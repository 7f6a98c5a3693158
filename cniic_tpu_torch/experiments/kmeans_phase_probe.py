"""Split a k-means encode's k-means stage into its phases, call by call.

Port of the question of ``scripts/experiments/kmeans_phase_probe.py``, not
of its code: the original timed JAX's upload packing and device bursts
through internals the port does not have (the narrow upload packing, the
burst loop, the Pallas burst). Here each k-means call that a production
encode makes, one lane chunk of ``ops/kmeans.py`` (cluster-colors: the
unique colours of up to CNIIC_KMEANS_LANES = 8 images, sorted by their
count; voronoi: up to 4 same-shape images), runs through the engine's own
pieces in its order, each phase timed:

* ``prep``: host validation and padding (``_validate_lane``,
  ``pad_lanes``; for voronoi the image batch's checks);
* ``upload``: the host arrays to the device and the init state
  (``_init_state``; for voronoi also the point build ``_voronoi_setup``);
* ``loop``: ``_drive``, one launch an iteration (K1 with D3 in it), the
  host reading the lanes' state every ``_CHECK_EVERY`` (8) launches. Each
  window of 8 launches between two host checks is timed on the device's
  clock (CUDA events around it), with the batch's iteration count after it
  and K1's launches in it;
* ``fetch``: the assignment and centroids back to the host and the
  active-cluster check.

``prep``, ``upload``, ``loop`` and ``fetch`` are host seconds
(``time.perf_counter`` around work that ends in a synchronize); the windows
are device milliseconds (CUDA events; on a CPU run host milliseconds,
labelled so). Each call's results are held against the engine's own call
(``kmeans_batch`` / ``voronoi_centroids_batch``) on the same lanes; a
difference fails the run.

cluster-colors' calls are probed from host lanes padded on the host
(``pad_lanes``). The engine lays its lanes out on the device instead
(``kmeans_lanes``; ``kmeans_batch`` uploads the host lanes in one buffer
for it), and on a CUDA device the codec's lanes come from the device
histogram with no host ``prep`` and no ``upload``; ``profile_clusterc``'s
``kmeans`` stage times that whole.

    python -m cniic_tpu_torch.experiments.kmeans_phase_probe [--device=cuda]
        [--specs=cluster-colors(32),voronoi(128)] <pngs...>

Both specs by default, over all the images given: a warmup pass, then a
timed pass. The last line is one JSON object with every call's phases and
windows and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import glob as globlib
import json
import os
import sys
import time

import numpy as np
import torch

from .. import image_io
from ..bench import device_label
from ..codecs import ClusterColors, from_spec
from ..codecs.base import pixels_row_major
from ..ops import histogram, kmeans_kernel
from ..ops import kmeans as km
from . import open_device, sync

SPECS = ("cluster-colors(32)", "voronoi(128)")


class WindowClock:
    """While entered, the steps `ops/kmeans.prepare_step` hands `_drive`
    record each window of `_CHECK_EVERY` launches: a clock around it (CUDA
    events on the card, the host clock on the CPU), the batch's iteration
    count after it (kept on the device until `read`) and K1's launches."""

    def __init__(self, dev):
        self.dev = dev
        self.windows = []

    def _mark(self):
        if self.dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def __enter__(self):
        self._real = real = km.prepare_step
        every = km._CHECK_EVERY

        def prepare(*args, **kw):
            step = real(*args, **kw)
            it = args[12] if len(args) > 12 else kw["it"]
            calls = [0]

            def timed() -> None:
                if calls[0] % every == 0:
                    self.windows.append({
                        "start": self._mark(),
                        "k1": kmeans_kernel.assign_stats.launches})
                step()
                calls[0] += 1
                if calls[0] % every == 0:
                    win = self.windows[-1]
                    win["end"] = self._mark()
                    win["k1"] = kmeans_kernel.assign_stats.launches - win["k1"]
                    win["it"] = it.max().clone()

            return timed

        km.prepare_step = prepare
        return self

    def __exit__(self, *exc):
        km.prepare_step = self._real

    def read(self) -> list:
        """[(iterations in the window, K1 launches, ms)] after a sync."""
        out, prev = [], 0
        for w in self.windows:
            if self.dev.type == "cuda":
                ms = w["start"].elapsed_time(w["end"])
            else:
                ms = (w["end"] - w["start"]) * 1e3
            it = int(w["it"])
            out.append((it - prev, w["k1"], ms))
            prev = it
        return out


def _loop(ptsT, w, cur, cents, ns, k, pmax, dev, t):
    with WindowClock(dev) as clock:
        t0 = time.perf_counter()
        it, cur, cents = km._drive(ptsT, w, cur, cents, ns, k, pmax, 10_000)
        sync(dev)
        t["loop"] = time.perf_counter() - t0
    return it, cur, cents, clock.read()


def probe_colours(points_list, weights_list, k: int, dev) -> dict:
    """One cluster-colors k-means call (one lane chunk), phase by phase."""
    t = {}
    t0 = time.perf_counter()
    for p, wl in zip(points_list, weights_list):
        km._validate_lane(p, wl, k)
    pts, w, ns = km.pad_lanes(points_list, weights_list)
    pmax = pts.max(axis=(0, 2)).tolist()
    t["prep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptsT = torch.from_numpy(pts).to(dev)
    w_dev = torch.from_numpy(w).to(dev)
    cur, cents = km._init_state(ptsT, ns, k)
    sync(dev)
    t["upload"] = time.perf_counter() - t0
    it, cur, cents, windows = _loop(ptsT, w_dev, cur, cents, ns, k, pmax,
                                    dev, t)
    t0 = time.perf_counter()
    assign = cur.cpu().numpy()
    cents_np = cents.cpu().numpy().astype(np.int64)
    for b, n in enumerate(ns):
        km._check_active(int(np.count_nonzero(np.bincount(
            assign[b, :n], minlength=k))), k, n)
    t["fetch"] = time.perf_counter() - t0
    want = km.kmeans_batch(points_list, k, weights_list=weights_list,
                           device=dev)
    same = all(np.array_equal(c, cents_np[b])
               and np.array_equal(a, assign[b, :ns[b]]) and i == it
               for b, (c, a, i) in enumerate(want))
    return {"lanes": len(ns), "points": ns, "seconds": t, "iterations": it,
            "windows": windows, "equal": same}


def probe_voronoi(imgs: np.ndarray, k: int, dev) -> dict:
    """One voronoi(k) k-means call (up to 4 same-shape images)."""
    t = {}
    t0 = time.perf_counter()
    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    B, h, wd, _ = imgs.shape
    n = h * wd
    if not k <= n < 2**27 or max(h, wd) - 1 > 16383:
        raise ValueError(f"voronoi({k}) cannot cluster {wd}x{h} images")
    t["prep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptsT, w_dev = km._voronoi_setup(torch.from_numpy(imgs).to(dev))
    ns = [n] * B
    cur, cents = km._init_state(ptsT, ns, k)
    sync(dev)
    t["upload"] = time.perf_counter() - t0
    it, cur, cents, windows = _loop(ptsT, w_dev, cur, cents, ns, k,
                                    [wd - 1, h - 1, 255, 255, 255], dev, t)
    t0 = time.perf_counter()
    actives = km._active_counts(cur, k).tolist()
    cents_np = cents.cpu().numpy().astype(np.int64)
    for a in actives:
        km._check_active(int(a), k, n)
    t["fetch"] = time.perf_counter() - t0
    want = km.voronoi_centroids_batch(imgs, k, device=dev)
    same = all(np.array_equal(c, cents_np[b]) for b, c in enumerate(want))
    return {"lanes": B, "points": ns, "seconds": t, "iterations": it,
            "windows": windows, "equal": same}


def probe_codec(codec, imgs, dev) -> list:
    """Every k-means call `codec.encode_batch(imgs)` makes, probed."""
    if isinstance(codec, ClusterColors):
        stats = [histogram.color_histogram(pixels_row_major(im))
                 for im in imgs]
        order = sorted(range(len(stats)),
                       key=lambda i: stats[i][0].shape[0], reverse=True)
        pts = [stats[i][0].astype(np.int64) for i in order]
        wts = [stats[i][1].astype(np.int64) for i in order]
        lanes = int(os.environ.get("CNIIC_KMEANS_LANES", "8"))
        return [probe_colours(pts[i:i + lanes], wts[i:i + lanes], codec.n,
                              dev) for i in range(0, len(pts), lanes)]
    buckets: dict = {}
    for im in imgs:
        buckets.setdefault(im.shape[:2], []).append(im)
    lanes = int(os.environ.get("CNIIC_KMEANS_LANES", "4"))
    return [probe_voronoi(np.stack(group[i:i + lanes]), codec.n, dev)
            for group in buckets.values()
            for i in range(0, len(group), lanes)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pngs", nargs="*")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--specs", default=",".join(SPECS))
    args = ap.parse_args(argv)
    paths = sorted(p for a in args.pngs for p in (globlib.glob(a) or [a]))
    if not paths:
        print("no images given", file=sys.stderr)
        return 1
    dev = open_device(args.device)
    if dev is None:
        return 1
    who = device_label(dev.type)
    window_clock = "device ms" if dev.type == "cuda" else "host ms"
    imgs = [image_io.load_image(p) for p in paths]
    print(f"device {dev} ({who}), {len(imgs)} images", flush=True)
    report = {"card": who, "window_clock": window_clock, "specs": {}}
    for spec in args.specs.split(","):
        codec = from_spec(spec, device=dev)
        probe_codec(codec, imgs, dev)  # warmup
        calls = probe_codec(codec, imgs, dev)
        for j, c in enumerate(calls):
            if not c["equal"]:
                print(f"{spec} call {j}: results differ from the engine's",
                      file=sys.stderr)
                return 1
            s = c["seconds"]
            win_ms = sum(ms for _, _, ms in c["windows"])
            print(f"{spec} call {j}: {c['lanes']} lanes of up to "
                  f"{max(c['points'])} points, {c['iterations']} iterations "
                  f"on {who}\n  host s: " + "  ".join(
                      f"{p} {s[p]:.4f}" for p in ("prep", "upload", "loop",
                                                  "fetch"))
                  + f"\n  loop windows ({window_clock}; iterations, K1 "
                  f"launches, ms): {[(i, n, round(ms, 4)) for i, n, ms in c['windows']]}"
                  f"\n  windows {win_ms:.4f} {window_clock} in all, "
                  f"{win_ms / max(c['iterations'], 1):.4f} an iteration",
                  flush=True)
        report["specs"][spec] = calls
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
