"""Where the k-means codecs' time goes on the card: K1 builds timed in turns,
and a profiler window over one warm encode of each k-means codec.

    python -m cniic_tpu_torch.kmeans_profile [--compare LABEL=SOURCE.cu ...]

* K1 at the two shapes of the main path, on `chip_smoke.py`'s images
  (`bench.synth_image`, seed 2024): (a) voronoi(128), 4 lanes of 1024^2
  points, d = 5, k = 128; (b) cluster-colors(32), 8 lanes of unique colours
  weighted by their counts, d = 3, k = 32. The package's K1 and every
  `--compare` source (another build of `csrc/kmeans_assign.cu`, e.g. a
  parent commit's, compiled with the same nvcc flags) run in turns, forward
  then backward, each a mean over 50 launches timed with CUDA events, into
  buffers allocated once.
* `encode_window(codec, imgs)`: torch.profiler over one warm
  `encode_batch`: the device busy share of the window, each kernel's share,
  and the device kernels launched per k-means iteration. `chip_smoke.py`
  phase 4 prints it for both k-means codecs. Here voronoi(128) is also
  read with the update as a launch of its own (`two_launches`: the engine's
  step prepared unfused for the duration), one, two, two, one in turns.

Needs a CUDA card; prints one line per reading and a JSON line at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import logging
import os
import re
import subprocess
import time

import numpy as np
import torch

from . import _build
from .bench import SEED, synth_image
from .codecs import from_spec
from .codecs.base import pixels_row_major
from .ops import histogram, kmeans_kernel
from .ops import kmeans as km

ITERS = 50   # launches a timing
ROUNDS = 2   # forward then backward over the builds


def voronoi_operands(imgs, k: int, dev):
    """K1's operands and pmax at the init state of a voronoi(k) encode of
    same-shape images (one lane each)."""
    ptsT, w = km._voronoi_setup(torch.from_numpy(np.stack(imgs)).to(dev))
    B, _, n = ptsT.shape
    cur, cents = km._init_state(ptsT, [n] * B, k)
    h, wd = imgs[0].shape[:2]
    ns = torch.full((B,), n, dtype=torch.int32, device=dev)
    act = torch.ones(B, dtype=torch.int32, device=dev)
    return [ptsT, w, cur, cents, ns, act], [wd - 1, h - 1, 255, 255, 255]


def colour_operands(imgs, k: int, dev):
    """K1's operands and pmax at the init state of a cluster-colors(k)
    encode: one lane of unique colours, weighted by their counts, an
    image."""
    stats = [histogram.color_histogram(pixels_row_major(im)) for im in imgs]
    pts, w, ns = km.pad_lanes([s[0].astype(np.int64) for s in stats],
                              [s[1] for s in stats])
    ptsT = torch.from_numpy(pts).to(dev)
    cur, cents = km._init_state(ptsT, ns, k)
    ops = [ptsT, torch.from_numpy(w).to(dev), cur, cents,
           torch.tensor(ns, dtype=torch.int32, device=dev),
           torch.ones(len(ns), dtype=torch.int32, device=dev)]
    return ops, pts.max(axis=(0, 2)).tolist()


def _load_compare(label: str, source: str) -> ctypes.CDLL:
    name = "cmp_" + re.sub(r"\W", "_", label)
    cmd = [a if a != kmeans_kernel.SOURCE else source
           for a in kmeans_kernel._commands()[0]]
    lib = _build.load(name, [source], [cmd])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # builds from before the packed path take no `packed` argument
    packed = hasattr(lib, "kmeans_step_update")
    lib.kmeans_assign_stats.argtypes = ([vp] * 9 + [ci] * (5 if packed else 4)
                                        + [vp])
    lib.kmeans_assign_stats.restype = ci
    lib.packed_abi = packed
    return lib


def _compare_call(lib, ops, out, packed: bool):
    ptsT, w, cur, cents, n, act = ops
    B, d, n_max = ptsT.shape
    args = [t.data_ptr() for t in (ptsT, w, cur, cents, n, act, *out)]
    args += [B, d, n_max, cents.shape[1]]
    if lib.packed_abi:
        args.append(int(packed))
    args.append(torch.cuda.current_stream().cuda_stream)
    rc = lib.kmeans_assign_stats(*args)
    if rc != 0:
        raise RuntimeError(f"compare build: CUDA error {rc}")


def time_ms(fn, iters: int) -> float:
    """Mean ms per call over `iters` calls, CUDA events, after a warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_turns(cases, compares):
    """{case: {label: [ms, ...]}}: the package's K1 ("repo") and each
    compare build in turns, forward then backward, ROUNDS times, each a
    mean over ITERS launches."""
    out = {}
    for key, (ops, pmax) in cases.items():
        B, d, n_max = ops[0].shape
        k = ops[3].shape[1]
        dev = ops[0].device
        bufs = (torch.zeros((B, n_max), dtype=torch.int32, device=dev),
                torch.zeros((B, k, d + 1), dtype=torch.int64, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev))
        packed = kmeans_kernel.packed_path(pmax, k)
        fns = {"repo": lambda: kmeans_kernel.assign_stats(
            *ops, pmax=pmax, out=bufs)}
        for label, lib in compares.items():
            fns[label] = (lambda lib=lib: _compare_call(lib, ops, bufs,
                                                        packed))
        order = list(fns)
        times = {label: [] for label in order}
        for r in range(ROUNDS):
            for label in (order if r % 2 == 0 else order[::-1]):
                times[label].append(time_ms(fns[label], ITERS))
        out[key] = times
    return out


def keep_cupti() -> None:
    """Keep CUPTI attached between torch.profiler windows. By default the
    profiler tears CUPTI down after each window and re-attaches it lazily
    in the next; windows have come back without kernels that ran in them,
    and with CUPTI kept attached only the process's first window attaches
    it. Call before the first window."""
    os.environ["TEARDOWN_CUPTI"] = "0"


def _device_intervals(prof):
    kernels = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.time_range.start, e.time_range.end, e.name))
    return kernels


def _union_us(spans) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


class IterLog(logging.Handler):
    """Counts the k-means loops run (`loops`) and their iterations
    (`iters`) from the engine's log lines, while attached (`with`)."""

    def __init__(self):
        super().__init__()
        self.iters = 0
        self.loops = 0

    def emit(self, record):
        m = re.match(r"k-means: (\d+) iterations", record.getMessage())
        if m:
            self.iters += int(m.group(1))
            self.loops += 1

    def __enter__(self):
        self._logger = logging.getLogger(km.__name__)
        self._level = self._logger.level
        self._logger.addHandler(self)
        self._logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)
        self._logger.setLevel(self._level)


@contextlib.contextmanager
def two_launches():
    """For the duration the engine's loop launches K1 then D3 an iteration
    (`prepare_step(fused=False)`), the iteration as it was before the update
    moved into K1's last blocks: for comparing the two in one process."""
    fused = km.prepare_step
    km.prepare_step = functools.partial(fused, fused=False)
    try:
        yield
    finally:
        km.prepare_step = fused


def encode_window(codec, imgs) -> dict:
    """torch.profiler over one warm `codec.encode_batch(imgs)` on the card:
    wall seconds, device busy share (union of device activity over the
    window), the share of the step's kernel (K1, with D3 in each lane's
    last block) and of D3's own kernel (0 unless `two_launches` keeps it a
    launch of its own), device kernels in the window, K1 and D3 launches,
    k-means iterations (all lane chunks) and kernels per iteration."""
    from torch.profiler import ProfilerActivity, profile

    codec.encode_batch(imgs)  # warm
    torch.cuda.synchronize()
    k1_0 = kmeans_kernel.assign_stats.launches
    d3_0 = kmeans_kernel.step_update.launches
    with IterLog() as handler:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            codec.encode_batch(imgs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    spans = _device_intervals(prof)
    kern = [s for s in spans if "memcpy" not in s[2].lower()
            and "memset" not in s[2].lower()]

    def share(key):
        return sum(e - s for s, e, n in kern if key in n) / (wall * 1e6)

    iters = handler.iters
    return {
        "wall_s": wall,
        "device_events": len(spans),
        "busy_share": _union_us([(s, e) for s, e, _ in spans]) / (wall * 1e6),
        "k1_share": share("assign_stats_kernel"),
        "d3_share": share("step_update_kernel"),
        "kernels": len(kern),
        "k1_launches": kmeans_kernel.assign_stats.launches - k1_0,
        "d3_launches": kmeans_kernel.step_update.launches - d3_0,
        "iterations": iters,
        "kernels_per_iteration": len(kern) / iters if iters else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", action="append", default=[],
                    metavar="LABEL=SOURCE",
                    help="another K1 source to time in turns with the "
                         "package's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kmeans_profile needs a CUDA card")
    dev = torch.device("cuda")
    keep_cupti()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    rng = np.random.default_rng(SEED)
    imgs = [synth_image(rng, 1024, 1024) for _ in range(8)]
    compares = {}
    for item in args.compare:
        label, source = item.split("=", 1)
        compares[label] = _load_compare(label, os.path.abspath(source))
    cases = {"a": voronoi_operands(imgs[:4], 128, dev),
             "b": colour_operands(imgs[:8], 32, dev)}
    turns = k1_turns(cases, compares)
    for key, times in turns.items():
        for label, ms in times.items():
            print(f"K1 ({key}) {label}: "
                  + " / ".join(f"{t * 1e3:.2f}" for t in ms) + " us")
    windows = {}
    for spec in ("voronoi(128)", "cluster-colors(32)"):
        windows[spec] = encode_window(from_spec(spec, device="cuda"), imgs)
        print(f"{spec} encode window: {json.dumps(windows[spec])}")
    turns_v = []
    for split in (False, True, True, False):
        with two_launches() if split else contextlib.nullcontext():
            win = encode_window(from_spec("voronoi(128)", device="cuda"), imgs)
        turns_v.append({"launches_an_iteration": 2 if split else 1, **win})
        print(f"voronoi(128) encode window, {2 if split else 1} launch(es) an "
              f"iteration: {json.dumps(win)}")
    windows["voronoi(128), one and two launches in turns"] = turns_v
    print(json.dumps({"card": card, "k1_us": {
        key: {label: [t * 1e3 for t in ms] for label, ms in times.items()}
        for key, times in turns.items()}, "encode": windows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
