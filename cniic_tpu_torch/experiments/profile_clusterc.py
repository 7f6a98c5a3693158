"""Where a cluster-colors encode spends its time, stage by stage.

Port of ``scripts/experiments/profile_clusterc.py``: the production
``encode_batch`` path (``codecs/clusterc.py``) run stage by stage through
the codec's own stage functions (``ClusterColors.stages()``), over groups
of PNGs:

* ``hist``: the colour histograms: on the card one upload and one sort for
  the group (``ops/color_hist.py``), on the CPU the host C histograms
  (``ops/histogram.py``);
* ``kmeans``: one k-means over the lanes sorted by unique count
  (``kmeans_lanes`` on the card's lanes, ``kmeans_batch`` on the host's;
  K1 on the card);
* ``parts``: the palette stream parts, the per-pixel palette ids gathered
  on the card and downloaded, or by a C gather on the host;
* ``huf``: ``huffman.batch_encode_streams`` (host C, or D1 under
  CNIIC_DEVICE_BITPACK=1).

Each stage's clock (``time.perf_counter``) stops after a synchronize of the
device. A group's line gives its megapixels, the lanes' unique colours and
k-means iterations, K1's launches and each stage's seconds beside the card's
name and power limit. The streams the stages make are held byte for byte
against ``encode_batch`` of the same images; a difference fails the run.

    python -m cniic_tpu_torch.experiments.profile_clusterc [--device=cuda]
        [--lanes=8] [--chunks=2] [--k=32] [--stages=codec|card|host] <pngs...>

``--stages`` picks the stage functions: the codec's for the device
(``codec``, the default), or ``card`` / ``host`` (``CardStages``,
``HostStages``) on any device, so that the two are timed on one.

The first group runs once untimed as the warmup, then the first
``--chunks`` groups of ``--lanes`` images run timed (the original warmed
on a group of its own: here the warmup repeats group 0, so that a small
corpus suffices). The last line is one JSON object: the card, and each
group's stages, iterations and K1 launches.
"""

from __future__ import annotations

import argparse
import glob as globlib
import json
import sys
import time

from .. import image_io
from ..bench import device_label
from ..codecs import ClusterColors, clusterc
from ..ops import kmeans_kernel
from . import open_device, sync

STAGES = ("hist", "kmeans", "parts", "huf")


STAGE_SETS = {"card": clusterc.CardStages, "host": clusterc.HostStages}


def profile_group(imgs, k: int, dev, stages: str = "codec") -> dict:
    """The four stages over one group of images: seconds each, the lanes'
    unique colours and iterations, K1 launches, and the streams."""
    st = (ClusterColors(k, device=dev).stages() if stages == "codec"
          else STAGE_SETS[stages](k, dev))
    t = {}

    def timed(name, fn, *args):
        sync(dev)
        t0 = time.perf_counter()
        out = fn(*args)
        sync(dev)
        t[name] = time.perf_counter() - t0
        return out

    h = timed("hist", st.hist, imgs)
    launches = kmeans_kernel.assign_stats.launches
    results = timed("kmeans", st.kmeans, h)
    launches = kmeans_kernel.assign_stats.launches - launches
    bad = [r for r in results if isinstance(r, Exception)]
    if bad:
        raise bad[0]
    parts = timed("parts", st.parts, h, results)
    streams = timed("huf", st.huf, imgs, results, parts)
    return {"seconds": t, "uniques": st.uniques(h),
            "iterations": [r[2] for r in results], "k1_launches": launches,
            "streams": streams}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pngs", nargs="*")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--stages", default="codec",
                    choices=["codec", *STAGE_SETS])
    args = ap.parse_args(argv)
    paths = sorted(p for a in args.pngs for p in (globlib.glob(a) or [a]))
    need = args.lanes * args.chunks
    if need < 1 or len(paths) < need:
        print(f"need {need} images, got {len(paths)}", file=sys.stderr)
        return 1
    dev = open_device(args.device)
    if dev is None:
        return 1
    who = device_label(dev.type)
    print(f"device {dev} ({who}) lanes={args.lanes} k={args.k} "
          f"stages={args.stages}", flush=True)
    groups = [paths[i:i + args.lanes] for i in range(0, need, args.lanes)]
    codec = ClusterColors(args.k, device=dev)
    report = {"card": who, "lanes": args.lanes, "k": args.k,
              "stages": args.stages, "groups": []}
    tot = mp = 0.0
    for label, group in [("warmup", groups[0])] + [
            (f"chunk{i}", g) for i, g in enumerate(groups)]:
        imgs = [image_io.load_image(p) for p in group]
        mpx = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
        r = profile_group(imgs, args.k, dev, args.stages)
        if r["streams"] != codec.encode_batch(imgs):
            print(f"{label}: the stages' streams differ from encode_batch's",
                  file=sys.stderr)
            return 1
        s = r["seconds"]
        total = sum(s.values())
        print(f"{label}: {mpx:.3f} MP  uniq={r['uniques']}  "
              f"iters={r['iterations']}  K1 launches {r['k1_launches']}\n  "
              + "  ".join(f"{n} {s[n]:.4f}s" for n in STAGES)
              + f"  total {total:.4f}s -> {mpx / total:.3f} MP/s on {who}",
              flush=True)
        if label != "warmup":
            tot += total
            mp += mpx
            report["groups"].append({
                "label": label, "megapixels": mpx, "seconds": s,
                "uniques": r["uniques"], "iterations": r["iterations"],
                "k1_launches": r["k1_launches"]})
    report["steady_mps"] = mp / tot
    print(f"steady: {mp / tot:.3f} MP/s over {mp:.3f} MP on {who}; streams "
          "equal encode_batch's", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
