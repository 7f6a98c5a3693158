"""Profile of the two k-means encodes, and the card against the CPU.

Port of ``scripts/experiments/profile_kmeans.py``. The original's
"on-silicon parity" held the Pallas iteration against the XLA oracle on a
TPU. Here it holds the card's ``encode_batch`` against the same call with
``device="cpu"``, which runs K1's plain version: the streams must be equal
byte for byte (a difference fails the run), and both median times are
printed. Then the cluster-colors stage split of the original: the host
histograms and one ``kmeans_batch``.

    python -m cniic_tpu_torch.experiments.profile_kmeans [--device=cuda]
        [--side=768]

The images are ``bench.synth_image`` (seed 2024), four of 768^2 as in the
original; ``--side`` shrinks them, since the CPU reference is slow (about
two minutes for voronoi(128) at 768^2). Each card timing is the median of
five calls after a warm one; the CPU reference runs once, unwarmed. Every line names the card
and its power limit.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..bench import SEED, device_label, synth_image
from ..codecs import from_spec
from ..ops import histogram, kmeans
from . import open_device, sync

SPECS = ("voronoi(128)", "cluster-colors(32)")


def median_time(fn, trials: int, dev, warm: bool = True):
    """(last result, median s, best s) of `trials` calls after a warm one,
    each ended by a synchronize."""
    if warm:
        fn()
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts)), min(ts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=768)
    args = ap.parse_args(argv)
    dev = open_device(args.device)
    if dev is None:
        return 1
    who = device_label(dev.type)
    print(f"device {dev} ({who})", flush=True)
    rng = np.random.default_rng(SEED)
    imgs = [synth_image(rng, args.side, args.side) for _ in range(4)]
    mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
    cpu = open_device("cpu")
    for spec in SPECS:
        ref, med_c, best_c = median_time(
            lambda: from_spec(spec, device=cpu).encode_batch(imgs),
            1, cpu, warm=False)
        codec = from_spec(spec, device=dev)
        got, med_d, best_d = median_time(lambda: codec.encode_batch(imgs),
                                         5, dev)
        equal = got == ref
        print(f"{spec}: CPU plain {mp / med_c:.3f} MP/s (best "
              f"{mp / best_c:.3f}) | {dev} {mp / med_d:.3f} MP/s (best "
              f"{mp / best_d:.3f}) on {who} | streams bit-identical: {equal}",
              flush=True)
        if not equal:
            print(f"PARITY FAILURE: {spec}", file=sys.stderr)
            return 1

    stats = [histogram.color_histogram(im.reshape(-1, 3)) for im in imgs]
    _, med, _ = median_time(lambda: [
        histogram.color_histogram(im.reshape(-1, 3)) for im in imgs], 3, dev)
    print(f"  hist: {med:.4f}s ({[s[0].shape[0] for s in stats]} uniques)")
    _, med, _ = median_time(lambda: kmeans.kmeans_batch(
        [c.astype(np.int64) for c, _, _ in stats], 32,
        weights_list=[c.astype(np.int64) for _, c, _ in stats],
        device=dev), 3, dev)
    print(f"  kmeans_batch: {med:.4f}s on {who}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
