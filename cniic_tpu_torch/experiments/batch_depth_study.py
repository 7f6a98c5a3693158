"""Batch-depth scaling of the two k-means encodes.

Port of ``scripts/experiments/batch_depth_study.py``: voronoi(128) and
cluster-colors(32) ``encode_batch`` MP/s with batches of {4, 8, 16, 32}
images of 1024^2 (``bench.synth_image``, seed 2024, the bench's shape) and
lane chunks (CNIIC_KMEANS_LANES) of 4 and 8, each the median of three timed
calls after a warm one, ended by a synchronize. The original asked whether
deeper batches amortize a per-burst dispatch cost it had measured on a
tunneled TPU; on the card it asks the same of the engine's host checks and
per-chunk uploads.

    python -m cniic_tpu_torch.experiments.batch_depth_study [--device=cuda]
        [depths...]

Ends with one JSON line: per codec, {depth<d>_chunk<l>: MP/s}, and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..bench import SEED, device_label, synth_image
from ..codecs import from_spec
from . import open_device, sync

TRIALS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("depths", nargs="*", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    depths = args.depths or [4, 8, 16, 32]
    dev = open_device(args.device)
    if dev is None:
        return 1
    who = device_label(dev.type)
    rng = np.random.default_rng(SEED)
    imgs_all = [synth_image(rng, 1024, 1024) for _ in range(max(depths))]
    out = {}
    for spec in ("cluster-colors(32)", "voronoi(128)"):
        codec = from_spec(spec, device=dev)
        out[codec.name] = {}
        for lanes in (4, 8):
            for d in depths:
                if lanes > d:
                    continue
                imgs = imgs_all[:d]
                mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
                old = os.environ.get("CNIIC_KMEANS_LANES")
                os.environ["CNIIC_KMEANS_LANES"] = str(lanes)
                try:
                    codec.encode_batch(imgs)  # warm at this shape
                    trials = []
                    for _ in range(TRIALS):
                        t0 = time.perf_counter()
                        blobs = codec.encode_batch(imgs)
                        sync(dev)
                        trials.append(time.perf_counter() - t0)
                finally:
                    if old is None:
                        os.environ.pop("CNIIC_KMEANS_LANES", None)
                    else:
                        os.environ["CNIIC_KMEANS_LANES"] = old
                med = float(np.median(trials))
                key = f"depth{d}_chunk{lanes}"
                out[codec.name][key] = mp / med
                print(f"{codec.name} {key}: {mp / med:.3f} MP/s (trials "
                      f"{'/'.join(f'{mp / t:.3f}' for t in trials)}), "
                      f"stream0 {len(blobs[0])} B on {who}", flush=True)
    print(json.dumps({"metric": "batch_depth_scaling", "card": who,
                      "mps": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
