"""The colour histogram and exact RLE as torch ops on the card, against C.

Port of ``scripts/experiments/device_hist_rle_probe.py``. On the host
both stages run in the C runtime (``native.hist_rgb``, an LSD radix sort;
``native.rle_frame``, one fused pass). This probe formulates them on the
device, as the original did in jnp, here as torch ops:

* histogram: the packed u24 keys sorted stably with their positions, run
  starts where a key differs from the one before, segment ids by a cumsum,
  the inverse scattered back (``device_color_histogram``: the op that
  cluster-colors runs on a CUDA device, ``ops/color_hist.py``);
* exact RLE: the run-boundary mask over the scan (``device_rle``), then the
  host's closed-form split of runs at 255 (``runs_to_records``, a copy of
  ``cniic_tpu/ops/rle.py``'s).

Both are asserted equal to the C paths, then timed end to end (upload +
compute + download, the median of three) beside them, on a
``synth_natural`` 2040x1356 image (seed 7), the RLE on its Hilbert scan.

    python -m cniic_tpu_torch.experiments.device_hist_rle_probe
        [--device=cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import hilbert, native
from ..bench import device_label
from ..ops import color_hist, histogram
from ..synth_corpus import synth_natural
from . import open_device, sync

RUN_CAP = 255


def _keys(pix):
    p = pix.to(torch.int32)
    return (p[:, 0] << 16) | (p[:, 1] << 8) | p[:, 2]


def device_color_histogram(pixels: np.ndarray, dev):
    """(colors uint8[u, 3], counts int64[u], inverse int32[N]) of an
    (N, 3) uint8 stream, computed on `dev` by the codec's own device
    histogram (``ops/color_hist.py``, one lane) and downloaded."""
    return color_hist.lane_histograms([pixels[None]], dev).lane(0)


def runs_to_records(starts: np.ndarray, n: int, scan: np.ndarray):
    """Run-start indices -> RLE records: a run of length L becomes
    ceil(L/255) records of 255, ..., remainder (copy of
    ``cniic_tpu/ops/rle.py``'s)."""
    lens = np.diff(np.append(starts, n))
    reps = -(-lens // RUN_CAP)  # records per run
    counts = np.full(int(reps.sum()), RUN_CAP, dtype=np.uint8)
    ends = np.cumsum(reps) - 1  # index of each run's last record
    counts[ends] = (lens - (reps - 1) * RUN_CAP).astype(np.uint8)
    colors = np.repeat(scan[starts], reps, axis=0)
    return counts, colors


def device_rle(scan: np.ndarray, dev):
    """Exact RLE records (counts, colors) of an (N, 3) scan: the boundary
    mask on `dev` (1 B/px download), the 255-cap split on the host."""
    keys = _keys(torch.from_numpy(np.ascontiguousarray(scan)).to(dev))
    mask = torch.ones_like(keys, dtype=torch.bool)
    mask[1:] = keys[1:] != keys[:-1]
    return runs_to_records(np.flatnonzero(mask.cpu().numpy()),
                           scan.shape[0], scan)


def timed(fn, dev, reps: int = 3):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = open_device(args.device)
    if dev is None:
        return 1
    who = device_label(dev.type)
    img = synth_natural(np.random.default_rng(7), 1356, 2040)
    mp = img.shape[0] * img.shape[1] / 1e6
    pixels = img.reshape(-1, 3)

    dcol, dcnt, dinv = device_color_histogram(pixels, dev)  # warm + parity
    ccol, ccnt, cinv = histogram.color_histogram(pixels)
    if not (np.array_equal(dcol, ccol) and np.array_equal(dcnt, ccnt)
            and np.array_equal(dinv, cinv)):
        print("histogram: device != C", file=sys.stderr)
        return 1
    print(f"histogram parity ok ({dcol.shape[0]} uniques)", flush=True)
    t_c, _ = timed(lambda: histogram.color_histogram(pixels), dev)
    t_d, _ = timed(lambda: device_color_histogram(pixels, dev), dev)
    print(f"histogram: C radix {t_c:.4f}s ({mp / t_c:.1f} MP/s) vs {dev} "
          f"sort+segment {t_d:.4f}s ({mp / t_d:.1f} MP/s) on {who}",
          flush=True)

    scan = hilbert.linearize(img)
    dc, dcl = device_rle(scan, dev)  # warm + parity
    if native.rle_records_frame(dc, dcl) != bytes(native.rle_frame(scan)):
        print("exact RLE: device != C", file=sys.stderr)
        return 1
    print(f"rle parity ok ({dc.size} records)", flush=True)
    t_c, _ = timed(lambda: native.rle_frame(scan), dev)
    t_d, _ = timed(lambda: device_rle(scan, dev), dev)
    print(f"exact RLE: fused C {t_c:.4f}s ({mp / t_c:.1f} MP/s) vs {dev} "
          f"boundary pass {t_d:.4f}s ({mp / t_d:.1f} MP/s) on {who}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
