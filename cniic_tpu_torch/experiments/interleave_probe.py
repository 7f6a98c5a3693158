"""The cluster-colors encode leg alone and amid the north-star sequence.

Port of ``scripts/experiments/interleave_probe.py``. The original
attributed a gap, on a TPU, between cluster-colors(32)'s north-star
reading and its isolated profile by replaying the north-star per-chunk
sequence and timing the cluster-colors encode in three contexts:

  A. cluster encode alone, chunks back to back (the profile's case)
  B. cluster encode + its decode and MSE (adds the host decode)
  C. the full north-star order: cluster encode and decode, then voronoi
     encode and decode (device work between the cluster legs)

If C's cluster leg is slower than A's, the work between the legs (the
voronoi device work, or the host decode) slows it. Each encode's time is
ended by its streams coming back to the host (host clock).

    python -m cniic_tpu_torch.experiments.interleave_probe [--device=cuda]
        [--chunks=3] [--chunk=32] <pngs...>
"""

from __future__ import annotations

import argparse
import glob as globlib
import sys
import time

from .. import image_io
from ..bench import device_label
from ..codecs import from_spec
from ..runner import compute_error
from . import open_device


def _decode_verify(codec, blobs, imgs):
    """The north-star decode+verify leg: the fused decode_mse_batch when
    the codec has one, else decode_batch + per-image MSE."""
    fused = getattr(codec, "decode_mse_batch", None)
    if fused is not None:
        fused(blobs, imgs)
    else:
        for im, de in zip(imgs, codec.decode_batch(blobs)):
            compute_error(im, de)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pngs", nargs="*")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=32)
    args = ap.parse_args(argv)
    chunk = args.chunk
    paths = sorted(p for a in args.pngs for p in (globlib.glob(a) or [a]))
    paths = paths[: chunk * (args.chunks + 1)]
    if len(paths) < chunk * 2:
        print("need at least two chunks of images", file=sys.stderr)
        return 1
    dev = open_device(args.device)
    if dev is None:
        return 1
    who = device_label(dev.type)
    cc = from_spec("cluster-colors(32)", device=dev)
    vo = from_spec("voronoi(128)", device=dev)
    groups = [paths[i:i + chunk] for i in range(0, len(paths), chunk)]
    imgs_by_chunk = [[image_io.load_image(p) for p in g] for g in groups]
    mp_of = [sum(im.shape[0] * im.shape[1] for im in ch) / 1e6
             for ch in imgs_by_chunk]

    t0 = time.perf_counter()  # warmup on chunk 0, both codecs
    blobs = cc.encode_batch(imgs_by_chunk[0])
    _decode_verify(cc, blobs, imgs_by_chunk[0])
    vb = vo.encode_batch(imgs_by_chunk[0])
    _decode_verify(vo, vb, imgs_by_chunk[0])
    print(f"warmup {time.perf_counter() - t0:.1f}s on {who}", flush=True)

    for label, mode in (("A cluster-only", "a"), ("B +own-decode", "b"),
                        ("C full-NS-order", "c")):
        ts, mps = [], []
        for ci, imgs in enumerate(imgs_by_chunk[1:], start=1):
            t0 = time.perf_counter()
            b = cc.encode_batch(imgs)
            ts.append(time.perf_counter() - t0)
            mps.append(mp_of[ci])
            if mode in ("b", "c"):
                _decode_verify(cc, b, imgs)
            if mode == "c":
                _decode_verify(vo, vo.encode_batch(imgs), imgs)
        rates = "/".join(f"{m / t:.3f}" for m, t in zip(mps, ts))
        print(f"{label}: cluster enc {rates} MP/s (mean "
              f"{sum(mps) / sum(ts):.3f}) on {who}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
