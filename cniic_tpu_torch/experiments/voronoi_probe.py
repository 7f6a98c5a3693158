"""Standalone voronoi(128) encode throughput over corpus chunks.

Port of ``scripts/experiments/voronoi_probe.py``: ``encode_batch`` alone
(no pipelining, no decode, no other codec in flight) over chunks of
``--depth`` images after an untimed warm chunk, each chunk's time ended by
the streams coming back to the host. The original attributed a gap
between its north-star reading and a standalone one on a TPU; on the card
the same protocol gives the standalone reading beside ``northstar``'s.

    python -m cniic_tpu_torch.experiments.voronoi_probe [--device=cuda]
        [--chunks=3] [--depth=8] [pngs...]   (default data/ns1000/*.png)
"""

from __future__ import annotations

import argparse
import glob as globlib
import sys
import time

from .. import image_io
from ..bench import device_label
from ..codecs import from_spec
from . import open_device, sync


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pngs", nargs="*", default=["data/ns1000/*.png"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--depth", type=int, default=8)
    args = ap.parse_args(argv)
    paths = sorted(p for a in args.pngs for p in globlib.glob(a))
    if len(paths) < args.depth * (args.chunks + 1):
        print(f"need {args.depth * (args.chunks + 1)} images, got "
              f"{len(paths)} (python -m cniic_tpu_torch.synth_corpus "
              "data/ns1000 1000 --ns)", file=sys.stderr)
        return 1
    dev = open_device(args.device)
    if dev is None:
        return 1
    who = device_label(dev.type)
    codec = from_spec("voronoi(128)", device=dev)
    warm = [image_io.load_image(p) for p in paths[:args.depth]]
    t0 = time.perf_counter()
    codec.encode_batch(warm)
    sync(dev)
    print(f"warm {time.perf_counter() - t0:.2f}s on {who}", flush=True)
    total_mp = total_s = 0.0
    for c in range(args.chunks):
        grp = paths[(c + 1) * args.depth:(c + 2) * args.depth]
        imgs = [image_io.load_image(p) for p in grp]
        t0 = time.perf_counter()
        streams = codec.encode_batch(imgs)
        dt = time.perf_counter() - t0  # the host bytes are the sync
        mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
        total_mp += mp
        total_s += dt
        if not all(isinstance(s, bytes) and len(s) > 16 for s in streams):
            print(f"chunk {c}: a stream failed", file=sys.stderr)
            return 1
        print(f"chunk {c}: {dt:.3f}s {mp / dt:.3f} MP/s", flush=True)
    print(f"standalone steady: {total_mp / total_s:.3f} MP/s over "
          f"{total_mp:.1f} MP on {who}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
