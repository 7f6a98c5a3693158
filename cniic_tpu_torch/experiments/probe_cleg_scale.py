"""The host-C codec legs at corpus scale, with and without the card.

Port of ``scripts/experiments/probe_cleg_scale.py``: the north-star chunk
protocol (chunked ``encode_batch``, loads untimed, encode seconds
accumulated) over a corpus prefix for host-C codecs only. The original ran
it with JAX kept off its TPU, to tell a slowdown from the device's
presence apart from one from the corpus's content. The port's Hilbert
codecs run in the host C runtime on either device, so the question is
asked by running it twice: ``--device=cuda`` (the default; refused with no
card) builds the codecs for the card as ``northstar`` does,
``--device=cpu`` for the CPU; the same reading on both says the card's
process adds nothing to these legs.

    python -m cniic_tpu_torch.experiments.probe_cleg_scale
        [--device=cuda|cpu] [--n=128] [--chunk=32]
        [--specs=hilbert(rle),hilbert(rle(4))] [--glob='data/ns1000/*.png']
"""

from __future__ import annotations

import argparse
import glob as globlib
import sys
import time

from .. import image_io
from ..codecs import from_spec
from . import open_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--specs", default="hilbert(rle),hilbert(rle(4))")
    ap.add_argument("--glob", default="data/ns1000/*.png")
    args = ap.parse_args(argv)
    paths = sorted(globlib.glob(args.glob))[:args.n]
    if not paths:
        print(f"no images match {args.glob}", file=sys.stderr)
        return 1
    dev = open_device(args.device)
    if dev is None:
        return 1
    codecs = [from_spec(s, device=dev) for s in args.specs.split(",")]
    acc = {c.name: [0.0, 0.0] for c in codecs}  # mp, enc_s

    groups = [paths[i:i + args.chunk] for i in range(0, len(paths), args.chunk)]
    warm = [image_io.load_image(p) for p in groups[0]]
    for c in codecs:
        c.encode_batch(warm[: min(8, len(warm))])
    for gi, g in enumerate(groups):
        imgs = [image_io.load_image(p) for p in g]
        mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
        for c in codecs:
            t0 = time.perf_counter()
            c.encode_batch(imgs)
            acc[c.name][0] += mp
            acc[c.name][1] += time.perf_counter() - t0
        print(f"chunk {gi + 1}/{len(groups)}: " + " ".join(
            f"{c.name}:{acc[c.name][0] / max(acc[c.name][1], 1e-9):.1f}"
            for c in codecs), flush=True)
    for c in codecs:
        mp, s = acc[c.name]
        print(f"{c.name}: {mp / s:.1f} MP/s over {mp:.0f} MP ({s:.2f}s), "
              f"host C, codecs built for {dev}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
