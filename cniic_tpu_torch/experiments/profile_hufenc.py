"""Stage profile of the Hufman encode, on the host.

Port of ``scripts/experiments/profile_hufenc.py``: each stage of one
image's Hufman encode timed on its own (pixels, histogram, leaf wire
bytes, code lengths, canonical code, tree serialization, bit packing),
the codebook split out as the production path builds it. The Hufman leg
runs in the host C runtime on the default path, so this run is CPU-only,
as the original's was, and takes no ``--device``; the port's ``image_io``
reads the PNGs where the original used PIL.

    python -m cniic_tpu_torch.experiments.profile_hufenc [--n=6]
        [--glob='data/ns1000/ns_*.png']

Prints each image's ms/MP and the median ms/MP of each stage (host clock).
"""

from __future__ import annotations

import argparse
import glob as globlib
import sys
import time

import numpy as np

from .. import huffman, image_io, native, wire
from ..codecs.base import pixels_row_major
from ..ops import histogram


def profile_one(img: np.ndarray) -> dict:
    mp = img.shape[0] * img.shape[1] / 1e6
    t = {}

    t0 = time.perf_counter()
    pixels = pixels_row_major(img)
    t["pixels"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    colors, counts, inverse = histogram.color_histogram(pixels)
    t["histogram"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    leaf_payloads = np.frombuffer(
        wire.rgb_stream_to_wire(colors), dtype=np.uint8
    ).reshape(-1, wire.RGB_WIRE_SIZE)
    t["leaf_wire"] = time.perf_counter() - t0

    freqs = np.asarray(counts, dtype=np.uint64)
    t0 = time.perf_counter()
    lens = native.huf_lens_unsorted(freqs)
    t["huf_lens_unsorted"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    codes, tags, leaf_sym = native.huf_canonical(lens)
    t["huf_canonical"] = time.perf_counter() - t0

    book = huffman.Codebook(codes=codes, lens=lens, tags=tags,
                            leaf_sym=leaf_sym)

    t0 = time.perf_counter()
    tree = huffman.serialize_tree(book, leaf_payloads)
    t["serialize_tree"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    payload = native.pack_bits(book.codes, book.lens,
                               np.asarray(inverse, np.int32))
    t["pack_bits"] = time.perf_counter() - t0

    total = sum(t.values())
    return {
        "uniques": int(colors.shape[0]),
        "mp": mp,
        "stages_ms_per_mp": {k: v / mp * 1e3 for k, v in t.items()},
        "total_ms_per_mp": total / mp * 1e3,
        "mps": mp / total,
        "bytes": len(tree) + len(payload) + 8,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--glob", default="data/ns1000/ns_*.png")
    args = ap.parse_args(argv)
    paths = sorted(globlib.glob(args.glob))[:args.n]
    if not paths:
        print(f"no images match {args.glob}", file=sys.stderr)
        return 1
    profile_one(image_io.load_image(paths[0]))  # warm (page cache, allocator)

    agg: dict[str, list] = {}
    for p in paths:
        r = profile_one(image_io.load_image(p))
        print(f"{p.split('/')[-1]}: uniq={r['uniques']:>7} "
              f"total={r['total_ms_per_mp']:6.1f} ms/MP ({r['mps']:5.1f} MP/s)")
        for k, v in r["stages_ms_per_mp"].items():
            agg.setdefault(k, []).append(v)

    print("\nmedian ms/MP per stage (host clock):")
    tot = 0.0
    for k, vs in agg.items():
        m = float(np.median(vs))
        tot += m
        print(f"  {k:<16} {m:7.2f}")
    print(f"  {'TOTAL':<16} {tot:7.2f}  ({1e3 / tot:.1f} MP/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
