"""K2's and K3's chunk sizes and D2's root-table width, swept on the card:
the readings behind `approx_rle.WIDE_CHUNK`, `approx_rle.CHUNK` and
`hufdec.TABLE_BITS`; and what each of D1's two schedules puts on the card.

    python -m cniic_tpu_torch.schedule_sweep

* K2 over the 1024 chunks of 1024 pixels the chunked route cuts from each
  of the Hilbert scans of 8 of `bench.synth_image`'s 1024^2 images (seed
  2024), at allow 4, sub-chunks of 16 to 256 and one walker a stream: the
  four kernels' device time a call (the one walker's kernel), a mean over
  the 8 scans, each call checked equal to the one walker's records and
  flags.
* K3 over the same scans whole, 8 streams at allow 4, chunks of 32 to 1024:
  the three kernels' device time a call, each checked equal to the
  one-walker schedule's records.
* D2's two passes on the first image's Hufman payload at K = 0 and 8 to 14:
  the walk's device time (and the root table's, K >= 1) a call.
* D1 on the 8 images' Hufman id streams, one batched call: every kernel,
  memset and copy a call of `bitpack.pack_words` puts on the card, by name,
  with the one-pass schedule and with one thread a symbol (a gather, an
  int64 cumsum and `pack_kernel`).

Times are torch.profiler's kernel spans, means over 10 warm calls. Needs a
CUDA card; prints one line per sweep and a JSON line at the end.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

import re

from . import hilbert, huffman, native
from .bench import SEED, synth_image
from .codecs.base import pixels_row_major
from .kmeans_profile import _device_intervals, keep_cupti
from .ops import approx_rle, bitpack, histogram, hufdec

WIDE_CHUNKS = (16, 24, 32, 48, 64, 96, 128, 256)
CHUNKS = (32, 64, 96, 128, 192, 256, 512, 1024)
KS = (0, 8, 10, 11, 12, 13, 14)
K2_KERNELS = ("speculate_kernel", "repair_kernel", "settle_kernel",
              "wide_flags_kernel")
K3_KERNELS = ("speculate_kernel", "repair_kernel", "settle_kernel")


def device_ms(fn, keys, calls: int = 10) -> float:
    """Device ms a call of `fn`: over `calls` warm calls, the sum over
    `keys` of the mean span of the kernels whose names hold the key."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = _device_intervals(prof)
    ms = 0.0
    for key in keys:
        spans = [e - s for s, e, name in events if key in name]
        if not spans:
            raise RuntimeError(f"the profiler saw no kernel named *{key}*")
        ms += sum(spans) / len(spans) / 1e3
    return ms


def k2_sweep(imgs, dev) -> dict:
    """{sub-chunk or "one walker": device ms} of K2 over each image's route
    chunks, a mean over the images."""
    ops = []
    for im in imgs:
        scans, lens, _ = approx_rle._wide_chunks(hilbert.linearize(im))
        rgb, ln = approx_rle._position_major(scans, lens, dev)
        ops.append((rgb, ln, approx_rle.wide_records(rgb, ln, 4,
                                                     chunk=rgb.shape[0])))
    out = {}
    for chunk in WIDE_CHUNKS + (None,):
        ms = 0.0
        for rgb, ln, want in ops:
            c = rgb.shape[0] if chunk is None else chunk
            got = approx_rle.wide_records(rgb, ln, 4, chunk=c)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"K2 at sub-chunk {chunk} differs from "
                                   "one walker")
            ms += device_ms(lambda: approx_rle.wide_records(  # noqa: B023
                rgb, ln, 4, chunk=c), K2_KERNELS if chunk else ("wide_kernel",))
        out[chunk or "one walker"] = ms / len(ops)
    return out


def k3_sweep(imgs, dev) -> dict:
    """{chunk: device ms} of K3 over the images' Hilbert scans."""
    scans = np.stack([hilbert.linearize(im) for im in imgs])
    rgb, ln = approx_rle._position_major(scans, [scans.shape[1]] * len(imgs),
                                         dev)
    want = approx_rle.batch_records(rgb, ln, 4.0, chunk=rgb.shape[0])
    out = {}
    for chunk in CHUNKS:
        got = approx_rle.batch_records(rgb, ln, 4.0, chunk=chunk)
        if not torch.equal(got, want):
            raise RuntimeError(f"K3 at chunk {chunk} differs from one walker")
        out[chunk] = device_ms(lambda: approx_rle.batch_records(  # noqa: B023
            rgb, ln, 4.0, chunk=chunk), K3_KERNELS)
    return out


def d2_sweep(img, dev) -> dict:
    """{K: (pass-1 ms, pass-2 ms)} of D2 on the image's Hufman payload."""
    _, freqs, ids = histogram.color_histogram(pixels_row_major(img))
    book = huffman.build_codebook(freqs)
    tree = huffman.serialize_tree(book, np.zeros((freqs.size, 1), np.uint8))
    left, right, symbol, _, _ = huffman.parse_tree(
        np.frombuffer(tree, np.uint8), 1)
    payload = native.pack_bits(book.codes, book.lens, ids)
    pay, lr2, s1, e1, chunk, chunk_ends, total = hufdec.lanes(
        np.frombuffer(payload, np.uint8), left, right, symbol, dev)
    exits, counts, _, _ = hufdec.walk(pay, lr2, s1, e1, total)
    offs, out_start = (torch.from_numpy(a).to(dev)
                       for a in hufdec.compose(exits, counts, ids.size))
    passes = (lambda K: hufdec.walk(pay, lr2, s1, e1, total, K=K),
              lambda K: hufdec.walk(pay, lr2, chunk + offs, chunk_ends, total,
                                    out_start=out_start, n_symbols=ids.size,
                                    K=K))
    out = {}
    for K in KS:
        keys = ("walk_kernel", "table_kernel") if K else ("walk_kernel",)
        out[K] = tuple(device_ms(lambda: fn(K), keys)  # noqa: B023
                       for fn in passes)
    return out


def d1_split(imgs, dev, calls: int = 10) -> dict:
    """{schedule: {name: device ms a call}} of everything D1's wrapper puts
    on the card for the images' Hufman id streams in one batched call."""
    from torch.profiler import ProfilerActivity, profile

    stats = [histogram.color_histogram(pixels_row_major(im)) for im in imgs]
    ids, freqs = [s[2] for s in stats], [s[1] for s in stats]
    books = [huffman.build_codebook(f) for f in freqs]
    arr_ids, codes, lens, totals = huffman.batch_arrays(ids, freqs, books)
    ops = bitpack.operands(arr_ids, codes, lens, dev)
    n_words = max((int(t) + 31) // 32 for t in totals)
    out = {}
    for label, one_pass in (("one thread a symbol", False), ("one pass", True)):
        def fn(one_pass=one_pass):
            bitpack.pack_words(*ops, n_words, one_pass=one_pass)

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split = {}
        for start, end, name in _device_intervals(prof):
            name = re.sub(r"^void ", "", name.replace(
                "(anonymous namespace)::", ""))
            name = re.split(r"[<(]", name)[0].split("::")[-1]
            split[name] = split.get(name, 0.0) + (end - start) / 1e3 / calls
        out[label] = split
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("schedule_sweep needs a CUDA card")
    dev = torch.device("cuda")
    keep_cupti()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    rng = np.random.default_rng(SEED)
    imgs = [synth_image(rng, 1024, 1024) for _ in range(8)]
    k2 = k2_sweep(imgs, dev)
    print("K2 at 1024 streams x 1024 (the route's chunks of a 1024^2 scan), "
          "kernels alone (ms) by sub-chunk: "
          + ", ".join(f"{c}: {t:.4f}" for c, t in k2.items()))
    k3 = k3_sweep(imgs, dev)
    print("K3 at 8 x 1024^2, kernels alone (ms) by chunk: "
          + ", ".join(f"{c}: {t:.4f}" for c, t in k3.items()))
    d2 = d2_sweep(imgs[0], dev)
    print("D2 on a 1024^2 Hufman payload, kernels alone (ms, pass 1 / pass "
          "2) by K: " + ", ".join(f"{K}: {a:.4f} / {b:.4f}"
                                  for K, (a, b) in d2.items()))
    d1 = d1_split(imgs, dev)
    for label, split in d1.items():
        print(f"D1 at 8 x 1024^2 ids, {label}: everything a call puts on the "
              "card (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
                  split.items(), key=lambda kv: -kv[1])))
    print(json.dumps({"card": card, "k2_ms_by_chunk": k2,
                      "k3_ms_by_chunk": k3,
                      "d2_ms_by_K": {K: list(t) for K, t in d2.items()},
                      "d1_device_ms_by_schedule": d1}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
