"""Huffman coding pipeline (reference src/huf.rs), port of ``cniic_tpu/huffman.py``.

Host (native C runtime), the default: histogramming, optimal code lengths,
the canonical code, preorder tree emission and parsing, the bit packer and
the 16-bit prefix-table decoder. ``pack_bits_numpy`` (the vectorized numpy
packer, the ``device=False`` oracle) lives in ``ops/bitpack.py`` as in the
reference and is re-exported here.

Device, behind the reference's env gates, on the torch device given as
``torch_device`` (the codec's device; "cuda" by default, and a missing card
raises):

* ``CNIIC_DEVICE_BITPACK=1``: the payload is packed by D1
  (``ops/bitpack.py``): `encode_payload`, and the batched packer in
  `batch_encode_streams` / `batch_encode`;
* ``CNIIC_DEVICE_HUF_DECODE=1``: the payload is decoded by the chunked
  self-synchronizing decoder D2 (``ops/hufdec.py``) first; where it declines
  (returns None) the host decoder runs, exactly where the reference's does.

On a CPU device the gates run the kernels' plain versions, so the CPU tests
cover them. ``device`` in `encode_payload` / `encode_stream` keeps the
reference's meaning: False selects the numpy oracle instead of a packer.

Wire format is byte-identical to the reference: the decoder trie serialized
preorder (tag 0 = leaf + payload, 1 = branch; huf.rs:296-321) followed by the
MSB-first packed payload, zero-padded to a byte (bit.rs:243-253).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from . import native, trace
from .ops.bitpack import pack_bits_numpy

__all__ = ["Codebook", "pack_bits_numpy", "build_codebook", "serialize_tree",
           "parse_tree", "encode_payload", "decode_payload", "encode_stream",
           "batch_arrays", "batch_encode_streams", "batch_encode",
           "decode_stream"]


def _gate(flag: str) -> bool:
    return os.environ.get(flag, "") == "1"


@dataclass
class Codebook:
    """Canonical Huffman codebook over `u` symbols (caller's symbol order)."""

    codes: np.ndarray      # uint64[u], right-aligned code bits
    lens: np.ndarray       # uint32[u]
    tags: np.ndarray       # uint8[2u-1] preorder tags
    leaf_sym: np.ndarray   # int32[u]: symbol index of k-th preorder leaf

    @property
    def n_symbols(self) -> int:
        return self.codes.size


def build_codebook(freqs: np.ndarray) -> Codebook:
    """Build the canonical codebook for symbol frequencies (caller order),
    the sort + two-queue + unscatter as one C call."""
    freqs = np.asarray(freqs, dtype=np.uint64)
    lens = native.huf_lens_unsorted(freqs)
    codes, tags, leaf_sym = native.huf_canonical(lens)
    return Codebook(codes=codes, lens=lens, tags=tags, leaf_sym=leaf_sym)


def serialize_tree(book: Codebook, leaf_payloads: np.ndarray) -> bytes:
    """Preorder tree bytes; leaf_payloads is uint8[u, leaf_size]."""
    return native.huf_tree_serialize(book.tags, book.leaf_sym,
                                     leaf_payloads)


def parse_tree(data, leaf_size: int):
    """Parse preorder tree bytes.

    Returns (left, right, symbol, payloads uint8[u, leaf_size], consumed).
    `symbol[i]` numbers leaves in preorder; payloads row k belongs to
    preorder leaf k.
    """
    left, right, symbol, payloads, n_nodes, consumed = native.huf_tree_parse(data, leaf_size)
    return left, right, symbol, payloads, consumed


def _total_bits(freqs, book: Codebook) -> int:
    """Payload size in bits (sum freq * len), known before any packing."""
    return int(np.asarray(freqs, np.uint64) @ book.lens)


def encode_payload(symbol_ids: np.ndarray, book: Codebook, device: bool = True,
                   total_bits: int | None = None,
                   torch_device="cuda") -> bytes:
    """Pack the symbol stream with the codebook: the native C packer, D1 on
    `torch_device` under CNIIC_DEVICE_BITPACK=1, or with device=False the
    vectorized-numpy oracle."""
    if symbol_ids.size == 0:
        return b""
    if not device:
        return pack_bits_numpy(book.codes[symbol_ids], book.lens[symbol_ids])
    if _gate("CNIIC_DEVICE_BITPACK"):
        from .ops import bitpack

        return bitpack.pack_bits_device(symbol_ids.astype(np.int32),
                                        book.codes, book.lens, total_bits,
                                        device=torch_device)
    return native.pack_bits(book.codes, book.lens, symbol_ids)


def decode_payload(payload, left, right, symbol, n_symbols: int,
                   torch_device="cuda") -> np.ndarray:
    """Decode the payload into preorder-leaf ids: the native 16-bit
    prefix-table decoder, after D2 on `torch_device` under
    CNIIC_DEVICE_HUF_DECODE=1 where D2 declines."""
    if _gate("CNIIC_DEVICE_HUF_DECODE"):
        from .ops import hufdec

        out = hufdec.decode_payload_device(payload, left, right, symbol,
                                           n_symbols, device=torch_device)
        if out is not None:
            return out
    out = native.huf_decode(payload, left, right, symbol, 0, n_symbols)
    if out.size != n_symbols:
        raise ValueError(f"Huffman payload exhausted: {out.size}/{n_symbols} symbols")
    return out


def encode_stream(symbol_ids: np.ndarray, freqs: np.ndarray,
                  leaf_payloads: np.ndarray, device: bool = True,
                  torch_device="cuda") -> bytes:
    """Full huf::encode_all analog (huf.rs:22-43): tree bytes + packed payload."""
    book = build_codebook(freqs)
    return serialize_tree(book, leaf_payloads) + encode_payload(
        symbol_ids, book, device=device, total_bits=_total_bits(freqs, book),
        torch_device=torch_device)


def batch_arrays(ids_list, freqs_list, books):
    """The batched packer's host arrays for B streams: ids int32 [B, n_max]
    (padded), codes u64 and lens u32 [B, max(u) + 1], and each stream's
    payload bits. The column past the largest alphabet is zero: each
    stream's padding ids point at its own first unused entry (u_i), a
    zero-length code."""
    B = len(ids_list)
    ids = np.empty((B, max(i.size for i in ids_list)), dtype=np.int32)
    u_pad = max(f.size for f in freqs_list) + 1
    codes = np.zeros((B, u_pad), dtype=np.uint64)
    lens = np.zeros((B, u_pad), dtype=np.uint32)
    total_bits = []
    for i, (sym, freqs, book) in enumerate(zip(ids_list, freqs_list, books)):
        u = freqs.size
        codes[i, :u] = book.codes
        lens[i, :u] = book.lens
        ids[i, : sym.size] = sym
        ids[i, sym.size:] = u
        total_bits.append(_total_bits(freqs, book))
    return ids, codes, lens, total_bits


def batch_encode_streams(ids_list, freqs_list, leafs_list,
                         torch_device="cuda") -> list[bytes]:
    """Batched encode_all for pre-resolved symbol streams.

    Host default: each stream end to end (tree + C pack) before the next.
    Under CNIIC_DEVICE_BITPACK=1: the trees on the host, then every payload
    in one D1 launch on `torch_device` (ops/bitpack.pack_bits_batch).

    ids_list: per-stream int arrays of symbol ids (< the stream's alphabet).
    freqs_list: per-stream symbol frequencies (the codebook input).
    leafs_list: per-stream uint8[u, leaf_size] wire payloads per symbol.
    """
    if not ids_list:
        return []
    if not _gate("CNIIC_DEVICE_BITPACK"):
        out = []
        with trace.span("huffman.encode"):
            for sym, freqs, leafs in zip(ids_list, freqs_list, leafs_list):
                book = build_codebook(freqs)
                out.append(serialize_tree(book, leafs) +
                           native.pack_bits(book.codes, book.lens,
                                            np.asarray(sym, np.int32)))
        return out
    from .ops import bitpack

    books = []
    trees = []
    with trace.span("huffman.trees"):
        for freqs, leafs in zip(freqs_list, leafs_list):
            book = build_codebook(freqs)
            books.append(book)
            trees.append(serialize_tree(book, leafs))

    with trace.span("huffman.pack"):
        ids, codes, lens, total_bits = batch_arrays(ids_list, freqs_list,
                                                    books)
        payloads = bitpack.pack_bits_batch(ids, codes, lens, total_bits,
                                           device=torch_device)
    return [t + p for t, p in zip(trees, payloads)]


def batch_encode(keys_list, uniq_to_payload, torch_device="cuda") -> list[bytes]:
    """Batched Huffman encode (tree bytes + packed payload per stream).

    keys_list: per-stream uint32 symbol-key arrays (values < 2^31-1).
    uniq_to_payload: fn(uniq_keys uint32[u]) -> uint8[u, leaf_size] wire
    payloads for the tree leaves.

    The statistics run in the host C radix histogram; the packing goes
    through `batch_encode_streams` (D1 under CNIIC_DEVICE_BITPACK=1).
    """
    stats = []
    with trace.span("huffman.stats"):
        for k in keys_list:
            stats.append(native.hist_u32(k))
    return batch_encode_streams(
        [inv for (_, _, inv) in stats],
        [counts for (_, counts, _) in stats],
        [uniq_to_payload(uniq) for (uniq, _, _) in stats],
        torch_device=torch_device)


def decode_stream(data, leaf_size: int, n_symbols: int, torch_device="cuda"):
    """Full huf::decode_all analog: returns (payloads uint8[u, leaf_size],
    decoded leaf-ids int32[n_symbols])."""
    left, right, symbol, payloads, consumed = parse_tree(data, leaf_size)
    body = np.frombuffer(bytes(data), dtype=np.uint8)[consumed:]
    # every symbol costs >= 1 payload bit, so a symbol count beyond
    # 8*len(body) can never be satisfied: reject before allocating. The
    # one legal exception is the single-leaf tree (0-bit codes, empty
    # body), which the body.size test exempts; its allocation is bounded
    # by the dims plausibility cap (wire.ByteReader.dims).
    if body.size and n_symbols > 8 * body.size:
        raise ValueError(
            f"Huffman stream too short for {n_symbols} symbols")
    ids = decode_payload(body, left, right, symbol, n_symbols,
                         torch_device=torch_device)
    return payloads, ids
