"""ctypes bindings to the host C runtime (``csrc/cniic_native.c``).

Copy of the loader in ``cniic_tpu/native/__init__.py``, cut to the entry
points the ported codecs reach: for the k-means codecs the histograms,
Huffman tree and bit packing, Rgb framing, gathers and the MSE sum; for the
Hilbert family the curve generator, the row gathers and scatters, the RLE
framing and fused decode, zip-dict and the exact-f64 approximate-RLE
engine; for delta the diff keys, the fused gather+diff+histogram pass and
the fused decode; zip-back for `zip(back)`. The C source is the port's own
byte-for-byte copy of the reference's one file
(``cniic_tpu/native/cniic_native.c``), compiled into this package's
``_build/`` directory and rebuilt whenever the source is newer; with
``CNIIC_NATIVE_LIB`` set, the library it names is loaded instead, as the
loader of ``cniic_tpu/native`` does.
All entry points release the GIL for the duration of the call (plain ctypes
semantics), so host-side codec work can overlap device work from other
threads, and a batch's images run on several threads at once
(`codecs.base.host_map`); the library is loaded and its argtypes declared
once, under a lock.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import _build

_SRC = os.path.join(_build.PKG_DIR, "csrc", "cniic_native.c")


def _commands():
    cc = os.environ.get("CC", "cc")
    flags = ["-O3", "-fPIC", "-shared", "-fvisibility=hidden", "-o", "{out}",
             _SRC, "-lm"]
    # -march=native unlocks the AVX2 candidate pre-filter in the zip-back
    # scan; the library is built per machine, so native codegen is safe.
    # The portable build follows if the compiler rejects the flag.
    return [[cc, "-march=native"] + flags, [cc] + flags]


_lib = None
_load_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    """The C runtime with every entry point's argtypes declared. The first
    calls may come from several threads at once (`codecs.base.host_map`):
    the lock keeps any of them from using the library before its argtypes
    are all set."""
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is None:
            _declare()
    return _lib


def _declare() -> None:
    global _lib
    # CNIIC_NATIVE_LIB names an alternate prebuilt library (the ASan fuzz
    # build, `make asan-fuzz`), loaded as-is and never rebuilt. Read here,
    # once, at first use, so a variable set after import is seen.
    override = os.environ.get("CNIIC_NATIVE_LIB")
    if override:
        lib = ctypes.CDLL(override)
    else:
        lib = _build.load("cniic_native", [_SRC], _commands())

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(i64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)

    lib.gilbert_curve.argtypes = [i64, i64, i32p]
    lib.gilbert_curve.restype = ctypes.c_int

    lib.huf_decode.argtypes = [u8p, i64, i32p, i32p, i32p, i64, ctypes.c_int32, i64, i32p]
    lib.huf_decode.restype = i64
    lib.huf_decode_fast.argtypes = lib.huf_decode.argtypes
    lib.huf_decode_fast.restype = i64
    for name in ("zip_dict_encode", "zip_back_encode"):
        fn = getattr(lib, name)
        fn.argtypes = [u8p, i64, ctypes.POINTER(u8p), ctypes.POINTER(i64)]
        fn.restype = ctypes.c_int
    for name in ("zip_dict_decode", "zip_back_decode"):
        fn = getattr(lib, name)
        fn.argtypes = [u8p, i64, ctypes.POINTER(u8p), ctypes.POINTER(i64),
                       i64]
        fn.restype = ctypes.c_int

    lib.approx_rle_encode.argtypes = [u8p, i64, ctypes.c_double, u8p, u8p]
    lib.approx_rle_encode.restype = i64

    lib.gather_rgb.argtypes = [u8p, i64p, i64, u8p]
    lib.gather_rgb.restype = None
    lib.scatter_rgb.argtypes = [u8p, i64p, i64, u8p]
    lib.scatter_rgb.restype = None
    lib.rle_frame.argtypes = [u8p, i64, u8p]
    lib.rle_frame.restype = i64
    lib.rle_frame_gather.argtypes = [u8p, i64p, i64, u8p]
    lib.rle_frame_gather.restype = i64
    lib.rle_records_frame.argtypes = [u8p, u8p, i64, u8p]
    lib.rle_records_frame.restype = None
    lib.rle_unframe_scatter.argtypes = [u8p, i64, i64p, i64, u8p]
    lib.rle_unframe_scatter.restype = ctypes.c_int

    lib.rgb_frame.argtypes = [u8p, i64, u8p]
    lib.rgb_frame.restype = None
    lib.rgb_unframe.argtypes = [u8p, i64, u8p]
    lib.rgb_unframe.restype = ctypes.c_int
    lib.palette_gather_rgb.argtypes = [i32p, u8p, i64, u8p]
    lib.palette_gather_rgb.restype = None
    lib.gather_i32.argtypes = [i32p, i32p, i64, i32p]
    lib.gather_i32.restype = None
    lib.huf_tree_serialize.argtypes = [u8p, i64, i32p, u8p, i64, u8p]
    lib.huf_tree_serialize.restype = i64
    lib.hist_u32.argtypes = [u32p, i64, u32p, i64p, i32p]
    lib.hist_u32.restype = i64
    lib.huf_lens_unsorted.argtypes = [u64p, i64, u32p]
    lib.huf_lens_unsorted.restype = ctypes.c_int
    lib.huf_canonical.argtypes = [u32p, i64, u64p, u8p, i32p]
    lib.huf_canonical.restype = ctypes.c_int
    lib.huf_tree_count.argtypes = [u8p, i64, i64, i64p]
    lib.huf_tree_count.restype = i64
    lib.huf_tree_parse.argtypes = [u8p, i64, i64, i32p, i32p, i32p, u8p, i64, i64p]
    lib.huf_tree_parse.restype = i64
    lib.pack_bits.argtypes = [u64p, u32p, i32p, i64, u8p]
    lib.pack_bits.restype = i64
    lib.hist_rgb.argtypes = [u8p, i64, u32p, i64p, i32p]
    lib.hist_rgb.restype = i64
    lib.delta_keys.argtypes = [u8p, i64, u32p]
    lib.delta_keys.restype = None
    lib.delta_keys_gather.argtypes = [u8p, i64p, i64, u32p]
    lib.delta_keys_gather.restype = None
    lib.delta_hist_gather.argtypes = [u8p, i64p, i64, u32p, i64p, i32p]
    lib.delta_hist_gather.restype = i64
    lib.delta_unpack.argtypes = [u8p, i64, i32p, i64, i64p, u8p]
    lib.delta_unpack.restype = ctypes.c_int
    lib.mse_sum_u8.argtypes = [u8p, u8p, i64]
    lib.mse_sum_u8.restype = ctypes.c_uint64

    lib.cniic_buf_free.argtypes = [u8p]
    lib.cniic_buf_free.restype = None

    _lib = lib


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _as_i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _as_i64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _as_u32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def gilbert_curve(w: int, h: int) -> np.ndarray:
    """(w*h, 2) int32 array of (x, y) coordinates of the scan."""
    lib = _load()
    out = np.empty((w * h, 2), dtype=np.int32)
    rc = lib.gilbert_curve(w, h, _as_i32p(out))
    if rc != 0:
        raise RuntimeError(f"gilbert_curve failed: {rc}")
    return out


def mse_sum_u8(a: np.ndarray, b: np.ndarray) -> int:
    """Exact sum of squared byte differences (the bench.rs:95-104 MSE
    numerator). Arrays must have the same size; any shape/uint8 dtype."""
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.uint8).reshape(-1)
    b = np.ascontiguousarray(b, dtype=np.uint8).reshape(-1)
    if a.size != b.size:
        raise ValueError(f"size mismatch: {a.size} vs {b.size}")
    return int(lib.mse_sum_u8(_as_u8p(a), _as_u8p(b), a.size))


def huf_decode(payload: bytes | np.ndarray, left: np.ndarray, right: np.ndarray,
               symbol: np.ndarray, root: int, n_symbols: int,
               fast: bool = True) -> np.ndarray:
    """Decode an MSB-first payload into symbol ids. Default is the 16-bit
    prefix-table decoder (huf_decode_fast); fast=False forces the plain
    bit-serial trie walk (the conformance oracle — both decode identical
    ids for any valid preorder tree, pinned by tests)."""
    lib = _load()
    pay = np.frombuffer(bytes(payload), dtype=np.uint8) if not isinstance(payload, np.ndarray) else payload
    pay = np.ascontiguousarray(pay, dtype=np.uint8)
    left = np.ascontiguousarray(left, dtype=np.int32)
    right = np.ascontiguousarray(right, dtype=np.int32)
    symbol = np.ascontiguousarray(symbol, dtype=np.int32)
    out = np.empty(n_symbols, dtype=np.int32)
    fn = lib.huf_decode_fast if fast else lib.huf_decode
    got = fn(
        _as_u8p(pay), pay.size, _as_i32p(left), _as_i32p(right), _as_i32p(symbol),
        left.size, root, n_symbols, _as_i32p(out))
    if got < 0:
        raise ValueError("malformed Huffman stream")
    return out[:got]


def pack_bits(codes: np.ndarray, lens: np.ndarray, ids: np.ndarray) -> bytes:
    """MSB-first bit-pack of a symbol-id stream (bit.rs semantics). The
    output buffer is sized from the worst case (max code length x symbols);
    the C engine reports the exact byte count."""
    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    lens = np.ascontiguousarray(lens, dtype=np.uint32)
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    cap = (int(lens.max(initial=0)) * ids.size + 7) // 8 + 1
    out = np.empty(max(cap, 1), dtype=np.uint8)
    got = lib.pack_bits(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _as_i32p(ids), ids.size, _as_u8p(out))
    return out[:got].tobytes()


def hist_rgb(pixels: np.ndarray):
    """(uniq keys asc, counts i64, inverse i32) for an (N, 3) uint8 stream —
    hist_u32 over the packed 24-bit colors with the packing fused in C."""
    lib = _load()
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    n = pixels.shape[0]
    uniq = np.empty(n, dtype=np.uint32)
    counts = np.empty(n, dtype=np.int64)
    inverse = np.empty(n, dtype=np.int32)
    u = lib.hist_rgb(_as_u8p(pixels), n,
                     uniq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                     counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                     _as_i32p(inverse))
    if u < 0:
        raise MemoryError("hist_rgb")
    return uniq[:u].copy(), counts[:u].copy(), inverse


def hist_u32(keys: np.ndarray):
    """(uniq asc, counts i64, inverse i32) for a uint32 key stream."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n = keys.size
    uniq = np.empty(n, dtype=np.uint32)
    counts = np.empty(n, dtype=np.int64)
    inverse = np.empty(n, dtype=np.int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u = lib.hist_u32(keys.ctypes.data_as(u32p), n, uniq.ctypes.data_as(u32p),
                     counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                     _as_i32p(inverse))
    if u < 0:
        raise MemoryError("hist_u32 failed")
    return uniq[:u].copy(), counts[:u].copy(), inverse


def huf_tree_serialize(tags: np.ndarray, leaf_sym: np.ndarray,
                       payloads: np.ndarray) -> bytes:
    """Preorder tree bytes from tag sequence + leaf payload mapping."""
    lib = _load()
    tags = np.ascontiguousarray(tags, dtype=np.uint8)
    leaf_sym = np.ascontiguousarray(leaf_sym, dtype=np.int32)
    payloads = np.ascontiguousarray(payloads, dtype=np.uint8)
    u, leaf_size = payloads.shape if payloads.ndim == 2 else (0, 0)
    if leaf_sym.size != u:
        raise ValueError("leaf_sym/payloads mismatch")
    out = np.empty(tags.size + u * leaf_size, dtype=np.uint8)
    w = lib.huf_tree_serialize(_as_u8p(tags), tags.size, _as_i32p(leaf_sym),
                               _as_u8p(payloads), leaf_size, _as_u8p(out))
    return out[:w].tobytes()


def gather_i32(idx: np.ndarray, table: np.ndarray) -> np.ndarray:
    """(N,) int32 indices + (u,) int32 table -> (N,) int32. idx must be
    in-range (encoder-internal: histogram inverse ids)."""
    lib = _load()
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    table = np.ascontiguousarray(table, dtype=np.int32)
    out = np.empty(idx.size, dtype=np.int32)
    lib.gather_i32(_as_i32p(idx), _as_i32p(table), idx.size, _as_i32p(out))
    return out


def palette_gather(ids: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """(N,) int32 ids + (u, 3) u8 palette -> (N, 3) u8. ids must be
    in-range (decoder-internal; huf_decode bounds them by the tree)."""
    lib = _load()
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    colors = np.ascontiguousarray(colors, dtype=np.uint8).reshape(-1, 3)
    out = np.empty((ids.size, 3), dtype=np.uint8)
    lib.palette_gather_rgb(_as_i32p(ids), _as_u8p(colors), ids.size,
                           _as_u8p(out))
    return out


def rgb_frame(rgb: np.ndarray) -> np.ndarray:
    """(N, 3) uint8 -> (N*11,) uint8 of 11-byte Rgb wire records."""
    lib = _load()
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8).reshape(-1, 3)
    out = np.empty(rgb.shape[0] * 11, dtype=np.uint8)
    lib.rgb_frame(_as_u8p(rgb), rgb.shape[0], _as_u8p(out))
    return out


def rgb_unframe(framed: np.ndarray, count: int) -> np.ndarray:
    """Inverse of rgb_frame; validates every length prefix."""
    lib = _load()
    framed = np.ascontiguousarray(framed, dtype=np.uint8)
    out = np.empty((count, 3), dtype=np.uint8)
    if lib.rgb_unframe(_as_u8p(framed), count, _as_u8p(out)) != 0:
        raise ValueError("corrupt Rgb length prefix in pixel stream")
    return out


def huf_lens_unsorted(freqs: np.ndarray) -> np.ndarray:
    """Optimal Huffman code lengths from frequencies in ANY order (caller
    order preserved). One C call fusing the stable ascending argsort, the
    two-queue pass, and the scatter back."""
    lib = _load()
    f = np.ascontiguousarray(freqs, dtype=np.uint64)
    lens = np.empty(f.size, dtype=np.uint32)
    rc = lib.huf_lens_unsorted(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), f.size,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if rc != 0:
        raise ValueError("huf_lens_unsorted failed")
    return lens


def huf_canonical(lens: np.ndarray):
    """Canonical codes + preorder tree. Returns (codes u64, tags u8[2u-1],
    leaf_sym i32[u]) — leaf_sym[k] is the symbol at the k-th preorder leaf."""
    lib = _load()
    l = np.ascontiguousarray(lens, dtype=np.uint32)
    u = l.size
    codes = np.empty(u, dtype=np.uint64)
    tags = np.empty(max(2 * u - 1, 1), dtype=np.uint8)
    leaf_sym = np.empty(u, dtype=np.int32)
    rc = lib.huf_canonical(
        l.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), u,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _as_u8p(tags), _as_i32p(leaf_sym))
    if rc != 0:
        raise ValueError("huf_canonical failed (invalid code-length set)")
    return codes, tags, leaf_sym


def huf_tree_parse(data, leaf_size: int):
    """Parse a preorder trie. Returns (left, right, symbol,
    payloads uint8[n_leaves, leaf_size], n_nodes, consumed_bytes)."""
    lib = _load()
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else np.ascontiguousarray(data, dtype=np.uint8)
    # exact-size the tables with a tag-only counting pass: `data` is the
    # whole remaining stream (tree + multi-MB payload), so sizing from its
    # length transiently allocated ~20 bytes per stream byte per decode
    consumed0 = ctypes.c_int64()
    n_count = lib.huf_tree_count(_as_u8p(arr), arr.size, leaf_size,
                                 ctypes.byref(consumed0))
    if n_count < 0:
        raise ValueError("malformed Huffman tree stream")
    max_nodes = n_count
    n_leaves = (n_count + 1) // 2  # preorder trie: leaves = (nodes+1)/2
    left = np.empty(max_nodes, dtype=np.int32)
    right = np.empty(max_nodes, dtype=np.int32)
    symbol = np.empty(max_nodes, dtype=np.int32)
    payloads = np.empty((n_leaves, leaf_size), dtype=np.uint8)
    consumed = ctypes.c_int64()
    n = lib.huf_tree_parse(
        _as_u8p(arr), arr.size, leaf_size, _as_i32p(left), _as_i32p(right),
        _as_i32p(symbol), _as_u8p(payloads),
        max_nodes, ctypes.byref(consumed))
    if n < 0:
        raise ValueError("malformed Huffman tree stream")
    # the count and parse passes walk the same tag stream, so n == max_nodes
    # on success: the tables are exact-size, no trailing slack to trim
    assert n == max_nodes, (n, max_nodes)
    return (left, right, symbol, payloads, int(n), int(consumed.value))


def delta_keys(scan: np.ndarray) -> np.ndarray:
    """Packed (d+255) 9-bit-per-channel diff keys of an (N, 3) uint8 scan."""
    lib = _load()
    scan = np.ascontiguousarray(scan, dtype=np.uint8)
    out = np.empty(scan.shape[0], dtype=np.uint32)
    lib.delta_keys(_as_u8p(scan), scan.shape[0], _as_u32p(out))
    return out


def delta_keys_gather(flat: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """delta_keys fused with the curve gather: keys of flat[perm] without
    materializing the (N, 3) scan."""
    lib = _load()
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    if flat.shape[0] != perm.size:
        raise ValueError("flat/perm length mismatch")
    out = np.empty(perm.size, dtype=np.uint32)
    lib.delta_keys_gather(_as_u8p(flat), _as_i64p(perm), perm.size,
                          _as_u32p(out))
    return out


def delta_hist_gather(flat: np.ndarray, perm: np.ndarray):
    """(uniq asc, counts i64, inverse i32) of the delta diff keys of
    flat[perm]: curve gather + diff + pack + histogram fused in one C pass.
    Output-identical to hist_u32(delta_keys_gather(flat, perm))."""
    lib = _load()
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    n = perm.size
    if flat.shape[0] != n:
        raise ValueError("flat/perm length mismatch")
    uniq = np.empty(n, dtype=np.uint32)
    counts = np.empty(n, dtype=np.int64)
    inverse = np.empty(n, dtype=np.int32)
    u = lib.delta_hist_gather(_as_u8p(flat), _as_i64p(perm), n,
                              _as_u32p(uniq), _as_i64p(counts),
                              _as_i32p(inverse))
    if u < 0:
        raise MemoryError("delta_hist_gather failed")
    return uniq[:u].copy(), counts[:u].copy(), inverse


def delta_unpack(payloads: np.ndarray, ids: np.ndarray,
                 perm: np.ndarray) -> np.ndarray:
    """Fused delta decode: 6-byte i16-LE leaves + symbol ids -> running
    3-channel sums scattered through perm into a (len(perm), 3) uint8
    image, range-checked, in one C pass."""
    lib = _load()
    payloads = np.ascontiguousarray(payloads, dtype=np.uint8).reshape(-1, 6)
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    if ids.size != perm.size:
        raise ValueError("ids/perm length mismatch")
    out = np.empty((perm.size, 3), dtype=np.uint8)
    rc = lib.delta_unpack(_as_u8p(payloads), payloads.shape[0],
                          _as_i32p(ids), ids.size, _as_i64p(perm),
                          _as_u8p(out))
    if rc == -1:
        raise ValueError("delta symbol id out of range")
    if rc == -2:
        raise ValueError("delta decode out of u8 range")
    return out


def rle_unframe_scatter(recs: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Fused RLE decode: validate 12-byte records, expand runs and scatter
    through perm into a (len(perm), 3) uint8 image in one C pass. Raises on
    corrupt prefixes or short streams."""
    lib = _load()
    recs = np.ascontiguousarray(recs, dtype=np.uint8)
    if recs.size % 12:
        raise ValueError("RLE stream is not a whole number of records")
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    out = np.empty((perm.size, 3), dtype=np.uint8)
    rc = lib.rle_unframe_scatter(_as_u8p(recs), recs.size // 12,
                                 _as_i64p(perm), perm.size, _as_u8p(out))
    if rc == -1:
        raise ValueError("corrupt Rgb prefix in RLE record")
    if rc == -2:
        raise ValueError("RLE stream too short")
    return out


# absolute wire-format maximum any legitimate zipc stream decodes to:
# 8 dim bytes + 11 bytes/pixel at the framework's 2^27-pixel cap. A
# crafted LZ78/LZ77 stream can otherwise demand unbounded output from a few
# hundred input bytes.
_ZIP_MAX_OUT = 8 + 11 * (1 << 27)


def _roundtrip_call(name: str, data, max_out: int | None = None) -> bytes:
    lib = _load()
    arr = (np.frombuffer(bytes(data), dtype=np.uint8)
           if not isinstance(data, np.ndarray)
           else np.ascontiguousarray(data, dtype=np.uint8))
    out_p = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64()
    args = [_as_u8p(arr), arr.size, ctypes.byref(out_p),
            ctypes.byref(out_len)]
    if max_out is not None:
        args.append(int(max_out))
    rc = getattr(lib, name)(*args)
    if rc == -2:
        raise ValueError(f"{name}: decoded stream exceeds the "
                         f"{max_out}-byte cap")
    if rc != 0:
        raise ValueError(f"{name} failed ({rc})")
    try:
        return ctypes.string_at(out_p, out_len.value)
    finally:
        lib.cniic_buf_free(out_p)


def zip_dict_encode(data) -> bytes:
    return _roundtrip_call("zip_dict_encode", data)


def zip_dict_decode(data, max_out: int = _ZIP_MAX_OUT) -> bytes:
    return _roundtrip_call("zip_dict_decode", data, max_out)


def zip_back_encode(data) -> bytes:
    return _roundtrip_call("zip_back_encode", data)


def zip_back_decode(data, max_out: int = _ZIP_MAX_OUT) -> bytes:
    return _roundtrip_call("zip_back_decode", data, max_out)


def gather_rgb(rgb: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """out[i] = rgb[perm[i]] over (N, 3) uint8 rows (int64 indices)."""
    lib = _load()
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8).reshape(-1, 3)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    out = np.empty((perm.size, 3), dtype=np.uint8)
    lib.gather_rgb(_as_u8p(rgb), _as_i64p(perm), perm.size, _as_u8p(out))
    return out


def scatter_rgb(rgb: np.ndarray, perm: np.ndarray, n_out: int) -> np.ndarray:
    """out[perm[i]] = rgb[i] over (N, 3) uint8 rows (int64 indices)."""
    lib = _load()
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8).reshape(-1, 3)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    out = np.empty((n_out, 3), dtype=np.uint8)
    lib.scatter_rgb(_as_u8p(rgb), _as_i64p(perm), perm.size, _as_u8p(out))
    return out


def rle_frame(rgb: np.ndarray) -> bytes:
    """(N, 3) uint8 -> exact-RLE 12-byte records (count + 11-byte Rgb)."""
    lib = _load()
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8).reshape(-1, 3)
    out = np.empty(rgb.shape[0] * 12, dtype=np.uint8)
    nbytes = lib.rle_frame(_as_u8p(rgb), rgb.shape[0], _as_u8p(out))
    return out[:nbytes].tobytes()


def rle_frame_gather(rgb: np.ndarray, perm: np.ndarray,
                     prefix: bytes = b"") -> bytes:
    """Exact-RLE records over rgb[perm[i]] in one fused sweep (identical
    bytes to rle_frame(gather_rgb(rgb, perm))); `prefix` (e.g. the dims
    header) is written in front of the records so the caller skips a
    whole-payload concat copy."""
    lib = _load()
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8).reshape(-1, 3)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    if perm.size and (rgb.shape[0] == 0 or int(perm.max()) >= rgb.shape[0]
                      or int(perm.min()) < 0):
        raise ValueError("perm indices out of range")
    p = len(prefix)
    out = np.empty(p + perm.size * 12, dtype=np.uint8)
    if p:
        out[:p] = np.frombuffer(prefix, dtype=np.uint8)
    nbytes = lib.rle_frame_gather(_as_u8p(rgb), _as_i64p(perm), perm.size,
                                  _as_u8p(out[p:]))
    return out[: p + nbytes].tobytes()


def rle_records_frame(counts: np.ndarray, colors: np.ndarray) -> bytes:
    """(R,) u8 counts + (R, 3) u8 colors -> R x 12-byte RLE records."""
    lib = _load()
    counts = np.ascontiguousarray(counts, dtype=np.uint8)
    colors = np.ascontiguousarray(colors, dtype=np.uint8).reshape(-1, 3)
    if counts.size != colors.shape[0]:
        raise ValueError("counts/colors record mismatch")
    out = np.empty(counts.size * 12, dtype=np.uint8)
    lib.rle_records_frame(_as_u8p(counts), _as_u8p(colors), counts.size,
                          _as_u8p(out))
    return out.tobytes()


def approx_rle_encode(rgb: np.ndarray, allow: float):
    """(counts uint8[R], colors uint8[R,3]) for the running-average RLE
    (the exact-f64 engine)."""
    lib = _load()
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8).reshape(-1, 3)
    n = rgb.shape[0]
    counts = np.empty(n, dtype=np.uint8)
    colors = np.empty((n, 3), dtype=np.uint8)
    nrec = lib.approx_rle_encode(_as_u8p(rgb), n, float(allow),
                                 _as_u8p(counts), _as_u8p(colors))
    return counts[:nrec].copy(), colors[:nrec].copy()
