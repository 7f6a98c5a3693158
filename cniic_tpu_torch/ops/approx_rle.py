"""K2 and K3: approximate RLE of many streams, CUDA kernels, plain versions
and the entry points of the Hilbert codec's two device routes.

Port of ``cniic_tpu/ops/approx_rle.py``. The recurrence is the reference's
running-average RLE (hilbertc.rs:200-285): strictly sequential within a
stream, independent across streams. Both kernels are CUDA C++ for
``sm_90a`` in ``csrc/approx_rle.cu``, built with nvcc on first use into
``_build/`` and called through plain C launchers with ctypes; the source
note says what bounds them on the card.

* **K2**, ``wide_records`` (replaces ``cniic_tpu/ops/approx_rle.py::
  _wkernel``): up to 1024 streams in exact int32 arithmetic, records with
  bit 24 (run ended at the previous position) and bit 25 (closed by the
  stream's end), and a per-stream flag on a boundary tie the exact
  arithmetic cannot decide as the reference's f64 does. Integer ``allow``
  <= 64 only (the 16384 clamp keeps every decision only there). On the card
  it runs as speculative chunks of ``chunk`` positions with the seams
  repaired on the card and the flags read from the settled rows (four
  launches, ``approx_rle_wide_chunked`` in the source;
  ``approx_rle_wide_chunked_ref`` models it on the CPU), or with ``chunk``
  >= L one thread a stream (one launch); ``wide_records_stats`` also
  reports how the seams synced. Its quotients are taken by the reciprocal
  table ``RECIP``, not by integer division.
* **K3**, ``batch_records`` (replaces ``cniic_tpu/ops/approx_rle.py::
  _kernel``): the same recurrence in the TPU kernel's f32 count²-scaled
  form, records ``1<<24 | rgb``, no flag. It may differ from the f64 engine
  within ~1e-4·allow of the boundary; its parity target is the TPU kernel.
  On the card it runs as speculative chunks of ``chunk`` positions with the
  seams repaired on the card (three launches, ``approx_rle_batch_chunked``
  in the source; ``approx_rle_batch_chunked_ref`` models it on the CPU), or
  with ``chunk`` >= L one thread a stream (one launch). The records are the
  same; ``batch_records_stats`` also reports how the seams synced.

Each wrapper takes position-major tensors (``rgb`` int32 [L, S] packed
0x00RRGGBB, ``lens`` int32 [S]) and returns ``recs`` int32 [L+1, S] (and
K2's ``flags`` int32 [S]). It checks its inputs, launches its kernel for
CUDA tensors (raising if the launch fails) or runs its plain version
(``approx_rle_wide_ref``, ``approx_rle_batch_ref``) for CPU tensors, and
never moves from one to the other. ``<wrapper>.launches`` counts calls
that launched (``<wrapper>.kernel_launches`` the kernels they launched).

The entry points keep the JAX signatures and return values, with an explicit
``device`` in place of ``interpret``: ``approx_rle_batch`` (K3),
``approx_rle_wide`` (K2) and ``approx_rle_chunked``, the byte-exact
single-stream encode over ~1024 speculative chunks with the seam stitcher
that replays windows through the exact-f64 native engine.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from .. import _build, resolve_device

SOURCE = os.path.join(_build.PKG_DIR, "csrc", "approx_rle.cu")
NAME = "approx_rle"

WIDE = 1024              # streams per K2 call (the chunk stitcher's bound)
MAX_WIDE_ALLOW = 64      # K2's clamp keeps decisions only up to here
MAX_BATCH_LEN = 1 << 24  # K3's f32 positions are exact up to here
CHUNK = 128              # positions one K3 walker speculates (PERF.md)
WIDE_CHUNK = 64          # positions one K2 walker speculates (PERF.md)
RUN_CAP = 255
ICL = 16384
REC = 1 << 24            # a record: a run ended at the previous position
LAST = 1 << 25           # K2: the run was closed by the stream's end
TIE = 1 << 26            # K2's chunk walks: a tie at this row (cleared)

# K2's quotients: floor(s / n) = (s * RECIP[n]) >> 32 for 0 <= s <= 65025
# and 2 <= n <= 255, with RECIP[n] = ceil(2^32 / n) (exact: s * (RECIP[n]
# * n - 2^32) <= 65025 * 254 < 2^32); n = 1 gives s itself. The kernel
# builds the same table in shared memory.
RECIP = np.array([0, 0] + [((1 << 32) - 1) // n + 1 for n in range(2, 256)],
                 np.int64)
_RECIP_T = torch.from_numpy(RECIP)

_count_lock = threading.Lock()


def _commands():
    return [[_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", "{out}", SOURCE]]


_lib = None


def load_library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load(NAME, [SOURCE], _commands())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.approx_rle_wide.argtypes = [vp] * 4 + [ci] * 3 + [vp]
    lib.approx_rle_wide.restype = ci
    lib.approx_rle_wide_chunked.argtypes = [vp] * 6 + [ci] * 4 + [vp]
    lib.approx_rle_wide_chunked.restype = ci
    lib.approx_rle_batch.argtypes = [vp] * 3 + [ci] * 2 + [ctypes.c_float, vp]
    lib.approx_rle_batch.restype = ci
    lib.approx_rle_batch_chunked.argtypes = ([vp] * 5 + [ci] * 3
                                             + [ctypes.c_float, vp])
    lib.approx_rle_batch_chunked.restype = ci
    lib.approx_rle_error_string.argtypes = [ci]
    lib.approx_rle_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(rgb, lens) -> None:
    if rgb.dim() != 2:
        raise ValueError(f"rgb must be [L, streams], got {tuple(rgb.shape)}")
    L, S = rgb.shape
    if tuple(lens.shape) != (S,):
        raise ValueError(f"lens must have shape ({S},), got {tuple(lens.shape)}")
    for name, t in (("rgb", rgb), ("lens", lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lens.device != rgb.device:
        raise ValueError(f"lens is on {lens.device}, rgb on {rgb.device}")
    if rgb.device.type not in ("cuda", "cpu"):
        raise ValueError(f"runs on cuda or cpu tensors, not {rgb.device}")
    if S:
        lo, hi = torch.stack(torch.aminmax(lens)).tolist()  # one host sync
        if lo < 0 or hi > L:
            raise ValueError(f"stream lengths must lie in [0, {L}]")


def _raise_launch(lib, fn: str, rc: int, shape) -> None:
    msg = lib.approx_rle_error_string(rc).decode()
    raise RuntimeError(f"{fn} launch failed (L, streams = {tuple(shape)}): "
                       f"CUDA error {rc}: {msg}")


def _check_chunk(chunk) -> int:
    if int(chunk) != chunk or chunk < 1:
        raise ValueError(f"chunk must be a positive integer, got {chunk!r}")
    return int(chunk)


def _check_wide(rgb, lens, allow, chunk):
    """(allow, chunk) as ints, after K2's input checks."""
    _check(rgb, lens)
    S = rgb.shape[1]
    if S > WIDE:
        raise ValueError(f"K2 takes at most {WIDE} streams, got {S}")
    if int(allow) != allow or not 0 <= allow <= MAX_WIDE_ALLOW:
        raise ValueError(f"K2 needs an integer allow in [0, {MAX_WIDE_ALLOW}],"
                         f" got {allow!r}")
    return int(allow), _check_chunk(chunk)


def _launch_wide(rgb, lens, allow: int, chunk: int):
    """K2 on the card: (recs, flags, unsynced-seam bitmaps int32 [S, nw] or
    None, positions the settle pass walked int32 [S] or None)."""
    L, S = rgb.shape
    lib = load_library()
    dev = rgb.device
    out = torch.empty((L + 1, S), dtype=torch.int32, device=dev)
    flags = torch.empty((S,), dtype=torch.int32, device=dev)
    nk, nw = _chunks(L, chunk)
    bits = walked = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if nk == 1:
            rc = lib.approx_rle_wide(rgb.data_ptr(), lens.data_ptr(),
                                     out.data_ptr(), flags.data_ptr(), S, L,
                                     allow, stream)
            fn, kernels = "approx_rle_wide", 1
        else:
            scratch = torch.empty(S * nw + 10 * S * nk, dtype=torch.int32,
                                  device=dev)
            walked = torch.empty(S, dtype=torch.int32, device=dev)
            rc = lib.approx_rle_wide_chunked(
                rgb.data_ptr(), lens.data_ptr(), out.data_ptr(),
                flags.data_ptr(), scratch.data_ptr(), walked.data_ptr(), S, L,
                chunk, allow, stream)
            bits = scratch[: S * nw].view(S, nw)
            fn, kernels = "approx_rle_wide_chunked", 4
    if rc != 0:
        _raise_launch(lib, fn, rc, rgb.shape)
    with _count_lock:
        wide_records.launches += 1
        wide_records.kernel_launches += kernels
    return out, flags, bits, walked


def wide_records(rgb, lens, allow: int, chunk: int = WIDE_CHUNK):
    """K2 over position-major streams: (recs int32 [L+1, S], flags int32
    [S]). `allow` must be an integer in [0, 64]. On the card, `chunk` >= L
    walks each stream with one thread (one launch); a smaller `chunk` runs
    the speculative chunk schedule (four launches), whose records and
    flags are the same. `wide_records.launches` counts calls,
    `.kernel_launches` the kernels they launched."""
    allow, chunk = _check_wide(rgb, lens, allow, chunk)
    if rgb.device.type == "cpu":
        return approx_rle_wide_ref(rgb, lens, allow)
    return _launch_wide(rgb, lens, allow, chunk)[:2]


wide_records.launches = 0
wide_records.kernel_launches = 0


def _seams(lens, chunk: int) -> int:
    """Seams inside the streams: (len - 1) // chunk each."""
    return int(((lens.cpu().to(torch.int64) - 1).clamp_min(0)
                // chunk).sum())


def _count_bits(bits) -> int:
    return (0 if bits is None else
            int(np.unpackbits(bits.cpu().numpy().view(np.uint8)).sum()))


def wide_records_stats(rgb, lens, allow: int, chunk: int = WIDE_CHUNK):
    """`wide_records` and what its chunk schedule did: (recs, flags, seams
    inside the streams, seams whose repair did not sync, positions the
    settle pass re-walked). CPU tensors run the plain model of the
    schedule."""
    allow, chunk = _check_wide(rgb, lens, allow, chunk)
    if rgb.device.type == "cpu":
        recs, flags, unsynced, walked = approx_rle_wide_chunked_ref(
            rgb, lens, allow, chunk)
        n_unsynced = int(unsynced.sum())
    else:
        recs, flags, bits, walked = _launch_wide(rgb, lens, allow, chunk)
        n_unsynced = _count_bits(bits)
    if _chunks(rgb.shape[0], chunk)[0] == 1:
        return recs, flags, 0, 0, 0
    return (recs, flags, _seams(lens, chunk), n_unsynced,
            int(walked.to(torch.int64).sum()))


def _check_batch(rgb, lens, chunk) -> None:
    _check(rgb, lens)
    L = rgb.shape[0]
    if L > MAX_BATCH_LEN:
        raise ValueError(
            f"K3 counts positions as the TPU kernel's f32 does, exact only up"
            f" to {MAX_BATCH_LEN} pixels; got streams of {L}")
    _check_chunk(chunk)


def _chunks(L: int, chunk: int):
    """(chunks, bitmap words a stream) of the chunk schedule over L + 1
    rows; one chunk is the one-walker schedule."""
    nk = 1 if chunk >= L else -(-(L + 1) // chunk)
    return nk, -(-nk // 32)


def _launch_batch(rgb, lens, allow: float, chunk: int):
    """K3 on the card: (recs, unsynced-seam bitmaps int32 [B, nw] or None,
    positions the settle pass walked int32 [B] or None)."""
    L, B = rgb.shape
    lib = load_library()
    dev = rgb.device
    out = torch.empty((L + 1, B), dtype=torch.int32, device=dev)
    nk, nw = _chunks(L, chunk)
    bits = walked = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if nk == 1:
            rc = lib.approx_rle_batch(rgb.data_ptr(), lens.data_ptr(),
                                      out.data_ptr(), B, L, allow, stream)
            fn, kernels = "approx_rle_batch", 1
        else:
            scratch = torch.empty(B * nw + 10 * B * nk, dtype=torch.int32,
                                  device=dev)
            walked = torch.empty(B, dtype=torch.int32, device=dev)
            rc = lib.approx_rle_batch_chunked(
                rgb.data_ptr(), lens.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), walked.data_ptr(), B, L, chunk, allow,
                stream)
            bits = scratch[: B * nw].view(B, nw)
            fn, kernels = "approx_rle_batch_chunked", 3
    if rc != 0:
        _raise_launch(lib, fn, rc, rgb.shape)
    with _count_lock:
        batch_records.launches += 1
        batch_records.kernel_launches += kernels
    return out, bits, walked


def batch_records(rgb, lens, allow: float, chunk: int = CHUNK):
    """K3 over position-major streams: recs int32 [L+1, B]. `allow` is
    taken as f32, as the TPU kernel takes it. On the card, `chunk` >= L
    walks each stream with one thread (one launch); a smaller `chunk` runs
    the speculative chunk schedule (three launches), whose records are the
    same. `batch_records.launches` counts calls,
    `.kernel_launches` the kernels they launched."""
    _check_batch(rgb, lens, chunk)
    allow = float(np.float32(allow))
    if rgb.device.type == "cpu":
        return approx_rle_batch_ref(rgb, lens, allow)
    return _launch_batch(rgb, lens, allow, int(chunk))[0]


batch_records.launches = 0
batch_records.kernel_launches = 0


def batch_records_stats(rgb, lens, allow: float, chunk: int = CHUNK):
    """`batch_records` and what its chunk schedule did: (recs, seams inside
    the streams, seams whose repair did not sync, positions the settle pass
    re-walked). CPU tensors run the plain model of the schedule."""
    _check_batch(rgb, lens, chunk)
    allow = float(np.float32(allow))
    chunk = int(chunk)
    L = rgb.shape[0]
    if rgb.device.type == "cpu":
        recs, unsynced, walked = approx_rle_batch_chunked_ref(rgb, lens, allow,
                                                              chunk)
        n_unsynced = int(unsynced.sum())
    else:
        recs, bits, walked = _launch_batch(rgb, lens, allow, chunk)
        n_unsynced = _count_bits(bits)
    if _chunks(L, chunk)[0] == 1:
        return recs, 0, 0, 0
    return (recs, _seams(lens, chunk), n_unsynced,
            int(walked.to(torch.int64).sum()))


# ---------------------------------------------------------------------------
# plain versions: vectorised across streams, a loop over positions
# ---------------------------------------------------------------------------

def _channels(rgb):
    """[L, S] packed int32 -> [L, 3, S] int32 channels."""
    return torch.stack([(rgb >> 16) & 0xFF, (rgb >> 8) & 0xFF, rgb & 0xFF],
                       dim=1)


def _pack3(q):
    return (q[0] << 16) | (q[1] << 8) | q[2]


def _round_avg(s, n):
    """round(s / n) half up per channel ([3, S] over [S], n >= 1 where
    used) and whether each s / n is exact in f64 (n divides 128 * r)."""
    n = n.clamp_min(1)
    q = torch.div(s, n, rounding_mode="floor")
    r = s - q * n
    return q + (2 * r >= n).to(torch.int32), ((r << 7) % n) == 0


def approx_rle_wide_ref(rgb, lens, allow: int):
    """The plain PyTorch version of K2 (any device)."""
    L, S = rgb.shape
    dev = rgb.device
    x_all = _channels(rgb)
    zero3 = torch.zeros((3, S), dtype=torch.int32, device=dev)
    zero = torch.zeros((S,), dtype=torch.int32, device=dev)
    out = torch.zeros((L + 1, S), dtype=torch.int32, device=dev)
    s, c, pend = zero3, zero, zero
    flags = torch.zeros((S,), dtype=torch.bool, device=dev)
    for pos in range(L + 1):
        x = x_all[pos] if pos < L else zero3
        active = lens > pos
        fresh = c == 0
        t = (s - c * x).abs().clamp_max(ICL)
        dist2 = (t * t).sum(0, dtype=torch.int32)
        thresh = (allow * c) * (allow * c)
        accept = ~fresh & (dist2 <= thresh)
        live = active & ~fresh
        q, exact = _round_avg(s, c)
        out[pos] = torch.where(live & ~accept, REC | _pack3(q), pend)
        flags |= live & (dist2 == thresh) & ~exact.all(0)
        ns = torch.where(accept, s + x, x)
        nc = torch.where(accept, c + 1, 1)
        capped = nc >= RUN_CAP
        last = active & (lens - 1 <= pos)
        close = active & (capped | last)
        p, _ = _round_avg(ns, nc)
        close_rec = (REC | (last & ~capped).to(torch.int32) * LAST
                     | _pack3(p))
        pend = torch.where(close, close_rec, 0)
        keep = active & ~close
        s = torch.where(keep, ns, 0)
        c = torch.where(keep, nc, 0)
    return out, flags.to(torch.int32)


def _pack_avg(sums, n):
    inv = torch.reciprocal(n.clamp_min(1.0))
    return REC | _pack3((sums * inv + 0.5).to(torch.int32))


def _batch_step(s, c, pend, x, pos, lens, allow_t):
    """One K3 step on any lanes: sums s [3, *lanes] and counts c [*lanes]
    (f32), pend int32, pixels x [3, *lanes] (f32), positions and lengths
    broadcast to the lanes. Returns (row, s, c, pend).

    The distance sum is formed as fma(t2, t2, fma(t0, t0, t1 * t1)) in f32,
    the TPU kernel's form under XLA: each step is taken exactly in float64
    (the terms are integers below 2^33, so every f64 sum and product is
    exact) and rounded once to float32, which is what a fused multiply-add
    does."""
    f32, f64 = torch.float32, torch.float64
    active = lens > pos
    fresh = c == 0
    t = (s - c * x).to(f64)
    sq = t * t
    dist2 = (sq[0] + sq[1].to(f32).to(f64)).to(f32).to(f64)
    dist2 = (sq[2] + dist2).to(f32)
    ac = allow_t * c
    accept = ~fresh & (dist2 <= ac * ac)
    row = torch.where(active & ~fresh & ~accept, _pack_avg(s, c), pend)
    ns = torch.where(accept, s + x, x)
    nc = torch.where(accept, c + 1, 1.0)
    capped = nc >= RUN_CAP
    close = active & (capped | (lens - 1 <= pos))
    pend = torch.where(close, _pack_avg(ns, nc), 0)
    keep = active & ~close
    return (row, torch.where(keep, ns, 0.0), torch.where(keep, nc, 0.0),
            pend)


def approx_rle_batch_ref(rgb, lens, allow: float):
    """The plain PyTorch version of K3 (any device): every stream from
    position 0 to L in one loop."""
    L, B = rgb.shape
    dev = rgb.device
    x_all = _channels(rgb).to(torch.float32)
    allow_t = torch.tensor(allow, dtype=torch.float32, device=dev)
    zero3 = torch.zeros((3, B), dtype=torch.float32, device=dev)
    out = torch.zeros((L + 1, B), dtype=torch.int32, device=dev)
    s, c = zero3, torch.zeros((B,), dtype=torch.float32, device=dev)
    pend = torch.zeros((B,), dtype=torch.int32, device=dev)
    for pos in range(L + 1):
        x = x_all[pos] if pos < L else zero3
        out[pos], s, c, pend = _batch_step(s, c, pend, x, pos, lens, allow_t)
    return out


def approx_rle_batch_chunked_ref(rgb, lens, allow: float, chunk: int):
    """A plain model of K3's chunk schedule (`approx_rle_batch_chunked` in
    csrc/approx_rle.cu), for the tests and CPU rehearsals: its three passes
    with the kernels' sync rules, vectorised over chunks and streams.
    Returns (recs int32 [L+1, B], unsynced bool [B, nk]: the seams whose
    repair did not sync, walked int64 [B]: positions the settle pass
    re-walked). With one chunk (`chunk` >= L) it is the one-walker
    schedule."""
    L, B = rgb.shape
    dev = rgb.device
    if _chunks(L, chunk)[0] == 1:
        return (approx_rle_batch_ref(rgb, lens, allow),
                torch.zeros((B, 1), dtype=torch.bool, device=dev),
                torch.zeros(B, dtype=torch.int64, device=dev))
    f32 = torch.float32
    lens = lens.to(torch.int64)
    x_all = torch.cat([_channels(rgb).to(f32),
                       torch.zeros((1, 3, B), dtype=f32, device=dev)])
    allow_t = torch.tensor(allow, dtype=f32, device=dev)
    return _chunk_schedule(
        x_all, lens, chunk,
        lambda s, c, pend, x, pos: _batch_step(s, c, pend, x, pos, lens,
                                               allow_t))


def _recip_quot(s, n):
    """floor(s / n) as K2 takes it, (s * RECIP[n]) >> 32 and s itself at n
    = 1, for int32 s in [0, 65025] and n in [1, 255] (broadcast; n = 0 gives
    0)."""
    m = _RECIP_T.to(n.device)[n.to(torch.int64)]
    q = ((s.to(torch.int64) * m) >> 32).to(torch.int32)
    return torch.where(n == 1, s, q)


def _recip_round(s, n):
    """round(s / n) half up through the reciprocal table."""
    q = _recip_quot(s, n)
    return q + (2 * (s - q * n) >= n).to(torch.int32)


def _recip_exact(s, n):
    """Whether s / n is exact in f64 (n divides 128 * (s mod n)), through
    the reciprocal table as the kernel takes it: r7 = (s mod n) << 7 is
    divisible when ((r7 * RECIP[n]) >> 32) * n == r7 (at n = 1, RECIP[1] =
    0 and r7 = 0)."""
    r7 = (s - _recip_quot(s, n) * n) << 7
    m = _RECIP_T.to(n.device)[n.to(torch.int64)]
    return ((r7.to(torch.int64) * m) >> 32) * n == r7


def _wide_step(s, c, pend, x, pos, lens, allow: int):
    """One step of K2's chunk walks on any lanes, in the kernel's
    arithmetic: int32 sums s [3, *lanes], counts c and pend [*lanes], pixels
    x [3, *lanes], positions and lengths broadcast to the lanes; quotients
    through the reciprocal table, and a tie marks its row with TIE. Returns
    (row, s, c, pend)."""
    active = lens > pos
    fresh = c == 0
    t = (s - c * x).abs().clamp_max(ICL)
    dist2 = (t * t).sum(0, dtype=torch.int32)
    thresh = (allow * c) * (allow * c)
    accept = ~fresh & (dist2 <= thresh)
    live = active & ~fresh
    row = torch.where(live & ~accept, REC | _pack3(_recip_round(s, c)), pend)
    tie = live & (dist2 == thresh)
    if bool(tie.any()):  # rare: the exactness test only where it is read
        row = row | (tie & ~_recip_exact(s, c).all(0)).to(torch.int32) * TIE
    ns = torch.where(accept, s + x, x)
    nc = torch.where(accept, c + 1, 1)
    capped = nc >= RUN_CAP
    last = active & (lens - 1 <= pos)
    close = active & (capped | last)
    pend = torch.zeros_like(pend)
    if bool(close.any()):
        pend = torch.where(close, REC | (last & ~capped).to(torch.int32) * LAST
                           | _pack3(_recip_round(ns, nc)), 0)
    keep = active & ~close
    return (row, torch.where(keep, ns, 0), torch.where(keep, nc, 0), pend)


def approx_rle_wide_chunked_ref(rgb, lens, allow: int, chunk: int):
    """A plain model of K2's chunk schedule (`approx_rle_wide_chunked` in
    csrc/approx_rle.cu), for the tests and CPU rehearsals: K3's three passes
    on K2's steps (`_wide_step`), then the flag pass: a stream's flag is the
    OR of the TIE marks left in its settled rows, which are then cleared.
    Returns (recs int32 [L+1, S], flags int32 [S], unsynced bool [S, nk],
    walked int64 [S]). With one chunk (`chunk` >= L) it is the one-walker
    schedule."""
    L, S = rgb.shape
    dev = rgb.device
    if _chunks(L, chunk)[0] == 1:
        recs, flags = approx_rle_wide_ref(rgb, lens, allow)
        return (recs, flags, torch.zeros((S, 1), dtype=torch.bool, device=dev),
                torch.zeros(S, dtype=torch.int64, device=dev))
    lens = lens.to(torch.int64)
    x_all = torch.cat([_channels(rgb),
                       torch.zeros((1, 3, S), dtype=torch.int32, device=dev)])
    rows, unsynced, walked = _chunk_schedule(
        x_all, lens, chunk,
        lambda s, c, pend, x, pos: _wide_step(s, c, pend, x, pos, lens,
                                              allow))
    flags = ((rows & TIE) != 0).any(0).to(torch.int32)
    return rows & ~TIE, flags, unsynced, walked


def _chunk_schedule(x_all, lens, chunk: int, step):
    """The speculate, repair and settle passes of the card's chunk schedule
    with the kernels' sync rules, vectorised over chunks and streams:
    `x_all` [L+1, 3, S] holds the pixels (a zero row at L) in the state's
    type, `lens` int64 [S], and `step(s, c, pend, x, pos)` takes one step
    of the recurrence on any lanes. Returns (rows int32 [L+1, S], unsynced
    bool [S, nk], walked int64 [S])."""
    L, S = x_all.shape[0] - 1, x_all.shape[2]
    dev = x_all.device
    nk, _ = _chunks(L, chunk)
    i64 = torch.int64
    out = torch.zeros((L + 1, S), dtype=torch.int32, device=dev)
    p0 = torch.arange(nk, dtype=i64, device=dev) * chunk

    def record(row):
        return (row & REC) != 0

    # pass 1: each (chunk, stream) from a fresh state, the true lengths
    s = torch.zeros((3, nk, S), dtype=x_all.dtype, device=dev)
    c = torch.zeros((nk, S), dtype=x_all.dtype, device=dev)
    pend = torch.zeros((nk, S), dtype=torch.int32, device=dev)
    for t in range(chunk):
        pos = p0 + t
        live = pos <= L
        pc = pos.clamp(max=L)
        x = x_all[pc].permute(1, 0, 2)
        row, ns, nc, npend = step(s, c, pend, x, pos[:, None])
        out[pos[live]] = row[live]
        s = torch.where(live[:, None], ns, s)
        c, pend = torch.where(live[:, None], nc, c), torch.where(
            live[:, None], npend, pend)
    spec = (s, c, pend)

    # pass 2: seam k re-walks chunk k from chunk k-1's exit until both walks
    # start a run at one position (or are past the stream's end)
    s, c, pend = spec[0][:, :-1], spec[1][:-1], spec[2][:-1]
    done = torch.zeros((nk - 1, S), dtype=torch.bool, device=dev)
    for t in range(chunk):
        pos = p0[1:] + t
        live = pos <= L
        pc = pos.clamp(max=L)
        act = ~done & live[:, None]
        old = out[pc]
        x = x_all[pc].permute(1, 0, 2)
        row, ns, nc, npend = step(s, c, pend, x, pos[:, None])
        out[pos[live]] = torch.where(act, row, old)[live]
        sync = act & ((pos[:, None] >= lens) | (record(row) & (
            record(old) | (t == 0))))
        s = torch.where(act, ns, s)
        c, pend = torch.where(act, nc, c), torch.where(act, npend, pend)
        done |= sync
    rep = (s, c, pend)
    unsynced = torch.cat([torch.zeros((1, S), dtype=torch.bool, device=dev),
                          ~done]).t().contiguous()

    # pass 3: per stream, the true state across the seams; where it differs
    # from the state a seam's repair started from, it walks the whole chunk.
    # A stream does one action an iteration (jump to the next unsynced seam,
    # compare, or one position of a walk)
    seam = torch.arange(nk, dtype=i64, device=dev)
    nxt = torch.where(unsynced, seam, nk).flip(1).cummin(1).values.flip(1)
    nxt = torch.cat([nxt, torch.full((S, 1), nk, dtype=i64, device=dev)], 1)
    cols = torch.arange(S, device=dev)
    s, c, pend = spec[0][:, 0].clone(), spec[1][0].clone(), spec[2][0].clone()
    k = torch.ones(S, dtype=i64, device=dev)
    eq = torch.ones(S, dtype=torch.bool, device=dev)
    walking = torch.zeros(S, dtype=torch.bool, device=dev)
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    pos = torch.zeros(S, dtype=i64, device=dev)
    walked = torch.zeros(S, dtype=i64, device=dev)
    while True:
        done |= ~eq & ~walking & (k >= nk)
        if bool(done.all()):
            break
        jump = ~done & eq
        comp = ~done & ~eq & ~walking
        wk = ~done & walking
        # jump: synced seams pass the truth on; an unsynced one's repair
        # exit is the truth
        kk = nxt[cols, k.clamp(max=nk)]
        done |= jump & (kk >= nk)
        go = jump & (kk < nk)
        if bool(go.any()):
            ri = (kk - 1).clamp(0, nk - 2)  # rep holds seams 1..nk-1
            s = torch.where(go, rep[0][:, ri, cols], s)
            c = torch.where(go, rep[1][ri, cols], c)
            pend = torch.where(go, rep[2][ri, cols], pend)
            k = torch.where(go, kk + 1, k)
            eq = eq & ~go
        if bool(comp.any()):
            # compare with the state seam k's repair started from
            kp = (k - 1).clamp(0, nk - 1)
            same = ((s == spec[0][:, kp, cols]).all(0)
                    & (c == spec[1][kp, cols]) & (pend == spec[2][kp, cols]))
            eq = eq | (comp & same)
            start = comp & ~same
            walking = walking | start
            pos = torch.where(start, k * chunk, pos)
        if bool(wk.any()):
            # one position of a walk of the whole chunk
            pc = pos.clamp(max=L)
            row, ns, nc, npend = step(s, c, pend, x_all[pc, :, cols].t(), pos)
            out[pc[wk], cols[wk]] = row[wk]
            walked += wk.to(i64)
            s = torch.where(wk, ns, s)
            c, pend = torch.where(wk, nc, c), torch.where(wk, npend, pend)
            end = wk & (pos + 1 >= torch.clamp((k + 1) * chunk, max=L + 1))
            walking = walking & ~end
            k = torch.where(end, k + 1, k)
            pos = torch.where(wk & ~end, pos + 1, pos)
    return out, unsynced, walked


# ---------------------------------------------------------------------------
# entry points (the JAX package's functions of the same names)
# ---------------------------------------------------------------------------

def _position_major(scans, lengths, dev):
    """(B, L, 3) uint8 scans -> (rgb int32 [L, B] packed, lens int32 [B])
    on `dev`. The bytes go up as they are; packing and the transpose run
    on `dev`."""
    ch = torch.from_numpy(scans).to(dev).to(torch.int32)
    rgb = ((ch[..., 0] << 16) | (ch[..., 1] << 8) | ch[..., 2]).t().contiguous()
    lens = torch.from_numpy(np.asarray(lengths, np.int32).copy()).to(dev)
    return rgb, lens


def _stream_major(recs):
    """[L+1, S] records on any device -> host int32 [S, L+1], each
    stream's column contiguous."""
    return recs.t().contiguous().cpu().numpy()


def _runs(col):
    """(counts u8, colors u8 [R, 3], ends) of one stream's record column."""
    ends = np.flatnonzero(col >> 24)  # record at p => run ended at p-1
    counts = np.diff(np.concatenate([[0], ends])).astype(np.uint8)
    vals = col[ends]
    colors = np.stack([(vals >> 16) & 0xFF, (vals >> 8) & 0xFF, vals & 0xFF],
                      axis=1).astype(np.uint8)
    return counts, colors, ends


def approx_rle_batch(scans, lengths, allow: float, device="cuda"):
    """Encode a batch of streams with K3, all in one launch.

    scans: (B, L, 3) uint8 (zero-padded); lengths: (B,). Returns a list of
    (counts uint8[R], colors uint8[R, 3]) per stream, identical to the
    reference recurrence up to f32-vs-f64 boundary rounding.
    """
    dev = resolve_device(device)
    scans = np.ascontiguousarray(scans, dtype=np.uint8)
    if scans.shape[0] == 0:
        return []
    rgb, lens = _position_major(scans, lengths, dev)
    recs = _stream_major(batch_records(rgb, lens, allow))
    out = []
    for j, n_j in enumerate(np.asarray(lengths, np.int64).tolist()):
        counts, colors, _ = _runs(recs[j, : n_j + 1])
        out.append((counts, colors))
    return out


def approx_rle_wide(scans, lengths, allow: float, device="cuda"):
    """Encode up to 1024 streams with K2 in one launch.

    scans: (B, L, 3) uint8 (zero-padded); lengths: (B,). allow must be a
    nonnegative integer <= 64. Returns a list of (counts uint8[R], colors
    uint8[R, 3], last_forced bool, flagged bool) per stream: `last_forced`
    marks a final record closed by stream end (what a chunk stitcher drops
    at seams); `flagged` marks a stream that hit an exact boundary tie where
    the reference's f64 recurrence is not predicted by exact arithmetic —
    re-run those through the native engine.
    """
    allow_i = int(allow)
    if allow_i != allow or allow_i < 0:
        raise ValueError("wide kernel needs an integer allowance")
    if allow_i > MAX_WIDE_ALLOW:
        # The ICL=16384 clamp preserves accept/reject decisions only while
        # allow*count < 16384 (count <= 255 => allow <= 64, the same bound
        # the native C fast path enforces); beyond that a clamped term can
        # flip a decision and (allow*c)^2 overflows int32 from allow >= 183.
        # Callers must use the exact-f64 native engine.
        raise ValueError("wide kernel supports integer allow <= 64 only "
                         "(ICL clamp bound; use native.approx_rle_encode)")
    dev = resolve_device(device)
    scans = np.ascontiguousarray(scans, dtype=np.uint8)
    B = scans.shape[0]
    if B > WIDE:
        raise ValueError(f"wide kernel packs at most {WIDE} streams")
    rgb, lens = _position_major(scans, lengths, dev)
    recs_t, flags_t = wide_records(rgb, lens, allow_i)
    recs = _stream_major(recs_t)
    flags = flags_t.cpu().numpy()
    out = []
    for j, n_j in enumerate(np.asarray(lengths, np.int64).tolist()):
        col = recs[j, : n_j + 1]
        counts, colors, ends = _runs(col)
        last_forced = bool(ends.size and (col[ends[-1]] >> 25) & 1)
        out.append((counts, colors, last_forced, bool(flags[j])))
    return out


def _wide_chunks(scan, chunk: int = 1024):
    """The chunks `approx_rle_chunked` gives K2 for one scan of n >= 1
    pixels: (scans uint8 [n_chunks, chunk, 3] zero-padded, lens int64
    [n_chunks], chunk), at most WIDE chunks (`chunk` grows when n > WIDE *
    chunk)."""
    n = scan.shape[0]
    n_chunks = -(-n // chunk)
    if n_chunks > WIDE:
        chunk = -(-n // WIDE)
        n_chunks = -(-n // chunk)
    scans = np.zeros((n_chunks * chunk, 3), np.uint8)
    scans[:n] = scan
    lens = np.full(n_chunks, chunk, np.int64)
    lens[-1] = n - (n_chunks - 1) * chunk
    return scans.reshape(n_chunks, chunk, 3), lens, chunk


def approx_rle_chunked(scan: np.ndarray, allow: float, chunk: int = 1024,
                       device="cuda"):
    """Byte-exact approx-RLE of ONE stream via ~1024 speculative chunks.
    K2 encodes every chunk as if it started a fresh run; the stitcher walks
    the truth: wherever the true parse has a run START at a position where
    an (unflagged) speculative chunk also starts a run, the chunk's
    remaining records ARE the truth (the recurrence is deterministic from
    identical state), so they are adopted wholesale; the gaps between sync
    points (runs crossing seams, flagged chunks, dropped force-closed
    records) are replayed through the exact-f64 native engine in bounded
    windows. Output == native.approx_rle_encode.
    """
    from .. import native

    scan = np.ascontiguousarray(scan, dtype=np.uint8)
    n = scan.shape[0]
    if n == 0:
        return (np.zeros(0, np.uint8), np.zeros((0, 3), np.uint8))
    if not float(allow).is_integer() or not 0 <= allow <= MAX_WIDE_ALLOW:
        # outside K2's exact-decision envelope (see approx_rle_wide): the
        # native engine IS the byte-exact answer
        return native.approx_rle_encode(scan, allow)
    scans, lens, chunk = _wide_chunks(scan, chunk)
    n_chunks = lens.size
    spec = approx_rle_wide(scans, lens, allow, device=device)

    # per-chunk absolute run-start positions (sync points) and record lists
    starts: list[np.ndarray] = []
    for j, (counts, colors, forced, flagged) in enumerate(spec):
        if flagged:
            starts.append(np.zeros(0, np.int64))
            continue
        ends = j * chunk + np.cumsum(counts.astype(np.int64))
        starts.append(np.concatenate([[j * chunk], ends[:-1]]))

    out_counts: list[np.ndarray] = []
    out_colors: list[np.ndarray] = []
    p = 0
    while p < n:
        j = p // chunk
        counts, colors, forced, flagged = spec[j]
        # the last chunk's stream end IS the true stream end: its
        # force-close is genuine, not speculative
        forced = forced and j < n_chunks - 1
        sync = starts[j]
        k = np.searchsorted(sync, p)
        if not flagged and k < sync.size and sync[k] == p:
            # adopt chunk j's records from this run start on, minus the
            # force-closed tail (its run truly continues across the seam)
            keep = counts[k:]
            keepc = colors[k:]
            if forced and keep.size:
                keep, keepc = keep[:-1], keepc[:-1]
            if keep.size:
                out_counts.append(keep)
                out_colors.append(keepc)
                p += int(keep.astype(np.int64).sum())
                if not forced:
                    continue  # landed exactly on the chunk seam, fresh
            # fall through to replay (forced tail or empty adoption)
        # replay a window with the exact engine until a sync point is hit
        W = chunk + 512
        while p < n:
            sub = scan[p : p + W]
            cc, ccol = native.approx_rle_encode(sub, allow)
            full = p + sub.shape[0] == n
            if not full and cc.size:
                cc, ccol = cc[:-1], ccol[:-1]  # window-forced close
            if not cc.size:
                W *= 2  # a single run longer than the window: widen
                continue
            ends = p + np.cumsum(cc.astype(np.int64))
            # earliest record end that is a sync point of its chunk
            hit = -1
            for i, q in enumerate(ends.tolist()):
                if q >= n:
                    hit = i
                    break
                sj = starts[q // chunk]
                kq = np.searchsorted(sj, q)
                if kq < sj.size and sj[kq] == q:
                    hit = i
                    break
            if hit >= 0:
                out_counts.append(cc[: hit + 1])
                out_colors.append(ccol[: hit + 1])
                p = int(ends[hit])
                break
            out_counts.append(cc)
            out_colors.append(ccol)
            p = int(ends[-1])
        # loop back to try chunk adoption at the new p

    counts = np.concatenate(out_counts) if out_counts else np.zeros(0, np.uint8)
    colors = (np.concatenate(out_colors) if out_colors
              else np.zeros((0, 3), np.uint8))
    return counts.astype(np.uint8), colors.astype(np.uint8)
