"""K1 and D3: the k-means step's CUDA kernels and their plain versions.

K1 replaces the TPU kernel ``cniic_tpu/ops/kmeans_pallas.py::_kernel`` (and
its XLA twin ``_assign_stats_xla`` in ``cniic_tpu/ops/kmeans.py``): the
fused assign + statistics step. D3 replaces the XLA programs of the JAX
loop body around it (``_means_from_sums``, ``_steal_indices``,
``_plateau_update`` and the ``where``s of ``kmeans_loop_pallas``): the
step's update. Both are CUDA C++ for ``sm_90a`` in ``csrc/kmeans_assign.cu``,
built with nvcc on first use into ``_build/`` and called through plain C
launchers with ctypes. The source note says what bounds each on the card
and what the design does about it. The loop's iteration is one launch: K1
with D3 run by the last block of each lane (``prepare_step``).

* ``assign_stats`` is K1's wrapper. It checks devices, dtypes, shapes,
  contiguity and the distance bound, picks the packed-key or the unpacked
  path from the host bound (`packed_path`), then launches the kernel for
  CUDA tensors (raising if the launch fails) or runs the plain version for
  CPU tensors. It never falls back from one to the other.
  ``assign_stats.launches`` counts kernel launches. With ``out=(new, sums,
  moved)`` it writes into the caller's buffers (``new`` may be ``cur``;
  ``sums`` and ``moved`` are added to and must start at zero).
* ``assign_stats_ref`` is K1's plain PyTorch version: blocked over points,
  exact scores by one float64 matrix product a block (integers below
  2^53), ``torch.argmin`` with the strict-move rule, and ``index_add_``
  for the statistics.
* ``step_update`` is D3's wrapper for the update alone, one block a lane
  (same rules, ``step_update.launches``); ``step_update_ref`` its plain
  version, the torch ops of the engine's loop body gathered into one
  function that never syncs with the host. Both take ``stolen``, the empty
  clusters' candidate points, in place of gathering them from ``ptsT``: the
  point-sharded k-means (``parallel/mesh.py``) assembles them across ranks.
* ``prepare_step`` checks the operands of a whole iteration once and returns
  a callable that launches it: on the card one kernel, K1 whose last block
  of each lane runs D3 (counted in ``assign_stats.launches``); with
  ``fused=False`` or on the CPU, ``assign_stats`` then ``step_update``.
  ``prepare_assign`` and ``prepare_update`` do the same for each alone (the
  point-sharded loop runs its all-reduce between them).

K1's operands (B lanes, n_max points per lane, d dimensions, k centroids):
ptsT int32[B, d, n_max] (nonnegative), w int32[B, n_max], cur int32[B, n_max]
(valid cluster ids for every point below n), cents int32[B, k, d],
n int32[B], act int32[B]. Outputs: new int32[B, n_max], sums
int64[B, k, d+1] (per cluster: sum of w*p per dimension, then sum of w) and
moved int32[B]; a frozen lane (act == 0) and the points past n keep zeros
(or, with ``out``, what the buffers held). The kernel holds a row of 4, 8
or 12 words per centroid in shared memory, so k rows must fit a block's
227 KB (k <= 7263 at d = 5); beyond that the launch is refused and the
wrapper raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .. import _build

SOURCE = os.path.join(_build.PKG_DIR, "csrc", "kmeans_assign.cu")
NAME = "kmeans_assign"

# elements of one (points x k) int64 distance tile in the plain version: a
# tile that stays in a CPU core's L2 cache there, a large one on the card
# (where every op on a tile is a kernel launch)
_REF_TILE = {"cpu": 1 << 17, "cuda": 1 << 24}

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
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kmeans_assign_stats.argtypes = [vp] * 9 + [ci] * 5 + [vp]
    lib.kmeans_assign_stats.restype = ci
    lib.kmeans_step_update.argtypes = [vp] * 12 + [ci] * 4 + [cl, cl, vp]
    lib.kmeans_step_update.restype = ci
    lib.kmeans_fused_step.argtypes = [vp] * 15 + [ci] * 5 + [cl, cl, vp]
    lib.kmeans_fused_step.restype = ci
    lib.kmeans_stats_in_smem.argtypes = [ci, ci]
    lib.kmeans_stats_in_smem.restype = ci
    lib.kmeans_error_string.argtypes = [ci]
    lib.kmeans_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def stats_in_smem(d: int, k: int) -> bool:
    """Whether the kernel keeps a (d, k) step's statistics tile in shared
    memory (small k) or adds straight into global memory (large k)."""
    return bool(load_library().kmeans_stats_in_smem(d, k))


def d2_bound(pmax) -> int:
    """No squared distance exceeds this: points and centroids (truncated
    means or stolen points) lie in [0, pmax] per dimension."""
    return sum(int(m) * int(m) for m in pmax)


def packed_path(pmax, k: int) -> bool:
    """Whether K1 may score with packed keys d2*pk + c (pk: the power of two
    >= k): every key, and every key less |p|^2*pk, must stay below 2^31."""
    pk = 1 << max(0, (k - 1).bit_length())
    return (d2_bound(pmax) + 1) * pk <= 2**31


def _check_tensors(named, device) -> None:
    for name, (t, dtype, shape) in named.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, ptsT on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(ptsT, w, cur, cents, n, act, pmax, out) -> None:
    if ptsT.dim() != 3:
        raise ValueError(f"ptsT must be [B, d, n_max], got {tuple(ptsT.shape)}")
    B, d, n_max = ptsT.shape
    if cents.dim() != 3 or cents.shape[0] != B or cents.shape[2] != d:
        raise ValueError(f"cents must be [{B}, k, {d}], got {tuple(cents.shape)}")
    k = cents.shape[1]
    i32 = torch.int32
    want = {"ptsT": (ptsT, i32, (B, d, n_max)), "w": (w, i32, (B, n_max)),
            "cur": (cur, i32, (B, n_max)), "cents": (cents, i32, (B, k, d)),
            "n": (n, i32, (B,)), "act": (act, i32, (B,))}
    if out is not None:
        want.update({"out new": (out[0], i32, (B, n_max)),
                     "out sums": (out[1], torch.int64, (B, k, d + 1)),
                     "out moved": (out[2], i32, (B,))})
    _check_tensors(want, ptsT.device)
    if k < 1:
        raise ValueError("k-means needs k >= 1")
    if len(pmax) != d:
        raise ValueError(f"pmax needs {d} per-dimension maxima, got {len(pmax)}")
    bound = d2_bound(pmax)
    if bound >= 2**31:
        raise ValueError(
            f"squared-distance bound {bound} reaches 2^31: int32 "
            "distances would overflow")


def _raise_launch(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.kmeans_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}: {msg}")


def assign_stats(ptsT, w, cur, cents, n, act, pmax, out=None):
    """One fused step over all lanes; returns (new, sums, moved), the
    buffers of `out` when it is given.

    pmax: host sequence of per-dimension maxima of the (nonnegative) points,
    from which the squared-distance bound is checked below 2^31 and the
    packed path is chosen.
    CUDA tensors launch the kernel, CPU tensors take `assign_stats_ref`."""
    step = prepare_assign(ptsT, w, cur, cents, n, act, pmax, out)
    if ptsT.device.type != "cuda":
        return step()
    with torch.cuda.device(ptsT.device):
        return step()


def prepare_assign(ptsT, w, cur, cents, n, act, pmax, out=None):
    """Check K1's operands once and return a callable that runs
    `assign_stats` on them, any number of times, and returns its outputs.
    On CUDA tensors it launches on the stream that is current now (the
    caller keeps the tensors' device current while it calls)."""
    _check(ptsT, w, cur, cents, n, act, pmax, out)
    dev = ptsT.device
    if dev.type == "cpu":
        def plain():
            got = assign_stats_ref(ptsT, w, cur, cents, n, act)
            if out is None:
                return got
            new, sums, moved = out
            keep = ((act != 0)[:, None]
                    & (torch.arange(ptsT.shape[2])[None, :] < n[:, None]))
            new.copy_(torch.where(keep, got[0], new))
            sums += got[1]
            moved += got[2]
            return out
        return plain
    if dev.type != "cuda":
        raise ValueError(f"assign_stats runs on cuda or cpu tensors, not {dev}")
    B, d, n_max = ptsT.shape
    k = cents.shape[1]
    lib = load_library()
    if out is None:
        out = (torch.zeros((B, n_max), dtype=torch.int32, device=dev),
               torch.zeros((B, k, d + 1), dtype=torch.int64, device=dev),
               torch.zeros((B,), dtype=torch.int32, device=dev))
    # the tensors stay alive in this tuple for as long as the callable does
    held = (ptsT, w, cur, cents, n, act, *out)
    args = ([t.data_ptr() for t in held]
            + [B, d, n_max, k, int(packed_path(pmax, k)),
               torch.cuda.current_stream(dev).cuda_stream])
    launch = lib.kmeans_assign_stats
    what = f"kmeans_assign_stats (B={B}, d={d}, n_max={n_max}, k={k})"

    def k1():
        _raise_launch(lib, launch(*args), what)
        with _count_lock:
            assign_stats.launches += 1
        return out

    k1.held = held
    return k1


assign_stats.launches = 0


def assign_stats_ref(ptsT, w, cur, cents, n, act):
    """The plain PyTorch version of the step (any device).

    A point's distances are scored as |c|^2 - 2 p.c, one float64 matrix
    product a block of points. Every product and partial sum is an integer
    below 2^53 (checked from the data; the wrapper's bound keeps them below
    2^32), so the scores are exact in any summation order, and they rank
    the centroids as the int64 squared distances do (|p|^2 is the same for
    every centroid of a point): the first minimum, and a move only to a
    strictly closer centroid."""
    B, d, n_max = ptsT.shape
    k = cents.shape[1]
    dev = ptsT.device
    new = torch.zeros((B, n_max), dtype=torch.int32, device=dev)
    sums = torch.zeros((B, k, d + 1), dtype=torch.int64, device=dev)
    moved = torch.zeros((B,), dtype=torch.int32, device=dev)
    pm = int(ptsT.abs().max()) if ptsT.numel() else 0
    cm = int(cents.abs().max()) if cents.numel() else 0
    if d * cm * (cm + 2 * pm) >= 2**53:
        raise ValueError("assign_stats_ref: coordinates too large for exact "
                         "float64 scores")
    block = max(1, _REF_TILE[dev.type] // k)
    for b, (nb, ab) in enumerate(zip(n.tolist(), act.tolist())):
        if ab == 0:
            continue
        c = cents[b].to(torch.float64)                    # (k, d)
        cc = (c * c).sum(1)                               # |c|^2
        m2c = (-2.0 * c).T.contiguous()                   # (d, k)
        for s in range(0, nb, block):
            e = min(s + block, nb)
            p = ptsT[b, :, s:e]                           # (d, m)
            score = torch.addmm(cc, p.T.to(torch.float64), m2c)
            best = torch.argmin(score, dim=1)             # first minimum
            c0 = cur[b, s:e].to(torch.int64)
            best_s = score.gather(1, best[:, None])[:, 0]
            cur_s = score.gather(1, c0[:, None])[:, 0]
            nw = torch.where(best_s < cur_s, best, c0)    # strictly closer
            new[b, s:e] = nw.to(torch.int32)
            moved[b] += (nw != c0).sum().to(torch.int32)
            wv = w[b, s:e].to(torch.int64)
            feats = torch.cat([p.to(torch.int64) * wv[None, :],
                               wv[None, :]], dim=0).T
            sums[b].index_add_(0, nw, feats)
    return new, sums, moved


# ---------------------------------------------------------------------------
# D3: the step's update
# ---------------------------------------------------------------------------

def steal_indices(k: int, it, n):
    """Empty-cluster picks: the Weyl hash of (iteration, cluster) over each
    lane's valid points. it: an int, an int64 scalar tensor or int64[B] (a
    count a lane); n int64[B]; returns int64[B, k]. The reference computes
    the hash in int32 with wraparound;
    ``(((it+1)*2654435769 + j*40503) & 0x7FFFFFFF) % max(n,1)``
    in int64 is the same number without relying on overflow."""
    j = torch.arange(k, dtype=torch.int64, device=n.device)
    it = torch.as_tensor(it, dtype=torch.int64, device=n.device).reshape(-1, 1)
    mix = ((it + 1) * 2654435769 + j[None, :] * 40503) & 0x7FFFFFFF
    return mix % n.clamp(min=1)[:, None]


def plateau_update(act, new_moved, best, stall):
    """Stall bookkeeping; the 2% bar is best - best // 50."""
    improved = new_moved < best - best // 50
    best = torch.where(act & improved, new_moved, best)
    stall = torch.where(act, torch.where(improved, 0, stall + 1), stall)
    return best, stall


def _check_update(sums, moved_k, ptsT, n, cents, moved, best, stall, act,
                  it, thresh, stolen=None) -> None:
    if ptsT.dim() != 3 or cents.dim() != 3:
        raise ValueError("ptsT must be [B, d, n_max] and cents [B, k, d]")
    B, d, n_max = ptsT.shape
    k = cents.shape[1]
    i32, i64 = torch.int32, torch.int64
    _check_tensors({
        "sums": (sums, i64, (B, k, d + 1)), "moved_k": (moved_k, i32, (B,)),
        "ptsT": (ptsT, i32, (B, d, n_max)), "n": (n, i32, (B,)),
        "cents": (cents, i32, (B, k, d)), "moved": (moved, i64, (B,)),
        "best": (best, i64, (B,)), "stall": (stall, i64, (B,)),
        "act": (act, i32, (B,)), "it": (it, i64, (B,)),
        "thresh": (thresh, i64, (B,)),
        **({} if stolen is None else {"stolen": (stolen, i32, (B, k, d))})},
        ptsT.device)
    if k < 1:
        raise ValueError("k-means needs k >= 1")


def step_update(sums, moved_k, ptsT, n, cents, moved, best, stall, act,
                it, thresh, stall_lim: int, max_iters: int,
                stolen=None) -> None:
    """D3, in place: after a K1 step over the lanes `act` names, set their
    centroids to the truncated means (the steal for empty clusters, hashed
    from the lane's iteration count it[b]), their moved / best / stall to
    the step's, advance it[b], recompute act[b] (moved > thresh, stall <
    stall_lim, it < max_iters), and zero their sums and moved_k for the next
    K1. A lane that did not run (act == 0) keeps everything it has.

    sums int64[B, k, d+1] and moved_k int32[B] are K1's outputs; moved,
    best, stall, it, thresh int64[B]; act int32[B]. Lanes start together
    and never thaw, so every active lane's count is the batch's.
    stolen: None to gather an empty cluster's point from ptsT by the hash,
    or int32[B, k, d], the points to take (then ptsT and n are not read).
    CUDA tensors launch the kernel, CPU tensors take `step_update_ref`."""
    step = prepare_update(sums, moved_k, ptsT, n, cents, moved, best, stall,
                          act, it, thresh, stall_lim, max_iters, stolen)
    if ptsT.device.type != "cuda":
        step()
        return
    with torch.cuda.device(ptsT.device):
        step()


def prepare_update(sums, moved_k, ptsT, n, cents, moved, best, stall, act,
                   it, thresh, stall_lim: int, max_iters: int, stolen=None):
    """Check D3's operands once and return a callable that runs
    `step_update` on them in place, any number of times. On CUDA tensors it
    launches on the stream that is current now (the caller keeps the
    tensors' device current while it calls)."""
    _check_update(sums, moved_k, ptsT, n, cents, moved, best, stall, act,
                  it, thresh, stolen)
    dev = ptsT.device
    if dev.type == "cpu":
        def plain():
            step_update_ref(sums, moved_k, ptsT, n, cents, moved, best,
                            stall, act, it, thresh, stall_lim, max_iters,
                            stolen)
        return plain
    if dev.type != "cuda":
        raise ValueError(f"step_update runs on cuda or cpu tensors, not {dev}")
    B, d, n_max = ptsT.shape
    k = cents.shape[1]
    lib = load_library()
    held = (sums, moved_k, ptsT, n, stolen, cents, moved, best, stall, act,
            it, thresh)
    args = ([None if t is None else t.data_ptr() for t in held]
            + [B, d, n_max, k, stall_lim, max_iters,
               torch.cuda.current_stream(dev).cuda_stream])
    launch = lib.kmeans_step_update
    what = f"kmeans_step_update (B={B}, d={d}, k={k})"

    def d3():
        _raise_launch(lib, launch(*args), what)
        with _count_lock:
            step_update.launches += 1

    d3.held = held
    return d3


step_update.launches = 0


def step_update_ref(sums, moved_k, ptsT, n, cents, moved, best, stall, act,
                    it, thresh, stall_lim: int, max_iters: int,
                    stolen=None) -> None:
    """The plain PyTorch version of D3 (any device, no host sync)."""
    d = ptsT.shape[1]
    k = cents.shape[1]
    a = act != 0
    wsum = sums[:, :, d]
    means = sums[:, :, :d] // wsum.clamp(min=1)[:, :, None]
    if stolen is None:
        steal = steal_indices(k, it, n.to(torch.int64))
        stolen = ptsT.gather(2, steal[:, None, :].expand(-1, d, -1)
                             ).transpose(1, 2)                    # (B, k, d)
    fresh = torch.where((wsum == 0)[:, :, None], stolen.to(torch.int64),
                        means)
    cents.copy_(torch.where(a[:, None, None], fresh.to(torch.int32), cents))
    mv = moved_k.to(torch.int64)
    moved.copy_(torch.where(a, mv, moved))
    new_best, new_stall = plateau_update(a, mv, best, stall)
    best.copy_(new_best)
    stall.copy_(new_stall)
    it_next = it + a.to(torch.int64)
    live = (moved > thresh) & (stall < stall_lim) & (it_next < max_iters)
    act.copy_((a & live).to(torch.int32))
    it.copy_(it_next)
    sums.mul_((~a)[:, None, None].to(torch.int64))
    moved_k.mul_((~a).to(torch.int32))


# ---------------------------------------------------------------------------
# the loop's iteration: K1 with D3 in each lane's last block
# ---------------------------------------------------------------------------

def prepare_step(ptsT, w, cur, cents, n, act, pmax, sums, moved_k, moved,
                 best, stall, it, thresh, stall_lim: int, max_iters: int,
                 fused: bool = True):
    """Check the operands of a whole iteration once and return a callable
    that runs it in place, any number of times: K1 (`assign_stats` over the
    lanes `act` names, the new ids written over `cur`) then D3
    (`step_update`).

    On CUDA tensors the iteration is one launch, K1 whose last block of
    each lane runs the lane's update, on the stream that is current now
    (the caller keeps the tensors' device current while it calls); it adds
    one to `assign_stats.launches`. `fused=False` keeps the two launches,
    `assign_stats` then `step_update` (`prepare_assign`, `prepare_update`).
    CPU tensors take the two plain versions either way."""
    k1 = prepare_assign(ptsT, w, cur, cents, n, act, pmax,
                        out=(cur, sums, moved_k))
    d3 = prepare_update(sums, moved_k, ptsT, n, cents, moved, best, stall,
                        act, it, thresh, stall_lim, max_iters)
    dev = ptsT.device

    def two_launches() -> None:
        k1()
        d3()

    if dev.type == "cpu" or not fused:
        return two_launches
    B, d, n_max = ptsT.shape
    k = cents.shape[1]
    lib = load_library()
    tickets = torch.zeros(B, dtype=torch.int32, device=dev)
    what = f"kmeans_fused_step (B={B}, d={d}, n_max={n_max}, k={k})"
    # the tensors stay alive in this tuple for as long as the callable does
    held = (ptsT, w, cur, cents, n, act, cur, sums, moved_k, moved, best,
            stall, it, thresh, tickets)
    args = ([t.data_ptr() for t in held]
            + [B, d, n_max, k, int(packed_path(pmax, k)), stall_lim,
               max_iters, torch.cuda.current_stream(dev).cuda_stream])
    launch = lib.kmeans_fused_step

    def one_launch() -> None:
        rc = launch(*args)
        if rc != 0:
            _raise_launch(lib, rc, what)
        with _count_lock:
            assign_stats.launches += 1

    one_launch.held = held
    return one_launch
