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
* Given the bound filter's state (``prune_state``) at a shape
  ``pruned_path`` picks (voronoi's points at k >= 512, unpacked), the
  one launch of ``prepare_step`` is K1's pruned instance: the same outputs,
  the scans of points no other centroid can have come closer to skipped
  (``pruned_assign_ref`` is the filter's plain model; ``scanned_points``
  counts what it scanned).

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
    lib.kmeans_pruned_step.argtypes = [vp] * 20 + [ci] * 5 + [cl, cl, vp]
    lib.kmeans_pruned_step.restype = ci
    lib.kmeans_prune_window.argtypes = []
    lib.kmeans_prune_window.restype = ci
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

# K1's pruned instance (the bound filter in front of the scan, see the
# kernel's note) runs voronoi's points (d = 5) on the unpacked path from this
# k up, where the scan over k centroids is nearly all of the step
PRUNE_D = 5
PRUNE_MIN_K = 512


def pruned_path(d: int, k: int, pmax) -> bool:
    """Whether the loop's iteration on the card takes K1's pruned instance:
    chosen by the shape, d = 5 and k >= 512 on the unpacked path."""
    return d == PRUNE_D and k >= PRUNE_MIN_K and not packed_path(pmax, k)


# the snapshots a lane keeps of its last centroid sets (see the model below)
PRUNE_WINDOW = 16


def prune_state(cents, n_max: int):
    """The bound filter's state for one loop over the centroids `cents`
    (int32[B, k, d], iteration 0), as the first launch needs it: lb
    float32[B, n_max] = 0 and since int32[B, n_max] = 0 (every point is
    held to its exact distance), the snapshots int32[B, PRUNE_WINDOW, d, k]
    (iteration 0's in slot 0) and mdisp float32[B, PRUNE_WINDOW] = 0."""
    B, k, d = cents.shape
    dev = cents.device
    ring = torch.zeros((B, PRUNE_WINDOW, d, k), dtype=torch.int32, device=dev)
    ring[:, 0] = cents.transpose(1, 2)
    return (torch.zeros((B, n_max), dtype=torch.float32, device=dev),
            torch.zeros((B, n_max), dtype=torch.int32, device=dev), ring,
            torch.zeros((B, PRUNE_WINDOW), dtype=torch.float32, device=dev))


_scan_counts = {}   # device -> uint64[1] the pruned instance adds to


def _scan_count(dev) -> torch.Tensor:
    with _count_lock:
        if dev not in _scan_counts:
            _scan_counts[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
        return _scan_counts[dev]


def scanned_points() -> int:
    """Points the pruned instance scanned, over every launch so far (a
    device read: it waits for the launches)."""
    with _count_lock:
        counts = list(_scan_counts.values())
    return sum(int(c.item()) for c in counts)


def prepare_step(ptsT, w, cur, cents, n, act, pmax, sums, moved_k, moved,
                 best, stall, it, thresh, stall_lim: int, max_iters: int,
                 fused: bool = True, bounds=None):
    """Check the operands of a whole iteration once and return a callable
    that runs it in place, any number of times: K1 (`assign_stats` over the
    lanes `act` names, the new ids written over `cur`) then D3
    (`step_update`).

    On CUDA tensors the iteration is one launch, K1 whose last block of
    each lane runs the lane's update, on the stream that is current now
    (the caller keeps the tensors' device current while it calls); it adds
    one to `assign_stats.launches`. `fused=False` keeps the two launches,
    `assign_stats` then `step_update` (`prepare_assign`, `prepare_update`).
    CPU tensors take the two plain versions either way.

    bounds: on the card, the bound filter's state (`prune_state` of the
    loop's first centroids), made for this loop and changed by nothing else,
    for a shape `pruned_path` picks: the one launch is then K1's pruned
    instance (every output the same), which adds to
    `assign_stats.pruned_launches` too and to `scanned_points`. The
    callable's `pruned` says which instance it runs."""
    k1 = prepare_assign(ptsT, w, cur, cents, n, act, pmax,
                        out=(cur, sums, moved_k))
    d3 = prepare_update(sums, moved_k, ptsT, n, cents, moved, best, stall,
                        act, it, thresh, stall_lim, max_iters)
    dev = ptsT.device

    def two_launches() -> None:
        k1()
        d3()

    two_launches.pruned = False
    if dev.type == "cpu" or not fused:
        if bounds is not None and dev.type != "cpu":
            raise ValueError("the pruned instance is the one-launch iteration")
        return two_launches
    B, d, n_max = ptsT.shape
    k = cents.shape[1]
    lib = load_library()
    tickets = torch.zeros(B, dtype=torch.int32, device=dev)
    what = f"kmeans_fused_step (B={B}, d={d}, n_max={n_max}, k={k})"
    # the tensors stay alive in this tuple for as long as the callable does
    held = (ptsT, w, cur, cents, n, act, cur, sums, moved_k, moved, best,
            stall, it, thresh, tickets)
    launch = lib.kmeans_fused_step
    pruned = bounds is not None
    if pruned:
        if not pruned_path(d, k, pmax):
            keys = "packed" if packed_path(pmax, k) else "unpacked"
            raise ValueError(f"K1 has no pruned instance at d={d}, k={k}, "
                             f"{keys}")
        f32, i32, W = torch.float32, torch.int32, PRUNE_WINDOW
        _check_tensors({"lb": (bounds[0], f32, (B, n_max)),
                        "since": (bounds[1], i32, (B, n_max)),
                        "ring": (bounds[2], i32, (B, W, d, k)),
                        "mdisp": (bounds[3], f32, (B, W))}, dev)
        if lib.kmeans_prune_window() != W:
            raise RuntimeError(f"{SOURCE} keeps {lib.kmeans_prune_window()} "
                               f"snapshots, the wrapper {W}")
        held += (*bounds, _scan_count(dev))
        launch = lib.kmeans_pruned_step
        what = "kmeans_pruned_step" + what[len("kmeans_fused_step"):]
    args = ([t.data_ptr() for t in held]
            + [B, d, n_max, k, int(packed_path(pmax, k)), stall_lim,
               max_iters, torch.cuda.current_stream(dev).cuda_stream])

    def one_launch() -> None:
        rc = launch(*args)
        if rc != 0:
            _raise_launch(lib, rc, what)
        with _count_lock:
            assign_stats.launches += 1
            if pruned:
                assign_stats.pruned_launches += 1

    one_launch.held = held
    one_launch.pruned = pruned
    return one_launch


assign_stats.pruned_launches = 0


# ---------------------------------------------------------------------------
# the bound filter in front of K1's scan: a plain model
# ---------------------------------------------------------------------------
#
# Exact pruning of the centroid scan. Each point keeps a lower bound `lb`
# on its distance to every centroid but its own, as they were at iteration
# `since` (its last scan), one a group of `groups` contiguous ranges of
# centroid ids (Yinyang's grouped bounds; one group is Hamerly's bound).
# The lane keeps the centroids of its last `window` iterations, and after
# each update the largest distance any centroid of a group has moved from
# each of them (`mdisp`). At iteration t a point's distance to another
# centroid is at least lb - mdisp[since] (the triangle inequality), and its
# distance to its own centroid is computed exactly. When that distance is
# at most every group's bound, no other centroid can be strictly closer,
# and K1 moves a point only to a strictly closer one: the point keeps its
# centroid with no scan. A point kept at window // 2 iterations from its
# snapshot takes the bound as its new one (it is rebased to t); any other
# point is scanned, and its bounds are set from the scan. A window of 2
# rebases every kept point every step: Hamerly's rule, lb shrinking by the
# largest drift each step. Every result equals the unpruned step's. The
# kernel keeps the bounds in float32 with directed rounding; this model in
# float64, rounded outward the same way. Tests and
# `prune_probe.py` use it, the main path does not.

_INF = float("inf")


def _sqrt_out(d2, up: bool):
    """sqrt of exact integer squares (int64), rounded up or down: exact for
    a perfect square, else one float64 step outward."""
    s = torch.sqrt(d2.to(torch.float64))
    exact = (s == torch.floor(s)) & (s * s == d2.to(torch.float64))
    away = torch.nextafter(s, torch.full_like(s, _INF if up else -_INF))
    return torch.where(exact, s, away).clamp(min=0.0)


def _sub_down(a, b):
    """a - b rounded down: the rounding error of the float64 difference,
    by Knuth's two-sum, says whether the nearest one fell above."""
    r = a - b
    bb = r - a
    err = (a - (r - bb)) - (b + bb)
    low = torch.where(err < 0, torch.nextafter(r, torch.full_like(r, -_INF)),
                      r)
    return torch.where(torch.isfinite(r), low, r)


def group_of(k: int, groups: int, device="cpu"):
    """Each centroid id's group: `groups` contiguous ranges of ids."""
    return torch.arange(k, dtype=torch.int64, device=device) * groups // k


def prune_bounds_ref(cents, n_max: int, window: int, groups: int = 1):
    """The model's state at the start of a loop over centroids `cents`
    (int32[B, k, d], iteration 0): lb float64[B, groups, n_max] = 0 and
    since int64[B, n_max] = 0 (every point is held to its exact distance,
    so only a point on its centroid is kept), the snapshots int64[B,
    window, k, d] (iteration 0's in slot 0) and mdisp float64[B, window,
    groups] = 0."""
    B, k, d = cents.shape
    dev = cents.device
    ring = torch.zeros((B, window, k, d), dtype=torch.int64, device=dev)
    ring[:, 0] = cents
    return {"lb": torch.zeros((B, groups, n_max), dtype=torch.float64,
                              device=dev),
            "since": torch.zeros((B, n_max), dtype=torch.int64, device=dev),
            "ring": ring,
            "mdisp": torch.zeros((B, window, groups), dtype=torch.float64,
                                 device=dev)}


def snapshot_ref(state, cents, it, ran) -> None:
    """After D3: each lane that ran (bool[B]) keeps its new centroids as
    iteration it[b]'s snapshot and sets mdisp[b, slot, g], the largest
    distance a centroid of group g moved from each snapshot, rounded up."""
    ring, mdisp = state["ring"], state["mdisp"]
    B, W, k, _ = ring.shape
    G = mdisp.shape[2]
    grp = group_of(k, G, cents.device)
    for b in torch.nonzero(ran)[:, 0].tolist():
        ring[b, int(it[b]) % W] = cents[b]
        diff = cents[b].to(torch.int64)[None] - ring[b]          # (W, k, d)
        disp = _sqrt_out((diff * diff).sum(2), up=True)          # (W, k)
        m = torch.zeros((W, G), dtype=torch.float64, device=cents.device)
        mdisp[b] = m.scatter_reduce(1, grp[None].expand(W, -1), disp, "amax")


def _d2(ptsT, cents, b, idx, c):
    """Exact squared distances int64 of lane b's points `idx` to its
    centroids `c` (one a point)."""
    p = ptsT[b][:, idx].to(torch.int64)                      # (d, m)
    q = cents[b][c].to(torch.int64).T                        # (d, m)
    return ((p - q) ** 2).sum(0)


def filter_ref(ptsT, cur, cents, n, act, it, state):
    """The filter's decisions for one step at each lane's iteration it[b]:
    which points must be scanned, bool[B, n_max] (active lanes' valid
    points that fail). Rebases the points it keeps at window // 2
    iterations or more from their snapshot, in place."""
    B, d, n_max = ptsT.shape
    lb, since, mdisp = state["lb"], state["since"], state["mdisp"]
    W = mdisp.shape[1]
    dev = ptsT.device
    scan = torch.zeros((B, n_max), dtype=torch.bool, device=dev)
    for b in range(B):
        nb, t = int(n[b]), int(it[b])
        if int(act[b]) == 0 or nb == 0:
            continue
        a = cur[b, :nb].to(torch.int64)
        ub = _sqrt_out(_d2(ptsT, cents, b, torch.arange(nb, device=dev), a),
                       up=True)
        s = since[b, :nb]
        low = _sub_down(lb[b, :, :nb], mdisp[b, s % W].T)            # (G, nb)
        low = torch.where((t - s < W)[None], low, -_INF)
        keep = ub <= low.min(0).values
        rebase = keep & (t - s >= W // 2)
        lb[b, :, :nb] = torch.where(rebase[None], low, lb[b, :, :nb])
        since[b, :nb] = torch.where(rebase, t, s)
        scan[b, :nb] = ~keep
    return scan


def pruned_assign_ref(ptsT, w, cur, cents, n, act, it, state):
    """The model of K1 behind the filter: `filter_ref`, then the exact scan
    (the scores, first minimum and strict-move rule of `assign_stats_ref`)
    of the points that fail only, the statistics over every point of the
    active lanes, and the scanned points' bounds set from their scan (lb[g]
    the least distance to group g's centroids but the new one, since the
    lane's iteration). Returns (new, sums, moved, scanned bool[B, n_max]) as
    `assign_stats_ref` returns the first three."""
    B, d, n_max = ptsT.shape
    k = cents.shape[1]
    lb, since = state["lb"], state["since"]
    G = lb.shape[1]
    dev = ptsT.device
    grp = group_of(k, G, dev)
    scan = filter_ref(ptsT, cur, cents, n, act, it, state)
    new = torch.zeros((B, n_max), dtype=torch.int32, device=dev)
    sums = torch.zeros((B, k, d + 1), dtype=torch.int64, device=dev)
    moved = torch.zeros((B,), dtype=torch.int32, device=dev)
    block = max(1, _REF_TILE[dev.type] // k)
    top = torch.iinfo(torch.int64).max
    for b in range(B):
        nb = int(n[b])
        if int(act[b]) == 0:
            continue
        nw = cur[b, :nb].to(torch.int64).clone()
        idx_all = torch.nonzero(scan[b, :nb])[:, 0]
        c = cents[b].to(torch.float64)
        cc = (c * c).sum(1)
        m2c = (-2.0 * c).T.contiguous()
        for s in range(0, idx_all.numel(), block):
            idx = idx_all[s:s + block]
            p = ptsT[b][:, idx].to(torch.float64)              # (d, m)
            score = torch.addmm(cc, p.T, m2c)                  # (m, k)
            best = torch.argmin(score, dim=1)                  # first minimum
            c0 = nw[idx]
            best_s = score.gather(1, best[:, None])[:, 0]
            cur_s = score.gather(1, c0[:, None])[:, 0]
            got = torch.where(best_s < cur_s, best, c0)   # strictly closer
            nw[idx] = got
            d2 = (score + (p * p).sum(0)[:, None]).round().to(torch.int64)
            d2.scatter_(1, got[:, None], top)                  # all but got
            low = torch.full((G, idx.numel()), top, dtype=torch.int64,
                             device=dev)
            low = low.scatter_reduce(0, grp[:, None].expand(-1, idx.numel()),
                                     d2.T, "amin")
            lb[b][:, idx] = torch.where(low == top, _INF,      # a group of one
                                        _sqrt_out(low.clamp(max=2**62),
                                                  up=False))
            since[b, idx] = int(it[b])
        new[b, :nb] = nw.to(torch.int32)
        moved[b] = (nw != cur[b, :nb]).sum().to(torch.int32)
        wv = w[b, :nb].to(torch.int64)
        feats = torch.cat([ptsT[b, :, :nb].to(torch.int64) * wv[None, :],
                           wv[None, :]], dim=0).T
        sums[b].index_add_(0, nw, feats)
    return new, sums, moved, scan
