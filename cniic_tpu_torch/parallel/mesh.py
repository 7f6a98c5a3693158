"""Multi-device scaling over `torch.distributed` (port of
``cniic_tpu/parallel/mesh.py``).

JAX's mesh is one controller over many devices; here the "mesh" is the
default process group, one rank a device, every rank running the same
program on the same inputs (SPMD). Each rank holds its share of the work and
ends with the whole result, as the JAX program does:

* **lane sharding** (the production axis): `ops.kmeans.kmeans_batch` and
  `voronoi_centroids_batch` hand each rank a contiguous range of their
  lanes when `batch_mesh` gives a group; each rank drives its lanes with the
  single-device loop and the per-lane results are gathered to every rank.
  The fused voronoi decode + MSE reconstructs a rank's lanes and gathers the
  MSEs through `sharded_mse`. Lane trajectories are independent, so the
  streams equal the single-device ones.
* **point sharding** (`sharded_kmeans`): one point set split over the
  ranks. Each iteration runs K1 over the rank's points, one all-reduce of
  the integer statistics, the move count and the empty clusters' candidate
  points (each rank contributes the points it holds, zeros elsewhere: the
  masked gather of JAX's psum), then D3 given those candidates. Integer sums
  do not depend on the order of the reduction, so the result equals the
  single-device `kmeans` bit for bit.

Backends: NCCL for CUDA tensors, one rank a card (`cuda:LOCAL_RANK`); gloo
for CPU tensors. A gloo group also carries CUDA tensors, staged through the
host (`_to_comm`), which lets several ranks share one card. Every collective
here is synchronous and issued in the same order on every rank.

Not ported: `sharded_voronoi_reconstruct` (no caller), `shard_map_unchecked`
and the compile keys, burst sizing and narrow uploads of `_sharded_burst`.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

# how long a collective may wait for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=300)


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(n: int | None = None, device="cuda", backend: str | None = None):
    """The default process group, the port's mesh of `n` ranks (None: as
    many as the environment says).

    It returns the group that is already up, or initializes one from the
    environment as torchrun sets it (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT); with no WORLD_SIZE there, a world of one on a
    free localhost port. The backend is NCCL for a CUDA device and gloo for
    the CPU; `backend="gloo"` with a CUDA device lets ranks share a card,
    the collectives staged through the host. A CUDA rank uses
    `cuda:LOCAL_RANK` (modulo the cards under gloo). An NCCL group of more
    ranks on a host than it has cards raises, and so does a missing card:
    nothing falls back to gloo or to the CPU."""
    if dist.is_initialized():
        world = dist.get_world_size()
        if n is not None and n != world:
            raise ValueError(f"a group of {world} ranks is up, not {n}")
        return dist.group.WORLD
    dev = resolve_device(device)
    env_world = os.environ.get("WORLD_SIZE")
    world = int(env_world) if env_world else 1
    if n is not None and n != world:
        raise ValueError(
            f"a mesh of {n} ranks needs {n} processes launched with "
            f"WORLD_SIZE={n} (torchrun, or parallel.launch.run); this one "
            f"has WORLD_SIZE={world}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL carries CUDA tensors only: use device='cuda' "
                         "or backend='gloo'")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", "0"))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        if backend == "nccl" and local_world > cards:
            raise RuntimeError(
                f"an NCCL group of {local_world} ranks on this host needs "
                f"{local_world} CUDA cards; {cards} visible")
        torch.cuda.set_device(local % cards)
    if env_world:
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{free_port()}", rank=0,
            world_size=1, timeout=TIMEOUT)
    return dist.group.WORLD


def world_group():
    """The default group when one of more than one rank is up, else None
    (whatever CNIIC_MESH says: the runner's one-writer rule needs it)."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def batch_mesh(batch: int):
    """The group the k-means drivers shard `batch` lanes over, or None to
    stay on one device: needs a group of more than one rank, a batch the
    ranks divide, and no CNIIC_MESH=0 override (JAX's `batch_mesh`)."""
    if os.environ.get("CNIIC_MESH", "") == "0":
        return None
    group = world_group()
    if group is None or batch % dist.get_world_size(group) != 0:
        return None
    return group


def batch_lanes(batch: int):
    """(group, lo, hi): `batch_mesh`'s group for `batch` lanes and this
    rank's contiguous lanes [lo, hi) of them, or (None, 0, batch) on one
    device."""
    group = batch_mesh(batch)
    if group is None:
        return None, 0, batch
    return (group, *lane_range(group, batch))


def lane_range(group, batch: int) -> tuple[int, int]:
    """This rank's contiguous lanes [lo, hi) of a batch the group divides."""
    world = dist.get_world_size(group)
    if batch % world:
        raise ValueError(f"{batch} lanes do not divide over {world} ranks")
    rank = dist.get_rank(group)
    per = batch // world
    return rank * per, (rank + 1) * per


def shard_batch(group, *arrays):
    """This rank's lanes of arrays with a leading lane axis (JAX's
    `shard_batch`: the batch laid over the group)."""
    lo, hi = lane_range(group, arrays[0].shape[0])
    return tuple(a[lo:hi] for a in arrays)


def _comm_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _to_comm(group, t: torch.Tensor) -> torch.Tensor:
    """`t` where the backend takes it: on the card for NCCL, on the host for
    gloo (a CUDA tensor is copied, which waits for the card)."""
    return t.contiguous().to(_comm_device(group))


def all_reduce(group, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of `t` on any device; returns `t`."""
    x = _to_comm(group, t)
    dist.all_reduce(x, op=op, group=group)
    if x.data_ptr() != t.data_ptr():
        t.copy_(x)
    return t


def all_max(group, value: int) -> int:
    """The largest of every rank's `value`."""
    t = torch.tensor([value], dtype=torch.int64)
    return int(all_reduce(group, t, dist.ReduceOp.MAX)[0])


def gather_lanes(group, t: torch.Tensor) -> torch.Tensor:
    """Every rank's lanes of `t` (equal shapes on every rank), concatenated
    in rank order along the leading axis, on `t`'s device."""
    x = _to_comm(group, t)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts).to(t.device)


# ---------------------------------------------------------------------------
# point-sharded k-means: one point set split over the ranks
# ---------------------------------------------------------------------------

class Clock:
    """Spans between marks on the card's clock (CUDA events, read at the
    end) or the host's (CPU). `mark(part)` closes the span since the
    previous mark and charges it to `part`; None charges it to nothing."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def mark(self, part: str | None = None) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.marks.append((part, ev))

    def parts_ms(self) -> dict:
        """{part: milliseconds charged to it in all}."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for (_, a), (part, b) in zip(self.marks, self.marks[1:]):
            if part is not None:
                ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
                out[part] = out.get(part, 0.0) + ms
        return out


def sharded_kmeans(group, points: np.ndarray, k: int,
                   weights: np.ndarray | None = None, block: int = 1024,
                   max_iters: int = 10_000, device="cuda",
                   stats: dict | None = None):
    """`ops.kmeans.kmeans` with the POINT axis split over the group's ranks:
    the same validation, tail-chunk init, stop threshold, plateau net and
    CNIIC_KMEANS_STRICT, and the same result bit for bit.

    Every rank passes the whole point set (SPMD) and holds the contiguous
    range of n_loc = ceil(n / (ranks * block)) * block points its rank
    names on `device`. Each iteration: the candidates for the empty
    clusters (the steal indices hashed from the global n and the iteration;
    each rank puts in the points it holds, zeros elsewhere), K1 over the
    rank's points (its count as K1's n), one all-reduce of the int64
    statistics, the move count and the candidates, then D3 given the
    candidates, against the global stop threshold. K1's and D3's operands
    are checked once, before the loop. The host reads the count and the
    active flag every `_CHECK_EVERY` iterations, as the single-device loop
    does; the candidates of the next such window are gathered together
    before the host waits for that read (a frozen loop ignores them), so
    the card does not wait for the host to issue them.

    Returns (centroids int64[k, d], assignment int32[n], n_iters) on every
    rank. stats: a dict to fill with the loop's "iters", "loop_ms", its
    parts' "parts_ms" ("candidates", "K1", "all-reduce", "D3", "host
    check"), the all-reduces' "collective_ms" and their count
    "collectives"; CUDA events on the card (each part's span holds the
    card's idle time while the host issued it), the host clock on the CPU;
    and "host_ms", the host's time in the loop less its waits for the
    checks' reads (on the card: how fast the host issues the loop).
    """
    from ..ops import kmeans as km
    from ..ops import kmeans_kernel as kk

    dev = resolve_device(device)
    points = np.asarray(points)
    n, d = points.shape
    km._validate_lane(points, weights, k)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n_loc = -(-n // (world * block)) * block
    lo = min(rank * n_loc, n)
    n_r = min(n, lo + n_loc) - lo

    # the tail-chunk init over the whole set (kmeans.rs:61-78)
    ppc = n // k
    tail_start = n - (k - 1) * ppc
    cur = np.full(n, k - 1, np.int32)
    j = np.arange(tail_start, n)
    cur[tail_start:] = (n - 1 - j) // ppc
    cents = np.empty((k, d), np.int32)
    cents[:k - 1] = points[n - np.arange(1, k) * ppc]
    cents[k - 1] = points[0]

    def lane(a):
        out = np.zeros((1, *a.shape[:-1], n_loc), np.int32)
        out[0, ..., :n_r] = a[..., lo:lo + n_r]
        return torch.from_numpy(out).to(dev)

    ptsT = lane(points.T.astype(np.int32))
    w = lane(np.ones(n, np.int32) if weights is None
             else np.asarray(weights).astype(np.int32))
    cur_t = lane(cur)
    cents_t = torch.from_numpy(cents[None]).to(dev)
    pmax = points.max(axis=0).tolist()

    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    strict = os.environ.get("CNIIC_KMEANS_STRICT", "") == "1"
    moved = torch.tensor([n + 1], **i64)
    best = torch.tensor([n + 1], **i64)
    stall = torch.zeros(1, **i64)
    it = torch.zeros(1, **i64)
    act = torch.tensor([int(max_iters > 0)], **i32)
    # what one all-reduce carries, in int64 words, each written by K1 or the
    # gather and read by D3 in place: K1's statistics, its int32 move count
    # in the low half of a word (little-endian) and the int32 candidates two
    # to a word. Summing the words sums the halves, as no half carries: the
    # count stays below n < 2^31, and one rank at most puts a nonzero in
    # each candidate.
    nsum = k * (d + 1)
    buf = torch.zeros(nsum + 1 + (k * d + 1) // 2, **i64)
    sums = buf[:nsum].view(1, k, d + 1)
    moved_k = buf[nsum:nsum + 1].view(torch.int32)[:1]
    stolen = buf[nsum + 1:].view(torch.int32)[:k * d].view(1, k, d)
    k1 = kk.prepare_assign(ptsT, w, cur_t, cents_t, torch.tensor([n_r], **i32),
                           act, pmax, out=(cur_t, sums, moved_k))
    d3 = kk.prepare_update(
        sums, moved_k, ptsT, torch.tensor([n], **i32), cents_t, moved, best,
        stall, act, it, torch.tensor([km._stop_threshold(n)], **i64),
        (1 << 30) if strict else km._STALL_LIMIT, max_iters, stolen=stolen)

    # a window's candidates: the steal indices of its iterations (D3 hashes
    # a live lane's count, which is the loop's iteration), this rank's
    # points at those it holds and zeros elsewhere
    window = km._CHECK_EVERY
    n64 = torch.tensor([n], **i64)
    offsets = torch.arange(window, **i64)
    cands = torch.zeros((window, k, d), **i32)

    def candidates(start: int) -> None:
        steal = kk.steal_indices(k, offsets + start, n64) - lo  # [window, k]
        held = (steal >= 0) & (steal < n_r)
        pick = ptsT[0].index_select(
            1, steal.clamp(0, max(n_r - 1, 0)).reshape(-1))      # [d, w*k]
        cands.copy_(torch.where(held[:, :, None],
                                pick.T.reshape(window, k, d), 0))

    clock = Clock(dev) if stats is not None else None
    mark = clock.mark if clock is not None else (lambda part=None: None)
    guard = (torch.cuda.device(dev) if dev.type == "cuda"
             else contextlib.nullcontext())
    count, live, start, waited = 0, max_iters > 0, 0, 0.0
    t0 = time.perf_counter()
    with guard:
        mark()
        candidates(start)
        mark("candidates")
        while live:
            for i in range(window):
                stolen[0].copy_(cands[i])
                k1()
                mark("K1")
                all_reduce(group, buf)
                mark("all-reduce")
                d3()
                mark("D3")
            start += window
            # the next window's, issued while the card runs this one's
            candidates(start)
            mark("candidates")
            t = time.perf_counter()
            count, flag = torch.cat([it, act.to(torch.int64)]).tolist()
            waited += time.perf_counter() - t
            live = bool(flag)
            mark("host check")
    host_ms = (time.perf_counter() - t0 - waited) * 1e3
    if stats is not None:
        parts = clock.parts_ms()
        stats.update(iters=count, loop_ms=sum(parts.values()),
                     parts_ms=parts, collective_ms=parts.get("all-reduce", 0.0),
                     collectives=start, host_ms=host_ms)

    assignment = gather_lanes(group, cur_t).reshape(-1)[:n].cpu().numpy()
    centroids = cents_t[0].cpu().numpy().astype(np.int64)
    active = int(np.count_nonzero(np.bincount(assignment, minlength=k)))
    km._check_active(active, k, n)
    return centroids, assignment, count


def sharded_mse(group, x, y) -> torch.Tensor:
    """Per-image MSE over a lane-sharded batch, gathered to every rank.

    x, y: this rank's lanes (uint8 [b, h, w, 3], arrays or tensors; all
    ranks the same b). Returns float64 [ranks * b] on x's device, in rank
    order: the exact integer sum of squared differences divided by h*w,
    correctly rounded, which is JAX's f64 form (every partial sum there is
    an integer below 2^53). With group None, this process's batch alone."""
    x, y = (torch.as_tensor(np.ascontiguousarray(a)) if isinstance(
        a, np.ndarray) else a for a in (x, y))
    y = y.to(x.device)
    h, w = x.shape[1], x.shape[2]
    diff = x.to(torch.int32) - y.to(torch.int32)
    tot = (diff * diff).sum(dim=tuple(range(1, diff.dim())),
                            dtype=torch.int64)
    if group is not None:
        tot = gather_lanes(group, tot)
    # the quotient is taken on the host: CUDA divides a tensor by a host
    # scalar as a multiply by its reciprocal, at times one bit off
    return torch.tensor([t / (h * w) for t in tot.tolist()],
                        dtype=torch.float64, device=x.device)
