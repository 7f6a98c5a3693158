"""Entry points of the port (counterparts of the repo's ``__graft_entry__``).

``entry(device)`` returns ``(fn, args)``: ``fn(*args)`` runs up to 8
iterations of the k-means loop's step (`ops.kmeans_kernel.prepare_step`: on
the card one launch an iteration, K1 with D3 in each lane's last block) over
two lanes, from the state ``__graft_entry__.entry`` builds (B = 2, k = 64,
d = 5, n = 16384 points from ``default_rng(0)``, centroids the first 64
points) and returns the loop's state.

``dryrun_multichip(n, device)`` runs the JAX dry run's checks on a group of
`n` ranks (the group that is up, or `n` spawned ranks: NCCL and `n` cards on
cuda, gloo on the CPU): lane-sharded encodes equal the single-device ones,
`sharded_kmeans` equals `kmeans`, `sharded_mse` is exact, and the runner's
CSVs with the mesh equal those without it byte for byte.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from . import resolve_device
from .ops import kmeans as km
from .ops import kmeans_kernel as kk
from .parallel import launch, mesh

B, K, D, N = 2, 64, 5, 16384


def _burst(ptsT, w, cur, cents, n, thresh, moved0, best0, stall0, it0: int,
           *, k: int, max_iters: int, pmax):
    """Up to `max_iters` iterations from the given state (the inputs are
    left as they are); returns (it, cur, cents, moved, best, stall)."""
    cur, cents = cur.clone(), cents.clone()
    moved, best, stall = moved0.clone(), best0.clone(), stall0.clone()
    lanes = ptsT.shape[0]
    dev = ptsT.device
    it = torch.full((lanes,), it0, dtype=torch.int64, device=dev)
    act = ((moved > thresh) & (stall < km._STALL_LIMIT)).to(torch.int32)
    sums = torch.zeros((lanes, k, ptsT.shape[1] + 1), dtype=torch.int64,
                       device=dev)
    moved_k = torch.zeros(lanes, dtype=torch.int32, device=dev)
    step = kk.prepare_step(ptsT, w, cur, cents, n, act, pmax, sums, moved_k,
                           moved, best, stall, it, thresh, km._STALL_LIMIT,
                           it0 + max_iters)
    guard = (torch.cuda.device(dev) if dev.type == "cuda"
             else contextlib.nullcontext())
    with guard:
        for _ in range(max_iters):
            step()
    return int(it.max()), cur, cents, moved, best, stall


def entry(device="cuda"):
    """(fn, args) of one batched k-means burst over two lanes on `device`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    pts = rng.integers(0, 256, (B, N, D)).astype(np.int32)
    ptsT = torch.from_numpy(np.ascontiguousarray(pts.transpose(0, 2, 1)))
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    args = (
        ptsT.to(dev),
        torch.ones((B, N), **i32),
        torch.zeros((B, N), **i32),
        torch.from_numpy(pts[:, :K, :].copy()).to(dev),
        torch.full((B,), N, **i32),
        torch.full((B,), N >> 10, **i64),
        torch.full((B,), N, **i64),
        torch.full((B,), N, **i64),
        torch.zeros(B, **i64),
        0,
    )
    fn = functools.partial(_burst, k=K, max_iters=8, pmax=[255] * D)
    return fn, args


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The multi-device dry run on a group of `n_devices` ranks; raises
    AssertionError where a sharded result differs from the single-device
    one."""
    resolve_device(device)
    if dist.is_initialized():
        _dryrun_rank(n_devices, device)
    else:
        launch.run(n_devices, _dryrun_rank, (n_devices, device),
                   device=device)


def _check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _unsharded(fn):
    """fn() with the lane sharding off (CNIIC_MESH=0)."""
    old = os.environ.get("CNIIC_MESH")
    os.environ["CNIIC_MESH"] = "0"
    try:
        return fn()
    finally:
        if old is None:
            del os.environ["CNIIC_MESH"]
        else:
            os.environ["CNIIC_MESH"] = old


def _dryrun_rank(n_devices: int, device) -> None:
    from . import image_io, runner
    from .codecs import from_spec

    group = mesh.make_mesh(n_devices, device=device)
    rng = np.random.default_rng(0)

    # 1. the codecs' encodes with the lanes sharded over the ranks
    imgs = [rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
            for _ in range(n_devices)]
    for spec in ("cluster-colors(4)", "voronoi(8)"):
        codec = from_spec(spec, device=device)
        sharded = codec.encode_batch(imgs)
        single = _unsharded(lambda: codec.encode_batch(imgs))
        _check(sharded == single, f"{spec}: sharded stream diverged")
        codec.decode(sharded[0])

    # 2. one point set split over the ranks
    pts = rng.integers(0, 256, (64 * n_devices, 5)).astype(np.int64)
    c1, a1, i1 = km.kmeans(pts, 16, device=device)
    c2, a2, i2 = mesh.sharded_kmeans(group, pts, 16, block=64, device=device)
    _check(i1 == i2 and np.array_equal(a1, a2) and np.array_equal(c1, c2),
           "sharded_kmeans diverged from kmeans")

    # 3. the MSE of a lane-sharded batch, gathered
    imgs_b = rng.integers(0, 256, (n_devices * 2, 8, 8, 3)).astype(np.uint8)
    noisy = imgs_b.copy()
    noisy[..., 0] ^= 1
    mse = mesh.sharded_mse(group, *mesh.shard_batch(
        group, torch.from_numpy(imgs_b).to(device),
        torch.from_numpy(noisy).to(device)))
    want = ((imgs_b[..., 0].astype(np.int64) - noisy[..., 0]) ** 2).sum(
        (1, 2)) / 64
    _check(mse.shape == (n_devices * 2,) and np.array_equal(
        mse.cpu().numpy(), want), "sharded_mse is not the exact MSE")

    # 4. the runner's CSVs with the mesh and without it
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i in range(n_devices):
            p = os.path.join(td, f"m{i}.png")
            image_io.save_png(
                rng.integers(0, 256, (16, 24, 3)).astype(np.uint8), p)
            paths.append(p)
        for spec in ("cluster-colors(4)", "voronoi(8)"):
            codec = from_spec(spec, device=device)
            out_mesh = os.path.join(td, "out_mesh")
            out_single = os.path.join(td, "out_single")
            runner.measure_all(codec, paths, output_dir=out_mesh,
                               verbose=False, batch=n_devices)
            _unsharded(lambda: runner.measure_all(
                codec, paths, output_dir=out_single, verbose=False,
                batch=n_devices))
            if dist.get_rank(group) != 0:
                continue  # rank 0 alone writes the CSVs
            with open(os.path.join(out_mesh, f"{codec.name}.csv"), "rb") as f:
                a = f.read()
            with open(os.path.join(out_single, f"{codec.name}.csv"),
                      "rb") as f:
                b = f.read()
            _check(a == b and a.count(b"\n") == n_devices + 1,
                   f"{spec}: mesh sweep CSV diverged")
