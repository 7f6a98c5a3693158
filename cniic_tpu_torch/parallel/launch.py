"""Spawning the ranks of a mesh on one host, the way torchrun would.

    results = launch.run(4, job, args, device="cpu")

starts `world` fresh interpreters (`torch.multiprocessing.spawn`), gives
each the environment torchrun sets (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT on a free localhost port), brings
the default group up through `mesh.make_mesh` and calls ``job(*args)`` there.
It returns the jobs' results in rank order. A rank that raises stops the
others, and `run` raises with its traceback
(`torch.multiprocessing.ProcessRaisedException`). `job` is pickled by
reference, so it must be a module-level function that the children can
import; its arguments and its result are pickled by value.

A CPU rank runs torch on its share of the host's cores. CUDA ranks under
NCCL take a card each; under gloo (``backend="gloo"``) they share the cards.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch.multiprocessing as mp

from .. import resolve_device
from . import mesh


def _rank_main(rank: int, world: int, port: int, device: str, backend,
               job, args, outs: list) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        mesh.make_mesh(world, device=device, backend=backend)
        result = job(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # a file, not a queue: a result larger than a pipe's buffer would block
    # the rank until the parent reads, and the parent reads after the join
    with open(outs[rank], "wb") as fh:
        pickle.dump(result, fh)


def run(world: int, job, args=(), device: str = "cuda",
        backend: str | None = None) -> list:
    """Run ``job(*args)`` on `world` spawned ranks of one group on `device`
    (the card unless the caller asks for the CPU); return the results by
    rank. No card for a CUDA device raises here, before any rank starts."""
    resolve_device(device)
    port = mesh.free_port()
    with tempfile.TemporaryDirectory(prefix="cniic_ranks_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(world, port, device, backend, job, args, outs))
        results = []
        for out in outs:
            with open(out, "rb") as fh:  # written by this run's own ranks
                results.append(pickle.load(fh))
    return results
