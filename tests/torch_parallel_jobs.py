"""What the parallel tests run on each spawned rank (`parallel.launch.run`
imports these functions by reference in every rank; nothing here imports
jax). Each job brings up no group of its own: `launch` has done that."""

import os

from cniic_tpu_torch import cli
from cniic_tpu_torch.codecs import from_spec
from cniic_tpu_torch.ops import kmeans as km
from cniic_tpu_torch.ops import kmeans_kernel as kk
from cniic_tpu_torch.parallel import mesh


def _spy_steals(fn):
    """fn() and the iterations at which D3 stole a point for an empty
    cluster of an active lane."""
    steals = []
    real = kk.step_update_ref

    def spy(sums, moved_k, ptsT, n, cents, moved, best, stall, act, it,
            *rest, **kw):
        d = ptsT.shape[1]
        if bool(((sums[:, :, d] == 0) & (act != 0)[:, None]).any()):
            steals.append(int(it.max()))
        return real(sums, moved_k, ptsT, n, cents, moved, best, stall, act,
                    it, *rest, **kw)

    kk.step_update_ref = spy
    try:
        return fn(), steals
    finally:
        kk.step_update_ref = real


def sharded_kmeans_cases(cases):
    """[(pts, k, weights, block)] -> [((centroids, assignment, iters),
    steal iterations)] through `mesh.sharded_kmeans` on the CPU."""
    group = mesh.make_mesh()
    return [_spy_steals(lambda: mesh.sharded_kmeans(
        group, pts, k, weights=w, block=block, device="cpu"))
        for pts, k, w, block in cases]


def _drive_lanes(fn):
    """fn() and the lane count of every k-means loop it drove."""
    lanes = []
    real = km._drive

    def spy(ptsT, *args):
        lanes.append(ptsT.shape[0])
        return real(ptsT, *args)

    km._drive = spy
    try:
        return fn(), lanes
    finally:
        km._drive = real


def encodes(specs, imgs):
    """Per spec: the streams and the lanes each loop drove, with the lane
    sharding on and under CNIIC_MESH=0, and the voronoi codecs' fused
    decode + MSE (the MSEs and the fetched images) of the sharded streams."""
    out = {}
    for spec in specs:
        codec = from_spec(spec, device="cpu")
        on = _drive_lanes(lambda: codec.encode_batch(imgs))
        os.environ["CNIIC_MESH"] = "0"
        try:
            off = _drive_lanes(lambda: codec.encode_batch(imgs))
        finally:
            del os.environ["CNIIC_MESH"]
        fused = None
        if hasattr(codec, "decode_mse_batch"):
            mses, fetch = codec.decode_mse_batch(on[0], imgs)
            fused = (mses, fetch())
        out[spec] = {"on": on, "off": off, "fused": fused}
    return out


def mesh_facts(batches):
    """batch_mesh's answer for each batch size, with the sharding on and
    under CNIIC_MESH=0, and this rank's lanes of each."""
    on = [mesh.batch_mesh(b) is not None for b in batches]
    os.environ["CNIIC_MESH"] = "0"
    try:
        off = [mesh.batch_mesh(b) is not None for b in batches]
    finally:
        del os.environ["CNIIC_MESH"]
    group = mesh.make_mesh()
    ranges = [mesh.lane_range(group, b) if ok else None
              for b, ok in zip(batches, on)]
    return on, off, ranges


def sharded_mse(x, y):
    group = mesh.make_mesh()
    return mesh.sharded_mse(group, *mesh.shard_batch(group, x, y)).numpy()


def world(tasks):
    """Run [(job name, args)] in order on this rank; the results by name.
    A "cli" task runs the CLI in the directory it names (it takes the group
    down, so it comes last)."""
    out = {}
    for name, args in tasks:
        if name == "cli":
            workdir, argv = args
            os.chdir(workdir)
            out[name] = cli.main(argv)
        else:
            out[name] = globals()[name](*args)
    return out
