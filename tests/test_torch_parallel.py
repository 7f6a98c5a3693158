"""The port's multi-device layer (cniic_tpu_torch.parallel, entry) against
the JAX package, on the CPU, with ranks spawned under gloo.

Every comparison is exact equality:

* `sharded_kmeans` over 4 ranks against JAX's `kmeans` and JAX's
  `sharded_kmeans` on its virtual mesh, on the cases of
  tests/test_parallel.py and on one whose clusters empty (the steal's
  candidates gathered across ranks);
* lane-sharded cluster-colors(4) and voronoi(8) streams at worlds 2 and 4
  against the single-rank port and `cniic_tpu`, the voronoi fused decode +
  MSE of a sharded batch against the single-rank one, and CNIIC_MESH=0;
* `sharded_mse` against JAX's `sharded_mse` bit for bit;
* D3's steal-candidates mode against its gather mode (plain versions);
* `entry(device="cpu")` against `__graft_entry__.entry()`, and
  `dryrun_multichip(4, device="cpu")`;
* the CLI on 2 ranks writes one CSV, equal to the one-process CSV.

The ranks are spawned once per world size (module-scoped fixtures); each
runs the jobs of `torch_parallel_jobs`.
"""

import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import torch_parallel_jobs as jobs
from cniic_tpu.codecs import from_spec as jax_from_spec
from cniic_tpu.ops import kmeans as jkm
from cniic_tpu.parallel import mesh as jmesh
from cniic_tpu_torch import cli, entry, image_io
from cniic_tpu_torch.codecs import from_spec
from cniic_tpu_torch.ops import kmeans_kernel as tkk
from cniic_tpu_torch.parallel import launch, mesh

SPECS = ("cluster-colors(4)", "voronoi(8)")


def _kmeans_cases():
    """tests/test_parallel.py's two cases (its rng fixture's seed), then a
    weighted set of 16 distinct points at k = 16, whose clusters empty."""
    rng = np.random.default_rng(1234)
    pts = rng.integers(0, 256, (700, 3)).astype(np.int64)
    wts = rng.integers(1, 9, 700).astype(np.int64)
    cases = [(pts, 12, wts, 64)]
    cases.append((rng.integers(0, 200, (512, 5)).astype(np.int64), 16, None,
                  64))
    rng = np.random.default_rng(263)
    rng.integers(150, 900), rng.integers(4, 40), rng.integers(2, 4)
    rng.choice([4, 16, 256])
    few = rng.integers(0, 4, (780, 2)).astype(np.int64)
    cases.append((few, 16, rng.integers(1, 50, 780).astype(np.int64), 64))
    return cases


def _images():
    rng = np.random.default_rng(77)
    return [rng.integers(0, 256, (24, 24, 3)).astype(np.uint8)
            for _ in range(8)]


def _mse_batch():
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (16, 8, 8, 3)).astype(np.uint8)
    noisy = imgs.copy()
    noisy[..., 0] ^= 3
    return imgs, noisy


@pytest.fixture(scope="module")
def world4():
    """One spawn of 4 gloo ranks for every world-4 check."""
    tasks = [("sharded_kmeans_cases", (_kmeans_cases(),)),
             ("encodes", (SPECS, _images())),
             ("sharded_mse", _mse_batch()),
             ("mesh_facts", ([8, 6, 4, 1],))]
    return launch.run(4, jobs.world, (tasks,), device="cpu")


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One spawn of 2 gloo ranks: the encodes, then the CLI over 3 PNGs in
    a directory of its own."""
    root = tmp_path_factory.mktemp("cli")
    paths = []
    for i, im in enumerate(_images()[:3]):
        paths.append(str(root / f"img{i}.png"))
        image_io.save_png(im, paths[-1])
    ranks = root / "ranks"
    ranks.mkdir()
    argv = ["--codec=voronoi(8)", "--device", "cpu", "--batch=2", *paths]
    tasks = [("encodes", (SPECS, _images())),
             ("cli", (str(ranks), argv))]
    return launch.run(2, jobs.world, (tasks,), device="cpu"), root, argv


@pytest.fixture(scope="module")
def single_port():
    """The lane-sharding-free port: streams, and the voronoi fused MSEs and
    images, in this (group-less) process."""
    imgs = _images()
    out = {}
    for spec in SPECS:
        codec = from_spec(spec, device="cpu")
        blobs = codec.encode_batch(imgs)
        fused = None
        if hasattr(codec, "decode_mse_batch"):
            mses, fetch = codec.decode_mse_batch(blobs, imgs)
            fused = (mses, fetch())
        out[spec] = (blobs, fused)
    return out


def _jax_mesh():
    return jmesh.make_mesh(min(8, len(jax.devices())))


@pytest.mark.parametrize("case", range(3))
def test_sharded_kmeans_matches_jax(world4, case):
    pts, k, w, block = _kmeans_cases()[case]
    want = jkm.kmeans(pts, k, weights=w)
    want_sharded = jmesh.sharded_kmeans(_jax_mesh(), pts, k, weights=w,
                                        block=block)
    for rank in world4:
        (c, a, it), steals = rank["sharded_kmeans_cases"][case]
        for ref in (want, want_sharded):
            assert it == ref[2]
            np.testing.assert_array_equal(a, ref[1])
            np.testing.assert_array_equal(c, ref[0])
        if case == 2:
            assert steals, "the input must empty a cluster"


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("world", [2, 4])
def test_lane_sharded_streams_match(world4, world2, single_port, spec, world):
    ranks = world4 if world == 4 else world2[0]
    blobs, fused = single_port[spec]
    jax_blobs = jax_from_spec(spec).encode_batch(_images())
    chunk = 8 if spec.startswith("cluster") else 4
    for rank in ranks:
        got = rank["encodes"][spec]
        (on, on_lanes), (off, off_lanes) = got["on"], got["off"]
        assert on == blobs == jax_blobs
        assert off == blobs
        # each loop drove this rank's share of a chunk; CNIIC_MESH=0 all
        assert on_lanes == [chunk // world] * (8 // chunk)
        assert off_lanes == [chunk] * (8 // chunk)
        if fused is not None:
            assert got["fused"][0] == fused[0]
            for a, b in zip(got["fused"][1], fused[1]):
                np.testing.assert_array_equal(a, b)


def test_batch_mesh_conditions(world4):
    for rank, (lo, hi) in zip(world4, [(0, 2), (2, 4), (4, 6), (6, 8)]):
        on, off, ranges = rank["mesh_facts"]
        assert on == [True, False, True, False]
        assert off == [False] * 4
        assert ranges[0] == (lo, hi)
    # no group in this process: one device
    assert mesh.batch_mesh(8) is None and mesh.world_group() is None


def test_sharded_mse_matches_jax(world4):
    imgs, noisy = _mse_batch()
    want = np.asarray(jmesh.sharded_mse(_jax_mesh())(imgs, noisy))
    for rank in world4:
        got = rank["sharded_mse"]
        assert got.dtype == np.float64 and got.shape == (16,)
        assert got.tobytes() == want.tobytes()


def _d3_state(seed, B=3, k=12, d=5, n=40):
    rng = np.random.default_rng(seed)
    t = torch.tensor
    ptsT = t(rng.integers(0, 300, (B, d, n)), dtype=torch.int32)
    sums = t(rng.integers(1, 10**6, (B, k, d + 1)), dtype=torch.int64)
    sums[:, ::3] = 0                                   # empty clusters
    i64 = dict(dtype=torch.int64)
    return [sums, t(rng.integers(0, 50, B), dtype=torch.int32), ptsT,
            t([n, n - 7, 1], dtype=torch.int32),
            t(rng.integers(0, 300, (B, k, d)), dtype=torch.int32),
            t([30, 2, 9], **i64), t([40, 40, 3], **i64), t([0, 5, 63], **i64),
            t([1, 1, 0], dtype=torch.int32), t([7, 2**31 + 3, 4], **i64),
            t([3, 3, 3], **i64), 64, 2**31 + 4]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", ["ref", "wrapper"])
def test_d3_steal_candidates_match_gather(seed, fn):
    """D3 given the points its hash picks equals D3 gathering them."""
    gather = _d3_state(seed)
    given = [x.clone() if torch.is_tensor(x) else x for x in gather]
    ptsT, n, it = gather[2], gather[3], gather[9]
    k, d = gather[4].shape[1], ptsT.shape[1]
    steal = tkk.steal_indices(k, it, n.to(torch.int64))
    stolen = ptsT.gather(2, steal[:, None, :].expand(-1, d, -1)
                         ).transpose(1, 2).contiguous()
    call = tkk.step_update_ref if fn == "ref" else tkk.step_update
    call(*gather)
    call(*given, stolen=stolen)
    for a, b in zip(gather[:11], given[:11]):
        assert torch.equal(a, b)
    assert bool((gather[0][:, ::3, d] == 0).any())  # the steal ran


def test_entry_matches_jax():
    jfn, jargs = graft.entry()
    want = jfn(*jargs)
    fn, args = entry.entry(device="cpu")
    got = fn(*args)
    again = fn(*args)  # fn leaves its inputs as they were
    assert got[0] == int(want[0]) == again[0]
    for g, a, w in zip(got[1:], again[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, a)


def test_dryrun_multichip_on_4_ranks():
    entry.dryrun_multichip(4, device="cpu")


def test_cli_on_two_ranks_writes_one_csv(world2, tmp_path, monkeypatch):
    ranks, root, argv = world2
    assert [r["cli"] for r in ranks] == [0, 0]
    assert sorted(os.listdir(root / "ranks" / "output")) == [
        "img0.png", "img1.png", "img2.png", "voronoi_8.csv"]
    monkeypatch.chdir(tmp_path)
    assert cli.main(argv) == 0
    assert ((root / "ranks" / "output" / "voronoi_8.csv").read_bytes()
            == (tmp_path / "output" / "voronoi_8.csv").read_bytes())


def test_cuda_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="is_available"):
        entry.entry()
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.make_mesh(1)
    with pytest.raises(RuntimeError, match="is_available"):
        entry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="is_available"):
        launch.run(1, jobs.world, ([],))
