"""Card-only checks of the PyTorch port: K1 (packed and unpacked paths, both
statistics branches), D3 (alone and in K1's last blocks, the loop's one
launch an iteration), K1's pruned instance (the bound filter in front of its
scan) over many steps of midtex voronoi loops and through `_drive`, K2 and
K3 (both schedules each), D1 (both schedules) and D2 (with and without its
root table) on the card against their plain versions, and the k-means engine
and codecs, the gated Hilbert codecs and the gated Huffman codecs on the
card against the CPU path; cluster-colors' colour histograms on the card
against the host C histogram and its card stages' streams against the CPU
path's, over the 8 midtex images, and one image's gated encode (the batch
stages' D1 route) against its ungated and CPU streams. D3 given the steal
candidates, and the point-sharded k-means on a world of one rank under
NCCL. The bench's two
k-means cells at full size against their pins. The sweep's device queue
(cluster-colors(16..256), voronoi(64..2048)) over `mid_0000` against the
committed `output_midtex` rows. D2 on mutated Huffman streams (the fuzz
campaign's blobs) against its plain version.

Every case is marked `cuda` and decides inside its fixture whether there is a
card, skipping with a reason when there is none. The file imports neither
jax nor `cniic_tpu`, so on a machine with a card and no jax it runs alone:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from cniic_tpu_torch import huffman, native, synth_corpus
from cniic_tpu_torch.codecs import from_spec
from cniic_tpu_torch.experiments import fuzz_campaign
from cniic_tpu_torch.ops import approx_rle as trle
from cniic_tpu_torch.ops import bitpack, hufdec
from cniic_tpu_torch.ops import kmeans as tkm
from cniic_tpu_torch.ops import kmeans_kernel as tkk
from torch_rle_cases import TIE, fma_batch, make_batch, seam_batch, tie_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _operands(seed, B, d, n, k, maxv, ties=False, frozen=False):
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, maxv, (B, d, n)).astype(np.int32)
    cents = rng.integers(0, maxv, (B, k, d)).astype(np.int32)
    if ties:
        pts[:, :, n // 2:] = pts[:, :, : n - n // 2]
        cents[:, k // 2:] = cents[:, : k - k // 2]
    ns = np.array([n - 7 * b for b in range(B)], np.int32)
    w = rng.integers(1, 200, (B, n)).astype(np.int32)
    cur = rng.integers(0, k, (B, n)).astype(np.int32)
    for b in range(B):
        w[b, ns[b]:] = 0
        cur[b, ns[b]:] = 0
    act = np.ones(B, np.int32)
    if frozen:
        act[-1] = 0
    return [torch.from_numpy(a) for a in (pts, w, cur, cents, ns, act)]


@pytest.mark.parametrize("B,d,n,k,maxv,ties,frozen", [
    (3, 3, 5000, 32, 256, False, False),    # cluster-colors-like
    (2, 5, 70000, 128, 1024, True, False),  # voronoi-like, with ties
    (3, 5, 4000, 16, 64, True, True),       # a frozen lane
    (2, 5, 8192, 2048, 1024, False, False),  # large k: global statistics
])
def test_kernel_matches_plain_version(cuda, B, d, n, k, maxv, ties, frozen):
    ops = _operands(1, B, d, n, k, maxv, ties, frozen)
    want = tkk.assign_stats_ref(*ops)
    before = tkk.assign_stats.launches
    got = tkk.assign_stats(*[t.to(cuda) for t in ops], pmax=[maxv - 1] * d)
    torch.cuda.synchronize()
    assert tkk.assign_stats.launches == before + 1
    for g, w_ in zip(got, want):
        assert g.is_cuda
        assert torch.equal(g.cpu(), w_)


def test_kernel_threads_share_an_instance_at_two_sizes(cuda):
    """Two host threads launch one K1 instance (d = 5, packed, global
    statistics) at k = 2048 and k = 4096 in turns: the instance's
    shared-memory opt-in must never fall below what a launch in flight on
    the other thread asked for."""
    import threading

    cases = []
    for k in (2048, 4096):
        ops = _operands(k, 1, 5, 6000, k, 256)
        assert tkk.packed_path([255] * 5, k) and not tkk.stats_in_smem(5, k)
        cases.append(([t.to(cuda) for t in ops], tkk.assign_stats_ref(*ops)))
    errors = []

    def worker(ops, want):
        try:
            for _ in range(50):
                got = tkk.assign_stats(*ops, pmax=[255] * 5)
                for g, w_ in zip(got, want):
                    assert torch.equal(g.cpu(), w_)
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=c) for c in cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []


@pytest.mark.parametrize("d,pmax,k", [
    (5, [3839, 2159, 255, 255, 255], 128),  # 3840x2160 voronoi bound
    (2, [16383, 16383], 8),                 # d = 2 at the coordinate cap
])
def test_kernel_unpacked_path_matches_plain_version(cuda, d, pmax, k):
    assert not tkk.packed_path(pmax, k)
    rng = np.random.default_rng(d)
    B, n = 2, 30_000
    pts = np.stack([rng.integers(0, m + 1, (B, n)) for m in pmax],
                   axis=1).astype(np.int32)
    pts[:, :, n // 2:] = pts[:, :, : n - n // 2]       # duplicated points
    cents = pts[:, :, rng.integers(0, n, k)].transpose(0, 2, 1).copy()
    cents[:, k // 2:] = cents[:, : k - k // 2]         # duplicated centroids
    pts[:, :, :k] = cents.transpose(0, 2, 1)           # points on centroids
    ops = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        pts, rng.integers(1, 9, (B, n)).astype(np.int32),
        rng.integers(0, k, (B, n)).astype(np.int32), cents,
        np.full(B, n, np.int32), np.ones(B, np.int32))]
    want = tkk.assign_stats_ref(*ops)
    got = tkk.assign_stats(*[t.to(cuda) for t in ops], pmax=pmax)
    for g, w_ in zip(got, want):
        assert torch.equal(g.cpu(), w_)


def _voronoi_operands(k):
    """Real voronoi points (smooth fields, flat patches: neighbouring pixels
    share clusters, flat patches tie exactly) at the init state and after
    one plain step."""
    rng = np.random.default_rng(4)
    h, w = 192, 256
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx + yy) % 256, (2 * xx) % 256, (3 * yy) % 256], -1)
    img[40:100, 30:150] = [90, 200, 10]
    img[120:, 180:] = rng.integers(0, 256, 3)
    imgs = torch.from_numpy(np.stack([img, img[::-1]]).astype(np.uint8))
    ptsT, wt = tkm._voronoi_setup(imgs)
    cur, cents = tkm._init_state(ptsT, [h * w] * 2, k)
    ns = torch.full((2,), h * w, dtype=torch.int32)
    act = torch.ones(2, dtype=torch.int32)
    return [ptsT, wt, cur, cents, ns, act], [w - 1, h - 1, 255, 255, 255]


@pytest.mark.parametrize("k", [128, 16])
def test_kernel_on_voronoi_points_matches_plain_version(cuda, k):
    ops, pmax = _voronoi_operands(k)
    assert tkk.packed_path(pmax, k)
    for step in range(3):
        want = tkk.assign_stats_ref(*ops)
        got = tkk.assign_stats(*[t.to(cuda) for t in ops], pmax=pmax)
        for g, w_ in zip(got, want):
            assert torch.equal(g.cpu(), w_), step
        # the next step from the plain version's state, means included
        sums, mv = want[1].clone(), want[2].clone()
        B = ops[0].shape[0]
        it = torch.full((B,), step, dtype=torch.int64)
        tkk.step_update_ref(sums, mv, ops[0], ops[4], ops[3],
                            torch.zeros(B, dtype=torch.int64),
                            torch.full((B,), 10**9, dtype=torch.int64),
                            torch.zeros(B, dtype=torch.int64), ops[5], it,
                            torch.zeros(B, dtype=torch.int64), 64, 100)
        ops[2] = want[0]


def _d3_operands(seed, B=5, d=5, k=64, n_max=3000):
    rng = np.random.default_rng(seed)
    ptsT = rng.integers(0, 1024, (B, d, n_max)).astype(np.int32)
    n = np.array([n_max - 11 * b for b in range(B)], np.int32)
    wsum = rng.integers(1, 500, (B, k))
    wsum[rng.random((B, k)) < 0.2] = 0                   # empty clusters
    sums = np.concatenate([rng.integers(0, 1024, (B, k, d)) * wsum[:, :, None]
                           + rng.integers(0, 500, (B, k, d)),
                           wsum[:, :, None]], axis=2).astype(np.int64)
    sums[wsum == 0] = 0
    act = np.ones(B, np.int32)
    act[1] = 0                                           # a frozen lane
    moved = rng.integers(0, 3000, B).astype(np.int64)
    moved[1] = 0
    best = moved + rng.integers(0, 40, B)
    stall = np.array([0, 0, 63, 5, 1], np.int64)[:B]     # lane 2 plateaus
    return [torch.from_numpy(a) for a in (
        sums, rng.integers(0, 3000, B).astype(np.int32), ptsT, n,
        rng.integers(0, 1024, (B, k, d)).astype(np.int32), moved, best, stall,
        act, np.full(B, 2**31 + 7, np.int64),
        np.full(B, 2, np.int64))]


@pytest.mark.parametrize("max_iters", [2**40, 2**31 + 8])
def test_d3_matches_plain_version(cuda, max_iters):
    """D3 on lanes with empty clusters (steal at a large iteration), a
    frozen lane, a plateauing lane, and max_iters binding or not; then a
    second step with nothing active changes nothing."""
    ops = _d3_operands(9)
    want = [t.clone() for t in ops]
    got = [t.to(cuda) for t in ops]
    for _ in range(2):
        tkk.step_update_ref(*want, 64, max_iters)
        before = tkk.step_update.launches
        tkk.step_update(*got, 64, max_iters)
        torch.cuda.synchronize()
        assert tkk.step_update.launches == before + 1
        for g, w_ in zip(got, want):
            assert torch.equal(g.cpu(), w_)
    assert int(want[9].max()) == (2**31 + 8 if max_iters == 2**31 + 8
                                  else 2**31 + 9)
    assert int(want[9][1]) == 2**31 + 7   # the frozen lane stopped counting


def test_d3_given_candidates_matches_plain_version(cuda):
    """D3 in the mode the point-sharded k-means runs: the empty clusters
    take the candidates given (here unrelated to ptsT), not a gather."""
    ops = _d3_operands(9)
    B, k, d = ops[4].shape
    stolen = torch.from_numpy(np.random.default_rng(3).integers(
        0, 1024, (B, k, d)).astype(np.int32))
    want = [t.clone() for t in ops]
    got = [t.to(cuda) for t in ops]
    for _ in range(2):
        tkk.step_update_ref(*want, 64, 2**40, stolen=stolen)
        before = tkk.step_update.launches
        tkk.step_update(*got, 64, 2**40, stolen=stolen.to(cuda))
        torch.cuda.synchronize()
        assert tkk.step_update.launches == before + 1
        for g, w_ in zip(got, want):
            assert torch.equal(g.cpu(), w_)
    empty = ops[0][:, :, d] == 0
    assert bool(empty.any())
    assert torch.equal(want[4][empty & (ops[8] != 0)[:, None]],
                       stolen[empty & (ops[8] != 0)[:, None]])


def test_sharded_kmeans_on_one_nccl_rank(cuda):
    """`sharded_kmeans` on a world of one under NCCL (K1 over the shard, the
    all-reduce, D3 given the candidates) equals `kmeans` on the card, at a
    shape with empty clusters."""
    import torch.distributed as dist

    from cniic_tpu_torch.parallel import mesh

    rng = np.random.default_rng(263)
    few = rng.integers(0, 4, (20_000, 2))
    w = rng.integers(1, 50, 20_000)
    voro = rng.integers(0, 1024, (300_000, 5))
    group = mesh.make_mesh(1, device="cuda")
    try:
        for pts, k, wts in ((few, 16, w), (voro, 128, None)):
            want = tkm.kmeans(pts, k, weights=wts, device="cuda")
            before = (tkk.assign_stats.launches, tkk.step_update.launches)
            got = mesh.sharded_kmeans(group, pts, k, weights=wts, block=256,
                                      device="cuda")
            assert got[2] == want[2]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])
            assert tkk.assign_stats.launches - before[0] >= got[2]
            assert tkk.step_update.launches - before[1] >= got[2]
    finally:
        dist.destroy_process_group()


def test_bench_kmeans_cells_match_the_pins(cuda):
    """The first image of the bench's cluster-colors_32 and voronoi_128
    cells at 1024^2, encoded and decoded on the card, prints the pinned
    (ratio, MSE)."""
    from test_torch_bench import FULL_SIZE, KMEANS_CELLS

    from cniic_tpu_torch import bench
    from cniic_tpu_torch.runner import compute_error

    rng = np.random.default_rng(bench.SEED)
    seen = {}
    for spec, side, n_imgs in bench.SUITE:
        imgs = [bench.synth_image(rng, side, side) for _ in range(n_imgs)]
        codec = from_spec(spec, device="cuda")
        if codec.name in KMEANS_CELLS:
            blob = codec.encode_batch(imgs)[0]
            err = compute_error(imgs[0], codec.decode(blob))
            seen[codec.name] = (f"{len(blob) / (side * side * 24) * 100:.3f}",
                                f"{err:.1f}")
        if len(seen) == len(KMEANS_CELLS):
            break
    assert seen == {name: FULL_SIZE[name] for name in KMEANS_CELLS}


def _fused_state(ops, dev, thresh=0):
    """D3's per-lane operands at the start of a loop over K1's `ops`."""
    ptsT, _, _, cents, n, _ = ops
    B, d, _ = ptsT.shape
    k = cents.shape[1]
    i64 = dict(dtype=torch.int64, device=dev)
    n64 = n.to(dev).to(torch.int64)
    return [torch.zeros((B, k, d + 1), **i64),
            torch.zeros(B, dtype=torch.int32, device=dev), n64 + 1, n64 + 1,
            torch.zeros(B, **i64), torch.zeros(B, **i64),
            torch.full((B,), thresh, **i64)]


@pytest.mark.parametrize("B,d,n,k,maxv,pmax,steps", [
    (8, 3, 46_000, 32, 256, None, 200),    # packed, shared-memory statistics
    (4, 5, 262_144, 128, 1024, None, 40),  # voronoi-like: many blocks a lane
    (2, 5, 8192, 2048, 1024, None, 200),   # packed, global statistics
    (2, 5, 30_000, 128, 256, [3839, 2159, 255, 255, 255], 200),  # unpacked
    (2, 2, 20_000, 4096, 16384, [16383, 16383], 100),  # unpacked, global
])
def test_fused_step_matches_plain_versions(cuda, B, d, n, k, maxv, pmax,
                                           steps):
    """The loop's one launch an iteration (K1, D3 in each lane's last
    block) against K1's then D3's plain versions on the card, every tensor
    after every step, over many steps: a missing fence between the blocks'
    statistics and the last block's means would show as a wrong centroid.
    One K1 launch a step, none of D3's own."""
    ops = [t.to(cuda) for t in _operands(3, B, d, n, k, maxv, ties=True)]
    if pmax is None:
        pmax = [maxv - 1] * d
    else:
        assert not tkk.packed_path(pmax, k)
    ptsT, w, cur, cents, ns, act = ops
    state = _fused_state(ops, cuda, thresh=-1)   # no lane freezes
    want = [t.clone() for t in (cur, cents, act, *state)]
    step = tkk.prepare_step(*ops, pmax, *state, 1 << 40, 1 << 40)
    before = (tkk.assign_stats.launches, tkk.step_update.launches)
    valid = torch.arange(n, device=cuda)[None, :] < ns[:, None]
    for i in range(steps):
        step()
        w_cur, w_cents, w_act, _, _, *rest = want
        new, sums, mk = tkk.assign_stats_ref(ptsT, w, w_cur, w_cents, ns,
                                             w_act)
        w_cur.copy_(torch.where(valid, new, w_cur))
        tkk.step_update_ref(sums, mk, ptsT, ns, w_cents, *rest[:3], w_act,
                            *rest[3:], 1 << 40, 1 << 40)
        for g, w_ in zip([cur, cents, act, *state[2:6]],
                         [w_cur, w_cents, w_act, *rest[:4]]):
            assert torch.equal(g, w_), i
        assert not state[0].any() and not state[1].any(), i
    assert (tkk.assign_stats.launches, tkk.step_update.launches) == (
        before[0] + steps, before[1])
    assert state[5].tolist() == [steps] * B


def _midtex_operands(k, rows, lanes, dev, seed=7):
    """K1's operands at the init state of a voronoi(k) loop over `lanes`
    bands of `rows` rows of midtex images (2040 wide: the unpacked path
    from k = 512 up)."""
    rng = np.random.default_rng(seed)
    imgs = [synth_corpus.synth_textured(rng, 1356, 2040, brightness=0.80)
            for _ in range(lanes)]
    ptsT, w = tkm._voronoi_setup(torch.from_numpy(
        np.stack([im[:rows] for im in imgs])).to(dev))
    B, _, n = ptsT.shape
    cur, cents = tkm._init_state(ptsT, [n] * B, k)
    ns = torch.full((B,), n, dtype=torch.int32, device=dev)
    act = torch.ones(B, dtype=torch.int32, device=dev)
    return [ptsT, w, cur, cents, ns, act], [2039, rows - 1, 255, 255, 255]


def _pruned_against_plain(ops, pmax, state, steps, dev):
    """`steps` iterations of the pruned instance against K1's then D3's
    plain versions, every tensor after every step; returns the scanned
    share of each step (points scanned over points of the active lanes)."""
    ptsT, w, cur, cents, ns, act = ops
    n = ptsT.shape[2]
    bounds = tkk.prune_state(cents, n)
    want = [t.clone() for t in (cur, cents, act, *state)]
    step = tkk.prepare_step(*ops, pmax, *state, 64, 1 << 40, bounds=bounds)
    assert step.pruned
    valid = torch.arange(n, device=dev)[None, :] < ns[:, None]
    before = (tkk.assign_stats.launches, tkk.assign_stats.pruned_launches,
              tkk.step_update.launches)
    shares = []
    for i in range(steps):
        live = int(torch.where(act != 0, ns, 0).sum())
        scanned = tkk.scanned_points()
        step()
        shares.append((tkk.scanned_points() - scanned) / max(live, 1))
        w_cur, w_cents, w_act, _, _, *rest = want
        new, sums, mk = tkk.assign_stats_ref(ptsT, w, w_cur, w_cents, ns,
                                             w_act)
        keep = valid & (w_act != 0)[:, None]
        w_cur.copy_(torch.where(keep, new, w_cur))
        tkk.step_update_ref(sums, mk, ptsT, ns, w_cents, *rest[:3], w_act,
                            *rest[3:], 64, 1 << 40)
        for g, w_ in zip([cur, cents, act, *state[2:6]],
                         [w_cur, w_cents, w_act, *rest[:4]]):
            assert torch.equal(g, w_), i
        assert not state[0].any() and not state[1].any(), i
    assert (tkk.assign_stats.launches - before[0],
            tkk.assign_stats.pruned_launches - before[1],
            tkk.step_update.launches - before[2]) == (steps, steps, 0)
    return shares


@pytest.mark.parametrize("k,rows,steps", [
    (1024, 340, 200),   # global statistics
    (2048, 340, 200),   # global statistics
    (512, 340, 200),    # shared-memory statistics
])
def test_pruned_step_matches_plain_versions(cuda, k, rows, steps):
    """K1's pruned instance (the bound filter in front of the scan), one
    launch an iteration with D3 and the snapshots in each lane's last
    block, against K1's then D3's plain versions over many steps of a
    voronoi loop on midtex points: the filter skips most scans and changes
    nothing."""
    ops, pmax = _midtex_operands(k, rows, 2, cuda)
    assert tkk.pruned_path(5, k, pmax)
    state = _fused_state(ops, cuda, thresh=-1)   # no lane freezes
    shares = _pruned_against_plain(ops, pmax, state, steps, cuda)
    assert shares[0] > 0.9 and min(shares[steps // 2:]) < 0.5


def test_pruned_step_through_steals_and_a_lane_that_freezes(cuda):
    """Every fifth centroid starts equal to the one before it, which wins
    every tie: those clusters go empty and the steal moves their centroids
    far (the snapshots' displacement jumps); lane 1 freezes early on its
    own threshold, lane 0 runs on."""
    ops, pmax = _midtex_operands(1024, 200, 2, cuda, seed=9)
    ptsT, w, cur, cents, ns, act = ops
    cents[:, 1::5] = cents[:, 0:-1:5][:, : cents[:, 1::5].shape[1]]
    cur.copy_(torch.where(cur % 5 == 1, cur - 1, cur))
    state = _fused_state(ops, cuda, thresh=-1)
    state[6][1] = int(ns[1]) // 64
    empty = torch.bincount(cur[0].to(torch.int64), minlength=1024) == 0
    assert int(empty.sum()) > 100
    _pruned_against_plain(ops, pmax, state, 120, cuda)
    it = state[5].tolist()
    assert act.tolist() == [1, 0] and 0 < it[1] < it[0] == 120


def test_drive_pruned_on_a_midtex_image_matches_unpruned(cuda, monkeypatch):
    """`_drive` on the first midtex image at k = 2048 with the pruned
    instance (picked by its shape) and with the unpruned kernel: the same
    (iters, cur, cents)."""
    ops, pmax = _midtex_operands(2048, 1356, 1, cuda)
    ptsT, w, cur0, cents0, ns, _ = ops
    runs = []
    for pruned in (True, False):
        if not pruned:
            monkeypatch.setattr(tkm, "pruned_path", lambda *args: False)
        before = tkk.assign_stats.pruned_launches
        runs.append(tkm._drive(ptsT, w, cur0.clone(), cents0.clone(),
                               ns.tolist(), 2048, pmax, 10_000))
        assert (tkk.assign_stats.pruned_launches > before) is pruned
    assert runs[0][0] == runs[1][0] > 100
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])


def test_fused_step_freezes_lanes_like_two_launches(cuda):
    """Lanes of unequal size that freeze at different iterations, a binding
    max_iters, and launches after the end: one launch an iteration against
    K1 then D3 as launches of their own, tensor for tensor."""
    rng = np.random.default_rng(8)
    sizes = (60, 30_000, 9000)
    pts, w, ns = tkm.pad_lanes([rng.integers(0, 256, (m, 3)) for m in sizes],
                               [None, rng.integers(1, 30, 30_000), None])
    for max_iters in (10_000, 5):
        runs = []
        for fused in (True, False):
            ptsT = torch.from_numpy(pts).to(cuda)
            cur, cents = tkm._init_state(ptsT, ns, 16)
            n32 = torch.tensor(ns, dtype=torch.int32, device=cuda)
            act = torch.ones(3, dtype=torch.int32, device=cuda)
            ops = [ptsT, torch.from_numpy(w).to(cuda), cur, cents, n32, act]
            state = _fused_state(ops, cuda)
            state[6] = torch.tensor([tkm._stop_threshold(m) for m in ns],
                                    dtype=torch.int64, device=cuda)
            step = tkk.prepare_step(*ops, [255] * 3, *state, 64, max_iters,
                                    fused=fused)
            before = (tkk.assign_stats.launches, tkk.step_update.launches)
            trace = []
            for _ in range(48):
                step()
                trace.append((state[5].tolist(), act.tolist()))
            assert (tkk.assign_stats.launches - before[0],
                    tkk.step_update.launches - before[1]) == (
                48, 0 if fused else 48)
            runs.append((trace, cur.cpu(), cents.cpu(),
                         [t.cpu() for t in state]))
        assert runs[0][0] == runs[1][0]
        assert torch.equal(runs[0][1], runs[1][1])
        assert torch.equal(runs[0][2], runs[1][2])
        for a, b in zip(runs[0][3], runs[1][3]):
            assert torch.equal(a, b)
        counts = runs[0][0][-1][0]
        assert not any(runs[0][0][-1][1])          # every lane froze
        if max_iters == 5:
            assert counts == [5, 5, 5] or counts[0] < 5
        else:
            assert len(set(counts)) > 1            # at different iterations


def test_engine_loop_matches_cpu(cuda, monkeypatch):
    """`_drive` on the card against the CPU, through a steal, a plateau and
    a binding max_iters, at two check cadences; voronoi too."""
    monkeypatch.setattr(tkm, "_STALL_LIMIT", 2)
    rng = np.random.default_rng(263)
    steal = rng.integers(0, 4, (780, 2))
    pts = [steal, steal[:500], rng.integers(0, 256, (600, 2))]
    for every in (1, 8):
        monkeypatch.setattr(tkm, "_CHECK_EVERY", every)
        for max_iters in (10_000, 3):
            a = tkm.kmeans_batch(pts, 16, max_iters=max_iters,
                                 on_error="collect", device="cuda")
            b = tkm.kmeans_batch(pts, 16, max_iters=max_iters,
                                 on_error="collect", device="cpu")
            for x, y in zip(a, b):
                assert type(x) is type(y)
                if isinstance(x, tuple):
                    np.testing.assert_array_equal(x[0], y[0])
                    np.testing.assert_array_equal(x[1], y[1])
                    assert x[2] == y[2]
    imgs = rng.integers(0, 256, (3, 40, 56, 3)).astype(np.uint8)
    imgs[1, :20] = 40
    for x, y in zip(tkm.voronoi_centroids_batch(imgs, 32, device="cuda"),
                    tkm.voronoi_centroids_batch(imgs, 32, device="cpu")):
        np.testing.assert_array_equal(x, y)


def test_kernel_wrapper_refuses_before_launch(cuda):
    ops = [t.to(cuda) for t in _operands(2, 2, 3, 100, 4, 256)]
    before = tkk.assign_stats.launches
    with pytest.raises(ValueError):
        tkk.assign_stats(*ops, pmax=[46341, 0, 0])
    ops[1] = ops[1].cpu()
    with pytest.raises(ValueError):
        tkk.assign_stats(*ops, pmax=[255] * 3)
    assert tkk.assign_stats.launches == before


def test_engine_and_codecs_match_cpu(cuda):
    rng = np.random.default_rng(7)
    pts = [rng.integers(0, 256, (n, 3)) for n in (900, 400)]
    ws = [rng.integers(1, 50, 900), None]
    a = tkm.kmeans_batch(pts, 12, weights_list=ws, device="cuda")
    b = tkm.kmeans_batch(pts, 12, weights_list=ws, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
        assert x[2] == y[2]
    imgs = [rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
            for _ in range(2)]
    imgs[1][:24] = imgs[1][:24] // 32 * 32
    for spec in ("cluster-colors(16)", "voronoi(32)"):
        on_card = from_spec(spec, device="cuda")
        streams = on_card.encode_batch(imgs)
        assert streams == from_spec(spec, device="cpu").encode_batch(imgs)
        for im, s in zip(imgs, streams):
            np.testing.assert_array_equal(
                on_card.decode(s), from_spec(spec, device="cpu").decode(s))


def test_voronoi128_4k_encode_hashes_to_the_fixture(cuda):
    """The seed-42 3840x2160 image through voronoi(128) on the card (the
    unpacked K1 path over 8.3M points a lane, D3 in its last blocks) gives
    the committed stream `tests/fixtures/voronoi128_synth4k.bin`, and the
    card's decode of it the pinned MSE."""
    import hashlib
    import test_torch_golden_4k as golden

    img = golden.synth_natural(np.random.default_rng(42), 2160, 3840)
    assert hashlib.sha256(img.tobytes()).hexdigest() == golden._IMG_SHA
    codec = from_spec("voronoi(128)", device="cuda")
    data = codec.encode(img)
    with open(golden._FIX, "rb") as fh:
        assert data == fh.read()
    assert hashlib.sha256(data).hexdigest() == golden._STREAM_SHA
    assert golden._mse(img, codec.decode(data)) == pytest.approx(
        golden._MSE, abs=1e-4)


def _rle_operands(scans, lens):
    return trle._position_major(scans, lens, torch.device("cpu"))


@pytest.mark.parametrize("allow", [0, 1, 2, 4, 16, 64])
def test_k2_matches_plain_version(cuda, allow):
    rng = np.random.default_rng(allow)
    scans, lens = make_batch(rng)
    scans = np.concatenate([scans, np.full((1, 3000, 3), 9, np.uint8)])
    scans[1, 500:504] = TIE  # a boundary tie at allow 2
    lens = np.concatenate([lens, [2804]])
    rgb, ln = _rle_operands(scans, lens)
    want = trle.approx_rle_wide_ref(rgb, ln, allow)
    before = trle.wide_records.launches
    got = trle.wide_records(rgb.to(cuda), ln.to(cuda), allow)
    torch.cuda.synchronize()
    assert trle.wide_records.launches == before + 1
    for g, w_ in zip(got, want):
        assert g.is_cuda
        assert torch.equal(g.cpu(), w_)
    if allow == 2:
        assert int(want[1][1]) == 1


@pytest.mark.parametrize("allow", [1.0, 2.5, 4.0, 16.0, 32.0, 64.0])
def test_k3_matches_plain_version(cuda, allow):
    scans, lens = make_batch(np.random.default_rng(int(allow)))
    if allow in (32.0, 64.0):
        scans, lens, _ = fma_batch(int(allow), np.random.default_rng(1))
    rgb, ln = _rle_operands(scans, lens)
    want = trle.approx_rle_batch_ref(rgb, ln, allow)
    before = trle.batch_records.launches
    got = trle.batch_records(rgb.to(cuda), ln.to(cuda), allow)
    torch.cuda.synchronize()
    assert trle.batch_records.launches == before + 1
    assert got.is_cuda and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("chunk", [1, 2, 7, 64, 255, 256, 1024])
def test_k3_chunk_schedule_matches_plain_version(cuda, chunk):
    """The three-pass schedule against the plain version and against the
    one-walker schedule (chunk >= L) on the card: the suite's batch, the
    f32-rounding streams and the seam streams (a flat stream that never
    syncs, an edge, a cap close at a seam, short and seam-length
    streams)."""
    cases = [(make_batch(np.random.default_rng(3)), 4.0),
             (fma_batch(64, np.random.default_rng(1))[:2], 64.0),
             (seam_batch(chunk, np.random.default_rng(9)), 2.0),
             (seam_batch(chunk, np.random.default_rng(10)), 16.0)]
    for (scans, lens), allow in cases:
        rgb, ln = _rle_operands(scans, lens)
        want = trle.approx_rle_batch_ref(rgb, ln, allow)
        before = (trle.batch_records.launches,
                  trle.batch_records.kernel_launches)
        got = trle.batch_records(rgb.to(cuda), ln.to(cuda), allow,
                                 chunk=chunk)
        one = trle.batch_records(rgb.to(cuda), ln.to(cuda), allow,
                                 chunk=rgb.shape[0])
        torch.cuda.synchronize()
        chunked = chunk < rgb.shape[0]
        assert (trle.batch_records.launches,
                trle.batch_records.kernel_launches) == (
            before[0] + 2, before[1] + (3 if chunked else 1) + 1)
        assert torch.equal(got.cpu(), want), (allow, chunk)
        assert torch.equal(one.cpu(), want), (allow, chunk)
    # the schedule's statistics equal the CPU model's
    rgb, ln = _rle_operands(*seam_batch(chunk, np.random.default_rng(9)))
    on_card = trle.batch_records_stats(rgb.to(cuda), ln.to(cuda), 2.0, chunk)
    on_cpu = trle.batch_records_stats(rgb, ln, 2.0, chunk)
    assert torch.equal(on_card[0].cpu(), on_cpu[0])
    assert on_card[1:] == on_cpu[1:]


def _walks(rng, S, L):
    """S random-walk streams of L pixels, [S, L, 3] uint8."""
    return np.clip(rng.integers(0, 256, (S, 1, 3))
                   + rng.integers(-3, 4, (S, L, 3)).cumsum(1), 0,
                   255).astype(np.uint8)


def _edge_batch(chunk, rng):
    """Walks ending at K2's chunk edges: lengths kC - 1, kC and kC + 1 for
    k = 1, 2, 3, and 0."""
    lens = np.array([k * chunk + d for k in (1, 2, 3) for d in (-1, 0, 1)]
                    + [0])
    return _walks(rng, len(lens), int(lens.max()) + 5), lens


def _k2_both_schedules(rgb, ln, allow, chunk, cuda):
    """K2's chunk schedule and one walker on the card, each equal to the
    plain version in rows and flags, with the launch counts; returns the
    plain version's (recs, flags)."""
    want = trle.approx_rle_wide_ref(rgb, ln, allow)
    before = (trle.wide_records.launches, trle.wide_records.kernel_launches)
    got = trle.wide_records(rgb.to(cuda), ln.to(cuda), allow, chunk=chunk)
    one = trle.wide_records(rgb.to(cuda), ln.to(cuda), allow,
                            chunk=rgb.shape[0])
    torch.cuda.synchronize()
    chunked = chunk < rgb.shape[0]
    assert (trle.wide_records.launches,
            trle.wide_records.kernel_launches) == (
        before[0] + 2, before[1] + (4 if chunked else 1) + 1)
    for g, o, w in zip(got, one, want):
        assert g.is_cuda
        assert torch.equal(g.cpu(), w), (allow, chunk)
        assert torch.equal(o.cpu(), w), (allow, chunk)
    return want


@pytest.mark.parametrize("chunk", [1, 2, 7, 32, 64, 1024])
def test_k2_chunk_schedule_matches_plain_version(cuda, chunk):
    """The four-pass schedule against the plain version and against the one
    walker (chunk >= L) on the card, rows and flags: the suite's batch, the
    seam streams (a flat stream that never syncs, an edge, a cap close at a
    seam), streams ending at the chunk edges, and the crafted ties: (i) met
    only by the true walk in a re-walked region flags, (ii) met only by a
    speculative walk does not. The schedule's statistics equal the CPU
    model's."""
    cases = [(make_batch(np.random.default_rng(3)), 4),
             (make_batch(np.random.default_rng(4)), 64),
             (seam_batch(chunk, np.random.default_rng(9)), 2),
             (seam_batch(chunk, np.random.default_rng(10)), 16),
             (_edge_batch(chunk, np.random.default_rng(11)), 4),
             (_edge_batch(chunk, np.random.default_rng(12)), 0)]
    for (scans, lens), allow in cases:
        _k2_both_schedules(*_rle_operands(scans, lens), allow, chunk, cuda)
    rgb, ln = _rle_operands(*tie_batch(np.random.default_rng(2)))
    _, flags = _k2_both_schedules(rgb, ln, 2, chunk, cuda)
    assert flags.tolist() == [1, 0, 1, 0]
    rgb, ln = _rle_operands(*seam_batch(chunk, np.random.default_rng(9)))
    on_card = trle.wide_records_stats(rgb.to(cuda), ln.to(cuda), 2, chunk)
    on_cpu = trle.wide_records_stats(rgb, ln, 2, chunk)
    assert torch.equal(on_card[0].cpu(), on_cpu[0])
    assert torch.equal(on_card[1].cpu(), on_cpu[1])
    assert on_card[2:] == on_cpu[2:]


@pytest.mark.parametrize("L", [1024, 2702])
def test_k2_chunk_schedule_at_full_width(cuda, L):
    """1024 streams of L pixels (the chunked route's shapes for a 1024^2
    and a 2040x1356 scan): walks with crafted ties (allow 2, flagged) and
    at allow 4, and 1024 flat streams, the worst case, whose seams never
    sync and whose every stream the settle pass walks."""
    rng = np.random.default_rng(L)
    scans = _walks(rng, 1024, L)
    for j in range(0, 1024, 37):
        p = int(rng.integers(0, L - 4))
        scans[j, p:p + 4] = TIE
    lens = np.full(1024, L)
    lens[-1] = L - 333
    rgb, ln = _rle_operands(scans, lens)
    _, flags = _k2_both_schedules(rgb, ln, 2, trle.WIDE_CHUNK, cuda)
    assert int(flags.sum()) > 0
    _k2_both_schedules(rgb, ln, 4, trle.WIDE_CHUNK, cuda)
    flat = np.broadcast_to(rng.integers(0, 256, (1024, 1, 3)),
                           (1024, L, 3)).astype(np.uint8)
    rgb, ln = _rle_operands(flat, lens)
    _k2_both_schedules(rgb, ln, 4, trle.WIDE_CHUNK, cuda)
    _, _, seams, unsynced, walked = trle.wide_records_stats(
        rgb.to(cuda), ln.to(cuda), 4)
    # only a seam whose chunk holds its stream's end syncs (past the end);
    # chunk 1's repair starts from the truth, so the settle pass walks every
    # chunk from the second on
    assert 0 < seams - 1024 <= unsynced <= seams
    assert walked >= int((ln.to(torch.int64) - 2 * trle.WIDE_CHUNK).sum())


def test_rle_wrappers_refuse_before_launch(cuda):
    rgb = torch.zeros((10, 3), dtype=torch.int32, device=cuda)
    lens = torch.full((3,), 10, dtype=torch.int32, device=cuda)
    before = (trle.wide_records.launches, trle.batch_records.launches)
    with pytest.raises(ValueError):
        trle.wide_records(rgb, lens, 65)
    with pytest.raises(ValueError):
        trle.batch_records(rgb, lens.cpu(), 4.0)
    assert (trle.wide_records.launches, trle.batch_records.launches) == before


@pytest.mark.parametrize("gate", ["CNIIC_CHUNKED_RLE", "CNIIC_PALLAS_RLE"])
def test_gated_hilbert_codecs_match_cpu(cuda, monkeypatch, gate):
    rng = np.random.default_rng(11)
    imgs = [np.clip(rng.integers(0, 60, 3) + rng.integers(
        -3, 4, (h, w, 3)).cumsum(1), 0, 255).astype(np.uint8)
        for h, w in ((64, 80), (48, 90), (40, 40))]
    monkeypatch.setenv(gate, "1")
    counter = (trle.wide_records if gate == "CNIIC_CHUNKED_RLE"
               else trle.batch_records)
    for allow in (4, 16):
        spec = f"hilbert(rle({allow}))"
        before = counter.launches
        on_card = from_spec(spec, device="cuda").encode_batch(imgs)
        assert counter.launches > before
        assert on_card == from_spec(spec, device="cpu").encode_batch(imgs)


def _books(rng, B, u_max, deep=False):
    """B ragged codebooks [B, u_pad] (hi, lo, lens as int32 tensors) and id
    streams [B, n] padded with a zero-length entry; one codebook reaches
    63-bit codes when `deep`."""
    us = [int(rng.integers(2, u_max)) for _ in range(B)]
    if deep:
        us[0] = 64
    u_pad = max(us) + 1
    n = 5000
    codes = np.zeros((B, u_pad), np.uint64)
    lens = np.zeros((B, u_pad), np.uint32)
    ids = np.zeros((B, n), np.int32)
    for b, u in enumerate(us):
        freqs = (2 ** np.arange(u, dtype=np.uint64) if deep and b == 0
                 else rng.integers(1, 1000, u).astype(np.uint64))
        book = huffman.build_codebook(freqs)
        codes[b, :u], lens[b, :u] = book.codes, book.lens
        m = n - 37 * b
        ids[b, :m] = rng.integers(0, u, m)
        ids[b, m:] = u
    if deep:
        assert lens.max() == 63
    hi = (codes >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = codes.astype(np.uint32).view(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (ids, hi, lo, lens.astype(np.int32))], codes, lens, us


@pytest.mark.parametrize("deep", [False, True])
def test_d1_matches_plain_version(cuda, deep):
    rng = np.random.default_rng(5)
    ops, codes, lens, us = _books(rng, 4, 300, deep)
    n_words = 2 * ops[0].shape[1] + 2
    want = bitpack.pack_words_ref(*ops, n_words)
    before = bitpack.pack_words.launches
    got = bitpack.pack_words(*[t.to(cuda) for t in ops], n_words)
    torch.cuda.synchronize()
    assert bitpack.pack_words.launches == before + 1
    assert got.is_cuda and torch.equal(got.cpu(), want)
    ids = ops[0].numpy()
    out = bitpack.pack_bits_batch(ids, codes, lens, device="cuda")
    for b, u in enumerate(us):
        assert out[b] == native.pack_bits(codes[b, :u], lens[b, :u],
                                          ids[b][ids[b] < u])


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("one_pass", [True, False])
def test_d1_schedules_on_tile_edges(cuda, B, one_pass):
    """Both schedules of D1 against the plain version and the C packer on
    streams a few tiles long: lengths on, below and above the tile's
    multiples (so rows start off a 16-byte boundary), 63-bit codes that
    straddle tile edges, zero-length padding across a tile edge and over a
    whole tile, an alphabet of more than 1024 entries (read through L2) and
    smaller ones (copied to shared memory), and an n_words that cuts the
    last tile."""
    T = bitpack.TILE
    assert bitpack.load_library().huf_pack_tile() == T
    rng = np.random.default_rng(B)
    for n, u, deep in ((3 * T, 300, False), (3 * T + 5, 64, True),
                       (2 * T - 1, 5000, False), (T + 1, 2, False),
                       (7, 40, False)):
        freqs = [(2 ** np.arange(u, dtype=np.uint64) if deep
                  else rng.integers(1, 5000, u).astype(np.uint64))
                 for _ in range(B)]
        books = [huffman.build_codebook(f) for f in freqs]
        codes = np.zeros((B, u + 1), np.uint64)
        lens = np.zeros((B, u + 1), np.uint32)
        ids = rng.integers(0, u, (B, n)).astype(np.int32)
        for b, book in enumerate(books):
            codes[b, :u], lens[b, :u] = book.codes, book.lens
        if n > T:
            ids[0, T - 3:T + 3] = u          # padding across a tile edge
        if n >= 3 * T:
            ids[B - 1, T:2 * T] = u          # a whole tile of padding
        ops = bitpack.operands(ids, codes, lens, torch.device("cpu"))
        totals = np.take_along_axis(lens, ids, 1).astype(np.int64).sum(1)
        full = int((totals.max() + 31) // 32)
        for n_words in (full + 3, full, max(full - 40, 1)):
            want = bitpack.pack_words_ref(*ops, n_words)
            before = bitpack.pack_words.launches
            got = bitpack.pack_words(*[t.to(cuda) for t in ops], n_words,
                                     one_pass=one_pass)
            torch.cuda.synchronize()
            assert bitpack.pack_words.launches == before + 1
            assert torch.equal(got.cpu(), want), (n, u, n_words)
        words = got.cpu().numpy()   # the cut one: a prefix of the bytes
        for b, book in enumerate(books):
            real = ids[b][ids[b] < u]
            packed = native.pack_bits(book.codes, book.lens, real)
            mine = bitpack._words_to_bytes(words[b].view(np.uint32),
                                           int(totals[b]))
            assert mine == packed[:len(mine)]


def test_d1_one_pass_at_full_size(cuda):
    """8 streams of 1M ids (512 tiles a stream, more tiles than the card
    holds at once, so the look-back crosses waves) against one thread a
    symbol, repeated."""
    rng = np.random.default_rng(4)
    u, n = 40_000, 1 << 20
    book = huffman.build_codebook(
        (rng.pareto(1.2, u) * 50 + 1).astype(np.uint64))
    ids = rng.integers(0, u, (8, n)).astype(np.int32)
    ops = [t.to(cuda) for t in bitpack.operands(
        ids, np.tile(book.codes, (8, 1)), np.tile(book.lens, (8, 1)),
        torch.device("cpu"))]
    n_words = int(book.lens.max()) * n // 32 + 1
    want = bitpack.pack_words(*ops, n_words, one_pass=False)
    for _ in range(20):
        assert torch.equal(bitpack.pack_words(*ops, n_words), want)
    assert native.pack_bits(book.codes, book.lens, ids[3]) == \
        bitpack.pack_bits_batch(ids, np.tile(book.codes, (8, 1)),
                                np.tile(book.lens, (8, 1)),
                                device="cuda")[3]


def _hufdec_stream(rng, freqs, n):
    ids = rng.integers(0, freqs.size, n)
    book = huffman.build_codebook(freqs)
    tree = huffman.serialize_tree(book, np.zeros((freqs.size, 1), np.uint8))
    payload = huffman.encode_payload(ids.astype(np.int32), book)
    left, right, symbol, _, _ = huffman.parse_tree(
        np.frombuffer(tree, np.uint8), 1)
    return payload, left, right, symbol, n


@pytest.mark.parametrize("u,n", [(300, 40_000), (2, 30_000), (4096, 60_000)])
def test_d2_matches_plain_version(cuda, u, n):
    rng = np.random.default_rng(u)
    freqs = rng.integers(1, 1000, u).astype(np.uint64)
    payload, left, right, symbol, n = _hufdec_stream(rng, freqs, n)
    pay = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    lr2 = torch.from_numpy(hufdec._lr2(left, right, symbol))
    L = 3 * hufdec.E
    starts = torch.arange(L, dtype=torch.int32) * 97
    ends = torch.clamp(starts + 4096, max=8 * len(payload))
    want = hufdec.walk_ref(pay, lr2, starts, ends, 8 * len(payload))
    before = hufdec.walk.launches
    got = hufdec.walk(pay.to(cuda), lr2.to(cuda), starts.to(cuda),
                      ends.to(cuda), 8 * len(payload))
    assert hufdec.walk.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert got[2] == want[2]
    host = native.huf_decode(payload, left, right, symbol, 0, n)
    before = (hufdec.walk.launches, hufdec.root_table.launches)
    dec = hufdec.decode_payload_device(payload, left, right, symbol, n,
                                       device="cuda")
    # both passes read one root table
    assert (hufdec.walk.launches, hufdec.root_table.launches) == (
        before[0] + 2, before[1] + 1)
    np.testing.assert_array_equal(dec, host)
    np.testing.assert_array_equal(
        hufdec.decode_payload_device(payload, left, right, symbol, n,
                                     device="cpu"), host)


@pytest.mark.parametrize("K", [0, 1, 5, 12, 14])
def test_d2_root_table_matches_plain_version(cuda, K):
    """Both passes at every table width against the plain version (the
    delta-like 2-symbol alphabet, a 4096-symbol one, budgets that cut
    codes) and the table itself against its plain version."""
    rng = np.random.default_rng(K)
    for u, n in ((2, 30_000), (4096, 60_000)):
        freqs = rng.integers(1, 1000, u).astype(np.uint64)
        payload, left, right, symbol, n = _hufdec_stream(rng, freqs, n)
        pay_np = np.frombuffer(payload, np.uint8)
        ops = hufdec.lanes(pay_np, left, right, symbol, torch.device("cpu"))
        pay, lr2, s1, e1, chunk, chunk_ends, total = ops
        card = [t.to(cuda) for t in (pay, lr2, s1, e1)]
        if K:
            assert torch.equal(hufdec.root_table(card[1], K).cpu(),
                               hufdec.root_table_ref(lr2, K))
        for n_steps in (13, hufdec._STEPS):
            want = hufdec.walk_ref(pay, lr2, s1, e1, total, n_steps=n_steps)
            before = (hufdec.walk.launches, hufdec.root_table.launches)
            got = hufdec.walk(*card, total, n_steps=n_steps, K=K)
            assert (hufdec.walk.launches, hufdec.root_table.launches) == (
                before[0] + 1, before[1] + (1 if K else 0))
            assert torch.equal(got[0].cpu(), want[0])
            assert torch.equal(got[1].cpu(), want[1])
            assert got[2] == want[2]
        offs, out_start = (torch.from_numpy(a) for a in
                           hufdec.compose(want[0], want[1], n))
        args = (pay, lr2, chunk + offs, chunk_ends, total)
        want2 = hufdec.walk_ref(*args, out_start=out_start, n_symbols=n)
        got2 = hufdec.walk(*[a.to(cuda) if torch.is_tensor(a) else a
                             for a in args], out_start=out_start.to(cuda),
                           n_symbols=n, K=K)
        assert torch.equal(got2[3].cpu(), want2[3])
        assert torch.equal(got2[1].cpu(), want2[1]) and got2[2] == want2[2]


def test_d2_deep_codes_decline_like_plain_version(cuda):
    rng = np.random.default_rng(3)
    freqs = (2.0 ** np.arange(40)).astype(np.uint64)
    stream = _hufdec_stream(rng, freqs, 30_000)
    on_card = hufdec.decode_payload_device(*stream, device="cuda")
    on_cpu = hufdec.decode_payload_device(*stream, device="cpu")
    assert (on_card is None) == (on_cpu is None)
    if on_card is not None:
        np.testing.assert_array_equal(on_card, on_cpu)


def test_huffman_wrappers_refuse_before_launch(cuda):
    ops = _books(np.random.default_rng(1), 2, 50)[0]
    ops = [t.to(cuda) for t in ops]
    before = (bitpack.pack_words.launches, hufdec.walk.launches)
    bad = ops[0].clone()
    bad[0, 0] = 10_000
    with pytest.raises(ValueError):
        bitpack.pack_words(bad, *ops[1:], 100)
    with pytest.raises(ValueError):
        bitpack.pack_words(ops[0], ops[1].cpu(), *ops[2:], 100)
    pay = torch.zeros(600, dtype=torch.uint8, device=cuda)
    lr2 = torch.tensor([-1, -2], dtype=torch.int32, device=cuda)
    st = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        hufdec.walk(pay, lr2, st, st, 8 * 600 + 1)
    with pytest.raises(TypeError):
        hufdec.walk(pay, lr2, st.long(), st, 8 * 600)
    assert (bitpack.pack_words.launches, hufdec.walk.launches) == before


@pytest.mark.parametrize("gate", ["CNIIC_DEVICE_BITPACK",
                                  "CNIIC_DEVICE_HUF_DECODE"])
def test_gated_huffman_codecs_match_cpu(cuda, monkeypatch, gate):
    rng = np.random.default_rng(13)
    imgs = [np.clip(rng.integers(0, 60, 3) + rng.integers(
        -3, 4, (h, w, 3)).cumsum(1), 0, 255).astype(np.uint8)
        for h, w in ((64, 80), (48, 90), (40, 40))]
    monkeypatch.setenv(gate, "1")
    counter = (bitpack.pack_words if gate == "CNIIC_DEVICE_BITPACK"
               else hufdec.walk)
    for spec in ("hufman", "delta", "cluster-colors(8)"):
        on_card = from_spec(spec, device="cuda")
        on_cpu = from_spec(spec, device="cpu")
        before = counter.launches
        streams = on_card.encode_batch(imgs)
        assert streams == on_cpu.encode_batch(imgs)
        for im, s in zip(imgs, streams):
            dec = on_card.decode(s)
            np.testing.assert_array_equal(dec, on_cpu.decode(s))
            if on_card.is_lossless:
                np.testing.assert_array_equal(dec, im)
        assert counter.launches > before, spec


@pytest.mark.parametrize("spec", fuzz_campaign.GATED)
def test_d2_kernel_on_mutated_streams_matches_plain_version(cuda, monkeypatch,
                                                            spec):
    """The mutated blobs of tests/test_torch_fuzz_decode.py's D2-gate case
    (and more of them) through `walk_kernel`: every outcome equals the
    plain version's on the CPU (raised, or equal pixels), and D2 launched
    and decoded."""
    on_card = from_spec(spec, device="cuda")
    on_cpu = from_spec(spec, device="cpu")
    blobs = fuzz_campaign.mutated_blobs(on_cpu, 2024, 64,
                                        fuzz_campaign.GATED_SHAPES)
    monkeypatch.setenv(fuzz_campaign.GATE, "1")
    launches, decodes = hufdec.walk.launches, hufdec.decodes
    for i, blob in enumerate(blobs):
        got, img = fuzz_campaign.outcome(on_card, blob)
        want, ref = fuzz_campaign.outcome(on_cpu, blob)
        assert got == want, f"blob {i}: {got} on the card, {want} on the CPU"
        if got == "ok":
            np.testing.assert_array_equal(img, ref, err_msg=f"blob {i}")
    assert hufdec.walk.launches > launches
    assert hufdec.decodes > decodes


def test_midtex_kmeans_rows_on_the_card(cuda, tmp_path):
    """`mid_0000` (remade by the port's generator) through the sweep's
    device queue on the card gives the committed `output_midtex` rows of
    cluster-colors(16..256) and voronoi(64..2048) exactly: K1's unpacked
    path from k = 512 and its global statistics from k = 1024, at the
    DIV2K shape."""
    import os

    from cniic_tpu_torch import sweep, synth_corpus

    ref = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "output_midtex")
    assert not synth_corpus.main([str(tmp_path / "m"), "1", "--midtex"])
    out = tmp_path / "out"
    before = tkk.assign_stats.launches
    assert sweep.main(["--device=cuda", "--batch=8", f"--out={out}",
                       f"--configs={','.join(sweep.DEVICE_CONFIGS)}",
                       str(tmp_path / "m" / "mid_0000.png")]) == 0
    assert tkk.assign_stats.launches > before
    names = [from_spec(c, device="cpu").name for c in sweep.DEVICE_CONFIGS]
    assert sweep.diff_rows(out, ref, names, images=["mid_0000.png"]) == []


@pytest.mark.parametrize("h,w", [(20, 50), (1356, 2040)])
def test_fused_mse_is_the_correctly_rounded_quotient(cuda, h, w):
    """The fused MSE on the card is the exact integer sum over h*w rounded
    once, as JAX's and the CPU's are: a multiply by the reciprocal of h*w
    (CUDA's division by a host scalar) is one bit off for many sums, 27 of
    the 72 voronoi rows of the midtex matrix."""
    from cniic_tpu_torch.parallel import mesh

    rng = np.random.default_rng(21)
    b = 512 if h * w < 10_000 else 4
    x = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    y = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    got = mesh.sharded_mse(None, torch.from_numpy(x).to(cuda),
                           torch.from_numpy(y).to(cuda)).cpu().tolist()
    tot = [int(((a.astype(np.int64) - c) ** 2).sum()) for a, c in zip(x, y)]
    assert got == [t / (h * w) for t in tot]


@pytest.fixture(scope="module")
def midtex8():
    """`synth_corpus --midtex`'s first 8 images (2040x1356, seed 7), as the
    kmeans-midtex8 cell makes them."""
    rng = np.random.default_rng(7)
    return [synth_corpus.synth_textured(rng, 1356, 2040, brightness=0.80)
            for _ in range(8)]


def test_device_colour_histograms_equal_hist_rgb_on_midtex(cuda, midtex8):
    """One upload and one sort over the 8 midtex images give each image's
    `native.hist_rgb`: unique colours in key order, counts, inverse."""
    from cniic_tpu_torch.ops import color_hist, histogram

    lh = color_hist.lane_histograms(midtex8, cuda)
    assert lh.colors.is_cuda and lh.inverse.is_cuda
    for b, im in enumerate(midtex8):
        uniq, counts, inverse = native.hist_rgb(im.reshape(-1, 3))
        colors, got_counts, got_inverse = lh.lane(b)
        np.testing.assert_array_equal(histogram.pack_colors(colors), uniq)
        np.testing.assert_array_equal(got_counts, counts)
        np.testing.assert_array_equal(got_inverse, inverse)


def test_cluster_colors_card_stages_equal_cpu_on_midtex(cuda, midtex8):
    """cluster-colors(32) `encode_batch` on the card (the colour histogram,
    K1's lanes and the palette ids on the device) gives the CPU path's
    streams for the 8 midtex images, launching K1."""
    before = tkk.assign_stats.launches
    on_card = from_spec("cluster-colors(32)", device="cuda").encode_batch(
        midtex8)
    assert tkk.assign_stats.launches > before
    assert on_card == from_spec("cluster-colors(32)",
                                device="cpu").encode_batch(midtex8)


def test_gated_single_image_cluster_colors_matches_cpu(cuda, monkeypatch):
    """`encode` of one image runs the batch stages, so under
    CNIIC_DEVICE_BITPACK=1 its payload is packed by D1's batch route: the
    stream equals the ungated card stream and the CPU path's."""
    rng = np.random.default_rng(13)
    img = np.clip(rng.integers(0, 60, 3) + rng.integers(
        -3, 4, (64, 80, 3)).cumsum(1), 0, 255).astype(np.uint8)
    ungated = from_spec("cluster-colors(8)", device="cuda").encode(img)
    monkeypatch.setenv("CNIIC_DEVICE_BITPACK", "1")
    before = bitpack.pack_words.launches
    gated = from_spec("cluster-colors(8)", device="cuda").encode(img)
    assert bitpack.pack_words.launches > before
    assert gated == ungated == from_spec("cluster-colors(8)",
                                         device="cpu").encode(img)
