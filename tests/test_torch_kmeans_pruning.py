"""The bound filter in front of K1's scan, in its plain model
(`kmeans_kernel.pruned_assign_ref`, float64 rounded outward), on the CPU.

K1's pruned instance keeps a point on its centroid without a scan when its
exact distance to that centroid is at most a lower bound on its distance to
every other one: the bound from its last scan, less the largest distance a
centroid moved since (from the lane's snapshots of its last few centroid
sets). That must never change a result: over many
iterations the model's assignment, statistics and move counts must equal
K1's plain version (`assign_stats_ref`) and, through D3's plain version
(`step_update_ref`), every centroid after every step, on voronoi points and
on adversarial inputs: centroids equidistant from points that tie with
their current centroid, points whose bounds are equal, clusters emptied
(the steal moves a centroid far) and lanes frozen from the start or early.
A whole loop driven by the model equals the JAX engine's. Each case prints
the share of points the filter sent to the scan.
"""

import fractions
import math

import numpy as np
import pytest
import torch

from cniic_tpu.ops import kmeans as jkm
from cniic_tpu_torch import synth_corpus
from cniic_tpu_torch.ops import kmeans as tkm
from cniic_tpu_torch.ops import kmeans_kernel as tkk


def _voronoi_lanes(seed, B, h, w):
    rng = np.random.default_rng(seed)
    imgs = np.stack([synth_corpus.synth_textured(rng, h, w, brightness=0.8)
                     for _ in range(B)])
    ptsT, wt = tkm._voronoi_setup(torch.from_numpy(imgs))
    return imgs, ptsT, wt


def _equidistant_lanes(seed, B, k):
    """Points on a coarse grid and centroids on a grid of the same pitch,
    shifted by half a pitch in some dimensions: most points lie exactly
    between two or more centroids, at distances that are perfect squares."""
    rng = np.random.default_rng(seed)
    n = 900
    grid = rng.integers(0, 8, (B, 5, n)) * 4
    ptsT = torch.from_numpy(grid.astype(np.int32))
    return ptsT, torch.ones((B, n), dtype=torch.int32)


def _steal_lanes(seed, B, k):
    """Voronoi points whose every fourth centroid (4j + 1) starts equal to
    the one before it, which wins every tie: those clusters go empty and the
    steal moves their centroids to points far away, a large drift."""
    _, ptsT, w = _voronoi_lanes(seed, B, 30, 40)
    ns = [ptsT.shape[2] - 5 * b for b in range(B)]
    cur, cents = tkm._init_state(ptsT, ns, k)
    cents[:, 1::4] = cents[:, 0::4][:, : cents[:, 1::4].shape[1]]
    cur = torch.where(cur % 4 == 1, cur - 1, cur)
    return ptsT, w, (cur, cents)


def _loop(ptsT, w, k, steps, window=16, groups=1, frozen=(), thresh=None,
          init=None):
    """`steps` iterations of the model against the plain versions, every
    output compared after every step; returns (scanned share a step,
    steals a step, iterations each lane ran)."""
    B, d, n = ptsT.shape
    ns = [n - 5 * b for b in range(B)]
    for b in range(B):
        w[b, ns[b]:] = 0
    cur, cents = tkm._init_state(ptsT, ns, k) if init is None else init
    n32 = torch.tensor(ns, dtype=torch.int32)
    act = torch.ones(B, dtype=torch.int32)
    for b in frozen:
        act[b] = 0
    i64 = dict(dtype=torch.int64)
    n64 = n32.to(torch.int64)
    th = torch.full((B,), -1, **i64) if thresh is None else thresh
    moved, best = n64 + 1, n64 + 1
    stall, it = torch.zeros(B, **i64), torch.zeros(B, **i64)
    state = tkk.prune_bounds_ref(cents, n, window, groups)
    shares, steals = [], []
    for _ in range(steps):
        if not bool(act.any()):
            break
        want = tkk.assign_stats_ref(ptsT, w, cur, cents, n32, act)
        got = tkk.pruned_assign_ref(ptsT, w, cur, cents, n32, act, it, state)
        for g, x in zip(got[:3], want):
            assert torch.equal(g, x)
        live = sum(ns[b] for b in range(B) if act[b])
        shares.append(float(got[3].sum()) / live)
        new, sums, mk = want
        keep = (act != 0)[:, None] & (torch.arange(n)[None, :]
                                      < n32[:, None])
        cur = torch.where(keep, new, cur)
        steals.append(int(((sums[:, :, d] == 0)
                           & (act != 0)[:, None]).sum()))
        ran = act != 0
        tkk.step_update_ref(sums, mk, ptsT, n32, cents, moved, best, stall,
                            act, it, th, 64, 1 << 40)
        tkk.snapshot_ref(state, cents, it, ran)
    return shares, steals, it.tolist()


def _report(name, shares, steals):
    tail = shares[len(shares) // 2:]
    print(f"{name}: {len(shares)} steps, scanned share first "
          f"{shares[0]:.3f}, mean {np.mean(shares):.3f}, second half "
          f"{np.mean(tail):.3f}; {sum(steals)} steals")


@pytest.mark.parametrize("window,groups", [(2, 1), (16, 1), (4, 1), (16, 4)])
def test_voronoi_loop_matches_plain_versions(window, groups):
    _, ptsT, w = _voronoi_lanes(7, 2, 40, 60)
    shares, steals, _ = _loop(ptsT, w, 48, 60, window, groups)
    _report(f"voronoi W{window} G{groups}", shares, steals)
    assert shares[0] > 0.5 and min(shares) < 0.2   # the filter does skip


@pytest.mark.parametrize("seed", [1, 2])
def test_equidistant_centroids_and_ties_with_the_current(seed):
    """Centroids on the points' grid, half a pitch apart: every point
    ties between centroids, most with its current centroid, and a point's
    distance equals its bound when its two distances are equal perfect
    squares."""
    ptsT, w = _equidistant_lanes(seed, 2, 64)
    B, d, n = ptsT.shape
    rng = np.random.default_rng(seed)
    cents = (rng.integers(0, 16, (B, 64, d)) * 2).astype(np.int32)
    cents[:, 32:] = cents[:, :32]               # equal centroids: ties
    cur = rng.integers(0, 64, (B, n)).astype(np.int32)
    shares, steals, _ = _loop(ptsT, w, 64, 40, init=(
        torch.from_numpy(cur), torch.from_numpy(cents)))
    _report(f"equidistant seed {seed}", shares, steals)
    assert min(shares) < 1.0


def test_point_exactly_on_its_bounds_is_kept_without_a_scan():
    """A point at distance 3 from two centroids (a perfect square): after
    its first scan its distance and its bound are both 3. Nothing moves, so
    the next steps keep it with no scan (the test is <=), and it stays on
    its current centroid, the higher index of the two, as the strict-move
    rule says; through a rebase too (window 2)."""
    ptsT = torch.tensor([[[5, 20]], [[5, 20]], [[5, 20]], [[5, 20]],
                         [[5, 20]]], dtype=torch.int32).permute(1, 0, 2)
    ptsT = ptsT.contiguous()                                  # (1, 5, 2)
    cents = torch.tensor([[[2, 5, 5, 5, 5], [8, 5, 5, 5, 5],
                           [20, 20, 20, 20, 20]]], dtype=torch.int32)
    cur = torch.tensor([[1, 2]], dtype=torch.int32)
    w = torch.ones((1, 2), dtype=torch.int32)
    n = torch.tensor([2], dtype=torch.int32)
    act = torch.ones(1, dtype=torch.int32)
    state = tkk.prune_bounds_ref(cents, 2, 2)
    for step in range(3):
        it = torch.tensor([step])
        want = tkk.assign_stats_ref(ptsT, w, cur, cents, n, act)
        got = tkk.pruned_assign_ref(ptsT, w, cur, cents, n, act, it, state)
        for g, x in zip(got[:3], want):
            assert torch.equal(g, x)
        assert got[0][0, 0] == 1                     # the tie keeps it
        if step == 0:
            assert bool(got[3][0, 0])                # scanned once
        else:
            assert not bool(got[3][0, 0])            # then kept, unscanned
        assert float(state["lb"][0, 0, 0]) == 3.0
        assert int(state["since"][0, 0]) == step     # rebased every step
        tkk.snapshot_ref(state, cents, it + 1, act != 0)
    # the point on its centroid is kept from the first step: 0 <= lb
    assert not bool(got[3][0, 1])


@pytest.mark.parametrize("window,groups", [(16, 1), (16, 4), (2, 1)])
def test_steals_move_centroids_far_and_nothing_changes(window, groups):
    ptsT, w, init = _steal_lanes(3, 2, 64)
    shares, steals, _ = _loop(ptsT, w, 64, 80, window, groups, init=init)
    _report(f"steals W{window} G{groups}", shares, steals)
    assert sum(steals) > 0


def test_frozen_lanes_and_a_lane_that_freezes_early():
    """Lane 1 frozen from the start; lane 2 freezes once it moves fewer
    than a quarter of its points (its own threshold); lane 0 runs on."""
    _, ptsT, w = _voronoi_lanes(11, 3, 30, 40)
    n = ptsT.shape[2]
    thresh = torch.tensor([-1, -1, n // 4], dtype=torch.int64)
    shares, steals, iters = _loop(ptsT, w, 24, 40, frozen=(1,),
                                  thresh=thresh)
    _report("frozen lanes", shares, steals)
    assert iters[1] == 0 and 0 < iters[2] < iters[0] == len(shares)


def _model_drive(ptsT, w, ns, k, window, groups):
    """`kmeans._drive` with the model as K1: (iters, cur, cents)."""
    B, d, n = ptsT.shape
    cur, cents = tkm._init_state(ptsT, ns, k)
    n32 = torch.tensor(ns, dtype=torch.int32)
    n64 = n32.to(torch.int64)
    i64 = dict(dtype=torch.int64)
    thresh = torch.tensor([tkm._stop_threshold(x) for x in ns], **i64)
    moved, best = n64 + 1, n64 + 1
    stall, it = torch.zeros(B, **i64), torch.zeros(B, **i64)
    act = torch.ones(B, dtype=torch.int32)
    state = tkk.prune_bounds_ref(cents, n, window, groups)
    while bool(act.any()):
        new, sums, mk, _ = tkk.pruned_assign_ref(ptsT, w, cur, cents, n32,
                                                 act, it, state)
        keep = (act != 0)[:, None] & (torch.arange(n)[None, :]
                                      < n32[:, None])
        cur = torch.where(keep, new, cur)
        ran = act != 0
        tkk.step_update_ref(sums, mk, ptsT, n32, cents, moved, best, stall,
                            act, it, thresh, tkm._STALL_LIMIT, 10_000)
        tkk.snapshot_ref(state, cents, it, ran)
    return int(it.max()), cur, cents


@pytest.mark.parametrize("window,groups", [(16, 1), (8, 4)])
def test_model_driven_voronoi_loop_matches_jax_engine(window, groups):
    """The whole voronoi loop with the filter in front of every scan gives
    the JAX engine's centroids and iteration count."""
    imgs, ptsT, w = _voronoi_lanes(5, 2, 24, 36)
    n = ptsT.shape[2]
    it, cur, cents = _model_drive(ptsT, w, [n, n], 16, window, groups)
    want = jkm.voronoi_centroids_batch(imgs, 16)
    for b in range(2):
        np.testing.assert_array_equal(cents[b].numpy(), want[b])
    port = tkm.voronoi_centroids_batch(imgs, 16, device="cpu")
    for b in range(2):
        np.testing.assert_array_equal(cents[b].numpy(), port[b])
    assert it > 2


def test_sqrt_rounded_outward_brackets_the_root():
    xs = [0, 1, 2, 3, 4, 15, 16, 17, 10**9 + 7, 2**31 - 1, 46340**2]
    up = tkk._sqrt_out(torch.tensor(xs), up=True)
    down = tkk._sqrt_out(torch.tensor(xs), up=False)
    for x, u, dn in zip(xs, up.tolist(), down.tolist()):
        r = math.isqrt(x)
        if r * r == x:
            assert u == dn == r
        else:   # (dn, u) holds sqrt(x): dn^2 < x < u^2, exactly
            assert fractions.Fraction(dn) ** 2 < x < fractions.Fraction(u) ** 2


def test_differences_rounded_down_stay_under_the_exact_one():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.uniform(0, 1e4, 200))
    b = torch.from_numpy(rng.uniform(-1e3, 1e3, 200))
    low = tkk._sub_down(a, b).tolist()
    for x, y, lo in zip(a.tolist(), b.tolist(), low):
        exact = fractions.Fraction(x) - fractions.Fraction(y)
        assert fractions.Fraction(lo) <= exact
        assert exact - fractions.Fraction(lo) <= fractions.Fraction(
            math.ulp(lo))
    inf = torch.tensor([float("inf")], dtype=torch.float64)
    assert tkk._sub_down(inf, torch.tensor([2.0], dtype=torch.float64)
                         ).item() == float("inf")


def test_snapshots_hold_the_largest_displacement_of_each_group():
    """mdisp[b, slot, g]: the largest distance a centroid of group g moved
    from the snapshot in that slot, rounded up (exact for a perfect
    square)."""
    c0 = torch.zeros((1, 4, 5), dtype=torch.int32)
    state = tkk.prune_bounds_ref(c0, 3, window=3, groups=2)
    c1 = c0.clone()
    c1[0, 1, :2] = torch.tensor([3, 4])          # group 0 moves 5
    tkk.snapshot_ref(state, c1, torch.tensor([1]), torch.tensor([True]))
    c2 = c1.clone()
    c2[0, 3] = 1                                 # group 1 moves sqrt(5)
    tkk.snapshot_ref(state, c2, torch.tensor([2]), torch.tensor([True]))
    m = state["mdisp"][0]                        # slots 0, 1, 2
    assert m[0, 0] == 5.0 and m[1, 0] == 0.0 and m[2, 0] == 0.0
    assert m[0, 1] == m[1, 1] > math.sqrt(5) and m[2, 1] == 0.0
    assert torch.equal(state["ring"][0, 2], c2[0].to(torch.int64))
    tkk.snapshot_ref(state, c2, torch.tensor([3]), torch.tensor([False]))
    assert m[0, 0] == 5.0                        # a lane that did not run


@pytest.mark.parametrize("d,k,pmax,pruned", [
    (5, 2048, [2039, 1355, 255, 255, 255], True),    # midtex voronoi(2048)
    (5, 1024, [2039, 1355, 255, 255, 255], True),
    (5, 512, [2039, 1355, 255, 255, 255], True),
    (5, 256, [2039, 1355, 255, 255, 255], False),    # below 512
    (5, 128, [2039, 1355, 255, 255, 255], False),    # packed
    (5, 512, [1023, 1023, 255, 255, 255], False),    # packed at 1024^2
    (3, 1024, [16383, 16383, 16383], False),         # cluster-colors' d
])
def test_pruned_path_is_picked_by_shape(d, k, pmax, pruned):
    assert tkk.pruned_path(d, k, pmax) is pruned


def test_prune_state_starts_every_point_at_its_exact_distance():
    cents = torch.arange(2 * 3 * 5, dtype=torch.int32).reshape(2, 3, 5)
    lb, since, ring, mdisp = tkk.prune_state(cents, 7)
    assert lb.dtype == mdisp.dtype == torch.float32
    assert since.dtype == ring.dtype == torch.int32
    assert lb.shape == since.shape == (2, 7) and not bool(lb.any())
    assert not bool(since.any()) and not bool(mdisp.any())
    assert ring.shape == (2, tkk.PRUNE_WINDOW, 5, 3)
    assert torch.equal(ring[:, 0], cents.transpose(1, 2))


def test_drive_on_the_cpu_takes_the_plain_versions(monkeypatch):
    """On the CPU the loop's step is the two plain versions and gets no
    filter state, even for a shape that the card would prune."""
    seen = []
    real = tkk.prepare_step

    def spy(*args, **kwargs):
        seen.append(kwargs.get("bounds"))
        step = real(*args, **kwargs)
        seen.append(step.pruned)
        return step

    monkeypatch.setattr(tkm, "prepare_step", spy)
    monkeypatch.setattr(tkm, "pruned_path", lambda *args: True)
    imgs, _, _ = _voronoi_lanes(9, 1, 20, 30)
    tkm.voronoi_centroids_batch(imgs, 8, device="cpu")
    assert seen == [None, False]


def test_k1_layer_reads_the_scanned_share_of_pruned_loops():
    """The benchmark's K1 layer: points the pruned instance scanned over the
    points of the active lanes of the loops it ran (lane b active in its
    first it[b] launches); None when no loop ran it."""
    from benchmark import cells

    pruned = (torch.tensor([100, 60]), torch.tensor([10, 4]), 5, 2048, True)
    plain = (torch.tensor([50]), torch.tensor([3]), 3, 32, False)
    layer = cells.k1_layer(None, 16, [pruned, plain], 13, scanned=312)
    assert layer["k1_scanned_share"] == 312 / (100 * 10 + 60 * 4)
    assert cells.k1_layer(None, 8, [plain], 3)["k1_scanned_share"] is None


def test_prune_probe_holds_each_variant_to_the_kernel_on_the_cpu():
    """`prune_probe` over a small crop: every variant's kept points are
    points the loop did not move, and each reports a share a step."""
    from cniic_tpu_torch import prune_probe

    img = prune_probe.midtex_image(7)[:40, :60]
    got = prune_probe.probe(img, 16, torch.device("cpu"), say=lambda s: None)
    assert got["kept_moved"] == 0 and got["iterations"] > 2
    assert set(got["shares"]) == set(prune_probe.VARIANTS)
    assert all(len(v) == got["iterations"] for v in got["shares"].values())
