"""The k-means loop's one-launch iteration (`kmeans_kernel.prepare_step`,
driven by `kmeans._drive`) on the CPU, where it is K1's plain version then
D3's.

The loop keeps one iteration count a lane instead of one for the batch.
`_global_count_drive` below is the loop with the batch-global count, written
out with K1's plain version and numpy: an active lane must see the same
count in both, so `(iters, cur, cents)` must be equal, through steals,
plateaus, lanes of unequal size where one freezes early, and a `max_iters`
on and around the host's check cadence. The JAX engine is held against the
same loop where `max_iters` does not bind (the JAX engine checks it only
between bursts).
"""

import numpy as np
import pytest
import torch

from cniic_tpu.ops import kmeans as jkm
from cniic_tpu_torch.ops import kmeans as tkm
from cniic_tpu_torch.ops import kmeans_kernel as tkk


def _global_count_drive(points, k, weights, max_iters, stall_lim):
    """(iters, cur, cents): one count for the batch, advanced while any lane
    runs; means, steal, plateau and freeze in numpy."""
    pts, w, ns = tkm.pad_lanes(points, weights)
    ptsT, wt = torch.from_numpy(pts), torch.from_numpy(w)
    cur, cents = tkm._init_state(ptsT, ns, k)
    B, d, _ = pts.shape
    n = np.array(ns, np.int64)
    thresh = np.array([tkm._stop_threshold(x) for x in ns], np.int64)
    moved, best = n + 1, n + 1
    stall = np.zeros(B, np.int64)
    act = np.full(B, int(max_iters > 0), np.int32)
    it = 0
    while act.any():
        new, sums, mv = tkk.assign_stats_ref(
            ptsT, wt, cur, cents, torch.from_numpy(n.astype(np.int32)),
            torch.from_numpy(act))
        sums, mv = sums.numpy(), mv.numpy().astype(np.int64)
        j = np.arange(k, dtype=np.int64)
        mix = ((it + 1) * 2654435769 + j * 40503) & 0x7FFFFFFF
        for b in np.flatnonzero(act):
            cur[b, :ns[b]] = new[b, :ns[b]]
            wsum = sums[b, :, d]
            mean = sums[b, :, :d] // np.maximum(wsum, 1)[:, None]
            stolen = pts[b][:, mix % max(ns[b], 1)].T
            cents[b] = torch.from_numpy(
                np.where((wsum == 0)[:, None], stolen, mean).astype(np.int32))
            moved[b] = mv[b]
            if mv[b] < best[b] - best[b] // 50:
                best[b], stall[b] = mv[b], 0
            else:
                stall[b] += 1
        it += 1
        act = (act.astype(bool) & (moved > thresh) & (stall < stall_lim)
               & (it < max_iters)).astype(np.int32)
    return it, cur.numpy(), cents.numpy()


def _port_drive(points, k, weights, max_iters):
    pts, w, ns = tkm.pad_lanes(points, weights)
    ptsT = torch.from_numpy(pts)
    cur, cents = tkm._init_state(ptsT, ns, k)
    it, cur, cents = tkm._drive(ptsT, torch.from_numpy(w), cur, cents, ns, k,
                                pts.max(axis=(0, 2)).tolist(), max_iters)
    return it, cur.numpy(), cents.numpy()


def _inputs(name):
    rng = np.random.default_rng(11)
    few = rng.integers(0, 4, (780, 2))           # 16 distinct points: steals
    if name == "steals":
        return [few, few[:500], rng.integers(0, 256, (600, 2)),
                rng.integers(0, 256, (600, 2))], [None] * 4
    if name == "unequal":
        # a tiny lane that freezes within a few iterations beside long ones
        return ([rng.integers(0, 256, (40, 3)), rng.integers(0, 256, (2500, 3)),
                 rng.integers(0, 256, (900, 3))],
                [None, rng.integers(1, 30, 2500), None])
    raise KeyError(name)


@pytest.mark.parametrize("max_iters", [1, 3, 8, 9, 10_000])
@pytest.mark.parametrize("name", ["steals", "unequal"])
def test_drive_equals_the_global_count_loop(monkeypatch, name, max_iters):
    monkeypatch.setattr(tkm, "_STALL_LIMIT", 3)  # plateaus too
    points, weights = _inputs(name)
    want = _global_count_drive(points, 16, weights, max_iters, 3)
    got = _port_drive(points, 16, weights, max_iters)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    if max_iters < 10_000:
        assert got[0] == max_iters     # binds exactly there
    else:
        assert got[0] > 9


@pytest.mark.parametrize("name", ["steals", "unequal"])
def test_global_count_loop_equals_jax_engine(name):
    """The loop this file holds `_drive` against is the JAX engine's."""
    points, weights = _inputs(name)
    want = jkm.kmeans_batch(points, 16, weights_list=weights)
    it, cur, cents = _global_count_drive(points, 16, weights, 10_000,
                                         tkm._STALL_LIMIT)
    for b, (c, a, iters) in enumerate(want):
        np.testing.assert_array_equal(cents[b], c)
        np.testing.assert_array_equal(cur[b, :a.size], a)
        assert iters == it


def test_lanes_count_their_own_iterations():
    """A lane's count stops where the lane freezes; the loop returns the
    longest lane's, which is the batch's."""
    points, weights = _inputs("unequal")
    pts, w, ns = tkm.pad_lanes(points, weights)
    ptsT = torch.from_numpy(pts)
    cur, cents = tkm._init_state(ptsT, ns, 16)
    B, d, _ = pts.shape
    i64 = torch.int64
    n32 = torch.tensor(ns, dtype=torch.int32)
    state = dict(
        sums=torch.zeros((B, 16, d + 1), dtype=i64),
        moved_k=torch.zeros(B, dtype=torch.int32),
        moved=n32.to(i64) + 1, best=n32.to(i64) + 1,
        stall=torch.zeros(B, dtype=i64), it=torch.zeros(B, dtype=i64),
        thresh=torch.tensor([tkm._stop_threshold(n) for n in ns], dtype=i64))
    act = torch.ones(B, dtype=torch.int32)
    step = tkk.prepare_step(ptsT, torch.from_numpy(w), cur, cents, n32, act,
                            pts.max(axis=(0, 2)).tolist(), stall_lim=64,
                            max_iters=10_000, **state)
    counts = []
    while bool(act.any()):
        step()
        counts.append(state["it"].tolist())
    for _ in range(3):                      # launches after the end: no-ops
        step()
    assert state["it"].tolist() == counts[-1]
    final = counts[-1]
    assert final[0] < max(final)            # the tiny lane froze early
    for seen in counts:                     # a running lane has the batch's
        assert all(c == max(seen) or c == f for c, f in zip(seen, final))
    want = _global_count_drive(points, 16, weights, 10_000, 64)
    assert max(final) == want[0]
    np.testing.assert_array_equal(cur.numpy(), want[1])
    np.testing.assert_array_equal(cents.numpy(), want[2])


def _step_operands():
    rng = np.random.default_rng(5)
    B, d, n, k = 2, 3, 60, 4
    t = torch.from_numpy
    i64 = torch.int64
    return dict(
        ptsT=t(rng.integers(0, 256, (B, d, n)).astype(np.int32)),
        w=t(np.ones((B, n), np.int32)),
        cur=t(rng.integers(0, k, (B, n)).astype(np.int32)),
        cents=t(rng.integers(0, 256, (B, k, d)).astype(np.int32)),
        n=t(np.full(B, n, np.int32)), act=t(np.ones(B, np.int32)),
        pmax=[255] * d, sums=torch.zeros((B, k, d + 1), dtype=i64),
        moved_k=torch.zeros(B, dtype=torch.int32),
        moved=torch.full((B,), n + 1, dtype=i64),
        best=torch.full((B,), n + 1, dtype=i64),
        stall=torch.zeros(B, dtype=i64), it=torch.zeros(B, dtype=i64),
        thresh=torch.zeros(B, dtype=i64), stall_lim=64, max_iters=100)


@pytest.mark.parametrize("fused", [True, False])
def test_prepared_step_is_k1_then_d3(fused):
    """On CPU tensors a prepared step is `assign_stats_ref` then
    `step_update_ref`, whatever `fused` says, and counts no launch."""
    ops = _step_operands()
    want = {key: v.clone() if torch.is_tensor(v) else v
            for key, v in ops.items()}
    before = (tkk.assign_stats.launches, tkk.step_update.launches)
    step = tkk.prepare_step(**ops, fused=fused)
    for _ in range(3):
        step()
        new, sums, mv = tkk.assign_stats_ref(
            *[want[key] for key in ("ptsT", "w", "cur", "cents", "n", "act")])
        want["cur"] = torch.where((want["act"] != 0)[:, None], new,
                                  want["cur"])
        tkk.step_update_ref(sums, mv, want["ptsT"], want["n"], want["cents"],
                            want["moved"], want["best"], want["stall"],
                            want["act"], want["it"], want["thresh"], 64, 100)
        for key in ("cur", "cents", "moved", "best", "stall", "act", "it"):
            assert torch.equal(ops[key], want[key]), key
        assert not ops["sums"].any() and not ops["moved_k"].any()
    assert ops["it"].tolist() == [3, 3]
    assert (tkk.assign_stats.launches, tkk.step_update.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "bound", "device", "it"])
def test_prepare_step_refuses_once_up_front(bad):
    ops = _step_operands()
    err = ValueError
    if bad == "dtype":
        ops["best"], err = ops["best"].to(torch.int32), TypeError
    elif bad == "shape":
        ops["sums"] = ops["sums"][:, :-1].contiguous()
    elif bad == "bound":
        ops["pmax"] = [46341, 0, 0]
    elif bad == "device":
        ops["thresh"] = ops["thresh"].to("meta")
    else:
        ops["it"] = torch.zeros(2, dtype=torch.int64)[:1]
    with pytest.raises(err):
        tkk.prepare_step(**ops)



def test_two_launches_prepares_the_engine_step_unfused_and_restores(
        monkeypatch):
    """`kmeans_profile.two_launches` makes the engine prepare its step with
    fused=False for the duration (the comparison run of the profile), and
    the engine prepares it fused before and after."""
    from cniic_tpu_torch import kmeans_profile

    seen = []
    real = tkk.prepare_step

    def spy(*args, fused=True, **kw):
        seen.append(fused)
        return real(*args, fused=fused, **kw)

    monkeypatch.setattr(tkm, "prepare_step", spy)
    points, weights = _inputs("steals")
    run = lambda: tkm.kmeans_batch(  # noqa: E731
        points, 16, weights_list=weights, on_error="collect", device="cpu")
    before = run()
    with kmeans_profile.two_launches():
        inside = run()
    assert tkm.prepare_step is spy
    run()
    assert seen and len(seen) % 3 == 0
    third = len(seen) // 3
    assert seen == [True] * third + [False] * third + [True] * third
    for a, b in zip(before, inside):
        assert type(a) is type(b)
        if isinstance(a, tuple):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2] == b[2]
