"""The port's k-means (cniic_tpu_torch.ops.kmeans*) against the JAX package.

Every stage is integer-exact, so every comparison is exact equality:

* K1's plain version (`assign_stats_ref`, what the wrapper runs on CPU
  tensors) against the Pallas kernel itself (`kmeans_pallas._assign_stats`
  in interpret mode) and against its XLA twin `_assign_stats_xla`, at the
  cases of tests/test_kmeans_pallas.py plus a frozen lane;
* the engine (`kmeans`, `kmeans_batch`, `voronoi_centroids_batch`) against
  the JAX engine on its CPU backend: centroids, assignments and the
  batch-global `iters`, through a steal, a plateau, strict mode, collect-mode
  errors and chunked batches.

Data passes between the packages as numpy arrays made from numpy seeds.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cniic_tpu.ops import kmeans as jkm
from cniic_tpu.ops import kmeans_pallas as jkp
from cniic_tpu_torch.ops import kmeans as tkm
from cniic_tpu_torch.ops import kmeans_kernel as tkk


# ---------------------------------------------------------------------------
# helpers: the JAX kernel's operands and outputs in the port's layout
# ---------------------------------------------------------------------------

def _planes_to_int64(sums, d: int, vp: int, wp: int) -> np.ndarray:
    """Digit-plane statistics int32[..., k, vp*d+wp] (8-bit planes, most
    significant first) -> the port's int64[..., k, d+1]: per cluster the sum
    of w*p per dimension, then the sum of w (sum of plane * 256^j)."""
    s = np.asarray(sums).astype(np.int64)
    vals = sum(s[..., i * d:(i + 1) * d] << (8 * (vp - 1 - i))
               for i in range(vp))
    wsum = sum(s[..., vp * d + i] << (8 * (wp - 1 - i)) for i in range(wp))
    return np.concatenate([vals, wsum[..., None]], axis=-1)


def _port_operands(pts_i, w, cur, cents, ns, act, n_pad):
    """JAX-layout operands (points [B, n, d]) -> the port's torch int32
    tensors (points [B, d, n]), cut to n_pad points per lane."""
    t = lambda a: torch.tensor(np.ascontiguousarray(a, dtype=np.int32))  # noqa: E731
    pts = np.asarray(pts_i)[:, :n_pad]
    return (t(pts.transpose(0, 2, 1)), t(np.asarray(w)[:, :n_pad]),
            t(np.asarray(cur)[:, :n_pad]), t(np.asarray(cents)), t(ns), t(act))


def _step_batch(seed, k, d, weighted, B=2, n=300, maxval=256):
    rng = np.random.default_rng(seed)
    pts, ws = [], []
    for _ in range(B):
        p = rng.integers(0, maxval, (n, d)).astype(np.int64)
        p[n // 2:] = p[: n - n // 2]  # duplicates -> distance ties
        pts.append(p)
        ws.append(rng.integers(1, 200, n).astype(np.int64) if weighted else None)
    return pts, ws


STEP_CASES = [  # (k, d, weighted, frozen lane) — test_kmeans_pallas.py:29-31
    (8, 3, True, False),
    (16, 5, False, False),
    (5, 2, False, False),
    (8, 3, True, True),
]


@pytest.mark.parametrize("k,d,weighted,frozen", STEP_CASES)
def test_assign_stats_ref_matches_pallas_kernel(k, d, weighted, frozen):
    pts, ws = _step_batch(3, k, d, weighted)
    (_, pts_i, w, _, cur, cents, ns, _, vp, wp, pk, _, _, _, d2b) = \
        jkm._prep_host_batch(pts, k, ws if weighted else None)
    B = len(pts)
    act = np.ones(B, np.int32)
    if frozen:
        act[1] = 0
    n_pad = 384  # a multiple of the kernel block covering n = 300
    new_p, sums_p, mv_p = jkp._assign_stats(
        jkp.to_ptsT(pts_i[:, :n_pad]), w[:, :n_pad], cur[:, :n_pad],
        cents.astype(jnp.float32), jnp.asarray(ns.astype(np.int32)),
        jnp.asarray(act), k=k, vp=vp, wp=wp, pk=pk, bs=128, d2b=d2b,
        packed=True, interpret=True)

    new_t, sums_t, mv_t = tkk.assign_stats_ref(
        *_port_operands(pts_i, w, cur, cents, ns, act, n_pad))
    want_sums = _planes_to_int64(sums_p, d, vp, wp)
    for b in range(B):
        if not act[b]:
            # a frozen lane is skipped whole: its outputs keep their zeros
            assert not new_t[b].any() and not sums_t[b].any()
            assert int(mv_t[b]) == 0
            continue
        np.testing.assert_array_equal(new_t[b].numpy(), np.asarray(new_p[b]))
        np.testing.assert_array_equal(sums_t[b].numpy(), want_sums[b])
        assert int(mv_t[b]) == int(mv_p[b, 0])


@pytest.mark.parametrize("k,d,weighted", [(8, 3, True), (16, 5, False),
                                          (5, 2, False)])
def test_assign_stats_ref_matches_xla_step(k, d, weighted):
    pts, ws = _step_batch(4, k, d, weighted)
    (pts_f, pts_i, w, valid, cur, cents, ns, bs, vp, wp, pk, _, _, _, _) = \
        jkm._prep_host_batch(pts, k, ws if weighted else None)
    B, n_pad = len(pts), pts_i.shape[1]
    new_t, sums_t, mv_t = tkk.assign_stats_ref(*_port_operands(
        pts_i, w, cur, cents, ns, np.ones(B, np.int32), n_pad))
    for b in range(B):
        new_x, sums_x, mv_x = jkm._assign_stats_xla(
            pts_f[b], pts_i[b], w[b], valid[b], cur[b],
            cents[b].astype(jnp.float32), k, bs, vp, wp, pk)
        np.testing.assert_array_equal(new_t[b].numpy(), np.asarray(new_x))
        np.testing.assert_array_equal(sums_t[b].numpy(),
                                      _planes_to_int64(sums_x, d, vp, wp))
        assert int(mv_t[b]) == int(mv_x)


def _small_operands(B=2, d=3, n=50, k=4, maxv=256, seed=0):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    pts = rng.integers(0, maxv, (B, d, n)).astype(np.int32)
    cur = rng.integers(0, k, (B, n)).astype(np.int32)
    cents = rng.integers(0, maxv, (B, k, d)).astype(np.int32)
    return (t(pts), t(np.ones((B, n), np.int32)), t(cur), t(cents),
            t(np.full(B, n, np.int32)), t(np.ones(B, np.int32)))


def test_assign_stats_wrapper_takes_plain_version_on_cpu():
    ops = _small_operands()
    before = tkk.assign_stats.launches
    got = tkk.assign_stats(*ops, pmax=[255] * 3)
    want = tkk.assign_stats_ref(*ops)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    # the counter counts kernel launches only
    assert tkk.assign_stats.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "bound", "pmax"])
def test_assign_stats_wrapper_rejects(bad):
    ptsT, w, cur, cents, n, act = _small_operands()
    pmax = [255] * 3
    err = ValueError
    if bad == "dtype":
        w, err = w.to(torch.int64), TypeError
    elif bad == "shape":
        cur = cur[:, :-1].contiguous()
    elif bad == "contiguity":
        cents = cents.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "bound":
        pmax = [46341, 0, 0]  # 46341^2 > 2^31
    else:
        pmax = [255] * 2
    with pytest.raises(err):
        tkk.assign_stats(ptsT, w, cur, cents, n, act, pmax=pmax)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _assert_same_lanes(jax_out, port_out):
    assert len(jax_out) == len(port_out)
    for j, t in zip(jax_out, port_out):
        if isinstance(j, Exception):
            assert type(t) is type(j) and str(t) == str(j)
            continue
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
        assert t[2] == j[2]  # the batch-global iteration count


def test_kmeans_init_layout_and_weights():
    vals = [0, 1, 2, 35, 40, 90, 92, 150, 151, 152]
    pts = np.array([[v, 0] for v in vals], np.int64)
    for w in (None, np.array([1, 3, 1, 7, 2, 2, 9, 1, 1, 4], np.int64)):
        j = jkm.kmeans(pts, 3, weights=w)
        t = tkm.kmeans(pts, 3, weights=w, device="cpu")
        _assert_same_lanes([j], [t])


def test_kmeans_batch_mixed_lanes_match():
    rng = np.random.default_rng(7)
    sets = [
        (rng.integers(0, 256, (500, 3)), rng.integers(1, 50, 500)),
        (rng.integers(0, 256, (1200, 3)), None),
        (rng.integers(0, 256, (37, 3)), np.ones(37, np.int64)),
    ]
    pts = [p for p, _ in sets]
    ws = [w for _, w in sets]
    _assert_same_lanes(jkm.kmeans_batch(pts, 8, weights_list=ws),
                       tkm.kmeans_batch(pts, 8, weights_list=ws, device="cpu"))


def test_kmeans_steal_matches(monkeypatch):
    """Few distinct values and many points: initial centroids coincide, so
    clusters empty and the Weyl steal (with the global iteration counter)
    picks their new centroids."""
    steals = []
    real = tkk.step_update_ref

    def spy(sums, moved_k, ptsT, n, cents, moved, best, stall, act, it,
            *rest):
        d = ptsT.shape[1]
        if bool(((sums[:, :, d] == 0) & (act != 0)[:, None]).any()):
            steals.append(int(it.max()))
        return real(sums, moved_k, ptsT, n, cents, moved, best, stall, act,
                    it, *rest)

    monkeypatch.setattr(tkk, "step_update_ref", spy)
    rng = np.random.default_rng(263)
    rng.integers(150, 900), rng.integers(4, 40), rng.integers(2, 4)
    rng.choice([4, 16, 256])  # the draws that picked n=780, k=16, d=2, max 4
    pts = rng.integers(0, 4, (780, 2))
    w = rng.integers(1, 50, 780)
    j = jkm.kmeans_batch([pts, pts[:500]], 16, weights_list=[w, None],
                         on_error="collect")
    t = tkm.kmeans_batch([pts, pts[:500]], 16, weights_list=[w, None],
                         on_error="collect", device="cpu")
    assert steals, "the input must empty a cluster"
    _assert_same_lanes(j, t)


def test_kmeans_plateau_matches(monkeypatch, caplog):
    """The plateau net (no 2% move-count improvement for _STALL_LIMIT
    iterations freezes a lane), with the limit cut to 2 in both packages so
    that ordinary inputs reach it."""
    monkeypatch.setattr(jkm, "_STALL_LIMIT", 2)
    monkeypatch.setattr(tkm, "_STALL_LIMIT", 2)
    rng = np.random.default_rng(11)
    pts = [rng.integers(0, 256, (600, 3)) for _ in range(3)]
    with caplog.at_level(logging.INFO):
        j = jkm.kmeans_batch(pts, 12)
        t = tkm.kmeans_batch(pts, 12, device="cpu")
    plateaus = [r.getMessage() for r in caplog.records
                if "plateaued" in r.getMessage()]
    assert len(plateaus) == 2, plateaus  # one per package
    assert plateaus[0] == plateaus[1]
    _assert_same_lanes(j, t)


def test_kmeans_strict_matches(monkeypatch):
    monkeypatch.setenv("CNIIC_KMEANS_STRICT", "1")
    rng = np.random.default_rng(5)
    pts = [rng.integers(0, 256, (n, 3)) for n in (700, 450)]
    ws = [rng.integers(1, 9, 700), None]
    _assert_same_lanes(jkm.kmeans_batch(pts, 12, weights_list=ws),
                       tkm.kmeans_batch(pts, 12, weights_list=ws, device="cpu"))


def test_kmeans_collect_errors_match(monkeypatch):
    """Collect mode: each failing lane yields the same exception type and
    message in place; the others match."""
    rng = np.random.default_rng(17)
    n, nv = int(rng.integers(20, 80)), int(rng.integers(2, 5))
    vals = rng.integers(0, 256, (nv, 3))
    few_colors = vals[rng.integers(0, nv, n)]  # ends with 4 of 6 clusters
    rng = np.random.default_rng(9)
    good = rng.integers(0, 256, (300, 3))
    pts = [
        good,
        rng.integers(0, 256, (3, 3)),                 # fewer points than k
        np.full((40, 3), 20000),                      # coordinate cap
        rng.integers(0, 256, (64, 3)),                # weight cap (below)
        few_colors,                                   # too few active clusters
        good[:200],
    ]
    ws = [None, None, None, np.full(64, 2**24), None, None]
    j = jkm.kmeans_batch(pts, 6, weights_list=ws, on_error="collect")
    t = tkm.kmeans_batch(pts, 6, weights_list=ws, on_error="collect",
                         device="cpu")
    assert [type(r).__name__ for r in t] == [
        "tuple", "ValueError", "ValueError", "ValueError", "AssertionError",
        "tuple"]
    _assert_same_lanes(j, t)
    # CNIIC_KMEANS_LAX=1 downgrades the active-cluster floor to a warning
    monkeypatch.setenv("CNIIC_KMEANS_LAX", "1")
    _assert_same_lanes(jkm.kmeans_batch(pts[4:], 6, on_error="collect"),
                       tkm.kmeans_batch(pts[4:], 6, on_error="collect",
                                        device="cpu"))


def test_kmeans_raise_mode_messages_match():
    for pts, k in ((np.zeros((2, 2), np.int64), 3),
                   (np.zeros((5, 3), np.int64), 0)):
        with pytest.raises(ValueError) as je:
            jkm.kmeans(pts, k)
        with pytest.raises(ValueError) as te:
            tkm.kmeans(pts, k, device="cpu")
        assert str(te.value) == str(je.value)


def test_kmeans_batch_chunked_matches(monkeypatch):
    monkeypatch.setenv("CNIIC_KMEANS_LANES", "2")
    monkeypatch.setenv("CNIIC_KMEANS_PREFETCH", "0")
    rng = np.random.default_rng(0)
    pts = [rng.integers(0, 256, (150 + 7 * i, 3)) for i in range(5)]
    _assert_same_lanes(jkm.kmeans_batch(pts, 8),
                       tkm.kmeans_batch(pts, 8, device="cpu"))


@pytest.mark.parametrize("lanes", ["4", "2"])
def test_voronoi_centroids_batch_matches(monkeypatch, lanes):
    monkeypatch.setenv("CNIIC_KMEANS_LANES", lanes)
    rng = np.random.default_rng(21)
    imgs = rng.integers(0, 256, (3, 24, 30, 3)).astype(np.uint8)
    imgs[1, :12] = 40  # a flat half: many exact distance ties
    j = jkm.voronoi_centroids_batch(imgs, 16)
    t, dev = tkm.voronoi_centroids_batch(imgs, 16, return_device_imgs=True,
                                         device="cpu")
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b, a)
    assert torch.equal(dev, torch.from_numpy(imgs))


def test_voronoi_centroids_collect_errors_match():
    rng = np.random.default_rng(2)
    for shape, k in (((2, 3, 3, 3), 16), ((2, 6, 6, 3), 0)):
        imgs = rng.integers(0, 256, shape).astype(np.uint8)
        j = jkm.voronoi_centroids_batch(imgs, k, on_error="collect")
        t = tkm.voronoi_centroids_batch(imgs, k, on_error="collect",
                                        device="cpu")
        assert [str(e) for e in t] == [str(e) for e in j]
        assert all(isinstance(e, ValueError) for e in t)


# ---------------------------------------------------------------------------
# D3 (the step's update) and the loop on the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("it", [0, 1, 4999, 2**20 + 3, 2**31 - 2])
def test_steal_indices_match_jax(it):
    """The Weyl hash in int64 equals JAX's int32 wraparound form, for large
    iterations and clusters whose j*40503 wraps int32."""
    k = 70_000
    ns = [1, 7, 1_048_576, 2**27 - 1]
    got = tkk.steal_indices(k, it, torch.tensor(ns, dtype=torch.int64))
    for b, n in enumerate(ns):
        want = jkm._steal_indices(k, jnp.int32(it), jnp.int32(n))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_plateau_update_matches_jax():
    rng = np.random.default_rng(31)
    B = 64
    act = rng.integers(0, 2, B).astype(bool)
    best = rng.integers(0, 2**30, B)
    moved = np.where(rng.integers(0, 2, B) == 1, best - best // 50,
                     rng.integers(0, 2**30, B))  # on the 2% bar, and not
    stall = rng.integers(0, 70, B)
    jb, js = jkm._plateau_update(
        jnp.asarray(act), *(jnp.asarray(a, jnp.int32)
                            for a in (moved, best, stall)))
    tb, ts = tkk.plateau_update(
        *(torch.from_numpy(a) for a in (act, moved, best, stall)))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _update_operands(seed=3, B=4, d=3, k=6, n_max=50):
    rng = np.random.default_rng(seed)
    ptsT = rng.integers(0, 256, (B, d, n_max)).astype(np.int32)
    n = np.array([n_max, n_max - 9, 5, n_max], np.int32)[:B]
    wsum = rng.integers(1, 90, (B, k))
    wsum[0, 2] = wsum[1, 0] = wsum[1, 5] = 0          # empty clusters
    sums = np.concatenate([rng.integers(0, 256, (B, k, d)) * wsum[:, :, None],
                           wsum[:, :, None]], axis=2).astype(np.int64)
    sums[wsum == 0] = 0
    t = torch.from_numpy
    return dict(
        sums=t(sums), moved_k=t(np.array([20, 12, 0, 40], np.int32)[:B]),
        ptsT=t(ptsT), n=t(n),
        cents=t(rng.integers(0, 256, (B, k, d)).astype(np.int32)),
        moved=t(np.array([30, 12, 3, 50], np.int64)[:B]),
        best=t(np.array([30, 12, 9, 50], np.int64)[:B]),
        stall=t(np.array([0, 63, 5, 2], np.int64)[:B]),
        act=t(np.array([1, 1, 0, 1], np.int32)[:B]),
        # the frozen lane stopped counting seven iterations ago
        it=t(np.array([2**20 + 5, 2**20 + 5, 2**20 - 2, 2**20 + 5],
                      np.int64)[:B]),
        thresh=t(np.array([0, 0, 3, 45], np.int64)[:B]))


def test_step_update_ref_matches_jax_pieces():
    """D3's plain version: truncated means, JAX's steal for the empty
    clusters, JAX's plateau bookkeeping on the active lanes, the freeze
    rule, the lanes' iteration counts and the zeroed statistics; a frozen
    lane keeps everything it has."""
    ops = _update_operands()
    before = {key: v.clone() for key, v in ops.items()}
    tkk.step_update(**ops, stall_lim=64, max_iters=2**21)
    d, k = ops["ptsT"].shape[1], ops["cents"].shape[1]
    it = int(before["it"][0])
    act = before["act"].numpy() != 0
    for b in range(4):
        if not act[b]:
            for key in ("cents", "sums", "moved_k", "it", "moved", "best",
                        "stall", "act"):
                assert torch.equal(ops[key][b], before[key][b]), key
            continue
        s = before["sums"][b].numpy()
        steal = np.asarray(jkm._steal_indices(k, jnp.int32(it),
                                              jnp.int32(int(before["n"][b]))))
        want = np.where(s[:, d:] == 0, before["ptsT"][b].numpy()[:, steal].T,
                        s[:, :d] // np.maximum(s[:, d:], 1))
        np.testing.assert_array_equal(ops["cents"][b].numpy(), want)
    jb, js = jkm._plateau_update(
        jnp.asarray(act), jnp.asarray(before["moved_k"].numpy()),
        jnp.asarray(before["best"].numpy().astype(np.int32)),
        jnp.asarray(before["stall"].numpy().astype(np.int32)))
    np.testing.assert_array_equal(ops["best"].numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ops["stall"].numpy(), np.asarray(js))
    moved = np.where(act, before["moved_k"].numpy(), before["moved"].numpy())
    np.testing.assert_array_equal(ops["moved"].numpy(), moved)
    live = (moved > before["thresh"].numpy()) & (np.asarray(js) < 64)
    np.testing.assert_array_equal(ops["act"].numpy(), live.astype(np.int32))
    np.testing.assert_array_equal(ops["it"].numpy(),
                                  before["it"].numpy() + act)
    assert not ops["sums"][act].any() and not ops["moved_k"][act].any()
    # lane 1 reached the stall limit; lane 3 fell to its threshold
    assert live.tolist() == [True, False, False, False]


def test_step_update_ref_binds_max_iters_and_idles():
    """At max_iters every lane freezes; with no lane active a step changes
    nothing, not even the iteration count."""
    ops = _update_operands()
    it = int(ops["it"][0])
    tkk.step_update(**ops, stall_lim=64, max_iters=it + 1)
    assert ops["it"].tolist() == [it + 1, it + 1, 2**20 - 2, it + 1]
    assert not ops["act"].any()
    frozen = {key: v.clone() for key, v in ops.items()}
    ops["sums"][0, 0, 0] = 7  # a frozen step's K1 adds nothing; D3 ignores it
    tkk.step_update(**ops, stall_lim=64, max_iters=it + 1)
    for key, v in ops.items():
        if key != "sums":
            assert torch.equal(v, frozen[key]), key


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_step_update_wrapper_rejects(bad):
    ops = _update_operands()
    err = ValueError
    if bad == "dtype":
        ops["moved"], err = ops["moved"].to(torch.int32), TypeError
    elif bad == "shape":
        ops["it"] = ops["it"][:1].contiguous()
    else:
        ops["thresh"] = ops["thresh"].to("meta")
    with pytest.raises(err):
        tkk.step_update(**ops, stall_lim=64, max_iters=10)


def test_assign_stats_out_writes_active_lanes_in_place():
    ptsT, w, cur, cents, n, act = _small_operands(B=3, n=40)
    n[1] = 33
    act[2] = 0
    want = tkk.assign_stats_ref(ptsT, w, cur, cents, n, act)
    cur0 = cur.clone()
    sums = torch.zeros((3, 4, 4), dtype=torch.int64)
    moved = torch.zeros(3, dtype=torch.int32)
    got = tkk.assign_stats(ptsT, w, cur, cents, n, act, pmax=[255] * 3,
                           out=(cur, sums, moved))
    assert got[0] is cur
    assert torch.equal(cur[0], want[0][0])
    assert torch.equal(cur[1, :33], want[0][1, :33])
    assert torch.equal(cur[1, 33:], cur0[1, 33:])   # past n: untouched
    assert torch.equal(cur[2], cur0[2])             # frozen lane: untouched
    assert torch.equal(sums, want[1]) and torch.equal(moved, want[2])


@pytest.mark.parametrize("pmax,k,packed", [
    ([4095, 90, 9, 3], 128, True),   # (d2_bound + 1) * pk == 2^31
    ([4096, 0, 0, 0], 128, False),   # one above
    ([4095, 90, 9, 3], 100, True),   # pk is the power of two >= k
    ([4095, 90, 9, 3], 129, False),
    ([1023, 1023, 255, 255, 255], 128, True),   # 1024^2 voronoi
    ([2039, 1355, 255, 255, 255], 128, True),   # 2040x1356
    ([3839, 2159, 255, 255, 255], 128, False),  # 3840x2160
    ([46340, 0], 1, True),
])
def test_packed_path_choice(pmax, k, packed):
    assert tkk.packed_path(pmax, k) is packed


def _cadence_inputs():
    rng = np.random.default_rng(11)
    few = rng.integers(0, 4, (780, 2))  # 16 distinct points: steals
    return [few, few[:500]] + [rng.integers(0, 256, (600, 2))
                               for _ in range(2)]


@pytest.mark.parametrize("max_iters", [10_000, 3])
def test_drive_check_cadence_does_not_change_results(monkeypatch, max_iters):
    """The host reads the loop's state every _CHECK_EVERY iterations; the
    launches after the last lane froze (or after max_iters) change nothing,
    so every cadence gives the same (iters, cur, cents), and a binding
    max_iters stops the loop exactly there."""
    monkeypatch.setattr(tkm, "_STALL_LIMIT", 2)  # plateaus too
    pts = _cadence_inputs()
    outs = []
    for every in (1, 3, 8):
        monkeypatch.setattr(tkm, "_CHECK_EVERY", every)
        outs.append(tkm.kmeans_batch(pts, 16, max_iters=max_iters,
                                     on_error="collect", device="cpu"))
    for out in outs[1:]:
        _assert_same_lanes(outs[0], out)
    iters = {r[2] for r in outs[0] if not isinstance(r, Exception)}
    if max_iters == 3:
        assert iters == {3}
    else:
        assert max(iters) > 3  # so the bound of 3 binds


def test_voronoi_check_cadence_does_not_change_results(monkeypatch):
    rng = np.random.default_rng(21)
    imgs = rng.integers(0, 256, (2, 24, 30, 3)).astype(np.uint8)
    imgs[1, :12] = 40
    outs = []
    for every in (1, 3, 8):
        monkeypatch.setattr(tkm, "_CHECK_EVERY", every)
        outs.append(tkm.voronoi_centroids_batch(imgs, 16, device="cpu"))
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            np.testing.assert_array_equal(a, b)
