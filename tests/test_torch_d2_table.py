"""D2's root table, modelled on the CPU.

`root_table_ref` is the plain version of the card's table build and
`walk_table_model` a plain model of its table walk. At K in {0, 1, 5, 12}
the model must give exactly `walk_ref`'s exits, counts, frozen flag and
pass-2 ids, and JAX's `_pass1`/`_pass2` (tolerance 0), on a small Hufman
stream, a delta stream, the 40-level deep-code stream, a trie with a
missing child, a payload ending mid-code, and step budgets of 5, 13 and 100
that cut codes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cniic_tpu.ops import hufdec as jax_hufdec
from cniic_tpu_torch import huffman
from cniic_tpu_torch.codecs import delta as delta_codec
from cniic_tpu_torch.ops import hufdec

KS = [0, 1, 5, 12]


def _tree_stream(freqs, ids):
    book = huffman.build_codebook(freqs)
    tree = huffman.serialize_tree(book, np.zeros((freqs.size, 1), np.uint8))
    payload = huffman.encode_payload(ids.astype(np.int32), book, device=False)
    left, right, symbol, _, _ = huffman.parse_tree(
        np.frombuffer(tree, np.uint8), 1)
    return (np.frombuffer(payload, np.uint8),
            hufdec._lr2(left, right, symbol), ids.size)


def _missing_child():
    """A trie whose node 2 has no right child: left/right/symbol arrays as
    `_lr2` takes them (child -1 = none), so lr2 holds a 0 there and bits
    "11" return to the root with no symbol."""
    left = np.array([1, -1, 3, -1, -1])
    right = np.array([2, -1, -1, -1, -1])
    symbol = np.array([-1, 0, -1, 1, -1])
    lr2 = hufdec._lr2(left, right, symbol)
    assert 0 in lr2[2:].tolist()
    rng = np.random.default_rng(17)
    pay = rng.integers(0, 256, 1500).astype(np.uint8)
    return pay, lr2, None


def _streams():
    rng = np.random.default_rng(21)
    u = 300
    huf = _tree_stream(rng.integers(1, 1000, u).astype(np.uint64),
                       rng.integers(0, u, 6000))
    img = np.clip(rng.integers(0, 60, 3) + rng.integers(
        -3, 4, (48, 64, 3)).cumsum(1), 0, 255).astype(np.uint8)
    _, dcounts, dinv = delta_codec._scan_stats(img)
    delta = _tree_stream(dcounts, dinv)
    deep = _tree_stream((2.0 ** np.arange(40)).astype(np.uint64),
                        rng.integers(0, 40, 3000))
    cut = (huf[0][: huf[0].size - 3], huf[1], None)  # ends mid-code
    return {"hufman": huf, "delta": delta, "deep": deep,
            "missing child": _missing_child(), "mid-code end": cut}


STREAMS = _streams()


def _lanes(pay, n_steps):
    """Pass-1 lanes as `lanes` builds them, fewer entry offsets for a short
    budget (every lane then stops on the budget)."""
    starts, ends = hufdec.chunk_bounds(pay.size)
    E = hufdec.E if n_steps == hufdec._STEPS else 3
    s1 = (starts[:, None] + np.arange(E, dtype=np.int32)[None]).reshape(-1)
    return s1.astype(np.int32), np.repeat(ends, E), starts, ends


def _walk_root(lr2, K, e):
    """Entry e of the root table, walked one bit at a time in Python."""
    node = 0
    for i in range(K):
        v = int(lr2[2 * node + ((e >> (K - 1 - i)) & 1)])
        if v <= 0:
            return v * 32 + i + 1
        node = v
    return node * 32 + K


@pytest.mark.parametrize("K", [1, 5, 12])
@pytest.mark.parametrize("name", ["hufman", "missing child", "deep"])
def test_root_table_ref(name, K):
    lr2 = STREAMS[name][1]
    got = hufdec.root_table_ref(torch.from_numpy(lr2), K).numpy()
    want = [_walk_root(lr2, K, e) for e in range(1 << K)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_steps", [5, 13, 100, hufdec._STEPS])
@pytest.mark.parametrize("name", list(STREAMS))
def test_table_walk_matches_walk_ref_and_jax(name, n_steps):
    pay, lr2, n = STREAMS[name]
    total = 8 * pay.size
    s1, e1, starts, ends = _lanes(pay, n_steps)
    args = [torch.from_numpy(a.copy()) for a in (pay, lr2, s1, e1)]
    want = hufdec.walk_ref(*args, total, n_steps=n_steps)
    j_exits, j_cnts, j_ok = jax_hufdec._pass1(
        jnp.asarray(pay), jnp.asarray(lr2), jnp.asarray(s1), jnp.asarray(e1),
        jnp.int32(total), n_steps)
    np.testing.assert_array_equal(want[0].numpy(), np.asarray(j_exits))
    np.testing.assert_array_equal(want[1].numpy(), np.asarray(j_cnts))
    assert want[2] == bool(j_ok)
    for K in KS:
        got = hufdec.walk_table_model(*args, total, n_steps=n_steps, K=K)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2] == want[2] and got[3] is None, K
    if n_steps != hufdec._STEPS:
        return
    # pass 2 from the true entry offsets, where pass 1 composes; a stream
    # with no symbol count of its own decodes all it holds
    composed = hufdec.compose(want[0], want[1], 0)
    if composed is not None and n is None:
        cnts = want[1].reshape(-1, hufdec.E).numpy()
        n = int(cnts[np.arange(cnts.shape[0]), composed[0]].sum())
    composed = composed and hufdec.compose(want[0], want[1], n)
    if composed is None:
        assert name == "deep"  # a code deeper than E crossed a chunk seam
        return
    offs, out_start = composed
    args2 = [torch.from_numpy(a.copy()) for a in (pay, lr2, starts + offs,
                                                   ends)]
    ost = torch.from_numpy(out_start)
    want2 = hufdec.walk_ref(*args2, total, out_start=ost, n_symbols=n)
    j_ids, j_cnt = jax_hufdec._pass2(
        jnp.asarray(pay), jnp.asarray(lr2), jnp.asarray(starts + offs),
        jnp.asarray(ends), jnp.int32(total), jnp.asarray(out_start),
        hufdec._STEPS, n)
    np.testing.assert_array_equal(want2[3].numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(want2[1].numpy(), np.asarray(j_cnt))
    for K in KS:
        got2 = hufdec.walk_table_model(*args2, total, out_start=ost,
                                       n_symbols=n, K=K)
        assert torch.equal(got2[3], want2[3]), K
        assert torch.equal(got2[1], want2[1]) and got2[2] == want2[2], K


def test_walk_checks_K():
    pay = torch.zeros(600, dtype=torch.uint8)
    lr2 = torch.tensor([-1, -2], dtype=torch.int32)
    st = torch.zeros(4, dtype=torch.int32)
    for bad in (-1, 15, 2.5):
        with pytest.raises(ValueError, match="K"):
            hufdec.walk(pay, lr2, st, st, 8 * 600, K=bad)
    before = (hufdec.walk.launches, hufdec.root_table.launches)
    hufdec.walk(pay, lr2, st, st, 8 * 600, K=12)  # CPU: the plain version
    assert torch.equal(hufdec.root_table(lr2, 3),
                       hufdec.root_table_ref(lr2, 3))
    assert (hufdec.walk.launches, hufdec.root_table.launches) == before
    for bad in (0, 15):
        with pytest.raises(ValueError, match="K"):
            hufdec.root_table(lr2, bad)


def test_walk_checks_table():
    pay, lr2, _ = STREAMS["hufman"]
    s1, e1, _, _ = _lanes(pay, hufdec._STEPS)
    args = [torch.from_numpy(a.copy()) for a in (pay, lr2, s1, e1)]
    table = hufdec.root_table(args[1], 12)
    for K, bad in ((0, table), (5, table), (12, table.long()),
                   (12, table[:-1])):
        with pytest.raises(ValueError, match="table"):
            hufdec.walk(*args, 8 * pay.size, K=K, table=bad)
    got = hufdec.walk(*args, 8 * pay.size, K=12, table=table)
    want = hufdec.walk_ref(*args, 8 * pay.size)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2]
