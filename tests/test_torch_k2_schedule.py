"""K2's speculative chunk schedule, modelled on the CPU.

`approx_rle_wide_chunked_ref` runs the four passes of the card's K2 chunk
schedule (speculate, repair, settle, flags) with the kernels' sync rules,
their flag rule (a stream's flag is the OR of the tie marks its settled rows
keep) and their division-free arithmetic (quotients through
`approx_rle.RECIP`). Here it must give, at every chunk size, exactly the
records and flags of K2's plain version (`approx_rle_wide_ref`, one walk a
stream) and JAX's `_wkernel` (through `approx_rle_wide` in interpret mode,
as tests/test_torch_approx_rle.py runs it), tolerance 0, on:

* tests/test_approx_rle_pallas.py's batch (`make_batch`, its first 400
  positions) at allow 0, 2, 4, 16 and 64;
* `seam_batch` at allow 2: a flat stream whose seams never sync, an edge, a
  run closed by the cap exactly at a seam, lengths 0, 1 and around 3c;
* crafted ties at allow 2: (i) one the true walk meets inside a region the
  settle pass re-walks, which must flag its stream; (ii) one only a
  speculative walk meets, which the true walk has left before it, and which
  must not; a tie at a sync point; a flat stream that never syncs.

The reciprocal table is checked against integer division for every
quotient K2 takes. Each JAX run happens once per module.
"""

import numpy as np
import pytest
import torch

from cniic_tpu.ops import approx_rle as jrle
from cniic_tpu_torch.ops import approx_rle as trle
from torch_rle_cases import SPEC_TIE, make_batch, seam_batch, tie_batch

CHUNKS = [1, 2, 7, 32, 64, 1 << 20]  # the last: one walker a stream
CPU = torch.device("cpu")


# name: (input, allow)
CASES = {"make0": ("make", 0), "make2": ("make", 2), "make4": ("make", 4),
         "make16": ("make", 16), "make64": ("make", 64),
         "seams2": ("seams", 2), "ties2": ("ties", 2)}
_memo = {}


def _case(name):
    """(scans, lens, allow) of a case name."""
    kind, allow = CASES[name]
    if kind == "make":
        scans, lens = make_batch(np.random.default_rng(1234))
        return scans[:, :400], np.minimum(lens, 400), allow
    if kind == "seams":
        return (*seam_batch(64, np.random.default_rng(9)), allow)
    return (*tie_batch(np.random.default_rng(2)), allow)


def _inputs(name):
    """(rgb, lens, allow, plain recs, plain flags, JAX runs), once a case."""
    if name not in _memo:
        scans, lens, allow = _case(name)
        rgb, ln = trle._position_major(scans, lens, CPU)
        recs, flags = trle.approx_rle_wide_ref(rgb, ln, allow)
        jax = jrle.approx_rle_wide(scans, lens, allow, interpret=True)
        _memo[name] = (rgb, ln, allow, recs, flags, jax)
    return _memo[name]


def _as_runs(recs, flags, lens):
    """approx_rle_wide's per-stream tuples from records and flags."""
    cols = recs.t().contiguous().numpy()
    out = []
    for j, n in enumerate(lens.tolist()):
        col = cols[j, : n + 1]
        counts, colors, ends = trle._runs(col)
        out.append((counts, colors,
                    bool(ends.size and (col[ends[-1]] >> 25) & 1),
                    bool(flags[j])))
    return out


def _assert_same_runs(got, want):
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"counts {j}")
        np.testing.assert_array_equal(g[1], w[1], err_msg=f"colors {j}")
        assert tuple(g[2:]) == tuple(w[2:]), f"last_forced/flag of {j}"


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", list(CASES))
def test_chunk_schedule_matches_plain_and_jax(name, chunk):
    rgb, ln, allow, recs, flags, jax = _inputs(name)
    got, got_flags, unsynced, walked = trle.approx_rle_wide_chunked_ref(
        rgb, ln, allow, chunk)
    assert torch.equal(got, recs), f"{name} at chunk {chunk}"
    assert torch.equal(got_flags, flags), f"{name} at chunk {chunk}"
    assert not bool((got & trle.TIE).any())
    _assert_same_runs(_as_runs(got, got_flags, ln), jax)
    if chunk >= rgb.shape[0]:
        assert not bool(unsynced.any()) and int(walked.sum()) == 0
    if name.startswith("seams") and chunk < rgb.shape[0]:
        assert bool(unsynced[0].any()) and int(walked[0]) > 0  # flat: no sync
    if name.startswith("ties"):
        _check_tie_premises(rgb, allow, chunk, flags, unsynced, walked)


def _fresh_walk_flags(rgb, j, p0, allow) -> int:
    """K2's flag for stream j walked from a fresh state at p0."""
    sub = rgb[p0:, j:j + 1].contiguous()
    return int(trle.approx_rle_wide_ref(
        sub, torch.tensor([sub.shape[0]], dtype=torch.int32), allow)[1])


def _check_tie_premises(rgb, allow, chunk, flags, unsynced, walked):
    """The crafted ties: (i) flags, (ii) does not; a walk that starts fresh
    at SPEC_TIE meets a tie; the walk of the chunk holding (i)'s tie does
    not, and the settle pass re-walks positions of (i)'s stream."""
    assert flags.tolist() == [1, 0, 1, 0]
    assert _fresh_walk_flags(rgb, 1, SPEC_TIE, allow) == 1
    if chunk < rgb.shape[0]:
        assert _fresh_walk_flags(rgb, 0, 513 // chunk * chunk, allow) == 0
        assert bool(unsynced[0].any()) and int(walked[0]) > 0


def test_reciprocal_table_is_exact():
    """Every quotient K2 takes, 0 <= s <= 65025 and 1 <= n <= 255 (16.6M
    pairs): the table's floor(s / n), its rounding and its f64-exactness
    test equal integer division's."""
    s = np.arange(65026, dtype=np.int64)
    st = torch.from_numpy(s.astype(np.int32))
    for n in range(1, 256):
        nt = torch.full_like(st, n)
        q = trle._recip_quot(st, nt).numpy()
        np.testing.assert_array_equal(q, s // n, err_msg=f"n = {n}")
        r = s % n
        np.testing.assert_array_equal(
            trle._recip_round(st, nt).numpy(), s // n + (2 * r >= n),
            err_msg=f"n = {n}")
        np.testing.assert_array_equal(
            trle._recip_exact(st, nt).numpy(), ((r << 7) % n) == 0,
            err_msg=f"n = {n}")
    assert trle.RECIP[0] == trle.RECIP[1] == 0
    assert (trle.RECIP[2:] < 1 << 32).all()


def test_schedule_stats_on_cpu_come_from_the_model():
    rgb, ln, allow, recs, flags, _ = _inputs("seams2")
    before = (trle.wide_records.launches, trle.wide_records.kernel_launches)
    got, got_flags, seams, unsynced, walked = trle.wide_records_stats(
        rgb, ln, allow, 64)
    assert torch.equal(got, recs) and torch.equal(got_flags, flags)
    assert seams == sum(max(int(n) - 1, 0) // 64 for n in ln)
    assert 0 < unsynced <= seams and walked > 0
    assert trle.wide_records_stats(rgb, ln, allow, 10_000)[2:] == (0, 0, 0)
    for chunk in (7, 10_000):  # the CPU wrapper is the plain version
        got = trle.wide_records(rgb, ln, allow, chunk=chunk)
        assert torch.equal(got[0], recs) and torch.equal(got[1], flags)
    assert (trle.wide_records.launches,
            trle.wide_records.kernel_launches) == before


def test_chunk_is_checked():
    rgb = torch.zeros((10, 2), dtype=torch.int32)
    lens = torch.full((2,), 10, dtype=torch.int32)
    for bad in (0, -3, 2.5):
        with pytest.raises(ValueError, match="chunk"):
            trle.wide_records(rgb, lens, 4, chunk=bad)
        with pytest.raises(ValueError, match="chunk"):
            trle.wide_records_stats(rgb, lens, 4, chunk=bad)
