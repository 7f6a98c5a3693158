"""K2 and K3's plain versions and the approx-RLE entry points against the JAX
package, on the CPU.

The JAX kernels run as tests/test_approx_rle_pallas.py runs them (Pallas in
interpret mode), at its sizes; each JAX run happens once per module.

* K2's plain version (through `approx_rle_wide`) equals JAX's records,
  `last_forced` markers and boundary-tie flags, including a crafted tie and
  300 streams;
* K3's plain version (through `approx_rle_batch`) equals JAX's records at
  allow 1, 4 and 16, and at allow 32 and 64 on streams built so that the
  rounding of the distance sum decides;
* `approx_rle_chunked` equals both the exact-f64 native engine and JAX's
  chunked encoder byte for byte, flagged-chunk replays and allow 65-200
  included;
* the wrappers refuse what their kernels do not take, and a CUDA device
  with no card is refused, never replaced by the CPU.
"""

import numpy as np
import pytest
import torch

from cniic_tpu import native as jax_native
from cniic_tpu.ops import approx_rle as jrle
from cniic_tpu_torch import native
from cniic_tpu_torch.ops import approx_rle as trle
from torch_rle_cases import FMA_CASES, TIE, fma_batch, make_batch


@pytest.fixture(scope="module")
def batch():
    return make_batch(np.random.default_rng(1234))


def _assert_same_runs(got, want):
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"counts {j}")
        np.testing.assert_array_equal(g[1], w[1], err_msg=f"colors {j}")
        assert tuple(g[2:]) == tuple(w[2:]), f"last_forced/flag of {j}"


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("allow", [1, 4, 16])
def test_wide_plain_matches_jax(batch, allow):
    scans, lens = batch
    got = trle.approx_rle_wide(scans, lens, allow, device="cpu")
    _assert_same_runs(got, jrle.approx_rle_wide(scans, lens, allow,
                                                interpret=True))
    if allow == 4:
        assert any(g[3] for g in got)  # this batch does flag a stream


def test_wide_plain_matches_jax_many_streams():
    rng = np.random.default_rng(77)
    B, L = 300, 520
    lens = rng.integers(1, L + 1, B).astype(np.int32)
    scans = np.zeros((B, L, 3), np.uint8)
    for j in range(B):
        scans[j, : lens[j]] = np.clip(
            rng.integers(0, 30, 3)
            + rng.integers(-2, 3, (int(lens[j]), 3)).cumsum(0), 0, 255)
    got = trle.approx_rle_wide(scans, lens, 4, device="cpu")
    _assert_same_runs(got, jrle.approx_rle_wide(scans, lens, 4,
                                                interpret=True))
    assert sum(g[3] for g in got) > 0


def test_wide_plain_last_forced_and_crafted_tie():
    """bit 25 on a stream-end close but not on a cap close, and the crafted
    tie of test_approx_rle_pallas.py (torch_rle_cases.TIE) flags its
    stream."""
    rng = np.random.default_rng(3)
    flat = np.full((2, 600, 3), 9, np.uint8)
    tie = rng.integers(40, 240, (1, 600, 3)).astype(np.uint8)
    tie[0, 200:204] = TIE
    scans = np.concatenate([flat, tie])
    lens = np.array([600, 510, 600])
    got = trle.approx_rle_wide(scans, lens, 2, device="cpu")
    _assert_same_runs(got, jrle.approx_rle_wide(scans, lens, 2,
                                                interpret=True))
    assert got[0][0].tolist() == [255, 255, 90] and got[0][2]
    assert got[1][0].tolist() == [255, 255] and not got[1][2]
    assert got[2][3] and not got[0][3]


def test_wide_plain_allow_64():
    rng = np.random.default_rng(64)
    scans = rng.integers(0, 256, (4, 900, 3)).astype(np.uint8)
    scans[1] = np.clip(rng.integers(60, 200, 3)
                       + rng.integers(-9, 10, (900, 3)).cumsum(0), 0, 255)
    lens = np.array([900, 900, 17, 0])
    _assert_same_runs(trle.approx_rle_wide(scans, lens, 64, device="cpu"),
                      jrle.approx_rle_wide(scans, lens, 64, interpret=True))


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("allow", [1.0, 4.0, 16.0])
def test_batch_plain_matches_jax(batch, allow):
    scans, lens = batch
    _assert_same_runs(trle.approx_rle_batch(scans, lens, allow, device="cpu"),
                      jrle.approx_rle_batch(scans, lens, allow,
                                            interpret=True))


@pytest.mark.parametrize("allow", [32.0, 64.0])
def test_batch_plain_matches_jax_at_fma_boundary(allow):
    """K3's plain version forms the distance sum as fma(t2, t2, fma(t0, t0,
    t1 * t1)) rounded to f32 at each step, the form XLA gives the TPU
    kernel's `t0*t0 + t1*t1 + t2*t2`. These streams put a term above 2^24
    at the threshold, where that form and the unfused sum decide
    differently: the port must decide as JAX does."""
    f32, f64 = np.float32, np.float64
    for a, c, *t in FMA_CASES:
        sq = np.asarray(t, f64) ** 2
        unfused = f32(f32(f32(sq[0]) + f32(sq[1])) + f32(sq[2]))
        assert unfused <= f32(f32(a * c) ** 2)  # the unfused sum accepts
    scans, lens, runs = fma_batch(allow, np.random.default_rng(int(allow)))
    got = trle.approx_rle_batch(scans, lens, allow, device="cpu")
    _assert_same_runs(got, jrle.approx_rle_batch(scans, lens, allow,
                                                 interpret=True))
    # the first run ends before x: the fused form rejected it
    assert [int(g[0][0]) for g in got] == runs


def test_batch_plain_run_cap_and_flush():
    scans = np.full((1, 600, 3), 9, np.uint8)
    (counts, colors), = trle.approx_rle_batch(scans, np.array([600]), 2.0,
                                              device="cpu")
    assert counts.tolist() == [255, 255, 90]
    assert (colors == 9).all()


# ---------------------------------------------------------------------------
# the chunked encoder
# ---------------------------------------------------------------------------

def _chunk_scan(rng, kind, n):
    if kind == "walk":
        scan = np.clip(rng.integers(0, 30, 3)
                       + rng.integers(-2, 3, (n, 3)).cumsum(0), 0, 255)
    elif kind == "flat":
        scan = np.full((n, 3), 9)
    elif kind == "rand":
        scan = rng.integers(0, 256, (n, 3))
    else:
        scan = np.clip(rng.integers(0, 30, 3)
                       + rng.integers(-1, 2, (n, 3)).cumsum(0), 0, 255)
        scan[2000:4000] = 7  # flat region crossing several chunk seams
    return scan.astype(np.uint8)


@pytest.mark.parametrize("kind,n", [
    ("walk", 5000), ("flat", 5000), ("rand", 3000), ("walk", 300),
    ("mixed", 7777), ("flat", 2048), ("flat", 1),
])
def test_chunked_matches_native_and_jax(kind, n):
    scan = _chunk_scan(np.random.default_rng(n), kind, n)
    for allow in (1, 4, 16):
        want = jax_native.approx_rle_encode(scan, float(allow))
        got = trle.approx_rle_chunked(scan, allow, chunk=1024, device="cpu")
        jax = jrle.approx_rle_chunked(scan, allow, chunk=1024, interpret=True)
        for g, w, j in zip(got, want, jax):
            np.testing.assert_array_equal(g, w, err_msg=f"{kind} {allow}")
            np.testing.assert_array_equal(g, j, err_msg=f"{kind} {allow}")


def test_chunked_through_flagged_chunk():
    rng = np.random.default_rng(1234)
    scan = rng.integers(40, 240, (2048, 3)).astype(np.uint8)
    scan[700:704] = TIE
    chunks = scan.reshape(4, 512, 3)
    spec = trle.approx_rle_wide(chunks, np.full(4, 512), 2, device="cpu")
    assert spec[1][3], "the crafted tie must flag its chunk"
    got = trle.approx_rle_chunked(scan, 2, chunk=512, device="cpu")
    want = native.approx_rle_encode(scan, 2.0)
    jax = jrle.approx_rle_chunked(scan, 2, chunk=512, interpret=True)
    for g, w, j in zip(got, want, jax):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)


def test_chunked_beyond_clamp_bound_is_native():
    scan = np.random.default_rng(5).integers(0, 256, (3000, 3)).astype(np.uint8)
    before = trle.wide_records.launches
    for allow in (65, 100, 200):
        got = trle.approx_rle_chunked(scan, allow, device="cpu")
        want = jax_native.approx_rle_encode(scan, float(allow))
        jax = jrle.approx_rle_chunked(scan, allow, interpret=True)
        for g, w, j in zip(got, want, jax):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, j)
    assert trle.wide_records.launches == before


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def test_wrappers_refuse_bad_inputs():
    rgb = torch.zeros((10, 3), dtype=torch.int32)
    lens = torch.full((3,), 10, dtype=torch.int32)
    with pytest.raises(ValueError):
        trle.wide_records(rgb, lens, 65)
    with pytest.raises(ValueError):
        trle.wide_records(rgb, lens, 2.5)
    with pytest.raises(ValueError):
        trle.wide_records(torch.zeros((4, 1025), dtype=torch.int32),
                          torch.zeros(1025, dtype=torch.int32), 4)
    with pytest.raises(TypeError):
        trle.batch_records(rgb.to(torch.int64), lens, 4.0)
    with pytest.raises(ValueError):
        trle.batch_records(rgb, lens[:2], 4.0)
    with pytest.raises(ValueError):
        trle.batch_records(rgb, lens + 1, 4.0)  # longer than the array
    with pytest.raises(ValueError):
        trle.batch_records(rgb.t(), lens, 4.0)  # not contiguous
    with pytest.raises(ValueError, match="2\\^24|16777216"):
        trle.batch_records(torch.zeros((trle.MAX_BATCH_LEN + 1, 1),
                                       dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32), 4.0)
    with pytest.raises(ValueError):
        trle.approx_rle_wide(np.zeros((1, 5, 3), np.uint8), [5], 65,
                             device="cpu")


def test_cpu_wrappers_count_no_launch_and_cuda_is_refused(batch):
    scans, lens = batch
    before = (trle.wide_records.launches, trle.batch_records.launches)
    trle.approx_rle_wide(scans[:2, :50], [50, 40], 4, device="cpu")
    trle.approx_rle_batch(scans[:2, :50], [50, 40], 4.0, device="cpu")
    assert (trle.wide_records.launches, trle.batch_records.launches) == before
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="is_available"):
        trle.approx_rle_batch(scans[:2, :50], [50, 40], 4.0)  # cuda default
