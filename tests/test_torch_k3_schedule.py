"""K3's speculative chunk schedule, modelled on the CPU.

`approx_rle_batch_chunked_ref` runs the three passes of the card's chunk
schedule (speculate, repair, settle) with the kernels' sync rules. Here it
must give, at every chunk size, exactly the records of K3's plain version
(`approx_rle_batch_ref`, one walk a stream) and of JAX's `_run` in
interpret mode (tolerance 0), on:

* tests/test_approx_rle_pallas.py's batch (`make_batch`) at allow 4 and 32,
  and the f32-rounding streams (`fma_batch`) at allow 32 and 64;
* `seam_batch`: a flat stream whose seams never sync, a flat stream with
  one edge, a run closed by the cap exactly at a seam, and lengths 0, 1,
  3c and 3c +- 1.

Each JAX run happens once per module.
"""

import numpy as np
import pytest
import torch

from cniic_tpu.ops import approx_rle as jrle
from cniic_tpu_torch.ops import approx_rle as trle
from torch_rle_cases import fma_batch, make_batch, seam_batch

CHUNKS = [1, 2, 7, 64, 255, 256, 1 << 20]  # the last: one walker a stream


def _case(name):
    if name.startswith("make"):
        return make_batch(np.random.default_rng(1234))
    if name.startswith("fma"):
        scans, lens, _ = fma_batch(int(name[3:]), np.random.default_rng(5))
        return scans, lens
    return seam_batch(int(name.split("_")[1]), np.random.default_rng(9))


CASES = {"make4": 4.0, "make32": 32.0, "fma32": 32.0, "fma64": 64.0}
_jax = {}


def _jax_records(name, allow, scans, lens):
    """JAX's `_run` (interpret mode) as [L+1, B] records, once a case."""
    key = (name, allow)
    if key not in _jax:
        B, L, _ = scans.shape
        n_blocks = (L + 1 + jrle.BLOCK - 1) // jrle.BLOCK
        packed = np.zeros((jrle.LANES, n_blocks * jrle.BLOCK), np.int32)
        ch = scans.astype(np.int32)
        packed[:B, :L] = (ch[..., 0] << 16) | (ch[..., 1] << 8) | ch[..., 2]
        ln = np.zeros((jrle.LANES, 1), np.int32)
        ln[:B, 0] = lens
        out = np.asarray(jrle._run(np.asarray([allow], np.float32), ln,
                                   packed, n_blocks, interpret=True))
        _jax[key] = torch.from_numpy(out[:B, : L + 1].T.copy())
    return _jax[key]


def _check(name, allow, chunk):
    scans, lens = _case(name)
    assert scans.shape[0] <= jrle.LANES
    rgb, ln = trle._position_major(scans, lens, torch.device("cpu"))
    got, unsynced, walked = trle.approx_rle_batch_chunked_ref(rgb, ln, allow,
                                                              chunk)
    want = trle.approx_rle_batch_ref(rgb, ln, allow)
    assert torch.equal(got, want), f"{name} at chunk {chunk}"
    assert torch.equal(got, _jax_records(name, allow, scans, lens))
    return got, unsynced, walked


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", list(CASES))
def test_chunk_schedule_matches_plain_and_jax(name, chunk):
    _check(name, CASES[name], chunk)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunk_schedule_on_seam_streams(chunk):
    """The crafted seam streams at allow 2: equal to the one-walker records
    and JAX's; a flat stream's seams sync only where the chunk is a
    multiple of the cap, and the settle pass then re-walks it."""
    c = min(chunk, 256)
    got, unsynced, walked = _check(f"seams_{c}", 2.0, chunk)
    seam = -(-300 // c) * c
    assert int(got[seam, 2]) != 0 and int(got[seam - 255, 2]) != 0
    assert int(got[seam - 254: seam, 2].count_nonzero()) == 0  # one capped run
    if chunk >= 1 << 20:
        assert not bool(unsynced.any()) and int(walked.sum()) == 0
    elif c % 255:
        assert bool(unsynced[0].any()) and int(walked[0]) > 0
    else:
        assert not bool(unsynced[0].any())


def test_schedule_stats_on_cpu_come_from_the_model():
    scans, lens = seam_batch(256, np.random.default_rng(9))
    rgb, ln = trle._position_major(scans, lens, torch.device("cpu"))
    before = (trle.batch_records.launches, trle.batch_records.kernel_launches)
    recs, seams, unsynced, walked = trle.batch_records_stats(rgb, ln, 2.0, 256)
    assert torch.equal(recs, trle.approx_rle_batch_ref(rgb, ln, 2.0))
    # seams inside the streams: (len - 1) // 256 each
    assert seams == sum(max(int(n) - 1, 0) // 256 for n in lens)
    assert 0 < unsynced <= seams and walked > 0
    assert trle.batch_records_stats(rgb, ln, 2.0, 10_000)[1:] == (0, 0, 0)
    assert (trle.batch_records.launches,
            trle.batch_records.kernel_launches) == before


def test_chunk_is_checked():
    rgb = torch.zeros((10, 2), dtype=torch.int32)
    lens = torch.full((2,), 10, dtype=torch.int32)
    for bad in (0, -3, 2.5):
        with pytest.raises(ValueError, match="chunk"):
            trle.batch_records(rgb, lens, 4.0, chunk=bad)
        with pytest.raises(ValueError, match="chunk"):
            trle.batch_records_stats(rgb, lens, 4.0, chunk=bad)
