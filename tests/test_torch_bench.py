"""The port's benchmark (`python -m cniic_tpu_torch.bench`) against the repo's
`bench.py`, on the CPU.

* its suite, trial count and corpus recipe are `bench.py`'s, so the same seed
  gives the same images;
* a run over all nine codecs, its suite shrunk to tiny images, prints one
  JSON line with `bench.py`'s keys plus `package` and `device`, no failures
  and `vs_baseline` null;
* a CUDA run with no card is refused.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from cniic_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location(
        "repo_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_suite_and_corpus_match_bench_py(jax_bench):
    assert bench.SUITE == jax_bench.SUITE
    assert bench.TRIALS == jax_bench.TRIALS
    a, b = np.random.default_rng(bench.SEED), np.random.default_rng(2024)
    for h, w in ((64, 64), (33, 71), (1024, 1024)):
        np.testing.assert_array_equal(bench.synth_image(a, h, w),
                                      jax_bench.synth_image(b, h, w))


def test_tiny_run_all_nine(capsys, monkeypatch):
    specs = [s for s, _, _ in bench.SUITE]
    monkeypatch.setattr(bench, "SUITE", [(s, 40, 2) for s in specs])
    monkeypatch.setattr(bench, "TRIALS", 1)
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    res = json.loads(out[0])
    assert "failures" not in res
    assert res["metric"] == "encode_throughput_geomean_9codecs"
    assert res["vs_baseline"] is None and res["vs_baseline_kind"] == "none"
    assert res["package"] == "cniic_tpu_torch" and res["device"] == "cpu"
    assert len(res["per_codec_mps"]) == 9 == len(res["per_codec_decode_mps"])
    assert res["suite"] == [{"spec": s, "side": 40, "images": 2, "trials": 1}
                            for s in specs]
    # rounded to 3 decimals, a slow codec on a loaded CPU may print 0.0
    assert list(res["per_codec_mps"]) == [
        "Hufman", "delta", "hilbert-rle", "hilbert-rle-approx_4",
        "cluster-colors_32", "voronoi_128", "hilbert-zip", "zip-dict",
        "zip-back"]
    assert all(v >= 0 for v in res["per_codec_mps"].values())


def test_cuda_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main([])
