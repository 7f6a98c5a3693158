"""The port's benchmark (`python -m cniic_tpu_torch.bench`) against the repo's
`bench.py`, on the CPU.

* its suite, trial count and corpus recipe are `bench.py`'s, so the same seed
  gives the same images;
* a run over all nine codecs, its suite shrunk to tiny images, prints one
  JSON line with `bench.py`'s keys plus `package` and `device`, no failures
  and, with no host baseline file, `vs_baseline` null;
* with a host baseline file covering the nine codecs, `vs_baseline` is the
  geomean of the per-codec speedups over it and its kind names the file;
  a file that misses a codec gives null;
* on the same shrunk suite, the per-codec ratio and MSE the port's bench
  prints equal `bench.py`'s, cell by cell;
* the nine full-size cells' (ratio, MSE), as both benches print them, are
  pinned in `FULL_SIZE`; the port's encodes of each cell's first image on
  the CPU give them, but for the two k-means cells, whose plain versions
  take minutes at full size: tests/test_torch_cuda.py checks those on the
  card, as does the bench run there;
* a CUDA run with no card is refused.
"""

import contextlib
import importlib.util
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from cniic_tpu_torch import bench
from cniic_tpu_torch.codecs import from_spec
from cniic_tpu_torch.runner import compute_error

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (ratio %, MSE) of each full-size cell's first image, as bench.py prints
# them: cluster-colors_32 to zip-back from BENCH_r05.json's tail, the first
# four from cniic_tpu on the CPU
FULL_SIZE = {
    "Hufman": ("9.854", "0.0"),
    "delta": ("5.875", "0.0"),
    "hilbert-rle": ("49.861", "0.0"),
    "hilbert-rle-approx_4": ("28.061", "2.5"),
    "cluster-colors_32": ("2.575", "71.5"),
    "voronoi_128": ("0.010", "1258.5"),
    "hilbert-zip": ("17.111", "0.0"),
    "zip-dict": ("14.322", "0.0"),
    "zip-back": ("19.262", "0.0"),
}

# checked on the card (tests/test_torch_cuda.py)
KMEANS_CELLS = ("cluster-colors_32", "voronoi_128")

_CELL = re.compile(r"^(\S+): enc .*, ratio ([0-9.]+)%, MSE ([0-9.]+)")


def cells(stderr: str) -> dict:
    """codec name -> (ratio, MSE) as a bench printed them on stderr."""
    return {m.group(1): m.group(2, 3)
            for m in map(_CELL.match, stderr.splitlines()) if m}


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


TINY = [(s, 40, 2) for s, _, _ in bench.SUITE]


def _tiny_run(mod, argv, baseline=None):
    """(return code, stdout, stderr) of a bench's main() over TINY, one
    trial; `baseline` replaces the port's host baseline file."""
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "SUITE", TINY)
        mp.setattr(mod, "TRIALS", 1)
        if baseline is not None:
            mp.setattr(mod, "BASELINE", baseline)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = mod.main(*argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def tiny_port():
    return _tiny_run(bench, [["--device", "cpu"]],
                     baseline=os.path.join(REPO, "no-such-baseline.json"))


def test_tiny_run_all_nine(tiny_port):
    specs = [s for s, _, _ in bench.SUITE]
    rc, stdout, _ = tiny_port
    assert rc == 0
    out = stdout.strip().splitlines()
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


def test_vs_baseline_reads_the_host_file(tmp_path):
    names = list(FULL_SIZE)
    path = tmp_path / "BASELINE_HOST_H100.json"
    path.write_text(json.dumps({"per_codec": {
        n: {"encode_mps": 1.0, "decode_mps": 1.0} for n in names}}))
    rc, stdout, stderr = _tiny_run(bench, [["--device", "cpu"]],
                                   baseline=str(path))
    assert rc == 0
    res = json.loads(stdout)
    # speedups over 1 MP/s are the rates: their geomean is the value
    assert res["vs_baseline"] == res["value"]
    assert res["vs_baseline_kind"] == "BASELINE_HOST_H100.json"
    assert stderr.count("x host") == 9
    # a file that misses a codec, or a suite a codec failed in, gives null
    enc = {n: 2.0 for n in names}
    base = {n: {"encode_mps": 0.5} for n in names}
    assert bench.vs_baseline(enc, base)[0] == pytest.approx(4.0)
    assert bench.vs_baseline(enc, dict(list(base.items())[1:])) == (None,
                                                                    "none")
    assert bench.vs_baseline(dict(list(enc.items())[1:]), base) == (None,
                                                                    "none")


def test_cuda_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main([])


def test_ratio_and_mse_match_bench_py(jax_bench, tiny_port):
    rc, _, stderr = _tiny_run(jax_bench, [])
    assert rc == 0
    want = cells(stderr)
    assert len(want) == 9 and cells(tiny_port[2]) == want


def test_full_size_cells_match_the_pins():
    """Each cell's first image at full size through the port on the CPU,
    formatted as the benches print it (the k-means cells on the card)."""
    rng = np.random.default_rng(bench.SEED)
    seen = {}
    for spec, side, n_imgs in bench.SUITE:
        imgs = [bench.synth_image(rng, side, side) for _ in range(n_imgs)]
        codec = from_spec(spec, device="cpu")
        if codec.name in KMEANS_CELLS:
            continue
        blob = codec.encode_batch(imgs[:1])[0]
        err = compute_error(imgs[0], codec.decode(blob))
        seen[codec.name] = (f"{len(blob) / (side * side * 24) * 100:.3f}",
                            f"{err:.1f}")
    assert seen == {k: v for k, v in FULL_SIZE.items()
                    if k not in KMEANS_CELLS}

