"""The port's overlapped sweep driver (`cniic_tpu_torch.sweep`): streams
unchanged, held against `scripts/run_sweep.py` and the committed
`output_midtex` matrix.

Ported from tests/test_run_sweep.py (overlap changes ONLY wall-clock: every
CSV is byte-identical to a serial run; the config split is the module's own;
a failed config fails the sweep), plus:

* the port's CSVs equal `scripts/run_sweep.py`'s on JAX-on-CPU byte for
  byte, one config of each of the nine families, k-means included, over a
  3-image corpus of 96x64;
* `diff_rows` reports a missing CSV, a missing row and each differing
  column;
* the full-width pin: `mid_0000` made by the port's generator gives, through
  the port on the CPU, exactly the committed `output_midtex` rows of nine
  configs (the voronoi and the larger cluster-colors rows take the card:
  tests/test_torch_cuda.py and chip_smoke.py phase 7);
* with no card, `--device=cuda` is refused before any config runs.
"""

import os
import sys

import numpy as np
import pytest
import torch

from cniic_tpu_torch import image_io, sweep, synth_corpus
from cniic_tpu_torch.codecs import from_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "output_midtex")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import run_sweep  # noqa: E402

FAMILIES = ["hufman", "delta", "hilbert(rle)", "hilbert(rle(4))",
            "hilbert(zip)", "zip(dict)", "zip(back)", "cluster-colors(16)",
            "voronoi(64)"]
# the committed rows the CPU reproduces at full width in seconds
PINNED = ["hufman", "delta", "hilbert(rle)", "hilbert(rle(4))",
          "hilbert(zip)", "zip(dict)", "zip(back)", "cluster-colors(16)",
          "cluster-colors(64)"]


def _corpus(tmp_path, rng, h, w):
    paths = []
    for i in range(3):
        img = np.zeros((h, w, 3), np.uint8)
        img[:, :, 0] = np.linspace(0, 255, w, dtype=np.uint8)[None, :]
        img[h // 4 + i: h // 2 + i, w // 4: w * 5 // 8] = [200, 40 * i, 60]
        img[h * 3 // 4:, w * 3 // 4:] = rng.integers(
            0, 256, (h - h * 3 // 4, w - w * 3 // 4, 3))
        p = tmp_path / f"img{i}.png"
        image_io.save_png(img, p)
        paths.append(str(p))
    return paths


@pytest.fixture
def corpus(tmp_path, rng):
    return _corpus(tmp_path, rng, 24, 32)


def _run(mode, corpus, out_dir, configs):
    argv = ["--device=cpu", "--batch=2", f"--out={out_dir}",
            f"--configs={','.join(configs)}"] + corpus
    if mode == "serial":
        argv.insert(0, "--serial")
    assert sweep.main(argv) == 0


def _csvs(d) -> dict:
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))
            if n.endswith(".csv")}


def test_overlapped_csvs_byte_identical_to_serial(tmp_path, corpus):
    # one config per queue family: host-C, hilbert, and both k-means codecs
    configs = ["hufman", "hilbert(rle)", "cluster-colors(4)", "voronoi(8)"]
    _run("serial", corpus, str(tmp_path / "ser"), configs)
    _run("overlap", corpus, str(tmp_path / "ovl"), configs)
    ser, ovl = _csvs(tmp_path / "ser"), _csvs(tmp_path / "ovl")
    assert len(ser) == len(configs)
    assert ser == ovl


def test_config_split_routes_kmeans_to_device_queue():
    dev, host = sweep.split_configs(
        ["hufman", "voronoi(8)", "cluster-colors(4)", "ccol(4)",
         "zip(dict)"])
    assert dev == ["voronoi(8)", "cluster-colors(4)", "ccol(4)"]
    assert host == ["hufman", "zip(dict)"]
    # default split = the full matrix lists, the script's 22 configs
    dev, host = sweep.split_configs()
    assert len(dev) == 11 and len(host) == 11
    assert (dev, host) == run_sweep.split_configs()


def test_failed_config_fails_the_sweep(tmp_path, corpus):
    # an unknown spec raises inside the queue; the sweep records it and
    # exits non-zero instead of silently dropping the queue
    argv = ["--serial", "--device=cpu", "--batch=2",
            f"--out={tmp_path / 'out'}", "--configs=hufman,no-such-codec"
            ] + corpus
    assert sweep.main(argv) == 1
    # the healthy config still ran
    assert (tmp_path / "out" / "Hufman.csv").exists()


def test_csvs_equal_jax_sweep(tmp_path, rng, monkeypatch):
    corpus = _corpus(tmp_path, rng, 64, 96)
    configs = ",".join(FAMILIES)
    monkeypatch.setattr(sys, "argv", [
        "run_sweep.py", "--batch=2", f"--out={tmp_path / 'jax'}",
        f"--configs={configs}"] + corpus)
    assert run_sweep.main() == 0
    _run("overlap", corpus, str(tmp_path / "ovl"), FAMILIES)
    _run("serial", corpus, str(tmp_path / "ser"), FAMILIES)
    want = _csvs(tmp_path / "jax")
    assert len(want) == len(FAMILIES)
    assert _csvs(tmp_path / "ovl") == want
    assert _csvs(tmp_path / "ser") == want


def test_diff_rows_reports_each_difference(tmp_path):
    want, got = tmp_path / "want", tmp_path / "got"
    want.mkdir()
    got.mkdir()
    head = "name,compressed_size,compression_ratio,error\n"
    (want / "a.csv").write_text(head + "d/x.png,10,1.5,0.0\n"
                                "d/y.png,20,2.5,3.25\n")
    (got / "a.csv").write_text(head + "e/x.png,10,1.5,0.0\n"
                               "e/y.png,20,2.5,3.5\n")
    assert sweep.diff_rows(got, want, ["a"], images=["x.png"]) == []
    assert sweep.diff_rows(got, want, ["a"]) == [
        "a y.png: error 3.5 != 3.25 (reference)"]
    (want / "b.csv").write_text(head + "d/x.png,1,1,1\n")
    assert sweep.diff_rows(got, want, ["b"]) == [f"b: no CSV in {got}"]
    assert sweep.diff_rows(got, want, ["a"], images=["z.png"]) == [
        f"a z.png: no row in {want}"]


def test_midtex_rows_at_full_width(tmp_path):
    """`mid_0000` through the port's overlapped sweep on the CPU reproduces
    the committed rows exactly (the committed PNGs are not the images the
    CSVs were computed from; the generator remakes them)."""
    assert not synth_corpus.main([str(tmp_path / "midtex"), "1", "--midtex"])
    out = tmp_path / "out"
    assert sweep.main(["--device=cpu", "--batch=8", f"--out={out}",
                       f"--configs={','.join(PINNED)}",
                       str(tmp_path / "midtex" / "mid_0000.png")]) == 0
    names = [from_spec(c, device="cpu").name for c in PINNED]
    assert sweep.diff_rows(out, REF, names, images=["mid_0000.png"]) == []


def test_cuda_refused_without_a_card(tmp_path, corpus, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    assert sweep.main(["--device=cuda", f"--out={tmp_path / 'out'}"]
                      + corpus) == 1
    assert "Device unavailable" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()
