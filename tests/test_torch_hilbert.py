"""The port's scan module and `--special=hilbert` against the JAX package,
on the CPU.

* `scan_coords`, `scan_indices`, `inverse_indices`, `linearize` and
  `scatter` equal `cniic_tpu.hilbert`'s on 1×n, n×1, odd and 2040×1356
  shapes, under both curve providers (CNIIC_CURVE = gilbert, snake);
* the pure-Python twin equals the C curve;
* `--special=hilbert` writes the same three CSVs as `cniic_tpu`'s CLI,
  including the reference's `next_power_of_two() >> 1` quirk.
"""

import csv
import os

import numpy as np
import pytest

from cniic_tpu import cli as jax_cli
from cniic_tpu import hilbert as jax_hilbert
from cniic_tpu_torch import cli, hilbert, image_io

SHAPES = [(1, 1), (1, 37), (41, 1), (13, 17), (31, 47), (64, 64),
          (2040, 1356)]


@pytest.mark.parametrize("curve", ["gilbert", "snake"])
@pytest.mark.parametrize("w,h", SHAPES)
def test_scan_matches_jax(monkeypatch, curve, w, h):
    monkeypatch.setenv("CNIIC_CURVE", curve)
    assert hilbert.curve_name() == curve
    np.testing.assert_array_equal(hilbert.scan_coords(w, h),
                                  jax_hilbert.scan_coords(w, h))
    idx = hilbert.scan_indices(w, h)
    np.testing.assert_array_equal(idx, jax_hilbert.scan_indices(w, h))
    np.testing.assert_array_equal(hilbert.inverse_indices(w, h),
                                  jax_hilbert.inverse_indices(w, h))
    assert np.unique(idx).size == w * h
    rng = np.random.default_rng(w * 7919 + h)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    scan = hilbert.linearize(img)
    np.testing.assert_array_equal(scan, jax_hilbert.linearize(img))
    np.testing.assert_array_equal(hilbert.scatter(scan, w, h), img)
    # the non-uint8 / non-RGB fallbacks of both functions
    wide = img.astype(np.int16)[..., :2]
    np.testing.assert_array_equal(hilbert.linearize(wide),
                                  jax_hilbert.linearize(wide))
    np.testing.assert_array_equal(
        hilbert.scatter(hilbert.linearize(wide), w, h), wide)


@pytest.mark.parametrize("w,h", [(5, 3), (13, 17), (31, 4), (1, 9)])
def test_python_twin_matches_native(w, h):
    assert (list(hilbert.gilbert_py(w, h))
            == [tuple(p) for p in hilbert.scan_coords(w, h).tolist()])


def test_unknown_curve_rejected(monkeypatch):
    monkeypatch.setenv("CNIIC_CURVE", "lebesgue")
    with pytest.raises(ValueError, match="unknown curve"):
        hilbert.curve_name()


def _special_csvs(main, png, workdir, monkeypatch):
    os.makedirs(workdir)
    monkeypatch.chdir(workdir)
    assert main(["--special=hilbert", png]) == 0
    stem = os.path.splitext(os.path.basename(png))[0]
    return {kind: open(f"output/{stem}.{kind}.hilbert.csv", "rb").read()
            for kind in ("rect", "small", "large")}


@pytest.mark.parametrize("h,w", [(9, 14), (64, 64), (64, 65), (1, 12)])
def test_special_hilbert_matches_jax(tmp_path, monkeypatch, h, w):
    """Byte-identical CSVs. 64x64 is the power-of-two quirk: the 'largest
    inscribed' square is 32, not 64; 64x65 gives min(64, 32) = 32 too; a
    dimension of 1 gives a header-only 'small' CSV."""
    rng = np.random.default_rng(h * 100 + w)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    png = str(tmp_path / "img.png")
    image_io.save_png(img, png)
    got = _special_csvs(cli.main, png, tmp_path / "port", monkeypatch)
    want = _special_csvs(jax_cli.main, png, tmp_path / "jax", monkeypatch)
    assert got == want
    rows = {k: list(csv.reader(v.decode().splitlines())) for k, v in got.items()}
    for kind, r in rows.items():
        assert r[0] == ["red", "blue", "green"], kind  # the reference's header
    assert len(rows["rect"]) == len(rows["large"]) == h * w + 1
    side = {(9, 14): 8, (64, 64): 32, (64, 65): 32, (1, 12): 0}[(h, w)]
    assert len(rows["small"]) == side * side + 1


def test_special_refusals(capsys):
    assert cli.main(["--special=bogus"]) == 1
    assert "Invalid special command" in capsys.readouterr().err
    assert cli.main([]) == 1
    assert "--special=hilbert" in capsys.readouterr().err
