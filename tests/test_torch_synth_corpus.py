"""The port's corpus generator (`cniic_tpu_torch.synth_corpus`) against
`scripts/make_synth_corpus.py`, pixel for pixel (the PNG bytes may differ:
the script writes through PIL, the port through its stdlib writer).

* every generator gives the script's pixels from the same seed;
* every mode of `main` (plain, --div2k, --textured, --midtex, --ns, --4k)
  writes the script's files with the script's pixels, at a small n; the
  fixed full-size modes run with their generators shrunk 20x in both
  modules (the same rng draws, a twentieth of the pixels);
* the first full-size --midtex image, the image of `output_midtex`'s
  `mid_0000` rows, equals the script's.
"""

import os
import sys

import numpy as np
import pytest

from cniic_tpu_torch import image_io, synth_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import make_synth_corpus as script  # noqa: E402

GENERATORS = [
    ("synth", (40, 56), {}),
    ("synth_natural", (40, 56), {}),
    ("synth_textured", (96, 128), {}),
    ("synth_textured", (96, 128), {"brightness": 0.80}),
]


@pytest.mark.parametrize("name,shape,kw", GENERATORS,
                         ids=[f"{g[0]}{'-bright' if g[2] else ''}"
                              for g in GENERATORS])
def test_generators_match_script(name, shape, kw):
    for seed in (7, 1001):
        a = getattr(synth_corpus, name)(np.random.default_rng(seed), *shape,
                                        **kw)
        b = getattr(script, name)(np.random.default_rng(seed), *shape, **kw)
        np.testing.assert_array_equal(a, b)


def test_mixed_cycle_matches_script():
    for i in range(10):
        a = synth_corpus.synth_mixed(np.random.default_rng(1000 + i), i, 72, 72)
        b = script.synth_mixed(np.random.default_rng(1000 + i), i, 72, 72)
        np.testing.assert_array_equal(a, b)


def _pixels(d) -> dict:
    return {f: image_io.load_image(os.path.join(d, f))
            for f in sorted(os.listdir(d))}


MODES = [["3", "40"], ["2", "--div2k"], ["2", "--textured"],
         ["2", "--midtex"], ["11", "--ns", "48"], ["--4k"]]


@pytest.mark.parametrize("args", MODES, ids=lambda a: "-".join(a))
def test_modes_match_script(args, tmp_path, monkeypatch):
    for mod in (synth_corpus, script):
        for name in ("synth_natural", "synth_textured"):
            full = getattr(mod, name)

            def shrunk(rng, h, w, *a, _full=full, **kw):
                return _full(rng, max(h // 20, 24), max(w // 20, 24), *a, **kw)

            if "--ns" not in args:  # --ns takes its side from the command
                monkeypatch.setattr(mod, name, shrunk)
    port_dir, script_dir = tmp_path / "port", tmp_path / "script"
    assert not synth_corpus.main([str(port_dir)] + args)
    monkeypatch.setattr(sys, "argv",
                        ["make_synth_corpus.py", str(script_dir)] + args)
    script.main()
    got, want = _pixels(port_dir), _pixels(script_dir)
    assert list(got) == list(want) and got
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_first_full_size_midtex_image(tmp_path):
    assert not synth_corpus.main([str(tmp_path), "1", "--midtex"])
    got = image_io.load_image(tmp_path / "mid_0000.png")
    want = script.synth_textured(np.random.default_rng(7), 1356, 2040,
                                 brightness=0.80)
    assert got.shape == (1356, 2040, 3)
    np.testing.assert_array_equal(got, want)
