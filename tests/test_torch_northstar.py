"""The port's north-star corpus driver (`cniic_tpu_torch.northstar`):
accounting and checkpoint/resume.

Ported from tests/test_northstar.py, test for test: a killed run continues
from the last completed chunk with identical accumulators, --finalize
re-aggregates without re-measuring, --remeasure splices legs (with
--trials=N medians and its determinism check), and a corpus change
invalidates the checkpoint. Plus: the accounting (images, MP, bytes, MSEs)
equals `scripts/experiments/northstar.py`'s on JAX-on-CPU, and with no card
`--device=cuda` is refused.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from cniic_tpu_torch import image_io, northstar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "experiments"))
import northstar as jax_northstar  # noqa: E402

SMALL_SPECS = ["hufman", "delta", "cluster-colors(4)"]


@pytest.fixture
def corpus(tmp_path, rng):
    paths = []
    for i in range(6):
        img = np.zeros((24, 32, 3), np.uint8)
        img[:, :, 0] = np.linspace(0, 255, 32, dtype=np.uint8)[None, :]
        img[4 + i : 13 + i, 6:22] = [210, 37 * i, 55]
        img[18:, 24:] = rng.integers(0, 256, (6, 8, 3))
        p = tmp_path / f"ns_{i:05d}.png"
        image_io.save_png(img, p)
        paths.append(str(p))
    return paths


def _run(args, monkeypatch):
    monkeypatch.setattr(northstar, "SPECS", SMALL_SPECS)
    return northstar.main(["--device=cpu"] + args)


def _nontiming(d):
    drop = {"encode_geomean_mps", "decode_geomean_mps", "per_codec_mps",
            "per_codec_decode_mps", "per_codec_vs_host", "vs_baseline",
            "suite_encode_s", "host_suite_encode_s_est",
            "suite_wallclock_vs_host", "wall_s"}
    return {k: v for k, v in d.items() if k not in drop}


def test_full_run_accounting(tmp_path, corpus, monkeypatch):
    out = str(tmp_path / "ns.json")
    assert _run(["--chunk=2", f"--out={out}"] + corpus, monkeypatch) == 0
    d = json.load(open(out))
    assert d["corpus"]["images"] == 6
    assert d["per_codec_mean_mse"]["Hufman"] == 0.0
    assert d["per_codec_mean_mse"]["delta"] == 0.0
    assert d["per_codec_mean_mse"]["cluster-colors_4"] > 0.0
    for v in d["per_codec_mean_ratio_pct"].values():
        assert 0.0 < v < 100.0
    # checkpoint left behind records all chunks complete
    ck = json.load(open(out + ".ckpt.json"))
    assert ck["next_chunk"] == 3
    assert all(a["images"] == 6 for a in ck["acc"].values())
    assert all(a["mp"] == pytest.approx(6 * 24 * 32 / 1e6)
               for a in ck["acc"].values())


def test_resume_continues_from_killed_chunk(tmp_path, corpus, monkeypatch):
    out = str(tmp_path / "ns.json")
    args = ["--chunk=2", f"--out={out}"] + corpus
    assert _run(args, monkeypatch) == 0
    first = json.load(open(out))

    # build the exact checkpoint a kill after chunk 2-of-3 leaves behind:
    # a clean run over just the first two chunks produces the same
    # deterministic accumulators (bytes, mse, images, mp) for that prefix
    partial_out = str(tmp_path / "partial.json")
    assert _run(["--chunk=2", f"--out={partial_out}"] + corpus[:4],
                monkeypatch) == 0
    ck = json.load(open(partial_out + ".ckpt.json"))
    assert ck["next_chunk"] == 2
    ck["paths_sha"] = northstar._paths_sha(sorted(corpus))
    json.dump(ck, open(out + ".ckpt.json", "w"))

    assert _run(args + ["--resume"], monkeypatch) == 0
    resumed = json.load(open(out))
    # the resumed run redid exactly the last chunk: image/MP accounting
    # and the deterministic per-image byte sizes land back identical
    assert resumed["corpus"] == first["corpus"]
    assert resumed["per_codec_mean_ratio_pct"] == first["per_codec_mean_ratio_pct"]
    assert resumed["per_codec_mean_mse"] == first["per_codec_mean_mse"]


def test_finalize_reaggregates_without_remeasuring(tmp_path, corpus,
                                                   monkeypatch):
    out = str(tmp_path / "ns.json")
    assert _run(["--chunk=2", f"--out={out}"] + corpus, monkeypatch) == 0
    first = json.load(open(out))

    # a custom baseline: per-codec encode_mps=1.0 makes vs_host == MP/s
    bl = {"host": "test", "per_codec": {
        n: {"encode_mps": 1.0, "decode_mps": 1.0}
        for n in first["per_codec_mps"]}}
    bl_name = str(tmp_path / "BASELINE_TEST_FINALIZE.json")
    with open(bl_name, "w") as fh:
        json.dump(bl, fh)
    os.remove(out)
    assert _run(["--chunk=2", f"--out={out}", "--finalize",
                 f"--baseline={bl_name}"] + corpus, monkeypatch) == 0
    fin = json.load(open(out))
    # no re-measurement: the deterministic accounting is identical, the
    # timing fields come straight from the checkpoint accumulators, and
    # the speedups are renormalized against the named baseline
    assert fin["baseline"] == bl_name
    assert fin["wall_s"] is None
    assert fin["corpus"] == first["corpus"]
    assert fin["per_codec_mean_ratio_pct"] == first["per_codec_mean_ratio_pct"]
    assert fin["per_codec_mps"] == first["per_codec_mps"]
    for n, v in fin["per_codec_vs_host"].items():
        assert v == pytest.approx(fin["per_codec_mps"][n], abs=0.006)
    assert fin["vs_baseline"] == pytest.approx(
        fin["encode_geomean_mps"], rel=0.01)


def test_finalize_refuses_incomplete_checkpoint(tmp_path, corpus,
                                                monkeypatch):
    out = str(tmp_path / "ns.json")
    # a clean run over the 4-image prefix leaves next_chunk=2; presenting
    # the full 6-image corpus to --finalize must refuse (3 chunks needed)
    assert _run(["--chunk=2", f"--out={out}"] + corpus[:4], monkeypatch) == 0
    ck = json.load(open(out + ".ckpt.json"))
    ck["paths_sha"] = northstar._paths_sha(sorted(corpus))
    json.dump(ck, open(out + ".ckpt.json", "w"))
    assert _run(["--chunk=2", f"--out={out}", "--finalize"] + corpus,
                monkeypatch) == 1


def test_remeasure_splices_leg_into_completed_record(tmp_path, corpus,
                                                     monkeypatch):
    out = str(tmp_path / "ns.json")
    assert _run(["--chunk=2", f"--out={out}"] + corpus, monkeypatch) == 0
    first = json.load(open(out))
    ck0 = json.load(open(out + ".ckpt.json"))

    # poison the timing of one leg in the checkpoint: a remeasure of that
    # leg must replace it, while the untouched legs' accumulators (timing
    # included) pass through from the checkpoint exactly
    ck = json.load(open(out + ".ckpt.json"))
    ck["acc"]["cluster-colors_4"]["enc_s"] *= 1000.0
    json.dump(ck, open(out + ".ckpt.json", "w"))

    assert _run(["--chunk=2", f"--out={out}",
                 "--remeasure=cluster-colors(4)"] + corpus, monkeypatch) == 0
    re = json.load(open(out))
    assert _nontiming(re) == _nontiming(first)
    # the poisoned figure (~1000x slower) did not survive
    assert re["per_codec_mps"]["cluster-colors_4"] > \
        first["per_codec_mps"]["cluster-colors_4"] / 100.0
    ck2 = json.load(open(out + ".ckpt.json"))
    assert "re" not in ck2
    assert ck2["next_chunk"] == 3
    for name in ("Hufman", "delta"):
        assert ck2["acc"][name] == ck0["acc"][name]
    assert ck2["acc"]["cluster-colors_4"]["images"] == 6


def test_remeasure_resumes_mid_kill(tmp_path, corpus, monkeypatch):
    out = str(tmp_path / "ns.json")
    assert _run(["--chunk=2", f"--out={out}"] + corpus, monkeypatch) == 0
    first = json.load(open(out))
    full_ck = json.load(open(out + ".ckpt.json"))

    # accumulators a kill after remeasure-chunk 2-of-3 leaves behind: the
    # remeasured leg holds the first two chunks' worth, others are complete
    partial_out = str(tmp_path / "partial.json")
    assert _run(["--chunk=2", f"--out={partial_out}"] + corpus[:4],
                monkeypatch) == 0
    part_acc = json.load(open(partial_out + ".ckpt.json"))["acc"]
    ck = dict(full_ck)
    ck["acc"] = dict(full_ck["acc"])
    ck["acc"]["cluster-colors_4"] = part_acc["cluster-colors_4"]
    ck["re"] = {"specs": ["cluster-colors(4)"], "next_chunk": 2}
    json.dump(ck, open(out + ".ckpt.json", "w"))

    # plain --resume and --finalize must refuse the unfinished remeasure
    assert _run(["--chunk=2", f"--out={out}", "--resume"] + corpus,
                monkeypatch) == 1
    assert _run(["--chunk=2", f"--out={out}", "--finalize"] + corpus,
                monkeypatch) == 1

    assert _run(["--chunk=2", f"--out={out}", "--resume",
                 "--remeasure=cluster-colors(4)"] + corpus, monkeypatch) == 0
    resumed = json.load(open(out))
    assert _nontiming(resumed) == _nontiming(first)
    assert "re" not in json.load(open(out + ".ckpt.json"))


def test_remeasure_refuses_incomplete_checkpoint(tmp_path, corpus,
                                                 monkeypatch):
    out = str(tmp_path / "ns.json")
    assert _run(["--chunk=2", f"--out={out}"] + corpus[:4], monkeypatch) == 0
    ck = json.load(open(out + ".ckpt.json"))
    ck["paths_sha"] = northstar._paths_sha(sorted(corpus))
    json.dump(ck, open(out + ".ckpt.json", "w"))
    assert _run(["--chunk=2", f"--out={out}",
                 "--remeasure=cluster-colors(4)"] + corpus, monkeypatch) == 1
    # a valid spec that is not in the record's codec list refuses too
    assert _run(["--chunk=2", f"--out={out}",
                 "--remeasure=cluster-colors(8)"] + corpus,
                monkeypatch) == 1


def test_remeasure_refuses_other_specs_unfinished_remeasure(
        tmp_path, corpus, monkeypatch):
    """A killed remeasure leaves partial accumulators for ITS legs; a
    remeasure of a DIFFERENT spec set must refuse rather than strip the
    're' key and bake the partial legs into a 'complete' checkpoint."""
    out = str(tmp_path / "ns.json")
    assert _run(["--chunk=2", f"--out={out}"] + corpus, monkeypatch) == 0
    ck = json.load(open(out + ".ckpt.json"))
    ck["acc"]["cluster-colors_4"]["images"] = 2  # partial, mid-kill
    ck["re"] = {"specs": ["cluster-colors(4)"], "next_chunk": 1}
    json.dump(ck, open(out + ".ckpt.json", "w"))
    assert _run(["--chunk=2", f"--out={out}", "--remeasure=delta"] + corpus,
                monkeypatch) == 1
    # the checkpoint is untouched: the unfinished remeasure is preserved
    ck2 = json.load(open(out + ".ckpt.json"))
    assert ck2["re"] == {"specs": ["cluster-colors(4)"], "next_chunk": 1}
    assert ck2["acc"]["cluster-colors_4"]["images"] == 2


def test_remeasure_trials_median_splice(tmp_path, corpus, monkeypatch):
    """--trials=N: N full passes per remeasured leg, output accumulators
    asserted identical across passes, median timing spliced — and the
    accounting (images/MP/bytes) must count the corpus ONCE, not N times."""
    out = str(tmp_path / "ns.json")
    assert _run(["--chunk=2", f"--out={out}"] + corpus, monkeypatch) == 0
    first = json.load(open(out))

    ck = json.load(open(out + ".ckpt.json"))
    ck["acc"]["delta"]["enc_s"] *= 1000.0
    json.dump(ck, open(out + ".ckpt.json", "w"))

    assert _run(["--chunk=2", f"--out={out}", "--remeasure=delta",
                 "--trials=3"] + corpus, monkeypatch) == 0
    re = json.load(open(out))
    assert _nontiming(re) == _nontiming(first)
    assert re["per_codec_mps"]["delta"] > \
        first["per_codec_mps"]["delta"] / 100.0
    ck2 = json.load(open(out + ".ckpt.json"))
    assert "re" not in ck2
    assert ck2["acc"]["delta"]["images"] == 6
    assert ck2["acc"]["delta"]["mp"] == pytest.approx(6 * 24 * 32 / 1e6)


def test_remeasure_trials_resume_mid_trial(tmp_path, corpus, monkeypatch):
    out = str(tmp_path / "ns.json")
    assert _run(["--chunk=2", f"--out={out}"] + corpus, monkeypatch) == 0
    first = json.load(open(out))
    full_ck = json.load(open(out + ".ckpt.json"))

    # a kill mid-trial-2-of-2 after chunk 2-of-3: trial 1's full leg
    # accumulators sit in "done", the partial trial 2 in acc
    partial_out = str(tmp_path / "partial.json")
    assert _run(["--chunk=2", f"--out={partial_out}"] + corpus[:4],
                monkeypatch) == 0
    part_acc = json.load(open(partial_out + ".ckpt.json"))["acc"]
    ck = dict(full_ck)
    ck["acc"] = dict(full_ck["acc"])
    ck["acc"]["delta"] = part_acc["delta"]
    ck["re"] = {"specs": ["delta"], "next_chunk": 2, "trials": 2,
                "trial": 1, "done": [{"delta": full_ck["acc"]["delta"]}]}
    json.dump(ck, open(out + ".ckpt.json", "w"))

    # a trial-count mismatch must refuse before touching anything
    assert _run(["--chunk=2", f"--out={out}", "--resume",
                 "--remeasure=delta", "--trials=3"] + corpus,
                monkeypatch) == 1
    assert _run(["--chunk=2", f"--out={out}", "--resume",
                 "--remeasure=delta"] + corpus, monkeypatch) == 1

    assert _run(["--chunk=2", f"--out={out}", "--resume",
                 "--remeasure=delta", "--trials=2"] + corpus,
                monkeypatch) == 0
    resumed = json.load(open(out))
    assert _nontiming(resumed) == _nontiming(first)
    ck2 = json.load(open(out + ".ckpt.json"))
    assert "re" not in ck2
    assert ck2["acc"]["delta"]["images"] == 6


def test_remeasure_trials_determinism_check(tmp_path, corpus, monkeypatch):
    """A cross-trial output mismatch (bytes differ) must abort the splice
    rather than average non-identical passes."""
    out = str(tmp_path / "ns.json")
    assert _run(["--chunk=2", f"--out={out}"] + corpus, monkeypatch) == 0
    full_ck = json.load(open(out + ".ckpt.json"))

    poisoned = dict(full_ck["acc"]["delta"])
    poisoned["bytes"] += 1
    ck = dict(full_ck)
    ck["re"] = {"specs": ["delta"], "next_chunk": 3, "trials": 2,
                "trial": 1, "done": [{"delta": poisoned}]}
    json.dump(ck, open(out + ".ckpt.json", "w"))
    assert _run(["--chunk=2", f"--out={out}", "--resume",
                 "--remeasure=delta", "--trials=2"] + corpus,
                monkeypatch) == 1


def test_trials_requires_remeasure(tmp_path, corpus, monkeypatch):
    out = str(tmp_path / "ns.json")
    assert _run(["--chunk=2", f"--out={out}", "--trials=3"] + corpus,
                monkeypatch) == 1
    assert _run(["--chunk=2", f"--out={out}", "--remeasure=delta",
                 "--trials=0"] + corpus, monkeypatch) == 1


def test_corpus_change_invalidates_checkpoint(tmp_path, corpus, rng,
                                              monkeypatch):
    out = str(tmp_path / "ns.json")
    assert _run(["--chunk=2", f"--out={out}"] + corpus, monkeypatch) == 0

    img = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    extra = str(tmp_path / "ns_99999.png")
    image_io.save_png(img, extra)
    # resume with a different path list: the sha mismatch must force a
    # fresh start (all 7 images counted exactly once)
    assert _run(["--chunk=2", f"--out={out}", "--resume"] + corpus + [extra],
                monkeypatch) == 0
    d = json.load(open(out))
    assert d["corpus"]["images"] == 7
    assert all(a["images"] == 7 for a in
               json.load(open(out + ".ckpt.json"))["acc"].values())


def test_accounting_equals_jax_northstar(tmp_path, corpus, monkeypatch):
    out, jax_out = str(tmp_path / "ns.json"), str(tmp_path / "jax.json")
    assert _run(["--chunk=2", f"--out={out}"] + corpus, monkeypatch) == 0
    monkeypatch.setattr(jax_northstar, "SPECS", SMALL_SPECS)
    monkeypatch.setattr(sys, "argv", ["northstar.py", "--chunk=2",
                                      f"--out={jax_out}"] + corpus)
    assert jax_northstar.main() == 0
    got, want = json.load(open(out)), json.load(open(jax_out))
    # the same streams and MSEs: every accumulator but the timings
    drop = {"baseline"}
    assert ({k: v for k, v in _nontiming(got).items() if k not in drop}
            == {k: v for k, v in _nontiming(want).items() if k not in drop})
    for name, acc in json.load(open(out + ".ckpt.json"))["acc"].items():
        jacc = json.load(open(jax_out + ".ckpt.json"))["acc"][name]
        assert {k: acc[k] for k in ("mp", "bytes", "mse_sum", "images")} == \
            {k: jacc[k] for k in ("mp", "bytes", "mse_sum", "images")}


def test_cuda_refused_without_a_card(tmp_path, corpus, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    monkeypatch.setattr(northstar, "SPECS", SMALL_SPECS)
    out = str(tmp_path / "ns.json")
    assert northstar.main([f"--out={out}"] + corpus) == 1
    assert "Device unavailable" in capsys.readouterr().err
    assert not os.path.exists(out)
