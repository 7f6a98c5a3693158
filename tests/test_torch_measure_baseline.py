"""The port's host baseline (`cniic_tpu_torch.measure_baseline`).

Ported from tests/test_measure_baseline.py: the --images mode samples a
corpus deterministically, writes the document with one recorded default
sample, refuses an empty glob, and --only splices re-measured legs into the
file, keeping the others verbatim and refusing a leg the file lacks. Plus:

* the document names the host CPU, the card (or "none") and the one-core
  setting, and each leg's seconds; the process gets its cores and torch
  threads back after the run;
* a leg spliced in with --only times the images a whole run gives it (the
  rng draws every leg's images before the skip);
* the committed `BASELINE_HOST_H100.json` covers the nine bench codecs,
  measured on one core beside an H100.
"""

import hashlib
import json
import os

import numpy as np
import torch

from cniic_tpu_torch import bench, image_io
from cniic_tpu_torch import measure_baseline as mb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = [("hufman", 24, 3), ("delta", 24, 3)]


def test_corpus_sample_is_deterministic_spread():
    paths = [f"img_{i:04d}.png" for i in range(100)]
    s = mb._corpus_sample(paths, 4)
    assert s == mb._corpus_sample(paths, 4)
    assert s[0] == paths[0] and s[-1] == paths[-1]
    assert len(s) == 4
    # a sample larger than the corpus degrades to the whole corpus
    assert mb._corpus_sample(paths[:3], 8) == paths[:3]


def _corpus(tmp_path, rng, n):
    for i in range(n):
        img = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
        image_io.save_png(img, tmp_path / f"c_{i}.png")


def test_images_mode_writes_matched_baseline(tmp_path, rng, monkeypatch):
    _corpus(tmp_path, rng, 5)
    monkeypatch.setattr(bench, "SUITE", TINY)
    monkeypatch.setattr(mb, "_CORPUS_DEFAULT_N", 2)
    out_path = tmp_path / "BASELINE_TEST_NS.json"
    assert mb.main([f"--images={tmp_path}/*.png", f"--out={out_path}"]) == 0
    doc = json.load(open(out_path))
    assert set(doc["per_codec"]) == {"Hufman", "delta"}
    for v in doc["per_codec"].values():
        assert v["encode_mps"] > 0 and v["decode_mps"] > 0
    assert doc["corpus"]["images"] == 5
    # 2-image deterministic spread = first and last of the sorted corpus;
    # fast legs share one recorded sample
    assert doc["corpus"]["sampled"]["default"] == ["c_0.png", "c_4.png"]
    assert "Hufman" not in doc["corpus"]["sampled"]


def test_images_mode_empty_glob_fails(tmp_path):
    assert mb.main([f"--images={tmp_path}/nothing/*.png"]) == 1


def test_only_splice_preserves_untouched_legs(tmp_path, rng, monkeypatch):
    _corpus(tmp_path, rng, 4)
    monkeypatch.setattr(bench, "SUITE", TINY)
    monkeypatch.setattr(mb, "_CORPUS_DEFAULT_N", 2)
    out_path = tmp_path / "BASELINE_TEST_ONLY.json"
    args = [f"--images={tmp_path}/*.png", f"--out={out_path}"]
    assert mb.main(args) == 0
    doc = json.load(open(out_path))
    # plant sentinels: the splice must keep the untouched leg verbatim
    doc["per_codec"]["Hufman"] = {"encode_mps": 123.0, "decode_mps": 456.0}
    json.dump(doc, open(out_path, "w"))

    assert mb.main(args + ["--only=delta"]) == 0
    doc2 = json.load(open(out_path))
    assert doc2["per_codec"]["Hufman"] == {"encode_mps": 123.0,
                                           "decode_mps": 456.0}
    assert doc2["per_codec"]["delta"]["encode_mps"] > 0
    assert doc2["corpus"] == doc["corpus"]
    assert doc2["cpu_model"] == doc["cpu_model"]
    assert [s["legs"] for s in doc2["spliced"]] == [["delta"]]

    # a leg not present in the file is a hard error, not a silent add
    assert mb.main(args + ["--only=zip-back"]) == 1


def test_document_names_host_card_and_one_core(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "SUITE", TINY)
    before = (os.sched_getaffinity(0), torch.get_num_threads())
    out_path = tmp_path / "BASELINE_TEST_HOST.json"
    assert mb.main([f"--out={out_path}"]) == 0
    assert (os.sched_getaffinity(0), torch.get_num_threads()) == before
    doc = json.load(open(out_path))
    assert doc["cpu_model"] == mb.cpu_model() and doc["cpu_model"]
    assert doc["machine"] == mb.machine() and doc["machine"]
    assert doc["card"] == mb.card_label()
    assert doc["threads"]["torch_threads"] == 1
    assert doc["threads"]["cpu"] in before[0]
    assert doc["package"] == "cniic_tpu_torch" and "plain CPU" in doc["notes"]
    for leg in doc["per_codec"].values():
        # tiny legs take under 30 s: median of three timed passes
        assert leg["passes"] == 3 and leg["encode_s"] > 0
        assert leg["leg_s"] >= leg["encode_s"]


def test_cpu_model_without_a_model_name(tmp_path, monkeypatch):
    """A virtual machine's /proc/cpuinfo may say "unknown" for the model
    name: the vendor, family and model numbers name the CPU then."""
    info = tmp_path / "cpuinfo"
    info.write_text("processor\t: 0\nvendor_id\t: GenuineIntel\n"
                    "cpu family\t: 6\nmodel\t\t: 143\nmodel name\t: unknown\n"
                    "\nprocessor\t: 1\nmodel name\t: other\n")
    monkeypatch.setattr(mb, "CPUINFO", str(info))
    assert mb.cpu_model() == ("GenuineIntel family 6 model 143 (no model "
                              "name reported)")
    info.write_text("processor\t: 0\nmodel name\t: Some CPU @ 2.0GHz\n")
    assert mb.cpu_model() == "Some CPU @ 2.0GHz"


def test_spliced_leg_times_the_images_of_a_whole_run(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "SUITE", TINY)
    seen = []
    real = mb.from_spec

    def spy(spec, device):
        codec = real(spec, device=device)
        encode = codec.encode_batch

        def recorded(imgs):
            seen.append((codec.name, hashlib.sha256(
                b"".join(im.tobytes() for im in imgs)).hexdigest()))
            return encode(imgs)

        codec.encode_batch = recorded
        return codec

    monkeypatch.setattr(mb, "from_spec", spy)
    out_path = tmp_path / "BASELINE_TEST_SPLICE.json"
    assert mb.main([f"--out={out_path}"]) == 0
    whole = {h for n, h in seen if n == "delta"}
    seen.clear()
    assert mb.main([f"--out={out_path}", "--only=delta"]) == 0
    assert {n for n, _ in seen} == {"delta"}
    assert {h for _, h in seen} == whole and len(whole) == 1


def test_committed_baseline_covers_the_bench():
    with open(os.path.join(REPO, mb.DEFAULT_OUT)) as fh:
        doc = json.load(fh)
    names = ["Hufman", "delta", "hilbert-rle", "hilbert-rle-approx_4",
             "cluster-colors_32", "voronoi_128", "hilbert-zip", "zip-dict",
             "zip-back"]
    assert sorted(doc["per_codec"]) == sorted(names)
    assert all(v["encode_mps"] > 0 for v in doc["per_codec"].values())
    assert "H100" in doc["card"]
    assert doc["cpu_model"] and doc["cpu_model"] != "unknown"
    assert doc["threads"]["torch_threads"] == 1
    assert bench.vs_baseline({n: 1.0 for n in names},
                             doc["per_codec"])[1] == mb.DEFAULT_OUT
