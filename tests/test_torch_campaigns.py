"""The port's campaigns, profiles and probes (`cniic_tpu_torch.experiments`)
on the CPU, beside the JAX package's scripts on the same seeds.

* `roundtrip_campaign`: its trial images are the script's; per spec, the
  hashes of the per-image and batch streams over a few seeds equal JAX's
  (the host-C specs, plus cluster-colors(4) and voronoi(4) at one seed),
  with no finding;
* under the K3 gate, contract 2 holds a hilbert(rle(d)) batch against K3's
  plain route, and a difference there is a finding;
* `fuzz_campaign`: for a fixed seed and trial count, each family's ok and
  raised counts equal the script's protocol run through JAX's decoders;
* `profile_clusterc`: its stages' streams equal `encode_batch`'s, JAX's;
  `kmeans_phase_probe`'s calls equal the engine's, window by window;
* `device_hist_rle_probe` and `zipback_matchfinder`: their torch
  formulations equal the C paths, the numpy replica and the scripts' jnp
  ones on a small input;
* every module that takes `--device` refuses `cuda` without a card.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from cniic_tpu.codecs import from_spec as jax_from_spec
from cniic_tpu_torch import image_io, native
from cniic_tpu_torch.bench import synth_image
from cniic_tpu_torch.codecs import ClusterColors, from_spec
from cniic_tpu_torch.experiments import (device_hist_rle_probe, fuzz_campaign,
                                         kmeans_phase_probe, profile_clusterc,
                                         roundtrip_campaign,
                                         zipback_matchfinder)
from cniic_tpu_torch.ops import approx_rle, histogram
from cniic_tpu_torch.synth_corpus import synth_natural

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "experiments"))
import device_hist_rle_probe as jax_hist_rle  # noqa: E402
import fuzz_campaign as jax_fuzz  # noqa: E402
import roundtrip_campaign as jax_roundtrip  # noqa: E402
import zipback_tpu_matchfinder as jax_zipback  # noqa: E402

CPU = torch.device("cpu")
HOST_SPECS = ["hufman", "delta", "hilbert(rle)", "hilbert(rle(3))",
              "hilbert(zip)", "zip(dict)", "zip(back)"]


def _jax_trial(seed):
    rng = np.random.default_rng(seed)
    return [jax_roundtrip._rand_image(rng)
            for _ in range(int(rng.integers(1, 6)))]


def _jax_hashes(specs, seeds):
    """The port's two digests over JAX's per-image and batch streams."""
    out = {}
    for spec in specs:
        codec = jax_from_spec(spec)
        singles, batch = hashlib.sha256(), hashlib.sha256()
        for seed in seeds:
            imgs = _jax_trial(seed)
            streams = []
            for im in imgs:
                try:
                    streams.append(codec.encode(im))
                except jax_roundtrip.ALLOWED:
                    streams.append(None)
            roundtrip_campaign.digest(singles, streams)
            try:
                roundtrip_campaign.digest(batch, codec.encode_batch(imgs))
            except jax_roundtrip.ALLOWED:
                pass
        out[spec] = (singles.hexdigest(), batch.hexdigest())
    return out


@pytest.mark.parametrize("specs,seeds", [
    (HOST_SPECS, (1, 7, 12)),
    (["cluster-colors(4)", "voronoi(4)"], (12,)),
], ids=["host", "kmeans"])
def test_roundtrip_hashes_match_jax(specs, seeds, monkeypatch, tmp_path):
    assert roundtrip_campaign.SPECS == jax_roundtrip.SPECS
    for seed in seeds:
        for a, b in zip(roundtrip_campaign.trial_images(seed),
                        _jax_trial(seed)):
            np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(roundtrip_campaign, "SPECS", specs)
    camp = roundtrip_campaign.Campaign(CPU, (), str(tmp_path))
    for seed in seeds:
        camp.run(seed)
    got = camp.summary({})
    assert got["findings"] == 0 and not os.listdir(tmp_path)
    want = _jax_hashes(specs, seeds)
    for spec in specs:
        assert (got["streams_sha256"][spec], got["batch_sha256"][spec]) \
            == want[spec], spec


def test_k3_gate_holds_the_batch_against_plain_k3(monkeypatch, tmp_path):
    spec = "hilbert(rle(3))"
    monkeypatch.setattr(roundtrip_campaign, "SPECS", [spec])
    assert roundtrip_campaign.Campaign(CPU, ("k2", "d1")).batch_refs == {}
    monkeypatch.setenv(roundtrip_campaign.GATES["k3"], "1")
    calls = []
    real = approx_rle.approx_rle_batch_ref

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(approx_rle, "approx_rle_batch_ref", spy)
    camp = roundtrip_campaign.Campaign(CPU, ("k3",), str(tmp_path))
    assert set(camp.batch_refs) == {spec}
    camp.run(19)
    assert camp.findings == 0 and len(calls) == 2  # the batch, its reference
    # a reference that disagrees is a finding of contract 2
    plain = from_spec(spec, device="cpu")
    monkeypatch.setattr(camp.batch_refs[spec], "encode_batch",
                        lambda imgs: [s + b"\0"
                                      for s in plain.encode_batch(imgs)])
    camp.run(19)
    assert camp.findings == 3  # one per lane
    assert os.listdir(tmp_path) == ["roundtrip_finding_lane_bytes_19.json"]


def test_fuzz_outcome_counts_match_jax(capsys, tmp_path):
    seed, trials = 11, 20
    assert fuzz_campaign.FAMILIES == jax_fuzz.FAMILIES
    assert fuzz_campaign.main(["--device=cpu", f"--seed={seed}",
                               f"--trials={trials}",
                               f"--out={tmp_path}"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(last.split("campaign done: ", 1)[1])["families"]
    rng = np.random.default_rng(seed)
    for spec in jax_fuzz.FAMILIES:
        codec = jax_from_spec(spec)
        streams = []
        for img in jax_fuzz.source_images(rng):
            try:
                streams.append(np.frombuffer(codec.encode(img), np.uint8))
            except ValueError:
                pass
        counts = {"ok": 0, "raised": 0}
        for _ in range(trials):
            blob = jax_fuzz.mutate(rng, streams[rng.integers(0, len(streams))])
            counts[fuzz_campaign.outcome(codec, blob)[0]] += 1
        assert {k: got[spec][k] for k in counts} == counts, spec
        assert got[spec]["findings"] == 0


@pytest.fixture
def pngs(tmp_path):
    rng = np.random.default_rng(2024)
    paths = []
    for i, (h, w) in enumerate([(40, 48), (40, 48), (36, 52)]):
        p = tmp_path / f"img{i}.png"
        image_io.save_png(synth_image(rng, h, w), p)
        paths.append(str(p))
    return paths


def test_profile_clusterc_stages_equal_the_encode(pngs, capsys):
    imgs = [image_io.load_image(p) for p in pngs]
    r = profile_clusterc.profile_group(imgs, 4, CPU)
    assert set(r["seconds"]) == set(profile_clusterc.STAGES)
    assert r["streams"] == ClusterColors(4, device="cpu").encode_batch(imgs)
    assert r["streams"] == jax_from_spec("cluster-colors(4)").encode_batch(imgs)
    assert profile_clusterc.main(["--device=cpu", "--lanes=3", "--chunks=1",
                                  "--k=4"] + pngs) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["groups"][0]["iterations"] == r["iterations"]


def test_kmeans_phase_probe_calls_equal_the_engine(pngs):
    imgs = [image_io.load_image(p) for p in pngs]
    for spec in ("cluster-colors(4)", "voronoi(4)"):
        calls = kmeans_phase_probe.probe_codec(from_spec(spec, device="cpu"),
                                               imgs, CPU)
        assert len(calls) == (1 if spec.startswith("cluster") else 2)
        for c in calls:
            assert c["equal"]
            assert set(c["seconds"]) == {"prep", "upload", "loop", "fetch"}
            assert sum(i for i, _, _ in c["windows"]) == c["iterations"]
    assert kmeans_phase_probe.main(
        ["--device=cpu", "--specs=cluster-colors(4),voronoi(4)"] + pngs) == 0


def test_device_hist_rle_formulations_equal_c_and_jax():
    img = synth_natural(np.random.default_rng(7), 60, 90)
    pixels = img.reshape(-1, 3)
    got = device_hist_rle_probe.device_color_histogram(pixels, CPU)
    for g, c, j in zip(got, histogram.color_histogram(pixels),
                       jax_hist_rle.device_color_histogram(pixels)):
        np.testing.assert_array_equal(g, c)
        np.testing.assert_array_equal(g, j)
    scan = img.reshape(-1, 3)[::-1].copy()
    scan[100:700] = scan[100]  # runs past the 255 cap
    counts, colors = device_hist_rle_probe.device_rle(scan, CPU)
    assert native.rle_records_frame(counts, colors) == bytes(
        native.rle_frame(scan))


def test_zipback_matcher_equals_numpy_replica_and_jax():
    small = np.random.default_rng(7).integers(0, 4, 4096).astype(np.uint8)
    want = zipback_matchfinder.numpy_matcher(small, 2, 16)
    for a, b in zip(want, jax_zipback.numpy_matcher(small, 2, 16)):
        np.testing.assert_array_equal(a, b)
    jax_out = jax_zipback.device_matcher(2, 16)(small)
    for K, T in ((1, 8), (2, 16)):
        got = zipback_matchfinder.device_matcher(torch.from_numpy(small), K, T)
        ref = zipback_matchfinder.numpy_matcher(small, K, T)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r)
    for g, j in zip(zipback_matchfinder.device_matcher(
            torch.from_numpy(small), 2, 16), jax_out):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


DEVICE_MODULES = [
    ("fuzz_campaign", ["--trials=1"]),
    ("roundtrip_campaign", ["--trials=1"]),
    ("profile_clusterc", ["--lanes=1", "--chunks=1", "PNG0"]),
    ("kmeans_phase_probe", ["PNG0"]),
    ("profile_kmeans", []),
    ("batch_depth_study", []),
    ("voronoi_probe", ["--depth=1", "--chunks=1", "PNG0", "PNG1"]),
    ("interleave_probe", ["--chunk=1", "--chunks=1", "PNG0", "PNG1"]),
    ("probe_cleg_scale", ["--glob=PNG0"]),
    ("device_hist_rle_probe", []),
    ("zipback_matchfinder", []),
]


@pytest.mark.parametrize("name,args", DEVICE_MODULES,
                         ids=[n for n, _ in DEVICE_MODULES])
def test_cuda_refused_without_a_card(name, args, pngs, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device=cuda is accepted")
    mod = importlib.import_module(f"cniic_tpu_torch.experiments.{name}")
    args = [a.replace("PNG0", pngs[0]).replace("PNG1", pngs[1]) for a in args]
    assert mod.main(["--device=cuda"] + args) == 1
    assert "Device unavailable" in capsys.readouterr().err
