"""cluster-colors' device path (`codecs/clusterc.CardStages`) on CPU tensors.

* `ops/color_hist.lane_histograms` equals `native.hist_rgb` lane by lane:
  one colour, all-distinct colours, keys at 0x000000 and 0xFFFFFF, lanes of
  unequal size, a 1x1 image;
* `kmeans.kmeans_lanes` (lanes already on the device, the engine's one
  lane loop) equals `cniic_tpu`'s `kmeans_batch` on the same lanes:
  results, collect-mode errors and their messages, lane chunks;
* the card stages' streams equal `cniic_tpu`'s cluster-colors
  `encode_batch` byte for byte, an image with fewer unique colours than k
  yields the same exception in place as the host stages, and the k-means
  sees the lanes in the host stages' order;
* `encode` of one image (`encode_batch` of one, so its Huffman stage is
  the batch one, D1's batch packer under CNIIC_DEVICE_BITPACK=1) gives
  `cniic_tpu`'s `encode` stream, on both stages;
* `profile_clusterc.profile_group` runs the codec's own stages, and
  `decode_fault_probe` the benchmark's pass steps.

Images are made from numpy seeds; the packages exchange numpy arrays.
"""

import numpy as np
import pytest
import torch

from cniic_tpu.codecs import from_spec as jax_from_spec
from cniic_tpu.ops import kmeans as jkm
from cniic_tpu_torch import decode_fault_probe, native
from cniic_tpu_torch.codecs import ClusterColors, clusterc
from cniic_tpu_torch.experiments import profile_clusterc
from cniic_tpu_torch.ops import color_hist, histogram
from cniic_tpu_torch.ops import kmeans as tkm

CPU = torch.device("cpu")


def _flat(h, w, rgb):
    return np.broadcast_to(np.array(rgb, np.uint8), (h, w, 3)).copy()


def _distinct(h, w, seed):
    """h * w pixels of pairwise distinct colours, in a random order."""
    keys = np.random.default_rng(seed).choice(1 << 24, h * w, replace=False)
    return histogram.unpack_colors(keys.astype(np.uint32)).reshape(h, w, 3)


def _noisy(h, w, seed, levels=6):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, levels, (h, w, 3)) * (255 // (levels - 1))
            ).astype(np.uint8)


def _extremes(h, w, seed):
    """Pixels at the ends of the key range, 0x000000 and 0xFFFFFF, and
    their neighbours 0x000001 and 0xFFFFFE."""
    rng = np.random.default_rng(seed)
    pal = np.array([[0, 0, 0], [255, 255, 255], [0, 0, 1], [255, 255, 254]],
                   np.uint8)
    return pal[rng.integers(0, 4, (h, w))]


CASES = {
    "one colour": [_flat(7, 9, (12, 34, 56))],
    "one colour, every lane": [_flat(5, 5, (0, 0, 0)),
                               _flat(3, 8, (0, 0, 0)),
                               _flat(4, 4, (255, 255, 255))],
    "all distinct": [_distinct(16, 20, 1), _distinct(9, 31, 2)],
    "keys at both ends": [_extremes(12, 11, 3), _extremes(1, 40, 4)],
    "lanes of unequal size": [_noisy(40, 67, 5), _noisy(3, 5, 6),
                              _noisy(25, 2, 7, levels=3),
                              _distinct(30, 30, 8)],
    "a 1x1 image": [_noisy(1, 1, 9), _noisy(20, 10, 10)],
    "a 1x1 image alone": [_extremes(1, 1, 11)],
}


@pytest.mark.parametrize("case", CASES)
def test_lane_histograms_equal_native_hist_rgb(case):
    imgs = CASES[case]
    lh = color_hist.lane_histograms(imgs, CPU)
    assert lh.colors.dtype == torch.int32 and lh.counts.dtype == torch.int64
    assert lh.inverse.dtype == torch.int32
    for b, im in enumerate(imgs):
        pixels = im.reshape(-1, 3)
        uniq, counts, inverse = native.hist_rgb(pixels)
        colors, got_counts, got_inverse = lh.lane(b)
        np.testing.assert_array_equal(histogram.pack_colors(colors), uniq)
        np.testing.assert_array_equal(got_counts, counts)
        assert got_counts.dtype == np.int64 and got_inverse.dtype == np.int32
        np.testing.assert_array_equal(got_inverse, inverse)
        np.testing.assert_array_equal(colors[got_inverse], pixels)
        assert lh.ns[b] == uniq.size
    assert lh.starts == np.cumsum([0] + lh.ns[:-1]).tolist()
    assert lh.counts.sum().item() == sum(im.shape[0] * im.shape[1]
                                         for im in imgs)


def test_lanes_past_128_take_wide_keys():
    """Past 128 lanes `lane << 24` leaves int32: the keys are int64 and
    every lane still equals its own histogram."""
    imgs = [_noisy(2, 3, s, levels=3) for s in range(130)]
    lh = color_hist.lane_histograms(imgs, CPU)
    for b in (0, 127, 128, 129):
        want = histogram.color_histogram(imgs[b].reshape(-1, 3))
        for got, w in zip(lh.lane(b), want):
            np.testing.assert_array_equal(got, w)


def _lanes_case():
    """`test_torch_kmeans`'s collect-mode lanes, as colours (every
    coordinate <= 255 but the cap's lane) with positive weights."""
    rng = np.random.default_rng(17)
    n, nv = int(rng.integers(20, 80)), int(rng.integers(2, 5))
    vals = rng.integers(0, 256, (nv, 3))
    few_colors = vals[rng.integers(0, nv, n)]
    rng = np.random.default_rng(9)
    good = rng.integers(0, 256, (300, 3))
    pts = [good, rng.integers(0, 256, (3, 3)), np.full((40, 3), 20000),
           rng.integers(0, 256, (64, 3)), few_colors, good[:200],
           rng.integers(0, 256, (90, 3))]
    ws = [rng.integers(1, 50, p.shape[0]) for p in pts]
    ws[3] = np.full(64, 2**24)                      # weighted values cap
    ws[6] = np.full(90, 2**21)                      # total weight cap
    return pts, ws


def _on_device(pts, ws):
    starts = np.cumsum([0] + [p.shape[0] for p in pts[:-1]]).tolist()
    points = torch.from_numpy(np.concatenate(pts).astype(np.int32))
    weights = torch.from_numpy(np.concatenate(ws).astype(np.int64))
    return points, weights, [(s, p.shape[0]) for s, p in zip(starts, pts)]


@pytest.mark.parametrize("lanes_env", [None, "2", "3"])
def test_kmeans_lanes_equal_kmeans_batch(monkeypatch, lanes_env):
    if lanes_env is not None:
        monkeypatch.setenv("CNIIC_KMEANS_LANES", lanes_env)
    pts, ws = _lanes_case()
    points, weights, lanes = _on_device(pts, ws)
    want = jkm.kmeans_batch(pts, 6, weights_list=ws, on_error="collect")
    got = tkm.kmeans_lanes(points, weights, lanes, 6, on_error="collect")
    assert [type(r).__name__ for r in got] == [
        "tuple", "ValueError", "ValueError", "ValueError", "AssertionError",
        "tuple", "ValueError"]
    for g, w in zip(got, want):
        if isinstance(w, Exception):
            assert type(g) is type(w) and str(g) == str(w)
            continue
        np.testing.assert_array_equal(g[0], w[0])
        assert isinstance(g[1], torch.Tensor)
        np.testing.assert_array_equal(g[1].numpy(), w[1])
        assert g[2] == w[2]


def test_kmeans_lanes_raise_mode_raises_the_first_error():
    pts, ws = _lanes_case()
    points, weights, lanes = _on_device(pts[:3], ws[:3])
    with pytest.raises(ValueError) as te:
        jkm.kmeans_batch(pts[:3], 6, weights_list=ws[:3])
    with pytest.raises(ValueError) as ge:
        tkm.kmeans_lanes(points, weights, lanes, 6)
    assert str(ge.value) == str(te.value)


def _images(seed):
    rng = np.random.default_rng(seed)
    imgs = []
    for h, w in ((40, 67), (33, 20), (48, 48), (17, 90)):
        img = (rng.integers(0, 7, (h, w, 3)) * 40).astype(np.uint8)
        img[: h // 3, : w // 2] = rng.integers(0, 256, 3)
        img[h // 2:, w // 3:] += rng.integers(0, 4, (h - h // 2,
                                                    w - w // 3, 3),
                                              dtype=np.uint8)
        imgs.append(img)
    return imgs


def _run(stages, imgs):
    h = stages.hist(imgs)
    results = stages.kmeans(h)
    return stages.huf(imgs, results, stages.parts(h, results))


@pytest.mark.parametrize("k", [8, 32])
def test_card_stages_streams_equal_cniic_tpu(k):
    imgs = _images(k)
    got = _run(clusterc.CardStages(k, CPU), imgs)
    want = jax_from_spec(f"cluster-colors({k})").encode_batch(imgs)
    assert got == want
    assert got == _run(clusterc.HostStages(k, CPU), imgs)


def test_card_stages_yield_the_same_exception_in_place():
    """An image with fewer unique colours than k fails in place with the
    host stages' exception and `cniic_tpu`'s; the others' streams stand."""
    imgs = _images(3)
    imgs.insert(1, _noisy(6, 6, 12, levels=2))      # at most 8 colours < 16
    host = _run(clusterc.HostStages(16, CPU), imgs)
    card = _run(clusterc.CardStages(16, CPU), imgs)
    assert isinstance(host[1], ValueError)
    for h, c in zip(host, card):
        if isinstance(h, Exception):
            assert type(c) is type(h) and str(c) == str(h)
        else:
            assert c == h
    ref = jax_from_spec("cluster-colors(16)").encode_batch(imgs)
    assert type(ref[1]) is type(host[1]) and str(ref[1]) == str(host[1])


def test_card_stages_take_the_host_lane_order(monkeypatch):
    """The k-means sees the lanes in the host stages' order: by unique
    count, descending, ties in the images' order."""
    imgs = _images(5)
    imgs.append(imgs[2].copy())                      # a tie
    seen = {}

    def spy(name, real):
        def run(*args, **kwargs):
            if name == "host":
                seen[name] = [p.shape[0] for p in args[0]]
            else:
                seen[name] = [n for _, n in args[2]]
            out = real(*args, **kwargs)
            seen[name + " ids"] = [None if isinstance(r, Exception) else
                                   int(np.asarray(r[1]).sum()) for r in out]
            return out
        return run

    monkeypatch.setattr(tkm, "kmeans_batch", spy("host", tkm.kmeans_batch))
    monkeypatch.setattr(tkm, "kmeans_lanes", spy("card", tkm.kmeans_lanes))
    host = _run(clusterc.HostStages(8, CPU), imgs)
    card = _run(clusterc.CardStages(8, CPU), imgs)
    uniques = clusterc.HostStages(8, CPU).uniques(
        clusterc.HostStages(8, CPU).hist(imgs))
    assert seen["card"] == seen["host"] == sorted(uniques, reverse=True)
    assert seen["card ids"] == seen["host ids"]
    assert clusterc.lane_order([3, 5, 3, 9]) == [3, 1, 0, 2]
    assert card == host


def test_codec_takes_the_card_stages_only_on_a_cuda_device():
    assert type(ClusterColors(8, device="cpu").stages()) is clusterc.HostStages
    codec = ClusterColors.__new__(ClusterColors)
    codec.n, codec.device = 8, torch.device("cuda")   # no card needed
    assert type(codec.stages()) is clusterc.CardStages


def test_profile_group_runs_the_codecs_stages():
    imgs = _images(7)
    r = profile_clusterc.profile_group(imgs, 8, CPU)
    assert set(r["seconds"]) == set(profile_clusterc.STAGES)
    assert r["streams"] == ClusterColors(8, device="cpu").encode_batch(imgs)
    assert r["uniques"] == [histogram.color_histogram(im.reshape(-1, 3))[0]
                            .shape[0] for im in imgs]
    assert r["k1_launches"] == 0                     # no card: plain versions
    for stages in profile_clusterc.STAGE_SETS:     # either set, on one device
        assert profile_clusterc.profile_group(
            imgs, 8, CPU, stages)["streams"] == r["streams"]


@pytest.mark.parametrize("gate", [None, "CNIIC_DEVICE_BITPACK"])
def test_single_image_encode_equals_cniic_tpu(monkeypatch, gate):
    img = _images(11)[0]
    want = jax_from_spec("cluster-colors(8)").encode(img)
    if gate is not None:
        monkeypatch.setenv(gate, "1")
    assert ClusterColors(8, device="cpu").encode(img) == want
    assert _run(clusterc.CardStages(8, CPU), [img]) == [want]


def test_decode_fault_probe_runs_the_passes_steps():
    imgs = _images(13)[:2]
    r = decode_fault_probe.probe(imgs, "cluster-colors(8)", 2, CPU)
    assert r["same_mses"] and len(r["after_encode"]) == len(r["alone"]) == 2
    assert r["released"] == [] and r["decode_released_s"] is None  # no card
    assert r["megapixels"] == sum(im.shape[0] * im.shape[1]
                                  for im in imgs) / 1e6
    for row in r["after_encode"]:
        assert row["encode_s"] > 0 and row["decode_s"] > 0
        assert row["encode_faults"] >= 0 and row["decode_faults"] >= 0
        assert row["decode_cpu_s"] >= 0 and row["decode_threads"] >= 1
