"""The port's k-means and Hilbert codecs against the JAX package, on the CPU.

* `cluster-colors(16|32)`, `voronoi(64|128)`, `hilbert(rle)`,
  `hilbert(rle(4|16))` and `hilbert(zip)` reproduce the golden frontier pins
  of tests/test_golden_frontier.py (imported, not copied);
* their streams equal `cniic_tpu`'s byte for byte, and each package decodes
  the other's streams to the same image; under CNIIC_CHUNKED_RLE=1 the
  approximate-RLE streams are unchanged, and under CNIIC_PALLAS_RLE=1
  `encode_batch` equals `cniic_tpu`'s batch route;
* `encode_batch` equals per-image `encode`, and the fused voronoi
  decode+MSE equals decode + `compute_error`;
* truncated and garbage Hilbert streams are rejected;
* the registry keeps the reference's parse order and refuses what is not
  ported yet, and a CUDA device with no card is refused, never replaced by
  the CPU.
"""

import time

import numpy as np
import pytest
import torch

from cniic_tpu.codecs import from_spec as jax_from_spec
from cniic_tpu_torch import huffman, wire
from cniic_tpu_torch.codecs import ClusterColors, Hilbert, VoronoiCluster, from_spec
from cniic_tpu_torch.ops import approx_rle
from cniic_tpu_torch.runner import compute_error
from test_golden_frontier import GOLDEN, _synth

SPECS = ["cluster-colors(16)", "cluster-colors(32)", "voronoi(64)",
         "voronoi(128)", "hilbert(rle)", "hilbert(rle(4))",
         "hilbert(rle(16))", "hilbert(zip)"]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(42)  # the golden corpus
    return [_synth(rng, 96, 128), _synth(rng, 128, 128), _synth(rng, 80, 112)]


@pytest.mark.parametrize("spec", SPECS)
def test_golden_pins_and_streams_match_jax(spec, corpus):
    port = from_spec(spec, device="cpu")
    ref = jax_from_spec(spec)
    for i, img in enumerate(corpus):
        data = port.encode(img)
        want = ref.encode(img)
        assert data == want, f"{spec} image {i}: stream differs from cniic_tpu"
        dec = port.decode(data)
        size, mse = GOLDEN[spec][i]
        assert len(data) == size
        assert compute_error(img, dec) == pytest.approx(mse, abs=1e-6)
        # cross-decode both ways
        np.testing.assert_array_equal(ref.decode(data), dec)
        np.testing.assert_array_equal(port.decode(want), dec)


@pytest.mark.parametrize("spec", ["cluster-colors(16)", "voronoi(64)"])
def test_encode_batch_equals_encode(spec, corpus):
    codec = from_spec(spec, device="cpu")
    imgs = corpus + [corpus[0][:, ::-1].copy()]  # two images share a shape
    single = [codec.encode(im) for im in imgs]
    assert codec.encode_batch(imgs) == single
    decoded = codec.decode_batch(single)
    for im, data, dec in zip(imgs, single, decoded):
        np.testing.assert_array_equal(dec, codec.decode(data))


def test_voronoi_fused_decode_mse(corpus):
    codec = from_spec("voronoi(64)", device="cpu")
    imgs = [corpus[0], corpus[0][::-1].copy(), corpus[2]]
    blobs = codec.encode_batch(imgs)
    # the encode upload is cached for the fused path and popped by it
    assert len(codec._dev_imgs) == 2
    mses, fetch = codec.decode_mse_batch(blobs, imgs)
    assert codec._dev_imgs == {}
    for im, data, mse, dec in zip(imgs, blobs, mses, fetch()):
        np.testing.assert_array_equal(dec, codec.decode(data))
        assert mse == compute_error(im, dec)


@pytest.mark.parametrize("spec", ["hilbert(rle(4))", "hilbert(rle(16))"])
def test_hilbert_chunked_gate_streams_unchanged(spec, corpus, monkeypatch):
    """CNIIC_CHUNKED_RLE=1 sends approximate RLE through K2's plain version
    and the seam stitcher: the streams stay the golden, ungated ones."""
    port = from_spec(spec, device="cpu")
    ref = jax_from_spec(spec)
    ungated = [ref.encode(img) for img in corpus]
    monkeypatch.setenv("CNIIC_CHUNKED_RLE", "1")
    for i, img in enumerate(corpus):
        data = port.encode(img)
        assert data == ungated[i], f"{spec} image {i}"
        assert data == ref.encode(img)
        assert len(data) == GOLDEN[spec][i][0]
        np.testing.assert_array_equal(ref.decode(data), port.decode(data))


@pytest.mark.parametrize("allow", [4, 16])
def test_hilbert_encode_batch_under_pallas_gate_matches_jax(
        allow, corpus, monkeypatch):
    """CNIIC_PALLAS_RLE=1 sends a batch through K3's plain version: its
    streams equal the JAX package's batch route (its Pallas kernel in
    interpret mode), and each package decodes them alike."""
    imgs = [np.ascontiguousarray(im[:40, :56]) for im in corpus]
    imgs[1] = imgs[1][:33, :47].copy()  # streams of different lengths
    spec = f"hilbert(rle({allow}))"
    port = from_spec(spec, device="cpu")
    ref = jax_from_spec(spec)
    monkeypatch.setenv("CNIIC_PALLAS_RLE", "1")
    got = port.encode_batch(imgs)
    assert got == ref.encode_batch(imgs)
    for data in got:
        np.testing.assert_array_equal(port.decode(data), ref.decode(data))
    monkeypatch.setenv("CNIIC_PALLAS_RLE", "0")
    assert port.encode_batch(imgs) == [port.encode(im) for im in imgs]


@pytest.mark.parametrize("spec", ["hilbert(rle)", "hilbert(rle(4))",
                                  "hilbert(zip)"])
def test_hilbert_rejects_truncated_and_garbage_streams(spec, corpus):
    codec = from_spec(spec, device="cpu")
    data = codec.encode(corpus[2])
    for cut in (len(data) // 3, len(data) - 5, 8 + 12):
        with pytest.raises(Exception):
            codec.decode(data[:cut])
    with pytest.raises(Exception):
        codec.decode(wire.pack_dims(4, 4) + b"\x01\x02\x03")
    if codec.mode == "rle":
        bad = bytearray(data)
        bad[8 + 3] ^= 0xFF  # a record's Rgb length prefix
        with pytest.raises(wire.WireError):
            codec.decode(bytes(bad))
        # a tiny stream claiming huge dims is refused before the curve is
        # generated
        blob = wire.pack_dims(16000, 8000) + b"\x05" + wire.pack_rgb(1, 2, 3)
        t0 = time.perf_counter()
        with pytest.raises(wire.WireError):
            codec.decode(blob)
        assert time.perf_counter() - t0 < 0.5


def test_hilbert_streams_follow_the_curve(corpus, monkeypatch):
    """Under the snake curve the port's streams still equal JAX's, and they
    differ from the gilbert streams."""
    img = corpus[2][:21, :34].copy()
    gilbert = from_spec("hilbert(rle)", device="cpu").encode(img)
    monkeypatch.setenv("CNIIC_CURVE", "snake")
    for spec in ("hilbert(rle)", "hilbert(rle(4))", "hilbert(zip)"):
        data = from_spec(spec, device="cpu").encode(img)
        assert data == jax_from_spec(spec).encode(img), spec
        if spec == "hilbert(rle)":
            assert data != gilbert
            np.testing.assert_array_equal(
                from_spec(spec, device="cpu").decode(data), img)


def test_registry_parse_order_and_unported_specs():
    assert isinstance(from_spec("cluster-colors(8)", device="cpu"), ClusterColors)
    assert isinstance(from_spec("ccol(8)", device="cpu"), ClusterColors)
    v = from_spec("voronoi(9)", device="cpu")
    assert isinstance(v, VoronoiCluster) and v.n == 9
    assert v.name == jax_from_spec("voronoi(9)").name
    for spec in ("hilbert(rle)", "Hilbert(rle(2.5))", "hilbert(rle(4))",
                 "hilbert(zip)"):
        h = from_spec(spec, device="cpu")
        assert isinstance(h, Hilbert) and h.device.type == "cpu"
        assert h.name == jax_from_spec(spec).name
        assert h.is_lossless == jax_from_spec(spec).is_lossless
    for spec in ("hufman", "delta", "zip(dict)", "bogus", "hilbert(foo)",
                 "hilbert(rle(x))"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            from_spec(spec, device="cpu")


def test_cuda_device_refused_without_a_card():
    with pytest.raises(ValueError, match="unsupported device"):
        from_spec("voronoi(8)", device="meta")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    for spec in ("cluster-colors(8)", "voronoi(8)", "hilbert(rle(4))"):
        with pytest.raises(RuntimeError, match="is_available"):
            from_spec(spec)  # the default device is cuda
    before = approx_rle.wide_records.launches
    with pytest.raises(RuntimeError, match="is_available"):
        approx_rle.approx_rle_chunked(np.zeros((10, 3), np.uint8), 4)
    assert approx_rle.wide_records.launches == before


@pytest.mark.parametrize("flag", ["CNIIC_DEVICE_BITPACK",
                                  "CNIIC_DEVICE_HUF_DECODE"])
def test_device_huffman_flags_not_ported(monkeypatch, corpus, flag):
    codec = from_spec("cluster-colors(8)", device="cpu")
    data = codec.encode(corpus[2])
    monkeypatch.setenv(flag, "1")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        codec.encode(corpus[2])
    with pytest.raises(NotImplementedError, match="not ported yet"):
        codec.decode(data)


def test_numpy_bit_packer_matches_native():
    rng = np.random.default_rng(12)
    freqs = rng.integers(1, 1000, 300)
    ids = rng.integers(0, 300, 5000).astype(np.int32)
    book = huffman.build_codebook(freqs)
    assert (huffman.encode_payload(ids, book, device=False)
            == huffman.encode_payload(ids, book))
