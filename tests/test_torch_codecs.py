"""The port's nine codec families against the JAX package, on the CPU.

* all 12 configs of tests/test_golden_frontier.py reproduce its golden
  frontier pins (imported, not copied);
* their streams equal `cniic_tpu`'s byte for byte, and each package decodes
  the other's streams to the same image; under CNIIC_CHUNKED_RLE=1 the
  approximate-RLE streams are unchanged, and under CNIIC_PALLAS_RLE=1
  `encode_batch` equals `cniic_tpu`'s batch route;
* `encode_batch` equals per-image `encode`, and the fused voronoi
  decode+MSE equals decode + `compute_error`;
* truncated and garbage Hilbert streams are rejected;
* under CNIIC_DEVICE_BITPACK=1 and CNIIC_DEVICE_HUF_DECODE=1 the Hufman,
  delta and cluster-colors streams and decodes equal the ungated ones and
  JAX's under the same gate;
* the registry keeps the reference's parse order, classes, names and
  refusals (`specs.AllFailed`, with JAX's text), and a CUDA device with no
  card is refused, never replaced by the CPU.
"""

import time

import numpy as np
import pytest
import torch

from cniic_tpu import codecs as jax_codecs
from cniic_tpu import specs as jax_specs
from cniic_tpu.codecs import from_spec as jax_from_spec
from cniic_tpu_torch import codecs, huffman, specs, wire
from cniic_tpu_torch.codecs import from_spec
from cniic_tpu_torch.ops import approx_rle, bitpack, hufdec
from cniic_tpu_torch.runner import compute_error
from test_golden_frontier import GOLDEN, SPECS, _synth


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


@pytest.mark.parametrize("spec", list(jax_codecs.ALL_SPECS)
                         + ["HUFMAN", "ccol(8)", "Hilbert(rle(2.5))"])
def test_registry_matches_jax(spec):
    port = from_spec(spec, device="cpu")
    ref = jax_from_spec(spec)
    assert type(port).__name__ == type(ref).__name__
    assert type(port) is getattr(codecs, type(ref).__name__)
    assert port.name == ref.name
    assert port.is_lossless == ref.is_lossless
    assert port.device.type == "cpu"


def test_registry_refusals_match_jax():
    assert codecs.ALL_SPECS == jax_codecs.ALL_SPECS
    for spec in ("bogus", "hilbert(foo)", "zip(foo)", "hilbert(rle(x))"):
        with pytest.raises(jax_specs.AllFailed) as want:
            jax_from_spec(spec)
        with pytest.raises(specs.AllFailed) as got:
            from_spec(spec, device="cpu")
        assert str(got.value) == str(want.value), spec


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
@pytest.mark.parametrize("spec", ["hufman", "delta", "cluster-colors(8)"])
def test_device_huffman_gates_match_ungated_and_jax(monkeypatch, corpus,
                                                     flag, spec):
    """Each Huffman gate on a CPU device runs its kernel's plain version
    (D1 packs the payload, D2 decodes it): streams and decodes equal the
    ungated ones and JAX's under the same gate."""
    port = from_spec(spec, device="cpu")
    ref = jax_from_spec(spec)
    imgs = [np.ascontiguousarray(im[:64, :80]) for im in corpus]
    imgs[1] = imgs[1][:48, :56].copy()
    ungated = [port.encode(im) for im in imgs]
    ungated_dec = [port.decode(s) for s in ungated]
    calls = []
    for mod, name in ((bitpack, "pack_words_ref"), (hufdec, "walk_ref")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setenv(flag, "1")
    declines = hufdec.declines
    got = port.encode_batch(imgs)
    assert got == ungated
    assert got == ref.encode_batch(imgs)
    assert [port.encode(im) for im in imgs] == ungated
    for data, want in zip(got, ungated_dec):
        dec = port.decode(data)
        np.testing.assert_array_equal(dec, want)
        np.testing.assert_array_equal(dec, ref.decode(data))
    used = "pack_words_ref" if flag == "CNIIC_DEVICE_BITPACK" else "walk_ref"
    assert used in calls and len(set(calls)) == 1
    assert hufdec.declines == declines


def test_numpy_bit_packer_matches_native():
    rng = np.random.default_rng(12)
    freqs = rng.integers(1, 1000, 300)
    ids = rng.integers(0, 300, 5000).astype(np.int32)
    book = huffman.build_codebook(freqs)
    assert (huffman.encode_payload(ids, book, device=False)
            == huffman.encode_payload(ids, book))


def test_delta_and_zip_back_bindings_match_jax():
    """The delta and zip-back entry points of the port's native module give
    the JAX package's outputs and raise where they raise."""
    from cniic_tpu import native as jax_native
    from cniic_tpu_torch import native

    rng = np.random.default_rng(21)
    flat = rng.integers(0, 256, (5000, 3)).astype(np.uint8)
    flat[:2000] = flat[:2000] // 64 * 64  # a low-unique stretch
    perm = rng.permutation(5000).astype(np.int64)
    keys = native.delta_keys_gather(flat, perm)
    np.testing.assert_array_equal(keys, jax_native.delta_keys_gather(flat, perm))
    np.testing.assert_array_equal(keys, native.delta_keys(flat[perm]))
    for got, want in zip(native.delta_hist_gather(flat, perm),
                         native.hist_u32(keys)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="length mismatch"):
        native.delta_keys_gather(flat[:10], perm)
    payloads = np.zeros((2, 6), np.uint8)
    payloads[1, ::2] = 200  # +200 on every channel
    ids = np.array([1, 1, 0], np.int32)
    with pytest.raises(ValueError, match="out of u8 range"):
        native.delta_unpack(payloads, ids, np.arange(3))
    with pytest.raises(ValueError, match="out of range"):
        native.delta_unpack(payloads, np.array([0, 2, 0], np.int32),
                            np.arange(3))
    raw = flat.tobytes()
    packed = native.zip_back_encode(raw)
    assert packed == jax_native.zip_back_encode(raw)
    assert native.zip_back_decode(packed) == raw
    with pytest.raises(ValueError, match="cap"):
        native.zip_back_decode(packed, max_out=len(raw) - 1)


def test_delta_fallback_stats_and_wire_errors(corpus):
    """A non-contiguous image takes delta's unfused statistics path and
    still gives JAX's stream; a decode that leaves the u8 range raises
    WireError, as in JAX."""
    port = from_spec("delta", device="cpu")
    ref = jax_from_spec("delta")
    view = corpus[2][:, ::-1]
    assert not view.flags.c_contiguous
    data = port.encode(view)
    assert data == ref.encode(view) == port.encode(view.copy())
    np.testing.assert_array_equal(port.decode(data), view)
    # one 2x1 image whose second pixel would be 250 + 250
    leafs = wire.i16_triplets_to_wire(
        np.array([[250, 250, 250]], np.int16)).reshape(1, 6)
    stream = huffman.encode_stream(np.zeros(2, np.int32), np.array([2]),
                                   leafs, torch_device="cpu")
    bad = wire.pack_dims(2, 1) + stream
    for codec in (port, ref):
        with pytest.raises(wire.WireError if codec is port else Exception,
                           match="u8 range"):
            codec.decode(bad)
