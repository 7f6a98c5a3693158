"""The port's nine decoders on adversarial input, held to `cniic_tpu`'s.

Ported from tests/test_fuzz_decode.py, test for test, on the CPU:

* the nine-family fuzz: truncations, bit flips, byte smashes, header
  traps, garbage and tail junk; decode succeeds with a plausible uint8
  image or raises the ValueError family, never anything else;
* zip-bomb streams die at the output cap, not after huge allocations;
* a tiny RLE payload claiming huge dims is refused before the curve.

Beyond the JAX tests:

* the differential, per family: the same mutated blobs go through
  `cniic_tpu`'s decoder (JAX on the CPU) and the port's; both raise the
  ValueError family, or both return equal pixels;
* the D2 gate: mutated hufman and delta streams large enough to reach D2
  (`experiments.fuzz_campaign.GATED_SHAPES`) decode under
  CNIIC_DEVICE_HUF_DECODE=1 through D2's plain version to the host
  decoder's outcome, and D2 decoded at least one of them (the card's
  kernel on the same blobs is in tests/test_torch_cuda.py).

The ASan build of the port's C runtime reruns this file (README).
"""

from __future__ import annotations

import time
import zlib

import numpy as np
import pytest

from cniic_tpu.codecs import from_spec as jax_from_spec
from cniic_tpu_torch import native, wire
from cniic_tpu_torch.codecs import from_spec
from cniic_tpu_torch.experiments import fuzz_campaign
from cniic_tpu_torch.ops import hufdec

# one decode machine per entry: (spec, mutation budget scale)
FAMILIES = [
    ("hufman", 1.0),
    ("zip(dict)", 1.0),
    ("zip(back)", 1.0),
    ("hilbert(rle)", 1.0),
    ("hilbert(rle(2))", 1.0),
    ("hilbert(zip)", 1.0),
    ("delta", 1.0),
    ("cluster-colors(4)", 0.4),  # device-side tails: keep the budget lean
    ("voronoi(4)", 0.4),
]
IDS = [f for f, _ in FAMILIES]
ALLOWED = (ValueError,)  # WireError subclasses ValueError


def _test_image() -> np.ndarray:
    rng = np.random.default_rng(99)
    img = np.zeros((16, 24, 3), np.uint8)
    img[:, :, 0] = np.linspace(0, 255, 24, dtype=np.uint8)[None, :]
    img[4:9, 3:15] = [200, 40, 90]
    img[10:, 16:] = rng.integers(0, 256, (6, 8, 3))
    return img


def _blobs(spec: str, scale: float, data: np.ndarray) -> list:
    """tests/test_fuzz_decode.py's mutation series of one family's stream,
    in its order and from its generator."""
    n = data.size
    rng = np.random.default_rng(zlib.crc32(spec.encode()))
    out = [data[:cut] for cut in range(min(n, 40))]
    out += [data[:cut] for cut in rng.integers(0, n, int(30 * scale))]
    for pos in rng.integers(0, n, int(120 * scale)):
        m = data.copy()
        m[pos] ^= 1 << int(rng.integers(0, 8))
        out.append(m)
    for pos in rng.integers(0, n, int(60 * scale)):
        for val in (0x00, 0xFF, 0x80):
            m = data.copy()
            m[pos] = val
            out.append(m)
    for pos in range(min(n, 24)):
        for val in (0x00, 0xFF, (int(data[pos]) + 1) & 0xFF):
            m = data.copy()
            m[pos] = val
            out.append(m)
    for ln in list(rng.integers(0, 400, int(25 * scale))) + [0, 1, 2, 3]:
        out.append(rng.integers(0, 256, int(ln)).astype(np.uint8))
    for extra in (1, 7, 256):
        out.append(np.concatenate(
            [data, rng.integers(0, 256, extra).astype(np.uint8)]))
    return [bytes(b) for b in out]


def _check(codec, blob: bytes):
    """Decode one mutated stream: ("raised", None) or ("ok", image)."""
    try:
        out = codec.decode(blob)
    except ALLOWED:
        return "raised", None
    assert isinstance(out, np.ndarray) and out.dtype == np.uint8 \
        and out.ndim == 3 and out.shape[2] == 3, \
        f"decode returned a malformed image: {type(out)}"
    # a benign mutation must not smuggle out an image past the wire-layer
    # plausibility cap (2^27 pixels, wire.ByteReader.dims)
    assert out.size <= 3 << 27, f"implausible decode size {out.shape}"
    return "ok", out


@pytest.fixture(scope="module")
def streams():
    """Each family's stream of the test image, from the port (equal to
    JAX's: the parity tests pin that)."""
    return {spec: from_spec(spec, device="cpu").encode(_test_image())
            for spec, _ in FAMILIES}


@pytest.mark.parametrize("spec,scale", FAMILIES, ids=IDS)
def test_fuzz_decode(spec, scale, streams):
    codec = from_spec(spec, device="cpu")
    data = np.frombuffer(streams[spec], np.uint8).copy()
    outcomes = {"ok": 0, "raised": 0}
    for blob in _blobs(spec, scale, data):
        outcomes[_check(codec, blob)[0]] += 1
    # sanity: the harness must have actually exercised both outcomes
    assert outcomes["raised"] > 0, "no mutation was ever rejected"
    assert _check(codec, bytes(data))[0] == "ok", \
        "unmutated stream must decode"


@pytest.mark.parametrize("spec,scale", FAMILIES, ids=IDS)
def test_fuzz_decode_matches_jax(spec, scale, streams):
    """The same blobs through JAX's decoder and the port's: the same
    outcome for every blob, and equal pixels where both decode."""
    port = from_spec(spec, device="cpu")
    ref = jax_from_spec(spec)
    assert ref.encode(_test_image()) == streams[spec]
    data = np.frombuffer(streams[spec], np.uint8).copy()
    seen = set()
    for i, blob in enumerate(_blobs(spec, scale, data)):
        got, img = _check(port, blob)
        want, ref_img = _check(ref, blob)
        assert got == want, f"blob {i}: port {got}, JAX {want}"
        if got == "ok":
            np.testing.assert_array_equal(img, ref_img, err_msg=f"blob {i}")
        seen.add(got)
    assert seen == {"ok", "raised"}


def test_zip_bomb_streams_rejected_bounded():
    """LZ78/LZ77 expansion bombs must die at the output cap, not after
    multi-GB allocations. A doubling zip-dict pair chain and a doubling
    zip-back lookback chain are decoded with a small explicit cap to prove
    the bound binds early."""
    pairs = [(97, 97)] + [(0x100 + i, 0x100 + i) for i in range(30)]
    bomb = b"".join(a.to_bytes(2, "little") + b.to_bytes(2, "little")
                    for a, b in pairs)
    with pytest.raises(ValueError):
        native.zip_dict_decode(bomb, max_out=10_000)

    out = bytearray((6).to_bytes(2, "little") + b"abcdef")
    ln = 6
    for _ in range(20):
        cl = min(ln, 32767)
        out += (0x8000 | cl).to_bytes(2, "little") + cl.to_bytes(2, "little")
        ln += cl
    with pytest.raises(ValueError):
        native.zip_back_decode(bytes(out), max_out=10_000)

    # the codec-level default cap also rejects them (zipc path)
    big = b"".join(a.to_bytes(2, "little") + b.to_bytes(2, "little")
                   for a, b in [(97, 97)] + [(0x100 + i, 0x100 + i)
                                             for i in range(48)])
    with pytest.raises((ValueError, wire.WireError)):
        from_spec("zip(dict)", device="cpu").decode(big)


def test_hilbert_rle_huge_dims_rejected_fast():
    """A tiny RLE payload claiming huge-but-plausible dims must be rejected
    BEFORE curve generation (the curve for a 2^27-px claim costs ~1 GB of
    indices)."""
    blob = wire.pack_dims(16000, 8000) + b"\x05" + wire.pack_rgb(1, 2, 3)
    t0 = time.perf_counter()
    with pytest.raises(wire.WireError):
        from_spec("hilbert(rle)", device="cpu").decode(blob)
    assert time.perf_counter() - t0 < 0.5, "rejection generated the curve"


@pytest.mark.parametrize("spec", fuzz_campaign.GATED)
def test_d2_gate_decodes_mutated_streams_like_the_host(spec, monkeypatch):
    """Mutated streams whose payloads exceed D2's chunk: under the gate
    (D2's plain version `walk_ref` on the CPU) every outcome equals the
    host decoder's, and D2 decoded some of them (not all declined)."""
    codec = from_spec(spec, device="cpu")
    blobs = fuzz_campaign.mutated_blobs(codec, 2024, 16,
                                        fuzz_campaign.GATED_SHAPES)
    host = [_check(codec, b) for b in blobs]
    monkeypatch.setenv(fuzz_campaign.GATE, "1")
    decodes, declines = hufdec.decodes, hufdec.declines
    for i, (blob, (want, img)) in enumerate(zip(blobs, host)):
        got, dec = _check(codec, blob)
        assert got == want, f"blob {i}: {got} under the gate, {want} without"
        if got == "ok":
            np.testing.assert_array_equal(dec, img, err_msg=f"blob {i}")
    engaged = hufdec.decodes - decodes
    assert engaged > 0, (f"D2 decoded none of {len(blobs)} blobs "
                         f"({hufdec.declines - declines} declined)")
