"""The golden 3840x2160 pins on the port (`cniic_tpu_torch`, CPU device).

Every k-means stage is integer-exact, so the port must reproduce the pins
the JAX package holds at this size, which no other test of the port
reaches: the committed voronoi(128) stream
`tests/fixtures/voronoi128_synth4k.bin` decodes to the pinned MSE, a side
over 16,384 is refused with the JAX package's ValueError through the codec,
and cluster-colors(32) encodes the seed-42 image to the pinned bytes (the
k-means loop over ~1.3M unique colours, one iteration a step of K1's and
D3's plain versions).

The image is generated in-process from its seed by this file's copy of the
recipe of scripts/make_synth_corpus.py::synth_natural, so this file needs
nothing but numpy and the port.
"""

import hashlib
import os

import numpy as np
import pytest

from cniic_tpu_torch import wire
from cniic_tpu_torch.codecs import from_spec

_IMG_SHA = "cd3007fd8c3d56783a8a9714e4641e005e1e7a133ef60817bc23efc75aa33ab3"
_STREAM_SHA = "df51eee5af16fd1a47af40fea1e8cc1112aacf3d8f8d6fe48a6dfa69911ba857"
_MSE = 491.312682  # 3840x2160, reference convention (bench.rs:95-104)
_CC_STREAM_SHA = "7e59789fa8091719be107ebe62cda1cb5cfbe442bedc9adcc51f5e3deb26c7e3"
_CC_SIZE = 5_082_919
_CC_MSE = 180.117916

_FIX = os.path.join(os.path.dirname(__file__), "fixtures",
                    "voronoi128_synth4k.bin")


def synth_natural(rng, h, w):
    """Natural-statistics field: 1/f^1.8 spectrum, correlated channels,
    flat patches, mild noise (the recipe of
    scripts/make_synth_corpus.py::synth_natural; seed 42 at 2160 x 3840 is
    the image of the golden 4K pins)."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = f[0, 1]
    spec = 1.0 / f ** 1.8

    def field():
        ph = rng.normal(size=(h, w // 2 + 1)) + 1j * rng.normal(size=(h, w // 2 + 1))
        x = np.fft.irfft2(ph * spec, s=(h, w))
        lo, hi = np.percentile(x, [1, 99])
        return np.clip((x - lo) / (hi - lo + 1e-9), 0, 1)

    lum = field()
    c1, c2 = field(), field()
    r = np.clip(lum * 0.75 + c1 * 0.35 - 0.05, 0, 1)
    g = np.clip(lum * 0.85 + c2 * 0.20 - 0.02, 0, 1)
    b = np.clip(lum * 0.65 + (1 - c1) * 0.30, 0, 1)
    img = np.stack([r, g, b], axis=-1) * 255.0
    for _ in range(int(rng.integers(4, 9))):
        y0, x0 = rng.integers(0, h * 3 // 4), rng.integers(0, w * 3 // 4)
        hh, ww = rng.integers(h // 12, h // 4), rng.integers(w // 12, w // 4)
        patch = img[y0:y0 + hh, x0:x0 + ww]
        img[y0:y0 + hh, x0:x0 + ww] = patch.mean(axis=(0, 1))
    img = img + rng.normal(0, 1.4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def synth4k():
    img = synth_natural(np.random.default_rng(42), 2160, 3840)
    assert hashlib.sha256(img.tobytes()).hexdigest() == _IMG_SHA
    return img


def _mse(img, out):
    d = img.astype(np.int64) - out.astype(np.int64)
    return float((d.astype(np.float64) ** 2).sum()) / (img.shape[0]
                                                       * img.shape[1])


def test_voronoi128_4k_fixture_decodes_to_pinned_mse(synth4k):
    with open(_FIX, "rb") as fh:
        data = fh.read()
    assert hashlib.sha256(data).hexdigest() == _STREAM_SHA
    assert len(data) == 16 + 19 * 128  # header + k exact 19-byte centroids
    r = wire.ByteReader(data)
    assert r.dims() == (3840, 2160)
    assert r.u64() == 128
    out = from_spec("voronoi(128)", device="cpu").decode(data)
    assert out.shape == (2160, 3840, 3)
    assert _mse(synth4k, out) == pytest.approx(_MSE, abs=1e-4)


def test_side_over_16384_raises_value_error():
    """Coordinates must fit the 16,384-wide exact-arithmetic budget, so a
    wider image is refused before any heavy work, as in the JAX package."""
    img = np.zeros((8, 16390, 3), np.uint8)
    img[:, ::7, 0] = 255  # enough distinct points for k=128
    with pytest.raises(ValueError, match="16383"):
        from_spec("voronoi(128)", device="cpu").encode(img)


def test_cluster_colors32_4k_golden_stream_and_mse(synth4k):
    codec = from_spec("cluster-colors(32)", device="cpu")
    data = codec.encode(synth4k)
    assert len(data) == _CC_SIZE
    assert hashlib.sha256(data).hexdigest() == _CC_STREAM_SHA
    out = codec.decode(data)
    assert out.shape == (2160, 3840, 3)
    assert _mse(synth4k, out) == pytest.approx(_CC_MSE, abs=1e-4)
