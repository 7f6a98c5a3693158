"""Space-filling traversal of arbitrary W×H rectangles.

Copy of ``cniic_tpu/hilbert.py``: the curve providers (``CNIIC_CURVE``:
``gilbert``, ``snake``), the memory and disk caches, the gathers and
scatters, and the pure-Python ``gilbert_py`` twin, unchanged apart from its
imports, a lock around the memory caches (the host codecs ask for curves
from several threads at once) and the default place of the disk cache,
which lies inside this package's git-ignored ``_build/`` directory
(``CNIIC_HILBERT_CACHE`` overrides it). The curve comes from the same C
source as the reference's, so ``scan_indices`` agrees with it exactly
(tested).

The reference linearizes images along a pseudo-Hilbert scan of the exact
image rectangle (reference src/hilbert.rs:40-43). Here, as in ``cniic_tpu``,
the *generalized Hilbert* ("gilbert") construction serves the same purpose:
a bijective, locality-preserving scan of any W×H rectangle. Encode and
decode share the permutation, which is the only correctness requirement.
The permutation is not stored in the stream, so the scan codecs' streams are
not cross-decodable with the reference binary (PARITY.md).

Attribution: the gilbert recursion follows Jakub Červený's public
generalized-Hilbert algorithm (github.com/jakubcerveny/gilbert, 2-clause
BSD); the C implementation in cniic_native.c is an independent iterative
rewrite of that recursion.
"""

from __future__ import annotations

import functools
import os
import threading

import numpy as np

from . import _build, native

_DISK_CACHE = os.environ.get(
    "CNIIC_HILBERT_CACHE", os.path.join(_build.BUILD_DIR, "hilbert_cache"))


def _snake_curve(w: int, h: int) -> np.ndarray:
    """Boustrophedon raster: rows alternate direction. Bijective and
    unit-adjacent but locality-poor — a second provider proving the codec
    stack is curve-agnostic (and a worst-case comparator for ratio
    studies)."""
    xs = np.tile(np.arange(w, dtype=np.int32), (h, 1))
    xs[1::2] = xs[1::2, ::-1]
    ys = np.repeat(np.arange(h, dtype=np.int32), w).reshape(h, w)
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=1)


_PROVIDERS = {
    "gilbert": lambda w, h: native.gilbert_curve(w, h),
    "snake": _snake_curve,
}


def curve_name() -> str:
    """Active curve provider (CNIIC_CURVE, default gilbert). A Zhang–Kamata
    implementation would register here as "zhang" (see module docstring)."""
    name = os.environ.get("CNIIC_CURVE", "gilbert")
    if name not in _PROVIDERS:
        raise ValueError(f"unknown curve provider {name!r} "
                         f"(have: {sorted(_PROVIDERS)})")
    return name


@functools.lru_cache(maxsize=64)
def _scan_coords_for(name: str, w: int, h: int) -> np.ndarray:
    path = os.path.join(_DISK_CACHE, f"{name}_{w}x{h}.npy")
    if w * h >= 1 << 18:
        try:
            coords = np.load(path)
            coords.setflags(write=False)
            return coords
        except Exception:
            pass
    coords = _PROVIDERS[name](w, h)
    if w * h >= 1 << 18:
        try:
            os.makedirs(_DISK_CACHE, exist_ok=True)
            tmp = os.path.join(_DISK_CACHE, f".tmp{os.getpid()}_{w}x{h}.npy")
            np.save(tmp, coords)  # np.save appends .npy only if missing
            os.replace(tmp, path)
        except Exception:
            pass
    coords.setflags(write=False)
    return coords


# Held around every read of the three caches below, so that a curve missing
# from them is made once when several threads ask for it together
# (`codecs.base.host_map`); a hit holds it for the cache lookup alone.
_cache_lock = threading.Lock()


def scan_coords(w: int, h: int) -> np.ndarray:
    """(w*h, 2) int32 array of (x, y) positions in scan order.

    Cached in memory per (curve, shape) and on disk across processes (a
    DIV2K-sized curve costs ~0.2-1 s to generate; sweeps touch the same few
    shapes from many processes)."""
    name = curve_name()
    with _cache_lock:
        return _scan_coords_for(name, w, h)


@functools.lru_cache(maxsize=64)
def _scan_indices_for(name: str, w: int, h: int) -> np.ndarray:
    coords = _scan_coords_for(name, w, h)
    idx = coords[:, 1].astype(np.int64) * w + coords[:, 0]
    idx.setflags(write=False)
    return idx


def scan_indices(w: int, h: int) -> np.ndarray:
    """Flat row-major indices (y*w + x) in scan order; use as a gather map."""
    name = curve_name()
    with _cache_lock:
        return _scan_indices_for(name, w, h)


@functools.lru_cache(maxsize=64)
def _inverse_indices_for(name: str, w: int, h: int) -> np.ndarray:
    fwd = _scan_indices_for(name, w, h)
    inv = np.empty_like(fwd)
    inv[fwd] = np.arange(fwd.size, dtype=np.int64)
    inv.setflags(write=False)
    return inv


def inverse_indices(w: int, h: int) -> np.ndarray:
    """inverse permutation: position of each row-major pixel in the scan."""
    name = curve_name()
    with _cache_lock:
        return _inverse_indices_for(name, w, h)


def linearize(img: np.ndarray) -> np.ndarray:
    """uint8[H, W, 3] → uint8[H*W, 3] pixels in scan order."""
    h, w = img.shape[:2]
    flat = img.reshape(h * w, -1)
    if flat.dtype == np.uint8 and flat.shape[1] == 3:
        return native.gather_rgb(flat, scan_indices(w, h))
    return flat[scan_indices(w, h)]


def scatter(pixels: np.ndarray, w: int, h: int) -> np.ndarray:
    """Inverse of :func:`linearize`: scan-ordered pixels → uint8[H, W, 3]."""
    if pixels.dtype == np.uint8 and pixels.shape[-1] == 3:
        return native.scatter_rgb(pixels, scan_indices(w, h), h * w).reshape(h, w, 3)
    out = np.empty((h * w, pixels.shape[-1]), dtype=pixels.dtype)
    out[scan_indices(w, h)] = pixels
    return out.reshape(h, w, -1)


# ---------------------------------------------------------------------------
# Pure-Python twin of the native recursion (for cross-check tests)
# ---------------------------------------------------------------------------


def _sgn(x: int) -> int:
    return (x > 0) - (x < 0)


def gilbert_py(w: int, h: int):
    """Generator over (x, y); must match native.gilbert_curve exactly."""
    if w >= h:
        yield from _gen(0, 0, w, 0, 0, h)
    else:
        yield from _gen(0, 0, 0, h, w, 0)


def _gen(x, y, ax, ay, bx, by):
    w = abs(ax + ay)
    h = abs(bx + by)
    dax, day = _sgn(ax), _sgn(ay)
    dbx, dby = _sgn(bx), _sgn(by)

    if h == 1:
        for _ in range(w):
            yield (x, y)
            x += dax
            y += day
        return
    if w == 1:
        for _ in range(h):
            yield (x, y)
            x += dbx
            y += dby
        return

    ax2, ay2 = ax // 2, ay // 2
    bx2, by2 = bx // 2, by // 2
    w2 = abs(ax2 + ay2)
    h2 = abs(bx2 + by2)

    if 2 * w > 3 * h:
        if (w2 % 2) and (w > 2):
            ax2 += dax
            ay2 += day
        yield from _gen(x, y, ax2, ay2, bx, by)
        yield from _gen(x + ax2, y + ay2, ax - ax2, ay - ay2, bx, by)
    else:
        if (h2 % 2) and (h > 2):
            bx2 += dbx
            by2 += dby
        yield from _gen(x, y, bx2, by2, ax2, ay2)
        yield from _gen(x + bx2, y + by2, ax, ay, bx - bx2, by - by2)
        yield from _gen(
            x + (ax - dax) + (bx2 - dbx),
            y + (ay - day) + (by2 - dby),
            -bx2,
            -by2,
            -(ax - ax2),
            -(ay - ay2),
        )
