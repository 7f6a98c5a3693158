"""Voronoi reconstruction and exact MSE (port of ``cniic_tpu/ops/voronoi.py``).

For every pixel, the reference picks the centroid minimizing
``(c.x - x).pow(2) + (c.y - y).pow(2)`` in u32 arithmetic, which *wraps*;
color is ignored, and ties resolve to the first (lowest index) centroid like
Rust's ``min_by_key`` (clusterc.rs:180-186). The stream's centroid
coordinates are any u32 (the parser accepts them), so the wrap is real on
hostile streams.

torch has no usable uint32 arithmetic, so the distances are int64 masked to
32 bits, computed without overflow: the wrapped difference is replaced by
its signed representative s in [-2^31, 2^31), whose square fits int64 and
agrees with the u32 square modulo 2^32. The distance is separable,
``dx^2[x, c] + dy^2[y, c] (mod 2^32)``, so the two (coordinate x centroid)
tables are built once per image and the (pixels x k) tile is one add, one
mask and one argmin, blocked over image rows. The MSE is an exact int64 sum.

Under a process group of several ranks the fused decode + MSE is
lane-sharded (``parallel/mesh.py``): a rank reconstructs its own lanes, the
MSEs are gathered through `mesh.sharded_mse`, and the images only when they
are fetched.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..parallel import mesh

_M32 = 0xFFFFFFFF
# elements of one (pixels x k) int64 distance tile
_TILE = 1 << 23


def _sq_u32(c, v):
    """(c - v)^2 mod 2^32 with u32 wraparound, for int64 centroid coordinates
    c[k] in [0, 2^32) and pixel coordinates v[m]; returns int64[m, k]."""
    s = (c[None, :] - v[:, None]) & _M32       # the u32 difference
    s = s - ((s >> 31) << 32)                  # signed representative
    return (s * s) & _M32                      # |s| <= 2^31: no overflow


def _nearest(cx, cy, w: int, h: int):
    """Index of the nearest centroid for every pixel, row-major: int64[h*w]."""
    dev = cx.device
    dx2 = _sq_u32(cx, torch.arange(w, dtype=torch.int64, device=dev))  # (w, k)
    dy2 = _sq_u32(cy, torch.arange(h, dtype=torch.int64, device=dev))  # (h, k)
    rows = max(1, _TILE // (w * cx.numel()))
    out = torch.empty((h, w), dtype=torch.int64, device=dev)
    for r in range(0, h, rows):
        d = (dy2[r:r + rows, None, :] + dx2[None, :, :]) & _M32
        out[r:r + rows] = torch.argmin(d, dim=2)   # first index among ties
    return out.reshape(-1)


def _reconstruct_one(xy: np.ndarray, colors: np.ndarray, w: int, h: int, dev):
    """uint8[h*w, 3] on `dev` from uint32[k, 2] centroids and uint8[k, 3]."""
    xy_t = torch.from_numpy(np.asarray(xy, np.int64)).to(dev)
    cols = torch.from_numpy(np.ascontiguousarray(colors, np.uint8)).to(dev)
    return cols[_nearest(xy_t[:, 0], xy_t[:, 1], w, h)]


def reconstruct(centroids_xy: np.ndarray, colors: np.ndarray, w: int, h: int,
                device="cuda") -> np.ndarray:
    """centroids_xy uint32[k, 2], colors uint8[k, 3] -> uint8[h, w, 3]."""
    return reconstruct_batch([centroids_xy], [colors], w, h, device)[0]


def reconstruct_batch(centroids_list, colors_list, w: int, h: int,
                      device="cuda"):
    """Same-shape batch decode; returns a list of uint8[h, w, 3]."""
    dev = resolve_device(device)
    return [_reconstruct_one(xy, cl, w, h, dev).reshape(h, w, 3).cpu().numpy()
            for xy, cl in zip(centroids_list, colors_list)]


def reconstruct_mse_batch(centroids_list, colors_list, w: int, h: int,
                          originals, device="cuda"):
    """Fused same-shape batch decode + exact MSE. originals: uint8[B, h, w, 3]
    as numpy or as a tensor already on the device (the encode upload).
    Returns (mses list[float], fetch) where fetch() pulls the reconstructed
    uint8[h, w, 3] images to the host; each MSE equals runner.compute_error
    on the fetched image (integer sum, f64 division). Lane-sharded under a
    group (`mesh.batch_mesh`): fetch() then gathers, so every rank calls it.
    """
    dev = resolve_device(device)
    B = len(centroids_list)
    group, lo, hi = mesh.batch_lanes(B)
    if not isinstance(originals, torch.Tensor):
        originals = torch.from_numpy(
            np.ascontiguousarray(originals[lo:hi], dtype=np.uint8))
    else:
        originals = originals[lo:hi]
    recs = torch.stack([
        _reconstruct_one(centroids_list[b], colors_list[b], w, h, dev)
        for b in range(lo, hi)]).reshape(hi - lo, h, w, 3)
    mses = mesh.sharded_mse(group, recs, originals.to(dev)).tolist()

    def fetch():
        out = recs if group is None else mesh.gather_lanes(group, recs)
        return list(out.cpu().numpy())

    return mses, fetch
