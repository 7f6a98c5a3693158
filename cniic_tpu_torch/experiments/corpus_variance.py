"""Per-image content statistics that explain a corpus's lossy results.

Port of ``scripts/experiments/corpus_variance.py`` (numpy over the port's
``image_io``; no device):

- grid-cell variance at the voronoi-equivalent cell area for k in
  {64, 256, 2048}: the content-side proxy for the voronoi codec's MSE at
  that k (positional k-means cells are near-square on uniform content);
- the unique-colour count and the share of pixels within the dominant
  colour mode (an 8-px-radius ball around the most common quantized
  colour): what the unique-colour-weighted k-means of cluster-colors sees;
- per-channel sigma, the overall contrast.

    python -m cniic_tpu_torch.experiments.corpus_variance <pngs...>
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .. import image_io


def grid_cell_variance(img: np.ndarray, k: int) -> float:
    h, w, _ = img.shape
    side = max(1, int(np.sqrt(h * w / k)))
    H, W = h // side * side, w // side * side
    x = img[:H, :W].astype(np.float64)
    cells = x.reshape(H // side, side, W // side, side, 3)
    cells = cells.transpose(0, 2, 1, 3, 4).reshape(-1, side * side, 3)
    return float(cells.var(axis=1).sum(axis=1).mean())


def dominant_share(img: np.ndarray) -> tuple[float, int]:
    px = img.reshape(-1, 3)
    uniq, counts = np.unique(
        (px >> 2).astype(np.uint32) @ np.array([1, 64, 4096], dtype=np.uint32),
        return_counts=True)
    mode_key = uniq[counts.argmax()]
    mode = np.array([mode_key % 64, (mode_key // 64) % 64, mode_key // 4096],
                    dtype=np.int64) * 4 + 2
    d2 = ((px.astype(np.int64) - mode) ** 2).sum(axis=1)
    share = float((d2 <= 64).mean())  # within an 8-px-radius color ball
    n_uniq = len(np.unique(px.astype(np.uint32) @ np.array(
        [1, 256, 65536], dtype=np.uint32)))
    return share, n_uniq


def main(argv=None) -> int:
    paths = list(sys.argv[1:] if argv is None else argv)
    if not paths:
        print(__doc__, file=sys.stderr)
        return 1
    rows = []
    for p in paths:
        img = image_io.load_image(p)
        v = {k: grid_cell_variance(img, k) for k in (64, 256, 2048)}
        share, n_uniq = dominant_share(img)
        sig = img.astype(np.float64).std(axis=(0, 1))
        rows.append((os.path.basename(p), v, share, n_uniq, sig))
        print(f"{os.path.basename(p)}: cellvar(k=64/256/2048) "
              f"{v[64]:.0f}/{v[256]:.0f}/{v[2048]:.0f}  dominant-ball "
              f"{share:.2f}  uniq {n_uniq}  sigma "
              f"{sig[0]:.1f}/{sig[1]:.1f}/{sig[2]:.1f}")
    if len(rows) > 1:
        for k in (64, 256, 2048):
            m = np.mean([r[1][k] for r in rows])
            print(f"corpus mean cellvar k={k}: {m:.0f}")
        print(f"corpus mean dominant-ball share: "
              f"{np.mean([r[2] for r in rows]):.2f}")
        print(f"corpus mean unique colors: "
              f"{np.mean([r[3] for r in rows]):.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
