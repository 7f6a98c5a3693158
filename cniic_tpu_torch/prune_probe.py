"""How much of K1's centroid scan an exact bound filter would skip.

    python -m cniic_tpu_torch.prune_probe [--device=cuda]
        [--k=1024,2048] [--seed=7] [--out=chiprun_out/prune_probe.json]

One voronoi(k) loop over the first `synth_corpus --midtex` image (2040x1356,
`--seed`), driven as the engine drives it, one K1 launch an iteration.
Beside it, the plain model of the filter (`kmeans_kernel.pruned_assign_ref`)
decides for each variant which points it would scan at every iteration,
with its own bounds, and its assignment is held to K1's: a point it keeps
must be one K1 did not move. Variants (the model's window W of centroid
snapshots and its G groups of centroid ids): Hamerly's rule, the bound
shrinking by the largest drift every step (W2), bounds held to the
snapshot of the point's last scan (W8, W16, W32), and the same with
Yinyang's bounds over 8 contiguous groups of centroid ids (W16G8). Prints,
for each k and variant, the share of points scanned over iterations 1-10,
11-50, 51-200 and the rest, and over the loop; the steals (clusters left
empty) and the largest drift with and without the stolen centroids. Writes
every iteration's readings to `--out`. Exit 1 if a kept point moved.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from . import synth_corpus
from .bench import device_label
from .experiments import open_device
from .ops import kmeans as km
from .ops import kmeans_kernel

VARIANTS = {"W2": (2, 1), "W8": (8, 1), "W16": (16, 1), "W32": (32, 1),
            "W16G8": (16, 8)}
SPANS = ((0, 10), (10, 50), (50, 200), (200, None))


def midtex_image(seed: int) -> np.ndarray:
    """`synth_corpus --midtex`'s first image."""
    return synth_corpus.synth_textured(np.random.default_rng(seed), 1356,
                                       2040, brightness=0.80)


def probe(img, k: int, dev, say=print) -> dict:
    """One loop; returns {variant: [scanned share an iteration]} and the
    steals and drifts an iteration."""
    ptsT, w = km._voronoi_setup(torch.from_numpy(img[None]).to(dev))
    _, d, n = ptsT.shape
    cur, cents = km._init_state(ptsT, [n], k)
    h, wd = img.shape[:2]
    pmax = [wd - 1, h - 1, 255, 255, 255]
    ns = torch.tensor([n], dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    act = torch.ones(1, dtype=torch.int32, device=dev)
    state = [torch.zeros((1, k, d + 1), **i64),
             torch.zeros(1, dtype=torch.int32, device=dev),
             torch.full((1,), n + 1, **i64), torch.full((1,), n + 1, **i64),
             torch.zeros(1, **i64), torch.zeros(1, **i64),
             torch.tensor([km._stop_threshold(n)], **i64)]
    step = kmeans_kernel.prepare_step(ptsT, w, cur, cents, ns, act, pmax,
                                      *state, km._STALL_LIMIT, 10_000)
    bounds = {v: kmeans_kernel.prune_bounds_ref(cents, n, win, g)
              for v, (win, g) in VARIANTS.items()}
    shares = {v: [] for v in VARIANTS}
    steals, maxdrift, maxdrift_kept = [], [], []
    kept_moved = 0
    t0 = time.perf_counter()
    guard = (torch.cuda.device(dev) if dev.type == "cuda"
             else contextlib.nullcontext())
    with guard:
        while bool(act[0]):
            old_cur, old_cents, was = cur.clone(), cents.clone(), act.clone()
            it = state[5].clone()
            step()
            for v in VARIANTS:
                new, _, _, scan = kmeans_kernel.pruned_assign_ref(
                    ptsT, w, old_cur, old_cents, ns, was, it, bounds[v])
                kept_moved += int((~scan[0] & (new[0] != cur[0])).sum())
                shares[v].append(float(scan.float().mean()))
                kmeans_kernel.snapshot_ref(bounds[v], cents, state[5],
                                           was != 0)
            empty = torch.bincount(cur[0].to(torch.int64), minlength=k) == 0
            diff = (cents - old_cents).to(torch.int64)
            drift = (diff * diff).sum(2).to(torch.float64).sqrt()
            steals.append(int(empty.sum()))
            maxdrift.append(float(drift.max()))
            maxdrift_kept.append(float(torch.where(
                empty[None], torch.zeros_like(drift), drift).max()))
    say(f"  k = {k}: {len(steals)} iterations in "
        f"{time.perf_counter() - t0:.1f} s, {sum(steals)} steals in "
        f"{sum(s > 0 for s in steals)} iterations; points kept by a filter "
        f"that K1 moved: {kept_moved}")
    for v, sh in shares.items():
        spans = []
        for lo, hi in SPANS:
            part = sh[lo:hi]
            spans.append(f"{np.mean(part):.4f}" if part else "-")
        say(f"    {v:8s} scanned share: iterations 1-10 {spans[0]}, 11-50 "
            f"{spans[1]}, 51-200 {spans[2]}, 201- {spans[3]}; over the "
            f"loop {np.mean(sh):.4f}")
    late = [i for i in range(200, len(steals))]
    with_steal = [i for i in late if steals[i]]
    say(f"    largest drift, iterations 201-: median "
        f"{np.median([maxdrift[i] for i in late]) if late else 0:.3f}, "
        f"without the stolen centroids "
        f"{np.median([maxdrift_kept[i] for i in late]) if late else 0:.3f}; "
        f"{len(with_steal)} of those iterations steal")
    return {"k": k, "iterations": len(steals), "kept_moved": kept_moved,
            "shares": shares, "steals": steals, "maxdrift": maxdrift,
            "maxdrift_without_stolen": maxdrift_kept}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--k", default="1024,2048")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default="chiprun_out/prune_probe.json")
    args = ap.parse_args(argv)
    dev = open_device(args.device)
    if dev is None:
        return 1
    img = midtex_image(args.seed)
    print(f"prune_probe on {device_label(dev.type)}: the first midtex image "
          f"(seed {args.seed}), {img.shape[1]}x{img.shape[0]}", flush=True)
    runs = [probe(img, int(k), dev) for k in args.k.split(",")]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"device": device_label(dev.type), "runs": runs}, fh)
    return 1 if any(r["kept_moved"] for r in runs) else 0


if __name__ == "__main__":
    sys.exit(main())
