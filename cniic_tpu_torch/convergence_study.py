"""Quantify the k-means stopping-rule divergence from the reference.

Copy of ``scripts/convergence_study.py``, unchanged apart from its imports,
``main(argv)`` and ``--device``. The reference iterates strictly until no
point changes cluster (kmeans.rs:26). ``ops/kmeans.py`` adds two early
stops (<0.1% moved; move-count plateau) because integer-truncated means at
megapixel scale leave a small fraction of boundary points limit-cycling
forever. This script measures the frontier impact: per codec config and
image, (compressed_size, MSE, seconds) under the default rule vs
CNIIC_KMEANS_STRICT=1, printed as a markdown table (PARITY.md records the
JAX package's).

    python -m cniic_tpu_torch.convergence_study            # small, on the CPU
    python -m cniic_tpu_torch.convergence_study big [--device=cuda|cpu]

The small study runs on the CPU (deterministic, no card). `big` runs at
megapixel scale on --device, cuda by default; with no card it is refused,
never moved to the CPU.
"""

import os
import sys
import time

import numpy as np

from . import resolve_device
from .codecs import from_spec
from .runner import compute_error
from .synth_corpus import synth


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    big = bool(argv) and argv[0] == "big"
    device = "cpu"
    if big:
        device = next((a.split("=", 1)[1] for a in argv
                       if a.startswith("--device=")), "cuda")
        try:
            resolve_device(device)
        except (RuntimeError, ValueError) as e:  # no card: refused
            print(f"Device unavailable\n{e}", file=sys.stderr)
            return 1
        # megapixel scale — where the limit-cycling actually appears
        rng = np.random.default_rng(2024)
        imgs = [("768x768", synth(rng, 768, 768)),
                ("1024x1024", synth(rng, 1024, 1024))]
        specs = ["cluster-colors(32)", "voronoi(128)"]
    else:
        rng = np.random.default_rng(42)
        imgs = [("96x128", synth(rng, 96, 128)), ("128x128", synth(rng, 128, 128)),
                ("80x112", synth(rng, 80, 112))]
        rng2 = np.random.default_rng(3)
        imgs.append(("256x256", synth(rng2, 256, 256)))
        specs = ["cluster-colors(16)", "cluster-colors(32)", "cluster-colors(64)",
                 "voronoi(64)", "voronoi(128)", "voronoi(256)"]

    print("| codec | image | size (plateau) | size (strict) | MSE (plateau) | MSE (strict) | dMSE % | s (plateau) | s (strict) |")
    print("|---|---|---|---|---|---|---|---|---|")
    old = os.environ.pop("CNIIC_KMEANS_STRICT", None)
    try:
        for spec in specs:
            codec = from_spec(spec, device=device)
            for name, img in imgs:
                os.environ.pop("CNIIC_KMEANS_STRICT", None)
                t0 = time.perf_counter()
                d1 = codec.encode(img)
                t1 = time.perf_counter() - t0
                m1 = compute_error(img, codec.decode(d1))
                os.environ["CNIIC_KMEANS_STRICT"] = "1"
                t0 = time.perf_counter()
                d2 = codec.encode(img)
                t2 = time.perf_counter() - t0
                m2 = compute_error(img, codec.decode(d2))
                os.environ.pop("CNIIC_KMEANS_STRICT", None)
                dm = 100.0 * (m1 - m2) / m2 if m2 else 0.0
                print(f"| {codec.name} | {name} | {len(d1)} | {len(d2)} | "
                      f"{m1:.2f} | {m2:.2f} | {dm:+.2f} | {t1:.1f} | {t2:.1f} |",
                      flush=True)
    finally:
        if old is not None:
            os.environ["CNIIC_KMEANS_STRICT"] = old
    return 0


if __name__ == "__main__":
    sys.exit(main())
