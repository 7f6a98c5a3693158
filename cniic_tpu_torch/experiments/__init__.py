"""The port of `scripts/experiments/`: campaigns, profiles and probes.

Each module keeps its script's name and names its original in its
docstring; `zipback_matchfinder` is `zipback_tpu_matchfinder.py`. The
drivers `northstar`, `sweep`, `synth_corpus`, `measure_baseline` and
`convergence_study` sit at the package root. Every module runs as

    python -m cniic_tpu_torch.experiments.<name> [--device=cuda|cpu] ...

with `main(argv) -> int`; a module that touches a device takes `--device`
(cuda by default: with no card the run is refused, never moved to the CPU).
The campaigns take `--seed` and write what they find under `--out`
(default `findings/`, git-ignored).

* `fuzz_campaign`: mutated streams through the nine decoders (and D2);
* `roundtrip_campaign`: random images through the five encode contracts;
* `profile_clusterc`, `kmeans_phase_probe`, `profile_kmeans`,
  `profile_hufenc`, `batch_depth_study`, `voronoi_probe`,
  `interleave_probe`, `probe_cleg_scale`: where the encodes' time goes;
* `corpus_variance`: per-image content statistics (no device);
* `device_hist_rle_probe`, `zipback_matchfinder`: torch formulations of
  host stages on the card, held against the C and numpy references.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch

from .. import resolve_device


def open_device(name: str):
    """The torch device `name`, or None after saying on stderr why it is
    refused (a CUDA device with no card, or neither cuda nor cpu)."""
    try:
        return resolve_device(name)
    except (RuntimeError, ValueError) as e:
        print(f"Device unavailable\n{e}", file=sys.stderr)
        return None


def sync(dev) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def env_gates(names):
    """Set each named environment variable to "1" for the duration, then
    restore what was there."""
    old = {n: os.environ.get(n) for n in names}
    os.environ.update({n: "1" for n in old})
    try:
        yield
    finally:
        for n, val in old.items():
            if val is None:
                del os.environ[n]
            else:
                os.environ[n] = val
