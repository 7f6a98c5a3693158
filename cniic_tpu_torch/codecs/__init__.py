"""Codec registry and spec dispatch (reference src/codec.rs:111-127).

Port of ``cniic_tpu/codecs/__init__.py``. Alternatives are tried in the
reference's fixed order: ClusterColors, VoronoiCluster, Delta, Hilbert,
Hufman, Zip (codec.rs:120-127) — the order matters because several grammars
overlap loosely. A spec none of them accepts raises ``specs.AllFailed``.
Every codec takes ``device`` and resolves it, so a missing card is refused
for every spec.
"""

from __future__ import annotations

import functools

from .. import specs
from . import delta as _delta, hilbertc as _hilbertc, hufman as _hufman, zipc as _zipc
from .base import Codec
from .clusterc import ClusterColors, VoronoiCluster, parse_cluster_colors, parse_voronoi
from .delta import Delta
from .hilbertc import Hilbert
from .hufman import Hufman
from .zipc import Zip

__all__ = [
    "Codec", "ClusterColors", "VoronoiCluster", "Delta", "Hilbert",
    "Hufman", "Zip", "from_spec", "ALL_SPECS",
]

# one representative spec per codec family (the reference Makefile sweep)
ALL_SPECS = (
    "hufman",
    "zip(dict)",
    "zip(back)",
    "hilbert(rle)",
    "hilbert(zip)",
    "delta",
    "hilbert(rle(4))",
    "cluster-colors(64)",
    "voronoi(256)",
)


def from_spec(spec: str, device="cuda") -> Codec:
    """Parse a codec spec string (AnyCodec::from_str, codec.rs:43-57) into a
    codec that runs on `device` ("cuda" or "cpu"; a missing card raises)."""
    alternatives = specs.Alternatives(spec)
    for name, parse in (("ClusterColors", parse_cluster_colors),
                        ("VoronoiCluster", parse_voronoi),
                        ("Delta", _delta.parse),
                        ("Hilbert", _hilbertc.parse),
                        ("Hufman", _hufman.parse),
                        ("Zip", _zipc.parse)):
        alternatives.then_try(name, functools.partial(parse, device=device))
    return alternatives.end()
