"""Codec registry and spec dispatch (reference src/codec.rs:111-127).

Port of ``cniic_tpu/codecs/__init__.py``. Alternatives are tried in the
reference's fixed order: ClusterColors, VoronoiCluster, Delta, Hilbert,
Hufman, Zip (codec.rs:120-127). The k-means families and the Hilbert family
are ported; a spec none of them accepts would go to Delta, Hufman or Zip,
which are not ported yet, so it raises ``NotImplementedError``.
"""

from __future__ import annotations

import functools

from .. import specs
from .base import Codec
from .clusterc import ClusterColors, VoronoiCluster, parse_cluster_colors, parse_voronoi
from .hilbertc import Hilbert
from .hilbertc import parse as parse_hilbert

__all__ = ["Codec", "ClusterColors", "VoronoiCluster", "Hilbert", "from_spec",
           "PORTED"]

PORTED = ("cluster-colors(<n>)", "voronoi(<n>)", "hilbert(rle)",
          "hilbert(rle(<d>))", "hilbert(zip)")


def from_spec(spec: str, device="cuda") -> Codec:
    """Parse a codec spec string (AnyCodec::from_str, codec.rs:43-57) into a
    codec that runs on `device` ("cuda" or "cpu"; a missing card raises)."""
    try:
        return (
            specs.Alternatives(spec)
            .then_try("ClusterColors",
                      functools.partial(parse_cluster_colors, device=device))
            .then_try("VoronoiCluster",
                      functools.partial(parse_voronoi, device=device))
            .then_try("Hilbert",
                      functools.partial(parse_hilbert, device=device))
            .end()
        )
    except specs.AllFailed as e:
        raise NotImplementedError(
            f"codec spec {spec!r} is not ported yet to cniic_tpu_torch "
            f"(ported: {', '.join(PORTED)}); the Delta, Hufman and Zip "
            "families run in cniic_tpu") from e
