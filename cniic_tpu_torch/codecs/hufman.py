"""The `Hufman` codec (reference src/codec/hufc.rs), on an explicit device.

Port of ``cniic_tpu/codecs/hufman.py``; the streams are byte-identical.

Wire layout: (u32 w, u32 h) LE, preorder decoder trie with 11-byte Rgb
leaves, then the MSB-first Huffman payload over the row-major pixel stream
(hufc.rs:12-17). The symbol alphabet is the set of 24-bit colors actually
present in the image.

The histogram, the tree and, by default, the packing and the decode run in
the host C runtime. The reference's env gates send the payload to
``device``: ``CNIIC_DEVICE_BITPACK=1`` packs it with D1 (``encode`` and, for
two images or more, one launch over the batch in ``encode_batch``) and
``CNIIC_DEVICE_HUF_DECODE=1`` decodes it with D2 (see ``huffman.py``).
Cluster-colors decode is this codec's decode.
"""

from __future__ import annotations

import os

import numpy as np

from .. import huffman, native, resolve_device, trace, wire
from ..ops import histogram
from .base import Codec, host_map, pixels_row_major


def _color_leafs(colors: np.ndarray) -> np.ndarray:
    return np.frombuffer(wire.rgb_stream_to_wire(colors), dtype=np.uint8
                         ).reshape(-1, wire.RGB_WIRE_SIZE)


class Hufman(Codec):
    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)

    def encode(self, img: np.ndarray) -> bytes:
        h, w = img.shape[:2]
        colors, counts, inverse = histogram.color_histogram(
            pixels_row_major(img))
        stream = huffman.encode_stream(inverse, counts, _color_leafs(colors),
                                       torch_device=self.device)
        return wire.pack_dims(w, h) + stream

    def decode(self, data) -> np.ndarray:
        r = wire.ByteReader(data)
        w, h = r.dims()
        payloads, ids = huffman.decode_stream(r.rest(), wire.RGB_WIRE_SIZE,
                                              w * h, torch_device=self.device)
        colors = wire.wire_to_rgb_stream(np.asarray(payloads).reshape(-1))
        # C palette gather — numpy's row fancy-index was 40% of decode
        return native.palette_gather(ids, colors).reshape(h, w, 3)

    def encode_batch(self, imgs) -> list[bytes]:
        """Batched encode: per-image fused C histogram + the shared tree and
        pack stage (huffman.batch_encode_streams), whose payloads go to D1
        in one launch. Only under CNIIC_DEVICE_BITPACK=1 with two images or
        more: on the host packer the per-image lifecycle wins, since the
        stage-major layout holds every image's multi-MB stats live at once
        and re-reads them cold; its images are spread over the host's CPUs
        (`host_map`)."""
        if len(imgs) < 2 or os.environ.get("CNIIC_DEVICE_BITPACK", "") != "1":
            return host_map(self.encode, imgs)

        with trace.span("huffman.stats"):
            stats = [histogram.color_histogram(pixels_row_major(img))
                     for img in imgs]
        streams = huffman.batch_encode_streams(
            [inv for (_, _, inv) in stats],
            [cnt for (_, cnt, _) in stats],
            [_color_leafs(colors) for (colors, _, _) in stats],
            torch_device=self.device)
        return [
            wire.pack_dims(img.shape[1], img.shape[0]) + s
            for img, s in zip(imgs, streams)
        ]

    @property
    def name(self) -> str:
        return "Hufman"

    @property
    def is_lossless(self) -> bool:
        return True


def parse(spec: str, device="cuda") -> Hufman:
    """Case-insensitive "hufman" (hufc.rs:51-63), as a codec on `device`."""
    from .. import specs

    if spec.lower() == "hufman":
        return Hufman(device=device)
    raise specs.OtherParseError("Not Hufman")
