"""The `delta` codec (reference src/codec/hilbertc.rs:397-582), on an
explicit device.

Port of ``cniic_tpu/codecs/delta.py``; the streams are byte-identical.

Hilbert-order traversal, per-channel differences of consecutive pixels with
an implicit [0,0,0] predecessor, Huffman coding of the difference triplets.
Leaf wire format: 3 x i16 LE = 6 bytes, no length prefix (ser.rs:188-195).

The statistics (curve gather + diff + pack + histogram fused in one C pass)
and the decode (leaf gather + running sums + inverse-curve scatter, one C
pass) run on the host. The Huffman payload follows the reference's env
gates onto ``device`` (see ``huffman.py``): D1 packs it under
``CNIIC_DEVICE_BITPACK=1`` (one launch over the batch in ``encode_batch``
with two images or more), D2 decodes it under ``CNIIC_DEVICE_HUF_DECODE=1``.
"""

from __future__ import annotations

import os

import numpy as np

from .. import hilbert, huffman, native, resolve_device, wire
from ..ops import histogram
from .base import Codec, host_map

LEAF_SIZE = 6  # 3 x i16 LE


def _keys_to_leafs(uniq_keys: np.ndarray) -> np.ndarray:
    """Packed 9-bit-per-channel diff keys -> 6-byte i16x3 leaf payloads
    (the inverse of delta_keys' (d+255) packing), shared by both encode
    paths so they cannot drift."""
    uniq_diffs = np.empty((uniq_keys.size, 3), dtype=np.int16)
    uniq_diffs[:, 0] = ((uniq_keys >> 18) & 0x1FF).astype(np.int16) - 255
    uniq_diffs[:, 1] = ((uniq_keys >> 9) & 0x1FF).astype(np.int16) - 255
    uniq_diffs[:, 2] = (uniq_keys & 0x1FF).astype(np.int16) - 255
    return wire.i16_triplets_to_wire(uniq_diffs).reshape(-1, LEAF_SIZE)


def _scan_stats(img: np.ndarray):
    """(uniq keys, counts, inverse) of the Hilbert-scan diff keys: the fused
    C gather+diff+pack+histogram pass when the image is contiguous uint8
    RGB, else the scan, the keys and the histogram one after another."""
    h, w = img.shape[:2]
    flat = img.reshape(h * w, -1)
    if flat.dtype == np.uint8 and flat.shape[1] == 3 and flat.flags.c_contiguous:
        return native.delta_hist_gather(flat, hilbert.scan_indices(w, h))
    return histogram.key_histogram(native.delta_keys(hilbert.linearize(img)))


class Delta(Codec):
    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)

    def encode(self, img: np.ndarray) -> bytes:
        h, w = img.shape[:2]
        uniq, counts, inverse = _scan_stats(img)
        stream = huffman.encode_stream(inverse, counts, _keys_to_leafs(uniq),
                                       torch_device=self.device)
        return wire.pack_dims(w, h) + stream

    def decode(self, data) -> np.ndarray:
        r = wire.ByteReader(data)
        w, h = r.dims()
        payloads, ids = huffman.decode_stream(r.rest(), LEAF_SIZE, w * h,
                                              torch_device=self.device)
        try:
            img = native.delta_unpack(np.asarray(payloads), ids,
                                      hilbert.scan_indices(w, h))
        except ValueError as e:
            raise wire.WireError(str(e))
        return img.reshape(h, w, 3)

    def encode_batch(self, imgs) -> list[bytes]:
        """Fused C stats per image, then one D1 launch over the batch
        (huffman.batch_encode_streams), under CNIIC_DEVICE_BITPACK=1 with
        two images or more; otherwise the per-image lifecycle, the images
        spread over the host's CPUs (`host_map`)."""
        if len(imgs) < 2 or os.environ.get("CNIIC_DEVICE_BITPACK", "") != "1":
            return host_map(self.encode, imgs)

        stats = [_scan_stats(img) for img in imgs]
        streams = huffman.batch_encode_streams(
            [inv for (_, _, inv) in stats],
            [counts for (_, counts, _) in stats],
            [_keys_to_leafs(uniq) for (uniq, _, _) in stats],
            torch_device=self.device)
        return [
            wire.pack_dims(img.shape[1], img.shape[0]) + s
            for img, s in zip(imgs, streams)
        ]

    @property
    def name(self) -> str:
        return "delta"

    @property
    def is_lossless(self) -> bool:
        return True


def parse(spec: str, device="cuda") -> Delta:
    from .. import specs

    specs.expect_name(spec, "delta")
    return Delta(device=device)
