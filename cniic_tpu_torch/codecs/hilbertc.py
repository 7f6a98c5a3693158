"""The `Hilbert` codec family (reference src/codec/hilbertc.rs:12-395), on an
explicit device.

Port of ``cniic_tpu/codecs/hilbertc.py``; the streams are byte-identical.

Variants (spec grammar hilbertc.rs:337-395):
    hilbert(rle)      exact RLE along the scan, lossless
    hilbert(rle(d))   approximate RLE: a run accepts a pixel while the
                      Euclidean distance between the run's running average
                      (f64) and the pixel is <= d; the emitted color is the
                      rounded average (hilbertc.rs:200-285)
    hilbert(zip)      zip-dict over the 11-byte-framed scan stream

Record format for both RLE variants: (u8 count, 11-byte Rgb) = 12 bytes
(hilbertc.rs:35-45 + the ser.rs:210-222 quirk); runs cap at count = 255
(hilbertc.rs:127-143).

By default every variant runs in the host C runtime. Two env gates send
approximate RLE to the device given as ``device``, as in ``cniic_tpu``:
``CNIIC_CHUNKED_RLE=1`` in `encode` (K2 over ~1024 speculative chunks of the
scan, seam-stitched to the exact engine's bytes) and ``CNIIC_PALLAS_RLE=1``
in `encode_batch` (K3, all streams of a batch in one launch).
"""

from __future__ import annotations

import os

import numpy as np

from .. import hilbert, native, resolve_device, wire
from .base import Codec, host_map


def _records_to_bytes(counts: np.ndarray, colors: np.ndarray) -> bytes:
    """(R,) u8 counts + (R, 3) u8 colors -> R x 12-byte records (one C
    sweep)."""
    return native.rle_records_frame(counts, colors)


class Hilbert(Codec):
    def __init__(self, mode: str, allow: float = 0.0, device="cuda") -> None:
        assert mode in ("rle", "zip")
        self.mode = mode
        self.allow = float(allow)
        self.device = resolve_device(device)

    def encode(self, img: np.ndarray) -> bytes:
        h, w = img.shape[:2]
        header = wire.pack_dims(w, h)
        if self.mode == "rle" and self.allow == 0.0:
            # one fused C pass over the raw image: curve gather + RLE +
            # record framing + header placement (identical bytes to
            # rle_frame(gather_rgb(...)))
            if img.dtype == np.uint8 and img.shape[2] == 3:
                return native.rle_frame_gather(
                    img.reshape(h * w, 3), hilbert.scan_indices(w, h),
                    prefix=header)
            return header + native.rle_frame(hilbert.linearize(img))
        scan = hilbert.linearize(img)
        if self.mode == "zip":
            framed = wire.rgb_stream_to_wire(scan)
            return header + native.zip_dict_encode(framed)
        if (os.environ.get("CNIIC_CHUNKED_RLE", "") == "1"
                and float(self.allow).is_integer()):
            # speculative ~1024-chunk device encode + exact seam stitching:
            # byte-identical to the native engine (pinned by tests)
            from ..ops import approx_rle as parle

            counts, colors = parle.approx_rle_chunked(
                scan, int(self.allow), device=self.device)
        else:
            counts, colors = native.approx_rle_encode(scan, self.allow)
        return header + _records_to_bytes(counts, colors)

    def decode(self, data) -> np.ndarray:
        r = wire.ByteReader(data)
        w, h = r.dims()
        n = w * h
        if self.mode == "zip":
            # dims are in the outer header here, so the decoded size is
            # known exactly: 11 wire bytes per pixel (LZ78-bomb guard)
            framed = np.frombuffer(
                native.zip_dict_decode(r.rest(), max_out=11 * n),
                dtype=np.uint8)
            scan = wire.wire_to_rgb_stream(framed, count=n)
        else:
            # fused C pass: record validation + run expansion +
            # inverse-curve scatter in one sweep
            buf = np.frombuffer(bytes(r.rest()), dtype=np.uint8)
            # coverage pre-check BEFORE generating the curve: a corrupted
            # header claiming huge-but-plausible dims otherwise forces
            # O(W*H) curve generation for a stream whose records can never
            # cover it. Each 12-byte record covers at most 255 pixels.
            if buf.size % 12 or (buf.size // 12) * 255 < n:
                raise wire.WireError(
                    f"RLE records cannot cover {w}x{h} pixels")
            try:
                img = native.rle_unframe_scatter(
                    buf, hilbert.scan_indices(w, h))
            except ValueError as e:
                raise wire.WireError(str(e))
            return img.reshape(h, w, 3)
        return hilbert.scatter(scan, w, h)

    def encode_batch(self, imgs) -> list[bytes]:
        """Approximate RLE of a batch in one K3 launch under
        CNIIC_PALLAS_RLE=1 (two images or more); otherwise each image goes
        through `encode`, the images spread over the host's CPUs
        (`host_map`). K3 is the f32 form of the recurrence, so its
        streams equal `cniic_tpu`'s batch route, not always the exact
        engine's."""
        if (self.mode != "rle" or self.allow == 0.0 or len(imgs) < 2
                or os.environ.get("CNIIC_PALLAS_RLE", "") in ("", "0")):
            return host_map(self.encode, imgs)
        from ..ops import approx_rle as parle

        scans = []
        lens = []
        for img in imgs:
            scans.append(hilbert.linearize(img))
            lens.append(scans[-1].shape[0])
        L = max(lens)
        batch = np.zeros((len(imgs), L, 3), np.uint8)
        for i, s in enumerate(scans):
            batch[i, : s.shape[0]] = s
        recs = parle.approx_rle_batch(batch, np.asarray(lens, np.int64),
                                      self.allow, device=self.device)
        out = []
        for img, (counts, colors) in zip(imgs, recs):
            h, w = img.shape[:2]
            out.append(wire.pack_dims(w, h) + _records_to_bytes(counts, colors))
        return out

    @property
    def name(self) -> str:
        if self.mode == "zip":
            return "hilbert-zip"
        if self.allow == 0.0:
            return "hilbert-rle"
        return f"hilbert-rle-approx_{_fmt_allow(self.allow)}"

    @property
    def is_lossless(self) -> bool:
        return self.mode == "zip" or self.allow == 0.0


def _fmt_allow(d: float) -> str:
    """Rust Display for f64 prints integral values without '.0'."""
    return str(int(d)) if float(d).is_integer() else repr(d)


def parse(spec: str, device="cuda"):
    """hilbert(rle) | hilbert(rle(<d>)) | hilbert(zip) (hilbertc.rs:337-395),
    as a codec on `device`."""
    from .. import specs

    call = specs.fun_call(spec)
    if call is None:
        raise specs.OtherParseError(f"Can't parse {spec!r} as a function")
    name, args = call
    specs.expect_name(name, "[Hh]ilbert")
    if len(args) != 1:
        raise specs.WrongNumberOfArguments(expected=1, found=len(args))
    arg = args[0]

    def parse_rle(s: str):
        if specs.matches_fully(s, "rle") is not None:
            return Hilbert("rle", 0.0, device=device)
        inner = specs.fun_call(s)
        if inner is None:
            raise specs.OtherParseError(f"Can't parse {s!r} as a function")
        rle_name, rle_args = inner
        specs.expect_name(rle_name, "rle")
        if len(rle_args) != 1:
            raise specs.WrongNumberOfArguments(expected=1, found=len(rle_args))
        try:
            d = float(rle_args[0])
        except ValueError as e:
            raise specs.OtherParseError(str(e))
        return Hilbert("rle", d, device=device)

    def parse_zip(s: str):
        if specs.matches_fully(s, "zip") is not None:
            return Hilbert("zip", device=device)
        raise specs.WrongName(expected="zip", found=s)

    return specs.Alternatives(arg).then_try("rle", parse_rle).then_try("zip", parse_zip).end()
