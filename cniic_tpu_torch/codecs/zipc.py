"""The `zip` codec wrapper (reference src/codec/zipc.rs).

Port of ``cniic_tpu/codecs/zipc.py``; the streams are byte-identical.

Wire: the LZ engine runs over the concatenation of the serialized dimensions
(8 bytes) and the 11-byte-framed row-major pixel stream (zipc.rs:15-25); the
dimensions are *inside* the compressed stream, unlike the hilbert(zip)
variant. Engines: zip-dict (LZ78/LZW pairs) and zip-back (LZ77), both exact
native implementations in the host C runtime. The decode caps its output at
the wire format's maximum (``native._ZIP_MAX_OUT``), so a crafted stream
cannot demand unbounded memory.

The codec runs on the host only. It still takes ``device`` and resolves it,
so the CLI and the runner treat every codec alike and a missing card is
refused for every spec.
"""

from __future__ import annotations

import numpy as np

from .. import native, resolve_device, wire
from .base import Codec, pixels_row_major


class Zip(Codec):
    def __init__(self, engine: str, device="cuda") -> None:
        assert engine in ("dict", "back")
        self.engine = engine
        self.device = resolve_device(device)

    def _raw_stream(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        header = np.frombuffer(wire.pack_dims(w, h), dtype=np.uint8)
        return np.concatenate(
            [header, wire.rgb_stream_to_wire(pixels_row_major(img))])

    def encode(self, img: np.ndarray) -> bytes:
        raw = self._raw_stream(img)
        if self.engine == "dict":
            return native.zip_dict_encode(raw)
        return native.zip_back_encode(raw)

    def decode(self, data) -> np.ndarray:
        buf = bytes(wire.ByteReader(data).rest())
        raw = (native.zip_dict_decode(buf) if self.engine == "dict"
               else native.zip_back_decode(buf))
        r = wire.ByteReader(raw)
        w, h = r.dims()
        pixels = wire.wire_to_rgb_stream(
            np.frombuffer(bytes(r.rest()), dtype=np.uint8), count=w * h)
        return pixels.reshape(h, w, 3)

    @property
    def name(self) -> str:
        return f"zip-{self.engine}"

    @property
    def is_lossless(self) -> bool:
        return True


def parse(spec: str, device="cuda") -> Zip:
    """zip(dict) | zip(back) (zipc.rs:62-81), as a codec holding `device`."""
    from .. import specs

    call = specs.fun_call(spec)
    if call is None:
        raise specs.OtherParseError("Incorrect syntax")
    name, args = call
    if specs.matches_fully(name, "zip") is None:
        raise specs.OtherParseError(f"Incorrect name: {name}")
    if len(args) != 1:
        raise specs.WrongNumberOfArguments(expected=1, found=len(args))
    if args[0] in ("dict", "back"):
        return Zip(args[0], device=device)
    raise specs.OtherParseError(f"Unrecognized argument: {args[0]}")
