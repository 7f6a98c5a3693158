"""Byte-level wire formats of the reference implementation.

Copy of ``cniic_tpu/wire.py``, unchanged apart from its imports: importing
anything from ``cniic_tpu`` imports jax, which this package never does.

The reference (hkapp/cniic) serializes everything through a small trait pair
(reference ``src/ser.rs``).  The layouts reproduced here:

* unsigned/signed integers are little-endian (ser.rs:31-108);
* ``usize`` is normalized to u64 (ser.rs:113-124);
* tuples serialize their fields in order (ser.rs:146-159);
* slices/Vecs are a u64 length prefix followed by the elements
  (ser.rs:164-184);
* fixed arrays ``[T; N]`` are the elements only, **no prefix**
  (ser.rs:188-205);
* ``Rgb<u8>`` serializes via the slice impl and therefore occupies
  **11 bytes**: an 8-byte little-endian length prefix with value 3, then the
  3 channel bytes (ser.rs:210-222).  This quirk is load-bearing: every
  RLE/zip-framed pixel and every Huffman tree leaf for a color carries it.

Also here: the MSB-first bit-writer semantics of the reference's bit layer
(bit.rs:183-253) used by the Huffman stages, plus vectorized numpy versions
of the hot per-pixel framings.
"""

from __future__ import annotations

import struct

import numpy as np

# ---------------------------------------------------------------------------
# Scalar little-endian packing (ser.rs:17-108)
# ---------------------------------------------------------------------------


def pack_u8(x: int) -> bytes:
    return struct.pack("<B", x)


def pack_u16(x: int) -> bytes:
    return struct.pack("<H", x)


def pack_i16(x: int) -> bytes:
    return struct.pack("<h", x)


def pack_u32(x: int) -> bytes:
    return struct.pack("<I", x)


def pack_u64(x: int) -> bytes:
    return struct.pack("<Q", x)


def pack_dims(w: int, h: int) -> bytes:
    """(u32, u32) tuple framing used as every codec's header (e.g. hufc.rs:13).

    Enforces the same 2^27-pixel plausibility bound as ByteReader.dims()
    so an oversized image fails loudly at encode time instead of encoding
    into a stream its own decoder would reject (round-trip symmetry)."""
    if w <= 0 or h <= 0 or w * h > 1 << 27:
        raise ValueError(
            f"image dimensions {w}x{h} exceed the 2^27-pixel framework cap")
    return pack_u32(w) + pack_u32(h)


def pack_rgb(r: int, g: int, b: int) -> bytes:
    """The 11-byte Rgb<u8> layout (ser.rs:210-214): u64 len=3 + payload."""
    return pack_u64(3) + bytes((r, g, b))


RGB_WIRE_SIZE = 11
_RGB_PREFIX = pack_u64(3)


class WireError(ValueError):
    """Malformed byte stream."""


class ByteReader:
    """Cursor-based reader over a byte buffer.

    The reference decodes from ``Iterator<Item = u8>``; a cursor over a
    contiguous buffer is the idiomatic (and vastly faster) Python analog.
    Returns ``None``-free values and raises :class:`WireError` at EOF, except
    for the ``try_*`` variants which mirror the reference's Option returns.
    """

    __slots__ = ("buf", "pos")

    def __init__(self, data) -> None:
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        self.buf = memoryview(bytes(data) if not isinstance(data, (bytes, bytearray, memoryview)) else data)
        self.pos = 0

    def __len__(self) -> int:
        return len(self.buf)

    def remaining(self) -> int:
        return len(self.buf) - self.pos

    def eof(self) -> bool:
        return self.pos >= len(self.buf)

    def take(self, n: int) -> memoryview:
        if self.remaining() < n:
            raise WireError(f"need {n} bytes, have {self.remaining()}")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return int.from_bytes(self.take(2), "little")

    def i16(self) -> int:
        return int.from_bytes(self.take(2), "little", signed=True)

    def u32(self) -> int:
        return int.from_bytes(self.take(4), "little")

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def dims(self) -> tuple[int, int]:
        """Image dimensions with a plausibility bound: decoders size their
        output buffers from these untrusted u32s, so absurd values must die
        here as a WireError instead of as a multi-GiB allocation (found by
        tests/test_fuzz_decode.py — a bit flip in the header asked
        hufman decode for 255 GiB). 2^27 pixels matches the framework-wide
        image cap (ops/kmeans.py validation)."""
        w, h = self.u32(), self.u32()
        if w == 0 or h == 0 or w * h > 1 << 27:
            # no encoder produces empty images (PNG loads are >= 1x1), and
            # downstream machinery (curve generation, point builders)
            # treats a zero dimension as an internal error
            raise WireError(f"implausible image dimensions {w}x{h}")
        return w, h

    def rgb(self) -> tuple[int, int, int]:
        """Inverse of :func:`pack_rgb` (ser.rs:216-222)."""
        n = self.u64()
        if n != 3:
            raise WireError(f"Rgb length prefix must be 3, got {n}")
        r, g, b = self.take(3)
        return r, g, b

    def try_u8(self):
        return None if self.eof() else self.u8()

    def try_u16(self):
        return None if self.remaining() < 2 else self.u16()

    def rest(self) -> memoryview:
        out = self.buf[self.pos :]
        self.pos = len(self.buf)
        return out


# ---------------------------------------------------------------------------
# Vectorized pixel framings (hot paths, numpy)
# ---------------------------------------------------------------------------


def rgb_stream_to_wire(pixels: np.ndarray) -> np.ndarray:
    """Frame an (N, 3) uint8 pixel stream as N×11-byte Rgb records.

    Mirrors ``SerStream`` over pixels (zipc.rs:17-19): each pixel costs 11
    bytes on the wire (the ser.rs:210-222 quirk). Native framing loop
    (several times faster than strided numpy writes on this host).
    """
    from . import native

    return native.rgb_frame(np.ascontiguousarray(pixels, dtype=np.uint8))


def wire_to_rgb_stream(data: np.ndarray, count: int | None = None) -> np.ndarray:
    """Inverse of :func:`rgb_stream_to_wire`; validates every length prefix."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if count is None:
        if data.size % RGB_WIRE_SIZE:
            raise WireError(f"stream size {data.size} is not a multiple of {RGB_WIRE_SIZE}")
        count = data.size // RGB_WIRE_SIZE
    elif data.size < count * RGB_WIRE_SIZE:
        # the C unframer trusts the count: a short untrusted buffer must be
        # rejected here, not read past (ASan fuzz finding, r4)
        raise WireError(
            f"framed stream holds {data.size} bytes, {count} records need "
            f"{count * RGB_WIRE_SIZE}")
    from . import native

    try:
        return native.rgb_unframe(data[: count * RGB_WIRE_SIZE], count)
    except ValueError as e:
        raise WireError(str(e))


def i16_triplets_to_wire(vals: np.ndarray) -> np.ndarray:
    """[i16; 3] layout for delta's SignedColor: 6 bytes, no prefix
    (hilbertc.rs:561-565 via ser.rs:188-195)."""
    vals = np.ascontiguousarray(vals, dtype="<i2")
    return vals.reshape(-1).view(np.uint8).copy()


def wire_to_i16_triplets(data: np.ndarray, count: int) -> np.ndarray:
    data = np.ascontiguousarray(data, dtype=np.uint8)
    return data[: count * 6].view("<i2").reshape(count, 3).copy()


# ---------------------------------------------------------------------------
# Bit layer (bit.rs) — MSB-first semantics
# ---------------------------------------------------------------------------


def bit_mask(nbits: int) -> int:
    """Keep the n right-most bits; saturates at 8 like bit.rs:103-105."""
    return ((1 << nbits) - 1) & 0xFF


def nth_bit_msb(byte: int, idx: int) -> int:
    """Bit at index counting from the most-significant side (bit.rs:70-86)."""
    return (byte >> (7 - idx)) & 1


def nth_bit_lsb(byte: int, idx: int) -> int:
    return (byte >> idx) & 1


def byte_from_bits_msb(bits) -> int:
    """Pack exactly 8 bits, first bit most significant (bit.rs:56-67)."""
    if len(bits) != 8:
        raise WireError("byte_from_bits needs exactly 8 bits")
    n = 0
    for b in bits:
        n = ((n << 1) | (b & 1)) & 0xFF
    return n


class BitWriter:
    """MSB-first bit→byte packer mirroring IoBitWriter (bit.rs:183-253).

    Supports interleaved bit and whole-byte writes with the same output byte
    sequence as the reference (fast byte-aligned path included), plus
    ``pad_and_flush`` zero-padding of the tail (bit.rs:243-253).

    Used for small host-side streams and as the parity oracle for the
    vectorized bit packer D1 in :mod:`cniic_tpu_torch.ops.bitpack`.
    """

    __slots__ = ("_out", "_cur", "_count")

    def __init__(self) -> None:
        self._out = bytearray()
        self._cur = 0
        self._count = 0

    def write_bit(self, b: int) -> None:
        self._cur = ((self._cur << 1) | (b & 1)) & 0xFF
        self._count += 1
        if self._count == 8:
            self._out.append(self._cur)
            self._cur = 0
            self._count = 0

    def write_byte(self, n: int) -> None:
        if self._count == 0:
            self._out.append(n & 0xFF)
        else:
            msb = (self._cur << (8 - self._count)) & 0xFF
            lsb = (n & 0xFF) >> self._count
            self._out.append(msb | lsb)
            self._cur = n & bit_mask(self._count)

    def write_bits(self, value: int, nbits: int) -> None:
        """Write `nbits` of `value`, most-significant of those bits first."""
        # Whole-byte fast path when aligned chunks are available.
        while nbits >= 8:
            nbits -= 8
            self.write_byte((value >> nbits) & 0xFF)
        for i in range(nbits - 1, -1, -1):
            self.write_bit((value >> i) & 1)

    def bit_len(self) -> int:
        return len(self._out) * 8 + self._count

    def pad_and_flush(self) -> None:
        if self._count:
            self._out.append((self._cur << (8 - self._count)) & 0xFF)
            self._cur = 0
            self._count = 0

    def getvalue(self) -> bytes:
        return bytes(self._out)


def bits_of_bytes_msb(data) -> np.ndarray:
    """Byte stream → flat bit stream, MSB first (bit.rs:256-259)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    return np.unpackbits(arr)
