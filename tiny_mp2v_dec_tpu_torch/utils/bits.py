"""Bit-level I/O over MPEG-2 elementary streams.

``BitReader`` is the Python model of the native tokenizer's bit cursor
(reference design: src/core/bitstream.h:22-64 — a 64-bit big-endian shift
register refilled 32 bits at a time).  This implementation favours clarity;
the C++ tokenizer is the production path.

``BitWriter`` is the encode-side used by tests and the synthetic stream
generator (the reference only ships encode *tables* for tests; we ship a full
writer so end-to-end streams can be fuzzed).
"""
from __future__ import annotations


class BitReader:
    """MSB-first bit reader over a bytes-like buffer."""

    __slots__ = ("data", "pos")

    def __init__(self, data, bit_pos: int = 0):
        self.data = data
        self.pos = bit_pos  # absolute bit position

    def copy(self) -> "BitReader":
        return BitReader(self.data, self.pos)

    def peek(self, n: int) -> int:
        """Return the next n bits (MSB-first) without consuming them.
        Bits past the end of the buffer read as zero."""
        byte0, shift = divmod(self.pos, 8)
        nbytes = (shift + n + 7) // 8
        chunk = self.data[byte0:byte0 + nbytes]
        val = int.from_bytes(chunk, "big")
        missing = nbytes - len(chunk)
        if missing:
            val <<= 8 * missing
        total = 8 * nbytes
        return (val >> (total - shift - n)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos += n
        return v

    def skip(self, n: int) -> None:
        self.pos += n

    def byte_aligned(self) -> bool:
        return self.pos % 8 == 0

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


class BitWriter:
    """MSB-first bit writer."""

    __slots__ = ("_bytes", "_acc", "_nbits")

    def __init__(self):
        self._bytes = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, n: int) -> None:
        assert n >= 0 and 0 <= value < (1 << n), (value, n)
        self._acc = (self._acc << n) | value
        self._nbits += n
        while self._nbits >= 8:
            self._nbits -= 8
            self._bytes.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_code(self, code) -> None:
        """Write a (value, length) VLC code tuple."""
        self.write(code[0], code[1])

    def align(self, fill: int = 0) -> None:
        if self._nbits:
            pad = 8 - self._nbits
            self.write((fill & ((1 << pad) - 1)) if fill else 0, pad)

    def start_code(self, code: int) -> None:
        """Byte-align then emit 00 00 01 <code>."""
        self.align()
        self._bytes += bytes((0, 0, 1, code & 0xFF))

    @property
    def bitpos(self) -> int:
        return 8 * len(self._bytes) + self._nbits

    def getvalue(self) -> bytes:
        assert self._nbits == 0, "unaligned stream"
        return bytes(self._bytes)
