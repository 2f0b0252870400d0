"""Packet-header bit I/O with 0xFF bit-stuffing (ISO/IEC 15444-1 B.10.1).

Analog of the reference's BitIO (reference: src/lib/jp2/codestream/BitIO.h:
68-108): MSB-first bit writer/reader where a byte following a 0xFF carries
only 7 payload bits, plus the comma-code and numpasses helpers used by
packet headers.
"""

from __future__ import annotations


class BitWriter:
    __slots__ = ("out", "buf", "ct")

    def __init__(self):
        self.out = bytearray()
        self.buf = 0
        self.ct = 8  # bits remaining in current byte

    def _emit(self):
        self.out.append(self.buf)
        self.ct = 7 if self.buf == 0xFF else 8
        self.buf = 0

    def write_bit(self, b: int):
        self.buf = (self.buf << 1) | (b & 1)
        self.ct -= 1
        if self.ct == 0:
            self._emit()

    def write_bits(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.write_bit((v >> i) & 1)

    def flush(self) -> bytes:
        """Pad to byte boundary with 0 bits; a trailing 0xFF gets a stuffed
        0x00 so a packet header never ends in 0xFF."""
        full = 7 if (self.out and self.out[-1] == 0xFF) else 8
        if self.ct < full:
            self.buf <<= self.ct
            self.out.append(self.buf & 0xFF)
            self.buf = 0
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0x00)
        return bytes(self.out)

    def write_commacode(self, n: int):
        """n ones followed by a zero (Lblock increments)."""
        for _ in range(n):
            self.write_bit(1)
        self.write_bit(0)

    def write_numpasses(self, n: int):
        """Pass-count codeword (Table B.4)."""
        if n == 1:
            self.write_bit(0)
        elif n == 2:
            self.write_bits(0b10, 2)
        elif n <= 5:
            self.write_bits(0b11, 2)
            self.write_bits(n - 3, 2)
        elif n <= 36:
            self.write_bits(0b1111, 4)
            self.write_bits(n - 6, 5)
        elif n <= 164:
            self.write_bits(0b111111111, 9)
            self.write_bits(n - 37, 7)
        else:
            raise ValueError(f"numpasses {n} > 164")


class BitReader:
    __slots__ = ("data", "pos", "buf", "ct", "start")

    def __init__(self, data, pos: int = 0):
        self.data = data
        self.pos = pos
        self.start = pos
        self.buf = 0
        self.ct = 0

    def read_bit(self) -> int:
        if self.ct == 0:
            prev_ff = self.pos > self.start and self.data[self.pos - 1] == 0xFF
            if self.pos < len(self.data):
                self.buf = self.data[self.pos]
                self.pos += 1
            else:
                self.buf = 0
                self.pos += 1
            self.ct = 7 if prev_ff else 8
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def align(self):
        """Consume padding to the byte boundary; if the last consumed byte is
        0xFF, consume the stuffed byte too."""
        self.ct = 0
        if self.pos > self.start and self.pos <= len(self.data) \
                and self.data[self.pos - 1] == 0xFF:
            self.pos += 1

    def read_commacode(self) -> int:
        n = 0
        while self.read_bit():
            n += 1
        return n

    def read_numpasses(self) -> int:
        if not self.read_bit():
            return 1
        if not self.read_bit():
            return 2
        n = self.read_bits(2)
        if n != 3:
            return 3 + n
        n = self.read_bits(5)
        if n != 31:
            return 6 + n
        return 37 + self.read_bits(7)
