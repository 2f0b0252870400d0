"""Tag trees (ISO/IEC 15444-1 B.10.2) — 2-D quadtree threshold coding of
code-block inclusion layers and missing bit-planes.

Analog of the reference TagTree (reference: src/lib/jp2/codestream/
TagTree.cpp:230 encode, :270 decode) with the classic low/value/known
per-node walk.
"""

from __future__ import annotations

from typing import List

from .bitio import BitReader, BitWriter

_INF = 999_999_999


class TagTree:
    def __init__(self, w: int, h: int):
        self.w = w
        self.h = h
        # Level dimensions from leaves up to the 1x1 root.
        self.level_dims: List[tuple] = []
        lw, lh = w, h
        while True:
            self.level_dims.append((lw, lh))
            if lw == 1 and lh == 1:
                break
            lw = (lw + 1) // 2
            lh = (lh + 1) // 2
        n = sum(a * b for a, b in self.level_dims)
        self.value = [_INF] * n
        self.low = [0] * n
        self.known = [False] * n
        # Offsets of each level in the flat arrays.
        self.level_off = []
        off = 0
        for a, b in self.level_dims:
            self.level_off.append(off)
            off += a * b

    def reset(self):
        for i in range(len(self.value)):
            self.value[i] = _INF
            self.low[i] = 0
            self.known[i] = False

    def _path(self, x: int, y: int) -> List[int]:
        """Node indices from root down to leaf (x, y)."""
        path = []
        for lev, (lw, lh) in enumerate(self.level_dims):
            xx, yy = x >> lev, y >> lev
            path.append(self.level_off[lev] + yy * lw + xx)
        return list(reversed(path))

    def set_value(self, x: int, y: int, v: int):
        """Set a leaf value and propagate minima up the tree."""
        for lev, (lw, lh) in enumerate(self.level_dims):
            idx = self.level_off[lev] + (y >> lev) * lw + (x >> lev)
            if self.value[idx] > v:
                self.value[idx] = v
            else:
                break

    def encode(self, bio: BitWriter, x: int, y: int, threshold: int):
        """Emit bits determining whether leaf value < threshold."""
        low = 0
        for idx in self._path(x, y):
            if low < self.low[idx]:
                low = self.low[idx]
            while low < threshold:
                if low >= self.value[idx]:
                    if not self.known[idx]:
                        bio.write_bit(1)
                        self.known[idx] = True
                    break
                bio.write_bit(0)
                low += 1
            self.low[idx] = low

    def decode(self, bio: BitReader, x: int, y: int, threshold: int) -> bool:
        """Consume bits; returns True iff leaf value < threshold."""
        low = 0
        leaf = -1
        for idx in self._path(x, y):
            leaf = idx
            if low < self.low[idx]:
                low = self.low[idx]
            while low < threshold:
                if low >= self.value[idx]:
                    break
                if bio.read_bit():
                    self.value[idx] = low
                else:
                    low += 1
            self.low[idx] = low
        return self.value[leaf] < threshold
