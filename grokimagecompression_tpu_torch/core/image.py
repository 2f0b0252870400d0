"""Planar image model — analog of ``grk_image``
(reference: src/lib/jp2/grok.h:851-918, src/lib/jp2/image.cpp:52).

Components are planar int32 numpy arrays with per-component subsampling
(dx, dy), precision, and signedness. Canvas coordinates: the image area is
[x0, xsiz) x [y0, ysiz); component c's samples live on the subsampled grid.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .geometry import ceil_div


@dataclasses.dataclass
class Component:
    data: np.ndarray  # int32, shape (h, w)
    dx: int = 1
    dy: int = 1
    prec: int = 8
    signed: bool = False
    # Channel semantics (JP2 cdef): True marks an opacity channel.
    alpha: bool = False

    @property
    def w(self) -> int:
        return self.data.shape[1]

    @property
    def h(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass
class Image:
    components: List[Component]
    x0: int = 0
    y0: int = 0
    xsiz: int = 0  # canvas right edge (Xsiz); 0 => derive from component 0
    ysiz: int = 0

    def __post_init__(self):
        if self.xsiz == 0 and self.components:
            c0 = self.components[0]
            self.xsiz = self.x0 + c0.w * c0.dx
            self.ysiz = self.y0 + c0.h * c0.dy

    @property
    def numcomps(self) -> int:
        return len(self.components)

    @property
    def width(self) -> int:
        return self.xsiz - self.x0

    @property
    def height(self) -> int:
        return self.ysiz - self.y0

    def comp_dims(self, c: int) -> Tuple[int, int]:
        comp = self.components[c]
        w = ceil_div(self.xsiz, comp.dx) - ceil_div(self.x0, comp.dx)
        h = ceil_div(self.ysiz, comp.dy) - ceil_div(self.y0, comp.dy)
        return w, h


def make_image(arrays: List[np.ndarray], prec: int = 8, signed: bool = False,
               subsampling: List[Tuple[int, int]] | None = None) -> Image:
    comps = []
    for i, a in enumerate(arrays):
        dx, dy = (1, 1) if subsampling is None else subsampling[i]
        comps.append(Component(data=np.asarray(a, dtype=np.int32), dx=dx, dy=dy,
                               prec=prec, signed=signed))
    return Image(components=comps)
