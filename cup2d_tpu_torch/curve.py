"""Hilbert space-filling curve over the block forest: the port's own copy
of ``cup2d_tpu.curve`` (host numpy code; the port imports nothing of the
JAX package).

A vectorized re-design of the reference SFC (main.cpp:342-450): the
reference walks one (i, j) pair at a time through bit-twiddling loops; here
the same public-domain Hilbert transpose algorithm is vectorized over numpy
arrays so a whole level's worth of block coordinates is encoded in one shot
(the forest planner re-encodes every block after each regrid, so this is
host-side hot code).

Semantics matched to the reference:
  * ``forward(l, i, j)``  — (level, block coords) -> Z index along the curve,
    with the multi-base-block compaction scheme of `main.cpp:385-400` (a
    non-square bpdx x bpdy domain tiles the curve of the enclosing square and
    compacts out-of-domain quadrants, `main.cpp:6357-6376`).
  * ``inverse(Z, l)``     — Z -> (i, j)  (`main.cpp:402-420`).
  * ``encode(l, i, j)``   — globally unique, level-aware ordering id ("id2",
    `main.cpp:422-445`): blocks of mixed levels sort along the curve with
    children adjacent to their parents' position.
"""

from __future__ import annotations

import numpy as np


def _xy2d(order: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Vectorized Hilbert (x, y) -> d on a 2**order x 2**order grid."""
    x = np.asarray(x, dtype=np.int64).copy()
    y = np.asarray(y, dtype=np.int64).copy()
    d = np.zeros_like(x)
    s = np.int64(1) << max(order - 1, 0)
    if order == 0:
        return d
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        # rotate quadrant
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f = np.where(flip, s - 1 - x, x)
        y_f = np.where(flip, s - 1 - y, y)
        x, y = np.where(swap, y_f, x_f), np.where(swap, x_f, y_f)
        s >>= 1
    return d


def _d2xy(order: int, d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized Hilbert d -> (x, y) on a 2**order x 2**order grid."""
    t = np.asarray(d, dtype=np.int64).copy()
    x = np.zeros_like(t)
    y = np.zeros_like(t)
    s = np.int64(1)
    n = np.int64(1) << order
    while s < n:
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        # rotate
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f = np.where(flip, s - 1 - x, x)
        y_f = np.where(flip, s - 1 - y, y)
        x, y = np.where(swap, y_f, x_f), np.where(swap, x_f, y_f)
        x = x + s * rx
        y = y + s * ry
        t //= 4
        s <<= 1
    return x, y


class SpaceCurve:
    """Level-aware Hilbert curve over a bpdx x bpdy forest of base blocks.

    Mirrors main.cpp:342-446 + its construction at
    `main.cpp:6342-6376`, fully vectorized.
    """

    def __init__(self, bpdx: int, bpdy: int, level_max: int):
        self.bpdx = int(bpdx)
        self.bpdy = int(bpdy)
        self.level_max = int(level_max)
        n_max = max(self.bpdx, self.bpdy)
        self.base_level = int(np.ceil(np.log2(n_max))) if n_max > 1 else 0

        # Compact the base-square curve onto the bpdx x bpdy sub-domain
        # (reference main.cpp:6357-6376).
        side = 1 << self.base_level
        ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
        d_all = _xy2d(self.base_level, ii.ravel(), jj.ravel())
        inside = (ii.ravel() < self.bpdx) & (jj.ravel() < self.bpdy)
        order = np.argsort(d_all)
        inside_sorted = inside[order]
        # compacted index for each inside block, in curve order
        comp = np.cumsum(inside_sorted) - 1
        self.is_regular = bool(np.all(inside_sorted))
        # Zsave[j * bpdx + i] = compacted index of base block (i, j)
        self._zsave = np.full(self.bpdx * self.bpdy, -1, dtype=np.int64)
        self._i_inverse = np.full(self.bpdx * self.bpdy, -1, dtype=np.int64)
        self._j_inverse = np.full(self.bpdx * self.bpdy, -1, dtype=np.int64)
        io = ii.ravel()[order][inside_sorted]
        jo = jj.ravel()[order][inside_sorted]
        co = comp[inside_sorted]
        self._zsave[jo * self.bpdx + io] = co
        self._i_inverse[co] = io
        self._j_inverse[co] = jo

        # Per-level curve lengths and level offsets ("sim.levels",
        # reference main.cpp:6490-6493 — note the reference's expression
        # `bpdx*bpdy*2` then `+ bpdx*bpdy*1 << (m+1)` evaluates to
        # offsets[0] = 2*nb, offsets[m] = offsets[m-1] + (nb << (m+1)),
        # which over-allocates level 0; we use exact per-level counts,
        # a deliberate cleanup — offsets only need to be unique ranges).
        self.level_offsets = np.zeros(self.level_max + 1, dtype=np.int64)
        nb = self.bpdx * self.bpdy
        for m in range(self.level_max):
            self.level_offsets[m + 1] = self.level_offsets[m] + nb * (1 << (2 * m))

    def blocks_at(self, level: int) -> tuple[int, int]:
        """(nx, ny) block counts at a level."""
        return self.bpdx << level, self.bpdy << level

    def forward(self, level: int, i, j) -> np.ndarray:
        """Z index of block(s) (i, j) at `level`. Vectorized."""
        i = np.asarray(i, dtype=np.int64)
        j = np.asarray(j, dtype=np.int64)
        aux = np.int64(1) << level
        if self.is_regular:
            return _xy2d(level + self.base_level, i, j)
        bi = i // aux
        bj = j // aux
        z_local = _xy2d(level, i - bi * aux, j - bj * aux)
        return z_local + self._zsave[bj * self.bpdx + bi] * aux * aux

    def inverse(self, z, level: int) -> tuple[np.ndarray, np.ndarray]:
        """(i, j) of Z index/indices at `level`. Vectorized."""
        z = np.asarray(z, dtype=np.int64)
        if self.is_regular:
            return _d2xy(level + self.base_level, z)
        aux = np.int64(1) << level
        zloc = z % (aux * aux)
        x, y = _d2xy(level, zloc)
        base = z // (aux * aux)
        return x + self._i_inverse[base] * aux, y + self._j_inverse[base] * aux

    def encode(self, level, i, j) -> np.ndarray:
        """Global level-aware ordering key ("id2", main.cpp:422-445).

        Sums the curve positions of all ancestors, plus (for finer levels)
        the start of the 4-child group descended along the curve, plus the
        level itself — so mixed-level forests sort depth-first along the
        curve. Vectorized over arrays of (level, i, j).
        """
        level = np.asarray(level, dtype=np.int64)
        i = np.asarray(i, dtype=np.int64)
        j = np.asarray(j, dtype=np.int64)
        scalar = level.ndim == 0 and i.ndim == 0 and j.ndim == 0
        level, i, j = np.broadcast_arrays(
            np.atleast_1d(level), np.atleast_1d(i), np.atleast_1d(j)
        )
        level = level.copy()
        out = np.zeros_like(i)
        # ancestors (own level down to 0)
        for lvl in range(self.level_max - 1, -1, -1):
            sel = level >= lvl
            if not sel.any():
                continue
            shift = (level - lvl).clip(min=0)
            out[sel] += self.forward(lvl, (i >> shift)[sel], (j >> shift)[sel])
        # descendants: follow the first-child-group chain down the levels,
        # vectorized across all blocks at once (chain state (cx, cy) holds
        # the current-level coords of each block's descendant group).
        cx = np.zeros_like(i)
        cy = np.zeros_like(j)
        for lvl in range(1, self.level_max):
            start = level == lvl - 1
            cx[start] = 2 * i[start]
            cy[start] = 2 * j[start]
            sel = level < lvl
            if not sel.any():
                continue
            zc = self.forward(lvl, cx[sel], cy[sel])
            zc -= zc % 4
            out[sel] += zc
            x1, y1 = self.inverse(zc, lvl)
            cx[sel] = 2 * x1
            cy[sel] = 2 * y1
        out += level
        return out[0] if scalar else out
