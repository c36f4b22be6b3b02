"""Block forest: the structure-of-arrays AMR grid, the counterpart of
``cup2d_tpu.forest``.

Every field lives in ONE dense torch tensor ``[capacity, dim, BS, BS]`` on
the sim's device, addressed by slot; the topology (level, block index,
active mask, the (level, i, j) -> slot map) is small host numpy/dict state
that only changes at regrid time. Blocks are kept in Hilbert-SFC order
across levels (the reference's ``id2`` ordering via SpaceCurve::Encode,
main.cpp:422-446).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .config import SimConfig
from .curve import SpaceCurve

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class _FieldsDict(dict):
    """Field store with a write-version counter.

    The AMR driver keeps an SFC-ordered compact copy of the fields as its
    per-step working state (``amr.AMRSim._ordered_state``) and syncs it
    back lazily; ``wver`` lets it detect any external write to the
    slot-layout dict (tests seeding a field) so a stale ordered cache is
    never used. Only mutations that happen count as writes."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.wver = 0

    def __setitem__(self, key, value):
        self.wver += 1
        super().__setitem__(key, value)

    def update(self, *a, **k):
        # len() covers mappings and sequences; a bare iterator can't be
        # emptiness-tested without consuming it, so it counts as a write
        if k or (a and (not hasattr(a[0], "__len__") or len(a[0]))):
            self.wver += 1
        super().update(*a, **k)

    def __ior__(self, other):
        self.update(other)
        return self

    def __delitem__(self, key):
        super().__delitem__(key)
        self.wver += 1

    def pop(self, key, *default):
        existed = key in self
        val = super().pop(key, *default)
        if existed:
            self.wver += 1
        return val

    def popitem(self):
        item = super().popitem()
        self.wver += 1
        return item

    def setdefault(self, key, default=None):
        if key not in self:
            self.wver += 1
        return super().setdefault(key, default)

    def clear(self):
        if self:
            self.wver += 1
        super().clear()


class Forest:
    """Host topology + device field storage for one AMR run. All fields
    share one topology."""

    def __init__(self, cfg: SimConfig, device, capacity: int = 0):
        self.cfg = cfg
        self.bs = cfg.bs
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"dtype {cfg.dtype!r}: expected float32|float64")
        self.dtype = _DTYPES[cfg.dtype]
        self.np_dtype = np.dtype(cfg.dtype)
        self.device = torch.device(device)
        self.curve = SpaceCurve(cfg.bpdx, cfg.bpdy, cfg.level_max)
        nb0 = cfg.bpdx * cfg.bpdy
        n_init = nb0 << (2 * cfg.level_start)
        self.capacity = capacity or max(
            64, 4 * n_init,
            4 * nb0 << (2 * min(cfg.level_max - 1, 3)))
        self.capacity = -(-self.capacity // 64) * 64
        self.blocks: Dict[Tuple[int, int, int], int] = {}
        self.level = np.zeros(self.capacity, np.int32)
        self.bi = np.zeros(self.capacity, np.int32)
        self.bj = np.zeros(self.capacity, np.int32)
        self.active = np.zeros(self.capacity, bool)
        self._free = list(range(self.capacity - 1, -1, -1))
        self.fields: Dict[str, torch.Tensor] = _FieldsDict()
        self.version = 0   # bumped on every topology change

        # initial uniform partition at level_start (main.cpp:6494-6541)
        lvl = cfg.level_start
        nbx, nby = cfg.bpdx << lvl, cfg.bpdy << lvl
        for j in range(nby):
            for i in range(nbx):
                self.allocate(lvl, i, j)

    # -- slot management ------------------------------------------------
    def _grow(self):
        """Double the slot capacity: pad the metadata arrays and every
        field."""
        old = self.capacity
        new = old * 2
        self.level = np.concatenate([self.level, np.zeros(old, np.int32)])
        self.bi = np.concatenate([self.bi, np.zeros(old, np.int32)])
        self.bj = np.concatenate([self.bj, np.zeros(old, np.int32)])
        self.active = np.concatenate([self.active, np.zeros(old, bool)])
        for name, fld in self.fields.items():
            self.fields[name] = torch.cat([fld, torch.zeros_like(fld)])
        self._free.extend(range(new - 1, old - 1, -1))
        self.capacity = new

    def allocate(self, l: int, i: int, j: int) -> int:
        if not self._free:
            self._grow()
        s = self._free.pop()
        self.blocks[(l, i, j)] = s
        self.level[s] = l
        self.bi[s] = i
        self.bj[s] = j
        self.active[s] = True
        self.version += 1
        return s

    def release(self, l: int, i: int, j: int) -> int:
        s = self.blocks.pop((l, i, j))
        self.active[s] = False
        self._free.append(s)
        self.version += 1
        return s

    def add_field(self, name: str, dim: int):
        self.fields[name] = torch.zeros(
            (self.capacity, dim, self.bs, self.bs), dtype=self.dtype,
            device=self.device)

    # -- queries --------------------------------------------------------
    def nblocks_at(self, l: int) -> Tuple[int, int]:
        return self.cfg.bpdx << l, self.cfg.bpdy << l

    def h_at(self, l: int) -> float:
        return self.cfg.h_at(l)

    def slot(self, l: int, i: int, j: int) -> int:
        return self.blocks.get((l, i, j), -1)

    def order(self) -> np.ndarray:
        """Active slots sorted by the level-aware SFC id (one vectorized
        encode over all blocks)."""
        if not self.blocks:
            return np.empty(0, np.int32)
        slots = np.fromiter(self.blocks.values(), np.int32,
                            len(self.blocks))
        ids = self.curve.encode(
            self.level[slots], self.bi[slots], self.bj[slots])
        return slots[np.argsort(ids, kind="stable")]

    def origin(self, s: int) -> Tuple[float, float]:
        h = self.h_at(int(self.level[s]))
        return (float(self.bi[s]) * self.bs * h,
                float(self.bj[s]) * self.bs * h)

    def h_per_block(self, order: np.ndarray) -> np.ndarray:
        return self.cfg.h0 / (1 << self.level[order]).astype(np.float64)

    # -- cell ownership (the reference's treef queries) -----------------
    def owner_relation(self, l: int, i: int, j: int) -> int:
        """For block (l,i,j): 0 = active here, -1 = region is refined,
        -2 = coarser parent active, -3 = nothing (the reference tree
        codes, main.cpp:672-688)."""
        if (l, i, j) in self.blocks:
            return 0
        i2, j2 = 2 * i, 2 * j
        b = self.blocks
        if (l + 1, i2, j2) in b or (l + 1, i2 + 1, j2) in b \
                or (l + 1, i2, j2 + 1) in b or (l + 1, i2 + 1, j2 + 1) in b:
            return -1
        if (l - 1, i // 2, j // 2) in self.blocks:
            return -2
        return -3
