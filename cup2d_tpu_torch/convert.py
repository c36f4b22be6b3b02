"""Carrying configurations and state from the JAX package to the port.

Both directions go through plain Python and numpy, so neither package
imports the other: ``config_from_dict`` takes ``dataclasses.asdict`` of a
JAX ``SimConfig``; ``state_from_numpy`` takes the fields of a JAX
``FlowState`` as numpy arrays (a mapping or a named tuple);
``forest_from_numpy`` takes a forest's block keys and slot-layout fields
(``{(level, i, j): slot}`` and ``{name: [capacity, dim, BS, BS]}``, as
``Forest.blocks`` and ``Forest.fields`` of either package hold them) into
a port ``AMRSim`` with the same topology; ``bc_from_fields`` takes a
boundary table of either package (read by its fields, no import) into the
port's ``bc.BCTable``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bc import BCTable, FaceBC
from .config import SimConfig
from .uniform import FlowState


def config_from_dict(d: dict) -> SimConfig:
    """Build the port's ``SimConfig`` from the dict form of a JAX one; the
    derived fields (h0, extents, min_h) are recomputed, not copied."""
    init = {f.name for f in dataclasses.fields(SimConfig) if f.init}
    unknown = set(d) - {f.name for f in dataclasses.fields(SimConfig)}
    if unknown:
        raise ValueError(f"unknown SimConfig fields: {sorted(unknown)}")
    return SimConfig(**{k: v for k, v in d.items() if k in init})


def bc_from_fields(obj) -> BCTable:
    """The port's ``BCTable`` with the faces of ``obj``, a boundary table
    of either package: each of ``x_lo``, ``x_hi``, ``y_lo`` and ``y_hi``
    is read for its ``kind``, ``u_wall`` and ``profile``. Validated."""
    faces = []
    for name in ("x_lo", "x_hi", "y_lo", "y_hi"):
        f = getattr(obj, name)
        u, v = f.u_wall
        faces.append(FaceBC(str(f.kind), (float(u), float(v)),
                            str(f.profile)))
    return BCTable(*faces).validate()


def state_from_numpy(fields, device, dtype) -> FlowState:
    """The port's ``FlowState`` from numpy arrays of every field."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    missing = set(FlowState._fields) - set(fields)
    if missing:
        raise ValueError(f"missing FlowState fields: {sorted(missing)}")
    return FlowState(**{
        k: torch.tensor(np.asarray(fields[k]), dtype=dtype, device=device)
        for k in FlowState._fields})


def state_to_numpy(state: FlowState) -> dict:
    """The fields of a port ``FlowState`` as numpy arrays."""
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in FlowState._fields}


def forest_from_numpy(sim, blocks: dict, fields: dict) -> None:
    """Give the port ``AMRSim`` ``sim`` the topology ``blocks`` and the
    slot-layout ``fields`` of another forest (JAX or port). The port
    assigns its own slots; the SFC order, and so the ordered state, is
    the same block for block."""
    sim.load_forest(dict(blocks),
                    {k: np.asarray(v) for k, v in fields.items()})


def forest_to_numpy(sim) -> tuple[dict, dict]:
    """(blocks, fields) of a port ``AMRSim``, current (synced), fields as
    numpy slot-layout arrays; the inverse of ``forest_from_numpy``."""
    fields = sim.fields()
    return (dict(sim.forest.blocks),
            {k: v.detach().cpu().numpy() for k, v in fields.items()})
