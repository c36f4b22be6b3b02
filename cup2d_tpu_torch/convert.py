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
port's ``bc.BCTable``; ``obstacle_from_numpy``/``obstacle_to_numpy`` carry
the obstacle fields of a shaped step (``sim.ObstacleFields``),
``copy_shape_state`` the host state of shape objects (the fish's midline
and schedulers included) and ``copy_simulation_state`` all of a shaped
Simulation's state, so that both packages' ``Simulation`` (or the port's on
two devices) can go on from one state; ``copy_amr_state`` does the same
for an ``AMRSim`` (the forest, every field, chi included, the shapes, the
clocks, the cached dt and the two-level trigger).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .bc import BCTable, FaceBC
from .config import SimConfig
from .sim import ObstacleFields
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


def obstacle_from_numpy(fields, device, dtype):
    """The port's ``sim.ObstacleFields`` from numpy arrays of every field
    (a mapping or a named tuple, e.g. a JAX ``ObstacleFields`` pulled to
    the host)."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    missing = set(ObstacleFields._fields) - set(fields)
    if missing:
        raise ValueError(f"missing ObstacleFields fields: {sorted(missing)}")
    return ObstacleFields(**{
        k: torch.tensor(np.asarray(fields[k]), dtype=dtype, device=device)
        for k in ObstacleFields._fields})


def obstacle_to_numpy(obs) -> dict:
    """The fields of a port ``ObstacleFields`` as numpy arrays."""
    return {k: getattr(obs, k).detach().cpu().numpy()
            for k in obs._fields}


# the state a shape's advect()/midline() and the drivers change: rigid
# motion, CoM bookkeeping and, for the fish, the gait clock, the
# schedulers and the last midline
SHAPE_STATE = ("com", "center", "orientation", "u", "v", "omega", "M", "J",
               "d_gm")


def copy_shape_state(src, dst) -> None:
    """Give the shape ``dst`` the host state of ``src``, a shape of either
    package of the same kind (read by its attributes, no import): every
    attribute of ``src`` that ``dst`` has, ``SHAPE_STATE`` among them,
    numpy arrays and the fish's schedulers copied deeply."""
    if type(src).__name__ != type(dst).__name__:
        raise TypeError(f"cannot copy a {type(src).__name__} into a "
                        f"{type(dst).__name__}")
    missing = [k for k in SHAPE_STATE if not hasattr(src, k)]
    if missing:
        raise ValueError(f"shape without {missing}")
    for key, val in vars(src).items():
        if not hasattr(dst, key):
            continue
        if isinstance(val, np.ndarray):
            setattr(dst, key, val.copy())
        elif hasattr(val, "__dict__"):
            # a scheduler: its numpy arrays and scalars, into the port's
            # own scheduler object
            getattr(dst, key).__dict__.update(copy.deepcopy(vars(val)))
        else:
            setattr(dst, key, copy.copy(val))


def copy_simulation_state(src, dst) -> None:
    """Give the port ``Simulation`` ``dst`` the state of ``src``, a
    ``Simulation`` of either package with the same shapes: the flow state
    (on ``dst``'s device, in its dtype), every shape's host state and the
    clocks (time, step count, the cached next dt), as if ``dst`` had made
    ``src``'s steps."""
    fields = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                  else np.asarray(v))
              for k, v in src.state._asdict().items()}
    dst.state = state_from_numpy(fields, dst.grid.device, dst.grid.dtype)
    if len(src.shapes) != len(dst.shapes):
        raise ValueError(f"{len(src.shapes)} shapes into "
                         f"{len(dst.shapes)}")
    for a, b in zip(src.shapes, dst.shapes):
        copy_shape_state(a, b)
    dst.time, dst.step_count = src.time, src.step_count
    dst._next_dt = src._next_dt
    dst._initialized = getattr(src, "_initialized", False)


def _host(v):
    """A field or scalar of either package as numpy."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def copy_amr_state(src, dst) -> None:
    """Give the port ``AMRSim`` ``dst`` the state of ``src``, an
    ``AMRSim`` of either package with the same configuration and shapes:
    the block keys and every slot-layout field (chi included), every
    shape's host state, the clocks (time, step count), the cached next dt
    and end-state umax (current for ``dst``'s topology exactly when they
    were for ``src``'s), the initialized flag, the padding and raster
    window capacities and the production two-level trigger, as if ``dst``
    had made ``src``'s steps."""
    if len(src.shapes) != len(dst.shapes):
        raise ValueError(f"{len(src.shapes)} shapes into "
                         f"{len(dst.shapes)}")
    src.sync_fields()
    sf = src.forest
    dst.load_forest(dict(sf.blocks),
                    {k: _host(v) for k, v in sf.fields.items()})
    for a, b in zip(src.shapes, dst.shapes):
        copy_shape_state(a, b)
    dst.time, dst.step_count = src.time, src.step_count
    dst._initialized = getattr(src, "_initialized", False)
    dst._npad_hwm = src._npad_hwm
    dst._npad_floor = src._npad_floor
    dst._npad_quiet = src._npad_quiet
    dst._wcap = list(src._wcap)
    # the tables of the new topology first: their rebuild re-arms the
    # trigger, which then takes src's state
    dst._refresh()
    current = src._tables_version == sf.version
    dst._last_iters = int(src._last_iters) if current else 0
    dst._coarse_on = bool(src._coarse_on) if current else False
    df = dst.forest
    nd = getattr(src, "_next_dt", None)
    dst._next_dt = None if nd is None else float(nd)
    dst._next_dt_version = (df.version if src._next_dt_version
                            == sf.version else -1)
    nu = src._next_umax
    if nu is None:
        dst._next_umax = None
    elif dst.shapes:
        dst._next_umax = float(_host(nu))
    else:
        dst._next_umax = torch.tensor(float(_host(nu)), dtype=dst.dtype,
                                      device=dst.device)
    dst._next_umax_version = (df.version if src._next_umax_version
                              == sf.version else -1)
