"""Field dumps in the reference format and checkpoint/restart, the
counterpart of ``cup2d_tpu.io`` (single process).

A dump is the exact on-disk triplet of the reference's ``dump()``
(main.cpp:3367-3467): per-cell quads as float32 ``.xyz.raw`` (4 corners x
2 coords, (x0,y0),(x0,y1),(x1,y1),(x1,y0)), float32 ``.attr.raw`` (u, v, 0
triplets) and the ``.xdmf2`` index; the JAX package writes the same
bytes for the same state.

A checkpoint is ``fields.npz`` + ``shapes.pkl`` + ``meta.json`` in the
JAX package's layout, written to a sibling temp dir and installed by
park -> replace -> delete, so at every instant ``dirpath`` or
``dirpath.old`` holds a complete checkpoint; the loader falls back to
``.old`` with a ``checkpoint_fallback_old`` event. ``load_checkpoint``
also reads a checkpoint the JAX package wrote: its fish and disk pickles
load into the port's ``models`` (the attribute names of both packages'
shapes are the same) through an unpickler that refuses every other
``cup2d_tpu`` name, so no JAX import can happen. The port adds one meta
key the JAX package ignores, the forest's ``padding`` (block-axis bucket
and raster window capacities), without which a restarted card run
pads, and so sums, differently from the run it resumes.

``save_checkpoint`` calls ``faults.crash_point("checkpoint_install")``
between its two renames (the ``crash_in_save`` drill).

The device snapshot tier of the supervised loop (``resilience.StepGuard``'s
ring): ``snapshot_state_device`` clones every field and every device
dt-cache scalar on the device, ``restore_snapshot_device`` installs fresh
clones of an entry (so one entry restores twice); neither reads the
device from the host. A snapshot of another topology restores through
``_install_state``.

A fleet (``fleet.FleetSim``) checkpoints its per-member clocks in a
``fleet`` meta entry, as the JAX package does; a checkpoint without one
restores every member at the shared clock. A serving session saves and
resumes one member alone (``save_member_checkpoint``,
``load_member_checkpoint``: the member's solo-shaped fields, its own clock
and its chained dt, in the same tmp -> park -> replace order). The device
snapshot tier carries a fleet's clocks and its [B] dt row.

Every device read goes through ``shapes_host.pull``; ``state_gathers``
counts ``_gather_state`` calls (``profiling.HostCounters``). Not ported:
the mirror tier (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import sys
from typing import NamedTuple

import numpy as np
import torch

from .shapes_host import pull

# full state gathers made since import (profiling.HostCounters)
state_gathers = 0

_XDMF_TEMPLATE = """<Xdmf
    Version="2.0">
  <Domain>
    <Grid>
      <Time Value="{time:.16e}"/>
      <Topology
          Dimensions="{ncell}"
          TopologyType="Quadrilateral"/>
     <Geometry
         GeometryType="XY">
       <DataItem
           Dimensions="{npoint} 2"
           Format="Binary">
         {xyz_base}
       </DataItem>
     </Geometry>
       <Attribute
           AttributeType="Vector"
           Name="vort"
           Center="Cell">
         <DataItem
             Dimensions="3 {ncell}"
             Format="Binary">
           {attr_base}
         </DataItem>
       </Attribute>
    </Grid>
  </Domain>
</Xdmf>
"""


def _write_quads(path: str, time: float, xg, yg, x1, y1, u, v) -> None:
    """Emit the reference dump triplet from per-cell corner/value arrays
    (any shape; raveled in C order)."""
    ncell = int(np.prod(np.shape(u)))
    xyz = np.empty((ncell, 4, 2), dtype=np.float32)
    xyz[:, 0, 0] = np.ravel(xg); xyz[:, 0, 1] = np.ravel(yg)
    xyz[:, 1, 0] = np.ravel(xg); xyz[:, 1, 1] = np.ravel(y1)
    xyz[:, 2, 0] = np.ravel(x1); xyz[:, 2, 1] = np.ravel(y1)
    xyz[:, 3, 0] = np.ravel(x1); xyz[:, 3, 1] = np.ravel(yg)

    attr = np.zeros((ncell, 3), dtype=np.float32)
    attr[:, 0] = np.ravel(u)
    attr[:, 1] = np.ravel(v)

    xyz.tofile(path + ".xyz.raw")
    attr.tofile(path + ".attr.raw")
    with open(path + ".xdmf2", "w") as f:
        f.write(_XDMF_TEMPLATE.format(
            time=time, ncell=ncell, npoint=4 * ncell,
            xyz_base=os.path.basename(path) + ".xyz.raw",
            attr_base=os.path.basename(path) + ".attr.raw",
        ))


def dump_uniform(path: str, time: float, vel, h: float,
                 origin=(0.0, 0.0)) -> None:
    """Write a uniform-grid velocity field [2, Ny, Nx] (a tensor, a split
    field or numpy) in the reference dump format, cells in row-major
    (y-outer) order."""
    vel = whole(vel)
    if torch.is_tensor(vel):
        (vel,) = pull(vel)
    vel = np.asarray(vel, dtype=np.float64)
    _, ny, nx = vel.shape
    x0 = origin[0] + np.arange(nx) * h
    y0 = origin[1] + np.arange(ny) * h
    xg, yg = np.meshgrid(x0, y0, indexing="xy")   # [ny, nx]
    _write_quads(path, time, xg, yg, xg + h, yg + h, vel[0], vel[1])


def dump_forest(path: str, time: float, forest, order=None) -> None:
    """Write an adaptive forest's velocity in the reference dump format:
    blocks in SFC order, cells y-outer/x-inner within each block. The
    ``[order]`` gather runs on the device before the one host copy."""
    order = forest.order() if order is None else order
    bs = forest.bs
    n = len(order)
    fld = forest.fields["vel"]
    (vel,) = pull(fld[torch.as_tensor(np.asarray(order, np.int64),
                                      device=fld.device)])

    h = forest.cfg.h0 / (1 << forest.level[order]).astype(np.float64)
    ar = np.arange(bs, dtype=np.float64)
    x0b = forest.bi[order].astype(np.float64) * bs * h
    y0b = forest.bj[order].astype(np.float64) * bs * h
    shape = (n, bs, bs)
    xg = np.broadcast_to(
        x0b[:, None, None] + ar[None, None, :] * h[:, None, None], shape)
    yg = np.broadcast_to(
        y0b[:, None, None] + ar[None, :, None] * h[:, None, None], shape)
    x1 = xg + h[:, None, None]
    y1 = yg + h[:, None, None]
    _write_quads(path, time, xg, yg, x1, y1, vel[:, 0], vel[:, 1])


def read_dump(path: str):
    """Read back a dump triplet -> (time, xyz [ncell,4,2], attr [ncell,3])."""
    import xml.etree.ElementTree as ET

    time = float(ET.parse(path + ".xdmf2").find("Domain/Grid/Time")
                 .get("Value"))
    xyz = np.fromfile(path + ".xyz.raw", dtype=np.float32).reshape(-1, 4, 2)
    attr = np.fromfile(path + ".attr.raw", dtype=np.float32).reshape(-1, 3)
    return time, xyz, attr


# ---------------------------------------------------------------------------
# checkpoint / restore
# ---------------------------------------------------------------------------

def whole(v):
    """A field of a sim on a mesh in the global layout (x-split ``Slabs``
    gathered along x, split forest ``Blocks`` along the block axis, on
    their mesh's first device); anything else as it is. Dumps,
    checkpoints and snapshot restores across topologies write and read
    this layout, so they restart on any mesh or on none."""
    from .parallel.shard_halo import Blocks, Slabs, gather_blocks, gather_x
    if isinstance(v, Slabs):
        return gather_x(v)
    if isinstance(v, Blocks):
        return gather_blocks(v)
    return v


def _gather_state(sim):
    """The checkpoint payload (host numpy fields, one read) and meta dict.
    Forest: topology as (level, i, j) keys and the fields in SFC order
    (slot numbers need not survive); uniform: the ``FlowState`` fields."""
    global state_gathers
    state_gathers += 1
    if hasattr(sim, "sync_fields"):
        # the forest's per-step truth is its ordered working state
        sim.sync_fields()
    if hasattr(sim, "forest"):
        f = sim.forest
        order = f.order()
        keys = np.stack([f.level[order], f.bi[order], f.bj[order]],
                        axis=1).astype(np.int32)
        names = sorted(f.fields)
        idx = torch.as_tensor(np.asarray(order, np.int64),
                              device=f.fields[names[0]].device)
        vals = pull(*(f.fields[k][idx] for k in names), keep_dtype=True)
        payload = {"__forest_keys": keys, **dict(zip(names, vals))}
    else:
        names = list(sim.state._fields)
        vals = pull(*(whole(getattr(sim.state, k)) for k in names),
                    keep_dtype=True)
        payload = dict(zip(names, vals))
    meta = {
        "time": sim.time,
        "step_count": sim.step_count,
        "config": {k: v for k, v in vars(sim.cfg).items()
                   if not k.startswith("_")},
    }
    if hasattr(sim, "times"):
        # a fleet: the per-member clocks (sim.time is only their min)
        meta["fleet"] = {"members": int(sim.members),
                         "times": [float(t) for t in sim.times]}
    if hasattr(sim, "forest") and hasattr(sim, "_next_dt"):
        # the cached next-dt state must survive, or a restart right after
        # a regrid takes a different dt branch than the uninterrupted run;
        # 'current' records whether each cache matched the topology
        fver = sim.forest.version
        umax = sim._next_umax
        if torch.is_tensor(umax):
            umax = pull(umax)[0]
        meta["dt_cache"] = {
            "next_dt": sim._next_dt,
            "next_dt_current": bool(
                sim._next_dt is not None
                and sim._next_dt_version == fver),
            "next_umax": float(umax) if umax is not None else None,
            "next_umax_current": bool(
                umax is not None
                and getattr(sim, "_next_umax_version", -1) == fver),
        }
    if hasattr(sim, "_coarse_on"):
        # the production two-level trigger, for the same same-branch
        # contract
        meta["poisson_trigger"] = {
            "coarse_on": bool(sim._coarse_on),
            "last_iters": int(sim._last_iters),
        }
    if hasattr(sim, "_npad_hwm"):
        meta["padding"] = {"npad_hwm": int(sim._npad_hwm),
                           "npad_floor": int(sim._npad_floor),
                           "npad_quiet": int(sim._npad_quiet),
                           "wcap": [int(w) for w in sim._wcap]}
    return payload, meta


def save_checkpoint(dirpath: str, sim) -> None:
    """Serialize a driver (``Simulation``, ``UniformSim``, ``FleetSim`` or
    ``AMRSim``) to ``dirpath``: written to a sibling temp dir, then
    installed so that a crash mid-save cannot destroy the previous restart
    point."""
    payload, meta = _gather_state(sim)
    shapes = getattr(sim, "shapes", [])
    _write_installed(dirpath, payload, meta, shapes, crash_window=True)


def _write_installed(dirpath: str, payload: dict, meta: dict, shapes,
                     crash_window: bool = False) -> None:
    """Write fields.npz, meta.json (and shapes.pkl unless ``shapes`` is
    None) into a sibling temp dir, then park the old ``dirpath``, move the
    new one in, THEN delete the old: at every instant dirpath or
    dirpath.old is complete."""
    tmp = dirpath.rstrip("/") + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "fields.npz"), **payload)
    if shapes is not None:
        with open(os.path.join(tmp, "shapes.pkl"), "wb") as f:
            pickle.dump(shapes, f)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    old = dirpath.rstrip("/") + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(dirpath):
        os.replace(dirpath, old)
    if crash_window:
        # a no-op unless a FaultPlan armed crash_in_save: dirpath absent,
        # dirpath.old complete
        from . import faults
        faults.crash_point("checkpoint_install")
    os.replace(tmp, dirpath)
    if os.path.exists(old):
        shutil.rmtree(old)


# the JAX package's shape modules and the port's counterparts
_SHAPE_MODULES = {"cup2d_tpu.models.fish": "fish",
                  "cup2d_tpu.models.disk": "disk"}


class _ShapesUnpickler(pickle.Unpickler):
    """Loads shape pickles of either package: a JAX fish or disk (and the
    fish's schedulers) becomes the port's class of the same name; any
    other ``cup2d_tpu`` name and every ``jax`` or ``jaxlib`` name is
    refused, so loading never imports JAX or the JAX package."""

    def find_class(self, module, name):
        if module.split(".", 1)[0] in ("jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"refusing {module}.{name} in a checkpoint's shapes (a JAX "
                "array or type; the port loads no JAX)")
        if module == "cup2d_tpu" or module.startswith("cup2d_tpu."):
            sub = _SHAPE_MODULES.get(module)
            if sub is None:
                raise pickle.UnpicklingError(
                    f"refusing {module}.{name} in a checkpoint's shapes "
                    "(only the JAX package's fish and disk models map "
                    "onto the port)")
            from .models import disk, fish
            return getattr({"fish": fish, "disk": disk}[sub], name)
        return super().find_class(module, name)


def _fallback_old(dirpath: str, what: str) -> str:
    """``dirpath``, or its parked ``.old`` copy (loudly, with a
    ``checkpoint_fallback_old`` event) when a save crashed between parking
    the previous one and installing the new one."""
    if not os.path.exists(os.path.join(dirpath, "meta.json")):
        old = dirpath.rstrip("/") + ".old"
        if os.path.exists(os.path.join(old, "meta.json")):
            print(f"cup2d_tpu_torch: {what} {dirpath!r} is missing or "
                  f"incomplete; falling back to parked copy {old!r} "
                  "(a save crashed between park and install)",
                  file=sys.stderr)
            from .resilience import record_event
            record_event(event="checkpoint_fallback_old",
                         requested=dirpath, used=old)
            return old
    return dirpath


def load_checkpoint(dirpath: str, sim) -> None:
    """Restore a checkpoint (the port's or the JAX package's) into ``sim``
    (built with a matching config/grid). Falls back to ``dirpath.old``,
    loudly, when a save crashed between parking the previous checkpoint
    and installing the new one."""
    dirpath = _fallback_old(dirpath, "checkpoint")
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    shapes = None
    shapes_path = os.path.join(dirpath, "shapes.pkl")
    if os.path.exists(shapes_path):
        with open(shapes_path, "rb") as f:
            shapes = _ShapesUnpickler(f).load()
    with np.load(os.path.join(dirpath, "fields.npz")) as data:
        _install_state(sim, data, meta, shapes)


def _install_state(sim, data, meta: dict, shapes) -> None:
    """Install a gathered payload (name -> array) + meta + shapes into
    ``sim``, in the JAX package's order."""
    # counters BEFORE the field restore: _refresh() branches on
    # step_count (a production restore builds no startup coarse maps)
    sim.time = float(meta["time"])
    sim.step_count = int(meta["step_count"])
    if "__forest_keys" in data:
        f = sim.forest
        for key in list(f.blocks):
            f.release(*key)
        keys = data["__forest_keys"]
        slots = [f.allocate(int(l), int(i), int(j)) for (l, i, j) in keys]
        for name in list(f.fields):
            old = f.fields[name]
            vals = data[name]
            if not torch.is_tensor(vals):    # a snapshot holds tensors
                vals = torch.as_tensor(np.asarray(vals))
            vals = vals.to(device=old.device, dtype=old.dtype)
            new = torch.zeros((f.capacity,) + tuple(vals.shape[1:]),
                              dtype=old.dtype, device=old.device)
            new[torch.as_tensor(slots, dtype=torch.long,
                                device=old.device)] = vals
            f.fields[name] = new
        pad = meta.get("padding")
        if pad and hasattr(sim, "_npad_hwm"):
            sim._npad_hwm = int(pad["npad_hwm"])
            sim._npad_floor = int(pad["npad_floor"])
            sim._npad_quiet = int(pad["npad_quiet"])
            sim._wcap = [int(w) for w in pad["wcap"]]
        if hasattr(sim, "_ord"):
            # the restored slot fields are the truth: drop the ordered
            # cache outright, refresh the tables (which may grow the
            # forest and move wver), THEN re-anchor the key so a field
            # write before the first step still drops the dt cache
            sim._ord = None
            sim._ord_dirty = False
            if hasattr(sim, "_refresh"):
                sim._refresh()
            sim._ord_key = (f.version, f.fields.wver)
    else:
        st = type(sim.state)(**{
            k: torch.tensor(np.asarray(data[k]), dtype=sim.grid.dtype,
                            device=sim.grid.device)
            for k in sim.state._fields})
        if hasattr(sim, "mesh"):
            sim.set_state(st)       # split over the sim's mesh
        else:
            sim.state = st
    # the cached next-dt state, cleared (the uniform checkpoint carries
    # none, as in the JAX package) or restored (the forest's dt_cache)
    for attr, cleared in (("_next_dt", None), ("_next_umax", None),
                          ("_next_dt_version", -1),
                          ("_next_umax_version", -1)):
        if hasattr(sim, attr):
            setattr(sim, attr, cleared)
    dtc = meta.get("dt_cache")
    if dtc and hasattr(sim, "forest") and hasattr(sim, "_next_dt"):
        fver = sim.forest.version
        if dtc.get("next_dt") is not None:
            sim._next_dt = float(dtc["next_dt"])
            sim._next_dt_version = fver if dtc["next_dt_current"] else -1
        if dtc.get("next_umax") is not None:
            umax = float(dtc["next_umax"])
            if not sim.shapes:
                # the obstacle-free forest step keeps it on the device
                umax = torch.tensor(umax, dtype=sim.dtype,
                                    device=sim.device)
            sim._next_umax = umax
            sim._next_umax_version = (
                fver if dtc["next_umax_current"] else -1)
    # after the _refresh() above, which re-arms the trigger
    trig = meta.get("poisson_trigger")
    if trig and hasattr(sim, "_coarse_on"):
        sim._coarse_on = bool(trig["coarse_on"])
        sim._last_iters = int(trig["last_iters"])
    if hasattr(sim, "times"):
        fl = meta.get("fleet")
        if fl is not None:
            if int(fl["members"]) != int(sim.members):
                raise ValueError(
                    f"checkpoint holds {fl['members']} fleet members, "
                    f"sim has {sim.members}")
            sim.times = np.asarray(fl["times"], np.float64)
        else:
            # a checkpoint of one run into a fleet: every member takes
            # the shared clock
            sim.times = np.full(sim.members, float(meta["time"]))
        sim.time = float(sim.times.min())
    if hasattr(sim, "shapes") and shapes is not None:
        sim.shapes[:] = shapes
        sim._initialized = True  # fields already hold the blended state


# ---------------------------------------------------------------------------
# per-member session checkpoints (fleet serving)
# ---------------------------------------------------------------------------
# A serving session outlives its slot: the FleetServer saves one of these
# when it retires a member and admits from it into any slot of any pool
# with the same grid, bit-exact (the fields in their dtype, the member's
# own clock, and its chained dt, whose JSON float64 round-trips an f32
# value exactly). The fields are the member's solo-shaped slice, so the
# session can also be resumed alone.

def save_member_checkpoint(dirpath: str, sim, m: int) -> None:
    """Serialize fleet member ``m``'s session to ``dirpath`` (one read)."""
    st = sim.member_state(m)
    names = list(st._fields)
    nd = sim._next_dt
    extra = [nd[m].reshape(1)] if torch.is_tensor(nd) else []
    vals = pull(*(getattr(st, k) for k in names), *extra, keep_dtype=True)
    next_dt = None
    if extra:
        next_dt = float(vals.pop()[0])
    elif nd is not None:
        next_dt = float(np.asarray(nd)[m])
    meta = {
        "kind": "member",
        "time": float(sim.times[m]),
        "step_count": int(sim.step_count),
        "config": {k: v for k, v in vars(sim.cfg).items()
                   if not k.startswith("_")},
        "next_dt": next_dt,
    }
    _write_installed(dirpath, dict(zip(names, vals)), meta, None)


def load_member_checkpoint(dirpath: str, grid):
    """Read a member session: (solo FlowState, meta). ``grid`` gives the
    device and dtype (the state cast as an admission installs it); falls
    back to ``dirpath.old`` as ``load_checkpoint`` does."""
    dirpath = _fallback_old(dirpath, "member checkpoint")
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("kind") != "member":
        raise ValueError(
            f"{dirpath!r} is not a member session checkpoint "
            f"(kind={meta.get('kind')!r})")
    from .uniform import FlowState
    with np.load(os.path.join(dirpath, "fields.npz")) as data:
        st = FlowState(**{k: torch.tensor(np.asarray(data[k]),
                                          dtype=grid.dtype,
                                          device=grid.device)
                          for k in FlowState._fields})
    return st, meta


# ---------------------------------------------------------------------------
# device snapshots (the StepGuard's ring)
# ---------------------------------------------------------------------------
# The stepping code may write into the tensors it was given, and torch has
# no buffer donation to guard against that, so a snapshot holds clones
# and a restore installs fresh clones of them (``Tensor.clone``, the JAX
# package's ``device_copy``): the ring entry itself is never handed to a
# step.

class DeviceSnapshot(NamedTuple):
    """One state on the device: clones of the fields plus host meta.

    ``dev`` holds the dt-cache entries that are device scalars at capture
    (the lagged drivers keep ``_next_dt`` / ``_next_umax`` on the device);
    ``meta['time']`` is settled by the StepGuard at verdict time on the
    lagged paths. The JAX package's ``mirror`` slot belongs to the
    host-redundant mirror tier, ROADMAP queue 1 item 8."""

    payload: dict        # field name -> device clone
    meta: dict           # host scalars (+ forest keys for a topology restore)
    dev: dict            # dt-cache entries still on the device
    shapes_pkl: object   # bytes | None


def _split_cache(meta: dict, dev: dict, name: str, val) -> None:
    """File a dt-cache value under meta (host) or dev (device clone)."""
    if torch.is_tensor(val):
        dev[name] = val.clone()
    elif val is not None:
        meta[name] = float(val)


def snapshot_state_device(sim) -> DeviceSnapshot:
    """Capture ``sim`` on the device: no host read, no state gather. The
    forest's topology keys are host numpy already; its ordered working
    state is cloned."""
    meta = {"time": sim.time, "step_count": sim.step_count}
    dev: dict = {}
    if hasattr(sim, "forest"):
        f = sim.forest
        ordf = sim._ordered_state()
        payload = {k: v.clone() for k, v in ordf.items()}
        order = sim._order
        meta.update(
            kind="forest",
            forest_version=f.version,
            n_real=int(sim._n_real),
            keys=np.stack([f.level[order], f.bi[order], f.bj[order]],
                          axis=1).astype(np.int32),
            next_dt_current=bool(sim._next_dt is not None
                                 and sim._next_dt_version == f.version),
            next_umax_current=bool(sim._next_umax is not None
                                   and sim._next_umax_version == f.version),
            last_iters=int(sim._last_iters),
            coarse_on=bool(sim._coarse_on),
        )
        _split_cache(meta, dev, "next_dt", sim._next_dt)
        _split_cache(meta, dev, "next_umax", sim._next_umax)
    else:
        payload = {k: v.clone() for k, v in sim.state._asdict().items()}
        meta["kind"] = "uniform"
        if hasattr(sim, "times"):
            # a fleet's clocks (host numpy; the guard settles them at
            # verdict time as it does the scalar clock)
            meta["times"] = np.array(sim.times)
        _split_cache(meta, dev, "next_dt", getattr(sim, "_next_dt", None))
    shapes = getattr(sim, "shapes", None)
    return DeviceSnapshot(
        payload=payload, meta=meta, dev=dev,
        shapes_pkl=pickle.dumps(list(shapes)) if shapes else None)


def snapshot_nbytes(snap: DeviceSnapshot) -> int:
    """Device bytes of one snapshot's fields (tensor metadata, no read;
    every part of a split field)."""
    def nbytes(v):
        if hasattr(v, "parts"):
            return sum(p.numel() * p.element_size() for p in v.parts)
        return v.numel() * v.element_size()
    return int(sum(nbytes(v) for v in snap.payload.values()))


def _restore_cache(sim, snap: DeviceSnapshot, fver=None) -> None:
    meta, dev = snap.meta, snap.dev
    if hasattr(sim, "_next_dt"):
        nd = dev.get("next_dt")
        sim._next_dt = nd.clone() if nd is not None else meta.get("next_dt")
        if hasattr(sim, "_next_dt_version"):
            sim._next_dt_version = (
                fver if meta.get("next_dt_current") else -1)
    if hasattr(sim, "_next_umax"):
        nu = dev.get("next_umax")
        sim._next_umax = (nu.clone() if nu is not None
                          else meta.get("next_umax"))
        sim._next_umax_version = (
            fver if meta.get("next_umax_current") else -1)
    if hasattr(sim, "_last_iters"):
        sim._last_iters = int(meta.get("last_iters", 0))
    if hasattr(sim, "_coarse_on"):
        sim._coarse_on = bool(meta.get("coarse_on", False))


def restore_snapshot_device(sim, snap: DeviceSnapshot) -> None:
    """Install fresh clones of a device snapshot into ``sim``.

    A snapshot of the current topology (the only kind the StepGuard's
    ladder restores: it re-anchors its ring after every regrid) installs
    clones of the ordered working state. One of another topology goes
    through ``_install_state`` with the cloned fields (device to device;
    only the dt-cache scalars are read to the host there, in one pull)."""
    meta = snap.meta
    if meta["kind"] == "forest":
        f = sim.forest
        if meta["forest_version"] == f.version and sim._ord is not None \
                and next(iter(snap.payload.values())).shape[0] \
                == next(iter(sim._ord.values())).shape[0]:
            sim.time = float(meta["time"])
            sim.step_count = int(meta["step_count"])
            sim._ord = {k: v.clone() for k, v in snap.payload.items()}
            # the restored ordered state is the truth; the slot fields
            # are stale until the next sync_fields()
            sim._ord_key = (f.version, f.fields.wver)
            sim._ord_dirty = True
            _restore_cache(sim, snap, fver=f.version)
        else:
            names = list(snap.dev)
            dev = dict(zip(names, (float(v) for v in
                                   pull(*snap.dev.values())))) \
                if names else {}
            m2 = {
                "time": meta["time"], "step_count": meta["step_count"],
                "dt_cache": {
                    "next_dt": dev.get("next_dt", meta.get("next_dt")),
                    "next_dt_current": meta["next_dt_current"],
                    "next_umax": dev.get("next_umax",
                                         meta.get("next_umax")),
                    "next_umax_current": meta["next_umax_current"],
                },
                "poisson_trigger": {"coarse_on": meta["coarse_on"],
                                    "last_iters": meta["last_iters"]},
            }
            n_real = meta["n_real"]
            data = {"__forest_keys": meta["keys"],
                    **{k: whole(v)[:n_real]
                       for k, v in snap.payload.items()}}
            shapes = (pickle.loads(snap.shapes_pkl)
                      if snap.shapes_pkl is not None else None)
            _install_state(sim, data, m2, shapes)
            return
    else:
        sim.time = float(meta["time"])
        sim.step_count = int(meta["step_count"])
        if hasattr(sim, "times") and "times" in meta:
            sim.times = np.array(meta["times"])
            sim.time = float(sim.times.min())
        sim.state = type(sim.state)(
            **{k: v.clone() for k, v in snap.payload.items()})
        _restore_cache(sim, snap)
    if getattr(sim, "shapes", None) and snap.shapes_pkl is not None:
        sim.shapes[:] = pickle.loads(snap.shapes_pkl)
        sim._initialized = True
