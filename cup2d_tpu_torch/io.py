"""Field dumps in the reference format and checkpoint/restart, the
counterpart of ``cup2d_tpu.io``.

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
restores every member at the shared clock. A fleet placed on a mesh
writes its fields in the global layout [B, ...] and places what it
loads, so a placed fleet's checkpoint loads unplaced and the other way
round. A serving session saves and
resumes one member alone (``save_member_checkpoint``,
``load_member_checkpoint``: the member's solo-shaped fields, its own clock
and its chained dt, in the same tmp -> park -> replace order). The device
snapshot tier carries a fleet's clocks and its [B] dt row.

Under a ``torch.distributed`` world (``parallel.launch``) dumps and
checkpoints are collective, as the reference's MPI-IO dump
(main.cpp:3367-3467) and ``cup2d_tpu/io.py:36-67``: every rank joins the
gather (``whole``: an all-gather of the split fields; the forest's slot
fields are whole on every rank already), rank 0 alone writes, and a
barrier keeps the others from racing past an incomplete file. Every rank
loads the same bytes.

Every device read goes through ``shapes_host.pull``; ``state_gathers``
counts ``_gather_state`` calls (``profiling.HostCounters``).

The elastic resume (``resilience.StepGuard.elastic_recover``):
``snapshot_covers`` (whether a device snapshot survives the loss of some
hosts: its owners, or the ring neighbours holding its mirror) and
``restore_snapshot_resharded`` (a snapshot installed into a sim that was
re-meshed since, ``ShardedUniformSim.remesh`` / ``ShardedAMRSim.remesh``).
The host-redundant mirror tier rides the device snapshots of a split
uniform run: ``mirror_snapshot`` ships every host's block of slabs to its
ring neighbour (``parallel.mesh.host_ring_shift``) with a per-block
checksum kept on the device, ``verify_mirror`` checks it on the cold path
(one read), ``restore_snapshot_mirrored`` rebuilds the lost hosts' columns
from the survivors' mirror copies; ``destroy_shards`` and
``corrupt_mirror`` are the ``shard_loss`` and ``mirror_corrupt`` drills.
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


def _sync_processes() -> None:
    """Barrier of the world, so that no rank runs past a file rank 0 is
    still writing (a no-op without a world)."""
    from .resilience import dist_initialized
    if not dist_initialized():
        return
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def dump_uniform(path: str, time: float, vel, h: float,
                 origin=(0.0, 0.0)) -> None:
    """Write a uniform-grid velocity field [2, Ny, Nx] (a tensor, a split
    field or numpy) in the reference dump format, cells in row-major
    (y-outer) order. Collective under a world."""
    from .resilience import is_writer
    vel = whole(vel)
    if is_writer():
        _dump_uniform(path, time, vel, h, origin)
    _sync_processes()


def _dump_uniform(path, time, vel, h, origin) -> None:
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
    ``[order]`` gather runs on the device before the one host copy. Under
    a world every rank holds the slot fields whole: rank 0 writes, the
    others wait at the barrier."""
    from .resilience import is_writer
    if is_writer():
        _dump_forest(path, time, forest, order)
    _sync_processes()


def _dump_forest(path: str, time: float, forest, order) -> None:
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
    their mesh's home device; all-gathers under a world); anything else
    as it is. Dumps,
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
    point. Collective under a world: every rank gathers, rank 0 writes,
    all meet at a barrier."""
    from .resilience import is_writer
    payload, meta = _gather_state(sim)
    shapes = getattr(sim, "shapes", [])
    if is_writer():
        _write_installed(dirpath, payload, meta, shapes, crash_window=True)
    _sync_processes()


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
    and installing the new one. Under a world every rank reads the same
    bytes and installs them alike."""
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
    """Serialize fleet member ``m``'s session to ``dirpath`` (one read).
    Collective under a world (``cup2d_tpu/io.py:476-514``): every rank
    gathers the member, rank 0 writes, all meet at a barrier."""
    from .resilience import is_writer
    st = sim.member_state(m)
    names = list(st._fields)
    nd = sim._next_dt
    extra = [nd[m].reshape(1)] if torch.is_tensor(nd) else []
    # a placed fleet's member in the global layout, on the fleet's device
    dev = sim.grid.device
    vals = pull(*(whole(getattr(st, k)).to(dev) for k in names), *extra,
                keep_dtype=True)
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
    if is_writer():
        _write_installed(dirpath, dict(zip(names, vals)), meta, None)
    _sync_processes()


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
    lagged paths. ``mirror``: the ``MirroredSnapshot`` of the
    host-redundant tier (None unless the StepGuard mirrors)."""

    payload: dict        # field name -> device clone
    meta: dict           # host scalars (+ forest keys for a topology restore)
    dev: dict            # dt-cache entries still on the device
    shapes_pkl: object   # bytes | None
    mirror: object = None   # MirroredSnapshot | None


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


def _n_blocks(v) -> int:
    """The ordered blocks of a forest field, split (``Blocks``) or whole."""
    mesh = getattr(v, "mesh", None)
    return v.shape[0] * (mesh.size if mesh is not None else 1)


def _placed(sim, v):
    """An ordered forest field in the sim's current placement: ``v`` where
    it lies there already (split over the sim's mesh, or whole where the
    sim is not split), else gathered and placed anew (a snapshot taken
    before a ``remesh``)."""
    mesh = getattr(v, "mesh", None)
    split = getattr(sim, "_split", False)
    if (split and mesh is sim.mesh) or (not split and mesh is None):
        return v
    return sim._put_ordered(whole(v))


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
                and _n_blocks(next(iter(snap.payload.values()))) \
                == _n_blocks(next(iter(sim._ord.values()))):
            sim.time = float(meta["time"])
            sim.step_count = int(meta["step_count"])
            sim._ord = {k: _placed(sim, v.clone())
                        for k, v in snap.payload.items()}
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


# ---------------------------------------------------------------------------
# elastic topology resume: snapshot coverage and the resharded restore
# (cup2d_tpu/io.py:756-862)
# ---------------------------------------------------------------------------

def snapshot_covers(snap: DeviceSnapshot, lost_processes=(), *,
                    lost_hosts=(), shards_destroyed=False,
                    mirror=True) -> bool:
    """True iff a device snapshot can seed an elastic resume after a
    topology loss (``cup2d_tpu/io.py:756-818``): every payload shard still
    readable from its owner, or from the ring neighbour that holds its
    mirror. A split field's shard belongs to the rank its part lives on
    (``SlabMesh.owners``; every shard of a single-controller mesh to this
    process), so the owner rule fails where a lost process owned one;
    ``shards_destroyed`` (the simulated real loss, a ``shard_loss`` fault)
    voids owner coverage whenever a host or process is named lost.

    Mirror coverage (``mirror``, the default): a lost host's block is
    still covered when the snapshot carries a ``MirroredSnapshot`` and the
    host's ring neighbour, which holds its mirror, is alive (two adjacent
    losses take a block and its only mirror), and the mirror's slabs are
    readable from this process: never after a real rank loss, whose
    cross-rank slabs need the lost world (as the JAX package's arrays are
    not fully addressable then). ``lost_hosts`` names the dead hosts by
    ring index (simulated hosts or ranks). ``mirror=False`` asks about the
    owner rule alone (the plain ring rung)."""
    lost = set(lost_processes)
    dead = set(lost_hosts) | lost
    owner_ok = not (shards_destroyed and dead)
    if owner_ok and lost:
        for v in snap.payload.values():
            mesh = getattr(v, "mesh", None)
            if mesh is not None and mesh.distributed \
                    and lost & set(mesh.owners):
                owner_ok = False
                break
    if owner_ok:
        return True
    m = getattr(snap, "mirror", None)
    if not mirror or m is None or not dead:
        return False
    for h in dead:
        if (h + 1) % m.n_hosts in dead:
            return False
    for v in m.payload.values():
        mesh = getattr(v, "mesh", None)
        if mesh is not None and not mesh.all_local:
            return False
    return True


def restore_snapshot_resharded(sim, snap: DeviceSnapshot) -> None:
    """Install a device snapshot into a sim whose mesh changed since the
    capture (after ``remesh``; ``cup2d_tpu/io.py:820-862``): the device
    restore first (which installs a forest's ordered working state in the
    sim's current placement already), then the uniform state re-split over
    the sim's current mesh through ``set_state`` and a cached device dt
    moved to the mesh's home. Valid where ``snapshot_covers`` says so."""
    restore_snapshot_device(sim, snap)
    if not hasattr(sim, "forest") and hasattr(sim, "set_state"):
        sim.set_state(type(sim.state)(*(whole(v) for v in sim.state)))
    mesh = getattr(sim, "mesh", None)
    nd = getattr(sim, "_next_dt", None)
    if mesh is not None and torch.is_tensor(nd):
        sim._next_dt = nd.to(mesh.home)


# ---------------------------------------------------------------------------
# the host-redundant mirror tier (cup2d_tpu/io.py:864-1143): in-memory
# recovery from a real host loss. A device snapshot's slabs die with their
# host; the mirror ships every host's block of slabs to its ring neighbour
# at capture (parallel.mesh.host_ring_shift), with one checksum per host
# block kept on the device, so a lost host's block is rebuilt from its
# neighbour's copy, and a torn or corrupt copy is found at restore instead
# of installed.
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


class MirroredSnapshot(NamedTuple):
    """The neighbour-held copy of one ``DeviceSnapshot``.

    ``payload[k]`` is split over the same mesh as the field it mirrors but
    moved one host block along the ring: the slabs on host h hold host
    h-1's columns (globally ``roll(x, +Nx/H)`` along x). ``sums[k]`` holds
    the capture-time checksum of each local slab (int64 in [0, 2^32), on
    the mesh's home device), from which each host block's uint32 sum
    follows; nothing is read until a restore compares them."""

    payload: dict        # field name -> ring-shifted Slabs
    sums: dict           # field name -> [local slabs] int64 checksums
    n_hosts: int         # ring size at capture


def _bits_sum(t: torch.Tensor) -> torch.Tensor:
    """The wrap-sum (mod 2^32) of ``t``'s bit patterns as 32-bit words (a
    bf16 field's as 16-bit words), int64 in [0, 2^32) on ``t``'s device:
    any flipped byte moves it."""
    t = t.contiguous()
    if t.element_size() == 2:
        w = t.view(torch.int16).to(torch.int64) & 0xFFFF
        return w.sum() & _MASK32
    return t.view(torch.int32).sum(dtype=torch.int64) & _MASK32


def _block_sums(v: torch.Tensor, h: int) -> torch.Tensor:
    """The per-host-block checksum of a whole field
    (``cup2d_tpu/io.py:906-917``): the x axis cut into ``h`` blocks, each
    block's 32-bit words summed mod 2^32. [h] int64 in [0, 2^32) on the
    field's device, equal to the JAX package's uint32 sums."""
    w = v.shape[-1] // h
    return torch.stack([_bits_sum(v[..., i * w:(i + 1) * w])
                        for i in range(h)])


def _slab_sums(s) -> torch.Tensor:
    """[local slabs] checksums of a split field, on its home device."""
    home = s.mesh.home
    return torch.stack([_bits_sum(p).to(home) for p in s.parts])


def _host_sums(slab_sums: torch.Tensor, mesh, n_hosts: int) -> torch.Tensor:
    """Each host block's checksum from every slab's ([n_hosts] on the
    home device): the slabs' sums of every rank in shard order (one
    all-gather under a world), then summed mod 2^32 per block of D/H."""
    from .parallel.shard_halo import all_shards
    every = torch.stack(all_shards(list(slab_sums.unbind(0)), mesh,
                                   kind="state"))
    return every.view(n_hosts, -1).sum(1) & _MASK32


def _mirrorable(v, n_hosts: int) -> bool:
    from .parallel.shard_halo import Slabs
    return (isinstance(v, Slabs) and len(v.shape) >= 2
            and v.shape[-1] % n_hosts == 0 and v.mesh.size % n_hosts == 0)


def mirror_snapshot(snap: DeviceSnapshot, mesh, n_hosts: int):
    """The host-redundant mirror of ``snap``: every payload field moved
    one host block along the ring (``host_ring_shift``, fresh tensors)
    and every slab of the copy checksummed, all on the device: no host
    read, and, on one process, no collective. Returns None for a payload
    the tier does not cover: a forest's (its block-leading layout keeps
    the disk rung for a real loss, as in the JAX package) or one whose
    fields or mesh do not divide into ``n_hosts`` blocks. The copies are
    enqueued on the current stream after the snapshot's clones, so the
    next step's writes cannot reach them."""
    from .parallel.mesh import host_ring_shift
    if snap.meta.get("kind") != "uniform":
        return None
    if not all(_mirrorable(v, n_hosts) for v in snap.payload.values()):
        return None
    payload = {k: host_ring_shift(v, n_hosts)
               for k, v in snap.payload.items()}
    sums = {k: _slab_sums(v) for k, v in payload.items()}
    return MirroredSnapshot(payload=payload, sums=sums,
                            n_hosts=int(n_hosts))


def mirror_nbytes(snap) -> int:
    """Device bytes of a snapshot's mirror payload (0 without one); tensor
    metadata, no read."""
    m = getattr(snap, "mirror", None)
    if m is None:
        return 0
    return int(sum(p.numel() * p.element_size()
                   for v in m.payload.values() for p in v.parts))


def _lost_col_mask(nx: int, lost_hosts, n_hosts: int) -> np.ndarray:
    """Boolean [nx] mask of the x columns the lost hosts own (the
    contiguous block h*Nx/H .. (h+1)*Nx/H, the TopologyGuard's grouping)."""
    w = nx // n_hosts
    mask = np.zeros(nx, bool)
    for h in lost_hosts:
        mask[h * w:(h + 1) * w] = True
    return mask


def _lost_slabs(mesh, lost_hosts, n_hosts: int) -> set:
    """The slabs of the lost hosts (host of slab d: d * H // D)."""
    lost = set(lost_hosts)
    return {d for d in range(mesh.size) if d * n_hosts // mesh.size in lost}


def verify_mirror(snap: DeviceSnapshot, lost_hosts) -> list:
    """The lost hosts' mirror holders' blocks checked against their
    capture-time sums. Returns the rejects (field, block, expected,
    actual); [] means the mirror may be installed. One read of the small
    sum vectors, on the cold restore path only."""
    from .shapes_host import pull
    m = snap.mirror
    holders = sorted({(h + 1) % m.n_hosts for h in lost_hosts})
    names = sorted(m.payload)
    vecs = []
    for k in names:
        mesh = m.payload[k].mesh
        vecs.append(_host_sums(m.sums[k], mesh, m.n_hosts))
        vecs.append(_host_sums(_slab_sums(m.payload[k]), mesh, m.n_hosts))
    got = pull(torch.stack(vecs), keep_dtype=True)[0]
    bad = []
    for i, k in enumerate(names):
        expect, actual = got[2 * i], got[2 * i + 1]
        for h in holders:
            if int(expect[h]) != int(actual[h]):
                bad.append({"field": k, "block": int(h),
                            "expected": int(expect[h]),
                            "actual": int(actual[h])})
    return bad


def corrupt_mirror(snap: DeviceSnapshot) -> bool:
    """The ``mirror_corrupt`` drill: negate the first element of every host
    block of every mirror field (which moves the block's word sum whatever
    the value; the two zeros' patterns differ too), its stored sums left
    as they were, so ``verify_mirror`` rejects whichever holder block a
    restore asks about. The payload dict takes new tensors; no tensor of a
    snapshot is written. False when the snapshot carries no mirror."""
    from .parallel.shard_halo import Slabs
    m = snap.mirror
    if m is None:
        return False
    payload = {}
    for k, v in m.payload.items():
        D = v.mesh.size
        firsts = {h * D // m.n_hosts for h in range(m.n_hosts)}
        parts = []
        for d, p in zip(v.mesh.local, v.parts):
            if d in firsts:
                p = p.clone()
                p[(0,) * p.dim()] *= -1
            parts.append(p)
        payload[k] = Slabs(parts, v.mesh)
    m.payload.clear()
    m.payload.update(payload)
    return True


def _wipe(v, lost_hosts, n_hosts: int):
    """``v`` with the lost hosts' shards zeroed as new tensors: a split
    field's slabs or blocks of those hosts, a whole field's x columns."""
    from .parallel.shard_halo import Blocks, Slabs
    if isinstance(v, (Slabs, Blocks)):
        lost = _lost_slabs(v.mesh, lost_hosts, n_hosts)
        parts = [torch.zeros_like(p) if d in lost else p
                 for d, p in zip(v.mesh.local, v.parts)]
        if isinstance(v, Blocks):
            return Blocks(parts, v.mesh, v.axis)
        return Slabs(parts, v.mesh)
    mask = torch.as_tensor(_lost_col_mask(v.shape[-1], lost_hosts,
                                          n_hosts), device=v.device)
    return torch.where(mask, torch.zeros((), dtype=v.dtype,
                                         device=v.device), v)


def destroy_shards(sim, snaps, lost_hosts, n_hosts: int) -> list:
    """The ``shard_loss`` drill (``cup2d_tpu/io.py:1083-1111``): zero the
    lost hosts' x-column blocks in the live state of a uniform run, in
    every snapshot's payload and in the mirror slabs those hosts held,
    which is what a real host loss takes with it, so a resumed run can
    only have come from the survivors' mirror copies or from disk. New
    tensors throughout: no snapshot tensor is written. Returns the new
    snapshot list."""
    if hasattr(sim, "state") and not hasattr(sim, "forest"):
        sim.state = type(sim.state)(
            **{k: _wipe(v, lost_hosts, n_hosts)
               for k, v in sim.state._asdict().items()})
    out = []
    for s in snaps:
        payload = {k: _wipe(v, lost_hosts, n_hosts)
                   for k, v in s.payload.items()}
        m = s.mirror
        if m is not None:
            m = m._replace(payload={k: _wipe(v, lost_hosts, n_hosts)
                                    for k, v in m.payload.items()})
        out.append(s._replace(payload=payload, mirror=m))
    return out


def restore_snapshot_mirrored(sim, snap: DeviceSnapshot,
                              lost_hosts) -> None:
    """The mirror rung (``cup2d_tpu/io.py:1114-1143``): the lost hosts'
    blocks rebuilt from their ring neighbours' mirror slabs, then installed
    through ``restore_snapshot_resharded``. The mirror is the field moved
    +Nx/H along the ring, so slab j's realigned copy is mirror slab
    (j + D/H) % D (``permute_slabs``); the lost slabs take it, every other
    slab keeps the snapshot's own. Valid where ``snapshot_covers`` said so
    with the mirror and ``verify_mirror`` found no reject."""
    from .parallel.shard_halo import Slabs, permute_slabs
    m = snap.mirror
    payload = {}
    for k, v in snap.payload.items():
        D = v.mesh.size
        dph = D // m.n_hosts
        lost = _lost_slabs(v.mesh, lost_hosts, m.n_hosts)
        back = permute_slabs(m.payload[k], lambda j: (j + dph) % D)
        payload[k] = Slabs([b if d in lost else p for d, p, b in
                            zip(v.mesh.local, v.parts, back.parts)],
                           v.mesh)
    restore_snapshot_resharded(
        sim, snap._replace(payload=payload, mirror=None))
