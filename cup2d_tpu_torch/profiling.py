"""Telemetry and profiling, the counterpart of ``cup2d_tpu.profiling``.

Everything here is host-side bookkeeping on top of work the step already
does: the per-step scalars arrive in the step's own reads
(``shapes_host.pull``), so a metrics-on run makes no read a metrics-off
run does not.

- ``MetricsRecorder``: one ``METRICS_KEYS`` record per step (solver
  health, dt/umax, the fused physics invariants, the forest's shape, the
  host counters, HBM peak, phase times), streamed as JSONL through a
  ``resilience.EventLog``. The key set and schema version are the JAX
  package's, letter for letter; what does not apply to a run is null
  (the flight recorder's gauges without one). A fleet's [B] diagnostics fold
  into the scalar slots as the JAX package's aggregates, with the rows in
  ``member_health``; a serving pool adds its gauges, and with per-client
  streams (``ClientStreams``) the rows go to one JSONL file a client.
- ``HostCounters``: per-run deltas of the port's process-wide counters:
  ``jit_compiles`` counts kernel-library builds and loads
  (``ops.hopper_kernels.build_events``: 0 in steady state, always 0 on
  the CPU), ``device_gets`` device-to-host reads (``shapes_host.pulls``),
  ``state_gathers`` full state gathers (``io._gather_state``).
  ``hbm_peak_bytes`` is ``torch.cuda.max_memory_allocated`` on the card,
  None on the CPU. With a flight recorder (``tracing.FlightRecorder``)
  each record carries its span count, build ms and allocator peak.
- ``TraceWindow``: ``CUP2D_TRACE=start:stop[:logdir]`` wraps exactly steps
  [start, stop) in ``torch.profiler``, which writes a Chrome trace into
  logdir; ``trace(logdir)`` wraps a block.
- ``PhaseTimers``: per-phase wall time, opt-in on every driver
  (``sim.timers``; the JAX package's phase names); ``fence`` synchronizes
  the cards of a phase's tensors so a phase is charged its own device
  time (no read). ``throughput(sim)``: cells x steps per second.
- ``load_metrics``, ``load_metrics_report``, ``summarize_metrics``,
  ``summarize_client``: the streams' readers (``post --metrics``).
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch


class PhaseTimers:
    """Accumulates wall time per named phase across steps."""

    def __init__(self):
        self.acc = defaultdict(float)
        self.count = defaultdict(int)

    @contextmanager
    def phase(self, name: str):
        """Time a host-side block. The caller fences the phase's device
        work (``fence``)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] += time.perf_counter() - t0
            self.count[name] += 1

    def fence(self, name: str, *tensors):
        """Wait for the cards to finish the work queued for ``tensors``
        (tensors, split fields, or tuples, lists and dicts of them) so the
        enclosing ``phase(name)`` block is charged its device time; each
        card is synchronized once, and nothing is read from it. Returns
        the arguments unchanged; anything but a CUDA tensor passes."""
        for dev in sorted(_cuda_devices(tensors), key=str):
            torch.cuda.synchronize(dev)
        return tensors

    def report(self) -> dict:
        return {
            name: {
                "total_s": self.acc[name],
                "mean_ms": 1e3 * self.acc[name] / max(1, self.count[name]),
                "count": self.count[name],
            }
            for name in sorted(self.acc)
        }

    def summary(self) -> str:
        rows = [f"{k:>16s}: {v['total_s']:8.3f}s total "
                f"{v['mean_ms']:8.2f}ms/call x{v['count']}"
                for k, v in self.report().items()]
        return "\n".join(rows)


def _cuda_devices(obj, out=None) -> set:
    """The CUDA devices the tensors in ``obj`` live on (split fields by
    their parts, containers element by element)."""
    out = set() if out is None else out
    if torch.is_tensor(obj):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, out)
    elif hasattr(obj, "parts"):
        _cuda_devices(obj.parts, out)
    return out


def throughput(sim) -> dict:
    """cells*steps/s so far, from the sim's own counters (the forest's
    live cell count)."""
    if hasattr(sim, "forest"):
        cells = len(sim.forest.blocks) * sim.forest.bs ** 2
    else:
        # a fleet steps B member grids a step
        cells = sim.grid.nx * sim.grid.ny * getattr(sim, "members", 1)
    wall = getattr(sim, "timers", None)
    # "a/b"-named sub-phases break a parent down: not in the wall total
    total = (sum(v for k, v in wall.acc.items() if "/" not in k)
             if wall else float("nan"))
    return {
        "cells": cells,
        "steps": sim.step_count,
        "sim_time": sim.time,
        "wall_s": total,
        "cells_steps_per_sec": (
            cells * sim.step_count / total if wall and total > 0
            else float("nan")),
    }


class _NullTimers:
    """No-op stand-in so instrumented code needs no branches."""

    @contextmanager
    def phase(self, name):
        yield

    def fence(self, name, *tensors):
        return tensors


NULL_TIMERS = _NullTimers()


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _export(prof, logdir: str, name: str) -> str:
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, name)
    prof.export_chrome_trace(path)
    return path


@contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the enclosed block, written to
    ``logdir/trace.json`` (Chrome trace format)."""
    prof = _profiler()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        _export(prof, logdir, "trace.json")


# ---------------------------------------------------------------------------
# windowed tracing (CUP2D_TRACE=start:stop[:logdir])
# ---------------------------------------------------------------------------

class TraceWindow:
    """Windowed ``torch.profiler`` tracing driven by the step counter: the
    trace wraps exactly steps ``[start, stop)``. The driver calls
    ``maybe_start`` before attempting a step and ``maybe_stop`` after it
    (with the post-step counter); ``>=`` comparisons keep a restarted run
    from arming a window its step range already passed. ``close`` stops a
    still-open trace at loop exit. The trace lands in
    ``logdir/trace_<start>_<stop>.json`` (``...json.r<rank>`` from the
    ranks past 0 of a world: each rank traces its own card)."""

    def __init__(self, start: int, stop: int, logdir: str = "trace"):
        if not (0 <= int(start) < int(stop)):
            raise ValueError(
                f"trace window needs 0 <= start < stop, got "
                f"{start}:{stop}")
        self.start = int(start)
        self.stop = int(stop)
        self.logdir = logdir
        self.active = False
        self.done = False
        self._prof = None

    @classmethod
    def from_env(cls) -> Optional["TraceWindow"]:
        """Latch CUP2D_TRACE once. A malformed spec raises rather than
        arming nothing."""
        spec = os.environ.get("CUP2D_TRACE", "")
        if not spec:
            return None
        parts = spec.split(":", 2)
        if len(parts) < 2:
            raise ValueError(
                f"CUP2D_TRACE={spec!r}: expected start:stop[:logdir]")
        try:
            start, stop = int(parts[0]), int(parts[1])
        except ValueError:
            raise ValueError(
                f"CUP2D_TRACE={spec!r}: start/stop must be integers")
        logdir = parts[2] if len(parts) == 3 and parts[2] else "trace"
        return cls(start, stop, logdir)

    def maybe_start(self, step_count: int) -> None:
        """Arm the trace before stepping ``step_count`` if the window
        opens here."""
        if self.active or self.done or step_count < self.start \
                or step_count >= self.stop:
            return
        self._prof = _profiler()
        self._prof.start()
        self.active = True
        from .resilience import record_event
        record_event(event="trace_start", step=step_count,
                     logdir=self.logdir)

    def maybe_stop(self, step_count: int) -> None:
        """Close the trace once the post-step counter reaches the window
        end."""
        if self.active and step_count >= self.stop:
            self._stop(step_count)

    def close(self) -> None:
        if self.active:
            self._stop(None)

    def _stop(self, step_count) -> None:
        self._prof.stop()
        from .parallel.launch import rank
        name = f"trace_{self.start}_{self.stop}.json"
        if rank() > 0:
            name += f".r{rank()}"
        _export(self._prof, self.logdir, name)
        self._prof = None
        self.active = False
        self.done = True
        from .resilience import record_event
        record_event(event="trace_stop", step=step_count,
                     logdir=self.logdir)


# ---------------------------------------------------------------------------
# host-side counters
# ---------------------------------------------------------------------------

def _totals() -> dict:
    """The process-wide counts since import, each kept where it happens."""
    from . import io, shapes_host
    from .ops import hopper_kernels
    return {"jit_compiles": hopper_kernels.build_events,
            "device_gets": shapes_host.pulls,
            "state_gathers": io.state_gathers}


def hbm_peak_bytes(device=None) -> Optional[int]:
    """The card's allocator high-water mark
    (``torch.cuda.max_memory_allocated``) of ``device``, or None on the
    CPU. With no device: the current card, if one is in use."""
    if device is None:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return None
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


class HostCounters:
    """Host-side observability counters for one run: the process-wide
    counts (``_totals``) since ``install``, as deltas.

    - ``jit_compiles``: kernel-library builds and loads (``nvcc`` runs and
      C entries resolved) — the first step on a card pays them, a
      steady-state step none; never any on the CPU.
    - ``device_gets``: device-to-host reads (``shapes_host.pull`` calls:
      the step's stacked diagnostic read, the solvers' flag reads, the
      dt and tag reads).
    - ``state_gathers``: full state gathers (``io._gather_state``), made
      by checkpoints and post-mortems only."""

    def __init__(self):
        self._base: Optional[dict] = None
        self._frozen: Optional[dict] = None

    def install(self) -> "HostCounters":
        if self._base is None:
            self._base = _totals()
        self._frozen = None
        return self

    def uninstall(self) -> None:
        if self._base is not None and self._frozen is None:
            self._frozen = self.snapshot()

    def snapshot(self) -> dict:
        if self._frozen is not None:
            return dict(self._frozen)
        if self._base is None:
            return {"jit_compiles": 0, "device_gets": 0,
                    "state_gathers": 0}
        cur = _totals()
        return {k: cur[k] - self._base[k] for k in cur}


# ---------------------------------------------------------------------------
# the per-step metrics stream
# ---------------------------------------------------------------------------

# THE frozen record key set of the JAX package (its schema-stability
# golden test holds both copies equal). Keys are always present; fields
# that do not apply are null.
METRICS_SCHEMA_VERSION = 12
METRICS_KEYS = (
    "schema", "step", "t", "dt", "wall_ms",
    "umax", "dt_next",
    "poisson_iters", "poisson_residual",
    "poisson_converged", "poisson_stalled",
    "poisson_mode", "precond_cycles",
    "kernel_tier", "prec_mode",
    "smoother_tier",
    "bc_table", "case",
    "energy", "div_linf",
    "n_blocks", "blocks_per_level", "refines", "coarsens",
    "halo_real_bytes", "halo_padded_bytes",
    "jit_compiles", "device_gets", "state_gathers", "hbm_peak_bytes",
    "snap_ring_bytes", "replayed_steps",
    "topology_epoch", "remesh_count", "remesh_ms",
    "mirror_bytes", "mirror_ms", "restore_source",
    "fleet_members", "member_steps_per_s", "member_health",
    "active_members", "occupancy", "admitted", "evicted",
    "queue_depth",
    "span_count", "compile_ms_total", "hbm_exec_bytes",
    "phase_ms",
)

_SERVE_KEYS = ("active_members", "occupancy", "admitted", "evicted",
               "queue_depth")

_DIAG_KEYS = ("umax", "dt_next", "poisson_iters", "poisson_residual",
              "poisson_converged", "poisson_stalled", "energy",
              "div_linf", "precond_cycles")

_INT_KEYS = {"poisson_iters", "precond_cycles"}
_BOOL_KEYS = {"poisson_converged", "poisson_stalled", "finite"}

# a fleet's [B] rows fold into the record's scalar slots as these
# conservative aggregates; the rows themselves go to member_health
_FLEET_AGG = {
    "umax": np.max, "dt_next": np.min,
    "poisson_iters": np.max, "poisson_residual": np.max,
    "poisson_converged": np.all, "poisson_stalled": np.any,
    "energy": np.sum, "div_linf": np.max,
    "precond_cycles": np.max,
}

# the per-member rows of member_health: the diag keys plus the health and
# clock entries of the guard's read
_MEMBER_KEYS = _DIAG_KEYS + ("finite", "dt")


def _jsonable(key: str, v):
    if v is None:
        return None
    if key in _INT_KEYS:
        return int(v)
    if key in _BOOL_KEYS:
        return bool(v)
    return float(v)


def _member_list(key: str, v):
    return [_jsonable(key, x) for x in np.asarray(v).ravel()]


def _device_of(sim):
    if sim is None:
        return None
    grid = getattr(sim, "grid", None)
    return getattr(grid, "device", None) or getattr(sim, "device", None)


class MetricsRecorder:
    """Assembles one ``METRICS_KEYS`` record per step and streams it
    through ``sink`` (a ``resilience.EventLog``, which writes from rank 0
    only under a world; None returns records without writing). The record reads nothing from the device: the
    diagnostics arrive as host values from the step's own read (a diag
    still holding tensors costs ONE counted ``pull``), the forest
    histogram is host numpy cached per topology version, and counters and
    timers are host state. ``guard``: a ``resilience.StepGuard`` (its
    ring and replays); ``server``: a ``fleet.FleetServer`` (the schema-v7
    gauges and, with its ``clients`` streams, one row a client a step);
    ``flight``: a ``tracing.FlightRecorder`` (its cumulative span count,
    build milliseconds and allocator peak ride every record)."""

    def __init__(self, sink=None, counters: Optional[HostCounters] = None,
                 timers: Optional[PhaseTimers] = None, guard=None,
                 server=None, flight=None):
        self.sink = sink
        self.counters = counters
        self.timers = timers
        self.server = server
        self.flight = flight
        self.guard = guard
        self._last_time: Optional[float] = None
        self._last_counters = counters.snapshot() if counters else None
        self._last_phase: dict = dict(timers.acc) if timers else {}
        self._last_regrid = (0, 0)
        self._last_replayed = 0
        self._last_remesh_ms = 0.0
        self._last_mirror_ms = 0.0
        self._lvl_cache = (None, None, None)   # (version, hist, n)

    def prime(self, sim) -> None:
        """Anchor the dt baseline to the sim's current time (call once
        before the loop; the first record's dt is null otherwise)."""
        self._last_time = float(sim.time)
        if hasattr(sim, "_n_refined"):
            self._last_regrid = (sim._n_refined, sim._n_coarsened)

    def record(self, sim, diag: dict, wall_ms: Optional[float] = None
               ) -> dict:
        """One record from a driver sim after a completed step; emits into
        the sink and returns the record."""
        return self.record_step(step=sim.step_count, t=float(sim.time),
                                diag=diag, wall_ms=wall_ms, sim=sim)

    def record_step(self, *, step: int, t: float, diag: dict,
                    wall_ms: Optional[float] = None, sim=None,
                    dt: Optional[float] = None) -> dict:
        vals = {k: diag[k] for k in _MEMBER_KEYS if k in diag}
        dev = [k for k, v in vals.items() if torch.is_tensor(v)]
        if dev:
            from .shapes_host import pull
            vals.update(zip(dev, (v.item() if v.ndim == 0 else v for v in
                                  pull(*(vals[k] for k in dev)))))
        # a fleet's [B] rows: the detail in member_health, the
        # conservative aggregates in the scalar slots
        vecs = [np.asarray(v) for v in vals.values() if np.ndim(v) >= 1]
        fleet_b = int(vecs[0].shape[0]) if vecs else 0
        member_health = None
        if fleet_b:
            member_health = {k: _member_list(k, v)
                             for k, v in vals.items() if np.ndim(v) >= 1}
            vals = {k: (_FLEET_AGG[k](np.asarray(v))
                        if np.ndim(v) >= 1 and k in _FLEET_AGG else v)
                    for k, v in vals.items()}
        if dt is not None and np.ndim(dt) >= 1:
            if member_health is not None:
                member_health["dt"] = _member_list("dt", dt)
            dt = float(np.min(dt))    # the pacing (slowest-dt) member
        if dt is None:
            dt = (t - self._last_time) if self._last_time is not None \
                else None
        self._last_time = t
        rec = {
            "schema": METRICS_SCHEMA_VERSION,
            "step": int(step),
            "t": float(t),
            "dt": float(dt) if dt is not None else None,
            "wall_ms": round(wall_ms, 3) if wall_ms is not None else None,
        }
        for k in _DIAG_KEYS:
            rec[k] = _jsonable(k, vals.get(k))
        # attribution strings: from the diag when a producer supplies one
        # (the guard's dispatch-time labels), else the driver's property
        for key in ("poisson_mode", "kernel_tier", "prec_mode",
                    "smoother_tier", "bc_table", "case"):
            kv = diag.get(key)
            if kv is None and sim is not None:
                kv = getattr(sim, key, None)
            rec[key] = str(kv) if kv is not None else None
        rec.update(self._amr_fields(sim))
        rec.update(self._comm_fields(sim))
        rec.update(self._counter_fields(sim))
        rec.update(self._guard_fields())
        rec["fleet_members"] = fleet_b or None
        rec["member_steps_per_s"] = (
            round(fleet_b * 1e3 / wall_ms, 3)
            if fleet_b and wall_ms else None)
        serve = (self.server.telemetry_fields()
                 if self.server is not None else {})
        for k in _SERVE_KEYS:
            rec[k] = serve.get(k)
        if (self.server is not None and self.server.clients is not None
                and member_health is not None):
            # the per-client split: the rows go to their clients' streams,
            # the record keeps the folds
            self._emit_client_rows(rec, member_health)
            member_health = None
        rec["member_health"] = member_health
        rec.update(self._flight_fields())
        rec["phase_ms"] = self._phase_fields()
        if self.sink is not None:
            self.sink.emit(event="metrics", **rec)
        return rec

    def _emit_client_rows(self, rec: dict, member_health: dict) -> None:
        """One row for each slot occupied during the recorded step
        (``server.step_clients``: a member that retired at the end of that
        step still gets its last row): its slice of the diagnostics and
        its own clock (the record's ``t`` is the pool's min)."""
        srv = self.server
        sim = srv.sim
        nm = len(next(iter(member_health.values())))
        for m in range(nm):
            cid = srv.step_clients[m]
            if cid is None:
                continue
            row = {k: v[m] for k, v in member_health.items()}
            srv.clients.emit(cid, {
                "event": "metrics", "client": str(cid), "member": m,
                "step": rec["step"], "t": float(sim.times[m]), **row})

    def _amr_fields(self, sim) -> dict:
        f = getattr(sim, "forest", None)
        if f is None:
            return {"n_blocks": None, "blocks_per_level": None,
                    "refines": None, "coarsens": None}
        if self._lvl_cache[0] != f.version:
            order = getattr(sim, "_order", None)
            if order is None:
                order = f.order()
            lv, cnt = np.unique(f.level[order], return_counts=True)
            hist = {str(int(l)): int(c) for l, c in zip(lv, cnt)}
            self._lvl_cache = (f.version, hist, int(len(order)))
        nr = getattr(sim, "_n_refined", 0)
        nc = getattr(sim, "_n_coarsened", 0)
        ref_d = nr - self._last_regrid[0]
        coa_d = nc - self._last_regrid[1]
        self._last_regrid = (nr, nc)
        return {"n_blocks": self._lvl_cache[2],
                "blocks_per_level": self._lvl_cache[1],
                "refines": ref_d, "coarsens": coa_d}

    @staticmethod
    def _comm_fields(sim) -> dict:
        """The halo bytes of one hot-loop vector exchange on a mesh
        (``ShardedAMRSim._comm_stats``: real and on the wire), null
        without one (``cup2d_tpu/profiling.py:676-681``)."""
        st = getattr(sim, "_comm_stats", None)
        if not st:
            return {"halo_real_bytes": None, "halo_padded_bytes": None}
        return {"halo_real_bytes": int(st["halo_real_bytes"]),
                "halo_padded_bytes": int(st["halo_padded_bytes"])}

    def _counter_fields(self, sim) -> dict:
        if self.counters is None:
            return {"jit_compiles": None, "device_gets": None,
                    "state_gathers": None, "hbm_peak_bytes": None}
        cur = self.counters.snapshot()
        last = self._last_counters or {k: 0 for k in cur}
        self._last_counters = cur
        return {
            "jit_compiles": cur["jit_compiles"] - last["jit_compiles"],
            "device_gets": cur["device_gets"] - last["device_gets"],
            "state_gathers": cur["state_gathers"] - last["state_gathers"],
            "hbm_peak_bytes": hbm_peak_bytes(_device_of(sim)),
        }

    def _guard_fields(self) -> dict:
        """Supervision telemetry, host state on the guard: the live
        snapshot ring's device bytes, the replayed-step delta, the elastic
        group (epoch, cumulative re-mesh count, this record's re-mesh ms)
        and the mirror group (held mirror bytes while mirroring, this
        record's capture ms, the last elastic rung)."""
        if self.guard is None:
            return {"snap_ring_bytes": None, "replayed_steps": None,
                    "topology_epoch": None, "remesh_count": None,
                    "remesh_ms": None, "mirror_bytes": None,
                    "mirror_ms": None, "restore_source": None}
        g = self.guard
        cur = int(g.replayed_steps)
        delta = cur - self._last_replayed
        self._last_replayed = cur
        ms_delta = g.remesh_ms_total - self._last_remesh_ms
        self._last_remesh_ms = g.remesh_ms_total
        mir_delta = g.mirror_ms_total - self._last_mirror_ms
        self._last_mirror_ms = g.mirror_ms_total
        return {"snap_ring_bytes": int(g.ring_nbytes()),
                "replayed_steps": delta,
                "topology_epoch": int(g.topology_epoch),
                "remesh_count": int(g.remesh_count),
                "remesh_ms": (round(ms_delta, 3)
                              if ms_delta > 0 else None),
                "mirror_bytes": (int(g.mirror_nbytes())
                                 if g.mirror_hosts is not None else None),
                "mirror_ms": (round(mir_delta, 3)
                              if mir_delta > 0 else None),
                "restore_source": g.restore_source}

    def _flight_fields(self) -> dict:
        """The flight recorder's gauges (``cup2d_tpu/profiling.py:
        738-749``): cumulative spans, build ms and allocator peak."""
        f = self.flight
        if f is None:
            return {"span_count": None, "compile_ms_total": None,
                    "hbm_exec_bytes": None}
        hbm = f.hbm_exec_bytes()
        return {"span_count": int(f.span_count),
                "compile_ms_total": round(f.compile_ms_total, 3),
                "hbm_exec_bytes": int(hbm) if hbm else None}

    def _phase_fields(self) -> Optional[dict]:
        if self.timers is None:
            return None
        cur = dict(self.timers.acc)
        out = {k: round(1e3 * (v - self._last_phase.get(k, 0.0)), 3)
               for k, v in cur.items()
               if v - self._last_phase.get(k, 0.0) > 0.0}
        self._last_phase = cur
        return out


# ---------------------------------------------------------------------------
# the stream's readers
# ---------------------------------------------------------------------------

class ClientStreams:
    """Per-client JSONL telemetry (schema v7): one append-only stream a
    serving client id under ``dirpath``, written by the recorder's
    per-client split, so a session's rows survive slot reuse.
    ``rotate_mb`` caps each file: crossing it renames the stream to
    ``<name>.jsonl.N`` and reopens it, as ``EventLog`` does."""

    def __init__(self, dirpath: str, rotate_mb: Optional[float] = None):
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self._files: dict = {}
        self.rotate_bytes = (int(rotate_mb * 2 ** 20)
                             if rotate_mb else None)
        self._seq: dict = {}

    @staticmethod
    def _fname(cid) -> str:
        # a flat file name from the client id
        s = "".join(c if c.isalnum() or c in "-_." else "_"
                    for c in str(cid))
        return (s or "client").lstrip(".") + ".jsonl"

    def path_of(self, cid) -> str:
        return os.path.join(self.dir, self._fname(cid))

    def emit(self, cid, rec: dict) -> None:
        from .resilience import is_writer
        if not is_writer():
            # one writer under a world: the ranks' rows are the same
            return
        f = self._files.get(cid)
        if f is None:
            f = open(self.path_of(cid), "a")
            self._files[cid] = f
        f.write(json.dumps(rec, sort_keys=True, default=float) + "\n")
        f.flush()
        if self.rotate_bytes and f.tell() >= self.rotate_bytes:
            path = self.path_of(cid)
            f.close()
            seq = self._seq.get(cid, _next_segment_seq(path))
            os.replace(path, f"{path}.{seq}")
            self._seq[cid] = seq + 1
            self._files[cid] = open(path, "a")

    def close(self, cid=None) -> None:
        """Close one client's stream (retire, evict) or all of them."""
        files = ([self._files.pop(cid)] if cid in self._files
                 else list(self._files.values()) if cid is None else [])
        if cid is None:
            self._files.clear()
        for f in files:
            if not f.closed:
                f.close()


def summarize_client(records: list) -> dict:
    """One client stream's summary for ``post --metrics``: the session's
    extent, clock, dt and solver-health statistics."""
    recs = [r for r in records if r.get("event", "metrics") == "metrics"]

    def col(key):
        return [r[key] for r in recs if r.get(key) is not None]

    def stats(xs):
        if not xs:
            return None
        return {"mean": round(float(np.mean(xs)), 6),
                "max": round(float(np.max(xs)), 6)}

    return {
        "steps": len(recs),
        "t_first": recs[0]["t"] if recs else None,
        "t_final": recs[-1]["t"] if recs else None,
        "dt": stats(col("dt")),
        "umax_max": (max(col("umax")) if col("umax") else None),
        "energy_last": (col("energy")[-1] if col("energy") else None),
        "poisson_iters": stats(col("poisson_iters")),
        "poisson_residual_max": (max(col("poisson_residual"))
                                 if col("poisson_residual") else None),
        "div_linf_max": (max(col("div_linf"))
                         if col("div_linf") else None),
        "finite_all": (all(col("finite")) if col("finite") else None),
    }


def _next_segment_seq(path: str) -> int:
    """1 + the highest existing numeric rotation suffix of ``path``."""
    import glob
    top = 0
    for p in glob.glob(path + ".*"):
        suf = p[len(path) + 1:]
        if suf.isdigit():
            top = max(top, int(suf))
    return top + 1


def _segment_paths(path: str) -> list:
    """Rotated segments of ``path`` in write order (``path.1`` oldest),
    then the live file itself."""
    import glob
    segs = []
    for p in glob.glob(path + ".*"):
        suf = p[len(path) + 1:]
        if suf.isdigit():
            segs.append((int(suf), p))
    return [p for _, p in sorted(segs)] + [path]


def load_metrics(path: str) -> list:
    """All JSONL records from ``path`` and its rotated segments, in write
    order. Torn lines are skipped (``load_metrics_report`` counts them)."""
    return load_metrics_report(path)[0]


def load_metrics_report(path: str) -> tuple:
    """(records, truncated_records) from ``path`` plus rotated segments.
    A killed run's torn last line is counted, not raised; a missing path
    raises ``FileNotFoundError`` unless rotated segments exist."""
    out: list = []
    torn = 0
    paths = [p for p in _segment_paths(path) if os.path.exists(p)]
    if not paths:
        open(path).close()     # surface the original FileNotFoundError
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    torn += 1
    return out, torn


def summarize_metrics(records: list) -> dict:
    """Aggregate a metrics stream (record dicts, from ``load_metrics`` or
    a recorder) into the summary ``post --metrics`` prints: the JAX
    package's summary, key for key."""
    recs = [r for r in records if r.get("event", "metrics") == "metrics"]

    def col(key):
        return [r[key] for r in recs if r.get(key) is not None]

    def stats(xs):
        if not xs:
            return None
        return {"mean": round(float(np.mean(xs)), 6),
                "max": round(float(np.max(xs)), 6)}

    def last(key):
        xs = col(key)
        return xs[-1] if xs else None

    def total(key):
        xs = col(key)
        return sum(xs) if xs else None

    def peak(key):
        xs = col(key)
        return max(xs) if xs else None

    energy = col("energy")
    out = {
        "schema": METRICS_SCHEMA_VERSION,
        "steps": len(recs),
        "t_first": recs[0]["t"] if recs else None,
        "t_final": recs[-1]["t"] if recs else None,
        "dt": stats(col("dt")),
        "wall_ms": stats(col("wall_ms")),
        "poisson_iters": stats(col("poisson_iters")),
        "poisson_residual_max": peak("poisson_residual"),
        "poisson_modes": (sorted({str(m) for m in col("poisson_mode")})
                          or None),
        "smoother_tiers": (sorted({str(m)
                                   for m in col("smoother_tier")})
                           or None),
        "precond_cycles": stats(col("precond_cycles")),
        "energy_first": energy[0] if energy else None,
        "energy_last": energy[-1] if energy else None,
        "div_linf_max": peak("div_linf"),
        "jit_compiles_total": total("jit_compiles"),
        "device_gets_per_step": stats(col("device_gets")),
        "hbm_peak_bytes": peak("hbm_peak_bytes"),
        "n_blocks_last": last("n_blocks"),
        "refines_total": total("refines"),
        "coarsens_total": total("coarsens"),
        "state_gathers_total": total("state_gathers"),
        "snap_ring_bytes": peak("snap_ring_bytes"),
        "replayed_steps_total": total("replayed_steps"),
        "topology_epoch": last("topology_epoch"),
        "remesh_count": last("remesh_count"),
        "mirror_bytes": peak("mirror_bytes"),
        "mirror_ms_total": (round(sum(col("mirror_ms")), 3)
                            if col("mirror_ms") else None),
        "restore_source": last("restore_source"),
        "fleet_members": last("fleet_members"),
        "member_steps_per_s": stats(col("member_steps_per_s")),
        "active_members": stats(col("active_members")),
        "occupancy": stats(col("occupancy")),
        "admitted_total": last("admitted"),
        "evicted_total": last("evicted"),
        "queue_depth": stats(col("queue_depth")),
        "span_count": last("span_count"),
        "compile_ms_total": last("compile_ms_total"),
        "hbm_exec_bytes": last("hbm_exec_bytes"),
    }
    # run-report rows (one each at exit, where a run writes them)
    for ev in ("serving_latency", "compile_ledger"):
        rows = [r for r in records if r.get("event") == ev]
        if rows:
            out[ev] = {k: v for k, v in rows[-1].items()
                       if k != "event"}
    return out
