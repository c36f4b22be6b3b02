"""Supervised stepping, the counterpart of ``cup2d_tpu.resilience``.

- ``EventLog``: append-only JSONL (events and the metrics stream), flushed
  per line, with size-capped rotation; ``set_event_log``/``record_event``
  register the process-wide sink (io's checkpoint fallback, the trace
  window).
- ``health_verdict``: a step is bad when the fused isfinite reduction
  failed, the Poisson residual is nonfinite, or the solve exited neither
  converged nor stalled with a residual above ``residual_ok`` (the guard
  passes 100 x the case's ``poisson_tol``).
- ``PhysicsWatchdog``: windowed drift bounds on umax, kinetic energy and
  max |div u|, which catch wrong-but-finite corruption.
- ``StepGuard``: a ring of device snapshots (``io.snapshot_state_device``:
  clones on the device, no host read) and, on a bad verdict, the bounded
  recovery ladder: rewind to the newest snapshot, replay the recorded good
  steps since it bit for bit (``snap_every`` cadence) and retry the failed
  step at dt/2; rewind again and retry with the exact Poisson solve;
  restore the checkpoint on disk; abort with a post-mortem checkpoint.
  Each rung emits one ``recovery`` event (step, verdict, action, rung,
  replayed). The verdict lags one step on the obstacle-free drivers
  (``async_diag``: ``UniformSim`` and the obstacle-free ``Simulation``
  and ``AMRSim``): step N's diagnostics and dt stay on the device, step
  N+1 is dispatched, then N's are read in one pull and N's clock is
  settled. The shaped drivers read their diagnostics at dispatch (the
  host kinematics need them) and verdict eagerly. Faults
  (``faults.FaultPlan``) fire through the guard's hooks and are suspended
  during a replay.
- ``FleetStepGuard``: the verdict of a ``fleet.FleetSim`` per member,
  eager, from the fleet step's one stacked read, with per-member watchdog
  clones; a bad member alone restores its slice of the ring, replays
  solo and walks retry, escalate, then abort or, in a serving pool,
  eviction (no disk rung: a disk restore would rewind the healthy
  members).
- ``PreemptionGuard``: SIGTERM latches a flag the loop polls at step
  boundaries; ``agree()`` is the local flag in one process and, under a
  ``torch.distributed`` world, the minimum of every rank's flag (one
  all-gather), so every rank stops at the same step boundary.
- Under a world (``parallel.launch``) the ``EventLog`` writes from rank 0
  only: the decisions it records are the same on every rank.

A loss that changes the topology (a host, or a rank of a world, dropping
out of a split run) is the elastic half:

- ``TopologyGuard``: detection and agreement. A device of the guard is one
  shard slot of a ``SlabMesh``; a host is a contiguous group of slots
  (``sim_hosts=H``, simulated in one process, the losses injected by
  ``faults`` ``host_exit@N`` / ``host_hang@N``) or, under a world, the rank
  owning them. The heartbeat ``[sigterm, epoch, exiting]`` rides the one
  all-gather ``PreemptionGuard.agree`` makes at each step boundary, under
  ``bounded_call``'s deadline, so a dead peer shows as a missed deadline
  (``Beat.hung``) instead of a hang. A host missing ``miss_k`` beats, or
  announcing its exit in its last one, is declared lost; every survivor
  computes the same survivors and epoch from the same evidence, and emits
  one ``topology_lost`` event.
- ``StepGuard.elastic_recover``: the survivors become a new mesh (after
  ``parallel.launch.reinit_distributed`` under a world), the sim is
  re-meshed in place (``remesh``) and resumes down the ladder ring (the
  newest snapshot, where the survivors still own it), mirror (the lost
  hosts' blocks from their ring neighbours' copies, checksummed:
  ``mirror_hosts``), disk, abort; one ``remesh`` event (and a
  ``mirror_reject`` for a corrupt mirror).

The port's solvers read their flags on the host, so a step's iteration
count is a host int when the step returns, lagged or not: the production
two-level trigger of the forest sees it at the next dispatch in both
modes, and the JAX guard's trigger-freshness drain and ``_last_iters_dev``
have nothing to settle here. The guard opens no tracing spans (the span
recorder is ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import sys
import time
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import tracing

# ---------------------------------------------------------------------------
# the distributed world
# ---------------------------------------------------------------------------

def dist_initialized() -> bool:
    """A ``torch.distributed`` world is up in this process (torch answers
    in every version, so the JAX package's fallback latch,
    ``note_distributed_initialized``, has no counterpart)."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def is_writer() -> bool:
    """This process writes the run's shared files: always without a world,
    rank 0 under one."""
    if not dist_initialized():
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


# ---------------------------------------------------------------------------
# JSONL event log
# ---------------------------------------------------------------------------

class EventLog:
    """Append-only JSONL log (one object per line, flushed per event so a
    dying process keeps its tail). ``rotate_mb`` caps the file: crossing
    the cap renames it to the next numbered segment ``<path>.N`` and
    reopens it fresh; ``profiling.load_metrics`` reads the segments back
    in write order. Once a world is up only rank 0 writes (the ranks'
    decisions are the same, so N copies would only interleave); events
    before it formed (a connect retry) come from every process."""

    # recovery-critical events are fsynced at emit
    _DURABLE_EVENTS = frozenset({
        "topology_lost", "remesh", "member_abort", "member_aborted",
        "mirror_reject",
    })

    def __init__(self, path: str, rotate_mb=None):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.rotate_bytes = (int(rotate_mb * 2 ** 20) if rotate_mb
                             else None)
        self._seq = None
        self._f = open(path, "a")

    def emit(self, **fields) -> None:
        if not is_writer():
            return
        fields.setdefault("wall", time.time())
        self._f.write(json.dumps(fields, sort_keys=True,
                                 default=float) + "\n")
        self._f.flush()
        if fields.get("event") in self._DURABLE_EVENTS:
            try:
                os.fsync(self._f.fileno())
            except OSError:
                pass    # non-seekable sink (pipe/pty): flush is all it has
        if self.rotate_bytes and self._f.tell() >= self.rotate_bytes:
            self._rotate()

    def _rotate(self) -> None:
        self._f.close()
        if self._seq is None:
            from .profiling import _next_segment_seq
            self._seq = _next_segment_seq(self.path)
        os.replace(self.path, f"{self.path}.{self._seq}")
        self._seq += 1
        self._f = open(self.path, "a")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


_EVENT_LOG: Optional[EventLog] = None


def set_event_log(log: Optional[EventLog]) -> None:
    """Register the process-wide event sink."""
    global _EVENT_LOG
    _EVENT_LOG = log


def record_event(**fields) -> None:
    """Emit into the registered event log; dropped when none is active."""
    if _EVENT_LOG is not None:
        _EVENT_LOG.emit(**fields)


# ---------------------------------------------------------------------------
# per-step health verdict
# ---------------------------------------------------------------------------

class StepVerdict(NamedTuple):
    ok: bool
    reason: str           # "ok" | "nonfinite" | "poisson_nonfinite"
    #                     | "poisson_exhausted" | "invariant_umax"
    #                     | "invariant_energy" | "invariant_divergence"


_HEALTH_KEYS = ("finite", "umax", "poisson_converged", "poisson_stalled",
                "poisson_residual")
_INVARIANT_KEYS = ("energy", "div_linf")
# everything the verdict and the record read per step
_PULL_KEYS = _HEALTH_KEYS + _INVARIANT_KEYS + (
    "poisson_iters", "precond_cycles", "dt_next", "dt")


def _host_scalars(diag: dict, keys) -> dict:
    """The named diag entries as host values: scalars, or numpy rows for
    a fleet's [B] entries. The drivers' diagnostics are host values
    already; tensors still in it cost ONE ``pull``."""
    vals = {k: diag[k] for k in keys if k in diag}
    dev = [k for k, v in vals.items() if torch.is_tensor(v)]
    if dev:
        from .shapes_host import pull
        vals.update(zip(dev, (v.item() if v.ndim == 0 else v for v in
                              pull(*(vals[k] for k in dev)))))
    return vals


def health_verdict(diag: dict,
                   residual_ok: Optional[float] = None) -> StepVerdict:
    """Classify a step's diagnostics: BAD when (a) the fused isfinite
    reduction over vel/pres failed, (b) the Poisson residual is
    nonfinite, or (c) the solve exited neither converged nor stalled with
    a residual above ``residual_ok`` (None: every such exit). A stalled
    exit is not bad: it is the solver's precision floor."""
    vals = _host_scalars(diag, _HEALTH_KEYS)
    finite = vals.get("finite")
    if finite is None:
        finite = np.isfinite(float(vals.get("umax", 0.0)))
    if not bool(finite):
        return StepVerdict(False, "nonfinite")
    resid = vals.get("poisson_residual")
    if resid is not None and not np.isfinite(float(resid)):
        return StepVerdict(False, "poisson_nonfinite")
    conv = vals.get("poisson_converged")
    stall = vals.get("poisson_stalled")
    if conv is not None and not bool(conv) \
            and stall is not None and not bool(stall):
        rf = float(resid) if resid is not None else float("inf")
        if residual_ok is None or not (rf <= residual_ok):
            return StepVerdict(False, "poisson_exhausted")
    return StepVerdict(True, "ok")


# ---------------------------------------------------------------------------
# physics-invariant watchdog
# ---------------------------------------------------------------------------

class PhysicsWatchdog:
    """Windowed drift bounds on the fused physics invariants (umax,
    kinetic energy, max |div u|) every step's diag carries. Each invariant
    arms itself once its window is full and settled (window max/min <= its
    settle ratio); an unsettled signal (spin-up from rest) stays dormant.
    umax and energy are held two-sided within ``factor`` of the window's
    min/max, the divergence one-sided (``div_factor`` x the window max).
    Only steps with a good final verdict enter the window."""

    def __init__(self, window: int = 8,
                 umax_factor: float = 4.0, umax_settle: float = 2.0,
                 energy_factor: float = 4.0, energy_settle: float = 2.0,
                 div_factor: float = 50.0, div_settle: float = 4.0):
        self.window = int(window)
        self.umax_factor = float(umax_factor)
        self.umax_settle = float(umax_settle)
        self.energy_factor = float(energy_factor)
        self.energy_settle = float(energy_settle)
        self.div_factor = float(div_factor)
        self.div_settle = float(div_settle)
        self.umax: deque = deque(maxlen=self.window)
        self.energy: deque = deque(maxlen=self.window)
        self.div: deque = deque(maxlen=self.window)

    @classmethod
    def for_prec(cls, prec_mode: str, **kw) -> "PhysicsWatchdog":
        """Bands matched to the storage precision (``sim.prec_mode``): the
        bf16 tier's step-to-step jitter is ~2^-8, so its windows settle
        later and the divergence bound doubles; explicit ``**kw`` wins."""
        if prec_mode == "bf16":
            kw.setdefault("umax_settle", 2.5)
            kw.setdefault("energy_settle", 2.5)
            kw.setdefault("div_settle", 8.0)
            kw.setdefault("div_factor", 100.0)
        return cls(**kw)

    def _armed(self, hist: deque, settle: float):
        """(hi, lo) when the window is full and settled, else None."""
        if len(hist) < self.window:
            return None
        hi, lo = max(hist), min(hist)
        if lo <= 0.0 or hi > settle * lo:
            return None
        return hi, lo

    def check(self, vals: dict) -> Optional[str]:
        """Verdict reason for a drifted invariant, or None (``vals`` holds
        host scalars)."""
        u = vals.get("umax")
        band = self._armed(self.umax, self.umax_settle)
        if u is not None and band is not None:
            hi, lo = band
            if not (lo / self.umax_factor <= float(u)
                    <= self.umax_factor * hi):
                return "invariant_umax"
        e = vals.get("energy")
        band = self._armed(self.energy, self.energy_settle)
        if e is not None and band is not None:
            hi, lo = band
            if not (lo / self.energy_factor <= float(e)
                    <= self.energy_factor * hi):
                return "invariant_energy"
        d = vals.get("div_linf")
        band = self._armed(self.div, self.div_settle)
        if d is not None and band is not None:
            hi, _ = band
            if float(d) > self.div_factor * hi:
                return "invariant_divergence"
        return None

    def observe(self, vals: dict) -> None:
        """Fold a GOOD step's invariants into the window."""
        if vals.get("umax") is not None:
            self.umax.append(float(vals["umax"]))
        if vals.get("energy") is not None:
            self.energy.append(float(vals["energy"]))
        if vals.get("div_linf") is not None:
            self.div.append(float(vals["div_linf"]))

    def reset(self) -> None:
        """Drop the window."""
        self.umax.clear()
        self.energy.clear()
        self.div.clear()


# ---------------------------------------------------------------------------
# the supervised stepper
# ---------------------------------------------------------------------------

class ResilienceAbort(RuntimeError):
    """The recovery ladder is exhausted (or the guard verdicts only); the
    post-mortem checkpoint (if configured) was written before raising."""


class _Pending:
    """One dispatched step whose verdict is not in yet."""

    __slots__ = ("step0", "t0", "diag", "exact", "dt_host", "advanced",
                 "snap", "trig", "fired", "mode", "tier")

    def __init__(self, step0, t0, diag, exact, dt_host, advanced,
                 snap=None, trig=None, fired=(), mode=None, tier=None):
        self.step0 = step0
        self.t0 = t0
        self.diag = diag
        self.exact = exact
        self.dt_host = dt_host       # None on the lagged (device-dt) paths
        self.advanced = advanced     # the driver advanced sim.time itself
        self.snap = snap             # optimistic post-step device snapshot
        self.trig = trig             # (coarse_on, last_iters) at dispatch
        self.fired = fired           # fault entries this dispatch consumed
        self.mode = mode             # poisson_mode and kernel_tier at
        self.tier = tier             # dispatch: the path the step took


class StepGuard:
    """Wraps ``sim.step_once`` with the verdict and the recovery ladder.

    ``sim``: ``Simulation``, ``AMRSim`` or ``UniformSim``. ``ring``: the
    confirmed device snapshots kept (the ladder restores the newest; under
    the lag an unconfirmed post-step snapshot also waits in the pending
    slot). ``ckpt_dir``: the run's checkpoint, the disk rung (None or
    absent disables it). ``postmortem_dir``: where the abort rung writes.
    ``event_log``: the JSONL sink of ``recovery`` events. ``faults``: a
    ``faults.FaultPlan`` whose hooks the guard drives (suspended during a
    replay). ``recover=False``: verdict only, the first bad step aborts.
    ``watchdog``: a ``PhysicsWatchdog`` consulted after the health
    verdict. ``snap_every``: the snapshot cadence in good steps; between
    snapshots the (dt, exact, trigger) of each good step is recorded and a
    rewind replays them to the failed step. ``lag``: the one-step-lagged
    verdict on the drivers that have ``async_diag``; the obstacle-free
    steps then keep their diagnostics on the device and the guard reads
    step N's after dispatching N+1 (the shaped steps verdict eagerly).
    ``mirror_hosts``: the host ring of the host-redundant mirror tier
    (None or < 2: off, and the guard dispatches and reads exactly as
    without it). Each snapshot of a split uniform run then also ships each
    host's block to its ring neighbour with on-device checksums
    (``io.mirror_snapshot``: copies on the device, no read), and
    ``elastic_recover`` gains the mirror rung; a forest's payload latches
    the tier off. ``mirror_every``: mirror every Nth snapshot only; a loss
    at an anchor without a mirror falls to the disk rung."""

    def __init__(self, sim, *, ring: int = 1, ckpt_dir: Optional[str] = None,
                 postmortem_dir: Optional[str] = None,
                 event_log: Optional[EventLog] = None,
                 faults=None, recover: bool = True, watchdog=None,
                 snap_every: int = 1, lag: bool = True,
                 mirror_hosts: Optional[int] = None,
                 mirror_every: int = 1):
        self.sim = sim
        self.ring: deque = deque(maxlen=max(1, int(ring)))
        self.ckpt_dir = ckpt_dir
        self.postmortem_dir = postmortem_dir
        self.event_log = event_log
        self.faults = faults
        self.recover = recover
        self.watchdog = watchdog
        self.snap_every = max(1, int(snap_every))
        self.lag = bool(lag)
        self.recoveries = 0       # completed recovery actions (telemetry)
        self.replayed_steps = 0   # cumulative replayed steps (telemetry)
        # the elastic group, advanced by elastic_recover alone
        self.topology_epoch = 0
        self.remesh_count = 0
        self.remesh_ms_total = 0.0
        # the mirror tier; None keeps every mirror path dormant
        self.mirror_hosts = (int(mirror_hosts)
                             if mirror_hosts and int(mirror_hosts) >= 2
                             else None)
        self.mirror_every = max(1, int(mirror_every))
        self.mirror_ms_total = 0.0   # host ms spent enqueueing captures
        self.restore_source = None   # the last elastic rung: ring|mirror|disk
        self._mirror_tick = 0
        self._pendings: list = []
        self._replay: list = []   # (dt, exact, trig) good steps since anchor
        self._since_snap = 0
        self._last_fired = ()     # fault entries the last _attempt consumed
        if self.lag and hasattr(sim, "async_diag"):
            sim.async_diag = True

    # -- snapshots (device-resident, io.py) ----------------------------
    def _snapshot(self):
        from .io import mirror_snapshot, snapshot_state_device
        snap = snapshot_state_device(self.sim)
        mesh = getattr(self.sim, "mesh", None)
        if self.mirror_hosts is not None and mesh is not None:
            self._mirror_tick += 1
            if self._mirror_tick >= self.mirror_every:
                t0 = time.perf_counter()
                m = mirror_snapshot(snap, mesh, self.mirror_hosts)
                if m is None:
                    # a payload the tier does not cover (the forest's):
                    # latch it off rather than probe every capture
                    self.mirror_hosts = None
                else:
                    snap = snap._replace(mirror=m)
                    self._mirror_tick = 0
                # the enqueue's cost; the copies run on the device behind
                # the step
                self.mirror_ms_total += (time.perf_counter() - t0) * 1e3
        return snap

    def ring_nbytes(self) -> int:
        """Device bytes of every live snapshot (anchors + pending)."""
        from .io import snapshot_nbytes
        n = sum(snapshot_nbytes(s) for s in self.ring)
        return n + sum(snapshot_nbytes(p.snap) for p in self._pendings
                       if p.snap is not None)

    def mirror_nbytes(self) -> int:
        """Device bytes of the held mirror payloads (anchors + pending)."""
        from .io import mirror_nbytes
        n = sum(mirror_nbytes(s) for s in self.ring)
        return n + sum(mirror_nbytes(p.snap) for p in self._pendings
                       if p.snap is not None)

    def _held_mirror_snaps(self) -> list:
        """Every held snapshot that carries a mirror, newest first (the
        ``mirror_corrupt`` drill's targets)."""
        out = [p.snap for p in reversed(self._pendings)
               if p.snap is not None and p.snap.mirror is not None]
        out += [s for s in reversed(self.ring) if s.mirror is not None]
        return out

    @property
    def pending(self) -> bool:
        """True while a dispatched step awaits its lagged verdict."""
        return bool(self._pendings)

    def _disk_available(self) -> bool:
        return bool(self.ckpt_dir) and (
            os.path.exists(os.path.join(self.ckpt_dir, "meta.json"))
            or os.path.exists(os.path.join(
                self.ckpt_dir.rstrip("/") + ".old", "meta.json")))

    # -- one supervised step -------------------------------------------
    def step(self, dt: Optional[float] = None) -> Optional[dict]:
        """Dispatch one step; return the newest verdicted step's record
        (host scalars + ``step``/``t``/``dt`` and the dispatch-time
        ``poisson_mode``/``kernel_tier``), or None while the first lagged
        dispatch is still in flight."""
        self._seed()
        out = None
        self._dispatch(dt)
        while self._pendings:
            if self.lag and len(self._pendings) == 1 \
                    and _on_device(self._pendings[-1].diag):
                break   # leave the newest device-diag step in flight
            out = self._resolve_oldest()
        return out

    def drain(self) -> list:
        """Resolve every pending verdict (at loop exit and before dumps,
        checkpoints and regrids); recovery runs as usual. Returns the
        records in step order."""
        out = []
        while self._pendings:
            out.append(self._resolve_oldest())
        return out

    def _seed(self) -> None:
        sim = self.sim
        if self.ring:
            if hasattr(sim, "forest") and \
                    self.ring[-1].meta.get("forest_version") \
                    != sim.forest.version:
                # a regrid between guarded steps: replay cannot reproduce
                # it, so the ring never spans one. Settle the verdicts in
                # flight against the old anchor, then re-anchor.
                self.drain()
                self._reanchor()
            return
        # the lazy chi blend first: a snapshot of the unblended state
        # restores as initialized, and a rewind after a failed first step
        # would skip the blend
        if getattr(sim, "shapes", None) \
                and not getattr(sim, "_initialized", False):
            sim.initialize()
        self._reanchor()   # the state before the first step is good

    def _reanchor(self) -> None:
        self.ring.append(self._snapshot())
        self._replay.clear()
        self._since_snap = 0

    def _trigger_state(self):
        """The two-level-trigger inputs the next dispatch consults,
        recorded per step so a replay takes the branch the original
        step took."""
        sim = self.sim
        if hasattr(sim, "_coarse_on"):
            return (bool(sim._coarse_on), int(sim._last_iters))
        return None

    def _dispatch(self, dt) -> None:
        sim = self.sim
        step0, t0 = sim.step_count, sim.time
        trig = self._trigger_state()
        diag = self._attempt(dt, exact=False)
        pend = _Pending(
            step0=step0, t0=t0, diag=diag,
            exact=bool(step0 < 10 or getattr(sim, "_force_exact", False)),
            dt_host=(sim.time - t0 if sim.time != t0 else None),
            advanced=(sim.time != t0), trig=trig,
            fired=self._last_fired,
            mode=getattr(sim, "poisson_mode", None),
            tier=getattr(sim, "kernel_tier", None))
        # optimistic cadence snapshot of the post-step state; if this
        # step's lagged verdict comes back bad it is dropped and the
        # rewind target stays the previous confirmed anchor
        self._since_snap += 1
        if self._since_snap >= self.snap_every:
            pend.snap = self._snapshot()
            self._since_snap = 0
        self._pendings.append(pend)
        # mirror_corrupt@N spoils every held mirror at step N's dispatch,
        # whichever anchor the next loss lands on (suspended in a replay,
        # keyed on the pre-step count like apply_pre_step)
        if self.faults is not None \
                and getattr(self.faults, "mirror_corrupt", None) \
                and self.faults.mirror_corrupt_at(step0):
            from .io import corrupt_mirror
            for snap in self._held_mirror_snaps():
                corrupt_mirror(snap)

    def _resolve_oldest(self) -> dict:
        pend = self._pendings.pop(0)
        # the step's one read (host values already on the eager paths)
        vals = _host_scalars(pend.diag, _PULL_KEYS)
        v = self._verdict_from(vals, pend.step0)
        if v.ok:
            return self._commit(pend, vals)
        return self._recover(pend, vals, v)

    @staticmethod
    def _dt_of(pend: _Pending, vals: dict) -> float:
        # the dt the driver used, from the diag: a difference of clocks
        # rounds differently by an ulp, and the replay must be exact
        dtv = vals.get("dt")
        if dtv is not None:
            return float(dtv)
        return pend.dt_host if pend.dt_host is not None else float("nan")

    def _commit(self, pend: _Pending, vals: dict) -> dict:
        sim = self.sim
        dt_used = self._dt_of(pend, vals)
        if not pend.advanced:
            # lagged path: the driver left the clock to the verdict, and
            # commits run in step order
            sim.time = sim.time + dt_used
        if self.watchdog is not None:
            self.watchdog.observe(vals)
        if pend.snap is not None:
            # promote to the confirmed anchor, its lagged clock settled
            pend.snap.meta["time"] = sim.time
            self.ring.append(pend.snap)
            self._replay.clear()
        else:
            self._replay.append((dt_used, pend.exact, pend.trig))
        if self.faults is not None:
            self.faults.fire_post_step(pend.step0 + 1)
        # host scalars replace the device originals: a metrics consumer
        # must not read the device a second time
        rec = {**pend.diag, **vals, "step": pend.step0 + 1,
               "t": sim.time, "dt": dt_used}
        if pend.mode is not None:
            rec["poisson_mode"] = pend.mode
        if pend.tier is not None:
            rec["kernel_tier"] = pend.tier
        return rec

    def _verdict_from(self, vals: dict, step: int) -> StepVerdict:
        tol = float(getattr(self.sim.cfg, "poisson_tol", 0.0))
        v = health_verdict(vals,
                           residual_ok=(100.0 * tol if tol > 0 else None))
        if v.ok and self.watchdog is not None:
            reason = self.watchdog.check(vals)
            if reason is not None:
                v = StepVerdict(False, reason)
        if v.ok and self.faults is not None \
                and self.faults.poisson_giveup_at(step):
            v = StepVerdict(False, "poisson_giveup(injected)")
        return v

    def _discard_pendings(self) -> None:
        """Drop every dispatch in flight (and its optimistic snapshot) and
        refund the fault counts each one consumed, so a fault armed for a
        discarded step fires at its real re-dispatch."""
        for p in self._pendings:
            for ent in p.fired:
                ent[1] += 1
        self._pendings.clear()

    # -- the recovery ladder -------------------------------------------
    def _recover(self, pend: _Pending, vals: dict,
                 v: StepVerdict) -> dict:
        sim = self.sim
        # a step dispatched on top of the bad one is garbage (the bad
        # step's own fault genuinely fired and is not refunded)
        self._discard_pendings()
        step0 = pend.step0
        dt_used = self._dt_of(pend, vals)
        rung = 0
        retry_dt: Optional[float] = None
        while True:
            action = self._next_action(rung)
            if action == "abort":
                self._abort(step0, v, vals, dt_used)
            replayed = 0
            if action in ("retry", "escalate"):
                replayed = self._rewind_replay()
                if pend.trig is not None:
                    # the retry consults the trigger with the inputs the
                    # failed step's dispatch saw
                    sim._coarse_on, sim._last_iters = pend.trig
                if action == "retry":
                    # half the failed dt; a nonfinite one (a fault at a
                    # cold cache) falls back to a fresh CFL dt
                    retry_dt = (0.5 * dt_used
                                if np.isfinite(dt_used) and dt_used > 0
                                else None)
            else:   # disk_restore: rewind possibly many steps
                from .io import load_checkpoint
                load_checkpoint(self.ckpt_dir, sim)
                self.ring.clear()
                self._reanchor()
                if self.watchdog is not None:
                    # the window describes steps past the restored point
                    self.watchdog.reset()
                retry_dt = None
            self._emit(step=step0, verdict=v.reason, action=action,
                       dt=dt_used, rung=rung, replayed=replayed)
            self.recoveries += 1
            # the retry verdicts at once: recovery is the cold path
            t0, s0 = sim.time, sim.step_count
            exact_retry = action == "escalate"
            trig = self._trigger_state()
            diag = self._attempt(retry_dt, exact=exact_retry)
            advanced = sim.time != t0
            vals = _host_scalars(diag, _PULL_KEYS)
            v2 = self._verdict_from(vals, s0)
            p2 = _Pending(
                step0=s0, t0=t0, diag=diag,
                exact=bool(s0 < 10 or exact_retry),
                dt_host=(sim.time - t0 if advanced else None),
                advanced=advanced, trig=trig)
            if v2.ok:
                # recovered: a fresh anchor, so the replay list restarts
                # from a clean base
                p2.snap = self._snapshot()
                self._since_snap = 0
                return self._commit(p2, vals)
            v = v2
            dt_used = self._dt_of(p2, vals)
            rung += 1

    def _rewind_replay(self) -> int:
        """Restore the newest anchor, then replay the recorded good steps
        to the failed one bit for bit: the same dts, exact-solve and
        trigger branches, faults suspended, no verdict reads."""
        from .io import restore_snapshot_device
        restore_snapshot_device(self.sim, self.ring[-1])
        return self._replay_recorded()

    def _replay_recorded(self) -> int:
        sim = self.sim
        n = len(self._replay)
        if not n:
            return 0
        ctx = (self.faults.suspend() if self.faults is not None
               else contextlib.nullcontext())
        # the replayed steps were force-logged when they first ran
        cfe = getattr(sim, "compute_forces_every", None)
        if cfe is not None:
            sim.compute_forces_every = 0
        try:
            with ctx:
                for rdt, rexact, rtrig in self._replay:
                    t0 = sim.time
                    if rtrig is not None:
                        sim._coarse_on, sim._last_iters = rtrig
                    if rexact:
                        sim._force_exact = True
                    try:
                        sim.step_once(dt=rdt)
                    finally:
                        if rexact:
                            sim._force_exact = False
                    if sim.time == t0:
                        # lagged driver: settle the clock from the
                        # recorded dt (the float the original commit read)
                        sim.time = t0 + rdt
        finally:
            if cfe is not None:
                sim.compute_forces_every = cfe
        self.replayed_steps += n
        return n

    def _attempt(self, dt, exact: bool = False) -> dict:
        sim = self.sim
        self._last_fired = (self.faults.apply_pre_step(sim)
                            if self.faults is not None else ())
        if exact:
            sim._force_exact = True
        try:
            return sim.step_once(dt=dt)
        finally:
            if exact:
                sim._force_exact = False

    def _next_action(self, rung: int) -> str:
        if not self.recover:
            return "abort"
        if rung == 0:
            return "retry"
        if rung == 1:
            return "escalate"
        if rung == 2 and self._disk_available():
            return "disk_restore"
        return "abort"

    def _emit(self, event: str = "recovery", **fields) -> None:
        if self.event_log is not None:
            self.event_log.emit(event=event,
                                sim_time=float(self.sim.time), **fields)

    def _abort(self, step: int, v: StepVerdict, vals: dict,
               dt_used: float) -> None:
        """The last rung: a post-mortem checkpoint of the dead state, the
        force log closed, one event, then raise. A dead run leaves enough
        on disk to be diagnosed and, where the fault was environmental,
        resumed."""
        sim = self.sim
        pm = None
        if self.postmortem_dir:
            try:
                from .io import save_checkpoint
                save_checkpoint(self.postmortem_dir, sim)
                pm = self.postmortem_dir
            except Exception as e:   # the abort must not be masked
                print(f"cup2d_tpu_torch: post-mortem checkpoint failed: "
                      f"{e}", file=sys.stderr)
        flog = getattr(sim, "force_log", None)
        if flog is not None and not flog.closed:
            flog.close()
        summary = {k: _as_float(vals[k])
                   for k in ("umax", "poisson_residual", "poisson_iters")
                   if k in vals}
        self._emit(step=step, verdict=v.reason, action="abort",
                   dt=dt_used, postmortem=pm, diag=summary)
        raise ResilienceAbort(
            f"step {step}: {v.reason}; recovery ladder exhausted"
            + (f" (post-mortem checkpoint: {pm})" if pm else ""))


    # -- elastic topology recovery -------------------------------------
    def elastic_recover(self, topo: "TopologyGuard") -> None:
        """Re-mesh the survivors and resume in place after ``topo``
        declared a loss (``cup2d_tpu/resilience.py:1140-1297``), no
        process relaunch:

        1. every dispatch in flight was issued on the lost topology: it is
           dropped and its fault counts refunded, as the ladder does (even
           a good one, so the resume point is a confirmed anchor);
        2. the survivors become a new mesh (``topo.survivor_mesh``: their
           slots on one process; under a world one over the world that
           ``parallel.launch.reinit_distributed`` formed from them), and
           ``sim.remesh`` rebuilds the split step over it (the forest's SFC
           partition re-splits by construction);
        3. the state comes down the ladder: **ring**, the newest anchor
           where the survivors still own every shard (``snapshot_covers``
           without the mirror; a ``shard_loss`` drill voids it), installed
           on the new mesh (``restore_snapshot_resharded``) and the
           recorded steps since replayed; **mirror**, the anchor's mirror
           where every lost host's ring neighbour lives, checked
           (``verify_mirror``: a bad sum emits one ``mirror_reject`` event
           and falls through), the lost blocks rebuilt from it
           (``restore_snapshot_mirrored``) and replayed likewise; **disk**,
           the last checkpoint, the watchdog's window reset; **abort**.

        Then the ring is re-anchored on the new mesh, the mirror tier
        resized to the surviving hosts (off below two), and one ``remesh``
        event emitted (epoch, source, devices, step, replayed, ms)."""
        sim = self.sim
        t0 = time.perf_counter()
        # no fence: torch runs a device's launches in the order they were
        # enqueued, and a copy between cards is ordered after the source
        # card's work, so the recovery's reads and copies follow the
        # dropped dispatches on every stream without waiting on them here;
        # no collective of the lost world is issued from here on
        self._discard_pendings()
        from .io import (destroy_shards, load_checkpoint,
                         restore_snapshot_mirrored,
                         restore_snapshot_resharded, snapshot_covers,
                         verify_mirror)
        # the simulated real loss: zero what the dead hosts held before a
        # rung is chosen, so a resume provably came from the survivors
        destroyed = tuple(topo.destroyed_hosts())
        lost_hosts = tuple(topo.lost_host_indices())
        if destroyed:
            wiped = destroy_shards(sim, list(self.ring), destroyed,
                                   topo.n_hosts)
            self.ring.clear()
            self.ring.extend(wiped)
        anchor = self.ring[-1] if self.ring else None
        lost_p = topo.lost_process_indices()
        dead = tuple(sorted(set(lost_hosts) | set(lost_p)))
        use_ring = anchor is not None and not destroyed \
            and snapshot_covers(anchor, lost_p, mirror=False)
        use_mirror = False
        if not use_ring and anchor is not None and snapshot_covers(
                anchor, lost_p, lost_hosts=lost_hosts,
                shards_destroyed=bool(destroyed)):
            bad = verify_mirror(anchor, dead)
            if bad:
                # never install a torn or corrupt mirror
                if self.event_log is not None:
                    self.event_log.emit(
                        event="mirror_reject", step=int(sim.step_count),
                        n_rejects=len(bad), rejects=bad[:8])
            else:
                use_mirror = True
        if not use_ring and not use_mirror and not self._disk_available():
            self._abort(sim.step_count, StepVerdict(False, "topology_lost"),
                        {}, float("nan"))
        mesh = topo.survivor_mesh()
        sim.remesh(mesh)
        replayed = 0
        if use_ring:
            restore_snapshot_resharded(sim, anchor)
            replayed = self._replay_recorded()
            source = "ring"
        elif use_mirror:
            restore_snapshot_mirrored(sim, anchor, dead)
            replayed = self._replay_recorded()
            source = "mirror"
        else:
            load_checkpoint(self.ckpt_dir, sim)
            if self.watchdog is not None:
                # the window describes steps past the restored point
                self.watchdog.reset()
            source = "disk"
        self.restore_source = source
        if self.mirror_hosts is not None:
            alive = topo.alive_host_count()
            self.mirror_hosts = alive if alive >= 2 else None
        self.ring.clear()
        self._reanchor()
        self.topology_epoch = int(topo.epoch)
        self.remesh_count += 1
        ms = 1e3 * (time.perf_counter() - t0)
        self.remesh_ms_total += ms
        self.recoveries += 1
        if self.event_log is not None:
            self.event_log.emit(
                event="remesh", epoch=int(topo.epoch), source=source,
                devices=int(mesh.size), step=int(sim.step_count),
                sim_time=float(sim.time), replayed=replayed,
                ms=round(ms, 3))


# ---------------------------------------------------------------------------
# per-member supervision of a fleet
# ---------------------------------------------------------------------------

class FleetStepGuard(StepGuard):
    """Per-member verdicts and recovery for ``fleet.FleetSim``, the JAX
    package's ``FleetStepGuard``.

    The fleet step's one stacked read carries [B] diagnostics; each member
    is classified by ``health_verdict`` and by its own ``PhysicsWatchdog``
    (``watchdog=`` is a prototype, copied once a member). Recovery is per
    member: a bad member restores only its slice of the newest snapshot
    (``FleetSim.set_member_state``), replays its recorded dts solo
    (``member_step_once``, faults suspended, exact-solve branches kept),
    retries the failed step at dt/2 and then with the exact solve; the
    healthy members commit their step and never rewind. No disk rung: it
    would rewind every member. The verdict is eager (``lag`` is forced
    off): under the lag a step stacked on a bad one would be garbage in
    one member only, and discarding it would rewind the healthy ones.

    Injected ``poisson_giveup`` faults flag member 0, the member the
    velocity faults hit on a fleet. Serving (``on_member_abort``, wired by
    ``fleet.FleetServer``): an exhausted ladder evicts the one member (a
    ``member_aborted`` event, the callback frees the slot) instead of
    raising ``ResilienceAbort``. Slots the server masked inactive are
    neither classified nor watched."""

    def __init__(self, sim, *, watchdog=None, on_member_abort=None, **kw):
        kw["lag"] = False     # eager by design, see the docstring
        super().__init__(sim, watchdog=None, **kw)
        import copy
        self._watchdog_proto = watchdog
        self.member_watchdogs = (
            [copy.deepcopy(watchdog) for _ in range(sim.members)]
            if watchdog is not None else None)
        self.on_member_abort = on_member_abort
        self.evictions = 0

    def _member_active(self, m: int) -> bool:
        act = getattr(self.sim, "active_mask", None)
        return True if act is None else bool(act[m])

    def reset_member_watchdog(self, m: int) -> None:
        """A fresh watchdog clone for slot ``m`` (admission: the slot's
        history was the previous occupant's)."""
        if self.member_watchdogs is not None:
            import copy
            self.member_watchdogs[m] = copy.deepcopy(self._watchdog_proto)

    def reanchor(self) -> None:
        """A fresh anchor and a clean replay base (the server's, after an
        admission batch, so a rewind never restores a slot's previous
        contents; the eager verdict leaves no step in flight)."""
        self._reanchor()

    # -- the per-member verdict ------------------------------------------
    def _resolve_oldest(self) -> dict:
        pend = self._pendings.pop(0)
        with tracing.span("verdict", step=int(pend.step0)):
            vals = _host_scalars(pend.diag, _PULL_KEYS)   # [B] rows
            verdicts = self._member_verdicts(vals, pend.step0)
            bad = [m for m, v in enumerate(verdicts) if not v.ok]
        if not bad:
            return self._commit(pend, vals)
        return self._recover_members(pend, vals, verdicts, bad)

    def _one_member_verdict(self, m: int, mv: dict,
                            step: int) -> StepVerdict:
        """The one per-member policy, of the fleet step's rows and of the
        solo retry alike: health, the member's watchdog, then the
        injected give-up of member 0."""
        tol = float(getattr(self.sim.cfg, "poisson_tol", 0.0))
        v = health_verdict(mv,
                           residual_ok=(100.0 * tol if tol > 0 else None))
        if v.ok and self.member_watchdogs is not None:
            reason = self.member_watchdogs[m].check(mv)
            if reason is not None:
                v = StepVerdict(False, reason)
        if v.ok and m == 0 and self.faults is not None \
                and self.faults.poisson_giveup_at(step):
            v = StepVerdict(False, "poisson_giveup(injected)")
        return v

    def _member_verdicts(self, vals: dict, step: int) -> list:
        return [
            self._one_member_verdict(
                m, {k: v[m] for k, v in vals.items() if np.ndim(v) >= 1},
                step)
            if self._member_active(m)
            # a parked slot's lane is select-frozen identity
            else StepVerdict(True, "inactive")
            for m in range(self.sim.members)]

    def _commit(self, pend: _Pending, vals: dict) -> dict:
        sim = self.sim
        dts = np.asarray(vals["dt"], np.float64)
        if not pend.advanced:
            sim.times = sim.times + dts
            sim.time = sim._fleet_time()
        if self.member_watchdogs is not None:
            for m in range(sim.members):
                if self._member_active(m):
                    self.member_watchdogs[m].observe(
                        {k: v[m] for k, v in vals.items()})
        if pend.snap is not None:
            pend.snap.meta["time"] = sim.time
            pend.snap.meta["times"] = np.array(sim.times)
            self.ring.append(pend.snap)
            self._replay.clear()
        else:
            self._replay.append((dts, pend.exact, None))
        if self.faults is not None:
            self.faults.fire_post_step(pend.step0 + 1)
        rec = {**pend.diag, **vals, "step": pend.step0 + 1,
               "t": sim.time, "dt": dts}
        if pend.mode is not None:
            rec["poisson_mode"] = pend.mode
        if pend.tier is not None:
            rec["kernel_tier"] = pend.tier
        return rec

    # -- per-member recovery ---------------------------------------------
    def _recover_members(self, pend: _Pending, vals: dict,
                         verdicts: list, bad: list) -> dict:
        sim = self.sim
        self._discard_pendings()
        # the optimistic post-step snapshot holds the bad slices
        pend.snap = None
        vals = {k: np.array(v) for k, v in vals.items()}   # writable
        dts = np.asarray(vals["dt"], np.float64)
        if not pend.advanced:
            for m in range(sim.members):
                if verdicts[m].ok:
                    sim.times[m] += dts[m]
        # every member's chained dt from step N's read: the floats the
        # unfaulted run keeps on the device
        sim._next_dt = torch.as_tensor(np.asarray(vals["dt_next"]),
                                       dtype=sim.grid.dtype,
                                       device=sim.grid.device)
        anchor = self.ring[-1]
        for m in bad:
            mv = self._recover_member(m, anchor, pend.step0, vals,
                                      verdicts[m])
            # the record shows what m committed
            for k, val in mv.items():
                if k in vals and np.ndim(vals[k]) >= 1:
                    vals[k][m] = val
        if self.member_watchdogs is not None:
            for m in range(sim.members):
                if verdicts[m].ok and self._member_active(m):
                    self.member_watchdogs[m].observe(
                        {k: v[m] for k, v in vals.items()})
        sim.time = sim._fleet_time()
        # every member healthy again: a fresh anchor, a clean replay base
        self._reanchor()
        if self.faults is not None:
            self.faults.fire_post_step(pend.step0 + 1)
        return {**pend.diag, **vals, "step": pend.step0 + 1,
                "t": sim.time, "dt": np.asarray(vals["dt"])}

    def _recover_member(self, m: int, anchor, step0: int, vals: dict,
                        v: StepVerdict) -> dict:
        sim = self.sim
        dt_used = float(np.asarray(vals["dt"])[m])
        rung = 0
        with tracing.span("recover", step=int(step0), member=m,
                          verdict=v.reason):
            while True:
                if not self.recover or rung >= 2:
                    self._abort_member(m, step0, v, vals, dt_used)
                    # evicted (serving): an inert lane, so that the
                    # record's folds carry none of the dead member's NaNs
                    return {"dt": 0.0, "dt_next": 1.0, "finite": True,
                            "umax": 0.0, "energy": 0.0,
                            "div_linf": 0.0, "poisson_iters": 0,
                            "poisson_residual": 0.0,
                            "poisson_stalled": False,
                            "poisson_converged": True,
                            "precond_cycles": 0}
                action = "retry" if rung == 0 else "escalate"
                with tracing.span(action, step=int(step0), member=m,
                                  rung=rung):
                    replayed = self._rewind_member(m, anchor)
                    exact = rung == 1
                    retry_dt = (0.5 * dt_used
                                if rung == 0 and np.isfinite(dt_used)
                                and dt_used > 0 else None)
                    self._emit(step=step0, member=m, verdict=v.reason,
                               action=action, dt=dt_used, rung=rung,
                               replayed=replayed)
                    self.recoveries += 1
                    # a fresh attempt of step0: armed *K faults fire again
                    # (looked up by the retried step; the shared counter
                    # has moved past it)
                    self._last_fired = (
                        self.faults.apply_pre_step(sim, step=step0)
                        if self.faults is not None else ())
                    diag = sim.member_step_once(
                        m, dt=retry_dt, exact=(exact or step0 < 10))
                    mv = _host_scalars(diag, _PULL_KEYS)
                    v2 = self._one_member_verdict(m, mv, step0)
                    if v2.ok:
                        sim.times[m] += float(mv["dt"])
                        sim.time = float(sim.times.min())
                        sim.set_member_next_dt(m, mv["dt_next"])
                        if self.member_watchdogs is not None:
                            self.member_watchdogs[m].observe(mv)
                        return mv
                    v = v2
                    dt_used = float(mv["dt"])
                    rung += 1

    def _rewind_member(self, m: int, anchor) -> int:
        """Restore member ``m``'s slice of the anchor, then replay its
        recorded dts solo (faults suspended, no verdict reads) up to the
        failed step."""
        sim = self.sim
        sim.set_member_state(m, sim.member_state(m, anchor.payload))
        sim.times[m] = float(np.asarray(anchor.meta["times"])[m])
        n = 0
        ctx = (self.faults.suspend() if self.faults is not None
               else contextlib.nullcontext())
        with ctx:
            for rdts, rexact, _ in self._replay:
                rdt = float(np.asarray(rdts)[m])
                if rdt == 0.0:
                    # the member sat parked for this step (its lane was
                    # frozen identity): nothing to replay
                    continue
                sim.member_step_once(m, dt=rdt, exact=rexact)
                sim.times[m] += rdt
                n += 1
        self.replayed_steps += n
        return n

    def _abort_member(self, m: int, step: int, v: StepVerdict,
                      vals: dict, dt_used: float) -> None:
        sim = self.sim
        summary = {k: _as_float(np.asarray(vals[k])[m])
                   for k in ("umax", "poisson_residual", "poisson_iters")
                   if k in vals}
        if self.on_member_abort is not None:
            # serving: evict the one member; the callback zeroes and
            # masks its slot, and the dt cache drops its NaN lane
            self._emit(event="member_aborted", step=step, member=m,
                       verdict=v.reason, action="evict", dt=dt_used,
                       diag=summary)
            self.evictions += 1
            self.on_member_abort(m, v.reason, step)
            sim.set_member_next_dt(m, 1.0)
            return
        pm = None
        if self.postmortem_dir:
            try:
                from .io import save_checkpoint
                save_checkpoint(self.postmortem_dir, sim)
                pm = self.postmortem_dir
            except Exception as e:   # the abort must not be masked
                print(f"cup2d_tpu_torch: post-mortem checkpoint failed: "
                      f"{e}", file=sys.stderr)
        flog = getattr(sim, "force_log", None)
        if flog is not None and not flog.closed:
            flog.close()
        self._emit(step=step, member=m, verdict=v.reason,
                   action="abort", dt=dt_used, postmortem=pm,
                   diag=summary)
        raise ResilienceAbort(
            f"step {step}, member {m}: {v.reason}; per-member ladder "
            "exhausted"
            + (f" (post-mortem checkpoint: {pm})" if pm else ""))


def _on_device(diag: dict) -> bool:
    return any(torch.is_tensor(v) for v in diag.values())


def _as_float(x) -> float:
    try:
        return float(np.asarray(x))
    except Exception:
        return float("nan")


# ---------------------------------------------------------------------------
# preemption-safe shutdown
# ---------------------------------------------------------------------------

class PreemptionGuard:
    """Latches SIGTERM (and optionally other signals) into a flag the
    driver loop polls at step boundaries; the handler touches no device
    state."""

    def __init__(self):
        self.triggered = False
        self.signum: Optional[int] = None
        self._prev: dict = {}

    def install(self, signums=None) -> "PreemptionGuard":
        if signums is None:
            signums = (signal.SIGTERM,)

        def _handler(signum, frame):
            self.triggered = True
            self.signum = signum

        for s in signums:
            self._prev[s] = signal.signal(s, _handler)
        return self

    def agree(self) -> bool:
        """The stop decision at a step boundary. Without a world, the local
        flag. Under one, ranks preempted at different instants must not
        enter mismatched collectives (one stepping while another starts
        the collective checkpoint save hangs both): every rank gathers
        every rank's flag (one all-gather of one int) and the run stops
        once all of them are set, at the same boundary on every rank. A
        collective under a world: call it at the same loop point on every
        rank."""
        if not dist_initialized():
            return self.triggered
        flags = _gather_ints([int(self.triggered)], _beat_device())
        return bool(flags.min() > 0)

    def uninstall(self) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()


# ---------------------------------------------------------------------------
# elastic topology: detection and agreement (cup2d_tpu/resilience.py:
# 1719-1971)
# ---------------------------------------------------------------------------

def _beat_device() -> torch.device:
    """Where this rank's step-boundary all-gather runs: its card under
    NCCL, the CPU under gloo."""
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather_ints(vals, dev: torch.device) -> np.ndarray:
    """Every rank's ``vals`` ([world, len(vals)] int host array) by one
    all-gather on ``dev``. On a card the gather runs on a side stream of
    its own, set current in the calling thread (the card too: a thread
    starts on card 0): the process group then makes only that stream
    wait on the collective, so a gather blocked on a dead peer holds no
    stream of the step, and the read that waits for it waits on that
    stream alone."""
    import torch.distributed as dist
    ws = dist.get_world_size()
    if dev.type != "cuda":
        me = torch.tensor(vals, dtype=torch.int32, device=dev)
        out = [torch.empty_like(me) for _ in range(ws)]
        dist.all_gather(out, me)
        return torch.stack(out).numpy()
    torch.cuda.set_device(dev)
    side = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(side):
        me = torch.tensor(vals, dtype=torch.int32, device=dev)
        out = [torch.empty_like(me) for _ in range(ws)]
        dist.all_gather(out, me)
        return torch.stack(out).cpu().numpy()


def bounded_call(fn, timeout: float):
    """Run ``fn()`` with a deadline: ``(True, result)`` when it returns
    within ``timeout`` seconds, ``(False, None)`` when it is still blocked
    then (the heartbeat's hang watchdog: a collective blocked on a dead
    peer becomes evidence instead of a hang). The worker is a daemon
    thread: a blocked collective cannot be cancelled from here, only left
    to the world's abort (``parallel.launch.shutdown_distributed(abort=
    True)``, which ends an NCCL kernel waiting on the dead peer). An
    exception inside ``fn`` is raised here."""
    import threading
    box: dict = {}

    def _run():
        try:
            box["result"] = fn()
        except BaseException as e:   # surfaced to the caller below
            box["error"] = e

    th = threading.Thread(target=_run, daemon=True)
    th.start()
    th.join(timeout)
    if th.is_alive():
        return False, None
    if "error" in box:
        raise box["error"]
    return True, box.get("result")


class Beat(NamedTuple):
    """One step-boundary heartbeat (``TopologyGuard.step_boundary``)."""

    stop: bool          # the SIGTERM agreement (PreemptionGuard's)
    lost: tuple         # hosts declared lost at this beat (mostly empty)
    self_lost: bool     # under a world: this rank was told to exit
    hung: bool          # the bounded collective missed its deadline


class TopologyGuard:
    """The detection and agreement half of elastic recovery.

    ``devices``: the shard slots watched, a ``SlabMesh`` or a sequence of
    devices (a single-controller mesh's, repeats allowed, e.g.
    ``["cuda:0"] * 4``); default: one slot a rank under a world, else
    every visible card. Two modes share one protocol:

    - **simulated** (``sim_hosts=H``, one process): the slots grouped into H
      contiguous hosts. ``faults`` ``host_exit@N`` / ``host_hang@N`` mark
      the highest-index alive host dead at step N's boundary; each
      ``poll`` after is one missed beat, and ``miss_k`` misses declare it
      lost (``shard_loss@N`` at the same boundary takes its shards with
      it: ``destroyed_hosts``). Every slot stays addressable, so the ring
      and mirror rungs run end to end in one process.
    - **real** (a world of more than one rank, no ``sim_hosts``): a host is
      the rank owning its slots. The heartbeat ``[sigterm, epoch,
      exiting]`` rides the one all-gather of ``PreemptionGuard.agree``,
      under ``bounded_call`` with ``timeout``. A rank armed with
      ``host_exit@N`` announces its exit in that beat (after finishing its
      in-flight work, so the peers' matching collectives complete), and
      every survivor declares it in the same beat; a dead or hung peer
      shows as the deadline missed (``Beat.hung``), after which the old
      world's collectives are unusable. Resuming in place then needs the
      world re-formed (``parallel.launch.reinit_distributed``) before
      ``StepGuard.elastic_recover``.

    The decision is deterministic on the same evidence: the survivors are
    the alive hosts in their original order, and the epoch rises by one a
    declaration, each emitting one ``topology_lost`` event."""

    def __init__(self, devices=None, *, sim_hosts: Optional[int] = None,
                 miss_k: int = 3, timeout: float = 10.0,
                 faults=None, event_log=None):
        from .parallel.shard_halo import SlabMesh
        if devices is None:
            if dist_initialized():
                import torch.distributed as dist
                from .parallel.launch import _rank_device
                devices = SlabMesh.over_world(dist.get_world_size(),
                                              _rank_device(None))
            else:
                devices = [torch.device("cuda", i)
                           for i in range(torch.cuda.device_count())]
        if isinstance(devices, SlabMesh):
            self.devices = list(devices.devices)
            self._owners = tuple(devices.owners)
            self._world_mesh = devices.distributed
            self._home = devices.home
        else:
            self.devices = [torch.device(d) for d in devices]
            self._owners = (0,) * len(self.devices)
            self._world_mesh = False
            self._home = self.devices[0] if self.devices else None
        self.miss_k = max(1, int(miss_k))
        self.timeout = float(timeout)
        self.faults = faults
        self.event_log = event_log
        self.epoch = 0
        self.hung = False
        self._exiting = False
        self._lost_processes: set = set()
        if sim_hosts is not None:
            h = int(sim_hosts)
            if h < 2 or len(self.devices) % h:
                raise ValueError(
                    f"sim_hosts={h}: need >= 2 simulated hosts (losing "
                    "the only host leaves nothing to re-mesh onto) "
                    f"dividing the {len(self.devices)}-device set into "
                    "equal contiguous groups")
            self.sim_hosts = h
            self._n = h
        else:
            self.sim_hosts = None
            self._n = max(self._owners) + 1 if self._world_mesh else 1
        # the hosts of the current world's ranks, in rank order (the
        # survivors once the world is re-formed)
        self._ranks = list(range(self._n))
        self.alive = [True] * self._n
        self._dead: dict = {}      # host -> fault kind, not yet declared
        self._missed: dict = {}    # host -> consecutive missed beats
        self._destroyed: set = set()

    # -- topology bookkeeping -----------------------------------------
    @property
    def n_hosts(self) -> int:
        return self._n

    def _host_of(self, idx: int) -> int:
        """The host owning slot ``idx`` (contiguous groups)."""
        if self.sim_hosts is not None:
            return idx * self.sim_hosts // len(self.devices)
        return self._owners[idx]

    def survivor_devices(self) -> list:
        """The slots of the alive hosts, in their original (contiguous)
        order: the same on every survivor. Under a world a slot of
        another rank is None."""
        return [d for i, d in enumerate(self.devices)
                if self.alive[self._host_of(i)]]

    def survivor_mesh(self):
        """The mesh the survivors re-mesh onto: their slots on one
        process; over a world, as many shards over the current world
        (one re-formed from the survivors after a real loss)."""
        surv = self.survivor_devices()
        if not surv:
            raise ResilienceAbort("topology loss left no survivor "
                                  "devices — nothing to re-mesh onto")
        if not self._world_mesh:
            from .parallel.mesh import make_mesh
            return make_mesh(devices=surv)
        import torch.distributed as dist
        from .parallel.shard_halo import SlabMesh
        if not dist_initialized():
            raise RuntimeError("the survivors' mesh needs a world: form "
                               "it with parallel.launch.reinit_distributed")
        ws = dist.get_world_size()
        if self.sim_hosts is None and ws != self.alive_host_count():
            raise RuntimeError(
                f"the world has {ws} ranks for {self.alive_host_count()} "
                "surviving hosts: re-form it over the survivors first "
                "(parallel.launch.reinit_distributed)")
        if len(surv) % ws:
            raise ValueError(f"{len(surv)} surviving slots do not divide "
                             f"over {ws} ranks")
        return SlabMesh.over_world(len(surv), self._home)

    def lost_process_indices(self) -> tuple:
        """The ranks declared lost (real mode; simulated hosts lose no
        process), for ``io.snapshot_covers``."""
        return tuple(sorted(self._lost_processes))

    def lost_host_indices(self) -> tuple:
        """Ring indices of every declared-lost host, both modes."""
        return tuple(h for h in range(len(self.alive))
                     if not self.alive[h])

    def destroyed_hosts(self) -> tuple:
        """Declared-lost hosts whose shards died with them (``shard_loss``
        at the loss's boundary), for ``io.destroy_shards``."""
        return tuple(sorted(h for h in self._destroyed
                            if not self.alive[h]))

    def alive_host_count(self) -> int:
        return sum(1 for a in self.alive if a)

    # -- detection -----------------------------------------------------
    def poll(self, step: int) -> tuple:
        """One simulated heartbeat at the boundary of ``step``: consume a
        host-loss fault armed for it, count one missed beat per dead but
        undeclared host, and declare those at ``miss_k`` misses. Returns
        the hosts declared at this beat."""
        if self.faults is not None:
            for kind in self.faults.host_loss_at(step):
                h = self._highest_alive_undead()
                if h is not None:
                    self._dead[h] = kind
                    if self.faults.shard_loss_at(step):
                        self._destroyed.add(h)
        newly = []
        for h in self._dead:
            if not self.alive[h]:
                continue
            self._missed[h] = self._missed.get(h, 0) + 1
            if self._missed[h] >= self.miss_k:
                newly.append(h)
        if newly:
            self._declare(newly, step)
        return tuple(newly)

    def _highest_alive_undead(self):
        for h in range(self.n_hosts - 1, -1, -1):
            if self.alive[h] and h not in self._dead:
                return h
        return None

    def _declare(self, hosts, step) -> None:
        for h in hosts:
            self.alive[h] = False
            if self.sim_hosts is None:
                self._lost_processes.add(h)
        self.epoch += 1
        if self.event_log is not None:
            self.event_log.emit(
                event="topology_lost", epoch=self.epoch,
                hosts=[int(h) for h in hosts],
                kinds=[str(self._dead.get(h, "?")) for h in hosts],
                step=int(step), miss_k=self.miss_k,
                survivors=len(self.survivor_devices()))

    def step_boundary(self, stop: PreemptionGuard, step: int) -> Beat:
        """The step boundary's one call: the SIGTERM agreement and the
        heartbeat in the one all-gather the loop makes there (real mode),
        or the local flag and the simulated poll (one process)."""
        if self.sim_hosts is not None or not dist_initialized() \
                or self._n == 1:
            return Beat(stop=stop.agree(), lost=self.poll(step),
                        self_lost=False, hung=False)
        import torch.distributed as dist
        ws = dist.get_world_size()
        if ws != len(self._ranks):
            # the world was re-formed over the survivors, in rank order
            self._ranks = [h for h in range(self._n) if self.alive[h]]
            if len(self._ranks) != ws:
                raise RuntimeError(
                    f"heartbeat over a world of {ws} ranks for "
                    f"{len(self._ranks)} alive hosts")
        me = self._ranks[dist.get_rank()]
        self_kind = None
        if self.faults is not None:
            kinds = self.faults.host_loss_at(step)
            if kinds:
                self_kind = kinds[-1]
                if self_kind == "exit":
                    self._exiting = True
                    # finish what this rank has in flight first: the
                    # peers' collectives and messages of the steps
                    # already dispatched then complete without it
                    if torch.cuda.is_available():
                        torch.cuda.synchronize()
        payload = [1 if stop.triggered else 0, self.epoch,
                   1 if self._exiting else 0]
        dev = _beat_device()
        done, flags = bounded_call(lambda: _gather_ints(payload, dev),
                                   self.timeout)
        if not done:
            self.hung = True
            if self.event_log is not None:
                self.event_log.emit(event="topology_hang", step=int(step),
                                    timeout_s=self.timeout,
                                    epoch=self.epoch)
            return Beat(stop=False, lost=(), self_lost=False, hung=True)
        flags = np.asarray(flags).reshape(ws, 3)
        exiting = [self._ranks[p] for p in range(ws)
                   if flags[p, 2] and self.alive[self._ranks[p]]
                   and self._ranks[p] != me]
        if exiting:
            for h in exiting:
                self._dead[h] = "exit"
            self._declare(exiting, step)
        alive_rows = [p for p in range(ws) if self.alive[self._ranks[p]]]
        stop_agreed = bool(alive_rows) and bool(
            np.min(flags[alive_rows, 0]) > 0)
        if self_kind == "hang":
            # the hard-loss flavour: this rank stops beating and keeps its
            # process; the survivors' next beat misses its deadline
            while True:
                time.sleep(3600)
        return Beat(stop=stop_agreed, lost=tuple(exiting),
                    self_lost=(self_kind == "exit"), hung=False)
