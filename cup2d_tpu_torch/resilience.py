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

The port's solvers read their flags on the host, so a step's iteration
count is a host int when the step returns, lagged or not: the production
two-level trigger of the forest sees it at the next dispatch in both
modes, and the JAX guard's trigger-freshness drain and ``_last_iters_dev``
have nothing to settle here. The guard opens no tracing spans (the span
recorder is ROADMAP queue 1 item 9). Not ported: the mirror tier and the
elastic topology guard (item 8).
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
    """Wraps ``sim.step_once`` with the verdict and the recovery ladder,
    the JAX package's ``StepGuard`` without its mirror tier.

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
    ``mirror_hosts``/``mirror_every``: the host-redundant mirror tier,
    ROADMAP queue 1 item 8; anything but off raises."""

    def __init__(self, sim, *, ring: int = 1, ckpt_dir: Optional[str] = None,
                 postmortem_dir: Optional[str] = None,
                 event_log: Optional[EventLog] = None,
                 faults=None, recover: bool = True, watchdog=None,
                 snap_every: int = 1, lag: bool = True,
                 mirror_hosts: Optional[int] = None,
                 mirror_every: int = 1):
        if (mirror_hosts and int(mirror_hosts) >= 2) \
                or int(mirror_every) != 1:
            raise NotImplementedError(
                f"StepGuard(mirror_hosts={mirror_hosts}, mirror_every="
                f"{mirror_every}): the host-redundant mirror tier is not "
                "ported yet (ROADMAP queue 1 item 8)")
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
        self._pendings: list = []
        self._replay: list = []   # (dt, exact, trig) good steps since anchor
        self._since_snap = 0
        self._last_fired = ()     # fault entries the last _attempt consumed
        if self.lag and hasattr(sim, "async_diag"):
            sim.async_diag = True

    # -- snapshots (device-resident, io.py) ----------------------------
    def _snapshot(self):
        from .io import snapshot_state_device
        return snapshot_state_device(self.sim)

    def ring_nbytes(self) -> int:
        """Device bytes of every live snapshot (anchors + pending)."""
        from .io import snapshot_nbytes
        n = sum(snapshot_nbytes(s) for s in self.ring)
        return n + sum(snapshot_nbytes(p.snap) for p in self._pendings
                       if p.snap is not None)

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
        import torch.distributed as dist
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        me = torch.tensor([int(self.triggered)], dtype=torch.int32,
                          device=dev)
        flags = [torch.empty_like(me) for _ in range(dist.get_world_size())]
        dist.all_gather(flags, me)
        return bool(torch.cat(flags).min().item() > 0)

    def uninstall(self) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
