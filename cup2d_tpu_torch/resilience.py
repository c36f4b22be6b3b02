"""Verdict-only supervision, the part of ``cup2d_tpu.resilience`` the run
driver's eager loop needs.

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
- ``StepGuard``: each step, the verdict, then the watchdog; a bad step is
  the abort rung: a post-mortem checkpoint, the force log closed, one
  ``recovery`` event with action ``abort``, then ``ResilienceAbort``.
- ``PreemptionGuard``: SIGTERM latches a flag the loop polls at step
  boundaries; single process, so ``agree()`` is the local flag.

Not ported (ROADMAP queue 1 item 5): the recovery ladder (rewind/replay,
retry, escalate, disk restore), the device snapshot ring, the lagged
verdict and fault injection; ``StepGuard`` refuses every argument that
asks for them. The elastic topology guard waits for item 8.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

_ITEM5 = ("the StepGuard recovery ladder, the snapshot ring, the lagged "
          "verdict and fault injection are not ported yet (ROADMAP queue "
          "1 item 5)")


# ---------------------------------------------------------------------------
# JSONL event log
# ---------------------------------------------------------------------------

class EventLog:
    """Append-only JSONL log (one object per line, flushed per event so a
    dying process keeps its tail). ``rotate_mb`` caps the file: crossing
    the cap renames it to the next numbered segment ``<path>.N`` and
    reopens it fresh; ``profiling.load_metrics`` reads the segments back
    in write order."""

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
    """The named diag entries as host scalars. The drivers' diagnostics
    are host values already; tensors still in it cost ONE ``pull``."""
    vals = {k: diag[k] for k in keys if k in diag}
    dev = [k for k, v in vals.items() if torch.is_tensor(v)]
    if dev:
        from .shapes_host import pull
        vals.update(zip(dev, (v.item() for v in
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
# the verdict-only stepper
# ---------------------------------------------------------------------------

class ResilienceAbort(RuntimeError):
    """A step failed its verdict and nothing recovers it; the post-mortem
    checkpoint (if configured) was written before raising."""


class StepGuard:
    """Wraps ``sim.step_once`` with the verdict, the watchdog and the
    abort rung: the JAX package's ``StepGuard(recover=False, lag=False)``.

    ``ckpt_dir`` is the run's checkpoint (kept for the disk rung of item
    5; unused here), ``postmortem_dir`` where the abort rung writes its
    checkpoint, ``event_log`` the JSONL sink, ``watchdog`` a
    ``PhysicsWatchdog`` (None skips it). ``recover``, ``lag``, ``ring``,
    ``snap_every``, ``faults`` and the mirror tier keep the JAX
    signature and defaults and raise unless off: the ladder, the lagged
    verdict and the snapshot ring wait for item 5."""

    def __init__(self, sim, *, ring: int = 1, ckpt_dir: Optional[str] = None,
                 postmortem_dir: Optional[str] = None,
                 event_log: Optional[EventLog] = None,
                 faults=None, recover: bool = True, watchdog=None,
                 snap_every: int = 1, lag: bool = True,
                 mirror_hosts: Optional[int] = None,
                 mirror_every: int = 1):
        asked = [name for name, on in (
            ("recover=True", recover), ("lag=True", lag),
            (f"ring={ring}", int(ring) != 1),
            (f"snap_every={snap_every}", int(snap_every) != 1),
            ("faults", faults is not None),
            ("mirror_hosts", bool(mirror_hosts)),
            (f"mirror_every={mirror_every}", int(mirror_every) != 1))
            if on]
        if asked:
            raise NotImplementedError(
                f"StepGuard({', '.join(asked)}): {_ITEM5}; pass "
                "recover=False, lag=False")
        self.sim = sim
        self.ckpt_dir = ckpt_dir
        self.postmortem_dir = postmortem_dir
        self.event_log = event_log
        self.watchdog = watchdog
        self.recover = False
        self.lag = False
        # steps a recovery replayed: 0 until item 5 brings the ladder
        self.replayed_steps = 0

    @property
    def pending(self) -> bool:
        """Always False: the verdict is eager."""
        return False

    def drain(self) -> list:
        """Nothing is ever in flight: ``[]``."""
        return []

    def ring_nbytes(self) -> int:
        """The guard holds no snapshot: 0 bytes."""
        return 0

    def step(self, dt: Optional[float] = None) -> dict:
        """One step, its verdict and the watchdog; returns the step's
        record (host scalars + ``step``/``t``/``dt`` and the dispatch-time
        ``poisson_mode``/``kernel_tier``), or raises ``ResilienceAbort``
        after the abort rung."""
        sim = self.sim
        if getattr(sim, "shapes", None) \
                and not getattr(sim, "_initialized", False):
            sim.initialize()
        step0, t0 = sim.step_count, sim.time
        mode = getattr(sim, "poisson_mode", None)
        tier = getattr(sim, "kernel_tier", None)
        diag = sim.step_once(dt=dt)
        vals = _host_scalars(diag, _PULL_KEYS)
        dtv = vals.get("dt")
        dt_used = float(dtv) if dtv is not None else sim.time - t0
        v = self._verdict_from(vals)
        if not v.ok:
            self._abort(step0, v, vals, dt_used)
        if self.watchdog is not None:
            self.watchdog.observe(vals)
        rec = {**diag, **vals, "step": step0 + 1, "t": sim.time,
               "dt": dt_used}
        if mode is not None:
            rec["poisson_mode"] = mode
        if tier is not None:
            rec["kernel_tier"] = tier
        return rec

    def _verdict_from(self, vals: dict) -> StepVerdict:
        tol = float(getattr(self.sim.cfg, "poisson_tol", 0.0))
        v = health_verdict(vals,
                           residual_ok=(100.0 * tol if tol > 0 else None))
        if v.ok and self.watchdog is not None:
            reason = self.watchdog.check(vals)
            if reason is not None:
                v = StepVerdict(False, reason)
        return v

    def _emit(self, event: str = "recovery", **fields) -> None:
        if self.event_log is not None:
            self.event_log.emit(event=event,
                                sim_time=float(self.sim.time), **fields)

    def _abort(self, step: int, v: StepVerdict, vals: dict,
               dt_used: float) -> None:
        """The abort rung: post-mortem checkpoint of the dead state, force
        log closed, one event, then raise."""
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
            f"step {step}: {v.reason}; no recovery (verdict-only guard)"
            + (f" (post-mortem checkpoint: {pm})" if pm else ""))


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
        """The stop decision at a step boundary: one process, so the local
        flag (the JAX package's cross-process agreement waits for item
        8)."""
        return self.triggered

    def uninstall(self) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
