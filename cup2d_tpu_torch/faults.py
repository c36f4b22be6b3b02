"""Fault injection for the supervised run loop, the counterpart of
``cup2d_tpu.faults``: the controlled failures that exercise every rung of
``resilience.StepGuard``, from tests (a :class:`FaultPlan` built directly)
and from the CLI (``CUP2D_FAULTS``, latched once by
:meth:`FaultPlan.from_env`).

Spec syntax, comma-separated directives ``name[@STEP][*COUNT]``, parsed as
the JAX package parses them (a typo raises instead of arming nothing)::

    nan_vel@N[*K]         poison one velocity cell with NaN before (up to
                          K) attempts of step N
    inf_vel@N[*K]         the same with +Inf
    scale_vel@N[*K]       scale the whole velocity x10 before step N: every
                          value stays finite, so only the physics watchdog
                          (resilience.PhysicsWatchdog) catches it
    poisson_giveup@N[*K]  report step N's pressure solve as failed
    sigterm@N             SIGTERM this process after step N completes
    crash_in_save         raise :class:`InjectedCrash` between the
                          checkpoint park and install renames
                          (io.save_checkpoint's crash window)
    host_exit@N           a host leaves the run at step N's boundary
                          (graceful). On a simulated topology
                          (resilience.TopologyGuard with sim_hosts=H) the
                          highest-index alive simulated host is marked
                          dead; under a torch.distributed world the
                          directive belongs to the process it is armed on,
                          as sigterm@N does: that rank announces its exit
                          in its last heartbeat and then exits hard
                          (os._exit, writing nothing)
    host_hang@N           a host stops beating without an announcement: a
                          simulated host misses beats; a real rank blocks
                          for good after its beat at step N, so the
                          survivors' next bounded heartbeat misses its
                          deadline
    shard_loss@N          the loss declared at step N's boundary takes its
                          shard slices with it: the live state, every held
                          snapshot and the mirror slices the dead host held
                          are zeroed before recovery (io.destroy_shards),
                          so a resumed run provably came from the
                          survivors' mirror copies or from disk
    mirror_corrupt@N      negate one element of every host block of every
                          held mirror at step N's dispatch
                          (io.corrupt_mirror), its stored checksums left as
                          they were, so the mirror rung rejects it
                          (mirror_reject event) and falls to the disk rung

The host-loss and shard-loss tokens are consumed by the TopologyGuard at
a step boundary, mirror_corrupt by the StepGuard at dispatch; without an
elastic guard or a mirror they never fire.

``*K`` repeats the fault for K consecutive attempts of that step, which is
how a drill climbs the ladder: ``*1`` recovers at the retry rung, ``*2``
at the exact-Poisson escalation, ``*3`` at the disk restore, ``*4`` (or
``*3`` with no checkpoint on disk) aborts.

The velocity faults write a new tensor (``_set_ordered`` on the forest, a
new ``FlowState`` on the uniform drivers), never into a tensor that a
device snapshot might share. On a fleet (``fleet.FleetSim``, velocity
[B, 2, Ny, Nx]) they hit member 0 only, the per-member recovery drill; the
fleet guard reports ``poisson_giveup`` on member 0 too.
"""

from __future__ import annotations

import contextlib
import os
import signal
from typing import Optional


class InjectedCrash(RuntimeError):
    """Raised at an armed crash point (stands in for a hard kill)."""


class FaultPlan:
    """Parsed, consumable fault schedule. Each directive is consumed as it
    fires (a decrementing count), so a recovered retry does not re-fault
    unless the spec asked for it with ``*K``."""

    _POISON = {"nan_vel": float("nan"), "inf_vel": float("inf")}
    _SCALE = 10.0      # scale_vel factor (x100 in energy)

    def __init__(self, spec: str = ""):
        self.vel_poison: dict[int, list] = {}   # step -> [value, count]
        self.vel_scale: dict[int, list] = {}    # step -> [factor, count]
        self.giveup: dict[int, int] = {}        # step -> count
        self.sigterm_steps: set[int] = set()
        self.crash_points: dict[str, int] = {}  # name -> count
        self.host_loss: dict[int, list] = {}    # step -> ["exit"|"hang"]
        self.shard_loss: dict[int, int] = {}    # step -> count
        self.mirror_corrupt: dict[int, int] = {}  # step -> count
        # a guard replay re-runs steps already verdicted good: no armed
        # fault may fire into it (StepGuard wraps the replay in suspend())
        self._suspended = 0
        for tok in (spec or "").split(","):
            tok = tok.strip()
            if not tok:
                continue
            count = 1
            if "*" in tok:
                tok, c = tok.split("*", 1)
                count = int(c)
            if "@" in tok:
                name, s = tok.split("@", 1)
                step: Optional[int] = int(s)
            else:
                name, step = tok, None
            if name in self._POISON:
                if step is None:
                    raise ValueError(f"{name} needs @STEP")
                self.vel_poison[step] = [self._POISON[name], count]
            elif name == "scale_vel":
                if step is None:
                    raise ValueError("scale_vel needs @STEP")
                self.vel_scale[step] = [self._SCALE, count]
            elif name == "poisson_giveup":
                if step is None:
                    raise ValueError("poisson_giveup needs @STEP")
                self.giveup[step] = count
            elif name == "sigterm":
                if step is None:
                    raise ValueError("sigterm needs @STEP")
                self.sigterm_steps.add(step)
            elif name == "crash_in_save":
                self.crash_points["checkpoint_install"] = count
            elif name in ("host_exit", "host_hang"):
                if step is None:
                    raise ValueError(f"{name} needs @STEP")
                self.host_loss.setdefault(step, []).append(
                    name.split("_", 1)[1])
            elif name == "shard_loss":
                if step is None:
                    raise ValueError("shard_loss needs @STEP")
                self.shard_loss[step] = count
            elif name == "mirror_corrupt":
                if step is None:
                    raise ValueError("mirror_corrupt needs @STEP")
                self.mirror_corrupt[step] = count
            else:
                raise ValueError(
                    f"unknown fault directive {name!r} "
                    "(expected nan_vel|inf_vel|scale_vel|poisson_giveup|"
                    "sigterm|crash_in_save|host_exit|host_hang|"
                    "shard_loss|mirror_corrupt)")

    @classmethod
    def from_env(cls) -> "FaultPlan":
        """Latch CUP2D_FAULTS once."""
        return cls(os.environ.get("CUP2D_FAULTS", ""))

    def __bool__(self) -> bool:
        return bool(self.vel_poison or self.vel_scale or self.giveup
                    or self.sigterm_steps or self.crash_points
                    or self.host_loss or self.shard_loss
                    or self.mirror_corrupt)

    @contextlib.contextmanager
    def suspend(self):
        """No fault fires inside (the guard's replay)."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    def apply_pre_step(self, sim, step: Optional[int] = None) -> list:
        """Poison or scale the velocity before an attempt of step
        ``step`` (default ``sim.step_count``). Returns the consumed
        [value, count] entries, so the guard can refund a dispatch it
        later discards (under the lagged verdict a step dispatched on top
        of a bad one is thrown away, and its fault must fire again at the
        real re-dispatch)."""
        if self._suspended:
            return []
        if step is None:
            step = sim.step_count
        fired = []
        ent = self.vel_poison.get(step)
        if ent and ent[1] > 0:
            ent[1] -= 1
            poison_velocity(sim, ent[0])
            fired.append(ent)
        ent = self.vel_scale.get(step)
        if ent and ent[1] > 0:
            ent[1] -= 1
            scale_velocity(sim, ent[0])
            fired.append(ent)
        return fired

    def poisson_giveup_at(self, step: int) -> bool:
        """Consume one forced give-up of ``step`` if armed."""
        if self._suspended:
            return False
        c = self.giveup.get(step, 0)
        if c <= 0:
            return False
        self.giveup[step] = c - 1
        return True

    def fire_post_step(self, step: int) -> None:
        """Post-step faults: SIGTERM delivery (preemption)."""
        if self._suspended:
            return
        if step in self.sigterm_steps:
            self.sigterm_steps.discard(step)
            os.kill(os.getpid(), signal.SIGTERM)

    def host_loss_at(self, step: int) -> list:
        """Consume the host-loss directives armed for ``step`` ('exit' /
        'hang'), the TopologyGuard's lookup at each boundary; none fire
        during a replay (a replay must not lose a host twice)."""
        if self._suspended:
            return []
        return self.host_loss.pop(step, [])

    def shard_loss_at(self, step: int) -> bool:
        """Consume one shard-destruction count of ``step`` if armed: the
        loss declared at this boundary takes its shards with it."""
        if self._suspended:
            return False
        c = self.shard_loss.get(step, 0)
        if c <= 0:
            return False
        self.shard_loss[step] = c - 1
        return True

    def mirror_corrupt_at(self, step: int) -> bool:
        """Consume one mirror corruption of ``step`` if armed (the
        StepGuard's lookup at each dispatch)."""
        if self._suspended:
            return False
        c = self.mirror_corrupt.get(step, 0)
        if c <= 0:
            return False
        self.mirror_corrupt[step] = c - 1
        return True

    def fire_crash_point(self, name: str) -> None:
        c = self.crash_points.get(name, 0)
        if c > 0:
            self.crash_points[name] = c - 1
            raise InjectedCrash(name)


def poison_velocity(sim, value: float) -> None:
    """Write ``value`` into one velocity cell of a real block or cell,
    through each driver's write path: the ordered working state on the
    forest, a new ``FlowState`` on the uniform drivers."""
    if hasattr(sim, "forest"):
        vel = sim._ordered_state()["vel"].clone()
        vel[0, 0, 0, 0] = value
        sim._set_ordered(vel=vel)
    elif hasattr(sim, "members"):
        # a fleet: member 0 only, through its slot write path (whatever
        # the fleet's placement)
        from .io import whole
        st = sim.member_state(0)
        vel = whole(st.vel).clone()
        vel[0, 0, 0] = value
        sim.set_member_state(0, st._replace(vel=vel))
    else:
        vel = sim.state.vel.clone()
        vel[0, 0, 0] = value
        sim.state = sim.state._replace(vel=vel)


def scale_velocity(sim, factor: float) -> None:
    """Multiply the whole velocity by ``factor``: every value stays
    finite (the corruption the isfinite verdict cannot see); member 0's
    only on a fleet."""
    if hasattr(sim, "forest"):
        sim._set_ordered(vel=sim._ordered_state()["vel"] * factor)
    elif hasattr(sim, "members"):
        st = sim.member_state(0)
        sim.set_member_state(0, st._replace(vel=st.vel * factor))
    else:
        sim.state = sim.state._replace(vel=sim.state.vel * factor)


# -- process-wide plan (the CLI arms it; io's crash window asks) --------
_ACTIVE: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> None:
    global _ACTIVE
    _ACTIVE = plan


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def crash_point(name: str) -> None:
    """No-op unless a plan armed this crash point (``io.save_checkpoint``
    calls it between the checkpoint park and install renames)."""
    if _ACTIVE is not None:
        _ACTIVE.fire_crash_point(name)
