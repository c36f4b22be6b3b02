"""Port parity for the disks of the shaped uniform step, f64 on the CPU:
the towed disk and the two-disk collision of
tests/test_collision_forces.py, and the catalog's channel (under
CUP2D_POIS=fas) and towed cylinder, each a live JAX ``Simulation`` and the
port's from the same start. Velocity, pressure, the shapes' host state and
the 19 force components <= 1e-10, equal iterations."""

import dataclasses
import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from cup2d_tpu import cases as jcases  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.models import DiskShape as JDisk  # noqa: E402
from cup2d_tpu.sim import Simulation as JSim  # noqa: E402
from cup2d_tpu_torch import Simulation, cases  # noqa: E402
from cup2d_tpu_torch.convert import config_from_dict  # noqa: E402
from cup2d_tpu_torch.models import DiskShape  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRAJ_BAR = 1e-10


def _cfg(**kw):
    """tests/test_collision_forces.py's configuration."""
    base = dict(bpdx=1, bpdy=1, level_max=1, level_start=0, extent=1.0,
                nu=1e-3, cfl=0.4, lam=1e6, dtype="float64",
                max_poisson_iterations=200)
    base.update(kw)
    return SimConfig(**base)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _err(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


def _lockstep(js, ts, steps):
    """Step both, holding them together after every step; returns the
    port's diagnostics."""
    out = []
    for _ in range(steps):
        jd = js.step_once()
        td = ts.step_once()
        assert td["poisson_iters"] == int(jd["poisson_iters"])
        assert abs(td["dt"] - jd["dt"]) <= 1e-15
        assert _err(js.state.vel, ts.state.vel) <= TRAJ_BAR
        assert _err(js.state.pres, ts.state.pres) <= TRAJ_BAR
        for a, b in zip(js.shapes, ts.shapes):
            for key in ("u", "v", "omega", "com", "center", "orientation",
                        "M", "J"):
                d = np.max(np.abs(np.subtract(getattr(a, key),
                                              getattr(b, key))))
                assert d <= TRAJ_BAR, key
            for key, v in a.forces.items():
                assert abs(b.forces[key] - v) <= TRAJ_BAR, key
        out.append(td)
    return out


def test_towed_disk_forces_and_log():
    """8 steps of the towed disk from rest (the exact startup solves:
    a rigid disk's RHS is mean-free, so they agree), with the force log
    and the reference test's bars on the port's forces."""
    cfg = _cfg()
    js = JSim(cfg, shapes=[JDisk(0.1, 0.35, 0.5, prescribed=(0.2, 0.0))],
              level=4)
    ts = Simulation(config_from_dict(dataclasses.asdict(cfg)),
                    shapes=[DiskShape(0.1, 0.35, 0.5, prescribed=(0.2, 0.0))],
                    level=4, device="cpu")
    jlog, tlog = io.StringIO(), io.StringIO()
    js.force_log, ts.force_log = jlog, tlog
    _lockstep(js, ts, 8)
    f = ts.shapes[0].forces
    assert abs(f["perimeter"] - 2 * np.pi * 0.1) < 0.02
    assert f["forcex"] < 0 and f["drag"] > 0
    assert abs(f["forcey"]) < 1e-8 and abs(f["torque"]) < 1e-8
    assert len(tlog.getvalue().splitlines()) == 8
    assert Simulation.force_log_header() == JSim.force_log_header()
    for a, b in zip(jlog.getvalue().splitlines(),
                    tlog.getvalue().splitlines()):
        ra, rb = a.split(","), b.split(",")
        assert ra[:2] == rb[:2]
        assert np.allclose([float(x) for x in ra[2:]],
                           [float(x) for x in rb[2:]], rtol=1e-7, atol=1e-12)


def test_two_disk_collision():
    """A towed disk overlapping a free one: the collision impulse sets the
    free disk moving; production solves from the first step. The overlap
    is a tie of the two chi (1 = 1), where the first disk wins the
    penalization target and the combined udef sums."""
    cfg = _cfg()
    disks = lambda cls: [cls(0.08, 0.30, 0.5, prescribed=(0.5, 0.0)),  # noqa
                         cls(0.08, 0.44, 0.5)]
    js = JSim(cfg, shapes=disks(JDisk), level=4)
    ts = Simulation(config_from_dict(dataclasses.asdict(cfg)),
                    shapes=disks(DiskShape), level=4, device="cpu")
    js.step_count = ts.step_count = 10
    js.initialize()
    ts.initialize()
    tie = (ts.state.chi == 1.0).sum()
    assert tie > 0
    _lockstep(js, ts, 5)
    assert ts.shapes[1].u > 0.1, ts.shapes[1].u     # kicked away


def test_channel_under_fas(monkeypatch):
    monkeypatch.setenv("CUP2D_POIS", "fas")
    js = jcases.make_sim("channel", level=3, dtype="float64")
    ts = cases.make_sim("channel", level=3, dtype="float64", device="cpu")
    assert ts.case == js.case == "channel"
    assert ts.bc_table == js.bc_table
    assert ts.poisson_mode == js.poisson_mode == "fas"
    assert _err(js.state.vel, ts.state.vel) == 0.0
    ds = _lockstep(js, ts, 3)
    assert all(d["finite"] for d in ds)


def test_cylinder_default_solver():
    js = jcases.make_sim("cylinder", level=3, dtype="float64")
    ts = cases.make_sim("cylinder", level=3, dtype="float64", device="cpu")
    assert ts.case == js.case == "cylinder"
    assert ts.bc_table == js.bc_table == "fs,fs,fs,fs"
    _lockstep(js, ts, 3)
    assert ts.shapes[0].forces["drag"] > 0


def test_obstacle_free_simulation_is_the_uniform_step():
    """With no shapes, ``step_once`` is ``UniformSim.step_once`` (the
    plain uniform step, no rasterization) bit for bit, as in JAX."""
    from cup2d_tpu_torch import UniformSim
    from cup2d_tpu_torch.uniform import taylor_green_state
    cfg = config_from_dict(dataclasses.asdict(_cfg(lam=0.0)))
    a = Simulation(cfg, shapes=[], level=3, device="cpu")
    b = UniformSim(cfg, level=3, device="cpu")
    a.state = b.state = taylor_green_state(b.grid)
    for _ in range(3):
        da, db = a.step_once(), b.step_once()
        assert da == db
    assert torch.equal(a.state.vel, b.state.vel)
    assert torch.equal(a.state.pres, b.state.pres)
    assert a.phase_seconds == {}


def test_simulation_refusals(monkeypatch):
    """No card and no device raises; fftd at f64 on the card refuses
    (``tridiag.cu`` has no f64 form yet); the
    ``async_diag`` attribute is accepted and the shaped step still
    returns host diagnostics; the phase timers time the JAX package's
    phases of the shaped step."""
    cfg = config_from_dict(dataclasses.asdict(_cfg()))
    sim = Simulation(cfg, shapes=[DiskShape(0.1, 0.5, 0.5)], level=2,
                     device="cpu")
    sim.async_diag = False
    sim.timers = None
    sim.async_diag = True
    d = sim.step_once()
    assert sim.step_count == 1 and sim.time > 0
    assert not any(torch.is_tensor(v) for v in d.values())
    from cup2d_tpu_torch.profiling import PhaseTimers
    sim.timers = PhaseTimers()
    sim.step_once()
    assert set(sim.timers.report()) == {"kinematics", "rasterize", "flow",
                                        "forces"}
    monkeypatch.setenv("CUP2D_POIS", "fftd")
    with pytest.raises(ValueError, match=r"tridiag\.cu.*note \(c\)"):
        Simulation(cfg, level=2, device="cuda", bc=cases.periodic_table())
    monkeypatch.delenv("CUP2D_POIS")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(cfg, level=2)
