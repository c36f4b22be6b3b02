"""Port parity for the whole obstacle-free uniform step (slice 1).

* 10 production steps of Taylor-Green at 64^2 f64 under the default
  solver and under CUP2D_POIS=fas/fas-f: vel and pres within 1e-10 of the
  JAX package, equal Poisson iterations every step.
* ``step_once``: the first 10 steps are the exact tol-0 solves, then the
  production ones, with equal iterations and the same dt sequence.
* The Taylor-Green decay bar of tests/test_taylor_green.py on the port.
* convert.py round trip, the device policy and the loud refusals.
* The port imports neither jax nor cup2d_tpu."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.uniform import UniformSim  # noqa: E402
from cup2d_tpu.uniform import taylor_green_state as jtg  # noqa: E402
from cup2d_tpu_torch import SimConfig as TConfig  # noqa: E402
from cup2d_tpu_torch import UniformGrid as TGrid  # noqa: E402
from cup2d_tpu_torch import UniformSim as TSim  # noqa: E402
from cup2d_tpu_torch.convert import (config_from_dict,  # noqa: E402
                                     state_from_numpy, state_to_numpy)
from cup2d_tpu_torch.uniform import taylor_green_state  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_BAR = 1e-10


def _tg_kw(**kw):
    base = dict(bpdx=1, bpdy=1, level_max=4, level_start=3, extent=1.0,
                nu=1e-3, cfl=0.4, lam=0.0, dtype="float64")
    base.update(kw)
    return base


def _pair(**kw):
    """The same Taylor-Green start in both packages (state carried over
    through convert.py)."""
    cfg = SimConfig(**_tg_kw(**kw))
    js = UniformSim(cfg)
    js.state = jtg(js.grid)
    ts = TSim(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    ts.state = state_from_numpy(
        {k: np.asarray(v) for k, v in js.state._asdict().items()},
        "cpu", torch.float64)
    return js, ts


def _state_err(js, ts):
    ev = np.max(np.abs(np.asarray(js.state.vel) - ts.state.vel.numpy()))
    ep = np.max(np.abs(np.asarray(js.state.pres) - ts.state.pres.numpy()))
    return ev, ep


@pytest.mark.parametrize("pois", ["", "fas", "fas-f"])
def test_trajectory_matches_jax(monkeypatch, pois):
    monkeypatch.setenv("CUP2D_POIS", pois)
    js, ts = _pair(poisson_tol=1e-9, poisson_tol_rel=0.0)
    assert ts.poisson_mode == js.poisson_mode
    for _ in range(10):
        jd = js.advance(1)
        td = ts.advance(1)
        assert td["poisson_iters"] == int(jd["poisson_iters"]) > 0
        assert td["poisson_converged"] == bool(jd["poisson_converged"])
        ev, ep = _state_err(js, ts)
        assert ev <= TRAJ_BAR and ep <= TRAJ_BAR, (ev, ep)
    assert abs(ts.time - js.time) <= 1e-14


def test_step_once_exact_startup_matches_jax():
    js, ts = _pair()
    for k in range(12):
        jd = js.step_once()
        td = ts.step_once()
        # dt comes from umax, a reduction: equal to the last bit or two
        assert abs(td["dt"] - jd["dt"]) <= 1e-15
        assert td["poisson_iters"] == int(jd["poisson_iters"])
        # the first 10 solves run at tol 0 and end at the precision floor
        assert td["poisson_stalled"] == bool(jd["poisson_stalled"])
        assert td["poisson_stalled"] == (k < 10)
        assert td["precond_cycles"] == 2 * td["poisson_iters"]
        for key in ("umax", "energy", "div_linf", "dt_next"):
            assert abs(td[key] - float(jd[key])) <= TRAJ_BAR
        ev, ep = _state_err(js, ts)
        assert ev <= TRAJ_BAR and ep <= TRAJ_BAR, (ev, ep)


def _tg_port(level=3, nu=1e-3):
    cfg = TConfig(**_tg_kw(level_max=level + 1, level_start=level, nu=nu,
                           poisson_tol=1e-11, poisson_tol_rel=0.0))
    sim = TSim(cfg, device="cpu")
    sim.state = taylor_green_state(sim.grid)
    return sim


def test_taylor_green_decay_bar():
    nu = 1e-3
    sim = _tg_port(nu=nu)
    w0 = float(sim.grid.vorticity_field(sim.state.vel).abs().max())
    sim.advance(n_steps=10_000, tend=0.2)
    assert sim.time >= 0.2
    w1 = float(sim.grid.vorticity_field(sim.state.vel).abs().max())
    expected = np.exp(-2 * nu * np.pi ** 2 * sim.time)
    assert abs(w1 / w0 - expected) / expected < 0.02, (w1 / w0, expected)


def test_divergence_free_and_bounded_energy():
    sim = _tg_port(level=2)
    e0 = float((sim.state.vel ** 2).sum())
    sim.advance(n_steps=20)
    assert float((sim.state.vel ** 2).sum()) <= e0 * 1.001
    # the central divergence of the projected field vanishes only to
    # O(h^2) (the compact Laplacian is not div(grad)); at 64^2 the
    # (h/2)-scaled form stays below 1e-5
    from cup2d_tpu_torch.ops.stencil import divergence_freeslip
    sim = _tg_port(level=3)
    sim.advance(n_steps=5)
    div = 0.5 * sim.grid.h * divergence_freeslip(sim.state.vel)
    assert float(div.abs().max()) < 1e-5


def test_convert_round_trip():
    cfg = SimConfig(**_tg_kw(nu=3e-4, poisson_tol=1e-6))
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    grid = TGrid(tcfg, device="cpu")
    st = taylor_green_state(grid)
    back = state_from_numpy(state_to_numpy(st), "cpu", torch.float64)
    for a, b in zip(st, back):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown"):
        config_from_dict({"bogus": 1})


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSim(TConfig(**_tg_kw()))


def test_f64_on_the_card_refuses():
    with pytest.raises(ValueError, match="f32 state only"):
        TGrid(TConfig(**_tg_kw()), device="cuda")


@pytest.mark.parametrize("env,value,exc", [
    # fftd needs a periodic axis, which the free-slip box has not
    ("CUP2D_POIS", "fftd", ValueError),
    ("CUP2D_POIS", "typo", ValueError),
    # bf16 runs on f32 state; this config is f64, which it refuses
    ("CUP2D_PREC", "bf16", ValueError),
    ("CUP2D_PREC", "f16", ValueError),
])
def test_latches_refuse_loudly(monkeypatch, env, value, exc):
    monkeypatch.setenv(env, value)
    with pytest.raises(exc, match=env):
        TGrid(TConfig(**_tg_kw()), device="cpu")


@pytest.mark.parametrize("pois", ["structured", "tables", "fft"])
def test_forest_tokens_are_inert(monkeypatch, pois):
    monkeypatch.setenv("CUP2D_POIS", pois)
    assert TGrid(TConfig(**_tg_kw()), device="cpu").poisson_mode == \
        "bicgstab+mg"


def test_non_free_slip_table_refuses(monkeypatch):
    """A boundary table is a ``bc.BCTable`` (a bare token refuses). The
    other tables run: the walled ones (tests/test_torch_cavity.py) and the
    periodic ones (tests/test_torch_periodic.py), which refuse the bf16
    tier, naming the table."""
    from cup2d_tpu_torch.cases import cavity_table, periodic_channel_table
    with pytest.raises(TypeError, match="BCTable"):
        TGrid(TConfig(**_tg_kw()), device="cpu", bc="ns,ns,ns,ns")
    g = TGrid(TConfig(**_tg_kw()), device="cpu", bc=periodic_channel_table())
    assert g.bc_table == "pd,pd,ns,ns" and g._paxes == (True, False)
    assert TGrid(TConfig(**_tg_kw()), device="cpu",
                 bc=cavity_table()).bc_table == "ns,ns,ns,ns(1,0)"
    monkeypatch.setenv("CUP2D_PREC", "bf16")
    with pytest.raises(ValueError, match="pd,pd,ns,ns"):
        TGrid(TConfig(**_tg_kw(dtype="float32")), device="cpu",
              bc=periodic_channel_table())


def _fish_kw():
    """``entry()``'s two fish, f64."""
    return dict(bpdx=2, bpdy=1, level_max=1, level_start=0, extent=4.0,
                dtype="float64", nu=4e-5, lam=1e7, cfl=0.5,
                shapes="angle=0 L=0.2 xpos=1.8 ypos=0.8\n"
                       "angle=180 L=0.2 xpos=1.6 ypos=0.8")


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    # a checkpoint of the JAX package's fish after a step (its shapes
    # then hold stepped state), loaded below into the port
    from cup2d_tpu.io import save_checkpoint as jsave
    from cup2d_tpu.sim import Simulation as JSim
    jsim = JSim(SimConfig(**_fish_kw()), level=3)
    jsim.step_once()
    assert jsim.step_count == 1
    jsave(str(tmp_path / "ck"), jsim)
    code = ("import sys, cup2d_tpu_torch, cup2d_tpu_torch.convert, "
            "cup2d_tpu_torch.bc, cup2d_tpu_torch.cases, "
            "cup2d_tpu_torch.amr, cup2d_tpu_torch.parallel.mesh, "
            "cup2d_tpu_torch.parallel.shard_halo, "
            "cup2d_tpu_torch.kernel_ab, cup2d_tpu_torch.ops.timing, "
            "cup2d_tpu_torch.sim, cup2d_tpu_torch.models, "
            "cup2d_tpu_torch.ops.obstacle, cup2d_tpu_torch.ops.collision, "
            "cup2d_tpu_torch.ops.forces, cup2d_tpu_torch.shapes_host, "
            "cup2d_tpu_torch.halo, cup2d_tpu_torch.flux, "
            "cup2d_tpu_torch.forest, cup2d_tpu_torch.poisson, chip_smoke; "
            "from cup2d_tpu_torch.poisson import FFTDiagPlan, "
            "fft_diag_solve; "
            "from cup2d_tpu_torch.ops.hopper_kernels import tridiag_scan; "
            "import cup2d_tpu_torch.io, cup2d_tpu_torch.profiling, "
            "cup2d_tpu_torch.post, cup2d_tpu_torch.resilience, "
            "cup2d_tpu_torch.faults, cup2d_tpu_torch.__main__, "
            "cup2d_tpu_torch.fleet, cup2d_tpu_torch.tracing, "
            "cup2d_tpu_torch.parallel.forest_mesh, "
            "cup2d_tpu_torch.native; "
            "from cup2d_tpu_torch.sim import Simulation; "
            f"cfg = cup2d_tpu_torch.SimConfig(**{_fish_kw()!r}); "
            "sim = Simulation(cfg, level=3, device='cpu'); "
            f"cup2d_tpu_torch.io.load_checkpoint({str(tmp_path / 'ck')!r}, "
            "sim); assert type(sim.shapes[0]).__module__ == "
            "'cup2d_tpu_torch.models.fish', sim.shapes; "
            "assert sim.step_count == 1, sim.step_count; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'cup2d_tpu' "
            "or m.startswith('cup2d_tpu.') or m == 'validation' "
            "or m.startswith('validation.')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                     r"import\s+cup2d_tpu(?!_torch)\b|"
                     r"from\s+cup2d_tpu(?!_torch)\b|"
                     r"import\s+validation\b|from\s+validation\b)", re.M)
    files = [os.path.join(d, f)
             for d, _, fs in os.walk(os.path.join(REPO, "cup2d_tpu_torch"))
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    for path in files:
        with open(path) as fh:
            assert not pat.search(fh.read()), path
