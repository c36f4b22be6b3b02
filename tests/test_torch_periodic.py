"""Port parity for the periodic tables and the FFT direct solve at f64.

* ``FFTDiagPlan.solve`` on the doubly-periodic box and on the channels
  periodic in x and in y: within 1e-12 of the JAX package's plan, a true
  residual below 1e-10, and a mean-free solution on the doubly-periodic
  box (tests/test_fftd.py's bars); the Thomas scans' plain twin against
  the JAX plan's two ``lax.scan``s (<= 1e-14); ``member_axis`` batched
  equals solo.
* The periodic V-cycle (<= 1e-12) and each wrap twin (substage pair,
  correction epilogue, sweep chain) against the JAX package's XLA chains.
* Ten-plus steps of ``tgv_periodic`` at 64^2 under the default solver, fas
  and fftd, and of the periodic channel under fas and fftd: within 1e-10
  with equal iterations; the KE decay of ``tgv_periodic`` within 1% of
  exp(-4 nu k^2 t) at 128^2 under fftd.
* The catalog's initial conditions bit for bit, the ``poisson_mode``
  strings and the refusals."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import cases as jcases  # noqa: E402
from cup2d_tpu import poisson as jp  # noqa: E402
from cup2d_tpu.bc import BCTable as JTable  # noqa: E402
from cup2d_tpu.bc import no_slip as jno_slip  # noqa: E402
from cup2d_tpu.bc import periodic as jperiodic  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.uniform import UniformGrid as JGrid  # noqa: E402
from cup2d_tpu.uniform import UniformSim as JSim  # noqa: E402
from cup2d_tpu_torch import bc as tbc  # noqa: E402
from cup2d_tpu_torch import cases as tcases  # noqa: E402
from cup2d_tpu_torch import poisson as tp  # noqa: E402
from cup2d_tpu_torch.convert import bc_from_fields  # noqa: E402
from cup2d_tpu_torch.convert import config_from_dict  # noqa: E402
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from cup2d_tpu_torch.uniform import UniformGrid as TGrid  # noqa: E402
from cup2d_tpu_torch.uniform import UniformSim as TSim  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64_BAR = 1e-12
SCAN_BAR = 1e-14
TRAJ_BAR = 1e-10

# (JAX table, port table) of the three periodic tables
TABLES = {
    "doubly": jcases.periodic_table(),
    "periodic_x": jcases.periodic_channel_table(),
    "periodic_y": JTable(jno_slip(), jno_slip(), jperiodic(), jperiodic()),
}


def _tables(name):
    j = TABLES[name]
    return j, bc_from_fields(j)


def _cfg(**kw):
    base = dict(bpdx=1, bpdy=1, level_max=1, level_start=0, extent=1.0,
                nu=1e-3, cfl=0.4, lam=0.0, dtype="float64",
                max_poisson_iterations=200)
    base.update(kw)
    return SimConfig(**base)


def _grids(name, monkeypatch, pois="fftd", level=3, **kw):
    """The JAX and the port grid of one table (ny 32 x nx 64 at level 3:
    the transposed py-only problem is then not square)."""
    if pois:
        monkeypatch.setenv("CUP2D_POIS", pois)
    else:
        monkeypatch.delenv("CUP2D_POIS", raising=False)
    jt, tt = _tables(name)
    cfg = _cfg(bpdx=2, extent=2.0, **kw)
    jg = JGrid(cfg, level=level, bc=jt)
    tg = TGrid(config_from_dict(dataclasses.asdict(cfg)), level=level,
               device="cpu", bc=tt)
    return jg, tg


def _rand(shape, seed, mean_free=True):
    b = np.random.default_rng(seed).standard_normal(shape)
    if mean_free:
        b = b - b.mean(axis=(-2, -1), keepdims=True)
    return b


@pytest.mark.parametrize("name", list(TABLES))
def test_fftd_plan_solve_matches_jax(name, monkeypatch):
    jg, tg = _grids(name, monkeypatch)
    assert tg.poisson_mode == jg.poisson_mode
    b = _rand((tg.ny, tg.nx), 11)
    xj = np.asarray(jg._fft_plan.solve(jnp.asarray(b)))
    xt = tg._fft_plan.solve(torch.tensor(b))
    assert np.max(np.abs(xj - xt.numpy())) <= F64_BAR
    res = float((torch.tensor(b) - tg.laplacian(xt)).abs().max())
    assert res < 1e-10, res
    if name == "doubly":
        assert abs(float(xt.mean())) < 1e-12
    r = tg.pressure_solve(torch.tensor(b))
    assert (r.iters, r.converged, r.stalled) == (1, True, False)
    assert torch.equal(r.x, xt)


def _jax_scans(plan, bh):
    """The two lax.scan's of the JAX package's FFTDiagPlan.solve on
    bh [L, n_s, nk]."""
    bt = jnp.moveaxis(bh, -2, 0)

    def fwd(dp_prev, xs):
        bj, idj = xs
        dp = (bj - dp_prev) * idj
        return dp, dp

    _, dps = jax.lax.scan(fwd, jnp.zeros_like(bt[0]),
                          (bt, plan.inv_denom))

    def bwd(x_next, xs):
        dpj, cpj = xs
        xj = dpj - cpj * x_next
        return xj, xj

    _, xt = jax.lax.scan(bwd, jnp.zeros_like(bt[0]), (dps, plan.cp),
                         reverse=True)
    return np.asarray(jnp.moveaxis(xt, 0, -2))


@pytest.mark.parametrize("name", ["periodic_x", "periodic_y"])
def test_tridiag_scan_plain_matches_the_jax_scans(name, monkeypatch):
    jg, tg = _grids(name, monkeypatch)
    n_s, nk = tg._fft_plan.cp.shape
    rng = np.random.default_rng(3)
    bh = (rng.standard_normal((2, n_s, nk))
          + 1j * rng.standard_normal((2, n_s, nk)))
    ref = _jax_scans(jg._fft_plan, jnp.asarray(bh))
    got = hk.tridiag_scan(torch.tensor(bh), tg._fft_plan.inv_denom,
                          tg._fft_plan.cp)
    assert got.dtype == torch.complex128
    assert np.max(np.abs(ref - got.numpy())) <= SCAN_BAR
    assert hk.launches["tridiag_scan"] == 0     # the twin ran


@pytest.mark.parametrize("name", list(TABLES))
def test_fft_diag_solve_member_axis_equals_solo(name, monkeypatch):
    _, tg = _grids(name, monkeypatch)
    b = torch.tensor(_rand((3, tg.ny, tg.nx), 5))
    batch = tp.fft_diag_solve(tg.laplacian, b, tg._fft_plan, tol=1e-3,
                              tol_rel=1e-2, member_axis=True)
    assert batch.iters.tolist() == [1, 1, 1]
    assert bool(batch.converged.all()) and not bool(batch.stalled.any())
    for m in range(3):
        solo = tp.fft_diag_solve(tg.laplacian, b[m], tg._fft_plan)
        assert torch.allclose(batch.x[m], solo.x, rtol=0, atol=F64_BAR)
        assert abs(float(batch.residual[m]) - solo.residual) <= F64_BAR


@pytest.mark.parametrize("name", list(TABLES))
@pytest.mark.parametrize("fused", [False, True])
def test_periodic_vcycle_matches_jax(name, fused, monkeypatch):
    jg, tg = _grids(name, monkeypatch, pois="fas", level=2)
    r = _rand((tg.ny, tg.nx), 7)
    jmg = jp.MultigridPreconditioner(
        tg.ny, tg.nx, jnp.float64, cycle_dtype=jnp.float64,
        edge_signs=jg._psigns, periodic=jg._paxes)
    tmg = tp.MultigridPreconditioner(
        tg.ny, tg.nx, torch.float64, cycle_dtype=torch.float64,
        fused_smoother=fused, edge_signs=tg._psigns, periodic=tg._paxes)
    for cyc in ("__call__", "fcycle"):
        ej = np.asarray(getattr(jmg, cyc)(jnp.asarray(r)))
        et = getattr(tmg, cyc)(torch.tensor(r)).numpy()
        assert np.max(np.abs(ej - et)) <= F64_BAR, cyc


@pytest.mark.parametrize("name", list(TABLES))
def test_wrap_twins_match_the_jax_xla_chains(name, monkeypatch):
    jg, tg = _grids(name, monkeypatch, pois="fas")
    px, py = tg._paxes
    rng = np.random.default_rng(9)
    vel = rng.standard_normal((2, tg.ny, tg.nx))
    dt = 0.3 * tg.h
    # the substage pair: the XLA pad -> RHS -> update chain
    vj = np.asarray(jg.advect_heun(jnp.asarray(vel), dt))
    vt = hk.fused_advect_heun_plain(torch.tensor(vel), tg.h, tg.cfg.nu, dt,
                                    bc=tg.bc)
    assert np.max(np.abs(vj - vt.numpy())) <= F64_BAR
    # the correction epilogue: project_correct's XLA branch with periodic=
    x, po = rng.standard_normal((2, tg.ny, tg.nx))
    jv, jpr = jp.project_correct(jnp.asarray(x), jnp.asarray(po),
                                 jnp.asarray(vel), tg.h, dt,
                                 grad_signs=jg._psigns, periodic=jg._paxes)
    tv, tpr = tp.project_correct(torch.tensor(x), torch.tensor(po),
                                 torch.tensor(vel), tg.h, dt,
                                 grad_signs=tg._psigns, periodic=tg._paxes)
    assert np.max(np.abs(np.asarray(jv) - tv.numpy())) <= F64_BAR
    assert np.max(np.abs(np.asarray(jpr) - tpr.numpy())) <= F64_BAR
    # the sweep chain: the periodic cycle's XLA sweeps at level 0
    jmg = jp.MultigridPreconditioner(
        tg.ny, tg.nx, jnp.float64, cycle_dtype=jnp.float64,
        edge_signs=jg._psigns, periodic=jg._paxes)
    for n, fz in ((2, False), (3, True), (24, False)):
        ej = np.asarray(jmg._smooth(jnp.asarray(x), jnp.asarray(po), 0, n,
                                    from_zero=fz))
        et = hk.jacobi_sweeps_plain(torch.tensor(x), torch.tensor(po), 0.8,
                                    n, fz, tg._psigns, (px, py))
        assert np.max(np.abs(ej - et.numpy())) <= F64_BAR, (n, fz)
        ew = hk.fused_jacobi_sweeps(torch.tensor(x), torch.tensor(po), 0.8,
                                    n, fz, tg._psigns)
        assert torch.equal(ew, et)


def _steps(js, ts, n):
    for k in range(n):
        dj, dt_ = js.step_once(), ts.step_once()
        assert int(dj["poisson_iters"]) == dt_["poisson_iters"], k
        assert dj["dt"] == pytest.approx(dt_["dt"], rel=1e-12)
        ev = np.max(np.abs(np.asarray(js.state.vel)
                           - ts.state.vel.numpy()))
        ep = np.max(np.abs(np.asarray(js.state.pres)
                           - ts.state.pres.numpy()))
        assert ev <= TRAJ_BAR and ep <= TRAJ_BAR, (k, ev, ep)


@pytest.mark.parametrize("pois", ["", "fas", "fftd"])
def test_tgv_periodic_trajectory_matches_jax(monkeypatch, pois):
    """The 10 exact startup steps and two production steps of the
    catalog's doubly-periodic Taylor-Green vortex at 64^2."""
    monkeypatch.setenv("CUP2D_POIS", pois)
    js = jcases.make_sim("tgv_periodic", level=3, dtype="float64")
    ts = tcases.make_sim("tgv_periodic", level=3, dtype="float64",
                         device="cpu")
    assert ts.poisson_mode == js.poisson_mode
    assert ts.kernel_tier == "plain+bc(pd,pd,pd,pd)"
    _steps(js, ts, 12)


def _channel_velocity(grid):
    x, y = grid.cell_centers()
    lx, ly = grid.cfg.extents
    u = (np.sin(np.pi * y / ly) * (1.0 + 0.3 * np.cos(2 * np.pi * x / lx))
         + 0.2 * np.sin(4 * np.pi * x / lx) * np.cos(3 * np.pi * y / ly))
    v = 0.25 * np.sin(2 * np.pi * x / lx) * np.sin(np.pi * y / ly)
    return np.stack([u, v])


@pytest.mark.parametrize("pois", ["fas", "fftd"])
def test_periodic_channel_trajectory_matches_jax(monkeypatch, pois):
    monkeypatch.setenv("CUP2D_POIS", pois)
    cfg = _cfg(bpdx=2, extent=2.0, nu=2e-3)
    js = JSim(cfg, level=3, bc=jcases.periodic_channel_table())
    ts = TSim(config_from_dict(dataclasses.asdict(cfg)), level=3,
              device="cpu", bc=tcases.periodic_channel_table())
    vel = _channel_velocity(ts.grid)
    js.state = js.state._replace(vel=jnp.asarray(vel))
    ts.state = ts.state._replace(vel=torch.tensor(vel))
    assert ts.poisson_mode == js.poisson_mode
    assert ts.bc_table == "pd,pd,ns,ns"
    _steps(js, ts, 11)


def test_tgv_periodic_ke_decay_within_1pct(monkeypatch):
    """tests/test_fftd.py's bar on the port: KE decays as
    exp(-4 nu k^2 t), k = 2 pi, within 1% at 128^2 under fftd."""
    nu = 1e-3
    monkeypatch.setenv("CUP2D_POIS", "fftd")
    sim = tcases.make_sim("tgv_periodic", level=4, nu=nu, dtype="float64",
                          device="cpu")
    ke0 = float(torch.mean(sim.state.vel ** 2))
    sim.advance(n_steps=10_000, tend=0.1)
    assert sim.time >= 0.1
    ke = float(torch.mean(sim.state.vel ** 2))
    expected = np.exp(-4.0 * nu * (2.0 * np.pi) ** 2 * sim.time)
    assert abs(ke / ke0 - expected) / expected < 0.01


@pytest.mark.parametrize("name,kw", [
    ("turb2d", {}), ("turb2d", {"seed": 3, "level": 3}),
    ("shear_layer", {}), ("tgv_periodic", {"level": 3})])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_initial_conditions_bit_equal(name, kw, dtype):
    js = jcases.make_sim(name, dtype=dtype, **kw)
    ts = tcases.make_sim(name, dtype=dtype, device="cpu", **kw)
    assert ts.case == js.case == name
    assert np.array_equal(np.asarray(js.state.vel), ts.state.vel.numpy())
    assert ts.cfg == config_from_dict(dataclasses.asdict(js.cfg))


def test_poisson_mode_strings(monkeypatch):
    for pois, name, mode in (("fftd", "doubly", "fftd"),
                             ("fftd", "periodic_x", "fftd+tridiag"),
                             ("fftd", "periodic_y", "fftd+tridiag"),
                             ("fas", "doubly", "fas"),
                             ("fas-f", "periodic_x", "fas-f"),
                             ("", "doubly", "bicgstab+mg")):
        jg, tg = _grids(name, monkeypatch, pois=pois)
        assert tg.poisson_mode == jg.poisson_mode == mode
        assert tg.precond_cycles(tp.BiCGSTABResult(None, 3, 0.0, True,
                                                   False), False) == int(
            jg.precond_cycles(jp.BiCGSTABResult(None, jnp.asarray(3), 0.0,
                                                True, False), False))


def test_refusals(monkeypatch):
    from cup2d_tpu_torch.amr import AMRSim
    from cup2d_tpu_torch.parallel.mesh import ShardedUniformSim, make_mesh
    cfg = config_from_dict(dataclasses.asdict(_cfg()))
    monkeypatch.setenv("CUP2D_POIS", "fftd")
    for table in (None, tcases.cavity_table()):
        with pytest.raises(ValueError, match="at least one periodic"):
            TGrid(cfg, level=2, device="cpu", bc=table)
    mesh = make_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="cannot attach a device mesh"):
        ShardedUniformSim(cfg, mesh, level=2, bc=tcases.periodic_table())
    with pytest.raises(ValueError, match="CUP2D_POIS"):
        AMRSim(cfg, shapes=[], device="cpu")
    monkeypatch.setenv("CUP2D_POIS", "fas")
    # the split periodic step runs (tests/test_torch_mesh_periodic.py)
    sh = ShardedUniformSim(cfg, mesh, level=2,
                           bc=tcases.periodic_channel_table())
    assert sh.bc_table == "pd,pd,ns,ns" and len(sh.state.vel.parts) == 2
    sh = tcases.make_sim("tgv_periodic", level=2, mesh=mesh)
    assert isinstance(sh, ShardedUniformSim) and sh.case == "tgv_periodic"
    fleet = tcases.make_sim("turb2d", level=2, members=2, device="cpu")
    assert fleet.members == 2 and fleet.poisson_mode == "fas"
    monkeypatch.setenv("CUP2D_PREC", "bf16")
    monkeypatch.delenv("CUP2D_POIS")
    with pytest.raises(ValueError, match="CUP2D_PREC=bf16.*periodic"):
        tcases.make_sim("shear_layer", level=2, device="cpu")
    with pytest.raises(ValueError, match="periodic"):
        hk._signs((0.0, 1.0, 1.0, 1.0))
    z = torch.zeros(1, 8, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="periodic"):
        tp.project_correct(z, z, torch.zeros(1, 2, 8, 8, dtype=z.dtype),
                           0.1, 0.01, grad_signs=(0.0, 0.0, 1.0, 1.0),
                           periodic=(False, True))
    assert hk._wrap_axes(hk._signs((0, 0, 1, 1))) == (True, False)
    assert tbc.periodic_axes(tcases.periodic_channel_table()) == (True,
                                                                 False)
