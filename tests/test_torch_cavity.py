"""Port parity for the wall-bounded uniform step (slice 6): the boundary
table forms of the three kernels' twins, the signed multigrid hierarchy
and projection epilogue, the case catalog, and whole trajectories.

* K2's BC twin (``advect_substage_plain`` with a table, through
  ``fused_advect_heun(bc=...)``): against the JAX package's
  ``fused_advect_heun(bc=...)`` Pallas kernel in interpret mode at f32,
  <= 2e-6 for the four tables of tests/test_megakernel.py (the bound the
  JAX package pins its kernel to against its XLA chain), and member-batched
  with per-member dt <= 1e-5 (the JAX package's own bound there: its
  kernel rounds the outflow speed ((s e) dt)/h in another order than the
  chain, measured 2.03e-6 apart); against the JAX XLA chain at f64 <= 1e-12.
* K5's twin with the channel's pressure signs against the JAX kernel in
  interpret mode (<= 5e-6, the means reassociate), and K6's twin with
  signs (1, -1, 1, 1) at n = 1..3 (<= 2e-6 relative).
* The signed V-cycle and ``project_correct(remove_mean=, grad_signs=)``
  against JAX at f64 <= 1e-12.
* Trajectories against a live JAX run, <= 1e-10 with equal iterations
  every step: the 32^2 cavity at f64 over 40 ``step_once`` steps under
  each solver (and the reference's lid-shear checks) and an obstacle-free
  parabolic channel on 64 x 16; the plug flow through inflow and outflow
  exact to 1e-10 and within 1e-10 of JAX (see its test for the
  iterations).
* The cavity's Poisson RHS is mean-free to rounding, and the channel's
  operator has no constant nullspace.
* The catalog, the Ghia data, the free-slip table's bit-identity and the
  refusals (a periodic table on a mesh; the split cavity builds)."""

import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import bc as jbc  # noqa: E402
from cup2d_tpu import cases as jcases  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.ops import pallas_kernels as jpk  # noqa: E402
from cup2d_tpu.ops.stencil import advect_diffuse_rhs, heun_substage  # noqa: E402
from cup2d_tpu.poisson import MultigridPreconditioner as JMG  # noqa: E402
from cup2d_tpu.poisson import project_correct as jproject  # noqa: E402
from cup2d_tpu.uniform import UniformSim as JSim  # noqa: E402
from cup2d_tpu_torch import bc as tbc  # noqa: E402
from cup2d_tpu_torch import cases as tcases  # noqa: E402
from cup2d_tpu_torch.convert import (bc_from_fields,  # noqa: E402
                                     config_from_dict)
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from cup2d_tpu_torch.parallel.mesh import (ShardedUniformSim,  # noqa: E402
                                           make_mesh)
from cup2d_tpu_torch.parallel.shard_halo import (  # noqa: E402
    fused_advect_heun_sharded, split_x)
from cup2d_tpu_torch.poisson import MultigridPreconditioner  # noqa: E402
from cup2d_tpu_torch.poisson import project_correct  # noqa: E402
from cup2d_tpu_torch.uniform import UniformGrid, UniformSim  # noqa: E402
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


NY, NX = 32, 64
H = 1.0 / NX
NU = 4e-5
HEUN_BOUND = 2e-6
MEMBER_BOUND = 1e-5
CORRECTION_BOUND = 5e-6
JACOBI_REL_BOUND = 2e-6
F64_BAR = 1e-12
TRAJ_BAR = 1e-10


def _tables(pkg, cases):
    """The four tables of tests/test_megakernel.py."""
    return {
        "cavity": cases.cavity_table(1.0),
        "channel_uniform": cases.channel_table(1.0),
        "channel_parabolic": cases.channel_table(1.0, profile="parabolic"),
        "outflow_y": pkg.BCTable(pkg.no_slip(), pkg.no_slip(),
                                 pkg.dirichlet_inflow(0.0, 1.0,
                                                      profile="parabolic"),
                                 pkg.convective_outflow()),
    }


TABLES = sorted(_tables(tbc, tcases))


def _pair(name):
    return _tables(jbc, jcases)[name], _tables(tbc, tcases)[name]


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _dts(L, dtype=np.float32):
    return np.asarray([0.5 * H, 0.35 * H, 0.27 * H][:L], dtype)


def _xla_bc_heun(vel, dt, bc):
    """The JAX package's XLA chain under a table (uniform.advect_heun)."""
    ih2 = 1.0 / (H * H)
    dt_b = dt[:, None, None, None]
    v = vel
    for c in (0.5, 1.0):
        lab = jbc.pad_vector_bc(v, 3, bc, H, dt_b)
        v = heun_substage(vel, c, advect_diffuse_rhs(lab, 3, H, NU, dt_b),
                          ih2)
    return v


# ---------------------------------------------------------------------------
# the three kernel forms' twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TABLES)
def test_advect_heun_bc_twin_vs_pallas_f32(name):
    j, t = _pair(name)
    v = _rand((1, 2, NY, NX), 11)
    dt = _dts(1)
    ref = np.asarray(jpk.fused_advect_heun(jnp.asarray(v), H, NU,
                                           jnp.asarray(dt), bc=j))
    got = hk.fused_advect_heun(torch.tensor(v), H, NU, torch.tensor(dt),
                               bc=t)
    assert got.dtype == torch.float32
    err = np.max(np.abs(got.numpy() - ref))
    assert err <= HEUN_BOUND, (name, err)


def test_advect_heun_bc_twin_member_batched_vs_pallas_f32():
    j, t = _pair("channel_parabolic")
    v = _rand((3, 2, NY, NX), 12)
    dt = _dts(3)
    ref = np.asarray(jpk.fused_advect_heun(jnp.asarray(v), H, NU,
                                           jnp.asarray(dt), bc=j))
    got = hk.fused_advect_heun(torch.tensor(v), H, NU, torch.tensor(dt),
                               bc=t)
    err = np.max(np.abs(got.numpy() - ref))
    assert err <= MEMBER_BOUND, err


@pytest.mark.parametrize("name", TABLES)
@pytest.mark.parametrize("L", [1, 3])
def test_advect_heun_bc_twin_vs_xla_f64(name, L):
    j, t = _pair(name)
    v = _rand((L, 2, NY, NX), 13 + L, np.float64)
    dt = _dts(L, np.float64)
    ref = np.asarray(_xla_bc_heun(jnp.asarray(v), jnp.asarray(dt), j))
    got = hk.fused_advect_heun(torch.tensor(v), H, NU, torch.tensor(dt),
                               bc=t)
    assert np.max(np.abs(got.numpy() - ref)) <= F64_BAR


def test_free_slip_table_takes_the_free_slip_substage():
    v = torch.tensor(_rand((1, 2, NY, NX), 14))
    dt = torch.tensor(_dts(1))
    assert torch.equal(hk.fused_advect_heun(v, H, NU, dt, bc=tbc.FREE_SLIP),
                       hk.fused_advect_heun(v, H, NU, dt))


def test_correction_twin_with_channel_signs_vs_pallas_f32():
    gs = tbc.pressure_signs(tcases.channel_table(1.0))
    assert gs == jbc.pressure_signs(jcases.channel_table(1.0)) \
        == (1.0, -1.0, 1.0, 1.0)
    x, pold = _rand((2, NY, NX), 20), _rand((2, NY, NX), 21)
    vel = _rand((2, 2, NY, NX), 22)
    pfac = (-0.5 * _dts(2) * H).astype(np.float32)
    zero = np.zeros(2, np.float32)
    jp, jv = jpk.fused_correction(
        jnp.asarray(x), jnp.asarray(pold), jnp.asarray(vel),
        jnp.asarray(zero), jnp.asarray(zero), jnp.asarray(pfac),
        1.0 / (H * H), grad_signs=gs)
    scal = torch.tensor(np.stack([zero, zero, pfac], axis=-1))
    tp, tv = hk.fused_correction(torch.tensor(x), torch.tensor(pold),
                                 torch.tensor(vel), scal, 1.0 / (H * H),
                                 grad_signs=gs)
    assert np.max(np.abs(tp.numpy() - np.asarray(jp))) <= CORRECTION_BOUND
    assert np.max(np.abs(tv.numpy() - np.asarray(jv))) <= CORRECTION_BOUND
    # all-Neumann signs are the Neumann twin bit for bit
    a = hk.fused_correction(torch.tensor(x), torch.tensor(pold),
                            torch.tensor(vel), scal, 1.0 / (H * H),
                            grad_signs=(1.0, 1.0, 1.0, 1.0))
    b = hk.fused_correction(torch.tensor(x), torch.tensor(pold),
                            torch.tensor(vel), scal, 1.0 / (H * H))
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("from_zero", [False, True])
def test_jacobi_twin_with_edge_signs_vs_pallas_f32(n, from_zero):
    signs = (1.0, -1.0, 1.0, 1.0)
    e, r = _rand((NY, NX), 40 + n), _rand((NY, NX), 50 + n)
    ref = np.asarray(jpk.fused_jacobi_sweeps(
        jnp.asarray(e), jnp.asarray(r), 0.8, n, edge_signs=signs,
        from_zero=from_zero))
    got = hk.fused_jacobi_sweeps(torch.tensor(e), torch.tensor(r), 0.8, n,
                                 from_zero, edge_signs=signs).numpy()
    rel = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert rel <= JACOBI_REL_BOUND, rel
    # the signs matter: the Neumann chain differs at the outflow column
    neu = hk.fused_jacobi_sweeps(torch.tensor(e), torch.tensor(r), 0.8, n,
                                 from_zero).numpy()
    assert np.max(np.abs(neu - got)) > 1e-3


@pytest.mark.parametrize("signs", [(1.0, -1.0, 1.0, 1.0),
                                   (1.0, 1.0, 1.0, 1.0)])
@pytest.mark.parametrize("fused", [False, True])
def test_signed_vcycle_matches_jax_f64(signs, fused):
    """One V-cycle and one F-cycle of the signed hierarchy at solver
    precision (the FAS solver's cycle; ``fused`` sends the chains through
    the sweep wrapper's twin)."""
    r = _rand((NY, NX), 60, np.float64)
    jmg = JMG(NY, NX, jnp.float64, cycle_dtype=jnp.float64,
              edge_signs=signs)
    tmg = MultigridPreconditioner(NY, NX, torch.float64,
                                  cycle_dtype=torch.float64,
                                  fused_smoother=fused, edge_signs=signs)
    for jf, tf in ((jmg, tmg), (jmg.fcycle, tmg.fcycle)):
        ref = np.asarray(jf(jnp.asarray(r)))
        got = tf(torch.tensor(r)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=F64_BAR)
    np.testing.assert_allclose(tmg._lap(torch.tensor(r)).numpy(),
                               np.asarray(jmg._lap(jnp.asarray(r))),
                               rtol=0, atol=F64_BAR)


@pytest.mark.parametrize("remove_mean", [True, False])
def test_project_correct_signed_matches_jax_f64(remove_mean):
    gs = (1.0, -1.0, 1.0, 1.0)
    x, pold = _rand((NY, NX), 70, np.float64), _rand((NY, NX), 71,
                                                      np.float64)
    vel = _rand((2, NY, NX), 72, np.float64)
    dt = 0.5 * H
    jv, jp = jproject(jnp.asarray(x), jnp.asarray(pold), jnp.asarray(vel),
                      H, dt, remove_mean=remove_mean, grad_signs=gs)
    tv, tp = project_correct(torch.tensor(x), torch.tensor(pold),
                             torch.tensor(vel), H, dt,
                             remove_mean=remove_mean, grad_signs=gs)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=F64_BAR)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=F64_BAR)


# ---------------------------------------------------------------------------
# trajectories against a live JAX run
# ---------------------------------------------------------------------------

def _err(js, ts):
    ev = np.max(np.abs(np.asarray(js.state.vel) - ts.state.vel.numpy()))
    ep = np.max(np.abs(np.asarray(js.state.pres) - ts.state.pres.numpy()))
    return ev, ep


@pytest.mark.parametrize("pois", ["", "fas", "fas-f"])
def test_cavity_trajectory_matches_jax(monkeypatch, pois):
    monkeypatch.setenv("CUP2D_POIS", pois)
    js = jcases.make_sim("cavity", level=2, dtype="float64")
    ts = tcases.make_sim("cavity", level=2, dtype="float64", device="cpu")
    assert ts.bc_table == js.bc_table == "ns,ns,ns,ns(1,0)"
    assert ts.poisson_mode == js.poisson_mode
    assert ts.kernel_tier == "plain+bc(ns,ns,ns,ns(1,0))"
    for _ in range(40):
        jd, td = js.step_once(), ts.step_once()
        assert td["poisson_iters"] == int(jd["poisson_iters"])
        assert abs(td["dt"] - float(jd["dt"])) <= 1e-15
        ev, ep = _err(js, ts)
        assert ev <= TRAJ_BAR and ep <= TRAJ_BAR, (ev, ep)
    # tests/test_bc.py's lid-shear checks, on the port's state
    vel = ts.state.vel.numpy()
    assert np.all(np.isfinite(vel))
    top = float(vel[0, -1, :].mean())
    assert top > 0.3
    assert float(np.abs(vel[0, 0, :]).mean()) < 0.1 * top


def _cfg(**kw):
    base = dict(bpdx=1, bpdy=1, level_max=1, level_start=0, extent=1.0,
                nu=1e-3, cfl=0.4, lam=1e6, dtype="float64",
                max_poisson_iterations=100)
    base.update(kw)
    return SimConfig(**base)


def _sims(cfg, level, jtable, vel):
    js = JSim(cfg, level=level, bc=jtable)
    ts = UniformSim(config_from_dict(dataclasses.asdict(cfg)), level=level,
                    device="cpu", bc=bc_from_fields(jtable))
    js.state = js.grid.zero_state()._replace(vel=jnp.asarray(vel))
    ts.state = ts.grid.zero_state()._replace(vel=torch.tensor(vel))
    return js, ts


def test_plug_flow_is_exact_through_inflow_outflow():
    """tests/test_bc.py's null test on the port: uniform u = u_in with
    inflow at x_lo and convective outflow at x_hi is an exact steady
    solution, and the two packages agree step by step. The port's Poisson
    RHS is exactly 0 (the inflow's affine term cancels the edge term to
    the bit), so every solve stops at once; the JAX package's jitted RHS
    holds ~3e-17 of rounding from XLA's fusion, which its tol-0 startup
    solves iterate on, so iteration counts are not compared here."""
    u_in = 0.2
    cfg = _cfg(bpdx=2, extent=2.0, cfl=0.3)
    js, ts = _sims(cfg, 2, jcases.channel_table(u_in),
                   np.stack([np.full((32, 64), u_in), np.zeros((32, 64))]))
    for _ in range(25):
        js.step_once()
        assert ts.step_once()["poisson_iters"] == 0
        ev, ep = _err(js, ts)
        assert ev <= TRAJ_BAR and ep <= TRAJ_BAR
    vel = ts.state.vel.numpy()
    np.testing.assert_allclose(vel[0], u_in, rtol=0, atol=1e-10)
    np.testing.assert_allclose(vel[1], 0.0, rtol=0, atol=1e-10)


@pytest.mark.parametrize("pois", ["", "fas"])
def test_parabolic_channel_trajectory_matches_jax(monkeypatch, pois):
    """The channel table with a parabolic inflow, obstacle-free, on
    64 x 16 (bpdx 4, level 1) from a perturbed Poiseuille start."""
    monkeypatch.setenv("CUP2D_POIS", pois)
    cfg = _cfg(bpdx=4, extent=4.0, nu=1e-2, poisson_tol=1e-6,
               poisson_tol_rel=1e-4)
    x = (np.arange(64) + 0.5) / 16
    y = (np.arange(16) + 0.5) / 16
    X, Y = np.meshgrid(x, y, indexing="xy")
    u = 2.0 * Y * (1 - Y) + 0.05 * np.sin(np.pi * X / 2) * np.sin(np.pi * Y)
    v = 0.05 * np.cos(np.pi * X) * np.sin(2 * np.pi * Y)
    js, ts = _sims(cfg, 1, jcases.channel_table(0.5, profile="parabolic"),
                   np.stack([u, v]))
    for _ in range(25):
        jd, td = js.step_once(), ts.step_once()
        assert td["poisson_iters"] == int(jd["poisson_iters"])
        ev, ep = _err(js, ts)
        assert ev <= TRAJ_BAR and ep <= TRAJ_BAR, (ev, ep)


def test_cavity_rhs_is_mean_free_and_channel_operator_is_not_singular():
    """The solver note: no cavity wall has a normal velocity, so the
    undivided divergence telescopes to zero and the Poisson RHS is
    mean-free to rounding; the channel's outflow row removes the constant
    nullspace."""
    sim = tcases.make_sim("cavity", level=2, dtype="float64", device="cpu")
    for _ in range(12):
        sim.step_once()
        g = sim.grid
        b = g.poisson_rhs(g.advect_heun(sim.state.vel, 1e-3), None, None,
                          torch.tensor(1e-3, dtype=torch.float64))
        assert float(b.sum().abs()) <= 1e-13 * float(b.abs().sum())
    grid = UniformGrid(config_from_dict(dataclasses.asdict(_cfg(bpdx=2))),
                       level=1, device="cpu",
                       bc=tcases.channel_table(1.0))
    one = torch.ones(grid.ny, grid.nx, dtype=torch.float64)
    assert float(grid.laplacian(one).abs().max()) == 2.0


# ---------------------------------------------------------------------------
# catalog, Ghia data, bit-identity and refusals
# ---------------------------------------------------------------------------

def test_catalog_matches_jax():
    assert tcases.case_names() == jcases.case_names()
    for c in tcases.CASES:
        j = jcases.REGISTRY[c.name]
        assert (c.describe, c.default_level, c.fleet_ok) == \
            (j.describe, j.default_level, j.fleet_ok)
    js = jcases.make_sim("cavity", level=3, re=400.0, dtype="float64")
    ts = tcases.make_sim("cavity", level=3, re=400.0, dtype="float64",
                         device="cpu")
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    assert ts.case == js.case == "cavity"
    assert (ts.grid.ny, ts.grid.nx) == (js.grid.ny, js.grid.nx)
    with pytest.raises(ValueError, match="unknown case"):
        tcases.make_sim("bogus")


def test_ghia_data_and_profiles_match_the_validation_module():
    from validation import cavity as vc
    for name in ("GHIA_Y", "GHIA_U", "GHIA_X", "GHIA_V"):
        np.testing.assert_array_equal(getattr(tcases, name),
                                      getattr(vc, name))
    js = jcases.make_sim("cavity", level=2, dtype="float64")
    ts = tcases.make_sim("cavity", level=2, dtype="float64", device="cpu")
    vel = _rand((2, 32, 32), 80, np.float64)
    js.state = js.state._replace(vel=jnp.asarray(vel))
    ts.state = ts.state._replace(vel=torch.tensor(vel))
    for (ja, jb), (ta, tb) in zip(vc.centerline_profiles(js),
                                  tcases.centerline_profiles(ts)):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
    # the comparison of validation.cavity.run, on the same state
    (y, u), (x, v) = vc.centerline_profiles(js)
    ref = (float(np.max(np.abs(np.interp(vc.GHIA_Y, y, u) - vc.GHIA_U))),
           float(np.max(np.abs(np.interp(vc.GHIA_X, x, v) - vc.GHIA_V))))
    assert tcases.ghia_errors(ts) == ref


def test_free_slip_table_is_bit_identical_to_no_table():
    cfg = config_from_dict(dataclasses.asdict(_cfg()))
    a = UniformSim(cfg, level=2, device="cpu")
    b = UniformSim(cfg, level=2, device="cpu", bc=tbc.FREE_SLIP)
    a.state = taylor_green_state(a.grid)
    b.state = taylor_green_state(b.grid)
    assert a.bc_table == b.bc_table == "fs,fs,fs,fs"
    assert a.kernel_tier == "plain"
    for _ in range(4):
        a.step_once()
        b.step_once()
    assert torch.equal(a.state.vel, b.state.vel)
    assert torch.equal(a.state.pres, b.state.pres)


@pytest.mark.parametrize("table", ["periodic", "periodic_channel"])
def test_periodic_tables_refuse(table, monkeypatch):
    """The periodic tables run (their parity with JAX is in
    tests/test_torch_periodic.py) and refuse only the bf16 tier, which
    has no periodic form, as in the JAX package."""
    bc = getattr(tcases, f"{table}_table")()
    cfg = config_from_dict(dataclasses.asdict(_cfg()))
    g = UniformGrid(cfg, level=2, device="cpu", bc=bc)
    assert g.bc_table == bc.token and g.kernel_tier == f"plain+bc({bc.token})"
    st = g.zero_state()
    st.vel[0] = 0.3
    st, d = g.step(st, 0.5 * g.h, obstacle_terms=False)
    assert bool(d["finite"]) and d["poisson_converged"]
    monkeypatch.setenv("CUP2D_PREC", "bf16")
    with pytest.raises(ValueError, match="CUP2D_PREC=bf16"):
        UniformGrid(config_from_dict(dataclasses.asdict(_cfg(
            dtype="float32"))), level=2, device="cpu", bc=bc)


def test_split_step_with_a_table_refuses():
    """Since the split BC and periodic forms were ported, every table runs
    on a mesh (the periodic ones held in tests/test_torch_mesh_periodic.py):
    a periodic table builds a split sim and the split substage runs it;
    the cavity builds a split sim and the signed split hierarchy
    builds."""
    cfg = config_from_dict(dataclasses.asdict(_cfg()))
    mesh = make_mesh(devices=["cpu"] * 2)
    for table in (tcases.periodic_table(), tcases.periodic_channel_table()):
        sh = ShardedUniformSim(cfg, mesh, level=2, bc=table)
        assert sh.bc_table == table.token and len(sh.state.vel.parts) == 2
    whole = torch.tensor(np.random.default_rng(1).standard_normal(
        (2, 16, 32)))
    v = split_x(whole, mesh)
    out = fused_advect_heun_sharded(v, 1 / 32, 1e-3, 1e-3,
                                    bc=tcases.periodic_channel_table())
    assert torch.equal(torch.cat(out.parts, dim=-1), hk.fused_advect_heun(
        whole, 1 / 32, 1e-3, 1e-3, bc=tcases.periodic_channel_table()))
    sim = tcases.make_sim("cavity", level=2, mesh=mesh, dtype="float64")
    assert isinstance(sim, ShardedUniformSim) and sim.case == "cavity"
    assert sim.kernel_tier == "plain+bc(ns,ns,ns,ns(1,0))"
    assert len(sim.state.vel.parts) == 2
    with pytest.raises(ValueError, match="not both"):
        tcases.make_sim("cavity", level=2, device="cpu", mesh=mesh)
    mg = MultigridPreconditioner(32, 32, torch.float64, mesh=mesh,
                                 edge_signs=(1.0, 1.0, 1.0, 1.0))
    assert mg.meshes[0] is mesh


@pytest.mark.parametrize("name,item", [("tgv_periodic", "queue 1 item 8"),
                                       ("shear_layer", "queue 1 item 8"),
                                       ("turb2d", "queue 1 item 8")])
def test_waiting_cases_refuse(name, item):
    """The periodic cases build and step solo, as a fleet, on a mesh and as
    a fleet on a mesh (tests/test_torch_fleet.py holds their fleets
    against JAX's, tests/test_torch_mesh_periodic.py and
    tests/test_torch_fleet_mesh.py their split runs); ``item`` names the
    ROADMAP item their split step and placed fleets once waited for, whose
    last entry (fleets across processes) no longer refuses anywhere in
    the package (tests/test_torch_fleet_dist.py runs them)."""
    from cup2d_tpu_torch.fleet import FleetSim
    fleet = tcases.make_sim(name, level=2, device="cpu", dtype="float64",
                            members=2)
    assert isinstance(fleet, FleetSim) and fleet.case == name
    d = fleet.step_once()
    assert d["finite"].all() and fleet.step_count == 1
    assert (fleet.times > 0).all()
    split = tcases.make_sim(name, level=2, dtype="float64",
                            mesh=make_mesh(devices=["cpu"] * 2))
    assert isinstance(split, ShardedUniformSim) and split.case == name
    assert split.step_once()["finite"]
    placed = tcases.make_sim(name, level=2, members=2, dtype="float64",
                             mesh=make_mesh(devices=["cpu"] * 2))
    assert placed.placement == "member" and placed.case == name
    assert placed.step_once()["finite"].all()
    assert item == "queue 1 item 8"
    import cup2d_tpu_torch
    pkg = os.path.dirname(cup2d_tpu_torch.__file__)
    for root, _, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(root, fn)) as f:
                    src = f.read()
                assert "item 8" not in src and "item 9" not in src, fn
    sim = tcases.make_sim(name, level=2, device="cpu", dtype="float64")
    assert sim.case == name and sim.bc_table == "pd,pd,pd,pd"
    d = sim.step_once()
    assert d["finite"] and sim.step_count == 1


@pytest.mark.parametrize("name,table", [
    ("channel", "in(0.2,0),out,fs,fs"), ("cylinder", "fs,fs,fs,fs")])
def test_shaped_cases_build_and_step(name, table):
    """The shaped cases build a port ``sim.Simulation`` (one prescribed
    disk) and step; their parity with JAX is in
    tests/test_torch_shaped_cases.py."""
    from cup2d_tpu_torch.sim import Simulation
    sim = tcases.make_sim(name, level=2, device="cpu", dtype="float64")
    assert isinstance(sim, Simulation) and sim.case == name
    assert sim.bc_table == table
    assert len(sim.shapes) == 1 and not sim.shapes[0].free
    d = sim.step_once()
    assert d["finite"] and sim.step_count == 1
    assert np.isfinite(sim.shapes[0].forces["drag"])


def test_cavity_fleet_and_bf16_refuse(monkeypatch):
    """The cavity runs as a fleet (every member on its table), on a mesh
    too (member placement); bf16 runs the cavity on f32 state (the
    boundary table's bf16 substage form) and refuses it on f64, as the JAX
    package does."""
    from cup2d_tpu_torch.fleet import FleetSim
    fleet = tcases.make_sim("cavity", level=2, device="cpu", members=2)
    assert isinstance(fleet, FleetSim) and fleet.case == "cavity"
    assert fleet.bc_table == "ns,ns,ns,ns(1,0)"
    d = fleet.step_once()
    assert d["finite"].all() and (d["umax"] > 0).all()
    placed = tcases.make_sim("cavity", level=2, members=2,
                             mesh=make_mesh(devices=["cpu"] * 2))
    assert placed.placement == "member"
    assert placed.step_once()["finite"].all()
    monkeypatch.setenv("CUP2D_PREC", "bf16")
    with pytest.raises(ValueError, match="CUP2D_PREC"):
        tcases.make_sim("cavity", level=2, device="cpu", dtype="float64")
    sim = tcases.make_sim("cavity", level=2, device="cpu")
    assert sim.kernel_tier == "plain-bf16+bc(ns,ns,ns,ns(1,0))"


def test_kernel_forms_refuse_periodic_signs_and_tables():
    """A periodic axis's sign pair (0, 0) and the periodic face kind have
    the wrap forms, whose periodic axes are those pairs; a lone 0 sign
    refuses, and a periodic y pair on the split sweep takes its y-wrap
    form."""
    assert hk._signs((0.0, 0.0, 1.0, 1.0)) == (0.0, 0.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="periodic"):
        hk._signs((0.0, 1.0, 1.0, 1.0))
    assert hk._wrap_axes((0.0, 0.0, 1.0, 1.0)) == (True, False)
    assert hk._wrap_axes((1.0, -1.0, 0.0, 0.0)) == (False, True)
    assert hk._split_signs((1.0, 1.0, 0.0, 0.0)) == ((1.0, 1.0, 0.0, 0.0),
                                                      True)
    f = hk._faces(tcases.periodic_channel_table())
    assert (f.x_lo.kind, f.x_hi.kind, f.y_lo.kind, f.y_hi.kind) == (4, 4, 1,
                                                                    1)
    f = hk._faces(tcases.channel_table(0.5, profile="parabolic"))
    assert (f.x_lo.kind, f.x_lo.parabolic, f.x_lo.u) == (2, 1, 0.5)
    assert (f.x_hi.kind, f.y_lo.kind, f.y_hi.kind) == (3, 0, 0)
