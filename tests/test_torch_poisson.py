"""Port parity for the Poisson layer at f64: the block preconditioner, one
V-cycle and one F-cycle (<= 1e-12), and the two solvers on the cold
``bench_state`` RHS at 64^2 — equal iteration counts and x within 1e-10
of the JAX package."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import poisson as jp  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.uniform import UniformGrid as JGrid  # noqa: E402
from cup2d_tpu_torch import poisson as tp  # noqa: E402
from cup2d_tpu_torch.convert import config_from_dict  # noqa: E402
from cup2d_tpu_torch.uniform import UniformGrid as TGrid  # noqa: E402
from cup2d_tpu_torch.uniform import bench_state  # noqa: E402

F64_BAR = 1e-12
SOLVE_BAR = 1e-10


def _cfg():
    return SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                     extent=1.0, nu=4e-5, cfl=0.5, dtype="float64")


@pytest.fixture(scope="module")
def grids():
    cfg = _cfg()
    jg = JGrid(cfg, level=3)
    tg = TGrid(config_from_dict(dataclasses.asdict(cfg)), level=3,
               device="cpu")
    vel = bench_state(tg).vel
    dt = 0.5 * tg.h
    b = tg.poisson_rhs(vel, None, None, torch.tensor(dt, dtype=tg.dtype))
    return jg, tg, b


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def test_block_precond_matches():
    r = _rand((64, 64), 1)
    jz = jp.apply_block_precond(jnp.asarray(r),
                                jnp.asarray(jp.block_precond_matrix(8)), 8)
    tz = tp.apply_block_precond(torch.tensor(r),
                                torch.tensor(tp.block_precond_matrix(8)), 8)
    assert np.max(np.abs(np.asarray(jz) - tz.numpy())) <= F64_BAR


@pytest.mark.parametrize("cycle", ["__call__", "fcycle"])
@pytest.mark.parametrize("fused", [False, True])
def test_cycle_matches_f64(cycle, fused):
    r = _rand((64, 128), 2)
    jm = jp.MultigridPreconditioner(64, 128, jnp.float64)
    tm = tp.MultigridPreconditioner(64, 128, torch.float64,
                                    fused_smoother=fused)
    assert tm.shapes == jm.shapes
    ref = np.asarray(getattr(jm, cycle)(jnp.asarray(r)))
    got = getattr(tm, cycle)(torch.tensor(r)).numpy()
    assert np.max(np.abs(ref - got)) <= F64_BAR * np.max(np.abs(ref))


def test_bf16_preconditioner_cycle_under_f32():
    tm = tp.MultigridPreconditioner(32, 32, torch.float32)
    assert tm.dtype == torch.bfloat16
    out = tm(torch.tensor(_rand((32, 32), 3), dtype=torch.float32))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def _solve_both(grids, solver, **kw):
    jg, tg, b = grids
    jb = jnp.asarray(b.numpy())
    if solver == "bicgstab":
        jr = jp.bicgstab(jg.laplacian, jb, M=jg.mg, **kw)
        tr = tp.bicgstab(tg.laplacian, b, M=tg.mg, **kw)
    else:
        jr = jp.mg_solve(jg.laplacian, jb, jg.mg, **kw)
        tr = tp.mg_solve(tg.laplacian, b, tg.mg, **kw)
    return jr, tr


@pytest.mark.parametrize("solver,kw", [
    ("bicgstab", dict(tol=0.0, tol_rel=1e-8)),
    ("bicgstab", dict(tol=1e-3, tol_rel=1e-2)),
    ("bicgstab", dict(tol=0.0, tol_rel=0.0, max_restarts=100,
                      refresh_every=10, stall_iters=20, stall_rtol=0.99)),
    ("mg_solve", dict(tol=0.0, tol_rel=1e-8, max_cycles=60)),
    ("mg_solve", dict(tol=0.0, tol_rel=1e-8, max_cycles=60, fmg=True)),
])
def test_solvers_match_on_cold_rhs(grids, solver, kw):
    jr, tr = _solve_both(grids, solver, **kw)
    assert tr.iters == int(jr.iters) > 0
    assert tr.converged == bool(jr.converged)
    assert tr.stalled == bool(jr.stalled)
    assert np.max(np.abs(np.asarray(jr.x) - tr.x.numpy())) <= SOLVE_BAR
    assert abs(tr.residual - float(jr.residual)) <= SOLVE_BAR


def test_project_correct_matches(grids):
    jg, tg, b = grids
    x, pold, vel = _rand((64, 64), 4), _rand((64, 64), 5), \
        _rand((2, 64, 64), 6)
    dt = 0.5 * tg.h
    jv, jpr = jp.project_correct(jnp.asarray(x), jnp.asarray(pold),
                                 jnp.asarray(vel), tg.h, jnp.float64(dt))
    tv, tpr = tp.project_correct(torch.tensor(x), torch.tensor(pold),
                                 torch.tensor(vel), tg.h, dt)
    assert np.max(np.abs(np.asarray(jv) - tv.numpy())) <= F64_BAR
    assert np.max(np.abs(np.asarray(jpr) - tpr.numpy())) <= F64_BAR
