"""The split periodic step: the ring exchange of a periodic x, the y-wrap
forms of the halo substage and the halo sweep (their plain twins here),
the split periodic hierarchy and whole ``ShardedUniformSim`` runs on the
periodic tables, f64 on CPU slab meshes (D in {1, 2, 4}).

* The halo substage's wrap twin over D slabs with the ring exchange,
  gathered, against the JAX package's XLA chain on the whole field
  (``bc.pad_vector_bc`` -> ``advect_diffuse_rhs`` -> ``heun_substage``;
  the reference has no Pallas wrap form): <= 1e-12, both substages, on
  the doubly-periodic box, the periodic channel (x periodic, no-slip y
  walls) and the table periodic in y with no-slip x walls.
* The halo sweep's y-wrap twin, per shard after a ring exchange and as
  the slab list with ring sources, against the JAX package's periodic
  Jacobi sweep (``MultigridPreconditioner._smooth``): <= 1e-12; the two
  forms equal bit for bit, a leading member axis included.
* The split periodic forms (Laplacian, RHS, epilogue) and the split
  periodic V- and F-cycles (split and gathered levels, the ring holding
  on each) equal the port's solo forms bit for bit at f32 and f64, but
  for the epilogue's f64 mean (<= 1e-15: an f64 sum in another order).
* ``tgv_periodic`` and ``turb2d`` on D = 2 and 4 under the default solver
  and fas, and the periodic channel: an exact tol-0 startup step, then
  production steps, <= 1e-10 of a live single-device JAX run with equal
  iterations every step, and <= 1e-12 of the port's solo step.
* fftd on a mesh keeps the reference's ValueError; a periodic table keeps
  its bf16 refusal."""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import cases as jcases  # noqa: E402
from cup2d_tpu import poisson as jp  # noqa: E402
from cup2d_tpu.bc import BCTable as JTable  # noqa: E402
from cup2d_tpu.bc import no_slip as jno_slip  # noqa: E402
from cup2d_tpu.bc import pad_vector_bc as jpad  # noqa: E402
from cup2d_tpu.bc import periodic as jperiodic  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.ops import stencil as jst  # noqa: E402
from cup2d_tpu.uniform import UniformSim as JSim  # noqa: E402
from cup2d_tpu_torch import cases as tcases  # noqa: E402
from cup2d_tpu_torch.convert import bc_from_fields  # noqa: E402
from cup2d_tpu_torch.convert import config_from_dict  # noqa: E402
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from cup2d_tpu_torch.ops.stencil import divergence_bc  # noqa: E402
from cup2d_tpu_torch.ops.stencil import laplacian5_bc  # noqa: E402
from cup2d_tpu_torch.parallel.mesh import (ShardedUniformSim,  # noqa: E402
                                           make_mesh, unshard_state)
from cup2d_tpu_torch.parallel.shard_halo import (  # noqa: E402
    Slabs, _walls, divergence_bc_x, exchange_x, gather_x, laplacian5_bc_x,
    project_correct_x, split_x)
from cup2d_tpu_torch.poisson import (MultigridPreconditioner,  # noqa: E402
                                     project_correct)
from cup2d_tpu_torch.uniform import UniformGrid  # noqa: E402
from cup2d_tpu_torch.uniform import UniformSim  # noqa: E402


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
SOLO_BAR = 1e-12
JAX_BAR = 1e-10
STEPS = 3
H = 1.0 / 32

TABLES = {
    "doubly": jcases.periodic_table(),
    "periodic_x": jcases.periodic_channel_table(),
    "periodic_y": JTable(jno_slip(), jno_slip(), jperiodic(), jperiodic()),
}


def _tables(name):
    j = TABLES[name]
    return j, bc_from_fields(j)


def _mesh(D):
    return make_mesh(devices=["cpu"] * D)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _grid(name, dtype="float64"):
    cfg = SimConfig(bpdx=2, bpdy=1, level_max=1, level_start=0, extent=2.0,
                    nu=1e-3, cfl=0.4, dtype=dtype)
    return UniformGrid(config_from_dict(dataclasses.asdict(cfg)), level=2,
                       device="cpu", bc=_tables(name)[1])


# ---------------------------------------------------------------------------
# the twins against the JAX package's XLA chains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TABLES))
@pytest.mark.parametrize("D", [1, 2, 4])
def test_wrap_substage_twin_matches_jax_chain(name, D):
    jt, tt = _tables(name)
    px = tt.x_lo.kind == "periodic"
    L, ny, nx, nu = 2, 16, 32, 1e-3
    v = _rand((L, 2, ny, nx), 3)
    vold = _rand((L, 2, ny, nx), 4)
    dt = np.array([0.3, 0.2]) * H
    ih2 = 1.0 / (H * H)
    facs = torch.tensor(np.stack([-dt * H, nu * dt, dt], axis=-1))
    mesh = _mesh(D)
    for cfac, old in ((0.5, None), (1.0, vold)):
        vs = split_x(torch.tensor(v), mesh)
        olds = None if old is None else split_x(torch.tensor(old), mesh)
        aux = exchange_x(vs, 3, px)
        w = nx // D
        out = gather_x(Slabs([
            hk.advect_substage_halo(
                p, None if olds is None else olds.parts[d], aux[d], facs,
                cfac, ih2, lo, hi, None, tt, H, d * w, nx)
            for d, (p, (lo, hi)) in enumerate(zip(vs.parts,
                                                  _walls(vs, px)))], mesh))
        dt4 = jnp.asarray(dt)[:, None, None, None]
        lab = jpad(jnp.asarray(v), 3, jt, H, dt4)
        rhs = jst.advect_diffuse_rhs(lab, 3, H, nu, dt4)
        ref = jst.heun_substage(jnp.asarray(v if old is None else old),
                                cfac, rhs, ih2)
        assert np.max(np.abs(np.asarray(ref) - out.numpy())) <= F64_BAR
    assert hk.launches["advect_substage_halo+pd"] == 0   # the twin ran


@pytest.mark.parametrize("name", list(TABLES))
@pytest.mark.parametrize("D", [1, 2, 4])
def test_wrap_sweep_twins_match_jax_chain(name, D):
    g = _grid(name)
    jt, _ = _tables(name)
    px, py = g._paxes
    e = _rand((2, g.ny, g.nx), 5)
    r = _rand((2, g.ny, g.nx), 6)
    jmg = jp.MultigridPreconditioner(
        g.ny, g.nx, jnp.float64, cycle_dtype=jnp.float64,
        edge_signs=g._psigns, periodic=(px, py))
    mesh = _mesh(D)
    es, rs = split_x(torch.tensor(e), mesh), split_x(torch.tensor(r), mesh)
    for fz in (False, True):
        ref = np.stack([np.asarray(jmg._smooth(
            jnp.asarray(e[m]), jnp.asarray(r[m]), 0, 1, from_zero=fz))
            for m in range(2)])
        lst = hk.jacobi_halo_sweep_slabs(es.parts, rs.parts, 0.8, fz,
                                         g._psigns)
        aux = [None] * D if fz else exchange_x(es, 1, px)
        per = [hk.jacobi_halo_sweep(es.parts[d], rs.parts[d], aux[d], 0.8,
                                    lo, hi, fz, g._psigns)
               for d, (lo, hi) in enumerate(_walls(rs, px))]
        assert all(torch.equal(a, b) for a, b in zip(lst, per))
        got = torch.cat(lst, dim=-1).numpy()
        assert np.max(np.abs(ref - got)) <= F64_BAR, fz
    assert hk.launches["jacobi_halo_sweep+pd"] == 0


def test_ring_exchange_and_walls():
    mesh = _mesh(3)
    a = torch.arange(2 * 12, dtype=torch.float64).reshape(2, 12)
    s = split_x(a, mesh)
    aux = exchange_x(s, 2, ring=True)
    assert torch.equal(aux[0], torch.cat([a[:, 10:], a[:, 4:6]], -1))
    assert torch.equal(aux[2], torch.cat([a[:, 6:8], a[:, :2]], -1))
    one = exchange_x(split_x(a, _mesh(1)), 3, ring=True)[0]
    assert torch.equal(one, torch.cat([a[:, 9:], a[:, :3]], -1))
    assert not exchange_x(split_x(a, _mesh(1)), 3)[0].any()
    assert _walls(s, True) == [(False, False)] * 3
    assert _walls(s) == [(True, False), (False, False), (False, True)]
    assert hk._split_signs((0, 0, 1, -1)) == ((0.0, 0.0, 1.0, -1.0), False)
    assert hk._split_signs((1, 1, 0, 0)) == ((1.0, 1.0, 0.0, 0.0), True)


# ---------------------------------------------------------------------------
# split forms against the port's solo forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(TABLES))
def test_split_periodic_forms_equal_solo(dtype, name):
    g = _grid(name, dtype)
    td = g.dtype
    px, py = g._paxes
    mesh = _mesh(4)
    p = torch.tensor(_rand((g.ny, g.nx), 7), dtype=td)
    v = torch.tensor(_rand((2, g.ny, g.nx), 8), dtype=td)
    lap = gather_x(laplacian5_bc_x(split_x(p, mesh), g._psigns, (px, py)))
    assert torch.equal(lap, laplacian5_bc(p, *g._psigns, px, py))
    dt = torch.tensor(0.01, dtype=td)
    rhs = gather_x(divergence_bc_x(split_x(v, mesh), g.h, dt, g._dcoeffs,
                                   None, (px, py)))
    assert torch.equal(rhs, (0.5 * g.h / dt) * divergence_bc(
        v, *g._dcoeffs, px, py))
    x = torch.tensor(_rand((g.ny, g.nx), 9), dtype=td)
    vs, ps = project_correct_x(split_x(x, mesh), split_x(p, mesh),
                               split_x(v, mesh), g.h, dt,
                               grad_signs=g._psigns, periodic=(px, py))
    vw, pw = project_correct(x, p, v, g.h, dt, grad_signs=g._psigns,
                             periodic=(px, py))
    bar = 0.0 if td == torch.float32 else 1e-15
    assert float((gather_x(vs) - vw).abs().max()) <= bar
    assert float((gather_x(ps) - pw).abs().max()) <= bar
    for fused in (False, True):
        r = torch.tensor(_rand((g.ny, g.nx), 10), dtype=td)
        kw = dict(cycle_dtype=td, fused_smoother=fused,
                  edge_signs=g._psigns, periodic=(px, py))
        solo = MultigridPreconditioner(g.ny, g.nx, td, **kw)
        for D in (1, 2, 4):
            split = MultigridPreconditioner(g.ny, g.nx, td, mesh=_mesh(D),
                                            **kw)
            for cyc in ("__call__", "fcycle"):
                a = gather_x(getattr(split, cyc)(split_x(r, _mesh(D))))
                assert torch.equal(a, getattr(solo, cyc)(r)), (D, cyc)


# ---------------------------------------------------------------------------
# split trajectories against single-device JAX and the port's solo step
# ---------------------------------------------------------------------------

def _channel_cfg():
    return SimConfig(bpdx=2, bpdy=1, level_max=1, level_start=0,
                     extent=2.0, nu=2e-3, cfl=0.4, dtype="float64",
                     poisson_tol=1e-9, poisson_tol_rel=0.0,
                     max_poisson_iterations=200)


def _channel_vel(ny, nx):
    y, x = np.meshgrid((np.arange(ny) + 0.5) / ny,
                       (np.arange(nx) + 0.5) / nx, indexing="ij")
    u = (np.sin(np.pi * y) * (1.0 + 0.3 * np.cos(2 * np.pi * x))
         + 0.2 * np.sin(4 * np.pi * x) * np.cos(3 * np.pi * y))
    v = 0.25 * np.sin(2 * np.pi * x) * np.sin(np.pi * y)
    return np.stack([u, v])


def _build(case, pkg, mesh=None):
    if case == "channel":
        jt = jcases.periodic_channel_table()
        if pkg == "jax":
            sim = JSim(_channel_cfg(), level=2, bc=jt)
        else:
            tcfg = config_from_dict(dataclasses.asdict(_channel_cfg()))
            sim = (UniformSim(tcfg, level=2, device="cpu",
                              bc=bc_from_fields(jt)) if mesh is None
                   else ShardedUniformSim(tcfg, mesh, level=2,
                                          bc=bc_from_fields(jt)))
        vel = _channel_vel(sim.grid.ny, sim.grid.nx)
        if pkg == "jax":
            sim.state = sim.state._replace(vel=jnp.asarray(vel))
        elif mesh is None:
            sim.state = sim.state._replace(vel=torch.tensor(vel))
        else:
            sim.set_state(sim.grid.zero_state()._replace(
                vel=torch.tensor(vel)))
        return sim
    if pkg == "jax":
        return jcases.make_sim(case, level=2, dtype="float64")
    if mesh is None:
        return tcases.make_sim(case, level=2, dtype="float64", device="cpu")
    return tcases.make_sim(case, level=2, dtype="float64", mesh=mesh)


def _advance(sim, k):
    """Step k: the first an exact tol-0 startup solve."""
    return sim.advance(1, exact_first_steps=k == 0)


@functools.lru_cache(maxsize=None)
def _references(case, pois):
    """Per step: (JAX vel, JAX pres, port solo vel, port solo pres, JAX
    iterations, port iterations)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CUP2D_POIS", pois)
    try:
        js, ts = _build(case, "jax"), _build(case, "torch")
        out = []
        for k in range(STEPS):
            jd, td = _advance(js, k), _advance(ts, k)
            out.append((np.asarray(js.state.vel), np.asarray(js.state.pres),
                        ts.state.vel.clone(), ts.state.pres.clone(),
                        int(jd["poisson_iters"]), td["poisson_iters"]))
        return out
    finally:
        mp.undo()


SPLIT_RUNS = [(c, p, D) for c in ("tgv_periodic", "turb2d")
              for p in ("", "fas") for D in (2, 4)] + [
    ("channel", "fas", 2), ("channel", "fas", 4), ("channel", "", 4)]


@pytest.mark.parametrize("case,pois,D", SPLIT_RUNS,
                         ids=[f"{c}-{p or 'default'}-{D}"
                              for c, p, D in SPLIT_RUNS])
def test_split_periodic_trajectory_matches_solo_and_jax(monkeypatch, case,
                                                        pois, D):
    refs = _references(case, pois)
    monkeypatch.setenv("CUP2D_POIS", pois)
    sh = _build(case, "torch", _mesh(D))
    assert isinstance(sh, ShardedUniformSim)
    assert sh.kernel_tier == (
        "plain+bc(pd,pd,ns,ns)" if case == "channel"
        else "plain+bc(pd,pd,pd,pd)")
    for k, (jv, jpres, tv, tpres, jit, tit) in enumerate(refs):
        d = _advance(sh, k)
        assert d["poisson_iters"] == tit == jit, (k, d, tit, jit)
        st = unshard_state(sh.state)
        assert float((st.vel - tv).abs().max()) <= SOLO_BAR, k
        assert float((st.pres - tpres).abs().max()) <= SOLO_BAR, k
        assert np.max(np.abs(st.vel.numpy() - jv)) <= JAX_BAR, k
        assert np.max(np.abs(st.pres.numpy() - jpres)) <= JAX_BAR, k
    assert refs[0][4] > 0


def test_fftd_and_bf16_refusals(monkeypatch):
    monkeypatch.setenv("CUP2D_POIS", "fftd")
    with pytest.raises(ValueError, match="cannot attach a device mesh"):
        tcases.make_sim("tgv_periodic", level=2, mesh=_mesh(2))
    monkeypatch.delenv("CUP2D_POIS")
    monkeypatch.setenv("CUP2D_PREC", "bf16")
    with pytest.raises(ValueError, match="CUP2D_PREC=bf16.*periodic"):
        tcases.make_sim("turb2d", level=2, mesh=_mesh(2))
    with pytest.raises(ValueError, match="not both"):
        tcases.make_sim("turb2d", level=2, mesh=_mesh(2), device="cpu")
