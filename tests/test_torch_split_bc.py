"""Port parity for wall-bounded boxes on the x-split step: the
boundary-table form of the halo substage, the per-slab BC stencils, the
signed halo sweep and split hierarchy, and whole split trajectories.

* The halo BC twin per shard against the JAX package's per-shard Pallas
  kernel (``_fused_substage_sharded`` with a table), called directly in
  interpret mode on operands built with numpy (aux lane-padded to 128
  columns, info (is_lo, is_hi, col0)), at f32 <= 2e-6 (the solo BC twin's
  bar against its Pallas kernel, tests/test_torch_cavity.py), under the
  four tables of tests/test_torch_cavity.py, both substages, D in {2, 4}.
* ``bc.pad_vector_bc_slab`` over every slab against the JAX package's
  ``bc.pad_vector_bc`` of the whole field at f64: equal (0.0).
* The split forms assembled over a CPU slab mesh (both substages, the
  Laplacian, the RHS with the affine term, the epilogue, the signed halo
  sweeps and the signed V- and F-cycles) equal the port's solo forms bit
  for bit at f32 and f64, except the epilogue's mean removal at f64
  (<= 1e-15: an f64 sum in another order).
* Split trajectories (``ShardedUniformSim``, D in {2, 4}, f64) of the
  32^2 cavity and the 64 x 16 parabolic channel under the default solver,
  fas and fas-f: an exact tol-0 startup step, then production steps, the
  velocity <= 1e-12 from the port's solo step and <= 1e-10 from the JAX
  package's solo ``UniformSim(bc=)``, with equal iterations every step
  (the pressure <= 1e-10 from both: the channel's BiCGSTAB solve carries
  the reductions' order into it at ~3e-12, as it carries the two
  packages' apart at ~2e-12). The channel
  is held at f64 only: at f32 the default solver does not converge on it
  (ROADMAP queue 3).
* The split bf16 cavity under fas equals the solo bf16 cavity bit for
  bit."""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import bc as jbc  # noqa: E402
from cup2d_tpu import cases as jcases  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.ops import pallas_kernels as jpk  # noqa: E402
from cup2d_tpu.uniform import UniformSim as JSim  # noqa: E402
from cup2d_tpu_torch import bc as tbc  # noqa: E402
from cup2d_tpu_torch import cases as tcases  # noqa: E402
from cup2d_tpu_torch.convert import (bc_from_fields,  # noqa: E402
                                     config_from_dict)
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from cup2d_tpu_torch.ops.stencil import laplacian5_bc  # noqa: E402
from cup2d_tpu_torch.parallel.mesh import (ShardedUniformSim,  # noqa: E402
                                           make_mesh, unshard_state)
from cup2d_tpu_torch.parallel.shard_halo import (  # noqa: E402
    divergence_bc_x, exchange_x, fused_advect_heun_sharded, gather_x,
    laplacian5_bc_x, overlap_jacobi_sweeps, project_correct_x, split_x)
from cup2d_tpu_torch.poisson import (MultigridPreconditioner,  # noqa: E402
                                     project_correct)
from cup2d_tpu_torch.uniform import UniformGrid, UniformSim  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.skipif(not jpk.HAVE_PALLAS,
                                reason="needs jax.experimental.pallas")

NY, NX = 32, 64
H = 1.0 / NX
NU = 4e-5
HEUN_BOUND = 2e-6
SOLO_BAR = 1e-12
JAX_BAR = 1e-10
LANES = 128


def _tables(pkg, cases):
    """The four tables of tests/test_torch_cavity.py."""
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


def _shard_aux(a, d, D, g, pad_to=None):
    """aux of shard d of a whole field a [..., NX]: the g columns left of
    the slab, then the g right of it, zeros at the walls; lane-padded with
    zeros to ``pad_to`` columns."""
    w = a.shape[-1] // D
    c0 = d * w
    aux = np.zeros(a.shape[:-1] + (pad_to or 2 * g,), a.dtype)
    if d > 0:
        aux[..., :g] = a[..., c0 - g:c0]
    if d < D - 1:
        aux[..., g:2 * g] = a[..., c0 + w:c0 + w + g]
    return aux


_jitted = {}


def _pallas_substage(v, vold, aux, info, facs, cfac, name):
    key = (v.shape, vold is None, cfac, name)
    if key not in _jitted:
        jt = _pair(name)[0]

        def run(v, vold, aux, info, facs):
            return jpk._fused_substage_sharded(
                v, vold, aux, info, facs, cfac, 1.0 / (H * H), jnp.float32,
                jt, H, NX, True)
        _jitted[key] = jax.jit(run)
    return np.asarray(_jitted[key](v, vold, aux, info, facs))


# ---------------------------------------------------------------------------
# the halo substage's BC twin and the slab paint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TABLES)
@pytest.mark.parametrize("second", [False, True])
@pytest.mark.parametrize("D", [2, 4])
def test_halo_bc_twin_vs_pallas_f32(name, second, D):
    tt = _pair(name)[1]
    v = _rand((1, 2, NY, NX), 1 + D)
    vold = _rand((1, 2, NY, NX), 11 + D) if second else None
    cfac = 1.0 if second else 0.5
    dt = 0.5 * H
    facs = np.asarray([[-dt * H, NU * dt, dt]], np.float32)
    w = NX // D
    for d in range(D):
        sl = slice(d * w, (d + 1) * w)
        info = np.asarray([[d == 0, d == D - 1, d * w]], np.int32)
        ref = _pallas_substage(
            jnp.asarray(v[..., sl]),
            None if vold is None else jnp.asarray(vold[..., sl]),
            jnp.asarray(_shard_aux(v, d, D, 3, LANES)), jnp.asarray(info),
            jnp.asarray(facs), cfac, name)
        got = hk.advect_substage_halo(
            torch.tensor(v[..., sl]),
            None if vold is None else torch.tensor(vold[..., sl]),
            torch.tensor(_shard_aux(v, d, D, 3)), torch.tensor(facs), cfac,
            1.0 / (H * H), d == 0, d == D - 1, bc=tt, h=H, col0=d * w,
            nx_tot=NX)
        err = np.max(np.abs(got.numpy() - ref))
        assert err <= HEUN_BOUND, (d, err)


@pytest.mark.parametrize("name", TABLES)
@pytest.mark.parametrize("D", [2, 4])
def test_pad_vector_bc_slab_equals_jax_whole_field_f64(name, D):
    jt, tt = _pair(name)
    v = _rand((3, 2, NY, NX), 20 + D, np.float64)
    dt = np.asarray([0.5, 0.35, 0.27])[:, None, None, None] * H
    ref = np.asarray(jbc.pad_vector_bc(jnp.asarray(v), 3, jt, H,
                                       jnp.asarray(dt)))
    w = NX // D
    for d in range(D):
        got = tbc.pad_vector_bc_slab(
            torch.tensor(v[..., d * w:(d + 1) * w]),
            torch.tensor(_shard_aux(v, d, D, 3)), 3, tt, H, torch.tensor(dt),
            d * w, NX, d == 0, d == D - 1)
        np.testing.assert_array_equal(got.numpy(),
                                      ref[..., d * w:d * w + w + 6])


# ---------------------------------------------------------------------------
# the split forms against the port's solo forms, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [2, 4])
def test_split_forms_equal_solo_bit_for_bit(dtype, D):
    mesh = make_mesh(devices=["cpu"] * D)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    v = torch.tensor(_rand((3, 2, NY, NX), 30 + D, np_dt))
    dts = torch.tensor([0.5 * H, 0.35 * H, 0.27 * H], dtype=dtype)
    dt = dts[0]
    e = torch.tensor(_rand((NY, NX), 40 + D, np_dt))
    r = torch.tensor(_rand((NY, NX), 50 + D, np_dt))
    cfg = config_from_dict(dataclasses.asdict(SimConfig(
        bpdx=2, bpdy=1, level_max=1, level_start=0, extent=2.0,
        dtype="float64" if dtype == torch.float64 else "float32")))
    for name in TABLES:
        tt = _pair(name)[1]
        signs = tbc.pressure_signs(tt)
        # both Heun substages, member-batched with per-member dt
        solo = hk.fused_advect_heun_plain(v, H, NU, dts, bc=tt)
        split = fused_advect_heun_sharded(split_x(v, mesh), H, NU, dts,
                                          bc=tt)
        assert torch.equal(gather_x(split), solo), name
        # the operator, the RHS (with the affine term) and the epilogue
        assert torch.equal(gather_x(laplacian5_bc_x(split_x(e, mesh),
                                                    signs)),
                           laplacian5_bc(e, *signs)), name
        grid = UniformGrid(cfg, level=2, device="cpu", bc=tt)
        v0 = v[0]
        b = grid.poisson_rhs(v0, None, None, dt)
        aff = (None if grid._div_affine is None
               else split_x(grid._div_affine, mesh))
        bs = divergence_bc_x(split_x(v0, mesh), grid.h, dt, grid._dcoeffs,
                             aff)
        assert torch.equal(gather_x(bs), b), name
        vel_s, pres_s = project_correct_x(
            split_x(e, mesh), split_x(r, mesh), split_x(v0, mesh), H, dt,
            remove_mean=tt.all_neumann, grad_signs=signs)
        vel, pres = project_correct(e, r, v0, H, dt,
                                    remove_mean=tt.all_neumann,
                                    grad_signs=signs)
        if dtype == torch.float32 or not tt.all_neumann:
            assert torch.equal(gather_x(vel_s), vel), name
            assert torch.equal(gather_x(pres_s), pres), name
        else:
            # f64 means summed per shard differ from the whole-field mean
            # in the last bits (f32 values rounded from an f64 sum do not)
            assert float((gather_x(pres_s) - pres).abs().max()) <= 1e-15
            assert float((gather_x(vel_s) - vel).abs().max()) <= 1e-15
        # signed halo sweeps: the wrapper's twin and the plain sweeps
        for n, fz in [(1, False), (1, True), (3, False), (2, True)]:
            ref = hk.jacobi_sweeps_plain(e, r, 0.8, n, fz, signs)
            for fused in (True, False):
                got = overlap_jacobi_sweeps(split_x(e, mesh),
                                            split_x(r, mesh), 0.8, n, fz,
                                            fused, signs)
                assert torch.equal(gather_x(got), ref), (name, n, fz)


@pytest.mark.parametrize("mode", ["default", "fas", "fas_bf16_legs"])
@pytest.mark.parametrize("D", [2, 8])
def test_signed_split_cycles_equal_solo_bit_for_bit(mode, D):
    """The signed bf16 preconditioner V-cycle (plain sweeps), the f64 FAS
    V- and F-cycles and the FAS cycles on bf16 legs (the halo-sweep
    wrapper), split over D slabs with the coarse levels gathered at D = 8,
    against the solo signed cycles; both sign patterns of the tables."""
    ny, nx = 64, 128
    fas = mode != "default"
    dtype = torch.float64 if mode == "fas" else torch.float32
    kw = dict(cycle_dtype=dtype if fas else None, fused_smoother=fas,
              leg_dtype=torch.bfloat16 if mode == "fas_bf16_legs" else None)
    mesh = make_mesh(devices=["cpu"] * D)
    r = torch.tensor(np.random.default_rng(D).standard_normal((ny, nx)),
                     dtype=dtype)
    rs = split_x(r, mesh)
    for signs in ((1.0, 1.0, 1.0, 1.0), (1.0, -1.0, 1.0, 1.0)):
        solo = MultigridPreconditioner(ny, nx, dtype, edge_signs=signs, **kw)
        split = MultigridPreconditioner(ny, nx, dtype, mesh=mesh,
                                        edge_signs=signs, **kw)
        assert torch.equal(gather_x(split(rs)), solo(r)), signs
        if fas:
            assert torch.equal(gather_x(split.fcycle(rs)), solo.fcycle(r))


def test_split_halo_bc_wrappers_take_the_twin_and_count_nothing():
    hk.reset_launches()
    tt = _pair("channel_parabolic")[1]
    v = torch.tensor(_rand((1, 2, NY, 16), 60))
    aux = torch.tensor(_rand((1, 2, NY, 6), 61))
    facs = torch.tensor([[-0.5 * H * H, NU * 0.5 * H, 0.5 * H]])
    kw = dict(bc=tt, h=H, col0=16, nx_tot=NX)
    assert torch.equal(
        hk.advect_substage_halo(v, None, aux, facs, 0.5, 1 / H ** 2, 0, 0,
                                **kw),
        hk.advect_substage_halo_plain(v, None, aux, facs, 0.5, 1 / H ** 2,
                                      0, 0, **kw))
    e, r, a2 = v[0, 0], v[0, 1], aux[0, 0, :, :2]
    signs = (1.0, -1.0, 1.0, 1.0)
    assert torch.equal(hk.jacobi_halo_sweep(e, r, a2, 0.8, 0, 1, False,
                                            signs),
                       hk.jacobi_halo_sweep_plain(e, r, a2, 0.8, 0, 1,
                                                  False, signs))
    assert hk.launches == {k: 0 for k in hk.launches}
    assert not hk._fns, "a CPU call must not build or load a kernel"


# ---------------------------------------------------------------------------
# split trajectories against the solo step and a live JAX run
# ---------------------------------------------------------------------------

STEPS = 3


def _channel_cfg():
    return SimConfig(bpdx=4, bpdy=1, level_max=1, level_start=0,
                     extent=4.0, nu=1e-2, cfl=0.4, lam=1e6, dtype="float64",
                     max_poisson_iterations=100, poisson_tol=1e-6,
                     poisson_tol_rel=1e-4)


def _channel_vel():
    """A perturbed Poiseuille start on 64 x 16 (tests/test_torch_cavity.py's
    channel trajectory)."""
    x = (np.arange(64) + 0.5) / 16
    y = (np.arange(16) + 0.5) / 16
    X, Y = np.meshgrid(x, y, indexing="xy")
    u = 2.0 * Y * (1 - Y) + 0.05 * np.sin(np.pi * X / 2) * np.sin(np.pi * Y)
    v = 0.05 * np.cos(np.pi * X) * np.sin(2 * np.pi * Y)
    return np.stack([u, v])


def _cavity_vel():
    rng = np.random.default_rng(7)
    return 0.1 * rng.standard_normal((2, 32, 32))


def _build(case, pkg, mesh=None):
    """(sim, start velocity) of a case in the JAX package (``pkg`` "jax"),
    the port solo (mesh None) or the port split over ``mesh``."""
    if case == "cavity":
        vel = _cavity_vel()
        if pkg == "jax":
            return jcases.make_sim("cavity", level=2, dtype="float64"), vel
        if mesh is None:
            return tcases.make_sim("cavity", level=2, dtype="float64",
                                   device="cpu"), vel
        return tcases.make_sim("cavity", level=2, dtype="float64",
                               mesh=mesh), vel
    vel = _channel_vel()
    jt = jcases.channel_table(0.5, profile="parabolic")
    if pkg == "jax":
        return JSim(_channel_cfg(), level=1, bc=jt), vel
    tcfg = config_from_dict(dataclasses.asdict(_channel_cfg()))
    if mesh is None:
        return UniformSim(tcfg, level=1, device="cpu",
                          bc=bc_from_fields(jt)), vel
    return ShardedUniformSim(tcfg, mesh, level=1, bc=bc_from_fields(jt)), vel


def _set_vel(sim, vel, pkg):
    if pkg == "jax":
        sim.state = sim.grid.zero_state()._replace(vel=jnp.asarray(vel))
    elif isinstance(sim, ShardedUniformSim):
        sim.set_state(sim.grid.zero_state()._replace(vel=torch.tensor(vel)))
    else:
        sim.state = sim.grid.zero_state()._replace(vel=torch.tensor(vel))


def _advance(sim, k):
    """Step k, a production step (the exact startup solves of the split
    step are held in tests/test_torch_mesh.py)."""
    return sim.advance(1)


@functools.lru_cache(maxsize=None)
def _references(case, pois):
    """Per step: (JAX vel, JAX pres, port solo vel, port solo pres, JAX
    iterations, port iterations)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CUP2D_POIS", pois)
    try:
        js, vel = _build(case, "jax")
        ts, _ = _build(case, "torch")
        _set_vel(js, vel, "jax")
        _set_vel(ts, vel, "torch")
        out = []
        for k in range(STEPS):
            jd, td = _advance(js, k), _advance(ts, k)
            out.append((np.asarray(js.state.vel), np.asarray(js.state.pres),
                        ts.state.vel.clone(), ts.state.pres.clone(),
                        int(jd["poisson_iters"]), td["poisson_iters"]))
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("case", ["cavity", "channel"])
@pytest.mark.parametrize("pois", ["", "fas", "fas-f"])
@pytest.mark.parametrize("D", [2, 4])
def test_split_walled_trajectory_matches_solo_and_jax(monkeypatch, case,
                                                      pois, D):
    refs = _references(case, pois)
    monkeypatch.setenv("CUP2D_POIS", pois)
    sh, vel = _build(case, "torch", make_mesh(devices=["cpu"] * D))
    assert sh.kernel_tier.startswith("plain+bc(")
    _set_vel(sh, vel, "torch")
    for k, (jv, jp, tv, tp, jit, tit) in enumerate(refs):
        d = _advance(sh, k)
        assert d["poisson_iters"] == tit == jit, (k, d, tit, jit)
        st = unshard_state(sh.state)
        assert float((st.vel - tv).abs().max()) <= SOLO_BAR, k
        assert float((st.pres - tp).abs().max()) <= JAX_BAR, k
        assert np.max(np.abs(st.vel.numpy() - jv)) <= JAX_BAR, k
        assert np.max(np.abs(st.pres.numpy() - jp)) <= JAX_BAR, k
    assert refs[-1][4] > 0


def test_split_bf16_cavity_fas_bit_for_bit(monkeypatch):
    monkeypatch.setenv("CUP2D_PREC", "bf16")
    monkeypatch.setenv("CUP2D_POIS", "fas")
    solo = tcases.make_sim("cavity", level=3, device="cpu")
    split = tcases.make_sim("cavity", level=3,
                            mesh=make_mesh(devices=["cpu"] * 4))
    assert split.kernel_tier == "plain-bf16+bc(ns,ns,ns,ns(1,0))"
    assert split.smoother_tier == "strip+bf16"
    for _ in range(3):
        a, b = solo.step_once(), split.step_once()
        assert a["poisson_iters"] == b["poisson_iters"]
    st = unshard_state(split.state)
    assert torch.equal(st.vel, solo.state.vel)
    assert torch.equal(st.pres, solo.state.pres)


def test_exchange_keeps_bc_slabs_local():
    """A slab's halo BC lab reads only its own columns and its aux: a
    change outside the aux columns leaves it as it was."""
    mesh = make_mesh(devices=["cpu"] * 4)
    tt = _pair("outflow_y")[1]
    v = torch.tensor(_rand((1, 2, NY, NX), 70, np.float64))
    s = split_x(v, mesh)
    aux = exchange_x(s, 3)
    lab = tbc.pad_vector_bc_slab(s.parts[1], aux[1], 3, tt, H, None, 16, NX,
                                 False, False)
    v2 = v.clone()
    v2[..., :12] += 1.0
    v2[..., 36:] -= 1.0
    s2 = split_x(v2, mesh)
    lab2 = tbc.pad_vector_bc_slab(s2.parts[1], exchange_x(s2, 3)[1], 3, tt,
                                  H, None, 16, NX, False, False)
    assert torch.equal(lab, lab2)
