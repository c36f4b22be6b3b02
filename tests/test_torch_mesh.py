"""Port parity for the x-split sharded uniform step on CPU slab meshes.

* ``ShardedUniformSim`` on the JAX package's own mesh test shape (level 3,
  128 x 64, f64, Taylor-Green; tests/test_mesh.py), one exact tol-0
  startup step and two production steps, under the default solver, fas
  and fas-f, for D in {2, 4, 8}: <= 1e-12 from the port's solo
  ``UniformSim`` and <= 1e-10 from the JAX package's single-device
  ``UniformSim``, with equal iteration counts. Only the reductions'
  order differs from the solo step. Tolerances 1e-9 absolute (none
  relative), so that the production solves iterate after the exact
  startup solve (at the default 1e-3 they converge in 0 iterations).
* The split V-cycle, F-cycle and FAS cycle equal the solo ones bit for
  bit (every level split, or the coarse ones gathered).
* The state lives as slabs of width Nx/D; the refusals are loud (fftd
  refuses a mesh; wall-bounded and periodic tables run, and so do the
  obstacle terms)."""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.uniform import UniformSim as JSim  # noqa: E402
from cup2d_tpu.uniform import taylor_green_state as jtg  # noqa: E402
from cup2d_tpu_torch import UniformSim  # noqa: E402
from cup2d_tpu_torch.convert import config_from_dict  # noqa: E402
from cup2d_tpu_torch.parallel.mesh import (  # noqa: E402
    ShardedUniformSim, make_mesh, unshard_state)
from cup2d_tpu_torch.parallel.shard_halo import (  # noqa: E402
    fused_advect_heun_sharded, gather_x, split_x)
from cup2d_tpu_torch.poisson import MultigridPreconditioner  # noqa: E402
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


LEVEL = 3          # 128 x 64 cells
SOLO_BAR = 1e-12
JAX_BAR = 1e-10
STEPS = 3


def _cfg_kw():
    return dict(bpdx=2, bpdy=1, level_max=1, level_start=0, extent=2.0,
                nu=1e-3, cfl=0.4, dtype="float64", poisson_tol=1e-9,
                poisson_tol_rel=0.0)


def _tcfg():
    return config_from_dict(dataclasses.asdict(SimConfig(**_cfg_kw())))


def _cpu_mesh(D):
    return make_mesh(devices=["cpu"] * D)


def _advance(sim, k):
    """Step k of the trajectory: the first is an exact startup solve."""
    return sim.advance(1, exact_first_steps=k == 0)


@functools.lru_cache(maxsize=None)
def _references(pois):
    """Per step: (JAX vel, port solo vel, iterations of both)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CUP2D_POIS", pois)
    try:
        js = JSim(SimConfig(**_cfg_kw()), level=LEVEL)
        js.state = jtg(js.grid)
        ts = UniformSim(_tcfg(), level=LEVEL, device="cpu")
        ts.state = taylor_green_state(ts.grid)
        out = []
        for k in range(STEPS):
            jd = _advance(js, k)
            td = _advance(ts, k)
            out.append((np.asarray(js.state.vel), ts.state.vel.clone(),
                        int(jd["poisson_iters"]), td["poisson_iters"]))
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("pois", ["", "fas", "fas-f"])
@pytest.mark.parametrize("D", [2, 4, 8])
def test_sharded_trajectory_matches_solo_and_jax(monkeypatch, pois, D):
    refs = _references(pois)
    monkeypatch.setenv("CUP2D_POIS", pois)
    sh = ShardedUniformSim(_tcfg(), _cpu_mesh(D), level=LEVEL)
    sh.set_state(taylor_green_state(sh.grid))
    for k, (jvel, tvel, jit, tit) in enumerate(refs):
        d = _advance(sh, k)
        assert d["poisson_iters"] == tit == jit > 0, (k, d, tit, jit)
        vel = unshard_state(sh.state).vel
        assert float((vel - tvel).abs().max()) <= SOLO_BAR, k
        assert np.max(np.abs(vel.numpy() - jvel)) <= JAX_BAR, k


def test_state_is_slabs_and_diag_keys_match(monkeypatch):
    monkeypatch.delenv("CUP2D_POIS", raising=False)
    D = 4
    sh = ShardedUniformSim(_tcfg(), _cpu_mesh(D), level=LEVEL)
    sh.set_state(taylor_green_state(sh.grid))
    solo = UniformSim(_tcfg(), level=LEVEL, device="cpu")
    solo.state = taylor_green_state(solo.grid)
    assert set(sh.step_once()) == set(solo.step_once())
    nx, ny = sh.grid.nx, sh.grid.ny
    for field in sh.state:
        assert len(field.parts) == D
        for d, p in enumerate(field.parts):
            assert p.shape[-2:] == (ny, nx // D)
            assert p.device == sh.mesh.devices[d]


def test_nonsolenoidal_kick_iterates(monkeypatch):
    """The Krylov loop itself runs on the split fields (the JAX package's
    test_sharded_poisson_iterates)."""
    monkeypatch.delenv("CUP2D_POIS", raising=False)
    sh = ShardedUniformSim(_tcfg(), _cpu_mesh(8), level=LEVEL)
    state = taylor_green_state(sh.grid)
    kick = 0.1 * torch.sin(torch.linspace(0, 3.0, sh.grid.nx,
                                          dtype=torch.float64))
    vel = state.vel.clone()
    vel[0] += kick[None, :]
    sh.set_state(state._replace(vel=vel))
    diag = sh.advance(1)
    assert diag["poisson_iters"] > 0
    assert bool(torch.isfinite(unshard_state(sh.state).vel).all())


@pytest.mark.parametrize("fas", [False, True])
@pytest.mark.parametrize("D", [2, 8])
def test_split_cycles_equal_solo_bit_for_bit(fas, D):
    """The bf16 preconditioner V-cycle (plain sweeps) and the f64 FAS
    V- and F-cycles (the halo-sweep wrapper), split over D slabs with
    coarse levels gathered at D = 8, against the solo cycles."""
    ny, nx = 64, 128
    dtype = torch.float64 if fas else torch.float32
    kw = dict(cycle_dtype=dtype if fas else None, fused_smoother=fas)
    solo = MultigridPreconditioner(ny, nx, dtype, **kw)
    split = MultigridPreconditioner(ny, nx, dtype, mesh=_cpu_mesh(D), **kw)
    sizes = [m.size for m in split.meshes]
    assert sizes[0] == D and (min(sizes) == 1) == (D == 8)
    r = torch.tensor(np.random.default_rng(D).standard_normal((ny, nx)),
                     dtype=dtype)
    rs = split_x(r, _cpu_mesh(D))
    assert torch.equal(gather_x(split(rs)), solo(r))
    if fas:
        assert torch.equal(gather_x(split.fcycle(rs)), solo.fcycle(r))


def test_make_mesh(monkeypatch):
    assert make_mesh(devices=["cpu"] * 3).size == 3
    assert make_mesh(2, devices=["cpu"] * 3).size == 2
    with pytest.raises(ValueError, match="need 4 devices"):
        make_mesh(4, devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


@pytest.mark.parametrize("env,value,exc,match", [
    # fftd needs a periodic axis (the default box has none); with one it
    # refuses the mesh (test_geometry_and_table_refusals)
    ("CUP2D_POIS", "fftd", ValueError, "fftd"),
    # bf16 runs on f32 state; this config is f64, which it refuses
    ("CUP2D_PREC", "bf16", ValueError, "bf16"),
])
def test_latches_refuse(monkeypatch, env, value, exc, match):
    monkeypatch.setenv(env, value)
    with pytest.raises(exc, match=match):
        ShardedUniformSim(_tcfg(), _cpu_mesh(2), level=LEVEL)


def test_geometry_and_table_refusals(monkeypatch):
    monkeypatch.delenv("CUP2D_POIS", raising=False)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedUniformSim(_tcfg(), _cpu_mesh(3), level=LEVEL)
    from cup2d_tpu_torch.bc import BCTable, periodic
    from cup2d_tpu_torch.cases import cavity_table, make_sim
    # a wall-bounded table runs split (tests/test_torch_split_bc.py), and
    # so does a periodic one (tests/test_torch_mesh_periodic.py), at the
    # mesh and at the split substage; fftd refuses any mesh
    sh = ShardedUniformSim(_tcfg(), _cpu_mesh(2), level=LEVEL,
                           bc=cavity_table())
    assert sh.bc_table == "ns,ns,ns,ns(1,0)"
    assert make_sim("cavity", level=2, mesh=_cpu_mesh(2)).case == "cavity"
    pd_fs = BCTable(periodic(), periodic())
    sh = ShardedUniformSim(_tcfg(), _cpu_mesh(2), level=LEVEL, bc=pd_fs)
    assert sh.bc_table == "pd,pd,fs,fs"
    whole = torch.tensor(np.random.default_rng(2).standard_normal(
        (2, 16, 32)))
    v = split_x(whole, _cpu_mesh(2))
    from cup2d_tpu_torch.ops.hopper_kernels import fused_advect_heun_plain
    assert torch.equal(
        gather_x(fused_advect_heun_sharded(v, 1 / 32, 1e-3, 1e-3,
                                           bc=pd_fs)),
        fused_advect_heun_plain(whole, 1 / 32, 1e-3, 1e-3, bc=pd_fs))
    monkeypatch.setenv("CUP2D_POIS", "fftd")
    with pytest.raises(ValueError, match="cannot attach a device mesh"):
        ShardedUniformSim(_tcfg(), _cpu_mesh(2), level=LEVEL, bc=pd_fs)
    monkeypatch.delenv("CUP2D_POIS")
    # the split step takes the obstacle terms (tests/test_torch_split_
    # obstacle.py): with no solid (chi = 0) they leave it unchanged
    sh = ShardedUniformSim(_tcfg(), _cpu_mesh(2), level=LEVEL)
    sh.set_state(taylor_green_state(UniformSim(_tcfg(), level=LEVEL,
                                               device="cpu").grid))
    with_terms, _ = sh.grid.step(sh.state, 1e-3)
    without, _ = sh.grid.step(sh.state, 1e-3, obstacle_terms=False)
    for a, b in zip(unshard_state(with_terms), unshard_state(without)):
        assert torch.equal(a, b)

