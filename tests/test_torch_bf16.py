"""The bf16 storage tier (``CUP2D_PREC=bf16``) of the port against the JAX
package's, on the CPU: the plain twins of the four bf16 kernel forms
against the JAX package's Pallas kernels in interpret mode (per shard for
the split ones: the JAX package's shard_map oracle is broken under jax
0.9.0), the FAS solver's bf16 legs, the bf16 Taylor-Green run, the split
step against the solo one, and the latch's refusals and labels. Inputs are
made with numpy from a seed; both packages get the same bf16 values.

"1 bf16 ulp" is 2^-7 max |ref|: a bf16 result of either package is the
f32 result rounded once, and the two f32 results differ by a few f32 ulp
(FMA contraction, the order of the JAX kernel's sums), so a rounding that
falls on the other side of a bf16 midpoint moves one bf16 ulp and nothing
else moves. Where the outputs are f32 (the second substage) the f32 bar
applies: 2e-6 relative to max |ref|.

The kernels themselves run on the card: tests/test_torch_cuda.py."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu.bc import BCTable as JTable  # noqa: E402
from cup2d_tpu.cases import channel_table as jchannel  # noqa: E402
from cup2d_tpu.cases import cavity_table as jcavity  # noqa: E402
from cup2d_tpu.config import SimConfig as JConfig  # noqa: E402
from cup2d_tpu.ops import pallas_kernels as jpk  # noqa: E402
from cup2d_tpu.poisson import MultigridPreconditioner as JMG  # noqa: E402
from cup2d_tpu.poisson import mg_solve as jmg_solve  # noqa: E402
from cup2d_tpu.uniform import UniformGrid as JGrid  # noqa: E402
from cup2d_tpu.uniform import UniformSim as JSim  # noqa: E402
from cup2d_tpu.uniform import taylor_green_state as jtg  # noqa: E402
from cup2d_tpu_torch import SimConfig, UniformGrid, UniformSim  # noqa: E402
from cup2d_tpu_torch import cases as tcases  # noqa: E402
from cup2d_tpu_torch import poisson as tpoisson  # noqa: E402
from cup2d_tpu_torch.amr import AMRSim  # noqa: E402
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from cup2d_tpu_torch.parallel import shard_halo  # noqa: E402
from cup2d_tpu_torch.parallel.mesh import (ShardedUniformSim,  # noqa: E402
                                           make_mesh, unshard_state)
from cup2d_tpu_torch.poisson import (MultigridPreconditioner,  # noqa: E402
                                     mg_solve)
from cup2d_tpu_torch.uniform import bench_state  # noqa: E402
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


pytestmark = pytest.mark.skipif(not jpk.HAVE_PALLAS,
                                reason="needs jax.experimental.pallas")

NY, NX = 32, 64
H = 1.0 / NX
NU = 4e-5
IH2 = 1.0 / (H * H)
BF16_ULP = 2.0 ** -7      # relative to max |ref|
EQUAL_SHARE = 0.99        # bf16 outputs bit-equal to the JAX kernel's
F32_REL = 2e-6            # f32 outputs (the second substage)
SIGNS = (1.0, -1.0, 1.0, 1.0)
LANES = 128               # the JAX halo kernels' lane-padded aux width
TABLES = {"free_slip": (None, None),
          "cavity": (jcavity(1.0), tcases.cavity_table(1.0)),
          "channel_parabolic": (jchannel(1.0, profile="parabolic"),
                                tcases.channel_table(1.0,
                                                     profile="parabolic"))}

_jitted = {}


def _bf16(shape, seed, scale=1.0):
    """Seeded normal values that bf16 holds exactly: (f32 numpy, bf16
    torch)."""
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    t = torch.tensor(a, dtype=torch.float32).to(torch.bfloat16)
    return t.float().numpy(), t


def _jb(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _np(x):
    """f32 numpy of a JAX or torch array of any float dtype."""
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_bf16_close(got, ref, ulps=1, label=""):
    got, ref = _np(got), _np(ref)
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    share = np.mean(got == ref)
    assert err <= ulps * BF16_ULP, (label, err)
    assert share >= EQUAL_SHARE, (label, share)


def _assert_f32_close(got, ref, label=""):
    got, ref = _np(got), _np(ref)
    rel = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert rel <= F32_REL, (label, rel)


def _facs(L, bc):
    """Per-member (afac, dfac[, dt]) of a ragged member stack."""
    dt = np.asarray([0.5, 0.35, 0.27][:L], np.float32) * H
    cols = [-dt * H, NU * dt] + ([dt] if bc is not None else [])
    return np.stack(cols, -1).astype(np.float32)


def _pallas_substage(v, vold, facs, cfac, out_dtype, table):
    key = ("solo", v.shape, vold is None, cfac, out_dtype, table)
    if key not in _jitted:
        bc = TABLES[table][0]

        def run(v, vold, facs):
            return jpk._fused_substage(v, vold, facs, cfac, IH2, out_dtype,
                                       True, bc, H)
        _jitted[key] = jax.jit(run)
    return _jitted[key](v, vold, facs)


# ---------------------------------------------------------------------------
# K2: the substage pair's bf16 form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", sorted(TABLES))
def test_substage_bf16_twins_vs_pallas(table):
    """Substage 1 (bf16 -> bf16) on a 3-member stack with per-member dt,
    then substage 2 given the SAME bf16 v1 and copy vb on both sides (bf16
    -> f32): the f32 bar."""
    jbc, tbc = TABLES[table]
    L = 3
    vnp, vb = _bf16((L, 2, NY, NX), 1)
    facs = _facs(L, jbc)
    ref1 = _pallas_substage(_jb(vnp), None, jnp.asarray(facs), 0.5,
                            jnp.bfloat16, table)
    got1 = hk.advect_substage(vb, None, torch.tensor(facs), 0.5, IH2, tbc, H)
    assert got1.dtype == torch.bfloat16
    _assert_bf16_close(got1, ref1, label=f"{table} substage 1")
    # the same bf16 v1 on both sides
    v1 = got1
    ref2 = _pallas_substage(_jb(v1.float().numpy()), _jb(vnp),
                            jnp.asarray(facs), 1.0, jnp.float32, table)
    got2 = hk.advect_substage(v1, vb, torch.tensor(facs), 1.0, IH2, tbc, H,
                              out_dtype=torch.float32)
    assert got2.dtype == torch.float32
    _assert_f32_close(got2, ref2, f"{table} substage 2")


# the pair against the JAX package's: 1.6e-7 relative under each table
# (this twin's bf16 first substage is bit-equal to the interpret kernel's
# on these inputs, so what is left is f32 rounding of the second), held
# at the f32 bar; the bf16 tier itself moves the pair 3.3e-3 (cavity) and
# 4.3e-3 relative from the f32 pair
PAIR_REL = 2e-6


@pytest.mark.parametrize("table", sorted(TABLES))
def test_bf16_pair_vs_pallas(table):
    """The whole ``fused_advect_heun(bf16=True)`` against the JAX package's,
    f32 state in and out: inside the JAX package's own 2e-2 bf16 band, and
    at PAIR_REL in practice."""
    jbc, tbc = TABLES[table]
    vnp, _ = _bf16((2, 2, NY, NX), 2)
    dt = np.asarray([0.5, 0.3], np.float32) * H
    ref = jpk.fused_advect_heun(jnp.asarray(vnp), H, NU, jnp.asarray(dt),
                                bc=jbc, bf16=True, interpret=True)
    got = hk.fused_advect_heun(torch.tensor(vnp), H, NU, torch.tensor(dt),
                               bc=tbc, bf16=True)
    assert got.dtype == torch.float32
    ref = np.asarray(ref)
    rel = np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref))
    assert rel <= min(PAIR_REL, 2e-2), rel
    # and it is the bf16 tier: the f32 pair differs by far more than f32
    # rounding
    f32 = hk.fused_advect_heun(torch.tensor(vnp), H, NU, torch.tensor(dt),
                               bc=tbc)
    assert float((got - f32).abs().max() / f32.abs().max()) > 1e-3


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


def _pallas_halo_substage(v, vold, aux, info, facs, cfac, out_dtype):
    key = ("halo", v.shape, vold is None, cfac, out_dtype)
    if key not in _jitted:
        def run(v, vold, aux, info, facs):
            return jpk._fused_substage_sharded(
                v, vold, aux, info, facs, cfac, IH2, out_dtype, JTable(), H,
                NX, True)
        _jitted[key] = jax.jit(run)
    return _jitted[key](v, vold, aux, info, facs)


@pytest.mark.parametrize("D", [1, 4])
def test_halo_substage_bf16_twin_vs_pallas(D):
    """Per shard, both substages, the aux columns in bf16; D = 1 and D = 4
    cover the four wall combinations (both, low only, none, high only)."""
    vnp, vb = _bf16((1, 2, NY, NX), 3 + D)
    facs = _facs(1, True)
    ft = torch.tensor(facs[:, :2])
    # substage 2's bf16 input: the whole field's first substage
    s1np = _np(hk.advect_substage(vb, None, ft, 0.5, IH2))
    w = NX // D
    for d in range(D):
        sl = slice(d * w, (d + 1) * w)
        lo, hi = d == 0, d == D - 1
        info = jnp.asarray([[lo, hi, d * w]], jnp.int32)
        ref1 = _pallas_halo_substage(
            _jb(vnp[..., sl]), None, _jb(_shard_aux(vnp, d, D, 3, LANES)),
            info, jnp.asarray(facs), 0.5, jnp.bfloat16)
        got1 = hk.advect_substage_halo(
            vb[..., sl].contiguous(), None,
            torch.tensor(_shard_aux(vnp, d, D, 3)).bfloat16(), ft, 0.5, IH2,
            lo, hi)
        _assert_bf16_close(got1, ref1, label=f"shard {d}/{D} substage 1")
        # substage 2 from the same bf16 inputs, the copy as vold
        ref2 = _pallas_halo_substage(
            _jb(s1np[..., sl]), _jb(vnp[..., sl]),
            _jb(_shard_aux(s1np, d, D, 3, LANES)), info, jnp.asarray(facs),
            1.0, jnp.float32)
        got2 = hk.advect_substage_halo(
            torch.tensor(s1np[..., sl]).bfloat16(), vb[..., sl].contiguous(),
            torch.tensor(_shard_aux(s1np, d, D, 3)).bfloat16(), ft, 1.0,
            IH2, lo, hi, out_dtype=torch.float32)
        _assert_f32_close(got2, ref2, f"shard {d}/{D} substage 2")


# ---------------------------------------------------------------------------
# K6, K7: the sweep chain and the halo sweep on bf16 legs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("signs", [None, SIGNS])
@pytest.mark.parametrize("from_zero", [False, True])
def test_sweep_chain_bf16_twin_vs_pallas(n, signs, from_zero):
    """Every sweep rounded to bf16 once: at most n bf16 ulps apart."""
    enp, e = _bf16((2, NY, NX), 10 + n)
    rnp, r = _bf16((2, NY, NX), 20 + n)
    key = ("chain", n, signs, from_zero)
    if key not in _jitted:
        _jitted[key] = jax.jit(lambda e, r: jpk.fused_jacobi_sweeps(
            e, r, 0.8, n, edge_signs=signs, from_zero=from_zero,
            interpret=True))
    ref = _jitted[key](_jb(enp), _jb(rnp))
    got = hk.fused_jacobi_sweeps(None if from_zero else e, r, 0.8, n,
                                 from_zero, signs)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got, ref, ulps=n, label=(n, signs, from_zero))


def test_strip_bf16_storage_f32_accumulate():
    """The JAX package's own bar (tests/test_strip_smoother.py): the bf16
    chain tracks the f32 chain to bf16 resolution, 2e-2 of max |ref|."""
    rnp, r = _bf16((32, 128), 3)
    enp, e = _bf16((32, 128), 4)
    got = hk.fused_jacobi_sweeps(e, r, 0.8, 2)
    assert got.dtype == torch.bfloat16
    ref = hk.jacobi_sweeps_plain(torch.tensor(enp), torch.tensor(rnp), 0.8,
                                 2)
    err = float((got.float() - ref).abs().max())
    assert err <= 2e-2 * float(ref.abs().max())


@pytest.mark.parametrize("D", [1, 2, 4])
def test_halo_sweep_bf16_twin_vs_pallas(D):
    enp, e = _bf16((NY, NX), 30 + D)
    rnp, r = _bf16((NY, NX), 40 + D)
    w = NX // D
    for d in range(D):
        sl = slice(d * w, (d + 1) * w)
        key = ("sweep", w)
        if key not in _jitted:
            _jitted[key] = jax.jit(lambda e, r, a, i:
                                   jpk.fused_jacobi_halo_sweep(
                                       e, r, a, i, 0.8, interpret=True))
        ref = _jitted[key](_jb(enp[:, sl]), _jb(rnp[:, sl]),
                           _jb(_shard_aux(enp, d, D, 1, LANES)),
                           jnp.asarray([[d == 0, d == D - 1]], jnp.int32))
        got = hk.jacobi_halo_sweep(
            e[:, sl].contiguous(), r[:, sl].contiguous(),
            torch.tensor(_shard_aux(enp, d, D, 1)).bfloat16(), 0.8, d == 0,
            d == D - 1)
        assert got.dtype == torch.bfloat16
        _assert_bf16_close(got, ref, label=(D, d))


def test_bf16_sweep_chain_cut_does_not_change_the_result():
    """A bf16 chain rounds every sweep wherever it keeps it, so launches
    of 6, 2 and 1 sweeps give one launch's result; the split halo sweeps
    give the chain's bit for bit, on 2 and 4 slabs."""
    assert hk.sweep_chain(24, bf16=True) == [6, 6, 6, 6]
    assert hk.sweep_chain(5, bf16=True) == [2, 2, 1]
    assert hk.sweep_chain(3, bf16=True) == [2, 1]
    assert hk.sweep_chain(2, bf16=True) == [2]
    _, e = _bf16((NY, NX), 50)
    _, r = _bf16((NY, NX), 51)
    for n in (1, 2, 3, 7):
        for fz in (False, True):
            whole = hk.fused_jacobi_sweeps(e, r, 0.8, n, fz)
            one = None if fz else e
            for k in range(n):
                one = hk.fused_jacobi_sweeps(one, r, 0.8, 1, fz and k == 0)
            assert torch.equal(whole, one), (n, fz)
            for D in (2, 4):
                mesh = make_mesh(devices=["cpu"] * D)
                split = shard_halo.overlap_jacobi_sweeps(
                    shard_halo.split_x(e, mesh), shard_halo.split_x(r, mesh),
                    0.8, n, fz)
                assert torch.equal(shard_halo.gather_x(split), whole)


# ---------------------------------------------------------------------------
# the FAS solver's bf16 legs
# ---------------------------------------------------------------------------

def _bench_rhs(size=128):
    """The 128^2 bench state's Poisson RHS at dt = h/2 (f32 numpy), and
    both packages' grids."""
    kw = dict(bpdx=1, bpdy=1, level_max=1, level_start=0, extent=1.0,
              nu=4e-5, cfl=0.5, dtype="float32")
    level = (size // 8).bit_length() - 1
    tg = UniformGrid(SimConfig(**kw), level=level, device="cpu")
    st = bench_state(tg)
    b = tg.poisson_rhs(st.vel, None, None, torch.tensor(0.5 * tg.h))
    return b, tg, JGrid(JConfig(**kw), level=level)


def test_bf16_leg_mg_solve_same_criterion():
    """bf16 legs under mg_solve's f32 true-residual loop converge by the
    same Linf criterion within +1 cycle of the f32 legs (the JAX
    package's bar, tests/test_strip_smoother.py), and the port's count
    equals the JAX package's or is within +1 of it."""
    b, tg, jg = _bench_rhs()
    iters = {}
    for name, leg in (("f32", None), ("bf16", torch.bfloat16)):
        mg = MultigridPreconditioner(tg.ny, tg.nx, torch.float32,
                                     cycle_dtype=torch.float32,
                                     fused_smoother=True, leg_dtype=leg)
        assert mg.smoother_tier == ("strip" if leg is None else "strip+bf16")
        assert mg(b).dtype == torch.float32
        res = mg_solve(tg.laplacian, b, mg, tol=0.0, tol_rel=1e-3,
                       max_cycles=100)
        assert res.converged, name
        iters[name] = res.iters
        jmg = JMG(jg.ny, jg.nx, jnp.float32, cycle_dtype=jnp.float32,
                  leg_dtype=None if leg is None else jnp.bfloat16,
                  smoother="strip")
        jres = jmg_solve(jg.laplacian, jnp.asarray(b.numpy()), jmg, tol=0.0,
                         tol_rel=1e-3, max_cycles=100)
        assert bool(jres.converged), name
        assert int(jres.iters) <= res.iters <= int(jres.iters) + 1, (
            name, res.iters, int(jres.iters))
    assert iters["bf16"] <= iters["f32"] + 1, iters


# ---------------------------------------------------------------------------
# the step under CUP2D_PREC=bf16
# ---------------------------------------------------------------------------

def _cfg32(**kw):
    base = dict(bpdx=1, bpdy=1, level_max=1, level_start=0, extent=1.0,
                nu=NU, cfl=0.4, dtype="float32", max_poisson_iterations=60)
    base.update(kw)
    return base


# port bf16 against the JAX package's bf16 tier after 10 steps: 1.2e-7
# (f32 rounding of a unit-scale field), while bf16 storage moves both
# packages 3.85e-3 from their f32 runs, and the port's f32 run is 2.4e-7
# from the JAX package's
TG_JAX_ABS = 1e-6


def test_bf16_taylor_green(monkeypatch):
    """10 steps of the 32^2 Taylor-Green at a fixed dt = h/4: the bf16 tier
    inside the JAX package's bf16 band of the f32 run (0 < dv <= 2e-2,
    tests/test_megakernel.py), and near the JAX package's bf16 tier."""
    monkeypatch.delenv("CUP2D_POIS", raising=False)
    monkeypatch.delenv("CUP2D_PALLAS", raising=False)
    monkeypatch.setenv("CUP2D_PREC", "f32")
    ref = UniformSim(SimConfig(**_cfg32()), level=2, device="cpu")
    ref.state = taylor_green_state(ref.grid)
    monkeypatch.setenv("CUP2D_PREC", "bf16")
    sim = UniformSim(SimConfig(**_cfg32()), level=2, device="cpu")
    assert (sim.kernel_tier, sim.prec_mode) == ("plain-bf16", "bf16")
    sim.state = taylor_green_state(sim.grid)
    monkeypatch.setenv("CUP2D_PALLAS", "1")
    js = JSim(JConfig(**_cfg32()), level=2)
    assert js.kernel_tier == "pallas-fused-bf16"
    js.state = jtg(js.grid)
    dt = 0.25 * sim.grid.h
    for _ in range(10):
        sim.step_once(dt)
        ref.step_once(dt)
        js.step_once(dt)
    vel = sim.state.vel.numpy()
    assert np.all(np.isfinite(vel))
    dv = np.max(np.abs(vel - ref.state.vel.numpy()))
    assert 0.0 < dv <= 2e-2, dv
    dj = np.max(np.abs(vel - np.asarray(js.state.vel)))
    assert dj <= TG_JAX_ABS, dj


@pytest.mark.parametrize("pois", ["", "fas"])
@pytest.mark.parametrize("D", [2, 4])
def test_split_bf16_step_equals_solo(monkeypatch, pois, D):
    """ShardedUniformSim under bf16 equals the solo bf16 step bit for bit
    with equal iterations: two exact startup steps and three production
    steps from the benchmark state at 64^2."""
    monkeypatch.setenv("CUP2D_PREC", "bf16")
    monkeypatch.setenv("CUP2D_POIS", pois)
    cfg = SimConfig(**_cfg32(nu=4e-5, cfl=0.5))
    solo = UniformSim(cfg, level=3, device="cpu")
    split = ShardedUniformSim(cfg, make_mesh(devices=["cpu"] * D), level=3)
    assert split.kernel_tier == solo.kernel_tier == "plain-bf16"
    assert split.grid.smoother_tier == solo.grid.smoother_tier
    start = bench_state(solo.grid)
    solo.state = start
    split.set_state(start)
    solo.step_count = split.step_count = 8
    for _ in range(5):
        a = solo.step_once(0.5 * solo.grid.h)
        b = split.step_once(0.5 * solo.grid.h)
        assert a["poisson_iters"] == b["poisson_iters"]
    got = unshard_state(split.state)
    assert torch.equal(got.vel, solo.state.vel)
    assert torch.equal(got.pres, solo.state.pres)


# ---------------------------------------------------------------------------
# the latch: refusals, labels, and which smoother each solver runs
# ---------------------------------------------------------------------------

def test_bf16_latch_refusals(monkeypatch):
    monkeypatch.setenv("CUP2D_PREC", "bf16")
    monkeypatch.delenv("CUP2D_POIS", raising=False)
    UniformGrid(SimConfig(**_cfg32()), level=1, device="cpu")      # 16^2
    with pytest.raises(ValueError, match="bf16.*ny % 16"):
        UniformGrid(SimConfig(**_cfg32()), level=0, device="cpu")  # 8^2
    with pytest.raises(ValueError, match="bf16"):
        UniformGrid(SimConfig(**_cfg32(bpdy=3, bpdx=3)), level=0,
                    device="cpu")                                 # 24^2
    with pytest.raises(ValueError, match="bf16.*f32 state"):
        UniformGrid(SimConfig(**_cfg32(dtype="float64")), level=2,
                    device="cpu")
    monkeypatch.setenv("CUP2D_POIS", "fas")
    # the forest's bf16 FAS legs need f32 state (and fas, as here)
    with pytest.raises(ValueError, match="CUP2D_PREC=bf16 needs f32"):
        AMRSim(SimConfig(**_cfg32(level_max=3, level_start=1,
                                  dtype="float64")), shapes=[],
               device="cpu")
    monkeypatch.setenv("CUP2D_PREC", "bf8")
    with pytest.raises(ValueError, match="f32|bf16"):
        UniformGrid(SimConfig(**_cfg32()), level=2, device="cpu")
    with pytest.raises(ValueError, match="f32 state"):
        hk.fused_advect_heun(torch.zeros(1, 2, 16, 16, dtype=torch.float64),
                             H, NU, H, bf16=True)


@pytest.mark.parametrize("pois", ["", "fas"])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_bf16_labels_match_the_reference(monkeypatch, pois, prec):
    """kernel_tier, prec_mode and smoother_tier read as the JAX package's
    (its fused tier, CUP2D_PALLAS=1, is the port's only tier)."""
    monkeypatch.setenv("CUP2D_PREC", prec)
    monkeypatch.setenv("CUP2D_POIS", pois)
    monkeypatch.setenv("CUP2D_PALLAS", "1")
    kw = _cfg32()
    for bc in (None, "cavity"):
        tsim = UniformSim(SimConfig(**kw), level=2, device="cpu",
                          bc=None if bc is None else tcases.cavity_table())
        jsim = JSim(JConfig(**kw), level=2,
                    bc=None if bc is None else jcavity())
        jt, tt = jsim.kernel_tier, tsim.kernel_tier
        assert tt == jt.replace("pallas-fused", "plain"), (jt, tt)
        assert tsim.prec_mode == jsim.prec_mode == prec
        assert tsim.smoother_tier == jsim.smoother_tier, (
            jsim.smoother_tier, tsim.smoother_tier)


@pytest.mark.parametrize("pois", ["", "fas"])
def test_default_cycle_does_not_run_the_bf16_chain(monkeypatch, pois):
    """Under bf16 the FAS cycle's chains go through the kernel wrapper
    (bf16 legs, the bf16 chain and halo-sweep forms), the default solver's
    bf16 preconditioner cycle through the plain sweeps, solo and split."""
    calls = {"chain": 0, "halo": 0}

    def counting(name, fn):
        def call(*a, **k):
            calls[name] += 1
            r = a[1][0] if isinstance(a[1], list) else a[1]
            assert r.dtype == torch.bfloat16
            return fn(*a, **k)
        return call
    monkeypatch.setattr(tpoisson, "fused_jacobi_sweeps",
                        counting("chain", hk.fused_jacobi_sweeps))
    # the split levels' halo sweeps: the slab list on a one-device mesh,
    # the per-slab wrapper on slabs of several devices
    monkeypatch.setattr(shard_halo, "jacobi_halo_sweep",
                        counting("halo", hk.jacobi_halo_sweep))
    monkeypatch.setattr(shard_halo, "jacobi_halo_sweep_slabs",
                        counting("halo", hk.jacobi_halo_sweep_slabs))
    monkeypatch.setenv("CUP2D_PREC", "bf16")
    monkeypatch.setenv("CUP2D_POIS", pois)
    cfg = SimConfig(**_cfg32())
    for sim in (UniformSim(cfg, level=2, device="cpu"),
                ShardedUniformSim(cfg, make_mesh(devices=["cpu"] * 2),
                                  level=2)):
        st = taylor_green_state(sim.grid)
        if isinstance(sim, ShardedUniformSim):
            sim.set_state(st)
        else:
            sim.state = st
        sim.step_count = 10
        sim.step_once(0.25 * sim.grid.h)
    if pois == "fas":
        assert calls["chain"] > 0 and calls["halo"] > 0, calls
    else:
        assert calls == {"chain": 0, "halo": 0}, calls


def test_cpu_bf16_wrappers_take_the_twin_and_count_nothing():
    hk.reset_launches()
    vnp, vb = _bf16((1, 2, NY, NX), 60)
    facs = torch.tensor(_facs(1, None))
    assert torch.equal(hk.advect_substage(vb, None, facs, 0.5, IH2),
                       hk.advect_substage_plain(vb, None, facs, 0.5, IH2))
    _, e = _bf16((NY, NX), 61)
    assert torch.equal(hk.fused_jacobi_sweeps(e, e, 0.8, 2),
                       hk.jacobi_sweeps_bf16_plain(e, e, 0.8, 2))
    aux = e[:, :2].contiguous()
    assert torch.equal(hk.jacobi_halo_sweep(e, e, aux, 0.8, 1, 0),
                       hk.jacobi_halo_sweep_bf16_plain(e, e, aux, 0.8, 1, 0))
    assert hk.launches == {k: 0 for k in hk.launches}
    assert not hk._fns, "a CPU call must not build or load a kernel"
    for k in hk.launches:
        assert hk.kernel_of(k) in hk.REPLACES


@pytest.fixture(autouse=True)
def _no_env_leak(monkeypatch):
    for k in ("CUP2D_PREC", "CUP2D_POIS", "CUP2D_PALLAS"):
        if k in os.environ:
            monkeypatch.delenv(k)
