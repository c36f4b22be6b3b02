"""Kernel 8's preconditioner forms and the Thomas scans' twin, on the CPU.

* ``hopper_kernels.block_precond``'s three forms (P_inv r; e + P_inv r;
  e + P_inv (r - lap) inside a preconditioner) and
  ``fused_block_jacobi_update`` at N = 1, 15, 16, 33 and 1000: bit for
  bit (sign of zero included) the compositions they replace, kernel 8
  with zero operands plus separate sums; within 1e-12 of the JAX
  package's ``apply_block_precond_blocks`` composed the same way, at f64.
* ``AMRSim``'s two-level preconditioners (additive, mg2, mult) on the
  vortex forest: three steps bit for bit the same sim whose
  ``_precond`` runs the earlier compositions, and within 1e-10 of the
  JAX package with equal iterations.
* ``tridiag_scan_plain`` against the JAX ``FFTDiagPlan.solve`` scans on
  ragged shapes, at f64."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import poisson as jp  # noqa: E402
from cup2d_tpu.amr import AMRSim as JSim  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu_torch import poisson as tp  # noqa: E402
from cup2d_tpu_torch.amr import AMRSim as TSim  # noqa: E402
from cup2d_tpu_torch.convert import config_from_dict  # noqa: E402
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from cup2d_tpu_torch.parallel.shard_halo import per_shard  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64_BAR = 1e-12
SCAN_BAR = 1e-14
TRAJ_BAR = 1e-10


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values and equal signs of zero."""
    return torch.equal(a, b) and torch.equal(torch.signbit(a),
                                             torch.signbit(b))


def earlier_precond(r, p_inv, e=None, lap=None):
    """The compositions the preconditioner forms replace: kernel 8 with
    e = lap = 0 on r or r - lap (a torch difference), then e + z."""
    d = r if lap is None else r - lap
    zero = torch.zeros_like(d)
    z = hk.fused_block_jacobi_update(zero, d, zero, p_inv)
    return z if e is None else e + z


def _blocks(n, seed, dtype):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((n, 8, 8)), dtype=dtype)
            for _ in range(3)]


@pytest.mark.parametrize("n", [1, 15, 16, 33, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_precond_forms_are_the_earlier_compositions(n, dtype):
    p_inv = torch.tensor(tp.block_precond_matrix(8), dtype=dtype)
    e, r, lap = _blocks(n, n, dtype)
    hk.reset_launches()
    assert same_bits(hk.block_precond(r, p_inv), earlier_precond(r, p_inv))
    assert torch.equal(hk.block_precond(r, p_inv),
                       hk.block_precond_plain(r, p_inv))
    assert same_bits(hk.block_precond(r, p_inv, e),
                     earlier_precond(r, p_inv, e))
    assert torch.equal(hk.block_precond(r, p_inv, e),
                       e + hk.block_precond_plain(r, p_inv))
    assert same_bits(hk.block_precond(r, p_inv, e, lap),
                     earlier_precond(r, p_inv, e, lap))
    assert same_bits(hk.fused_block_jacobi_update(e, r, lap, p_inv),
                     e + hk.block_precond_plain(r - lap, p_inv))
    assert all(v == 0 for v in hk.launches.values())   # the twins ran


def test_precond_forms_keep_the_sign_of_zero():
    """A -0 product becomes +0 before e is added, as kernel 8 with a zero
    e made it: -0 + (0 + -0) is +0 where -0 + -0 would be -0."""
    p_inv = torch.tensor(tp.block_precond_matrix(8), dtype=torch.float32)
    r = torch.zeros(33, 8, 8)
    r[::2] = -0.0
    e = torch.full_like(r, -0.0)
    for got, want in ((hk.block_precond(r, p_inv),
                       earlier_precond(r, p_inv)),
                      (hk.block_precond(r, p_inv, e),
                       earlier_precond(r, p_inv, e)),
                      (hk.block_precond(r, p_inv, e, r),
                       earlier_precond(r, p_inv, e, r))):
        assert same_bits(got, want)
        assert not bool(torch.signbit(got).any())


@pytest.mark.parametrize("n", [1, 15, 16, 33, 1000])
def test_precond_forms_match_jax_at_f64(n):
    p_np = tp.block_precond_matrix(8)
    p_inv = torch.tensor(p_np)
    e, r, lap = _blocks(n, 100 + n, torch.float64)
    jpinv = jnp.asarray(p_np)

    def jz(d):
        return np.asarray(jp.apply_block_precond_blocks(
            jnp.asarray(d.numpy()), jpinv))

    scale = float(np.abs(jz(r)).max())
    for got, want in (
            (hk.block_precond(r, p_inv), jz(r)),
            (hk.block_precond(r, p_inv, e), e.numpy() + jz(r)),
            (hk.block_precond(r, p_inv, e, lap),
             e.numpy() + jz(r - lap)),
            (hk.fused_block_jacobi_update(e, r, lap, p_inv),
             e.numpy() + jz(r - lap))):
        assert np.abs(got.numpy() - want).max() <= F64_BAR * scale


def test_precond_refuses_lap_without_e():
    r = torch.zeros(4, 8, 8)
    with pytest.raises(ValueError, match="lap without e"):
        hk.block_precond(r, torch.zeros(64, 64), None, r)


def _vortex_cfg():
    return SimConfig(bpdx=1, bpdy=1, level_max=4, level_start=1,
                     extent=1.0, nu=1e-4, cfl=0.4, dtype="float64",
                     max_poisson_iterations=100, poisson_tol=1e-4,
                     poisson_tol_rel=1e-3, rtol=2.0, ctol=0.5)


def _vortex_vel(cfg, blocks, capacity):
    """The Gaussian vortex of tests/test_amr.py, slot layout."""
    bs = cfg.bs
    vals = np.zeros((capacity, 2, bs, bs))
    for (l, i, j), s in blocks.items():
        h = cfg.h_at(l)
        x = (i * bs + np.arange(bs) + 0.5) * h - 0.5
        y = (j * bs + np.arange(bs) + 0.5) * h - 0.5
        X, Y = np.meshgrid(x, y, indexing="xy")
        r2 = X ** 2 + Y ** 2
        ut = 0.5 / (2 * np.pi * np.sqrt(r2 + 1e-12)) \
            * (1 - np.exp(-r2 / (2 * 0.0064)))
        th = np.arctan2(Y, X)
        vals[s, 0] = -ut * np.sin(th)
        vals[s, 1] = ut * np.cos(th)
    return vals


class EarlierSim(TSim):
    """``AMRSim`` whose preconditioner runs the earlier compositions."""

    def _precond(self, r, e=None, lap=None):
        return per_shard(earlier_precond, r, self.p_inv, e, lap)


def _ordered(sim, jax_side):
    sim.sync_fields()
    f = sim.forest
    o = f.order()
    get = (lambda a: np.asarray(a)[o]) if jax_side else \
        (lambda a: a.numpy()[o])
    return get(f.fields["vel"]), get(f.fields["pres"])


@pytest.mark.parametrize("form", ["additive", "mg2", "mult"])
def test_two_level_forms_match_earlier_bits_and_jax(form, monkeypatch):
    """CUP2D_POIS=fft keeps the two-level correction on from the first
    solve; CUP2D_TWOLEVEL picks the form, startup solves included."""
    monkeypatch.setenv("CUP2D_POIS", "fft")
    monkeypatch.setenv("CUP2D_TWOLEVEL", form)
    cfg = _vortex_cfg()
    js = JSim(cfg, shapes=[])
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    ts = TSim(tcfg, shapes=[], device="cpu")
    te = EarlierSim(tcfg, shapes=[], device="cpu")
    vel = _vortex_vel(cfg, js.forest.blocks, js.forest.capacity)
    js.forest.fields["vel"] = jnp.asarray(vel)
    ts.forest.fields["vel"] = torch.tensor(vel)
    te.forest.fields["vel"] = torch.tensor(vel)
    for k in range(3):
        if k == 0:
            assert js.adapt() == ts.adapt() == te.adapt()
        jd, td, ed = js.step_once(), ts.step_once(), te.step_once()
        assert td["poisson_iters"] == ed["poisson_iters"] \
            == int(jd["poisson_iters"]) > 0, k
        assert td["precond_cycles"] == int(jd["precond_cycles"]) > 0, k
        (vt, pt), (ve, pe) = _ordered(ts, False), _ordered(te, False)
        assert same_bits(torch.tensor(vt), torch.tensor(ve)), k
        assert same_bits(torch.tensor(pt), torch.tensor(pe)), k
        vj, pj = _ordered(js, True)
        assert np.abs(vj - vt).max() <= TRAJ_BAR, k
        assert np.abs(pj - pt).max() <= TRAJ_BAR, k
    assert ts.poisson_mode == js.poisson_mode


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


@pytest.mark.parametrize("shape", [(1, 70, 33), (3, 37, 20), (2, 129, 65)])
@pytest.mark.parametrize("signs", [(0.0, 0.0, 1.0, 1.0),
                                   (0.0, 0.0, -1.0, 1.0)])
def test_tridiag_scan_plain_matches_the_jax_scans_on_ragged_shapes(
        shape, signs):
    """Mode counts that are no multiple of the kernel's 32-mode group and
    row counts that are no multiple of its row tile: the plain twin
    against the JAX plan's scans on each plan's own coefficients."""
    L, n_s, nk = shape
    nx = 2 * (nk - 1)
    jplan = jp.FFTDiagPlan(n_s, nx, jnp.float64, True, False, signs)
    tplan = tp.FFTDiagPlan(n_s, nx, torch.float64, True, False, signs,
                           device="cpu")
    assert tuple(tplan.cp.shape) == (n_s, nk)
    rng = np.random.default_rng(nk)
    bh = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    ref = _jax_scans(jplan, jnp.asarray(bh))
    hk.reset_launches()
    got = hk.tridiag_scan_plain(torch.tensor(bh), tplan.inv_denom, tplan.cp)
    assert got.dtype == torch.complex128 and got.shape == shape
    assert np.max(np.abs(ref - got.numpy())) <= SCAN_BAR * np.abs(ref).max()
    assert torch.equal(hk.tridiag_scan(torch.tensor(bh), tplan.inv_denom,
                                       tplan.cp), got)
    assert hk.launches["tridiag_scan"] == 0     # the twin ran
