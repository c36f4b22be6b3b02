"""Port parity: every ported stencil operator and the free-slip paint
against the JAX package on the same seeded numpy inputs.

f64 bar 1e-12 (both sides evaluate the same association order; only
reduction-free rounding can differ). The f32 WENO path is held at 1e-6
relative: both sides use the bit-trick reciprocal, and the only other
source of difference is compiler FMA contraction on the JAX side."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu.ops import stencil as js  # noqa: E402
from cup2d_tpu import uniform as ju  # noqa: E402
from cup2d_tpu_torch.ops import stencil as ts  # noqa: E402
from cup2d_tpu_torch import uniform as tu  # noqa: E402

F64_BAR = 1e-12
F32_REL_BAR = 1e-6
NY, NX = 24, 40


def _rand(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _both(a):
    return jnp.asarray(a), torch.tensor(a)


def _close(j, t, bar=F64_BAR):
    j = np.asarray(j)
    t = t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
    assert j.shape == t.shape
    err = np.max(np.abs(j - t)) if j.size else 0.0
    assert err <= bar, err


def test_dt_from_umax_f64():
    umax = np.abs(_rand((16,), 0)) * 3
    ju_, tu_ = _both(umax)
    _close(js.dt_from_umax(ju_, 1.0 / 64, 4e-5, 0.5),
           ts.dt_from_umax(tu_, 1.0 / 64, 4e-5, 0.5))


@pytest.mark.parametrize("fn", ["weno5_plus", "weno5_minus"])
def test_weno5_reconstructions_f64(fn):
    args = [_rand((64,), s) for s in range(5)]
    got = getattr(ts, fn)(*[torch.tensor(a) for a in args])
    ref = getattr(js, fn)(*[jnp.asarray(a) for a in args])
    _close(ref, got)


def test_weno_derivative_f64_strict_wind_sign():
    # a third of the winds exactly 0: the strict test takes the minus side
    wind = _rand((90,), 9)
    wind[::3] = 0.0
    args = [_rand((90,), s) for s in range(10, 17)]
    got = ts.weno_derivative(torch.tensor(wind),
                             *[torch.tensor(a) for a in args])
    ref = js.weno_derivative(jnp.asarray(wind),
                             *[jnp.asarray(a) for a in args])
    _close(ref, got)
    # args are (um3, um2, um1, u, up1, up2, up3): the minus-branch faces
    # are reconstructed from (um1..up3) and (um2..up2)
    minus = ts.weno5_minus(*[torch.tensor(a) for a in args[2:7]]) \
        - ts.weno5_minus(*[torch.tensor(a) for a in args[1:6]])
    assert torch.equal(got[::3], minus[::3])


@pytest.mark.parametrize("lead", [(), (3,)])
def test_advect_diffuse_rhs_and_heun_f64(lead):
    v = _rand(lead + (2, NY, NX), 1)
    jv, tv = _both(v)
    h, nu, dt = 1.0 / NX, 4e-5, 2e-3
    jr = js.advect_diffuse_rhs(ju.pad_vector(jv, 3), 3, h, nu, dt)
    tr = ts.advect_diffuse_rhs(ts.pad_vector(tv, 3), 3, h, nu, dt)
    _close(jr, tr)
    ih2 = 1.0 / (h * h)
    _close(js.heun_substage(jv, 0.5, jr, ih2),
           ts.heun_substage(tv, 0.5, tr, ih2))


def test_advect_diffuse_rhs_f32_bit_trick():
    v = _rand((2, NY, NX), 2, np.float32)
    h, nu = 1.0 / NX, 4e-5
    dt = np.float32(2e-3)
    jr = js.advect_diffuse_rhs(ju.pad_vector(jnp.asarray(v), 3), 3, h, nu,
                               jnp.float32(dt))
    tr = ts.advect_diffuse_rhs(ts.pad_vector(torch.tensor(v), 3), 3, h, nu,
                               torch.tensor(dt))
    assert tr.dtype == torch.float32
    jr = np.asarray(jr)
    rel = np.max(np.abs(jr - tr.numpy())) / np.max(np.abs(jr))
    assert rel <= F32_REL_BAR, rel


def test_weno5_weights_f32_uses_bit_trick():
    """The f32 weights are exactly the JAX bit-trick ones on a wide spread
    of smoothness indicators, degenerate ratios included."""
    b = [np.abs(_rand((256,), s, np.float32)) * 10.0 ** s for s in (3, 4, 5)]
    b[0][:8] = 0.0
    jw = js._weno5_weights(*[jnp.asarray(x) for x in b], 0.1, 0.6, 0.3)
    tw = ts._weno5_weights(*[torch.tensor(x) for x in b], 0.1, 0.6, 0.3)
    for a, c in zip(jw, tw):
        rel = np.max(np.abs(np.asarray(a) - c.numpy()))
        assert rel <= F32_REL_BAR, rel


@pytest.mark.parametrize("lo,hi", [(1.0, 1.0), (1.0, -1.0), (-1.0, 1.0)])
def test_edge_ones(lo, hi):
    got = ts._edge_ones(NX, torch.float64, "cpu", lo=lo, hi=hi)
    _close(js._edge_ones(NX, jnp.float64, lo=lo, hi=hi), got, 0.0)


@pytest.mark.parametrize("dy,dx", [(0, 1), (0, -1), (1, 0), (-1, 0),
                                   (1, 1), (-1, -1), (1, -1), (-1, 1)])
def test_zshift_exact(dy, dx):
    p = _rand((2, NY, NX), 3)
    jp, tp = _both(p)
    _close(js._zshift(jp, dy, dx), ts._zshift(tp, dy, dx), 0.0)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_linear_operators_f64(lead):
    p = _rand(lead + (NY, NX), 4)
    v = _rand(lead + (2, NY, NX), 5)
    ud = _rand(lead + (2, NY, NX), 6)
    chi = np.abs(_rand(lead + (NY, NX), 7)) % 1.0
    (jp, tp), (jv, tv), (jd, td), (jc, tc) = map(_both, (p, v, ud, chi))
    h, dt = 1.0 / NX, 3e-3
    _close(js.laplacian5_neumann(jp), ts.laplacian5_neumann(tp))
    _close(js.divergence_freeslip(jv), ts.divergence_freeslip(tv))
    _close(js.divergence_rhs_fused(jv, jd, jc, h, dt),
           ts.divergence_rhs_fused(tv, td, tc, h, dt))
    _close(js.pressure_gradient_update_fused(jp, h, dt),
           ts.pressure_gradient_update_fused(tp, h, dt))


def test_vorticity_f64():
    v = _rand((2, NY, NX), 8)
    jv, tv = _both(v)
    _close(js.vorticity(ju.pad_vector(jv, 1), 1, 1.0 / NX),
           ts.vorticity(ts.pad_vector(tv, 1), 1, 1.0 / NX))


@pytest.mark.parametrize("lead,g", [((), 3), ((3,), 3), ((), 1)])
def test_pad_vector_exact_with_corners(lead, g):
    v = _rand(lead + (2, NY, NX), 11)
    got = tu.pad_vector(torch.tensor(v), g)
    _close(ju.pad_vector(jnp.asarray(v), g), got, 0.0)
    # every ghost equals the edge cell (zeroth order); a corner is (-u, -v)
    c = got[..., :, :g, :g].numpy()
    assert np.array_equal(c[..., 0, :, :], np.broadcast_to(
        -v[..., 0, :1, :1], c[..., 0, :, :].shape))
    assert np.array_equal(c[..., 1, :, :], np.broadcast_to(
        -v[..., 1, :1, :1], c[..., 1, :, :].shape))


def test_pad_scalar_exact():
    p = _rand((2, NY, NX), 12)
    _close(ju.pad_scalar(jnp.asarray(p), 3),
           tu.pad_scalar(torch.tensor(p), 3), 0.0)
