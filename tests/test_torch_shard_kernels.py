"""Port parity for the halo-mode kernels of the x-split step and for the
single-op advection RHS (their plain twins; the kernels run on the card,
tests/test_torch_cuda.py).

* f32: the per-shard twins of the halo substage and the halo Jacobi sweep
  against the JAX package's per-shard Pallas kernels, called directly in
  interpret mode on operands built with numpy (aux lane-padded to 128
  columns for JAX, 6 or 2 columns for the port). The substage is held to
  2e-6, the bar of the solo substage twin against its Pallas kernel
  (tests/test_torch_kernels.py: unit-scale operands, rounding amplified by
  ih2 = 1/h^2; the split twin equals the solo twin bit for bit, and the
  split Pallas kernel the solo one); the sweep to 1e-6 relative.
* The split forms assembled over a CPU slab mesh equal the port's solo
  twins bit for bit, at f32 and f64.
* The single-op RHS twin against ``cup2d_tpu.ops.stencil.advect_diffuse_rhs``
  at f64, <= 1e-12.
* ``exchange_x``: each halo is the neighbour's edge columns, zeros at the
  walls."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu.bc import BCTable  # noqa: E402
from cup2d_tpu.ops import pallas_kernels as jpk  # noqa: E402
from cup2d_tpu.ops.stencil import advect_diffuse_rhs as jrhs  # noqa: E402
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from cup2d_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from cup2d_tpu_torch.parallel.shard_halo import (  # noqa: E402
    exchange_x, fused_advect_heun_sharded, gather_x, overlap_jacobi_sweeps,
    split_x)

pytestmark = pytest.mark.skipif(not jpk.HAVE_PALLAS,
                                reason="needs jax.experimental.pallas")

NY, NX = 32, 64
H = 1.0 / NX
NU = 4e-5
DT = 0.5 * H
HEUN_BOUND = 2e-6
JACOBI_REL_BOUND = 1e-6
F64_BAR = 1e-12
LANES = 128

_jitted = {}


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


def _pallas_substage(v, vold, aux, info, facs, cfac):
    key = ("substage", v.shape, vold is None, cfac)
    if key not in _jitted:
        def run(v, vold, aux, info, facs):
            return jpk._fused_substage_sharded(
                v, vold, aux, info, facs, cfac, 1.0 / (H * H), jnp.float32,
                BCTable(), H, NX, True)
        _jitted[key] = jax.jit(run)
    return np.asarray(_jitted[key](v, vold, aux, info, facs))


def _pallas_sweep(e, r, aux, info):
    key = ("sweep", e.shape)
    if key not in _jitted:
        _jitted[key] = jax.jit(lambda e, r, a, i:
                               jpk.fused_jacobi_halo_sweep(
                                   e, r, a, i, 0.8, interpret=True))
    return np.asarray(_jitted[key](e, r, aux, info))


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("second", [False, True])
def test_substage_halo_twin_vs_pallas_f32(D, second):
    v = _rand((1, 2, NY, NX), 1 + D)
    vold = _rand((1, 2, NY, NX), 11 + D) if second else None
    cfac = 1.0 if second else 0.5
    facs_j = np.asarray([[-DT * H, NU * DT, DT]], np.float32)
    facs_t = torch.tensor(facs_j[:, :2])
    w = NX // D
    for d in range(D):
        sl = slice(d * w, (d + 1) * w)
        info = np.asarray([[d == 0, d == D - 1, d * w]], np.int32)
        ref = _pallas_substage(
            jnp.asarray(v[..., sl]),
            None if vold is None else jnp.asarray(vold[..., sl]),
            jnp.asarray(_shard_aux(v, d, D, 3, LANES)), jnp.asarray(info),
            jnp.asarray(facs_j), cfac)
        got = hk.advect_substage_halo(
            torch.tensor(v[..., sl]),
            None if vold is None else torch.tensor(vold[..., sl]),
            torch.tensor(_shard_aux(v, d, D, 3)), facs_t, cfac,
            1.0 / (H * H), d == 0, d == D - 1)
        err = np.max(np.abs(got.numpy() - ref))
        assert err <= HEUN_BOUND, (d, err)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_jacobi_halo_twin_vs_pallas_f32(D):
    e = _rand((NY, NX), 20 + D)
    r = _rand((NY, NX), 30 + D)
    w = NX // D
    for d in range(D):
        sl = slice(d * w, (d + 1) * w)
        info = np.asarray([[d == 0, d == D - 1]], np.int32)
        ref = _pallas_sweep(jnp.asarray(e[:, sl]), jnp.asarray(r[:, sl]),
                            jnp.asarray(_shard_aux(e, d, D, 1, LANES)),
                            jnp.asarray(info))
        got = hk.jacobi_halo_sweep(
            torch.tensor(e[:, sl]), torch.tensor(r[:, sl]),
            torch.tensor(_shard_aux(e, d, D, 1)), 0.8, d == 0, d == D - 1)
        rel = np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref))
        assert rel <= JACOBI_REL_BOUND, (d, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [2, 4])
def test_split_twins_equal_solo_bit_for_bit(dtype, D):
    mesh = make_mesh(devices=["cpu"] * D)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    v = torch.tensor(_rand((3, 2, NY, NX), 40 + D, np_dt))
    dt = torch.tensor([0.5 * H, 0.35 * H, 0.27 * H], dtype=dtype)
    solo = hk.fused_advect_heun_plain(v, H, NU, dt)
    split = fused_advect_heun_sharded(split_x(v, mesh), H, NU, dt)
    assert torch.equal(gather_x(split), solo)
    e = torch.tensor(_rand((NY, NX), 50 + D, np_dt))
    r = torch.tensor(_rand((NY, NX), 60 + D, np_dt))
    for n, fz in [(1, False), (1, True), (3, False), (3, True)]:
        solo = hk.jacobi_sweeps_plain(e, r, 0.8, n, fz)
        split = overlap_jacobi_sweeps(split_x(e, mesh), split_x(r, mesh),
                                      0.8, n, fz)
        assert torch.equal(gather_x(split), solo), (n, fz)


def test_advect_rhs_twin_vs_xla_f64():
    lab = _rand((2, NY + 6, NX + 6), 70, np.float64)
    ref = np.asarray(jrhs(jnp.asarray(lab), 3, H, NU, DT))
    got = hk.advect_diffuse_rhs(torch.tensor(lab), H, NU, DT).numpy()
    assert got.shape == (2, NY, NX)
    assert np.max(np.abs(got - ref)) <= F64_BAR


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_exchange_x(D):
    a = _rand((2, NY, NX), 80 + D)
    s = split_x(torch.tensor(a), make_mesh(devices=["cpu"] * D))
    for g in (1, 3):
        aux = exchange_x(s, g)
        assert len(aux) == D
        for d in range(D):
            assert aux[d].shape == (2, NY, 2 * g)
            assert np.array_equal(aux[d].numpy(), _shard_aux(a, d, D, g))


def test_exchange_refuses_narrow_slabs():
    s = split_x(torch.zeros(NY, 16), make_mesh(devices=["cpu"] * 8))
    with pytest.raises(ValueError, match="halo"):
        exchange_x(s, 3)


def test_cpu_halo_wrappers_take_the_twin_and_count_nothing():
    hk.reset_launches()
    v = torch.tensor(_rand((1, 2, NY, NX), 90))
    aux = torch.tensor(_rand((1, 2, NY, 6), 91))
    facs = torch.tensor([[-DT * H, NU * DT]], dtype=torch.float32)
    assert torch.equal(
        hk.advect_substage_halo(v, None, aux, facs, 0.5, 1 / H ** 2, 1, 0),
        hk.advect_substage_halo_plain(v, None, aux, facs, 0.5, 1 / H ** 2,
                                      1, 0))
    e, r = v[0, 0], v[0, 1]
    a2 = aux[0, 0, :, :2]
    assert torch.equal(hk.jacobi_halo_sweep(e, r, a2, 0.8, 0, 1),
                       hk.jacobi_halo_sweep_plain(e, r, a2, 0.8, 0, 1))
    lab = torch.tensor(_rand((2, NY + 6, NX + 6), 92))
    assert torch.equal(hk.advect_diffuse_rhs(lab, H, NU, DT),
                       hk.advect_diffuse_rhs_plain(lab, H, NU, DT))
    assert hk.launches == {k: 0 for k in hk.launches}
    assert not hk._fns, "a CPU call must not build or load a kernel"
