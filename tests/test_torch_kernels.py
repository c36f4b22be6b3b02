"""Port parity for the three Hopper kernels' plain twins.

* f32: each twin against the JAX Pallas kernel it stands in for, run in
  interpret mode on the CPU as the JAX package's own tests run it. Bounds
  as the JAX package pins Pallas against XLA (tests/test_megakernel.py,
  tests/test_strip_smoother.py): <= 2e-6 for the substage pair (unit-scale
  operands, FMA contraction amplified by ih2), <= 5e-6 for the correction
  (the means reassociate), <= 2e-6 relative for the sweep chains.
* f64: each twin against the JAX XLA chain, <= 1e-12.
* Dispatch: on CPU tensors the wrappers run the twin and count no launch;
  the module imports without nvcc and without triton.

The kernels themselves run only on the card: tests/test_torch_cuda.py."""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu.ops import pallas_kernels as jpk  # noqa: E402
from cup2d_tpu.ops.stencil import advect_diffuse_rhs, heun_substage  # noqa: E402
from cup2d_tpu.poisson import MultigridPreconditioner, project_correct  # noqa: E402
from cup2d_tpu.uniform import pad_vector  # noqa: E402
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402

pytestmark = pytest.mark.skipif(not jpk.HAVE_PALLAS,
                                reason="needs jax.experimental.pallas")

NY, NX = 32, 64
H = 1.0 / NX
NU = 4e-5
HEUN_BOUND = 2e-6
CORRECTION_BOUND = 5e-6
JACOBI_REL_BOUND = 2e-6
F64_BAR = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _dts(L, dtype=np.float32):
    return np.asarray([0.5 * H, 0.35 * H, 0.27 * H][:L], dtype)


def _xla_heun(vel, dt):
    """The JAX package's XLA substage chain (uniform.advect_heun)."""
    ih2 = 1.0 / (H * H)
    dt_b = dt[:, None, None, None]
    v = vel
    for c in (0.5, 1.0):
        rhs = advect_diffuse_rhs(pad_vector(v, 3), 3, H, NU, dt_b)
        v = heun_substage(vel, c, rhs, ih2)
    return v


@pytest.mark.parametrize("L", [1, 3])
def test_advect_heun_twin_vs_pallas_f32(L):
    v = _rand((L, 2, NY, NX), L)
    dt = _dts(L)
    ref = np.asarray(jpk.fused_advect_heun(jnp.asarray(v), H, NU,
                                           jnp.asarray(dt)))
    got = hk.fused_advect_heun(torch.tensor(v), H, NU, torch.tensor(dt))
    assert got.dtype == torch.float32
    err = np.max(np.abs(got.numpy() - ref))
    assert err <= HEUN_BOUND, err


@pytest.mark.parametrize("L", [1, 3])
def test_advect_heun_twin_vs_xla_f64(L):
    v = _rand((L, 2, NY, NX), 10 + L, np.float64)
    dt = _dts(L, np.float64)
    ref = np.asarray(_xla_heun(jnp.asarray(v), jnp.asarray(dt)))
    got = hk.fused_advect_heun(torch.tensor(v), H, NU, torch.tensor(dt))
    assert np.max(np.abs(got.numpy() - ref)) <= F64_BAR


def _correction_operands(L, seed, dtype):
    x = _rand((L, NY, NX), seed, dtype)
    pold = _rand((L, NY, NX), seed + 1, dtype)
    vel = _rand((L, 2, NY, NX), seed + 2, dtype)
    dt = _dts(L, dtype)
    mx = x.mean(axis=(1, 2))
    mp = pold.mean(axis=(1, 2))
    pfac = (-0.5 * dt * H).astype(dtype)
    scal = np.stack([mx, mp, pfac], axis=-1).astype(dtype)
    return x, pold, vel, dt, scal


@pytest.mark.parametrize("L", [1, 3])
def test_correction_twin_vs_pallas_f32(L):
    x, pold, vel, _, scal = _correction_operands(L, 20 + L, np.float32)
    jp, jv = jpk.fused_correction(jnp.asarray(x), jnp.asarray(pold),
                                  jnp.asarray(vel), jnp.asarray(scal[:, 0]),
                                  jnp.asarray(scal[:, 1]),
                                  jnp.asarray(scal[:, 2]), 1.0 / (H * H))
    tp, tv = hk.fused_correction(torch.tensor(x), torch.tensor(pold),
                                 torch.tensor(vel), torch.tensor(scal),
                                 1.0 / (H * H))
    assert np.max(np.abs(tp.numpy() - np.asarray(jp))) <= CORRECTION_BOUND
    assert np.max(np.abs(tv.numpy() - np.asarray(jv))) <= CORRECTION_BOUND


def test_correction_twin_vs_xla_f64():
    x, pold, vel, dt, scal = _correction_operands(1, 30, np.float64)
    jv, jp = project_correct(jnp.asarray(x[0]), jnp.asarray(pold[0]),
                             jnp.asarray(vel[0]), H, jnp.asarray(dt[0]))
    tp, tv = hk.fused_correction(torch.tensor(x), torch.tensor(pold),
                                 torch.tensor(vel), torch.tensor(scal),
                                 1.0 / (H * H))
    assert np.max(np.abs(tp.numpy()[0] - np.asarray(jp))) <= F64_BAR
    assert np.max(np.abs(tv.numpy()[0] - np.asarray(jv))) <= F64_BAR


@pytest.mark.parametrize("n", [1, 2, 3, 6])
@pytest.mark.parametrize("from_zero", [False, True])
def test_jacobi_twin_vs_pallas_f32(n, from_zero):
    e = _rand((NY, NX), 40 + n)
    r = _rand((NY, NX), 50 + n)
    ref = np.asarray(jpk.fused_jacobi_sweeps(jnp.asarray(e), jnp.asarray(r),
                                             0.8, n, from_zero=from_zero))
    got = hk.fused_jacobi_sweeps(torch.tensor(e), torch.tensor(r), 0.8, n,
                                 from_zero).numpy()
    rel = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert rel <= JACOBI_REL_BOUND, rel


@pytest.mark.parametrize("n", [2, 24])
@pytest.mark.parametrize("from_zero", [False, True])
def test_jacobi_twin_vs_xla_f64(n, from_zero):
    e = _rand((2, NY, NX), 60 + n, np.float64)
    r = _rand((2, NY, NX), 70 + n, np.float64)
    mg = MultigridPreconditioner(NY, NX, jnp.float64)
    ref = np.asarray(mg._smooth(jnp.asarray(e), jnp.asarray(r), 0, n,
                                from_zero=from_zero))
    got = hk.fused_jacobi_sweeps(torch.tensor(e), torch.tensor(r), 0.8, n,
                                 from_zero).numpy()
    assert np.max(np.abs(got - ref)) <= F64_BAR


def test_cpu_wrappers_take_the_twin_and_count_nothing():
    hk.reset_launches()
    v = torch.tensor(_rand((1, 2, NY, NX), 80))
    dt = torch.tensor(_dts(1))
    assert torch.equal(hk.fused_advect_heun(v, H, NU, dt),
                       hk.fused_advect_heun_plain(v, H, NU, dt))
    x, pold, vel, _, scal = map(torch.tensor, _correction_operands(
        1, 81, np.float32))
    for a, b in zip(hk.fused_correction(x, pold, vel, scal, 1.0 / H ** 2),
                    hk.fused_correction_plain(x, pold, vel, scal,
                                              1.0 / H ** 2)):
        assert torch.equal(a, b)
    assert torch.equal(hk.fused_jacobi_sweeps(x[0], pold[0], 0.8, 8),
                       hk.jacobi_sweeps_plain(x[0], pold[0], 0.8, 8))
    assert hk.launches == {k: 0 for k in hk.launches}
    assert not hk._fns, "a CPU call must not build or load a kernel"


def test_wrappers_refuse_mixed_devices():
    r = torch.zeros(NY, NX)
    with pytest.raises(ValueError, match="devices"):
        hk.fused_jacobi_sweeps(torch.zeros(NY, NX, device="meta"), r, 0.8, 2)


def test_module_imports_without_nvcc_or_triton():
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="")
    code = ("import sys; import cup2d_tpu_torch.ops.hopper_kernels as hk; "
            "assert 'triton' not in sys.modules; "
            "assert 'torch.utils.cpp_extension' not in sys.modules; "
            "print(sorted(hk.launches))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "fused_jacobi_sweeps" in out.stdout
