"""The port's Hopper kernels on the card, against their plain twins, at
small shapes. These need an NVIDIA card and nvcc; without them every test
here skips. They import no JAX, so they run on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q

Bounds: the substage pair <= 2e-6 on unit-scale operands at dt = h/2
(FMA contraction in the kernel, amplified by ih2 = 1/h^2), the correction
<= 5e-6, the sweep chains <= 2e-6 relative."""

import numpy as np
import pytest
import torch

from cup2d_tpu_torch.ops import hopper_kernels as hk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    return torch.device("cuda")


def _rand(shape, seed, device):
    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.tensor(a, dtype=torch.float32, device=device)


@pytest.mark.parametrize("shape", [(1, 2, 64, 96), (3, 2, 40, 72)])
def test_advect_heun_kernel_vs_twin(cuda, shape):
    h = 1.0 / shape[-1]
    v = _rand(shape, 1, cuda)
    dt = torch.tensor([0.5 * h, 0.35 * h, 0.27 * h][:shape[0]],
                      device=cuda)
    hk.reset_launches()
    got = hk.fused_advect_heun(v, h, 4e-5, dt)
    ref = hk.fused_advect_heun_plain(v, h, 4e-5, dt)
    torch.cuda.synchronize()
    assert hk.launches["fused_advect_heun"] == 2
    assert float((got - ref).abs().max()) <= 2e-6


def test_correction_kernel_vs_twin(cuda):
    x, p, v = (_rand((2, 48, 80), 2, cuda), _rand((2, 48, 80), 3, cuda),
               _rand((2, 2, 48, 80), 4, cuda))
    scal = torch.stack([x.mean((1, 2)), p.mean((1, 2)),
                        torch.tensor([-1e-4, -2e-4], device=cuda)], -1)
    got = hk.fused_correction(x, p, v, scal.contiguous(), 6400.0)
    ref = hk.fused_correction_plain(x, p, v, scal, 6400.0)
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 5e-6


@pytest.mark.parametrize("n", [1, 2, 3, 6, 24])
@pytest.mark.parametrize("from_zero", [False, True])
def test_jacobi_kernel_vs_twin(cuda, n, from_zero):
    e, r = _rand((72, 136), 5, cuda), _rand((72, 136), 6, cuda)
    got = hk.fused_jacobi_sweeps(e, r, 0.8, n, from_zero)
    ref = hk.jacobi_sweeps_plain(e, r, 0.8, n, from_zero)
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= 2e-6


def test_kernel_refuses_f64(cuda):
    e = torch.zeros(16, 16, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        hk.fused_jacobi_sweeps(e, e, 0.8, 2)
