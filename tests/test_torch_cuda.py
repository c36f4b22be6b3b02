"""The port's Hopper kernels on the card, against their plain twins, at
small shapes. These need an NVIDIA card and nvcc; without them every test
here skips. They import no JAX, so they run on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q

Bounds: the substage pair <= 2e-6 on unit-scale operands at dt = h/2
(FMA contraction in the kernel, amplified by ih2 = 1/h^2), the correction
<= 5e-6, the sweep chains <= 2e-6 relative, the forest lab RHS <= 2e-6
relative per block-size class, the block-Jacobi update <= 2e-6 relative
(summation order of its 64-term products), the single-op RHS <= 2e-6
relative. The halo kernels of the x-split step reproduce the solo kernels
bit for bit once their slabs are assembled (the same per-cell code and
the same ghost values), and a split step on one card follows the solo
step to 1e-5 relative (only the reductions' order differs)."""

import numpy as np
import pytest
import torch

from cup2d_tpu_torch import SimConfig, UniformSim
from cup2d_tpu_torch.amr import multilevel_forest
from cup2d_tpu_torch.convert import forest_from_numpy, forest_to_numpy
from cup2d_tpu_torch.ops import hopper_kernels as hk
from cup2d_tpu_torch.parallel.mesh import (ShardedUniformSim, make_mesh,
                                           unshard_state)
from cup2d_tpu_torch.parallel.shard_halo import (exchange_x,
                                                 fused_advect_heun_sharded,
                                                 gather_x,
                                                 overlap_jacobi_sweeps,
                                                 split_x)
from cup2d_tpu_torch.poisson import block_precond_matrix
from cup2d_tpu_torch.uniform import bench_state

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


@pytest.mark.parametrize("n", [3, 128])
@pytest.mark.parametrize("nu", [4e-5, 1.0])
def test_lab_rhs_kernel_vs_twin(cuda, n, nu):
    """Held per h class, relative to that class's max |ref|: the output
    scales with h (advection) and nu dt (diffusion, which dominates at
    nu = 1)."""
    lab = _rand((n, 2, 14, 14), 7, cuda)
    cls = torch.arange(n, device=cuda) % 3
    h = torch.tensor([1 / 64, 1 / 128, 1.0], device=cuda)[cls].reshape(
        n, 1, 1, 1)
    dt = torch.tensor(0.5 / 128, device=cuda)
    hk.reset_launches()
    got = hk.fused_lab_rhs(lab, h, nu, dt)
    ref = hk.fused_lab_rhs_plain(lab, h, nu, dt)
    torch.cuda.synchronize()
    assert hk.launches["fused_lab_rhs"] == 1
    for c in range(min(n, 3)):
        d, r = (got - ref)[cls == c], ref[cls == c]
        assert float(d.abs().max() / r.abs().max()) <= 2e-6


@pytest.mark.parametrize("n", [1, 5, 300])
def test_block_jacobi_kernel_vs_twin(cuda, n):
    e, r, lap = (_rand((n, 8, 8), s, cuda) for s in (8, 9, 10))
    p = torch.tensor(block_precond_matrix(8), dtype=torch.float32,
                     device=cuda)
    hk.reset_launches()
    got = hk.fused_block_jacobi_update(e, r, lap, p)
    ref = hk.block_jacobi_plain(e, r, lap, p)
    torch.cuda.synchronize()
    assert hk.launches["fused_block_jacobi_update"] == 1
    assert float((got - ref).abs().max() / ref.abs().max()) <= 2e-6


def test_forest_kernels_refuse_bad_operands(cuda):
    lab = torch.zeros(4, 2, 14, 14, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        hk.fused_lab_rhs(lab, 0.1, 4e-5, 1e-3)
    lab = torch.zeros(4, 2, 14, 28, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        hk.fused_lab_rhs(lab, 0.1, 4e-5, 1e-3)
    e = torch.zeros(8, 8, 16, device=cuda)[..., ::2]
    p = torch.zeros(64, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        hk.fused_block_jacobi_update(e, e, e, p)
    with pytest.raises(TypeError, match="float32"):
        hk.fused_block_jacobi_update(e.double(), e.double(), e.double(),
                                     p.double())


def test_forest_step_on_the_card_launches_both_kernels(cuda, monkeypatch):
    """A short forest step on the card under CUP2D_POIS=fas: the lab RHS
    twice a step, the block-Jacobi update once a production cycle; the
    state agrees with the CPU run of the same forest to 1e-4 relative."""
    monkeypatch.setenv("CUP2D_POIS", "fas")
    cpu = multilevel_forest(bpd=2, level_max=4, dtype="float32",
                            device="cpu")
    card = type(cpu)(cpu.cfg, shapes=[], device=cuda)
    forest_from_numpy(card, *forest_to_numpy(cpu))
    card.step_count = cpu.step_count
    hk.reset_launches()
    d = card.step_once()
    cpu.step_once()
    torch.cuda.synchronize()
    assert hk.launches["fused_lab_rhs"] == 2
    assert hk.launches["fused_block_jacobi_update"] == d["poisson_iters"] > 0
    a = card.fields()["vel"].cpu()[
        torch.as_tensor(card.forest.order(), dtype=torch.long)]
    b = cpu.fields()["vel"][
        torch.as_tensor(cpu.forest.order(), dtype=torch.long)]
    assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


def test_forest_default_solver_on_the_card_matches_cpu(cuda, monkeypatch):
    """Two forest steps on the card under the default BiCGSTAB (block
    Jacobi, then the two-level M once a solve took > 15 iterations),
    against the CPU: 1e-4 relative at tolerances 1e-6/1e-5, where a
    convergence test on its edge cannot move the states apart."""
    monkeypatch.delenv("CUP2D_POIS", raising=False)
    cpu = multilevel_forest(bpd=2, level_max=4, dtype="float32",
                            tol=1e-6, tol_rel=1e-5, device="cpu")
    card = type(cpu)(cpu.cfg, shapes=[], device=cuda)
    forest_from_numpy(card, *forest_to_numpy(cpu))
    card.step_count = cpu.step_count
    hk.reset_launches()
    for _ in range(2):
        card.step_once()
        cpu.step_once()
    torch.cuda.synchronize()
    assert hk.launches["fused_lab_rhs"] == 4
    assert hk.launches["fused_block_jacobi_update"] == 0
    assert card.poisson_mode == "bicgstab+twolevel"
    a = card.fields()["vel"].cpu()[
        torch.as_tensor(card.forest.order(), dtype=torch.long)]
    b = cpu.fields()["vel"][
        torch.as_tensor(cpu.forest.order(), dtype=torch.long)]
    assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


@pytest.mark.parametrize("D", [1, 2, 4])
def test_halo_substage_kernel_vs_twin_and_solo_kernel(cuda, D):
    h = 1.0 / 96
    v = _rand((2, 2, 40, 96), 11, cuda)
    dt = torch.tensor([0.5 * h, 0.3 * h], device=cuda)
    mesh = make_mesh(devices=[cuda] * D)
    hk.reset_launches()
    split = gather_x(fused_advect_heun_sharded(split_x(v, mesh), h, 4e-5,
                                               dt))
    solo = hk.fused_advect_heun(v, h, 4e-5, dt)
    torch.cuda.synchronize()
    assert hk.launches["advect_substage_halo"] == 2 * D
    assert torch.equal(split, solo)
    # one shard against its twin
    s = split_x(v, mesh)
    aux = exchange_x(s, 3)[0]
    facs = torch.stack([-dt * h, 4e-5 * dt], -1).contiguous()
    got = hk.advect_substage_halo(s.parts[0], None, aux, facs, 0.5,
                                  1 / h ** 2, True, D == 1)
    ref = hk.advect_substage_halo_plain(s.parts[0], None, aux, facs, 0.5,
                                        1 / h ** 2, True, D == 1)
    assert float((got - ref).abs().max()) <= 2e-6


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("from_zero", [False, True])
def test_halo_jacobi_kernel_vs_twin_and_solo_kernel(cuda, D, from_zero):
    e, r = _rand((72, 136), 12, cuda), _rand((72, 136), 13, cuda)
    mesh = make_mesh(devices=[cuda] * D)
    hk.reset_launches()
    split = gather_x(overlap_jacobi_sweeps(split_x(e, mesh), split_x(r, mesh),
                                           0.8, 3, from_zero))
    solo = hk.fused_jacobi_sweeps(e, r, 0.8, 3, from_zero)
    torch.cuda.synchronize()
    assert hk.launches["jacobi_halo_sweep"] == 3 * D
    assert torch.equal(split, solo)
    twin = hk.jacobi_sweeps_plain(e, r, 0.8, 3, from_zero)
    assert float((split - twin).abs().max() / twin.abs().max()) <= 2e-6


def test_advect_rhs_kernel_vs_twin(cuda):
    lab = _rand((2, 70, 134), 14, cuda)
    hk.reset_launches()
    got = hk.advect_diffuse_rhs(lab, 1 / 128, 4e-5, 0.5 / 128)
    ref = hk.advect_diffuse_rhs_plain(lab, 1 / 128, 4e-5, 0.5 / 128)
    torch.cuda.synchronize()
    assert hk.launches["advect_diffuse_rhs"] == 1
    assert got.shape == (2, 64, 128)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 2e-6


@pytest.mark.parametrize("pois", ["", "fas"])
def test_sharded_step_on_one_card_matches_solo(cuda, monkeypatch, pois):
    """Two production steps of a D = 2 split on cuda:0 against the solo
    step: equal iterations, velocity within 1e-5 relative."""
    monkeypatch.setenv("CUP2D_POIS", pois)
    cfg = SimConfig(bpdx=2, bpdy=1, level_max=1, level_start=0,
                    extent=2.0, nu=4e-5, cfl=0.5, dtype="float32")
    solo = UniformSim(cfg, level=5, device=cuda)
    solo.state = bench_state(solo.grid)
    sh = ShardedUniformSim(cfg, make_mesh(devices=[cuda] * 2), level=5)
    sh.set_state(bench_state(sh.grid))
    hk.reset_launches()
    for _ in range(2):
        ds, dh = solo.advance(1), sh.advance(1)
        assert ds["poisson_iters"] == dh["poisson_iters"]
    torch.cuda.synchronize()
    assert hk.launches["advect_substage_halo"] == 2 * 2 * 2
    assert (hk.launches["jacobi_halo_sweep"] > 0) == (pois == "fas")
    a, b = unshard_state(sh.state).vel, solo.state.vel
    assert float((a - b).abs().max() / b.abs().max()) <= 1e-5
