"""The port's Hopper kernels on the card, against their plain twins, at
small shapes. These need an NVIDIA card and nvcc; without them every test
here skips. They import no JAX, so they run on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q

Bounds: the substage pair <= 2e-6 relative to max |ref| at dt = h/2:
kernel and twin differ by FMA contraction in each update v + dt * rhs,
a few ulp of the field's magnitude (amplified by ih2 = 1/h^2 in the
diffusion term), so the bar scales with the field; the operands here are
standard normal, |v| up to ~4.5, where one f32 ulp is 4.8e-7 and an
absolute 2e-6 would be ~4 ulp. The correction
<= 5e-6, the sweep chains <= 2e-6 relative, the forest lab RHS <= 2e-6
relative per block-size class, the block-Jacobi update <= 2e-6 relative
(summation order of its 64-term products), the single-op RHS <= 2e-6
relative on ragged shapes, odd and even pitches and adversarial winds,
from the same bits whatever its copy width. The halo kernels of the x-split
step reproduce the solo kernels
bit for bit once their slabs are assembled (the same per-cell code and
the same ghost values), on smooth and on adversarial winds, and a split
step on one card follows the solo step to 1e-5 relative (only the
reductions' order differs). The boundary-table forms of the substage,
the correction and the sweep chain hold their twins to the same bounds on
the four tables of tests/test_megakernel.py, ragged shapes included, and
a short cavity run on the card follows the CPU to 1e-4 relative with
every ``+bc`` counter moving. The bf16 forms (``CUP2D_PREC=bf16``) hold
their bf16 twins: a bf16 output within one bf16 ulp (2^-7 of max |ref|)
and at least 99% of it bit-equal (kernel and twin each round one f32
value, a few f32 ulp apart), n bf16 ulps after an n-sweep chain, an f32
output from the same bf16 inputs (the second substage) within 2e-6
relative; their split forms reproduce the solo ones bit for bit, and a
split bf16 step the solo bf16 step. The boundary-table forms of the halo
kernels (the halo substage under a table, the signed halo sweep), f32 and
bf16, hold their twins as the solo forms do and reproduce the solo BC
pair and the signed chain kernel bit for bit once assembled; a split
cavity on one card follows the solo cavity to 1e-5 relative. The halo
sweep's slab list (one launch for every slab of the card) equals the
per-slab kernel over an exchange and the chain kernel's single sweep bit
for bit, whatever the slabs' widths and alignment, holds its twin to the
chain's bars, and refuses an output that overlaps a slab it reads; the
face-sharing lab RHS holds its twin on adversarial winds and gives the
same bits from labs off the 16-byte grid. The shaped forest: a disk forest
on the card follows the CPU to 1e-4 relative from one carried state; the
window raster's dropped padding row repeats bit for bit; the batched force
pass indexes past every block's lab without a device-side assert. The
device snapshot ring: a snapshot clones every field and reads nothing,
the lagged guard is bit for bit the eager run, and one entry restores
twice, each restore and replay bit for bit the uninterrupted steps. The
forest on four shards of the card follows the solo forest bit for bit
(equal topologies and iterations) with the lab RHS launched once a shard
and stage, the block-Jacobi update once a shard and sweep and once a shard
and P_inv r, and the group partials once a shard and reduction; both
kernels hold their twins on one shard's operands; ``group_sum.cu`` is its
twin bit for bit at any number of rows, and kernel 8's P_inv r form gives
a block the same bits in calls of any size; the C regrid helper builds
on the card's host and adapts as the Python sweep; ``CUP2D_POIS=tables`` and the bf16 FAS legs follow the
CPU (1e-4, and the 2e-2 bf16 band). The periodic tables on the split
step: the halo substage's wrap form over a ring exchange and the halo
sweep's y-wrap forms (per slab and as the slab list) reproduce the solo
wrap forms bit for bit once assembled and hold their twins (2e-6
relative); a split periodic step on one card follows the solo step and a
fleet placed on two shards of the card (member or spatial) the unplaced
fleet, to 1e-5 relative with equal iterations."""

import numpy as np
import pytest
import torch

from cup2d_tpu_torch import SimConfig, UniformSim
from cup2d_tpu_torch import bc as tbc
from cup2d_tpu_torch import cases as tcases
from cup2d_tpu_torch.amr import multilevel_forest
from cup2d_tpu_torch.convert import forest_from_numpy, forest_to_numpy
from cup2d_tpu_torch.kernel_ab import WIND_PATTERNS, wind_field
from cup2d_tpu_torch.ops import hopper_kernels as hk
from cup2d_tpu_torch.parallel import shard_halo
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
    # relative to max |ref|: FMA contraction moves each update by a few
    # ulp of the field's magnitude, not of 1
    assert float((got - ref).abs().max() / ref.abs().max()) <= 2e-6


def test_correction_kernel_vs_twin(cuda):
    x, p, v = (_rand((2, 48, 80), 2, cuda), _rand((2, 48, 80), 3, cuda),
               _rand((2, 2, 48, 80), 4, cuda))
    scal = torch.stack([x.mean((1, 2)), p.mean((1, 2)),
                        torch.tensor([-1e-4, -2e-4], device=cuda)], -1)
    got = hk.fused_correction(x, p, v, scal.contiguous(), 6400.0)
    ref = hk.fused_correction_plain(x, p, v, scal, 6400.0)
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 5e-6


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 24])
@pytest.mark.parametrize("from_zero", [False, True])
def test_jacobi_kernel_vs_twin(cuda, n, from_zero):
    e, r = _rand((72, 136), 5, cuda), _rand((72, 136), 6, cuda)
    got = hk.fused_jacobi_sweeps(e, r, 0.8, n, from_zero)
    ref = hk.jacobi_sweeps_plain(e, r, 0.8, n, from_zero)
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= 2e-6


# (L, ny, nx, n): the coarsest level's 24-sweep chain, coarse levels,
# member stacks, ragged tiles on both tile sizes, and rows that are not
# whole 16-byte words (nx % 4 != 0: the 4-byte copy route)
JACOBI_SHAPES = [(1, 8, 8, 24), (1, 16, 16, 2), (1, 16, 32, 24),
                 (3, 16, 16, 2), (4, 40, 72, 3), (1, 37, 150, 2),
                 (2, 33, 70, 6), (1, 1000, 1500, 2), (1, 1000, 1501, 5),
                 (1, 2048, 2048, 2)]


@pytest.mark.parametrize("shape", JACOBI_SHAPES)
@pytest.mark.parametrize("from_zero", [False, True])
def test_jacobi_kernel_shapes_vs_twin(cuda, shape, from_zero):
    L, ny, nx, n = shape
    e, r = _rand((L, ny, nx), 15, cuda), _rand((L, ny, nx), 16, cuda)
    hk.reset_launches()
    got = hk.fused_jacobi_sweeps(e, r, 0.8, n, from_zero)
    ref = hk.jacobi_sweeps_plain(e, r, 0.8, n, from_zero)
    torch.cuda.synchronize()
    assert hk.launches["fused_jacobi_sweeps"] == len(hk.sweep_chain(n))
    assert float((got - ref).abs().max() / ref.abs().max()) <= 2e-6


def test_jacobi_kernel_misaligned_operands(cuda):
    """Operands that start 4 bytes past a 16-byte boundary take the
    4-byte copy route and give the aligned operands' result bit for
    bit."""
    flat = _rand((2 * 64 * 96 + 1,), 17, cuda)
    e = flat[1:1 + 64 * 96].view(64, 96)
    r = flat[1 + 64 * 96:].view(64, 96)
    assert e.data_ptr() % 16 and r.data_ptr() % 16
    got = hk.fused_jacobi_sweeps(e, r, 0.8, 2)
    assert torch.equal(got, hk.fused_jacobi_sweeps(e.clone(), r.clone(),
                                                   0.8, 2))
    ref = hk.jacobi_sweeps_plain(e, r, 0.8, 2)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 2e-6


@pytest.mark.parametrize("shape", [(1, 8, 8, 24), (1, 1000, 1500, 2)])
def test_jacobi_kernel_repeats_bit_for_bit(cuda, shape):
    L, ny, nx, n = shape
    e, r = _rand((L, ny, nx), 18, cuda), _rand((L, ny, nx), 19, cuda)
    first = hk.fused_jacobi_sweeps(e, r, 0.8, n)
    for _ in range(3):
        assert torch.equal(hk.fused_jacobi_sweeps(e, r, 0.8, n), first)


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


@pytest.mark.parametrize("n", [1, 5, 33, 300, 4099])
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


def test_block_jacobi_kernel_repeats_bit_for_bit(cuda):
    e, r, lap = (_rand((2053, 8, 8), s, cuda) for s in (20, 21, 22))
    p = torch.tensor(block_precond_matrix(8), dtype=torch.float32,
                     device=cuda)
    first = hk.fused_block_jacobi_update(e, r, lap, p)
    for _ in range(3):
        assert torch.equal(hk.fused_block_jacobi_update(e, r, lap, p), first)


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
    flat = torch.zeros(3 * 64 + 1, device=cuda)
    e = flat[1:].view(3, 8, 8)
    with pytest.raises(ValueError, match="16-byte"):
        hk.fused_block_jacobi_update(e, e, e, p)


def test_forest_step_on_the_card_launches_both_kernels(cuda, monkeypatch):
    """A short forest step on the card under CUP2D_POIS=fas: the lab RHS
    twice a step, the block-Jacobi update once a production cycle besides
    its P_inv r launches (kernel 8 counts both, the ``+pinv`` form the
    latter); the state agrees with the CPU run of the same forest to 1e-4
    relative."""
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
    cycles = (hk.launches["fused_block_jacobi_update"]
              - hk.launches["fused_block_jacobi_update+pinv"])
    assert cycles == d["poisson_iters"] > 0
    a = card.fields()["vel"].cpu()[
        torch.as_tensor(card.forest.order(), dtype=torch.long)]
    b = cpu.fields()["vel"][
        torch.as_tensor(cpu.forest.order(), dtype=torch.long)]
    assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


def test_forest_default_solver_on_the_card_matches_cpu(cuda, monkeypatch):
    """Two forest steps on the card under the default BiCGSTAB (block
    Jacobi, then the two-level M once a solve took > 15 iterations),
    against the CPU: 1e-4 relative at tolerances 1e-6/1e-5, where a
    convergence test on its edge cannot move the states apart. Every
    kernel-8 launch is a P_inv r (``+pinv``): no FAS cycle."""
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
    assert hk.launches["fused_block_jacobi_update"] \
        == hk.launches["fused_block_jacobi_update+pinv"] > 0
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


# ragged shapes: no side a multiple of the 32 x 128 tile, rows that are
# whole 16-byte words or not (the 4-byte copy route), member stacks
SUBSTAGE_SHAPES = [(1, 2, 37, 150), (2, 2, 33, 72), (1, 2, 130, 260)]


@pytest.mark.parametrize("shape", SUBSTAGE_SHAPES)
@pytest.mark.parametrize("pattern", WIND_PATTERNS)
def test_substage_kernels_on_adversarial_winds(cuda, shape, pattern):
    """Winds of random signs, exact zeros, one sign, or a checkerboard
    (every face split between two signs): both substages of the solo
    kernel against the twin, the halo kernel on two slabs against the
    twin shard by shard, and the assembled slabs against the solo kernel
    bit for bit."""
    L, _, ny, nx = shape
    h = 1.0 / nx
    v = wind_field(shape, pattern, 60, cuda)
    dt = torch.tensor([0.5 * h, 0.35 * h][:L], device=cuda)
    hk.reset_launches()
    got = hk.fused_advect_heun(v, h, 4e-5, dt)
    ref = hk.fused_advect_heun_plain(v, h, 4e-5, dt)
    torch.cuda.synchronize()
    assert hk.launches["fused_advect_heun"] == 2
    assert float((got - ref).abs().max() / ref.abs().max()) <= 2e-6
    mesh = make_mesh(devices=[cuda] * 2)
    s = split_x(v, mesh)
    assert torch.equal(gather_x(fused_advect_heun_sharded(s, h, 4e-5, dt)),
                       got)
    aux = exchange_x(s, 3)
    facs = hk._substage_facs(dt, h, 4e-5, (L,), L, torch.float32, cuda)
    for d in range(2):
        args = (s.parts[d], None, aux[d], facs, 0.5, 1 / h ** 2, d == 0,
                d == 1)
        k = hk.advect_substage_halo(*args)
        p = hk.advect_substage_halo_plain(*args)
        assert float((k - p).abs().max() / p.abs().max()) <= 2e-6


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
    assert hk.launches["jacobi_halo_sweep"] == 3
    assert torch.equal(split, solo)
    twin = hk.jacobi_sweeps_plain(e, r, 0.8, 3, from_zero)
    assert float((split - twin).abs().max() / twin.abs().max()) <= 2e-6


@pytest.mark.parametrize("shape", [
    (2, 70, 134), (1, 2, 43, 157), (1, 2, 43, 156), (2, 2, 39, 77),
    (3, 2, 70, 262), (1, 2, 1006, 1507)])
@pytest.mark.parametrize("pattern", ["normal", "checker", "zeros"])
def test_advect_rhs_kernel_vs_twin(cuda, shape, pattern):
    """Ragged tiles (ny % 32, nx % 128), odd pitches (4-byte copies) and
    even ones (8-byte), a member stack; checker winds split every face and
    overflow each warp's queue every row, zeros take the minus stencil."""
    lab = wind_field(shape, pattern, 14, cuda)
    hk.reset_launches()
    got = hk.advect_diffuse_rhs(lab, 1 / 128, 4e-5, 0.5 / 128)
    ref = hk.advect_diffuse_rhs_plain(lab, 1 / 128, 4e-5, 0.5 / 128)
    torch.cuda.synchronize()
    assert hk.launches["advect_diffuse_rhs"] == 1
    assert got.shape == shape[:-2] + (shape[-2] - 6, shape[-1] - 6)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 2e-6


def test_advect_rhs_kernel_copies_4_bytes_where_8_cannot(cuda):
    """An odd pitch (nx + 6) and a lab off the 8-byte grid run the 4-byte
    copies rather than being refused, and give the bits the 8-byte copies
    give from an aligned copy of the same lab."""
    odd = wind_field((2, 2, 40, 77), "normal", 16, cuda)
    assert hk.advect_rhs_plan(2, 34, 71, 132, True)[0] == 1
    got = hk.advect_diffuse_rhs(odd, 1 / 71, 4e-5, 0.5 / 71)
    ref = hk.advect_diffuse_rhs_plain(odd, 1 / 71, 4e-5, 0.5 / 71)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 2e-6
    buf = wind_field((2 * 40 * 76 + 1,), "normal", 17, cuda)
    off = buf[1:].view(1, 2, 40, 76)
    assert off.data_ptr() % 8 != 0
    assert hk.advect_rhs_plan(1, 34, 70, 132, False)[0] == 1
    aligned = off.clone()
    assert aligned.data_ptr() % 8 == 0
    hk.reset_launches()
    a = hk.advect_diffuse_rhs(off, 1 / 70, 4e-5, 0.5 / 70)
    b = hk.advect_diffuse_rhs(aligned, 1 / 70, 4e-5, 0.5 / 70)
    torch.cuda.synchronize()
    assert hk.launches["advect_diffuse_rhs"] == 2
    assert torch.equal(a, b)


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


# ---------------------------------------------------------------------------
# boundary-table forms
# ---------------------------------------------------------------------------

BC_TABLES = {
    "cavity": tcases.cavity_table(1.0),
    "channel_uniform": tcases.channel_table(1.0),
    "channel_parabolic": tcases.channel_table(1.0, profile="parabolic"),
    "outflow_y": tbc.BCTable(tbc.no_slip(), tbc.no_slip(),
                             tbc.dirichlet_inflow(0.0, 1.0,
                                                  profile="parabolic"),
                             tbc.convective_outflow()),
}
# one tile with all four walls, ragged tiles with 4-byte rows, a member
# stack, and tiles that straddle a y wall and an x wall at once
BC_SHAPES = [(1, 2, 24, 100), (1, 2, 64, 96), (3, 2, 40, 72),
             (1, 2, 37, 150), (2, 2, 33, 70), (1, 2, 130, 260)]


@pytest.mark.parametrize("name", sorted(BC_TABLES))
@pytest.mark.parametrize("shape", BC_SHAPES)
def test_advect_heun_bc_kernel_vs_twin(cuda, name, shape):
    bc = BC_TABLES[name]
    h = 1.0 / shape[-1]
    v = _rand(shape, 31, cuda)
    dt = torch.tensor([0.5 * h, 0.35 * h, 0.27 * h][:shape[0]],
                      device=cuda)
    hk.reset_launches()
    got = hk.fused_advect_heun(v, h, 4e-5, dt, bc=bc)
    ref = hk.fused_advect_heun_plain(v, h, 4e-5, dt, bc=bc)
    torch.cuda.synchronize()
    assert hk.launches["fused_advect_heun"] == 2
    assert hk.launches["fused_advect_heun+bc"] == 2
    assert float((got - ref).abs().max() / ref.abs().max()) <= 2e-6


@pytest.mark.parametrize("signs", [(1.0, -1.0, 1.0, 1.0),
                                   (-1.0, 1.0, 1.0, -1.0),
                                   (1.0, 1.0, 1.0, 1.0)])
def test_correction_signed_kernel_vs_twin(cuda, signs):
    x, p, v = (_rand((2, 48, 80), 32, cuda), _rand((2, 48, 80), 33, cuda),
               _rand((2, 2, 48, 80), 34, cuda))
    scal = torch.stack([torch.zeros(2, device=cuda),
                        torch.zeros(2, device=cuda),
                        torch.tensor([-1e-4, -2e-4], device=cuda)], -1)
    hk.reset_launches()
    got = hk.fused_correction(x, p, v, scal.contiguous(), 6400.0,
                              grad_signs=signs)
    ref = hk.fused_correction_plain(x, p, v, scal, 6400.0, grad_signs=signs)
    torch.cuda.synchronize()
    assert hk.launches["fused_correction+bc"] == 1
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 5e-6
    if signs == (1.0, 1.0, 1.0, 1.0):
        for a, b in zip(got, hk.fused_correction(x, p, v, scal.contiguous(),
                                                 6400.0)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shape", JACOBI_SHAPES)
@pytest.mark.parametrize("from_zero", [False, True])
def test_jacobi_signed_kernel_shapes_vs_twin(cuda, shape, from_zero):
    L, ny, nx, n = shape
    signs = (1.0, -1.0, 1.0, 1.0)
    e, r = _rand((L, ny, nx), 35, cuda), _rand((L, ny, nx), 36, cuda)
    hk.reset_launches()
    got = hk.fused_jacobi_sweeps(e, r, 0.8, n, from_zero, edge_signs=signs)
    ref = hk.jacobi_sweeps_plain(e, r, 0.8, n, from_zero, edge_signs=signs)
    torch.cuda.synchronize()
    assert hk.launches["fused_jacobi_sweeps+bc"] == len(hk.sweep_chain(n))
    assert float((got - ref).abs().max() / ref.abs().max()) <= 2e-6
    same = hk.fused_jacobi_sweeps(e, r, 0.8, n, from_zero,
                                  edge_signs=(1.0, 1.0, 1.0, 1.0))
    assert torch.equal(same, hk.fused_jacobi_sweeps(e, r, 0.8, n, from_zero))


def test_bc_kernel_forms_refuse_periodic(cuda):
    """The periodic tables run the wrap forms (below); what refuses is a
    bf16 periodic substage, a lone periodic sign and a bf16 wrap chain."""
    v = torch.zeros(1, 2, 16, 16, device=cuda, dtype=torch.bfloat16)
    facs = torch.zeros(1, 3, device=cuda)
    with pytest.raises(ValueError, match="periodic"):
        hk.advect_substage(v, None, facs, 0.5, 1.0,
                           tcases.periodic_channel_table(), 0.1)
    e = torch.zeros(16, 16, device=cuda)
    with pytest.raises(ValueError, match="periodic"):
        hk.fused_jacobi_sweeps(e, e, 0.8, 2, edge_signs=(0, 1, 1, 1))
    with pytest.raises(ValueError, match="f32 only"):
        hk.fused_jacobi_sweeps(e.bfloat16(), e.bfloat16(), 0.8, 2,
                               edge_signs=(0, 0, 1, 1))


# ---------------------------------------------------------------------------
# wrap forms (periodic tables) and the batched Thomas scans
# ---------------------------------------------------------------------------

WRAP_TABLES = {
    "doubly": tcases.periodic_table(),
    "periodic_x": tcases.periodic_channel_table(),
    "periodic_y": tbc.BCTable(tbc.no_slip(), tbc.no_slip(), tbc.periodic(),
                              tbc.periodic()),
    "periodic_x_inflow": tbc.BCTable(
        tbc.periodic(), tbc.periodic(),
        tbc.dirichlet_inflow(0.0, 1.0, profile="parabolic"),
        tbc.convective_outflow()),
}
# a field narrower than the halo (the wrap spans several periods), one
# tile, ragged tiles with 4-byte rows, a member stack, several tiles
WRAP_SHAPES = [(1, 2, 8, 8), (1, 2, 24, 100), (1, 2, 37, 150),
               (3, 2, 40, 72), (1, 2, 130, 260)]


def _wrap_signs(bc):
    return tbc.pressure_signs(bc), tbc.periodic_axes(bc)


@pytest.mark.parametrize("name", sorted(WRAP_TABLES))
@pytest.mark.parametrize("shape", WRAP_SHAPES)
def test_advect_heun_wrap_kernel_vs_twin(cuda, name, shape):
    bc = WRAP_TABLES[name]
    h = 1.0 / shape[-1]
    v = _rand(shape, 41, cuda)
    dt = torch.tensor([0.5 * h, 0.35 * h, 0.27 * h][:shape[0]],
                      device=cuda)
    hk.reset_launches()
    got = hk.fused_advect_heun(v, h, 4e-5, dt, bc=bc)
    ref = hk.fused_advect_heun_plain(v, h, 4e-5, dt, bc=bc)
    torch.cuda.synchronize()
    assert hk.launches["fused_advect_heun+pd"] == 2
    assert hk.launches["fused_advect_heun+bc"] == 2
    assert float((got - ref).abs().max() / ref.abs().max()) <= 2e-6


@pytest.mark.parametrize("name", sorted(WRAP_TABLES))
@pytest.mark.parametrize("shape", [(2, 48, 80), (1, 8, 8), (1, 37, 150)])
def test_correction_wrap_kernel_vs_twin(cuda, name, shape):
    signs, paxes = _wrap_signs(WRAP_TABLES[name])
    L = shape[0]
    x, p = _rand(shape, 42, cuda), _rand(shape, 43, cuda)
    v = _rand((L, 2) + shape[1:], 44, cuda)
    scal = torch.stack([x.mean((1, 2)), p.mean((1, 2)),
                        torch.full((L,), -1e-4, device=cuda)], -1)
    hk.reset_launches()
    got = hk.fused_correction(x, p, v, scal.contiguous(), 6400.0, signs)
    ref = hk.fused_correction_plain(x, p, v, scal, 6400.0, signs, paxes)
    torch.cuda.synchronize()
    assert hk.launches["fused_correction+pd"] == 1
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 5e-6


@pytest.mark.parametrize("name", ["doubly", "periodic_x", "periodic_y"])
@pytest.mark.parametrize("shape", JACOBI_SHAPES)
@pytest.mark.parametrize("from_zero", [False, True])
def test_jacobi_wrap_kernel_shapes_vs_twin(cuda, name, shape, from_zero):
    signs, paxes = _wrap_signs(WRAP_TABLES[name])
    L, ny, nx, n = shape
    e, r = _rand((L, ny, nx), 45, cuda), _rand((L, ny, nx), 46, cuda)
    hk.reset_launches()
    got = hk.fused_jacobi_sweeps(e, r, 0.8, n, from_zero, signs)
    ref = hk.jacobi_sweeps_plain(e, r, 0.8, n, from_zero, signs, paxes)
    torch.cuda.synchronize()
    assert hk.launches["fused_jacobi_sweeps+pd"] == len(
        hk.sweep_chain(n, wrap=True))
    assert float((got - ref).abs().max() / ref.abs().max()) <= 2e-6


@pytest.mark.parametrize("shape", [(1, 64, 33), (3, 37, 20), (2, 9, 1),
                                   (1, 1024, 513)])
def test_tridiag_scan_kernel_vs_twin(cuda, shape):
    L, n_s, nk = shape
    rng = np.random.default_rng(47)
    b = torch.tensor(rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape),
                     dtype=torch.complex64, device=cuda)
    # a diagonally dominant system's coefficients: |cp| < 1
    d = -2.0 - 2.0 * rng.random((n_s, nk))
    cp, idn = np.empty((n_s, nk)), np.empty((n_s, nk))
    idn[0], cp[0] = 1.0 / d[0], 1.0 / d[0]
    for j in range(1, n_s):
        idn[j] = 1.0 / (d[j] - cp[j - 1])
        cp[j] = idn[j]
    cp[-1] = 0.0
    idn = torch.tensor(idn, dtype=torch.float32, device=cuda)
    cp = torch.tensor(cp, dtype=torch.float32, device=cuda)
    hk.reset_launches()
    got = hk.tridiag_scan(b, idn, cp)
    ref = hk.tridiag_scan_plain(b, idn, cp)
    torch.cuda.synchronize()
    assert hk.launches["tridiag_scan"] == 1
    # the kernel rounds each product and difference as the twin does
    assert torch.equal(got, ref)


@pytest.mark.parametrize("pois", ["", "fas", "fftd"])
@pytest.mark.parametrize("table", ["periodic", "periodic_channel"])
def test_periodic_step_on_the_card_matches_cpu(cuda, monkeypatch, pois,
                                               table):
    monkeypatch.setenv("CUP2D_POIS", pois)
    cfg = SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                    extent=1.0, nu=1e-3, cfl=0.4, dtype="float32",
                    poisson_tol=1e-4, poisson_tol_rel=1e-3)
    bc = getattr(tcases, f"{table}_table")()
    sims = [UniformSim(cfg, level=3, device=d, bc=bc) for d in (cuda, "cpu")]
    for s in sims:
        s.state = bench_state(s.grid)._replace(pres=s.grid.zero_state().pres)
        s.step_count = 10
    hk.reset_launches()
    iters = [[s.step_once()["poisson_iters"] for _ in range(5)]
             for s in sims]
    la = dict(hk.launches)
    assert iters[0] == iters[1]
    a, b = sims[0].state.vel.cpu(), sims[1].state.vel
    assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
    assert la["fused_advect_heun+pd"] == la["fused_advect_heun"] == 10
    assert la["fused_correction+pd"] == la["fused_correction"] == 5
    assert la["fused_jacobi_sweeps+pd"] == la["fused_jacobi_sweeps"]
    assert (la["fused_jacobi_sweeps"] > 0) == (pois == "fas")
    assert (la["tridiag_scan"] > 0) == (pois == "fftd"
                                        and table == "periodic_channel")


@pytest.mark.parametrize("pois", ["", "fas"])
def test_cavity_on_the_card_matches_cpu(cuda, monkeypatch, pois):
    """Five step_once steps of the 64^2 f32 cavity from a seeded start on
    the card and on the CPU: the BC forms launch (the sweep chain's under
    fas only), and the states agree to 1e-4 relative."""
    monkeypatch.setenv("CUP2D_POIS", pois)
    sims = [tcases.make_sim("cavity", level=3, device=d)
            for d in (cuda, "cpu")]
    v0 = np.random.default_rng(37).standard_normal((2, 64, 64)) * 0.1
    for s in sims:
        s.state = s.state._replace(vel=s.grid.tensor(v0))
    hk.reset_launches()
    for _ in range(5):
        for s in sims:
            s.step_once()
    torch.cuda.synchronize()
    assert hk.launches["fused_advect_heun+bc"] == 10
    assert hk.launches["fused_correction+bc"] == 5
    assert (hk.launches["fused_jacobi_sweeps+bc"] > 0) == (pois == "fas")
    assert sims[0].kernel_tier == "hopper+bc(ns,ns,ns,ns(1,0))"
    a, b = sims[0].state.vel.cpu(), sims[1].state.vel
    assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# bf16 forms (CUP2D_PREC=bf16)
# ---------------------------------------------------------------------------

BF16_ULP = 2.0 ** -7


def _bf16_close(got, ref, ulps=1):
    assert got.dtype == ref.dtype == torch.bfloat16
    rel = float((got.float() - ref.float()).abs().max()
                / ref.float().abs().max())
    share = float((got == ref).float().mean())
    assert rel <= ulps * BF16_ULP, rel
    assert share >= 0.99, share


# ragged shapes (2-byte loads where nx % 4), member stacks, tiles across
# both walls
BF16_SHAPES = [(1, 2, 64, 96), (3, 2, 48, 72), (2, 2, 33, 70),
               (1, 2, 130, 260)]


@pytest.mark.parametrize("table", [None, "cavity", "channel_parabolic"])
@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_advect_heun_bf16_kernel_vs_twin(cuda, table, shape):
    bc = None if table is None else BC_TABLES[table]
    L, _, ny, nx = shape
    h = 1.0 / nx
    v = _rand(shape, 41, cuda)
    dt = torch.tensor([0.5 * h, 0.35 * h, 0.27 * h][:L], device=cuda)
    facs = hk._substage_facs(dt, h, 4e-5, (L,), L, torch.float32, cuda,
                             with_dt=bc is not None)
    vb = v.to(torch.bfloat16)
    hk.reset_launches()
    s1 = hk.advect_substage(vb, None, facs, 0.5, 1 / h ** 2, bc, h)
    _bf16_close(s1, hk.advect_substage_plain(vb, None, facs, 0.5,
                                             1 / h ** 2, bc, h))
    s2 = hk.advect_substage(s1, vb, facs, 1.0, 1 / h ** 2, bc, h,
                            torch.float32)
    ref = hk.advect_substage_plain(s1, vb, facs, 1.0, 1 / h ** 2, bc, h,
                                   torch.float32)
    assert s2.dtype == torch.float32
    assert float((s2 - ref).abs().max() / ref.abs().max()) <= 2e-6
    pair = hk.fused_advect_heun(v, h, 4e-5, dt, bc=bc, bf16=True)
    twin = hk.fused_advect_heun_plain(v, h, 4e-5, dt, bc=bc, bf16=True)
    torch.cuda.synchronize()
    assert float((pair - twin).abs().max() / twin.abs().max()) <= 2e-2
    assert hk.launches["fused_advect_heun+bf16"] == 4
    assert hk.launches["fused_advect_heun+bc+bf16"] == (0 if bc is None
                                                        else 4)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_halo_substage_bf16_kernel_vs_twin_and_solo_kernel(cuda, D):
    h = 1.0 / 96
    v = _rand((2, 2, 48, 96), 42, cuda)
    dt = torch.tensor([0.5 * h, 0.3 * h], device=cuda)
    mesh = make_mesh(devices=[cuda] * D)
    hk.reset_launches()
    split = gather_x(fused_advect_heun_sharded(split_x(v, mesh), h, 4e-5,
                                               dt, bf16=True))
    solo = hk.fused_advect_heun(v, h, 4e-5, dt, bf16=True)
    torch.cuda.synchronize()
    assert hk.launches["advect_substage_halo+bf16"] == 2 * D
    assert torch.equal(split, solo)
    s = split_x(v.to(torch.bfloat16), mesh)
    aux = exchange_x(s, 3)
    facs = hk._substage_facs(dt, h, 4e-5, (2,), 2, torch.float32, cuda)
    for d in range(D):
        args = (s.parts[d], None, aux[d], facs, 0.5, 1 / h ** 2, d == 0,
                d == D - 1)
        _bf16_close(hk.advect_substage_halo(*args),
                    hk.advect_substage_halo_plain(*args))


@pytest.mark.parametrize("shape", JACOBI_SHAPES)
@pytest.mark.parametrize("signs", [None, (1.0, -1.0, 1.0, 1.0)])
@pytest.mark.parametrize("from_zero", [False, True])
def test_jacobi_bf16_kernel_vs_twin(cuda, shape, signs, from_zero):
    L, ny, nx, n = shape
    e = _rand((L, ny, nx), 43, cuda).to(torch.bfloat16)
    r = _rand((L, ny, nx), 44, cuda).to(torch.bfloat16)
    hk.reset_launches()
    got = hk.fused_jacobi_sweeps(e, r, 0.8, n, from_zero, signs)
    ref = hk.jacobi_sweeps_bf16_plain(e, r, 0.8, n, from_zero, signs)
    torch.cuda.synchronize()
    launches = len(hk.sweep_chain(n, bf16=True))
    assert hk.launches["fused_jacobi_sweeps+bf16"] == launches
    assert hk.launches["fused_jacobi_sweeps+bc+bf16"] == (
        0 if signs is None else launches)
    _bf16_close(got, ref, ulps=n)


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("from_zero", [False, True])
def test_halo_jacobi_bf16_kernel_vs_twin_and_solo_kernel(cuda, D,
                                                         from_zero):
    e = _rand((72, 136), 45, cuda).to(torch.bfloat16)
    r = _rand((72, 136), 46, cuda).to(torch.bfloat16)
    mesh = make_mesh(devices=[cuda] * D)
    hk.reset_launches()
    split = gather_x(overlap_jacobi_sweeps(split_x(e, mesh), split_x(r, mesh),
                                           0.8, 3, from_zero))
    solo = hk.fused_jacobi_sweeps(e, r, 0.8, 3, from_zero)
    torch.cuda.synchronize()
    assert hk.launches["jacobi_halo_sweep+bf16"] == 3
    assert torch.equal(split, solo)
    _bf16_close(split, hk.jacobi_sweeps_bf16_plain(e, r, 0.8, 3, from_zero),
                ulps=3)


def test_bf16_kernels_refuse_mixed_storage(cuda):
    e = torch.zeros(16, 16, device=cuda)
    with pytest.raises(TypeError, match="storage dtype"):
        hk.fused_jacobi_sweeps(e, e.to(torch.bfloat16), 0.8, 2)
    v = torch.zeros(1, 2, 16, 16, device=cuda)
    facs = torch.zeros(1, 2, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        hk.advect_substage(v.to(torch.bfloat16), None,
                           facs.to(torch.bfloat16), 0.5, 1.0)
    with pytest.raises(TypeError, match="bfloat16"):
        hk.advect_substage(v, None, facs, 0.5, 1.0,
                           out_dtype=torch.bfloat16)


@pytest.mark.parametrize("pois", ["", "fas"])
def test_sharded_bf16_step_on_one_card_equals_solo(cuda, monkeypatch,
                                                   pois):
    """Two exact and two production steps under CUP2D_PREC=bf16 of a
    D = 2 split on cuda:0 against the solo bf16 step: equal iterations,
    bit for bit; every substage launch a bf16 one, and under fas every
    sweep."""
    monkeypatch.setenv("CUP2D_POIS", pois)
    monkeypatch.setenv("CUP2D_PREC", "bf16")
    cfg = SimConfig(bpdx=2, bpdy=1, level_max=1, level_start=0,
                    extent=2.0, nu=4e-5, cfl=0.5, dtype="float32")
    solo = UniformSim(cfg, level=5, device=cuda)
    solo.state = bench_state(solo.grid)
    sh = ShardedUniformSim(cfg, make_mesh(devices=[cuda] * 2), level=5)
    sh.set_state(bench_state(sh.grid))
    solo.step_count = sh.step_count = 8
    hk.reset_launches()
    for _ in range(4):
        ds, dh = solo.step_once(), sh.step_once()
        assert ds["poisson_iters"] == dh["poisson_iters"]
    torch.cuda.synchronize()
    la = hk.launches
    assert la["advect_substage_halo+bf16"] == la["advect_substage_halo"] > 0
    assert la["fused_advect_heun+bf16"] == la["fused_advect_heun"] > 0
    assert la["jacobi_halo_sweep+bf16"] == la["jacobi_halo_sweep"]
    assert la["fused_jacobi_sweeps+bf16"] == la["fused_jacobi_sweeps"]
    assert (la["fused_jacobi_sweeps"] > 0) == (pois == "fas")
    assert torch.equal(unshard_state(sh.state).vel, solo.state.vel)


# ---------------------------------------------------------------------------
# boundary-table forms of the x-split step's halo kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(BC_TABLES))
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("bf16", [False, True])
def test_halo_substage_bc_kernel_vs_twin_and_solo_kernel(cuda, name, D,
                                                         bf16):
    """The halo substage's boundary-table form: the assembled slabs equal
    the solo BC pair bit for bit (f32 and bf16), each shard's substages
    hold their twins as the solo forms do."""
    bc = BC_TABLES[name]
    L, ny, nx = 2, 48, 96
    h = 1.0 / nx
    v = _rand((L, 2, ny, nx), 51, cuda)
    dt = torch.tensor([0.5 * h, 0.3 * h], device=cuda)
    mesh = make_mesh(devices=[cuda] * D)
    hk.reset_launches()
    split = gather_x(fused_advect_heun_sharded(split_x(v, mesh), h, 4e-5,
                                               dt, bc=bc, bf16=bf16))
    solo = hk.fused_advect_heun(v, h, 4e-5, dt, bc=bc, bf16=bf16)
    torch.cuda.synchronize()
    suffix = "+bc+bf16" if bf16 else "+bc"
    assert hk.launches["advect_substage_halo" + suffix] == 2 * D
    assert torch.equal(split, solo)
    storage = torch.bfloat16 if bf16 else torch.float32
    s0 = split_x(v.to(storage), mesh)
    aux0 = exchange_x(s0, 3)
    facs = hk._substage_facs(dt, h, 4e-5, (L,), L, torch.float32, cuda,
                             with_dt=True)
    w = nx // D
    for d in range(D):
        kw = dict(bc=bc, h=h, col0=d * w, nx_tot=nx)
        a1 = (s0.parts[d], None, aux0[d], facs, 0.5, 1 / h ** 2, d == 0,
              d == D - 1)
        s1, r1 = hk.advect_substage_halo(*a1, **kw), \
            hk.advect_substage_halo_plain(*a1, **kw)
        if bf16:
            _bf16_close(s1, r1)
        else:
            assert float((s1 - r1).abs().max() / r1.abs().max()) <= 2e-6
        a2 = (s1, s0.parts[d], aux0[d], facs, 1.0, 1 / h ** 2, d == 0,
              d == D - 1, torch.float32)
        s2 = hk.advect_substage_halo(*a2, **kw)
        r2 = hk.advect_substage_halo_plain(*a2, **kw)
        assert float((s2 - r2).abs().max() / r2.abs().max()) <= 2e-6


@pytest.mark.parametrize("signs", [(1.0, 1.0, 1.0, 1.0),
                                   (1.0, -1.0, 1.0, 1.0)])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_halo_jacobi_signed_kernel_vs_solo_kernel(cuda, signs, D, from_zero,
                                                  bf16):
    """The signed halo sweep: three split sweeps equal three sweeps of the
    signed chain kernel bit for bit (f32 and bf16) and hold the chain's
    twin; both sign patterns of the tables (the cavity's, the channel's)."""
    storage = torch.bfloat16 if bf16 else torch.float32
    e = _rand((72, 136), 52, cuda).to(storage)
    r = _rand((72, 136), 53, cuda).to(storage)
    mesh = make_mesh(devices=[cuda] * D)
    hk.reset_launches()
    split = gather_x(overlap_jacobi_sweeps(split_x(e, mesh), split_x(r, mesh),
                                           0.8, 3, from_zero,
                                           edge_signs=signs))
    solo = hk.fused_jacobi_sweeps(e, r, 0.8, 3, from_zero, signs)
    torch.cuda.synchronize()
    suffix = "+bc+bf16" if bf16 else "+bc"
    assert hk.launches["jacobi_halo_sweep" + suffix] == 3
    assert torch.equal(split, solo)
    if bf16:
        _bf16_close(split, hk.jacobi_sweeps_bf16_plain(e, r, 0.8, 3,
                                                       from_zero, signs),
                    ulps=3)
    else:
        twin = hk.jacobi_sweeps_plain(e, r, 0.8, 3, from_zero, signs)
        assert float((split - twin).abs().max() / twin.abs().max()) <= 2e-6


@pytest.mark.parametrize("pois", ["", "fas"])
def test_sharded_cavity_on_one_card_matches_solo(cuda, monkeypatch, pois):
    """The 128^2 cavity split into 4 slabs of cuda:0, four production
    steps from the benchmark velocity against the solo cavity: equal
    iterations, velocity within 1e-5 relative; only the boundary-table
    halo forms launch."""
    monkeypatch.setenv("CUP2D_POIS", pois)
    solo = tcases.make_sim("cavity", level=4, device=cuda)
    sh = tcases.make_sim("cavity", level=4,
                         mesh=make_mesh(devices=[cuda] * 4))
    solo.state = bench_state(solo.grid)
    sh.set_state(bench_state(sh.grid))
    solo.step_count = sh.step_count = 10
    for _ in range(4):
        ds = solo.step_once()
        hk.reset_launches()
        dh = sh.step_once()
        assert ds["poisson_iters"] == dh["poisson_iters"]
        la = dict(hk.launches)
        assert la["advect_substage_halo+bc"] == la["advect_substage_halo"] \
            == 8
        assert la["jacobi_halo_sweep+bc"] == la["jacobi_halo_sweep"]
        assert (la["jacobi_halo_sweep"] > 0) == (pois == "fas"
                                                 and dh["poisson_iters"] > 0)
        assert la["fused_advect_heun"] == la["fused_correction"] == 0
    a, b = unshard_state(sh.state).vel, solo.state.vel
    assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# the periodic tables on the x-split step: the ring exchange and the y-wrap
# forms of the halo kernels
# ---------------------------------------------------------------------------

PD_TABLES = {"doubly": tcases.periodic_table(),
             "channel": tcases.periodic_channel_table(),
             "periodic_y": tbc.BCTable(tbc.no_slip(), tbc.no_slip(),
                                       tbc.periodic(), tbc.periodic())}


@pytest.mark.parametrize("name", sorted(PD_TABLES))
@pytest.mark.parametrize("D", [1, 2, 4])
def test_halo_substage_wrap_kernel_vs_twin_and_solo_kernel(cuda, name, D):
    """The halo substage's wrap form over a ring exchange: the assembled
    slabs equal kernel 2's solo wrap pair bit for bit, each shard's
    substages hold their twins (2e-6 relative)."""
    bc = PD_TABLES[name]
    px = tbc.periodic_axes(bc)[0]
    L, ny, nx = 2, 48, 96
    h = 1.0 / nx
    v = _rand((L, 2, ny, nx), 61, cuda)
    dt = torch.tensor([0.5 * h, 0.3 * h], device=cuda)
    mesh = make_mesh(devices=[cuda] * D)
    hk.reset_launches()
    split = gather_x(fused_advect_heun_sharded(split_x(v, mesh), h, 4e-5,
                                               dt, bc=bc))
    solo = hk.fused_advect_heun(v, h, 4e-5, dt, bc=bc)
    torch.cuda.synchronize()
    assert hk.launches["advect_substage_halo+pd"] == 2 * D
    assert torch.equal(split, solo)
    s0 = split_x(v, mesh)
    aux0 = exchange_x(s0, 3, ring=px)
    facs = hk._substage_facs(dt, h, 4e-5, (L,), L, torch.float32, cuda,
                             with_dt=True)
    w = nx // D
    walls = shard_halo._walls(s0, px)
    for d in range(D):
        kw = dict(bc=bc, h=h, col0=d * w, nx_tot=nx)
        a1 = (s0.parts[d], None, aux0[d], facs, 0.5, 1 / h ** 2, *walls[d])
        s1 = hk.advect_substage_halo(*a1, **kw)
        r1 = hk.advect_substage_halo_plain(*a1, **kw)
        assert float((s1 - r1).abs().max() / r1.abs().max()) <= 2e-6
        a2 = (s1, s0.parts[d], aux0[d], facs, 1.0, 1 / h ** 2, *walls[d])
        s2 = hk.advect_substage_halo(*a2, **kw)
        r2 = hk.advect_substage_halo_plain(*a2, **kw)
        assert float((s2 - r2).abs().max() / r2.abs().max()) <= 2e-6


@pytest.mark.parametrize("name", sorted(PD_TABLES))
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_halo_jacobi_wrap_kernel_vs_twin_and_solo_kernel(cuda, name, D,
                                                         from_zero, fused):
    """The halo sweep on a periodic table (its y-wrap form where y is
    periodic, the signed form on a ring where only x is): three split
    sweeps, as the slab list (``fused``) and per slab over a ring
    exchange, equal three sweeps of the chain kernel's wrap form bit for
    bit and hold its twin; each form holds its own twin."""
    signs = tbc.pressure_signs(PD_TABLES[name])
    px, py = tbc.periodic_axes(PD_TABLES[name])
    e, r = _rand((2, 72, 136), 62, cuda), _rand((2, 72, 136), 63, cuda)
    mesh = make_mesh(devices=[cuda] * D)
    es, rs = split_x(e, mesh), split_x(r, mesh)
    hk.reset_launches()
    if fused:
        split = overlap_jacobi_sweeps(es, rs, 0.8, 3, from_zero,
                                      edge_signs=signs)
    else:
        split = es
        for k in range(3):
            split = shard_halo.sweep_exchanged(split, rs, 0.8,
                                               from_zero and k == 0, signs)
    split = gather_x(split)
    solo = hk.fused_jacobi_sweeps(e, r, 0.8, 3, from_zero, signs)
    torch.cuda.synchronize()
    launched = 3 if fused else 3 * D
    assert hk.launches["jacobi_halo_sweep"] == launched
    assert hk.launches["jacobi_halo_sweep+pd"] == (launched if py else 0)
    assert torch.equal(split, solo)
    twin = hk.jacobi_sweeps_plain(e, r, 0.8, 3, from_zero, signs, (px, py))
    assert float((split - twin).abs().max() / twin.abs().max()) <= 2e-6
    aux = exchange_x(es, 1, ring=px)
    lst = hk.jacobi_halo_sweep_slabs(es.parts, rs.parts, 0.8, from_zero,
                                     signs)
    lst_twin = hk.jacobi_halo_sweep_slabs_plain(es.parts, rs.parts, 0.8,
                                                from_zero, signs)
    for d, (lo, hi) in enumerate(shard_halo._walls(rs, px)):
        a = (es.parts[d], rs.parts[d], aux[d], 0.8, lo, hi, from_zero,
             signs)
        k, p = hk.jacobi_halo_sweep(*a), hk.jacobi_halo_sweep_plain(*a)
        assert torch.equal(k, lst[d])
        for got, ref in ((k, p), (lst[d], lst_twin[d])):
            assert float((got - ref).abs().max() / ref.abs().max()) <= 2e-6


@pytest.mark.parametrize("case", ["tgv_periodic", "turb2d"])
@pytest.mark.parametrize("pois", ["", "fas"])
def test_split_periodic_step_on_one_card_matches_solo(cuda, monkeypatch,
                                                      case, pois):
    """A periodic case split into 4 slabs of cuda:0, four production steps
    against the solo case: equal iterations, velocity within 1e-5
    relative; the wrap forms of the halo kernels launch, no solo kernel."""
    monkeypatch.setenv("CUP2D_POIS", pois)
    solo = tcases.make_sim(case, level=4, device=cuda)
    sh = tcases.make_sim(case, level=4, mesh=make_mesh(devices=[cuda] * 4))
    solo.step_count = sh.step_count = 10
    for _ in range(4):
        ds = solo.step_once()
        hk.reset_launches()
        dh = sh.step_once()
        assert ds["poisson_iters"] == dh["poisson_iters"]
        la = dict(hk.launches)
        assert la["advect_substage_halo+pd"] == la["advect_substage_halo"] \
            == 8
        assert la["jacobi_halo_sweep+pd"] == la["jacobi_halo_sweep"]
        assert la["fused_advect_heun"] == la["fused_correction"] == 0
    a, b = unshard_state(sh.state).vel, solo.state.vel
    assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


@pytest.mark.parametrize("placement", ["member", "spatial"])
@pytest.mark.parametrize("pois", ["", "fas"])
def test_placed_fleet_on_one_card_matches_unplaced(cuda, monkeypatch,
                                                   placement, pois):
    """A turb2d fleet of 4 members placed on 2 shards of cuda:0 against the
    unplaced fleet: equal per-member iterations, every field within 1e-5
    relative; member placement launches kernel 2 once a shard, spatial
    placement the halo substage's wrap form."""
    from cup2d_tpu_torch.fleet import FleetSim
    from cup2d_tpu_torch.io import whole
    monkeypatch.setenv("CUP2D_POIS", pois)
    ref = tcases.make_sim("turb2d", level=4, members=4, device=cuda)
    sim = FleetSim(ref.cfg, level=4, members=4,
                   mesh=make_mesh(devices=[cuda] * 2), placement=placement,
                   bc=ref.grid.bc)
    sim.set_state(ref.state)
    ref.step_count = sim.step_count = 10
    for _ in range(3):
        dr = ref.step_once()
        hk.reset_launches()
        ds = sim.step_once()
        assert np.array_equal(dr["poisson_iters"], ds["poisson_iters"])
        la = dict(hk.launches)
        if placement == "member":
            assert la["fused_advect_heun"] == 4
            assert la["fused_correction"] == 2
        else:
            assert la["advect_substage_halo+pd"] == 4
            assert la["fused_advect_heun"] == 0
    for a, b in ((sim.state.vel, ref.state.vel),
                 (sim.state.pres, ref.state.pres)):
        a = whole(a)
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


# the slab list: one launch sweeps every slab of the card; slabs of 34
# (f32: no whole 16-byte rows, scalar runs), 68 and 136 columns, unequal
# widths, and operands off the 16-byte grid
HALO_SLAB_CUTS = {"1": [(0, 136)], "2": [(0, 68), (68, 136)],
                  "4": [(34 * d, 34 * d + 34) for d in range(4)],
                  "unequal": [(0, 8), (8, 40), (40, 53), (53, 136)]}


def _halo_slabs(x, cuts, offset=False):
    """The slabs of x [..., nx] at ``cuts``, each contiguous; ``offset``
    puts each one element past a 16-byte boundary."""
    out = []
    for a, b in cuts:
        part = x[..., a:b]
        if offset:
            flat = torch.empty(part.numel() + 1, dtype=x.dtype,
                               device=x.device)
            out.append(flat[1:].view(part.shape).copy_(part))
        else:
            out.append(part.contiguous())
    return out


@pytest.mark.parametrize("cuts", sorted(HALO_SLAB_CUTS))
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("signs", [None, (1.0, -1.0, 1.0, 1.0)])
@pytest.mark.parametrize("from_zero", [False, True])
def test_halo_slab_list_kernel_vs_twin(cuda, cuts, bf16, signs, from_zero):
    """One launch for every slab: bit for bit the per-slab kernel over an
    exchange (and, for a split of the field, the chain kernel's single
    sweep), whether runs are 16-byte words or single cells; the twin within
    the chain kernel's bars."""
    storage = torch.bfloat16 if bf16 else torch.float32
    e = _rand((2, 40, 136), 60, cuda).to(storage)
    r = _rand((2, 40, 136), 61, cuda).to(storage)
    c = HALO_SLAB_CUTS[cuts]
    es, rs = _halo_slabs(e, c), _halo_slabs(r, c)
    hk.reset_launches()
    got = hk.jacobi_halo_sweep_slabs(es, rs, 0.8, from_zero, signs)
    torch.cuda.synchronize()
    assert hk.launches["jacobi_halo_sweep"] == 1
    assert hk.launches["jacobi_halo_sweep+bc"] == (signs is not None)
    assert hk.launches["jacobi_halo_sweep+bf16"] == bf16
    mesh = make_mesh(devices=[cuda] * len(c))
    aux = exchange_x(shard_halo.Slabs(es, mesh), 1)
    for d, g in enumerate(got):
        per = hk.jacobi_halo_sweep(es[d], rs[d], aux[d], 0.8, d == 0,
                                   d == len(c) - 1, from_zero, signs)
        assert torch.equal(g, per), d
    odd = hk.jacobi_halo_sweep_slabs(_halo_slabs(e, c, True),
                                     _halo_slabs(r, c, True), 0.8,
                                     from_zero, signs)
    assert all(torch.equal(a, b) for a, b in zip(got, odd))
    whole = torch.cat(got, dim=-1)
    assert torch.equal(whole, hk.fused_jacobi_sweeps(e, r, 0.8, 1,
                                                     from_zero, signs))
    ref = torch.cat(hk.jacobi_halo_sweep_slabs_plain(es, rs, 0.8, from_zero,
                                                     signs), dim=-1)
    if bf16:
        _bf16_close(whole, ref)
    else:
        assert float((whole - ref).abs().max() / ref.abs().max()) <= 2e-6


def test_halo_slab_list_refuses_an_out_over_e(cuda):
    """A slab reads its neighbours' e while the launch writes out, so no
    out may overlap any slab of e."""
    e = _rand((16, 136), 62, cuda)
    es = _halo_slabs(e, HALO_SLAB_CUTS["2"])
    rs = _halo_slabs(_rand((16, 136), 63, cuda), HALO_SLAB_CUTS["2"])
    with pytest.raises(ValueError, match="overlaps"):
        hk.jacobi_halo_sweep_slabs(es, rs, 0.8, out=[es[0],
                                                     torch.empty_like(rs[1])])
    with pytest.raises(ValueError, match="overlaps"):
        hk.jacobi_halo_sweep_slabs(es, rs, 0.8, out=[torch.empty_like(rs[0]),
                                                     es[0]])
    out = [torch.empty_like(p) for p in rs]
    got = hk.jacobi_halo_sweep_slabs(es, rs, 0.8, out=out)
    assert all(g is o for g, o in zip(got, out))


@pytest.mark.parametrize("pattern", WIND_PATTERNS)
@pytest.mark.parametrize("n", [1, 33, 1000])
def test_lab_rhs_kernel_on_adversarial_winds(cuda, pattern, n):
    """The face-sharing lab RHS on winds that stress it (every neighbour
    of another sign, zeros, one sign): the twin per h class, and the same
    bits from labs off the 16-byte grid (4-byte copies)."""
    lab = wind_field((n, 2, 14, 14), pattern, 70, cuda)
    cls = torch.arange(n, device=cuda) % 3
    h = torch.tensor([1 / 64, 1 / 128, 1.0], device=cuda)[cls]
    dt = torch.tensor(0.5 / 128, device=cuda)
    got = hk.fused_lab_rhs(lab, h, 4e-5, dt)
    ref = hk.fused_lab_rhs_plain(lab, h.reshape(n, 1, 1, 1), 4e-5, dt)
    for c in range(min(n, 3)):
        d, r = (got - ref)[cls == c], ref[cls == c]
        assert float(d.abs().max()) <= 2e-6 * max(float(r.abs().max()),
                                                  1e-30)
    flat = torch.empty(lab.numel() + 1, device=cuda)
    odd = flat[1:].view(lab.shape).copy_(lab)
    assert torch.equal(hk.fused_lab_rhs(odd, h, 4e-5, dt), got)


ENTRY_SHAPES = ("angle=0 L=0.2 xpos=1.8 ypos=0.8\n"
                "angle=180 L=0.2 xpos=1.6 ypos=0.8")


@pytest.mark.parametrize("pois", ["", "fas"])
def test_shaped_step_on_the_card_matches_cpu(cuda, monkeypatch, pois):
    """The two fish of ``entry()`` at 128 x 64, f32: the card's state after
    its 10 exact startup steps carried to the CPU, then 5 production
    ``step_once`` steps on both with equal iterations; the velocity within
    1e-4 relative under fas, and within the solver's 1e-2 relative
    tolerance under the default solver, whose bf16 preconditioner cycle
    carries a one-ulp difference to ~1e-3 (ROADMAP queue 3). Two substage
    launches and one correction a step on the card, sweep chains under fas
    only. (The exact startup solves part between devices as between the
    packages: the shaped RHS is not mean-free.)"""
    from cup2d_tpu_torch import Simulation
    from cup2d_tpu_torch.convert import copy_simulation_state
    monkeypatch.setenv("CUP2D_POIS", pois)
    cfg = SimConfig(bpdx=2, bpdy=1, level_max=1, level_start=0,
                    extent=4.0, dtype="float32", nu=4e-5, lam=1e7, cfl=0.5,
                    shapes=ENTRY_SHAPES)
    card, cpu = (Simulation(cfg, level=3, device=d) for d in (cuda, "cpu"))
    hk.reset_launches()
    card.initialize()
    for _ in range(10):
        card.step_once()
    copy_simulation_state(card, cpu)
    for _ in range(5):
        assert card.step_once()["poisson_iters"] == \
            cpu.step_once()["poisson_iters"]
    a, b = card.state.vel.cpu(), cpu.state.vel
    assert bool(torch.isfinite(a).all())
    bar = 1e-4 if pois == "fas" else 1e-2
    assert float((a - b).abs().max() / b.abs().max()) <= bar
    assert hk.launches["fused_advect_heun"] == 30
    assert hk.launches["fused_correction"] == 15
    assert (hk.launches["fused_jacobi_sweeps"] > 0) == (pois == "fas")


def test_force_gathers_past_the_lab_on_the_card(cuda):
    """The force pass's block core with 2 ghosts on a tile whose body runs
    off its corner: the probe walk and the 5-point stencils index past the
    lab. The indices clamp as JAX clamps them, so the card raises no
    device-side assert, and it agrees with the CPU."""
    from cup2d_tpu_torch.ops import forces as tf
    ny = nx = 16
    G = 2
    h = 1.0 / ny
    x = (np.arange(nx) + 0.5) * h
    X, Y = np.meshgrid(x, x)
    own = 0.3 - np.hypot(X - 0.05, Y - 0.95)
    chi = np.clip(0.5 + own / (2 * h), 0.0, 1.0)
    rng = np.random.default_rng(71)
    pad = ((G, G), (G, G))
    vel = rng.standard_normal((2, ny, nx))
    args = [np.stack([np.pad(vel[c], pad, mode="edge") for c in range(2)]),
            rng.standard_normal((ny, nx)), np.pad(chi, pad, mode="edge"),
            np.pad(own, pad, mode="edge"),
            0.1 * rng.standard_normal((2, ny, nx)), own, X, Y,
            np.array([0.05, 0.95]), np.array([0.3, -0.1, 0.7])]
    outs = []
    for dev in (cuda, "cpu"):
        t = [torch.tensor(a, dtype=torch.float32, device=dev) for a in args]
        outs.append(tf.surface_forces_block(*t, 1e-3, h, G))
    torch.cuda.synchronize()
    for k, v in outs[1].items():
        assert abs(float(outs[0][k]) - float(v)) <= 1e-4 * max(
            abs(float(v)), 1.0), k


@pytest.mark.parametrize("pois", ["", "fas"])
def test_disk_forest_on_the_card_matches_cpu(cuda, monkeypatch, pois):
    """A free disk in a Taylor-Green forest at levelMax 3, f32: the card's
    state after ``initialize()`` and its 10 exact startup steps carried to
    the CPU (``convert.copy_amr_state``), then 5 production steps on both
    with an ``adapt()`` after the second: equal block keys and
    iterations, velocity and the disk's (u, v, omega) within 1e-4
    relative, forces on. Two lab-RHS launches a step on the card,
    block-Jacobi cycle updates under fas only (P_inv r, kernel 8's
    ``+pinv`` form, under both), no uniform kernel."""
    from cup2d_tpu_torch.amr import AMRSim
    from cup2d_tpu_torch.convert import copy_amr_state
    from cup2d_tpu_torch.models import DiskShape
    if pois:
        monkeypatch.setenv("CUP2D_POIS", pois)
    cfg = SimConfig(bpdx=2, bpdy=1, level_max=3, level_start=1, extent=1.0,
                    dtype="float32", nu=1e-3, lam=1e6, rtol=2.0, ctol=1.0)
    card, cpu = (AMRSim(cfg, shapes=[DiskShape(0.08, 0.55, 0.25)],
                        device=d) for d in (cuda, "cpu"))
    card.initialize()
    f = card.forest
    vel = card.fields()["vel"].cpu().numpy().copy()
    bs = cfg.bs
    for s in f.order():
        h = cfg.h_at(int(f.level[s]))
        x = (int(f.bi[s]) * bs + np.arange(bs) + 0.5) * h
        y = (int(f.bj[s]) * bs + np.arange(bs) + 0.5) * h
        X, Y = np.meshgrid(x, y, indexing="xy")
        vel[s, 0] = 0.2 * np.sin(np.pi * X) * np.cos(np.pi * Y)
        vel[s, 1] = -0.2 * np.cos(np.pi * X) * np.sin(np.pi * Y)
    f.fields["vel"] = torch.tensor(vel, device=cuda)
    hk.reset_launches()
    for _ in range(10):
        card.step_once()
    copy_amr_state(card, cpu)
    for k in range(5):
        if k == 2:
            assert card.adapt() == cpu.adapt()
            assert set(card.forest.blocks) == set(cpu.forest.blocks)
        assert card.step_once()["poisson_iters"] == \
            cpu.step_once()["poisson_iters"]
    idx = [torch.as_tensor(s.forest.order(), dtype=torch.long,
                           device=s.device) for s in (card, cpu)]
    a = card.fields()["vel"][idx[0]].cpu()
    b = cpu.fields()["vel"][idx[1]]
    assert bool(torch.isfinite(a).all())
    assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
    p, q = card.shapes[0], cpu.shapes[0]
    up, uq = np.array([p.u, p.v, p.omega]), np.array([q.u, q.v, q.omega])
    assert np.abs(up - uq).max() <= 1e-4 * max(np.abs(uq).max(), 1e-3)
    assert abs(p.forces["forcex"] - q.forces["forcex"]) <= 1e-3 * max(
        abs(q.forces["forcex"]), 1e-3)
    assert hk.launches["fused_lab_rhs"] == 2 * 15
    # FAS cycles launch kernel 8 under fas only; P_inv r, its +pinv form,
    # under both solvers
    cycles = (hk.launches["fused_block_jacobi_update"]
              - hk.launches["fused_block_jacobi_update+pinv"])
    assert (cycles > 0) == (pois == "fas")
    assert hk.launches["fused_block_jacobi_update+pinv"] > 0
    for k in ("fused_advect_heun", "fused_correction", "fused_jacobi_sweeps",
              "advect_substage_halo", "jacobi_halo_sweep"):
        assert hk.launches[k] == 0, k


def test_window_raster_padding_row_is_repeatable_on_the_card(cuda):
    """The window raster writes every padding window to the same dropped
    row N (an index copy with a repeated destination, each time the same
    value): two runs give the same bits, and the CPU's values."""
    from cup2d_tpu_torch.amr import AMRSim
    from cup2d_tpu_torch.models import DiskShape
    cfg = SimConfig(bpdx=2, bpdy=1, level_max=3, level_start=1, extent=1.0,
                    dtype="float32", nu=4e-5, lam=1e6, rtol=2.0, ctol=1.0)
    outs = []
    for dev in (cuda, cuda, "cpu"):
        sim = AMRSim(cfg, shapes=[DiskShape(0.08, 0.55, 0.25)], device=dev)
        sim.initialize()
        sim._wcap = [256]                      # >= 200 padding windows
        inp = sim._shape_inputs()[0]
        assert int((inp["pos"] < 0).sum()) > 200
        outs.append([x.cpu() for x in sim._window_raster(inp,
                                                          sim._npad_hwm)])
    for x, y in zip(outs[0], outs[1]):
        assert torch.equal(x, y)
    for x, y in zip(outs[0], outs[2]):
        assert float((x - y).abs().max()) <= 1e-6 * max(
            float(y.abs().max()), 1.0)


def test_surface_forces_blocks_past_the_lab_on_the_card(cuda):
    """The forest's batched force pass over [N] G = 4 labs whose body
    crosses block edges and runs off the field's corner: probes and
    stencils index past each block's lab. The indices clamp per block, so
    the card raises no device-side assert, and it agrees with the CPU."""
    from cup2d_tpu_torch.ops import forces as tf
    G, bs, ny, nx = 4, 8, 16, 24
    h = 1.0 / ny
    X, Y = np.meshgrid((np.arange(nx) + 0.5) * h, (np.arange(ny) + 0.5) * h)
    own = 0.45 - np.hypot(X - 0.05, Y - 0.95)
    chi = np.clip(0.5 + own / (2 * h), 0.0, 1.0)
    rng = np.random.default_rng(72)
    vel = rng.standard_normal((2, ny, nx))
    pad = ((G, G), (G, G))
    velp = np.stack([np.pad(vel[c], pad, mode="edge") for c in range(2)])
    chip, sdfp = np.pad(chi, pad, mode="edge"), np.pad(own, pad, mode="edge")
    pres = rng.standard_normal((ny, nx))
    udef = 0.1 * rng.standard_normal((2, ny, nx))
    blocks = [(j, i) for j in range(ny // bs) for i in range(nx // bs)]

    def lab(a, j, i):
        return a[..., j * bs:j * bs + bs + 2 * G, i * bs:i * bs + bs + 2 * G]

    def tile(a, j, i):
        return a[..., j * bs:(j + 1) * bs, i * bs:(i + 1) * bs]
    args = [np.stack([lab(velp, *b) for b in blocks]),
            np.stack([tile(pres, *b) for b in blocks]),
            np.stack([lab(chip, *b) for b in blocks]),
            np.stack([lab(sdfp, *b) for b in blocks]),
            np.stack([tile(udef, *b) for b in blocks]),
            np.stack([tile(own, *b) for b in blocks]),
            np.stack([tile(X, *b) for b in blocks]),
            np.stack([tile(Y, *b) for b in blocks]),
            np.array([0.05, 0.95]), np.array([0.3, -0.1, 0.7])]
    hb = h * (1.0 + (np.arange(len(blocks)) % 2))
    outs = []
    for dev in (cuda, "cpu"):
        t = [torch.tensor(a, dtype=torch.float32, device=dev) for a in args]
        outs.append(tf.surface_forces_blocks(
            *t[:8], t[8], t[9], 1e-3,
            torch.tensor(hb, dtype=torch.float32, device=dev), G=G))
    torch.cuda.synchronize()
    for k, v in outs[1].items():
        assert abs(float(outs[0][k]) - float(v)) <= 1e-4 * max(
            abs(float(v)), 1.0), k


@pytest.mark.parametrize("kind", ["uniform", "forest"])
def test_snapshot_clones_and_restores_twice_on_the_card(cuda, kind):
    """The device snapshot ring on the card: a snapshot clones every field
    (no storage shared with the live state) and reads nothing from the
    device; the lagged guard is bit for bit the unguarded run; one entry
    restores twice and each restore plus replay repeats the uninterrupted
    steps bit for bit."""
    from cup2d_tpu_torch import io as tio
    from cup2d_tpu_torch import shapes_host
    from cup2d_tpu_torch.resilience import StepGuard
    from cup2d_tpu_torch.uniform import taylor_green_state

    def mk():
        if kind == "uniform":
            cfg = SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                            extent=1.0, nu=1e-3, cfl=0.4, dtype="float32")
            sim = UniformSim(cfg, level=4, device=cuda)
            sim.state = taylor_green_state(sim.grid)
            sim.step_count = 20
            return sim
        cpu = multilevel_forest(dtype="float32", device="cpu")
        from cup2d_tpu_torch.amr import AMRSim
        sim = AMRSim(cpu.cfg, shapes=[], device=cuda)
        forest_from_numpy(sim, *forest_to_numpy(cpu))
        sim.step_count = 20
        return sim

    def vel(sim):
        if kind == "forest":
            return sim._ordered_state()["vel"].clone()
        return sim.state.vel.clone()

    a, b = mk(), mk()
    for _ in range(6):
        a.step_once()
    guard = StepGuard(b, snap_every=4)
    for _ in range(6):
        guard.step()
    guard.drain()
    assert b.async_diag and torch.equal(vel(a), vel(b)) and a.time == b.time
    live = (b._ordered_state() if kind == "forest"
            else b.state._asdict())
    pulls = shapes_host.pulls
    snap = tio.snapshot_state_device(b)
    assert shapes_host.pulls == pulls
    assert all(s.device == v.device and s.data_ptr() != v.data_ptr()
               for s, v in zip(snap.payload.values(), live.values()))
    ref, t_ref = vel(b), b.time
    for _ in range(2):
        assert guard._rewind_replay() == 2
        assert torch.equal(vel(b), ref) and b.time == t_ref
    pulls = shapes_host.pulls
    tio.restore_snapshot_device(b, snap)
    tio.restore_snapshot_device(b, snap)
    assert shapes_host.pulls == pulls
    assert torch.equal(vel(b), ref)


# ---------------------------------------------------------------------------
# the forest on a mesh (four shards of one card) and the forest's left-overs
# ---------------------------------------------------------------------------

def _vortex_start(cuda):
    """A ~400-block vortex forest (f32), its config and host state."""
    from cup2d_tpu_torch.amr import vortex_forest
    sim = vortex_forest(target=300, level_start=3, level_max=5, device=cuda)
    return sim.cfg, forest_to_numpy(sim)


@pytest.mark.parametrize("pois", ["structured", "fas"])
def test_sharded_forest_on_one_card_matches_solo(cuda, monkeypatch, pois):
    """A ShardedAMRSim on four shards of the card follows the solo AMRSim
    through an adapt and six production steps bit for bit: equal
    topologies and iterations, the same state (every full reduction takes
    the group partials of ``group_sum.cu`` in one order, P_inv r runs as
    kernel 8 per shard); the lab RHS, kernel 8 (the P_inv r form too) and
    the group partials launched once a shard where solo launches once,
    the block-Jacobi sweeps only under fas."""
    from cup2d_tpu_torch.amr import AMRSim
    from cup2d_tpu_torch.parallel.forest_mesh import ShardedAMRSim
    cfg, snap = _vortex_start(cuda)
    monkeypatch.setenv("CUP2D_POIS", pois)
    solo = AMRSim(cfg, shapes=[], device=cuda)
    split = ShardedAMRSim(cfg, make_mesh(devices=[cuda] * 4), shapes=[])
    out = {}
    for name, sim in (("solo", solo), ("split", split)):
        forest_from_numpy(sim, *snap)
        sim.step_count = 10
        sim.adapt()
        hk.reset_launches()
        iters = [sim.step_once()["poisson_iters"] for _ in range(6)]
        out[name] = (iters, dict(hk.launches), set(sim.forest.blocks),
                     {k: sim._gather(v)
                      for k, v in sim._ordered_state().items()})
    (it_a, la, ka, sa), (it_b, lb, kb, sb) = out["solo"], out["split"]
    assert ka == kb and it_a == it_b
    for k in ("vel", "pres"):
        assert torch.equal(sb[k], sa[k]), k
    assert lb["fused_lab_rhs"] == 4 * la["fused_lab_rhs"] == 4 * 12
    for k in ("fused_block_jacobi_update", "fused_block_jacobi_update+pinv",
              "group_sum"):
        assert lb[k] == 4 * la[k] > 0, k
    assert (la["fused_block_jacobi_update"]
            > la["fused_block_jacobi_update+pinv"]) == (pois == "fas")


def test_per_shard_kernels_match_twins(cuda):
    """Kernels 4 and 8 on one shard's [B, ...] operands of a split step
    (views of the [B + 1] lab buffer and of split blocks) against their
    twins at phase 2's bars."""
    from cup2d_tpu_torch.halo import assemble_labs_ordered
    from cup2d_tpu_torch.parallel.forest_mesh import ShardedAMRSim
    from cup2d_tpu_torch.parallel.shard_halo import (_structured_lap,
                                                     split_blocks)
    cfg, snap = _vortex_start(cuda)
    sim = ShardedAMRSim(cfg, make_mesh(devices=[cuda] * 4), shapes=[])
    forest_from_numpy(sim, *snap)
    sim._refresh()
    vel = sim._ordered_state()["vel"]
    labs = assemble_labs_ordered(vel, sim._tables["vec3"])
    dt = torch.tensor(1e-3, device=cuda)
    p_inv = torch.tensor(block_precond_matrix(8), dtype=torch.float32,
                         device=cuda)
    g = torch.Generator(device="cpu").manual_seed(3)
    n = sim._npad_hwm
    e = split_blocks(torch.randn(n, 8, 8, generator=g).to(cuda), sim.mesh)
    r = split_blocks(torch.randn(n, 8, 8, generator=g).to(cuda), sim.mesh)
    op = sim._tables["pois"]
    recvs = shard_halo._exchange_surface(e.parts, op)
    for d in range(4):
        lab, h = labs.parts[d], sim._h.parts[d]
        got = hk.fused_lab_rhs(lab, h, cfg.nu, dt)
        ref = hk.fused_lab_rhs_plain(lab, h, cfg.nu, dt)
        assert float((got - ref).abs().max()) \
            <= 2e-6 * max(float(ref.abs().max()), 1e-30)
        rows, mats = op.dev[d]
        lap = _structured_lap(e.parts[d],
                              torch.cat([e.parts[d], recvs[d]]), *rows, mats)
        got = hk.fused_block_jacobi_update(e.parts[d], r.parts[d], lap, p_inv)
        ref = hk.block_jacobi_plain(e.parts[d], r.parts[d], lap, p_inv)
        assert float((got - ref).abs().max()) \
            <= 2e-6 * float(ref.abs().max())


GROUP_FORMS = [(torch.float32, torch.float32),
               (torch.float32, torch.float64),
               (torch.float64, torch.float64)]


@pytest.mark.parametrize("dot", [False, True], ids=["sum", "dot"])
@pytest.mark.parametrize("ind,acc", GROUP_FORMS,
                         ids=["f32", "f32-into-f64", "f64"])
@pytest.mark.parametrize("m", [1024, 2048, 16, 7])
def test_group_sum_kernel_is_its_twin_bit_for_bit(cuda, dot, ind, acc, m):
    """group_sum.cu against its twin at 1, 8, 256 and 1,024 rows: the same
    bits, and a row's bits whatever the rows of the launch."""
    g = torch.Generator(device="cpu").manual_seed(m)
    a = torch.randn(1024, m, generator=g).to(ind).to(cuda)
    c = torch.randn(1024, m, generator=g).to(ind).to(cuda) if dot else None
    hk.reset_launches()
    first = hk.group_sum(a[:1], None if c is None else c[:1], acc)
    for G in (1, 8, 256, 1024):
        args = (a[:G], None if c is None else c[:G])
        got = hk.group_sum(*args, acc)
        assert got.dtype == acc and torch.equal(
            got, hk.group_sum_plain(*args, acc)), G
        assert torch.equal(got[:1], first), G
    torch.cuda.synchronize()
    assert hk.launches["group_sum"] == 5


def test_group_sum_refuses_what_the_kernel_does_not_take(cuda):
    a = torch.zeros(4, 16, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        hk.group_sum(a, None, torch.float32)
    with pytest.raises(ValueError):
        hk.group_sum(torch.zeros(2, 9000, device=cuda))
    with pytest.raises(ValueError):
        hk.group_sum(torch.zeros(4, 16, device=cuda).t())


def test_block_precond_kernel_rows_whatever_n(cuda):
    """Kernel 8 as P_inv r (e = lap = 0): within 2e-6 relative of its twin,
    and a block's bits the same in calls of 16, 1,000 and 16,384 blocks
    (the solo forest's and a shard's)."""
    p_inv = torch.tensor(block_precond_matrix(8), dtype=torch.float32,
                         device=cuda)
    r = _rand((16384, 8, 8), 7, cuda)
    zero = torch.zeros_like(r)
    hk.reset_launches()
    want = hk.block_precond(r, p_inv, zero)
    ref = hk.block_precond_plain(r, p_inv)
    assert float((want - ref).abs().max()) <= 2e-6 * float(ref.abs().max())
    for n in (16, 1000):
        got = hk.block_precond(r[:n].contiguous(), p_inv, zero[:n])
        assert torch.equal(got, want[:n]), n
    torch.cuda.synchronize()
    assert hk.launches["fused_block_jacobi_update+pinv"] == 3
    assert hk.launches["fused_block_jacobi_update"] == 3


def test_block_sum_on_four_shards_of_the_card_equals_solo(cuda):
    """``shard_halo.block_sum`` of blocks split over four shards of the
    card (each shard's group partials, then one sum) is the whole
    operand's bit for bit, the dot (f32 products, f64 partials) and the
    sum."""
    from cup2d_tpu_torch.parallel.shard_halo import block_sum, split_blocks
    x, y = _rand((2048, 8, 8), 8, cuda), _rand((2048, 8, 8), 9, cuda)
    mesh = make_mesh(devices=[cuda] * 4)
    bx, by = split_blocks(x, mesh), split_blocks(y, mesh)
    assert torch.equal(block_sum(bx, by, torch.float64),
                       block_sum(x, y, torch.float64))
    assert torch.equal(block_sum(bx), block_sum(x))


def test_native_regrid_helper_on_the_card_host(cuda):
    """The C regrid helper builds on the card's host and an adapt of a
    card forest gives the topology of the Python sweep."""
    from cup2d_tpu_torch.amr import AMRSim
    cfg, snap = _vortex_start(cuda)
    keys = []
    for twin in (False, True):
        sim = AMRSim(cfg, shapes=[], device=cuda)
        forest_from_numpy(sim, *snap)
        if twin:
            def fix(lv, bi, bj, st, sim=sim):
                state = {(int(lv[k]), int(bi[k]), int(bj[k])): int(st[k])
                         for k in range(len(st))}
                sim._fix_states_py(state)
                for k in range(len(st)):
                    st[k] = state[(int(lv[k]), int(bi[k]), int(bj[k]))]
            sim._fix_states = fix
        sim.adapt()
        keys.append(set(sim.forest.blocks))
    assert keys[0] == keys[1]


def test_tables_and_bf16_forest_on_the_card_match_cpu(cuda, monkeypatch):
    """CUP2D_POIS=tables (default tolerances 1e-6/1e-5) and CUP2D_PREC=bf16
    with fas on the 355-block forest: card against CPU over five steps
    with an adapt, 1e-4 and the bf16 band 2e-2 relative."""
    from cup2d_tpu_torch.amr import AMRSim
    for pois, prec, bar, kw in (("tables", "f32", 1e-4,
                                 dict(tol=1e-6, tol_rel=1e-5)),
                                ("fas", "bf16", 2e-2, {})):
        monkeypatch.setenv("CUP2D_POIS", pois)
        monkeypatch.setenv("CUP2D_PREC", prec)
        cpu = multilevel_forest(dtype="float32", device="cpu", **kw)
        card = AMRSim(cpu.cfg, shapes=[], device=cuda)
        forest_from_numpy(card, *forest_to_numpy(cpu))
        card.step_count = cpu.step_count
        for k in range(5):
            if k == 2:
                assert card.adapt() == cpu.adapt()
            card.step_once()
            cpu.step_once()
        a = card.fields()["vel"].cpu()
        b = cpu.fields()["vel"]
        rel = float((a[card.forest.order()] - b[cpu.forest.order()])
                    .abs().max() / b.abs().max())
        assert rel <= bar, (pois, prec, rel)


def test_world_on_cards_equals_one_process_over_the_same_cards(cuda,
                                                               tmp_path):
    """One NCCL rank a card (``torch.distributed.run``) against one
    process over the same cards (``cup2d_tpu_torch.dist_check``): the
    split uniform step (512^2, default and fas) and the split vortex
    forest (levels 3-5, structured and fas) bit for bit, equal
    iterations, edge columns and surfaces sent point to point."""
    import json
    import os
    import subprocess
    import sys
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs at least 2 cards: one NCCL rank a card")
    from cup2d_tpu_torch.dist_check import compare
    common = ["--size", "512", "--forest-target", "300", "--forest-levels",
              "3", "5", "--steps", "2", "--out", str(tmp_path)]
    runs = [[sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(n), "-m", "cup2d_tpu_torch.dist_check",
             "--layout", "ranks"] + common,
            [sys.executable, "-m", "cup2d_tpu_torch.dist_check", "--layout",
             "mesh"] + common]
    for cmd in runs:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        assert p.returncode == 0, p.stderr[-3000:]
    assert compare(str(tmp_path)) == 0
    with open(tmp_path / "ranks.json") as f:
        ranks = json.load(f)
    assert ranks["shards"] == n
    for name, run in ranks["runs"].items():
        assert run["comm_per_step"]["allgathers"] > 0, name
        assert run["comm_per_step"]["p2p_messages"] > 0, name
