"""Host-side launch plans of the sweep-chain, block-Jacobi, substage and
single-op RHS kernels, the V-cycle chain table that chip_smoke.py and
kernel_ab time per level, the substage's and the single-op RHS's
reconstruction counts behind their bounds, kernel_ab's adversarial wind
fields, and the C entry points' argument counts. Pure functions of
shapes, data and the card's SM count: no card, no JAX."""

import numpy as np
import pytest
import torch

from cup2d_tpu_torch.kernel_ab import WIND_PATTERNS, _arity, wind_field
from cup2d_tpu_torch.ops import hopper_kernels as hk
from cup2d_tpu_torch.ops.timing import (OPS_LAB_RHS_REST,
                                        OPS_SUBSTAGE_REST, OPS_WENO_FACE,
                                        advect_rhs_ops, bound, substage_ops,
                                        vcycle_chains, weno_faces)

SMS = 132     # an H100 SXM


@pytest.mark.parametrize("n, chain", [
    (0, []), (1, [1]), (2, [2]), (6, [6]), (8, [6, 2]),
    (24, [6, 6, 6, 6]), (25, [6, 6, 6, 6, 1])])
def test_sweep_chain_splits_into_launches_of_at_most_six(n, chain):
    assert hk.sweep_chain(n) == chain
    assert sum(chain) == n


@pytest.mark.parametrize("shape, big", [
    ((1, 8192, 8192), True), ((1, 2048, 2048), True),
    ((1, 1024, 1024), False), ((1, 16, 16), False), ((1, 8, 8), False),
    ((4, 1024, 1024), True), ((3, 16, 16), False)])
def test_jacobi_plan_takes_the_big_tile_where_it_fills_the_card(shape, big):
    got, vec, grid = hk.jacobi_plan(*shape, 2, SMS, True)
    assert got is big
    assert vec == 4
    ty, w = hk.JACOBI_TILES[big]
    L, ny, nx = shape
    tiles = L * -(-ny // ty) * -(-nx // (w - 2 * 4))
    assert grid == min(tiles, SMS * hk.JACOBI_CTAS_PER_SM[big])


@pytest.mark.parametrize("nx, aligned, vec", [(136, True, 4), (150, True, 1),
                                              (1501, True, 1),
                                              (136, False, 1)])
def test_jacobi_plan_copies_16_bytes_only_on_whole_aligned_rows(nx, aligned,
                                                                vec):
    assert hk.jacobi_plan(1, 72, nx, 2, SMS, aligned)[1] == vec


@pytest.mark.parametrize("n", range(1, 7))
def test_jacobi_plan_halo_widens_in_16_byte_steps(n):
    """Five or six sweeps need an 8-column x halo, so the tile puts out
    fewer columns and a wide level needs more tiles."""
    grid = hk.jacobi_plan(1, 64, 600, n, 1000, True)[2]
    ty, w = hk.JACOBI_TILES[False]
    hx = 4 if n <= 4 else 8
    assert grid == -(-64 // ty) * -(-600 // (w - 2 * hx))


def test_launch_plans_never_exceed_the_tiles():
    for L in (1, 3):
        for ny in (8, 9, 33, 100, 1000):
            for nx in (8, 13, 64, 150, 1500):
                for n in (1, 2, 6):
                    big, _, grid = hk.jacobi_plan(L, ny, nx, n, SMS, True)
                    ty, w = hk.JACOBI_TILES[big]
                    hx = 4 * -(-n // 4)
                    tiles = L * -(-ny // ty) * -(-nx // (w - 2 * hx))
                    assert 1 <= grid <= tiles


@pytest.mark.parametrize("n, grid", [(1, 1), (32, 1), (33, 2), (1000, 32),
                                     (16384, 512), (65536, 4 * SMS)])
def test_block_jacobi_grid(n, grid):
    assert hk.block_jacobi_grid(n, SMS) == grid


def test_vcycle_chains_of_the_8192_hierarchy():
    """Ten levels from 8192^2 to 16^2 smooth twice with n = 2 (from zero,
    then from the corrected e), the 8^2 level runs 24 sweeps from zero:
    24 launches a cycle."""
    chains = vcycle_chains(8192)
    assert [s for s, _ in chains] == [8192 >> k for k in range(11)]
    assert all(c == [(2, True), (2, False)] for _, c in chains[:-1])
    assert chains[-1] == (8, [(24, True)])
    launches = sum(len(hk.sweep_chain(n)) for _, c in chains for n, _ in c)
    assert launches == 24


def test_bound_names_the_larger_time():
    ms, by = bound(12.0 * 8192 ** 2, 18.0 * 8192 ** 2)
    assert by == "bytes"
    assert ms == pytest.approx(12.0 * 8192 ** 2 / 3.35e12 * 1e3)
    assert bound(1.0, 1e9)[1] == "operations"


@pytest.mark.parametrize("shape, grid", [
    ((1, 8192, 8192), 2 * SMS), ((1, 8192, 2048), 2 * SMS),
    ((3, 256, 512), 3 * 8 * 4), ((1, 37, 150), 2 * 2),
    ((2, 33, 70), 2 * 2 * 1), ((1, 5, 4), 1)])
def test_substage_plan_grid_fills_the_sms_or_takes_every_tile(shape, grid):
    L, ny, nx = shape
    assert hk.substage_plan(L, ny, nx, SMS, True)[1] == grid
    ty, tx = hk.SUBSTAGE_TILE
    assert grid <= L * -(-ny // ty) * -(-nx // tx)


@pytest.mark.parametrize("nx, aligned, vec", [(8192, True, 4), (2048, True, 4),
                                              (150, True, 1), (1501, True, 1),
                                              (260, False, 1)])
def test_substage_plan_copies_16_bytes_only_on_whole_aligned_rows(nx, aligned,
                                                                  vec):
    assert hk.substage_plan(1, 64, nx, SMS, aligned)[0] == vec


@pytest.mark.parametrize("pattern, per_cell", [
    ("positive", None), ("negative", None), ("checker", 4.0)])
def test_weno_faces_counts_shared_and_split_faces(pattern, per_cell):
    """Winds of one sign share every inner face: (nx + 1) faces a row and
    (ny + 1) a column; a checkerboard splits every inner face: 4 per cell
    less the outer faces' second reconstruction."""
    L, ny, nx = 2, 5, 7
    v = wind_field((L, 2, ny, nx), pattern, 0, "cpu")
    shared = L * (ny * (nx + 1) + nx * (ny + 1))
    got = weno_faces(v)
    if per_cell is None:
        assert got == shared
    else:
        assert got == L * (ny * (2 * nx) + nx * (2 * ny))
        assert got == per_cell * L * ny * nx


def test_substage_ops_on_the_benchmark_pattern():
    """About 2 reconstructions per cell and component on a smooth field,
    so about 2 x (2 x 88 + 16) operations per cell."""
    n = 64
    y, x = np.meshgrid((np.arange(n) + 0.5) / n, (np.arange(n) + 0.5) / n,
                       indexing="ij")
    v = torch.tensor(np.stack([np.sin(np.pi * x) * np.cos(np.pi * y),
                               -np.cos(np.pi * x) * np.sin(np.pi * y)]
                              )[None], dtype=torch.float32)
    per = weno_faces(v) / (n * n)
    assert 2.0 < per < 2.1
    assert substage_ops(v) == pytest.approx(
        2 * (OPS_WENO_FACE * per + OPS_SUBSTAGE_REST) * n * n)


@pytest.mark.parametrize("shape, aligned, vec", [
    ((1, 8192, 8192), True, 2), ((3, 256, 512), True, 2),
    ((1, 37, 150), True, 2), ((1, 37, 151), True, 1),
    ((2, 33, 71), True, 1), ((1, 1000, 1501), True, 1),
    ((1, 8192, 8192), False, 1)])
def test_advect_rhs_plan_copies_8_bytes_on_even_pitches_else_4(shape,
                                                                aligned,
                                                                vec):
    """A lab row at nx = 8192 is 8198 floats: a whole number of 8-byte
    words, not of 16-byte ones. 8-byte copies need an even pitch nx + 6
    and an 8-byte aligned lab; otherwise the kernel copies 4 bytes at a
    time (it runs, it does not refuse). The grid is the substages'."""
    L, ny, nx = shape
    got_vec, grid = hk.advect_rhs_plan(L, ny, nx, SMS, aligned)
    assert got_vec == vec
    assert grid == hk.substage_plan(L, ny, nx, SMS, True)[1]


@pytest.mark.parametrize("pattern", ["normal", "checker", "positive",
                                     "zeros"])
def test_advect_rhs_ops_counts_each_face_once_where_its_winds_agree(
        pattern):
    """Over labs [L, 2, ny+6, nx+6] the interior's faces: nx + 1 a row and
    ny + 1 a column per component, an inner face twice where its two
    cells' winds differ in sign (strict: 0 counts as negative), and 13
    operations a cell and component besides them."""
    L, ny, nx = 2, 5, 9
    lab = wind_field((L, 2, ny + 6, nx + 6), pattern, 4, "cpu")
    u = lab[:, 0, 3:-3, 3:-3] > 0
    v = lab[:, 1, 3:-3, 3:-3] > 0
    brute = 0
    for m in range(L):
        for y in range(ny):
            for f in range(nx + 1):
                brute += 1 + (0 < f < nx
                              and bool(u[m, y, f - 1] != u[m, y, f]))
        for x in range(nx):
            for f in range(ny + 1):
                brute += 1 + (0 < f < ny
                              and bool(v[m, f - 1, x] != v[m, f, x]))
    assert advect_rhs_ops(lab) == 2 * (OPS_WENO_FACE * brute
                                       + OPS_LAB_RHS_REST * L * ny * nx)
    if pattern == "positive":
        assert brute == L * (ny * (nx + 1) + nx * (ny + 1))


@pytest.mark.parametrize("pattern", WIND_PATTERNS)
def test_wind_field_patterns(pattern):
    v = wind_field((2, 2, 12, 16), pattern, 3, "cpu")
    assert v.dtype == torch.float32 and v.shape == (2, 2, 12, 16)
    assert torch.equal(v, wind_field((2, 2, 12, 16), pattern, 3, "cpu"))
    if pattern == "positive":
        assert bool((v > 0).all())
    elif pattern == "negative":
        assert bool((v < 0).all())
    elif pattern == "zeros":
        assert 0.2 < float((v == 0).float().mean()) < 0.4
    elif pattern == "checker":
        p = v > 0
        assert bool((p[..., 1:] != p[..., :-1]).all())
        assert bool((p[..., 1:, :] != p[..., :-1, :]).all())
    elif pattern == "random_sign":
        assert 0.3 < float((v > 0).float().mean()) < 0.7


@pytest.mark.parametrize("stem", sorted(hk._ENTRIES))
def test_c_entry_points_take_the_arguments_their_wrappers_pass(stem):
    """ctypes passes what argtypes lists: a count that differs from the
    C signature shifts every later argument (the stream last)."""
    name, argtypes = hk._ENTRIES[stem]
    src = (hk._CSRC / f"{stem}.cu").read_text()
    assert _arity(src, name) == len(argtypes)
