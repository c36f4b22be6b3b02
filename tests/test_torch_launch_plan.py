"""Host-side launch plans of the sweep-chain and block-Jacobi kernels, and
the V-cycle chain table that chip_smoke.py and kernel_ab time per level.
Pure functions of shapes and the card's SM count: no card, no JAX."""

import pytest

from cup2d_tpu_torch.ops import hopper_kernels as hk
from cup2d_tpu_torch.ops.timing import bound, vcycle_chains

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
                                     (16384, 2 * SMS)])
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
