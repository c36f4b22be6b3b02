"""Device timing of kernels on the card, and the per-level table of the
Multigrid sweep chain.

``cuda_ms`` times eager calls with CUDA events (host launch cost included
once the calls are short); ``graph_ms`` captures the calls in one CUDA
graph and replays it, so only device time counts. Both need a card.
"""

from __future__ import annotations

import torch

from .hopper_kernels import sweep_chain

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# f32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
OPS_SWEEP_CELL = 9           # 5 Laplacian, 4 update
# WENO substage operations, counting each add, multiply, compare, select,
# max, integer op and reciprocal as one: a reconstruction is 83 (33
# smoothness, 30 weights, 15 candidate stencils, 5 blend) and its 5
# operand selects; per cell and component besides its faces, 2
# differences, a 5-op Laplacian, a 6-op RHS and a 3-op update
OPS_WENO_FACE = 88
OPS_SUBSTAGE_REST = 16


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fns, reps: int = 24) -> float:
    """Device time per call: ``reps`` calls, cycling over ``fns`` (one per
    operand set, so that the sets together can exceed the 50 MB L2 and
    every call reads cold operands), captured in one CUDA graph and
    replayed, so host launch overhead does not count."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for k in range(reps):
            fns[k % len(fns)]()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(5):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (5 * reps)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms for ``nbytes`` moved and ``ops`` f32 operations,
    and which of the two sets it."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def weno_faces(v: torch.Tensor) -> int:
    """WENO reconstructions that one substage on v [..., 2, ny, nx] needs
    per component when each face is reconstructed once where its two
    cells' winds agree in sign (u > 0 along x, v > 0 along y) and twice
    where they differ; the field's outer faces once."""
    ny, nx = v.shape[-2:]
    n = v[..., 0, 0, 0].numel()
    pu, pv = v[..., 0, :, :] > 0, v[..., 1, :, :] > 0
    fx = n * ny * (nx + 1) + int((pu[..., 1:] != pu[..., :-1]).sum())
    fy = n * nx * (ny + 1) + int((pv[..., 1:, :] != pv[..., :-1, :]).sum())
    return fx + fy


def substage_ops(v: torch.Tensor) -> float:
    """Operations of one substage on v: both components' reconstructions
    (``weno_faces``) and the rest of each cell's arithmetic."""
    ny, nx = v.shape[-2:]
    cells = v[..., 0, 0, 0].numel() * ny * nx
    return 2.0 * (OPS_WENO_FACE * weno_faces(v) + OPS_SUBSTAGE_REST * cells)


def vcycle_chains(size: int, coarsest: int = 16, nu: int = 2,
                  coarse_sweeps: int = 24) -> list[tuple[int, list]]:
    """The sweep chains one V-cycle of ``MultigridPreconditioner`` on a
    size x size grid runs at each level: [(level size, [(n, from_zero),
    ...]), ...], finest first. Each level above the coarsest smooths
    twice (from zero, then from the corrected e), the coarsest runs one
    chain of ``coarse_sweeps`` from zero."""
    out = []
    while size >= coarsest and size % 2 == 0:
        out.append((size, [(nu, True), (nu, False)]))
        size //= 2
    out.append((size, [(coarse_sweeps, True)]))
    return out


def sweep_level_table(sweeps, device, size: int = 8192, sets: int = 3,
                      seed: int = 0) -> list[dict]:
    """Device time of each chain of one V-cycle (``vcycle_chains``) on
    the card, through ``sweeps(e, r, omega, n, from_zero)``: a graph
    replay over ``sets`` operand sets per level (cold in L2 where the
    sets exceed it; at 8192^2 one set is 537 MB). Per level: the chains'
    ms, their bound (12 bytes a cell, 8 from zero; 9 operations a cell
    and sweep) and the launches per cycle."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for n_cells, chains in vcycle_chains(size):
        k = 1 if n_cells >= 4096 else sets
        ops = [(torch.randn(n_cells, n_cells, generator=gen, device=device),
                torch.randn(n_cells, n_cells, generator=gen, device=device))
               for _ in range(k)]
        row = {"level": n_cells, "chains": [], "ms": 0.0, "bound_ms": 0.0,
               "launches": 0}
        for n, fz in chains:
            reps = 4 if n_cells >= 4096 else 24
            ms = graph_ms([lambda o=o: sweeps(o[0], o[1], 0.8, n, fz)
                           for o in ops], reps=reps)
            cells = n_cells * n_cells
            b = bound((8.0 if fz else 12.0) * cells,
                      OPS_SWEEP_CELL * n * cells)[0]
            launches = len(sweep_chain(n))
            row["chains"].append({"n": n, "from_zero": fz, "ms": ms,
                                  "bound_ms": b, "launches": launches})
            row["ms"] += ms
            row["bound_ms"] += b
            row["launches"] += launches
        rows.append(row)
        del ops
    return rows
