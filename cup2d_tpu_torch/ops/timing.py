"""Device timing of kernels on the card, and the per-level tables of the
Multigrid sweep chain and of the split hierarchy's halo sweep.

``cuda_ms`` times eager calls with CUDA events (host launch cost included
once the calls are short); ``graph_ms`` captures the calls in one CUDA
graph and replays it, so only device time counts. Both need a card.
"""

from __future__ import annotations

import torch

from .hopper_kernels import fused_jacobi_sweeps, sweep_chain

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s, and
# f32 and f64 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12
OPS_SWEEP_CELL = 9           # 5 Laplacian, 4 update
# WENO substage operations, counting each add, multiply, compare, select,
# max, integer op and reciprocal as one: a reconstruction is 83 (33
# smoothness, 30 weights, 15 candidate stencils, 5 blend) and its 5
# operand selects; per cell and component besides its faces, 2
# differences, a 5-op Laplacian, a 6-op RHS and a 3-op update
OPS_WENO_FACE = 88
OPS_SUBSTAGE_REST = 16
# a WENO RHS (the forest lab RHS, the single-op RHS) per cell and
# component besides its faces: the substage's rest less its 3-op update
OPS_LAB_RHS_REST = 13


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


def substage_pair_bytes(cells: int, bf16: bool = False) -> float:
    """Bytes the two substage launches move on one field of ``cells``
    cells, each input read once and each output written once: in f32,
    substage 1 reads v and writes v1 (8 + 8 a cell), substage 2 reads v1
    and vold and writes the state (8 + 8 + 8); in bf16, 4 + 4 and
    4 + 4 + 8 (the f32 state out). The bf16 copy of the state that feeds
    them is a plain cast (12 bytes a cell more), not a kernel's work."""
    return (24.0 if bf16 else 40.0) * cells


def sweep_bytes(cells: int, from_zero: bool, itemsize: int = 4) -> float:
    """Bytes of an n-sweep chain (or one sweep) on ``cells`` cells: e and r
    read once and the result written once (r and the result from zero),
    ``itemsize`` bytes a value (4 in f32, 2 in bf16)."""
    return (2.0 if from_zero else 3.0) * itemsize * cells


def bound(nbytes: float, ops: float,
          peak: float = PEAK_F32) -> tuple[float, str]:
    """Least time in ms for ``nbytes`` moved and ``ops`` operations at
    ``peak`` operations/s (f32 by default; ``PEAK_F64`` for the f64
    forms), and which of the two sets it."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
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


def lab_weno_faces(lab: torch.Tensor) -> int:
    """WENO reconstructions the forest lab RHS needs on labs [N, 2, 14,
    14] (8 x 8 blocks, 3 ghost cells) when each face of a block is
    reconstructed once where its two cells' winds agree in sign and twice
    where they differ (``weno_faces`` of the blocks' own cells), summed
    over both components."""
    return 2 * weno_faces(lab[..., 3:-3, 3:-3])


def advect_rhs_ops(lab: torch.Tensor) -> float:
    """Operations of a WENO RHS over labs [..., 2, ny+6, nx+6] (3 ghost
    cells read as they are): both components' reconstructions
    (``weno_faces`` of the labs' interior) and the rest of each cell's
    arithmetic, ``OPS_LAB_RHS_REST`` (the RHS has no update). The
    single-op RHS and, on [N, 2, 14, 14], the forest lab RHS."""
    inner = lab[..., 3:-3, 3:-3]
    cells = inner[..., 0, :, :].numel()
    return 2.0 * (OPS_WENO_FACE * weno_faces(inner)
                  + OPS_LAB_RHS_REST * cells)


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
                      seed: int = 0, dtype=torch.float32) -> list[dict]:
    """Device time of each chain of one V-cycle (``vcycle_chains``) on
    the card, through ``sweeps(e, r, omega, n, from_zero)``, on operands
    of ``dtype`` (f32, or bf16 for the FAS solver's bf16 legs): a graph
    replay over ``sets`` operand sets per level (cold in L2 where the
    sets exceed it; at 8192^2 one f32 set is 537 MB). Per level: the
    chains' ms, their bound (``sweep_bytes``: 12 bytes a cell, 8 from
    zero, in f32; 6 and 4 in bf16; 9 operations a cell and sweep) and the
    launches per cycle."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bf16 = dtype == torch.bfloat16
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows = []
    for n_cells, chains in vcycle_chains(size):
        k = 1 if n_cells >= 4096 else sets
        ops = [tuple(torch.randn(n_cells, n_cells, generator=gen,
                                 device=device).to(dtype)
                     for _ in range(2)) for _ in range(k)]
        row = {"level": n_cells, "chains": [], "ms": 0.0, "bound_ms": 0.0,
               "launches": 0}
        for n, fz in chains:
            reps = 4 if n_cells >= 4096 else 24
            ms = graph_ms([lambda o=o: sweeps(o[0], o[1], 0.8, n, fz)
                           for o in ops], reps=reps)
            cells = n_cells * n_cells
            b = bound(sweep_bytes(cells, fz, itemsize),
                      OPS_SWEEP_CELL * n * cells)[0]
            launches = len(sweep_chain(n, bf16))
            row["chains"].append({"n": n, "from_zero": fz, "ms": ms,
                                  "bound_ms": b, "launches": launches})
            row["ms"] += ms
            row["bound_ms"] += b
            row["launches"] += launches
        rows.append(row)
        del ops
    return rows


def exchange_launches(slabs: int) -> int:
    """Kernel launches of ``shard_halo.exchange_x`` over ``slabs`` slabs of
    one card: a copy or a zero fill for each side of each slab, or one
    zero fill for a single slab."""
    return 2 * slabs if slabs > 1 else 1


def halo_sweep_level_table(device, size: int = 8192, slabs: int = 4,
                           dtype=torch.float32, edge_signs=None,
                           seed: int = 0, sets: int = 3) -> list[dict]:
    """The halo sweep at each level of the ``slabs``-way split V-cycle
    hierarchy of size^2 on one card (``shard_halo.level_meshes``: split
    while a slab is at least ``MIN_SPLIT_WIDTH`` wide, gathered onto one
    slab below), on operands of ``dtype`` (f32 or bf16), Neumann or with
    a table's ``edge_signs``. Per level: the device ms of one sweep from e
    as one slab-list launch (``shard_halo.sweep_slabs``) and as the
    per-slab sequence (``shard_halo.sweep_exchanged``: one edge column
    exchanged, then a launch per slab), from graph replays
    over ``sets`` operand sets (one at the two finest levels); the launches
    of each; the bytes bound of the sweep (``sweep_bytes``, 9 operations a
    cell); the sweeps one V-cycle runs there; whether the slab list
    equals one sweep of the chain kernel on the whole field bit for bit,
    from e and from zero; and the device ms of that chain sweep, the same
    work in ``jacobi.cu``'s design (tiles staged with their halo by
    cp.async, the whole field, no slab edges)."""
    from ..parallel.mesh import make_mesh
    from ..parallel.shard_halo import (gather_x, level_meshes, split_x,
                                       sweep_exchanged, sweep_slabs)
    gen = torch.Generator(device=device).manual_seed(seed)
    itemsize = torch.empty((), dtype=dtype).element_size()
    levels = vcycle_chains(size)
    meshes = level_meshes([(n, n) for n, _ in levels],
                          make_mesh(devices=[device] * slabs))
    rows = []
    for (n_cells, chains), mesh in zip(levels, meshes):
        k = 1 if n_cells >= 4096 else sets
        ops = []
        for _ in range(k):
            e, r = (torch.randn(n_cells, n_cells, generator=gen,
                                device=device).to(dtype) for _ in range(2))
            ops.append((e, r, split_x(e, mesh), split_x(r, mesh)))
        e, r, es, rs = ops[0]
        equal = all(bool(torch.equal(
            gather_x(sweep_slabs(es, rs, 0.8, fz, edge_signs)),
            fused_jacobi_sweeps(e, r, 0.8, 1, fz, edge_signs)))
            for fz in (False, True))
        ms = graph_ms([lambda o=o: sweep_slabs(o[2], o[3], 0.8, False,
                                               edge_signs) for o in ops])
        pms = graph_ms([lambda o=o: sweep_exchanged(o[2], o[3], 0.8, False,
                                                    edge_signs)
                        for o in ops])
        cms = graph_ms([lambda o=o: fused_jacobi_sweeps(o[0], o[1], 0.8, 1,
                                                        False, edge_signs)
                        for o in ops])
        cells = n_cells * n_cells
        D = mesh.size
        rows.append({
            "level": n_cells, "slabs": D, "width": n_cells // D, "ms": ms,
            "per_slab_ms": pms, "chain_ms": cms,
            "bound_ms": bound(sweep_bytes(cells, False, itemsize),
                              OPS_SWEEP_CELL * cells)[0],
            "launches": 1, "per_slab_launches": D + exchange_launches(D),
            "sweeps_per_cycle": sum(n for n, _ in chains),
            "bit_equal": equal})
        del ops, e, r, es, rs
    return rows
