// n damped-Jacobi sweeps (1 <= n <= 6) of the undivided zero-ghost 5-point
// Laplacian with the Neumann wall diagonal, in one pass:
//   e <- e + omega * (r - lap(e)) / d,   d = (ey + ex) - 4
// ey/ex are 1 on the wall rows/columns, else 0 (the signed form: a
// boundary table's pressure sign of the face there, -1 at a Dirichlet
// outflow face, also in lap's wall term). from_zero makes the first sweep
// e = omega * r / d and ignores e (which may then be null).
// e, r, out [L, ny, nx] f32, or all bf16 (the bf16 forms).
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _jacobi_strips_kernel (reached
// from fused_jacobi_sweeps), f32 storage: all-Neumann edge signs
// (cup2d_jacobi_sweeps) and a table's edge signs (cup2d_jacobi_sweeps_signed,
// a template instance of its own, so the Neumann instances are unchanged);
// and bf16 storage, the FAS solver's bf16 legs (cup2d_jacobi_sweeps_bf16,
// cup2d_jacobi_sweeps_signed_bf16).
//
// Bound on this card: memory. n sweeps read e and r once and write the
// result once, 12 bytes per cell (8 from zero; 6 and 4 in bf16), for 9
// operations per cell and sweep.
//
// Design: the TPU kernel time-skews the sweeps over row strips that run in
// sequence (sweep k trails sweep k-1 by one strip in a VMEM ring). CUDA
// blocks run in parallel, so this kernel blocks in time instead: a CTA
// holds a tile of e and r with an n-row and HX-column halo in shared
// memory (W columns, TY + 2n rows) and runs all n sweeps there, the valid
// region shrinking by one cell per sweep; it writes the TY x (W - 2 HX)
// interior once. Cells outside the domain are zero ghosts and stay zero.
// - Compile-time shapes: the kernel is a template on the sweep count, the
//   tile and the load width; no index needs a division in the sweeps.
// - Aligned, vectorized loads with zero ghosts: HX is n rounded up to 4
//   and the tile is W = 128 (or 32) columns wide, so a tile's rows start
//   and end on 16-byte words; where nx is a multiple of 4 (and the
//   pointers are 16-byte aligned) the tile arrives by 16-byte cp.async,
//   zero-filled outside the domain, and leaves by float4 stores; any
//   other shape takes 4-byte copies and stores.
// - Persistent CTAs walk the tiles of all L members with a two-stage ring:
//   the next tile's copies are in flight during this tile's sweeps.
// - A thread owns one column of the tile and a run of rows, and rolls its
//   column's values through registers: 4 shared loads and 1 store a cell.
//   Tiles clear of the domain's edge (all but a few percent on the fine
//   levels) take a path with no domain tests and the interior diagonal
//   (-4, whose reciprocal -0.25 is exact); edge tiles test every cell, and
//   only they read the signs (their diagonal and its reciprocal come from
//   the signed (ey + ex) - 4, as the plain version's inv_diag does).
// - Two tiles: 128 columns x 64 rows (120 or 112 columns out; 512
//   threads, one CTA per SM: 174-195 KB of shared memory for n = 1..6,
//   two stages of e and r plus one sweep buffer) where a level has at
//   least four such tiles per SM (fewer leave the SMs of the last round
//   idle): the halo is recomputed 1.13x at n = 2 (the former 64 x 32
//   tile: 1.2x). 32 x 16 (24 or 16 columns out; 256 threads, 13-18 KB,
//   3-4 CTAs per SM by registers) on the coarser levels, so a level of a
//   few tiles spreads over the SMs and an 8^2 level sweeps a 32 x 28 tile.
// The per-cell arithmetic is the same expression as the plain version's
// (MultigridPreconditioner._smooth) and jacobi_halo.cu's, operand for
// operand: lap = xp + xm + yp + ym + cur * corr, then
// cur + omega * (rv - lap) * inv_d with inv_d = 1 / corr.
// bf16 storage (the storage type ST a template parameter; the f32
// instances are the kernel above): the tile, the sweep buffer and the
// output hold bf16, every sweep computes in f32 from widened operands and
// rounds its result to bf16 where it stores it, in shared memory as in
// device memory. So every sweep is rounded once, as the TPU kernel's bf16
// rings round it, and a chain gives the same result however it is cut
// into launches: the bf16 forms are built for 1, 2 and 6 sweeps only
// (12 instances, not 48), and the wrapper cuts a chain into those. Copies
// are 8-byte cp.async (four values) where rows are whole 8-byte words,
// else 2-byte loads; the copy width is a launch argument of a bf16
// instance, not a template parameter. Shared memory halves: 84-97 KB for
// the big tile, 6-9 KB for the small one.
// The wrap form (cup2d_jacobi_sweeps_wrap, f32, a template instance of its
// own: WRAP) runs the periodic tables, which the TPU kernel refuses: the
// JAX package sweeps them with its XLA chain (MultigridPreconditioner.
// _smooth with periodic=, the wrap Laplacian laplacian5_bc(px, py) and the
// signed diagonal, 0 on the periodic faces), whose function it computes.
// Along a periodic axis (wrap: bit 0 x, bit 1 y) an edge tile copies its
// halo from the wrapped rows and columns instead of zero-filling them and
// sweeps those cells as the interior ones (the periodic extension of the
// field, swept, is the extension of the swept field); the signs there are
// 0, so the diagonal is the interior -4. The wrap is a true modulo: the 8^2
// coarsest level swept in chains of 6 has a 6-row and 8-column halo. HX
// and x0 are multiples of 4, so where nx is too the wrapped runs stay
// 16-byte copies. Built for 1, 2 and 6 sweeps (the wrapper cuts a chain
// into those, as the bf16 chains: an f32 sweep stores in shared memory
// what it would store in device memory, so the cut does not change the
// result).
// The kernel and its launch templates live in jacobi.cuh; this source
// instantiates the f32 and bf16 forms, jacobi_f64.cu the f64 ones.
// f64 storage (ST = double; cup2d_jacobi_sweeps_f64, _signed_f64,
// _wrap_f64, in jacobi_f64.cu): every operand, the tile and the
// arithmetic in f64 (the JAX package's XLA chain at x64, which its Pallas
// gate sends f64 state to), the per-cell expression the f32 one. The
// f64 tile keeps what it stores, as f32 does, so the forms are built for
// 1, 2 and 6 sweeps (18 instances) and the wrapper cuts a chain as it
// cuts a bf16 one. Copies
// are 16 bytes (two values; nx even, 16-byte aligned pointers) or 8, the
// width a launch argument. The big tile is 128 x 32 (its five f64 buffers
// take 174-225 KB for n = 1..6, one CTA an SM), the small one 32 x 16
// (25-36 KB).

#include "jacobi.cuh"

namespace {

template <int VEC, bool SIGNED>
Launch<float> pick_n(int nsw, int big) {
    switch (nsw) {
        case 1: return pick<1, VEC, SIGNED, float>(big);
        case 2: return pick<2, VEC, SIGNED, float>(big);
        case 3: return pick<3, VEC, SIGNED, float>(big);
        case 4: return pick<4, VEC, SIGNED, float>(big);
        case 5: return pick<5, VEC, SIGNED, float>(big);
        case 6: return pick<6, VEC, SIGNED, float>(big);
        default: return nullptr;
    }
}

// the bf16 launch sizes (hopper_kernels.BF16_CHAIN)
template <bool SIGNED>
Launch<bf16> pick_bf16(int nsw, int big) {
    switch (nsw) {
        case 1: return pick<1, 0, SIGNED, bf16>(big);
        case 2: return pick<2, 0, SIGNED, bf16>(big);
        case 6: return pick<6, 0, SIGNED, bf16>(big);
        default: return nullptr;
    }
}

// the wrap form's launch sizes (hopper_kernels.BF16_CHAIN, as bf16's)
template <int VEC>
Launch<float> pick_wrap(int nsw, int big) {
    switch (nsw) {
        case 1: return pick<1, VEC, true, float, true>(big);
        case 2: return pick<2, VEC, true, float, true>(big);
        case 6: return pick<6, VEC, true, float, true>(big);
        default: return nullptr;
    }
}

template <bool SIGNED>
int sweeps_entry(const float* e, const float* r, float* out, int L, int ny,
                 int nx, int nsw, float omega, int from_zero, int big,
                 int vec, int grid, Signs sg, void* stream) {
    if (L < 1 || ny < 1 || nx < 1 || grid < 1 || (vec == 4 && nx % 4))
        return (int)cudaErrorInvalidValue;
    Launch<float> fn = vec == 4 ? pick_n<4, SIGNED>(nsw, big)
                     : (vec == 1 ? pick_n<1, SIGNED>(nsw, big) : nullptr);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return fn(e, r, out, L, ny, nx, omega, from_zero, sg, vec, grid, 0,
              (cudaStream_t)stream);
}

template <bool SIGNED>
int sweeps_entry_bf16(const void* e, const void* r, void* out, int L,
                      int ny, int nx, int nsw, float omega, int from_zero,
                      int big, int vec, int grid, Signs sg, void* stream) {
    if (L < 1 || ny < 1 || nx < 1 || grid < 1 || (vec != 4 && vec != 1)
            || (vec == 4 && nx % 4))
        return (int)cudaErrorInvalidValue;
    Launch<bf16> fn = pick_bf16<SIGNED>(nsw, big);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return fn(static_cast<const bf16*>(e), static_cast<const bf16*>(r),
              static_cast<bf16*>(out), L, ny, nx, omega, from_zero, sg, vec,
              grid, 0, (cudaStream_t)stream);
}

}  // namespace

// big: 1 for the 128-column tile, 0 for the 32-column one; vec: 4 for
// 16-byte copies (nx a multiple of 4, 16-byte aligned pointers), 1 for
// 4-byte ones; grid: the number of persistent CTAs, 1 .. the number of
// tiles.
extern "C" int cup2d_jacobi_sweeps(const float* e, const float* r,
                                   float* out, int L, int ny, int nx,
                                   int nsw, float omega, int from_zero,
                                   int big, int vec, int grid, void* stream) {
    return sweeps_entry<false>(e, r, out, L, ny, nx, nsw, omega, from_zero,
                               big, vec, grid, Signs{1.0f, 1.0f, 1.0f, 1.0f},
                               stream);
}

// es_*: the table's edge signs (bc.pressure_signs)
extern "C" int cup2d_jacobi_sweeps_signed(
        const float* e, const float* r, float* out, int L, int ny, int nx,
        int nsw, float omega, int from_zero, int big, int vec, int grid,
        float es_x_lo, float es_x_hi, float es_y_lo, float es_y_hi,
        void* stream) {
    return sweeps_entry<true>(e, r, out, L, ny, nx, nsw, omega, from_zero,
                              big, vec, grid,
                              Signs{es_x_lo, es_x_hi, es_y_lo, es_y_hi},
                              stream);
}

// The wrap form: nsw 1, 2 or 6; the table's signs, whose (0, 0) pairs
// are its periodic axes, at least one (the interior diagonal there).
extern "C" int cup2d_jacobi_sweeps_wrap(
        const float* e, const float* r, float* out, int L, int ny, int nx,
        int nsw, float omega, int from_zero, int big, int vec, int grid,
        float es_x_lo, float es_x_hi, float es_y_lo, float es_y_hi,
        void* stream) {
    const int wrap = (es_x_lo == 0.0f && es_x_hi == 0.0f ? 1 : 0)
                     | (es_y_lo == 0.0f && es_y_hi == 0.0f ? 2 : 0);
    if (L < 1 || ny < 1 || nx < 1 || grid < 1 || wrap == 0
            || (vec == 4 && nx % 4))
        return (int)cudaErrorInvalidValue;
    Launch<float> fn = vec == 4 ? pick_wrap<4>(nsw, big)
                     : (vec == 1 ? pick_wrap<1>(nsw, big) : nullptr);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return fn(e, r, out, L, ny, nx, omega, from_zero,
              Signs{es_x_lo, es_x_hi, es_y_lo, es_y_hi}, vec, grid, wrap,
              (cudaStream_t)stream);
}

// The bf16 forms: e, r, out bf16; nsw 1, 2 or 6; vec 4 for 8-byte copies
// (nx a multiple of 4, 8-byte aligned pointers), 1 for 2-byte loads.
extern "C" int cup2d_jacobi_sweeps_bf16(const void* e, const void* r,
                                        void* out, int L, int ny, int nx,
                                        int nsw, float omega, int from_zero,
                                        int big, int vec, int grid,
                                        void* stream) {
    return sweeps_entry_bf16<false>(e, r, out, L, ny, nx, nsw, omega,
                                    from_zero, big, vec, grid,
                                    Signs{1.0f, 1.0f, 1.0f, 1.0f}, stream);
}

extern "C" int cup2d_jacobi_sweeps_signed_bf16(
        const void* e, const void* r, void* out, int L, int ny, int nx,
        int nsw, float omega, int from_zero, int big, int vec, int grid,
        float es_x_lo, float es_x_hi, float es_y_lo, float es_y_hi,
        void* stream) {
    return sweeps_entry_bf16<true>(e, r, out, L, ny, nx, nsw, omega,
                                   from_zero, big, vec, grid,
                                   Signs{es_x_lo, es_x_hi, es_y_lo, es_y_hi},
                                   stream);
}

