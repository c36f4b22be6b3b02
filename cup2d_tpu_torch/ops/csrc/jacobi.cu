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

#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace {

using storage::bf16;
using storage::narrow;
using storage::widen;

// per-face edge signs (x_lo, x_hi, y_lo, y_hi)
struct Signs {
    float x_lo, x_hi, y_lo, y_hi;
};

// The wall indicator of global index k of n: the Neumann 1, or the face's
// sign (SIGNED), at index 0 and n - 1; 0 elsewhere.
template <bool SIGNED>
__device__ __forceinline__ float edge(int k, int n, float lo, float hi) {
    if constexpr (SIGNED)
        return k == 0 ? lo : (k == n - 1 ? hi : 0.0f);
    else
        return k == 0 ? 1.0f : (k == n - 1 ? 1.0f : 0.0f);
}

template <int NSW, int W_, int TY_, int GROUPS_>
struct Geo {
    static constexpr int N = NSW;
    static constexpr int W = W_;                    // shared row pitch
    static constexpr int TY = TY_;
    static constexpr int GROUPS = GROUPS_;          // row groups
    static constexpr int THREADS = W * GROUPS;      // a thread per column
    static constexpr int HX = (NSW + 3) / 4 * 4;    // x halo, 4-cell steps
    static constexpr int TX = W - 2 * HX;           // columns out
    static constexpr int H = TY + 2 * NSW;
    static constexpr int CELLS = W * H;
};

template <int VEC>
__device__ __forceinline__ void cp_zfill(float* dst, const float* src,
                                         bool in) {
    uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    int n = in ? 4 * VEC : 0;
    if (VEC == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(s), "l"(src), "r"(n) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait0() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Tile {
    size_t base;   // offset of the member's field
    int oy, ox;    // global coordinates of the shared tile's cell (0, 0)
    int y0, x0;    // global coordinates of the tile's first output cell
};

template <class G>
__device__ __forceinline__ Tile tile_at(int t, int ny, int nx) {
    const int tx_n = (nx + G::TX - 1) / G::TX;
    const int ty_n = (ny + G::TY - 1) / G::TY;
    const int l = t / (tx_n * ty_n);
    const int rem = t - l * tx_n * ty_n;
    const int by = rem / tx_n, bx = rem - (rem / tx_n) * tx_n;
    Tile T;
    T.base = (size_t)l * ny * nx;
    T.y0 = by * G::TY;
    T.x0 = bx * G::TX;
    T.oy = T.y0 - G::N;
    T.ox = T.x0 - G::HX;
    return T;
}

// k mod n in [0, n), for any k
__device__ __forceinline__ int wrap_index(int k, int n) {
    const int m = k % n;
    return m < 0 ? m + n : m;
}

// Issue the copies of one tile's e (unless from_zero) and r into a stage:
// f32 by VEC, bf16 (VEC 0) by vec (4: 8-byte cp.async, 1: 2-byte loads).
// WRAP (f32): the periodic axes' outside cells from the wrapped index.
template <class G, int VEC, class ST, bool WRAP = false>
__device__ __forceinline__ void load_tile(ST* es, ST* rs, const ST* e,
                                          const ST* r, const Tile& T,
                                          int ny, int nx, int from_zero,
                                          int vec, int wrap = 0) {
    if constexpr (storage::is_f32<ST>) {
        constexpr int CW = G::W / VEC;   // copies per shared row
        for (int q = threadIdx.x; q < G::H * CW; q += G::THREADS) {
            const int j = q / CW, i = (q % CW) * VEC;
            int gy = T.oy + j, gx = T.ox + i;
            if constexpr (WRAP) {
                if (wrap & 2) gy = wrap_index(gy, ny);
                if (wrap & 1) gx = wrap_index(gx, nx);
            }
            const bool in = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
            const size_t g = T.base + (in ? (size_t)gy * nx + gx : 0);
            const int k = j * G::W + i;
            cp_zfill<VEC>(rs + k, r + g, in);
            if (!from_zero) cp_zfill<VEC>(es + k, e + g, in);
        }
    } else if (vec == 4) {
        constexpr int CW = G::W / 4;
        for (int q = threadIdx.x; q < G::H * CW; q += G::THREADS) {
            const int j = q / CW, i = (q % CW) * 4;
            const int gy = T.oy + j, gx = T.ox + i;
            const bool in = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
            const size_t g = T.base + (in ? (size_t)gy * nx + gx : 0);
            const int k = j * G::W + i;
            storage::cp_async8(rs + k, r + g, in);
            if (!from_zero) storage::cp_async8(es + k, e + g, in);
        }
    } else {
        const ST zero = narrow<ST>(0.0f);
        for (int q = threadIdx.x; q < G::H * G::W; q += G::THREADS) {
            const int j = q / G::W, i = q % G::W;
            const int gy = T.oy + j, gx = T.ox + i;
            const bool in = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
            const size_t g = T.base + (in ? (size_t)gy * nx + gx : 0);
            rs[q] = in ? r[g] : zero;
            if (!from_zero) es[q] = in ? e[g] : zero;
        }
    }
}

// Sweep S of the chain, read from src, written to dst: rows S .. H - S
// and columns 1 .. W - 1, a superset of the cells that stay valid (S away
// from the shared tile's edge in y, S + HX - N in x). Thread (g, i) owns
// column i over row group g and rolls the column through registers.
// EDGE: the tile reaches the domain's edge, so every cell is tested.
// WRAP: no cell is outside along a periodic axis (wrap).
template <class G, int S, bool EDGE, bool SIGNED, class ST, bool WRAP = false>
__device__ __forceinline__ void sweep(const ST* __restrict__ src,
                                      ST* __restrict__ dst,
                                      const ST* __restrict__ rs,
                                      const Tile& T,
                                      int ny, int nx, float omega,
                                      int from_zero, const Signs& sg,
                                      int wrap = 0) {
    constexpr int R = (G::H - 2 * S + G::GROUPS - 1) / G::GROUPS;
    const int i = threadIdx.x % G::W;
    const int j0 = S + (threadIdx.x / G::W) * R;
    const int j1 = min(j0 + R, G::H - S);
    if (i == 0 || i == G::W - 1 || j0 >= j1) return;
    const int gx = T.ox + i;
    float exv = edge<SIGNED>(gx, nx, sg.x_lo, sg.x_hi);
    const bool xin = (WRAP && (wrap & 1)) || (gx >= 0 && gx < nx);
    const bool wy = WRAP && (wrap & 2);
    if (S == 1 && from_zero) {
        for (int j = j0; j < j1; ++j) {
            const int idx = j * G::W + i;
            float rv = widen(rs[idx]);
            if (!EDGE) {
                dst[idx] = narrow<ST>(omega * rv * -0.25f);
                continue;
            }
            const int gy = T.oy + j;
            if (!xin || (!wy && (gy < 0 || gy >= ny))) {
                dst[idx] = narrow<ST>(0.0f);
                continue;
            }
            float eyv = edge<SIGNED>(gy, ny, sg.y_lo, sg.y_hi);
            float corr = (eyv + exv) - 4.0f;
            float inv_d = 1.0f / corr;
            dst[idx] = narrow<ST>(omega * rv * inv_d);
        }
        return;
    }
    float ym = widen(src[(j0 - 1) * G::W + i]);
    float cur = widen(src[j0 * G::W + i]);
    for (int j = j0; j < j1; ++j) {
        const int idx = j * G::W + i;
        const float yp = widen(src[idx + G::W]);
        const float xp = widen(src[idx + 1]);
        const float xm = widen(src[idx - 1]);
        const float rv = widen(rs[idx]);
        float corr = -4.0f, inv_d = -0.25f;     // 1 / -4, exact
        if (EDGE) {
            const int gy = T.oy + j;
            if (!xin || (!wy && (gy < 0 || gy >= ny))) {
                dst[idx] = narrow<ST>(0.0f);
                ym = cur;
                cur = yp;
                continue;
            }
            float eyv = edge<SIGNED>(gy, ny, sg.y_lo, sg.y_hi);
            corr = (eyv + exv) - 4.0f;
            inv_d = 1.0f / corr;
        }
        float lap = xp + xm + yp + ym + cur * corr;
        dst[idx] = narrow<ST>(cur + omega * (rv - lap) * inv_d);
        ym = cur;
        cur = yp;
    }
}

// Sweeps S..N, alternating between the two buffers.
template <class G, int S, bool EDGE, bool SIGNED, class ST, bool WRAP = false>
__device__ __forceinline__ void sweeps(ST* a, ST* b, const ST* rs,
                                       const Tile& T, int ny, int nx,
                                       float omega, int from_zero,
                                       const Signs& sg, int wrap = 0) {
    if constexpr (S <= G::N) {
        sweep<G, S, EDGE, SIGNED, ST, WRAP>(a, b, rs, T, ny, nx, omega,
                                            from_zero, sg, wrap);
        __syncthreads();
        sweeps<G, S + 1, EDGE, SIGNED, ST, WRAP>(b, a, rs, T, ny, nx, omega,
                                                 from_zero, sg, wrap);
    }
}

// ST: the storage type of e, r, out and the tile. An f32 instance copies
// by VEC (4: 16 bytes, 1: 4 bytes); a bf16 one (VEC 0) by vec (4: 8 bytes,
// 1: 2 bytes). WRAP (f32, SIGNED): the wrap form, wrap its periodic axes.
template <class G, int VEC, bool SIGNED, class ST, bool WRAP = false>
__global__ void __launch_bounds__(G::THREADS)
jacobi_kernel(const ST* __restrict__ e, const ST* __restrict__ r,
              ST* __restrict__ out, int L, int ny, int nx, float omega,
              int from_zero, Signs sg, int vec, int wrap) {
    extern __shared__ float4 smem4[];
    ST* smem = reinterpret_cast<ST*>(smem4);
    ST* buf = smem + 4 * G::CELLS;         // the sweep buffer
    const int tiles = L * ((ny + G::TY - 1) / G::TY)
                        * ((nx + G::TX - 1) / G::TX);
    int t = blockIdx.x;
    if (t >= tiles) return;
    Tile T = tile_at<G>(t, ny, nx);
    load_tile<G, VEC, ST, WRAP>(smem, smem + G::CELLS, e, r, T, ny, nx,
                                from_zero, vec, wrap);
    cp_commit();
    for (int s = 0; t < tiles; t += gridDim.x, s ^= 1) {
        ST* es = smem + s * 2 * G::CELLS;
        const ST* rs = es + G::CELLS;
        const int nt = t + gridDim.x;
        if (nt < tiles) {
            ST* ns = smem + (s ^ 1) * 2 * G::CELLS;
            load_tile<G, VEC, ST, WRAP>(ns, ns + G::CELLS, e, r,
                                        tile_at<G>(nt, ny, nx), ny, nx,
                                        from_zero, vec, wrap);
        }
        cp_commit();
        cp_wait1();
        __syncthreads();
        if (T.oy >= 0 && T.oy + G::H <= ny && T.ox >= 0
                && T.ox + G::W <= nx)
            sweeps<G, 1, false, SIGNED, ST, WRAP>(es, buf, rs, T, ny, nx,
                                                  omega, from_zero, sg,
                                                  wrap);
        else
            sweeps<G, 1, true, SIGNED, ST, WRAP>(es, buf, rs, T, ny, nx,
                                                 omega, from_zero, sg, wrap);
        const ST* res = (G::N % 2) ? buf : es;
        if constexpr (storage::is_f32<ST>) {
            constexpr int CX = G::TX / VEC;
            for (int q = threadIdx.x; q < G::TY * CX; q += G::THREADS) {
                const int j = q / CX, i = (q % CX) * VEC;
                const int gy = T.y0 + j, gx = T.x0 + i;
                if (gy >= ny || gx >= nx) continue;
                const int k = (j + G::N) * G::W + i + G::HX;
                float* o = out + T.base + (size_t)gy * nx + gx;
                if (VEC == 4)
                    *reinterpret_cast<float4*>(o) =
                        *reinterpret_cast<const float4*>(res + k);
                else
                    *o = res[k];
            }
        } else {
            const int v4 = vec == 4 ? 4 : 1;
            const int cx = G::TX / v4;
            for (int q = threadIdx.x; q < G::TY * cx; q += G::THREADS) {
                const int j = q / cx, i = (q % cx) * v4;
                const int gy = T.y0 + j, gx = T.x0 + i;
                if (gy >= ny || gx >= nx) continue;
                const int k = (j + G::N) * G::W + i + G::HX;
                ST* o = out + T.base + (size_t)gy * nx + gx;
                if (v4 == 4)
                    *reinterpret_cast<uint2*>(o) =
                        *reinterpret_cast<const uint2*>(res + k);
                else
                    *o = res[k];
            }
        }
        __syncthreads();   // this stage is refilled by the next iteration
        if (nt < tiles) T = tile_at<G>(nt, ny, nx);
    }
    cp_wait0();
}

template <class ST>
using Launch = int (*)(const ST*, const ST*, ST*, int, int, int, float, int,
                       Signs, int, int, int, cudaStream_t);

template <class G, int VEC, bool SIGNED, class ST, bool WRAP = false>
int launch(const ST* e, const ST* r, ST* out, int L, int ny, int nx,
           float omega, int from_zero, Signs sg, int vec, int grid, int wrap,
           cudaStream_t st) {
    // two stages of (e, r) and the sweep buffer
    constexpr size_t smem = sizeof(ST) * 5 * G::CELLS;
    // above 48 KB of shared memory once per device (a bit per ordinal)
    static unsigned long long opted_in = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (smem > 48 * 1024 && !(dev < 64 && (opted_in >> dev & 1))) {
        err = cudaFuncSetAttribute(
            jacobi_kernel<G, VEC, SIGNED, ST, WRAP>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) opted_in |= 1ull << dev;
    }
    jacobi_kernel<G, VEC, SIGNED, ST, WRAP><<<grid, G::THREADS, smem, st>>>(
        e, r, out, L, ny, nx, omega, from_zero, sg, vec, wrap);
    return (int)cudaGetLastError();
}

// 128 x 64 tiles for the fine levels, 32 x 16 for the coarse ones
template <int NSW, int VEC, bool SIGNED, class ST, bool WRAP = false>
Launch<ST> pick(int big) {
    return big ? launch<Geo<NSW, 128, 64, 4>, VEC, SIGNED, ST, WRAP>
               : launch<Geo<NSW, 32, 16, 8>, VEC, SIGNED, ST, WRAP>;
}

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
