// n damped-Jacobi sweeps (1 <= n <= 6) of the undivided zero-ghost 5-point
// Laplacian with the Neumann wall diagonal, in one pass:
//   e <- e + omega * (r - lap(e)) / d,   d = (ey + ex) - 4
// ey/ex are 1 on the wall rows/columns, else 0. from_zero makes the first
// sweep e = omega * r / d and ignores e (which may then be null).
// e, r, out [L, ny, nx] f32.
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _jacobi_strips_kernel (reached
// from fused_jacobi_sweeps), all-Neumann edge signs, f32 storage.
//
// Bound on this card: memory. n sweeps read e and r once and write the
// result once, 12 bytes per cell (8 from zero), for 9 operations per cell
// and sweep.
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
//   (-4, whose reciprocal -0.25 is exact); edge tiles test every cell.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int NSW, int W_, int TY_, int GROUPS_>
struct Geo {
    static constexpr int N = NSW;
    static constexpr int W = W_;                    // shared row pitch
    static constexpr int TY = TY_;
    static constexpr int GROUPS = GROUPS_;          // row groups
    static constexpr int THREADS = W * GROUPS;      // a thread per column
    static constexpr int HX = (NSW + 3) / 4 * 4;    // x halo, 16-byte steps
    static constexpr int TX = W - 2 * HX;           // columns out
    static constexpr int H = TY + 2 * NSW;
    static constexpr int CELLS = W * H;
    // two stages of (e, r) and the sweep buffer
    static constexpr size_t SMEM = sizeof(float) * 5 * CELLS;
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

// Issue the copies of one tile's e (unless from_zero) and r into a stage.
template <class G, int VEC>
__device__ __forceinline__ void load_tile(float* es, float* rs,
                                          const float* e, const float* r,
                                          const Tile& T, int ny, int nx,
                                          int from_zero) {
    constexpr int CW = G::W / VEC;   // copies per shared row
    for (int q = threadIdx.x; q < G::H * CW; q += G::THREADS) {
        const int j = q / CW, i = (q % CW) * VEC;
        const int gy = T.oy + j, gx = T.ox + i;
        const bool in = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
        const size_t g = T.base + (in ? (size_t)gy * nx + gx : 0);
        const int k = j * G::W + i;
        cp_zfill<VEC>(rs + k, r + g, in);
        if (!from_zero) cp_zfill<VEC>(es + k, e + g, in);
    }
}

// Sweep S of the chain, read from src, written to dst: rows S .. H - S
// and columns 1 .. W - 1, a superset of the cells that stay valid (S away
// from the shared tile's edge in y, S + HX - N in x). Thread (g, i) owns
// column i over row group g and rolls the column through registers.
// EDGE: the tile reaches the domain's edge, so every cell is tested.
template <class G, int S, bool EDGE>
__device__ __forceinline__ void sweep(const float* __restrict__ src,
                                      float* __restrict__ dst,
                                      const float* __restrict__ rs,
                                      const Tile& T,
                                      int ny, int nx, float omega,
                                      int from_zero) {
    constexpr int R = (G::H - 2 * S + G::GROUPS - 1) / G::GROUPS;
    const int i = threadIdx.x % G::W;
    const int j0 = S + (threadIdx.x / G::W) * R;
    const int j1 = min(j0 + R, G::H - S);
    if (i == 0 || i == G::W - 1 || j0 >= j1) return;
    const int gx = T.ox + i;
    float exv = gx == 0 ? 1.0f : (gx == nx - 1 ? 1.0f : 0.0f);
    const bool xin = gx >= 0 && gx < nx;
    if (S == 1 && from_zero) {
        for (int j = j0; j < j1; ++j) {
            const int idx = j * G::W + i;
            float rv = rs[idx];
            if (!EDGE) {
                dst[idx] = omega * rv * -0.25f;
                continue;
            }
            const int gy = T.oy + j;
            if (!xin || gy < 0 || gy >= ny) {
                dst[idx] = 0.0f;
                continue;
            }
            float eyv = gy == 0 ? 1.0f : (gy == ny - 1 ? 1.0f : 0.0f);
            float corr = (eyv + exv) - 4.0f;
            float inv_d = 1.0f / corr;
            dst[idx] = omega * rv * inv_d;
        }
        return;
    }
    float ym = src[(j0 - 1) * G::W + i];
    float cur = src[j0 * G::W + i];
    for (int j = j0; j < j1; ++j) {
        const int idx = j * G::W + i;
        const float yp = src[idx + G::W];
        const float xp = src[idx + 1];
        const float xm = src[idx - 1];
        const float rv = rs[idx];
        float corr = -4.0f, inv_d = -0.25f;     // 1 / -4, exact
        if (EDGE) {
            const int gy = T.oy + j;
            if (!xin || gy < 0 || gy >= ny) {
                dst[idx] = 0.0f;
                ym = cur;
                cur = yp;
                continue;
            }
            float eyv = gy == 0 ? 1.0f : (gy == ny - 1 ? 1.0f : 0.0f);
            corr = (eyv + exv) - 4.0f;
            inv_d = 1.0f / corr;
        }
        float lap = xp + xm + yp + ym + cur * corr;
        dst[idx] = cur + omega * (rv - lap) * inv_d;
        ym = cur;
        cur = yp;
    }
}

// Sweeps S..N, alternating between the two buffers.
template <class G, int S, bool EDGE>
__device__ __forceinline__ void sweeps(float* a, float* b, const float* rs,
                                       const Tile& T, int ny, int nx,
                                       float omega, int from_zero) {
    if constexpr (S <= G::N) {
        sweep<G, S, EDGE>(a, b, rs, T, ny, nx, omega, from_zero);
        __syncthreads();
        sweeps<G, S + 1, EDGE>(b, a, rs, T, ny, nx, omega, from_zero);
    }
}

template <class G, int VEC>
__global__ void __launch_bounds__(G::THREADS)
jacobi_kernel(const float* __restrict__ e, const float* __restrict__ r,
              float* __restrict__ out, int L, int ny, int nx, float omega,
              int from_zero) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* buf = smem + 4 * G::CELLS;      // the sweep buffer
    const int tiles = L * ((ny + G::TY - 1) / G::TY)
                        * ((nx + G::TX - 1) / G::TX);
    int t = blockIdx.x;
    if (t >= tiles) return;
    Tile T = tile_at<G>(t, ny, nx);
    load_tile<G, VEC>(smem, smem + G::CELLS, e, r, T, ny, nx, from_zero);
    cp_commit();
    for (int s = 0; t < tiles; t += gridDim.x, s ^= 1) {
        float* es = smem + s * 2 * G::CELLS;
        const float* rs = es + G::CELLS;
        const int nt = t + gridDim.x;
        if (nt < tiles) {
            float* ns = smem + (s ^ 1) * 2 * G::CELLS;
            load_tile<G, VEC>(ns, ns + G::CELLS, e, r, tile_at<G>(nt, ny, nx),
                              ny, nx, from_zero);
        }
        cp_commit();
        cp_wait1();
        __syncthreads();
        if (T.oy >= 0 && T.oy + G::H <= ny && T.ox >= 0
                && T.ox + G::W <= nx)
            sweeps<G, 1, false>(es, buf, rs, T, ny, nx, omega, from_zero);
        else
            sweeps<G, 1, true>(es, buf, rs, T, ny, nx, omega, from_zero);
        const float* res = (G::N % 2) ? buf : es;
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
        __syncthreads();   // this stage is refilled by the next iteration
        if (nt < tiles) T = tile_at<G>(nt, ny, nx);
    }
    cp_wait0();
}

using Launch = int (*)(const float*, const float*, float*, int, int, int,
                       float, int, int, cudaStream_t);

template <class G, int VEC>
int launch(const float* e, const float* r, float* out, int L, int ny,
           int nx, float omega, int from_zero, int grid, cudaStream_t st) {
    // above 48 KB of shared memory once per device (a bit per ordinal)
    static unsigned long long opted_in = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (G::SMEM > 48 * 1024 && !(dev < 64 && (opted_in >> dev & 1))) {
        err = cudaFuncSetAttribute(
            jacobi_kernel<G, VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) opted_in |= 1ull << dev;
    }
    jacobi_kernel<G, VEC><<<grid, G::THREADS, G::SMEM, st>>>(
        e, r, out, L, ny, nx, omega, from_zero);
    return (int)cudaGetLastError();
}

// 128 x 64 tiles for the fine levels, 32 x 16 for the coarse ones
template <int NSW, int VEC>
Launch pick(int big) {
    return big ? launch<Geo<NSW, 128, 64, 4>, VEC>
               : launch<Geo<NSW, 32, 16, 8>, VEC>;
}

template <int VEC>
Launch pick_n(int nsw, int big) {
    switch (nsw) {
        case 1: return pick<1, VEC>(big);
        case 2: return pick<2, VEC>(big);
        case 3: return pick<3, VEC>(big);
        case 4: return pick<4, VEC>(big);
        case 5: return pick<5, VEC>(big);
        case 6: return pick<6, VEC>(big);
        default: return nullptr;
    }
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
    if (L < 1 || ny < 1 || nx < 1 || grid < 1 || (vec == 4 && nx % 4))
        return (int)cudaErrorInvalidValue;
    Launch fn = vec == 4 ? pick_n<4>(nsw, big)
              : (vec == 1 ? pick_n<1>(nsw, big) : nullptr);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return fn(e, r, out, L, ny, nx, omega, from_zero, grid,
              (cudaStream_t)stream);
}
