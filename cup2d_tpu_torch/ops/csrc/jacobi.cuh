// n damped-Jacobi sweeps of the zero-ghost 5-point Laplacian in one pass
// (the kernel, its tiles, loaders and launch templates), shared by the
// sources that instantiate its forms: jacobi.cu (f32 and bf16 storage)
// and jacobi_f64.cu (f64 storage), which build in parallel. The design
// and what each form replaces: jacobi.cu.

#pragma once

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
// f64 (VEC 0) by vec (2: 16-byte cp.async, 1: 8-byte ones), wrapped too.
template <class G, int VEC, class ST, bool WRAP = false>
__device__ __forceinline__ void load_tile(ST* es, ST* rs, const ST* e,
                                          const ST* r, const Tile& T,
                                          int ny, int nx, int from_zero,
                                          int vec, int wrap = 0) {
    if constexpr (storage::is_f64<ST>) {
        const int v2 = vec == 2 ? 2 : 1;
        const int cw = G::W / v2;        // copies per shared row
        for (int q = threadIdx.x; q < G::H * cw; q += G::THREADS) {
            const int j = q / cw, i = (q % cw) * v2;
            int gy = T.oy + j, gx = T.ox + i;
            if constexpr (WRAP) {
                if (wrap & 2) gy = wrap_index(gy, ny);
                if (wrap & 1) gx = wrap_index(gx, nx);
            }
            const bool in = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
            const size_t g = T.base + (in ? (size_t)gy * nx + gx : 0);
            const int k = j * G::W + i;
            if (v2 == 2) {
                storage::cp_async16(rs + k, r + g, in);
                if (!from_zero) storage::cp_async16(es + k, e + g, in);
            } else {
                storage::cp_async8(rs + k, r + g, in);
                if (!from_zero) storage::cp_async8(es + k, e + g, in);
            }
        }
    } else if constexpr (storage::is_f32<ST>) {
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
                                      int ny, int nx,
                                      storage::compute_t<ST> omega,
                                      int from_zero, const Signs& sg,
                                      int wrap = 0) {
    using F = storage::compute_t<ST>;    // the arithmetic type
    constexpr int R = (G::H - 2 * S + G::GROUPS - 1) / G::GROUPS;
    const int i = threadIdx.x % G::W;
    const int j0 = S + (threadIdx.x / G::W) * R;
    const int j1 = min(j0 + R, G::H - S);
    if (i == 0 || i == G::W - 1 || j0 >= j1) return;
    const int gx = T.ox + i;
    F exv = (F)edge<SIGNED>(gx, nx, sg.x_lo, sg.x_hi);
    const bool xin = (WRAP && (wrap & 1)) || (gx >= 0 && gx < nx);
    const bool wy = WRAP && (wrap & 2);
    if (S == 1 && from_zero) {
        for (int j = j0; j < j1; ++j) {
            const int idx = j * G::W + i;
            F rv = widen(rs[idx]);
            if (!EDGE) {
                dst[idx] = narrow<ST>(omega * rv * (F)-0.25);
                continue;
            }
            const int gy = T.oy + j;
            if (!xin || (!wy && (gy < 0 || gy >= ny))) {
                dst[idx] = narrow<ST>((F)0.0);
                continue;
            }
            F eyv = (F)edge<SIGNED>(gy, ny, sg.y_lo, sg.y_hi);
            F corr = (eyv + exv) - (F)4.0;
            F inv_d = (F)1.0 / corr;
            dst[idx] = narrow<ST>(omega * rv * inv_d);
        }
        return;
    }
    F ym = widen(src[(j0 - 1) * G::W + i]);
    F cur = widen(src[j0 * G::W + i]);
    for (int j = j0; j < j1; ++j) {
        const int idx = j * G::W + i;
        const F yp = widen(src[idx + G::W]);
        const F xp = widen(src[idx + 1]);
        const F xm = widen(src[idx - 1]);
        const F rv = widen(rs[idx]);
        F corr = (F)-4.0, inv_d = (F)-0.25;     // 1 / -4, exact
        if (EDGE) {
            const int gy = T.oy + j;
            if (!xin || (!wy && (gy < 0 || gy >= ny))) {
                dst[idx] = narrow<ST>((F)0.0);
                ym = cur;
                cur = yp;
                continue;
            }
            F eyv = (F)edge<SIGNED>(gy, ny, sg.y_lo, sg.y_hi);
            corr = (eyv + exv) - (F)4.0;
            inv_d = (F)1.0 / corr;
        }
        F lap = xp + xm + yp + ym + cur * corr;
        dst[idx] = narrow<ST>(cur + omega * (rv - lap) * inv_d);
        ym = cur;
        cur = yp;
    }
}

// Sweeps S..N, alternating between the two buffers.
template <class G, int S, bool EDGE, bool SIGNED, class ST, bool WRAP = false>
__device__ __forceinline__ void sweeps(ST* a, ST* b, const ST* rs,
                                       const Tile& T, int ny, int nx,
                                       storage::compute_t<ST> omega,
                                       int from_zero,
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
// 1: 2 bytes), an f64 one (VEC 0) by vec (2: 16 bytes, 1: 8 bytes).
// WRAP (f32 or f64, SIGNED): the wrap form, wrap its periodic axes.
template <class G, int VEC, bool SIGNED, class ST, bool WRAP = false>
__global__ void __launch_bounds__(G::THREADS)
jacobi_kernel(const ST* __restrict__ e, const ST* __restrict__ r,
              ST* __restrict__ out, int L, int ny, int nx,
              storage::compute_t<ST> omega, int from_zero, Signs sg, int vec,
              int wrap) {
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
        } else if constexpr (storage::is_f64<ST>) {
            const int v2 = vec == 2 ? 2 : 1;
            const int cx = G::TX / v2;
            for (int q = threadIdx.x; q < G::TY * cx; q += G::THREADS) {
                const int j = q / cx, i = (q % cx) * v2;
                const int gy = T.y0 + j, gx = T.x0 + i;
                if (gy >= ny || gx >= nx) continue;
                const int k = (j + G::N) * G::W + i + G::HX;
                ST* o = out + T.base + (size_t)gy * nx + gx;
                if (v2 == 2)
                    *reinterpret_cast<double2*>(o) =
                        *reinterpret_cast<const double2*>(res + k);
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
using Launch = int (*)(const ST*, const ST*, ST*, int, int, int,
                       storage::compute_t<ST>, int, Signs, int, int, int,
                       cudaStream_t);

template <class G, int VEC, bool SIGNED, class ST, bool WRAP = false>
int launch(const ST* e, const ST* r, ST* out, int L, int ny, int nx,
           storage::compute_t<ST> omega, int from_zero, Signs sg, int vec,
           int grid, int wrap, cudaStream_t st) {
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

// 128 x 64 tiles for the fine levels (f64: 128 x 32), 32 x 16 for the
// coarse ones
template <int NSW, int VEC, bool SIGNED, class ST, bool WRAP = false>
Launch<ST> pick(int big) {
    constexpr int BIG_TY = storage::is_f64<ST> ? 32 : 64;
    return big ? launch<Geo<NSW, 128, BIG_TY, 4>, VEC, SIGNED, ST, WRAP>
               : launch<Geo<NSW, 32, 16, 8>, VEC, SIGNED, ST, WRAP>;
}

}  // namespace
