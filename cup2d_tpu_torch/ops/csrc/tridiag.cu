// The batched Thomas solve of the FFT-diagonalized direct Poisson solve
// (CUP2D_POIS=fftd with one periodic axis): per member l and mode k, the
// two first-order recurrences along the wall axis j = 0 .. n_s - 1,
//   forward   dp_j = (b_j - dp_{j-1}) * inv_denom_j     (dp_{-1} = 0)
//   backward  x_j  = dp_j - cp_j * x_{j+1}              (x_{n_s} = 0)
// on complex b, x [L, n_s, nk] (complex64 as float2, the real and the
// imaginary part each scaled by the real coefficient) with f32
// coefficients inv_denom, cp [n_s, nk] precomputed on the host
// (poisson.FFTDiagPlan).
//
// Replaces: no TPU kernel. The JAX package computes this with XLA's
// lax.scan (cup2d_tpu/poisson.py FFTDiagPlan.solve, the fwd and bwd
// scans); PyTorch has no scan, and its plain version is a Python loop of
// 2 n_s launches (16,384 at 8192^2).
//
// Bound on this card: memory. Per row and mode the function reads b (8
// bytes) and both coefficients (4 + 4) and writes x (8): 24 bytes, for 8
// operations. This design also writes dp (8) and reads it back (8): 40.
//
// Design: a lane per (member, mode), a CTA of one warp per 32 consecutive
// modes of one member (a ragged last group masks its lanes), so every row
// of a copy and of a store is coalesced over the modes. The recurrence is
// serial along j; what sets the rate is the bytes in flight, since one row
// of modes (nk = 4097 at 8192^2) is only 129 warps on 132 SMs. So each
// walk streams its operands through shared memory: tiles of ROWS rows x
// 32 modes, forward b and inv_denom, backward dp and cp, in a ring of
// STAGES stages filled by cp.async (8 bytes for a complex value, 4 for a
// coefficient: a row of nk complex values is 8 nk bytes, which is not a
// multiple of 16 for odd nk, so neither 16-byte copies nor TMA, whose
// global strides must be multiples of 16, can address the rows). The
// ring keeps STAGES - 1 tiles (126 KB) of loads in flight per warp while
// the lane runs its recurrence on the tile that has landed; the earlier
// design held 32 rows of loads in registers (12 KB a warp, 248
// registers). A lane copies and reads only its own mode's column, so its
// own cp.async.wait_group is all the synchronization a tile needs. The
// last rows of a ragged tile are masked.
// The forward walk writes dp into the output buffer and the backward walk
// copies it back from there, last rows first, and overwrites it with x:
// the rows the forward walk wrote last are the first the backward walk
// reads, and the L2 (50 MB) still holds part of them; nothing else keeps
// them on chip. Products and differences are written out (__fmul_rn,
// __fsub_rn): a contracted multiply-add would move an ulp from the plain
// version, and the order along j is the recurrences' own, so the result
// is the earlier design's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MODES = 32;    // modes of a CTA: one warp, a lane each
constexpr int ROWS = 48;     // rows of a tile
constexpr int STAGES = 8;    // tiles of the ring

struct Tile {
    float2 v[ROWS][MODES];   // b (forward) or dp (backward)
    float c[ROWS][MODES];    // inv_denom (forward) or cp (backward)
};
constexpr size_t SMEM = sizeof(Tile) * STAGES;

__device__ __forceinline__ void cp8(void* dst, const void* src) {
    uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
    uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy rows j0 .. j0 + nr - 1 of this lane's column of v (stride nk
// between rows) and of c into a tile, and close the copy group (empty for
// a masked lane or a tile past the end, so that the groups stay counted
// alike).
__device__ __forceinline__ void load(Tile& tl, const float2* v,
                                     const float* c, int j0, int nr, int nk,
                                     bool on) {
    const int lane = threadIdx.x;
    if (on) {
        for (int u = 0; u < nr; ++u) {
            cp8(&tl.v[u][lane], v + (size_t)(j0 + u) * nk);
            cp4(&tl.c[u][lane], c + (size_t)(j0 + u) * nk);
        }
    }
    cp_commit();
}

__global__ void __launch_bounds__(MODES, 1)
tridiag_kernel(const float2* __restrict__ b,
               const float* __restrict__ inv_denom,
               const float* __restrict__ cp, float2* x, int n_s, int nk) {
    extern __shared__ float4 smem4[];
    Tile* ring = reinterpret_cast<Tile*>(smem4);
    const int groups = (nk + MODES - 1) / MODES;
    const int l = blockIdx.x / groups;
    const int lane = threadIdx.x;
    const int k = (blockIdx.x - l * groups) * MODES + lane;
    const bool on = k < nk;
    const size_t base = (size_t)l * n_s * nk + (on ? k : 0);
    const float2* bl = b + base;
    float2* xl = x + base;
    const float* idl = inv_denom + (on ? k : 0);
    const float* cpl = cp + (on ? k : 0);
    const int tiles = (n_s + ROWS - 1) / ROWS;

    // forward: tile t holds rows t ROWS .. t ROWS + nr - 1, in order
    for (int t = 0; t < STAGES - 1; ++t)
        if (t < tiles)
            load(ring[t], bl, idl, t * ROWS, min(ROWS, n_s - t * ROWS), nk,
                 on);
        else
            cp_commit();
    float2 dp = make_float2(0.0f, 0.0f);
    for (int t = 0; t < tiles; ++t) {
        const int tn = t + STAGES - 1;
        if (tn < tiles)
            load(ring[tn % STAGES], bl, idl, tn * ROWS,
                 min(ROWS, n_s - tn * ROWS), nk, on);
        else
            cp_commit();
        cp_wait<STAGES - 1>();
        if (!on) continue;
        const Tile& tl = ring[t % STAGES];
        const int j0 = t * ROWS, nr = min(ROWS, n_s - j0);
#pragma unroll 8
        for (int u = 0; u < nr; ++u) {
            const float2 bb = tl.v[u][lane];
            const float id = tl.c[u][lane];
            dp.x = __fmul_rn(__fsub_rn(bb.x, dp.x), id);
            dp.y = __fmul_rn(__fsub_rn(bb.y, dp.y), id);
            xl[(size_t)(j0 + u) * nk] = dp;
        }
    }
    cp_wait<0>();
    // the backward walk's copies read what this lane's stores just wrote
    __threadfence_block();

    // backward: tile t holds rows lo .. hi - 1, hi = n_s - t ROWS, walked
    // from hi - 1 down
    for (int t = 0; t < STAGES - 1; ++t) {
        const int hi = n_s - t * ROWS, lo = max(0, hi - ROWS);
        if (t < tiles)
            load(ring[t], xl, cpl, lo, hi - lo, nk, on);
        else
            cp_commit();
    }
    float2 xn = make_float2(0.0f, 0.0f);
    for (int t = 0; t < tiles; ++t) {
        const int tn = t + STAGES - 1;
        if (tn < tiles) {
            const int hi = n_s - tn * ROWS, lo = max(0, hi - ROWS);
            load(ring[tn % STAGES], xl, cpl, lo, hi - lo, nk, on);
        } else {
            cp_commit();
        }
        cp_wait<STAGES - 1>();
        if (!on) continue;
        const Tile& tl = ring[t % STAGES];
        const int hi = n_s - t * ROWS, lo = max(0, hi - ROWS);
#pragma unroll 8
        for (int u = hi - lo - 1; u >= 0; --u) {
            const float2 dd = tl.v[u][lane];
            const float c = tl.c[u][lane];
            xn.x = __fsub_rn(dd.x, __fmul_rn(c, xn.x));
            xn.y = __fsub_rn(dd.y, __fmul_rn(c, xn.y));
            xl[(size_t)(lo + u) * nk] = xn;
        }
    }
    cp_wait<0>();
}

}  // namespace

// b, x: [L, n_s, nk] complex64 as interleaved float pairs (8-byte
// aligned); inv_denom, cp: [n_s, nk] f32 (4-byte aligned). x must not
// overlap b.
extern "C" int cup2d_tridiag_scan(const float* b, const float* inv_denom,
                                  const float* cp, float* x, int L, int n_s,
                                  int nk, void* stream) {
    if (L < 1 || n_s < 1 || nk < 1)
        return (int)cudaErrorInvalidValue;
    const long long grid = (long long)L * ((nk + MODES - 1) / MODES);
    if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
    // above 48 KB of shared memory once per device (a bit per ordinal)
    static unsigned long long opted_in = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (!(dev < 64 && (opted_in >> dev & 1))) {
        err = cudaFuncSetAttribute(
            tridiag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)SMEM);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) opted_in |= 1ull << dev;
    }
    tridiag_kernel<<<(int)grid, MODES, SMEM, (cudaStream_t)stream>>>(
        reinterpret_cast<const float2*>(b), inv_denom, cp,
        reinterpret_cast<float2*>(x), n_s, nk);
    return (int)cudaGetLastError();
}
