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
// Design: one thread per (member, mode), threads of a warp on consecutive
// modes, so every load and store of a row is coalesced over the modes.
// The forward walk writes dp into the output buffer and the backward walk
// reads it from there and overwrites it with x. The recurrence is serial
// along j, so a thread issues the loads of UNROLL = 32 rows before it
// runs their arithmetic: the loads are independent of the carried value
// and stay in flight together. One row of modes (nk = 4097 at 8192^2) is
// only 4097 threads, 129 warps, so the bytes in flight, not the threads,
// set the rate: a block is one warp (129 blocks over the 132 SMs) and
// each thread keeps 32 rows of loads in flight (248 registers; a first
// version with 8 rows in 64-thread blocks took 2.5x as long). Products
// and differences are written out (__fmul_rn, __fsub_rn): a contracted
// multiply-add would move an ulp from the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;
constexpr int UNROLL = 32;

__global__ void __launch_bounds__(THREADS)
tridiag_kernel(const float2* __restrict__ b,
               const float* __restrict__ inv_denom,
               const float* __restrict__ cp, float2* __restrict__ x, int L,
               int n_s, int nk) {
    const int t = blockIdx.x * THREADS + threadIdx.x;
    if (t >= L * nk) return;
    const int l = t / nk, k = t - l * nk;
    const size_t base = (size_t)l * n_s * nk + k;

    float2 dp = make_float2(0.0f, 0.0f);
    int j = 0;
    for (; j + UNROLL <= n_s; j += UNROLL) {
        float2 bb[UNROLL];
        float id[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            bb[u] = b[base + (size_t)(j + u) * nk];
            id[u] = inv_denom[(size_t)(j + u) * nk + k];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            dp.x = __fmul_rn(__fsub_rn(bb[u].x, dp.x), id[u]);
            dp.y = __fmul_rn(__fsub_rn(bb[u].y, dp.y), id[u]);
            x[base + (size_t)(j + u) * nk] = dp;
        }
    }
    for (; j < n_s; ++j) {
        const float2 bj = b[base + (size_t)j * nk];
        const float id = inv_denom[(size_t)j * nk + k];
        dp.x = __fmul_rn(__fsub_rn(bj.x, dp.x), id);
        dp.y = __fmul_rn(__fsub_rn(bj.y, dp.y), id);
        x[base + (size_t)j * nk] = dp;
    }

    float2 xn = make_float2(0.0f, 0.0f);
    j = n_s - 1;
    for (; j - UNROLL + 1 >= 0; j -= UNROLL) {
        float2 dd[UNROLL];
        float c[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            dd[u] = x[base + (size_t)(j - u) * nk];
            c[u] = cp[(size_t)(j - u) * nk + k];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            xn.x = __fsub_rn(dd[u].x, __fmul_rn(c[u], xn.x));
            xn.y = __fsub_rn(dd[u].y, __fmul_rn(c[u], xn.y));
            x[base + (size_t)(j - u) * nk] = xn;
        }
    }
    for (; j >= 0; --j) {
        const float2 dj = x[base + (size_t)j * nk];
        const float c = cp[(size_t)j * nk + k];
        xn.x = __fsub_rn(dj.x, __fmul_rn(c, xn.x));
        xn.y = __fsub_rn(dj.y, __fmul_rn(c, xn.y));
        x[base + (size_t)j * nk] = xn;
    }
}

}  // namespace

// b, x: [L, n_s, nk] complex64 as interleaved float pairs (8-byte
// aligned); inv_denom, cp: [n_s, nk] f32. x must not overlap b.
extern "C" int cup2d_tridiag_scan(const float* b, const float* inv_denom,
                                  const float* cp, float* x, int L, int n_s,
                                  int nk, void* stream) {
    if (L < 1 || n_s < 1 || nk < 1
            || (long long)L * nk > 2147483647LL - THREADS)
        return (int)cudaErrorInvalidValue;
    const int grid = (L * nk + THREADS - 1) / THREADS;
    tridiag_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float2*>(b), inv_denom, cp,
        reinterpret_cast<float2*>(x), L, n_s, nk);
    return (int)cudaGetLastError();
}
