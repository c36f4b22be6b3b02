// WENO5 advection plus diffusion RHS over pre-assembled forest labs:
//   out[n, c] = afac_n * (u . grad) q_c + dfac_n * lap(q_c)   (undivided)
// for lab [N, 2, 14, 14] f32 (BS 8, 3 ghost cells), h [N] f32 per block,
// dt a device f32 scalar and nu a float: afac_n = -dt*h_n, dfac = nu*dt,
// in f32 as the plain version forms them; out [N, 2, 8, 8] f32. Pad rows
// (h = 1, stale but finite data) are computed like the rest; the caller
// masks them.
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _lab_kernel (reached from
// fused_lab_rhs), f32.
//
// Bound on this card: per block 2 x 196 lab values read and 2 x 64 RHS
// values written (2084 bytes with h) against 2 x 64 x 365
// operations (the 368 of a uniform substage cell less its 3-op update):
// about 22 operations per byte, just above the H100's f32 balance point
// (~20 per byte at 67 TFLOP/s and 3.35 TB/s), so the WENO arithmetic
// bounds it, with memory close behind.
//
// Design: the Pallas kernel streams chunks of whole labs through VMEM and
// evaluates the shared advect_diffuse_core on them. Here a CTA takes
// BPC = 4 consecutive labs (6.3 KB), copies them into shared memory with
// coalesced loads (the labs are contiguous), and runs one thread per
// output cell and component (512 threads). The per-cell arithmetic is
// weno.cuh, shared with the uniform substage kernel.

#include <cuda_runtime.h>

#include "weno.cuh"

namespace {

constexpr int BS = 8;
constexpr int G = 3;
constexpr int L = BS + 2 * G;                 // 14
constexpr int LAB = 2 * L * L;                // floats per lab
constexpr int BPC = 4;                        // labs per CTA
constexpr int THREADS = BPC * 2 * BS * BS;    // 512

__global__ void __launch_bounds__(THREADS)
lab_rhs_kernel(const float* __restrict__ lab, const float* __restrict__ h,
               const float* __restrict__ dt, float nu,
               float* __restrict__ out, int n) {
    __shared__ float s[BPC * LAB];
    const int n0 = blockIdx.x * BPC;
    const int nb = min(BPC, n - n0);
    const float* src = lab + (size_t)n0 * LAB;
    for (int k = threadIdx.x; k < nb * LAB; k += THREADS) s[k] = src[k];
    __syncthreads();

    const int b = threadIdx.x / (2 * BS * BS);
    if (b >= nb) return;
    const int c = (threadIdx.x / (BS * BS)) & 1;
    const int cell = threadIdx.x % (BS * BS);
    const int y = cell / BS, x = cell % BS;
    const int at = (y + G) * L + (x + G);
    const float* blk = s + b * LAB;
    const float wu = blk[at];
    const float wv = blk[L * L + at];
    const int row = n0 + b;
    const float afac = -dt[0] * h[row];
    const float dfac = nu * dt[0];
    out[((size_t)row * 2 + c) * (BS * BS) + cell] =
        cup2d::advect_diffuse_cell(blk + c * L * L + at, L, wu, wv, afac,
                                   dfac);
}

}  // namespace

extern "C" int cup2d_lab_rhs(const float* lab, const float* h,
                             const float* dt, float nu, float* out, int n,
                             void* stream) {
    if (n <= 0) return 0;
    lab_rhs_kernel<<<(n + BPC - 1) / BPC, THREADS, 0,
                     (cudaStream_t)stream>>>(lab, h, dt, nu, out, n);
    return (int)cudaGetLastError();
}
