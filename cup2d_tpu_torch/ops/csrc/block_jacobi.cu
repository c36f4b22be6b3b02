// One sweep of the forest's damped block-Jacobi smoother, after the
// operator has been applied:
//   out[n, i] = e[n, i] + sum_k (r[n, k] - lap[n, k]) * P_inv[i, k]
// over [N, 64] f32 block stacks (BS 8), P_inv a 64 x 64 f32 matrix.
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _block_jacobi_kernel (reached
// from fused_block_jacobi_update), f32.
//
// Bound on this card: per block 3 x 256 bytes read and 256 written against
// 64 x (2 x 64 + 2) operations, about 8 per byte, under the H100's f32
// balance point (~20 per byte): memory bounds it.
//
// Design: the Pallas kernel runs the product on the MXU at full f32. No
// TF32 here either: the product is an f32 FMA chain of 64 terms per
// output element, k in order. P_inv is staged once per CTA in shared
// memory (16.6 KB), transposed with a row pitch of 65 words so that both
// the coalesced staging stores and the compute loop's reads (the 64
// threads of a row on consecutive words) are free of bank conflicts; the
// CTA then walks the block stack, ROWS blocks at a time, with one output
// element per thread, and d = r - lap staged in shared memory for the
// row's 64 threads.

#include <cuda_runtime.h>

namespace {

constexpr int M = 64;                 // BS * BS
constexpr int PITCH = M + 1;          // shared row pitch of the transpose
constexpr int ROWS = 4;               // blocks per CTA step
constexpr int THREADS = ROWS * M;     // 256

__global__ void __launch_bounds__(THREADS)
block_jacobi_kernel(const float* __restrict__ p_inv,
                    const float* __restrict__ e, const float* __restrict__ r,
                    const float* __restrict__ lap, float* __restrict__ out,
                    int n) {
    __shared__ float pt[M * PITCH];   // pt[k * PITCH + i] = P_inv[i, k]
    __shared__ float d[ROWS][M];
    for (int q = threadIdx.x; q < M * M; q += THREADS) {
        int i = q / M, k = q % M;
        pt[k * PITCH + i] = p_inv[q];
    }
    const int b = threadIdx.x / M;
    const int i = threadIdx.x % M;
    for (int row0 = blockIdx.x * ROWS; row0 < n; row0 += gridDim.x * ROWS) {
        const int row = row0 + b;
        const size_t o = (size_t)row * M + i;
        __syncthreads();
        if (row < n) d[b][i] = r[o] - lap[o];
        __syncthreads();
        if (row < n) {
            float z = 0.0f;
#pragma unroll 16
            for (int k = 0; k < M; ++k)
                z = fmaf(d[b][k], pt[k * PITCH + i], z);
            out[o] = e[o] + z;
        }
    }
}

}  // namespace

extern "C" int cup2d_block_jacobi(const float* p_inv, const float* e,
                                  const float* r, const float* lap,
                                  float* out, int n, void* stream) {
    if (n <= 0) return 0;
    int ctas = (n + ROWS - 1) / ROWS;
    if (ctas > 132 * 8) ctas = 132 * 8;
    block_jacobi_kernel<<<ctas, THREADS, 0, (cudaStream_t)stream>>>(
        p_inv, e, r, lap, out, n);
    return (int)cudaGetLastError();
}
