// WENO5 advection plus diffusion right-hand side over a ghost-padded lab:
//   out = afac * (u . grad) q + dfac * lap(q)   (undivided, per component q)
// lab [L, 2, ny + 6, nx + 6] f32 with three ghost cells on each side, read
// as they are (no paint); out [L, 2, ny, nx]; facs [2] f32 = (afac, dfac) =
// (-dt*h, nu*dt), shared by the batch.
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _adv_kernel (reached from
// advect_diffuse_rhs_pallas through _advect_call), the round-4 single-op
// kernel over a pre-padded lab.
//
// Bound on this card: the arithmetic: about 365 operations per cell and
// component against 16 bytes per cell (the lab read once, the result
// written once), above the H100's f32 balance point of ~20 operations per
// byte.
//
// Design: the tile loop of advect_heun.cu without its ghost paint and
// without the Heun update. A block stages its TY x TX output tile plus the
// 3-cell halo of both components in shared memory (the halo is re-read by
// neighbouring blocks, mostly from L2) and runs the per-cell code of
// weno.cuh, shared with the other two WENO kernels.

#include <cuda_runtime.h>
#include <cstdint>

#include "weno.cuh"

namespace {

constexpr int G = 3;
constexpr int TX = 32;
constexpr int TY = 16;
constexpr int LX = TX + 2 * G;
constexpr int LY = TY + 2 * G;
constexpr int THREADS_Y = 8;

__global__ void __launch_bounds__(TX * THREADS_Y)
advect_rhs_kernel(const float* __restrict__ labv, float* __restrict__ out,
                  const float* __restrict__ facs, int ny, int nx) {
    __shared__ float lab[2][LY][LX];
    const int l = blockIdx.z;
    const int x0 = blockIdx.x * TX;
    const int y0 = blockIdx.y * TY;
    const int wp = nx + 2 * G;
    const size_t pplane = (size_t)(ny + 2 * G) * wp;
    const size_t plane = (size_t)ny * nx;
    const float* src = labv + (size_t)l * 2 * pplane;
    const int tid = threadIdx.y * TX + threadIdx.x;

    for (int k = tid; k < LY * LX; k += TX * THREADS_Y) {
        int j = k / LX, i = k - (k / LX) * LX;
        // lab coordinates; a ragged last tile clamps, feeding no output
        int py = min(y0 + j, ny + 2 * G - 1);
        int px = min(x0 + i, wp - 1);
        size_t idx = (size_t)py * wp + px;
        lab[0][j][i] = src[idx];
        lab[1][j][i] = src[pplane + idx];
    }
    __syncthreads();

    const float afac = facs[0];
    const float dfac = facs[1];
    const int x = x0 + threadIdx.x;
    const int i = threadIdx.x + G;
    for (int r = threadIdx.y; r < TY; r += THREADS_Y) {
        const int y = y0 + r;
        if (y >= ny || x >= nx) continue;
        const int j = r + G;
        const float wu = lab[0][j][i];
        const float wv = lab[1][j][i];
        const size_t cell = (size_t)y * nx + x;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            out[((size_t)l * 2 + c) * plane + cell] =
                cup2d::advect_diffuse_cell(&lab[c][j][i], LX, wu, wv, afac,
                                           dfac);
        }
    }
}

}  // namespace

extern "C" int cup2d_advect_rhs(const float* lab, float* out,
                                const float* facs, int L, int ny, int nx,
                                void* stream) {
    dim3 block(TX, THREADS_Y);
    dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, L);
    advect_rhs_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        lab, out, facs, ny, nx);
    return (int)cudaGetLastError();
}
