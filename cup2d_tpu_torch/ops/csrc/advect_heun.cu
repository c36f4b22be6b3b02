// One Heun substage of WENO5 advection plus diffusion on a free-slip box:
//   out = vold + cfac * rhs * ih2,
//   rhs = afac * (u . grad) q + dfac * lap(q)   (undivided, per component q)
// for a batch of L members, v/vold/out [L, 2, ny, nx] f32, facs [L, 2] f32
// (afac = -dt*h, dfac = nu*dt per member). vold == nullptr means vold = v
// (the first substage).
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _substage_kernel (reached from
// fused_advect_heun through _fused_substage), free-slip table, f32 storage.
//
// Bound on this card: about 368 operations per cell and component
// against 16 (first substage) or 24 (second) bytes per cell, about 30
// operations per byte, above the H100's f32 balance point (~20 per byte
// at 67 TFLOP/s and 3.35 TB/s): the arithmetic of the eight WENO
// reconstructions per cell bounds it, not memory.
//
// Design: the TPU kernel streams row strips through a 4-slot VMEM ring that
// carries halo rows from one sequential grid step to the next. CUDA blocks
// run in parallel, so nothing carries over: each block owns a TY x TX
// output tile of one member and loads the tile plus a 3-cell halo of both
// components into shared memory, building wall ghosts from global indices
// (y ghosts copy u and negate v, x ghosts negate u and copy v of the
// y-completed column, so a corner is (-u, -v) of the corner cell). The
// halo is re-read by neighbouring blocks (1.6x loads, served mostly by
// L2). The per-cell arithmetic is weno.cuh, shared with lab_rhs.cu: it
// follows ops/stencil.py term for term in f32; the normalizer of the WENO
// weights is the bit-trick reciprocal, the weight divide a correctly
// rounded reciprocal. Only FMA contraction by the compiler separates the
// result from the plain PyTorch version.

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
substage_kernel(const float* __restrict__ v, const float* __restrict__ vold,
                float* __restrict__ out, const float* __restrict__ facs,
                int ny, int nx, float cfac, float ih2) {
    __shared__ float lab[2][LY][LX];
    const int l = blockIdx.z;
    const int x0 = blockIdx.x * TX;
    const int y0 = blockIdx.y * TY;
    const size_t plane = (size_t)ny * nx;
    const float* u = v + (size_t)l * 2 * plane;
    const float* w = u + plane;
    const int tid = threadIdx.y * TX + threadIdx.x;

    for (int k = tid; k < LY * LX; k += TX * THREADS_Y) {
        int j = k / LX, i = k - (k / LX) * LX;
        int gy = y0 + j - G, gx = x0 + i - G;
        float su = 1.0f, sv = 1.0f;
        if (gy < 0) { gy = 0; sv = -1.0f; }
        else if (gy >= ny) { gy = ny - 1; sv = -1.0f; }
        if (gx < 0) { gx = 0; su = -1.0f; }
        else if (gx >= nx) { gx = nx - 1; su = -1.0f; }
        size_t idx = (size_t)gy * nx + gx;
        lab[0][j][i] = su * u[idx];
        lab[1][j][i] = sv * w[idx];
    }
    __syncthreads();

    const float afac = facs[2 * l];
    const float dfac = facs[2 * l + 1];
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
            const float* q = &lab[c][j][i];
            float rhs = cup2d::advect_diffuse_cell(q, LX, wu, wv, afac,
                                                   dfac);
            size_t o = ((size_t)l * 2 + c) * plane + cell;
            float vo = vold ? vold[o] : q[0];
            out[o] = vo + cfac * rhs * ih2;
        }
    }
}

}  // namespace

extern "C" int cup2d_advect_substage(const float* v, const float* vold,
                                     float* out, const float* facs, int L,
                                     int ny, int nx, float cfac, float ih2,
                                     void* stream) {
    dim3 block(TX, THREADS_Y);
    dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, L);
    substage_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        v, vold, out, facs, ny, nx, cfac, ih2);
    return (int)cudaGetLastError();
}
