// One Heun substage of WENO5 advection plus diffusion on one x slab of a
// free-slip box split along x:
//   out = vold + cfac * rhs * ih2,
//   rhs = afac * (u . grad) q + dfac * lap(q)   (undivided, per component q)
// for a batch of L members, v/vold/out [L, 2, ny, nxl] f32, facs [L, 2] f32
// (afac = -dt*h, dfac = nu*dt per member), aux [L, 2, ny, 6] f32: the three
// columns left of the slab (aux[..., 0:3], the left neighbour's last three)
// and the three right of it (aux[..., 3:6], the right neighbour's first
// three). is_lo / is_hi say that the slab owns the low / high x wall; there
// the aux columns are ignored and the wall ghosts are painted. vold ==
// nullptr means vold = v (the first substage).
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _sharded_substage_kernel
// (reached from _fused_substage_sharded), free-slip table, f32 storage.
//
// Bound on this card: the arithmetic, as for advect_heun.cu: about 368
// operations per cell and component against 16 or 24 bytes per cell
// (the 6-column aux adds 48 bytes per row, under 3% at a slab width of
// 2048), above the H100's f32 balance point of ~20 operations per byte.
//
// Design: the tile of advect_heun.cu, which loads its own halo. A tile at
// a slab edge reads its x halo from aux where that side has a neighbour
// and paints the free-slip x ghost (u negated, v copied, from the
// y-completed edge column) only where the slab owns the wall. y ghosts are
// painted over the halo columns too (u copied, v negated), so the corners
// compose y then x as in the solo kernel, and every lab value is the
// number the solo kernel loads at the same global position. The per-cell
// arithmetic is weno.cuh, shared with the solo kernel, and the update is
// written as there: the slabs of a split step reproduce the solo kernel's
// output bit for bit. The TPU kernel's 128-lane padding of aux is a DMA
// artefact and is not kept.

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
substage_halo_kernel(const float* __restrict__ v,
                     const float* __restrict__ vold,
                     const float* __restrict__ aux, float* __restrict__ out,
                     const float* __restrict__ facs, int ny, int nxl,
                     float cfac, float ih2, int is_lo, int is_hi) {
    __shared__ float lab[2][LY][LX];
    const int l = blockIdx.z;
    const int x0 = blockIdx.x * TX;
    const int y0 = blockIdx.y * TY;
    const size_t plane = (size_t)ny * nxl;
    const size_t aplane = (size_t)ny * 2 * G;
    const float* u = v + (size_t)l * 2 * plane;
    const float* w = u + plane;
    const float* au = aux + (size_t)l * 2 * aplane;
    const float* aw = au + aplane;
    const int tid = threadIdx.y * TX + threadIdx.x;

    for (int k = tid; k < LY * LX; k += TX * THREADS_Y) {
        int j = k / LX, i = k - (k / LX) * LX;
        int gy = y0 + j - G, gx = x0 + i - G;
        float su = 1.0f, sv = 1.0f;
        if (gy < 0) { gy = 0; sv = -1.0f; }
        else if (gy >= ny) { gy = ny - 1; sv = -1.0f; }
        const float* su_src = u;
        const float* sw_src = w;
        size_t idx;
        if (gx < 0 && !is_lo) {
            idx = (size_t)gy * 2 * G + (gx + G);
            su_src = au; sw_src = aw;
        } else if (gx >= nxl && !is_hi) {
            // a ragged last tile loads past the third halo column: those
            // lab cells feed no output cell, so they repeat the third
            int c = gx - nxl < G ? gx - nxl : G - 1;
            idx = (size_t)gy * 2 * G + (G + c);
            su_src = au; sw_src = aw;
        } else {
            if (gx < 0) { gx = 0; su = -1.0f; }
            else if (gx >= nxl) { gx = nxl - 1; su = -1.0f; }
            idx = (size_t)gy * nxl + gx;
        }
        lab[0][j][i] = su * su_src[idx];
        lab[1][j][i] = sv * sw_src[idx];
    }
    __syncthreads();

    const float afac = facs[2 * l];
    const float dfac = facs[2 * l + 1];
    const int x = x0 + threadIdx.x;
    const int i = threadIdx.x + G;
    for (int r = threadIdx.y; r < TY; r += THREADS_Y) {
        const int y = y0 + r;
        if (y >= ny || x >= nxl) continue;
        const int j = r + G;
        const float wu = lab[0][j][i];
        const float wv = lab[1][j][i];
        const size_t cell = (size_t)y * nxl + x;
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

extern "C" int cup2d_advect_substage_halo(const float* v, const float* vold,
                                          const float* aux, float* out,
                                          const float* facs, int L, int ny,
                                          int nxl, float cfac, float ih2,
                                          int is_lo, int is_hi,
                                          void* stream) {
    dim3 block(TX, THREADS_Y);
    dim3 grid((nxl + TX - 1) / TX, (ny + TY - 1) / TY, L);
    substage_halo_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        v, vold, aux, out, facs, ny, nxl, cfac, ih2, is_lo, is_hi);
    return (int)cudaGetLastError();
}
