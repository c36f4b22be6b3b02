// One damped-Jacobi sweep of the undivided zero-ghost 5-point Laplacian
// with the Neumann wall diagonal on one x slab of a field split along x:
//   out = e + omega * (r - lap(e)) / d,   d = (ey + ex) - 4
// e, r, out [L, ny, nxl] f32; aux [L, ny, 2] f32 holds the column left of
// the slab (aux[..., 0], the left neighbour's last column) and the column
// right of it (aux[..., 1], the right neighbour's first), zeros where the
// slab owns a wall. ey is 1 on the first and last rows; ex is 1 on the
// first column only where is_lo, on the last only where is_hi, so the
// x-wall diagonal appears on the wall slabs alone. from_zero makes the
// sweep e = omega * r / d and ignores e and aux (either may be null).
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _jacobi_halo_kernel (reached
// from fused_jacobi_halo_sweep), Neumann walls, f32 storage.
//
// Bound on this card: memory. A sweep reads e and r and writes the result,
// 12 bytes per cell (8 from zero), for 9 operations per cell.
//
// Design: one sweep per launch, as on the TPU: each sweep needs fresh
// neighbour columns, so the split chain cannot block sweeps in time as
// jacobi.cu does. One thread per cell; the four neighbours of a cell are
// loads that the block's neighbours in x and y share through L1. The sweep
// is written term for term as in jacobi.cu (and the plain version), so a
// split sweep equals jacobi.cu's single sweep bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

__global__ void __launch_bounds__(TX * TY)
jacobi_halo_kernel(const float* __restrict__ e, const float* __restrict__ r,
                   const float* __restrict__ aux, float* __restrict__ out,
                   int ny, int nxl, float omega, int is_lo, int is_hi,
                   int from_zero) {
    const int gx = blockIdx.x * TX + threadIdx.x;
    const int gy = blockIdx.y * TY + threadIdx.y;
    if (gx >= nxl || gy >= ny) return;
    const int l = blockIdx.z;
    const size_t base = (size_t)l * ny * nxl;
    const size_t idx = base + (size_t)gy * nxl + gx;

    float exv = (gx == 0 && is_lo) ? 1.0f
              : ((gx == nxl - 1 && is_hi) ? 1.0f : 0.0f);
    float eyv = gy == 0 ? 1.0f : (gy == ny - 1 ? 1.0f : 0.0f);
    float corr = (eyv + exv) - 4.0f;
    float inv_d = 1.0f / corr;
    float rv = r[idx];
    float nw;
    if (from_zero) {
        nw = omega * rv * inv_d;
    } else {
        const float* a = aux + ((size_t)l * ny + gy) * 2;
        float cur = e[idx];
        float xp = gx + 1 < nxl ? e[idx + 1] : a[1];
        float xm = gx > 0 ? e[idx - 1] : a[0];
        float yp = gy + 1 < ny ? e[idx + nxl] : 0.0f;
        float ym = gy > 0 ? e[idx - nxl] : 0.0f;
        float lap = xp + xm + yp + ym + cur * corr;
        nw = cur + omega * (rv - lap) * inv_d;
    }
    out[idx] = nw;
}

}  // namespace

extern "C" int cup2d_jacobi_halo_sweep(const float* e, const float* r,
                                       const float* aux, float* out, int L,
                                       int ny, int nxl, float omega,
                                       int is_lo, int is_hi, int from_zero,
                                       void* stream) {
    dim3 block(TX, TY);
    dim3 grid((nxl + TX - 1) / TX, (ny + TY - 1) / TY, L);
    jacobi_halo_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        e, r, aux, out, ny, nxl, omega, is_lo, is_hi, from_zero);
    return (int)cudaGetLastError();
}
