// One damped-Jacobi sweep of the undivided zero-ghost 5-point Laplacian
// with the Neumann wall diagonal on one x slab of a field split along x:
//   out = e + omega * (r - lap(e)) / d,   d = (ey + ex) - 4
// e, r, out [L, ny, nxl] f32 (or all bf16, aux too); aux [L, ny, 2] holds
// the column left of the slab (aux[..., 0], the left neighbour's last
// column) and the column right of it (aux[..., 1], the right neighbour's
// first), zeros where the slab owns a wall. ey is 1 on the first and last
// rows; ex is 1 on the first column only where is_lo, on the last only
// where is_hi, so the x-wall diagonal appears on the wall slabs alone.
// from_zero makes the sweep e = omega * r / d and ignores e and aux
// (either may be null).
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _jacobi_halo_kernel (reached
// from fused_jacobi_halo_sweep), Neumann walls, f32 storage
// (cup2d_jacobi_halo_sweep) and bf16 storage (cup2d_jacobi_halo_sweep_bf16:
// the split hierarchy's sweeps under the FAS solver's bf16 legs).
//
// Bound on this card: memory. A sweep reads e and r and writes the result,
// 12 bytes per cell (8 from zero; 6 and 4 in bf16), for 9 operations per
// cell.
//
// Design: one sweep per launch, as on the TPU: each sweep needs fresh
// neighbour columns, so the split chain cannot block sweeps in time as
// jacobi.cu does. One thread per cell; the four neighbours of a cell are
// loads that the block's neighbours in x and y share through L1. The sweep
// is written term for term as in jacobi.cu (and the plain version), so a
// split sweep equals jacobi.cu's single sweep bit for bit. In bf16 storage
// (the storage type a template parameter; the f32 instance is the kernel
// above) the operands are widened where they are read and the result
// rounded to bf16 once, as jacobi.cu rounds each sweep: a split bf16 sweep
// equals a bf16 chain's sweep bit for bit too.

#include <cuda_runtime.h>

#include "storage.cuh"

namespace {

using storage::widen;

constexpr int TX = 32;
constexpr int TY = 8;

template <class ST>
__global__ void __launch_bounds__(TX * TY)
jacobi_halo_kernel(const ST* __restrict__ e, const ST* __restrict__ r,
                   const ST* __restrict__ aux, ST* __restrict__ out,
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
    float rv = widen(r[idx]);
    float nw;
    if (from_zero) {
        nw = omega * rv * inv_d;
    } else {
        const ST* a = aux + ((size_t)l * ny + gy) * 2;
        float cur = widen(e[idx]);
        float xp = widen(gx + 1 < nxl ? e[idx + 1] : a[1]);
        float xm = widen(gx > 0 ? e[idx - 1] : a[0]);
        float yp = gy + 1 < ny ? widen(e[idx + nxl]) : 0.0f;
        float ym = gy > 0 ? widen(e[idx - nxl]) : 0.0f;
        float lap = xp + xm + yp + ym + cur * corr;
        nw = cur + omega * (rv - lap) * inv_d;
    }
    out[idx] = storage::narrow<ST>(nw);
}

template <class ST>
int sweep(const ST* e, const ST* r, const ST* aux, ST* out, int L, int ny,
          int nxl, float omega, int is_lo, int is_hi, int from_zero,
          void* stream) {
    dim3 block(TX, TY);
    dim3 grid((nxl + TX - 1) / TX, (ny + TY - 1) / TY, L);
    jacobi_halo_kernel<ST><<<grid, block, 0, (cudaStream_t)stream>>>(
        e, r, aux, out, ny, nxl, omega, is_lo, is_hi, from_zero);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cup2d_jacobi_halo_sweep(const float* e, const float* r,
                                       const float* aux, float* out, int L,
                                       int ny, int nxl, float omega,
                                       int is_lo, int is_hi, int from_zero,
                                       void* stream) {
    return sweep(e, r, aux, out, L, ny, nxl, omega, is_lo, is_hi, from_zero,
                 stream);
}

// The bf16 form: e, r, aux, out bf16.
extern "C" int cup2d_jacobi_halo_sweep_bf16(const void* e, const void* r,
                                            const void* aux, void* out,
                                            int L, int ny, int nxl,
                                            float omega, int is_lo,
                                            int is_hi, int from_zero,
                                            void* stream) {
    using storage::bf16;
    return sweep(static_cast<const bf16*>(e), static_cast<const bf16*>(r),
                 static_cast<const bf16*>(aux), static_cast<bf16*>(out), L,
                 ny, nxl, omega, is_lo, is_hi, from_zero, stream);
}
