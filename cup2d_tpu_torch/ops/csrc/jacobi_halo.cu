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
// (either may be null). The signed form puts a boundary table's pressure
// sign of the face in place of each 1 (sy_lo / sy_hi on the first / last
// row, sx_lo / sx_hi on the first / last column where is_lo / is_hi; -1 at
// a Dirichlet outflow face), in the diagonal and in lap's wall term alike.
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _jacobi_halo_kernel (reached
// from fused_jacobi_halo_sweep), Neumann walls, f32 storage
// (cup2d_jacobi_halo_sweep) and bf16 storage (cup2d_jacobi_halo_sweep_bf16:
// the split hierarchy's sweeps under the FAS solver's bf16 legs). The
// signed forms (cup2d_jacobi_halo_sweep_signed, cup2d_jacobi_halo_sweep_
// signed_bf16) have no TPU kernel of their own: the JAX package's signed
// hierarchies drop the halo sweep and run the signed _jacobi_strips_kernel
// on GSPMD-partitioned levels, so these slab sweeps stand for one signed
// sweep of that kernel, and equal jacobi.cu's signed single sweep bit for
// bit.
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
// split sweep equals jacobi.cu's single sweep bit for bit, Neumann or
// signed (the signs a template parameter: the Neumann instances are the
// kernel above, unchanged). In bf16 storage
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

// per-face edge signs (x_lo, x_hi, y_lo, y_hi)
struct Signs {
    float x_lo, x_hi, y_lo, y_hi;
};

// The wall indicator of a cell at the low (at_lo) or high (at_hi) end of
// an axis: the Neumann 1, or the face's sign (SIGNED); 0 elsewhere. At_lo
// wins where both hold, as jacobi.cu's edge() gives index 0 of n = 1.
template <bool SIGNED>
__device__ __forceinline__ float edge(bool at_lo, bool at_hi, float lo,
                                      float hi) {
    if constexpr (SIGNED)
        return at_lo ? lo : (at_hi ? hi : 0.0f);
    else
        return at_lo ? 1.0f : (at_hi ? 1.0f : 0.0f);
}

template <bool SIGNED, class ST>
__global__ void __launch_bounds__(TX * TY)
jacobi_halo_kernel(const ST* __restrict__ e, const ST* __restrict__ r,
                   const ST* __restrict__ aux, ST* __restrict__ out,
                   int ny, int nxl, float omega, int is_lo, int is_hi,
                   int from_zero, Signs sg) {
    const int gx = blockIdx.x * TX + threadIdx.x;
    const int gy = blockIdx.y * TY + threadIdx.y;
    if (gx >= nxl || gy >= ny) return;
    const int l = blockIdx.z;
    const size_t base = (size_t)l * ny * nxl;
    const size_t idx = base + (size_t)gy * nxl + gx;

    float exv = edge<SIGNED>(gx == 0 && is_lo, gx == nxl - 1 && is_hi,
                             sg.x_lo, sg.x_hi);
    float eyv = edge<SIGNED>(gy == 0, gy == ny - 1, sg.y_lo, sg.y_hi);
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

template <bool SIGNED, class ST>
int sweep(const ST* e, const ST* r, const ST* aux, ST* out, int L, int ny,
          int nxl, float omega, int is_lo, int is_hi, int from_zero,
          const Signs& sg, void* stream) {
    dim3 block(TX, TY);
    dim3 grid((nxl + TX - 1) / TX, (ny + TY - 1) / TY, L);
    jacobi_halo_kernel<SIGNED, ST><<<grid, block, 0, (cudaStream_t)stream>>>(
        e, r, aux, out, ny, nxl, omega, is_lo, is_hi, from_zero, sg);
    return (int)cudaGetLastError();
}

constexpr Signs NEUMANN{1.0f, 1.0f, 1.0f, 1.0f};

}  // namespace

extern "C" int cup2d_jacobi_halo_sweep(const float* e, const float* r,
                                       const float* aux, float* out, int L,
                                       int ny, int nxl, float omega,
                                       int is_lo, int is_hi, int from_zero,
                                       void* stream) {
    return sweep<false>(e, r, aux, out, L, ny, nxl, omega, is_lo, is_hi,
                        from_zero, NEUMANN, stream);
}

// The bf16 form: e, r, aux, out bf16.
extern "C" int cup2d_jacobi_halo_sweep_bf16(const void* e, const void* r,
                                            const void* aux, void* out,
                                            int L, int ny, int nxl,
                                            float omega, int is_lo,
                                            int is_hi, int from_zero,
                                            void* stream) {
    using storage::bf16;
    return sweep<false>(static_cast<const bf16*>(e),
                        static_cast<const bf16*>(r),
                        static_cast<const bf16*>(aux), static_cast<bf16*>(out),
                        L, ny, nxl, omega, is_lo, is_hi, from_zero, NEUMANN,
                        stream);
}

// The signed forms: es_* the table's pressure signs (bc.pressure_signs)
extern "C" int cup2d_jacobi_halo_sweep_signed(
        const float* e, const float* r, const float* aux, float* out, int L,
        int ny, int nxl, float omega, int is_lo, int is_hi, int from_zero,
        float es_x_lo, float es_x_hi, float es_y_lo, float es_y_hi,
        void* stream) {
    return sweep<true>(e, r, aux, out, L, ny, nxl, omega, is_lo, is_hi,
                       from_zero, Signs{es_x_lo, es_x_hi, es_y_lo, es_y_hi},
                       stream);
}

extern "C" int cup2d_jacobi_halo_sweep_signed_bf16(
        const void* e, const void* r, const void* aux, void* out, int L,
        int ny, int nxl, float omega, int is_lo, int is_hi, int from_zero,
        float es_x_lo, float es_x_hi, float es_y_lo, float es_y_hi,
        void* stream) {
    using storage::bf16;
    return sweep<true>(static_cast<const bf16*>(e),
                       static_cast<const bf16*>(r),
                       static_cast<const bf16*>(aux), static_cast<bf16*>(out),
                       L, ny, nxl, omega, is_lo, is_hi, from_zero,
                       Signs{es_x_lo, es_x_hi, es_y_lo, es_y_hi}, stream);
}
