// Projection correction epilogue on a Neumann box:
//   pres = ((x - mx) + pold) - mp
//   vel += pfac * grad(pres) * ih2
// with the gradient as zero-ghost central differences plus the rank-1 wall
// term (-1 at the low wall, +1 at the high wall: the one-sided Neumann
// difference). x, pold, pres [L, ny, nx] f32; vel, vout [L, 2, ny, nx] f32;
// scal [L, 3] f32 holds (mx, mp, pfac) per member, the means taken outside.
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _correct_kernel (reached from
// fused_correction): the all-Neumann signs gs = (1, 1, 1, 1)
// (cup2d_fused_correction) and a boundary table's per-face pressure signs
// (cup2d_fused_correction_signed: the wall terms -s_lo and +s_hi, s = -1
// at a Dirichlet outflow face; the table's means come in as 0 where it
// has one). The wrap form (cup2d_fused_correction_wrap) computes the JAX
// package's XLA epilogue of a periodic table (poisson.project_correct's
// periodic= branch, which the Pallas kernel never takes): along a periodic
// axis the neighbour is read at the wrapped index and the sign there is 0,
// so the wall term vanishes.
//
// Bound on this card: memory. It reads x, pold and vel and writes pres and
// vel, 28 bytes per cell, for about 15 operations per cell.
//
// Design: the TPU kernel walks row strips in sequence and keeps the
// neighbour strips in a VMEM ring. Here every thread owns one cell and
// forms the mean-free pressure at the cell and its four neighbours from x
// and pold directly; the neighbour reads of a warp hit the same cache
// lines as the centre reads of the adjacent warps, so device memory sees
// each input about once. The velocity update rounds its multiply and add
// apart (__fmul_rn, __fadd_rn), as the plain epilogue's separate tensor
// operations do: a contracted FMA would differ from it by an ulp, which the
// next step's Poisson solve amplifies (the x-split step keeps the plain
// epilogue, and is held to this kernel's solo step).
// f64 (cup2d_fused_correction_f64, _signed_f64, _wrap_f64): the three forms
// with every operand and all arithmetic in f64 (T a template parameter of
// the kernel; the JAX package's XLA epilogue at x64, which its Pallas gate
// sends f64 state to), 48 bytes a cell.

#include <cuda_runtime.h>

#include "storage.cuh"

namespace {

using storage::add_rn;
using storage::mul_rn;

// per-face pressure-ghost signs (x_lo, x_hi, y_lo, y_hi)
struct Signs {
    float x_lo, x_hi, y_lo, y_hi;
};

// WRAP: wrap bit 0 wraps x, bit 1 wraps y (a neighbour one cell past the
// edge)
template <bool WRAP, class T>
__device__ __forceinline__ T mean_free(const T* __restrict__ x,
                                       const T* __restrict__ pold, int j,
                                       int i, int ny, int nx, T mx, T mp,
                                       int wrap) {
    if constexpr (WRAP) {
        if (wrap & 1) i = i < 0 ? i + nx : (i >= nx ? i - nx : i);
        if (wrap & 2) j = j < 0 ? j + ny : (j >= ny ? j - ny : j);
    }
    if (j < 0 || j >= ny || i < 0 || i >= nx) return (T)0.0;
    size_t k = (size_t)j * nx + i;
    return ((x[k] - mx) + pold[k]) - mp;
}

// SIGNED: the wall terms from gs; else the Neumann constants. WRAP: wrap
// holds the periodic axes (mean_free), their signs 0.
template <bool SIGNED, bool WRAP = false, class T = float>
__global__ void correction_kernel(const T* __restrict__ x,
                                  const T* __restrict__ pold,
                                  const T* __restrict__ vel,
                                  const T* __restrict__ scal,
                                  T* __restrict__ pres,
                                  T* __restrict__ vout, int ny, int nx,
                                  T ih2, Signs gs, int wrap) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    const int l = blockIdx.z;
    if (i >= nx || j >= ny) return;
    const size_t plane = (size_t)ny * nx;
    const T* xl = x + (size_t)l * plane;
    const T* pl = pold + (size_t)l * plane;
    const T mx = scal[3 * l];
    const T mp = scal[3 * l + 1];
    const T pfac = scal[3 * l + 2];

    const T cur = mean_free<WRAP>(xl, pl, j, i, ny, nx, mx, mp, wrap);
    T gx, gy;
    if constexpr (SIGNED) {
        gx = (T)(i == 0 ? -gs.x_lo : (i == nx - 1 ? gs.x_hi : 0.0f));
        gy = (T)(j == 0 ? -gs.y_lo : (j == ny - 1 ? gs.y_hi : 0.0f));
    } else {
        gx = (T)(i == 0 ? -1.0f : (i == nx - 1 ? 1.0f : 0.0f));
        gy = (T)(j == 0 ? -1.0f : (j == ny - 1 ? 1.0f : 0.0f));
    }
    const T dpx =
        (mean_free<WRAP>(xl, pl, j, i + 1, ny, nx, mx, mp, wrap)
         - mean_free<WRAP>(xl, pl, j, i - 1, ny, nx, mx, mp, wrap))
        + cur * gx;
    const T dpy =
        (mean_free<WRAP>(xl, pl, j + 1, i, ny, nx, mx, mp, wrap)
         - mean_free<WRAP>(xl, pl, j - 1, i, ny, nx, mx, mp, wrap))
        + cur * gy;
    const size_t cell = (size_t)j * nx + i;
    pres[(size_t)l * plane + cell] = cur;
    const size_t u = (size_t)l * 2 * plane + cell;
    vout[u] = add_rn(vel[u], mul_rn(pfac * dpx, ih2));
    vout[u + plane] = add_rn(vel[u + plane], mul_rn(pfac * dpy, ih2));
}

template <bool SIGNED, bool WRAP = false, class T>
int launch(const T* x, const T* pold, const T* vel, const T* scal, T* pres,
           T* vout, int L, int ny, int nx, T ih2, Signs gs, cudaStream_t st,
           int wrap = 0) {
    dim3 block(64, 4);
    dim3 grid((nx + 63) / 64, (ny + 3) / 4, L);
    correction_kernel<SIGNED, WRAP, T><<<grid, block, 0, st>>>(
        x, pold, vel, scal, pres, vout, ny, nx, ih2, gs, wrap);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cup2d_fused_correction(const float* x, const float* pold,
                                      const float* vel, const float* scal,
                                      float* pres, float* vout, int L,
                                      int ny, int nx, float ih2,
                                      void* stream) {
    return launch<false>(x, pold, vel, scal, pres, vout, L, ny, nx, ih2,
                         Signs{1.0f, 1.0f, 1.0f, 1.0f},
                         (cudaStream_t)stream);
}

// gs_*: the table's pressure signs (bc.pressure_signs)
extern "C" int cup2d_fused_correction_signed(
        const float* x, const float* pold, const float* vel,
        const float* scal, float* pres, float* vout, int L, int ny, int nx,
        float ih2, float gs_x_lo, float gs_x_hi, float gs_y_lo,
        float gs_y_hi, void* stream) {
    return launch<true>(x, pold, vel, scal, pres, vout, L, ny, nx, ih2,
                        Signs{gs_x_lo, gs_x_hi, gs_y_lo, gs_y_hi},
                        (cudaStream_t)stream);
}

// The wrap form: the table's signs, whose (0, 0) pairs are its periodic
// axes, at least one.
extern "C" int cup2d_fused_correction_wrap(
        const float* x, const float* pold, const float* vel,
        const float* scal, float* pres, float* vout, int L, int ny, int nx,
        float ih2, float gs_x_lo, float gs_x_hi, float gs_y_lo,
        float gs_y_hi, void* stream) {
    const int wrap = (gs_x_lo == 0.0f && gs_x_hi == 0.0f ? 1 : 0)
                     | (gs_y_lo == 0.0f && gs_y_hi == 0.0f ? 2 : 0);
    if (wrap == 0) return (int)cudaErrorInvalidValue;
    return launch<true, true>(x, pold, vel, scal, pres, vout, L, ny, nx, ih2,
                              Signs{gs_x_lo, gs_x_hi, gs_y_lo, gs_y_hi},
                              (cudaStream_t)stream, wrap);
}

// The f64 forms: every operand f64, ih2 f64; the signs as above.
extern "C" int cup2d_fused_correction_f64(const double* x, const double* pold,
                                          const double* vel,
                                          const double* scal, double* pres,
                                          double* vout, int L, int ny,
                                          int nx, double ih2, void* stream) {
    return launch<false>(x, pold, vel, scal, pres, vout, L, ny, nx, ih2,
                         Signs{1.0f, 1.0f, 1.0f, 1.0f},
                         (cudaStream_t)stream);
}

extern "C" int cup2d_fused_correction_signed_f64(
        const double* x, const double* pold, const double* vel,
        const double* scal, double* pres, double* vout, int L, int ny,
        int nx, double ih2, float gs_x_lo, float gs_x_hi, float gs_y_lo,
        float gs_y_hi, void* stream) {
    return launch<true>(x, pold, vel, scal, pres, vout, L, ny, nx, ih2,
                        Signs{gs_x_lo, gs_x_hi, gs_y_lo, gs_y_hi},
                        (cudaStream_t)stream);
}

extern "C" int cup2d_fused_correction_wrap_f64(
        const double* x, const double* pold, const double* vel,
        const double* scal, double* pres, double* vout, int L, int ny,
        int nx, double ih2, float gs_x_lo, float gs_x_hi, float gs_y_lo,
        float gs_y_hi, void* stream) {
    const int wrap = (gs_x_lo == 0.0f && gs_x_hi == 0.0f ? 1 : 0)
                     | (gs_y_lo == 0.0f && gs_y_hi == 0.0f ? 2 : 0);
    if (wrap == 0) return (int)cudaErrorInvalidValue;
    return launch<true, true>(x, pold, vel, scal, pres, vout, L, ny, nx, ih2,
                              Signs{gs_x_lo, gs_x_hi, gs_y_lo, gs_y_hi},
                              (cudaStream_t)stream, wrap);
}
