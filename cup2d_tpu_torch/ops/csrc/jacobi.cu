// n damped-Jacobi sweeps (1 <= n <= 6) of the undivided zero-ghost 5-point
// Laplacian with the Neumann wall diagonal, in one pass:
//   e <- e + omega * (r - lap(e)) / d,   d = (ey + ex) - 4
// ey/ex are 1 on the wall rows/columns, else 0. from_zero makes the first
// sweep e = omega * r / d and ignores e (which may then be null).
// e, r, out [L, ny, nx] f32.
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _jacobi_strips_kernel (reached
// from fused_jacobi_sweeps), all-Neumann edge signs, f32 storage.
//
// Bound on this card: memory. n sweeps read e and r once and write the
// result once, 12 bytes per cell (8 from zero), for 9 operations per cell
// and sweep.
//
// Design: the TPU kernel time-skews the sweeps over row strips that run in
// sequence (sweep k trails sweep k-1 by one strip in a VMEM ring). CUDA
// blocks run in parallel, so this kernel blocks in time instead: a block
// loads its TY x TX tile of e and r plus an n-cell halo into shared memory
// and runs all n sweeps there, the valid region shrinking by one cell per
// sweep; it writes the tile's interior once. Cells outside the domain are
// zero ghosts and stay zero. The halo is recomputed by neighbouring blocks
// (1.2x at n = 2, 1.5x at n = 6). Sweep arithmetic follows
// MultigridPreconditioner._smooth term for term.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 64;
constexpr int TY = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
jacobi_kernel(const float* __restrict__ e, const float* __restrict__ r,
              float* __restrict__ out, int ny, int nx, int nsw, float omega,
              int from_zero) {
    extern __shared__ float smem[];
    const int ex_w = TX + 2 * nsw;
    const int ey_h = TY + 2 * nsw;
    const int cells = ex_w * ey_h;
    float* src = smem;
    float* dst = smem + cells;
    float* rs = smem + 2 * cells;

    const int l = blockIdx.z;
    const int oy = blockIdx.y * TY - nsw;
    const int ox = blockIdx.x * TX - nsw;
    const size_t base = (size_t)l * ny * nx;

    for (int k = threadIdx.x; k < cells; k += THREADS) {
        int j = k / ex_w, i = k - (k / ex_w) * ex_w;
        int gy = oy + j, gx = ox + i;
        bool in = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
        size_t g = base + (size_t)(in ? gy : 0) * nx + (in ? gx : 0);
        rs[k] = in ? r[g] : 0.0f;
        src[k] = (in && !from_zero) ? e[g] : 0.0f;
    }
    __syncthreads();

    for (int s = 1; s <= nsw; ++s) {
        const int ry = ey_h - 2 * s, rx = ex_w - 2 * s;
        for (int k = threadIdx.x; k < ry * rx; k += THREADS) {
            int j = s + k / rx, i = s + (k - (k / rx) * rx);
            int gy = oy + j, gx = ox + i;
            int idx = j * ex_w + i;
            if (gy < 0 || gy >= ny || gx < 0 || gx >= nx) {
                dst[idx] = 0.0f;
                continue;
            }
            float exv = gx == 0 ? 1.0f : (gx == nx - 1 ? 1.0f : 0.0f);
            float eyv = gy == 0 ? 1.0f : (gy == ny - 1 ? 1.0f : 0.0f);
            float corr = (eyv + exv) - 4.0f;
            float inv_d = 1.0f / corr;
            float rv = rs[idx];
            float nw;
            if (s == 1 && from_zero) {
                nw = omega * rv * inv_d;
            } else {
                float cur = src[idx];
                float lap = src[idx + 1] + src[idx - 1] + src[idx + ex_w]
                          + src[idx - ex_w] + cur * corr;
                nw = cur + omega * (rv - lap) * inv_d;
            }
            dst[idx] = nw;
        }
        __syncthreads();
        float* t = src; src = dst; dst = t;
    }

    for (int k = threadIdx.x; k < TY * TX; k += THREADS) {
        int j = k / TX, i = k - (k / TX) * TX;
        int gy = oy + nsw + j, gx = ox + nsw + i;
        if (gy < ny && gx < nx)
            out[base + (size_t)gy * nx + gx] = src[(j + nsw) * ex_w + i + nsw];
    }
}

}  // namespace

extern "C" int cup2d_jacobi_sweeps(const float* e, const float* r,
                                   float* out, int L, int ny, int nx,
                                   int nsw, float omega, int from_zero,
                                   void* stream) {
    if (nsw < 1 || nsw > 6) return (int)cudaErrorInvalidValue;
    size_t smem = 3 * sizeof(float) * (TX + 2 * nsw) * (TY + 2 * nsw);
    dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, L);
    jacobi_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        e, r, out, ny, nx, nsw, omega, from_zero);
    return (int)cudaGetLastError();
}
