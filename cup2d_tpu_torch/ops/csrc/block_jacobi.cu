// The forest's block-Jacobi preconditioner and smoother, P_inv a 64 x 64
// f32 matrix over [N, 64] f32 block stacks (BS 8), in three forms that
// stream only the operands they have (d = r, or d = r - lap):
//   P form       out[n, i] = 0 + sum_k r[n, k] * P_inv[i, k]
//   E form       out[n, i] = e[n, i] + (0 + sum_k r[n, k] * P_inv[i, k])
//   update form  out[n, i] = e[n, i] + sum_k (r - lap)[n, k] * P_inv[i, k]
// The update form is one sweep of the damped block-Jacobi smoother after
// the operator has been applied; a preconditioner's update (the two-level
// forms' tails) adds 0 to the product first, as the P form does.
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _block_jacobi_kernel (reached
// from fused_block_jacobi_update), f32; the P and E forms are its
// function with e = lap = 0 and with lap = 0 (the JAX package's
// apply_block_precond_blocks and the sums around it).
//
// Bound on this card: per block 256 bytes read for each operand and 256
// written (2 streams in the P form, 3 in the E form, 4 in the update
// form) against 64 x (2 x 64 + 2) operations, 4 to 8 per byte, under the
// H100's f32 balance point (~20 per byte): memory bounds it. At N = 16384
// the product is 134 MFLOP, ~2 us of f32 FMA peak, under the 2.5-5 us
// byte bounds.
//
// Design:
// - CUDA cores, not tensor cores: TF32 would break the f32 contract (the
//   Pallas kernel runs the MXU at full f32; the twin bar assumes f32
//   products).
// - CTAs of WARPS warps, a few per SM (the caller's grid; a CTA walks
//   more rounds where the grid is smaller). Each CTA copies P_inv once
//   into shared memory by 16-byte cp.async, row-major with each row's
//   float4 slots XOR-swizzled by its row quad, so that the product's
//   reads of four rows at one k-quad take the least wavefronts (two for
//   a warp); the copy is in flight with the first operands, where a
//   transposed copy would pass through registers first.
// - Each warp walks its own chunks of CB = 8 consecutive blocks through
//   its own ring of stages (cp.async 16 bytes at a time, each block's 64
//   values on a 68-word row, the products reading d straight from the
//   ring) with no barrier but __syncwarp: the warps of an SM drift apart,
//   so one warp's products overlap another's copies and stores, where a
//   CTA-wide tile moved the whole SM from loading to computing to
//   storing in step. The update form first overwrites r with r - lap in
//   place. A form's ring holds only its operands (the P form streams 2
//   of kernel 8's 4).
// - Register tiling: each lane owns 4 blocks x 4 rows of P_inv (16
//   outputs); one k-quad costs 4 float4 reads of d (two addresses a
//   warp) and 4 of P_inv for 64 FMAs, and the outputs leave as float4
//   stores.
// - Each output is one f32 FMA chain from 0, k in order from 0, then the
//   form's sums, in every form and in every design since the first
//   (one element a thread): no atomics, so a block's bits do not depend on
//   N, on the run or on the form that computed its product. The
//   preconditioner forms add the product to 0 first (__fadd_rn: a -0
//   product becomes +0), as kernel 8 did with a zero e: the same bits as
//   the compositions they replace.
// - f64 (cup2d_block_jacobi_f64, cup2d_block_precond_f64): the four forms
//   with P_inv, the operands, the FMA chain and the sums in f64 (the value
//   type T a template parameter; the JAX package's XLA composition at x64,
//   which its Pallas gate block_update_supported sends f64 state to). A
//   quad of four values is 32 bytes, copied and read as two 16-byte
//   halves; the swizzle and the ring keep their quad layout, so shared
//   memory doubles (P_inv 32 KB, 137 KB a CTA in the update form).

#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace {

using storage::add_rn;

constexpr int M = 64;                 // BS * BS values per block
constexpr int PITCH = M + 4;          // shared row pitch of a ring's block
constexpr int CB = 8;                 // blocks per warp chunk
constexpr int CHUNK = CB * M;         // values of one operand's chunk
constexpr int PCHUNK = CB * PITCH;    // shared values of one operand's chunk
constexpr int WARPS = 4;              // warps per CTA
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;             // chunks of a warp's ring

// P_inv (M * M values), then each warp's ring; a stage holds r, then e,
// then lap
template <int NOPS, class T>
constexpr size_t smem_bytes() {
    return sizeof(T) * (M * M + WARPS * STAGES * NOPS * PCHUNK);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
    uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// Four consecutive values (a quad): one 16-byte float4 in f32, two
// double2 halves in f64.
template <class T>
struct Quad {
    T x, y, z, w;
};

__device__ __forceinline__ void cp_quad(float* dst, const float* src) {
    cp16(dst, src);
}
__device__ __forceinline__ void cp_quad(double* dst, const double* src) {
    cp16(dst, src);
    cp16(dst + 2, src + 2);
}

__device__ __forceinline__ Quad<float> ld_quad(const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    return Quad<float>{v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ Quad<double> ld_quad(const double* p) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    return Quad<double>{a.x, a.y, b.x, b.y};
}

__device__ __forceinline__ void st_quad(float* p, float x, float y, float z,
                                        float w) {
    *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}
__device__ __forceinline__ void st_quad(double* p, double x, double y,
                                        double z, double w) {
    *reinterpret_cast<double2*>(p) = make_double2(x, y);
    *reinterpret_cast<double2*>(p + 2) = make_double2(z, w);
}

__device__ __forceinline__ float fma_op(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_op(double a, double b, double c) {
    return fma(a, b, c);
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The shared quad slot of P_inv's row i, k-quad kq: row-major, the
// k-quads of row i XOR-swizzled by (i / 4) mod 8.
__device__ __forceinline__ int p_slot(int i, int kq) {
    return i * (M / 4) + (kq ^ ((i >> 2) & 7));
}

// The shared offset of the quad q of a chunk: block q / 16 on its row.
__device__ __forceinline__ int pitched(int q) {
    return (q / (M / 4)) * PITCH + 4 * (q % (M / 4));
}

// Issue this lane's copies of chunk c's operands (the blocks that exist)
// into one stage of its warp's ring.
template <int NOPS, class T>
__device__ __forceinline__ void load_chunk(T* st, const T* r, const T* e,
                                           const T* lap, int c, int n,
                                           int lane) {
    const int nb = min(CB, n - c * CB);
    const size_t g = (size_t)c * CHUNK;
    for (int q = lane; q < nb * (M / 4); q += 32) {
        const int s = pitched(q);
        cp_quad(st + s, r + g + 4 * q);
        if (NOPS > 1) cp_quad(st + PCHUNK + s, e + g + 4 * q);
        if (NOPS > 2) cp_quad(st + 2 * PCHUNK + s, lap + g + 4 * q);
    }
}

template <class T>
__device__ __forceinline__ T lane_of(const Quad<T>& v, int c) {
    return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// NOPS 1: the P form (r); 2: the E form (r, e); 3: the update form (r, e,
// lap). PINV: the product is added to 0 first (the preconditioner forms).
// T: float or double, every operand and the arithmetic.
template <int NOPS, bool PINV, class T>
__global__ void __launch_bounds__(THREADS)
block_jacobi_kernel(const T* __restrict__ p_inv, const T* __restrict__ e,
                    const T* __restrict__ r, const T* __restrict__ lap,
                    T* __restrict__ out, int n) {
    constexpr int S = STAGES;
    constexpr int STAGE = NOPS * PCHUNK;
    extern __shared__ float4 smem4[];
    T* pm = reinterpret_cast<T*>(smem4);          // P_inv, swizzled quads
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    T* ring = pm + M * M + w * S * STAGE;
    const int chunks = (n + CB - 1) / CB;
    const int gw = blockIdx.x * WARPS + w, nw = gridDim.x * WARPS;
    // P_inv first (the oldest copy group), then this warp's first S - 1
    // chunks (a group each)
    for (int q = threadIdx.x; q < M * M / 4; q += THREADS)
        cp_quad(pm + 4 * p_slot(q / (M / 4), q % (M / 4)), p_inv + 4 * q);
    cp_commit();
#pragma unroll
    for (int u = 0; u < S - 1; ++u) {
        if (gw + u * nw < chunks)
            load_chunk<NOPS>(ring + u * STAGE, r, e, lap, gw + u * nw, n,
                             lane);
        cp_commit();
    }
    cp_wait<S - 1>();
    __syncthreads();                              // P_inv has landed
    const int i0 = 4 * (lane % 16);               // rows i0 .. i0 + 3
    const int b0 = 4 * (lane / 16);               // blocks b0 .. b0 + 3
    const int sw = (lane % 16) & 7;               // their swizzle
    for (int c = gw, it = 0; c < chunks; c += nw, ++it) {
        T* st = ring + (it % S) * STAGE;
        if (c + (S - 1) * nw < chunks)
            load_chunk<NOPS>(ring + ((it + S - 1) % S) * STAGE, r, e, lap,
                             c + (S - 1) * nw, n, lane);
        cp_commit();
        cp_wait<S - 1>();
        __syncwarp();
        if constexpr (NOPS == 3) {
            // d = r - lap, in place of r
            for (int q = lane; q < CHUNK / 4; q += 32) {
                T* a = st + pitched(q);
                const Quad<T> l = ld_quad(st + 2 * PCHUNK + pitched(q));
                const Quad<T> v = ld_quad(a);
                st_quad(a, v.x - l.x, v.y - l.y, v.z - l.z, v.w - l.w);
            }
            __syncwarp();
        }
        const T* d = st;                          // d[b * PITCH + k]
        T z[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) z[j][ii] = (T)0.0;
#pragma unroll
        for (int kq = 0; kq < M / 4; ++kq) {
            Quad<T> dv[4], pv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                dv[j] = ld_quad(d + (b0 + j) * PITCH + 4 * kq);
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)         // P_inv[i0 + ii][4 kq ..]
                pv[ii] = ld_quad(pm + 4 * ((i0 + ii) * (M / 4) + (kq ^ sw)));
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int ii = 0; ii < 4; ++ii)
                        z[j][ii] = fma_op(lane_of(dv[j], cc),
                                          lane_of(pv[ii], cc), z[j][ii]);
        }
        const size_t g = (size_t)c * CHUNK;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (c * CB + b0 + j < n) {
                T v[4];
#pragma unroll
                for (int ii = 0; ii < 4; ++ii)
                    v[ii] = PINV ? add_rn((T)0.0, z[j][ii]) : z[j][ii];
                if constexpr (NOPS > 1) {
                    const Quad<T> ev = ld_quad(st + PCHUNK + (b0 + j) * PITCH
                                               + i0);
                    v[0] = ev.x + v[0];
                    v[1] = ev.y + v[1];
                    v[2] = ev.z + v[2];
                    v[3] = ev.w + v[3];
                }
                st_quad(out + g + (b0 + j) * M + i0, v[0], v[1], v[2], v[3]);
            }
        }
        __syncwarp();      // this stage is refilled by a later iteration
    }
    cp_wait<0>();
}

template <int NOPS, bool PINV, class T>
int launch(const T* p_inv, const T* e, const T* r, const T* lap, T* out,
           int n, int grid, void* stream) {
    if (n <= 0) return 0;
    const int rounds = (n + CB * WARPS - 1) / (CB * WARPS);
    if (grid < 1 || grid > rounds) return (int)cudaErrorInvalidValue;
    constexpr size_t SMEM = smem_bytes<NOPS, T>();
    // above 48 KB of shared memory once per device (a bit per ordinal)
    static unsigned long long opted_in = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (!(dev < 64 && (opted_in >> dev & 1))) {
        err = cudaFuncSetAttribute(
            block_jacobi_kernel<NOPS, PINV, T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) opted_in |= 1ull << dev;
    }
    block_jacobi_kernel<NOPS, PINV, T>
        <<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(p_inv, e, r, lap,
                                                        out, n);
    return (int)cudaGetLastError();
}

template <class T>
int precond(const T* p_inv, const T* e, const T* r, const T* lap, T* out,
            int n, int grid, void* stream) {
    if (e == nullptr)
        return lap == nullptr
            ? launch<1, true>(p_inv, e, r, lap, out, n, grid, stream)
            : (int)cudaErrorInvalidValue;
    if (lap == nullptr)
        return launch<2, true>(p_inv, e, r, lap, out, n, grid, stream);
    return launch<3, true>(p_inv, e, r, lap, out, n, grid, stream);
}

}  // namespace

// The update form. grid: persistent CTAs, 1 .. the number of 32-block
// rounds (a chunk of 8 blocks for each warp of a CTA).
extern "C" int cup2d_block_jacobi(const float* p_inv, const float* e,
                                  const float* r, const float* lap,
                                  float* out, int n, int grid,
                                  void* stream) {
    return launch<3, false>(p_inv, e, r, lap, out, n, grid, stream);
}

// The preconditioner forms: the P form where e is null (lap null too),
// the E form where lap alone is null, else the update form adding its
// product to 0 first. grid as above.
extern "C" int cup2d_block_precond(const float* p_inv, const float* e,
                                   const float* r, const float* lap,
                                   float* out, int n, int grid,
                                   void* stream) {
    return precond(p_inv, e, r, lap, out, n, grid, stream);
}

// The f64 forms: P_inv and every operand f64 (16-byte aligned); grid as
// above.
extern "C" int cup2d_block_jacobi_f64(const double* p_inv, const double* e,
                                      const double* r, const double* lap,
                                      double* out, int n, int grid,
                                      void* stream) {
    return launch<3, false>(p_inv, e, r, lap, out, n, grid, stream);
}

extern "C" int cup2d_block_precond_f64(const double* p_inv, const double* e,
                                       const double* r, const double* lap,
                                       double* out, int n, int grid,
                                       void* stream) {
    return precond(p_inv, e, r, lap, out, n, grid, stream);
}
