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
// balance point (~20 per byte): memory bounds it. At N = 16384 the product
// is 134 MFLOP, ~2 us of f32 FMA peak, under the ~5 us byte bound.
//
// Design:
// - CUDA cores, not tensor cores: the product is below the byte bound
//   already, and TF32 would break the f32 contract (the Pallas kernel
//   runs the MXU at full f32; the twin bar assumes f32 products).
// - Persistent CTAs, two per SM (the caller sizes the grid; at N = 16384
//   each walks two tiles, so one tile's copies overlap the other's
//   products): each stages P_inv once, transposed (pt[k][i], row pitch 68
//   words: 16-byte rows for the float4 reads, at most 4-way conflicts in
//   the one-off staging), while its first tile is in flight, then walks
//   tiles of TB = 32 consecutive blocks.
// - A tile of e, r and lap is one contiguous 8 KB span each,
//   brought in by 16-byte cp.async into a two-stage ring: the next tile's
//   copies are in flight during this tile's products.
// - Register tiling: each thread owns 4 blocks x 4 rows of P_inv (16
//   outputs); one k-quad costs 4 float4 reads of d and 4 of pt for 64
//   FMAs, and the outputs leave as float4 stores.
// - Each output is one f32 FMA chain, k in order from 0, then e + z, as
//   in the first, one-element-per-thread design: no atomics, so the
//   result is the same bit for bit from run to run and between designs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int M = 64;                 // BS * BS values per block
constexpr int PITCH = M + 4;          // shared row pitch of P_inv and d

constexpr int TB = 32;                // blocks per tile
constexpr int TILE = TB * M;          // floats of one operand's tile
constexpr int THREADS = 16 * (TB / 4);  // a thread per 4 rows x 4 blocks
constexpr int RING = 2 * 3 * TILE;    // two stages of e, r and lap
constexpr size_t SMEM = sizeof(float) * (M * PITCH + RING + TB * PITCH);

__device__ __forceinline__ void cp16(float* dst, const float* src) {
    uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Issue the copies of tile t's e, r and lap (the blocks that exist) into
// one stage of the ring.
__device__ __forceinline__ void load_tile(float* st, const float* e,
                                          const float* r, const float* lap,
                                          int t, int n) {
    const int nb = min(TB, n - t * TB);
    const size_t g = (size_t)t * TILE;
    for (int c = 4 * threadIdx.x; c < nb * M; c += 4 * THREADS) {
        cp16(st + c, e + g + c);
        cp16(st + TILE + c, r + g + c);
        cp16(st + 2 * TILE + c, lap + g + c);
    }
}

__device__ __forceinline__ float lane(const float4& v, int c) {
    return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

__global__ void __launch_bounds__(THREADS)
block_jacobi_kernel(const float* __restrict__ p_inv,
                    const float* __restrict__ e, const float* __restrict__ r,
                    const float* __restrict__ lap, float* __restrict__ out,
                    int n) {
    extern __shared__ float4 smem4[];
    float* pt = reinterpret_cast<float*>(smem4);  // pt[k * PITCH + i]
    float* ring = pt + M * PITCH;
    float* d = ring + RING;                    // d[b * PITCH + k]
    const int tiles = (n + TB - 1) / TB;
    int t = blockIdx.x;
    load_tile(ring, e, r, lap, t, n);
    cp_commit();
    // P_inv staged transposed while the first tile is in flight: all of a
    // thread's loads first, then its stores
    constexpr int PQ = M * M / 4 / THREADS;    // float4 per thread
    float4 pv0[PQ];
#pragma unroll
    for (int u = 0; u < PQ; ++u)
        pv0[u] = reinterpret_cast<const float4*>(p_inv)[threadIdx.x
                                                        + u * THREADS];
#pragma unroll
    for (int u = 0; u < PQ; ++u) {
        const int q = threadIdx.x + u * THREADS;
        const int i = q / (M / 4), k = 4 * (q % (M / 4));
        pt[k * PITCH + i] = pv0[u].x;
        pt[(k + 1) * PITCH + i] = pv0[u].y;
        pt[(k + 2) * PITCH + i] = pv0[u].z;
        pt[(k + 3) * PITCH + i] = pv0[u].w;
    }
    const int i0 = 4 * (threadIdx.x % 16);        // rows i0 .. i0 + 3
    const int b0 = 4 * (threadIdx.x / 16);        // blocks b0 .. b0 + 3
    for (int s = 0; t < tiles; t += gridDim.x, s ^= 1) {
        const float* st = ring + s * 3 * TILE;
        if (t + (int)gridDim.x < tiles)
            load_tile(ring + (s ^ 1) * 3 * TILE, e, r, lap,
                         t + gridDim.x, n);
        cp_commit();
        cp_wait<1>();
        __syncthreads();
        for (int q = threadIdx.x; q < TILE / 4; q += THREADS) {
            const float4 a =
                reinterpret_cast<const float4*>(st + TILE)[q];
            const float4 c =
                reinterpret_cast<const float4*>(st + 2 * TILE)[q];
            const float4 v = make_float4(a.x - c.x, a.y - c.y, a.z - c.z,
                                         a.w - c.w);
            const int b = q / (M / 4), k = 4 * (q % (M / 4));
            *reinterpret_cast<float4*>(d + b * PITCH + k) = v;
        }
        __syncthreads();
        float z[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) z[j][c] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < M; k += 4) {
            float4 dv[4], pv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                dv[j] = *reinterpret_cast<const float4*>(
                    d + (b0 + j) * PITCH + k);
#pragma unroll
            for (int c = 0; c < 4; ++c)
                pv[c] = *reinterpret_cast<const float4*>(
                    pt + (k + c) * PITCH + i0);
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int ii = 0; ii < 4; ++ii)
                        z[j][ii] = fmaf(lane(dv[j], c), lane(pv[c], ii),
                                        z[j][ii]);
        }
        const size_t g = (size_t)t * TILE;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (t * TB + b0 + j < n) {
                const int o = (b0 + j) * M + i0;
                const float4 ev = *reinterpret_cast<const float4*>(st + o);
                *reinterpret_cast<float4*>(out + g + o) = make_float4(
                    ev.x + z[j][0], ev.y + z[j][1], ev.z + z[j][2],
                    ev.w + z[j][3]);
            }
        }
        __syncthreads();   // this stage is refilled by the next iteration
    }
    cp_wait<0>();
}

}  // namespace

// grid: persistent CTAs, 1 .. the number of 32-block tiles.
extern "C" int cup2d_block_jacobi(const float* p_inv, const float* e,
                                  const float* r, const float* lap,
                                  float* out, int n, int grid,
                                  void* stream) {
    if (n <= 0) return 0;
    const int tiles = (n + TB - 1) / TB;
    if (grid < 1 || grid > tiles) return (int)cudaErrorInvalidValue;
    // above 48 KB of shared memory once per device (a bit per ordinal)
    static unsigned long long opted_in = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (!(dev < 64 && (opted_in >> dev & 1))) {
        err = cudaFuncSetAttribute(
            block_jacobi_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) opted_in |= 1ull << dev;
    }
    block_jacobi_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
        p_inv, e, r, lap, out, n);
    return (int)cudaGetLastError();
}
