// The forest's full reductions, one fixed order whatever the device
// layout: per row of x [R, m] (a group of 16 ordered blocks, m its
// values), the sum
//   out[g] = sum_j x[g, j]                 (sum form)
//   out[g] = sum_j (a[g, j] * c[g, j])     (dot form)
// by one fixed pairwise tree, each product rounded in the operands' type
// before it is widened to the accumulator's. The caller then adds the
// [R] partials with one torch.sum on its home device, so the solo forest
// and every split of it add the same terms in the same order.
//
// Replaces: no TPU kernel. The JAX package leaves these sums to XLA
// (jnp.sum and jnp.vdot in cup2d_tpu/amr.py and cup2d_tpu/poisson.py,
// partitioned by GSPMD on a mesh); PyTorch's own reductions pick their
// order from the tensor's size and the thread count, so a shard's
// partial would not repeat the solo run's bits.
//
// Bound on this card: memory. Each value is read once (4 or 8 bytes, two
// operands for a dot) for one add (and one multiply); the [R] partials
// written are 1/m of that.
//
// Design: one CTA per row, so a row's bits do not depend on how many
// rows a launch holds. The tree: while m > 1, h = ceil(m / 2), and
// x[j] += x[j + h] for j < m - h (x[h - 1] stays as it is where m is
// odd); its first level reads device memory (coalesced), the rest run in
// shared memory, one __syncthreads a level. Adds and products are
// written out (__fadd_rn, __dadd_rn, __fmul_rn, __dmul_rn): no FMA
// contraction, so the plain twin (the same tree as elementwise torch ops
// on the [R, m] view) gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float add_rn(float x, float y) {
    return __fadd_rn(x, y);
}
__device__ __forceinline__ double add_rn(double x, double y) {
    return __dadd_rn(x, y);
}
__device__ __forceinline__ float mul_rn(float x, float y) {
    return __fmul_rn(x, y);
}
__device__ __forceinline__ double mul_rn(double x, double y) {
    return __dmul_rn(x, y);
}

template <typename In, typename Acc, bool DOT>
__device__ __forceinline__ Acc term(const In* __restrict__ a,
                                    const In* __restrict__ c, size_t i) {
    if (DOT) return static_cast<Acc>(mul_rn(a[i], c[i]));
    return static_cast<Acc>(a[i]);
}

template <typename In, typename Acc, bool DOT>
__global__ void __launch_bounds__(MAX_THREADS)
group_sum_kernel(const In* __restrict__ a, const In* __restrict__ c,
                 Acc* __restrict__ out, int m) {
    extern __shared__ unsigned char smem_raw[];
    Acc* s = reinterpret_cast<Acc*>(smem_raw);
    const size_t base = (size_t)blockIdx.x * m;
    int h = (m + 1) / 2;
    for (int j = threadIdx.x; j < h; j += blockDim.x) {
        Acc v = term<In, Acc, DOT>(a, c, base + j);
        if (j + h < m) v = add_rn(v, term<In, Acc, DOT>(a, c, base + j + h));
        s[j] = v;
    }
    __syncthreads();
    for (int n = h; n > 1; n = h) {
        h = (n + 1) / 2;
        // reads [h, n), writes [0, n - h): disjoint within a level
        for (int j = threadIdx.x; j < n - h; j += blockDim.x)
            s[j] = add_rn(s[j], s[j + h]);
        __syncthreads();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

template <typename In, typename Acc>
int launch(const void* a, const void* c, void* out, int rows, int m,
           cudaStream_t stream) {
    const int h = (m + 1) / 2;
    int threads = 32;
    while (threads < h && threads < MAX_THREADS) threads *= 2;
    const size_t smem = sizeof(Acc) * (size_t)h;
    if (c == nullptr)
        group_sum_kernel<In, Acc, false><<<rows, threads, smem, stream>>>(
            static_cast<const In*>(a), nullptr, static_cast<Acc*>(out), m);
    else
        group_sum_kernel<In, Acc, true><<<rows, threads, smem, stream>>>(
            static_cast<const In*>(a), static_cast<const In*>(c),
            static_cast<Acc*>(out), m);
    return (int)cudaGetLastError();
}

}  // namespace

// a (and c for the dot form; null for the sum form): [rows, m] contiguous,
// f32 (in_f64 = 0) or f64; out: [rows], f32 (acc_f64 = 0) or f64. An f64
// operand takes an f64 accumulator. m is at most 8192 (the tree's first
// level, ceil(m / 2) accumulators, lives in 48 KB of shared memory).
extern "C" int cup2d_group_sum(const void* a, const void* c, void* out,
                               int rows, int m, int in_f64, int acc_f64,
                               void* stream) {
    if (rows <= 0) return 0;
    if (m < 1 || m > 8192 || (in_f64 && !acc_f64))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (in_f64) return launch<double, double>(a, c, out, rows, m, st);
    if (acc_f64) return launch<float, double>(a, c, out, rows, m, st);
    return launch<float, float>(a, c, out, rows, m, st);
}
