// Storage types of the kernels' operands: f32, or bf16 (the CUP2D_PREC=bf16
// tier). Arithmetic is f32 in either case; a bf16 operand is widened where
// it is read and an f32 result rounded to nearest even where it is stored
// (__float2bfloat16_rn, as torch's .to(torch.bfloat16) and JAX's astype
// round). For float both are the identity, so an f32 instance compiles to
// the code it had before the storage type became a template parameter.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace storage {
namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T narrow(float x);

template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }

template <>
__device__ __forceinline__ bf16 narrow<bf16>(float x) {
    return __float2bfloat16_rn(x);
}

template <class T>
constexpr bool is_f32 = sizeof(T) == sizeof(float);

// An 8-byte cp.async (four bf16 values), zero-filled where !in.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool in = true) {
    uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    int n = in ? 8 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}

}  // namespace
}  // namespace storage
