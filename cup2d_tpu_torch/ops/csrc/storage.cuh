// Storage types of the kernels' operands: f32, bf16 (the CUP2D_PREC=bf16
// tier) or f64. Arithmetic is f32 for f32 and bf16 operands, f64 for f64
// ones (compute_t). A bf16 operand is widened where it is read and an f32
// result rounded to nearest even where it is stored (__float2bfloat16_rn,
// as torch's .to(torch.bfloat16) and JAX's astype round). For float and
// double both are the identity, so an f32 instance compiles to the code it
// had before the storage type became a template parameter.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace storage {
namespace {

using bf16 = __nv_bfloat16;

// the arithmetic type of a storage type: f32, f64 for f64 storage
template <class T>
struct Compute {
    using type = float;
};

template <>
struct Compute<double> {
    using type = double;
};

template <class T>
using compute_t = typename Compute<T>::type;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double widen(double x) { return x; }

template <class T>
struct Narrow;

template <>
struct Narrow<float> {
    static __device__ __forceinline__ float of(float x) { return x; }
};

template <>
struct Narrow<bf16> {
    static __device__ __forceinline__ bf16 of(float x) {
        return __float2bfloat16_rn(x);
    }
};

template <>
struct Narrow<double> {
    static __device__ __forceinline__ double of(double x) { return x; }
};

// a result of T's arithmetic type stored as T
template <class T>
__device__ __forceinline__ T narrow(compute_t<T> x) {
    return Narrow<T>::of(x);
}

template <class T>
constexpr bool is_f32 = sizeof(T) == sizeof(float);
template <class T>
constexpr bool is_f64 = sizeof(T) == sizeof(double);
template <class T>
constexpr bool is_bf16 = sizeof(T) == 2;

// An 8-byte cp.async (four bf16 values, one f64), zero-filled where !in.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool in = true) {
    uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    int n = in ? 8 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}

// A 16-byte cp.async (two f64 values), zero-filled where !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in = true) {
    uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    int n = in ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}

// Correctly rounded operations of either arithmetic type, none contracted
// into a fused multiply-add: the f64 forms of the plain expressions that
// the f32 kernels round with __fmul_rn, __fadd_rn and their kin.
__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
    return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
    return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
    return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
    return __ddiv_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
    return __fma_rn(a, b, c);
}
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) {
    return fmin(a, b);
}
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) {
    return fmax(a, b);
}

// A decimal constant of either arithmetic type, each written as its own
// literal (1e-6f for f32, 1e-6 for f64): no double rounding through the
// other type.
template <class R>
__device__ __forceinline__ constexpr R lit(float f, double d) {
    if constexpr (sizeof(R) == sizeof(float))
        return f;
    else
        return d;
}

}  // namespace
}  // namespace storage
