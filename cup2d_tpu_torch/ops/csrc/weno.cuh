// WENO5 advection plus diffusion, shared by the kernels that walk a field
// (substage.cuh: the two substages and advect_rhs.cu, the single-op RHS)
// and lab_rhs.cu (the forest lab RHS), so that the arithmetic is one
// definition: the bit-trick reciprocal 0x7EF311C3 of the weight
// normalizer, the den > 1e-35 guard with its correctly rounded
// reciprocal, the operand order of each face and the expression order of
// ops/stencil.py term for term.
// The arithmetic type R is a template parameter: float for the f32 and
// bf16 forms, double for the f64 forms, which compute what ops/stencil.py
// computes at f64: the epsilon the double 1e-6, the normalizer's
// reciprocal an IEEE divide (the bit trick is f32 only), the guarded
// reciprocal __drcp_rn, the fused multiply-adds __fma_rn.
// Built without --use_fast_math: IEEE divides and denormals are kept.

#pragma once

#include "storage.cuh"

namespace cup2d {

template <class R>
__device__ __forceinline__ R sq(R x) { return x * x; }

// The reconstruction weno5_plus of ops/stencil.py in its two halves: the
// weights' numerators, their normalizer and the candidate stencils
// (Weno5Part, all arithmetic), then the guarded reciprocal and the blend.
// A kernel that reconstructs several faces at once computes every part
// before any blend, so that the compiler can interleave the faces'
// arithmetic: the correctly rounded reciprocal branches to a slow path,
// and code does not move across it.
template <class R>
struct Weno5PartT {
    R n1, n2, n3, den, f1, f2, f3;
};

using Weno5Part = Weno5PartT<float>;

template <class R>
__device__ __forceinline__ Weno5PartT<R> weno5_part(R um2, R um1, R u,
                                                    R up1, R up2) {
    using storage::lit;
    const R c1312 = (R)(13.0 / 12.0);
    const R eps = lit<R>(1e-6f, 1e-6);
    R b1 = c1312 * sq((um2 + u) - (R)2.0 * um1)
         + (R)0.25 * sq((um2 + (R)3.0 * u) - (R)4.0 * um1);
    R b2 = c1312 * sq((um1 + up1) - (R)2.0 * u) + (R)0.25 * sq(um1 - up1);
    R b3 = c1312 * sq((u + up2) - (R)2.0 * up1)
         + (R)0.25 * sq(((R)3.0 * u + up2) - (R)4.0 * up1);
    // max-normalized weights, bit-trick reciprocal of the normalizer (f32;
    // f64 divides)
    R bmax = storage::vmax(storage::vmax(b1, b2), b3) + eps;
    R m;
    if constexpr (sizeof(R) == sizeof(float))
        m = __int_as_float(0x7EF311C3 - __float_as_int(bmax));
    else
        m = (R)1.0 / bmax;
    R r1 = (b1 + eps) * m;
    R r2 = (b2 + eps) * m;
    R r3 = (b3 + eps) * m;
    R s1 = r1 * r1, s2 = r2 * r2, s3 = r3 * r3;
    Weno5PartT<R> p;
    p.n1 = lit<R>(0.1f, 0.1) * (s2 * s3);
    p.n2 = lit<R>(0.6f, 0.6) * (s1 * s3);
    p.n3 = lit<R>(0.3f, 0.3) * (s1 * s2);
    p.den = (p.n1 + p.n3) + p.n2;
    p.f1 = (R)(11.0 / 6.0) * u
         + ((R)(1.0 / 3.0) * um2 - (R)(7.0 / 6.0) * um1);
    p.f2 = (R)(5.0 / 6.0) * u
         + ((R)(-1.0 / 6.0) * um1 + (R)(1.0 / 3.0) * up1);
    p.f3 = (R)(1.0 / 3.0) * u
         + ((R)(5.0 / 6.0) * up1 - (R)(1.0 / 6.0) * up2);
    return p;
}

__device__ __forceinline__ float rcp_rn(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp_rn(double x) { return __drcp_rn(x); }

template <class R>
__device__ __forceinline__ R weno5_blend(const Weno5PartT<R>& p) {
    using storage::lit;
    bool ok = p.den > lit<R>(1e-35f, 1e-35);
    R aux = rcp_rn(ok ? p.den : (R)1.0);
    R w1 = ok ? p.n1 * aux : lit<R>(0.1f, 0.1);
    R w2 = ok ? p.n2 * aux : lit<R>(0.6f, 0.6);
    R w3 = ok ? p.n3 * aux : lit<R>(0.3f, 0.3);
    return (w1 * p.f1 + w3 * p.f3) + w2 * p.f2;
}

// The reconstruction at the face between a cell and its next neighbour
// along one direction with wind sign pos, from the six values m2 .. p3 at
// offsets -2 .. 3 from the cell: operand for operand the right face t1 of
// the cell in ops/stencil.py (pos) or its mirror (the identity
// weno5_minus(a,b,c,d,e) == weno5_plus(e,d,c,b,a)). The left face t2 of
// the cell is the same call on the values at offsets -3 .. 2: two cells of
// the same wind sign reconstruct their shared face from the same five
// operands.
template <class R>
__device__ __forceinline__ Weno5PartT<R> weno_face_part(bool pos, R m2, R m1,
                                                        R c, R p1, R p2,
                                                        R p3) {
    return weno5_part<R>(pos ? m2 : p3, pos ? m1 : p2, pos ? c : p1,
                         pos ? p1 : c, pos ? p2 : m1);
}

template <class R>
__device__ __forceinline__ R weno_face(bool pos, R m2, R m1, R c, R p1,
                                       R p2, R p3) {
    return weno5_blend(weno_face_part<R>(pos, m2, m1, c, p1, p2, p3));
}

// rhs = afac * (wu dq/dx + wv dq/dy) + dfac * lap(q) at a cell of value c
// with neighbours xm, xp (x) and ym, yp (y), given its two derivatives.
// The three fused multiply-adds are written out: which product the
// compiler fuses otherwise depends on the code around the call, and every
// kernel that includes this must round alike (the substage's per-cell and
// face-sharing designs give the same bits).
template <class R>
__device__ __forceinline__ R advect_diffuse_rhs(R c, R xm, R xp, R ym, R yp,
                                                R wu, R wv, R dx, R dy,
                                                R afac, R dfac) {
    R lap = storage::fma_rn((R)-4.0, c, ((xp + xm) + yp) + ym);
    return storage::fma_rn(dfac, lap,
                           afac * storage::fma_rn(wu, dx, wv * dy));
}

}  // namespace cup2d
