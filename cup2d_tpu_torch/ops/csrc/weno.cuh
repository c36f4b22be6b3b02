// WENO5 advection plus diffusion, shared by the kernels that walk a field
// (substage.cuh: the two substages and advect_rhs.cu, the single-op RHS)
// and lab_rhs.cu (the forest lab RHS), so that the f32 arithmetic is one
// definition: the bit-trick reciprocal 0x7EF311C3 of the weight
// normalizer, the den > 1e-35 guard with its correctly rounded
// reciprocal, the operand order of each face and the expression order of
// ops/stencil.py term for term.
// Built without --use_fast_math: IEEE divides and denormals are kept.

#pragma once

namespace cup2d {

__device__ __forceinline__ float sq(float x) { return x * x; }

// The reconstruction weno5_plus of ops/stencil.py in its two halves: the
// weights' numerators, their normalizer and the candidate stencils
// (Weno5Part, all arithmetic), then the guarded reciprocal and the blend.
// A kernel that reconstructs several faces at once computes every part
// before any blend, so that the compiler can interleave the faces'
// arithmetic: the correctly rounded reciprocal branches to a slow path,
// and code does not move across it.
struct Weno5Part {
    float n1, n2, n3, den, f1, f2, f3;
};

__device__ __forceinline__ Weno5Part weno5_part(float um2, float um1,
                                                float u, float up1,
                                                float up2) {
    const float c1312 = (float)(13.0 / 12.0);
    float b1 = c1312 * sq((um2 + u) - 2.0f * um1)
             + 0.25f * sq((um2 + 3.0f * u) - 4.0f * um1);
    float b2 = c1312 * sq((um1 + up1) - 2.0f * u) + 0.25f * sq(um1 - up1);
    float b3 = c1312 * sq((u + up2) - 2.0f * up1)
             + 0.25f * sq((3.0f * u + up2) - 4.0f * up1);
    // max-normalized weights, bit-trick reciprocal of the normalizer
    float bmax = fmaxf(fmaxf(b1, b2), b3) + 1e-6f;
    float m = __int_as_float(0x7EF311C3 - __float_as_int(bmax));
    float r1 = (b1 + 1e-6f) * m;
    float r2 = (b2 + 1e-6f) * m;
    float r3 = (b3 + 1e-6f) * m;
    float s1 = r1 * r1, s2 = r2 * r2, s3 = r3 * r3;
    Weno5Part p;
    p.n1 = 0.1f * (s2 * s3);
    p.n2 = 0.6f * (s1 * s3);
    p.n3 = 0.3f * (s1 * s2);
    p.den = (p.n1 + p.n3) + p.n2;
    p.f1 = (float)(11.0 / 6.0) * u
         + ((float)(1.0 / 3.0) * um2 - (float)(7.0 / 6.0) * um1);
    p.f2 = (float)(5.0 / 6.0) * u
         + ((float)(-1.0 / 6.0) * um1 + (float)(1.0 / 3.0) * up1);
    p.f3 = (float)(1.0 / 3.0) * u
         + ((float)(5.0 / 6.0) * up1 - (float)(1.0 / 6.0) * up2);
    return p;
}

__device__ __forceinline__ float weno5_blend(const Weno5Part& p) {
    bool ok = p.den > 1e-35f;
    float aux = __frcp_rn(ok ? p.den : 1.0f);
    float w1 = ok ? p.n1 * aux : 0.1f;
    float w2 = ok ? p.n2 * aux : 0.6f;
    float w3 = ok ? p.n3 * aux : 0.3f;
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
__device__ __forceinline__ Weno5Part weno_face_part(bool pos, float m2,
                                                    float m1, float c,
                                                    float p1, float p2,
                                                    float p3) {
    return weno5_part(pos ? m2 : p3, pos ? m1 : p2, pos ? c : p1,
                      pos ? p1 : c, pos ? p2 : m1);
}

__device__ __forceinline__ float weno_face(bool pos, float m2, float m1,
                                           float c, float p1, float p2,
                                           float p3) {
    return weno5_blend(weno_face_part(pos, m2, m1, c, p1, p2, p3));
}

// rhs = afac * (wu dq/dx + wv dq/dy) + dfac * lap(q) at a cell of value c
// with neighbours xm, xp (x) and ym, yp (y), given its two derivatives.
// The three fused multiply-adds are written out: which product the
// compiler fuses otherwise depends on the code around the call, and every
// kernel that includes this must round alike (the substage's per-cell and
// face-sharing designs give the same bits).
__device__ __forceinline__ float advect_diffuse_rhs(float c, float xm,
                                                    float xp, float ym,
                                                    float yp, float wu,
                                                    float wv, float dx,
                                                    float dy, float afac,
                                                    float dfac) {
    float lap = __fmaf_rn(-4.0f, c, ((xp + xm) + yp) + ym);
    return __fmaf_rn(dfac, lap, afac * __fmaf_rn(wu, dx, wv * dy));
}

}  // namespace cup2d
