// Per-cell WENO5 advection plus diffusion, shared by advect_heun.cu (the
// uniform substage) and lab_rhs.cu (the forest lab RHS), so that the f32
// arithmetic is one definition: the bit-trick reciprocal 0x7EF311C3 of
// the weight normalizer, the den > 1e-35 guard with its correctly rounded
// reciprocal, and the expression order of ops/stencil.py term for term.
// Built without --use_fast_math: IEEE divides and denormals are kept.

#pragma once

namespace cup2d {

__device__ __forceinline__ float sq(float x) { return x * x; }

__device__ __forceinline__ float weno5_plus(float um2, float um1, float u,
                                            float up1, float up2) {
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
    float n1 = 0.1f * (s2 * s3);
    float n2 = 0.6f * (s1 * s3);
    float n3 = 0.3f * (s1 * s2);
    float den = (n1 + n3) + n2;
    bool ok = den > 1e-35f;
    float aux = __frcp_rn(ok ? den : 1.0f);
    float w1 = ok ? n1 * aux : 0.1f;
    float w2 = ok ? n2 * aux : 0.6f;
    float w3 = ok ? n3 * aux : 0.3f;
    float f1 = (float)(11.0 / 6.0) * u
             + ((float)(1.0 / 3.0) * um2 - (float)(7.0 / 6.0) * um1);
    float f2 = (float)(5.0 / 6.0) * u
             + ((float)(-1.0 / 6.0) * um1 + (float)(1.0 / 3.0) * up1);
    float f3 = (float)(1.0 / 3.0) * u
             + ((float)(5.0 / 6.0) * up1 - (float)(1.0 / 6.0) * up2);
    return (w1 * f1 + w3 * f3) + w2 * f2;
}

// the mirror identity: weno5_minus(a,b,c,d,e) == weno5_plus(e,d,c,b,a),
// so the stencil is selected by wind sign (strict: wind == 0 -> minus)
__device__ __forceinline__ float weno_derivative(float wind, float um3,
                                                 float um2, float um1,
                                                 float u, float up1,
                                                 float up2, float up3) {
    bool pos = wind > 0.0f;
    float t1 = weno5_plus(pos ? um2 : up3, pos ? um1 : up2, pos ? u : up1,
                          pos ? up1 : u, pos ? up2 : um1);
    float t2 = weno5_plus(pos ? um3 : up2, pos ? um2 : up1, pos ? um1 : u,
                          pos ? u : um1, pos ? up1 : um2);
    return t1 - t2;
}

// rhs = afac * (wu dq/dx + wv dq/dy) + dfac * lap(q) at the cell q points
// to, in a lab with row stride ``ys`` and at least 3 ghost cells around it
__device__ __forceinline__ float advect_diffuse_cell(const float* q, int ys,
                                                     float wu, float wv,
                                                     float afac,
                                                     float dfac) {
    float dx = weno_derivative(wu, q[-3], q[-2], q[-1], q[0], q[1], q[2],
                               q[3]);
    float dy = weno_derivative(wv, q[-3 * ys], q[-2 * ys], q[-ys], q[0],
                               q[ys], q[2 * ys], q[3 * ys]);
    float lap = q[1] + q[-1] + q[ys] + q[-ys] - 4.0f * q[0];
    return afac * (wu * dx + wv * dy) + dfac * lap;
}

}  // namespace cup2d
