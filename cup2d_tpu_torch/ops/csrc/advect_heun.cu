// One Heun substage of WENO5 advection plus diffusion on a free-slip box:
//   out = vold + cfac * rhs * ih2,
//   rhs = afac * (u . grad) q + dfac * lap(q)   (undivided, per component q)
// for a batch of L members, v/vold/out [L, 2, ny, nx] f32, facs [L, 2] f32
// (afac = -dt*h, dfac = nu*dt per member). vold == nullptr means vold = v
// (the first substage).
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _substage_kernel (reached from
// fused_advect_heun through _fused_substage): the free-slip table
// (cup2d_advect_substage) and any other non-periodic boundary table
// (cup2d_advect_substage_bc, the kernel's BC branch: _bc_ghost, _bc_uw_y,
// _bc_uw_x), f32 storage; and both in bf16 storage, fused_advect_heun(
// bf16=True) (cup2d_advect_substage_bf16, cup2d_advect_substage_bc_bf16):
// v and vold bf16, f32 arithmetic, out bf16 (substage 1) or f32
// (substage 2), facs f32. The periodic tables (cup2d_advect_substage_wrap,
// f32) have no Pallas form: the JAX package runs them as its XLA chain
// (uniform.py's pad_vector_field -> advect_diffuse_rhs -> heun_substage,
// bc.pad_vector_bc's wrap), whose function this form computes. The f64
// forms (cup2d_advect_substage_f64, _bc_f64, _wrap_f64) are the three
// above with every operand and all arithmetic in f64: the JAX package's
// XLA chain at x64, which its Pallas gate (fused_tier_supported, f32 only)
// sends f64 state to.
//
// Bound on this card: the arithmetic of the WENO reconstructions, about
// 2 per cell and component once each face is reconstructed once (193
// operations per cell and component on the benchmark state) against 16
// (first substage) or 24 (second) bytes per cell: about as long as the
// bytes take at the H100's 67 TFLOP/s and 3.35 TB/s. In bf16 storage the
// bytes fall to 8 and 16 per cell and the arithmetic stays: operations
// bound the pair.
//
// Design: the TPU kernel streams row strips through a 4-slot VMEM ring that
// carries halo rows from one sequential grid step to the next. CUDA blocks
// run in parallel, so persistent CTAs walk 32 x 128 tiles through a
// two-stage cp.async ring instead, each tile loading its own 3-cell halo,
// and a warp walks its columns down 16 rows sharing each face between the
// two cells that agree in wind sign: substage.cuh, the core this kernel
// shares with advect_heun_halo.cu (here with both x walls painted and no
// aux). The per-cell arithmetic is weno.cuh, shared with lab_rhs.cu and
// advect_rhs.cu: it follows ops/stencil.py term for term in f32. Only FMA
// contraction by the compiler separates the result from the plain
// PyTorch version.

#include "substage.cuh"

// vec: 4 for 16-byte copies (nx a multiple of 4, v 16-byte aligned), 1
// for 4-byte ones; grid: the persistent CTAs, 1 .. the number of tiles.
extern "C" int cup2d_advect_substage(const float* v, const float* vold,
                                     float* out, const float* facs, int L,
                                     int ny, int nx, float cfac, float ih2,
                                     int vec, int grid, void* stream) {
    return substage::launch_form<false, float, float>(
        v, vold, nullptr, out, facs, L, ny, nx, cfac, ih2, 1, 1,
        substage::Faces{}, 0.0f, 0, nx, vec, grid, stream);
}

// The boundary-table form: facs [L, 3] = (afac, dfac, dt) per member, h the
// grid spacing (outflow speed), faces the table (substage.cuh: kind, wall
// velocity, parabolic flag per face); ny, nx >= 2, so that every face's
// edge and inner lines are distinct.
extern "C" int cup2d_advect_substage_bc(const float* v, const float* vold,
                                        float* out, const float* facs,
                                        int L, int ny, int nx, float cfac,
                                        float ih2, float h,
                                        substage::Faces faces, int vec,
                                        int grid, void* stream) {
    if (ny < 2 || nx < 2) return (int)cudaErrorInvalidValue;
    return substage::launch_form<true, float, float>(
        v, vold, nullptr, out, facs, L, ny, nx, cfac, ih2, 1, 1, faces, h, 0,
        nx, vec, grid, stream);
}

// The bf16 forms: v, vold bf16 ([L, 2, ny, nx]), out bf16 where out_bf16
// (the first substage) else f32, facs f32 as above; vec 4 for 8-byte
// copies (nx a multiple of 4, v 8-byte aligned), 1 for 2-byte loads.
extern "C" int cup2d_advect_substage_bf16(const void* v, const void* vold,
                                          void* out, const float* facs,
                                          int L, int ny, int nx, float cfac,
                                          float ih2, int out_bf16, int vec,
                                          int grid, void* stream) {
    return substage::launch_bf16<false>(v, vold, nullptr, out, facs, L, ny,
                                        nx, cfac, ih2, 1, 1,
                                        substage::Faces{}, 0.0f, 0, nx,
                                        out_bf16, vec, grid, stream);
}

extern "C" int cup2d_advect_substage_bc_bf16(const void* v, const void* vold,
                                             void* out, const float* facs,
                                             int L, int ny, int nx,
                                             float cfac, float ih2, float h,
                                             substage::Faces faces,
                                             int out_bf16, int vec, int grid,
                                             void* stream) {
    if (ny < 2 || nx < 2) return (int)cudaErrorInvalidValue;
    return substage::launch_bf16<true>(v, vold, nullptr, out, facs, L, ny,
                                       nx, cfac, ih2, 1, 1, faces, h, 0, nx,
                                       out_bf16, vec, grid, stream);
}

// The wrap form: a table with a periodic axis (a face pair of kind
// substage::PERIODIC), f32; the arguments of the boundary-table form, and
// nx a multiple of 4 where vec is 4 (a wrapped run of four columns is then
// one 16-byte copy).
extern "C" int cup2d_advect_substage_wrap(const float* v, const float* vold,
                                          float* out, const float* facs,
                                          int L, int ny, int nx, float cfac,
                                          float ih2, float h,
                                          substage::Faces faces, int vec,
                                          int grid, void* stream) {
    const bool wx = faces.x_lo.kind == substage::PERIODIC;
    const bool wy = faces.y_lo.kind == substage::PERIODIC;
    if (ny < 2 || nx < 2 || !(wx || wy)
            || wx != (faces.x_hi.kind == substage::PERIODIC)
            || wy != (faces.y_hi.kind == substage::PERIODIC))
        return (int)cudaErrorInvalidValue;
    return substage::launch_form<true, float, float, true>(
        v, vold, nullptr, out, facs, L, ny, nx, cfac, ih2, 1, 1, faces, h, 0,
        nx, vec, grid, stream);
}

// The f64 forms: v, vold, out, facs f64 and every scalar f64 (the faces'
// wall velocities too: substage::Faces64); vec 2 for 16-byte copies (nx
// even, v 16-byte aligned), 1 for 8-byte ones; one CTA an SM.
extern "C" int cup2d_advect_substage_f64(const double* v, const double* vold,
                                         double* out, const double* facs,
                                         int L, int ny, int nx, double cfac,
                                         double ih2, int vec, int grid,
                                         void* stream) {
    return substage::launch_form<false, double, double>(
        v, vold, nullptr, out, facs, L, ny, nx, cfac, ih2, 1, 1,
        substage::Faces64{}, 0.0, 0, nx, vec, grid, stream);
}

extern "C" int cup2d_advect_substage_bc_f64(const double* v,
                                            const double* vold, double* out,
                                            const double* facs, int L,
                                            int ny, int nx, double cfac,
                                            double ih2, double h,
                                            substage::Faces64 faces, int vec,
                                            int grid, void* stream) {
    if (ny < 2 || nx < 2) return (int)cudaErrorInvalidValue;
    return substage::launch_form<true, double, double>(
        v, vold, nullptr, out, facs, L, ny, nx, cfac, ih2, 1, 1, faces, h, 0,
        nx, vec, grid, stream);
}

extern "C" int cup2d_advect_substage_wrap_f64(const double* v,
                                              const double* vold,
                                              double* out,
                                              const double* facs, int L,
                                              int ny, int nx, double cfac,
                                              double ih2, double h,
                                              substage::Faces64 faces,
                                              int vec, int grid,
                                              void* stream) {
    const bool wx = faces.x_lo.kind == substage::PERIODIC;
    const bool wy = faces.y_lo.kind == substage::PERIODIC;
    if (ny < 2 || nx < 2 || !(wx || wy)
            || wx != (faces.x_hi.kind == substage::PERIODIC)
            || wy != (faces.y_hi.kind == substage::PERIODIC))
        return (int)cudaErrorInvalidValue;
    return substage::launch_form<true, double, double, true>(
        v, vold, nullptr, out, facs, L, ny, nx, cfac, ih2, 1, 1, faces, h, 0,
        nx, vec, grid, stream);
}
