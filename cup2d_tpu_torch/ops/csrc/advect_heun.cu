// One Heun substage of WENO5 advection plus diffusion on a free-slip box:
//   out = vold + cfac * rhs * ih2,
//   rhs = afac * (u . grad) q + dfac * lap(q)   (undivided, per component q)
// for a batch of L members, v/vold/out [L, 2, ny, nx] f32, facs [L, 2] f32
// (afac = -dt*h, dfac = nu*dt per member). vold == nullptr means vold = v
// (the first substage).
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _substage_kernel (reached from
// fused_advect_heun through _fused_substage), free-slip table, f32 storage.
//
// Bound on this card: the arithmetic of the WENO reconstructions, about
// 2 per cell and component once each face is reconstructed once (193
// operations per cell and component on the benchmark state) against 16
// (first substage) or 24 (second) bytes per cell: about as long as the
// bytes take at the H100's 67 TFLOP/s and 3.35 TB/s.
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
    return substage::launch(v, vold, nullptr, out, facs, L, ny, nx, cfac,
                            ih2, 1, 1, vec, grid, stream);
}
