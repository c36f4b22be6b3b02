// WENO5 advection plus diffusion right-hand side over a ghost-padded lab:
//   out = afac * (u . grad) q + dfac * lap(q)   (undivided, per component q)
// lab [L, 2, ny + 6, nx + 6] f32 with three ghost cells on each side, read
// as they are (no paint); out [L, 2, ny, nx]; facs [2] f32 = (afac, dfac) =
// (-dt*h, nu*dt), shared by the batch.
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _adv_kernel (reached from
// advect_diffuse_rhs_pallas through _advect_call), the round-4 single-op
// kernel over a pre-padded lab.
//
// Bound on this card: the WENO reconstructions, about 2 per cell and
// component once each face is reconstructed once (~190 operations per cell
// and component on the 8192^2 benchmark lab) against 16 bytes per cell
// (the lab read once, the result written once): about as long as the
// bytes take at the H100's 67 TFLOP/s and 3.35 TB/s.
//
// Design: the substage kernels' core (substage.cuh) in its single-op RHS
// form: persistent CTAs walk 32 x 128 tiles through a two-stage cp.async
// ring, and each warp walks its 32 columns down 16 rows sharing each face
// between the two cells whose winds agree in sign, queueing the cells
// where they differ. Only its two ends differ from the substages': the
// loader stages the lab as it is (8-byte copies where the pitch nx + 6 is
// even, from an even lab column; 4-byte ones where it is odd) and paints
// nothing, and each cell writes its RHS. The arithmetic is weno.cuh's, in
// the per-cell design's operand order, so the result is that design's
// bit for bit.

#include "substage.cuh"

// vec: 2 for 8-byte copies (nx even, lab 8-byte aligned), 1 for 4-byte
// ones; grid: the persistent CTAs, 1 .. the number of tiles.
extern "C" int cup2d_advect_rhs(const float* lab, float* out,
                                const float* facs, int L, int ny, int nx,
                                int vec, int grid, void* stream) {
    if (L < 1 || ny < 1 || nx < 1 || grid < 1 || (vec != 2 && vec != 1)
        || (vec == 2 && nx % 2))
        return (int)cudaErrorInvalidValue;
    return substage::launch_vec<0, false, float, float, true>(
        lab, nullptr, nullptr, out, facs, L, ny, nx, 0.0f, 0.0f, 0, 0,
        substage::Faces{}, 0.0f, 0, nx, vec, grid, (cudaStream_t)stream);
}
