// One Heun substage of WENO5 advection plus diffusion on one x slab of a
// free-slip box split along x:
//   out = vold + cfac * rhs * ih2,
//   rhs = afac * (u . grad) q + dfac * lap(q)   (undivided, per component q)
// for a batch of L members, v/vold/out [L, 2, ny, nxl] f32, facs [L, 2] f32
// (afac = -dt*h, dfac = nu*dt per member), aux [L, 2, ny, 6] f32: the three
// columns left of the slab (aux[..., 0:3], the left neighbour's last three)
// and the three right of it (aux[..., 3:6], the right neighbour's first
// three). is_lo / is_hi say that the slab owns the low / high x wall; there
// the aux columns are ignored and the wall ghosts are painted. vold ==
// nullptr means vold = v (the first substage).
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _sharded_substage_kernel
// (reached from _fused_substage_sharded), free-slip table, f32 storage.
//
// Bound on this card: as for advect_heun.cu, about 2 reconstructions per
// cell and component against 16 or 24 bytes per cell (the 6-column aux
// adds 48 bytes per row, under 3% at a slab width of 2048).
//
// Design: the solo kernel's (substage.cuh), which loads its own halo. A
// tile at a slab edge copies its x halo from aux where that side has a
// neighbour and paints the free-slip x ghost (u negated, v copied, from the
// y-completed edge column) only where the slab owns the wall. y ghosts are
// painted over the aux columns too (u copied, v negated), so every lab
// value is the number the solo kernel holds at the same global position,
// and the core is the solo kernel's: the slabs of a split step reproduce
// the solo kernel's output bit for bit. The TPU kernel's 128-lane padding
// of aux is a DMA artefact and is not kept.

#include "substage.cuh"

// vec and grid as for cup2d_advect_substage, of the slab's shape
extern "C" int cup2d_advect_substage_halo(const float* v, const float* vold,
                                          const float* aux, float* out,
                                          const float* facs, int L, int ny,
                                          int nxl, float cfac, float ih2,
                                          int is_lo, int is_hi, int vec,
                                          int grid, void* stream) {
    return substage::launch(v, vold, aux, out, facs, L, ny, nxl, cfac, ih2,
                            is_lo, is_hi, vec, grid, stream);
}
