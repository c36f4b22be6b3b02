// One Heun substage of WENO5 advection plus diffusion on one x slab of a
// free-slip box, or of a boundary table's box, split along x:
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
// (reached from _fused_substage_sharded), free-slip table, f32 storage
// (cup2d_advect_substage_halo) and bf16 storage (cup2d_advect_substage_
// halo_bf16: v, vold and aux bf16, the halo exchanged in the storage
// dtype; out bf16 on the first substage, f32 on the second); and any other
// non-periodic boundary table, its BC branch (the info row's col0 and the
// global width nx_tot place the parabolic profile), in both storages
// (cup2d_advect_substage_halo_bc, cup2d_advect_substage_halo_bc_bf16).
// The periodic tables have no Pallas form (the JAX package runs them on its
// XLA chain, bc.pad_vector_bc's wrap under GSPMD); their slabs run the wrap
// form (cup2d_advect_substage_halo_wrap, f32): the ring's halo along a
// periodic x, the rows wrapped inside the slab along a periodic y.
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
// the solo kernel's output bit for bit. The boundary-table form paints as
// the solo BC form does (substage.cuh, paint_ghosts_bc) with three
// differences: the y-face profile at the slab's global columns (col0 +
// x, over nx_tot), the x faces only on the walls the slab owns, and the
// received halo columns left as loaded apart from their y ghost rows,
// which are painted from them as their owner paints its own. The solo
// instances pass col0 = 0, nx_tot = nx and both walls, so their
// arithmetic is unchanged. The TPU kernel's 128-lane padding of aux is a
// DMA artefact and is not kept.

#include "substage.cuh"

// vec and grid as for cup2d_advect_substage, of the slab's shape
extern "C" int cup2d_advect_substage_halo(const float* v, const float* vold,
                                          const float* aux, float* out,
                                          const float* facs, int L, int ny,
                                          int nxl, float cfac, float ih2,
                                          int is_lo, int is_hi, int vec,
                                          int grid, void* stream) {
    return substage::launch_form<false, float, float>(
        v, vold, aux, out, facs, L, ny, nxl, cfac, ih2, is_lo, is_hi,
        substage::Faces{}, 0.0f, 0, nxl, vec, grid, stream);
}

// The bf16 form: v, vold, aux bf16; out bf16 where out_bf16, else f32; vec
// as for cup2d_advect_substage_bf16, of the slab's shape
extern "C" int cup2d_advect_substage_halo_bf16(
        const void* v, const void* vold, const void* aux, void* out,
        const float* facs, int L, int ny, int nxl, float cfac, float ih2,
        int is_lo, int is_hi, int out_bf16, int vec, int grid,
        void* stream) {
    return substage::launch_bf16<false>(v, vold, aux, out, facs, L, ny, nxl,
                                        cfac, ih2, is_lo, is_hi,
                                        substage::Faces{}, 0.0f, 0, nxl,
                                        out_bf16, vec, grid, stream);
}

// The boundary-table forms: facs [L, 3] = (afac, dfac, dt) per member, h
// the grid spacing (outflow speed), faces the table (the solo BC form's
// struct), the slab's first column global column col0 of a field nx_tot
// wide; ny, nxl >= 2, 0 <= col0 <= nx_tot - nxl.
extern "C" int cup2d_advect_substage_halo_bc(
        const float* v, const float* vold, const float* aux, float* out,
        const float* facs, int L, int ny, int nxl, float cfac, float ih2,
        float h, substage::Faces faces, int is_lo, int is_hi, int col0,
        int nx_tot, int vec, int grid, void* stream) {
    if (ny < 2 || nxl < 2 || col0 < 0 || col0 > nx_tot - nxl)
        return (int)cudaErrorInvalidValue;
    return substage::launch_form<true, float, float>(
        v, vold, aux, out, facs, L, ny, nxl, cfac, ih2, is_lo, is_hi, faces,
        h, col0, nx_tot, vec, grid, stream);
}

// bf16: v, vold, aux bf16; out bf16 where out_bf16, else f32
extern "C" int cup2d_advect_substage_halo_bc_bf16(
        const void* v, const void* vold, const void* aux, void* out,
        const float* facs, int L, int ny, int nxl, float cfac, float ih2,
        float h, substage::Faces faces, int is_lo, int is_hi, int col0,
        int nx_tot, int out_bf16, int vec, int grid, void* stream) {
    if (ny < 2 || nxl < 2 || col0 < 0 || col0 > nx_tot - nxl)
        return (int)cudaErrorInvalidValue;
    return substage::launch_bf16<true>(v, vold, aux, out, facs, L, ny, nxl,
                                       cfac, ih2, is_lo, is_hi, faces, h,
                                       col0, nx_tot, out_bf16, vec, grid,
                                       stream);
}

// The wrap form of a periodic table (f32, a face pair of kind
// substage::PERIODIC): the boundary-table form's arguments. A periodic y
// wraps the slab's rows and aux's inside the slab; along a periodic x the
// caller passes is_lo = is_hi = 0 with aux holding the ring's columns (the
// first slab's left halo the last slab's last three columns, and so on),
// and the y faces of the other axis paint every column at its source
// column's profile (col0 + x mod nx_tot). vec as for the BC form.
extern "C" int cup2d_advect_substage_halo_wrap(
        const float* v, const float* vold, const float* aux, float* out,
        const float* facs, int L, int ny, int nxl, float cfac, float ih2,
        float h, substage::Faces faces, int is_lo, int is_hi, int col0,
        int nx_tot, int vec, int grid, void* stream) {
    const bool wx = faces.x_lo.kind == substage::PERIODIC;
    const bool wy = faces.y_lo.kind == substage::PERIODIC;
    if (ny < 2 || nxl < 2 || col0 < 0 || col0 > nx_tot - nxl || aux == nullptr
            || !(wx || wy) || wx != (faces.x_hi.kind == substage::PERIODIC)
            || wy != (faces.y_hi.kind == substage::PERIODIC)
            || (wx && (is_lo || is_hi)))
        return (int)cudaErrorInvalidValue;
    return substage::launch_form<true, float, float, true>(
        v, vold, aux, out, facs, L, ny, nxl, cfac, ih2, is_lo, is_hi, faces,
        h, col0, nx_tot, vec, grid, stream);
}
