// One Heun substage of WENO5 advection plus diffusion on a free-slip box
// or a boundary table's box, whole (advect_heun.cu) or as one x slab of a
// split field (advect_heun_halo.cu), and the single-op RHS over a
// pre-padded lab (advect_rhs.cu): the tile geometry, the
// loaders with their ghost painting and the compute core the three kernels
// share. The substages differ only in what the loader is given: the solo
// kernel no aux and both x walls, the halo kernel its neighbours' edge
// columns and the walls it owns.
//
//   out = vold + cfac * rhs * ih2   (the substages; the single-op RHS: rhs),
//   rhs = afac * (u . grad) q + dfac * lap(q)   (undivided, per component q)
//
// Bound on this card: the WENO reconstructions, the arithmetic of which
// is fixed (bit for bit the per-cell kernel's). A cell's x derivative is
// t1 - t2, its right face less its left face, each reconstructed with the
// cell's own wind sign (weno.cuh); the right face of cell i and the left
// face of cell i + 1 are the same call on the same five operands whenever
// the two cells' winds have the same sign. So a face needs one
// reconstruction where its two cells agree and two where they differ:
// about 2 per cell and component instead of the per-cell kernel's 4 (on
// the 8192^2 benchmark state 0.4% of the faces differ in sign).
//
// Design:
// - A warp owns 32 columns of a tile and walks RW = 16 rows; a lane owns
//   one column. Each row, a lane reconstructs its right x face with the
//   sign of its own u and its upper y face with the sign of its own v.
//   The left x face comes from the lane to the left by warp shuffle, the
//   lower y face from the lane's own previous row. Lane 0's left faces,
//   one per row and component, are reconstructed for the 16 rows at once
//   before the walk, one per lane, and the first row's lower faces
//   likewise: 2.09 reconstructions per cell and component.
// - Where a cell's sign differs from its left or lower neighbour's, the
//   face it received is the wrong one. The cell then joins its warp's
//   queue in shared memory with its faces so far, and the missing faces
//   are reconstructed in batches, one per lane, at the end of the walk
//   (or when the queue fills), where the queued cells are finished. A
//   branch in the walk instead would cost the whole warp a reconstruction
//   whenever one lane takes it: 14% (x) and 6% (y) of the warps' rows on
//   the benchmark state, 16% of the kernel's time.
// - The four faces of a row are computed as four Weno5Parts, then four
//   blends (weno.cuh), so that the compiler can interleave their
//   arithmetic ahead of the reciprocals' branches.
// - Each face is cup2d::weno_face on the operands of the cell's right
//   face t1 (or left face t2) in ops/stencil.py (weno.cuh), and t1 - t2,
//   the Laplacian, the RHS and the update keep their expression order and
//   fused multiply-adds (the update is vold + cfac * rhs * ih2 as one fma
//   of cfac * rhs), so the result is the per-cell kernel's bit for bit.
//   A lane holds its column's seven values per component in registers,
//   rolled down a row at a time, and loads the row's six other x values:
//   seven shared loads per cell and component.
// - Tiles of TY x TX = 32 x 128 cells (8 warps, 4 across and 2 down) of
//   one member, with a 3-row and 4-column halo of both components in
//   shared memory (1.26x the tile's cells). Persistent CTAs, two per SM
//   (96 KB of shared memory and 128 registers a thread each), walk the
//   tiles through a two-stage ring: the next tile's 16-byte cp.async
//   copies (4-byte where rows are not whole 16-byte words) are in flight
//   during this tile's arithmetic.
// - Only cells inside the field (or the slab's aux columns) are copied.
//   A tile whose halo leaves the field across a wall paints its ghosts in
//   shared memory after the copies land: y ghosts over every column (u
//   copied, v negated, from the edge row), then x ghosts on the walled
//   sides (u negated, v copied, from the y-completed edge column), so a
//   corner is (-u, -v) of the corner cell, as ops/stencil.py pads. Cells
//   past the ghosts of a ragged tile are never copied and feed no output
//   cell.
// - The boundary-table form (BC = true, whole or of a slab) differs in
//   the painting alone: paint_ghosts_bc paints each face by its kind
//   (free-slip mirror, no-slip or inflow 2 uw - edge with the parabolic
//   profile, convective outflow edge + c (edge - inner)), y faces over
//   every column first, then x faces over the y-completed columns, so the
//   corners compose y then x as bc.pad_vector_bc does. A slab paints the
//   y ghosts of its received halo columns too (the profile at the global
//   column col0 + x), as their owner paints them, and its x faces only on
//   the walls it owns (bc.pad_vector_bc_slab). Each ghost layer
//   is one painted line. The free-slip instance (BC = false) is the
//   kernel above unchanged: the form is a template parameter, not a
//   branch in the loader or the walk.
// - Storage types (the CUP2D_PREC=bf16 tier): v, vold and aux are of one
//   type TI, out of another, TO (substage 1 reads and writes bf16,
//   substage 2 reads bf16 and writes the f32 state). A bf16 tile is
//   widened to f32 when it is staged, so the painting, the walk and
//   weno.cuh run unchanged on the values the TPU kernel upcasts; vold is
//   widened where it is read and each result rounded once, to nearest
//   even, where it is stored. bf16 stages arrive by 8-byte cp.async (four
//   values; rows of whole 8-byte words) into a two-stage raw ring, or by
//   2-byte loads where rows are ragged (aux always: its columns start off
//   the 8-byte grid), and one pass widens a stage into the single f32
//   stage: the same 96 KB as the f32 kernel's two f32 stages. The copy
//   width of a bf16 instance is a launch argument, not a template
//   parameter (half the instances to build). The f32 instances (TI = TO =
//   float) are the kernel above.
// - The single-op RHS form (LAB = true, f32) changes the two ends alone:
//   load_lab stages a tile from a lab [L, 2, ny + 6, nx + 6] whose ghosts
//   already hold their values (nothing is painted, no wall logic), and
//   each cell writes rhs itself (no vold, no update). A lab row at
//   nx = 8192 is 8198 floats, a multiple of 8 bytes but not of 16, so the
//   stage starts one column further left than load_tile's, on an even lab
//   column: 8-byte cp.async where the pitch nx + 6 is even, 4-byte copies
//   where it is odd (a launch argument, as the bf16 copy width is). The
//   walk reads the faces where the per-cell kernel read them, and the
//   result is its bits. The form is a template parameter of the kernel,
//   the walk and the queue, so the substage instances compile as before.
// - The wrap form (WRAP = true, a boundary-table form, f32) runs the
//   periodic tables: a face of kind PERIODIC (paired, as
//   bc.py validates) makes its axis wrap. Along a periodic axis a tile
//   copies its out-of-field halo rows or columns from (gy mod ny, gx mod
//   nx), as bc.pad_vector_bc's wrap puts them, and paints nothing there;
//   the other axis's faces paint as in the BC form, over every stage
//   column, the wrapped columns included (the y faces of the periodic
//   channel; an inflow profile at the wrapped column's own coordinate), so
//   the corners are pad_vector_bc's too. nx % 4 == 0 keeps a wrapped run
//   of four columns one 16-byte copy (x0 - XO is a multiple of 4). The
//   compute core is the BC form's; the instance is a template parameter
//   of the loader and the painting, so the other instances are unchanged.
//   On an x slab (advect_heun_halo.cu's wrap form) x never wraps inside the
//   slab: along a periodic x the host passes no wall and aux holds the
//   ring's columns, whose y rows wrap (a periodic y) or are painted at
//   their source column's profile (the periodic channel).
// - f64 (TI = TO = double; the free-slip, BC and wrap forms of the whole
//   field): the arithmetic type R (storage::compute_t) is double, so the
//   stage, the walk's registers, the queue's values, facs, cfac, ih2, h
//   and the faces' wall velocities (FaceT<double>) are f64 and weno.cuh
//   runs its f64 form, in the f32 form's order of operations. The stage
//   doubles: 187 KB of shared memory a CTA, so one CTA an SM
//   (substage_ctas), and the copies are 16 bytes (two values; nx even,
//   v 16-byte aligned) or 8.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"
#include "weno.cuh"

namespace substage {

// A face of a boundary table (cup2d_tpu_torch/bc.py): its ghost kind, its
// wall velocity (no-slip lid or inflow) and whether an inflow is parabolic
// (4 s (1 - s) along the face). Passed to the kernel by value. Outside the
// unnamed namespace below: a C entry point that takes it by value must
// keep external linkage.
enum FaceKind { FREE_SLIP = 0, NO_SLIP = 1, INFLOW = 2, OUTFLOW = 3,
                PERIODIC = 4 };

template <class R>
struct FaceT {
    int kind;
    int parabolic;
    R u, v;
};

template <class R>
struct FacesT {
    FaceT<R> x_lo, x_hi, y_lo, y_hi;
};

using Face = FaceT<float>;
using Faces = FacesT<float>;
using Faces64 = FacesT<double>;

// Internal linkage for the rest in each source that includes this: two
// libraries that shared these templates would also share launch_vec's
// opt-in flag (a static local of a template is one object per process),
// and the second would launch without its own shared-memory opt-in.
namespace {

constexpr int G = 3;                     // ghost cells a WENO5 cell reads
constexpr int TX = 128;                  // columns out per tile
constexpr int TY = 32;                   // rows out per tile
constexpr int WARPS_X = TX / 32;
constexpr int WARPS = 8;
constexpr int RW = TY / (WARPS / WARPS_X);   // rows a warp walks
constexpr int THREADS = 32 * WARPS;
constexpr int XO = 4;                    // x halo, in 16-byte steps
constexpr int W = TX + 2 * XO;           // shared row pitch
constexpr int H = TY + 2 * G;
constexpr int CELLS = W * H;             // one component of one stage
// a warp's queue of deferred cells: QCELLS cells (packed row and lane), up
// to four face requests each, and eight values per cell (field-major)
constexpr int QCELLS = 32;
constexpr int QREQ = 4 * QCELLS;
constexpr int QWORDS = QCELLS + QREQ + 8 * QCELLS;
// a warp's queue in bytes: the cells' and requests' ints, then the values
// in the arithmetic type R (QWORDS words for f32)
template <class R>
constexpr size_t QBYTES = sizeof(int) * (QCELLS + QREQ)
                          + sizeof(R) * 8 * QCELLS;
// the same in values of R (QWORDS for f32)
template <class R>
constexpr int QWORDS_OF = (int)(QBYTES<R> / sizeof(R));
static_assert(QWORDS_OF<float> == QWORDS
              && QBYTES<double> % sizeof(double) == 0,
              "a warp's queue is a whole number of values");
// two stages of (u, v) and the warps' queues
template <class R>
constexpr size_t SMEM = sizeof(R) * (2 * 2 * CELLS + WARPS * QWORDS_OF<R>);
// CTAs per SM: two for the f32 and bf16 forms, one for f64 (its stages
// take 187 KB)
template <class TI>
constexpr int substage_ctas = storage::is_f64<TI> ? 1 : 2;
static_assert(2 * RW <= 32, "the boundary pass puts both components of a "
                            "warp's rows on its 32 lanes");
static_assert(TX % 32 == 0 && W % 4 == 0 && CELLS % 4 == 0,
              "16-byte copies need whole 16-byte rows and stages");
static_assert(TX + 2 * G <= W && (TX + 2 * G) % 2 == 0,
              "a lab tile's columns fit a stage row in 8-byte copies");

struct Tile {
    int l;         // member
    int y0, x0;    // global coordinates of the tile's first output cell
};

__device__ __forceinline__ Tile tile_at(int t, int ny, int nx) {
    const int tx_n = (nx + TX - 1) / TX;
    const int ty_n = (ny + TY - 1) / TY;
    Tile T;
    T.l = t / (tx_n * ty_n);
    const int rem = t - T.l * tx_n * ty_n;
    const int by = rem / tx_n;
    T.y0 = by * TY;
    T.x0 = (rem - by * tx_n) * TX;
    return T;
}

// k mod n in [0, n), for any k (a halo may span several periods of a
// field narrower than the tile)
__device__ __forceinline__ int wrap(int k, int n) {
    const int m = k % n;
    return m < 0 ? m + n : m;
}

// a copy of VEC values of T: 16 bytes (four f32 or two f64 values), 8
// (one f64) or 4 (one f32)
template <int VEC, class T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
    constexpr int BYTES = VEC * (int)sizeof(T);
    uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(s), "l"(src) : "memory");
    else if constexpr (BYTES == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                     :: "r"(s), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait0() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copies of one tile into a stage (u then v, H rows of W): the
// cells inside the field, and where aux is given, the slab's outside
// columns on the sides it does not own (aux [L, 2, ny, 6]: columns -3..-1,
// then nx..nx+2). Shared column i holds global x0 - XO + i. WRAP: along a
// periodic axis (wx, wy) the cells outside the field too, from the
// wrapped index (a slab's aux columns wrap their rows along y; a slab
// passes wx false, its x halo being aux's). T: f32 (VEC 4 or 1) or f64
// (VEC 2 or 1).
template <int VEC, bool WRAP = false, class T_>
__device__ __forceinline__ void load_tile(T_* st, const T_* v,
                                          const T_* aux, const Tile& T,
                                          int ny, int nx, int is_lo,
                                          int is_hi, bool wx = false,
                                          bool wy = false) {
    const size_t plane = (size_t)ny * nx;
    const T_* src = v + (size_t)T.l * 2 * plane;
    constexpr int CW = W / VEC;          // copies per shared row
    for (int q = threadIdx.x; q < 2 * H * CW; q += THREADS) {
        const int row = q / CW;          // component c, row j
        const int c = row >= H;
        const int j = row - c * H;
        const int i = (q - row * CW) * VEC;
        int gy = T.y0 - G + j, gx = T.x0 - XO + i;
        if constexpr (WRAP) {
            if (gy < 0 || gy >= ny) {
                if (!wy) continue;
                gy = wrap(gy, ny);
            }
            if (gx < 0 || gx >= nx) {
                if (!wx) continue;
                gx = wrap(gx, nx);
            }
        } else {
            if (gy < 0 || gy >= ny || gx < 0 || gx >= nx) continue;
        }
        cp_async<VEC>(st + c * CELLS + j * W + i,
                      src + c * plane + (size_t)gy * nx + gx);
    }
    if (aux == nullptr) return;
    const bool lo = T.x0 == 0 && !is_lo;
    const bool hi = T.x0 - XO + W > nx && !is_hi;
    if (!lo && !hi) return;
    const T_* a = aux + (size_t)T.l * 2 * ny * 2 * G;
    for (int q = threadIdx.x; q < 2 * H * 2 * G; q += THREADS) {
        const int row = q / (2 * G), k = q - row * (2 * G);
        const int c = row >= H;
        const int j = row - c * H;
        int gy = T.y0 - G + j;
        const int gx = k < G ? k - G : nx + k - G;
        const int i = gx - T.x0 + XO;
        if (!(k < G ? lo : hi) || i >= W) continue;
        if (gy < 0 || gy >= ny) {
            if (!(WRAP && wy)) continue;
            gy = wrap(gy, ny);
        }
        cp_async<1>(st + c * CELLS + j * W + i,
                    a + ((size_t)c * ny + gy) * 2 * G + k);
    }
}

// The bf16 loader: the copies of one tile into a raw bf16 stage (u then v,
// H rows of W), by 8-byte cp.async where vec4 (nx a multiple of 4, v 8-byte
// aligned), else by 2-byte loads; the aux columns always by 2-byte loads.
// Shared column i holds global x0 - XO + i, as in load_tile.
__device__ __forceinline__ void load_tile_bf16(
        storage::bf16* st, const storage::bf16* v, const storage::bf16* aux,
        const Tile& T, int ny, int nx, int is_lo, int is_hi, bool vec4) {
    const size_t plane = (size_t)ny * nx;
    const storage::bf16* src = v + (size_t)T.l * 2 * plane;
    if (vec4) {
        constexpr int CW = W / 4;
        for (int q = threadIdx.x; q < 2 * H * CW; q += THREADS) {
            const int row = q / CW;
            const int c = row >= H;
            const int j = row - c * H;
            const int i = (q - row * CW) * 4;
            const int gy = T.y0 - G + j, gx = T.x0 - XO + i;
            if (gy < 0 || gy >= ny || gx < 0 || gx >= nx) continue;
            storage::cp_async8(st + c * CELLS + j * W + i,
                               src + c * plane + (size_t)gy * nx + gx);
        }
    } else {
        for (int q = threadIdx.x; q < 2 * H * W; q += THREADS) {
            const int row = q / W;
            const int c = row >= H;
            const int j = row - c * H;
            const int i = q - row * W;
            const int gy = T.y0 - G + j, gx = T.x0 - XO + i;
            if (gy < 0 || gy >= ny || gx < 0 || gx >= nx) continue;
            st[c * CELLS + j * W + i] = src[c * plane + (size_t)gy * nx + gx];
        }
    }
    if (aux == nullptr) return;
    const bool lo = T.x0 == 0 && !is_lo;
    const bool hi = T.x0 - XO + W > nx && !is_hi;
    if (!lo && !hi) return;
    const storage::bf16* a = aux + (size_t)T.l * 2 * ny * 2 * G;
    for (int q = threadIdx.x; q < 2 * H * 2 * G; q += THREADS) {
        const int row = q / (2 * G), k = q - row * (2 * G);
        const int c = row >= H;
        const int j = row - c * H;
        const int gy = T.y0 - G + j;
        const int gx = k < G ? k - G : nx + k - G;
        const int i = gx - T.x0 + XO;
        if (gy < 0 || gy >= ny || !(k < G ? lo : hi) || i >= W) continue;
        st[c * CELLS + j * W + i] = a[((size_t)c * ny + gy) * 2 * G + k];
    }
}

// The single-op RHS's loader: the copies of one tile from a lab [L, 2,
// ny + 6, nx + 6] into a stage (u then v, H rows), only cells inside the
// lab. Shared row j holds lab row y0 + j (global y0 - G + j, as in
// load_tile), shared column i lab column x0 + i (global x0 - G + i, one
// column left of load_tile's, so that a stage row starts on an even lab
// column); the walk reads stage columns 0 .. TX + 2G - 1. By 8-byte
// cp.async where vec2 (the pitch nx + 6 even, the lab 8-byte aligned),
// else by 4-byte ones.
__device__ __forceinline__ void load_lab(float* st, const float* lab,
                                         const Tile& T, int ny, int nx,
                                         bool vec2) {
    constexpr int LW = TX + 2 * G;       // lab columns a tile reads
    const int pitch = nx + 2 * G;
    const size_t pplane = (size_t)(ny + 2 * G) * pitch;
    const float* src = lab + (size_t)T.l * 2 * pplane
                       + (size_t)T.y0 * pitch + T.x0;
    const int rows = min(H, ny + 2 * G - T.y0);
    const int cols = min(LW, pitch - T.x0);
    if (vec2) {
        constexpr int CW = LW / 2;
        for (int q = threadIdx.x; q < 2 * H * CW; q += THREADS) {
            const int row = q / CW;
            const int c = row >= H;
            const int j = row - c * H;
            const int i = (q - row * CW) * 2;
            if (j >= rows || i >= cols) continue;
            storage::cp_async8(st + c * CELLS + j * W + i,
                               src + c * pplane + (size_t)j * pitch + i);
        }
    } else {
        for (int q = threadIdx.x; q < 2 * H * LW; q += THREADS) {
            const int row = q / LW;
            const int c = row >= H;
            const int j = row - c * H;
            const int i = q - row * LW;
            if (j >= rows || i >= cols) continue;
            cp_async<1>(st + c * CELLS + j * W + i,
                        src + c * pplane + (size_t)j * pitch + i);
        }
    }
}

// Widen a raw bf16 stage (both components) into the f32 stage.
__device__ __forceinline__ void widen_stage(float* st,
                                            const storage::bf16* raw) {
    const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(raw);
    float2* s2 = reinterpret_cast<float2*>(st);
    for (int q = threadIdx.x; q < CELLS; q += THREADS)
        s2[q] = __bfloat1622float2(r2[q]);
}

// True where the cells a tile's outputs read (3 rows and columns around
// it) leave the field across a y wall or a walled x side: the tile then
// paints ghosts (a slab's other x sides come from aux, a periodic axis's
// from the wrap: wy, and wall_lo = wall_hi = false along a periodic x).
__device__ __forceinline__ bool paints(const Tile& T, int ny, int nx,
                                       bool wall_lo, bool wall_hi,
                                       bool wy = false) {
    return (!wy && (T.y0 < G || T.y0 + TY + G > ny))
           || (wall_lo && T.x0 < G) || (wall_hi && T.x0 + TX + G > nx);
}

// Paint the free-slip ghosts of a stage whose copies have landed: the y
// ghosts over every column, then the x ghosts of the walled sides from
// the y-completed edge column. Ends synchronised.
template <class R>
__device__ __forceinline__ void paint_ghosts(R* st, const Tile& T,
                                             int ny, int nx, bool wall_lo,
                                             bool wall_hi) {
    R* u = st;
    R* w = st + CELLS;
    const int jhi = ny - 1 - T.y0 + G;   // shared row of gy = ny - 1
    for (int q = threadIdx.x; q < 2 * G * W; q += THREADS) {
        const int r = q / W, i = q - r * W;
        int j, from;
        if (r < G) {
            if (T.y0 != 0) continue;
            j = r;
            from = G;
        } else {
            j = jhi + 1 + (r - G);
            from = jhi;
            if (j >= H) continue;
        }
        u[j * W + i] = u[from * W + i];
        w[j * W + i] = -w[from * W + i];
    }
    __syncthreads();
    const int ihi = nx - 1 - T.x0 + XO;  // shared column of gx = nx - 1
    for (int q = threadIdx.x; q < 2 * G * H; q += THREADS) {
        const int k = q / H, j = q - k * H;
        int i, from;
        if (k < G) {
            if (T.x0 != 0 || !wall_lo) continue;
            i = XO - G + k;
            from = XO;
        } else {
            i = ihi + 1 + (k - G);
            from = ihi;
            if (!wall_hi || i >= W) continue;
        }
        u[j * W + i] = -u[j * W + from];
        w[j * W + i] = w[j * W + from];
    }
    __syncthreads();
}

// 4 s (1 - s), rounded as the plain profile is
template <class R>
__device__ __forceinline__ R parabola(R s) {
    return storage::mul_rn(storage::mul_rn((R)4.0, s),
                           storage::sub_rn((R)1.0, s));
}

// A face's wall velocity at profile value p: parabolic inflow scales its
// nonzero components by p.
template <class R>
__device__ __forceinline__ void wall_velocity(const FaceT<R>& f, R p, R& wu,
                                              R& wv) {
    wu = f.u;
    wv = f.v;
    if (f.kind == INFLOW && f.parabolic) {
        if (wu != (R)0.0) wu = storage::mul_rn(wu, p);
        if (wv != (R)0.0) wv = storage::mul_rn(wv, p);
    }
}

// The ghost pair of a face whose normal component is nc (1: a y face, v;
// 0: an x face, u) and whose outward direction is sign, from the edge and
// inner cells' (u, v), rounded as bc.pad_vector_bc's plain expressions
// (no contraction): the mirror; 2 uw - edge; or edge + c (edge - inner)
// with c = clip(sign * edge_n * dt / h, 0, 1), the outflow speed taken
// from the edge cell, not from a ghost.
template <class R>
__device__ __forceinline__ void bc_ghost(const FaceT<R>& f, int nc, R sign,
                                         R eu, R ev, R iu, R iv, R wu, R wv,
                                         R dt, R h, R& gu, R& gv) {
    using namespace storage;
    if (f.kind == FREE_SLIP) {
        gu = nc == 0 ? -eu : eu;
        gv = nc == 1 ? -ev : ev;
    } else if (f.kind == OUTFLOW) {
        const R en = nc == 0 ? eu : ev;
        const R c = vmin(vmax(div_rn(mul_rn(mul_rn(sign, en), dt), h),
                              (R)0.0),
                         (R)1.0);
        gu = add_rn(eu, mul_rn(c, sub_rn(eu, iu)));
        gv = add_rn(ev, mul_rn(c, sub_rn(ev, iv)));
    } else {
        gu = sub_rn(mul_rn((R)2.0, wu), eu);
        gv = sub_rn(mul_rn((R)2.0, wv), ev);
    }
}

// Paint the boundary table's ghosts of a stage whose copies have landed,
// on a whole field (col0 = 0, nx_tot = nx, both x sides walled) or on one
// x slab of a field nx_tot wide whose first column is global column col0:
// the y faces over every column (a slab's received halo columns too, as
// their owner paints them), each ghost row from the edge row (and the next
// one in, for outflow), the parabolic profile at s = (col0 + gx + 0.5) /
// nx_tot; then the x faces over the y-completed columns on the walled sides
// only, the profile at s = (gy + 0.5) / ny clamped to [0, 1], so that it
// closes to 0 at the corners. The received halo columns are otherwise left
// as loaded. dt is the member's raw dt. The int -> float conversion of a
// global column is exact below 2^24, so a slab's profile is the whole
// field's at the same column. WRAP: no y faces where y is periodic (wy);
// where x is (wx) the x faces are off (wall_lo = wall_hi = false) and a
// wrapped column's profile is its source column's (global column col0 + gx
// mod nx_tot: a slab's ring halo columns too). Ends synchronised.
template <bool WRAP = false, class R>
__device__ __forceinline__ void paint_ghosts_bc(R* st, const Tile& T,
                                                int ny, int nx,
                                                const FacesT<R>& F, R dt,
                                                R h, int col0,
                                                int nx_tot, bool wall_lo,
                                                bool wall_hi, bool wx = false,
                                                bool wy = false) {
    using namespace storage;
    R* u = st;
    R* w = st + CELLS;
    const int jhi = ny - 1 - T.y0 + G;   // shared row of gy = ny - 1
    for (int q = threadIdx.x; q < 2 * G * W; q += THREADS) {
        if constexpr (WRAP) {
            if (wy) break;
        }
        const int r = q / W, i = q - r * W;
        const bool lo = r < G;
        int j, e, in;
        if (lo) {
            if (T.y0 != 0) continue;
            j = r;
            e = G;
            in = G + 1;
        } else {
            j = jhi + 1 + (r - G);
            if (j >= H) continue;
            e = jhi;
            in = jhi - 1;
        }
        const FaceT<R> f = lo ? F.y_lo : F.y_hi;
        int gx = col0 + T.x0 - XO + i;       // the global column
        if constexpr (WRAP) {
            if (wx) gx = wrap(gx, nx_tot);
        }
        const R p = parabola(div_rn(add_rn((R)gx, (R)0.5), (R)nx_tot));
        R wu, wv, gu, gv;
        wall_velocity(f, p, wu, wv);
        bc_ghost(f, 1, lo ? (R)-1.0 : (R)1.0, u[e * W + i], w[e * W + i],
                 u[in * W + i], w[in * W + i], wu, wv, dt, h, gu, gv);
        u[j * W + i] = gu;
        w[j * W + i] = gv;
    }
    __syncthreads();
    const int ihi = nx - 1 - T.x0 + XO;  // shared column of gx = nx - 1
    for (int q = threadIdx.x; q < 2 * G * H; q += THREADS) {
        const int k = q / H, j = q - k * H;
        const bool lo = k < G;
        int i, e, in;
        if (lo) {
            if (T.x0 != 0 || !wall_lo) continue;
            i = XO - G + k;
            e = XO;
            in = XO + 1;
        } else {
            i = ihi + 1 + (k - G);
            if (!wall_hi || i >= W) continue;
            e = ihi;
            in = ihi - 1;
        }
        const FaceT<R> f = lo ? F.x_lo : F.x_hi;
        const R s = div_rn(add_rn((R)(T.y0 - G + j), (R)0.5), (R)ny);
        const R p = parabola(vmin(vmax(s, (R)0.0), (R)1.0));
        R wu, wv, gu, gv;
        wall_velocity(f, p, wu, wv);
        bc_ghost(f, 0, lo ? (R)-1.0 : (R)1.0, u[j * W + e], w[j * W + e],
                 u[j * W + in], w[j * W + in], wu, wv, dt, h, gu, gv);
        u[j * W + i] = gu;
        w[j * W + i] = gv;
    }
    __syncthreads();
}

// A warp's queue of deferred cells in shared memory: cells whose left x or
// lower y face splits between two wind signs, so that the face its
// neighbour reconstructed is not the one it needs.
template <class R>
struct Queue {
    int* cell;     // (row << 5) | lane
    int* req;      // (slot << 2) | (dir << 1) | component; dir 1: y
    R* val;        // [8][QCELLS]: r0 r1 t0 t1 l0 l1 d0 d1 of each slot
    int ncell, nreq;
};

// A cell's two results at o and o + plane: the update vold + cfac * rhs *
// ih2 (one fma of cfac * rhs, rounded once to TO) or, in the single-op RHS
// form (LAB), rhs itself.
template <bool LAB, class TO, class R>
__device__ __forceinline__ void store(TO* __restrict__ out, size_t o,
                                      size_t plane, R rhs0, R rhs1, R vo0,
                                      R vo1, R cfac, R ih2) {
    if constexpr (LAB) {
        out[o] = rhs0;
        out[o + plane] = rhs1;
    } else {
        out[o] = storage::narrow<TO>(storage::fma_rn(cfac * rhs0, ih2, vo0));
        out[o + plane] = storage::narrow<TO>(storage::fma_rn(cfac * rhs1,
                                                             ih2, vo1));
    }
}

// Finish the queued cells: each lane reconstructs queued faces (a cell's
// left x or lower y face, with the cell's own sign), then finishes one
// queued cell as the row walk finishes the others. Leaves it empty.
template <bool LAB, class TI, class TO, class R>
__device__ __forceinline__ void flush_queue(
        Queue<R>& Q, const R* U, const R* V, int k0,
        const TI* __restrict__ vold, TO* __restrict__ out, size_t ob,
        size_t plane, int nx, R afac, R dfac, R cfac, R ih2) {
    const int lane = threadIdx.x & 31;
    __syncwarp();
    for (int r = lane; r < Q.nreq; r += 32) {
        const int req = Q.req[r];
        const int slot = req >> 2, dir = (req >> 1) & 1, comp = req & 1;
        const int cell = Q.cell[slot];
        const int kk = k0 + (cell >> 5) * W + (cell & 31);
        const int s = dir ? W : 1;
        const R* q = (comp ? V : U) + kk;
        const bool pos = (dir ? V : U)[kk] > (R)0.0;
        Q.val[(4 + 2 * dir + comp) * QCELLS + slot] = cup2d::weno_face(
            pos, q[-3 * s], q[-2 * s], q[-s], q[0], q[s], q[2 * s]);
    }
    __syncwarp();
    if (lane < Q.ncell) {
        const int cell = Q.cell[lane];
        const int kk = k0 + (cell >> 5) * W + (cell & 31);
        const R* f = Q.val + lane;
        const size_t o = ob + (size_t)(cell >> 5) * nx + (cell & 31);
        const R wu = U[kk], wv = V[kk];
        R vo0 = wu, vo1 = wv;
        if constexpr (!LAB) {
            vo0 = vold != nullptr ? storage::widen(vold[o]) : wu;
            vo1 = vold != nullptr ? storage::widen(vold[o + plane]) : wv;
        }
        const R rhs0 = cup2d::advect_diffuse_rhs(
            wu, U[kk - 1], U[kk + 1], U[kk - W], U[kk + W], wu, wv,
            f[0] - f[4 * QCELLS], f[2 * QCELLS] - f[6 * QCELLS], afac, dfac);
        const R rhs1 = cup2d::advect_diffuse_rhs(
            wv, V[kk - 1], V[kk + 1], V[kk - W], V[kk + W], wu, wv,
            f[QCELLS] - f[5 * QCELLS], f[3 * QCELLS] - f[7 * QCELLS], afac,
            dfac);
        store<LAB>(out, o, plane, rhs0, rhs1, vo0, vo1, cfac, ih2);
    }
    __syncwarp();
    Q.ncell = Q.nreq = 0;
}

// The substage of one tile from its stage: each warp walks its RW rows
// (see the design note above), a lane holding its column's seven values
// around the row in registers for each component (rows j-3 .. j+3,
// rolled down a row at a time) and loading the row's six other x values.
// No barrier inside: warps return early where their columns or rows lie
// past the field. LAB: the single-op RHS's stage (load_lab) and results.
template <bool LAB, class TI, class TO, class R>
__device__ __forceinline__ void compute_tile(
        const R* st, R* queues, const Tile& T, int ny, int nx,
        const TI* __restrict__ vold, TO* __restrict__ out,
        R afac, R dfac, R cfac, R ih2) {
    constexpr unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wx = warp % WARPS_X, wy = warp / WARPS_X;
    const int x = T.x0 + wx * 32;        // the warp's first column
    const int y = T.y0 + wy * RW;        // and first row
    if (x >= nx || y >= ny) return;
    const int rows = min(RW, ny - y);
    const R* U = st;
    const R* V = st + CELLS;
    constexpr int X0 = LAB ? G : XO;     // the stage column of global x0
    const int k0 = (wy * RW + G) * W + wx * 32 + X0;   // lane 0, row 0
    Queue<R> Q;
    Q.cell = reinterpret_cast<int*>(queues + warp * QWORDS_OF<R>);
    Q.req = Q.cell + QCELLS;
    Q.val = reinterpret_cast<R*>(Q.req + QREQ);
    Q.ncell = Q.nreq = 0;

    // lane 0's left faces: lane k < RW holds row k of u, lane RW + k row k
    // of v, reconstructed with that row's own u sign
    R lb;
    {
        const int kb = k0 + (lane % RW) * W;
        const R* q = (lane < RW ? U : V) + kb;
        lb = cup2d::weno_face(U[kb] > (R)0.0, q[-3], q[-2], q[-1], q[0], q[1],
                              q[2]);
    }
    // the column windows at row 0, and its lower faces with its own v sign
    const int k = k0 + lane;
    R yu[2 * G + 1], yv[2 * G + 1];
#pragma unroll
    for (int m = 0; m <= 2 * G; ++m) {
        yu[m] = U[k + (m - G) * W];
        yv[m] = V[k + (m - G) * W];
    }
    bool py = yv[G] > (R)0.0;
    const cup2d::Weno5PartT<R> pd0 = cup2d::weno_face_part(
        py, yu[0], yu[1], yu[2], yu[3], yu[4], yu[5]);
    const cup2d::Weno5PartT<R> pd1 = cup2d::weno_face_part(
        py, yv[0], yv[1], yv[2], yv[3], yv[4], yv[5]);
    R d0 = cup2d::weno5_blend(pd0);
    R d1 = cup2d::weno5_blend(pd1);

    const size_t plane = (size_t)ny * nx;
    const size_t ob = (size_t)T.l * 2 * plane + (size_t)y * nx + x;
    const bool xin = x + lane < nx;
    const unsigned below = (1u << lane) - 1u;
    for (int j = 0; j < rows; ++j) {
        const int kj = k + j * W;
        if (j > 0) {
#pragma unroll
            for (int m = 0; m < 2 * G; ++m) {
                yu[m] = yu[m + 1];
                yv[m] = yv[m + 1];
            }
            yu[2 * G] = U[kj + G * W];
            yv[2 * G] = V[kj + G * W];
        }
        R xu[2 * G + 1], xv[2 * G + 1];
#pragma unroll
        for (int m = 0; m <= 2 * G; ++m) {
            xu[m] = m == G ? yu[G] : U[kj + m - G];
            xv[m] = m == G ? yv[G] : V[kj + m - G];
        }
        const size_t o = ob + (size_t)j * nx + lane;
        R vo0 = yu[G], vo1 = yv[G];
        if constexpr (!LAB) {
            if (vold != nullptr && xin) {
                vo0 = storage::widen(vold[o]);
                vo1 = storage::widen(vold[o + plane]);
            }
        }
        const R wu = yu[G], wv = yv[G];
        const bool px = wu > (R)0.0, pyj = wv > (R)0.0;
        // right and upper faces, with this cell's signs: the four parts,
        // then the four blends (weno.cuh)
        const cup2d::Weno5PartT<R> pr0 = cup2d::weno_face_part(
            px, xu[1], xu[2], xu[3], xu[4], xu[5], xu[6]);
        const cup2d::Weno5PartT<R> pr1 = cup2d::weno_face_part(
            px, xv[1], xv[2], xv[3], xv[4], xv[5], xv[6]);
        const cup2d::Weno5PartT<R> pt0 = cup2d::weno_face_part(
            pyj, yu[1], yu[2], yu[3], yu[4], yu[5], yu[6]);
        const cup2d::Weno5PartT<R> pt1 = cup2d::weno_face_part(
            pyj, yv[1], yv[2], yv[3], yv[4], yv[5], yv[6]);
        const R r0 = cup2d::weno5_blend(pr0);
        const R r1 = cup2d::weno5_blend(pr1);
        const R t0 = cup2d::weno5_blend(pt0);
        const R t1 = cup2d::weno5_blend(pt1);
        // left faces: the left lane's right faces (lane 0: the boundary
        // pass's); lower faces: the previous row's upper faces. A cell
        // whose sign differs from the neighbour's joins the queue
        const unsigned signs = __ballot_sync(FULL, px);
        R l0 = __shfl_up_sync(FULL, r0, 1);
        R l1 = __shfl_up_sync(FULL, r1, 1);
        const R b0 = __shfl_sync(FULL, lb, j);
        const R b1 = __shfl_sync(FULL, lb, j + RW);
        if (lane == 0) {
            l0 = b0;
            l1 = b1;
        }
        const bool xm = lane > 0 && xin
                        && ((signs >> (lane - 1)) & 1u) != (unsigned)px;
        const bool ym = j > 0 && xin && pyj != py;
        const unsigned bx = __ballot_sync(FULL, xm);
        const unsigned by = __ballot_sync(FULL, ym);
        if (bx | by) {
            const unsigned bc = bx | by;
            const int nc = __popc(bc);
            const int nr = 2 * (__popc(bx) + __popc(by));
            if (Q.ncell + nc > QCELLS || Q.nreq + nr > QREQ)
                flush_queue<LAB>(Q, U, V, k0, vold, out, ob, plane, nx, afac,
                                 dfac, cfac, ih2);
            if (xm || ym) {
                const int slot = Q.ncell + __popc(bc & below);
                Q.cell[slot] = (j << 5) | lane;
                R* f = Q.val + slot;
                f[0] = r0;
                f[QCELLS] = r1;
                f[2 * QCELLS] = t0;
                f[3 * QCELLS] = t1;
                f[4 * QCELLS] = l0;
                f[5 * QCELLS] = l1;
                f[6 * QCELLS] = d0;
                f[7 * QCELLS] = d1;
                int r = Q.nreq + 2 * (__popc(bx & below) + __popc(by & below));
                if (xm) {
                    Q.req[r++] = slot << 2;
                    Q.req[r++] = (slot << 2) | 1;
                }
                if (ym) {
                    Q.req[r++] = (slot << 2) | 2;
                    Q.req[r] = (slot << 2) | 3;
                }
            }
            Q.ncell += nc;
            Q.nreq += nr;
        }
        if (xin && !xm && !ym) {
            const R rhs0 = cup2d::advect_diffuse_rhs(
                yu[G], xu[G - 1], xu[G + 1], yu[G - 1], yu[G + 1], wu, wv,
                r0 - l0, t0 - d0, afac, dfac);
            const R rhs1 = cup2d::advect_diffuse_rhs(
                yv[G], xv[G - 1], xv[G + 1], yv[G - 1], yv[G + 1], wu, wv,
                r1 - l1, t1 - d1, afac, dfac);
            store<LAB>(out, o, plane, rhs0, rhs1, vo0, vo1, cfac, ih2);
        }
        py = pyj;
        d0 = t0;
        d1 = t1;
    }
    if (Q.ncell > 0)
        flush_queue<LAB>(Q, U, V, k0, vold, out, ob, plane, nx, afac, dfac,
                         cfac, ih2);
}

// Persistent CTAs over the tiles of all L members (v, vold, out
// [L, 2, ny, nx]; facs [L, 2] = (afac, dfac), with BC [L, 3] = (afac, dfac,
// dt); vold null: vold = v). aux null: a whole field, walled on both x
// sides. BC: the boundary table's ghosts (faces, h; a slab's first column
// is global column col0 of nx_tot, a whole field's 0 of nx). TI:
// the storage type of v, vold and aux; TO: that of out. An f32 instance
// copies by VEC (4: 16 bytes, 1: 4 bytes); a bf16 one (VEC 0) by its
// launch argument vec (4: 8 bytes, 1: 2 bytes). LAB (f32, VEC 0, not BC):
// the single-op RHS, v a lab [L, 2, ny + 6, nx + 6] copied by vec (2: 8
// bytes, 1: 4 bytes), facs [2] shared by the members, out = rhs. WRAP
// (f32 or f64, BC): the wrap form, the faces of kind PERIODIC making their
// axes wrap; of a slab (aux given), x comes from aux and only y wraps.
// f64 (TI = TO = double, VEC 2: 16 bytes, 1: 8 bytes): everything in f64,
// facs, cfac, ih2, h and faces too (R = storage::compute_t<TI>).
template <int VEC, bool BC, class TI, class TO, bool LAB = false,
          bool WRAP = false>
__global__ void __launch_bounds__(THREADS, substage_ctas<TI>)
substage_kernel(const TI* __restrict__ v, const TI* __restrict__ vold,
                const TI* __restrict__ aux, TO* __restrict__ out,
                const storage::compute_t<TI>* __restrict__ facs, int L,
                int ny, int nx, storage::compute_t<TI> cfac,
                storage::compute_t<TI> ih2, int is_lo, int is_hi,
                FacesT<storage::compute_t<TI>> faces,
                storage::compute_t<TI> h, int col0, int nx_tot, int vec) {
    using R = storage::compute_t<TI>;
    static_assert(!WRAP || (BC && !LAB && !storage::is_bf16<TI>),
                  "the wrap form is an f32 or f64 boundary-table substage");
    static_assert(!storage::is_f64<TI> || (!LAB && storage::is_f64<TO>),
                  "an f64 substage reads and writes f64");
    constexpr int FS = LAB ? 0 : BC ? 3 : 2;   // facs per member
    extern __shared__ float4 smem4[];
    R* smem = reinterpret_cast<R*>(smem4);
    const int tiles = L * ((ny + TY - 1) / TY) * ((nx + TX - 1) / TX);
    int t = blockIdx.x;
    if (t >= tiles) return;
    const bool wx = WRAP && faces.x_lo.kind == PERIODIC;
    const bool wy = WRAP && faces.y_lo.kind == PERIODIC;
    const bool wall_lo = (aux == nullptr || is_lo) && !wx;
    const bool wall_hi = (aux == nullptr || is_hi) && !wx;
    // a slab takes its x halo from aux (the ring's, along a periodic x):
    // only a whole field wraps x inside its own columns
    const bool lwx = wx && aux == nullptr;
    Tile T = tile_at(t, ny, nx);
    if constexpr (!storage::is_bf16<TI>) {
        if constexpr (LAB)
            load_lab(smem, v, T, ny, nx, vec == 2);
        else
            load_tile<VEC, WRAP>(smem, v, aux, T, ny, nx, is_lo, is_hi, lwx,
                                 wy);
        cp_commit();
        for (int s = 0; t < tiles; t += gridDim.x, s ^= 1) {
            R* st = smem + s * 2 * CELLS;
            const int nt = t + gridDim.x;
            Tile N = T;
            if (nt < tiles) {
                N = tile_at(nt, ny, nx);
                if constexpr (LAB)
                    load_lab(smem + (s ^ 1) * 2 * CELLS, v, N, ny, nx,
                             vec == 2);
                else
                    load_tile<VEC, WRAP>(smem + (s ^ 1) * 2 * CELLS, v, aux,
                                         N, ny, nx, is_lo, is_hi, lwx, wy);
            }
            cp_commit();
            cp_wait1();
            __syncthreads();
            if (!LAB && paints(T, ny, nx, wall_lo, wall_hi, wy)) {
                if constexpr (BC)
                    paint_ghosts_bc<WRAP>(st, T, ny, nx, faces,
                                          facs[FS * T.l + 2], h, col0,
                                          nx_tot, wall_lo, wall_hi, wx, wy);
                else
                    paint_ghosts(st, T, ny, nx, wall_lo, wall_hi);
            }
            compute_tile<LAB>(st, smem + 2 * 2 * CELLS, T, ny, nx, vold, out,
                              facs[FS * T.l], facs[FS * T.l + 1], cfac, ih2);
            __syncthreads();   // this stage is refilled by the next iteration
            T = N;
        }
        cp_wait0();
    } else {
        // one f32 stage, then the raw bf16 ring (the same bytes as the two
        // f32 stages), then the queues
        storage::bf16* raw = reinterpret_cast<storage::bf16*>(
            smem + 2 * CELLS);
        const bool vec4 = vec == 4;
        load_tile_bf16(raw, v, aux, T, ny, nx, is_lo, is_hi, vec4);
        cp_commit();
        for (int s = 0; t < tiles; t += gridDim.x, s ^= 1) {
            const int nt = t + gridDim.x;
            Tile N = T;
            if (nt < tiles) {
                N = tile_at(nt, ny, nx);
                load_tile_bf16(raw + (s ^ 1) * 2 * CELLS, v, aux, N, ny, nx,
                               is_lo, is_hi, vec4);
            }
            cp_commit();
            cp_wait1();
            __syncthreads();
            widen_stage(smem, raw + s * 2 * CELLS);
            __syncthreads();
            if (paints(T, ny, nx, wall_lo, wall_hi)) {
                if constexpr (BC)
                    paint_ghosts_bc(smem, T, ny, nx, faces,
                                    facs[FS * T.l + 2], h, col0, nx_tot,
                                    wall_lo, wall_hi);
                else
                    paint_ghosts(smem, T, ny, nx, wall_lo, wall_hi);
            }
            compute_tile<false>(smem, smem + 2 * 2 * CELLS, T, ny, nx, vold,
                                out, facs[FS * T.l], facs[FS * T.l + 1],
                                cfac, ih2);
            __syncthreads();   // the f32 stage is refilled next iteration
            T = N;
        }
        cp_wait0();
    }
}

// Launch on a stream: the grid's persistent CTAs, 1 .. the number of tiles.
// Returns the CUDA error code.
template <int VEC, bool BC, class TI, class TO, bool LAB = false,
          bool WRAP = false, class R = storage::compute_t<TI>>
int launch_vec(const TI* v, const TI* vold, const TI* aux, TO* out,
               const R* facs, int L, int ny, int nx, R cfac, R ih2,
               int is_lo, int is_hi, const FacesT<R>& fc, R h, int col0,
               int nx_tot, int vec, int grid, cudaStream_t st) {
    // above 48 KB of shared memory once per device (a bit per ordinal)
    static unsigned long long opted_in = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (!(dev < 64 && (opted_in >> dev & 1))) {
        err = cudaFuncSetAttribute(
            substage_kernel<VEC, BC, TI, TO, LAB, WRAP>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM<R>);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) opted_in |= 1ull << dev;
    }
    substage_kernel<VEC, BC, TI, TO, LAB, WRAP>
        <<<grid, THREADS, SMEM<R>, st>>>(
        v, vold, aux, out, facs, L, ny, nx, cfac, ih2, is_lo, is_hi, fc, h,
        col0, nx_tot, vec);
    return (int)cudaGetLastError();
}

// vec 4: 16-byte copies for f32 (nx a multiple of 4, v 16-byte aligned),
// 8-byte ones for bf16 (nx a multiple of 4, v 8-byte aligned); vec 2:
// 16-byte copies for f64 (nx even, v 16-byte aligned); vec 1: 4-byte
// copies for f32, 8-byte ones for f64, 2-byte loads for bf16. WRAP: the
// wrap form (f32 or f64).
template <bool BC, class TI, class TO, bool WRAP = false,
          class R = storage::compute_t<TI>>
int launch_form(const TI* v, const TI* vold, const TI* aux, TO* out,
                const R* facs, int L, int ny, int nx, R cfac, R ih2,
                int is_lo, int is_hi, const FacesT<R>& fc, R h, int col0,
                int nx_tot, int vec, int grid, void* stream) {
    if (L < 1 || ny < 1 || nx < 1 || grid < 1 || (vec == 4 && nx % 4)
            || (vec == 2 && nx % 2))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if constexpr (storage::is_f64<TI>) {
        if (vec == 2)
            return launch_vec<2, BC, TI, TO, false, WRAP>(
                v, vold, aux, out, facs, L, ny, nx, cfac, ih2, is_lo, is_hi,
                fc, h, col0, nx_tot, vec, grid, st);
        if (vec == 1)
            return launch_vec<1, BC, TI, TO, false, WRAP>(
                v, vold, aux, out, facs, L, ny, nx, cfac, ih2, is_lo, is_hi,
                fc, h, col0, nx_tot, vec, grid, st);
        return (int)cudaErrorInvalidValue;
    } else if constexpr (storage::is_f32<TI>) {
        if (vec == 4)
            return launch_vec<4, BC, TI, TO, false, WRAP>(
                v, vold, aux, out, facs, L, ny, nx, cfac, ih2, is_lo, is_hi,
                fc, h, col0, nx_tot, vec, grid, st);
        if (vec == 1)
            return launch_vec<1, BC, TI, TO, false, WRAP>(
                v, vold, aux, out, facs, L, ny, nx, cfac, ih2, is_lo, is_hi,
                fc, h, col0, nx_tot, vec, grid, st);
        return (int)cudaErrorInvalidValue;
    } else {
        if (vec != 4 && vec != 1) return (int)cudaErrorInvalidValue;
        return launch_vec<0, BC>(v, vold, aux, out, facs, L, ny, nx, cfac,
                                 ih2, is_lo, is_hi, fc, h, col0, nx_tot, vec,
                                 grid, st);
    }
}

// A bf16 substage (either form): v, vold, aux bf16; out bf16 where out_bf16
// (the first substage) else f32 (the second).
template <bool BC>
int launch_bf16(const void* v, const void* vold, const void* aux, void* out,
                const float* facs, int L, int ny, int nx, float cfac,
                float ih2, int is_lo, int is_hi, const Faces& fc, float h,
                int col0, int nx_tot, int out_bf16, int vec, int grid,
                void* stream) {
    using storage::bf16;
    const bf16* vb = static_cast<const bf16*>(v);
    const bf16* ob = static_cast<const bf16*>(vold);
    const bf16* ab = static_cast<const bf16*>(aux);
    if (out_bf16)
        return launch_form<BC>(vb, ob, ab, static_cast<bf16*>(out), facs, L,
                               ny, nx, cfac, ih2, is_lo, is_hi, fc, h, col0,
                               nx_tot, vec, grid, stream);
    return launch_form<BC>(vb, ob, ab, static_cast<float*>(out), facs, L, ny,
                           nx, cfac, ih2, is_lo, is_hi, fc, h, col0, nx_tot,
                           vec, grid, stream);
}

}  // namespace
}  // namespace substage
