// One Heun substage of WENO5 advection plus diffusion on a free-slip box,
// whole (advect_heun.cu) or as one x slab of a split field
// (advect_heun_halo.cu): the tile geometry, the loader with its ghost
// painting and the compute core the two kernels share. They differ only
// in what the loader is given: the solo kernel no aux and both x walls,
// the halo kernel its neighbours' edge columns and the walls it owns.
//
//   out = vold + cfac * rhs * ih2,
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
// - Each face is cup2d::weno_face on the operands weno_derivative gives
//   it, and t1 - t2, the Laplacian, the RHS and the update keep their
//   expression order and fused multiply-adds (the update is vold +
//   cfac * rhs * ih2 as one fma of cfac * rhs), so the result is the
//   per-cell kernel's bit for bit. A lane holds its column's seven values
//   per component in registers, rolled down a row at a time, and loads
//   the row's six other x values: seven shared loads per cell and
//   component.
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

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "weno.cuh"

// Internal linkage in each source that includes this: two libraries that
// shared these templates would also share launch_vec's opt-in flag (a
// static local of a template is one object per process), and the second
// would launch without its own shared-memory opt-in.
namespace substage {
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
// two stages of (u, v) and the warps' queues
constexpr size_t SMEM = sizeof(float) * (2 * 2 * CELLS + WARPS * QWORDS);
constexpr int CTAS_PER_SM = 2;
static_assert(2 * RW <= 32, "the boundary pass puts both components of a "
                            "warp's rows on its 32 lanes");
static_assert(TX % 32 == 0 && W % 4 == 0 && CELLS % 4 == 0,
              "16-byte copies need whole 16-byte rows and stages");

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

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
    uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    if (VEC == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
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
// then nx..nx+2). Shared column i holds global x0 - XO + i.
template <int VEC>
__device__ __forceinline__ void load_tile(float* st, const float* v,
                                          const float* aux, const Tile& T,
                                          int ny, int nx, int is_lo,
                                          int is_hi) {
    const size_t plane = (size_t)ny * nx;
    const float* src = v + (size_t)T.l * 2 * plane;
    constexpr int CW = W / VEC;          // copies per shared row
    for (int q = threadIdx.x; q < 2 * H * CW; q += THREADS) {
        const int row = q / CW;          // component c, row j
        const int c = row >= H;
        const int j = row - c * H;
        const int i = (q - row * CW) * VEC;
        const int gy = T.y0 - G + j, gx = T.x0 - XO + i;
        if (gy < 0 || gy >= ny || gx < 0 || gx >= nx) continue;
        cp_async<VEC>(st + c * CELLS + j * W + i,
                      src + c * plane + (size_t)gy * nx + gx);
    }
    if (aux == nullptr) return;
    const bool lo = T.x0 == 0 && !is_lo;
    const bool hi = T.x0 - XO + W > nx && !is_hi;
    if (!lo && !hi) return;
    const float* a = aux + (size_t)T.l * 2 * ny * 2 * G;
    for (int q = threadIdx.x; q < 2 * H * 2 * G; q += THREADS) {
        const int row = q / (2 * G), k = q - row * (2 * G);
        const int c = row >= H;
        const int j = row - c * H;
        const int gy = T.y0 - G + j;
        const int gx = k < G ? k - G : nx + k - G;
        const int i = gx - T.x0 + XO;
        if (gy < 0 || gy >= ny || !(k < G ? lo : hi) || i >= W) continue;
        cp_async<1>(st + c * CELLS + j * W + i,
                    a + ((size_t)c * ny + gy) * 2 * G + k);
    }
}

// True where the cells a tile's outputs read (3 rows and columns around
// it) leave the field across a y wall or a walled x side: the tile then
// paints ghosts (a slab's other x sides come from aux).
__device__ __forceinline__ bool paints(const Tile& T, int ny, int nx,
                                       bool wall_lo, bool wall_hi) {
    return T.y0 < G || T.y0 + TY + G > ny || (wall_lo && T.x0 < G)
           || (wall_hi && T.x0 + TX + G > nx);
}

// Paint the free-slip ghosts of a stage whose copies have landed: the y
// ghosts over every column, then the x ghosts of the walled sides from
// the y-completed edge column. Ends synchronised.
__device__ __forceinline__ void paint_ghosts(float* st, const Tile& T,
                                             int ny, int nx, bool wall_lo,
                                             bool wall_hi) {
    float* u = st;
    float* w = st + CELLS;
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

// A warp's queue of deferred cells in shared memory: cells whose left x or
// lower y face splits between two wind signs, so that the face its
// neighbour reconstructed is not the one it needs.
struct Queue {
    int* cell;     // (row << 5) | lane
    int* req;      // (slot << 2) | (dir << 1) | component; dir 1: y
    float* val;    // [8][QCELLS]: r0 r1 t0 t1 l0 l1 d0 d1 of each slot
    int ncell, nreq;
};

// Finish the queued cells: each lane reconstructs queued faces (a cell's
// left x or lower y face, with the cell's own sign), then finishes one
// queued cell as the row walk finishes the others. Leaves it empty.
__device__ __forceinline__ void flush_queue(
        Queue& Q, const float* U, const float* V, int k0,
        const float* __restrict__ vold, float* __restrict__ out, size_t ob,
        size_t plane, int nx, float afac, float dfac, float cfac,
        float ih2) {
    const int lane = threadIdx.x & 31;
    __syncwarp();
    for (int r = lane; r < Q.nreq; r += 32) {
        const int req = Q.req[r];
        const int slot = req >> 2, dir = (req >> 1) & 1, comp = req & 1;
        const int cell = Q.cell[slot];
        const int kk = k0 + (cell >> 5) * W + (cell & 31);
        const int s = dir ? W : 1;
        const float* q = (comp ? V : U) + kk;
        const bool pos = (dir ? V : U)[kk] > 0.0f;
        Q.val[(4 + 2 * dir + comp) * QCELLS + slot] = cup2d::weno_face(
            pos, q[-3 * s], q[-2 * s], q[-s], q[0], q[s], q[2 * s]);
    }
    __syncwarp();
    if (lane < Q.ncell) {
        const int cell = Q.cell[lane];
        const int kk = k0 + (cell >> 5) * W + (cell & 31);
        const float* f = Q.val + lane;
        const size_t o = ob + (size_t)(cell >> 5) * nx + (cell & 31);
        const float wu = U[kk], wv = V[kk];
        const float vo0 = vold != nullptr ? vold[o] : wu;
        const float vo1 = vold != nullptr ? vold[o + plane] : wv;
        const float rhs0 = cup2d::advect_diffuse_rhs(
            wu, U[kk - 1], U[kk + 1], U[kk - W], U[kk + W], wu, wv,
            f[0] - f[4 * QCELLS], f[2 * QCELLS] - f[6 * QCELLS], afac, dfac);
        const float rhs1 = cup2d::advect_diffuse_rhs(
            wv, V[kk - 1], V[kk + 1], V[kk - W], V[kk + W], wu, wv,
            f[QCELLS] - f[5 * QCELLS], f[3 * QCELLS] - f[7 * QCELLS], afac,
            dfac);
        out[o] = __fmaf_rn(cfac * rhs0, ih2, vo0);
        out[o + plane] = __fmaf_rn(cfac * rhs1, ih2, vo1);
    }
    __syncwarp();
    Q.ncell = Q.nreq = 0;
}

// The substage of one tile from its stage: each warp walks its RW rows
// (see the design note above), a lane holding its column's seven values
// around the row in registers for each component (rows j-3 .. j+3,
// rolled down a row at a time) and loading the row's six other x values.
// No barrier inside: warps return early where their columns or rows lie
// past the field.
__device__ __forceinline__ void compute_tile(
        const float* st, float* queues, const Tile& T, int ny, int nx,
        const float* __restrict__ vold, float* __restrict__ out,
        float afac, float dfac, float cfac, float ih2) {
    constexpr unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wx = warp % WARPS_X, wy = warp / WARPS_X;
    const int x = T.x0 + wx * 32;        // the warp's first column
    const int y = T.y0 + wy * RW;        // and first row
    if (x >= nx || y >= ny) return;
    const int rows = min(RW, ny - y);
    const float* U = st;
    const float* V = st + CELLS;
    const int k0 = (wy * RW + G) * W + wx * 32 + XO;   // lane 0, row 0
    Queue Q;
    Q.cell = reinterpret_cast<int*>(queues + warp * QWORDS);
    Q.req = Q.cell + QCELLS;
    Q.val = reinterpret_cast<float*>(Q.req + QREQ);
    Q.ncell = Q.nreq = 0;

    // lane 0's left faces: lane k < RW holds row k of u, lane RW + k row k
    // of v, reconstructed with that row's own u sign
    float lb;
    {
        const int kb = k0 + (lane % RW) * W;
        const float* q = (lane < RW ? U : V) + kb;
        lb = cup2d::weno_face(U[kb] > 0.0f, q[-3], q[-2], q[-1], q[0], q[1],
                              q[2]);
    }
    // the column windows at row 0, and its lower faces with its own v sign
    const int k = k0 + lane;
    float yu[2 * G + 1], yv[2 * G + 1];
#pragma unroll
    for (int m = 0; m <= 2 * G; ++m) {
        yu[m] = U[k + (m - G) * W];
        yv[m] = V[k + (m - G) * W];
    }
    bool py = yv[G] > 0.0f;
    const cup2d::Weno5Part pd0 = cup2d::weno_face_part(
        py, yu[0], yu[1], yu[2], yu[3], yu[4], yu[5]);
    const cup2d::Weno5Part pd1 = cup2d::weno_face_part(
        py, yv[0], yv[1], yv[2], yv[3], yv[4], yv[5]);
    float d0 = cup2d::weno5_blend(pd0);
    float d1 = cup2d::weno5_blend(pd1);

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
        float xu[2 * G + 1], xv[2 * G + 1];
#pragma unroll
        for (int m = 0; m <= 2 * G; ++m) {
            xu[m] = m == G ? yu[G] : U[kj + m - G];
            xv[m] = m == G ? yv[G] : V[kj + m - G];
        }
        const size_t o = ob + (size_t)j * nx + lane;
        float vo0 = yu[G], vo1 = yv[G];
        if (vold != nullptr && xin) {
            vo0 = vold[o];
            vo1 = vold[o + plane];
        }
        const float wu = yu[G], wv = yv[G];
        const bool px = wu > 0.0f, pyj = wv > 0.0f;
        // right and upper faces, with this cell's signs: the four parts,
        // then the four blends (weno.cuh)
        const cup2d::Weno5Part pr0 = cup2d::weno_face_part(
            px, xu[1], xu[2], xu[3], xu[4], xu[5], xu[6]);
        const cup2d::Weno5Part pr1 = cup2d::weno_face_part(
            px, xv[1], xv[2], xv[3], xv[4], xv[5], xv[6]);
        const cup2d::Weno5Part pt0 = cup2d::weno_face_part(
            pyj, yu[1], yu[2], yu[3], yu[4], yu[5], yu[6]);
        const cup2d::Weno5Part pt1 = cup2d::weno_face_part(
            pyj, yv[1], yv[2], yv[3], yv[4], yv[5], yv[6]);
        const float r0 = cup2d::weno5_blend(pr0);
        const float r1 = cup2d::weno5_blend(pr1);
        const float t0 = cup2d::weno5_blend(pt0);
        const float t1 = cup2d::weno5_blend(pt1);
        // left faces: the left lane's right faces (lane 0: the boundary
        // pass's); lower faces: the previous row's upper faces. A cell
        // whose sign differs from the neighbour's joins the queue
        const unsigned signs = __ballot_sync(FULL, px);
        float l0 = __shfl_up_sync(FULL, r0, 1);
        float l1 = __shfl_up_sync(FULL, r1, 1);
        const float b0 = __shfl_sync(FULL, lb, j);
        const float b1 = __shfl_sync(FULL, lb, j + RW);
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
                flush_queue(Q, U, V, k0, vold, out, ob, plane, nx, afac,
                            dfac, cfac, ih2);
            if (xm || ym) {
                const int slot = Q.ncell + __popc(bc & below);
                Q.cell[slot] = (j << 5) | lane;
                float* f = Q.val + slot;
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
            const float rhs0 = cup2d::advect_diffuse_rhs(
                yu[G], xu[G - 1], xu[G + 1], yu[G - 1], yu[G + 1], wu, wv,
                r0 - l0, t0 - d0, afac, dfac);
            const float rhs1 = cup2d::advect_diffuse_rhs(
                yv[G], xv[G - 1], xv[G + 1], yv[G - 1], yv[G + 1], wu, wv,
                r1 - l1, t1 - d1, afac, dfac);
            out[o] = __fmaf_rn(cfac * rhs0, ih2, vo0);
            out[o + plane] = __fmaf_rn(cfac * rhs1, ih2, vo1);
        }
        py = pyj;
        d0 = t0;
        d1 = t1;
    }
    if (Q.ncell > 0)
        flush_queue(Q, U, V, k0, vold, out, ob, plane, nx, afac, dfac, cfac,
                    ih2);
}

// Persistent CTAs over the tiles of all L members (v, vold, out
// [L, 2, ny, nx]; facs [L, 2] = (afac, dfac); vold null: vold = v).
// aux null: a whole field, walled on both x sides.
template <int VEC>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
substage_kernel(const float* __restrict__ v, const float* __restrict__ vold,
                const float* __restrict__ aux, float* __restrict__ out,
                const float* __restrict__ facs, int L, int ny, int nx,
                float cfac, float ih2, int is_lo, int is_hi) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int tiles = L * ((ny + TY - 1) / TY) * ((nx + TX - 1) / TX);
    int t = blockIdx.x;
    if (t >= tiles) return;
    const bool wall_lo = aux == nullptr || is_lo;
    const bool wall_hi = aux == nullptr || is_hi;
    Tile T = tile_at(t, ny, nx);
    load_tile<VEC>(smem, v, aux, T, ny, nx, is_lo, is_hi);
    cp_commit();
    for (int s = 0; t < tiles; t += gridDim.x, s ^= 1) {
        float* st = smem + s * 2 * CELLS;
        const int nt = t + gridDim.x;
        Tile N = T;
        if (nt < tiles) {
            N = tile_at(nt, ny, nx);
            load_tile<VEC>(smem + (s ^ 1) * 2 * CELLS, v, aux, N, ny, nx,
                           is_lo, is_hi);
        }
        cp_commit();
        cp_wait1();
        __syncthreads();
        if (paints(T, ny, nx, wall_lo, wall_hi))
            paint_ghosts(st, T, ny, nx, wall_lo, wall_hi);
        compute_tile(st, smem + 2 * 2 * CELLS, T, ny, nx, vold, out,
                     facs[2 * T.l], facs[2 * T.l + 1], cfac, ih2);
        __syncthreads();   // this stage is refilled by the next iteration
        T = N;
    }
    cp_wait0();
}

// Launch on a stream: vec 4 for 16-byte copies (nx a multiple of 4, v
// 16-byte aligned), 1 for 4-byte ones; grid the persistent CTAs, 1 .. the
// number of tiles. Returns the CUDA error code.
template <int VEC>
int launch_vec(const float* v, const float* vold, const float* aux,
               float* out, const float* facs, int L, int ny, int nx,
               float cfac, float ih2, int is_lo, int is_hi, int grid,
               cudaStream_t st) {
    // above 48 KB of shared memory once per device (a bit per ordinal)
    static unsigned long long opted_in = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (!(dev < 64 && (opted_in >> dev & 1))) {
        err = cudaFuncSetAttribute(
            substage_kernel<VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) opted_in |= 1ull << dev;
    }
    substage_kernel<VEC><<<grid, THREADS, SMEM, st>>>(
        v, vold, aux, out, facs, L, ny, nx, cfac, ih2, is_lo, is_hi);
    return (int)cudaGetLastError();
}

int launch(const float* v, const float* vold, const float* aux,
                  float* out, const float* facs, int L, int ny, int nx,
                  float cfac, float ih2, int is_lo, int is_hi, int vec,
                  int grid, void* stream) {
    if (L < 1 || ny < 1 || nx < 1 || grid < 1 || (vec == 4 && nx % 4))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (vec == 4)
        return launch_vec<4>(v, vold, aux, out, facs, L, ny, nx, cfac, ih2,
                             is_lo, is_hi, grid, st);
    if (vec == 1)
        return launch_vec<1>(v, vold, aux, out, facs, L, ny, nx, cfac, ih2,
                             is_lo, is_hi, grid, st);
    return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace substage
