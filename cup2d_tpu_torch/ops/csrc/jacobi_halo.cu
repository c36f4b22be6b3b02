// One damped-Jacobi sweep of the undivided zero-ghost 5-point Laplacian
// with the Neumann wall diagonal on the x slabs of a field split along x:
//   out = e + omega * (r - lap(e)) / d,   d = (ey + ex) - 4
// per slab e, r, out [L, ny, nxl] f32 (or all bf16). The column left of a
// slab and the column right of it come from an edge-column source each: a
// pointer and a row stride, member l's row y at src[(l * ny + y) * stride]
// (the left neighbour's last column and the right neighbour's first, read
// in place; or an aux [L, ny, 2] of the exchanged columns, stride 2); a
// null source is the zero ghost of a wall. ey is 1 on the first and last
// rows; ex is 1 on the first column only where is_lo, on the last only
// where is_hi, so the x-wall diagonal appears on the wall slabs alone.
// from_zero makes the sweep e = omega * r / d and reads neither e nor the
// edge sources (all may be null). The signed form puts a boundary table's
// pressure sign of the face in place of each 1 (sy_lo / sy_hi on the
// first / last row, sx_lo / sx_hi on the first / last column where
// is_lo / is_hi; -1 at a Dirichlet outflow face), in the diagonal and in
// lap's wall term alike.
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _jacobi_halo_kernel (reached
// from fused_jacobi_halo_sweep), Neumann walls, f32 and bf16 storage (the
// split hierarchy's sweeps under the FAS solver's bf16 legs). The signed
// forms have no TPU kernel of their own: the JAX package's signed
// hierarchies drop the halo sweep and run the signed _jacobi_strips_kernel
// on GSPMD-partitioned levels, so these slab sweeps stand for one signed
// sweep of that kernel, and equal jacobi.cu's signed single sweep bit for
// bit. C entries: a slab list (cup2d_jacobi_halo_sweep_slabs{,_bf16,
// _signed,_signed_bf16}: every slab of a card in one launch, each reading
// its neighbours' edge columns in place) and one slab with its aux
// (cup2d_jacobi_halo_sweep{,_bf16,_signed,_signed_bf16}: the per-slab
// sweep after an exchange, for slabs on different devices); both run the
// same kernel. The periodic tables (no Pallas form: the JAX package sweeps
// them on its XLA chain) run a y-wrap form of each (..._wrap, f32, signed:
// the y rows wrap inside the slab) where y is periodic, and the signed
// forms where only x is; along a periodic x the host passes no wall slab
// and closes the edge-column sources into a ring (slab 0's left source is
// the last slab's last column, the last slab's right source slab 0's
// first; one slab reads its own), so every slab sweeps as an interior one.
//
// Bound on this card: memory. A sweep reads e and r and writes the result,
// 12 bytes per cell (8 from zero; 6 and 4 in bf16), for 9 operations per
// cell.
//
// Design: one sweep per launch, as on the TPU: each sweep needs fresh
// neighbour columns, so the split chain cannot block sweeps in time as
// jacobi.cu does. One launch sweeps every slab and member of a list
// (blockIdx.z over member x slab); out never aliases any slab's e, since
// a slab reads its neighbours' e while they are written.
// - A thread owns a run of V consecutive cells of a row, one 16-byte word
//   (4 f32 or 8 bf16 values), and walks a strip of ry rows in y, rolling
//   the rows below, at and above its run through registers: each e and r
//   word is read once by a 16-byte load (the strip's first two rows of e
//   twice), one row ahead of its use so that the next row's loads are in
//   flight while a row is computed, and each result stored once by a
//   16-byte store. Consecutive lanes hold consecutive runs of a row, so a
//   warp reads whole lines.
// - The x neighbours at a run's ends come from the adjacent lanes by warp
//   shuffle; a lane whose neighbour run lies in another warp loads that
//   one value, and at a slab's edge it comes from the edge-column source.
// - Rows that are not whole 16-byte words, and operands not on 16-byte
//   boundaries (the narrow coarse levels, ragged shapes), take the same
//   walk with runs of one cell and scalar loads, chosen per slab.
// - ry is the longest strip (32 rows down to 1) that still gives the
//   launch 2048 threads per SM, a full SM's worth: the fine levels walk
//   long strips, a coarse level of a few hundred cells a row per thread,
//   so its latency is one row's. (At 1024 the bf16 finest level of 4
//   slabs of 2048 walked 32-row strips in about two waves of threads.)
// - Runs clear of the walls take the interior diagonal -4 with its exact
//   reciprocal -0.25, as jacobi.cu's interior tiles do; runs on a wall
//   row or column evaluate edge<SIGNED>() per cell.
// The per-cell expression is jacobi.cu's operand for operand (lap = xp +
// xm + yp + ym + cur * corr, then cur + omega * (rv - lap) * inv_d), so a
// split sweep equals jacobi.cu's single sweep bit for bit, Neumann or
// signed, f32 or bf16: bf16 operands are widened where they are read and
// the result rounded to bf16 once, as jacobi.cu rounds each sweep.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "storage.cuh"

// One slab of a slab list, as the host passes it. Outside the unnamed
// namespace: the C entries take a pointer to it.
namespace halo {

struct Slab {
    const void* e;       // [L, ny, nxl]; may be null from zero
    const void* r;
    void* out;
    const void* left;    // edge-column sources; null: the zero ghost
    const void* right;
    int nxl;
    int lstride, rstride;
    int is_lo, is_hi;
};

}  // namespace halo

namespace {

using storage::narrow;
using storage::widen;

constexpr int THREADS = 128;
constexpr int MAX_SLABS = 16;
constexpr int MAX_RY = 32;
constexpr int THREADS_PER_SM = 2048;   // the strip rule's target

// per-face edge signs (x_lo, x_hi, y_lo, y_hi)
struct Signs {
    float x_lo, x_hi, y_lo, y_hi;
};

// the slab list as the kernel takes it, by value, with each slab's run
// length in cells (V or 1)
struct Table {
    halo::Slab s[MAX_SLABS];
    int run[MAX_SLABS];
};

template <class ST>
constexpr int V = 16 / sizeof(ST);

// The wall indicator of a cell at the low (at_lo) or high (at_hi) end of
// an axis: the Neumann 1, or the face's sign (SIGNED); 0 elsewhere. At_lo
// wins where both hold, as jacobi.cu's edge() gives index 0 of n = 1.
template <bool SIGNED>
__device__ __forceinline__ float edge(bool at_lo, bool at_hi, float lo,
                                      float hi) {
    if constexpr (SIGNED)
        return at_lo ? lo : (at_hi ? hi : 0.0f);
    else
        return at_lo ? 1.0f : (at_hi ? 1.0f : 0.0f);
}

// A run of R values as loaded: one 16-byte word (R = V) or one value.
template <int R, class ST>
using Word = std::conditional_t<R == 1, ST, uint4>;

template <int R, class ST>
__device__ __forceinline__ Word<R, ST> load_word(const ST* p) {
    if constexpr (R == 1)
        return __ldg(p);
    else
        return __ldg(reinterpret_cast<const uint4*>(p));
}

// a loaded run, widened to f32
template <int R, class ST>
__device__ __forceinline__ void unpack(const Word<R, ST>& w, float (&v)[R]) {
    if constexpr (R == 1) {
        v[0] = widen(w);
    } else {
        const uint32_t u[4] = {w.x, w.y, w.z, w.w};
        if constexpr (storage::is_f32<ST>) {
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = __uint_as_float(u[j]);
        } else {
            // a bf16 is the high half of its f32: exact widening
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                v[2 * j] = __uint_as_float(u[j] << 16);
                v[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
            }
        }
    }
}

template <int R, class ST>
__device__ __forceinline__ void load_run(const ST* p, float (&v)[R]) {
    unpack<R, ST>(load_word<R, ST>(p), v);
}

template <int R, class ST>
__device__ __forceinline__ Word<R, ST> zero_word() {
    if constexpr (R == 1)
        return narrow<ST>(0.0f);
    else
        return make_uint4(0u, 0u, 0u, 0u);
}

// the first and the last value of a loaded run, widened
template <int R, class ST>
__device__ __forceinline__ float first_of(const Word<R, ST>& w) {
    if constexpr (R == 1)
        return widen(w);
    else if constexpr (storage::is_f32<ST>)
        return __uint_as_float(w.x);
    else
        return __uint_as_float(w.x << 16);
}

template <int R, class ST>
__device__ __forceinline__ float last_of(const Word<R, ST>& w) {
    if constexpr (R == 1)
        return widen(w);
    else if constexpr (storage::is_f32<ST>)
        return __uint_as_float(w.w);
    else
        return __uint_as_float(w.w & 0xffff0000u);
}

// a run of results, rounded once to the storage type and stored by one
// 16-byte store (R = V) or one value
template <int R, class ST>
__device__ __forceinline__ void store_run(ST* p, const float (&v)[R]) {
    if constexpr (R == 1) {
        p[0] = narrow<ST>(v[0]);
    } else {
        uint32_t u[4];
        if constexpr (storage::is_f32<ST>) {
#pragma unroll
            for (int j = 0; j < 4; ++j) u[j] = __float_as_uint(v[j]);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                // round to nearest even, low half first, as narrow<bf16>
                const __nv_bfloat162 b =
                    __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
                u[j] = *reinterpret_cast<const uint32_t*>(&b);
            }
        }
        *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    }
}

// One slab's share of the launch: thread t of the slab owns run k of the
// rows y0 .. y1 - 1 of member l, with runs of R cells. WRAPY: a periodic y,
// row 0's lower neighbour row ny - 1 and row ny - 1's upper neighbour row
// 0, and no y wall (the rows take the interior diagonal, as the y signs
// of a periodic axis are 0).
template <bool SIGNED, class ST, int R, bool WRAPY = false>
__device__ __forceinline__ void walk(const halo::Slab& S, int l, int ny,
                                     int ry, float omega, int from_zero,
                                     const Signs& sg) {
    const int nxl = S.nxl;
    const int runs = nxl / R;
    const int total = runs * ((ny + ry - 1) / ry);
    const int t = blockIdx.x * THREADS + threadIdx.x;
    const int lane = threadIdx.x & 31;
    if (t - lane >= total) return;            // the whole warp is past it
    const bool act = t < total;
    const int s = act ? t / runs : 0;
    const int k = act ? t - s * runs : 0;
    const int c0 = k * R;
    const int y0 = s * ry;
    const int y1 = min(y0 + ry, ny);
    const size_t plane = (size_t)l * ny;
    const ST* r = static_cast<const ST*>(S.r);
    ST* out = static_cast<ST*>(S.out);
    const bool xedge = (S.is_lo && c0 == 0) || (S.is_hi && c0 + R >= nxl);

    if (from_zero) {
        for (int y = y0; act && y < y1; ++y) {
            const size_t row = (plane + y) * nxl + c0;
            float rv[R], o[R];
            load_run<R>(r + row, rv);
            const bool wall = xedge || (!WRAPY && (y == 0 || y == ny - 1));
#pragma unroll
            for (int j = 0; j < R; ++j) {
                float inv_d = -0.25f;             // 1 / -4, exact
                if (wall) {
                    const int c = c0 + j;
                    float exv = edge<SIGNED>(c == 0 && S.is_lo,
                                             c == nxl - 1 && S.is_hi,
                                             sg.x_lo, sg.x_hi);
                    float eyv = edge<SIGNED>(y == 0, y == ny - 1, sg.y_lo,
                                             sg.y_hi);
                    float corr = (eyv + exv) - 4.0f;
                    inv_d = 1.0f / corr;
                }
                o[j] = omega * rv[j] * inv_d;
            }
            store_run<R>(out + row, o);
        }
        return;
    }

    const ST* e = static_cast<const ST*>(S.e);
    const ST* left = static_cast<const ST*>(S.left);
    const ST* right = static_cast<const ST*>(S.right);
    // the rows below and at the run, and the next row of e (y + 1) and of
    // r (y), loaded one row ahead of their use, all kept as loaded (a
    // bf16 word holds 8 values in 4 registers) and widened where used
    using W = Word<R, ST>;
    const W zero = zero_word<R, ST>();
    W wm = zero, wc = zero, wn = zero, wr = zero;
    if (act) {
        const size_t row = (plane + y0) * nxl + c0;
        if (y0 > 0)
            wm = load_word<R>(e + row - nxl);
        else if (WRAPY)
            wm = load_word<R>(e + (plane + ny - 1) * nxl + c0);
        wc = load_word<R>(e + row);
        wr = load_word<R>(r + row);
        if (y0 + 1 < ny)
            wn = load_word<R>(e + row + nxl);
        else if (WRAPY)
            wn = load_word<R>(e + plane * nxl + c0);
    }
    // every lane walks ry rows, so the shuffles stay convergent
    for (int i = 0; i < ry; ++i) {
        const int y = y0 + i;
        const bool on = act && y < y1;
        const size_t row = (plane + y) * nxl + c0;
        const W wp = on && (WRAPY || y + 1 < ny) ? wn : zero;
        const W wrow = wr;
        if (act && y + 1 < y1) {
            wr = load_word<R>(r + row + nxl);
            if (y + 2 < ny)
                wn = load_word<R>(e + row + 2 * nxl);
            else if (WRAPY)
                wn = load_word<R>(e + plane * nxl + c0);   // row 0
        }
        float xl = __shfl_up_sync(0xffffffffu, last_of<R, ST>(wc), 1);
        float xr = __shfl_down_sync(0xffffffffu, first_of<R, ST>(wc), 1);
        if (on) {
            if (k == 0)
                xl = left ? widen(__ldg(left + (plane + y) * S.lstride))
                          : 0.0f;
            else if (lane == 0)
                xl = widen(__ldg(e + row - 1));
            if (k == runs - 1)
                xr = right ? widen(__ldg(right + (plane + y) * S.rstride))
                           : 0.0f;
            else if (lane == 31)
                xr = widen(__ldg(e + row + R));
            float ym[R], cur[R], yp[R], rv[R];
            unpack<R, ST>(wm, ym);
            unpack<R, ST>(wc, cur);
            unpack<R, ST>(wp, yp);
            unpack<R, ST>(wrow, rv);
            const bool wall = xedge || (!WRAPY && (y == 0 || y == ny - 1));
            float o[R];
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const float xp = j + 1 < R ? cur[j + 1] : xr;
                const float xm = j > 0 ? cur[j - 1] : xl;
                float corr = -4.0f, inv_d = -0.25f;   // 1 / -4, exact
                if (wall) {
                    const int c = c0 + j;
                    float exv = edge<SIGNED>(c == 0 && S.is_lo,
                                             c == nxl - 1 && S.is_hi,
                                             sg.x_lo, sg.x_hi);
                    float eyv = edge<SIGNED>(y == 0, y == ny - 1, sg.y_lo,
                                             sg.y_hi);
                    corr = (eyv + exv) - 4.0f;
                    inv_d = 1.0f / corr;
                }
                float lap = xp + xm + yp[j] + ym[j] + cur[j] * corr;
                o[j] = cur[j] + omega * (rv[j] - lap) * inv_d;
            }
            store_run<R>(out + row, o);
        }
        wm = wc;
        wc = wp;
    }
}

template <bool SIGNED, class ST, bool WRAPY>
__global__ void __launch_bounds__(THREADS)
jacobi_halo_kernel(const Table tab, int D, int ny, int ry, float omega,
                   int from_zero, Signs sg) {
    const int d = blockIdx.z % D;
    const int l = blockIdx.z / D;
    const halo::Slab S = tab.s[d];
    if (tab.run[d] == V<ST>)
        walk<SIGNED, ST, V<ST>, WRAPY>(S, l, ny, ry, omega, from_zero, sg);
    else
        walk<SIGNED, ST, 1, WRAPY>(S, l, ny, ry, omega, from_zero, sg);
}

int sm_count() {
    static int sms[64] = {0};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (dev < 64 && sms[dev]) return sms[dev];
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess)
        return 0;
    if (dev < 64) sms[dev] = n;
    return n;
}

bool aligned16(const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The launch plan: each slab's run length (V where its rows are whole
// 16-byte words and its operands start on 16-byte boundaries, else 1),
// the strip length ry and the grid, then the launch.
template <bool SIGNED, class ST, bool WRAPY = false>
int launch(const halo::Slab* slabs, int D, int L, int ny, float omega,
           int from_zero, Signs sg, void* stream) {
    if (D < 1 || D > MAX_SLABS || L < 1 || ny < 1 || (long)L * D > 65535)
        return (int)cudaErrorInvalidValue;
    Table tab;
    long long runs = 0, widest = 0;
    for (int d = 0; d < D; ++d) {
        const halo::Slab& S = slabs[d];
        if (S.nxl < 1 || S.r == nullptr || S.out == nullptr
                || (!from_zero && S.e == nullptr))
            return (int)cudaErrorInvalidValue;
        tab.s[d] = S;
        const bool vec = S.nxl % V<ST> == 0 && aligned16(S.r)
                         && aligned16(S.out) && (from_zero || aligned16(S.e));
        tab.run[d] = vec ? V<ST> : 1;
        const long long n = S.nxl / tab.run[d];
        runs += n;
        widest = n > widest ? n : widest;
    }
    const int sms = sm_count();
    if (sms < 1) return (int)cudaErrorInvalidDevice;
    int ry = MAX_RY;
    while (ry > 1 && runs * L * ((ny + ry - 1) / ry)
                         < (long long)THREADS_PER_SM * sms)
        ry /= 2;
    const long long blocks =
        (widest * ((ny + ry - 1) / ry) + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL / THREADS) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)blocks, 1, (unsigned)(L * D));
    jacobi_halo_kernel<SIGNED, ST, WRAPY><<<grid, THREADS, 0,
                                            (cudaStream_t)stream>>>(
        tab, D, ny, ry, omega, from_zero, sg);
    return (int)cudaGetLastError();
}

// one slab with its aux [L, ny, 2] as the edge-column sources (stride 2)
template <bool SIGNED, class ST, bool WRAPY = false>
int launch_aux(const void* e, const void* r, const void* aux, void* out,
               int L, int ny, int nxl, float omega, int is_lo, int is_hi,
               int from_zero, Signs sg, void* stream) {
    const ST* a = static_cast<const ST*>(aux);
    halo::Slab S{e, r, out, a, a ? a + 1 : nullptr, nxl, 2, 2, is_lo,
                 is_hi};
    return launch<SIGNED, ST, WRAPY>(&S, 1, L, ny, omega, from_zero, sg,
                                     stream);
}

constexpr Signs NEUMANN{1.0f, 1.0f, 1.0f, 1.0f};

}  // namespace

using storage::bf16;

// The slab list: D slabs (at most 16) of L members of ny rows, every one
// on the current device, swept in one launch.
extern "C" int cup2d_jacobi_halo_sweep_slabs(const halo::Slab* slabs, int D,
                                             int L, int ny, float omega,
                                             int from_zero, void* stream) {
    return launch<false, float>(slabs, D, L, ny, omega, from_zero, NEUMANN,
                                stream);
}

extern "C" int cup2d_jacobi_halo_sweep_slabs_bf16(const halo::Slab* slabs,
                                                  int D, int L, int ny,
                                                  float omega, int from_zero,
                                                  void* stream) {
    return launch<false, bf16>(slabs, D, L, ny, omega, from_zero, NEUMANN,
                               stream);
}

// The signed forms: es_* the table's pressure signs (bc.pressure_signs)
extern "C" int cup2d_jacobi_halo_sweep_slabs_signed(
        const halo::Slab* slabs, int D, int L, int ny, float omega,
        int from_zero, float es_x_lo, float es_x_hi, float es_y_lo,
        float es_y_hi, void* stream) {
    return launch<true, float>(slabs, D, L, ny, omega, from_zero,
                               Signs{es_x_lo, es_x_hi, es_y_lo, es_y_hi},
                               stream);
}

extern "C" int cup2d_jacobi_halo_sweep_slabs_signed_bf16(
        const halo::Slab* slabs, int D, int L, int ny, float omega,
        int from_zero, float es_x_lo, float es_x_hi, float es_y_lo,
        float es_y_hi, void* stream) {
    return launch<true, bf16>(slabs, D, L, ny, omega, from_zero,
                              Signs{es_x_lo, es_x_hi, es_y_lo, es_y_hi},
                              stream);
}

// One slab: e, r, aux, out (aux [L, ny, 2]: the column left of the slab,
// then the column right of it, zeros where the slab owns a wall).
extern "C" int cup2d_jacobi_halo_sweep(const float* e, const float* r,
                                       const float* aux, float* out, int L,
                                       int ny, int nxl, float omega,
                                       int is_lo, int is_hi, int from_zero,
                                       void* stream) {
    return launch_aux<false, float>(e, r, aux, out, L, ny, nxl, omega,
                                    is_lo, is_hi, from_zero, NEUMANN, stream);
}

// The bf16 form: e, r, aux, out bf16.
extern "C" int cup2d_jacobi_halo_sweep_bf16(const void* e, const void* r,
                                            const void* aux, void* out,
                                            int L, int ny, int nxl,
                                            float omega, int is_lo,
                                            int is_hi, int from_zero,
                                            void* stream) {
    return launch_aux<false, bf16>(e, r, aux, out, L, ny, nxl, omega, is_lo,
                                   is_hi, from_zero, NEUMANN, stream);
}

extern "C" int cup2d_jacobi_halo_sweep_signed(
        const float* e, const float* r, const float* aux, float* out, int L,
        int ny, int nxl, float omega, int is_lo, int is_hi, int from_zero,
        float es_x_lo, float es_x_hi, float es_y_lo, float es_y_hi,
        void* stream) {
    return launch_aux<true, float>(e, r, aux, out, L, ny, nxl, omega, is_lo,
                                   is_hi, from_zero,
                                   Signs{es_x_lo, es_x_hi, es_y_lo, es_y_hi},
                                   stream);
}

extern "C" int cup2d_jacobi_halo_sweep_signed_bf16(
        const void* e, const void* r, const void* aux, void* out, int L,
        int ny, int nxl, float omega, int is_lo, int is_hi, int from_zero,
        float es_x_lo, float es_x_hi, float es_y_lo, float es_y_hi,
        void* stream) {
    return launch_aux<true, bf16>(e, r, aux, out, L, ny, nxl, omega, is_lo,
                                  is_hi, from_zero,
                                  Signs{es_x_lo, es_x_hi, es_y_lo, es_y_hi},
                                  stream);
}

// The y-wrap forms of a periodic table (f32; y periodic: es_y_lo = es_y_hi
// = 0): the slab list, whose edge-column sources close into a ring where x
// is periodic too, and one slab with its aux (the ring's exchange).
extern "C" int cup2d_jacobi_halo_sweep_slabs_wrap(
        const halo::Slab* slabs, int D, int L, int ny, float omega,
        int from_zero, float es_x_lo, float es_x_hi, float es_y_lo,
        float es_y_hi, void* stream) {
    if (es_y_lo != 0.0f || es_y_hi != 0.0f)
        return (int)cudaErrorInvalidValue;
    return launch<true, float, true>(
        slabs, D, L, ny, omega, from_zero,
        Signs{es_x_lo, es_x_hi, es_y_lo, es_y_hi}, stream);
}

extern "C" int cup2d_jacobi_halo_sweep_wrap(
        const float* e, const float* r, const float* aux, float* out, int L,
        int ny, int nxl, float omega, int is_lo, int is_hi, int from_zero,
        float es_x_lo, float es_x_hi, float es_y_lo, float es_y_hi,
        void* stream) {
    if (es_y_lo != 0.0f || es_y_hi != 0.0f)
        return (int)cudaErrorInvalidValue;
    return launch_aux<true, float, true>(
        e, r, aux, out, L, ny, nxl, omega, is_lo, is_hi, from_zero,
        Signs{es_x_lo, es_x_hi, es_y_lo, es_y_hi}, stream);
}
