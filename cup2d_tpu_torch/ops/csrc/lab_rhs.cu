// WENO5 advection plus diffusion RHS over pre-assembled forest labs:
//   out[n, c] = afac_n * (u . grad) q_c + dfac_n * lap(q_c)   (undivided)
// for lab [N, 2, 14, 14] f32 (BS 8, 3 ghost cells), h [N] f32 per block,
// dt a device f32 scalar and nu a float: afac_n = -dt*h_n, dfac = nu*dt,
// in f32 as the plain version forms them; out [N, 2, 8, 8] f32. Pad rows
// (h = 1, stale but finite data) are computed like the rest; the caller
// masks them.
//
// Replaces: cup2d_tpu/ops/pallas_kernels.py _lab_kernel (reached from
// fused_lab_rhs), f32; and the JAX package's XLA chain at x64
// (advect_diffuse_rhs over the labs, which its Pallas gate
// lab_tier_supported sends f64 state to): cup2d_lab_rhs_f64, lab, h, dt,
// nu and out f64, the same kernel on the arithmetic type T (weno.cuh's f64
// form), 4 labs a CTA (BPC): the labs and faces of 8 would take 61 KB of
// static shared memory, past the 48 KB a static array may hold.
//
// Bound on this card: per block 2 x 196 lab values read and 2 x 64 RHS
// values written (2084 bytes with h). The arithmetic is the WENO
// reconstructions, 88 operations each: a block needs 9 faces a row and a
// column per component where the per-cell form reconstructs 16, so with
// each face reconstructed once (twice where its two cells' winds differ in
// sign) a block is ~27,000 operations, ~13 per byte, under the H100's f32
// balance point (~20 per byte at 67 TFLOP/s and 3.35 TB/s): memory bounds
// it, the arithmetic close behind.
//
// Design: the Pallas kernel streams chunks of whole labs through VMEM and
// evaluates the shared advect_diffuse_core on them. Here a CTA of 288
// threads takes BPC = 8 consecutive labs (12.5 KB, contiguous), and works
// in four passes over shared memory:
// 1. the labs arrive by 16-byte cp.async (4-byte where the labs do not
//    start on a 16-byte boundary); dt and each lab's h are read once, into
//    afac and dfac;
// 2. a face pass: a face slot is an axis, a component, a line of the
//    block and a face 0..8 along it, 288 a lab, and thread t takes slot t
//    of every lab (its offsets computed once). Each slot
//    reconstructs the face between cells f - 1 and f once, with the wind
//    sign of cell f (its left face; at f = 8 the right face of cell 7),
//    and that one value serves as cell f - 1's right face too where the
//    two cells' signs agree: the two calls then take the same five
//    operands (weno.cuh). A thread takes its labs four at a time, their
//    Weno5Parts before their blends, so that the compiler can interleave
//    them ahead of the reciprocals' branches;
// 3. the slots whose two cells' signs differ join a queue in shared memory
//    (a warp ballot and one atomic a warp), and their second
//    reconstructions, with cell f - 1's sign, run four a thread: a
//    differing face costs its own reconstruction, not a divergent second
//    one for its whole warp (on normal random winds half the interior
//    faces differ, on a smooth field almost none);
// 4. a cell pass: a thread per output cell and component (1024 a CTA)
//    takes dx = right - left face and dy likewise, and the RHS.
// A face pass into shared memory was chosen over substage.cuh's warp walk:
// the walk's gain is rows that carry faces down a 32-row column, and a
// block has 8 rows and 8 columns, so the walk would spend most of its
// lanes on the halo; here every lane of the face pass reconstructs.
// Each face is cup2d::weno_face_part / weno5_blend on the operands of the
// cell's right or left face in ops/stencil.py's order (weno.cuh), and the
// RHS is cup2d::advect_diffuse_rhs, so the result is the per-cell design's
// (every face reconstructed by both its cells) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "weno.cuh"

namespace {

constexpr int BS = 8;
constexpr int G = 3;
constexpr int L = BS + 2 * G;                 // 14
constexpr int PLANE = L * L;                  // 196
constexpr int LAB = 2 * PLANE;                // values per lab
// labs per CTA: 8 in f32, 4 in f64 (the same shared bytes)
template <class T>
constexpr int BPC_OF = sizeof(T) == sizeof(float) ? 8 : 4;
constexpr int NF = BS + 1;                    // faces along a line
constexpr int LINE_FACES = BS * NF;           // 72 per axis and component
constexpr int LAB_FACES = 4 * LINE_FACES;     // 288
constexpr int THREADS = LAB_FACES;            // a face slot each
// face slots of one lab: [axis][component][line][face], left (sign of
// cell f) and right (sign of cell f - 1) faces
constexpr int FACE_WORDS = 2 * LAB_FACES;
// labs whose face slot a thread reconstructs together, and the most
// slots that can need a second reconstruction (the interior faces)
constexpr int GROUP = 4;
template <class T>
constexpr int QMAX = BPC_OF<T> * 4 * BS * (NF - 2);
// queued reconstructions a thread takes together
constexpr int QGROUP = 4;
static_assert(LAB % 4 == 0, "a lab is a whole number of 16-byte words");
static_assert(BPC_OF<float> % GROUP == 0 && BPC_OF<double> % GROUP == 0,
              "whole groups of labs");
static_assert(BPC_OF<float> * LAB_FACES <= 65536,
              "slots fit the queue's words");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// Face slot rem of a lab ([axis][component][line][face]; x slots run f
// fastest along a row, y slots the line (column) fastest, so neighbouring
// slots read neighbouring words): its face f along its axis, the offset
// of cell f in the lab (at: the component's plane; wind: the plane of the
// axis's velocity component, u along x, v along y) and the axis stride.
struct Slot {
    int f, at, wind, st;
};

__device__ __forceinline__ Slot slot_of(int rem) {
    const int axis = rem / (2 * LINE_FACES);           // 0: x, 1: y
    const int comp = (rem / LINE_FACES) & 1;
    const int k = rem % LINE_FACES;
    Slot S;
    S.f = axis == 0 ? k % NF : k / BS;
    const int line = axis == 0 ? k / NF : k % BS;
    S.st = axis == 0 ? 1 : L;
    const int cell = axis == 0 ? (line + G) * L + (S.f + G)
                               : (S.f + G) * L + (line + G);
    S.at = comp * PLANE + cell;
    S.wind = axis * PLANE + cell;
    return S;
}

// the reconstruction of a slot's face in lab blk with wind sign pos, from
// the six values at offsets -3 .. 2 from cell f (both faces' operands)
template <class T>
__device__ __forceinline__ cup2d::Weno5PartT<T> face_part(const T* blk,
                                                          const Slot& S,
                                                          bool pos) {
    const T* q = blk + S.at;
    const int st = S.st;
    return cup2d::weno_face_part(pos, q[-3 * st], q[-2 * st], q[-st], q[0],
                                 q[st], q[2 * st]);
}

// T: float (the f32 form) or double (the f64 form), every operand and the
// arithmetic; BPC<T> labs a CTA.
template <class T>
__global__ void __launch_bounds__(THREADS)
lab_rhs_kernel(const T* __restrict__ lab, const T* __restrict__ h,
               const T* __restrict__ dt, T nu, T* __restrict__ out, int n,
               int vec) {
    constexpr int BPC = BPC_OF<T>;
    constexpr int VW = 16 / sizeof(T);           // values a 16-byte copy
    __shared__ __align__(16) T s[BPC * LAB];
    __shared__ T fs[BPC * FACE_WORDS];
    __shared__ unsigned short queue[QMAX<T>];
    __shared__ T afac[BPC];
    __shared__ T dfac;
    __shared__ int queued;
    const int n0 = blockIdx.x * BPC;
    const int nb = min(BPC, n - n0);
    const int lane = threadIdx.x & 31;
    const T* src = lab + (size_t)n0 * LAB;
    if (vec) {
        for (int k = threadIdx.x; k < nb * LAB / VW; k += THREADS)
            cp_async16(s + VW * k, src + VW * k);
    } else if constexpr (sizeof(T) == sizeof(float)) {
        for (int k = threadIdx.x; k < nb * LAB; k += THREADS)
            cp_async4(s + k, src + k);
    } else {
        for (int k = threadIdx.x; k < nb * LAB; k += THREADS)
            storage::cp_async8(s + k, src + k);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (threadIdx.x < nb) {
        const T dtv = __ldg(dt);
        afac[threadIdx.x] = -dtv * __ldg(h + n0 + threadIdx.x);
        if (threadIdx.x == 0) {
            dfac = nu * dtv;
            queued = 0;
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // face pass: thread t reconstructs face slot t of every lab, GROUP
    // labs at a time (their parts before their blends, so that the
    // compiler can interleave them ahead of the reciprocals' branches),
    // with the wind sign of cell f (of cell 7 at f = 8); a slot whose two
    // cells' signs differ joins the CTA's queue
    const Slot S = slot_of(threadIdx.x);
    for (int g = 0; g < BPC; g += GROUP) {
        cup2d::Weno5PartT<T> pa[GROUP];
        bool second[GROUP];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
            const T* blk = s + (g + j) * LAB;
            const bool pos_f = blk[S.wind] > (T)0.0;
            const bool pos_m = blk[S.wind - S.st] > (T)0.0;
            second[j] = g + j < nb && S.f > 0 && S.f < BS && pos_m != pos_f;
            pa[j] = face_part(blk, S, S.f < BS ? pos_f : pos_m);
        }
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
            const T a = cup2d::weno5_blend(pa[j]);
            T* fo = fs + (g + j) * FACE_WORDS + threadIdx.x;
            if (g + j < nb) {
                if (S.f < BS) fo[0] = a;
                if (S.f > 0 && !second[j]) fo[LAB_FACES] = a;
            }
            const unsigned m = __ballot_sync(0xffffffffu, second[j]);
            if (m) {
                int base = 0;
                if (lane == __ffs(m) - 1)
                    base = atomicAdd(&queued, __popc(m));
                base = __shfl_sync(0xffffffffu, base, __ffs(m) - 1);
                if (second[j])
                    queue[base + __popc(m & ((1u << lane) - 1))] =
                        (unsigned short)((g + j) * LAB_FACES + threadIdx.x);
            }
        }
    }
    __syncthreads();

    // the queued slots' second reconstructions (the right face of cell
    // f - 1, with its sign), QGROUP a thread at a time
    const int nq = queued;
    for (int t0 = 0; t0 < nq; t0 += THREADS * QGROUP) {
        cup2d::Weno5PartT<T> pb[QGROUP];
        int dst[QGROUP];
#pragma unroll
        for (int j = 0; j < QGROUP; ++j) {
            const int t = t0 + j * THREADS + threadIdx.x;
            const int q = t < nq ? queue[t] : 0;
            const int b = q / LAB_FACES, rem = q - b * LAB_FACES;
            const Slot Q = slot_of(rem);
            const T* blk = s + b * LAB;
            pb[j] = face_part(blk, Q, blk[Q.wind - Q.st] > (T)0.0);
            dst[j] = t < nq ? b * FACE_WORDS + LAB_FACES + rem : -1;
        }
#pragma unroll
        for (int j = 0; j < QGROUP; ++j) {
            const T v = cup2d::weno5_blend(pb[j]);
            if (dst[j] >= 0) fs[dst[j]] = v;
        }
    }
    __syncthreads();

    // cell pass: dx = right face - left face, dy likewise, then the RHS
    for (int j = threadIdx.x; j < BPC * 2 * BS * BS; j += THREADS) {
        const int b = j / (2 * BS * BS);
        if (b >= nb) break;
        const int c = (j / (BS * BS)) & 1;
        const int cell = j % (BS * BS);
        const int y = cell / BS, x = cell % BS;
        const T* fl = fs + b * FACE_WORDS + c * LINE_FACES;
        const T* fr = fl + LAB_FACES;
        const T dx = fr[y * NF + x + 1] - fl[y * NF + x];
        const T dy = fr[2 * LINE_FACES + (y + 1) * BS + x]
                   - fl[2 * LINE_FACES + y * BS + x];
        const T* blk = s + b * LAB;
        const int at = (y + G) * L + (x + G);
        const T* q = blk + c * PLANE + at;
        out[((size_t)(n0 + b) * 2 + c) * (BS * BS) + cell] =
            cup2d::advect_diffuse_rhs(q[0], q[-1], q[1], q[-L], q[L],
                                      blk[at], blk[PLANE + at], dx, dy,
                                      afac[b], dfac);
    }
}

template <class T>
int launch(const T* lab, const T* h, const T* dt, T nu, T* out, int n,
           void* stream) {
    if (n <= 0) return 0;
    const int vec = reinterpret_cast<uintptr_t>(lab) % 16 == 0;
    lab_rhs_kernel<T><<<(n + BPC_OF<T> - 1) / BPC_OF<T>, THREADS, 0,
                        (cudaStream_t)stream>>>(lab, h, dt, nu, out, n, vec);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cup2d_lab_rhs(const float* lab, const float* h,
                             const float* dt, float nu, float* out, int n,
                             void* stream) {
    return launch<float>(lab, h, dt, nu, out, n, stream);
}

// The f64 form: lab, h, dt, out f64, nu f64.
extern "C" int cup2d_lab_rhs_f64(const double* lab, const double* h,
                                 const double* dt, double nu, double* out,
                                 int n, void* stream) {
    return launch<double>(lab, h, dt, nu, out, n, stream);
}
