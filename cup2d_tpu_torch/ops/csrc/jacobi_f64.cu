// The f64 forms of the sweep chain (jacobi.cuh's kernel on f64 storage):
// n damped-Jacobi sweeps e <- e + omega * (r - lap(e)) / d with every
// operand, the tile and the arithmetic in f64, Neumann
// (cup2d_jacobi_sweeps_f64), a table's edge signs
// (cup2d_jacobi_sweeps_signed_f64) and the wrap form of the periodic tables
// (cup2d_jacobi_sweeps_wrap_f64). The design, the f64 tiles and what the
// forms replace: jacobi.cu. A source of its own so that its 18 instances
// compile beside jacobi.cu's 60.

#include "jacobi.cuh"

namespace {

// the f64 launch sizes (hopper_kernels.BF16_CHAIN, as bf16's)
template <bool SIGNED, bool WRAP>
Launch<double> pick_f64(int nsw, int big) {
    switch (nsw) {
        case 1: return pick<1, 0, SIGNED, double, WRAP>(big);
        case 2: return pick<2, 0, SIGNED, double, WRAP>(big);
        case 6: return pick<6, 0, SIGNED, double, WRAP>(big);
        default: return nullptr;
    }
}

template <bool SIGNED, bool WRAP>
int sweeps_entry_f64(const double* e, const double* r, double* out, int L,
                     int ny, int nx, int nsw, double omega, int from_zero,
                     int big, int vec, int grid, Signs sg, int wrap,
                     void* stream) {
    if (L < 1 || ny < 1 || nx < 1 || grid < 1 || (vec != 2 && vec != 1)
            || (vec == 2 && nx % 2) || (WRAP && wrap == 0))
        return (int)cudaErrorInvalidValue;
    Launch<double> fn = pick_f64<SIGNED, WRAP>(nsw, big);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return fn(e, r, out, L, ny, nx, omega, from_zero, sg, vec, grid, wrap,
              (cudaStream_t)stream);
}

}  // namespace

// The f64 forms: e, r, out f64, omega f64; nsw 1, 2 or 6; vec 2 for
// 16-byte copies (nx even, 16-byte aligned pointers), 1 for 8-byte ones;
// the signed and wrap forms take the signs as above.
extern "C" int cup2d_jacobi_sweeps_f64(const double* e, const double* r,
                                       double* out, int L, int ny, int nx,
                                       int nsw, double omega, int from_zero,
                                       int big, int vec, int grid,
                                       void* stream) {
    return sweeps_entry_f64<false, false>(
        e, r, out, L, ny, nx, nsw, omega, from_zero, big, vec, grid,
        Signs{1.0f, 1.0f, 1.0f, 1.0f}, 0, stream);
}

extern "C" int cup2d_jacobi_sweeps_signed_f64(
        const double* e, const double* r, double* out, int L, int ny, int nx,
        int nsw, double omega, int from_zero, int big, int vec, int grid,
        float es_x_lo, float es_x_hi, float es_y_lo, float es_y_hi,
        void* stream) {
    return sweeps_entry_f64<true, false>(
        e, r, out, L, ny, nx, nsw, omega, from_zero, big, vec, grid,
        Signs{es_x_lo, es_x_hi, es_y_lo, es_y_hi}, 0, stream);
}

extern "C" int cup2d_jacobi_sweeps_wrap_f64(
        const double* e, const double* r, double* out, int L, int ny, int nx,
        int nsw, double omega, int from_zero, int big, int vec, int grid,
        float es_x_lo, float es_x_hi, float es_y_lo, float es_y_hi,
        void* stream) {
    const int wrap = (es_x_lo == 0.0f && es_x_hi == 0.0f ? 1 : 0)
                     | (es_y_lo == 0.0f && es_y_hi == 0.0f ? 2 : 0);
    return sweeps_entry_f64<true, true>(
        e, r, out, L, ny, nx, nsw, omega, from_zero, big, vec, grid,
        Signs{es_x_lo, es_x_hi, es_y_lo, es_y_hi}, wrap, stream);
}
