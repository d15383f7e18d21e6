// Fused residual add + norm, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// paddle_tpu/ops/pallas/fused_residual_norm.py, with their block math:
// `fused_residual_rms_norm_fwd` / `_bwd` (`_rrms_fwd_block`,
// `_rrms_bwd_block`) and `fused_residual_layer_norm_fwd` / `_bwd`
// (`_rln_fwd_block`, `_rln_bwd_block`):
//   forward   res = x + y, rounded to the input type BEFORE the stats;
//             RMS:   rstd = rsqrt(mean(res^2) + eps),
//                    normed = res * rstd * w;
//             Layer: two-pass mean and var, rstd = rsqrt(var + eps),
//                    normed = (res - mean) * rstd * w + b;
//             fp32, cast to the input type;
//   backward  d = dres + the norm's dx of dnormed, the SHARED cotangent
//             of x and y (cast to the input type); dw (and db) summed
//             over rows in fp32. A missing dres (the residual output
//             unused, as the final norms discard it) is zero.
//
// What bounds it on an H100: bytes. At LLaMA-7B training (x, y [4096,
// 4096] bf16) the RMS forward moves 67.1 MB in and 67.1 MB out (~0.04
// ms at 3.35 TB/s); at GPT-124M training (x, y [8192, 768] bf16) the
// Layer forward moves 25.2 MB in and 25.2 MB out (~0.015 ms). The row
// kernels are row_norm.cuh's (design notes there): rows kept in
// registers between their reductions and their use, sums in a fixed
// order (no atomics). Each backward is one launch (ln_bwd_kernel,
// templated on the norm), its dw (and db) summed past a grid barrier.
//
// Plain C interface (bound with ctypes); the wrapper in
// fused_residual_norm.py checks shapes, types and contiguity and
// allocates the outputs and the partials. The entries read w (and b) in
// their own type and write dw (and db) in it.

#include "row_norm.cuh"

extern "C" {

// dtype: 0 float32, 1 bfloat16 (x, y, res, normed, d, dres, dnormed);
// wdtype the same for w (and b), dw (and db); mean, rstd and the
// partials are fp32. All row-major and contiguous. `vec`: the caller
// checked 16-byte alignment and h a multiple of 16 bytes of the type.
// Launch on `stream` (a cudaStream_t); return a cudaError_t as int.
int pdt_rms_fwd(int dtype, int wdtype, const void* x, const void* y,
                const void* w, void* res, void* normed, float* rstd, int n,
                int h, float eps, int vec, void* stream) {
  return row_norm_fwd<true>(kRms, dtype, wdtype, x, y, w, nullptr, res,
                            normed, nullptr, rstd, n, h, eps, vec,
                            (cudaStream_t)stream);
}

// The largest row width the kernels take for a dtype and load width.
int pdt_rms_max_h(int dtype, int vec) { return row_norm_max_h(dtype, vec); }

int pdt_rln_fwd(int dtype, int wdtype, const void* x, const void* y,
                const void* w, const void* b, void* res, void* normed,
                float* mean, float* rstd, int n, int h, float eps, int vec,
                void* stream) {
  return row_norm_fwd<true>(kLayer, dtype, wdtype, x, y, w, b, res, normed,
                            mean, rstd, n, h, eps, vec, (cudaStream_t)stream);
}

// The backward of `norm` (0 RMS, row 12; 1 Layer, row 10), one launch
// (row_norm.cuh's ln_bwd_kernel) on the plan of norms.ln_bwd_plan;
// `mean` (Layer) and dres may be null; `dwdb` is [2, h] in w's type
// (dw, then db), RMS [h] (dw). The CTAs an SM holds for that plan come
// from pdt_ln_bwd_ctas_per_sm (a negative cudaError_t on failure).
int pdt_ln_bwd_ctas_per_sm(int norm, int dtype, int vec, int h, int G) {
  return ln_bwd_ctas_per_sm(norm, dtype, vec, h, G);
}

int pdt_ln_bwd(int norm, int dtype, int wdtype, const void* res,
               const void* w, const float* mean, const float* rstd,
               const void* dres, const void* dnormed, void* d, void* dwdb,
               float* part, int n, int h, int vec, int G, int ctas, int cols,
               void* stream) {
  return ln_bwd(norm, dtype, wdtype, res, w, mean, rstd, dres, dnormed, d,
                dwdb, part, n, h, vec, G, ctas, cols, (cudaStream_t)stream);
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
