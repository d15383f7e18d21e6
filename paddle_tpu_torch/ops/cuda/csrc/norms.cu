// RMSNorm and LayerNorm over the last axis, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/norms.py:
// `_rms_call` (`_rms_fwd_kernel`), `_rms2d_bwd` (`_rms_bwd_kernel`),
// `_ln_call` (`_ln_fwd_kernel`) and `_ln2d_bwd` (`_ln_bwd_kernel`):
//   RMS   out = x * rstd * w in fp32, cast once, rstd = rsqrt(mean(x^2)
//         + eps); dx = rstd * (wg - xhat * mean(wg * xhat)), wg = g * w,
//         xhat = x * rstd; dw = sum over rows of g * xhat;
//   Layer out = (x - mean) * rstd * w + b, two-pass fp32 stats;
//         dx = rstd * (wg - mean(wg) - xhat * mean(wg * xhat)),
//         xhat = (x - mean) * rstd; dw as RMS, db = sum over rows of g.
// They are the row kernels of the fused residual pairs without the
// residual input (row_norm.cuh, design notes there).
//
// What bounds it on an H100: bytes. At the GPT-124M training shape
// under the norm backend (x [8192, 768] fp32) the Layer forward moves
// 25.2 MB in and 25.2 MB out (~0.015 ms at 3.35 TB/s); at LLaMA-7B
// width (x [4096, 4096] fp32) the RMS forward 67.1 MB each way.
//
// Plain C interface (bound with ctypes); the wrapper in norms.py checks
// shapes, types and contiguity and allocates the outputs and the
// scratch. Each backward is one launch (row_norm.cuh's ln_bwd_kernel,
// templated on the norm).

#include "row_norm.cuh"

extern "C" {

// norm: 0 RMS, 1 Layer. dtype: 0 float32, 1 bfloat16 (x, out, g, dx);
// wdtype the same for w and b, and for dw and db; mean, rstd and the
// partials are fp32. All row-major and contiguous. b and mean are read and written only by the Layer norm.
// `vec`: the caller checked 16-byte alignment and h a multiple of 16
// bytes of the type. Launch on `stream` (a cudaStream_t); return a
// cudaError_t as int.
int pdt_norm_fwd(int norm, int dtype, int wdtype, const void* x,
                 const void* w, const void* b, void* out, float* mean,
                 float* rstd, int n, int h, float eps, int vec, void* stream) {
  return row_norm_fwd<false>(norm, dtype, wdtype, x, nullptr, w, b, nullptr,
                             out, mean, rstd, n, h, eps, vec,
                             (cudaStream_t)stream);
}

// The backward of `norm` (0 RMS, row 14; 1 Layer, row 16), one launch
// (row_norm.cuh's ln_bwd_kernel) on the plan of norms.ln_bwd_plan;
// `mean` (Layer) and `dres` may be null (RMS reads no mean; here dres is
// null); `dwdb` is [2, h] in w's type (dw, then db), RMS [h] (dw). The
// CTAs an SM holds for that plan come from pdt_ln_bwd_ctas_per_sm (a
// negative cudaError_t on failure).
int pdt_ln_bwd_ctas_per_sm(int norm, int dtype, int vec, int h, int G) {
  return ln_bwd_ctas_per_sm(norm, dtype, vec, h, G);
}

int pdt_ln_bwd(int norm, int dtype, int wdtype, const void* x,
               const void* w, const float* mean, const float* rstd,
               const void* dres, const void* g, void* d, void* dwdb,
               float* part, int n, int h, int vec, int G, int ctas, int cols,
               void* stream) {
  return ln_bwd(norm, dtype, wdtype, x, w, mean, rstd, dres, g, d, dwdb,
                part, n, h, vec, G, ctas, cols, (cudaStream_t)stream);
}

// The largest row width the kernels take for a dtype and load width.
int pdt_norm_max_h(int dtype, int vec) { return row_norm_max_h(dtype, vec); }

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
