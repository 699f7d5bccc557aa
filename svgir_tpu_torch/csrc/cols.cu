// B9 svgir_pad_cols / svgir_slice_cols replace svgir_tpu/ops/blend_pallas.py
// pad_cols / slice_cols (_pad_cols_kernel, _slice_cols_kernel): the column
// zero-pad [M, kin] -> [M, kout] (kin <= kout) and the column slice
// [M, kin] -> [M, kout] (kout <= kin) of a float32 row-major array.  As in
// the reference, M must be a multiple of `block` (the reference's row
// block); the kernel's own tiling does not depend on it.
//
// Bound: bytes.  Each output element is one read (or a zero) and one write.
// Design: one warp per row, eight rows per block: the warp's lanes walk the
// row's kout output columns 32 at a time, so each store and each load of a
// warp covers neighbouring addresses, and M / 8 blocks keep the card full.
// No shared memory, no atomics.
#include <cuda_runtime.h>

#define SVGIR_COLS_ROWS 8  // rows (warps) per block

__global__ void __launch_bounds__(32 * SVGIR_COLS_ROWS)
svgir_cols_kernel(const float* __restrict__ x, int m, int kin, int kout,
                  float* __restrict__ out) {
  const size_t r = (size_t)blockIdx.x * SVGIR_COLS_ROWS + threadIdx.y;
  if (r >= (size_t)m) return;
  const float* src = x + r * kin;
  float* dst = out + r * kout;
  for (int c = threadIdx.x; c < kout; c += 32) dst[c] = c < kin ? src[c] : 0.f;
}

static int launch_cols(const float* x, int m, int kin, int kout, int block, float* out,
                       void* stream) {
  if (block <= 0 || m % block != 0 || kin <= 0 || kout <= 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (m + SVGIR_COLS_ROWS - 1) / SVGIR_COLS_ROWS;
  if (m > 0)
    svgir_cols_kernel<<<blocks, dim3(32, SVGIR_COLS_ROWS), 0, (cudaStream_t)stream>>>(
        x, m, kin, kout, out);
  return (int)cudaGetLastError();
}

extern "C" int svgir_pad_cols(const float* x, int m, int kin, int kout, int block, float* out,
                              void* stream) {
  if (kin > kout) return (int)cudaErrorInvalidValue;
  return launch_cols(x, m, kin, kout, block, out, stream);
}

extern "C" int svgir_slice_cols(const float* x, int m, int kin, int kout, int block,
                                float* out, void* stream) {
  if (kout > kin) return (int)cudaErrorInvalidValue;
  return launch_cols(x, m, kin, kout, block, out, stream);
}
