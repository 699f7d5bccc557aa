// B9 svgir_pad_cols / svgir_slice_cols replace svgir_tpu/ops/blend_pallas.py
// pad_cols / slice_cols (_pad_cols_kernel, _slice_cols_kernel): the column
// zero-pad [M, kin] -> [M, kout] (kin <= kout) and the column slice
// [M, kin] -> [M, kout] (kout <= kin) of a float32 row-major array.  As in
// the reference, M must be a multiple of `block` (the reference's row
// block); the kernels' own tiling does not depend on it.
//
// Bound: bytes.  Each output element is one read (or a zero) and one write.
// Pad: one warp per row, eight rows per block: the warp's lanes walk the
// row's kout output columns 32 at a time, so each store and each load of a
// warp covers neighbouring addresses, and M / 8 blocks keep the card full.
// Slice: a row of kout < 32 columns would leave most of a warp's lanes idle
// under that layout, with one 4-byte load and store each.  So the slice
// walks the flattened output [M * kout] instead: each thread stores 16-byte
// runs of four consecutive outputs and gathers each from its rows (two
// 8-byte loads where kin and kout are even, so that no pair of columns
// straddles a row, and x is 8-byte aligned; else four 4-byte loads),
// kSliceRuns runs a thread with all their loads issued before the first
// store, on a grid of at most kSliceBlocksPerSm blocks per SM that strides
// over the output.  An output
// whose length is not a multiple of four ends in a scalar tail.
// No shared memory, no atomics.
#include <cuda_runtime.h>

#define SVGIR_COLS_ROWS 8  // pad: rows (warps) per block

static const int kSliceThreads = 256;
static const int kSliceRuns = 4;         // 16-byte output runs per thread and pass
static const int kSliceBlocksPerSm = 8;

__global__ void __launch_bounds__(32 * SVGIR_COLS_ROWS)
svgir_cols_kernel(const float* __restrict__ x, int m, int kin, int kout,
                  float* __restrict__ out) {
  const size_t r = (size_t)blockIdx.x * SVGIR_COLS_ROWS + threadIdx.y;
  if (r >= (size_t)m) return;
  const float* src = x + r * kin;
  float* dst = out + r * kout;
  for (int c = threadIdx.x; c < kout; c += 32) dst[c] = c < kin ? src[c] : 0.f;
}

// Output run q covers outputs 4q .. 4q+3.  PAIRS: kin and kout are even, so
// outputs 4q, 4q+1 and 4q+2, 4q+3 each lie in one row, as one float2.
template <bool PAIRS, typename Idx>
__device__ __forceinline__ float4 svgir_slice_run(const float* __restrict__ x, Idx q,
                                                  Idx kin, Idx kout) {
  float v[4];
  if (PAIRS) {
    const Idx hout = kout >> 1, hin = kin >> 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Idx p = 2 * q + h;  // float2 index of the output
      const Idx r = p / hout;
      const float2 t = reinterpret_cast<const float2*>(x)[r * hin + (p - r * hout)];
      v[2 * h] = t.x;
      v[2 * h + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const Idx p = 4 * q + h;
      const Idx r = p / kout;
      v[h] = __ldg(x + r * kin + (p - r * kout));
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool PAIRS, typename Idx>
__global__ void __launch_bounds__(kSliceThreads)
svgir_slice_kernel(const float* __restrict__ x, Idx m, Idx kin, Idx kout,
                   float* __restrict__ out) {
  const Idx n = m * kout, runs = n >> 2;
  const Idx stride = (Idx)gridDim.x * kSliceThreads;
  float4* dst = reinterpret_cast<float4*>(out);
  for (Idx q0 = (Idx)blockIdx.x * kSliceThreads + threadIdx.x; q0 < runs;
       q0 += stride * kSliceRuns) {
    float4 v[kSliceRuns];
#pragma unroll
    for (int k = 0; k < kSliceRuns; ++k) {
      const Idx q = q0 + k * stride;
      if (q < runs) v[k] = svgir_slice_run<PAIRS, Idx>(x, q, kin, kout);
    }
#pragma unroll
    for (int k = 0; k < kSliceRuns; ++k) {
      const Idx q = q0 + k * stride;
      if (q < runs) dst[q] = v[k];
    }
  }
  // the last n mod 4 outputs
  const Idx p = 4 * runs + (Idx)blockIdx.x * kSliceThreads + threadIdx.x;
  if (p < n) {
    const Idx r = p / kout;
    out[p] = x[r * kin + (p - r * kout)];
  }
}

static int slice_blocks(long long runs) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  const long long need = (runs + kSliceThreads - 1) / kSliceThreads;
  const long long cap = (long long)sms * kSliceBlocksPerSm;
  return (int)(need < 1 ? 1 : need < cap ? need : cap);
}

template <typename Idx>
static void launch_slice(const float* x, int m, int kin, int kout, float* out,
                         cudaStream_t s) {
  const int blocks = slice_blocks((long long)m * kout / 4);
  if (kin % 2 == 0 && kout % 2 == 0 && ((size_t)x & 7) == 0)
    svgir_slice_kernel<true, Idx><<<blocks, kSliceThreads, 0, s>>>(x, m, kin, kout, out);
  else
    svgir_slice_kernel<false, Idx><<<blocks, kSliceThreads, 0, s>>>(x, m, kin, kout, out);
}

static int check_cols(int m, int kin, int kout, int block) {
  return block <= 0 || m < 0 || m % block != 0 || kin <= 0 || kout <= 0;
}

extern "C" int svgir_pad_cols(const float* x, int m, int kin, int kout, int block, float* out,
                              void* stream) {
  if (check_cols(m, kin, kout, block) || kin > kout) return (int)cudaErrorInvalidValue;
  const int blocks = (m + SVGIR_COLS_ROWS - 1) / SVGIR_COLS_ROWS;
  if (m > 0)
    svgir_cols_kernel<<<blocks, dim3(32, SVGIR_COLS_ROWS), 0, (cudaStream_t)stream>>>(
        x, m, kin, kout, out);
  return (int)cudaGetLastError();
}

// The output must be 16-byte aligned (a fresh allocation is); an x that is
// not 8-byte aligned takes the 4-byte loads.
extern "C" int svgir_slice_cols(const float* x, int m, int kin, int kout, int block,
                                float* out, void* stream) {
  if (check_cols(m, kin, kout, block) || kout > kin || ((size_t)out & 15))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)m * kin < (1LL << 32))
    launch_slice<unsigned>(x, m, kin, kout, out, s);
  else
    launch_slice<unsigned long long>(x, m, kin, kout, out, s);
  return (int)cudaGetLastError();
}
