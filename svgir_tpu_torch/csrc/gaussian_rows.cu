// R1 svgir_gaussian_rows: the per-Gaussian sums of per-instance rows, for
// the custom-gradient boundary of ops/rasterizer.py.  Its backward sums the
// blend backward's rows d_slab [M, K] (B4/B6, K = 12 + CA + 4 CV) into the
// slab's per-Gaussian rows [N + 1, K]; its forward sums the blend's
// per-instance weight sums [M] (K = 1).  svgir_tpu does both with a
// scatter-add over the instances' Gaussian ids (XLA's scatter); no Pallas
// kernel of it does this.
//
// The binner hands over each Gaussian's list of instance slots
// (ops/binning.py): lists [N, 2] int32 holds Gaussian g's first raw
// instance and its count, raw_slot [R] int32 each raw instance's slot, and
// a Gaussian's raw instances run in rect order (y outer, x inner), so in
// ascending slot order.  Row g of the output is the sum of the rows of
// d_inst at the slots of g's list, added in list order onto 0.  Entries
// whose raw index is >= R (the binner's cap dropped them) or whose slot is
// >= M (the padded layout's cap dropped them) are skipped; padding slots
// are in no list and are never read.  Row N is zero.  That is what a
// scatter-add in ascending slot order gives (index_add_ on the CPU), and
// every row is the same on every run: there are no atomics.
//
// Bound: bytes: the output written once, the listed rows of d_inst, the
// lists and the listed slots read once.  Design: a block owns `rows`
// consecutive output rows, rows = max(1, kOutputs / K), so about kPerThread
// outputs a thread.  Its first threads stage the rows' lists and each
// list's first slot in shared memory; then the block walks its rows * K
// outputs flat, so that the stores of a warp are consecutive and an empty
// list costs a store an output.  A thread issues the first-slot loads of
// all its outputs before it adds any further entry: most Gaussians that
// have instances at all have one or two.  (Loading the further entries
// four at a time ran 11% slower on the H100.)
#include <climits>

#include <cuda_runtime.h>

static const int kThreads = 256;
static const int kPerThread = 8;                     // outputs a thread
static const int kOutputs = kThreads * kPerThread;   // outputs a block

__global__ void __launch_bounds__(kThreads)
svgir_gaussian_rows_kernel(const float* __restrict__ d_inst, int m, int k,
                           const int2* __restrict__ lists,
                           const int* __restrict__ raw_slot, int r, int n, int rows,
                           float* __restrict__ out) {
  __shared__ int s_first[kOutputs];   // the list's first raw instance
  __shared__ int s_count[kOutputs];   // its entries below r
  __shared__ int s_slot[kOutputs];    // its first entry's slot; -1: none below m
  const long long row0 = (long long)blockIdx.x * rows;
  const int nr = (int)min((long long)rows, (long long)n + 1 - row0);
  for (int i = threadIdx.x; i < nr; i += kThreads) {
    const long long g = row0 + i;
    int first = 0, count = 0, slot = -1;
    if (g < n) {
      const int2 l = lists[g];
      first = l.x;
      count = l.x < r ? min(l.y, r - l.x) : 0;
      if (count > 0) {
        const int q = raw_slot[first];
        if ((unsigned)q < (unsigned)m) slot = q;
      }
    }
    s_first[i] = first;
    s_count[i] = count;
    s_slot[i] = slot;
  }
  __syncthreads();
  const int total = nr * k;
  float* dst = out + row0 * k;
  for (int e0 = threadIdx.x; e0 < total; e0 += kOutputs) {
    float acc[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int e = e0 + u * kThreads;
      acc[u] = 0.f;
      if (e < total) {
        const int i = e / k;
        const int q = s_slot[i];
        if (q >= 0) acc[u] += __ldg(d_inst + (size_t)q * k + (e - i * k));
      }
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int e = e0 + u * kThreads;
      if (e < total) {
        const int i = e / k, c = e - i * k;
        const int first = s_first[i], count = s_count[i];
        for (int j = 1; j < count; ++j) {
          const int q = __ldg(raw_slot + first + j);
          if ((unsigned)q < (unsigned)m) acc[u] += __ldg(d_inst + (size_t)q * k + c);
        }
        dst[e] = acc[u];
      }
    }
  }
}

// d_inst [m, k] float32, lists [n, 2] int32 (8-byte aligned), raw_slot [r]
// int32 -> out [n + 1, k] float32, every row written.
extern "C" int svgir_gaussian_rows(const float* d_inst, int m, int k, const int* lists,
                                   const int* raw_slot, int r, int n, float* out,
                                   void* stream) {
  if (m < 0 || k <= 0 || r < 0 || n < 0 || ((size_t)lists & 7))
    return (int)cudaErrorInvalidValue;
  const int rows = kOutputs / k > 1 ? kOutputs / k : 1;
  const long long blocks = ((long long)n + rows) / rows;   // n + 1 rows
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  svgir_gaussian_rows_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      d_inst, m, k, reinterpret_cast<const int2*>(lists), raw_slot, r, n, rows, out);
  return (int)cudaGetLastError();
}
