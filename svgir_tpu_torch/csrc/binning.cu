// Tile binning kernels of the counting binner (svgir_tpu_torch/ops/binning.py).
//
// B1 svgir_counts replaces svgir_tpu/ops/binning_pallas.py compute_counts
// (_counts_kernel): per-tile instance counts of the depth-sorted rects, plus
// the carry snapshot table carry[c, t] = instances tile t receives from
// Gaussian chunks before chunk c.
//   Bound on the card: latency.  The work itself is bound by bytes (16 B
//   read per Gaussian, 4 B written per (chunk, tile), a few integer tests
//   per coverage check), but this design walks the chunks in sequence.
//   Design: one thread per tile; each block walks every Gaussian chunk in
//   order, staging the chunk's rects in shared memory, so the sequential
//   chunk loop that the reference ran as a grid dimension becomes a loop
//   inside the block and the snapshots come out in the same pass.  Blocks
//   are one warp wide, but 625 tiles still make only 20 blocks, each a
//   serial chain of all chunks: most SMs idle.  Counting the chunks in
//   parallel ([nchunks, T]) and scanning over chunks would fill the card.
//
// B2 svgir_instances replaces binning_pallas.py compute_instances
// (_inst_kernel): for every instance slot j of the Gaussian-major
// enumeration, its Gaussian g (binary search over the exclusive offsets),
// its tile (y outer, x inner over g's rect) and its output slot
//   slot = table[chunk(g), tile] + #{g' in [chunk_start(g), g) covering tile}
// where table already holds carry + chunk-aligned tile starts.
//   Bound: bytes (8 B written per instance, the Gaussian-side arrays read
//   once); the in-chunk rank count is at most gauss_chunk-1 integer tests.
//   Design: one thread per instance; neighbouring instances mostly share a
//   Gaussian, so the rank loop's rect reads are broadcasts served by L1.
//   Slots stay int32 throughout and the tile split uses integer division.
#include <cuda_runtime.h>

__global__ void svgir_counts_kernel(const int* __restrict__ x0, const int* __restrict__ y0,
                                    const int* __restrict__ x1, const int* __restrict__ y1,
                                    int nchunks, int gauss_chunk, int grid_x, int num_tiles,
                                    int* __restrict__ counts, int* __restrict__ carry) {
  extern __shared__ int4 s_rect[];  // gauss_chunk rects (x0, y0, x1, y1)
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = t < num_tiles;
  const int tx = live ? t % grid_x : -1;
  const int ty = live ? t / grid_x : -1;
  int acc = 0;
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();
    for (int i = threadIdx.x; i < gauss_chunk; i += blockDim.x) {
      const int g = c * gauss_chunk + i;
      s_rect[i] = make_int4(x0[g], y0[g], x1[g], y1[g]);
    }
    __syncthreads();
    if (live) {
      carry[(size_t)c * num_tiles + t] = acc;  // snapshot BEFORE chunk c
      for (int i = 0; i < gauss_chunk; ++i) {
        const int4 r = s_rect[i];
        acc += (tx >= r.x) & (tx < r.z) & (ty >= r.y) & (ty < r.w);
      }
    }
  }
  if (live) counts[t] = acc;
}

__global__ void svgir_instances_kernel(const int* __restrict__ x0, const int* __restrict__ y0,
                                       const int* __restrict__ x1, const int* __restrict__ y1,
                                       const int* __restrict__ offsets,
                                       const int* __restrict__ order,
                                       const int* __restrict__ table,
                                       const int* __restrict__ total_raw, int ns, int m,
                                       int gauss_chunk, int grid_x, int num_tiles,
                                       int* __restrict__ slot, int* __restrict__ gid) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  if (j >= *total_raw) {  // past the last instance: dropped by the caller
    slot[j] = m;
    gid[j] = -1;
    return;
  }
  // g = last Gaussian with offsets[g] <= j (Gaussians with no instances
  // share their successor's offset and are skipped by taking the last)
  int lo = 0, hi = ns;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid] <= j) lo = mid + 1; else hi = mid;
  }
  const int g = lo - 1;
  const int k = j - offsets[g];
  const int gx0 = x0[g];
  const int w = max(x1[g] - gx0, 1);
  const int qy = k / w;
  const int tx = gx0 + k - qy * w;
  const int ty = y0[g] + qy;
  const int cidx = g / gauss_chunk;
  int rank = 0;
  for (int h = cidx * gauss_chunk; h < g; ++h)
    rank += (x0[h] <= tx) & (tx < x1[h]) & (y0[h] <= ty) & (ty < y1[h]);
  slot[j] = table[(size_t)cidx * num_tiles + ty * grid_x + tx] + rank;
  gid[j] = order[g];
}

extern "C" int svgir_counts(const int* x0, const int* y0, const int* x1, const int* y1,
                            int nchunks, int gauss_chunk, int grid_x, int grid_y,
                            int* counts, int* carry, void* stream) {
  const int num_tiles = grid_x * grid_y;
  const int threads = 32;
  const int blocks = (num_tiles + threads - 1) / threads;
  if (blocks > 0)
    svgir_counts_kernel<<<blocks, threads, gauss_chunk * sizeof(int4), (cudaStream_t)stream>>>(
        x0, y0, x1, y1, nchunks, gauss_chunk, grid_x, num_tiles, counts, carry);
  return (int)cudaGetLastError();
}

extern "C" int svgir_instances(const int* x0, const int* y0, const int* x1, const int* y1,
                               const int* offsets, const int* order, const int* table,
                               const int* total_raw, int ns, int m, int gauss_chunk,
                               int grid_x, int num_tiles, int* slot, int* gid, void* stream) {
  const int threads = 256;
  const int blocks = (m + threads - 1) / threads;
  if (blocks > 0)
    svgir_instances_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        x0, y0, x1, y1, offsets, order, table, total_raw, ns, m, gauss_chunk, grid_x,
        num_tiles, slot, gid);
  return (int)cudaGetLastError();
}
