// Tile binning kernels of the counting binner (svgir_tpu_torch/ops/binning.py).
//
// B1 svgir_counts replaces svgir_tpu/ops/binning_pallas.py compute_counts
// (_counts_kernel): per-tile instance counts of the depth-sorted rects, plus
// the carry snapshot table carry[c, t] = instances tile t receives from
// Gaussian chunks before chunk c.
//   Bound on the card: bytes.  16 B read per Gaussian and 4 B written per
//   (chunk, tile): 1.3 MB, 0.4 us at 3.35 TB/s, at the bench's 50,176
//   Gaussians and 196 chunks x 625 tiles.  The TPU kernel walks the chunks
//   in sequence and carries the sum from one grid step to the next; on
//   this card a walk over the chunks per tile is a chain of 50k dependent
//   tests on a few of the 132 SMs, latency-bound at ~1 ms.
//   Design: two launches, neither walks the chunks in sequence.
//   Pass 1, one block per Gaussian chunk (196 blocks): each thread adds the
//   four corners of its rect, clamped to the grid, into a (gy+1) x (gx+1)
//   difference array in shared memory with integer atomics (exact, so the
//   result does not depend on their order; an empty or inverted rect adds
//   nothing); the block takes the array's 2-D inclusive prefix sum (a
//   thread per row, then a thread per column) and writes the chunk's
//   per-tile counts into carry[c, :], coalesced.  Four atomics per
//   Gaussian, whatever its rect's size.
//   Pass 2 scans carry in place over the chunks: a block takes 32 tiles,
//   one per lane (loads coalesced), and 16 warps that split the chunk
//   axis; each warp sums its share with independent loads, the warps'
//   totals are scanned in shared memory, and each warp rewrites its share
//   as the exclusive prefix from its offset, four chunks at a time; the
//   last warp's end is counts[t].  Integer sums: exact in any order.
//   The difference array lives in one block's shared memory, which holds
//   a grid of up to ~58,000 tiles.  A larger grid is counted in bands: a
//   block takes one chunk and one band of whole tile rows (or, where even
//   two tile rows do not fit, of a row's columns) whose difference array
//   fits, and clamps each rect to its band; pass 1 then runs as a grid of
//   chunks x bands.  The counts stay exact, and a grid that fits is one
//   band, the whole grid, as before.
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
#include "blend_common.cuh"

static const int kCountThreads = 256;  // pass 1: threads per chunk block
static const int kSmemOptInMax = 232448;  // bytes of shared memory a block may use
static const int kScanWarps = 16;      // pass 2: warps splitting the chunks

// Pass 1: per_chunk[c, t] = rects of chunk c (blockIdx.x) covering tile t,
// for the tiles of band blockIdx.y: band_h tile rows x band_w tile columns
// (the bands tile the grid row-major; edge bands are smaller).
__global__ void __launch_bounds__(kCountThreads)
svgir_counts_chunk_kernel(const int* __restrict__ x0, const int* __restrict__ y0,
                          const int* __restrict__ x1, const int* __restrict__ y1,
                          int gauss_chunk, int grid_x, int grid_y, int band_w, int band_h,
                          int* __restrict__ per_chunk) {
  extern __shared__ int s_d[];  // (bh + 1) x (bw + 1) difference array
  const int nbx = (grid_x + band_w - 1) / band_w;
  const int bx0 = (blockIdx.y % nbx) * band_w, by0 = (blockIdx.y / nbx) * band_h;
  const int bw = min(band_w, grid_x - bx0), bh = min(band_h, grid_y - by0);
  const int wd = bw + 1;
  const int nd = (bh + 1) * wd;
  for (int i = threadIdx.x; i < nd; i += blockDim.x) s_d[i] = 0;
  __syncthreads();
  const size_t g0 = (size_t)blockIdx.x * gauss_chunk;
  for (int i = threadIdx.x; i < gauss_chunk; i += blockDim.x) {
    const size_t g = g0 + i;
    // the rect clamped to the band, in band coordinates
    const int a = min(max(x0[g] - bx0, 0), bw), b = min(max(x1[g] - bx0, 0), bw);
    const int c = min(max(y0[g] - by0, 0), bh), d = min(max(y1[g] - by0, 0), bh);
    if (a < b && c < d) {
      atomicAdd(s_d + c * wd + a, 1);
      atomicAdd(s_d + c * wd + b, -1);
      atomicAdd(s_d + d * wd + a, -1);
      atomicAdd(s_d + d * wd + b, 1);
    }
  }
  __syncthreads();
  // inclusive prefix sums along x, then along y, over the bh x bw tiles
  // (the array's last row and column are never read back)
  for (int r = threadIdx.x; r < bh; r += blockDim.x) {
    int* row = s_d + r * wd;
    int acc = 0;
    for (int x = 0; x < bw; ++x) {
      acc += row[x];
      row[x] = acc;
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < bw; x += blockDim.x) {
    int acc = 0;
    for (int r = 0; r < bh; ++r) {
      acc += s_d[r * wd + x];
      s_d[r * wd + x] = acc;
    }
  }
  __syncthreads();
  int* dst = per_chunk + (size_t)blockIdx.x * grid_x * grid_y;
  for (int t = threadIdx.x; t < bw * bh; t += blockDim.x) {
    const int ty = t / bw, tx = t - ty * bw;
    dst[(size_t)(by0 + ty) * grid_x + bx0 + tx] = s_d[ty * wd + tx];
  }
}

// Pass 2: carry[c, t] <- sum of carry[c', t] over c' < c (in place), and
// counts[t] <- the sum over every chunk.
__global__ void __launch_bounds__(32 * kScanWarps)
svgir_counts_scan_kernel(int nchunks, int num_tiles, int* __restrict__ carry,
                         int* __restrict__ counts) {
  __shared__ int s_tot[kScanWarps][32];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int t = blockIdx.x * 32 + lane;
  const bool live = t < num_tiles;
  const int per = (nchunks + kScanWarps - 1) / kScanWarps;
  const int c0 = min(wp * per, nchunks), c1 = min(c0 + per, nchunks);
  int sum = 0;
  if (live) {
#pragma unroll 4
    for (int c = c0; c < c1; ++c) sum += carry[(size_t)c * num_tiles + t];
  }
  s_tot[wp][lane] = sum;
  __syncthreads();
  int off = 0;
  for (int k = 0; k < wp; ++k) off += s_tot[k][lane];
  if (!live) return;
  for (int c = c0; c < c1; c += 4) {
    int x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[k] = c + k < c1 ? carry[(size_t)(c + k) * num_tiles + t] : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c + k < c1) carry[(size_t)(c + k) * num_tiles + t] = off;
      off += x[k];
    }
  }
  if (wp == kScanWarps - 1) counts[t] = off;  // its share ends at nchunks
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

// B1: counts [grid_x * grid_y] and carry [nchunks, grid_x * grid_y], two
// launches.  The difference array of a band takes (bw+1)*(bh+1)*4 bytes of
// shared memory: the whole grid where that fits what a block may opt in
// to, else bands of whole tile rows, else bands of columns of one row.
extern "C" int svgir_counts(const int* x0, const int* y0, const int* x1, const int* y1,
                            int nchunks, int gauss_chunk, int grid_x, int grid_y,
                            int* counts, int* carry, void* stream) {
  if (grid_x < 1 || grid_y < 1 || gauss_chunk < 1 || nchunks < 0)
    return (int)cudaErrorInvalidValue;
  const long long cap = kSmemOptInMax / sizeof(int);  // difference-array entries
  int band_w = grid_x, band_h = grid_y;
  if ((long long)(grid_x + 1) * (grid_y + 1) > cap) {
    band_h = (int)(cap / (grid_x + 1)) - 1;
    if (band_h < 1) {
      band_h = 1;
      band_w = (int)(cap / 2) - 1;
    }
  }
  const long long nbands =
      (long long)((grid_x + band_w - 1) / band_w) * ((grid_y + band_h - 1) / band_h);
  if (nbands > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(band_w + 1) * (band_h + 1) * sizeof(int);
  cudaError_t err = svgir_smem_opt_in(svgir_counts_chunk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (nchunks > 0) {
    svgir_counts_chunk_kernel<<<dim3(nchunks, (unsigned)nbands), kCountThreads, smem, s>>>(
        x0, y0, x1, y1, gauss_chunk, grid_x, grid_y, band_w, band_h, carry);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int num_tiles = grid_x * grid_y;
  svgir_counts_scan_kernel<<<(num_tiles + 31) / 32, 32 * kScanWarps, 0, s>>>(nchunks, num_tiles,
                                                                             carry, counts);
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
