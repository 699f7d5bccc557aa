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
// enumeration, its Gaussian g (the last with offsets[g] <= j), its tile
// (y outer, x inner over g's rect) and its output slot
//   slot = table[chunk(g), tile] + #{g' in [chunk_start(g), g) covering tile}
// where table already holds carry + chunk-aligned tile starts; slot m and
// gid -1 for every j in [total_raw, m).
//   Bound: bytes (8 B written per slot, the Gaussian-side arrays read once,
//   one table entry per instance): 0.9 us at the bench's 165,888 slots.
//   The TPU kernel takes blocks of instances and finds each one's Gaussian
//   and in-chunk rank by comparing it with a window of rects; one thread
//   per instance doing the same here (a binary search over all offsets,
//   then up to 255 rect tests) is O(instances x chunk) work.
//   Design: one block per (Gaussian chunk, band of the grid), nothing
//   searched in global memory, no rect tests.  The block loads its chunk's
//   rects, clipped to the band, with each one's in-band instance count,
//   and the band's part of the table into shared memory, and scans the
//   counts (a chunk with none in the band ends there: on the bench 130 of
//   196 chunks hold only culled Gaussians).  Walk 1 gives each Gaussian
//   threads that take its clipped rect's tiles row by row and set bit
//   (g mod 32) of each tile's word for g's group of 32 Gaussians (a
//   shared-memory atomicOr: exact in any order); they also write each
//   instance's (Gaussian, tile) into a map in shared memory.  A pass over
//   the tiles then counts, per tile and group, the covering Gaussians of
//   the earlier groups.  Walk 2 takes the map's instances, a thread each:
//   rank = that count plus the set bits below g's in its group's word
//   (popc), which is the number of earlier Gaussians of the chunk whose
//   rect covers the tile, exactly; it writes slot and gid at j =
//   offsets[g] + the tile's place in g's rect, consecutive instances at
//   consecutive j.  The map holds 4,096 instances: a chunk with more is
//   walked in windows, each window's map filled by the per-Gaussian loops.
//   Timed on an H100 on the bench step, a first version that walked the
//   instances in both walks, each finding its Gaussian by a binary search
//   over the scanned counts and its tile by a division, ran 0.0102-0.0117
//   ms; ranking by a loop over the earlier groups' words, 0.0079-0.0082.
//   A tile takes its table entry, (gauss_chunk/32, rounded up to odd)
//   words and gauss_chunk/32 two-byte counts of shared memory (56 B at
//   gauss_chunk 256, the odd stride keeping neighbouring tiles off one
//   bank); a grid past a block's shared memory is walked in bands of
//   whole tile rows (or of a row's columns), as B1 counts it, each band a
//   block of its own.  Extra blocks at the end of the launch fill
//   [total_raw, m).  The rects must lie in the grid, as preprocess's
//   clamped tile rects do.  Int32 throughout.
#include "blend_common.cuh"

static const int kCountThreads = 256;  // pass 1: threads per chunk block
static const int kSmemOptInMax = 232448;  // bytes of shared memory a block may use
static const int kScanWarps = 16;      // pass 2: warps splitting the chunks
static const int kInstThreads = 512;   // B2: threads per (chunk, band) block
static const int kInstTailPer = 4;     // B2: slots past total_raw per thread
static const int kInstWindow = 4096;   // B2: instances mapped at a time
static const int kInstTabRegs = 2;     // B2: table entries a thread prefetches

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

// B2.  Blocks [0, nwork) take (chunk, band) = (b / nbands, b % nbands); the
// blocks after them write slot m, gid -1 past total_raw.
__global__ void __launch_bounds__(kInstThreads)
svgir_instances_kernel(const int* __restrict__ x0, const int* __restrict__ y0,
                       const int* __restrict__ x1, const int* __restrict__ y1,
                       const int* __restrict__ offsets, const int* __restrict__ order,
                       const int* __restrict__ table, const int* __restrict__ total_raw,
                       int m, int gauss_chunk, int grid_x, int grid_y, int band_w,
                       int band_h, int nbands, int nwork, int* __restrict__ slot,
                       int* __restrict__ gid) {
  const int n_raw = *total_raw;
  if ((int)blockIdx.x >= nwork) {
    const int j0 = (blockIdx.x - nwork) * (kInstThreads * kInstTailPer) + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kInstTailPer; ++k) {
      const int j = j0 + k * kInstThreads;
      if (j < m && j >= n_raw) {
        slot[j] = m;
        gid[j] = -1;
      }
    }
    return;
  }
  const int gc = gauss_chunk, ng = (gc + 31) >> 5;  // ng groups of 32
  const int ts = ng | 1;  // words per tile: one per group, odd stride
  extern __shared__ int s_i[];
  int* s_pre = s_i;             // [gc] exclusive scan of the in-band counts
  int* s_ax = s_pre + gc;       // clipped rect's first tile, band coordinates
  int* s_ay = s_ax + gc;
  int* s_cw = s_ay + gc;        // clipped rect's width and height (0 if empty)
  int* s_ch = s_cw + gc;
  int* s_w = s_ch + gc;         // the rect's width
  int* s_j0 = s_w + gc;         // j of the clipped rect's first tile
  int* s_ord = s_j0 + gc;       // original Gaussian id
  int* s_warp = s_ord + gc;     // [kInstThreads / 32] the scan's warp totals
  unsigned* s_map = (unsigned*)(s_warp + kInstThreads / 32);  // [kInstWindow]
  int* s_tab = (int*)(s_map + kInstWindow);                   // [bw * bh] table
  unsigned* s_mask = (unsigned*)(s_tab + band_w * band_h);    // [bw * bh][ts]
  unsigned short* s_below = (unsigned short*)(s_mask + band_w * band_h * ts);
                                // [bw * bh][ng] covering Gaussians of earlier groups

  const int chunk = blockIdx.x / nbands, band = blockIdx.x - chunk * nbands;
  const int nbx = (grid_x + band_w - 1) / band_w;
  const int bx0 = (band % nbx) * band_w, by0 = (band / nbx) * band_h;
  const int bw = min(band_w, grid_x - bx0), bh = min(band_h, grid_y - by0);
  const int ntile = bw * bh;
  const int* tab = table + (size_t)chunk * grid_x * grid_y;
  // the band's first table entries, loaded while the rects are
  int tab_r[kInstTabRegs];
#pragma unroll
  for (int k = 0; k < kInstTabRegs; ++k) {
    const int t = threadIdx.x + k * kInstThreads;
    tab_r[k] = t < ntile ? tab[(size_t)(by0 + t / bw) * grid_x + bx0 + t % bw] : 0;
  }

  // each thread takes `per` consecutive Gaussians of the chunk
  const int per = (gc + kInstThreads - 1) / kInstThreads;
  const int i0 = min((int)threadIdx.x * per, gc), i1 = min(i0 + per, gc);
  const size_t g0 = (size_t)chunk * gc;
  int own = 0;
  for (int i = i0; i < i1; ++i) {
    const size_t g = g0 + i;
    const int gx0 = x0[g], gy0 = y0[g], w = x1[g] - gx0, off = offsets[g];
    const int a = max(gx0, bx0), b = min(x1[g], bx0 + bw);
    const int c = max(gy0, by0), d = min(y1[g], by0 + bh);
    const int cw = max(b - a, 0), ch = max(d - c, 0);
    s_ax[i] = a - bx0;
    s_ay[i] = c - by0;
    s_cw[i] = cw;
    s_ch[i] = ch;
    s_w[i] = w;
    s_j0[i] = cw * ch ? off + (c - gy0) * w + (a - gx0) : 0;
    s_ord[i] = order[g];
    own += cw * ch;
  }
  // exclusive scan of the counts over the block: threads in order
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(SVGIR_FULL_MASK, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[wp] = incl;
  __syncthreads();
  int run = incl - own, total = 0;  // this thread's start, the block's sum
#pragma unroll
  for (int k = 0; k < kInstThreads / 32; ++k) {
    const int v = s_warp[k];
    run += k < wp ? v : 0;
    total += v;
  }
  if (total == 0) return;  // the whole block: nothing of this chunk in the band
  for (int i = i0; i < i1; ++i) {
    s_pre[i] = run;
    run += s_cw[i] * s_ch[i];
  }
#pragma unroll
  for (int k = 0; k < kInstTabRegs; ++k) {
    const int t = threadIdx.x + k * kInstThreads;
    if (t < ntile) s_tab[t] = tab_r[k];
  }
  for (int t = threadIdx.x + kInstTabRegs * kInstThreads; t < ntile; t += kInstThreads)
    s_tab[t] = tab[(size_t)(by0 + t / bw) * grid_x + bx0 + t % bw];
  for (int t = threadIdx.x; t < ntile * ts; t += kInstThreads) s_mask[t] = 0;
  __syncthreads();

  // The per-Gaussian loops give each Gaussian `sub` threads, which take
  // its clipped rect's rows in turn (no search, no division per tile).
  const int sub = max(1, kInstThreads / gc);
  // Walk 1: the coverage bit of each (Gaussian, tile), and the first
  // window's map e -> (Gaussian, tile).
  for (int it = threadIdx.x; it < gc * sub; it += kInstThreads) {
    const int i = it % gc, cw = s_cw[i], ch = s_ch[i], pre = s_pre[i];
    const unsigned t0 = s_ay[i] * bw + s_ax[i], key = (unsigned)i << 16;
    unsigned* word = s_mask + (i >> 5);
    const unsigned bit = 1u << (i & 31);
    for (int r = it / gc; r < ch; r += sub)
      for (int c = 0; c < cw; ++c) {
        const unsigned t = t0 + r * bw + c;
        atomicOr(word + t * ts, bit);
        const int e = pre + r * cw + c;
        if (e < kInstWindow) s_map[e] = key | t;
      }
  }
  __syncthreads();
  // below[t][q] = the chunk's Gaussians of groups before q covering tile t
  // (eight words loaded before their eight counts are stored)
  for (int t = threadIdx.x; t < ntile; t += kInstThreads) {
    int acc = 0;
    for (int q0 = 0; q0 < ng; q0 += 8) {
      unsigned w8[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) w8[k] = q0 + k < ng ? s_mask[t * ts + q0 + k] : 0u;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (q0 + k < ng) s_below[t * ng + q0 + k] = (unsigned short)acc;
        acc += __popc(w8[k]);
      }
    }
  }
  // Walk 2, a window of kInstWindow instances at a time (the map of each
  // later window filled per Gaussian): a thread per instance writes its
  // slot, rank = the chunk's Gaussians before g covering the tile (the
  // earlier groups' count plus the bits below g's in its own group's
  // word); stores at consecutive j coalesce.  The tile's row is
  // t * magic >> 32, exact for t, bw <= 2^16.
  const unsigned long long magic = ((1ull << 32) + bw - 1) / bw;
  for (int e0 = 0; e0 < total; e0 += kInstWindow) {
    if (e0 > 0) {
      __syncthreads();  // the last window is read
      for (int it = threadIdx.x; it < gc * sub; it += kInstThreads) {
        const int i = it % gc, cw = s_cw[i], ch = s_ch[i], pre = s_pre[i] - e0;
        if (pre >= kInstWindow || pre + cw * ch <= 0) continue;
        const unsigned t0 = s_ay[i] * bw + s_ax[i];
        for (int r = it / gc; r < ch; r += sub) {
          const int lo = max(-(pre + r * cw), 0), hi = min(kInstWindow - pre - r * cw, cw);
          for (int c = lo; c < hi; ++c)
            s_map[pre + r * cw + c] = ((unsigned)i << 16) | (t0 + r * bw + c);
        }
      }
    }
    __syncthreads();  // the counts below are complete, the window's map filled
    const int n = min(total - e0, kInstWindow);
    for (int e = threadIdx.x; e < n; e += kInstThreads) {
      const unsigned v = s_map[e];
      const int i = v >> 16, t = v & 0xffff;
      const int ly = (int)(((unsigned long long)t * magic) >> 32), lx = t - ly * bw;
      const int j = s_j0[i] + (ly - s_ay[i]) * s_w[i] + lx - s_ax[i];
      if (j >= n_raw || j >= m) continue;
      const int q = i >> 5;
      const int rank = s_below[t * ng + q] +
                       __popc(s_mask[t * ts + q] & ((1u << (i & 31)) - 1u));
      slot[j] = s_tab[t] + rank;
      gid[j] = s_ord[i];
    }
  }
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

// B2: slot and gid [m].  Shared memory per block: 8 * gauss_chunk + 16 ints
// of the chunk's rects and scan, the instance map, and per tile of the band
// its table entry, ts coverage words and ng counts; a grid
// whose words exceed what a block may opt in to is walked in bands of
// whole tile rows, else of a row's columns.
extern "C" int svgir_instances(const int* x0, const int* y0, const int* x1, const int* y1,
                               const int* offsets, const int* order, const int* table,
                               const int* total_raw, int ns, int m, int gauss_chunk,
                               int grid_x, int num_tiles, int* slot, int* gid, void* stream) {
  if (gauss_chunk < 1 || ns < 0 || ns % gauss_chunk || m < 0 || grid_x < 1 ||
      num_tiles < grid_x || num_tiles % grid_x)
    return (int)cudaErrorInvalidValue;
  const int grid_y = num_tiles / grid_x;
  const long long ng = (gauss_chunk + 31) / 32;
  const long long tile_b = 4LL * ((ng | 1) + 1) + 2LL * ng;
  const long long fixed = 4LL * (8LL * gauss_chunk + kInstThreads / 32 + kInstWindow);
  long long cap = (kSmemOptInMax - fixed) / tile_b;  // tiles a band may hold
  if (cap > 65536) cap = 65536;  // the instance map keeps a tile in 16 bits
  if (cap < 1 || gauss_chunk > 65536) return (int)cudaErrorInvalidValue;
  int band_w = grid_x, band_h = grid_y;
  if ((long long)num_tiles > cap) {
    band_h = (int)(cap / grid_x);
    if (band_h < 1) {
      band_h = 1;
      band_w = (int)cap;
    }
  }
  const long long nbands =
      (long long)((grid_x + band_w - 1) / band_w) * ((grid_y + band_h - 1) / band_h);
  const long long nwork = (long long)(ns / gauss_chunk) * nbands;
  const long long ntail = ((long long)m + kInstThreads * kInstTailPer - 1) /
                          (kInstThreads * kInstTailPer);
  if (nwork + ntail > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(fixed + tile_b * band_w * band_h);
  cudaError_t err = svgir_smem_opt_in(svgir_instances_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (nwork + ntail > 0)
    svgir_instances_kernel<<<(unsigned)(nwork + ntail), kInstThreads, smem,
                             (cudaStream_t)stream>>>(
        x0, y0, x1, y1, offsets, order, table, total_raw, m, gauss_chunk, grid_x, grid_y,
        band_w, band_h, (int)nbands, (int)nwork, slot, gid);
  return (int)cudaGetLastError();
}
