// B3 svgir_blend_forward replaces svgir_tpu/ops/blend_pallas_strip.py
// blend_forward_strip (_fwd_kernel), and B5 svgir_blend_forward_tiles
// replaces svgir_tpu/ops/blend_pallas.py blend_forward (_fwd_kernel):
// front-to-back alpha compositing of each tile's depth-sorted instances in
// chunks of `chunk` rows.  One kernel serves both; only the output layout
// differs (template parameter TILES).
//
// Per pixel and instance (blend_pallas._chunk_math):
//   power = -0.5 (cx dx^2 + cz dy^2) - cy dx dy,  alpha = min(0.99, o e^power)
//   ok    = power <= 0 && alpha >= 1/255
//   gate  = ok && logT_excl >= log(1e-4),  w = alpha exp(logT_excl)
// The running logT adds log1p(-alpha) for every ok instance, also after the
// pixel has saturated; from alpha 0.5 up that term is formed from 1 -
// alpha without alpha's rounding (svgir_log1m_alpha, blend_common.cuh).
// A tile stops before a chunk once no pixel of the tile (padding pixels
// included) has logT >= log(1e-4); that chunk-level granularity fixes the
// final logT of saturated pixels.
//
// Outputs, B3 (image layout): image [CA+CV+2, gy*tile, gx*tile] (plain
// sums, vertex sums, final logT, n_contrib) and eff[t] = chunks processed.
// B5 (tile-major): out [T, CA+CV+3, tile*tile], the same rows plus the
// chunks processed as a float, broadcast over the tile's pixels.  Both
// optionally write the per-instance weight sums over the tile's pixels;
// rows of skipped chunks are left as they are (the wrapper zero-fills
// wsum, which gives B5's zeros for the chunks the early exit skipped).
//
// Bound: operations.  Every (pixel, instance) pair of a processed chunk
// costs two exponentials, a log1p and ~2*(CA+4*CV)+20 flops, against a few
// bytes per pair of slab reads.  Design: one block per tile, PPT pixels per
// thread (template parameter) in the lane and warp patches of
// svgir_lane_origin (blend_common.cuh), so each slab value read from
// shared memory (a broadcast) serves PPT pixels; each chunk of slab rows is
// staged in shared memory once (optionally by cp.async into the other of
// two buffers, behind the previous chunk's work); a warp skips an instance
// when none of its pixels' power reaches the row's floor
// (svgir_power_floor: the pair cannot pass, so expf is not needed; padding
// rows land here).  Channel sums stay in registers: exact-width
// instantiations (CA, CV known when compiling: stage 1, the stage-2 step
// and its eval render) unroll every channel loop with no runtime guard,
// generic ones take the width at run time under compiled bounds.  Weight
// sums: a thread sums its own pixels, the warp sums by shuffles only where
// a lane's pixel blends, and the warps' sums are added in warp order in
// shared memory: no float atomics, so the result is deterministic.
// dispatch_forward lists the compiled kernels.
#include "blend_common.cuh"

// EXACT: ca == MAXA and cv == MAXV (the run-time widths are not read).
// ASYNC: each chunk's rows are copied in (cp.async) while the block works
// on the chunk before it, into the other of two buffers.
template <int MAXA, int MAXV, bool EXACT, int PPT, bool ASYNC, bool TILES>
__global__ void __launch_bounds__(1024 / PPT, PPT == 4 ? 2 : 1)
svgir_blend_fwd_kernel(const float* __restrict__ slab, const int* __restrict__ tile_start,
                       const int* __restrict__ tile_count, int kr, int ca_rt, int cv_rt,
                       int grid_x, int tile, int chunk, int img_w, size_t img_hw,
                       float* __restrict__ img, int* __restrict__ eff,
                       float* __restrict__ wsum) {
  constexpr int NV = MAXV > 0 ? MAXV : 1;
  const int ca = EXACT ? MAXA : ca_rt, cv = EXACT ? MAXV : cv_rt;
  const int P = tile * tile;
  const int nthreads = P / PPT, nwarps = nthreads >> 5;
  // per buffer: the chunk's rows (chunk * kr) and svgir_power_floor of
  // each row (chunk); ASYNC keeps two; then the warps' weight sums
  extern __shared__ float smem[];
  const int nbuf = chunk * (kr + 1);
  float* s_wpart = smem + (ASYNC ? 2 : 1) * nbuf;  // nwarps * chunk (weight sums only)
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t = blockIdx.x;
  const int tx0 = (t % grid_x) * tile, ty0 = (t / grid_x) * tile;
  const int start = tile_start[t];
  const int nchunks = tile_count[t] / chunk;

  using LB = SvgirLaneBlock<PPT>;
  int pix[PPT];
  float px[LB::BX], py[LB::BY], logT[PPT], nc[PPT];  // pixel j: px[j % BX], py[j / BX]
  float acc[PPT][MAXA], accv[PPT][NV];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    pix[j] = svgir_pixel<PPT>(warp, lane, j, tile);
    if (j < LB::BX) px[j] = (float)(tx0 + pix[j] % tile);
    if (j % LB::BX == 0) py[j / LB::BX] = (float)(ty0 + pix[j] / tile);
    logT[j] = 0.f;
    nc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < MAXA; ++k) acc[j][k] = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) accv[j][k] = 0.f;
  }

  // chunk cc into buffer b
  auto stage = [&](int cc, int b) {
    const float* src = slab + (size_t)(start + cc * chunk) * kr;
    float* dst = smem + b * nbuf;
    svgir_stage<ASYNC>(dst, src, chunk * kr, tid, nthreads);
    for (int e = tid; e < chunk; e += nthreads)
      dst[chunk * kr + e] = svgir_power_floor(src[e * kr + 5]);
  };
  if (ASYNC && nchunks > 0) {
    stage(0, 0);
    svgir_cp_async_commit();
  }
  int c = 0;
  for (; c < nchunks; ++c) {
    bool live = false;
#pragma unroll
    for (int j = 0; j < PPT; ++j) live |= logT[j] >= SVGIR_LOG_T_EPS;
    if (!__syncthreads_or(live)) break;
    const int cur = ASYNC ? c & 1 : 0;
    if constexpr (ASYNC) {
      svgir_cp_async_wait_all();
      __syncthreads();
      if (c + 1 < nchunks) {
        stage(c + 1, cur ^ 1);
        svgir_cp_async_commit();
      }
    } else {
      stage(c, 0);
      __syncthreads();
    }
    const float* s_slab = smem + cur * nbuf;
    const float* s_floor = s_slab + chunk * kr;
    for (int i = 0; i < chunk; ++i) {
      const float* r = s_slab + i * kr;
      const float floor_i = s_floor[i];
      float dx[PPT], dy[PPT], power[PPT];
      bool near = false;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        dx[j] = r[0] - px[j % LB::BX];
        dy[j] = r[1] - py[j / LB::BX];
        power[j] = -0.5f * (r[2] * dx[j] * dx[j] + r[4] * dy[j] * dy[j]) - r[3] * dx[j] * dy[j];
        near |= power[j] >= floor_i;
      }
      if (!__any_sync(SVGIR_FULL_MASK, near)) {
        // no pixel of the warp can pass: nothing blends, logT stays
        if (wsum != nullptr && lane == 0) s_wpart[warp * chunk + i] = 0.f;
        continue;
      }
      float ws = 0.f;
      bool any_gate = false;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const float dx_ = dx[j], dy_ = dy[j];
        const float ep = power[j] >= floor_i ? expf(power[j]) : 0.f;
        const float alpha = fminf(SVGIR_ALPHA_MAX, r[5] * ep);
        const bool ok = (power[j] <= 0.f) && (alpha >= SVGIR_ALPHA_MIN);
        const bool gate = ok && (logT[j] >= SVGIR_LOG_T_EPS);
        const float w = gate ? alpha * expf(logT[j]) : 0.f;
        if (ok) logT[j] += svgir_log1m_alpha(r, px[j % LB::BX], py[j / LB::BX], alpha);
        if (gate) {
          nc[j] += 1.f;
#pragma unroll
          for (int k = 0; k < MAXA; ++k)
            if (EXACT || k < ca) acc[j][k] += w * r[SVGIR_NG + k];
          if (MAXV > 0 && (EXACT || cv > 0)) {
            const SvgirUV q = svgir_uv(r, dx_, dy_);
            const float w0 = w * (1.f - q.u) * (1.f - q.v), w1 = w * q.u * (1.f - q.v);
            const float w2 = w * (1.f - q.u) * q.v, w3 = w * q.u * q.v;
            const float* va = r + SVGIR_NG + ca;
#pragma unroll
            for (int k = 0; k < NV; ++k)
              if (EXACT || k < cv)
                accv[j][k] += w0 * va[k] + w1 * va[cv + k] + w2 * va[2 * cv + k] +
                              w3 * va[3 * cv + k];
          }
        }
        ws += w;
        any_gate |= gate;
      }
      if (wsum != nullptr) {
        float s = 0.f;
        if (__any_sync(SVGIR_FULL_MASK, any_gate)) s = svgir_warp_sum(ws);
        if (lane == 0) s_wpart[warp * chunk + i] = s;
      }
    }
    __syncthreads();
    if (wsum != nullptr) {
      for (int i = tid; i < chunk; i += nthreads) {
        float s = 0.f;
        for (int wp = 0; wp < nwarps; ++wp) s += s_wpart[wp * chunk + i];
        wsum[start + c * chunk + i] = s;
      }
    }
  }
  if (ASYNC) svgir_cp_async_wait_all();  // a copy the early exit left in flight

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    // channel k of this pixel: image layout [k, gy, gx]; tile-major [t, k, p]
    const int gx = tx0 + pix[j] % tile, gy = ty0 + pix[j] / tile;
    const size_t o = TILES ? (size_t)t * (ca + cv + 3) * P + pix[j] : (size_t)gy * img_w + gx;
    const size_t stride = TILES ? (size_t)P : img_hw;
#pragma unroll
    for (int k = 0; k < MAXA; ++k)
      if (EXACT || k < ca) img[k * stride + o] = acc[j][k];
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (MAXV > 0 && (EXACT || k < cv)) img[(ca + k) * stride + o] = accv[j][k];
    img[(ca + cv) * stride + o] = logT[j];
    img[(ca + cv + 1) * stride + o] = nc[j];
    if (TILES) img[(ca + cv + 2) * stride + o] = (float)c;
  }
  if (eff != nullptr && tid == 0) eff[t] = c;
}

// info != nullptr: no launch; info gets the kernel's resident blocks per
// SM, threads per block, pixels per thread, shared-memory bytes, 0 and
// asynchronous staging.
template <int PPT, bool ASYNC>
static size_t forward_smem(int kr, int tile, int chunk, bool with_wsum) {
  return ((ASYNC ? 2 : 1) * (size_t)chunk * (kr + 1) +
          (with_wsum ? (size_t)(tile * tile / PPT / 32) * chunk : 0)) *
         sizeof(float);
}

// Whether that kernel takes this tile and chunk: its lane patches tile the
// tile and its block fits in shared memory.
template <int PPT, bool ASYNC>
static bool forward_fits(int kr, int tile, int chunk, bool with_wsum) {
  return svgir_ppt_fits(PPT, tile) &&
         forward_smem<PPT, ASYNC>(kr, tile, chunk, with_wsum) <= SVGIR_SMEM_MAX;
}

template <int MAXA, int MAXV, bool EXACT, int PPT, bool ASYNC, bool TILES>
static int launch_forward(const float* slab, const int* tile_start, const int* tile_count,
                          int kr, int ca, int cv, int grid_x, int grid_y, int tile, int chunk,
                          float* img, int* eff, float* wsum, cudaStream_t stream, int* info) {
  if (!svgir_ppt_fits(PPT, tile)) return (int)cudaErrorInvalidValue;
  const int nthreads = tile * tile / PPT;
  const size_t smem = forward_smem<PPT, ASYNC>(kr, tile, chunk, wsum != nullptr);
  auto kernel = svgir_blend_fwd_kernel<MAXA, MAXV, EXACT, PPT, ASYNC, TILES>;
  cudaError_t err = svgir_smem_opt_in(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    info[4] = 0;
    info[5] = ASYNC;
    return svgir_occupancy(kernel, nthreads, PPT, smem, info);
  }
  const int img_w = grid_x * tile;
  const size_t img_hw = (size_t)grid_y * tile * img_w;
  if (grid_x * grid_y > 0)
    kernel<<<grid_x * grid_y, nthreads, smem, stream>>>(slab, tile_start, tile_count, kr, ca,
                                                        cv, grid_x, tile, chunk, img_w, img_hw,
                                                        img, eff, wsum);
  return (int)cudaGetLastError();
}

// One compiled kernel per width: exact widths (14, 0) (stage 1), (13, 13)
// (the stage-2 step) and (16, 16) (its eval render) at the pixels per
// thread and staging that ran fastest on the bench inputs of an H100
// (PERF.md); generic widths under the bounds ca <= 16, cv = 0 and ca <= 32,
// cv <= 16 at one pixel per thread.  An exact width whose kernel does not
// take the tile or chunk (its lane patches do not tile the tile, or its two
// buffers outgrow shared memory) takes the generic kernel, which tiles
// every side the wrappers accept (a multiple of 8) with one buffer.
template <bool TILES>
static int dispatch_forward(const float* slab, const int* tile_start, const int* tile_count,
                            int kr, int ca, int cv, int grid_x, int grid_y, int tile, int chunk,
                            float* img, int* eff, float* wsum, void* stream,
                            int* info = nullptr) {
  cudaStream_t s = (cudaStream_t)stream;
#define SVGIR_FWD(A, V, EX, PP, AS)                                                            \
  return launch_forward<A, V, EX, PP, AS, TILES>(slab, tile_start, tile_count, kr, ca, cv,     \
                                                 grid_x, grid_y, tile, chunk, img, eff, wsum, s, \
                                                 info)
  const bool ws = wsum != nullptr;
  if (ca == 14 && cv == 0 && forward_fits<2, false>(kr, tile, chunk, ws))
    SVGIR_FWD(14, 0, true, 2, false);
  if (ca == 13 && cv == 13 && forward_fits<1, true>(kr, tile, chunk, ws))
    SVGIR_FWD(13, 13, true, 1, true);
  if (ca == 16 && cv == 16 && forward_fits<1, false>(kr, tile, chunk, ws))
    SVGIR_FWD(16, 16, true, 1, false);
  if (cv == 0 && ca <= 16) SVGIR_FWD(16, 0, false, 1, false);
  if (ca <= 32 && cv <= 16) SVGIR_FWD(32, 16, false, 1, false);
#undef SVGIR_FWD
  return (int)cudaErrorInvalidValue;
}

// Channel bounds of the compiled kernels; the Python wrapper checks them
// before the call (kernels/blend.py).
extern "C" int svgir_blend_forward(const float* slab, const int* tile_start,
                                   const int* tile_count, int kr, int ca, int cv, int grid_x,
                                   int grid_y, int tile, int chunk, float* img, int* eff,
                                   float* wsum, void* stream) {
  return dispatch_forward<false>(slab, tile_start, tile_count, kr, ca, cv, grid_x, grid_y,
                                 tile, chunk, img, eff, wsum, stream);
}

// B5: out [T, CA+CV+3, tile*tile] (tile-major), no separate eff array.
extern "C" int svgir_blend_forward_tiles(const float* slab, const int* tile_start,
                                         const int* tile_count, int kr, int ca, int cv,
                                         int grid_x, int grid_y, int tile, int chunk,
                                         float* out, float* wsum, void* stream) {
  return dispatch_forward<true>(slab, tile_start, tile_count, kr, ca, cv, grid_x, grid_y,
                                tile, chunk, out, nullptr, wsum, stream);
}

// The kernel a launch at these widths, tile and chunk takes: info[6] =
// resident blocks per SM, threads per block, pixels per thread,
// shared-memory bytes, 0, asynchronous staging (nothing is launched).
extern "C" int svgir_blend_forward_info(int kr, int ca, int cv, int tile, int chunk,
                                        int with_wsum, int* info) {
  float dummy = 0.f;
  return dispatch_forward<false>(nullptr, nullptr, nullptr, kr, ca, cv, 1, 1, tile, chunk,
                                 nullptr, nullptr, with_wsum ? &dummy : nullptr, nullptr, info);
}
