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
// pixel has saturated.  A tile stops before a chunk once no pixel of the
// tile (padding pixels included) has logT >= log(1e-4); that chunk-level
// granularity fixes the final logT of saturated pixels.
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
// bytes per pair of slab reads.  Design: one block per tile and one thread
// per pixel; each chunk of slab rows is staged in shared memory once and
// read as broadcasts; channel sums stay in registers (template bounds
// MAXA/MAXV with guarded, fully unrolled loops keep the indexing static).
// Weight sums reduce by warp shuffles, then across warps in a fixed order
// in shared memory: no float atomics, so the result is deterministic.
#include "blend_common.cuh"

template <int MAXA, int MAXV, bool TILES>
__global__ void __launch_bounds__(1024)
svgir_blend_fwd_kernel(const float* __restrict__ slab, const int* __restrict__ tile_start,
                       const int* __restrict__ tile_count, int kr, int ca, int cv,
                       int grid_x, int tile, int chunk, int img_w, size_t img_hw,
                       float* __restrict__ img, int* __restrict__ eff,
                       float* __restrict__ wsum) {
  extern __shared__ float smem[];
  float* s_slab = smem;                // chunk * kr
  float* s_wpart = smem + chunk * kr;  // nwarps * chunk (weight sums only)
  const int P = tile * tile;
  const int p = threadIdx.x;
  const int warp = p >> 5, lane = p & 31, nwarps = P >> 5;
  const int t = blockIdx.x;
  const int gx = (t % grid_x) * tile + p % tile;
  const int gy = (t / grid_x) * tile + p / tile;
  const float px = (float)gx, py = (float)gy;
  const int start = tile_start[t];
  const int nchunks = tile_count[t] / chunk;
  constexpr int NV = MAXV > 0 ? MAXV : 1;

  float acc[MAXA];
  float accv[NV];
#pragma unroll
  for (int k = 0; k < MAXA; ++k) acc[k] = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) accv[k] = 0.f;
  float logT = 0.f, nc = 0.f;

  int c = 0;
  for (; c < nchunks; ++c) {
    if (!__syncthreads_or(logT >= SVGIR_LOG_T_EPS)) break;
    const float* src = slab + (size_t)(start + c * chunk) * kr;
    for (int e = p; e < chunk * kr; e += P) s_slab[e] = src[e];
    __syncthreads();
    for (int i = 0; i < chunk; ++i) {
      const float* r = s_slab + i * kr;
      const float dx = r[0] - px, dy = r[1] - py;
      const float power = -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
      const float alpha = fminf(SVGIR_ALPHA_MAX, r[5] * expf(power));
      const bool ok = (power <= 0.f) && (alpha >= SVGIR_ALPHA_MIN);
      const bool gate = ok && (logT >= SVGIR_LOG_T_EPS);
      const float w = gate ? alpha * expf(logT) : 0.f;
      if (ok) logT += log1pf(-alpha);
      if (gate) {
        nc += 1.f;
#pragma unroll
        for (int k = 0; k < MAXA; ++k)
          if (k < ca) acc[k] += w * r[SVGIR_NG + k];
        if (MAXV > 0 && cv > 0) {
          const SvgirUV q = svgir_uv(r, dx, dy);
          const float w0 = w * (1.f - q.u) * (1.f - q.v), w1 = w * q.u * (1.f - q.v);
          const float w2 = w * (1.f - q.u) * q.v, w3 = w * q.u * q.v;
          const float* va = r + SVGIR_NG + ca;
#pragma unroll
          for (int k = 0; k < NV; ++k)
            if (k < cv)
              accv[k] += w0 * va[k] + w1 * va[cv + k] + w2 * va[2 * cv + k] +
                         w3 * va[3 * cv + k];
        }
      }
      if (wsum != nullptr) {
        float ws = 0.f;
        if (__any_sync(SVGIR_FULL_MASK, gate)) ws = svgir_warp_sum(w);
        if (lane == 0) s_wpart[warp * chunk + i] = ws;
      }
    }
    __syncthreads();
    if (wsum != nullptr) {
      for (int i = p; i < chunk; i += P) {
        float s = 0.f;
        for (int wp = 0; wp < nwarps; ++wp) s += s_wpart[wp * chunk + i];
        wsum[start + c * chunk + i] = s;
      }
    }
  }

  // channel k of this pixel: image layout [k, gy, gx]; tile-major [t, k, p]
  const size_t o = TILES ? (size_t)t * (ca + cv + 3) * P + p : (size_t)gy * img_w + gx;
  const size_t stride = TILES ? (size_t)P : img_hw;
#pragma unroll
  for (int k = 0; k < MAXA; ++k)
    if (k < ca) img[k * stride + o] = acc[k];
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (MAXV > 0 && k < cv) img[(ca + k) * stride + o] = accv[k];
  img[(ca + cv) * stride + o] = logT;
  img[(ca + cv + 1) * stride + o] = nc;
  if (TILES) img[(ca + cv + 2) * stride + o] = (float)c;
  if (eff != nullptr && p == 0) eff[t] = c;
}

template <int MAXA, int MAXV, bool TILES>
static int launch_forward(const float* slab, const int* tile_start, const int* tile_count,
                          int kr, int ca, int cv, int grid_x, int grid_y, int tile, int chunk,
                          float* img, int* eff, float* wsum, cudaStream_t stream) {
  const int P = tile * tile;
  const size_t smem = ((size_t)chunk * kr + (wsum ? (size_t)(P / 32) * chunk : 0)) * sizeof(float);
  auto kernel = svgir_blend_fwd_kernel<MAXA, MAXV, TILES>;
  cudaError_t err = svgir_smem_opt_in(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int img_w = grid_x * tile;
  const size_t img_hw = (size_t)grid_y * tile * img_w;
  if (grid_x * grid_y > 0)
    kernel<<<grid_x * grid_y, P, smem, stream>>>(slab, tile_start, tile_count, kr, ca, cv,
                                                 grid_x, tile, chunk, img_w, img_hw, img,
                                                 eff, wsum);
  return (int)cudaGetLastError();
}

template <bool TILES>
static int dispatch_forward(const float* slab, const int* tile_start, const int* tile_count,
                            int kr, int ca, int cv, int grid_x, int grid_y, int tile, int chunk,
                            float* img, int* eff, float* wsum, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cv == 0 && ca <= 16)
    return launch_forward<16, 0, TILES>(slab, tile_start, tile_count, kr, ca, cv, grid_x,
                                        grid_y, tile, chunk, img, eff, wsum, s);
  if (ca <= 32 && cv <= 16)
    return launch_forward<32, 16, TILES>(slab, tile_start, tile_count, kr, ca, cv, grid_x,
                                         grid_y, tile, chunk, img, eff, wsum, s);
  return (int)cudaErrorInvalidValue;
}

// Channel bounds of the two compiled variants; the Python wrapper checks
// them before the call (kernels/blend.py).
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
