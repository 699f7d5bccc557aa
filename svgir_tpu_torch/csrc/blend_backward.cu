// B4 svgir_blend_backward replaces svgir_tpu/ops/blend_pallas_strip.py
// blend_backward_strip (_bwd_kernel), and B6 svgir_blend_backward_tiles
// replaces svgir_tpu/ops/blend_pallas.py blend_backward (_bwd_kernel):
// per-instance gradient rows d_slab [M, KR] of the forward blend
// (blend_forward.cu).  One kernel serves both; only the layout of the
// cotangents and of the forward's outputs differs (template parameter
// TILES).  B4 reads image-layout cotangents g_img [>= CA+CV+1, Hp, Wp], the
// final logT image and eff[t]; B6 reads tile-major g_out [T, CA+CV+3,
// tile*tile] and the forward's meta block [T, 3, tile*tile] (final logT in
// row 0, chunks processed in row 2, from which it takes eff).
//
// Each tile sweeps its processed chunks (eff[t], from the forward) from last
// to first and walks the instances of a chunk backwards, rebuilding the
// log-transmittance from the forward's final logT:
//   logT_excl_i = logT_after_i - loga_i
//   d_loga_i    = g_logT + sum_{j > i} dw_j w_j
// (loga_i the forward's own term, svgir_log1m_alpha in blend_common.cuh),
// and forming the rows of _bwd_kernel: d_mean2d, d_conic, d_opacity (only
// where alpha < 0.99), d_Jinv and d_lam (through the interior of the u, v
// clamps), the plain rows g . w and the vertex rows g . w . bilinear weight.
// dw adds the weight-sum cotangent g_wsum[i] when one is given.  Rows of
// chunks the forward skipped, and of padding, stay zero (the caller
// zero-fills d_slab).
//
// Bound: operations, as the forward, plus one sum over the tile's pixels
// for each of the KR rows of every instance.  Only ~12% of the (pixel,
// instance) pairs of the bench step pass the footprint test, so what the
// kernel spends on the pairs that do not, and on the row sums, decides its
// time.  Design:
// - One block per tile (so an instance's row needs no sum across blocks),
//   PPT pixels per thread (template parameter): a lane owns a 1x1, 1x2 or
//   2x2 block of pixels and a warp an 8x4, 8x8 or 16x8 patch of the tile,
//   so a small footprint wakes few warps.  A warp skips an instance when
//   none of its pixels' power reaches the row's floor (svgir_power_floor:
//   below it the pair cannot pass, so expf is not needed; padding rows,
//   opacity 0, land here), or when none passes the footprint test; the
//   terms it skips are exact zeros.
// - Exact-width instantiations (CA, CV known when compiling: the stage-1
//   and stage-2 widths) unroll every channel loop with no runtime guard;
//   generic ones take the width at run time under compiled bounds.
// - Row sums: a thread sums its own pixels' terms in registers, then the
//   warp reduces the rows in groups of 16 with a reduce-scatter butterfly
//   (8 + 4 + 2 + 1 + 1 shuffles per 16 rows, each lane left with one row's
//   sum), and the lanes park the sums in shared memory.  Every IB
//   instances one barrier; then the block sums each row over the warps
//   that saw the instance, in warp order, while the warps go on with the
//   next IB instances (the partial sums are double-buffered).  Every sum
//   has a fixed order and there are no atomics: the rows are the same on
//   every run.  With CV = 0 the d_Jinv and d_lam rows are zero and are not
//   summed.
// - Per compiled width: PPT, IB and whether the chunk's rows are copied in
//   asynchronously (cp.async, two buffers) behind the previous chunk's
//   work (dispatch_backward).
// The per-Gaussian sums of the rows stay outside, as in the reference's
// custom VJP: ops/rasterizer.py hands d_slab to R1 (gaussian_rows.cu),
// which sums each Gaussian's rows over the binner's instance lists.
#include "blend_common.cuh"

// Rows of an instance that are summed, in the order of the kernel's
// "slots": the 12 geometry rows (6 with no vertex channels: d_Jinv and
// d_lam are then zero), MAXA plain rows, then 4 * MAXV vertex rows
// (vertex-major).
template <int MAXA, int MAXV>
struct SvgirBwdSlots {
  static constexpr int NGEO = MAXV > 0 ? SVGIR_NG : 6;
  static constexpr int N = NGEO + MAXA + 4 * MAXV;
};

// Per-pixel terms of one (pixel, instance) pair that the rows are made of.
struct SvgirBwdTerms {
  float dx, dy, dp, dae, w, du0, du1, lamx, lamy, a[4];
};

// Reduce-scatter of the N values v[0..N) of each lane over the warp (N a
// power of two up to 32): lane l ends with v[0] = the warp's sum of value
// l >> (5 - log2 N).  Halving levels exchange half of the values with the
// partner lane; once one value is left, the remaining levels add.
template <int N, int O>
struct SvgirReduceScatter {
  __device__ __forceinline__ static void run(float* v, int lane) {
    if constexpr (O == 0) {
      return;
    } else if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float send = up ? v[j] : v[j + H];
        const float keep = up ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(SVGIR_FULL_MASK, send, O);
      }
      SvgirReduceScatter<H, O / 2>::run(v, lane);
    } else {
      v[0] += __shfl_xor_sync(SVGIR_FULL_MASK, v[0], O);
      SvgirReduceScatter<1, O / 2>::run(v, lane);
    }
  }
};

// Slot s (a constant once the callers' loops are unrolled) of one pixel;
// gp(k): the pixel's plain cotangent k, gv its vertex cotangents.
template <int MAXA, int MAXV, class GP>
__device__ __forceinline__ float svgir_bwd_slot(int s, const float* r, const SvgirBwdTerms& q,
                                                GP gp, const float* gv) {
  using SL = SvgirBwdSlots<MAXA, MAXV>;
  if (s < SL::NGEO) {
    const float m0 = q.dp * (-r[2] * q.dx - r[3] * q.dy);
    const float m1 = q.dp * (-r[4] * q.dy - r[3] * q.dx);
    switch (s) {
      case 0: return MAXV > 0 ? m0 + q.du0 * r[6] + q.du1 * r[8] : m0;
      case 1: return MAXV > 0 ? m1 + q.du0 * r[7] + q.du1 * r[9] : m1;
      case 2: return q.dp * (-0.5f * q.dx * q.dx);
      case 3: return q.dp * (-q.dx * q.dy);
      case 4: return q.dp * (-0.5f * q.dy * q.dy);
      case 5: return q.dae;
      case 6: return q.du0 * q.dx;
      case 7: return q.du0 * q.dy;
      case 8: return q.du1 * q.dx;
      case 9: return q.du1 * q.dy;
      case 10: return q.lamx;
      default: return q.lamy;
    }
  }
  if (s < SL::NGEO + MAXA) return gp(s - SL::NGEO) * q.w;
  if (s < SL::N) {
    const int e = s - SL::NGEO - MAXA;
    return gv[e % (MAXV > 0 ? MAXV : 1)] * q.a[e / (MAXV > 0 ? MAXV : 1)];
  }
  return 0.f;
}

// The d_slab column of slot s, or -1 for a slot past the run-time width.
template <int MAXA, int MAXV>
__device__ __forceinline__ int svgir_bwd_row(int s, int ca, int cv) {
  using SL = SvgirBwdSlots<MAXA, MAXV>;
  if (s < SL::NGEO) return MAXV > 0 ? s : (s < 6 ? s : -1);
  if (s < SL::NGEO + MAXA) {
    const int k = s - SL::NGEO;
    return k < ca ? SVGIR_NG + k : -1;
  }
  const int e = s - SL::NGEO - MAXA, vtx = e / (MAXV > 0 ? MAXV : 1),
            k = e % (MAXV > 0 ? MAXV : 1);
  return k < cv ? SVGIR_NG + ca + vtx * cv + k : -1;
}

// EXACT: ca == MAXA and cv == MAXV (the run-time widths are not read).
// IB: instances per round of cross-warp sums.  ASYNC: each chunk's rows are
// copied in (cp.async) while the block works on the chunk before it, into
// the other of two buffers.  GP_SMEM: each thread parks its pixels' plain
// cotangents in shared memory and reads them at each use (svgir_lds), which
// spares PPT * MAXA registers: at the stage-2 width this keeps the kernel
// within 128 registers without spilling.
template <int MAXA, int MAXV, bool EXACT, int PPT, int IB, bool ASYNC, bool TILES, bool GP_SMEM>
__global__ void __launch_bounds__(1024 / PPT, PPT == 4 ? 2 : 1)
svgir_blend_bwd_kernel(const float* __restrict__ slab, const int* __restrict__ tile_start,
                       const int* __restrict__ eff, const float* __restrict__ g_img,
                       const float* __restrict__ logt_img, const float* __restrict__ g_wsum,
                       int kr, int ca_rt, int cv_rt, int grid_x, int tile, int chunk, int img_w,
                       size_t img_hw, float* __restrict__ d_slab) {
  using SL = SvgirBwdSlots<MAXA, MAXV>;
  constexpr int NV = MAXV > 0 ? MAXV : 1;
  const int ca = EXACT ? MAXA : ca_rt, cv = EXACT ? MAXV : cv_rt;
  const int P = tile * tile;
  const int nthreads = P / PPT, nwarps = nthreads >> 5;
  // per buffer: the chunk's rows (chunk * kr), g_wsum (chunk) and
  // svgir_power_floor of each row (chunk); ASYNC keeps two
  extern __shared__ float smem[];
  const int nbuf = chunk * (kr + 2);
  float* s_part = smem + (ASYNC ? 2 : 1) * nbuf;          // 2 * IB * nwarps * SL::N
  int* s_act = reinterpret_cast<int*>(s_part + 2 * IB * nwarps * SL::N);
                                                          // 2 * IB * nwarps
  float* s_gp = reinterpret_cast<float*>(s_act + 2 * IB * nwarps);  // GP_SMEM: MAXA * P
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t = blockIdx.x;
  const int tx0 = (t % grid_x) * tile, ty0 = (t / grid_x) * tile;
  const int start = tile_start[t];
  // TILES: logt_img is the meta block [T, 3, P] (logT, n_contrib, chunks)
  const int ne = TILES ? (int)logt_img[(size_t)t * 3 * P + 2 * P] : eff[t];
  const size_t stride = TILES ? (size_t)P : img_hw;

  using LB = SvgirLaneBlock<PPT>;
  float px[LB::BX], py[LB::BY];  // pixel j: (px[j % BX], py[j / BX])
  float logT[PPT], S[PPT];
  float gp[PPT][MAXA], gv[PPT][NV];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = svgir_pixel<PPT>(warp, lane, j, tile);
    const int gx = tx0 + p % tile, gy = ty0 + p / tile;
    if (j < LB::BX) px[j] = (float)gx;
    if (j % LB::BX == 0) py[j / LB::BX] = (float)gy;
    // channel k of this pixel: image layout [k, gy, gx]; tile-major [t, k, p]
    const size_t o = TILES ? (size_t)t * (ca + cv + 3) * P + p : (size_t)gy * img_w + gx;
#pragma unroll
    for (int k = 0; k < MAXA; ++k) {
      const float g = (EXACT || k < ca) ? g_img[k * stride + o] : 0.f;
      if constexpr (GP_SMEM) s_gp[(k * PPT + j) * nthreads + tid] = g;
      else gp[j][k] = g;
    }
#pragma unroll
    for (int k = 0; k < NV; ++k)
      gv[j][k] = (MAXV > 0 && (EXACT || k < cv)) ? g_img[(ca + k) * stride + o] : 0.f;
    // logT after the instance being visited, and its d_loga
    logT[j] = TILES ? logt_img[(size_t)t * 3 * P + p] : logt_img[(size_t)gy * img_w + gx];
    S[j] = g_img[(ca + cv) * stride + o];
  }
  // plain cotangent k of pixel j: GP_SMEM reads the thread's own entry,
  // written above, before the chunk loop's first barrier
  auto cot_p = [&](int j, int k) -> float {
    if constexpr (GP_SMEM) return svgir_lds(s_gp + (k * PPT + j) * nthreads + tid);
    else return gp[j][k];
  };

  // chunk cc into buffer b
  auto stage = [&](int cc, int b) {
    const int bb = start + cc * chunk;
    const float* src = slab + (size_t)bb * kr;
    float* dst = smem + b * nbuf;
    svgir_stage<ASYNC>(dst, src, chunk * kr, tid, nthreads);
    for (int e = tid; e < chunk; e += nthreads) {
      dst[chunk * kr + e] = g_wsum ? g_wsum[bb + e] : 0.f;
      dst[chunk * (kr + 1) + e] = svgir_power_floor(src[e * kr + 5]);
    }
  };
  int buf = 0, cur = 0;
  if (ASYNC && ne > 0) {
    stage(ne - 1, 0);
    svgir_cp_async_commit();
  }
  for (int c = ne - 1; c >= 0; --c) {
    const int base = start + c * chunk;
    if constexpr (ASYNC) {
      svgir_cp_async_wait_all();
      __syncthreads();
      if (c > 0) {
        stage(c - 1, cur ^ 1);
        svgir_cp_async_commit();
      }
    } else {
      __syncthreads();
      stage(c, 0);
      __syncthreads();
    }
    const float* s_slab = smem + cur * nbuf;
    const float* s_gw = s_slab + chunk * kr;
    const float* s_floor = s_gw + chunk;
    for (int i1 = chunk; i1 > 0; i1 -= IB) {
      const int nb = min(IB, i1), i0 = i1 - nb;
      float* part = s_part + buf * IB * nwarps * SL::N;
      int* act = s_act + buf * IB * nwarps;
      for (int b = nb - 1; b >= 0; --b) {
        const float* r = s_slab + (i0 + b) * kr;
        const float floor_i = s_floor[i0 + b];
        int* my_act = act + b * nwarps + warp;
        float dx[PPT], dy[PPT], ep[PPT], alpha[PPT], power[PPT];
        bool ok[PPT], near = false, any_ok = false;
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          dx[j] = r[0] - px[j % LB::BX];
          dy[j] = r[1] - py[j / LB::BX];
          power[j] = -0.5f * (r[2] * dx[j] * dx[j] + r[4] * dy[j] * dy[j]) - r[3] * dx[j] * dy[j];
          near |= power[j] >= floor_i;
        }
        if (!__any_sync(SVGIR_FULL_MASK, near)) {  // padding rows land here too
          if (lane == 0) *my_act = 0;
          continue;
        }
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          ep[j] = power[j] >= floor_i ? expf(power[j]) : 0.f;
          alpha[j] = fminf(SVGIR_ALPHA_MAX, r[5] * ep[j]);
          ok[j] = (power[j] <= 0.f) && (alpha[j] >= SVGIR_ALPHA_MIN);
          any_ok |= ok[j];
        }
        if (!__any_sync(SVGIR_FULL_MASK, any_ok)) {
          // no pixel of the warp sees this instance: every term is 0
          if (lane == 0) *my_act = 0;
          continue;
        }
        SvgirBwdTerms q[PPT];
        const float gw_i = s_gw[i0 + b];
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const float loga =
              ok[j] ? svgir_log1m_alpha(r, px[j % LB::BX], py[j / LB::BX], alpha[j]) : 0.f;
          const float logT_excl = logT[j] - loga;
          const bool gate = ok[j] && (logT_excl >= SVGIR_LOG_T_EPS);
          const float expT = expf(logT_excl);
          const float w = gate ? alpha[j] * expT : 0.f;
          float dw = gw_i;
#pragma unroll
          for (int k = 0; k < MAXA; ++k)
            if (EXACT || k < ca) dw += cot_p(j, k) * r[SVGIR_NG + k];
          q[j].du0 = q[j].du1 = q[j].lamx = q[j].lamy = 0.f;
          q[j].a[0] = q[j].a[1] = q[j].a[2] = q[j].a[3] = 0.f;
          if (MAXV > 0 && (EXACT || cv > 0)) {
            const SvgirUV uv = svgir_uv(r, dx[j], dy[j]);
            const float* va = r + SVGIR_NG + ca;
            float mv0 = 0.f, mv1 = 0.f, mv2 = 0.f, mv3 = 0.f;
#pragma unroll
            for (int k = 0; k < NV; ++k)
              if (EXACT || k < cv) {
                const float g = gv[j][k];
                mv0 += g * va[k];
                mv1 += g * va[cv + k];
                mv2 += g * va[2 * cv + k];
                mv3 += g * va[3 * cv + k];
              }
            const float wv0 = (1.f - uv.u) * (1.f - uv.v), wv1 = uv.u * (1.f - uv.v);
            const float wv2 = (1.f - uv.u) * uv.v, wv3 = uv.u * uv.v;
            dw += wv0 * mv0 + wv1 * mv1 + wv2 * mv2 + wv3 * mv3;
            float d_u = w * ((1.f - uv.v) * (mv1 - mv0) + uv.v * (mv3 - mv2));
            float d_v = w * ((1.f - uv.u) * (mv2 - mv0) + uv.u * (mv3 - mv1));
            if (!(uv.u_raw > 0.001f && uv.u_raw < 0.999f)) d_u = 0.f;
            if (!(uv.v_raw > 0.001f && uv.v_raw < 0.999f)) d_v = 0.f;
            q[j].du0 = d_u * 0.5f / uv.uvmx;
            q[j].du1 = d_v * 0.5f / uv.uvmy;
            q[j].lamx = 0.5f * (d_u * (-uv.du0 / (uv.uvmx * uv.uvmx)) * 0.5f);
            q[j].lamy = 0.5f * (d_v * (-uv.du1 / (uv.uvmy * uv.uvmy)) * 0.5f);
            q[j].a[0] = w * wv0;
            q[j].a[1] = w * wv1;
            q[j].a[2] = w * wv2;
            q[j].a[3] = w * wv3;
          }
          const float nclamp = alpha[j] < SVGIR_ALPHA_MAX ? 1.f : 0.f;
          const float d_alpha =
              (gate ? dw * expT : 0.f) + (ok[j] ? S[j] * (-1.f / (1.f - alpha[j])) : 0.f);
          q[j].dx = dx[j];
          q[j].dy = dy[j];
          q[j].w = w;
          q[j].dp = d_alpha * alpha[j] * nclamp;
          q[j].dae = d_alpha * ep[j] * nclamp;
          S[j] += dw * w;
          logT[j] = logT_excl;
        }
        // rows, 16 at a time: own pixels, then the warp
        float* my_part = part + (b * nwarps + warp) * SL::N;
        constexpr int NGROUPS = (SL::N + 15) / 16;
#pragma unroll
        for (int g = 0; g < NGROUPS; ++g) {
          float v[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            float s = 0.f;
#pragma unroll
            for (int j = 0; j < PPT; ++j)
              s += svgir_bwd_slot<MAXA, MAXV>(
                  g * 16 + e, r, q[j], [&](int k) { return cot_p(j, k); }, gv[j]);
            v[e] = s;
          }
          SvgirReduceScatter<16, 16>::run(v, lane);
          const int slot = g * 16 + (lane >> 1);
          if ((lane & 1) == 0 && slot < SL::N) my_part[slot] = v[0];
        }
        if (lane == 0) *my_act = 1;
      }
      __syncthreads();
      // each row of the round's instances: the sum over the warps that saw
      // the instance, in warp order; rows no warp saw stay zero
      for (int e = tid; e < nb * SL::N; e += nthreads) {
        const int b = e / SL::N, s = e - b * SL::N;
        const int* a = act + b * nwarps;
        const float* pp = part + b * nwarps * SL::N + s;
        float sum = 0.f;
        bool seen = false;
        for (int wp = 0; wp < nwarps; ++wp)
          if (a[wp]) {
            sum += pp[wp * SL::N];
            seen = true;
          }
        const int row = svgir_bwd_row<MAXA, MAXV>(s, ca, cv);
        if (seen && row >= 0) d_slab[(size_t)(base + i0 + b) * kr + row] = sum;
      }
      buf ^= 1;
    }
    if (ASYNC) cur ^= 1;
  }
}

// Shared-memory bytes of a block of the kernel at these sizes.
template <int MAXA, int MAXV, int PPT, int IB, bool ASYNC, bool GP_SMEM>
static size_t backward_smem(int kr, int tile, int chunk) {
  const int P = tile * tile, nwarps = P / PPT / 32;
  return ((ASYNC ? 2 : 1) * (size_t)chunk * (kr + 2) +
          2 * IB * nwarps * SvgirBwdSlots<MAXA, MAXV>::N + (GP_SMEM ? MAXA * (size_t)P : 0)) *
             sizeof(float) +
         2 * IB * nwarps * sizeof(int);
}

// Whether that kernel takes this tile and chunk: its lane patches tile the
// tile and its block fits in shared memory.
template <int MAXA, int MAXV, int PPT, int IB, bool ASYNC, bool GP_SMEM>
static bool backward_fits(int kr, int tile, int chunk) {
  return svgir_ppt_fits(PPT, tile) &&
         backward_smem<MAXA, MAXV, PPT, IB, ASYNC, GP_SMEM>(kr, tile, chunk) <= SVGIR_SMEM_MAX;
}

// info != nullptr: no launch; info gets the kernel's resident blocks per
// SM, threads per block, pixels per thread, shared-memory bytes, instances
// per round and asynchronous staging.
template <int MAXA, int MAXV, bool EXACT, int PPT, int IB, bool ASYNC, bool TILES, bool GP_SMEM>
static int launch_backward(const float* slab, const int* tile_start, const int* eff,
                           const float* g_img, const float* logt_img, const float* g_wsum,
                           int kr, int ca, int cv, int grid_x, int grid_y, int tile, int chunk,
                           float* d_slab, cudaStream_t stream, int* info) {
  if (!svgir_ppt_fits(PPT, tile)) return (int)cudaErrorInvalidValue;
  const int nthreads = tile * tile / PPT;
  const size_t smem = backward_smem<MAXA, MAXV, PPT, IB, ASYNC, GP_SMEM>(kr, tile, chunk);
  auto kernel = svgir_blend_bwd_kernel<MAXA, MAXV, EXACT, PPT, IB, ASYNC, TILES, GP_SMEM>;
  cudaError_t err = svgir_smem_opt_in(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    info[4] = IB;
    info[5] = ASYNC;
    return svgir_occupancy(kernel, nthreads, PPT, smem, info);
  }
  const int img_w = grid_x * tile;
  const size_t img_hw = (size_t)grid_y * tile * img_w;
  if (grid_x * grid_y > 0)
    kernel<<<grid_x * grid_y, nthreads, smem, stream>>>(slab, tile_start, eff, g_img, logt_img,
                                                        g_wsum, kr, ca, cv, grid_x, tile, chunk,
                                                        img_w, img_hw, d_slab);
  return (int)cudaGetLastError();
}

// One compiled kernel per width: exact widths (14, 0) (stage 1) and
// (13, 13) (the stage-2 step) at the pixels per thread, instances per round
// and staging that ran fastest on the bench inputs of an H100 (PERF.md);
// generic widths under the bounds ca <= 16, cv = 0 and ca <= 32, cv <= 16
// at one pixel per thread (fewer instances per round at the widest, so that
// the partial sums fit shared memory at tile 32 and chunk 128).  An exact
// width whose kernel does not take the tile or chunk (4 pixels a thread need
// a side that is a multiple of 16; a long chunk, with the stage-2 kernel's
// two buffers and parked cotangents, can outgrow shared memory) takes the
// generic kernel, which tiles every side the wrappers accept (a multiple of
// 8) and needs the least shared memory.
template <bool TILES>
static int dispatch_backward(const float* slab, const int* tile_start, const int* eff,
                             const float* g_img, const float* logt_img, const float* g_wsum,
                             int kr, int ca, int cv, int grid_x, int grid_y, int tile,
                             int chunk, float* d_slab, void* stream, int* info = nullptr) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk % 4 != 0) return (int)cudaErrorInvalidValue;  // as the reference's rounds
#define SVGIR_BWD(A, V, EX, PP, IB, AS, GPS)                                                   \
  return launch_backward<A, V, EX, PP, IB, AS, TILES, GPS>(                                    \
      slab, tile_start, eff, g_img, logt_img, g_wsum, kr, ca, cv, grid_x, grid_y, tile, chunk, \
      d_slab, s, info)
  if (ca == 14 && cv == 0 && backward_fits<14, 0, 4, 32, false, false>(kr, tile, chunk))
    SVGIR_BWD(14, 0, true, 4, 32, false, false);
  if (ca == 13 && cv == 13 && backward_fits<13, 13, 2, 8, true, true>(kr, tile, chunk))
    SVGIR_BWD(13, 13, true, 2, 8, true, true);
  if (cv == 0 && ca <= 16) SVGIR_BWD(16, 0, false, 1, 8, false, false);
  if (ca <= 32 && cv <= 16) SVGIR_BWD(32, 16, false, 1, 4, false, false);
#undef SVGIR_BWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int svgir_blend_backward(const float* slab, const int* tile_start, const int* eff,
                                    const float* g_img, const float* logt_img,
                                    const float* g_wsum, int kr, int ca, int cv, int grid_x,
                                    int grid_y, int tile, int chunk, float* d_slab,
                                    void* stream) {
  return dispatch_backward<false>(slab, tile_start, eff, g_img, logt_img, g_wsum, kr, ca, cv,
                                  grid_x, grid_y, tile, chunk, d_slab, stream);
}

// B6: g_out [T, CA+CV+3, tile*tile] and the forward's meta [T, 3, tile*tile].
extern "C" int svgir_blend_backward_tiles(const float* slab, const int* tile_start,
                                          const float* g_out, const float* meta,
                                          const float* g_wsum, int kr, int ca, int cv,
                                          int grid_x, int grid_y, int tile, int chunk,
                                          float* d_slab, void* stream) {
  return dispatch_backward<true>(slab, tile_start, nullptr, g_out, meta, g_wsum, kr, ca, cv,
                                 grid_x, grid_y, tile, chunk, d_slab, stream);
}

// The kernel a launch at these widths, tile and chunk takes: info[6] =
// resident blocks per SM, threads per block, pixels per thread,
// shared-memory bytes, instances per round, asynchronous staging (nothing
// is launched).
extern "C" int svgir_blend_backward_info(int kr, int ca, int cv, int tile, int chunk,
                                         int* info) {
  return dispatch_backward<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, kr, ca,
                                  cv, 1, 1, tile, chunk, nullptr, nullptr, info);
}
