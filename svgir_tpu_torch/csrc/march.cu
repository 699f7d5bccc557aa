// B8 svgir_march replaces svgir_tpu/ops/march_pallas.py march_test_merge
// (_march_kernel) together with the lax.scan over visits around it in
// grid_tracer._nearest_hits_grid: the grid march of the radiance bake.
// For every ray it walks the grid's cells at half-cell steps, merges
// consecutive steps in one cell into visits of at most kmax steps (the
// visit list of grid_tracer._run_scan), tests every BLK-wide block of each
// visited cell's candidate list within the visit's t-span [t_lo, t_hi),
// and keeps the k nearest accepted hits (t, surfel id).
//
// Design.  One warp per ray; each lane tests two of a block's 64
// candidates.  The block table is field-major ([32, BLK] floats per block
// row), so each field of a block is one coalesced 256-byte run over the
// warp.  The running top-k lives in registers, KPL = ceil(k / 32) slots
// per lane (slot s at lane s % 32, register s / 32): accepted candidates
// are inserted one at a time, in candidate order, at the count of slots
// whose t is <= theirs (a ballot), and the slots behind shift up by one
// (shuffles).  That is lax.top_k's contract exactly: ascending t, ties in
// slot order (running hits before candidates, candidates in row order),
// empty slots (inf, -1).  Once k hits are held and a visit starts at or
// past the k-th t, no later candidate can enter, so the walk stops: the
// result is unchanged.  One launch marches every ray it is given; the TPU
// kernel ran one visit per launch, max_visits launches per ray chunk.
//
// Numerics (ROADMAP C-1).  For thin surfels the power -0.5 p^T Sigma^-1 p
// cancels catastrophically and its value is rounding noise, so which hits
// pass depends on the exact order of every operation.  The test below
// rounds each product, sum and quotient on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: nvcc cannot contract them into fused multiply-
// adds), in the order of the plain version (ops/tracing.surfel_test),
// with expf as torch's CUDA exp; the cell walk likewise.  So the kernel
// equals its plain version hit for hit on the card.
//
// Bound.  By the distinct bytes it must move (each visited block once,
// 24 B of ray and 8k B of hits per ray) the march is bound by its
// operations: 84 float operations for each of the 64 candidates of every
// visited block.  The kernel itself re-reads the 6 KB of fields it needs
// of each visited block from L2 or device memory once per ray that visits
// it, and a warp's inserts are serial; those set its time.
#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

#define SVGIR_MARCH_BLK 64
#define SVGIR_PACK_W 32
#define SVGIR_MARCH_FULL 0xffffffffu
#define SVGIR_MARCH_ALPHA_MIN (1.0f / 255.0f)
#define SVGIR_MARCH_ALPHA_MAX 0.99f

static const int kMarchThreads = 128;  // 4 warps: 4 rays per block

struct SvgirMarchArgs {
  const float* block_geo;   // [nrows, 32 * BLK] field-major packed rows
  const int* block_start;   // [res^3] first block row of each cell
  const int* cell_count;    // [res^3] candidates per cell (uncapped)
  const float* rays_o;      // [r, 3]
  const float* rays_d;      // [r, 3]
  long long r;
  float lo[3], inv_cell[3];
  int res;
  float dt, t_max;
  int n_steps, kmax, cap, k;
  float* out_t;             // [r, k]
  int* out_idx;             // [r, k]
};

// clip(int32(trunc((p - lo) * inv_cell)), 0, res - 1); the float is clamped
// to [-1, res] first, as grid_tracer._to_cell does.
__device__ __forceinline__ int svgir_axis_cell(float p, float lo, float inv_cell, int res) {
  const float x = __fmul_rn(__fsub_rn(p, lo), inv_cell);
  const int c = (int)fminf(fmaxf(x, -1.f), (float)res);
  return min(max(c, 0), res - 1);
}

__device__ __forceinline__ float svgir_dot3_rn(float a0, float a1, float a2, float b0, float b1,
                                               float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// The surfel test of candidate c of a field-major block row g against ray
// (o, d) within [t_lo, t_hi).  Returns whether it is accepted; t and id
// are its plane-hit distance and surfel id.
__device__ __forceinline__ bool svgir_test(const float* __restrict__ g, int c, float ox, float oy,
                                           float oz, float dx, float dy, float dz, float t_lo,
                                           float t_hi, float& t, int& id) {
#define SVGIR_F(f) __ldg(g + (f) * SVGIR_MARCH_BLK + c)
  const float m0 = SVGIR_F(0), m1 = SVGIR_F(1), m2 = SVGIR_F(2);
  const float n0 = SVGIR_F(21), n1 = SVGIR_F(22), n2 = SVGIR_F(23);
  const float denom_raw = svgir_dot3_rn(n0, n1, n2, dx, dy, dz);
  const float denom = fabsf(denom_raw) < 1e-6f ? 1e-6f : denom_raw;
  const float a0 = __fsub_rn(m0, ox), a1 = __fsub_rn(m1, oy), a2 = __fsub_rn(m2, oz);
  t = __fdiv_rn(svgir_dot3_rn(a0, a1, a2, n0, n1, n2), denom);
  // p = (o + t d) - m; local_j = sum_i rot[i][j] p_i (rot row-major at 6)
  const float p0 = __fsub_rn(__fadd_rn(ox, __fmul_rn(t, dx)), m0);
  const float p1 = __fsub_rn(__fadd_rn(oy, __fmul_rn(t, dy)), m1);
  const float p2 = __fsub_rn(__fadd_rn(oz, __fmul_rn(t, dz)), m2);
  const float lu = svgir_dot3_rn(SVGIR_F(6), SVGIR_F(9), SVGIR_F(12), p0, p1, p2);
  const float lv = svgir_dot3_rn(SVGIR_F(7), SVGIR_F(10), SVGIR_F(13), p0, p1, p2);
  const float u = __fdiv_rn(lu, fmaxf(SVGIR_F(3), 1e-12f));
  const float v = __fdiv_rn(lv, fmaxf(SVGIR_F(4), 1e-12f));
  const float dis = __fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v));
  // pd = (m - o) - t d; power = -0.5 (diagonal terms + 2 off-diagonal)
  const float px = __fsub_rn(a0, __fmul_rn(t, dx));
  const float py = __fsub_rn(a1, __fmul_rn(t, dy));
  const float pz = __fsub_rn(a2, __fmul_rn(t, dz));
  const float diag = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(SVGIR_F(15), px), px),
                                         __fmul_rn(__fmul_rn(SVGIR_F(18), py), py)),
                               __fmul_rn(__fmul_rn(SVGIR_F(20), pz), pz));
  const float off = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(SVGIR_F(16), px), py),
                                        __fmul_rn(__fmul_rn(SVGIR_F(17), px), pz)),
                              __fmul_rn(__fmul_rn(SVGIR_F(19), py), pz));
  const float power = __fmul_rn(-0.5f, __fadd_rn(diag, __fmul_rn(2.f, off)));
  const float alpha = fminf(__fmul_rn(SVGIR_F(24), expf(power)), SVGIR_MARCH_ALPHA_MAX);
  id = (int)SVGIR_F(26);
  return id >= 0 && SVGIR_F(25) > 0.5f && dis <= 9.f && power <= 0.f &&
         alpha >= SVGIR_MARCH_ALPHA_MIN && denom_raw < 0.f && t >= t_lo && t < t_hi;
#undef SVGIR_F
}

// t of slot s (warp-uniform result).
template <int KPL>
__device__ __forceinline__ float svgir_slot_t(const float (&ht)[KPL], int s) {
  float v = CUDART_INF_F;
#pragma unroll
  for (int q = 0; q < KPL; ++q)
    if (q == (s >> 5)) v = ht[q];
  return __shfl_sync(SVGIR_MARCH_FULL, v, s & 31);
}

// Insert (x, xi) after every held slot whose t is <= x; slot k-1 drops out.
template <int KPL>
__device__ __forceinline__ void svgir_insert(float x, int xi, int lane, int k, float (&ht)[KPL],
                                             int (&hi)[KPL]) {
  int pos = 0;
#pragma unroll
  for (int q = 0; q < KPL; ++q) pos += __popc(__ballot_sync(SVGIR_MARCH_FULL, ht[q] <= x));
  float up_t[KPL];
  int up_i[KPL];
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    up_t[q] = __shfl_up_sync(SVGIR_MARCH_FULL, ht[q], 1);
    up_i[q] = __shfl_up_sync(SVGIR_MARCH_FULL, hi[q], 1);
    float wrap_t = CUDART_INF_F;
    int wrap_i = -1;
    if (q > 0) {
      wrap_t = __shfl_sync(SVGIR_MARCH_FULL, ht[q > 0 ? q - 1 : 0], 31);
      wrap_i = __shfl_sync(SVGIR_MARCH_FULL, hi[q > 0 ? q - 1 : 0], 31);
    }
    if (lane == 0) {
      up_t[q] = wrap_t;
      up_i[q] = wrap_i;
    }
  }
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int s = q * 32 + lane;
    if (s >= k || s < pos) continue;  // slots past k stay (inf, -1)
    ht[q] = s == pos ? x : up_t[q];
    hi[q] = s == pos ? xi : up_i[q];
  }
}

template <int KPL>
__global__ void __launch_bounds__(kMarchThreads) svgir_march_kernel(const SvgirMarchArgs a) {
  const int lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * (kMarchThreads / 32) + (threadIdx.x >> 5);
  if (ray >= a.r) return;  // the whole warp: one ray per warp
  const float ox = a.rays_o[3 * ray], oy = a.rays_o[3 * ray + 1], oz = a.rays_o[3 * ray + 2];
  const float dx = a.rays_d[3 * ray], dy = a.rays_d[3 * ray + 1], dz = a.rays_d[3 * ray + 2];
  const int k = a.k;

  float ht[KPL];
  int hi[KPL];
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    ht[q] = CUDART_INF_F;
    hi[q] = -1;
  }
  int nfin = 0;            // finite slots held (warp-uniform)
  float kth = CUDART_INF_F;    // t of slot k-1 once k are held
  const float half_dt = __fmul_rn(0.5f, a.dt);
  int cur = -1, j0 = 0, len = 0;  // the open visit: cell, first step, steps
  for (int j = 0; j <= a.n_steps; ++j) {
    int cell = -1;
    if (j < a.n_steps) {
      const float s = __fadd_rn(__fmul_rn((float)j, a.dt), half_dt);
      const int cx = svgir_axis_cell(__fadd_rn(ox, __fmul_rn(s, dx)), a.lo[0], a.inv_cell[0], a.res);
      const int cy = svgir_axis_cell(__fadd_rn(oy, __fmul_rn(s, dy)), a.lo[1], a.inv_cell[1], a.res);
      const int cz = svgir_axis_cell(__fadd_rn(oz, __fmul_rn(s, dz)), a.lo[2], a.inv_cell[2], a.res);
      cell = (cz * a.res + cy) * a.res + cx;
      if (len > 0 && cell == cur && len < a.kmax) {
        ++len;
        continue;
      }
    }
    if (len > 0) {  // close the open visit
      const int cnt = min(__ldg(a.cell_count + cur), a.cap);
      if (cnt > 0) {
        const float t_lo = __fmul_rn((float)j0, a.dt);
        if (nfin == k && !(t_lo < kth)) break;  // nothing later can enter
        const float t_hi = fminf(__fmul_rn(__fadd_rn((float)j0, (float)len), a.dt), a.t_max);
        const float* row = a.block_geo + (size_t)__ldg(a.block_start + cur) *
                                             (SVGIR_PACK_W * SVGIR_MARCH_BLK);
        const int nb = (cnt + SVGIR_MARCH_BLK - 1) / SVGIR_MARCH_BLK;
        for (int bi = 0; bi < nb; ++bi, row += SVGIR_PACK_W * SVGIR_MARCH_BLK) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float t;
            int id;
            const bool ok = svgir_test(row, lane + 32 * h, ox, oy, oz, dx, dy, dz, t_lo, t_hi, t, id);
            unsigned mask = __ballot_sync(SVGIR_MARCH_FULL, ok && t < kth);
            while (mask) {
              const int src = __ffs(mask) - 1;
              mask &= mask - 1;
              const float x = __shfl_sync(SVGIR_MARCH_FULL, t, src);
              const int xi = __shfl_sync(SVGIR_MARCH_FULL, id, src);
              if (!(x < kth)) continue;
              svgir_insert<KPL>(x, xi, lane, k, ht, hi);
              nfin = min(nfin + 1, k);
              kth = nfin == k ? svgir_slot_t<KPL>(ht, k - 1) : CUDART_INF_F;
            }
          }
        }
      }
    }
    cur = cell;
    j0 = j;
    len = 1;
  }
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int s = q * 32 + lane;
    if (s < k) {
      a.out_t[ray * k + s] = ht[q];
      a.out_idx[ray * k + s] = hi[q];
    }
  }
}

// The march of r rays: out_t, out_idx [r, k] (k in 1..128).  Returns a
// CUDA error code (invalid value for arguments the kernel does not take).
extern "C" int svgir_march(const float* block_geo, const int* block_start, const int* cell_count,
                           const float* rays_o, const float* rays_d, long long r, float lo_x,
                           float lo_y, float lo_z, float inv_x, float inv_y, float inv_z, int res,
                           float dt, float t_max, int n_steps, int kmax, int cap, int k,
                           float* out_t, int* out_idx, void* stream) {
  if (k < 1 || k > 128 || res < 1 || kmax < 1 || cap < 1 || n_steps < 0 || r < 0)
    return (int)cudaErrorInvalidValue;
  if (r == 0) return 0;
  SvgirMarchArgs a;
  a.block_geo = block_geo;
  a.block_start = block_start;
  a.cell_count = cell_count;
  a.rays_o = rays_o;
  a.rays_d = rays_d;
  a.r = r;
  a.lo[0] = lo_x;
  a.lo[1] = lo_y;
  a.lo[2] = lo_z;
  a.inv_cell[0] = inv_x;
  a.inv_cell[1] = inv_y;
  a.inv_cell[2] = inv_z;
  a.res = res;
  a.dt = dt;
  a.t_max = t_max;
  a.n_steps = n_steps;
  a.kmax = kmax;
  a.cap = cap;
  a.k = k;
  a.out_t = out_t;
  a.out_idx = out_idx;
  const int rays_per_block = kMarchThreads / 32;
  const long long blocks = (r + rays_per_block - 1) / rays_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 32)
    svgir_march_kernel<1><<<(unsigned)blocks, kMarchThreads, 0, s>>>(a);
  else if (k <= 64)
    svgir_march_kernel<2><<<(unsigned)blocks, kMarchThreads, 0, s>>>(a);
  else
    svgir_march_kernel<4><<<(unsigned)blocks, kMarchThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
