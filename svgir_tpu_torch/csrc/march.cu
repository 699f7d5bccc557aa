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
// What bounds it on an H100.  Loading all 23 fields the test reads of every
// visited block (5,888 bytes a visit, from L2) ran at 6.2 TB/s on the bake's
// chunks, so bytes set the time, and then the walk: one step at a time, the
// whole warp computing one cell and waiting on one count.  So:
// - the test runs in stages (svgir_visit_block), each loading only for the
//   candidates still in the running; on the bench bake's chunks under 0.3%
//   (rays that hit nothing) and 23% (rays that hit) of the 32-byte sectors
//   of a visit hold a candidate that faces the ray with its plane hit in
//   the span, and padding candidates past a cell's count load nothing;
// - the walk goes 32 steps at a time (a step a lane), visit starts found by
//   ballots and their cells' counts loaded together: about 0.06 ms of a
//   65,536-ray chunk.
// What is left is the first stages' loads of each visited block.
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
// visited block (chip_smoke.march_bound).
#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

#define SVGIR_MARCH_BLK 64
#define SVGIR_PACK_W 32
#define SVGIR_MARCH_FULL 0xffffffffu
#define SVGIR_MARCH_ALPHA_MIN (1.0f / 255.0f)
#define SVGIR_MARCH_ALPHA_MAX 0.99f

static const int kMarchThreads = 128;  // 4 warps: 4 rays per block
static const int kMarchRays = kMarchThreads / 32;
// Blocks an SM holds at least, by register slots per lane (KPL): 48, 32 and
// 16 warps.  Blocks of 16 or 32 rays ran slower on an H100: a block's
// slots free only when its slowest ray is done.
template <int KPL>
constexpr int svgir_march_min_blocks() {
  return KPL == 1 ? 12 : KPL == 2 ? 8 : 4;
}

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

// The normals (fields 21-23) of the real candidates of block row g, for
// the facing test.  Loading them a block ahead, while the block before is
// tested, spilled registers at 48 warps an SM and ran slower on an H100.
__device__ __forceinline__ void svgir_load_normals(const float* __restrict__ g, int nreal,
                                                   int lane, float (&n)[2][3]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h;
    if (c >= nreal) continue;
#pragma unroll
    for (int f = 0; f < 3; ++f) n[h][f] = __ldg(g + (21 + f) * SVGIR_MARCH_BLK + c);
  }
}

// Tests the real candidates of one field-major block row g (the first
// nreal of its BLK; the rest are padding rows, id -1, by the table's
// construction) against ray (o, d) within [t_lo, t_hi), and inserts the
// accepted ones in candidate order.  Lane l tests candidates l and l + 32.
// The acceptance is a conjunction, so it is evaluated in four stages, each
// loading its fields only for the lanes still in the running and skipped by
// the whole warp when none is: (1) facing (fields 21-23, loaded by the
// caller, svgir_load_normals), (2) the plane hit
// within the span and before the k-th hit (0-2), (3) the ellipse, dis <= 9
// (3, 4, 6, 7, 9, 10, 12, 13), (4) power, alpha, validity and id (15-20,
// 24-26).  Each quantity is rounded as in the plain version, so the same
// candidates are accepted; a candidate at or past the k-th t could not
// enter, and the k-th t only falls between the stages and the inserts,
// where it is tested again.
template <int KPL>
__device__ __forceinline__ void svgir_visit_block(const float* __restrict__ g, int nreal, int lane,
                                                  const float (&n)[2][3], float ox, float oy,
                                                  float oz, float dx, float dy, float dz,
                                                  float t_lo, float t_hi, int k, float& kth,
                                                  int& nfin, float (&ht)[KPL], int (&hi)[KPL]) {
#define SVGIR_F(f) __ldg(g + (f) * SVGIR_MARCH_BLK + c)
  float denom[2], m0[2], m1[2], m2[2], a0[2], a1[2], a2[2];
  float t[2] = {0.f, 0.f};
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h;
    live[h] = c < nreal;
    if (!live[h]) continue;
    const float denom_raw = svgir_dot3_rn(n[h][0], n[h][1], n[h][2], dx, dy, dz);
    denom[h] = fabsf(denom_raw) < 1e-6f ? 1e-6f : denom_raw;
    live[h] = denom_raw < 0.f;
  }
  if (!__any_sync(SVGIR_MARCH_FULL, live[0] || live[1])) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h;
    if (!live[h]) continue;
    m0[h] = SVGIR_F(0), m1[h] = SVGIR_F(1), m2[h] = SVGIR_F(2);
    a0[h] = __fsub_rn(m0[h], ox), a1[h] = __fsub_rn(m1[h], oy), a2[h] = __fsub_rn(m2[h], oz);
    t[h] = __fdiv_rn(svgir_dot3_rn(a0[h], a1[h], a2[h], n[h][0], n[h][1], n[h][2]), denom[h]);
    live[h] = t[h] >= t_lo && t[h] < t_hi && t[h] < kth;
  }
  if (!__any_sync(SVGIR_MARCH_FULL, live[0] || live[1])) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h;
    if (!live[h]) continue;
    // p = (o + t d) - m; local_j = sum_i rot[i][j] p_i (rot row-major at 6)
    const float p0 = __fsub_rn(__fadd_rn(ox, __fmul_rn(t[h], dx)), m0[h]);
    const float p1 = __fsub_rn(__fadd_rn(oy, __fmul_rn(t[h], dy)), m1[h]);
    const float p2 = __fsub_rn(__fadd_rn(oz, __fmul_rn(t[h], dz)), m2[h]);
    const float lu = svgir_dot3_rn(SVGIR_F(6), SVGIR_F(9), SVGIR_F(12), p0, p1, p2);
    const float lv = svgir_dot3_rn(SVGIR_F(7), SVGIR_F(10), SVGIR_F(13), p0, p1, p2);
    const float u = __fdiv_rn(lu, fmaxf(SVGIR_F(3), 1e-12f));
    const float v = __fdiv_rn(lv, fmaxf(SVGIR_F(4), 1e-12f));
    live[h] = __fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v)) <= 9.f;
  }
  if (!__any_sync(SVGIR_MARCH_FULL, live[0] || live[1])) return;
  int id[2] = {-1, -1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h;
    if (!live[h]) continue;
    // pd = (m - o) - t d; power = -0.5 (diagonal terms + 2 off-diagonal)
    const float px = __fsub_rn(a0[h], __fmul_rn(t[h], dx));
    const float py = __fsub_rn(a1[h], __fmul_rn(t[h], dy));
    const float pz = __fsub_rn(a2[h], __fmul_rn(t[h], dz));
    const float diag = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(SVGIR_F(15), px), px),
                                           __fmul_rn(__fmul_rn(SVGIR_F(18), py), py)),
                                 __fmul_rn(__fmul_rn(SVGIR_F(20), pz), pz));
    const float off = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(SVGIR_F(16), px), py),
                                          __fmul_rn(__fmul_rn(SVGIR_F(17), px), pz)),
                                __fmul_rn(__fmul_rn(SVGIR_F(19), py), pz));
    const float power = __fmul_rn(-0.5f, __fadd_rn(diag, __fmul_rn(2.f, off)));
    const float alpha = fminf(__fmul_rn(SVGIR_F(24), expf(power)), SVGIR_MARCH_ALPHA_MAX);
    id[h] = (int)SVGIR_F(26);
    live[h] = id[h] >= 0 && SVGIR_F(25) > 0.5f && power <= 0.f && alpha >= SVGIR_MARCH_ALPHA_MIN;
  }
#undef SVGIR_F
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned mask = __ballot_sync(SVGIR_MARCH_FULL, live[h]);
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float x = __shfl_sync(SVGIR_MARCH_FULL, t[h], src);
      const int xi = __shfl_sync(SVGIR_MARCH_FULL, id[h], src);
      if (!(x < kth)) continue;
      svgir_insert<KPL>(x, xi, lane, k, ht, hi);
      nfin = min(nfin + 1, k);
      kth = nfin == k ? svgir_slot_t<KPL>(ht, k - 1) : CUDART_INF_F;
    }
  }
}

// One warp per ray, kMarchRays consecutive rays per block.  The walk goes
// 32 steps at a time, a step a lane: each lane finds its step's cell, the
// warp finds where visits start (a change of cell, or every kmax steps of
// one cell) by ballots, and the lanes that start a visit load its cell's
// count and first block row together.  Then the visits are closed in step
// order, each tested block by block, exactly as a walk one step at a time
// would close them.
template <int KPL>
__global__ void __launch_bounds__(kMarchThreads, svgir_march_min_blocks<KPL>())
svgir_march_kernel(const SvgirMarchArgs a) {
  const int lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kMarchRays + (threadIdx.x >> 5);
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
  int nfin = 0;                // finite slots held (warp-uniform)
  float kth = CUDART_INF_F;    // t of slot k-1 once k are held
  const float half_dt = __fmul_rn(0.5f, a.dt);
  bool open = false;           // the open visit: first step, count, first row
  int j0 = 0, cnt = 0, bs = 0;
  int last_cell = -2, last_run = 0;  // the step before this 32: cell, run position
  bool done = false;
  for (int jc = 0; jc <= a.n_steps && !done; jc += 32) {
    const int j = jc + lane;
    int cell = -1;
    if (j < a.n_steps) {
      const float s = __fadd_rn(__fmul_rn((float)j, a.dt), half_dt);
      const int cx = svgir_axis_cell(__fadd_rn(ox, __fmul_rn(s, dx)), a.lo[0], a.inv_cell[0], a.res);
      const int cy = svgir_axis_cell(__fadd_rn(oy, __fmul_rn(s, dy)), a.lo[1], a.inv_cell[1], a.res);
      const int cz = svgir_axis_cell(__fadd_rn(oz, __fmul_rn(s, dz)), a.lo[2], a.inv_cell[2], a.res);
      cell = (cz * a.res + cy) * a.res + cx;
    }
    int prev = __shfl_up_sync(SVGIR_MARCH_FULL, cell, 1);
    if (lane == 0) prev = last_cell;
    // run: steps since this step's run of one cell began
    const unsigned upto = __ballot_sync(SVGIR_MARCH_FULL, j < a.n_steps && cell != prev) &
                          (SVGIR_MARCH_FULL >> (31 - lane));
    const int run = upto ? lane - (31 - __clz(upto)) : last_run + 1 + lane;
    const bool starts = j < a.n_steps && run % a.kmax == 0;
    int cnt_l = 0, bs_l = 0;
    if (starts) {
      cnt_l = min(__ldg(a.cell_count + cell), a.cap);
      if (cnt_l > 0) bs_l = __ldg(a.block_start + cell);
    }
    last_cell = __shfl_sync(SVGIR_MARCH_FULL, cell, 31);
    last_run = __shfl_sync(SVGIR_MARCH_FULL, run, 31);
    // a visit ends where the next starts, and the last one at n_steps
    unsigned ends = __ballot_sync(SVGIR_MARCH_FULL, starts || j == a.n_steps);
    while (ends) {
      const int l = __ffs(ends) - 1;
      ends &= ends - 1;
      const int je = jc + l;
      if (open && cnt > 0) {  // close the visit [j0, je)
        const float t_lo = __fmul_rn((float)j0, a.dt);
        if (nfin == k && !(t_lo < kth)) {  // nothing later can enter
          done = true;
          break;
        }
        const float t_hi =
            fminf(__fmul_rn(__fadd_rn((float)j0, (float)(je - j0)), a.dt), a.t_max);
        const int row_floats = SVGIR_PACK_W * SVGIR_MARCH_BLK;
        const float* row = a.block_geo + (size_t)bs * row_floats;
        for (int b0 = 0; b0 < cnt; b0 += SVGIR_MARCH_BLK, row += row_floats) {
          float n[2][3] = {};
          svgir_load_normals(row, cnt - b0, lane, n);
          svgir_visit_block<KPL>(row, cnt - b0, lane, n, ox, oy, oz, dx, dy, dz, t_lo, t_hi, k,
                                 kth, nfin, ht, hi);
        }
      }
      open = je < a.n_steps;
      j0 = je;
      cnt = __shfl_sync(SVGIR_MARCH_FULL, cnt_l, l);
      bs = __shfl_sync(SVGIR_MARCH_FULL, bs_l, l);
    }
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
  const long long blocks = (r + kMarchRays - 1) / kMarchRays;
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
