// The parts of the compositing kernels (resident_fwd.cu B1 and B6,
// resident_bwd.cu B2/B3 and B7) that split a screen tile over a cluster of
// CTAs (Hopper, sm_90a).  Everything a pixel computes (the live test, the
// forward and replay steps) stays in blend_common.cuh.
//
// A tile's entries are a segment of an index array, front to back: B1-B3
// read depth-sorted pair segments (pairs + starts[t]); B6/B7 read the dense
// (T, K) table of backend: pallas as segments of cap = K entries at t * K
// (starts null), on 16-px tiles, one CTA each.
//
// A tile of side <= 32 is cut into 16x16 quadrants, one CTA of 256 threads
// each, one pixel per thread; the four CTAs of a 32-px tile form one thread
// block cluster (a tile <= 16 px is one CTA, launched without a cluster,
// whose vote is its own __syncthreads_or).  What the cluster shares is the
// exit vote: before each group every CTA stores its __syncthreads_or in
// shared memory, the cluster synchronises and every CTA reads all the flags
// through distributed shared memory, so the whole tile stops before the same
// group, as the plain version and the TPU kernel do.  What a CTA does alone: it
// stages the group's rows with cp.async (the next group while the current
// one composites), lists only the rows that can be live at one of its pixels
// (row_box + box_meets), in their order, and (backward) sums its pixels'
// gradient terms per row in shared memory (warp_add_sums).

#pragma once

#include <cooperative_groups.h>

#include <utility>

#include "blend_common.cuh"

namespace blend {

namespace cg = cooperative_groups;

constexpr int kQuad = 16;  // a CTA's quadrant side
static_assert(kQuad * kQuad == kThreads, "one thread per pixel of a 16x16 quadrant");
constexpr int kMaxQuads = 4;  // tile <= 32
constexpr int kMaxRounds = kMaxGroup / kThreads;  // rows per thread in a group's cull
// The cull keeps a row whose box of power >= -4.5 * 1.05 meets the quadrant,
// padded by one pixel; rows of a nearly singular conic (det <= 1e-4 ca cc)
// are kept whole.  The 5 % (and the pixel) cover the rounding as `evaluate`
// forms the power: its error is <= ~3.5 ulp of A = ca dx^2 + cc dy^2, and
// A <= 2 ca cc / det times the exact quadratic form Q, so at det > 1e-4 ca cc
// a live pixel has Q <= 9 / (1 - 0.0084); the rest covers the rounding of
// det, the quotient and the square root below.
constexpr float kCullPower = 9.45f;
constexpr float kCullDetRel = 1e-4f;

__host__ __device__ constexpr int quads_of(int tile) { return tile > kQuad ? kMaxQuads : 1; }

// B6/B7 composite every staged row, without cull_rows: at 16-px tiles
// bin_gaussians already drops every (Gaussian, tile) pair that composites no
// pixel of the tile (binning.py _tile_cull), so the box cull would keep
// nearly every row and only cost its two barriers a group.  They unroll
// their walk over a group's rows by 4: the rows' live tests are independent,
// and a dense tile's CTA, often alone on its SM at the end of the launch,
// has no other warps to hide their latency (-5 to -20 % on the H100; B1-B3
// keep the compiler's choice; PERF.md has the times).
constexpr int kTableUnroll = 4;

// step(i) for i in [0, n), unrolled by UNROLL, or as the compiler chooses
// where UNROLL is 0.
template <int UNROLL, class Step>
__device__ __forceinline__ void walk_rows(int n, Step step) {
  if constexpr (UNROLL > 0) {
#pragma unroll (UNROLL > 0 ? UNROLL : 1)
    for (int i = 0; i < n; ++i) step(i);
  } else {
    for (int i = 0; i < n; ++i) step(i);
  }
}

// The first entry of tile t's segment: pairs + starts[t], or, where starts
// is null, row t of a (T, cap) table.
__device__ __forceinline__ const int* segment(const int* pairs, const int* starts, int t, int cap) {
  return pairs + (starts != nullptr ? static_cast<size_t>(starts[t])
                                    : static_cast<size_t>(t) * static_cast<size_t>(cap));
}

// This CTA's quadrant of its tile and this thread's pixel in it; a warp
// holds 8x4 pixels (warps 2 across, 4 down), so that fewer warps than with
// 16x2 strips see a small Gaussian and run its reduction.
struct Quadrant {
  int t;                  // tile
  int rank;               // CTA rank in the cluster = quadrant (x-major)
  int p;                  // pixel index y * tile + x inside the tile
  bool valid;             // the pixel lies inside the tile
  float px, py;           // its coordinates (tile origin + x, no +0.5)
  float x0, x1, y0, y1;   // the quadrant's first and last pixel coordinates
};

constexpr int kWarpW = 8;  // a warp's pixels: 8 across, 4 down
constexpr int kWarpH = 32 / kWarpW;
static_assert(kQuad % kWarpW == 0 && (kQuad / kWarpW) * (kQuad / kWarpH) == kWarps,
              "the warps tile the quadrant");

__device__ __forceinline__ Quadrant quadrant(int nq, int tiles_x, int tile) {
  Quadrant q;
  q.rank = nq > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  q.t = blockIdx.x / nq;
  const int qx = (q.rank & 1) * kQuad;
  const int qy = (q.rank >> 1) * kQuad;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wx = qx + (warp % (kQuad / kWarpW)) * kWarpW;
  const int wy = qy + (warp / (kQuad / kWarpW)) * kWarpH;
  const int x = wx + lane % kWarpW;
  const int y = wy + lane / kWarpW;
  q.valid = x < tile && y < tile;
  q.p = y * tile + x;
  const int ox = (q.t % tiles_x) * tile;
  const int oy = (q.t / tiles_x) * tile;
  q.px = static_cast<float>(ox + x);
  q.py = static_cast<float>(oy + y);
  q.x0 = static_cast<float>(ox + qx);
  q.x1 = static_cast<float>(ox + min(qx + kQuad, tile) - 1);
  q.y0 = static_cast<float>(oy + qy);
  q.y1 = static_cast<float>(oy + min(qy + kQuad, tile) - 1);
  return q;
}

// The tile-wide exit vote: true while some pixel of some CTA of the cluster
// has transmittance > kTEps.  `vote` is a 2-slot shared array; slot `parity`
// alternates by group, so a CTA that is already a group ahead never
// overwrites a flag another CTA has yet to read.  A barrier for the CTA and
// the cluster; a tile of one CTA votes with its __syncthreads_or alone.
__device__ __forceinline__ bool tile_alive(int* vote, int parity, bool alive, int nq) {
  if (nq == 1) return __syncthreads_or(alive) != 0;
  cg::cluster_group cluster = cg::this_cluster();
  const int any = __syncthreads_or(alive);
  if (threadIdx.x == 0) vote[parity] = any;
  cluster.sync();
  int all = 0;
  for (int r = 0; r < nq; ++r) all |= *cluster.map_shared_rank(vote + parity, r);
  return all != 0;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copies of the rows of entries ids[0..n) into dst, 16 bytes per
// thread and step, and commits them as one group (an empty one for n = 0).
__device__ __forceinline__ void stage_rows_async(float4* dst, const float4* __restrict__ rows,
                                                 const int* __restrict__ ids, int n) {
  for (int i = threadIdx.x; i < n * (kRow / 4); i += kThreads) {
    const int idx = ids[i >> 2];
    cp_async16(dst + i, rows + static_cast<size_t>(idx) * (kRow / 4) + (i & 3));
  }
  cp_async_commit();
}

// Where row r can be live: false for an opacity < 1/255 (alpha =
// min(0.99, op exp(power)) <= op where power <= 0), else true with `box` =
// (x_lo, x_hi, y_lo, y_hi), the box of power >= -4.5 of a finite conic
// with ca, cc > 0 and det > 1e-4 ca cc (half-widths sqrt(9 cc / det),
// sqrt(9 ca / det), inflated and padded as kCullPower says), or the whole
// plane for any other conic.  Round-to-nearest intrinsics in the order of
// resident_blend.quadrant_keep_plain.
__device__ __forceinline__ bool row_box(const float* r, float4& box) {
  const float mx = r[0], my = r[1], ca = r[2], cb = r[3], cc = r[4], op = r[kOpCol];
  if (op < kAlphaMin) return false;
  box = make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  if (!(isfinite(mx) && isfinite(my) && isfinite(ca) && isfinite(cb) && isfinite(cc))) {
    return true;
  }
  const float det = __fsub_rn(__fmul_rn(ca, cc), __fmul_rn(cb, cb));
  if (!(ca > 0.0f && cc > 0.0f && det > __fmul_rn(__fmul_rn(kCullDetRel, ca), cc))) return true;
  const float hx = __fadd_rn(__fsqrt_rn(__fdiv_rn(__fmul_rn(kCullPower, cc), det)), 1.0f);
  const float hy = __fadd_rn(__fsqrt_rn(__fdiv_rn(__fmul_rn(kCullPower, ca), det)), 1.0f);
  box = make_float4(__fsub_rn(mx, hx), __fadd_rn(mx, hx), __fsub_rn(my, hy), __fadd_rn(my, hy));
  return true;
}

// Whether a row's box meets the pixels [x0, x1] x [y0, y1]; a row whose box
// does not is dead at every one of them.  (Testing it also against a warp's
// 8x4 pixels, to skip rows per warp, cost 10-13 % on the main view: a
// Gaussian there meets most warps of a quadrant it meets.)
__device__ __forceinline__ bool box_meets(const float4& box, float x0, float x1, float y0,
                                          float y1) {
  return box.y >= x0 && box.x <= x1 && box.w >= y0 && box.z <= y1;
}

// Compacts the staged indices j < n of the rows that can be live in the
// quadrant into list[0..), front to back, and returns how many (in every
// thread): a ballot per warp, the warps' counts in `warp_cnt` (kMaxRounds *
// kWarps ints of shared memory) and a __popc prefix.  Two barriers; call
// with every thread.
__device__ __forceinline__ int cull_rows(const float* srow, int n, const Quadrant& q, int* list,
                                         int* warp_cnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned mask[kMaxRounds];
#pragma unroll
  for (int k = 0; k < kMaxRounds; ++k) {
    const int j = k * kThreads + threadIdx.x;
    float4 box;
    const bool keep = j < n && row_box(srow + j * kRow, box) &&
                      box_meets(box, q.x0, q.x1, q.y0, q.y1);
    mask[k] = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_cnt[k * kWarps + warp] = __popc(mask[k]);
  }
  __syncthreads();
  int kept = 0;
#pragma unroll
  for (int k = 0; k < kMaxRounds; ++k) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp && ((mask[k] >> lane) & 1u)) {
        list[kept + __popc(mask[k] & ((1u << lane) - 1u))] = k * kThreads + threadIdx.x;
      }
      kept += warp_cnt[k * kWarps + w];
    }
  }
  __syncthreads();
  return kept;
}

// The optional diagnostic counts of this CTA: walked (2, T, 4), plane 0 the
// pair slots it stepped through, plane 1 the rows of those its cull kept.
// T = gridDim.x / nq.
__device__ __forceinline__ void write_walked(int* walked, const Quadrant& q, int nq, int n_walked,
                                             int n_kept) {
  const int at = q.t * kMaxQuads + q.rank;
  walked[at] = n_walked;
  walked[static_cast<int>(gridDim.x / nq) * kMaxQuads + at] = n_kept;
}

// Row r of shared memory into registers, four 16-byte loads.
__device__ __forceinline__ void load_row(float (&dst)[kRow], const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < kRow / 4; ++i) {
    const float4 v = s4[i];
    dst[4 * i] = v.x;
    dst[4 * i + 1] = v.y;
    dst[4 * i + 2] = v.z;
    dst[4 * i + 3] = v.w;
  }
}

// One butterfly step of warp_sum_transposed: lanes whose bit H is set keep
// the upper H of the first 2H values, the others the lower H, and each adds
// its partner's copy of the half it keeps.
template <int H>
__device__ __forceinline__ void butterfly_half(float (&v)[kRow], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// The warp sum of 16 values per lane in 16 shuffles: four butterfly steps
// that each keep half of the values (8, 4, 2, 1 exchanged) and one that
// exchanges the last.  Returns the sum of column (lane & 15) over the 32
// lanes; `v` is clobbered.
__device__ __forceinline__ float warp_sum_transposed(float (&v)[kRow]) {
  static_assert(kRow == 16, "four halving steps from 16 columns");
  const int lane = threadIdx.x & 31;
  butterfly_half<8>(v, lane);
  butterfly_half<4>(v, lane);
  butterfly_half<2>(v, lane);
  butterfly_half<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 16);
}

// Column of the raw per-row sums that every CTA accumulates in shared memory
// ([s0, sx, sy, sxx, sxy, syy, sum_w g_0..g_{C-1}, 0.., n_warps@15]): the
// last one counts the warps that composited the row.
constexpr int kWarpCountCol = kRow - 1;

// Adds a warp's sums of one staged row (a replay step's Sums, per lane) into
// the CTA's raw row `part` (16 floats of shared memory); a warp none of whose
// pixels composites the row adds nothing.  Every lane of the warp calls it.
template <int C>
__device__ __forceinline__ void warp_add_sums(const Sums<C>& s, bool live, float* part) {
  static_assert(6 + C <= kWarpCountCol, "the raw row holds at most 9 colour sums");
  if (!__any_sync(0xffffffffu, live)) return;
  float v[kRow];
  v[0] = s.s0;
  v[1] = s.sx;
  v[2] = s.sy;
  v[3] = s.sxx;
  v[4] = s.sxy;
  v[5] = s.syy;
#pragma unroll
  for (int c = 0; c < C; ++c) v[6 + c] = s.dcol[c];
#pragma unroll
  for (int c = 6 + C; c < kRow; ++c) v[c] = 0.0f;
  const float sum = warp_sum_transposed(v);
  const int col = threadIdx.x & 31;
  if (col < 6 + C) atomicAdd(part + col, sum);
  if (col == kWarpCountCol) atomicAdd(part + col, 1.0f);
}

// Column c of an entry's gradient row from the cluster's raw sums R and the
// entry's staged row r (the formulas of blend_common.cuh's header).
template <int C>
__device__ __forceinline__ float gradient_column(const float* R, const float* r, int c) {
  switch (c) {
    case 0: return -(r[2] * R[1] + r[3] * R[2]);
    case 1: return -(r[4] * R[2] + r[3] * R[1]);
    case 2: return -0.5f * R[3];
    case 3: return -R[4];
    case 4: return -0.5f * R[5];
    case kOpCol: return R[0] / fmaxf(r[kOpCol], 1e-12f);
    default: return R[c + 1];  // 5 <= c < 5 + C: the colour sums
  }
}

// Host: launches `kernel` on n_tiles * quads_of(tile) CTAs of kThreads
// threads in clusters of quads_of(tile) (none where that is one), with `smem`
// bytes of dynamic shared memory (the limit raised past the default 48 KB
// where needed).  Returns
// the first CUDA error, also a refused cluster launch.
template <class... Expected, class... Actual>
cudaError_t launch_clusters(void (*kernel)(Expected...), int n_tiles, int tile, size_t smem,
                            cudaStream_t stream, Actual&&... args) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int nq = quads_of(tile);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * nq);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nq;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nq > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Actual>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace blend
