// The per-pixel compositing rules that the forward and replay-backward
// kernels share: resident_fwd.cu (B1), resident_bwd.cu (B2/B3, both through
// cluster_blend.cuh) and table_blend.cu (B6/B7) include this header, so the
// row layout, the constants, the live test and one entry's forward and
// replay step exist once, and every backend decides the -4.5 and 1/255 edges
// alike.  The row staging and block reduction below serve B6/B7.
//
// Row layout (N+1, 16) f32: [mx, my, ca, cb, cc, c_0..c_{C-1}, 0.., op@14, 0];
// row N is a zero sentinel.  Per entry at pixel (px, py), no +0.5:
//   dx = mx - px, dy = my - py,
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy,
//   raw = op exp(power), alpha = min(0.99, raw),
//   live iff -4.5 <= power <= 0 and alpha >= 1/255.
// A tile stops before a group of entries once every pixel's transmittance is
// <= kTEps (a vote of the tile's block or cluster, at the same entries
// forward and backward).
// Replay, per pixel with g = cot, S = sum_c out[c] g[c] + g[C] out[C]:
//   w_i = alpha_i T_excl, gdotc_i = sum_c colour_i[c] g[c],
//   prefix_i = sum_{j<=i} gdotc_j w_j,
//   d_alpha = T_excl gdotc_i - (S - prefix_i) / max(1 - alpha_i, 1e-6),
//   d_power = (raw > 0.99 ? 0 : d_alpha) alpha_i   (zero where not live);
//   summed over the pixels: s0 = sum d_power, sx = sum d_power dx, ...,
//   d_mx = -(ca sx + cb sy), d_my = -(cc sy + cb sx), d_ca = -sxx/2,
//   d_cb = -sxy, d_cc = -syy/2, d_colour[c] = sum w_i g[c],
//   d_op = s0 / max(op, 1e-12).

#pragma once

#include <cuda_runtime.h>

namespace blend {

constexpr int kRow = 16;
constexpr int kOpCol = 14;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // backward: entries staged and reduced together
constexpr int kMaxGroup = 512;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// Every kernel that includes this header launches blocks of kThreads
// threads; the compile-time stride lets nvcc unroll the block-wide loops.

// Copies the rows of entries ids[0..n) into shared memory, one float4 per
// thread and step; `sidx`, where given, keeps the ids.
__device__ __forceinline__ void stage_rows(float4* dst, int* sidx, const float4* __restrict__ rows,
                                           const int* __restrict__ ids, int n) {
  for (int i = threadIdx.x; i < n * (kRow / 4); i += kThreads) {
    const int idx = ids[i >> 2];
    if (sidx != nullptr && (i & 3) == 0) sidx[i >> 2] = idx;
    dst[i] = rows[static_cast<size_t>(idx) * (kRow / 4) + (i & 3)];
  }
}

// One staged row r at one pixel.
struct Hit {
  float dx, dy, raw, alpha;
  bool live;
};

// The conic power and raw use round-to-nearest intrinsics in the plain
// version's order of operations (nvcc would contract them into FMAs), so the
// live test decides exactly as the plain version does: a flip at the -4.5 or
// 1/255 edge changes a pixel by ~1e-2.
__device__ __forceinline__ Hit evaluate(const float* r, float px, float py) {
  Hit h;
  h.dx = __fsub_rn(r[0], px);
  h.dy = __fsub_rn(r[1], py);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(r[2], h.dx), h.dx),
                            __fmul_rn(__fmul_rn(r[4], h.dy), h.dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(r[3], h.dx), h.dy));
  h.raw = __fmul_rn(r[kOpCol], expf(power));
  h.alpha = fminf(kAlphaMax, h.raw);
  h.live = power <= 0.0f && power >= -4.5f && h.alpha >= kAlphaMin;
  return h;
}

// Forward step of a live entry at one pixel.
template <int C>
__device__ __forceinline__ void composite(const float* r, const Hit& h, float& trans,
                                          float (&acc)[C]) {
  const float w = h.alpha * trans;
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] += w * r[5 + c];
  trans *= (1.0f - h.alpha);
}

// One entry's gradient terms, summed over the pixels a thread, then a warp, holds.
template <int C>
struct Sums {
  float s0, sx, sy, sxx, sxy, syy;
  float dcol[C];

  __device__ __forceinline__ void zero() {
    s0 = sx = sy = sxx = sxy = syy = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) dcol[c] = 0.0f;
  }
};

// Replay step of a live entry at one pixel: adds its terms to `s` (in place,
// so that nvcc fuses each product into its sum) and advances the pixel's
// transmittance and prefix.  gc is the pixel's colour cotangent, s_tot its S.
template <int C>
__device__ __forceinline__ void replay(const float* r, const Hit& h, const float (&gc)[C],
                                       float s_tot, float& trans, float& prefix, Sums<C>& s) {
  const float w = h.alpha * trans;
  float gdotc = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    gdotc += r[5 + c] * gc[c];
    s.dcol[c] += w * gc[c];
  }
  prefix += gdotc * w;
  const float one_m = fmaxf(1.0f - h.alpha, 1e-6f);
  const float d_alpha = trans * gdotc - (s_tot - prefix) / one_m;
  const float d_power = (h.raw > kAlphaMax) ? 0.0f : d_alpha * h.alpha;
  const float t1 = d_power * h.dx;
  const float t2 = d_power * h.dy;
  s.s0 += d_power;
  s.sx += t1;
  s.sy += t2;
  s.sxx += t1 * h.dx;
  s.sxy += t1 * h.dy;
  s.syy += t2 * h.dy;
  trans *= (1.0f - h.alpha);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of the block reduction: each warp's partial row of each
// staged entry, and whether the warp composited the entry at all.
struct Partials {
  float row[kWarps][kChunk][kRow];
  unsigned char flag[kWarps][kChunk];
};

// Warp half of the reduction of staged entry j: a warp none of whose pixels
// composites the entry adds nothing; otherwise its lanes' sums become one
// partial gradient row.  Every lane of the warp calls it.
template <int C>
__device__ __forceinline__ void warp_partial(const float* r, bool any_live, Sums<C>& s,
                                             Partials& part, int j) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // read before the stores into `part`, which the compiler cannot tell apart
  // from the staged row: the values stay those `evaluate` already loaded
  const float ca = r[2], cb = r[3], cc = r[4], op = r[kOpCol];
  const bool warp_live = __any_sync(0xffffffffu, any_live);
  if (warp_live) {
    s.s0 = warp_sum(s.s0);
    s.sx = warp_sum(s.sx);
    s.sy = warp_sum(s.sy);
    s.sxx = warp_sum(s.sxx);
    s.sxy = warp_sum(s.sxy);
    s.syy = warp_sum(s.syy);
#pragma unroll
    for (int c = 0; c < C; ++c) s.dcol[c] = warp_sum(s.dcol[c]);
    if (lane == 0) {
      float* pr = part.row[warp][j];
      pr[0] = -(ca * s.sx + cb * s.sy);
      pr[1] = -(cc * s.sy + cb * s.sx);
      pr[2] = -0.5f * s.sxx;
      pr[3] = -s.sxy;
      pr[4] = -0.5f * s.syy;
#pragma unroll
      for (int c = 0; c < C; ++c) pr[5 + c] = s.dcol[c];
      pr[kOpCol] = s.s0 / fmaxf(op, 1e-12f);
    }
  }
  if (lane == 0) part.flag[warp][j] = warp_live ? 1 : 0;
}

// Block half, after a barrier: sums the warps' partial rows of the n staged
// entries and hands every column of an entry some warp composited to
// store(j, c, v); the structurally zero columns are skipped.
template <int C, class Store>
__device__ __forceinline__ void emit_rows(const Partials& part, int n, Store store) {
  for (int i = threadIdx.x; i < n * kRow; i += kThreads) {
    const int j = i >> 4;
    const int c = i & (kRow - 1);
    if (c >= 5 + C && c != kOpCol) continue;
    float v = 0.0f;
    bool any = false;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (part.flag[w][j]) {
        v += part.row[w][j][c];
        any = true;
      }
    }
    if (any) store(j, c, v);
  }
}

}  // namespace blend
