// The per-pixel compositing rules of the forward and replay-backward
// kernels: resident_fwd.cu (B1, and B6 over the (T, K) table) and
// resident_bwd.cu (B2/B3, and B7) include this header through
// cluster_blend.cuh, so the row layout, the constants, the live test and one
// entry's forward and replay step exist once, and every backend decides the
// -4.5 and 1/255 edges alike.
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
constexpr int kMaxGroup = 512;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// Every kernel that includes this header launches blocks of kThreads
// threads; the compile-time stride lets nvcc unroll the block-wide loops.

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

}  // namespace blend
