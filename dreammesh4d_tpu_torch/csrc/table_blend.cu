// Alpha compositing over a dense (T, K) per-tile index table, forward (B6)
// and replay backward (B7), one thread block per 16x16 screen tile and one
// thread per pixel (Hopper, sm_90a).
//
// Replaces: dreammesh4d_tpu/ops/gs/pallas_blend.py::_fwd_kernel (entry
// table_fwd) and ::_bwd_kernel together with the per-Gaussian scatter-add of
// _blend_bwd_rule that follows it (entry table_bwd).  Same function, not the
// same layout: the TPU kernels read rows that XLA pre-gathered into a
// (T, K, 16) block (134 MB per view at K = 2048), form a group's
// transmittance from a bf16 triangular matmul over log(1 - alpha) and emit
// per-slot gradient rows that XLA scatter-adds.  Here a block reads its
// tile's slice of the index table and gathers the referenced rows of the
// (N+1, 16) table into shared memory a group (forward) or 32 entries
// (backward) at a time; each thread walks its pixel front to back in exact
// float32; the backward reduces each entry's gradient row over the block's
// 256 pixels and adds it into the Gaussian's row with one atomicAdd per
// column.  A Gaussian occurs at most once in a tile, so the atomics of one
// block never collide.
//
// Inputs
//   rows       (N+1, 16) f32  [mx, my, ca, cb, cc, c_0..c_{C-1}, 0.., op@14, 0],
//                              row N is a zero sentinel
//   tile_gauss (T, K) i32     row ids per tile, front to back, in [0, N]
//   counts     (T,) i32       entries per tile; only the first min(count, K)
//                              are read, so sentinel ids past them cost nothing
//   out, cot   (T, C+1, 256) f32 (backward): the forward's output (C channels,
//              then the final transmittance) and its cotangent
// Outputs
//   table_fwd: out (T, C+1, 256) f32, pixel p = y * 16 + x inside the tile
//   table_bwd: grads (N+1, 16) f32, zeroed by the caller on the launch's
//              stream: [d_mx, d_my, d_ca, d_cb, d_cc, d_c_0..d_c_{C-1}, 0..,
//              d_op@14, 0] summed over every tile that holds the Gaussian
//
// Semantics shared with the plain versions (table_blend.blend_table_plain,
// blend_table_bwd_plain), B1/B2 and the TPU kernels: the live test, the
// forward and replay steps and the block reduction of blend_common.cuh, with
// px = tile origin + x; the tile stops before a group of `group` entries once
// every pixel's transmittance is <= 1e-4 (a block-wide vote, at the same
// entries in the forward and the replay).
//
// Bound on this card: operations.  Every evaluated (entry, pixel) costs an
// exp and ~20 FP32 operations (the backward ~3x that plus the block
// reduction), with no reuse across tiles; the bytes (index table, the rows
// it references, the output or the two cotangent blocks and the gradient
// table) are a few tens of MB, ~10 us at 3.35 TB/s.  Design: rows staged in
// shared memory and read by every thread as a broadcast, so the inner loop
// is register arithmetic; the backward skips a warp's reduction of an entry
// none of its pixels composites and emits 32 entries per three barriers.

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // one thread per pixel
static_assert(kPixels == kThreads, "one thread per pixel of a 16x16 tile");

template <int C>
__global__ void __launch_bounds__(kThreads)
table_fwd_kernel(const float4* __restrict__ rows, const int* __restrict__ tile_gauss,
                 const int* __restrict__ counts, float* __restrict__ out, int K, int tiles_x,
                 int group) {
  extern __shared__ float4 smem4[];
  const float* srow = reinterpret_cast<const float*>(smem4);

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int count = min(counts[t], K);
  const int* ids = tile_gauss + static_cast<size_t>(t) * K;
  const float px = static_cast<float>((t % tiles_x) * kTile + p % kTile);
  const float py = static_cast<float>((t / tiles_x) * kTile + p / kTile);

  float trans = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  for (int g0 = 0; g0 < count; g0 += group) {
    // block-wide exit; also the barrier before the staging buffer is reused
    if (!__syncthreads_or(trans > kTEps)) break;
    const int n = min(group, count - g0);
    stage_rows(smem4, nullptr, rows, ids + g0, n);
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float* r = srow + j * kRow;
      const Hit h = evaluate(r, px, py);
      if (h.live) composite<C>(r, h, trans, acc);
    }
  }

  float* o = out + static_cast<size_t>(t) * (C + 1) * kPixels;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c * kPixels + p] = acc[c];
  o[C * kPixels + p] = trans;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
table_bwd_kernel(const float4* __restrict__ rows, const int* __restrict__ tile_gauss,
                 const int* __restrict__ counts, const float* __restrict__ out,
                 const float* __restrict__ cot, float* __restrict__ grads, int K, int tiles_x,
                 int group) {
  __shared__ float4 srow4[kChunk * (kRow / 4)];
  __shared__ int sidx[kChunk];
  __shared__ Partials part;
  const float* srow = reinterpret_cast<const float*>(srow4);

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int count = min(counts[t], K);
  const int* ids = tile_gauss + static_cast<size_t>(t) * K;
  const float px = static_cast<float>((t % tiles_x) * kTile + p % kTile);
  const float py = static_cast<float>((t / tiles_x) * kTile + p / kTile);
  const float* o = out + static_cast<size_t>(t) * (C + 1) * kPixels;
  const float* g = cot + static_cast<size_t>(t) * (C + 1) * kPixels;

  float gc[C];
  float s_tot = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    gc[c] = g[c * kPixels + p];
    s_tot += o[c * kPixels + p] * gc[c];
  }
  s_tot += g[C * kPixels + p] * o[C * kPixels + p];
  float trans = 1.0f;
  float prefix = 0.0f;

  for (int g0 = 0; g0 < count; g0 += group) {
    // the exit vote of the forward, on the replayed transmittance; a barrier too
    if (!__syncthreads_or(trans > kTEps)) break;
    const int g_end = min(g0 + group, count);

    for (int c0 = g0; c0 < g_end; c0 += kChunk) {
      const int n = min(kChunk, g_end - c0);
      stage_rows(srow4, sidx, rows, ids + c0, n);
      __syncthreads();

      for (int j = 0; j < n; ++j) {
        const float* r = srow + j * kRow;
        const Hit h = evaluate(r, px, py);
        Sums<C> sums;
        sums.zero();
        if (h.live) replay<C>(r, h, gc, s_tot, trans, prefix, sums);
        warp_partial<C>(r, h.live, sums, part, j);
      }
      __syncthreads();

      // add each entry's row to its Gaussian's row
      emit_rows<C>(part, n, [&](int j, int c, float v) {
        atomicAdd(grads + static_cast<size_t>(sidx[j]) * kRow + c, v);
      });
      // the next chunk's staging rewrites sidx and the partial rows, which the emit reads
      __syncthreads();
    }
  }
}

bool bad_args(int n_tiles, int K, int tiles_x, int group) {
  return n_tiles < 0 || K < 0 || tiles_x < 1 || group < 1 || group > kMaxGroup;
}

}  // namespace

// Both return the CUDA error code of the launch (0 = success).  The caller
// checks shapes and types; here only the ranges the kernels rely on.

extern "C" int table_fwd(const float* rows, const int* tile_gauss, const int* counts, float* out,
                         int n_tiles, int K, int tiles_x, int group, int n_channels,
                         void* stream) {
  if (bad_args(n_tiles, K, tiles_x, group)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(group) * kRow * sizeof(float);
  const float4* r4 = reinterpret_cast<const float4*>(rows);
#define TABLE_FWD_CASE(CH)                                                                      \
  case CH:                                                                                      \
    table_fwd_kernel<CH><<<n_tiles, kThreads, smem, s>>>(r4, tile_gauss, counts, out, K,        \
                                                         tiles_x, group);                       \
    break;
  switch (n_channels) {
    TABLE_FWD_CASE(1)
    TABLE_FWD_CASE(2)
    TABLE_FWD_CASE(3)
    TABLE_FWD_CASE(4)
    TABLE_FWD_CASE(5)
    TABLE_FWD_CASE(6)
    TABLE_FWD_CASE(7)
    TABLE_FWD_CASE(8)
    TABLE_FWD_CASE(9)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TABLE_FWD_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" int table_bwd(const float* rows, const int* tile_gauss, const int* counts,
                         const float* out, const float* cot, float* grads, int n_tiles, int K,
                         int tiles_x, int group, int n_channels, void* stream) {
  if (bad_args(n_tiles, K, tiles_x, group)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* r4 = reinterpret_cast<const float4*>(rows);
#define TABLE_BWD_CASE(CH)                                                                      \
  case CH:                                                                                      \
    table_bwd_kernel<CH><<<n_tiles, kThreads, 0, s>>>(r4, tile_gauss, counts, out, cot, grads,  \
                                                      K, tiles_x, group);                       \
    break;
  switch (n_channels) {
    TABLE_BWD_CASE(1)
    TABLE_BWD_CASE(2)
    TABLE_BWD_CASE(3)
    TABLE_BWD_CASE(4)
    TABLE_BWD_CASE(5)
    TABLE_BWD_CASE(6)
    TABLE_BWD_CASE(7)
    TABLE_BWD_CASE(8)
    TABLE_BWD_CASE(9)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TABLE_BWD_CASE
  return static_cast<int>(cudaGetLastError());
}
