// Forward alpha compositing of depth-sorted Gaussian pair segments, one
// thread block per screen tile (Hopper, sm_90a).
//
// Replaces: dreammesh4d_tpu/ops/gs/pallas_resident.py::_fwd_kernel (TPU
// Pallas).  Same function, not the same layout: the TPU kernel composites a
// group of pairs with a triangular bf16 matmul over log(1 - alpha) and an MXU
// colour dot; here each thread walks its pixels front to back with exact
// float32 products.
//
// Inputs
//   rows   (N+1, 16) f32  [mx, my, ca, cb, cc, c_0..c_{C-1}, 0.., op@14, 0],
//                          row N is a zero sentinel
//   pairs  (NM,) i32      Gaussian ids grouped by tile, front to back
//   starts, counts (T,) i32 per-tile segment of `pairs`
// Output
//   out    (T, C+1, tile*tile) f32: C accumulated channels, then the final
//          transmittance; pixel p = y * tile + x inside the tile.
//
// Semantics shared with the plain version (resident_blend.blend_pairs_plain)
// and the TPU kernel: the live test and the forward step of blend_common.cuh,
// with px = tile origin + x; only the first min(count, cap) pairs of a
// segment are read; the tile stops before a group of `group` pairs once every
// pixel's transmittance is <= 1e-4 (one __syncthreads_or per group).
//
// Bound on this card: the work is (live pairs) x (pixels) exp + ~30 FP32
// operations with no reuse across tiles, so it is bounded by operations,
// not bytes (the inputs and output are ~11 MB at 512^2, ~3 us at 3.35 TB/s).
// Design: a group of rows is staged once in shared memory and every thread
// reads the same row (a broadcast), so the inner loop is pure register
// arithmetic on 4 pixels per thread.

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int kMaxPixelsPerThread = 4;  // tile * tile <= 1024

template <int C>
__global__ void __launch_bounds__(kThreads)
resident_fwd_kernel(const float4* __restrict__ rows, const int* __restrict__ pairs,
                    const int* __restrict__ starts, const int* __restrict__ counts,
                    float* __restrict__ out, int tiles_x, int tile, int cap, int group) {
  extern __shared__ float4 smem4[];
  const float* srow = reinterpret_cast<const float*>(smem4);

  const int t = blockIdx.x;
  const int P = tile * tile;
  const int n_pix = (P + kThreads - 1) / kThreads;
  const int count = min(counts[t], cap);
  const int start = starts[t];
  const float ox = static_cast<float>((t % tiles_x) * tile);
  const float oy = static_cast<float>((t / tiles_x) * tile);

  float px[kMaxPixelsPerThread], py[kMaxPixelsPerThread], trans[kMaxPixelsPerThread];
  float acc[kMaxPixelsPerThread][C];
#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    px[k] = ox + static_cast<float>(p % tile);
    py[k] = oy + static_cast<float>(p / tile);
    // pixels past the tile never keep it alive
    trans[k] = (k < n_pix && p < P) ? 1.0f : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] = 0.0f;
  }

  for (int g0 = 0; g0 < count; g0 += group) {
    int alive = 0;
#pragma unroll
    for (int k = 0; k < kMaxPixelsPerThread; ++k) alive |= (trans[k] > kTEps);
    // tile-wide exit; also the barrier before the staging buffer is reused
    if (!__syncthreads_or(alive)) break;

    const int n = min(group, count - g0);
    stage_rows(smem4, nullptr, rows, pairs + start + g0, n);
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float* r = srow + j * kRow;
#pragma unroll
      for (int k = 0; k < kMaxPixelsPerThread; ++k) {
        if (k >= n_pix) break;
        const Hit h = evaluate(r, px[k], py[k]);
        if (h.live) composite<C>(r, h, trans[k], acc[k]);
      }
    }
  }

  float* o = out + static_cast<size_t>(t) * (C + 1) * P;
#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (k >= n_pix || p >= P) break;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c * P + p] = acc[k][c];
    o[C * P + p] = trans[k];
  }
}

template <int C>
void launch(const float* rows, const int* pairs, const int* starts, const int* counts,
            float* out, int n_tiles, int tiles_x, int tile, int cap, int group,
            cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(group) * kRow * sizeof(float);
  resident_fwd_kernel<C><<<n_tiles, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(rows), pairs, starts, counts, out, tiles_x, tile,
      cap, group);
}

}  // namespace

// Returns the CUDA error code of the launch (0 = success).  The caller
// checks shapes; here only the ranges the kernel relies on.
extern "C" int resident_fwd(const float* rows, const int* pairs, const int* starts,
                            const int* counts, float* out, int n_tiles, int tiles_x,
                            int tile, int cap, int group, int n_channels, void* stream) {
  if (tile < 1 || tile * tile > kThreads * kMaxPixelsPerThread || group < 1 ||
      group > kMaxGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_channels) {
    case 1: launch<1>(rows, pairs, starts, counts, out, n_tiles, tiles_x, tile, cap, group, s); break;
    case 2: launch<2>(rows, pairs, starts, counts, out, n_tiles, tiles_x, tile, cap, group, s); break;
    case 3: launch<3>(rows, pairs, starts, counts, out, n_tiles, tiles_x, tile, cap, group, s); break;
    case 4: launch<4>(rows, pairs, starts, counts, out, n_tiles, tiles_x, tile, cap, group, s); break;
    case 5: launch<5>(rows, pairs, starts, counts, out, n_tiles, tiles_x, tile, cap, group, s); break;
    case 6: launch<6>(rows, pairs, starts, counts, out, n_tiles, tiles_x, tile, cap, group, s); break;
    case 7: launch<7>(rows, pairs, starts, counts, out, n_tiles, tiles_x, tile, cap, group, s); break;
    case 8: launch<8>(rows, pairs, starts, counts, out, n_tiles, tiles_x, tile, cap, group, s); break;
    case 9: launch<9>(rows, pairs, starts, counts, out, n_tiles, tiles_x, tile, cap, group, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
