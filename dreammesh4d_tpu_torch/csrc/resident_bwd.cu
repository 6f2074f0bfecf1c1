// Replay backward of the per-tile alpha compositing (Hopper, sm_90a): one
// thread block per screen tile, two entry points that differ only in where a
// pair's 16-wide gradient row goes.
//
// Replaces: dreammesh4d_tpu/ops/gs/pallas_resident.py::_bwd_kernel_accum
// (entry resident_bwd_accum: rows summed per Gaussian into an (N+1, 16)
// table) and ::_bwd_kernel (entry resident_bwd_pairs: rows written per pair
// slot into (T, cap, 16), reduced per Gaussian outside).  Same function, not
// the same layout: the TPU kernels form the running transmittance and the
// prefix sums of a 128-pair group with triangular bf16 matmuls and
// read-modify-write a VMEM table, which is legal there because the TPU grid
// is sequential.  Here blocks run in no order: each thread replays its pixels
// front to back in exact float32, a pair's sums are reduced across the
// block's pixels (warp shuffles, then shared memory), and the accumulating
// entry does one atomicAdd per column per (tile, pair).  A Gaussian occurs
// at most once per tile, so there is no conflict inside a block.
//
// Inputs
//   rows   (N+1, 16) f32  [mx, my, ca, cb, cc, c_0..c_{C-1}, 0.., op@14, 0]
//   pairs  (NM,) i32, starts/counts (T,) i32: per-tile segments, front to back
//   out    (T, C+1, tile*tile) f32: the forward's output (colours, final T)
//   cot    (T, C+1, tile*tile) f32: its cotangent
// Output (zeroed by the caller on the same stream before the launch)
//   accum: grads (N+1, 16) f32;  pairs: grads (T, cap, 16) f32
//   columns [d_mx, d_my, d_ca, d_cb, d_cc, d_c_0..d_c_{C-1}, 0.., d_op@14, 0]
//
// Per tile, pixel and pair (front to back): the replay step and the block
// reduction of blend_common.cuh, with the forward's live test.
// The tile stops before a group of `group` pairs once every pixel's replayed
// transmittance is <= 1e-4: the same vote, on the same products, as the
// forward, so both agree about which pairs exist.
//
// Bound on this card: operations, as the forward (the replay is ~3x the
// forward's arithmetic per evaluated pixel plus the block reduction; inputs
// and outputs are a few tens of MB, ~10 us at 3.35 TB/s).  Design: pairs are
// staged 32 at a time in shared memory; a warp owns a contiguous strip of
// the tile (4 rows of a 32-px tile) and skips the reduction of a pair none of
// its pixels composites; warps leave partial rows in shared memory and the
// block sums and emits the 32 rows together, so there are three barriers per
// 32 pairs instead of one per pair.

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int kMaxPixelsPerThread = 4;  // tile * tile <= 1024

template <int C, bool PER_PAIR>
__global__ void __launch_bounds__(kThreads)
resident_bwd_kernel(const float4* __restrict__ rows, const int* __restrict__ pairs,
                    const int* __restrict__ starts, const int* __restrict__ counts,
                    const float* __restrict__ out, const float* __restrict__ cot,
                    float* __restrict__ grads, int tiles_x, int tile, int cap, int group) {
  __shared__ float4 srow4[kChunk * (kRow / 4)];
  __shared__ int sidx[kChunk];
  __shared__ Partials part;
  const float* srow = reinterpret_cast<const float*>(srow4);

  const int t = blockIdx.x;
  const int P = tile * tile;
  const int n_pix = (P + kThreads - 1) / kThreads;
  const int count = min(counts[t], cap);
  const int start = starts[t];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float ox = static_cast<float>((t % tiles_x) * tile);
  const float oy = static_cast<float>((t / tiles_x) * tile);
  const float* o = out + static_cast<size_t>(t) * (C + 1) * P;
  const float* g = cot + static_cast<size_t>(t) * (C + 1) * P;

  // a warp owns the contiguous pixels [warp * 32 * n_pix, (warp + 1) * 32 * n_pix)
  float px[kMaxPixelsPerThread], py[kMaxPixelsPerThread], trans[kMaxPixelsPerThread];
  float s_tot[kMaxPixelsPerThread], prefix[kMaxPixelsPerThread];
  float gc[kMaxPixelsPerThread][C];
  bool valid[kMaxPixelsPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    const int p = warp * 32 * n_pix + k * 32 + lane;
    valid[k] = (k < n_pix) && (p < P);
    px[k] = ox + static_cast<float>(p % tile);
    py[k] = oy + static_cast<float>(p / tile);
    trans[k] = valid[k] ? 1.0f : 0.0f;  // pixels past the tile never keep it alive
    prefix[k] = 0.0f;
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gc[k][c] = valid[k] ? g[c * P + p] : 0.0f;
      if (valid[k]) s += o[c * P + p] * gc[k][c];
    }
    if (valid[k]) s += g[C * P + p] * o[C * P + p];
    s_tot[k] = s;
  }

  for (int g0 = 0; g0 < count; g0 += group) {
    int alive = 0;
#pragma unroll
    for (int k = 0; k < kMaxPixelsPerThread; ++k) alive |= (trans[k] > kTEps);
    // tile-wide exit, at the pair where the forward stopped; also a barrier
    if (!__syncthreads_or(alive)) break;
    const int g_end = min(g0 + group, count);

    for (int c0 = g0; c0 < g_end; c0 += kChunk) {
      const int n = min(kChunk, g_end - c0);
      stage_rows(srow4, sidx, rows, pairs + start + c0, n);
      __syncthreads();

      for (int j = 0; j < n; ++j) {
        const float* r = srow + j * kRow;
        Sums<C> sums;
        sums.zero();
        bool any_live = false;
#pragma unroll
        for (int k = 0; k < kMaxPixelsPerThread; ++k) {
          if (k >= n_pix) break;
          const Hit h = evaluate(r, px[k], py[k]);
          if (h.live && valid[k]) {
            any_live = true;
            replay<C>(r, h, gc[k], s_tot[k], trans[k], prefix[k], sums);
          }
        }
        warp_partial<C>(r, any_live, sums, part, j);
      }
      __syncthreads();

      emit_rows<C>(part, n, [&](int j, int c, float v) {
        if (PER_PAIR) {
          grads[(static_cast<size_t>(t) * cap + (c0 + j)) * kRow + c] = v;
        } else {
          atomicAdd(grads + static_cast<size_t>(sidx[j]) * kRow + c, v);
        }
      });
      // the next chunk's staging rewrites sidx, which the emit still reads
      __syncthreads();
    }
  }
}

template <int C, bool PER_PAIR>
void launch(const float* rows, const int* pairs, const int* starts, const int* counts,
            const float* out, const float* cot, float* grads, int n_tiles, int tiles_x,
            int tile, int cap, int group, cudaStream_t stream) {
  resident_bwd_kernel<C, PER_PAIR><<<n_tiles, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(rows), pairs, starts, counts, out, cot, grads, tiles_x,
      tile, cap, group);
}

template <bool PER_PAIR>
int dispatch(const float* rows, const int* pairs, const int* starts, const int* counts,
             const float* out, const float* cot, float* grads, int n_tiles, int tiles_x,
             int tile, int cap, int group, int n_channels, void* stream) {
  if (tile < 1 || tile * tile > kThreads * kMaxPixelsPerThread || group < 1 || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RESIDENT_BWD_CASE(CH)                                                              \
  case CH:                                                                                 \
    launch<CH, PER_PAIR>(rows, pairs, starts, counts, out, cot, grads, n_tiles, tiles_x,   \
                         tile, cap, group, s);                                             \
    break;
  switch (n_channels) {
    RESIDENT_BWD_CASE(1)
    RESIDENT_BWD_CASE(2)
    RESIDENT_BWD_CASE(3)
    RESIDENT_BWD_CASE(4)
    RESIDENT_BWD_CASE(5)
    RESIDENT_BWD_CASE(6)
    RESIDENT_BWD_CASE(7)
    RESIDENT_BWD_CASE(8)
    RESIDENT_BWD_CASE(9)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RESIDENT_BWD_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return the CUDA error code of the launch (0 = success).  The caller
// checks shapes and zeroes `grads` on `stream` before the call.

// grads (N+1, 16): each pair's row added to its Gaussian's row.
extern "C" int resident_bwd_accum(const float* rows, const int* pairs, const int* starts,
                                  const int* counts, const float* out, const float* cot,
                                  float* grads, int n_tiles, int tiles_x, int tile, int cap,
                                  int group, int n_channels, void* stream) {
  return dispatch<false>(rows, pairs, starts, counts, out, cot, grads, n_tiles, tiles_x, tile,
                         cap, group, n_channels, stream);
}

// grads (T, cap, 16): each pair's row written at (tile, slot).
extern "C" int resident_bwd_pairs(const float* rows, const int* pairs, const int* starts,
                                  const int* counts, const float* out, const float* cot,
                                  float* grads, int n_tiles, int tiles_x, int tile, int cap,
                                  int group, int n_channels, void* stream) {
  return dispatch<true>(rows, pairs, starts, counts, out, cot, grads, n_tiles, tiles_x, tile,
                        cap, group, n_channels, stream);
}
