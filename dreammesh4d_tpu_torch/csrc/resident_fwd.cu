// Forward alpha compositing of each screen tile's segment of Gaussian
// entries, one cluster of CTAs per tile (Hopper, sm_90a).  Two entry
// points, one body: resident_fwd (B1) over depth-sorted pair segments, and
// table_fwd (B6) over the dense (T, K) index table of backend: pallas.
//
// Replaces: dreammesh4d_tpu/ops/gs/pallas_resident.py::_fwd_kernel (B1) and
// dreammesh4d_tpu/ops/gs/pallas_blend.py::_fwd_kernel (B6; TPU Pallas).
// Same function, not the same layout: the TPU kernels composite a group of
// entries with a triangular bf16 matmul over log(1 - alpha) and an MXU
// colour dot (B6 on rows that XLA pre-gathered into a (T, K, 16) block);
// here each thread walks its pixel front to back with exact float32
// products.
//
// Inputs
//   rows   (N+1, 16) f32  [mx, my, ca, cb, cc, c_0..c_{C-1}, 0.., op@14, 0],
//                          row N is a zero sentinel
//   pairs  (NM,) i32      Gaussian ids grouped by tile, front to back
//   starts, counts (T,) i32 per-tile segment of `pairs`
//   table_fwd: tile_gauss (T, K) i32 in place of pairs, tile t's segment
//          at t * K (no starts), cap = K, tile = 16; ids in [0, N]
// Outputs
//   out    (T, C+1, tile*tile) f32: C accumulated channels, then the final
//          transmittance; pixel p = y * tile + x inside the tile.
//   walked (2, T, 4) i32, optional (null: none), per quadrant CTA: [0] the
//          pair slots it stepped through before its tile stopped (culled
//          rows included), [1] how many of those rows its cull kept (B6
//          does not cull: all of them); column 0 only when tile <= 16.
//
// Semantics shared with the plain versions (resident_blend.blend_pairs_plain,
// table_blend.blend_table_plain) and the TPU kernels: the live test and the
// forward step of blend_common.cuh, with px = tile origin + x; only the
// first min(count, cap) pairs of a segment are read; the tile stops before a
// group of `group` pairs once every pixel's transmittance is <= 1e-4 (a vote
// of the whole cluster per group).
//
// Bound on this card: the work is (walked pairs) x (pixels) exp + ~20 FP32
// operations with no reuse across tiles, so it is bounded by operations,
// not bytes (the inputs and output are ~11 MB at 512^2, ~3 us at 3.35 TB/s).
// Design (cluster_blend.cuh): a 32-px tile is four 16x16 quadrant CTAs of one
// pixel per thread, 1024 CTAs at 512^2 instead of 256 blocks of four pixels
// per thread; each CTA composites only the staged rows that can be live in
// its quadrant, while the next group's rows arrive by cp.async; the rows sit
// in shared memory and every thread reads the same one (a broadcast).  B6's
// 16-px tiles are one CTA each, launched without a cluster; it walks every
// staged row (the binning already culled them per tile) in a
// loop unrolled by kTableUnroll.

#include "cluster_blend.cuh"

namespace {

using namespace blend;

// Shared memory: two row buffers of `group` rows, then the cull list.
__host__ __device__ constexpr size_t smem_bytes(int group) {
  return static_cast<size_t>(group) * (2 * kRow * sizeof(float) + sizeof(int));
}

// The body of both kernels; CULL: composite only the staged rows cull_rows
// keeps, else every staged row; UNROLL: of the walk over them (walk_rows).
template <int C, bool CULL, int UNROLL>
__device__ __forceinline__ void fwd_body(const float4* __restrict__ rows,
                                         const int* __restrict__ pairs,
                                         const int* __restrict__ starts,
                                         const int* __restrict__ counts, float* __restrict__ out,
                                         int* __restrict__ walked, int nq, int tiles_x, int tile,
                                         int cap, int group) {
  extern __shared__ float4 smem4[];
  __shared__ int vote[2];
  __shared__ int warp_cnt[kMaxRounds * kWarps];
  // the rows of group k, staged in buffer k & 1
  auto buffer = [&](int k) { return smem4 + (k & 1) * group * (kRow / 4); };
  int* list = reinterpret_cast<int*>(smem4 + 2 * group * (kRow / 4));

  const Quadrant q = quadrant(nq, tiles_x, tile);
  const int P = tile * tile;
  const int count = min(counts[q.t], cap);
  const int* seg = segment(pairs, starts, q.t, cap);

  float trans = q.valid ? 1.0f : 0.0f;  // pixels past the tile never keep it alive
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  int n_walked = 0, n_kept = 0;
  if (count > 0) stage_rows_async(buffer(0), rows, seg, min(group, count));
  for (int g0 = 0, k = 0; g0 < count; g0 += group, ++k) {
    // tile-wide exit; also the barrier before the other buffer is rewritten
    if (!tile_alive(vote, k & 1, trans > kTEps, nq)) break;
    const int n = min(group, count - g0);
    n_walked += n;
    const int next = g0 + group;
    stage_rows_async(buffer(k + 1), rows, seg + next, next < count ? min(group, count - next) : 0);
    cp_async_wait<1>();
    __syncthreads();

    const float* srow = reinterpret_cast<const float*>(buffer(k));
    const int kept = CULL ? cull_rows(srow, n, q, list, warp_cnt) : n;
    n_kept += kept;
    walk_rows<UNROLL>(kept, [&](int i) {
      float r[kRow];
      load_row(r, srow + (CULL ? list[i] : i) * kRow);
      const Hit h = evaluate(r, q.px, q.py);
      if (h.live) composite<C>(r, h, trans, acc);
    });
  }
  cp_async_wait<0>();
  // no CTA leaves while another may still read its vote
  if (nq > 1) cg::this_cluster().sync();

  if (walked != nullptr && threadIdx.x == 0) write_walked(walked, q, nq, n_walked, n_kept);
  if (!q.valid) return;
  float* o = out + static_cast<size_t>(q.t) * (C + 1) * P;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c * P + q.p] = acc[c];
  o[C * P + q.p] = trans;
}

// B1 and B6 under names of their own, which the profiler tells apart.
template <int C>
__global__ void __launch_bounds__(kThreads)
resident_fwd_kernel(const float4* __restrict__ rows, const int* __restrict__ pairs,
                    const int* __restrict__ starts, const int* __restrict__ counts,
                    float* __restrict__ out, int* __restrict__ walked, int nq, int tiles_x,
                    int tile, int cap, int group) {
  fwd_body<C, true, 0>(rows, pairs, starts, counts, out, walked, nq, tiles_x, tile, cap, group);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
table_fwd_kernel(const float4* __restrict__ rows, const int* __restrict__ pairs,
                 const int* __restrict__ starts, const int* __restrict__ counts,
                 float* __restrict__ out, int* __restrict__ walked, int nq, int tiles_x, int tile,
                 int cap, int group) {
  fwd_body<C, false, kTableUnroll>(rows, pairs, starts, counts, out, walked, nq, tiles_x, tile, cap,
                                  group);
}

template <int C>
int launch(bool table, const float* rows, const int* pairs, const int* starts, const int* counts,
           float* out, int* walked, int n_tiles, int tiles_x, int tile, int cap, int group,
           cudaStream_t stream) {
  return static_cast<int>(launch_clusters(
      table ? table_fwd_kernel<C> : resident_fwd_kernel<C>, n_tiles, tile, smem_bytes(group),
      stream, reinterpret_cast<const float4*>(rows), pairs, starts, counts, out, walked,
      quads_of(tile), tiles_x, tile, cap, group));
}

// The caller checks shapes; here only the ranges the kernels rely on.
int dispatch(bool table, const float* rows, const int* pairs, const int* starts,
             const int* counts, float* out, int* walked, int n_tiles, int tiles_x, int tile,
             int cap, int group, int n_channels, void* stream) {
  if (n_tiles < 0 || tiles_x < 1 || tile < 1 || tile > 2 * kQuad || cap < 0 || group < 1 ||
      group > kMaxGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD_CASE(CH)                                                                           \
  case CH:                                                                                     \
    return launch<CH>(table, rows, pairs, starts, counts, out, walked, n_tiles, tiles_x, tile, \
                      cap, group, s);
  switch (n_channels) {
    FWD_CASE(1)
    FWD_CASE(2)
    FWD_CASE(3)
    FWD_CASE(4)
    FWD_CASE(5)
    FWD_CASE(6)
    FWD_CASE(7)
    FWD_CASE(8)
    FWD_CASE(9)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FWD_CASE
}

}  // namespace

// Both return the CUDA error code of the launch (0 = success), also where
// the card refuses the cluster launch.

// B1: the pair segments pairs[starts[t] ..], tile <= 32.
extern "C" int resident_fwd(const float* rows, const int* pairs, const int* starts,
                            const int* counts, float* out, int* walked, int n_tiles, int tiles_x,
                            int tile, int cap, int group, int n_channels, void* stream) {
  return dispatch(false, rows, pairs, starts, counts, out, walked, n_tiles, tiles_x, tile, cap,
                  group, n_channels, stream);
}

// B6: row t of tile_gauss (T, K) is tile t's segment, 16-px tiles.
extern "C" int table_fwd(const float* rows, const int* tile_gauss, const int* counts, float* out,
                         int* walked, int n_tiles, int K, int tiles_x, int group, int n_channels,
                         void* stream) {
  return dispatch(true, rows, tile_gauss, nullptr, counts, out, walked, n_tiles, tiles_x, kQuad, K,
                  group, n_channels, stream);
}
