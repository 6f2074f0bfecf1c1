// Replay backward of the per-tile alpha compositing (Hopper, sm_90a): one
// cluster of CTAs per screen tile, two entry points that differ only in
// where a pair's 16-wide gradient row goes.
//
// Replaces: dreammesh4d_tpu/ops/gs/pallas_resident.py::_bwd_kernel_accum
// (entry resident_bwd_accum: rows summed per Gaussian into an (N+1, 16)
// table) and ::_bwd_kernel (entry resident_bwd_pairs: rows written per pair
// slot into (T, cap, 16), reduced per Gaussian outside).  Same function, not
// the same layout: the TPU kernels form the running transmittance and the
// prefix sums of a 128-pair group with triangular bf16 matmuls and
// read-modify-write a VMEM table, which is legal there because the TPU grid
// is sequential.  Here clusters run in no order: each thread replays its
// pixel front to back in exact float32, a pair's sums are reduced across the
// CTA's pixels (warp shuffles, then shared-memory atomics), and each CTA
// does one atomicAdd per column per (quadrant, pair) into the zeroed table,
// per Gaussian or per pair slot.  A Gaussian occurs at most once per tile,
// so a row has at most the cluster's four writers.
//
// Inputs
//   rows   (N+1, 16) f32  [mx, my, ca, cb, cc, c_0..c_{C-1}, 0.., op@14, 0]
//   pairs  (NM,) i32, starts/counts (T,) i32: per-tile segments, front to back
//   out    (T, C+1, tile*tile) f32: the forward's output (colours, final T)
//   cot    (T, C+1, tile*tile) f32: its cotangent
// Outputs
//   grads (zeroed by the caller on the same stream before the launch)
//     accum: (N+1, 16) f32;  pairs: (T, cap, 16) f32
//     columns [d_mx, d_my, d_ca, d_cb, d_cc, d_c_0..d_c_{C-1}, 0.., d_op@14, 0]
//   walked (2, T, 4) i32, optional (null: none): as in resident_fwd.cu
//
// Per tile, pixel and pair (front to back): the replay step of
// blend_common.cuh, with the forward's live test.  The tile stops before a
// group of `group` pairs once every pixel's replayed transmittance is
// <= 1e-4: the same vote of the whole cluster, on the same products, as the
// forward, so both agree about which pairs exist.
//
// Bound on this card: operations, as the forward (the replay is ~3x the
// forward's arithmetic per evaluated pixel plus the reduction; inputs and
// outputs are a few tens of MB, ~10 us at 3.35 TB/s).  Design
// (cluster_blend.cuh): four 16x16 quadrant CTAs per 32-px tile, one pixel
// per thread; a CTA replays only the staged rows that can be live in its
// quadrant, while the next group's rows arrive by cp.async.  A warp with a
// live pixel reduces its 6 + C sums of a row in 16 shuffles (a transposed
// butterfly that leaves column c on lane c) and its lanes add them into the
// CTA's raw row of that pair in shared memory; after the group each CTA
// forms the conic and opacity columns of its rows and adds them to the
// table, so a per-pair slot of resident_bwd_pairs too gets up to four adds
// in no fixed order and its bits may differ by rounding from run to run.
// (Summing the four CTAs' rows through distributed shared memory first, one
// write per column per (tile, pair), was slower on an H100; PERF.md has the times.)

#include "cluster_blend.cuh"

namespace {

using namespace blend;

// Shared memory: two row buffers of `group` rows, the raw sums of `group`
// rows, then the cull list.
__host__ __device__ constexpr size_t smem_bytes(int group) {
  return static_cast<size_t>(group) * (3 * kRow * sizeof(float) + sizeof(int));
}

template <int C, bool PER_PAIR>
__global__ void __launch_bounds__(kThreads)
resident_bwd_kernel(const float4* __restrict__ rows, const int* __restrict__ pairs,
                    const int* __restrict__ starts, const int* __restrict__ counts,
                    const float* __restrict__ out, const float* __restrict__ cot,
                    float* __restrict__ grads, int* __restrict__ walked, int nq, int tiles_x,
                    int tile, int cap, int group) {
  extern __shared__ float4 smem4[];
  __shared__ int vote[2];
  __shared__ int warp_cnt[kMaxRounds * kWarps];
  // the rows of group k, staged in buffer k & 1
  auto buffer = [&](int k) { return smem4 + (k & 1) * group * (kRow / 4); };
  float* part = reinterpret_cast<float*>(smem4 + 2 * group * (kRow / 4));
  int* list = reinterpret_cast<int*>(part + group * kRow);
  cg::cluster_group cluster = cg::this_cluster();

  const Quadrant q = quadrant(nq, tiles_x, tile);
  const int P = tile * tile;
  const int count = min(counts[q.t], cap);
  const int* seg = pairs + starts[q.t];

  float gc[C];
  float s_tot = 0.0f;
  float trans = q.valid ? 1.0f : 0.0f;  // pixels past the tile never keep it alive
  float prefix = 0.0f;
  if (q.valid) {
    const float* o = out + static_cast<size_t>(q.t) * (C + 1) * P + q.p;
    const float* g = cot + static_cast<size_t>(q.t) * (C + 1) * P + q.p;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gc[c] = g[c * P];
      s_tot += o[c * P] * gc[c];
    }
    s_tot += g[C * P] * o[C * P];
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) gc[c] = 0.0f;
  }

  int n_walked = 0, n_kept = 0;
  if (count > 0) stage_rows_async(buffer(0), rows, seg, min(group, count));
  for (int g0 = 0, k = 0; g0 < count; g0 += group, ++k) {
    // tile-wide exit, at the pair where the forward stopped; also the barrier
    // after which the CTA is done with the previous group's raw sums
    if (!tile_alive(vote, k & 1, trans > kTEps, nq)) break;
    const int n = min(group, count - g0);
    n_walked += n;
    const int next = g0 + group;
    stage_rows_async(buffer(k + 1), rows, seg + next, next < count ? min(group, count - next) : 0);
    for (int i = threadIdx.x; i < n * kRow; i += kThreads) part[i] = 0.0f;
    cp_async_wait<1>();
    __syncthreads();

    const float* srow = reinterpret_cast<const float*>(buffer(k));
    const int kept = cull_rows(srow, n, q, list, warp_cnt);
    n_kept += kept;
    for (int i = 0; i < kept; ++i) {
      const int j = list[i];
      float r[kRow];
      load_row(r, srow + j * kRow);
      const Hit h = evaluate(r, q.px, q.py);
      const bool live = h.live && q.valid;
      Sums<C> sums;
      sums.zero();
      if (live) replay<C>(r, h, gc, s_tot, trans, prefix, sums);
      warp_add_sums<C>(sums, live, part + j * kRow);
    }
    // every warp's adds into this CTA's raw sums are done
    __syncthreads();
    // each CTA adds its own partial rows: a Gaussian occurs once per tile, so
    // a row of the table has at most the cluster's four writers here
    for (int i = threadIdx.x; i < n * kRow; i += kThreads) {
      const int c = i & (kRow - 1);
      const int j = i >> 4;
      const float* R = part + j * kRow;
      if ((c >= 5 + C && c != kOpCol) || R[kWarpCountCol] == 0.0f) continue;
      const float v = gradient_column<C>(R, srow + j * kRow, c);
      atomicAdd(PER_PAIR ? grads + (static_cast<size_t>(q.t) * cap + (g0 + j)) * kRow + c
                         : grads + static_cast<size_t>(seg[g0 + j]) * kRow + c, v);
    }
  }
  cp_async_wait<0>();
  // no CTA leaves while another may still read its vote
  cluster.sync();
  if (walked != nullptr && threadIdx.x == 0) write_walked(walked, q, nq, n_walked, n_kept);
}

template <int C, bool PER_PAIR>
int launch(const float* rows, const int* pairs, const int* starts, const int* counts,
           const float* out, const float* cot, float* grads, int* walked, int n_tiles,
           int tiles_x, int tile, int cap, int group, cudaStream_t stream) {
  return static_cast<int>(launch_clusters(
      resident_bwd_kernel<C, PER_PAIR>, n_tiles, tile, smem_bytes(group), stream,
      reinterpret_cast<const float4*>(rows), pairs, starts, counts, out, cot, grads, walked,
      quads_of(tile), tiles_x, tile, cap, group));
}

template <bool PER_PAIR>
int dispatch(const float* rows, const int* pairs, const int* starts, const int* counts,
             const float* out, const float* cot, float* grads, int* walked, int n_tiles,
             int tiles_x, int tile, int cap, int group, int n_channels, void* stream) {
  if (tile < 1 || tile > 2 * kQuad || group < 1 || group > kMaxGroup || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RESIDENT_BWD_CASE(CH)                                                              \
  case CH:                                                                                 \
    return launch<CH, PER_PAIR>(rows, pairs, starts, counts, out, cot, grads, walked,      \
                                n_tiles, tiles_x, tile, cap, group, s);
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
}

}  // namespace

// Both return the CUDA error code of the launch (0 = success), also where
// the card refuses the cluster launch.  The caller checks shapes and zeroes
// `grads` on `stream` before the call.

// grads (N+1, 16): each pair's row added to its Gaussian's row.
extern "C" int resident_bwd_accum(const float* rows, const int* pairs, const int* starts,
                                  const int* counts, const float* out, const float* cot,
                                  float* grads, int* walked, int n_tiles, int tiles_x, int tile,
                                  int cap, int group, int n_channels, void* stream) {
  return dispatch<false>(rows, pairs, starts, counts, out, cot, grads, walked, n_tiles, tiles_x,
                         tile, cap, group, n_channels, stream);
}

// grads (T, cap, 16): each pair's row added at (tile, slot) by the quadrant CTAs
// that composited it (at most four adds into the zeroed slot, in no fixed order).
extern "C" int resident_bwd_pairs(const float* rows, const int* pairs, const int* starts,
                                  const int* counts, const float* out, const float* cot,
                                  float* grads, int* walked, int n_tiles, int tiles_x, int tile,
                                  int cap, int group, int n_channels, void* stream) {
  return dispatch<true>(rows, pairs, starts, counts, out, cot, grads, walked, n_tiles, tiles_x,
                        tile, cap, group, n_channels, stream);
}
