// Cell-packed hash-grid encode for Hopper (sm_90a): forward with the analytic
// spatial gradient, and the table-gradient backward.
//
// Replaces the TPU kernels of dreammesh4d_tpu/ops/hashgrid_pallas.py:
//   hashgrid_cell_fwd  <-  _fwd_kernel  (trilinear features and d/dx per level)
//   hashgrid_cell_bwd  <-  _bwd_kernel  (coefficient rows added into the table)
//
// What they compute, per point x in [0,1]^3 and level l of resolution res:
//   xs = x * res,  cell = clamp(floor(xs), 0, res-1),  u = xs - cell
//   row = tables[l][cell id]   (dense id where res^3 <= T, else the uint32
//                               spatial hash of the cell, masked to T)
//   the row holds 8 corners x 2 features, corner c = dx | dy<<1 | dz<<2 at
//   row[2c + f]; w_c is the trilinear weight of corner c, dw_c its d/du
//   feats[n, 2l+f]      = sum_c w_c      * row[2c+f]
//   dfeats[n, 2l+f, d]  = sum_c dw_c[d]  * row[2c+f] * res
// and backward, from the cotangents g_f (N, 2L) and g_d (N, 2L, 3):
//   d_tables[l][cell id][2c+f] += w_c * g_f[f] + res * (dw_c . g_d[f])
// The query points get no gradient (the contract of the kernels replaced).
//
// Bound by bytes on an H100: a (point, level) moves a 64-byte row and 32
// bytes of output against ~200 float operations.  Design:
// - A thread hashes its own cell, so there is no index array and no launch
//   that builds one.
// - Four lanes share one (point, level): each loads one float4 of the row
//   (two corners x two features), so a row is read once, fully used.  The
//   lanes' partial sums are exchanged in a two-step reduce-scatter (6
//   shuffles) that leaves each lane with two of the eight outputs, which it
//   stores as one float2.
// - A warp is one point and its eight quads are eight consecutive levels (two
//   rounds for 16 levels), so a warp writes 64 contiguous bytes of feats and
//   192 of dfeats per round, and reads its cotangents the same way.  With a
//   warp spread over eight points at one level instead, every store filled a
//   quarter of a 32-byte sector and the forward took three times as long.
// - Backward: each lane adds its quarter row with one 16-byte atomicAdd into
//   the zeroed table; sums arrive in a run-dependent order.  Consecutive
//   samples of a ray share a cell on the coarse levels, so those rows take
//   many atomics; combining them across warps first is future work.
// - x * res is formed with __fmul_rn so that nvcc cannot contract it with the
//   subtraction into an FMA: cell and fraction must be those of the plain
//   version.
//
// Plain C entry points, no PyTorch headers; the caller passes device
// pointers, the level resolutions by value and the stream, and allocates
// (and for the backward zeroes) the outputs.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 32
#define THREADS 256
#define POINTS_PER_BLOCK (THREADS / 32)  // a warp per point

struct Levels {
    int res[MAX_LEVELS];
};

// Cell row and the fractions of one point at one level.
__device__ __forceinline__ uint32_t cell_row(float px, float py, float pz, int res, int T,
                                             float& ux, float& uy, float& uz) {
    const float resf = (float)res;
    const float xs = __fmul_rn(px, resf);
    const float ys = __fmul_rn(py, resf);
    const float zs = __fmul_rn(pz, resf);
    const float cx = fminf(fmaxf(floorf(xs), 0.0f), resf - 1.0f);
    const float cy = fminf(fmaxf(floorf(ys), 0.0f), resf - 1.0f);
    const float cz = fminf(fmaxf(floorf(zs), 0.0f), resf - 1.0f);
    ux = __fsub_rn(xs, cx);
    uy = __fsub_rn(ys, cy);
    uz = __fsub_rn(zs, cz);
    const uint32_t ix = (uint32_t)cx, iy = (uint32_t)cy, iz = (uint32_t)cz;
    const uint32_t r = (uint32_t)res;
    if ((uint64_t)r * r * r <= (uint64_t)T) return (ix * r + iy) * r + iz;
    return (ix ^ (iy * 2654435761u) ^ (iz * 805459861u)) & (uint32_t)(T - 1);
}

// The weights of the two corners a lane owns: corner A = 2j (dx = 0) and
// corner B = 2j + 1 (dx = 1), both with dy = j & 1, dz = j >> 1.
struct Chains {
    float wA, wB, dxA, dxB, dyA, dyB, dzA, dzB;
};

__device__ __forceinline__ Chains corner_chains(int j, float ux, float uy, float uz) {
    const bool dy = j & 1, dz = j >> 1;
    const float fy = dy ? uy : 1.0f - uy;
    const float fz = dz ? uz : 1.0f - uz;
    const float sy = dy ? 1.0f : -1.0f;
    const float sz = dz ? 1.0f : -1.0f;
    const float fxA = 1.0f - ux, fxB = ux;
    Chains c;
    c.wA = (fxA * fy) * fz;
    c.wB = (fxB * fy) * fz;
    c.dxB = fy * fz;
    c.dxA = -c.dxB;
    c.dyA = (fxA * sy) * fz;
    c.dyB = (fxB * sy) * fz;
    c.dzA = (fxA * fy) * sz;
    c.dzB = (fxB * fy) * sz;
    return c;
}

// Keep one half of a pair of values and add the partner lane's copy of it.
__device__ __forceinline__ float swap_add(float lo, float hi, bool keep_hi, int lane_mask) {
    const float send = keep_hi ? lo : hi;
    const float recv = __shfl_xor_sync(0xffffffffu, send, lane_mask);
    return (keep_hi ? hi : lo) + recv;
}

__global__ void __launch_bounds__(THREADS)
hashgrid_cell_fwd_kernel(const float* __restrict__ tables, const float* __restrict__ x,
                         float* __restrict__ feats, float* __restrict__ dfeats,
                         long long N, int L, int T, Levels lv) {
    const int j = threadIdx.x & 3;         // quarter of the row
    const int q = (threadIdx.x >> 2) & 7;  // quad in the warp: level within a round of 8
    const long long n = (long long)blockIdx.x * POINTS_PER_BLOCK + (threadIdx.x >> 5);
    if (n >= N) return;  // the whole warp
    const float px = x[3 * n], py = x[3 * n + 1], pz = x[3 * n + 2];
    const bool b0 = j & 1, b1 = j >> 1;

    for (int l0 = 0; l0 < L; l0 += 8) {
        const bool live = l0 + q < L;
        const int l = live ? l0 + q : L - 1;  // stays in the warp for the shuffles
        const int res = lv.res[l];
        float ux, uy, uz;
        const uint32_t row = cell_row(px, py, pz, res, T, ux, uy, uz);
        const float4 r = __ldg(reinterpret_cast<const float4*>(
            tables + ((size_t)l * T + row) * 16 + 4 * j));
        const Chains c = corner_chains(j, ux, uy, uz);
        // this lane's part of [f0, f1, d(f0)/dx,dy,dz, d(f1)/dx,dy,dz]
        const float o0 = c.wA * r.x + c.wB * r.z;
        const float o1 = c.wA * r.y + c.wB * r.w;
        if (dfeats == nullptr) {
            float f0 = o0 + __shfl_xor_sync(0xffffffffu, o0, 1);
            float f1 = o1 + __shfl_xor_sync(0xffffffffu, o1, 1);
            f0 += __shfl_xor_sync(0xffffffffu, f0, 2);
            f1 += __shfl_xor_sync(0xffffffffu, f1, 2);
            if (live && j == 0)
                *reinterpret_cast<float2*>(feats + (size_t)n * 2 * L + 2 * l) = make_float2(f0, f1);
            continue;
        }
        const float o2 = c.dxA * r.x + c.dxB * r.z;
        const float o3 = c.dyA * r.x + c.dyB * r.z;
        const float o4 = c.dzA * r.x + c.dzB * r.z;
        const float o5 = c.dxA * r.y + c.dxB * r.w;
        const float o6 = c.dyA * r.y + c.dyB * r.w;
        const float o7 = c.dzA * r.y + c.dzB * r.w;
        // reduce-scatter over the four lanes: bit 0 picks o0..o3 / o4..o7,
        // bit 1 the first / second pair of those
        const float a0 = swap_add(o0, o4, b0, 1);
        const float a1 = swap_add(o1, o5, b0, 1);
        const float a2 = swap_add(o2, o6, b0, 1);
        const float a3 = swap_add(o3, o7, b0, 1);
        const float v0 = swap_add(a0, a2, b1, 2);
        const float v1 = swap_add(a1, a3, b1, 2);
        // lane 0: (o0,o1)  lane 2: (o2,o3)  lane 1: (o4,o5)  lane 3: (o6,o7)
        if (!live) continue;
        if (j == 0) {
            *reinterpret_cast<float2*>(feats + (size_t)n * 2 * L + 2 * l) = make_float2(v0, v1);
        } else {
            const float resf = (float)res;
            const int pair = j == 2 ? 0 : (j == 1 ? 1 : 2);
            *reinterpret_cast<float2*>(dfeats + ((size_t)n * 2 * L + 2 * l) * 3 + 2 * pair) =
                make_float2(v0 * resf, v1 * resf);
        }
    }
}

__device__ __forceinline__ void atomic_add4(float* p, float4 v) {
#if __CUDA_ARCH__ >= 900
    atomicAdd(reinterpret_cast<float4*>(p), v);
#else
    atomicAdd(p, v.x);
    atomicAdd(p + 1, v.y);
    atomicAdd(p + 2, v.z);
    atomicAdd(p + 3, v.w);
#endif
}

__global__ void __launch_bounds__(THREADS)
hashgrid_cell_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g_feats,
                         const float* __restrict__ g_dfeats, float* __restrict__ d_tables,
                         long long N, int L, int T, Levels lv) {
    const int j = threadIdx.x & 3;
    const int q = (threadIdx.x >> 2) & 7;
    const long long n = (long long)blockIdx.x * POINTS_PER_BLOCK + (threadIdx.x >> 5);
    if (n >= N) return;
    const float px = x[3 * n], py = x[3 * n + 1], pz = x[3 * n + 2];

    for (int l = q; l < L; l += 8) {
        const int res = lv.res[l];
        const float resf = (float)res;
        float ux, uy, uz;
        const uint32_t row = cell_row(px, py, pz, res, T, ux, uy, uz);
        const Chains c = corner_chains(j, ux, uy, uz);
        float2 gf = make_float2(0.0f, 0.0f);
        float2 g0 = gf, g1 = gf, g2 = gf;  // g_d[f0] = (g0.x, g0.y, g1.x), g_d[f1] = (g1.y, g2.x, g2.y)
        if (g_feats != nullptr)
            gf = __ldg(reinterpret_cast<const float2*>(g_feats + (size_t)n * 2 * L + 2 * l));
        if (g_dfeats != nullptr) {
            const float2* gd = reinterpret_cast<const float2*>(
                g_dfeats + ((size_t)n * 2 * L + 2 * l) * 3);
            g0 = __ldg(gd);
            g1 = __ldg(gd + 1);
            g2 = __ldg(gd + 2);
        }
        float4 v;  // the row's slots 4j..4j+3: (A,f0) (A,f1) (B,f0) (B,f1)
        v.x = c.wA * gf.x + resf * (c.dxA * g0.x + c.dyA * g0.y + c.dzA * g1.x);
        v.y = c.wA * gf.y + resf * (c.dxA * g1.y + c.dyA * g2.x + c.dzA * g2.y);
        v.z = c.wB * gf.x + resf * (c.dxB * g0.x + c.dyB * g0.y + c.dzB * g1.x);
        v.w = c.wB * gf.y + resf * (c.dxB * g1.y + c.dyB * g2.x + c.dzB * g2.y);
        if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
            atomic_add4(d_tables + ((size_t)l * T + row) * 16 + 4 * j, v);
    }
}

static int launch_grid(long long N, dim3& grid) {
    const long long blocks = (N + POINTS_PER_BLOCK - 1) / POINTS_PER_BLOCK;
    if (N <= 0 || blocks > 2147483647LL) return 1;
    grid = dim3((unsigned)blocks);
    return 0;
}

extern "C" int hashgrid_cell_fwd(const float* tables, const float* x, float* feats, float* dfeats,
                                 long long N, int L, int T, Levels lv, void* stream) {
    dim3 grid;
    if (L < 1 || L > MAX_LEVELS || T < 1 || (T & (T - 1)) || launch_grid(N, grid))
        return (int)cudaErrorInvalidValue;
    hashgrid_cell_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        tables, x, feats, dfeats, N, L, T, lv);
    return (int)cudaGetLastError();
}

extern "C" int hashgrid_cell_bwd(const float* x, const float* g_feats, const float* g_dfeats,
                                 float* d_tables, long long N, int L, int T, Levels lv,
                                 void* stream) {
    dim3 grid;
    if (L < 1 || L > MAX_LEVELS || T < 1 || (T & (T - 1)) || launch_grid(N, grid))
        return (int)cudaErrorInvalidValue;
    hashgrid_cell_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        x, g_feats, g_dfeats, d_tables, N, L, T, lv);
    return (int)cudaGetLastError();
}
