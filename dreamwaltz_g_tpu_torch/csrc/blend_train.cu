// Tile-table Gaussian blend of the training step, forward and backward, and
// its forward-only twin, for sm_90a.
//
// Replaces, in dreamwaltz_g_tpu/ops/pallas_blend.py:
//   * _make_fwd_train_kernel (called by blend_tiles_pallas_train) with
//     blend_train_fwd_f32 (B1 forward);
//   * _make_bwd_train_kernel (same wrapper) with blend_train_bwd_f32 (B1
//     backward);
//   * _make_kernel (called by blend_tiles_pallas) with blend_tiles_eval_f32
//     (B3): the forward kernel with the saved-state writes compiled out.
//
// Function: view b, tile t composites the Gaussians
// tile_lists[b, t, 0 : tile_counts[b, t]] front to back over its
// tile_size^2 pixels; per pixel out = sum_j T_j w_j v_j with
// w = op * exp(-q / 2) (q the conic form at the pixel centre), an entry
// skipped unless q >= 0 and w >= min_alpha, w clipped to alpha_clip, and
// T_j = prod_{i<j} (1 - w_i). Packed row per Gaussian, 16 floats (64 B):
//   [mx, my, ca, cb, cc, op, 0, 0, v0 .. v7]     (row N is all zero)
//
// Design: the 3DGS rasterizer's forward and backward, not the TPU block
// structure (chunked matmul prefixes, lane-transposed panels, a suffix
// carried in scratch across a sequential grid).
// * One block per (tile, view), one thread per pixel. The block gathers the
//   rows of its list into shared memory in batches through tile_lists, so
//   no (T, K, 16) panel array is materialised; the (N + 1, 16) table
//   (13 MB for 200k Gaussians) stays in the 50 MB L2.
// * Forward: running float32 transmittance; a pixel stops once T <= t_eps
//   (exp(-9.2), the TPU kernel's threshold) after blending the entry that
//   took it there, and the block leaves when __syncthreads_count says every
//   pixel has stopped. For the backward it keeps, per pixel, the final T
//   and the number of entries it walked (the 3DGS choice, not the TPU's
//   per-chunk log-T checkpoint): 8 bytes a pixel.
// * Backward: the block walks its entries back to front from the largest
//   walked count. Each pixel recovers T_j = T_{j+1} / (1 - w_j) with the
//   same rounded (1 - w_j) the forward multiplied by, keeps the suffix
//   S = sum_{j' > j} G_j' contrib_j' in a register, and forms
//   dw = G T - S / max(1 - w, 1e-6), zero outside
//   active = (q >= 0) & (w_raw >= min_alpha) & (w_raw <= alpha_clip),
//   chained to d(mx, my, ca, cb, cc, op) exactly as the TPU kernel does, and
//   dvals = contrib * g. The per-entry sums over the tile's pixels are a
//   warp-shuffle reduction (skipped for a warp none of whose pixels the
//   entry reaches) and a shared-memory pass across the warps, written to a
//   (B, T, K, 16) per-entry gradient panel in the packed-row lane layout;
//   slots the walk never reached are written as zeros. Each sum runs in a
//   fixed order, so the panel is deterministic. The wrapper sums the panel
//   into per-Gaussian gradients with index_add_ over tile_lists.
//
// Differences from the TPU kernels, by design: those keep log T, stop per
// TILE at 128-entry chunk boundaries and carry the backward's suffix across
// chunks; these multiply T in float32 and stop per PIXEL. What the TPU
// kernel still adds after a pixel's T drops below t_eps is at most
// t_eps * |value|. q and w are evaluated with explicit round-to-nearest
// multiplies and adds (no FMA contraction) in the plain PyTorch version's
// operation order, so that the min_alpha and q >= 0 tests decide alike.
//
// What bounds them on the H100: the bytes are small (the packed table, 4 B
// of list per entry, the 32 B-per-pixel output, the 8 B-per-pixel state
// and, backward, the 32 B-per-pixel upstream gradient and the 64 B-per-entry
// panel), so the bound is the per (pixel, entry) float work: 13 operations
// with one exp for every pair a pixel reaches, about 20 more for a blended
// pair forward and about 45 more backward, plus the backward's 14 sums over
// the tile's pixels. The design keeps that work on the FP32 pipes by
// sharing each batch of rows through shared memory (one gather per row per
// tile, broadcast to every thread), by testing min_alpha before touching the
// value lanes, by the per-pixel and per-block early exit, and by skipping
// the shuffle reduction in warps an entry does not reach.

#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 256;     // forward: rows per shared-memory batch (16 KB)
constexpr int kBwdBatch = 16;   // backward: entries per batch
constexpr int kMaxWarps = 32;   // 1024 threads
constexpr unsigned kFull = 0xffffffffu;

struct Weight {
  float dx, dy, q, w;  // w is the raw weight op * exp(-q / 2)
};

__device__ __forceinline__ Weight weight(const float4 a0, const float4 a1,
                                         float px, float py) {
  Weight r;
  r.dx = px - a0.x;
  r.dy = py - a0.y;
  r.q = __fadd_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(a0.z, r.dx), r.dx),
                __fmul_rn(__fmul_rn(__fmul_rn(2.0f, a0.w), r.dx), r.dy)),
      __fmul_rn(__fmul_rn(a1.x, r.dy), r.dy));
  r.w = __fmul_rn(a1.y, expf(__fmul_rn(-0.5f, r.q)));
  return r;
}

// Load rows list[lo .. lo + n) of the view's table into rows[0 .. 4n).
__device__ __forceinline__ void load_rows(float4* rows, const float4* table,
                                          const int* list, int lo, int n) {
  for (int k = threadIdx.x; k < n * 4; k += blockDim.x) {
    const int g = list[lo + (k >> 2)];
    rows[k] = table[(size_t)g * 4 + (k & 3)];
  }
}

template <bool kTrain>
__global__ void __launch_bounds__(1024)
blend_fwd_kernel(const float4* __restrict__ packed,
                 const int* __restrict__ tile_lists,
                 const int* __restrict__ tile_counts,
                 float4* __restrict__ out, float* __restrict__ t_final,
                 int* __restrict__ n_last, int n_tiles, int K, int n_rows,
                 int tiles_x, int tile_size, float alpha_clip,
                 float min_alpha, float t_eps) {
  __shared__ float4 rows[kBatch * 4];
  const int t = blockIdx.x;
  const size_t bt = (size_t)blockIdx.y * n_tiles + t;
  const int P = blockDim.x;
  const int pid = threadIdx.x;
  const int* list = tile_lists + bt * K;
  const int count = tile_counts[bt];
  const float4* table = packed + (size_t)blockIdx.y * n_rows * 4;
  const float px = (float)((t % tiles_x) * tile_size + pid % tile_size) + 0.5f;
  const float py = (float)((t / tiles_x) * tile_size + pid / tile_size) + 0.5f;

  float T = 1.0f;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int done = 0;
  int walked = count;

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    const int n = min(kBatch, count - b0);
    load_rows(rows, table, list, b0, n);
    __syncthreads();
    if (!done) {
      for (int j = 0; j < n; ++j) {
        const Weight g = weight(rows[4 * j], rows[4 * j + 1], px, py);
        if (!(g.q >= 0.0f && g.w >= min_alpha)) continue;
        const float w = fminf(g.w, alpha_clip);
        const float4 v0 = rows[4 * j + 2];
        const float4 v1 = rows[4 * j + 3];
        const float c = T * w;
        acc[0] += c * v0.x; acc[1] += c * v0.y;
        acc[2] += c * v0.z; acc[3] += c * v0.w;
        acc[4] += c * v1.x; acc[5] += c * v1.y;
        acc[6] += c * v1.z; acc[7] += c * v1.w;
        T = __fmul_rn(T, __fsub_rn(1.0f, w));
        if (T <= t_eps) {
          done = 1;
          walked = b0 + j + 1;
          break;
        }
      }
    }
    // barrier before the next batch overwrites `rows`, and the block exit
    if (__syncthreads_count(done) == P) break;
  }

  const size_t p = bt * P + pid;
  out[2 * p] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  out[2 * p + 1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  if (kTrain) {
    t_final[p] = T;
    n_last[p] = walked;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__global__ void __launch_bounds__(1024)
blend_bwd_kernel(const float4* __restrict__ packed,
                 const int* __restrict__ tile_lists,
                 const int* __restrict__ tile_counts,
                 const float* __restrict__ t_final,
                 const int* __restrict__ n_last,
                 const float4* __restrict__ g_out,
                 float* __restrict__ d_panels, int n_tiles, int K,
                 int n_rows, int tiles_x, int tile_size, float alpha_clip,
                 float min_alpha) {
  __shared__ float4 rows[kBwdBatch * 4];
  __shared__ float part[kMaxWarps][kBwdBatch][16];
  __shared__ int s_walk;
  const int t = blockIdx.x;
  const size_t bt = (size_t)blockIdx.y * n_tiles + t;
  const int P = blockDim.x;
  const int pid = threadIdx.x;
  const int lane = pid & 31;
  const int warp = pid >> 5;
  const int n_warps = P >> 5;
  const int* list = tile_lists + bt * K;
  const float4* table = packed + (size_t)blockIdx.y * n_rows * 4;
  float* dp = d_panels + bt * K * 16;
  const float px = (float)((t % tiles_x) * tile_size + pid % tile_size) + 0.5f;
  const float py = (float)((t / tiles_x) * tile_size + pid / tile_size) + 0.5f;

  const size_t p = bt * P + pid;
  const int walked = n_last[p];
  float T = t_final[p];
  const float4 g0 = g_out[2 * p];
  const float4 g1 = g_out[2 * p + 1];
  float S = 0.0f;

  if (pid == 0) s_walk = 0;
  __syncthreads();
  atomicMax(&s_walk, walked);
  __syncthreads();
  const int top = s_walk;
  (void)tile_counts;  // the walk never passes the count; slots past it are 0
  for (int i = top * 16 + pid; i < K * 16; i += P) dp[i] = 0.0f;

  for (int hi = top; hi > 0; hi -= kBwdBatch) {
    const int lo = max(0, hi - kBwdBatch);
    const int n = hi - lo;
    load_rows(rows, table, list, lo, n);
    __syncthreads();
    for (int jj = n - 1; jj >= 0; --jj) {
      float d[14];
#pragma unroll
      for (int c = 0; c < 14; ++c) d[c] = 0.0f;
      bool reached = false;
      if (lo + jj < walked) {
        const float4 a0 = rows[4 * jj];
        const float4 a1 = rows[4 * jj + 1];
        const Weight g = weight(a0, a1, px, py);
        if (g.q >= 0.0f && g.w >= min_alpha) {
          reached = true;
          const float w = fminf(g.w, alpha_clip);
          const float one_m_w = __fsub_rn(1.0f, w);
          T = T / one_m_w;                      // T entering entry j
          const float contrib = T * w;
          const float4 v0 = rows[4 * jj + 2];
          const float4 v1 = rows[4 * jj + 3];
          const float G = g0.x * v0.x + g0.y * v0.y + g0.z * v0.z +
                          g0.w * v0.w + g1.x * v1.x + g1.y * v1.y +
                          g1.z * v1.z + g1.w * v1.w;
          float dw = G * T - S / fmaxf(one_m_w, 1e-6f);
          if (!(g.w <= alpha_clip)) dw = 0.0f;  // clipped: no gradient
          const float dq = dw * w * (-0.5f);
          const float op = a1.y;
          const float dqdx = 2.0f * a0.z * g.dx + 2.0f * a0.w * g.dy;
          const float dqdy = 2.0f * a1.x * g.dy + 2.0f * a0.w * g.dx;
          d[0] = -dq * dqdx;
          d[1] = -dq * dqdy;
          d[2] = dq * g.dx * g.dx;
          d[3] = dq * 2.0f * g.dx * g.dy;
          d[4] = dq * g.dy * g.dy;
          d[5] = op > 0.0f ? dw * w / fmaxf(op, 1e-12f) : 0.0f;
          d[6] = contrib * g0.x; d[7] = contrib * g0.y;
          d[8] = contrib * g0.z; d[9] = contrib * g0.w;
          d[10] = contrib * g1.x; d[11] = contrib * g1.y;
          d[12] = contrib * g1.z; d[13] = contrib * g1.w;
          S += G * contrib;
        }
      }
      // per-warp sums; a warp none of whose pixels the entry reaches writes
      // zeros without shuffling
      if (__any_sync(kFull, reached)) {
#pragma unroll
        for (int c = 0; c < 14; ++c) d[c] = warp_sum(d[c]);
      }
      if (lane == 0) {
        float* dst = part[warp][jj];
#pragma unroll
        for (int c = 0; c < 6; ++c) dst[c] = d[c];
        dst[6] = 0.0f;
        dst[7] = 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) dst[8 + c] = d[6 + c];
      }
    }
    __syncthreads();
    // sum across warps in warp order and write the batch's panel rows
    for (int i = pid; i < n * 16; i += P) {
      const int e = i >> 4;
      const int c = i & 15;
      float s = 0.0f;
      for (int w = 0; w < n_warps; ++w) s += part[w][e][c];
      dp[(size_t)(lo + e) * 16 + c] = s;
    }
    __syncthreads();  // before the next batch overwrites rows and part
  }
}

}  // namespace

// Launch on `stream`: one block of tile_size^2 threads per (tile, view).
// Each returns the cudaGetLastError() code of its launch (0 on success).
extern "C" int blend_train_fwd_f32(const float* packed, const int* tile_lists,
                                   const int* tile_counts, float* out,
                                   float* t_final, int* n_last, int n_views,
                                   int n_tiles, int K, int n_rows,
                                   int tiles_x, int tile_size,
                                   float alpha_clip, float min_alpha,
                                   float t_eps, void* stream) {
  const int P = tile_size * tile_size;
  if (n_tiles > 0 && n_views > 0) {
    blend_fwd_kernel<true><<<dim3(n_tiles, n_views), P, 0,
                             (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(packed), tile_lists, tile_counts,
        reinterpret_cast<float4*>(out), t_final, n_last, n_tiles, K, n_rows,
        tiles_x, tile_size, alpha_clip, min_alpha, t_eps);
  }
  return (int)cudaGetLastError();
}

extern "C" int blend_tiles_eval_f32(const float* packed, const int* tile_lists,
                                    const int* tile_counts, float* out,
                                    int n_views, int n_tiles, int K,
                                    int n_rows, int tiles_x, int tile_size,
                                    float alpha_clip, float min_alpha,
                                    float t_eps, void* stream) {
  const int P = tile_size * tile_size;
  if (n_tiles > 0 && n_views > 0) {
    blend_fwd_kernel<false><<<dim3(n_tiles, n_views), P, 0,
                              (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(packed), tile_lists, tile_counts,
        reinterpret_cast<float4*>(out), nullptr, nullptr, n_tiles, K, n_rows,
        tiles_x, tile_size, alpha_clip, min_alpha, t_eps);
  }
  return (int)cudaGetLastError();
}

extern "C" int blend_train_bwd_f32(const float* packed, const int* tile_lists,
                                   const int* tile_counts,
                                   const float* t_final, const int* n_last,
                                   const float* g_out, float* d_panels,
                                   int n_views, int n_tiles, int K,
                                   int n_rows, int tiles_x, int tile_size,
                                   float alpha_clip, float min_alpha,
                                   void* stream) {
  const int P = tile_size * tile_size;
  if (n_tiles > 0 && n_views > 0) {
    blend_bwd_kernel<<<dim3(n_tiles, n_views), P, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(packed), tile_lists, tile_counts,
        t_final, n_last, reinterpret_cast<const float4*>(g_out), d_panels,
        n_tiles, K, n_rows, tiles_x, tile_size, alpha_clip, min_alpha);
  }
  return (int)cudaGetLastError();
}
