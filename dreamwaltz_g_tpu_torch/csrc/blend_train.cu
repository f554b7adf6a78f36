// Tile-table Gaussian blend of the training step, forward and backward, and
// its forward-only twin, for sm_90a.
//
// Replaces, in dreamwaltz_g_tpu/ops/pallas_blend.py:
//   * _make_fwd_train_kernel (:421, called by blend_tiles_pallas_train :579,
//     pallas_call :654) with blend_train_fwd_f32 (B1 forward);
//   * _make_bwd_train_kernel (:483, same wrapper, pallas_call :694) with
//     blend_train_bwd_f32 (B1 backward);
//   * _make_kernel (:58, called by blend_tiles_pallas :126, pallas_call
//     :180) with blend_tiles_eval_f32 (B3): the forward kernel with the
//     saved-state writes compiled out.
//
// Function: view b, tile t composites the Gaussians
// tile_lists[b, t, 0 : tile_counts[b, t]] front to back over its
// tile_size^2 pixels; per pixel out = sum_j T_j w_j v_j with
// w = op * exp(-q / 2) (q the conic form at the pixel centre), an entry
// skipped unless q >= 0 and w >= min_alpha, w clipped to alpha_clip, and
// T_j = prod_{i<j} (1 - w_i). Packed row per Gaussian, 16 floats (64 B):
//   [mx, my, ca, cb, cc, op, 0, 0, v0 .. v7]     (row N is all zero)
//
// Forward (B1 forward, B3): the 3DGS forward, not the TPU block structure
// (chunked matmul prefixes, lane-transposed panels), on B2's design
// (blend_sorted.cu) and with B2's walk, blend::forward_walk in
// blend_common.cuh: the three forward blends differ only in where an
// entry's row index comes from (here tile_lists[b, t, i]), the table's view
// offset (view b reads rows b * n_rows ..) and whether the state is saved.
// What bounds it on the H100 is what bounds B2: the bytes are small (the
// packed rows the lists reference, 4 B of list an entry, the 32 B-per-pixel
// output and, for B1, the 8 B-per-pixel state), and so is the float work
// once the cull drops the pairs min_alpha rejects (on the step's 512^2
// frame a pixel reaches ~92% of its tile's entries, its patch keeps ~12%
// of those, and it blends ~2.4%); the heaviest tiles' walks set the time.
// * Sub-tile blocks: a block covers 8 rows of a (tile, view) (a 32 x 8
//   strip of 256 threads, 4 blocks a tile at tile_size 32, over a
//   dim3(n_tiles * 4, n_views) grid), so a heavy tile spreads over several
//   SMs; each gathers the rows of its list itself (the (N + 1, 16) table,
//   13 MB for 200k Gaussians, stays in the 50 MB L2; no (T, K) panel array
//   is materialised) and leaves once all its pixels have stopped.
// * A warp owns an 8 x 4 pixel patch and skips every entry whose footprint
//   box misses the patch: a skipped pair is one the plain test rejects, so
//   each pixel's arithmetic and order are unchanged and B1 forward's out
//   equals B3's, and B2's image, to every bit.
// * Rows arrive through a double-buffered cp.async ring, one barrier a
//   batch.
// * The saved state (B1 forward), per pixel in the tile's row-major order:
//   the final T (T = T (1 - w), each rounded once, as the backward's
//   recovery undoes it) and n_last, the list index + 1 of the entry that
//   took T to t_eps = exp(-9.2) or below (the TPU kernel's threshold), or
//   the tile's count where none did; a culled entry never blends, so never
//   stops a pixel. 8 bytes a pixel; the TPU kernel keeps a per-chunk log-T
//   checkpoint instead.
//
// Backward (B1 backward). Per pixel it walks its entries back to front,
// recovers T_j = T_{j+1} / (1 - w_j) with the same rounded (1 - w_j) the
// forward multiplied by, keeps the suffix S = sum_{j' > j} G_j' contrib_j' in
// a register, and forms dw = G T - S / max(1 - w, 1e-6), zero outside
// active = (q >= 0) & (w_raw >= min_alpha) & (w_raw <= alpha_clip), chained
// to d(mx, my, ca, cb, cc, op) exactly as the TPU kernel does, and
// dvals = contrib * g. Each entry's 14 sums over the tile's pixels form a
// (B, T, K, 16) per-entry gradient panel in the packed-row lane layout,
// which the wrapper sums into per-Gaussian gradients with index_add_ over
// tile_lists.
//
// What bounds the backward on the H100: the bytes are small (the packed
// rows, 4 B of list per entry, the 8 B-per-pixel state, the 32 B-per-pixel
// upstream gradient and the 64 B-per-entry panel), and so is the float
// work the function needs: 13 operations with one exp for each pair a
// pixel reaches and its patch keeps, ~58 more for a blended pair, and a
// float64 box a block per entry (chip_smoke.py counts that work for the
// bound). On the step's 512^2 frame a pixel reaches ~92% of its tile's
// entries, the cull keeps ~12% of them and a pixel blends ~2.4%; dozens of
// tiles hold the full 1024 entries. So the work a kernel wastes -- pairs
// min_alpha rejects, sums over warps no pixel of which an entry touches,
// block barriers, and the heaviest tiles' blocks on one SM -- sets its time,
// not the blends.
// The design (blend_common.cuh has the patch map and the cull's proof):
// * Sub-tile blocks: a block covers 8 rows of the tile (a 32 x 8 strip
//   of 256 threads, 4 blocks a tile at tile_size 32), so a
//   heavy tile spreads over several SMs. Each block gathers the tile's rows
//   itself and walks from its own largest walked count. The blocks take the
//   tiles heaviest first (blend_bwd_order_kernel ranks them by count), so a
//   full tile does not start in the grid's last wave.
// * A warp owns an 8 x 4 pixel patch and skips every entry whose footprint
//   box misses the patch's pixel centres: no evaluation and no reduction.
//   A skipped pair is one the plain test rejects, so the per-pixel
//   arithmetic is unchanged. A batch is 32 entries: each lane tests one
//   entry's box, and the warp walks the ballot's set bits back to front.
// * One multi-value reduce-scatter per reached entry: five shuffle rounds
//   halve the 16 lanes' values (8 + 4 + 2 + 1 + 1 shuffles against 70 for
//   14 warp_sums), after which lane 2c holds channel c of the warp's sum and
//   16 lanes store it with one instruction. A warp none of whose pixels
//   the entry reaches skips it and clears its bit in the batch's mask.
// * A heavy tile's warp walks up to ~900 kept entries one after another
//   (the step's avatar frame), so the length of that walk in instructions,
//   not the card's total work, sets the kernel's time. Every division is
//   correctly rounded, as in the plain version: T_j = T_{j+1} / (1 - w_j)
//   undoes the forward's product.
// * Rows arrive through 16-byte cp.async copies, double-buffered, issued and
//   boxed by one warp a batch (in turn); the cross-warp partials
//   [2][warps][32][16] are double-buffered too, so a batch costs one block
//   barrier. The pass that sums a batch's partials over the warps (in warp
//   order, those whose mask bit is set) runs one batch later.
// * The sub-tile blocks' sums meet in a fixed order: each block writes its
//   rows of a (B, T, S, K, 16) float32 scratch up to its walk length, and
//   the walk length beside it; blend_bwd_sum_kernel adds the S partials in
//   strip order, a slot past a block's length counting as zero, and writes
//   the panel (zeros past the tile's largest length). So the panel is
//   deterministic. (A cluster summing through distributed shared memory
//   would tie the blocks of a tile to one another's walk.)
//
// Differences from the TPU kernels, by design: those keep log T, stop per
// TILE at 128-entry chunk boundaries and carry the backward's suffix across
// chunks; these multiply T in float32 and stop per PIXEL. What the TPU
// kernel still adds after a pixel's T drops below t_eps is at most
// t_eps * |value|. q and w are evaluated with explicit round-to-nearest
// multiplies and adds (no FMA contraction) in the plain PyTorch version's
// operation order, so that the min_alpha and q >= 0 tests decide alike.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using blend::kFull;

constexpr int kBwdBatch = 32;   // backward: entries per batch, one a lane

// B1 forward (kTrain) and B3: S = tile_size / 8 blocks a (tile, view),
// blockIdx.y the view.
template <bool kTrain>
__global__ void __launch_bounds__(blend::kMaxThreads)
blend_fwd_kernel(const float4* __restrict__ packed,
                 const int* __restrict__ tile_lists,
                 const int* __restrict__ tile_counts,
                 float4* __restrict__ out, float* __restrict__ t_final,
                 int* __restrict__ n_last, int n_tiles, int K, int n_rows,
                 int tiles_x, int tile_size, float alpha_clip,
                 float min_alpha, float t_eps) {
  const int S = tile_size / blend::kBlockRows;
  const int t = blockIdx.x / S;
  const size_t bt = (size_t)blockIdx.y * n_tiles + t;
  const blend::Patch pt =
      blend::patch_of(t, blockIdx.x % S, tiles_x, tile_size);
  blend::forward_walk<kTrain>(
      packed + (size_t)blockIdx.y * n_rows * 4, tile_lists + bt * K,
      tile_counts[bt], pt, bt * tile_size * tile_size + pt.pid, alpha_clip,
      min_alpha, t_eps, out, t_final, n_last);
}

// The 16 lanes of v summed over the warp: after five shuffle rounds that
// each halve the values a lane carries, lanes 2c and 2c + 1 hold channel c.
// Fixed order, so deterministic.
__device__ __forceinline__ float reduce_scatter16(const float (&v)[16],
                                                  int lane) {
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4, h1 = lane & 2;
  float a[8], b[4], c[2];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i] = (h4 ? v[i + 8] : v[i]) +
           __shfl_xor_sync(kFull, h4 ? v[i] : v[i + 8], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = (h3 ? a[i + 4] : a[i]) +
           __shfl_xor_sync(kFull, h3 ? a[i] : a[i + 4], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (h2 ? b[i + 2] : b[i]) +
           __shfl_xor_sync(kFull, h2 ? b[i] : b[i + 2], 4);
  const float e = (h1 ? c[1] : c[0]) +
                  __shfl_xor_sync(kFull, h1 ? c[0] : c[1], 2);
  return e + __shfl_xor_sync(kFull, e, 1);
}

// dynamic shared memory of blend_bwd_kernel: rows and boxes of two batches,
// and two batches of cross-warp partials
constexpr size_t bwd_smem(int warps) {
  return sizeof(float4) * 2 * kBwdBatch * 5 +
         sizeof(float) * 2 * (size_t)warps * kBwdBatch * 16;
}

// order[b, r] = the tile of view b with the r-th largest count (ties in
// tile order): blend_bwd_kernel takes the heaviest tiles first, so that they
// do not start in the grid's last wave. One block a view.
__global__ void __launch_bounds__(256)
blend_bwd_order_kernel(const int* __restrict__ tile_counts,
                       int* __restrict__ order, int n_tiles) {
  const int* c = tile_counts + (size_t)blockIdx.x * n_tiles;
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    const int ct = c[t];
    int rank = 0;
    for (int u = 0; u < n_tiles; ++u) {
      const int cu = c[u];
      rank += cu > ct || (cu == ct && u < t);
    }
    order[(size_t)blockIdx.x * n_tiles + rank] = t;
  }
}

__global__ void __launch_bounds__(blend::kMaxThreads)
blend_bwd_kernel(const float4* __restrict__ packed,
                 const int* __restrict__ tile_lists,
                 const int* __restrict__ order,
                 const float* __restrict__ t_final,
                 const int* __restrict__ n_last,
                 const float4* __restrict__ g_out,
                 float* __restrict__ parts, int* __restrict__ lens,
                 int n_tiles, int K, int n_rows, int tiles_x, int tile_size,
                 float alpha_clip, float min_alpha) {
  extern __shared__ float4 smem[];
  float4(*rows)[kBwdBatch * 4] =
      reinterpret_cast<float4(*)[kBwdBatch * 4]>(smem);
  float4(*boxes)[kBwdBatch] =
      reinterpret_cast<float4(*)[kBwdBatch]>(smem + 2 * kBwdBatch * 4);
  float* part = reinterpret_cast<float*>(smem + 2 * kBwdBatch * 5);
  __shared__ unsigned wmask[2][32];
  __shared__ int s_top;

  const int S = tile_size / blend::kBlockRows;
  const int t = order[(size_t)blockIdx.y * n_tiles + blockIdx.x / S];
  const int strip = blockIdx.x % S;
  const size_t bt = (size_t)blockIdx.y * n_tiles + t;
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nthr >> 5;
  const int* list = tile_lists + bt * K;
  const float4* table = packed + (size_t)blockIdx.y * n_rows * 4;
  float* dst = parts + (bt * S + strip) * (size_t)K * 16;
  const blend::Patch pt =
      blend::patch_of(t, strip, tiles_x, tile_size);

  const size_t p = bt * tile_size * tile_size + pt.pid;
  const int walked = n_last[p];
  float T = t_final[p];
  const float4 g0 = g_out[2 * p];
  const float4 g1 = g_out[2 * p + 1];
  float S_sum = 0.0f;

  if (tid == 0) s_top = 0;
  __syncthreads();
  const int wmax = __reduce_max_sync(kFull, walked);
  if (lane == 0) atomicMax(&s_top, wmax);
  __syncthreads();
  const int top = s_top;  // this block's walk: its pixels' largest count

  // batch i covers list slots [lo(i), top - 32 i); warp i % n_warps copies
  // its rows (lane j slot lo(i) + j) and computes their boxes
  auto lo_of = [&](int i) { return max(0, top - kBwdBatch * (i + 1)); };
  auto index_at = [&](int i) {
    const int lo = lo_of(i);
    return warp == i % n_warps && lo + lane < top - kBwdBatch * i
               ? list[lo + lane] : -1;
  };
  auto issue = [&](int row, int buf) {
    if (row >= 0) {
      const float4* src = table + (size_t)row * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        blend::cp_async16(&rows[buf][4 * lane + c], src + c);
    }
    blend::cp_async_commit();
  };
  auto box = [&](int row, int buf) {
    blend::cp_async_wait_all();
    if (row >= 0)
      boxes[buf][lane] = blend::footprint_box(
          rows[buf][4 * lane], rows[buf][4 * lane + 1], min_alpha);
  };
  // batch i's sums over the warps, in warp order, into this block's rows of
  // the scratch
  auto write_batch = [&](int i) {
    const int lo = lo_of(i), n = top - kBwdBatch * i - lo, buf = i & 1;
    const float* pb = part + (size_t)buf * n_warps * kBwdBatch * 16;
    for (int k = tid; k < n * 16; k += nthr) {
      const int e = k >> 4;
      float s = 0.0f;
      for (int w = 0; w < n_warps; ++w)
        if ((wmask[buf][w] >> e) & 1u) s += pb[(w * kBwdBatch + e) * 16 +
                                               (k & 15)];
      dst[(size_t)lo * 16 + k] = s;
    }
  };

  const int n_batches = (top + kBwdBatch - 1) / kBwdBatch;
  int row = n_batches > 0 ? index_at(0) : -1;
  issue(row, 0);
  box(row, 0);
  row = index_at(1);
  __syncthreads();
  for (int i = 0; i < n_batches; ++i) {
    const int buf = i & 1;
    const int lo = lo_of(i);
    const int n = top - kBwdBatch * i - lo;
    const int row_next = i + 1 < n_batches ? row : -1;
    issue(row_next, buf ^ 1);
    row = index_at(i + 2);  // used a batch from now
    if (i > 0) write_batch(i - 1);

    float* pw = part + ((size_t)buf * n_warps + warp) * kBwdBatch * 16;
    unsigned mask = __ballot_sync(
        kFull, lane < n && blend::box_hits(boxes[buf][lane], pt));
    unsigned wrote = 0;
    while (mask) {
      const int jj = 31 - __clz(mask);  // back to front
      mask &= ~(1u << jj);
      float d[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) d[c] = 0.0f;
      bool reached = false;
      if (lo + jj < walked) {
        const float4 a0 = rows[buf][4 * jj];
        const float4 a1 = rows[buf][4 * jj + 1];
        const blend::Weight g = blend::weight(a0, a1, pt.px, pt.py);
        if (g.q >= 0.0f && g.w >= min_alpha) {
          reached = true;
          const float w = fminf(g.w, alpha_clip);
          const float one_m_w = __fsub_rn(1.0f, w);
          T = T / one_m_w;                      // T entering entry j
          const float contrib = T * w;
          const float4 v0 = rows[buf][4 * jj + 2];
          const float4 v1 = rows[buf][4 * jj + 3];
          const float G = g0.x * v0.x + g0.y * v0.y + g0.z * v0.z +
                          g0.w * v0.w + g1.x * v1.x + g1.y * v1.y +
                          g1.z * v1.z + g1.w * v1.w;
          float dw = G * T - S_sum / fmaxf(one_m_w, 1e-6f);
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
          d[8] = contrib * g0.x; d[9] = contrib * g0.y;
          d[10] = contrib * g0.z; d[11] = contrib * g0.w;
          d[12] = contrib * g1.x; d[13] = contrib * g1.y;
          d[14] = contrib * g1.z; d[15] = contrib * g1.w;
          S_sum += G * contrib;
        }
      }
      if (__any_sync(kFull, reached)) {
        const float s = reduce_scatter16(d, lane);
        if (!(lane & 1)) pw[jj * 16 + (lane >> 1)] = s;
        wrote |= 1u << jj;
      }
    }
    if (lane == 0) wmask[buf][warp] = wrote;
    box(row_next, buf ^ 1);
    // the batch after and this batch's partials are visible, and nobody
    // still reads the buffers the next iteration refills
    __syncthreads();
  }
  if (n_batches > 0) write_batch(n_batches - 1);
  if (tid == 0) lens[bt * S + strip] = top;
}

// d_panels[b, t, k] = sum over the tile's S blocks, in strip order, of their
// partials at slot k (zero past a block's walk length); one float4 a thread
__global__ void __launch_bounds__(256)
blend_bwd_sum_kernel(const float4* __restrict__ parts,
                     const int* __restrict__ lens,
                     float4* __restrict__ d_panels, int S, int K,
                     size_t n_out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const size_t bt = i / ((size_t)K * 4);
  const int k = (int)((i / 4) % K);
  const int c4 = (int)(i % 4);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int st = 0; st < S; ++st) {
    if (k < lens[bt * S + st]) {
      const float4 v = parts[((bt * S + st) * K + k) * 4 + c4];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
  }
  d_panels[i] = s;
}

constexpr int kSumThreads = 256;

}  // namespace

// Launch on `stream`: S = tile_size / 8 blocks of tile_size * 8 threads a
// (tile, view). Each returns the cudaGetLastError() code of its launch (0
// on success; cudaErrorInvalidValue for a tile size the kernel does not
// take, see blend::valid_tile).
template <bool kTrain>
static int launch_fwd(const float* packed, const int* tile_lists,
                      const int* tile_counts, float* out, float* t_final,
                      int* n_last, int n_views, int n_tiles, int K,
                      int n_rows, int tiles_x, int tile_size,
                      float alpha_clip, float min_alpha, float t_eps,
                      void* stream) {
  if (!blend::valid_tile(tile_size)) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0 && n_views > 0) {
    const int S = tile_size / blend::kBlockRows;
    blend_fwd_kernel<kTrain><<<dim3(n_tiles * S, n_views),
                               tile_size * blend::kBlockRows, 0,
                               (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(packed), tile_lists, tile_counts,
        reinterpret_cast<float4*>(out), t_final, n_last, n_tiles, K, n_rows,
        tiles_x, tile_size, alpha_clip, min_alpha, t_eps);
  }
  return (int)cudaGetLastError();
}

extern "C" int blend_train_fwd_f32(const float* packed, const int* tile_lists,
                                   const int* tile_counts, float* out,
                                   float* t_final, int* n_last, int n_views,
                                   int n_tiles, int K, int n_rows,
                                   int tiles_x, int tile_size,
                                   float alpha_clip, float min_alpha,
                                   float t_eps, void* stream) {
  return launch_fwd<true>(packed, tile_lists, tile_counts, out, t_final,
                          n_last, n_views, n_tiles, K, n_rows, tiles_x,
                          tile_size, alpha_clip, min_alpha, t_eps, stream);
}

extern "C" int blend_tiles_eval_f32(const float* packed, const int* tile_lists,
                                    const int* tile_counts, float* out,
                                    int n_views, int n_tiles, int K,
                                    int n_rows, int tiles_x, int tile_size,
                                    float alpha_clip, float min_alpha,
                                    float t_eps, void* stream) {
  return launch_fwd<false>(packed, tile_lists, tile_counts, out, nullptr,
                           nullptr, n_views, n_tiles, K, n_rows, tiles_x,
                           tile_size, alpha_clip, min_alpha, t_eps, stream);
}

// The backward: blend_bwd_order_kernel ranks each view's tiles into
// `order` (B, T) int32, then S = tile_size / 8 blocks of tile_size * 8
// threads a (tile, view) write `parts` (B, T, S, K, 16) float32 and `lens`
// (B, T, S) int32 (scratch the caller allocates), and blend_bwd_sum_kernel
// sums them into d_panels (B, T, K, 16). cudaErrorInvalidValue for a tile
// size the kernels do not take (blend::valid_tile).
extern "C" int blend_train_bwd_f32(const float* packed, const int* tile_lists,
                                   const int* tile_counts,
                                   const float* t_final, const int* n_last,
                                   const float* g_out, float* parts,
                                   int* lens, int* order, float* d_panels,
                                   int n_views,
                                   int n_tiles, int K, int n_rows,
                                   int tiles_x, int tile_size,
                                   float alpha_clip, float min_alpha,
                                   void* stream) {
  if (!blend::valid_tile(tile_size)) return (int)cudaErrorInvalidValue;
  if (n_tiles <= 0 || n_views <= 0 || K <= 0) return 0;
  const int S = tile_size / blend::kBlockRows;
  const int threads = tile_size * blend::kBlockRows;
  const size_t smem = bwd_smem(threads / 32);  // <= 37,888 B: no opt-in
  blend_bwd_order_kernel<<<n_views, kSumThreads, 0, (cudaStream_t)stream>>>(
      tile_counts, order, n_tiles);
  blend_bwd_kernel<<<dim3(n_tiles * S, n_views), threads, smem,
                     (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(packed), tile_lists, order, t_final,
      n_last, reinterpret_cast<const float4*>(g_out), parts, lens, n_tiles, K,
      n_rows,
      tiles_x, tile_size, alpha_clip, min_alpha);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n_out = (size_t)n_views * n_tiles * K * 4;
  blend_bwd_sum_kernel<<<(unsigned)((n_out + kSumThreads - 1) / kSumThreads),
                         kSumThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(parts), lens,
      reinterpret_cast<float4*>(d_panels), S, K, n_out);
  return (int)cudaGetLastError();
}

// The launch facts, as blend::launch_facts lists them in info[6], of part
// 0 blend_fwd_kernel<true> (B1 forward), 1 blend_fwd_kernel<false> (B3),
// 2 blend_bwd_kernel, 3 blend_bwd_sum_kernel, 4 blend_bwd_order_kernel, at
// tile_size.
extern "C" int blend_train_info(int part, int tile_size, int* info) {
  if (!blend::valid_tile(tile_size)) return (int)cudaErrorInvalidValue;
  const int threads = tile_size * blend::kBlockRows;
  switch (part) {
    case 0:
      return (int)blend::launch_facts(blend_fwd_kernel<true>, threads, 0,
                                      info);
    case 1:
      return (int)blend::launch_facts(blend_fwd_kernel<false>, threads, 0,
                                      info);
    case 2:
      return (int)blend::launch_facts(blend_bwd_kernel, threads,
                                      bwd_smem(threads / 32), info);
    case 3:
      return (int)blend::launch_facts(blend_bwd_sum_kernel, kSumThreads, 0,
                                      info);
    case 4:
      return (int)blend::launch_facts(blend_bwd_order_kernel, kSumThreads, 0,
                                      info);
    default: return (int)cudaErrorInvalidValue;
  }
}
