// Shared by blend_sorted.cu and blend_train.cu: the warp patches, the exact
// footprint cull, 16-byte cp.async copies, the per-pair weight, the
// front-to-back walk of the three forward blends and the launch facts.
//
// Patches. A tile of tile_size^2 pixels (tile_size 8, 16, 24 or 32) is cut
// into 8 x 4 pixel patches, numbered row-major (tile_size / 8 a row). A block
// covers kBlockRows = 8 whole rows of the tile (tile_size * 8 threads, at
// most 256), so tile_size / 8 blocks share a tile; warp w of block `strip`
// owns patch 2 * strip * (tile_size / 8) + w, and lane l pixel (l % 8, l / 8)
// of it. Outputs keep the tile's row-major
// pixel order; only the thread -> pixel map is the patches'.
//
// The cull. Pixel (px, py) blends an entry only where the kernel's
// float32 weight w = op * expf(-q / 2), q = ca dx^2 + 2 cb dx dy + cc dy^2
// with dx = px - mx, dy = py - my, passes w >= min_alpha (and q >= 0). With
// exact arithmetic that is q <= r = 2 ln(op / min_alpha), an ellipse whose
// bounding box, for a positive-definite conic (det = ca cc - cb^2 > 0,
// ca > 0), is |dx| <= sqrt(r cc / det), |dy| <= sqrt(r ca / det).
// footprint_box widens it so that it holds every pixel the kernel's rounded
// arithmetic can pass:
// * expf is within 2 ulp and the product op * e rounds once, so the kernel's
//   w is at most op exp(-q_k / 2) (1 + kEpsW), kEpsW = 2^-20 > 3 * 2^-23:
//   a passing pixel has q_k <= r + 2 kEpsW, q_k the kernel's q;
// * q_k is formed by round-to-nearest multiplies and adds (dx, dy rounded
//   once each, four roundings a term, two for the sums), so
//   |q_k - q| <= 6u Q + O(u^2), u = 2^-24, Q = ca dx^2 + 2|cb dx dy| +
//   cc dy^2 <= 2 (ca dx^2 + cc dy^2) <= 2 kappa q with
//   kappa = (ca + cc)^2 / det (ca dx^2 + cc dy^2 <= (ca + cc)(dx^2 + dy^2)
//   and q >= (det / (ca + cc)) (dx^2 + dy^2)). With kGamma = 2^-21 >= 6u:
//   q <= (r + 2 kEpsW) / (1 - 2 kGamma kappa), the radius the box takes;
// * the box is computed in float64 (its own roundings ~1e-16 relative, and
//   a 2^-30 relative widening covers them) and rounded outward to float32.
// A conic that is not positive definite (det <= 0 or ca <= 0, where the
// region is unbounded and the bound above fails), or so thin that
// 2 kGamma kappa > 1/2, or an entry with a NaN or infinite attribute, gets
// the whole plane: it is never culled. An entry whose op (1 + kEpsW) is below
// min_alpha (dead slots and the sentinel row have op = 0) gets the empty box:
// its w fails everywhere. So a culled pair is one the plain test rejects,
// and no pixel's arithmetic changes. ops/blend.py:footprint_boxes is the
// plain twin.

#pragma once

#include <cuda_runtime.h>

namespace blend {

constexpr unsigned kFull = 0xffffffffu;
constexpr double kEpsW = 1.0 / (1 << 20);
constexpr double kGamma = 1.0 / (1 << 21);
constexpr double kKappaMax = 0.25 / kGamma;  // 2 kGamma kappa <= 1/2
constexpr int kBlockRows = 8;                 // tile rows a block covers
constexpr int kMaxThreads = 32 * kBlockRows;  // threads a block, at most

// (x_lo, x_hi, y_lo, y_hi) of the pixel centres that may pass min_alpha
__device__ __forceinline__ float4 footprint_box(float4 a0, float4 a1,
                                                float min_alpha) {
  const float inf = __int_as_float(0x7f800000);
  const double op = a1.y;
  if (op * (1.0 + kEpsW) < (double)min_alpha)
    return make_float4(inf, -inf, inf, -inf);
  const double mx = a0.x, my = a0.y, ca = a0.z, cb = a0.w, cc = a1.x;
  const double det = ca * cc - cb * cb;
  const double kappa = (ca + cc) * (ca + cc) / det;
  if (!(det > 0.0 && ca > 0.0 && kappa <= kKappaMax && isfinite(op)))
    return make_float4(-inf, inf, -inf, inf);
  const double r =
      fmax(2.0 * log(op / (double)min_alpha) + 2.0 * kEpsW, 0.0) /
      (1.0 - 2.0 * kGamma * kappa) * (1.0 + 1.0 / (1 << 30));
  const double hx = sqrt(r * cc / det);
  const double hy = sqrt(r * ca / det);
  const float4 box =
      make_float4(__double2float_rd(mx - hx), __double2float_ru(mx + hx),
                  __double2float_rd(my - hy), __double2float_ru(my + hy));
  // a NaN or infinite attribute leaves no finite box: never culled
  if (!(isfinite(box.x) && isfinite(box.y) && isfinite(box.z) &&
        isfinite(box.w)))
    return make_float4(-inf, inf, -inf, inf);
  return box;
}

// This thread's pixel and its warp's patch (see the note above).
struct Patch {
  int pid;             // pixel index in the tile, row-major
  float px, py;        // this pixel's centre
  float x0, x1, y0, y1;  // the patch's extreme pixel centres
};

__device__ __forceinline__ Patch patch_of(int t, int strip, int tiles_x,
                                          int tile_size) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int across = tile_size >> 3;
  const int pr = strip * (kBlockRows / 4) + warp / across;
  const int pc = warp % across;
  const int lx = pc * 8 + (lane & 7);
  const int ly = pr * 4 + (lane >> 3);
  const float ox = (float)((t % tiles_x) * tile_size);
  const float oy = (float)((t / tiles_x) * tile_size);
  Patch p;
  p.pid = ly * tile_size + lx;
  p.px = ox + (float)lx + 0.5f;
  p.py = oy + (float)ly + 0.5f;
  p.x0 = ox + (float)(pc * 8) + 0.5f;
  p.x1 = p.x0 + 7.0f;
  p.y0 = oy + (float)(pr * 4) + 0.5f;
  p.y1 = p.y0 + 3.0f;
  return p;
}

__device__ __forceinline__ bool box_hits(const float4 b, const Patch& p) {
  return b.y >= p.x0 && b.x <= p.x1 && b.w >= p.y0 && b.z <= p.y1;
}

// the tile sizes the kernels take: 8 to 32 in steps of 8
inline bool valid_tile(int tile_size) {
  return tile_size >= 8 && tile_size <= 32 && tile_size % 8 == 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread issued has landed and is visible to it
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Weight {
  float dx, dy, q, w;  // w is the raw weight op * exp(-q / 2)
};

// q and w of one (pixel, entry) pair with explicit round-to-nearest
// multiplies and adds (no FMA contraction) in the plain PyTorch version's
// operation order, so that the q >= 0 and min_alpha tests decide alike in
// both versions.
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

constexpr int kWalkRows = 128;  // rows a batch: 8 KB of rows + 2 KB of boxes

// The forward walk of the three forward blends (B2, B1 forward, B3): this
// block's pixels composite the `count` entries idx[0 .. count) (rows of
// `table`, depth-ordered) front to back, and pixel p of the output gets
// sum_j T_j w_j v_j. Each warp walks only the entries whose footprint box
// hits its patch; a pixel stops after the entry that takes its T to t_eps
// or below, and the block leaves once all its pixels have stopped. With
// kSave it also writes the pixel's final T and n_last, the list index + 1
// of the entry that stopped it (`count` where none did), which the
// backward walks back from: T = T (1 - w) is rounded as the backward's
// recovery T_j = T_{j+1} / (1 - w_j) undoes it.
//
// Rows arrive through 16-byte cp.async copies, double-buffered: batch
// b + 1 is in flight while batch b is blended. The thread that copied a
// row waits for its own copies and computes the row's box, so one barrier
// a batch (which also counts the stopped pixels) suffices; the row index
// of the batch after is read into a register a batch ahead. Each warp
// tests 32 entries' boxes at once (one a lane) and walks the ballot's set
// bits in list order.
template <bool kSave>
__device__ __forceinline__ void forward_walk(
    const float4* __restrict__ table, const int* __restrict__ idx, int count,
    const Patch& pt, size_t p, float alpha_clip, float min_alpha,
    float t_eps, float4* __restrict__ out, float* __restrict__ t_final,
    int* __restrict__ n_last) {
  __shared__ float4 rows[2][kWalkRows * 4];
  __shared__ float4 boxes[2][kWalkRows];
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int R = min(kWalkRows, nthr);  // one row a thread, at most

  // the row of entry b0 + tid, or -1 past the list
  auto index_at = [&](int b0) {
    return tid < R && b0 + tid < count ? idx[b0 + tid] : -1;
  };
  auto issue = [&](int g, int buf) {
    if (g >= 0) {
      const float4* src = table + (size_t)g * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) cp_async16(&rows[buf][4 * tid + c],
                                             src + c);
    }
    cp_async_commit();
  };
  auto box = [&](int g, int buf) {
    cp_async_wait_all();
    if (g >= 0)
      boxes[buf][tid] = footprint_box(rows[buf][4 * tid],
                                      rows[buf][4 * tid + 1], min_alpha);
  };

  float T = 1.0f;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int done = 0;
  int walked = count;

  int g = index_at(0);
  issue(g, 0);
  box(g, 0);
  g = index_at(R);
  __syncthreads();
  for (int b0 = 0, buf = 0; b0 < count; b0 += R, buf ^= 1) {
    const int n = min(R, count - b0);
    const int g_next = g;
    issue(g_next, buf ^ 1);
    g = index_at(b0 + 2 * R);  // used a batch from now
    for (int j0 = 0; j0 < n && !__all_sync(kFull, done); j0 += 32) {
      const bool hit = j0 + lane < n && box_hits(boxes[buf][j0 + lane], pt);
      unsigned mask = __ballot_sync(kFull, hit);
      while (mask) {
        const int j = j0 + __ffs(mask) - 1;
        mask &= mask - 1;
        if (done) continue;
        const float4 a0 = rows[buf][4 * j];
        const float4 a1 = rows[buf][4 * j + 1];
        const Weight r = weight(a0, a1, pt.px, pt.py);
        if (!(r.q >= 0.0f && r.w >= min_alpha)) continue;
        const float w = fminf(r.w, alpha_clip);
        const float4 v0 = rows[buf][4 * j + 2];
        const float4 v1 = rows[buf][4 * j + 3];
        const float c = T * w;
        acc[0] += c * v0.x; acc[1] += c * v0.y;
        acc[2] += c * v0.z; acc[3] += c * v0.w;
        acc[4] += c * v1.x; acc[5] += c * v1.y;
        acc[6] += c * v1.z; acc[7] += c * v1.w;
        T = __fmul_rn(T, __fsub_rn(1.0f, w));
        if (T <= t_eps) {
          done = 1;
          walked = b0 + j + 1;
        }
      }
    }
    box(g_next, buf ^ 1);
    // the batch after lands before anyone reads it, nobody still reads this
    // batch's buffers when the next iteration refills them, and the block
    // leaves once every pixel has stopped
    if (__syncthreads_count(done) == nthr) break;
  }

  out[2 * p] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  out[2 * p + 1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  if (kSave) {
    t_final[p] = T;
    n_last[p] = walked;
  }
}

// info = {threads, static shared-memory bytes, dynamic shared-memory bytes,
// resident blocks an SM, registers a thread, local-memory bytes a thread}
template <typename K>
cudaError_t launch_facts(K* kernel, int threads, size_t dyn_smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, dyn_smem);
  const int facts[6] = {threads, (int)attr.sharedSizeBytes, (int)dyn_smem,
                        blocks, attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 6; ++i) info[i] = facts[i];
  return err;
}

}  // namespace blend
