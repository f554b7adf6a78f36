// Shared by blend_sorted.cu and blend_train.cu: the warp patches, the exact
// footprint cull, 16-byte cp.async copies and the launch facts.
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
