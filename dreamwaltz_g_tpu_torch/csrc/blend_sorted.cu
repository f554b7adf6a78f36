// Sorted-segment front-to-back Gaussian blend (eval render), for sm_90a.
//
// Replaces dreamwaltz_g_tpu/ops/pallas_blend.py:_make_sorted_kernel (:228,
// called by blend_sorted_pallas :326, pallas_call :392). Same function: tile
// t composites the Gaussians s_idx[seg_start[t] : seg_start[t] + counts[t]]
// (depth-sorted by the binning) front to back over its tile_size^2 pixels
// and writes, per pixel, the 8 value lanes [c0, c1, c2, depth, 1, 0, 0, 0]
// weighted by T_i * w_i, with w = op * exp(-q / 2), q the conic form at the
// pixel centre, an entry skipped unless q >= 0 and w >= min_alpha, and w
// clipped to alpha_clip.
//
// Packed row per Gaussian, 16 floats (64 B):
//   [mx, my, ca, cb, cc, op, 0, 0, v0, v1, v2, v3, v4, v5, v6, v7]
//
// What bounds it on the H100: the bytes are small (the packed table, 4 B
// of s_idx per entry, the 32 B-per-pixel output: ~30 MB for a 1024^2 frame
// of a 200k-Gaussian avatar), and so is the float work once the cull below
// drops the pairs min_alpha rejects: 13 float32 operations with one exp for
// each pair a pixel reaches and its patch keeps (~16% of the pairs reached
// on the render's frames), 20 more for each pair it blends (~2-3%), and a
// float64 box a block per entry (chip_smoke.py counts that work for the
// bound). A third of the tiles overflow to the full 1024 entries while the
// rest are light, so without the cull the rejected pairs, and with it the
// heaviest tiles' walks, set the time.
//
// Design (blend_common.cuh has the patch map and the cull's proof):
// * Sub-tile blocks: a block covers 8 rows of a tile (a 32 x 8 strip of
//   256 threads, 4 blocks a tile at tile_size 32), so a heavy tile
//   spreads over several SMs. Each block gathers the tile's rows itself (the
//   packed table stays in the 50 MB L2) and leaves once all its pixels have
//   stopped.
// * A warp owns an 8 x 4 pixel patch, not a row, and skips every entry
//   whose footprint box misses the patch's pixel centres: no exp, no test.
//   The box (computed once a block per entry, in float64, widened past the
//   kernel's rounding) holds every pixel where w >= min_alpha can pass, so a
//   skipped pair is one the plain test rejects and each pixel's arithmetic
//   and its order are the parent design's: the output is the same to every
//   bit. Each warp tests 32 entries' boxes at once (one a lane) and walks
//   the ballot's set bits in order.
// * Rows arrive through 16-byte cp.async copies, double-buffered, one
//   barrier a batch.
// The walk itself is blend::forward_walk, which B1's forward and B3
// (blend_train.cu) share: the three forward blends differ only in where
// an entry's row index comes from (s_idx here, a tile list there), the
// table's view offset and whether the walk's state is saved, so B2's image
// equals B3's to every bit by construction.
//
// Differences from the TPU kernel, by design: the TPU kernel keeps log T,
// forms the exclusive prefix with a bf16 matmul (about 0.4% on log T) and
// stops per TILE at 128-entry chunk boundaries; this kernel multiplies T
// in float32 and stops per PIXEL. What the TPU kernel still adds after a
// pixel's T drops below t_eps is at most t_eps * |value|.
// q and w are evaluated with explicit round-to-nearest multiplies and adds
// (no FMA contraction) in the plain PyTorch version's operation order, so
// that the min_alpha and q >= 0 tests decide alike in both versions.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

__global__ void __launch_bounds__(blend::kMaxThreads)
blend_sorted_kernel(const float4* __restrict__ packed,
                    const int* __restrict__ s_idx,
                    const int* __restrict__ seg_start,
                    const int* __restrict__ counts,
                    float4* __restrict__ out,
                    int tiles_x, int tile_size,
                    float alpha_clip, float min_alpha, float t_eps) {
  const int S = tile_size / blend::kBlockRows;
  const int t = blockIdx.x / S;
  const blend::Patch pt =
      blend::patch_of(t, blockIdx.x % S, tiles_x, tile_size);
  blend::forward_walk<false>(
      packed, s_idx + seg_start[t], counts[t], pt,
      (size_t)t * tile_size * tile_size + pt.pid, alpha_clip, min_alpha,
      t_eps, out, nullptr, nullptr);
}

}  // namespace

// Launch on `stream`: tile_size / 8 blocks of tile_size * 8 threads a
// tile. Returns the cudaGetLastError() code of the launch (0 on success;
// cudaErrorInvalidValue for a tile size the kernel does not take, see
// blend::valid_tile).
extern "C" int blend_sorted_f32(const float* packed, const int* s_idx,
                                const int* seg_start, const int* counts,
                                float* out, int n_tiles, int tiles_x,
                                int tile_size, float alpha_clip,
                                float min_alpha,
                                float t_eps, void* stream) {
  if (!blend::valid_tile(tile_size)) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    blend_sorted_kernel<<<n_tiles * (tile_size / blend::kBlockRows),
                          tile_size * blend::kBlockRows, 0,
                          (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(packed), s_idx, seg_start, counts,
        reinterpret_cast<float4*>(out), tiles_x, tile_size, alpha_clip,
        min_alpha, t_eps);
  }
  return (int)cudaGetLastError();
}

// The launch facts of blend_sorted_f32's kernel at tile_size, as
// blend::launch_facts lists them in info[6].
extern "C" int blend_sorted_info(int tile_size, int* info) {
  if (!blend::valid_tile(tile_size)) return (int)cudaErrorInvalidValue;
  return (int)blend::launch_facts(blend_sorted_kernel,
                                  tile_size * blend::kBlockRows, 0, info);
}
