// Flash self-attention forward at head dimensions 40, 64 and 80 in bf16,
// for sm_90a: TMA copies, wgmma products and warp-specialised warpgroups.
//
// Replaces, at D = 40, 64 and 80 in bf16, the forward of the TPU kernel
// behind dreamwaltz_g_tpu/guidance/layers.py:153 `_flash_kernel`
// (pallas_call :167): out = softmax(Q K^T / sqrt(D)) V over (B, N, H, D)
// and the (B, H, N) float32 lse = row max + log(row sum) of the scaled
// scores, in natural log. SD1.5's heads are 40 wide at its 64^2 latents
// and 80 wide at 32^2, SDXL's and SD2.x's 64; the other widths stay with
// csrc/flash_attn.cu. The arithmetic is the row-split forward's there:
// float32 scores and softmax, each exponent one FFMA (scale log2 e folded
// in) and one ex2.approx, each probability rounded to bf16 once and the
// output once, so guidance/flash.py's plain versions are its twins.
//
// Bound on this card: operations, 4 B H N^2 D for the two products at the
// tensor cores' 989 TFLOP/s (0.087 ms at SDXL's (2, 4096, 10, 64), 0.043 ms
// at SD1.5's (2, 4096, 8, 40), 0.0054 ms at its (2, 1024, 8, 80); NVIDIA
// H100 80GB HBM3 at its 700 W limit), but the B H N^2 exponentials, at 16
// ex2 a clock an SM, set a floor of ~0.09 ms and ~0.072 ms at the first two
// at ~1.75 GHz: at D = 64 a key costs as much on the special-function units
// as on the tensor cores, and at D = 40 the exponentials alone set the
// floor. The design keeps both units busy at once.
//
// Design:
//  * A block owns 128 query rows of one (batch, head): three warpgroups,
//    one producer and two consumers of 64 rows each. Grid (N / 128, H, B);
//    N is a multiple of 128 under the modules' flash gate.
//  * The producer's first thread issues every copy as a TMA load: the Q
//    tile once, then 128-key tiles of K and V into a ring of stages (3 at
//    D = 40 and 80, 2 at D = 64), each with its own K-full, V-full and
//    empty mbarrier, so the scores of a tile start before its V lands.
//    The producer gives its registers to the consumers (setmaxnreg).
//  * A tile's first 64 columns are one slab of 128-byte rows, the TMA's and
//    wgmma's 128-byte swizzle exactly, so it lands swizzled, with no
//    padding and no bank conflicts, and the products read it from shared
//    memory through descriptors. The tensor maps (4-D: D, H, N, B, by the
//    tensors' own strides) span D columns; at D = 40 the box's columns
//    40-63 lie past the map's first dimension, and TMA fills them with
//    zeros (not the next head's values), so a 40-wide tile lands as a
//    64-wide one whose last 24 columns are zero, with the same byte count
//    for the barrier. A row of 80 columns (160 bytes) is wider than the
//    128-byte swizzle atom: at D = 80 its last 16 columns land in a second
//    slab of 32-byte rows with the 32-byte swizzle, through a second map a
//    tensor (box {16, 1, 128, 1} at column 64), so a tile is 20 KB with no
//    zeros copied. The maps are encoded on the host through CUDA's
//    entry-point query and cached by (pointer, box, shape, strides); they
//    reach the kernel as one __grid_constant__ parameter.
//  * S = Q K^T: wgmma m64n128k16, Q and K K-major from shared memory,
//    ceil(D / 16) k-steps (three at D = 40: columns 40-47 are zeros on both
//    sides; at D = 80 four on the first slab and one on the second). The
//    softmax runs on the accumulator in registers (a row's 128 scores over
//    a quad of lanes), and P, rounded to bf16 in registers, is the A
//    operand of O += P V: wgmma m64nDk16 (N = D, a multiple of 8; at D = 80
//    m64n64k16 on the first slab and m64n16k16 on the second, from the same
//    P registers), V from shared memory with the transpose bit (its rows
//    are keys), eight k-steps; the accumulator is D / 2 floats a thread.
//  * Overlap comes from the two consumers: while one runs its softmax on
//    the special-function units, the other's products run on the tensor
//    cores. Within a consumer the products and the softmax take turns: an
//    overlapped loop (tile i's S issued before tile i - 1's P V is done)
//    was serialised by ptxas (its C7513 note) in every form tried, and was
//    no faster (PERF.md, section 6), nor was a ping-pong of the two
//    consumers on named barriers. One overlap that ptxas keeps, P V's
//    first half running while the second half of the tile's P is computed
//    (`split_pv`), is built but taken at no width yet.
//  * A wait that never ends traps (a launch error) instead of hanging the
//    card.
//
// The C functions launch on the given stream, do not synchronise or
// allocate, and return cudaGetLastError() (or an error code of their own
// above cudaError_t's range).
#include <cuda.h>  // CUtensorMap and its enums; no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BOX_D = 64;     // the first slab's columns: one 128-byte row
constexpr int TAIL_D = 16;    // the second slab's at D = 80: a 32-byte row
constexpr int BM = 128;       // query rows a block
constexpr int BN = 128;       // keys a tile
constexpr int THREADS = 384;  // a producer and two consumer warpgroups
// bytes of a tile's first slab (K, V or Q), whatever the head dimension:
// TMA writes (and counts) the whole box, zeros past the map's D columns
constexpr int SLAB = BN * BOX_D * 2;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// whether head dimension HD has a second slab (columns 64 .. HD - 1)
template <int HD>
__host__ __device__ constexpr bool has_tail() {
  static_assert(HD == 40 || HD == 64 || HD == 64 + TAIL_D, "a Hopper width");
  return HD > BOX_D;
}

// bytes of a K, V or Q tile at head dimension HD
template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  return SLAB + (has_tail<HD>() ? BN * TAIL_D * 2 : 0);
}

// the K / V ring's stages at head dimension HD: 3 at D = 40, where the
// copies of 80-byte rows take about as long as a tile's products and
// softmax, and at D = 80; 2 at D = 64, where a third stage was slower
// (PERF.md, section 6)
template <int HD>
__host__ __device__ constexpr int ring_stages() {
  return HD == 64 ? 2 : 3;
}

// whether a tile's P V is split around its exponentials at head dimension
// HD: P V's first four k-steps issued once the first half of the tile's
// exponentials is done, and the second half computed while they run. No
// width takes it: its gain at D = 64 and 80 was not there at every shape in
// every turn (PERF.md, section 6), so each width runs the tile's softmax
// whole, then all of P V; flash_hopper_variants.py's `split_pv` turns it on
template <int HD>
__host__ __device__ constexpr bool split_pv() {
  return false;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of copies to complete
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed (parity 1 on a fresh
// barrier passes at once); traps after ~2^24 polls, well past any wait the
// pipeline can have
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls > (1 << 24)) __trap();
  }
}

// the map's box of a 4-D map at (d, h, n, b) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int n,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(d), "r"(h), "r"(n), "r"(b)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units) and the layout type in bits 62-63.
// K-major (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (the
// stride offset), the leading offset unused. MN-major (V under the transpose
// bit): the 8-key groups 1024 bytes apart; N = 64 (or 40) lies within one
// swizzle atom, so the leading offset is unused too. A k-step moves the
// start address:
// 32 bytes along a K-major row, 16 rows (2048 bytes) down V.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the same for the 32-byte swizzle (layout type 3), D = 80's second slab:
// rows of 32 bytes, 8-row groups 256 bytes apart. K-major, a row is one
// k-step's 16 columns; MN-major, V's 16 columns are one swizzle atom (the
// leading offset unused) and a k-step moves 16 rows (512 bytes) down.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most `n` committed groups of this warpgroup are in flight
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// keep the compiler from moving register reads or writes of `r` across
// this point (the products write and read them asynchronously)
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// d (64 x 128, float32) (+)= A B: A 64 x 16 and B 16 x 128 from shared
// memory through their descriptors, both K-major; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x N, float32) += A B for N = 16, 40 or 64 (d: N / 2 floats): A
// 64 x 16 from registers (the m16n8k16 A fragment of each warp's 16 rows),
// B 16 x N from shared memory through its descriptor, MN-major (the
// transpose bit set); N = 40 reads the first 40 columns of the 64-wide
// swizzle atom, N = 16 D = 80's second slab
__device__ __forceinline__ void wgmma_pv(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[20],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

// ---------------------------------------------------------------------------
// the online softmax of one key tile
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// over the 4 lanes of a quad, which hold one accumulator row between them
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A warp's 16 rows of a tile's scores s as the m64n128 accumulator holds
// them (lane 4 g + t: s[4 j .. 4 j + 1] row g, keys 8 j + 2 t and + 1;
// s[4 j + 2 .. 4 j + 3] row g + 8). m: the running row maxima in the log2
// domain of the scaled scores, taken to the tile's (neg_m = -m), and
// alpha = 2^(m_old - m_new), which rescales O and the row sums.
__device__ __forceinline__ void tile_max(const float (&s)[64], float (&m)[2],
                                         float (&alpha)[2],
                                         float (&neg_m)[2],
                                         float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the first tile: m = -inf, so alpha = 2^-inf = 0
    float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
}

// P = 2^(scale_log2 s - m) of keys 64 HALF .. 64 HALF + 63 as the A
// fragments of P V's k-steps 4 HALF .. 4 HALF + 3 (the accumulator layout
// of keys 16 k .. 16 k + 15 is the A layout), each value rounded to bf16
// once; sum: this lane's partial row sums, added in key order
template <int HALF>
__device__ __forceinline__ void tile_exp(const float (&s)[64],
                                         uint32_t (&pa)[8][4],
                                         const float (&neg_m)[2],
                                         float (&sum)[2], float scale_log2) {
#pragma unroll
  for (int j = 8 * HALF; j < 8 * HALF + 8; ++j) {
    float p0 = ex2(fmaf(s[4 * j], scale_log2, neg_m[0]));
    float p1 = ex2(fmaf(s[4 * j + 1], scale_log2, neg_m[0]));
    float p2 = ex2(fmaf(s[4 * j + 2], scale_log2, neg_m[1]));
    float p3 = ex2(fmaf(s[4 * j + 3], scale_log2, neg_m[1]));
    sum[0] += p0 + p1;
    sum[1] += p2 + p3;
    pa[j / 2][2 * (j & 1)] = pack_bf16(p0, p1);
    pa[j / 2][2 * (j & 1) + 1] = pack_bf16(p2, p3);
  }
}

// fence_regs of the A fragments of P V's k-steps 4 HALF .. 4 HALF + 3 only
// (the other half may be in flight)
template <int HALF>
__device__ __forceinline__ void fence_half(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 4 * HALF; i < 4 * HALF + 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

template <int R>
__device__ __forceinline__ void rescale(float (&o)[R],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// a block's shared memory with a ring of S stages of T-byte tiles, by byte
// offsets from a 1024-byte aligned base: Q, the K ring, the V ring, then
// the barriers (Q full; K full, V full and empty for each stage)
template <int S, int T>
struct Ring {
  static constexpr int STAGES = S;
  static constexpr int OFF_K = T;
  static constexpr int OFF_V = OFF_K + S * T;
  static constexpr int OFF_BAR = OFF_V + S * T;
  // dynamic shared memory a block: the layout and the base's alignment
  // slack
  static constexpr int SMEM_BYTES = OFF_BAR + 8 * (1 + 3 * S) + 1024;
  uint32_t base;  // the 1024-byte aligned start of the layout
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k(int s) const { return base + OFF_K + s * T; }
  __device__ uint32_t v(int s) const { return base + OFF_V + s * T; }
  __device__ uint32_t q_full() const { return base + OFF_BAR; }
  __device__ uint32_t k_full(int s) const {
    return base + OFF_BAR + 8 * (1 + s);
  }
  __device__ uint32_t v_full(int s) const {
    return base + OFF_BAR + 8 * (1 + S + s);
  }
  __device__ uint32_t empty(int s) const {
    return base + OFF_BAR + 8 * (1 + 2 * S + s);
  }
};

template <int HD>
using RingOf = Ring<ring_stages<HD>(), tile_bytes<HD>()>;

// the kernel's tensor maps, each spanning its tensor's D columns: Q's, K's
// and V's first slab's (box {64, 1, 128, 1}, 128-byte swizzle) and, at
// D = 80, their second slab's (box {16, 1, 128, 1}, 32-byte swizzle)
template <int HD>
struct Maps {
  static constexpr int SLABS = has_tail<HD>() ? 2 : 1;
  CUtensorMap q[SLABS], k[SLABS], v[SLABS];
};

// the producer's one thread: Q, then each key tile's K and V into the ring
// once the consumers have released its stage
template <int HD>
__device__ __forceinline__ void produce(const RingOf<HD>& r,
                                        const Maps<HD>& mp, int n_tiles,
                                        int b, int h, int q0) {
  constexpr int STAGES = RingOf<HD>::STAGES;
  // one tile of a tensor: its slabs, completing one barrier
  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar,
                  int n) {
    mbar_expect_tx(bar, tile_bytes<HD>());
    tma_load(dst, map, bar, 0, h, n, b);
    if constexpr (has_tail<HD>())
      tma_load(dst + SLAB, map + 1, bar, BOX_D, h, n, b);
  };
  load(r.q(), mp.q, r.q_full(), q0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(r.empty(s), ((i / STAGES) & 1) ^ 1);
    load(r.k(s), mp.k, r.k_full(s), i * BN);
    load(r.v(s), mp.v, r.v_full(s), i * BN);
  }
}

// O += P V's k-step from the A fragment a: o's first 64 columns (all of
// them at D = 40 and 64) from the first slab's descriptor dv, and at
// D = 80 the last 16 from the second slab's, dv_tail
template <int HD>
__device__ __forceinline__ void pv_step(float (&o)[HD / 2],
                                        const uint32_t (&a)[4], uint64_t dv,
                                        uint64_t dv_tail) {
  if constexpr (has_tail<HD>()) {
    wgmma_pv(*reinterpret_cast<float(*)[BOX_D / 2]>(&o[0]), a, dv);
    wgmma_pv(*reinterpret_cast<float(*)[TAIL_D / 2]>(&o[BOX_D / 2]), a,
             dv_tail);
  } else {
    wgmma_pv(o, a, dv);
  }
}

// O += P V's k-steps K0 .. K1 - 1 from the stage's V tile at v, issued (the
// caller commits)
template <int HD, int K0, int K1>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[8][4],
                                         uint32_t v) {
  const uint64_t dv = sw128_desc(v);
  const uint64_t dv_tail = sw32_desc(v + SLAB);
#pragma unroll
  for (int kk = K0; kk < K1; ++kk)
    pv_step<HD>(o, pa[kk], dv + (2048 >> 4) * kk, dv_tail + (512 >> 4) * kk);
}

// one consumer warpgroup's 64 query rows: rows q0 + 64 c .. (head
// dimension HD)
template <int HD>
__device__ __forceinline__ void consume(const RingOf<HD>& r,
                                        bf16* __restrict__ out,
                                        float* __restrict__ lse, int N,
                                        int H, int n_tiles, int b, int h,
                                        int q0, float scale_log2) {
  constexpr int STAGES = RingOf<HD>::STAGES;
  // Q K^T's k-steps on the first slab (its columns past D are zeros)
  constexpr int S_STEPS = ((HD < BOX_D ? HD : BOX_D) + 15) / 16;
  const int c = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const uint64_t dq = sw128_desc(r.q() + c * 64 * BOX_D * 2);
  const uint64_t dq_tail = sw32_desc(r.q() + SLAB + c * 64 * TAIL_D * 2);

  // o: the m64nHD accumulator, lane 4 g + t holding o[4 j .. 4 j + 1] of
  // row g, columns 8 j + 2 t and + 1, and o[4 j + 2 .. 4 j + 3] of row g + 8
  float s[64], o[HD / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float alpha[2];
  uint32_t pa[8][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  // S = Q K^T of the stage's key tile, issued (the caller commits)
  auto issue_s = [&](int stage) {
    const uint64_t dk = sw128_desc(r.k(stage));
#pragma unroll
    for (int kk = 0; kk < S_STEPS; ++kk)
      wgmma_m64n128k16_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    if constexpr (has_tail<HD>())
      wgmma_m64n128k16_ss(s, dq_tail, sw32_desc(r.k(stage) + SLAB), 1);
  };

  mbar_wait(r.q_full(), 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    float neg_m[2], sum[2] = {0.f, 0.f};
    mbar_wait(r.k_full(st), ph);
    wgmma_fence();
    issue_s(st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    tile_max(s, m, alpha, neg_m, scale_log2);
    tile_exp<0>(s, pa, neg_m, sum, scale_log2);
    if constexpr (!split_pv<HD>()) tile_exp<1>(s, pa, neg_m, sum, scale_log2);
    rescale(o, alpha);
    mbar_wait(r.v_full(st), ph);
    fence_regs(o);
    if constexpr (split_pv<HD>()) {
      fence_half<0>(pa);
      wgmma_fence();
      issue_pv<HD, 0, 4>(o, pa, r.v(st));
      wgmma_commit();
      tile_exp<1>(s, pa, neg_m, sum, scale_log2);
      fence_half<1>(pa);
      wgmma_fence();
      issue_pv<HD, 4, 8>(o, pa, r.v(st));
    } else {
      fence_regs(pa);
      wgmma_fence();
      issue_pv<HD, 0, 8>(o, pa, r.v(st));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + sum[rr];
    // one lane a warp: the 8 consumer warps release the stage together
    if (lane == 0) mbar_arrive(r.empty(st));
  }

  // out and lse are contiguous (B, N, H, HD) and (B, H, N); lse is the
  // natural log: (m + log2 l) ln 2
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = 1.f / l[i];
  }
  const int row = q0 + 64 * c + 16 * warp + g;
  bf16* o_lo = out + (((long long)b * N + row) * H + h) * HD;
  bf16* o_hi = o_lo + (long long)8 * H * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int d = 8 * j + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(o_lo + d) =
        __floats2bfloat162_rn(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(o_hi + d) =
        __floats2bfloat162_rn(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
  }
  if (t == 0) {
    float* lse_row = lse + ((long long)b * H + h) * N + row;
    lse_row[0] = (m[0] + log2f(l[0])) * 0.69314718055994531f;
    lse_row[8] = (m[1] + log2f(l[1])) * 0.69314718055994531f;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_hopper_kernel(const __grid_constant__ Maps<HD> maps,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        int N, int H, float scale_log2) {
  extern __shared__ unsigned char smem[];
  const RingOf<HD> r{(smem_u32(smem) + 1023) & ~1023u};
  constexpr int STAGES = RingOf<HD>::STAGES;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int n_tiles = N / BN;
  if (threadIdx.x == 0) {
    mbar_init(r.q_full(), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.k_full(s), 1);
      mbar_init(r.v_full(s), 1);
      mbar_init(r.empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // no block-wide barrier below: the producer's idle threads leave
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) produce<HD>(r, maps, n_tiles, b, h, q0);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume<HD>(r, out, lse, N, H, n_tiles, b, h, q0, scale_log2);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps, launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query (the
// library links no libcuda); null where CUDA lacks it
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// error codes beyond cudaError_t's range
#define FLASH_BAD_SHAPE 100001
#define FLASH_TMA_ENCODE 100002
#define FLASH_NO_ENCODER 100003

struct MapKey {
  const void* p;
  int D, box, B, N, H;
  long long sb, sn, sh;
  bool operator==(const MapKey& o) const {
    return p == o.p && D == o.D && box == o.box && B == o.B && N == o.N &&
           H == o.H && sb == o.sb && sn == o.sn && sh == o.sh;
  }
};

// the tensor maps encoded so far, by (pointer, width, box, shape,
// strides): a training step's allocator hands the same buffers out step
// after step, and an encode costs about as much host time as a small
// call's kernel
constexpr int MAP_CACHE = 64;
struct {
  MapKey key[MAP_CACHE];
  CUtensorMap map[MAP_CACHE];
  int count = 0, next = 0;
  std::mutex mutex;
} maps;

// a (B, N, H, D) bf16 tensor with element strides (sb, sn, sh) and unit
// stride along D as a 4-D map (D, H, N, B) of {box, 1, 128, 1} boxes:
// box 64 with the 128-byte swizzle (at D < 64 the box's columns past D are
// out of bounds: TMA writes zeros there), or box 16 with the 32-byte
// swizzle (D = 80's second slab, loaded at column 64); 0 or an error code
int tensor_map(CUtensorMap* map, const void* p, int D, int box_d, int B,
               int N, int H, long long sb, long long sn, long long sh) {
  const MapKey key{p, D, box_d, B, N, H, sb, sn, sh};
  std::lock_guard<std::mutex> lock(maps.mutex);
  for (int i = 0; i < maps.count; ++i)
    if (maps.key[i] == key) {
      *map = maps.map[i];
      return 0;
    }
  EncodeTiled encode = encode_tiled();
  if (!encode) return FLASH_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sn * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_d, 1, BN, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_d == BOX_D ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return FLASH_TMA_ENCODE;
  int slot = maps.count < MAP_CACHE ? maps.count++ : maps.next;
  maps.next = (slot + 1) % MAP_CACHE;
  maps.key[slot] = key;
  maps.map[slot] = *map;
  return 0;
}

// what TMA takes: a 16-byte aligned base and strides of whole 16 bytes
bool tma_ok(const void* p, long long sb, long long sn, long long sh) {
  return (uintptr_t)p % 16 == 0 && sb % 8 == 0 && sn % 8 == 0 && sh % 8 == 0;
}

// the maps of Q, K and V, each given as its base and element strides
// (b, n, h), at width HD; 0 or an error code
template <int HD>
int make_maps(Maps<HD>* mp, const void* const (&p)[3],
              const long long (&s)[3][3], int B, int N, int H) {
  CUtensorMap* dst[3] = {mp->q, mp->k, mp->v};
  for (int i = 0; i < 3; ++i)
    for (int slab = 0; slab < Maps<HD>::SLABS; ++slab) {
      int rc = tensor_map(&dst[i][slab], p[i], HD, slab ? TAIL_D : BOX_D, B,
                          N, H, s[i][0], s[i][1], s[i][2]);
      if (rc) return rc;
    }
  return 0;
}

// one launch of the kernel at width HD
template <int HD>
int launch(const void* const (&p)[3], const long long (&s)[3][3], void* out,
           float* lse, int B, int N, int H, cudaStream_t stream) {
  constexpr int SMEM_BYTES = RingOf<HD>::SMEM_BYTES;
  Maps<HD> mp;
  int rc = make_maps<HD>(&mp, p, s, B, N, H);
  if (rc) return rc;
  // once a process for each width, not on every launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_hopper_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  flash_fwd_hopper_kernel<HD><<<dim3(N / BM, H, B), THREADS, SMEM_BYTES,
                                stream>>>(
      mp, (bf16*)out, lse, N, H, 1.4426950408889634f / sqrtf((float)HD));
  return cudaGetLastError();
}

// the kernel's launch facts at width HD (flash_fwd_hopper_info's order)
template <int HD>
int facts(int* info) {
  auto kernel = flash_fwd_hopper_kernel<HD>;
  constexpr int SMEM_BYTES = RingOf<HD>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      THREADS, SMEM_BYTES);
  const int f[7] = {has_tail<HD>() ? BOX_D + TAIL_D : BOX_D,
                    THREADS,
                    BM,
                    SMEM_BYTES,
                    blocks,
                    attr.numRegs,
                    (int)attr.localSizeBytes};
  for (int i = 0; i < 7; ++i) info[i] = f[i];
  return err;
}

}  // namespace

// q, k, v: (B, N, H, D) bf16, D = 40, 64 or 80, with element strides (b,
// n, h), unit stride along D, 16-byte aligned bases and strides of whole
// 16 bytes (else FLASH_BAD_SHAPE); out contiguous (B, N, H, D) bf16; lse
// contiguous (B, H, N) float32. N must be a multiple of 128.
extern "C" int flash_fwd_hopper(const void* q, const void* k, const void* v,
                                void* out, float* lse, int B, int N, int H,
                                int D, long long sqb, long long sqn,
                                long long sqh, long long skb, long long skn,
                                long long skh, long long svb, long long svn,
                                long long svh, void* stream_) {
  if ((D != 40 && D != 64 && D != 80) || N < BN || N % BN || B < 1 ||
      H < 1 || !tma_ok(q, sqb, sqn, sqh) || !tma_ok(k, skb, skn, skh) ||
      !tma_ok(v, svb, svn, svh))
    return FLASH_BAD_SHAPE;
  const void* const p[3] = {q, k, v};
  const long long s[3][3] = {
      {sqb, sqn, sqh}, {skb, skn, skh}, {svb, svn, svh}};
  const cudaStream_t stream = (cudaStream_t)stream_;
  if (D == 40) return launch<40>(p, s, out, lse, B, N, H, stream);
  if (D == 64) return launch<64>(p, s, out, lse, B, N, H, stream);
  return launch<80>(p, s, out, lse, B, N, H, stream);
}

// The kernel's launch facts for head dimension D (40, 64 or 80) and the
// type is_bf16, part 0 (the one kernel; FLASH_BAD_SHAPE elsewhere), in
// flash_attn.cu's flash_attn_fwd_info order: {tile width (the slabs'
// columns: 64, or 80 at D = 80), threads, query rows a block, dynamic
// shared-memory bytes, resident blocks an SM, registers a thread,
// local-memory bytes a thread}
extern "C" int flash_fwd_hopper_info(int D, int is_bf16, int part,
                                     int* info) {
  if (!is_bf16 || part != 0) return FLASH_BAD_SHAPE;
  if (D == 40) return facts<40>(info);
  if (D == 64) return facts<64>(info);
  if (D == 80) return facts<80>(info);
  return FLASH_BAD_SHAPE;
}
