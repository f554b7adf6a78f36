// Flash self-attention, forward and backward, for sm_90a.
//
// Replaces the TPU kernel behind dreamwaltz_g_tpu/guidance/layers.py
// `_flash_kernel` (the Pallas TPU flash_attention: forward, dq and dkv
// kernels): softmax(Q K^T / sqrt(D)) V over (B, N, H, D) without writing the
// N x N scores to device memory. Scores, the running max / sum and every
// accumulator are float32; `lse` (B, H, N) = row max + log(row sum) of the
// scaled scores, in natural log, is what the backward recomputes
// P = exp(S - lse) from.
//
// Bound: operations (4 B H N^2 D forward, 10 B H N^2 D backward against
// 2-byte operands read once). For the UNet's (2, 4096, 8, 40) forward that
// is 0.043 ms at the tensor cores' 989 TFLOP/s (NVIDIA H100 80GB HBM3 at its
// 700 W limit), but the B H N^2 = 268M exponentials set a floor above it: at
// 16 ex2 a clock an SM, ~0.07 ms on 132 SMs at ~1.7 GHz.
//
// bf16 forward, D <= 128 (the main path sends D = 40, 64 and 80 to
// csrc/flash_fwd_hopper.cu; the instantiations at widths 48, 64 and 80 stay
// for the other widths they cover and as its yardstick), FlashAttention-2
// on mma.sync:
//  * Each warp owns 16 query rows and every key of a 64-key tile. The
//    scores stay in their m16n8k16 accumulators; row max and row sum reduce
//    over the quad of lanes that holds a row (two shuffles); each exponent
//    is one FFMA (scale log2 e folded in) and one ex2, with the running max
//    in that log2 domain (lse goes back to the natural log at the end); the
//    row sums are per-lane partials, reduced once after the last tile; O is
//    rescaled by alpha in registers.
//  * P never leaves registers: the accumulator layout of 16 key columns is
//    the A-operand layout of P V, so each probability is rounded to bf16
//    once and packed in place.
//  * Fragments come through ldmatrix: Q's once per block, kept in registers;
//    K's by ldmatrix.x4 (two key n8-tiles a load); V's by ldmatrix.x4.trans
//    from the row-major [key][d] tile. Rows are padded by 8 elements, so the
//    row pitch is an odd number of 16-byte chunks (7, 11, 17 at the tile
//    widths 48, 80, 128) and the 8 row addresses of each 8 x 8 matrix fall on
//    8 different bank groups: no conflicts. An XOR swizzle would need rows of
//    a power-of-two count of chunks, which 48 and 80 are not.
//  * K and V stream through a ring of 2-3 stages in dynamic shared memory,
//    filled by 16-byte cp.async.cg copies: tile i + STAGES - 1 is in flight
//    while tile i's products run, with one __syncthreads a tile. Q travels
//    in the first copy group with key tile 0, so one wait covers both.
//    Columns D..DP-1 of Q and of every stage are zeroed once at block start.
//    A D that is not a multiple of 8, or a view that is not 16-byte
//    aligned, loads element by element, synchronously, into the same ring.
//  * Blocks of 8 warps (128 query rows) at tile widths 48 and 80, 4 warps
//    at 64 and 128 (`with_rows_config`); `flash_attn_fwd_info` reports each
//    one's shared memory, registers and resident blocks an SM.
//
// bf16 forward, D > 128 (the VAE encoder's mid block, (1, 4096, 1, 512),
// once a training step; 256 and 384 run zero-padded in the 512-wide tile):
// the same register-resident softmax, shaped for a wide head.
//  * A 16 x 512 float32 accumulator would be 256 registers a thread, so two
//    warps share 16 query rows and each holds one half of D (128 registers
//    of O). A block is 8 warps, 4 row groups x 2, 64 query rows.
//  * Each warp of a pair scores its own 16 keys of a 32-key tile over all
//    512 columns, so Q K^T is computed once. The pair trades its tile row
//    maxima (16 floats) and its bf16 P fragments (16 B a lane) through
//    shared memory under a 64-thread named barrier, so that both warps
//    hold the same running max and all 32 keys' P for their half of P V;
//    the row sums are traded once at the end. Scores never leave
//    registers. (Each warp scoring all 32 keys instead, with no exchange,
//    would compute Q K^T twice: 1.5x the mma.sync and 1.33x the ldmatrix
//    reads of a tile.)
//  * What bounds it is not the card's 0.035 ms of tensor work but the
//    traffic into and inside the SMs. With 16 query rows a block, each of
//    256 blocks would stream all of K and V (2 GiB of L2 reads a call); 64
//    rows a block cut that 4x. B H = 1 gives only
//    N / 64 = 64 such blocks for 132 SMs, so the key range is split in two:
//    128 blocks, each writing its normalised float32 partial O and its lse
//    to scratch that the wrapper allocates; flash_combine_kernel merges
//    them, rounding out to bf16 once. Inside the SM, the ldmatrix reads of
//    Q, K and V (~384 KB a key tile for the 8 warps, 3,072 clocks at 128
//    B a clock) and the 1,024 mma.sync of a tile are the computed floors.
//  * Q (64 x 520) is read from shared memory each tile (its fragments
//    would take another 128 registers); K and V come in 32-key tiles at
//    full depth through a 2-stage cp.async ring, 204 KB in all. The row
//    pitch of 520 elements (65 chunks of 16 B) keeps ldmatrix free of bank
//    conflicts, as at the narrow widths.
//
// float32 (the same TPU kernel, dreamwaltz_g_tpu/guidance/layers.py:153
// `_flash_kernel` via :174 `flash_self_attention`, at float32: the tiny
// stack, the float32 guidance, the parity mode): three-pass TF32 on the
// tensor cores, FlashAttention-2 shaped like the bf16 forward.
//  * Products. Each operand x splits into hi = tf32(x) (cvt.rna, 10
//    mantissa bits) and lo = tf32(x - hi); x - hi is exact, so x = hi + lo
//    to within 2^-22 |x|. Each product is lo hi + hi lo + hi hi on
//    mma.sync.m16n8k8 TF32, each partial product exact; the dropped lo lo
//    and the roundings of lo leave ~3 2^-22 of each product, against 2^-24
//    for CUDA-core float32. A single TF32 product (2^-11) misses the
//    float32 tolerances (1e-5 on out, 1e-4 of each gradient's largest);
//    three pass them with room (the plain twins in guidance/flash.py).
//  * Accumulator chains. The tensor cores add into a float32 accumulator
//    without rounding to nearest: over the 1,536 chained adds of a
//    4096-key row the bias passed 1e-5 on out at (2, 4096, 8, 40) (NVIDIA
//    H100 80GB HBM3). So each tile's P V (and
//    each backward tile's products) goes into registers of its own, and
//    the running sums take it with a round-to-nearest add (o = alpha o +
//    P V as one FFMA, where the rescale was anyway).
//  * Bound on this card: operations, 3 x 4 B H N^2 D forward at TF32's 495
//    TFLOP/s, i.e. float32 products at 165 TFLOP/s (0.26 ms at the UNet's
//    (2, 4096, 8, 40)), above the CUDA cores' 67 TFLOP/s (0.64 ms).
//  * Fragments. ldmatrix moves 16-bit elements and cannot transpose 32-bit
//    ones, so fragments come from float tiles by 32-bit loads. Rows are
//    padded by 4 floats: the pitch is 4 x an odd number of words, so the 8
//    rows x 4 columns of an A or B fragment, and the 4 row pairs x 8
//    columns of V's, fall on 32 different banks. Operands split as they
//    are loaded (Q, K, V and P alike).
//  * P without a shuffle. The scores' accumulator holds columns 2t, 2t + 1
//    of each 8-key slice, the A operand wants t, t + 4. P V sums over the
//    keys, so the k order inside a slice is free: k = t is key 2t, k = t + 4
//    key 2t + 1, and V's rows are read in that order (frag_b32_kn). The
//    backward takes P and dS into dV, dK and dQ the same way.
//  * Tiles. D <= 128 (tile widths 16, 40, 64, 80, 128): 4 row groups of 16
//    query rows a block, one warp each (two at width 64, see
//    with_tf32_fwd_config), 64-key tiles through a 2-stage cp.async ring. D > 128 (512; 256 and 384 zero-padded): 16 x 512 of O is
//    too many registers for a warp, so the DSPLIT warps of a row group take
//    slices of the depth, for both Q K^T (partial scores, summed through
//    shared memory in warp order by sum_partials, so every warp holds the
//    same scores and softmax) and O: 4 warps of 128 columns, 2 row groups,
//    32 rows a block, 16-key tiles (float32 tiles are twice bf16's: Q 66 KB
//    + the ring 132 KB + the exchange 8 KB). 128 blocks at (1, 4096, 1,
//    512) fill the card without splitting the keys.
//  * Exponent: ex2.approx.ftz in the log2 domain, as the bf16 forward
//    (~2^-22 relative); lse goes back to the natural log.
//
// A head dimension below its tile's width (40 in a 48-wide tile) is
// zero-padded in the shared-memory tiles only. Tensors are addressed by
// their own batch, row and head strides (unit stride along D), so a
// (B, N, H, D) view of a projection's output needs no copy.
//
// Backward, deterministic, with no atomics. `delta = rowsum(dO * O)` is a
// small kernel of its own; then P = exp(S - lse), dS = P (dP - delta),
// dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K, float32 accumulators;
// bf16 rounds P and dS to bf16 once each.
//  * float32 (three-pass TF32, as the forward): a dQ pass and a dK / dV pass
//    in one grid (the dK / dV blocks first, the heavier), each recomputing
//    S and dP (14 N^2 D, three products each), no scratch. Row groups and
//    D-split warps as in the forward: D <= 128, 4 groups of 16 rows, one
//    warp each (two at widths 64, 80 and 128), 32-row streamed
//    tiles; D = 512, one group of 8 warps of 64 columns, 16-row tiles (X1
//    and X2 66 KB, the ring 132 KB, the exchange of S and dP 16 KB). P and
//    dS stay in registers and enter the products as A operands in the
//    permuted k order.
//  * bf16, tile widths 48, 80, 128: two passes, one body. A
//    block that owns a query tile walks the key tiles and accumulates dQ; a
//    block that owns a key tile walks the query tiles and accumulates dK and
//    dV (the transposed products S^T = K Q^T and dP^T = V dO^T, so the same
//    fragment code serves both). Each pass recomputes S and dP: 14 N^2 D.
//  * bf16, D > 128 (the VAE's (1, 4096, 1, 512), once a training step; 256
//    and 384 zero-padded in the 512-wide tile): 10 N^2 D, no recompute.
//    flash_bwd_kv_wide_kernel owns 32 keys a block (N / 32 = 128 blocks at
//    the VAE's shape, one wave on 132 SMs) with K and V resident in shared
//    memory, and streams 32-query tiles of Q and dO through a 2-stage
//    cp.async ring (204 KB in all, 1 block an SM). dK and dV for 32 keys x
//    512 in float32 are 128 KB of registers: 8 warps of 32 keys x 64
//    columns, 128 registers a thread. The tile's scores S^T and dP^T (32 x
//    32 each, full depth) are 8 blocks of 16 x 16, one a warp: the warp that
//    forms P hands it in float32 to the warp of the same block that forms
//    dS, under a 64-thread named barrier; both round to bf16 into shared
//    memory as P^T and dS^T [key][query], the A operands of the products.
//    The pass writes dS^T to (B H, N, N) bf16 scratch from the wrapper
//    (32 MiB at the VAE's shape), and flash_bwd_dq_wide_kernel computes
//    dQ = scale dS K as a tiled product (128 x 128 a block, a 3-stage
//    ring; dS^T and K are both k-major, so both operands come through
//    ldmatrix.trans). This is instead of a dQ pass that recomputes S and
//    dP (14 N^2 D): the scratch costs 2 N^2 bytes written and read, far
//    below the 4 N^2 D operations it saves. Computed floors (no profiler
//    of the SMs on the card's machine): the dK / dV pass's ldmatrix reads,
//    ~360 KB a query tile a block (K and V rows read again by the warps of
//    each score block), ~2,800 clocks at 128 B a clock, against ~1,500 for
//    its 1,024 mma.sync; over 128 tiles ~0.2 ms at ~1.75 GHz. Q and dO
//    stream from L2 once a key block: 1 GiB a call.
//
// The C functions launch on the given stream, do not synchronise or
// allocate, and return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 128;
constexpr int PAD = 8;  // bf16 elements of row padding in shared memory

struct Strides {
  long long b, n, h;
};

__device__ __forceinline__ long long offset(const Strides& s, int b, int n,
                                            int h) {
  return (long long)b * s.b + (long long)n * s.n + (long long)h * s.h;
}

// ---------------------------------------------------------------------------
// tensor-core fragments (mma.sync.m16n8k16, bf16 x bf16 -> float32)
// lane = 4 g + t. A (16 x 16, row): a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 8),
// a3 (g + 8, 2t + 8), two consecutive columns each. B (16 x 8, col): b0
// (k = 2t, n = g), b1 (k = 2t + 8, n = g), two consecutive k each. C (16 x 8):
// c0, c1 (g, 2t), (g, 2t + 1); c2, c3 (g + 8, 2t), (g + 8, 2t + 1).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(const bf16* lo, const bf16* hi) {
  return (uint32_t) * reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t) * reinterpret_cast<const uint16_t*>(hi) << 16);
}

// rows r0.. of a row-major tile X[row][ld], columns k0..k0+15
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* X, int ld,
                                       int r0, int k0, int g, int t) {
  const bf16* p = X + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B[k][n] = Y[n0 + n][k0 + k]: the product with Y transposed
__device__ __forceinline__ void frag_b_nt(uint32_t (&b)[2], const bf16* Y,
                                          int ld, int n0, int k0, int g,
                                          int t) {
  const bf16* p = Y + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B[k][n] = Y[k0 + k][n0 + n]: the product with Y as it lies
__device__ __forceinline__ void frag_b_nn(uint32_t (&b)[2], const bf16* Y,
                                          int ld, int k0, int n0, int g,
                                          int t) {
  const bf16* p = Y + (k0 + 2 * t) * ld + n0 + g;
  b[0] = pack(p, p + ld);
  b[1] = pack(p + 8 * ld, p + 9 * ld);
}

// `rows` rows of D values from device memory into a [rows][DP + PAD] tile,
// columns D..DP-1 zero, by a block of NTH threads. `vec`: D, the row stride
// and the base address are multiples of 8 elements, so rows move as 16-byte
// words.
template <int DP, int NTH = THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int rows,
                                          int D, bool vec) {
  constexpr int LD = DP + PAD;
  if (vec) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < rows * CH; i += NTH) {
      int r = i / CH, c = (i % CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c < D) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += NTH) {
      int r = i / DP, c = i % DP;
      dst[r * LD + c] = c < D ? src[r * row_stride + c] : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// bf16 forward, row split (D <= 128): each warp owns 16 query rows and every
// key of a tile; scores, softmax and P stay in registers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  const uint32_t b[2] = {b0, b1};
  mma_bf16(c, a, b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8 x 8 bf16 matrices, lanes 8 i..8 i + 7 giving the row addresses of
// matrix i; lane 4 g + t receives row g, columns 2 t and 2 t + 1 of each
// (of each transposed matrix with .trans)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

// The row maxima of a warp's 16 x (8 NT) scores s, held as C fragments
// (rows g and g + 8 of the lane), reduced over the quad that holds a row.
template <int NT>
__device__ __forceinline__ void tile_row_max(const float (&s)[NT][4],
                                             float (&mx)[2]) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
}

// One key tile's online softmax on a warp's 16 x (8 NT) scores s, given the
// tile's row maxima mx (unscaled). m: the running row maxima in the log2
// domain of the scaled scores; l: this lane's partial row sums. The tile's
// P = 2^(scale_log2 s - m) comes back as the A fragments of P V (the C
// layout of key columns 16 j..16 j + 15 is the A layout), each value
// rounded to bf16 once; o and l are rescaled by alpha = 2^(m_old - m_new).
template <int NT, int ND>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4],
                                               float (&o)[ND][4],
                                               uint32_t (&pa)[NT / 2][4],
                                               float (&m)[2], float (&l)[2],
                                               const float (&mx)[2],
                                               float scale_log2) {
  float alpha[2], neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the first tile: m = -inf, so alpha = 2^-inf = 0
    float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float p0 = ex2(fmaf(s[j][0], scale_log2, neg_m[0]));
    float p1 = ex2(fmaf(s[j][1], scale_log2, neg_m[0]));
    float p2 = ex2(fmaf(s[j][2], scale_log2, neg_m[1]));
    float p3 = ex2(fmaf(s[j][3], scale_log2, neg_m[1]));
    sum[0] += p0 + p1;
    sum[1] += p2 + p3;
    // key slice j / 2: a0 / a1 from n8-tile 2 (j / 2), a2 / a3 from the next
    pa[j / 2][2 * (j & 1)] = pack_bf16(p0, p1);
    pa[j / 2][2 * (j & 1) + 1] = pack_bf16(p2, p3);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most `n` of this thread's committed copy groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// load_tile's `vec` case as asynchronous copies: columns D..DP-1 are left
// as they are
template <int DP, int NTH>
__device__ __forceinline__ void copy_tile_async(bf16* dst, const bf16* src,
                                                long long row_stride,
                                                int rows, int D) {
  constexpr int LD = DP + PAD, CH = DP / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NTH) {
    int r = i / CH, c = (i % CH) * 8;
    if (c < D) cp_async16(dst + r * LD + c, src + r * row_stride + c);
  }
}

// the Q tile, then a ring of STAGES K tiles and STAGES V tiles
template <int DP, int WARPS, int BN, int STAGES>
struct RowFwdSmem {
  static constexpr int BM = 16 * WARPS;
  static constexpr int LD = DP + PAD;
  static constexpr int TILE = BN * LD;  // elements of one K or V stage
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * BM * LD;
  static constexpr size_t v = k + sizeof(bf16) * STAGES * TILE;
  static constexpr size_t bytes = v + sizeof(bf16) * STAGES * TILE;
};

template <int DP, int WARPS, int BN, int STAGES>
__global__ void __launch_bounds__(32 * WARPS)
flash_fwd_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int N, int H, int D,
                      Strides sq, Strides sk, Strides sv, float scale_log2,
                      bool vec) {
  static_assert(STAGES >= 2, "tile j + 1 loads while tile j is used");
  constexpr int NTH = 32 * WARPS;
  using L = RowFwdSmem<DP, WARPS, BN, STAGES>;
  constexpr int BM = L::BM, LD = L::LD, TILE = L::TILE;
  constexpr int NT = BN / 8;   // score n8-tiles
  constexpr int ND = DP / 8;   // output n8-tiles
  constexpr int KQ = DP / 16;  // k16 steps of Q K^T
  constexpr int KP = BN / 16;  // k16 steps of P V
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;

  // each lane's ldmatrix row address. Q (A operand) and V (B operand of
  // P V, transposed): matrices (rows 0-7, 8-15) x (columns 0-7, 8-15) in
  // that order; K (B operand of Q K^T): (keys 0-7, 8-15) x (columns 0-7,
  // 8-15) in the other order, so that one x4 gives two key n8-tiles
  const uint32_t q_lane =
      smem_addr(Qs + (r0 + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t k_lane = smem_addr(
      Ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8);
  const uint32_t v_lane = smem_addr(Vs + (lane & 15) * LD + (lane >> 4) * 8);

  // key tile `tile` into ring stage `stage`: asynchronous 16-byte copies,
  // or the element-wise load (synchronous, padding included)
  const int n_tiles = N / BN;
  auto load_kv = [&](int stage, int tile) {
    const bf16* k_src = k + offset(sk, b, tile * BN, h);
    const bf16* v_src = v + offset(sv, b, tile * BN, h);
    if (vec) {
      copy_tile_async<DP, NTH>(Ks + stage * TILE, k_src, sk.n, BN, D);
      copy_tile_async<DP, NTH>(Vs + stage * TILE, v_src, sv.n, BN, D);
    } else {
      load_tile<DP, NTH>(Ks + stage * TILE, k_src, sk.n, BN, D, false);
      load_tile<DP, NTH>(Vs + stage * TILE, v_src, sv.n, BN, D, false);
    }
  };
  // the copies never write columns D..DP-1: zero them once in Q and in
  // every K and V stage (Q, the K ring and the V ring lie back to back,
  // BM + 2 STAGES BN rows)
  if (vec && D < DP) {
    const int tail = (DP - D) / 8;
    for (int i = threadIdx.x; i < (BM + 2 * STAGES * BN) * tail; i += NTH) {
      int r = i / tail, c = D + (i % tail) * 8;
      *reinterpret_cast<uint4*>(Qs + r * LD + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // Q and key tile 0 in the first commit group, tiles 1..STAGES-2 in one
  // group each (empty past the end)
  if (vec)
    copy_tile_async<DP, NTH>(Qs, q + offset(sq, b, q0, h), sq.n, BM, D);
  else
    load_tile<DP, NTH>(Qs, q + offset(sq, b, q0, h), sq.n, BM, D, false);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(st, st);
    cp_async_commit();
  }

  cp_async_wait<STAGES - 2>();  // the first group: Q and tile 0
  __syncthreads();
  uint32_t qa[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) ldsm_x4(qa[kk], q_lane + 32 * kk);

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  int rd = 0, wr = STAGES - 1;  // ring stages read and filled this tile
  for (int i = 0; i < n_tiles; ++i) {
    // tile i's group is complete once at most STAGES - 2 younger ones are
    // in flight; the barrier makes every thread's copies visible and shows
    // that every warp is done with tile i - 1, whose stage is wr
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < n_tiles) load_kv(wr, i + STAGES - 1);
    cp_async_commit();
    const uint32_t k_tile = k_lane + 2 * rd * TILE;
    const uint32_t v_tile = v_lane + 2 * rd * TILE;
    rd = rd + 1 == STAGES ? 0 : rd + 1;
    wr = wr + 1 == STAGES ? 0 : wr + 1;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, k_tile + 2 * (8 * j * LD + 16 * kk));
        mma_bf16(s[j], qa[kk], kb[0], kb[1]);
        mma_bf16(s[j + 1], qa[kk], kb[2], kb[3]);
      }

    uint32_t pa[KP][4];
    float mx[2];
    tile_row_max(s, mx);
    online_softmax(s, o, pa, m, l, mx, scale_log2);

#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, v_tile + 2 * (16 * kk * LD + 8 * j));
        mma_bf16(o[j], pa[kk], vb[0], vb[1]);
        mma_bf16(o[j + 1], pa[kk], vb[2], vb[3]);
      }
  }

  // out and lse are contiguous (B, N, H, D) and (B, H, N); lse is the
  // natural log: (m + log2 l) ln 2
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / l[r];
  }
  bf16* o_lo = out + (((long long)b * N + q0 + r0 + g) * H + h) * D;
  bf16* o_hi = o_lo + (long long)8 * H * D;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    int d = 8 * j + 2 * t;
    if (d + 1 < D && !(D & 1)) {
      *reinterpret_cast<__nv_bfloat162*>(o_lo + d) =
          __floats2bfloat162_rn(o[j][0] * inv[0], o[j][1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(o_hi + d) =
          __floats2bfloat162_rn(o[j][2] * inv[1], o[j][3] * inv[1]);
    } else {
      if (d < D) {
        o_lo[d] = __float2bfloat16(o[j][0] * inv[0]);
        o_hi[d] = __float2bfloat16(o[j][2] * inv[1]);
      }
      if (d + 1 < D) {
        o_lo[d + 1] = __float2bfloat16(o[j][1] * inv[0]);
        o_hi[d + 1] = __float2bfloat16(o[j][3] * inv[1]);
      }
    }
  }
  if (t == 0) {
    float* lse_row = lse + ((long long)b * H + h) * N + q0 + r0 + g;
    lse_row[0] = (m[0] + log2f(l[0])) * 0.69314718055994531f;
    lse_row[8] = (m[1] + log2f(l[1])) * 0.69314718055994531f;
  }
}

// ---------------------------------------------------------------------------
// bf16 forward, wide heads (D > 128, tile width 512): a pair of warps per 16
// query rows, one half of D each; each computes the scores of half the keys
// of a tile, and the pair trades row maxima and probabilities; a key range
// per block, partial outputs merged by flash_combine_kernel
// ---------------------------------------------------------------------------

constexpr int WIDE_WARPS = 8;  // 4 row groups x 2 halves (of D, of a tile)
constexpr int MAX_SPLITS = 4;  // key ranges a call, at most

// the Q tile, a ring of STAGES K tiles and STAGES V tiles, then each warp
// pair's exchange: row maxima or sums (float [4][2][16]) and P fragments
// (uint4 [4][2][32])
template <int DP, int BN, int STAGES>
struct WideFwdSmem {
  static constexpr int BM = 16 * WIDE_WARPS / 2;
  static constexpr int LD = DP + PAD;
  static constexpr int TILE = BN * LD;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * BM * LD;
  static constexpr size_t v = k + sizeof(bf16) * STAGES * TILE;
  static constexpr size_t rows = v + sizeof(bf16) * STAGES * TILE;
  static constexpr size_t p = rows + sizeof(float) * WIDE_WARPS * 16;
  static constexpr size_t bytes = p + sizeof(uint4) * WIDE_WARPS * 32;
};

// the two warps of row group `pair` (warps pair and pair + 4): bar.sync on
// named barrier 1 + pair, 64 threads
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
}

// o += P V for one k16 step: P the A fragments of 16 keys, V those keys'
// rows from the ldmatrix address vb0 on, 8 ND columns
template <int ND>
__device__ __forceinline__ void pv_16(float (&o)[ND][4],
                                      const uint32_t (&pa)[4], uint32_t vb0) {
#pragma unroll
  for (int j = 0; j < ND; j += 2) {
    uint32_t vb[4];
    ldsm_x4_trans(vb, vb0 + 2 * 8 * j);
    mma_bf16(o[j], pa, vb[0], vb[1]);
    mma_bf16(o[j + 1], pa, vb[2], vb[3]);
  }
}

// Block (query tile, head, batch x splits + split) walks keys split N /
// splits .. (split + 1) N / splits - 1 and writes, for its 64 rows, the
// normalised partial output to o_part (splits, B, N, H, D) and the partial
// lse (natural log) to lse_part (splits, B, H, N), both float32. Warp
// (row group rg, half w) scores keys 16 w..16 w + 15 of each 32-key tile
// and accumulates columns w DP / 2.. of O.
template <int DP, int BN, int STAGES>
__global__ void __launch_bounds__(32 * WIDE_WARPS, 1)
flash_fwd_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, float* __restrict__ o_part,
                      float* __restrict__ lse_part, int N, int H, int D,
                      int splits, Strides sq, Strides sk, Strides sv,
                      float scale_log2, bool vec) {
  static_assert(STAGES >= 2, "tile j + 1 loads while tile j is used");
  static_assert(BN == 32, "two warps, 16 keys each");
  constexpr int NTH = 32 * WIDE_WARPS;
  using L = WideFwdSmem<DP, BN, STAGES>;
  constexpr int BM = L::BM, LD = L::LD, TILE = L::TILE;
  constexpr int DW = DP / 2;       // output columns a warp
  constexpr int ND = DW / 8;       // output n8-tiles a warp
  constexpr int KQ = DP / 16;      // k16 steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);

  const int B = gridDim.z / splits;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int h = blockIdx.y, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int pair = warp % 4, w = warp / 4;
  const int r0 = pair * 16, d0 = w * DW;
  const int keys = N / splits, key0 = split * keys;
  // this warp's and its partner's slots of the pair exchange
  float* rows_mine = reinterpret_cast<float*>(smem + L::rows) + warp * 16;
  float* rows_other =
      reinterpret_cast<float*>(smem + L::rows) + (warp ^ 4) * 16;
  uint4* p_mine = reinterpret_cast<uint4*>(smem + L::p) + warp * 32 + lane;
  uint4* p_other =
      reinterpret_cast<uint4*>(smem + L::p) + (warp ^ 4) * 32 + lane;

  // ldmatrix row addresses as in flash_fwd_rows_kernel: K at this warp's 16
  // keys, V at this warp's half of D (its own keys' rows, then the other's)
  const uint32_t q_lane =
      smem_addr(Qs + (r0 + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t k_lane = smem_addr(
      Ks + (16 * w + (lane & 7) + ((lane >> 4) << 3)) * LD +
      ((lane >> 3) & 1) * 8);
  const uint32_t v_mine =
      smem_addr(Vs + (16 * w + (lane & 15)) * LD + d0 + (lane >> 4) * 8);
  const uint32_t v_other =
      smem_addr(Vs + (16 * (1 - w) + (lane & 15)) * LD + d0 + (lane >> 4) * 8);

  const int n_tiles = keys / BN;
  auto load_kv = [&](int stage, int tile) {
    const bf16* k_src = k + offset(sk, b, key0 + tile * BN, h);
    const bf16* v_src = v + offset(sv, b, key0 + tile * BN, h);
    if (vec) {
      copy_tile_async<DP, NTH>(Ks + stage * TILE, k_src, sk.n, BN, D);
      copy_tile_async<DP, NTH>(Vs + stage * TILE, v_src, sv.n, BN, D);
    } else {
      load_tile<DP, NTH>(Ks + stage * TILE, k_src, sk.n, BN, D, false);
      load_tile<DP, NTH>(Vs + stage * TILE, v_src, sv.n, BN, D, false);
    }
  };
  // columns D..DP-1 of Q and of every stage, zeroed once
  if (vec && D < DP) {
    const int tail = (DP - D) / 8;
    for (int i = threadIdx.x; i < (BM + 2 * STAGES * BN) * tail; i += NTH) {
      int r = i / tail, c = D + (i % tail) * 8;
      *reinterpret_cast<uint4*>(Qs + r * LD + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (vec)
    copy_tile_async<DP, NTH>(Qs, q + offset(sq, b, q0, h), sq.n, BM, D);
  else
    load_tile<DP, NTH>(Qs, q + offset(sq, b, q0, h), sq.n, BM, D, false);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(st, st);
    cp_async_commit();
  }

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  int rd = 0, wr = STAGES - 1;
  for (int i = 0; i < n_tiles; ++i) {
    // the barrier also orders the pair exchange: every read of tile i - 1's
    // slots is done before tile i writes them
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < n_tiles) load_kv(wr, i + STAGES - 1);
    cp_async_commit();
    const uint32_t k_tile = k_lane + 2 * rd * TILE;
    const uint32_t stage = 2 * rd * TILE;
    rd = rd + 1 == STAGES ? 0 : rd + 1;
    wr = wr + 1 == STAGES ? 0 : wr + 1;

    // this warp's 16 rows x 16 keys over the full depth
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t qa[4], kb[4];
      ldsm_x4(qa, q_lane + 32 * kk);
      ldsm_x4(kb, k_tile + 32 * kk);
      mma_bf16(s[0], qa, kb[0], kb[1]);
      mma_bf16(s[1], qa, kb[2], kb[3]);
    }

    // the tile's row maxima over both warps' keys, the same in both
    float mx[2], mx_other[2];
    tile_row_max(s, mx);
    if (t == 0) {
      rows_mine[g] = mx[0];
      rows_mine[g + 8] = mx[1];
    }
    pair_sync(pair);
    mx_other[0] = rows_other[g];
    mx_other[1] = rows_other[g + 8];
    mx[0] = fmaxf(mx[0], mx_other[0]);
    mx[1] = fmaxf(mx[1], mx_other[1]);

    uint32_t pa[1][4], pa_other[4];
    online_softmax(s, o, pa, m, l, mx, scale_log2);
    *p_mine = make_uint4(pa[0][0], pa[0][1], pa[0][2], pa[0][3]);
    pair_sync(pair);
    const uint4 x = *p_other;
    pa_other[0] = x.x;
    pa_other[1] = x.y;
    pa_other[2] = x.z;
    pa_other[3] = x.w;

    pv_16(o, pa[0], v_mine + stage);
    pv_16(o, pa_other, v_other + stage);
  }

  // row sums: this lane's partials over the quad, then the two warps' keys
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
  __syncthreads();
  if (t == 0) {
    rows_mine[g] = l[0];
    rows_mine[g + 8] = l[1];
  }
  pair_sync(pair);
  l[0] += rows_other[g];
  l[1] += rows_other[g + 8];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / l[r];
  const long long row = (long long)(split * B + b) * N + q0 + r0 + g;
  float* o_lo = o_part + (row * H + h) * D;
  float* o_hi = o_lo + (long long)8 * H * D;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    int d = d0 + 8 * j + 2 * t;
    if (d + 1 < D && !(D & 1)) {
      *reinterpret_cast<float2*>(o_lo + d) =
          make_float2(o[j][0] * inv[0], o[j][1] * inv[0]);
      *reinterpret_cast<float2*>(o_hi + d) =
          make_float2(o[j][2] * inv[1], o[j][3] * inv[1]);
    } else {
      if (d < D) {
        o_lo[d] = o[j][0] * inv[0];
        o_hi[d] = o[j][2] * inv[1];
      }
      if (d + 1 < D) {
        o_lo[d + 1] = o[j][1] * inv[0];
        o_hi[d + 1] = o[j][3] * inv[1];
      }
    }
  }
  // both warps of a pair hold the same row state; the first writes it
  if (t == 0 && w == 0) {
    float* lse_row = lse_part + ((long long)(split * B + b) * H + h) * N +
                     q0 + r0 + g;
    lse_row[0] = (m[0] + log2f(l[0])) * 0.69314718055994531f;
    lse_row[8] = (m[1] + log2f(l[1])) * 0.69314718055994531f;
  }
}

// lse = log sum_s exp(lse_s) and out = sum_s exp(lse_s - lse) O_s, rounded
// to bf16 once: one warp a (b, n, h) row; out contiguous (B, N, H, D), lse
// (B, H, N)
__global__ void __launch_bounds__(THREADS)
flash_combine_kernel(const float* __restrict__ o_part,
                     const float* __restrict__ lse_part,
                     bf16* __restrict__ out, float* __restrict__ lse, int B,
                     int N, int H, int D, int splits) {
  const long long rows = (long long)B * N * H;
  const long long row =
      (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int h = (int)(row % H);
  const long long bn = row / H;
  const int n = (int)(bn % N), b = (int)(bn / N);
  const long long at = ((long long)b * H + h) * N + n;
  // the loops run to MAX_SPLITS so that w stays in registers
  float w[MAX_SPLITS], mx = -INFINITY, sum = 0.f;
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s) {
    w[s] = s < splits ? lse_part[s * rows + at] : -INFINITY;
    mx = fmaxf(mx, w[s]);
  }
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s)
    sum += s < splits ? expf(w[s] - mx) : 0.f;
  const float lse_row = mx + logf(sum);
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s)
    w[s] = s < splits ? expf(w[s] - lse_row) : 0.f;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < splits) acc = fmaf(w[s], o_part[(s * rows + row) * D + d], acc);
    out[row * D + d] = __float2bfloat16(acc);
  }
  if (lane == 0) lse[at] = lse_row;
}

// ---------------------------------------------------------------------------
// bf16 backward, D <= 128: one body for the dQ pass (KV = false: the block
// owns a query tile, X1 = Q, X2 = dO, and streams Y1 = K, Y2 = V) and the
// dK / dV pass (KV = true: the block owns a key tile, X1 = K, X2 = V, and
// streams Y1 = Q, Y2 = dO). With S' = X1 Y1^T and dP' = X2 Y2^T (transposed
// in the KV pass): P' = exp(scale S' - lse), dS' = P' (dP' - delta), lse and
// delta indexed by the query, which is the row (dQ pass) or the column (KV
// pass).
// Then acc1 += dS' Y1 (dQ or dK, times scale at the end) and, in the KV
// pass, acc2 += P' Y2 (dV).
// ---------------------------------------------------------------------------

template <int DP, int BN>
struct BwdSmem {
  static constexpr int BM = 16 * (THREADS / 32);
  static constexpr int LD = DP + PAD;
  static constexpr int LDT = BN + PAD;
  static constexpr int NV = BM > BN ? BM : BN;
  static constexpr size_t x1 = 0;
  static constexpr size_t x2 = x1 + sizeof(bf16) * BM * LD;
  static constexpr size_t y1 = x2 + sizeof(bf16) * BM * LD;
  static constexpr size_t y2 = y1 + sizeof(bf16) * BN * LD;
  static constexpr size_t t1 = y2 + sizeof(bf16) * BN * LD;
  static constexpr size_t t2 = t1 + sizeof(bf16) * BM * LDT;
  static constexpr size_t vecs = t2 + sizeof(bf16) * BM * LDT;
  static constexpr size_t bytes = vecs + sizeof(float) * 2 * NV;
};

template <int DP, int BN, bool KV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_bf16_kernel(const bf16* __restrict__ x1, const bf16* __restrict__ x2,
                      const bf16* __restrict__ y1, const bf16* __restrict__ y2,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ g1,
                      bf16* __restrict__ g2, int N, int H, int D, Strides sx1,
                      Strides sx2, Strides sy1, Strides sy2, float scale,
                      bool vec) {
  using L = BwdSmem<DP, BN>;
  constexpr int BM = L::BM, LD = L::LD, LDT = L::LDT;
  constexpr int NT = BN / 8;
  constexpr int ND = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X1s = reinterpret_cast<bf16*>(smem + L::x1);
  bf16* X2s = reinterpret_cast<bf16*>(smem + L::x2);
  bf16* Y1s = reinterpret_cast<bf16*>(smem + L::y1);
  bf16* Y2s = reinterpret_cast<bf16*>(smem + L::y2);
  bf16* T1s = reinterpret_cast<bf16*>(smem + L::t1);  // dS'
  bf16* T2s = reinterpret_cast<bf16*>(smem + L::t2);  // P'
  float* v_lse = reinterpret_cast<float*>(smem + L::vecs);
  float* v_delta = v_lse + L::NV;

  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;  // each warp: 16 owned rows, every column
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* delta_bh = delta + ((long long)b * H + h) * N;

  load_tile<DP>(X1s, x1 + offset(sx1, b, m0, h), sx1.n, BM, D, vec);
  load_tile<DP>(X2s, x2 + offset(sx2, b, m0, h), sx2.n, BM, D, vec);
  if (!KV && threadIdx.x < BM) {
    v_lse[threadIdx.x] = lse_bh[m0 + threadIdx.x];
    v_delta[threadIdx.x] = delta_bh[m0 + threadIdx.x];
  }
  float acc1[ND][4], acc2[KV ? ND : 1][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc1[j][e] = 0.f;
      if constexpr (KV) acc2[j][e] = 0.f;
    }

  for (int n0 = 0; n0 < N; n0 += BN) {
    __syncthreads();
    load_tile<DP>(Y1s, y1 + offset(sy1, b, n0, h), sy1.n, BN, D, vec);
    load_tile<DP>(Y2s, y2 + offset(sy2, b, n0, h), sy2.n, BN, D, vec);
    if (KV && threadIdx.x < BN) {
      v_lse[threadIdx.x] = lse_bh[n0 + threadIdx.x];
      v_delta[threadIdx.x] = delta_bh[n0 + threadIdx.x];
    }
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < DP; k0 += 16) {
      uint32_t a1[4], a2[4];
      frag_a(a1, X1s, LD, r0, k0, g, t);
      frag_a(a2, X2s, LD, r0, k0, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bb[2];
        frag_b_nt(bb, Y1s, LD, 8 * j, k0, g, t);
        mma_bf16(s[j], a1, bb);
        frag_b_nt(bb, Y2s, LD, 8 * j, k0, g, t);
        mma_bf16(dp[j], a2, bb);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int row = r0 + g + (e >= 2 ? 8 : 0);
        int col = 8 * j + 2 * t + (e & 1);
        int qi = KV ? col : row;
        float p = __expf(s[j][e] * scale - v_lse[qi]);
        float ds = p * (dp[j][e] - v_delta[qi]);
        T1s[row * LDT + col] = __float2bfloat16(ds);
        if constexpr (KV) T2s[row * LDT + col] = __float2bfloat16(p);
      }
    __syncthreads();

#pragma unroll
    for (int k0 = 0; k0 < BN; k0 += 16) {
      uint32_t a[4];
      frag_a(a, T1s, LDT, r0, k0, g, t);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        uint32_t bb[2];
        frag_b_nn(bb, Y1s, LD, k0, 8 * j, g, t);
        mma_bf16(acc1[j], a, bb);
      }
      if constexpr (KV) {
        frag_a(a, T2s, LDT, r0, k0, g, t);
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          uint32_t bb[2];
          frag_b_nn(bb, Y2s, LD, k0, 8 * j, g, t);
          mma_bf16(acc2[j], a, bb);
        }
      }
    }
  }

  // gradients are contiguous (B, N, H, D)
  long long lo = (((long long)b * N + m0 + r0 + g) * H + h) * D;
  long long hi = lo + (long long)8 * H * D;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int d = 8 * j + 2 * t + e;
      if (d < D) {
        g1[lo + d] = __float2bfloat16(acc1[j][e] * scale);
        g1[hi + d] = __float2bfloat16(acc1[j][e + 2] * scale);
        if constexpr (KV) {
          g2[lo + d] = __float2bfloat16(acc2[j][e]);
          g2[hi + d] = __float2bfloat16(acc2[j][e + 2]);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// bf16 backward, wide heads (D > 128, tile width 512): a dK / dV pass that
// also writes dS^T to scratch, then the product dQ = scale dS K
// ---------------------------------------------------------------------------

constexpr int BWD_WARPS = 8;
constexpr int BK_WIDE = 32;  // keys a dK / dV block owns
constexpr int BQ_WIDE = 32;  // queries a streamed tile

// K and V (resident), a ring of STAGES Q tiles and STAGES dO tiles, the
// tile's bf16 P^T and dS^T [key][query], each warp pair's float32 P
// exchange (float [4][32 lanes][8]), and each stage's lse and delta
template <int DP, int STAGES>
struct WideBwdSmem {
  static constexpr int LD = DP + PAD;
  static constexpr int LDP = BQ_WIDE + PAD;
  static constexpr int TILE = BQ_WIDE * LD;  // elements of one Q or dO stage
  static constexpr size_t k = 0;
  static constexpr size_t v = k + sizeof(bf16) * BK_WIDE * LD;
  static constexpr size_t q = v + sizeof(bf16) * BK_WIDE * LD;
  static constexpr size_t d_out = q + sizeof(bf16) * STAGES * TILE;
  static constexpr size_t pt = d_out + sizeof(bf16) * STAGES * TILE;
  static constexpr size_t dst = pt + sizeof(bf16) * BK_WIDE * LDP;
  static constexpr size_t xch = dst + sizeof(bf16) * BK_WIDE * LDP;
  static constexpr size_t vecs = xch + sizeof(float) * 4 * 32 * 8;
  static constexpr size_t bytes = vecs + sizeof(float) * STAGES * 2 * BQ_WIDE;
};

// Block (key tile, head, batch) owns keys k0..k0 + 31 and walks every query
// tile of 32. Scores: warp (mat, blk) computes a 16 x 16 block, keys
// 16 (blk / 2).., queries 16 (blk % 2).., of S^T = K Q^T (mat 0) or
// dP^T = V dO^T (mat 1) over the full depth. The S^T warp turns its block
// into P = exp(scale S - lse) and hands it, in float32, to the dP^T warp of
// the same block (warps blk and blk + 4, a named barrier), which forms
// dS = P (dP - delta). Both write bf16 tiles [key][query] to shared
// memory, P^T and dS^T, each value rounded once. Products: warp w owns
// columns 64 w..64 w + 63 of dV += P^T dO and dK += dS^T Q for all 32 keys.
// dS^T goes on to ds (B H, N keys, N queries) for flash_bwd_dq_wide_kernel.
template <int DP, int STAGES>
__global__ void __launch_bounds__(32 * BWD_WARPS, 1)
flash_bwd_kv_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ d_out,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, bf16* __restrict__ ds, int N,
                         int H, int D, Strides sq, Strides sk, Strides sv,
                         Strides sd, float scale, bool vec) {
  static_assert(STAGES >= 2, "tile j + 1 loads while tile j is used");
  constexpr int NTH = 32 * BWD_WARPS;
  using L = WideBwdSmem<DP, STAGES>;
  constexpr int LD = L::LD, LDP = L::LDP, TILE = L::TILE;
  constexpr int BK = BK_WIDE, BQ = BQ_WIDE;
  constexpr int KD = DP / 16;          // k16 steps of the scores
  constexpr int DW = DP / BWD_WARPS;   // dK / dV columns a warp
  constexpr int ND = DW / 8;           // their n8-tiles
  static_assert(BK == 32 && BQ == 32, "four 16 x 16 score blocks a matrix");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Gs = reinterpret_cast<bf16*>(smem + L::d_out);
  bf16* Pt = reinterpret_cast<bf16*>(smem + L::pt);
  bf16* dSt = reinterpret_cast<bf16*>(smem + L::dst);
  float* vecs = reinterpret_cast<float*>(smem + L::vecs);

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mat = warp / 4, blk = warp % 4;
  const int kr = 16 * (blk / 2), qc = 16 * (blk % 2);
  const int d0 = warp * DW;
  const long long bh = (long long)b * H + h;
  const float* lse_bh = lse + bh * N;
  const float* delta_bh = delta + bh * N;
  float* slot = reinterpret_cast<float*>(smem + L::xch) + (blk * 32 + lane) * 8;

  // ldmatrix row addresses (patterns as in flash_fwd_rows_kernel). Scores:
  // K or V rows as the A operand, Q or dO rows as the B operand (two query
  // n8-tiles an x4), the latter offset by the ring stage. Products: P^T and
  // dS^T as A operands, dO and Q transposed as B operands at this warp's
  // columns.
  const uint32_t x_lane = smem_addr((mat ? Vs : Ks) + (kr + (lane & 15)) * LD +
                                    (lane >> 4) * 8);
  const uint32_t y_lane = smem_addr(
      (mat ? Gs : Qs) + (qc + (lane & 7) + ((lane >> 4) << 3)) * LD +
      ((lane >> 3) & 1) * 8);
  const uint32_t pt_lane = smem_addr(Pt + (lane & 15) * LDP + (lane >> 4) * 8);
  const uint32_t dst_lane =
      smem_addr(dSt + (lane & 15) * LDP + (lane >> 4) * 8);
  const uint32_t g_lane =
      smem_addr(Gs + (lane & 15) * LD + d0 + (lane >> 4) * 8);
  const uint32_t q_lane =
      smem_addr(Qs + (lane & 15) * LD + d0 + (lane >> 4) * 8);

  // query tile `tile` into ring stage `stage`, with its lse and delta
  const int n_tiles = N / BQ;
  auto load_q = [&](int stage, int tile) {
    const int q0 = tile * BQ;
    const bf16* q_src = q + offset(sq, b, q0, h);
    const bf16* g_src = d_out + offset(sd, b, q0, h);
    if (vec) {
      copy_tile_async<DP, NTH>(Qs + stage * TILE, q_src, sq.n, BQ, D);
      copy_tile_async<DP, NTH>(Gs + stage * TILE, g_src, sd.n, BQ, D);
    } else {
      load_tile<DP, NTH>(Qs + stage * TILE, q_src, sq.n, BQ, D, false);
      load_tile<DP, NTH>(Gs + stage * TILE, g_src, sd.n, BQ, D, false);
    }
    // lse and delta are contiguous (B, H, N) float32: 16-byte copies
    float* vl = vecs + stage * 2 * BQ;
    const int i = threadIdx.x;
    if (i < BQ / 4)
      cp_async16(vl + 4 * i, lse_bh + q0 + 4 * i);
    else if (i < BQ / 2)
      cp_async16(vl + BQ + 4 * (i - BQ / 4), delta_bh + q0 + 4 * (i - BQ / 4));
  };
  // columns D..DP-1 of K, V and every stage, zeroed once (the four lie
  // back to back, 2 BK + 2 STAGES BQ rows)
  if (vec && D < DP) {
    const int tail = (DP - D) / 8;
    for (int i = threadIdx.x; i < (2 * BK + 2 * STAGES * BQ) * tail;
         i += NTH) {
      int r = i / tail, c = D + (i % tail) * 8;
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // K, V and query tile 0 in the first commit group
  if (vec) {
    copy_tile_async<DP, NTH>(Ks, k + offset(sk, b, k0, h), sk.n, BK, D);
    copy_tile_async<DP, NTH>(Vs, v + offset(sv, b, k0, h), sv.n, BK, D);
  } else {
    load_tile<DP, NTH>(Ks, k + offset(sk, b, k0, h), sk.n, BK, D, false);
    load_tile<DP, NTH>(Vs, v + offset(sv, b, k0, h), sv.n, BK, D, false);
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_q(st, st);
    cp_async_commit();
  }

  float acc_k[2][ND][4], acc_v[2][ND][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[m][j][e] = acc_v[m][j][e] = 0.f;
  const float scale_log2 = scale * 1.4426950408889634f;

  int rd = 0, wr = STAGES - 1;
  for (int i = 0; i < n_tiles; ++i) {
    // the barrier also shows that every warp is done with tile i - 1's
    // P^T, dS^T and exchange slots, which tile i overwrites
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < n_tiles) load_q(wr, i + STAGES - 1);
    cp_async_commit();
    const uint32_t stage = 2 * rd * TILE;
    const float* vl = vecs + rd * 2 * BQ;
    rd = rd + 1 == STAGES ? 0 : rd + 1;
    wr = wr + 1 == STAGES ? 0 : wr + 1;

    // this warp's 16 keys x 16 queries of S^T or dP^T
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4], yb[4];
      ldsm_x4(a, x_lane + 32 * kk);
      ldsm_x4(yb, y_lane + stage + 32 * kk);
      mma_bf16(s[0], a, yb[0], yb[1]);
      mma_bf16(s[1], a, yb[2], yb[3]);
    }

    // element (j, e): key kr + g (+ 8 for e >= 2), query qc + 8 j + 2 t +
    // (e & 1); lse and delta are indexed by the query
    float p[2][4];
    if (mat == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = qc + 8 * j + 2 * t + (e & 1);
          p[j][e] = ex2(fmaf(s[j][e], scale_log2,
                             -vl[col] * 1.4426950408889634f));
        }
      *reinterpret_cast<float4*>(slot) =
          make_float4(p[0][0], p[0][1], p[0][2], p[0][3]);
      *reinterpret_cast<float4*>(slot + 4) =
          make_float4(p[1][0], p[1][1], p[1][2], p[1][3]);
      pair_sync(blk);
    } else {
      pair_sync(blk);
      const float4 x0 = *reinterpret_cast<const float4*>(slot);
      const float4 x1 = *reinterpret_cast<const float4*>(slot + 4);
      const float px[2][4] = {{x0.x, x0.y, x0.z, x0.w},
                              {x1.x, x1.y, x1.z, x1.w}};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = qc + 8 * j + 2 * t + (e & 1);
          p[j][e] = px[j][e] * (s[j][e] - vl[BQ + col]);
        }
    }
    // P^T (mat 0) or dS^T (mat 1), rounded to bf16 once
    bf16* out_t = mat ? dSt : Pt;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = qc + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(out_t + (kr + g) * LDP + col) =
          pack_bf16(p[j][0], p[j][1]);
      *reinterpret_cast<uint32_t*>(out_t + (kr + g + 8) * LDP + col) =
          pack_bf16(p[j][2], p[j][3]);
    }
    __syncthreads();

    // dS^T of the tile to scratch, 16 bytes a thread
    if (threadIdx.x < BK * BQ / 8) {
      const int r = threadIdx.x / (BQ / 8), c = (threadIdx.x % (BQ / 8)) * 8;
      *reinterpret_cast<uint4*>(ds + (bh * N + k0 + r) * N + (i * BQ + c)) =
          *reinterpret_cast<const uint4*>(dSt + r * LDP + c);
    }

#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[2][4], sa[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        ldsm_x4(pa[m], pt_lane + 2 * (16 * m * LDP + 16 * kk));
        ldsm_x4(sa[m], dst_lane + 2 * (16 * m * LDP + 16 * kk));
      }
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t gb[4], qb[4];
        ldsm_x4_trans(gb, g_lane + stage + 2 * (16 * kk * LD + 8 * j));
        ldsm_x4_trans(qb, q_lane + stage + 2 * (16 * kk * LD + 8 * j));
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(acc_v[m][j], pa[m], gb[0], gb[1]);
          mma_bf16(acc_v[m][j + 1], pa[m], gb[2], gb[3]);
          mma_bf16(acc_k[m][j], sa[m], qb[0], qb[1]);
          mma_bf16(acc_k[m][j + 1], sa[m], qb[2], qb[3]);
        }
      }
    }
  }

  // dK = scale dS^T Q and dV, contiguous (B, N, H, D)
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const long long lo = (((long long)b * N + k0 + 16 * m + g) * H + h) * D;
    const long long hi = lo + (long long)8 * H * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = d0 + 8 * j + 2 * t;
      if (d + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(dk + lo + d) = __floats2bfloat162_rn(
            acc_k[m][j][0] * scale, acc_k[m][j][1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dk + hi + d) = __floats2bfloat162_rn(
            acc_k[m][j][2] * scale, acc_k[m][j][3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + lo + d) =
            __floats2bfloat162_rn(acc_v[m][j][0], acc_v[m][j][1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + hi + d) =
            __floats2bfloat162_rn(acc_v[m][j][2], acc_v[m][j][3]);
      }
    }
  }
}

// dQ = scale dS K: one (GM queries x GN columns) tile of one head a block,
// 8 warps of 64 x 32, the keys in GK-key steps through a STAGES-deep
// cp.async ring (64-key steps in 3 stages: half the barriers of 32-key
// steps, and the faster of the two on the card). dS^T [key][query] and
// K [key][d] both lie k-major in their tiles, so both operands come
// through ldmatrix.trans.
constexpr int GM = 128, GN = 128, GK = 64;

template <int STAGES>
struct DqSmem {
  static constexpr int LDA = GM + PAD;
  static constexpr int LDB = GN + PAD;
  static constexpr int A_TILE = GK * LDA;
  static constexpr int B_TILE = GK * LDB;
  static constexpr size_t a = 0;
  static constexpr size_t b = a + sizeof(bf16) * STAGES * A_TILE;
  static constexpr size_t bytes = b + sizeof(bf16) * STAGES * B_TILE;
};

template <int STAGES>
__global__ void __launch_bounds__(32 * BWD_WARPS)
flash_bwd_dq_wide_kernel(const bf16* __restrict__ ds,
                         const bf16* __restrict__ k, bf16* __restrict__ dq,
                         int N, int H, int D, Strides sk, float scale,
                         bool vec) {
  static_assert(STAGES >= 2, "tile j + 1 loads while tile j is used");
  constexpr int NTH = 32 * BWD_WARPS;
  using L = DqSmem<STAGES>;
  constexpr int LDA = L::LDA, LDB = L::LDB;
  constexpr int A_TILE = L::A_TILE, B_TILE = L::B_TILE;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem + L::a);
  bf16* Bs = reinterpret_cast<bf16*>(smem + L::b);

  const int m0 = blockIdx.x * GM, n0 = blockIdx.y * GN;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 2, wn = warp / 2;  // 64 rows, 32 columns a warp
  const bf16* ds_bh = ds + (long long)bh * N * N;

  // A [m][k] = dS^T [k][m], transposed: matrices (k 0-7, m 0-7), (k 0-7,
  // m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15) give a0..a3; B = K [k][n],
  // transposed, as V in flash_fwd_rows_kernel
  const uint32_t a_lane = smem_addr(
      As + ((lane & 7) + ((lane >> 4) << 3)) * LDA + wm * 64 +
      ((lane >> 3) & 1) * 8);
  const uint32_t b_lane =
      smem_addr(Bs + (lane & 15) * LDB + wn * 32 + (lane >> 4) * 8);

  const int n_tiles = N / GK;
  auto load = [&](int stage, int tile) {
    const int key0 = tile * GK;
    for (int i = threadIdx.x; i < GK * GM / 8; i += NTH) {
      int r = i / (GM / 8), c = (i % (GM / 8)) * 8;
      cp_async16(As + stage * A_TILE + r * LDA + c,
                 ds_bh + (long long)(key0 + r) * N + m0 + c);
    }
    const bf16* k_src = k + offset(sk, b, key0, h) + n0;
    if (vec) {
      for (int i = threadIdx.x; i < GK * GN / 8; i += NTH) {
        int r = i / (GN / 8), c = (i % (GN / 8)) * 8;
        cp_async16(Bs + stage * B_TILE + r * LDB + c, k_src + r * sk.n + c);
      }
    } else {
      for (int i = threadIdx.x; i < GK * GN; i += NTH) {
        int r = i / GN, c = i % GN;
        Bs[stage * B_TILE + r * LDB + c] = k_src[r * sk.n + c];
      }
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load(st, st);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  int rd = 0, wr = STAGES - 1;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < n_tiles) load(wr, i + STAGES - 1);
    cp_async_commit();
    const uint32_t a_st = a_lane + 2 * rd * A_TILE;
    const uint32_t b_st = b_lane + 2 * rd * B_TILE;
    rd = rd + 1 == STAGES ? 0 : rd + 1;
    wr = wr + 1 == STAGES ? 0 : wr + 1;
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk) {
      uint32_t a[4][4], bb[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4_trans(a[mi], a_st + 2 * (16 * kk * LDA + 16 * mi));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldsm_x4_trans(bb[jj], b_st + 2 * (16 * kk * LDB + 16 * jj));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          mma_bf16(acc[mi][2 * jj], a[mi], bb[jj][0], bb[jj][1]);
          mma_bf16(acc[mi][2 * jj + 1], a[mi], bb[jj][2], bb[jj][3]);
        }
    }
  }

  // dq contiguous (B, N, H, D)
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int row = m0 + wm * 64 + 16 * mi + g;
    bf16* lo = dq + (((long long)b * N + row) * H + h) * D;
    bf16* hi = lo + (long long)8 * H * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = n0 + wn * 32 + 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(lo + d) =
          __floats2bfloat162_rn(acc[mi][j][0] * scale, acc[mi][j][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(hi + d) =
          __floats2bfloat162_rn(acc[mi][j][2] * scale, acc[mi][j][3] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: three-pass TF32 on the tensor cores (mma.sync.m16n8k8). Each
// operand x splits into hi = tf32(x) and lo = tf32(x - hi); each product is
// lo hi + hi lo + hi hi, accumulated in float32
// ---------------------------------------------------------------------------

constexpr int F32_PAD = 4;  // float32 elements of row padding in shared memory
constexpr float LOG2E = 1.4426950408889634f;

// round to nearest, ties away from zero, to TF32's 10 mantissa bits
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4). B (8 x 8, col): b0 (k = t, n = g), b1 (k = t + 4, n = g). C as for
// m16n8k16: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
struct FragA32 {
  uint32_t hi[4], lo[4];
};
struct FragB32 {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A B as three TF32 products, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const FragA32& a,
                                     const FragB32& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// A from a row-major tile, X at (row r0, column k0)
__device__ __forceinline__ FragA32 frag_a32(const float* X, int ld, int g,
                                            int t) {
  FragA32 f;
  split_tf32(X[g * ld + t], f.hi[0], f.lo[0]);
  split_tf32(X[(g + 8) * ld + t], f.hi[1], f.lo[1]);
  split_tf32(X[g * ld + t + 4], f.hi[2], f.lo[2]);
  split_tf32(X[(g + 8) * ld + t + 4], f.hi[3], f.lo[3]);
  return f;
}

// A from a 16 x 8 block of scores in C layout (rows g, g + 8; columns 2t,
// 2t + 1), with the k order permuted: k = t is column 2t, k = t + 4 column
// 2t + 1. The B operand it meets (frag_b32_kn) reads its rows in that order.
__device__ __forceinline__ FragA32 frag_a32_scores(const float (&c)[4]) {
  FragA32 f;
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[2], f.hi[1], f.lo[1]);
  split_tf32(c[1], f.hi[2], f.lo[2]);
  split_tf32(c[3], f.hi[3], f.lo[3]);
  return f;
}

// B[k][n] = Y[n][k]: Y at (row n0, column k0), the product with Y transposed
__device__ __forceinline__ FragB32 frag_b32_nk(const float* Y, int ld, int g,
                                               int t) {
  FragB32 f;
  split_tf32(Y[g * ld + t], f.hi[0], f.lo[0]);
  split_tf32(Y[g * ld + t + 4], f.hi[1], f.lo[1]);
  return f;
}

// B[k][n] = Y[row(k)][n], rows in frag_a32_scores' k order (k = t: row 2t,
// k = t + 4: row 2t + 1): Y at (row k0, column n0), the product with Y as
// it lies
__device__ __forceinline__ FragB32 frag_b32_kn(const float* Y, int ld, int g,
                                               int t) {
  FragB32 f;
  split_tf32(Y[2 * t * ld + g], f.hi[0], f.lo[0]);
  split_tf32(Y[(2 * t + 1) * ld + g], f.hi[1], f.lo[1]);
  return f;
}

// `rows` rows of D floats into a [rows][DP + F32_PAD] tile by NTH threads.
// `vec` (D, the row stride and the base a multiple of 4 floats, 16-byte
// aligned): asynchronous 16-byte copies, columns D..DP-1 left as they are;
// else element by element, synchronously, columns D..DP-1 zeroed.
template <int DP, int NTH>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int rows,
                                              int D, bool vec) {
  constexpr int LD = DP + F32_PAD;
  if (vec) {
    constexpr int CH = DP / 4;
    for (int i = threadIdx.x; i < rows * CH; i += NTH) {
      int r = i / CH, c = (i % CH) * 4;
      if (c < D) cp_async16(dst + r * LD + c, src + r * row_stride + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += NTH) {
      int r = i / DP, c = i % DP;
      dst[r * LD + c] = c < D ? src[r * row_stride + c] : 0.f;
    }
  }
}

// columns D..DP-1 of `rows` consecutive tile rows, zeroed (the `vec` copies
// never write them)
template <int DP, int NTH>
__device__ __forceinline__ void zero_tail_f32(float* tiles, int rows, int D) {
  constexpr int LD = DP + F32_PAD;
  const int tail = (DP - D) / 4;
  for (int i = threadIdx.x; i < rows * tail; i += NTH) {
    int r = i / tail, c = D + (i % tail) * 4;
    *reinterpret_cast<float4*>(tiles + r * LD + c) = make_float4(0, 0, 0, 0);
  }
}

// The DSPLIT warps of row group rg (warps DSPLIT rg..) each hold partial
// sums of the same M 16 x (8 NT) score tiles, over their own columns of the
// depth. Each writes its partials to xs ([warp][m][j][lane] float4) and,
// after the group's named barrier, adds all of them in warp order, so every
// warp of the group ends with the same sums. The caller's next block-wide
// barrier keeps the next tile's writes behind this tile's reads.
template <int DSPLIT, int M, int NT>
__device__ __forceinline__ void sum_partials(float (&s)[M][NT][4], float4* xs,
                                             int rg, int w, int lane) {
  float4* mine = xs + (rg * DSPLIT + w) * M * NT * 32 + lane;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mine[(m * NT + j) * 32] =
          make_float4(s[m][j][0], s[m][j][1], s[m][j][2], s[m][j][3]);
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "r"(32 * DSPLIT)
               : "memory");
  const float4* group = xs + rg * DSPLIT * M * NT * 32 + lane;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float4 acc = make_float4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < DSPLIT; ++u) {
        const float4 x = group[(u * M * NT + m * NT + j) * 32];
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      s[m][j][0] = acc.x;
      s[m][j][1] = acc.y;
      s[m][j][2] = acc.z;
      s[m][j][3] = acc.w;
    }
}

// online_softmax for float32 P: p = 2^(scale_log2 s - m) in place of s, l
// rescaled by alpha, which comes back for the caller's O
template <int NT>
__device__ __forceinline__ void online_softmax_f32(float (&s)[NT][4],
                                                   float (&alpha)[2],
                                                   float (&m)[2], float (&l)[2],
                                                   const float (&mx)[2],
                                                   float scale_log2) {
  float neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = ex2(fmaf(s[j][e], scale_log2, neg_m[e >> 1]));
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// zeroed accumulators
template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// Q (resident), a ring of STAGES K tiles and STAGES V tiles, and the score
// exchange of D-split warps
template <int DP, int DSPLIT, int RG, int BN, int STAGES>
struct Tf32FwdSmem {
  static constexpr int WARPS = DSPLIT * RG;
  static constexpr int BM = 16 * RG;
  static constexpr int LD = DP + F32_PAD;
  static constexpr int TILE = BN * LD;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(float) * BM * LD;
  static constexpr size_t v = k + sizeof(float) * STAGES * TILE;
  static constexpr size_t xs = v + sizeof(float) * STAGES * TILE;
  static constexpr size_t bytes =
      xs + (DSPLIT > 1 ? sizeof(float) * WARPS * 16 * BN : 0);
};

// Block (query tile, head, batch): RG row groups of 16 query rows, DSPLIT
// warps each; warp w of a group takes columns w DW.. of the depth, both of
// Q K^T (its partial sums, summed over the group by sum_partials) and of O.
// Every warp of a group then holds the same scores and softmax state.
template <int DP, int DSPLIT, int RG, int BN, int STAGES>
__global__ void __launch_bounds__(32 * DSPLIT * RG, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int N, int H, int D,
                      Strides sq, Strides sk, Strides sv, float scale_log2,
                      bool vec) {
  static_assert(STAGES >= 2, "tile j + 1 loads while tile j is used");
  using L = Tf32FwdSmem<DP, DSPLIT, RG, BN, STAGES>;
  constexpr int NTH = 32 * L::WARPS;
  constexpr int BM = L::BM, LD = L::LD, TILE = L::TILE;
  constexpr int DW = DP / DSPLIT;  // depth columns a warp
  static_assert(DW % 8 == 0 && BN % 8 == 0, "whole k8 steps and n8 tiles");
  constexpr int KD = DW / 8;  // k8 steps of Q K^T
  constexpr int NT = BN / 8;  // score n8 tiles, k8 steps of P V
  constexpr int ND = DW / 8;  // output n8 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q);
  float* Ks = reinterpret_cast<float*>(smem + L::k);
  float* Vs = reinterpret_cast<float*>(smem + L::v);
  float4* xs = reinterpret_cast<float4*>(smem + L::xs);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / DSPLIT, w = warp % DSPLIT;
  const int r0 = 16 * rg, d0 = w * DW;

  const int n_tiles = N / BN;
  auto load_kv = [&](int stage, int tile) {
    load_tile_f32<DP, NTH>(Ks + stage * TILE, k + offset(sk, b, tile * BN, h),
                           sk.n, BN, D, vec);
    load_tile_f32<DP, NTH>(Vs + stage * TILE, v + offset(sv, b, tile * BN, h),
                           sv.n, BN, D, vec);
  };
  // Q, the K ring and the V ring lie back to back: BM + 2 STAGES BN rows
  if (vec && D < DP) zero_tail_f32<DP, NTH>(Qs, BM + 2 * STAGES * BN, D);
  load_tile_f32<DP, NTH>(Qs, q + offset(sq, b, q0, h), sq.n, BM, D, vec);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(st, st);
    cp_async_commit();
  }

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float* q_w = Qs + r0 * LD + d0;

  int rd = 0, wr = STAGES - 1;
  for (int i = 0; i < n_tiles; ++i) {
    // tile i's group is complete; the barrier shows every warp done with
    // tile i - 1 (its stage wr and the exchange slots)
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < n_tiles) load_kv(wr, i + STAGES - 1);
    cp_async_commit();
    const float* k_t = Ks + rd * TILE + d0;
    const float* v_t = Vs + rd * TILE + d0;
    rd = rd + 1 == STAGES ? 0 : rd + 1;
    wr = wr + 1 == STAGES ? 0 : wr + 1;

    float s[1][NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const FragA32 a = frag_a32(q_w + 8 * kk, LD, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma3(s[0][j], a, frag_b32_nk(k_t + 8 * j * LD + 8 * kk, LD, g, t));
    }
    if constexpr (DSPLIT > 1) sum_partials<DSPLIT, 1, NT>(s, xs, rg, w, lane);

    float mx[2], alpha[2];
    tile_row_max(s[0], mx);
    online_softmax_f32(s[0], alpha, m, l, mx, scale_log2);
    // the tile's P V in registers of its own, then o = alpha o + P V in
    // round-to-nearest float32 (see the header on accumulator chains)
    float pv[ND][4];
    zero(pv);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const FragA32 pa = frag_a32_scores(s[0][j]);
#pragma unroll
      for (int n = 0; n < ND; ++n)
        mma3(pv[n], pa, frag_b32_kn(v_t + 8 * j * LD + 8 * n, LD, g, t));
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = fmaf(o[n][e], alpha[e >> 1], pv[n][e]);
  }

  // out (B, N, H, D) and lse (B, H, N), contiguous; lse in natural log
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / l[r];
  }
  float* o_lo = out + (((long long)b * N + q0 + r0 + g) * H + h) * D;
  float* o_hi = o_lo + (long long)8 * H * D;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int d = d0 + 8 * j + 2 * t;
    if (d < D) {
      o_lo[d] = o[j][0] * inv[0];
      o_hi[d] = o[j][2] * inv[1];
    }
    if (d + 1 < D) {
      o_lo[d + 1] = o[j][1] * inv[0];
      o_hi[d + 1] = o[j][3] * inv[1];
    }
  }
  if (t == 0 && w == 0) {
    float* lse_row = lse + ((long long)b * H + h) * N + q0 + r0 + g;
    lse_row[0] = (m[0] + log2f(l[0])) * 0.69314718055994531f;
    lse_row[8] = (m[1] + log2f(l[1])) * 0.69314718055994531f;
  }
}

// X1 and X2 (resident), a ring of STAGES Y1 tiles and STAGES Y2 tiles, each
// stage's lse and delta (the dK / dV pass), and the score exchange of
// D-split warps (S and dP)
template <int DP, int DSPLIT, int RG, int BN, int STAGES>
struct Tf32BwdSmem {
  static constexpr int WARPS = DSPLIT * RG;
  static constexpr int BM = 16 * RG;
  static constexpr int LD = DP + F32_PAD;
  static constexpr int TILE = BN * LD;
  static constexpr size_t x1 = 0;
  static constexpr size_t x2 = x1 + sizeof(float) * BM * LD;
  static constexpr size_t y1 = x2 + sizeof(float) * BM * LD;
  static constexpr size_t y2 = y1 + sizeof(float) * STAGES * TILE;
  static constexpr size_t vecs = y2 + sizeof(float) * STAGES * TILE;
  static constexpr size_t xs = vecs + sizeof(float) * STAGES * 2 * BN;
  static constexpr size_t bytes =
      xs + (DSPLIT > 1 ? sizeof(float) * WARPS * 2 * 16 * BN : 0);
};

// One pass of the float32 backward over the rows m0.. that the block owns,
// with the roles of flash_bwd_bf16_kernel: the dQ pass (KV = false: X1 = Q,
// X2 = dO, streamed Y1 = K, Y2 = V) or the dK / dV pass (KV = true: X1 = K,
// X2 = V, Y1 = Q, Y2 = dO). Row groups and D-split warps as in
// flash_fwd_tf32_kernel: S' and dP' are summed over the group's warps, and
// each warp accumulates its own DW columns of acc1 += dS' Y1 and (KV) acc2
// += P' Y2, with P' and dS' taken from the score registers as A operands.
template <int DP, int DSPLIT, int RG, int BN, int STAGES, bool KV>
__device__ __forceinline__ void flash_bwd_tf32_pass(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const float* __restrict__ y1, const float* __restrict__ y2,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ g1, float* __restrict__ g2, int m0, int N, int H,
    int D, Strides sx1, Strides sx2, Strides sy1, Strides sy2, float scale,
    bool vec) {
  static_assert(STAGES >= 2, "tile j + 1 loads while tile j is used");
  using L = Tf32BwdSmem<DP, DSPLIT, RG, BN, STAGES>;
  constexpr int NTH = 32 * L::WARPS;
  constexpr int BM = L::BM, LD = L::LD, TILE = L::TILE;
  constexpr int DW = DP / DSPLIT;
  static_assert(DW % 8 == 0 && BN % 8 == 0, "whole k8 steps and n8 tiles");
  static_assert(NTH >= BN / 2, "one 16-byte copy a thread for lse, delta");
  constexpr int KD = DW / 8, NT = BN / 8, ND = DW / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* X1s = reinterpret_cast<float*>(smem + L::x1);
  float* X2s = reinterpret_cast<float*>(smem + L::x2);
  float* Y1s = reinterpret_cast<float*>(smem + L::y1);
  float* Y2s = reinterpret_cast<float*>(smem + L::y2);
  float* vecs = reinterpret_cast<float*>(smem + L::vecs);
  float4* xs = reinterpret_cast<float4*>(smem + L::xs);

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / DSPLIT, w = warp % DSPLIT;
  const int r0 = 16 * rg, d0 = w * DW;
  const float scale_log2 = scale * LOG2E;
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* delta_bh = delta + ((long long)b * H + h) * N;

  // the dQ pass's rows: lse (log2 domain) and delta in registers
  float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
  if constexpr (!KV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_lse[r] = lse_bh[m0 + r0 + g + 8 * r] * LOG2E;
      row_delta[r] = delta_bh[m0 + r0 + g + 8 * r];
    }
  }

  const int n_tiles = N / BN;
  auto load_y = [&](int stage, int tile) {
    const int n0 = tile * BN;
    load_tile_f32<DP, NTH>(Y1s + stage * TILE, y1 + offset(sy1, b, n0, h),
                           sy1.n, BN, D, vec);
    load_tile_f32<DP, NTH>(Y2s + stage * TILE, y2 + offset(sy2, b, n0, h),
                           sy2.n, BN, D, vec);
    if constexpr (KV) {
      // lse and delta are contiguous (B, H, N) float32
      float* vl = vecs + stage * 2 * BN;
      const int i = threadIdx.x;
      if (i < BN / 4)
        cp_async16(vl + 4 * i, lse_bh + n0 + 4 * i);
      else if (i < BN / 2)
        cp_async16(vl + BN + 4 * (i - BN / 4), delta_bh + n0 + 4 * (i - BN / 4));
    }
  };
  // X1, X2, the Y1 ring and the Y2 ring lie back to back
  if (vec && D < DP) zero_tail_f32<DP, NTH>(X1s, 2 * BM + 2 * STAGES * BN, D);
  load_tile_f32<DP, NTH>(X1s, x1 + offset(sx1, b, m0, h), sx1.n, BM, D, vec);
  load_tile_f32<DP, NTH>(X2s, x2 + offset(sx2, b, m0, h), sx2.n, BM, D, vec);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_y(st, st);
    cp_async_commit();
  }

  float acc1[ND][4], acc2[KV ? ND : 1][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc1[j][e] = 0.f;
      if constexpr (KV) acc2[j][e] = 0.f;
    }
  const float* x1_w = X1s + r0 * LD + d0;
  const float* x2_w = X2s + r0 * LD + d0;

  int rd = 0, wr = STAGES - 1;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < n_tiles) load_y(wr, i + STAGES - 1);
    cp_async_commit();
    const float* y1_t = Y1s + rd * TILE + d0;
    const float* y2_t = Y2s + rd * TILE + d0;
    const float* vl = vecs + rd * 2 * BN;
    rd = rd + 1 == STAGES ? 0 : rd + 1;
    wr = wr + 1 == STAGES ? 0 : wr + 1;

    // sd[0] = S', sd[1] = dP'
    float sd[2][NT][4];
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sd[mm][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const FragA32 a1 = frag_a32(x1_w + 8 * kk, LD, g, t);
      const FragA32 a2 = frag_a32(x2_w + 8 * kk, LD, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma3(sd[0][j], a1, frag_b32_nk(y1_t + 8 * j * LD + 8 * kk, LD, g, t));
        mma3(sd[1][j], a2, frag_b32_nk(y2_t + 8 * j * LD + 8 * kk, LD, g, t));
      }
    }
    if constexpr (DSPLIT > 1) sum_partials<DSPLIT, 2, NT>(sd, xs, rg, w, lane);

    // element (j, e): row r0 + g (+ 8 for e >= 2), column 8 j + 2 t + (e & 1);
    // lse and delta are the query's: the row (dQ pass) or the column (KV)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const float l2 = KV ? vl[col] * LOG2E : row_lse[e >> 1];
        const float dl = KV ? vl[BN + col] : row_delta[e >> 1];
        const float p = ex2(fmaf(sd[0][j][e], scale_log2, -l2));
        sd[0][j][e] = p;
        sd[1][j][e] = p * (sd[1][j][e] - dl);
      }

    // the tile's products in registers of their own, added to acc1 and
    // acc2 in round-to-nearest float32
    float t1[ND][4], t2[KV ? ND : 1][4];
    zero(t1);
    zero(t2);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const FragA32 da = frag_a32_scores(sd[1][j]);
#pragma unroll
      for (int n = 0; n < ND; ++n)
        mma3(t1[n], da, frag_b32_kn(y1_t + 8 * j * LD + 8 * n, LD, g, t));
      if constexpr (KV) {
        const FragA32 pa = frag_a32_scores(sd[0][j]);
#pragma unroll
        for (int n = 0; n < ND; ++n)
          mma3(t2[n], pa, frag_b32_kn(y2_t + 8 * j * LD + 8 * n, LD, g, t));
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc1[n][e] += t1[n][e];
        if constexpr (KV) acc2[n][e] += t2[n][e];
      }
  }

  // gradients are contiguous (B, N, H, D)
  const long long lo = (((long long)b * N + m0 + r0 + g) * H + h) * D;
  const long long hi = lo + (long long)8 * H * D;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = d0 + 8 * j + 2 * t + e;
      if (d < D) {
        g1[lo + d] = acc1[j][e] * scale;
        g1[hi + d] = acc1[j][e + 2] * scale;
        if constexpr (KV) {
          g2[lo + d] = acc2[j][e];
          g2[hi + d] = acc2[j][e + 2];
        }
      }
    }
}

// Both passes in one grid: blocks 0..N / BM - 1 take the dK / dV pass (the
// heavier, so it is scheduled first), the rest the dQ pass
template <int DP, int DSPLIT, int RG, int BN, int STAGES>
__global__ void __launch_bounds__(32 * DSPLIT * RG, 1)
flash_bwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ d_out,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq,
                      float* __restrict__ dk, float* __restrict__ dv, int N,
                      int H, int D, Strides sq, Strides sk, Strides sv,
                      Strides sd, float scale, bool vec) {
  constexpr int BM = 16 * RG;
  const int blocks = N / BM;
  if ((int)blockIdx.x < blocks)
    flash_bwd_tf32_pass<DP, DSPLIT, RG, BN, STAGES, true>(
        k, v, q, d_out, lse, delta, dk, dv, blockIdx.x * BM, N, H, D, sk, sv,
        sq, sd, scale, vec);
  else
    flash_bwd_tf32_pass<DP, DSPLIT, RG, BN, STAGES, false>(
        q, d_out, k, v, lse, delta, dq, nullptr, (blockIdx.x - blocks) * BM,
        N, H, D, sq, sd, sk, sv, scale, vec);
}

// delta[b, h, n] = sum_d dO[b, n, h, d] O[b, n, h, d]; both contiguous
template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_delta_kernel(const T* __restrict__ out, const T* __restrict__ d_out,
                   float* __restrict__ delta, int B, int N, int H, int D) {
  long long row = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= (long long)B * N * H) return;
  int lane = threadIdx.x % 32;
  const T* o = out + row * D;
  const T* g = d_out + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_f32(o[d]) * to_f32(g[d]);
  acc = warp_sum(acc);
  if (lane == 0) {
    int h = (int)(row % H);
    long long bn = row / H;
    int n = (int)(bn % N), b = (int)(bn / N);
    delta[((long long)b * H + h) * N + n] = acc;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr int BN_ROWS = 64;  // keys a tile, row-split bf16 forward
constexpr int BN_WIDE = 32;  // keys a tile, wide bf16 forward
constexpr int WIDE_STAGES = 2;
constexpr int BN_BWD = 32;  // streamed rows a tile, bf16 backward, D <= 128

using WideL = WideFwdSmem<512, BN_WIDE, WIDE_STAGES>;

cudaError_t launch_fwd_wide(const bf16* q, const bf16* k, const bf16* v,
                            bf16* out, float* lse, float* o_part,
                            float* lse_part, int B, int N, int H, int D,
                            int splits, Strides sq, Strides sk, Strides sv,
                            float scale, bool vec, cudaStream_t stream) {
  auto kernel = flash_fwd_wide_kernel<512, BN_WIDE, WIDE_STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WideL::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(N / WideL::BM, H, B * splits);
  kernel<<<grid, 32 * WIDE_WARPS, WideL::bytes, stream>>>(
      q, k, v, o_part, lse_part, N, H, D, splits, sq, sk, sv,
      scale * 1.4426950408889634f, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long long rows = (long long)B * N * H;
  int blocks = (int)((rows + THREADS / 32 - 1) / (THREADS / 32));
  flash_combine_kernel<<<blocks, THREADS, 0, stream>>>(
      o_part, lse_part, out, lse, B, N, H, D, splits);
  return cudaGetLastError();
}

template <int DP, int WARPS, int STAGES>
cudaError_t launch_fwd_rows(const bf16* q, const bf16* k, const bf16* v,
                            bf16* out, float* lse, int B, int N, int H, int D,
                            Strides sq, Strides sk, Strides sv, float scale,
                            bool vec, cudaStream_t stream) {
  using L = RowFwdSmem<DP, WARPS, BN_ROWS, STAGES>;
  auto kernel = flash_fwd_rows_kernel<DP, WARPS, BN_ROWS, STAGES>;
  // once for this instantiation, not on every launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid(N / L::BM, H, B);
  kernel<<<grid, 32 * WARPS, L::bytes, stream>>>(
      q, k, v, out, lse, N, H, D, sq, sk, sv, scale * 1.4426950408889634f,
      vec);
  return cudaGetLastError();
}

template <int DP_, int WARPS_, int STAGES_>
struct RowsConfig {
  static constexpr int DP = DP_, WARPS = WARPS_, STAGES = STAGES_;
};

// the row-split forward's instantiation for a head dimension D <= 128
// (tile width, warps, ring stages), handed to f. The main path sends bf16
// at D = 40, 64 and 80 to csrc/flash_fwd_hopper.cu; widths 48, 64 and 80
// stay for the other widths they cover and as its yardstick. At width 64
// 4 warps and 2 stages fit 4 blocks an SM (128 registers, 46,080 B):
// 0.36 ms at (2, 4096, 10, 64) against 0.45 for 8 warps and 3 stages,
// 1 block an SM at 130 registers (NVIDIA H100 80GB HBM3, 700 W, launch medians)
template <typename F>
cudaError_t with_rows_config(int D, F&& f) {
  if (D <= 48) return f(RowsConfig<48, 8, 3>{});
  if (D <= 64) return f(RowsConfig<64, 4, 2>{});
  if (D <= 80) return f(RowsConfig<80, 8, 3>{});
  return f(RowsConfig<128, 4, 2>{});
}

// info = {tile width (0: float32), threads, query rows a block, dynamic
// shared-memory bytes, resident blocks an SM, registers a thread,
// local-memory bytes a thread}
template <typename K>
cudaError_t kernel_facts(K* kernel, int width, int threads, int rows,
                         size_t smem, int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  int facts[7] = {width, threads, rows, (int)smem, blocks, attr.numRegs,
                  (int)attr.localSizeBytes};
  for (int i = 0; i < 7; ++i) info[i] = facts[i];
  return err;
}

template <int DP>
cudaError_t launch_bwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                            const bf16* d_out, const float* lse,
                            const float* delta, bf16* dq, bf16* dk, bf16* dv,
                            int B, int N, int H, int D, Strides sq, Strides sk,
                            Strides sv, Strides sd, float scale, bool vec,
                            cudaStream_t stream) {
  using L = BwdSmem<DP, BN_BWD>;
  auto dq_kernel = flash_bwd_bf16_kernel<DP, BN_BWD, false>;
  auto kv_kernel = flash_bwd_bf16_kernel<DP, BN_BWD, true>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(N / L::BM, H, B);
  dq_kernel<<<grid, THREADS, L::bytes, stream>>>(
      q, d_out, k, v, lse, delta, dq, nullptr, N, H, D, sq, sd, sk, sv, scale,
      vec);
  kv_kernel<<<grid, THREADS, L::bytes, stream>>>(
      k, v, q, d_out, lse, delta, dk, dv, N, H, D, sk, sv, sq, sd, scale, vec);
  return cudaGetLastError();
}

constexpr int WIDE_BWD_STAGES = 2;  // Q / dO ring of the dK / dV pass
constexpr int DQ_STAGES = 3;        // dS / K ring of the dQ product

using WideBwdL = WideBwdSmem<512, WIDE_BWD_STAGES>;
using DqL = DqSmem<DQ_STAGES>;

// D > 128, a multiple of 128: the dK / dV pass (it writes dS^T to ds,
// (B H, N, N) bf16), then dQ = scale dS K
cudaError_t launch_bwd_wide(const bf16* q, const bf16* k, const bf16* v,
                            const bf16* d_out, const float* lse,
                            const float* delta, bf16* dq, bf16* dk, bf16* dv,
                            bf16* ds, int B, int N, int H, int D, Strides sq,
                            Strides sk, Strides sv, Strides sd, float scale,
                            bool vec, cudaStream_t stream) {
  auto kv_kernel = flash_bwd_kv_wide_kernel<512, WIDE_BWD_STAGES>;
  auto dq_kernel = flash_bwd_dq_wide_kernel<DQ_STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WideBwdL::bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DqL::bytes);
  if (err != cudaSuccess) return err;
  kv_kernel<<<dim3(N / BK_WIDE, H, B), 32 * BWD_WARPS, WideBwdL::bytes,
              stream>>>(q, k, v, d_out, lse, delta, dk, dv, ds, N, H, D, sq,
                        sk, sv, sd, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(N / GM, D / GN, B * H), 32 * BWD_WARPS, DqL::bytes,
              stream>>>(ds, k, dq, N, H, D, sk, scale, vec);
  return cudaGetLastError();
}

bool aligned8(const void* p, const Strides& s) {
  return (uintptr_t)p % 16 == 0 && s.b % 8 == 0 && s.n % 8 == 0 && s.h % 8 == 0;
}

// float32: 16-byte rows of 4 floats
bool aligned4(const void* p, const Strides& s) {
  return (uintptr_t)p % 16 == 0 && s.b % 4 == 0 && s.n % 4 == 0 && s.h % 4 == 0;
}

template <int DP_, int DSPLIT_, int RG_, int BN_, int STAGES_>
struct Tf32Config {
  static constexpr int DP = DP_, DSPLIT = DSPLIT_, RG = RG_, BN = BN_,
                       STAGES = STAGES_;
};

// the float32 kernels' instantiations for a head dimension D (tile width,
// D-split warps, row groups of 16 rows, streamed tile, ring stages), handed
// to f. Registers: a forward warp holds O and the tile's P V, 2 x 4 DW
// floats over its 32 lanes; a dK / dV warp dK, dV and the tile's products,
// 4 x 4 DW. Hence the forward's 4 warps of 128 columns at D = 512, and the
// backward's 2 warps at widths 80 and 128 and 8 of 64 columns at 512. At
// width 64 (only the tiny VAE's (1, 1024, 1, 64): 64 row groups for 132
// SMs) 2 warps a group double the warps in flight: 0.087 -> 0.070 ms
// forward, 0.19 -> 0.13 backward (NVIDIA H100 80GB HBM3, 700 W); at 16,
// 80 and 512 more D-split warps were slower.
template <typename F>
cudaError_t with_tf32_fwd_config(int D, F&& f) {
  if (D <= 16) return f(Tf32Config<16, 1, 4, 64, 2>{});
  if (D <= 40) return f(Tf32Config<40, 1, 4, 64, 2>{});
  if (D <= 64) return f(Tf32Config<64, 2, 4, 64, 2>{});
  if (D <= 80) return f(Tf32Config<80, 1, 4, 64, 2>{});
  if (D <= 128) return f(Tf32Config<128, 1, 4, 64, 2>{});
  return f(Tf32Config<512, 4, 2, 16, 2>{});
}

template <typename F>
cudaError_t with_tf32_bwd_config(int D, F&& f) {
  if (D <= 16) return f(Tf32Config<16, 1, 4, 32, 2>{});
  if (D <= 40) return f(Tf32Config<40, 1, 4, 32, 2>{});
  if (D <= 64) return f(Tf32Config<64, 2, 4, 32, 2>{});
  if (D <= 80) return f(Tf32Config<80, 2, 4, 32, 2>{});
  if (D <= 128) return f(Tf32Config<128, 2, 4, 32, 2>{});
  return f(Tf32Config<512, 8, 1, 16, 2>{});
}

template <typename C>
using Tf32FwdL = Tf32FwdSmem<C::DP, C::DSPLIT, C::RG, C::BN, C::STAGES>;
template <typename C>
using Tf32BwdL = Tf32BwdSmem<C::DP, C::DSPLIT, C::RG, C::BN, C::STAGES>;

template <typename C>
cudaError_t launch_fwd_tf32(const float* q, const float* k, const float* v,
                            float* out, float* lse, int B, int N, int H, int D,
                            Strides sq, Strides sk, Strides sv, float scale,
                            bool vec, cudaStream_t stream) {
  using L = Tf32FwdL<C>;
  auto kernel =
      flash_fwd_tf32_kernel<C::DP, C::DSPLIT, C::RG, C::BN, C::STAGES>;
  // once for this instantiation, not on every launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(N / L::BM, H, B), 32 * L::WARPS, L::bytes, stream>>>(
      q, k, v, out, lse, N, H, D, sq, sk, sv, scale * LOG2E, vec);
  return cudaGetLastError();
}

template <typename C>
cudaError_t launch_bwd_tf32(const float* q, const float* k, const float* v,
                            const float* d_out, const float* lse,
                            const float* delta, float* dq, float* dk,
                            float* dv, int B, int N, int H, int D, Strides sq,
                            Strides sk, Strides sv, Strides sd, float scale,
                            bool vec, cudaStream_t stream) {
  using L = Tf32BwdL<C>;
  auto kernel =
      flash_bwd_tf32_kernel<C::DP, C::DSPLIT, C::RG, C::BN, C::STAGES>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(2 * (N / L::BM), H, B), 32 * L::WARPS, L::bytes, stream>>>(
      q, k, v, d_out, lse, delta, dq, dk, dv, N, H, D, sq, sk, sv, sd, scale,
      vec);
  return cudaGetLastError();
}

}  // namespace

// error codes beyond cudaError_t's range for shapes the kernels do not take
#define FLASH_BAD_SHAPE 100001

#define BWD_CASE(DP)                                                          \
  return launch_bwd_bf16<DP>(                                                 \
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)d_out, lse, \
      delta, (bf16*)dq, (bf16*)dk, (bf16*)dv, B, N, H, D, sq, sk, sv, sd,     \
      scale, vec, stream)

// q, k, v: (B, N, H, D) with element strides (b, n, h) and unit stride along
// D; out contiguous (B, N, H, D); lse contiguous (B, H, N) float32.
// is_bf16: the tensors' type (else float32). N must be a multiple of 128.
// The bf16 forward at D > 128 cuts the keys into `splits` ranges (N / splits
// a multiple of 32, splits <= 4) and needs float32 scratch from the caller:
// o_part (splits, B, N, H, D) and lse_part (splits, B, H, N); elsewhere
// o_part, lse_part and splits are not read.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, float* lse, float* o_part,
                              float* lse_part, int B, int N, int H, int D,
                              long long sqb, long long sqn, long long sqh,
                              long long skb, long long skn, long long skh,
                              long long svb, long long svn, long long svh,
                              int is_bf16, int splits, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  Strides sq{sqb, sqn, sqh}, sk{skb, skn, skh}, sv{svb, svn, svh};
  if (N % 128 || D < 1 || D > 512 || B < 1 || H < 1) return FLASH_BAD_SHAPE;
  float scale = 1.0f / sqrtf((float)D);
  if (!is_bf16) {
    bool vec = D % 4 == 0 && aligned4(q, sq) && aligned4(k, sk) &&
               aligned4(v, sv);
    return with_tf32_fwd_config(D, [&](auto config) {
      return launch_fwd_tf32<decltype(config)>(
          (const float*)q, (const float*)k, (const float*)v, (float*)out, lse,
          B, N, H, D, sq, sk, sv, scale, vec, stream);
    });
  }
  bool vec = D % 8 == 0 && aligned8(q, sq) && aligned8(k, sk) && aligned8(v, sv);
  if (D <= 128)
    return with_rows_config(D, [&](auto config) {
      using C = decltype(config);
      return launch_fwd_rows<C::DP, C::WARPS, C::STAGES>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, lse, B,
          N, H, D, sq, sk, sv, scale, vec, stream);
    });
  if (!o_part || !lse_part || splits < 1 || splits > MAX_SPLITS ||
      N % splits || (N / splits) % BN_WIDE)
    return FLASH_BAD_SHAPE;
  return launch_fwd_wide((const bf16*)q, (const bf16*)k, (const bf16*)v,
                         (bf16*)out, lse, o_part, lse_part, B, N, H, D, splits,
                         sq, sk, sv, scale, vec, stream);
}

// The launch facts of the kernels that flash_attn_fwd runs for head
// dimension D and the type is_bf16, as kernel_facts lists them in info[7]
// (the compiler's log has no dynamic shared memory and no occupancy):
// part 0 the forward kernel, part 1 the wide forward's combine (D > 128,
// bf16; FLASH_BAD_SHAPE elsewhere).
extern "C" int flash_attn_fwd_info(int D, int is_bf16, int part, int* info) {
  if (D < 1 || D > 512 || part < 0 || part > 1) return FLASH_BAD_SHAPE;
  bool wide = is_bf16 && D > 128;
  if (part == 1 && !wide) return FLASH_BAD_SHAPE;
  if (!is_bf16)
    return with_tf32_fwd_config(D, [&](auto config) {
      using C = decltype(config);
      using L = Tf32FwdL<C>;
      return kernel_facts(
          flash_fwd_tf32_kernel<C::DP, C::DSPLIT, C::RG, C::BN, C::STAGES>,
          C::DP, 32 * L::WARPS, L::BM, L::bytes, info);
    });
  if (D <= 128)
    return with_rows_config(D, [&](auto config) {
      using C = decltype(config);
      using L = RowFwdSmem<C::DP, C::WARPS, BN_ROWS, C::STAGES>;
      return kernel_facts(
          flash_fwd_rows_kernel<C::DP, C::WARPS, BN_ROWS, C::STAGES>, C::DP,
          32 * C::WARPS, L::BM, L::bytes, info);
    });
  if (part == 1)
    return kernel_facts(flash_combine_kernel, 512, THREADS, THREADS / 32, 0,
                        info);
  return kernel_facts(flash_fwd_wide_kernel<512, BN_WIDE, WIDE_STAGES>, 512,
                      32 * WIDE_WARPS, WideL::BM, WideL::bytes, info);
}

// The launch facts of the backward's kernels for head dimension D and the
// type is_bf16, in launch order, as kernel_facts lists them in info[7]:
// part 0 delta, part 1 the dQ pass (the dK / dV pass for bf16 at D > 128;
// for float32 the one kernel of both passes), part 2 the dK / dV pass (the
// dS K product for bf16 at D > 128, whose tile width is its column tile;
// FLASH_BAD_SHAPE for float32).
extern "C" int flash_attn_bwd_info(int D, int is_bf16, int part, int* info) {
  if (D < 1 || D > 512 || part < 0 || part > 2) return FLASH_BAD_SHAPE;
  if (part == 0)
    return is_bf16 ? kernel_facts(flash_delta_kernel<bf16>, 0, THREADS,
                                  THREADS / 32, 0, info)
                   : kernel_facts(flash_delta_kernel<float>, 0, THREADS,
                                  THREADS / 32, 0, info);
  if (!is_bf16) {
    if (part == 2) return FLASH_BAD_SHAPE;
    return with_tf32_bwd_config(D, [&](auto config) {
      using C = decltype(config);
      using L = Tf32BwdL<C>;
      return kernel_facts(
          flash_bwd_tf32_kernel<C::DP, C::DSPLIT, C::RG, C::BN, C::STAGES>,
          C::DP, 32 * L::WARPS, L::BM, L::bytes, info);
    });
  }
  if (D > 128) {
    if (D % 128) return FLASH_BAD_SHAPE;
    if (part == 1)
      return kernel_facts(flash_bwd_kv_wide_kernel<512, WIDE_BWD_STAGES>, 512,
                          32 * BWD_WARPS, BK_WIDE, WideBwdL::bytes, info);
    return kernel_facts(flash_bwd_dq_wide_kernel<DQ_STAGES>, GN,
                        32 * BWD_WARPS, GM, DqL::bytes, info);
  }
#define BWD_INFO(DP)                                                       \
  {                                                                         \
    auto dq_pass = flash_bwd_bf16_kernel<DP, BN_BWD, false>;                \
    auto kv_pass = flash_bwd_bf16_kernel<DP, BN_BWD, true>;                 \
    return kernel_facts(part == 1 ? dq_pass : kv_pass, DP, THREADS,         \
                        BwdSmem<DP, BN_BWD>::BM,                            \
                        BwdSmem<DP, BN_BWD>::bytes, info);                  \
  }
  if (D <= 48) BWD_INFO(48);
  if (D <= 80) BWD_INFO(80);
  BWD_INFO(128);
#undef BWD_INFO
}

// out, d_out, dq, dk, dv contiguous (B, N, H, D); delta (B, H, N) float32
// scratch that the call fills. bf16 at D > 128 (a multiple of 128) also
// needs ds, (B, H, N, N) bf16 scratch for dS^T [key][query]; elsewhere ds
// is not read.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* out, const float* lse,
                              const void* d_out, void* dq, void* dk, void* dv,
                              float* delta, void* ds, int B, int N, int H,
                              int D,
                              long long sqb, long long sqn, long long sqh,
                              long long skb, long long skn, long long skh,
                              long long svb, long long svn, long long svh,
                              int is_bf16, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  Strides sq{sqb, sqn, sqh}, sk{skb, skn, skh}, sv{svb, svn, svh};
  Strides sd{(long long)N * H * D, (long long)H * D, (long long)D};
  if (N % 128 || D < 1 || D > 512 || B < 1 || H < 1) return FLASH_BAD_SHAPE;
  if (is_bf16 && D > 128 && (D % 128 || !ds)) return FLASH_BAD_SHAPE;
  float scale = 1.0f / sqrtf((float)D);
  long long rows = (long long)B * N * H;
  int delta_blocks = (int)((rows + THREADS / 32 - 1) / (THREADS / 32));
  if (!is_bf16) {
    flash_delta_kernel<float><<<delta_blocks, THREADS, 0, stream>>>(
        (const float*)out, (const float*)d_out, delta, B, N, H, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bool vec = D % 4 == 0 && aligned4(q, sq) && aligned4(k, sk) &&
               aligned4(v, sv) && aligned4(d_out, sd);
    return with_tf32_bwd_config(D, [&](auto config) {
      return launch_bwd_tf32<decltype(config)>(
          (const float*)q, (const float*)k, (const float*)v,
          (const float*)d_out, lse, delta, (float*)dq, (float*)dk, (float*)dv,
          B, N, H, D, sq, sk, sv, sd, scale, vec, stream);
    });
  }
  flash_delta_kernel<bf16><<<delta_blocks, THREADS, 0, stream>>>(
      (const bf16*)out, (const bf16*)d_out, delta, B, N, H, D);
  bool vec = D % 8 == 0 && aligned8(q, sq) && aligned8(k, sk) &&
             aligned8(v, sv) && aligned8(d_out, sd);
  if (D <= 48) BWD_CASE(48);
  if (D <= 80) BWD_CASE(80);
  if (D <= 128) BWD_CASE(128);
  return launch_bwd_wide((const bf16*)q, (const bf16*)k, (const bf16*)v,
                         (const bf16*)d_out, lse, delta, (bf16*)dq, (bf16*)dk,
                         (bf16*)dv, (bf16*)ds, B, N, H, D, sq, sk, sv, sd,
                         scale, vec, stream);
}
