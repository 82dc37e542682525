// Forward flash attention for Hopper (sm_90a): online softmax over key
// tiles, causal mask, sliding window, tanh logit softcap, GQA.
//
// Replaces the TPU kernel `_flash_kernel` of the JAX package
// (src/repro/kernels/flash_attention/flash_attention.py), launched there by
// `flash_attention_pallas`.  For query head h of batch b (kv head
// h / (H/KV)) and query position s it computes
//
//     x_t   = scale · q_s·k_t,  then x_t <- cap·tanh(x_t / cap) with a cap
//     x_t   = -2^30 where the key is masked (t > s when causal;
//             t <= s - window with a window)
//     o_s   = Σ_t softmax(x)_t v_t
//
// with the softmax taken online over key tiles: running max m, running sum
// l and an unnormalised accumulator, all fp32, rescaled by exp(m_old - m_new)
// as each tile arrives; o is written in the inputs' dtype.  The same
// function as the plain version in kernels/flash_attention/ref.py.  q and k
// have head dim D, v and o head dim Dv <= D (MLA's prefill: D = 192 =
// qk_nope 128 + qk_rope 64, Dv = 128).
//
// For training, both kernels also write each row's log-sum-exp, lse_s =
// m + log l in the natural-log units of the scaled, capped scores, into
// an fp32 [B,H,S] tensor when the caller passes one (a null pointer for
// serving: one untaken branch a row in the epilogue).  The backward
// kernels (flash_attention_bwd.cu) recompute p = exp(x - lse) from it.
//
// What bounds it.  At gemma2-9b's prefill (B=2, H=16 over KV=8, S=8192,
// D=256, causal, bf16) the function needs 4·B·H·D operations per unmasked
// (query, key) pair — 1.1 TFLOP for a global layer, 1.1 ms on the bf16
// tensor cores (989 TFLOP/s) — against 0.13 GB of inputs and outputs
// (0.04 ms at 3.35 TB/s): it is bound by operations, so its products
// belong on the tensor cores.
//
// Two kernels, chosen by dtype, head dims and alignment in
// `arcadia_flash_attention` (never by trying one and then the other):
//
// 1. `flash_fwd_wgmma<D, Dv>` — bf16 at the serving pairs (D, Dv) = (64,
//    64), (80, 80) (hubert), (128, 128), (192, 128) (MLA's prefill) and
//    (256, 256), pointers and strides 16-byte aligned (TMA's rule).
//    * Three warpgroups.  Warpgroup 0 is the producer: after `setmaxnreg`
//      drops it to 24 registers, one thread issues TMA copies of the Q tile
//      and of each K and V tile into shared memory, with mbarriers counting
//      the bytes.  Warpgroups 1 and 2 (240 registers each) are consumers,
//      64 query rows each, so a block's 128 rows share every K/V tile.
//    * S = Q·Kᵀ by `wgmma.mma_async m64n{Bc}k16` with Q and K read from
//      shared memory through descriptors; S stays in fp32 registers.  The
//      softmax runs on those registers; P is rounded to bf16 (the plain
//      version rounds p to v's dtype) and packed in place: the
//      accumulator's fragment layout is the A-operand layout of the next
//      product, so O += P·V is `wgmma m64n{N}k16` with A from registers and
//      V from shared memory, N = Dv rounded up to whole 64-column boxes.
//      V's tile is [keys, Dv] with Dv contiguous, the MN-major B operand
//      (wgmma's transpose bit), so it needs no transpose.
//    * Overlap.  K/V tiles sit in a ring of two stages with full and empty
//      mbarriers (K and V apart, so K's slot frees as soon as Q·Kᵀ is
//      done): the producer loads ahead while the consumers multiply.  A
//      consumer issues Q·Kᵀ of tile j and P·V of tile j - 1 together and
//      runs tile j's softmax while P·V is still in flight.  The two
//      consumers take turns at issuing (named barriers), so one's softmax
//      runs under the other's products; for that both walk all the
//      block's tiles.  The softmax, not the products or the copies, is what
//      the kernel waits for (tools/flash_ablate.py times it without each).
//    * Tensor maps: one per operand over its strided 4-D view (D or Dv, S,
//      heads, batch), built on the host per call with cuTensorMapEncodeTiled
//      got through cudaGetDriverEntryPoint (no -lcuda), 128-byte swizzle,
//      so a row is ceil(D/64) boxes of 64 columns.  The layer's [B,S,H,D]
//      views go in as they are, and so does MLA's v, the [..., 128:] view
//      of its [B,S,H,256] expansion (a 256-byte offset).  Rows past S
//      arrive as zeros, and so do a box's columns past the view's head dim:
//      at D = 80 a row is two boxes, columns 80..127 zero.  Q·Kᵀ runs D/16
//      k16 steps (5 at D = 80: the zero columns are never multiplied); P·V
//      runs over N = 128 and the epilogue writes the Dv live columns.  So
//      at D = 80 the tensor cores execute (80 + 128)/160 = 1.3× the
//      function's operations; narrowing P·V needs a second, 16-column map
//      with a 32-byte swizzle.  TMA counts a box's bytes whole, zero
//      columns included, so the barriers expect boxes·rows·128 bytes.
//    * Tiles (227 KB of shared memory a block; Br = 128 query rows):
//        D = 256:         Bc = 64,  Q 64 KB + 2 stages × (K 32 + V 32 KB) = 192 KB
//        D = 192, Dv 128: Bc = 128, Q 48 KB + 2 × (48 + 32 KB)            = 208 KB
//        D = 128 and 80:  Bc = 128, Q 32 KB + 2 × (32 + 32 KB)            = 160 KB
//        D = 64:          Bc = 128, Q 16 KB + 2 × (16 + 16 KB)            =  80 KB
//      plus 1 KB to align the ring to the swizzle's 1024 bytes and 128 B of
//      barriers.  Registers a consumer thread: O is 64 × N fp32 over 128
//      threads (N/2: 128 at D = 256), S is Bc/2 (32), P Bc/4 (16): 176 of
//      its 240 at D = 256; 64 + 64 + 32 at N = 128.  No kernel spills
//      (cudaFuncGetAttributes' local bytes are 0; `arcadia_flash_kernel_info`
//      reports them).
//    * Masks only where they bite.  Tiles outside the causal/window band
//      of the block are never loaded.  Tiles wholly inside a warpgroup's
//      band skip the per-element mask, which only the diagonal, the
//      window's edge and the ragged end pay, as two compares against the
//      row's visible range.  Masked scores are -2^30 and the running max
//      starts at -2^30, so a tile that holds no visible key for a row (a
//      window narrower than a tile, or a tile past a warpgroup's diagonal)
//      adds weights that the row's first real score wipes with the factor
//      exp2(-2^30 - m) = 0, or adds exp2(-2^30 - m) = 0 after it (no
//      (-inf) - (-inf)); keys past S score -inf (exactly zero weight); rows
//      past S are not written.  Without a softcap the scale and log2(e)
//      go into one FMA before ex2; with one, log2(e) is folded in after
//      tanh.  The softcap uses tanhf (not tanh.approx).
// 2. `flash_fwd_kernel<T, DM>` — fp32, bf16 at other pairs, and bf16 views
//    that are not 16-byte aligned (pointers and strides multiples of 4
//    elements only), on the tensor cores through `mma.sync`.
//    * fp32 inputs: every product is three TF32 products with fp32 sums,
//      a·b ≈ aₗ·bₕ + aₕ·bₗ + aₕ·bₕ with hi = cvt.rna.tf32.f32(x) and lo =
//      cvt.rna.tf32.f32(x − hi) (`mma.sync.aligned.m16n8k8...tf32`).  hi +
//      lo carries 22 bits of x's 24, and the dropped aₗ·bₗ is 2^-22 of a·b,
//      so the fp32 route keeps the plain version's 2e-5 (the CPU mirror,
//      ref.attention_split_reference, does the same arithmetic).  The
//      split's floor on the card is 3·ops / 495 TFLOP/s (TF32), 0.41 of
//      the old route's ops / 67 TFLOP/s (fp32 FMAs).
//    * bf16 inputs: `mma.sync m16n8k16` bf16 with fp32 sums.  A product of
//      two bf16 values is exact in fp32, so Q·Kᵀ is the function the old
//      route computed by widening; P is rounded to bf16 where it meets V,
//      as the plain version rounds p to v's dtype.
//    * Why mma.sync and not wgmma: wgmma's tf32 form takes both operands
//      K-major from shared memory, and V [keys, Dv] is MN-major for P·V, so
//      V would have to be staged transposed; mma.sync reads either layout
//      from shared memory with plain loads (fp32) or ldmatrix (.trans for V,
//      bf16), and takes P from the S accumulator's registers.  This route
//      serves what TMA cannot read (4-element alignment) and fp32, neither
//      of them on the serving path.
//    * Where the split happens.  Q and K/V tiles sit in shared memory as
//      they arrive (fp32 or bf16); each fragment is split as a warp loads
//      it, once for the three products it feeds, rounding on the bits
//      ((x + 0x1000) & ~0x1FFF, cvt.rna's result, on the integer pipe).  A
//      split copy in shared memory would double every staged tile (8
//      bytes an element): at D = 256 the Q tile alone would take 266 KB.
//      P is split in registers.
//    * Sums.  A step's three products go into a fresh accumulator that is
//      added to O in fp32 (round to nearest): the tensor cores' own sums
//      truncate, and with O kept in their accumulator a first build's fp32
//      error grew with the number of keys summed.  S = Q·Kᵀ (at most 32
//      steps) stays in theirs.
//    * P·V walks O's columns 32 at a time, the loads of a step ahead of
//      its products; a step whose first column is live runs whole, and
//      its dead columns (Dv < DM) are never stored.  Its loads may reach
//      past V's last row, so Q sits after the ring.
//    * Tiles.  8 warps, 16 query rows each: 128 rows a block.  K and V
//      tiles of Bc keys in a double-buffered cp.async ring (16-byte copies
//      of fp32, 8-byte copies of bf16: the route's 4-element alignment;
//      rows past S zero-filled), so tile j + 1 lands while tile j is
//      multiplied.  Rows are padded to 8k + 4
//      floats (fp32) or 16k + 8 bf16, which keeps every fragment load and
//      ldmatrix free of bank conflicts; the columns past D and Dv are zero.
//      Template width DM = D rounded up to 64, 128, 192 or 256 sizes the O
//      accumulator (16 × DM fp32 a warp); the shared tiles follow the run's
//      D and Dv.  Bc (keys a tile) is what fits two stages at DM:
//        fp32: 64 at DM <= 128, 32 at 192, 16 at 256 (Q 133 KB + 2 × 33 KB)
//        bf16: 64 at every width (203 KB at D = 256)
//      Q·Kᵀ runs over ceil(D/8) (fp32) or ceil(D/16) (bf16) k steps and
//      P·V over Dv's columns, not DM's: MLA's D = 192, Dv = 128 multiplies
//      128 columns of V.
//    * The softmax as before: each warp owns its 16 rows (two a thread,
//      combined by quad shuffles), m and l in fp32, expf and tanhf.  P's
//      fragments come straight from the S accumulator (fp32: the k slots
//      of m16n8k8 are read as keys 2t and 2t + 1, and V's rows are loaded
//      in the same order).
//    * Masks.  The key tiles outside the block's causal / window band are
//      never loaded; a tile inside the band for all of a warp's rows skips
//      the per-element mask; a warp skips a tile that none of its rows can
//      see
//      (the same bits: such a tile adds weights the row's first visible
//      key wipes with exp(-2^30 - m) = 0, or adds 0); keys past S score
//      -inf; rows past S are not written.  Inputs are read through their
//      strides in place.
//    * No spills: `arcadia_flash_kernel_info` reports registers and local
//      bytes of each instantiation.
//
// Built by kernels/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface at the end).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda.h>                      // CUtensorMap and its enums only
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // 8 warps, 16 query rows each
constexpr int kRows = 128;             // query rows of a block
constexpr int kMaxSmem = 232448;       // 227 KB, H100
constexpr float kNegInf = -1073741824.f;  // -2^30, the plain version's mask value

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;          // element strides: batch, head, seq
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float* lse;                          // [B,H,S] fp32 (seq stride 1), or null
  long long l_sb, l_sh;
  int S, D, Dv, rep, nq;               // Dv <= D: v's and o's head dim
  int causal, window;                  // window <= 0: none
  float scale, cap;                    // cap <= 0: none
};

// ------------------- mma.sync route: fp32 (3 × TF32) and bf16 ------------------- //

// The instantiation's width: D rounded up to 64, 128, 192 or 256.
__host__ __device__ constexpr int mma_width(int D) {
  return D <= 64 ? 64 : D <= 128 ? 128 : D <= 192 ? 192 : 256;
}
// Keys of a K/V tile: two stages of K and V beside 128 rows of Q at D = DM.
__host__ __device__ constexpr int mma_keys(bool tf32, int DM) {
  return !tf32 ? 64 : DM <= 128 ? 64 : DM == 192 ? 32 : 16;
}
// Elements of a staged row of n columns: fp32 rows 8k + 4 floats, bf16 rows
// 16k + 8 (both keep fragment loads and ldmatrix free of bank conflicts).
__host__ __device__ constexpr int tile_ld(int n, bool tf32) {
  return tf32 ? (n + 7) / 8 * 8 + 4 : (n + 15) / 16 * 16 + 8;
}
// Q [128][ldk] and two stages of K [Bc][ldk] and V [Bc][ldv].
__host__ __device__ constexpr int mma_smem_bytes(int D, int Dv, bool tf32) {
  return (tf32 ? 4 : 2) *
         (kRows * tile_ld(D, tf32) +
          2 * mma_keys(tf32, mma_width(D)) * (tile_ld(D, tf32) + tile_ld(Dv, tf32)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four consecutive elements (16 B of fp32, 8 B of bf16) from global into
// shared memory, zeros where !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// rows [r0, r0 + rows) of a [S, n] slice (row stride ld_g) into shared rows
// ld_s apart, by cp.async; rows past S arrive as zeros
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld_s, const T* src, long long ld_g,
                                          int r0, int rows, int S, int n) {
  const int quads = n >> 2;
  const int step = blockDim.x;
  const int dr = step / quads, dc = (step - dr * quads) * 4;   // a step's rows, columns
  int r = threadIdx.x / quads, c = (threadIdx.x - r * quads) * 4;
  for (; r < rows; r += dr, c += dc) {
    if (c >= n) {
      c -= n;
      ++r;
      if (r >= rows) break;
    }
    const bool ok = r0 + r < S;
    cp_async4(dst + r * ld_s + c, ok ? src + static_cast<long long>(r0 + r) * ld_g + c : src,
              ok);
  }
}

// x as a TF32 operand, rounded as cvt.rna.tf32.f32 rounds it (to nearest,
// ties away from zero) but on the bits, two integer operations on the
// integer pipe rather than a conversion; and the split x ≈ hi + lo of two
// TF32 values
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
// d += a·b: a 16x8 (row), b 8x8 (col), TF32; d 16x8 fp32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a·b in three TF32 products, the small ones first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}
// c += a·b with the three products summed in a fresh accumulator and added
// to c in fp32 (round to nearest): the tensor cores' own sum truncates, and
// a long sum kept in their accumulator (O over 8192 keys) drifts with it
__device__ __forceinline__ void mma3_add(float (&c)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(d, ah, al, bh, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}
// d += a·b: a 16x16 (row), b 16x8 (col), bf16; d 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// four 8x8 bf16 matrices from shared memory, one row address a lane
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
// A lane's row address for ldmatrix.x4 (ld: the shared row in elements):
//   A 16x16 at (m0, k0) stored [m][k]: a_rows, ldsm_x4
//   B 16(k) x 16(n) at (k0, n0), the n8 fragments {r0, r1} and {r2, r3}:
//     stored [n][k]: b_rows, ldsm_x4;  stored [k][n]: b_cols, ldsm_x4_t
__device__ __forceinline__ const __nv_bfloat16* a_rows(const __nv_bfloat16* s, int ld, int m0,
                                                       int k0, int lane) {
  return s + (m0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + k0 + (lane >> 4) * 8;
}
__device__ __forceinline__ const __nv_bfloat16* b_rows(const __nv_bfloat16* s, int ld, int k0,
                                                       int n0, int lane) {
  return s + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const __nv_bfloat16* b_cols(const __nv_bfloat16* s, int ld, int k0,
                                                       int n0, int lane) {
  return s + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0 + (lane >> 4) * 8;
}

// s[16 x 8·NT] = Q[m0.., :D]·K[:8·NT, :D]ᵀ over nk k steps, Q and K [rows][ld]
template <int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* Q, const float* K,
                                       int ld, int m0, int nk, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* qa = Q + (m0 + g) * ld + t;
  const float* kb = K + g * ld + t;
#pragma unroll 4
  for (int kk = 0; kk < nk; ++kk, qa += 8, kb += 8) {
    uint32_t ah[4], al[4];
    split(qa[0], ah[0], al[0]);              // (g, t)
    split(qa[8 * ld], ah[1], al[1]);         // (g + 8, t)
    split(qa[4], ah[2], al[2]);              // (g, t + 4)
    split(qa[8 * ld + 4], ah[3], al[3]);     // (g + 8, t + 4)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
      split(kb[nt * 8 * ld], bh[0], bl[0]);      // (k t, key g)
      split(kb[nt * 8 * ld + 4], bh[1], bl[1]);  // (k t + 4, key g)
      mma3(s[nt], ah, al, bh, bl);
    }
  }
}
template <int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const __nv_bfloat16* Q,
                                       const __nv_bfloat16* K, int ld, int m0, int nk,
                                       int lane) {
  static_assert(NT % 2 == 0, "bf16 takes keys 16 at a time");
#pragma unroll 2
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t qa[4];
    ldsm_x4(qa, a_rows(Q, ld, m0, 16 * kk, lane));
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t kb[4];
      ldsm_x4(kb, b_rows(K, ld, 16 * kk, 16 * j, lane));
      mma_bf16(s[2 * j], qa, kb[0], kb[1]);
      mma_bf16(s[2 * j + 1], qa, kb[2], kb[3]);
    }
  }
}

// o[16 x 8·NO] += P[16 x 8·NT]·V[8·NT, :Dv] with P in the S accumulator's
// registers and V [keys][ld]; nv n8 tiles of O are live (Dv's)
template <int NT, int NO>
__device__ __forceinline__ void pv(float (&o)[NO][4], const float (&p)[NT][4], const float* V,
                                   int ld, int nv, int lane) {
  static_assert(NO % 4 == 0, "O is taken 32 columns at a time");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    // the k slots t and t + 4 of this step are keys 8j + 2t and 8j + 2t + 1,
    // where the accumulator holds P, and V's rows are read in that order
    uint32_t ah[4], al[4];
    split(p[j][0], ah[0], al[0]);
    split(p[j][2], ah[1], al[1]);
    split(p[j][1], ah[2], al[2]);
    split(p[j][3], ah[3], al[3]);
    const float* vb = V + (8 * j + 2 * t) * ld + g;
    // four n8 tiles a step, their loads ahead of their products; a step
    // whose first tile is live runs whole (its dead tiles' columns are
    // never stored)
#pragma unroll
    for (int c4 = 0; c4 < NO / 4; ++c4) {
      if (4 * c4 < nv) {
        float v0[4], v1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v0[i] = vb[(4 * c4 + i) * 8];
          v1[i] = vb[ld + (4 * c4 + i) * 8];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t bh[2], bl[2];
          split(v0[i], bh[0], bl[0]);
          split(v1[i], bh[1], bl[1]);
          mma3_add(o[4 * c4 + i], ah, al, bh, bl);
        }
      }
    }
  }
}
template <int NT, int NO>
__device__ __forceinline__ void pv(float (&o)[NO][4], const float (&p)[NT][4],
                                   const __nv_bfloat16* V, int ld, int nv, int lane) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    // P rounded to bf16 (the plain version rounds p to v's dtype)
    const uint32_t pa[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                            pack_bf16(p[2 * j][2], p[2 * j][3]),
                            pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                            pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int c4 = 0; c4 < NO / 4; ++c4) {
      if (4 * c4 < nv) {                      // 32 columns a step, as fp32
        uint32_t vb[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) ldsm_x4_t(vb[i], b_cols(V, ld, 16 * j, 32 * c4 + 16 * i, lane));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(o[4 * c4 + 2 * i], pa, vb[i][0], vb[i][1]);
          mma_bf16(o[4 * c4 + 2 * i + 1], pa, vb[i][2], vb[i][3]);
        }
      }
    }
  }
}

// two adjacent outputs (an even column of a row whose stride is a
// multiple of 4 elements)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const Args a) {
  constexpr bool kTf32 = sizeof(T) == 4;
  constexpr int Bc = mma_keys(kTf32, DM);
  constexpr int NT = Bc / 8;                  // n8 tiles of S
  constexpr int NO = DM / 8;                  // n8 tiles of O
  extern __shared__ float4 smem4[];
  const int ldk = tile_ld(a.D, kTf32), ldv = tile_ld(a.Dv, kTf32);
  const int stage = Bc * (ldk + ldv);
  T* ring = reinterpret_cast<T*>(smem4);      // stage s: K, then V
  T* Qs = ring + 2 * stage;                   // after the ring: P·V's last
                                              // chunk may read past V's end

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = a.nq - 1 - static_cast<int>(blockIdx.x);   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.rep;
  const int q0 = qt * kRows;
  const int m0 = 16 * warp;                   // the warp's rows q0 + m0 ..
  const int S = a.S;

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  // zero the tiles once: the columns past D and Dv stay zero
  {
    const int n = mma_smem_bytes(a.D, a.Dv, kTf32) / 16;
    for (int i = tid; i < n; i += kThreads) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // the key tiles some row of this block can see
  const int k_last = a.causal ? min(S - 1, q0 + kRows - 1) : S - 1;
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_lo = k_first / Bc;
  const int kt_hi = k_last / Bc;
  auto issue = [&](int kt, int st) {
    T* Ks = ring + st * stage;
    copy_rows(Ks, ldk, kg, a.k_ss, kt * Bc, Bc, S, a.D);
    copy_rows(Ks + Bc * ldk, ldv, vg, a.v_ss, kt * Bc, Bc, S, a.Dv);
  };
  copy_rows(Qs, ldk, qg, a.q_ss, q0, kRows, S, a.D);
  issue(kt_lo, 0);
  cp_async_commit();

  const int nk = kTf32 ? (a.D + 7) / 8 : (a.D + 15) / 16;    // k steps of Q·Kᵀ
  const int nv = (a.Dv + 7) / 8;                             // live n8 tiles of O
  const int r_lo = q0 + m0;                   // the warp's first and last rows
  const int r_hi = r_lo + 15;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    if (kt < kt_hi) {                         // the next tile lands meanwhile
      issue(kt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * Bc;
    // a tile none of the warp's rows can see changes nothing (see the note)
    const bool seen = r_lo < S && (!a.causal || k0 <= r_hi) &&
                      (a.window <= 0 || k0 + Bc - 1 > r_lo - a.window);
    if (seen) {
      const T* Ks = ring + st * stage;
      const T* Vs = Ks + Bc * ldk;
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      scores<NT>(s, Qs, Ks, ldk, m0, nk, lane);

      // scale, cap and mask (only where the tile crosses the band's edge
      // or the end for one of the warp's rows); then the online softmax of
      // rows g and g + 8
      const bool inside = (!a.causal || k0 + Bc - 1 <= r_lo) &&
                          (a.window <= 0 || k0 > r_hi - a.window) && k0 + Bc <= S;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * a.scale;
          if (a.cap > 0.f) x = tanhf(x / a.cap) * a.cap;
          if (!inside) {
            const int qpos = r_lo + g + 8 * (e >> 1);
            const int kpos = k0 + 8 * nt + 2 * t + (e & 1);
            bool ok = true;
            if (a.causal) ok = kpos <= qpos;
            if (a.window > 0) ok = ok && kpos > qpos - a.window;
            x = ok ? x : kNegInf;
            if (kpos >= S) x = -INFINITY;     // past the end: no weight at all
          }
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));   // the row's quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m[r], mx[r]);
        alpha[r] = expf(m[r] - m_new[r]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[nt][e] - m_new[e >> 1]);
          s[nt][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * alpha[r] + rs[r];
        m[r] = m_new[r];
      }
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        o[nt][0] *= alpha[0];
        o[nt][1] *= alpha[0];
        o[nt][2] *= alpha[1];
        o[nt][3] *= alpha[1];
      }
      pv<NT, NO>(o, s, Vs, ldv, nv, lane);
    }
    __syncthreads();                          // the stage is free for tile kt + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r_lo + g + 8 * r;
    if (qpos >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    if (a.lse != nullptr && t == 0)          // log-sum-exp of the row's scores
      a.lse[b * a.l_sb + h * a.l_sh + qpos] = m[r] + logf(den);
    T* row = og + static_cast<long long>(qpos) * a.o_ss;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < a.Dv) store2(row + col, o[nt][2 * r] / den, o[nt][2 * r + 1] / den);
    }
  }
}

template <typename T, int DM>
int launch(const Args& a, int batch, int heads, cudaStream_t stream) {
  const int bytes = mma_smem_bytes(a.D, a.Dv, sizeof(T) == 4);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.nq), static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  flash_fwd_kernel<T, DM><<<grid, kThreads, static_cast<size_t>(bytes), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int batch, int heads, cudaStream_t stream) {
  switch (mma_width(a.D)) {
    case 64: return launch<T, 64>(a, batch, heads, stream);
    case 128: return launch<T, 128>(a, batch, heads, stream);
    case 192: return launch<T, 192>(a, batch, heads, stream);
    default: return launch<T, 256>(a, batch, heads, stream);
  }
}

template <typename T>
const void* mma_kernel(int D) {
  switch (mma_width(D)) {
    case 64: return reinterpret_cast<const void*>(flash_fwd_kernel<T, 64>);
    case 128: return reinterpret_cast<const void*>(flash_fwd_kernel<T, 128>);
    case 192: return reinterpret_cast<const void*>(flash_fwd_kernel<T, 192>);
    default: return reinterpret_cast<const void*>(flash_fwd_kernel<T, 256>);
  }
}

// --------------- tensor-core route: bf16 at the serving (D, Dv) pairs --------------- //

constexpr int kTcRows = 128;           // query rows of a block: two consumer warpgroups
constexpr int kTcThreads = 384;        // producer warpgroup + two consumer warpgroups
constexpr int kStages = 2;             // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// q/k head dim D, v head dim Dv (both multiples of 16, Dv <= D).  A row
// is loaded as 64-column boxes of 128 bytes; a box that reaches past the
// head dim (D = 80: columns 64..127 of which 80..127 lie outside the
// view) arrives with its outside columns zero, and TMA's complete_tx
// counts the whole box, so every byte count below is boxes·rows·128.
template <int D, int Dv>
struct TcCfg {
  static_assert(D % 16 == 0 && Dv % 16 == 0 && Dv <= D, "head dims");
  static constexpr int kBc = D == 256 ? 64 : 128;       // keys of a tile
  static constexpr int kBoxes = (D + 63) / 64;          // boxes of a Q or K row
  static constexpr int kVBoxes = (Dv + 63) / 64;        // boxes of a V row
  static constexpr int kN = 64 * kVBoxes;               // P·V's width: O's columns
  static constexpr int kQBytes = kTcRows * kBoxes * 128;
  static constexpr int kKBytes = kBc * kBoxes * 128;    // one K tile
  static constexpr int kVBytes = kBc * kVBoxes * 128;   // one V tile
  static constexpr int kBarBytes = 128;                 // 1 + 4·kStages mbarriers
  static constexpr int kSmem =
      1024 + kQBytes + kStages * (kKBytes + kVBytes) + kBarBytes;
  static_assert(kSmem <= kMaxSmem, "tile plan exceeds 227 KB");
};

struct TcArgs {
  CUtensorMap qmap, kmap, vmap;        // (D, S, heads, batch) views, 128-byte swizzle
  void* o;
  long long o_sb, o_sh, o_ss;
  float* lse;                          // as Args::lse
  long long l_sb, l_sh;
  int S, rep, nq, causal, window;
  float scale, cap;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// box (64 columns, rows, 1, 1) of a 4-D tensor map at (c0, c1, c2, c3)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most N committed groups of this warpgroup are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// named barrier `id` among `count` threads: wait at it, or only arrive
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] * B[16 x 64], A in registers (bf16 pairs), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] * B[16 x 128], A in registers (bf16 pairs), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 256] += A[64 x 16] * B[16 x 256], A in registers (bf16 pairs), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// uint32 registers read asynchronously by wgmma (the A operand): keep them
// live and unmoved until the product has completed
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {   // 2^-22 relative
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// What a consumer thread needs to turn its scores into softmax weights.
struct RowCtx {
  int q_row;           // query position of fragment row 0 (row 1 is + 8)
  int col0;            // key column of fragment column 0 within a tile
  int S, causal, window;
  float pre, post;     // with a cap: x = tanh(s·pre)·post, the log2 domain
  float mul;           // weight = exp2(x·mul - m·mul): scale·log2(e), or 1
};

// Scores of one tile (fragment sc, keys k0 ..) to unnormalised weights:
// softcap (kCap) and mask (kEdge: only tiles a mask or the end cuts), then
// update the running max m and sum l of the thread's two rows, return each
// row's factor exp2((m_old - m_new)·mul) for the accumulator, and leave
// exp2((x - m)·mul) in sc.  Without a cap x is the raw product and its
// scale goes into the one FMA before exp2; with a cap log2(e) is folded in
// after tanh.
template <int Bc, bool kCap, bool kEdge>
__device__ __forceinline__ void online_softmax(float (&sc)[Bc / 2], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2],
                                               const RowCtx& c, int k0) {
  // visible keys of each row as offsets from this thread's first column:
  // lo[r] .. hi[r], and none past `end` (the last key, S - 1)
  int lo[2], hi[2], end = 0;
  if constexpr (kEdge) {
    const int base = k0 + c.col0;
    end = c.S - 1 - base;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = c.q_row + 8 * r;
      lo[r] = (c.window > 0 ? q - c.window + 1 : 0) - base;
      hi[r] = (c.causal ? q : c.S - 1) - base;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < Bc / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = sc[4 * j + e];
      if constexpr (kCap) x = tanhf(x * c.pre) * c.post;
      if constexpr (kEdge) {
        const int off = 8 * j + (e & 1);               // a constant
        x = off < lo[r] || off > hi[r] ? kNegInf : x;
        x = off > end ? -INFINITY : x;                 // past the end: no weight
      }
      sc[4 * j + e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {                        // a row's 4 threads
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = fast_exp2((m[r] - m_new) * c.mul);
    m[r] = m_new;
    mb[r] = m_new * c.mul;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < Bc / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(sc[4 * j + e], c.mul, -mb[e >> 1]));
      l[e >> 1] += p;
      sc[4 * j + e] = p;
    }
}

// P rounded to bf16 and packed as the A operand of P·V: the accumulator's
// fragment of keys 16ks .. 16ks + 15 is that operand's fragment
template <int Bc>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[Bc / 16][4],
                                       const float (&sc)[Bc / 2]) {
#pragma unroll
  for (int ks = 0; ks < Bc / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[ks][r] = pack_bf16(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
  // a warp whose rows all kept their max skips it (exact: the factor is 1)
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

template <int D, int Dv, bool kCap>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wgmma(const __grid_constant__ TcArgs a) {
  using C = TcCfg<D, Dv>;
  constexpr int Bc = C::kBc;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes of shared address: align the ring
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = q_s + C::kQBytes;                    // stage st at + st·kKBytes
  uint8_t* v_s = k_s + kStages * C::kKBytes;          // stage st at + st·kVBytes
  uint64_t* bar = reinterpret_cast<uint64_t*>(v_s + kStages * C::kVBytes);
  uint64_t* q_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* v_full = bar + 1 + kStages;
  uint64_t* k_empty = bar + 1 + 2 * kStages;
  uint64_t* v_empty = bar + 1 + 3 * kStages;

  const int qt = a.nq - 1 - static_cast<int>(blockIdx.x);   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.rep;
  const int q0 = qt * kTcRows;
  const int S = a.S;
  // the key tiles some row of this block can see
  const int k_last = a.causal ? min(S - 1, q0 + kTcRows - 1) : S - 1;
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_lo = k_first / Bc;
  const int n_tiles = k_last / Bc - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(k_empty + st, 2 * 128);                // every consumer thread
      mbar_init(v_empty + st, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------ producer ------------------------------ //
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load(q_s + c * kTcRows * 128, &a.qmap, q_full, 64 * c, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const int free_parity = ((i / kStages) & 1) ^ 1;  // the slot's last use
        const int k0 = (kt_lo + i) * Bc;
        uint8_t* kd = k_s + st * C::kKBytes;
        uint8_t* vd = v_s + st * C::kVBytes;
        mbar_wait(k_empty + st, free_parity);
        mbar_expect_tx(k_full + st, C::kKBytes);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load(kd + c * Bc * 128, &a.kmap, k_full + st, 64 * c, k0, kvh, b);
        mbar_wait(v_empty + st, free_parity);
        mbar_expect_tx(v_full + st, C::kVBytes);
#pragma unroll
        for (int c = 0; c < C::kVBoxes; ++c)
          tma_load(vd + c * Bc * 128, &a.vmap, v_full + st, 64 * c, k0, kvh, b);
      }
    }
  } else {
    // ----------------------------- consumers ------------------------------ //
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int cw = wg - 1;                             // rows 64·cw .. 64·cw + 63
    const int t = threadIdx.x - 128 * wg;
    const int row0 = 16 * (t / 32) + (t % 32) / 4;     // and row0 + 8
    const int q0w = q0 + 64 * cw;
    RowCtx ctx;
    ctx.q_row = q0w + row0;
    ctx.col0 = 2 * (t % 4);                            // and + 1, + 8·j
    ctx.S = S;
    ctx.causal = a.causal;
    ctx.window = a.window;
    ctx.pre = kCap ? a.scale / a.cap : 0.f;
    ctx.post = a.cap * kLog2e;
    ctx.mul = kCap ? 1.f : a.scale * kLog2e;
    // a tile that needs the per-element mask for these 64 rows: the causal
    // diagonal and the tiles past it, the window's edge and the tiles
    // before it, the ragged end.  Both warpgroups walk all the block's
    // tiles, so that they can take turns; a tile that is masked for all of
    // a warpgroup's rows adds exactly nothing (see the note at the top)
    auto edge = [&](int k0) {
      return k0 + Bc > S || (a.causal && k0 + Bc - 1 > q0w) ||
             (a.window > 0 && k0 <= q0w + 63 - a.window);
    };
    // descriptors of this warpgroup's Q rows and of the stages' K and V
    // tiles; a step adds its byte offset / 16 to the start-address field
    const uint64_t q_desc = smem_desc(smem_u32(q_s) + cw * 64 * 128, 16, 1024);
    // S = Q·Kᵀ of tile i into sc: D/16 steps of k16 (the zero columns of a
    // last box past D are never multiplied), Q and K K-major, each
    // 64-column box after the last, 32 bytes a step within a box
    auto issue_qk = [&](float (&sc)[Bc / 2], int i) {
      const uint64_t k_desc =
          smem_desc(smem_u32(k_s + (i % kStages) * C::kKBytes), 16, 1024);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int col = (kk % 4) * 2;
        wgmma_ss(sc, q_desc + (kk / 4) * kTcRows * 8 + col,
                 k_desc + (kk / 4) * Bc * 8 + col, kk > 0);
      }
    };
    // O += P·V of tile i: Bc/16 steps of k16 (16 key rows, 2048 bytes, a
    // step), N = kN (Dv rounded up to whole boxes: at Dv = 80 the 48 zero
    // columns give O columns that are never written), V MN-major with its
    // 64-column boxes Bc·128 bytes apart
    auto issue_pv = [&](float (&o)[C::kN / 2], uint32_t (&pa)[Bc / 16][4], int i) {
      const uint64_t v_desc =
          smem_desc(smem_u32(v_s + (i % kStages) * C::kVBytes), Bc * 128, 1024);
#pragma unroll
      for (int ks = 0; ks < Bc / 16; ++ks) wgmma_rs(o, pa[ks], v_desc + ks * 128);
    };
    // The two warpgroups take turns at issuing their products (named
    // barriers 1 and 2, 256 threads): while one runs its softmax the other's
    // wgmmas keep the tensor cores busy.  Warpgroup 1 hands warpgroup 0 the
    // first turn; each turn ends by handing over.
    const int my_turn = 1 + cw, their_turn = 2 - cw;
    if (cw == 1) bar_arrive(1, 256);

    // accumulator fragment (wgmma m64nN f32): o[4j + 2r + e] is row
    // row0 + 8r, column 8j + col0 + e; likewise the scores
    float o[C::kN / 2];
#pragma unroll
    for (int i = 0; i < C::kN / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};                   // running max
    float l[2] = {0.f, 0.f};                           // this thread's columns
    float alpha[2];
    float sc[Bc / 2];
    uint32_t pa[Bc / 16][4];
    // the softmax of tile i, on fragment sc, without the mask where it
    // cannot bite
    auto softmax = [&](int i) {
      const int k0 = (kt_lo + i) * Bc;
      if (edge(k0))
        online_softmax<Bc, kCap, true>(sc, m, l, alpha, ctx, k0);
      else
        online_softmax<Bc, kCap, false>(sc, m, l, alpha, ctx, k0);
    };

    mbar_wait(q_full, 0);
    {                                                  // the first tile
      mbar_wait(k_full, 0);
      bar_sync(my_turn, 256);
      fence_regs(sc);
      wgmma_fence();
      issue_qk(sc, 0);
      wgmma_commit();
      bar_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(k_empty);
      softmax(0);
      pack_p<Bc>(pa, sc);
    }
    // tile i's scores and softmax run while P·V of tile i - 1 is in flight
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % kStages, ph = (i / kStages) & 1;
      const int sp = (i - 1) % kStages, pp = ((i - 1) / kStages) & 1;
      mbar_wait(k_full + st, ph);
      mbar_wait(v_full + sp, pp);
      bar_sync(my_turn, 256);
      fence_regs(sc);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      issue_qk(sc, i);
      wgmma_commit();
      issue_pv(o, pa, i - 1);
      wgmma_commit();
      bar_arrive(their_turn, 256);
      wgmma_wait<1>();                                 // Q·Kᵀ of tile i done
      fence_regs(sc);
      mbar_arrive(k_empty + st);
      softmax(i);
      wgmma_wait<0>();                                 // P·V of tile i - 1 done
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(v_empty + sp);
      rescale(o, alpha);
      pack_p<Bc>(pa, sc);
    }
    {                                                  // P·V of the last tile
      const int st = (n_tiles - 1) % kStages, ph = ((n_tiles - 1) / kStages) & 1;
      mbar_wait(v_full + st, ph);
      bar_sync(my_turn, 256);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      issue_pv(o, pa, n_tiles - 1);
      wgmma_commit();
      bar_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(v_empty + st);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = ctx.q_row + 8 * r;
      if (qpos >= S) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      // the row's log-sum-exp in the natural-log units of the scaled
      // scores: m is in the units the weights' exp2 takes before `mul`
      if (a.lse != nullptr && (t % 4) == 0)
        a.lse[b * a.l_sb + h * a.l_sh + qpos] =
            m[r] * ctx.mul * kLn2 + logf(fmaxf(l[r], 1e-30f));
      __nv_bfloat16* row = og + static_cast<long long>(qpos) * a.o_ss + ctx.col0;
#pragma unroll
      for (int j = 0; j < Dv / 8; ++j)                 // the Dv live columns
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// bf16 view (D, S, heads, batch) with element strides (1, ss, sh, sb); the
// box is 64 columns × `rows` rows of one head of one batch
bool encode_view(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D, int S,
                 int heads, int batch, long long ss, long long sh, long long sb,
                 int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int Dv>
int launch_tc(const Args& a, int batch, int heads, int kv_heads, cudaStream_t stream) {
  using C = TcCfg<D, Dv>;
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  TcArgs t;
  std::memset(&t, 0, sizeof(t));
  if (!encode_view(enc, &t.qmap, a.q, D, a.S, heads, batch, a.q_ss, a.q_sh, a.q_sb,
                   kTcRows) ||
      !encode_view(enc, &t.kmap, a.k, D, a.S, kv_heads, batch, a.k_ss, a.k_sh,
                   a.k_sb, C::kBc) ||
      !encode_view(enc, &t.vmap, a.v, Dv, a.S, kv_heads, batch, a.v_ss, a.v_sh,
                   a.v_sb, C::kBc))
    return static_cast<int>(cudaErrorInvalidValue);
  t.o = a.o;
  t.o_sb = a.o_sb;
  t.o_sh = a.o_sh;
  t.o_ss = a.o_ss;
  t.lse = a.lse;
  t.l_sb = a.l_sb;
  t.l_sh = a.l_sh;
  t.S = a.S;
  t.rep = a.rep;
  t.nq = (a.S + kTcRows - 1) / kTcRows;
  t.causal = a.causal;
  t.window = a.window;
  t.scale = a.scale;
  t.cap = a.cap;
  auto kernel = t.cap > 0.f ? flash_fwd_wgmma<D, Dv, true> : flash_fwd_wgmma<D, Dv, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(t.nq), static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  kernel<<<grid, kTcThreads, C::kSmem, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// The (q/k head dim, v head dim) pairs the tensor-core kernel is built
// for: f(Pair<D, Dv>{}) for the pair whose q/k head dim is `D` (256's for
// any other D; callers check tc_pair first).
template <int D, int Dv>
struct Pair {
  static constexpr int kD = D, kDv = Dv;
};

template <typename F>
int on_tc_pair(int D, F f) {
  switch (D) {
    case 64: return f(Pair<64, 64>{});
    case 80: return f(Pair<80, 80>{});
    case 128: return f(Pair<128, 128>{});
    case 192: return f(Pair<192, 128>{});
    default: return f(Pair<256, 256>{});
  }
}

bool tc_pair(int D, int Dv) {
  return on_tc_pair(D, [&](auto p) { return decltype(p)::kD == D && decltype(p)::kDv == Dv; });
}

// TMA's rules: 16-byte aligned base addresses and strides
bool tc_aligned(const Args& a) {
  auto ptr_ok = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const long long strides[12] = {a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh, a.k_ss,
                                 a.v_sb, a.v_sh, a.v_ss, a.o_sb, a.o_sh, a.o_ss};
  for (long long s : strides)
    if (s % 8) return false;
  return ptr_ok(a.q) && ptr_ok(a.k) && ptr_ok(a.v) && ptr_ok(a.o);
}

// attributes of a kernel into out[5..8]: registers, local (spill) bytes,
// static shared bytes, max threads a block
int kernel_attributes(const void* fn, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[5] = fa.numRegs;
  out[6] = static_cast<int>(fa.localSizeBytes);
  out[7] = static_cast<int>(fa.sharedSizeBytes);
  out[8] = fa.maxThreadsPerBlock;
  return 0;
}

// the plan and attributes of flash_fwd_wgmma<D, Dv> into out[0..8]
template <int D, int Dv>
int tc_info(int capped, int* out) {
  using C = TcCfg<D, Dv>;
  out[0] = 1;
  out[1] = kTcRows;
  out[2] = C::kBc;
  out[3] = kStages;
  out[4] = C::kSmem;
  return kernel_attributes(capped ? reinterpret_cast<const void*>(flash_fwd_wgmma<D, Dv, true>)
                                  : reinterpret_cast<const void*>(flash_fwd_wgmma<D, Dv, false>),
                           out);
}

}  // namespace

// Attention of q [batch, heads, seqlen, headdim] against k [batch,
// kv_heads, seqlen, headdim] and v [batch, kv_heads, seqlen, vdim] into o
// [batch, heads, seqlen, vdim] (vdim <= headdim), each given by its
// data pointer and its batch, head and sequence strides in elements (the
// head dim is contiguous, and every stride and pointer a multiple of four
// elements).  dtype: 0 for fp32, 1 for bf16, the same for all four.
// lse, unless null, receives each row's log-sum-exp of its scaled,
// capped and masked scores (fp32 [batch, heads, seqlen], batch and head
// strides l_sb and l_sh, sequence stride 1): what the backward kernels
// (flash_attention_bwd.cu) recompute the softmax from.
// window <= 0 means no window, cap <= 0 no softcap.  bf16 at the
// (headdim, vdim) pairs (64, 64), (80, 80), (128, 128), (192, 128) and
// (256, 256) with 16-byte aligned pointers and strides goes to the
// tensor-core kernel, everything else to the CUDA-core kernel; *route is
// set to 1 or 0 accordingly.  Launches one kernel on
// `stream`, does not synchronise, and returns the cudaError_t of the launch
// (0 on success).
extern "C" int arcadia_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float* lse, long long l_sb, long long l_sh,
    int batch, int heads, int kv_heads, int seqlen, int headdim, int vdim,
    int causal, int window, float scale, float cap, int dtype, void* stream,
    int* route) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || seqlen <= 0 || headdim <= 0 ||
      vdim <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (heads % kv_heads || headdim > 256 || headdim % 4 || vdim > headdim ||
      vdim % 4 || heads > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o,
         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
         lse, l_sb, l_sh, seqlen, headdim, vdim, heads / kv_heads, (seqlen + kRows - 1) / kRows,
         causal, window, scale, cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = 0;
  if (dtype == 0) return dispatch<float>(a, batch, heads, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (tc_pair(headdim, vdim) && tc_aligned(a)) {
    *route = 1;
    return on_tc_pair(headdim, [&](auto p) {
      return launch_tc<decltype(p)::kD, decltype(p)::kDv>(a, batch, heads, kv_heads, s);
    });
  }
  return dispatch<__nv_bfloat16>(a, batch, heads, s);
}

// The plan and attributes of the kernel that serves (dtype, headdim, vdim,
// with or without a softcap) when the alignment allows the tensor cores,
// or (mma != 0) when it does not: out[0] route (1 wgmma, 0 mma.sync — the
// "cuda_cores" route), out[1] query rows of a
// block, out[2] keys of a tile, out[3] K/V stages, out[4] dynamic shared
// bytes of a launch, out[5] registers a thread, out[6] local (spill) bytes
// a thread, out[7] static shared bytes, out[8] max threads a block.
// Returns a cudaError_t (0 on success).
extern "C" int arcadia_flash_kernel_info(int dtype, int headdim, int vdim, int capped,
                                         int mma, int* out) {
  if (headdim <= 0 || headdim > 256 || headdim % 4 || vdim <= 0 || vdim > headdim ||
      vdim % 4 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && tc_pair(headdim, vdim) && !mma)
    return on_tc_pair(headdim, [&](auto p) {
      return tc_info<decltype(p)::kD, decltype(p)::kDv>(capped, out);
    });
  out[0] = 0;
  out[1] = kRows;
  out[2] = mma_keys(dtype == 0, mma_width(headdim));
  out[3] = 2;
  out[4] = mma_smem_bytes(headdim, vdim, dtype == 0);
  const void* fn = dtype == 0 ? mma_kernel<float>(headdim) : mma_kernel<__nv_bfloat16>(headdim);
  return kernel_attributes(fn, out);
}
