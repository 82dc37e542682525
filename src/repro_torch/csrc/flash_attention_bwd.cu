// Backward of flash attention for Hopper (sm_90a) on `mma.sync`: dq, dk
// and dv of the forward in flash_attention.cu (causal mask, sliding window,
// tanh logit softcap, GQA, a value head dim Dv <= D) for what the
// tensor-core route (flash_attention_bwd_tc.cu) does not take: fp32, bf16
// at other head dims, and bf16 views that are not 16-byte aligned.
//
// Gradient of the JAX package's Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention/flash_attention.py).  The JAX package
// has no backward kernel: it trains attention through `jax.grad` of its
// jnp strategies (src/repro/models/layers.py).  This source computes the
// contract of `attention_backward_reference`
// (kernels/flash_attention/ref.py).  For query head h (kv head h / G) and
// query row s, with x the scaled scores:
//
//     x_st  = scale · q_s·k_t,  then x <- cap·tanh(x / cap) with a cap
//     p_st  = exp(x_st - lse_s)       (0 where the mask hides t from s)
//     delta_s = Σ_c dO_sc O_sc
//     dP_st = dO_s · v_t
//     dS_st = p_st (dP_st - delta_s) (1 - (x_st / cap)²)   (the last factor
//             only with a cap: the capped score's derivative, from tanhf)
//     dq_s  = scale Σ_t dS_st k_t
//     dk_t  = scale Σ_{h in the group} Σ_s dS_st q_s
//     dv_t  =       Σ_{h in the group} Σ_s bf(p_st) dO_s
//
// where lse is the forward's per-row log-sum-exp (its `lse` output) and
// bf() rounds p to v's dtype where it meets dO, as the forward rounds p
// before P·V.  The inputs hold no P, so S is recomputed.
//
// What bounds it.  The function needs 2·(3D + 2Dv) operations per unmasked
// (query, key) pair of each head (Q·Kᵀ, dO·Vᵀ, dV, dQ, dK).  In fp32 an
// fp32-accurate product is three TF32 products, so the floor is 3·ops at
// 495 TFLOP/s (hubert-xlarge's 8 × 1500 frames, 16 heads of 80, not
// causal: 1.4 ms); in bf16 ops at 989 TFLOP/s.  Against 0.1-0.4 GB of
// inputs and outputs both are bound by operations, so the products run
// on the tensor cores, all but fp32's dP:
//
//   * fp32: S, dV, dK and dQ on `mma.sync m16n8k8` TF32, each product a·b
//     as aₗ·bₕ + aₕ·bₗ + aₕ·bₕ with hi = tf32(x) and lo = tf32(x − hi),
//     rounded as cvt.rna.tf32.f32 rounds but on the bits (22 of fp32's 24
//     bits; the dropped aₗ·bₗ is 2^-22 of a·b).  Q, K, V and dO sit in
//     shared memory as they arrive and each fragment is split as a warp
//     loads it, once for its three products (a split copy would double
//     every staged tile); P and dS are split in registers.  dV, dK and dQ
//     add each step's three products, summed in a fresh accumulator, in
//     fp32 (the tensor cores' own sums truncate, and these sums run over
//     the group's rows or the keys).
//     dP = dO·Vᵀ runs as fp32 FMAs on the CUDA cores, in order over the
//     columns as the first kernel did (`dots_fp32`).  dq's row at a query
//     that sees few keys is dS = p·(dP − delta), a difference of two
//     nearly equal sums, and with dP on the tensor cores dq missed the
//     fp32 row check (1e-4 of the row, floored at 2^-8 of the largest) on
//     the card in every form tried: the three products kept in the tensor
//     cores' accumulator, each step's sum added in fp32, and six products
//     of three-part splits — the tensor cores' truncating sums, not the
//     split, set that error (PERF.md §6).
//     ref.attention_backward_split_reference mirrors this arithmetic on
//     the CPU.
//   * bf16: `mma.sync m16n8k16` bf16, fp32 sums: S and dP of bf16 inputs
//     are exact products, P meets dO rounded to bf16 (bf() above), and dS,
//     an fp32 value, meets K and Q as two bf16 operands hi = bf16(dS), lo =
//     bf16(dS − hi), so dq and dk keep 16 of its bits where one rounding
//     would keep 8 (the tensor-core route's rounding, which this route
//     does not add).
//   mma.sync and not wgmma: wgmma's tf32 form wants both operands K-major,
//   and half of these products read a tile across its rows; mma.sync reads
//   either layout (plain fragment loads for fp32, ldmatrix and its .trans
//   form for bf16).  dV, dK and dQ walk their columns 32 at a time, the
//   loads of a step ahead of its products; a step whose first column is
//   live runs whole (dead columns are never stored; its loads may reach
//   past a row's end into the next region of the plan).
//
// Three launches a call, no atomics, so two calls give the same bits:
//
//   (a) `flash_bwd_delta`: delta = rowsum(dO ∘ O) in fp32, one warp a row,
//       into an fp32 [B,H,S] scratch laid out as lse.
//   (b) `flash_bwd_dkdv`: one block per (b, kv head, tile of Bk keys), 8
//       warps.  It keeps its K and V tiles in shared memory and dK, dV in
//       registers, and walks the group's G query heads in head order and
//       each head's query tiles of Bq rows in order, so the GQA sum has a
//       fixed order; the Q, dO, lse and delta tiles come through a
//       double-buffered cp.async ring, tile i + 1 landing while tile i is
//       multiplied.  Per query tile: S = Q·Kᵀ and dP = dO·Vᵀ [Bq × Bk]
//       (warps tiled over it), P and dS into shared memory, then dV +=
//       Pᵀ·dO and dK += dSᵀ·Q (warps tiled over [Bk × D]: a warp owns 16
//       keys and D/2 or D/4 columns of both).
//   (c) `flash_bwd_dq`: one block per (b, head, Bq query rows), 8 warps,
//       walking its key tiles in order through a double-buffered ring of K
//       and V: S, dP, dS as in (b), dSᵀ into shared memory, then dQ +=
//       dS·K with dQ in registers (warps tiled over [Bq × D]).
//
// Masks as the forward does them: the tiles outside the causal / window
// band of a block are never loaded (b visits the query tiles from the key
// tile's first row, when causal, to its last key + window - 1; c the key
// tiles from q0 - window + 1 to the last row, when causal), and a warp's
// [16 × n] part of S that no pair of it can see is not multiplied; a
// masked pair has p exactly 0 (so dS is 0); rows and keys past S arrive as
// zeros and are never written.
//
// Tiles.  Rows of a staged tile are padded to 8k + 4 floats (fp32) or
// 16k + 8 bf16, P and dS rows likewise, which keeps the fragment loads
// and ldmatrix free of bank conflicts; columns past D and Dv are zero.
// Template width DM = D rounded up to 64, 128, 192 or 256 sizes the
// accumulators; the shared tiles follow the run's D and Dv.  (Bk, Bq) of
// the dK/dV launch and (Bq, Bk) of the dQ launch, chosen so that the ring's
// two stages fit 227 KB at D = DM (`bwd_keys`, `bwd_rows`, `dq_rows`,
// `dq_keys` below; `arcadia_flash_bwd_kernel_info` reports them with each
// kernel's registers and local (spill) bytes):
//     fp32 DM  64: dK/dV (64, 64), dQ (64, 64)
//     fp32 DM 128: dK/dV (64, 32), dQ (64, 64)
//     fp32 DM 192: dK/dV (64, 32), dQ (64, 32)
//     fp32 DM 256: dK/dV (32, 32), dQ (32, 32)
//     bf16:        dK/dV (64, 64), dQ (64, 64)      (231 KB of 227 at D 256)
//
// Inputs are read through their batch, head and sequence strides (the
// head dim contiguous, strides and pointers multiples of 4 elements: 16
// bytes of fp32, copied 16 bytes at a time, 8 of bf16, copied 8), so the
// layer's permuted [B,S,H,D] views and MLA's [..., 128:] value view go in
// as they are; dq, dk and dv are written through strides of their own.
//
// Built by kernels/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface at the end).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;       // 227 KB, H100
constexpr int kDeltaRows = kThreads / 32;   // delta: one warp a row

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                    // [B,H,S], strides l_sb, l_sh, 1
  float* delta;                        // scratch laid out as lse
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_ss;          // element strides: batch, head, seq
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  long long l_sb, l_sh;
  int S, D, Dv, rep;                   // rep = G, query heads of a kv head
  int causal, window;                  // window <= 0: none
  float scale, cap;                    // cap <= 0: none
};

// ------------------------------ the plan ------------------------------ //

__host__ __device__ constexpr int mma_width(int D) {
  return D <= 64 ? 64 : D <= 128 ? 128 : D <= 192 ? 192 : 256;
}
// dK/dV launch: keys of a block, query rows of a step
__host__ __device__ constexpr int bwd_keys(bool tf32, int DM) {
  return tf32 && DM == 256 ? 32 : 64;
}
__host__ __device__ constexpr int bwd_rows(bool tf32, int DM) {
  return !tf32 || DM == 64 ? 64 : 32;
}
// dQ launch: query rows of a block, keys of a step
__host__ __device__ constexpr int dq_rows(bool tf32, int DM) {
  return tf32 && DM == 256 ? 32 : 64;
}
__host__ __device__ constexpr int dq_keys(bool tf32, int DM) {
  return tf32 && DM >= 192 ? 32 : 64;
}
// Elements of a staged row of n columns (see the note).
__host__ __device__ constexpr int tile_ld(int n, bool tf32) {
  return tf32 ? (n + 7) / 8 * 8 + 4 : (n + 15) / 16 * 16 + 8;
}
__host__ __device__ constexpr int pad_ld(int n, bool tf32) { return n + (tf32 ? 4 : 8); }
// dK/dV: K [Bk][ldk], V [Bk][ldv], two stages of Q [Bq][ldk] and dO
// [Bq][ldv]; P and dS [Bq][Bk + pad] (bf16: P, dS hi, dS lo); two stages of
// lse and delta [Bq].
__host__ __device__ constexpr int dkdv_smem_bytes(int D, int Dv, bool tf32) {
  return (tf32 ? 4 : 2) * ((bwd_keys(tf32, mma_width(D)) + 2 * bwd_rows(tf32, mma_width(D))) *
                               (tile_ld(D, tf32) + tile_ld(Dv, tf32)) +
                           (tf32 ? 2 : 3) * bwd_rows(tf32, mma_width(D)) *
                               pad_ld(bwd_keys(tf32, mma_width(D)), tf32)) +
         16 * bwd_rows(tf32, mma_width(D));
}
// dQ: Q [Bq][ldk], dO [Bq][ldv], two stages of K [Bk][ldk] and V [Bk][ldv];
// dSᵀ [Bk][Bq + pad] (bf16: hi, lo); lse and delta [Bq].
__host__ __device__ constexpr int dq_smem_bytes(int D, int Dv, bool tf32) {
  return (tf32 ? 4 : 2) * ((dq_rows(tf32, mma_width(D)) + 2 * dq_keys(tf32, mma_width(D))) *
                               (tile_ld(D, tf32) + tile_ld(Dv, tf32)) +
                           (tf32 ? 1 : 2) * dq_keys(tf32, mma_width(D)) *
                               pad_ld(dq_rows(tf32, mma_width(D)), tf32)) +
         8 * dq_rows(tf32, mma_width(D));
}

// ----------------------------- primitives ----------------------------- //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// four consecutive elements (16 B of fp32, 8 B of bf16), zeros where !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(bf16* dst, const bf16* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_async1(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// rows [r0, r0 + rows) of a [S, n] slice (row stride ld_g) into shared rows
// ld_s apart; rows past S arrive as zeros
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld_s, const T* src, long long ld_g,
                                          int r0, int rows, int S, int n) {
  const int quads = n >> 2;
  const int step = kThreads;
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
// lse and delta of rows [r0, r0 + rows) (zeros past S)
__device__ __forceinline__ void copy_stats(float* lse_s, float* delta_s, const float* lse,
                                           const float* delta, int r0, int rows, int S) {
  for (int e = threadIdx.x; e < rows; e += kThreads) {
    const bool ok = r0 + e < S;
    cp_async1(lse_s + e, ok ? lse + r0 + e : lse, ok);
    cp_async1(delta_s + e, ok ? delta + r0 + e : delta, ok);
  }
}

// x as a TF32 operand, rounded as cvt.rna.tf32.f32 rounds it (to nearest,
// ties away from zero) but on the bits, two integer operations on the
// integer pipe rather than a conversion
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
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
// a long sum kept in their accumulator (dK, dV over the group's rows) drifts
__device__ __forceinline__ void mma3_add(float (&c)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(d, ah, al, bh, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
// A lane's row address for ldmatrix.x4 (ld: the shared row in elements):
//   A 16x16 at (m0, k0) stored [m][k]: a_rows, ldsm_x4; stored [k][m]: a_cols, ldsm_x4_t
//   B 16(k) x 16(n) at (k0, n0), the n8 fragments {r0, r1} and {r2, r3}:
//     stored [n][k]: b_rows, ldsm_x4;  stored [k][n]: b_cols, ldsm_x4_t
__device__ __forceinline__ const bf16* a_rows(const bf16* s, int ld, int m0, int k0, int lane) {
  return s + (m0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + k0 + (lane >> 4) * 8;
}
__device__ __forceinline__ const bf16* a_cols(const bf16* s, int ld, int m0, int k0, int lane) {
  return s + (k0 + (lane >> 4) * 8 + (lane & 7)) * ld + m0 + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* b_rows(const bf16* s, int ld, int k0, int n0, int lane) {
  return s + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* b_cols(const bf16* s, int ld, int k0, int n0, int lane) {
  return s + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0 + (lane >> 4) * 8;
}

// c[16 x 8·NT] += A[m0.., :]·B[n0.., :]ᵀ over nk k steps, both stored
// [rows][ld] with k contiguous (Q·Kᵀ)
template <int NT>
__device__ __forceinline__ void mma_nt(float (&c)[NT][4], const float* A, int lda, int m0,
                                       const float* B, int ldb, int n0, int nk, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* pa = A + (m0 + g) * lda + t;
  const float* pb = B + (n0 + g) * ldb + t;
#pragma unroll 4
  for (int kk = 0; kk < nk; ++kk, pa += 8, pb += 8) {
    uint32_t ah[4], al[4];
    split(pa[0], ah[0], al[0]);              // (g, t)
    split(pa[8 * lda], ah[1], al[1]);        // (g + 8, t)
    split(pa[4], ah[2], al[2]);              // (g, t + 4)
    split(pa[8 * lda + 4], ah[3], al[3]);    // (g + 8, t + 4)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
      split(pb[nt * 8 * ldb], bh[0], bl[0]);
      split(pb[nt * 8 * ldb + 4], bh[1], bl[1]);
      mma3(c[nt], ah, al, bh, bl);
    }
  }
}
// c[16 x 8·NT] = A[m0.., :n]·B[n0.., :n]ᵀ in fp32 FMAs on the CUDA cores,
// in order over the n columns (dO·Vᵀ in fp32: see the note on dP), at the
// accumulator's fragment positions
template <int NT>
__device__ __forceinline__ void dots_fp32(float (&c)[NT][4], const float* A, int lda, int m0,
                                          const float* B, int ldb, int n0, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* pa = A + (m0 + g) * lda;
  const float* pb = B + (n0 + 2 * t) * ldb;
  for (int d = 0; d < n; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(pa + d);
    const float4 a1 = *reinterpret_cast<const float4*>(pa + 8 * lda + d);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 b = *reinterpret_cast<const float4*>(pb + (8 * nt + e) * ldb + d);
        float& x = c[nt][e];
        float& y = c[nt][2 + e];
        x = fmaf(a0.x, b.x, x);
        x = fmaf(a0.y, b.y, x);
        x = fmaf(a0.z, b.z, x);
        x = fmaf(a0.w, b.w, x);
        y = fmaf(a1.x, b.x, y);
        y = fmaf(a1.y, b.y, y);
        y = fmaf(a1.z, b.z, y);
        y = fmaf(a1.w, b.w, y);
      }
  }
}
template <int NT>
__device__ __forceinline__ void mma_nt(float (&c)[NT][4], const bf16* A, int lda, int m0,
                                       const bf16* B, int ldb, int n0, int nk, int lane) {
  static_assert(NT % 2 == 0, "bf16 takes columns 16 at a time");
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_rows(A, lda, m0, 16 * kk, lane));
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t b[4];
      ldsm_x4(b, b_rows(B, ldb, 16 * kk, n0 + 16 * j, lane));
      mma_bf16(c[2 * j], a, b[0], b[1]);
      mma_bf16(c[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// c[16 x 8·NT] += A[:, m0..]ᵀ·B[:, n0..] over k = 0..kdim, both stored
// [k][ld] (Pᵀ·dO, dSᵀ·Q, dS·K from dSᵀ); the n8 tiles at and past column
// `live` are left alone.  fp32: the k slots t and t + 4 of a step are rows
// 2t and 2t + 1, which makes both operands' loads free of bank conflicts.
template <int NT>
__device__ __forceinline__ void mma_tn(float (&c)[NT][4], const float* A, int lda, int m0,
                                       const float* B, int ldb, int n0, int kdim, int live,
                                       int lane) {
  static_assert(NT % 4 == 0, "columns are taken 32 at a time");
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < kdim; k0 += 8) {
    const float* pa = A + (k0 + 2 * t) * lda + m0 + g;
    uint32_t ah[4], al[4];
    split(pa[0], ah[0], al[0]);              // (g, slot t)
    split(pa[8], ah[1], al[1]);              // (g + 8, slot t)
    split(pa[lda], ah[2], al[2]);            // (g, slot t + 4)
    split(pa[lda + 8], ah[3], al[3]);        // (g + 8, slot t + 4)
    const float* pb = B + (k0 + 2 * t) * ldb + n0 + g;
    // four n8 tiles a step, their loads ahead of their products; a step
    // whose first tile is live runs whole (dead columns are never stored;
    // the loads past a row's end land in the next region of the plan)
#pragma unroll
    for (int c4 = 0; c4 < NT / 4; ++c4) {
      if (n0 + 32 * c4 < live) {
        float b0[4], b1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          b0[i] = pb[8 * (4 * c4 + i)];
          b1[i] = pb[ldb + 8 * (4 * c4 + i)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t bh[2], bl[2];
          split(b0[i], bh[0], bl[0]);
          split(b1[i], bh[1], bl[1]);
          mma3_add(c[4 * c4 + i], ah, al, bh, bl);
        }
      }
    }
  }
}
// bf16: A as one operand (lo null) or as hi + lo, two products
template <int NT>
__device__ __forceinline__ void mma_tn(float (&c)[NT][4], const bf16* A, const bf16* A_lo,
                                       int lda, int m0, const bf16* B, int ldb, int n0,
                                       int kdim, int live, int lane) {
  static_assert(NT % 4 == 0, "columns are taken 32 at a time");
  for (int k0 = 0; k0 < kdim; k0 += 16) {
    uint32_t a[4], al[4];
    ldsm_x4_t(a, a_cols(A, lda, m0, k0, lane));
    if (A_lo != nullptr) ldsm_x4_t(al, a_cols(A_lo, lda, m0, k0, lane));
#pragma unroll
    for (int c4 = 0; c4 < NT / 4; ++c4) {
      if (n0 + 32 * c4 < live) {             // 32 columns a step, as fp32
        uint32_t b[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4_t(b[i], b_cols(B, ldb, k0, n0 + 32 * c4 + 16 * i, lane));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (A_lo != nullptr) {
            mma_bf16(c[4 * c4 + 2 * i], al, b[i][0], b[i][1]);
            mma_bf16(c[4 * c4 + 2 * i + 1], al, b[i][2], b[i][3]);
          }
          mma_bf16(c[4 * c4 + 2 * i], a, b[i][0], b[i][1]);
          mma_bf16(c[4 * c4 + 2 * i + 1], a, b[i][2], b[i][3]);
        }
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// S and dP of the warp's [16 × 8·NT] part of a [rows × keys] tile (rows
// m0.. at query q0, keys n0.. at key k0) -> p in s, dS in dp (0 where
// masked).  A part that no pair of it can see is not multiplied.
template <typename T, int NT>
__device__ __forceinline__ void probs_and_dscores(float (&s)[NT][4], float (&dp)[NT][4],
                                                  const T* Qs, const T* dOs, int ldk,
                                                  const T* Ks, const T* Vs, int ldv,
                                                  const float* lse_s, const float* delta_s,
                                                  int m0, int n0, int q0, int k0,
                                                  const BwdArgs& a, int lane) {
  constexpr bool kTf32 = sizeof(T) == 4;
  const int g = lane >> 2, t = lane & 3;
  zero(s);
  zero(dp);
  const int r_lo = q0 + m0, r_hi = r_lo + 15;
  const int c_lo = k0 + n0, c_hi = c_lo + 8 * NT - 1;
  const bool seen = r_lo < a.S && c_lo < a.S && (!a.causal || c_lo <= r_hi) &&
                    (a.window <= 0 || c_hi > r_lo - a.window);
  if (seen) {
    const int nk = kTf32 ? (a.D + 7) / 8 : (a.D + 15) / 16;
    mma_nt<NT>(s, Qs, ldk, m0, Ks, ldk, n0, nk, lane);
    if constexpr (kTf32) {
      dots_fp32<NT>(dp, dOs, ldv, m0, Vs, ldv, n0, a.Dv, lane);
    } else {
      mma_nt<NT>(dp, dOs, ldv, m0, Vs, ldv, n0, (a.Dv + 15) / 16, lane);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + g + 8 * (e >> 1);
      const int qpos = q0 + row;
      const int kpos = c_lo + 8 * nt + 2 * t + (e & 1);
      float x = s[nt][e] * a.scale;
      float th = 0.f;
      if (a.cap > 0.f) {
        th = tanhf(x / a.cap);
        x = th * a.cap;
      }
      bool ok = seen && qpos < a.S && kpos < a.S;
      if (a.causal) ok = ok && kpos <= qpos;
      if (a.window > 0) ok = ok && kpos > qpos - a.window;
      const float p = ok ? expf(x - lse_s[row]) : 0.f;
      float ds = p * (dp[nt][e] - delta_s[row]);
      if (a.cap > 0.f) ds *= 1.f - th * th;
      s[nt][e] = p;
      dp[nt][e] = ds;
    }
}

// stores of the accumulator's two adjacent columns
__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void put2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// rows r0.. (16 a warp) and columns n0.. of an accumulator, times `mul`,
// into a [S, n] slice of global memory; rows past S and columns past n
// are not written
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* base, long long ld_g, const float (&c)[NT][4],
                                           int r0, int n0, int S, int n, float mul,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= S) continue;
    T* p = base + static_cast<long long>(row) * ld_g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + 8 * nt + 2 * t;
      if (col < n) put2(p + col, c[nt][2 * r] * mul, c[nt][2 * r + 1] * mul);
    }
  }
}

// -------------------------------- kernels -------------------------------- //

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<bf16>(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const BwdArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * kDeltaRows + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (s >= a.S) return;
  const T* orow = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh +
                  static_cast<long long>(s) * a.o_ss;
  const T* drow = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh +
                  static_cast<long long>(s) * a.do_ss;
  float acc = 0.f;
  for (int d = 4 * lane; d < a.Dv; d += 128) {
    const float4 x = load4<T>(orow + d), y = load4<T>(drow + d);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[b * a.l_sb + h * a.l_sh + s] = acc;
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const BwdArgs a) {
  constexpr bool kTf32 = sizeof(T) == 4;
  constexpr int Bk = bwd_keys(kTf32, DM), Bq = bwd_rows(kTf32, DM);
  constexpr int WR = Bq / 16, WN = kWarps / WR;     // S: warps over rows x keys
  constexpr int NTA = Bk / WN / 8;
  constexpr int WK = Bk / 16, WC = kWarps / WK;     // dK, dV: warps over keys x columns
  constexpr int NTB = DM / WC / 8;
  constexpr int ldp = pad_ld(Bk, kTf32);
  static_assert(WR * WN == kWarps && WK * WC == kWarps && NTA >= 1 && NTB >= 1, "plan");
  extern __shared__ float4 smem4[];
  const int ldk = tile_ld(a.D, kTf32), ldv = tile_ld(a.Dv, kTf32);
  T* Ks = reinterpret_cast<T*>(smem4);
  T* Vs = Ks + Bk * ldk;
  T* ring = Vs + Bk * ldv;                   // stage s: Q [Bq][ldk], dO [Bq][ldv]
  const int stage = Bq * (ldk + ldv);
  T* Ps = ring + 2 * stage;                  // [Bq][ldp]: P, dS (bf16: P, dS hi, dS lo)
  T* dSs = Ps + Bq * ldp;
  T* dSs_lo = kTf32 ? nullptr : dSs + Bq * ldp;
  float* stats = reinterpret_cast<float*>(Ps + (kTf32 ? 2 : 3) * Bq * ldp);   // [2][lse, delta][Bq]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * Bk;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int S = a.S;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  {
    const int n = dkdv_smem_bytes(a.D, a.Dv, kTf32) / 16;
    for (int i = tid; i < n; i += kThreads) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // the query tiles some key of this tile is seen from
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(S - 1, k0 + Bk - 1 + a.window - 1) : S - 1;
  const int qt_lo = q_lo / Bq, qt_hi = q_hi / Bq;
  const int nqt = qt_hi - qt_lo + 1;
  const int items = a.rep * nqt;             // (head of the group, query tile), in order
  auto issue = [&](int i, int st) {
    const int h = kvh * a.rep + i / nqt;
    const int q0 = (qt_lo + i % nqt) * Bq;
    T* Qs = ring + st * stage;
    copy_rows(Qs, ldk, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0, Bq,
              S, a.D);
    copy_rows(Qs + Bq * ldk, ldv, static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh,
              a.do_ss, q0, Bq, S, a.Dv);
    copy_stats(stats + 2 * Bq * st, stats + 2 * Bq * st + Bq, a.lse + b * a.l_sb + h * a.l_sh,
               a.delta + b * a.l_sb + h * a.l_sh, q0, Bq, S);
  };
  copy_rows(Ks, ldk, kg, a.k_ss, k0, Bk, S, a.D);
  copy_rows(Vs, ldv, vg, a.v_ss, k0, Bk, S, a.Dv);
  issue(0, 0);
  cp_async_commit();

  const int wk = warp % WK, wc = warp / WK;  // dK, dV: keys 16·wk.., columns wc·DM/WC..
  const int wr = warp % WR, wn = warp / WR;  // S: rows 16·wr.., keys wn·Bk/WN..
  float dk[NTB][4], dv[NTB][4];
  zero(dk);
  zero(dv);

  for (int i = 0; i < items; ++i) {
    const int st = i & 1;
    if (i + 1 < items) {
      issue(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qs = ring + st * stage;
    const T* dOs = Qs + Bq * ldk;
    const float* lse_s = stats + 2 * Bq * st;
    const int q0 = (qt_lo + i % nqt) * Bq;
    {
      float s[NTA][4], dp[NTA][4];
      probs_and_dscores<T, NTA>(s, dp, Qs, dOs, ldk, Ks, Vs, ldv, lse_s, lse_s + Bq,
                                16 * wr, wn * (Bk / WN), q0, k0, a, lane);
#pragma unroll
      for (int nt = 0; nt < NTA; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int at = (16 * wr + g + 8 * r) * ldp + wn * (Bk / WN) + 8 * nt + 2 * t;
          if constexpr (kTf32) {
            put2(Ps + at, s[nt][2 * r], s[nt][2 * r + 1]);
            put2(dSs + at, dp[nt][2 * r], dp[nt][2 * r + 1]);
          } else {
            put2(Ps + at, s[nt][2 * r], s[nt][2 * r + 1]);   // bf(p)
            const __nv_bfloat162 hi = __floats2bfloat162_rn(dp[nt][2 * r], dp[nt][2 * r + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dSs + at) = hi;
            put2(dSs_lo + at, dp[nt][2 * r] - __low2float(hi),
                 dp[nt][2 * r + 1] - __high2float(hi));
          }
        }
    }
    __syncthreads();
    // dV += bf(P)ᵀ·dO, dK += dSᵀ·Q over the tile's Bq rows, in order
    const int n0 = wc * (DM / WC);
    if constexpr (kTf32) {
      mma_tn<NTB>(dv, Ps, ldp, 16 * wk, dOs, ldv, n0, Bq, a.Dv, lane);
      mma_tn<NTB>(dk, dSs, ldp, 16 * wk, Qs, ldk, n0, Bq, a.D, lane);
    } else {
      mma_tn<NTB>(dv, Ps, nullptr, ldp, 16 * wk, dOs, ldv, n0, Bq, a.Dv, lane);
      mma_tn<NTB>(dk, dSs, dSs_lo, ldp, 16 * wk, Qs, ldk, n0, Bq, a.D, lane);
    }
    __syncthreads();                         // the stage, P and dS are free
  }

  const int n0 = wc * (DM / WC);
  store_rows(static_cast<T*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh, a.dk_ss, dk, k0 + 16 * wk,
             n0, S, a.D, a.scale, lane);
  store_rows(static_cast<T*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh, a.dv_ss, dv, k0 + 16 * wk,
             n0, S, a.Dv, 1.f, lane);
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const BwdArgs a) {
  constexpr bool kTf32 = sizeof(T) == 4;
  constexpr int Bq = dq_rows(kTf32, DM), Bk = dq_keys(kTf32, DM);
  constexpr int WR = Bq / 16, WN = kWarps / WR;     // S: warps over rows x keys
  constexpr int NTA = Bk / WN / 8;
  constexpr int WC = kWarps / WR;                   // dQ: warps over rows x columns
  constexpr int NTB = DM / WC / 8;
  constexpr int ldp = pad_ld(Bq, kTf32);
  static_assert(WR * WN == kWarps && NTA >= 1 && NTB >= 1, "plan");
  extern __shared__ float4 smem4[];
  const int ldk = tile_ld(a.D, kTf32), ldv = tile_ld(a.Dv, kTf32);
  T* Qs = reinterpret_cast<T*>(smem4);
  T* dOs = Qs + Bq * ldk;
  T* ring = dOs + Bq * ldv;                  // stage s: K [Bk][ldk], V [Bk][ldv]
  const int stage = Bk * (ldk + ldv);
  T* dSt = ring + 2 * stage;                 // dSᵀ [Bk][ldp] (bf16: hi, then lo)
  T* dSt_lo = kTf32 ? nullptr : dSt + Bk * ldp;
  float* lse_s = reinterpret_cast<float*>(dSt + (kTf32 ? 1 : 2) * Bk * ldp);
  float* delta_s = lse_s + Bq;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (a.S + Bq - 1) / Bq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * Bq;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.rep;
  const int S = a.S;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  {
    const int n = dq_smem_bytes(a.D, a.Dv, kTf32) / 16;
    for (int i = tid; i < n; i += kThreads) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // the key tiles some row of this query tile can see
  const int k_last = a.causal ? min(S - 1, q0 + Bq - 1) : S - 1;
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_lo = k_first / Bk, kt_hi = k_last / Bk;
  auto issue = [&](int kt, int st) {
    T* K = ring + st * stage;
    copy_rows(K, ldk, kg, a.k_ss, kt * Bk, Bk, S, a.D);
    copy_rows(K + Bk * ldk, ldv, vg, a.v_ss, kt * Bk, Bk, S, a.Dv);
  };
  copy_rows(Qs, ldk, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0, Bq, S,
            a.D);
  copy_rows(dOs, ldv, static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh, a.do_ss, q0,
            Bq, S, a.Dv);
  copy_stats(lse_s, delta_s, a.lse + b * a.l_sb + h * a.l_sh,
             a.delta + b * a.l_sb + h * a.l_sh, q0, Bq, S);
  issue(kt_lo, 0);
  cp_async_commit();

  const int wr = warp % WR, wn = warp / WR;  // S: rows 16·wr.., keys wn·Bk/WN..; dQ: columns wn·DM/WC..
  float dq[NTB][4];
  zero(dq);

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    if (kt < kt_hi) {
      issue(kt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* K = ring + st * stage;
    const T* V = K + Bk * ldk;
    {
      float s[NTA][4], dp[NTA][4];
      probs_and_dscores<T, NTA>(s, dp, Qs, dOs, ldk, K, V, ldv, lse_s, delta_s, 16 * wr,
                                wn * (Bk / WN), q0, kt * Bk, a, lane);
      // dSᵀ [key][row]
#pragma unroll
      for (int nt = 0; nt < NTA; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = (wn * (Bk / WN) + 8 * nt + 2 * t + (e & 1)) * ldp + 16 * wr + g +
                         8 * (e >> 1);
          if constexpr (kTf32) {
            dSt[at] = dp[nt][e];
          } else {
            const bf16 hi = __float2bfloat16(dp[nt][e]);
            dSt[at] = hi;
            dSt_lo[at] = __float2bfloat16(dp[nt][e] - __bfloat162float(hi));
          }
        }
    }
    __syncthreads();
    // dQ += dS·K over the tile's keys, in order
    if constexpr (kTf32) {
      mma_tn<NTB>(dq, dSt, ldp, 16 * wr, K, ldk, wn * (DM / WC), Bk, a.D, lane);
    } else {
      mma_tn<NTB>(dq, dSt, dSt_lo, ldp, 16 * wr, K, ldk, wn * (DM / WC), Bk, a.D, lane);
    }
    __syncthreads();                         // the stage and dSᵀ are free
  }

  store_rows(static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh, a.dq_ss, dq, q0 + 16 * wr,
             wn * (DM / WC), S, a.D, a.scale, lane);
}

template <typename T, int DM>
int launch(const BwdArgs& a, int batch, int heads, int kv_heads, cudaStream_t stream) {
  constexpr bool kTf32 = sizeof(T) == 4;
  const dim3 grid_delta(static_cast<unsigned>((a.S + kDeltaRows - 1) / kDeltaRows),
                        static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  flash_bwd_delta<T><<<grid_delta, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int kv_bytes = dkdv_smem_bytes(a.D, a.Dv, kTf32);
  const int q_bytes = dq_smem_bytes(a.D, a.Dv, kTf32);
  if (kv_bytes > kMaxSmem || q_bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, DM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int Bk = bwd_keys(kTf32, DM);
  const dim3 grid_kv(static_cast<unsigned>((a.S + Bk - 1) / Bk),
                     static_cast<unsigned>(kv_heads), static_cast<unsigned>(batch));
  flash_bwd_dkdv<T, DM><<<grid_kv, kThreads, kv_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dq<T, DM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int Bq = dq_rows(kTf32, DM);
  const dim3 grid_q(static_cast<unsigned>((a.S + Bq - 1) / Bq),
                    static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  flash_bwd_dq<T, DM><<<grid_q, kThreads, q_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const BwdArgs& a, int batch, int heads, int kv_heads, cudaStream_t s) {
  switch (mma_width(a.D)) {
    case 64: return launch<T, 64>(a, batch, heads, kv_heads, s);
    case 128: return launch<T, 128>(a, batch, heads, kv_heads, s);
    case 192: return launch<T, 192>(a, batch, heads, kv_heads, s);
    default: return launch<T, 256>(a, batch, heads, kv_heads, s);
  }
}

// registers and local (spill) bytes of one kernel into out[0..1]
int attributes(const void* fn, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  return 0;
}

template <typename T, int DM>
int info(int headdim, int vdim, int* out) {
  constexpr bool kTf32 = sizeof(T) == 4;
  out[0] = bwd_rows(kTf32, DM);
  out[1] = bwd_keys(kTf32, DM);
  out[2] = dkdv_smem_bytes(headdim, vdim, kTf32);
  out[3] = dq_rows(kTf32, DM);
  out[4] = dq_keys(kTf32, DM);
  out[5] = dq_smem_bytes(headdim, vdim, kTf32);
  int err = attributes(reinterpret_cast<const void*>(flash_bwd_delta<T>), out + 6);
  if (err == 0) err = attributes(reinterpret_cast<const void*>(flash_bwd_dkdv<T, DM>), out + 8);
  if (err == 0) err = attributes(reinterpret_cast<const void*>(flash_bwd_dq<T, DM>), out + 10);
  return err;
}

template <typename T>
int info_dispatch(int headdim, int vdim, int* out) {
  switch (mma_width(headdim)) {
    case 64: return info<T, 64>(headdim, vdim, out);
    case 128: return info<T, 128>(headdim, vdim, out);
    case 192: return info<T, 192>(headdim, vdim, out);
    default: return info<T, 256>(headdim, vdim, out);
  }
}

}  // namespace

// Gradients of attention (see the note at the top): q [batch, heads,
// seqlen, headdim], k [batch, kv_heads, seqlen, headdim], v [batch,
// kv_heads, seqlen, vdim] (vdim <= headdim), the forward's output o and
// its cotangent dout [batch, heads, seqlen, vdim], and the forward's lse
// (fp32 [batch, heads, seqlen], strides l_sb, l_sh, 1) -> dq, dk, dv
// shaped and typed as q, k, v.  Every tensor is given by its data pointer
// and its batch, head and sequence strides in elements (head dim
// contiguous; strides and pointers multiples of four elements).  delta is
// fp32 scratch laid out as lse.  dtype: 0 for fp32, 1 for bf16, the same
// for q, k, v, o, dout, dq, dk and dv.  window <= 0 means no window, cap
// <= 0 no softcap.  Launches three kernels on `stream` (delta, dK and dV,
// dQ), does not synchronise, and returns the first launch's cudaError_t
// that is not 0 (0 on success).
extern "C" int arcadia_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    long long l_sb, long long l_sh,
    int batch, int heads, int kv_heads, int seqlen, int headdim, int vdim,
    int causal, int window, float scale, float cap, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || seqlen <= 0 || headdim <= 0 ||
      vdim <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (heads % kv_heads || headdim > 256 || headdim % 4 || vdim > headdim ||
      vdim % 4 || heads > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv,
            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
            o_sb, o_sh, o_ss, do_sb, do_sh, do_ss,
            dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
            l_sb, l_sh,
            seqlen, headdim, vdim, heads / kv_heads, causal, window, scale, cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, batch, heads, kv_heads, s);
  if (dtype == 1) return dispatch<bf16>(a, batch, heads, kv_heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan and attributes of the backward kernels for (dtype, headdim,
// vdim): out[0] query rows of a dK/dV step, out[1] keys of a dK/dV block,
// out[2] dynamic shared bytes of the dK/dV launch, out[3] query rows of a
// dQ block, out[4] keys of a dQ step, out[5] dynamic shared bytes of the
// dQ launch, then registers and local (spill) bytes a thread of the delta
// (out[6], out[7]), dK/dV (out[8], out[9]) and dQ (out[10], out[11])
// kernels.  Returns a cudaError_t.
extern "C" int arcadia_flash_bwd_kernel_info(int dtype, int headdim, int vdim, int* out) {
  if (headdim <= 0 || headdim > 256 || headdim % 4 || vdim <= 0 || vdim > headdim || vdim % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return info_dispatch<float>(headdim, vdim, out);
  if (dtype == 1) return info_dispatch<bf16>(headdim, vdim, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
