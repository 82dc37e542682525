// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a), the
// `cuda_cores` route: fp32, and bf16 that csrc/ssd_scan_tc.cu does not take
// (widths that are not multiples of 16, chunks that are not 64·k, data that
// is not 16-byte aligned).  The route keeps its name; its products run on
// the tensor cores (mma.sync).
//
// Replaces the TPU kernel `_ssd_kernel` of the JAX package
// (src/repro/kernels/ssd_scan/ssd_scan.py), launched there by `ssd_pallas`.
// Per (batch b, head h), with group g = h / (H/G), a_t = -exp(A_log[h])·dt_t
// and the chunks of Q tokens, it computes
//
//     cum_i  = Σ_{k≤i} a_k                       (inclusive, within the chunk)
//     y_i    = Σ_{j≤i} exp(cum_i - cum_j) (C_i·B_j) x_j dt_j      [intra]
//            + exp(cum_i) C_i · h_c                                [inter]
//     h_{c+1} = exp(cum_Q) h_c + Σ_j exp(cum_Q - cum_j) (x_j dt_j) ⊗ B_j
//
// with h ∈ R^{P×N} the state, zero at the first chunk; it writes y
// [B,S,H,P] in the inputs' dtype and the final h as state [B,H,P,N] fp32.
// The function of kernels/ssd_scan/ref.py::ssd_reference.
//
// What bounds it.  At mamba2-130m's serving shape (B=8, S=4096, H=24, P=64,
// N=128, Q=256) the scan needs Q(Q+1)(N+P) + 4QNP ≈ 21 M operations per
// (b, h, chunk), 64 GFLOP a call, on 0.44 GB of fp32 inputs and outputs.  An
// fp32-accurate product on the tensor cores is three TF32 products, so in
// fp32 the floor is 3 × 64 GFLOP at 495 TFLOP/s: 0.39 ms, against 0.13 ms at
// HBM's 3.35 TB/s — operations bound it.
//
// Design: the three passes of Mamba2's GPU algorithm (Dao & Gu 2024, "SSD
// algorithm"), as ssd_scan_tc.cu takes them, every chunk in parallel:
//
//   1. ssd_cc_chunk_state, grid (chunk · P/64 · N/128, h, b), 4 warps: cum of the
//      chunk by a block-wide parallel scan in fp64 (an fp32 sum drifts at Q
//      = 256, where cum reaches -100 to -200; each decay difference is
//      rounded to fp32 once), then S_c[64 p, 128 n] = Σ_j x_j ⊗ B'_j, B'_j =
//      B_j · (dt_j · exp(cum_Q - cum_j)), the factor in fp32.  Writes S_c
//      fp32 and cum fp64.
//   2. ssd_cc_state_passing, grid (b·h, slice of P·N), four elements a
//      thread where P·N allows: h <- exp(cum_Q)·h + S_c over the chunks in
//      fp32 (one fused multiply-add a step); writes
//      the state at each chunk's start, h_prev[c] — fp32 for fp32 inputs,
//      rounded once to bf16 for bf16 (the tensor-core route's rounding) —
//      and the final state in fp32.
//   3. ssd_cc_chunk_scan, grid (chunk · Q/64, h, b), 4 warps of 16 rows:
//      y_i = exp(cum_i)·(C_i · h_prevᵀ), then for each 64-token column tile
//      j up to the block's rows: the score tile C_i·B_jᵀ, masked to 0 where
//      j > i BEFORE the exp (an overflowing exp times a 0 mask is NaN), times
//      exp(cum_i - cum_j) and dt_j, formed in registers and used there as
//      the A operand of y_i += scores · x_j.
//
// Products.  Every product — C·Bᵀ, scores·x, C·h_prev and the chunk
// state — runs on `mma.sync`:
//   * fp32: m16n8k8 TF32, each product a·b as aₗ·bₕ + aₕ·bₗ + aₕ·bₕ with hi =
//     tf32(v) rounded as cvt.rna.tf32.f32 rounds (on the bits) and lo =
//     tf32(v - hi): 22 of fp32's 24 bits, the dropped aₗ·bₗ 2^-22 of a·b.
//     Each staged element is split ONCE, as its tile is staged into shared
//     memory, into a hi and a lo plane; the warps load hi and lo fragments
//     with ldmatrix (an 8 × 4 TF32 tile is an 8 × 8 b16 tile).  The score
//     tile is split in registers (its fragment's k slots read as tokens 2t,
//     2t + 1, so x_j is staged with its tokens in that order).  h_prev stays
//     fp32.  ref.ssd_split_reference mirrors this arithmetic on the CPU.
//   * bf16: m16n8k16 with the tensor-core route's roundings — B'_j rounded
//     to bf16 once, h_prev in bf16, the score tile split into bf16 hi =
//     bf16(v) and lo = bf16(v - hi) — so ref.ssd_three_pass_reference
//     mirrors it as it mirrors ssd_scan_tc.cu.
//   Each 32-deep slice of a product goes into a fresh accumulator that is
//   added to its sum in fp32: the tensor cores' own long sums truncate
//   (csrc/flash_attention_bwd.cu's note).
//
// Staging.  Operands arrive in 32-deep slices (32 state or head columns, or
// 32 tokens) through a two-stage ring: a slice lands as stored (cp.async in
// 16-byte pieces where the pointer, the row stride and the row's width are
// 16-byte multiples; plain loads otherwise — the arithmetic is the same),
// slice k + 1 in flight while slice k is split into its planes and
// multiplied.  Widths that are not multiples of 16 (P, N) and token tiles
// past the chunk (Q not a multiple of 64) are zero in shared memory, and
// the masks take only pairs of tokens inside the chunk.  xh, Bm and Cm are
// read through their strides (batch, token, head or group; the last
// dimension contiguous), so the mixer's views go in without a copy.
//
// Intermediates, from the caller: S_c [B,H,S/Q,P,N] fp32, cum [B,H,S] fp64,
// h_prev [B,H,S/Q,P,N] in the inputs' dtype.
//
// Built by kernels/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;           // tokens of a row tile and of a column tile
constexpr int kSlice = 32;          // depth of a staged slice
constexpr int kStateRows = 64;      // head columns p of a pass-1 block
constexpr int kStateBlock = 128;    // state columns n of a pass-1 block
constexpr int kThreads = 128;       // passes 1 and 3: 4 warps of 16 rows
constexpr int kStateThreads = 256;  // pass 2
constexpr int kMaxP = 128;
constexpr int kMaxSmem = 232448;    // 227 KB, H100
constexpr int kMaxGridYZ = 65535;   // grid.y and grid.z limit

struct Dims {
  int S, H, P, G, N, Q, nc, rep, nt, P16;
};

// Element strides of xh (batch, token, head) and of Bm and Cm (batch,
// token, group); the last dimension of each is contiguous.
struct Strides {
  long long xb, xs, xh, bb, bs, bg, cb, cs, cg;
};

// ------------------------------ operand types -----------------------------
// Op<T>: how an operand of inputs of type T sits in shared memory.  fp32: a
// TF32 word in two planes (hi, lo), mma depth 8; bf16: one plane, depth 16.
// A staged row holds a 32-deep slice and 16 bytes of padding, so the 8 rows
// an ldmatrix reads fall in distinct banks.
template <typename T> struct Op;
template <> struct Op<float> {
  using S = uint32_t;
  static constexpr int kK = 8;
  static constexpr int kPlanes = 2;
  static constexpr int kLd = kSlice + 4;
};
template <> struct Op<bf16> {
  using S = bf16;
  static constexpr int kK = 16;
  static constexpr int kPlanes = 1;
  static constexpr int kLd = kSlice + 8;
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int max_i(int a, int b) { return a > b ? a : b; }

// Elements of a landed row of `cols` Ts: 16 bytes of padding, so that a
// column of 16-byte pieces read down the rows falls in distinct banks.
template <typename Ts>
__host__ __device__ constexpr int raw_ld(int cols) {
  return cols + 16 / static_cast<int>(sizeof(Ts));
}
template <typename Ts>
__host__ __device__ inline long long raw_bytes(int rows, int cols) {
  return static_cast<long long>(rows) * raw_ld<Ts>(cols) * sizeof(Ts);
}


// ---- shared memory of passes 1 and 3, bytes (the wrapper's plan too) ----
template <typename T>
__host__ __device__ inline long long state_raw() {
  return raw_bytes<T>(kSlice, kStateRows) + raw_bytes<T>(kSlice, kStateBlock);
}
template <typename T>
__host__ __device__ inline long long state_smem_bytes(int Q) {
  const int Qp = (Q + kTile - 1) / kTile * kTile;
  return 8LL * Qp + 8LL * 16 + 4LL * Qp + 2 * state_raw<T>() +
         static_cast<long long>(kStateRows + kStateBlock) * Op<T>::kLd *
             sizeof(typename Op<T>::S) * Op<T>::kPlanes;
}
template <typename T>
__host__ __device__ inline long long scan_raw(int P16) {
  const long long b = raw_bytes<T>(max_i(kTile, P16), kSlice), x = raw_bytes<T>(kSlice, P16);
  return raw_bytes<T>(kTile, kSlice) + (b > x ? b : x);
}
template <typename T>
__host__ __device__ inline long long scan_smem_bytes(int P, int Q) {
  const int P16 = round16(P), Qp = (Q + kTile - 1) / kTile * kTile;
  return 8LL * Qp + 4LL * Qp + 2 * scan_raw<T>(P16) +
         static_cast<long long>(kTile + max_i(kTile, P16)) * Op<T>::kLd *
             sizeof(typename Op<T>::S) * Op<T>::kPlanes;
}

// ------------------------------ primitives ------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x as a TF32 operand, rounded as cvt.rna.tf32.f32 rounds it (to nearest,
// ties away from zero), on the bits
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}
// exp(cum_i - cum_j): the fp64 difference rounded to fp32 once.
__device__ __forceinline__ float exp_diff(double cum_i, double cum_j) {
  return expf(static_cast<float>(cum_i - cum_j));
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// v into element e of a staged operand: fp32 as TF32 hi (plane 0) and lo
// (plane 1, `plane` elements on); bf16 rounded once.
__device__ __forceinline__ void put(uint32_t* p, int e, int plane, float v) {
  const uint32_t hi = to_tf32(v);
  p[e] = hi;
  p[e + plane] = to_tf32(v - __uint_as_float(hi));
}
__device__ __forceinline__ void put(bf16* p, int e, int, float v) { p[e] = __float2bfloat16(v); }

// The position of token r of a staged slice whose k slots an fp32 score
// fragment reads as tokens 2t, 2t + 1: slot t holds token 2t, slot t + 4
// token 2t + 1, in each group of 8.
__device__ __forceinline__ int k_order(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3);
}

// A [rows][cols] tile from global memory (row r at src + r·stride) into a
// landing buffer `raw` (rows raw_ld(cols) apart; cols a multiple of 16):
// cp.async in 16-byte pieces where the pointer, stride and valid width
// allow, plain loads otherwise; rows >= nr and columns >= ncv are zero.
// Uniform over the block.
template <typename Ts>
__device__ __forceinline__ void land(Ts* raw, const Ts* src, long long stride, int rows, int cols,
                                     int nr, int ncv) {
  constexpr int kV = 16 / sizeof(Ts);
  const int ld = raw_ld<Ts>(cols);
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     static_cast<uintptr_t>(stride * static_cast<long long>(sizeof(Ts))) |
                     static_cast<uintptr_t>(ncv * sizeof(Ts))) & 15u) == 0;
  if (vec) {
    const int pieces = cols / kV;
    for (int e = threadIdx.x; e < rows * pieces; e += blockDim.x) {
      const int r = e / pieces, q = e - r * pieces;
      Ts* d = raw + r * ld + q * kV;
      if (r < nr && q * kV < ncv)
        cp_async16(d, src + r * stride + q * kV);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, c = e - r * cols;
      raw[r * ld + c] = (r < nr && c < ncv) ? src[r * stride + c] : from_f32<Ts>(0.f);
    }
  }
}

// Four consecutive landed values as fp32.
__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load4(float (&v)[4], const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
// Four values into elements e.. of a staged operand's row (16-byte
// stores of TF32 hi and lo words; an 8-byte store of bf16).
__device__ __forceinline__ void put4(uint32_t* p, int e, int plane, const float (&v)[4]) {
  uint4 hi, lo;
  hi.x = to_tf32(v[0]);
  hi.y = to_tf32(v[1]);
  hi.z = to_tf32(v[2]);
  hi.w = to_tf32(v[3]);
  lo.x = to_tf32(v[0] - __uint_as_float(hi.x));
  lo.y = to_tf32(v[1] - __uint_as_float(hi.y));
  lo.z = to_tf32(v[2] - __uint_as_float(hi.z));
  lo.w = to_tf32(v[3] - __uint_as_float(hi.w));
  *reinterpret_cast<uint4*>(p + e) = hi;
  *reinterpret_cast<uint4*>(p + e + plane) = lo;
}
__device__ __forceinline__ void put4(bf16* p, int e, int, const float (&v)[4]) {
  uint2 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  *reinterpret_cast<uint2*>(p + e) = u;
}

// A landed [rows][cols] tile into its operand planes: natural (row r, depth
// c) or transposed (row c, depth r, in k_order if kTransposedOrdered),
// each value times scale[r] when a scale is given.  A thread takes four consecutive columns of a landed row: along
// the row when natural (vector stores), down the rows when transposed (its
// lanes then store one staged row's consecutive depths).
enum Layout { kNatural, kTransposed, kTransposedOrdered };
template <typename T, typename Ts>
__device__ __forceinline__ void split_tile(typename Op<T>::S* dst, int plane, const Ts* raw, int rows,
                                           int cols, Layout lay, const float* scale) {
  constexpr int kLd = Op<T>::kLd;
  const int ld = raw_ld<Ts>(cols), quads = cols / 4;
  for (int e = threadIdx.x; e < rows * quads; e += blockDim.x) {
    int r, c;
    if (lay == kNatural) {
      r = e / quads;
      c = (e - r * quads) * 4;
    } else {
      c = (e / rows) * 4;
      r = e - (c / 4) * rows;
    }
    float v[4];
    load4(v, raw + r * ld + c);
    if (scale) {
      const float s = scale[r];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] *= s;
    }
    if (lay == kNatural) {
      put4(dst, r * kLd + c, plane, v);
    } else {
      const int k = lay == kTransposedOrdered ? k_order(r) : r;
#pragma unroll
      for (int q = 0; q < 4; ++q) put(dst, (c + q) * kLd + k, plane, v[q]);
    }
  }
}

// Fragments of a staged operand (row-major [row][depth], rows kLd apart).
// A: rows m0..m0+15 at depth step kk; B: rows n0..n0+15 (two n8 tiles,
// {b[0], b[1]} and {b[2], b[3]}).  16 bytes are kK/2 elements in either type.
template <typename T>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const typename Op<T>::S* t, int m0, int kk,
                                     int lane) {
  ldsm_x4(a, t + (m0 + (lane & 15)) * Op<T>::kLd + kk * Op<T>::kK + (lane >> 4) * (Op<T>::kK / 2));
}
template <typename T>
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], const typename Op<T>::S* t, int n0, int kk,
                                     int lane) {
  ldsm_x4(b, t + (n0 + (lane & 7) + (lane >> 4) * 8) * Op<T>::kLd + kk * Op<T>::kK +
                 ((lane >> 3) & 1) * (Op<T>::kK / 2));
}


// d += a·b for one n8 tile in three TF32 products, the small ones first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// acc[nt] += A[m0.., slice] · B[nt·8.., slice]ᵀ over the n8 tiles whose pair
// of 8 rows starts below n_lim: A and B staged operands, their lo planes
// `ap` and `bp` elements on (fp32).  The slice's products are summed in a
// fresh accumulator and added to acc in fp32.
template <typename T, int NT>
__device__ __forceinline__ void mma_slice(float (&acc)[NT][4], const typename Op<T>::S* A, int ap,
                                          const typename Op<T>::S* B, int bp, int m0, int n_lim,
                                          int lane) {
  float d[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kSlice / Op<T>::kK; ++kk) {
    uint32_t ah[4], al[4];
    ld_a<T>(ah, A, m0, kk, lane);
    if (Op<T>::kPlanes == 2) ld_a<T>(al, A + ap, m0, kk, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (np * 16 < n_lim) {
        uint32_t bh[4], bl[4];
        ld_b<T>(bh, B, np * 16, kk, lane);
        if (Op<T>::kPlanes == 2) {
          ld_b<T>(bl, B + bp, np * 16, kk, lane);
          mma3(d[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma3(d[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        } else {
          mma_bf16(d[2 * np], ah, bh[0], bh[1]);
          mma_bf16(d[2 * np + 1], ah, bh[2], bh[3]);
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += d[nt][e];
}

// acc[nt] += V[.., slice h] · B[nt·8.., slice]ᵀ with V a 16 x 64 tile held in
// registers in the accumulator's layout (c[t]: row g, tokens 8t + 2q and +1;
// row g + 8 the same), split there: fp32 into TF32 hi and lo, three
// products, B staged in k_order; bf16 into bf16 hi and lo, two products.
// A fresh accumulator, added in fp32.  The half h is a template argument,
// so c is indexed only by constants and stays in registers.
template <typename T, int NT, int h>
__device__ __forceinline__ void mma_regs(float (&acc)[NT][4], const float (&c)[8][4],
                                         const typename Op<T>::S* B, int bp, int n_lim, int lane) {
  float d[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kSlice / Op<T>::kK; ++kk) {
    uint32_t ah[4], al[4];
    if (Op<T>::kPlanes == 2) {
      const float* t = c[4 * h + kk];
      const float v[4] = {t[0], t[2], t[1], t[3]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ah[q] = to_tf32(v[q]);
        al[q] = to_tf32(v[q] - __uint_as_float(ah[q]));
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* t = c[4 * h + 2 * kk + (q >> 1)];
        const float v0 = t[(q & 1) * 2], v1 = t[(q & 1) * 2 + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
        ah[q] = *reinterpret_cast<const uint32_t*>(&hi);
        al[q] = pack_bf16(v0 - __low2float(hi), v1 - __high2float(hi));
      }
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (np * 16 < n_lim) {
        uint32_t bh[4], bl[4];
        ld_b<T>(bh, B, np * 16, kk, lane);
        if (Op<T>::kPlanes == 2) {
          ld_b<T>(bl, B + bp, np * 16, kk, lane);
          mma3(d[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma3(d[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        } else {
          mma_bf16(d[2 * np], al, bh[0], bh[1]);
          mma_bf16(d[2 * np], ah, bh[0], bh[1]);
          mma_bf16(d[2 * np + 1], al, bh[2], bh[3]);
          mma_bf16(d[2 * np + 1], ah, bh[2], bh[3]);
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += d[nt][e];
}

// In-place inclusive prefix sum of v[0..n) in fp64 by the whole block
// (ssd_scan_tc.cu's): runs per thread, then warp shuffles, then the warps'
// totals (`warp_sums`, 16) in order.
__device__ void block_inclusive_scan(double* v, int n, double* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  double run = 0.0;
  for (int i = lo; i < hi; ++i) {
    run += v[i];
    v[i] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  double before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.0;
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  for (int k = 0; k < warp; ++k) before += warp_sums[k];
  for (int i = lo; i < hi; ++i) v[i] += before;
  __syncthreads();
}

// V consecutive floats from or to global memory (V = 4: one 16-byte access;
// T = bf16: rounded to nearest even).
template <int V>
__device__ __forceinline__ void load_v(float (&v)[V], const float* p) {
  if (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[V - 1] = f.w;
  } else {
    v[0] = p[0];
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[V - 1]);
  else
    p[0] = v[0];
}
template <int V>
__device__ __forceinline__ void store_v(bf16* p, const float (&v)[V]) {
  if (V == 4) {
    uint2 packed;
    packed.x = pack_bf16(v[0], v[1]);
    packed.y = pack_bf16(v[2], v[V - 1]);
    *reinterpret_cast<uint2*>(p) = packed;
  } else {
    p[0] = __float2bfloat16(v[0]);
  }
}

// -------------------------- pass 1: chunk states --------------------------
// Block ((c · npb + p-block) · nnb + n-block, h, b), 4 warps; warp w holds
// rows p = p0 + 16w.. of S_c and the block's 128 state columns.  Slice k:
// tokens 32k.. of x ([tokens][64 p]) and of B ([tokens][128 n]) landed,
// staged transposed (the depth is the token), B times w_j = dt_j·exp(cum_Q
// - cum_j).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_cc_chunk_state(const T* __restrict__ xh, const float* __restrict__ dt,
                   const float* __restrict__ A_log, const T* __restrict__ Bm,
                   float* __restrict__ chunk_state, double* __restrict__ cum_out, Dims d,
                   Strides st) {
  using S = typename Op<T>::S;
  constexpr int kLd = Op<T>::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = d.P, N = d.N, Q = d.Q;
  const int Qp = d.nt * kTile;
  const int npb = (P + kStateRows - 1) / kStateRows, nnb = (N + kStateBlock - 1) / kStateBlock;
  double* cum = reinterpret_cast<double*>(smem);
  double* warp_sums = cum + Qp;
  float* w = reinterpret_cast<float*>(warp_sums + 16);
  T* raw = reinterpret_cast<T*>(w + Qp);                       // two landing stages
  const int raw_stage = static_cast<int>(state_raw<T>() / sizeof(T));
  const int xp = kStateRows * kLd, bp = kStateBlock * kLd;     // plane sizes
  S* xs = reinterpret_cast<S*>(raw + 2 * raw_stage);           // x  [64 p][kLd] per plane
  S* bs = xs + xp * Op<T>::kPlanes;                            // B' [128 n][kLd] per plane

  const int nb = blockIdx.x % nnb, cp = blockIdx.x / nnb;
  const int c = cp / npb, pbk = cp - c * npb;
  const int hh = blockIdx.y, b = blockIdx.z, g = hh / d.rep;
  const int p0 = pbk * kStateRows, pvalid = min(kStateRows, P - p0);
  const int n0 = nb * kStateBlock, nvalid = min(kStateBlock, N - n0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = static_cast<long long>(c) * Q;
  const T* xbase = xh + b * st.xb + t0 * st.xs + hh * st.xh + p0;
  const T* bbase = Bm + b * st.bb + t0 * st.bs + g * st.bg + n0;
  const int nk = (Q + kSlice - 1) / kSlice;
  auto issue = [&](int k) {
    T* r = raw + (k & 1) * raw_stage;
    const int tok = k * kSlice, nr = min(kSlice, Q - tok);
    land(r, xbase + tok * st.xs, st.xs, kSlice, kStateRows, nr, pvalid);
    land(r + kSlice * raw_ld<T>(kStateRows), bbase + tok * st.bs, st.bs, kSlice, kStateBlock, nr,
         nvalid);
  };
  issue(0);
  cp_async_commit();

  const float A = -expf(A_log[hh]);
  const float* dtb = dt + (static_cast<long long>(b) * d.S + t0) * d.H + hh;
  for (int i = tid; i < Qp; i += blockDim.x)
    cum[i] = i < Q ? static_cast<double>(A) * static_cast<double>(dtb[static_cast<long long>(i) * d.H])
                   : 0.0;
  __syncthreads();
  block_inclusive_scan(cum, Q, warp_sums);
  const double total = cum[Q - 1];
  double* cum_g = cum_out + (static_cast<long long>(b) * d.H + hh) * d.S + t0;
  for (int i = tid; i < Qp; i += blockDim.x) {
    if (i < Q && nb == 0 && pbk == 0) cum_g[i] = cum[i];
    w[i] = i < Q ? dtb[static_cast<long long>(i) * d.H] * exp_diff(total, cum[i]) : 0.f;
  }

  float acc[kStateBlock / 8][4];
#pragma unroll
  for (int nt = 0; nt < kStateBlock / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int m0 = warp * 16;
  for (int k = 0; k < nk; ++k) {
    if (k + 1 < nk) {
      issue(k + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // slice k landed; the planes are free
    const T* r = raw + (k & 1) * raw_stage;
    split_tile<T>(xs, xp, r, kSlice, kStateRows, kTransposed, nullptr);
    split_tile<T>(bs, bp, r + kSlice * raw_ld<T>(kStateRows), kSlice, kStateBlock, kTransposed,
                  w + k * kSlice);
    __syncthreads();
    if (m0 < pvalid)
      mma_slice<T, kStateBlock / 8>(acc, xs, xp, bs, bp, m0, round16(nvalid), lane);
  }

  float* out = chunk_state +
               ((static_cast<long long>(b) * d.H + hh) * d.nc + c) * static_cast<long long>(P) * N;
  const int gq = lane >> 2, tq = lane & 3;
  const int pa = p0 + m0 + gq, pb = pa + 8;
#pragma unroll
  for (int nt = 0; nt < kStateBlock / 8; ++nt) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + nt * 8 + 2 * tq + q;
      if (n < N) {
        if (pa < P) out[static_cast<long long>(pa) * N + n] = acc[nt][q];
        if (pb < P) out[static_cast<long long>(pb) * N + n] = acc[nt][2 + q];
      }
    }
  }
}

// -------------------------- pass 2: state passing -------------------------
// Thread e of block (b·h, slice): elements V·e.. of [P·N] (V = 4 where P·N
// is a multiple of 4, else 1) over the chunks in order.
template <typename T, int V>
__global__ void __launch_bounds__(kStateThreads)
ssd_cc_state_passing(const float* __restrict__ chunk_state, const double* __restrict__ cum,
                     T* __restrict__ h_prev, float* __restrict__ state_out, Dims d) {
  const long long PN = static_cast<long long>(d.P) * d.N;
  const long long e = (static_cast<long long>(blockIdx.y) * kStateThreads + threadIdx.x) * V;
  if (e >= PN) return;
  const long long bh = blockIdx.x;
  const double* last = cum + bh * d.S + d.Q - 1;       // cum_Q of chunk 0
  const float* src = chunk_state + bh * d.nc * PN + e;
  T* hp = h_prev + bh * d.nc * PN + e;
  float h[V], sv[V];
#pragma unroll
  for (int q = 0; q < V; ++q) h[q] = 0.f;
  load_v<V>(sv, src);
  for (int c = 0; c < d.nc; ++c) {
    float s[V];
#pragma unroll
    for (int q = 0; q < V; ++q) s[q] = sv[q];
    if (c + 1 < d.nc) load_v<V>(sv, src + (c + 1) * PN);   // the next chunk's, in flight
    store_v<V>(hp + c * PN, h);
    const float decay = expf(static_cast<float>(last[static_cast<long long>(c) * d.Q]));
#pragma unroll
    for (int q = 0; q < V; ++q) h[q] = fmaf(decay, h[q], s[q]);
  }
  store_v<V>(state_out + bh * PN + e, h);
}

// -------------------------- pass 3: chunk output --------------------------
// Block (c · nt + row tile I, h, b), 4 warps of 16 rows of the tile.  Steps,
// one 32-deep slice each: the N/32 slices of C_I·h_prevᵀ (C_I [64][32 n],
// h_prev [P][32 n]); then for each column tile J <= I the N/32 slices of
// C_I·B_Jᵀ (B_J [64][32 n]) and the two 32-token halves of scores·x_J (x_J
// landed [32 tokens][P], staged transposed).  kPT: P rounded up to 32, 64
// or 128 (fragments past P are skipped).
// Blocks an SM the registers are sized for: 3 in bf16 (shared memory
// allows it); 2 in fp32, whose registers spill under a 3-block cap at P 64.
template <typename T, int kPT>
__global__ void __launch_bounds__(kThreads, kPT > 64 ? 1 : Op<T>::kPlanes == 2 ? 2 : 3)
ssd_cc_chunk_scan(const T* __restrict__ xh, const float* __restrict__ dt,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const double* __restrict__ cum_in, const T* __restrict__ h_prev,
                  T* __restrict__ y, Dims d, Strides st) {
  using S = typename Op<T>::S;
  constexpr int kLd = Op<T>::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = d.P, N = d.N, Q = d.Q, P16 = d.P16;
  const int Qp = d.nt * kTile, RB = max_i(kTile, P16);
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + Qp);
  T* raw = reinterpret_cast<T*>(dts + Qp);
  const int raw_stage = static_cast<int>(scan_raw<T>(P16) / sizeof(T));
  const int ap = kTile * kLd, bp = RB * kLd;
  S* as = reinterpret_cast<S*>(raw + 2 * raw_stage);           // [64][kLd] per plane
  S* bs = as + ap * Op<T>::kPlanes;                            // [RB][kLd] per plane

  const int c = blockIdx.x / d.nt, it = blockIdx.x - c * d.nt;
  const int hh = blockIdx.y, b = blockIdx.z, g = hh / d.rep;
  const int i0 = it * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const long long t0 = static_cast<long long>(c) * Q;
  const long long bh = static_cast<long long>(b) * d.H + hh;
  const int ns = (N + kSlice - 1) / kSlice;
  const int per_j = ns + 2;
  const int steps = ns + (it + 1) * per_j;
  // The sources of step s, from the block's indices and the launch's
  // parameters each time (no 64-bit pointer stays live across the loop).
  auto issue = [&](int s) {
    T* ra = raw + (s & 1) * raw_stage;
    T* rb = ra + kTile * raw_ld<T>(kSlice);
    const int cb = blockIdx.x / d.nt, i0b = (blockIdx.x - cb * d.nt) * kTile;
    const int hb = blockIdx.y, bb = blockIdx.z, gb = hb / d.rep;
    const long long tb = static_cast<long long>(cb) * d.Q;
    const int ni = min(kTile, d.Q - i0b);
    const T* cbase = Cm + bb * st.cb + (tb + i0b) * st.cs + gb * st.cg;
    if (s < ns) {                                       // C_I and h_prev, slice s of n
      const int n0 = s * kSlice, nv = min(kSlice, d.N - n0);
      const T* hbase = h_prev + ((static_cast<long long>(bb) * d.H + hb) * d.nc + cb) *
                                    static_cast<long long>(d.P) * d.N;
      land(ra, cbase + n0, st.cs, kTile, kSlice, ni, nv);
      land(rb, hbase + n0, static_cast<long long>(d.N), RB, kSlice, d.P, nv);
      return;
    }
    const int q = s - ns, J = q / per_j, r = q - J * per_j;
    if (r < ns) {                                       // C_I and B_J, slice r of n
      const int n0 = r * kSlice, nv = min(kSlice, d.N - n0);
      land(ra, cbase + n0, st.cs, kTile, kSlice, ni, nv);
      land(rb, Bm + bb * st.bb + (tb + J * kTile) * st.bs + gb * st.bg + n0, st.bs, kTile, kSlice,
           min(kTile, d.Q - J * kTile), nv);
    } else {                                            // x_J, tokens of half r - ns
      const int tok = J * kTile + (r - ns) * kSlice;
      land(rb, xh + bb * st.xb + (tb + tok) * st.xs + hb * st.xh, st.xs, kSlice, d.P16,
           min(kSlice, d.Q - tok), d.P);
    }
  };
  issue(0);
  cp_async_commit();
  const double* cum_g = cum_in + bh * d.S + t0;
  const float* dtb = dt + (static_cast<long long>(b) * d.S + t0) * d.H + hh;
  for (int i = tid; i < i0 + kTile; i += blockDim.x) {
    cum[i] = i < Q ? cum_g[i] : 0.0;
    dts[i] = i < Q ? dtb[static_cast<long long>(i) * d.H] : 0.f;
  }

  const int m0 = warp * 16;
  const int ia = i0 + m0 + gq, ib = ia + 8;            // a lane's two rows in the chunk
  float acc[kPT / 8][4], s[8][4];
#pragma unroll
  for (int nt = 0; nt < kPT / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int k = 0; k < steps; ++k) {
    if (k + 1 < steps) {
      issue(k + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // slice k landed; the planes are free
    const T* ra = raw + (k & 1) * raw_stage;
    const T* rb = ra + kTile * raw_ld<T>(kSlice);
    const int q = k - ns, J = q < 0 ? -1 : q / per_j, r = q < 0 ? k : q - J * per_j;
    if (q < 0 || r < ns) {
      split_tile<T>(as, ap, ra, kTile, kSlice, kNatural, nullptr);
      split_tile<T>(bs, bp, rb, q < 0 ? RB : kTile, kSlice, kNatural, nullptr);
    } else {
      split_tile<T>(bs, bp, rb, kSlice, P16,
                    Op<T>::kPlanes == 2 ? kTransposedOrdered : kTransposed, nullptr);
    }
    __syncthreads();
    if (q < 0) {
      // inter-chunk term: C_i · h_prevᵀ, then times exp(cum_i)
      mma_slice<T, kPT / 8>(acc, as, ap, bs, bp, m0, P16, lane);
      if (k == ns - 1) {
        const float ea = expf(static_cast<float>(cum[ia])), eb = expf(static_cast<float>(cum[ib]));
#pragma unroll
        for (int nt = 0; nt < kPT / 8; ++nt) {
          acc[nt][0] *= ea;
          acc[nt][1] *= ea;
          acc[nt][2] *= eb;
          acc[nt][3] *= eb;
        }
      }
    } else if (r < ns) {
      // the score tile C_I·B_Jᵀ
      if (r == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      }
      mma_slice<T, 8>(s, as, ap, bs, bp, m0, kTile, lane);
      if (r == ns - 1) {
        // mask (j > i, or a token past the chunk, selects 0: the exp is not
        // taken), decay, dt
        const int j0 = J * kTile;
        const double ca = cum[ia], cb = cum[ib];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + nt * 8 + 2 * tq + e;
            const bool jok = j < Q;
            const double cj = cum[j];
            const float dj = dts[j];
            s[nt][e] = (jok && j <= ia && ia < Q) ? s[nt][e] * exp_diff(ca, cj) * dj : 0.f;
            s[nt][2 + e] = (jok && j <= ib && ib < Q) ? s[nt][2 + e] * exp_diff(cb, cj) * dj : 0.f;
          }
        }
      }
    } else {
      // y_i += scores · x_J over this half's 32 tokens (a warp whose rows all
      // precede the half has nothing to add)
      const int half = r - ns;
      if (half == 0)
        mma_regs<T, kPT / 8, 0>(acc, s, bs, bp, P16, lane);
      else if (!(J == it && kSlice > m0 + 15))
        mma_regs<T, kPT / 8, 1>(acc, s, bs, bp, P16, lane);
    }
  }

  // y [B,S,H,P] contiguous
  const long long ytok = static_cast<long long>(d.H) * P;
  T* ybase = y + (static_cast<long long>(b) * d.S + t0) * ytok + static_cast<long long>(hh) * P;
#pragma unroll
  for (int nt = 0; nt < kPT / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = nt * 8 + 2 * tq + e;
      if (p < P) {
        if (ia < Q) ybase[ia * ytok + p] = from_f32<T>(acc[nt][e]);
        if (ib < Q) ybase[ib * ytok + p] = from_f32<T>(acc[nt][2 + e]);
      }
    }
  }
}

// ------------------------------- launches -------------------------------
template <typename T, int kPT>
const void* kernel_of(int launch) {
  if (launch == 0) return reinterpret_cast<const void*>(ssd_cc_chunk_state<T>);
  if (launch == 1) return reinterpret_cast<const void*>(ssd_cc_state_passing<T, 4>);
  return reinterpret_cast<const void*>(ssd_cc_chunk_scan<T, kPT>);
}
template <typename T>
const void* kernel_for(int launch, int P) {
  if (P <= 32) return kernel_of<T, 32>(launch);
  if (P <= 64) return kernel_of<T, 64>(launch);
  return kernel_of<T, 128>(launch);
}

template <typename T, int kPT>
int launch(const T* xh, const float* dt, const float* A_log, const T* Bm, const T* Cm, T* y,
           float* state, float* chunk_state, double* cum, T* h_prev, int batch, const Dims& d,
           const Strides& st, cudaStream_t stream) {
  const int s1 = static_cast<int>(state_smem_bytes<T>(d.Q));
  const int s3 = static_cast<int>(scan_smem_bytes<T>(d.P, d.Q));
  cudaError_t err = cudaFuncSetAttribute(ssd_cc_chunk_state<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_cc_chunk_scan<T, kPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s3);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int npb = (d.P + kStateRows - 1) / kStateRows;
  const int nnb = (d.N + kStateBlock - 1) / kStateBlock;
  ssd_cc_chunk_state<T><<<dim3(d.nc * npb * nnb, d.H, batch), kThreads, s1, stream>>>(
      xh, dt, A_log, Bm, chunk_state, cum, d, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long PN = static_cast<long long>(d.P) * d.N;
  const int V = PN % 4 ? 1 : 4;
  const dim3 sgrid(batch * d.H,
                   static_cast<unsigned>((PN / V + kStateThreads - 1) / kStateThreads));
  if (V == 4)
    ssd_cc_state_passing<T, 4><<<sgrid, kStateThreads, 0, stream>>>(chunk_state, cum, h_prev, state, d);
  else
    ssd_cc_state_passing<T, 1><<<sgrid, kStateThreads, 0, stream>>>(chunk_state, cum, h_prev, state, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  ssd_cc_chunk_scan<T, kPT><<<dim3(d.nc * d.nt, d.H, batch), kThreads, s3, stream>>>(
      xh, dt, Bm, Cm, cum, h_prev, y, d, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(const void* xh, const void* dt, const void* A_log, const void* Bm, const void* Cm,
             void* y, void* state, void* chunk_state, void* cum, void* h_prev, int batch,
             const Dims& d, const Strides& st, cudaStream_t s) {
  const auto* x = static_cast<const T*>(xh);
  const auto* t = static_cast<const float*>(dt);
  const auto* a = static_cast<const float*>(A_log);
  const auto* bm = static_cast<const T*>(Bm);
  const auto* cm = static_cast<const T*>(Cm);
  auto* yo = static_cast<T*>(y);
  auto* so = static_cast<float*>(state);
  auto* cst = static_cast<float*>(chunk_state);
  auto* cu = static_cast<double*>(cum);
  auto* hp = static_cast<T*>(h_prev);
  if (d.P <= 32) return launch<T, 32>(x, t, a, bm, cm, yo, so, cst, cu, hp, batch, d, st, s);
  if (d.P <= 64) return launch<T, 64>(x, t, a, bm, cm, yo, so, cst, cu, hp, batch, d, st, s);
  return launch<T, 128>(x, t, a, bm, cm, yo, so, cst, cu, hp, batch, d, st, s);
}

}  // namespace

// Shared bytes of the chunk-state and chunk-output launches for head dim
// P, state dim N, chunk Q and dtype (0 fp32, 1 bf16) into out[0..2).
extern "C" void arcadia_ssd_scan_plan(int headdim, int dstate, int chunk, int dtype,
                                      long long* out) {
  (void)dstate;
  (void)headdim;
  out[0] = dtype ? state_smem_bytes<bf16>(chunk) : state_smem_bytes<float>(chunk);
  out[1] = dtype ? scan_smem_bytes<bf16>(headdim, chunk) : scan_smem_bytes<float>(headdim, chunk);
}

// cudaFuncGetAttributes of launch `launch` (0 chunk state, 1 state passing,
// 2 chunk output) at head dim P and dtype (0 fp32, 1 bf16): out = registers
// a thread, local (spill) bytes, static shared bytes, max threads a block.
// Returns the cudaError_t.
extern "C" int arcadia_ssd_scan_info(int launch, int headdim, int dtype, int* out) {
  if (launch < 0 || launch > 2 || headdim <= 0 || headdim > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* f = dtype ? kernel_for<bf16>(launch, headdim) : kernel_for<float>(launch, headdim);
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = fa.maxThreadsPerBlock;
  return 0;
}

// SSD scan of xh [batch, seqlen, heads, headdim], Bm and Cm [batch, seqlen,
// groups, dstate], read through strides[9] (xh: batch, token, head; Bm and
// Cm: batch, token, group; in elements, the last dimension contiguous), dt
// [batch, seqlen, heads] fp32 and A_log [heads] fp32 contiguous, into y
// (contiguous, xh's shape and dtype) and state [batch, heads, headdim,
// dstate] fp32.  dtype: 0 for fp32 xh/Bm/Cm, 1 for bf16.  Scratch from the
// caller: chunk_state [batch, heads, seqlen/chunk, headdim, dstate] fp32,
// cum [batch, heads, seqlen] fp64, h_prev [batch, heads, seqlen/chunk,
// headdim, dstate] in xh's dtype.  headdim at most 128, chunk dividing
// seqlen, groups dividing heads, batch and heads at most 65535.  Launches
// three kernels on `stream`, does not synchronise, and returns the first
// cudaError_t (0 on success).
extern "C" int arcadia_ssd_scan(const void* xh, const void* dt, const void* A_log, const void* Bm,
                                const void* Cm, void* y, void* state, void* chunk_state, void* cum,
                                void* h_prev, int batch, int seqlen, int heads, int headdim,
                                int groups, int dstate, int chunk, int dtype,
                                const long long* strides, void* stream) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || headdim <= 0 || groups <= 0 || dstate <= 0 ||
      chunk <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (seqlen % chunk || heads % groups || headdim > kMaxP || batch > kMaxGridYZ ||
      heads > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  long long plan[2];
  arcadia_ssd_scan_plan(headdim, dstate, chunk, dtype, plan);
  if (plan[0] > kMaxSmem || plan[1] > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (chunk + kTile - 1) / kTile;
  const Dims d{seqlen, heads, headdim, groups, dstate, chunk, seqlen / chunk, heads / groups, nt,
               round16(headdim)};
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_p<float>(xh, dt, A_log, Bm, Cm, y, state, chunk_state, cum, h_prev, batch, d,
                           st, s);
  return launch_p<bf16>(xh, dt, A_log, Bm, Cm, y, state, chunk_state, cum, h_prev, batch, d, st,
                        s);
}
