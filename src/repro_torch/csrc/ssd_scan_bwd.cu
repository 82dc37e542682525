// Backward of the Mamba2 SSD (state-space duality) chunked scan for Hopper
// (sm_90a), the `cuda_cores` route: fp32, and bf16 that
// csrc/ssd_scan_bwd_tc.cu does not take (widths that are not multiples of
// 16, chunks that are not 64·k, data that is not 16-byte aligned).  The
// route keeps its name; its products run on the tensor cores (mma.sync).
//
// The gradient of the scan of csrc/ssd_scan.cu and csrc/ssd_scan_tc.cu, whose
// TPU kernel is `_ssd_kernel` (src/repro/kernels/ssd_scan/ssd_scan.py).  That
// Pallas kernel has no gradient: the JAX package trains through autodiff of
// its plain reference (ref.ssd_reference).  This kernel computes the same
// function as the port's plain chunked backward,
// kernels/ssd_scan/ref.py::ssd_backward_reference.
//
// Per (batch b, head h), group g = h / (H/G), a_t = -exp(A_log[h])·dt_t,
// x~_t = dt_t·x_t, cum the inclusive cumsum of a within a chunk of Q tokens
// (fp64, as the forward sums it), L_ij = exp(cum_i - cum_j) for j <= i,
// s_ij = C_i·B_j and r_ij = dy_i·x~_j:
//
//   h0_c   state at chunk c's start        (recomputed, fp32)
//   G_c    adjoint of the state at c's end: G_last = dstate (or 0),
//          G_{c-1} = exp(cum_Q) G_c + Σ_i exp(cum_i) dy_i ⊗ C_i
//   dx~_j  = Σ_{i>=j} L_ij s_ij dy_i + exp(cum_Q - cum_j) G B_j
//   dB_j   = Σ_h [Σ_{i>=j} L_ij r_ij C_i + exp(cum_Q - cum_j) Gᵀ x~_j]
//   dC_i   = Σ_h [Σ_{j<=i} L_ij r_ij B_j + exp(cum_i) h0ᵀ dy_i]
//   da_t   = Σ_{i>=t} (Σ_{j<i} M_ij - Σ_{k>i} M_ki + u_i) + Σ_{j<t} v_j
//            + exp(cum_Q) <G, h0>,   M = L∘s∘r below the diagonal,
//            u_i = exp(cum_i) C_i·(h0ᵀ dy_i), v_j = exp(cum_Q - cum_j) x~_j·(G B_j)
//   dx_t   = dt_t dx~_t,  ddt_t = <x_t, dx~_t> - exp(A_log) da_t,
//   dA_log = Σ_{b,t} a_t da_t,
//
// with Σ_h over the H/G heads of a group.  Outputs: dxh [B,S,H,P], dBm and
// dCm [B,S,G,N] in the inputs' dtype, ddt [B,S,H] and dA_log [H] in fp32.
//
// What bounds it.  At mamba2-130m's training shape (B=8, S=4096, H=24, P=64,
// G=1, N=128, Q=256) the function needs, per (b, h, chunk), the causal
// pairs' dy·x~ᵀ and (L∘s)ᵀ·dy products, Q(Q+1)·2P operations, and five
// Q·N·P state products, 10·Q·N·P; per (b, group, chunk) the causal pairs'
// C·Bᵀ, dB and dC products, Q(Q+1)·3N: 93 GFLOP.  In fp32 an fp32-accurate
// product is three TF32 products, 0.57 ms at 495 TFLOP/s, against 0.20 ms
// to move 0.68 GB of fp32 inputs and outputs at HBM's rate: operations
// bound it.
//
// Design: the passes of the tensor-core gradient (ssd_scan_bwd_tc.cu), so
// that no product is computed twice and no per-head partial of dB or dC is
// written; every chunk in parallel; seven launches:
//
//   1. chunk sums, grid (2 · chunk · P/64 · N/128, h, b): the chunk's state
//      contribution S_c = Σ_j x_j ⊗ B_j·dt_j·w_j (w_j = exp(cum_Q - cum_j))
//      and adjoint contribution D_c = Σ_i dy_i ⊗ C_i·exp(cum_i), the fp32
//      factor applied to B or C as it is staged; cum by a block-wide fp64
//      scan.
//   2. state passes, grid (b·h, P·N/1024), four elements a thread where P·N
//      allows: h0 forward and G backward over the chunks in fp32 (one fused
//      multiply-add a step, in place over S_c and D_c), and <G_c, h0_c> in
//      fp64, a fixed-order tree per block.
//   3. pairs, grid (pair (I, J) of 64-token tiles, chunk, b·g): C·Bᵀ once per
//      (b, chunk, group), written in fp32 for launch 4; for each head in head
//      order r = dy·x~ᵀ, L masked BEFORE the exp (a pair j > i takes 0 and
//      never evaluates exp(cum_i - cum_j)), the heads' fp32 sum of W = L∘r
//      (written in fp32 for launch 5: dB and dC need only that sum), and
//      M's row and column sums over the tile in fp64 (fixed shuffles and a
//      fixed-order cross-warp sum).
//   4. columns, grid (chunk · Q/64, h, b): dx~ of a 64-token column tile:
//      w·(G B) (and v from it), then for each row tile I >= J the A operand
//      (L∘s)ᵀ formed in registers from launch 3's C·Bᵀ, times dy_I; writes
//      dxh = dt·dx~, <x, dx~> and v.
//   5. group, grid (2 · chunk · Q/64, g, b), 8 warps: dB (or dC) of a
//      64-token tile in one accumulator: the state term Σ_h w·dt·(x_h G_h)
//      (Σ_h exp(cum)·(dy_h h0_h)), the heads in order, the per-head factor
//      applied to the fp32 product's rows, then the quadratic term Wᵀ C_I (W
//      B_J) over the tile pairs; u for the dC tiles.
//   6. finalize, grid (chunk, h, b): da by a reverse cumsum in fp64 of the
//      row minus column sums, plus the state terms as sums of their own
//      sign (v below t, <G, h0>), then ddt and the chunk's part of dA_log.
//   7. dA_log: the parts summed in fp64 in (batch, chunk) order.
// No atomics: every sum has a fixed order, so two calls give the same bits.
//
// Products.  Every product — the chunk sums, C·Bᵀ, dy·x~ᵀ, G·B, (L∘s)ᵀ·dy,
// x·G, dy·h0, Wᵀ·C and W·B — runs on `mma.sync`:
//   * fp32: m16n8k8 TF32, each product a·b as aₗ·bₕ + aₕ·bₗ + aₕ·bₕ with hi =
//     tf32(v) rounded as cvt.rna.tf32.f32 rounds (on the bits) and lo =
//     tf32(v - hi).  Each staged element is split ONCE, as its slice is
//     staged into shared memory, into a hi and a lo plane that the warps
//     read with ldmatrix; the (L∘s)ᵀ tile is split in registers (its
//     fragment's k slots read as tokens 2t, 2t + 1, so dy_I is staged with
//     its tokens in that order).  h0 and G stay fp32: they are split as
//     they are staged, never rounded to bf16.  ref.ssd_backward_split_
//     reference mirrors this arithmetic on the CPU.  No product is left in
//     fp32 FMAs: dA_log, whose terms cancel, stays within the float64
//     bound the plain fp32 backward sets (4 times its distance, or 2e-5;
//     tests/test_torch_cuda.py::test_ssd_backward_of_fp32_is_near_float64
//     on the card, tests/test_torch_ssd_split.py for the mirror).
//   * bf16: m16n8k16 with the tensor-core gradient's roundings — B·dt·w and
//     C·exp(cum) rounded to bf16 once, h0 and G rounded to bf16 where they
//     meet a product, W and (L∘s) split into bf16 hi and lo — so
//     ref.ssd_backward_tc_reference mirrors it as it mirrors
//     ssd_scan_bwd_tc.cu.
//   Each 32-deep slice of a product goes into a fresh accumulator that is
//   added to its sum in fp32 (the tensor cores' own long sums truncate); a
//   head's state term of dB or dC is its own accumulator, added with its
//   factor.
//
// Staging, as csrc/ssd_scan.cu stages: 32-deep slices through a two-stage
// ring, each landing as stored (cp.async in 16-byte pieces where pointer,
// row stride and width allow, plain loads otherwise — the same arithmetic),
// then split into its planes while the next slice is in flight; widths that
// are not multiples of 16 and token tiles past the chunk are zero, and the
// masks take only pairs inside the chunk.  xh, Bm, Cm and dy are read
// through their strides.
//
// Scratch, from the caller (arcadia_ssd_scan_bwd_scratch_bytes): cum fp64,
// S_c / h0 and D_c / G fp32 [B,H,S/Q,P,N], C·Bᵀ and W fp32 [B,G,S/Q,pairs,
// 64,64], the row and column sums per tile (fp64), u, v (fp64) and <x, dx~>
// (fp32) per token, the <G, h0> and dA_log parts.
//
// Built by kernels/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;           // tokens of a row or column tile
constexpr int kSlice = 32;          // depth of a staged slice
constexpr int kSumRows = 64;        // head columns p of a chunk-sum block
constexpr int kSumBlock = 128;      // state columns n of a chunk-sum block
constexpr int kSumThreads = 128;    // launch 1: 4 warps of 16 rows
constexpr int kPairThreads = 128;   // launch 3: 4 warps of 16 rows
constexpr int kColThreads = 128;    // launch 4
constexpr int kGroupThreads = 256;  // launch 5: 4 row groups x 2 column halves
constexpr int kStateThreads = 256;  // launch 2
constexpr int kFinThreads = 256;    // launches 6 and 7
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kMaxSmem = 232448;    // 227 KB, H100
constexpr int kMaxGridYZ = 65535;
constexpr long long kAlign = 256;   // scratch regions

struct Dims {
  int S, H, P, G, N, Q, nc, rep, nt, npairs, slices, P16, N16;
};

// Element strides of xh (batch, token, head), Bm and Cm (batch, token,
// group) and dy (batch, token, head); the last dimension of each contiguous.
struct Strides {
  long long xb, xs, xh, bb, bs, bg, cb, cs, cg, yb, ys, yh;
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
__host__ __device__ inline int pad_q(int Q) { return (Q + kTile - 1) / kTile * kTile; }

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


// ---- shared memory of each launch, bytes (the wrapper's plan too) --------
template <typename T>
__host__ __device__ inline long long plane_bytes(int rows) {
  return static_cast<long long>(rows) * Op<T>::kLd * sizeof(typename Op<T>::S);
}
// 1. cum, warp sums, the token factors; two landing stages of x or dy
//    [32][64 p] and B or C [32][128 n]; their planes
template <typename T>
__host__ __device__ inline long long sums_raw() {
  return raw_bytes<T>(kSlice, kSumRows) + raw_bytes<T>(kSlice, kSumBlock);
}
template <typename T>
__host__ __device__ inline long long sums_smem(int Q) {
  return 8LL * pad_q(Q) + 8LL * 16 + 4LL * pad_q(Q) + 2 * sums_raw<T>() +
         plane_bytes<T>(kSumRows + kSumBlock) * Op<T>::kPlanes;
}
// 3. two landing stages of B_J and C_I or x_J and dy_I [64][32]; their
//    planes; the cross-warp row sums; a head's cum of J and I and dt of J
template <typename T>
__host__ __device__ inline long long pairs_raw() {
  return 2 * raw_bytes<T>(kTile, kSlice);
}
template <typename T>
__host__ __device__ inline long long pairs_smem() {
  return 2 * pairs_raw<T>() + 2 * plane_bytes<T>(kTile) * Op<T>::kPlanes + 8LL * 4 * kTile +
         8LL * 2 * kTile + 4LL * kTile;
}
// 4. cum; two landing stages of B_J [64][32] and G [P][32] (fp32) or dy_I
//    [32][P]; their planes
template <typename T>
__host__ __device__ inline long long cols_raw(int P16) {
  const long long g = raw_bytes<float>(max_i(kTile, P16), kSlice), y = raw_bytes<T>(kSlice, P16);
  return raw_bytes<T>(kTile, kSlice) + (g > y ? g : y);
}
template <typename T>
__host__ __device__ inline long long cols_smem(int P, int Q) {
  const int P16 = round16(P);
  return 8LL * pad_q(Q) + 2 * cols_raw<T>(P16) +
         plane_bytes<T>(kTile + max_i(kTile, P16)) * Op<T>::kPlanes;
}
// 5. a head's cum and dt of the tile and its cum_Q; the cross-warp u sums;
//    two landing stages of x or dy [64][32] or W's slice (fp32) and of G or
//    h0 [32][N] (fp32) or C_I or B_J [32][N]; the A operand's two planes
//    (W is split in bf16 too) and the B operand's planes
__host__ __device__ inline long long group_a_raw() {      // x, dy, W or Wᵀ's slice
  const long long a = raw_bytes<float>(kTile, kSlice), t = raw_bytes<float>(kSlice, kTile);
  return a > t ? a : t;
}
template <typename T>
__host__ __device__ inline long long group_raw(int N16) {
  return group_a_raw() + raw_bytes<float>(kSlice, N16);
}
template <typename T>
__host__ __device__ inline long long group_smem(int N) {
  const int N16 = round16(N);
  return 8LL * kTile + 16 + 4LL * kTile + 8LL * 2 * kTile + 2 * group_raw<T>(N16) +
         2 * plane_bytes<T>(kTile) + plane_bytes<T>(N16) * Op<T>::kPlanes;
}
// 6. da, the row minus column sums, v
__host__ __device__ inline long long fin_smem(int Q) { return 3LL * 8 * Q; }
// Elements a thread of the state passes: 4 where P·N allows 16-byte access.
__host__ __device__ inline int state_vec(int P, int N) {
  return (static_cast<long long>(P) * N) % 4 ? 1 : 4;
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
// v as bf16 hi = bf16(v) (plane 0) and lo = bf16(v - hi) (plane 1): the
// tensor-core gradient's split of its fp32 pair weights
__device__ __forceinline__ void put_hl(bf16* p, int e, int plane, float v) {
  const bf16 hi = __float2bfloat16(v);
  p[e] = hi;
  p[e + plane] = __float2bfloat16(v - __bfloat162float(hi));
}
__device__ __forceinline__ void put_hl(uint32_t* p, int e, int plane, float v) { put(p, e, plane, v); }

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
// stores of TF32 hi and lo words; 8-byte stores of bf16, or of bf16 hi and
// lo with kHL).
template <bool kHL>
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
template <bool kHL>
__device__ __forceinline__ void put4(bf16* p, int e, int plane, const float (&v)[4]) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(v[2], v[3]);
  uint2 hi;
  hi.x = *reinterpret_cast<const uint32_t*>(&h0);
  hi.y = *reinterpret_cast<const uint32_t*>(&h1);
  *reinterpret_cast<uint2*>(p + e) = hi;
  if (kHL) {
    uint2 lo;
    lo.x = pack_bf16(v[0] - __low2float(h0), v[1] - __high2float(h0));
    lo.y = pack_bf16(v[2] - __low2float(h1), v[3] - __high2float(h1));
    *reinterpret_cast<uint2*>(p + e + plane) = lo;
  }
}

// A landed [rows][cols] tile into its operand planes: natural (row r, depth
// c) or transposed (row c, depth r, in k_order if kTransposedOrdered),
// each value times scale[r] when a scale is given; kHL: bf16 as hi and lo
// planes.  A thread takes four consecutive columns of a landed row: along
// the row when natural (vector stores), down the rows when transposed (its
// lanes then store one staged row's consecutive depths).
enum Layout { kNatural, kTransposed, kTransposedOrdered };
template <typename T, bool kHL = false, typename Ts>
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
      put4<kHL>(dst, r * kLd + c, plane, v);
    } else {
      const int k = lay == kTransposedOrdered ? k_order(r) : r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (kHL)
          put_hl(dst, (c + q) * kLd + k, plane, v[q]);
        else
          put(dst, (c + q) * kLd + k, plane, v[q]);
      }
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

// acc[·] += A[m0.., slice] · B[rows.., slice]ᵀ: pair np of acc's n8 tiles
// covers B's 16 rows from 16·(u0 + np·ustep), taken where they start below
// n_lim.  A and B are staged operands, lo planes `ap` and `bp` elements on.
// fp32: three TF32 products; bf16: one, or two where A is split into hi and
// lo (kASplit).  kFresh: the slice's products are summed in a fresh
// accumulator and added to acc in fp32; otherwise into acc itself.
template <typename T, int NT, bool kASplit = false, bool kFresh = true>
__device__ __forceinline__ void mma_slice(float (&acc)[NT][4], const typename Op<T>::S* A, int ap,
                                          const typename Op<T>::S* B, int bp, int m0, int n_lim,
                                          int lane, int u0 = 0, int ustep = 1) {
  float d[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[nt][e] = kFresh ? 0.f : acc[nt][e];
#pragma unroll
  for (int kk = 0; kk < kSlice / Op<T>::kK; ++kk) {
    uint32_t ah[4], al[4];
    ld_a<T>(ah, A, m0, kk, lane);
    if (Op<T>::kPlanes == 2 || kASplit) ld_a<T>(al, A + ap, m0, kk, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int n0 = (u0 + np * ustep) * 16;
      if (n0 < n_lim) {
        uint32_t bh[4], bl[4];
        ld_b<T>(bh, B, n0, kk, lane);
        if (Op<T>::kPlanes == 2) {
          ld_b<T>(bl, B + bp, n0, kk, lane);
          mma3(d[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma3(d[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        } else {
          if (kASplit) {
            mma_bf16(d[2 * np], al, bh[0], bh[1]);
            mma_bf16(d[2 * np + 1], al, bh[2], bh[3]);
          }
          mma_bf16(d[2 * np], ah, bh[0], bh[1]);
          mma_bf16(d[2 * np + 1], ah, bh[2], bh[3]);
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = kFresh ? acc[nt][e] + d[nt][e] : d[nt][e];
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

// Pair index of tiles (I, J), J <= I: I(I+1)/2 + J.
__host__ __device__ __forceinline__ int pair_index(int I, int J) { return I * (I + 1) / 2 + J; }

// ---------------------------- 1. chunk sums -------------------------------
// Block (((c · npb + p-block) · nnb + n-block) · 2 + which, h, b), 4 warps;
// warp w holds rows p = p0 + 16w.. and the block's 128 state columns.
// which 0: S_c[p][n] = Σ_j x_j[p] B_j[n]·dt_j·w_j; which 1: D_c[p][n] =
// Σ_i dy_i[p] C_i[n]·exp(cum_i); stored [P][N] fp32.  Slice k: 32 tokens,
// landed as stored, staged transposed (the depth is the token), the factor
// on B or C.
template <typename T>
__global__ void __launch_bounds__(kSumThreads, 1)
bwd_cc_chunk_sums(const T* __restrict__ xh, const float* __restrict__ dt,
                  const float* __restrict__ A_log, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const T* __restrict__ dy, float* __restrict__ hsum,
                  float* __restrict__ gsum, double* __restrict__ cum_out, Dims d, Strides st) {
  using S = typename Op<T>::S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = d.P, N = d.N, Q = d.Q;
  const int Qp = d.nt * kTile;
  const int npb = (P + kSumRows - 1) / kSumRows, nnb = (N + kSumBlock - 1) / kSumBlock;
  double* cum = reinterpret_cast<double*>(smem);
  double* warp_sums = cum + Qp;
  float* w = reinterpret_cast<float*>(warp_sums + 16);
  T* raw = reinterpret_cast<T*>(w + Qp);                       // two landing stages
  const int raw_stage = static_cast<int>(sums_raw<T>() / sizeof(T));
  const int xp = kSumRows * Op<T>::kLd, zp = kSumBlock * Op<T>::kLd;   // plane sizes
  S* xs = reinterpret_cast<S*>(raw + 2 * raw_stage);
  S* zs = xs + xp * Op<T>::kPlanes;

  const int which = blockIdx.x & 1, rest = blockIdx.x >> 1;
  const int nb = rest % nnb, cp = rest / nnb;
  const int c = cp / npb, pbk = cp - c * npb;
  const int hh = blockIdx.y, b = blockIdx.z, g = hh / d.rep;
  const int p0 = pbk * kSumRows, pvalid = min(kSumRows, P - p0);
  const int n0 = nb * kSumBlock, nvalid = min(kSumBlock, N - n0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = static_cast<long long>(c) * Q;
  const T* xbase = (which ? dy + b * st.yb + t0 * st.ys + hh * st.yh
                          : xh + b * st.xb + t0 * st.xs + hh * st.xh) + p0;
  const long long xstr = which ? st.ys : st.xs;
  const T* zbase = which ? Cm + b * st.cb + t0 * st.cs + g * st.cg + n0
                         : Bm + b * st.bb + t0 * st.bs + g * st.bg + n0;
  const long long zstr = which ? st.cs : st.bs;
  const int nk = (Q + kSlice - 1) / kSlice;
  auto issue = [&](int k) {
    T* r = raw + (k & 1) * raw_stage;
    const int tok = k * kSlice, nr = min(kSlice, Q - tok);
    land(r, xbase + tok * xstr, xstr, kSlice, kSumRows, nr, pvalid);
    land(r + kSlice * raw_ld<T>(kSumRows), zbase + tok * zstr, zstr, kSlice, kSumBlock, nr,
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
    if (i < Q && nb == 0 && pbk == 0 && !which) cum_g[i] = cum[i];
    w[i] = i >= Q ? 0.f
           : which ? expf(static_cast<float>(cum[i]))
                   : dtb[static_cast<long long>(i) * d.H] * exp_diff(total, cum[i]);
  }

  float acc[kSumBlock / 8][4];
#pragma unroll
  for (int nt = 0; nt < kSumBlock / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
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
    split_tile<T>(xs, xp, r, kSlice, kSumRows, kTransposed, nullptr);
    split_tile<T>(zs, zp, r + kSlice * raw_ld<T>(kSumRows), kSlice, kSumBlock, kTransposed,
                  w + k * kSlice);
    __syncthreads();
    if (m0 < pvalid)
      mma_slice<T, kSumBlock / 8>(acc, xs, xp, zs, zp, m0, round16(nvalid), lane);
  }

  float* out = (which ? gsum : hsum) +
               ((static_cast<long long>(b) * d.H + hh) * d.nc + c) * static_cast<long long>(P) * N;
  const int gq = lane >> 2, tq = lane & 3;
  const int pa = p0 + m0 + gq, pb = pa + 8;
#pragma unroll
  for (int nt = 0; nt < kSumBlock / 8; ++nt) {
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

// V consecutive floats from or to global memory (V = 4: one 16-byte access).
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

// --------------------------- 2. state passes -------------------------------
// Block (b·h, slice), V (p, n) elements a thread (V = 4 where P·N is a
// multiple of 4, else 1): h0 forward over the chunks (fp32, in place over
// S_c), G backward from d(state) (in place over D_c), and per chunk the
// block's part of <G, h0> in fp64 (a fixed tree).  The next chunk's sums are
// loaded while this chunk's step runs.
template <int V>
__global__ void __launch_bounds__(kStateThreads)
bwd_cc_state_passes(float* __restrict__ hsum, float* __restrict__ gsum,
                    const double* __restrict__ cum, const float* __restrict__ dstate,
                    double* __restrict__ c0_part, Dims d) {
  __shared__ double red[kStateThreads];
  const long long PN = static_cast<long long>(d.P) * d.N;
  const long long e = (static_cast<long long>(blockIdx.y) * kStateThreads + threadIdx.x) * V;
  const bool on = e < PN;
  const long long bh = blockIdx.x;
  const double* last = cum + bh * d.S + d.Q - 1;       // cum_Q of chunk 0
  const long long base = bh * d.nc * PN + e;
  float h[V], sv[V];
#pragma unroll
  for (int q = 0; q < V; ++q) h[q] = 0.f;
  if (on) {
    load_v<V>(sv, hsum + base);
    for (int c = 0; c < d.nc; ++c) {
      float s[V];
#pragma unroll
      for (int q = 0; q < V; ++q) s[q] = sv[q];
      if (c + 1 < d.nc) load_v<V>(sv, hsum + base + (c + 1) * PN);
      store_v<V>(hsum + base + c * PN, h);
      const float decay = expf(static_cast<float>(last[static_cast<long long>(c) * d.Q]));
#pragma unroll
      for (int q = 0; q < V; ++q) h[q] = fmaf(decay, h[q], s[q]);
    }
  }
  float g[V];
#pragma unroll
  for (int q = 0; q < V; ++q) g[q] = 0.f;
  if (on && dstate) load_v<V>(g, dstate + bh * PN + e);
  if (on) load_v<V>(sv, gsum + base + (d.nc - 1) * PN);
  for (int c = d.nc - 1; c >= 0; --c) {
    double part = 0.0;
    if (on) {
      float s[V], h0[V];
#pragma unroll
      for (int q = 0; q < V; ++q) s[q] = sv[q];
      if (c > 0) load_v<V>(sv, gsum + base + (c - 1) * PN);
      load_v<V>(h0, hsum + base + c * PN);
      store_v<V>(gsum + base + c * PN, g);
#pragma unroll
      for (int q = 0; q < V; ++q) part += static_cast<double>(h0[q]) * static_cast<double>(g[q]);
      const float decay = expf(static_cast<float>(last[static_cast<long long>(c) * d.Q]));
#pragma unroll
      for (int q = 0; q < V; ++q) g[q] = fmaf(decay, g[q], s[q]);
    }
    red[threadIdx.x] = part;
    __syncthreads();
    for (int k = kStateThreads / 2; k > 0; k >>= 1) {
      if (threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
      __syncthreads();
    }
    if (threadIdx.x == 0) c0_part[(bh * d.nc + c) * d.slices + blockIdx.y] = red[0];
    __syncthreads();
  }
}

// ------------------------------ 3. pairs ----------------------------------
// Block (pair (I, J), chunk c, b·G + g), 4 warps; warp w holds rows j = 16w..
// of column tile J and all 64 columns i of row tile I ([j][i]).  Steps, one
// 32-deep slice each: the N/32 slices of s = B_J·C_Iᵀ, then for each head
// of the group in order the P/32 slices of r = x_J·dy_Iᵀ.
template <typename T>
__global__ void __launch_bounds__(kPairThreads, 1)
bwd_cc_pairs(const T* __restrict__ xh, const float* __restrict__ dt, const T* __restrict__ Bm,
             const T* __restrict__ Cm, const T* __restrict__ dy, const double* __restrict__ cum_g,
             float* __restrict__ s_buf, float* __restrict__ w_buf, double* __restrict__ row_part,
             double* __restrict__ col_part, Dims d, Strides st) {
  using S = typename Op<T>::S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = d.P, N = d.N, Q = d.Q;
  T* raw = reinterpret_cast<T*>(smem);
  const int raw_stage = static_cast<int>(pairs_raw<T>() / sizeof(T));
  const int pl = kTile * Op<T>::kLd;
  S* as = reinterpret_cast<S*>(raw + 2 * raw_stage);           // B_J or x_J
  S* bs = as + pl * Op<T>::kPlanes;                             // C_I or dy_I
  double* red = reinterpret_cast<double*>(bs + pl * Op<T>::kPlanes);   // [4][64]
  double* cj = red + 4 * kTile;
  double* ci = cj + kTile;
  float* dtj = reinterpret_cast<float*>(ci + kTile);

  const int pair = blockIdx.x, c = blockIdx.y, bg = blockIdx.z;
  const int b = bg / d.G, g = bg - b * d.G;
  int I = 0;
  while (pair_index(I + 1, 0) <= pair) ++I;
  const int J = pair - pair_index(I, 0);
  const bool diag = I == J;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const long long t0 = static_cast<long long>(c) * Q;
  const int jt0 = J * kTile, it0 = I * kTile;
  const int nj = min(kTile, Q - jt0), ni = min(kTile, Q - it0);
  const int ns = (N + kSlice - 1) / kSlice, nsp = (P + kSlice - 1) / kSlice;
  const int steps = ns + d.rep * nsp;
  auto issue = [&](int s) {
    T* ra = raw + (s & 1) * raw_stage;
    T* rb = ra + kTile * raw_ld<T>(kSlice);
    if (s < ns) {
      const int n0 = s * kSlice, nv = min(kSlice, N - n0);
      land(ra, Bm + b * st.bb + (t0 + jt0) * st.bs + g * st.bg + n0, st.bs, kTile, kSlice, nj, nv);
      land(rb, Cm + b * st.cb + (t0 + it0) * st.cs + g * st.cg + n0, st.cs, kTile, kSlice, ni, nv);
    } else {
      const int q = s - ns, k = q / nsp, p0 = (q - k * nsp) * kSlice, hh = g * d.rep + k;
      const int pv = min(kSlice, P - p0);
      land(ra, xh + b * st.xb + (t0 + jt0) * st.xs + hh * st.xh + p0, st.xs, kTile, kSlice, nj, pv);
      land(rb, dy + b * st.yb + (t0 + it0) * st.ys + hh * st.yh + p0, st.ys, kTile, kSlice, ni, pv);
    }
  };
  issue(0);
  cp_async_commit();

  const int m0 = warp * 16, ja = m0 + gq, jb = ja + 8;
  const bool vja = ja < nj, vjb = jb < nj;
  float s[8][4], r[8][4], w2[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = w2[nt][e] = 0.f;
  const long long tile = ((static_cast<long long>(bg) * d.nc + c) * d.npairs + pair) * kTile * kTile;
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
    split_tile<T>(as, pl, ra, kTile, kSlice, kNatural, nullptr);
    split_tile<T>(bs, pl, ra + kTile * raw_ld<T>(kSlice), kTile, kSlice, kNatural, nullptr);
    const int q = k - ns, hk = q < 0 ? 0 : q / nsp, sl = q < 0 ? 0 : q - hk * nsp;
    const int hh = g * d.rep + hk;
    if (q >= 0 && sl == 0) {               // this head's cum of J and I and dt of J
      const double* cb = cum_g + (static_cast<long long>(b) * d.H + hh) * d.S + t0;
      for (int e = tid; e < kTile; e += blockDim.x) {
        cj[e] = e < nj ? cb[jt0 + e] : 0.0;
        ci[e] = e < ni ? cb[it0 + e] : 0.0;
        dtj[e] = e < nj ? dt[(static_cast<long long>(b) * d.S + t0 + jt0 + e) * d.H + hh] : 0.f;
      }
    }
    __syncthreads();
    if (q < 0) {
      // C·Bᵀ of the pair, once for the group: s[j][i] = B_j · C_i
      mma_slice<T, 8>(s, as, pl, bs, pl, m0, kTile, lane);
      if (k == ns - 1) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int i = nt * 8 + 2 * tq;
          *reinterpret_cast<float2*>(s_buf + tile + ja * kTile + i) = make_float2(s[nt][0], s[nt][1]);
          *reinterpret_cast<float2*>(s_buf + tile + jb * kTile + i) = make_float2(s[nt][2], s[nt][3]);
        }
      }
      continue;
    }
    // dy·x~ᵀ of the pair, once per head: r[j][i] = x_j · dy_i (times dt_j below)
    if (sl == 0) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) r[nt][0] = r[nt][1] = r[nt][2] = r[nt][3] = 0.f;
    }
    mma_slice<T, 8>(r, as, pl, bs, pl, m0, kTile, lane);
    if (sl != nsp - 1) continue;
    const double cja = cj[ja], cjb = cj[jb];
    const float dta = dtj[ja], dtb = dtj[jb];
    double col_a = 0.0, col_b = 0.0;   // Σ_i M over this lane's columns, rows ja and jb
    double rowp[8][2];                 // Σ over rows ja, jb of M, per column
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = nt * 8 + 2 * tq + e;
        const bool vi = i < ni;
        const double cii = ci[i];
        const float ra = r[nt][e] * dta, rb = r[nt][2 + e] * dtb;
        // mask before exp: a pair j > i, or a token past the chunk, takes 0
        const float La = (vja && vi && (!diag || ja <= i)) ? exp_diff(cii, cja) : 0.f;
        const float Lb = (vjb && vi && (!diag || jb <= i)) ? exp_diff(cii, cjb) : 0.f;
        w2[nt][e] += La * ra;
        w2[nt][2 + e] += Lb * rb;
        const double ma = (!diag || ja < i) ? static_cast<double>((La * s[nt][e]) * ra) : 0.0;
        const double mb = (!diag || jb < i) ? static_cast<double>((Lb * s[nt][2 + e]) * rb) : 0.0;
        col_a += ma;
        col_b += mb;
        rowp[nt][e] = ma + mb;
      }
    }
    // column sums of M (over i) for rows ja, jb: across the quad
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      col_a += __shfl_xor_sync(0xffffffffu, col_a, o);
      col_b += __shfl_xor_sync(0xffffffffu, col_b, o);
    }
    const long long tok = (static_cast<long long>(b) * d.H + hh) * d.S + t0;
    if (tq == 0) {
      if (vja) col_part[(tok + jt0 + ja) * d.nt + I] = col_a;
      if (vjb) col_part[(tok + jt0 + jb) * d.nt + I] = col_b;
    }
    // row sums of M (over j) per column i: across the 8 row lanes, then warps
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        double v = rowp[nt][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (gq == 0) red[warp * kTile + nt * 8 + 2 * tq + e] = v;
      }
    }
    __syncthreads();                       // red written (uniform: every thread is here)
    if (tid < ni)
      row_part[(tok + it0 + tid) * d.nt + J] =
          ((red[tid] + red[kTile + tid]) + red[2 * kTile + tid]) + red[3 * kTile + tid];
  }

  // the heads' sum of L∘r, fp32 [j][i]
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int i = nt * 8 + 2 * tq;
    *reinterpret_cast<float2*>(w_buf + tile + ja * kTile + i) = make_float2(w2[nt][0], w2[nt][1]);
    *reinterpret_cast<float2*>(w_buf + tile + jb * kTile + i) = make_float2(w2[nt][2], w2[nt][3]);
  }
}

// ----------------------------- 4. columns ---------------------------------
// Block (c · nt + J, h, b), 4 warps; warp w holds rows j = 16w.. of column
// tile J and the P columns of dx~.  Steps: the N/32 slices of G·B_J (B_J
// [64][32 n], G [P][32 n] fp32), then for each row tile I >= J its two
// 32-token halves of (L∘s)ᵀ·dy_I (dy_I landed [32 tokens][P], staged
// transposed).  kPT: P rounded up to 32, 64 or 128.
// Three blocks an SM up to P 64 (shared memory allows it; no spill).
template <typename T, int kPT>
__global__ void __launch_bounds__(kColThreads, kPT <= 64 ? 3 : 1)
bwd_cc_columns(const T* __restrict__ xh, const float* __restrict__ dt, const T* __restrict__ Bm,
               const T* __restrict__ dy, const double* __restrict__ cum_g,
               const float* __restrict__ gbuf, const float* __restrict__ s_buf,
               T* __restrict__ dxh, float* __restrict__ xdx_out, double* __restrict__ v_out,
               Dims d, Strides st) {
  using S = typename Op<T>::S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = d.P, N = d.N, Q = d.Q, P16 = d.P16;
  const int Qp = d.nt * kTile, RB = max_i(kTile, P16);
  double* cum = reinterpret_cast<double*>(smem);
  unsigned char* raw = reinterpret_cast<unsigned char*>(cum + Qp);
  const int raw_stage = static_cast<int>(cols_raw<T>(P16));     // bytes
  const int ap = kTile * Op<T>::kLd, bp = RB * Op<T>::kLd;
  S* as = reinterpret_cast<S*>(raw + 2 * raw_stage);             // B_J
  S* bs = as + ap * Op<T>::kPlanes;                              // G or dy_I

  const int c = blockIdx.x / d.nt, J = blockIdx.x - c * d.nt;
  const int hh = blockIdx.y, b = blockIdx.z, g = hh / d.rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const long long t0 = static_cast<long long>(c) * Q;
  const int jt0 = J * kTile, nj = min(kTile, Q - jt0);
  const long long bh = static_cast<long long>(b) * d.H + hh;
  const float* gsrc = gbuf + (bh * d.nc + c) * static_cast<long long>(P) * N;
  const T* bsrc = Bm + b * st.bb + (t0 + jt0) * st.bs + g * st.bg;
  const int ns = (N + kSlice - 1) / kSlice;
  const int steps = ns + 2 * (d.nt - J);
  auto issue = [&](int s) {
    unsigned char* r = raw + (s & 1) * raw_stage;
    float* rg = reinterpret_cast<float*>(r + raw_bytes<T>(kTile, kSlice));
    if (s < ns) {                                       // B_J and G, slice s of n
      const int n0 = s * kSlice, nv = min(kSlice, N - n0);
      land(reinterpret_cast<T*>(r), bsrc + n0, st.bs, kTile, kSlice, nj, nv);
      land(rg, gsrc + n0, static_cast<long long>(N), RB, kSlice, P, nv);
    } else {                                            // dy of a half of row tile I
      const int q = s - ns, tok = (J + (q >> 1)) * kTile + (q & 1) * kSlice;
      land(reinterpret_cast<T*>(rg), dy + b * st.yb + (t0 + tok) * st.ys + hh * st.yh, st.ys,
           kSlice, P16, min(kSlice, Q - tok), P);
    }
  };
  issue(0);
  cp_async_commit();
  const double* cg = cum_g + bh * d.S + t0;
  for (int i = tid; i < Qp; i += blockDim.x) cum[i] = i < Q ? cg[i] : 0.0;

  const int m0 = warp * 16, ja = m0 + gq, jb = ja + 8;
  const bool vja = ja < nj, vjb = jb < nj;
  const T* xa = xh + b * st.xb + (t0 + jt0 + ja) * st.xs + hh * st.xh;
  const T* xb = xa + 8 * st.xs;
  const float* dtr = dt + (static_cast<long long>(b) * d.S + t0 + jt0) * d.H + hh;
  const float dta = vja ? dtr[static_cast<long long>(ja) * d.H] : 0.f;
  const float dtb = vjb ? dtr[static_cast<long long>(jb) * d.H] : 0.f;
  float acc[kPT / 8][4], ls[8][4];
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
    const unsigned char* r = raw + (k & 1) * raw_stage;
    const float* rg = reinterpret_cast<const float*>(r + raw_bytes<T>(kTile, kSlice));
    if (k < ns) {
      split_tile<T>(as, ap, reinterpret_cast<const T*>(r), kTile, kSlice, kNatural, nullptr);
      split_tile<T>(bs, bp, rg, RB, kSlice, kNatural, nullptr);
    } else {
      split_tile<T>(bs, bp, reinterpret_cast<const T*>(rg), kSlice, P16,
                    Op<T>::kPlanes == 2 ? kTransposedOrdered : kTransposed, nullptr);
    }
    __syncthreads();
    if (k < ns) {
      // G·B_J: A = B_J [j][n], B = G [p][n]
      mma_slice<T, kPT / 8>(acc, as, ap, bs, bp, m0, P16, lane);
      if (k == ns - 1) {
        // v_j = w_j Σ_p x~_j[p] (G B_j)[p] in fp64, then acc = w_j (G B_j)
        const double total = cum[Q - 1];
        const float wa = vja ? exp_diff(total, cum[jt0 + ja]) : 0.f;
        const float wb = vjb ? exp_diff(total, cum[jt0 + jb]) : 0.f;
        double va = 0.0, vb = 0.0;
#pragma unroll
        for (int nt = 0; nt < kPT / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = nt * 8 + 2 * tq + e;
            if (p < P) {
              if (vja) va += static_cast<double>((to_f32(xa[p]) * dta) * acc[nt][e]);
              if (vjb) vb += static_cast<double>((to_f32(xb[p]) * dtb) * acc[nt][2 + e]);
            }
            acc[nt][e] *= wa;
            acc[nt][2 + e] *= wb;
          }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          va += __shfl_xor_sync(0xffffffffu, va, o);
          vb += __shfl_xor_sync(0xffffffffu, vb, o);
        }
        if (tq == 0) {
          if (vja) v_out[bh * d.S + t0 + jt0 + ja] = static_cast<double>(wa) * va;
          if (vjb) v_out[bh * d.S + t0 + jt0 + jb] = static_cast<double>(wb) * vb;
        }
      }
      continue;
    }
    const int q = k - ns, I = J + (q >> 1), it0 = I * kTile;
    if ((q & 1) == 0) {
      // (L∘s)ᵀ of the pair in registers, rows ja, jb, from launch 3's C·Bᵀ
      // (s[j][i]); 0 where i < j or a token lies past the chunk (no exp)
      const float* sp = s_buf +
          ((((static_cast<long long>(b) * d.G + g) * d.nc + c) * d.npairs + pair_index(I, J)) *
           kTile * kTile);
      const double cja = cum[jt0 + ja], cjb = cum[jt0 + jb];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int i = nt * 8 + 2 * tq;
        const float2 sa = *reinterpret_cast<const float2*>(sp + ja * kTile + i);
        const float2 sb = *reinterpret_cast<const float2*>(sp + jb * kTile + i);
        const float sv[4] = {sa.x, sa.y, sb.x, sb.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = i + (e & 1), jl = e < 2 ? ja : jb;
          const bool ok = (e < 2 ? vja : vjb) && it0 + il < Q && (I != J || jl <= il);
          ls[nt][e] = ok ? exp_diff(cum[it0 + il], e < 2 ? cja : cjb) * sv[e] : 0.f;
        }
      }
      mma_regs<T, kPT / 8, 0>(acc, ls, bs, bp, P16, lane);
    } else {
      mma_regs<T, kPT / 8, 1>(acc, ls, bs, bp, P16, lane);
    }
  }

  // dxh = dt·dx~ (contiguous [B,S,H,P]) and <x, dx~>
  const long long ytok = static_cast<long long>(d.H) * P;
  T* ya = dxh + (static_cast<long long>(b) * d.S + t0 + jt0 + ja) * ytok + static_cast<long long>(hh) * P;
  T* yb = ya + 8 * ytok;
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int nt = 0; nt < kPT / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = nt * 8 + 2 * tq + e;
      if (p < P) {
        if (vja) {
          ya[p] = from_f32<T>(dta * acc[nt][e]);
          sa = fmaf(to_f32(xa[p]), acc[nt][e], sa);
        }
        if (vjb) {
          yb[p] = from_f32<T>(dtb * acc[nt][2 + e]);
          sb = fmaf(to_f32(xb[p]), acc[nt][2 + e], sb);
        }
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, o);
    sb += __shfl_xor_sync(0xffffffffu, sb, o);
  }
  if (tq == 0) {
    if (vja) xdx_out[bh * d.S + t0 + jt0 + ja] = sa;
    if (vjb) xdx_out[bh * d.S + t0 + jt0 + jb] = sb;
  }
}

// ------------------------------ 5. group ----------------------------------
// Block ((c·nt + T)·2 + which, g, b), 8 warps: warp w holds rows t = 16(w &
// 3).. of tile T and the 16-column units u ≡ (w >> 2) (mod 2) of N.  which 0
// gives dB_T, which 1 dC_T.  Steps, one 32-deep slice each: for each head of
// the group in order, the P/32 slices of x_T·G (dy_T·h0) — x or dy [64][32
// p], G or h0 landed [32 p][N] (fp32) and staged transposed — whose rows
// take the head's factor after its last slice; then the quadratic term,
// two 32-token halves a tile pair: dB_T += Wᵀ-rows·C_I (W [j = T][i], C_I
// landed [32 i][N]) or dC_T += W·B_J (W landed [32 j][64 i], staged
// transposed; B_J [32 j][N]).  kNT: N rounded up to 64, 128 or 256.
// Two blocks an SM in bf16 up to N 128; one in fp32, whose registers
// spill under a 2-block cap at N 128.
template <typename T, int kNT>
__global__ void __launch_bounds__(kGroupThreads, kNT <= 128 && Op<T>::kPlanes == 1 ? 2 : 1)
bwd_cc_group(const T* __restrict__ xh, const float* __restrict__ dt, const T* __restrict__ Bm,
             const T* __restrict__ Cm, const T* __restrict__ dy, const double* __restrict__ cum_g,
             const float* __restrict__ h0buf, const float* __restrict__ gbuf,
             const float* __restrict__ w_buf, T* __restrict__ dBm, T* __restrict__ dCm,
             double* __restrict__ u_out, Dims d, Strides st) {
  using S = typename Op<T>::S;
  constexpr int kU = kNT / 32;                          // units a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = d.P, N = d.N, Q = d.Q, N16 = d.N16;
  double* cumt = reinterpret_cast<double*>(smem);       // [64] a head's cum of the tile
  double* cq = cumt + kTile;                            // [2] its cum_Q
  float* dtt = reinterpret_cast<float*>(cq + 2);        // [64] its dt of the tile
  double* red = reinterpret_cast<double*>(dtt + kTile); // [2][64] u's halves
  unsigned char* raw = reinterpret_cast<unsigned char*>(red + 2 * kTile);
  const int raw_stage = static_cast<int>(group_raw<T>(N16));     // bytes
  const int ap = kTile * Op<T>::kLd, bp = N16 * Op<T>::kLd;
  S* as = reinterpret_cast<S*>(raw + 2 * raw_stage);             // two planes
  S* bs = as + 2 * ap;

  const int which = blockIdx.x & 1, ct = blockIdx.x >> 1;
  const int c = ct / d.nt, Tt = ct - c * d.nt;
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const int m0 = (warp & 3) * 16, nh = warp >> 2;
  const long long t0 = static_cast<long long>(c) * Q;
  const int tt0 = Tt * kTile, nrow = min(kTile, Q - tt0);
  const int nsp = (P + kSlice - 1) / kSlice;
  const int head_steps = d.rep * nsp;
  const int steps = head_steps + 2 * (which ? Tt + 1 : d.nt - Tt);
  const long long ptile = (static_cast<long long>(b) * d.G + g) * d.nc + c;
  auto issue = [&](int s) {
    unsigned char* r = raw + (s & 1) * raw_stage;
    unsigned char* rz = r + group_a_raw();
    if (s < head_steps) {
      const int hk = s / nsp, p0 = (s - hk * nsp) * kSlice, hh = g * d.rep + hk;
      const int pv = min(kSlice, P - p0);
      const T* asrc = which ? dy + b * st.yb + (t0 + tt0) * st.ys + hh * st.yh
                            : xh + b * st.xb + (t0 + tt0) * st.xs + hh * st.xh;
      land(reinterpret_cast<T*>(r), asrc + p0, which ? st.ys : st.xs, kTile, kSlice, nrow, pv);
      const float* zsrc = (which ? h0buf : gbuf) +
                          ((static_cast<long long>(b) * d.H + hh) * d.nc + c) * static_cast<long long>(P) * N;
      land(reinterpret_cast<float*>(rz), zsrc + static_cast<long long>(p0) * N,
           static_cast<long long>(N), kSlice, N16, pv, N);
    } else {
      const int q = s - head_steps, pq = q >> 1, half = q & 1;
      const int I = which ? Tt : Tt + pq, J = which ? pq : Tt;
      const float* wt = w_buf + (ptile * d.npairs + pair_index(I, J)) * kTile * kTile;
      const int tok = (which ? J : I) * kTile + half * kSlice;
      if (which)                           // W rows j of this half, all 64 columns i
        land(reinterpret_cast<float*>(r), wt + half * kSlice * kTile, static_cast<long long>(kTile),
             kSlice, kTile, kSlice, kTile);
      else                                 // W all 64 rows j, columns i of this half
        land(reinterpret_cast<float*>(r), wt + half * kSlice, static_cast<long long>(kTile), kTile,
             kSlice, kTile, kSlice);
      const T* zsrc = which ? Bm + b * st.bb + (t0 + tok) * st.bs + g * st.bg
                            : Cm + b * st.cb + (t0 + tok) * st.cs + g * st.cg;
      land(reinterpret_cast<T*>(rz), zsrc, which ? st.bs : st.cs, kSlice, N16, min(kSlice, Q - tok),
           N);
    }
  };
  issue(0);
  cp_async_commit();

  float acc[2 * kU][4];
#pragma unroll
  for (int f = 0; f < 2 * kU; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.f;
  const int ta = m0 + gq, tb = ta + 8;
  // slice k landed and split into its planes (the next one in flight)
  auto stage = [&](int k) {
    if (k + 1 < steps) {
      issue(k + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // slice k landed; the planes are free
    const unsigned char* r = raw + (k & 1) * raw_stage;
    const unsigned char* rz = r + group_a_raw();
    if (k < head_steps) {
      split_tile<T>(as, ap, reinterpret_cast<const T*>(r), kTile, kSlice, kNatural, nullptr);
      split_tile<T>(bs, bp, reinterpret_cast<const float*>(rz), kSlice, N16, kTransposed, nullptr);
      const int hk = k / nsp, hh = g * d.rep + hk;
      if (k - hk * nsp == 0) {             // this head's cum and dt of the tile, and cum_Q
        const double* cb = cum_g + (static_cast<long long>(b) * d.H + hh) * d.S + t0;
        for (int e = tid; e < kTile; e += blockDim.x) {
          cumt[e] = e < nrow ? cb[tt0 + e] : 0.0;
          dtt[e] = e < nrow ? dt[(static_cast<long long>(b) * d.S + t0 + tt0 + e) * d.H + hh] : 0.f;
        }
        if (tid == 0) cq[0] = cb[Q - 1];
      }
    } else {
      split_tile<T, true>(as, ap, reinterpret_cast<const float*>(r), which ? kSlice : kTile,
                          which ? kTile : kSlice, which ? kTransposed : kNatural, nullptr);
      split_tile<T>(bs, bp, reinterpret_cast<const T*>(rz), kSlice, N16, kTransposed, nullptr);
    }
    __syncthreads();
  };
  // the state terms, head by head (tmp is dead once they are done)
  {
    float tmp[2 * kU][4];
#pragma unroll
    for (int f = 0; f < 2 * kU; ++f) tmp[f][0] = tmp[f][1] = tmp[f][2] = tmp[f][3] = 0.f;
    for (int k = 0; k < head_steps; ++k) {
      stage(k);
      const int hk = k / nsp, sl = k - hk * nsp, hh = g * d.rep + hk;
      mma_slice<T, 2 * kU, false, false>(tmp, as, ap, bs, bp, m0, N16, lane, nh, 2);
      if (sl != nsp - 1) continue;
      // the head's factor on the rows: dt·w (dB) or exp(cum) (dC)
      const bool va = ta < nrow, vb = tb < nrow;
      float fa, fb;
      if (which) {
        fa = va ? expf(static_cast<float>(cumt[ta])) : 0.f;
        fb = vb ? expf(static_cast<float>(cumt[tb])) : 0.f;
        // u_t = exp(cum_t) Σ_n C_t[n] (h0ᵀ dy_t)[n], fp64 over fp32 products
        const T* ca = Cm + b * st.cb + (t0 + tt0 + ta) * st.cs + g * st.cg;
        const T* cbp = ca + 8 * st.cs;
        double pa = 0.0, pb = 0.0;
#pragma unroll
        for (int ui = 0; ui < kU; ++ui) {
          const int u = 2 * ui + nh;
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = u * 16 + h8 * 8 + 2 * tq + e;
              if (n < N) {
                if (va) pa += static_cast<double>(to_f32(ca[n]) * tmp[2 * ui + h8][e]);
                if (vb) pb += static_cast<double>(to_f32(cbp[n]) * tmp[2 * ui + h8][2 + e]);
              }
            }
          }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          pa += __shfl_xor_sync(0xffffffffu, pa, o);
          pb += __shfl_xor_sync(0xffffffffu, pb, o);
        }
        if (tq == 0) {
          red[nh * kTile + ta] = pa;
          red[nh * kTile + tb] = pb;
        }
      } else {
        fa = va ? dtt[ta] * exp_diff(cq[0], cumt[ta]) : 0.f;
        fb = vb ? dtt[tb] * exp_diff(cq[0], cumt[tb]) : 0.f;
      }
#pragma unroll
      for (int f = 0; f < 2 * kU; ++f) {
        acc[f][0] = fmaf(fa, tmp[f][0], acc[f][0]);
        acc[f][1] = fmaf(fa, tmp[f][1], acc[f][1]);
        acc[f][2] = fmaf(fb, tmp[f][2], acc[f][2]);
        acc[f][3] = fmaf(fb, tmp[f][3], acc[f][3]);
        tmp[f][0] = tmp[f][1] = tmp[f][2] = tmp[f][3] = 0.f;
      }
      if (which) {
        __syncthreads();                   // red written (uniform over the block)
        if (tid < nrow)
          u_out[(static_cast<long long>(b) * d.H + hh) * d.S + t0 + tt0 + tid] =
              static_cast<double>(expf(static_cast<float>(cumt[tid]))) *
              (red[tid] + red[kTile + tid]);
      }
    }
  }
  // the quadratic term: dB_T += W[t][i]·C_i over each half; dC_T += Wᵀ[t][j]·B_j
  for (int k = head_steps; k < steps; ++k) {
    stage(k);
    mma_slice<T, 2 * kU, true>(acc, as, ap, bs, bp, m0, N16, lane, nh, 2);
  }

  T* out = which ? dCm : dBm;
  const long long orow = static_cast<long long>(d.G) * N;
  T* oa = out + (static_cast<long long>(b) * d.S + t0 + tt0 + ta) * orow + static_cast<long long>(g) * N;
  T* ob = oa + 8 * orow;
#pragma unroll
  for (int ui = 0; ui < kU; ++ui) {
    const int u = 2 * ui + nh;
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = u * 16 + h8 * 8 + 2 * tq + e;
        if (n < N) {
          if (ta < nrow) oa[n] = from_f32<T>(acc[2 * ui + h8][e]);
          if (tb < nrow) ob[n] = from_f32<T>(acc[2 * ui + h8][2 + e]);
        }
      }
    }
  }
}

// ---------------------------- 6. finalize ---------------------------------
__global__ void __launch_bounds__(kFinThreads)
bwd_cc_finalize(const float* __restrict__ dt, const float* __restrict__ A_log,
                const double* __restrict__ cum_g, const double* __restrict__ c0_part,
                const double* __restrict__ row_part, const double* __restrict__ col_part,
                const double* __restrict__ u, const double* __restrict__ v,
                const float* __restrict__ xdx, float* __restrict__ ddt,
                double* __restrict__ dA_part, Dims d) {
  extern __shared__ double fin[];
  const int Q = d.Q;
  double* da = fin;            // [Q]
  double* rc = fin + Q;        // [Q] row - column sums
  double* vv = fin + 2 * Q;    // [Q]
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const long long bh = static_cast<long long>(b) * d.H + hh;
  const long long tok = bh * d.S + static_cast<long long>(c) * Q;
  for (int t = tid; t < Q; t += blockDim.x) {
    const int I = t / kTile;
    const double* rp = row_part + (tok + t) * d.nt;
    const double* cp = col_part + (tok + t) * d.nt;
    double row = 0.0, col = 0.0;
    for (int J = 0; J <= I; ++J) row += rp[J];
    for (int K = I; K < d.nt; ++K) col += cp[K];
    rc[t] = (row + u[tok + t]) - col;
    vv[t] = v[tok + t];
  }
  __syncthreads();
  const float A = -expf(A_log[hh]);
  const float* dtb = dt + (static_cast<long long>(b) * d.S + static_cast<long long>(c) * Q) * d.H + hh;
  if (tid == 0) {
    double dot = 0.0;
    for (int s = 0; s < d.slices; ++s) dot += c0_part[(bh * d.nc + c) * d.slices + s];
    const double c0 = exp(cum_g[tok + Q - 1]) * dot;
    double run = 0.0;
    for (int t = Q - 1; t >= 0; --t) {
      run += rc[t];
      da[t] = run;
    }
    double below = 0.0, dA = 0.0;
    for (int t = 0; t < Q; ++t) {
      da[t] += below + c0;
      below += vv[t];
      dA += static_cast<double>(A * dtb[static_cast<long long>(t) * d.H]) * da[t];
    }
    dA_part[bh * d.nc + c] = dA;
  }
  __syncthreads();
  for (int t = tid; t < Q; t += blockDim.x)
    ddt[(static_cast<long long>(b) * d.S + static_cast<long long>(c) * Q + t) * d.H + hh] =
        xdx[tok + t] + A * static_cast<float>(da[t]);
}

// ----------------------------- 7. dA_log ----------------------------------
__global__ void __launch_bounds__(kFinThreads)
bwd_cc_dA_log(const double* __restrict__ dA_part, float* __restrict__ dA_log, int batch, Dims d) {
  for (int hh = threadIdx.x; hh < d.H; hh += blockDim.x) {
    double acc = 0.0;
    for (int b = 0; b < batch; ++b)
      for (int c = 0; c < d.nc; ++c) acc += dA_part[(static_cast<long long>(b) * d.H + hh) * d.nc + c];
    dA_log[hh] = static_cast<float>(acc);
  }
}

// ------------------------------ scratch -----------------------------------
long long up(long long n) { return (n + kAlign - 1) / kAlign * kAlign; }

struct Scratch {
  long long cum, hsum, gsum, c0, u, v, xdx, dA, s_buf, w_buf, row, col, total;
};

// Byte offsets of the scratch regions.
Scratch carve(long long batch, const Dims& d) {
  const long long bhs = batch * d.H * d.S, PN = static_cast<long long>(d.P) * d.N;
  const long long states = batch * d.H * d.nc * PN;
  const long long tiles = batch * d.G * d.nc * d.npairs * kTile * kTile;
  Scratch s{};
  long long at = 0;
  auto take = [&](long long bytes) { const long long o = at; at += up(bytes); return o; };
  s.cum = take(8 * bhs);
  s.hsum = take(4 * states);
  s.gsum = take(4 * states);
  s.c0 = take(8 * batch * d.H * d.nc * d.slices);
  s.u = take(8 * bhs);
  s.v = take(8 * bhs);
  s.xdx = take(4 * bhs);
  s.dA = take(8 * batch * d.H * d.nc);
  s.s_buf = take(4 * tiles);
  s.w_buf = take(4 * tiles);
  s.row = take(8 * bhs * d.nt);
  s.col = take(8 * bhs * d.nt);
  s.total = at;
  return s;
}

template <typename T>
long long max_smem(const Dims& d) {
  long long m = sums_smem<T>(d.Q);
  const long long o[4] = {pairs_smem<T>(), cols_smem<T>(d.P, d.Q), group_smem<T>(d.N),
                          fin_smem(d.Q)};
  for (long long v : o) m = v > m ? v : m;
  return m;
}

int check(int batch, int seqlen, int heads, int headdim, int groups, int dstate, int chunk,
          int dtype, Dims& d) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || groups <= 0 || chunk <= 0 || headdim <= 0 ||
      dstate <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (headdim > kMaxP || dstate > kMaxN || seqlen % chunk || heads % groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = seqlen / chunk, nt = (chunk + kTile - 1) / kTile;
  if (batch > kMaxGridYZ || heads > kMaxGridYZ || nc > kMaxGridYZ ||
      static_cast<long long>(batch) * groups > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  d = Dims{seqlen, heads, headdim, groups, dstate, chunk, nc, heads / groups, nt,
           nt * (nt + 1) / 2,
           static_cast<int>((static_cast<long long>(headdim) * dstate / state_vec(headdim, dstate) +
                             kStateThreads - 1) / kStateThreads),
           round16(headdim), round16(dstate)};
  if ((dtype ? max_smem<bf16>(d) : max_smem<float>(d)) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Each launch's kernel for (P, N) and the dtype, for the launch and for its
// attributes.
template <typename T, int kPT>
void kernels_p(const void** f) {
  f[3] = reinterpret_cast<const void*>(bwd_cc_columns<T, kPT>);
}
template <typename T, int kNT>
void kernels_n(const void** f) {
  f[4] = reinterpret_cast<const void*>(bwd_cc_group<T, kNT>);
}
template <typename T>
void kernels_for(int P, int N, const void** f) {
  if (P <= 32) kernels_p<T, 32>(f);
  else if (P <= 64) kernels_p<T, 64>(f);
  else kernels_p<T, 128>(f);
  if (N <= 64) kernels_n<T, 64>(f);
  else if (N <= 128) kernels_n<T, 128>(f);
  else kernels_n<T, 256>(f);
  f[0] = reinterpret_cast<const void*>(bwd_cc_chunk_sums<T>);
  f[1] = reinterpret_cast<const void*>(bwd_cc_state_passes<4>);
  f[2] = reinterpret_cast<const void*>(bwd_cc_pairs<T>);
  f[5] = reinterpret_cast<const void*>(bwd_cc_finalize);
  f[6] = reinterpret_cast<const void*>(bwd_cc_dA_log);
}

template <typename T>
int launch(const void* xh, const void* dt, const void* A_log, const void* Bm, const void* Cm,
           const void* dy, const void* dstate, void* dxh, void* ddt, void* dA_log, void* dBm,
           void* dCm, void* scratch, int batch, const Dims& d, const Strides& st,
           cudaStream_t s) {
  const Scratch sc = carve(batch, d);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  double* cum = reinterpret_cast<double*>(base + sc.cum);
  float* hsum = reinterpret_cast<float*>(base + sc.hsum);
  float* gsum = reinterpret_cast<float*>(base + sc.gsum);
  double* c0 = reinterpret_cast<double*>(base + sc.c0);
  double* u = reinterpret_cast<double*>(base + sc.u);
  double* v = reinterpret_cast<double*>(base + sc.v);
  float* xdx = reinterpret_cast<float*>(base + sc.xdx);
  double* dA = reinterpret_cast<double*>(base + sc.dA);
  float* s_buf = reinterpret_cast<float*>(base + sc.s_buf);
  float* w_buf = reinterpret_cast<float*>(base + sc.w_buf);
  double* row = reinterpret_cast<double*>(base + sc.row);
  double* col = reinterpret_cast<double*>(base + sc.col);
  const auto* x = static_cast<const T*>(xh);
  const auto* t = static_cast<const float*>(dt);
  const auto* a = static_cast<const float*>(A_log);
  const auto* bm = static_cast<const T*>(Bm);
  const auto* cm = static_cast<const T*>(Cm);
  const auto* y = static_cast<const T*>(dy);

  const void* f[7];
  kernels_for<T>(d.P, d.N, f);
  const long long smem[7] = {sums_smem<T>(d.Q), 0, pairs_smem<T>(), cols_smem<T>(d.P, d.Q),
                             group_smem<T>(d.N), fin_smem(d.Q), 0};
  for (int k = 0; k < 7; ++k) {
    if (!smem[k]) continue;
    const cudaError_t err = cudaFuncSetAttribute(f[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem[k]));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err;
  const int npb = (d.P + kSumRows - 1) / kSumRows, nnb = (d.N + kSumBlock - 1) / kSumBlock;
  // 1. chunk sums
  bwd_cc_chunk_sums<T><<<dim3(2 * d.nc * npb * nnb, d.H, batch), kSumThreads, smem[0], s>>>(
      x, t, a, bm, cm, y, hsum, gsum, cum, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // 2. state passes
  const dim3 sgrid(batch * d.H, d.slices);
  if (state_vec(d.P, d.N) == 4)
    bwd_cc_state_passes<4><<<sgrid, kStateThreads, 0, s>>>(
        hsum, gsum, cum, static_cast<const float*>(dstate), c0, d);
  else
    bwd_cc_state_passes<1><<<sgrid, kStateThreads, 0, s>>>(
        hsum, gsum, cum, static_cast<const float*>(dstate), c0, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // 3. pairs
  bwd_cc_pairs<T><<<dim3(d.npairs, d.nc, batch * d.G), kPairThreads, smem[2], s>>>(
      x, t, bm, cm, y, cum, s_buf, w_buf, row, col, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // 4. columns
  {
    const dim3 grid(d.nc * d.nt, d.H, batch);
    T* o = static_cast<T*>(dxh);
    if (d.P <= 32)
      bwd_cc_columns<T, 32><<<grid, kColThreads, smem[3], s>>>(x, t, bm, y, cum, gsum, s_buf, o, xdx, v, d, st);
    else if (d.P <= 64)
      bwd_cc_columns<T, 64><<<grid, kColThreads, smem[3], s>>>(x, t, bm, y, cum, gsum, s_buf, o, xdx, v, d, st);
    else
      bwd_cc_columns<T, 128><<<grid, kColThreads, smem[3], s>>>(x, t, bm, y, cum, gsum, s_buf, o, xdx, v, d, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  // 5. group
  {
    const dim3 grid(2 * d.nc * d.nt, d.G, batch);
    T* ob = static_cast<T*>(dBm);
    T* oc = static_cast<T*>(dCm);
    if (d.N <= 64)
      bwd_cc_group<T, 64><<<grid, kGroupThreads, smem[4], s>>>(x, t, bm, cm, y, cum, hsum, gsum, w_buf, ob, oc, u, d, st);
    else if (d.N <= 128)
      bwd_cc_group<T, 128><<<grid, kGroupThreads, smem[4], s>>>(x, t, bm, cm, y, cum, hsum, gsum, w_buf, ob, oc, u, d, st);
    else
      bwd_cc_group<T, 256><<<grid, kGroupThreads, smem[4], s>>>(x, t, bm, cm, y, cum, hsum, gsum, w_buf, ob, oc, u, d, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  // 6. finalize
  bwd_cc_finalize<<<dim3(d.nc, d.H, batch), kFinThreads, smem[5], s>>>(
      t, a, cum, c0, row, col, u, v, xdx, static_cast<float*>(ddt), dA, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // 7. dA_log
  bwd_cc_dA_log<<<1, kFinThreads, 0, s>>>(dA, static_cast<float*>(dA_log), batch, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared bytes of the launches — chunk sums, pairs, columns, group,
// finalize — for head dim P, state dim N, chunk Q and dtype (0 fp32, 1
// bf16) into out[0..5).
extern "C" void arcadia_ssd_scan_bwd_plan(int headdim, int dstate, int chunk, int dtype,
                                          long long* out) {
  if (dtype) {
    out[0] = sums_smem<bf16>(chunk);
    out[1] = pairs_smem<bf16>();
    out[2] = cols_smem<bf16>(headdim, chunk);
    out[3] = group_smem<bf16>(dstate);
  } else {
    out[0] = sums_smem<float>(chunk);
    out[1] = pairs_smem<float>();
    out[2] = cols_smem<float>(headdim, chunk);
    out[3] = group_smem<float>(dstate);
  }
  out[4] = fin_smem(chunk);
}

// Bytes of scratch the caller allocates (256-byte aligned) for a call, or -1
// for a shape the kernel does not take.
extern "C" long long arcadia_ssd_scan_bwd_scratch_bytes(int batch, int seqlen, int heads,
                                                       int headdim, int groups, int dstate,
                                                       int chunk, int dtype) {
  Dims d;
  if (check(batch, seqlen, heads, headdim, groups, dstate, chunk, dtype, d) != 0) return -1;
  return carve(batch, d).total;
}

// cudaFuncGetAttributes of the kernel of launch `launch` (0 chunk sums, 1
// state passes, 2 pairs, 3 columns, 4 group, 5 finalize, 6 dA_log) for head
// dim P, state dim N and dtype (0 fp32, 1 bf16): out = registers a thread,
// local (spill) bytes, static shared bytes, max threads a block.  Returns
// the cudaError_t.
extern "C" int arcadia_ssd_scan_bwd_info(int launch, int headdim, int dstate, int dtype,
                                         int* out) {
  if (launch < 0 || launch > 6 || headdim <= 0 || headdim > kMaxP || dstate <= 0 ||
      dstate > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* f[7];
  if (dtype)
    kernels_for<bf16>(headdim, dstate, f);
  else
    kernels_for<float>(headdim, dstate, f);
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, f[launch]);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = fa.maxThreadsPerBlock;
  return 0;
}

// Gradient of the SSD scan.  xh and dy [batch, seqlen, heads, headdim], Bm
// and Cm [batch, seqlen, groups, dstate], read through strides[12] (xh:
// batch, token, head; Bm, Cm: batch, token, group; dy: batch, token, head;
// in elements, the last dimension contiguous); dt [batch, seqlen, heads]
// and A_log [heads] fp32 contiguous; d(final state) [batch, heads, headdim,
// dstate] fp32 contiguous or null.  dtype: 0 for fp32 xh/Bm/Cm/dy, 1 for
// bf16.  Outputs, contiguous: dxh (xh's shape and dtype), ddt (fp32, dt's),
// dA_log [heads] fp32, dBm and dCm ([batch, seqlen, groups, dstate], Bm's
// dtype).  `scratch` holds arcadia_ssd_scan_bwd_scratch_bytes bytes,
// 256-byte aligned.  headdim at most 128, dstate at most 256, chunk
// dividing seqlen, groups dividing heads.  Launches seven kernels on
// `stream`, does not synchronise, and returns the first cudaError_t (0 on
// success).
extern "C" int arcadia_ssd_scan_bwd(const void* xh, const void* dt, const void* A_log,
                                    const void* Bm, const void* Cm, const void* dy,
                                    const void* dstate, void* dxh, void* ddt, void* dA_log,
                                    void* dBm, void* dCm, void* scratch, int batch, int seqlen,
                                    int heads, int headdim, int groups, int dstate_dim, int chunk,
                                    int dtype, const long long* strides, void* stream) {
  Dims d;
  const int bad = check(batch, seqlen, heads, headdim, groups, dstate_dim, chunk, dtype, d);
  if (bad) return bad;
  if (reinterpret_cast<uintptr_t>(scratch) & (kAlign - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2],  strides[3],  strides[4],  strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xh, dt, A_log, Bm, Cm, dy, dstate, dxh, ddt, dA_log, dBm, dCm, scratch,
                         batch, d, st, s);
  return launch<bf16>(xh, dt, A_log, Bm, Cm, dy, dstate, dxh, ddt, dA_log, dBm, dCm, scratch,
                      batch, d, st, s);
}
