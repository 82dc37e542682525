// Backward of the Mamba2 SSD chunked scan on Hopper's tensor cores (sm_90a),
// bf16.
//
// The gradient of the scan of csrc/ssd_scan_tc.cu, whose TPU kernel is
// `_ssd_kernel` (src/repro/kernels/ssd_scan/ssd_scan.py); that Pallas kernel
// has no gradient (the JAX package trains through autodiff of its plain
// reference).  It computes the function of csrc/ssd_scan_bwd.cu and of the
// plain chunked backward, kernels/ssd_scan/ref.py::ssd_backward_reference —
// the contract at the top of ssd_scan_bwd.cu: per (batch b, head h), group g
// = h / (H/G), x~ = dt·x, cum the fp64 cumsum of a = -exp(A_log)·dt within a
// chunk of Q tokens, L_ij = exp(cum_i - cum_j) (j <= i), s = C·Bᵀ, r =
// dy·x~ᵀ, h0_c the state at chunk c's start and G_c the adjoint at its end:
//
//   dx~ = (L∘s)ᵀ dy + w·(G B),  w_j = exp(cum_Q - cum_j)
//   dB  = Σ_h [(L∘r)ᵀ C + w·(Gᵀ x~)],  dC = Σ_h [(L∘r) B + exp(cum)·(h0ᵀ dy)]
//   da  from the row and column sums of M = L∘s∘r below the diagonal, u, v
//       and exp(cum_Q)<G, h0>, then ddt and dA_log,
//
// for bf16 xh, Bm, Cm and dy with P and N multiples of 16 (P <= 128, N <=
// 256) and a chunk of 64·k tokens; kernels/ssd_scan/ref.py::
// ssd_backward_tc_reference is the same passes in plain PyTorch, rounding
// where this file rounds.  Outputs: dxh [B,S,H,P], dBm and dCm [B,S,G,N] in
// bf16, ddt [B,S,H] and dA_log [H] in fp32.
//
// What bounds it.  At mamba2-130m's training shape (B=8, S=4096, H=24, P=64,
// G=1, N=128, Q=256) the function needs, per (b, h, chunk), the causal
// pairs' dy·x~ᵀ and (L∘s)ᵀ·dy products, Q(Q+1)·2P operations, and five
// Q·N·P state products, 10·Q·N·P; and per (b, group, chunk) the causal
// pairs' C·Bᵀ, dB and dC products, Q(Q+1)·3N: 93 GFLOP, 0.094 ms on the
// tensor cores, against 0.34 GB read and written once, 0.10 ms at HBM's
// rate: bytes and operations bound it about equally.
//
// Design.  The products run on the tensor cores (mma.sync m16n8k16, bf16
// operands, fp32 sums; tiles by cp.async into two stages, shared rows
// padded by 16 bytes for ldmatrix), and the work is ordered so that no
// product is computed twice and no per-head partial of dB or dC is written:
//
//   1. chunk sums, grid (2·chunk, h, b): the chunk's state contribution
//      S_c = Σ_j x_j ⊗ bf16(B_j·dt_j·w_j) and adjoint contribution D_c =
//      Σ_i dy_i ⊗ bf16(C_i·exp(cum_i)), as the forward's first pass takes
//      S_c (the fp32 factor rounded once into the bf16 N-operand); cum by a
//      block-wide fp64 scan.
//   2. state passes, grid (b·h, P·N/1024): h0 forward and G backward over
//      the chunks in fp32, four elements a thread; h0 and G are written in
//      bf16 (they enter their products rounded once: at the card tests'
//      draws the CPU mirror is as close to float64 with one rounding as
//      with hi + lo splits, 1.6e-3 against 1.1e-3 of each gradient's
//      largest value, under the 5e-2 tolerance), and <G_c, h0_c> in fp64,
//      a fixed-order tree per block.
//   3. pairs, grid (pair (I, J) of 64-token tiles, chunk, b·g): C·Bᵀ is
//      computed once per (b, chunk, group) pair — here, before the block
//      walks the group's heads — and written in fp32 to a buffer
//      [B, G, S/Q, pairs, 64, 64] (21 MB at the training shape) that
//      launch 4 reads per head.  For each head in head order: r = dy·x~ᵀ
//      once per tile pair, L masked BEFORE the exp (a pair j > i takes 0
//      and never evaluates exp(cum_i - cum_j)), the fp32 sum over the heads
//      of W = L∘r (dB and dC need only that sum, since B and C belong to
//      the group: their quadratic products run once per group, not per
//      head), and M's row and column sums over the tile in fp64 (fixed
//      shuffles and a fixed-order cross-warp sum).  Both options for C·Bᵀ
//      are taken, each where it fits: the heads' sum of W must be taken
//      in head order, so one block walks the heads of a tile pair and
//      needs C·Bᵀ once; dx~ needs no r but L∘s of every row tile of its
//      column, per head, and a chunk's Q x Q weights do not fit in a block
//      (256 KB fp32 at Q = 256), so launch 4 runs per (head, column tile)
//      and reads C·Bᵀ from the buffer, which L2 holds.  W's sum is written
//      as bf16 hi = bf16(v) and lo = bf16(v - hi) tiles.
//   4. columns, grid (chunk·Q/64, h, b): dx~ of a 64-token column tile:
//      w·(G B) on the tensor cores (and v from it), then for each row tile
//      I >= J the A operand (L∘s)ᵀ from the buffer's C·Bᵀ, split into bf16
//      hi and lo, times dy_I; writes dxh = dt·dx~, <x, dx~> and v.
//   5. group, grid (2·chunk·Q/64, g, b): per 64-token tile, dB (or dC) in
//      one accumulator: the state term Σ_h w·dt·(x_h G_h) (Σ_h exp(cum)·(dy_h
//      h0_h)) walking the group's heads in order, the per-head factor applied
//      to the fp32 product's rows (never to a rounded x), then the
//      quadratic term from W's hi and lo tiles times C (B); u for the dC
//      tiles.  dB and dC are written once, in bf16.
//   6. finalize, grid (chunk, h, b): da by a reverse cumsum in fp64 of the
//      row minus column sums, plus the state terms as sums of their own
//      sign (v below t, <G, h0>), then ddt and the chunk's part of dA_log.
//   7. dA_log: the parts summed in fp64 in (batch, chunk) order.
// No atomics: every sum has a fixed order, so two calls give the same bits.
// Inputs as they come: xh, Bm, Cm and dy are read through their strides
// (batch, token, head or group; the last dimension contiguous), so the
// mixer's views go in without a copy; strides must be multiples of 8
// elements and pointers 16-byte aligned (the cp.async rule).
//
// Intermediates, at the training shape: S_c and D_c fp32 (2 × 100.7 MB,
// written by launch 1, read by 2), h0 and G bf16 (2 × 50.3 MB), C·Bᵀ fp32
// and W's hi and lo (21 + 2 × 10.5 MB, over the space of S_c and D_c), the
// row and column sums per tile (2 × 25.2 MB fp64), cum, u, v (fp64) and
// <x, dx~> (fp32) per token.
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
constexpr int kPad = 8;             // bf16 padding a shared row: 16 bytes
constexpr int kLdw = kTile + kPad;  // shared row of a 64-wide bf16 tile
constexpr int kSliceP = 32;         // p-rows of a head step in launch 5
constexpr int kLda = kSliceP + kPad;
constexpr int kPairThreads = 128;   // launch 3: 4 warps of 16 rows
constexpr int kColThreads = 128;    // launch 4
constexpr int kGroupThreads = 256;  // launch 5: 4 row groups x 2 n-halves
constexpr int kStateThreads = 256;  // launch 2
constexpr int kFinThreads = 256;    // launches 6 and 7
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kMaxSmem = 232448;    // 227 KB, H100
constexpr int kMaxGridYZ = 65535;
constexpr long long kAlign = 256;   // scratch regions

struct Dims {
  int S, H, P, G, N, Q, nc, rep, nt, npairs, slices;
};

// Element strides of xh (batch, token, head), Bm and Cm (batch, token,
// group) and dy (batch, token, head).
struct Strides {
  long long xb, xs, xh, bb, bs, bg, cb, cs, cg, yb, ys, yh;
};

// ---- shared memory of each launch, bytes (the wrapper's plan too) --------
__host__ __device__ inline long long sums_smem(int P, int N, int Q) {
  return 8LL * Q + 8LL * 16 + 4LL * Q + 2LL * 2 * kTile * ((P + kPad) + (N + kPad));
}
__host__ __device__ inline long long pairs_stage(int P) {
  return 2LL * kTile * 8 + 4LL * kTile + 2LL * 2 * kTile * (P + kPad);
}
__host__ __device__ inline long long pairs_smem(int P, int N) {
  return 2LL * 2 * kTile * (N + kPad) + 2 * pairs_stage(P) + 8LL * 4 * kTile;
}
__host__ __device__ inline long long cols_stage(int P) {
  const long long gb = 2LL * (P + kTile) * kLdw, pair = 2LL * kTile * (P + kPad);
  return gb > pair ? gb : pair;
}
__host__ __device__ inline long long cols_smem(int P, int Q) {
  return 8LL * Q + 2LL * kTile * (P + kPad) + 2 * cols_stage(P);
}
__host__ __device__ inline long long group_stage(int N) {
  const long long head = 8LL * kTile + 16 + 4LL * kTile + 2LL * kTile * kLda +
                         2LL * kSliceP * (N + kPad);
  const long long quad = 2LL * 2 * kTile * kLdw + 2LL * kTile * (N + kPad);
  return head > quad ? head : quad;
}
__host__ __device__ inline long long group_smem(int N) {
  return 2LL * kTile * (N + kPad) + 8LL * 2 * kTile + 2 * group_stage(N);
}
__host__ __device__ inline long long fin_smem(int Q) { return 3LL * 8 * Q; }

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
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
// d += a · b: a 16x16 (row), b 16x8 (col), bf16; d 16x8 fp32.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// exp(cum_i - cum_j): the fp64 difference rounded to fp32 once.
__device__ __forceinline__ float exp_diff(double cum_i, double cum_j) {
  return expf(static_cast<float>(cum_i - cum_j));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}
// An fp32 pair as bf16 hi = bf16(v) and lo = bf16(v - hi).
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}
__device__ __forceinline__ float bf(const bf16& v) { return __bfloat162float(v); }

// ldmatrix row addresses (ld = the shared row length in elements):
//   A 16x16 at (m0, k0) stored [m][k]: a_rows + ldsm_x4; stored [k][m]: a_cols + ldsm_x4_t
//   B 16(k) x 16(n) at (k0, n0) as two n8 fragments {r0, r1}, {r2, r3}:
//     stored [n][k]: b_rows + ldsm_x4;  stored [k][n]: b_cols + ldsm_x4_t
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

// cp.async of `rows` rows of `width` bf16 (a multiple of 8) from global rows
// `stride` elements apart into shared rows `ld` apart.
__device__ __forceinline__ void copy_rows(bf16* dst, int ld, const bf16* src, long long stride,
                                          int rows, int width) {
  const int pieces = width / 8;
  for (int e = threadIdx.x; e < rows * pieces; e += blockDim.x) {
    const int r = e / pieces, q = e - r * pieces;
    cp_async16(dst + r * ld + q * 8, src + r * stride + q * 8);
  }
}
// cp.async of n fp64 values (n even, both ends 16-byte aligned).
__device__ __forceinline__ void copy_f64(double* dst, const double* src, int n) {
  for (int e = threadIdx.x; e < n / 2; e += blockDim.x) cp_async16(dst + 2 * e, src + 2 * e);
}

// In-place inclusive prefix sum of v[0..n) in fp64 by the whole block
// (csrc/ssd_scan_tc.cu's): runs per thread, then warp shuffles, then the
// warps' totals (`warp_sums`, 16) in order.
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
// Block (2c + which, h, b), N/16 warps, warp w the rows n = 16w.. of the
// transposed sum: which 0 gives S_cᵀ[n, p] = Σ_j bf16(B_j[n]·dt_j·w_j) x_j[p],
// which 1 gives D_cᵀ[n, p] = Σ_i bf16(C_i[n]·exp(cum_i)) dy_i[p]; stored
// [P][N] fp32.  kPT: P rounded up to 32, 64 or 128.
template <int kPT>
__global__ void __launch_bounds__(2 * kMaxN)
bwd_tc_chunk_sums(const bf16* __restrict__ xh, const float* __restrict__ dt,
                  const float* __restrict__ A_log, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                  float* __restrict__ hsum, float* __restrict__ gsum, double* __restrict__ cum_out,
                  Dims d, Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = d.P, N = d.N, Q = d.Q;
  const int ldx = P + kPad, ldb = N + kPad;
  double* cum = reinterpret_cast<double*>(smem);
  double* warp_sums = cum + Q;
  float* w = reinterpret_cast<float*>(warp_sums + 16);
  bf16* const xs = reinterpret_cast<bf16*>(w + Q);   // stage s at xs + s·kTile·ldx
  bf16* const bs = xs + 2 * kTile * ldx;              // stage s at bs + s·kTile·ldb

  const int which = blockIdx.x & 1, c = blockIdx.x >> 1, hh = blockIdx.y, b = blockIdx.z;
  const int g = hh / d.rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = static_cast<long long>(c) * Q;
  const bf16* xbase = which ? dy + b * st.yb + t0 * st.ys + hh * st.yh
                            : xh + b * st.xb + t0 * st.xs + hh * st.xh;
  const long long xstr = which ? st.ys : st.xs;
  const bf16* bbase = which ? Cm + b * st.cb + t0 * st.cs + g * st.cg
                            : Bm + b * st.bb + t0 * st.bs + g * st.bg;
  const long long bstr = which ? st.cs : st.bs;
  const int nk = Q / kTile;

  copy_rows(xs, ldx, xbase, xstr, kTile, P);    // tile 0 flies during the scan
  copy_rows(bs, ldb, bbase, bstr, kTile, N);
  cp_async_commit();

  const float A = -expf(A_log[hh]);
  const float* dtb = dt + (static_cast<long long>(b) * d.S + t0) * d.H + hh;
  for (int i = tid; i < Q; i += blockDim.x)
    cum[i] = static_cast<double>(A) * static_cast<double>(dtb[static_cast<long long>(i) * d.H]);
  __syncthreads();
  block_inclusive_scan(cum, Q, warp_sums);
  const double total = cum[Q - 1];
  double* cum_g = cum_out + (static_cast<long long>(b) * d.H + hh) * d.S + t0;
  for (int i = tid; i < Q; i += blockDim.x) {
    if (!which) cum_g[i] = cum[i];
    w[i] = which ? expf(static_cast<float>(cum[i]))
                 : dtb[static_cast<long long>(i) * d.H] * exp_diff(total, cum[i]);
  }

  float acc[kPT / 8][4];
#pragma unroll
  for (int nt = 0; nt < kPT / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int m0 = warp * 16;

  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    bf16* const xt = xs + stage * kTile * ldx;
    bf16* const bt = bs + stage * kTile * ldb;
    if (kt + 1 < nk) {
      copy_rows(xs + (stage ^ 1) * kTile * ldx, ldx, xbase + (kt + 1) * kTile * xstr, xstr, kTile,
                P);
      copy_rows(bs + (stage ^ 1) * kTile * ldb, ldb, bbase + (kt + 1) * kTile * bstr, bstr, kTile,
                N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // the N-operand times its token's fp32 factor, rounded once
    const int half_n = N / 2;
    for (int e = tid; e < kTile * half_n; e += blockDim.x) {
      const int r = e / half_n, q = e - r * half_n;
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(bt + r * ldb) + q;
      const float s = w[kt * kTile + r];
      const float2 f = __bfloat1622float2(*p2);
      *p2 = __floats2bfloat162_rn(f.x * s, f.y * s);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4_t(a, a_cols(bt, ldb, m0, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < kPT / 16; ++np) {
        if (np * 16 < P) {
          uint32_t f[4];
          ldsm_x4_t(f, b_cols(xt, ldx, kk * 16, np * 16, lane));
          mma16816(acc[2 * np], a, f[0], f[1]);
          mma16816(acc[2 * np + 1], a, f[2], f[3]);
        }
      }
    }
    __syncthreads();                       // the stage is free for tile kt + 2
  }

  float* out = (which ? gsum : hsum) +
               ((static_cast<long long>(b) * d.H + hh) * d.nc + c) * static_cast<long long>(P) * N;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kPT / 8; ++nt) {
    if (nt * 8 < P) {
      const long long p = nt * 8 + 2 * tq, n = m0 + gq;
      out[p * N + n] = acc[nt][0];
      out[(p + 1) * N + n] = acc[nt][1];
      out[p * N + n + 8] = acc[nt][2];
      out[(p + 1) * N + n + 8] = acc[nt][3];
    }
  }
}

// --------------------------- 2. state passes -------------------------------
// Block (b·h, slice), four (p, n) elements a thread.  h0 forward over the
// chunks (fp32, written back over S_c and in bf16 to h0b), G backward from
// d(state) (bf16 to gb), and per chunk the block's part of <G, h0> in fp64.
__global__ void __launch_bounds__(kStateThreads)
bwd_tc_state_passes(float* __restrict__ hsum, const float* __restrict__ gsum,
                    const double* __restrict__ cum, const float* __restrict__ dstate,
                    bf16* __restrict__ h0b, bf16* __restrict__ gb, double* __restrict__ c0_part,
                    Dims d) {
  __shared__ double red[kStateThreads];
  const long long PN = static_cast<long long>(d.P) * d.N;
  const long long e = (static_cast<long long>(blockIdx.y) * kStateThreads + threadIdx.x) * 4;
  const bool on = e < PN;
  const long long bh = blockIdx.x;
  const double* last = cum + bh * d.S + d.Q - 1;       // cum_Q of chunk 0
  const long long base = bh * d.nc * PN + e;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < d.nc && on; ++c) {
    float4* at = reinterpret_cast<float4*>(hsum + base + c * PN);
    const float4 s = *at;
    *at = h;
    uint2 packed;
    packed.x = pack_bf16(h.x, h.y);
    packed.y = pack_bf16(h.z, h.w);
    *reinterpret_cast<uint2*>(h0b + base + c * PN) = packed;
    const float decay = expf(static_cast<float>(last[static_cast<long long>(c) * d.Q]));
    h.x = fmaf(decay, h.x, s.x);
    h.y = fmaf(decay, h.y, s.y);
    h.z = fmaf(decay, h.z, s.z);
    h.w = fmaf(decay, h.w, s.w);
  }
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (on && dstate) g = *reinterpret_cast<const float4*>(dstate + bh * PN + e);
  for (int c = d.nc - 1; c >= 0; --c) {
    double part = 0.0;
    if (on) {
      uint2 packed;
      packed.x = pack_bf16(g.x, g.y);
      packed.y = pack_bf16(g.z, g.w);
      *reinterpret_cast<uint2*>(gb + base + c * PN) = packed;
      const float4 h0 = *reinterpret_cast<const float4*>(hsum + base + c * PN);
      part = static_cast<double>(h0.x) * g.x + static_cast<double>(h0.y) * g.y +
             static_cast<double>(h0.z) * g.z + static_cast<double>(h0.w) * g.w;
      const float4 s = *reinterpret_cast<const float4*>(gsum + base + c * PN);
      const float decay = expf(static_cast<float>(last[static_cast<long long>(c) * d.Q]));
      g.x = fmaf(decay, g.x, s.x);
      g.y = fmaf(decay, g.y, s.y);
      g.z = fmaf(decay, g.z, s.z);
      g.w = fmaf(decay, g.w, s.w);
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
// of column tile J and all 64 columns i of row tile I, transposed ([j][i]).
// One stage: cum of tiles J and I, dt of J, x_J and dy_I of one head.
__device__ __forceinline__ void pairs_issue(unsigned char* stage, int P, const bf16* xh,
                                            const bf16* dy, const float* dt, const double* cum_g,
                                            const Dims& d, const Strides& st, int b, int hh,
                                            long long t0, int jt0, int it0) {
  const int ldx = P + kPad;
  double* cj = reinterpret_cast<double*>(stage);
  double* ci = cj + kTile;
  float* dtj = reinterpret_cast<float*>(ci + kTile);
  bf16* xs = reinterpret_cast<bf16*>(dtj + kTile);
  bf16* ys = xs + kTile * ldx;
  copy_rows(xs, ldx, xh + b * st.xb + (t0 + jt0) * st.xs + hh * st.xh, st.xs, kTile, P);
  copy_rows(ys, ldx, dy + b * st.yb + (t0 + it0) * st.ys + hh * st.yh, st.ys, kTile, P);
  const double* cb = cum_g + (static_cast<long long>(b) * d.H + hh) * d.S + t0;
  copy_f64(cj, cb + jt0, kTile);
  copy_f64(ci, cb + it0, kTile);
  for (int r = threadIdx.x; r < kTile; r += blockDim.x)
    dtj[r] = dt[(static_cast<long long>(b) * d.S + t0 + jt0 + r) * d.H + hh];
}

__global__ void __launch_bounds__(kPairThreads)
bwd_tc_pairs(const bf16* __restrict__ xh, const float* __restrict__ dt,
             const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
             const bf16* __restrict__ dy, const double* __restrict__ cum_g,
             float* __restrict__ s_buf, bf16* __restrict__ w2_hi, bf16* __restrict__ w2_lo,
             double* __restrict__ row_part, double* __restrict__ col_part, Dims d, Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = d.P, N = d.N, Q = d.Q;
  const int ldn = N + kPad, ldx = P + kPad;
  bf16* bt = reinterpret_cast<bf16*>(smem);            // [64][ldn] B_J
  bf16* ct = bt + kTile * ldn;                          // [64][ldn] C_I
  unsigned char* ring = reinterpret_cast<unsigned char*>(ct + kTile * ldn);
  const long long sb = pairs_stage(P);
  double* red = reinterpret_cast<double*>(ring + 2 * sb);   // [4][64] row sums

  const int pair = blockIdx.x, c = blockIdx.y, bg = blockIdx.z;
  const int b = bg / d.G, g = bg - b * d.G;
  int I = 0;
  while (pair_index(I + 1, 0) <= pair) ++I;
  const int J = pair - pair_index(I, 0);
  const bool diag = I == J;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const long long t0 = static_cast<long long>(c) * Q;
  const int jt0 = J * kTile, it0 = I * kTile;
  copy_rows(bt, ldn, Bm + b * st.bb + (t0 + jt0) * st.bs + g * st.bg, st.bs, kTile, N);
  copy_rows(ct, ldn, Cm + b * st.cb + (t0 + it0) * st.cs + g * st.cg, st.cs, kTile, N);
  cp_async_commit();
  const int hfirst = g * d.rep;
  pairs_issue(ring, P, xh, dy, dt, cum_g, d, st, b, hfirst, t0, jt0, it0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // C·Bᵀ of the pair, once for the group: s[j][i] = B_j · C_i
  const int m0 = warp * 16;
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_rows(bt, ldn, m0, kk * 16, lane));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t f[4];
      ldsm_x4(f, b_rows(ct, ldn, kk * 16, np * 16, lane));
      mma16816(s[2 * np], a, f[0], f[1]);
      mma16816(s[2 * np + 1], a, f[2], f[3]);
    }
  }
  const long long tile = ((static_cast<long long>(bg) * d.nc + c) * d.npairs + pair) * kTile * kTile;
  const int ja = m0 + gq, jb = ja + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int i = nt * 8 + 2 * tq;
    *reinterpret_cast<float2*>(s_buf + tile + ja * kTile + i) = make_float2(s[nt][0], s[nt][1]);
    *reinterpret_cast<float2*>(s_buf + tile + jb * kTile + i) = make_float2(s[nt][2], s[nt][3]);
  }

  float w2[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) w2[nt][0] = w2[nt][1] = w2[nt][2] = w2[nt][3] = 0.f;
  for (int k = 0; k < d.rep; ++k) {
    const int hh = hfirst + k;
    if (k + 1 < d.rep) {
      pairs_issue(ring + ((k + 1) & 1) * sb, P, xh, dy, dt, cum_g, d, st, b, hh + 1, t0, jt0, it0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* stg = ring + (k & 1) * sb;
    const double* cj = reinterpret_cast<const double*>(stg);
    const double* ci = cj + kTile;
    const float* dtj = reinterpret_cast<const float*>(ci + kTile);
    const bf16* xs = reinterpret_cast<const bf16*>(dtj + kTile);
    const bf16* ys = xs + kTile * ldx;

    // dy·x~ᵀ of the pair, once per head: r[j][i] = dt_j (x_j · dy_i)
    float r[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) r[nt][0] = r[nt][1] = r[nt][2] = r[nt][3] = 0.f;
    for (int kk = 0; kk < P / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, a_rows(xs, ldx, m0, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t f[4];
        ldsm_x4(f, b_rows(ys, ldx, kk * 16, np * 16, lane));
        mma16816(r[2 * np], a, f[0], f[1]);
        mma16816(r[2 * np + 1], a, f[2], f[3]);
      }
    }
    const double cja = cj[ja], cjb = cj[jb];
    const float dta = dtj[ja], dtb = dtj[jb];
    double col_a = 0.0, col_b = 0.0;   // Σ_i M over this lane's columns, rows ja and jb
    double rowp[8][2];                 // Σ over rows ja, jb of M, per column
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = nt * 8 + 2 * tq + q;
        const double cii = ci[i];
        const float ra = r[nt][q] * dta, rb = r[nt][2 + q] * dtb;
        const float La = (!diag || ja <= i) ? exp_diff(cii, cja) : 0.f;   // mask before exp
        const float Lb = (!diag || jb <= i) ? exp_diff(cii, cjb) : 0.f;
        w2[nt][q] += La * ra;
        w2[nt][2 + q] += Lb * rb;
        const double ma = (!diag || ja < i) ? static_cast<double>((La * s[nt][q]) * ra) : 0.0;
        const double mb = (!diag || jb < i) ? static_cast<double>((Lb * s[nt][2 + q]) * rb) : 0.0;
        col_a += ma;
        col_b += mb;
        rowp[nt][q] = ma + mb;
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
      col_part[(tok + jt0 + ja) * d.nt + I] = col_a;
      col_part[(tok + jt0 + jb) * d.nt + I] = col_b;
    }
    // row sums of M (over j) per column i: across the 8 row lanes, then warps
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        double v = rowp[nt][q];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (gq == 0) red[warp * kTile + nt * 8 + 2 * tq + q] = v;
      }
    }
    __syncthreads();                       // red written; the stage is free
    if (tid < kTile)
      row_part[(tok + it0 + tid) * d.nt + J] =
          ((red[tid] + red[kTile + tid]) + red[2 * kTile + tid]) + red[3 * kTile + tid];
  }

  // the heads' sum of L∘r as bf16 hi and lo tiles [j][i]
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int i = nt * 8 + 2 * tq;
    uint32_t hi, lo;
    split_bf16(w2[nt][0], w2[nt][1], hi, lo);
    *reinterpret_cast<uint32_t*>(w2_hi + tile + ja * kTile + i) = hi;
    *reinterpret_cast<uint32_t*>(w2_lo + tile + ja * kTile + i) = lo;
    split_bf16(w2[nt][2], w2[nt][3], hi, lo);
    *reinterpret_cast<uint32_t*>(w2_hi + tile + jb * kTile + i) = hi;
    *reinterpret_cast<uint32_t*>(w2_lo + tile + jb * kTile + i) = lo;
  }
}

// ----------------------------- 4. columns ---------------------------------
// Block (c·nt + J, h, b), 4 warps; warp w holds rows j = 16w.. of column tile
// J and the P columns of dx~.  Steps: the N/64 slices of G·B_J (G [p][n] and
// B_J rows), then the row tiles I >= J (dy_I).
template <int kPT>
__global__ void __launch_bounds__(kColThreads)
bwd_tc_columns(const bf16* __restrict__ xh, const float* __restrict__ dt,
               const bf16* __restrict__ Bm, const bf16* __restrict__ dy,
               const double* __restrict__ cum_g, const bf16* __restrict__ gb,
               const float* __restrict__ s_buf, bf16* __restrict__ dxh,
               float* __restrict__ xdx_out, double* __restrict__ v_out, Dims d, Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = d.P, N = d.N, Q = d.Q;
  const int ldx = P + kPad;
  double* cum = reinterpret_cast<double*>(smem);             // [Q]
  bf16* xj = reinterpret_cast<bf16*>(cum + Q);                // [64][ldx] x_J
  unsigned char* ring = reinterpret_cast<unsigned char*>(xj + kTile * ldx);
  const long long sb = cols_stage(P);

  const int c = blockIdx.x / d.nt, J = blockIdx.x - c * d.nt;
  const int hh = blockIdx.y, b = blockIdx.z, g = hh / d.rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const long long t0 = static_cast<long long>(c) * Q;
  const int jt0 = J * kTile;
  const long long bh = static_cast<long long>(b) * d.H + hh;
  const bf16* gsrc = gb + (bh * d.nc + c) * static_cast<long long>(P) * N;
  const bf16* bsrc = Bm + b * st.bb + (t0 + jt0) * st.bs + g * st.bg;
  const int nsl = (N + kTile - 1) / kTile;
  const int steps = nsl + d.nt - J;
  auto issue = [&](int step, unsigned char* stage) {
    bf16* s0 = reinterpret_cast<bf16*>(stage);
    if (step < nsl) {                                   // G[:, slice] and B_J[:, slice]
      const int n0 = step * kTile, wdt = min(kTile, N - n0);
      copy_rows(s0, kLdw, gsrc + n0, N, P, wdt);
      copy_rows(s0 + P * kLdw, kLdw, bsrc + n0, st.bs, kTile, wdt);
    } else {                                            // dy of row tile I
      const int I = J + step - nsl;
      copy_rows(s0, ldx, dy + b * st.yb + (t0 + I * kTile) * st.ys + hh * st.yh, st.ys, kTile, P);
    }
  };
  copy_f64(cum, cum_g + bh * d.S + t0, Q);
  copy_rows(xj, ldx, xh + b * st.xb + (t0 + jt0) * st.xs + hh * st.xh, st.xs, kTile, P);
  issue(0, ring);
  cp_async_commit();

  const int m0 = warp * 16, ja = m0 + gq, jb = ja + 8;
  float acc[kPT / 8][4];
#pragma unroll
  for (int nt = 0; nt < kPT / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const long long stile = ((static_cast<long long>(b) * d.G + g) * d.nc + c) * d.npairs;
  for (int k = 0; k < steps; ++k) {
    // the pair's C·Bᵀ, rows ja, jb, from the group's buffer (in flight during the wait)
    float2 sa[4][2], sbv[4][2];
    const bool pair_step = k >= nsl;
    const int I = J + k - nsl;
    if (pair_step) {
      const float* sp = s_buf + (stile + pair_index(I, J)) * kTile * kTile;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = kk * 16 + q * 8 + 2 * tq;
          sa[kk][q] = *reinterpret_cast<const float2*>(sp + ja * kTile + i);
          sbv[kk][q] = *reinterpret_cast<const float2*>(sp + jb * kTile + i);
        }
    }
    if (k + 1 < steps) {
      issue(k + 1, ring + ((k + 1) & 1) * sb);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* s0 = reinterpret_cast<const bf16*>(ring + (k & 1) * sb);
    if (!pair_step) {
      // G·B_J over this slice of n: A = B_J [j][n], B = G stored [p][n]
      const int wdt = min(kTile, N - k * kTile);
      const bf16* bs = s0 + P * kLdw;
      for (int kk = 0; kk < wdt / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, a_rows(bs, kLdw, m0, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < kPT / 16; ++np) {
          if (np * 16 < P) {
            uint32_t f[4];
            ldsm_x4(f, b_rows(s0, kLdw, kk * 16, np * 16, lane));
            mma16816(acc[2 * np], a, f[0], f[1]);
            mma16816(acc[2 * np + 1], a, f[2], f[3]);
          }
        }
      }
      if (k == nsl - 1) {
        // v_j = w_j Σ_p x~_j[p] (G B_j)[p], then acc = w_j (G B_j)
        const double total = cum[Q - 1];
        const float wa = exp_diff(total, cum[jt0 + ja]), wb = exp_diff(total, cum[jt0 + jb]);
        const float* dtr = dt + (static_cast<long long>(b) * d.S + t0 + jt0) * d.H + hh;
        const float dta = dtr[static_cast<long long>(ja) * d.H];
        const float dtb = dtr[static_cast<long long>(jb) * d.H];
        double va = 0.0, vb = 0.0;
#pragma unroll
        for (int nt = 0; nt < kPT / 8; ++nt) {
          if (nt * 8 < P) {
            const int p = nt * 8 + 2 * tq;
            va += static_cast<double>((bf(xj[ja * ldx + p]) * dta) * acc[nt][0]);
            va += static_cast<double>((bf(xj[ja * ldx + p + 1]) * dta) * acc[nt][1]);
            vb += static_cast<double>((bf(xj[jb * ldx + p]) * dtb) * acc[nt][2]);
            vb += static_cast<double>((bf(xj[jb * ldx + p + 1]) * dtb) * acc[nt][3]);
            acc[nt][0] *= wa;
            acc[nt][1] *= wa;
            acc[nt][2] *= wb;
            acc[nt][3] *= wb;
          }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          va += __shfl_xor_sync(0xffffffffu, va, o);
          vb += __shfl_xor_sync(0xffffffffu, vb, o);
        }
        if (tq == 0) {
          v_out[bh * d.S + t0 + jt0 + ja] = static_cast<double>(wa) * va;
          v_out[bh * d.S + t0 + jt0 + jb] = static_cast<double>(wb) * vb;
        }
      }
    } else {
      // dx~_J += (L∘s)ᵀ dy_I: A = W[j][i] split hi + lo, B = dy_I stored [i][p]
      const bool diag = I == J;
      const int it0 = I * kTile;
      const double cja = cum[jt0 + ja], cjb = cum[jt0 + jb];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4], pl[4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = kk * 16 + q * 8 + 2 * tq;
          const double c0 = cum[it0 + i], c1 = cum[it0 + i + 1];
          const float a0 = (!diag || ja <= i) ? exp_diff(c0, cja) * sa[kk][q].x : 0.f;
          const float a1 = (!diag || ja <= i + 1) ? exp_diff(c1, cja) * sa[kk][q].y : 0.f;
          const float b0 = (!diag || jb <= i) ? exp_diff(c0, cjb) * sbv[kk][q].x : 0.f;
          const float b1 = (!diag || jb <= i + 1) ? exp_diff(c1, cjb) * sbv[kk][q].y : 0.f;
          split_bf16(a0, a1, pa[2 * q], pl[2 * q]);
          split_bf16(b0, b1, pa[2 * q + 1], pl[2 * q + 1]);
        }
#pragma unroll
        for (int np = 0; np < kPT / 16; ++np) {
          if (np * 16 < P) {
            uint32_t f[4];
            ldsm_x4_t(f, b_cols(s0, ldx, kk * 16, np * 16, lane));
            mma16816(acc[2 * np], pa, f[0], f[1]);
            mma16816(acc[2 * np + 1], pa, f[2], f[3]);
            mma16816(acc[2 * np], pl, f[0], f[1]);
            mma16816(acc[2 * np + 1], pl, f[2], f[3]);
          }
        }
      }
    }
    __syncthreads();                       // every warp is done with the stage
  }

  // dxh = dt·dx~ (contiguous [B,S,H,P]) and <x, dx~>
  const float* dtr = dt + (static_cast<long long>(b) * d.S + t0 + jt0) * d.H + hh;
  const float dta = dtr[static_cast<long long>(ja) * d.H], dtb = dtr[static_cast<long long>(jb) * d.H];
  const long long ytok = static_cast<long long>(d.H) * P;
  bf16* ya = dxh + (static_cast<long long>(b) * d.S + t0 + jt0 + ja) * ytok + static_cast<long long>(hh) * P;
  bf16* yb = ya + 8 * ytok;
  float xa = 0.f, xb = 0.f;
#pragma unroll
  for (int nt = 0; nt < kPT / 8; ++nt) {
    if (nt * 8 < P) {
      const int p = nt * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(ya + p) = pack_bf16(dta * acc[nt][0], dta * acc[nt][1]);
      *reinterpret_cast<uint32_t*>(yb + p) = pack_bf16(dtb * acc[nt][2], dtb * acc[nt][3]);
      xa = fmaf(bf(xj[ja * ldx + p]), acc[nt][0], xa);
      xa = fmaf(bf(xj[ja * ldx + p + 1]), acc[nt][1], xa);
      xb = fmaf(bf(xj[jb * ldx + p]), acc[nt][2], xb);
      xb = fmaf(bf(xj[jb * ldx + p + 1]), acc[nt][3], xb);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    xa += __shfl_xor_sync(0xffffffffu, xa, o);
    xb += __shfl_xor_sync(0xffffffffu, xb, o);
  }
  if (tq == 0) {
    xdx_out[bh * d.S + t0 + jt0 + ja] = xa;
    xdx_out[bh * d.S + t0 + jt0 + jb] = xb;
  }
}

// ------------------------------ 5. group ----------------------------------
// Block ((c·nt + T)·2 + which, g, b), 8 warps: warp w holds rows t = 16(w &
// 3).. of tile T and the 16-column units u ≡ (w >> 2) (mod 2) of N.  which 0
// gives dB_T, which 1 dC_T.  Steps: for each head of the group in order,
// P/32 slices of the product x_T·G (dy_T·h0) — x or dy [t][p] times G or h0
// stored [p][n] — whose rows take the head's factor at its last slice;
// then the quadratic term, one step per pair: W's hi and lo tiles and C_I
// (B_J) rows.  kNT: N rounded up to 64, 128 or 256.
template <int kNT>
__global__ void __launch_bounds__(kGroupThreads)
bwd_tc_group(const bf16* __restrict__ xh, const float* __restrict__ dt,
             const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
             const bf16* __restrict__ dy, const double* __restrict__ cum_g,
             const bf16* __restrict__ h0b, const bf16* __restrict__ gb,
             const bf16* __restrict__ w2_hi, const bf16* __restrict__ w2_lo,
             bf16* __restrict__ dBm, bf16* __restrict__ dCm, double* __restrict__ u_out, Dims d,
             Strides st) {
  constexpr int kU = kNT / 32;                          // units a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = d.P, N = d.N, Q = d.Q;
  const int ldn = N + kPad;
  bf16* ctile = reinterpret_cast<bf16*>(smem);          // [64][ldn] C_T (dC: u)
  double* red = reinterpret_cast<double*>(ctile + kTile * ldn);   // [2][64]
  unsigned char* ring = reinterpret_cast<unsigned char*>(red + 2 * kTile);
  const long long sb = group_stage(N);

  const int which = blockIdx.x & 1, ct = blockIdx.x >> 1;
  const int c = ct / d.nt, T = ct - c * d.nt;
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const int m0 = (warp & 3) * 16, nh = warp >> 2;
  const long long t0 = static_cast<long long>(c) * Q;
  const int tt0 = T * kTile;
  const int nsp = (P + kSliceP - 1) / kSliceP;
  const int head_steps = d.rep * nsp;
  const int quad_steps = which ? T + 1 : d.nt - T;
  const int steps = head_steps + quad_steps;
  const long long ptile = (static_cast<long long>(b) * d.G + g) * d.nc + c;

  auto issue = [&](int step, unsigned char* stage) {
    if (step < head_steps) {
      const int hk = step / nsp, sl = step - hk * nsp, hh = g * d.rep + hk;
      const int p0 = sl * kSliceP, wdt = min(kSliceP, P - p0);
      double* cumt = reinterpret_cast<double*>(stage);  // [64] + cum_Q pair
      float* dtt = reinterpret_cast<float*>(cumt + kTile + 2);
      bf16* as = reinterpret_cast<bf16*>(dtt + kTile);
      bf16* bs = as + kTile * kLda;
      const bf16* asrc = which ? dy + b * st.yb + (t0 + tt0) * st.ys + hh * st.yh
                               : xh + b * st.xb + (t0 + tt0) * st.xs + hh * st.xh;
      copy_rows(as, kLda, asrc + p0, which ? st.ys : st.xs, kTile, wdt);
      const bf16* bsrc = (which ? h0b : gb) +
                         ((static_cast<long long>(b) * d.H + hh) * d.nc + c) * static_cast<long long>(P) * N;
      copy_rows(bs, ldn, bsrc + static_cast<long long>(p0) * N, N, wdt, N);
      if (sl == nsp - 1) {
        const double* cb = cum_g + (static_cast<long long>(b) * d.H + hh) * d.S + t0;
        copy_f64(cumt, cb + tt0, kTile);
        copy_f64(cumt + kTile, cb + Q - 2, 2);
        for (int r = threadIdx.x; r < kTile; r += blockDim.x)
          dtt[r] = dt[(static_cast<long long>(b) * d.S + t0 + tt0 + r) * d.H + hh];
      }
    } else {
      const int q = step - head_steps;
      const int I = which ? T : T + q, J = which ? q : T;
      const long long tile = (ptile * d.npairs + pair_index(I, J)) * kTile * kTile;
      bf16* wh = reinterpret_cast<bf16*>(stage);
      bf16* wl = wh + kTile * kLdw;
      bf16* zs = wl + kTile * kLdw;
      copy_rows(wh, kLdw, w2_hi + tile, kTile, kTile, kTile);
      copy_rows(wl, kLdw, w2_lo + tile, kTile, kTile, kTile);
      const bf16* zsrc = which ? Bm + b * st.bb + (t0 + J * kTile) * st.bs + g * st.bg
                               : Cm + b * st.cb + (t0 + I * kTile) * st.cs + g * st.cg;
      copy_rows(zs, ldn, zsrc, which ? st.bs : st.cs, kTile, N);
    }
  };
  if (which)
    copy_rows(ctile, ldn, Cm + b * st.cb + (t0 + tt0) * st.cs + g * st.cg, st.cs, kTile, N);
  issue(0, ring);
  cp_async_commit();

  float acc[2 * kU][4], tmp[2 * kU][4];
#pragma unroll
  for (int f = 0; f < 2 * kU; ++f)
    acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = tmp[f][0] = tmp[f][1] = tmp[f][2] =
        tmp[f][3] = 0.f;
  const int ta = m0 + gq, tb = ta + 8;
  for (int k = 0; k < steps; ++k) {
    if (k + 1 < steps) {
      issue(k + 1, ring + ((k + 1) & 1) * sb);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unsigned char* stage = ring + (k & 1) * sb;
    bool u_ready = false;
    float eu = 0.f;                        // exp(cum_t) of row tid, for u
    if (k < head_steps) {
      const int sl = k % nsp, p0 = sl * kSliceP, wdt = min(kSliceP, P - p0);
      const double* cumt = reinterpret_cast<const double*>(stage);
      const float* dtt = reinterpret_cast<const float*>(cumt + kTile + 2);
      const bf16* as = reinterpret_cast<const bf16*>(dtt + kTile);
      const bf16* bs = as + kTile * kLda;
      for (int kk = 0; kk < wdt / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, a_rows(as, kLda, m0, kk * 16, lane));
#pragma unroll
        for (int ui = 0; ui < kU; ++ui) {
          const int u = 2 * ui + nh;
          if (u * 16 < N) {
            uint32_t f[4];
            ldsm_x4_t(f, b_cols(bs, ldn, kk * 16, u * 16, lane));
            mma16816(tmp[2 * ui], a, f[0], f[1]);
            mma16816(tmp[2 * ui + 1], a, f[2], f[3]);
          }
        }
      }
      if (sl == nsp - 1) {
        // the head's factor on the rows: w·dt (dB) or exp(cum) (dC)
        float fa, fb;
        if (which) {
          fa = expf(static_cast<float>(cumt[ta]));
          fb = expf(static_cast<float>(cumt[tb]));
          // u_t = exp(cum_t) Σ_n C_t[n] (h0ᵀ dy_t)[n], fp64 over fp32 products
          double pa = 0.0, pb = 0.0;
#pragma unroll
          for (int ui = 0; ui < kU; ++ui) {
            const int u = 2 * ui + nh;
            if (u * 16 < N) {
#pragma unroll
              for (int h8 = 0; h8 < 2; ++h8) {
                const int n = u * 16 + h8 * 8 + 2 * tq;
                const float* t4 = tmp[2 * ui + h8];
                pa += static_cast<double>(bf(ctile[ta * ldn + n]) * t4[0]);
                pa += static_cast<double>(bf(ctile[ta * ldn + n + 1]) * t4[1]);
                pb += static_cast<double>(bf(ctile[tb * ldn + n]) * t4[2]);
                pb += static_cast<double>(bf(ctile[tb * ldn + n + 1]) * t4[3]);
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
          if (tid < kTile) eu = expf(static_cast<float>(cumt[tid]));
          u_ready = true;
        } else {
          const double cq = cumt[kTile + 1];
          fa = dtt[ta] * exp_diff(cq, cumt[ta]);
          fb = dtt[tb] * exp_diff(cq, cumt[tb]);
        }
#pragma unroll
        for (int f = 0; f < 2 * kU; ++f) {
          acc[f][0] = fmaf(fa, tmp[f][0], acc[f][0]);
          acc[f][1] = fmaf(fa, tmp[f][1], acc[f][1]);
          acc[f][2] = fmaf(fb, tmp[f][2], acc[f][2]);
          acc[f][3] = fmaf(fb, tmp[f][3], acc[f][3]);
          tmp[f][0] = tmp[f][1] = tmp[f][2] = tmp[f][3] = 0.f;
        }
      }
    } else {
      // dB_T += Wsumᵀ C_I (W stored [j = t][i]: a_rows); dC_T += Wsum B_J
      // (W stored [j][i = t]: a_cols, transposed); Z rows [k][n]
      const bf16* wh = reinterpret_cast<const bf16*>(stage);
      const bf16* wl = wh + kTile * kLdw;
      const bf16* zs = wl + kTile * kLdw;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t ah[4], al[4];
        if (which) {
          ldsm_x4_t(ah, a_cols(wh, kLdw, m0, kk * 16, lane));
          ldsm_x4_t(al, a_cols(wl, kLdw, m0, kk * 16, lane));
        } else {
          ldsm_x4(ah, a_rows(wh, kLdw, m0, kk * 16, lane));
          ldsm_x4(al, a_rows(wl, kLdw, m0, kk * 16, lane));
        }
#pragma unroll
        for (int ui = 0; ui < kU; ++ui) {
          const int u = 2 * ui + nh;
          if (u * 16 < N) {
            uint32_t f[4];
            ldsm_x4_t(f, b_cols(zs, ldn, kk * 16, u * 16, lane));
            mma16816(acc[2 * ui], ah, f[0], f[1]);
            mma16816(acc[2 * ui + 1], ah, f[2], f[3]);
            mma16816(acc[2 * ui], al, f[0], f[1]);
            mma16816(acc[2 * ui + 1], al, f[2], f[3]);
          }
        }
      }
    }
    __syncthreads();                       // the stage is free; red is written
    if (u_ready && tid < kTile) {          // red is rewritten nsp >= 1 steps later
      const int hh = g * d.rep + k / nsp;
      u_out[(static_cast<long long>(b) * d.H + hh) * d.S + t0 + tt0 + tid] =
          static_cast<double>(eu) * (red[tid] + red[kTile + tid]);
    }
  }

  bf16* out = which ? dCm : dBm;
  const long long orow = static_cast<long long>(d.G) * N;
  bf16* oa = out + (static_cast<long long>(b) * d.S + t0 + tt0 + ta) * orow + static_cast<long long>(g) * N;
  bf16* ob = oa + 8 * orow;
#pragma unroll
  for (int ui = 0; ui < kU; ++ui) {
    const int u = 2 * ui + nh;
    if (u * 16 < N) {
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int n = u * 16 + h8 * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(oa + n) = pack_bf16(acc[2 * ui + h8][0], acc[2 * ui + h8][1]);
        *reinterpret_cast<uint32_t*>(ob + n) = pack_bf16(acc[2 * ui + h8][2], acc[2 * ui + h8][3]);
      }
    }
  }
}

// ---------------------------- 6. finalize ---------------------------------
__global__ void __launch_bounds__(kFinThreads)
bwd_tc_finalize(const float* __restrict__ dt, const float* __restrict__ A_log,
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
bwd_tc_dA_log(const double* __restrict__ dA_part, float* __restrict__ dA_log, int batch, Dims d) {
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
  long long cum, hsum, gsum, h0b, gb, c0, u, v, xdx, dA, s_buf, w2_hi, w2_lo, row, col, total;
};

// Byte offsets of the scratch regions.  C·Bᵀ, W's tiles and the row and
// column sums reuse the space of S_c and D_c, which launch 2 is the last to
// read.
Scratch carve(long long batch, const Dims& d) {
  const long long bhs = batch * d.H * d.S, PN = static_cast<long long>(d.P) * d.N;
  const long long states = batch * d.H * d.nc * PN;
  const long long tiles = batch * d.G * d.nc * d.npairs * kTile * kTile;
  Scratch s{};
  long long at = 0;
  auto take = [&](long long bytes) { const long long o = at; at += up(bytes); return o; };
  s.cum = take(8 * bhs);
  s.h0b = take(2 * states);
  s.gb = take(2 * states);
  s.c0 = take(8 * batch * d.H * d.nc * d.slices);
  s.u = take(8 * bhs);
  s.v = take(8 * bhs);
  s.xdx = take(4 * bhs);
  s.dA = take(8 * batch * d.H * d.nc);
  const long long shared_at = at;
  s.hsum = take(4 * states);
  s.gsum = take(4 * states);
  const long long first = at;
  at = shared_at;
  s.s_buf = take(4 * tiles);
  s.w2_hi = take(2 * tiles);
  s.w2_lo = take(2 * tiles);
  s.row = take(8 * bhs * d.nt);
  s.col = take(8 * bhs * d.nt);
  s.total = at > first ? at : first;
  return s;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int check(int batch, int seqlen, int heads, int headdim, int groups, int dstate, int chunk,
          Dims& d) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || groups <= 0 || chunk <= 0 || headdim <= 0 ||
      dstate <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (headdim % 16 || headdim > kMaxP || dstate % 16 || dstate > kMaxN || chunk % kTile ||
      seqlen % chunk || heads % groups)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch > kMaxGridYZ || heads > kMaxGridYZ || static_cast<long long>(batch) * groups > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = chunk / kTile;
  d = Dims{seqlen, heads, headdim, groups, dstate, chunk, seqlen / chunk, heads / groups, nt,
           nt * (nt + 1) / 2,
           static_cast<int>((static_cast<long long>(headdim) * dstate / 4 + kStateThreads - 1) /
                            kStateThreads)};
  if (sums_smem(headdim, dstate, chunk) > kMaxSmem || pairs_smem(headdim, dstate) > kMaxSmem ||
      cols_smem(headdim, chunk) > kMaxSmem || group_smem(dstate) > kMaxSmem ||
      fin_smem(chunk) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Each launch's kernel for (P, N), for the launch and for its attributes.
template <int kPT>
void kernels_p(const void** f) {
  f[0] = reinterpret_cast<const void*>(bwd_tc_chunk_sums<kPT>);
  f[3] = reinterpret_cast<const void*>(bwd_tc_columns<kPT>);
}
template <int kNT>
void kernels_n(const void** f) {
  f[4] = reinterpret_cast<const void*>(bwd_tc_group<kNT>);
}
void kernels_for(int P, int N, const void** f) {
  if (P <= 32) kernels_p<32>(f);
  else if (P <= 64) kernels_p<64>(f);
  else kernels_p<128>(f);
  if (N <= 64) kernels_n<64>(f);
  else if (N <= 128) kernels_n<128>(f);
  else kernels_n<256>(f);
  f[1] = reinterpret_cast<const void*>(bwd_tc_state_passes);
  f[2] = reinterpret_cast<const void*>(bwd_tc_pairs);
  f[5] = reinterpret_cast<const void*>(bwd_tc_finalize);
  f[6] = reinterpret_cast<const void*>(bwd_tc_dA_log);
}

}  // namespace

// Shared bytes of the launches — chunk sums, pairs, columns, group,
// finalize — into out[0..5).
extern "C" void arcadia_ssd_scan_bwd_tc_plan(int headdim, int dstate, int chunk, long long* out) {
  out[0] = sums_smem(headdim, dstate, chunk);
  out[1] = pairs_smem(headdim, dstate);
  out[2] = cols_smem(headdim, chunk);
  out[3] = group_smem(dstate);
  out[4] = fin_smem(chunk);
}

// Bytes of scratch the caller allocates (256-byte aligned) for a call, or -1
// for a shape the kernel does not take.
extern "C" long long arcadia_ssd_scan_bwd_tc_scratch_bytes(int batch, int seqlen, int heads,
                                                          int headdim, int groups, int dstate,
                                                          int chunk) {
  Dims d;
  if (check(batch, seqlen, heads, headdim, groups, dstate, chunk, d) != 0) return -1;
  return carve(batch, d).total;
}

// cudaFuncGetAttributes of the kernel of launch `launch` (0 chunk sums, 1
// state passes, 2 pairs, 3 columns, 4 group, 5 finalize, 6 dA_log) for head
// dim P and state dim N: out = registers a thread, local (spill) bytes, static
// shared bytes, max threads a block.  Returns the cudaError_t.
extern "C" int arcadia_ssd_scan_bwd_tc_info(int launch, int headdim, int dstate, int* out) {
  if (launch < 0 || launch > 6) return static_cast<int>(cudaErrorInvalidValue);
  const void* f[7];
  kernels_for(headdim, dstate, f);
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, f[launch]);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = fa.maxThreadsPerBlock;
  return 0;
}

// Gradient of the SSD scan on the tensor cores.  bf16 xh and dy [batch,
// seqlen, heads, headdim], Bm and Cm [batch, seqlen, groups, dstate], read
// through strides[12] (xh: batch, token, head; Bm, Cm: batch, token, group;
// dy: batch, token, head; in elements, the last dimension contiguous);
// dt [batch, seqlen, heads] and A_log [heads] fp32 contiguous; d(final state)
// [batch, heads, headdim, dstate] fp32 contiguous or null.  Outputs,
// contiguous: dxh (bf16, xh's shape), ddt (fp32, dt's), dA_log [heads] fp32,
// dBm and dCm (bf16, [batch, seqlen, groups, dstate]).  `scratch` holds
// arcadia_ssd_scan_bwd_tc_scratch_bytes bytes, 256-byte aligned.  headdim
// and dstate multiples of 16 (at most 128 and 256), chunk a multiple of 64
// dividing seqlen, groups dividing heads, strides multiples of 8, the four
// bf16 inputs 16-byte aligned.  Launches seven kernels on `stream`, does not
// synchronise, and returns the first cudaError_t (0 on success).
extern "C" int arcadia_ssd_scan_bwd_tc(const void* xh, const void* dt, const void* A_log,
                                       const void* Bm, const void* Cm, const void* dy,
                                       const void* dstate, void* dxh, void* ddt, void* dA_log,
                                       void* dBm, void* dCm, void* scratch, int batch, int seqlen,
                                       int heads, int headdim, int groups, int dstate_dim,
                                       int chunk, const long long* strides, void* stream) {
  Dims d;
  int bad = check(batch, seqlen, heads, headdim, groups, dstate_dim, chunk, d);
  if (bad) return bad;
  for (int k = 0; k < 12; ++k)
    if (strides[k] % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(xh) || !aligned16(Bm) || !aligned16(Cm) || !aligned16(dy) ||
      (reinterpret_cast<uintptr_t>(scratch) & (kAlign - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2],  strides[3],  strides[4],  strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  const Scratch sc = carve(batch, d);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  double* cum = reinterpret_cast<double*>(base + sc.cum);
  float* hsum = reinterpret_cast<float*>(base + sc.hsum);
  float* gsum = reinterpret_cast<float*>(base + sc.gsum);
  bf16* h0b = reinterpret_cast<bf16*>(base + sc.h0b);
  bf16* gb = reinterpret_cast<bf16*>(base + sc.gb);
  double* c0 = reinterpret_cast<double*>(base + sc.c0);
  double* u = reinterpret_cast<double*>(base + sc.u);
  double* v = reinterpret_cast<double*>(base + sc.v);
  float* xdx = reinterpret_cast<float*>(base + sc.xdx);
  double* dA = reinterpret_cast<double*>(base + sc.dA);
  float* s_buf = reinterpret_cast<float*>(base + sc.s_buf);
  bf16* w2h = reinterpret_cast<bf16*>(base + sc.w2_hi);
  bf16* w2l = reinterpret_cast<bf16*>(base + sc.w2_lo);
  double* row = reinterpret_cast<double*>(base + sc.row);
  double* col = reinterpret_cast<double*>(base + sc.col);
  const auto* x = static_cast<const bf16*>(xh);
  const auto* t = static_cast<const float*>(dt);
  const auto* a = static_cast<const float*>(A_log);
  const auto* bm = static_cast<const bf16*>(Bm);
  const auto* cm = static_cast<const bf16*>(Cm);
  const auto* y = static_cast<const bf16*>(dy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const void* f[7];
  kernels_for(d.P, d.N, f);
  const long long smem[7] = {sums_smem(d.P, d.N, d.Q), 0, pairs_smem(d.P, d.N),
                             cols_smem(d.P, d.Q), group_smem(d.N), fin_smem(d.Q), 0};
  for (int k = 0; k < 7; ++k) {
    if (!smem[k]) continue;
    const cudaError_t err = cudaFuncSetAttribute(f[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem[k]));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err;
  // 1. chunk sums
  {
    const dim3 grid(2 * d.nc, d.H, batch);
    if (d.P <= 32)
      bwd_tc_chunk_sums<32><<<grid, 2 * d.N, smem[0], s>>>(x, t, a, bm, cm, y, hsum, gsum, cum, d, st);
    else if (d.P <= 64)
      bwd_tc_chunk_sums<64><<<grid, 2 * d.N, smem[0], s>>>(x, t, a, bm, cm, y, hsum, gsum, cum, d, st);
    else
      bwd_tc_chunk_sums<128><<<grid, 2 * d.N, smem[0], s>>>(x, t, a, bm, cm, y, hsum, gsum, cum, d, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  // 2. state passes
  bwd_tc_state_passes<<<dim3(batch * d.H, d.slices), kStateThreads, 0, s>>>(
      hsum, gsum, cum, static_cast<const float*>(dstate), h0b, gb, c0, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // 3. pairs
  bwd_tc_pairs<<<dim3(d.npairs, d.nc, batch * d.G), kPairThreads, smem[2], s>>>(
      x, t, bm, cm, y, cum, s_buf, w2h, w2l, row, col, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // 4. columns
  {
    const dim3 grid(d.nc * d.nt, d.H, batch);
    bf16* o = static_cast<bf16*>(dxh);
    if (d.P <= 32)
      bwd_tc_columns<32><<<grid, kColThreads, smem[3], s>>>(x, t, bm, y, cum, gb, s_buf, o, xdx, v, d, st);
    else if (d.P <= 64)
      bwd_tc_columns<64><<<grid, kColThreads, smem[3], s>>>(x, t, bm, y, cum, gb, s_buf, o, xdx, v, d, st);
    else
      bwd_tc_columns<128><<<grid, kColThreads, smem[3], s>>>(x, t, bm, y, cum, gb, s_buf, o, xdx, v, d, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  // 5. group
  {
    const dim3 grid(2 * d.nc * d.nt, d.G, batch);
    bf16* ob = static_cast<bf16*>(dBm);
    bf16* oc = static_cast<bf16*>(dCm);
    if (d.N <= 64)
      bwd_tc_group<64><<<grid, kGroupThreads, smem[4], s>>>(x, t, bm, cm, y, cum, h0b, gb, w2h, w2l, ob, oc, u, d, st);
    else if (d.N <= 128)
      bwd_tc_group<128><<<grid, kGroupThreads, smem[4], s>>>(x, t, bm, cm, y, cum, h0b, gb, w2h, w2l, ob, oc, u, d, st);
    else
      bwd_tc_group<256><<<grid, kGroupThreads, smem[4], s>>>(x, t, bm, cm, y, cum, h0b, gb, w2h, w2l, ob, oc, u, d, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  // 6. finalize
  bwd_tc_finalize<<<dim3(d.nc, d.H, batch), kFinThreads, smem[5], s>>>(
      t, a, cum, c0, row, col, u, v, xdx, static_cast<float*>(ddt), dA, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // 7. dA_log
  bwd_tc_dA_log<<<1, kFinThreads, 0, s>>>(dA, static_cast<float*>(dA_log), batch, d);
  return static_cast<int>(cudaGetLastError());
}
