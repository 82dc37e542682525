// Mamba2 SSD chunked scan on Hopper's tensor cores (sm_90a), bf16, with
// the chunks in parallel.
//
// Replaces the TPU kernel `_ssd_kernel` of the JAX package
// (src/repro/kernels/ssd_scan/ssd_scan.py), launched there by `ssd_pallas`,
// for bf16 inputs with head dim P and state dim N multiples of 16 (P <= 128,
// N <= 256) and a chunk Q that is a multiple of 64; ssd_scan.cu serves the
// rest.  Per (batch b, head h), with group g = h / (H/G), a_t =
// -exp(A_log[h])·dt_t and cum the inclusive sum of a within a chunk, it
// computes the same function as ssd_scan.cu and kernels/ssd_scan/ref.py:
//
//     y_i = Σ_{j≤i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j  +  exp(cum_i) C_i·h_c
//     h_{c+1} = exp(cum_Q) h_c + Σ_j x_j ⊗ B_j dt_j exp(cum_Q - cum_j)
//
// writing y [B,S,H,P] bf16 and the final h as state [B,H,P,N] fp32.
//
// What bounds it.  At mamba2-130m's serving shape (B=8, S=4096, H=24,
// P=64, N=128, Q=256) the function needs about Q(Q+1)(N+P) + 4QNP ≈ 21 M
// operations per (b, h, chunk), 64 GFLOP in all, on 0.22 GB of bf16 inputs
// and outputs: 0.065 ms on the tensor cores (989 TFLOP/s) and 0.068 ms at
// HBM's 3.35 TB/s, so operations and bytes bound it about equally.
//
// Design: the split of Mamba2's own GPU algorithm (Dao & Gu 2024, "SSD
// algorithm": chunk states, state passing, chunk output), three launches.
// The sequential dependence is only the state passing, an elementwise walk
// over the chunks; everything else runs with B·H·(S/Q) independent chunks
// (3,072 at the serving shape, against 192 (b, h) pairs for ssd_scan.cu).
//
//   1. ssd_chunk_state_kernel, grid (c, h, b), N/16 warps.  cum of the
//      chunk by a parallel scan in fp64 (an fp32 sum drifts at Q = 256,
//      where cum reaches -100 to -200); each decay difference is rounded to
//      fp32 once.  S_c[P,N] = Σ_j x_j ⊗ B'_j on the tensor cores
//      (mma.sync m16n8k16, bf16 operands, fp32 sums), with x as stored and
//      B'_j = bf16(B_j · dt_j · exp(cum_Q - cum_j)): the per-token factor in
//      fp32, the scaled B rounded once.  64-token tiles of x and B arrive
//      by cp.async into two stages, the next tile in flight while the
//      current one is scaled and multiplied.  Writes S_c fp32 and cum fp64.
//   2. ssd_state_passing_kernel, grid (b·h, slice of P·N), 4 elements a
//      thread: h <- exp(cum_Q)·h + S_c over the chunks in order in fp32;
//      writes the state at each chunk's start, h_prev[c], in bf16 (it is
//      only the B operand of pass 3's bf16 product, whose C is bf16 already;
//      one rounding, 2^-9 of the term, below y's own bf16 rounding), and
//      the final state in fp32.
//   3. ssd_chunk_scan_kernel, grid (c · Q/rows, h, b), blocks of 128 rows
//      (8 warps of 16) where Q and shared memory allow, else 64 (4 warps).
//      y_i starts as exp(cum_i)·(C_i · h_prevᵀ) on the tensor cores;
//      then for each 64-column tile j up to the block's last row (two
//      cp.async stages; a warp whose rows all precede the tile skips it):
//      the score tile C_i·B_jᵀ on the tensor cores, masked to 0 where
//      j > i BEFORE the exp (an overflowing exp times a 0 mask is NaN), times
//      exp(cum_i - cum_j) and dt_j (dt folds into the scores, so x is
//      rounded nowhere), rounded to bf16 in registers as the A operand of
//      y_i += scores · x_j, as the flash kernel does with P.  C·Bᵀ is
//      computed once per head: at G = 1 the 24 heads of mamba2-130m each
//      redo it (about 32 of the 74 GFLOP of tensor-core work at the serving
//      shape), where sharing it would write [B, S/Q, Q, Q] fp32 scores to
//      memory (34 MB) and read them back per head.
//
// Inputs as they come: xh, Bm and Cm are read through their strides
// (batch, token, head or group; the last dimension contiguous), so the
// mixer's views of its conv output go in without a copy; the wrapper
// checks that every stride is a multiple of 8 elements and every pointer
// 16-byte aligned (the cp.async rule) and sends other layouts to
// ssd_scan.cu.  Shared rows are padded by 16 bytes, so the 8 rows an
// ldmatrix reads fall in distinct banks.
//
// Intermediates the bound does not count, at the serving shape: S_c
// [B,H,S/Q,P,N] fp32 written by pass 1 and read by pass 2 (2 × 100.7 MB),
// h_prev [B,H,S/Q,P,N] bf16 written by pass 2 and read by pass 3 (2 ×
// 50.3 MB), cum [B,H,S] fp64 (6.3 MB written, read twice): about 0.32 GB,
// 0.096 ms at HBM's rate, beside the bound's 0.068 ms.
//
// Built by kernels/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;           // tokens of a row tile and of a K tile
constexpr int kPad = 8;             // bf16 padding a shared row: 16 bytes
constexpr int kScanMaxWarps = 8;    // pass 3: 16 rows a warp, up to 128 rows
constexpr int kStateThreads = 256;  // pass 2
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kMaxSmem = 232448;    // 227 KB, H100
constexpr int kMaxGridYZ = 65535;   // grid.y and grid.z limit

struct Dims {
  int S, H, P, G, N, Q, nc, rep;
};

// Element strides of xh (batch, token, head) and of Bm and Cm (batch,
// token, group); the last dimension of each is contiguous.
struct Strides {
  long long xb, xs, xh, bb, bs, bg, cb, cs, cg;
};

// ---- shared memory of passes 1 and 3, bytes (the wrapper's plan too) ----
__host__ __device__ inline long long state_smem_bytes(int P, int N, int Q) {
  return 8LL * Q + 8LL * 16 + 4LL * Q                      // cum, warp sums, w
         + 2LL * 2 * kTile * ((P + kPad) + (N + kPad));    // 2 stages of x, B
}
__host__ __device__ inline long long scan_smem_bytes(int P, int N, int Q, int rows) {
  return 8LL * Q + 4LL * Q                                 // cum, dt
         + 2LL * (rows + P) * (N + kPad)                   // C rows, h_prev
         + 2LL * 2 * kTile * ((N + kPad) + (P + kPad));    // 2 stages of B, x
}
// Rows of a pass-3 block: 128 (8 warps) where the chunk and shared memory
// allow, else 64 (4 warps).
__host__ __device__ inline int scan_rows(int P, int N, int Q) {
  return Q % (2 * kTile) == 0 && scan_smem_bytes(P, N, Q, 2 * kTile) <= kMaxSmem ? 2 * kTile
                                                                              : kTile;
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
// Four 8x8 bf16 matrices from shared memory, one row address a lane.
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

// Fragment addresses (lane's row pointer) for ldmatrix.x4, ld = the
// shared row length in elements.  mi = lane / 8 picks the 8x8 matrix.
//   A 16x16 at (m0, k0) stored [m][k]:      a_rows(...) with ldsm_x4
//   A 16x16 at (m0, k0) stored [k][m]:      a_cols(...) with ldsm_x4_t
//   B 16(k) x 16(n) at (k0, n0), the two n8 fragments {r0, r1}, {r2, r3}:
//     stored [n][k]: b_rows(...) with ldsm_x4;  stored [k][n]: b_cols with ldsm_x4_t
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

// cp.async of `rows` rows of `width` bf16 (a multiple of 8) from global
// rows `stride` elements apart into shared rows `ld` apart.
__device__ __forceinline__ void copy_rows(bf16* dst, int ld, const bf16* src, long long stride,
                                          int rows, int width) {
  const int pieces = width / 8;
  for (int e = threadIdx.x; e < rows * pieces; e += blockDim.x) {
    const int r = e / pieces, q = e - r * pieces;
    cp_async16(dst + r * ld + q * 8, src + r * stride + q * 8);
  }
}

// In-place inclusive prefix sum of v[0..n) in fp64 by the whole block:
// each thread sums a run of consecutive values, then the runs' totals are
// scanned across the warp (shuffles) and the block (`warp_sums`, 16).
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

// -------------------------- pass 1: chunk states --------------------------
// kPT: P rounded up to 32, 64 or 128 (fragments past P are skipped).
template <int kPT>
__global__ void __launch_bounds__(2 * kMaxN)
ssd_chunk_state_kernel(const bf16* __restrict__ xh, const float* __restrict__ dt,
                       const float* __restrict__ A_log, const bf16* __restrict__ Bm,
                       float* __restrict__ chunk_state, double* __restrict__ cum_out, Dims d,
                       Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = d.P, N = d.N, Q = d.Q;
  const int ldx = P + kPad, ldb = N + kPad;
  double* cum = reinterpret_cast<double*>(smem);
  double* warp_sums = cum + Q;
  float* w = reinterpret_cast<float*>(warp_sums + 16);
  bf16* const xs = reinterpret_cast<bf16*>(w + Q);   // stage s at xs + s·kTile·ldx
  bf16* const bs = xs + 2 * kTile * ldx;              // stage s at bs + s·kTile·ldb

  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int g = hh / d.rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = static_cast<long long>(c) * Q;
  const bf16* xbase = xh + b * st.xb + t0 * st.xs + hh * st.xh;
  const bf16* bbase = Bm + b * st.bb + t0 * st.bs + g * st.bg;
  const int nk = Q / kTile;

  copy_rows(xs, ldx, xbase, st.xs, kTile, P);     // tile 0 flies during the scan
  copy_rows(bs, ldb, bbase, st.bs, kTile, N);
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
    cum_g[i] = cum[i];
    w[i] = dtb[static_cast<long long>(i) * d.H] * exp_diff(total, cum[i]);
  }

  float acc[kPT / 8][4];
#pragma unroll
  for (int nt = 0; nt < kPT / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int m0 = warp * 16;                // this warp's 16 rows n of S_cᵀ

  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    bf16* const xt = xs + stage * kTile * ldx;
    bf16* const bt = bs + stage * kTile * ldb;
    if (kt + 1 < nk) {
      copy_rows(xs + (stage ^ 1) * kTile * ldx, ldx, xbase + (kt + 1) * kTile * st.xs, st.xs,
                kTile, P);
      copy_rows(bs + (stage ^ 1) * kTile * ldb, ldb, bbase + (kt + 1) * kTile * st.bs, st.bs,
                kTile, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // B'_j = bf16(B_j · w_j): the fp32 factor, one rounding
    const int half_n = N / 2;
    for (int e = tid; e < kTile * half_n; e += blockDim.x) {
      const int r = e / half_n, q = e - r * half_n;
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(bt + r * ldb) + q;
      const float s = w[kt * kTile + r];
      const float2 f = __bfloat1622float2(*p2);
      *p2 = __floats2bfloat162_rn(f.x * s, f.y * s);
    }
    __syncthreads();
    // S_cᵀ[n, p] += Σ_j B'_j[n] x_j[p]: A = B'ᵀ (stored [j][n]), B = x ([j][p])
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

  // S_c stored [P][N]: lanes of one column write 8 consecutive n
  float* out = chunk_state +
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

// -------------------------- pass 2: state passing -------------------------
__global__ void __launch_bounds__(kStateThreads)
ssd_state_passing_kernel(const float* __restrict__ chunk_state, const double* __restrict__ cum,
                         bf16* __restrict__ h_prev, float* __restrict__ state_out, Dims d) {
  const long long PN = static_cast<long long>(d.P) * d.N;
  const long long e = (static_cast<long long>(blockIdx.y) * kStateThreads + threadIdx.x) * 4;
  if (e >= PN) return;
  const long long bh = blockIdx.x;
  const double* last = cum + bh * d.S + d.Q - 1;       // cum_Q of chunk 0
  const float* src = chunk_state + bh * d.nc * PN + e;
  bf16* hp = h_prev + bh * d.nc * PN + e;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < d.nc; ++c) {
    uint2 packed;
    packed.x = pack_bf16(h.x, h.y);
    packed.y = pack_bf16(h.z, h.w);
    *reinterpret_cast<uint2*>(hp + c * PN) = packed;
    const float decay = expf(static_cast<float>(last[static_cast<long long>(c) * d.Q]));
    const float4 s = *reinterpret_cast<const float4*>(src + c * PN);
    h.x = fmaf(decay, h.x, s.x);
    h.y = fmaf(decay, h.y, s.y);
    h.z = fmaf(decay, h.z, s.z);
    h.w = fmaf(decay, h.w, s.w);
  }
  *reinterpret_cast<float4*>(state_out + bh * PN + e) = h;
}

// -------------------------- pass 3: chunk output --------------------------
template <int kPT>
__global__ void __launch_bounds__(kScanMaxWarps * 32, kPT <= 64 ? 2 : 1)
ssd_chunk_scan_kernel(const bf16* __restrict__ xh, const float* __restrict__ dt,
                      const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                      const double* __restrict__ cum_in, const bf16* __restrict__ h_prev,
                      bf16* __restrict__ y, Dims d, Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = d.P, N = d.N, Q = d.Q;
  const int ldn = N + kPad, ldx = P + kPad;
  const int rows = blockDim.x / 2;        // 16 rows a warp
  const int tiles = Q / rows;
  const int c = blockIdx.x / tiles, it = blockIdx.x - c * tiles;
  const int hh = blockIdx.y, b = blockIdx.z, g = hh / d.rep;
  const int i0 = it * rows;               // the block's first row in the chunk
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + Q);
  bf16* cs = reinterpret_cast<bf16*>(dts + Q);
  bf16* hs = cs + rows * ldn;
  bf16* const bsm = hs + P * ldn;               // stage s at bsm + s·kTile·ldn
  bf16* const xsm = bsm + 2 * kTile * ldn;      // stage s at xsm + s·kTile·ldx

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = static_cast<long long>(c) * Q;
  const long long bh = static_cast<long long>(b) * d.H + hh;
  const bf16* xbase = xh + b * st.xb + t0 * st.xs + hh * st.xh;
  const bf16* bbase = Bm + b * st.bb + t0 * st.bs + g * st.bg;
  const bf16* cbase = Cm + b * st.cb + t0 * st.cs + g * st.cg;
  const bf16* hbase = h_prev + (bh * d.nc + c) * static_cast<long long>(P) * N;
  const int nj = (i0 + rows) / kTile;     // column tiles up to the last row

  // group 0: C rows of the block, h_prev of the chunk, column tile 0
  copy_rows(cs, ldn, cbase + i0 * st.cs, st.cs, rows, N);
  copy_rows(hs, ldn, hbase, N, P, N);
  copy_rows(bsm, ldn, bbase, st.bs, kTile, N);
  copy_rows(xsm, ldx, xbase, st.xs, kTile, P);
  cp_async_commit();
  if (nj > 1) {
    copy_rows(bsm + kTile * ldn, ldn, bbase + kTile * st.bs, st.bs, kTile, N);
    copy_rows(xsm + kTile * ldx, ldx, xbase + kTile * st.xs, st.xs, kTile, P);
    cp_async_commit();
  }
  const double* cum_g = cum_in + bh * d.S + t0;
  const float* dtb = dt + (static_cast<long long>(b) * d.S + t0) * d.H + hh;
  for (int i = tid; i < i0 + rows; i += blockDim.x) {
    cum[i] = cum_g[i];
    dts[i] = dtb[static_cast<long long>(i) * d.H];
  }
  if (nj > 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  __syncthreads();

  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = warp * 16;               // this warp's rows in the tile
  const int ia = i0 + m0 + gq, ib = ia + 8;   // a lane's two rows in the chunk
  const double cum_a = cum[ia], cum_b = cum[ib];

  // inter-chunk term: exp(cum_i) · C_i · h_prevᵀ (h_prev stored [p][n])
  float acc[kPT / 8][4];
#pragma unroll
  for (int nt = 0; nt < kPT / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_rows(cs, ldn, m0, kk * 16, lane));
#pragma unroll
    for (int np = 0; np < kPT / 16; ++np) {
      if (np * 16 < P) {
        uint32_t f[4];
        ldsm_x4(f, b_rows(hs, ldn, kk * 16, np * 16, lane));
        mma16816(acc[2 * np], a, f[0], f[1]);
        mma16816(acc[2 * np + 1], a, f[2], f[3]);
      }
    }
  }
  {
    const float ea = expf(static_cast<float>(cum_a)), eb = expf(static_cast<float>(cum_b));
#pragma unroll
    for (int nt = 0; nt < kPT / 8; ++nt) {
      acc[nt][0] *= ea;
      acc[nt][1] *= ea;
      acc[nt][2] *= eb;
      acc[nt][3] *= eb;
    }
  }

  // intra-chunk term, one 64-column tile j at a time
  for (int jt = 0; jt < nj; ++jt) {
    const int stage = jt & 1;
    if (jt > 0) {
      if (jt + 1 < nj)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
    }
    const bf16* bj = bsm + stage * kTile * ldn;
    const bf16* xj = xsm + stage * kTile * ldx;
    const int j0 = jt * kTile;
    // a warp whose rows all precede the tile has nothing to add (uniform)
    if (j0 <= i0 + m0 + 15) {
      // scores C_i · B_jᵀ (B stored [j][n])
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, a_rows(cs, ldn, m0, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t f[4];
          ldsm_x4(f, b_rows(bj, ldn, kk * 16, np * 16, lane));
          mma16816(s[2 * np], a, f[0], f[1]);
          mma16816(s[2 * np + 1], a, f[2], f[3]);
        }
      }
      // mask (j > i selects 0, the exp is not taken), decay, dt; bf16 A operand
      const bool mask = j0 + kTile - 1 > i0 + m0;   // some j lies past some row
      uint32_t pa[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int ja = j0 + nt * 8 + 2 * tq, jb = ja + 1;
        const double cja = cum[ja], cjb = cum[jb];
        const float dja = dts[ja], djb = dts[jb];
        const float v0 = (!mask || ja <= ia) ? s[nt][0] * exp_diff(cum_a, cja) * dja : 0.f;
        const float v1 = (!mask || jb <= ia) ? s[nt][1] * exp_diff(cum_a, cjb) * djb : 0.f;
        const float v2 = (!mask || ja <= ib) ? s[nt][2] * exp_diff(cum_b, cja) * dja : 0.f;
        const float v3 = (!mask || jb <= ib) ? s[nt][3] * exp_diff(cum_b, cjb) * djb : 0.f;
        pa[nt >> 1][(nt & 1) * 2] = pack_bf16(v0, v1);
        pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(v2, v3);
      }
      // y_i += scores · x_j (x stored [j][p])
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < kPT / 16; ++np) {
          if (np * 16 < P) {
            uint32_t f[4];
            ldsm_x4_t(f, b_cols(xj, ldx, kk * 16, np * 16, lane));
            mma16816(acc[2 * np], pa[kk], f[0], f[1]);
            mma16816(acc[2 * np + 1], pa[kk], f[2], f[3]);
          }
        }
      }
    }
    __syncthreads();                      // every warp is done with the stage
    if (jt + 2 < nj) {
      copy_rows(bsm + stage * kTile * ldn, ldn, bbase + (jt + 2) * kTile * st.bs, st.bs, kTile,
                N);
      copy_rows(xsm + stage * kTile * ldx, ldx, xbase + (jt + 2) * kTile * st.xs, st.xs, kTile,
                P);
      cp_async_commit();
    }
  }

  // y [B,S,H,P] contiguous
  const long long ytok = static_cast<long long>(d.H) * P;
  bf16* ybase = y + (static_cast<long long>(b) * d.S + t0) * ytok + static_cast<long long>(hh) * P;
#pragma unroll
  for (int nt = 0; nt < kPT / 8; ++nt) {
    if (nt * 8 < P) {
      const int p = nt * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(ybase + ia * ytok + p) = pack_bf16(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<uint32_t*>(ybase + ib * ytok + p) = pack_bf16(acc[nt][2], acc[nt][3]);
    }
  }
}

template <int kPT>
int launch(const bf16* xh, const float* dt, const float* A_log, const bf16* Bm, const bf16* Cm,
           bf16* y, float* state, float* chunk_state, double* cum, bf16* h_prev, int batch,
           const Dims& d, const Strides& st, cudaStream_t stream) {
  const int s1 = static_cast<int>(state_smem_bytes(d.P, d.N, d.Q));
  const int rows = scan_rows(d.P, d.N, d.Q);
  const int s3 = static_cast<int>(scan_smem_bytes(d.P, d.N, d.Q, rows));
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel<kPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<kPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s3);
  if (err != cudaSuccess) return static_cast<int>(err);

  ssd_chunk_state_kernel<kPT><<<dim3(d.nc, d.H, batch), 2 * d.N, s1, stream>>>(
      xh, dt, A_log, Bm, chunk_state, cum, d, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long quads = static_cast<long long>(d.P) * d.N / 4;
  const unsigned slices = static_cast<unsigned>((quads + kStateThreads - 1) / kStateThreads);
  ssd_state_passing_kernel<<<dim3(batch * d.H, slices), kStateThreads, 0, stream>>>(
      chunk_state, cum, h_prev, state, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  ssd_chunk_scan_kernel<kPT><<<dim3(d.nc * (d.Q / rows), d.H, batch), 2 * rows, s3, stream>>>(
      xh, dt, Bm, Cm, cum, h_prev, y, d, st);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// The plan of a launch: shared bytes of passes 1 and 3 and the rows of a
// pass-3 block, into out[0..2].
extern "C" void arcadia_ssd_scan_tc_plan(int headdim, int dstate, int chunk, long long* out) {
  const int rows = scan_rows(headdim, dstate, chunk);
  out[0] = state_smem_bytes(headdim, dstate, chunk);
  out[1] = scan_smem_bytes(headdim, dstate, chunk, rows);
  out[2] = rows;
}

// SSD scan of bf16 xh [batch, seqlen, heads, headdim], Bm and Cm [batch,
// seqlen, groups, dstate] read through strides[9] (xh: batch, token, head;
// Bm: batch, token, group; Cm: the same; in elements, the last dimension
// contiguous), dt [batch, seqlen, heads] fp32 and A_log [heads] fp32
// contiguous, into y (contiguous, xh's shape, bf16) and state [batch,
// heads, headdim, dstate] fp32.  Scratch from the caller: chunk_state
// [batch, heads, seqlen/chunk, headdim, dstate] fp32, cum [batch, heads,
// seqlen] fp64, h_prev [batch, heads, seqlen/chunk, headdim, dstate] bf16.
// headdim and dstate multiples of 16 (at most 128 and 256), chunk a
// multiple of 64 dividing seqlen, groups dividing heads, batch and heads
// at most 65535, strides multiples of 8 and xh/Bm/Cm 16-byte aligned.  Launches three kernels on `stream`,
// does not synchronise, and returns the first cudaError_t (0 on success).
extern "C" int arcadia_ssd_scan_tc(const void* xh, const void* dt, const void* A_log,
                                   const void* Bm, const void* Cm, void* y, void* state,
                                   void* chunk_state, void* cum, void* h_prev, int batch,
                                   int seqlen, int heads, int headdim, int groups, int dstate,
                                   int chunk, const long long* strides, void* stream) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || groups <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (headdim <= 0 || headdim % 16 || headdim > kMaxP || dstate <= 0 || dstate % 16 ||
      dstate > kMaxN || chunk % kTile || seqlen % chunk || heads % groups)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch > kMaxGridYZ || heads > kMaxGridYZ)        // grid (·, heads, batch)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < 9; ++k)
    if (strides[k] % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(xh) || !aligned16(Bm) || !aligned16(Cm))
    return static_cast<int>(cudaErrorInvalidValue);
  if (state_smem_bytes(headdim, dstate, chunk) > kMaxSmem ||
      scan_smem_bytes(headdim, dstate, chunk, scan_rows(headdim, dstate, chunk)) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{seqlen, heads, headdim, groups, dstate, chunk, seqlen / chunk, heads / groups};
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  const auto* x = static_cast<const bf16*>(xh);
  const auto* t = static_cast<const float*>(dt);
  const auto* a = static_cast<const float*>(A_log);
  const auto* bm = static_cast<const bf16*>(Bm);
  const auto* cm = static_cast<const bf16*>(Cm);
  auto* yo = static_cast<bf16*>(y);
  auto* so = static_cast<float*>(state);
  auto* cst = static_cast<float*>(chunk_state);
  auto* cu = static_cast<double*>(cum);
  auto* hp = static_cast<bf16*>(h_prev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (headdim <= 32) return launch<32>(x, t, a, bm, cm, yo, so, cst, cu, hp, batch, d, st, s);
  if (headdim <= 64) return launch<64>(x, t, a, bm, cm, yo, so, cst, cu, hp, batch, d, st, s);
  return launch<128>(x, t, a, bm, cm, yo, so, cst, cu, hp, batch, d, st, s);
}
