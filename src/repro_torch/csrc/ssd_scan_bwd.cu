// Backward of the Mamba2 SSD (state-space duality) chunked scan for Hopper
// (sm_90a).
//
// The gradient of the scan of csrc/ssd_scan.cu and csrc/ssd_scan_tc.cu, whose
// TPU kernel is `_ssd_kernel` (src/repro/kernels/ssd_scan/ssd_scan.py).  That
// Pallas kernel has no gradient: the JAX package trains through autodiff of
// its plain reference (ref.ssd_reference).  This kernel computes the same
// function as the port's plain chunked backward,
// kernels/ssd_scan/ref.py::ssd_backward_reference, in the same passes.
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
//   dB_j   = Σ_{i>=j} L_ij r_ij C_i + exp(cum_Q - cum_j) Gᵀ x~_j   (per head)
//   dC_i   = Σ_{j<=i} L_ij r_ij B_j + exp(cum_i) h0ᵀ dy_i           (per head)
//   da_t   = Σ_{i>=t} (Σ_{j<i} M_ij - Σ_{k>i} M_ki + u_i) + Σ_{j<t} v_j
//            + exp(cum_Q) <G, h0>,   M = L∘s∘r below the diagonal,
//            u_i = exp(cum_i) C_i·(h0ᵀ dy_i), v_j = exp(cum_Q - cum_j) x~_j·(G B_j)
//   dx_t   = dt_t dx~_t,  ddt_t = <x_t, dx~_t> - exp(A_log) da_t,
//   dA_log = Σ_{b,t} a_t da_t,
//
// with dB and dC summed over the H/G heads of a group.  Outputs: dxh
// [B,S,H,P], dBm and dCm [B,S,G,N] in the inputs' dtype, ddt [B,S,H] and
// dA_log [H] in fp32.
//
// Seven launches on the CUDA cores in fp32 out of shared memory (the
// products go to mma/wgmma in a later change).  Each product is a loop over
// its depth in which a thread holds a 4 x 4 (or 4 x 8, 4 x 16) block of
// outputs in registers and reads 4 + 4 (or 4 + 8, 4 + 16) operands a step
// from k-major tiles padded to 65 floats a row, so that neither a row nor a
// column read of a tile conflicts in the banks:
//   1. chunk sums, one block per (b, h, chunk): cum in fp64 (kept for the
//      later launches), the chunk's state contribution Σ_j exp(cum_Q - cum_j)
//      x~_j ⊗ B_j and its adjoint contribution Σ_i exp(cum_i) dy_i ⊗ C_i;
//   2. state passes, one thread per (b, h, p, n): h0 forward over the
//      chunks and G backward, in place over the two sums;
//   3. rows, one block per (b, h, chunk, 64-row tile I): dC of the tile
//      and the row sums of M plus u;
//   4. columns, one block per (b, h, chunk, 64-column tile J): dx~ (so dxh
//      and <x, dx~>) and dB of the tile, the column sums of M, and v;
//   5. finalize, one block per (b, h, chunk): <G, h0>, da by a reverse
//      cumsum in fp64, ddt, and the chunk's part of dA_log;
//   6. the group sums of dB and dC over the heads' fp32 partials;
//   7. dA_log, the sum of the chunks' parts over batch and chunks.
// What bounds it.  At mamba2-130m's training shape (B=8, S=4096, H=24,
// P=64, N=128, Q=256) the gradient needs about 3·Q²(N+P)/2 + 8·Q·N·P
// multiply-adds per (b, h, chunk) — about 0.17 TFLOP a call — on ≈ 0.34 GB
// of inputs and outputs read and written once: on the tensor cores the
// operations (0.17 ms) bound it.  These launches run on the CUDA cores (67
// TFLOP/s fp32 at most, 2.5 ms for the same work) and read the operands of
// every product out of shared memory, one load for two to four
// multiply-adds, so shared-memory bandwidth bounds them above either.
// What the design does:
//   * Deterministic.  There are no atomics: every sum is taken in a fixed
//     order (warp shuffles in a fixed pattern, fixed-order shared-memory
//     sums, per-head fp32 partials of dB and dC summed in head order, the
//     chunks' dA_log parts in fp64 in (batch, chunk) order), so two calls
//     give the same bits.
//   * Mask before exp, as the forward: a pair j > i takes 0 and never
//     evaluates exp(cum_i - cum_j), which can overflow.
//   * d(cum) cancels: da_t is the sum of M over i >= t > j, but a reverse
//     cumsum of row minus column sums adds and removes every term with j >= t.
//     The diagonal's two terms cancel exactly and are left out; the row and
//     column sums, u and v are summed and kept in fp64 (the products in fp32)
//     and da's cumsums run in fp64, so the cancellation costs only the
//     products' own rounding; the state terms of da (v and <G, h0>) enter as
//     sums of their own sign.
//   * Decay differences as the forward takes them: cum in fp64, each
//     difference rounded to fp32 once.
//   * The quadratic terms are tiled 64 x 64, as the forward tiles them: the
//     Q x Q matrices do not fit in shared memory at Q = 256.
//
// Built by kernels/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).  The inputs are
// contiguous: kernels/ssd_scan/ssd_scan.py copies the mixer's views.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;                               // 16 x 16 threads over a tile
constexpr int kTile = 64;                               // tokens of a pair tile
constexpr int kLd = kTile + 1;                          // padded token row of a k-major tile
constexpr int kPer = kTile / kGrid;                     // 4 x 4 pairs a thread
constexpr int kSumTile = 32;                            // tokens a step of the chunk sums
constexpr int kStage = 32;                              // h0 / G rows staged at a time
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kMaxU = kMaxP / kGrid;                    // p-columns of a thread (dx~)
constexpr int kMaxV = kMaxN / kGrid;                    // n-columns of a thread (dB, dC)
constexpr int kSumV = 8;                                // n-columns a pass of the chunk sums
constexpr int kMaxSmem = 232448;                        // 227 KB, H100

struct Dims {
  int S, H, P, G, N, Q, nc, rep, ntiles;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);                           // round to nearest even
}

// Sum over the 16 lanes of a half warp (tx = lane % 16), the same order on
// every call; every lane of the half gets the sum.
template <typename F>
__device__ __forceinline__ F half_warp_sum(F v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared bytes of launch 1 (chunk sums) and of launches 3 and 4 (rows and
// columns, one layout).
__host__ __device__ __forceinline__ long long sums_smem(int P, int N, int Q) {
  return 8LL * Q + 4LL * kSumTile * (2LL * P + 2LL * N);
}
__host__ __device__ __forceinline__ long long tile_smem(int P, int N, int Q) {
  return 8LL * Q + 4LL * kLd * (2LL * N + 2LL * P + kTile);
}

struct Tok {                                            // offsets of token t0 of (b, h)
  long long x, bc, dt, cum;
};

__device__ __forceinline__ Tok token_base(const Dims& d, int b, int hh, int t0) {
  const int g = hh / d.rep;
  Tok o;
  o.x = (static_cast<long long>(b) * d.S + t0) * d.H * d.P + static_cast<long long>(hh) * d.P;
  o.bc = (static_cast<long long>(b) * d.S + t0) * d.G * d.N + static_cast<long long>(g) * d.N;
  o.dt = (static_cast<long long>(b) * d.S + t0) * d.H + hh;
  o.cum = (static_cast<long long>(b) * d.H + hh) * d.S + t0;
  return o;
}

// ---- 1. chunk sums -------------------------------------------------------
// S[p][n] = Σ_j Xs[j][p] Bs[j][n] and D[p][n] = Σ_i Ys[i][p] Cs[i][n] as two
// products over the chunk's tokens; a thread holds 4 p-rows x 8 n-columns
// of each (p = ty + 16u, n = tx + 16v), passes over 64-row and 128-column
// blocks of the outputs.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_chunk_sums(const T* __restrict__ xh, const float* __restrict__ dt,
               const float* __restrict__ A_log, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const T* __restrict__ dy,
               double* __restrict__ cum_out, float* __restrict__ hsum,
               float* __restrict__ gsum, Dims d) {
  extern __shared__ double smem[];
  const int P = d.P, N = d.N, Q = d.Q;
  double* cum = smem;                                   // [Q]
  float* Xs = reinterpret_cast<float*>(cum + Q);        // [kSumTile][P] exp(cum_Q - cum_j) x~_j
  float* Bs = Xs + kSumTile * P;                        // [kSumTile][N] B_j
  float* Ys = Bs + kSumTile * N;                        // [kSumTile][P] exp(cum_i) dy_i
  float* Cs = Ys + kSumTile * P;                        // [kSumTile][N] C_i
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int ty = tid / kGrid, tx = tid % kGrid;
  const int t0 = c * Q;
  const Tok o = token_base(d, b, hh, t0);
  const long long xs = static_cast<long long>(d.H) * P, bs = static_cast<long long>(d.G) * N;
  const float A = -expf(A_log[hh]);
  for (int i = tid; i < Q; i += kThreads) cum[i] = static_cast<double>(A) * dt[o.dt + static_cast<long long>(i) * d.H];
  __syncthreads();
  if (tid == 0) {
    double run = 0.0;
    for (int i = 0; i < Q; ++i) {
      run += cum[i];
      cum[i] = run;
    }
  }
  __syncthreads();
  for (int i = tid; i < Q; i += kThreads) cum_out[o.cum + i] = cum[i];
  const double total = cum[Q - 1];
  const long long ob = ((static_cast<long long>(b) * d.H + hh) * d.nc + c) * P * N;
  for (int p0 = 0; p0 < P; p0 += kGrid * kPer) {
    for (int n0 = 0; n0 < N; n0 += kGrid * kSumV) {
      float as[kPer][kSumV], ag[kPer][kSumV];
#pragma unroll
      for (int u = 0; u < kPer; ++u)
#pragma unroll
        for (int v = 0; v < kSumV; ++v) as[u][v] = ag[u][v] = 0.f;
      for (int j0 = 0; j0 < Q; j0 += kSumTile) {
        const int nj = min(kSumTile, Q - j0);
        __syncthreads();                                // the previous step is done with the tiles
        for (int e = tid; e < nj * P; e += kThreads) {
          const int r = e / P, p = e - r * P, t = j0 + r;
          const long long at = o.x + t * xs + p;
          const float w = expf(static_cast<float>(total - cum[t])) * dt[o.dt + static_cast<long long>(t) * d.H];
          Xs[r * P + p] = w * to_f32(xh[at]);
          Ys[r * P + p] = expf(static_cast<float>(cum[t])) * to_f32(dy[at]);
        }
        for (int e = tid; e < nj * N; e += kThreads) {
          const int r = e / N, n = e - r * N;
          const long long at = o.bc + (j0 + r) * bs + n;
          Bs[r * N + n] = to_f32(Bm[at]);
          Cs[r * N + n] = to_f32(Cm[at]);
        }
        __syncthreads();
        for (int j = 0; j < nj; ++j) {
          float xa[kPer], ya[kPer], bb[kSumV], cb[kSumV];
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int p = p0 + ty + kGrid * u;
            xa[u] = p < P ? Xs[j * P + p] : 0.f;
            ya[u] = p < P ? Ys[j * P + p] : 0.f;
          }
#pragma unroll
          for (int v = 0; v < kSumV; ++v) {
            const int n = n0 + tx + kGrid * v;
            bb[v] = n < N ? Bs[j * N + n] : 0.f;
            cb[v] = n < N ? Cs[j * N + n] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kPer; ++u)
#pragma unroll
            for (int v = 0; v < kSumV; ++v) {
              as[u][v] = fmaf(xa[u], bb[v], as[u][v]);
              ag[u][v] = fmaf(ya[u], cb[v], ag[u][v]);
            }
        }
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u)
#pragma unroll
        for (int v = 0; v < kSumV; ++v) {
          const int p = p0 + ty + kGrid * u, n = n0 + tx + kGrid * v;
          if (p < P && n < N) {
            hsum[ob + static_cast<long long>(p) * N + n] = as[u][v];
            gsum[ob + static_cast<long long>(p) * N + n] = ag[u][v];
          }
        }
    }
  }
}

// ---- 2. state passes -----------------------------------------------------
__global__ void __launch_bounds__(kThreads)
bwd_state_passes(const double* __restrict__ cum, float* __restrict__ hbuf,
                 float* __restrict__ gbuf, const float* __restrict__ dstate, Dims d) {
  const int hh = blockIdx.y, b = blockIdx.z;
  const int PN = d.P * d.N;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PN) return;
  const double* cg = cum + (static_cast<long long>(b) * d.H + hh) * d.S;
  const long long base = (static_cast<long long>(b) * d.H + hh) * d.nc * PN + e;
  float h = 0.f;                                        // h0 of chunk c, then c+1
  for (int c = 0; c < d.nc; ++c) {
    const float decay = expf(static_cast<float>(cg[c * d.Q + d.Q - 1]));
    float* at = hbuf + base + static_cast<long long>(c) * PN;
    const float s = *at;
    *at = h;
    h = fmaf(decay, h, s);
  }
  float g = dstate ? dstate[(static_cast<long long>(b) * d.H + hh) * PN + e] : 0.f;
  for (int c = d.nc - 1; c >= 0; --c) {                 // G at chunk c's end
    const float decay = expf(static_cast<float>(cg[c * d.Q + d.Q - 1]));
    float* at = gbuf + base + static_cast<long long>(c) * PN;
    const float s = *at;
    *at = g;
    g = fmaf(decay, g, s);
  }
}

// The shared tiles of launches 3 and 4, each k-major: [width][64 tokens + 1].
struct Tiles {
  double* cum;   // [Q]
  float* Ct;     // [N][kLd]  C of tile I (rows) / of tile I (columns); G rows staged
  float* Bt;     // [N][kLd]  B of tile J; h0 rows staged (rows)
  float* Yt;     // [P][kLd]  dy of tile I
  float* Xt;     // [P][kLd]  x~ of tile J
  float* Wt;     // [64][kLd] a weight of each pair, k-major over the product's k
};

__device__ __forceinline__ Tiles carve(double* smem, int P, int N, int Q) {
  Tiles s;
  s.cum = smem;
  s.Ct = reinterpret_cast<float*>(smem + Q);
  s.Bt = s.Ct + N * kLd;
  s.Yt = s.Bt + N * kLd;
  s.Xt = s.Yt + P * kLd;
  s.Wt = s.Xt + P * kLd;
  return s;
}

// Tokens [0, 64) of a [tokens, width] slice (token stride `ts`, from `src`)
// into a k-major [width][kLd] tile, times `scale` (1 if null, else
// scale[token stride `ss`]); zero past nr.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ts, int width,
                                          int nr, const float* scale, long long ss) {
  for (int e = threadIdx.x; e < kTile * width; e += kThreads) {
    const int r = e / width, q = e - r * width;
    float v = 0.f;
    if (r < nr) {
      v = to_f32(src[r * ts + q]);
      if (scale) v *= scale[r * ss];
    }
    dst[q * kLd + r] = v;
  }
}

// acc[u][v] += Σ_k A[k][a0 + 16u] · B[k][b0 + 16v] over k < depth, for k-major
// tiles A and B of row length kLd.
__device__ __forceinline__ void pair_products(float (&acc)[kPer][kPer], const float* A,
                                              const float* B, int depth, int a0, int b0) {
  for (int k = 0; k < depth; ++k) {
    float a[kPer], bv[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) a[u] = A[k * kLd + a0 + kGrid * u];
#pragma unroll
    for (int v = 0; v < kPer; ++v) bv[v] = B[k * kLd + b0 + kGrid * v];
#pragma unroll
    for (int u = 0; u < kPer; ++u)
#pragma unroll
      for (int v = 0; v < kPer; ++v) acc[u][v] = fmaf(a[u], bv[v], acc[u][v]);
  }
}

// acc[u][v] += Σ_k W[k][m0 + 16u] · Z(k, q0 + 16v) over k < depth, with W a
// k-major [depth][kLd] tile and Z(k, q) = Zt[q * ldz + k] (the k-major tile
// of the other operand, read across), q < width.
template <int V>
__device__ __forceinline__ void tile_products(float (&acc)[kPer][V], const float* W,
                                              const float* Zt, int ldz, int depth, int width,
                                              int m0, int q0) {
  for (int k = 0; k < depth; ++k) {
    float a[kPer], z[V];
#pragma unroll
    for (int u = 0; u < kPer; ++u) a[u] = W[k * kLd + m0 + kGrid * u];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int q = q0 + kGrid * v;
      z[v] = q < width ? Zt[q * ldz + k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[u][v] = fmaf(a[u], z[v], acc[u][v]);
  }
}

// ---- 3. rows: dC and the row sums of M, plus u ---------------------------
// A thread holds rows i = ty + 16u of the tile: their dC at n = tx + 16v
// (v < V, V = 8 for N <= 128, else 16), and, in tx == 0, their row sums.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bwd_chunk_rows(const T* __restrict__ xh, const float* __restrict__ dt,
               const T* __restrict__ Bm, const T* __restrict__ Cm,
               const T* __restrict__ dy, const double* __restrict__ cum_g,
               const float* __restrict__ h0buf, float* __restrict__ dC_part,
               double* __restrict__ row_out, Dims d) {
  extern __shared__ double smem[];
  const int P = d.P, N = d.N, Q = d.Q;
  const Tiles s = carve(smem, P, N, Q);
  const int c = blockIdx.x / d.ntiles, it = blockIdx.x - c * d.ntiles;
  const int hh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int ty = tid / kGrid, tx = tid % kGrid;
  const int t0 = c * Q, i0 = it * kTile, ni = min(kTile, Q - i0);
  const Tok o = token_base(d, b, hh, t0);
  const long long xs = static_cast<long long>(d.H) * P, bs = static_cast<long long>(d.G) * N;
  for (int i = tid; i < Q; i += kThreads) s.cum[i] = cum_g[o.cum + i];
  load_tile(s.Ct, Cm + o.bc + i0 * bs, bs, N, ni, static_cast<const float*>(nullptr), 0);
  load_tile(s.Yt, dy + o.x + i0 * xs, xs, P, ni, static_cast<const float*>(nullptr), 0);

  // inter: acc(i, n) = exp(cum_i) Σ_p dy_i[p] h0[p][n], h0 staged kStage rows at a time in Bt
  float acc[kPer][V];
#pragma unroll
  for (int u = 0; u < kPer; ++u)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[u][v] = 0.f;
  const float* h0 = h0buf + ((static_cast<long long>(b) * d.H + hh) * d.nc + c) * P * N;
  for (int p0 = 0; p0 < P; p0 += kStage) {
    const int np = min(kStage, P - p0);
    __syncthreads();
    for (int e = tid; e < np * N; e += kThreads) {
      const int r = e / N, n = e - r * N;
      s.Bt[n * (kStage + 1) + r] = h0[static_cast<long long>(p0 + r) * N + n];
    }
    __syncthreads();
    tile_products<V>(acc, s.Yt + p0 * kLd, s.Bt, kStage + 1, np, N, ty, tx);
  }
  double rowacc[kPer];                                  // row sums (fp64), kept in tx == 0
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = ty + kGrid * u;
    const float e = i < ni ? expf(static_cast<float>(s.cum[i0 + i])) : 0.f;
    double part = 0.0;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int n = tx + kGrid * v;
      acc[u][v] *= e;
      if (n < N) part += static_cast<double>(s.Ct[n * kLd + i] * acc[u][v]);
    }
    rowacc[u] = half_warp_sum(part);                    // u_i
  }

  // intra: tiles J <= I
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile, nj = min(kTile, Q - j0);
    __syncthreads();                                    // Bt, Xt, Wt free
    load_tile(s.Bt, Bm + o.bc + j0 * bs, bs, N, nj, static_cast<const float*>(nullptr), 0);
    load_tile(s.Xt, xh + o.x + j0 * xs, xs, P, nj, dt + o.dt + static_cast<long long>(j0) * d.H,
              d.H);
    __syncthreads();
    float sc[kPer][kPer] = {}, rc[kPer][kPer] = {};
    pair_products(sc, s.Ct, s.Bt, N, ty, tx);           // C_i·B_j
    pair_products(rc, s.Yt, s.Xt, P, ty, tx);           // dy_i·x~_j
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = ty + kGrid * u;
      double msum = 0.0;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int j = tx + kGrid * v;
        float w = 0.f;
        if (i < ni && j < nj && j0 + j <= i0 + i) {
          w = expf(static_cast<float>(s.cum[i0 + i] - s.cum[j0 + j])) * rc[u][v];
          if (j0 + j < i0 + i) msum += static_cast<double>(w * sc[u][v]);
        }
        s.Wt[j * kLd + i] = w;
      }
      rowacc[u] += half_warp_sum(msum);
    }
    __syncthreads();
    tile_products<V>(acc, s.Wt, s.Bt, kLd, nj, N, ty, tx);   // dC(i, n) += Σ_j W_ij B_j[n]
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = ty + kGrid * u;
    if (i >= ni) continue;
    const long long row = ((static_cast<long long>(b) * d.S + t0 + i0 + i) * d.H + hh) * N;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int n = tx + kGrid * v;
      if (n < N) dC_part[row + n] = acc[u][v];
    }
    if (tx == 0) row_out[o.cum + i0 + i] = rowacc[u];
  }
}

// ---- 4. columns: dx~ (dxh, <x, dx~>), dB, the column sums of M, and v ----
// In the pair products a thread holds i = tx + 16u, j = ty + 16v (column
// sums over the half warp); in the outputs rows j = ty + 16u of the tile:
// dx~ at p = tx + 16w (w < U, U = 4 for P <= 64, else 8), dB at n = tx +
// 16v (v < V), and, in tx == 0, the sums.
template <typename T, int U, int V>
__global__ void __launch_bounds__(kThreads)
bwd_chunk_cols(const T* __restrict__ xh, const float* __restrict__ dt,
               const T* __restrict__ Bm, const T* __restrict__ Cm,
               const T* __restrict__ dy, const double* __restrict__ cum_g,
               const float* __restrict__ gbuf, T* __restrict__ dxh,
               float* __restrict__ dB_part, double* __restrict__ col_out,
               double* __restrict__ v_out, float* __restrict__ xdx_out, Dims d) {
  extern __shared__ double smem[];
  const int P = d.P, N = d.N, Q = d.Q;
  const Tiles s = carve(smem, P, N, Q);
  const int c = blockIdx.x / d.ntiles, jt = blockIdx.x - c * d.ntiles;
  const int hh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int ty = tid / kGrid, tx = tid % kGrid;
  const int t0 = c * Q, j0 = jt * kTile, nj = min(kTile, Q - j0);
  const Tok o = token_base(d, b, hh, t0);
  const long long xs = static_cast<long long>(d.H) * P, bs = static_cast<long long>(d.G) * N;
  for (int i = tid; i < Q; i += kThreads) s.cum[i] = cum_g[o.cum + i];
  load_tile(s.Bt, Bm + o.bc + j0 * bs, bs, N, nj, static_cast<const float*>(nullptr), 0);
  load_tile(s.Xt, xh + o.x + j0 * xs, xs, P, nj, dt + o.dt + static_cast<long long>(j0) * d.H, d.H);

  // inter: ax(j, p) = Σ_n G[p][n] B_j[n] and ab(j, n) = Σ_p x~_j[p] G[p][n],
  // G staged kStage rows at a time in Ct, k-major over p ([n][row])
  float ax[kPer][U], ab[kPer][V];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
#pragma unroll
    for (int w = 0; w < U; ++w) ax[u][w] = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) ab[u][v] = 0.f;
  }
  const float* G = gbuf + ((static_cast<long long>(b) * d.H + hh) * d.nc + c) * P * N;
  float* Gk = s.Ct;                                     // [n][kStage+1]
  for (int p0 = 0; p0 < P; p0 += kStage) {
    const int np = min(kStage, P - p0);
    __syncthreads();
    for (int e = tid; e < np * N; e += kThreads) {
      const int r = e / N, n = e - r * N;
      Gk[n * (kStage + 1) + r] = G[static_cast<long long>(p0 + r) * N + n];
    }
    __syncthreads();
    tile_products<V>(ab, s.Xt + p0 * kLd, Gk, kStage + 1, np, N, ty, tx);
    // ax(j, p) for p in [p0, p0 + np): Σ_n B_j[n] G[p][n]
    for (int n = 0; n < N; ++n) {
      float bj[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) bj[u] = s.Bt[n * kLd + ty + kGrid * u];
#pragma unroll
      for (int w = 0; w < U; ++w) {
        const int p = tx + kGrid * w;
        if (p >= p0 && p < p0 + np) {
          const float g = Gk[n * (kStage + 1) + p - p0];
#pragma unroll
          for (int u = 0; u < kPer; ++u) ax[u][w] = fmaf(bj[u], g, ax[u][w]);
        }
      }
    }
  }
  const double total = s.cum[Q - 1];
  double colacc[kPer], vsum[kPer];                      // fp64, kept in tx == 0
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = ty + kGrid * u;
    const float e = j < nj ? expf(static_cast<float>(total - s.cum[j0 + j])) : 0.f;
    double part = 0.0;
#pragma unroll
    for (int w = 0; w < U; ++w) {
      const int p = tx + kGrid * w;
      ax[u][w] *= e;
      if (p < P) part += static_cast<double>(s.Xt[p * kLd + j] * ax[u][w]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) ab[u][v] *= e;
    vsum[u] = half_warp_sum(part);
    colacc[u] = 0.0;
  }

  // intra: tiles I >= J
  for (int it = jt; it < d.ntiles; ++it) {
    const int i0 = it * kTile, ni = min(kTile, Q - i0);
    __syncthreads();                                    // Ct, Yt, Wt free
    load_tile(s.Ct, Cm + o.bc + i0 * bs, bs, N, ni, static_cast<const float*>(nullptr), 0);
    load_tile(s.Yt, dy + o.x + i0 * xs, xs, P, ni, static_cast<const float*>(nullptr), 0);
    __syncthreads();
    float sc[kPer][kPer] = {}, rc[kPer][kPer] = {};
    pair_products(sc, s.Ct, s.Bt, N, tx, ty);           // [u: i = tx + 16u][v: j = ty + 16v]
    pair_products(rc, s.Yt, s.Xt, P, tx, ty);
    double msum[kPer] = {};
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tx + kGrid * u;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int j = ty + kGrid * v;
        float w1 = 0.f, w2 = 0.f;
        if (i < ni && j < nj && j0 + j <= i0 + i) {
          const float L = expf(static_cast<float>(s.cum[i0 + i] - s.cum[j0 + j]));
          w1 = L * sc[u][v];
          w2 = L * rc[u][v];
          if (j0 + j < i0 + i) msum[v] += static_cast<double>(w1 * rc[u][v]);
        }
        s.Wt[i * kLd + j] = w1;
        rc[u][v] = w2;                                  // kept for dB
      }
    }
#pragma unroll
    for (int v = 0; v < kPer; ++v) colacc[v] += half_warp_sum(msum[v]);
    __syncthreads();
    tile_products<U>(ax, s.Wt, s.Yt, kLd, ni, P, ty, tx);    // dx~(j, p) += Σ_i W1_ij dy_i[p]
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u)
#pragma unroll
      for (int v = 0; v < kPer; ++v) s.Wt[(tx + kGrid * u) * kLd + ty + kGrid * v] = rc[u][v];
    __syncthreads();
    tile_products<V>(ab, s.Wt, s.Ct, kLd, ni, N, ty, tx);    // dB(j, n) += Σ_i W2_ij C_i[n]
  }

  // outputs: dxh = dt·dx~, <x, dx~>, dB partials, the sums
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = ty + kGrid * u;
    float part = 0.f;
    if (j < nj) {
      const float dtj = dt[o.dt + static_cast<long long>(j0 + j) * d.H];
#pragma unroll
      for (int w = 0; w < U; ++w) {
        const int p = tx + kGrid * w;
        if (p < P) {
          const long long at = o.x + (j0 + j) * xs + p;
          part = fmaf(to_f32(xh[at]), ax[u][w], part);
          dxh[at] = from_f32<T>(dtj * ax[u][w]);
        }
      }
      const long long row = ((static_cast<long long>(b) * d.S + t0 + j0 + j) * d.H + hh) * N;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int n = tx + kGrid * v;
        if (n < N) dB_part[row + n] = ab[u][v];
      }
    }
    part = half_warp_sum(part);
    if (j < nj && tx == 0) {
      xdx_out[o.cum + j0 + j] = part;
      v_out[o.cum + j0 + j] = vsum[u];
    }
  }
  // column sums: colacc[v] holds column j = ty + 16v in every lane of the half warp
#pragma unroll
  for (int v = 0; v < kPer; ++v) {
    const int j = ty + kGrid * v;
    if (j < nj && tx == 0) col_out[o.cum + j0 + j] = colacc[v];
  }
}

// ---- 5. finalize: da, ddt, the chunk's part of dA_log --------------------
__global__ void __launch_bounds__(kThreads)
bwd_chunk_finalize(const float* __restrict__ dt, const float* __restrict__ A_log,
                   const double* __restrict__ cum_g, const float* __restrict__ h0buf,
                   const float* __restrict__ gbuf, const double* __restrict__ row,
                   const double* __restrict__ col, const double* __restrict__ v,
                   const float* __restrict__ xdx, float* __restrict__ ddt,
                   double* __restrict__ dA_part, Dims d) {
  extern __shared__ double da[];                        // [Q]
  __shared__ double red[kThreads];
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int Q = d.Q, PN = d.P * d.N;
  const Tok o = token_base(d, b, hh, c * Q);
  const long long sb = ((static_cast<long long>(b) * d.H + hh) * d.nc + c) * PN;
  double part = 0.0;
  for (int e = tid; e < PN; e += kThreads)
    part += static_cast<double>(h0buf[sb + e]) * static_cast<double>(gbuf[sb + e]);
  red[tid] = part;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  const float A = -expf(A_log[hh]);
  if (tid == 0) {
    const double c0 = exp(cum_g[o.cum + Q - 1]) * red[0];
    double run = 0.0;
    for (int t = Q - 1; t >= 0; --t) {
      run += row[o.cum + t] - col[o.cum + t];
      da[t] = run;
    }
    double below = 0.0, dA = 0.0;
    for (int t = 0; t < Q; ++t) {
      da[t] += below + c0;
      below += v[o.cum + t];
      dA += static_cast<double>(A * dt[o.dt + static_cast<long long>(t) * d.H]) * da[t];
    }
    dA_part[(static_cast<long long>(b) * d.H + hh) * d.nc + c] = dA;
  }
  __syncthreads();
  for (int t = tid; t < Q; t += kThreads)
    ddt[o.dt + static_cast<long long>(t) * d.H] = xdx[o.cum + t] + A * static_cast<float>(da[t]);
}

// ---- 6. group sums of dB and dC ------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_group_sums(const float* __restrict__ dB_part, const float* __restrict__ dC_part,
               T* __restrict__ dBm, T* __restrict__ dCm, long long count, Dims d) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= count) return;
  const int n = static_cast<int>(e % d.N);
  const long long rest = e / d.N;
  const int g = static_cast<int>(rest % d.G);
  const long long bt = rest / d.G;                      // b·S + t
  const long long base = (bt * d.H + static_cast<long long>(g) * d.rep) * d.N + n;
  float sb = 0.f, sc = 0.f;
  for (int r = 0; r < d.rep; ++r) {
    sb += dB_part[base + static_cast<long long>(r) * d.N];
    sc += dC_part[base + static_cast<long long>(r) * d.N];
  }
  dBm[e] = from_f32<T>(sb);
  dCm[e] = from_f32<T>(sc);
}

// ---- 7. dA_log ------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
bwd_dA_log(const double* __restrict__ dA_part, float* __restrict__ dA_log, int batch, Dims d) {
  for (int hh = threadIdx.x; hh < d.H; hh += kThreads) {
    double acc = 0.0;
    for (int b = 0; b < batch; ++b)
      for (int c = 0; c < d.nc; ++c) acc += dA_part[(static_cast<long long>(b) * d.H + hh) * d.nc + c];
    dA_log[hh] = static_cast<float>(acc);
  }
}

// Launches 3 and 4 at register widths U (p-columns) and V (n-columns).
template <typename T, int U, int V>
cudaError_t launch_tiles(const T* x, const float* dtp, const T* Bp, const T* Cp, const T* dyp,
                         const double* cump, const float* hp, const float* gp, void* dxh,
                         void* dB_part, void* dC_part, void* row, void* col, void* v, void* xdx,
                         dim3 tiles, long long smem, const Dims& d, cudaStream_t stream) {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_chunk_rows<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_chunk_cols<T, U, V>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  bwd_chunk_rows<T, V><<<tiles, kThreads, smem, stream>>>(x, dtp, Bp, Cp, dyp, cump, hp,
                                                         static_cast<float*>(dC_part),
                                                         static_cast<double*>(row), d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_chunk_cols<T, U, V><<<tiles, kThreads, smem, stream>>>(
      x, dtp, Bp, Cp, dyp, cump, gp, static_cast<T*>(dxh), static_cast<float*>(dB_part),
      static_cast<double*>(col), static_cast<double*>(v), static_cast<float*>(xdx), d);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* xh, const void* dt, const void* A_log, const void* Bm, const void* Cm,
           const void* dy, const void* dstate, void* dxh, void* ddt, void* dA_log, void* dBm,
           void* dCm, void* cum, void* hbuf, void* gbuf, void* dB_part, void* dC_part,
           void* row, void* col, void* v, void* xdx, void* dA_part, int batch, const Dims& d,
           cudaStream_t stream) {
  const long long s1 = sums_smem(d.P, d.N, d.Q), s34 = tile_smem(d.P, d.N, d.Q);
  const long long s5 = 8LL * d.Q;
  if (s1 > kMaxSmem || s34 > kMaxSmem || s5 + 8LL * kThreads > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_chunk_sums<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(s1))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_chunk_finalize, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(s5))) != cudaSuccess)
    return static_cast<int>(err);
  const T* x = static_cast<const T*>(xh);
  const T* Bp = static_cast<const T*>(Bm);
  const T* Cp = static_cast<const T*>(Cm);
  const T* dyp = static_cast<const T*>(dy);
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A_log);
  double* cump = static_cast<double*>(cum);
  float* hp = static_cast<float*>(hbuf);
  float* gp = static_cast<float*>(gbuf);
  const dim3 chunks(d.nc, d.H, batch), tiles(d.nc * d.ntiles, d.H, batch);
  const dim3 elems((d.P * d.N + kThreads - 1) / kThreads, d.H, batch);

  bwd_chunk_sums<T><<<chunks, kThreads, s1, stream>>>(x, dtp, Ap, Bp, Cp, dyp, cump, hp, gp, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_state_passes<<<elems, kThreads, 0, stream>>>(cump, hp, gp, static_cast<const float*>(dstate), d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const bool wide_p = d.P > kGrid * kMaxU / 2, wide_n = d.N > kGrid * kMaxV / 2;
  err = wide_n ? (wide_p ? launch_tiles<T, kMaxU, kMaxV>(x, dtp, Bp, Cp, dyp, cump, hp, gp, dxh,
                                                        dB_part, dC_part, row, col, v, xdx,
                                                        tiles, s34, d, stream)
                         : launch_tiles<T, kMaxU / 2, kMaxV>(x, dtp, Bp, Cp, dyp, cump, hp, gp,
                                                            dxh, dB_part, dC_part, row, col, v,
                                                            xdx, tiles, s34, d, stream))
               : (wide_p ? launch_tiles<T, kMaxU, kMaxV / 2>(x, dtp, Bp, Cp, dyp, cump, hp, gp,
                                                            dxh, dB_part, dC_part, row, col, v,
                                                            xdx, tiles, s34, d, stream)
                         : launch_tiles<T, kMaxU / 2, kMaxV / 2>(x, dtp, Bp, Cp, dyp, cump, hp,
                                                                gp, dxh, dB_part, dC_part, row,
                                                                col, v, xdx, tiles, s34, d,
                                                                stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_chunk_finalize<<<chunks, kThreads, s5, stream>>>(
      dtp, Ap, cump, hp, gp, static_cast<const double*>(row), static_cast<const double*>(col),
      static_cast<const double*>(v), static_cast<const float*>(xdx), static_cast<float*>(ddt),
      static_cast<double*>(dA_part), d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long count = static_cast<long long>(batch) * d.S * d.G * d.N;
  bwd_group_sums<T><<<static_cast<unsigned>((count + kThreads - 1) / kThreads), kThreads, 0,
                      stream>>>(static_cast<const float*>(dB_part),
                                static_cast<const float*>(dC_part), static_cast<T*>(dBm),
                                static_cast<T*>(dCm), count, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dA_log<<<1, kThreads, 0, stream>>>(static_cast<const double*>(dA_part),
                                         static_cast<float*>(dA_log), batch, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared bytes of the chunk-sum launch, of the row and column launches, and
// of the finalize launch (dynamic part) into out[0..3).
extern "C" void arcadia_ssd_scan_bwd_plan(int headdim, int dstate, int chunk, long long* out) {
  out[0] = sums_smem(headdim, dstate, chunk);
  out[1] = tile_smem(headdim, dstate, chunk);
  out[2] = 8LL * chunk;
}

// Gradient of the SSD scan.  Contiguous xh and dy [batch, seqlen, heads,
// headdim], dt [batch, seqlen, heads] fp32, A_log [heads] fp32, Bm and Cm
// [batch, seqlen, groups, dstate], d(final state) [batch, heads, headdim,
// dstate] fp32 or null; outputs dxh (xh's shape and dtype), ddt (dt's), dA_log
// [heads] fp32, dBm and dCm (Bm's); scratch allocated by the caller: cum
// [batch, heads, seqlen] fp64, hbuf and gbuf [batch, heads, seqlen/chunk,
// headdim, dstate] fp32, dB_part and dC_part [batch, seqlen, heads, dstate]
// fp32, row, col and v [batch, heads, seqlen] fp64, xdx the same in fp32,
// dA_part [batch, heads, seqlen/chunk] fp64.  dtype: 0 for fp32
// xh/Bm/Cm/dy, 1 for bf16.
// Launches seven kernels on `stream`, does not synchronise, and returns the
// first cudaError_t (0 on success).
extern "C" int arcadia_ssd_scan_bwd(const void* xh, const void* dt, const void* A_log,
                                    const void* Bm, const void* Cm, const void* dy,
                                    const void* dstate, void* dxh, void* ddt, void* dA_log,
                                    void* dBm, void* dCm, void* cum, void* hbuf, void* gbuf,
                                    void* dB_part, void* dC_part, void* row, void* col, void* v,
                                    void* xdx, void* dA_part, int batch, int seqlen, int heads,
                                    int headdim, int groups, int dstate_dim, int chunk, int dtype,
                                    void* stream) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || headdim <= 0 || groups <= 0 ||
      dstate_dim <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (seqlen % chunk || heads % groups || headdim > kMaxP || dstate_dim > kMaxN ||
      heads > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = seqlen / chunk;
  const int ntiles = (chunk + kTile - 1) / kTile;
  if (static_cast<long long>(nc) * ntiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  Dims d{seqlen, heads, headdim, groups, dstate_dim, chunk, nc, heads / groups, ntiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xh, dt, A_log, Bm, Cm, dy, dstate, dxh, ddt, dA_log, dBm, dCm, cum, hbuf,
                         gbuf, dB_part, dC_part, row, col, v, xdx, dA_part, batch, d, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xh, dt, A_log, Bm, Cm, dy, dstate, dxh, ddt, dA_log, dBm, dCm,
                                 cum, hbuf, gbuf, dB_part, dC_part, row, col, v, xdx, dA_part,
                                 batch, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
