// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` of the JAX package
// (src/repro/kernels/ssd_scan/ssd_scan.py), launched there by `ssd_pallas`.
// Per (batch b, head h), with group g = h / (H/G), a_t = -exp(A_log[h])·dt_t
// and the chunks of Q tokens walked in order, it computes for each chunk
//
//     cum_i  = Σ_{k≤i} a_k                       (inclusive, within the chunk)
//     y_i    = Σ_{j≤i} exp(cum_i - cum_j) (C_i·B_j) x_j dt_j      [intra]
//            + exp(cum_i) C_i · h                                  [inter]
//     h     <- exp(cum_Q) h + Σ_j exp(cum_Q - cum_j) (x_j dt_j) ⊗ B_j
//
// with h ∈ R^{P×N} the running state, zero at the first chunk; it writes
// y [B,S,H,P] in the inputs' dtype and the final h as state [B,H,P,N] fp32.
// The same function as the plain version in kernels/ssd_scan/ref.py.
//
// What bounds it.  At the serving shape of mamba2-130m (B=8, S=4096, H=24,
// P=64, N=128, Q=256) the scan does about Q²(N+P) + 4QNP ≈ 21 M operations
// per (b, h, chunk) — 64 GFLOP a launch — on 0.22 GB of bf16 inputs and
// outputs: on the tensor cores (989 TFLOP/s) and HBM (3.35 TB/s) both take
// about 0.065 ms, so the bound is set by operations and bytes together.
// This first kernel does its products on the CUDA cores in fp32 out of
// shared memory, so it is bound by shared-memory traffic far above either;
// wgmma and TMA are the next step.  What the design does:
//   * The chunk axis is a loop inside the block.  The TPU walked it as the
//     innermost grid axis and kept h in VMEM across grid steps; Hopper
//     blocks run in no order, so one block takes one (b, h) and keeps h
//     [P, N] fp32 (32 KB at P=64, N=128) in shared memory for the whole
//     sequence.  A __syncthreads() separates the rows that read h (inter
//     term) from its update.
//   * The Q×Q matrix does not fit.  Pallas formed (C·Bᵀ ∘ L) for the whole
//     chunk: 256 KB at Q=256 in fp32, over the 227 KB a block may use.  Here
//     the intra-chunk product is tiled as flash attention is: 64-row tiles
//     i, and for each the 64-column tiles j ≤ i, with y_i accumulated in
//     registers over the j tiles.  About 135 KB of dynamic shared memory at
//     the serving shape (set with cudaFuncSetAttribute).
//   * Mask before exp.  For j > i, cum_i - cum_j > 0 and its exp can
//     overflow; an inf times a 0 mask is NaN.  The kernel selects 0 for
//     j > i and never evaluates that exp.
//   * Inputs as they come.  The Pallas wrapper materialised x·dt, a and
//     fp32 copies of B and C in HBM.  This kernel reads xh, dt, A_log, Bm
//     and Cm in their own dtypes and forms a and x·dt on the fly; it
//     accumulates in fp32 and writes y in xh's dtype.
//   * Grouping.  Head h reads B and C of group h / (H/G) straight from the
//     [B,S,G,N] tensors; nothing is repeated in memory.
//   * Decay differences.  At Q=256 the cumulative log-decay reaches -100 to
//     -200, where an fp32 rounding is ~1e-5, and that error would enter
//     every decay exp(cum_i - cum_j) — most of all those of nearby tokens,
//     which carry most of y.  The kernel sums cum in fp64 (one thread, 256
//     adds a chunk, 2 KB of shared memory) and rounds each difference to
//     fp32 once, so its decays are as exact as fp32 allows.  The plain
//     version sums in fp32 and is the less exact of the two.
// Shared-memory tiles are padded to N+1 (and 64+1) floats a row, so the
// lanes of a warp that walk rows hit distinct banks.
//
// Built by kernels/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                                 // rows = columns of a tile
constexpr int kMaxP = 128;                                // largest head dim
constexpr int kYPerThread = kTile * kMaxP / kThreads;     // y accumulators a thread
constexpr int kMaxSmem = 232448;                          // 227 KB, H100

struct Dims {
  int S, H, P, G, N, Q, nc, rep;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);                             // round to nearest even
}

// In-place inclusive prefix sum of v[0..n) in fp64, in order, by one thread.
__device__ __forceinline__ void serial_inclusive_scan(double* v, int n) {
  double run = 0.0;
  for (int i = 0; i < n; ++i) {
    run += v[i];
    v[i] = run;
  }
}

// Shared memory of one block, in floats.
__host__ __device__ __forceinline__ long long smem_floats(int P, int N, int Q) {
  const long long ldn = N + 1;
  return 2LL * Q            // cum [Q], fp64
         + P * ldn          // h      [P][N+1]
         + Q                // dt [Q]
         + 2LL * kTile * ldn  // C tile, B tile [64][N+1]
         + 1LL * kTile * P    // x·dt tile [64][P]
         + kTile * (kTile + 1LL);  // masked C·Bᵀ tile [64][65]
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ xh, const float* __restrict__ dt,
                const float* __restrict__ A_log, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state_out, Dims d) {
  extern __shared__ double smem[];
  const int P = d.P, N = d.N, Q = d.Q;
  const int ldn = N + 1;
  constexpr int lds = kTile + 1;
  double* cum = smem;                 // cumulative log-decay of the chunk, fp64
  float* h_s = reinterpret_cast<float*>(cum + Q);  // running state h[p][n]
  float* dts = h_s + P * ldn;         // dt of the chunk
  float* Ct = dts + Q;                // C rows of tile i
  float* Bt = Ct + kTile * ldn;       // B rows of tile j
  float* Xt = Bt + kTile * ldn;       // x·dt rows of tile j
  float* St = Xt + kTile * P;         // masked, decayed C_i·B_j of tiles (i, j)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / d.H;
  const int hh = blockIdx.x - b * d.H;
  const int g = hh / d.rep;
  const float A = -expf(A_log[hh]);
  const long long x_tok = static_cast<long long>(d.H) * P;   // token stride of xh, y
  const long long bc_tok = static_cast<long long>(d.G) * N;  // token stride of Bm, Cm
  const long long x_base = static_cast<long long>(b) * d.S * x_tok + static_cast<long long>(hh) * P;
  const long long bc_base = static_cast<long long>(b) * d.S * bc_tok + static_cast<long long>(g) * N;
  const float* dtb = dt + static_cast<long long>(b) * d.S * d.H + hh;

  for (int e = tid; e < P * N; e += kThreads) h_s[(e / N) * ldn + e % N] = 0.f;

  for (int c = 0; c < d.nc; ++c) {
    const int t0 = c * Q;
    __syncthreads();                  // the previous chunk is done with cum, dts, h
    for (int i = tid; i < Q; i += kThreads) {
      const float v = dtb[static_cast<long long>(t0 + i) * d.H];
      dts[i] = v;
      cum[i] = static_cast<double>(A) * v;
    }
    __syncthreads();
    if (tid == 0) serial_inclusive_scan(cum, Q);
    __syncthreads();
    const double total = cum[Q - 1];

    // ---- y of the chunk, one 64-row tile i at a time ----
    for (int i0 = 0; i0 < Q; i0 += kTile) {
      const int ni = min(kTile, Q - i0);
      __syncthreads();                // the previous tile is done with Ct
      for (int e = tid; e < ni * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        Ct[r * ldn + n] = to_f32(Cm[bc_base + static_cast<long long>(t0 + i0 + r) * bc_tok + n]);
      }
      float acc[kYPerThread];
#pragma unroll
      for (int k = 0; k < kYPerThread; ++k) acc[k] = 0.f;

      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        const int nj = min(kTile, Q - j0);
        __syncthreads();              // the previous tile j is done with Bt, Xt, St
        for (int e = tid; e < nj * N; e += kThreads) {
          const int r = e / N, n = e - r * N;
          Bt[r * ldn + n] = to_f32(Bm[bc_base + static_cast<long long>(t0 + j0 + r) * bc_tok + n]);
        }
        for (int e = tid; e < nj * P; e += kThreads) {
          const int r = e / P, p = e - r * P;
          Xt[r * P + p] = to_f32(xh[x_base + static_cast<long long>(t0 + j0 + r) * x_tok + p]) * dts[j0 + r];
        }
        __syncthreads();
        // St[i][j] = exp(cum_i - cum_j) C_i·B_j for j <= i, else 0 (no exp)
        for (int e = tid; e < kTile * kTile; e += kThreads) {
          const int i = e / kTile, j = e - i * kTile;
          float s = 0.f;
          if (i < ni && j < nj && j0 + j <= i0 + i) {
            const float* ci = Ct + i * ldn;
            const float* bj = Bt + j * ldn;
            for (int n = 0; n < N; ++n) s = fmaf(ci[n], bj[n], s);
            s *= expf(static_cast<float>(cum[i0 + i] - cum[j0 + j]));
          }
          St[i * lds + j] = s;
        }
        __syncthreads();
        // y_i += St[i, :] · Xt
#pragma unroll
        for (int k = 0; k < kYPerThread; ++k) {
          const int e = tid + k * kThreads;
          const int i = e / P, p = e - i * P;
          if (i < ni) {
            const float* si = St + i * lds;
            float a = 0.f;
            for (int j = 0; j < nj; ++j) a = fmaf(si[j], Xt[j * P + p], a);
            acc[k] += a;
          }
        }
      }
      // y_i += exp(cum_i) C_i · h, with h the state at the chunk's start
#pragma unroll
      for (int k = 0; k < kYPerThread; ++k) {
        const int e = tid + k * kThreads;
        const int i = e / P, p = e - i * P;
        if (i < ni) {
          const float* ci = Ct + i * ldn;
          const float* hp = h_s + p * ldn;
          float a = 0.f;
          for (int n = 0; n < N; ++n) a = fmaf(ci[n], hp[n], a);
          const float v = acc[k] + expf(static_cast<float>(cum[i0 + i])) * a;
          y[x_base + static_cast<long long>(t0 + i0 + i) * x_tok + p] = from_f32<T>(v);
        }
      }
    }

    // ---- state update: every row has read the old h ----
    __syncthreads();
    const float decay = expf(static_cast<float>(total));
    for (int e = tid; e < P * N; e += kThreads) h_s[(e / N) * ldn + e % N] *= decay;
    for (int j0 = 0; j0 < Q; j0 += kTile) {
      const int nj = min(kTile, Q - j0);
      __syncthreads();                // Bt, Xt free
      for (int e = tid; e < nj * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        const float w = expf(static_cast<float>(total - cum[j0 + r]));
        Bt[r * ldn + n] = w * to_f32(Bm[bc_base + static_cast<long long>(t0 + j0 + r) * bc_tok + n]);
      }
      for (int e = tid; e < nj * P; e += kThreads) {
        const int r = e / P, p = e - r * P;
        Xt[r * P + p] = to_f32(xh[x_base + static_cast<long long>(t0 + j0 + r) * x_tok + p]) * dts[j0 + r];
      }
      __syncthreads();
      for (int e = tid; e < P * N; e += kThreads) {
        const int p = e / N, n = e - p * N;
        float a = 0.f;
        for (int j = 0; j < nj; ++j) a = fmaf(Xt[j * P + p], Bt[j * ldn + n], a);
        h_s[p * ldn + n] += a;        // one owner per element
      }
    }
  }

  __syncthreads();
  float* st = state_out + (static_cast<long long>(b) * d.H + hh) * P * N;
  for (int e = tid; e < P * N; e += kThreads) st[e] = h_s[(e / N) * ldn + e % N];
}

template <typename T>
int launch(const void* xh, const void* dt, const void* A_log, const void* Bm,
           const void* Cm, void* y, void* state, int batch, const Dims& d,
           cudaStream_t stream) {
  const long long bytes = smem_floats(d.P, d.N, d.Q) * static_cast<long long>(sizeof(float));
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(batch) * static_cast<unsigned>(d.H);
  ssd_scan_kernel<T><<<grid, kThreads, static_cast<size_t>(bytes), stream>>>(
      static_cast<const T*>(xh), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), static_cast<float*>(state), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// SSD scan of contiguous xh [batch, seqlen, heads, headdim], dt
// [batch, seqlen, heads] fp32, A_log [heads] fp32, Bm and Cm
// [batch, seqlen, groups, dstate] into y (xh's shape and dtype) and state
// [batch, heads, headdim, dstate] fp32, all allocated by the caller.
// dtype: 0 for fp32 xh/Bm/Cm/y, 1 for bf16.  chunk must divide seqlen and
// groups must divide heads.  Launches one kernel on `stream`, does not
// synchronise, and returns the cudaError_t of the launch (0 on success).
extern "C" int arcadia_ssd_scan(const void* xh, const void* dt, const void* A_log,
                                const void* Bm, const void* Cm, void* y, void* state,
                                int batch, int seqlen, int heads, int headdim,
                                int groups, int dstate, int chunk, int dtype,
                                void* stream) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || headdim <= 0 || groups <= 0 ||
      dstate <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (seqlen % chunk || heads % groups || headdim > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims d{seqlen, heads, headdim, groups, dstate, chunk, seqlen / chunk, heads / groups};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(xh, dt, A_log, Bm, Cm, y, state, batch, d, s);
  if (dtype == 1) return launch<__nv_bfloat16>(xh, dt, A_log, Bm, Cm, y, state, batch, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
