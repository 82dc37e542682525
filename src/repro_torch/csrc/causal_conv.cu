// Depthwise causal conv1d with its bias and SiLU, forward and gradient, for
// Hopper (sm_90a): the Mamba2 mixer's short convolution over its x, B and C
// columns.
//
// Replaces no TPU kernel: the JAX package computes `_causal_conv`
// (src/repro/models/layers.py) as W shifted products summed by XLA, which
// fuses them into one pass.  Eager PyTorch runs the same formula as a pad
// copy, W strided products, W - 1 adds, a bias add that widens the whole
// tensor to fp32, an fp32 SiLU and a cast back, and autograd differentiates
// each of those passes on its own.  For every output row t and channel c
//
//     pre[t, c] = b[c] + Σ_{i<W} w[i, c] · x[t - W + 1 + i, c]
//     out[t, c] = silu(pre[t, c]) = pre / (1 + exp(-pre))
//
// where x rows before 0 are the cached `state` rows (decode, chunked
// prefill) or zero.  The sum starts from the bias and is taken in fp32 with
// fused multiply-adds, the oldest tap first; the SiLU is fp32 and the
// result is rounded once to x's dtype.  kernels/causal_conv/ref.py
// (`causal_conv_fp32_reference`) is the plain version of this arithmetic.
//
// What bounds it.  W <= 4 multiply-adds an element against 2-4 bytes read
// and written: far below the card's ridge, so the time is bytes.  The
// forward's least traffic is one read of x and one write of out (0.235 GB
// at the mixer's 8 x 4096 x 1792 bf16: 0.070 ms at 3.35 TB/s); the
// gradient's is one read each of x and dy and one write of dx (0.105 ms).
//
// Design.  A block of 128 threads takes a tile of kTileL = 32 rows by one
// 128-byte line of channels (64 bf16, 32 fp32).  The tile's input rows and
// the W-1 rows before them land in shared memory in one pass of 16-byte
// loads, 8 threads to a line, every thread's loads issued before any is
// stored, so each block has its whole tile in flight at once; each thread
// then walks one channel down 16 (bf16) or 8 (fp32) rows with the taps,
// the bias and the last W-1 inputs in registers, and the tile leaves in
// 16-byte stores.  The W-1 halo rows a tile reads again were just read by
// the tile before it, from L2.  x is read through its batch and row
// strides with the channels contiguous: the mixer hands in the x, B and C
// columns of in_proj's output as they lie, with no copy.  Every row moves
// as 16-byte words: the channels come in whole groups of 8 (the wrapper
// refuses other counts) and pointers and strides are 16-byte multiples
// (the wrapper copies a view that is not; kernels/causal_conv/
// causal_conv.py).  On an H100 a thread that walked 8 channels down 32
// rows from registers (one 16-byte load a row) kept too few loads in
// flight at the registers it needed: 0.47 ms forward and 0.43 ms gradient
// at the mixer's shape, against 0.104 and 0.220 for the tiles.
//
// The gradient (`causal_conv_bwd_kernel`) takes the same tiles with x's
// halo on both sides (2(W - 1) rows) and dy's W-1 rows past the tile: it
// recomputes pre from x, w and b, forms g = dy · silu'(pre) in fp32 into
// shared memory and writes
//
//     dx[t, c] = Σ_{i<W} w[i, c] · g[t + W - 1 - i, c]    (g = 0 past the end)
//
// rounded once to x's dtype, contiguous.  dw[i, c] = Σ_t g[t, c] · x[t - W
// + 1 + i, c] and db[c] = Σ_t g[t, c] are summed in fp32 by each thread over
// its own rows, then over the block's threads of a channel in a fixed
// order, and written as one partial per (batch, tile); a second launch
// (`causal_conv_wsum_kernel`) adds the partials in a fixed order.  No
// atomics: two calls give the same bits.
//
// The sigmoid goes through __expf and __fdividef (a few fp32 ulps; the
// output is rounded to bf16 once after it).
//
// Built by kernels/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxWidth = 4;
constexpr int kThreads = 128;                    // threads a block
constexpr int kTileBytes = 128;                  // bytes of a tile row: one cache line
constexpr int kRowWords = kTileBytes / 16;       // 16-byte words of a tile row
constexpr int kRowsPerPass = kThreads / kRowWords;  // tile rows one pass of loads covers
constexpr int kTileL = 32;                       // rows a tile (and a gradient partial)
constexpr int kChannelMultiple = 8;              // channels come in whole 16-byte words
constexpr int kSumCols = 32;                     // wsum: columns a block
constexpr int kSumParts = 8;                     // wsum: partial slices a column
constexpr int kMaxGridYZ = 65535;

template <typename T>
constexpr int kElts = 16 / static_cast<int>(sizeof(T));          // channels a 16-byte word
template <typename T>
constexpr int kChan = kTileBytes / static_cast<int>(sizeof(T));  // channels a tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// One 16-byte word of a row: kElts channels as stored.
template <typename T>
struct alignas(16) Word {
  T v[kElts<T>];
};

template <typename T>
__device__ __forceinline__ Word<T> zero_word() {
  Word<T> r;
#pragma unroll
  for (int j = 0; j < kElts<T>; ++j) r.v[j] = from_f<T>(0.f);
  return r;
}

// The 16-byte word at p (16-byte aligned).
template <typename T>
__device__ __forceinline__ Word<T> load_word(const T* p) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  return *reinterpret_cast<const Word<T>*>(&q);
}

template <typename T>
__device__ __forceinline__ void store_word(T* p, const Word<T>& r) {
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&r);
}

// The sigmoid through the hardware's exp2 and reciprocal.
__device__ __forceinline__ float sigmoid(float p) { return __fdividef(1.f, 1.f + __expf(-p)); }

__device__ __forceinline__ float silu(float p) { return p * sigmoid(p); }

// d silu / d pre, as PyTorch's silu_backward writes it.
__device__ __forceinline__ float silu_grad(float p) {
  const float s = sigmoid(p);
  return s * (1.f + p * (1.f - s));
}

// Loads kRowsIn tile rows of one input into shared memory: tile row r is
// row t = t_first + r of `base` (row stride `stride`, channels cb ..
// cb+kChan-1); rows before 0 are the state's [W-1, C] rows where `st` is
// given, else zero, and rows at or past `t_limit` are zero.  Every thread
// issues all its loads before it stores any.
template <int W, typename T, int kRowsIn>
__device__ __forceinline__ void load_tile(T (*tile)[kChan<T>], const T* base, long long stride,
                                          const T* st, int C, int cb, int t_first, int t_limit) {
  constexpr int E = kElts<T>;
  constexpr int kPasses = (kRowsIn + kRowsPerPass - 1) / kRowsPerPass;
  const int q = threadIdx.x % kRowWords;
  const int c = cb + q * E;
  Word<T> buf[kPasses];
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const int r = threadIdx.x / kRowWords + k * kRowsPerPass;
    const int t = t_first + r;
    if (r >= kRowsIn) continue;
    if (c >= C || t >= t_limit)
      buf[k] = zero_word<T>();
    else if (t >= 0)
      buf[k] = load_word<T>(base + c + t * stride);
    else if (st != nullptr)                  // row W-1+t of the state [W-1, C]
      buf[k] = load_word<T>(st + static_cast<long long>(W - 1 + t) * C + c);
    else
      buf[k] = zero_word<T>();
  }
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const int r = threadIdx.x / kRowWords + k * kRowsPerPass;
    if (r < kRowsIn) *reinterpret_cast<Word<T>*>(&tile[r][q * E]) = buf[k];
  }
}

// Stores tile rows [0, kTileL) to the contiguous [.., C] rows t0 + r < S.
template <typename T>
__device__ __forceinline__ void store_tile(T (*tile)[kChan<T>], T* base, int C, int cb,
                                           int t0, int S) {
  constexpr int E = kElts<T>;
  const int q = threadIdx.x % kRowWords;
  const int c = cb + q * E;
  if (c >= C) return;
#pragma unroll
  for (int k = 0; k < kTileL / kRowsPerPass; ++k) {
    const int r = threadIdx.x / kRowWords + k * kRowsPerPass;
    if (t0 + r < S)
      store_word<T>(base + static_cast<long long>(t0 + r) * C + c,
                    *reinterpret_cast<const Word<T>*>(&tile[r][q * E]));
  }
}

// Forward.  A block takes a tile of kTileL rows by kChan channels: its x
// rows and the W-1 rows before them land in shared memory in one pass of
// 16-byte loads (every thread's loads in flight at once), each thread then
// walks one channel down kTileL / kSegs rows with the taps and the last
// W-1 inputs in registers, and the tile leaves in 16-byte stores.
template <int W, typename T>
__global__ void __launch_bounds__(kThreads)
causal_conv_fwd_kernel(const T* __restrict__ x, long long sxb, long long sxs,
                       const T* __restrict__ w, const float* __restrict__ bias,
                       const T* __restrict__ state, T* __restrict__ out,
                       T* __restrict__ new_state, int S, int C) {
  constexpr int CH = kChan<T>;
  constexpr int kIn = kTileL + W - 1;
  constexpr int kSegs = kThreads / CH;
  constexpr int kSegRows = kTileL / kSegs;
  __shared__ __align__(16) unsigned char xs_raw[kIn * CH * sizeof(T)];
  __shared__ __align__(16) unsigned char ys_raw[kTileL * CH * sizeof(T)];
  T (*xs)[CH] = reinterpret_cast<T (*)[CH]>(xs_raw);   // x rows t0-W+1 .. t0+kTileL-1
  T (*ys)[CH] = reinterpret_cast<T (*)[CH]>(ys_raw);
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kTileL;
  const int cb = blockIdx.x * CH;
  const T* xb = x + b * sxb;
  const T* st = state == nullptr ? nullptr : state + static_cast<long long>(b) * (W - 1) * C;
  load_tile<W, T, kIn>(xs, xb, sxs, st, C, cb, t0 - (W - 1), S);
  __syncthreads();

  const int ch = threadIdx.x % CH;
  const int r0 = (threadIdx.x / CH) * kSegRows;
  const bool live = cb + ch < C;
  float wf[W], b0 = live ? bias[cb + ch] : 0.f;
#pragma unroll
  for (int i = 0; i < W; ++i) wf[i] = live ? to_f(w[static_cast<long long>(i) * C + cb + ch]) : 0.f;
  float win[W];                              // x rows r-W+1 .. r (tile rows r .. r+W-1)
#pragma unroll
  for (int i = 0; i < W - 1; ++i) win[i] = to_f(xs[r0 + i][ch]);
#pragma unroll
  for (int r = r0; r < r0 + kSegRows; ++r) {
    win[W - 1] = to_f(xs[r + W - 1][ch]);
    float a = b0;
#pragma unroll
    for (int i = 0; i < W; ++i) a = fmaf(wf[i], win[i], a);
    ys[r][ch] = from_f<T>(silu(a));
#pragma unroll
    for (int i = 0; i + 1 < W; ++i) win[i] = win[i + 1];
  }
  __syncthreads();
  store_tile<T>(ys, out + static_cast<long long>(b) * S * C, C, cb, t0, S);

  // The new state: the last W-1 rows of cat(state, x), copied as stored, by
  // the block that holds the last row.
  if (new_state != nullptr && t0 + kTileL >= S) {
    for (int e = threadIdx.x; e < (W - 1) * CH; e += kThreads) {
      const int k = e / CH, c = cb + e % CH;
      if (c >= C) continue;
      const int t = S - (W - 1) + k;
      const T v = t >= 0 ? xb[t * sxs + c]
                         : (st == nullptr ? from_f<T>(0.f) : st[static_cast<long long>(W - 1 + t) * C + c]);
      new_state[(static_cast<long long>(b) * (W - 1) + k) * C + c] = v;
    }
  }
}

// Gradient.  A block takes a tile of kTileL rows by kChan channels: x rows
// t0-W+1 .. t0+kTileL+W-2 and dy rows t0 .. t0+kTileL+W-2 land in shared
// memory; each thread recomputes pre and g = dy · silu'(pre) down its rows
// of one channel into shared memory (the last segment also the W-1 rows
// past the tile, which dx needs), adding its own rows into dw and db; then
// dx = Σ_i w[i] g[t+W-1-i] is formed from the shared g with the last W-1 g
// in registers and leaves in 16-byte stores.  The block's dw and db are
// added over its segments in a fixed order into one partial.
template <int W, typename T>
__global__ void __launch_bounds__(kThreads)
causal_conv_bwd_kernel(const T* __restrict__ x, long long sxb, long long sxs,
                       const T* __restrict__ w, const float* __restrict__ bias,
                       const T* __restrict__ state, const T* __restrict__ dy, long long sdb,
                       long long sds, T* __restrict__ dx, float* __restrict__ part, int S,
                       int C) {
  constexpr int CH = kChan<T>;
  constexpr int kInX = kTileL + 2 * (W - 1);
  constexpr int kInD = kTileL + W - 1;
  constexpr int kSegs = kThreads / CH;
  constexpr int kSegRows = kTileL / kSegs;
  __shared__ __align__(16) unsigned char xs_raw[kInX * CH * sizeof(T)];
  __shared__ __align__(16) unsigned char ds_raw[kInD * CH * sizeof(T)];
  T (*xs)[CH] = reinterpret_cast<T (*)[CH]>(xs_raw);   // x rows t0-W+1 .., then the dx tile
  T (*ds)[CH] = reinterpret_cast<T (*)[CH]>(ds_raw);   // dy rows t0 ..
  __shared__ float gs[kInD][CH];             // g rows t0 ..
  __shared__ float red[kSegs][W + 1][CH];
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kTileL;
  const int cb = blockIdx.x * CH;
  const T* xb = x + b * sxb;
  const T* dyb = dy + b * sdb;
  const T* st = state == nullptr ? nullptr : state + static_cast<long long>(b) * (W - 1) * C;

  const int ch = threadIdx.x % CH;
  const int seg = threadIdx.x / CH;
  const int r0 = seg * kSegRows;
  const bool live = cb + ch < C;
  float wf[W], b0 = live ? bias[cb + ch] : 0.f;
#pragma unroll
  for (int i = 0; i < W; ++i) wf[i] = live ? to_f(w[static_cast<long long>(i) * C + cb + ch]) : 0.f;
  float dw[W], db = 0.f;
#pragma unroll
  for (int i = 0; i < W; ++i) dw[i] = 0.f;

  load_tile<W, T, kInX>(xs, xb, sxs, st, C, cb, t0 - (W - 1), S);
  load_tile<W, T, kInD>(ds, dyb, sds, nullptr, C, cb, t0, S);
  __syncthreads();

  float win[W];                              // xs rows r .. r+W-1: x rows t-W+1 .. t
#pragma unroll
  for (int i = 0; i < W - 1; ++i) win[i] = to_f(xs[r0 + i][ch]);
#pragma unroll
  for (int k = 0; k < kSegRows + W - 1; ++k) {
    // the W-1 rows past a segment are the next one's, past the tile the
    // last segment's
    if (k >= kSegRows && seg != kSegs - 1) break;
    const int r = r0 + k;
    win[W - 1] = to_f(xs[r + W - 1][ch]);
    float a = b0;
#pragma unroll
    for (int i = 0; i < W; ++i) a = fmaf(wf[i], win[i], a);
    const float g = t0 + r < S ? to_f(ds[r][ch]) * silu_grad(a) : 0.f;
    gs[r][ch] = g;
    if (k < kSegRows) {
      db += g;
#pragma unroll
      for (int i = 0; i < W; ++i) dw[i] = fmaf(g, win[i], dw[i]);
    }
#pragma unroll
    for (int i = 0; i + 1 < W; ++i) win[i] = win[i + 1];
  }
  __syncthreads();

  // dx[r] = Σ_i w[i] g[r + W - 1 - i], into xs (no longer read)
  float gw[W];                               // g rows r .. r+W-1
#pragma unroll
  for (int i = 0; i < W - 1; ++i) gw[i] = gs[r0 + i][ch];
#pragma unroll
  for (int k = 0; k < kSegRows; ++k) {
    const int r = r0 + k;
    gw[W - 1] = gs[r + W - 1][ch];
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) d = fmaf(wf[i], gw[W - 1 - i], d);
    xs[r][ch] = from_f<T>(d);
#pragma unroll
    for (int i = 0; i + 1 < W; ++i) gw[i] = gw[i + 1];
  }
  __syncthreads();
  store_tile<T>(xs, dx + static_cast<long long>(b) * S * C, C, cb, t0, S);

  // The block's dw and db added over its segments in order, one partial
  // per (batch, block row): part[b][blockIdx.y][k][c], k < W for dw, k = W
  // for db.
#pragma unroll
  for (int i = 0; i < W; ++i) red[seg][i][ch] = dw[i];
  red[seg][W][ch] = db;
  __syncthreads();
  const long long base =
      (static_cast<long long>(b) * gridDim.y + blockIdx.y) * (W + 1) * static_cast<long long>(C);
  for (int o = threadIdx.x; o < (W + 1) * CH; o += kThreads) {
    const int k = o / CH, cc = o % CH;
    if (cb + cc >= C) continue;
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < kSegs; ++y) s += red[y][k][cc];
    part[base + static_cast<long long>(k) * C + cb + cc] = s;
  }
}

// dw [W, C] in T and db [C] fp32 from part [parts, W + 1, C]: thread (x, y)
// of a block adds parts y, y + kSumParts, ... of column o in order, then
// the block adds its kSumParts sums in order.
template <typename T>
__global__ void __launch_bounds__(kSumCols * kSumParts)
causal_conv_wsum_kernel(const float* __restrict__ part, int parts, int W, int C,
                        T* __restrict__ dw, float* __restrict__ db) {
  __shared__ float red[kSumParts][kSumCols];
  const int n = (W + 1) * C;
  const int o = blockIdx.x * kSumCols + threadIdx.x;
  float s = 0.f;
  if (o < n) {
#pragma unroll 8
    for (int p = threadIdx.y; p < parts; p += kSumParts)
      s += part[static_cast<long long>(p) * n + o];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || o >= n) return;
  float t = 0.f;
#pragma unroll
  for (int y = 0; y < kSumParts; ++y) t += red[y][threadIdx.x];
  if (o < W * C)
    dw[o] = from_f<T>(t);
  else
    db[o - W * C] = t;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
dim3 conv_grid(int batch, int seqlen, int C, int rows) {
  return dim3((C + kChan<T> - 1) / kChan<T>, (seqlen + rows - 1) / rows, batch);
}

bool dims_ok(int batch, int seqlen, int C, int width) {
  return batch > 0 && seqlen > 0 && C > 0 && C % kChannelMultiple == 0 && width >= 1 &&
         width <= kMaxWidth &&
         batch <= kMaxGridYZ && (seqlen + kTileL - 1) / kTileL <= kMaxGridYZ;
}

// What the kernels' 16-byte words need of a view: pointer and row and
// batch strides in bytes multiples of 16.
bool view_aligned(const void* p, long long sb, long long ss, int elem) {
  return aligned16(p) && (sb * elem) % 16 == 0 && (ss * elem) % 16 == 0;
}

template <int W, typename T>
int launch_fwd(const void* x, long long sxb, long long sxs, const void* w, const void* b,
               const void* state, void* out, void* new_state, int batch, int seqlen, int C,
               cudaStream_t s) {
  causal_conv_fwd_kernel<W, T><<<conv_grid<T>(batch, seqlen, C, kTileL), kThreads, 0, s>>>(
      static_cast<const T*>(x), sxb, sxs, static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<const T*>(state), static_cast<T*>(out), static_cast<T*>(new_state), seqlen, C);
  return static_cast<int>(cudaGetLastError());
}

template <int W, typename T>
int launch_bwd(const void* x, long long sxb, long long sxs, const void* w, const void* b,
               const void* state, const void* dy, long long sdb, long long sds, void* dx,
               void* dw, void* db, void* part, int batch, int seqlen, int C, cudaStream_t s) {
  const dim3 grid = conv_grid<T>(batch, seqlen, C, kTileL);
  causal_conv_bwd_kernel<W, T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), sxb, sxs, static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<const T*>(state), static_cast<const T*>(dy), sdb, sds, static_cast<T*>(dx),
      static_cast<float*>(part), seqlen, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = (W + 1) * C;
  causal_conv_wsum_kernel<T><<<(n + kSumCols - 1) / kSumCols, dim3(kSumCols, kSumParts), 0, s>>>(
      static_cast<const float*>(part), batch * static_cast<int>(grid.y), W, C, static_cast<T*>(dw),
      static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_width(int width, const void* x, long long sxb, long long sxs, const void* w,
              const void* b, const void* state, void* out, void* new_state, int batch,
              int seqlen, int C, cudaStream_t s) {
  switch (width) {
    case 1: return launch_fwd<1, T>(x, sxb, sxs, w, b, state, out, new_state, batch, seqlen, C, s);
    case 2: return launch_fwd<2, T>(x, sxb, sxs, w, b, state, out, new_state, batch, seqlen, C, s);
    case 3: return launch_fwd<3, T>(x, sxb, sxs, w, b, state, out, new_state, batch, seqlen, C, s);
    default: return launch_fwd<4, T>(x, sxb, sxs, w, b, state, out, new_state, batch, seqlen, C, s);
  }
}

template <typename T>
int bwd_width(int width, const void* x, long long sxb, long long sxs, const void* w,
              const void* b, const void* state, const void* dy, long long sdb, long long sds,
              void* dx, void* dw, void* db, void* part, int batch, int seqlen, int C,
              cudaStream_t s) {
  switch (width) {
    case 1: return launch_bwd<1, T>(x, sxb, sxs, w, b, state, dy, sdb, sds, dx, dw, db, part, batch, seqlen, C, s);
    case 2: return launch_bwd<2, T>(x, sxb, sxs, w, b, state, dy, sdb, sds, dx, dw, db, part, batch, seqlen, C, s);
    case 3: return launch_bwd<3, T>(x, sxb, sxs, w, b, state, dy, sdb, sds, dx, dw, db, part, batch, seqlen, C, s);
    default: return launch_bwd<4, T>(x, sxb, sxs, w, b, state, dy, sdb, sds, dx, dw, db, part, batch, seqlen, C, s);
  }
}

template <int W, typename T>
int info_of(int which, int* out) {
  cudaFuncAttributes a;
  cudaError_t err;
  if (which == 0)
    err = cudaFuncGetAttributes(&a, causal_conv_fwd_kernel<W, T>);
  else if (which == 1)
    err = cudaFuncGetAttributes(&a, causal_conv_bwd_kernel<W, T>);
  else
    err = cudaFuncGetAttributes(&a, causal_conv_wsum_kernel<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  return 0;
}

template <typename T>
int info_width(int width, int which, int* out) {
  switch (width) {
    case 1: return info_of<1, T>(which, out);
    case 2: return info_of<2, T>(which, out);
    case 3: return info_of<3, T>(which, out);
    default: return info_of<4, T>(which, out);
  }
}

}  // namespace

// Rows of a tile, as the wrapper sizes the gradient's partials ([batch,
// ceil(seqlen / rows), W + 1, C]), the widest W, and the bf16 and fp32
// channels of a tile.
extern "C" void arcadia_causal_conv_plan(long long* out) {
  out[0] = kTileL;
  out[1] = kMaxWidth;
  out[2] = kChan<bf16>;
  out[3] = kChan<float>;
}

// Forward of x [batch, seqlen, C] read through (batch, row) element
// strides with the channels contiguous, w [width, C] contiguous in x's
// dtype (0 = fp32, 1 = bf16), b [C] fp32, an optional state [batch,
// width-1, C] contiguous in x's dtype, into out [batch, seqlen, C]
// contiguous and, where new_state is not null, the new state [batch,
// width-1, C].  C a multiple of 8, and x, the state and out 16-byte
// aligned with 16-byte strides (checked here).  One launch on `stream`;
// returns its cudaError_t.
extern "C" int arcadia_causal_conv_fwd(const void* x, long long sxb, long long sxs, const void* w,
                                       const void* b, const void* state, void* out,
                                       void* new_state, int batch, int seqlen, int C, int width,
                                       int dtype, void* stream) {
  if (!dims_ok(batch, seqlen, C, width) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == 0 ? 4 : 2;
  if (!view_aligned(x, sxb, sxs, elem) || !aligned16(state) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_width<float>(width, x, sxb, sxs, w, b, state, out, new_state, batch, seqlen, C, s);
  return fwd_width<bf16>(width, x, sxb, sxs, w, b, state, out, new_state, batch, seqlen, C, s);
}

// Gradient of the forward above at dy [batch, seqlen, C] (strides sdb,
// sds, channels contiguous, x's dtype, 16-byte aligned as x): dx [batch,
// seqlen, C] contiguous in x's dtype, dw [width, C] in x's dtype, db [C]
// fp32.  part is fp32 scratch of [batch, ceil(seqlen / 32), width + 1, C]
// from the caller.  Two launches on `stream`; returns the first
// cudaError_t.
extern "C" int arcadia_causal_conv_bwd(const void* x, long long sxb, long long sxs, const void* w,
                                       const void* b, const void* state, const void* dy,
                                       long long sdb, long long sds, void* dx, void* dw, void* db,
                                       void* part, int batch, int seqlen, int C, int width,
                                       int dtype, void* stream) {
  if (!dims_ok(batch, seqlen, C, width) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == 0 ? 4 : 2;
  if (!view_aligned(x, sxb, sxs, elem) || !view_aligned(dy, sdb, sds, elem) ||
      !aligned16(state) || !aligned16(dx))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_width<float>(width, x, sxb, sxs, w, b, state, dy, sdb, sds, dx, dw, db, part, batch, seqlen, C, s);
  return bwd_width<bf16>(width, x, sxb, sxs, w, b, state, dy, sdb, sds, dx, dw, db, part, batch, seqlen, C, s);
}

// cudaFuncGetAttributes of the forward (which 0), gradient (1) or partial
// sum (2) kernel at (width, dtype): registers a thread, local (spill)
// bytes, static shared bytes, max threads a block.
extern "C" int arcadia_causal_conv_info(int which, int width, int dtype, int* out) {
  if (width < 1 || width > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  return dtype == 0 ? info_width<float>(width, which, out) : info_width<bf16>(width, which, out);
}
