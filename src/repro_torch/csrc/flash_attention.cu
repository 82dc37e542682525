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
// function as the plain version in kernels/flash_attention/ref.py.
//
// What bounds it.  At gemma2-9b's prefill (B=2, H=16 over KV=8, S=8192,
// D=256, causal, bf16) the function needs 4·B·H·D operations per unmasked
// (query, key) pair — 1.1 TFLOP for a global layer, 1.1 ms on the bf16
// tensor cores (989 TFLOP/s) — against 0.13 GB of inputs and outputs
// (0.04 ms at 3.35 TB/s): it is bound by operations.  This first kernel does
// its products on the CUDA cores in fp32 out of shared memory (67 TFLOP/s at
// best), so it sits well above that bound; wgmma and TMA are the next step.
// What the design does:
//   * The key axis is a loop inside the block.  The TPU walked it as the
//     innermost grid axis and kept (m, l, acc) in VMEM across grid steps;
//     Hopper blocks run in no order, so one block takes one (b, h, 64-row
//     query tile), keeps m and l in registers (each row's 16 owner threads
//     hold the same copy, combined by warp shuffles) and the [64, D]
//     accumulator in registers (4 rows × D/16 columns a thread), and walks
//     its key tiles in order.
//   * Tiles a mask removes entirely are never loaded: the block visits only
//     the key tiles from (q0 - window + 1) / 64 to (q0 + 63) / 64, as the
//     Pallas kernel skipped them with pl.when.  Inside a visited tile a row
//     may still have no visible key (a window narrower than a tile); its
//     scores are all -2^30, as in the plain version, and the next tile's
//     factor exp(-2^30 - m) = 0 wipes what they added.
//   * The ragged edge is masked here, not by the caller: the Pallas wrapper
//     needed S % 256 == 0.  Keys past S score -inf (exactly 0 weight) and
//     their V rows are zero in shared memory; rows past S are not written.
//   * Strided inputs.  q, k, v and o are read and written through their
//     batch, head and sequence strides (the head dim contiguous), so the
//     model passes its [B,S,K,G,D] and [B,S,K,D] projections as they are,
//     with no transpose copy; GQA reads kv head h / rep in place.
//   * Shared memory: Q and K tiles [64][D+4] fp32 (rows padded so that a
//     quarter-warp's float4 loads of 8 rows fall on distinct banks), V
//     [64][D] and P [64][68]: 211 KB at D = 256, dynamic, set with
//     cudaFuncSetAttribute.  Inputs are widened to fp32 as they are staged.
//   * fp32 arithmetic throughout (expf and tanhf, no fast-math), so fp32
//     inputs agree with the plain version to 2e-5; TF32 is never used.
// Head dims up to 256, D % 4 == 0; fp32 or bf16.
//
// Built by kernels/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // 16 × 16: 4 rows × (D/16) columns each
constexpr int kTile = 64;              // query rows = key rows of a tile
constexpr int kLdP = kTile + 4;
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
  int S, D, rep, nq;
  int causal, window;                  // window <= 0: none
  float scale, cap;                    // cap <= 0: none
};

// four consecutive elements (16 B of fp32, 8 B of bf16) as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);            // round to nearest even
}

// rows [r0, r0 + 64) of a [S, D] slice (row stride ld_g) into a [64][ld_s]
// fp32 tile; rows past S and columns past D are zero
template <typename T, int DM>
__device__ __forceinline__ void load_tile(float* dst, int ld_s, const T* src,
                                          long long ld_g, int r0, int S, int D) {
  constexpr int kQuads = DM / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < kTile * kQuads; e += kThreads) {
    const int r = e / kQuads;
    const int d = (e - r * kQuads) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S && d < D) val = load4(src + static_cast<long long>(r0 + r) * ld_g + d);
    *reinterpret_cast<float4*>(dst + r * ld_s + d) = val;
  }
}

__host__ __device__ constexpr int smem_floats(int DM) {
  return 2 * kTile * (DM + 4) + kTile * DM + kTile * kLdP;
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Args a) {
  constexpr int kLdQ = DM + 4;
  constexpr int kVw = DM >= 64 ? 4 : 2;       // V columns per vector load
  constexpr int kNc = DM / (16 * kVw);        // column groups a thread owns
  constexpr int kCols = kNc * kVw;            // = DM / 16
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * kLdQ;
  float* Vs = Ks + kTile * kLdQ;
  float* Ps = Vs + kTile * DM;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;                    // rows ty + 16 i
  const int tx = tid & 15;                    // score columns tx + 16 j
  const int qt = a.nq - 1 - static_cast<int>(blockIdx.x);   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.rep;
  const int q0 = qt * kTile;
  const int S = a.S;

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  load_tile<T, DM>(Qs, kLdQ, qg, a.q_ss, q0, S, a.D);

  // the key tiles some row of this query tile can see
  const int k_last = a.causal ? min(S - 1, q0 + kTile - 1) : S - 1;
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_lo = k_first / kTile;
  const int kt_hi = k_last / kTile;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                          // the previous tile is done with Ks, Vs, Ps
    load_tile<T, DM>(Ks, kLdQ, kg, a.k_ss, k0, S, a.D);
    load_tile<T, DM>(Vs, DM, vg, a.v_ss, k0, S, a.D);
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DM; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * kLdQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * kLdQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // scale, cap and mask; then the online softmax of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale;
        if (a.cap > 0.f) x = tanhf(x / a.cap) * a.cap;
        bool ok = true;
        if (a.causal) ok = kpos <= qpos;
        if (a.window > 0) ok = ok && kpos > qpos - a.window;
        x = ok ? x : kNegInf;
        if (kpos >= S) x = -INFINITY;         // past the end: no weight at all
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)  // the row's 16 threads
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = e;
        rs += e;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc[rows, columns kVw·tx + 16·kVw·c + e] += P[rows, :] · V[:, columns]
#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      float pj[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pj[i] = Ps[(ty + 16 * i) * kLdP + j];
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        const float* vp = Vs + j * DM + kVw * tx + 16 * kVw * c;
        float vv[kVw];
        if constexpr (kVw == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vp);
          vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vp);
          vv[0] = t.x; vv[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < kVw; ++e)
            acc[i][c * kVw + e] = fmaf(pj[i], vv[e], acc[i][c * kVw + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* row = og + static_cast<long long>(qpos) * a.o_ss;
#pragma unroll
    for (int c = 0; c < kNc; ++c)
#pragma unroll
      for (int e = 0; e < kVw; ++e) {
        const int col = kVw * tx + 16 * kVw * c + e;
        if (col < a.D) store(row + col, acc[i][c * kVw + e] / den);
      }
  }
}

template <typename T, int DM>
int launch(const Args& a, int batch, int heads, cudaStream_t stream) {
  const int bytes = smem_floats(DM) * static_cast<int>(sizeof(float));
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
  if (a.D <= 32) return launch<T, 32>(a, batch, heads, stream);
  if (a.D <= 64) return launch<T, 64>(a, batch, heads, stream);
  if (a.D <= 128) return launch<T, 128>(a, batch, heads, stream);
  return launch<T, 256>(a, batch, heads, stream);
}

}  // namespace

// Attention of q [batch, heads, seqlen, headdim] against k, v
// [batch, kv_heads, seqlen, headdim] into o (q's shape), each given by its
// data pointer and its batch, head and sequence strides in elements (the
// head dim is contiguous, and every stride and pointer a multiple of four
// elements).  dtype: 0 for fp32, 1 for bf16, the same for all four.
// window <= 0 means no window, cap <= 0 no softcap.  Launches one kernel on
// `stream`, does not synchronise, and returns the cudaError_t of the launch
// (0 on success).
extern "C" int arcadia_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int batch, int heads, int kv_heads, int seqlen, int headdim,
    int causal, int window, float scale, float cap, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || seqlen <= 0 || headdim <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (heads % kv_heads || headdim > 256 || headdim % 4 || heads > 65535 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o,
         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
         seqlen, headdim, heads / kv_heads, (seqlen + kTile - 1) / kTile,
         causal, window, scale, cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, batch, heads, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, batch, heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
