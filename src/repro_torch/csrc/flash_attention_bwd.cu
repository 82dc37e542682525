// Backward of flash attention for Hopper (sm_90a), on the CUDA cores:
// dq, dk and dv of the forward in flash_attention.cu (causal mask, sliding
// window, tanh logit softcap, GQA, a value head dim Dv <= D).
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
// (query, key) pair of each head (Q·Kᵀ, dO·Vᵀ, dV, dQ, dK); at gemma2-9b's
// global layer (1 × 8192, H 16 over KV 8, D 256, causal) that is 1.4 TFLOP,
// 1.4 ms on the bf16 tensor cores, against 0.2 GB of inputs and outputs:
// bound by operations.  This first kernel runs them on the CUDA cores in
// fp32 (bf16 inputs widened, no TF32), 67 TFLOP/s at most, and recomputes
// Q·Kᵀ and dO·Vᵀ in its dQ launch (2·(4D + 3Dv) a pair executed).  Moving
// the products onto wgmma is the next step.
//
// Three launches a call, no atomics, so two calls give the same bits:
//
//   (a) `flash_bwd_delta`: delta = rowsum(dO ∘ O) in fp32, one warp a row,
//       into an fp32 [B,H,S] scratch laid out as lse.
//   (b) `flash_bwd_dkdv`: one block per (b, kv head, tile of Bk keys).  It
//       keeps its K and V tiles in shared memory and dK, dV in registers,
//       and walks the group's G query heads in head order and each head's
//       query tiles of 64 rows in order, so the GQA sum has a fixed order.
//       Per query tile: S and dP of the [64, Bk] tile (a thread owns rows
//       ty + 16i, keys tx + 16j), p and dS into shared memory, then
//       dV += bf(P)ᵀ·dO and dK += dSᵀ·Q (a thread owns keys ty + 16r and
//       D/16 columns, four contiguous at a time).
//   (c) `flash_bwd_dq`: one block per (b, head, 64 query rows), walking its
//       key tiles in order: S, dP, dS as in (b), then dQ += dS·K with dQ
//       in registers.
//
// Masks as the forward does them: the tiles outside the causal / window
// band of a block are never loaded (b visits the query tiles from the key
// tile's first row, when causal, to its last key + window - 1; c the key
// tiles from q0 - window + 1 to the last row, when causal); a masked pair
// has p exactly 0 (so dS is 0); rows and keys past S are never written.
//
// Registers and shared memory.  A tile of 64 keys at D = 256 would need
// 2 × 64 × 256 fp32 accumulators (dK and dV, 128 KB: 128 registers a
// thread of 256) and 2 × 264 KB of tiles, so the key tile is Bk = 32 at
// D = 256 and 64 below; each thread then holds (Bk/16)·(DM/16) of dK and
// as many of dV (64 registers together at DM = 128 and 256).  Shared
// memory per block, fp32: Q and dO tiles [64][DM+4], K and V tiles
// [Bk][DM+4] (rows padded so that a quarter warp's float4 reads of 8 rows
// fall on distinct banks), P and dS [64][Bk+4], lse and delta [64]:
//     DM = 256, Bk = 32: 218,624 B;  DM = 128, Bk = 64: 170,496 B;
//     DM =  64, Bk = 64: 104,960 B;  DM =  32, Bk = 64:  72,192 B
// (227 KB a block at most).  `arcadia_flash_bwd_kernel_info` reports each
// kernel's registers and local (spill) bytes.
//
// Inputs are read through their batch, head and sequence strides (the
// head dim contiguous, strides and pointers multiples of 4 elements), so
// the layer's permuted [B,S,H,D] views and MLA's [..., 128:] value view go
// in as they are; dq, dk and dv are written through strides of their own.
//
// Built by kernels/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface at the end).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // 16 × 16
constexpr int kBq = 64;                // query rows of a tile
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

// The plan of a head width DM (D rounded up to 32, 64, 128 or 256).
template <int DM>
struct BwdCfg {
  static constexpr int kBk = DM == 256 ? 32 : 64;       // keys of a tile
  static constexpr int kLd = DM + 4;                    // row stride of a tile
  static constexpr int kLdP = kBk + 4;                  // row stride of P, dS
  static constexpr int kSmemFloats =
      2 * kBq * kLd + 2 * kBk * kLd + 2 * kBq * kLdP + 2 * kBq;
  static constexpr int kSmem = kSmemFloats * 4;
  static_assert(kSmem <= kMaxSmem, "tile plan exceeds 227 KB");
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

// p as it meets dO: rounded to the inputs' dtype
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [r0, r0 + ROWS) of a [S, n] slice (row stride ld_g) into a
// [ROWS][ld_s] fp32 tile of DM columns; rows past S and columns past n zero
template <typename T, int DM, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ld_s, const T* src,
                                          long long ld_g, int r0, int S, int n) {
  constexpr int kQuads = DM / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * kQuads; e += kThreads) {
    const int r = e / kQuads;
    const int d = (e - r * kQuads) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S && d < n) val = load4(src + static_cast<long long>(r0 + r) * ld_g + d);
    *reinterpret_cast<float4*>(dst + r * ld_s + d) = val;
  }
}

// acc[i][j] = Σ_{d < n} A[ty + 16i][d] · B[tx + 16j][d] over fp32 tiles
// with row stride ld: the [64, 16·NJ] products a thread owns
template <int NJ>
__device__ __forceinline__ void tile_dots(float (&acc)[4][NJ], const float* A,
                                          const float* B, int ld, int n, int ty,
                                          int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < n; d += 4) {
    float4 av[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// p and dS of the [64, Bk] tile at query rows q0.., keys k0.. from the raw
// products s = Q·Kᵀ and dp = dO·Vᵀ a thread owns; lse_s and delta_s hold
// the tile's 64 rows.  Leaves p (rounded as it meets dO, for dV) in P_s and
// dS in dS_s (P_s may be null: the dQ launch needs dS only).
template <typename T, int NJ>
__device__ __forceinline__ void probs_and_dscores(
    const float (&s)[4][NJ], const float (&dp)[4][NJ], const float* lse_s,
    const float* delta_s, float* P_s, float* dS_s, int ldp, int q0, int k0,
    const BwdArgs& a, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
    const float lse = lse_s[r], delta = delta_s[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      const int kpos = k0 + c;
      float x = s[i][j] * a.scale;
      float th = 0.f;
      if (a.cap > 0.f) {
        th = tanhf(x / a.cap);
        x = th * a.cap;
      }
      bool ok = qpos < a.S && kpos < a.S;
      if (a.causal) ok = ok && kpos <= qpos;
      if (a.window > 0) ok = ok && kpos > qpos - a.window;
      const float p = ok ? expf(x - lse) : 0.f;
      float ds = p * (dp[i][j] - delta);
      if (a.cap > 0.f) ds *= 1.f - th * th;
      if (P_s != nullptr) P_s[r * ldp + c] = round_to(p, static_cast<const T*>(nullptr));
      dS_s[r * ldp + c] = ds;
    }
  }
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
    const float4 x = load4(orow + d), y = load4(drow + d);
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
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const BwdArgs a) {
  using C = BwdCfg<DM>;
  constexpr int Bk = C::kBk, NJ = Bk / 16, kLd = C::kLd, kLdP = C::kLdP;
  constexpr int kVw = DM >= 64 ? 4 : 2;       // columns per vector read
  constexpr int kNc = DM / (16 * kVw);        // column groups a thread owns
  constexpr int kCols = kNc * kVw;            // = DM / 16
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBq * kLd;
  float* Ks = dOs + kBq * kLd;
  float* Vs = Ks + Bk * kLd;
  float* Ps = Vs + Bk * kLd;
  float* dSs = Ps + kBq * kLdP;
  float* lse_s = dSs + kBq * kLdP;
  float* delta_s = lse_s + kBq;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * Bk;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int S = a.S;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  load_tile<T, DM, Bk>(Ks, kLd, kg, a.k_ss, k0, S, a.D);
  load_tile<T, DM, Bk>(Vs, kLd, vg, a.v_ss, k0, S, a.Dv);

  // the query tiles some key of this tile is seen from
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(S - 1, k0 + Bk - 1 + a.window - 1) : S - 1;
  const int qt_lo = q_lo / kBq, qt_hi = q_hi / kBq;

  // dk, dv rows (keys) ty + 16r, columns kVw·tx + 16·kVw·c + e
  float dk[NJ][kCols], dv[NJ][kCols];
#pragma unroll
  for (int r = 0; r < NJ; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int g = 0; g < a.rep; ++g) {            // the group's heads, in order
    const int h = kvh * a.rep + g;
    const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dog = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const float* lg = a.lse + b * a.l_sb + h * a.l_sh;
    const float* deg = a.delta + b * a.l_sb + h * a.l_sh;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {  // its query tiles, in order
      const int q0 = qt * kBq;
      __syncthreads();                         // the last tile is done with Qs .. dSs
      load_tile<T, DM, kBq>(Qs, kLd, qg, a.q_ss, q0, S, a.D);
      load_tile<T, DM, kBq>(dOs, kLd, dog, a.do_ss, q0, S, a.Dv);
      if (tid < kBq) {
        lse_s[tid] = q0 + tid < S ? lg[q0 + tid] : 0.f;
        delta_s[tid] = q0 + tid < S ? deg[q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][NJ], dp[4][NJ];
      tile_dots<NJ>(s, Qs, Ks, kLd, a.D, ty, tx);
      tile_dots<NJ>(dp, dOs, Vs, kLd, a.Dv, ty, tx);
      probs_and_dscores<T, NJ>(s, dp, lse_s, delta_s, Ps, dSs, kLdP, q0, k0, a, ty, tx);
      __syncthreads();
      // dV += bf(P)ᵀ·dO, dK += dSᵀ·Q over the tile's 64 rows, in order
#pragma unroll 4
      for (int j = 0; j < kBq; ++j) {
        float pj[NJ], sj[NJ];
#pragma unroll
        for (int r = 0; r < NJ; ++r) {
          pj[r] = Ps[j * kLdP + ty + 16 * r];
          sj[r] = dSs[j * kLdP + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < kNc; ++c) {
          const int col = kVw * tx + 16 * kVw * c;
          float ov[kVw], qv[kVw];
          if constexpr (kVw == 4) {
            const float4 t = *reinterpret_cast<const float4*>(dOs + j * kLd + col);
            const float4 u = *reinterpret_cast<const float4*>(Qs + j * kLd + col);
            ov[0] = t.x; ov[1] = t.y; ov[2] = t.z; ov[3] = t.w;
            qv[0] = u.x; qv[1] = u.y; qv[2] = u.z; qv[3] = u.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(dOs + j * kLd + col);
            const float2 u = *reinterpret_cast<const float2*>(Qs + j * kLd + col);
            ov[0] = t.x; ov[1] = t.y;
            qv[0] = u.x; qv[1] = u.y;
          }
#pragma unroll
          for (int r = 0; r < NJ; ++r)
#pragma unroll
            for (int e = 0; e < kVw; ++e) {
              dv[r][c * kVw + e] = fmaf(pj[r], ov[e], dv[r][c * kVw + e]);
              dk[r][c * kVw + e] = fmaf(sj[r], qv[e], dk[r][c * kVw + e]);
            }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh;
  T* dvg = static_cast<T*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh;
#pragma unroll
  for (int r = 0; r < NJ; ++r) {
    const int kpos = k0 + ty + 16 * r;
    if (kpos >= S) continue;
    T* krow = dkg + static_cast<long long>(kpos) * a.dk_ss;
    T* vrow = dvg + static_cast<long long>(kpos) * a.dv_ss;
#pragma unroll
    for (int c = 0; c < kNc; ++c)
#pragma unroll
      for (int e = 0; e < kVw; ++e) {
        const int col = kVw * tx + 16 * kVw * c + e;
        if (col < a.D) store(krow + col, dk[r][c * kVw + e] * a.scale);
        if (col < a.Dv) store(vrow + col, dv[r][c * kVw + e]);
      }
  }
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const BwdArgs a) {
  using C = BwdCfg<DM>;
  constexpr int Bk = C::kBk, NJ = Bk / 16, kLd = C::kLd, kLdP = C::kLdP;
  constexpr int kVw = DM >= 64 ? 4 : 2;
  constexpr int kNc = DM / (16 * kVw);
  constexpr int kCols = kNc * kVw;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBq * kLd;
  float* Ks = dOs + kBq * kLd;
  float* Vs = Ks + Bk * kLd;
  float* dSs = Vs + Bk * kLd + kBq * kLdP;    // the plan's P tile stays unused
  float* lse_s = dSs + kBq * kLdP;
  float* delta_s = lse_s + kBq;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nq = (a.S + kBq - 1) / kBq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBq;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.rep;
  const int S = a.S;
  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* dog = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  load_tile<T, DM, kBq>(Qs, kLd, qg, a.q_ss, q0, S, a.D);
  load_tile<T, DM, kBq>(dOs, kLd, dog, a.do_ss, q0, S, a.Dv);
  if (tid < kBq) {
    const long long row = b * a.l_sb + h * a.l_sh + q0 + tid;
    lse_s[tid] = q0 + tid < S ? a.lse[row] : 0.f;
    delta_s[tid] = q0 + tid < S ? a.delta[row] : 0.f;
  }

  // the key tiles some row of this query tile can see
  const int k_last = a.causal ? min(S - 1, q0 + kBq - 1) : S - 1;
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;

  // dq rows ty + 16i, columns kVw·tx + 16·kVw·c + e
  float dq[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[i][c] = 0.f;

  for (int kt = k_first / Bk; kt <= k_last / Bk; ++kt) {
    const int k0 = kt * Bk;
    __syncthreads();                           // the last tile is done with Ks, Vs, dSs
    load_tile<T, DM, Bk>(Ks, kLd, kg, a.k_ss, k0, S, a.D);
    load_tile<T, DM, Bk>(Vs, kLd, vg, a.v_ss, k0, S, a.Dv);
    __syncthreads();
    float s[4][NJ], dp[4][NJ];
    tile_dots<NJ>(s, Qs, Ks, kLd, a.D, ty, tx);
    tile_dots<NJ>(dp, dOs, Vs, kLd, a.Dv, ty, tx);
    probs_and_dscores<T, NJ>(s, dp, lse_s, delta_s, nullptr, dSs, kLdP, q0, k0, a, ty, tx);
    __syncthreads();
    // dQ += dS·K over the tile's keys, in order
#pragma unroll 4
    for (int j = 0; j < Bk; ++j) {
      float sj[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sj[i] = dSs[(ty + 16 * i) * kLdP + j];
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        const int col = kVw * tx + 16 * kVw * c;
        float kv[kVw];
        if constexpr (kVw == 4) {
          const float4 t = *reinterpret_cast<const float4*>(Ks + j * kLd + col);
          kv[0] = t.x; kv[1] = t.y; kv[2] = t.z; kv[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(Ks + j * kLd + col);
          kv[0] = t.x; kv[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < kVw; ++e)
            dq[i][c * kVw + e] = fmaf(sj[i], kv[e], dq[i][c * kVw + e]);
      }
    }
  }

  T* dqg = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    T* row = dqg + static_cast<long long>(qpos) * a.dq_ss;
#pragma unroll
    for (int c = 0; c < kNc; ++c)
#pragma unroll
      for (int e = 0; e < kVw; ++e) {
        const int col = kVw * tx + 16 * kVw * c + e;
        if (col < a.D) store(row + col, dq[i][c * kVw + e] * a.scale);
      }
  }
}

template <typename T, int DM>
int launch(const BwdArgs& a, int batch, int heads, int kv_heads, cudaStream_t stream) {
  using C = BwdCfg<DM>;
  const dim3 grid_delta(static_cast<unsigned>((a.S + kDeltaRows - 1) / kDeltaRows),
                        static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  flash_bwd_delta<T><<<grid_delta, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, DM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned>((a.S + C::kBk - 1) / C::kBk),
                     static_cast<unsigned>(kv_heads), static_cast<unsigned>(batch));
  flash_bwd_dkdv<T, DM><<<grid_kv, kThreads, C::kSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dq<T, DM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>((a.S + kBq - 1) / kBq),
                    static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  flash_bwd_dq<T, DM><<<grid_q, kThreads, C::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const BwdArgs& a, int batch, int heads, int kv_heads, cudaStream_t s) {
  if (a.D <= 32) return launch<T, 32>(a, batch, heads, kv_heads, s);
  if (a.D <= 64) return launch<T, 64>(a, batch, heads, kv_heads, s);
  if (a.D <= 128) return launch<T, 128>(a, batch, heads, kv_heads, s);
  return launch<T, 256>(a, batch, heads, kv_heads, s);
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
int info(int* out) {
  using C = BwdCfg<DM>;
  out[0] = kBq;
  out[1] = C::kBk;
  out[2] = C::kSmem;
  int err = attributes(reinterpret_cast<const void*>(flash_bwd_delta<T>), out + 3);
  if (err == 0) err = attributes(reinterpret_cast<const void*>(flash_bwd_dkdv<T, DM>), out + 5);
  if (err == 0) err = attributes(reinterpret_cast<const void*>(flash_bwd_dq<T, DM>), out + 7);
  return err;
}

template <typename T>
int info_dispatch(int headdim, int* out) {
  if (headdim <= 32) return info<T, 32>(out);
  if (headdim <= 64) return info<T, 64>(out);
  if (headdim <= 128) return info<T, 128>(out);
  return info<T, 256>(out);
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
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, batch, heads, kv_heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan and attributes of the backward kernels for (dtype, headdim):
// out[0] query rows of a tile, out[1] keys of a tile, out[2] dynamic
// shared bytes of the dK/dV and dQ launches, then registers and local
// (spill) bytes a thread of the delta (out[3], out[4]), dK/dV (out[5],
// out[6]) and dQ (out[7], out[8]) kernels.  Returns a cudaError_t.
extern "C" int arcadia_flash_bwd_kernel_info(int dtype, int headdim, int* out) {
  if (headdim <= 0 || headdim > 256 || headdim % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return info_dispatch<float>(headdim, out);
  if (dtype == 1) return info_dispatch<__nv_bfloat16>(headdim, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
