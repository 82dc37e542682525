// Backward of flash attention for Hopper (sm_90a), on the tensor cores:
// dq, dk and dv of the bf16 forward `flash_fwd_wgmma` (flash_attention.cu)
// at its (D, Dv) pairs (64, 64), (80, 80), (128, 128), (192, 128) and
// (256, 256), with the causal mask, a sliding window, the tanh logit
// softcap and GQA.
//
// Gradient of the JAX package's Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention/flash_attention.py), which has no
// backward kernel: the JAX package trains attention through `jax.grad` of
// its jnp strategies.  It computes the contract of
// `attention_backward_reference` (kernels/flash_attention/ref.py) with one
// rounding more, which `attention_backward_tc_reference` mirrors: dS is
// rounded to bf16 where it meets Q and K.  For query head h (kv head h / G)
// and query row s, with x the scaled scores:
//
//     x_st    = scale · q_s·k_t,  then x <- cap·tanh(x / cap) with a cap
//     p_st    = exp(x_st - lse_s)        (exactly 0 where the mask hides t)
//     delta_s = Σ_c dO_sc O_sc
//     dS_st   = p_st (dP_st - delta_s) (1 - (x_st / cap)²),  dP_st = dO_s·v_t
//     dq_s    = scale Σ_t bf(dS_st) k_t
//     dk_t    = scale Σ_{h in the group} Σ_s bf(dS_st) q_s
//     dv_t    =       Σ_{h in the group} Σ_s bf(p_st) dO_s
//
// What bounds it.  The function needs 2·(3D + 2Dv) operations per unmasked
// (query, key) pair of each head; at gemma2-9b's global layer (1 × 8192,
// H 16 over KV 8, D 256, causal) that is 1.4 TFLOP, 1.4 ms on the bf16
// tensor cores (989 TFLOP/s), against 0.2 GB of inputs and outputs (0.06
// ms at 3.35 TB/s): bound by operations, so every product runs on wgmma,
// bf16 operands with fp32 accumulators.
//
// Three launches a call, no atomics, so two calls give the same bits:
//
//   (a) `flash_bwd_tc_delta`: delta = rowsum(dO ∘ O) in fp32, one warp a
//       row, into an fp32 [B,H,S] scratch laid out as lse.
//   (b) `flash_bwd_tc_dkdv<D, Dv, kCap>`: one block per (b, kv head, tile
//       of 64 keys), 384 threads.  Warpgroup 0 is the producer (24
//       registers after `setmaxnreg`): one thread brings the K and V tiles
//       once and then, for the group's G query heads in head order and each
//       head's query tiles of 64 rows in order, the Q and dO tiles into a
//       two-stage ring (TMA, full and empty mbarriers).  So the GQA sum has
//       one order and there are no atomics.  The two consumer warpgroups
//       (240 registers) share the 64 keys and split the products:
//         warpgroup 1: Sᵀ = K·Qᵀ, Pᵀ = exp2(x·log2e - lse·log2e),
//                      dV += bf(Pᵀ)·dO
//         warpgroup 2: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, dSᵀ, dK += bf(dSᵀ)·Q
//       Sᵀ and dPᵀ are `wgmma m64n64k16` with K and V the K-major A operand
//       and the Q and dO tiles ([64, D] with D contiguous) the K-major B
//       operand, no transpose.  Pᵀ and dSᵀ are made in the fp32
//       accumulator registers, rounded to bf16 and packed in place: the
//       accumulator's fragment is the A-operand fragment of the next
//       product (the forward's trick), so dV and dK are `wgmma` with A
//       from registers and dO and Q the MN-major B operand (the transpose
//       bit), 64 output columns an instruction.  lse and delta are per
//       query, so per column of Sᵀ: a warp loads the step's 64 (two a
//       lane; lse +inf past the end, so that p is 0 there) and each thread
//       takes its 16 columns' by shuffle.
//       Why not one Sᵀ for both: dK and dV for 64 keys cost (D + Dv)/2
//       fp32 registers a thread in one warpgroup, 256 at (256, 256), so
//       each warpgroup keeps one of them (Dv/2 or D/2) and Sᵀ is computed
//       by both.  Handing Pᵀ and dSᵀ over through shared memory would save
//       that product but add stores, a proxy fence and a barrier between
//       the warpgroups each tile; this first kernel takes the simpler way.
//   (c) `flash_bwd_tc_dq<D, Dv, kCap>`: one block per (b, head, 128 query
//       rows), structured as `flash_fwd_wgmma`: the producer brings Q and
//       dO once and K, V tiles of 64 keys into a ring (two stages, one at
//       D = 256 where Q and dO of 128 rows take 128 KB), each consumer
//       warpgroup owns 64 rows: S = Q·Kᵀ and dP = dO·Vᵀ (SS, K and V the
//       K-major B operand), dS in registers, rounded and packed, then
//       dQ += bf(dS)·K with K the MN-major B operand.  Recomputing S and
//       dP here keeps the call free of atomics and of a [B,H,S,S] buffer.
//
// Work executed per attended pair: 2·(3D + 2Dv) in (b) (Sᵀ twice, dPᵀ,
// dV, dK) and 2·(2D + Dv) in (c) (S, dP, dQ): 2·(5D + 3Dv) against the
// function's 2·(3D + 2Dv), 1.6× at D = Dv, with the output widths of dV,
// dK and dQ rounded up to whole 64-column boxes (D = 80: 128).  Each
// warpgroup runs its step in order (scores, then the elementwise work,
// then the product), so its tensor-core work overlaps only the other
// warpgroup's; issuing step i's scores with step i - 1's product (the
// forward's overlap) was slower and spilled (PERF.md §6).  Every
// `m64n64k16` with both operands in shared memory reads 4 KB for 64 Ki
// multiply-adds, as many bytes a clock as shared memory gives at the
// tensor cores' rate, so wider products (n128) and operands kept in
// registers are where this design's time can be won.
//
// Masks as the forward does them: the tiles outside a block's causal /
// window band are never loaded ((b) visits the query tiles from the key
// tile's first row, when causal, to its last key + window - 1; (c) the key
// tiles from q0 - window + 1 to its last row, when causal).  Tiles that a
// mask or the end cuts pay a per-element test (template kEdge); a masked
// pair has p exactly 0, so dS is 0; rows and keys past S arrive as zeros
// (TMA's out-of-bounds fill) and are never written.
//
// Shared memory (1 KB to align the swizzled tiles, bf16, rows of 64-column
// boxes of 128 bytes, 128-byte swizzle):
//   (b) K + V + 2 stages × (Q + dO), each a [64, ·] tile:
//       (256, 256): 193 KB; (192, 128): 121 KB; (128, 128): 97 KB
//   (c) Q + dO of 128 rows + stages × (K + V) of 64 keys:
//       (256, 256): 193 KB (1 stage); (192, 128): 161 KB; (128, 128): 129 KB
// Registers a consumer thread: (b) D/2 of dK (128 at D = 256) + 32 of Sᵀ +
// 32 of dPᵀ + 16 of packed dSᵀ; (c) D/2 of dQ + 32 + 32 + 16.
// `arcadia_flash_bwd_tc_kernel_info` reports each kernel's registers and
// local (spill) bytes.
//
// Inputs are read through tensor maps over their strided [B,S,H,D] views
// (pointers and strides 16-byte aligned: TMA's rule), so the layer's
// permuted views and MLA's [..., 128:] value view go in as they are; dq,
// dk and dv are written through strides of their own.
//
// Self-contained (no header of its own): kernels/nvcc.py names a library
// by its one source's hash.  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface at the end).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda.h>                      // CUtensorMap and its enums only
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;       // 227 KB, H100
constexpr int kThreads = 384;          // producer warpgroup + two consumers
constexpr int kTile = 64;              // rows of a TMA box: keys of a (b)
                                       // block, queries of its steps, keys
                                       // of a (c) step
constexpr int kBoxBytes = kTile * 128; // one box: 64 rows × 64 bf16
constexpr int kDqRows = 128;           // query rows of a (c) block
constexpr int kStages = 2;             // Q/dO ring of (b)
constexpr int kDeltaThreads = 256;
constexpr int kDeltaRows = kDeltaThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int Dv>
struct Cfg {
  static_assert(D % 16 == 0 && Dv % 16 == 0 && Dv <= D, "head dims");
  static constexpr int kBoxes = (D + 63) / 64;          // boxes of a Q or K row
  static constexpr int kVBoxes = (Dv + 63) / 64;        // boxes of a V or dO row
  static constexpr int kKBytes = kBoxes * kBoxBytes;    // a [64, D] tile
  static constexpr int kVBytes = kVBoxes * kBoxBytes;   // a [64, Dv] tile
  static constexpr int kBarBytes = 128;
  static constexpr int kDkdvSmem =
      1024 + kKBytes + kVBytes + kStages * (kKBytes + kVBytes) + kBarBytes;
  // (c): Q and dO of 128 rows, then as many K/V stages as fit (1 or 2)
  static constexpr int kDqStages =
      1024 + 2 * (kKBytes + kVBytes) + 2 * (kKBytes + kVBytes) + kBarBytes <= kMaxSmem
          ? 2 : 1;
  static constexpr int kDqSmem =
      1024 + 2 * (kKBytes + kVBytes) + kDqStages * (kKBytes + kVBytes) + kBarBytes;
  static_assert(kDkdvSmem <= kMaxSmem && kDqSmem <= kMaxSmem, "tile plan exceeds 227 KB");
};

struct Args {
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

// what the (b) and (c) kernels take: the views as tensor maps (64-row
// boxes; Q and dO also as 128-row boxes for (c)), the rest as Args
struct TcArgs {
  CUtensorMap qmap, kmap, vmap, domap; // (D or Dv, S, heads, batch), 64 rows
  CUtensorMap qmap2, domap2;           // the same, 128-row boxes
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  long long l_sb, l_sh;
  int S, rep, causal, window;
  float scale, cap;
  float pre, post;                     // with a cap: x = tanh(s·pre)·post (log2 units)
  float mul;                           // without: x = s·mul, scale·log2(e)
};

// ------------------------------- delta --------------------------------- //

__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_tc_delta(const Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * kDeltaRows + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (s >= a.S) return;
  const __nv_bfloat16* orow = static_cast<const __nv_bfloat16*>(a.o) + b * a.o_sb +
                              h * a.o_sh + static_cast<long long>(s) * a.o_ss;
  const __nv_bfloat16* drow = static_cast<const __nv_bfloat16*>(a.dout) + b * a.do_sb +
                              h * a.do_sh + static_cast<long long>(s) * a.do_ss;
  float acc = 0.f;
  for (int d = 4 * lane; d < a.Dv; d += 128) {
    const uint2 x = *reinterpret_cast<const uint2*>(orow + d);
    const uint2 y = *reinterpret_cast<const uint2*>(drow + d);
    const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
    const float2 y0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y.x));
    const float2 y1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y.y));
    acc = fmaf(x0.x, y0.x, acc);
    acc = fmaf(x0.y, y0.y, acc);
    acc = fmaf(x1.x, y1.x, acc);
    acc = fmaf(x1.y, y1.y, acc);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[b * a.l_sb + h * a.l_sh + s] = acc;
}

// ------------------- TMA, mbarriers and wgmma (sm_90a) -------------------- //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// box (64 columns, rows, 1, 1) of a 4-D tensor map at (c0, c1, c2, c3)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.  A
// step adds its byte offset / 16 to the start-address field.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(float (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(r[i]);
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] * B[16 x 64], A in registers (bf16 pairs), B
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {   // 2^-22 relative; -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------- the elementwise step -------------------------- //

// p (kDs false) or dS (kDs true) of one raw product s at (query q, key t),
// lse2 = lse·log2(e) of the query; dp and delta for dS.  The scale, cap and
// mask come from the kernel's parameters (constant bank, no registers).
template <bool kCap, bool kEdge, bool kDs>
__device__ __forceinline__ float prob_or_ds(float s, float dp, float lse2, float dl,
                                            int q, int t, const TcArgs& a) {
  float x, th = 0.f;
  if constexpr (kCap) {
    th = tanhf(s * a.pre);
    x = th * a.post;
  } else {
    x = s * a.mul;
  }
  float p = fast_exp2(x - lse2);
  if constexpr (kEdge) {
    bool ok = t < a.S;
    if (a.causal) ok = ok && t <= q;
    if (a.window > 0) ok = ok && t > q - a.window;
    p = ok ? p : 0.f;
  }
  if constexpr (!kDs) return p;
  float ds = p * (dp - dl);
  if constexpr (kCap) ds *= 1.f - th * th;
  return ds;
}

// a [64, 64] fp32 fragment rounded to bf16 and packed as the A operand of
// the next product: the accumulator's fragment of columns 16ks .. 16ks + 15
// is that operand's fragment of k-step ks
__device__ __forceinline__ void pack_a(uint32_t (&pa)[4][4], const float (&sc)[32]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[ks][r] = pack_bf16(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
}

// The [64 keys, 64 queries] tile of (b), transposed scores: row = key,
// column = query.  lse and delta are per column: lane l of each warp holds
// those of queries q0 + l (lw[0], dw[0]) and q0 + 32 + l (lw[1], dw[1]),
// and a thread takes its 16 columns' by shuffle (4 registers a thread, not
// 32).
template <bool kCap, bool kEdge, bool kDs>
__device__ __forceinline__ void tile_t(float (&s)[32], const float (&dp)[32],
                                       const float (&lw)[2], const float (&dw)[2],
                                       int key0, int q0, int col0, const TcArgs& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int lane = 8 * (j % 4) + col0 + e;         // column 8j + col0 + e
      const float lse2 = __shfl_sync(0xffffffffu, lw[j / 4], lane);
      const float dl = kDs ? __shfl_sync(0xffffffffu, dw[j / 4], lane) : 0.f;
      const int q = q0 + 8 * j + col0 + e;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        s[i] = prob_or_ds<kCap, kEdge, kDs>(s[i], dp[i], lse2, dl, q, key0 + 8 * r, a);
      }
    }
}

// The [64 queries, 64 keys] tile of (c): row = query (lse2 and delta per
// row r), column = key.
template <bool kCap, bool kEdge>
__device__ __forceinline__ void tile_dq(float (&s)[32], const float (&dp)[32],
                                        const float (&lse2)[2], const float (&dl)[2],
                                        int q_row0, int k_col0, const TcArgs& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int i = 4 * j + e;
      s[i] = prob_or_ds<kCap, kEdge, true>(s[i], dp[i], lse2[r], dl[r], q_row0 + 8 * r,
                                           k_col0 + 8 * j + (e & 1), a);
    }
}

// 64 rows of an accumulator [64 x 64·NB] (boxes of 64 columns), times
// `mul`, into bf16 rows row0 + 8r of `out` (row stride ld), the first n
// columns
template <int NB>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ld,
                                           const float (&acc)[NB][32], int row,
                                           int rows_end, int col0, int n, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= rows_end) continue;
    __nv_bfloat16* p = out + static_cast<long long>(rr) * ld;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + col0;
        if (col < n)
          *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(
              acc[c][4 * j + 2 * r] * mul, acc[c][4 * j + 2 * r + 1] * mul);
      }
  }
}

// ------------------------------ dK and dV -------------------------------- //

// Shared memory of a (b) block: K and V of its 64 keys, then the ring of Q
// and dO tiles; barriers after them.
template <int D, int Dv>
struct DkdvSmem {
  using C = Cfg<D, Dv>;
  uint8_t* k_s;
  uint8_t* v_s;
  uint8_t* q_s;                        // stage st at + st·kKBytes
  uint8_t* do_s;                       // stage st at + st·kVBytes
  uint64_t* kv_full;
  uint64_t* q_full;                    // [kStages]
  uint64_t* q_empty;                   // [kStages]
  __device__ explicit DkdvSmem(uint8_t* raw) {
    // the swizzle repeats every 1024 bytes of shared address: align the tiles
    k_s = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    v_s = k_s + C::kKBytes;
    q_s = v_s + C::kVBytes;
    do_s = q_s + kStages * C::kKBytes;
    kv_full = reinterpret_cast<uint64_t*>(do_s + kStages * C::kVBytes);
    q_full = kv_full + 1;
    q_empty = kv_full + 1 + kStages;
  }
};

// The steps of a (b) block: the group's heads in order, each head's query
// tiles in order
struct DkdvWalk {
  int k0, kvh, b, qt_lo, n_qt, n_steps;
  __device__ DkdvWalk(const TcArgs& a) {
    k0 = blockIdx.x * kTile;
    kvh = blockIdx.y;
    b = blockIdx.z;
    // the query tiles some key of this tile is seen from, in each head
    const int q_lo = a.causal ? k0 : 0;
    const int q_hi = a.window > 0 ? min(a.S - 1, k0 + kTile - 1 + a.window - 1) : a.S - 1;
    qt_lo = q_lo / kTile;
    n_qt = q_hi / kTile - qt_lo + 1;
    n_steps = a.rep * n_qt;
  }
  __device__ int head(int i) const { return i / n_qt; }     // within the group
  __device__ int q0(int i) const { return (qt_lo + i % n_qt) * kTile; }
};

// A consumer warpgroup of (b): dV (kDk false: Sᵀ, Pᵀ, dV += bf(Pᵀ)·dO) or
// dK (kDk true: Sᵀ, dPᵀ, dSᵀ, dK += bf(dSᵀ)·Q) of the block's 64 keys
template <int D, int Dv, bool kCap, bool kDk>
__device__ __forceinline__ void dkdv_consumer(const TcArgs& a, const DkdvSmem<D, Dv>& m,
                                              const DkdvWalk& w) {
  using C = Cfg<D, Dv>;
  constexpr int kOut = kDk ? C::kBoxes : C::kVBoxes;   // 64-column boxes kept
  const int t = threadIdx.x % 128, lane = t % 32;
  const int row0 = 16 * (t / 32) + lane / 4;           // key rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);                     // and + 1, + 8·j
  const int k0 = w.k0;
  const uint64_t k_desc = smem_desc(smem_u32(m.k_s), 16, 1024);
  const uint64_t v_desc = smem_desc(smem_u32(m.v_s), 16, 1024);
  // the tile needs the per-element mask: the causal diagonal, the
  // window's edge, the ragged end of the keys or of the queries
  auto edge = [&](int q0) {
    return k0 + kTile > a.S || q0 + kTile > a.S ||
           (a.causal && q0 < k0 + kTile - 1) ||
           (a.window > 0 && k0 <= q0 + kTile - 1 - a.window);
  };
  float acc[kOut][32];
#pragma unroll
  for (int c = 0; c < kOut; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float s[32], dp[32];
  uint32_t pa[4][4];
  float lw[2], dw[2];

  // this warp's lane l: lse (log2 units; +inf past S, so p = 0) and delta
  // of step i's queries q0 + l and q0 + 32 + l
  auto load_rows = [&](int i) {
    const long long lrow = w.b * a.l_sb + (w.kvh * a.rep + w.head(i)) * a.l_sh;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = w.q0(i) + 32 * u + lane;
      lw[u] = q < a.S ? a.lse[lrow + q] * kLog2e : INFINITY;
      dw[u] = kDk && q < a.S ? a.delta[lrow + q] : 0.f;
    }
  };
  // Sᵀ = K·Qᵀ of step i over D/16 k-steps (D = 80: 5, the zero columns of
  // the second box never multiplied); dPᵀ = V·dOᵀ
  auto issue_scores = [&](int i) {
    const int st = i % kStages;
    const uint64_t q_desc = smem_desc(smem_u32(m.q_s + st * C::kKBytes), 16, 1024);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * (kBoxBytes / 16) + (kk % 4) * 2;
      wgmma_ss(s, k_desc + off, q_desc + off, kk > 0);
    }
    if constexpr (kDk) {
      const uint64_t do_desc = smem_desc(smem_u32(m.do_s + st * C::kVBytes), 16, 1024);
#pragma unroll
      for (int kk = 0; kk < Dv / 16; ++kk) {
        const int off = (kk / 4) * (kBoxBytes / 16) + (kk % 4) * 2;
        wgmma_ss(dp, v_desc + off, do_desc + off, kk > 0);
      }
    }
  };
  // dV += bf(Pᵀ)·dO or dK += bf(dSᵀ)·Q of step i: 4 k-steps of 16 queries
  // (2048 bytes), the B tile MN-major, one instruction a 64-column box
  auto issue_out = [&](int i) {
    const int st = i % kStages;
    const uint32_t b_st = kDk ? smem_u32(m.q_s + st * C::kKBytes)
                              : smem_u32(m.do_s + st * C::kVBytes);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int c = 0; c < kOut; ++c)
        wgmma_rs(acc[c], pa[ks], smem_desc(b_st + c * kBoxBytes, kBoxBytes, 1024) + ks * 128);
  };
  // Pᵀ or dSᵀ of step i in place of Sᵀ
  auto elementwise = [&](int i) {
    const int q0 = w.q0(i);
    if (edge(q0))
      tile_t<kCap, true, kDk>(s, dp, lw, dw, k0 + row0, q0, col0, a);
    else
      tile_t<kCap, false, kDk>(s, dp, lw, dw, k0 + row0, q0, col0, a);
  };
  auto fence_scores = [&]() {
    fence_regs(s);
    if constexpr (kDk) fence_regs(dp);
  };

  // Step by step: the scores, then Pᵀ or dSᵀ, then the product.  (Issuing
  // step i's scores with step i - 1's product, as the forward overlaps
  // P·V with the next softmax, was slower here and spilled at D = 256:
  // PERF.md §6.)
  mbar_wait(m.kv_full, 0);
  for (int i = 0; i < w.n_steps; ++i) {
    const int st = i % kStages;
    load_rows(i);
    mbar_wait(m.q_full + st, (i / kStages) & 1);
    fence_scores();
    wgmma_fence();
    issue_scores(i);
    wgmma_commit();
    wgmma_wait<0>();
    fence_scores();
    elementwise(i);
    pack_a(pa, s);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    issue_out(i);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(m.q_empty + st);
  }

  if constexpr (kDk) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dk) + w.b * a.dk_sb + w.kvh * a.dk_sh;
    store_rows<kOut>(out, a.dk_ss, acc, k0 + row0, a.S, col0, D, a.scale);
  } else {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dv) + w.b * a.dv_sb + w.kvh * a.dv_sh;
    store_rows<kOut>(out, a.dv_ss, acc, k0 + row0, a.S, col0, Dv, 1.f);
  }
}

template <int D, int Dv, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tc_dkdv(const __grid_constant__ TcArgs a) {
  using C = Cfg<D, Dv>;
  extern __shared__ uint8_t smem_raw[];
  const DkdvSmem<D, Dv> m(smem_raw);
  const DkdvWalk w(a);

  if (threadIdx.x == 0) {
    mbar_init(m.kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(m.q_full + st, 1);
      mbar_init(m.q_empty + st, 2 * 128);             // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------ producer ------------------------------ //
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(m.kv_full, C::kKBytes + C::kVBytes);
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load(m.k_s + c * kBoxBytes, &a.kmap, m.kv_full, 64 * c, w.k0, w.kvh, w.b);
#pragma unroll
      for (int c = 0; c < C::kVBoxes; ++c)
        tma_load(m.v_s + c * kBoxBytes, &a.vmap, m.kv_full, 64 * c, w.k0, w.kvh, w.b);
      for (int i = 0; i < w.n_steps; ++i) {
        const int st = i % kStages;
        const int free_parity = ((i / kStages) & 1) ^ 1;  // the slot's last use
        const int h = w.kvh * a.rep + w.head(i);
        const int q0 = w.q0(i);
        mbar_wait(m.q_empty + st, free_parity);
        mbar_expect_tx(m.q_full + st, C::kKBytes + C::kVBytes);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load(m.q_s + st * C::kKBytes + c * kBoxBytes, &a.qmap, m.q_full + st,
                   64 * c, q0, h, w.b);
#pragma unroll
        for (int c = 0; c < C::kVBoxes; ++c)
          tma_load(m.do_s + st * C::kVBytes + c * kBoxBytes, &a.domap, m.q_full + st,
                   64 * c, q0, h, w.b);
      }
    }
  } else if (wg == 1) {
    // ------------------ consumers: dV (1) and dK (2) --------------------- //
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    dkdv_consumer<D, Dv, kCap, false>(a, m, w);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    dkdv_consumer<D, Dv, kCap, true>(a, m, w);
  }
}

// --------------------------------- dQ ------------------------------------ //

template <int D, int Dv, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tc_dq(const __grid_constant__ TcArgs a) {
  using C = Cfg<D, Dv>;
  constexpr int kSt = C::kDqStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* do_s = q_s + 2 * C::kKBytes;                // 128 rows: 2·kBoxBytes a box
  uint8_t* k_s = do_s + 2 * C::kVBytes;                // stage st at + st·kKBytes
  uint8_t* v_s = k_s + kSt * C::kKBytes;               // stage st at + st·kVBytes
  uint64_t* bar = reinterpret_cast<uint64_t*>(v_s + kSt * C::kVBytes);
  uint64_t* q_full = bar;
  uint64_t* kv_full = bar + 1;
  uint64_t* kv_empty = bar + 1 + kSt;

  const int nq = (a.S + kDqRows - 1) / kDqRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kDqRows;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.rep;
  const int S = a.S;
  // the key tiles some row of this block can see
  const int k_last = a.causal ? min(S - 1, q0 + kDqRows - 1) : S - 1;
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_lo = k_first / kTile;
  const int n_tiles = k_last / kTile - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kSt; ++st) {
      mbar_init(kv_full + st, 1);
      mbar_init(kv_empty + st, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------ producer ------------------------------ //
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * (C::kKBytes + C::kVBytes));
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load(q_s + c * 2 * kBoxBytes, &a.qmap2, q_full, 64 * c, q0, h, b);
#pragma unroll
      for (int c = 0; c < C::kVBoxes; ++c)
        tma_load(do_s + c * 2 * kBoxBytes, &a.domap2, q_full, 64 * c, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kSt;
        const int free_parity = ((i / kSt) & 1) ^ 1;
        const int k0 = (kt_lo + i) * kTile;
        mbar_wait(kv_empty + st, free_parity);
        mbar_expect_tx(kv_full + st, C::kKBytes + C::kVBytes);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load(k_s + st * C::kKBytes + c * kBoxBytes, &a.kmap, kv_full + st,
                   64 * c, k0, kvh, b);
#pragma unroll
        for (int c = 0; c < C::kVBoxes; ++c)
          tma_load(v_s + st * C::kVBytes + c * kBoxBytes, &a.vmap, kv_full + st,
                   64 * c, k0, kvh, b);
      }
    }
  } else {
    // ----------------------------- consumers ------------------------------ //
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int cw = wg - 1;                             // rows 64·cw .. 64·cw + 63
    const int t = threadIdx.x - 128 * wg;
    const int row0 = 16 * (t / 32) + (t % 32) / 4;
    const int col0 = 2 * (t % 4);
    const int q0w = q0 + 64 * cw;
    auto edge = [&](int k0) {
      return k0 + kTile > S || (a.causal && k0 + kTile - 1 > q0w) ||
             (a.window > 0 && k0 <= q0w + 63 - a.window);
    };
    // each row's lse (log2 units; +inf past S: p = 0) and delta
    float lse2[2], dl[2];
    const long long lrow = b * a.l_sb + h * a.l_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0w + row0 + 8 * r;
      lse2[r] = q < S ? a.lse[lrow + q] * kLog2e : INFINITY;
      dl[r] = q < S ? a.delta[lrow + q] : 0.f;
    }
    // this warpgroup's Q and dO rows: boxes of 128 rows, 2·kBoxBytes apart
    const uint64_t q_desc = smem_desc(smem_u32(q_s) + cw * kBoxBytes, 16, 1024);
    const uint64_t do_desc = smem_desc(smem_u32(do_s) + cw * kBoxBytes, 16, 1024);
    float acc[C::kBoxes][32];
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float s[32], dp[32];
    uint32_t pa[4][4];

    // S = Q·Kᵀ and dP = dO·Vᵀ of tile i, K and V K-major
    auto issue_scores = [&](int i) {
      const int st = i % kSt;
      const uint64_t k_desc = smem_desc(smem_u32(k_s + st * C::kKBytes), 16, 1024);
      const uint64_t v_desc = smem_desc(smem_u32(v_s + st * C::kVBytes), 16, 1024);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, q_desc + (kk / 4) * (2 * kBoxBytes / 16) + (kk % 4) * 2,
                 k_desc + (kk / 4) * (kBoxBytes / 16) + (kk % 4) * 2, kk > 0);
#pragma unroll
      for (int kk = 0; kk < Dv / 16; ++kk)
        wgmma_ss(dp, do_desc + (kk / 4) * (2 * kBoxBytes / 16) + (kk % 4) * 2,
                 v_desc + (kk / 4) * (kBoxBytes / 16) + (kk % 4) * 2, kk > 0);
    };
    // dQ += bf(dS)·K of tile i: 4 k-steps of 16 keys, K MN-major, a box an
    // instruction
    auto issue_out = [&](int i) {
      const uint32_t k_st = smem_u32(k_s + (i % kSt) * C::kKBytes);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          wgmma_rs(acc[c], pa[ks],
                   smem_desc(k_st + c * kBoxBytes, kBoxBytes, 1024) + ks * 128);
    };
    // dS of tile i in place of S
    auto elementwise = [&](int i) {
      const int k0 = (kt_lo + i) * kTile;
      if (edge(k0))
        tile_dq<kCap, true>(s, dp, lse2, dl, q0w + row0, k0 + col0, a);
      else
        tile_dq<kCap, false>(s, dp, lse2, dl, q0w + row0, k0 + col0, a);
    };

    // tile by tile, as the dK/dV launch (with two stages the producer
    // loads the next tile meanwhile)
    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kSt;
      mbar_wait(kv_full + st, (i / kSt) & 1);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_scores(i);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      elementwise(i);
      pack_a(pa, s);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_out(i);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(kv_empty + st);
    }
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
    store_rows<C::kBoxes>(out, a.dq_ss, acc, q0w + row0, S, col0, D, a.scale);
  }
}

// --------------------------------- host ---------------------------------- //

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// bf16 view (D, S, heads, batch) with element strides (1, ss, sh, sb); the
// box is 64 columns × `rows` rows of one head of one batch
bool encode_view(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D, int S,
                 int heads, int batch, long long ss, long long sh, long long sb,
                 int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int Dv>
int launch(const Args& a, int batch, int heads, int kv_heads, cudaStream_t stream) {
  using C = Cfg<D, Dv>;
  const dim3 grid_delta(static_cast<unsigned>((a.S + kDeltaRows - 1) / kDeltaRows),
                        static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  flash_bwd_tc_delta<<<grid_delta, kDeltaThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  TcArgs t;
  std::memset(&t, 0, sizeof(t));
  if (!encode_view(enc, &t.qmap, a.q, D, a.S, heads, batch, a.q_ss, a.q_sh, a.q_sb, kTile) ||
      !encode_view(enc, &t.kmap, a.k, D, a.S, kv_heads, batch, a.k_ss, a.k_sh, a.k_sb, kTile) ||
      !encode_view(enc, &t.vmap, a.v, Dv, a.S, kv_heads, batch, a.v_ss, a.v_sh, a.v_sb, kTile) ||
      !encode_view(enc, &t.domap, a.dout, Dv, a.S, heads, batch, a.do_ss, a.do_sh, a.do_sb,
                   kTile) ||
      !encode_view(enc, &t.qmap2, a.q, D, a.S, heads, batch, a.q_ss, a.q_sh, a.q_sb,
                   kDqRows) ||
      !encode_view(enc, &t.domap2, a.dout, Dv, a.S, heads, batch, a.do_ss, a.do_sh,
                   a.do_sb, kDqRows))
    return static_cast<int>(cudaErrorInvalidValue);
  t.lse = a.lse;
  t.delta = a.delta;
  t.dq = a.dq;
  t.dk = a.dk;
  t.dv = a.dv;
  t.dq_sb = a.dq_sb; t.dq_sh = a.dq_sh; t.dq_ss = a.dq_ss;
  t.dk_sb = a.dk_sb; t.dk_sh = a.dk_sh; t.dk_ss = a.dk_ss;
  t.dv_sb = a.dv_sb; t.dv_sh = a.dv_sh; t.dv_ss = a.dv_ss;
  t.l_sb = a.l_sb;
  t.l_sh = a.l_sh;
  t.S = a.S;
  t.rep = a.rep;
  t.causal = a.causal;
  t.window = a.window;
  t.scale = a.scale;
  t.cap = a.cap;
  t.pre = a.cap > 0.f ? a.scale / a.cap : 0.f;
  t.post = a.cap * kLog2e;
  t.mul = a.scale * kLog2e;

  const bool cap = a.cap > 0.f;
  auto dkdv = cap ? flash_bwd_tc_dkdv<D, Dv, true> : flash_bwd_tc_dkdv<D, Dv, false>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDkdvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned>((a.S + kTile - 1) / kTile),
                     static_cast<unsigned>(kv_heads), static_cast<unsigned>(batch));
  dkdv<<<grid_kv, kThreads, C::kDkdvSmem, stream>>>(t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dq = cap ? flash_bwd_tc_dq<D, Dv, true> : flash_bwd_tc_dq<D, Dv, false>;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>((a.S + kDqRows - 1) / kDqRows),
                    static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  dq<<<grid_q, kThreads, C::kDqSmem, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// The (q/k head dim, v head dim) pairs the kernels are built for: f(Pair<D,
// Dv>{}) for the pair whose q/k head dim is `D`; tc_pair checks the pair.
template <int D, int Dv>
struct Pair {
  static constexpr int kD = D, kDv = Dv;
};

template <typename F>
int on_pair(int D, F f) {
  switch (D) {
    case 64: return f(Pair<64, 64>{});
    case 80: return f(Pair<80, 80>{});
    case 128: return f(Pair<128, 128>{});
    case 192: return f(Pair<192, 128>{});
    default: return f(Pair<256, 256>{});
  }
}

bool tc_pair(int D, int Dv) {
  return on_pair(D, [&](auto p) { return decltype(p)::kD == D && decltype(p)::kDv == Dv; });
}

// TMA's rules for q, k, v and dout (16-byte aligned pointers and strides);
// o and the outputs take 4-byte bf16 pairs
bool tc_aligned(const Args& a) {
  auto ptr_ok = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const long long strides[12] = {a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh, a.k_ss,
                                 a.v_sb, a.v_sh, a.v_ss, a.do_sb, a.do_sh, a.do_ss};
  for (long long s : strides)
    if (s % 8) return false;
  return ptr_ok(a.q) && ptr_ok(a.k) && ptr_ok(a.v) && ptr_ok(a.dout);
}

// registers and local (spill) bytes of a kernel into out[0..1], the larger
// of what is there and what the kernel reports
int attributes(const void* fn, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs > out[0] ? fa.numRegs : out[0];
  const int local = static_cast<int>(fa.localSizeBytes);
  out[1] = local > out[1] ? local : out[1];
  return 0;
}

template <int D, int Dv>
int info(int* out) {
  using C = Cfg<D, Dv>;
  for (int i = 0; i < 12; ++i) out[i] = 0;
  out[0] = kTile;                      // query rows of a (b) step
  out[1] = kTile;                      // keys of a (b) block and of a (c) step
  out[2] = C::kDkdvSmem;
  out[3] = kDqRows;
  out[4] = C::kDqSmem;
  out[5] = C::kDqStages;
  const void* fns[5] = {reinterpret_cast<const void*>(flash_bwd_tc_delta),
                        reinterpret_cast<const void*>(flash_bwd_tc_dkdv<D, Dv, false>),
                        reinterpret_cast<const void*>(flash_bwd_tc_dkdv<D, Dv, true>),
                        reinterpret_cast<const void*>(flash_bwd_tc_dq<D, Dv, false>),
                        reinterpret_cast<const void*>(flash_bwd_tc_dq<D, Dv, true>)};
  const int slot[5] = {6, 8, 8, 10, 10};
  int err = 0;
  for (int i = 0; i < 5 && err == 0; ++i) err = attributes(fns[i], out + slot[i]);
  return err;
}

}  // namespace

// Gradients of attention on the tensor cores (see the note at the top):
// the interface of `arcadia_flash_attention_backward`
// (flash_attention_bwd.cu) for bf16 at the (headdim, vdim) pairs (64, 64),
// (80, 80), (128, 128), (192, 128) and (256, 256) with q, k, v and dout
// 16-byte aligned (pointers and strides); anything else returns
// cudaErrorInvalidValue and launches nothing (the caller chooses the route
// before the call).  Launches three kernels on `stream` (delta, dK and dV,
// dQ), does not synchronise, and returns the first launch's cudaError_t
// that is not 0 (0 on success).
extern "C" int arcadia_flash_attention_backward_tc(
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
    int causal, int window, float scale, float cap, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || seqlen <= 0 || heads % kv_heads ||
      heads > 65535 || batch > 65535 || !tc_pair(headdim, vdim))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv,
         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
         o_sb, o_sh, o_ss, do_sb, do_sh, do_ss,
         dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
         l_sb, l_sh,
         seqlen, headdim, vdim, heads / kv_heads, causal, window, scale, cap};
  if (!tc_aligned(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_pair(headdim, [&](auto p) {
    return launch<decltype(p)::kD, decltype(p)::kDv>(a, batch, heads, kv_heads, s);
  });
}

// The plan and attributes of the kernels for (headdim, vdim): out[0] query
// rows of a dK/dV step, out[1] keys of a dK/dV block and of a dQ step,
// out[2] dynamic shared bytes of the dK/dV launch, out[3] query rows of a
// dQ block, out[4] its dynamic shared bytes, out[5] its K/V stages; then
// registers and local (spill) bytes a thread of the delta (out[6], out[7]),
// dK/dV (out[8], out[9]) and dQ (out[10], out[11]) kernels, the larger of
// the instantiations with and without a softcap.  Returns a cudaError_t.
extern "C" int arcadia_flash_bwd_tc_kernel_info(int headdim, int vdim, int* out) {
  if (!tc_pair(headdim, vdim)) return static_cast<int>(cudaErrorInvalidValue);
  return on_pair(headdim, [&](auto p) {
    return info<decltype(p)::kD, decltype(p)::kDv>(out);
  });
}
