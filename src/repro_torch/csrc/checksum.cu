// Lane-polynomial integrity hash, row-wise, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_checksum_kernel` of the JAX package
// (src/repro/kernels/checksum/checksum.py), launched there by
// `checksum_blocks_pallas` and combined on the host by
// `tensor_checksum_pallas`.  For every row of a [rows, lanes] uint32
// matrix it computes
//
//     out[row] = Σ_i  mat[row, i] · r^i   (mod 2^32),   r = 2654435761,
//
// the same value as the plain version in kernels/checksum/ref.py.
//
// What bounds it.  Each lane is read once and takes one multiply-add, so
// the kernel is bound by HBM bytes: rows·lanes·4 B at 3.35 TB/s on an H100
// SXM.  The design spends nothing else on memory:
//   * one pass: the matrix is read once, coalesced (neighbouring threads
//     read neighbouring lanes), and nothing is written but one 4-byte
//     partial per block;
//   * no weight matrix: the TPU kernel streamed a (256, 128) weight tile
//     beside the data.  Here each thread makes its own weights r^i in
//     registers: r^i of its first lane by square-and-multiply from the
//     32-entry table kRPow2 of r^(2^k), then one multiply by the stride
//     factor r^kThreads per further lane;
//   * no second pass: the TPU wrapper combined per-block partials with a
//     host loop of r^(b·L) factors.  Here a block's lanes carry their
//     absolute weights already, so the block's partial is simply added
//     into out[row] with atomicAdd (the wrapper zeroes `out` first).
//     Unsigned addition mod 2^32 is associative and commutative, so the
//     result is bit-exact whatever order the blocks land in.
//
// Exponents: r is odd, so its multiplicative order mod 2^32 divides 2^30;
// in fact r^(2^28) = 1 (the table's tail), so bits of i above 27 multiply
// by 1 and any lane index is exact.
//
// Products and sums are uint32, which wrap mod 2^32 by definition.
//
// Built by kernels/checksum/checksum.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                                   // lanes a thread takes per block
constexpr long long kChunk = static_cast<long long>(kThreads) * kItems;  // lanes per block

// r^(2^k) mod 2^32, k = 0..31 (tests/test_torch_checksum.py checks them).
__constant__ uint32_t kRPow2[32] = {
    0x9E3779B1u, 0xFFE6CC61u, 0x1F76BCC1u, 0x4B180981u,
    0x5E8A5301u, 0x53FDA601u, 0x2F9F4C01u, 0xDDCE9801u,
    0xB5DD3001u, 0x54BA6001u, 0x4D74C001u, 0x2AE98001u,
    0x95D30001u, 0x2BA60001u, 0x574C0001u, 0xAE980001u,
    0x5D300001u, 0xBA600001u, 0x74C00001u, 0xE9800001u,
    0xD3000001u, 0xA6000001u, 0x4C000001u, 0x98000001u,
    0x30000001u, 0x60000001u, 0xC0000001u, 0x80000001u,
    0x00000001u, 0x00000001u, 0x00000001u, 0x00000001u,
};

// kThreads = 2^8, so the stride factor r^kThreads is kRPow2[8].
constexpr int kStrideLog2 = 8;
static_assert((1 << kStrideLog2) == kThreads, "stride factor index");

__device__ __forceinline__ uint32_t r_pow(unsigned long long i) {
  uint32_t acc = 1u;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if ((i >> k) & 1ull) acc *= kRPow2[k];   // uniform address: broadcast
  }
  return acc;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
checksum_rows_kernel(const uint32_t* __restrict__ mat, uint32_t* __restrict__ out,
                     long long lanes, long long blocks_per_row) {
  const long long row = static_cast<long long>(blockIdx.x) / blocks_per_row;
  const long long part = static_cast<long long>(blockIdx.x) - row * blocks_per_row;
  const uint32_t* src = mat + row * lanes;
  const long long first = part * kChunk + threadIdx.x;

  uint32_t w = r_pow(static_cast<unsigned long long>(first));
  const uint32_t stride = kRPow2[kStrideLog2];
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = first + static_cast<long long>(k) * kThreads;
    if (i < lanes) acc += __ldg(src + i) * w;
    w *= stride;
  }

  __shared__ uint32_t warp_sums[kThreads / 32];
  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0u;
    acc = warp_sum(acc);
    if (lane == 0 && acc != 0u) atomicAdd(out + row, acc);
  }
}

}  // namespace

// Hash every row of the contiguous [rows, lanes] uint32 matrix `mat` into
// out[rows] (uint32, zeroed by the caller) on `stream`.  Launches one
// kernel, does not synchronise, and returns the cudaError_t of the launch
// (0 on success).
extern "C" int arcadia_checksum_rows(const void* mat, void* out, long long rows,
                                     long long lanes, void* stream) {
  if (rows <= 0 || lanes <= 0) return 0;
  const long long blocks_per_row = (lanes + kChunk - 1) / kChunk;
  if (rows > 0x7fffffffLL / blocks_per_row) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(rows * blocks_per_row);
  checksum_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mat), static_cast<uint32_t*>(out), lanes, blocks_per_row);
  return static_cast<int>(cudaGetLastError());
}
