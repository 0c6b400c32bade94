// fp32 activations times packed ±1 weights, the bitplanes unpacked inside
// the GEMM, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel _fused_unpack_kernel of
// distributed_mnist_bnns_tpu/ops/xnor_gemm.py (xnor_matmul_fused_unpack):
//   out[m, n] = sum_k x[m, k] * w[k, n],  w[k, n] = 2 * bit(k, n) - 1,
// where bit b of packed word kw is K index kw * 32 + b (LSB first, as
// bitpack.unpack_bits). The unpacked (K, N) matrix never reaches device
// memory.
//
// Operands: x is (M, K) fp32, row-major, unpadded. w is K-major (KW_p >= KW
// rows, ldw >= N columns) int32, the layout of prepack_weights, read as it
// is: the entry never pads the weights per call. Output (M, N) fp32.
//
// Padding: zero words past the real K would unpack to -1. The TPU entry
// cancels them with zero-padded x columns; here the K loop stops at the real
// K (k_bits) and x is never read past it, so neither the weight padding nor
// memory beyond x can reach the sum.
//
// Design: one thread per output column n and TM rows. A block covers 128
// columns x TM rows. The block's x rows are staged through shared memory KC
// values at a time (every thread reads the same x value: a broadcast). Each
// thread reads its weight column one packed word at a time (coalesced across
// the warp: neighbouring threads hold neighbouring n), and applies each bit
// to its TM row accumulators as an add or a subtract of x: one word of
// weights serves 32 x TM products, and the bitplane never leaves registers.
// The sum runs in fp32 in increasing k. On ±1 x (the LM's binarized
// activations) every partial sum is an integer of size at most K, so the
// result is exact and equals any other order bitwise; on real-valued x it is
// a sequential fp32 sum.
//
// What bounds it on an H100: at the LM's prefill shape (M = 16, K = 256,
// N = 512) the work is 4.2 MFLOP and about 50 KB of bytes moved: well under a
// microsecond of either at the card's rates (67 TFLOP/s fp32, 3.35 TB/s), so
// the kernel is bound by launch latency and by the dependent add chain of
// each accumulator. The simple design answers with many independent
// accumulators (TM a thread, one thread per output column) and a single
// launch. Tensor-core products on the unpacked tile (bf16 ±1 is exact) and
// splitting K across warps are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 128;  // threads (output columns) per block
constexpr int TM = 8;    // output rows per thread
constexpr int KC = 256;  // x values (8 packed words) staged per chunk

__global__ void __launch_bounds__(BN)
xnor_unpack_kernel(const float* __restrict__ x, const int32_t* __restrict__ w,
                   float* __restrict__ out, int m_rows, int n_cols, int ldw,
                   int k_bits) {
  __shared__ float xs[TM][KC];

  const int n = blockIdx.x * BN + threadIdx.x;
  const int m0 = blockIdx.y * TM;
  const bool live = n < n_cols;

  float acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) acc[r] = 0.0f;

  for (int k0 = 0; k0 < k_bits; k0 += KC) {
    const int kc = min(KC, k_bits - k0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int idx = threadIdx.x; idx < TM * KC; idx += BN) {
      const int r = idx / KC;
      const int j = idx - r * KC;
      const int gm = m0 + r;
      xs[r][j] = (gm < m_rows && j < kc)
                     ? x[static_cast<size_t>(gm) * k_bits + k0 + j] : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    const int32_t* wp = w + static_cast<size_t>(k0 / 32) * ldw + n;
    for (int t = 0; t * 32 < kc; ++t) {
      const unsigned word = static_cast<unsigned>(wp[static_cast<size_t>(t) * ldw]);
      const int bits = min(32, kc - t * 32);
      for (int b = 0; b < bits; ++b) {
        const bool plus = (word >> b) & 1u;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float xv = xs[r][t * 32 + b];
          acc[r] = plus ? __fadd_rn(acc[r], xv) : __fsub_rn(acc[r], xv);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    if (m0 + r < m_rows) out[static_cast<size_t>(m0 + r) * n_cols + n] = acc[r];
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() right after the launch; the Python wrapper
// raises if it is not 0 (cudaSuccess).
int xnor_unpack(const float* x, const int32_t* w, float* out, int m_rows,
                int n_cols, int ldw, int k_bits, void* stream) {
  dim3 block(BN);
  dim3 grid((n_cols + BN - 1) / BN, (m_rows + TM - 1) / TM);
  xnor_unpack_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, m_rows, n_cols, ldw, k_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
