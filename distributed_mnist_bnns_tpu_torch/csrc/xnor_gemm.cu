// Packed ±1 GEMM (XNOR-popcount) with three epilogues, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of distributed_mnist_bnns_tpu/ops/xnor_gemm.py:
//   EPI_NONE   <- _xnor_kernel         o = K - 2 * sum_w popcount(x_w ^ w_w)
//   EPI_SIGN   <- _xnor_sign_kernel    where(a * (o + bias) >= t, +1, -1)
//   EPI_AFFINE <- _xnor_affine_kernel  clip(a * (o + bias) + c, -1, 1)
// The TPU kernels walk packed K as a sequential grid axis that revisits the
// output tile; here K is a loop inside the block, and blocks run in parallel
// over (M, N) tiles.
//
// Operands: x is (M, KW) int32, packed activations, row-major. w is K-major
// (KW_p >= KW rows, ldw >= N columns) int32, the layout of prepack_weights,
// so that neighbouring threads (neighbouring n) read neighbouring words.
// Output (M, N) fp32, row-major. The kernel masks the ragged M and N edges
// itself; padded weight columns beyond N are never read.
//
// Design: one thread per output (m, n). A block covers BM rows x BN columns.
// The block's x rows are staged through shared memory KC words at a time
// (every thread of a row then reads the same word: a broadcast), and each
// thread streams its weight column from global memory (coalesced across the
// warp; the BM row-threads of a block share it through L1). Mismatches are
// summed in int32 with __popc, and o = (float)K - (float)(2 * mism) is exact
// because |o| <= K <= 2^24.
//
// What bounds it on an H100: at the MLP's layer-2 shape with M = 32
// (K = 3072 -> 96 words, N = 1536) the work is 32 * 1536 * 96 = 4.7 M popc
// of 32 bits and about 0.8 MB moved, microseconds of either at the card's
// rates, so the kernel is bound by launch latency and by the latency of the
// dependent load -> xor -> popc chain, not by bytes or operations. The simple
// design answers that with many independent threads (one per output, no
// cross-thread reduction, no second pass) and a single launch per layer with
// the epilogue fused, so the fp32 pre-activation never goes back to device
// memory. Tensor-core b1 products, packed-bit output and a fused activation
// pack are later work.
//
// Rounding in the epilogues is spelled out with intrinsics, so nvcc has no
// choice to make. The sign epilogue rounds after each operation
// (__fadd_rn, __fmul_rn). The affine epilogue rounds the bias add, then does
// a*y + c as one fused multiply-add (__fmaf_rn): XLA contracts that pair into
// an FMA where the JAX package runs it, so one rounding is what the reference
// computes. The plain PyTorch version rounds the same way (it emulates the
// FMA exactly), and the two agree bitwise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 128;  // threads along N (one output column each)
constexpr int BM = 4;    // threads along M (one output row each)
constexpr int KC = 256;  // packed words of x staged per chunk

enum Epilogue { EPI_NONE = 0, EPI_SIGN = 1, EPI_AFFINE = 2 };

template <int EPI>
__global__ void __launch_bounds__(BN * BM)
xnor_gemm_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
                 const float* __restrict__ va, const float* __restrict__ vb,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int m_rows, int n_cols, int kw, int ldw, int k_bits) {
  __shared__ int32_t xs[BM][KC];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int n = blockIdx.x * BN + tx;
  const int m0 = blockIdx.y * BM;
  const int m = m0 + ty;
  const bool live = (m < m_rows) && (n < n_cols);
  const int tid = ty * BN + tx;

  int mism = 0;
  for (int k0 = 0; k0 < kw; k0 += KC) {
    const int kc = min(KC, kw - k0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int idx = tid; idx < BM * KC; idx += BN * BM) {
      const int i = idx / KC;
      const int j = idx - i * KC;
      const int gm = m0 + i;
      xs[i][j] = (gm < m_rows && j < kc)
                     ? x[static_cast<size_t>(gm) * kw + k0 + j] : 0;
    }
    __syncthreads();
    if (live) {
      const int32_t* wp = w + static_cast<size_t>(k0) * ldw + n;
#pragma unroll 8
      for (int t = 0; t < kc; ++t) {
        mism += __popc(static_cast<unsigned>(xs[ty][t] ^ wp[static_cast<size_t>(t) * ldw]));
      }
    }
  }
  if (!live) return;

  const float o = __fsub_rn(__int2float_rn(k_bits), __int2float_rn(2 * mism));
  float r;
  if (EPI == EPI_NONE) {
    r = o;
  } else if (EPI == EPI_SIGN) {
    const float y = __fadd_rn(o, bias[n]);
    r = (__fmul_rn(va[n], y) >= vb[n]) ? 1.0f : -1.0f;
  } else {
    const float y = __fmaf_rn(va[n], __fadd_rn(o, bias[n]), vb[n]);
    // NaN passes through, as torch.clamp and jnp.clip let it.
    r = (y < -1.0f) ? -1.0f : ((y > 1.0f) ? 1.0f : y);
  }
  out[static_cast<size_t>(m) * n_cols + n] = r;
}

template <int EPI>
int launch(const int32_t* x, const int32_t* w, const float* va, const float* vb,
           const float* bias, float* out, int m_rows, int n_cols, int kw,
           int ldw, int k_bits, void* stream) {
  dim3 block(BN, BM);
  dim3 grid((n_cols + BN - 1) / BN, (m_rows + BM - 1) / BM);
  xnor_gemm_kernel<EPI><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, va, vb, bias, out, m_rows, n_cols, kw, ldw, k_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() right after the launch; the
// Python wrapper raises if it is not 0 (cudaSuccess).

int xnor_gemm_none(const int32_t* x, const int32_t* w, float* out, int m_rows,
                   int n_cols, int kw, int ldw, int k_bits, void* stream) {
  return launch<EPI_NONE>(x, w, nullptr, nullptr, nullptr, out, m_rows, n_cols,
                          kw, ldw, k_bits, stream);
}

int xnor_gemm_sign(const int32_t* x, const int32_t* w, const float* a,
                   const float* t, const float* bias, float* out, int m_rows,
                   int n_cols, int kw, int ldw, int k_bits, void* stream) {
  return launch<EPI_SIGN>(x, w, a, t, bias, out, m_rows, n_cols, kw, ldw,
                          k_bits, stream);
}

int xnor_gemm_affine(const int32_t* x, const int32_t* w, const float* a,
                     const float* c, const float* bias, float* out, int m_rows,
                     int n_cols, int kw, int ldw, int k_bits, void* stream) {
  return launch<EPI_AFFINE>(x, w, a, c, bias, out, m_rows, n_cols, kw, ldw,
                            k_bits, stream);
}

}  // extern "C"
