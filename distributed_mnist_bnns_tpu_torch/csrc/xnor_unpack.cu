// fp32 activations times packed ±1 weights, the bitplanes unpacked inside
// the GEMM, for Hopper (sm_90a), on the tensor cores.
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
// K (k_bits), x is never read past it and its tile is zero-filled in shared
// memory, so neither the weight padding nor memory beyond x reaches the sum.
//
// What bounds it on an H100: at the LM's prefill shape (M = 16, K = 256,
// N = 512) the work is 4.2 MFLOP and about 50 KB of bytes moved: well under a
// microsecond of either at the card's rates, so the kernel is bound by
// latency: the launch, the copies, and the chain of dependent operations of
// one thread. A first design (one thread per output column, every bit a
// select and an fp32 add, 8 blocks at that shape) ran one chain of ~6k
// instructions per thread on 8 SMs. This one spreads the work over at
// least 32 blocks and runs it on the tensor cores:
// - mma.sync m16n8k16, bf16 operands, fp32 accumulation. A block of 4 warps
//   owns 16 rows and 16 columns (two n8 tiles) of the output; its warps split
//   the K steps of each chunk of 256 (4 x 16 = 64 k each) and their partial
//   sums are added in shared memory in a fixed order (warp 0, 1, 2, 3): no
//   atomics, so two runs are bitwise equal.
// - B (the ±1 weights) is built in registers from the packed word, with no
//   conversion: lane (g, t)'s B fragment holds K rows 2t, 2t + 1, 2t + 8 and
//   2t + 9 of column g, all in one word, each pair one register of two bf16s,
//   0x3F80 (+1) with the sign bit set where the weight bit is 0 (-1). One
//   coalesced 32-bit load of a word serves two k16 steps.
// - A (x) is split exactly into three bf16 pieces: hi = bf16(x), mid =
//   bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest. Three
//   times 8 significand bits cover fp32's 24, so hi + mid + lo == x for
//   fp32 x of magnitude above about 2^-100 (below it lo falls under bf16's
//   normal range), and each piece times ±1 is exact: three mma per k16 step,
//   as the JAX kernel multiplies at Precision.HIGHEST and accepts any real
//   x. On the LM's ±1 activations mid = lo = 0. The x tile is copied with
//   cp.async (double-buffered over chunks of 256), and every warp splits the
//   values it reads when it loads its A fragments: each x value is read by
//   one warp of the block only.
// - The tensor cores truncate where they add, so each k16 step's three mma
//   run from a zero accumulator (lo, then mid, then hi) and the step is added
//   to the output's sum in fp32, rounded to nearest. On ±1 x every partial
//   sum is an integer of size at most K, exact in fp32 up to K = 2^24, so
//   the result equals the plain version bitwise in any order; on real x it
//   is an fp32 sum in another order.

#include <cstring>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BM = 16;       // output rows of a block: one m16 tile
constexpr int BN = 16;       // output columns of a block: two n8 tiles
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KC = 256;      // x values of a row staged per chunk (8 words)
constexpr int LD = KC + 8;   // row stride of the staged x tile, in floats
constexpr int STEPS = KC / 16 / WARPS;  // k16 steps of a warp per chunk

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// hi, mid and lo pieces of two consecutive x values, each packed as the
// register of an A fragment (the lower K index in the lower half).
__device__ __forceinline__ void split3(float2 x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(x.x - hf.x, x.y - hf.y);
  const __nv_bfloat162 md = __floats2bfloat162_rn(r.x, r.y);
  const float2 mf = __bfloat1622float2(md);
  hi = bits_of(h);
  mid = bits_of(md);
  lo = bits_of(__floats2bfloat162_rn(r.x - mf.x, r.y - mf.y));
}

// Two bf16 ±1 weights from bits 0 and 1 of `bits`: 0x3F80 is +1, and the
// sign bit is set where the weight bit is 0.
__device__ __forceinline__ uint32_t pm1_pair(uint32_t bits) {
  const uint32_t neg = ~bits;
  return 0x3F803F80u | ((neg & 1u) << 15) | ((neg & 2u) << 30);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts of m16n8k16 (lane = 4 g + t), two bf16s a register:
// A registers (row, cols) = (g, 2t..2t+1), (g + 8, 2t..), (g, 2t+8..),
// (g + 8, 2t+8..); B registers (k rows, col) = (2t..2t+1, g), (2t+8.., g);
// C (row, col) = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

// grid (column blocks, row blocks)
__global__ void __launch_bounds__(THREADS)
xnor_unpack_kernel(const float* __restrict__ x, const int32_t* __restrict__ w,
                   float* __restrict__ out, int m_rows, int n_cols, int ldw,
                   int k_bits, int vec) {
  __shared__ __align__(16) float xs[2][BM * LD];
  __shared__ float part[WARPS][2][4][32];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_chunks = (k_bits + KC - 1) / KC;

  // x rows m0.. and columns c * KC.. into stage c & 1, zero past M and K.
  auto stage = [&](int c) {
    float* dst = xs[c & 1];
    const int k0 = c * KC;
    if (vec) {
      for (int idx = threadIdx.x; idx < BM * KC / 4; idx += THREADS) {
        const int r = idx / (KC / 4), j = 4 * (idx % (KC / 4));
        const bool ok = m0 + r < m_rows && k0 + j < k_bits;
        cp_async16(dst + r * LD + j,
                   ok ? x + static_cast<size_t>(m0 + r) * k_bits + k0 + j : x,
                   ok ? 16 : 0);
      }
    } else {
      for (int idx = threadIdx.x; idx < BM * KC; idx += THREADS) {
        const int r = idx / KC, j = idx % KC;
        const bool ok = m0 + r < m_rows && k0 + j < k_bits;
        cp_async4(dst + r * LD + j,
                  ok ? x + static_cast<size_t>(m0 + r) * k_bits + k0 + j : x,
                  ok ? 4 : 0);
      }
    }
  };

  float acc[2][4] = {};
  stage(0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; every warp is done with c - 1
    if (c + 1 < n_chunks) {
      stage(c + 1);
      cp_async_commit();
    }
    const float* xc = xs[c & 1];
#pragma unroll
    for (int pair = 0; pair < STEPS / 2; ++pair) {
      const int s0 = warp * STEPS + 2 * pair;  // first of two k16 steps
      const int kb = c * KC + 16 * s0;         // a multiple of 32: one word
      if (kb >= k_bits) break;                 // the same in the whole warp
      uint32_t word[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + 8 * j + g;
        word[j] = n < n_cols
                      ? static_cast<uint32_t>(w[static_cast<size_t>(kb / 32) * ldw + n])
                      : 0u;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (kb + 16 * half >= k_bits) break;
        const float* p = xc + g * LD + 16 * (s0 + half) + 2 * t;
        uint32_t a[3][4];  // hi, mid, lo
        split3(*reinterpret_cast<const float2*>(p), a[0][0], a[1][0], a[2][0]);
        split3(*reinterpret_cast<const float2*>(p + 8 * LD), a[0][1], a[1][1], a[2][1]);
        split3(*reinterpret_cast<const float2*>(p + 8), a[0][2], a[1][2], a[2][2]);
        split3(*reinterpret_cast<const float2*>(p + 8 * LD + 8), a[0][3], a[1][3],
               a[2][3]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t bits = word[j] >> (16 * half + 2 * t);
          const uint32_t b0 = pm1_pair(bits), b1 = pm1_pair(bits >> 8);
          float step[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(step, a[2], b0, b1);
          mma_bf16(step, a[1], b0, b1);
          mma_bf16(step, a[0], b0, b1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += step[e];
        }
      }
    }
  }
  cp_async_wait_all();

  // The warps' partial sums, added in a fixed order.
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[warp][j][e][lane] = acc[j][e];
  __syncthreads();
  for (int idx = threadIdx.x; idx < 2 * 4 * 32; idx += THREADS) {
    const int j = idx / 128, e = (idx / 32) % 4, ln = idx % 32;
    float sum = part[0][j][e][ln];
#pragma unroll
    for (int wp = 1; wp < WARPS; ++wp) sum += part[wp][j][e][ln];
    const int row = m0 + ln / 4 + 8 * (e >> 1);
    const int col = n0 + 8 * j + 2 * (ln % 4) + (e & 1);
    if (row < m_rows && col < n_cols)
      out[static_cast<size_t>(row) * n_cols + col] = sum;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() right after the launch (the Python wrapper
// raises if it is not 0), or cudaErrorInvalidValue for a shape the kernel
// does not take (too many row blocks for the grid).
int xnor_unpack(const float* x, const int32_t* w, float* out, int m_rows,
                int n_cols, int ldw, int k_bits, void* stream) {
  const int row_blocks = (m_rows + BM - 1) / BM;
  if (m_rows < 1 || n_cols < 1 || k_bits < 0 || row_blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n_cols + BN - 1) / BN, row_blocks);
  const int vec = k_bits % 4 == 0 && aligned16(x);
  xnor_unpack_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, m_rows, n_cols, ldw, k_bits, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
