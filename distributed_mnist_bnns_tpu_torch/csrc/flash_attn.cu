// Flash attention forward (K4) for Hopper (sm_90a). The backward kernels, K5
// (dq) and K6 (dk, dv), are in flash_bwd.cu.
//
// Replaces the TPU Pallas kernel _flash_kernel of distributed_mnist_bnns_tpu/
// ops/flash_attention.py.
//
// Operands (all contiguous fp32, in the JAX package's (B, L, H, D) layout, so
// no transpose is copied around a call):
//   q                (B, Lq, H, D)    queries
//   k, v             (B, Lk, H, D)    keys, values
//   out              (B, Lq, H, D)    output
//   lse              (B, Lq, H)       log-sum-exp of each query row's scores
// Query row i attends keys j < Lk, and with `causal` only j <= i + Lk - Lq
// (bottom-right aligned; the wrapper refuses causal with Lq > Lk). The scale
// is d^-0.5 of the real head_dim, passed in.
//
// The TPU kernel walks a sequential grid axis over key blocks and carries
// (m, l, acc) in VMEM scratch. Here a block of 256 threads owns one
// (batch*head, tile of 64 query rows) and walks the key tiles 0.. up to the
// causal diagonal in a loop. Each key tile is staged in shared memory once and
// read by every row of the query tile: that is the reuse the TPU's VMEM
// blocks gave. The 256 threads form a 16 x 16 grid; thread (ty, tx) owns rows
// ty + 16 i (i < 4) and columns tx + 16 j of every 64-wide product, so each
// product is a register-tiled SIMT matrix multiply out of shared memory, and
// a row's softmax max and sum are shuffles among the 16 lanes that share it.
// Tiles in shared memory have an odd row stride, so the 16 lanes that read 16
// different rows at one column hit 16 different banks. The ragged edges (rows
// past L, columns past D) are zero-filled on the chip and masked; nothing is
// padded in device memory.
//
// The softmax follows the JAX kernel (flash_attention.py:101-127): masked
// scores are NEG_INF = -1e30; p = exp(s - m) only where s > NEG_INF/2; the
// correction exp(m_prev - m_new) is 0 while m_prev is still NEG_INF; a row
// with l == 0 gives out 0 and lse NEG_INF. Key tiles past a query tile's
// diagonal are not visited: every pair in them is masked, and a fully masked
// tile leaves (m, l, acc) as they are.
//
// What bounds it on an H100: counting only the unmasked (query, key) pairs
// (32 heads x 1024 x 1025 / 2 = 16.8 M at the LM's training width), K4 does
// 4D fp32 operations a pair: 4.3 GFLOP, 64 us at the 67 TFLOP/s fp32 peak
// (26 us in 3xTF32 on the tensor cores, at 495 / 3 TFLOP/s); its bytes (about
// 34 MB) take about 10 us at 3.35 TB/s. So it is bound by operations.
// Everything is exact fp32 on the CUDA cores (no TF32, no fast-math exp), as
// the JAX kernel computes at Precision.HIGHEST. This first design reads both
// operands of every multiply-add from shared memory with scalar loads, two
// loads for each multiply-add in a 4 x 4 register tile, so the shared-memory
// pipe and not the FMA units sets its pace; the tensor cores in 3xTF32, as
// the backward kernels run, are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;      // rows of a tile, of queries or of keys
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int TR = 4;         // rows a thread owns: ty + 16 i
constexpr int TC = 4;         // score columns a thread owns: tx + 16 j
constexpr int LDP = TILE + 1; // row stride of a tile of scores
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

// Row stride of a (TILE, D) tile with DC = ceil(D / 16) accumulator columns
// per thread: 16 * DC columns (zero past D) plus one, odd.
template <int DC>
__host__ __device__ constexpr int ld_of() { return 16 * DC + 1; }

template <int DC>
constexpr size_t smem_fwd() {
  return sizeof(float) * (3 * TILE * ld_of<DC>() + TILE * LDP);
}

// acc[i][j] += sum_{x < n} A[(ty + 16 i) * a_r + x * a_x] * B[(tx + 16 j) * b_c + x * b_x]
template <int C>
__device__ __forceinline__ void tile_mma(float (&acc)[TR][C], const float* A,
                                         int a_r, int a_x, const float* B,
                                         int b_c, int b_x, int n, int ty,
                                         int tx) {
  for (int x = 0; x < n; ++x) {
    float a[TR], b[C];
#pragma unroll
    for (int i = 0; i < TR; ++i) a[i] = A[(ty + 16 * i) * a_r + x * a_x];
#pragma unroll
    for (int j = 0; j < C; ++j) b[j] = B[(tx + 16 * j) * b_c + x * b_x];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Rows [row0, row0 + TILE) of head h of batch b of a (B, L, H, D) tensor into
// dst[r * ld + d] for d < 16 * DC, zero past L and past D.
template <int DC>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int b,
                                          int h, int row0, int L, int H,
                                          int D) {
  constexpr int W = 16 * DC;
  for (int idx = threadIdx.x; idx < TILE * W; idx += THREADS) {
    const int r = idx / W, d = idx - r * W;
    const int l = row0 + r;
    float x = 0.0f;
    if (l < L && d < D) x = src[((static_cast<size_t>(b) * L + l) * H + h) * D + d];
    dst[r * ld_of<DC>() + d] = x;
  }
}

// Max and sum over the 16 lanes (one half-warp) that share a row.
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int C>
__device__ __forceinline__ void zero(float (&a)[TR][C]) {
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) a[i][j] = 0.0f;
}

// K4: grid (B * H, query tiles); causal runs the longest tiles first.
template <int DC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int Lq, int Lk, int D,
                 float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = ld_of<DC>();
  float* Qs = smem;
  float* Ks = Qs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ps = Vs + TILE * LD;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * TILE;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int off = Lk - Lq;
  load_tile<DC>(Qs, q, b, h, q0, Lq, H, D);

  float m[TR], l[TR], acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i) m[i] = NEG_INF, l[i] = 0.0f;
  zero(acc);
  const int k_end = causal ? min(Lk, q0 + TILE + off) : Lk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<DC>(Ks, k, b, h, k0, Lk, H, D);
    load_tile<DC>(Vs, v, b, h, k0, Lk, H, D);
    __syncthreads();
    float s[TR][TC];
    zero(s);
    tile_mma<TC>(s, Qs, LD, 1, Ks, LD, 1, D, ty, tx);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mb = NEG_INF;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < Lk && (!causal || kj <= qi + off);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mb = fmaxf(mb, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mb));
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        s[i][j] = s[i][j] > NEG_INF / 2 ? expf(s[i][j] - m_new) : 0.0f;
        ps += s[i][j];
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
      }
      const float corr = m[i] > NEG_INF / 2 ? expf(m[i] - m_new) : 0.0f;
      m[i] = m_new;
      l[i] = l[i] * corr + row_sum(ps);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    // acc[r][d] += sum_x P[r][x] * V[x][d]
    tile_mma<DC>(acc, Ps, LDP, 1, Vs, 1, LD, TILE, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Lq) continue;
    const float safe = l[i] == 0.0f ? 1.0f : l[i];
    const size_t row = (static_cast<size_t>(b) * Lq + qi) * H + h;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) out[row * D + d] = acc[i][c] / safe;
    }
    if (tx == 0) lse[row] = l[i] == 0.0f ? NEG_INF : m[i] + logf(safe);
  }
}

// Allow each instantiation the dynamic shared memory of its largest D, once
// per process (before any CUDA-graph capture: the wrappers' first launch).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

bool shape_ok(int B, int H, int Lq, int Lk, int D) {
  return B >= 1 && H >= 1 && Lq >= 1 && Lk >= 1 && D >= 1 && D <= MAX_D &&
         static_cast<long long>(B) * H <= 0x7fffffffLL &&
         (Lq + TILE - 1) / TILE <= 65535 && (Lk + TILE - 1) / TILE <= 65535;
}

template <int DC>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* out, float* lse, int B, int H, int Lq, int Lk,
                       int D, int causal, float scale, cudaStream_t stream) {
  static bool done = false;
  cudaError_t err = allow_smem(flash_fwd_kernel<DC>, smem_fwd<DC>(), &done);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lq + TILE - 1) / TILE);
  flash_fwd_kernel<DC><<<grid, THREADS, smem_fwd<DC>(), stream>>>(
      q, k, v, out, lse, H, Lq, Lk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() right after its launch (the Python wrapper
// raises if it is not 0), or cudaErrorInvalidValue for a shape the kernels do
// not take (a zero length, head_dim above 128, too many tiles).
int flash_fwd(const float* q, const float* k, const float* v, float* out,
              float* lse, int B, int H, int Lq, int Lk, int D, int causal,
              float scale, void* stream) {
  if (!shape_ok(B, H, Lq, Lk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch_fwd<1>(q, k, v, out, lse, B, H, Lq, Lk, D, causal, scale, s);
  if (D <= 32) return launch_fwd<2>(q, k, v, out, lse, B, H, Lq, Lk, D, causal, scale, s);
  if (D <= 64) return launch_fwd<4>(q, k, v, out, lse, B, H, Lq, Lk, D, causal, scale, s);
  return launch_fwd<8>(q, k, v, out, lse, B, H, Lq, Lk, D, causal, scale, s);
}

}  // extern "C"
