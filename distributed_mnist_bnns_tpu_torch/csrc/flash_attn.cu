// Flash attention, forward (K4) and backward (K5: dq; K6: dk and dv), for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of distributed_mnist_bnns_tpu/ops/
// flash_attention.py: _flash_kernel (K4), _flash_bwd_dq_kernel (K5) and
// _flash_bwd_dkv_kernel (K6).
//
// Operands (all contiguous fp32, in the JAX package's (B, L, H, D) layout, so
// no transpose is copied around a call):
//   q, dout          (B, Lq, H, D)    queries, cotangent of out
//   k, v             (B, Lk, H, D)    keys, values
//   out              (B, Lq, H, D)    K4's output
//   lse, coeff       (B, Lq, H)       K4's log-sum-exp; coeff = g_lse - delta,
//                                     delta = rowsum(dout * out) (PyTorch)
//   dq | dk, dv      like q | like k  K5's | K6's outputs
// Query row i attends keys j < Lk, and with `causal` only j <= i + Lk - Lq
// (bottom-right aligned; the wrapper refuses causal with Lq > Lk). The scale
// is d^-0.5 of the real head_dim, passed in.
//
// The TPU kernels walk a sequential grid axis over key (K4, K5) or query (K6)
// blocks and carry (m, l, acc) or the gradient sums in VMEM scratch. Here a
// block of 256 threads owns one (batch*head, tile of 64 rows) and walks the
// other axis in a loop, tile by tile: K4 and K5 one query tile against key
// tiles 0.. up to the causal diagonal, K6 one key tile against query tiles
// from the diagonal on. Each tile of the streamed operand is staged in shared
// memory once and read by every row of the resident tile: that is the reuse
// the TPU's VMEM blocks gave. The 256 threads form a 16 x 16 grid; thread
// (ty, tx) owns rows ty + 16 i (i < 4) and columns tx + 16 j of every 64-wide
// product, so each product is a register-tiled SIMT matrix multiply out of
// shared memory, and a row's softmax max and sum are shuffles among the 16
// lanes that share it. Tiles in shared memory have an odd row stride, so the
// 16 lanes that read 16 different rows at one column hit 16 different banks.
// The ragged edges (rows past L, columns past D) are zero-filled on the chip
// and masked; nothing is padded in device memory.
//
// dq and dk/dv are two kernels, as on the TPU, so that every output element
// has exactly one writer: no atomics, and two runs are bitwise equal.
//
// The softmax follows the JAX kernels (flash_attention.py:101-127, 295-304):
// masked scores are NEG_INF = -1e30; p = exp(s - m) only where s > NEG_INF/2;
// the correction exp(m_prev - m_new) is 0 while m_prev is still NEG_INF; a row
// with l == 0 gives out 0 and lse NEG_INF. The backward's p is forced to 0 for
// padded rows and columns, causally masked pairs and rows whose lse is
// NEG_INF. Key tiles past a query tile's diagonal are not visited (K4, K5),
// nor query tiles before a key tile's diagonal (K6): every pair in them is
// masked, and a fully masked tile leaves (m, l, acc) and the sums as they are.
//
// What bounds it on an H100: counting only the unmasked (query, key) pairs
// (32 heads x 1024 x 1025 / 2 = 16.8 M at the LM's training width), K4 does
// 4D, K5 6D and K6 8D fp32 operations a pair: 4.3, 6.4 and 8.6 GFLOP, 64, 96
// and 128 us at the 67 TFLOP/s fp32 peak; their bytes (about 34 MB for K4)
// take about 10 us at 3.35 TB/s. So all three are bound by operations.
// Everything is exact fp32 on the CUDA cores (no TF32, no fast-math exp), as
// the JAX kernels compute at Precision.HIGHEST. This first design reads both
// operands of every multiply-add from shared memory with scalar loads, two
// loads for each multiply-add in a 4 x 4 register tile, so the shared-memory
// pipe and not the FMA units sets its pace; wider register tiles, vector
// loads and tensor cores (a TF32 or bf16 tolerance) are later work.

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
template <int DC>
constexpr size_t smem_dq() {
  return sizeof(float) * (4 * TILE * ld_of<DC>() + TILE * LDP);
}
template <int DC>
constexpr size_t smem_dkv() {
  return sizeof(float) * (4 * TILE * ld_of<DC>() + 2 * TILE * LDP + 2 * TILE);
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

// K5: grid (B * H, query tiles); dq = sum_j ds k_j over key tiles up to the
// diagonal, ds = p * (do . v_j + coeff) * scale, p = exp(s - lse).
template <int DC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ coeff,
                    float* __restrict__ dq, int H, int Lq, int Lk, int D,
                    float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = ld_of<DC>();
  float* Qs = smem;
  float* dOs = Qs + TILE * LD;
  float* Ks = dOs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ss = Vs + TILE * LD;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * TILE;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int off = Lk - Lq;
  load_tile<DC>(Qs, q, b, h, q0, Lq, H, D);
  load_tile<DC>(dOs, dout, b, h, q0, Lq, H, D);
  float lse_r[TR], coeff_r[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qi = q0 + ty + 16 * i;
    const size_t row = (static_cast<size_t>(b) * Lq + qi) * H + h;
    lse_r[i] = qi < Lq ? lse[row] : NEG_INF;
    coeff_r[i] = qi < Lq ? coeff[row] : 0.0f;
  }
  float acc[TR][DC];
  zero(acc);
  const int k_end = causal ? min(Lk, q0 + TILE + off) : Lk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();
    load_tile<DC>(Ks, k, b, h, k0, Lk, H, D);
    load_tile<DC>(Vs, v, b, h, k0, Lk, H, D);
    __syncthreads();
    float s[TR][TC], dp[TR][TC];
    zero(s);
    zero(dp);
    tile_mma<TC>(s, Qs, LD, 1, Ks, LD, 1, D, ty, tx);
    tile_mma<TC>(dp, dOs, LD, 1, Vs, LD, 1, D, ty, tx);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool invalid = kj >= Lk || qi >= Lq ||
                             (causal && kj > qi + off) || lse_r[i] < NEG_INF / 2;
        const float p = invalid ? 0.0f : expf(s[i][j] * scale - lse_r[i]);
        Ss[(ty + 16 * i) * LDP + tx + 16 * j] = p * (dp[i][j] + coeff_r[i]) * scale;
      }
    }
    __syncthreads();
    // dq[r][d] += sum_x dS[r][x] * K[x][d]
    tile_mma<DC>(acc, Ss, LDP, 1, Ks, 1, LD, TILE, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Lq) continue;
    const size_t row = (static_cast<size_t>(b) * Lq + qi) * H + h;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dq[row * D + d] = acc[i][c];
    }
  }
}

// K6: grid (B * H, key tiles); dv = sum_i p^T do_i and dk = sum_i ds^T q_i
// over query tiles from the diagonal on. A thread's rows are keys, its score
// columns queries.
template <int DC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ coeff,
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int Lq, int Lk, int D, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = ld_of<DC>();
  float* Ks = smem;
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* dOs = Qs + TILE * LD;
  float* Ps = dOs + TILE * LD;
  float* Ss = Ps + TILE * LDP;
  float* lse_s = Ss + TILE * LDP;
  float* coeff_s = lse_s + TILE;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int c0 = blockIdx.y * TILE;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int off = Lk - Lq;
  load_tile<DC>(Ks, k, b, h, c0, Lk, H, D);
  load_tile<DC>(Vs, v, b, h, c0, Lk, H, D);
  float dk_acc[TR][DC], dv_acc[TR][DC];
  zero(dk_acc);
  zero(dv_acc);
  // first query row that sees key c0 is c0 - off
  const int q_begin = causal ? max(0, c0 - off) / TILE * TILE : 0;
  for (int q0 = q_begin; q0 < Lq; q0 += TILE) {
    __syncthreads();
    load_tile<DC>(Qs, q, b, h, q0, Lq, H, D);
    load_tile<DC>(dOs, dout, b, h, q0, Lq, H, D);
    if (threadIdx.x < TILE) {
      const int qi = q0 + threadIdx.x;
      const size_t row = (static_cast<size_t>(b) * Lq + qi) * H + h;
      lse_s[threadIdx.x] = qi < Lq ? lse[row] : NEG_INF;
      coeff_s[threadIdx.x] = qi < Lq ? coeff[row] : 0.0f;
    }
    __syncthreads();
    float s[TR][TC], dp[TR][TC];
    zero(s);
    zero(dp);
    tile_mma<TC>(s, Ks, LD, 1, Qs, LD, 1, D, ty, tx);    // s[c][r] = k_c . q_r
    tile_mma<TC>(dp, Vs, LD, 1, dOs, LD, 1, D, ty, tx);  // dp[c][r] = v_c . do_r
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int kc = c0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int r = tx + 16 * j;
        const int qr = q0 + r;
        const float lse_q = lse_s[r];
        const bool invalid = kc >= Lk || qr >= Lq ||
                             (causal && kc > qr + off) || lse_q < NEG_INF / 2;
        const float p = invalid ? 0.0f : expf(s[i][j] * scale - lse_q);
        Ps[(ty + 16 * i) * LDP + r] = p;
        Ss[(ty + 16 * i) * LDP + r] = p * (dp[i][j] + coeff_s[r]) * scale;
      }
    }
    __syncthreads();
    // dv[c][d] += sum_x P[c][x] * dO[x][d];  dk[c][d] += sum_x dS[c][x] * Q[x][d]
    tile_mma<DC>(dv_acc, Ps, LDP, 1, dOs, 1, LD, TILE, ty, tx);
    tile_mma<DC>(dk_acc, Ss, LDP, 1, Qs, 1, LD, TILE, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int kc = c0 + ty + 16 * i;
    if (kc >= Lk) continue;
    const size_t row = (static_cast<size_t>(b) * Lk + kc) * H + h;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk[row * D + d] = dk_acc[i][c];
        dv[row * D + d] = dv_acc[i][c];
      }
    }
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

template <int DC>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* coeff,
                      float* dq, int B, int H, int Lq, int Lk, int D,
                      int causal, float scale, cudaStream_t stream) {
  static bool done = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<DC>, smem_dq<DC>(), &done);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lq + TILE - 1) / TILE);
  flash_bwd_dq_kernel<DC><<<grid, THREADS, smem_dq<DC>(), stream>>>(
      q, k, v, dout, lse, coeff, dq, H, Lq, Lk, D, scale, causal);
  return cudaGetLastError();
}

template <int DC>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* coeff,
                       float* dk, float* dv, int B, int H, int Lq, int Lk,
                       int D, int causal, float scale, cudaStream_t stream) {
  static bool done = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<DC>, smem_dkv<DC>(), &done);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lk + TILE - 1) / TILE);
  flash_bwd_dkv_kernel<DC><<<grid, THREADS, smem_dkv<DC>(), stream>>>(
      q, k, v, dout, lse, coeff, dk, dv, H, Lq, Lk, D, scale, causal);
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

int flash_bwd_dq(const float* q, const float* k, const float* v,
                 const float* dout, const float* lse, const float* coeff,
                 float* dq, int B, int H, int Lq, int Lk, int D, int causal,
                 float scale, void* stream) {
  if (!shape_ok(B, H, Lq, Lk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch_dq<1>(q, k, v, dout, lse, coeff, dq, B, H, Lq, Lk, D, causal, scale, s);
  if (D <= 32) return launch_dq<2>(q, k, v, dout, lse, coeff, dq, B, H, Lq, Lk, D, causal, scale, s);
  if (D <= 64) return launch_dq<4>(q, k, v, dout, lse, coeff, dq, B, H, Lq, Lk, D, causal, scale, s);
  return launch_dq<8>(q, k, v, dout, lse, coeff, dq, B, H, Lq, Lk, D, causal, scale, s);
}

int flash_bwd_dkv(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* coeff,
                  float* dk, float* dv, int B, int H, int Lq, int Lk, int D,
                  int causal, float scale, void* stream) {
  if (!shape_ok(B, H, Lq, Lk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch_dkv<1>(q, k, v, dout, lse, coeff, dk, dv, B, H, Lq, Lk, D, causal, scale, s);
  if (D <= 32) return launch_dkv<2>(q, k, v, dout, lse, coeff, dk, dv, B, H, Lq, Lk, D, causal, scale, s);
  if (D <= 64) return launch_dkv<4>(q, k, v, dout, lse, coeff, dk, dv, B, H, Lq, Lk, D, causal, scale, s);
  return launch_dkv<8>(q, k, v, dout, lse, coeff, dk, dv, B, H, Lq, Lk, D, causal, scale, s);
}

}  // extern "C"
