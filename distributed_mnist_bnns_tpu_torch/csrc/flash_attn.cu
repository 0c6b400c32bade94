// Flash attention forward (K4) for Hopper (sm_90a): the scores in exact fp32
// on the CUDA cores, P V on the tensor cores in 3xTF32. The backward
// kernels, K5 (dq) and K6 (dk, dv), are in flash_bwd.cu; the helpers the
// three share (the split products, the tile copies, the fragment layouts) in
// flash_common.cuh.
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
// What bounds it on an H100: counting only the unmasked (query, key) pairs
// (32 heads x 1024 x 1025 / 2 = 16.8 M at the LM's training width), K4 does
// 4D operations a pair: 4.3 GFLOP, 26 us in 3xTF32 on the tensor cores (495 /
// 3 TFLOP/s; 64 us in fp32 on the CUDA cores); its bytes (about 34 MB) take
// about 10 us at 3.35 TB/s. So it is bound by operations.
//
// The TPU kernel walks a sequential grid axis over key blocks and carries
// (m, l, acc) in VMEM scratch. Here a block of 4 warps owns one (batch*head,
// tile of 64 query rows), each warp 16 rows, and walks the key tiles of 64 up
// to the causal diagonal in a loop, the longest query tiles first:
// - S = Q K^T runs on the CUDA cores, each score one fmaf chain over the head
//   dim in increasing order, then scaled. The binarized LM's queries and
//   keys are integer sums plus a bias (scores of hundreds), and its
//   attention output feeds a sign: scores on the tensor cores in 3xTF32
//   (each 8-deep step summed from zero or not) differ from an fp32 GEMM's
//   in the last bits and flip enough of those signs that the flash model
//   left the exact-softmax model (chip_smoke.py's step parity and export
//   checks failed with such a K4). With this S the flash step's loss has
//   been bitwise the exact model's on the H100: PyTorch's fp32 GEMM summed
//   in the same order there, an order it does not promise. K5 and K6
//   recompute S by the same chains (flash_common.cuh, fma_scores), so
//   their p = exp(s - lse) is K4's bit for bit: with 3xTF32 scores there,
//   the LM step's gradients left the exact model's by about 1e-3.
// - O += P V runs as 3xTF32 mma.sync m16n8k8 (flash_common.cuh), each 8-key
//   step summed from zero and added in fp32, since the tensor cores truncate
//   where they add and O sums up to a thousand keys. S never leaves the
//   registers: the online softmax runs on the fragments, a row's max and sum
//   shuffled among the 4 lanes that share it, and P is split and relabelled
//   as the A operand of P V (a_from_c), V's B operand read in the same order.
// - The Q tile is copied once; K and V tiles are copied with cp.async into
//   one of two buffers while the other is multiplied, one barrier per tile.
//   Splitting each streamed tile once per block instead of in every warp did
//   not pay in K5 and K6, so every warp splits what it reads.
// - The head dim is a template parameter DP (16, 32, 64 or 128), and
//   __launch_bounds__(128, 2) lets ptxas give a thread up to 255 registers,
//   as K5 and K6 have it.
//
// The softmax follows the JAX kernel (flash_attention.py:101-127), in exact
// fp32 (precise expf and logf, no fast-math): masked scores are NEG_INF =
// -1e30; p = exp(s - m) only where s > NEG_INF/2; the correction exp(m_prev -
// m_new) is 0 while m_prev is still NEG_INF; a row with l == 0 gives out 0
// and lse NEG_INF. Key tiles past a query tile's diagonal are not visited:
// every pair in them is masked, and a fully masked tile leaves (m, l, acc)
// as they are. Every output element has one writer: two runs are bitwise
// equal.

#include "flash_common.cuh"

namespace {

template <int DP>
constexpr size_t smem_fwd() {  // Q; K, V in two stages
  return sizeof(float) * 5 * TILE * ld_of<DP>();
}

// Max and sum over the 4 lanes (t = 0..3) that share a row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// K4: grid (B * H, query tiles); causal runs the longest tiles first.
template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int Lq, int Lk, int D,
                 float scale, int causal, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = ld_of<DP>();
  constexpr int NK = TILE / 8;  // 8-key blocks of a key tile
  constexpr int ND = DP / 8;    // 8-column blocks of the head dim
  float* Qs = smem;
  float* KV = Qs + TILE * LD;  // stage s: K at KV + 2 s TILE LD, V after it
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * warp;
  const int off = Lk - Lq;

  load_tile<DP>(Qs, q, b, h, q0, TILE, Lq, H, D, vec);
  const int k_end = causal ? min(Lk, q0 + TILE + off) : Lk;
  const int n_tiles = k_end > 0 ? (k_end + TILE - 1) / TILE : 0;
  if (n_tiles > 0) {
    load_tile<DP>(KV, k, b, h, 0, TILE, Lk, H, D, vec);
    load_tile<DP>(KV + TILE * LD, v, b, h, 0, TILE, Lk, H, D, vec);
  }
  cp_async_commit();

  // a lane's rows: r0 + g (i = 0) and r0 + g + 8 (i = 1)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float acc[ND][4];
  zero(acc);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * TILE;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_tiles) {
      float* nxt = KV + ((it + 1) & 1) * 2 * TILE * LD;
      load_tile<DP>(nxt, k, b, h, k0 + TILE, TILE, Lk, H, D, vec);
      load_tile<DP>(nxt + TILE * LD, v, b, h, k0 + TILE, TILE, Lk, H, D, vec);
      cp_async_commit();
    }
    const float* Ks = KV + (it & 1) * 2 * TILE * LD;
    const float* Vs = Ks + TILE * LD;

    // S = Q K^T: one fmaf chain a score over the head dim from 0 up
    float s[NK][4];
    fma_scores<DP>(s, Qs, Ks, r0, g, t);

    // scale and mask; the tile's row max
    const bool full = k0 + TILE <= Lk && (!causal || k0 + TILE - 1 <= q0 + off);
    float mb[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int qi = q0 + r0 + g + 8 * i;
        const int kj = k0 + 8 * n + 2 * t + (e & 1);
        const bool ok = full || (kj < Lk && (!causal || kj <= qi + off));
        s[n][e] = ok ? s[n][e] * scale : NEG_INF;
        mb[i] = fmaxf(mb[i], s[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mb[i]));
      corr[i] = m[i] > NEG_INF / 2 ? expf(m[i] - m_new) : 0.0f;
      m[i] = m_new;
    }
    // p in place of s; the row sums
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        s[n][e] = s[n][e] > NEG_INF / 2 ? expf(s[n][e] - m[i]) : 0.0f;
        ps[i] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(ps[i]);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // O += P V
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const FragA a = a_from_c(s[kk]);
#pragma unroll
      for (int n = 0; n < ND; ++n)
        mma3_add(acc[n], a, load_b_cols(Vs, LD, 8 * kk, 8 * n, g, t));
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + 8 * i;
    if (qi >= Lq) continue;
    const float safe = l[i] == 0.0f ? 1.0f : l[i];
    const size_t row = row_of(b, qi, Lq, H, h);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * n + 2 * t + c;
        if (d < D) out[row * D + d] = acc[n][2 * i + c] / safe;
      }
    if (t == 0) lse[row] = l[i] == 0.0f ? NEG_INF : m[i] + logf(safe);
  }
}

template <int DP>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* out, float* lse, int B, int H, int Lq, int Lk,
                       int D, int causal, float scale, cudaStream_t stream) {
  static bool done = false;
  cudaError_t err = allow_smem(flash_fwd_kernel<DP>, smem_fwd<DP>(), &done);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lq + TILE - 1) / TILE);
  flash_fwd_kernel<DP><<<grid, THREADS, smem_fwd<DP>(), stream>>>(
      q, k, v, out, lse, H, Lq, Lk, D, scale, causal, vec_ok(D, q, k, v, q));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() right after the launch (the Python wrapper
// raises if it is not 0), or cudaErrorInvalidValue for a shape the kernel
// does not take (a zero length, head_dim above 128, too many tiles).
int flash_fwd(const float* q, const float* k, const float* v, float* out,
              float* lse, int B, int H, int Lq, int Lk, int D, int causal,
              float scale, void* stream) {
  if (!shape_ok(B, H, Lq, Lk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch_fwd<16>(q, k, v, out, lse, B, H, Lq, Lk, D, causal, scale, s);
  if (D <= 32) return launch_fwd<32>(q, k, v, out, lse, B, H, Lq, Lk, D, causal, scale, s);
  if (D <= 64) return launch_fwd<64>(q, k, v, out, lse, B, H, Lq, Lk, D, causal, scale, s);
  return launch_fwd<128>(q, k, v, out, lse, B, H, Lq, Lk, D, causal, scale, s);
}

}  // extern "C"
