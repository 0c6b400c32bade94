// Flash attention backward, K5 (dq) and K6 (dk and dv), for Hopper (sm_90a):
// the scores recomputed as K4 computes them, every other product on the
// tensor cores in 3xTF32.
//
// Replaces the TPU Pallas kernels of distributed_mnist_bnns_tpu/ops/
// flash_attention.py: _flash_bwd_dq_kernel (K5, :307) and
// _flash_bwd_dkv_kernel (K6, :353). The forward, K4, is in flash_attn.cu.
//
// Operands (all contiguous fp32, in the JAX package's (B, L, H, D) layout, so
// no transpose is copied around a call):
//   q, dout          (B, Lq, H, D)    queries, cotangent of out
//   k, v             (B, Lk, H, D)    keys, values
//   lse, coeff       (B, Lq, H)       K4's log-sum-exp; coeff = g_lse - delta,
//                                     delta = rowsum(dout * out) (PyTorch)
//   dq | dk, dv      like q | like k  K5's | K6's outputs
// With s = q k^T * scale, p = exp(s - lse) and ds = p * (dout v^T + coeff) *
// scale: dq = ds k (K5), dv = p^T dout and dk = ds^T q (K6). Query row i
// attends keys j < Lk, and with `causal` only j <= i + Lk - Lq (bottom-right
// aligned; the wrapper refuses causal with Lq > Lk). The scale is d^-0.5 of
// the real head_dim, passed in.
//
// What bounds them on an H100: counting only the unmasked (query, key) pairs
// (32 heads x 1024 x 1025 / 2 = 16.8 M at the LM's training width), K5 does
// 6D and K6 8D operations a pair, 6.4 and 8.6 GFLOP; their bytes (about 40 MB
// each) take about 12 us at 3.35 TB/s, so both are bound by operations. In
// exact fp32 on the CUDA cores (67 TFLOP/s) that is 96 and 128 us. The
// tensor cores multiply TF32 at 495 TFLOP/s; an fp32-accurate product in
// 3xTF32 takes three TF32 products, so 165 TFLOP/s: 39 and 52 us.
//
// The design (the scores, the 3xTF32 products, their summation, the tile
// padding and the head-dim template are flash_common.cuh's, shared with K4):
// - Three products per key tile in K5, S = Q K^T, dP = dO V^T and dQ += dS K;
//   four per query tile in K6, S^T = K Q^T, dP^T = V dO^T, dV += P^T dO and
//   dK += dS^T Q. S is K4's fmaf chains (fma_scores) on the CUDA cores, so
//   p = exp(s - lse) is consistent with K4's lse bit for bit: the binarized
//   LM's scores run to hundreds, and 3xTF32 scores here moved its gradients
//   about 1e-3 (relative) from the exact softmax's on the H100. The other
//   products run in 3xTF32; P and dS are computed in fp32 registers and
//   split like any operand. The split is the kernels' largest cost in
//   instructions: every warp splits each operand it reads.
// - A block of 4 warps owns a 64-row tile, of queries (K5) or of keys (K6),
//   and walks the other axis tile by tile, as the TPU kernels walk their
//   sequential grid axis: K5 key tiles of 64 up to the causal diagonal, the
//   longest query tiles first; K6 query tiles of 32 (its two (16, D)
//   accumulators take the registers a longer tile's scores would need)
//   from the diagonal on. Each warp owns 16 rows of every m16 product.
//   Told to plan for two blocks an SM, ptxas gives a thread up to 255
//   registers. Without the hint it kept to ~170, which bought no third
//   block (K5's shared memory holds two at D <= 64; K6 at 174 registers
//   still ran two), and K5 ran 7% and K6 16% slower.
// - S and dP never leave the registers. The accumulator fragment of
//   m16n8k8 holds columns 2t and 2t + 1 of a lane's two rows, the A fragment
//   columns t and t + 4; the summed index of the next product is relabelled
//   to match (A's column t is key (or query) 2t, t + 4 is 2t + 1), and its B
//   operand is read from shared memory in the same order.
// - The streamed tiles (K and V in K5; Q, dO and their lse and coeff rows in
//   K6) are copied with cp.async into one of two buffers while the other is
//   multiplied: one barrier per tile.
// - The head dim is a template parameter DP (16, 32, 64 or 128; D rounds up
//   to the next of them): its loops unroll with no test of D, which took a
//   fifth off K5.
// - Everything that is not a matrix product stays exact fp32 (precise expf,
//   no fast-math) and follows the JAX kernels (flash_attention.py:295-304):
//   masked scores are NEG_INF = -1e30; p is 0 for padded rows and columns,
//   causally masked pairs and rows whose lse is NEG_INF. Tiles past the
//   diagonal are not visited (K5), nor before it (K6): every pair in them is
//   masked.
// - dq and dk/dv are two kernels, as on the TPU, so that every output element
//   has exactly one writer: no atomics, and two runs are bitwise equal.
// Later work: wgmma (TF32 wants both operands K-major in shared memory, which
// dQ += dS K and dV += P^T dO do not give without a transposed copy) and TMA
// loads with mbarriers in place of cp.async; one fused dq/dk/dv kernel would
// need atomics or a second pass for dq.

#include "flash_common.cuh"

namespace {

constexpr int BQ = 32;        // K6's streamed query tile

template <int DP>
constexpr size_t smem_dq() {  // Q, dO; K, V in two stages
  return sizeof(float) * 6 * TILE * ld_of<DP>();
}
template <int DP>
constexpr size_t smem_dkv() {  // K, V; Q, dO, lse, coeff in two stages
  return sizeof(float) * ((2 * TILE + 4 * BQ) * ld_of<DP>() + 4 * BQ);
}

// s = A B^T (fmaf chains) and dp = C E^T (3xTF32) over the head dim, for A,
// C rows r0..r0+15 of one tile and B, E rows 0..8N-1 of another.
template <int DP, int N>
__device__ __forceinline__ void scores(float (&s)[N][4], float (&dp)[N][4],
                                       const float* A, const float* B,
                                       const float* C, const float* E, int r0,
                                       int g, int t) {
  constexpr int LD = ld_of<DP>();
  fma_scores<DP>(s, A, B, r0, g, t);
  zero(dp);
#pragma unroll
  for (int ks = 0; ks < DP / 8; ++ks) {
    const FragA c = load_a(C, LD, r0, 8 * ks, g, t);
#pragma unroll
    for (int n = 0; n < N; ++n)
      mma3(dp[n], c, load_b_rows(E, LD, 8 * n, 8 * ks, g, t));
  }
}

// K5: grid (B * H, query tiles); causal runs the longest tiles first.
template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ coeff,
                    float* __restrict__ dq, int H, int Lq, int Lk, int D,
                    float scale, int causal, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = ld_of<DP>();
  constexpr int NK = TILE / 8;  // 8-key blocks of a key tile
  constexpr int ND = DP / 8;    // 8-column blocks of the head dim
  float* Qs = smem;
  float* dOs = Qs + TILE * LD;
  float* KV = dOs + TILE * LD;  // stage s: K at KV + 2 s TILE LD, V after it
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * warp;
  const int off = Lk - Lq;

  load_tile<DP>(Qs, q, b, h, q0, TILE, Lq, H, D, vec);
  load_tile<DP>(dOs, dout, b, h, q0, TILE, Lq, H, D, vec);
  const int k_end = causal ? min(Lk, q0 + TILE + off) : Lk;
  const int n_tiles = (k_end + TILE - 1) / TILE;
  if (n_tiles > 0) {
    load_tile<DP>(KV, k, b, h, 0, TILE, Lk, H, D, vec);
    load_tile<DP>(KV + TILE * LD, v, b, h, 0, TILE, Lk, H, D, vec);
  }
  cp_async_commit();
  // a lane's rows: r0 + g (i = 0) and r0 + g + 8 (i = 1)
  float lse_r[2], coeff_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + 8 * i;
    const size_t row = row_of(b, qi, Lq, H, h);
    lse_r[i] = qi < Lq ? lse[row] : NEG_INF;
    coeff_r[i] = qi < Lq ? coeff[row] : 0.0f;
  }
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

    float s[NK][4], dp[NK][4];
    scores<DP>(s, dp, Qs, Ks, dOs, Vs, r0, g, t);

    // ds in place of s
    const bool full = k0 + TILE <= Lk && (!causal || k0 + TILE - 1 <= q0 + off);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int qi = q0 + r0 + g + 8 * i;
        const int kj = k0 + 8 * n + 2 * t + (e & 1);
        const bool invalid = lse_r[i] < NEG_INF / 2 ||
                             (!full && (kj >= Lk || (causal && kj > qi + off)));
        const float p = invalid ? 0.0f : expf(s[n][e] * scale - lse_r[i]);
        s[n][e] = p * (dp[n][e] + coeff_r[i]) * scale;
      }

    // dq += ds K
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const FragA a = a_from_c(s[kk]);
#pragma unroll
      for (int n = 0; n < ND; ++n)
        mma3_add(acc[n], a, load_b_cols(Ks, LD, 8 * kk, 8 * n, g, t));
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int qi = q0 + r0 + g + 8 * (e >> 1);
    if (qi >= Lq) continue;
    const size_t row = row_of(b, qi, Lq, H, h);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = 8 * n + 2 * t + (e & 1);
      if (d < D) dq[row * D + d] = acc[n][e];
    }
  }
}

// K6: grid (B * H, key tiles); dv = sum_i p^T do_i and dk = sum_i ds^T q_i
// over query tiles from the diagonal on. A warp's rows are keys, its score
// columns queries.
template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ coeff,
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int Lq, int Lk, int D, float scale, int causal, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = ld_of<DP>();
  constexpr int NQ = BQ / 8;  // 8-query blocks of a query tile
  constexpr int ND = DP / 8;
  float* Ks = smem;
  float* Vs = Ks + TILE * LD;
  float* QD = Vs + TILE * LD;    // stage s: Q at QD + 2 s BQ LD, dO after it
  float* LC = QD + 4 * BQ * LD;  // stage s: lse at LC + 2 s BQ, coeff after it
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int c0 = blockIdx.y * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * warp;
  const int off = Lk - Lq;

  // Query tile it's Q, dO, lse and coeff rows into stage it & 1.
  auto stage = [&](int it, int qb) {
    float* qd = QD + (it & 1) * 2 * BQ * LD;
    load_tile<DP>(qd, q, b, h, qb, BQ, Lq, H, D, vec);
    load_tile<DP>(qd + BQ * LD, dout, b, h, qb, BQ, Lq, H, D, vec);
    if (threadIdx.x < 2 * BQ) {
      const int qr = qb + threadIdx.x % BQ;
      const float* src = threadIdx.x < BQ ? lse : coeff;
      const bool ok = qr < Lq;
      cp_async4(LC + (it & 1) * 2 * BQ + threadIdx.x,
                ok ? src + row_of(b, qr, Lq, H, h) : src, ok ? 4 : 0);
    }
  };

  load_tile<DP>(Ks, k, b, h, c0, TILE, Lk, H, D, vec);
  load_tile<DP>(Vs, v, b, h, c0, TILE, Lk, H, D, vec);
  // first query row that sees key c0 is c0 - off
  const int q_begin = causal ? max(0, c0 - off) / BQ * BQ : 0;
  const int n_tiles = (Lq - q_begin + BQ - 1) / BQ;
  if (n_tiles > 0) stage(0, q_begin);
  cp_async_commit();
  float dk_acc[ND][4], dv_acc[ND][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int it = 0; it < n_tiles; ++it) {
    const int qb = q_begin + it * BQ;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_tiles) {
      stage(it + 1, qb + BQ);
      cp_async_commit();
    }
    const float* Qs = QD + (it & 1) * 2 * BQ * LD;
    const float* dOs = Qs + BQ * LD;
    const float* lse_s = LC + (it & 1) * 2 * BQ;
    const float* coeff_s = lse_s + BQ;

    float s[NQ][4], dp[NQ][4];  // s^T and dp^T: rows keys, columns queries
    scores<DP>(s, dp, Ks, Qs, Vs, dOs, r0, g, t);

    // p in place of s, ds in place of dp
    const bool full = qb + BQ <= Lq && c0 + TILE <= Lk &&
                      (!causal || c0 + TILE - 1 <= qb + off);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = c0 + r0 + g + 8 * (e >> 1);
        const int r = 8 * n + 2 * t + (e & 1);
        const int qr = qb + r;
        const float lse_q = lse_s[r];
        const bool invalid =
            lse_q < NEG_INF / 2 ||
            (!full && (kc >= Lk || qr >= Lq || (causal && kc > qr + off)));
        const float p = invalid ? 0.0f : expf(s[n][e] * scale - lse_q);
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] + coeff_s[r]) * scale;
      }

    // dv += p^T dO, dk += ds^T Q
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      const FragA pa = a_from_c(s[kk]);
      const FragA da = a_from_c(dp[kk]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        mma3_add(dv_acc[n], pa, load_b_cols(dOs, LD, 8 * kk, 8 * n, g, t));
        mma3_add(dk_acc[n], da, load_b_cols(Qs, LD, 8 * kk, 8 * n, g, t));
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int kc = c0 + r0 + g + 8 * (e >> 1);
    if (kc >= Lk) continue;
    const size_t row = row_of(b, kc, Lk, H, h);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = 8 * n + 2 * t + (e & 1);
      if (d < D) {
        dk[row * D + d] = dk_acc[n][e];
        dv[row * D + d] = dv_acc[n][e];
      }
    }
  }
}

template <int DP>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* coeff,
                      float* dq, int B, int H, int Lq, int Lk, int D,
                      int causal, float scale, cudaStream_t stream) {
  static bool done = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<DP>, smem_dq<DP>(), &done);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lq + TILE - 1) / TILE);
  flash_bwd_dq_kernel<DP><<<grid, THREADS, smem_dq<DP>(), stream>>>(
      q, k, v, dout, lse, coeff, dq, H, Lq, Lk, D, scale, causal,
      vec_ok(D, q, k, v, dout));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* coeff,
                       float* dk, float* dv, int B, int H, int Lq, int Lk,
                       int D, int causal, float scale, cudaStream_t stream) {
  static bool done = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<DP>, smem_dkv<DP>(), &done);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lk + TILE - 1) / TILE);
  flash_bwd_dkv_kernel<DP><<<grid, THREADS, smem_dkv<DP>(), stream>>>(
      q, k, v, dout, lse, coeff, dk, dv, H, Lq, Lk, D, scale, causal,
      vec_ok(D, q, k, v, dout));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() right after its launch (the Python wrapper
// raises if it is not 0), or cudaErrorInvalidValue for a shape the kernels do
// not take (a zero length, head_dim above 128, too many tiles).
int flash_bwd_dq(const float* q, const float* k, const float* v,
                 const float* dout, const float* lse, const float* coeff,
                 float* dq, int B, int H, int Lq, int Lk, int D, int causal,
                 float scale, void* stream) {
  if (!shape_ok(B, H, Lq, Lk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch_dq<16>(q, k, v, dout, lse, coeff, dq, B, H, Lq, Lk, D, causal, scale, s);
  if (D <= 32) return launch_dq<32>(q, k, v, dout, lse, coeff, dq, B, H, Lq, Lk, D, causal, scale, s);
  if (D <= 64) return launch_dq<64>(q, k, v, dout, lse, coeff, dq, B, H, Lq, Lk, D, causal, scale, s);
  return launch_dq<128>(q, k, v, dout, lse, coeff, dq, B, H, Lq, Lk, D, causal, scale, s);
}

int flash_bwd_dkv(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* coeff,
                  float* dk, float* dv, int B, int H, int Lq, int Lk, int D,
                  int causal, float scale, void* stream) {
  if (!shape_ok(B, H, Lq, Lk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch_dkv<16>(q, k, v, dout, lse, coeff, dk, dv, B, H, Lq, Lk, D, causal, scale, s);
  if (D <= 32) return launch_dkv<32>(q, k, v, dout, lse, coeff, dk, dv, B, H, Lq, Lk, D, causal, scale, s);
  if (D <= 64) return launch_dkv<64>(q, k, v, dout, lse, coeff, dk, dv, B, H, Lq, Lk, D, causal, scale, s);
  return launch_dkv<128>(q, k, v, dout, lse, coeff, dk, dv, B, H, Lq, Lk, D, causal, scale, s);
}

}  // extern "C"
