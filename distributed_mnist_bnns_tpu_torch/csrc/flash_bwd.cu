// Flash attention backward, K5 (dq) and K6 (dk and dv), for Hopper (sm_90a),
// on the tensor cores in 3xTF32.
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
// The design:
// - Every product runs on the tensor cores as mma.sync m16n8k8 with TF32
//   operands and fp32 accumulation, three of them for each 16 x 8 x 8 step:
//   each operand x is split into big = tf32(x) and small = tf32(x - big),
//   both rounded to nearest with ties away from zero as cvt.rna.tf32.f32
//   rounds, and the step adds small*big, big*small and big*big. A TF32
//   product is exact in fp32; what the split drops (small*small and the
//   rounding of small) is about 2^-21 of the product, fp32's accuracy class,
//   as the JAX kernels compute at Precision.HIGHEST (on the TPU a multi-pass
//   bf16 split). K5 has three products per key tile, S = Q K^T, dP = dO V^T
//   and dQ += dS K; K6 four per query tile, S^T = K Q^T, dP^T = V dO^T,
//   dV += P^T dO and dK += dS^T Q. P and dS are computed in fp32 registers
//   and split like any operand.
// - The split is the kernels' largest cost in instructions: every warp
//   splits each operand it reads. It rounds by an integer add and mask
//   (20% faster than cvt.rna at the training width, the same bits), and
//   small is left unmasked: mma reads only the top 19 bits of a TF32
//   operand (the outputs are bitwise those of masking it).
// - The tensor cores truncate where they add; summed over a thousand keys
//   into one accumulator, that drifts towards zero (7.8e-5 in dv at the
//   training width). So each 8-deep step of dQ, dK and dV is summed from
//   zero and added to its output's sum in fp32, rounded to nearest (1e-5).
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
//   multiplied: one barrier per tile. Tile rows are padded to DP + 4
//   floats, so both fragment patterns (8 rows x 4 columns, and 4 row pairs x
//   8 columns) hit 32 different banks.
// - The head dim is a template parameter DP (16, 32, 64 or 128; D rounds up
//   to the next of them): its loops unroll with no test of D, which took a
//   fifth off K5. Columns past D and rows past L are zero-filled in shared
//   memory; nothing is padded in device memory.
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;      // rows of a tile, of queries or of keys
constexpr int THREADS = 128;  // 4 warps, 16 rows each
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

// Row stride, in floats, of a tile with DP columns.
template <int DP>
__host__ __device__ constexpr int ld_of() { return DP + 4; }
constexpr int BQ = 32;        // K6's streamed query tile

template <int DP>
constexpr size_t smem_dq() {  // Q, dO; K, V in two stages
  return sizeof(float) * 6 * TILE * ld_of<DP>();
}
template <int DP>
constexpr size_t smem_dkv() {  // K, V; Q, dO, lse, coeff in two stages
  return sizeof(float) * ((2 * TILE + 4 * BQ) * ld_of<DP>() + 4 * BQ);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ size_t row_of(int b, int l, int L, int H, int h) {
  return (static_cast<size_t>(b) * L + l) * H + h;
}

// Rows [row0, row0 + rows) of head h of batch b of a (B, L, H, D) tensor into
// dst[r * LD + d] for d < DP, zero past L and past D. `vec`: D % 4 == 0 and
// the tensor 16-byte aligned, so rows go in 16-byte copies.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int b,
                                          int h, int row0, int rows, int L,
                                          int H, int D, bool vec) {
  constexpr int LD = ld_of<DP>();
  if (vec) {
    for (int idx = threadIdx.x; idx < rows * (DP / 4); idx += THREADS) {
      const int r = idx / (DP / 4), c = 4 * (idx % (DP / 4)), l = row0 + r;
      const bool ok = l < L && c < D;
      cp_async16(dst + r * LD + c, ok ? src + row_of(b, l, L, H, h) * D + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DP; idx += THREADS) {
      const int r = idx / DP, c = idx % DP, l = row0 + r;
      const bool ok = l < L && c < D;
      cp_async4(dst + r * LD + c, ok ? src + row_of(b, l, L, H, h) * D + c : src,
                ok ? 4 : 0);
    }
  }
}

// big = tf32(x), small = tf32(x - big), rounded to nearest, ties away from
// zero; small's low 13 bits are left for mma to drop.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

struct FragA {  // a 16 x 8 A operand, split
  uint32_t big[4], small[4];
};
struct FragB {  // an 8 x 8 B operand, split
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// c += a b, the step summed from zero and added in fp32 (the output sums).
__device__ __forceinline__ void mma3_add(float (&c)[4], const FragA& a, const FragB& b) {
  float step[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma3(step, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += step[e];
}

// Fragment layouts of m16n8k8 (lane = 4 g + t): A (row, col) = (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k, n) = (t, g), (t + 4, g);
// C (row, col) = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

// A = rows r0.. and columns k0.. of a row-major tile.
__device__ __forceinline__ FragA load_a(const float* s, int ld, int r0, int k0,
                                        int g, int t) {
  FragA a;
  const float* p = s + (r0 + g) * ld + k0 + t;
  split(p[0], a.big[0], a.small[0]);
  split(p[8 * ld], a.big[1], a.small[1]);
  split(p[4], a.big[2], a.small[2]);
  split(p[8 * ld + 4], a.big[3], a.small[3]);
  return a;
}

// B (k, n) = tile (n0 + n, k0 + k): the tile's rows are B's columns.
__device__ __forceinline__ FragB load_b_rows(const float* s, int ld, int n0,
                                             int k0, int g, int t) {
  FragB b;
  const float* p = s + (n0 + g) * ld + k0 + t;
  split(p[0], b.big[0], b.small[0]);
  split(p[4], b.big[1], b.small[1]);
  return b;
}

// B (k, n) = tile (k0 + perm(k), n0 + n), perm(t) = 2t, perm(t + 4) = 2t + 1:
// the order in which a_from_c relabels the summed index.
__device__ __forceinline__ FragB load_b_cols(const float* s, int ld, int k0,
                                             int n0, int g, int t) {
  FragB b;
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
  split(p[0], b.big[0], b.small[0]);
  split(p[ld], b.big[1], b.small[1]);
  return b;
}

// The A operand of an accumulator fragment's 16 x 8 block, its columns
// relabelled by perm (see load_b_cols).
__device__ __forceinline__ FragA a_from_c(const float (&c)[4]) {
  FragA a;
  split(c[0], a.big[0], a.small[0]);  // (g, 2t)      -> (g, t)
  split(c[2], a.big[1], a.small[1]);  // (g + 8, 2t)  -> (g + 8, t)
  split(c[1], a.big[2], a.small[2]);  // (g, 2t + 1)  -> (g, t + 4)
  split(c[3], a.big[3], a.small[3]);  // (g + 8, 2t + 1) -> (g + 8, t + 4)
  return a;
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.0f;
}

// s = A B^T and dp = C E^T over the head dim, for A, C rows r0..r0+15 of one
// tile and B, E rows 0..8N-1 of another.
template <int DP, int N>
__device__ __forceinline__ void scores(float (&s)[N][4], float (&dp)[N][4],
                                       const float* A, const float* B,
                                       const float* C, const float* E, int r0,
                                       int g, int t) {
  constexpr int LD = ld_of<DP>();
  zero(s);
  zero(dp);
#pragma unroll
  for (int ks = 0; ks < DP / 8; ++ks) {
    const FragA a = load_a(A, LD, r0, 8 * ks, g, t);
    const FragA c = load_a(C, LD, r0, 8 * ks, g, t);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      mma3(s[n], a, load_b_rows(B, LD, 8 * n, 8 * ks, g, t));
      mma3(dp[n], c, load_b_rows(E, LD, 8 * n, 8 * ks, g, t));
    }
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

// Allow each instantiation its dynamic shared memory, once per process
// (before any CUDA-graph capture: the wrappers' first launch).
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

// 16-byte copies need D % 4 == 0 and every row 16-byte aligned.
int vec_ok(int D, const float* q, const float* k, const float* v, const float* dout) {
  const auto aligned = [](const float* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return D % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(dout);
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
