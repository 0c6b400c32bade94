// What the flash-attention kernels share: K4 (flash_attn.cu) and K5, K6
// (flash_bwd.cu) compute the scores S = Q K^T as exact fp32 fmaf chains on
// the CUDA cores (fma_scores, the same bits in all three), and run every
// other matrix product on the tensor cores in 3xTF32 with the helpers below.
//
// Operands are contiguous fp32 in the JAX package's (B, L, H, D) layout.
// A block of THREADS = 4 warps owns a tile of TILE = 64 rows; each warp owns
// 16 rows of every m16 product.
//
// 3xTF32: every product runs as mma.sync m16n8k8 with TF32 operands and fp32
// accumulation, three of them for each 16 x 8 x 8 step: each operand x is
// split into big = tf32(x) and small = tf32(x - big), both rounded to nearest
// with ties away from zero as cvt.rna.tf32.f32 rounds, and the step adds
// small*big, big*small and big*big. A TF32 product is exact in fp32; what the
// split drops (small*small and the rounding of small) is about 2^-21 of the
// product, fp32's accuracy class, as the JAX kernels compute at
// Precision.HIGHEST. The split rounds by an integer add and mask (faster
// than cvt.rna, the same bits), and small is left unmasked: mma reads only
// the top 19 bits of a TF32 operand.
//
// The tensor cores truncate where they add; summed over a thousand keys into
// one accumulator that drifts towards zero. So a sum over keys or queries
// (O, dQ, dK, dV) adds each 8-deep step, summed from zero, to its output's
// sum in fp32, rounded to nearest (mma3_add). dP, summed over the head dim
// only, uses one accumulator (mma3).
//
// Tile rows are padded to DP + 4 floats, so both fragment patterns (8 rows x
// 4 columns, and 4 row pairs x 8 columns) hit 32 different banks. DP is the
// head dim rounded up to 16, 32, 64 or 128, a template parameter; columns
// past D and rows past L are zero-filled in shared memory, nothing is padded
// in device memory.

#pragma once

#include "common.cuh"

namespace {

constexpr int TILE = 64;      // rows of a tile, of queries or of keys
constexpr int THREADS = 128;  // 4 warps, 16 rows each
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

// Row stride, in floats, of a tile with DP columns.
template <int DP>
__host__ __device__ constexpr int ld_of() { return DP + 4; }

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
// relabelled by perm (see load_b_cols): the accumulator of one product
// becomes the left operand of the next without leaving the registers.
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

// s = A B^T over the head dim, unscaled, in the accumulator fragment's
// layout: rows r0 + g and r0 + g + 8 of tile A, columns 8n + 2t and
// 8n + 2t + 1 of tile B's rows. Each score is one fmaf chain from d = 0 up,
// so K4, K5 and K6 compute every score bit for bit alike (fmaf(a, b, c) is
// symmetric in a and b: K6's s^T = K Q^T is K4's s). 16-byte shared-memory
// loads, 8N fmaf a lane for 2 + N loads.
template <int DP, int N>
__device__ __forceinline__ void fma_scores(float (&s)[N][4], const float* A,
                                           const float* B, int r0, int g,
                                           int t) {
  constexpr int LD = ld_of<DP>();
  zero(s);
  const float* a = A + (r0 + g) * LD;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a + d);
    const float4 x1 = *reinterpret_cast<const float4*>(a + 8 * LD + d);
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 y =
            *reinterpret_cast<const float4*>(B + (8 * n + 2 * t + c) * LD + d);
        s[n][c] = fmaf(x0.x, y.x, s[n][c]);
        s[n][c] = fmaf(x0.y, y.y, s[n][c]);
        s[n][c] = fmaf(x0.z, y.z, s[n][c]);
        s[n][c] = fmaf(x0.w, y.w, s[n][c]);
        s[n][2 + c] = fmaf(x1.x, y.x, s[n][2 + c]);
        s[n][2 + c] = fmaf(x1.y, y.y, s[n][2 + c]);
        s[n][2 + c] = fmaf(x1.z, y.z, s[n][2 + c]);
        s[n][2 + c] = fmaf(x1.w, y.w, s[n][2 + c]);
      }
  }
}

bool shape_ok(int B, int H, int Lq, int Lk, int D) {
  return B >= 1 && H >= 1 && Lq >= 1 && Lk >= 1 && D >= 1 && D <= MAX_D &&
         static_cast<long long>(B) * H <= 0x7fffffffLL &&
         (Lq + TILE - 1) / TILE <= 65535 && (Lk + TILE - 1) / TILE <= 65535;
}

// 16-byte copies of (B, L, H, D) rows: D % 4 == 0 and every operand aligned.
int vec_ok(int D, const float* a, const float* b, const float* c, const float* d) {
  return D % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(c) && aligned16(d);
}

}  // namespace
