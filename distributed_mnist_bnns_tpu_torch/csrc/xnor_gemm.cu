// Packed ±1 GEMM (XNOR-popcount) with three epilogues, for Hopper (sm_90a).
// The kernel takes the activations as they are (fp32) and packs their signs
// on chip; the weights come pre-packed.
//
// Replaces the TPU Pallas kernels of distributed_mnist_bnns_tpu/ops/xnor_gemm.py:
//   EPI_NONE   <- _xnor_kernel (:81)         o = K - 2 * mismatches
//   EPI_SIGN   <- _xnor_sign_kernel (:124)   where(a * (o + bias) >= t, +1, -1)
//   EPI_AFFINE <- _xnor_affine_kernel (:149) clip(a * (o + bias) + c, -1, 1)
// with mismatches = sum_w popcount(x_w ^ w_w) over the packed words. The JAX
// package packs x outside the Pallas kernel (pack_bits_mxu) and XLA fuses the
// pack into the jitted program; an eager program would pay several launches
// for it, so here the pack is part of the kernel.
//
// Operands. x is (M, K) fp32, row-major. Bit k of row m is x >= 2^-126
// (rule GT0: x > 0 with a subnormal read as 0; pack_bits(x) bit for bit,
// the public entries' ±1 contract) or x > -2^-126 (rule GE0: x >= 0 with a
// subnormal read as 0; pack_bits(binarize_ste(x)) bit for bit: -0.0 gives 1,
// NaN 0). XLA reads subnormals as zero on the CPU, so these are the JAX
// package's bits for every fp32 x. w is K-major (KW_p >= KW rows,
// ldw >= N columns) int32, the layout of prepack_weights, read as it is;
// only its first KW = ceil(K/32) rows are read. Output (M, N) fp32,
// row-major.
//
// What bounds it on an H100 (3.35 TB/s; 1,979 TOP/s int8 as the ±1 rate),
// counting fp32 x (4*M*K bytes), the real weight words, the epilogue vectors
// and the output once:
//   K1 (4, 256, 512), the LM's decode projections: 28 KB, 8.4 ns; 1 M ops.
//   K2 (32, 3072, 1536), the MLP's layer 2: 1.2 MB, 0.36 us.
//   K3 (32, 1536, 768), the MLP's layer 3: 0.45 MB, 0.14 us.
// All three are far below a launch (~1.3 us), so what bounds them is latency:
// the launch, then the memory round trips in series, then the barriers. The
// design gives each shape one round trip and as few barriers as it can.
//
// Design.
//   - A block of 512 threads owns 16 rows (one m16 tile, warp w packs row w)
//     and bn columns (bn in {32, 64, 128}: warp w takes n8 tile w) over all
//     of K, in chunks of up to 16 k256 steps (one chunk for K <= 4096). The
//     kernel is instantiated for 1, 2, 4, 8 and 16 staged steps, so the
//     unrolled loads and packs match the shape (instructions that a small
//     shape only predicates off still cost it time on this card).
//   - One memory round trip: each warp loads its row's words of x, one load
//     of 32 consecutive values (128 B, coalesced) per word, up to 16 before
//     it packs any, then the B fragments of its n8 tile for the chunk's
//     steps straight into registers (w[t * ldw + n] holds 32 consecutive k
//     bits of column n), while the block copies the epilogue vectors into
//     shared memory (cp.async). x goes first, since the pack and the
//     exchange wait for it (0.2-0.4 us off K2 and K3 against the weights
//     first, scripts/torch_xnor_variants.py). __ballot_sync of the rule's
//     predicate is the word (lane i gives bit i, LSB-first as pack_bits;
//     lanes past K give 0, pack_bits' zero tail).
//   - Sharing x: the fp32 rows are 32 times the bytes of their bits, and a
//     layer of many column tiles would read them once per tile. So up to 8
//     consecutive column tiles form a thread-block cluster; each block loads
//     and packs 1/share of the chunk's words and stores each word into every
//     block of the cluster with st.async, which completes its bytes on the
//     receiving block's mbarrier. A block waits on its own mbarrier for all
//     16 rows' words (0.3 us off K2 against a cluster barrier there); one
//     cluster barrier at the start makes sure every block runs before any
//     store reaches it. Without sharing (share = 1: K1's small x) it is one
//     __syncthreads. Clusters of 8 at most: a cluster runs on one GPC, and
//     larger ones left K2's blocks two waves.
//   - The products run on the b1 tensor cores, mma.sync m16n8k256, the A
//     fragment four packed x words from shared memory, the B fragment two
//     weight words. The operation is .and.popc with the exact identity
//       popc(x ^ w) = popc(x) + popc(w) - 2 * popc(x & w).
//     nvcc 12.8 also accepts .xor.popc for sm_90a, but CUTLASS
//     (arch/mma_sm80.h) enables its b1 XOR mma only up to sm_89 and its AND
//     mma up to sm_90: AND is the form NVIDIA's own library runs on Hopper.
//     The two popcounts cost the CUDA cores little: each warp takes its rows'
//     popcounts from the A fragments and its column's from the B fragments,
//     summed over the four lanes that hold a row (a column) with two
//     shuffles. Zero words pad both operands to the k256 step, so the
//     identity stays exact. The counts are int32 and every output is summed
//     by one lane in one order: two runs give the same bits.
//   - The epilogue runs on the mma's C fragment and writes the outputs.
//
// Rounding in the epilogues is spelled out with intrinsics, so nvcc has no
// choice to make. The sign epilogue rounds after each operation
// (__fadd_rn, __fmul_rn). The affine epilogue rounds the bias add, then does
// a*y + c as one fused multiply-add (__fmaf_rn): XLA contracts that pair into
// an FMA where the JAX package runs it, so one rounding is what the reference
// computes. The plain PyTorch version rounds the same way (it emulates the
// FMA exactly), and the two agree bitwise. o = (float)K - (float)(2 * mism)
// is exact because |o| <= K <= 2^24.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;            // threads a block
constexpr int NW = NT / 32;        // warps a block
constexpr int BM = 16;             // rows a block: one m16 tile, 1 per warp
constexpr int STEP_W = 8;          // 32-bit words of one k256 step
constexpr int MAX_CH = 16;         // k256 steps staged at once, at most
constexpr int MAX_BN = NW * 8;     // columns a block: one n8 tile per warp
constexpr int MAX_SHARE = 8;       // blocks of a cluster (the portable limit)
constexpr int PQ = 16;             // words a warp loads before it packs any
constexpr unsigned FULL = 0xffffffffu;

enum Epilogue { EPI_NONE = 0, EPI_SIGN = 1, EPI_AFFINE = 2 };
enum Rule { RULE_GT0 = 0, RULE_GE0 = 1 };

// x row stride in words for CH staged steps: 4 mod 8, so the A-fragment
// reads (rows g = 0..7, words t = 0..3) hit 32 distinct banks.
__host__ __device__ constexpr int xld(int ch) { return ch * STEP_W + 4; }

// Shared memory in 32-bit words: the epilogue vectors [3][bn] and the packed
// x [BM][xld].
__host__ __device__ constexpr int smem_words(int ch, int bn) {
  return 3 * bn + BM * xld(ch) + 2;
}

// d += popc(a & b) over k256 for the m16n8 tile: a row-major, b col-major.
__device__ __forceinline__ void mma_and_popc(int (&d)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The epilogue of column c of the tile; vec holds the tile's (a, t or c,
// bias) as [3][bn].
template <int EPI>
__device__ __forceinline__ float epilogue(int mism, int k_bits, int c, int bn,
                                          const float* vec) {
  const float o = __fsub_rn(__int2float_rn(k_bits), __int2float_rn(2 * mism));
  if (EPI == EPI_NONE) return o;
  const float a = vec[c], b = vec[bn + c], bias = vec[2 * bn + c];
  if (EPI == EPI_SIGN) {
    return (__fmul_rn(a, __fadd_rn(o, bias)) >= b) ? 1.0f : -1.0f;
  }
  const float y = __fmaf_rn(a, __fadd_rn(o, bias), b);
  // NaN passes through, as torch.clamp and jnp.clip let it.
  return (y < -1.0f) ? -1.0f : ((y > 1.0f) ? 1.0f : y);
}

template <int EPI, int CH>
__global__ void __launch_bounds__(NT)
xnor_gemm_kernel(const float* __restrict__ x, const int32_t* __restrict__ w,
                 const float* __restrict__ va, const float* __restrict__ vb,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int m_rows, int n_cols, int k_bits, int ldw, int bn, int rule) {
  constexpr int CHW = CH * STEP_W;   // words staged at once
  constexpr int XLD = xld(CH);
  constexpr int PQC = PQ < CHW ? PQ : CHW;
  extern __shared__ __align__(16) uint32_t smem[];
  float* vec = reinterpret_cast<float*>(smem);          // [3][bn]
  uint32_t* xs = smem + 3 * bn;                         // [BM][XLD]

  // The blocks of a cluster are consecutive column tiles of the same rows:
  // each packs 1/share of every chunk of x and stores it into all of them.
  cg::cluster_group cluster = cg::this_cluster();
  const int share = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lbn = 31 - __clz(bn);                       // bn is a power of 2
  const int n0 = blockIdx.x * bn;
  const int m0 = blockIdx.y * BM;
  const int rows = min(BM, m_rows - m0);
  const int kw = (k_bits + 31) >> 5;
  const int chunks = max(1, (kw + CHW - 1) / CHW);
  const int g = lane >> 2;   // fragment row (A, C) / column (B)
  const int t = lane & 3;    // fragment word (A, B) / column pair (C)
  const int nt = warp;                                  // this warp's n8 tile
  const bool has_tile = n0 < n_cols && nt < (bn >> 3);  // the same for the warp
  // Subnormals read as zero, as XLA reads them (pack_bits).
  const float tiny = __int_as_float(0x00800000);        // 2^-126

  // The packed x arrives through st.async, each store completing its bytes
  // on the receiving block's mbarrier. A block may store into another's
  // shared memory only once that block runs and its mbarrier is set up:
  // arrive now, wait before the first remote store.
  const uint32_t xs_s = static_cast<uint32_t>(__cvta_generic_to_shared(xs));
  const uint32_t mbar_s = xs_s + 4 * BM * XLD;
  if (share > 1) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar_s) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }

  // The epilogue vectors of the tile, copied while the rest loads.
  if (EPI != EPI_NONE) {
    for (int i = tid; i < 3 * bn; i += NT) {
      const int v = i >> lbn;
      const int n = n0 + (i & (bn - 1));
      const float* src = v == 0 ? va : (v == 1 ? vb : bias);
      cp_async4(vec + i, n < n_cols ? src + n : src, n < n_cols ? 4 : 0);
    }
    cp_async_commit();
  }
  // Lane l < share stores the words this warp packs into block l's x.
  uint32_t* dst = xs + warp * XLD;
  uint32_t rdst = 0, rbar = 0;
  if (share > 1 && lane < share) {
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rdst) : "r"(xs_s + 4 * warp * XLD), "r"(lane));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(mbar_s), "r"(lane));
  }

  int acc[4] = {0, 0, 0, 0};
  int px0 = 0, px1 = 0, pw = 0;   // popcounts of rows g, g + 8 and column g
  for (int ci = 0; ci < chunks; ++ci) {
    const int c0 = ci * CHW;
    const int cw = max(0, min(CHW, kw - c0));             // real words
    const int cwp = (cw + STEP_W - 1) / STEP_W * STEP_W;  // whole k256 steps

    // 1. The loads: warp w loads its block's share of the chunk's words of
    //    row w of x, up to PQ words before it packs any (a value outside
    //    the rows or K is NaN, which neither rule counts as a 1), then the
    //    B fragments of its n8 tile for the chunk's steps, straight into
    //    registers (a word past K or a column past ldw is 0). x goes first:
    //    the pack and the exchange wait for it, the products for both.
    const int per = (cwp + share - 1) / share;
    const int j0 = rank * per;
    const int j1 = min(cwp, j0 + per);
    const bool live = warp < rows;
    const float* xr = x + static_cast<size_t>(m0 + (live ? warp : 0)) * k_bits
                      + static_cast<size_t>(c0) * 32 + lane;
    const int left = k_bits - c0 * 32 - lane;   // this lane's values left
    float v[PQC];
    auto load_x = [&](int jb) {
#pragma unroll
      for (int i = 0; i < PQC; ++i) {
        const int j = jb + i;
        v[i] = __int_as_float(0x7fffffff);
        if (live && j < j1 && j < cw && 32 * j < left) v[i] = xr[32 * j];
      }
    };
    load_x(j0);
    uint32_t b[CH][2];
    {
      const int col = n0 + nt * 8 + g;
      const bool on = has_tile && col < ldw;
      const int32_t* wc = w + static_cast<size_t>(c0 + t) * ldw + (on ? col : 0);
#pragma unroll
      for (int s = 0; s < CH; ++s) {
        const int r = s * STEP_W + t;
        b[s][0] = on && r < cw ? static_cast<uint32_t>(wc[static_cast<size_t>(r - t) * ldw]) : 0u;
        b[s][1] = on && r + 4 < cw ? static_cast<uint32_t>(wc[static_cast<size_t>(r - t + 4) * ldw]) : 0u;
      }
    }

    // 2. The pack: one ballot per word, stored into every block of the
    //    cluster (st.async, completing on the receiver's mbarrier) once the
    //    cluster's blocks run and have read the last chunk.
    if (ci > 0 && share > 1) cluster.sync();
    if (ci == 0 && share > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (share > 1 && tid == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(mbar_s), "r"(4 * BM * cwp) : "memory");
    }
    for (int jb = j0; jb < j1; jb += PQC) {
      if (jb > j0) load_x(jb);
      if (share == 1) {
#pragma unroll
        for (int i = 0; i < PQC; ++i) {
          if (jb + i < j1) {  // the same for every lane of the warp
            const bool bit = rule == RULE_GE0 ? (v[i] > -tiny) : (v[i] >= tiny);
            const uint32_t word = __ballot_sync(FULL, bit);
            if (lane == 0) dst[jb + i] = word;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < PQC; ++i) {
          if (jb + i < j1) {
            const bool bit = rule == RULE_GE0 ? (v[i] > -tiny) : (v[i] >= tiny);
            const uint32_t word = __ballot_sync(FULL, bit);
            if (lane < share) {
              asm volatile(
                  "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
                  ::"r"(rdst + 4 * (jb + i)), "r"(word), "r"(rbar) : "memory");
            }
          }
        }
      }
    }
    cp_async_wait_all();
    if (share > 1) {   // every share of the chunk has landed
      uint32_t done = 0;
      while (!done) {
        asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(mbar_s), "r"(ci & 1) : "memory");
      }
    }
    __syncthreads();

    // 3. The products: this warp's n8 tile over the chunk's steps, and the
    //    popcounts of its rows (A fragments) and column (B fragments).
    if (has_tile) {
      const int steps = cwp / STEP_W;
#pragma unroll
      for (int s = 0; s < CH; ++s) {
        if (s < steps) {
          const uint32_t* xa = xs + s * STEP_W + t;
          const uint32_t a0 = xa[g * XLD], a1 = xa[(g + 8) * XLD];
          const uint32_t a2 = xa[g * XLD + 4], a3 = xa[(g + 8) * XLD + 4];
          mma_and_popc(acc, a0, a1, a2, a3, b[s][0], b[s][1]);
          px0 += __popc(a0) + __popc(a2);
          px1 += __popc(a1) + __popc(a3);
          pw += __popc(b[s][0]) + __popc(b[s][1]);
        }
      }
    }
    if (chunks > 1 && share == 1) __syncthreads();  // before the next chunk lands
  }
  // No remote store follows the last chunk's cluster barrier, so a block may
  // leave as soon as its own outputs are written.
  if (!has_tile) return;

  // 4. The epilogue on the C fragment: rows g and g + 8, columns 2t and
  //    2t + 1. Row popcounts are summed over the four lanes that hold a
  //    row, column popcounts over the four that hold a column, whose lanes
  //    (groups 2t and 2t + 1) then hand them over.
  px0 += __shfl_xor_sync(FULL, px0, 1);
  px0 += __shfl_xor_sync(FULL, px0, 2);
  px1 += __shfl_xor_sync(FULL, px1, 1);
  px1 += __shfl_xor_sync(FULL, px1, 2);
  pw += __shfl_xor_sync(FULL, pw, 1);
  pw += __shfl_xor_sync(FULL, pw, 2);
  const int pwa = __shfl_sync(FULL, pw, 8 * t);
  const int pwb = __shfl_sync(FULL, pw, 8 * t + 4);
  const int mm[4] = {px0 + pwa - 2 * acc[0], px0 + pwb - 2 * acc[1],
               px1 + pwa - 2 * acc[2], px1 + pwb - 2 * acc[3]};
  const int c = nt * 8 + 2 * t;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1);
    const int n = n0 + c + (e & 1);
    if (r < rows && n < n_cols) {
      out[static_cast<size_t>(m0 + r) * n_cols + n] =
          epilogue<EPI>(mm[e], k_bits, c + (e & 1), bn, vec);
    }
  }
}

template <int EPI, int CH>
cudaError_t launch_ch(const float* x, const int32_t* w, const float* va,
                      const float* vb, const float* bias, float* out,
                      int m_rows, int n_cols, int k_bits, int ldw, int bn,
                      int share, int rule, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  const int tiles = (n_cols + bn - 1) / bn;
  cfg.gridDim = dim3((tiles + share - 1) / share * share, (m_rows + BM - 1) / BM, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = sizeof(uint32_t) * smem_words(CH, bn);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = share;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, xnor_gemm_kernel<EPI, CH>, x, w, va, vb, bias,
                            out, m_rows, n_cols, k_bits, ldw, bn, rule);
}

// Stages as many k256 steps at once as K has, up to MAX_CH: one chunk, so
// one round trip, for K <= 4096.
template <int EPI>
int launch(const float* x, const int32_t* w, const float* va, const float* vb,
           const float* bias, float* out, int m_rows, int n_cols, int k_bits,
           int ldw, int bn, int share, int rule, void* stream) {
  if (bn < 32 || bn > MAX_BN || (bn & (bn - 1)) != 0 || share < 1
      || share > MAX_SHARE || k_bits < 0
      || (rule != RULE_GT0 && rule != RULE_GE0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int steps = (k_bits + 255) / 256;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define XNOR_LAUNCH(C)                                                         \
  launch_ch<EPI, C>(x, w, va, vb, bias, out, m_rows, n_cols, k_bits, ldw, bn, \
                    share, rule, st)
  if (steps <= 1) {
    err = XNOR_LAUNCH(1);
  } else if (steps <= 2) {
    err = XNOR_LAUNCH(2);
  } else if (steps <= 4) {
    err = XNOR_LAUNCH(4);
  } else if (steps <= 8) {
    err = XNOR_LAUNCH(8);
  } else {
    err = XNOR_LAUNCH(MAX_CH);
  }
#undef XNOR_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns the launch's cudaError_t (then cudaGetLastError());
// the Python wrapper raises if it is not 0 (cudaSuccess). bn and share come
// from ops/_kernels.py::xnor_tiling; rule is 0 (x > 0) or 1 (x >= 0).

int xnor_gemm_none(const float* x, const int32_t* w, float* out, int m_rows,
                   int n_cols, int k_bits, int ldw, int bn, int share, int rule,
                   void* stream) {
  return launch<EPI_NONE>(x, w, nullptr, nullptr, nullptr, out, m_rows, n_cols,
                          k_bits, ldw, bn, share, rule, stream);
}

int xnor_gemm_sign(const float* x, const int32_t* w, const float* a,
                   const float* t, const float* bias, float* out, int m_rows,
                   int n_cols, int k_bits, int ldw, int bn, int share, int rule,
                   void* stream) {
  return launch<EPI_SIGN>(x, w, a, t, bias, out, m_rows, n_cols, k_bits, ldw,
                          bn, share, rule, stream);
}

int xnor_gemm_affine(const float* x, const int32_t* w, const float* a,
                     const float* c, const float* bias, float* out, int m_rows,
                     int n_cols, int k_bits, int ldw, int bn, int share,
                     int rule, void* stream) {
  return launch<EPI_AFFINE>(x, w, a, c, bias, out, m_rows, n_cols, k_bits, ldw,
                            bn, share, rule, stream);
}

}  // extern "C"
