// Attention over the paged KV pool, walking the page table in the kernel,
// for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel _paged_attn_kernel of
// distributed_mnist_bnns_tpu/ops/paged_kv.py. One body serves the three call
// shapes of the LM server: decode (C = 1 query per slot), verify (C = K
// consecutive queries per slot) and chunked prefill (S = 1, C = chunk).
//
// Operands (all contiguous):
//   q      (S, C, H, D) fp32   queries
//   qpos   (S, C)       int32  global position of each query
//   k, v   (num_pages, ps, H, D) fp32 page pools
//   tables (S, P)       int32  page ids per slot; page 0 is the null page
//   out    (S, C, H, D) fp32
// Query c of slot s attends to the keys at logical positions
// l <= qpos[s, c], l < P * ps; logical position l lives at page
// tables[s, l / ps], row l % ps. Everything later (the unwritten tail, the
// null page's garbage, a freed page's old rows) is masked.
//
// The TPU kernel walks (slot, page) as a sequential grid and carries the
// online-softmax state (m, l, acc) in VMEM from page to page. Here one block
// of NW warps owns one (head, slot, query). The query's keys are cut into
// tiles of 32 logical positions, and warp w takes tiles w, w + NW, ... with
// its own online-softmax state, so the warps of a block walk the keys in
// parallel; at the end the block merges the NW states through shared memory
// (the flash-decoding split, inside one block). Within a warp, lane j scores
// key j of the tile: it reads K row j through the page table straight from
// device memory (16-byte loads when D % 4 == 0) and dots it with q, which
// the block keeps in shared memory. The tile's max and sum are warp
// shuffles; for the value product each lane owns D / 32 output columns and
// reads V rows straight from device memory, neighbouring lanes on
// neighbouring columns. No tile is staged in shared memory and no block
// barrier sits inside the key loop, so a warp's loads overlap freely.
//
// The softmax follows the JAX kernel's conventions (paged_kv.py:388-407):
// masked scores are NEG_INF = -1e30; p = exp(s - m) only where s > NEG_INF/2;
// a correction exp(m_prev - m_new) is 0 while m_prev is still NEG_INF; a
// query with no key at all (l == 0) gives 0, never NaN. Tiles past the
// query's own position are not visited: a fully masked tile would leave
// (m, l, acc) exactly as they were. Page ids outside [0, num_pages) read the
// null page instead of faulting.
//
// What bounds it on an H100: at the LM's width (H = 4, D = 64, ps = 16,
// positions < 256) one decode call reads at most 4 slots x 256 positions x
// 2 x 1 KB = 2 MB of K/V, well under a microsecond at 3.35 TB/s, and
// computes a few MFLOP. So it is bound by launch latency and by the latency
// of each warp's chain of dependent loads and shuffles, not by bytes or
// operations. The design answers with one launch per layer for all slots
// and queries, no materialised gather of the pool, NW independent key
// streams per query, and no second pass. TMA page loads, tensor-core
// products for the prefill's many queries and blocks shared by the queries
// of one slot are later work.
//
// Exact fp32 throughout (no TF32, no fast-math exp): the JAX kernel computes
// at Precision.HIGHEST. The kernel matches its plain PyTorch version to
// about 1e-6; the order of the softmax sums differs, so not bitwise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;    // keys a warp scores at once (one per lane)
constexpr int MAX_D = 128;  // head_dim limit: D / 32 accumulators a lane
constexpr int NW = 4;       // warps of a block, each on its own key tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q . k over d values; float4 loads when the rows are 16-byte aligned.
__device__ __forceinline__ float row_dot(const float* qs, const float* krow,
                                         int d) {
  float dot = 0.0f;
  if ((d & 3) == 0) {
    const float4* k4 = reinterpret_cast<const float4*>(krow);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
#pragma unroll 4
    for (int i = 0; i < d / 4; ++i) {
      const float4 kv = __ldg(k4 + i);
      const float4 qv = q4[i];
      dot = fmaf(qv.x, kv.x, dot);
      dot = fmaf(qv.y, kv.y, dot);
      dot = fmaf(qv.z, kv.z, dot);
      dot = fmaf(qv.w, kv.w, dot);
    }
  } else {
    for (int i = 0; i < d; ++i) dot = fmaf(qs[i], __ldg(krow + i), dot);
  }
  return dot;
}

__global__ void __launch_bounds__(NW * 32)
paged_attn_kernel(const float* __restrict__ q, const int32_t* __restrict__ qpos,
                  const float* __restrict__ kpool, const float* __restrict__ vpool,
                  const int32_t* __restrict__ tables, float* __restrict__ out,
                  int n_queries, int n_heads, int d, int ps, int n_table,
                  int num_pages, float scale) {
  __shared__ __align__(16) float qs[MAX_D];
  __shared__ float ms[NW], ls[NW];
  __shared__ float accs[NW][MAX_D];

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int c = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t q_off =
      ((static_cast<size_t>(s) * n_queries + c) * n_heads + h) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = q[q_off + i];
  __syncthreads();

  const int my_pos = qpos[static_cast<size_t>(s) * n_queries + c];
  const int n_keys = min(my_pos + 1, n_table * ps);  // keys at l <= my_pos
  const int32_t* table = tables + static_cast<size_t>(s) * n_table;
  const size_t row_stride = static_cast<size_t>(n_heads) * d;

  float m = NEG_INF, lsum = 0.0f;
  float acc[MAX_D / 32];
#pragma unroll
  for (int i = 0; i < MAX_D / 32; ++i) acc[i] = 0.0f;

  for (int t0 = warp * TILE; t0 < n_keys; t0 += NW * TILE) {
    const int l = t0 + lane;
    size_t row = 0;                     // this lane's key row in the pools
    float sc = NEG_INF;
    if (l < n_keys) {
      int page = table[l / ps];
      if (page < 0 || page >= num_pages) page = 0;
      row = (static_cast<size_t>(page) * ps + l % ps) * row_stride + h * d;
      sc = row_dot(qs, kpool + row, d) * scale;
    }
    const float m_new = fmaxf(m, warp_max(sc));
    const float p = (sc > NEG_INF / 2) ? expf(sc - m_new) : 0.0f;
    const float corr = (m > NEG_INF / 2) ? expf(m - m_new) : 0.0f;
    lsum = corr * lsum + warp_sum(p);
    m = m_new;
    const int n_here = min(TILE, n_keys - t0);
    float pv[MAX_D / 32];
#pragma unroll
    for (int i = 0; i < MAX_D / 32; ++i) pv[i] = 0.0f;
    for (int j = 0; j < n_here; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const size_t rj = __shfl_sync(0xffffffffu, row, j);
#pragma unroll
      for (int i = 0; i < MAX_D / 32; ++i) {
        const int col = lane + 32 * i;
        if (col < d) pv[i] = fmaf(pj, __ldg(vpool + rj + col), pv[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < MAX_D / 32; ++i) acc[i] = corr * acc[i] + pv[i];
  }

  // Merge the NW warps' states: rescale each to the common max.
  if (lane == 0) {
    ms[warp] = m;
    ls[warp] = lsum;
  }
#pragma unroll
  for (int i = 0; i < MAX_D / 32; ++i) {
    const int col = lane + 32 * i;
    if (col < d) accs[warp][col] = acc[i];
  }
  __syncthreads();
  if (warp != 0) return;
  float m_all = NEG_INF;
  for (int w = 0; w < NW; ++w) m_all = fmaxf(m_all, ms[w]);
  float l_all = 0.0f;
  float f[NW];
  for (int w = 0; w < NW; ++w) {
    f[w] = (ms[w] > NEG_INF / 2) ? expf(ms[w] - m_all) : 0.0f;
    l_all = fmaf(f[w], ls[w], l_all);
  }
  const float denom = (l_all == 0.0f) ? 1.0f : l_all;
  for (int col = lane; col < d; col += 32) {
    float a = 0.0f;
    for (int w = 0; w < NW; ++w) a = fmaf(f[w], accs[w][col], a);
    out[q_off + col] = a / denom;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() right after the launch (the Python wrapper
// raises if it is not 0), or cudaErrorInvalidValue for a head_dim the
// kernel does not take.
int paged_attn(const float* q, const int32_t* qpos, const float* kpool,
               const float* vpool, const int32_t* tables, float* out,
               int n_slots, int n_queries, int n_heads, int d, int ps,
               int n_table, int num_pages, float scale, void* stream) {
  if (d < 1 || d > MAX_D) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(n_heads, n_slots, n_queries);
  paged_attn_kernel<<<grid, NW * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      q, qpos, kpool, vpool, tables, out, n_queries, n_heads, d, ps, n_table,
      num_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
