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
// What bounds it on an H100: bytes, on paper. At the LM's width (H = 4,
// D = 64, ps = 16, positions < 256) a decode call must read at most 4 slots x
// 256 positions x 2 x 1 KB = 2 MB of K/V (chip_smoke.py's _paged_bound:
// 0.00063 ms at 3.35 TB/s) and computes a few MFLOP. In practice it is bound
// by latency: one launch, then a chain of dependent steps in each block.
// The first design (one 4-warp block per (head, slot, query), K and V read
// straight from device memory inside the key loop) took 0.0220 ms at decode,
// (S, C, P) = (4, 1, 16), qpos 255. It lost that time in its value product:
// a loop over the tile's keys with a runtime trip count, each iteration a
// shuffled row index, an __ldg of V and the fmaf that consumed it, so every
// warp waited for one L2 round trip per key, 64 in a row at qpos 255. At
// prefill each of the chunk's queries had a block of its own and read the
// slot's pages again.
//
// This design:
//   - A cluster of R = 8 blocks serves up to CQ = 16 queries of one (head,
//     slot): every query of a decode or verify slot, a whole prefill chunk.
//     Each block reads the queries, their positions and the slot's table row
//     into shared memory once, so no global load is left in the key loop.
//   - The keys are cut into tiles of TK = 16 logical positions (a page at
//     ps = 16). Tile j goes to partition g = j mod G, G = R * NK: block
//     g mod R of the cluster, key slot g / R of its NK = 2, whatever the
//     queries are. A key slot stages its tiles' K and V rows in shared
//     memory with cp.async (16-byte copies when D % 4 == 0 and the pools are
//     16-byte aligned, 4-byte ones otherwise), two stages deep: the next
//     tile's copies are in flight while the current one is computed, so
//     scores and P.V read only shared memory and registers. A slot's QS
//     warps share its staged tile, each for QW = CQ / QS of the queries
//     (QW = 1 at decode, 4 otherwise); only the slot's own warps wait for
//     each other (a named barrier), never the block.
//   - Each partition keeps an online-softmax state (m, l, acc) per query
//     and skips a tile that lies wholly past a query's position. At the end
//     every partition pushes its state of query c into the shared memory of
//     block c mod R (a store to distributed shared memory), one cluster
//     barrier, and that block merges the G states in partition order from
//     its own shared memory (the flash-decoding split inside one launch; no
//     second pass). Eight blocks a (head, slot) put several SMs' load
//     bandwidth and issue slots on it: one block would leave one SM to pull
//     a slot's 128 KB at decode and to score a prefill chunk's 16 queries
//     against 256 keys alone. (scripts/torch_paged_variants.py times
//     other R and NK on a card; PERF.md has what they gave.)
//   - Within a warp, a lane scores one query against one key of the tile
//     (decode) or one of the warp's 4 queries against 2 keys, so that a
//     shared-memory row load serves several lanes; the tile's max per query
//     is a shuffle over the lanes that hold its keys. For P.V each lane holds
//     D / 32 columns of the tile's 16 V rows in registers and runs, per
//     query, one fmaf chain over k and a left fold of the tile's p.
//
// A query's output bits depend only on its own q, position, table row and
// the pools, never on S, C, its slot or the other queries: the tile ->
// partition assignment and every order of summation (the d chain of a score,
// the k fold of a tile's sum, the k chain of P.V, the partition order of
// the merge) are functions of key position alone, and every rounding is
// spelled out (__fmaf_rn, __fmul_rn, __fadd_rn, __fdiv_rn; no contraction
// is left to the compiler). The LM server's streams are held token-identical
// to the decoder driven alone, which rests on this.
//
// The softmax follows the JAX kernel's conventions (paged_kv.py:388-407):
// masked scores are NEG_INF = -1e30; p = exp(s - m) only where s > NEG_INF/2;
// a correction exp(m_prev - m_new) is 0 while m_prev is still NEG_INF; a
// query with no key at all (l == 0) gives 0, never NaN. Tiles past a query's
// own position are not visited for it: a fully masked tile would leave
// (m, l, acc) exactly as they were. Page ids outside [0, num_pages) read the
// null page instead of faulting.
//
// Exact fp32 throughout (no TF32, no tensor cores, no fast-math exp): the JAX
// kernel computes at Precision.HIGHEST. The kernel matches its plain PyTorch
// version to about 1e-6; the order of the softmax sums differs, so not
// bitwise.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TK = 16;       // logical positions of a key tile
constexpr int R = 8;         // blocks of a cluster, one (head, slot)
constexpr int NK = 2;        // key slots of a block
constexpr int G = R * NK;    // partitions of the keys: tile j -> j mod G
constexpr int MAX_D = 128;   // head_dim limit: D / 32 columns a lane
constexpr int MAX_CQ = 16;   // queries a cluster serves
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
constexpr float NEG_INF = -1e30f;

// Shared memory of a block, in floats; every region a multiple of 4, so
// every row is 16-byte aligned.
//   qs                [CQ][LD]        the queries, zero past D
//   per key slot, SLOT floats:
//     stage 0, 1      [K, V][TK][LD]  cp.async targets
//     pbuf            [CQ][TK]        the tile's p
//     mst, lst, cst   [CQ4] each      running max, running sum, correction
//   receive area, the merge's (QR = the queries a block merges):
//     racc            [G][QR][DP]     each partition's acc
//     rm, rl          [G * QR] each   each partition's m and l
//     rf              [(G + 1) * QR]  merge factors, then each query's l
//   nkeys_s           [CQ4] int       keys visible to each query
//   table_s           [P rounded up to 4] int, out-of-range ids made 0
template <int DP, int CQ>
struct Layout {
  static constexpr int QW = CQ < 4 ? CQ : 4;   // queries of a warp
  static constexpr int QS = CQ / QW;           // warps of a key slot
  static constexpr int NT = NK * QS * 32;      // threads of a block
  static constexpr int LD = DP + 4;            // padded row: K reads hit 8 banks
  static constexpr int CQ4 = (CQ + 3) / 4 * 4;
  static constexpr int STAGE = 2 * TK * LD;
  static constexpr int SLOT = 2 * STAGE + CQ * TK + 3 * CQ4;
  static constexpr int QR = (CQ + R - 1) / R;
  static constexpr int RECV = CQ * LD + NK * SLOT;   // receive area's offset
  static constexpr int RM = G * QR * DP;             // offsets within it
  static constexpr int RL = RM + (G * QR + 3) / 4 * 4;
  static constexpr int RF = RL + (G * QR + 3) / 4 * 4;
  static constexpr int RSIZE = RF + ((G + 1) * QR + 3) / 4 * 4;
  static constexpr int FIXED = RECV + RSIZE + CQ4;
  static size_t bytes(int n_table) {
    return 4 * (static_cast<size_t>(FIXED) + (n_table + 3) / 4 * 4);
  }
};

// Copy tile j's K and V rows (positions TK j .. TK j + TK - 1 of the slot)
// of head h into kdst, vdst ([TK][LD] each); rows past the table and columns
// past D are zero-filled. Thread t of the nt threads of a key slot copies
// its share; the caller commits the group.
template <int DP>
__device__ __forceinline__ void load_tile(float* kdst, float* vdst,
                                          const float* kpool, const float* vpool,
                                          const int* table_s, int j, int t,
                                          int nt, int h, int d, int ps,
                                          int n_pos, size_t row_stride,
                                          bool vec) {
  constexpr int LD = DP + 4;
  if (vec) {
    for (int i = t; i < TK * (DP / 4); i += nt) {
      const int r = i / (DP / 4), col = 4 * (i % (DP / 4)), l = j * TK + r;
      const bool ok = l < n_pos && col < d;
      size_t off = 0;
      if (ok)
        off = (static_cast<size_t>(table_s[l / ps]) * ps + l % ps) * row_stride +
              static_cast<size_t>(h) * d + col;
      cp_async16(kdst + r * LD + col, kpool + off, ok ? 16 : 0);
      cp_async16(vdst + r * LD + col, vpool + off, ok ? 16 : 0);
    }
  } else {
    for (int i = t; i < TK * DP; i += nt) {
      const int r = i / DP, col = i % DP, l = j * TK + r;
      const bool ok = l < n_pos && col < d;
      size_t off = 0;
      if (ok)
        off = (static_cast<size_t>(table_s[l / ps]) * ps + l % ps) * row_stride +
              static_cast<size_t>(h) * d + col;
      cp_async4(kdst + r * LD + col, kpool + off, ok ? 4 : 0);
      cp_async4(vdst + r * LD + col, vpool + off, ok ? 4 : 0);
    }
  }
}

// The QS warps of key slot n wait for each other (barrier 0 is the block's).
template <int QS>
__device__ __forceinline__ void slot_sync(int n) {
  if constexpr (QS == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + n), "r"(QS * 32) : "memory");
  }
}

template <int DP, int CQ>
__global__ void __cluster_dims__(R, 1, 1)
__launch_bounds__(Layout<DP, CQ>::NT, 1)
paged_attn_kernel(const float* __restrict__ q, const int32_t* __restrict__ qpos,
                  const float* __restrict__ kpool, const float* __restrict__ vpool,
                  const int32_t* __restrict__ tables, float* __restrict__ out,
                  int n_queries, int n_heads, int d, int ps, int n_table,
                  int num_pages, float scale, bool vec) {
  using L = Layout<DP, CQ>;
  constexpr int LD = L::LD, NT = L::NT, QW = L::QW, QS = L::QS, NC = DP / 32;
  static_assert(QW == 1 || QW == 4, "a warp serves one query or four");
  constexpr int KL = QW == 1 ? 1 : 2;   // keys a lane scores
  // The lane bits that index a lane's keys: its query's max is an xor
  // shuffle over offsets XLO .. XHI / 2.
  constexpr int XLO = QW == 1 ? 1 : 4, XHI = QW == 1 ? TK : 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  int* nkeys_s = reinterpret_cast<int*>(smem + L::RECV + L::RSIZE);
  int* table_s = nkeys_s + L::CQ4;
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = static_cast<int>(cluster.block_rank());
  // Distributed shared memory may be written only once every block of the
  // cluster runs: arrive now, wait before the merge's first remote store.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int h = blockIdx.x / R, s = blockIdx.y, c0 = blockIdx.z * CQ;
  const int nq = min(CQ, n_queries - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = warp / QS, sub = warp % QS;   // key slot, warp within it
  const int n_pos = n_table * ps;             // positions the table covers
  const size_t row_stride = static_cast<size_t>(n_heads) * d;
  const size_t q_row0 = static_cast<size_t>(s) * n_queries + c0;

  for (int i = threadIdx.x; i < CQ * DP; i += NT) {
    const int c = i / DP, col = i % DP;
    qs[c * LD + col] = (c < nq && col < d)
        ? q[((q_row0 + c) * n_heads + h) * d + col] : 0.0f;
  }
  for (int c = threadIdx.x; c < CQ; c += NT)
    nkeys_s[c] = c < nq ? min(qpos[q_row0 + c] + 1, n_pos) : 0;
  for (int i = threadIdx.x; i < n_table; i += NT) {
    const int page = tables[static_cast<size_t>(s) * n_table + i];
    table_s[i] = (page < 0 || page >= num_pages) ? 0 : page;
  }
  __syncthreads();

  int block_keys = 0;
  for (int c = 0; c < nq; ++c) block_keys = max(block_keys, nkeys_s[c]);
  const int n_tiles = (block_keys + TK - 1) / TK;

  float* sbase = smem + CQ * LD + n * L::SLOT;
  float* pbuf = sbase + 2 * L::STAGE;
  float* mst = pbuf + CQ * TK;
  float* lst = mst + L::CQ4;
  float* cst = lst + L::CQ4;
  // This warp's queries: c = sub + QS u, u < QW.
  for (int u = lane; u < QW; u += 32) {
    mst[sub + QS * u] = NEG_INF;
    lst[sub + QS * u] = 0.0f;
  }

  const int ts = sub * 32 + lane;   // thread of the key slot
  auto issue = [&](int j, int stage) {
    if (j < n_tiles) {
      float* kdst = sbase + stage * L::STAGE;
      load_tile<DP>(kdst, kdst + TK * LD, kpool, vpool, table_s, j, ts,
                    QS * 32, h, d, ps, n_pos, row_stride, vec);
    }
    cp_async_commit();
  };

  float acc[QW][NC];
#pragma unroll
  for (int u = 0; u < QW; ++u)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[u][i] = 0.0f;

  // This lane's scores: query my_c, keys k0 + 8 e for e < KL.
  const int k0 = QW == 1 ? lane % TK : lane / 4;
  const int my_u = QW == 1 ? lane / TK : lane % 4;
  const bool my_live = my_u < QW;
  const int my_c = sub + QS * (my_live ? my_u : 0);
  const int j0 = n * R + rank;   // this slot's first tile: partition j0
  issue(j0, 0);
  issue(j0 + G, 1);
  int stage = 0;
  for (int j = j0; j < n_tiles; j += G, stage ^= 1) {
    cp_async_wait<1>();   // this thread's copies of tile j have landed
    slot_sync<QS>(n);     // and so have the slot's other threads'
    const float* ks = sbase + stage * L::STAGE;
    const float* vs = ks + TK * LD;

    // Scores. One query a warp (decode): lane k < 16 dots key k. Four: lane
    // dots query u = lane % 4 with keys lane / 4 and lane / 4 + 8, so a
    // K row load serves 4 lanes and a q row load 8.
    float dot[KL];
#pragma unroll
    for (int e = 0; e < KL; ++e) dot[e] = 0.0f;
    const float4* q4 = reinterpret_cast<const float4*>(qs + my_c * LD);
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) {
      const float4 qv = q4[i];
#pragma unroll
      for (int e = 0; e < KL; ++e) {
        const float4 kv = reinterpret_cast<const float4*>(ks + (k0 + 8 * e) * LD)[i];
        dot[e] = __fmaf_rn(qv.x, kv.x, dot[e]);
        dot[e] = __fmaf_rn(qv.y, kv.y, dot[e]);
        dot[e] = __fmaf_rn(qv.z, kv.z, dot[e]);
        dot[e] = __fmaf_rn(qv.w, kv.w, dot[e]);
      }
    }
    // The tile's max per query over the lanes that hold its keys (exact in
    // any order), the new running max, p and the correction.
    const int nk = my_live ? nkeys_s[my_c] : 0;
    float sc[KL], mt = NEG_INF;
#pragma unroll
    for (int e = 0; e < KL; ++e) {
      sc[e] = j * TK + k0 + 8 * e < nk ? __fmul_rn(dot[e], scale) : NEG_INF;
      mt = fmaxf(mt, sc[e]);
    }
#pragma unroll
    for (int o = XLO; o < XHI; o <<= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float m_old = my_live ? mst[my_c] : NEG_INF;
    const float m_new = fmaxf(m_old, mt);
#pragma unroll
    for (int e = 0; e < KL; ++e)
      if (my_live)
        pbuf[my_c * TK + k0 + 8 * e] =
            sc[e] > NEG_INF / 2 ? expf(__fsub_rn(sc[e], m_new)) : 0.0f;
    __syncwarp();   // every lane has read mst before it is written
    if (my_live && k0 == 0 && j * TK < nk) {
      cst[my_c] = m_old > NEG_INF / 2 ? expf(__fsub_rn(m_old, m_new)) : 0.0f;
      mst[my_c] = m_new;
    }
    __syncwarp();

    // P.V: the tile's V columns of this lane in registers; per query the
    // tile's sum of p (a left fold over k) and one fmaf chain over k, then
    // l = corr * l + sum and acc = corr * acc + pv.
    float vreg[TK][NC];
#pragma unroll
    for (int r = 0; r < TK; ++r)
#pragma unroll
      for (int i = 0; i < NC; ++i) vreg[r][i] = vs[r * LD + lane + 32 * i];
#pragma unroll
    for (int u = 0; u < QW; ++u) {
      const int c = sub + QS * u;
      if (j * TK >= nkeys_s[c]) continue;   // warp-uniform
      const float cr = cst[c];
      const float4* p4 = reinterpret_cast<const float4*>(pbuf + c * TK);
      float pv[NC], tsum = 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i) pv[i] = 0.0f;
#pragma unroll
      for (int r4 = 0; r4 < TK / 4; ++r4) {
        const float4 p = p4[r4];
        tsum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(tsum, p.x), p.y), p.z), p.w);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          pv[i] = __fmaf_rn(p.x, vreg[4 * r4][i], pv[i]);
          pv[i] = __fmaf_rn(p.y, vreg[4 * r4 + 1][i], pv[i]);
          pv[i] = __fmaf_rn(p.z, vreg[4 * r4 + 2][i], pv[i]);
          pv[i] = __fmaf_rn(p.w, vreg[4 * r4 + 3][i], pv[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[u][i] = __fmaf_rn(cr, acc[u][i], pv[i]);
      if (lane == 0) lst[c] = __fmaf_rn(cr, lst[c], tsum);
    }
    slot_sync<QS>(n);   // the slot is done with this stage before it refills
    issue(j + 2 * G, stage);
  }
  cp_async_wait_all();
  slot_sync<QS>(n);

  // Merge. Query c is merged by block c % R of the cluster: each warp
  // pushes its partition's (m, l, acc) of each of its queries into that
  // block's receive area (a store to distributed shared memory), one
  // cluster barrier, and every block merges its queries from its own shared
  // memory, the G partitions in partition order, rescaled to the common max.
  const int g_mine = n * R + rank;   // this slot's partition
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int u = 0; u < QW; ++u) {
    const int c = sub + QS * u;
    if (c >= nq) continue;
    float* dst = cluster.map_shared_rank(smem, c % R) + L::RECV;
    const int row = g_mine * L::QR + c / R;
#pragma unroll
    for (int i = 0; i < NC; ++i) dst[row * DP + lane + 32 * i] = acc[u][i];
    if (lane == 0) {
      dst[L::RM + row] = mst[c];
      dst[L::RL + row] = lst[c];
    }
  }
  cluster.sync();

  float* recv = smem + L::RECV;
  for (int r = threadIdx.x; r < L::QR; r += NT) {
    if (rank + R * r >= nq) continue;
    float m_all = NEG_INF;
    for (int g = 0; g < G; ++g) m_all = fmaxf(m_all, recv[L::RM + g * L::QR + r]);
    float l_all = 0.0f;
    for (int g = 0; g < G; ++g) {
      const float m = recv[L::RM + g * L::QR + r];
      const float f = m > NEG_INF / 2 ? expf(__fsub_rn(m, m_all)) : 0.0f;
      recv[L::RF + g * L::QR + r] = f;
      l_all = __fmaf_rn(f, recv[L::RL + g * L::QR + r], l_all);
    }
    recv[L::RF + G * L::QR + r] = l_all == 0.0f ? 1.0f : l_all;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < L::QR * d; idx += NT) {
    const int r = idx / d, col = idx % d, c = rank + R * r;
    if (c >= nq) continue;
    float a = 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g)
      a = __fmaf_rn(recv[L::RF + g * L::QR + r],
                    recv[(g * L::QR + r) * DP + col], a);
    out[((q_row0 + c) * n_heads + h) * d + col] =
        __fdiv_rn(a, recv[L::RF + G * L::QR + r]);
  }
}

template <int DP, int CQ>
cudaError_t launch(const float* q, const int32_t* qpos, const float* kpool,
                   const float* vpool, const int32_t* tables, float* out,
                   int n_slots, int n_queries, int n_heads, int d, int ps,
                   int n_table, int num_pages, float scale, bool vec,
                   cudaStream_t stream) {
  using L = Layout<DP, CQ>;
  const size_t bytes = L::bytes(n_table);
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  static bool done = false;
  const cudaError_t err = allow_smem(paged_attn_kernel<DP, CQ>, SMEM_LIMIT, &done);
  if (err != cudaSuccess) return err;
  dim3 grid(R * n_heads, n_slots, (n_queries + CQ - 1) / CQ);
  paged_attn_kernel<DP, CQ><<<grid, L::NT, bytes, stream>>>(
      q, qpos, kpool, vpool, tables, out, n_queries, n_heads, d, ps, n_table,
      num_pages, scale, vec);
  return cudaGetLastError();
}

// One query a slot (decode) takes the smallest block, up to 4 (verify) the
// next, more (prefill) clusters of MAX_CQ.
template <int DP>
cudaError_t launch_d(const float* q, const int32_t* qpos, const float* kpool,
                     const float* vpool, const int32_t* tables, float* out,
                     int n_slots, int n_queries, int n_heads, int d, int ps,
                     int n_table, int num_pages, float scale, bool vec,
                     cudaStream_t stream) {
  if (n_queries == 1)
    return launch<DP, 1>(q, qpos, kpool, vpool, tables, out, n_slots, n_queries,
                         n_heads, d, ps, n_table, num_pages, scale, vec, stream);
  if (n_queries <= 4)
    return launch<DP, 4>(q, qpos, kpool, vpool, tables, out, n_slots, n_queries,
                         n_heads, d, ps, n_table, num_pages, scale, vec, stream);
  return launch<DP, MAX_CQ>(q, qpos, kpool, vpool, tables, out, n_slots,
                            n_queries, n_heads, d, ps, n_table, num_pages,
                            scale, vec, stream);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() right after the launch (the Python wrapper
// raises if it is not 0), or cudaErrorInvalidValue for a shape the kernel
// does not take (head_dim outside 1..128, a table row too long for shared
// memory).
int paged_attn(const float* q, const int32_t* qpos, const float* kpool,
               const float* vpool, const int32_t* tables, float* out,
               int n_slots, int n_queries, int n_heads, int d, int ps,
               int n_table, int num_pages, float scale, void* stream) {
  if (d < 1 || d > MAX_D || ps < 1 || n_table < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && aligned16(kpool) && aligned16(vpool);
  if (d <= 32)
    return launch_d<32>(q, qpos, kpool, vpool, tables, out, n_slots, n_queries,
                        n_heads, d, ps, n_table, num_pages, scale, vec, st);
  if (d <= 64)
    return launch_d<64>(q, qpos, kpool, vpool, tables, out, n_slots, n_queries,
                        n_heads, d, ps, n_table, num_pages, scale, vec, st);
  return launch_d<128>(q, qpos, kpool, vpool, tables, out, n_slots, n_queries,
                       n_heads, d, ps, n_table, num_pages, scale, vec, st);
}

}  // extern "C"
