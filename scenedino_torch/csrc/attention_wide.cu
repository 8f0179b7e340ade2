// K1 past head dim 256: softmax(Q K^T / sqrt(D)) V over (B, N, H, D) bf16,
// its log-sum-exp, and the backward's dQ (with di = rowsum(dO o)) and dK, dV.
//
// Replaces, at the head dims past attention_any.cu's widest (256), the Pallas
// TPU flash attention reached from scenedino_tpu/models/vit.py:126
// `_flash_mhsa` (its call at :160; jax/experimental/pallas/ops/tpu/
// flash_attention.py:589 `_flash_attention_impl`) and its custom VJP,
// `_flash_attention_bwd_dq` (:1287) and `_flash_attention_bwd_dkv` (:941),
// which take any D. A ViT of `vit_overrides` with wide heads has D > 256:
// ViT-B/8 with 2 heads (384) or 1 (768), width 1024 with 2 heads (512),
// width 1280 with 4 heads (320) or 1 (1280).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): the forward does
// 4 N^2 D B H FLOP, dq 6 and dkv 8, against about N D B H bf16 values a
// tensor: operations, the tensor cores. At (2, 1921, 2, 384) the forward's
// products take 0.0229 ms, dq's 0.0344 and dkv's 0.0459.
//
// What changes past 256 columns, and the design:
//   * Registers. A 64-row accumulator of C fp32 columns is C / 2 registers a
//     thread. So the output columns split into column groups of G 64-column
//     chunks: 4 (256 columns) in the forward and dq, 2 in dkv (dK and dV, 128
//     columns each). A group is a block of the grid; every group recomputes
//     S = Q K^T (and dP) over the whole head dim, so the products over the
//     head dim run once per group: ceil(chunks / G) times in all. The last
//     group of a row of chunks that G does not divide starts at chunk
//     chunks - G, overlapping the one before, and stores only its own chunks.
//     G is a template parameter and the accumulators' indices are known at
//     compile time: no wgmma runs under a run-time predicate (a predicated
//     wgmma with a register A operand once let ptxas reuse that operand's
//     registers inside the walk, tools/probe_any_registers.py).
//   * Shared memory. A 64-row tile of D bf16 is 128 D bytes (160 KB at 1280):
//     nothing is resident. Every operand is streamed through one ring of
//     STAGES slots of two 64 x 64 tiles (16 KB) in the order the products use
//     them: a step is one slot. The products over the head dim (Q K^T, dO V^T;
//     K Q^T, V dO^T) take a step a 64-column chunk, both operands' chunks in
//     it; the products whose N is the head dim (P V, dS K; P^T dO, dS^T Q)
//     take a step for two of their group's chunks. One warp of a producer
//     warpgroup starts every TMA load; its slot's full mbarrier counts the
//     bytes, its empty one the four consumer warps once their products are
//     done. Columns past D are zeros from TMA on a load and cut on a store;
//     the tensor maps are attention_any.cu's (inner dimension D, 64-column
//     boxes under the 128-byte swizzle).
//   * A block is one consumer warpgroup of 64 own rows and the producer
//     warpgroup, one block an SM: the consumer holds its accumulators in
//     about 200-240 registers (the forward's four O tiles, S and P; dq's four
//     dQ tiles, S, dP and dS; dkv's two dK and two dV tiles, S^T, dP^T, P^T
//     and dS^T). Two blocks an SM, 128 registers a thread at launch and
//     setmaxnreg's split, spilled in the forward and dkv and serialized their
//     wgmmas (ptxas C7512).
//   * Identical softmax state across groups. Every group forms the same S
//     with the same products in the same order, so every group holds the same
//     bits of the running max m and sum l, and of P. The log-sum-exp (and
//     dq's di) is written by group 0 only. The forward is hopper.cuh's online
//     softmax in base 2 with the exact rescale; the ragged key tail is at
//     -inf on the last tile (dq: P = 0 there); dkv's query columns past N
//     have lse +inf (P = 0) and di 0, as in attention_any.cu.
//   * In a step the products over a chunk are committed as one wgmma group,
//     and the previous step's group is awaited (its slot goes back) while it
//     runs; at the end of each phase (S; P V) every group is awaited before
//     the accumulators are read. No atomics: two launches give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BT = TILE;            // rows of an own and of a walked tile
constexpr int ANY_WIDEST = 4 * TILE;  // attention_any.cu's widest: the head dims past it come here
constexpr int THREADS = 256;        // the consumer warpgroup, then the producer's
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// output chunks a column group, by kernel, and the ring's slots (128 KB)
constexpr int FWD_G = 4, DQ_G = 4, DKV_G = 2;
constexpr int STAGES = 8;

// the ring, and 2 x 2 rows of statistics (dq: di of its own rows; dkv: a
// walked tile's lse and di, double buffered)
struct Ring {
  alignas(1024) unsigned char tile[STAGES][2][TILE_BYTES];
  alignas(16) float rows[2][2][BT];
  uint64_t full[STAGES], empty[STAGES];
};

// ------------------------------------------------------------------ the ring

// the producer's lane: step `step`'s two boxes (64-column chunk `chunk0` of
// m0's rows from row0, chunk `chunk1` of m1's from row1) into its slot once
// the slot is free
__device__ __forceinline__ void put(Ring& r, int step, const CUtensorMap* m0, int chunk0, int row0,
                                    const CUtensorMap* m1, int chunk1, int row1, int h, int b) {
  const int s = step % STAGES;
  mbar_wait(&r.empty[s], ((step / STAGES) & 1) ^ 1);  // passes at once in the first round
  mbar_arrive_expect_tx(&r.full[s], 2 * TILE_BYTES);
  tma_load_4d(r.tile[s][0], m0, &r.full[s], chunk0 * TILE, h, row0, b);
  tma_load_4d(r.tile[s][1], m1, &r.full[s], chunk1 * TILE, h, row1, b);
}

// the consumer's walk through the ring: `next` awaits a step's tiles; once
// the step's products are committed, `retire` awaits the previous step's and
// hands its slot back; `drain` awaits every product and hands the last slot
// back
struct Walk {
  int step = 0;
  int held = -1;  // the slot of the last retired step, still read by its products

  __device__ __forceinline__ int next(Ring& r) {
    const int s = step % STAGES;
    mbar_wait(&r.full[s], (step / STAGES) & 1);
    return s;
  }
  __device__ __forceinline__ void retire(Ring& r, int lane) {
    wgmma_wait<1>();
    if (held >= 0 && lane == 0) mbar_arrive(&r.empty[held]);
    held = step % STAGES;
    ++step;
  }
  __device__ __forceinline__ void drain(Ring& r, int lane) {
    wgmma_wait<0>();
    if (held >= 0 && lane == 0) mbar_arrive(&r.empty[held]);
    held = -1;
  }
};

// acc += A B^T over one 64-column chunk, A and B tiles read K-major
__device__ __forceinline__ void chunk_nt(float (&acc)[32], const unsigned char* a, const unsigned char* b) {
  const uint64_t da = wgmma_desc(a);
  const uint64_t db = wgmma_desc(b);
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    wgmma_m64n64k16_ss(acc, da + kk * WGMMA_K_STEP, db + kk * WGMMA_K_STEP, 1);
  }
}

// acc += A (64 x 64 bf16 in registers) times a walked tile read down its rows
__device__ __forceinline__ void tile_rows(float (&acc)[32], const uint32_t (&a)[16], const unsigned char* b) {
  const uint64_t db = wgmma_desc(b);
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) wgmma_m64n64k16_rs<1>(acc, &a[4 * kk], db + kk * WGMMA_MN_STEP, 1);
}

// the step of two chunks of a column group: acc[j] += A times tile 0, acc[j + 1] += A times tile 1
template <int G>
__device__ __forceinline__ void group_step(float (&acc)[G][32], int j, const uint32_t (&a)[16], Ring& r, int slot) {
  tile_rows(acc[j], a, r.tile[slot][0]);
  tile_rows(acc[j + 1], a, r.tile[slot][1]);
}

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_registers(acc);
}

template <int G>
__device__ __forceinline__ void fence_all(float (&acc)[G][32]) {
#pragma unroll
  for (int j = 0; j < G; ++j) fence_registers(acc[j]);
}

// the block's column group: its first chunk c0 (the last group starts G
// chunks before the end) and the first of its chunks that it stores
struct Group {
  int g, c0, first;
  __device__ __forceinline__ Group(int g_, int chunks, int G)
      : g(g_), c0(min(g_ * G, chunks - G)), first(g_ * G - c0) {}
};

// the consumer's G accumulator tiles -> bf16 in the idle ring (tile j at
// slot j / 2 + `slot0`), then one thread stores those from `first` on at
// columns 64 (c0 + j) of rows row0..row0 + 63
template <int G>
__device__ __forceinline__ void store_group(Ring& r, const CUtensorMap* map, const float (&acc)[G][32],
                                            int slot0, const Group& grp, int row0, int h, int b, int tid) {
  const int warp = tid / 32;
  const int lane = tid % 32;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= grp.first) store_accumulator(r.tile[slot0 + j / 2][j % 2], acc[j], warp, lane);
  }
  fence_proxy_async();
  named_barrier_sync(1, 128);
  if (tid == 0) {
    for (int j = grp.first; j < G; ++j) {
      tma_store_4d(map, r.tile[slot0 + j / 2][j % 2], (grp.c0 + j) * TILE, h, row0, b);
    }
    tma_store_commit();
    tma_store_wait_read();
  }
}

// the tensor maps of a launch, and what every kernel is told
struct Maps {
  CUtensorMap q, k, v, o, dout;  // o: the forward's output, dq's dQ, dkv's dK
  CUtensorMap dv;                // dkv's dV
};

struct Args {
  const bf16* o;      // dq: the forward's output
  const bf16* dout;   // dq: its gradient
  const float* lse;   // dq, dkv: the forward's log-sum-exp
  const float* di;    // dkv: dq's di
  float* lse_out;     // the forward: null (not written) or the log-sum-exp
  float* di_out;      // dq: di
  int N, H, D, chunks, groups;
  float scale;
};

// ----------------------------------------------------------------- forward

__device__ __forceinline__ void fwd_produce(Ring& r, const Maps& maps, const Args& a, const Group& grp,
                                            int row0, int h, int b, int tiles) {
  int step = 0;
  for (int t = 0; t < tiles; ++t) {
    for (int c = 0; c < a.chunks; ++c) put(r, step++, &maps.q, c, row0, &maps.k, c, t * BT, h, b);
#pragma unroll
    for (int j = 0; j < FWD_G; j += 2) {
      put(r, step++, &maps.v, grp.c0 + j, t * BT, &maps.v, grp.c0 + j + 1, t * BT, h, b);
    }
  }
}

// O (and the log-sum-exp) of 64 query rows in the group's columns
__device__ __forceinline__ void fwd_consume(Ring& r, const Maps& maps, const Args& a, const Group& grp,
                                            int row0, int h, int b, int tiles) {
  constexpr int G = FWD_G;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col0 = (lane % 4) * 2;
  const float scale_log2 = a.scale * LOG2E;

  float o[G][32], s[32];
  uint32_t p[16];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float alpha[2];
#pragma unroll
  for (int j = 0; j < G; ++j) zero(o[j]);

  Walk w;
  for (int t = 0; t < tiles; ++t) {
    zero(s);
    for (int c = 0; c < a.chunks; ++c) {  // S = Q K^T, a chunk of the head dim a step
      const int slot = w.next(r);
      fence_registers(s);
      wgmma_fence();
      chunk_nt(s, r.tile[slot][0], r.tile[slot][1]);
      wgmma_commit();
      w.retire(r, lane);
    }
    w.drain(r, lane);
    fence_registers(s);
    if (softmax_tile(t, s, m, l, alpha, scale_log2, a.N, col0)) {
#pragma unroll
      for (int j = 0; j < G; ++j) rescale(o[j], alpha);  // the first tile: O is 0, alpha 0
    }
    pack_p(s, p);
#pragma unroll
    for (int j = 0; j < G; j += 2) {  // O += P V in the group's columns, two chunks a step
      const int slot = w.next(r);
      fence_all(o);
      wgmma_fence();
      group_step(o, j, p, r, slot);
      wgmma_commit();
      w.retire(r, lane);
    }
    w.drain(r, lane);
    fence_all(o);
  }

  const int row_lo = warp * 16 + lane / 4;
  float inv[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
    inv[hi] = 1.f / l[hi];
    const int n = row0 + row_lo + 8 * hi;
    if (grp.g == 0 && a.lse_out != nullptr && lane % 4 == 0 && n < a.N) {
      a.lse_out[((size_t)b * a.H + h) * a.N + n] = (m[hi] + log2f(l[hi])) * LN2;
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) rescale(o[j], inv);
  named_barrier_sync(1, 128);  // every warp is done with the ring
  store_group(r, &maps.o, o, 0, grp, row0, h, b, tid);
}

__global__ void __launch_bounds__(THREADS, 1) fwd_kernel(const __grid_constant__ Maps maps, const Args args) {
  extern __shared__ unsigned char smem_raw[];
  Ring& r = aligned_smem<Ring>(smem_raw);
  const Group grp(blockIdx.x % args.groups, args.chunks, FWD_G);
  const int row0 = blockIdx.x / args.groups * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (args.N + BT - 1) / BT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 4);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 128) {
    fwd_produce(r, maps, args, grp, row0, h, b, tiles);
  } else if (threadIdx.x < 128) {
    fwd_consume(r, maps, args, grp, row0, h, b, tiles);
  }
}

// ---------------------------------------------------------------------- dq

__device__ __forceinline__ void dq_produce(Ring& r, const Maps& maps, const Args& a, const Group& grp,
                                           int row0, int h, int b, int tiles) {
  int step = 0;
  for (int t = 0; t < tiles; ++t) {
    for (int c = 0; c < a.chunks; ++c) {
      put(r, step++, &maps.q, c, row0, &maps.k, c, t * BT, h, b);
      put(r, step++, &maps.dout, c, row0, &maps.v, c, t * BT, h, b);
    }
#pragma unroll
    for (int j = 0; j < DQ_G; j += 2) {
      put(r, step++, &maps.k, grp.c0 + j, t * BT, &maps.k, grp.c0 + j + 1, t * BT, h, b);
    }
  }
}

// dS = P (dP * scale - di * scale) with P = exp2(S * scale * log2(e) - lse * log2(e)),
// on the accumulators' registers, packed to bf16 as the A operand of
// dQ += dS K. MASK: columns at or past `nvalid` (key rows past N) give 0.
template <bool MASK>
__device__ __forceinline__ void dq_elementwise(const float (&s)[32], const float (&dp)[32], uint32_t (&ds)[16],
                                               const float (&lse2_r)[2], const float (&dis_r)[2], float scale,
                                               float scale_log2, int nvalid, int col0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int i = 4 * j + 2 * hi;
      float ds0 = fast_exp2(fmaf(s[i], scale_log2, -lse2_r[hi])) * fmaf(dp[i], scale, -dis_r[hi]);
      float ds1 = fast_exp2(fmaf(s[i + 1], scale_log2, -lse2_r[hi])) * fmaf(dp[i + 1], scale, -dis_r[hi]);
      if (MASK && 8 * j + col0 >= nvalid) ds0 = 0.f;
      if (MASK && 8 * j + col0 + 1 >= nvalid) ds1 = 0.f;
      ds[a_index(j, hi)] = pack_bf16(ds0, ds1);
    }
  }
}

// dQ of 64 query rows in the group's columns
__device__ __forceinline__ void dq_consume(Ring& r, const Maps& maps, const Args& a, const Group& grp,
                                           int row0, int h, int b, int tiles) {
  constexpr int G = DQ_G;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int N = a.N;
  const size_t bh = (size_t)b * a.H + h;
  float* di_rows = r.rows[0][0];

  // di = rowsum(dO * o) in fp32 over the whole head dim, two threads a row, 16-byte loads
  {
    const int rr = tid / 2;
    const int half = tid % 2;
    const int n = row0 + rr;
    float acc = 0.f;
    if (n < N) {
      const size_t at = ((size_t)(b * N + n) * a.H + h) * a.D;
      const uint4* orow = reinterpret_cast<const uint4*>(a.o + at);
      const uint4* drow = reinterpret_cast<const uint4*>(a.dout + at);
      for (int c = half; c < a.D / 8; c += 2) {
        const uint4 ov = orow[c];
        const uint4 dv = drow[c];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          acc = fmaf(of.x, df.x, acc);
          acc = fmaf(of.y, df.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      di_rows[rr] = acc;
      if (grp.g == 0 && n < N) a.di_out[bh * N + n] = acc;
    }
  }
  named_barrier_sync(1, 128);

  // the thread's two rows of the accumulators: row_lo and row_lo + 8
  const int row_lo = warp * 16 + lane / 4;
  const int col0 = (lane % 4) * 2;
  const float scale = a.scale;
  const float scale_log2 = scale * LOG2E;
  float dis_r[2], lse2_r[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int n = row0 + row_lo + hi * 8;
    dis_r[hi] = di_rows[row_lo + hi * 8] * scale;
    lse2_r[hi] = n < N ? a.lse[bh * N + n] * LOG2E : 0.f;  // rows past N: q = dO = 0, so dS = 0
  }

  float dq[G][32], s[32], dp[32];
  uint32_t ds[16];
#pragma unroll
  for (int j = 0; j < G; ++j) zero(dq[j]);

  Walk w;
  for (int t = 0; t < tiles; ++t) {
    zero(s);
    zero(dp);
    for (int c = 0; c < a.chunks; ++c) {  // S = Q K^T and dP = dO V^T, a chunk a step each
      int slot = w.next(r);
      fence_registers(s);
      wgmma_fence();
      chunk_nt(s, r.tile[slot][0], r.tile[slot][1]);
      wgmma_commit();
      w.retire(r, lane);
      slot = w.next(r);
      fence_registers(dp);
      wgmma_fence();
      chunk_nt(dp, r.tile[slot][0], r.tile[slot][1]);
      wgmma_commit();
      w.retire(r, lane);
    }
    w.drain(r, lane);
    fence_registers(s);
    fence_registers(dp);
    const int nvalid = N - t * BT;  // columns of this tile below N
    if (nvalid >= BT) {
      dq_elementwise<false>(s, dp, ds, lse2_r, dis_r, scale, scale_log2, nvalid, col0);
    } else {
      dq_elementwise<true>(s, dp, ds, lse2_r, dis_r, scale, scale_log2, nvalid, col0);
    }
#pragma unroll
    for (int j = 0; j < G; j += 2) {  // dQ += dS K in the group's columns, two chunks a step
      const int slot = w.next(r);
      fence_all(dq);
      wgmma_fence();
      group_step(dq, j, ds, r, slot);
      wgmma_commit();
      w.retire(r, lane);
    }
    w.drain(r, lane);
    fence_all(dq);
  }
  named_barrier_sync(1, 128);  // every warp is done with the ring
  store_group(r, &maps.o, dq, 0, grp, row0, h, b, tid);
}

__global__ void __launch_bounds__(THREADS, 1) dq_kernel(const __grid_constant__ Maps maps, const Args args) {
  extern __shared__ unsigned char smem_raw[];
  Ring& r = aligned_smem<Ring>(smem_raw);
  const Group grp(blockIdx.x % args.groups, args.chunks, DQ_G);
  const int row0 = blockIdx.x / args.groups * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (args.N + BT - 1) / BT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 128) {
    dq_produce(r, maps, args, grp, row0, h, b, tiles);
  } else if (threadIdx.x < 128) {
    dq_consume(r, maps, args, grp, row0, h, b, tiles);
  }
}

// --------------------------------------------------------------------- dkv

__device__ __forceinline__ void dkv_produce(Ring& r, const Maps& maps, const Args& a, const Group& grp,
                                            int row0, int h, int b, int tiles) {
  int step = 0;
  for (int t = 0; t < tiles; ++t) {
    for (int c = 0; c < a.chunks; ++c) {
      put(r, step++, &maps.k, c, row0, &maps.q, c, t * BT, h, b);
      put(r, step++, &maps.v, c, row0, &maps.dout, c, t * BT, h, b);
    }
    put(r, step++, &maps.dout, grp.c0, t * BT, &maps.dout, grp.c0 + 1, t * BT, h, b);
    put(r, step++, &maps.q, grp.c0, t * BT, &maps.q, grp.c0 + 1, t * BT, h, b);
  }
}

// P^T = exp2(S^T scale log2(e) - lse log2(e)) on S^T's registers, packed to
// bf16 as the A operand of dV += P^T dO; the statistics belong to the columns
// (query rows), and a column past N has lse = +inf, so its P is 0
__device__ __forceinline__ void dkv_probabilities(const float (&st)[32], uint32_t (&p)[16], const float* lse2,
                                                  float scale_log2, int col0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + col0);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int i = 4 * j + 2 * hi;
      p[a_index(j, hi)] = pack_bf16(fast_exp2(fmaf(st[i], scale_log2, -l2.x)),
                                    fast_exp2(fmaf(st[i + 1], scale_log2, -l2.y)));
    }
  }
}

// dS^T = P^T (dP^T scale - di scale) from the packed P^T, packed to bf16 as
// the A operand of dK += dS^T Q
__device__ __forceinline__ void dkv_scores_grad(const uint32_t (&p)[16], const float (&dpt)[32], uint32_t (&ds)[16],
                                                const float* dis, float scale, int col0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 di = *reinterpret_cast<const float2*>(dis + 8 * j + col0);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int i = 4 * j + 2 * hi;
      const uint32_t pair = p[a_index(j, hi)];
      const float2 pf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pair));
      ds[a_index(j, hi)] = pack_bf16(pf.x * fmaf(dpt[i], scale, -di.x), pf.y * fmaf(dpt[i + 1], scale, -di.y));
    }
  }
}

// dK and dV of 64 key rows in the group's columns (key rows past N compute
// values that the store cuts)
__device__ __forceinline__ void dkv_consume(Ring& r, const Maps& maps, const Args& a, const Group& grp,
                                            int row0, int h, int b, int tiles) {
  constexpr int G = DKV_G;
  static_assert(G == 2, "dV and dK take one step each");
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int col0 = (lane % 4) * 2;
  const int N = a.N;
  const float scale = a.scale;
  const float scale_log2 = scale * LOG2E;
  const size_t bh = (size_t)b * a.H + h;

  float dk[G][32], dv[G][32], st[32], dpt[32];
  uint32_t p[16], ds[16];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    zero(dk[j]);
    zero(dv[j]);
  }

  Walk w;
  for (int t = 0; t < tiles; ++t) {
    // the walked tile's lse log2(e) (+inf past N) and di scale (0 past N), in
    // the buffer that tile t - 1 did not use
    float* lse2 = r.rows[t % 2][0];
    float* dis = r.rows[t % 2][1];
    {
      const int i = tid % BT;
      const int n = t * BT + i;
      if (tid < BT) {
        lse2[i] = n < N ? a.lse[bh * N + n] * LOG2E : INFINITY;
      } else {
        dis[i] = n < N ? a.di[bh * N + n] * scale : 0.f;
      }
    }
    named_barrier_sync(1, 128);

    zero(st);
    zero(dpt);
    for (int c = 0; c < a.chunks; ++c) {  // S^T = K Q^T and dP^T = V dO^T, a chunk a step each
      int slot = w.next(r);
      fence_registers(st);
      wgmma_fence();
      chunk_nt(st, r.tile[slot][0], r.tile[slot][1]);
      wgmma_commit();
      w.retire(r, lane);
      slot = w.next(r);
      fence_registers(dpt);
      wgmma_fence();
      chunk_nt(dpt, r.tile[slot][0], r.tile[slot][1]);
      wgmma_commit();
      w.retire(r, lane);
    }
    w.drain(r, lane);
    fence_registers(st);
    fence_registers(dpt);
    dkv_probabilities(st, p, lse2, scale_log2, col0);
    dkv_scores_grad(p, dpt, ds, dis, scale, col0);

    int slot = w.next(r);  // dV += P^T dO in the group's two chunks
    fence_all(dv);
    wgmma_fence();
    group_step(dv, 0, p, r, slot);
    wgmma_commit();
    w.retire(r, lane);
    slot = w.next(r);  // dK += dS^T Q in the group's two chunks
    fence_all(dk);
    wgmma_fence();
    group_step(dk, 0, ds, r, slot);
    wgmma_commit();
    w.retire(r, lane);
    w.drain(r, lane);
    fence_all(dv);
    fence_all(dk);
  }
  named_barrier_sync(1, 128);  // every warp is done with the ring
  store_group(r, &maps.o, dk, 0, grp, row0, h, b, tid);
  store_group(r, &maps.dv, dv, 1, grp, row0, h, b, tid);
}

__global__ void __launch_bounds__(THREADS, 1) dkv_kernel(const __grid_constant__ Maps maps, const Args args) {
  extern __shared__ unsigned char smem_raw[];
  Ring& r = aligned_smem<Ring>(smem_raw);
  const Group grp(blockIdx.x % args.groups, args.chunks, DKV_G);
  const int row0 = blockIdx.x / args.groups * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (args.N + BT - 1) / BT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 128) {
    dkv_produce(r, maps, args, grp, row0, h, b, tiles);
  } else if (threadIdx.x < 128) {
    dkv_consume(r, maps, args, grp, row0, h, b, tiles);
  }
}

// ------------------------------------------------------------------ host

// the shapes the kernels take: D % 8 == 0 (16-byte rows), D past 256; the
// grid's y and z are H and B
bool bad_shape(int B, int N, int H, int D) {
  return B <= 0 || N <= 0 || H <= 0 || D % 8 != 0 || D <= ANY_WIDEST || B > 65535 || H > 65535;
}

// the map of a (B, N, H, D) bf16 tensor's 64-row, 64-column boxes (columns
// past D zero on a load, cut on a store)
int encode(CUtensorMap* map, const void* base, int B, int N, int H, int D) {
  return encode_head_box_map(map, base, B, N, H, D, TILE, BT, CU_TENSOR_MAP_SWIZZLE_128B);
}

// encodes the maps of the given tensors (null: not used) and launches
// `kernel` over (row tiles x column groups, H, B) with the ring's shared memory
template <int G, class Kernel>
int launch(Kernel kernel, bool (&allowed)[MAX_DEVICES], const void* const (&bases)[6], Args args, int B, int N,
           int H, int D, void* stream) {
  constexpr int SMEM = (int)sizeof(Ring) + 1024;
  static_assert(SMEM <= 232448, "a block's shared memory fits an SM");
  int err = (int)allow_smem(kernel, SMEM, allowed);
  if (err) return err;
  Maps maps;
  CUtensorMap* slots[6] = {&maps.q, &maps.k, &maps.v, &maps.o, &maps.dout, &maps.dv};
  for (int i = 0; i < 6; ++i) {
    if (bases[i] == nullptr) continue;
    err = encode(slots[i], bases[i], B, N, H, D);
    if (err) return err;
  }
  args.N = N;
  args.H = H;
  args.D = D;
  args.chunks = (D + TILE - 1) / TILE;
  args.groups = (args.chunks + G - 1) / G;
  const int tiles = (N + BT - 1) / BT;
  kernel<<<dim3(tiles * args.groups, H, B), THREADS, SMEM, (cudaStream_t)stream>>>(maps, args);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, N, H, D) bf16, contiguous, 16-byte aligned, on the
// current device, D % 8 == 0, D > 256; lse: (B, H, N) fp32 or null (not
// written); scale: the softmax scale. Returns a cudaError_t (0 = launched).
extern "C" int attention_wide_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int N,
                                  int H, int D, float scale, void* stream) {
  if (bad_shape(B, N, H, D)) return (int)cudaErrorInvalidValue;
  static bool allowed[MAX_DEVICES] = {};
  Args args{};
  args.lse_out = (float*)lse;
  args.scale = scale;
  return launch<FWD_G>(fwd_kernel, allowed, {q, k, v, out, nullptr, nullptr}, args, B, N, H, D, stream);
}

// dq (B, N, H, D) bf16 and di (B, H, N) fp32 from q, k, v, o, dout (as the
// forward's) and lse (B, H, N) fp32. Returns a cudaError_t.
extern "C" int attention_wide_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                     const void* lse, void* dq, void* di, int B, int N, int H, int D, float scale,
                                     void* stream) {
  if (bad_shape(B, N, H, D)) return (int)cudaErrorInvalidValue;
  static bool allowed[MAX_DEVICES] = {};
  Args args{};
  args.o = (const bf16*)o;
  args.dout = (const bf16*)dout;
  args.lse = (const float*)lse;
  args.di_out = (float*)di;
  args.scale = scale;
  return launch<DQ_G>(dq_kernel, allowed, {q, k, v, dq, dout, nullptr}, args, B, N, H, D, stream);
}

// dk, dv (B, N, H, D) bf16 from q, k, v, dout, lse and di of
// attention_wide_bwd_dq. Returns a cudaError_t.
extern "C" int attention_wide_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                      const void* di, void* dk, void* dv, int B, int N, int H, int D, float scale,
                                      void* stream) {
  if (bad_shape(B, N, H, D)) return (int)cudaErrorInvalidValue;
  static bool allowed[MAX_DEVICES] = {};
  Args args{};
  args.lse = (const float*)lse;
  args.di = (const float*)di;
  args.scale = scale;
  return launch<DKV_G>(dkv_kernel, allowed, {q, k, v, dk, dout, dv}, args, B, N, H, D, stream);
}
