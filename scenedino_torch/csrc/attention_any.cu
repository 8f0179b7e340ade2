// K1 at every head dim but 64 and 80: softmax(Q K^T / sqrt(D)) V over
// (B, N, H, D) bf16, its log-sum-exp, and the backward's dQ (with di =
// rowsum(dO o)) and dK, dV.
//
// Replaces, at the head dims that attention.cu / attention_bwd.cu (D = 64)
// and attention_d80.cu / attention_d80_bwd.cu (D = 80) do not take, the Pallas
// TPU flash attention reached from scenedino_tpu/models/vit.py:126
// `_flash_mhsa` (jax/experimental/pallas/ops/tpu/flash_attention.py:589
// `_flash_attention_impl`, pallas_call at :758) and its custom VJP,
// `_flash_attention_bwd_dq` (:1287) and `_flash_attention_bwd_dkv` (:941),
// which take any D. A ViT from `vit_overrides` (configs/
// train_synthetic_smoke.yaml: width 64, 2 heads) has D = 32; the JAX
// package's own tests use 8 and 16.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s; 16 exp2 a cycle an SM,
// about 3.9 T a second): the forward does 4 N^2 D B H FLOP and N^2 B H exp2,
// dq 3 products of 2 N^2 D B H and dkv 4, each with N^2 B H exp2, against
// about N D B H bf16 values a tensor. At (2, 1921, 6, 128) the forward's
// products take 0.0229 ms and its exp2 0.0114 ms: operations, the tensor
// cores first. At (2, 1921, 2, 32) the products take 0.0019 ms and the exp2
// 0.0038 ms: at D <= 64 the exp unit is the tighter limit.
//
// Design: attention.cu's and attention_bwd.cu's (D = 64), whose notes say
// more, carried over to a row of M whole 64-column tiles.
//   * Where D % 8 == 0 a row of D columns is M = ceil(D / 64) tiles of 64 bf16
//     under hopper.cuh's 128-byte swizzle. The tensor maps' inner dimension is
//     D and their box 64 columns, so TMA fills the columns past D with zeros
//     on a load and cuts them on a store. The padded widths are 64, 128, 192
//     and 256: one instantiation of each kernel a width, and at 64 columns
//     one for each count of k-steps (below), 21 in all. Where
//     D % 8 != 0 (rows not 16-byte aligned: TMA cannot address them) the
//     wrapper zero-pads the tensors to the next multiple of 8 and cuts the
//     results; the softmax scale is always the true D's.
//   * A block is consumer warpgroups of 64 own rows each and a producer
//     warpgroup of which one warp works; the roles part in one if/else that
//     never rejoins, and setmaxnreg hands the producer's registers to the
//     consumers. The producer TMA-loads the own tiles once and walks the other
//     operand's 64-row tiles through a ring of STAGES slots (a full and an
//     empty mbarrier a slot); one walked tile serves every warpgroup.
//   * Products are wgmma m64n64k16. Those that reduce over the head dim (Q K^T,
//     dO V^T; K Q^T, V dO^T) read K-major, k-step kk at 32 (kk % 4) bytes into
//     tile kk / 4; at D <= 64 they take ceil(D / 16) k-steps only, so there
//     the zero columns cost no product; above 64 they run all 4 M (skipping
//     gained at most 7 % at D = 96 on the H100). The count is a template
//     parameter, not a predicate: with the k-steps past D under a predicate
//     known at run time ptxas turned each into a branch around its wgmma,
//     serialized them (C7519), and in dkv with V a register A operand reused
//     V's registers inside the walk for dS^T, so that from the second walked
//     tile on dP^T took dS^T for V (dK off by up to 1.7; the builds and their
//     SASS: tools/probe_any_registers.py). Those whose N is the head dim (P V,
//     dS K; P^T dO, dS^T Q) run one m64n64k16 a tile and k-step over the
//     walked tile read MN-major: the zero columns of the last tile are their
//     waste (half of P V at D = 32). The own rows are the A operand from
//     registers where they fit beside the accumulators, else from their tiles
//     in shared memory.
//   * Forward: the online softmax of hopper.cuh in base 2 with the exact
//     rescale (the running max moves whenever a row's max grows), S of tile
//     t + 1 issued before O += P V of tile t and the softmax of t + 1 run under
//     that product, the last tile peeled off the loop, the ragged key tail at
//     -inf on the last tile only, the log-sum-exp by one lane a quad.
//   * dq: per 64 query rows, di = rowsum(dO o) in fp32 first; then per walked
//     K/V tile S and dP, dS = P (dP - di) / sqrt(D) in bf16 (key columns past
//     N give 0), and dQ += dS K left in flight under the next tile's products.
//   * dkv: per 64 key rows, walk the 64-row Q/dO tiles with their lse (+inf
//     past N: P = 0) and di. S^T first, P^T = exp2(S^T scale log2(e) - lse
//     log2(e)) packed to bf16; then dV += P^T dO beside dP^T = V dO^T; then
//     dS^T = P^T (dP^T - di) / sqrt(D) from the packed P^T, and dK += dS^T Q in
//     flight under the next tile's S^T. dK and dV are 64 x 64 M fp32 each:
//     to 128 columns one warpgroup holds both; above that two warpgroups of a
//     block share the same 64 keys and each walked Q/dO tile, each holding
//     two column tiles of dK and dV (at M = 3 the second takes tiles 1 and 2
//     and stores tile 2 only) and each forming S^T and dP^T.
//   * The warpgroups a block (one to the configured count) are chosen on the
//     host for the fewest waves of blocks on the card, the smaller count on a
//     tie: the smoke recipe's ViT at 192x640 (2, 1921, 2, 32) has 124 query
//     tiles, which then run as 124 blocks of one warpgroup.
//   * No atomics: two launches give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BT = TILE;                         // rows of an own and of a walked tile
constexpr int MAX_TILES = 4;                     // 256 columns
constexpr uint64_t TILE_DESC = TILE_BYTES >> 4;  // descriptor units from one tile to the next
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Per padded width (M tiles): consumer warpgroups a block, ring slots, and
// whether the own rows are the A operand from registers (else from shared
// memory). dkv: KG key groups of 64 rows, SPLIT column groups of MC tiles
// each (a warpgroup a key group and column group), K and V from shared
// memory.
template <int M>
struct Config {
  static constexpr int FWD_WGS = M == 1 ? 3 : 2;
  static constexpr int FWD_STAGES = M <= 3 ? 3 : 2;
  static constexpr bool FWD_QREG = M <= 2;
  static constexpr int DQ_WGS = M == 4 ? 1 : 2;
  static constexpr int DQ_STAGES = M <= 2 ? 3 : 2;
  static constexpr bool DQ_QREG = M <= 2;
  static constexpr bool DQ_DOREG = M == 1;
  static constexpr int DKV_SPLIT = M <= 2 ? 1 : 2;
  static constexpr int DKV_KG = M <= 2 ? 2 : 1;
  static constexpr int DKV_MC = (M + DKV_SPLIT - 1) / DKV_SPLIT;
  static constexpr int DKV_STAGES = M <= 3 ? 3 : 2;
};

// setmaxnreg's split for WGS consumer warpgroups; a block of one consumer
// warpgroup starts with more registers than a consumer may take, and keeps them
template <int WGS>
__device__ __forceinline__ void producer_registers() {
  if constexpr (WGS > 1) registers_release<Registers<WGS, 1>::PRODUCER>();
}
template <int WGS>
__device__ __forceinline__ void consumer_registers() {
  if constexpr (WGS > 1) registers_take<Registers<WGS, 1>::CONSUMER>();
}

// The A operand of a product that reduces over the head dim: the own rows'
// M tiles as registers (REG) or by the descriptor of their first tile.
template <int M, bool REG>
struct OwnA;

template <int M>
struct OwnA<M, true> {
  uint32_t r[M][16];
  __device__ __forceinline__ void load(const unsigned char (*tiles)[TILE_BYTES], int warp, int lane) {
#pragma unroll
    for (int j = 0; j < M; ++j) load_a_operand(r[j], tiles[j], warp, lane);
  }
  __device__ __forceinline__ void refresh() {}
};

template <int M>
struct OwnA<M, false> {
  uint64_t desc;
  __device__ __forceinline__ void load(const unsigned char (*tiles)[TILE_BYTES], int, int) {
    desc = wgmma_desc(tiles[0]);
  }
  // hides the descriptor's value from the compiler for one walked tile, so
  // that the 4 M k-steps' descriptors are formed where they are used and not
  // held in registers across the walk
  __device__ __forceinline__ void refresh() { asm volatile("" : "+l"(desc)); }
};

// k-step kk (head-dim columns 16 kk to 16 kk + 15) of acc = or += A B^T, B a
// walked row of tiles (its first tile's descriptor) read K-major
template <int M, bool REG>
__device__ __forceinline__ void nt_step(float (&acc)[32], const OwnA<M, REG>& a, uint64_t desc_b, int kk) {
  const uint64_t at = (kk / 4) * TILE_DESC + (kk % 4) * WGMMA_K_STEP;
  if constexpr (REG) {
    wgmma_m64n64k16_rs<0>(acc, &a.r[kk / 4][4 * (kk % 4)], desc_b + at, kk > 0);
  } else {
    wgmma_m64n64k16_ss(acc, a.desc + at, desc_b + at, kk > 0);
  }
}

// acc = A B^T over the head dim's first KS k-steps
template <int KS, int M, bool REG>
__device__ __forceinline__ void product_nt(float (&acc)[32], const OwnA<M, REG>& a, uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) nt_step(acc, a, desc_b, kk);
}

// acc0 = a0 b0^T and acc1 = a1 b1^T over KS k-steps, alternating
template <int KS, int M, bool REG0, bool REG1>
__device__ __forceinline__ void products_nt(float (&acc0)[32], const OwnA<M, REG0>& a0, uint64_t desc_b0,
                                            float (&acc1)[32], const OwnA<M, REG1>& a1, uint64_t desc_b1) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    nt_step(acc0, a0, desc_b0, kk);
    nt_step(acc1, a1, desc_b1, kk);
  }
}

// acc[j] (64 x 64, j < MC) += A (64 x 64 bf16 in registers) times tile j of a
// walked row (its first tile's descriptor) read down its rows; k-step outer,
// so that consecutive products accumulate into different tiles
template <int MC>
__device__ __forceinline__ void product_rows(float (&acc)[MC][32], const uint32_t (&a)[16], uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      wgmma_m64n64k16_rs<1>(acc[j], &a[4 * kk], desc_b + j * TILE_DESC + kk * WGMMA_MN_STEP, 1);
    }
  }
}

template <int MC>
__device__ __forceinline__ void fence_all(float (&acc)[MC][32]) {
#pragma unroll
  for (int j = 0; j < MC; ++j) fence_registers(acc[j]);
}

template <int MC>
__device__ __forceinline__ void zero_all(float (&acc)[MC][32]) {
#pragma unroll
  for (int j = 0; j < MC; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  }
  fence_all(acc);
}

// a warpgroup's accumulator tiles -> bf16 in shared memory (the layout the
// TMA store reads); one thread then stores them at columns 64 (c0 + j)
template <int MC>
__device__ __forceinline__ void stage_tiles(unsigned char (*tiles)[TILE_BYTES], const float (&acc)[MC][32], int first,
                                            int warp, int lane) {
#pragma unroll
  for (int j = 0; j < MC; ++j) {
    if (j >= first) store_accumulator(tiles[j], acc[j], warp, lane);
  }
}

__device__ __forceinline__ void store_tiles(const CUtensorMap* map, unsigned char (*tiles)[TILE_BYTES], int c0,
                                            int count, int first, int row0, int h, int b) {
  for (int j = first; j < count; ++j) tma_store_4d(map, tiles[j], (c0 + j) * TILE, h, row0, b);
}

// ----------------------------------------------------------------- forward

template <int M, int WGS, int STAGES>
struct FwdSmem {
  alignas(1024) unsigned char q[WGS][M][TILE_BYTES];     // own; O on the way out
  alignas(1024) unsigned char k[STAGES][M][TILE_BYTES];  // walked
  alignas(1024) unsigned char v[STAGES][M][TILE_BYTES];  // walked
  uint64_t own, full[STAGES], empty[STAGES];
};

struct FwdMaps {
  CUtensorMap q, k, v, o;
};

struct FwdArgs {
  float* lse;  // null: not written
  int N, H;
  float scale_log2;
};

// one lane starts every load of the block: the active warpgroups' Q tiles,
// then the K and V tiles into the ring as its slots come free
template <int M, int WGS, int STAGES>
__device__ __forceinline__ void fwd_produce(FwdSmem<M, WGS, STAGES>& sm, const FwdMaps& maps, int row0, int h, int b,
                                            int active, int tiles) {
  mbar_arrive_expect_tx(&sm.own, active * M * TILE_BYTES);
  for (int w = 0; w < active; ++w) {
#pragma unroll
    for (int j = 0; j < M; ++j) tma_load_4d(sm.q[w][j], &maps.q, &sm.own, j * TILE, h, row0 + w * BT, b);
  }
  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);  // passes at once in the first round
    mbar_arrive_expect_tx(&sm.full[s], 2 * M * TILE_BYTES);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      tma_load_4d(sm.k[s][j], &maps.k, &sm.full[s], j * TILE, h, t * BT, b);
      tma_load_4d(sm.v[s][j], &maps.v, &sm.full[s], j * TILE, h, t * BT, b);
    }
  }
}

// warpgroup `wg` of the block: O (and the log-sum-exp) of its 64 query rows
template <int M, int KS, int WGS, int STAGES>
__device__ __forceinline__ void fwd_consume(FwdSmem<M, WGS, STAGES>& sm, const FwdMaps& maps, const FwdArgs& a, int wg,
                                            int wg_row0, int h, int b, int tiles) {
  constexpr bool QREG = Config<M>::FWD_QREG;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col0 = (lane % 4) * 2;
  const int N = a.N;
  const float scale_log2 = a.scale_log2;

  float o[M][32], s[32];
  uint32_t p[16];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float alpha[2];
  zero_all(o);  // zeroed here, not under products in flight

  mbar_wait(&sm.own, 0);
  OwnA<M, QREG> aq;
  aq.load(sm.q[wg], warp, lane);

  // S of the next tile is issued before O += P V of this one, and the
  // softmax of the next tile runs while that product is in flight; the last
  // tile is peeled off, so that no commit depends on a branch
  mbar_wait(&sm.full[0], 0);
  fence_registers(s);
  wgmma_fence();
  product_nt<KS>(s, aq, wgmma_desc(sm.k[0][0]));
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(s);
  softmax_tile(0, s, m, l, alpha, scale_log2, N, col0);  // O is 0: nothing to rescale
  pack_p(s, p);
  for (int t = 0; t + 1 < tiles; ++t) {
    const int slot = t % STAGES;
    const int next = (t + 1) % STAGES;
    mbar_wait(&sm.full[next], ((t + 1) / STAGES) & 1);
    aq.refresh();
    fence_registers(s);
    wgmma_fence();
    product_nt<KS>(s, aq, wgmma_desc(sm.k[next][0]));
    wgmma_commit();
    fence_all(o);
    wgmma_fence();
    product_rows(o, p, wgmma_desc(sm.v[slot][0]));
    wgmma_commit();
    wgmma_wait<1>();  // S of the next tile; O += P V still in flight
    fence_registers(s);
    const bool move = softmax_tile(t + 1, s, m, l, alpha, scale_log2, N, col0);
    wgmma_wait<0>();
    fence_all(o);
    if (lane == 0) mbar_arrive(&sm.empty[slot]);
    if (move) {
#pragma unroll
      for (int j = 0; j < M; ++j) rescale(o[j], alpha);
    }
    pack_p(s, p);
  }
  fence_all(o);
  wgmma_fence();
  product_rows(o, p, wgmma_desc(sm.v[(tiles - 1) % STAGES][0]));
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(o);

  const int row_lo = warp * 16 + lane / 4;
  float inv[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
    inv[hi] = 1.f / l[hi];
    const int n = wg_row0 + row_lo + 8 * hi;
    if (a.lse != nullptr && lane % 4 == 0 && n < N) {
      a.lse[((size_t)b * a.H + h) * N + n] = (m[hi] + log2f(l[hi])) * LN2;
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) rescale(o[j], inv);

  named_barrier_sync(1 + wg, 128);  // every warp is done with the Q tiles
  stage_tiles(sm.q[wg], o, 0, warp, lane);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0) {
    store_tiles(&maps.o, sm.q[wg], 0, M, 0, wg_row0, h, b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

// `wgs` (<= WGS) consumer warpgroups a block: the block is (wgs + 1) * 128 threads
template <int M, int KS, int WGS, int STAGES>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
fwd_kernel(const __grid_constant__ FwdMaps maps, const FwdArgs args, int wgs) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<M, WGS, STAGES>& sm = aligned_smem<FwdSmem<M, WGS, STAGES>>(smem_raw);
  const int row0 = blockIdx.x * (wgs * BT);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (args.N + BT - 1) / BT;
  // warpgroups with a row below N; the others take no part, so the empty
  // barriers count only these
  const int active = min(wgs, (args.N - row0 + BT - 1) / BT);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.own, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], active * 4);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the two roles never meet again: ptxas then gives each its own registers
  if (wg == wgs) {
    producer_registers<WGS>();
    if (threadIdx.x % 128 == 0) fwd_produce(sm, maps, row0, h, b, active, tiles);
  } else {
    consumer_registers<WGS>();
    if (wg < active) fwd_consume<M, KS>(sm, maps, args, wg, row0 + wg * BT, h, b, tiles);
  }
}

// ---------------------------------------------------------------------- dq

template <int M, int WGS, int STAGES>
struct DqSmem {
  alignas(1024) unsigned char q[WGS][M][TILE_BYTES];     // own; dQ on the way out
  alignas(1024) unsigned char dout[WGS][M][TILE_BYTES];  // own
  alignas(1024) unsigned char k[STAGES][M][TILE_BYTES];  // walked
  alignas(1024) unsigned char v[STAGES][M][TILE_BYTES];  // walked
  float di[WGS][BT];
  uint64_t own, full[STAGES], empty[STAGES];
};

struct DqMaps {
  CUtensorMap q, k, v, dout, dq;
};

struct DqArgs {
  const bf16* o;
  const bf16* dout;
  const float* lse;
  float* di_out;
  int N, H, D;
  float scale;
};

// one lane starts every load of the block: the own Q and dO tiles, then the
// K and V tiles into the ring as its slots come free
template <int M, int WGS, int STAGES>
__device__ __forceinline__ void dq_produce(DqSmem<M, WGS, STAGES>& sm, const DqMaps& maps, int row0, int h, int b,
                                           int active, int tiles) {
  mbar_arrive_expect_tx(&sm.own, active * 2 * M * TILE_BYTES);
  for (int w = 0; w < active; ++w) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      tma_load_4d(sm.q[w][j], &maps.q, &sm.own, j * TILE, h, row0 + w * BT, b);
      tma_load_4d(sm.dout[w][j], &maps.dout, &sm.own, j * TILE, h, row0 + w * BT, b);
    }
  }
  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);
    mbar_arrive_expect_tx(&sm.full[s], 2 * M * TILE_BYTES);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      tma_load_4d(sm.k[s][j], &maps.k, &sm.full[s], j * TILE, h, t * BT, b);
      tma_load_4d(sm.v[s][j], &maps.v, &sm.full[s], j * TILE, h, t * BT, b);
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

// warpgroup `wg` of the block: dQ of its 64 query rows
template <int M, int KS, int WGS, int STAGES>
__device__ __forceinline__ void dq_consume(DqSmem<M, WGS, STAGES>& sm, const DqMaps& maps, const DqArgs& a, int wg,
                                           int wg_row0, int h, int b, int tiles) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int N = a.N;
  const size_t bh = (size_t)b * a.H + h;

  // di = rowsum(dO * o) in fp32, two threads a row, 16-byte loads
  {
    const int r = tid / 2;
    const int half = tid % 2;
    const int n = wg_row0 + r;
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
      sm.di[wg][r] = acc;
      if (n < N) a.di_out[bh * N + n] = acc;
    }
  }
  named_barrier_sync(1 + wg, 128);

  // the thread's two rows of the accumulators: row_lo and row_lo + 8
  const int row_lo = warp * 16 + lane / 4;
  const int col0 = (lane % 4) * 2;
  const float scale = a.scale;
  const float scale_log2 = scale * LOG2E;
  float dis_r[2], lse2_r[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int n = wg_row0 + row_lo + hi * 8;
    dis_r[hi] = sm.di[wg][row_lo + hi * 8] * scale;
    lse2_r[hi] = n < N ? a.lse[bh * N + n] * LOG2E : 0.f;  // rows past N: q = dO = 0, so dS = 0
  }

  float dq[M][32], s[32], dp[32];
  uint32_t ds[16];
  zero_all(dq);

  mbar_wait(&sm.own, 0);
  OwnA<M, Config<M>::DQ_QREG> aq;
  OwnA<M, Config<M>::DQ_DOREG> ado;
  aq.load(sm.q[wg], warp, lane);
  ado.load(sm.dout[wg], warp, lane);

  for (int t = 0; t < tiles; ++t) {
    const int slot = t % STAGES;
    mbar_wait(&sm.full[slot], (t / STAGES) & 1);
    const uint64_t desc_k = wgmma_desc(sm.k[slot][0]);
    const uint64_t desc_v = wgmma_desc(sm.v[slot][0]);
    aq.refresh();
    ado.refresh();

    fence_registers(s);
    fence_registers(dp);
    wgmma_fence();
    products_nt<KS>(s, aq, desc_k, dp, ado, desc_v);  // S = Q K^T, dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();  // and the previous tile's dQ += dS K
    fence_registers(s);
    fence_registers(dp);
    if (t > 0 && lane == 0) mbar_arrive(&sm.empty[(t - 1) % STAGES]);

    const int nvalid = N - t * BT;  // columns of this tile below N
    if (nvalid >= BT) {
      dq_elementwise<false>(s, dp, ds, lse2_r, dis_r, scale, scale_log2, nvalid, col0);
    } else {
      dq_elementwise<true>(s, dp, ds, lse2_r, dis_r, scale, scale_log2, nvalid, col0);
    }

    fence_all(dq);
    wgmma_fence();
    product_rows(dq, ds, desc_k);  // dQ += dS K, left in flight under the next tile's first products
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_all(dq);

  named_barrier_sync(1 + wg, 128);  // every warp is done with the Q and dO tiles
  stage_tiles(sm.q[wg], dq, 0, warp, lane);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0) {
    store_tiles(&maps.dq, sm.q[wg], 0, M, 0, wg_row0, h, b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

template <int M, int KS, int WGS, int STAGES>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
dq_kernel(const __grid_constant__ DqMaps maps, const DqArgs args, int wgs) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem<M, WGS, STAGES>& sm = aligned_smem<DqSmem<M, WGS, STAGES>>(smem_raw);
  const int row0 = blockIdx.x * (wgs * BT);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (args.N + BT - 1) / BT;
  const int active = min(wgs, (args.N - row0 + BT - 1) / BT);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.own, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], active * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == wgs) {
    producer_registers<WGS>();
    if (threadIdx.x % 128 == 0) dq_produce(sm, maps, row0, h, b, active, tiles);
  } else {
    consumer_registers<WGS>();
    if (wg < active) dq_consume<M, KS>(sm, maps, args, wg, row0 + wg * BT, h, b, tiles);
  }
}

// --------------------------------------------------------------------- dkv

template <int M, int KG, int STAGES>
struct DkvSmem {
  alignas(1024) unsigned char k[KG][M][TILE_BYTES];         // own; dK on the way out
  alignas(1024) unsigned char v[KG][M][TILE_BYTES];         // own; dV on the way out
  alignas(1024) unsigned char q[STAGES][M][TILE_BYTES];     // walked
  alignas(1024) unsigned char dout[STAGES][M][TILE_BYTES];  // walked
  alignas(8) float lse2[STAGES][BT];                        // walked: lse * log2(e), +inf past N
  alignas(8) float dis[STAGES][BT];                         // walked: di * scale, 0 past N
  uint64_t own, full[STAGES], empty[STAGES];
};

struct DkvMaps {
  CUtensorMap q, k, v, dout, dk, dv;
};

struct DkvArgs {
  const float* lse;
  const float* di;
  int N, H;
  float scale;
};

// one warp: lane 0 starts the loads (the own K and V tiles, then the Q and dO
// tiles into the ring), every lane brings two rows' lse and di of each
// walked tile, read one tile ahead
template <int M, int KG, int STAGES>
__device__ __forceinline__ void dkv_produce(DkvSmem<M, KG, STAGES>& sm, const DkvMaps& maps, const DkvArgs& a,
                                            int row0, int h, int b, int active_kg, int tiles) {
  const int lane = threadIdx.x % 32;
  const int N = a.N;
  if (lane == 0) {
    mbar_arrive_expect_tx(&sm.own, active_kg * 2 * M * TILE_BYTES);
    for (int w = 0; w < active_kg; ++w) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        tma_load_4d(sm.k[w][j], &maps.k, &sm.own, j * TILE, h, row0 + w * BT, b);
        tma_load_4d(sm.v[w][j], &maps.v, &sm.own, j * TILE, h, row0 + w * BT, b);
      }
    }
  }
  const float* lse_bh = a.lse + ((size_t)b * a.H + h) * N;
  const float* di_bh = a.di + ((size_t)b * a.H + h) * N;
  float l[2], d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = lane + 32 * i;
    l[i] = n < N ? lse_bh[n] * LOG2E : INFINITY;
    d[i] = n < N ? di_bh[n] * a.scale : 0.f;
  }
  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.full[s], 2 * M * TILE_BYTES);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        tma_load_4d(sm.q[s][j], &maps.q, &sm.full[s], j * TILE, h, t * BT, b);
        tma_load_4d(sm.dout[s][j], &maps.dout, &sm.full[s], j * TILE, h, t * BT, b);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sm.lse2[s][lane + 32 * i] = l[i];
      sm.dis[s][lane + 32 * i] = d[i];
    }
    mbar_arrive(&sm.full[s]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the next tile's, read while its slot is awaited
      const int n = (t + 1) * BT + lane + 32 * i;
      l[i] = n < N ? lse_bh[n] * LOG2E : INFINITY;
      d[i] = n < N ? di_bh[n] * a.scale : 0.f;
    }
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

// warpgroup (kg, cg) of the block: of the 64 key rows of key group kg, the
// MC column tiles of dK and dV from tile c0 = cg (M - MC) on (key rows past N
// compute values that the store cuts)
template <int M, int KS, int KG, int STAGES>
__device__ __forceinline__ void dkv_consume(DkvSmem<M, KG, STAGES>& sm, const DkvMaps& maps, const DkvArgs& a,
                                            int kg, int cg, int kg_row0, int h, int b, int tiles) {
  using C = Config<M>;
  constexpr int SPLIT = C::DKV_SPLIT;
  constexpr int MC = C::DKV_MC;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col0 = (lane % 4) * 2;
  const float scale = a.scale;
  const float scale_log2 = scale * LOG2E;
  const int c0 = cg * (M - MC);  // the first column tile of this warpgroup
  const int first = cg * MC - c0;  // its tiles below this one are the other group's to store

  float dk[MC][32], dv[MC][32], st[32], dpt[32];
  uint32_t p[16], ds[16];
  zero_all(dk);
  zero_all(dv);

  mbar_wait(&sm.own, 0);
  OwnA<M, false> ak, av;
  ak.load(sm.k[kg], warp, lane);
  av.load(sm.v[kg], warp, lane);

  for (int t = 0; t < tiles; ++t) {
    const int slot = t % STAGES;
    mbar_wait(&sm.full[slot], (t / STAGES) & 1);
    const uint64_t desc_q = wgmma_desc(sm.q[slot][0]);
    const uint64_t desc_do = wgmma_desc(sm.dout[slot][0]);
    ak.refresh();
    av.refresh();

    fence_registers(st);
    wgmma_fence();
    product_nt<KS>(st, ak, desc_q);  // S^T = K Q^T
    wgmma_commit();
    wgmma_wait<0>();  // and the previous tile's dK += dS^T Q
    fence_registers(st);
    if (t > 0 && lane == 0) mbar_arrive(&sm.empty[(t - 1) % STAGES]);
    dkv_probabilities(st, p, sm.lse2[slot], scale_log2, col0);

    fence_all(dv);
    fence_registers(dpt);
    wgmma_fence();
    product_rows(dv, p, desc_do + c0 * TILE_DESC);  // dV += P^T dO
    product_nt<KS>(dpt, av, desc_do);                // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dv);
    fence_registers(dpt);
    dkv_scores_grad(p, dpt, ds, sm.dis[slot], scale, col0);

    fence_all(dk);
    wgmma_fence();
    product_rows(dk, ds, desc_q + c0 * TILE_DESC);  // dK += dS^T Q, left in flight under the next S^T
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_all(dk);

  // the key group's warpgroups are done with its own K and V tiles
  named_barrier_sync(1 + kg, SPLIT * 128);
  stage_tiles(sm.k[kg] + c0, dk, first, warp, lane);
  stage_tiles(sm.v[kg] + c0, dv, first, warp, lane);
  fence_proxy_async();
  named_barrier_sync(1 + kg, SPLIT * 128);
  if (tid == 0) {
    store_tiles(&maps.dk, sm.k[kg] + c0, c0, MC, first, kg_row0, h, b);
    store_tiles(&maps.dv, sm.v[kg] + c0, c0, MC, first, kg_row0, h, b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

// `kgs` (<= KG) key groups a block: (kgs SPLIT + 1) * 128 threads
template <int M, int KS, int KG, int STAGES>
__global__ void __launch_bounds__((KG * Config<M>::DKV_SPLIT + 1) * 128, 1)
dkv_kernel(const __grid_constant__ DkvMaps maps, const DkvArgs args, int kgs) {
  constexpr int SPLIT = Config<M>::DKV_SPLIT;
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<M, KG, STAGES>& sm = aligned_smem<DkvSmem<M, KG, STAGES>>(smem_raw);
  const int row0 = blockIdx.x * (kgs * BT);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (args.N + BT - 1) / BT;
  const int active_kg = min(kgs, (args.N - row0 + BT - 1) / BT);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.own, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 33);  // the loads' announcement and each producer lane's statistics
      mbar_init(&sm.empty[s], active_kg * SPLIT * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kgs * SPLIT) {
    producer_registers<KG * SPLIT>();
    if (threadIdx.x % 128 < 32) dkv_produce(sm, maps, args, row0, h, b, active_kg, tiles);
  } else {
    consumer_registers<KG * SPLIT>();
    const int kg = wg / SPLIT;
    if (kg < active_kg) dkv_consume<M, KS>(sm, maps, args, kg, wg % SPLIT, row0 + kg * BT, h, b, tiles);
  }
}

// ------------------------------------------------------------------ host

// the shapes the kernels take: D % 8 == 0 (16-byte rows), D <= 256; the grid's
// y and z are H and B
bool bad_shape(int B, int N, int H, int D) {
  return B <= 0 || N <= 0 || H <= 0 || D <= 0 || D % 8 != 0 || D > MAX_TILES * TILE || B > 65535 || H > 65535;
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<M>, Int<KS>) at D's tiles M = ceil(D / 64) and the k-steps KS of
// the products over the head dim: ceil(D / 16) in one tile, all 4 M above
template <class F>
int at_width(int D, F f) {
  switch ((D + 15) / 16) {
    case 1: return f(Int<1>{}, Int<1>{});
    case 2: return f(Int<1>{}, Int<2>{});
    case 3: return f(Int<1>{}, Int<3>{});
    case 4: return f(Int<1>{}, Int<4>{});
  }
  switch ((D + TILE - 1) / TILE) {
    case 2: return f(Int<2>{}, Int<8>{});
    case 3: return f(Int<3>{}, Int<12>{});
    case 4: return f(Int<4>{}, Int<16>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// the current device's multiprocessors, asked once per device
cudaError_t multiprocessors(int* count) {
  static int known[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (known[dev] == 0) {
    err = cudaDeviceGetAttribute(&known[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *count = known[dev];
  return cudaSuccess;
}

// Groups of 64 own rows a block (a block is groups * split consumer
// warpgroups and a producer): of 1 to `most`, the one whose grid takes the
// fewest waves of blocks on the card, the smaller on a tie (more blocks, so
// more of the SMs busy); `occupancy` keeps the kernel's blocks an SM at each
// group count. Writes the groups and the blocks along the rows.
template <class Kernel>
cudaError_t groups_per_block(Kernel kernel, int most, int split, int smem, int N, int H, int B,
                             int (&occupancy)[MAX_DEVICES][MAX_TILES], int* groups, int* blocks) {
  const int tiles = (N + BT - 1) / BT;
  int sms = 0, dev = 0;
  cudaError_t err = multiprocessors(&sms);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int best = most;
  long long fewest = -1;
  for (int g = most; g >= 1; --g) {
    int& per_sm = occupancy[dev][g - 1];
    if (per_sm == 0) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, (g * split + 1) * 128, smem);
      if (err != cudaSuccess) return err;
      if (per_sm == 0) per_sm = -1;  // does not fit: not taken
    }
    if (per_sm < 0) continue;
    const long long slots = (long long)sms * per_sm;
    const long long waves = ((long long)(tiles + g - 1) / g * H * B + slots - 1) / slots;
    if (fewest < 0 || waves <= fewest) {
      fewest = waves;
      best = g;
    }
  }
  *groups = best;
  *blocks = (tiles + best - 1) / best;
  return cudaSuccess;
}

// the map of a (B, N, H, D) bf16 tensor's 64-row, 64-column boxes (columns
// past D zero on a load, cut on a store)
int encode(CUtensorMap* map, const void* base, int B, int N, int H, int D) {
  return encode_head_box_map(map, base, B, N, H, D, TILE, BT, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <class Smem, class Kernel>
int prepare(Kernel kernel, bool (&allowed)[MAX_DEVICES]) {
  static_assert(sizeof(Smem) + 1024 <= 232448, "a block's shared memory fits an SM");
  return (int)allow_smem(kernel, (int)sizeof(Smem) + 1024, allowed);
}

}  // namespace

// q, k, v, out: (B, N, H, D) bf16, contiguous, 16-byte aligned, on the
// current device, D % 8 == 0, D <= 256; lse: (B, H, N) fp32 or null (not
// written); scale: the softmax scale. Returns a cudaError_t (0 = launched).
extern "C" int attention_any_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int N,
                                 int H, int D, float scale, void* stream) {
  if (bad_shape(B, N, H, D)) return (int)cudaErrorInvalidValue;
  return at_width(D, [&](auto width, auto ksteps) {
    constexpr int M = decltype(width)::value;
    constexpr int KS = decltype(ksteps)::value;
    using C = Config<M>;
    using Smem = FwdSmem<M, C::FWD_WGS, C::FWD_STAGES>;
    const auto kernel = fwd_kernel<M, KS, C::FWD_WGS, C::FWD_STAGES>;
    static bool allowed[MAX_DEVICES] = {};
    int err = prepare<Smem>(kernel, allowed);
    if (err) return err;
    FwdMaps maps;
    err = encode(&maps.q, q, B, N, H, D);
    if (!err) err = encode(&maps.k, k, B, N, H, D);
    if (!err) err = encode(&maps.v, v, B, N, H, D);
    if (!err) err = encode(&maps.o, out, B, N, H, D);
    if (err) return err;
    static int occupancy[MAX_DEVICES][MAX_TILES] = {};
    int wgs = 0, blocks = 0;
    err = (int)groups_per_block(kernel, C::FWD_WGS, 1, sizeof(Smem) + 1024, N, H, B, occupancy, &wgs, &blocks);
    if (err) return err;
    kernel<<<dim3(blocks, H, B), (wgs + 1) * 128, sizeof(Smem) + 1024, (cudaStream_t)stream>>>(
        maps, FwdArgs{(float*)lse, N, H, scale * LOG2E}, wgs);
    return (int)cudaGetLastError();
  });
}

// dq (B, N, H, D) bf16 and di (B, H, N) fp32 from q, k, v, o, dout (as the
// forward's) and lse (B, H, N) fp32. Returns a cudaError_t.
extern "C" int attention_any_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                    const void* lse, void* dq, void* di, int B, int N, int H, int D, float scale,
                                    void* stream) {
  if (bad_shape(B, N, H, D)) return (int)cudaErrorInvalidValue;
  return at_width(D, [&](auto width, auto ksteps) {
    constexpr int M = decltype(width)::value;
    constexpr int KS = decltype(ksteps)::value;
    using C = Config<M>;
    using Smem = DqSmem<M, C::DQ_WGS, C::DQ_STAGES>;
    const auto kernel = dq_kernel<M, KS, C::DQ_WGS, C::DQ_STAGES>;
    static bool allowed[MAX_DEVICES] = {};
    int err = prepare<Smem>(kernel, allowed);
    if (err) return err;
    DqMaps maps;
    err = encode(&maps.q, q, B, N, H, D);
    if (!err) err = encode(&maps.k, k, B, N, H, D);
    if (!err) err = encode(&maps.v, v, B, N, H, D);
    if (!err) err = encode(&maps.dout, dout, B, N, H, D);
    if (!err) err = encode(&maps.dq, dq, B, N, H, D);
    if (err) return err;
    static int occupancy[MAX_DEVICES][MAX_TILES] = {};
    int wgs = 0, blocks = 0;
    err = (int)groups_per_block(kernel, C::DQ_WGS, 1, sizeof(Smem) + 1024, N, H, B, occupancy, &wgs, &blocks);
    if (err) return err;
    kernel<<<dim3(blocks, H, B), (wgs + 1) * 128, sizeof(Smem) + 1024, (cudaStream_t)stream>>>(
        maps, DqArgs{(const bf16*)o, (const bf16*)dout, (const float*)lse, (float*)di, N, H, D, scale}, wgs);
    return (int)cudaGetLastError();
  });
}

// dk, dv (B, N, H, D) bf16 from q, k, v, dout, lse and di of
// attention_any_bwd_dq. Returns a cudaError_t.
extern "C" int attention_any_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                     const void* di, void* dk, void* dv, int B, int N, int H, int D, float scale,
                                     void* stream) {
  if (bad_shape(B, N, H, D)) return (int)cudaErrorInvalidValue;
  return at_width(D, [&](auto width, auto ksteps) {
    constexpr int M = decltype(width)::value;
    constexpr int KS = decltype(ksteps)::value;
    using C = Config<M>;
    using Smem = DkvSmem<M, C::DKV_KG, C::DKV_STAGES>;
    const auto kernel = dkv_kernel<M, KS, C::DKV_KG, C::DKV_STAGES>;
    static bool allowed[MAX_DEVICES] = {};
    int err = prepare<Smem>(kernel, allowed);
    if (err) return err;
    DkvMaps maps;
    err = encode(&maps.q, q, B, N, H, D);
    if (!err) err = encode(&maps.k, k, B, N, H, D);
    if (!err) err = encode(&maps.v, v, B, N, H, D);
    if (!err) err = encode(&maps.dout, dout, B, N, H, D);
    if (!err) err = encode(&maps.dk, dk, B, N, H, D);
    if (!err) err = encode(&maps.dv, dv, B, N, H, D);
    if (err) return err;
    static int occupancy[MAX_DEVICES][MAX_TILES] = {};
    int kgs = 0, blocks = 0;
    err = (int)groups_per_block(kernel, C::DKV_KG, C::DKV_SPLIT, sizeof(Smem) + 1024, N, H, B, occupancy, &kgs,
                                &blocks);
    if (err) return err;
    kernel<<<dim3(blocks, H, B), (kgs * C::DKV_SPLIT + 1) * 128, sizeof(Smem) + 1024, (cudaStream_t)stream>>>(
        maps, DkvArgs{(const float*)lse, (const float*)di, N, H, scale}, kgs);
    return (int)cudaGetLastError();
  });
}
