// Flash-style attention backward for the DINO ViT: dQ, dK, dV in bf16.
//
// Replaces: the backward of the library Pallas TPU flash attention that
// scenedino_tpu/models/vit.py:126 `_flash_mhsa` calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py, custom VJP :204,
// bwd :254): `_flash_attention_bwd_dkv` (:941, kernel :796) and
// `_flash_attention_bwd_dq` (:1287, kernel :1146).
//
// With P = exp(q k^T * scale - lse) (lse from the forward kernel,
// attention.cu), di = rowsum(dO o), dP = dO v^T and
// dS = P (dP - di) * scale:
//   dQ = dS k,   dK = dS^T q,   dV = P^T dO.
// q, k, v, o, dO, dQ, dK, dV are (B, N, H, D) bf16 with D = 64; lse and
// di are (B, H, N) fp32.
//
// Bound on the H100: every product is 2 N^2 D B H FLOP, 22.7 GFLOP at the
// training shape (4, 1921, 12, 64); dq does 3 of them and dkv 4, against
// about 5.9 MB per tensor, so both kernels are bound by operations: the
// tensor cores' rate, and beside it the special-function unit's, which
// computes one exp2 per element of S in either kernel (N^2 B H of them at
// 16 a cycle an SM: two thirds of the cycles of dq's products at their
// peak rate).
//
// What the design does about it (Hopper: wgmma, TMA, mbarriers; the
// primitives are in hopper.cuh):
//   * Two kernels, as in the TPU design, no atomics, so the gradients are
//     the same bits from run to run. attention_bwd_dq owns a tile of query
//     rows, computes di = rowsum(dO o) for them in fp32 (written for the
//     dkv kernel) and walks the key/value tiles; attention_bwd_dkv owns a
//     tile of key rows and walks the query/dO tiles with their lse and di.
//   * A block is WGS consumer warpgroups, each owning 64 rows of the block's
//     own tile, and a producer warpgroup of which one warp works. The two
//     roles part in one if/else and never meet again, so that the producer
//     can hand its registers to the consumers (setmaxnreg): a dkv consumer
//     holds four 64 x 64 fp32 accumulators and six bf16 operands a thread.
//   * All products are wgmma m64n64k16 (bf16 in, fp32 accumulate) with the A
//     operand in registers. The own rows (Q and dO; K and V) are read from
//     their TMA-loaded tiles into A-operand registers once and stay there
//     for the walk. S = Q K^T and dP = dO V^T (dkv: S^T = K Q^T and
//     dP^T = V dO^T, so no transpose is ever needed) come out in registers;
//     the exponent, dS and the rounding to bf16 happen on those registers,
//     and the packed registers are the A operand of the next product
//     (dQ += dS K; dV += P^T dO, dK += dS^T Q), which reads the walked tile
//     a second time with the contraction down its rows (the instruction's
//     transposed-B order). S, dP, P and dS never touch shared memory; dQ
//     (dK, dV) stay in registers for the whole walk. Independent products
//     alternate their k-steps, so that no wgmma accumulates onto the one
//     started just before it.
//   * The producer warp keeps STAGES walked tiles in flight: TMA loads into
//     a ring of 128-byte-swizzled tiles, a full and an empty mbarrier per
//     slot, so the loads of later tiles run under the products of this one.
//     A walked tile serves every warpgroup of the block. In dq the products
//     that end a tile (dQ += dS K) stay in flight under the next tile's
//     first products; the elementwise pass of one warpgroup overlaps the
//     products of the other.
//   * N is a dimension of its own in the tensor maps: the ragged tail
//     (N = 1921 at ViT-B/8 on 192x640) arrives zero-filled and results past
//     N are cut by the TMA store. Zero key rows give S = 0, not P = 0, so
//     the last walked tile's columns past N are masked to P = dS = 0 on the
//     registers (only that tile pays for the mask).
//   * Results leave through the block's own tiles in shared memory (the
//     swizzled layout, free of bank conflicts) as TMA stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// consumer warpgroups per block, slots of the ring, and blocks per SM that
// the registers are divided for (tools/bench_attention_bwd.py times others)
#ifndef BWD_DQ_WGS
#define BWD_DQ_WGS 2
#endif
#ifndef BWD_DQ_STAGES
#define BWD_DQ_STAGES 3
#endif
#ifndef BWD_DQ_BLOCKS
#define BWD_DQ_BLOCKS 1
#endif
#ifndef BWD_DKV_WGS
#define BWD_DKV_WGS 2
#endif
#ifndef BWD_DKV_STAGES
#define BWD_DKV_STAGES 3
#endif
#ifndef BWD_DKV_BLOCKS
#define BWD_DKV_BLOCKS 1
#endif

namespace {

using namespace hopper;

constexpr int D = 64;   // head dim
constexpr int BT = 64;  // rows of a warpgroup's own tile and of each walked tile
constexpr float LOG2E = 1.4426950408889634f;

static_assert(D == TILE && BT == TILE, "the tiles of hopper.cuh are 64 x 64");

template <int WGS, int STAGES>
struct DqSmem {
  alignas(1024) unsigned char q[WGS][TILE_BYTES];     // own; dQ on the way out
  alignas(1024) unsigned char dout[WGS][TILE_BYTES];  // own
  alignas(1024) unsigned char k[STAGES][TILE_BYTES];  // walked
  alignas(1024) unsigned char v[STAGES][TILE_BYTES];  // walked
  float di[WGS][BT];
  uint64_t own, full[STAGES], empty[STAGES];
};

template <int WGS, int STAGES>
struct DkvSmem {
  alignas(1024) unsigned char k[WGS][TILE_BYTES];        // own; dK on the way out
  alignas(1024) unsigned char v[WGS][TILE_BYTES];        // own; dV on the way out
  alignas(1024) unsigned char q[STAGES][TILE_BYTES];     // walked
  alignas(1024) unsigned char dout[STAGES][TILE_BYTES];  // walked
  alignas(8) float lse2[STAGES][BT];                     // walked: lse * log2(e), 0 past N
  alignas(8) float dis[STAGES][BT];                      // walked: di * scale, 0 past N
  uint64_t own, full[STAGES], empty[STAGES];
};

// acc0 = a0 times the transpose of walked tile b0 and acc1 = a1 times that
// of b1 (all 64 x 64; a0, a1: own rows in registers), k-steps alternating
__device__ __forceinline__ void products_nt(float (&acc0)[32], const uint32_t (&a0)[16], uint64_t desc_b0,
                                            float (&acc1)[32], const uint32_t (&a1)[16], uint64_t desc_b1) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_m64n64k16_rs<0>(acc0, &a0[4 * kk], desc_b0 + kk * WGMMA_K_STEP, kk > 0);
    wgmma_m64n64k16_rs<0>(acc1, &a1[4 * kk], desc_b1 + kk * WGMMA_K_STEP, kk > 0);
  }
}

// acc (64 x 64, registers) += A (64 x 64 bf16 in registers) times the walked tile
__device__ __forceinline__ void product_rows(float (&acc)[32], const uint32_t (&a)[16], uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    wgmma_m64n64k16_rs<1>(acc, &a[4 * kk], desc_b + kk * WGMMA_MN_STEP, 1);
  }
}

// the same for two independent products, k-steps alternating
__device__ __forceinline__ void products_rows(float (&acc0)[32], const uint32_t (&a0)[16], uint64_t desc_b0,
                                              float (&acc1)[32], const uint32_t (&a1)[16], uint64_t desc_b1) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    wgmma_m64n64k16_rs<1>(acc0, &a0[4 * kk], desc_b0 + kk * WGMMA_MN_STEP, 1);
    wgmma_m64n64k16_rs<1>(acc1, &a1[4 * kk], desc_b1 + kk * WGMMA_MN_STEP, 1);
  }
}

// ---------------------------------------------------------------------- dq

struct DqArgs {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;
  float* di_out;
  int N, H;
  float scale;
};

// one lane starts every load of the block: its own Q and dO tiles, then the
// K and V tiles into the ring as its slots come free
template <int WGS, int STAGES>
__device__ __forceinline__ void dq_produce(DqSmem<WGS, STAGES>& sm, const CUtensorMap* map_q,
                                           const CUtensorMap* map_k, const CUtensorMap* map_v,
                                           const CUtensorMap* map_dout, int row0, int h, int b, int active,
                                           int tiles) {
  mbar_arrive_expect_tx(&sm.own, active * 2 * TILE_BYTES);
  for (int w = 0; w < active; ++w) {
    tma_load_4d(sm.q[w], map_q, &sm.own, 0, h, row0 + w * BT, b);
    tma_load_4d(sm.dout[w], map_dout, &sm.own, 0, h, row0 + w * BT, b);
  }
  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);  // passes at once in the first round
    mbar_arrive_expect_tx(&sm.full[s], 2 * TILE_BYTES);
    tma_load_4d(sm.k[s], map_k, &sm.full[s], 0, h, t * BT, b);
    tma_load_4d(sm.v[s], map_v, &sm.full[s], 0, h, t * BT, b);
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
template <int WGS, int STAGES>
__device__ __forceinline__ void dq_consume(DqSmem<WGS, STAGES>& sm, const CUtensorMap* map_dq, const DqArgs& a,
                                           int wg, int wg_row0, int h, int b, int tiles) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int N = a.N;
  const size_t bh = (size_t)b * a.H + h;

  // di = rowsum(dO * o) in fp32, two threads per row, 16-byte loads
  {
    const int r = tid / 2;
    const int half = tid % 2;
    const int n = wg_row0 + r;
    float acc = 0.f;
    if (n < N) {
      const size_t at = ((size_t)(b * N + n) * a.H + h) * D + half * (D / 2);
      const uint4* orow = reinterpret_cast<const uint4*>(a.o + at);
      const uint4* drow = reinterpret_cast<const uint4*>(a.dout + at);
#pragma unroll
      for (int i = 0; i < D / 2 / 8; ++i) {
        const uint4 ov = orow[i];
        const uint4 dv = drow[i];
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

  float dq[32], s[32], dp[32];
  uint32_t ds[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  fence_registers(dq);  // zeroed here, not under products in flight

  mbar_wait(&sm.own, 0);
  uint32_t a_q[16], a_do[16];  // the own rows stay in registers for the whole walk
  load_a_operand(a_q, sm.q[wg], warp, lane);
  load_a_operand(a_do, sm.dout[wg], warp, lane);

  for (int t = 0; t < tiles; ++t) {
    const int slot = t % STAGES;
    mbar_wait(&sm.full[slot], (t / STAGES) & 1);
    const uint64_t desc_k = wgmma_desc(sm.k[slot]);
    const uint64_t desc_v = wgmma_desc(sm.v[slot]);

    fence_registers(s);
    fence_registers(dp);
    wgmma_fence();
    products_nt(s, a_q, desc_k, dp, a_do, desc_v);  // S = Q K^T, dP = dO V^T
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

    fence_registers(dq);
    wgmma_fence();
    product_rows(dq, ds, desc_k);  // dQ += dS K, left in flight under the next tile's first products
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_registers(dq);

  named_barrier_sync(1 + wg, 128);  // every warp has read its rows of the Q tile
  store_accumulator(sm.q[wg], dq, warp, lane);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0) {
    tma_store_4d(map_dq, sm.q[wg], 0, h, wg_row0, b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

template <int WGS, int STAGES, int BLOCKS>
__global__ void __launch_bounds__((WGS + 1) * 128, BLOCKS)
attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_dout,
                        const __grid_constant__ CUtensorMap map_dq, const DqArgs args) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem<WGS, STAGES>& sm = aligned_smem<DqSmem<WGS, STAGES>>(smem_raw);
  const int row0 = blockIdx.x * (WGS * BT);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (args.N + BT - 1) / BT;
  const int active = min(WGS, (args.N - row0 + BT - 1) / BT);  // warpgroups with a row below N
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
  if (wg == WGS) {
    registers_release<Registers<WGS, BLOCKS>::PRODUCER>();
    if (threadIdx.x % 128 == 0) dq_produce(sm, &map_q, &map_k, &map_v, &map_dout, row0, h, b, active, tiles);
  } else {
    registers_take<Registers<WGS, BLOCKS>::CONSUMER>();
    if (wg < active) dq_consume(sm, &map_dq, args, wg, row0 + wg * BT, h, b, tiles);
  }
}

// --------------------------------------------------------------------- dkv

struct DkvArgs {
  const float* lse;
  const float* di;
  int N, H;
  float scale;
};

// one warp: lane 0 starts the loads (the block's own K and V tiles, then the
// Q and dO tiles into the ring), every lane brings two rows' lse and di of
// each walked tile, read one tile ahead
template <int WGS, int STAGES>
__device__ __forceinline__ void dkv_produce(DkvSmem<WGS, STAGES>& sm, const CUtensorMap* map_q,
                                            const CUtensorMap* map_k, const CUtensorMap* map_v,
                                            const CUtensorMap* map_dout, const DkvArgs& a, int row0, int h, int b,
                                            int active, int tiles) {
  const int lane = threadIdx.x % 32;
  const int N = a.N;
  if (lane == 0) {
    mbar_arrive_expect_tx(&sm.own, active * 2 * TILE_BYTES);
    for (int w = 0; w < active; ++w) {
      tma_load_4d(sm.k[w], map_k, &sm.own, 0, h, row0 + w * BT, b);
      tma_load_4d(sm.v[w], map_v, &sm.own, 0, h, row0 + w * BT, b);
    }
  }
  const float* lse_bh = a.lse + ((size_t)b * a.H + h) * N;
  const float* di_bh = a.di + ((size_t)b * a.H + h) * N;
  float l[2], d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = lane + 32 * i;
    l[i] = n < N ? lse_bh[n] * LOG2E : 0.f;
    d[i] = n < N ? di_bh[n] * a.scale : 0.f;
  }
  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.full[s], 2 * TILE_BYTES);
      tma_load_4d(sm.q[s], map_q, &sm.full[s], 0, h, t * BT, b);
      tma_load_4d(sm.dout[s], map_dout, &sm.full[s], 0, h, t * BT, b);
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
      l[i] = n < N ? lse_bh[n] * LOG2E : 0.f;
      d[i] = n < N ? di_bh[n] * a.scale : 0.f;
    }
  }
}

// P^T and dS^T on the accumulators' registers, packed to bf16 as the A
// operands of dV += P^T dO and dK += dS^T Q. The statistics belong to the
// columns (query rows) here. MASK: columns at or past `nvalid` give 0.
template <bool MASK>
__device__ __forceinline__ void dkv_elementwise(const float (&st)[32], const float (&dpt)[32], uint32_t (&p)[16],
                                                uint32_t (&ds)[16], const float* lse2, const float* dis, float scale,
                                                float scale_log2, int nvalid, int col0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + col0;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
    const float2 di = *reinterpret_cast<const float2*>(dis + c);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int i = 4 * j + 2 * hi;
      float p0 = fast_exp2(fmaf(st[i], scale_log2, -l2.x));
      float p1 = fast_exp2(fmaf(st[i + 1], scale_log2, -l2.y));
      if (MASK && c >= nvalid) p0 = 0.f;
      if (MASK && c + 1 >= nvalid) p1 = 0.f;
      p[a_index(j, hi)] = pack_bf16(p0, p1);
      ds[a_index(j, hi)] = pack_bf16(p0 * fmaf(dpt[i], scale, -di.x), p1 * fmaf(dpt[i + 1], scale, -di.y));
    }
  }
}

// warpgroup `wg` of the block: dK and dV of its 64 key rows (key rows past N
// compute values that the store cuts)
template <int WGS, int STAGES>
__device__ __forceinline__ void dkv_consume(DkvSmem<WGS, STAGES>& sm, const CUtensorMap* map_dk,
                                            const CUtensorMap* map_dv, const DkvArgs& a, int wg, int wg_row0,
                                            int h, int b, int tiles) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col0 = (lane % 4) * 2;
  const int N = a.N;
  const float scale = a.scale;
  const float scale_log2 = scale * LOG2E;

  float dk[32], dv[32], st[32], dpt[32];
  uint32_t p[16], ds[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  mbar_wait(&sm.own, 0);
  uint32_t a_k[16], a_v[16];  // the own rows stay in registers for the whole walk
  load_a_operand(a_k, sm.k[wg], warp, lane);
  load_a_operand(a_v, sm.v[wg], warp, lane);

  for (int t = 0; t < tiles; ++t) {
    const int slot = t % STAGES;
    mbar_wait(&sm.full[slot], (t / STAGES) & 1);
    const uint64_t desc_q = wgmma_desc(sm.q[slot]);
    const uint64_t desc_do = wgmma_desc(sm.dout[slot]);

    fence_registers(st);
    fence_registers(dpt);
    wgmma_fence();
    products_nt(st, a_k, desc_q, dpt, a_v, desc_do);  // S^T = K Q^T, dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(st);
    fence_registers(dpt);

    const int nvalid = N - t * BT;
    if (nvalid >= BT) {
      dkv_elementwise<false>(st, dpt, p, ds, sm.lse2[slot], sm.dis[slot], scale, scale_log2, nvalid, col0);
    } else {
      dkv_elementwise<true>(st, dpt, p, ds, sm.lse2[slot], sm.dis[slot], scale, scale_log2, nvalid, col0);
    }

    fence_registers(dv);
    fence_registers(dk);
    wgmma_fence();
    products_rows(dv, p, desc_do, dk, ds, desc_q);  // dV += P^T dO, dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&sm.empty[slot]);
  }
  fence_registers(dv);
  fence_registers(dk);

  named_barrier_sync(1 + wg, 128);  // every warp has read its rows of the K and V tiles
  store_accumulator(sm.k[wg], dk, warp, lane);
  store_accumulator(sm.v[wg], dv, warp, lane);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0) {
    tma_store_4d(map_dk, sm.k[wg], 0, h, wg_row0, b);
    tma_store_4d(map_dv, sm.v[wg], 0, h, wg_row0, b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

template <int WGS, int STAGES, int BLOCKS>
__global__ void __launch_bounds__((WGS + 1) * 128, BLOCKS)
attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_dout,
                         const __grid_constant__ CUtensorMap map_dk, const __grid_constant__ CUtensorMap map_dv,
                         const DkvArgs args) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<WGS, STAGES>& sm = aligned_smem<DkvSmem<WGS, STAGES>>(smem_raw);
  const int row0 = blockIdx.x * (WGS * BT);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (args.N + BT - 1) / BT;
  const int active = min(WGS, (args.N - row0 + BT - 1) / BT);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.own, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 33);  // the loads' announcement and each producer lane's statistics
      mbar_init(&sm.empty[s], active * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == WGS) {
    registers_release<Registers<WGS, BLOCKS>::PRODUCER>();
    if (threadIdx.x % 128 < 32) dkv_produce(sm, &map_q, &map_k, &map_v, &map_dout, args, row0, h, b, active, tiles);
  } else {
    registers_take<Registers<WGS, BLOCKS>::CONSUMER>();
    if (wg < active) dkv_consume(sm, &map_dk, &map_dv, args, wg, row0 + wg * BT, h, b, tiles);
  }
}

// ------------------------------------------------------------------ launch

bool bad_shape(int B, int N, int H, int head_dim) {
  return head_dim != D || B <= 0 || N <= 0 || H <= 0;
}

}  // namespace

// q, k, v, o, dout, dq: (B, N, H, D) bf16; lse, di: (B, H, N) fp32; all
// contiguous, 16-byte aligned, on the current device. Writes dq and di.
// Returns a cudaError_t (0 = launched).
extern "C" int attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* dq, void* di, int B,
                                int N, int H, int head_dim, float scale, void* stream) {
  if (bad_shape(B, N, H, head_dim)) return (int)cudaErrorInvalidValue;
  const auto kernel = attention_bwd_dq_kernel<BWD_DQ_WGS, BWD_DQ_STAGES, BWD_DQ_BLOCKS>;
  const int smem = (int)sizeof(DqSmem<BWD_DQ_WGS, BWD_DQ_STAGES>) + 1024;  // room to align the tiles
  static bool allowed[hopper::MAX_DEVICES] = {};
  const cudaError_t err = hopper::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[5];
  const void* const bases[5] = {q, k, v, dout, dq};
  const int bad = hopper::encode_maps(maps, bases, B, N, H);
  if (bad) return bad;
  const dim3 grid((N + BWD_DQ_WGS * BT - 1) / (BWD_DQ_WGS * BT), H, B);
  kernel<<<grid, (BWD_DQ_WGS + 1) * 128, smem, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      DqArgs{(const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)lse, (float*)di, N, H, scale});
  return (int)cudaGetLastError();
}

// q, k, v, dout, dk, dv: (B, N, H, D) bf16; lse, di: (B, H, N) fp32 (di
// from attention_bwd_dq); all contiguous, 16-byte aligned, on the current
// device. Writes dk and dv. Returns a cudaError_t (0 = launched).
extern "C" int attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* di, void* dk, void* dv, int B,
                                 int N, int H, int head_dim, float scale, void* stream) {
  if (bad_shape(B, N, H, head_dim)) return (int)cudaErrorInvalidValue;
  const auto kernel = attention_bwd_dkv_kernel<BWD_DKV_WGS, BWD_DKV_STAGES, BWD_DKV_BLOCKS>;
  const int smem = (int)sizeof(DkvSmem<BWD_DKV_WGS, BWD_DKV_STAGES>) + 1024;
  static bool allowed[hopper::MAX_DEVICES] = {};
  const cudaError_t err = hopper::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[6];
  const void* const bases[6] = {q, k, v, dout, dk, dv};
  const int bad = hopper::encode_maps(maps, bases, B, N, H);
  if (bad) return bad;
  const dim3 grid((N + BWD_DKV_WGS * BT - 1) / (BWD_DKV_WGS * BT), H, B);
  kernel<<<grid, (BWD_DKV_WGS + 1) * 128, smem, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      DkvArgs{(const float*)lse, (const float*)di, N, H, scale});
  return (int)cudaGetLastError();
}
