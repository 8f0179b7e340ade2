// Flash-style attention backward at head dim 80 (the I-JEPA-H/14 backbone:
// 16 heads of 80): dQ, dK, dV in bf16.
//
// Replaces, at D = 80: the backward of the library Pallas TPU flash
// attention that scenedino_tpu/models/vit.py:126 `_flash_mhsa` calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py, custom VJP :204):
// `_flash_attention_bwd_dq` (:1287, kernel :1146) and
// `_flash_attention_bwd_dkv` (:941, kernel :796).
//
// With P = exp(q k^T * scale - lse) (lse, natural log, from the D = 80
// forward in attention_d80.cu), di = rowsum(dO o), dP = dO v^T and
// dS = P (dP - di) * scale:
//   dQ = dS k,   dK = dS^T q,   dV = P^T dO.
// q, k, v, o, dO, dQ, dK, dV are (B, N, H, 80) bf16; lse and di are
// (B, H, N) fp32.
//
// Bound on the H100: every product is 2 N^2 D B H FLOP, 14.2 GFLOP at the
// D = 80 training step's student (2, 1921, 12, 80); dq does 3 of them and
// dkv 4, against about 3.7 MB per tensor, so both kernels are bound by the
// tensor cores' rate (at 585 tokens and one image, by the bytes).
//
// The design is attention_bwd.cu's (D = 64), whose note says more; what
// follows is what a row of 80 changes. hopper.cuh's tile is 64 x 64 bf16
// under the 128-byte swizzle, and a row of 80 (160 bytes) does not fit it.
// Padding every tile to 128 columns would waste 37.5 % of the products whose
// N is the head dim, so each own or walked tile is two TMA boxes instead:
//   * columns 0-63, a standard tile (128-byte swizzle, `wgmma_desc`);
//   * columns 64-79, a 16-column side tile of 32-byte rows under the 32-byte
//     swizzle (`wgmma_desc_b32`, hopper.cuh).
// The products that reduce over D (S = Q K^T, dP = dO V^T; in dkv
// S^T = K Q^T, dP^T = V dO^T) take four k-steps on the main tiles and a
// fifth on the side tiles. The products whose N is D (dQ += dS K,
// dV += P^T dO, dK += dS^T Q) are wgmma m64n64k16 on the main tile and
// m64n16k16 on the side tile, both with the transposed B: a 64 x 80 fp32
// accumulator in 32 + 8 registers a thread. No product is wasted.
//   * Two kernels and no atomics, so the gradients are the same bits from
//     run to run. attention_d80_bwd_dq owns query rows, writes di for the
//     dkv kernel and walks 64-row key/value tiles; attention_d80_bwd_dkv owns
//     key rows and walks query/dO tiles of BWD80_DKV_QT rows with their lse
//     and di.
//   * A block is WGS consumer warpgroups, each owning 64 rows held as
//     A-operand registers (16 + 4 a thread per tensor), and a producer warp
//     that keeps STAGES walked tiles in flight through TMA (a full and an
//     empty mbarrier per slot). The roles part in one if/else that never
//     rejoins, and setmaxnreg hands the producer's registers to the
//     consumers: a dkv consumer at 64-row query tiles holds S^T and dP^T
//     (32 + 32), dK and dV (40 + 40), K and V (20 + 20), P and dS (16 + 16).
//     A 32-row query tile (m64n32k16 for S^T and dP^T) halves the first and
//     last of those; tools/bench_attention_bwd.py --head-dim 80 times both
//     (the 64-row tile is the faster on the H100: PERF.md, section 6).
//   * dq leaves dQ += dS K in flight under the next tile's first products,
//     as attention_bwd.cu does. dkv waits for dV and dK before the next
//     tile: keeping them in flight keeps P and dS live beside the next S^T
//     and dP^T, and at 64-row query tiles ptxas then serializes the wgmmas
//     (C7512), which made that version slower.
//   * S, dP, P and dS never touch shared memory; the exponent and dS happen
//     on the accumulators' registers and the packed registers are the A
//     operand of the next product. Independent products alternate their
//     k-steps. Results leave through the own tiles' shared memory (the
//     swizzled layouts) as two TMA stores each.
//   * The ragged tail: N is a dimension of the tensor maps, so rows past N
//     arrive as zeros and the TMA stores cut results past N. Zero key rows
//     give S = 0, not P = 0: dq masks the last walked tile's columns past N
//     (only that tile pays). In dkv a query row past N has lse = +inf and
//     di = 0, so its P and dS are 0 without a mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// consumer warpgroups per block, slots of the ring, blocks per SM that the
// registers are divided for, and (dkv) rows of a walked query tile
// (tools/bench_attention_bwd.py --head-dim 80 --variants times others)
#ifndef BWD80_DQ_WGS
#define BWD80_DQ_WGS 2
#endif
#ifndef BWD80_DQ_STAGES
#define BWD80_DQ_STAGES 3
#endif
#ifndef BWD80_DQ_BLOCKS
#define BWD80_DQ_BLOCKS 1
#endif
#ifndef BWD80_DKV_WGS
#define BWD80_DKV_WGS 2
#endif
#ifndef BWD80_DKV_STAGES
#define BWD80_DKV_STAGES 3
#endif
#ifndef BWD80_DKV_BLOCKS
#define BWD80_DKV_BLOCKS 1
#endif
#ifndef BWD80_DKV_QT
#define BWD80_DKV_QT 64
#endif

namespace {

using namespace hopper;

constexpr int D = ROW80;  // head dim
constexpr int BT = TILE;  // rows of a warpgroup's own tile and of dq's walked tile
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BWD80_DKV_QT == 32 || BWD80_DKV_QT == 64, "dkv walks query tiles of 32 or 64 rows");

// Rows80, MapPair, load_rows / store_rows, OwnRows / load_own, Acc80,
// product_rows80, store_acc80 and encode_pair are hopper.cuh's, shared with
// the forward (attention_d80.cu).

// one k-step of acc (64 x 64 or 64 x 32: NA = 32 or 16) += A times B^T, B K-major
template <int NA>
__device__ __forceinline__ void mma_nt(float (&acc)[NA], const uint32_t* a, uint64_t desc_b, int accumulate) {
  if constexpr (NA == 32) {
    wgmma_m64n64k16_rs<0>(acc, a, desc_b, accumulate);
  } else {
    static_assert(NA == 16, "S^T and dP^T are 64 x 64 or 64 x 32");
    wgmma_m64n32k16_rs<0>(acc, a, desc_b, accumulate);
  }
}

// acc0 = a0 b0^T and acc1 = a1 b1^T over the 80 columns (a0, a1: own rows in
// registers; b0, b1: walked tiles by their main and side descriptors),
// k-steps alternating
template <int NA>
__device__ __forceinline__ void products_nt(float (&acc0)[NA], const OwnRows& a0, uint64_t main0, uint64_t side0,
                                            float (&acc1)[NA], const OwnRows& a1, uint64_t main1, uint64_t side1) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    mma_nt(acc0, &a0.main[4 * kk], main0 + kk * WGMMA_K_STEP, kk > 0);
    mma_nt(acc1, &a1.main[4 * kk], main1 + kk * WGMMA_K_STEP, kk > 0);
  }
  mma_nt(acc0, a0.side, side0, 1);
  mma_nt(acc1, a1.side, side1, 1);
}

// acc0 += a0 times walked tile 0 and acc1 += a1 times walked tile 1, both
// read down their rows (product_rows80 twice), k-steps alternating
template <int KSTEPS>
__device__ __forceinline__ void products_rows(Acc80& acc0, const uint32_t* a0, uint64_t main0, uint64_t side0,
                                              Acc80& acc1, const uint32_t* a1, uint64_t main1, uint64_t side1) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    wgmma_m64n64k16_rs<1>(acc0.main, &a0[4 * kk], main0 + kk * WGMMA_MN_STEP, 1);
    wgmma_m64n64k16_rs<1>(acc1.main, &a1[4 * kk], main1 + kk * WGMMA_MN_STEP, 1);
    wgmma_m64n16k16_rs<1>(acc0.side, &a0[4 * kk], side0 + kk * WGMMA_B32_MN_STEP, 1);
    wgmma_m64n16k16_rs<1>(acc1.side, &a1[4 * kk], side1 + kk * WGMMA_B32_MN_STEP, 1);
  }
}

// ---------------------------------------------------------------------- dq

template <int WGS, int STAGES>
struct DqSmem {
  Rows80<BT> q[WGS];        // own; dQ on the way out
  Rows80<BT> dout[WGS];     // own
  Rows80<BT> k[STAGES];     // walked
  Rows80<BT> v[STAGES];     // walked
  float di[WGS][BT];
  uint64_t own, full[STAGES], empty[STAGES];
};

struct DqMaps {
  MapPair q, k, v, dout, dq;
};

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
__device__ __forceinline__ void dq_produce(DqSmem<WGS, STAGES>& sm, const DqMaps& maps, int row0, int h, int b,
                                           int active, int tiles) {
  mbar_arrive_expect_tx(&sm.own, active * 2 * Rows80<BT>::BYTES);
  for (int w = 0; w < active; ++w) {
    load_rows(sm.q[w], maps.q, &sm.own, row0 + w * BT, h, b);
    load_rows(sm.dout[w], maps.dout, &sm.own, row0 + w * BT, h, b);
  }
  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);  // passes at once in the first round
    mbar_arrive_expect_tx(&sm.full[s], 2 * Rows80<BT>::BYTES);
    load_rows(sm.k[s], maps.k, &sm.full[s], t * BT, h, b);
    load_rows(sm.v[s], maps.v, &sm.full[s], t * BT, h, b);
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
__device__ __forceinline__ void dq_consume(DqSmem<WGS, STAGES>& sm, const MapPair& map_dq, const DqArgs& a, int wg,
                                           int wg_row0, int h, int b, int tiles) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int N = a.N;
  const size_t bh = (size_t)b * a.H + h;

  // di = rowsum(dO * o) in fp32, two threads per row (40 values, five
  // 16-byte loads each)
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
    lse2_r[hi] = n < N ? a.lse[bh * N + n] * LOG2E : INFINITY;  // a row past N: P = 0
  }

  Acc80 dq;
  float s[32], dp[32];
  uint32_t ds[16];
  zero_registers(dq);

  mbar_wait(&sm.own, 0);
  OwnRows a_q, a_do;  // the own rows stay in registers for the whole walk
  load_own(a_q, sm.q[wg], warp, lane);
  load_own(a_do, sm.dout[wg], warp, lane);

  for (int t = 0; t < tiles; ++t) {
    const int slot = t % STAGES;
    mbar_wait(&sm.full[slot], (t / STAGES) & 1);
    const uint64_t k_main = wgmma_desc(sm.k[slot].main), k_side = wgmma_desc_b32(sm.k[slot].side);
    const uint64_t v_main = wgmma_desc(sm.v[slot].main), v_side = wgmma_desc_b32(sm.v[slot].side);

    fence_registers(s);
    fence_registers(dp);
    wgmma_fence();
    products_nt(s, a_q, k_main, k_side, dp, a_do, v_main, v_side);  // S = Q K^T, dP = dO V^T
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
    product_rows80<BT / 16>(dq, ds, k_main, k_side);  // dQ += dS K, left in flight under the next tile's first products
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_registers(dq);

  named_barrier_sync(1 + wg, 128);  // every warp has read its rows of the Q tile
  store_acc80(sm.q[wg], dq, warp, lane);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0) {
    store_rows(map_dq, sm.q[wg], wg_row0, h, b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

template <int WGS, int STAGES, int BLOCKS>
__global__ void __launch_bounds__((WGS + 1) * 128, BLOCKS)
attention_d80_bwd_dq_kernel(const __grid_constant__ DqMaps maps, const DqArgs args) {
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
    if (threadIdx.x % 128 == 0) dq_produce(sm, maps, row0, h, b, active, tiles);
  } else {
    registers_take<Registers<WGS, BLOCKS>::CONSUMER>();
    if (wg < active) dq_consume(sm, maps.dq, args, wg, row0 + wg * BT, h, b, tiles);
  }
}

// --------------------------------------------------------------------- dkv

template <int WGS, int STAGES, int QT>
struct DkvSmem {
  Rows80<BT> k[WGS];          // own; dK on the way out
  Rows80<BT> v[WGS];          // own; dV on the way out
  Rows80<QT> q[STAGES];       // walked
  Rows80<QT> dout[STAGES];    // walked
  alignas(8) float lse2[STAGES][QT];  // walked: lse * log2(e), +inf past N
  alignas(8) float dis[STAGES][QT];   // walked: di * scale, 0 past N
  uint64_t own, full[STAGES], empty[STAGES];
};

struct DkvMaps {
  MapPair q, dout;  // boxes of QT rows
  MapPair k, v, dk, dv;
};

struct DkvArgs {
  const float* lse;
  const float* di;
  int N, H;
  float scale;
};

// one warp: lane 0 starts the loads (the block's own K and V tiles, then the
// Q and dO tiles into the ring), every lane brings QT / 32 rows' lse and di
// of each walked tile, read one tile ahead
template <int WGS, int STAGES, int QT>
__device__ __forceinline__ void dkv_produce(DkvSmem<WGS, STAGES, QT>& sm, const DkvMaps& maps, const DkvArgs& a,
                                            int row0, int h, int b, int active, int tiles) {
  constexpr int PER_LANE = QT / 32;
  const int lane = threadIdx.x % 32;
  const int N = a.N;
  if (lane == 0) {
    mbar_arrive_expect_tx(&sm.own, active * 2 * Rows80<BT>::BYTES);
    for (int w = 0; w < active; ++w) {
      load_rows(sm.k[w], maps.k, &sm.own, row0 + w * BT, h, b);
      load_rows(sm.v[w], maps.v, &sm.own, row0 + w * BT, h, b);
    }
  }
  const float* lse_bh = a.lse + ((size_t)b * a.H + h) * N;
  const float* di_bh = a.di + ((size_t)b * a.H + h) * N;
  float l[PER_LANE], d[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int n = lane + 32 * i;
    l[i] = n < N ? lse_bh[n] * LOG2E : INFINITY;
    d[i] = n < N ? di_bh[n] * a.scale : 0.f;
  }
  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.full[s], 2 * Rows80<QT>::BYTES);
      load_rows(sm.q[s], maps.q, &sm.full[s], t * QT, h, b);
      load_rows(sm.dout[s], maps.dout, &sm.full[s], t * QT, h, b);
    }
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      sm.lse2[s][lane + 32 * i] = l[i];
      sm.dis[s][lane + 32 * i] = d[i];
    }
    mbar_arrive(&sm.full[s]);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {  // the next tile's, read while its slot is awaited
      const int n = (t + 1) * QT + lane + 32 * i;
      l[i] = n < N ? lse_bh[n] * LOG2E : INFINITY;
      d[i] = n < N ? di_bh[n] * a.scale : 0.f;
    }
  }
}

// P^T and dS^T on the accumulators' registers (NA = QT / 2 a thread),
// packed to bf16 as the A operands of dV += P^T dO and dK += dS^T Q. The
// statistics belong to the columns (query rows) here; a column past N has
// lse = +inf, so its P and dS are 0.
template <int NA>
__device__ __forceinline__ void dkv_elementwise(const float (&st)[NA], const float (&dpt)[NA],
                                                uint32_t (&p)[NA / 2], uint32_t (&ds)[NA / 2], const float* lse2,
                                                const float* dis, float scale, float scale_log2, int col0) {
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int c = 8 * j + col0;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
    const float2 di = *reinterpret_cast<const float2*>(dis + c);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int i = 4 * j + 2 * hi;
      const float p0 = fast_exp2(fmaf(st[i], scale_log2, -l2.x));
      const float p1 = fast_exp2(fmaf(st[i + 1], scale_log2, -l2.y));
      p[a_index(j, hi)] = pack_bf16(p0, p1);
      ds[a_index(j, hi)] = pack_bf16(p0 * fmaf(dpt[i], scale, -di.x), p1 * fmaf(dpt[i + 1], scale, -di.y));
    }
  }
}

// warpgroup `wg` of the block: dK and dV of its 64 key rows (key rows past N
// compute values that the store cuts)
template <int WGS, int STAGES, int QT>
__device__ __forceinline__ void dkv_consume(DkvSmem<WGS, STAGES, QT>& sm, const DkvMaps& maps, const DkvArgs& a,
                                            int wg, int wg_row0, int h, int b, int tiles) {
  constexpr int NA = QT / 2;  // accumulator values a thread of S^T and dP^T
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col0 = (lane % 4) * 2;
  const float scale = a.scale;
  const float scale_log2 = scale * LOG2E;

  Acc80 dk, dv;
  float st[NA], dpt[NA];
  uint32_t p[NA / 2], ds[NA / 2];
  zero_registers(dk);
  zero_registers(dv);

  mbar_wait(&sm.own, 0);
  OwnRows a_k, a_v;  // the own rows stay in registers for the whole walk
  load_own(a_k, sm.k[wg], warp, lane);
  load_own(a_v, sm.v[wg], warp, lane);

  for (int t = 0; t < tiles; ++t) {
    const int slot = t % STAGES;
    mbar_wait(&sm.full[slot], (t / STAGES) & 1);
    const uint64_t q_main = wgmma_desc(sm.q[slot].main), q_side = wgmma_desc_b32(sm.q[slot].side);
    const uint64_t do_main = wgmma_desc(sm.dout[slot].main), do_side = wgmma_desc_b32(sm.dout[slot].side);

    fence_registers(st);
    fence_registers(dpt);
    wgmma_fence();
    products_nt(st, a_k, q_main, q_side, dpt, a_v, do_main, do_side);  // S^T = K Q^T, dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(st);
    fence_registers(dpt);

    dkv_elementwise(st, dpt, p, ds, sm.lse2[slot], sm.dis[slot], scale, scale_log2, col0);

    fence_registers(dv);
    fence_registers(dk);
    wgmma_fence();
    products_rows<QT / 16>(dv, p, do_main, do_side, dk, ds, q_main, q_side);  // dV += P^T dO, dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&sm.empty[slot]);
  }
  fence_registers(dv);
  fence_registers(dk);

  named_barrier_sync(1 + wg, 128);  // every warp has read its rows of the K and V tiles
  store_acc80(sm.k[wg], dk, warp, lane);
  store_acc80(sm.v[wg], dv, warp, lane);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0) {
    store_rows(maps.dk, sm.k[wg], wg_row0, h, b);
    store_rows(maps.dv, sm.v[wg], wg_row0, h, b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

template <int WGS, int STAGES, int BLOCKS, int QT>
__global__ void __launch_bounds__((WGS + 1) * 128, BLOCKS)
attention_d80_bwd_dkv_kernel(const __grid_constant__ DkvMaps maps, const DkvArgs args) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<WGS, STAGES, QT>& sm = aligned_smem<DkvSmem<WGS, STAGES, QT>>(smem_raw);
  const int row0 = blockIdx.x * (WGS * BT);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (args.N + QT - 1) / QT;
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
    if (threadIdx.x % 128 < 32) dkv_produce(sm, maps, args, row0, h, b, active, tiles);
  } else {
    registers_take<Registers<WGS, BLOCKS>::CONSUMER>();
    if (wg < active) dkv_consume(sm, maps, args, wg, row0 + wg * BT, h, b, tiles);
  }
}

// ------------------------------------------------------------------ launch

}  // namespace

// q, k, v, o, dout, dq: (B, N, H, 80) bf16; lse, di: (B, H, N) fp32; all
// contiguous, 16-byte aligned, on the current device. Writes dq and
// di = rowsum(dout o). Returns a cudaError_t (0 = launched).
extern "C" int attention_d80_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                    const void* lse, void* dq, void* di, int B, int N, int H, int head_dim,
                                    float scale, void* stream) {
  if (hopper::bad_shape80(B, N, H, head_dim)) return (int)cudaErrorInvalidValue;
  const auto kernel = attention_d80_bwd_dq_kernel<BWD80_DQ_WGS, BWD80_DQ_STAGES, BWD80_DQ_BLOCKS>;
  const int smem = (int)sizeof(DqSmem<BWD80_DQ_WGS, BWD80_DQ_STAGES>) + 1024;  // room to align the tiles
  static bool allowed[hopper::MAX_DEVICES] = {};
  const cudaError_t err = hopper::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  DqMaps maps;
  int bad = hopper::encode_pair(&maps.q, q, B, N, H, BT);
  if (!bad) bad = hopper::encode_pair(&maps.k, k, B, N, H, BT);
  if (!bad) bad = hopper::encode_pair(&maps.v, v, B, N, H, BT);
  if (!bad) bad = hopper::encode_pair(&maps.dout, dout, B, N, H, BT);
  if (!bad) bad = hopper::encode_pair(&maps.dq, dq, B, N, H, BT);
  if (bad) return bad;
  const dim3 grid((N + BWD80_DQ_WGS * BT - 1) / (BWD80_DQ_WGS * BT), H, B);
  kernel<<<grid, (BWD80_DQ_WGS + 1) * 128, smem, (cudaStream_t)stream>>>(
      maps, DqArgs{(const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)lse, (float*)di, N, H, scale});
  return (int)cudaGetLastError();
}

// q, k, v, dout, dk, dv: (B, N, H, 80) bf16; lse, di: (B, H, N) fp32 (di
// from attention_d80_bwd_dq); all contiguous, 16-byte aligned, on the
// current device. Writes dk and dv. Returns a cudaError_t (0 = launched).
extern "C" int attention_d80_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                     const void* di, void* dk, void* dv, int B, int N, int H, int head_dim,
                                     float scale, void* stream) {
  if (hopper::bad_shape80(B, N, H, head_dim)) return (int)cudaErrorInvalidValue;
  constexpr int QT = BWD80_DKV_QT;
  const auto kernel = attention_d80_bwd_dkv_kernel<BWD80_DKV_WGS, BWD80_DKV_STAGES, BWD80_DKV_BLOCKS, QT>;
  const int smem = (int)sizeof(DkvSmem<BWD80_DKV_WGS, BWD80_DKV_STAGES, QT>) + 1024;
  static bool allowed[hopper::MAX_DEVICES] = {};
  const cudaError_t err = hopper::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  DkvMaps maps;
  int bad = hopper::encode_pair(&maps.q, q, B, N, H, QT);
  if (!bad) bad = hopper::encode_pair(&maps.dout, dout, B, N, H, QT);
  if (!bad) bad = hopper::encode_pair(&maps.k, k, B, N, H, BT);
  if (!bad) bad = hopper::encode_pair(&maps.v, v, B, N, H, BT);
  if (!bad) bad = hopper::encode_pair(&maps.dk, dk, B, N, H, BT);
  if (!bad) bad = hopper::encode_pair(&maps.dv, dv, B, N, H, BT);
  if (bad) return bad;
  const dim3 grid((N + BWD80_DKV_WGS * BT - 1) / (BWD80_DKV_WGS * BT), H, B);
  kernel<<<grid, (BWD80_DKV_WGS + 1) * 128, smem, (cudaStream_t)stream>>>(
      maps, DkvArgs{(const float*)lse, (const float*)di, N, H, scale});
  return (int)cudaGetLastError();
}
