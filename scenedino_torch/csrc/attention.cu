// Flash-style attention forward for the DINO ViT, bf16 in and out.
//
// Replaces: scenedino_tpu/models/vit.py:126 `_flash_mhsa`, which calls the
// library Pallas TPU kernel jax/experimental/pallas/ops/tpu/flash_attention.py
// (`_flash_attention_impl` :589, pallas_call at :758) on q, k, v padded to a
// multiple of 512 tokens and masked by segment ids.
//
// Computes out = softmax(q k^T * scale) v for every (batch, head) of
// q, k, v laid out (B, N, H, D), D = 64, and, when the caller passes an
// fp32 (B, H, N) buffer, each row's log-sum-exp of the scaled logits
// (natural log), which the backward kernels (attention_bwd.cu) read.
//
// Bound on the H100: operations. One call does 4 N^2 D B H FLOP (11.3
// GFLOP at ViT-B/8 on 192x640: B = 1, N = 1921, H = 12; 0.0115 ms at 989
// TFLOP/s) against 4 N D B H bf16 values moved (3.9 MB, 0.0012 ms). Beside
// the tensor cores, the special-function unit computes one exp2 per logit
// (N^2 B H of them at 16 a cycle an SM: about as long as the products at
// their peak), so neither may wait for the other.
//
// What the design does about it (Hopper: wgmma, TMA, mbarriers; the
// primitives are in hopper.cuh), as the backward kernels do:
//   * A block is WGS consumer warpgroups, each owning 64 query rows, and a
//     producer warpgroup of which one thread works. The roles part in one
//     if/else and never meet again, so the producer hands its registers to
//     the consumers (setmaxnreg).
//   * The producer TMA-loads each consumer's Q tile once, then walks the
//     key and value tiles (64 rows each) through a ring of STAGES slots of
//     128-byte-swizzled tiles, a full and an empty mbarrier a slot; one
//     walked tile serves every warpgroup of the block.
//   * S = Q K^T is wgmma m64n64k16 with K read K-major and Q, the A
//     operand, loaded once from its tile into registers. S comes out in
//     registers.
//   * The online softmax runs on those registers in fp32, base 2, with
//     scale * log2(e) folded into one fma before ex2.approx: a row's max
//     over the quad of lanes that hold it (two shuffles), maxima and sums
//     as trees, the row sum kept per lane and summed over the quad once at
//     the end. The rescale of O is exact (hopper.cuh): the running max of a
//     warp's rows moves whenever a row's grows, so the dominant key's P is
//     1 before its bf16 rounding, as in the plain softmax; O is touched only
//     on the tiles where some row's max grew.
//   * P is packed to bf16 in the order of the A operand (a_index), and
//     O += P V reads the same walked V tile MN-major. S, P and O never
//     touch shared memory during the walk.
//   * The walk is pipelined within a warpgroup: S of tile t + 1 is issued
//     before O += P V of tile t, and the softmax of tile t + 1 runs while
//     that product is in flight; the other warpgroups' products fill the
//     rest. The last tile is peeled off the loop, so that no wgmma commit
//     depends on a branch (with one, ptxas serialized the products, C7514).
//   * The ragged tail: TMA zero-fills key rows past N, and a zero key row
//     gives S = 0, not P = 0, so the last walked tile's columns at or past
//     N are set to -inf before the max (only that tile pays for the mask).
//     Query rows past N compute values that the TMA store of O cuts.
//   * Epilogue: O / l to bf16 into the warpgroup's own (swizzled) Q tile
//     and out with a TMA store; the log-sum-exp (m + log2 l) ln 2 by one
//     lane of each quad, rows below N only ((B, H, N) fp32 rows are not
//     16-byte aligned at N = 1921, so no bulk copy).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// consumer warpgroups per block, slots of the ring, and blocks per SM that
// the registers are divided for (tools/bench_attention_bwd.py --fwd-variants
// times others)
#ifndef FWD_WGS
#define FWD_WGS 3
#endif
#ifndef FWD_STAGES
#define FWD_STAGES 3
#endif
#ifndef FWD_BLOCKS
#define FWD_BLOCKS 1
#endif

namespace {

using namespace hopper;

constexpr int D = 64;   // head dim
constexpr int BT = 64;  // rows of a warpgroup's query tile and of each walked tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

static_assert(D == TILE && BT == TILE, "the tiles of hopper.cuh are 64 x 64");

template <int WGS, int STAGES>
struct FwdSmem {
  alignas(1024) unsigned char q[WGS][TILE_BYTES];     // own; O on the way out
  alignas(1024) unsigned char k[STAGES][TILE_BYTES];  // walked
  alignas(1024) unsigned char v[STAGES][TILE_BYTES];  // walked
  uint64_t own, full[STAGES], empty[STAGES];
};

struct FwdArgs {
  float* lse;  // null: not written
  int N, H;
  float scale_log2;
};

// one lane starts every load of the block: the active warpgroups' Q tiles,
// then the K and V tiles into the ring as its slots come free
template <int WGS, int STAGES>
__device__ __forceinline__ void fwd_produce(FwdSmem<WGS, STAGES>& sm, const CUtensorMap* map_q,
                                            const CUtensorMap* map_k, const CUtensorMap* map_v, int row0, int h,
                                            int b, int active, int tiles) {
  mbar_arrive_expect_tx(&sm.own, active * TILE_BYTES);
  for (int w = 0; w < active; ++w) tma_load_4d(sm.q[w], map_q, &sm.own, 0, h, row0 + w * BT, b);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);  // passes at once in the first round
    mbar_arrive_expect_tx(&sm.full[s], 2 * TILE_BYTES);
    tma_load_4d(sm.k[s], map_k, &sm.full[s], 0, h, t * BT, b);
    tma_load_4d(sm.v[s], map_v, &sm.full[s], 0, h, t * BT, b);
  }
}

// The online softmax (softmax_tile, pack_p, rescale) is hopper.cuh's, shared
// with the D = 80 forward (attention_d80.cu).

// S = Q K^T for the walked key tile at desc_k (64 x 64, fp32 registers)
__device__ __forceinline__ void scores(float (&s)[32], const uint32_t (&a_q)[16], uint64_t desc_k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n64k16_rs<0>(s, &a_q[4 * kk], desc_k + kk * WGMMA_K_STEP, kk > 0);
}

// O (64 x 64, registers) += P (64 x 64 bf16 in registers) times the walked value tile
__device__ __forceinline__ void product_rows(float (&o)[32], const uint32_t (&p)[16], uint64_t desc_v) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) wgmma_m64n64k16_rs<1>(o, &p[4 * kk], desc_v + kk * WGMMA_MN_STEP, 1);
}

// warpgroup `wg` of the block: O (and the log-sum-exp) of its 64 query rows
template <int WGS, int STAGES>
__device__ __forceinline__ void fwd_consume(FwdSmem<WGS, STAGES>& sm, const CUtensorMap* map_o, const FwdArgs& a,
                                            int wg, int wg_row0, int h, int b, int tiles) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col0 = (lane % 4) * 2;
  const int N = a.N;
  const float scale_log2 = a.scale_log2;

  float o[32], s[32];
  uint32_t p[16];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  fence_registers(o);  // zeroed here, not under products in flight

  mbar_wait(&sm.own, 0);
  uint32_t a_q[16];  // the own rows stay in registers for the whole walk
  load_a_operand(a_q, sm.q[wg], warp, lane);

  // S of the next tile is issued before O += P V of this one, and the
  // softmax of the next tile runs while that product is in flight (P stays
  // in S's registers until the product is done); the last tile is peeled off
  float alpha[2];
  mbar_wait(&sm.full[0], 0);
  fence_registers(s);
  wgmma_fence();
  scores(s, a_q, wgmma_desc(sm.k[0]));
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(s);
  softmax_tile(0, s, m, l, alpha, scale_log2, N, col0);  // O is 0: nothing to rescale
  pack_p(s, p);
  for (int t = 0; t + 1 < tiles; ++t) {
    const int slot = t % STAGES;
    const int next = (t + 1) % STAGES;
    mbar_wait(&sm.full[next], ((t + 1) / STAGES) & 1);
    fence_registers(s);
    wgmma_fence();
    scores(s, a_q, wgmma_desc(sm.k[next]));
    wgmma_commit();
    fence_registers(o);
    wgmma_fence();
    product_rows(o, p, wgmma_desc(sm.v[slot]));
    wgmma_commit();
    wgmma_wait<1>();  // S of the next tile; O += P V still in flight
    fence_registers(s);
    const bool move = softmax_tile(t + 1, s, m, l, alpha, scale_log2, N, col0);
    wgmma_wait<0>();
    fence_registers(o);
    if (lane == 0) mbar_arrive(&sm.empty[slot]);
    if (move) rescale(o, alpha);
    pack_p(s, p);
  }
  fence_registers(o);
  wgmma_fence();
  product_rows(o, p, wgmma_desc(sm.v[(tiles - 1) % STAGES]));
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(o);

  const int row_lo = warp * 16 + lane / 4;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
    const float inv = 1.f / l[hi];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j + 2 * hi] *= inv;
      o[4 * j + 2 * hi + 1] *= inv;
    }
    const int n = wg_row0 + row_lo + 8 * hi;
    if (a.lse != nullptr && lane % 4 == 0 && n < N) {
      a.lse[((size_t)b * a.H + h) * N + n] = (m[hi] + log2f(l[hi])) * LN2;
    }
  }

  named_barrier_sync(1 + wg, 128);  // every warp is done with the Q tile
  store_accumulator(sm.q[wg], o, warp, lane);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0) {
    tma_store_4d(map_o, sm.q[wg], 0, h, wg_row0, b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

template <int WGS, int STAGES, int BLOCKS>
__global__ void __launch_bounds__((WGS + 1) * 128, BLOCKS)
attention_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_o,
                     const FwdArgs args) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<WGS, STAGES>& sm = aligned_smem<FwdSmem<WGS, STAGES>>(smem_raw);
  const int row0 = blockIdx.x * (WGS * BT);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (args.N + BT - 1) / BT;
  // warpgroups with a row below N; the others (the last block of a head can
  // hold one valid row) take no part, so the empty barriers count only these
  const int active = min(WGS, (args.N - row0 + BT - 1) / BT);
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
    if (threadIdx.x % 128 == 0) fwd_produce(sm, &map_q, &map_k, &map_v, row0, h, b, active, tiles);
  } else {
    registers_take<Registers<WGS, BLOCKS>::CONSUMER>();
    if (wg < active) fwd_consume(sm, &map_o, args, wg, row0 + wg * BT, h, b, tiles);
  }
}

}  // namespace

// q, k, v, out: (B, N, H, D) bf16, contiguous, 16-byte aligned, on the
// current device; lse: (B, H, N) fp32 or null (not written).
// Returns a cudaError_t (0 = launched).
extern "C" int attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int N,
                             int H, int head_dim, float scale, void* stream) {
  if (head_dim != D || B <= 0 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const auto kernel = attention_fwd_kernel<FWD_WGS, FWD_STAGES, FWD_BLOCKS>;
  const int smem = (int)sizeof(FwdSmem<FWD_WGS, FWD_STAGES>) + 1024;  // room to align the tiles
  static bool allowed[hopper::MAX_DEVICES] = {};
  const cudaError_t err = hopper::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[4];
  const void* const bases[4] = {q, k, v, out};
  const int bad = hopper::encode_maps(maps, bases, B, N, H);
  if (bad) return bad;
  const dim3 grid((N + FWD_WGS * BT - 1) / (FWD_WGS * BT), H, B);
  kernel<<<grid, (FWD_WGS + 1) * 128, smem, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], FwdArgs{(float*)lse, N, H, scale * LOG2E});
  return (int)cudaGetLastError();
}
