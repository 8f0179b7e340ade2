// Flash-style attention forward at head dim 80, bf16 in and out (the
// I-JEPA-H/14 backbone: 16 heads of 80; any ViT with heads of 80). Its
// backward, dq and dk/dv, is attention_d80_bwd.cu.
//
// Replaces, at D = 80: scenedino_tpu/models/vit.py:126 `_flash_mhsa`, which
// calls the library Pallas TPU kernel jax/experimental/pallas/ops/tpu/
// flash_attention.py (`_flash_attention_impl` :589, pallas_call at :758) on
// q, k, v padded to a multiple of 512 tokens and masked by segment ids.
//
// Computes, for every (batch, head) of q, k, v laid out (B, N, H, 80),
// out = softmax(q k^T * scale) v and, when the caller passes an fp32
// (B, H, N) buffer, each row's log-sum-exp of the scaled logits (natural
// log), which the backward reads.
//
// Bound on the H100: operations at the training step's shapes. One call does
// 4 N^2 D B H FLOP: 28.3 GFLOP at the D = 80 step's student (2, 1921, 12,
// 80), 0.0287 ms at 989 TFLOP/s, against 4 N D B H bf16 values moved (3.0
// MB, 0.0009 ms). At one I-JEPA-H/14 image (1, 585, 16, 80) the two are
// about equal (1.75 GFLOP, 6.0 MB: 0.0018 ms each). Beside the tensor cores
// the special-function unit computes one exp2 per logit.
//
// What the design does about it: attention.cu's design (D = 64), whose note
// says more, on the 64 + 16 column split of a row of 80 that
// attention_d80_bwd.cu introduced (hopper.cuh, "rows of 80"):
//   * Each own or walked tile is two TMA boxes: columns 0-63 under the
//     128-byte swizzle and columns 64-79 as a side tile of 32-byte rows under
//     the 32-byte swizzle. No row is padded to 128 columns, which would waste
//     37.5 % of the O += P V products.
//   * A block is WGS consumer warpgroups, each owning 64 query rows, and a
//     producer warpgroup of which one thread works: it TMA-loads the Q tiles
//     once, then walks the K and V tiles (64 rows) through a ring of STAGES
//     slots, a full and an empty mbarrier a slot; one walked tile serves
//     every warpgroup of the block. The roles part in one if/else that never
//     rejoins, and setmaxnreg hands the producer's registers to the
//     consumers, each of which holds S (32 fp32 a thread), O (32 + 8), Q as
//     the A operand (16 + 4) and P (16).
//   * S = Q K^T: four wgmma m64n64k16 k-steps on K's main tile and a fifth on
//     its side tile, K read K-major. O += P V: m64n64k16 on V's main tile
//     plus m64n16k16 on its side tile, V read MN-major, four k-steps over the
//     64 keys; P is packed to bf16 in the A operand's order. S, P and O never
//     touch shared memory during the walk.
//   * The online softmax (hopper.cuh, shared with attention.cu) runs on S's
//     registers in fp32, base 2, scale * log2(e) folded into one fma before
//     ex2.approx; a row's max over its quad of lanes by two shuffles; the
//     exact rescale (a warp's running max moves whenever a row's max grows,
//     so the dominant key's P is 1 before its bf16 rounding); the row sum
//     kept per lane and summed over the quad once at the end.
//   * S of tile t + 1 is issued before O += P V of tile t, and the softmax of
//     tile t + 1 runs while that product is in flight. The last tile is
//     peeled off the loop, so that no wgmma commit depends on a branch.
//   * The ragged tail: TMA zero-fills key rows past N, and a zero key row
//     gives S = 0, not P = 0, so the last walked tile's columns at or past N
//     are set to -inf before the max (only that tile pays for the mask).
//     Query rows past N compute values that the TMA store of O cuts. A
//     warpgroup whose 64 rows all lie past N (at 1921 = 30 * 64 + 1 the last
//     query tile holds one row) takes no part: the block's empty barriers
//     count only the active warpgroups, as in attention.cu.
//   * Epilogue: O / l to bf16 into the warpgroup's own (swizzled) Q tiles,
//     main and side, and out by two TMA stores; the log-sum-exp,
//     (m + log2 l) ln 2, by one lane of each quad, rows below N only.
//   * Block shape: 3 warpgroups and 3 ring slots, one block an SM (24 / 160
//     registers after setmaxnreg). A grid that would not fill one wave of
//     the card (one I-JEPA-H/14 image: 64 such blocks on 132 SMs) takes
//     blocks of 2 warpgroups instead (24 / 240), chosen on the host from the
//     block count. Every instantiation gives the same bits: a row's
//     arithmetic does not depend on the block (PERF.md, section 6, has the
//     times of both and of the others tried).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// consumer warpgroups per block, slots of the ring, and blocks per SM that
// the registers are divided for; FWD80_SMALL_* the same for a grid that the
// first instantiation would leave short of one wave of blocks on the card
// (tools/bench_attention_bwd.py --head-dim 80 --fwd-variants times others)
#ifndef FWD80_WGS
#define FWD80_WGS 3
#endif
#ifndef FWD80_STAGES
#define FWD80_STAGES 3
#endif
#ifndef FWD80_BLOCKS
#define FWD80_BLOCKS 1
#endif
#ifndef FWD80_SMALL_WGS
#define FWD80_SMALL_WGS 2
#endif
#ifndef FWD80_SMALL_STAGES
#define FWD80_SMALL_STAGES 3
#endif
#ifndef FWD80_SMALL_BLOCKS
#define FWD80_SMALL_BLOCKS 1
#endif

namespace {

using namespace hopper;

constexpr int BT = TILE;  // rows of a warpgroup's query tile and of each walked tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int WGS, int STAGES>
struct Fwd80Smem {
  Rows80<BT> q[WGS];     // own; O on the way out
  Rows80<BT> k[STAGES];  // walked
  Rows80<BT> v[STAGES];  // walked
  uint64_t own, full[STAGES], empty[STAGES];
};

struct Fwd80Maps {
  MapPair q, k, v, o;
};

struct Fwd80Args {
  float* lse;  // null: not written
  int N, H;
  float scale_log2;
};

// one lane starts every load of the block: the active warpgroups' Q tiles,
// then the K and V tiles into the ring as its slots come free
template <int WGS, int STAGES>
__device__ __forceinline__ void fwd80_produce(Fwd80Smem<WGS, STAGES>& sm, const Fwd80Maps& maps, int row0, int h,
                                              int b, int active, int tiles) {
  mbar_arrive_expect_tx(&sm.own, active * Rows80<BT>::BYTES);
  for (int w = 0; w < active; ++w) load_rows(sm.q[w], maps.q, &sm.own, row0 + w * BT, h, b);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);  // passes at once in the first round
    mbar_arrive_expect_tx(&sm.full[s], 2 * Rows80<BT>::BYTES);
    load_rows(sm.k[s], maps.k, &sm.full[s], t * BT, h, b);
    load_rows(sm.v[s], maps.v, &sm.full[s], t * BT, h, b);
  }
}

// warpgroup `wg` of the block: O (and the log-sum-exp) of its 64 query rows
template <int WGS, int STAGES>
__device__ __forceinline__ void fwd80_consume(Fwd80Smem<WGS, STAGES>& sm, const MapPair& map_o, const Fwd80Args& a,
                                              int wg, int wg_row0, int h, int b, int tiles) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col0 = (lane % 4) * 2;
  const int N = a.N;
  const float scale_log2 = a.scale_log2;

  Acc80 o;
  float s[32];
  uint32_t p[16];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float alpha[2];
  zero_registers(o);  // zeroed here, not under products in flight

  mbar_wait(&sm.own, 0);
  OwnRows a_q;  // the own rows stay in registers for the whole walk
  load_own(a_q, sm.q[wg], warp, lane);

  // S of the next tile is issued before O += P V of this one, and the
  // softmax of the next tile runs while that product is in flight (P stays
  // in its registers until the product is done); the last tile is peeled off
  mbar_wait(&sm.full[0], 0);
  fence_registers(s);
  wgmma_fence();
  product_nt80(s, a_q, wgmma_desc(sm.k[0].main), wgmma_desc_b32(sm.k[0].side));
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
    product_nt80(s, a_q, wgmma_desc(sm.k[next].main), wgmma_desc_b32(sm.k[next].side));
    wgmma_commit();
    fence_registers(o);
    wgmma_fence();
    product_rows80<BT / 16>(o, p, wgmma_desc(sm.v[slot].main), wgmma_desc_b32(sm.v[slot].side));
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
  const int last = (tiles - 1) % STAGES;
  fence_registers(o);
  wgmma_fence();
  product_rows80<BT / 16>(o, p, wgmma_desc(sm.v[last].main), wgmma_desc_b32(sm.v[last].side));
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(o);

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
  rescale(o, inv);

  named_barrier_sync(1 + wg, 128);  // every warp is done with the Q tiles
  store_acc80(sm.q[wg], o, warp, lane);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0) {
    store_rows(map_o, sm.q[wg], wg_row0, h, b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

template <int WGS, int STAGES, int BLOCKS>
__global__ void __launch_bounds__((WGS + 1) * 128, BLOCKS)
attention_d80_fwd_kernel(const __grid_constant__ Fwd80Maps maps, const Fwd80Args args) {
  extern __shared__ unsigned char smem_raw[];
  Fwd80Smem<WGS, STAGES>& sm = aligned_smem<Fwd80Smem<WGS, STAGES>>(smem_raw);
  const int row0 = blockIdx.x * (WGS * BT);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (args.N + BT - 1) / BT;
  // warpgroups with a row below N; the others take no part, so the empty
  // barriers count only these
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
    if (threadIdx.x % 128 == 0) fwd80_produce(sm, maps, row0, h, b, active, tiles);
  } else {
    registers_take<Registers<WGS, BLOCKS>::CONSUMER>();
    if (wg < active) fwd80_consume(sm, maps.o, args, wg, row0 + wg * BT, h, b, tiles);
  }
}

// blocks along the query rows at WGS warpgroups a block
template <int WGS>
int query_blocks(int N) {
  return (N + WGS * BT - 1) / (WGS * BT);
}

template <int WGS, int STAGES, int BLOCKS>
int launch_fwd80(const Fwd80Maps& maps, const Fwd80Args& args, int B, int H, cudaStream_t stream) {
  const auto kernel = attention_d80_fwd_kernel<WGS, STAGES, BLOCKS>;
  const int smem = (int)sizeof(Fwd80Smem<WGS, STAGES>) + 1024;  // room to align the tiles
  static bool allowed[MAX_DEVICES] = {};
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(query_blocks<WGS>(args.N), H, B), (WGS + 1) * 128, smem, stream>>>(maps, args);
  return (int)cudaGetLastError();
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

}  // namespace

// q, k, v, out: (B, N, H, 80) bf16; lse: (B, H, N) fp32 or null (not
// written); all contiguous, 16-byte aligned, on the current device. Returns a
// cudaError_t (0 = launched).
extern "C" int attention_d80_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int N,
                                 int H, int head_dim, float scale, void* stream) {
  if (hopper::bad_shape80(B, N, H, head_dim)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = multiprocessors(&sms);
  if (err != cudaSuccess) return (int)err;
  Fwd80Maps maps;
  int bad = hopper::encode_pair(&maps.q, q, B, N, H, BT);
  if (!bad) bad = hopper::encode_pair(&maps.k, k, B, N, H, BT);
  if (!bad) bad = hopper::encode_pair(&maps.v, v, B, N, H, BT);
  if (!bad) bad = hopper::encode_pair(&maps.o, out, B, N, H, BT);
  if (bad) return bad;
  const Fwd80Args args{(float*)lse, N, H, scale * LOG2E};
  // a grid short of one wave (one I-JEPA-H/14 image: 64 blocks of 3
  // warpgroups on 132 SMs) takes smaller blocks, more of them
  if ((long long)query_blocks<FWD80_WGS>(N) * H * B < (long long)sms * FWD80_BLOCKS) {
    return launch_fwd80<FWD80_SMALL_WGS, FWD80_SMALL_STAGES, FWD80_SMALL_BLOCKS>(maps, args, B, H,
                                                                                 (cudaStream_t)stream);
  }
  return launch_fwd80<FWD80_WGS, FWD80_STAGES, FWD80_BLOCKS>(maps, args, B, H, (cudaStream_t)stream);
}
