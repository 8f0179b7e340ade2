// Fused point query of the folded field, in three output modes that share
// one per-point pipeline (projection, code, 4-corner gather, both head
// products):
//
//   K2 `point_render`: volume compositing for the novel-view renderer.
//     Replaces scenedino_tpu/ops/fast_field.py:825 `_make_point_eval` and
//     :927 `_fused_rows_body`, the XLA-fused `lax.map` body of
//     `render_novel_view_fused` (:532).
//   K3 `probe_weights`: the sigma-only probe of the probe-guided render.
//     Replaces `_probe_weights_body` (:792), driven by
//     `render_novel_view_probe` (:750-761): only the density column of W2,
//     and the compositing weights (R, K) are the output.
//   K4 `point_query`: the voxel query, no compositing. Replaces
//     `fast_query_fused` (:990) over `_make_point_eval` (:856-922): per
//     point sigma = softplus(out[0]) and the feature out[1:].
//
// The TPU build could not write these in Pallas (Mosaic cannot lower a
// gather), so they had no TPU kernel; on Hopper each is one kernel.
//
// Per ray (origin o, unit direction d) and per sample depth z_k:
//   p = o + z_k d, projected into the encode camera (NDC clamped to +-2);
//   the positional code of (x, y, normalized depth), rounded to bf16;
//   g = bilinear blend in fp32 of 4 bf16 rows of the folded feature grid
//       (border clamp, align_corners=False);
//   h = bf16(relu((g + code @ W_code) + b1)), out = h @ W2 + b2 (fp32 sums);
//   sigma = softplus(out[0]);
// then along the K samples: alpha compositing with the max(1-a, 1e-10)
// floor and the optional hard cap on the last sample, depth = E[z] or the
// weight median (the sample at the count of samples whose normalized weight
// CDF is below 0.5, clamped; scenedino_tpu/core/compositing.py:61-78), the
// weighted feature out[1:], and the weighted colour from a second
// projection into the colour camera (bilinear, weights collapsed where the
// clamped corners coincide). Only per-ray outputs reach memory. K3 stops at
// the weights, K4 at the head output, and neither composites colour.
//
// Bound on the H100 at the flagship shape (122,880 rays x 32 samples,
// 384x1280x128 bf16 grid, W_code 39x128, W2 128x65): the two products are
// 3.93 M points x 2 x (39*128 + 128*65) = 105 GFLOP, about 106 us at the
// 989 TFLOP/s bf16 tensor-core peak; the grid rows the points read are
// about 118 MB, about 35 us at 3.35 TB/s if read once. But the four corner
// rows of every point (1 KB, 4.0 GB in all, mostly from L2) are what the
// kernel moves, and the code (36 sinf a point) and the blend run on the
// CUDA cores. K3 at the probe shape (7,680 rays x 16 samples) is bound by
// the grid rows it reads; K4 at the SSCBench grid (2,097,152 points) by
// its (P, 64) fp32 feature output, 537 MB, about 0.16 ms.
//
// Design (Hopper: wgmma; hopper.cuh):
//   * A warpgroup owns a 64-point tile (wgmma's M = 64): 64 / K rays of K
//     samples, or 64 query points. Blocks are persistent, PR_WGS
//     warpgroups each, sharing W_code and W2, which sit in shared memory
//     for the block's life as 128-byte-swizzled K-major tiles, zero-padded
//     (code columns to 64, hidden units to 64 or 128, outputs to 64 + 8 or
//     128). Consecutive tiles run on neighbouring blocks at once, so
//     neighbouring rays share the grid rows in L2.
//   * Set-up is spread over the warpgroup: a thread holds rows r and r + 8
//     of the tile's accumulators; for each it projects the point (the four
//     lanes of a row each repeat it), computes 16 of the row's 64 code
//     columns (sinf(fl(x f + pi/2)) for the cosine, as the reference; not
//     __sinf, which is accurate only in [-pi, pi] while the arguments reach
//     ~100 rad) into the warpgroup's swizzled code tile, the corner rows and
//     weights; lanes 0-2 sample one colour channel each, lane 3 keeps z.
//   * The code product acc = code W_code (K = 64, N = 64 a chunk; both
//     operands in shared memory) is issued asynchronously from zero and
//     runs while the chunk's first corner rows load. The hidden layer is
//     formed one 64-column chunk at a time, so one fp32 accumulator is what
//     the registers hold of it.
//   * The hidden units are permuted so that the accumulator columns of a
//     thread are one contiguous run of D/4 grid channels: the thread holds
//     columns n = 64c + 8j + 2q + t (q = lane % 4), and n stands for channel
//     pi(n) = q (16 C) + 16c + 2j + t with C = D/64 chunks. pi is applied to
//     W_code's columns, b1 and W2's rows as they are copied in; the grid
//     and the public layouts stay as they are. At D = 128 a thread reads
//     64 bytes of each 256-byte corner row as four 16-byte loads, and the
//     four lanes of a row read all of it; batches of 4 loads (a row's
//     corners of 8 channels) are issued PR_AHEAD batches ahead of the blend,
//     across chunks.
//   * h = bf16(relu((g + acc) + b1)) goes chunk by chunk into swizzled
//     tiles in shared memory, the A operand of out = h W2 (N = 64 + 8 at
//     E = 65): the fp32 accumulator never leaves the registers, and no
//     register holds a finished chunk of h while the next one is gathered.
//   * out + b2 goes through a 64-row fp32 buffer in shared memory (over the
//     code and h tiles, which are read by then). K2 and K3 composite one
//     ray a warp, two samples a lane: the transmittance
//     is an exclusive product scan by shuffles, the median's CDF a prefix
//     sum and its index a count of ballots, so products and sums are taken
//     in another order than the plain version's sequential ones (within
//     chip_smoke.py's K2_*_TOL and K2_MEDIAN_FLIPS). The weights return
//     through shared memory and the threads form the per-ray sums of the
//     feature and colour columns, each output one thread, coalesced. K4
//     writes the buffer out with coalesced stores.
//   * A ray of K > 64 samples (K2, K3) spans ceil(K / 64) tiles, and its
//     tiles are walked in order by one warpgroup, one ray at a time: tile s
//     holds samples [64 s, 64 s + 64), the rows past K dead (they repeat the
//     last sample; weight 0). One warp composites the tile's 64 samples as
//     above, from the transmittance the ray's earlier tiles left (the
//     delta of a tile's last sample reads the next tile's first depth from
//     memory), and the threads add the tile's weighted feature and colour
//     to the ray's running sums. The transmittance, E[z] and those sums are
//     carried from tile to tile in the warpgroup's shared memory, not in
//     registers (the D = 128 instantiations run at 168 registers a thread
//     without a spill, with nothing to spare). For the weight median the
//     ray's weights stay in shared memory until its last tile, which then
//     counts the samples whose CDF over the total is below 0.5 in chunks of
//     64, as the one-tile walk does. That array bounds these instantiations:
//     KMAX = 256 samples a ray (1 KB a warpgroup). K <= 64 keeps the packed
//     layout above.
//   * The host side caches the shared-memory attribute, the SM count and
//     the blocks an SM per device: a launch is the launch alone.
// The output mode, the hidden chunks, the output layout and the walk (one
// tile a ray or several) are template arguments, so that the one-tile
// kernels are built as they were before the multi-tile walk: sixteen
// instantiations, for D <= 128 (a multiple of 8), E <= 128, C <= 64 and
// K <= 256 (`shipped`). Every other shape the JAX functions take runs the
// wide walk (csrc/wide_walk.cuh; `point_wide_kernel` below): weights
// streamed from L2 through a ring in shared memory instead of resident, h
// in a row-major store, the output in chunks of 64 columns, the density
// column's chunk first, a ray's weights for the median in global scratch;
// five instantiations (K2 and K3 by walk, K4), chosen on the host, so the
// sixteen keep their code. A D that is not a multiple of 8 loads its grid
// rows element by element there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wide_walk.cuh"

// warpgroups a block, blocks an SM the registers are divided for, and
// corner-load batches issued ahead of the one being blended
// (tools/bench_point_render.py builds others side by side). Registers set
// the time: the walk's dependent chains (sinf, the divides, loads from L2)
// need warps to switch between. Three warpgroups an SM (168 registers a
// thread) hold the D = 128 instantiations without a spill; four (128) ran
// K2 faster on an H100 but spilled there (PERF.md).
#ifndef PR_WGS
#define PR_WGS 1
#endif
#ifndef PR_BLOCKS
#define PR_BLOCKS 3
#endif
#ifndef PR_AHEAD
#define PR_AHEAD 1
#endif

namespace {

using namespace hopper;

enum Mode { RENDER = 0, PROBE = 1, QUERY = 2 };

constexpr int TP = 64;          // points a tile: wgmma's M
constexpr int KMAX = 256;       // samples a ray: the multi-tile walk keeps a ray's weights in shared memory
constexpr int WG = 128;         // threads a warpgroup
constexpr int CODE_COLS = 64;   // code columns, zero-padded: four k-steps
constexpr float EPS = 1e-3f;
constexpr float HALF_PI = 1.57079637f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* rays;            // (R, 8); the points (R, 3) in QUERY
  const float* z;               // (R, K); unused in QUERY
  const __nv_bfloat16* grid;    // (Hg, Wg, D)
  const __nv_bfloat16* w_code;  // (C, D)
  const float* b1;              // (D,)
  const __nv_bfloat16* w2;      // (D, E)
  const float* b2;              // (E,)
  const float* feat_w2c;        // (4, 4)
  const float* feat_k;          // (3, 3)
  const __nv_bfloat16* color;   // (Hc, Wc, 3); RENDER only
  const float* color_w2c;       // (4, 4); RENDER only
  const float* color_k;         // (3, 3); RENDER only
  float* depth;                 // (R,) RENDER
  float* dino;                  // (R, E - 1) RENDER, QUERY
  float* rgb;                   // (R, 3) RENDER
  float* out;                   // weights (R, K) PROBE; sigma (R,) QUERY
  int R, K, Hg, Wg, D, E, C, Hc, Wc;
  int num_freqs, include_input, inv_z, code_distance, hard_cap, median;
  float zn_sub, zn_scale, freq_factor;
};

// Shared memory of a block: DC hidden chunks of 64, EC output chunks of 64
// and an 8-column output tail (ET = 8) or none (ET = 0); MULTI: the
// multi-tile walk's weights of a whole ray and its carried state.
template <int DC, int EC, int ET, int MULTI>
struct Layout {
  static constexpr int DP = 64 * DC;
  static constexpr int EP = 64 * EC + ET;
  static constexpr int LDO = EP + ((8 - EP) % 32 + 32) % 32;  // row stride of the output buffer, = 8 mod 32
  static constexpr int WC = 0;                                 // DC tiles: rows n (hidden), columns k (code)
  static constexpr int W2 = WC + DC * TILE_BYTES;              // EC x DC tiles: rows e, columns n
  static constexpr int W2T = W2 + EC * DC * TILE_BYTES;        // DC tail tiles of 8 rows (1 KB)
  static constexpr int B1 = W2T + (ET ? DC * 1024 : 0);
  static constexpr int B2 = B1 + DP * 4;
  static constexpr int CAM = B2 + EP * 4;
  static constexpr int CODE_TAB = CAM + 48 * 4;                // per code column: freq, phase, source
  static constexpr int WG0 = (CODE_TAB + CODE_COLS * 12 + 1023) / 1024 * 1024;
  // a warpgroup's own: the code tile and the DC tiles of h (the products' A
  // operands), which the output buffer later overwrites; z, the weights, the
  // colours
  static constexpr int OUT_BYTES = TP * LDO * 4 > (1 + DC) * TILE_BYTES ? TP * LDO * 4 : (1 + DC) * TILE_BYTES;
  static constexpr int CODE = 0;
  static constexpr int H = TILE_BYTES;
  static constexpr int OUT = 0;
  static constexpr int Z = OUT_BYTES;
  static constexpr int W = Z + TP * 4;                         // TP, or KMAX: a multi-tile ray's weights
  static constexpr int RGB = W + (MULTI ? KMAX : TP) * 4;
  // a multi-tile ray's carried state: transmittance, depth, weight total,
  // then its feature and colour sums (at most 127 + 3)
  static constexpr int CARRY = RGB + TP * 3 * 4;
  static constexpr int WG_BYTES = (CARRY + (MULTI ? 3 + 130 : 0) * 4 + 1023) / 1024 * 1024;
  static constexpr int TOTAL = WG0 + PR_WGS * WG_BYTES;
};

// the grid channel that hidden unit n of the kernel stands for
template <int DC>
__host__ __device__ inline int hidden_channel(int n) {
  const int c = n / 64, j = (n % 64) / 8, q = (n % 8) / 2, t = n % 2;
  return q * 16 * DC + 16 * c + 2 * j + t;
}

// cam: rot (9), trans (3), K (9). Rounded step by step (no FMA contraction)
// so the coordinates agree with the plain version's separate products.
__device__ inline void project(const float* cam, const float* pt, float& x, float& y, float& zc, float* pc) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float s = __fmul_rn(cam[i * 3 + 0], pt[0]);
    s = __fadd_rn(s, __fmul_rn(cam[i * 3 + 1], pt[1]));
    s = __fadd_rn(s, __fmul_rn(cam[i * 3 + 2], pt[2]));
    pc[i] = __fadd_rn(s, cam[9 + i]);
  }
  float proj[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float s = __fmul_rn(cam[12 + i * 3 + 0], pc[0]);
    s = __fadd_rn(s, __fmul_rn(cam[12 + i * 3 + 1], pc[1]));
    proj[i] = __fadd_rn(s, __fmul_rn(cam[12 + i * 3 + 2], pc[2]));
  }
  zc = proj[2];
  const float zd = fmaxf(zc, EPS);
  x = fminf(fmaxf(__fdiv_rn(proj[0], zd), -2.f), 2.f);
  y = fminf(fmaxf(__fdiv_rn(proj[1], zd), -2.f), 2.f);
}

// NDC -> continuous pixel coordinate, align_corners=False
__device__ inline float to_pixel(float v, int n) {
  return __fsub_rn(__fmul_rn(__fmul_rn(__fadd_rn(v, 1.f), 0.5f), (float)n), 0.5f);
}

__device__ inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// `v`, opaque to the compiler where it is called: what is computed from it
// is computed there, inside the tile loop, and not hoisted out of the loop
// into a register that lives across the whole walk (ptxas spilled such
// loop invariants: the grid sizes as floats, the wgmma descriptors)
__device__ __forceinline__ int fresh(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ inline float softplus(float x) { return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))); }

__device__ inline float pick3(int j, float a, float b, float c) { return j == 0 ? a : (j == 1 ? b : c); }

__device__ __forceinline__ int corner_row(const int4& v, int corner) {
  return corner == 0 ? v.x : (corner == 1 ? v.y : (corner == 2 ? v.z : v.w));
}

// bf16 element i of 8 packed in 16 bytes, exactly, as fp32
__device__ __forceinline__ float bf16_at(const uint4& v, int i) {
  const uint32_t w = i / 2 == 0 ? v.x : (i / 2 == 1 ? v.y : (i / 2 == 2 ? v.z : v.w));
  return __uint_as_float(i % 2 ? (w & 0xffff0000u) : (w << 16));
}

// what code column c is, once a block: sin(in[j] f + phase) of input j (0-2),
// input j itself (3-5), or 0 past C (6)
struct CodeColumn {
  float freq, phase;
  int source;
};

__device__ inline CodeColumn code_column(const Params& P, int c) {
  if (c >= P.C) return {0.f, 0.f, 6};
  if (P.include_input) {
    if (c < 3) return {0.f, 0.f, 3 + c};
    c -= 3;
  }
  const int f = c / 6, rem = c - 6 * f, s = rem / 3;
  return {P.freq_factor * (float)(1 << f), s ? HALF_PI : 0.f, rem - 3 * s};
}

// [input?, sin(f_0 in), cos(f_0 in) = sin(f_0 in + pi/2), sin(f_1 in), ...], 0 past C
__device__ __forceinline__ float code_value(const CodeColumn& col, float x, float y, float zz) {
  if (col.source >= 6) return 0.f;
  const float v = pick3(col.source % 3, x, y, zz);
  return col.source >= 3 ? v : sinf(__fadd_rn(__fmul_rn(v, col.freq), col.phase));
}

// One row p of the tile, as thread lane q sees it: the code's inputs
// (x, y, zz), the corner rows and weights of the feature grid; lanes 0-2
// the colour channel q (RENDER), lane 3 the sample depth.
template <int MODE, int MULTI>
__device__ __forceinline__ void setup_row(const Params& P, const float* cam, int p, int ray0, int rpt, int seg, int q,
                                          float3& in, int4& idx, float2& wxy, float* s_z, float* s_rgb) {
  const int K = MODE == QUERY ? 1 : P.K;
  int rl, k;
  if constexpr (MULTI) {  // tile `seg` of one ray: rows past K repeat its last sample; nobody reads them
    rl = 0;
    k = min(seg * TP + p, K - 1);
  } else {
    rl = p / K;
    k = p - rl * K;
  }
  const int r = ray0 + rl;
  const int rr = (rl < rpt && r < P.R) ? r : 0;  // rows past the tile's rays compute ray 0; nobody reads them
  float pt[3], zv = 0.f;
  if (MODE == QUERY) {
#pragma unroll
    for (int i = 0; i < 3; ++i) pt[i] = __ldg(P.rays + (size_t)rr * 3 + i);
  } else {
    const float* ray = P.rays + (size_t)rr * 8;
    zv = __ldg(P.z + (size_t)rr * K + k);
#pragma unroll
    for (int i = 0; i < 3; ++i) pt[i] = __fadd_rn(__ldg(ray + i), __fmul_rn(zv, __ldg(ray + 3 + i)));
  }

  const int Wg = fresh(P.Wg), Hg = fresh(P.Hg);
  float x, y, zc, pc[3];
  project(cam, pt, x, y, zc, pc);
  const float dl = P.code_distance ? sqrtf(pc[0] * pc[0] + pc[1] * pc[1] + pc[2] * pc[2]) : zc;
  // the normalized depth as jitted XLA computes the JAX package's normalize_z
  // (kernels/point_render.py `_config_args`): one rounding for the multiply-add
  const float zx = P.inv_z ? __fdiv_rn(1.f, fmaxf(dl, EPS)) : dl;
  in = make_float3(x, y, __fmaf_rn(__fsub_rn(zx, P.zn_sub), P.zn_scale, -1.f));

  // feature-grid corners (no weight collapse: coinciding corners blend to the corner)
  const float px = to_pixel(x, Wg), py = to_pixel(y, Hg);
  const float fx0 = floorf(px), fy0 = floorf(py);
  const int x0 = clampi((int)fx0, 0, Wg - 1), x1 = clampi((int)fx0 + 1, 0, Wg - 1);
  const int y0 = clampi((int)fy0, 0, Hg - 1), y1 = clampi((int)fy0 + 1, 0, Hg - 1);
  idx = make_int4(y0 * Wg + x0, y0 * Wg + x1, y1 * Wg + x0, y1 * Wg + x1);
  wxy = make_float2(__fsub_rn(px, fx0), __fsub_rn(py, fy0));

  if (q == 3 && MODE != QUERY) s_z[p] = zv;
  if (MODE != RENDER) return;
  // colour: second projection, bilinear with the border weight collapse; one channel a lane
  float cx, cy, czc, cpc[3];
  project(cam + 21, pt, cx, cy, czc, cpc);
  if (q == 3) return;
  const int Wc = fresh(P.Wc), Hc = fresh(P.Hc);
  const float qx = to_pixel(cx, Wc), qy = to_pixel(cy, Hc);
  const float gx0 = floorf(qx), gy0 = floorf(qy);
  const int u0 = clampi((int)gx0, 0, Wc - 1), u1 = clampi((int)gx0 + 1, 0, Wc - 1);
  const int v0 = clampi((int)gy0, 0, Hc - 1), v1 = clampi((int)gy0 + 1, 0, Hc - 1);
  const float wx = u1 > u0 ? __fsub_rn(qx, gx0) : 0.f;
  const float wy = v1 > v0 ? __fsub_rn(qy, gy0) : 0.f;
  const float w00 = (1.f - wx) * (1.f - wy), w01 = wx * (1.f - wy);
  const float w10 = (1.f - wx) * wy, w11 = wx * wy;
  const __nv_bfloat16* img = P.color;
  const float c00 = __bfloat162float(img[(v0 * Wc + u0) * 3 + q]);
  const float c01 = __bfloat162float(img[(v0 * Wc + u1) * 3 + q]);
  const float c10 = __bfloat162float(img[(v1 * Wc + u0) * 3 + q]);
  const float c11 = __bfloat162float(img[(v1 * Wc + u1) * 3 + q]);
  s_rgb[p * 3 + q] = c00 * w00 + c01 * w01 + c10 * w10 + c11 * w11;
}

// the thread's 16 code columns 16 kk + 8 g + 2 q + {0, 1} of rows r and
// r + 8 (inputs in[0], in[1]) into the swizzled code tile, four sinf
// chains at a time
__device__ __forceinline__ void write_code(const Params& P, const CodeColumn* tab, unsigned char* code, int row,
                                           int q, const float3 (&in)[2]) {
#pragma unroll 2
  for (int s = 0; s < 8; ++s) {
    const int col = 16 * (s >> 1) + 8 * (s & 1);
    const int c = col + 2 * q;
    uint32_t v[2] = {0u, 0u};
    if (c < P.C) {
      const CodeColumn c0 = tab[c], c1 = tab[c + 1];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        v[hi] = pack_bf16(code_value(c0, in[hi].x, in[hi].y, in[hi].z), code_value(c1, in[hi].x, in[hi].y, in[hi].z));
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      *reinterpret_cast<uint32_t*>(code + swizzled_offset(row + 8 * hi, col) + 4 * q) = v[hi];
    }
  }
}

// 16 bytes of the grid through the non-coherent path. As a volatile asm it
// keeps its place in the ring (each batch's blend is pinned at its end), so
// the loads in flight are the ring's.
__device__ __forceinline__ uint4 load16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// batch b of a thread's corner loads: chunk c, row r + 8 hi, 8-channel
// group g (b = 4 c + 2 hi + g), the four corners (16 bytes each)
template <int DC>
__device__ __forceinline__ void load_batch(uint4 (&buf)[4], const Params& P, const int4 (&idx)[2], int b, int q) {
  const int c = b / 4, hi = (b / 2) % 2, g = b % 2;
  const int base = q * 16 * DC + 16 * c + 8 * g;
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    buf[corner] = base + 8 <= P.D ? load16(P.grid + (size_t)corner_row(idx[hi], corner) * P.D + base)
                                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

// chunk c's accumulator columns of batch b <- relu((g + acc) + b1), g the blended corners
template <int DC>
__device__ __forceinline__ void blend_batch(float (&acc)[32], const uint4 (&buf)[4], const float2 (&wxy)[2],
                                            const float* s_b1, int b, int q) {
  const int c = b / 4, hi = (b / 2) % 2, g = b % 2;
  const int base = q * 16 * DC + 16 * c + 8 * g;
  const float wx = wxy[hi].x, wy = wxy[hi].y;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float top = bf16_at(buf[0], i) * (1.f - wx) + bf16_at(buf[1], i) * wx;
    const float bot = bf16_at(buf[2], i) * (1.f - wx) + bf16_at(buf[3], i) * wx;
    const float gv = top * (1.f - wy) + bot * wy;
    float& a = acc[4 * (4 * g + i / 2) + 2 * hi + (i % 2)];
    a = fmaxf((gv + a) + s_b1[base + i], 0.f);
  }
  // the batch's results are done here, before the next load is issued
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(acc[4 * (4 * g + i / 2) + 2 * hi + (i % 2)]));
}

// One ray's compositing by one warp, two samples a lane: weights into s_w
// (and the probe's output), the depth (E[z] or the weight median) returned
// to every lane.
template <int MODE>
__device__ __forceinline__ float composite_ray(const Params& P, const float* s_out, int ldo, const float* s_z,
                                               float* s_w, int pb, int r, int lane) {
  const int K = P.K;
  float alpha[2], f[2], zk[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int k = 2 * lane + t;
    alpha[t] = 0.f;
    f[t] = 1.f;
    zk[t] = 0.f;
    if (k < K) {
      const float sigma = softplus(s_out[(pb + k) * ldo]);
      zk[t] = s_z[pb + k];
      const float delta = k + 1 < K ? s_z[pb + k + 1] - zk[t] : 1e10f;
      alpha[t] = 1.f - expf(-fabsf(delta) * fmaxf(sigma, 0.f));
      if (P.hard_cap && k == K - 1) alpha[t] = 1.f;
      f[t] = fmaxf(1.f - alpha[t], 1e-10f);
    }
  }
  // transmittance: the exclusive product of the floors, scanned over the lanes' pairs
  float incl = f[0] * f[1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl *= v;
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 1.f;
  const float w0 = alpha[0] * excl, w1 = alpha[1] * (excl * f[0]);
  const int k0 = 2 * lane;
  if (k0 < K) s_w[pb + k0] = w0;
  if (k0 + 1 < K) s_w[pb + k0 + 1] = w1;
  if (MODE == PROBE) {
    if (k0 < K) P.out[(size_t)r * K + k0] = w0;
    if (k0 + 1 < K) P.out[(size_t)r * K + k0 + 1] = w1;
    return 0.f;
  }
  if (!P.median) {
    float d = w0 * zk[0] + w1 * zk[1];
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) d += __shfl_xor_sync(FULL, d, o);
    return d;
  }
  // the median: count the samples whose CDF over the total is below 0.5
  float total = w0 + w1;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) total += __shfl_xor_sync(FULL, total, o);
  const float den = fmaxf(total, 1e-10f);
  float cum = w0 + w1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(FULL, cum, o);
    if (lane >= o) cum += v;
  }
  float before = __shfl_up_sync(FULL, cum, 1);
  if (lane == 0) before = 0.f;
  const float cdf0 = before + w0;
  const unsigned below0 = __ballot_sync(FULL, k0 < K && __fdiv_rn(cdf0, den) < 0.5f);
  const unsigned below1 = __ballot_sync(FULL, k0 + 1 < K && __fdiv_rn(cum, den) < 0.5f);
  const int at = min(__popc(below0) + __popc(below1), K - 1);
  return s_z[pb + at];
}

// Tile `seg` of ray r of K > 64 samples, by one warp, two samples a lane:
// its weights from the transmittance carried in s_carry[0] into s_w[64 seg
// + k] (K3: and out), E[z] and the weight total added to s_carry[1] and
// s_carry[2]; the transmittance carried on. On the ray's last tile (K2) the
// weight median, if asked for, replaces s_carry[1]. The delta of the tile's
// last sample reads the next tile's first depth from memory.
template <int MODE>
__device__ __forceinline__ void composite_segment(const Params& P, const float* s_out, int ldo, const float* s_z,
                                                  float* s_w, float* s_carry, int seg, int r, int lane) {
  const int K = P.K, k0 = seg * TP;
  const float* zr = P.z + (size_t)r * K;
  float alpha[2], f[2], zk[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int p = 2 * lane + t, k = k0 + p;
    alpha[t] = 0.f;
    f[t] = 1.f;
    zk[t] = 0.f;
    if (k < K) {
      const float sigma = softplus(s_out[p * ldo]);
      zk[t] = s_z[p];
      const float znext = p + 1 < TP ? s_z[p + 1] : (k + 1 < K ? __ldg(zr + k + 1) : 0.f);
      const float delta = k + 1 < K ? znext - zk[t] : 1e10f;
      alpha[t] = 1.f - expf(-fabsf(delta) * fmaxf(sigma, 0.f));
      if (P.hard_cap && k == K - 1) alpha[t] = 1.f;
      f[t] = fmaxf(1.f - alpha[t], 1e-10f);
    }
  }
  float incl = f[0] * f[1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl *= v;
  }
  const float carried = s_carry[0];
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 1.f;
  excl *= carried;
  const float w0 = alpha[0] * excl, w1 = alpha[1] * (excl * f[0]);
  const int k = k0 + 2 * lane;
  if (k < K) s_w[k] = w0;
  if (k + 1 < K) s_w[k + 1] = w1;
  if (MODE == PROBE) {
    if (k < K) P.out[(size_t)r * K + k] = w0;
    if (k + 1 < K) P.out[(size_t)r * K + k + 1] = w1;
  }
  float total = w0 + w1, d = w0 * zk[0] + w1 * zk[1];
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    total += __shfl_xor_sync(FULL, total, o);
    d += __shfl_xor_sync(FULL, d, o);
  }
  const float t_next = carried * __shfl_sync(FULL, incl, 31);
  __syncwarp();
  if (lane == 0) {
    s_carry[0] = t_next;
    s_carry[1] += d;
    s_carry[2] += total;
  }
  if (MODE != RENDER || !P.median || k0 + TP < K) return;
  __syncwarp();  // every weight of the ray and its total are in shared memory
  // the median: count the samples whose CDF over the total is below 0.5, 64 at a time
  const float den = fmaxf(s_carry[2], 1e-10f);
  float base = 0.f;
  int count = 0;
  for (int c = 0; c < K; c += TP) {
    const int kc = c + 2 * lane;
    const float v0 = kc < K ? s_w[kc] : 0.f, v1 = kc + 1 < K ? s_w[kc + 1] : 0.f;
    float cum = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(FULL, cum, o);
      if (lane >= o) cum += v;
    }
    cum += base;
    float before = __shfl_up_sync(FULL, cum, 1);
    if (lane == 0) before = base;
    const unsigned below0 = __ballot_sync(FULL, kc < K && __fdiv_rn(before + v0, den) < 0.5f);
    const unsigned below1 = __ballot_sync(FULL, kc + 1 < K && __fdiv_rn(cum, den) < 0.5f);
    count += __popc(below0) + __popc(below1);
    base = __shfl_sync(FULL, cum, 31);
  }
  __syncwarp();
  if (lane == 0) s_carry[1] = __ldg(zr + min(count, K - 1));
}

template <int MODE, int DC, int EC, int ET, int MULTI>
__global__ void __launch_bounds__(PR_WGS * WG, PR_BLOCKS) point_kernel(const Params P) {
  using L = Layout<DC, EC, ET, MULTI>;
  constexpr int EN = EC > 0 ? EC : 1;  // extent of the output accumulators (unused at EC = 0)
  extern __shared__ unsigned char smem_raw[];
  // the first 1024-byte boundary, reached by indexing the shared array (not
  // by integer arithmetic on its address, which leaves a generic pointer:
  // 64-bit addresses and generic loads for every shared-memory access)
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* s_b1 = reinterpret_cast<float*>(sm + L::B1);
  float* s_b2 = reinterpret_cast<float*>(sm + L::B2);
  float* s_cam = reinterpret_cast<float*>(sm + L::CAM);
  const int tid = threadIdx.x;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // weights (hidden units permuted, zero-padded), biases and cameras, once a block
  for (int i = tid; i < DC * 64 * CODE_COLS; i += blockDim.x) {
    const int n = i / CODE_COLS, k = i % CODE_COLS;
    const int ch = hidden_channel<DC>(n);
    *reinterpret_cast<__nv_bfloat16*>(sm + L::WC + (n / 64) * TILE_BYTES + swizzled_offset(n % 64, k) + (k % 8) * 2) =
        (k < P.C && ch < P.D) ? P.w_code[k * P.D + ch] : zero;
  }
  for (int i = tid; i < L::EP * L::DP; i += blockDim.x) {
    const int e = i / L::DP, n = i % L::DP;
    const int ch = hidden_channel<DC>(n);
    const int kt = n / 64, k = n % 64;
    unsigned char* tile = e < 64 * EC ? sm + L::W2 + ((e / 64) * DC + kt) * TILE_BYTES : sm + L::W2T + kt * 1024;
    *reinterpret_cast<__nv_bfloat16*>(tile + swizzled_offset(e % 64, k) + (k % 8) * 2) =
        (e < P.E && ch < P.D) ? P.w2[ch * P.E + e] : zero;
  }
  for (int i = tid; i < L::DP; i += blockDim.x) s_b1[i] = i < P.D ? P.b1[i] : 0.f;
  for (int i = tid; i < L::EP; i += blockDim.x) s_b2[i] = i < P.E ? P.b2[i] : 0.f;
  if (tid < (MODE == RENDER ? 42 : 21)) {
    const int cam = tid / 21, j = tid % 21;
    const float* w2c = cam ? P.color_w2c : P.feat_w2c;
    const float* kmat = cam ? P.color_k : P.feat_k;
    s_cam[tid] = j < 9 ? w2c[(j / 3) * 4 + j % 3] : (j < 12 ? w2c[(j - 9) * 4 + 3] : kmat[j - 12]);
  }
  CodeColumn* s_tab = reinterpret_cast<CodeColumn*>(sm + L::CODE_TAB);
  for (int c = tid; c < CODE_COLS; c += blockDim.x) s_tab[c] = code_column(P, c);
  fence_proxy_async();  // the tiles were written by threads; wgmma reads them
  __syncthreads();

  const int wg = tid / WG, t = tid % WG, warp = t / 32, lane = t % 32, q = lane % 4;
  unsigned char* own = sm + L::WG0 + wg * L::WG_BYTES;
  float* s_out = reinterpret_cast<float*>(own + L::OUT);
  float* s_z = reinterpret_cast<float*>(own + L::Z);
  float* s_w = reinterpret_cast<float*>(own + L::W);
  float* s_rgb = reinterpret_cast<float*>(own + L::RGB);
  float* s_carry = reinterpret_cast<float*>(own + L::CARRY);
  const int row0 = warp * 16 + lane / 4;
  const int K = MODE == QUERY ? 1 : P.K;
  const int rpt = MULTI ? 1 : TP / K;
  const int nseg = MULTI ? (K + TP - 1) / TP : 1;  // tiles a ray
  const int ntiles = (P.R + rpt - 1) / rpt;
  constexpr int NB = 4 * DC;  // corner-load batches of a thread

  unsigned char* code = own + L::CODE;

  for (int tile = blockIdx.x * PR_WGS + wg; tile < ntiles; tile += gridDim.x * PR_WGS) {
    const int ray0 = tile * rpt;
    for (int seg = 0; seg < nseg; ++seg) {
      const uint32_t s0 = fresh(smem_u32(sm));  // the descriptors below are made here, tile by tile
      const uint64_t desc_code = wgmma_desc_at(s0 + (uint32_t)(code - sm));
      int4 idx[2];
      float2 wxy[2];
      float3 in[2];
      setup_row<MODE, MULTI>(P, s_cam, row0, ray0, rpt, seg, q, in[0], idx[0], wxy[0], s_z, s_rgb);
      setup_row<MODE, MULTI>(P, s_cam, row0 + 8, ray0, rpt, seg, q, in[1], idx[1], wxy[1], s_z, s_rgb);
      write_code(P, s_tab, code, row0, q, in);
      fence_proxy_async();  // the code tile was written by threads; wgmma reads it
      named_barrier_sync(1 + wg, WG);

      // chunk by chunk: acc = code W_code (from zero, in flight while the
      // chunk's first corner rows load), then the blend into it, then h. The
      // loads run PR_AHEAD batches ahead through a ring, across chunks.
      constexpr int SLOTS = PR_AHEAD + 1;
      float acc[32];  // one 64-column chunk of the hidden layer
      uint4 buf[SLOTS][4];
  #pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int c = b / 4;
        if (b % 4 == 0) {
  #pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] = 0.f;  // nothing in flight: zeroed here, not live across the tile
          fence_registers(acc);
          wgmma_fence();
  #pragma unroll
          for (int kk = 0; kk < CODE_COLS / 16; ++kk) {
            wgmma_m64n64k16_ss(acc, desc_code + kk * WGMMA_K_STEP,
                               wgmma_desc_at(s0 + L::WC + c * TILE_BYTES) + kk * WGMMA_K_STEP, kk > 0);
          }
          wgmma_commit();
          if (b == 0) {
  #pragma unroll
            for (int a = 0; a < SLOTS && a < NB; ++a) load_batch<DC>(buf[a], P, idx, a, q);
          }
          wgmma_wait<0>();
          fence_registers(acc);
        }
        if (b > 0 && b + PR_AHEAD < NB) load_batch<DC>(buf[(b + PR_AHEAD) % SLOTS], P, idx, b + PR_AHEAD, q);
        blend_batch<DC>(acc, buf[b % SLOTS], wxy, s_b1, b, q);
        if (b % 4 == 3) {
          // chunk c of h to bf16, into its swizzled tile: the A operand of out = h W2
          unsigned char* ht = own + L::H + c * TILE_BYTES;
  #pragma unroll
          for (int j = 0; j < 8; ++j) {
  #pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              *reinterpret_cast<uint32_t*>(ht + swizzled_offset(row0 + 8 * hi, 8 * j) + 4 * q) =
                  pack_bf16(acc[4 * j + 2 * hi], acc[4 * j + 2 * hi + 1]);
            }
          }
        }
      }
      fence_proxy_async();  // h was written by threads; wgmma reads it
      named_barrier_sync(1 + wg, WG);

      // out = h W2 + b2 into the warpgroup's buffer: every 64-column chunk and
      // the 8-column tail in one batch (the buffer lies over h), then written
      const uint32_t h0 = s0 + (uint32_t)(own - sm) + L::H;
      float o[EN][32], ot[4];
  #pragma unroll
      for (int c = 0; c < EN; ++c) {
  #pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
        if (EC > 0) fence_registers(o[c]);
      }
  #pragma unroll
      for (int i = 0; i < 4; ++i) ot[i] = 0.f;
      if (ET > 0) fence_registers(ot);
      wgmma_fence();
  #pragma unroll
      for (int kk = 0; kk < 4 * DC; ++kk) {
        const uint64_t desc_h = wgmma_desc_at(h0 + (kk / 4) * TILE_BYTES) + (kk % 4) * WGMMA_K_STEP;
  #pragma unroll
        for (int c = 0; c < EC; ++c) {
          wgmma_m64n64k16_ss(o[c], desc_h,
                             wgmma_desc_at(s0 + L::W2 + (c * DC + kk / 4) * TILE_BYTES) + (kk % 4) * WGMMA_K_STEP,
                             kk > 0);
        }
        if (ET > 0) {
          wgmma_m64n8k16_ss(ot, desc_h, wgmma_desc_at(s0 + L::W2T + (kk / 4) * 1024) + (kk % 4) * WGMMA_K_STEP,
                            kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
  #pragma unroll
      for (int c = 0; c < EC; ++c) fence_registers(o[c]);
      if (ET > 0) fence_registers(ot);
  #pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float* row = s_out + (row0 + 8 * hi) * L::LDO;
  #pragma unroll
        for (int c = 0; c < EC; ++c) {
  #pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * c + 8 * j + 2 * q;
            *reinterpret_cast<float2*>(row + col) =
                make_float2(o[c][4 * j + 2 * hi] + s_b2[col], o[c][4 * j + 2 * hi + 1] + s_b2[col + 1]);
          }
        }
        if (ET > 0) {
          const int col = 64 * EC + 2 * q;
          *reinterpret_cast<float2*>(row + col) = make_float2(ot[2 * hi] + s_b2[col], ot[2 * hi + 1] + s_b2[col + 1]);
        }
      }
      named_barrier_sync(1 + wg, WG);

      if (MODE == QUERY) {
        // sigma and the feature rows of the tile's points: a warp a row, coalesced
        const int E = P.E;
        for (int p = warp; p < TP && ray0 + p < P.R; p += WG / 32) {
          const int r = ray0 + p;
          for (int e = lane; e < E; e += 32) {
            const float v = s_out[p * L::LDO + e];
            if (e == 0) {
              P.out[r] = softplus(v);
            } else {
              P.dino[(size_t)r * (E - 1) + e - 1] = v;
            }
          }
        }
      } else if constexpr (!MULTI) {
        for (int rl = warp; rl < rpt; rl += WG / 32) {
          const int r = ray0 + rl;
          if (r >= P.R) break;
          const float depth = composite_ray<MODE>(P, s_out, L::LDO, s_z, s_w, rl * K, r, lane);
          if (MODE == RENDER && lane == 0) P.depth[r] = depth;
        }
        if (MODE == RENDER) {
          named_barrier_sync(1 + wg, WG);
          // the weighted feature and colour, one output a thread
          const int F = P.E - 1, NO = F + 3;
          for (int i = t; i < rpt * NO; i += WG) {
            const int rl = i / NO, col = i - rl * NO;
            const int r = ray0 + rl;
            if (r >= P.R) break;
            const int pb = rl * K;
            float sum = 0.f;
            if (col < F) {
              for (int k = 0; k < K; ++k) sum += s_w[pb + k] * s_out[(pb + k) * L::LDO + 1 + col];
              P.dino[(size_t)r * F + col] = sum;
            } else {
              for (int k = 0; k < K; ++k) sum += s_w[pb + k] * s_rgb[(pb + k) * 3 + col - F];
              P.rgb[(size_t)r * 3 + col - F] = sum;
            }
          }
        }
      } else {
        // tile `seg` of a ray of K > 64 samples
        const int F = P.E - 1, NO = MODE == RENDER ? F + 3 : 0;
        if (seg == 0) {
          for (int i = t; i < 3 + NO; i += WG) s_carry[i] = i == 0 ? 1.f : 0.f;
          named_barrier_sync(1 + wg, WG);
        }
        if (warp == 0) composite_segment<MODE>(P, s_out, L::LDO, s_z, s_w, s_carry, seg, ray0, lane);
        if (MODE == RENDER) {
          named_barrier_sync(1 + wg, WG);
          // the tile's weighted feature and colour added to the ray's sums, one output a thread
          const int k0 = seg * TP, n = min(TP, K - k0);
          const bool last = k0 + TP >= K;
          for (int col = t; col < NO; col += WG) {
            float sum = s_carry[3 + col];
            if (col < F) {
              for (int p = 0; p < n; ++p) sum += s_w[k0 + p] * s_out[p * L::LDO + 1 + col];
            } else {
              for (int p = 0; p < n; ++p) sum += s_w[k0 + p] * s_rgb[p * 3 + col - F];
            }
            if (!last) {
              s_carry[3 + col] = sum;
            } else if (col < F) {
              P.dino[(size_t)ray0 * F + col] = sum;
            } else {
              P.rgb[(size_t)ray0 * 3 + col - F] = sum;
            }
          }
          if (last && t == 0) P.depth[ray0] = s_carry[1];
        }
      }

      named_barrier_sync(1 + wg, WG);  // the buffers are free for the next tile
    }
  }
}

struct Cached {
  bool ready = false;
  int blocks = 0;  // blocks a launch: blocks an SM times SMs
};

template <int MODE, int DC, int EC, int ET, int MULTI>
int launch_shape(const Params& P, void* stream) {
  const auto kernel = point_kernel<MODE, DC, EC, ET, MULTI>;
  constexpr int smem = Layout<DC, EC, ET, MULTI>::TOTAL + 1024;  // room to align the tiles
  static Cached cached[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  Cached& c = cached[dev];
  if (!c.ready) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess) {
      return (int)err;
    }
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PR_WGS * WG, smem);
    if (err != cudaSuccess) return (int)err;
    c.blocks = (per_sm > 0 ? per_sm : 1) * sms;
    c.ready = true;
  }
  const int K = MODE == QUERY ? 1 : P.K;
  const int rpt = K > TP ? 1 : TP / K;
  const int ntiles = (P.R + rpt - 1) / rpt;
  int blocks = (ntiles + PR_WGS - 1) / PR_WGS;
  if (blocks > c.blocks) blocks = c.blocks;
  kernel<<<blocks, PR_WGS * WG, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// the hidden width to 64 or 128, the output width to 64 + 8 (E <= 72), 128, or 8 (K3's density column)
template <int MODE, int MULTI>
int launch(const Params& P, void* stream) {
  if constexpr (MODE == PROBE) {
    return P.D <= 64 ? launch_shape<MODE, 1, 0, 8, MULTI>(P, stream) : launch_shape<MODE, 2, 0, 8, MULTI>(P, stream);
  } else {
    if (P.D <= 64) {
      return P.E <= 72 ? launch_shape<MODE, 1, 1, 8, MULTI>(P, stream) : launch_shape<MODE, 1, 2, 0, MULTI>(P, stream);
    }
    return P.E <= 72 ? launch_shape<MODE, 2, 1, 8, MULTI>(P, stream) : launch_shape<MODE, 2, 2, 0, MULTI>(P, stream);
  }
}

// the one-tile walk up to 64 samples a ray, the multi-tile walk past it (K4: one point, one tile)
template <int MODE>
int launch(const Params& P, void* stream) {
  if constexpr (MODE == QUERY) {
    return launch<MODE, 0>(P, stream);
  } else {
    return P.K > TP ? launch<MODE, 1>(P, stream) : launch<MODE, 0>(P, stream);
  }
}

// ------------------------------------------------------------ the wide walk
// (csrc/wide_walk.cuh): every shape the instantiations above do not take

struct Wide {
  const unsigned char* packed;  // the packed weight units
  unsigned char* scratch;       // a block's share: the ray's weights (MULTI), then the A store if not in shared memory
  long long scratch_block;      // bytes of a block's share
  int DC, CT, EC, NU;           // hidden chunks, code tiles, output chunks (64 each); units a tile
  int ldc, ldh;                 // row strides (elements) of the code and h stores
  int a_shared, weights_bytes;  // the A store in shared memory; bytes of the weights in a block's share
};

// shared memory of a wide block: the ring, the output buffer of one 64-column
// chunk, depths, weights, colours, the carried state, cameras, the A store
struct WideLayout {
  static constexpr int RING = 0;
  static constexpr int OUT = RING + wide::SLOTS * TILE_BYTES;
  static constexpr int Z = OUT + TP * wide::LDO * 4;
  static constexpr int W = Z + TP * 4;
  static constexpr int RGB = W + TP * 4;
  static constexpr int CARRY = RGB + TP * 3 * 4;
  static constexpr int CAM = CARRY + 64;
  static constexpr int A = (CAM + 48 * 4 + 127) / 128 * 128;
};

// code column c at any code width: code_column's, the frequency f_0 2^f for any f
__device__ inline CodeColumn wide_code_column(const Params& P, int c) {
  if (c >= P.C) return {0.f, 0.f, 6};
  if (P.include_input) {
    if (c < 3) return {0.f, 0.f, 3 + c};
    c -= 3;
  }
  const int f = c / 6, rem = c - 6 * f, s = rem / 3;
  return {ldexpf(P.freq_factor, f), s ? HALF_PI : 0.f, rem - 3 * s};
}

// channels [ch, ch + 8) of grid row `row`, zeros past D: one 16-byte load
// where D is a multiple of 8 (`vec`), else element by element
__device__ __forceinline__ uint4 wide_grid8(const Params& P, int vec, int row, int ch) {
  const __nv_bfloat16* p = P.grid + (size_t)row * P.D + ch;
  if (vec) return ch < P.D ? load16(p) : make_uint4(0u, 0u, 0u, 0u);
  const unsigned short* e = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = ch + 2 * i < P.D ? __ldg(e + 2 * i) : 0u, hi = ch + 2 * i + 1 < P.D ? __ldg(e + 2 * i + 1) : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One block, one warpgroup, one 64-point tile at a time (a ray's segment of
// 64 samples where MULTI): the point set-up of the shipped kernels; the code
// into the code store; per hidden chunk its corner rows (in flight during
// the chunk's code product), the code product over the code tiles, the
// blend, relu and bf16 into the h store; then per 64-column output chunk the
// product over the hidden k-tiles into the output buffer. The first chunk
// holds the density column: the compositing (composite_ray, or
// composite_segment with the ray's weights in the block's scratch) runs
// there, and every chunk's weighted columns are summed into the outputs
// (across a ray's segments through the outputs themselves).
template <int MODE, int MULTI>
__global__ void __launch_bounds__(wide::WG, 2) point_wide_kernel(const Params P, const Wide Wd) {
  using L = WideLayout;
  constexpr int LDO = wide::LDO;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* s_out = reinterpret_cast<float*>(sm + L::OUT);
  float* s_z = reinterpret_cast<float*>(sm + L::Z);
  float* s_w = reinterpret_cast<float*>(sm + L::W);
  float* s_rgb = reinterpret_cast<float*>(sm + L::RGB);
  float* s_carry = reinterpret_cast<float*>(sm + L::CARRY);
  float* s_cam = reinterpret_cast<float*>(sm + L::CAM);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, q = lane % 4;
  const int row0 = warp * 16 + lane / 4;
  if (t < (MODE == RENDER ? 42 : 21)) {
    const int cam = t / 21, j = t % 21;
    const float* w2c = cam ? P.color_w2c : P.feat_w2c;
    const float* kmat = cam ? P.color_k : P.feat_k;
    s_cam[t] = j < 9 ? w2c[(j / 3) * 4 + j % 3] : (j < 12 ? w2c[(j - 9) * 4 + 3] : kmat[j - 12]);
  }
  unsigned char* mine = Wd.scratch + (size_t)blockIdx.x * Wd.scratch_block;
  float* g_w = reinterpret_cast<float*>(mine);  // MULTI: the ray's weights
  __nv_bfloat16* code = reinterpret_cast<__nv_bfloat16*>(Wd.a_shared ? sm + L::A : mine + Wd.weights_bytes);
  __nv_bfloat16* h = code + TP * Wd.ldc;
  const int DC = Wd.DC, CT = Wd.CT, EC = Wd.EC, D = P.D, E = P.E, F = E - 1, vec = P.D % 8 == 0;
  const int K = MODE == QUERY ? 1 : P.K;
  const int rpt = MULTI ? 1 : TP / K;
  const int nseg = MULTI ? (K + TP - 1) / TP : 1;
  const int ntiles = (P.R + rpt - 1) / rpt;
  const wide::Ring ring{sm + L::RING, Wd.packed, (uint32_t)Wd.NU, TILE_BYTES};
  wide::ring_start(ring, t);
  __syncthreads();  // the cameras
  uint32_t g = 0;   // units taken

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int ray0 = tile * rpt;
    for (int seg = 0; seg < nseg; ++seg) {
      int4 idx[2];
      float2 wxy[2];
      float3 in[2];
      setup_row<MODE, MULTI>(P, s_cam, row0, ray0, rpt, seg, q, in[0], idx[0], wxy[0], s_z, s_rgb);
      setup_row<MODE, MULTI>(P, s_cam, row0 + 8, ray0, rpt, seg, q, in[1], idx[1], wxy[1], s_z, s_rgb);
      // the code in bf16: columns 8 m + 2 q and the next of rows r and r + 8, zero past C
      for (int c = 2 * q; c < 64 * CT; c += 8) {
        const CodeColumn c0 = wide_code_column(P, c), c1 = wide_code_column(P, c + 1);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          *reinterpret_cast<uint32_t*>(code + (size_t)(row0 + 8 * hi) * Wd.ldc + c) =
              pack_bf16(code_value(c0, in[hi].x, in[hi].y, in[hi].z), code_value(c1, in[hi].x, in[hi].y, in[hi].z));
        }
      }

      // h = bf16(relu((g + code W_code) + b1)), 64 hidden units at a time
      for (int c = 0; c < DC; ++c) {
        uint4 buf[2][2][4];  // row r + 8 hi, channel group, corner
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
          for (int gq = 0; gq < 2; ++gq) {
#pragma unroll
            for (int corner = 0; corner < 4; ++corner) {
              buf[hi][gq][corner] = wide_grid8(P, vec, corner_row(idx[hi], corner), q * 16 * DC + 16 * c + 8 * gq);
            }
          }
        }
        float acc[32];
        for (int s = 0; s < CT; ++s) {
          wide::unit_bf16(acc, code, Wd.ldc, 64 * s, wide::ring_take(ring, g++, t), row0, q, s > 0);
        }
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const float wx = wxy[hi].x, wy = wxy[hi].y;
#pragma unroll
          for (int gq = 0; gq < 2; ++gq) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int ch = q * 16 * DC + 16 * c + 8 * gq + i;
              const uint4(&b)[4] = buf[hi][gq];
              const float top = bf16_at(b[0], i) * (1.f - wx) + bf16_at(b[1], i) * wx;
              const float bot = bf16_at(b[2], i) * (1.f - wx) + bf16_at(b[3], i) * wx;
              const float gv = top * (1.f - wy) + bot * wy;
              float& a = acc[4 * (4 * gq + i / 2) + 2 * hi + (i % 2)];
              a = fmaxf((gv + a) + (ch < D ? __ldg(P.b1 + ch) : 0.f), 0.f);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            *reinterpret_cast<uint32_t*>(h + (size_t)(row0 + 8 * hi) * Wd.ldh + 64 * c + 8 * j + 2 * q) =
                pack_bf16(acc[4 * j + 2 * hi], acc[4 * j + 2 * hi + 1]);
          }
        }
      }

      // out = h W2 + b2, 64 columns at a time; the density column's chunk first
      for (int j = 0; j < EC; ++j) {
        float o[32];
        for (int kt = 0; kt < DC; ++kt) {
          wide::unit_bf16(o, h, Wd.ldh, 64 * kt, wide::ring_take(ring, g++, t), row0, q, kt > 0);
        }
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int col = 8 * jj + 2 * q, e = 64 * j + col;
            *reinterpret_cast<float2*>(s_out + (row0 + 8 * hi) * LDO + col) =
                make_float2(o[4 * jj + 2 * hi] + (e < E ? __ldg(P.b2 + e) : 0.f),
                            o[4 * jj + 2 * hi + 1] + (e + 1 < E ? __ldg(P.b2 + e + 1) : 0.f));
          }
        }
        __syncthreads();

        if (MODE == QUERY) {
          // sigma and the feature rows of the chunk's columns: a warp a point, coalesced
          for (int p = warp; p < TP && ray0 + p < P.R; p += wide::WG / 32) {
            const int r = ray0 + p;
            for (int cl = lane; cl < 64; cl += 32) {
              const int e = 64 * j + cl;
              const float v = s_out[p * LDO + cl];
              if (e == 0) {
                P.out[r] = softplus(v);
              } else if (e < E) {
                P.dino[(size_t)r * F + e - 1] = v;
              }
            }
          }
        } else {
          const int k0 = seg * TP, n = min(TP, K - k0);
          if (j == 0) {
            if constexpr (!MULTI) {
              for (int rl = warp; rl < rpt; rl += wide::WG / 32) {
                const int r = ray0 + rl;
                if (r >= P.R) break;
                const float depth = composite_ray<MODE>(P, s_out, LDO, s_z, s_w, rl * K, r, lane);
                if (MODE == RENDER && lane == 0) P.depth[r] = depth;
              }
            } else {
              if (seg == 0 && t < 3) s_carry[t] = t == 0 ? 1.f : 0.f;
              __syncthreads();
              if (warp == 0) composite_segment<MODE>(P, s_out, LDO, s_z, g_w, s_carry, seg, ray0, lane);
            }
            __syncthreads();
            if (MODE == RENDER) {
              // the weighted colour, one output a thread
              if constexpr (!MULTI) {
                for (int i = t; i < rpt * 3; i += wide::WG) {
                  const int rl = i / 3, ch = i - 3 * rl, r = ray0 + rl, pb = rl * K;
                  if (r >= P.R) break;
                  float sum = 0.f;
                  for (int k = 0; k < K; ++k) sum += s_w[pb + k] * s_rgb[(pb + k) * 3 + ch];
                  P.rgb[(size_t)r * 3 + ch] = sum;
                }
              } else if (t < 3) {
                float sum = seg ? P.rgb[(size_t)ray0 * 3 + t] : 0.f;
                for (int p = 0; p < n; ++p) sum += g_w[k0 + p] * s_rgb[p * 3 + t];
                P.rgb[(size_t)ray0 * 3 + t] = sum;
                if (t == 0 && k0 + TP >= K) P.depth[ray0] = s_carry[1];
              }
            }
          }
          if (MODE == RENDER) {
            // the chunk's weighted feature columns, one output a thread
            if constexpr (!MULTI) {
              for (int i = t; i < rpt * 64; i += wide::WG) {
                const int rl = i / 64, cl = i % 64, f = 64 * j + cl - 1, r = ray0 + rl, pb = rl * K;
                if (r >= P.R) break;
                if (f < 0 || f >= F) continue;
                float sum = 0.f;
                for (int k = 0; k < K; ++k) sum += s_w[pb + k] * s_out[(pb + k) * LDO + cl];
                P.dino[(size_t)r * F + f] = sum;
              }
            } else {
              for (int cl = t; cl < 64; cl += wide::WG) {
                const int f = 64 * j + cl - 1;
                if (f < 0 || f >= F) continue;
                float sum = seg ? P.dino[(size_t)ray0 * F + f] : 0.f;
                for (int p = 0; p < n; ++p) sum += g_w[k0 + p] * s_out[p * LDO + cl];
                P.dino[(size_t)ray0 * F + f] = sum;
              }
            }
          }
        }
        __syncthreads();  // the output buffer, depths, weights and colours are free
      }
    }
  }
  cp_async_wait<0>();
}

// the wide walk's shapes, shared memory, blocks and buffers for one launch
struct WidePlan {
  Wide W;
  int smem, blocks;
  long long packed_bytes, scratch_bytes;
};

template <int MODE, int MULTI>
int wide_plan(const Params& P, WidePlan& pl) {
  static bool ready[MAX_DEVICES];
  static int sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sms[dev] && (err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return (int)err;
  }
  Wide& W = pl.W;
  W.DC = (P.D + 63) / 64;
  W.CT = (P.C + 63) / 64;
  W.EC = (P.E + 63) / 64;
  W.NU = W.DC * W.CT + W.EC * W.DC;
  W.ldc = 64 * W.CT + 8;  // = 4 words mod 32: the A fragments' loads meet no bank twice
  W.ldh = 64 * W.DC + 8;
  const long long a_bytes = wide::round_up(2LL * TP * (W.ldc + W.ldh), 256);
  W.a_shared = WideLayout::A + a_bytes <= wide::SHARED_BUDGET;
  const int K = MODE == QUERY ? 1 : P.K;
  W.weights_bytes = MULTI ? (int)wide::round_up(4LL * K, 256) : 0;
  W.scratch_block = W.weights_bytes + (W.a_shared ? 0 : a_bytes);
  pl.smem = WideLayout::A + (W.a_shared ? (int)a_bytes : 0) + 1024;  // room to align the ring
  int per_sm = 0;
  if (int e = wide::blocks_per_sm(point_wide_kernel<MODE, MULTI>, pl.smem, ready[dev], per_sm)) return e;
  const long long most = (long long)per_sm * sms[dev];
  const int rpt = MULTI ? 1 : TP / K;
  const long long ntiles = ((long long)P.R + rpt - 1) / rpt;
  pl.blocks = (int)(ntiles < most ? ntiles : most);
  pl.packed_bytes = (long long)W.NU * TILE_BYTES;
  pl.scratch_bytes = W.scratch_block * most;  // for the most blocks a launch takes
  return 0;
}

template <int MODE, int MULTI>
int launch_wide(const Params& P, void* packed, void* scratch, void* stream) {
  WidePlan pl;
  if (int err = wide_plan<MODE, MULTI>(P, pl)) return err;
  if (!packed || (pl.scratch_bytes && !scratch)) return (int)cudaErrorInvalidValue;
  pl.W.packed = static_cast<const unsigned char*>(packed);
  pl.W.scratch = static_cast<unsigned char*>(scratch);
  const long long elements = (long long)pl.W.NU * 64 * 64;
  const int pack_blocks = (int)(elements / 256 < 1024 ? (elements + 255) / 256 : 1024);
  wide::pack_units<0, 1><<<pack_blocks, 256, 0, (cudaStream_t)stream>>>(
      P.w_code, P.w2, P.D, P.E, P.C, pl.W.DC, pl.W.CT, pl.W.DC, pl.W.NU, static_cast<unsigned char*>(packed));
  point_wide_kernel<MODE, MULTI><<<pl.blocks, wide::WG, pl.smem, (cudaStream_t)stream>>>(P, pl.W);
  return (int)cudaGetLastError();
}

// the shipped instantiations where they take the shape, else the wide walk
template <int MODE>
bool shipped(const Params& P) {
  return P.D <= 128 && P.D % 8 == 0 && P.E <= 128 && P.C <= CODE_COLS && (MODE == QUERY || P.K <= KMAX);
}

template <int MODE>
int launch_any(const Params& P, void* packed, void* scratch, void* stream) {
  if (shipped<MODE>(P)) return launch<MODE>(P, stream);
  if constexpr (MODE == QUERY) {
    return launch_wide<MODE, 0>(P, packed, scratch, stream);
  } else {
    return P.K > TP ? launch_wide<MODE, 1>(P, packed, scratch, stream) : launch_wide<MODE, 0>(P, packed, scratch, stream);
  }
}

template <int MODE>
int wide_bytes(const Params& P, long long* packed, long long* scratch) {
  *packed = *scratch = 0;
  if (shipped<MODE>(P)) return 0;
  WidePlan pl;
  int err;
  if constexpr (MODE == QUERY) {
    err = wide_plan<MODE, 0>(P, pl);
  } else {
    err = P.K > TP ? wide_plan<MODE, 1>(P, pl) : wide_plan<MODE, 0>(P, pl);
  }
  if (err) return err;
  *packed = pl.packed_bytes;
  *scratch = pl.scratch_bytes;
  return 0;
}

bool bad_field(int R, int K, int D, int E, int C, int num_freqs, int include_input, int min_e) {
  return R <= 0 || K <= 0 || D <= 0 || E < min_e || C <= 0 || C != 3 * (include_input ? 1 : 0) + 6 * num_freqs;
}

}  // namespace

// Pointers are device pointers on the current device; the wrappers check
// dtypes, shapes, contiguity and the grid's 16-byte alignment. Each returns
// a cudaError_t (0 = launched). `packed` and `scratch` are the wide walk's
// buffers, of the sizes point_wide_bytes gives (null where it gives 0).
extern "C" int point_render(
    const void* rays, const void* z, const void* grid, const void* w_code, const void* b1,
    const void* w2, const void* b2, const void* feat_w2c, const void* feat_k,
    const void* color, const void* color_w2c, const void* color_k,
    void* depth, void* dino, void* rgb, void* packed, void* scratch,
    int R, int K, int Hg, int Wg, int D, int E, int C, int Hc, int Wc,
    int num_freqs, int include_input, int inv_z, int code_distance, int hard_cap, int median,
    float zn_sub, float zn_scale, float freq_factor, void* stream) {
  if (bad_field(R, K, D, E, C, num_freqs, include_input, 2)) return (int)cudaErrorInvalidValue;
  Params P = {(const float*)rays, (const float*)z, (const __nv_bfloat16*)grid,
              (const __nv_bfloat16*)w_code, (const float*)b1, (const __nv_bfloat16*)w2,
              (const float*)b2, (const float*)feat_w2c, (const float*)feat_k,
              (const __nv_bfloat16*)color, (const float*)color_w2c, (const float*)color_k,
              (float*)depth, (float*)dino, (float*)rgb, nullptr,
              R, K, Hg, Wg, D, E, C, Hc, Wc,
              num_freqs, include_input, inv_z, code_distance, hard_cap, median,
              zn_sub, zn_scale, freq_factor};
  return launch_any<RENDER>(P, packed, scratch, stream);
}

// K3: w2 (D, 1) and b2 (1,) are the density column alone; writes the
// compositing weights (R, K).
extern "C" int probe_weights(
    const void* rays, const void* z, const void* grid, const void* w_code, const void* b1,
    const void* w2, const void* b2, const void* feat_w2c, const void* feat_k, void* weights, void* packed,
    void* scratch, int R, int K, int Hg, int Wg, int D, int C,
    int num_freqs, int include_input, int inv_z, int code_distance, int hard_cap,
    float zn_sub, float zn_scale, float freq_factor, void* stream) {
  if (bad_field(R, K, D, 1, C, num_freqs, include_input, 1)) return (int)cudaErrorInvalidValue;
  Params P = {(const float*)rays, (const float*)z, (const __nv_bfloat16*)grid,
              (const __nv_bfloat16*)w_code, (const float*)b1, (const __nv_bfloat16*)w2,
              (const float*)b2, (const float*)feat_w2c, (const float*)feat_k,
              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, (float*)weights,
              R, K, Hg, Wg, D, 1, C, 0, 0,
              num_freqs, include_input, inv_z, code_distance, hard_cap, 0,
              zn_sub, zn_scale, freq_factor};
  return launch_any<PROBE>(P, packed, scratch, stream);
}

// K4: points (R, 3); writes sigma (R,) and the feature (R, E - 1).
extern "C" int point_query(
    const void* pts, const void* grid, const void* w_code, const void* b1, const void* w2,
    const void* b2, const void* feat_w2c, const void* feat_k, void* sigma, void* feat, void* packed, void* scratch,
    int R, int Hg, int Wg, int D, int E, int C,
    int num_freqs, int include_input, int inv_z, int code_distance,
    float zn_sub, float zn_scale, float freq_factor, void* stream) {
  if (bad_field(R, 1, D, E, C, num_freqs, include_input, 2)) return (int)cudaErrorInvalidValue;
  Params P = {(const float*)pts, nullptr, (const __nv_bfloat16*)grid,
              (const __nv_bfloat16*)w_code, (const float*)b1, (const __nv_bfloat16*)w2,
              (const float*)b2, (const float*)feat_w2c, (const float*)feat_k,
              nullptr, nullptr, nullptr, nullptr, (float*)feat, nullptr, (float*)sigma,
              R, 1, Hg, Wg, D, E, C, 0, 0,
              num_freqs, include_input, inv_z, code_distance, 0, 0,
              zn_sub, zn_scale, freq_factor};
  return launch_any<QUERY>(P, packed, scratch, stream);
}

// The bytes of the wide walk's packed weights and scratch for a launch of
// `mode` (0 K2, 1 K3, 2 K4; K3 with E = 1, K4 with K = 1) on the current
// device: both 0 where the shipped instantiations take the shape.
extern "C" int point_wide_bytes(int mode, int R, int K, int D, int E, int C, long long* packed, long long* scratch) {
  Params P = {};
  P.R = R;
  P.K = K;
  P.D = D;
  P.E = E;
  P.C = C;
  if (mode == RENDER) return wide_bytes<RENDER>(P, packed, scratch);
  if (mode == PROBE) return wide_bytes<PROBE>(P, packed, scratch);
  return wide_bytes<QUERY>(P, packed, scratch);
}
