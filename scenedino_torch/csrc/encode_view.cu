// K6: the encode-view render, fused per sample, on the tensor cores.
//
// Replaces scenedino_tpu/ops/fast_field.py:254 `render_encode_view` (and
// its vmap `render_encode_view_batched`, :225), XLA in the reference: the
// render of the encode camera's own view, where every sample of pixel p's
// ray projects back to p, so the folded feature grid is read once a pixel
// and nothing is looked up per sample. The port's preamble (per pixel, in
// torch: the grid's 2x2 mean or NDC lookup, the x/y code folded into a
// bias, b1, the sample depths and each ray's camera-z factor) hands this
// kernel, per ray r of N = B x H x W and per sample k < K:
//
//   base_r (D)   = grid_r + code_xy_r @ W_xy + b1, fp32
//   z_rk         = the sample's ray distance, sorted along k
//   zscale_r     = camera z per unit of distance (1 for code_mode distance)
//
// and the kernel computes, per sample,
//   zn  = fma(1 / max(z zscale, 1e-3) - 1/far, 2 / (1/near - 1/far), -1)
//         with the constants in float32 (jitted XLA's folding of the JAX
//         package's normalize_z; or the linear normalization without inv_z),
//   code = [zn?, sin(f_0 zn), sin(f_0 zn + pi/2), sin(f_1 zn), ...]
//         (13 columns at 6 frequencies with the input; sinf, not __sinf:
//         the arguments reach ~100 rad),
//   h   = relu(base + code @ W_z),  out = h @ W2 + b2,
// then along the ray: sigma = softplus(out[0]), alpha compositing with
// the max(1 - a, 1e-10) floor and the optional hard cap on the last
// sample, depth = E[z] or the weight median, the weighted feature
// sum_k w_k out_k[1:], and rgb = colour_r x sum_k w_k. Only the per-ray
// outputs reach memory: the plain version's (N, K, D) and (N, K, E)
// intermediates (2 GB for one 192x640 frame at d_hidden 128) never exist.
//
// Types: the state's dtype.
//   * bf16 (serving): W_z and W2 are bf16, the code and h are rounded to
//     bf16 before their products, sums in fp32: what the plain version
//     computes, since a bf16 x bf16 product is exact in fp32. Both products
//     are bf16 wgmma.
//   * fp32 (stage 2's fold): both products as three TF32 passes (3xTF32):
//     x = x_hi + x_lo with x_hi = tf32(x), x_lo = tf32(x - x_hi) (round to
//     nearest), for the code and h on the A side and W_z and W2 on the B
//     side, and x y = x_hi y_hi + x_hi y_lo + x_lo y_hi, each a TF32 wgmma
//     into one fp32 accumulator. The dropped x_lo y_lo and the splits'
//     residues are ~2^-22 of a product: fp32's accuracy, where one TF32 pass
//     keeps ~2^-11 (tests/test_torch_encode_view.py shows both against the
//     fp32 bounds). The 13-term code product takes the three passes too.
//
// Bound on the H100 at 192x640 x 32 samples, d_hidden 128, d_out 65: 9,984
// multiply-adds a sample (13 x 128 + 128 x 65), 78.5 GFLOP a frame; 111 MB
// moved (base 62.9 MB, z 15.7 MB, outputs 32.4 MB). Operations bound it:
// bf16 at the tensor cores' 989 TFLOP/s (0.079 ms a frame); the fp32 state's
// three passes at TF32's 495 TFLOP/s (0.476 ms a frame; 1.17 ms at the
// 67 TFLOP/s of fp32 outside the tensor cores).
//
// Design (Hopper: wgmma; hopper.cuh):
//   * A warpgroup owns a 64-row tile of samples (wgmma's M = 64): a ray's K
//     samples padded with dead rows to Kp, the next of 8, 16, 32 and 64,
//     and 64 / Kp rays a tile. Blocks are persistent, four warpgroups each
//     (one block an SM, 128 registers a thread), and hold W_z and W2 in
//     shared memory for their whole life as 128-byte-swizzled K-major tiles,
//     zero-padded (code columns to 16, hidden units to 64 or 128, outputs
//     to 64 + 8 or to 24): bf16, or the hi and lo TF32 copies of each
//     (214 KB at d_hidden 128 with the warpgroups' buffers).
//   * Each tile's base rows, depths and z factors arrive by cp.async into
//     one of two buffers while the tile before it computes.
//   * A thread holds rows r and r + 8 of the tile's accumulators. It forms
//     the z code of its two rows in exactly the A fragment's columns (bf16:
//     2q, 2q + 1, 2q + 8, 2q + 9; TF32: q, q + 4, 8 + q, 12 + q, q = lane % 4;
//     no column twice). The code product is one k16 bf16 wgmma a 64-column
//     hidden chunk, or two k8 steps of three TF32 passes (m64n32k8) a
//     32-column half chunk.
//   * The thread adds its rows' base values, applies relu, and rounds h to
//     bf16 (pack_bf16 at a_index) or splits it into TF32 hi and lo; that is
//     the A operand of out = h W2 (register-A wgmma): h never touches shared
//     memory. TF32's A fragment takes columns t and t + 4 of a k-step where
//     the accumulator holds 2t and 2t + 1: W2's rows are permuted within
//     each group of 8 as they are copied in (tf32_k_column).
//   * Registers set the time: the walk is a chain of dependent steps (the
//     copies' wait, sinf, wgmma waits, barriers, shuffle scans), and more
//     warpgroups an SM hide more of it (three, at 168 registers, ran slower
//     on an H100). What keeps four within 128 registers without a spill:
//     the TF32 path's 32-column halves (16 registers of code product and 32
//     of h's hi and lo at a time), each wgmma's descriptor made where it is
//     issued (desc), the tile counters in 32 bits, and divisions by a
//     reciprocal multiply (quotient) or a shift (Kp).
//   * out + b2 goes through a 64-row fp32 buffer in shared memory. One warp
//     composites one ray, two samples a lane: the transmittance as an
//     exclusive product scan by shuffles, the depth and the weight total as
//     butterfly sums, the median's CDF as a prefix sum and its index as a
//     count of ballots; dead rows carry weight 0. The weights return through
//     shared memory and each thread forms one weighted feature sum, so a
//     ray's row goes out coalesced.
//   * A ray of K > 64 samples spans ceil(K / 64) tiles of one ray each
//     (samples [64 s, 64 s + 64) in tile s, the rows past K dead), which the
//     same warpgroup walks in order; the copies of a ray's next tile (its
//     base row again, 64 depths) land while this one computes, as between
//     rays. One warp composites a tile from the transmittance the ray's
//     earlier tiles left (a tile's last delta reads the next tile's first
//     depth from memory), and the threads add the tile's weighted feature
//     to the ray's running sums. The transmittance, E[z], the weight total
//     and the feature sums are carried in the warpgroup's shared memory (the
//     registers have nothing to spare); for the weight median the ray's
//     weights stay there until its last tile, which counts the samples whose
//     CDF over the total is below 0.5, 64 at a time. That array bounds these
//     instantiations: MAX_K = 256 samples a ray (1 KB a warpgroup, within the
//     227 KB of the fp32 state at d_hidden 128). K <= 64 keeps the packed tiles,
//     in instantiations of their own (MULTI = 0) built as they were before
//     the multi-tile walk: with one kernel for both, the one-tile walk ran
//     12 % slower on an H100 (the serving frame, 0.808 against 0.718 ms).
//     The multi-tile instantiations run three warpgroups a block (168
//     registers a thread; `warpgroups`).
//   * A z code of more than 16 columns (num_freqs 8-15 with the input, up to
//     32) takes one more k16 step of the code product (bf16), or two more k8
//     steps of three TF32 passes, whose A fragments are formed where each
//     half chunk issues them (held for the whole tile they would not fit in
//     128 registers). It is an instantiation of its own (CS = 2), so that the
//     16-column kernels' products stay as they were, at three warpgroups a
//     block as the multi-tile walk's.
//   * The host side caches the shared-memory attribute, the SM count and
//     the blocks an SM per device: a launch is the launch alone.
// The state's type, the code's k16 steps, the walk (one tile a ray or
// several), the hidden chunks and the output layout are template arguments:
// thirty-two instantiations, for K <= 256, D <= 128, E <= 68 and a z code
// of at most 32 columns (`shipped`). Every other shape runs the wide walk
// (csrc/wide_walk.cuh; `encode_wide_kernel` below), whose weights no longer
// fit resident (W2 alone is 787 KB in bf16 at d_hidden 512 and 769 outputs,
// 1.57 MB as the fp32 state's hi and lo copies): they stream from L2
// through a ring in shared memory; the z code and h sit in a row-major
// store, from which each product loads its A fragment (bf16, or fp32 split
// into TF32 hi and lo there, three passes kept); the output goes in chunks
// of 64 columns, the density column's chunk first; a ray's weights for the
// median in global scratch. Four instantiations (the state's type by walk),
// chosen on the host, so the thirty-two keep their code.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wide_walk.cuh"

namespace {

using namespace hopper;

constexpr int TP = 64;          // sample rows a tile: wgmma's M
constexpr int WG = 128;         // threads a warpgroup
constexpr int WGS = 4;          // warpgroups a block, one block an SM: 128 registers a thread
// warpgroups a block of the multi-tile walk and of the 32-column code: three,
// 168 registers a thread (at 128 ptxas spilled in three of their TF32
// instantiations)
template <int CS, int MULTI>
__host__ __device__ constexpr int warpgroups() {
  return CS == 2 || MULTI ? 3 : WGS;
}
constexpr int CZ = 32;          // z-code columns at most (16 a k16 step)
constexpr int MAX_K = 256;      // samples a ray: a multi-tile ray's weights stay in shared memory
constexpr int MAX_D = 128;
constexpr int MAX_E = 68;
constexpr int MAX_RAYS = TP / 8;  // rays a tile at the least padding
constexpr float EPS = 1e-3f;
constexpr float HALF_PI = 1.57079637f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* base;    // (N, D)
  const float* z;       // (N, K)
  const float* zscale;  // (N,)
  const void* w_z;      // (Cz, D), fp32 or bf16
  const void* w2;       // (D, E), fp32 or bf16
  const float* b2;      // (E,)
  const float* color;   // (N, 3)
  float* depth;         // (N,)
  float* dino;          // (N, E - 1)
  float* rgb;           // (N, 3)
  int N, K, kshift, nseg, D, E, Cz, num_freqs, include_input, inv_z, hard_cap, median;  // nseg: tiles a ray
  float zn_sub, zn_scale, freq_factor;
  int vec, units;                       // a base row copied in 16-byte (vec) or 4-byte units, `units` a row
  uint32_t inv_units, inv_k, inv_f;     // reciprocal() of units, K and E - 1
};

// m such that quotient(n, m) = n / d where n d < 2^32: ceil(2^32 / d), or 0 for d = 1
inline uint32_t reciprocal(uint32_t d) { return d == 1 ? 0u : (uint32_t)((0x100000000ull + d - 1) / d); }

// n / d by a multiply (exact for n d < 2^32: here d <= 128 and n < 2^10)
__device__ __forceinline__ int quotient(int n, uint32_t m) { return m ? (int)__umulhi((uint32_t)n, m) : n; }

// Shared memory of a block. TF32: the fp32 state (two copies, hi and lo, of
// each weight tile); DC hidden chunks of 64; EC output chunks of 64 and an
// output tail of ET columns (8 or 24); MULTI: the multi-tile walk's weights
// of a whole ray and its carried state.
template <int TF32, int DC, int EC, int ET, int MULTI, int NWG>
struct Layout {
  static constexpr int DP = 64 * DC;
  static constexpr int EP = 64 * EC + ET;
  static constexpr int LDO = EP + ((8 - EP) % 32 + 32) % 32;  // row stride of the output buffer, = 8 mod 32
  static constexpr int COPIES = TF32 ? 2 : 1;
  static constexpr int KW = TF32 ? 32 : 64;                    // hidden units a 128-byte row holds
  static constexpr int KT = DP / KW;                           // k-tiles of W2
  static constexpr int WZ = 0;                                 // COPIES x DC tiles: rows n (hidden), columns k (code)
  static constexpr int W2 = WZ + COPIES * DC * TILE_BYTES;     // COPIES x EC x KT tiles: rows e, columns hidden
  static constexpr int W2T = W2 + COPIES * EC * KT * TILE_BYTES;  // COPIES x KT tail tiles of ET rows
  static constexpr int B2 = W2T + COPIES * KT * ET * 128;
  static constexpr int WG0 = (B2 + EP * 4 + 1023) / 1024 * 1024;
  // a warpgroup's own: the output buffer, two of each prefetch buffer, the weights
  static constexpr int OUT = 0;
  static constexpr int BASE = OUT + TP * LDO * 4;             // 2 x (MAX_RAYS, DP)
  static constexpr int Z = BASE + 2 * MAX_RAYS * DP * 4;      // 2 x TP
  static constexpr int ZS = Z + 2 * TP * 4;                   // 2 x MAX_RAYS
  static constexpr int W = ZS + 2 * MAX_RAYS * 4;             // TP, or MAX_K: a multi-tile ray's weights
  // a multi-tile ray's carried state: transmittance, depth, weight total, then its feature sums
  static constexpr int CARRY = W + (MULTI ? MAX_K : TP) * 4;
  static constexpr int WG_BYTES = (CARRY + (MULTI ? 3 + MAX_E : 0) * 4 + 1023) / 1024 * 1024;
  static constexpr int TOTAL = WG0 + NWG * WG_BYTES;
};

// `v`, opaque to the compiler where it is called: what is computed from it
// is computed there, inside the tile loop, and not held in a register across
// the whole walk
__device__ __forceinline__ uint32_t fresh(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// the descriptor of the tile at byte `offset` of the block's shared memory
// (at s0), advanced by `ks` k-steps, made where the wgmma that reads it is
// issued: descriptors made ahead of a batch and held in registers (two
// each) are what a thread's registers ran out on
__device__ __forceinline__ uint64_t desc(uint32_t s0, uint32_t offset, int ks) {
  return wgmma_desc_at(fresh(s0) + offset) + ks * WGMMA_K_STEP;
}

__device__ inline float softplus(float x) { return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))); }

__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }  // NaN stays NaN, as torch.relu

__device__ __forceinline__ float weight_at(const void* w, int i, int tf32) {
  return tf32 ? static_cast<const float*>(w)[i] : __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
}

__device__ __forceinline__ float normalized_depth(const Params& P, float z, float zscale) {
  const float dl = __fmul_rn(z, zscale);
  // as jitted XLA computes the JAX package's normalize_z: one rounding for the multiply-add
  const float zx = P.inv_z ? __fdiv_rn(1.f, fmaxf(dl, EPS)) : dl;
  return __fmaf_rn(__fsub_rn(zx, P.zn_sub), P.zn_scale, -1.f);
}

// z-code column c of normalized depth zn: zn (c = 0 with the input),
// sin(zn f + phase), or 0 past Cz
__device__ __forceinline__ float code_value(const Params& P, float zn, int c) {
  if (c >= P.Cz) return 0.f;
  if (P.include_input && c == 0) return zn;
  const int i = c - P.include_input;
  const float freq = P.freq_factor * (float)(1 << (i >> 1));
  return sinf(__fadd_rn(__fmul_rn(zn, freq), (i & 1) ? HALF_PI : 0.f));
}

// the tile's base rows (padded to DP columns), depths (padded to Kp a ray;
// of a ray of K > 64, samples [64 seg, 64 seg + 64)) and z factors into one
// set of buffers, by the warpgroup's threads
template <int DP, int MULTI>
__device__ __forceinline__ void prefetch(const Params& P, int ray0, int rpt, int seg, float* s_base, float* s_z,
                                         float* s_zs, int t) {
  const int rays = min(rpt, P.N - ray0);
  const int K = P.K, units = P.units;
  const float* base = P.base + (size_t)ray0 * P.D;
  for (int i = t; i < rays * units; i += WG) {
    const int rl = quotient(i, P.inv_units), c = i - rl * units;
    if (P.vec) {
      cp_async_16(s_base + rl * DP + 4 * c, base + (size_t)i * 4);
    } else {
      cp_async_4(s_base + rl * DP + c, base + i);
    }
  }
  const float* z = P.z + (size_t)ray0 * K;
  if constexpr (MULTI) {
    const int k0 = seg * TP;
    for (int i = t; i < min(TP, K - k0); i += WG) cp_async_4(s_z + i, z + k0 + i);
  } else {
    for (int i = t; i < rays * K; i += WG) {
      const int rl = quotient(i, P.inv_k);
      cp_async_4(s_z + (rl << P.kshift) + (i - rl * K), z + i);
    }
  }
  if (t < rays) cp_async_4(s_zs + t, P.zscale + ray0 + t);
}

// One ray's compositing by one warp, two samples a lane (k = 2 lane and
// 2 lane + 1): the weights into s_w, the total weight to every lane; returns
// the depth (E[z] or the weight median) to every lane.
__device__ __forceinline__ float composite_ray(const Params& P, const float* s_out, int ldo, const float* s_z,
                                               float* s_w, int pb, int lane, float& total) {
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
      const float delta = k + 1 < K ? __fsub_rn(s_z[pb + k + 1], zk[t]) : 1e10f;
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
  total = w0 + w1;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) total += __shfl_xor_sync(FULL, total, o);
  if (!P.median) {
    float d = __fadd_rn(__fmul_rn(w0, zk[0]), __fmul_rn(w1, zk[1]));
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) d += __shfl_xor_sync(FULL, d, o);
    return d;
  }
  // the median: count the samples whose CDF over the total is below 0.5
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
  return s_z[pb + min(__popc(below0) + __popc(below1), K - 1)];
}

// Tile `seg` of ray r of K > 64 samples, by one warp, two samples a lane:
// its weights from the transmittance carried in s_carry[0] into s_w[64 seg
// + k]; E[z] and the weight total added to s_carry[1] and s_carry[2]; the
// transmittance carried on. On the ray's last tile the weight median, if
// asked for, replaces s_carry[1]. The delta of the tile's last sample reads
// the next tile's first depth from memory.
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
      const float delta = k + 1 < K ? __fsub_rn(znext, zk[t]) : 1e10f;
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
  float total = w0 + w1, d = __fadd_rn(__fmul_rn(w0, zk[0]), __fmul_rn(w1, zk[1]));
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
  if (!P.median || k0 + TP < K) return;
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

template <int TF32, int CS, int MULTI, int DC, int EC, int ET>
__global__ void __launch_bounds__(warpgroups<CS, MULTI>() * WG, 1) encode_view_kernel(const Params P) {
  constexpr int NWG = warpgroups<CS, MULTI>();
  using L = Layout<TF32, DC, EC, ET, MULTI, NWG>;
  constexpr int DP = L::DP, KW = L::KW, KT = L::KT;
  static_assert(CS * 16 <= KW, "a W_z tile row holds the code's columns");
  constexpr int EN = EC > 0 ? EC : 1;  // extent of the 64-column accumulators (unused at EC = 0)
  extern __shared__ unsigned char smem_raw[];
  // the first 1024-byte boundary, reached by indexing the shared array
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* s_b2 = reinterpret_cast<float*>(sm + L::B2);
  const int tid = threadIdx.x;
  const int D = P.D, E = P.E;

  // the weights, zero-padded, once a block: bf16 as they are; fp32 as TF32
  // hi and lo, W2's hidden units permuted within groups of 8 (tf32_k_column)
  for (int i = tid; i < DP * KW; i += blockDim.x) {
    const int n = i / KW, k = i % KW;
    const float v = (k < P.Cz && n < D) ? weight_at(P.w_z, k * D + n, TF32) : 0.f;
    unsigned char* tile = sm + L::WZ + (n / 64) * TILE_BYTES;
    if (TF32) {
      const float hi = tf32_rna(v);
      *reinterpret_cast<float*>(tile + swizzled_element(n % 64, k, 4)) = hi;
      *reinterpret_cast<float*>(tile + DC * TILE_BYTES + swizzled_element(n % 64, k, 4)) = tf32_rna(v - hi);
    } else {
      *reinterpret_cast<__nv_bfloat16*>(tile + swizzled_element(n % 64, k, 2)) = __float2bfloat16(v);
    }
  }
  for (int i = tid; i < L::EP * DP; i += blockDim.x) {
    const int e = i / DP, p = i % DP;
    const int n = TF32 ? (p & ~7) + tf32_k_column(p & 7) : p;  // the hidden unit at k position p
    const float v = (e < E && n < D) ? weight_at(P.w2, n * E + e, TF32) : 0.f;
    const int kt = p / KW, k = p % KW;
    unsigned char* tile;
    int row, copy_stride;
    if (e < 64 * EC) {
      tile = sm + L::W2 + ((e / 64) * KT + kt) * TILE_BYTES;
      row = e % 64;
      copy_stride = EC * KT * TILE_BYTES;
    } else {
      tile = sm + L::W2T + kt * ET * 128;
      row = e - 64 * EC;
      copy_stride = KT * ET * 128;
    }
    if (TF32) {
      const float hi = tf32_rna(v);
      *reinterpret_cast<float*>(tile + swizzled_element(row, k, 4)) = hi;
      *reinterpret_cast<float*>(tile + copy_stride + swizzled_element(row, k, 4)) = tf32_rna(v - hi);
    } else {
      *reinterpret_cast<__nv_bfloat16*>(tile + swizzled_element(row, k, 2)) = __float2bfloat16(v);
    }
  }
  for (int e = tid; e < L::EP; e += blockDim.x) s_b2[e] = e < E ? P.b2[e] : 0.f;
  // the prefetch buffers start at 0: what no copy writes (base columns past D,
  // dead rows' depths) stays finite
  for (int i = tid; i < NWG * L::WG_BYTES / 4; i += blockDim.x) {
    const int w = i / (L::WG_BYTES / 4), o = i % (L::WG_BYTES / 4);
    if (o * 4 >= L::BASE) reinterpret_cast<float*>(sm + L::WG0 + w * L::WG_BYTES)[o] = 0.f;
  }
  fence_proxy_async();  // the tiles were written by threads; wgmma reads them
  __syncthreads();

  const int wg = tid / WG, t = tid % WG, warp = t / 32, lane = t % 32, q = lane % 4;
  unsigned char* own = sm + L::WG0 + wg * L::WG_BYTES;
  float* s_out = reinterpret_cast<float*>(own + L::OUT);
  float* s_w = reinterpret_cast<float*>(own + L::W);
  float* s_carry = reinterpret_cast<float*>(own + L::CARRY);
  const int row0 = warp * 16 + lane / 4;
  const int K = P.K, kshift = P.kshift, rpt = TP >> kshift;
  const int ntiles = (P.N + rpt - 1) / rpt;
  const int stride = gridDim.x * NWG;

  // the walk: tile after tile of this warpgroup, and within a ray of K > 64
  // samples its P.nseg tiles `seg` in order; each step's copies are issued
  // one step ahead
  int tile = blockIdx.x * NWG + wg, seg = 0;
  if (tile < ntiles) {
    prefetch<DP, MULTI>(P, tile * rpt, rpt, 0, reinterpret_cast<float*>(own + L::BASE),
                 reinterpret_cast<float*>(own + L::Z), reinterpret_cast<float*>(own + L::ZS), t);
  }
  cp_async_commit();
  for (int buf = 0; tile < ntiles; buf ^= 1) {
    const int ray0 = tile * rpt;
    float* s_base = reinterpret_cast<float*>(own + L::BASE) + buf * MAX_RAYS * DP;
    float* s_z = reinterpret_cast<float*>(own + L::Z) + buf * TP;
    float* s_zs = reinterpret_cast<float*>(own + L::ZS) + buf * MAX_RAYS;
    int next_tile = tile + stride, next_seg = 0;
    if constexpr (MULTI) {
      if (seg + 1 < P.nseg) {
        next_tile = tile;
        next_seg = seg + 1;
      }
    }
    if (next_tile < ntiles) {
      const int nb = buf ^ 1;
      prefetch<DP, MULTI>(P, next_tile * rpt, rpt, next_seg, reinterpret_cast<float*>(own + L::BASE) + nb * MAX_RAYS * DP,
                   reinterpret_cast<float*>(own + L::Z) + nb * TP, reinterpret_cast<float*>(own + L::ZS) + nb * MAX_RAYS,
                   t);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed (the next tile's may not)
    named_barrier_sync(1 + wg, WG);

    const uint32_t s0 = fresh(smem_u32(sm));  // the descriptors below are made here, tile by tile
    const float* brow[2];
    float zn[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + 8 * hi, rl = row >> kshift;
      zn[hi] = normalized_depth(P, s_z[row], s_zs[rl]);
      brow[hi] = s_base + rl * DP;
    }

    float o[EN][32], ot[ET / 2];
    if constexpr (!TF32) {
      // the code in bf16, as the A fragment of one k16 step: rows r, r + 8 of
      // columns 2q, 2q + 1 and 2q + 8, 2q + 9
      uint32_t ca[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 2 * q + 8 * (i >> 1);
        ca[i] = pack_bf16(code_value(P, zn[i & 1], c), code_value(P, zn[i & 1], c + 1));
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        fence_registers(acc);
        uint32_t ca2[4];  // CS = 2: columns 16-31, formed chunk by chunk
        if constexpr (CS == 2) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int cc = 16 + 2 * q + 8 * (i >> 1);
            ca2[i] = pack_bf16(code_value(P, zn[i & 1], cc), code_value(P, zn[i & 1], cc + 1));
          }
        }
        wgmma_fence();
        wgmma_m64n64k16_rs<0>(acc, ca, desc(s0, L::WZ + c * TILE_BYTES, 0), 0);
        if constexpr (CS == 2) wgmma_m64n64k16_rs<0>(acc, ca2, desc(s0, L::WZ + c * TILE_BYTES, 1), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers(acc);
        // h = bf16(relu(base + acc)): the A operand of four k16 steps of out = h W2
        uint32_t a[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const float2 b = *reinterpret_cast<const float2*>(brow[hi] + 64 * c + 8 * j + 2 * q);
            a[a_index(j, hi)] = pack_bf16(relu(__fadd_rn(b.x, acc[4 * j + 2 * hi])),
                                          relu(__fadd_rn(b.y, acc[4 * j + 2 * hi + 1])));
          }
        }
        if (c == 0) {
#pragma unroll
          for (int ec = 0; ec < EN; ++ec) {
#pragma unroll
            for (int i = 0; i < 32; ++i) o[ec][i] = 0.f;
            if (EC > 0) fence_registers(o[ec]);
          }
#pragma unroll
          for (int i = 0; i < ET / 2; ++i) ot[i] = 0.f;
          fence_registers(ot);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int acc_on = c > 0 || kk > 0;
#pragma unroll
          for (int ec = 0; ec < EC; ++ec) {
            wgmma_m64n64k16_rs<0>(o[ec], a + 4 * kk,
                                  desc(s0, L::W2 + (ec * KT + c) * TILE_BYTES, kk), acc_on);
          }
          const uint64_t dt = desc(s0, L::W2T + c * ET * 128, kk);
          if constexpr (ET == 8) {
            wgmma_m64n8k16_rs(ot, a + 4 * kk, dt, acc_on);
          } else {
            wgmma_m64n24k16_rs(ot, a + 4 * kk, dt, acc_on);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int ec = 0; ec < EC; ++ec) fence_registers(o[ec]);
        fence_registers(ot);
      }
    } else {
      // the code split into TF32 hi and lo, as the A fragments of two k8
      // steps: rows r, r + 8 of columns q, q + 4 (step 0) and 8 + q, 12 + q
      uint32_t ch[2][4], cl[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = code_value(P, zn[i & 1], 8 * s + q + 4 * (i >> 1));
          const float hv = tf32_rna(v);
          ch[s][i] = __float_as_uint(hv);
          cl[s][i] = __float_as_uint(tf32_rna(__fsub_rn(v, hv)));
        }
      }
#pragma unroll
      for (int i = 0; i < EN; ++i) {
#pragma unroll
        for (int k = 0; k < 32; ++k) o[i][k] = 0.f;
        if (EC > 0) fence_registers(o[i]);
      }
#pragma unroll
      for (int i = 0; i < ET / 2; ++i) ot[i] = 0.f;
      fence_registers(ot);
      // 32 hidden units at a time (half a chunk), so that 16 registers hold
      // the code product and 32 its h
#pragma unroll
      for (int half = 0; half < 2 * DC; ++half) {
        const int c = half / 2, n0 = 32 * half;  // chunk, first hidden unit
        float acc[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = 0.f;
        fence_registers(acc);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 2; ++s) {  // rows 32 (half % 2) on of the chunk's W_z tiles
          const uint64_t bh = desc(s0, L::WZ + c * TILE_BYTES + (half % 2) * 4096, s);
          const uint64_t bl = desc(s0, L::WZ + (DC + c) * TILE_BYTES + (half % 2) * 4096, s);
          wgmma_m64n32k8_tf32_rs(acc, cl[s], bh, s > 0);
          wgmma_m64n32k8_tf32_rs(acc, ch[s], bl, 1);
          wgmma_m64n32k8_tf32_rs(acc, ch[s], bh, 1);
        }
        if constexpr (CS == 2) {
#pragma unroll
          for (int s = 2; s < 4; ++s) {  // columns 16-31, formed here: held for the tile they would not fit
            uint32_t sh[4], sl[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float v = code_value(P, zn[i & 1], 8 * s + q + 4 * (i >> 1));
              const float hv = tf32_rna(v);
              sh[i] = __float_as_uint(hv);
              sl[i] = __float_as_uint(tf32_rna(__fsub_rn(v, hv)));
            }
            const uint64_t bh = desc(s0, L::WZ + c * TILE_BYTES + (half % 2) * 4096, s);
            const uint64_t bl = desc(s0, L::WZ + (DC + c) * TILE_BYTES + (half % 2) * 4096, s);
            wgmma_m64n32k8_tf32_rs(acc, sl, bh, 1);
            wgmma_m64n32k8_tf32_rs(acc, sh, bl, 1);
            wgmma_m64n32k8_tf32_rs(acc, sh, bh, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers(acc);
        // h = relu(base + acc) split into TF32 hi and lo: the A operands of
        // four k8 steps of out = h W2, step jj's (d[4jj], d[4jj+2], d[4jj+1], d[4jj+3])
        uint32_t hh[16], hl[16];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const float2 b = *reinterpret_cast<const float2*>(brow[hi] + n0 + 8 * jj + 2 * q);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = relu(__fadd_rn(e ? b.y : b.x, acc[4 * jj + 2 * hi + e]));
              const float hv = tf32_rna(v);
              hh[4 * jj + 2 * e + hi] = __float_as_uint(hv);
              hl[4 * jj + 2 * e + hi] = __float_as_uint(tf32_rna(__fsub_rn(v, hv)));
            }
          }
        }
        wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {  // k-tile `half` of W2, its step jj
          const int acc_on = half > 0 || jj > 0;
#pragma unroll
          for (int ec = 0; ec < EC; ++ec) {
            const uint64_t bh = desc(s0, L::W2 + (ec * KT + half) * TILE_BYTES, jj);
            const uint64_t bl = desc(s0, L::W2 + ((EC + ec) * KT + half) * TILE_BYTES, jj);
            wgmma_m64n64k8_tf32_rs(o[ec], hl + 4 * jj, bh, acc_on);
            wgmma_m64n64k8_tf32_rs(o[ec], hh + 4 * jj, bl, 1);
            wgmma_m64n64k8_tf32_rs(o[ec], hh + 4 * jj, bh, 1);
          }
          const uint64_t th = desc(s0, L::W2T + half * ET * 128, jj);
          const uint64_t tl = desc(s0, L::W2T + (KT + half) * ET * 128, jj);
          if constexpr (ET == 8) {
            wgmma_m64n8k8_tf32_rs(ot, hl + 4 * jj, th, acc_on);
            wgmma_m64n8k8_tf32_rs(ot, hh + 4 * jj, tl, 1);
            wgmma_m64n8k8_tf32_rs(ot, hh + 4 * jj, th, 1);
          } else {
            wgmma_m64n24k8_tf32_rs(ot, hl + 4 * jj, th, acc_on);
            wgmma_m64n24k8_tf32_rs(ot, hh + 4 * jj, tl, 1);
            wgmma_m64n24k8_tf32_rs(ot, hh + 4 * jj, th, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();  // before the next half's products take these registers
#pragma unroll
        for (int ec = 0; ec < EC; ++ec) fence_registers(o[ec]);
        fence_registers(ot);
      }
    }

    // out + b2 into the warpgroup's buffer
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float* row = s_out + (row0 + 8 * hi) * L::LDO;
#pragma unroll
      for (int ec = 0; ec < EC; ++ec) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * ec + 8 * j + 2 * q;
          *reinterpret_cast<float2*>(row + col) =
              make_float2(o[ec][4 * j + 2 * hi] + s_b2[col], o[ec][4 * j + 2 * hi + 1] + s_b2[col + 1]);
        }
      }
#pragma unroll
      for (int j = 0; j < ET / 8; ++j) {
        const int col = 64 * EC + 8 * j + 2 * q;
        *reinterpret_cast<float2*>(row + col) =
            make_float2(ot[4 * j + 2 * hi] + s_b2[col], ot[4 * j + 2 * hi + 1] + s_b2[col + 1]);
      }
    }
    named_barrier_sync(1 + wg, WG);

    if constexpr (!MULTI) {
      const int rays = min(rpt, P.N - ray0);
      for (int rl = warp; rl < rays; rl += WG / 32) {
        const int r = ray0 + rl;
        float total;
        const float depth = composite_ray(P, s_out, L::LDO, s_z, s_w, rl << kshift, lane, total);
        if (lane == 0) P.depth[r] = depth;
        if (lane < 3) P.rgb[(size_t)r * 3 + lane] = __ldg(P.color + (size_t)r * 3 + lane) * total;
      }
      named_barrier_sync(1 + wg, WG);
      // the weighted feature, one output a thread
      const int F = E - 1;
      for (int i = t; i < rays * F; i += WG) {
        const int rl = quotient(i, P.inv_f), col = i - rl * F;
        const int pb = rl << kshift;
        float sum = 0.f;
#pragma unroll 4
        for (int k = 0; k < K; ++k) sum = fmaf(s_w[pb + k], s_out[(pb + k) * L::LDO + 1 + col], sum);
        P.dino[(size_t)ray0 * F + i] = sum;
      }
    } else {
      // tile `seg` of a ray of K > 64 samples
      const int F = E - 1;
      if (seg == 0) {
        for (int i = t; i < 3 + F; i += WG) s_carry[i] = i == 0 ? 1.f : 0.f;
        named_barrier_sync(1 + wg, WG);
      }
      if (warp == 0) composite_segment(P, s_out, L::LDO, s_z, s_w, s_carry, seg, ray0, lane);
      named_barrier_sync(1 + wg, WG);
      // the tile's weighted feature added to the ray's sums, one output a thread
      const int k0 = seg * TP, n = min(TP, K - k0);
      const bool last = k0 + TP >= K;
      for (int col = t; col < F; col += WG) {
        float sum = s_carry[3 + col];
        for (int p = 0; p < n; ++p) sum = fmaf(s_w[k0 + p], s_out[p * L::LDO + 1 + col], sum);
        if (last) {
          P.dino[(size_t)ray0 * F + col] = sum;
        } else {
          s_carry[3 + col] = sum;
        }
      }
      if (last && t == 0) P.depth[ray0] = s_carry[1];
      if (last && t < 3) P.rgb[(size_t)ray0 * 3 + t] = __ldg(P.color + (size_t)ray0 * 3 + t) * s_carry[2];
    }
    named_barrier_sync(1 + wg, WG);  // the buffers are free for the next tile's copies and products
    tile = next_tile;
    seg = next_seg;
  }
  cp_async_wait<0>();
}

struct Cached {
  bool ready = false;
  int blocks = 0;  // blocks a launch: blocks an SM times SMs
};

template <int TF32, int CS, int MULTI, int DC, int EC, int ET>
int launch_shape(const Params& P, void* stream) {
  const auto kernel = encode_view_kernel<TF32, CS, MULTI, DC, EC, ET>;
  constexpr int NWG = warpgroups<CS, MULTI>();
  constexpr int smem = Layout<TF32, DC, EC, ET, MULTI, NWG>::TOTAL + 1024;  // room to align the tiles
  static_assert(smem <= 232448, "the block's shared memory must fit an H100 SM's 227 KB");
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NWG * WG, smem);
    if (err != cudaSuccess) return (int)err;
    c.blocks = (per_sm > 0 ? per_sm : 1) * sms;
    c.ready = true;
  }
  const int rpt = TP >> P.kshift;
  const int ntiles = (P.N + rpt - 1) / rpt;
  int blocks = (ntiles + NWG - 1) / NWG;
  if (blocks > c.blocks) blocks = c.blocks;
  kernel<<<blocks, NWG * WG, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// the hidden width to 64 or 128, the output width to 24 (E <= 24) or 64 + 8
template <int TF32, int CS, int MULTI>
int launch(const Params& P, void* stream) {
  if (P.D <= 64) {
    return P.E <= 24 ? launch_shape<TF32, CS, MULTI, 1, 0, 24>(P, stream)
                     : launch_shape<TF32, CS, MULTI, 1, 1, 8>(P, stream);
  }
  return P.E <= 24 ? launch_shape<TF32, CS, MULTI, 2, 0, 24>(P, stream)
                   : launch_shape<TF32, CS, MULTI, 2, 1, 8>(P, stream);
}

// the code to one k16 step (16 columns) or two (32); the one-tile walk up to
// 64 samples a ray, the multi-tile walk past it
template <int TF32>
int launch(const Params& P, void* stream) {
  if (P.Cz <= 16) return P.nseg > 1 ? launch<TF32, 1, 1>(P, stream) : launch<TF32, 1, 0>(P, stream);
  return P.nseg > 1 ? launch<TF32, 2, 1>(P, stream) : launch<TF32, 2, 0>(P, stream);
}

// ------------------------------------------------------------ the wide walk
// (csrc/wide_walk.cuh): every shape the instantiations above do not take

struct Wide {
  const unsigned char* packed;  // the packed weight units
  unsigned char* scratch;       // a block's share: the ray's weights (MULTI), then the A store if not in shared memory
  long long scratch_block;      // bytes of a block's share
  int DC, CT, EC, KT, NU;       // hidden chunks of 64, code tiles, output chunks of 64, hidden k-tiles; units a tile
  int ldc, ldh;                 // row strides (elements) of the code and h stores
  int a_shared, weights_bytes;  // the A store in shared memory; bytes of the weights in a block's share
};

// shared memory of a wide block: the ring (units of one bf16 tile, or the
// hi and lo TF32 tiles), the output buffer of one 64-column chunk, depths,
// weights, the carried state, the A store
template <int TF32>
struct WideLayout {
  static constexpr int UNIT = (TF32 ? 2 : 1) * TILE_BYTES;
  static constexpr int RING = 0;
  static constexpr int OUT = RING + wide::SLOTS * UNIT;
  static constexpr int Z = OUT + TP * wide::LDO * 4;
  static constexpr int W = Z + TP * 4;
  static constexpr int CARRY = W + TP * 4;
  static constexpr int A = CARRY + 128;
};

// z-code column c at any code width: code_value's, the frequency f_0 2^i for any i
__device__ __forceinline__ float wide_code_value(const Params& P, float zn, int c) {
  if (c >= P.Cz) return 0.f;
  if (P.include_input && c == 0) return zn;
  const int i = c - P.include_input;
  return sinf(__fadd_rn(__fmul_rn(zn, ldexpf(P.freq_factor, i >> 1)), (i & 1) ? HALF_PI : 0.f));
}

template <int TF32>
struct Elem {
  using type = __nv_bfloat16;
};
template <>
struct Elem<1> {
  using type = float;
};

// One block, one warpgroup, one 64-row tile at a time (64 / Kp rays of Kp
// samples, or a ray's segment of 64 samples where MULTI): the z code into
// the code store; per hidden chunk the code product over the code tiles,
// then h = relu(base + acc) into the h store (bf16, or fp32 split into TF32
// hi and lo where each product loads it); then per 64-column output chunk
// the product over the hidden k-tiles into the output buffer. The first
// chunk holds the density column: the compositing (composite_ray, or
// composite_segment with the ray's weights in the block's scratch) runs
// there, and every chunk's weighted columns are summed into the feature
// output (across a ray's segments through the output itself).
template <int TF32, int MULTI>
__global__ void __launch_bounds__(wide::WG, 2) encode_wide_kernel(const Params P, const Wide Wd) {
  using L = WideLayout<TF32>;
  using T = typename Elem<TF32>::type;
  constexpr int LDO = wide::LDO, KW = TF32 ? 32 : 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* s_out = reinterpret_cast<float*>(sm + L::OUT);
  float* s_z = reinterpret_cast<float*>(sm + L::Z);
  float* s_w = reinterpret_cast<float*>(sm + L::W);
  float* s_carry = reinterpret_cast<float*>(sm + L::CARRY);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, q = lane % 4;
  const int row0 = warp * 16 + lane / 4;
  unsigned char* mine = Wd.scratch + (size_t)blockIdx.x * Wd.scratch_block;
  float* g_w = reinterpret_cast<float*>(mine);  // MULTI: the ray's weights
  T* code = reinterpret_cast<T*>(Wd.a_shared ? sm + L::A : mine + Wd.weights_bytes);
  T* h = code + TP * Wd.ldc;
  const int DC = Wd.DC, CT = Wd.CT, EC = Wd.EC, KT = Wd.KT, D = P.D, E = P.E, F = E - 1, K = P.K, N = P.N;
  const int kshift = P.kshift, rpt = TP >> kshift, nseg = MULTI ? P.nseg : 1;
  const int ntiles = (N + rpt - 1) / rpt;
  const wide::Ring ring{sm + L::RING, Wd.packed, (uint32_t)Wd.NU, L::UNIT};
  wide::ring_start(ring, t);
  uint32_t g = 0;  // units taken

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int ray0 = tile * rpt, rays = min(rpt, N - ray0);
    for (int seg = 0; seg < nseg; ++seg) {
      const int k0 = seg * TP;
      // rows r and r + 8: their ray (a row past the tile's rays reads the
      // first ray; nobody reads its outputs), depth (0 past K) and normalized depth
      int rrow[2];
      float zn[2];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = row0 + 8 * hi, rl = MULTI ? 0 : row >> kshift, k = MULTI ? k0 + row : row - (rl << kshift);
        rrow[hi] = rl < rays ? ray0 + rl : ray0;
        const float zv = rl < rays && k < K ? __ldg(P.z + (size_t)rrow[hi] * K + k) : 0.f;
        if (q == 0) s_z[row] = zv;
        zn[hi] = normalized_depth(P, zv, __ldg(P.zscale + rrow[hi]));
      }
      // the z code: bf16 pairs (columns 8 m + 2 q and the next), or fp32 (columns 4 m + q)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        T* crow = code + (size_t)(row0 + 8 * hi) * Wd.ldc;
        if constexpr (TF32) {
          for (int c = q; c < KW * CT; c += 4) crow[c] = wide_code_value(P, zn[hi], c);
        } else {
          for (int c = 2 * q; c < KW * CT; c += 8) {
            *reinterpret_cast<uint32_t*>(crow + c) =
                pack_bf16(wide_code_value(P, zn[hi], c), wide_code_value(P, zn[hi], c + 1));
          }
        }
      }

      // h = relu(base + code W_z), 64 hidden units at a time
      for (int c = 0; c < DC; ++c) {
        float acc[32];
        for (int s = 0; s < CT; ++s) {
          const uint32_t unit = wide::ring_take(ring, g++, t);
          if constexpr (TF32) {
            wide::unit_tf32(acc, code, Wd.ldc, KW * s, unit, row0, q, s > 0);
          } else {
            wide::unit_bf16(acc, code, Wd.ldc, KW * s, unit, row0, q, s > 0);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int n = 64 * c + 8 * j + 2 * q;
            const float* brow = P.base + (size_t)rrow[hi] * D;
            const float v0 = relu(__fadd_rn(n < D ? __ldg(brow + n) : 0.f, acc[4 * j + 2 * hi]));
            const float v1 = relu(__fadd_rn(n + 1 < D ? __ldg(brow + n + 1) : 0.f, acc[4 * j + 2 * hi + 1]));
            T* hrow = h + (size_t)(row0 + 8 * hi) * Wd.ldh + n;
            if constexpr (TF32) {
              *reinterpret_cast<float2*>(hrow) = make_float2(v0, v1);
            } else {
              *reinterpret_cast<uint32_t*>(hrow) = pack_bf16(v0, v1);
            }
          }
        }
      }

      // out = h W2 + b2, 64 columns at a time; the density column's chunk first
      for (int j = 0; j < EC; ++j) {
        float o[32];
        for (int kt = 0; kt < KT; ++kt) {
          const uint32_t unit = wide::ring_take(ring, g++, t);
          if constexpr (TF32) {
            wide::unit_tf32(o, h, Wd.ldh, KW * kt, unit, row0, q, kt > 0);
          } else {
            wide::unit_bf16(o, h, Wd.ldh, KW * kt, unit, row0, q, kt > 0);
          }
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

        const int n = min(TP, K - k0);
        if (j == 0) {
          if constexpr (!MULTI) {
            for (int rl = warp; rl < rays; rl += wide::WG / 32) {
              const int r = ray0 + rl;
              float total;
              const float depth = composite_ray(P, s_out, LDO, s_z, s_w, rl << kshift, lane, total);
              if (lane == 0) P.depth[r] = depth;
              if (lane < 3) P.rgb[(size_t)r * 3 + lane] = __ldg(P.color + (size_t)r * 3 + lane) * total;
            }
          } else {
            if (seg == 0 && t < 3) s_carry[t] = t == 0 ? 1.f : 0.f;
            __syncthreads();
            if (warp == 0) composite_segment(P, s_out, LDO, s_z, g_w, s_carry, seg, ray0, lane);
          }
          __syncthreads();
          if (MULTI && k0 + TP >= K) {
            if (t == 0) P.depth[ray0] = s_carry[1];
            if (t < 3) P.rgb[(size_t)ray0 * 3 + t] = __ldg(P.color + (size_t)ray0 * 3 + t) * s_carry[2];
          }
        }
        // the chunk's weighted feature columns, one output a thread
        if constexpr (!MULTI) {
          for (int i = t; i < rays * 64; i += wide::WG) {
            const int rl = i / 64, cl = i % 64, f = 64 * j + cl - 1, pb = rl << kshift;
            if (f < 0 || f >= F) continue;
            float sum = 0.f;
            for (int k = 0; k < K; ++k) sum = fmaf(s_w[pb + k], s_out[(pb + k) * LDO + cl], sum);
            P.dino[(size_t)(ray0 + rl) * F + f] = sum;
          }
        } else {
          for (int cl = t; cl < 64; cl += wide::WG) {
            const int f = 64 * j + cl - 1;
            if (f < 0 || f >= F) continue;
            float sum = seg ? P.dino[(size_t)ray0 * F + f] : 0.f;
            for (int p = 0; p < n; ++p) sum = fmaf(g_w[k0 + p], s_out[p * LDO + cl], sum);
            P.dino[(size_t)ray0 * F + f] = sum;
          }
        }
        __syncthreads();  // the output buffer, depths and weights are free
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

template <int TF32, int MULTI>
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
  constexpr int KW = TF32 ? 32 : 64, PAD = TF32 ? 4 : 8;  // PAD: a row = 4 words mod 32, no bank met twice
  Wide& W = pl.W;
  W.DC = (P.D + 63) / 64;
  W.CT = (P.Cz + KW - 1) / KW;
  W.EC = (P.E + 63) / 64;
  W.KT = 64 * W.DC / KW;
  W.NU = W.DC * W.CT + W.EC * W.KT;
  W.ldc = KW * W.CT + PAD;
  W.ldh = 64 * W.DC + PAD;
  const long long a_bytes = wide::round_up((TF32 ? 4LL : 2LL) * TP * (W.ldc + W.ldh), 256);
  W.a_shared = WideLayout<TF32>::A + a_bytes <= wide::SHARED_BUDGET;
  W.weights_bytes = MULTI ? (int)wide::round_up(4LL * P.K, 256) : 0;
  W.scratch_block = W.weights_bytes + (W.a_shared ? 0 : a_bytes);
  pl.smem = WideLayout<TF32>::A + (W.a_shared ? (int)a_bytes : 0) + 1024;  // room to align the ring
  int per_sm = 0;
  if (int e = wide::blocks_per_sm(encode_wide_kernel<TF32, MULTI>, pl.smem, ready[dev], per_sm)) return e;
  const long long most = (long long)per_sm * sms[dev];
  const int rpt = TP >> P.kshift;
  const long long ntiles = ((long long)P.N + rpt - 1) / rpt;
  pl.blocks = (int)(ntiles < most ? ntiles : most);
  pl.packed_bytes = (long long)W.NU * WideLayout<TF32>::UNIT;
  pl.scratch_bytes = W.scratch_block * most;  // for the most blocks a launch takes
  return 0;
}

template <int TF32, int MULTI>
int launch_wide(const Params& P, void* packed, void* scratch, void* stream) {
  WidePlan pl;
  if (int err = wide_plan<TF32, MULTI>(P, pl)) return err;
  if (!packed || (pl.scratch_bytes && !scratch)) return (int)cudaErrorInvalidValue;
  pl.W.packed = static_cast<const unsigned char*>(packed);
  pl.W.scratch = static_cast<unsigned char*>(scratch);
  const long long elements = (long long)pl.W.NU * 64 * (TF32 ? 32 : 64);
  const int pack_blocks = (int)(elements / 256 < 1024 ? (elements + 255) / 256 : 1024);
  wide::pack_units<TF32, 0><<<pack_blocks, 256, 0, (cudaStream_t)stream>>>(
      P.w_z, P.w2, P.D, P.E, P.Cz, pl.W.DC, pl.W.CT, pl.W.KT, pl.W.NU, static_cast<unsigned char*>(packed));
  encode_wide_kernel<TF32, MULTI><<<pl.blocks, wide::WG, pl.smem, (cudaStream_t)stream>>>(P, pl.W);
  return (int)cudaGetLastError();
}

// the shipped instantiations where they take the shape
bool shipped(const Params& P) { return P.K <= MAX_K && P.D <= MAX_D && P.E <= MAX_E && P.Cz <= CZ; }

template <int TF32>
int launch_any(const Params& P, void* packed, void* scratch, void* stream) {
  if (shipped(P)) return launch<TF32>(P, stream);
  return P.nseg > 1 ? launch_wide<TF32, 1>(P, packed, scratch, stream) : launch_wide<TF32, 0>(P, packed, scratch, stream);
}

template <int TF32>
int wide_bytes(const Params& P, long long* packed, long long* scratch) {
  WidePlan pl;
  const int err = P.nseg > 1 ? wide_plan<TF32, 1>(P, pl) : wide_plan<TF32, 0>(P, pl);
  if (err) return err;
  *packed = pl.packed_bytes;
  *scratch = pl.scratch_bytes;
  return 0;
}

Params make_params(const void* base, const void* z, const void* zscale, const void* w_z, const void* w2,
                   const void* b2, const void* color, void* depth, void* dino, void* rgb, long long N, int K, int D,
                   int E, int Cz, int num_freqs, int include_input, int inv_z, int hard_cap, int median,
                   float zn_sub, float zn_scale, float freq_factor) {
  const int kshift = K <= 8 ? 3 : (K <= 16 ? 4 : (K <= 32 ? 5 : 6));  // Kp = 2^kshift; 64 past 64 samples
  const int vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(base) & 15) == 0;
  const int units = vec ? D / 4 : D;
  return {(const float*)base, (const float*)z, (const float*)zscale, w_z, w2, (const float*)b2,
          (const float*)color, (float*)depth, (float*)dino, (float*)rgb,
          (int)N, K, kshift, (K + TP - 1) / TP, D, E, Cz, num_freqs, include_input, inv_z, hard_cap, median,
          zn_sub, zn_scale, freq_factor, vec, units, reciprocal(units), reciprocal(K), reciprocal(E - 1)};
}

}  // namespace

// Pointers are device pointers on the current device; the wrapper
// (kernels/encode_view.py) checks dtypes, shapes and contiguity. Returns a
// cudaError_t (0 = launched). `packed` and `scratch` are the wide walk's
// buffers, of the sizes encode_view_wide_bytes gives (null where it gives 0).
extern "C" int encode_view(
    const void* base, const void* z, const void* zscale, const void* w_z, const void* w2, const void* b2,
    const void* color, void* depth, void* dino, void* rgb, void* packed, void* scratch,
    long long N, int K, int D, int E, int Cz, int bf16,
    int num_freqs, int include_input, int inv_z, int hard_cap, int median,
    float zn_sub, float zn_scale, float freq_factor, void* stream) {
  if (N <= 0 || N > INT_MAX - TP || K <= 0 || D <= 0 || E < 2 || Cz <= 0 ||
      Cz != (include_input ? 1 : 0) + 2 * num_freqs)
    return (int)cudaErrorInvalidValue;
  const Params P = make_params(base, z, zscale, w_z, w2, b2, color, depth, dino, rgb, N, K, D, E, Cz, num_freqs,
                               include_input, inv_z, hard_cap, median, zn_sub, zn_scale, freq_factor);
  return bf16 ? launch_any<0>(P, packed, scratch, stream) : launch_any<1>(P, packed, scratch, stream);
}

// The bytes of the wide walk's packed weights and scratch for a launch on
// the current device: both 0 where the shipped instantiations take the shape.
extern "C" int encode_view_wide_bytes(long long N, int K, int D, int E, int Cz, int bf16, long long* packed,
                                      long long* scratch) {
  *packed = *scratch = 0;
  if (N <= 0 || N > INT_MAX - TP || K <= 0 || D <= 0 || E < 2 || Cz <= 0) return (int)cudaErrorInvalidValue;
  const Params P = make_params(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, N, K, D, E, Cz, 0, 0, 0, 0, 0, 0.f, 1.f, 1.f);
  if (shipped(P)) return 0;
  return bf16 ? wide_bytes<0>(P, packed, scratch) : wide_bytes<1>(P, packed, scratch);
}
