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
//   h = bf16(relu(g + code @ W_code + b1)), out = h @ W2 + b2 (fp32 sums);
//   sigma = softplus(out[0]);
// then along the K samples: alpha compositing with the max(1-a, 1e-10)
// floor and the optional hard cap on the last sample, depth = E[z] or the
// weight median (the first sample whose normalized weight CDF reaches
// 0.5, clamped; scenedino_tpu/core/compositing.py:61-78), the weighted
// feature out[1:], and the weighted colour from a second projection into
// the colour camera (bilinear, weights collapsed where the clamped corners
// coincide). Only per-ray outputs reach memory. K3 stops at the weights,
// K4 at the head output, and neither projects into the colour camera.
//
// Bound on the H100 at the flagship shape (122,880 rays x 32 samples,
// 384x1280x128 bf16 grid, W_code 39x128, W2 128x65): the two products are
// 3.93 M points x 2 x (39*128 + 128*65) = 105 GFLOP, about 106 us at the
// 989 TFLOP/s bf16 tensor-core peak; the grid is 126 MB, about 38 us at
// 3.35 TB/s if read once. So it is bound by operations at peak, but the
// four gathers per point (1 KB of grid rows each, mostly from L2) and the
// fp32 blend on the CUDA cores sit in front of that. K3 at the probe
// shape (7,680 rays x 16 samples, one output column padded to 16) is
// bound by the 126 MB grid, about 38 us if read once. K4 at the SSCBench
// grid (2,097,152 points, W2 128x65) is bound by bytes: the (P, 64) fp32
// feature output alone is 537 MB, about 0.16 ms.
//
// Design: a block of 4 warps walks over tiles of 64 points (64/K rays).
// The weights (W_code, W2, zero-padded to multiples of 16) sit in shared
// memory for the block's life. Per tile: one thread per point projects,
// builds the code and the corner indices; the code product runs on the
// tensor cores (WMMA, bf16 in, fp32 out) into a shared fp32 tile; the
// threads then gather the corner rows as 16-byte loads, blend, add bias,
// ReLU and round to bf16; the second product runs on the tensor cores
// into the same fp32 tile; one warp per ray composites (K2, K3), or the
// block writes the tile's head outputs with coalesced stores (K4, a tile
// of 64 points with K = 1). The output mode is a template argument, so
// the three kernels are compiled from one copy of the pipeline. Not yet used:
// wgmma, TMA, overlap of the gathers with the products (later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

enum Mode { RENDER = 0, PROBE = 1, QUERY = 2 };

constexpr int TP = 64;        // points per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int NWARPS = THREADS / 32;
constexpr float EPS = 1e-3f;
constexpr float HALF_PI = 1.57079637f;

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
  float zn_sub, zn_den, freq_factor;
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// shared-memory layout, computed alike on the host (its size) and in the kernel
struct Layout {
  int CP, DP, EP;                   // code, hidden, output widths padded to 16
  int ldc, ldwc, ldw2, ldh, lda;    // row strides (elements)
  size_t wc, w2, code, acc, h, idx, wxy, rgb, z, wts, b1, b2, cam, total;
};

__host__ __device__ inline Layout make_layout(int C, int D, int E) {
  Layout L;
  L.CP = round16(C);
  L.DP = round16(D);
  L.EP = round16(E);
  L.ldc = L.CP + 8;
  L.ldwc = L.DP + 8;
  L.ldw2 = L.EP + 8;
  L.ldh = L.DP + 8;
  L.lda = (L.DP > L.EP ? L.DP : L.EP) + 4;
  size_t o = 0;
  L.wc = o;   o = align128(o + (size_t)L.CP * L.ldwc * 2);
  L.w2 = o;   o = align128(o + (size_t)L.DP * L.ldw2 * 2);
  L.code = o; o = align128(o + (size_t)TP * L.ldc * 2);
  L.acc = o;  o = align128(o + (size_t)TP * L.lda * 4);
  L.h = o;    o = align128(o + (size_t)TP * L.ldh * 2);
  L.idx = o;  o = align128(o + (size_t)TP * 16);
  L.wxy = o;  o = align128(o + (size_t)TP * 8);
  L.rgb = o;  o = align128(o + (size_t)TP * 12);
  L.z = o;    o = align128(o + (size_t)TP * 4);
  L.wts = o;  o = align128(o + (size_t)TP * 4);
  L.b1 = o;   o = align128(o + (size_t)L.DP * 4);
  L.b2 = o;   o = align128(o + (size_t)L.EP * 4);
  L.cam = o;  o = align128(o + 42 * 4);
  L.total = o;
  return L;
}

// cam: rot (9), trans (3), K (9). Rounded step by step (no FMA contraction)
// so the coordinates agree with the plain version's separate products.
__device__ inline void project(const float* cam, const float* pt, float& x, float& y,
                               float& zc, float* pc) {
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

// one thread per point: code row, feature corners, colour sample, depth
template <int MODE>
__device__ void setup_point(const Params& P, const Layout& L, unsigned char* smem, int p,
                            int ray0, int rpt) {
  __nv_bfloat16* code = reinterpret_cast<__nv_bfloat16*>(smem + L.code) + p * L.ldc;
  int4* s_idx = reinterpret_cast<int4*>(smem + L.idx);
  float2* s_wxy = reinterpret_cast<float2*>(smem + L.wxy);
  float* s_rgb = reinterpret_cast<float*>(smem + L.rgb);
  float* s_z = reinterpret_cast<float*>(smem + L.z);
  const float* fcam = reinterpret_cast<const float*>(smem + L.cam);
  const float* ccam = fcam + 21;

  const int rl = p / P.K;
  const int k = p - rl * P.K;
  const int r = ray0 + rl;
  if (rl >= rpt || r >= P.R) {
    for (int c = 0; c < L.CP; ++c) code[c] = __float2bfloat16(0.f);
    s_idx[p] = make_int4(0, 0, 0, 0);
    s_wxy[p] = make_float2(0.f, 0.f);
    s_rgb[p * 3 + 0] = s_rgb[p * 3 + 1] = s_rgb[p * 3 + 2] = 0.f;
    s_z[p] = 0.f;
    return;
  }
  float pt[3];
  if (MODE == QUERY) {
#pragma unroll
    for (int i = 0; i < 3; ++i) pt[i] = P.rays[(size_t)r * 3 + i];
    s_z[p] = 0.f;
  } else {
    const float* ray = P.rays + (size_t)r * 8;
    const float zv = P.z[(size_t)r * P.K + k];
#pragma unroll
    for (int i = 0; i < 3; ++i) pt[i] = __fadd_rn(ray[i], __fmul_rn(zv, ray[3 + i]));
    s_z[p] = zv;
  }

  float x, y, zc, pc[3];
  project(fcam, pt, x, y, zc, pc);
  const float dl = P.code_distance ? sqrtf(pc[0] * pc[0] + pc[1] * pc[1] + pc[2] * pc[2]) : zc;
  const float zn01 = P.inv_z ? __fdiv_rn(__fsub_rn(__fdiv_rn(1.f, fmaxf(dl, EPS)), P.zn_sub), P.zn_den)
                             : __fdiv_rn(__fsub_rn(dl, P.zn_sub), P.zn_den);
  const float in3[3] = {x, y, __fsub_rn(__fmul_rn(2.f, zn01), 1.f)};
  int c = 0;
  if (P.include_input) {
    for (int j = 0; j < 3; ++j) code[c++] = __float2bfloat16(in3[j]);
  }
  for (int f = 0; f < P.num_freqs; ++f) {
    const float freq = P.freq_factor * (float)(1 << f);
    for (int s = 0; s < 2; ++s) {
      for (int j = 0; j < 3; ++j) {
        code[c++] = __float2bfloat16(sinf(__fadd_rn(__fmul_rn(in3[j], freq), s ? HALF_PI : 0.f)));
      }
    }
  }
  for (; c < L.CP; ++c) code[c] = __float2bfloat16(0.f);

  // feature-grid corners (no weight collapse: coinciding corners blend to the corner)
  const float px = to_pixel(x, P.Wg), py = to_pixel(y, P.Hg);
  const float fx0 = floorf(px), fy0 = floorf(py);
  const int x0 = clampi((int)fx0, 0, P.Wg - 1), x1 = clampi((int)fx0 + 1, 0, P.Wg - 1);
  const int y0 = clampi((int)fy0, 0, P.Hg - 1), y1 = clampi((int)fy0 + 1, 0, P.Hg - 1);
  s_idx[p] = make_int4(y0 * P.Wg + x0, y0 * P.Wg + x1, y1 * P.Wg + x0, y1 * P.Wg + x1);
  s_wxy[p] = make_float2(__fsub_rn(px, fx0), __fsub_rn(py, fy0));

  if (MODE != RENDER) return;
  // colour: second projection, bilinear with the border weight collapse
  float cx, cy, czc, cpc[3];
  project(ccam, pt, cx, cy, czc, cpc);
  const float qx = to_pixel(cx, P.Wc), qy = to_pixel(cy, P.Hc);
  const float gx0 = floorf(qx), gy0 = floorf(qy);
  const int u0 = clampi((int)gx0, 0, P.Wc - 1), u1 = clampi((int)gx0 + 1, 0, P.Wc - 1);
  const int v0 = clampi((int)gy0, 0, P.Hc - 1), v1 = clampi((int)gy0 + 1, 0, P.Hc - 1);
  const float wx = u1 > u0 ? __fsub_rn(qx, gx0) : 0.f;
  const float wy = v1 > v0 ? __fsub_rn(qy, gy0) : 0.f;
  const float w00 = (1.f - wx) * (1.f - wy), w01 = wx * (1.f - wy);
  const float w10 = (1.f - wx) * wy, w11 = wx * wy;
  const __nv_bfloat16* img = P.color;
  for (int ch = 0; ch < 3; ++ch) {
    const float c00 = __bfloat162float(img[(v0 * P.Wc + u0) * 3 + ch]);
    const float c01 = __bfloat162float(img[(v0 * P.Wc + u1) * 3 + ch]);
    const float c10 = __bfloat162float(img[(v1 * P.Wc + u0) * 3 + ch]);
    const float c11 = __bfloat162float(img[(v1 * P.Wc + u1) * 3 + ch]);
    s_rgb[p * 3 + ch] = c00 * w00 + c01 * w01 + c10 * w10 + c11 * w11;
  }
}

// C (TP x n) = A (TP x kdim) @ B (kdim x n), bf16 in shared memory, fp32 out
__device__ void tile_matmul(const __nv_bfloat16* A, int lda_, const __nv_bfloat16* B, int ldb,
                            float* Cm, int ldc_, int n, int kdim, int warp) {
  const int mt = TP / 16, nt = n / 16, kt = kdim / 16;
  for (int t = warp; t < mt * nt; t += NWARPS) {
    const int i = t / nt, j = t % nt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < kt; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + i * 16 * lda_ + kk * 16, lda_);
      wmma::load_matrix_sync(b, B + kk * 16 * ldb + j * 16, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Cm + i * 16 * ldc_ + j * 16, acc, ldc_, wmma::mem_row_major);
  }
}

__device__ inline float softplus(float x) { return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))); }

template <int MODE>
__global__ void __launch_bounds__(THREADS) point_kernel(const Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(P.C, P.D, P.E);
  __nv_bfloat16* s_wc = reinterpret_cast<__nv_bfloat16*>(smem + L.wc);
  __nv_bfloat16* s_w2 = reinterpret_cast<__nv_bfloat16*>(smem + L.w2);
  __nv_bfloat16* s_code = reinterpret_cast<__nv_bfloat16*>(smem + L.code);
  float* s_acc = reinterpret_cast<float*>(smem + L.acc);
  __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem + L.h);
  const int4* s_idx = reinterpret_cast<const int4*>(smem + L.idx);
  const float2* s_wxy = reinterpret_cast<const float2*>(smem + L.wxy);
  const float* s_rgb = reinterpret_cast<const float*>(smem + L.rgb);
  const float* s_z = reinterpret_cast<const float*>(smem + L.z);
  float* s_wts = reinterpret_cast<float*>(smem + L.wts);
  float* s_b1 = reinterpret_cast<float*>(smem + L.b1);
  float* s_b2 = reinterpret_cast<float*>(smem + L.b2);
  float* s_cam = reinterpret_cast<float*>(smem + L.cam);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // weights, biases and both cameras, once per block, zero-padded
  for (int i = tid; i < L.CP * L.DP; i += THREADS) {
    const int c = i / L.DP, d = i % L.DP;
    s_wc[c * L.ldwc + d] = (c < P.C && d < P.D) ? P.w_code[c * P.D + d] : zero;
  }
  for (int i = tid; i < L.DP * L.EP; i += THREADS) {
    const int d = i / L.EP, e = i % L.EP;
    s_w2[d * L.ldw2 + e] = (d < P.D && e < P.E) ? P.w2[d * P.E + e] : zero;
  }
  for (int i = tid; i < L.DP; i += THREADS) s_b1[i] = i < P.D ? P.b1[i] : 0.f;
  for (int i = tid; i < L.EP; i += THREADS) s_b2[i] = i < P.E ? P.b2[i] : 0.f;
  if (tid < (MODE == RENDER ? 42 : 21)) {
    const int cam = tid / 21, j = tid % 21;
    const float* w2c = cam ? P.color_w2c : P.feat_w2c;
    const float* kmat = cam ? P.color_k : P.feat_k;
    s_cam[tid] = j < 9 ? w2c[(j / 3) * 4 + j % 3] : (j < 12 ? w2c[(j - 9) * 4 + 3] : kmat[j - 12]);
  }
  __syncthreads();

  const int rpt = TP / P.K;  // rays per tile
  const int ntiles = (P.R + rpt - 1) / rpt;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int ray0 = tile * rpt;
    if (tid < TP) setup_point<MODE>(P, L, smem, tid, ray0, rpt);
    __syncthreads();

    tile_matmul(s_code, L.ldc, s_wc, L.ldwc, s_acc, L.lda, L.DP, L.CP, warp);
    __syncthreads();

    // gather 4 corner rows (8 channels = 16 bytes per load), blend, bias, relu, bf16
    const int chunks = L.DP / 8;
    for (int i = tid; i < TP * chunks; i += THREADS) {
      const int p = i / chunks, c0 = (i % chunks) * 8;
      __align__(16) __nv_bfloat16 hv[8];
      if (c0 < P.D) {
        const int4 id = s_idx[p];
        const float2 w = s_wxy[p];
        const uint4 r00 = __ldg(reinterpret_cast<const uint4*>(P.grid + (size_t)id.x * P.D + c0));
        const uint4 r01 = __ldg(reinterpret_cast<const uint4*>(P.grid + (size_t)id.y * P.D + c0));
        const uint4 r10 = __ldg(reinterpret_cast<const uint4*>(P.grid + (size_t)id.z * P.D + c0));
        const uint4 r11 = __ldg(reinterpret_cast<const uint4*>(P.grid + (size_t)id.w * P.D + c0));
        const __nv_bfloat16* a00 = reinterpret_cast<const __nv_bfloat16*>(&r00);
        const __nv_bfloat16* a01 = reinterpret_cast<const __nv_bfloat16*>(&r01);
        const __nv_bfloat16* a10 = reinterpret_cast<const __nv_bfloat16*>(&r10);
        const __nv_bfloat16* a11 = reinterpret_cast<const __nv_bfloat16*>(&r11);
        const float* accp = s_acc + p * L.lda + c0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float top = __bfloat162float(a00[j]) * (1.f - w.x) + __bfloat162float(a01[j]) * w.x;
          const float bot = __bfloat162float(a10[j]) * (1.f - w.x) + __bfloat162float(a11[j]) * w.x;
          const float g = top * (1.f - w.y) + bot * w.y;
          hv[j] = __float2bfloat16(fmaxf(g + accp[j] + s_b1[c0 + j], 0.f));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) hv[j] = zero;
      }
      *reinterpret_cast<uint4*>(s_h + p * L.ldh + c0) = *reinterpret_cast<const uint4*>(hv);
    }
    __syncthreads();

    tile_matmul(s_h, L.ldh, s_w2, L.ldw2, s_acc, L.lda, L.EP, L.DP, warp);
    __syncthreads();

    if (MODE == QUERY) {
      // head outputs of the tile's points (K = 1): sigma and the feature row
      for (int i = tid; i < TP * P.E; i += THREADS) {
        const int p = i / P.E, e = i - p * P.E;
        const int r = ray0 + p;
        if (r >= P.R) continue;
        const float x = s_acc[p * L.lda + e] + s_b2[e];
        if (e == 0) {
          P.out[r] = softplus(x);
        } else {
          P.dino[(size_t)r * (P.E - 1) + e - 1] = x;
        }
      }
      __syncthreads();
      continue;
    }

    // compositing: one warp per ray
    for (int rl = warp; rl < rpt; rl += NWARPS) {
      const int r = ray0 + rl;
      if (r >= P.R) break;
      const int pb = rl * P.K;
      if (lane == 0) {
        float T = 1.f, depth = 0.f;
        for (int k = 0; k < P.K; ++k) {
          const float sigma = softplus(s_acc[(pb + k) * L.lda] + s_b2[0]);
          const float delta = k + 1 < P.K ? s_z[pb + k + 1] - s_z[pb + k] : 1e10f;
          float alpha = 1.f - expf(-fabsf(delta) * fmaxf(sigma, 0.f));
          if (P.hard_cap && k == P.K - 1) alpha = 1.f;
          const float w = alpha * T;
          s_wts[pb + k] = w;
          if (MODE == PROBE) P.out[(size_t)r * P.K + k] = w;
          depth += w * s_z[pb + k];
          T *= fmaxf(1.f - alpha, 1e-10f);
        }
        if (MODE == RENDER && P.median) {
          // first sample whose normalized weight CDF reaches 0.5, clamped
          float total = 0.f;
          for (int k = 0; k < P.K; ++k) total += s_wts[pb + k];
          const float den = fmaxf(total, 1e-10f);
          float cdf = 0.f;
          int idx = 0;
          for (int k = 0; k < P.K; ++k) {
            cdf += s_wts[pb + k];
            if (__fdiv_rn(cdf, den) < 0.5f) ++idx;
          }
          depth = s_z[pb + (idx < P.K ? idx : P.K - 1)];
        }
        if (MODE == RENDER) P.depth[r] = depth;
      }
      if (MODE != RENDER) continue;
      __syncwarp();
      for (int d = lane; d < P.E - 1; d += 32) {
        float acc = 0.f;
        for (int k = 0; k < P.K; ++k) {
          acc += s_wts[pb + k] * (s_acc[(pb + k) * L.lda + 1 + d] + s_b2[1 + d]);
        }
        P.dino[(size_t)r * (P.E - 1) + d] = acc;
      }
      if (lane < 3) {
        float acc = 0.f;
        for (int k = 0; k < P.K; ++k) acc += s_wts[pb + k] * s_rgb[(pb + k) * 3 + lane];
        P.rgb[(size_t)r * 3 + lane] = acc;
      }
    }
    __syncthreads();
  }
}

template <int MODE>
int launch(const Params& P, void* stream) {
  const Layout L = make_layout(P.C, P.D, P.E);
  const int smem = (int)L.total;
  cudaError_t err = cudaFuncSetAttribute(point_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return (int)err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, point_kernel<MODE>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const int rpt = TP / P.K;
  const int ntiles = (P.R + rpt - 1) / rpt;
  int blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > ntiles) blocks = ntiles;
  point_kernel<MODE><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

bool bad_field(int R, int K, int D, int E, int C, int num_freqs, int include_input, int min_e) {
  return R <= 0 || K <= 0 || K > TP || D <= 0 || D > 128 || D % 8 || E < min_e || E > 128 ||
         C <= 0 || C > 64 || C != 3 * (include_input ? 1 : 0) + 6 * num_freqs;
}

}  // namespace

// Pointers are device pointers on the current device; the wrappers check
// dtypes, shapes and contiguity. Each returns a cudaError_t (0 = launched).
extern "C" int point_render(
    const void* rays, const void* z, const void* grid, const void* w_code, const void* b1,
    const void* w2, const void* b2, const void* feat_w2c, const void* feat_k,
    const void* color, const void* color_w2c, const void* color_k,
    void* depth, void* dino, void* rgb,
    int R, int K, int Hg, int Wg, int D, int E, int C, int Hc, int Wc,
    int num_freqs, int include_input, int inv_z, int code_distance, int hard_cap, int median,
    float zn_sub, float zn_den, float freq_factor, void* stream) {
  if (bad_field(R, K, D, E, C, num_freqs, include_input, 2)) return (int)cudaErrorInvalidValue;
  Params P = {(const float*)rays, (const float*)z, (const __nv_bfloat16*)grid,
              (const __nv_bfloat16*)w_code, (const float*)b1, (const __nv_bfloat16*)w2,
              (const float*)b2, (const float*)feat_w2c, (const float*)feat_k,
              (const __nv_bfloat16*)color, (const float*)color_w2c, (const float*)color_k,
              (float*)depth, (float*)dino, (float*)rgb, nullptr,
              R, K, Hg, Wg, D, E, C, Hc, Wc,
              num_freqs, include_input, inv_z, code_distance, hard_cap, median,
              zn_sub, zn_den, freq_factor};
  return launch<RENDER>(P, stream);
}

// K3: w2 (D, 1) and b2 (1,) are the density column alone; writes the
// compositing weights (R, K).
extern "C" int probe_weights(
    const void* rays, const void* z, const void* grid, const void* w_code, const void* b1,
    const void* w2, const void* b2, const void* feat_w2c, const void* feat_k, void* weights,
    int R, int K, int Hg, int Wg, int D, int C,
    int num_freqs, int include_input, int inv_z, int code_distance, int hard_cap,
    float zn_sub, float zn_den, float freq_factor, void* stream) {
  if (bad_field(R, K, D, 1, C, num_freqs, include_input, 1)) return (int)cudaErrorInvalidValue;
  Params P = {(const float*)rays, (const float*)z, (const __nv_bfloat16*)grid,
              (const __nv_bfloat16*)w_code, (const float*)b1, (const __nv_bfloat16*)w2,
              (const float*)b2, (const float*)feat_w2c, (const float*)feat_k,
              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, (float*)weights,
              R, K, Hg, Wg, D, 1, C, 0, 0,
              num_freqs, include_input, inv_z, code_distance, hard_cap, 0,
              zn_sub, zn_den, freq_factor};
  return launch<PROBE>(P, stream);
}

// K4: points (R, 3); writes sigma (R,) and the feature (R, E - 1).
extern "C" int point_query(
    const void* pts, const void* grid, const void* w_code, const void* b1, const void* w2,
    const void* b2, const void* feat_w2c, const void* feat_k, void* sigma, void* feat,
    int R, int Hg, int Wg, int D, int E, int C,
    int num_freqs, int include_input, int inv_z, int code_distance,
    float zn_sub, float zn_den, float freq_factor, void* stream) {
  if (bad_field(R, 1, D, E, C, num_freqs, include_input, 2)) return (int)cudaErrorInvalidValue;
  Params P = {(const float*)pts, nullptr, (const __nv_bfloat16*)grid,
              (const __nv_bfloat16*)w_code, (const float*)b1, (const __nv_bfloat16*)w2,
              (const float*)b2, (const float*)feat_w2c, (const float*)feat_k,
              nullptr, nullptr, nullptr, nullptr, (float*)feat, nullptr, (float*)sigma,
              R, 1, Hg, Wg, D, E, C, 0, 0,
              num_freqs, include_input, inv_z, code_distance, 0, 0,
              zn_sub, zn_den, freq_factor};
  return launch<QUERY>(P, stream);
}
