// K6: the encode-view render, fused per sample.
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
//   zn  = 2 ((1 / max(z zscale, 1e-3) - 1/far) / (1/near - 1/far)) - 1
//         (or the linear normalization without inv_z),
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
// Types: the state's dtype. fp32 (stage 2's fold): every product and sum
// in fp32 FMAs (not TF32). bf16 (serving): W_z and W2 are bf16, the code
// and h are rounded to bf16 before their products, sums in fp32 — what the
// plain version computes, since a bf16 x bf16 product is exact in fp32.
//
// Bound on the H100 at 192x640 x 32 samples, d_hidden 128, d_out 65: 9,984
// multiply-adds a sample (13 x 128 + 128 x 65), 78.5 GFLOP a frame; 111 MB
// moved (base 62.9 MB, z 15.7 MB, outputs 32.4 MB). bf16 operations bound
// it at the tensor cores' 989 TFLOP/s (0.079 ms); the fp32 state's at the
// 67 TFLOP/s of fp32 outside the tensor cores (the fp32 fold asks for full
// fp32, which the tensor cores do not give): 1.17 ms a frame.
//
// Design (simple first; the K2 pipeline's wgmma is a later step):
//   * One warp a ray, one lane a sample (K <= 32): lane k's 13 code values
//     stay in registers, and it walks the hidden units j one at a time:
//     h_j from 16 FMAs on a row of W_z, then 68 (or 20) FMAs into its
//     output accumulators from a row of W2. Every lane of the warp reads
//     the same shared-memory word (a broadcast, no bank conflict), four
//     floats a load.
//   * W_z (transposed, 16 columns) and W2 (rows padded to EP floats) sit in
//     shared memory in fp32 for the block's life; blocks are persistent
//     and walk rays in steps of the grid's warps.
//   * Compositing is warp-parallel: the next sample's depth by a shuffle,
//     the transmittance as an exclusive product scan, the depth and the
//     weight total as butterfly sums, the median's CDF as a prefix sum and
//     its index as a count of ballots; each feature column a butterfly sum,
//     kept by the lane that writes it, so the row goes out coalesced.
//   * The host side keeps the SM count per device: a launch asks the
//     runtime nothing else.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 2;   // blocks an SM the registers are divided for
constexpr int CZ = 16;          // z-code columns, zero-padded
constexpr int MAX_D = 128;
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
  long long N;
  int K, D, E, Cz, bf16, num_freqs, include_input, inv_z, hard_cap, median;
  float zn_sub, zn_den, freq_factor;
};

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float weight_at(const void* w, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]) : static_cast<const float*>(w)[i];
}

__device__ inline float softplus(float x) { return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int EP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) encode_view_kernel(const Params P) {
  extern __shared__ float4 smem4[];
  float* s_wz = reinterpret_cast<float*>(smem4);  // (D, CZ): s_wz[j CZ + c] = W_z[c, j]
  float* s_w2 = s_wz + MAX_D * CZ;                 // (D, EP)
  float* s_b2 = s_w2 + MAX_D * EP;                 // (EP,)
  float* s_base = s_b2 + EP;                       // (WARPS, D)
  const int D = P.D, E = P.E, K = P.K;
  for (int i = threadIdx.x; i < D * CZ; i += THREADS) {
    const int j = i / CZ, c = i - j * CZ;
    s_wz[i] = c < P.Cz ? weight_at(P.w_z, c * D + j, P.bf16) : 0.f;
  }
  for (int i = threadIdx.x; i < D * EP; i += THREADS) {
    const int j = i / EP, e = i - j * EP;
    s_w2[i] = e < E ? weight_at(P.w2, j * E + e, P.bf16) : 0.f;
  }
  for (int e = threadIdx.x; e < EP; e += THREADS) s_b2[e] = e < E ? P.b2[e] : 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* base = s_base + warp * MAX_D;
  const bool live = lane < K;
  for (long long r = (long long)blockIdx.x * WARPS + warp; r < P.N; r += (long long)gridDim.x * WARPS) {
    for (int j = lane; j < D; j += 32) base[j] = __ldg(P.base + r * D + j);

    // the sample's z code, in registers
    const float zk = live ? __ldg(P.z + r * K + lane) : 0.f;
    const float dl = __fmul_rn(zk, __ldg(P.zscale + r));
    const float zn01 = P.inv_z ? __fdiv_rn(__fsub_rn(__fdiv_rn(1.f, fmaxf(dl, EPS)), P.zn_sub), P.zn_den)
                               : __fdiv_rn(__fsub_rn(dl, P.zn_sub), P.zn_den);
    const float zn = __fsub_rn(__fmul_rn(2.f, zn01), 1.f);
    float code[CZ];
#pragma unroll
    for (int c = 0; c < CZ; ++c) {
      const int f = (c - P.include_input) >> 1;
      float v = 0.f;
      if (c < P.Cz) {
        if (P.include_input && c == 0) {
          v = zn;
        } else {
          const float freq = P.freq_factor * (float)(1 << f);
          const float phase = ((c - P.include_input) & 1) ? HALF_PI : 0.f;
          v = sinf(__fadd_rn(__fmul_rn(zn, freq), phase));
        }
      }
      code[c] = P.bf16 ? round_bf16(v) : v;
    }
    __syncwarp();

    // both products, one hidden unit at a time
    float acc[EP];
#pragma unroll
    for (int e = 0; e < EP; ++e) acc[e] = 0.f;
    for (int j = 0; j < D; ++j) {
      const float4* wz = reinterpret_cast<const float4*>(s_wz + j * CZ);
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < CZ / 4; ++q) {
        const float4 w = wz[q];
        t = fmaf(code[4 * q], w.x, t);
        t = fmaf(code[4 * q + 1], w.y, t);
        t = fmaf(code[4 * q + 2], w.z, t);
        t = fmaf(code[4 * q + 3], w.w, t);
      }
      float h = __fadd_rn(base[j], t);
      h = h < 0.f ? 0.f : h;  // relu; NaN stays NaN, as torch.relu
      if (P.bf16) h = round_bf16(h);
      const float4* w2 = reinterpret_cast<const float4*>(s_w2 + j * EP);
#pragma unroll
      for (int q = 0; q < EP / 4; ++q) {
        const float4 w = w2[q];
        acc[4 * q] = fmaf(h, w.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(h, w.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(h, w.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(h, w.w, acc[4 * q + 3]);
      }
    }

    // compositing along the ray, one sample a lane
    const float z_next = __shfl_down_sync(FULL, zk, 1);
    float alpha = 0.f, fl = 1.f;
    if (live) {
      const float sigma = softplus(__fadd_rn(acc[0], s_b2[0]));
      const float delta = lane + 1 < K ? __fsub_rn(z_next, zk) : 1e10f;
      alpha = 1.f - expf(-fabsf(delta) * fmaxf(sigma, 0.f));
      if (P.hard_cap && lane == K - 1) alpha = 1.f;
      fl = fmaxf(1.f - alpha, 1e-10f);
    }
    float incl = fl;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl *= v;
    }
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 1.f;
    const float w = alpha * excl;  // 0 on dead lanes
    const float total = warp_sum(w);
    float depth;
    if (!P.median) {
      depth = warp_sum(w * zk);
    } else {
      float cum = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(FULL, cum, o);
        if (lane >= o) cum += v;
      }
      const unsigned below = __ballot_sync(FULL, live && __fdiv_rn(cum, fmaxf(total, 1e-10f)) < 0.5f);
      depth = __shfl_sync(FULL, zk, min(__popc(below), K - 1));
    }

    // the weighted feature columns 1..E-1: column e is kept by lane (e - 1) % 32
    float mine[(EP + 31) / 32];
#pragma unroll
    for (int e = 1; e < EP; ++e) {
      if (e < E) {
        const float s = warp_sum(w * __fadd_rn(acc[e], s_b2[e]));
        if (lane == ((e - 1) & 31)) mine[(e - 1) >> 5] = s;
      }
    }
    float* dino = P.dino + r * (E - 1);
#pragma unroll
    for (int i = 0; i < (EP + 31) / 32; ++i) {
      const int e = 32 * i + lane;
      if (e < E - 1) dino[e] = mine[i];
    }
    if (lane < 3) P.rgb[r * 3 + lane] = __ldg(P.color + r * 3 + lane) * total;
    if (lane == 0) P.depth[r] = depth;
    __syncwarp();  // base is rewritten for the next ray
  }
}

constexpr int MAX_DEVICES = 64;

template <int EP>
size_t smem_bytes() {
  return sizeof(float) * ((size_t)MAX_D * CZ + (size_t)MAX_D * EP + EP + (size_t)WARPS * MAX_D);
}

// the current device's SM count, asked of the runtime once per device
cudaError_t sm_count(int* sms) {
  static int known[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (known[dev] == 0) {
    err = cudaDeviceGetAttribute(&known[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = known[dev];
  return cudaSuccess;
}

template <int EP>
int launch(const Params& P, void* stream) {
  static_assert(sizeof(float) * ((size_t)MAX_D * CZ + (size_t)MAX_D * EP + EP + (size_t)WARPS * MAX_D) <= 48 * 1024,
                "the kernel's shared memory must fit the default 48 KB");
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (P.N + WARPS - 1) / WARPS;
  if (blocks > (long long)sms * MIN_BLOCKS) blocks = (long long)sms * MIN_BLOCKS;
  encode_view_kernel<EP><<<(int)blocks, THREADS, smem_bytes<EP>(), (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers are device pointers on the current device; the wrapper
// (kernels/encode_view.py) checks dtypes, shapes and contiguity. Returns a
// cudaError_t (0 = launched).
extern "C" int encode_view(
    const void* base, const void* z, const void* zscale, const void* w_z, const void* w2, const void* b2,
    const void* color, void* depth, void* dino, void* rgb,
    long long N, int K, int D, int E, int Cz, int bf16,
    int num_freqs, int include_input, int inv_z, int hard_cap, int median,
    float zn_sub, float zn_den, float freq_factor, void* stream) {
  if (N <= 0 || K <= 0 || K > 32 || D <= 0 || D > MAX_D || E < 2 || E > 68 || Cz <= 0 || Cz > CZ ||
      Cz != (include_input ? 1 : 0) + 2 * num_freqs)
    return (int)cudaErrorInvalidValue;
  Params P = {(const float*)base, (const float*)z, (const float*)zscale, w_z, w2, (const float*)b2,
              (const float*)color, (float*)depth, (float*)dino, (float*)rgb,
              N, K, D, E, Cz, bf16, num_freqs, include_input, inv_z, hard_cap, median,
              zn_sub, zn_den, freq_factor};
  return E <= 20 ? launch<20>(P, stream) : launch<68>(P, stream);
}
