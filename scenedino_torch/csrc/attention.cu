// Flash-style attention forward for the DINO ViT, bf16 in and out.
//
// Replaces: scenedino_tpu/models/vit.py:126 `_flash_mhsa`, which calls the
// library Pallas TPU kernel jax/experimental/pallas/ops/tpu/flash_attention.py
// (`_flash_attention_impl`, pallas_call at :758) on q, k, v padded to a
// multiple of 512 tokens and masked by segment ids.
//
// Computes out = softmax(q k^T * scale) v for every (batch, head) of
// q, k, v laid out (B, N, H, D), D = 64. At ViT-B/8 on a 192x640 image
// (B=1, N=1921, H=12) one call does 4*N^2*D*H = 11.3 GFLOP and moves
// about 3.9 MB, so it is bound by operations: about 11 us at the H100's
// 989 TFLOP/s bf16 tensor-core peak against 1.2 us for the bytes.
//
// Design: one block of 4 warps per (query tile of 64, head, batch). Each
// warp owns 16 query rows and keeps its Q fragments in registers. Key and
// value tiles of 64 rows are staged in shared memory; S = Q K^T and
// O += P V run on the tensor cores through WMMA (bf16 inputs, fp32
// accumulation). The softmax is online, in fp32, in base 2: a running
// max and sum per row, the fp32 accumulator O in shared memory rescaled
// before each P V product, P rounded to bf16 for the product. The N x N
// logits never reach device memory. The ragged tail is masked in the
// kernel: key rows past N are zero-filled and given zero probability,
// query rows past N are not written, so nothing is padded to 512.
// When the caller needs a gradient it passes an fp32 (B, H, N) buffer
// and the kernel also writes each row's log-sum-exp of the scaled logits
// (natural log), which the backward kernels (attention_bwd.cu) read
// instead of recomputing the softmax statistics.
// Not yet used: wgmma, TMA, double-buffered tiles (later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key rows per tile
constexpr int THREADS = 128; // 4 warps x 16 query rows
constexpr int LDH = D + 8;   // bf16 stride of the q, k, v tiles
constexpr int LDP = BK + 8;  // bf16 stride of P
constexpr int LDS = BK + 4;  // fp32 stride of S
constexpr int LDO = D + 4;   // fp32 stride of O

struct Smem {
  __nv_bfloat16 q[BQ * LDH];
  __nv_bfloat16 k[BK * LDH];
  __nv_bfloat16 v[BK * LDH];
  __nv_bfloat16 p[BQ * LDP];
  float s[BQ * LDS];
  float o[BQ * LDO];
};

// rows [row0, row0 + 64) of head h of a (B, N, H, D) tensor; rows past N are 0
__device__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int b, int h,
                          int row0, int N, int H) {
  for (int i = threadIdx.x; i < 64 * (D / 8); i += THREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const int n = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) {
      val = *reinterpret_cast<const uint4*>(src + ((size_t)(b * N + n) * H + h) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int N, int H, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile(sm.q, q, b, h, q0, N, H);
  for (int i = threadIdx.x; i < BQ * LDO; i += THREADS) sm.o[i] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sm.q + warp * 16 * LDH + kk * 16, LDH);
  }

  // two lanes per query row, each over half of the columns
  const int row = lane / 2;
  const int half = lane % 2;
  float* srow = sm.s + (warp * 16 + row) * LDS;
  float* orow = sm.o + (warp * 16 + row) * LDO;
  __nv_bfloat16* prow = sm.p + (warp * 16 + row) * LDP;
  float m = -INFINITY;  // running max of the scaled logits, base 2
  float l = 0.f;        // running sum of probabilities

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sm.k, k, b, h, k0, N, H);
    load_tile(sm.v, v, b, h, k0, N, H);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sm.k + j * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(sm.s + warp * 16 * LDS + j * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    const int nvalid = min(BK, N - k0);
    float mx = -INFINITY;
    for (int c = half * (BK / 2); c < (half + 1) * (BK / 2); ++c) {
      if (c < nvalid) mx = fmaxf(mx, srow[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx * scale_log2);
    float sum = 0.f;
    for (int c = half * (BK / 2); c < (half + 1) * (BK / 2); ++c) {
      const float p = c < nvalid ? exp2f(srow[c] * scale_log2 - m_new) : 0.f;
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = exp2f(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) orow[c] *= alpha;
    __syncwarp();

#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sm.o + warp * 16 * LDO + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, sm.p + warp * 16 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(vf, sm.v + kk * 16 * LDH + j * 16, LDH);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(sm.o + warp * 16 * LDO + j * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int n = q0 + warp * 16 + row;
  if (n < N) {
    const float inv = 1.f / l;
    __nv_bfloat16* dst = out + ((size_t)(b * N + n) * H + h) * D;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) {
      dst[c] = __float2bfloat16(orow[c] * inv);
    }
    if (lse != nullptr && half == 0) {
      lse[((size_t)b * H + h) * N + n] = (m + log2f(l)) * 0.6931471805599453f;
    }
  }
}

}  // namespace

// q, k, v, out: (B, N, H, D) bf16, contiguous, on the current device;
// lse: (B, H, N) fp32 or null (not written).
// Returns a cudaError_t (0 = launched).
extern "C" int attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int B, int N, int H, int head_dim, float scale, void* stream) {
  if (head_dim != D || B <= 0 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BQ - 1) / BQ, H, B);
  attention_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, (float*)lse, N, H, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
