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
// Two kernels, as in the TPU design:
//   * attention_bwd_dq: one block of 4 warps per (query tile of 64, head,
//     batch). It first computes di for its rows (fp32, written for the
//     dkv kernel), keeps its Q and dO fragments in registers, then walks
//     over the key/value tiles: S = Q K^T and dP = dO V^T on the tensor
//     cores, P and dS in fp32 on the CUDA cores, dQ += dS K accumulated in
//     fp32 fragments that stay in registers for the whole walk.
//   * attention_bwd_dkv: one block per (key tile of 64, head, batch). It
//     keeps its K and V fragments in registers and walks over the query
//     tiles: S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
//     dK += dS^T Q, both accumulated in fp32 register fragments.
// Each warp owns 16 rows of its block's tile; its rows of S, dP, P and dS
// live in shared memory only between the products (WMMA: bf16 inputs,
// fp32 accumulation; P and dS are rounded to bf16 for the products).
// The N x N matrices never reach device memory.
//
// The ragged tail (N = 1921 at ViT-B/8 on 192x640) is masked in the
// kernels: tile rows past N are zero-filled, their probabilities are 0,
// and nothing is written past N.
//
// Bound on the H100: at (4, 1921, 12, 64) dq does 3 products and dkv 4,
// each 2 N^2 D B H = 14.2 GFLOP, against about 2.4 MB per tensor, so both
// are bound by operations (tensor-core peak). Not yet used: wgmma, TMA,
// double-buffered tiles (later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 64;        // head dim
constexpr int BT = 64;       // rows of the block's own tile and of each walked tile
constexpr int THREADS = 128; // 4 warps x 16 rows
constexpr int LDH = D + 8;   // bf16 stride of the q, k, v, dO tiles
constexpr int LDP = BT + 8;  // bf16 stride of P and dS
constexpr int LDS = BT + 4;  // fp32 stride of S and dP
constexpr float LOG2E = 1.4426950408889634f;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct Smem {
  __nv_bfloat16 own0[BT * LDH];  // dq: Q    dkv: K
  __nv_bfloat16 own1[BT * LDH];  // dq: dO   dkv: V
  __nv_bfloat16 walk0[BT * LDH]; // dq: K    dkv: Q
  __nv_bfloat16 walk1[BT * LDH]; // dq: V    dkv: dO
  __nv_bfloat16 p[BT * LDP];     // dkv: P^T (bf16)
  __nv_bfloat16 ds[BT * LDP];    // dq: dS   dkv: dS^T (bf16, scale applied)
  float s[BT * LDS];             // S (or S^T), fp32; the result tile at the end
  float dp[BT * LDS];            // dP (or dP^T), fp32
  float lse[BT];                 // dkv: lse of the walked query tile (base 2)
  float di[BT];                  // di of the query rows in play
};

// rows [row0, row0 + 64) of head h of a (B, N, H, D) tensor; rows past N are 0
__device__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int b, int h,
                          int row0, int N, int H) {
  for (int i = threadIdx.x; i < BT * (D / 8); i += THREADS) {
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

// the warp's 16 x 64 fp32 accumulator tile -> bf16 rows < N of a (B, N, H, D) tensor
__device__ void store_rows(FragC (&acc)[D / 16], float* stage, __nv_bfloat16* dst, int b, int h,
                           int row0, int N, int H) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* base = stage + warp * 16 * LDS;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(base + j * 16, acc[j], LDS, wmma::mem_row_major);
  }
  __syncwarp();
  const int row = lane / 2;
  const int half = lane % 2;
  const int n = row0 + warp * 16 + row;
  if (n < N) {
    __nv_bfloat16* out = dst + ((size_t)(b * N + n) * H + h) * D;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) {
      out[c] = __float2bfloat16(base[row * LDS + c]);
    }
  }
}

// acc[j] (16 x 16 block j of a 16 x 64 result) += A (16 x 64, row-major at a)
// times B (64 x 64, row-major at b)
__device__ void mma_rows(FragC (&acc)[D / 16], const __nv_bfloat16* a, int lda,
                         const __nv_bfloat16* b) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      FragA af;
      FragBRow bf;
      wmma::load_matrix_sync(af, a + kk * 16, lda);
      wmma::load_matrix_sync(bf, b + kk * 16 * LDH + j * 16, LDH);
      wmma::mma_sync(acc[j], af, bf, acc[j]);
    }
  }
}

// out (the warp's 16 x 64 fp32 rows at out) = A (register fragments,
// 16 x D) times the transpose of the 64 x D tile at t
__device__ void mma_nt(float* out, const FragA (&a)[D / 16], const __nv_bfloat16* t) {
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBCol bf;
      wmma::load_matrix_sync(bf, t + j * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, a[kk], bf, acc);
    }
    wmma::store_matrix_sync(out + j * 16, acc, LDS, wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(THREADS)
attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        __nv_bfloat16* __restrict__ dq, float* __restrict__ di_out, int N, int H,
                        float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bh = (size_t)b * H + h;

  load_tile(sm.own0, q, b, h, q0, N, H);
  load_tile(sm.own1, dout, b, h, q0, N, H);
  // di = rowsum(dO * o) in fp32, two threads per row
  {
    const int r = threadIdx.x / 2;
    const int half = threadIdx.x % 2;
    const int n = q0 + r;
    float acc = 0.f;
    if (n < N) {
      const __nv_bfloat16* orow = o + ((size_t)(b * N + n) * H + h) * D;
      const __nv_bfloat16* drow = dout + ((size_t)(b * N + n) * H + h) * D;
      for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) {
        acc += __bfloat162float(orow[c]) * __bfloat162float(drow[c]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sm.di[r] = acc;
      if (n < N) di_out[bh * N + n] = acc;
    }
  }
  __syncthreads();

  FragA qf[D / 16], df[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sm.own0 + warp * 16 * LDH + kk * 16, LDH);
    wmma::load_matrix_sync(df[kk], sm.own1 + warp * 16 * LDH + kk * 16, LDH);
  }
  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  const int row = lane / 2;
  const int half = lane % 2;
  const int n = q0 + warp * 16 + row;
  const float lse2 = n < N ? lse[bh * N + n] * LOG2E : 0.f;
  const float di = sm.di[warp * 16 + row];
  const float scale_log2 = scale * LOG2E;
  float* srow = sm.s + (warp * 16 + row) * LDS;
  float* dprow = sm.dp + (warp * 16 + row) * LDS;
  __nv_bfloat16* dsrow = sm.ds + (warp * 16 + row) * LDP;

  for (int k0 = 0; k0 < N; k0 += BT) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sm.walk0, k, b, h, k0, N, H);
    load_tile(sm.walk1, v, b, h, k0, N, H);
    __syncthreads();

    mma_nt(sm.s + warp * 16 * LDS, qf, sm.walk0);   // S = Q K^T
    mma_nt(sm.dp + warp * 16 * LDS, df, sm.walk1);  // dP = dO V^T
    __syncwarp();

    const int nvalid = min(BT, N - k0);
    for (int c = half * (BT / 2); c < (half + 1) * (BT / 2); ++c) {
      float ds = 0.f;
      if (c < nvalid && n < N) {
        const float p = exp2f(srow[c] * scale_log2 - lse2);
        ds = p * (dprow[c] - di) * scale;
      }
      dsrow[c] = __float2bfloat16(ds);
    }
    __syncwarp();

    mma_rows(acc, sm.ds + warp * 16 * LDP, LDP, sm.walk0);  // dQ += dS K
  }
  store_rows(acc, sm.s, dq, b, h, q0, N, H);
}

__global__ void __launch_bounds__(THREADS)
attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di_in,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N,
                         int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bh = (size_t)b * H + h;

  load_tile(sm.own0, k, b, h, k0, N, H);
  load_tile(sm.own1, v, b, h, k0, N, H);
  __syncthreads();

  FragA kf[D / 16], vf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(kf[kk], sm.own0 + warp * 16 * LDH + kk * 16, LDH);
    wmma::load_matrix_sync(vf[kk], sm.own1 + warp * 16 * LDH + kk * 16, LDH);
  }
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  const int row = lane / 2;
  const int half = lane % 2;
  const float scale_log2 = scale * LOG2E;
  float* srow = sm.s + (warp * 16 + row) * LDS;
  float* dprow = sm.dp + (warp * 16 + row) * LDS;
  __nv_bfloat16* prow = sm.p + (warp * 16 + row) * LDP;
  __nv_bfloat16* dsrow = sm.ds + (warp * 16 + row) * LDP;

  for (int q0 = 0; q0 < N; q0 += BT) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile(sm.walk0, q, b, h, q0, N, H);
    load_tile(sm.walk1, dout, b, h, q0, N, H);
    if (threadIdx.x < BT) {
      const int n = q0 + threadIdx.x;
      sm.lse[threadIdx.x] = n < N ? lse[bh * N + n] * LOG2E : 0.f;
      sm.di[threadIdx.x] = n < N ? di_in[bh * N + n] : 0.f;
    }
    __syncthreads();

    mma_nt(sm.s + warp * 16 * LDS, kf, sm.walk0);   // S^T = K Q^T
    mma_nt(sm.dp + warp * 16 * LDS, vf, sm.walk1);  // dP^T = V dO^T
    __syncwarp();

    const int nvalid = min(BT, N - q0);
    for (int c = half * (BT / 2); c < (half + 1) * (BT / 2); ++c) {
      float p = 0.f, ds = 0.f;
      if (c < nvalid) {
        p = exp2f(srow[c] * scale_log2 - sm.lse[c]);
        ds = p * (dprow[c] - sm.di[c]) * scale;
      }
      prow[c] = __float2bfloat16(p);
      dsrow[c] = __float2bfloat16(ds);
    }
    __syncwarp();

    mma_rows(dv_acc, sm.p + warp * 16 * LDP, LDP, sm.walk1);   // dV += P^T dO
    mma_rows(dk_acc, sm.ds + warp * 16 * LDP, LDP, sm.walk0);  // dK += dS^T Q
  }
  store_rows(dk_acc, sm.s, dk, b, h, k0, N, H);
  __syncwarp();
  store_rows(dv_acc, sm.dp, dv, b, h, k0, N, H);
}

bool bad_shape(int B, int N, int H, int head_dim) {
  return head_dim != D || B <= 0 || N <= 0 || H <= 0;
}

}  // namespace

// q, k, v, o, dout, dq: (B, N, H, D) bf16; lse, di: (B, H, N) fp32; all
// contiguous on the current device. Writes dq and di.
// Returns a cudaError_t (0 = launched).
extern "C" int attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* dq, void* di, int B,
                                int N, int H, int head_dim, float scale, void* stream) {
  if (bad_shape(B, N, H, head_dim)) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BT - 1) / BT, H, B);
  attention_bwd_dq_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)lse,
      (__nv_bfloat16*)dq, (float*)di, N, H, scale);
  return (int)cudaGetLastError();
}

// q, k, v, dout, dk, dv: (B, N, H, D) bf16; lse, di: (B, H, N) fp32 (di
// from attention_bwd_dq); all contiguous on the current device. Writes dk
// and dv. Returns a cudaError_t (0 = launched).
extern "C" int attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* di, void* dk, void* dv, int B,
                                 int N, int H, int head_dim, float scale, void* stream) {
  if (bad_shape(B, N, H, head_dim)) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BT - 1) / BT, H, B);
  attention_bwd_dkv_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)di, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, N, H, scale);
  return (int)cudaGetLastError();
}
