// The wide walk: what csrc/point_render.cu (K2, K3, K4) and
// csrc/encode_view.cu (K6) run past the widths their shipped
// instantiations hold resident (hidden units past 128, output columns past
// 128 (K6: 68), code columns past 64 (K6: 32), samples a ray past 256, and
// for the point kernels a hidden width that is not a multiple of 8).
//
// A block is one warpgroup and owns a 64-row tile (wgmma's M = 64) at a
// time. Nothing of the head's weights stays resident: they are streamed.
//   * Before the walk, `pack_units` (a kernel of its own, launched by the
//     same entry point) writes the weights once a call into global memory as
//     the exact images of 128-byte-swizzled K-major tiles (hopper.cuh):
//     first the code product's units, hidden chunk c (64 units) by code tile
//     s (64 bf16 or 32 TF32 columns), then the output product's, output
//     chunk j (64 columns) by hidden k-tile kt; a TF32 unit is the hi tile
//     and then the lo tile (3xTF32). Zero-padded; the point kernels' hidden
//     units are permuted as their shipped kernels permute them.
//   * The walk consumes the same unit sequence tile after tile, through a
//     ring of SLOTS slots in shared memory that cp.async fills SLOTS - 1
//     units ahead (across tiles), so the weights stream from L2.
//   * The A operands are the tile's code (columns padded to a whole code
//     tile) and h (64 x 64 DC), kept in a plain row-major store with padded
//     rows: in shared memory where it fits beside the rest, else in the
//     block's share of a global scratch buffer (the same code: a generic
//     pointer). Each product step loads its A fragment from the store into
//     registers (register-A wgmma), so neither store is swizzled.
//   * A unit's products are issued and waited for before the next unit is
//     taken: every wgmma's trip count is a uniform loop count, no wgmma is
//     predicated, and a slot is refilled only after the block's barrier
//     that follows every warp's wait.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace wide {

using namespace hopper;

constexpr int TP = 64;     // rows a tile: wgmma's M
constexpr int WG = 128;    // threads a block: one warpgroup
constexpr int SLOTS = 3;   // ring slots
constexpr int LDO = 72;    // row stride of the output buffer, = 8 mod 32
// shared memory a block may take with its A store in it: two blocks an SM
constexpr int SHARED_BUDGET = 113 * 1024;

// the ring: SLOTS units of `unit_bytes` in shared memory, filled from the
// packed units in global memory, unit g of the walk from unit g % nunits
struct Ring {
  unsigned char* slots;
  const unsigned char* src;
  uint32_t nunits;
  int unit_bytes;
};

__device__ __forceinline__ void ring_issue(const Ring& r, uint32_t g, int t) {
  const unsigned char* s = r.src + (size_t)(g % r.nunits) * r.unit_bytes;
  unsigned char* d = r.slots + (g % SLOTS) * r.unit_bytes;
  for (int i = 16 * t; i < r.unit_bytes; i += 16 * WG) cp_async_16(d + i, s + i);
  cp_async_commit();
}

// the first SLOTS - 1 units, before the walk
__device__ __forceinline__ void ring_start(const Ring& r, int t) {
#pragma unroll
  for (int g = 0; g < SLOTS - 1; ++g) ring_issue(r, g, t);
}

// waits for unit g and returns its slot's shared-memory address; refills the
// slot of unit g - 1 with unit g + SLOTS - 1. Every thread has waited for
// its products on unit g - 1 before it comes here, and the barrier holds the
// refill until all have.
__device__ __forceinline__ uint32_t ring_take(const Ring& r, uint32_t g, int t) {
  cp_async_wait<SLOTS - 2>();
  fence_proxy_async();  // the copies were made in the generic proxy; wgmma reads them in the async one
  __syncthreads();
  ring_issue(r, g + SLOTS - 1, t);
  return smem_u32(r.slots + (g % SLOTS) * r.unit_bytes);
}

// acc (+)= A[:, k0, k0 + 64) x the bf16 unit at `tile` (64 K-major rows, one
// a column of acc): A bf16, row stride lda elements, shared or global
__device__ __forceinline__ void unit_bf16(float (&acc)[32], const __nv_bfloat16* A, int lda, int k0, uint32_t tile,
                                          int row0, int q, int accumulate) {
  uint32_t a[16];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        a[4 * kk + 2 * half + hi] =
            *reinterpret_cast<const uint32_t*>(A + (size_t)(row0 + 8 * hi) * lda + k0 + 16 * kk + 8 * half + 2 * q);
      }
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n64k16_rs<0>(acc, a + 4 * kk, wgmma_desc_at(tile) + kk * WGMMA_K_STEP, accumulate || kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(acc);
}

// acc (+)= A[:, k0, k0 + 32) x the TF32 unit at `tile` (the hi tile, then
// the lo tile 8 KB on), in three passes: A_lo B_hi + A_hi B_lo + A_hi B_hi
// with A = A_hi + A_lo split where it is loaded (A fp32, row stride lda)
__device__ __forceinline__ void unit_tf32(float (&acc)[32], const float* A, int lda, int k0, uint32_t tile, int row0,
                                          int q, int accumulate) {
  uint32_t ah[16], al[16];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = A[(size_t)(row0 + 8 * (i & 1)) * lda + k0 + 8 * kk + q + 4 * (i >> 1)];
      const float hv = tf32_rna(v);
      ah[4 * kk + i] = __float_as_uint(hv);
      al[4 * kk + i] = __float_as_uint(tf32_rna(__fsub_rn(v, hv)));
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bh = wgmma_desc_at(tile) + kk * WGMMA_K_STEP;
    const uint64_t bl = wgmma_desc_at(tile + TILE_BYTES) + kk * WGMMA_K_STEP;
    wgmma_m64n64k8_tf32_rs(acc, al + 4 * kk, bh, accumulate || kk > 0);
    wgmma_m64n64k8_tf32_rs(acc, ah + 4 * kk, bl, 1);
    wgmma_m64n64k8_tf32_rs(acc, ah + 4 * kk, bh, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(acc);
}

// the grid channel that hidden unit n stands for under the point kernels'
// permutation (csrc/point_render.cu's hidden_channel, DC at run time)
__host__ __device__ inline int permuted_channel(int n, int DC) {
  const int c = n / 64, j = (n % 64) / 8, q = (n % 8) / 2, t = n % 2;
  return q * 16 * DC + 16 * c + 2 * j + t;
}

__device__ __forceinline__ float weight(const void* w, size_t i, int tf32) {
  return tf32 ? static_cast<const float*>(w)[i] : __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
}

// The packed units (see the header): w_code (C, D) and w2 (D, E), fp32
// (TF32) or bf16. Code product units DC x CT, then output units EC x KT.
template <int TF32, int PERM>
__global__ void pack_units(const void* w_code, const void* w2, int D, int E, int C, int DC, int CT, int KT, int NU,
                           unsigned char* out) {
  constexpr int KW = TF32 ? 32 : 64;  // columns a tile row holds
  constexpr int UB = TF32 ? 2 * TILE_BYTES : TILE_BYTES;
  const int nw = DC * CT;
  const size_t total = (size_t)NU * 64 * KW;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += (size_t)gridDim.x * blockDim.x) {
    const int u = (int)(i / (64 * KW)), n = (int)(i / KW % 64), k = (int)(i % KW);
    float v;
    if (u < nw) {  // hidden unit 64 c + n, code column KW s + k
      const int hidden = 64 * (u / CT) + n, col = KW * (u % CT) + k;
      const int ch = PERM ? permuted_channel(hidden, DC) : hidden;
      v = (col < C && ch < D) ? weight(w_code, (size_t)col * D + ch, TF32) : 0.f;
    } else {  // output column 64 j + n, hidden unit KW kt + k
      const int uo = u - nw, col = 64 * (uo / KT) + n, hidden = KW * (uo % KT) + k;
      const int ch = PERM ? permuted_channel(hidden, DC) : hidden;
      v = (col < E && ch < D) ? weight(w2, (size_t)ch * E + col, TF32) : 0.f;
    }
    unsigned char* tile = out + (size_t)u * UB;
    if (TF32) {
      const float hv = tf32_rna(v);
      *reinterpret_cast<float*>(tile + swizzled_element(n, k, 4)) = hv;
      *reinterpret_cast<float*>(tile + TILE_BYTES + swizzled_element(n, k, 4)) = tf32_rna(__fsub_rn(v, hv));
    } else {
      *reinterpret_cast<__nv_bfloat16*>(tile + swizzled_element(n, k, 2)) = __float2bfloat16(v);
    }
  }
}

// the shared-memory attribute once per device and kernel, then the blocks an
// SM at `smem` bytes
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int smem, bool& ready, int& per_sm) {
  cudaError_t err;
  if (!ready) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WG, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  return 0;
}

inline long long round_up(long long v, long long m) { return (v + m - 1) / m * m; }

}  // namespace wide
