// Flash-style attention forward at head dim 80, bf16 in and out (the
// I-JEPA-H/14 backbone: 16 heads of 80). Its backward, dq and dk/dv, is
// attention_d80_bwd.cu.
//
// Replaces, at D = 80: scenedino_tpu/models/vit.py:126 `_flash_mhsa`, which
// calls the library Pallas TPU kernel jax/experimental/pallas/ops/tpu/
// flash_attention.py (`_flash_attention_impl` :589) on q, k, v padded to a
// multiple of 512 tokens and masked by segment ids. The D = 64 kernels
// (attention.cu, attention_bwd.cu) are built on hopper.cuh's 64 x 64 tiles
// with a 128-byte swizzle; a 160-byte row of 80 bf16 values fits neither,
// so this file is its own design.
//
// Computes, for every (batch, head) of q, k, v laid out (B, N, H, 80):
//   attention_d80_fwd:     out = softmax(q k^T * scale) v and, when the
//                          caller passes an fp32 (B, H, N) buffer, each
//                          row's log-sum-exp (natural log), which the
//                          backward reads.
//
// Bound on the H100: operations. The forward does 4 N^2 D B H FLOP (7.0
// GFLOP at (4, 585, 16, 80), 0.0071 ms at 989 TFLOP/s) against 4 N D B H
// bf16 values moved (12 MB, 0.0036 ms).
//
// What the design does about it: FlashAttention-2 on the warp-level tensor
// core product mma.sync.m16n8k16 (bf16 in, fp32 accumulate; valid on
// sm_90a), which takes any multiple of 16 for the reduced dimension (80 = 5
// steps of 16) and of 8 for the output one (80 = 10 tiles of 8), so no row
// is padded in the products. A simple, correct kernel; wgmma and TMA, as the
// backward and the D = 64 kernels use, are later work.
//   * A block is 4 warps. Each warp owns 16 query rows (64 a block) and
//     keeps its Q fragments in registers, loaded once from device memory;
//     the block walks the key and value tiles (64 rows).
//   * Walked tiles go through shared memory in two slots: cp.async copies
//     tile t + 1 while tile t is computed. A row is stored at a stride of
//     88 values (176 bytes), so the eight 16-byte rows that one ldmatrix
//     reads fall in distinct banks. ldmatrix (.trans where the tile's rows
//     are the product's reduced dimension) loads the B fragments.
//   * Scores stay in registers; the online softmax runs on them in fp32,
//     base 2 (scale * log2(e) folded into one fma before exp2), a row's max
//     and sum over the quad of lanes that hold it by two shuffles. P is
//     rounded to bf16 as the A operand of the next product: the
//     accumulator layout of two 8-column tiles is the A layout of one
//     16-deep step.
//   * The ragged tail: cp.async zero-fills rows past N. Key columns past N
//     are set to -inf before the softmax. Rows past N are computed and never
//     stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 80;        // head dim
constexpr int KSTEPS = D / 16;  // 16-deep product steps over the head dim
constexpr int DTILES = D / 8;   // 8-wide output tiles over the head dim
constexpr int LD = 88;       // shared row stride in values: 176 bytes
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int QROWS = 16 * WARPS;  // query rows of a block
constexpr int KT = 64;             // key rows of a walked tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

static_assert(D % 16 == 0 && DTILES % 2 == 0, "the head dim must be a multiple of 16");
static_assert((LD * 2) % 16 == 0, "shared rows must stay 16-byte aligned");

// element offset of (batch b, token n, head h, 0) in a (B, N, H, D) tensor
__device__ __forceinline__ size_t row_at(int b, int n, int h, int N, int H) {
  return ((size_t)b * N + n) * (size_t)H * D + (size_t)h * D;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared; zero-filled when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// `rows` rows of D values of head h from token row0 on into a shared tile
// of stride LD; rows at or past N are zero-filled
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* __restrict__ g, int b, int h, int row0, int N,
                                          int H) {
  constexpr int CHUNKS = D / 8;  // 16-byte pieces of a row
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, part = c % CHUNKS;
    const int n = row0 + r;
    const bool valid = n < N;
    cp_async16(tile + r * LD + part * 8, valid ? g + row_at(b, n, h, N, H) + part * 8 : g, valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// B fragments of two 8-wide output tiles (n0, n0 + 8) for the 16-deep step
// at k0, from a tile whose ROWS are the output dimension (B[k][n] =
// tile[n][k]): r[0], r[1] are tile n0's b0, b1; r[2], r[3] tile n0 + 8's
__device__ __forceinline__ void frag_b_rows_n(uint32_t (&r)[4], const bf16* tile, int n0, int k0, int lane) {
  ldsm_x4(r, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 + ((lane >> 3) & 1) * 8);
}
// the same from a tile whose ROWS are the reduced dimension (B[k][n] = tile[k][n])
__device__ __forceinline__ void frag_b_rows_k(uint32_t (&r)[4], const bf16* tile, int k0, int n0, int lane) {
  ldsm_x4_trans(r, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8);
}

// c += a b, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) { return __ldg(reinterpret_cast<const unsigned int*>(p)); }

// A fragments (16 rows from r0, all D columns) of a (B, N, H, D) tensor,
// straight from device memory; rows at or past N are 0
__device__ __forceinline__ void load_frag_a(uint32_t (&a)[KSTEPS][4], const bf16* __restrict__ x, int b, int r0,
                                            int h, int N, int H, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = r0 + g + 8;
  const bf16* pa = x + row_at(b, ra < N ? ra : 0, h, N, H);
  const bf16* pb = x + row_at(b, rb < N ? rb : 0, h, N, H);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = ra < N ? ldg32(pa + c) : 0u;
    a[kk][1] = rb < N ? ldg32(pb + c) : 0u;
    a[kk][2] = ra < N ? ldg32(pa + c + 8) : 0u;
    a[kk][3] = rb < N ? ldg32(pb + c + 8) : 0u;
  }
}

// acc (16 x 8 tiles, DTILES of them) to bf16 rows r0 .. r0 + 15 below N,
// each multiplied by its row's factor
__device__ __forceinline__ void store_rows(bf16* __restrict__ y, const float (&acc)[DTILES][4], float fa, float fb,
                                           int b, int r0, int h, int N, int H, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
  for (int n = 0; n < DTILES; ++n) {
    const int c = n * 8 + 2 * t;
    if (ra < N) *reinterpret_cast<uint32_t*>(y + row_at(b, ra, h, N, H) + c) = pack_bf16(acc[n][0] * fa, acc[n][1] * fa);
    if (rb < N) *reinterpret_cast<uint32_t*>(y + row_at(b, rb, h, N, H) + c) = pack_bf16(acc[n][2] * fb, acc[n][3] * fb);
  }
}

// s (16 rows x 64 keys: 8 tiles of 8) = A B^T over D, B's rows from a
// shared tile of 64 rows
__device__ __forceinline__ void scores64(float (&s)[8][4], const uint32_t (&a)[KSTEPS][4], const bf16* tile,
                                         int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t bf[4];
      frag_b_rows_n(bf, tile, j * 8, kk * 16, lane);
      mma(s[j], a[kk], bf[0], bf[1]);
      mma(s[j + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// acc (16 rows x D) += P T, P given as A fragments over 16 * KS rows of
// the shared tile T (its rows are the reduced dimension)
template <int KS>
__device__ __forceinline__ void accumulate_pv(float (&acc)[DTILES][4], const uint32_t (&p)[KS][4], const bf16* tile,
                                              int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int n = 0; n < DTILES; n += 2) {
      uint32_t bf[4];
      frag_b_rows_k(bf, tile, kk * 16, n * 8, lane);
      mma(acc[n], p[kk], bf[0], bf[1]);
      mma(acc[n + 1], p[kk], bf[2], bf[3]);
    }
  }
}

// key columns at or past N of the tile starting at key0 -> -inf
__device__ __forceinline__ void mask_keys(float (&s)[8][4], int key0, int N, int lane) {
  if (key0 + KT <= N) return;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (key0 + j * 8 + 2 * t + (e & 1) >= N) s[j][e] = -INFINITY;
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(THREADS) attention_d80_fwd_kernel(const bf16* __restrict__ q,
                                                                    const bf16* __restrict__ k,
                                                                    const bf16* __restrict__ v, bf16* __restrict__ out,
                                                                    float* __restrict__ lse, int N, int H,
                                                                    float scale_log2) {
  __shared__ __align__(16) bf16 sk[2][KT * LD];
  __shared__ __align__(16) bf16 sv[2][KT * LD];
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * QROWS + warp * 16;
  const int tiles = (N + KT - 1) / KT;

  load_tile<KT>(sk[0], k, b, h, 0, N, H);
  load_tile<KT>(sv[0], v, b, h, 0, N, H);
  cp_async_commit();
  uint32_t qa[KSTEPS][4];
  load_frag_a(qa, q, b, r0, h, N, H, lane);

  float o[DTILES][4];
#pragma unroll
  for (int n = 0; n < DTILES; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m in logit units; l per lane

  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < tiles) {
      load_tile<KT>(sk[cur ^ 1], k, b, h, (it + 1) * KT, N, H);
      load_tile<KT>(sv[cur ^ 1], v, b, h, (it + 1) * KT, N, H);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    float s[8][4];
    scores64(s, qa, sk[cur], lane);
    mask_keys(s, it * KT, N, lane);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);  // 0 on the first tile (m = -inf)
      m[r] = mx[r];
      base[r] = m[r] * scale_log2;
    }
    uint32_t pa[4][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(fmaf(s[j][0], scale_log2, -base[0]));
      const float p1 = exp2f(fmaf(s[j][1], scale_log2, -base[0]));
      const float p2 = exp2f(fmaf(s[j][2], scale_log2, -base[1]));
      const float p3 = exp2f(fmaf(s[j][3], scale_log2, -base[1]));
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < DTILES; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    accumulate_pv<4>(o, pa, sv[cur], lane);
    __syncthreads();  // every warp is done with slot `cur` before it is refilled
  }

  const float la = quad_sum(l[0]), lb = quad_sum(l[1]);
  store_rows(out, o, 1.f / la, 1.f / lb, b, r0, h, N, H, lane);
  if (lse != nullptr && t == 0) {
    const int ra = r0 + g, rb = r0 + g + 8;
    float* row = lse + ((size_t)b * H + h) * N;
    if (ra < N) row[ra] = (m[0] * scale_log2 + log2f(la)) * LN2;
    if (rb < N) row[rb] = (m[1] * scale_log2 + log2f(lb)) * LN2;
  }
}

bool bad_shape(int B, int N, int H, int head_dim) {
  return head_dim != D || B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535;
}

dim3 grid_of(int B, int N, int H) { return dim3((N + QROWS - 1) / QROWS, H, B); }

}  // namespace

// q, k, v, out: (B, N, H, 80) bf16; lse: (B, H, N) fp32 or null; all
// contiguous, 16-byte aligned, on the current device. Returns a cudaError_t
// (0 = launched).
extern "C" int attention_d80_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int N,
                                 int H, int head_dim, float scale, void* stream) {
  if (bad_shape(B, N, H, head_dim)) return (int)cudaErrorInvalidValue;
  attention_d80_fwd_kernel<<<grid_of(B, N, H), THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse, N, H, scale * LOG2E);
  return (int)cudaGetLastError();
}
