// K1 at every head dim but 64 and 80: softmax(Q K^T / sqrt(D)) V over
// (B, N, H, D) bf16, its log-sum-exp, and the backward's dQ (with di =
// rowsum(dO o)) and dK, dV.
//
// Replaces, at the head dims that the tuned kernels do not take, the Pallas
// TPU flash attention reached from scenedino_tpu/models/vit.py:126
// `_flash_mhsa` and its custom VJP (`_flash_attention_bwd_dq`,
// `_flash_attention_bwd_dkv`), which take any D. A ViT from `vit_overrides`
// (configs/train_synthetic_smoke.yaml: width 64, 2 heads) has D = 32, the
// JAX package's own tests 8 and 16. D = 64 (attention.cu, attention_bwd.cu)
// and D = 80 (attention_d80.cu, attention_d80_bwd.cu) keep their kernels.
//
// Bound on the H100: at these head dims the products are small (4 N^2 D
// FLOP a head forward, 10 N^2 D backward) against the N D bytes a head
// reads, so above a few hundred tokens the tensor cores bound it: at the
// smoke config's ViT at 192x640 (B 2, N 1921, H 2, D 32) the forward is
// 1.9 GFLOP, about 1.9 us at 989 TFLOP/s, and moves 2.0 MB, about 0.6 us at
// 3.35 TB/s. mma.sync reaches well under that peak (it is wgmma that the
// card's full rate needs); this is the simple kernel first, FlashAttention-2
// on mma.sync m16n8k16, as the port's first D = 80 kernel was.
//
// Design:
//   * The head dim is a template argument PD, one of 32, 48, 64, 96, 128,
//     192 and 256: D is padded to the next of them inside the kernel, the
//     columns past D of every tile zero-filled in shared memory, so the
//     products over PD columns equal those over D; nothing past D is
//     stored. The softmax scale is the true D's. Above 256 the wrapper
//     raises.
//   * A block of 4 warps owns 64 query rows (16 a warp) of one head and
//     walks the key and value tiles (64 rows, 32 at PD > 128 to keep the
//     registers of S and O within budget) through two cp.async buffers:
//     tile t + 1 lands while tile t computes. Rows past N and columns past
//     D are zero-filled by the copy (a source size of 0). Where D % 8 != 0
//     a row is not 16-byte aligned, and the tiles are filled by plain loads.
//   * Operands come from shared memory by ldmatrix (rows padded by 8
//     columns: conflict-free), S = Q K^T and O += P V by mma.sync
//     m16n8k16 into fp32 registers. The online softmax runs on S's
//     registers in base 2 with the exact rescale (the running max moves
//     whenever it grows), P is rounded to bf16 as the A operand of P V, and
//     key columns past N of the last tile are -inf.
//   * dq: per 64 query rows, di = rowsum(dO o) in fp32 first, then over the
//     key tiles P = exp2(S scale log2(e) - lse log2(e)), dP = dO V^T,
//     dS = P (dP - di) / sqrt(D) and dQ += dS K, dS in bf16.
//   * dkv: per 64 key rows (16 a warp), over 32-row query tiles: S^T = K Q^T,
//     P^T, dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - di) / sqrt(D),
//     dK += dS^T Q. Query rows past N carry lse = +inf (P = 0) and di = 0.
//     Above PD = 128 a block accumulates half of dK's and dV's columns (the
//     grid's z holds the half): 2 x 128 fp32 a thread is what the registers
//     hold; S^T and dP^T are formed over all PD columns in both halves.
//   * No atomics: two launches give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;       // query rows a block (fwd, dq); key rows a block (dkv)
constexpr int BQ_DKV = 32;   // query rows a walked tile of dkv
constexpr int THREADS = 128;  // 4 warps, 16 rows each
constexpr int MAX_PD = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int PD>
struct Dims {
  static constexpr int LD = PD + 8;                  // row stride in shared memory (bf16)
  static constexpr int BK = PD > 128 ? 32 : 64;      // key rows a walked tile (fwd, dq)
  static constexpr int SPLIT = PD > 128 ? 2 : 1;     // column halves of dK and dV (dkv)
  static constexpr int SW = PD / SPLIT;              // columns of dK and dV a dkv block accumulates
};

// the padded head dim of D (0: none)
inline int padded(int D) {
  const int widths[] = {32, 48, 64, 96, 128, 192, 256};
  for (int w : widths) {
    if (D <= w) return w;
  }
  return 0;
}

__device__ __forceinline__ void cp_async_16_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b: a 16 x 16 (row-major fragment), b 16 x 8 (column-major), c 16 x 8 fp32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The thread's share of a product, in the m16n8k16 layouts (g = lane / 4,
// tq = lane % 4): an accumulator n-tile holds rows g (elements 0, 1) and
// g + 8 (2, 3) at columns 2 tq and 2 tq + 1.

// the A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a
// row-major tile of stride LD
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0, int c0, int lane) {
  ldsm_x4(a, tile + (r0 + lane % 16) * LD + c0 + (lane / 16) * 8);
}

// the B fragments of two n-tiles, n in [n0, n0 + 16), over k in [k0, k0 +
// 16), from a tile whose rows are n (b[0], b[1]: the first n-tile's)
template <int LD>
__device__ __forceinline__ void load_b_rows_n(uint32_t (&b)[4], const bf16* tile, int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane / 16) * 8 + lane % 8) * LD + k0 + ((lane / 8) % 2) * 8);
}

// the same from a tile whose rows are k
template <int LD>
__device__ __forceinline__ void load_b_rows_k(uint32_t (&b)[4], const bf16* tile, int n0, int k0, int lane) {
  ldsm_x4_t(b, tile + (k0 + ((lane / 8) % 2) * 8 + lane % 8) * LD + n0 + (lane / 16) * 8);
}

// accumulator n-tiles 2 kk and 2 kk + 1 (16 columns) as the A fragment of one k16 step
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&s)[NT][4], int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }
}

struct Shape {
  int N, H, D;
  bool vec;  // D % 8 == 0: 16-byte rows, filled by cp.async
};

// element (b, n, h, 0) of a contiguous (B, N, H, D) tensor
__device__ __forceinline__ size_t row_at(const Shape& s, int b, int n, int h) {
  return ((size_t)b * s.N + n) * s.H * s.D + (size_t)h * s.D;
}

// rows [row0, row0 + ROWS) of head h of batch b into `dst` (ROWS x LD),
// columns past D and rows past N zero
template <int PD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, const Shape& s, int b, int h, int row0) {
  constexpr int LD = Dims<PD>::LD, CH = PD / 8;
  if (s.vec) {
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, n = row0 + r;
      const bool ok = n < s.N && 8 * c < s.D;
      cp_async_16_zfill(dst + r * LD + 8 * c, ok ? src + row_at(s, b, n, h) + 8 * c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * PD; i += THREADS) {
      const int r = i / PD, c = i % PD, n = row0 + r;
      dst[r * LD + c] = n < s.N && c < s.D ? src[row_at(s, b, n, h) + c] : __float2bfloat16(0.f);
    }
  }
}

// rows g and g + 8 of a warp's 16, columns [c0, c0 + 8 NT) of an
// accumulator, times f[hi], to row `r0 + g + 8 hi` of head h (rows below N,
// columns below D)
template <int NT>
__device__ __forceinline__ void store_rows(bf16* dst, const Shape& s, int b, int h, int r0, int c0,
                                           const float (&acc)[NT][4], const float (&f)[2], int lane) {
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int n = r0 + g + 8 * hi;
    if (n >= s.N) continue;
    bf16* row = dst + row_at(s, b, n, h);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = c0 + 8 * nt + 2 * tq;
      const float x = acc[nt][2 * hi] * f[hi], y = acc[nt][2 * hi + 1] * f[hi];
      if (col + 1 < s.D && s.D % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x, y);
      } else {
        if (col < s.D) row[col] = __float2bfloat16(x);
        if (col + 1 < s.D) row[col + 1] = __float2bfloat16(y);
      }
    }
  }
}

// S (16 x 8 NT a warp) = rows [r0, r0 + 16) of `a_tile` times the rows of
// `b_tile` (n) over PD columns
template <int PD, int NT>
__device__ __forceinline__ void product_nt(float (&s)[NT][4], const bf16* a_tile, int r0, const bf16* b_tile,
                                           int lane) {
  constexpr int LD = Dims<PD>::LD;
  zero(s);
#pragma unroll
  for (int ks = 0; ks < PD / 16; ++ks) {
    uint32_t a[4];
    load_a<LD>(a, a_tile, r0, 16 * ks, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      load_b_rows_n<LD>(b, b_tile, 16 * np, 16 * ks, lane);
      mma(s[2 * np], a, b[0], b[1]);
      mma(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x 8 NT, columns [c0, c0 + 8 NT) of b_tile) += p (16 x 8 KT, in
// registers) times b_tile's rows (k) [0, 8 KT)
template <int LD, int KT, int NT>
__device__ __forceinline__ void product_pv(float (&acc)[NT][4], const float (&p)[KT][4], const bf16* b_tile, int c0,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < KT / 2; ++kk) {
    uint32_t a[4];
    acc_to_a(a, p, kk);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      load_b_rows_k<LD>(b, b_tile, c0 + 16 * np, 16 * kk, lane);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// ----------------------------------------------------------------- forward

template <int PD>
__global__ void __launch_bounds__(THREADS) fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                                      const bf16* __restrict__ v, bf16* __restrict__ out,
                                                      float* __restrict__ lse, const Shape s, float scale_log2) {
  using T = Dims<PD>;
  constexpr int LD = T::LD, BK = T::BK, NS = BK / 8, NO = PD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + BQ * LD;  // two buffers
  bf16* s_v = s_k + 2 * BK * LD;
  const int row0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane % 4;
  const int tiles = (s.N + BK - 1) / BK;

  load_tile<PD, BQ>(s_q, q, s, b, h, row0);
  load_tile<PD, BK>(s_k, k, s, b, h, 0);
  load_tile<PD, BK>(s_v, v, s, b, h, 0);
  cp_async_commit();

  float o[NO][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_tile<PD, BK>(s_k + (buf ^ 1) * BK * LD, k, s, b, h, (t + 1) * BK);
      load_tile<PD, BK>(s_v + (buf ^ 1) * BK * LD, v, s, b, h, (t + 1) * BK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float sc[NS][4];
    product_nt<PD>(sc, s_q, 16 * warp, s_k + buf * BK * LD, lane);
    if ((t + 1) * BK > s.N) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (t * BK + 8 * nt + 2 * tq + (i & 1) >= s.N) sc[nt][i] = -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[nt][0], sc[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[nt][2], sc[nt][3]));
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
      const float m_new = fmaxf(m[hi], mx[hi] * scale_log2);  // finite: every tile has a key below N
      alpha[hi] = fast_exp2(m[hi] - m_new);                    // 0 on the first tile (m = -inf)
      m[hi] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[nt][i] = fast_exp2(fmaf(sc[nt][i], scale_log2, -m[i / 2]));
        sum[i / 2] += sc[nt][i];
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) l[hi] = fmaf(l[hi], alpha[hi], sum[hi]);
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nt][i] *= alpha[i / 2];
    }
    product_pv<LD>(o, sc, s_v + buf * BK * LD, 0, lane);
    __syncthreads();  // this buffer is free for tile t + 2's copies
  }

  float inv[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
    inv[hi] = 1.f / l[hi];
  }
  const int r0 = row0 + 16 * warp;
  store_rows(out, s, b, h, r0, 0, o, inv, lane);
  if (lse != nullptr && tq == 0) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int n = r0 + lane / 4 + 8 * hi;
      if (n < s.N) lse[((size_t)b * s.H + h) * s.N + n] = (m[hi] + log2f(l[hi])) * LN2;
    }
  }
}

// ------------------------------------------------------------------ dq

template <int PD>
__global__ void __launch_bounds__(THREADS) dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                                                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                                                     bf16* __restrict__ dq, float* __restrict__ di, const Shape s,
                                                     float scale, float scale_log2) {
  using T = Dims<PD>;
  constexpr int LD = T::LD, BK = T::BK, NS = BK / 8, NO = PD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_do = s_q + BQ * LD;
  bf16* s_k = s_do + BQ * LD;  // two buffers
  bf16* s_v = s_k + 2 * BK * LD;
  float* s_l = reinterpret_cast<float*>(s_v + 2 * BK * LD);  // lse log2(e) of the block's rows
  float* s_di = s_l + BQ;
  const int row0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int tiles = (s.N + BK - 1) / BK;

  load_tile<PD, BQ>(s_q, q, s, b, h, row0);
  load_tile<PD, BQ>(s_do, dout, s, b, h, row0);
  load_tile<PD, BK>(s_k, k, s, b, h, 0);
  load_tile<PD, BK>(s_v, v, s, b, h, 0);
  cp_async_commit();
  // di = rowsum(dO o) in fp32, a warp a row; rows past N: di 0, lse 0
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int n = row0 + r;
    float acc = 0.f;
    if (n < s.N) {
      const size_t at = row_at(s, b, n, h);
      for (int c = lane; c < s.D; c += 32) acc += __bfloat162float(dout[at + c]) * __bfloat162float(o[at + c]);
    }
#pragma unroll
    for (int w = 16; w >= 1; w /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (lane == 0) {
      const size_t stat = ((size_t)b * s.H + h) * s.N + n;
      s_di[r] = acc;
      s_l[r] = n < s.N ? lse[stat] * LOG2E : 0.f;
      if (n < s.N) di[stat] = acc;
    }
  }

  float acc[NO][4];
  zero(acc);
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_tile<PD, BK>(s_k + (buf ^ 1) * BK * LD, k, s, b, h, (t + 1) * BK);
      load_tile<PD, BK>(s_v + (buf ^ 1) * BK * LD, v, s, b, h, (t + 1) * BK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = s_k + buf * BK * LD;
    const bf16* vt = s_v + buf * BK * LD;

    float p[NS][4], dp[NS][4];
    product_nt<PD>(p, s_q, 16 * warp, kt, lane);
    product_nt<PD>(dp, s_do, 16 * warp, vt, lane);
    const float lr[2] = {s_l[16 * warp + g], s_l[16 * warp + g + 8]};
    const float dr[2] = {s_di[16 * warp + g], s_di[16 * warp + g + 8]};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = t * BK + 8 * nt + 2 * tq + (i & 1) < s.N;
        const float pv = live ? fast_exp2(fmaf(p[nt][i], scale_log2, -lr[i / 2])) : 0.f;
        p[nt][i] = pv * (dp[nt][i] - dr[i / 2]) * scale;  // dS
      }
    }
    product_pv<LD>(acc, p, kt, 0, lane);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows(dq, s, b, h, row0 + 16 * warp, 0, acc, one, lane);
}

// ----------------------------------------------------------------- dkv

template <int PD>
__global__ void __launch_bounds__(THREADS) dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                                      const float* __restrict__ lse, const float* __restrict__ di,
                                                      bf16* __restrict__ dk, bf16* __restrict__ dv, const Shape s,
                                                      float scale, float scale_log2) {
  using T = Dims<PD>;
  constexpr int LD = T::LD, SW = T::SW, NS = BQ_DKV / 8, NW = SW / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);
  bf16* s_v = s_k + BQ * LD;
  bf16* s_q = s_v + BQ * LD;  // two buffers
  bf16* s_do = s_q + 2 * BQ_DKV * LD;
  float* s_l = reinterpret_cast<float*>(s_do + 2 * BQ_DKV * LD);  // two buffers of lse log2(e)
  float* s_di = s_l + 2 * BQ_DKV;
  const int key0 = blockIdx.x * BQ, h = blockIdx.y;
  const int b = blockIdx.z / T::SPLIT, c0 = (blockIdx.z % T::SPLIT) * SW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane % 4;
  const int tiles = (s.N + BQ_DKV - 1) / BQ_DKV;
  const size_t stat0 = ((size_t)b * s.H + h) * s.N;

  // a query tile's rows, its lse log2(e) (+inf past N: P = 0) and di (0 past N)
  auto load_queries = [&](int buf, int t) {
    load_tile<PD, BQ_DKV>(s_q + buf * BQ_DKV * LD, q, s, b, h, t * BQ_DKV);
    load_tile<PD, BQ_DKV>(s_do + buf * BQ_DKV * LD, dout, s, b, h, t * BQ_DKV);
    for (int j = threadIdx.x; j < BQ_DKV; j += THREADS) {
      const int n = t * BQ_DKV + j;
      s_l[buf * BQ_DKV + j] = n < s.N ? lse[stat0 + n] * LOG2E : INFINITY;
      s_di[buf * BQ_DKV + j] = n < s.N ? di[stat0 + n] : 0.f;
    }
  };
  load_tile<PD, BQ>(s_k, k, s, b, h, key0);
  load_tile<PD, BQ>(s_v, v, s, b, h, key0);
  load_queries(0, 0);
  cp_async_commit();

  float acc_k[NW][4], acc_v[NW][4];
  zero(acc_k);
  zero(acc_v);
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) load_queries(buf ^ 1, t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = s_q + buf * BQ_DKV * LD;
    const bf16* dot = s_do + buf * BQ_DKV * LD;
    const float* lt = s_l + buf * BQ_DKV;
    const float* dt = s_di + buf * BQ_DKV;

    float p[NS][4], dp[NS][4];  // P^T and dP^T: the warp's 16 keys x 32 queries
    product_nt<PD>(p, s_k, 16 * warp, qt, lane);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) p[nt][i] = fast_exp2(fmaf(p[nt][i], scale_log2, -lt[8 * nt + 2 * tq + (i & 1)]));
    }
    product_pv<LD>(acc_v, p, dot, c0, lane);
    product_nt<PD>(dp, s_v, 16 * warp, dot, lane);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) p[nt][i] = p[nt][i] * (dp[nt][i] - dt[8 * nt + 2 * tq + (i & 1)]) * scale;
    }
    product_pv<LD>(acc_k, p, qt, c0, lane);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows(dk, s, b, h, key0 + 16 * warp, c0, acc_k, one, lane);
  store_rows(dv, s, b, h, key0 + 16 * warp, c0, acc_v, one, lane);
}

// ------------------------------------------------------------------ host

template <int PD>
constexpr int fwd_smem() {
  return (BQ + 4 * Dims<PD>::BK) * Dims<PD>::LD * 2;
}
template <int PD>
constexpr int dq_smem() {
  return (2 * BQ + 4 * Dims<PD>::BK) * Dims<PD>::LD * 2 + 2 * BQ * 4;
}
template <int PD>
constexpr int dkv_smem() {
  return (2 * BQ + 4 * BQ_DKV) * Dims<PD>::LD * 2 + 4 * BQ_DKV * 4;
}
static_assert(dq_smem<MAX_PD>() <= 232448 && dkv_smem<MAX_PD>() <= 232448, "a block's shared memory fits an SM");

bool bad_shape(int B, int N, int H, int D) {
  return B <= 0 || N <= 0 || H <= 0 || D <= 0 || padded(D) == 0 || B * 2 > 65535 || H > 65535;
}

// f(std::integral_constant<int, PD>) at D's padded width
template <class F>
int at_width(int D, F f) {
  switch (padded(D)) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 192: return f(std::integral_constant<int, 192>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (B, N, H, D) bf16, contiguous, 16-byte aligned, on the
// current device, D <= 256; lse: (B, H, N) fp32 or null (not written).
// Returns a cudaError_t (0 = launched).
extern "C" int attention_any_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int N,
                                 int H, int D, float scale, void* stream) {
  if (bad_shape(B, N, H, D)) return (int)cudaErrorInvalidValue;
  return at_width(D, [&](auto pd) {
    constexpr int PD = decltype(pd)::value;
    const auto kernel = fwd_kernel<PD>;
    static bool allowed[MAX_DEVICES] = {};
    cudaError_t err = allow_smem(kernel, fwd_smem<PD>(), allowed);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + BQ - 1) / BQ, H, B);
    kernel<<<grid, THREADS, fwd_smem<PD>(), (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse, Shape{N, H, D, D % 8 == 0},
        scale * LOG2E);
    return (int)cudaGetLastError();
  });
}

// dq (B, N, H, D) bf16 and di (B, H, N) fp32 from q, k, v, o, dout (as the
// forward's) and lse (B, H, N) fp32. Returns a cudaError_t.
extern "C" int attention_any_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                    const void* lse, void* dq, void* di, int B, int N, int H, int D, float scale,
                                    void* stream) {
  if (bad_shape(B, N, H, D)) return (int)cudaErrorInvalidValue;
  return at_width(D, [&](auto pd) {
    constexpr int PD = decltype(pd)::value;
    const auto kernel = dq_kernel<PD>;
    static bool allowed[MAX_DEVICES] = {};
    cudaError_t err = allow_smem(kernel, dq_smem<PD>(), allowed);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + BQ - 1) / BQ, H, B);
    kernel<<<grid, THREADS, dq_smem<PD>(), (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dout, (const float*)lse,
        (bf16*)dq, (float*)di, Shape{N, H, D, D % 8 == 0}, scale, scale * LOG2E);
    return (int)cudaGetLastError();
  });
}

// dk, dv (B, N, H, D) bf16 from q, k, v, dout, lse and di of
// attention_any_bwd_dq. Returns a cudaError_t.
extern "C" int attention_any_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                     const void* di, void* dk, void* dv, int B, int N, int H, int D, float scale,
                                     void* stream) {
  if (bad_shape(B, N, H, D)) return (int)cudaErrorInvalidValue;
  return at_width(D, [&](auto pd) {
    constexpr int PD = decltype(pd)::value;
    const auto kernel = dkv_kernel<PD>;
    static bool allowed[MAX_DEVICES] = {};
    cudaError_t err = allow_smem(kernel, dkv_smem<PD>(), allowed);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + BQ - 1) / BQ, H, B * Dims<PD>::SPLIT);
    kernel<<<grid, THREADS, dkv_smem<PD>(), (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse, (const float*)di,
        (bf16*)dk, (bf16*)dv, Shape{N, H, D, D % 8 == 0}, scale, scale * LOG2E);
    return (int)cudaGetLastError();
  });
}
