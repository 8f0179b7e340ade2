// Hopper (sm_90a) building blocks for the hand-written kernels: mbarriers,
// TMA tile loads and stores with their tensor maps, cp.async copies, and
// warpgroup matrix products (wgmma) on 64 x 64 bf16 tiles (or 64 x 32 TF32
// ones: the same 128-byte rows) kept in shared memory under the 128-byte
// swizzle, with A from shared memory or from registers.
//
// One tile convention throughout: a tile is 64 rows of 64 bf16 (128 bytes a
// row, 8 KB), 1024-byte aligned in shared memory, written by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r lies at
// r * 128 + ((c ^ (r % 8)) * 16). `wgmma_desc` describes such a tile to
// wgmma (layout type B128, 8-row groups 1024 bytes apart). The same tile
// serves both operand orders:
//   * K-major (the contraction runs along a row: S = Q K^T reads K so):
//     transpose flag 0, k-step kk starts 32 * kk bytes into the tile;
//   * MN-major (the contraction runs down the rows: dQ += dS K reads K so):
//     transpose flag 1, k-step kk starts 16 rows = 2048 * kk bytes on.
// `WGMMA_K_STEP` and `WGMMA_MN_STEP` are those advances in descriptor units.
#pragma once
#include <cuda.h>  // CUtensorMap and its enums; the encoder itself is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hopper {

constexpr int TILE = 64;                     // rows and columns of a tile
constexpr int TILE_BYTES = TILE * TILE * 2;  // bf16
constexpr uint64_t WGMMA_K_STEP = 32 >> 4;   // descriptor units (16 bytes) per k-step, K-major
constexpr uint64_t WGMMA_MN_STEP = 2048 >> 4;  // per k-step, MN-major

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(arrivals) : "memory");
}

// after the last mbar_init, before any thread or the TMA unit uses a barrier
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// returns once the barrier's phase of this parity has completed. A wait that
// polls a million times (seconds; a kernel here lasts milliseconds) has lost
// an arrival: it traps, so a fault shows as an error and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls > (1u << 20)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// --------------------------------------------------------------------- TMA

// loads the box at (c0, c1, c2, c3), innermost coordinate first, into `dst`;
// the bytes land on `bar`. Rows outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// stores the box at `src` to (c0, c1, c2, c3); rows outside the tensor are
// dropped. Follow with tma_store_commit and, before `src` is reused or the
// block ends, tma_store_wait_read.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() { asm volatile("cp.async.bulk.commit_group;" ::: "memory"); }

__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// makes ordinary shared-memory writes visible to the TMA unit and to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// byte offset of columns [col, col + 8) (col a multiple of 8) of row `row`
// in a swizzled tile
__device__ __forceinline__ uint32_t swizzled_offset(int row, int col) {
  return static_cast<uint32_t>(row * 128 + ((((col >> 3) ^ row) & 7) << 4));
}

// ------------------------------------------------------------------- wgmma

// the descriptor of the tile at shared-memory address `addr`
__device__ __forceinline__ uint64_t wgmma_desc_at(uint32_t addr) {
  uint64_t d = (addr & 0x3FFFFu) >> 4;            // start address
  d |= uint64_t(1) << 16;                         // leading offset: unused by a 64-wide swizzled tile
  d |= uint64_t(1024 >> 4) << 32;                 // stride between 8-row groups
  d |= uint64_t(1) << 62;                         // 128-byte swizzle
  return d;
}

__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) { return wgmma_desc_at(smem_u32(tile)); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Moves registers between the warpgroups of a block: the producer's
// warpgroup gives up all but `Regs` a thread, a consumer's takes `Regs`. The
// block starts with the same count everywhere (ptxas allots registers to
// whole warpgroups), which is too few for a consumer that holds four
// accumulators. Every warp of the warpgroup must execute it, in a branch
// that does not meet the other role's again.
template <int Regs>
__device__ __forceinline__ void registers_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(Regs));
}
template <int Regs>
__device__ __forceinline__ void registers_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(Regs));
}

// Registers a thread: a block of WGS consumer warpgroups and one producer
// warpgroup, BLOCKS of them on an SM, starts with START everywhere; the
// producer keeps PRODUCER and each consumer takes CONSUMER, so that all fit
// into what the block started with.
template <int WGS, int BLOCKS>
struct Registers {
  static constexpr int PER_THREAD = 65536 / (BLOCKS * (WGS + 1) * 128);
  static constexpr int START = (PER_THREAD > 255 ? 255 : PER_THREAD) / 8 * 8;
  static constexpr int PRODUCER = 24;
  static constexpr int SHARE = ((WGS + 1) * START - PRODUCER) / WGS / 8 * 8;
  static constexpr int CONSUMER = SHARE > 240 ? 240 : SHARE;
};

// the block's shared-memory struct at the first 1024-byte boundary of the
// dynamic shared memory (launch with sizeof(Smem) + 1024 bytes)
template <class Smem>
__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// keeps the compiler from moving accesses to an accumulator across a wgmma
// batch that is in flight
template <int N>
__device__ __forceinline__ void fence_registers(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_ACC32(d)                                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),            \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]),             \
      "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),             \
      "+f"(d[30]), "+f"(d[31])
#define HOPPER_ACC32_LIST                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "   \
  "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d = or += A (64 x 16 bf16, registers) times B (16 x 64 bf16, shared
// memory; TransB 0: K-major, 1: MN-major); `accumulate` 0 overwrites d.
// d is the warpgroup's 64 x 64 fp32 accumulator: thread t holds the rows
// r = 16 * (t / 32) + (t % 32) / 4 and r + 8, and of each 8-column group j
// the columns c = 8 j + 2 * (t % 4) and c + 1:
// d[4 j + 2 hi + e] is (r + 8 hi, c + e).
// a[0..3] are the thread's 8 values of A, packed in pairs: (r, c and c + 1
// of group 0), (r + 8, the same), (r, those of group 1), (r + 8, the same).
// Two neighbouring 8-column groups of an accumulator, rounded to bf16, are
// exactly this, so one product's result feeds the next without leaving the
// registers.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t* a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_ACC32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TransB));
}

// d = or += A (64 x 16 bf16) times B (16 x 64 bf16), both K-major in shared
// memory (`desc_a` a swizzled tile of 64 rows as `wgmma_desc` describes it,
// advanced by WGMMA_K_STEP a k-step); d as in wgmma_m64n64k16_rs.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_ACC32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// wgmma_m64n64k16_ss with an 8-column B (8 x 16 bf16, K-major: the first 8
// rows of a swizzled tile, one 1024-byte swizzle atom): d is 64 x 8 fp32,
// d[2 hi + e] is (r + 8 hi, 2 * (t % 4) + e) in the rows of the 64-column form.
__device__ __forceinline__ void wgmma_m64n8k16_ss(float (&d)[4], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// wgmma_m64n64k16_rs with an 8-column B (one 1024-byte swizzle atom of 8
// rows, K-major): d as in wgmma_m64n8k16_ss, a as in wgmma_m64n64k16_rs
__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4], const uint32_t* a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

#define HOPPER_ACC12(d)                                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),           \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
#define HOPPER_ACC12_LIST "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}"

// wgmma_m64n64k16_rs with a 24-column B (three 8-row atoms, K-major): d is
// 64 x 24 fp32, d[4 j + 2 hi + e] as in the 64-column form for j < 3
__device__ __forceinline__ void wgmma_m64n24k16_rs(float (&d)[12], const uint32_t* a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 " HOPPER_ACC12_LIST
      ", {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n"
      "}\n"
      : HOPPER_ACC12(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// ------------------------------------------------------------ wgmma, TF32
//
// d = or += A (64 x 8 tf32, registers) times B (8 x N tf32, shared memory,
// K-major only: TF32 has no transposed form). A tile of B is the same
// 128-byte-swizzled tile as above, a row holding 32 tf32 along K; a k-step of
// 8 is 32 bytes, so WGMMA_K_STEP advances it as it does a bf16 k-step of 16.
// d is laid out as in the bf16 forms. a[0..3] are the thread's 4 values of A,
// the bits of fp32 numbers whose low 13 bits are 0 (tf32_rna): (r, t % 4),
// (r + 8, t % 4), (r, t % 4 + 4), (r + 8, t % 4 + 4), r as for d. So the
// accumulator's 8-column group j feeds a k-step of 8 as (d[4 j], d[4 j + 2],
// d[4 j + 1], d[4 j + 3]) when B's rows of that step are the group's columns
// in the order 0, 2, 4, 6, 1, 3, 5, 7 (tf32_k_column).
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t* a, uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " HOPPER_ACC32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

#define HOPPER_ACC16(d)                                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),           \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HOPPER_ACC16_LIST "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16], const uint32_t* a, uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " HOPPER_ACC16_LIST
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : HOPPER_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n8k8_tf32_rs(float (&d)[4], const uint32_t* a, uint64_t desc_b,
                                                      int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n24k8_tf32_rs(float (&d)[12], const uint32_t* a, uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 " HOPPER_ACC12_LIST
      ", {%12, %13, %14, %15}, %16, p, 1, 1;\n"
      "}\n"
      : HOPPER_ACC12(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// the accumulator column (0-7 within its group) that row k of a TF32 k-step's
// B stands for, so that the accumulator feeds A without a shuffle
__host__ __device__ __forceinline__ constexpr int tf32_k_column(int k) { return k < 4 ? 2 * k : 2 * (k - 4) + 1; }

// byte offset of element k (of `bytes` bytes) of row n in a swizzled tile
// (rows of 128 bytes; n may run past 8: a tile of 8-row atoms 1024 bytes apart)
__device__ __forceinline__ uint32_t swizzled_element(int n, int k, int bytes) {
  const int b = k * bytes;
  return static_cast<uint32_t>(n * 128 + ((((b >> 4) ^ n) & 7) << 4) + (b & 15));
}

// ---------------------------------------------------------------- cp.async

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// returns once all but the newest N groups of the thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// where the A operand of a product keeps element (row + 8 hi, 8 j + column)
// of an accumulator: the pair index in a[16]
__device__ __forceinline__ constexpr int a_index(int j, int hi) { return 4 * (j / 2) + 2 * (j % 2) + hi; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the thread's share of a swizzled 64 x 64 tile as the A operand of four
// k-steps (wgmma_m64n64k16_rs); `warp` and `lane` within the warpgroup
__device__ __forceinline__ void load_a_operand(uint32_t (&a)[16], const unsigned char* tile, int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = warp * 16 + hi * 8 + lane / 4;
        a[4 * kk + 2 * half + hi] = *reinterpret_cast<const uint32_t*>(
            tile + swizzled_offset(row, 16 * kk + 8 * half) + (lane % 4) * 4);
      }
    }
  }
}

// the thread's 32 accumulator values -> bf16 in a swizzled tile (the layout a
// TMA store reads); `warp` and `lane` within the warpgroup
__device__ __forceinline__ void store_accumulator(unsigned char* tile, const float (&d)[32], int warp, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = warp * 16 + hi * 8 + lane / 4;
      *reinterpret_cast<uint32_t*>(tile + swizzled_offset(row, 8 * j) + (lane % 4) * 4) =
          pack_bf16(d[4 * j + 2 * hi], d[4 * j + 2 * hi + 1]);
    }
  }
}

#define HOPPER_ACC8(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define HOPPER_ACC8_LIST "{%0, %1, %2, %3, %4, %5, %6, %7}"

// wgmma_m64n64k16_rs with a 32-column B: d is 64 x 32 fp32, d[4 j + 2 hi + e]
// as in the 64-column form for j < 4
template <int TransB>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t* a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOPPER_ACC16_LIST
      ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : HOPPER_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TransB));
}

// wgmma_m64n64k16_rs with a 16-column B: d is 64 x 16 fp32, d[4 j + 2 hi + e]
// as in the 64-column form for j < 2
template <int TransB>
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t* a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " HOPPER_ACC8_LIST
      ", {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
      "}\n"
      : HOPPER_ACC8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TransB));
}

// ------------------------------------------------- 16-column side tiles
//
// A row of 80 bf16 (160 bytes) is split 64 + 16: columns 0-63 are a tile of
// the convention above, columns 64-79 a side tile of 32-byte rows written by
// TMA with CU_TENSOR_MAP_SWIZZLE_32B: the 16-byte chunk c of row r lies at
// r * 32 + ((c ^ ((r / 4) % 2)) * 16), the pattern repeating every 8 rows
// (256 bytes), so a side tile is 256-byte aligned. `wgmma_desc_b32`
// describes it (layout type B32, 8-row groups 256 bytes apart), again for
// both operand orders:
//   * K-major: its 16 columns are one k-step, B's N its rows;
//   * MN-major: its 16 columns are B's N, k-step kk starts 16 rows = 512 * kk
//     bytes on (`WGMMA_B32_MN_STEP`).
constexpr int SIDE = 16;  // columns of a side tile
constexpr uint64_t WGMMA_B32_MN_STEP = 512 >> 4;

__device__ __forceinline__ uint64_t wgmma_desc_b32_at(uint32_t addr) {
  uint64_t d = (addr & 0x3FFFFu) >> 4;            // start address
  d |= uint64_t(1) << 16;                         // leading offset: unused by a 16-wide swizzled tile
  d |= uint64_t(256 >> 4) << 32;                  // stride between 8-row groups
  d |= uint64_t(3) << 62;                         // 32-byte swizzle
  return d;
}

__device__ __forceinline__ uint64_t wgmma_desc_b32(const void* tile) { return wgmma_desc_b32_at(smem_u32(tile)); }

// byte offset of columns [col, col + 8) (col 0 or 8) of row `row` in a side tile
__device__ __forceinline__ uint32_t side_offset(int row, int col) {
  return static_cast<uint32_t>(row * 32 + ((((col >> 3) ^ (row >> 2)) & 1) << 4));
}

// the thread's share of a side tile's 64 rows as the A operand of one k-step
__device__ __forceinline__ void load_a_side(uint32_t (&a)[4], const unsigned char* side, int warp, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = warp * 16 + hi * 8 + lane / 4;
      a[2 * half + hi] = *reinterpret_cast<const uint32_t*>(side + side_offset(row, 8 * half) + (lane % 4) * 4);
    }
  }
}

// a 64 x 16 accumulator (wgmma_m64n16k16_rs) -> bf16 in a side tile
__device__ __forceinline__ void store_side(unsigned char* side, const float (&d)[8], int warp, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = warp * 16 + hi * 8 + lane / 4;
      *reinterpret_cast<uint32_t*>(side + side_offset(row, 8 * j) + (lane % 4) * 4) =
          pack_bf16(d[4 * j + 2 * hi], d[4 * j + 2 * hi + 1]);
    }
  }
}

// ------------------------------------------------------------ rows of 80
//
// What both D = 80 attention files (attention_d80.cu, attention_d80_bwd.cu)
// build on. A row of 80 bf16 is a tile of its first 64 columns and a side
// tile of the other 16, so each own or walked tile is two TMA boxes (the
// main and side maps of `encode_pair`). A product that reduces over the 80
// columns takes four k-steps on the main tile and a fifth on the side tile
// (`product_nt80`); one whose N is the 80 columns is m64n64k16 on the main
// tile plus m64n16k16 on the side tile, both with B read down its rows
// (`product_rows80`), into a 64 x 80 fp32 accumulator of 32 + 8 registers a
// thread (`Acc80`). No product is padded.
constexpr int ROW80 = TILE + SIDE;

// ROWS rows of one head: columns 0-63 as a main tile, 64-79 as a side tile
template <int ROWS>
struct Rows80 {
  alignas(1024) unsigned char main[ROWS * TILE * 2];
  alignas(256) unsigned char side[ROWS * SIDE * 2];
  static constexpr int BYTES = ROWS * ROW80 * 2;
};

// the two tensor maps of a (B, N, H, 80) tensor: the main box and the side box
struct MapPair {
  CUtensorMap main, side;
};

template <int ROWS>
__device__ __forceinline__ void load_rows(Rows80<ROWS>& dst, const MapPair& map, uint64_t* bar, int row0, int h,
                                          int b) {
  tma_load_4d(dst.main, &map.main, bar, 0, h, row0, b);
  tma_load_4d(dst.side, &map.side, bar, TILE, h, row0, b);
}

template <int ROWS>
__device__ __forceinline__ void store_rows(const MapPair& map, const Rows80<ROWS>& src, int row0, int h, int b) {
  tma_store_4d(&map.main, src.main, 0, h, row0, b);
  tma_store_4d(&map.side, src.side, TILE, h, row0, b);
}

// a 64-row own tile as A-operand registers: four k-steps from the main
// tile, the fifth from the side tile
struct OwnRows {
  uint32_t main[16];
  uint32_t side[4];
};

__device__ __forceinline__ void load_own(OwnRows& a, const Rows80<TILE>& rows, int warp, int lane) {
  load_a_operand(a.main, rows.main, warp, lane);
  load_a_side(a.side, rows.side, warp, lane);
}

// acc (64 x 64) = A B^T over the 80 columns: A the own rows in registers, B
// a walked tile by its main and side descriptors, read K-major
__device__ __forceinline__ void product_nt80(float (&acc)[32], const OwnRows& a, uint64_t desc_main,
                                             uint64_t desc_side) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    wgmma_m64n64k16_rs<0>(acc, &a.main[4 * kk], desc_main + kk * WGMMA_K_STEP, kk > 0);
  }
  wgmma_m64n64k16_rs<0>(acc, a.side, desc_side, 1);
}

// a 64 x 80 fp32 accumulator: columns 0-63 and 64-79
struct Acc80 {
  float main[32];
  float side[8];
};

__device__ __forceinline__ void fence_registers(Acc80& d) {
  fence_registers(d.main);
  fence_registers(d.side);
}

__device__ __forceinline__ void zero_registers(Acc80& d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d.main[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) d.side[i] = 0.f;
  fence_registers(d);
}

// acc += A (64 x 16 KSTEPS bf16 in registers) times the walked tile (main
// and side descriptors) read down its rows
template <int KSTEPS>
__device__ __forceinline__ void product_rows80(Acc80& acc, const uint32_t* a, uint64_t desc_main,
                                               uint64_t desc_side) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    wgmma_m64n64k16_rs<1>(acc.main, &a[4 * kk], desc_main + kk * WGMMA_MN_STEP, 1);
    wgmma_m64n16k16_rs<1>(acc.side, &a[4 * kk], desc_side + kk * WGMMA_B32_MN_STEP, 1);
  }
}

// the accumulator -> bf16 in an own tile (the layout the TMA stores read)
__device__ __forceinline__ void store_acc80(Rows80<TILE>& rows, const Acc80& d, int warp, int lane) {
  store_accumulator(rows.main, d.main, warp, lane);
  store_side(rows.side, d.side, warp, lane);
}

// ------------------------------------- online softmax of the K1 forwards
//
// attention.cu (D = 64) and attention_d80.cu (D = 80) walk 64-row key tiles
// with S = Q K^T of a warpgroup's 64 query rows in wgmma's accumulator
// registers (float[32], the layout of wgmma_m64n64k16_rs).

// One tile of the online softmax on the registers of S: the rows' running
// max m (scaled, base 2) and per-lane partial sums l move on, `alpha` =
// exp2(m_old - m_new) is what O must be scaled by (`rescale`), and S is
// replaced by P = exp2(S scale log2(e) - m_new) in place (`pack_p` makes
// it the A operand of O += P V). Maxima and sums are taken as trees, not
// chains. MASK: columns at or past `nvalid` (key rows past N) are -inf.
// The rescale is exact: m moves whenever a row's max of this tile exceeds
// it somewhere in the warp, so the dominant key's P is 1 before its bf16
// rounding, as in the plain version's softmax; otherwise alpha is 1 and O is
// left as it is. Returns whether O must be rescaled (the same in every lane
// of the warp).
// K1_RESCALE_SLACK = s > 0 builds the lazy rescale instead (m moves only
// where the max exceeds it by more than s, so P stays below 2^s): the
// rescale these kernels shipped with until the exact one replaced it, built
// only by tools/softmax_sweep.py for comparison. At s = 8 it read one bf16
// step more than scaled_dot_product_attention on a peaked softmax (PERF.md).
#ifndef K1_RESCALE_SLACK
#define K1_RESCALE_SLACK 0
#endif

template <bool MASK>
__device__ __forceinline__ bool softmax_scores(float (&s)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                               float scale_log2, int nvalid, int col0) {
  if (MASK) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (8 * (i / 4) + col0 + i % 2 >= nvalid) s[i] = -INFINITY;
    }
  }
  float mx[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = fmaxf(s[4 * j + 2 * hi], s[4 * j + 2 * hi + 1]);
#pragma unroll
    for (int w = 4; w >= 1; w /= 2) {
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
    }
    mx[hi] = fmaxf(t[0], __shfl_xor_sync(0xffffffffu, t[0], 1));
    mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
    mx[hi] *= scale_log2;  // finite: every walked tile has a column below N
  }
  const bool move = __any_sync(0xffffffffu, mx[0] > m[0] + float(K1_RESCALE_SLACK) ||
                                                  mx[1] > m[1] + float(K1_RESCALE_SLACK));
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    alpha[hi] = 1.f;
    if (move) {
      const float m_new = fmaxf(m[hi], mx[hi]);
      alpha[hi] = fast_exp2(m[hi] - m_new);  // 0 on the first tile (m = -inf)
      m[hi] = m_new;
    }
    const float neg_m = -m[hi];
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * hi;
      s[i] = fast_exp2(fmaf(s[i], scale_log2, neg_m));
      s[i + 1] = fast_exp2(fmaf(s[i + 1], scale_log2, neg_m));
      t[j] = s[i] + s[i + 1];
    }
#pragma unroll
    for (int w = 4; w >= 1; w /= 2) {
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] += t[j + w];
    }
    l[hi] = fmaf(l[hi], alpha[hi], t[0]);
  }
  return move;
}

// softmax_scores of walked tile t (64 key rows from 64 t), masked where it
// is the ragged last one
__device__ __forceinline__ bool softmax_tile(int t, float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, int N, int col0) {
  const int nvalid = N - t * TILE;  // columns of this tile below N
  if (nvalid >= TILE) return softmax_scores<false>(s, m, l, alpha, scale_log2, nvalid, col0);
  return softmax_scores<true>(s, m, l, alpha, scale_log2, nvalid, col0);
}

// P (the exponents left in S's registers) to bf16 as the A operand of O += P V
__device__ __forceinline__ void pack_p(const float (&s)[32], uint32_t (&p)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) p[a_index(j, hi)] = pack_bf16(s[4 * j + 2 * hi], s[4 * j + 2 * hi + 1]);
  }
}

// an accumulator's rows r and r + 8 (see wgmma_m64n64k16_rs) times f[0] and f[1]
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&f)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= f[(i / 2) % 2];
}

__device__ __forceinline__ void rescale(Acc80& o, const float (&f)[2]) {
  rescale(o.main, f);
  rescale(o.side, f);
}

// -------------------------------------------------------- tensor maps (host)

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the loaded libcuda, fetched through the runtime so
// that the library needs no link against libcuda; null if it has none
inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// the map of one head's 64-row tile of a contiguous (B, N, H, 64) bf16 tensor
// at `base` (16-byte aligned): dimensions (64, H, N, B) innermost first, box
// (64, 1, 64, 1), 128-byte swizzle. N is a dimension of its own, so a tile
// that runs past N is zero-filled on a load and cut on a store.
// Returns a cudaError_t (0 = encoded).
inline int encode_head_tile_map(CUtensorMap* map, const void* base, int B, int N, int H) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {TILE, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {TILE * 2ull, TILE * 2ull * H, TILE * 2ull * H * N};  // bytes, dims 1..3
  const cuuint32_t box[4] = {TILE, 1, TILE, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                              box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// one tensor map per tensor per call (the pointers differ every call)
template <int COUNT>
int encode_maps(CUtensorMap (&maps)[COUNT], const void* const (&bases)[COUNT], int B, int N, int H) {
  for (int i = 0; i < COUNT; ++i) {
    const int bad = encode_head_tile_map(&maps[i], bases[i], B, N, H);
    if (bad) return bad;
  }
  return 0;
}

// the map of a box of `cols` columns by `rows` rows of one head of a
// contiguous (B, N, H, D) bf16 tensor at `base` (16-byte aligned, D * 2 a
// multiple of 16): dimensions (D, H, N, B) innermost first, box (cols, 1,
// rows, 1) under `swizzle`, whose span a box row must fill (64 columns for
// the 128-byte swizzle, 16 for the 32-byte one). The box's first column is
// the load's or store's c0. Rows past N are zero-filled on a load and cut on
// a store. Returns a cudaError_t (0 = encoded).
inline int encode_head_box_map(CUtensorMap* map, const void* base, int B, int N, int H, int D, int cols, int rows,
                               CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t row = 2ull * D;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {row, row * H, row * H * N};  // bytes, dims 1..3
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                              elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the main and side maps of a contiguous (B, N, H, 80) bf16 tensor at
// `base`, boxes of `rows` rows. Returns a cudaError_t (0 = encoded).
inline int encode_pair(MapPair* pair, const void* base, int B, int N, int H, int rows) {
  const int bad = encode_head_box_map(&pair->main, base, B, N, H, ROW80, TILE, rows, CU_TENSOR_MAP_SWIZZLE_128B);
  return bad ? bad : encode_head_box_map(&pair->side, base, B, N, H, ROW80, SIDE, rows, CU_TENSOR_MAP_SWIZZLE_32B);
}

// a shape the D = 80 kernels refuse (the grid's y and z are H and B)
inline bool bad_shape80(int B, int N, int H, int head_dim) {
  return head_dim != ROW80 || B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535;
}

constexpr int MAX_DEVICES = 64;

// raises the kernel's dynamic shared memory limit, once per device
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace hopper
