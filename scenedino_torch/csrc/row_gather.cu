// Row gather: out[i] = table[idx[i]] for a 2-D table whose row is a
// multiple of 16 bytes, with int32 indices.
//
// Replaces: tools/probe_pallas_gather.py:17 `run` (its four bodies at
// :38-60: 256 indices from a 512x128 fp32 table) and
// tools/bench_pallas_gather.py:38 `pallas_gather` (`gather_kernel` :29:
// 2^20 indices from a 32768x128 bf16 table in blocks of 8192). Those were
// probes of whether Mosaic can lower a gather on the TPU; it cannot, so
// the JAX package gathers through XLA. On Hopper a row gather is a plain
// kernel. The port also runs it on the probe-guided render, where each
// full-resolution ray reads its probe pixel's weight histogram and depths
// (scenedino_tpu/ops/fast_field.py:765-768, there a `jnp.repeat`).
//
// Bound on the H100: bytes. P2's shape writes 2^20 x 256 B = 268 MB and
// reads 4 MB of indices and the 8 MB table (once, if it stays in the 50 MB
// L2): about 0.084 ms at 3.35 TB/s.
//
// Design: one warp per group of rows. A row of V 16-byte vectors (V <= 32,
// rows of at most 512 bytes) takes V lanes, so a warp copies 32 / V rows
// at once: 1 of P1's 512-byte rows, 2 of P2's 256-byte rows, 4 of the
// probe path's 128-byte rows. A longer row (the probe path's at n_probe >
// 64: its weights and depths, 8 n_probe bytes) is one warp's, each lane
// copying every 32nd vector of it. The lanes of the group read the group's
// indices once (one coalesced load), and each lane takes its row's index
// by a shuffle. Table rows are read with 16-byte read-only loads; output
// rows are written with 16-byte streaming stores, so the written rows do
// not push the table out of L2.
//
// An index outside [0, rows) reads nothing: its output row is written as
// zero bytes.
//
// At P1's 394 kB a call is host time, not device time: the launch asks the
// runtime nothing but the current device (the SM count is kept per device),
// and the wrapper looks the function up and types it once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS) row_gather_kernel(
    const uint4* __restrict__ table, const int* __restrict__ idx, uint4* __restrict__ out,
    long long n, int rows, int vpr, int group) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * WARPS;
  const long long ngroups = (n + group - 1) / group;
  // the row of the group this lane copies, and its first vector of that row
  const int j = lane / vpr;
  const int v0 = lane % vpr;
  for (long long g = (long long)blockIdx.x * WARPS + threadIdx.x / 32; g < ngroups; g += nwarps) {
    const long long row0 = g * group;
    int mine = -1;
    if (lane < group && row0 + lane < n) mine = __ldg(idx + row0 + lane);
    const int src = __shfl_sync(0xffffffffu, mine, j < group ? j : 0);
    const long long i = row0 + j;
    if (j >= group || i >= n) continue;
    for (int v = v0; v < vpr; v += 32) {  // once, unless a row is longer than 512 bytes
      const uint4 val =
          src >= 0 && src < rows ? __ldg(table + (size_t)src * vpr + v) : make_uint4(0u, 0u, 0u, 0u);
      __stcs(out + (size_t)i * vpr + v, val);
    }
  }
}

constexpr int MAX_DEVICES = 64;

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

}  // namespace

// Pointers are device pointers on the current device, 16-byte aligned; the
// wrapper checks dtypes, shapes and contiguity. Returns a cudaError_t
// (0 = launched).
extern "C" int row_gather(const void* table, const void* idx, void* out, long long n, int rows,
                          int row_bytes, void* stream) {
  if (n < 0 || rows <= 0 || row_bytes <= 0 || row_bytes % 16) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int vpr = row_bytes / 16;
  const int group = vpr <= 32 ? 32 / vpr : 1;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long ngroups = (n + group - 1) / group;
  long long blocks = (ngroups + WARPS - 1) / WARPS;
  const long long cap = (long long)sms * 16;
  if (blocks > cap) blocks = cap;
  row_gather_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, (const int*)idx, (uint4*)out, n, rows, vpr, group);
  return (int)cudaGetLastError();
}
