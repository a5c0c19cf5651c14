// Fixed-order segment sums for the port's Gauss-Newton solvers: the flat
// (global) bundle adjustment's block sums over cameras, points and
// (point, camera) pairs, and the pose graph's over keyframes.
//
// Replaces no TPU kernel: the reference sums with XLA's `.at[].add`
// (my_orb_slam2_tpu/ops/ba.py:201-290, ops/pose_graph.py:74), which is
// deterministic on every backend. `index_add_`'s CUDA kernel adds with
// atomics, so two runs on the card on the same input differ in the last
// bits and a whole drive parts from run to run. This kernel sums each
// segment in one fixed order: the rows' own order, as the CPU's
// `index_add_` and JAX's CPU scatter add them, so identical inputs give the
// CPU's bits. That order is the design's constraint: each (segment,
// component) is one serial chain of adds, acc = ((0 + v0) + v1) + ..., and
// no tree, split or reassociation may shorten it.
//
// Layout (CSR, built on the device by the wrapper once per solve, since the
// indices do not change within one): `order` lists the input rows sorted by
// segment, stable, so the rows of segment s are order[offsets[s]] ..
// order[offsets[s + 1] - 1] in their original order; `longest_first` lists
// the segments by length, longest first.
//
// Two routes, chosen by the wrapper from shapes alone (rows per segment on
// average, and the row width k):
//
// - Short segments (a point's observations, a keyframe's edges):
//   `segment_sum_thread_kernel`, one thread per (segment, component). It
//   walks its segment's rows in order and adds vals[order[j] * k + c] into
//   a register, then writes once. Consecutive threads take consecutive
//   components of a row, so a warp's loads of one row are contiguous. With
//   a few rows a segment the grid holds rows * k threads and the card's
//   bandwidth is busy; bound: bytes.
//
// - Long segments (a camera's observations: ~128 rows on average at the
//   global BA's capacity, up to ~1700): `segment_sum_block_kernel`, one
//   block per segment. A thread per (segment, component) there gives a grid
//   of only n * k threads (12,288 for b_c), each waiting on one dependent
//   pair of global loads (order[j], then the gathered row) a row, so the
//   time is the longest segment times a memory round trip over the loads in
//   flight, with the card's bandwidth idle. The block instead
//     1. copies its segment's `order` slice once, coalesced, into shared
//        memory with cp.async, kStages - 1 chunks ahead of the rows that
//        need it;
//     2. gathers each chunk of rows into a ring of kStages shared-memory
//        stages with cp.async (LDGSTS): consecutive threads copy
//        consecutive 16, 8 or 4 B pieces of a row (16 B where the row width
//        and the base allow, as U's 144 B rows; 8 B for b_c's 24 B rows; 4 B
//        for 36 B or 196 B rows), so kStages - 1 chunks of rows are in flight
//        while one is summed;
//     3. k threads, one per component, in warps of their own (the other
//        warps issue the copies), add the staged rows in the rows' order
//        from shared memory, their loads a batch of rows ahead of the adds,
//        so each step waits only on the FADD before it.
//   One __syncthreads a chunk. The grid is persistent (as many blocks as
//   fit on the card) and walks the segments longest first, so the longest
//   chains start in the first wave and a block that meets an empty segment
//   zeroes its remaining (empty) ones at once: at the global BA's capacity
//   most of the 2048 cameras are empty. Bound: the bytes of the rows where
//   many segments stream at once (U); the chain where a few long ones
//   dominate: the longest segment times the FADD latency (1658 rows x 4
//   cycles ~ 3.4 us at 1.98 GHz for b_c, longer than its bytes take).
//   cp.async and not TMA: TMA's 1-D bulk copies need 16 B-multiple sizes
//   and addresses (b_c's and the pose graph's rows are not), and Hopper's
//   TMA has no row gather (each row would be its own bulk copy and
//   mbarrier transaction); cp.async takes any 4 B-aligned row and spreads a
//   chunk's pieces over the block's threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockThreads = 256;  // the long route's block; k <= kMaxK components
constexpr int kMaxK = 128;          // consumer warps take at most half the block
constexpr int kStages = 3;          // chunks of rows in the shared-memory ring
constexpr int kIdxSlots = 2 * kStages - 2;  // chunks of row numbers staged ahead
constexpr int kStageBytes = 32768;  // rows of one chunk, in bytes (the chunk's row count is clamped below)
constexpr int kBatch = 32;          // rows a consumer loads ahead of its adds
constexpr int kMaxChunkRows = 512;
// Shared memory of one block at most: kIdxSlots chunks of int64 row numbers
// and kStages stages of rows (a stage holds at most kStageBytes: at k =
// kMaxK a kBatch-row chunk is 16 KB).
constexpr int kMaxSmemBytes = kIdxSlots * kMaxChunkRows * 8 + kStages * kStageBytes;
constexpr int kMaxDevices = 64;

__global__ void segment_sum_thread_kernel(const float* __restrict__ vals, const int64_t* __restrict__ order,
                                          const int64_t* __restrict__ offsets, float* __restrict__ out,
                                          int64_t n_out, int k) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_out) return;
  const int64_t s = t / k;
  const int c = static_cast<int>(t - s * k);
  const int64_t b = offsets[s];
  const int64_t e = offsets[s + 1];
  float acc = 0.0f;
#pragma unroll 4
  for (int64_t j = b; j < e; ++j) {
    acc += vals[order[j] * k + c];
  }
  out[t] = acc;
}

template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(W));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc + col[0] + col[k] + ... + col[(rows - 1) k], added in that order: a
// column of a staged chunk in shared memory. The loads run a batch of
// kBatch rows ahead of the adds (each register is reloaded for the next
// batch right after its add), so the chain waits only on the FADD before.

__device__ __forceinline__ float add_rows(float acc, const float* col, int rows, int k) {
  int r = 0;
  if (rows >= kBatch) {
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) x[u] = col[u * k];
    for (; r + 2 * kBatch <= rows; r += kBatch) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        acc += x[u];
        x[u] = col[(r + kBatch + u) * k];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc += x[u];
    r += kBatch;
  }
  for (; r + 8 <= rows; r += 8) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = col[(r + u) * k];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += x[u];
  }
  for (; r < rows; ++r) acc += col[r * k];
  return acc;
}

// A persistent grid over the segments in `longest_first` order: block i
// sums positions i, i + gridDim.x, ... of it, each one segment, and on the
// first empty one writes zeros for its remaining positions (all empty,
// since the order is by length) and stops. W: the copy width in bytes (16,
// 8 or 4; divides 4k and the base address). Warps [0, ceil(k / 32)) sum;
// the others issue the copies.
//
// A segment's pipeline: commit group g holds chunk g's rows and, from g =
// kStages - 1 on, the row numbers of chunk g + kStages - 1; the prologue
// stages the row numbers of chunks 0 .. kIdxSlots - 1, then issues chunks
// 0 .. kStages - 2 of rows. Iteration j waits for group j (chunk j's rows,
// chunk j + kStages - 1's row numbers), passes one barrier, issues group
// j + kStages - 1 and sums chunk j: kStages - 1 chunks of rows and of row
// numbers stay in flight while a chunk is summed.
template <int W>
__global__ void __launch_bounds__(kBlockThreads)
    segment_sum_block_kernel(const float* __restrict__ vals, const int64_t* __restrict__ order,
                             const int64_t* __restrict__ offsets, const int64_t* __restrict__ longest_first,
                             float* __restrict__ out, int64_t n_seg, int k, int chunk_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* sidx = reinterpret_cast<int64_t*>(smem);  // kIdxSlots chunks of row numbers
  float* ring = reinterpret_cast<float*>(smem + kIdxSlots * chunk_rows * 8);  // kStages chunks of rows
  const int tid = threadIdx.x;
  const int row_bytes = 4 * k;
  const int pieces = row_bytes / W;
  const int stage_floats = chunk_rows * k;
  const char* src = reinterpret_cast<const char*>(vals);
  const uint32_t sidx_s = static_cast<uint32_t>(__cvta_generic_to_shared(sidx));
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const int issuer = tid - (k + 31) / 32 * 32;  // < 0 on the summing warps
  const int n_issuers = kBlockThreads - (k + 31) / 32 * 32;
  // Issuer i copies pieces i, i + n_issuers, ... of a chunk (piece p: row
  // p / pieces, bytes (p % pieces) W of it), stepping row and piece without
  // a division.
  const int dr = n_issuers / pieces, dq = n_issuers - dr * pieces;
  const int r0 = issuer < 0 ? 0 : issuer / pieces, q0 = issuer < 0 ? 0 : issuer - r0 * pieces;
  for (int64_t i = blockIdx.x; i < n_seg; i += gridDim.x) {
    const int64_t s = longest_first[i];
    const int64_t b = offsets[s];
    const int64_t n = offsets[s + 1] - b;  // uniform over the block
    if (n == 0) {
      const int per = kBlockThreads / k;  // segments zeroed a pass
      const int m = tid / k, c = tid - m * k;
      if (m < per) {
#pragma unroll 4
        for (int64_t p = i + m * gridDim.x; p < n_seg; p += per * gridDim.x) out[longest_first[p] * k + c] = 0.0f;
      }
      return;
    }
    const int64_t n_chunks = (n + chunk_rows - 1) / chunk_rows;
    auto rows_of = [&](int64_t c) {
      const int64_t left = n - c * chunk_rows;
      return static_cast<int>(left < chunk_rows ? left : chunk_rows);
    };
    auto issue_idx = [&](int64_t c) {  // chunk c's row numbers -> slot c % kIdxSlots
      if (c >= n_chunks || issuer < 0) return;
      const uint32_t dst = sidx_s + static_cast<uint32_t>((c % kIdxSlots) * chunk_rows * 8);
      const int64_t* from = order + b + c * chunk_rows;
      const int rows = rows_of(c);
#pragma unroll 4
      for (int r = issuer; r < rows; r += n_issuers) cp_async<8>(dst + r * 8, from + r);
    };
    auto issue_rows = [&](int64_t c) {  // chunk c's rows -> stage c % kStages
      if (c >= n_chunks || issuer < 0) return;
      const int64_t* rows_idx = sidx + (c % kIdxSlots) * chunk_rows;
      const uint32_t dst = ring_s + static_cast<uint32_t>((c % kStages) * stage_floats * 4);
      const int rows = rows_of(c);
      int r = r0, q = q0;
#pragma unroll 4
      for (; r < rows;) {
        cp_async<W>(dst + r * row_bytes + q * W, src + rows_idx[r] * row_bytes + q * W);
        r += dr;
        q += dq;
        if (q >= pieces) {
          q -= pieces;
          ++r;
        }
      }
    };
    for (int c = 0; c < kIdxSlots; ++c) issue_idx(c);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int c = 0; c < kStages - 1; ++c) {
      issue_rows(c);
      cp_async_commit();
    }
    float acc = 0.0f;
    for (int64_t j = 0; j < n_chunks; ++j) {
      // Group j has landed (this thread's copies; the barrier makes
      // everyone's visible). Groups pending: j .. j + kStages - 2.
      cp_async_wait<kStages - 2>();
      __syncthreads();
      // Chunk j + kStages - 1's rows take the stage of chunk j - 1, summed
      // before this barrier; chunk j + kIdxSlots's row numbers the slot of
      // chunk j, whose rows were issued kStages - 1 iterations ago.
      issue_rows(j + kStages - 1);
      issue_idx(j + kIdxSlots);
      cp_async_commit();
      if (tid < k) acc = add_rows(acc, ring + (j % kStages) * stage_floats + tid, rows_of(j), k);
    }
    if (tid < k) out[s * k + tid] = acc;
    __syncthreads();  // the next segment's prologue reuses the shared memory
  }
}

template <int W>
int launch_block(const float* vals, const int64_t* order, const int64_t* offsets, const int64_t* longest_first,
                 float* out, int64_t n_seg, int k, cudaStream_t stream) {
  // Above 48 KB of dynamic shared memory a kernel needs the attribute; the
  // grid is as many blocks as fit on the card at once. Both are set once a
  // device (and a row width).
  static bool ready[kMaxDevices];
  static int sms[kMaxDevices];
  static int resident[kMaxDevices][kMaxK + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(segment_sum_block_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  // A whole number of kBatch-row batches, at least one.
  int chunk_rows = kStageBytes / (4 * k) / kBatch * kBatch;
  chunk_rows = chunk_rows < kBatch ? kBatch : (chunk_rows > kMaxChunkRows ? kMaxChunkRows : chunk_rows);
  const int smem = kIdxSlots * chunk_rows * 8 + kStages * chunk_rows * k * 4;
  if (resident[dev][k] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[dev][k], segment_sum_block_kernel<W>,
                                                        kBlockThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident[dev][k] == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int64_t fit = static_cast<int64_t>(resident[dev][k]) * sms[dev];
  segment_sum_block_kernel<W><<<static_cast<unsigned>(n_seg < fit ? n_seg : fit), kBlockThreads, smem, stream>>>(
      vals, order, offsets, longest_first, out, n_seg, k, chunk_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The short route. vals: (rows, k) f32; order: (rows,) int64; offsets:
// (n_seg + 1,) int64; out: (n_seg, k) f32. Returns cudaGetLastError() after
// the launch.
extern "C" int segment_sum_f32(const float* vals, const int64_t* order, const int64_t* offsets, float* out,
                               int64_t n_seg, int k, void* stream) {
  const int64_t n_out = n_seg * static_cast<int64_t>(k);
  if (n_out == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n_out + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  segment_sum_thread_kernel<<<static_cast<unsigned>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      vals, order, offsets, out, n_out, k);
  return static_cast<int>(cudaGetLastError());
}

// The long route: as segment_sum_f32, with longest_first: (n_seg,) int64,
// the segments by length, longest first. Takes 1 <= k <= 128 and rows <
// 2^31 (the wrapper checks both).
extern "C" int segment_sum_long_f32(const float* vals, const int64_t* order, const int64_t* offsets,
                                    const int64_t* longest_first, float* out, int64_t n_seg, int k,
                                    void* stream) {
  if (n_seg == 0) return 0;
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t base = reinterpret_cast<uintptr_t>(vals);
  const int row_bytes = 4 * k;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0 && base % 16 == 0) return launch_block<16>(vals, order, offsets, longest_first, out, n_seg, k, st);
  if (row_bytes % 8 == 0 && base % 8 == 0) return launch_block<8>(vals, order, offsets, longest_first, out, n_seg, k, st);
  return launch_block<4>(vals, order, offsets, longest_first, out, n_seg, k, st);
}
