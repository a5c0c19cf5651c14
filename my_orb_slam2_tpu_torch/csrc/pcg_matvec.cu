// The global bundle adjustment's PCG matvec, fused: the Schur complement of
// the camera system applied to a camera vector x,
//
//   S x = (U_d x - W V^-1 W^T (x * free_cam)) * free_cam,
//
// over the flat observation rows o, whose 6x3 blocks W_o couple camera
// obs_cam[o] and point obs_pt[o]. Two kernels a PCG step, on one stream:
//
// - `pcg_point_matvec`: for each point p, over its rows in their order,
//   gather x[obs_cam] masked by free_cam, apply W_o^T (6 -> 3), sum the three
//   components in the rows' order, then y_p = V_inv_p (sum) (3x3);
// - `pcg_camera_matvec`: for each camera c, over its rows in their order,
//   gather y[obs_pt], apply W_o (3 -> 6), sum the six components in the
//   rows' order, then out_c = (U_d_c (x_c free_c) - sum) free_c.
//
// Replaces no TPU kernel: the reference applies S with XLA's einsums and
// `.at[].add` scatters (my_orb_slam2_tpu/ops/ba.py, the PCG branch of
// bundle_adjust). On the card those einsums ran as cuBLAS batched gemvs over
// 262,144 rows, three a step, each writing an (O, 6) or (O, 3) row tensor
// that a segment-sum kernel then read back: 0.8 of a global-BA iteration's
// device time. Here the per-row products never leave the SM.
//
// Bound: bytes. A step reads W twice (72 B a live row a pass), each row's
// int32 neighbour index twice, V_inv of the live points, U_d, x and the
// small tables, and writes y and out: ~45 MB at the benchmark's 262,144
// rows, ~13-15 us at 3.35 TB/s; the adds are 21 a row a pass, far below the
// f32 peak. What the design does about it:
//
// - W is read once a pass and coalesced: the wrapper permutes it once an LM
//   iteration into each pass's row order, plane-major (18, rows): entry
//   (i, m) of the row at position j of a pass's CSR order is
//   w[(3 i + m) stride + j], so consecutive threads (rows) read consecutive
//   floats of a plane. Each pass's neighbour index (the camera of each row
//   in point order, the point of each row in camera order) is int32 and
//   built once a solve.
// - x (C x 24 B) and y (P x 12 B) are gathered through the read-only cache
//   and stay in L1 / L2 (36 KB and 3.1 MB at the benchmark's size).
// - No atomics: each (segment, component) is one serial chain of adds in
//   the rows' order, acc = ((0 + t_0) + t_1) + ..., as the CPU's index_add_
//   takes it, so two runs give the same bits. The per-row products (three
//   or six fused multiply-adds) round differently from the CPU's einsums.
//
// Two routes a pass, chosen by the wrapper from shapes alone (rows per
// segment on average, as ops/segment_sum.route):
//
// - short (a point's 2-6 rows): a thread a segment, walking its rows;
// - long (a camera's hundreds of rows, up to ~1700): a block a segment, a
//   persistent grid over the segments longest first (so the longest chains
//   start in the first wave, and a block that meets an empty segment
//   finishes its remaining, all empty, ones at once). Warps 1-7 compute a
//   chunk of rows' products into shared memory while warp 0's first k
//   lanes add the chunk before in row order (double-buffered, one
//   __syncthreads a chunk), so the chain waits on shared-memory loads
//   issued a batch ahead, not on the gathers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockThreads = 256;  // the long route: warp 0 adds, warps 1-7 make rows
constexpr int kShortThreads = 128;  // the short route
constexpr int kMakers = kBlockThreads - 32;
constexpr int kRowsPerMaker = 2;
constexpr int kChunk = kMakers * kRowsPerMaker;  // rows of one shared-memory stage
constexpr int kBatch = 16;                       // rows an adder loads ahead of its adds
constexpr int kMaxDevices = 64;

struct Args {
  const float* w;         // (18, stride): W in this pass's row order, plane-major
  const int* nbr;         // (rows,): the row's other index (camera or point), this pass's order
  const int* off;         // (n + 1,): segment s is positions off[s] .. off[s + 1] - 1
  const int* first;       // (n,): segments by length, longest first (long route)
  const float* in;        // the gathered vector: x (C, 6) or y (P, 3)
  const float* x;         // (C, 6)
  const float* free_cam;  // (C,)
  const float* mat;       // V_inv (P, 3, 3) or U_d (C, 6, 6)
  float* out;             // y (P, 3) or out (C, 6)
  int n;                  // segments
  int64_t stride;         // W's plane stride
};

__device__ __forceinline__ float wld(const Args& a, int q, int j) {
  return __ldg(a.w + static_cast<int64_t>(q) * a.stride + j);
}

// A point: its rows' cameras, W^T (x * free) (6 -> 3), then V_inv.
struct PointPass {
  static constexpr int kOut = 3;

  __device__ static __forceinline__ void row(const Args& a, int j, float* t) {
    const int c = __ldg(a.nbr + j);
    const float f = __ldg(a.free_cam + c);
    float v[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) v[i] = __ldg(a.in + 6 * static_cast<int64_t>(c) + i) * f;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float s = wld(a, m, j) * v[0];
#pragma unroll
      for (int i = 1; i < 6; ++i) s = fmaf(wld(a, 3 * i + m, j), v[i], s);
      t[m] = s;
    }
  }

  // y_s = V_inv_s acc. A point with no live row is never gathered by the
  // camera pass; it gets zeros without reading its V_inv.
  __device__ static __forceinline__ void finish(const Args& a, int s, const float* acc, bool empty) {
    float* y = a.out + 3 * static_cast<int64_t>(s);
    if (empty) {
      y[0] = y[1] = y[2] = 0.0f;
      return;
    }
    const float* V = a.mat + 9 * static_cast<int64_t>(s);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      y[m] = fmaf(__ldg(V + 3 * m + 2), acc[2], fmaf(__ldg(V + 3 * m + 1), acc[1], __ldg(V + 3 * m) * acc[0]));
    }
  }
};

// A camera: its rows' points, W y (3 -> 6), then (U_d (x free) - sum) free.
struct CameraPass {
  static constexpr int kOut = 6;

  __device__ static __forceinline__ void row(const Args& a, int j, float* t) {
    const int p = __ldg(a.nbr + j);
    const float y0 = __ldg(a.in + 3 * static_cast<int64_t>(p));
    const float y1 = __ldg(a.in + 3 * static_cast<int64_t>(p) + 1);
    const float y2 = __ldg(a.in + 3 * static_cast<int64_t>(p) + 2);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      t[i] = fmaf(wld(a, 3 * i + 2, j), y2, fmaf(wld(a, 3 * i + 1, j), y1, wld(a, 3 * i, j) * y0));
    }
  }

  __device__ static __forceinline__ void finish(const Args& a, int s, const float* acc, bool) {
    const float f = __ldg(a.free_cam + s);
    float xm[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) xm[i] = __ldg(a.x + 6 * static_cast<int64_t>(s) + i) * f;
    const float* U = a.mat + 36 * static_cast<int64_t>(s);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float u = __ldg(U + 6 * i) * xm[0];
#pragma unroll
      for (int k = 1; k < 6; ++k) u = fmaf(__ldg(U + 6 * i + k), xm[k], u);
      a.out[6 * static_cast<int64_t>(s) + i] = (u - acc[i]) * f;
    }
  }
};

// The short route: thread s walks segment s's rows in order.
template <class Pass>
__device__ __forceinline__ void run_short(const Args& a) {
  const int s = blockIdx.x * kShortThreads + threadIdx.x;
  if (s >= a.n) return;
  const int b = __ldg(a.off + s), e = __ldg(a.off + s + 1);
  float acc[Pass::kOut];
#pragma unroll
  for (int k = 0; k < Pass::kOut; ++k) acc[k] = 0.0f;
  for (int j = b; j < e; ++j) {
    float t[Pass::kOut];
    Pass::row(a, j, t);
#pragma unroll
    for (int k = 0; k < Pass::kOut; ++k) acc[k] += t[k];
  }
  Pass::finish(a, s, acc, b == e);
}

// acc + col[0] + col[pitch] + ... + col[(rows - 1) pitch], added in that
// order; the loads run a batch of kBatch rows ahead of the adds.
__device__ __forceinline__ float add_column(float acc, const float* col, int rows, int pitch) {
  int r = 0;
  if (rows >= kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = col[u * pitch];
    for (; r + 2 * kBatch <= rows; r += kBatch) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        acc += v[u];
        v[u] = col[(r + kBatch + u) * pitch];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc += v[u];
    r += kBatch;
  }
  for (; r < rows; ++r) acc += col[r * pitch];
  return acc;
}

// Warps 1-7: the products of chunk `c` of the segment at positions b ..
// b + n - 1 into `stage` (row r at r * pitch).
template <class Pass>
__device__ __forceinline__ void make_rows(const Args& a, int b, int n, int c, float* stage) {
  constexpr int kPitch = Pass::kOut | 1;  // odd: the makers' stores spread over the banks
  const int base = c * kChunk;
  const int rows = min(kChunk, n - base);
#pragma unroll
  for (int q = 0; q < kRowsPerMaker; ++q) {
    const int r = static_cast<int>(threadIdx.x) - 32 + q * kMakers;
    if (r < rows) {
      float t[Pass::kOut];
      Pass::row(a, b + base + r, t);
#pragma unroll
      for (int k = 0; k < Pass::kOut; ++k) stage[r * kPitch + k] = t[k];
    }
  }
}

// The long route: a persistent grid over the segments in `first` order;
// block i takes positions i, i + gridDim.x, ...
template <class Pass>
__device__ __forceinline__ void run_long(const Args& a) {
  constexpr int kOut = Pass::kOut, kPitch = kOut | 1;
  __shared__ float stage[2][kChunk * kPitch];
  __shared__ float sums[kOut];
  const int tid = threadIdx.x;
  for (int i = blockIdx.x; i < a.n; i += gridDim.x) {
    const int s = __ldg(a.first + i);
    const int b = __ldg(a.off + s);
    const int n = __ldg(a.off + s + 1) - b;  // uniform over the block
    if (n == 0) {
      // By length, descending: the block's remaining positions are empty
      // too. A thread each finishes them with a zero sum.
      float zero[kOut];
#pragma unroll
      for (int k = 0; k < kOut; ++k) zero[k] = 0.0f;
      for (int64_t p = i + static_cast<int64_t>(tid) * gridDim.x; p < a.n;
           p += static_cast<int64_t>(kBlockThreads) * gridDim.x) {
        Pass::finish(a, __ldg(a.first + p), zero, true);
      }
      return;
    }
    const int chunks = (n + kChunk - 1) / kChunk;
    if (tid >= 32) make_rows<Pass>(a, b, n, 0, stage[0]);
    __syncthreads();
    float acc = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      // Chunk c + 1 goes to the stage that chunk c - 1 left, summed before
      // the last barrier.
      if (tid >= 32) {
        if (c + 1 < chunks) make_rows<Pass>(a, b, n, c + 1, stage[(c + 1) & 1]);
      } else if (tid < kOut) {
        acc = add_column(acc, stage[c & 1] + tid, min(kChunk, n - c * kChunk), kPitch);
      }
      __syncthreads();
    }
    // Lane 0 reads `sums` before the next segment's first barrier, which
    // lanes 1 .. kOut - 1 must pass before they write it again.
    if (tid < kOut) sums[tid] = acc;
    __syncwarp();
    if (tid == 0) {
      float v[kOut];
#pragma unroll
      for (int k = 0; k < kOut; ++k) v[k] = sums[k];
      Pass::finish(a, s, v, false);
    }
  }
}

template <bool kLong>
__global__ void __launch_bounds__(kBlockThreads) pcg_point_matvec(const Args a) {
  if constexpr (kLong) {
    run_long<PointPass>(a);
  } else {
    run_short<PointPass>(a);
  }
}

template <bool kLong>
__global__ void __launch_bounds__(kBlockThreads) pcg_camera_matvec(const Args a) {
  if constexpr (kLong) {
    run_long<CameraPass>(a);
  } else {
    run_short<CameraPass>(a);
  }
}

// The long route's grid: as many blocks as fit on the card at once (set
// once a device and pass), at most one a segment.
template <class Kernel>
int long_grid(Kernel kernel, int pass, int n, int* grid) {
  static int resident[kMaxDevices][2];
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev][pass] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[dev][pass], kernel, kBlockThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident[dev][pass] == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int64_t fit = static_cast<int64_t>(resident[dev][pass]) * sms[dev];
  *grid = static_cast<int>(n < fit ? n : fit);
  return 0;
}

int short_grid(int n) { return (n + kShortThreads - 1) / kShortThreads; }

int launch_points(const Args& a, int long_route, cudaStream_t stream) {
  if (a.n == 0) return 0;
  if (long_route) {
    int grid = 0;
    const int err = long_grid(pcg_point_matvec<true>, 0, a.n, &grid);
    if (err != 0) return err;
    pcg_point_matvec<true><<<grid, kBlockThreads, 0, stream>>>(a);
  } else {
    pcg_point_matvec<false><<<short_grid(a.n), kShortThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_cameras(const Args& a, int long_route, cudaStream_t stream) {
  if (a.n == 0) return 0;
  if (long_route) {
    int grid = 0;
    const int err = long_grid(pcg_camera_matvec<true>, 1, a.n, &grid);
    if (err != 0) return err;
    pcg_camera_matvec<true><<<grid, kBlockThreads, 0, stream>>>(a);
  } else {
    pcg_camera_matvec<false><<<short_grid(a.n), kShortThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One PCG matvec: the point pass into y, then the camera pass into out, on
// `stream`. pt_* / cam_*: each pass's plane-major W (18, stride), int32
// neighbour index (stride,), int32 offsets (n + 1,) and longest-first order
// (n,; read by the long route only), its segment count and route (1: long).
// x: (n_cams, 6); free_cam: (n_cams,); v_inv: (n_pts, 3, 3); u_d: (n_cams,
// 6, 6); y: (n_pts, 3) scratch; out: (n_cams, 6); all f32. Returns the
// first nonzero cudaGetLastError() after a launch (0 if none).
extern "C" int pcg_matvec_f32(const float* pt_w, const int* pt_nbr, const int* pt_off, const int* pt_first,
                              int n_pts, int pt_long, const float* cam_w, const int* cam_nbr, const int* cam_off,
                              const int* cam_first, int n_cams, int cam_long, int64_t stride, const float* free_cam,
                              const float* v_inv, const float* u_d, float* y, const float* x, float* out,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args pt{pt_w, pt_nbr, pt_off, pt_first, x, x, free_cam, v_inv, y, n_pts, stride};
  const int err = launch_points(pt, pt_long, st);
  if (err != 0) return err;
  const Args cam{cam_w, cam_nbr, cam_off, cam_first, y, x, free_cam, u_d, out, n_cams, stride};
  return launch_cameras(cam, cam_long, st);
}
