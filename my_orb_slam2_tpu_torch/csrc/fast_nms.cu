// Fused FAST-9/16 V-score + 3x3 non-maximum suppression for Hopper (sm_90a).
//
// Replaces my_orb_slam2_tpu/ops/fast_pallas.py:fast_nms_pallas (the Pallas
// TPU kernel, pl.pallas_call at fast_pallas.py:109). Its plain PyTorch
// version is ops/fast_nms.py: nms3x3(fast_score_map(img, thr, 9)).
//
// What bounds it on this card: the main path runs it on a 2288 x 656 f32
// pyramid atlas (6.0 MB) per image, so one pass reads ~6 MB and writes
// ~6 MB (about 4 us of HBM time at 3.35 TB/s), and spends ~300 simple
// float ops per pixel (16 ring differences, 2 x (48 + 16) min/max for the
// bright and dark arcs, the 3x3 max) -- about 0.5 GFLOP per atlas. At this
// size it is launch- and latency-bound, not bandwidth- or FLOP-bound.
//
// What the design does about it: one launch does the whole operation in one
// pass. Each block loads a TILE_H x TILE_W output tile plus a 4-pixel halo
// (ring radius 3 + 1 for the NMS neighbourhood) into shared memory, computes
// the V-score for the tile plus a 1-pixel ring into shared memory, and runs
// the NMS from there, so the score map never goes to device memory. A
// leading batch dimension (blockIdx.z) lets several images share a launch.
//
// Arithmetic: subtraction, min, max and compares are exact in IEEE f32, and
// the arc reduction uses the same log-step window as the plain version, so
// the output is bit-identical to nms3x3(fast_score_map(...)) on every pixel:
// the 3-pixel border scores 0 (interior mask in global image coordinates,
// as at fast_pallas.py:73-79) and neighbours outside the image count as
// -inf, like max_pool2d's padding. Build without --use_fast_math (it
// implies flush-to-zero).
//
// Entry point (plain C ABI, loaded with ctypes):
//   int fast_nms_f32(const float* in, float* out, int B, int H, int W,
//                    float thr, int arc, void* stream)
// in/out: contiguous (B, H, W) f32 device buffers. Only arc == 9 (the
// FAST-9/16 test of OrbConfig.fast_arc) is built. Returns the
// cudaGetLastError() of the launch (0 = launched).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int HALO = 4;
constexpr int IN_W = TILE_W + 2 * HALO;
constexpr int IN_H = TILE_H + 2 * HALO;
constexpr int SC_W = TILE_W + 2;
constexpr int SC_H = TILE_H + 2;

// max over the 16 cyclic starts of the min over 9 consecutive entries:
// windows 2, 4, 8 by log-step doubling, then the 9th entry, exactly as
// frontend.fast_score_map's arc_max_min.
__device__ __forceinline__ float arc_max_min9(const float d[16]) {
  float m2[16], m4[16], m8[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m2[i] = fminf(d[i], d[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m4[i] = fminf(m2[i], m2[(i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m8[i] = fminf(m4[i], m4[(i + 4) & 15]);
  float best = fminf(m8[0], d[8]);
#pragma unroll
  for (int i = 1; i < 16; ++i) best = fmaxf(best, fminf(m8[i], d[(i + 8) & 15]));
  return best;
}

__global__ void __launch_bounds__(256) fast_nms_kernel(
    const float* __restrict__ in, float* __restrict__ out, int H, int W, float thr) {
  __shared__ float tile[IN_H][IN_W + 1];
  __shared__ float score[SC_H][SC_W + 1];

  const size_t plane = (size_t)H * (size_t)W;
  const float* img = in + (size_t)blockIdx.z * plane;
  float* dst = out + (size_t)blockIdx.z * plane;
  const int y0 = blockIdx.y * TILE_H;
  const int x0 = blockIdx.x * TILE_W;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;

  // 1. Tile + halo into shared memory (zeros outside the image: every pixel
  //    that reads them lies in the masked 3-pixel border).
  for (int i = tid; i < IN_H * IN_W; i += nt) {
    const int ty = i / IN_W;
    const int tx = i - ty * IN_W;
    const int gy = y0 - HALO + ty;
    const int gx = x0 - HALO + tx;
    tile[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();

  // 2. V-score on the tile plus a 1-pixel ring.
  for (int i = tid; i < SC_H * SC_W; i += nt) {
    const int sy = i / SC_W;
    const int sx = i - sy * SC_W;
    const int gy = y0 - 1 + sy;
    const int gx = x0 - 1 + sx;
    float s;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
      s = -INFINITY;
    } else if (gy < 3 || gy >= H - 3 || gx < 3 || gx >= W - 3) {
      s = 0.f;
    } else {
      const int cy = sy + HALO - 1;
      const int cx = sx + HALO - 1;
      const float c = tile[cy][cx];
      float d[16], n[16];
      // Bresenham ring of radius 3 in FAST_RING order (dy, dx).
      d[0] = tile[cy - 3][cx + 0] - c;
      d[1] = tile[cy - 3][cx + 1] - c;
      d[2] = tile[cy - 2][cx + 2] - c;
      d[3] = tile[cy - 1][cx + 3] - c;
      d[4] = tile[cy + 0][cx + 3] - c;
      d[5] = tile[cy + 1][cx + 3] - c;
      d[6] = tile[cy + 2][cx + 2] - c;
      d[7] = tile[cy + 3][cx + 1] - c;
      d[8] = tile[cy + 3][cx + 0] - c;
      d[9] = tile[cy + 3][cx - 1] - c;
      d[10] = tile[cy + 2][cx - 2] - c;
      d[11] = tile[cy + 1][cx - 3] - c;
      d[12] = tile[cy + 0][cx - 3] - c;
      d[13] = tile[cy - 1][cx - 3] - c;
      d[14] = tile[cy - 2][cx - 2] - c;
      d[15] = tile[cy - 3][cx - 1] - c;
#pragma unroll
      for (int k = 0; k < 16; ++k) n[k] = -d[k];
      const float v = fmaxf(arc_max_min9(d), arc_max_min9(n));
      s = v > thr ? v : 0.f;
    }
    score[sy][sx] = s;
  }
  __syncthreads();

  // 3. 3x3 NMS from shared memory: keep score >= max(neighbourhood).
  for (int i = tid; i < TILE_H * TILE_W; i += nt) {
    const int oy = i / TILE_W;
    const int ox = i - oy * TILE_W;
    const int gy = y0 + oy;
    const int gx = x0 + ox;
    if (gy >= H || gx >= W) continue;
    const float s = score[oy + 1][ox + 1];
    float m = s;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, score[oy + dy][ox + dx]);
    dst[(size_t)gy * W + gx] = s >= m ? s : 0.f;
  }
}

}  // namespace

extern "C" int fast_nms_f32(const float* in, float* out, int B, int H, int W, float thr,
                            int arc, void* stream) {
  if (arc != 9 || B <= 0 || B > 65535 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  fast_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, out, H, W, thr);
  return (int)cudaGetLastError();
}
