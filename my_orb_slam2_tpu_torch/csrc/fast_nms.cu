// Fused FAST-9/16 V-score + 3x3 non-maximum suppression for Hopper (sm_90a).
//
// Replaces my_orb_slam2_tpu/ops/fast_pallas.py:fast_nms_pallas (the Pallas
// TPU kernel, pl.pallas_call at fast_pallas.py:109). Its plain PyTorch
// version is ops/fast_nms.py: nms3x3(fast_score_map(img, thr, 9)).
//
// What bounds it on this card: the main path runs it once per stereo frame
// on the (2, 2288, 656) f32 L+R atlas batch. Each atlas must be read once
// and written once: 12.0 MB, 3.58 us at 3.35 TB/s. The arithmetic depends
// on the data: on the bench atlas an exact compass test passes 11.2% of the
// pixels, and only those need the 16-entry ring and one 55-op arc; with the
// NMS that is ~27 M operations an atlas, 0.40 us at 67 TFLOP/s. So the
// bound is the bytes (ops/fast_nms.work counts both for a given input).
//
// What the design does about it:
// - Loads. Each block owns a TH x TW output tile and brings in the tile
//   with a 4-row and an 8-column halo in one copy. Where the row pitch is
//   16-byte aligned, a TMA 3D tile load (cp.async.bulk.tensor + mbarrier)
//   does it, and TMA's out-of-bounds zero fill is exactly the zeros outside
//   the image. Other pitches (an odd image width, such as KITTI's 1241 + 16)
//   take a coalesced scalar loader into the same shared layout.
// - Early rejection (exact). A pixel scores above `thr` only if 9
//   consecutive ring entries are all > thr (bright) or all < -thr (dark).
//   Every 9 consecutive entries of the 16 hold two cyclically adjacent
//   compass entries (0,4), (4,8), (8,12) or (12,0). So a pixel whose
//   compass diffs have no such pair above thr, and none below -thr, scores
//   exactly 0 (this implies the looser form, "at least 2 of the 4 compass
//   entries"). Each thread tests 4 neighbouring pixels from five 16-byte
//   shared loads, with no branch on the pixels' position. The pixels that
//   pass (11% of the bench atlas, but 34% of 32-pixel row segments: a warp
//   vote would leave most lanes idle) are compacted into a shared list,
//   one shared atomic per warp, and scored densely by all threads.
// - Scoring. Rounding of x - c is monotone in x, so min and max commute with
//   it: the arc is taken over the raw ring values and c subtracted once, and
//   only the direction(s) the compass test let through are evaluated (the
//   other arc is <= thr and cannot change the result). The arc of 16
//   windows of 9 shares the 8-entry minima of the windows starting at 2i and
//   2i + 1: 55 min/max, reduced as a tree.
// - NMS and stores. A pixel whose score is 0 outputs 0 whatever its
//   neighbours, so the 3x3 max is taken only where a score is non-zero.
//   Outputs are written 4 at a time with 16-byte stores where aligned.
// - One launch covers a batch: blockIdx.z is the image (the L+R pair).
// - Tile and block sizes (48 x 16 outputs, 128 threads, 56 registers, no
//   spills, 12 KB of shared memory, 9 blocks an SM) were chosen by timing
//   variants on the card (PERF.md). What holds it back there is the
//   instruction work of the compass pass and of the scoring, not the bytes:
//   loading and storing alone take ~4.4 us an atlas.
//
// Arithmetic: subtraction, min, max and compares are exact in IEEE f32, so
// the output is bit-identical to nms3x3(fast_score_map(...)) on every
// pixel: the 3-pixel border scores 0 (interior mask in global image
// coordinates, as at fast_pallas.py:73-79) and neighbours outside the
// image count as -inf, like max_pool2d's padding. Build without
// --use_fast_math (it implies flush-to-zero).
//
// Entry point (plain C ABI, loaded with ctypes):
//   int fast_nms_f32(const float* in, float* out, int B, int H, int W,
//                    float thr, int arc, void* stream)
// in/out: contiguous (B, H, W) f32 device buffers. Only arc == 9 (the
// FAST-9/16 test of OrbConfig.fast_arc) is built. Returns a cudaError_t
// (0 = launched; cudaErrorNotSupported if libcuda's tensor-map encoder
// cannot be found for an aligned input).

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TW = 48;           // output columns per block (multiple of 4)
constexpr int TH = 16;           // output rows per block
constexpr int NT = 128;          // threads per block
constexpr int MIN_BLOCKS = 8;    // resident blocks an SM (caps registers at 64)
constexpr int IN_W = TW + 16;    // input tile columns: x0 - 8 .. x0 + TW + 7
constexpr int IN_H = TH + 8;     // input tile rows:    y0 - 4 .. y0 + TH + 3
constexpr int SC_W = TW + 8;     // score tile columns: x0 - 4 .. x0 + TW + 3
constexpr int SC_H = TH + 2;     // score tile rows:    y0 - 1 .. y0 + TH
constexpr int PX = 4;            // neighbouring pixels a thread tests in the compass pass
constexpr int GA = SC_W / PX;    // PX-pixel groups per score row
constexpr int GC = TW / 4;       // 4-pixel groups per output row
static_assert(TW % 4 == 0 && PX % 4 == 0 && SC_W % PX == 0, "tiles are whole 16-byte groups");
static_assert(NT % 32 == 0, "blocks are whole warps");
static_assert(SC_H * SC_W < 65536, "list entries are 16-bit");
static_assert(IN_W <= 256 && IN_H <= 256, "TMA box dimensions are at most 256");

struct __align__(128) Smem {
  float4 tile[IN_H][IN_W / 4];   // TMA destination (128-byte aligned)
  float4 score[SC_H][SC_W / 4];
  uint16_t list[SC_H * SC_W];
  uint8_t keep[GA];  // per group of a score row: a bit a pixel
  uint64_t bar;
  int n_list;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// max over the 16 cyclic starts i of min(x[i .. i+8]): the FAST arc of the
// ring values x = sgn * ring (sgn = -1 for the dark arc). Pair minima of
// x[2i+1], x[2i+2] are doubled twice to the 8 entries x[2i+1 .. 2i+8],
// which the windows starting at 2i and 2i+1 share: 55 min/max instead of
// the 79 of a log-step over all 16 starts. Min and max are exact, so the
// order does not change the value.
__device__ __forceinline__ float arc_max_min9(const float ring[16], float sgn) {
  float x[16], p[8], q[8], o[8], w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = sgn * ring[i];
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = fminf(x[2 * i + 1], x[(2 * i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = fminf(p[i], p[(i + 1) & 7]);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = fminf(q[i], q[(i + 2) & 7]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[2 * i] = fminf(o[i], x[2 * i]);
    w[2 * i + 1] = fminf(o[i], x[(2 * i + 9) & 15]);
  }
  // The max over the 16 windows as a tree, 4 steps deep (a chain is 16).
  // Every loop has a constant trip count, so w stays in registers.
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = fmaxf(w[i], w[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = fmaxf(w[i], w[i + 4]);
  return fmaxf(fmaxf(w[0], w[2]), fmaxf(w[1], w[3]));
}

// The exact compass test of one pixel (c the centre, n/e/s/w the ring
// entries 0, 4, 8, 12): bit 0 if the bright arc may exceed thr, bit 1 if
// the dark one may. The rule is (dn > thr or ds > thr) and (de > thr or
// dw > thr) for bright, with d = x - c. x - c rounds monotonically in x, so
// min and max commute with it: max(dn, ds) = fl(max(n, s) - c), and the
// rule is fl(min(max(n, s), max(e, w)) - c) > thr (the dark one mirrored).
__device__ __forceinline__ uint32_t compass_flags(float c, float n, float e, float s, float w, float thr) {
  const float hi = fminf(fmaxf(n, s), fmaxf(e, w));
  const float lo = fmaxf(fminf(n, s), fminf(e, w));
  return (uint32_t)(hi - c > thr) | ((uint32_t)(lo - c < -thr) << 1);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void tma_load_tile(Smem& sm, const CUtensorMap* map, int x, int y, int z) {
  const uint32_t bar = smem_u32(&sm.bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"((uint32_t)sizeof(sm.tile))
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(&sm.tile[0][0])),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// Spins until the barrier's phase completes. A tile that never arrives (a
// malformed tensor map) traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
    if (done) return;
  }
}

template <bool kTma>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) fast_nms_kernel(
    const __grid_constant__ CUtensorMap map, const float* __restrict__ in, float* __restrict__ out, int H,
    int W, float thr) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const size_t plane = (size_t)H * (size_t)W;
  float* dst = out + (size_t)blockIdx.z * plane;
  float* tile = &sm.tile[0][0].x;
  float* score = &sm.score[0][0].x;

  // 1. Input tile (zeros outside the image: every pixel that reads them lies
  //    in the 3-pixel border, which scores 0).
  if (tid == 0) sm.n_list = 0;
  if (tid < GA) {
    // The pixels of group `tid` that may be listed: inside the 3-pixel
    // border (columns) and read by the NMS (score columns 3 .. TW + 4).
    constexpr uint32_t all = (1u << PX) - 1u;
    const int gx = x0 - 4 + PX * tid;
    const int jlo = max(max(3 - gx, 3 - PX * tid), 0);
    const int jhi = min(min(W - 4 - gx, TW + 4 - PX * tid), PX - 1);
    sm.keep[tid] = jlo <= jhi ? (all << jlo) & (all >> (PX - 1 - jhi)) : 0u;
  }
  if constexpr (kTma) {
    if (tid == 0) {
      mbar_init(&sm.bar, 1);
      tma_load_tile(sm, &map, x0 - 8, y0 - 4, blockIdx.z);
    }
    __syncthreads();  // n_list and the barrier's init are visible
    mbar_wait(&sm.bar, 0);
  } else {
    const float* img = in + (size_t)blockIdx.z * plane;
    for (int i = tid; i < IN_H * IN_W; i += NT) {
      const int r = i / IN_W;
      const int c = i - r * IN_W;
      const int gy = y0 - 4 + r;
      const int gx = x0 - 8 + c;
      tile[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? __ldg(img + (size_t)gy * W + gx) : 0.f;
    }
    __syncthreads();
  }

  // 2. Compass test on the score tile (the output tile plus a 1-pixel ring),
  //    PX neighbouring pixels a thread from 16-byte shared loads; survivors
  //    go to the list, the rest score 0 (-inf outside the image).
  for (int g0 = (tid & ~31); g0 < SC_H * GA; g0 += NT) {
    const int g = g0 + lane;
    uint32_t pass = 0;  // a bit a pixel that may score
    int r = 0, k = 0;
    if (g < SC_H * GA) {
      r = g / GA;
      k = g - r * GA;
      const int gy = y0 - 1 + r;
      const int gx = x0 - 4 + PX * k;
      // Centre row: input columns PX*k .. PX*k + PX + 7 (pixel j's centre
      // is a[j + 4], its west and east ring entries a[j + 1] and a[j + 7]);
      // the rows 3 above and below: the centres' columns.
      float a[PX + 8], nv[PX], sv[PX];
#pragma unroll
      for (int q = 0; q < PX / 4 + 2; ++q) {
        const float4 m = sm.tile[r + 3][(PX / 4) * k + q];
        a[4 * q] = m.x, a[4 * q + 1] = m.y, a[4 * q + 2] = m.z, a[4 * q + 3] = m.w;
      }
#pragma unroll
      for (int q = 0; q < PX / 4; ++q) {
        const float4 n = sm.tile[r][(PX / 4) * k + 1 + q], s = sm.tile[r + 6][(PX / 4) * k + 1 + q];
        nv[4 * q] = n.x, nv[4 * q + 1] = n.y, nv[4 * q + 2] = n.z, nv[4 * q + 3] = n.w;
        sv[4 * q] = s.x, sv[4 * q + 1] = s.y, sv[4 * q + 2] = s.z, sv[4 * q + 3] = s.w;
      }
      // The compass test of all PX pixels, then the group's mask: no branch
      // on the group's position, so the warp does not diverge.
      const uint32_t keep = (gy >= 3 && gy < H - 3) ? sm.keep[k] : 0u;
#pragma unroll
      for (int j = 0; j < PX; ++j)
        if (compass_flags(a[j + 4], nv[j], a[j + 7], sv[j], a[j + 1], thr)) pass |= 1u << j;
      pass &= keep;
      float4* dst_sc = &sm.score[r][(PX / 4) * k];
      if (gy >= 0 && gy < H && gx >= 0 && gx + PX - 1 < W) {
#pragma unroll
        for (int q = 0; q < PX / 4; ++q) dst_sc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        float sc[PX];
#pragma unroll
        for (int j = 0; j < PX; ++j) sc[j] = (gy >= 0 && gy < H && gx + j >= 0 && gx + j < W) ? 0.f : -INFINITY;
#pragma unroll
        for (int q = 0; q < PX / 4; ++q)
          dst_sc[q] = make_float4(sc[4 * q], sc[4 * q + 1], sc[4 * q + 2], sc[4 * q + 3]);
      }
    }
    // Warp-aggregated append: each lane's offset from ballots of the bits of
    // its count (0 .. PX), one shared atomic per warp.
    const int cnt = __popc(pass);
    uint32_t bits[4];
    int total = 0;
#pragma unroll
    for (int b = 0; (1 << b) <= PX; ++b) {
      bits[b] = __ballot_sync(0xffffffffu, cnt & (1 << b));
      total += __popc(bits[b]) << b;
    }
    if (total) {
      const uint32_t lt = (1u << lane) - 1u;
      int base = 0;
      if (lane == 0) base = atomicAdd(&sm.n_list, total);
      base = __shfl_sync(0xffffffffu, base, 0);
#pragma unroll
      for (int b = 0; (1 << b) <= PX; ++b) base += __popc(bits[b] & lt) << b;
      while (pass) {
        const int j = __ffs(pass) - 1;
        pass &= pass - 1;
        sm.list[base++] = (uint16_t)(r * SC_W + PX * k + j);
      }
    }
  }
  __syncthreads();

  // 3. V-score of the listed pixels, densely over all threads. d = x - c
  //    rounds monotonically in x, so min and max commute with it: the
  //    bright arc is fl(arc(x) - c) over the raw ring values x, and the
  //    dark arc, arc(-d), is fl(arc(-x) + c). Only the directions the
  //    compass test let through are evaluated; the other arc is <= thr, so
  //    it cannot change `v > thr ? v : 0`. The directions are the compass
  //    test's again (cheaper here, on the few listed pixels, than carried
  //    in the list). One code path serves both directions (x negated for
  //    the dark one), so a warp does not diverge.
  const int n_list = sm.n_list;
  for (int e = tid; e < n_list; e += NT) {
    const int idx = sm.list[e];
    const int r = idx / SC_W;
    const int c = idx - r * SC_W;
    const float* t = tile + (r + 3) * IN_W + (c + 4);  // centre in the input tile
    const float cv = t[0];
    // Bresenham ring of radius 3 in FAST_RING order (dy, dx). Assigned one
    // by one: an aggregate-initialized array was put on the stack by ptxas.
    float ring[16];
    ring[0] = t[-3 * IN_W + 0];
    ring[1] = t[-3 * IN_W + 1];
    ring[2] = t[-2 * IN_W + 2];
    ring[3] = t[-1 * IN_W + 3];
    ring[4] = t[0 * IN_W + 3];
    ring[5] = t[1 * IN_W + 3];
    ring[6] = t[2 * IN_W + 2];
    ring[7] = t[3 * IN_W + 1];
    ring[8] = t[3 * IN_W + 0];
    ring[9] = t[3 * IN_W - 1];
    ring[10] = t[2 * IN_W - 2];
    ring[11] = t[1 * IN_W - 3];
    ring[12] = t[0 * IN_W - 3];
    ring[13] = t[-1 * IN_W - 3];
    ring[14] = t[-2 * IN_W - 2];
    ring[15] = t[-3 * IN_W - 1];
    // 1 bright, 2 dark, 3 both (rare)
    const uint32_t dirs = compass_flags(cv, ring[0], ring[4], ring[8], ring[12], thr);
    const float sgn = dirs == 2u ? -1.f : 1.f;
    float v = arc_max_min9(ring, sgn) - sgn * cv;
    if (dirs == 3u) v = fmaxf(v, arc_max_min9(ring, -1.f) + cv);
    score[r * SC_W + c] = v > thr ? v : 0.f;
  }
  __syncthreads();

  // 4. 3x3 NMS (keep score >= max of the neighbourhood) and the stores, 4
  //    pixels a thread. A zero score outputs 0, so the neighbourhood is read
  //    only where a score is non-zero.
  const bool vec_store = (W & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  for (int g = tid; g < TH * GC; g += NT) {
    const int oy = g / GC;
    const int k = g - oy * GC;
    const int gy = y0 + oy;
    const int gx = x0 + 4 * k;
    if (gy >= H || gx >= W) continue;
    const float4 c4 = sm.score[oy + 1][k + 1];
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if (c4.x != 0.f || c4.y != 0.f || c4.z != 0.f || c4.w != 0.f) {
      const float s[4] = {c4.x, c4.y, c4.z, c4.w};
      float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float4 p0 = sm.score[oy + dy][k], p1 = sm.score[oy + dy][k + 1], p2 = sm.score[oy + dy][k + 2];
        const float row[12] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x, p2.y, p2.z, p2.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) m[j] = fmaxf(m[j], fmaxf(row[j + 3], fmaxf(row[j + 4], row[j + 5])));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = (s[j] != 0.f && s[j] >= m[j]) ? s[j] : 0.f;
    }
    float* p = dst + (size_t)gy * W + gx;
    if (vec_store && gx + 3 < W) {
      *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gx + j < W) p[j] = o[j];
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder (cuTensorMapEncodeTiled), looked up once in
// the libcuda that the process has already loaded (no link-time dependency
// on it).
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

}  // namespace

extern "C" int fast_nms_f32(const float* in, float* out, int B, int H, int W, float thr, int arc,
                            void* stream) {
  if (arc != 9 || B <= 0 || B > 65535 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  const bool tma = (W % 4) == 0 && (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  if (tma) {
    const EncodeTiled encode = encoder();
    if (!encode) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)H * W * 4};
    const cuuint32_t box[3] = {IN_W, IN_H, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(in), dims, strides,
                                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
    fast_nms_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(map, in, out, H, W, thr);
  } else {
    fast_nms_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(map, in, out, H, W, thr);
  }
  return (int)cudaGetLastError();
}
