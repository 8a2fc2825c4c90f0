// The fused warp of the s2d carry, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel warp_combine
// (tecogan_tpu/ops/pallas/warp_combine.py) together with the XLA graph
// the JAX s2d-carry route builds around that combine
// (tecogan_tpu/engine/fused.py: planar_pseudo_flow_coords, the packed u8
// table and gather of warp_s2d_carry, and the deprocess + space-to-depth
// at the head of fused_first_layer).  On a TPU the gather had to stay
// outside the kernel; here each thread loads its own taps.
//
// Contract (NHWC):
//   carry   (B, H, W, 48) bf16, contiguous: the s2d SR frame,
//           carry[b, i, j, c*16 + a*4 + bb] = frame[b, 4i+a, 4j+bb, c]
//   prev_lr (B, H, W, 3)  f32, contiguous
//   out     (B, H, W, 48) bf16, the same channel order:
//     out = s2d(deprocess(grid_sample(q(frame), pseudo_flow(prev_lr))))
// where q(v) = clamp(rint(v * 255), 0, 255) / 255 (the JAX route's u8
// carry), grid_sample is bilinear with zero padding and
// align_corners=False, and pseudo_flow is the reference's raw .view of
// the (2, 4H, 4W) bilinear x4 upsample of prev_lr[..., 0:2] * 4 as a
// (4H, 4W, 2) grid.
//
// What bounds it: at 1080p the kernel must write the 12.4 MB feedback
// and read prev_lr's R and G planes (1.0 MB) and the carry taps that land
// inside the frame (at most the 12.4 MB carry): ~26 MB, ~8 us at
// 3.35 TB/s.  The arithmetic (~50 f32 operations a HR pixel) is far below
// the CUDA cores' rate.  The carry (12.4 MB) and prev_lr fit in the 50 MB
// L2, so the scattered, data-dependent tap reads mostly hit it.
//
// The raw view: grid[r, c, k] is flat element 2*(r*4W + c) + k of the
// (2, 4H, 4W) planes.  HR row r reads plane r >= 2H (R, then G) at plane
// row rr = r - 2H*plane; both k land in plane row yy = 2*rr + over,
// columns xx = 2c - over*4W and xx + 1, where over = 2c >= 4W.  The
// upsample's source rows of yy = 2*rr and 2*rr + 1 are the same two
// (only the weight differs), and the 8 values of 4 neighbouring pixels
// (c = 4j .. 4j+3) are 8 consecutive columns from 8j - over*4W, whose
// source columns are L - 1 .. L + 2 with L = 2j - over*W and fixed
// weights 5/8, 7/8, 1/8, 3/8, 5/8, 7/8, 1/8, 3/8.
//
// Design: one thread per (LR pixel j, sub-row a): 4 HR pixels.  A block
// covers TJ = 32 LR pixels of one LR row (128 threads).  It first stages
// the plane rows of prev_lr its 4 sub-rows read, once each, in shared
// memory: at odd H the plane switches inside the LR row (a = 0, 1 read R,
// a = 2, 3 read G), and the block stages rows of both.  Each staged row
// holds the 2*TJ + 2 source columns of the block's non-wrapped pixels
// (window 0) and, where the block has pixels with over = 1, those of the
// wrapped ones (window 1), clamped at the edges as the upsample clamps.
// A thread makes one vertical lerp per source column (4) and 8 horizontal
// lerps with fixed weights; at odd W the wrap can fall inside its 4
// pixels (between bb = 1 and bb = 2), and it then lerps both windows and
// picks per pixel.  A pixel with a tap in the frame issues all its tap
// loads (in-frame taps only, 3 channels each) before using the first, so
// it pays one memory latency.  The thread writes its 4 pixels x 3
// channels as three 8-byte stores into slots c*16 + a*4 + [0..3]: the 4
// threads of an LR pixel write its 96 contiguous bytes.  No shared-memory
// records, no barrier after staging.
//
// On random flow the in-frame taps are scattered: each costs 32-byte
// sectors of the carry for 2-byte values, so the data-dependent byte
// bound, which counts 6 bytes a touched pixel, is not reachable there.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int C = 3;               // colour channels
constexpr int S2D = 16 * C;        // s2d channels of one LR pixel
constexpr int TJ = 32;             // LR pixels per block
constexpr int THREADS = TJ * 4;    // one thread per (LR pixel, sub-row)
constexpr int SPAN = 2 * TJ + 2;   // staged source columns per window
constexpr int SLOTS = 8;           // staged plane rows (at most 4 + 4)

// Source taps of output index `dst` of a x4 bilinear upsample
// (align_corners=False, edge clamp), as torch's upsample_bilinear2d
// computes them.
__device__ __forceinline__ void source_taps(int dst, int in_size, int& i0,
                                            int& i1, float& l1) {
  float src = (dst + 0.5f) * 0.25f - 0.5f;
  src = src < 0.f ? 0.f : src;
  i0 = min(static_cast<int>(src), in_size - 1);
  i1 = i0 + (i0 < in_size - 1 ? 1 : 0);
  l1 = fminf(fmaxf(src - i0, 0.f), 1.f);
}

// Plane, plane row and the two source rows (of the upsample) of HR row r.
__device__ __forceinline__ void plane_rows(int r, int H, int& plane, int& rr,
                                           int& y0, int& y1) {
  plane = r >= 2 * H ? 1 : 0;
  rr = r - plane * 2 * H;
  float unused;
  source_taps(2 * rr, H, y0, y1, unused);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS, 8)
warp_s2d_kernel(const __nv_bfloat16* __restrict__ carry,
                const float* __restrict__ prev_lr,
                __nv_bfloat16* __restrict__ out, int H, int W) {
  __shared__ float lr_s[2][SLOTS][SPAN];

  const int b = blockIdx.z;
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * TJ;
  const int nj = min(TJ, W - j0);
  const int H4 = 4 * H, W4 = 4 * W;

  // The block's plane rows: segment 0 holds the rows of the first
  // sub-row's plane, segment 1 (odd H only) those of the second plane.
  int p_first, p_last, rr, lo0, hi0, lo1 = 0, hi1 = -1, unused;
  plane_rows(4 * i, H, p_first, rr, lo0, unused);
  plane_rows(4 * i + 3, H, p_last, rr, unused, hi0);
  if (p_last != p_first) {
    const int split = 2 * H - 4 * i;  // first sub-row on the second plane
    hi1 = hi0;
    plane_rows(4 * i + split - 1, H, p_first, rr, unused, hi0);
    plane_rows(4 * i + split, H, p_last, rr, lo1, unused);
  }
  const int n0 = hi0 - lo0 + 1;
  const int ns = n0 + hi1 - lo1 + 1;
  // window 0: pixels with 2c < 4W, from column 2*j0 - 1; window 1: the
  // wrapped pixels, from column 2*j0 - W - 1
  const bool need[2] = {4 * j0 < 2 * W, 4 * (j0 + nj) - 1 >= 2 * W};
  const float* lr_img = prev_lr + (size_t)b * H * W * C;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (!need[w]) continue;
    for (int e = threadIdx.x; e < ns * SPAN; e += THREADS) {
      const int sl = e / SPAN, m = e % SPAN;
      const bool second = sl >= n0;
      const int y = second ? lo1 + sl - n0 : lo0 + sl;
      const int col = min(max(2 * j0 - 1 - w * W + m, 0), W - 1);
      lr_s[w][sl][m] = lr_img[((size_t)y * W + col) * C + (second ? p_last : p_first)];
    }
  }
  __syncthreads();

  const int jl = threadIdx.x >> 2;
  const int a = threadIdx.x & 3;
  if (jl >= nj) return;
  const int j = j0 + jl;

  int plane, y0, y1;
  plane_rows(4 * i + a, H, plane, rr, y0, y1);
  const int s0 = plane == p_first ? y0 - lo0 : n0 + y0 - lo1;
  const int s1 = plane == p_first ? y1 - lo0 : n0 + y1 - lo1;
  // over of the first and the last of the thread's 4 pixels
  const int ov_lo = 8 * j >= W4 ? 1 : 0;
  const int ov_hi = 8 * j + 6 >= W4 ? 1 : 0;

  // one vertical lerp per source column, in window `ov` and with the row
  // weight of plane row yy = 2*rr + ov
  auto vlerp = [&](int ov, float (&v)[4]) {
    int t0, t1;
    float ly;
    source_taps(2 * rr + ov, H, t0, t1, ly);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      v[m] = (1.f - ly) * lr_s[ov][s0][2 * jl + m] + ly * lr_s[ov][s1][2 * jl + m];
  };
  float v_lo[4], v_hi[4];
  vlerp(ov_lo, v_lo);
  if (ov_hi != ov_lo) {  // the wrap falls inside the 4 pixels (odd W)
    vlerp(ov_hi, v_hi);
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) v_hi[m] = v_lo[m];
  }

  // Per pixel: its 4 bilinear taps, and when one lies in the frame, all
  // 12 tap loads (3 channels) issued before the first is used, so that
  // the pixel pays one memory latency.
  const __nv_bfloat16* img = carry + (size_t)b * H * W * S2D;
  float res[C][4];
#pragma unroll
  for (int bb = 0; bb < 4; ++bb) {
    const bool hi = 8 * j + 2 * bb >= W4;
    float g[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      // column 2*bb + k of the 8: source columns (m+2)/4 and the next of
      // the window, weight frac((m + 0.5) / 4 + 0.5)
      const int m = 2 * bb + k;
      const int c0 = (m + 2) / 4;
      const float lx = (m + 0.5f) * 0.25f + 0.5f - c0;
      const float va = hi ? v_hi[c0] : v_lo[c0];
      const float vb = hi ? v_hi[c0 + 1] : v_lo[c0 + 1];
      g[k] = (1.f - lx) * va + lx * vb;
    }
    // grid = upsample(prev_lr * 4); unnormalize as grid_sample does
    const float ix = ((4.f * g[0] + 1.f) * W4 - 1.f) * 0.5f;
    const float iy = ((4.f * g[1] + 1.f) * H4 - 1.f) * 0.5f;
    const float fx = floorf(ix), fy = floorf(iy);
    float acc[C] = {0.f, 0.f, 0.f};
    if (fx >= -1.f && fx <= static_cast<float>(W4 - 1) && fy >= -1.f &&
        fy <= static_cast<float>(H4 - 1)) {
      const float wx = ix - fx, wy = iy - fy;
      bool ok[4];
      float tw[4];
      int toff[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float ty = fy + (t >> 1), tx = fx + (t & 1);
        ok[t] = ty >= 0.f && ty <= static_cast<float>(H4 - 1) && tx >= 0.f &&
                tx <= static_cast<float>(W4 - 1);
        const int y = ok[t] ? static_cast<int>(ty) : 0;
        const int x = ok[t] ? static_cast<int>(tx) : 0;
        tw[t] = ((t >> 1) ? wy : 1.f - wy) * ((t & 1) ? wx : 1.f - wx);
        toff[t] = ((y >> 2) * W + (x >> 2)) * S2D + (y & 3) * 4 + (x & 3);
      }
      float tv[4][C];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          tv[t][ch] = ok[t] ? __bfloat162float(img[toff[t] + ch * 16]) : 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          acc[ch] = fmaf(tw[t], fminf(fmaxf(rintf(tv[t][ch] * 255.f), 0.f), 255.f), acc[ch]);
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      res[ch][bb] = (acc[ch] * (1.f / 255.f) + 1.f) * 0.5f;  // deprocess
    }
  }

  // deprocess rounded once to bf16; slots c*16 + a*4 + [0..3]
  __nv_bfloat16* o = out + (((size_t)b * H + i) * W + j) * S2D + a * 4;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    uint2 pk;
    pk.x = pack_bf16x2(res[ch][0], res[ch][1]);
    pk.y = pack_bf16x2(res[ch][2], res[ch][3]);
    *reinterpret_cast<uint2*>(o + ch * 16) = pk;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): launch on `stream` without
// synchronising, on the calling thread's current device; returns
// cudaGetLastError() (0 on success).
extern "C" int warp_s2d_launch(const void* carry, const void* prev_lr, void* out,
                               int B, int H, int W, void* stream) {
  const dim3 grid((W + TJ - 1) / TJ, H, B);
  warp_s2d_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(carry), static_cast<const float*>(prev_lr),
      static_cast<__nv_bfloat16*>(out), H, W);
  return (int)cudaGetLastError();
}
