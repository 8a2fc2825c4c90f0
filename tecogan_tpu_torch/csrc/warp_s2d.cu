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
// Design: one thread per HR output pixel, one block per 16 LR pixels of
// one LR row (256 threads).  A thread computes its two grid values from
// the four LR taps of each upsampled element (no grid tensor), samples
// the four carry taps it needs -- loading only those inside the frame --
// and writes its 3 results into the block's staged 96-byte LR records in
// shared memory.  The block's records are one contiguous run of the
// output, stored with 16-byte writes.  Simple first: no TMA, no wgmma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int C = 3;               // colour channels
constexpr int S2D = 16 * C;        // s2d channels of one LR pixel
constexpr int TJ = 16;             // LR pixels per block
constexpr int THREADS = TJ * 16;   // one thread per HR pixel
constexpr int CHUNKS = S2D * 2 / 16;  // 16-byte pieces of one LR record

static_assert(S2D * 2 % 16 == 0, "LR records must be whole 16-byte pieces");

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

__global__ void __launch_bounds__(THREADS)
warp_s2d_kernel(const __nv_bfloat16* __restrict__ carry,
                const float* __restrict__ prev_lr,
                __nv_bfloat16* __restrict__ out, int H, int W) {
  __shared__ __align__(16) __nv_bfloat16 rec[TJ * S2D];

  const int b = blockIdx.z;
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * TJ;
  const int jj = threadIdx.x >> 4;
  const int sub = threadIdx.x & 15;  // a*4 + bb
  const int j = j0 + jj;
  const int H4 = 4 * H, W4 = 4 * W;

  if (j < W) {
    const int r = 4 * i + (sub >> 2);
    const int c = 4 * j + (sub & 3);
    // The raw view: grid[r, c, k] is flat element 2*(r*W4 + c) + k of the
    // (2, H4, W4) planes.  Rows r < 2H read plane 0 (R), later rows plane
    // 1 (G); both k land in one plane row, at columns xx and xx + 1.
    const int plane = r >= 2 * H ? 1 : 0;
    const int rr = r - plane * 2 * H;
    const int over = 2 * c >= W4 ? 1 : 0;
    const int yy = 2 * rr + over;
    const int xx = 2 * c - over * W4;

    int y0, y1, x0, x1, u0, u1;
    float ly, lx, lu;
    source_taps(yy, H, y0, y1, ly);
    source_taps(xx, W, x0, x1, lx);
    source_taps(xx + 1, W, u0, u1, lu);
    const float* lr = prev_lr + (size_t)b * H * W * C + plane;
    const float* row0 = lr + (size_t)y0 * W * C;
    const float* row1 = lr + (size_t)y1 * W * C;
    const float ly0 = 1.f - ly;
    const float lx0 = 1.f - lx, lu0 = 1.f - lu;
    const float up_x = ly0 * (lx0 * row0[x0 * C] + lx * row0[x1 * C]) +
                       ly * (lx0 * row1[x0 * C] + lx * row1[x1 * C]);
    const float up_y = ly0 * (lu0 * row0[u0 * C] + lu * row0[u1 * C]) +
                       ly * (lu0 * row1[u0 * C] + lu * row1[u1 * C]);
    // grid = upsample(prev_lr * 4); unnormalize as grid_sample does
    const float ix = ((4.f * up_x + 1.f) * W4 - 1.f) * 0.5f;
    const float iy = ((4.f * up_y + 1.f) * H4 - 1.f) * 0.5f;

    const float fx = floorf(ix), fy = floorf(iy);
    const float wx = ix - fx, wy = iy - fy;
    const __nv_bfloat16* img = carry + (size_t)b * H * W * S2D;
    float acc[C] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float ty = fy + dy;
      if (!(ty >= 0.f && ty <= static_cast<float>(H4 - 1))) continue;
      const int y = static_cast<int>(ty);
      const float wrow = dy ? wy : 1.f - wy;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float tx = fx + dx;
        if (!(tx >= 0.f && tx <= static_cast<float>(W4 - 1))) continue;
        const int x = static_cast<int>(tx);
        const float w = wrow * (dx ? wx : 1.f - wx);
        const __nv_bfloat16* p =
            img + ((size_t)(y >> 2) * W + (x >> 2)) * S2D + (y & 3) * 4 + (x & 3);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          const float q = fminf(fmaxf(rintf(__bfloat162float(p[ch * 16]) * 255.f),
                                      0.f), 255.f);
          acc[ch] = fmaf(w, q, acc[ch]);
        }
      }
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      // deprocess: (v + 1) / 2, rounded once to bf16
      rec[jj * S2D + ch * 16 + sub] =
          __float2bfloat16_rn((acc[ch] * (1.f / 255.f) + 1.f) * 0.5f);
    }
  }
  __syncthreads();

  const int n = min(TJ, W - j0) * CHUNKS;
  uint4* dst = reinterpret_cast<uint4*>(out + (((size_t)b * H + i) * W + j0) * S2D);
  const uint4* src = reinterpret_cast<const uint4*>(rec);
  for (int t = threadIdx.x; t < n; t += THREADS) dst[t] = src[t];
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
