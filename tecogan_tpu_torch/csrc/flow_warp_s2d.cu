// The dense flow warp of TecoGAN as published, on the s2d carry, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package serves no learned flow.  It
// stands for the published inference's chain (github.com/thunil/TecoGAN,
// main.py and lib/ops.py): upscale_four(flow * 4), then
// tf.contrib.image.dense_image_warp of the previous 1080p output, then
// space_to_depth into the generator's 48 feedback channels.
//
// Contract (NHWC, contiguous):
//   flow  (B, H, W, 2)  f32: the LR flow in LR pixels, channel 0 rows,
//                       channel 1 columns
//   carry (B, H, W, 48) f32: the s2d SR frame,
//                       carry[b, i, j, c*16 + a*4 + bb] = y[b, 4i+a, 4j+bb, c]
//   out   (B, H, W, 48) bf16, the same channel order, holding
//     w(p) = bilinear(y, clamp(p - f(p))),  f = upscale_four(flow * 4)
// where upscale_four's pixel (4i + a, 4j + bb) is
//   tl * (1 - a/4) * (1 - bb/4) + tr * (1 - a/4) * (bb/4)
//     + bl * (a/4) * (1 - bb/4) + br * (a/4) * (bb/4)
// of flow * 4 at (i, j), (i, j+1), (i+1, j), (i+1, j+1), the last row and
// column repeated, and the sample is dense_image_warp's: per axis,
// fl = clamp(floor(q), 0, size - 2), alpha = clamp(q - fl, 0, 1), then
// top = ax * (tr - tl) + tl, bottom alike, out = ay * (bottom - top) + top.
// Every operation is rounded as the plain version's torch ops round it
// (no contraction into FMAs), so the kernel equals the plain version
// (ops/kernels/flow_warp_s2d.py) bit for bit.  The sample position is
// clamped into the frame; nothing reads outside it.
//
// What bounds it: at 1080p the kernel must read the 1.04 MB flow and the
// 24.88 MB carry and write the 12.44 MB feedback, 38.36 MB: 11.5 us at
// 3.35 TB/s.  The arithmetic (~80 f32 operations a HR pixel) is far below
// the CUDA cores' rate.  The carry fits in the 50 MB L2, so the
// data-dependent tap loads mostly hit it.
//
// Design: one thread per (LR pixel j, sub-row a): 4 HR pixels, which
// share the four flow values they upscale from (four 8-byte loads).  A
// block covers TJ = 32 LR pixels of one LR row (128 threads).  A pixel
// issues its 12 tap loads (4 taps x 3 channels) before using the first.
// The thread writes its 4 pixels x 3 channels as three 8-byte stores into
// slots c*16 + a*4 + [0..3]: the 4 threads of an LR pixel write its 96
// contiguous bytes.  No shared memory, no barrier.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int C = 3;             // colour channels
constexpr int S2D = 16 * C;      // s2d channels of one LR pixel
constexpr int TJ = 32;           // LR pixels per block
constexpr int THREADS = TJ * 4;  // one thread per (LR pixel, sub-row)

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// dense_image_warp's lerp, rounded as torch's separate ops round it
__device__ __forceinline__ float lerp_tf(float lo, float hi, float alpha) {
  return __fadd_rn(__fmul_rn(alpha, __fsub_rn(hi, lo)), lo);
}

// upscale_four's sum for one component: ((tl*ya*xa + tr*ya*xb) + bl*yb*xa) + br*yb*xb
__device__ __forceinline__ float up4(float tl, float tr, float bl, float br, float ya,
                                     float yb, float xa, float xb) {
  float s = __fadd_rn(__fmul_rn(__fmul_rn(tl, ya), xa), __fmul_rn(__fmul_rn(tr, ya), xb));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(bl, yb), xa));
  return __fadd_rn(s, __fmul_rn(__fmul_rn(br, yb), xb));
}

__global__ void __launch_bounds__(THREADS, 8)
dense_flow_warp_kernel(const float* __restrict__ flow, const float* __restrict__ carry,
                       __nv_bfloat16* __restrict__ out, int H, int W) {
  const int b = blockIdx.z;
  const int i = blockIdx.y;
  const int j = blockIdx.x * TJ + (threadIdx.x >> 2);
  const int a = threadIdx.x & 3;
  if (j >= W) return;
  const int H4 = 4 * H, W4 = 4 * W;

  // the four flow values of the upscale, times 4 (exact)
  const float2* fl = reinterpret_cast<const float2*>(flow) + (size_t)b * H * W;
  const int i1 = min(i + 1, H - 1), j1 = min(j + 1, W - 1);
  const float2 f_tl = __ldg(fl + (size_t)i * W + j), f_tr = __ldg(fl + (size_t)i * W + j1);
  const float2 f_bl = __ldg(fl + (size_t)i1 * W + j), f_br = __ldg(fl + (size_t)i1 * W + j1);
  const float ya = 1.f - 0.25f * a, yb = 0.25f * a;
  const float qrow = static_cast<float>(4 * i + a);

  const float* img = carry + (size_t)b * H * W * S2D;
  float res[C][4];
#pragma unroll
  for (int bb = 0; bb < 4; ++bb) {
    const float xa = 1.f - 0.25f * bb, xb = 0.25f * bb;
    const float fy = up4(4.f * f_tl.x, 4.f * f_tr.x, 4.f * f_bl.x, 4.f * f_br.x, ya, yb, xa, xb);
    const float fx = up4(4.f * f_tl.y, 4.f * f_tr.y, 4.f * f_bl.y, 4.f * f_br.y, ya, yb, xa, xb);
    const float qy = __fsub_rn(qrow, fy);
    const float qx = __fsub_rn(static_cast<float>(4 * j + bb), fx);
    const float y0 = fminf(fmaxf(floorf(qy), 0.f), static_cast<float>(H4 - 2));
    const float x0 = fminf(fmaxf(floorf(qx), 0.f), static_cast<float>(W4 - 2));
    const float ay = fminf(fmaxf(__fsub_rn(qy, y0), 0.f), 1.f);
    const float ax = fminf(fmaxf(__fsub_rn(qx, x0), 0.f), 1.f);
    const int iy = static_cast<int>(y0), ix = static_cast<int>(x0);
    int off[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int y = iy + (t >> 1), x = ix + (t & 1);
      off[t] = ((y >> 2) * W + (x >> 2)) * S2D + (y & 3) * 4 + (x & 3);
    }
    float tv[4][C];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int ch = 0; ch < C; ++ch) tv[t][ch] = __ldg(img + off[t] + ch * 16);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const float top = lerp_tf(tv[0][ch], tv[1][ch], ax);
      const float bottom = lerp_tf(tv[2][ch], tv[3][ch], ax);
      res[ch][bb] = lerp_tf(top, bottom, ay);
    }
  }

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
extern "C" int flow_warp_s2d_launch(const void* flow, const void* carry, void* out, int B,
                                    int H, int W, void* stream) {
  const dim3 grid((W + TJ - 1) / TJ, H, B);
  dense_flow_warp_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(flow), static_cast<const float*>(carry),
      static_cast<__nv_bfloat16*>(out), H, W);
  return (int)cudaGetLastError();
}
