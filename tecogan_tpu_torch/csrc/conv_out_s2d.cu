// conv_out + bias + sigmoid + space-to-depth, fused, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels conv_out_s2d_pallas_paired and
// conv_out_s2d_pallas (tecogan_tpu/ops/pallas/conv_out_s2d.py), one kernel
// for both: masked row and column tails cover every B, H and W.
//
// Contract (NHWC):
//   feat  (B, 4H, 4W, 64) bf16, contiguous
//   w     (3, 3, 64, 3)   f32 HWIO, contiguous
//   bias  (3,)            f32
//   out   (B, H, W, 48)   bf16
//   out[b, i, j, c*16 + a*4 + bb] = sigmoid(bias[c] +
//       sum_{u,v,k} feat[b, 4i+a+u-1, 4j+bb+v-1, k] * w[u, v, k, c])
// with zero padding outside the image and f32 accumulation.  The
// 3-channel HR frame is never stored: each result goes straight to its
// space-to-depth slot.
//
// What bounds it: at 1080p the kernel must read 265 MB of bf16 features
// per frame (~80 us at 3.35 TB/s) and do 7.2 GFLOP.  With each feature
// read from device memory once it is bytes-bound on the tensor cores, but
// this first version runs the 3-wide dot products on the CUDA cores
// (~3.6 G f32 FMA per frame, about as long as the bytes take).
//
// Design: one block covers TR LR rows x TC LR columns.  It stages the
// (4*TR + 2) x (4*TC + 2) HR pixels it needs (1-pixel halos, zero-filled
// outside the image by cp.async's src-size operand) and the 6.9 KB of f32
// weights in shared memory.  Each thread owns one (LR row, LR column,
// sub-row a): 4 HR pixels x 3 channels, which it writes as three 8-byte
// stores into the s2d slots; the four threads of one LR pixel write its
// 96 bytes together.  Pixels are padded to 144 bytes and rows to 4 words
// past a multiple of 32 words, so the 16-byte feature reads of each
// quarter-warp (4 sub-rows x 2 columns) hit 32 distinct banks; the weight
// reads are warp-wide broadcasts.  Making it fast (TMA, wgmma with N=48)
// is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int K = 64;                    // feature channels
constexpr int C = 3;                     // output channels
constexpr int TR = 2;                    // LR rows per block
constexpr int TC = 16;                   // LR columns per block
constexpr int THREADS = TR * TC * 4;     // one thread per (row, col, a)
constexpr int SH = 4 * TR + 2;           // staged HR rows
constexpr int SW = 4 * TC + 2;           // staged HR columns
constexpr int CHUNKS = K / 8;            // 16-byte chunks per pixel
constexpr int PIX_WORDS = (K + 8) / 2;   // 144-byte padded pixel, in words
constexpr int ROW_WORDS = ((SW * PIX_WORDS + 27) / 32) * 32 + 4;  // = 4 mod 32
constexpr int W_FLOATS = 9 * K * C;
constexpr int W_BYTES = W_FLOATS * 4;
constexpr int SMEM_BYTES = W_BYTES + SH * ROW_WORDS * 4;

static_assert(W_BYTES % 16 == 0, "feature tile must stay 16-byte aligned");
static_assert(ROW_WORDS % 4 == 0 && ROW_WORDS >= SW * PIX_WORDS, "row pad");

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src,
                                           int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS)
conv_out_s2d_kernel(const __nv_bfloat16* __restrict__ feat,
                    const float* __restrict__ wgt,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);
  uint32_t* f_s = reinterpret_cast<uint32_t*>(smem + W_BYTES);

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TR;
  const int j0 = blockIdx.x * TC;
  const int H4 = 4 * H, W4 = 4 * W;
  const int y0 = 4 * i0 - 1, x0 = 4 * j0 - 1;  // HR origin of the tile
  const __nv_bfloat16* img = feat + (size_t)b * H4 * W4 * K;

  // Stage the HR tile: 8 consecutive threads copy one pixel's 128 bytes.
  for (int t = threadIdx.x; t < SH * SW * CHUNKS; t += THREADS) {
    const int q = t % CHUNKS;
    const int p = t / CHUNKS;
    const int c = p % SW;
    const int r = p / SW;
    const int y = y0 + r, x = x0 + c;
    const bool inside = y >= 0 && y < H4 && x >= 0 && x < W4;
    const __nv_bfloat16* src =
        inside ? img + ((size_t)y * W4 + x) * K + q * 8 : img;
    cp_async16(f_s + r * ROW_WORDS + c * PIX_WORDS + q * 4, src,
               inside ? 16 : 0);
  }
  for (int t = threadIdx.x; t < W_FLOATS / 4; t += THREADS) {
    reinterpret_cast<float4*>(w_s)[t] = reinterpret_cast<const float4*>(wgt)[t];
  }
  cp_async_wait_all();
  __syncthreads();

  const int a = threadIdx.x & 3;
  const int tj = (threadIdx.x >> 2) % TC;
  const int ti = (threadIdx.x >> 2) / TC;

  float acc[4][C];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[p][c] = 0.f;

#pragma unroll
  for (int u = 0; u < 3; ++u) {
    // staged row of HR row 4i+a+u-1; columns 4j-1 .. 4j+4 are 4tj .. 4tj+5
    const uint32_t* rowp = f_s + (4 * ti + a + u) * ROW_WORDS + 4 * tj * PIX_WORDS;
#pragma unroll 1
    for (int q = 0; q < CHUNKS; ++q) {
      float f[6][8];
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        const uint4 v4 =
            *reinterpret_cast<const uint4*>(rowp + m * PIX_WORDS + q * 4);
        const uint32_t wd[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f[m][2 * e] = __uint_as_float(wd[e] << 16);
          f[m][2 * e + 1] = __uint_as_float(wd[e] & 0xffff0000u);
        }
      }
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const float4* wp =
            reinterpret_cast<const float4*>(w_s + ((u * 3 + v) * K + q * 8) * C);
        float w[8 * C];
#pragma unroll
        for (int e = 0; e < 2 * C; ++e) {
          const float4 t4 = wp[e];
          w[4 * e] = t4.x;
          w[4 * e + 1] = t4.y;
          w[4 * e + 2] = t4.z;
          w[4 * e + 3] = t4.w;
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int k = 0; k < 8; ++k)
#pragma unroll
            for (int c = 0; c < C; ++c)
              acc[p][c] = fmaf(f[p + v][k], w[k * C + c], acc[p][c]);
      }
    }
  }

  const int i = i0 + ti, j = j0 + tj;
  if (i < H && j < W) {
    __nv_bfloat16* o = out + (((size_t)b * H + i) * W + j) * (16 * C) + a * 4;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float bc = bias[c];
      float s[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) s[p] = 1.f / (1.f + __expf(-(acc[p][c] + bc)));
      uint2 pk;
      pk.x = pack_bf16x2(s[0], s[1]);
      pk.y = pack_bf16x2(s[2], s[3]);
      *reinterpret_cast<uint2*>(o + c * 16) = pk;
    }
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes), both on the calling thread's
// current device.
//
// conv_out_s2d_init: raise the kernel's dynamic shared memory limit to
// what it needs; once per device, before its first launch.
extern "C" int conv_out_s2d_init() {
  return (int)cudaFuncSetAttribute(conv_out_s2d_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_BYTES);
}

// conv_out_s2d_launch: launch on `stream` without synchronising; returns
// cudaGetLastError() (0 on success).
extern "C" int conv_out_s2d_launch(const void* feat, const void* weight,
                                   const void* bias, void* out, int B, int H,
                                   int W, void* stream) {
  const dim3 grid((W + TC - 1) / TC, (H + TR - 1) / TR, B);
  conv_out_s2d_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(feat), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W);
  return (int)cudaGetLastError();
}
