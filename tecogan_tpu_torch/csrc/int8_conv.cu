// int8 (W8A8) convolutions of the generator tail, for Hopper (sm_90a):
// a 3x3 SAME conv and the 2x transposed conv, both implicit GEMMs on the
// tensor cores (mma.sync m16n8k32, s8 x s8 -> s32).
//
// Replaces the XLA convs of the JAX package's quantized tail
// (tecogan_tpu/engine/quant.py::tail_features_int8, conv_general_dilated
// with preferred_element_type=int32), for which PyTorch has no CUDA op.
// Each launch computes one whole JAX layer of that tail:
//
//   xq  = clamp(rint(float(x) * inv_s), -127, 127)            (s8)
//   acc = sum over taps and input channels of xq * wq           (s32, exact)
//   y   = bf16(float(acc) * deq[o] + bias[o])   (each op rounded on its own)
//   y   = relu(y)                 if relu
//   y   = bf16(float(y) + float(res))           if res
//
// which is what the plain version (ops/kernels/int8_conv.py) computes with
// torch's ops, so the two agree bit for bit.
//
// Contract (NHWC, contiguous):
//   x    (B, H, W, CIN) bf16, CIN in {64, 128}
//   wq   (COUT, 3, 3, CIN) s8: output channel o's taps (u, v) and input
//        channels, k = (3u + v) * CIN + ci contiguous; COUT in {64, 128}
//   inv_s (1,) f32 on the device; deq, bias (COUT,) f32 (bias may be null)
//   res  null or (B, H, W, COUT) bf16 (3x3 only in the tail, either kind here)
//   out  3x3: (B, H, W, COUT); up2x: (B, 2H, 2W, COUT), bf16
//
// int8_conv3x3: out[y, x] = sum_{u,v} xq[y + u - 1, x + v - 1] . wq[u, v],
// zero outside the image.  int8_up2x: JAX's lhs-dilated conv (dilation 2,
// padding (1, 2) on both axes) on the forward kernel wq, which equals
// ConvTranspose2d(k3, s2, p1, output_padding=1) on the flipped kernel.  An
// output pixel (2i + a, 2j + b) only meets input pixels: row tap u = 1 on
// input row i when a = 0; u = 0 on row i and u = 2 on row i + 1 when a = 1
// (the same for columns and v).  So the kernel runs it as 4 sub-pixel
// phases of 1, 2, 2 and 4 taps: 9 taps an input pixel, and the zeros that
// the dilation inserts are never multiplied.
//
// What bounds it: bytes.  A layer reads its bf16 input once, writes its
// bf16 output (and reads the residual); at 270p -> 1080p a frame's 39
// launches move ~3.6 GB against 0.54 TMAC (1.08 ms at 3.35 TB/s against
// 0.55 ms at the 1979 TOPS int8 peak).  The design keeps the int8 operands
// out of device memory: the input is quantized while it is staged into
// shared memory (2 bytes read a value, no int8 copy written and read back),
// the epilogue applies the dequantization, bias, ReLU and residual before
// the one bf16 store.
//
// Tiling: a block of 8 warps owns NB = 64 output channels (blockIdx.y picks
// which) and holds their weights in shared memory for its life (rows padded
// to an odd number of 16-byte pieces, so ldmatrix phases hit distinct
// banks).  It walks over pixel tiles of TH x TW = 8 x 16 (output pixels;
// input pixels for up2x), persistent, 2 blocks an SM.  Per tile it stages
// the quantized input tile with its halo (10 x 18, or 9 x 17 for up2x),
// then each warp computes 2 rows of 16 pixels (two m16 tiles) by 32
// channels (four n8 tiles): per (tap, 32 channels) two ldmatrix.x4 for A,
// two for B, eight MMAs.  No cp.async ring, no TMA, no wgmma: a simple
// kernel first; its time against its bound is in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NB = 64;           // output channels a block
constexpr int TH = 8, TW = 16;   // pixel tile: 8 rows of one m16 tile each
constexpr int THREADS = 256;     // 8 warps: 4 (pixel rows) x 2 (channels)

template <int CIN, bool UP>
struct Cfg {
  static constexpr int K = 9 * CIN;          // GEMM depth
  static constexpr int WROW = K + 16;        // bytes a weight row in shared memory
  static constexpr int IH = UP ? TH + 1 : TH + 2;  // staged input rows
  static constexpr int IW = UP ? TW + 1 : TW + 2;  // staged input columns
  static constexpr int PIX = CIN + 16;       // bytes a staged pixel
  static constexpr int W_BYTES = NB * WROW;
  static constexpr int SMEM = W_BYTES + IH * IW * PIX;
  static_assert((WROW / 16) % 2 == 1 && (PIX / 16) % 2 == 1,
                "odd 16-byte strides: conflict-free ldmatrix");
  static_assert(K % 16 == 0 && W_BYTES % 16 == 0, "16-byte pieces");
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// d += a * b: m16n8k32, s8 in, s32 accumulate (exact)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// clamp(rint(v * s), -127, 127): rint rounds half to even, as torch.round
__device__ __forceinline__ uint32_t quant1(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(v, s)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
}

__device__ __forceinline__ uint32_t quant4(uint32_t lo, uint32_t hi, float s) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return quant1(a.x, s) | quant1(a.y, s) << 8 | quant1(b.x, s) << 16 | quant1(b.y, s) << 24;
}

// One output value: float(acc) * deq, + bias, to bf16, ReLU; the residual
// is added by the caller.  Every operation rounds on its own.
__device__ __forceinline__ float dequant(int acc, float dq, float bs, bool has_bias,
                                         bool relu) {
  float v = __fmul_rn(__int2float_rn(acc), dq);
  if (has_bias) v = __fadd_rn(v, bs);
  v = __bfloat162float(__float2bfloat16_rn(v));
  return relu && !(v > 0.f) ? 0.f : v;
}

template <int CIN, bool UP>
__global__ void __launch_bounds__(THREADS, 2)
int8_conv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ inv_s_p, const float* __restrict__ deq,
                 const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
                 __nv_bfloat16* __restrict__ out, int B, int H, int W, int cout,
                 int relu) {
  using C = Cfg<CIN, UP>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* xs = smem + C::W_BYTES;
  const uint32_t ws_a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t xs_a = ws_a + C::W_BYTES;
  const int n0 = blockIdx.y * NB;

  // this block's NB weight rows, once
  constexpr int WCH = C::K / 16;
  for (int i = threadIdx.x; i < NB * WCH; i += THREADS) {
    const int n = i / WCH, c = i % WCH;
    *reinterpret_cast<uint4*>(smem + n * C::WROW + c * 16) =
        __ldg(reinterpret_cast<const uint4*>(wq + (size_t)(n0 + n) * C::K) + c);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // pixel rows 2wm, 2wm + 1; channels 32wn..
  const int g = lane >> 2, tq = lane & 3;
  const float inv_s = __ldg(inv_s_p);
  const bool has_bias = bias != nullptr;
  float dq[4][2], bs[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 32 * wn + 8 * nt + 2 * tq + h;
      dq[nt][h] = __ldg(deq + n);
      bs[nt][h] = has_bias ? __ldg(bias + n) : 0.f;
    }
  // ldmatrix rows of this lane: A, pixel column lane & 15 at k byte
  // 16 * (lane >> 4); B, channel 8 * ((lane >> 4) & 1) + (lane & 7) at k
  // byte 16 * ((lane >> 3) & 1), so that the four matrices are (n 0-7,
  // k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31).
  const uint32_t a_lane = xs_a + (lane & 15) * C::PIX + (lane >> 4) * 16;
  const uint32_t b_lane = ws_a + (32 * wn + ((lane >> 4) & 1) * 8 + (lane & 7)) * C::WROW +
                          ((lane >> 3) & 1) * 16;

  const int OH = UP ? 2 * H : H, OW = UP ? 2 * W : W;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int ntiles = B * tiles_h * tiles_w;
  constexpr int XCH = CIN / 8;  // 16-byte bf16 pieces a pixel
  constexpr int HALO = UP ? 0 : 1;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (tiles_h * tiles_w);
    const int rem = tile % (tiles_h * tiles_w);
    const int y0 = (rem / tiles_w) * TH, x0 = (rem % tiles_w) * TW;
    const __nv_bfloat16* img = x + (size_t)b * H * W * CIN;

    __syncthreads();  // the previous tile's reads of xs are done
    for (int i = threadIdx.x; i < C::IH * C::IW * XCH; i += THREADS) {
      const int p = i / XCH, c = i % XCH;
      const int gy = y0 - HALO + p / C::IW, gx = x0 - HALO + p % C::IW;
      uint2 q = make_uint2(0u, 0u);  // SAME padding: quantized zeros
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(img + ((size_t)gy * W + gx) * CIN) + c);
        q = make_uint2(quant4(v.x, v.y, inv_s), quant4(v.z, v.w, inv_s));
      }
      *reinterpret_cast<uint2*>(xs + p * C::PIX + c * 8) = q;
    }
    __syncthreads();

#pragma unroll 1
    for (int phase = 0; phase < (UP ? 4 : 1); ++phase) {
      const int pr = phase >> 1, pc = phase & 1;  // up2x: output row / column parity
      int acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

      // taps: 3x3 all nine, (u, v) read at staged offset (u, v); up2x the
      // phase's own, tap u at offset 0 (u = 0, 1) or 1 (u = 2)
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int u = tap / 3, v = tap % 3;
        int du = u, dv = v;
        if (UP) {
          if (pr == 0 ? u != 1 : u == 1) continue;
          if (pc == 0 ? v != 1 : v == 1) continue;
          du = u == 2;
          dv = v == 2;
        }
        const uint32_t a_tap = a_lane + ((2 * wm + du) * C::IW + dv) * C::PIX;
        const uint32_t b_tap = b_lane + tap * CIN;
#pragma unroll
        for (int kc = 0; kc < CIN / 32; ++kc) {
          uint32_t a0[4], a1[4], b01[4], b23[4];
          ldmatrix_x4(a_tap + kc * 32, a0);
          ldmatrix_x4(a_tap + C::IW * C::PIX + kc * 32, a1);
          ldmatrix_x4(b_tap + kc * 32, b01);
          ldmatrix_x4(b_tap + 16 * C::WROW + kc * 32, b23);
          mma_s8(acc[0][0], a0, b01[0], b01[1]);
          mma_s8(acc[0][1], a0, b01[2], b01[3]);
          mma_s8(acc[0][2], a0, b23[0], b23[1]);
          mma_s8(acc[0][3], a0, b23[2], b23[3]);
          mma_s8(acc[1][0], a1, b01[0], b01[1]);
          mma_s8(acc[1][1], a1, b01[2], b01[3]);
          mma_s8(acc[1][2], a1, b23[0], b23[1]);
          mma_s8(acc[1][3], a1, b23[2], b23[3]);
        }
      }

      // epilogue: lane holds pixel columns g, g + 8 of rows 2wm + mt,
      // channels 2tq, 2tq + 1 of each n8 tile
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int py = y0 + 2 * wm + mt, px = x0 + g + 8 * hh;
          if (py >= H || px >= W) continue;
          const int oy = UP ? 2 * py + pr : py, ox = UP ? 2 * px + pc : px;
          const size_t base = (((size_t)b * OH + oy) * OW + ox) * cout + n0 + 32 * wn + 2 * tq;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float v0 = dequant(acc[mt][nt][2 * hh], dq[nt][0], bs[nt][0], has_bias, relu);
            float v1 = dequant(acc[mt][nt][2 * hh + 1], dq[nt][1], bs[nt][1], has_bias, relu);
            if (res != nullptr) {
              const float2 r = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(res + base + 8 * nt));
              v0 = __fadd_rn(v0, r.x);
              v1 = __fadd_rn(v1, r.y);
            }
            *reinterpret_cast<__nv_bfloat162*>(out + base + 8 * nt) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
    }
  }
}

template <int CIN, bool UP>
int set_smem() {
  return (int)cudaFuncSetAttribute(int8_conv_kernel<CIN, UP>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Cfg<CIN, UP>::SMEM);
}

template <bool UP>
int launch(const void* x, const void* wq, const void* inv_s, const void* deq,
           const void* bias, const void* res, void* out, int B, int H, int W, int cin,
           int cout, int relu, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int groups = cout / NB;
  const long ntiles = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int per_group = (int)(ntiles < 2L * sms / groups ? ntiles : 2L * sms / groups);
  const dim3 grid(per_group > 0 ? per_group : 1, groups);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int8_t*>(wq);
  const auto* sp = static_cast<const float*>(inv_s);
  const auto* dp = static_cast<const float*>(deq);
  const auto* bp = static_cast<const float*>(bias);
  const auto* rp = static_cast<const __nv_bfloat16*>(res);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  if (cin == 64)
    int8_conv_kernel<64, UP><<<grid, THREADS, Cfg<64, UP>::SMEM, s>>>(
        xp, wp, sp, dp, bp, rp, op, B, H, W, cout, relu);
  else
    int8_conv_kernel<128, UP><<<grid, THREADS, Cfg<128, UP>::SMEM, s>>>(
        xp, wp, sp, dp, bp, rp, op, B, H, W, cout, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes), on the calling thread's
// current device.
//
// int8_conv_init: raise the kernels' dynamic shared memory limit; once per
// device, before the first launch.
extern "C" int int8_conv_init() {
  int err = set_smem<64, false>();
  if (!err) err = set_smem<128, false>();
  if (!err) err = set_smem<64, true>();
  if (!err) err = set_smem<128, true>();
  return err;
}

// int8_conv3x3_launch / int8_up2x_launch: launch on `stream` without
// synchronising; `bias` and `res` may be null.  Return cudaGetLastError()
// (0 on success).  The wrapper has checked shapes, types and alignment.
extern "C" int int8_conv3x3_launch(const void* x, const void* wq, const void* inv_s,
                                   const void* deq, const void* bias, const void* res,
                                   void* out, int B, int H, int W, int cin, int cout,
                                   int relu, void* stream) {
  return launch<false>(x, wq, inv_s, deq, bias, res, out, B, H, W, cin, cout, relu, stream);
}

extern "C" int int8_up2x_launch(const void* x, const void* wq, const void* inv_s,
                                const void* deq, const void* bias, const void* res,
                                void* out, int B, int H, int W, int cin, int cout,
                                int relu, void* stream) {
  return launch<true>(x, wq, inv_s, deq, bias, res, out, B, H, W, cin, cout, relu, stream);
}
