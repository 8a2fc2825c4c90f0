// int8 (W8A8) convolutions of the generator tail, for Hopper (sm_90a):
// a 3x3 SAME conv and the 2x transposed conv, both implicit GEMMs on the
// tensor cores through wgmma.mma_async (s8 x s8 -> s32).
//
// Replaces the XLA convs of the JAX package's quantized tail
// (tecogan_tpu/engine/quant.py:152 and :157, conv_general_dilated with
// preferred_element_type=int32 in tail_features_int8), for which PyTorch
// has no CUDA op.  Each launch computes one whole JAX layer of that tail:
//
//   xq  = clamp(rint(float(x) * inv_s), -127, 127)            (s8)
//   acc = sum over taps and input channels of xq * wq           (s32, exact)
//   y   = T(float(acc) * deq[o] + bias[o])      (each op rounded on its own)
//   y   = relu(y)                 if relu
//   y   = T(float(y) + float(res))              if res
//
// with T the activation type, bf16 (the served route) or f32 (the fp32
// route, a precision reference; there the casts to T are exact).  That is
// what the plain version (ops/kernels/int8_conv.py) computes with
// torch's ops, so the two agree bit for bit.  An s32 sum is exact in any
// order, so only the epilogue's rounding sequence has to follow torch's.
//
// Contract (NHWC, contiguous):
//   x    (B, H, W, CIN) T, CIN in {64, 128}
//   wq   (COUT, 3, 3, CIN) s8: output channel o's taps (u, v) and input
//        channels, k = (3u + v) * CIN + ci contiguous; COUT in {64, 128}
//   inv_s (1,) f32 on the device; deq, bias (COUT,) f32 (bias may be null)
//   res  null or the output's shape, T
//   out  3x3: (B, H, W, COUT); up2x: (B, 2H, 2W, COUT), T
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
// 0.55 ms at the 1979 TOPS int8 peak).  The int8 operands never reach
// device memory: the input is quantized while it is staged into shared
// memory, and the epilogue applies the dequantization, bias, ReLU and
// residual before the one bf16 store.  Measured on an H100 80GB HBM3 at
// 700 W, each layer of that tail takes 32-57% of its bytes bound (the
// 270 x 480 layers the least: with 8-9 tiles a block, launch, the weight
// copy, which waits for the previous kernel's end, and pipeline fill weigh
// as much as their bytes); PERF.md section 6 has the times.
//
// Design.  One persistent block an SM (grid = min(tiles, SMs)) of three
// warpgroups.  A tile is TR = 2 rows by TW = 64 columns of pixels (output
// pixels for the 3x3 conv, input pixels for up2x), all COUT output
// channels: no block splits the channels, so each input pixel is read from
// device memory once a layer, plus its halo.  W need not be a multiple of
// 64: the last column of tiles is masked.  Tile ids run down each 64-column
// strip before the next, and each block takes a contiguous range of them,
// so a block's next tile is mostly the one below, which shares OV = 2
// staged rows (1 for up2x) with it: they are copied in shared memory, not
// loaded and quantized again.
//
// * Weights: every block copies wq into shared memory once (cp.async), in
//   the canonical K-major layout without swizzle that wgmma reads through
//   a matrix descriptor: 16-byte K chunks x COUT rows x 16 bytes, so a
//   core matrix (8 rows x 16 bytes) is 128 contiguous bytes; the stride
//   between core matrices is 128 bytes along N and COUT * 16 bytes along K.
// * The ring: NS stages of the quantized input tile with its halo
//   (IH x IW = 4 x 66 pixels for the 3x3 conv, 3 x 65 for up2x), laid out
//   as 16-byte K chunks x staged rows x staged columns, again without
//   swizzle.  The A operand of tap (u, v) for one 64-pixel row is then the
//   same descriptor with its start moved by ((row + u) * IW + v) * 16
//   bytes: 128 bytes between core matrices along M and LBO_A =
//   IH * IW * 16 (rounded up to 128, plus 16 or 32 bytes so that the
//   producer's 16-byte stores of a pixel's chunks hit distinct banks) along
//   K.  No im2col copy.  Pixels outside the image are quantized zeros.
// * Warpgroup 0 produces: row by row, it keeps the 16-byte loads of the
//   next DEPTH staged rows (bf16: 3 at CIN 64, 2 at 128; f32, twice the
//   bytes a row: 1) in flight while it quantizes a loaded row in registers
//   and stores its s8 chunks.  A tile's first row waits for its stage's
//   "empty" mbarrier; its last row fences the stage for the async proxy and
//   arrives on the stage's "full" mbarrier.  So staging overlaps the wgmmas.
// * Warpgroups 1 and 2 consume: warpgroup 1 + c takes the block's tiles
//   c, c + 2, ..., both rows of each: a row is one m64 chain of
//   wgmma.mma_async m64nCOUTk32 (9 taps x CIN / 32; up2x: one chain a
//   sub-pixel phase, of its own taps), then its epilogue.  The two
//   warpgroups work on different tiles, so one's epilogue runs while the
//   other's wgmmas do.  After a tile's last chain its stage is handed back
//   (one arrival a warp on "empty").
// * Epilogue: the accumulator fragment holds, a lane, two channels of each
//   8-channel block for two pixels.  The lane dequantizes, rounds to bf16
//   and applies the ReLU on its own values, then the 4 lanes of a quad
//   transpose their 4-byte pieces with shuffles, so that each lane holds 8
//   consecutive channels of one pixel: every store (and residual load) is
//   16 bytes, and a quad writes 64 contiguous bytes.  In f32 a lane stores
//   its own 8-byte pairs (a quad writes 32 contiguous bytes).  up2x's four
//   phases store to the pixels (2i + a, 2j + b) of their phase.
// * Programmatic dependent launch: only the mbarrier set-up runs while the
//   previous kernel of the stream finishes.  Every read of device memory
//   (weights, deq, bias, inv_s, x, the residual) and every write follows
//   griddepcontrol.wait, so the kernel just before may produce any input.
//   The consumers copy the weights while the producer stages the first
//   tile, which they wait for anyway.
//
// Shared memory (bytes), the same for both activation types: weights
// 9 * CIN * COUT, deq and bias 8 * COUT, NS stages of CIN / 16 * LBO_A,
// 2 * NS mbarriers.
//   3x3   CIN 64:  stage 17,024;  COUT 64: 4 stages, 105,536;  COUT 128: 4 stages, 142,912
//   3x3   CIN 128: stage 33,920;  COUT 64: 4 stages, 209,984;  COUT 128: 2 stages, 216,352
//   up2x  CIN 64:  stage 12,928;  COUT 64: 4 stages,  89,152;  COUT 128: 4 stages, 126,528
//   up2x  CIN 128: stage 25,728;  COUT 64: 4 stages, 177,216;  COUT 128: 3 stages, 225,712
// (the limit a block is 232,448).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TR = 2;            // rows of pixels a tile
constexpr int TW = 64;           // columns a tile: the m64 of wgmma
constexpr int THREADS = 384;     // warpgroup 0 produces, 1 and 2 consume
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_STAGES = 4;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

template <int CIN, int COUT, bool UP, int ESIZE>
struct Cfg {
  static constexpr int KC = CIN / 16;              // 16-byte K chunks a pixel
  static constexpr int K = 9 * CIN;                // GEMM depth
  static constexpr int HALO = UP ? 0 : 1;
  static constexpr int IH = UP ? TR + 1 : TR + 2;  // staged rows
  static constexpr int IW = UP ? TW + 1 : TW + 2;  // staged columns
  static constexpr int LBO_A = cdiv(IH * IW * 16, 128) * 128 + (KC == 4 ? 32 : 16);
  static constexpr int STAGE = KC * LBO_A;
  static constexpr int LBO_B = COUT * 16;
  static constexpr int W_BYTES = K * COUT;
  static constexpr int DEQ_OFF = W_BYTES;
  static constexpr int BIAS_OFF = W_BYTES + 4 * COUT;
  static constexpr int RING_OFF = W_BYTES + 8 * COUT;
  static constexpr int NS = cmin(MAX_STAGES, (SMEM_LIMIT - RING_OFF - 16 * MAX_STAGES) / STAGE);
  static constexpr int BAR_OFF = RING_OFF + NS * STAGE;
  static constexpr int SMEM = BAR_OFF + 16 * NS;
  static constexpr int OV = IH - TR;               // staged rows shared by two tiles
  static constexpr int ROW_ITEMS = IW * KC;        // 16-byte s8 chunks a staged row
  static constexpr int PER_ROW = cdiv(ROW_ITEMS, 128);  // a producer thread's
  static constexpr int VEC = ESIZE;                // 16-byte loads an item (16 channels)
  // staged rows loaded ahead: the loads in flight take at most 80 registers
  static constexpr int DEPTH = ESIZE == 4 ? 1 : KC == 4 ? 3 : 2;
  static_assert(NS >= 2, "the ring needs two stages");
  static_assert(RING_OFF % 128 == 0 && STAGE % 16 == 0, "16-byte aligned stages");
  static_assert(((LBO_A / 16) % 8 == 2 && KC == 4) || ((LBO_A / 16) % 8 == 1 && KC == 8),
                "conflict-free 16-byte stores of a pixel's chunks");
};

// ---- shared memory, barriers, wgmma ------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait of more
// than ~2^34 clocks (seconds) is a broken pipeline: trap rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// generic-proxy writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Matrix descriptor, no swizzle: start, leading (K) and stride (M or N)
// byte offsets between core matrices, each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

template <int N>
struct Wgmma;

// d (m64 x n64, s32) = A (m64 x k32, s8, K-major) * B (n64 x k32, s8, K-major)
// + (acc ? d : 0)
template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
};

// the same with n128
template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
};

// ---- arithmetic ---------------------------------------------------------------------

// clamp(rint(v * s), -127, 127) as s8 in the low byte: clamp the rounded
// product, then adding 1.5 * 2^23 rounds it half to even (as torch.round)
// to an integer held in the low mantissa bits, two's complement in its
// low byte.  Full-rate float operations only, no conversion instruction.
__device__ __forceinline__ uint32_t quant1(float v, float s) {
  const float t = fminf(fmaxf(__fmul_rn(v, s), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(t, 12582912.f));
}

// 4 values, in order -> 4 s8 in one word
__device__ __forceinline__ uint32_t quant4(float v0, float v1, float v2, float v3, float s) {
  const uint32_t lo = __byte_perm(quant1(v0, s), quant1(v1, s), 0x0040);
  const uint32_t hi = __byte_perm(quant1(v2, s), quant1(v3, s), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// One item, the 16 channels of a pixel that make a 16-byte K chunk: its
// VEC 16-byte loads (2 of bf16, 4 of f32) -> 16 s8, in order.
__device__ __forceinline__ uint4 quant16(const uint4 (&v)[2], float s) {
  uint32_t q[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const uint32_t a = (&v[h >> 1].x)[2 * (h & 1)], b = (&v[h >> 1].x)[2 * (h & 1) + 1];
    q[h] = quant4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
                  __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u), s);
  }
  return make_uint4(q[0], q[1], q[2], q[3]);
}

__device__ __forceinline__ uint4 quant16(const uint4 (&v)[4], float s) {
  uint32_t q[4];
#pragma unroll
  for (int h = 0; h < 4; ++h)
    q[h] = quant4(__uint_as_float(v[h].x), __uint_as_float(v[h].y),
                  __uint_as_float(v[h].z), __uint_as_float(v[h].w), s);
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// Two output values: float(acc) * deq, + bias, each rounded on its own,
// then one rounding to bf16 (as a bf16x2) and the ReLU on its halves:
// a signed 16-bit max with 0 keeps positive bf16 values and zeroes
// negative ones and -0.
__device__ __forceinline__ uint32_t dequant2(int a0, int a1, float2 dq, float2 bs,
                                             bool has_bias, bool relu) {
  float v0 = __fmul_rn(__int2float_rn(a0), dq.x), v1 = __fmul_rn(__int2float_rn(a1), dq.y);
  if (has_bias) {
    v0 = __fadd_rn(v0, bs.x);
    v1 = __fadd_rn(v1, bs.y);
  }
  const __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&y);
  return relu ? __vmaxs2(u, 0u) : u;
}

// The same in f32, where the cast to the activation type is exact: two
// values, each ReLU'd by fmaxf (the residual add follows in the epilogue).
__device__ __forceinline__ float2 dequant2_f32(int a0, int a1, float2 dq, float2 bs,
                                               bool has_bias, bool relu) {
  float v0 = __fmul_rn(__int2float_rn(a0), dq.x), v1 = __fmul_rn(__int2float_rn(a1), dq.y);
  if (has_bias) {
    v0 = __fadd_rn(v0, bs.x);
    v1 = __fadd_rn(v1, bs.y);
  }
  return relu ? make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f)) : make_float2(v0, v1);
}

__device__ __forceinline__ uint32_t pick(uint32_t v0, uint32_t v1, uint32_t v2, uint32_t v3,
                                         int i) {
  return i == 0 ? v0 : i == 1 ? v1 : i == 2 ? v2 : v3;
}

// Lane q of a quad holds v[k] = its 4-byte piece q of 8-channel block k
// (k = 0..3).  Returns the 4 pieces of block q: 16 bytes, channel order.
__device__ __forceinline__ uint4 quad_transpose(uint32_t v0, uint32_t v1, uint32_t v2,
                                                uint32_t v3, int lane) {
  const int q = lane & 3;
  uint32_t o[4];
  const uint32_t own = pick(v0, v1, v2, v3, q);
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = own;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const int src = (q - i) & 3;  // it sends its piece src of block q
    const uint32_t got = __shfl_sync(0xffffffffu, pick(v0, v1, v2, v3, (q + i) & 3),
                                     (lane & ~3) | src);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = k == src ? got : o[k];
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t y, uint32_t r) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  const __nv_bfloat162 s = __floats2bfloat162_rn(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  return *reinterpret_cast<const uint32_t*>(&s);
}

// ---- the kernel ---------------------------------------------------------------------

// T: the activation type of x, the residual and the output, bf16 or f32
template <typename T>
struct Args {
  const T* x;
  const int8_t* wq;
  const float* inv_s;
  const float* deq;
  const float* bias;
  const T* res;
  T* out;
  int B, H, W, relu;
};

// A tile: TR rows x TW columns of pixels of image b.  Tile ids run down
// each column strip (image b, columns x0..x0 + 63) before the next strip,
// and each block takes a contiguous range of them, so a block's next tile
// is usually the one below: it shares OV staged rows with it.  `fresh`:
// the block's first tile of a strip, which stages all IH rows.
struct Tile {
  int b, y0, x0;
  bool fresh;
};

__device__ __forceinline__ Tile decode(int tile, int tiles_h, int tiles_w, bool first) {
  const int per_image = tiles_h * tiles_w;
  const int rem = tile % per_image, rp = rem % tiles_h;
  return {tile / per_image, rp * TR, (rem / tiles_h) * TW, first || rp == 0};
}

// The producer's cursor over its row jobs: the i-th of the n staged rows
// that local tile k loads (all IH when fresh, else the TR below the
// shared ones).
struct RowJob {
  int k, i, n;
  Tile t;
};

template <int CIN, int COUT, bool UP, typename T>
struct Producer {
  using C = Cfg<CIN, COUT, UP, sizeof(T)>;
  using Item = uint4[C::VEC];  // an item's 16 channels, loaded
  const Args<T>& a;
  int first, nk, tiles_h, tiles_w, tid;

  __device__ __forceinline__ void start(RowJob& j, int k) const {
    j.k = k;
    j.i = 0;
    j.n = 0;
    j.t = Tile{0, 0, 0, true};
    if (k < nk) {
      j.t = decode(first + k, tiles_h, tiles_w, k == 0);
      j.n = j.t.fresh ? C::IH : TR;
    }
  }
  __device__ __forceinline__ void next(RowJob& j) const {
    if (++j.i == j.n) start(j, j.k + 1);
  }
  __device__ __forceinline__ static int row(const RowJob& j) {
    return j.t.fresh ? j.i : C::OV + j.i;
  }

  // issue the 16-byte loads of job j's row (zeros outside the image)
  __device__ __forceinline__ void load(const RowJob& j, Item (&buf)[C::PER_ROW]) const {
    const int gy = j.t.y0 - C::HALO + row(j);
    const bool row_in = j.k < nk && gy >= 0 && gy < a.H;
    const T* src_row = a.x + (static_cast<size_t>(j.t.b) * a.H + (row_in ? gy : 0)) * a.W * CIN;
#pragma unroll
    for (int e = 0; e < C::PER_ROW; ++e) {
      const int item = e * 128 + tid, px = item / C::KC, kc = item % C::KC;
      const int gx = j.t.x0 - C::HALO + px;
#pragma unroll
      for (int h = 0; h < C::VEC; ++h) buf[e][h] = make_uint4(0u, 0u, 0u, 0u);
      if (row_in && item < C::ROW_ITEMS && gx >= 0 && gx < a.W) {
        const uint4* src =
            reinterpret_cast<const uint4*>(src_row + static_cast<size_t>(gx) * CIN + kc * 16);
#pragma unroll
        for (int h = 0; h < C::VEC; ++h) buf[e][h] = __ldg(src + h);
      }
    }
  }

  // quantize the loaded row into staged row `rho` of the stage at `st`
  __device__ __forceinline__ void store(unsigned char* st, int rho, const Item (&buf)[C::PER_ROW],
                                        float inv_s) const {
#pragma unroll
    for (int e = 0; e < C::PER_ROW; ++e) {
      const int item = e * 128 + tid, px = item / C::KC, kc = item % C::KC;
      if (item < C::ROW_ITEMS)
        *reinterpret_cast<uint4*>(st + kc * C::LBO_A + (rho * C::IW + px) * 16) =
            quant16(buf[e], inv_s);
    }
  }

  // the previous tile's last OV staged rows are this tile's first OV
  __device__ __forceinline__ void copy_shared_rows(const unsigned char* prev,
                                                   unsigned char* st) const {
    constexpr int N = C::OV * C::IW;
    for (int i = tid; i < C::KC * N; i += 128) {
      const int kc = i / N, p = i % N;
      *reinterpret_cast<uint4*>(st + kc * C::LBO_A + p * 16) =
          *reinterpret_cast<const uint4*>(prev + kc * C::LBO_A + (TR * C::IW + p) * 16);
    }
  }
};

// Consumer epilogue of one m64 tile: acc holds, for this lane, pixels
// m0 = 16 warp + lane / 4 and m0 + 8, channels 8 j + 2 (lane % 4) + {0, 1}
// of every 8-channel block j.  `pix(m)` gives output pixel m's element
// offset, or -1 where it lies outside the output.  In f32 each lane
// stores its own 8-byte pairs: a quad writes 32 contiguous bytes a block.
template <int COUT, typename PixFn>
__device__ __forceinline__ void epilogue(const Args<float>& a, const int (&acc)[COUT / 2],
                                         const float* deq_s, const float* bias_s,
                                         int wtid, PixFn pix) {
  const int lane = wtid & 31, warp = wtid >> 5, q = lane & 3;
  const bool has_bias = a.bias != nullptr, relu = a.relu != 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long base = pix(16 * warp + (lane >> 2) + 8 * h);
    if (base < 0) continue;
#pragma unroll
    for (int j = 0; j < COUT / 8; ++j) {
      const int ch = 8 * j + 2 * q;
      const float2 dq = *reinterpret_cast<const float2*>(deq_s + ch);
      const float2 bs = *reinterpret_cast<const float2*>(bias_s + ch);
      float2 v = dequant2_f32(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], dq, bs, has_bias, relu);
      if (a.res != nullptr) {
        const float2 r = __ldg(reinterpret_cast<const float2*>(a.res + base + ch));
        v = make_float2(__fadd_rn(v.x, r.x), __fadd_rn(v.y, r.y));
      }
      *reinterpret_cast<float2*>(a.out + base + ch) = v;
    }
  }
}

// The bf16 epilogue: each lane rounds its own values, then the quad
// transposes them into 16-byte pieces.
template <int COUT, typename PixFn>
__device__ __forceinline__ void epilogue(const Args<__nv_bfloat16>& a,
                                         const int (&acc)[COUT / 2], const float* deq_s,
                                         const float* bias_s, int wtid, PixFn pix) {
  const int lane = wtid & 31, warp = wtid >> 5, q = lane & 3;
  const bool has_bias = a.bias != nullptr, relu = a.relu != 0;
  uint32_t pk[2][COUT / 8];
#pragma unroll
  for (int j = 0; j < COUT / 8; ++j) {
    const float2 dq = *reinterpret_cast<const float2*>(deq_s + 8 * j + 2 * q);
    const float2 bs = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pk[h][j] = dequant2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], dq, bs, has_bias, relu);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long base = pix(16 * warp + (lane >> 2) + 8 * h);
    uint4 v[COUT / 32], r[COUT / 32];
#pragma unroll
    for (int g = 0; g < COUT / 32; ++g)
      v[g] = quad_transpose(pk[h][4 * g], pk[h][4 * g + 1], pk[h][4 * g + 2],
                            pk[h][4 * g + 3], lane);
    if (base < 0) continue;
    if (a.res != nullptr) {
#pragma unroll
      for (int g = 0; g < COUT / 32; ++g)
        r[g] = __ldg(reinterpret_cast<const uint4*>(a.res + base + 8 * (4 * g + q)));
#pragma unroll
      for (int g = 0; g < COUT / 32; ++g)
        v[g] = make_uint4(add_bf16x2(v[g].x, r[g].x), add_bf16x2(v[g].y, r[g].y),
                          add_bf16x2(v[g].z, r[g].z), add_bf16x2(v[g].w, r[g].w));
    }
#pragma unroll
    for (int g = 0; g < COUT / 32; ++g)
      *reinterpret_cast<uint4*>(a.out + base + 8 * (4 * g + q)) = v[g];
  }
}

// up2x phase (pr, pc)'s first tap: (1, 1), (1, 0), (0, 1) or (0, 0)
__host__ __device__ constexpr int first_tap(int pr, int pc) {
  return 3 * (pr ? 0 : 1) + (pc ? 0 : 1);
}

template <int CIN, int COUT, bool UP, typename T>
__global__ void __launch_bounds__(THREADS, 1) int8_conv_kernel(const Args<T> a) {
  using C = Cfg<CIN, COUT, UP, sizeof(T)>;
  extern __shared__ __align__(1024) unsigned char smem[];
  float* deq_s = reinterpret_cast<float*>(smem + C::DEQ_OFF);
  float* bias_s = reinterpret_cast<float*>(smem + C::BIAS_OFF);
  const uint32_t w_addr = smem_addr(smem);
  const uint32_t bar_addr = w_addr + C::BAR_OFF;  // full[NS], then empty[NS]
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < C::NS; ++s) {
      mbar_init(bar_addr + 8 * s, 128);           // the producer's threads
      mbar_init(bar_addr + 8 * (C::NS + s), 4);   // the consuming warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // programmatic dependent launch: the set-up above ran beside the previous
  // kernel's tail; every read of device memory (the weights, deq, bias,
  // inv_s, x, res) and every write follows its end, so any of them may come
  // from the kernel just before on the stream
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // this block's tiles: a contiguous range of the tile ids
  const int tiles_w = cdiv(a.W, TW), tiles_h = cdiv(a.H, TR);
  const long long ntiles = static_cast<long long>(a.B) * tiles_h * tiles_w;
  const int first = static_cast<int>(ntiles * blockIdx.x / gridDim.x);
  const int nk = static_cast<int>(ntiles * (blockIdx.x + 1) / gridDim.x) - first;
  unsigned char* ring = smem + C::RING_OFF;
  const int wg = tid >> 7;

  if (wg == 0) {
    // ---- producer: the tiles' staged rows in order, DEPTH rows of loads
    // in flight ahead of the row being quantized
    const Producer<CIN, COUT, UP, T> P{a, first, nk, tiles_h, tiles_w, tid};
    const float inv_s = __ldg(a.inv_s);
    RowJob ld, sj;  // the next row to load, the next row to store
    P.start(ld, 0);
    P.start(sj, 0);
    typename Producer<CIN, COUT, UP, T>::Item buf[C::DEPTH][C::PER_ROW];
#pragma unroll
    for (int d = 0; d < C::DEPTH; ++d) {
      P.load(ld, buf[d]);
      P.next(ld);
    }
    while (sj.k < nk) {
#pragma unroll
      for (int d = 0; d < C::DEPTH; ++d) {
        if (sj.k < nk) {
          const int s = sj.k % C::NS;
          unsigned char* st = ring + s * C::STAGE;
          if (sj.i == 0) {  // the tile's first row: claim its stage
            mbar_wait(bar_addr + 8 * (C::NS + s), ((sj.k / C::NS) & 1) ^ 1);
            if (!sj.t.fresh) {
              asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the previous stage is written
              P.copy_shared_rows(ring + ((sj.k - 1) % C::NS) * C::STAGE, st);
            }
          }
          P.store(st, P.row(sj), buf[d], inv_s);
          if (sj.i + 1 == sj.n) {  // the tile is staged
            fence_async_shared();
            mbar_arrive(bar_addr + 8 * s);
          }
          P.next(sj);
          P.load(ld, buf[d]);
          P.next(ld);
        }
      }
    }
    return;
  }

  // ---- consumers.  First the weights, in the K-major core-matrix layout
  // (chunk kc of row n at (kc * COUT + n) * 16; neighbouring threads read
  // the two chunks of one 32-byte sector), deq and bias: their copy runs
  // while the producer stages the first tile
  constexpr int KCH = C::K / 16;
  for (int i = tid - 128; i < COUT * KCH; i += THREADS - 128) {
    const int kc = 2 * (i / (2 * COUT)) + (i & 1), n = (i >> 1) % COUT;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     w_addr + (kc * COUT + n) * 16),
                 "l"(a.wq + static_cast<size_t>(n) * C::K + kc * 16)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int i = tid - 128; i < COUT; i += THREADS - 128) {
    deq_s[i] = __ldg(a.deq + i);
    bias_s[i] = a.bias != nullptr ? __ldg(a.bias + i) : 0.f;
  }
  fence_async_shared();
  asm volatile("bar.sync 2, %0;\n" ::"n"(THREADS - 128) : "memory");

  // warpgroup 1 + c computes the tiles k = c, c + 2, ..., both rows of
  // each, so that one's epilogue overlaps the other's wgmmas
  const int c = wg - 1, wtid = tid & 127, lane = tid & 31;
  const int OH = UP ? 2 * a.H : a.H, OW = UP ? 2 * a.W : a.W;
  const uint64_t desc_a0 = make_desc(0, C::LBO_A, 128);
  const uint64_t desc_b0 = make_desc(w_addr, C::LBO_B, 128);
  for (int k = c; k < nk; k += 2) {
    const int s = k % C::NS;
    mbar_wait(bar_addr + 8 * s, (k / C::NS) & 1);
    const Tile t = decode(first + k, tiles_h, tiles_w, k == 0);
    const long long img = static_cast<long long>(t.b) * OH * OW;
#pragma unroll 1
    for (int r = 0; r < TR; ++r) {
      const uint32_t a_row = w_addr + C::RING_OFF + s * C::STAGE + r * C::IW * 16;
      const int y = t.y0 + r;
      const bool row_ok = y < a.H;
#pragma unroll
      for (int phase = 0; phase < (UP ? 4 : 1); ++phase) {
        const int pr = phase >> 1, pc = phase & 1;  // up2x: output row / column parity
        int acc[COUT / 2];  // the first wgmma writes it
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int u = tap / 3, v = tap % 3;
          int du = u, dv = v;
          if (UP) {  // the phase's own taps; u = 2 reads the next row (column)
            if (pr == 0 ? u != 1 : u == 1) continue;
            if (pc == 0 ? v != 1 : v == 1) continue;
            du = u == 2;
            dv = v == 2;
          }
          const uint32_t a_tap = a_row + (du * C::IW + dv) * 16;
#pragma unroll
          for (int kk = 0; kk < CIN / 32; ++kk) {
            const uint64_t da = desc_a0 | ((a_tap + 2 * kk * C::LBO_A) & 0x3FFFF) >> 4;
            const uint64_t db = desc_b0 + (((tap * C::KC + 2 * kk) * C::LBO_B) >> 4);
            Wgmma<COUT>::mma(acc, da, db, UP ? (tap != first_tap(pr, pc) || kk) : (tap || kk));
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        if (r == TR - 1 && phase == (UP ? 3 : 0)) {  // the stage is read: hand it back
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_addr + 8 * (C::NS + s));
        }
        epilogue<COUT>(a, acc, deq_s, bias_s, wtid, [&](int m) -> long long {
          const int x = t.x0 + m;
          if (!row_ok || x >= a.W) return -1;
          const int oy = UP ? 2 * y + pr : y, ox = UP ? 2 * x + pc : x;
          return (img + static_cast<long long>(oy) * OW + ox) * COUT;
        });
      }
    }
  }
}

template <int CIN, int COUT, bool UP, typename T>
int set_smem() {
  return static_cast<int>(cudaFuncSetAttribute(int8_conv_kernel<CIN, COUT, UP, T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Cfg<CIN, COUT, UP, sizeof(T)>::SMEM));
}

template <int CIN, int COUT, bool UP, typename T>
cudaError_t launch_one(const Args<T>& a, int grid, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Cfg<CIN, COUT, UP, sizeof(T)>::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_conv_kernel<CIN, COUT, UP, T>, a);
}

template <bool UP, typename T>
cudaError_t launch_typed(const void* x, const void* wq, const void* inv_s, const void* deq,
                         const void* bias, const void* res, void* out, int B, int H, int W,
                         int cin, int cout, int relu, int grid, cudaStream_t s) {
  const Args<T> a{static_cast<const T*>(x), static_cast<const int8_t*>(wq),
                  static_cast<const float*>(inv_s), static_cast<const float*>(deq),
                  static_cast<const float*>(bias), static_cast<const T*>(res),
                  static_cast<T*>(out), B, H, W, relu};
  if (cin == 64 && cout == 64) return launch_one<64, 64, UP>(a, grid, s);
  if (cin == 64) return launch_one<64, 128, UP>(a, grid, s);
  if (cout == 64) return launch_one<128, 64, UP>(a, grid, s);
  return launch_one<128, 128, UP>(a, grid, s);
}

template <bool UP>
int launch(const void* x, const void* wq, const void* inv_s, const void* deq,
           const void* bias, const void* res, void* out, int B, int H, int W, int cin,
           int cout, int relu, int f32, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long ntiles = static_cast<long long>(B) * cdiv(H, TR) * cdiv(W, TW);
  const int grid = static_cast<int>(ntiles < sms ? ntiles : sms);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      f32 ? launch_typed<UP, float>(x, wq, inv_s, deq, bias, res, out, B, H, W, cin, cout,
                                    relu, grid, s)
          : launch_typed<UP, __nv_bfloat16>(x, wq, inv_s, deq, bias, res, out, B, H, W, cin,
                                            cout, relu, grid, s);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <bool UP, typename T>
int set_smem_all() {
  int err = set_smem<64, 64, UP, T>();
  if (!err) err = set_smem<64, 128, UP, T>();
  if (!err) err = set_smem<128, 64, UP, T>();
  if (!err) err = set_smem<128, 128, UP, T>();
  return err;
}

}  // namespace

// Plain C entry points (loaded with ctypes), on the calling thread's
// current device.
//
// int8_conv_init: raise the kernels' dynamic shared memory limit; once per
// device, before the first launch.
extern "C" int int8_conv_init() {
  int err = set_smem_all<false, __nv_bfloat16>();
  if (!err) err = set_smem_all<true, __nv_bfloat16>();
  if (!err) err = set_smem_all<false, float>();
  if (!err) err = set_smem_all<true, float>();
  return err;
}

// int8_conv3x3_launch / int8_up2x_launch: launch on `stream` without
// synchronising; x, res and out are bf16, or f32 where `f32` is nonzero;
// `bias` and `res` may be null.  Return cudaGetLastError() (0 on success).
// The wrapper has checked shapes, types and alignment.
extern "C" int int8_conv3x3_launch(const void* x, const void* wq, const void* inv_s,
                                   const void* deq, const void* bias, const void* res,
                                   void* out, int B, int H, int W, int cin, int cout,
                                   int relu, int f32, void* stream) {
  return launch<false>(x, wq, inv_s, deq, bias, res, out, B, H, W, cin, cout, relu, f32,
                       stream);
}

extern "C" int int8_up2x_launch(const void* x, const void* wq, const void* inv_s,
                                const void* deq, const void* bias, const void* res,
                                void* out, int B, int H, int W, int cin, int cout,
                                int relu, int f32, void* stream) {
  return launch<true>(x, wq, inv_s, deq, bias, res, out, B, H, W, cin, cout, relu, f32,
                      stream);
}
