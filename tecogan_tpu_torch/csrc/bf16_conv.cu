// bf16 convolutions of the generator tail, for Hopper (sm_90a): a 3x3 SAME
// conv and the 2x transposed conv, both implicit GEMMs on the tensor cores
// through wgmma.mma_async (bf16 x bf16 -> f32), with the bias, ReLU and
// residual add in the epilogue.
//
// Replaces no Pallas kernel.  The JAX package leaves the tail's convs to
// XLA (tecogan_tpu/models/generator.py, Generator.tail_features: the
// resblocks' convs, up1, trunk_rb1, trunk_rb2, up2 and conv_hr, each with
// its bias, ReLU and skip add as XLA ops).  Eager PyTorch runs each such
// layer as cuDNN's conv plus one to three elementwise kernels (the bias
// add, the ReLU clamp, the skip add), each a pass over the tensor the conv
// has just written.  Each launch here computes one whole layer, as torch's
// chain of ops does:
//
//   y = bf16(sum over taps and input channels of x * w)   (f32 accumulation)
//   y = bf16(float(y) + float(bias[o]))     if bias (bias held in bf16)
//   y = relu(y)                             if relu
//   y = bf16(float(y) + float(res))         if res
//
// so it differs from cuDNN's conv + torch's adds only in the order of the
// f32 sum.  The plain version (ops/kernels/bf16_conv.py) is that chain of
// torch ops.
//
// Contract (NHWC, contiguous, bf16):
//   x    (B, H, W, CIN), CIN in {64, 128}
//   w    (COUT, 3, 3, CIN): output channel o's taps (u, v) and input
//        channels, k = (3u + v) * CIN + ci contiguous; COUT in {64, 128}
//   bias null or (COUT,);  res null or the output's shape
//   out  3x3: (B, H, W, COUT); up2x: (B, 2H, 2W, COUT)
//
// bf16_conv3x3: out[y, x] = sum_{u,v} x[y + u - 1, x + v - 1] . w[u, v], zero
// outside the image.  bf16_up2x: JAX's lhs-dilated conv (dilation 2, padding
// (1, 2) on both axes) on the forward kernel w, which equals
// ConvTranspose2d(k3, s2, p1, output_padding=1) on the flipped kernel.  An
// output pixel (2i + a, 2j + b) only meets input pixels: row tap u = 1 on
// input row i when a = 0; u = 0 on row i and u = 2 on row i + 1 when a = 1
// (the same for columns and v).  So it runs as 4 sub-pixel phases of 1, 2,
// 2 and 4 taps: the zeros that the dilation inserts are never multiplied.
//
// What bounds it: bytes and bf16 MMA, about equally.  At 270p -> 1080p a
// frame's 39 launches (32 resblock convs, up1, trunk_rb1 x 2, trunk_rb2 x 2,
// up2, conv_hr) read and write ~3.6 GB of bf16 activations (1.08 ms at
// 3.35 TB/s) and make 1.08 TFLOP (1.09 ms at the 989 TFLOP/s dense bf16
// peak); conv_hr alone is 0.31 ms of the MMA bound.  On an H100 at 700 W
// the 39 launches take ~3.1 ms, 40% of their bound; PERF.md section 6 has
// each layer's time.
//
// Design (int8_conv.cu's, with bf16 operands staged as they are).  A
// block holds the weights of NB = 64 output channels in shared memory for
// the whole launch; a COUT = 128 layer runs as two blocks a tile, block
// 2g + h computing channels 64h..64h + 63 of group g's tiles, both walking
// the same tiles at the same pace, so the second read of each input tile
// is served by L2.  Persistent blocks, one an SM (COUT / 64 times min(tiles,
// SMs * 64 / COUT) of them), of three warpgroups.
//
// * Tiles: TR rows by TW = 64 columns of pixels (output pixels for the 3x3
//   conv, input pixels for up2x), the block's 64 output channels.  W need
//   not be a multiple of 64: the last column of tiles is masked.  Tile ids
//   run down each 64-column strip before the next, each group of blocks
//   takes a contiguous range of them, so a block's next tile is mostly the
//   one below, whose halo rows L2 still holds.
// * Weights: every block copies its 64 rows of w into shared memory once
//   (cp.async), in the canonical K-major layout without swizzle that wgmma
//   reads through a matrix descriptor: 16-byte K chunks (8 channels) x 64
//   rows x 16 bytes, so a core matrix (8 rows x 16 bytes) is 128 contiguous
//   bytes; the stride between core matrices is 128 bytes along N and
//   64 * 16 bytes along K.  Their copy runs while the producer stages the
//   first tile, which the consumers wait for anyway.
// * The ring: NS stages, each one K slice (SC input channels) of one
//   tile's input with its halo (IH x IW pixels: 4 x 66 for the 3x3 conv,
//   3 x 65 for up2x at TR = 2), laid out as 16-byte K chunks x staged rows
//   x staged columns.  The A operand of tap (u, v) for one 64-pixel row is
//   then the same descriptor with its start moved by ((row + u) * IW + v)
//   * 16 bytes: 128 bytes between core matrices along M and LBO_A = IH * IW
//   * 16 rounded up to 128 along K.  No im2col copy.
// * One thread of warpgroup 0 produces: for each stage in turn it waits
//   for the stage's "empty" mbarrier, then issues SC / 8 TMA tile loads
//   (cp.async.bulk.tensor) of x seen as a 4-D tensor (channel, column, row,
//   image), a box of one 16-byte channel chunk over the IH x IW pixels
//   each, completing on the stage's "full" mbarrier with their bytes.
//   Coordinates outside the image read zeros: the SAME padding and the
//   masked edges.  The loads of up to NS stages are in flight.  (Issued as
//   16-byte cp.async by the producer's 128 threads instead, the same
//   stages held the Cin-128 layers to ~420 TFLOP/s: conv_hr took 0.80 ms
//   against 0.64 with TMA.)
// * Warpgroups 1 and 2 consume: warpgroup 1 + c takes the block's tiles c,
//   c + 2, ....  A row is one m64 chain of wgmma.mma_async m64n64k16 (9
//   taps x SC / 16 a slice; up2x: one chain a sub-pixel phase, of its own
//   taps), then its epilogue.  The two warpgroups work on different tiles,
//   so one's epilogue runs while the other's wgmmas do.  (A probe of bare
//   n64 chains from shared memory reaches 970 TFLOP/s on an H100 at 700 W,
//   and issuing the next chain before an epilogue gained 0.5%: the loads
//   against the ring's depth, not the instruction, hold these kernels.)
//   A stage goes back to the producer (one arrival a warp on "empty") as
//   soon as the wgmmas that read it have completed.  Where a tile takes
//   two slices (the 3x3 conv at CIN 128), both rows' accumulators are held,
//   slice 0's stage is handed back while slice 1's wgmmas run, and the
//   epilogue follows.  Each stage has a "full" mbarrier a consumer, on
//   which the producer's loads complete for the tile's consumer: a
//   consumer's waits on one barrier then come in the order of its phases,
//   which a parity wait needs (with two slices and two stages, both
//   consumers read every stage in turn, and one could otherwise reach use
//   u of a stage before use u - 1 was filled).
// * Epilogue: the accumulator fragment holds, a lane, two channels of each
//   8-channel block for two pixels.  The residual's loads go first, so
//   that their latency passes under the arithmetic.  The lane rounds to
//   bf16, adds the bias, rounds, and applies the ReLU on its own values,
//   then the 4 lanes of a quad transpose their 4-byte pieces with
//   shuffles, so that each lane holds 8 consecutive channels of one pixel:
//   every store (and residual load) is 16 bytes, and a quad writes 64
//   contiguous bytes.  up2x's four phases store to the pixels (2i + a,
//   2j + b) of their phase.
// * Programmatic dependent launch: only the mbarrier set-up runs while the
//   previous kernel of the stream finishes.  Every read of device memory
//   (weights, bias, x, the residual) and every write follows
//   griddepcontrol.wait, so the kernel just before may produce any input
//   (the route lays the weights out on the card right before its first
//   frame's tail).
//
// Shared memory (bytes): weights 9 * CIN * 64 * 2, bias 256, NS stages of
// SC / 8 * LBO_A, 24 * NS of mbarriers; the limit a block is 232,448.  The
// int8 kernels' plan (all COUT channels and a whole tile a stage) does not
// fit bf16 weights at 128 -> 128 (294,912 bytes alone); here each block
// holds 64 output channels, and a 3x3 tile at CIN 128 is staged in two
// 64-channel slices (TR = 2) and an up2x tile at CIN 128 as one row (TR = 1).
//   layer (CIN -> COUT)          TR  SC   stage    NS  weights  total
//   3x3   64 -> 64 (resblocks,    2  64   33,792   4   73,728   209,248
//          trunk_rb1), 64 -> 128 (trunk_rb2/Conv_0, two blocks a tile)
//   up2x  64 -> 64 (up1)          2  64   25,600   4   73,728   176,480
//   3x3   128 -> 128 (trunk_rb2/  2  64   33,792   2  147,456   215,344
//          Conv_1, two blocks a tile), 128 -> 64 (conv_hr)
//   up2x  128 -> 128 (up2, two    1  128  34,816   2  147,456   217,392
//          blocks a tile)

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;           // columns a tile: the m64 of wgmma
constexpr int NB = 64;           // output channels a block: the n64 of wgmma
constexpr int THREADS = 384;     // warpgroup 0 produces, 1 and 2 consume
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_STAGES = 4;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

template <int CIN, bool UP>
struct Cfg {
  static constexpr int TR = UP && CIN == 128 ? 1 : 2;   // rows of pixels a tile
  static constexpr int SC = UP ? CIN : 64;              // input channels a stage
  static constexpr int NSL = CIN / SC;                  // stages (K slices) a tile
  static constexpr int KC = SC / 8;                     // 16-byte K chunks a staged pixel
  static constexpr int K = 9 * CIN;                     // GEMM depth
  static constexpr int HALO = UP ? 0 : 1;
  static constexpr int IH = UP ? TR + 1 : TR + 2;       // staged rows
  static constexpr int IW = UP ? TW + 1 : TW + 2;       // staged columns
  static constexpr int LBO_A = cdiv(IH * IW * 16, 128) * 128;   // TMA: 128-byte aligned planes
  static constexpr int STAGE = KC * LBO_A;
  static constexpr int LBO_B = NB * 16;
  static constexpr int W_BYTES = K * NB * 2;
  static constexpr int BIAS_OFF = W_BYTES;
  static constexpr int RING_OFF = W_BYTES + 4 * NB;
  static constexpr int NS = cmin(MAX_STAGES, (SMEM_LIMIT - RING_OFF - 24 * MAX_STAGES) / STAGE);
  static constexpr int BAR_OFF = RING_OFF + NS * STAGE;
  static constexpr int SMEM = BAR_OFF + 24 * NS;
  // A consumer's uses of a stage's "full" barrier run in order: with one
  // slice a tile and an even NS each stage serves one consumer; with two
  // slices and two stages every stage serves both in turn, so each stage
  // has a "full" barrier a consumer (see the kernel).
  static constexpr int STRIDE = NSL == 1 ? 1 : 2;    // uses of a stage between a consumer's
  static_assert((NSL == 1 && NS % 2 == 0) || (NSL == 2 && NS == 2), "consumers' stage uses");
  static_assert(NSL == 1 || !UP, "up2x stages whole tiles");
  static_assert(RING_OFF % 128 == 0 && STAGE % 16 == 0, "16-byte aligned stages");
  static constexpr int TX = KC * IH * IW * 16;          // bytes a stage's TMA loads bring
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
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

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// one TMA tile load of x (NHWC as a 4-D tensor map: channel, column, row,
// image), completing on `bar`; coordinates outside the tensor read zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c, int x,
                                         int y, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(b), "r"(bar)
      : "memory");
}

// generic-proxy writes to shared memory (the weights' cp.async), made
// visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared, bypassing L1
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the accumulators in place across the asynchronous wgmmas.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Matrix descriptor, no swizzle: start, leading (K) and stride (M or N)
// byte offsets between core matrices, each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

// d (m64 x n64, f32) = A (m64 x k16, bf16, K-major) * B (n64 x k16, bf16,
// K-major) + (acc ? d : 0)
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// ---- arithmetic ---------------------------------------------------------------------

// Two output values as torch's chain rounds them: the f32 sums to bf16,
// + bias in f32 and to bf16 again, then the ReLU on the bf16 halves (a
// signed 16-bit max with 0 keeps positive values and zeroes negative ones
// and -0).
__device__ __forceinline__ uint32_t bias_relu2(float a0, float a1, float2 bs, bool has_bias,
                                               bool relu) {
  __nv_bfloat162 y = __floats2bfloat162_rn(a0, a1);
  if (has_bias) {
    const float2 f = __bfloat1622float2(y);
    y = __floats2bfloat162_rn(__fadd_rn(f.x, bs.x), __fadd_rn(f.y, bs.y));
  }
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&y);
  return relu ? __vmaxs2(u, 0u) : u;
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

// x reaches the kernel as a tensor map, for its TMA loads
struct Args {
  const __nv_bfloat16* w;
  const __nv_bfloat16* bias;
  const __nv_bfloat16* res;
  __nv_bfloat16* out;
  int B, H, W, cout, relu;
};

// A tile: TR rows x TW columns of pixels of image b.  Tile ids run down
// each column strip (image b, columns x0..x0 + 63) before the next strip.
struct Tile {
  int b, y0, x0;
};

template <int TR>
__device__ __forceinline__ Tile decode(int tile, int tiles_h, int tiles_w) {
  const int per_image = tiles_h * tiles_w;
  const int rem = tile % per_image;
  return {tile / per_image, (rem % tiles_h) * TR, (rem / tiles_h) * TW};
}

// Consumer epilogue of one m64 row: acc holds, for this lane, pixels m0 =
// 16 warp + lane / 4 and m0 + 8, channels 8 j + 2 (lane % 4) + {0, 1} of
// every 8-channel block j.  `pix(m)` gives output pixel m's element offset
// (its first channel of this block's 64), or -1 where it lies outside the
// output.  Each lane rounds its own values, then the quad transposes them
// into 16-byte pieces.
template <typename PixFn>
__device__ __forceinline__ void epilogue(const Args& a, const float (&acc)[32],
                                         const float* bias_s, int wtid, PixFn pix) {
  const int lane = wtid & 31, warp = wtid >> 5, q = lane & 3;
  const bool has_bias = a.bias != nullptr, relu = a.relu != 0;
  long long base[2];
  uint4 r[2][NB / 32];  // the residual, loaded first: its latency under the math below
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    base[h] = pix(16 * warp + (lane >> 2) + 8 * h);
    if (a.res != nullptr && base[h] >= 0) {
#pragma unroll
      for (int g = 0; g < NB / 32; ++g)
        r[h][g] = __ldg(reinterpret_cast<const uint4*>(a.res + base[h] + 8 * (4 * g + q)));
    }
  }
  uint32_t pk[2][NB / 8];
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    const float2 bs = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pk[h][j] = bias_relu2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], bs, has_bias, relu);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint4 v[NB / 32];
#pragma unroll
    for (int g = 0; g < NB / 32; ++g)
      v[g] = quad_transpose(pk[h][4 * g], pk[h][4 * g + 1], pk[h][4 * g + 2],
                            pk[h][4 * g + 3], lane);
    if (base[h] < 0) continue;
    if (a.res != nullptr) {
#pragma unroll
      for (int g = 0; g < NB / 32; ++g)
        v[g] = make_uint4(add_bf16x2(v[g].x, r[h][g].x), add_bf16x2(v[g].y, r[h][g].y),
                          add_bf16x2(v[g].z, r[h][g].z), add_bf16x2(v[g].w, r[h][g].w));
    }
#pragma unroll
    for (int g = 0; g < NB / 32; ++g)
      *reinterpret_cast<uint4*>(a.out + base[h] + 8 * (4 * g + q)) = v[g];
  }
}

// up2x phase (pr, pc)'s first tap: (1, 1), (1, 0), (0, 1) or (0, 0)
__host__ __device__ constexpr int first_tap(int pr, int pc) {
  return 3 * (pr ? 0 : 1) + (pc ? 0 : 1);
}

// Issue the wgmmas of one m64 row of a tile over the stage at `a_row` (its
// staged row r): the 9 taps of the 3x3 conv, or up2x phase (pr, pc)'s own
// taps.  `sl` is the stage's K slice; `first` whether it starts the sum.
template <int CIN, bool UP>
__device__ __forceinline__ void row_mmas(float (&acc)[32], uint32_t a_row, uint64_t desc_a0,
                                         uint64_t desc_b0, int sl, int pr, int pc,
                                         bool first) {
  using C = Cfg<CIN, UP>;
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
    for (int kk = 0; kk < C::KC / 2; ++kk) {
      const uint64_t da = desc_a0 | ((a_tap + 2 * kk * C::LBO_A) & 0x3FFFF) >> 4;
      const int chunk = tap * (CIN / 8) + sl * C::KC + 2 * kk;
      const uint64_t db = desc_b0 + ((chunk * C::LBO_B) >> 4);
      const bool start = first && kk == 0 && (UP ? tap == first_tap(pr, pc) : tap == 0);
      mma(acc, da, db, start ? 0 : 1);
    }
  }
}

template <int CIN, bool UP>
__global__ void __launch_bounds__(THREADS, 1)
    bf16_conv_kernel(const Args a, const __grid_constant__ CUtensorMap xmap) {
  using C = Cfg<CIN, UP>;
  constexpr int TR = C::TR;
  extern __shared__ __align__(1024) unsigned char smem[];
  float* bias_s = reinterpret_cast<float*>(smem + C::BIAS_OFF);
  const uint32_t w_addr = smem_addr(smem);
  // full[NS][2] (a stage's fill for consumer 0 or 1), then empty[NS]
  const uint32_t bar_addr = w_addr + C::BAR_OFF;
  const int tid = threadIdx.x;

  // this block's output channels and tiles: groups of COUT / 64 blocks
  // share a contiguous range of the tile ids
  const int halves = a.cout / NB, h = blockIdx.x % halves;
  const int groups = gridDim.x / halves, grp = blockIdx.x / halves;
  const int tiles_w = cdiv(a.W, TW), tiles_h = cdiv(a.H, TR);
  const long long ntiles = static_cast<long long>(a.B) * tiles_h * tiles_w;
  const int first = static_cast<int>(ntiles * grp / groups);
  const int nk = static_cast<int>(ntiles * (grp + 1) / groups) - first;
  const int wg = tid >> 7;

  if (tid == 0) {
    for (int s = 0; s < 2 * C::NS; ++s) mbar_init(bar_addr + 8 * s, 1);  // TMA + its bytes
    for (int s = 0; s < C::NS; ++s) mbar_init(bar_addr + 8 * (2 * C::NS + s), 4);  // warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // programmatic dependent launch: the set-up above ran beside the previous
  // kernel's tail; every read of device memory and every write follows its
  // end
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (wg == 0) {
    // ---- producer (one thread): stage j = k * NSL + sl is slice sl of
    // local tile k, KC TMA loads of one 16-byte channel chunk each
    if (tid == 0) {
      const int total = nk * C::NSL;
      for (int j = 0; j < total; ++j) {
        const int s = j % C::NS, k = j / C::NSL, sl = j % C::NSL;
        mbar_wait(bar_addr + 8 * (2 * C::NS + s), ((j / C::NS) & 1) ^ 1);
        const Tile t = decode<TR>(first + k, tiles_h, tiles_w);
        const uint32_t st = w_addr + C::RING_OFF + s * C::STAGE;
        const uint32_t full = bar_addr + 8 * (2 * s + k % 2);  // the tile's consumer's
        mbar_expect_tx(full, C::TX);
#pragma unroll
        for (int kc = 0; kc < C::KC; ++kc)
          tma_load(st + kc * C::LBO_A, &xmap, sl * C::SC + kc * 8, t.x0 - C::HALO,
                   t.y0 - C::HALO, t.b, full);
      }
    }
    return;
  }

  // ---- consumers.  First the block's weights, in the K-major core-matrix
  // layout (chunk kc of row n at (kc * 64 + n) * 16; neighbouring threads
  // read the two chunks of one 32-byte sector), and the bias: their copy
  // runs while the producer stages the first tile
  constexpr int KCH = C::K / 8;
  const __nv_bfloat16* wh = a.w + static_cast<size_t>(h) * NB * C::K;
  for (int i = tid - 128; i < NB * KCH; i += THREADS - 128) {
    const int kc = 2 * (i / (2 * NB)) + (i & 1), n = (i >> 1) % NB;
    cp_async16(w_addr + (kc * NB + n) * 16, wh + static_cast<size_t>(n) * C::K + kc * 8);
  }
  for (int i = tid - 128; i < NB; i += THREADS - 128)
    bias_s[i] = a.bias != nullptr ? __bfloat162float(a.bias[h * NB + i]) : 0.f;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_async_shared();
  asm volatile("bar.sync 2, %0;\n" ::"n"(THREADS - 128) : "memory");

  // warpgroup 1 + c computes the tiles k = c, c + 2, ..., so that one's
  // epilogue overlaps the other's wgmmas
  const int c = wg - 1, wtid = tid & 127, lane = tid & 31;
  const int OH = UP ? 2 * a.H : a.H, OW = UP ? 2 * a.W : a.W;
  const uint64_t desc_a0 = make_desc(0, C::LBO_A, 128);
  const uint64_t desc_b0 = make_desc(w_addr, C::LBO_B, 128);
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_addr + 8 * (2 * C::NS + s));
  };
  // stage use u (its u-th fill) is this consumer's (u / STRIDE)-th of it
  auto wait_full = [&](int j) {
    const int s = j % C::NS;
    mbar_wait(bar_addr + 8 * (2 * s + c), ((j / C::NS / C::STRIDE) & 1));
  };
  for (int k = c; k < nk; k += 2) {
    const Tile t = decode<TR>(first + k, tiles_h, tiles_w);
    const long long img = static_cast<long long>(t.b) * OH * OW;
    auto pix_fn = [&](int r, int pr, int pc) {
      return [&, r, pr, pc](int m) -> long long {
        const int x = t.x0 + m, y = t.y0 + r;
        if (y >= a.H || x >= a.W) return -1;
        const int oy = UP ? 2 * y + pr : y, ox = UP ? 2 * x + pc : x;
        return (img + static_cast<long long>(oy) * OW + ox) * a.cout + h * NB;
      };
    };
    if constexpr (C::NSL == 1) {
      const int j = k, s = j % C::NS;
      wait_full(j);
      const uint32_t stage = w_addr + C::RING_OFF + s * C::STAGE;
#pragma unroll 1
      for (int r = 0; r < TR; ++r) {
#pragma unroll
        for (int phase = 0; phase < (UP ? 4 : 1); ++phase) {
          const int pr = phase >> 1, pc = phase & 1;  // up2x: output row / column parity
          float acc[32];  // the first wgmma writes it
          wgmma_fence();
          row_mmas<CIN, UP>(acc, stage + r * C::IW * 16, desc_a0, desc_b0, 0, pr, pc, true);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(acc);
          if (r == TR - 1 && phase == (UP ? 3 : 0)) release(s);  // the stage is read
          epilogue(a, acc, bias_s, wtid, pix_fn(r, pr, pc));
        }
      }
    } else {
      // two K slices: both rows' sums held across them
      float acc[TR][32];
#pragma unroll
      for (int sl = 0; sl < C::NSL; ++sl) {
        const int j = k * C::NSL + sl, s = j % C::NS;
        wait_full(j);
        const uint32_t stage = w_addr + C::RING_OFF + s * C::STAGE;
#pragma unroll
        for (int r = 0; r < TR; ++r) fence_acc(acc[r]);
        wgmma_fence();
#pragma unroll
        for (int r = 0; r < TR; ++r)
          row_mmas<CIN, UP>(acc[r], stage + r * C::IW * 16, desc_a0, desc_b0, sl, 0, 0,
                            sl == 0);
        wgmma_commit();
#pragma unroll
        for (int r = 0; r < TR; ++r) fence_acc(acc[r]);
        if (sl > 0) {
          wgmma_wait<1>();  // the previous slice's wgmmas are done with its stage
          release((j - 1) % C::NS);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < TR; ++r) fence_acc(acc[r]);
      release((k * C::NSL + C::NSL - 1) % C::NS);
#pragma unroll
      for (int r = 0; r < TR; ++r) epilogue(a, acc[r], bias_s, wtid, pix_fn(r, 0, 0));
    }
  }
}

template <int CIN, bool UP>
int set_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      bf16_conv_kernel<CIN, UP>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<CIN, UP>::SMEM));
}

template <int CIN, bool UP>
cudaError_t launch_one(const Args& a, const CUtensorMap& xmap, int grid, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Cfg<CIN, UP>::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, bf16_conv_kernel<CIN, UP>, a, xmap);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (no link to libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <bool UP>
int launch(const void* x, const void* w, const void* bias, const void* res, void* out, int B,
           int H, int W, int cin, int cout, int relu, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tr = UP && cin == 128 ? 1 : 2;
  const long long ntiles = static_cast<long long>(B) * cdiv(H, tr) * cdiv(W, TW);
  const int halves = cout / NB, per = sms / halves;
  const int grid = halves * static_cast<int>(ntiles < per ? ntiles : per);
  const Args a{static_cast<const __nv_bfloat16*>(w),
               static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(res),
               static_cast<__nv_bfloat16*>(out), B, H, W, cout, relu};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // x as a 4-D tensor map (channel, column, row, image); a box is one
  // 16-byte channel chunk of a stage's IH x IW pixels
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(cin) * 2,
                                 static_cast<cuuint64_t>(W) * cin * 2,
                                 static_cast<cuuint64_t>(H) * W * cin * 2};
  const cuuint32_t box[4] = {8, static_cast<cuuint32_t>(UP ? TW + 1 : TW + 2),
                             static_cast<cuuint32_t>(UP ? tr + 1 : tr + 2), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const int enc = encode_tiled()(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                                 dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                 CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (enc != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cin == 64 ? launch_one<64, UP>(a, xmap, grid, s)
                                    : launch_one<128, UP>(a, xmap, grid, s);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// Plain C entry points (loaded with ctypes), on the calling thread's
// current device.
//
// bf16_conv_init: raise the kernels' dynamic shared memory limit; once per
// device, before the first launch.
extern "C" int bf16_conv_init() {
  int err = set_smem<64, false>();
  if (!err) err = set_smem<128, false>();
  if (!err) err = set_smem<64, true>();
  if (!err) err = set_smem<128, true>();
  return err;
}

// bf16_conv3x3_launch / bf16_up2x_launch: launch on `stream` without
// synchronising; `bias` and `res` may be null.  Return cudaGetLastError()
// (0 on success).  The wrapper has checked shapes, types and alignment.
extern "C" int bf16_conv3x3_launch(const void* x, const void* w, const void* bias,
                                   const void* res, void* out, int B, int H, int W, int cin,
                                   int cout, int relu, void* stream) {
  return launch<false>(x, w, bias, res, out, B, H, W, cin, cout, relu, stream);
}

extern "C" int bf16_up2x_launch(const void* x, const void* w, const void* bias,
                                const void* res, void* out, int B, int H, int W, int cin,
                                int cout, int relu, void* stream) {
  return launch<true>(x, w, bias, res, out, B, H, W, cin, cout, relu, stream);
}
