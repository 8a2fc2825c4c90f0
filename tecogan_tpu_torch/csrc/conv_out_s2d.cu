// conv_out + bias + sigmoid + space-to-depth, fused, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels conv_out_s2d_pallas_paired and
// conv_out_s2d_pallas (tecogan_tpu/ops/pallas/conv_out_s2d.py), one kernel
// for both: masked row and column tails cover every B, H and W.
//
// Contract (NHWC):
//   feat  (B, 4H, 4W, 64) bf16 (f32: the f32 kernel below), contiguous
//   w     (3, 3, 64, 3)   f32 HWIO, contiguous; rounded to bf16 (to
//                         nearest) on load, as the JAX route casts it
//   bias  (3,)            f32
//   out   (B, H, W, 48)   bf16
//   out[b, i, j, c*16 + a*4 + bb] = sigmoid(bias[c] +
//       sum_{u,v,k} feat[b, 4i+a+u-1, 4j+bb+v-1, k] * bf16(w[u, v, k, c]))
// with zero padding outside the image and f32 accumulation.  The
// 3-channel HR frame is never stored: each result goes straight to its
// space-to-depth slot.
//
// What bounds it: at 1080p the kernel must read the 265.4 MB of bf16
// features and write the 12.4 MB result, 277.8 MB: 0.083 ms at 3.35 TB/s.
// The tensor-core work of the tiling below is 9.3 GFLOP (2.3 M m16n8k16
// products, padding included), ~0.015 ms even at mma.sync rates, so it is
// bytes-bound once each feature is fetched once and the loads overlap the
// compute.
//
// Formulation (the JAX kernel's shift-after-the-dot): for each staged HR
// input row r and row tap u, Z_u[p, n] = sum_k F[r, p, k] * W[u, v, k, c]
// with n = 3v + c is a bf16 m16n8k16 product per 16 pixels and 16
// channels, added into the f32 accumulator of output row r - u + 1.
// Columns n < 8 have one 8-column tile per row tap; the ninth, (v 2, c 2),
// of all three taps shares a fourth tile, so a 16x16 A tile feeds 4 MMAs.
// Three accumulators roll down the band; output row o is complete once
// row o + 1 is in.  Its result is then y[x, c] = sum_v Z[x + v - 1, 3v + c]:
// the column shift acts on the small sums, through shared memory.  Each
// staged feature is read from shared memory once (one ldmatrix.x4 per
// 16x16 A tile).  The B fragments (32 registers) are built once per block
// from the f32 weights, rounded to bf16.
//
// The fp32 route, a precision reference, has a kernel of its own
// (conv_out_s2d_f32_kernel, at the end, with its design): the same function
// on f32 features and the f32 weights as they are (no rounding to bf16),
// summed with f32 FMAs on the CUDA cores, the result rounded to bf16 once.
//
// Tiling: a block of 8 warps owns a strip of TC = 30 LR columns (120 HR
// columns plus a 1-pixel halo on each side: 122 staged pixels in 8 M
// tiles of 16, one a warp) and a band of BH = 17 LR rows (68 HR rows plus
// a halo row above and below).  It walks down the band with a ring of
// STAGES = 3 HR rows in shared memory, filled by cp.async (zero-fill
// outside the image gives the SAME padding), two rows in flight while the
// MMAs run on the third; one barrier a row.  Pixels are padded to 144
// bytes so that the 8 row addresses of each ldmatrix phase hit distinct
// banks.  Each finished HR row's sigmoid values go to the LR row's s2d
// records in shared memory; after sub-row a = 3 the strip's records are
// stored as one contiguous run in 16-byte writes.  At 1080p the grid is
// 16 strips x 16 bands = 256 blocks, one wave at 2 blocks an SM (70,272
// bytes of shared memory and 128 registers a thread); halos re-read 1.56%
// of the columns and 2.78% of the rows, so the features are fetched 1.044
// times (277.0 MB): with the 12.4 MB written, 0.0864 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int K = 64;                    // feature channels
constexpr int C = 3;                     // output channels
constexpr int TC = 30;                   // LR columns per strip
constexpr int BH = 17;                   // LR rows per band
constexpr int SW = 4 * TC + 2;           // staged HR pixels per row
constexpr int MT = (SW + 15) / 16;       // M tiles of 16 pixels, one a warp
constexpr int MROWS = 16 * MT;           // pixel slots per ring row
constexpr int THREADS = 32 * MT;
constexpr int STAGES = 3;                // ring rows
constexpr int CHUNKS = K / 8;            // 16-byte chunks per pixel
constexpr int PIX_BYTES = 2 * K + 16;    // 144: 36 words, 4 mod 32
constexpr int ROW_BYTES = MROWS * PIX_BYTES;
constexpr int RING_BYTES = STAGES * ROW_BYTES;
constexpr int ZS = 9;                    // floats per pixel of Z: n = 3v + c
constexpr int ZS_BYTES = MROWS * ZS * 4;
constexpr int REC = 16 * C;              // s2d channels of one LR pixel
constexpr int REC_BYTES = TC * REC * 2;
constexpr int SMEM_BYTES = RING_BYTES + 2 * ZS_BYTES + 2 * REC_BYTES;

static_assert(THREADS % CHUNKS == 0 && MROWS * CHUNKS % THREADS == 0,
              "whole copies per thread, one chunk index a thread");
static_assert(ZS_BYTES % 16 == 0 && RING_BYTES % 16 == 0, "alignment");
static_assert(REC * 2 % 16 == 0, "LR records must be whole 16-byte pieces");

__device__ __forceinline__ void cp_async16(uint32_t smem_dst, const void* gmem_src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_dst),
               "l"(gmem_src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// d += a * b: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Band {
  const __nv_bfloat16* img;  // this image's features
  __nv_bfloat16* out;
  int H, W, b, i0, j0, nb, NR;
  uint32_t ring;             // shared address of the ring
  unsigned char* smem;
};

// Issue the copies of band input row t (HR row 4*i0 - 1 + t) into its
// ring slot; pixels outside the image and slots past the strip are
// zero-filled without reading memory.  THREADS is a multiple of CHUNKS,
// so a thread copies the same 16-byte chunk of every pixel it copies.
__device__ __forceinline__ void stage_row(const Band& s, int t) {
  const int r = 4 * s.i0 - 1 + t;
  const int W4 = 4 * s.W;
  const bool row_in = r >= 0 && r < 4 * s.H;
  const int q0 = threadIdx.x / CHUNKS, ch = threadIdx.x % CHUNKS;
  const __nv_bfloat16* row = s.img + (size_t)(row_in ? r : 0) * W4 * K + ch * 8;
  const uint32_t dst = s.ring + (t % STAGES) * ROW_BYTES + ch * 16;
#pragma unroll
  for (int k = 0; k < MROWS * CHUNKS / THREADS; ++k) {
    const int q = q0 + k * (THREADS / CHUNKS);
    const int x = 4 * s.j0 - 1 + q;
    const bool in = row_in && q < SW && x >= 0 && x < W4;
    cp_async16(dst + q * PIX_BYTES, in ? row + (size_t)x * K : s.img, in ? 16 : 0);
  }
}

// Output row e of the band (HR row 4*i0 + e): the column shift on its
// sums in zs, bias and sigmoid, into slot e % 4 of the s2d records of its
// LR row; one (channel, HR column) a task, spread over the block.
__device__ __forceinline__ void epilogue(const Band& s, int e, const float* zs,
                                         const float (&bias)[C]) {
  __nv_bfloat16* rec = reinterpret_cast<__nv_bfloat16*>(s.smem + RING_BYTES + 2 * ZS_BYTES) +
                       ((e >> 2) & 1) * TC * REC;
  for (int task = threadIdx.x; task < C * 4 * TC; task += THREADS) {
    const int c = task / (4 * TC);
    const int xl = task % (4 * TC);  // HR column 4*j0 + xl, staged at slot xl + 1
    const float* z = zs + xl * ZS + c;
    const float y = (c == 0 ? bias[0] : c == 1 ? bias[1] : bias[2]) + z[0] + z[ZS + 3] +
                    z[2 * ZS + 6];
    rec[(xl >> 2) * REC + c * 16 + (e & 3) * 4 + (xl & 3)] =
        __float2bfloat16_rn(__fdividef(1.f, 1.f + __expf(-y)));
  }
}

// Store the strip's records of band LR row li as one contiguous run.
__device__ __forceinline__ void store_row(const Band& s, int li) {
  const uint4* src = reinterpret_cast<const uint4*>(s.smem + RING_BYTES + 2 * ZS_BYTES) +
                     (li & 1) * (TC * REC * 2 / 16);
  uint4* dst = reinterpret_cast<uint4*>(
      s.out + (((size_t)s.b * s.H + s.i0 + li) * s.W + s.j0) * REC);
  const int n = min(TC, s.W - s.j0) * (REC * 2 / 16);
  for (int e = threadIdx.x; e < n; e += THREADS) dst[e] = src[e];
}

// A warp's registers: the B fragments (k rows 2*cq, 2*cq + 1 and +8,
// column g of each 8-column tile) and the f32 accumulators of its 16
// pixels.  Tile u (one a row tap) holds columns n = 3v + c < 8; the last
// column, (v 2, c 2), of all three row taps shares tile D (column u), so
// a 16x16 A tile feeds 4 MMAs and no fragment is mostly padding.
struct Warp {
  uint32_t bw[3][K / 16][2];
  uint32_t bd[K / 16][2];
  float acc[3][4];  // acc[o % 3]: columns 0..7 of output row o
  float r8[3][2];   // r8[o % 3]: column 8 of output row o, pixel rows g, g+8
  float bias[C];
};

// One band input row t, with P = t % 3 known at compile time so that the
// rolling accumulators stay in registers.  One barrier a row: the sums of
// the row finished at step t - 1 (in zs, two buffers) go through the
// epilogue at step t, and an LR row's records (two buffers) are stored at
// the step after its last sub-row.
template <int P>
__device__ __forceinline__ void band_row(const Band& s, int t, Warp& r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* zs = reinterpret_cast<float*>(s.smem + RING_BYTES);
  cp_async_wait<STAGES - 2>();  // row t has landed (this thread's copies)
  __syncthreads();              // ... everyone's; row t - 1's slot is free
  if (t + STAGES - 1 < s.NR) stage_row(s, t + STAGES - 1);
  cp_async_commit();
  if (t >= 4 && ((t - 4) & 3) == 3) store_row(s, (t - 4) >> 2);
  if (t >= 3) epilogue(s, t - 3, zs + ((t - 1) & 1) * (MROWS * ZS), r.bias);

  const uint32_t a_base = s.ring + (t % STAGES) * ROW_BYTES +
                          (16 * warp + (lane & 15)) * PIX_BYTES + (lane >> 4) * 16;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kt = 0; kt < K / 16; ++kt) {
    uint32_t a[4];
    ldmatrix_x4(a_base + kt * 32, a);
#pragma unroll
    for (int u = 0; u < 3; ++u) mma_bf16(r.acc[(P - u + 3) % 3], a, r.bw[u][kt]);
    mma_bf16(d, a, r.bd[kt]);
  }
  // tile D's column u belongs to output row t - u; lane (g, 0) holds
  // columns 0 and 1, lane (g, 1) column 2
  const float d2_lo = __shfl_down_sync(0xffffffffu, d[0], 1);
  const float d2_hi = __shfl_down_sync(0xffffffffu, d[2], 1);
  constexpr int DONE = (P + 1) % 3;  // output row t - 2: its last tap is in
  r.r8[P][0] += d[0];
  r.r8[P][1] += d[2];
  r.r8[(P + 2) % 3][0] += d[1];
  r.r8[(P + 2) % 3][1] += d[3];
  r.r8[DONE][0] += d2_lo;
  r.r8[DONE][1] += d2_hi;

  if (t >= 2) {
    const int g = lane >> 2, cq = lane & 3;
    float* z0 = zs + (t & 1) * (MROWS * ZS) + (16 * warp + g) * ZS;
    float* z1 = z0 + 8 * ZS;
    z0[2 * cq] = r.acc[DONE][0];
    z0[2 * cq + 1] = r.acc[DONE][1];
    z1[2 * cq] = r.acc[DONE][2];
    z1[2 * cq + 1] = r.acc[DONE][3];
    if (cq == 0) {
      z0[8] = r.r8[DONE][0];
      z1[8] = r.r8[DONE][1];
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) r.acc[DONE][e] = 0.f;
  r.r8[DONE][0] = r.r8[DONE][1] = 0.f;
}

__global__ void __launch_bounds__(THREADS, 2)
conv_out_s2d_kernel(const __nv_bfloat16* __restrict__ feat,
                    const float* __restrict__ wgt,
                    const float* __restrict__ bias_g,
                    __nv_bfloat16* __restrict__ out, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];

  Band s;
  s.H = H;
  s.W = W;
  s.b = blockIdx.z;
  s.i0 = blockIdx.y * BH;
  s.j0 = blockIdx.x * TC;
  s.nb = min(BH, H - s.i0);
  s.NR = 4 * s.nb + 2;
  s.img = feat + (size_t)s.b * (4 * H) * (4 * W) * K;
  s.out = out;
  s.smem = smem;
  s.ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // the first STAGES - 1 rows in flight while the weights are built
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    stage_row(s, t);  // NR >= 6 > STAGES - 1
    cp_async_commit();
  }

  // w[u, v, k, c] in HWIO at ((u*3 + v)*K + k)*C + c, rounded to bf16
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, cq = lane & 3;
  Warp r;
#pragma unroll
  for (int kt = 0; kt < K / 16; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * kt + 8 * h + 2 * cq;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const float* w = wgt + ((u * 3 + g / C) * K + k) * C + g % C;  // n = g
        r.bw[u][kt][h] = pack_bf16x2(__ldg(w), __ldg(w + C));
      }
      const float* w = wgt + ((min(g, 2) * 3 + 2) * K + k) * C + 2;  // (u = g, v 2, c 2)
      r.bd[kt][h] = g < 3 ? pack_bf16x2(__ldg(w), __ldg(w + C)) : 0u;
    }
#pragma unroll
  for (int c = 0; c < C; ++c) r.bias[c] = __ldg(bias_g + c);
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int e = 0; e < 4; ++e) r.acc[p][e] = 0.f;
    r.r8[p][0] = r.r8[p][1] = 0.f;
  }

  for (int t = 0; t < s.NR; t += 3) {
    band_row<0>(s, t, r);
    if (t + 1 < s.NR) band_row<1>(s, t + 1, r);
    if (t + 2 < s.NR) band_row<2>(s, t + 2, r);
  }
  // the band's last output row, finished at step NR - 1, and its LR row
  cp_async_wait<0>();
  __syncthreads();
  epilogue(s, s.NR - 3, reinterpret_cast<const float*>(smem + RING_BYTES) +
                            ((s.NR - 1) & 1) * (MROWS * ZS), r.bias);
  __syncthreads();
  store_row(s, s.nb - 1);
}

// ---- the f32 kernel -----------------------------------------------------------------
// The fp32 route's kernel: the same function on f32 features and the f32
// weights as they are, summed with f32 FMAs on the CUDA cores.
//
// What bounds it: at 1080p it must read the 530.84 MB of f32 features and
// write the 12.44 MB result, 543.28 MB: 0.1622 ms at 3.35 TB/s.  Its
// 3.583 G FMAs take 0.1070 ms at 67 TFLOP/s, under the bytes but not far:
// the FMA pipe has to be kept busy by a loop that reads shared memory
// rarely, while the next rows stream in.
//
// Tiling: a block of F_G = 4 warps owns a strip of F_TC = 32 LR columns
// (lane j: LR column j0 + j, its 4 HR columns) and walks down a band of
// F_BH = 16 LR rows one HR input row at a time, as the bf16 kernel does,
// through a ring of F_STAGES = 3 whole rows of the strip's 130 staged
// pixels (a halo of one), filled by cp.async with zero-fill for SAME
// padding.  A staged row holds all 64 channels, one contiguous run of
// device memory: stages of half or quarter pixels ran slower.  Warp g sums
// channels 16g .. 16g + 15: per channel it loads its LR column's 6 staged
// pixels (4 + halo) and the 27 weights (u, v, c), and does 108 FMAs into
// 36 rolling accumulators: 3 output rows x 4 HR columns x 3 channels.  So
// each loaded feature feeds 18 FMAs and each weight 4, and a warp issues
// 1728 FMAs a row against 204 shared-memory wavefronts (24 float4 feature
// loads of 4 wavefronts, conflict-free by the swizzle below, and 108
// broadcast weight loads): 8.5 FMA instructions a wavefront.  Output row e
// takes input rows e, e + 1, e + 2 (row tap u = t - e); it is complete
// after row e + 2, when the 4 warps' partial sums meet in shared memory.
// At the next row warps 0-2 (channel c = g) add them, the bias, take the
// sigmoid, round to bf16 once and keep 4 values; after the LR row's fourth
// HR row each writes its 32 contiguous bytes of the LR pixel's 96-byte s2d
// record in two 16-byte stores.
//
// Shared memory: 3 x 33,280 bytes of ring, 6,144 of partial sums and 6,912
// of weights, 112,896 bytes: 2 blocks an SM (128 registers a thread).  At
// 1080p the grid is 15 strips x 17 bands = 255 blocks, one wave of 264
// places; halos re-read 2 of each band's 66 rows and 2 of each strip's 130
// columns, so the features are fetched 1.047 times (556 MB).
constexpr int F_TC = 32;                     // LR columns a strip, one a lane
constexpr int F_BH = 16;                     // LR rows a band
constexpr int F_G = 4;                       // channel groups, one a warp
constexpr int F_THREADS = 32 * F_G;
constexpr int F_SW = 4 * F_TC + 2;           // staged HR pixels a row
constexpr int F_Q = K / 4;                   // 16-byte chunks a pixel
constexpr int F_QW = F_Q / F_G;              // chunks a pixel a warp
constexpr int F_STAGES = 3;                  // ring rows
constexpr int F_BLOCKS = 2;                  // blocks an SM
constexpr int F_ROW_FLOATS = F_SW * K;
constexpr int F_RED_FLOATS = F_G * F_TC * 4 * C;  // partial sums of one output row
constexpr int F_W_FLOATS = 9 * K * C;
constexpr int F_SMEM = (F_STAGES * F_ROW_FLOATS + F_RED_FLOATS + F_W_FLOATS) * 4;
static_assert(F_Q % F_G == 0 && F_THREADS % F_Q == 0, "whole chunks a warp and a thread");
static_assert(F_W_FLOATS % 4 == 0 && F_RED_FLOATS % 4 == 0, "16-byte alignment");

// Shared float offset of 16-byte chunk q of staged pixel px: the chunk is
// XORed with bits 2-4 of px, so that the lanes of a quarter warp, which read
// pixels 4 apart, hit 8 different 16-byte bank groups.
__device__ __forceinline__ int f_chunk(int px, int q) {
  return 4 * (F_Q * px + (q ^ ((px >> 2) & 7)));
}

// Issue the copies of band input row t (HR row 4*i0 - 1 + t) into ring slot
// `dst`; pixels outside the image are zero-filled without reading memory.
// A thread copies the same chunk of every pixel it copies.
__device__ __forceinline__ void f_stage(const float* img, int H4, int W4, int i0, int j0,
                                        int t, uint32_t dst) {
  const int r = 4 * i0 - 1 + t;
  const bool row_in = r >= 0 && r < H4;
  const int q = threadIdx.x % F_Q;
  const float* row = img + (size_t)(row_in ? r : 0) * W4 * K + 4 * q;
  for (int px = threadIdx.x / F_Q; px < F_SW; px += F_THREADS / F_Q) {
    const int x = 4 * j0 - 1 + px;
    const bool in = row_in && x >= 0 && x < W4;
    cp_async16(dst + 4 * f_chunk(px, q), in ? row + (size_t)x * K : img, in ? 16 : 0);
  }
}

// One input row: warp g's channels k = 16g .. 16g + 15 (chunks F_QW g ..)
// of staged row `buf`.  Row t adds row tap u to output row t - u, kept in
// acc[2 - u].
__device__ __forceinline__ void f_row_fma(const float* buf, const float* ws, int g, int lane,
                                          float (&acc)[3][4][C]) {
#pragma unroll
  for (int qq = 0; qq < F_QW; ++qq) {
    const int kq = F_QW * g + qq;
    float f[6][4];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(buf + f_chunk(4 * lane + i, kq));
      f[i][0] = v.x;
      f[i][1] = v.y;
      f[i][2] = v.z;
      f[i][3] = v.w;
    }
    // w[u, v, k, c] in HWIO: the 12 floats (k, c) of a tap and a chunk are
    // contiguous, 3 float4s
    const float* wq = ws + 4 * C * kq;
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const float4* wp = reinterpret_cast<const float4*>(wq + (u * 3 + v) * K * C);
        const float4 w0 = wp[0], w1 = wp[1], w2 = wp[2];
        const float w[12] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y,
                             w1.z, w1.w, w2.x, w2.y, w2.z, w2.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < C; ++c)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[2 - u][b][c] = fmaf(f[b + v][kk], w[kk * C + c], acc[2 - u][b][c]);
      }
  }
}

// Output row e of the band (HR row 4*i0 + e), channel c = warp: the 4
// warps' partial sums of lane j's 4 HR columns, the bias, the sigmoid,
// rounded to bf16 into slot e % 4 of rec; after slot 3 the channel's 32
// bytes of the LR pixel's record go out as two 16-byte stores.
__device__ __forceinline__ void f_epilogue(const float* red, float bias_c, int e,
                                           __nv_bfloat16* out, int b, int H, int W, int i0,
                                           int j0, uint32_t (&rec)[8]) {
  const int c = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (c >= C) return;
  const float4* r4 = reinterpret_cast<const float4*>(red);
  float y[4] = {bias_c, bias_c, bias_c, bias_c};
#pragma unroll
  for (int g = 0; g < F_G; ++g) {
    const float4 p = r4[(g * F_TC + lane) * C + c];
    y[0] += p.x;
    y[1] += p.y;
    y[2] += p.z;
    y[3] += p.w;
  }
  float sg[4];
#pragma unroll
  for (int bb = 0; bb < 4; ++bb) sg[bb] = 1.f / (1.f + expf(-y[bb]));
  const uint32_t lo = pack_bf16x2(sg[0], sg[1]), hi = pack_bf16x2(sg[2], sg[3]);
  const int a = e & 3;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s == a) {
      rec[2 * s] = lo;
      rec[2 * s + 1] = hi;
    }
  if (a == 3 && lane < W - j0) {
    uint4* dst = reinterpret_cast<uint4*>(
        out + (((size_t)b * H + i0 + (e >> 2)) * W + j0 + lane) * REC + c * 16);
    dst[0] = make_uint4(rec[0], rec[1], rec[2], rec[3]);
    dst[1] = make_uint4(rec[4], rec[5], rec[6], rec[7]);
  }
}

__global__ void __launch_bounds__(F_THREADS, F_BLOCKS)
conv_out_s2d_f32_kernel(const float* __restrict__ feat, const float* __restrict__ wgt,
                        const float* __restrict__ bias_g, __nv_bfloat16* __restrict__ out,
                        int H, int W) {
  extern __shared__ __align__(128) float fsm[];
  float* red = fsm + F_STAGES * F_ROW_FLOATS;
  float* ws = red + F_RED_FLOATS;
  const int b = blockIdx.z, i0 = blockIdx.y * F_BH, j0 = blockIdx.x * F_TC;
  const int H4 = 4 * H, W4 = 4 * W;
  const int NR = 4 * min(F_BH, H - i0) + 2;  // band input rows
  const float* img = feat + (size_t)b * H4 * W4 * K;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(fsm));

  // the first F_STAGES - 1 rows in flight while the weights are copied
#pragma unroll
  for (int t = 0; t < F_STAGES - 1; ++t) {  // NR >= 6
    f_stage(img, H4, W4, i0, j0, t, ring + t * F_ROW_FLOATS * 4);
    cp_async_commit();
  }
  for (int e = threadIdx.x; e < F_W_FLOATS / 4; e += F_THREADS)
    reinterpret_cast<float4*>(ws)[e] = __ldg(reinterpret_cast<const float4*>(wgt) + e);
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float bias_c = __ldg(bias_g + min(g, C - 1));
  float acc[3][4][C];
#pragma unroll
  for (int o = 0; o < 3; ++o)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[o][bb][c] = 0.f;
  uint32_t rec[8];

  // Two barriers a row: after the first, row t has landed and row t - 1's
  // slot is free; the second keeps the partial sums of output row t - 3,
  // written after row t - 1 and read here, from being rewritten after row t.
  for (int t = 0; t < NR; ++t) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();
    if (t + F_STAGES - 1 < NR)
      f_stage(img, H4, W4, i0, j0, t + F_STAGES - 1,
              ring + ((t + F_STAGES - 1) % F_STAGES) * F_ROW_FLOATS * 4);
    cp_async_commit();
    if (t >= 3) f_epilogue(red, bias_c, t - 3, out, b, H, W, i0, j0, rec);
    __syncthreads();
    f_row_fma(fsm + (t % F_STAGES) * F_ROW_FLOATS, ws, g, lane, acc);
    // output row t - 2 is complete: its partial sums out, the rows roll
    float4* r4 = reinterpret_cast<float4*>(red) + (g * F_TC + lane) * C;
#pragma unroll
    for (int c = 0; c < C; ++c)
      r4[c] = make_float4(acc[0][0][c], acc[0][1][c], acc[0][2][c], acc[0][3][c]);
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[0][bb][c] = acc[1][bb][c];
        acc[1][bb][c] = acc[2][bb][c];
        acc[2][bb][c] = 0.f;
      }
  }
  // the band's last output row, complete after the last row
  cp_async_wait<0>();
  __syncthreads();
  f_epilogue(red, bias_c, NR - 3, out, b, H, W, i0, j0, rec);
}

}  // namespace

// Plain C entry points (loaded with ctypes), both on the calling thread's
// current device.
//
// conv_out_s2d_init: raise both kernels' dynamic shared memory limits to
// what they need, and ask for the f32 kernel's two blocks an SM; once per
// device, before the first launch.
extern "C" int conv_out_s2d_init() {
  cudaError_t err = cudaFuncSetAttribute(conv_out_s2d_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv_out_s2d_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv_out_s2d_f32_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

// conv_out_s2d_launch: launch on `stream` without synchronising; feat is
// bf16, or f32 where `f32` is nonzero (the f32 kernel); returns
// cudaGetLastError() (0 on success).
extern "C" int conv_out_s2d_launch(const void* feat, const void* weight,
                                   const void* bias, void* out, int B, int H,
                                   int W, int f32, void* stream) {
  if (f32) {
    const dim3 grid((W + F_TC - 1) / F_TC, (H + F_BH - 1) / F_BH, B);
    conv_out_s2d_f32_kernel<<<grid, F_THREADS, F_SMEM, (cudaStream_t)stream>>>(
        static_cast<const float*>(feat), static_cast<const float*>(weight),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W);
    return (int)cudaGetLastError();
  }
  const dim3 grid((W + TC - 1) / TC, (H + BH - 1) / BH, B);
  conv_out_s2d_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(feat), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W);
  return (int)cudaGetLastError();
}
