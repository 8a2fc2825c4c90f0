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
// (conv_out_s2d_f32_kernel, at the end): the same function on f32 features
// and the f32 weights as they are (no rounding to bf16), summed with f32
// FMAs on the CUDA cores, the result rounded to bf16 once.
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
// A block: LR row i, LR columns j0 .. j0 + F_LRC - 1, that is 4 HR rows of
// F_COLS HR columns, one thread an HR pixel.  Its 6 x F_SW staged HR pixels
// (a halo of one) pass through shared memory in chunks of F_KC channels,
// padded to F_PIX floats a pixel so that a quarter warp's float4 reads of 8
// neighbouring pixels hit distinct banks; the weights sit there as one
// float4 (c0, c1, c2, 0) a (u, v, k), read by every thread of a warp at once.
constexpr int F_LRC = 16;                    // LR columns a block
constexpr int F_COLS = 4 * F_LRC;            // HR columns a block
constexpr int F_THREADS = 4 * F_COLS;        // one an HR pixel
constexpr int F_SW = F_COLS + 2;             // staged HR columns
constexpr int F_KC = 16;                     // channels a chunk
constexpr int F_PIX = F_KC + 4;              // floats a staged pixel
constexpr int F_STAGE = 6 * F_SW * F_PIX;    // floats of staged features
constexpr int F_SMEM = (F_STAGE + 9 * K * 4) * 4;
static_assert(F_SMEM <= 48 * 1024, "no opt-in shared memory needed");
static_assert(K % F_KC == 0 && F_COLS % 32 == 0, "whole chunks, one HR row a warp");

__global__ void __launch_bounds__(F_THREADS)
conv_out_s2d_f32_kernel(const float* __restrict__ feat, const float* __restrict__ wgt,
                        const float* __restrict__ bias_g, __nv_bfloat16* __restrict__ out,
                        int H, int W) {
  extern __shared__ __align__(16) float fsm[];
  float4* w4 = reinterpret_cast<float4*>(fsm + F_STAGE);
  const int b = blockIdx.z, i = blockIdx.y, j0 = blockIdx.x * F_LRC;
  const int H4 = 4 * H, W4 = 4 * W, tid = threadIdx.x;
  const float* img = feat + (size_t)b * H4 * W4 * K;
  for (int e = tid; e < 9 * K; e += F_THREADS)  // e = (u * 3 + v) * K + k
    w4[e] = make_float4(__ldg(wgt + C * e), __ldg(wgt + C * e + 1), __ldg(wgt + C * e + 2), 0.f);
  const int a = tid / F_COLS, xl = tid % F_COLS;  // HR row 4i + a, column 4 j0 + xl
  float acc[C] = {0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += F_KC) {
    __syncthreads();  // the previous chunk is read (and the weights written)
    for (int e = tid; e < 6 * F_SW * (F_KC / 4); e += F_THREADS) {
      const int q = e % (F_KC / 4), p = (e / (F_KC / 4)) % F_SW, r = e / (F_KC / 4 * F_SW);
      const int gy = 4 * i - 1 + r, gx = 4 * j0 - 1 + p;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H4 && gx >= 0 && gx < W4)
        v = __ldg(reinterpret_cast<const float4*>(img + ((size_t)gy * W4 + gx) * K + k0) + q);
      *reinterpret_cast<float4*>(fsm + (r * F_SW + p) * F_PIX + 4 * q) = v;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* px = fsm + ((a + tap / 3) * F_SW + xl + tap % 3) * F_PIX;
      const float4* wp = w4 + tap * K + k0;
#pragma unroll
      for (int kq = 0; kq < F_KC / 4; ++kq) {
        const float4 f = *reinterpret_cast<const float4*>(px + 4 * kq);
        const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 w = wp[4 * kq + t];
          acc[0] = fmaf(fs[t], w.x, acc[0]);
          acc[1] = fmaf(fs[t], w.y, acc[1]);
          acc[2] = fmaf(fs[t], w.z, acc[2]);
        }
      }
    }
  }
  const int x = 4 * j0 + xl;
  if (x >= W4) return;
  __nv_bfloat16* o = out + (((size_t)b * H + i) * W + (x >> 2)) * REC + a * 4 + (x & 3);
#pragma unroll
  for (int c = 0; c < C; ++c)
    o[c * 16] = __float2bfloat16_rn(1.f / (1.f + expf(-(acc[c] + __ldg(bias_g + c)))));
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

// conv_out_s2d_launch: launch on `stream` without synchronising; feat is
// bf16, or f32 where `f32` is nonzero (the f32 kernel); returns
// cudaGetLastError() (0 on success).
extern "C" int conv_out_s2d_launch(const void* feat, const void* weight,
                                   const void* bias, void* out, int B, int H,
                                   int W, int f32, void* stream) {
  if (f32) {
    const dim3 grid((W + F_LRC - 1) / F_LRC, H, B);
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
