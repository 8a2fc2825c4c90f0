// conv_out + bias + TecoGAN's bicubic 4x skip + space-to-depth, fused, for
// Hopper (sm_90a): the output layer of TecoGAN as published
// (github.com/thunil/TecoGAN, lib/frvsr.py's generator_F: conv 64 -> 3,
// plus bicubic_four of the LR frame, no sigmoid).
//
// Replaces no Pallas kernel (the JAX package serves no bicubic skip).  It
// is conv_out_s2d.cu's bf16 kernel with another epilogue: the design, the
// tiling and what bounds it are that file's, which says them in full.
//
// Contract (NHWC):
//   feat  (B, 4H, 4W, 64) bf16, contiguous
//   w     (3, 3, 64, 3)   f32 HWIO, contiguous; rounded to bf16 on load
//   bias  (3,)            f32
//   lr    (B, H, W, 3)    f32, contiguous: the LR frame in [0, 1]
//   out   (B, H, W, 48)   f32
//   out[b, i, j, c*16 + a*4 + bb] = bias[c]
//       + sum_{u,v,k} feat[b, 4i+a+u-1, 4j+bb+v-1, k] * bf16(w[u, v, k, c])
//       + bicubic_four(lr)[b, 4i+a, 4j+bb, c]
// with zero padding outside the image and f32 sums, neither rounded to bf16
// nor clamped: the published recurrence feeds the frame back unclamped,
// and the served uint8 frame is cut from it.
// bicubic_four is lib/ops.py's: Keys' cubic convolution with a = -0.75 at
// offsets 0, 1/4, 1/2 and 3/4, rows first (v[n] = w0*x[i-1] + w1*x[i] +
// w2*x[i+1] + w3*x[i+2] on LR column j-1+n), then columns, the edge rows
// and columns repeated; each of its products and sums rounded as the plain
// version's torch ops round them (ops/kernels/conv_out_bicubic_s2d.py).
//
// What bounds it: at 1080p the 265.42 MB of bf16 features, the 1.56 MB LR
// frame and the 24.88 MB result, 291.86 MB: 0.0871 ms at 3.35 TB/s.
//
// The skip: the bicubic row of output row e is made at the band step
// before its epilogue (step e + 2), by the block's last 90 threads (one
// channel and one LR column each: 16 LR loads, 4 vertical and 4 x 4
// horizontal sums), into one of two shared rows; the epilogue of step
// e + 3 adds it after the barrier.  The LR frame's loads are small and
// L1-resident (a block's strip is 33 x 20 LR pixels).

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
constexpr int REC_BYTES = TC * REC * 4;
constexpr int BIC_FLOATS = C * 4 * TC;   // one output row's skip values
constexpr int BIC_OFF = RING_BYTES + 2 * ZS_BYTES + 2 * REC_BYTES;
constexpr int SMEM_BYTES = BIC_OFF + 2 * BIC_FLOATS * 4;
constexpr int BIC_TASKS = C * TC;        // (channel, LR column) tasks a row

// bicubic_four's taps at offsets 0, 1/4, 1/2, 3/4 (exact in f32)
__constant__ float BIC_W[4][4] = {{0.f, 1.f, 0.f, 0.f},
                                  {-0.10546875f, 0.87890625f, 0.26171875f, -0.03515625f},
                                  {-0.09375f, 0.59375f, 0.59375f, -0.09375f},
                                  {-0.03515625f, 0.26171875f, 0.87890625f, -0.10546875f}};

static_assert(THREADS % CHUNKS == 0 && MROWS * CHUNKS % THREADS == 0,
              "whole copies per thread, one chunk index a thread");
static_assert(ZS_BYTES % 16 == 0 && RING_BYTES % 16 == 0, "alignment");
static_assert(REC * 4 % 16 == 0, "LR records must be whole 16-byte pieces");
static_assert(BIC_OFF % 16 == 0 && BIC_TASKS <= THREADS, "skip rows: alignment, one task a thread");

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
  const float* lr;           // this image's LR frame
  float* out;
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
// sums in zs, the bias and the skip row bic, into slot e % 4 of the s2d
// records of its LR row; one (channel, HR column) a task, spread over the
// block.
__device__ __forceinline__ void epilogue(const Band& s, int e, const float* zs, const float* bic,
                                         const float (&bias)[C]) {
  float* rec = reinterpret_cast<float*>(s.smem + RING_BYTES + 2 * ZS_BYTES) +
               ((e >> 2) & 1) * TC * REC;
  for (int task = threadIdx.x; task < C * 4 * TC; task += THREADS) {
    const int c = task / (4 * TC);
    const int xl = task % (4 * TC);  // HR column 4*j0 + xl, staged at slot xl + 1
    const float* z = zs + xl * ZS + c;
    const float y = (c == 0 ? bias[0] : c == 1 ? bias[1] : bias[2]) + z[0] + z[ZS + 3] +
                    z[2 * ZS + 6];
    rec[(xl >> 2) * REC + c * 16 + (e & 3) * 4 + (xl & 3)] = y + bic[task];
  }
}

__device__ __forceinline__ float taps4(const float (&w)[4], float x0, float x1, float x2,
                                       float x3) {
  float s = __fadd_rn(__fmul_rn(w[0], x0), __fmul_rn(w[1], x1));
  s = __fadd_rn(s, __fmul_rn(w[2], x2));
  return __fadd_rn(s, __fmul_rn(w[3], x3));
}

// The skip row of output row e into bic (channel-major, HR columns of the
// strip): the block's last BIC_TASKS threads, one (channel, LR column) each.
__device__ __forceinline__ void bicubic_row(const Band& s, int e, float* bic) {
  const int task = threadIdx.x - (THREADS - BIC_TASKS);
  if (task < 0) return;
  const int c = task / TC, jl = task % TC;
  const int j = s.j0 + jl;
  if (j >= s.W) return;
  const int i = s.i0 + (e >> 2), a = e & 3;
  float wy[4], wx[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) wy[m] = BIC_W[a][m];
#pragma unroll
  for (int bb = 0; bb < 4; ++bb)
#pragma unroll
    for (int m = 0; m < 4; ++m) wx[bb][m] = BIC_W[bb][m];
  const float* rows[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) rows[m] = s.lr + (size_t)min(max(i - 1 + m, 0), s.H - 1) * s.W * C;
  float v[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int col = min(max(j - 1 + n, 0), s.W - 1) * C + c;
    v[n] = taps4(wy, __ldg(rows[0] + col), __ldg(rows[1] + col), __ldg(rows[2] + col),
                 __ldg(rows[3] + col));
  }
  float4 h;
  h.x = taps4(wx[0], v[0], v[1], v[2], v[3]);
  h.y = taps4(wx[1], v[0], v[1], v[2], v[3]);
  h.z = taps4(wx[2], v[0], v[1], v[2], v[3]);
  h.w = taps4(wx[3], v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(bic + c * 4 * TC)[jl] = h;
}

// Store the strip's records of band LR row li as one contiguous run.
__device__ __forceinline__ void store_row(const Band& s, int li) {
  const uint4* src = reinterpret_cast<const uint4*>(s.smem + RING_BYTES + 2 * ZS_BYTES) +
                     (li & 1) * (REC_BYTES / 16);
  uint4* dst = reinterpret_cast<uint4*>(
      s.out + (((size_t)s.b * s.H + s.i0 + li) * s.W + s.j0) * REC);
  const int n = min(TC, s.W - s.j0) * (REC * 4 / 16);
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
// epilogue at step t with the skip row made at step t - 1 (two buffers),
// and an LR row's records (two buffers) are stored at the step after its
// last sub-row.
template <int P>
__device__ __forceinline__ void band_row(const Band& s, int t, Warp& r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* zs = reinterpret_cast<float*>(s.smem + RING_BYTES);
  cp_async_wait<STAGES - 2>();  // row t has landed (this thread's copies)
  __syncthreads();              // ... everyone's; row t - 1's slot is free
  if (t + STAGES - 1 < s.NR) stage_row(s, t + STAGES - 1);
  cp_async_commit();
  if (t >= 4 && ((t - 4) & 3) == 3) store_row(s, (t - 4) >> 2);
  float* bic = reinterpret_cast<float*>(s.smem + BIC_OFF);
  if (t >= 3)
    epilogue(s, t - 3, zs + ((t - 1) & 1) * (MROWS * ZS), bic + ((t - 3) & 1) * BIC_FLOATS,
             r.bias);
  if (t >= 2) bicubic_row(s, t - 2, bic + ((t - 2) & 1) * BIC_FLOATS);

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
conv_out_bicubic_kernel(const __nv_bfloat16* __restrict__ feat,
                        const float* __restrict__ wgt,
                        const float* __restrict__ bias_g,
                        const float* __restrict__ lr,
                        float* __restrict__ out, int H, int W) {
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
  s.lr = lr + (size_t)s.b * H * W * C;
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
  epilogue(s, s.NR - 3,
           reinterpret_cast<const float*>(smem + RING_BYTES) + ((s.NR - 1) & 1) * (MROWS * ZS),
           reinterpret_cast<const float*>(smem + BIC_OFF) + ((s.NR - 3) & 1) * BIC_FLOATS,
           r.bias);
  __syncthreads();
  store_row(s, s.nb - 1);
}

}  // namespace

// Plain C entry points (loaded with ctypes), both on the calling thread's
// current device.
//
// conv_out_bicubic_s2d_init: raise the kernel's dynamic shared memory
// limit to what it needs; once per device, before the first launch.
extern "C" int conv_out_bicubic_s2d_init() {
  return (int)cudaFuncSetAttribute(conv_out_bicubic_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

// conv_out_bicubic_s2d_launch: launch on `stream` without synchronising;
// returns cudaGetLastError() (0 on success).
extern "C" int conv_out_bicubic_s2d_launch(const void* feat, const void* weight,
                                           const void* bias, const void* lr, void* out,
                                           int B, int H, int W, void* stream) {
  const dim3 grid((W + TC - 1) / TC, (H + BH - 1) / BH, B);
  conv_out_bicubic_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(feat), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<const float*>(lr),
      static_cast<float*>(out), H, W);
  return (int)cudaGetLastError();
}
