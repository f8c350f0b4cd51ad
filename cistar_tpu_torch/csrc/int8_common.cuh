// Pieces shared by the port's int8 kernels (int8_resblock.cu: K1/K2,
// int8_atrous.cu: K5/K6, int8_tiled.cu: K7, int8_msrb.cu: K8): per-image
// absmax and quantize (also straight into the reflect-padded layout that
// the wgmma conv reads), the IN finalize, the IN + ReLU requantize, the IN
// + skip output pass, the epilogue codes and ConvArgs of both convs, and
// the cp.async + mma.sync implicit-GEMM int8 conv (conv_s8_kernel) with
// its epilogues (IN statistics, grouped input scales, ReLU and tile
// maxima). conv_s8_kernel still serves the K1 / K2 / K5 / K6 / K7 / K8
// shapes outside the tile rule of the wgmma + TMA conv (wgmma_conv.cuh),
// K6's 256² stage 1 (32 -> 64 channels) among them.
//
// Numerical rules, each matched to the plain PyTorch versions
// (cistar_tpu_torch/ops/quant_int8.py):
//   * 127/amax is an IEEE division (__fdiv_rn). Never build with
//     --use_fast_math: it would turn it into a multiply by an approximate
//     reciprocal and flip quantized LSBs.
//   * Rounding is rintf (half to even, like torch.round / jnp.round), never
//     roundf (half away from zero).
//   * nvcc contracts a*b+c into an FMA by default; the dequantize and the
//     IN use __fmul_rn / __fadd_rn / __fsub_rn, and the build passes
//     --fmad=false as well, so each op rounds once, as in the plain version.
//   * rsigma is 1 / sqrt(var + eps) with IEEE sqrt and division. The plain
//     version's torch.rsqrt may differ by an ulp on the card.
//   * The statistics are summed with atomics, in an order that changes from
//     run to run; a requantized LSB can flip against the plain version.
//     The int32 accumulators of the conv (the RAW entries) are compared bit
//     for bit.
//
// Everything here has internal linkage: each .cu file is its own library.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;           // conv: output pixels per block
constexpr int CONV_THREADS = 256; // conv: 8 warps, 2 (M) x 4 (N)
constexpr int EW_THREADS = 256;
constexpr int EW_VEC = 8;         // elements per thread in elementwise passes

__device__ __forceinline__ int reflect1(int v, int n) {
  // pad=1 reflection (ReflectionPad2d(1)): -1 -> 1, n -> n-2
  return v < 0 ? -v : (v >= n ? 2 * n - 2 - v : v);
}

// 16-byte async copy; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes = 16) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Max of floats of either sign, through the integer atomics: a value >= 0
// orders like its bits as int, a negative one inversely to its bits as
// unsigned. Memory initialised to 0xFFFFFFFF loses to every value.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide max of a non-negative value into *out (float bits as int).
__device__ __forceinline__ void block_absmax_to(float v, float* out) {
  __shared__ float red[EW_THREADS / 32];
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < EW_THREADS / 32 ? red[lane] : 0.f;
    v = warp_max(v);
    if (lane == 0) atomicMax(reinterpret_cast<int*>(out), __float_as_int(v));
  }
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v);
template <>
__device__ __forceinline__ void load8<float>(const float* p, float* v) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float* v) {
  uint4 r = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}
template <>
__device__ __forceinline__ void load8<int8_t>(const int8_t* p, float* v) {
  uint2 r = reinterpret_cast<const uint2*>(p)[0];
  const int8_t* q = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = static_cast<float>(q[i]);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float* v);
template <>
__device__ __forceinline__ void store8<float>(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float* v) {
  uint4 r;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
  reinterpret_cast<uint4*>(p)[0] = r;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ int8_t to_s8(float v) {
  // clip(rint(v), -127, 127): rintf rounds half to even
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.f), 127.f));
}

__device__ __forceinline__ void store8_s8(int8_t* p, const float* v) {
  uint2 r;
  int8_t* q = reinterpret_cast<int8_t*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = to_s8(v[i]);
  reinterpret_cast<uint2*>(p)[0] = r;
}

// Which pixels of an NHWC image an elementwise pass reads: every pixel
// (stride 1), or x[2i, 2j, :] of a full-resolution image (stride 2, K6).
// Element e of the read image maps to offset src(e) in the full image;
// c % EW_VEC == 0 keeps each vector of EW_VEC elements inside one pixel.
struct Sub {
  int stride;
  int wo;             // width of the read image
  int win;            // width of the full image
  int c;              // channels
  long in_per_image;  // elements of one full image
};

__host__ __device__ inline Sub dense(long per_image) {
  return Sub{1, 1, 1, 1, per_image};
}

__device__ __forceinline__ long src(long e, const Sub& s) {
  if (s.stride == 1) return e;
  const long p = e / s.c;
  const int c = static_cast<int>(e - p * s.c);
  const long i = p / s.wo, j = p - i * s.wo;
  return (s.stride * i * s.win + s.stride * j) * s.c + c;
}

// grid (x: chunks of one image, y: image); per_image: elements read per image
template <typename T>
__global__ void absmax_kernel(const T* __restrict__ x, long per_image, Sub sub,
                              float* __restrict__ amax) {
  const int n = blockIdx.y;
  const T* xi = x + n * sub.in_per_image;
  float m = 0.f;
  for (long e = (static_cast<long>(blockIdx.x) * EW_THREADS + threadIdx.x) * EW_VEC;
       e < per_image; e += static_cast<long>(gridDim.x) * EW_THREADS * EW_VEC) {
    float v[EW_VEC];
    load8<T>(xi + src(e, sub), v);
#pragma unroll
    for (int i = 0; i < EW_VEC; ++i) m = fmaxf(m, fabsf(v[i]));
  }
  block_absmax_to(m, amax + n);
}

// A grid of absmax_kernel for small batches (K7a): blocks enough for 8 an
// SM of an H100 over the batch, at least 16 an image, each with a vector
// of every thread to read. A block keeps one load a thread in flight, so
// (16, n) blocks leave the card mostly idle at a batch of 2-8.
dim3 absmax_grid(long per_image, int n) {
  const long per_block = static_cast<long>(EW_THREADS) * EW_VEC;
  const long most = (per_image + per_block - 1) / per_block;
  long x = (8L * 132 + n - 1) / n;
  if (x < 16) x = 16;
  if (x > most) x = most;
  return dim3(static_cast<unsigned>(x), n);
}

// q = clip(rint(x * (127 / max(amax, 1e-6))), -127, 127); scale = amax / 127.
// q is dense: (N, per_image). With ct > 0 the scales are per (image, tile
// of ct channels): amax and scale are (N, C / ct) and sub.c is C.
template <typename T>
__global__ void quant_kernel(const T* __restrict__ x, long per_image, Sub sub,
                             const float* __restrict__ amax,
                             int8_t* __restrict__ q,
                             float* __restrict__ scale, int ct = 0) {
  const int n = blockIdx.y;
  const long e = (static_cast<long>(blockIdx.x) * EW_THREADS + threadIdx.x) * EW_VEC;
  int k = n;  // which scale
  if (ct > 0) {
    const int tiles = sub.c / ct;
    k = n * tiles + static_cast<int>(e % sub.c) / ct;
    if (blockIdx.x == 0 && threadIdx.x < tiles)
      scale[n * tiles + threadIdx.x] =
          __fdiv_rn(fmaxf(amax[n * tiles + threadIdx.x], 1e-6f), 127.f);
  } else if (blockIdx.x == 0 && threadIdx.x == 0) {
    scale[n] = __fdiv_rn(fmaxf(amax[n], 1e-6f), 127.f);
  }
  if (e >= per_image) return;
  const float inv = __fdiv_rn(127.f, fmaxf(amax[k], 1e-6f));
  float v[EW_VEC];
  load8<T>(x + n * sub.in_per_image + src(e, sub), v);
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) v[i] = __fmul_rn(v[i], inv);
  store8_s8(q + n * per_image + e, v);
}

// Stores the 8 int8 values of element e of an (H, W, C) image into its
// reflect-pad-1 copy qp (H+2, W+2, C): at (y+1, x+1), and at each border
// position that reflects onto (y, x) (row 0 reflects row 1, row H+1 row
// H-2; columns the same).
__device__ __forceinline__ void store8_s8_padded(int8_t* qp, long e, int h, int w, int c,
                                                 const float* v) {
  const long p = e / c;
  const int ch = static_cast<int>(e - p * c);
  const int y = static_cast<int>(p / w), x = static_cast<int>(p - (p / w) * w);
  uint2 r;
  int8_t* b = reinterpret_cast<int8_t*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = to_s8(v[i]);
  const int ys[3] = {y + 1, y == 1 ? 0 : -1, y == h - 2 ? h + 1 : -1};
  const int xs[3] = {x + 1, x == 1 ? 0 : -1, x == w - 2 ? w + 1 : -1};
#pragma unroll
  for (int iy = 0; iy < 3; ++iy)
#pragma unroll
    for (int ix = 0; ix < 3; ++ix)
      if (ys[iy] >= 0 && xs[ix] >= 0)
        *reinterpret_cast<uint2*>(qp + (static_cast<long>(ys[iy]) * (w + 2) + xs[ix]) * c +
                                  ch) = r;
}

// quant_kernel (one scale per image, dense x) into the padded layout (K1,
// K7a: the block input; K5: its branch sum).
template <typename T>
__global__ void quant_pad_kernel(const T* __restrict__ x, long per_image,
                                 const float* __restrict__ amax, int8_t* __restrict__ qp,
                                 float* __restrict__ scale, int h, int w, int c) {
  const int n = blockIdx.y;
  const long e = (static_cast<long>(blockIdx.x) * EW_THREADS + threadIdx.x) * EW_VEC;
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[n] = __fdiv_rn(fmaxf(amax[n], 1e-6f), 127.f);
  if (e >= per_image) return;
  const float inv = __fdiv_rn(127.f, fmaxf(amax[n], 1e-6f));
  float v[EW_VEC];
  load8<T>(x + n * per_image + e, v);
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) v[i] = __fmul_rn(v[i], inv);
  store8_s8_padded(qp + static_cast<long>(n) * (h + 2) * (w + 2) * c, e, h, w, c, v);
}

// What a conv launch does with its accumulators.
//   EPI_RAW     write the int32 accumulators of each input group to acc_out
//               (groups, N*H*W, Cout)
//   EPI_STATS   f = float(acc) * (xs[n] * ws[c]) + bias[c] into f (fp32), with
//               per-(image, channel) sum, sum of squares and (WANT_MAX) max
//               added to the statistics (K1, K2, K5, K6, K7a)
//   EPI_GSTATS  f = (sum_g float(acc_g) * gs[n, g]) * ws[c] + bias[c], the
//               group sum in fp32 in group order; the statistics as above (K7b)
//   With st_sum null (the BatchNorm forms of K1 / K7, whose norm is folded
//   into ws and bias), EPI_STATS / EPI_GSTATS write f and add no sum, only
//   the max where WANT_MAX.
//   EPI_GRELU   the same f, then ReLU. WANT_MAX: f into f (fp32) and its max
//               per (image, tile of ct channels) into st_max; else f into out
//               as TO (K8)
//   wg_branch_kernel only (K6's two passes, wgmma_conv.cuh):
//   EPI_BSTATS  each branch's sum and sum of squares of f; no f written
//   EPI_BSUM    sum_b relu((f_b - mean_b) * rsig_b) in branch order, into out
//               as TO
//   wg_conv_kernel, bf16 operands only (K10, conv_s2.cu):
//   EPI_BF16    bf16(bf16(acc) + bf16(bias[c])) into out (bf16), the plain
//               bf16 conv's two roundings; no statistics
enum Epi {
  EPI_RAW = 0,
  EPI_STATS = 1,
  EPI_GSTATS = 2,
  EPI_GRELU = 3,
  EPI_BSTATS = 4,
  EPI_BSUM = 5,
  EPI_BF16 = 6
};

// One conv launch. Its operands; the pointers an epilogue does not use may
// be null.
struct ConvArgs {
  const int8_t* xq;
  const int8_t* wk;
  const float* xs;
  const float* ws;
  const float* bias;
  int32_t* acc_out;
  float* f;
  float* st_sum;
  float* st_sq;
  float* st_max;
  int n, h, w, cin, cout, dil;
  const float* gs = nullptr;  // (N, groups) scale of each input group
  void* out = nullptr;        // EPI_GRELU without WANT_MAX; EPI_BF16
  int groups = 1;             // input channel groups, each cin / groups wide
  int ct = 0;                 // EPI_GRELU with WANT_MAX: tile of st_max
  // wg_conv_kernel (EPI_STATS) and wg_branch_kernel: branches > 1 convs of
  // xq in one launch (K5's and K6's four), branch b at dilation bdil[b]
  // (dil unused) with weight rows b*cout .. of wk, ws / bias at +
  // b*sb_stride, f at + b*n*h*w*cout and the statistics at + b*n*cout.
  int branches = 1;
  int bdil[4] = {1, 1, 1, 1};
  int sb_stride = 0;
  // EPI_BSUM: each branch's IN statistics, (branches, N, Cout)
  const float* mean = nullptr;
  const float* rsig = nullptr;
  // wg_branch_kernel: wk as one swizzled B tile a K stage
  // (branch_weights_kernel), each loaded by one bulk copy; the halo of xq
  // loaded with each tile, at least the largest bdil
  const int8_t* wbulk = nullptr;
  int hpad = 0;
};

// Implicit-GEMM KKxKK conv, stride 1, "same" size. xq (N,H,W,Cin) int8; wk
// (Cout, KK*KK*Cin) int8, K-contiguous with k = tap*Cin + cin, tap =
// KK*ky + kx; tap (ky, kx) reads pixel (y + (ky - KK/2)*dil, x + (kx -
// KK/2)*dil). REFLECT: reflect-pad-1 (KK 3, dil 1), the index computed in
// the loader. Else zero padding: a tap outside the image is zero-filled in
// shared memory and nothing outside the tensor is read.
// The K loop runs group by group (cin = groups x cg channels), and inside
// a group tap by tap: each group's exact int32 partial is flushed when its
// last K-stage is done (written out, or added in fp32 times the group's
// scale), and the next group starts again from 0. With one group this is
// the plain tap-major K loop.
// Tiles: BM pixels x BN couts x BK int8 of K per stage, double-buffered
// cp.async, mma.sync.m16n8k32 s8 -> s32. A K-stage lies inside one tap and
// one group, so cg % BK == 0; Cout % BN == 0; (H*W) % BM == 0 (a block's
// rows lie in one image). The host launcher checks all three.
template <int BN, int BK, int KK, int EPI, bool WANT_MAX, bool REFLECT, typename TO>
__global__ void __launch_bounds__(CONV_THREADS) conv_s8_kernel(const ConvArgs a) {
  constexpr int SROW = BK + 16;  // smem row stride (bytes): conflict-free
                                 // 32-bit fragment loads, 16-byte aligned
  constexpr int CPR = BK / 16;   // 16-byte chunks per smem row
  constexpr int A_ITERS = BM * CPR / CONV_THREADS;
  constexpr int B_CHUNKS = BN * CPR;
  constexpr int B_ITERS = (B_CHUNKS + CONV_THREADS - 1) / CONV_THREADS;
  constexpr int WN = BN / 4;     // columns per warp
  constexpr int NI = WN / 8;     // n fragments per warp
  constexpr bool GROUPED = EPI == EPI_GSTATS || EPI == EPI_GRELU;
  __shared__ __align__(16) int8_t As[2][BM * SROW];
  __shared__ __align__(16) int8_t Bs[2][BN * SROW];
  __shared__ float red[2][3][BN];

  const int H = a.h, W = a.w, Cin = a.cin, Cout = a.cout;
  const int HW = H * W;
  const long K = static_cast<long>(KK) * KK * Cin;
  const int cg = Cin / a.groups;
  const int CPG = cg / BK;          // K-stages per tap of one group
  const int SPG = KK * KK * CPG;    // K-stages per group
  const int KT = a.groups * SPG;
  const long M = static_cast<long>(a.n) * HW;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int img = m0 / HW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;

  int a_img[A_ITERS], a_y[A_ITERS], a_x[A_ITERS], a_col[A_ITERS], a_row[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int id = tid + i * CONV_THREADS;
    a_row[i] = id / CPR;
    a_col[i] = (id % CPR) * 16;
    const int m = m0 + a_row[i];
    a_img[i] = m / HW;
    const int rem = m - a_img[i] * HW;
    a_y[i] = rem / W;
    a_x[i] = rem - a_y[i] * W;
  }

  auto load_stage = [&](int kt, int buf) {
    const int grp = kt / SPG;
    const int r = kt - grp * SPG;
    const int tap = r / CPG;
    const int cin0 = grp * cg + (r - tap * CPG) * BK;
    const int dy = (tap / KK - KK / 2) * a.dil, dx = (tap % KK - KK / 2) * a.dil;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      int yy = a_y[i] + dy, xx = a_x[i] + dx;
      bool in = true;
      if (REFLECT) {
        yy = reflect1(yy, H);
        xx = reflect1(xx, W);
      } else {
        in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      }
      const int8_t* s =
          in ? a.xq + ((static_cast<long>(a_img[i]) * H + yy) * W + xx) * Cin + cin0 + a_col[i]
             : a.xq;
      cp_async16(&As[buf][a_row[i] * SROW + a_col[i]], s, in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int id = tid + i * CONV_THREADS;
      if (id < B_CHUNKS) {
        const int row = id / CPR, col = (id % CPR) * 16;
        cp_async16(&Bs[buf][row * SROW + col],
                   a.wk + static_cast<long>(n0 + row) * K + static_cast<long>(tap) * Cin +
                       cin0 + col);
      }
    }
    cp_async_commit();
  };

  // Fragment (mi, ni, r): row = wm*64 + mi*16 + g + 8*(r >> 1),
  // col = wn*WN + ni*8 + 2*t + (r & 1).
  int acc[4][NI][4];
  float fv[4][NI][4];  // the group sum, then the epilogue's values
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[i][j][r] = 0;
        fv[i][j][r] = 0.f;
      }

  load_stage(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) {
      load_stage(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* as = As[buf];
    const int8_t* bs = Bs[buf];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[4][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const unsigned*>(as + r * SROW + kk + t * 4);
        af[mi][1] = *reinterpret_cast<const unsigned*>(as + (r + 8) * SROW + kk + t * 4);
        af[mi][2] = *reinterpret_cast<const unsigned*>(as + r * SROW + kk + 16 + t * 4);
        af[mi][3] = *reinterpret_cast<const unsigned*>(as + (r + 8) * SROW + kk + 16 + t * 4);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int c = wn * WN + ni * 8 + g;
        bf[ni][0] = *reinterpret_cast<const unsigned*>(bs + c * SROW + kk + t * 4);
        bf[ni][1] = *reinterpret_cast<const unsigned*>(bs + c * SROW + kk + 16 + t * 4);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_s8(acc[mi][ni], af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                 bf[ni][0], bf[ni][1]);
    }
    __syncthreads();
    if ((EPI == EPI_RAW || GROUPED) && (kt + 1) % SPG == 0) {
      // the last K-stage of group grp: flush its exact int32 partial
      const int grp = kt / SPG;
      const float gsc = GROUPED ? a.gs[img * a.groups + grp] : 0.f;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          if (EPI == EPI_RAW) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const long row = m0 + wm * 64 + mi * 16 + g + 8 * h;
              const int col = n0 + wn * WN + ni * 8 + 2 * t;
              *reinterpret_cast<int2*>(a.acc_out + (grp * M + row) * Cout + col) =
                  make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
            }
          } else {
#pragma unroll
            for (int r = 0; r < 4; ++r)
              fv[mi][ni][r] = __fadd_rn(
                  fv[mi][ni][r], __fmul_rn(static_cast<float>(acc[mi][ni][r]), gsc));
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
        }
    }
  }
  if (EPI == EPI_RAW) return;

  // Epilogue: the dequantized value of each fragment element into fv.
  const float xsc = EPI == EPI_STATS ? a.xs[img] : 0.f;
  float s[NI][2], sq[NI][2], mx[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + wn * WN + ni * 8 + 2 * t + j;
      const float scale = EPI == EPI_STATS ? __fmul_rn(xsc, a.ws[col]) : a.ws[col];
      const float b = a.bias[col];
      s[ni][j] = 0.f;
      sq[ni][j] = 0.f;
      mx[ni][j] = -INFINITY;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float in = EPI == EPI_STATS ? static_cast<float>(acc[mi][ni][2 * h + j])
                                            : fv[mi][ni][2 * h + j];
          float v = __fadd_rn(__fmul_rn(in, scale), b);
          if (EPI == EPI_GRELU) v = fmaxf(v, 0.f);
          fv[mi][ni][2 * h + j] = v;
          s[ni][j] = __fadd_rn(s[ni][j], v);
          sq[ni][j] = __fadd_rn(sq[ni][j], __fmul_rn(v, v));
          mx[ni][j] = fmaxf(mx[ni][j], v);
        }
    }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long row = m0 + wm * 64 + mi * 16 + g + 8 * h;
        const int col = n0 + wn * WN + ni * 8 + 2 * t;
        if (EPI == EPI_GRELU && !WANT_MAX)
          store2(static_cast<TO*>(a.out) + row * Cout + col, fv[mi][ni][2 * h],
                 fv[mi][ni][2 * h + 1]);
        else
          store2(a.f + row * Cout + col, fv[mi][ni][2 * h], fv[mi][ni][2 * h + 1]);
      }
  if (EPI == EPI_GRELU && !WANT_MAX) return;
  const bool sums = a.st_sum != nullptr;
  if (!sums && !WANT_MAX) return;
  // Reduce over the 8 row groups of the warp (lane bits 2..4) ...
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s[ni][j] = __fadd_rn(s[ni][j], __shfl_xor_sync(0xffffffffu, s[ni][j], o));
        sq[ni][j] = __fadd_rn(sq[ni][j], __shfl_xor_sync(0xffffffffu, sq[ni][j], o));
        mx[ni][j] = fmaxf(mx[ni][j], __shfl_xor_sync(0xffffffffu, mx[ni][j], o));
      }
  // ... then over the two warps that share a column, then into global.
  if (g == 0) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * WN + ni * 8 + 2 * t + j;
        red[wm][0][c] = s[ni][j];
        red[wm][1][c] = sq[ni][j];
        red[wm][2][c] = mx[ni][j];
      }
  }
  __syncthreads();
  if (tid < BN) {
    const float m = fmaxf(red[0][2][tid], red[1][2][tid]);
    if (EPI == EPI_GRELU) {
      // m >= 0 after the ReLU: its bits order like ints
      const int col = n0 + tid;
      atomicMax(reinterpret_cast<int*>(a.st_max + static_cast<long>(img) * (Cout / a.ct) +
                                       col / a.ct),
                __float_as_int(m));
      return;
    }
    const long o = static_cast<long>(img) * Cout + n0 + tid;
    if (sums) {
      atomicAdd(a.st_sum + o, __fadd_rn(red[0][0][tid], red[1][0][tid]));
      atomicAdd(a.st_sq + o, __fadd_rn(red[0][1][tid], red[1][1][tid]));
    }
    if (WANT_MAX) atomic_max_float(a.st_max + o, m);
  }
}

bool conv_shape_ok(int n, int h, int w, int cin, int cout) {
  return n > 0 && h >= 2 && w >= 2 && cin % 32 == 0 && cout % 64 == 0 &&
         (h * w) % BM == 0;
}

// The widest tiles only (BN 128, BK 64): the grouped entries (K7, K8)
// take cin / groups % 64 == 0 and Cout % 128 == 0, and instantiate nothing
// else.
bool wide_shape_ok(int n, int h, int w, int cin, int cout, int groups) {
  return groups > 0 && cin % groups == 0 && (cin / groups) % 64 == 0 &&
         cout % 128 == 0 && conv_shape_ok(n, h, w, cin, cout);
}

#define CISTAR_CONV(BN_, BK_)                                                    \
  conv_s8_kernel<BN_, BK_, KK, EPI, WANT_MAX, REFLECT, TO>                     \
      <<<dim3(static_cast<unsigned>(static_cast<long>(a.n) * a.h * a.w / BM),   \
              a.cout / BN_),                                                     \
         CONV_THREADS, 0, st>>>(a)

// Picks the tile: BK 64 where the group width allows it, else 32; BN 128
// where Cout allows it, else 64.
template <int EPI, bool WANT_MAX, bool REFLECT, int KK = 3, typename TO = float>
void launch_conv(const ConvArgs& a, cudaStream_t st) {
  const bool bk64 = (a.cin / a.groups) % 64 == 0, bn128 = a.cout % 128 == 0;
  if (bk64 && bn128)
    CISTAR_CONV(128, 64);
  else if (bk64)
    CISTAR_CONV(64, 64);
  else if (bn128)
    CISTAR_CONV(128, 32);
  else
    CISTAR_CONV(64, 32);
}

// BN 128, BK 64 only (wide_shape_ok).
template <int EPI, bool WANT_MAX, bool REFLECT, int KK = 3, typename TO = float>
void launch_conv_wide(const ConvArgs& a, cudaStream_t st) {
  CISTAR_CONV(128, 64);
}
#undef CISTAR_CONV

// IN finalize, one block per row of the (rows, C) statistics (a row is one
// image, one (branch, image) pair, or one (image, tile of C channels) of a
// wider image): mean and rsigma per channel; with WANT_RMAX also the
// requantization scale of relu(IN(f)) of the row from max f (K1, K7a).
// bn: the BatchNorm forms (K1 / K7 with bn=True), whose affine is already
// in f; mean 0 and rsigma 1, which the passes below apply exactly ((f - 0)
// * 1 == f), and the scale from max(0, max_c max f_c), exact as well since
// ReLU is monotone.
template <bool WANT_RMAX>
__global__ void in_stats_kernel(const float* __restrict__ st_sum,
                                const float* __restrict__ st_sq,
                                const float* __restrict__ st_max, int C,
                                float hw, float eps, float* __restrict__ mean,
                                float* __restrict__ rsig,
                                float* __restrict__ rinv,
                                float* __restrict__ rscale, bool bn = false) {
  const int n = blockIdx.x;
  float m = 0.f;
  for (int c = threadIdx.x; c < C; c += EW_THREADS) {
    const long o = static_cast<long>(n) * C + c;
    float mu = 0.f, rs = 1.f;
    if (!bn) {
      mu = __fdiv_rn(st_sum[o], hw);
      const float msq = __fdiv_rn(st_sq[o], hw);
      const float var = fmaxf(__fsub_rn(msq, __fmul_rn(mu, mu)), 0.f);
      rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    }
    mean[o] = mu;
    rsig[o] = rs;
    if (WANT_RMAX) m = fmaxf(m, fmaxf(__fmul_rn(__fsub_rn(st_max[o], mu), rs), 0.f));
  }
  if (WANT_RMAX) {
    __shared__ float amax;
    if (threadIdx.x == 0) amax = 0.f;
    __syncthreads();
    block_absmax_to(m, &amax);
    __syncthreads();
    if (threadIdx.x == 0) {
      const float a = fmaxf(amax, 1e-6f);
      rinv[n] = __fdiv_rn(127.f, a);
      rscale[n] = __fdiv_rn(a, 127.f);
    }
  }
}

// rq = clip(rint(relu((f - mean) * rsigma) * rinv), -127, 127), rinv per
// (image, tile of ct channels): ct = C for one scale per image (K1), a
// divisor of C for per-tile scales (K7a).
__global__ void in_relu_quant_kernel(const float* __restrict__ f, long per_image,
                                     int C, int ct, const float* __restrict__ mean,
                                     const float* __restrict__ rsig,
                                     const float* __restrict__ rinv,
                                     int8_t* __restrict__ q) {
  const int n = blockIdx.y;
  const long e = (static_cast<long>(blockIdx.x) * EW_THREADS + threadIdx.x) * EW_VEC;
  if (e >= per_image) return;
  const int c0 = static_cast<int>(e % C);
  const float inv = rinv[n * (C / ct) + c0 / ct];
  const float* mu = mean + static_cast<long>(n) * C + c0;
  const float* rs = rsig + static_cast<long>(n) * C + c0;
  float v[EW_VEC];
  load8<float>(f + n * per_image + e, v);
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i)
    v[i] = __fmul_rn(fmaxf(__fmul_rn(__fsub_rn(v[i], mu[i]), rs[i]), 0.f), inv);
  store8_s8(q + n * per_image + e, v);
}

// out = (f - mean) * rsigma + skip, skip = float(x) (K1, K5, K7b) or
// float(xq) * xscale[n] (K2, TS = int8). K2 writes fp32 hnew in place of f
// and adds its per-image absmax to amax.
template <typename TS, typename TO, bool ABSMAX>
__global__ void in_skip_out_kernel(const float* f, long per_image, int C,
                                   const float* __restrict__ mean,
                                   const float* __restrict__ rsig,
                                   const TS* __restrict__ skip,
                                   const float* __restrict__ xscale, TO* out,
                                   float* __restrict__ amax) {
  const int n = blockIdx.y;
  const long e = (static_cast<long>(blockIdx.x) * EW_THREADS + threadIdx.x) * EW_VEC;
  float m = 0.f;
  if (e < per_image) {
    const int c0 = static_cast<int>(e % C);
    const float* mu = mean + static_cast<long>(n) * C + c0;
    const float* rs = rsig + static_cast<long>(n) * C + c0;
    float v[EW_VEC], sk[EW_VEC];
    load8<float>(f + n * per_image + e, v);
    load8<TS>(skip + n * per_image + e, sk);
    const float xsc = xscale != nullptr ? xscale[n] : 1.f;
#pragma unroll
    for (int i = 0; i < EW_VEC; ++i) {
      const float s = xscale != nullptr ? __fmul_rn(sk[i], xsc) : sk[i];
      v[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[i], mu[i]), rs[i]), s);
      m = fmaxf(m, fabsf(v[i]));
    }
    store8<TO>(out + n * per_image + e, v);
  }
  if (ABSMAX) block_absmax_to(m, amax + n);
}

size_t align256(size_t b) { return (b + 255) & ~static_cast<size_t>(255); }

// Carves consecutive 256-aligned pieces out of a workspace; with a null
// base it only counts the bytes.
struct Carver {
  char* base;
  size_t off = 0;
  template <typename T>
  T* take(size_t bytes) {
    char* p = base != nullptr ? base + off : nullptr;
    off += align256(bytes);
    return reinterpret_cast<T*>(p);
  }
};

dim3 ew_grid(long per_image, int n) {
  const long per_block = static_cast<long>(EW_THREADS) * EW_VEC;
  return dim3(static_cast<unsigned>((per_image + per_block - 1) / per_block), n);
}

}  // namespace
