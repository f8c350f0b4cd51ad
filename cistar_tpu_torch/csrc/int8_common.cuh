// Pieces shared by the port's int8 kernels (int8_resblock.cu: K1/K2,
// int8_atrous.cu: K5/K6): per-image absmax and quantize, the implicit-GEMM
// int8 3x3 conv with its instance-norm statistics epilogue, the IN
// finalize and the IN + skip output pass.
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

// q = clip(rint(x * (127 / max(amax, 1e-6))), -127, 127); scale = amax / 127.
// q is dense: (N, per_image).
template <typename T>
__global__ void quant_kernel(const T* __restrict__ x, long per_image, Sub sub,
                             const float* __restrict__ amax,
                             int8_t* __restrict__ q,
                             float* __restrict__ scale) {
  const int n = blockIdx.y;
  const float a = fmaxf(amax[n], 1e-6f);
  const float inv = __fdiv_rn(127.f, a);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[n] = __fdiv_rn(a, 127.f);
  const long e = (static_cast<long>(blockIdx.x) * EW_THREADS + threadIdx.x) * EW_VEC;
  if (e >= per_image) return;
  float v[EW_VEC];
  load8<T>(x + n * sub.in_per_image + src(e, sub), v);
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) v[i] = __fmul_rn(v[i], inv);
  store8_s8(q + n * per_image + e, v);
}

// Implicit-GEMM 3x3 conv, stride 1, "same" size. xq (N,H,W,Cin) int8; wk
// (Cout, 9*Cin) int8, K-contiguous with k = tap*Cin + cin, tap = 3*ky + kx;
// tap (ky, kx) reads pixel (y + (ky-1)*dil, x + (kx-1)*dil). REFLECT:
// reflect-pad-1 (dil must be 1), the index computed in the loader. Else
// zero padding: a tap outside the image is zero-filled in shared memory and
// nothing outside the tensor is read.
// Tiles: BM pixels x BN couts x BK int8 of K per stage, double-buffered
// cp.async, mma.sync.m16n8k32 s8 -> s32. A K-stage lies inside one tap, so
// Cin % BK == 0; Cout % BN == 0; (H*W) % BM == 0 (a block's rows lie in one
// image). The host launcher checks all three.
// RAW: write the int32 accumulators to acc_out. Else: f = float(acc) *
// (xs[n] * ws[c]) + bias[c] into f (fp32), with per-(image, channel) sum,
// sum of squares and (WANT_MAX) max added to the statistics.
template <int BN, int BK, bool RAW, bool WANT_MAX, bool REFLECT>
__global__ void __launch_bounds__(CONV_THREADS)
conv3x3_s8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wk,
                  const float* __restrict__ xs, const float* __restrict__ ws,
                  const float* __restrict__ bias, int32_t* __restrict__ acc_out,
                  float* __restrict__ f, float* __restrict__ st_sum,
                  float* __restrict__ st_sq, float* __restrict__ st_max, int H,
                  int W, int Cin, int Cout, int dil) {
  constexpr int SROW = BK + 16;  // smem row stride (bytes): conflict-free
                                 // 32-bit fragment loads, 16-byte aligned
  constexpr int CPR = BK / 16;   // 16-byte chunks per smem row
  constexpr int A_ITERS = BM * CPR / CONV_THREADS;
  constexpr int B_CHUNKS = BN * CPR;
  constexpr int B_ITERS = (B_CHUNKS + CONV_THREADS - 1) / CONV_THREADS;
  constexpr int WN = BN / 4;     // columns per warp
  constexpr int NI = WN / 8;     // n fragments per warp
  __shared__ __align__(16) int8_t As[2][BM * SROW];
  __shared__ __align__(16) int8_t Bs[2][BN * SROW];
  __shared__ float red[2][3][BN];

  const int HW = H * W;
  const int K = 9 * Cin;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
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
    const int k0 = kt * BK;
    const int tap = k0 / Cin;
    const int cin0 = k0 - tap * Cin;
    const int dy = (tap / 3 - 1) * dil, dx = (tap % 3 - 1) * dil;
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
          in ? xq + ((static_cast<long>(a_img[i]) * H + yy) * W + xx) * Cin + cin0 + a_col[i]
             : xq;
      cp_async16(&As[buf][a_row[i] * SROW + a_col[i]], s, in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int id = tid + i * CONV_THREADS;
      if (id < B_CHUNKS) {
        const int row = id / CPR, col = (id % CPR) * 16;
        cp_async16(&Bs[buf][row * SROW + col],
                   wk + static_cast<long>(n0 + row) * K + k0 + col);
      }
    }
    cp_async_commit();
  };

  int acc[4][NI][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int KT = K / BK;
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
  }

  // Epilogue. Fragment (mi, ni, r): row = wm*64 + mi*16 + g + 8*(r >> 1),
  // col = wn*WN + ni*8 + 2*t + (r & 1).
  if (RAW) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long row = m0 + wm * 64 + mi * 16 + g + 8 * h;
          const int col = n0 + wn * WN + ni * 8 + 2 * t;
          *reinterpret_cast<int2*>(acc_out + row * Cout + col) =
              make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        }
    return;
  }

  const int img = m0 / HW;
  const float xsc = xs[img];
  float s[NI][2], sq[NI][2], mx[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + wn * WN + ni * 8 + 2 * t + j;
      const float scale = __fmul_rn(xsc, ws[col]);
      const float b = bias[col];
      s[ni][j] = 0.f;
      sq[ni][j] = 0.f;
      mx[ni][j] = -INFINITY;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v =
              __fadd_rn(__fmul_rn(static_cast<float>(acc[mi][ni][2 * h + j]), scale), b);
          acc[mi][ni][2 * h + j] = __float_as_int(v);  // keep v for the store
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
        *reinterpret_cast<float2*>(f + row * Cout + col) =
            make_float2(__int_as_float(acc[mi][ni][2 * h]),
                        __int_as_float(acc[mi][ni][2 * h + 1]));
      }
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
    const long o = static_cast<long>(img) * Cout + n0 + tid;
    atomicAdd(st_sum + o, __fadd_rn(red[0][0][tid], red[1][0][tid]));
    atomicAdd(st_sq + o, __fadd_rn(red[0][1][tid], red[1][1][tid]));
    if (WANT_MAX) atomic_max_float(st_max + o, fmaxf(red[0][2][tid], red[1][2][tid]));
  }
}

// One conv launch. Its operands; the statistics pointers are unused when
// RAW, acc_out unused otherwise.
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
};

bool conv_shape_ok(int n, int h, int w, int cin, int cout) {
  return n > 0 && h >= 2 && w >= 2 && cin % 32 == 0 && cout % 64 == 0 &&
         (h * w) % BM == 0;
}

// Picks the tile: BK 64 where Cin allows it, else 32; BN 128 where Cout
// allows it, else 64.
template <bool RAW, bool WANT_MAX, bool REFLECT>
void launch_conv(const ConvArgs& a, cudaStream_t st) {
  const bool bk64 = a.cin % 64 == 0, bn128 = a.cout % 128 == 0;
  const dim3 grid(static_cast<unsigned>(static_cast<long>(a.n) * a.h * a.w / BM),
                  a.cout / (bn128 ? 128 : 64));
#define CISTAR_CONV(BN_, BK_)                                                    \
  conv3x3_s8_kernel<BN_, BK_, RAW, WANT_MAX, REFLECT><<<grid, CONV_THREADS, 0, st>>>( \
      a.xq, a.wk, a.xs, a.ws, a.bias, a.acc_out, a.f, a.st_sum, a.st_sq,         \
      a.st_max, a.h, a.w, a.cin, a.cout, a.dil)
  if (bk64 && bn128)
    CISTAR_CONV(128, 64);
  else if (bk64)
    CISTAR_CONV(64, 64);
  else if (bn128)
    CISTAR_CONV(128, 32);
  else
    CISTAR_CONV(64, 32);
#undef CISTAR_CONV
}

// IN finalize, one block per row of the (rows, C) statistics (a row is one
// image, or one (branch, image) pair): mean and rsigma per channel; with
// WANT_RMAX also the requantization scale of relu(IN(f)) from max f (K1).
template <bool WANT_RMAX>
__global__ void in_stats_kernel(const float* __restrict__ st_sum,
                                const float* __restrict__ st_sq,
                                const float* __restrict__ st_max, int C,
                                float hw, float eps, float* __restrict__ mean,
                                float* __restrict__ rsig,
                                float* __restrict__ rinv,
                                float* __restrict__ rscale) {
  const int n = blockIdx.x;
  float m = 0.f;
  for (int c = threadIdx.x; c < C; c += EW_THREADS) {
    const long o = static_cast<long>(n) * C + c;
    const float mu = __fdiv_rn(st_sum[o], hw);
    const float msq = __fdiv_rn(st_sq[o], hw);
    const float var = fmaxf(__fsub_rn(msq, __fmul_rn(mu, mu)), 0.f);
    const float rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
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

// out = (f - mean) * rsigma + skip, skip = float(x) (K1, K5) or
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
