// Int8 residual blocks for Hopper (sm_90a): K1 and K2 of the port.
//
// Replaces the TPU kernels
//   K1  cistar_tpu/ops/quant_pallas.py::_resblock_int8_bf16io_kernel
//       (full-precision carrier, launched by _run_resblock_int8_bf16io)
//   K2  cistar_tpu/ops/quant_pallas.py::_resblock_int8_kernel
//       (int8 carrier + one scale per image, launched by _run_resblock_int8)
// and the int8 conv both of them run, _conv9_int8.
//
// One residual block, per image:
//   quantize the carrier (one absmax per image) -> reflect-pad-1 3x3 conv,
//   int8 x int8 -> int32 -> dequantize (x_scale * w_scale) + bias -> IN ->
//   ReLU -> requantize per image -> conv 2 -> IN -> + full-precision skip
//   (K2: + dequantized input, then requantize per image).
//
// Design. The TPU kernel holds a whole image in VMEM (12 MB at the trunk
// shape (B, 32, 32, 512)) and does every reduction inside one grid step.
// A Hopper block has at most 227 KB of shared memory and blocks run in
// parallel in no order, so the block is split into launches on one stream:
//
//   absmax_kernel        per-image max |x| (atomicMax on the float bits,
//                        valid because |x| >= 0)
//   quant_kernel         x * (127 / amax) -> rint -> clip -> int8
//   conv3x3_s8_kernel    implicit GEMM, M = N*H*W pixels, N = Cout,
//                        K = 9*Cin, tensor cores through
//                        mma.sync.m16n8k32.s32.s8.s8.s32. The loader
//                        computes the reflect index itself: no padded copy.
//                        The epilogue dequantizes, writes fp32 f and adds
//                        each (image, channel)'s sum f, sum f^2 and max f
//                        into global statistics with atomics.
//   in_stats_kernel      IN finalize (mean, E[f^2]-mean^2 clamped >= 0,
//                        eps) and the requantization scale without a pass
//                        over f: rsigma > 0 and ReLU is monotone, so
//                        max |relu(IN(f))| = max_c relu((max f_c - mean_c)
//                        * rsigma_c), exactly, in fp32.
//   in_relu_quant_kernel relu(IN(f)) * (127 / rmax) -> int8
//   in_skip_out_kernel   IN(f2) + skip -> carrier dtype (K2: fp32 hnew and
//                        its per-image absmax, then quant_kernel)
//
// What bounds it. At the trunk shape one block does 2 convs x 1024 px x 9 x
// 512 x 512 MACs per image, 9.66 G int8 operations, against 2 MiB of bf16
// carrier (in and out) and 4.7 MB of weights per launch: operation-bound
// on an H100 (1,979 dense int8 TOPS vs 3.35 TB/s). This first version is a simple
// double-buffered cp.async + mma.sync GEMM (128x128x64 tiles, 8 warps),
// far from the wgmma/TMA peak; the fp32 intermediate f makes a round trip
// through device memory (the TPU kernel kept it in VMEM). Both are work for
// a later change; the arithmetic is the point here.
//
// Numerical traps, each matched to the plain PyTorch version
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
//     Whole blocks are compared within a tolerance; the int32 accumulators
//     of the conv (conv3x3_reflect_s8_acc) are compared bit for bit.
//
// Interface: plain C, loaded with ctypes. Every entry returns
// cudaGetLastError() as an int. Nothing here allocates: the caller passes
// a workspace of cistar_resblock_workspace_bytes() bytes.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;           // output pixels per block
constexpr int BN = 128;           // output channels per block
constexpr int BK = 64;            // int8 reduction depth per stage
constexpr int SROW = BK + 16;     // smem row stride (bytes): conflict-free
                                  // 32-bit fragment loads, 16-byte aligned
constexpr int CONV_THREADS = 256; // 8 warps: 2 (M) x 4 (N), 64x32 each
constexpr int EW_THREADS = 256;
constexpr int EW_VEC = 8;         // elements per thread in elementwise passes

__device__ __forceinline__ int reflect1(int v, int n) {
  // pad=1 reflection (ReflectionPad2d(1)): -1 -> 1, n -> n-2
  return v < 0 ? -v : (v >= n ? 2 * n - 2 - v : v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
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

// grid (x: chunks of one image, y: image); per_image = H*W*C
template <typename T>
__global__ void absmax_kernel(const T* __restrict__ x, long per_image,
                              float* __restrict__ amax) {
  const int n = blockIdx.y;
  const T* xi = x + n * per_image;
  float m = 0.f;
  for (long e = (static_cast<long>(blockIdx.x) * EW_THREADS + threadIdx.x) * EW_VEC;
       e < per_image; e += static_cast<long>(gridDim.x) * EW_THREADS * EW_VEC) {
    float v[EW_VEC];
    load8<T>(xi + e, v);
#pragma unroll
    for (int i = 0; i < EW_VEC; ++i) m = fmaxf(m, fabsf(v[i]));
  }
  block_absmax_to(m, amax + n);
}

// q = clip(rint(x * (127 / max(amax, 1e-6))), -127, 127); scale = amax / 127
template <typename T>
__global__ void quant_kernel(const T* __restrict__ x, long per_image,
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
  load8<T>(x + n * per_image + e, v);
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) v[i] = __fmul_rn(v[i], inv);
  store8_s8(q + n * per_image + e, v);
}

// Implicit-GEMM reflect-pad-1 3x3 conv. xq (N,H,W,C) int8; wk (C, 9*C)
// int8, K-contiguous with k = tap*C + cin, tap = 3*(dy+1) + (dx+1).
// RAW: write the int32 accumulators to acc. Else: f = float(acc) *
// (xs[n] * ws[c]) + bias[c] into f (fp32), with per-(image, channel) sum,
// sum of squares and (WANT_MAX) max added to stats.
// Requires C % 128 == 0 and (H*W) % 128 == 0 (a block's rows lie in one
// image), checked by the host entry.
template <bool RAW, bool WANT_MAX>
__global__ void __launch_bounds__(CONV_THREADS)
conv3x3_s8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wk,
                  const float* __restrict__ xs, const float* __restrict__ ws,
                  const float* __restrict__ bias, int32_t* __restrict__ acc_out,
                  float* __restrict__ f, float* __restrict__ st_sum,
                  float* __restrict__ st_sq, float* __restrict__ st_max, int H,
                  int W, int C) {
  __shared__ __align__(16) int8_t As[2][BM * SROW];
  __shared__ __align__(16) int8_t Bs[2][BN * SROW];
  __shared__ float red[2][3][BN];

  const int HW = H * W;
  const int K = 9 * C;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;

  // Each thread copies two 16-byte chunks of A and two of B per stage.
  int a_img[2], a_y[2], a_x[2], a_col[2], a_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = tid + i * CONV_THREADS;
    a_row[i] = id >> 2;
    a_col[i] = (id & 3) * 16;
    const int m = m0 + a_row[i];
    a_img[i] = m / HW;
    const int rem = m - a_img[i] * HW;
    a_y[i] = rem / W;
    a_x[i] = rem - a_y[i] * W;
  }

  auto load_stage = [&](int kt, int buf) {
    const int k0 = kt * BK;
    const int tap = k0 / C;
    const int cin0 = k0 - tap * C;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int yy = reflect1(a_y[i] + dy, H), xx = reflect1(a_x[i] + dx, W);
      const int8_t* src =
          xq + ((static_cast<long>(a_img[i]) * H + yy) * W + xx) * C + cin0 + a_col[i];
      cp_async16(&As[buf][a_row[i] * SROW + a_col[i]], src);
      const int8_t* wsrc = wk + static_cast<long>(n0 + a_row[i]) * K + k0 + a_col[i];
      cp_async16(&Bs[buf][a_row[i] * SROW + a_col[i]], wsrc);
    }
    cp_async_commit();
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
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
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const unsigned*>(as + r * SROW + kk + t * 4);
        af[mi][1] = *reinterpret_cast<const unsigned*>(as + (r + 8) * SROW + kk + t * 4);
        af[mi][2] = *reinterpret_cast<const unsigned*>(as + r * SROW + kk + 16 + t * 4);
        af[mi][3] = *reinterpret_cast<const unsigned*>(as + (r + 8) * SROW + kk + 16 + t * 4);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn * 32 + ni * 8 + g;
        bf[ni][0] = *reinterpret_cast<const unsigned*>(bs + c * SROW + kk + t * 4);
        bf[ni][1] = *reinterpret_cast<const unsigned*>(bs + c * SROW + kk + 16 + t * 4);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                 bf[ni][0], bf[ni][1]);
    }
    __syncthreads();
  }

  // Epilogue. Fragment (mi, ni, r): row = wm*64 + mi*16 + g + 8*(r >> 1),
  // col = wn*32 + ni*8 + 2*t + (r & 1).
  if (RAW) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long row = m0 + wm * 64 + mi * 16 + g + 8 * h;
          const int col = n0 + wn * 32 + ni * 8 + 2 * t;
          *reinterpret_cast<int2*>(acc_out + row * C + col) =
              make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        }
    return;
  }

  const int img = m0 / HW;
  const float xsc = xs[img];
  float s[4][2], sq[4][2], mx[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t + j;
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
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long row = m0 + wm * 64 + mi * 16 + g + 8 * h;
        const int col = n0 + wn * 32 + ni * 8 + 2 * t;
        *reinterpret_cast<float2*>(f + row * C + col) =
            make_float2(__int_as_float(acc[mi][ni][2 * h]),
                        __int_as_float(acc[mi][ni][2 * h + 1]));
      }
  // Reduce over the 8 row groups of the warp (lane bits 2..4) ...
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
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
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + ni * 8 + 2 * t + j;
        red[wm][0][c] = s[ni][j];
        red[wm][1][c] = sq[ni][j];
        red[wm][2][c] = mx[ni][j];
      }
  }
  __syncthreads();
  if (tid < BN) {
    const long o = static_cast<long>(img) * C + n0 + tid;
    atomicAdd(st_sum + o, __fadd_rn(red[0][0][tid], red[1][0][tid]));
    atomicAdd(st_sq + o, __fadd_rn(red[0][1][tid], red[1][1][tid]));
    if (WANT_MAX) atomic_max_float(st_max + o, fmaxf(red[0][2][tid], red[1][2][tid]));
  }
}

// IN finalize, one block per image: mean, rsigma per channel; with
// WANT_RMAX also the requantization scale of relu(IN(f)) from max f.
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

// rq = clip(rint(relu((f - mean) * rsigma) * rinv), -127, 127)
__global__ void in_relu_quant_kernel(const float* __restrict__ f, long per_image,
                                     int C, const float* __restrict__ mean,
                                     const float* __restrict__ rsig,
                                     const float* __restrict__ rinv,
                                     int8_t* __restrict__ q) {
  const int n = blockIdx.y;
  const long e = (static_cast<long>(blockIdx.x) * EW_THREADS + threadIdx.x) * EW_VEC;
  if (e >= per_image) return;
  const int c0 = static_cast<int>(e % C);
  const float inv = rinv[n];
  const float* mu = mean + static_cast<long>(n) * C + c0;
  const float* rs = rsig + static_cast<long>(n) * C + c0;
  float v[EW_VEC];
  load8<float>(f + n * per_image + e, v);
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i)
    v[i] = __fmul_rn(fmaxf(__fmul_rn(__fsub_rn(v[i], mu[i]), rs[i]), 0.f), inv);
  store8_s8(q + n * per_image + e, v);
}

// out = (f - mean) * rsigma + skip, skip = float(x) (K1) or
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

// ---------------------------------------------------------------------------
// Workspace layout, shared by both blocks (sizes in bytes, 256-aligned).
struct Workspace {
  int8_t* q;       // M*C int8: quantized conv input (x, then relu(IN(f)))
  float* f;        // M*C fp32: conv output f, then f2 (K2: hnew)
  float* st_sum;   // N*C
  float* st_sq;    // N*C
  float* st_max;   // N*C
  float* mean;     // N*C
  float* rsig;     // N*C
  float* amax;     // N: absmax of the block input
  float* xscale;   // N: its quantization scale
  float* rinv;     // N: 127 / rmax of relu(IN(f))
  float* rscale;   // N: rmax / 127
  float* oamax;    // N: absmax of hnew (K2)
};

size_t align256(size_t b) { return (b + 255) & ~static_cast<size_t>(255); }

size_t workspace_layout(long n, long hw, long c, char* base, Workspace* w) {
  const size_t mc = static_cast<size_t>(n * hw * c), nc = static_cast<size_t>(n * c);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base != nullptr ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  Workspace ws;
  ws.q = reinterpret_cast<int8_t*>(take(mc));
  ws.f = reinterpret_cast<float*>(take(mc * 4));
  // the three statistics arrays are contiguous so one memset clears them
  char* stats = take(3 * nc * 4);
  ws.st_sum = reinterpret_cast<float*>(stats);
  ws.st_sq = stats ? ws.st_sum + nc : nullptr;
  ws.st_max = stats ? ws.st_sum + 2 * nc : nullptr;
  ws.mean = reinterpret_cast<float*>(take(nc * 4));
  ws.rsig = reinterpret_cast<float*>(take(nc * 4));
  ws.amax = reinterpret_cast<float*>(take(n * 4));
  ws.xscale = reinterpret_cast<float*>(take(n * 4));
  ws.rinv = reinterpret_cast<float*>(take(n * 4));
  ws.rscale = reinterpret_cast<float*>(take(n * 4));
  ws.oamax = reinterpret_cast<float*>(take(n * 4));
  if (w != nullptr) *w = ws;
  return off;
}

bool shape_ok(int n, int h, int w, int c) {
  return n > 0 && h >= 2 && w >= 2 && c % BN == 0 && (h * w) % BM == 0;
}

dim3 ew_grid(long per_image, int n) {
  const long per_block = static_cast<long>(EW_THREADS) * EW_VEC;
  return dim3(static_cast<unsigned>((per_image + per_block - 1) / per_block), n);
}

// Clears the statistics (sum, sum of squares: 0; max: 0xFF bytes, which
// atomic_max_float treats as below every value), then one conv.
template <bool WANT_MAX>
void conv_stats(const Workspace& ws, const int8_t* q, const int8_t* wk,
                const float* xs, const float* wscale, const float* bias, int n,
                int h, int w, int c, cudaStream_t st) {
  const size_t nc = static_cast<size_t>(n) * c;
  cudaMemsetAsync(ws.st_sum, 0, 2 * nc * 4, st);
  if (WANT_MAX) cudaMemsetAsync(ws.st_max, 0xFF, nc * 4, st);
  dim3 grid(static_cast<unsigned>(static_cast<long>(n) * h * w / BM), c / BN);
  conv3x3_s8_kernel<false, WANT_MAX><<<grid, CONV_THREADS, 0, st>>>(
      q, wk, xs, wscale, bias, nullptr, ws.f, ws.st_sum, ws.st_sq, ws.st_max, h,
      w, c);
}

// conv 1 -> IN -> ReLU -> requantize into ws.q -> conv 2, leaving f2 in
// ws.f and its IN statistics in ws.mean / ws.rsig. xs: conv 1 input scale.
void block_body(const Workspace& ws, const int8_t* xq, const float* xs,
                const int8_t* w1k, const int8_t* w2k, const float* sb, int n,
                int h, int w, int c, float eps, cudaStream_t st) {
  const long per_image = static_cast<long>(h) * w * c;
  const float hw = static_cast<float>(h * w);
  conv_stats<true>(ws, xq, w1k, xs, sb, sb + c, n, h, w, c, st);
  in_stats_kernel<true><<<n, EW_THREADS, 0, st>>>(ws.st_sum, ws.st_sq, ws.st_max, c,
                                                  hw, eps, ws.mean, ws.rsig,
                                                  ws.rinv, ws.rscale);
  in_relu_quant_kernel<<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
      ws.f, per_image, c, ws.mean, ws.rsig, ws.rinv, ws.q);
  conv_stats<false>(ws, ws.q, w2k, ws.rscale, sb + 2 * c, sb + 3 * c, n, h, w, c, st);
  in_stats_kernel<false><<<n, EW_THREADS, 0, st>>>(ws.st_sum, ws.st_sq, nullptr, c,
                                                   hw, eps, ws.mean, ws.rsig,
                                                   nullptr, nullptr);
}

template <typename T>
int resblock_bf16io(const T* x, const int8_t* w1k, const int8_t* w2k,
                    const float* sb, T* out, void* workspace, int n, int h, int w,
                    int c, float eps, cudaStream_t st) {
  Workspace ws;
  workspace_layout(n, static_cast<long>(h) * w, c, static_cast<char*>(workspace), &ws);
  const long per_image = static_cast<long>(h) * w * c;
  cudaMemsetAsync(ws.amax, 0, n * 4, st);
  absmax_kernel<T><<<dim3(16, n), EW_THREADS, 0, st>>>(x, per_image, ws.amax);
  quant_kernel<T><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(x, per_image, ws.amax,
                                                                ws.q, ws.xscale);
  block_body(ws, ws.q, ws.xscale, w1k, w2k, sb, n, h, w, c, eps, st);
  in_skip_out_kernel<T, T, false><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
      ws.f, per_image, c, ws.mean, ws.rsig, x, nullptr, out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

size_t cistar_resblock_workspace_bytes(int n, int h, int w, int c) {
  return workspace_layout(n, static_cast<long>(h) * w, c, nullptr, nullptr);
}

// int32 accumulators of the reflect-pad-1 3x3 conv: xq (N,H,W,C) int8,
// wk (C, 9*C) int8 -> acc (N,H,W,C) int32.
int cistar_conv3x3_reflect_s8_acc(const void* xq, const void* wk, void* acc,
                                  int n, int h, int w, int c, void* stream) {
  if (!shape_ok(n, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(static_cast<long>(n) * h * w / BM), c / BN);
  conv3x3_s8_kernel<true, false><<<grid, CONV_THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wk), nullptr,
      nullptr, nullptr, static_cast<int32_t*>(acc), nullptr, nullptr, nullptr,
      nullptr, h, w, c);
  return static_cast<int>(cudaGetLastError());
}

// K1: x, out (N,H,W,C) bf16 (is_bf16 = 1) or fp32; sb (4, C) fp32 rows
// [w1_scale, b1, w2_scale, b2].
int cistar_resblock_int8_bf16io(const void* x, int is_bf16, const void* w1k,
                                const void* w2k, const void* sb, void* out,
                                void* workspace, int n, int h, int w, int c,
                                float eps, void* stream) {
  if (!shape_ok(n, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(w1k);
  const int8_t* b = static_cast<const int8_t*>(w2k);
  const float* s = static_cast<const float*>(sb);
  if (is_bf16)
    return resblock_bf16io(static_cast<const __nv_bfloat16*>(x), a, b, s,
                           static_cast<__nv_bfloat16*>(out), workspace, n, h, w, c,
                           eps, st);
  return resblock_bf16io(static_cast<const float*>(x), a, b, s,
                         static_cast<float*>(out), workspace, n, h, w, c, eps, st);
}

// K2: hq (N,H,W,C) int8 + hs (N,) fp32 -> outq (N,H,W,C) int8 + outs (N,).
int cistar_resblock_int8(const void* hq, const void* hs, const void* w1k,
                         const void* w2k, const void* sb, void* outq, void* outs,
                         void* workspace, int n, int h, int w, int c, float eps,
                         void* stream) {
  if (!shape_ok(n, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Workspace ws;
  workspace_layout(n, static_cast<long>(h) * w, c, static_cast<char*>(workspace), &ws);
  const long per_image = static_cast<long>(h) * w * c;
  const int8_t* xq = static_cast<const int8_t*>(hq);
  const float* xs = static_cast<const float*>(hs);
  block_body(ws, xq, xs, static_cast<const int8_t*>(w1k),
             static_cast<const int8_t*>(w2k), static_cast<const float*>(sb), n, h,
             w, c, eps, st);
  cudaMemsetAsync(ws.oamax, 0, n * 4, st);
  in_skip_out_kernel<int8_t, float, true><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
      ws.f, per_image, c, ws.mean, ws.rsig, xq, xs, ws.f, ws.oamax);
  quant_kernel<float><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
      ws.f, per_image, ws.oamax, static_cast<int8_t*>(outq),
      static_cast<float*>(outs));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
