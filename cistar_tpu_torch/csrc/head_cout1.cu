// The cout=1 7x7 reflect head conv for Hopper (sm_90a): K9 of the port.
//
// One kernel for the four TPU kernels that compute the same function,
//   K9a cistar_tpu/ops/pallas_kernels.py::_conv7_cout1_kernel
//       (conv2d_reflect_cout1, :292)
//   K9b pallas_kernels.py::_conv7_cout1_masked_kernel
//       (conv2d_reflect_cout1_masked, :402)
//   K9c pallas_kernels.py::_conv7_cout1_loop_kernel
//       (conv2d_reflect_cout1_loop, :494)
//   K9d cistar_tpu/ops/head_conv.py::_head_kernel
//       (head_conv_tanh_pallas, :341), with its optional pre_in
// (N,H,W,Cin) -> (N,H,W,1): out = act(sum_{dy,dx,c} xp[y+dy, x+dx, c] *
// w[dy, dx, c] + b), xp the reflect-pad-3 input, the taps rounded to the
// input dtype (the caller passes them so), products and sums in fp32, bias
// and tanh in fp32, one cast to the input dtype. With pre_in the input is
// first relu((x - mean) * rsqrt(var + eps)) with the single-pass statistics
// (E[x^2] - E[x]^2 clamped at 0), normalized and ReLU'd in fp32 and rounded
// to the input dtype, as _head_kernel does.
//
// Design. The TPU kernels are MXU layouts for one output channel: a
// (pixels, Cin) x (Cin, 49) tap matmul and shifted adds of the 49 tap
// planes, with the lane packing that the TPU's (8, 128) tiles need. One
// output channel gives a tensor core nothing to do, so here each thread
// owns one output pixel and runs the 49 x Cin taps in fp32 FMA. A block
// owns a 16 x 16 output tile of one image and stages its 22 x 22 input
// halo in shared memory, 8 channels at a time, with the reflect index
// computed by the loader (no padded copy) and, with pre_in, the normalize
// applied once per staged value. The statistics of pre_in come from a
// first pass (sums_kernel: per-(image, channel) sum and sum of squares by
// atomics).
//
// What bounds it: bytes. At (64, 256, 256, 64) bf16 the input is 537 MB
// and the output 8.4 MB, 0.163 ms at 3.35 TB/s; the 26.3 GFLOP would take
// 0.027 ms at the bf16 tensor-core rate. This first version runs them on
// the fp32 FMA units (67 TFLOP/s: 0.39 ms at best) and reads each staged
// value 49 times from shared memory.
//
// Numerics: fp32 sums in another order than the plain version (an ulp of
// the bf16 output at most); IEEE division and 1/sqrt for the statistics;
// tanhf.
//
// Interface: plain C, loaded with ctypes; returns cudaGetLastError(). The
// caller passes a workspace of cistar_head_cout1_workspace_bytes() bytes.

#include <algorithm>

#include "int8_common.cuh"

namespace {

constexpr int TILE = 16;                   // output tile edge, one pixel a thread
constexpr int HALO = 3;                     // reflect pad of the 7x7 conv
constexpr int SPAN = TILE + 2 * HALO;       // staged input tile edge
constexpr int CC = EW_VEC;                  // channels staged per step
constexpr int HEAD_THREADS = TILE * TILE;

// ReflectionPad2d(3) index for n > 3. Rows and columns further out than 3
// feed only outputs outside the image (the ragged edge tiles): clamped.
__device__ __forceinline__ int reflect3(int v, int n) {
  v = v < 0 ? -v : (v >= n ? 2 * n - 2 - v : v);
  return min(max(v, 0), n - 1);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Per-(image, channel) sum and sum of squares of x, added into st_sum /
// st_sq (N, Cin). grid (chunks, N); thread tid reads channels 8 * (tid %
// tv) .. + 7 of pixels tid / tv + k * rows * chunks; tv = Cin / 8 <= 256.
template <typename T>
__global__ void __launch_bounds__(HEAD_THREADS)
    sums_kernel(const T* __restrict__ x, long hw, int cin, float* __restrict__ st_sum,
                float* __restrict__ st_sq) {
  __shared__ float red[2][HEAD_THREADS * EW_VEC];
  const int n = blockIdx.y, tid = threadIdx.x;
  const int tv = cin / EW_VEC, rows = HEAD_THREADS / tv;
  const int v = tid % tv, r0 = tid / tv;
  float s[EW_VEC], q[EW_VEC];
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) s[i] = q[i] = 0.f;
  if (r0 < rows) {
    const T* xi = x + static_cast<long>(n) * hw * cin + v * EW_VEC;
    for (long p = static_cast<long>(blockIdx.x) * rows + r0; p < hw;
         p += static_cast<long>(gridDim.x) * rows) {
      float xv[EW_VEC];
      load8<T>(xi + p * cin, xv);
#pragma unroll
      for (int i = 0; i < EW_VEC; ++i) {
        s[i] = __fadd_rn(s[i], xv[i]);
        q[i] = __fadd_rn(q[i], __fmul_rn(xv[i], xv[i]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) {
    red[0][tid * EW_VEC + i] = s[i];
    red[1][tid * EW_VEC + i] = q[i];
  }
  __syncthreads();
  for (int ch = tid; ch < cin; ch += HEAD_THREADS) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < rows; ++r) {
      const int k = (r * tv + ch / EW_VEC) * EW_VEC + ch % EW_VEC;
      a = __fadd_rn(a, red[0][k]);
      b = __fadd_rn(b, red[1][k]);
    }
    atomicAdd(st_sum + static_cast<long>(n) * cin + ch, a);
    atomicAdd(st_sq + static_cast<long>(n) * cin + ch, b);
  }
}

// grid (ceil(W / 16), ceil(H / 16), N), HEAD_THREADS threads: thread (ty,
// tx) computes output pixel (y0 + ty, x0 + tx). wt: (49, Cin) fp32, tap =
// 7 * dy + dx.
template <typename T, bool PRE_IN, bool TANH>
__global__ void __launch_bounds__(HEAD_THREADS)
    head_kernel(const T* __restrict__ x, const float* __restrict__ wt,
                const float* __restrict__ bias, const float* __restrict__ st_sum,
                const float* __restrict__ st_sq, T* __restrict__ out, int h, int w,
                int cin, float eps) {
  __shared__ __align__(16) T xs[SPAN * SPAN * CC];
  __shared__ float ws[49 * CC];
  __shared__ float mu[CC], rs[CC];
  const int n = blockIdx.z, y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const int ty = threadIdx.x / TILE, tx = threadIdx.x % TILE;
  const float fhw = static_cast<float>(h * w);
  const T* xi = x + static_cast<long>(n) * h * w * cin;
  float acc = 0.f;
  for (int c0 = 0; c0 < cin; c0 += CC) {
    if (PRE_IN && threadIdx.x < CC) {
      const long o = static_cast<long>(n) * cin + c0 + threadIdx.x;
      const float m = __fdiv_rn(st_sum[o], fhw);
      const float var =
          fmaxf(__fsub_rn(__fdiv_rn(st_sq[o], fhw), __fmul_rn(m, m)), 0.f);
      mu[threadIdx.x] = m;
      rs[threadIdx.x] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    }
    for (int i = threadIdx.x; i < 49 * CC; i += HEAD_THREADS)
      ws[i] = wt[(i / CC) * cin + c0 + i % CC];
    __syncthreads();
    for (int p = threadIdx.x; p < SPAN * SPAN; p += HEAD_THREADS) {
      const int yy = reflect3(y0 + p / SPAN - HALO, h);
      const int xx = reflect3(x0 + p % SPAN - HALO, w);
      float v[EW_VEC];
      load8<T>(xi + (static_cast<long>(yy) * w + xx) * cin + c0, v);
      if (PRE_IN) {
#pragma unroll
        for (int i = 0; i < EW_VEC; ++i)
          v[i] = fmaxf(__fmul_rn(__fsub_rn(v[i], mu[i]), rs[i]), 0.f);
      }
      store8<T>(xs + p * CC, v);  // rounds to T, as the TPU kernel's cast
    }
    __syncthreads();
#pragma unroll
    for (int dy = 0; dy < 7; ++dy)
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) {
        float v[EW_VEC];
        load8<T>(xs + ((ty + dy) * SPAN + tx + dx) * CC, v);
        const float* wp = ws + (dy * 7 + dx) * CC;
#pragma unroll
        for (int i = 0; i < EW_VEC; ++i) acc = fmaf(v[i], wp[i], acc);
      }
    __syncthreads();
  }
  const int oy = y0 + ty, ox = x0 + tx;
  if (oy < h && ox < w) {
    float y = bias != nullptr ? __fadd_rn(acc, bias[0]) : acc;
    if (TANH) y = tanhf(y);
    store1(out + (static_cast<long>(n) * h + oy) * w + ox, y);
  }
}

template <typename T, bool PRE_IN, bool TANH>
void launch_head(const void* x, const float* wt, const float* bias, const float* st,
                 void* out, int n, int h, int w, int cin, float eps, cudaStream_t s) {
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, n);
  head_kernel<T, PRE_IN, TANH><<<grid, HEAD_THREADS, 0, s>>>(
      static_cast<const T*>(x), wt, bias, st, st + static_cast<long>(n) * cin,
      static_cast<T*>(out), h, w, cin, eps);
}

template <typename T>
int run(const void* x, const float* wt, const float* bias, void* out, float* st,
        int n, int h, int w, int cin, int tanh, int pre_in, float eps,
        cudaStream_t s) {
  if (pre_in) {
    const long hw = static_cast<long>(h) * w;
    const int rows = HEAD_THREADS / (cin / EW_VEC);
    const int chunks = static_cast<int>(std::min<long>((hw + rows - 1) / rows, 64));
    cudaMemsetAsync(st, 0, 2 * static_cast<size_t>(n) * cin * 4, s);
    sums_kernel<T><<<dim3(chunks, n), HEAD_THREADS, 0, s>>>(
        static_cast<const T*>(x), hw, cin, st, st + static_cast<long>(n) * cin);
    if (tanh)
      launch_head<T, true, true>(x, wt, bias, st, out, n, h, w, cin, eps, s);
    else
      launch_head<T, true, false>(x, wt, bias, st, out, n, h, w, cin, eps, s);
  } else if (tanh) {
    launch_head<T, false, true>(x, wt, bias, st, out, n, h, w, cin, eps, s);
  } else {
    launch_head<T, false, false>(x, wt, bias, st, out, n, h, w, cin, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The statistics of pre_in: 2 * N * Cin fp32.
size_t cistar_head_cout1_workspace_bytes(int n, int cin) {
  return align256(2 * static_cast<size_t>(n) * cin * 4);
}

// x (N,H,W,Cin) bf16 (is_bf16 = 1) or fp32, Cin % 8 == 0, Cin <= 2048,
// H, W > 3; wt (49, Cin) fp32; bias (1,) fp32 or null; out (N,H,W) in x's
// dtype.
int cistar_head_cout1(const void* x, int is_bf16, const void* wt, const void* bias,
                      void* out, void* workspace, int n, int h, int w, int cin,
                      int tanh, int pre_in, float eps, void* stream) {
  if (n <= 0 || n > 65535 || h <= HALO || w <= HALO || cin <= 0 || cin % EW_VEC ||
      cin > HEAD_THREADS * EW_VEC)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(wt);
  const float* bf = static_cast<const float*>(bias);
  float* st = static_cast<float*>(workspace);
  if (is_bf16)
    return run<__nv_bfloat16>(x, wf, bf, out, st, n, h, w, cin, tanh, pre_in, eps, s);
  return run<float>(x, wf, bf, out, st, n, h, w, cin, tanh, pre_in, eps, s);
}

}  // extern "C"
