// Instance norm + activation (+ residual) for Hopper (sm_90a): K4 of the port.
//
// Replaces the TPU kernels
//   cistar_tpu/ops/pallas_kernels.py::_in_act_kernel      (no residual)
//   cistar_tpu/ops/pallas_kernels.py::_in_act_res_kernel  (residual)
// launched by fused_instance_norm_act (:111, :120).
//
// Per image and channel, in fp32: mean = sum(x) / hw; the centered
// variance var = sum((x - mean)^2) / hw (two passes, as the TPU kernel, not
// the single-pass E[x^2] - E[x]^2 of the plain IN); y = (x - mean) *
// rsqrt(var + eps); with a residual y += float(res); then none / relu /
// leaky (slope) / tanh; one cast to the input dtype. The residual form has
// no tanh: the TPU kernel has no such branch (its fallback does; ROADMAP
// queue 3), and the port follows the kernel.
//
// Design. The TPU kernel holds a whole image in VMEM (up to 2 MiB) and
// makes one HBM read and one write. Here one block owns one (image, slice
// of cs channels) and walks the image three times: the sum, the centered
// sum of squares, the output. The slices of an image are neighbours in the
// grid, so the second and third reads mostly hit L2 (50 MB). Threads take
// 8 channels each (one 16-byte bf16 load); the per-channel sums are reduced
// through shared memory in a fixed order, so the kernel is deterministic.
//
// What bounds it: bytes. At (64, 64, 64, 256) bf16 the input and the
// output are 134 MB each, 0.080 ms at 3.35 TB/s; the second and third
// reads are what this first version pays on top.
//
// Numerics: IEEE division and 1/sqrt (int8_common.cuh's rules; built with
// --fmad=false), tanhf. The plain version's torch.rsqrt and torch.tanh may
// differ by an ulp on the card.
//
// Interface: plain C, loaded with ctypes; returns cudaGetLastError().

#include "int8_common.cuh"

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2, ACT_TANH = 3 };

constexpr int IN_THREADS = 256;
constexpr int MAX_CS = 64;  // channels of one block's slice

// Sum over the block's pixel rows of each thread's 8 partials: the result
// for channel ch of the slice lands in out[ch]. red holds IN_THREADS * 8.
__device__ __forceinline__ void slice_reduce(const float* part, float* red,
                                             float* out, int tv, int rows,
                                             int cs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) red[tid * EW_VEC + i] = part[i];
  __syncthreads();
  if (tid < cs) {
    const int v = tid / EW_VEC, i = tid % EW_VEC;
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s = __fadd_rn(s, red[(r * tv + v) * EW_VEC + i]);
    out[tid] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float act_fn(float y, int act, float slope) {
  if (act == ACT_RELU) return fmaxf(y, 0.f);
  if (act == ACT_LEAKY) return y >= 0.f ? y : __fmul_rn(y, slope);
  if (act == ACT_TANH) return tanhf(y);
  return y;
}

// grid (C / cs, N), cs in {8, 16, 32, 64}. Thread tid reads channels
// c0 + 8 * (tid % tv) .. + 7 of pixels tid / tv, + rows, ...; tv = cs / 8
// divides IN_THREADS, rows = IN_THREADS / tv.
template <typename T>
__global__ void __launch_bounds__(IN_THREADS)
    in_act_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  T* __restrict__ out, int hw, int c, int cs, int act,
                  float slope, float eps) {
  __shared__ float red[IN_THREADS * EW_VEC];
  __shared__ float mean_s[MAX_CS], rsig_s[MAX_CS];
  const int n = blockIdx.y, c0 = blockIdx.x * cs;
  const int tv = cs / EW_VEC, rows = IN_THREADS / tv;
  const int v = threadIdx.x % tv, r0 = threadIdx.x / tv;
  const long base = static_cast<long>(n) * hw * c + c0 + v * EW_VEC;
  const float fhw = static_cast<float>(hw);

  float part[EW_VEC];
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) part[i] = 0.f;
  for (int p = r0; p < hw; p += rows) {
    float xv[EW_VEC];
    load8<T>(x + base + static_cast<long>(p) * c, xv);
#pragma unroll
    for (int i = 0; i < EW_VEC; ++i) part[i] = __fadd_rn(part[i], xv[i]);
  }
  slice_reduce(part, red, mean_s, tv, rows, cs);
  if (threadIdx.x < cs) mean_s[threadIdx.x] = __fdiv_rn(mean_s[threadIdx.x], fhw);
  __syncthreads();

  float mu[EW_VEC];
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) {
    mu[i] = mean_s[v * EW_VEC + i];
    part[i] = 0.f;
  }
  for (int p = r0; p < hw; p += rows) {
    float xv[EW_VEC];
    load8<T>(x + base + static_cast<long>(p) * c, xv);
#pragma unroll
    for (int i = 0; i < EW_VEC; ++i) {
      const float d = __fsub_rn(xv[i], mu[i]);
      part[i] = __fadd_rn(part[i], __fmul_rn(d, d));
    }
  }
  slice_reduce(part, red, rsig_s, tv, rows, cs);
  if (threadIdx.x < cs) {
    const float var = __fdiv_rn(rsig_s[threadIdx.x], fhw);
    rsig_s[threadIdx.x] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
  __syncthreads();

  float rs[EW_VEC];
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) rs[i] = rsig_s[v * EW_VEC + i];
  const int a = res != nullptr && act == ACT_TANH ? ACT_NONE : act;
  for (int p = r0; p < hw; p += rows) {
    const long o = base + static_cast<long>(p) * c;
    float xv[EW_VEC], rv[EW_VEC];
    load8<T>(x + o, xv);
    if (res != nullptr) load8<T>(res + o, rv);
#pragma unroll
    for (int i = 0; i < EW_VEC; ++i) {
      float y = __fmul_rn(__fsub_rn(xv[i], mu[i]), rs[i]);
      if (res != nullptr) y = __fadd_rn(y, rv[i]);
      xv[i] = act_fn(y, a, slope);
    }
    store8<T>(out + o, xv);
  }
}

template <typename T>
int run(const void* x, const void* res, void* out, int n, int hw, int c, int act,
        float slope, float eps, cudaStream_t st) {
  int cs = MAX_CS;
  while (c % cs) cs /= 2;
  in_act_kernel<T><<<dim3(c / cs, n), IN_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<T*>(out), hw, c,
      cs, act, slope, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, res (may be null), out: (N, hw, C) bf16 (is_bf16 = 1) or fp32, C % 8 == 0.
// act: 0 none, 1 relu, 2 leaky, 3 tanh (none with a residual).
int cistar_in_act(const void* x, int is_bf16, const void* res, void* out, int n,
                  int hw, int c, int act, float slope, float eps, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || c % EW_VEC || act < 0 || act > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return run<__nv_bfloat16>(x, res, out, n, hw, c, act, slope, eps, st);
  return run<float>(x, res, out, n, hw, c, act, slope, eps, st);
}

}  // extern "C"
