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
// makes one HBM read and one write. Here a thread-block cluster holds it:
// one cluster owns one (image, slice of cs channels), and each of its cl
// CTAs loads its share of the slice's pixels once, with 16-byte cp.async,
// into shared memory (in_act_cluster_kernel). The per-channel sums of
// each CTA (its threads' sums over their pixels, then over its pixel rows
// in order) are exchanged through distributed shared memory, and every
// CTA adds the cl of them in rank order, so all hold the same,
// deterministic mean. The centered sum of squares comes from the values on
// chip, with a second exchange; then each CTA writes its share's output,
// reading the residual (if any) once. x is read from HBM once. cl is the
// least power of two (at most 16) that brings a share within 64 KB, or
// within 128 KB at 16 (in_act_cluster_size); fused_instance_norm_act's
// rule caps an image at 2 MiB, which every slice meets. Larger shapes
// (only a direct call can give them) take the first version's kernel
// (in_act_kernel: one block an (image, slice), walking the image three
// times; the later reads mostly hit L2). The choice is made by shape and
// reported by cistar_in_act_variant.
//
// What bounds it: bytes. At (64, 64, 64, 256) bf16 the input and the
// output are 134 MB each, 0.080 ms at 3.35 TB/s.
//
// Numerics: IEEE division and 1/sqrt (int8_common.cuh's rules; built with
// --fmad=false), tanhf. The plain version's torch.rsqrt and torch.tanh may
// differ by an ulp on the card.
//
// Interface: plain C, loaded with ctypes; returns cudaGetLastError().

#include <cooperative_groups.h>

#include "int8_common.cuh"

namespace cg = cooperative_groups;

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2, ACT_TANH = 3 };

constexpr int IN_THREADS = 256;
constexpr int MAX_CS = 64;              // channels of one slice
constexpr int CL_MAX = 16;              // CTAs of a cluster (16: non-portable)
constexpr int SHARE_BYTES = 64 * 1024;  // a CTA's share, cl < 16
constexpr int SHARE_BYTES_16 = 128 * 1024;

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

// The cluster barrier in two halves (release / acquire), so that a CTA
// can arrive once it has read its peers and wait only before it exits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Channel slice of C: the widest of 64, 32, 16, 8 that divides it.
__host__ __device__ inline int slice_channels(int c) {
  int cs = MAX_CS;
  while (c % cs) cs /= 2;
  return cs;
}

// CTAs of the cluster for an (hw, c) image of elem-byte values, or 0 for
// the three-pass kernel.
int in_act_cluster_size(long hw, int c, int elem) {
  const long row = static_cast<long>(slice_channels(c)) * elem;
  for (int cl = 1; cl < CL_MAX; cl *= 2)
    if ((hw + cl - 1) / cl * row <= SHARE_BYTES) return cl;
  return (hw + CL_MAX - 1) / CL_MAX * row <= SHARE_BYTES_16 ? CL_MAX : 0;
}

// grid (cl * C / cs, N), clusters of (cl, 1, 1): cluster k of image n owns
// channels c0 = (k) * cs .. + cs - 1; its CTA of rank r the pixels
// [r * hw / cl, (r + 1) * hw / cl). Thread tid loads, into xs, channels
// c0 + 8 * (tid % tv) .. + 7 of the share's pixels tid / tv, + rows, ...
// (tv = cs / 8, rows = IN_THREADS / tv): piece i = tid + k * IN_THREADS of
// xs, and works on those pieces only.
template <typename T>
__global__ void __launch_bounds__(IN_THREADS)
    in_act_cluster_kernel(const T* __restrict__ x, const T* __restrict__ res,
                          T* __restrict__ out, int hw, int c, int cs, int cl, int act,
                          float slope, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[IN_THREADS * EW_VEC];
  __shared__ float sum_s[MAX_CS], sq_s[MAX_CS];  // read by the cluster
  __shared__ float mean_s[MAX_CS], rsig_s[MAX_CS];
  T* xs = reinterpret_cast<T*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.y, c0 = blockIdx.x / cl * cs;
  const int p0 = static_cast<int>(static_cast<long>(rank) * hw / cl);
  const int np = static_cast<int>(static_cast<long>(rank + 1) * hw / cl) - p0;
  const int tv = cs / EW_VEC, rows = IN_THREADS / tv;
  const int v = threadIdx.x % tv, r0 = threadIdx.x / tv;
  const long base = (static_cast<long>(n) * hw + p0) * c + c0 + v * EW_VEC;
  const float fhw = static_cast<float>(hw);
  constexpr int COPIES = EW_VEC * sizeof(T) / 16;

  for (int q = r0; q < np; q += rows) {
    T* d = xs + static_cast<long>(q * tv + v) * EW_VEC;
    const T* s = x + base + static_cast<long>(q) * c;
#pragma unroll
    for (int k = 0; k < COPIES; ++k) cp_async16(d + k * (16 / sizeof(T)), s + k * (16 / sizeof(T)));
  }
  cp_async_commit();
  cp_async_wait<0>();

  float part[EW_VEC];
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) part[i] = 0.f;
  for (int q = r0; q < np; q += rows) {
    float xv[EW_VEC];
    load8<T>(xs + static_cast<long>(q * tv + v) * EW_VEC, xv);
#pragma unroll
    for (int i = 0; i < EW_VEC; ++i) part[i] = __fadd_rn(part[i], xv[i]);
  }
  slice_reduce(part, red, sum_s, tv, rows, cs);
  cluster.sync();
  if (threadIdx.x < cs) {
    float s = 0.f;
    for (int r = 0; r < cl; ++r) s = __fadd_rn(s, cluster.map_shared_rank(sum_s, r)[threadIdx.x]);
    mean_s[threadIdx.x] = __fdiv_rn(s, fhw);
  }
  __syncthreads();

  float mu[EW_VEC];
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) {
    mu[i] = mean_s[v * EW_VEC + i];
    part[i] = 0.f;
  }
  for (int q = r0; q < np; q += rows) {
    float xv[EW_VEC];
    load8<T>(xs + static_cast<long>(q * tv + v) * EW_VEC, xv);
#pragma unroll
    for (int i = 0; i < EW_VEC; ++i) {
      const float d = __fsub_rn(xv[i], mu[i]);
      part[i] = __fadd_rn(part[i], __fmul_rn(d, d));
    }
  }
  slice_reduce(part, red, sq_s, tv, rows, cs);
  cluster.sync();
  if (threadIdx.x < cs) {
    float s = 0.f;
    for (int r = 0; r < cl; ++r) s = __fadd_rn(s, cluster.map_shared_rank(sq_s, r)[threadIdx.x]);
    const float var = __fdiv_rn(s, fhw);
    rsig_s[threadIdx.x] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
  cluster_arrive();  // done reading the peers' sums
  __syncthreads();

  float rs[EW_VEC];
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) rs[i] = rsig_s[v * EW_VEC + i];
  const int a = res != nullptr && act == ACT_TANH ? ACT_NONE : act;
  for (int q = r0; q < np; q += rows) {
    const long o = base + static_cast<long>(q) * c;
    float xv[EW_VEC], rv[EW_VEC];
    load8<T>(xs + static_cast<long>(q * tv + v) * EW_VEC, xv);
    if (res != nullptr) load8<T>(res + o, rv);
#pragma unroll
    for (int i = 0; i < EW_VEC; ++i) {
      float y = __fmul_rn(__fsub_rn(xv[i], mu[i]), rs[i]);
      if (res != nullptr) y = __fadd_rn(y, rv[i]);
      xv[i] = act_fn(y, a, slope);
    }
    store8<T>(out + o, xv);
  }
  cluster_wait();  // no peer reads this CTA's sums any more
}

// Shapes beyond the cluster's shares. grid (C / cs, N). Thread tid reads
// channels c0 + 8 * (tid % tv) .. + 7 of pixels tid / tv, + rows, ...; tv
// = cs / 8 divides IN_THREADS, rows = IN_THREADS / tv.
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
cudaError_t launch_cluster(const T* x, const T* res, T* out, int n, int hw, int c, int cs,
                           int cl, int act, float slope, float eps, cudaStream_t st) {
  auto kern = in_act_cluster_kernel<T>;
  static bool attr = false;
  if (!attr) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SHARE_BYTES_16);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cl * (c / cs)), static_cast<unsigned>(n), 1);
  cfg.blockDim = dim3(IN_THREADS, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>((hw + cl - 1) / cl) * cs * sizeof(T);
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = static_cast<unsigned>(cl);
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, x, res, out, hw, c, cs, cl, act, slope, eps);
}

template <typename T>
int run(const void* x, const void* res, void* out, int n, int hw, int c, int act,
        float slope, float eps, cudaStream_t st) {
  const int cs = slice_channels(c);
  const int cl = in_act_cluster_size(hw, c, sizeof(T));
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  if (cl > 0) {
    const cudaError_t e = launch_cluster<T>(xt, rt, ot, n, hw, c, cs, cl, act, slope, eps, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    in_act_kernel<T><<<dim3(c / cs, n), IN_THREADS, 0, st>>>(xt, rt, ot, hw, c, cs, act,
                                                             slope, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Which kernel an (hw, c) image takes: the CTAs of a cluster of
// in_act_cluster_kernel (1-16), or 0 for the three-pass in_act_kernel.
int cistar_in_act_variant(int hw, int c, int is_bf16) {
  if (hw <= 0 || c <= 0 || c % EW_VEC) return -1;
  return in_act_cluster_size(hw, c, is_bf16 ? 2 : 4);
}

// x, res (may be null), out: (N, hw, C) bf16 (is_bf16 = 1) or fp32, C % 8 == 0.
// act: 0 none, 1 relu, 2 leaky, 3 tanh (none with a residual).
int cistar_in_act(const void* x, int is_bf16, const void* res, void* out, int n,
                  int hw, int c, int act, float slope, float eps, void* stream) {
  if (n <= 0 || n > 65535 || hw <= 0 || c <= 0 || c % EW_VEC || act < 0 || act > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return run<__nv_bfloat16>(x, res, out, n, hw, c, act, slope, eps, st);
  return run<float>(x, res, out, n, hw, c, act, slope, eps, st);
}

}  // extern "C"
