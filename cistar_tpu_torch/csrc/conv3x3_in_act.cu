// Fused 3x3 conv + instance norm + activation (+ residual) for Hopper
// (sm_90a): K3 of the port.
//
// Replaces the TPU kernel inside
//   cistar_tpu/ops/pallas_kernels.py::fused_conv3x3_in_act (:224)
// the residual block layer of the bf16 fast forwards
// (fast_infer.py::resnet_generator_fast_apply, global_generator_fast_apply).
//
// Per image: acc = conv3x3(pad(x), w) + b, the products of the x and w
// values summed in fp32 (reflect or zero pad 1); the single-pass IN of acc
// (mean = sum / hw, var = max(sum(acc^2) / hw - mean^2, 0)); y = (acc -
// mean) * rsqrt(var + eps); with a residual y += float(res); ReLU if asked;
// one cast to x's dtype.
//
// Design. The TPU kernel holds one whole image, its fp32 accumulator and
// the weights in VMEM (up to 9 MiB, the routing rule) and normalizes before
// its one write. A Hopper block has 227 KB of shared memory and blocks run
// in parallel in no order, so the statistics cross blocks:
//
//   wg_conv_kernel     bf16 x and w on a shape that meets wg_tile_ok:
//                      implicit GEMM, M = N*H*W pixels, N = Cout, K =
//                      9*Cin, on wgmma.mma_async bf16 -> fp32 with TMA loads
//                      into a ring of mbarrier stages (wgmma_conv.cuh, the
//                      int8 conv of K1 / K2 with bf16 operands). Reflect
//                      padding reads a padded copy of x (reflect_pad_kernel,
//                      ~0.04 ms at (64, 32, 32, 512)); zero padding reads x
//                      itself, TMA zero-filling the border. The epilogue adds
//                      the bias, writes fp32 acc and adds each (image,
//                      channel)'s sum and sum of squares into global
//                      statistics with atomics.
//   conv_ffma_kernel   any other operands (fp32 x or w, or a shape outside
//                      the tile rule): the same GEMM in fp32 FFMA on 32 x 32
//                      shared-memory tiles, no TF32. Only narrow shapes reach
//                      K3 with fp32 weights under the rule.
//   in_stats_kernel    the IN finalize (int8_common.cuh)
//   in_act_out_kernel  (acc - mean) * rsigma (+ residual) (ReLU) -> x dtype
//
// What bounds it: operations. At (64, 32, 32, 512) bf16 one launch does
// 309.2 GFLOP, 0.313 ms at 989 TFLOP/s, against at most 0.2 GB of traffic.
// The fp32 accumulator still makes a round trip through device memory.
//
// Numerics: fp32 sums in another order than the plain version; the IN
// with IEEE division and 1/sqrt (--fmad=false: each op rounds once). The
// statistics are summed with atomics, in an order that changes from run
// to run.
//
// Interface: plain C, loaded with ctypes; returns cudaGetLastError(). The
// caller passes a workspace of cistar_conv3x3_in_act_workspace_bytes().

#include "wgmma_conv.cuh"

namespace {

constexpr int FT = 32;             // FFMA tile: pixels, couts and K

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Args {
  const void* x;     // (N, H, W, Cin)
  const void* wk;    // (Cout, 9 * Cin), k = tap * Cin + cin, tap = 3 * ky + kx
  const float* bias; // (Cout,)
  float* f;          // (N * H * W, Cout): conv + bias
  float* st_sum;     // (N, Cout)
  float* st_sq;      // (N, Cout)
  int n, h, w, cin, cout;
  bool x_bf16, w_bf16;
};

// FFMA conv on any shape: block (FT pixels) x (FT couts), thread tid owns
// pixel tid / 8 and couts 4 * (tid % 8) .. + 3; K in FT-wide slices
// through shared memory. Statistics by one atomic per output element.
template <typename TX, typename TW, bool REFLECT>
__global__ void __launch_bounds__(256) conv_ffma_kernel(const Args a) {
  __shared__ float As[FT][FT + 1];  // [k][pixel]
  __shared__ float Bs[FT][FT + 1];  // [k][cout]
  const TX* xp = static_cast<const TX*>(a.x);
  const TW* wp = static_cast<const TW*>(a.wk);
  const int H = a.h, W = a.w, Cin = a.cin, Cout = a.cout;
  const long HW = static_cast<long>(H) * W, M = a.n * HW, K = 9L * Cin;
  const long m0 = static_cast<long>(blockIdx.x) * FT;
  const int n0 = blockIdx.y * FT;
  const int tid = threadIdx.x, tm = tid / 8, tn = (tid % 8) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (long k0 = 0; k0 < K; k0 += FT) {
    for (int e = tid; e < FT * FT; e += 256) {
      const int kk = e % FT, r = e / FT;
      const long k = k0 + kk, m = m0 + r;
      float v = 0.f;
      if (m < M && k < K) {
        const int tap = static_cast<int>(k / Cin), ci = static_cast<int>(k - tap * Cin);
        const long im = m / HW;
        const int rem = static_cast<int>(m - im * HW);
        int yy = rem / W + tap / 3 - 1, xx = rem % W + tap % 3 - 1;
        bool in = true;
        if (REFLECT) {
          yy = reflect1(yy, H);
          xx = reflect1(xx, W);
        } else {
          in = yy >= 0 && yy < H && xx >= 0 && xx < W;
        }
        if (in) v = to_f(xp[((im * H + yy) * W + xx) * Cin + ci]);
      }
      As[kk][r] = v;
      const int co = n0 + r;
      Bs[kk][r] = co < Cout && k < K ? to_f(wp[static_cast<long>(co) * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FT; ++kk) {
      const float av = As[kk][tm];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(av, Bs[kk][tn + j], acc[j]);
    }
    __syncthreads();
  }
  const long m = m0 + tm;
  if (m >= M) return;
  const long im = m / HW;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = n0 + tn + j;
    if (co < Cout) {
      const float v = __fadd_rn(acc[j], a.bias[co]);
      a.f[m * Cout + co] = v;
      atomicAdd(a.st_sum + im * Cout + co, v);
      atomicAdd(a.st_sq + im * Cout + co, __fmul_rn(v, v));
    }
  }
}

// out = relu?((f - mean) * rsigma + float(res)) in T; C % 8 == 0.
template <typename T, bool RES, bool RELU>
__global__ void in_act_out_kernel(const float* __restrict__ f, long per_image, int C,
                                  const float* __restrict__ mean,
                                  const float* __restrict__ rsig,
                                  const T* __restrict__ res, T* __restrict__ out) {
  const int n = blockIdx.y;
  const long e = (static_cast<long>(blockIdx.x) * EW_THREADS + threadIdx.x) * EW_VEC;
  if (e >= per_image) return;
  const int c0 = static_cast<int>(e % C);
  const float* mu = mean + static_cast<long>(n) * C + c0;
  const float* rs = rsig + static_cast<long>(n) * C + c0;
  const long o = n * per_image + e;
  float v[EW_VEC], r[EW_VEC];
  load8<float>(f + o, v);
  if (RES) load8<T>(res + o, r);
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) {
    float y = __fmul_rn(__fsub_rn(v[i], mu[i]), rs[i]);
    if (RES) y = __fadd_rn(y, r[i]);
    v[i] = RELU ? fmaxf(y, 0.f) : y;
  }
  store8<T>(out + o, v);
}

struct Workspace {
  void* xpad;     // N * (H+2) * (W+2) * Cin bf16: reflect-padded x, or null
  float* f;       // M * Cout
  float* st_sum;  // N * Cout, then st_sq right after it
  float* st_sq;
  float* mean;    // N * Cout
  float* rsig;    // N * Cout
};

// pad: the launch takes wg_conv_kernel with reflect padding, and so needs xpad.
size_t workspace_layout(long n, long h, long w, long cin, long cout, bool pad, char* base,
                        Workspace* wsp) {
  const size_t mc = static_cast<size_t>(n * h * w * cout), nc = static_cast<size_t>(n * cout);
  Carver cv{base};
  Workspace ws;
  ws.xpad = pad ? cv.take<void>(static_cast<size_t>(n * (h + 2) * (w + 2) * cin * 2)) : nullptr;
  ws.f = cv.take<float>(mc * 4);
  ws.st_sum = cv.take<float>(2 * nc * 4);  // one memset clears both
  ws.st_sq = ws.st_sum ? ws.st_sum + nc : nullptr;
  ws.mean = cv.take<float>(nc * 4);
  ws.rsig = cv.take<float>(nc * 4);
  if (wsp != nullptr) *wsp = ws;
  return cv.off;
}

// Which conv a launch takes: the BN of wg_conv_kernel, or 0 for
// conv_ffma_kernel.
int conv_variant(int n, int h, int w, int cin, int cout, bool x_bf16, bool w_bf16) {
  return x_bf16 && w_bf16 && wg_tile_ok(n, h, w, cin, cout, 2) ? wg_bn(n, h, w, cout) : 0;
}

// The tensor-core conv: f = conv(x) + bias into a.f, with the statistics
// where a.st_sum is set. xpad: scratch for the reflect-padded x.
cudaError_t launch_wg_bf16(const Args& a, bool reflect, void* xpad, cudaStream_t st) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  if (reflect) {
    launch_reflect_pad(x, static_cast<__nv_bfloat16*>(xpad), a.n, a.h, a.w, a.cin, st);
    x = static_cast<const __nv_bfloat16*>(xpad);
  }
  const ConvArgs c{nullptr, nullptr, nullptr, nullptr, a.bias, nullptr, a.f, a.st_sum,
                   a.st_sq, nullptr, a.n, a.h, a.w, a.cin, a.cout, 1};
  return launch_wg_conv<__nv_bfloat16, EPI_STATS, false>(
      x, reflect, static_cast<const __nv_bfloat16*>(a.wk), c, st);
}

template <bool REFLECT>
void launch_gemm(const Args& a, cudaStream_t st) {
  const long m = static_cast<long>(a.n) * a.h * a.w;
  const dim3 grid(static_cast<unsigned>((m + FT - 1) / FT), (a.cout + FT - 1) / FT);
  if (a.x_bf16 && a.w_bf16)
    conv_ffma_kernel<__nv_bfloat16, __nv_bfloat16, REFLECT><<<grid, 256, 0, st>>>(a);
  else if (a.x_bf16)
    conv_ffma_kernel<__nv_bfloat16, float, REFLECT><<<grid, 256, 0, st>>>(a);
  else if (a.w_bf16)
    conv_ffma_kernel<float, __nv_bfloat16, REFLECT><<<grid, 256, 0, st>>>(a);
  else
    conv_ffma_kernel<float, float, REFLECT><<<grid, 256, 0, st>>>(a);
}

template <typename T>
void launch_out(const Workspace& ws, long per_image, int n, int c, const void* res,
                bool relu, void* out, cudaStream_t st) {
  const T* r = static_cast<const T*>(res);
  T* o = static_cast<T*>(out);
  const dim3 grid = ew_grid(per_image, n);
  if (r != nullptr && relu)
    in_act_out_kernel<T, true, true><<<grid, EW_THREADS, 0, st>>>(ws.f, per_image, c, ws.mean, ws.rsig, r, o);
  else if (r != nullptr)
    in_act_out_kernel<T, true, false><<<grid, EW_THREADS, 0, st>>>(ws.f, per_image, c, ws.mean, ws.rsig, r, o);
  else if (relu)
    in_act_out_kernel<T, false, true><<<grid, EW_THREADS, 0, st>>>(ws.f, per_image, c, ws.mean, ws.rsig, r, o);
  else
    in_act_out_kernel<T, false, false><<<grid, EW_THREADS, 0, st>>>(ws.f, per_image, c, ws.mean, ws.rsig, r, o);
}

}  // namespace

extern "C" {

size_t cistar_conv3x3_in_act_workspace_bytes(int n, int h, int w, int cin, int cout,
                                             int x_bf16, int w_bf16, int reflect) {
  const bool pad = reflect && conv_variant(n, h, w, cin, cout, x_bf16 != 0, w_bf16 != 0);
  return workspace_layout(n, h, w, cin, cout, pad, nullptr, nullptr);
}

// Which conv K3 runs at this shape and these dtypes: the BN of
// wg_conv_kernel (128 or 256), or 0 for conv_ffma_kernel.
int cistar_conv3x3_in_act_variant(int n, int h, int w, int cin, int cout, int x_bf16,
                                  int w_bf16) {
  return conv_variant(n, h, w, cin, cout, x_bf16 != 0, w_bf16 != 0);
}

// x (N,H,W,Cin) bf16 (x_bf16 = 1) or fp32; wk (Cout, 9*Cin) bf16 (w_bf16 =
// 1) or fp32; bias (Cout,) fp32; res (N,H,W,Cout) in x's dtype or null;
// out (N,H,W,Cout) in x's dtype. Cout % 8 == 0, H, W >= 2.
int cistar_conv3x3_in_act(const void* x, int x_bf16, const void* wk, int w_bf16,
                          const void* bias, const void* res, void* out, void* workspace,
                          int n, int h, int w, int cin, int cout, int reflect, int relu,
                          float eps, void* stream) {
  if (n <= 0 || h < 2 || w < 2 || cin <= 0 || cout <= 0 || cout % EW_VEC)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wg = conv_variant(n, h, w, cin, cout, x_bf16 != 0, w_bf16 != 0) != 0;
  Workspace ws;
  workspace_layout(n, h, w, cin, cout, wg && reflect, static_cast<char*>(workspace), &ws);
  cudaMemsetAsync(ws.st_sum, 0, 2 * static_cast<size_t>(n) * cout * 4, st);
  const Args a{x, wk, static_cast<const float*>(bias), ws.f, ws.st_sum, ws.st_sq,
               n, h, w, cin, cout, x_bf16 != 0, w_bf16 != 0};
  if (wg) {
    const cudaError_t e = launch_wg_bf16(a, reflect != 0, ws.xpad, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else if (reflect) {
    launch_gemm<true>(a, st);
  } else {
    launch_gemm<false>(a, st);
  }
  in_stats_kernel<false><<<n, EW_THREADS, 0, st>>>(ws.st_sum, ws.st_sq, nullptr, cout,
                                                   static_cast<float>(h * w), eps, ws.mean,
                                                   ws.rsig, nullptr, nullptr);
  const long per_image = static_cast<long>(h) * w * cout;
  if (x_bf16)
    launch_out<__nv_bfloat16>(ws, per_image, n, cout, res, relu, out, st);
  else
    launch_out<float>(ws, per_image, n, cout, res, relu, out, st);
  return static_cast<int>(cudaGetLastError());
}

// K3's conv alone: f (N,H,W,Cout) fp32 = conv3x3(pad(x), w) + bias, x
// (N,H,W,Cin) and wk (Cout, 9*Cin) bf16, on wg_conv_kernel only (the shape
// meets its rule). xpad: (N, H+2, W+2, Cin) bf16 scratch where reflect,
// else null.
int cistar_conv3x3_bf16_f32(const void* x, const void* wk, const void* bias, void* f,
                            void* xpad, int n, int h, int w, int cin, int cout, int reflect,
                            void* stream) {
  if (conv_variant(n, h, w, cin, cout, true, true) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, wk, static_cast<const float*>(bias), static_cast<float*>(f), nullptr,
               nullptr, n, h, w, cin, cout, true, true};
  const cudaError_t e = launch_wg_bf16(a, reflect != 0, xpad, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
