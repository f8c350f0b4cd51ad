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
// parallel in no order, so the block is split into launches on one stream
// (all but in_relu_quant_kernel live in int8_common.cuh, shared with K5/K6):
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
// Numerics: the rules of int8_common.cuh (IEEE division, rintf, no FMA
// contraction). The statistics are summed with atomics, so a requantized
// LSB can flip against the plain version: whole blocks are compared
// within a tolerance, the int32 accumulators of the conv
// (conv3x3_reflect_s8_acc) bit for bit.
//
// Interface: plain C, loaded with ctypes. Every entry returns
// cudaGetLastError() as an int. Nothing here allocates: the caller passes
// a workspace of cistar_resblock_workspace_bytes() bytes.

#include "int8_common.cuh"

namespace {

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

size_t workspace_layout(long n, long hw, long c, char* base, Workspace* w) {
  const size_t mc = static_cast<size_t>(n * hw * c), nc = static_cast<size_t>(n * c);
  Carver cv{base};
  Workspace ws;
  ws.q = cv.take<int8_t>(mc);
  ws.f = cv.take<float>(mc * 4);
  // the three statistics arrays are contiguous so one memset clears them
  ws.st_sum = cv.take<float>(3 * nc * 4);
  ws.st_sq = ws.st_sum ? ws.st_sum + nc : nullptr;
  ws.st_max = ws.st_sum ? ws.st_sum + 2 * nc : nullptr;
  ws.mean = cv.take<float>(nc * 4);
  ws.rsig = cv.take<float>(nc * 4);
  ws.amax = cv.take<float>(n * 4);
  ws.xscale = cv.take<float>(n * 4);
  ws.rinv = cv.take<float>(n * 4);
  ws.rscale = cv.take<float>(n * 4);
  ws.oamax = cv.take<float>(n * 4);
  if (w != nullptr) *w = ws;
  return cv.off;
}

bool shape_ok(int n, int h, int w, int c) {
  // C % 128: the widest tiles (BN 128, BK 64), as slice 1 measured K1/K2
  return conv_shape_ok(n, h, w, c, c) && c % 128 == 0;
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
  launch_conv<false, WANT_MAX, true>(
      ConvArgs{q, wk, xs, wscale, bias, nullptr, ws.f, ws.st_sum, ws.st_sq,
               ws.st_max, n, h, w, c, c, 1},
      st);
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
  absmax_kernel<T><<<dim3(16, n), EW_THREADS, 0, st>>>(x, per_image, dense(per_image),
                                                       ws.amax);
  quant_kernel<T><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
      x, per_image, dense(per_image), ws.amax, ws.q, ws.xscale);
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
  launch_conv<true, false, true>(
      ConvArgs{static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wk),
               nullptr, nullptr, nullptr, static_cast<int32_t*>(acc), nullptr,
               nullptr, nullptr, nullptr, n, h, w, c, c, 1},
      static_cast<cudaStream_t>(stream));
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
      ws.f, per_image, dense(per_image), ws.oamax, static_cast<int8_t*>(outq),
      static_cast<float*>(outs));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
