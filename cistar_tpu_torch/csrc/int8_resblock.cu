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
// (int8_common.cuh and wgmma_conv.cuh, shared with K3 and K5-K8):
//
//   absmax_kernel        per-image max |x| (atomicMax on the float bits,
//                        valid because |x| >= 0)
//   quant_pad_kernel     x * (127 / amax) -> rint -> clip -> int8, written
//                        straight into the reflect-padded (N, H+2, W+2, C)
//                        layout the conv reads, border included (K2: its
//                        int8 input is copied there by reflect_pad_kernel)
//   wg_conv_kernel       implicit GEMM, M = N*H*W pixels, N = Cout, K =
//                        9*Cin, on wgmma.mma_async s8 with TMA loads into a
//                        ring of mbarrier stages (wgmma_conv.cuh). The
//                        epilogue dequantizes, writes fp32 f and adds each
//                        (image, channel)'s sum f, sum f^2 and max f into
//                        global statistics with atomics.
//   in_stats_kernel      IN finalize (mean, E[f^2]-mean^2 clamped >= 0,
//                        eps) and the requantization scale without a pass
//                        over f: rsigma > 0 and ReLU is monotone, so
//                        max |relu(IN(f))| = max_c relu((max f_c - mean_c)
//                        * rsigma_c), exactly, in fp32.
//   in_relu_quant_pad_kernel  relu(IN(f)) * (127 / rmax) -> int8, padded
//   in_skip_out_kernel   IN(f2) + skip -> carrier dtype (K2: fp32 hnew and
//                        its per-image absmax, then quant_kernel)
//
// A shape outside wg_tile_ok (W neither a divisor nor a multiple of 128)
// takes conv_s8_kernel (int8_common.cuh: cp.async + mma.sync, which
// computes the reflect index in its loader) on the unpadded layout, with
// quant_kernel / in_relu_quant_kernel: a choice by shape, reported by
// cistar_resblock_conv_variant.
//
// What bounds it. At the trunk shape one block does 2 convs x 1024 px x 9 x
// 512 x 512 MACs per image, 9.66 G int8 operations, against 2 MiB of bf16
// carrier (in and out) and 4.7 MB of weights per launch: operation-bound
// on an H100 (1,979 dense int8 TOPS vs 3.35 TB/s). The fp32 intermediate f
// still makes a round trip through device memory (the TPU kernel kept it
// in VMEM); that is work for a later change.
//
// Numerics: the rules of int8_common.cuh (IEEE division, rintf, no FMA
// contraction). The statistics are summed with atomics, so a requantized
// LSB can flip against the plain version: whole blocks are compared
// within a tolerance, the int32 accumulators of the conv
// (conv3x3_reflect_s8_acc) bit for bit.
//
// K1's bn form (bn = 1; the TPU kernel's bn=True, the BatchNorm ResnetBlock
// of pix2pixHD's MultiscaleGlobalGenerator): the inference BatchNorm is an
// affine already folded into the sb rows (quantize_resblock_bn), so there is
// no IN. Each conv's epilogue adds no statistic; conv 1 keeps the max f of
// each (image, channel), which gives the requantization scale
// max(0, max_c max f_c) / 127 exactly. The IN passes then run with mean 0
// and rsigma 1, which leave f unchanged. The only reduction across CTAs is
// a max, which does not depend on order: the bn form equals its plain
// version bit for bit.
//
// Interface: plain C, loaded with ctypes. Every entry returns
// cudaGetLastError() as an int. Nothing here allocates: the caller passes
// a workspace of cistar_resblock_workspace_bytes() bytes.

#include "wgmma_conv.cuh"

namespace {

// ---------------------------------------------------------------------------
// Workspace layout, shared by both blocks (sizes in bytes, 256-aligned).
struct Workspace {
  int8_t* q;       // N*(H+2)*(W+2)*C int8: quantized conv input (x, then
                   // relu(IN(f))), reflect-padded for wg_conv_kernel
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

size_t workspace_layout(long n, long h, long w, long c, char* base, Workspace* wsp) {
  const size_t mc = static_cast<size_t>(n * h * w * c), nc = static_cast<size_t>(n * c);
  Carver cv{base};
  Workspace ws;
  ws.q = cv.take<int8_t>(static_cast<size_t>(n * (h + 2) * (w + 2) * c));
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
  if (wsp != nullptr) *wsp = ws;
  return cv.off;
}

bool shape_ok(int n, int h, int w, int c) {
  // C % 128: the widest tiles (BN 128, BK 64), as slice 1 measured K1/K2
  return conv_shape_ok(n, h, w, c, c) && c % 128 == 0;
}

// in_relu_quant_kernel (one scale per image) into the padded layout.
__global__ void in_relu_quant_pad_kernel(const float* __restrict__ f, long per_image,
                                         const float* __restrict__ mean,
                                         const float* __restrict__ rsig,
                                         const float* __restrict__ rinv,
                                         int8_t* __restrict__ qp, int h, int w, int c) {
  const int n = blockIdx.y;
  const long e = (static_cast<long>(blockIdx.x) * EW_THREADS + threadIdx.x) * EW_VEC;
  if (e >= per_image) return;
  const int c0 = static_cast<int>(e % c);
  const float inv = rinv[n];
  const float* mu = mean + static_cast<long>(n) * c + c0;
  const float* rs = rsig + static_cast<long>(n) * c + c0;
  float v[EW_VEC];
  load8<float>(f + n * per_image + e, v);
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i)
    v[i] = __fmul_rn(fmaxf(__fmul_rn(__fsub_rn(v[i], mu[i]), rs[i]), 0.f), inv);
  store8_s8_padded(qp + static_cast<long>(n) * (h + 2) * (w + 2) * c, e, h, w, c, v);
}

// Clears the statistics (sum, sum of squares: 0; max: 0xFF bytes, which
// atomic_max_float treats as below every value), then one conv of q
// (padded where wg: the layout of wg_variant_s8). bn: no sums, the max only.
template <bool WANT_MAX>
cudaError_t conv_stats(const Workspace& ws, const int8_t* q, const int8_t* wk,
                       const float* xs, const float* wscale, const float* bias, int n,
                       int h, int w, int c, bool bn, bool wg, cudaStream_t st) {
  const size_t nc = static_cast<size_t>(n) * c;
  if (!bn) cudaMemsetAsync(ws.st_sum, 0, 2 * nc * 4, st);
  if (WANT_MAX) cudaMemsetAsync(ws.st_max, 0xFF, nc * 4, st);
  const ConvArgs a{q, wk, xs, wscale, bias, nullptr, ws.f, bn ? nullptr : ws.st_sum,
                   bn ? nullptr : ws.st_sq, ws.st_max, n, h, w, c, c, 1};
  if (wg) return launch_wg_conv<int8_t, EPI_STATS, WANT_MAX>(q, true, wk, a, st);
  launch_conv<EPI_STATS, WANT_MAX, true>(a, st);
  return cudaSuccess;
}

// conv 1 -> IN (bn: the folded affine) -> ReLU -> requantize into ws.q ->
// conv 2, leaving f2 in ws.f and its IN statistics in ws.mean / ws.rsig
// (bn: 0 and 1). xq: conv 1 input (padded where wg), xs: its scale.
cudaError_t block_body(const Workspace& ws, const int8_t* xq, const float* xs,
                       const int8_t* w1k, const int8_t* w2k, const float* sb, int n,
                       int h, int w, int c, float eps, bool bn, bool wg, cudaStream_t st) {
  const long per_image = static_cast<long>(h) * w * c;
  const float hw = static_cast<float>(h * w);
  cudaError_t e = conv_stats<true>(ws, xq, w1k, xs, sb, sb + c, n, h, w, c, bn, wg, st);
  if (e != cudaSuccess) return e;
  in_stats_kernel<true><<<n, EW_THREADS, 0, st>>>(ws.st_sum, ws.st_sq, ws.st_max, c,
                                                  hw, eps, ws.mean, ws.rsig,
                                                  ws.rinv, ws.rscale, bn);
  if (wg)
    in_relu_quant_pad_kernel<<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
        ws.f, per_image, ws.mean, ws.rsig, ws.rinv, ws.q, h, w, c);
  else
    in_relu_quant_kernel<<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
        ws.f, per_image, c, c, ws.mean, ws.rsig, ws.rinv, ws.q);
  e = conv_stats<false>(ws, ws.q, w2k, ws.rscale, sb + 2 * c, sb + 3 * c, n, h, w, c, bn,
                        wg, st);
  if (e != cudaSuccess) return e;
  in_stats_kernel<false><<<n, EW_THREADS, 0, st>>>(ws.st_sum, ws.st_sq, nullptr, c,
                                                   hw, eps, ws.mean, ws.rsig,
                                                   nullptr, nullptr, bn);
  return cudaSuccess;
}

template <typename T>
int resblock_bf16io(const T* x, const int8_t* w1k, const int8_t* w2k,
                    const float* sb, T* out, void* workspace, int n, int h, int w,
                    int c, float eps, bool bn, cudaStream_t st) {
  Workspace ws;
  workspace_layout(n, h, w, c, static_cast<char*>(workspace), &ws);
  const long per_image = static_cast<long>(h) * w * c;
  const bool wg = wg_variant_s8(n, h, w, c) != 0;
  cudaMemsetAsync(ws.amax, 0, n * 4, st);
  absmax_kernel<T><<<dim3(16, n), EW_THREADS, 0, st>>>(x, per_image, dense(per_image),
                                                       ws.amax);
  if (wg)
    quant_pad_kernel<T><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
        x, per_image, ws.amax, ws.q, ws.xscale, h, w, c);
  else
    quant_kernel<T><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
        x, per_image, dense(per_image), ws.amax, ws.q, ws.xscale);
  const cudaError_t e = block_body(ws, ws.q, ws.xscale, w1k, w2k, sb, n, h, w, c, eps, bn,
                                   wg, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  in_skip_out_kernel<T, T, false><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
      ws.f, per_image, c, ws.mean, ws.rsig, x, nullptr, out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

size_t cistar_resblock_workspace_bytes(int n, int h, int w, int c) {
  return workspace_layout(n, h, w, c, nullptr, nullptr);
}

// Which conv the blocks and the RAW entry run at (n, h, w, c): the BN of
// wg_conv_kernel (128 or 256), or 0 for conv_s8_kernel.
int cistar_resblock_conv_variant(int n, int h, int w, int c) {
  return wg_variant_s8(n, h, w, c);
}

// int32 accumulators of the reflect-pad-1 3x3 conv: xq (N,H,W,C) int8,
// wk (C, 9*C) int8 -> acc (N,H,W,C) int32. xpad: (N, H+2, W+2, C) int8
// scratch for the padded input of wg_conv_kernel.
int cistar_conv3x3_reflect_s8_acc(const void* xq, const void* wk, void* acc, void* xpad,
                                  int n, int h, int w, int c, void* stream) {
  if (!shape_ok(n, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* wp = static_cast<const int8_t*>(wk);
  const ConvArgs a{x, wp, nullptr, nullptr, nullptr, static_cast<int32_t*>(acc), nullptr,
                   nullptr, nullptr, nullptr, n, h, w, c, c, 1};
  if (wg_variant_s8(n, h, w, c) != 0) {
    int8_t* xp = static_cast<int8_t*>(xpad);
    launch_reflect_pad(x, xp, n, h, w, c, st);
    const cudaError_t e = launch_wg_conv<int8_t, EPI_RAW, false>(xp, true, wp, a, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    launch_conv<EPI_RAW, false, true>(a, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1: x, out (N,H,W,C) bf16 (is_bf16 = 1) or fp32; sb (4, C) fp32 rows
// [w1_scale, b1, w2_scale, b2]; bn = 1: the BatchNorm form, the norm folded
// into sb (quantize_resblock_bn), no IN.
int cistar_resblock_int8_bf16io(const void* x, int is_bf16, const void* w1k,
                                const void* w2k, const void* sb, void* out,
                                void* workspace, int n, int h, int w, int c,
                                float eps, int bn, void* stream) {
  if (!shape_ok(n, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(w1k);
  const int8_t* b = static_cast<const int8_t*>(w2k);
  const float* s = static_cast<const float*>(sb);
  if (is_bf16)
    return resblock_bf16io(static_cast<const __nv_bfloat16*>(x), a, b, s,
                           static_cast<__nv_bfloat16*>(out), workspace, n, h, w, c,
                           eps, bn != 0, st);
  return resblock_bf16io(static_cast<const float*>(x), a, b, s,
                         static_cast<float*>(out), workspace, n, h, w, c, eps, bn != 0,
                         st);
}

// K2: hq (N,H,W,C) int8 + hs (N,) fp32 -> outq (N,H,W,C) int8 + outs (N,).
int cistar_resblock_int8(const void* hq, const void* hs, const void* w1k,
                         const void* w2k, const void* sb, void* outq, void* outs,
                         void* workspace, int n, int h, int w, int c, float eps,
                         void* stream) {
  if (!shape_ok(n, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Workspace ws;
  workspace_layout(n, h, w, c, static_cast<char*>(workspace), &ws);
  const long per_image = static_cast<long>(h) * w * c;
  const int8_t* xq = static_cast<const int8_t*>(hq);
  const float* xs = static_cast<const float*>(hs);
  const bool wg = wg_variant_s8(n, h, w, c) != 0;
  if (wg) launch_reflect_pad(xq, ws.q, n, h, w, c, st);
  const cudaError_t e = block_body(ws, wg ? ws.q : xq, xs, static_cast<const int8_t*>(w1k),
                                   static_cast<const int8_t*>(w2k),
                                   static_cast<const float*>(sb), n, h, w, c, eps, false,
                                   wg, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaMemsetAsync(ws.oamax, 0, n * 4, st);
  in_skip_out_kernel<int8_t, float, true><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
      ws.f, per_image, c, ws.mean, ws.rsig, xq, xs, ws.f, ws.oamax);
  quant_kernel<float><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
      ws.f, per_image, dense(per_image), ws.oamax, static_cast<int8_t*>(outq),
      static_cast<float*>(outs));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
