// Cout-tiled int8 residual block for Hopper (sm_90a): K7a and K7b of the
// port, the two kernels of the pix2pixHD GlobalGenerator's int8 trunk at
// its default width (1024 channels at 32x32 for a 512² input).
//
// Replaces the TPU kernels
//   K7a cistar_tpu/ops/quant_pallas.py::_resblock_a_kernel
//   K7b cistar_tpu/ops/quant_pallas.py::_resblock_b_kernel
// both launched by _run_resblock_int8_tiled.
//
// K7a, per image: quantize the carrier (one absmax per image; quantize_act,
//   which JAX runs in XLA before the kernel) -> reflect-pad-1 3x3 conv 1
//   over all of Cin, int8 x int8 -> int32 -> dequantize (x_scale * w_scale)
//   + bias -> IN -> ReLU -> int8 with one scale per (image, tile of ct
//   output channels).
// K7b, per image: reflect-pad-1 3x3 conv 2 whose K loop runs group by group
//   (group g = K7a's tile g of ct input channels): the exact int32 partial
//   of each group times that group's tile scale, summed in fp32 in group
//   order -> * w_scale + bias -> IN -> + full-precision skip.
//
// Design. On the TPU a (batch, tile) grid keeps the whole image in VMEM
// and streams one weight tile per step. Here each kernel is a short
// sequence of launches built from int8_common.cuh and wgmma_conv.cuh:
//   K7a: absmax_kernel, quant_pad_kernel (the int8 input written straight
//        into the reflect-padded (N, H+2, W+2, C) layout that TMA reads) ->
//        wg_conv_kernel (wgmma + TMA, K1's conv 1 at wg_bn's BN, 128 or
//        256: EPI_STATS, f and each (image, channel)'s sum, sum of squares
//        and max f) -> in_stats_kernel over (image, tile) rows, which gives
//        mean, rsigma and the tile's requantization scale without a pass
//        over f (IN then ReLU is monotone per channel, so max relu(IN f)
//        over a tile is max_c relu((max f_c - mean_c) * rsigma_c), exactly,
//        K1's rule per tile) -> in_relu_quant_kernel with the tile's scale.
//   K7b: reflect_pad_kernel (rq into the (N, H+2, W+2, C) copy that TMA
//        reads: TMA fills zeros, not reflections) -> wg_conv_kernel
//        (wgmma + TMA, BN 128, EPI_GSTATS: the K loop group by group, each
//        group's exact int32 partial times its tile scale added to an fp32
//        sum in group order, then the IN statistics) -> in_stats_kernel ->
//        in_skip_out_kernel.
// The numerical tile ct sets only the absmax groups and the scales; the
// CUDA tiles (K7a: 128 pixels x 128 or 256 couts x 128 of K per stage;
// K7b: 128 pixels x 128 couts x 128 of K) are independent of it. A shape
// outside wg_tile_ok (W = 48, say, or for K7b a tile of 64 channels) takes
// conv_s8_kernel on the unpadded int8 input: a choice by shape, reported
// by cistar_tiled_a_conv_variant (K7a) and cistar_tiled_conv_variant
// (K7b).
//
// What bounds it. At (16, 32, 32, 1024) each kernel does one conv: 16 x
// 1024 px x 9 x 1024 x 1024 MACs = 3.09e11 int8 operations, 0.156 ms at
// 1,979 dense int8 TOPS, against 34 MB of bf16 carrier, 17 MB of int8 and
// 9.4 MB of weights (under 0.03 ms at 3.35 TB/s): operation-bound. Both
// send fp32 f through device memory: K7a's passes move ~240 MB at that
// shape (~0.07 ms), most of it f written and read back. Keeping f on chip
// is work for a later change.
//
// Numerics: the rules of int8_common.cuh. The IN statistics are summed
// with atomics in a changing order, so a requantized LSB of K7a can flip
// against the plain version, and K7b's output moves by its effect. The
// int32 accumulators of every group of conv 2
// (cistar_conv3x3_reflect_grouped_s8_acc, on K7b's route) and of conv 1
// (cistar_conv3x3_reflect_s8_acc of int8_resblock.cu, the same template at
// the same BN) are compared bit for bit.
//
// The bn form (bn = 1; the TPU kernels' bn=True, the 512-channel trunk of
// pix2pixHD's MultiscaleGlobalGenerator at 64x64, ct 128): the inference
// BatchNorm is folded into the sb rows (quantize_resblock_bn), so neither
// kernel sums a statistic. K7a's conv keeps the max f of each (image,
// channel), and each (image, tile) scale is max(0, max over the tile of
// max f_c) / 127, exactly; K7b's conv writes f2 and the skip pass adds it
// to x. With the IN passes at mean 0 and rsigma 1 (which leave f as it
// is), every cross-CTA reduction left is a max: rq, rs and the output
// equal their plain versions bit for bit.
//
// Interface: plain C, loaded with ctypes. Every entry returns
// cudaGetLastError() as an int. Nothing here allocates: the caller passes a
// workspace of cistar_tiled_workspace_bytes() bytes.

#include "wgmma_conv.cuh"

namespace {

struct TiledWs {
  int8_t* q;       // N*(H+2)*(W+2)*C int8: the quantized block input (K7a;
                   // reflect-padded on the wgmma route), or K7b's
                   // reflect-padded rq
  float* f;        // M*C fp32: conv output
  float* st_sum;   // N*C, followed by
  float* st_sq;    // N*C and
  float* st_max;   // N*C (one memset clears the first two)
  float* mean;     // N*C
  float* rsig;     // N*C
  float* amax;     // N: absmax of the block input
  float* xscale;   // N: its quantization scale
  float* rinv;     // N*t: 127 / rmax of each (image, tile)
};

size_t tiled_layout(long n, long h, long w, long c, char* base, TiledWs* wsp) {
  const size_t mc = static_cast<size_t>(n * h * w * c), nc = static_cast<size_t>(n * c);
  Carver cv{base};
  TiledWs ws;
  ws.q = cv.take<int8_t>(static_cast<size_t>(n * (h + 2) * (w + 2) * c));
  ws.f = cv.take<float>(mc * 4);
  ws.st_sum = cv.take<float>(3 * nc * 4);
  ws.st_sq = ws.st_sum ? ws.st_sum + nc : nullptr;
  ws.st_max = ws.st_sum ? ws.st_sum + 2 * nc : nullptr;
  ws.mean = cv.take<float>(nc * 4);
  ws.rsig = cv.take<float>(nc * 4);
  ws.amax = cv.take<float>(n * 4);
  ws.xscale = cv.take<float>(n * 4);
  ws.rinv = cv.take<float>(nc * 4);  // N*t <= N*C
  if (wsp != nullptr) *wsp = ws;
  return cv.off;
}

// The conv K7b and the grouped RAW entry run at (n, h, w, c) in groups:
// BN 128 of wg_conv_kernel, or 0 for conv_s8_kernel.
int conv_variant(int n, int h, int w, int c, int groups) {
  return wg_tile_ok(n, h, w, c, c, 1, 3, groups) ? WG_BN_GROUPED : 0;
}

// Conv 2 of K7b or the RAW entry, group by group, of rq (N,H,W,C): on the
// wgmma conv via its reflect-padded copy qp where the shape allows.
template <int EPI>
cudaError_t grouped_conv(ConvArgs a, int8_t* qp, cudaStream_t st) {
  if (conv_variant(a.n, a.h, a.w, a.cin, a.groups) == 0) {
    launch_conv_wide<EPI, false, true>(a, st);
    return cudaSuccess;
  }
  launch_reflect_pad(a.xq, qp, a.n, a.h, a.w, a.cin, st);
  return launch_wg_conv_bn<WG_BN_GROUPED, int8_t, EPI, false>(qp, true, a.wk, a, st);
}

bool tiled_shape_ok(int n, int h, int w, int c, int ct) {
  return ct > 0 && c % ct == 0 && ct % 8 == 0 && c / ct <= EW_THREADS &&
         wide_shape_ok(n, h, w, c, c, c / ct);
}

template <typename T>
int tiled_a(const T* x, const int8_t* w1k, const float* sb, int8_t* rq, float* rs,
            void* workspace, int n, int h, int w, int c, int ct, float eps, bool bn,
            cudaStream_t st) {
  TiledWs ws;
  tiled_layout(n, h, w, c, static_cast<char*>(workspace), &ws);
  const long per_image = static_cast<long>(h) * w * c;
  const size_t nc = static_cast<size_t>(n) * c;
  const bool wg = wg_variant_s8(n, h, w, c) != 0;
  cudaMemsetAsync(ws.amax, 0, n * 4, st);
  absmax_kernel<T><<<absmax_grid(per_image, n), EW_THREADS, 0, st>>>(
      x, per_image, dense(per_image), ws.amax);
  if (wg)
    quant_pad_kernel<T><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
        x, per_image, ws.amax, ws.q, ws.xscale, h, w, c);
  else
    quant_kernel<T><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
        x, per_image, dense(per_image), ws.amax, ws.q, ws.xscale);
  // max: 0xFF bytes, which atomic_max_float treats as below every value
  if (!bn) cudaMemsetAsync(ws.st_sum, 0, 2 * nc * 4, st);
  cudaMemsetAsync(ws.st_max, 0xFF, nc * 4, st);
  const ConvArgs a{ws.q, w1k, ws.xscale, sb, sb + c, nullptr, ws.f,
                   bn ? nullptr : ws.st_sum, bn ? nullptr : ws.st_sq, ws.st_max, n, h, w,
                   c, c, 1};
  if (wg) {
    const cudaError_t e = launch_wg_conv<int8_t, EPI_STATS, true>(ws.q, true, w1k, a, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    launch_conv_wide<EPI_STATS, true, true>(a, st);
  }
  // one row of statistics per (image, tile): C = ct
  in_stats_kernel<true><<<n * (c / ct), EW_THREADS, 0, st>>>(
      ws.st_sum, ws.st_sq, ws.st_max, ct, static_cast<float>(h * w), eps, ws.mean,
      ws.rsig, ws.rinv, rs, bn);
  in_relu_quant_kernel<<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
      ws.f, per_image, c, ct, ws.mean, ws.rsig, ws.rinv, rq);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int tiled_b(const int8_t* rq, const float* rs, const int8_t* w2k, const float* sb,
            const T* x, T* out, void* workspace, int n, int h, int w, int c, int ct,
            float eps, bool bn, cudaStream_t st) {
  TiledWs ws;
  tiled_layout(n, h, w, c, static_cast<char*>(workspace), &ws);
  const long per_image = static_cast<long>(h) * w * c;
  const size_t nc = static_cast<size_t>(n) * c;
  if (!bn) cudaMemsetAsync(ws.st_sum, 0, 2 * nc * 4, st);
  ConvArgs a{rq, w2k, nullptr, sb + 2 * c, sb + 3 * c, nullptr, ws.f,
             bn ? nullptr : ws.st_sum, bn ? nullptr : ws.st_sq, nullptr, n, h, w, c, c,
             1};
  a.gs = rs;
  a.groups = c / ct;
  const cudaError_t e = grouped_conv<EPI_GSTATS>(a, ws.q, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  in_stats_kernel<false><<<n, EW_THREADS, 0, st>>>(ws.st_sum, ws.st_sq, nullptr, c,
                                                   static_cast<float>(h * w), eps,
                                                   ws.mean, ws.rsig, nullptr, nullptr,
                                                   bn);
  in_skip_out_kernel<T, T, false><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
      ws.f, per_image, c, ws.mean, ws.rsig, x, nullptr, out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

size_t cistar_tiled_workspace_bytes(int n, int h, int w, int c) {
  return tiled_layout(n, h, w, c, nullptr, nullptr);
}

// Which conv K7a runs at (n, h, w, c): the BN of wg_conv_kernel (128 or
// 256), or 0 for conv_s8_kernel.
int cistar_tiled_a_conv_variant(int n, int h, int w, int c) {
  return wg_variant_s8(n, h, w, c);
}

// Which conv K7b and cistar_conv3x3_reflect_grouped_s8_acc run at (n, h, w,
// c) in groups: the BN of wg_conv_kernel (128), or 0 for conv_s8_kernel.
int cistar_tiled_conv_variant(int n, int h, int w, int c, int groups) {
  return conv_variant(n, h, w, c, groups);
}

// int32 accumulators of the reflect-pad-1 3x3 conv, per input group: xq
// (N,H,W,C) int8, wk (C, 9*C) int8 -> acc (groups, N,H,W,C) int32, group g
// summing input channels [g*C/groups, (g+1)*C/groups). xpad: (N, H+2, W+2,
// C) int8 scratch for the padded input of wg_conv_kernel.
int cistar_conv3x3_reflect_grouped_s8_acc(const void* xq, const void* wk, void* acc,
                                          void* xpad, int n, int h, int w, int c,
                                          int groups, void* stream) {
  if (!wide_shape_ok(n, h, w, c, c, groups))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a{static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wk),
             nullptr, nullptr, nullptr, static_cast<int32_t*>(acc), nullptr,
             nullptr, nullptr, nullptr, n, h, w, c, c, 1};
  a.groups = groups;
  const cudaError_t e = grouped_conv<EPI_RAW>(a, static_cast<int8_t*>(xpad),
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// K7a: x (N,H,W,C) bf16 (is_bf16 = 1) or fp32; w1k (C, 9*C) int8; sb (4, C)
// fp32 rows [w1_scale, b1, w2_scale, b2] -> rq (N,H,W,C) int8 and rs
// (N, C/ct) fp32, the scale of each (image, tile). bn = 1: the BatchNorm
// form, the norm folded into sb, no IN (also in K7b).
int cistar_resblock_tiled_a(const void* x, int is_bf16, const void* w1k,
                            const void* sb, void* rq, void* rs, void* workspace,
                            int n, int h, int w, int c, int ct, float eps, int bn,
                            void* stream) {
  if (!tiled_shape_ok(n, h, w, c, ct)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wk = static_cast<const int8_t*>(w1k);
  const float* s = static_cast<const float*>(sb);
  int8_t* q = static_cast<int8_t*>(rq);
  float* r = static_cast<float*>(rs);
  if (is_bf16)
    return tiled_a(static_cast<const __nv_bfloat16*>(x), wk, s, q, r, workspace, n, h,
                   w, c, ct, eps, bn != 0, st);
  return tiled_a(static_cast<const float*>(x), wk, s, q, r, workspace, n, h, w, c, ct,
                 eps, bn != 0, st);
}

// K7b: rq, rs from K7a; w2k (C, 9*C) int8; sb as K7a; x the block input
// (the skip) -> out (N,H,W,C), both bf16 (is_bf16 = 1) or fp32.
int cistar_resblock_tiled_b(const void* rq, const void* rs, const void* w2k,
                            const void* sb, const void* x, int is_bf16, void* out,
                            void* workspace, int n, int h, int w, int c, int ct,
                            float eps, int bn, void* stream) {
  if (!tiled_shape_ok(n, h, w, c, ct)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(rq);
  const float* r = static_cast<const float*>(rs);
  const int8_t* wk = static_cast<const int8_t*>(w2k);
  const float* s = static_cast<const float*>(sb);
  if (is_bf16)
    return tiled_b(q, r, wk, s, static_cast<const __nv_bfloat16*>(x),
                   static_cast<__nv_bfloat16*>(out), workspace, n, h, w, c, ct, eps,
                   bn != 0, st);
  return tiled_b(q, r, wk, s, static_cast<const float*>(x), static_cast<float*>(out),
                 workspace, n, h, w, c, ct, eps, bn != 0, st);
}

}  // extern "C"
