// Int8 MSRB branch for Hopper (sm_90a): K8 of the port, the kernel of the
// UNet-MSRB generator's int8 trunk (pix2pixHD's r2l_MSRB deployment).
//
// Replaces the TPU kernel
//   K8  cistar_tpu/ops/quant_pallas.py::_msrb_branch_kernel
//       (launched by _run_msrb_branch, twice per stage by _run_msrb_stage).
//
// One branch, per image: a KKxKK zero-pad conv (KK 3, pad 1, or KK 5, pad
// 2) of an int8 input whose channels come in gin groups, each with its own
// per-image scale: the exact int32 partial of each group times its scale,
// summed in fp32 in group order -> * w_scale + bias -> ReLU -> either
// int8 with one scale per (image, tile of ct output channels) (stage 1,
// quant_out) or the float output (stage 2). An MSRB block runs it four
// times: stage 1 (3x3 and 5x5) on the input quantized per image (gin 1),
// stage 2 (3x3 and 5x5) on the two int8 stage-1 outputs side by side, whose
// 2t tile scales are the group scales (gin = 2t, cg = ct).
//
// Design. The TPU kernel holds one zero-padded image and one weight tile in
// VMEM per (image, tile) grid step. Here a branch is one launch of the
// wgmma + TMA conv (wgmma_conv.cuh, EPI_GRELU, BN 128) on the unpadded
// input: tap (ky, kx) of an M tile is one TMA box at (x0 + kx - KK/2, y0 +
// ky - KK/2), and TMA's zero fill outside the tensor is the zero padding
// (a 5x5 box may lie wholly outside: all zeros). Its K loop runs group by
// group (a group is 128 int8 channels at the ported shapes, so a 128-byte
// K stage lies in one tap of one group) and adds each group's exact int32
// partial times the group's scale to an fp32 sum, in group order. Stage 2
// writes its output dtype straight from the epilogue. Stage 1 writes fp32 f
// and each (image, tile)'s max with an integer atomicMax (f >= 0 after the
// ReLU), then quant_kernel quantizes per tile. The max does not depend on
// the order of the atomics, so stage 1's int8 output and scales are those
// of the plain version, bit for bit. A shape outside wg_tile_ok (a group of
// 64 channels, say) takes conv_s8_kernel (int8_common.cuh: cp.async +
// mma.sync, the zero-pad index in its loader): a choice by shape, reported
// by cistar_msrb_conv_variant.
//
// What bounds it. At (8, 64, 64, 512) -> 512 (stage 1) one 3x3 branch does
// 8 x 4096 px x 9 x 512 x 512 MACs = 1.55e11 int8 operations (0.078 ms at
// 1,979 dense int8 TOPS), the 5x5 branch 25/9 of that (0.217 ms); stage 2
// has twice the input channels (0.156 and 0.434 ms). The bytes (16-33 MB
// of int8 in, 17-34 MB out, up to 13 MB of weights) take under 0.03 ms at
// 3.35 TB/s: operation-bound. Stage 1's fp32 f still makes a round trip
// through device memory, and the two branches of a stage are two launches.
//
// Interface: plain C, loaded with ctypes. Every entry returns
// cudaGetLastError() as an int. Nothing here allocates: the caller passes a
// workspace of cistar_msrb_workspace_bytes() bytes.

#include "wgmma_conv.cuh"

namespace {

// The conv K8 and the RAW entry run at a shape: BN 128 of wg_conv_kernel,
// or 0 for conv_s8_kernel.
int conv_variant(int n, int h, int w, int cin, int cout, int kk, int groups) {
  return wg_tile_ok(n, h, w, cin, cout, 1, kk, groups) ? WG_BN_GROUPED : 0;
}

template <int KK>
cudaError_t launch_branch(const ConvArgs& a, bool wg, int quant_out, int is_bf16,
                          cudaStream_t st) {
  constexpr int B = WG_BN_GROUPED;
  const int8_t* x = a.xq;  // unpadded: TMA's zero fill is the padding
  if (wg && quant_out)
    return launch_wg_conv_bn<B, int8_t, EPI_GRELU, true, KK>(x, false, a.wk, a, st);
  if (wg && is_bf16)
    return launch_wg_conv_bn<B, int8_t, EPI_GRELU, false, KK, __nv_bfloat16>(x, false, a.wk,
                                                                            a, st);
  if (wg)
    return launch_wg_conv_bn<B, int8_t, EPI_GRELU, false, KK, float>(x, false, a.wk, a, st);
  if (quant_out)
    launch_conv_wide<EPI_GRELU, true, false, KK, float>(a, st);
  else if (is_bf16)
    launch_conv_wide<EPI_GRELU, false, false, KK, __nv_bfloat16>(a, st);
  else
    launch_conv_wide<EPI_GRELU, false, false, KK, float>(a, st);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The fp32 f of a quant_out branch and its tile maxima.
size_t cistar_msrb_workspace_bytes(int n, int h, int w, int cout, int ct) {
  Carver cv{nullptr};
  cv.take<float>(static_cast<size_t>(n) * h * w * cout * 4);
  cv.take<float>(static_cast<size_t>(n) * (cout / ct) * 4);
  return cv.off;
}

// Which conv K8 and cistar_conv_zero_grouped_s8_acc run at (n, h, w, cin ->
// cout, kk, groups): the BN of wg_conv_kernel (128), or 0 for
// conv_s8_kernel.
int cistar_msrb_conv_variant(int n, int h, int w, int cin, int cout, int kk, int groups) {
  return conv_variant(n, h, w, cin, cout, kk, groups);
}

// int32 accumulators of the zero-pad KKxKK conv (KK 3 or 5, pad KK/2), per
// input group: xq (N,H,W,Cin) int8, wk (Cout, KK*KK*Cin) int8 -> acc
// (groups, N,H,W,Cout) int32.
int cistar_conv_zero_grouped_s8_acc(const void* xq, const void* wk, void* acc, int n,
                                    int h, int w, int cin, int cout, int kk, int groups,
                                    void* stream) {
  if (!wide_shape_ok(n, h, w, cin, cout, groups) || (kk != 3 && kk != 5))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* wp = static_cast<const int8_t*>(wk);
  ConvArgs a{x, wp, nullptr, nullptr, nullptr, static_cast<int32_t*>(acc), nullptr,
             nullptr, nullptr, nullptr, n, h, w, cin, cout, 1};
  a.groups = groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int B = WG_BN_GROUPED;
  cudaError_t e = cudaSuccess;
  if (conv_variant(n, h, w, cin, cout, kk, groups) != 0)
    e = kk == 3 ? launch_wg_conv_bn<B, int8_t, EPI_RAW, false, 3>(x, false, wp, a, st)
                : launch_wg_conv_bn<B, int8_t, EPI_RAW, false, 5>(x, false, wp, a, st);
  else if (kk == 3)
    launch_conv_wide<EPI_RAW, false, false, 3>(a, st);
  else
    launch_conv_wide<EPI_RAW, false, false, 5>(a, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// K8, one branch: xq (N,H,W,Cin) int8 in gin groups with scales xs (N, gin)
// fp32; wk (Cout, KK*KK*Cin) int8; scale, bias (Cout,) fp32 (the branch's
// rows of the stage's sb). quant_out: out (N,H,W,Cout) int8 and os (N,
// Cout/ct) fp32 per-(image, tile) scales; else out in bf16 (is_bf16 = 1)
// or fp32, and os is untouched.
int cistar_msrb_branch_int8(const void* xq, const void* xs, int gin, const void* wk,
                            const void* scale, const void* bias, int kk, int quant_out,
                            int is_bf16, void* out, void* os, void* workspace, int n,
                            int h, int w, int cin, int cout, int ct, void* stream) {
  if (!wide_shape_ok(n, h, w, cin, cout, gin) || (kk != 3 && kk != 5) || ct <= 0 ||
      cout % ct || ct % 8 || cout / ct > EW_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Carver cv{static_cast<char*>(workspace)};
  const long per_image = static_cast<long>(h) * w * cout;
  float* f = cv.take<float>(static_cast<size_t>(n) * per_image * 4);
  float* tmax = cv.take<float>(static_cast<size_t>(n) * (cout / ct) * 4);
  ConvArgs a{static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wk), nullptr,
             static_cast<const float*>(scale), static_cast<const float*>(bias), nullptr,
             f, nullptr, nullptr, tmax, n, h, w, cin, cout, 1};
  a.gs = static_cast<const float*>(xs);
  a.groups = gin;
  a.out = out;
  a.ct = ct;
  const bool wg = conv_variant(n, h, w, cin, cout, kk, gin) != 0;
  if (quant_out) cudaMemsetAsync(tmax, 0, static_cast<size_t>(n) * (cout / ct) * 4, st);
  const cudaError_t e = kk == 3 ? launch_branch<3>(a, wg, quant_out, is_bf16, st)
                                : launch_branch<5>(a, wg, quant_out, is_bf16, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (quant_out)
    quant_kernel<float><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
        f, per_image, Sub{1, 1, 1, cout, per_image}, tmax, static_cast<int8_t*>(out),
        static_cast<float*>(os), ct);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
