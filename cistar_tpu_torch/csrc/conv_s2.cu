// The UNet's 7x7 stride-2 zero-pad-3 downs in bf16 for Hopper (sm_90a): K10
// of the port.
//
// Replaces no TPU kernel. The JAX package leaves these convs to XLA
// (cistar_tpu/models/fast_infer.py::unet_msrb_int8_apply, its down_{i}_conv
// loop), and so did the port, through F.conv2d: on an H100 cuDNN runs them on
// legacy non-tensor-core kernels (precomputed_ / implicit_convolve_sgemm),
// 41.1 ms of the int8 engine's ~60 ms call at batch 8, 71.5% of its device
// time. K10 moves them onto the tensor cores.
//
// y = bf16(bf16(conv(x, w)) + bf16(b)): x (N, H, W, Cin) bf16, w (Cout,
// 49*Cin) bf16, K-contiguous with k = tap*Cin + cin, tap = 7*dy + dx; the
// products summed in fp32, then the plain op's two roundings
// (ops/nn.py::conv2d, _add_bias). Output (N, H/2, W/2, Cout) bf16.
//
// What bounds it: operations. Each of the three downs (64 -> 128 channels
// out to 256², 128 -> 256 to 128², 256 -> 512 to 64²) does 2 * Ho * Wo *
// Cout * Cin * 49 = 52.6 GFLOP a frame against 26-51 MB of input, output
// and weights: 1,000-2,000 operations a byte, against the card's 295 (989
// bf16 TFLOP/s over 3.35 TB/s). All three at batch 8: 1,262.7 GFLOP, 1.28
// ms at the bf16 peak.
//
// Design: the implicit-GEMM conv of the family (wgmma_conv.cuh's
// wg_conv_kernel: one producer warp keeping TMA loads in flight into a ring
// of STAGES tiles, two consumer warpgroups on wgmma m64nBNk16, setmaxnreg,
// K-major operands with 128-byte swizzle), M = N * Ho * Wo output pixels, N
// = Cout, K = 49 * Cin in 64-channel (128-byte) stages, one tap a stage.
//   * The stride lives in the A operand's TMA box, not in address
//     arithmetic. The map over x has element strides of 2 on W and H and a
//     box of 2 * cols x 2 * rows pixels (cols x rows the tile's output
//     pixels), so tap (dy, dx) of a tile at output (y0, x0) is one box at
//     input (2*y0 + dy - 3, 2*x0 + dx - 3): every other pixel, packed into
//     the dense 128-pixel A tile the MMA reads. TMA's zero fill outside the
//     tensor is the pad of 3.
//   * BN by shape (s2_variant): 256 output channels a block where Cout
//     allows it and BN 128 would take more waves of 132 blocks (downs 2
//     and 3 at batch 8, down 2 at batch 1), else 128 (down 1, Cout 128;
//     down 3 at batch 1, whose 64 blocks of 256 would leave half the SMs
//     idle). Measured at batch 8 on an H100: down 2 0.604 ms at BN 256,
//     0.809 at 128; down 3 0.536 and 0.771; at batch 1 down 2 0.072 and
//     0.096, down 3 0.124 and 0.088. One block a tile: a persistent grid
//     (PERSIST) gained 2-3% at downs 1 and 2 and lost 9% at down 3.
//   * The epilogue (EPI_BF16) writes bf16 straight from the accumulators:
//     no fp32 round trip through device memory, no statistics (the IN +
//     ReLU that follow stay plain ops).
//
// The shape rule (s2_shape_ok): H and W even, Cin a multiple of 64 (a K
// stage lies in one tap), Cout a multiple of 128, and the family's tile
// rule on the output (Wo divides 128 or 128 divides Wo, Ho * Wo % 128 ==
// 0): a tile is whole output rows or 128 pixels of one, in one image, and
// its box at most 256 pixels a side. The three downs at 512² meet it at
// every batch.
//
// Interface: plain C, loaded with ctypes; each entry returns
// cudaGetLastError() as an int. Nothing here allocates.

#include "wgmma_conv.cuh"

namespace {

constexpr int S2_KK = 7, S2_STRIDE = 2;
constexpr int S2_KE = WG_KBYTES / 2;  // bf16 channels a K stage

bool s2_shape_ok(int n, int h, int w, int cin, int cout) {
  if (n <= 0 || h < 2 || w < 2 || h % 2 || w % 2 || cin <= 0 || cin % S2_KE ||
      cout <= 0 || cout % 128)
    return false;
  const int ho = h / 2, wo = w / 2;
  const bool rows = (wo <= WG_BM && WG_BM % wo == 0) || wo % WG_BM == 0;
  return rows && (static_cast<long>(ho) * wo) % WG_BM == 0;
}

// The BN of a launch, or 0 where the shape rule does not hold: 256 where
// Cout allows it and 128 would take more waves of WG_SMS blocks, else 128.
int s2_variant(int n, int h, int w, int cin, int cout) {
  if (!s2_shape_ok(n, h, w, cin, cout)) return 0;
  const long b256 = static_cast<long>(n) * (h / 2) * (w / 2) / WG_BM * (cout / 256);
  const auto waves = [](long blocks) { return (blocks + WG_SMS - 1) / WG_SMS; };
  return cout % 256 == 0 && waves(b256) < waves(2 * b256) ? 256 : 128;
}

template <int BN>
cudaError_t launch_s2(const __nv_bfloat16* x, const __nv_bfloat16* wk, const float* bias,
                      __nv_bfloat16* out, int n, int h, int w, int cin, int cout,
                      cudaStream_t st) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorInvalidValue;
  const int ho = h / 2, wo = w / 2;
  // the tile's output pixels: cols of a row, rows rows
  const cuuint32_t cols = static_cast<cuuint32_t>(wo < WG_BM ? wo : WG_BM);
  const cuuint32_t rows = WG_BM / cols;
  const cuuint64_t es = 2, c = cin, kc = static_cast<cuuint64_t>(S2_KK * S2_KK) * c;
  CUtensorMap tx, tw;
  const cuuint64_t xdim[4] = {c, static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t xstride[3] = {c * es, w * c * es, h * w * c * es};
  const cuuint32_t xbox[4] = {S2_KE, S2_STRIDE * cols, S2_STRIDE * rows, 1};
  const cuuint32_t xsteps[4] = {1, S2_STRIDE, S2_STRIDE, 1};
  if (enc(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<__nv_bfloat16*>(x), xdim,
          xstride, xbox, xsteps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cuuint64_t wdim[2] = {kc, static_cast<cuuint64_t>(cout)};
  const cuuint64_t wstride[1] = {kc * es};
  const cuuint32_t wbox[2] = {S2_KE, static_cast<cuuint32_t>(BN)};
  const cuuint32_t ones[2] = {1, 1};
  if (enc(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(wk), wdim,
          wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  ConvArgs a{nullptr, nullptr, nullptr, nullptr, bias, nullptr, nullptr, nullptr,
             nullptr, nullptr, n, ho, wo, cin, cout, 1};
  a.out = out;
  return wg_launch<__nv_bfloat16, BN, EPI_BF16, false, S2_KK, float, false, WG_KBYTES,
                   S2_STRIDE>(tx, tw, a, 0, st);
}

}  // namespace

extern "C" {

// The BN K10 runs at this shape (128 or 256), or 0 where it does not take
// it.
int cistar_conv7x7s2_bf16_variant(int n, int h, int w, int cin, int cout) {
  return s2_variant(n, h, w, cin, cout);
}

// K10: x (N,H,W,Cin) bf16, wk (Cout, 49*Cin) bf16, bias (Cout,) fp32 or
// null, out (N,H/2,W/2,Cout) bf16. Refuses a shape outside s2_shape_ok.
int cistar_conv7x7s2_bf16(const void* x, const void* wk, const void* bias, void* out, int n,
                          int h, int w, int cin, int cout, void* stream) {
  const int bn = s2_variant(n, h, w, cin, cout);
  if (bn == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(wk);
  const auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bn == 256 ? launch_s2<256>(xb, wb, b, o, n, h, w, cin, cout, st)
                                  : launch_s2<128>(xb, wb, b, o, n, h, w, cin, cout, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
