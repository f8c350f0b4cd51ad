// Int8 atrous kernels for Hopper (sm_90a): K5 and K6 of the port, the two
// int8 kernels of the bilinear_content generator's engine.
//
// Replaces the TPU kernels
//   K5  cistar_tpu/ops/quant_pallas.py::_atrous_resblock_int8_kernel
//       (launched by _run_atrous_resblock_int8): one ResidualBlockAtrous.
//   K6  cistar_tpu/ops/quant_pallas.py::_multi_atrous_stage_int8_kernel
//       (launched by _run_multi_atrous_stage_int8): one stride-2
//       MultiAtrousConv encoder stage.
//
// K5, per image: quantize the carrier (one absmax per image) -> four 3x3
//   zero-pad convs at dilation 2/4/6/8, each int8 x int8 -> int32 ->
//   dequantize (x_scale * w_scale) + bias -> IN -> ReLU -> sum of the four,
//   in branch order -> requantize the sum per image -> reflect-pad-1 3x3
//   conv -> IN -> + full-precision skip.
// K6, per image: quantize x[2i, 2j, :] (the absmax too is over those
//   pixels only) -> four 3x3 zero-pad convs at dilation 1/2/3/4, Cin ->
//   Cout, each dequantized + bias -> IN -> ReLU -> their sum, in the input's
//   dtype. A stride-2 conv with an even rate r reads only even pixels, so
//   this is exactly the stride-2 stage at rates 2/4/6/8 on x.
//
// Design. The TPU kernels hold a whole image in VMEM (~9 MB per image for
// K5, atrous_block_fits) and reduce inside one grid step. A Hopper block
// has 227 KB of shared memory, so each kernel is a short sequence of
// launches on PyTorch's current stream, built from K1's pieces
// (int8_common.cuh, wgmma_conv.cuh):
//   absmax_kernel, quant_kernel   per-image quantize; K6 reads the
//                                 full-resolution x at stride 2, so no
//                                 subsampled copy is made
//   wg_conv_kernel (one launch)   the four zero-pad branch convs on wgmma +
//                                 TMA (BN 128, one persistent block an SM
//                                 walking the four branches' tiles, which
//                                 measured 15% faster than one block a tile
//                                 and 20% faster than four launches at
//                                 batch 32): tap (ky, kx) at rate r is the box
//                                 at (x0 + (kx-1)*r, y0 + (ky-1)*r) of the
//                                 unpadded input, and TMA fills zeros
//                                 outside the image (a box may lie wholly
//                                 outside). Each branch writes its fp32 f_b
//                                 and adds its (image, channel) sum and sum
//                                 of squares into global statistics with
//                                 atomics.
//   in_stats_kernel               IN finalize for the four branches at once
//   branch_sum_kernel             sum_b relu(IN f_b), in branch order; K5
//                                 writes it over f_0 with its per-image
//                                 absmax, K6 writes it out in the input dtype
//   K5 only: quant_pad_kernel (the branch sum, straight into the
//            reflect-padded layout TMA reads) -> wg_conv_kernel (reflect,
//            EPI_STATS) -> in_stats_kernel -> in_skip_out_kernel.
// K1's requantization shortcut (max |relu(IN f)| from per-channel maxima)
// does not hold for a sum of four branches, so K5 reduces |sum| for real.
// A shape outside wg_tile_ok takes conv_s8_kernel (cp.async + mma.sync,
// four launches, zero taps filled in shared memory; reflect index in the
// loader) on unpadded inputs: K6 at every path shape, whose 64 input
// channels are half a K stage. A choice by shape, reported by
// cistar_atrous_conv_variant.
//
// What bounds it. K5 at (32, 64, 64, 128): 5 convs x 131,072 px x 9 x 128 x
// 128 MACs = 1.93e11 int8 operations, 0.098 ms at 1,979 dense int8 TOPS,
// against 67 MB of bf16 carrier in and out (0.020 ms at 3.35 TB/s):
// operation-bound. K6 at (32, 64, 64, 64 -> 128): 4 convs, 7.7e10
// operations (0.039 ms) against 50 MB of carrier read (the even pixels
// only) and written (0.015 ms): operation-bound too. Both send each
// branch's fp32 f_b through device memory, which the TPU kernel kept in
// VMEM: K5 moves ~970 MB at batch 32 (the four f_b written and read back,
// the branch sum, the fifth conv's f), ~0.29 ms at 3.35 TB/s, more than
// its convs take at the wgmma conv's rate. Keeping f_b on chip is work for
// a later change.
//
// Numerics: the rules of int8_common.cuh. The IN statistics are summed with
// atomics in a changing order: K6's output can differ from the plain
// version by a bf16 ulp, K5's requantized sum by an LSB. The int32
// accumulators (cistar_conv3x3_zero_s8_acc, on K5's route at every rate)
// are compared bit for bit.
//
// Interface: plain C, loaded with ctypes. Every entry returns
// cudaGetLastError() as an int. Nothing here allocates: the caller passes a
// workspace of cistar_atrous_workspace_bytes() bytes.

#include "wgmma_conv.cuh"

namespace {

constexpr int NB = 4;  // branches
// BN of the wgmma conv here: K5's convs have Cout 128 (where wg_bn too
// answers 128), so one build serves them
constexpr int ATROUS_BN = 128;

// The conv the branch convs, K5's reflect conv and the RAW entry run at
// (n, h, w, cin -> cout): BN 128 of wg_conv_kernel, or 0 for
// conv_s8_kernel.
int conv_variant(int n, int h, int w, int cin, int cout) {
  return wg_tile_ok(n, h, w, cin, cout, 1) ? ATROUS_BN : 0;
}

// The wgmma conv of this library: BN 128, persistent blocks (9 K stages a
// tile at Cin 128).
template <int EPI>
cudaError_t atrous_wg_conv(const int8_t* x, bool padded, const int8_t* wk,
                           const ConvArgs& a, cudaStream_t st) {
  return launch_wg_conv_bn<ATROUS_BN, int8_t, EPI, false, 3, float, true>(x, padded, wk, a,
                                                                          st);
}

// out = sum_b relu((f_b - mean_b) * rsig_b), added in branch order from 0.
// f: NB slabs of (N, per_image) fp32, branch_stride apart; mean / rsig:
// (NB, N, C). ABSMAX adds the per-image max of the (non-negative) sum to
// amax. out may alias f's slab 0: each element is read, then written, by
// the same thread.
template <typename TO, bool ABSMAX>
__global__ void branch_sum_kernel(const float* f, long per_image, long branch_stride,
                                  int C, int n_images, const float* __restrict__ mean,
                                  const float* __restrict__ rsig, TO* out,
                                  float* __restrict__ amax) {
  const int n = blockIdx.y;
  const long e = (static_cast<long>(blockIdx.x) * EW_THREADS + threadIdx.x) * EW_VEC;
  float m = 0.f;
  if (e < per_image) {
    const int c0 = static_cast<int>(e % C);
    float v[EW_VEC], fb[EW_VEC];
#pragma unroll
    for (int i = 0; i < EW_VEC; ++i) v[i] = 0.f;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const long o = (static_cast<long>(b) * n_images + n) * C + c0;
      load8<float>(f + b * branch_stride + n * per_image + e, fb);
#pragma unroll
      for (int i = 0; i < EW_VEC; ++i)
        v[i] = __fadd_rn(v[i], fmaxf(__fmul_rn(__fsub_rn(fb[i], mean[o + i]), rsig[o + i]),
                                     0.f));
    }
#pragma unroll
    for (int i = 0; i < EW_VEC; ++i) m = fmaxf(m, v[i]);
    store8<TO>(out + n * per_image + e, v);
  }
  if (ABSMAX) block_absmax_to(m, amax + n);
}

struct AtrousWs {
  int8_t* q;      // N*(H+2)*(W+2)*max(Cin, Cout) int8: the quantized
                  // input, then (K5) the quantized branch sum, reflect-
                  // padded on the wgmma route
  float* f;       // NB * N*HW*Cout fp32: the branch outputs f_b; K5 puts
                  // the branch sum, then the reflect conv's output, in slab 0
  float* st_sum;  // NB*N*Cout, followed by
  float* st_sq;   // NB*N*Cout (one memset clears both)
  float* mean;    // NB*N*Cout
  float* rsig;    // NB*N*Cout
  float* amax;    // N: absmax of the input
  float* xscale;  // N: its quantization scale
  float* samax;   // N: absmax of the branch sum (K5)
  float* sscale;  // N: its quantization scale
};

size_t atrous_layout(long n, long h, long w, long cin, long cout, char* base,
                     AtrousWs* wsp) {
  const size_t mc = static_cast<size_t>(n * h * w * cout);
  const size_t nbc = static_cast<size_t>(NB * n * cout);
  Carver cv{base};
  AtrousWs ws;
  const long cmax = cin > cout ? cin : cout;
  ws.q = cv.take<int8_t>(static_cast<size_t>(n * (h + 2) * (w + 2) * cmax));
  ws.f = cv.take<float>(NB * mc * 4);
  ws.st_sum = cv.take<float>(2 * nbc * 4);
  ws.st_sq = ws.st_sum ? ws.st_sum + nbc : nullptr;
  ws.mean = cv.take<float>(nbc * 4);
  ws.rsig = cv.take<float>(nbc * 4);
  ws.amax = cv.take<float>(n * 4);
  ws.xscale = cv.take<float>(n * 4);
  ws.samax = cv.take<float>(n * 4);
  ws.sscale = cv.take<float>(n * 4);
  if (wsp != nullptr) *wsp = ws;
  return cv.off;
}

// Quantize per image (sub picks the pixels read), then the four branch
// convs and the IN finalize of each, leaving f_b in ws.f's slabs and their
// statistics in ws.mean / ws.rsig. wbk: (NB, Cout, 9*Cin); sb rows
// [s0, b0, s1, b1, s2, b2, s3, b3, ...], each Cout wide. The convs are one
// wgmma launch where conv_variant allows, else four conv_s8_kernel ones.
template <typename T>
cudaError_t branches(const AtrousWs& ws, const T* x, Sub sub, const int8_t* wbk,
                     const float* sb, int n, int h, int w, int cin, int cout,
                     const int* rates, float eps, cudaStream_t st) {
  const long per_in = static_cast<long>(h) * w * cin;
  const long mc = static_cast<long>(n) * h * w * cout;
  const size_t nc = static_cast<size_t>(n) * cout;
  cudaMemsetAsync(ws.amax, 0, n * 4, st);
  absmax_kernel<T><<<dim3(16, n), EW_THREADS, 0, st>>>(x, per_in, sub, ws.amax);
  quant_kernel<T><<<ew_grid(per_in, n), EW_THREADS, 0, st>>>(x, per_in, sub, ws.amax,
                                                             ws.q, ws.xscale);
  cudaMemsetAsync(ws.st_sum, 0, 2 * NB * nc * 4, st);
  if (conv_variant(n, h, w, cin, cout) != 0) {
    // weights (NB*Cout, 9*Cin); branch b's f, statistics and sb rows at the
    // offsets of ConvArgs::branches
    ConvArgs a{ws.q, wbk, ws.xscale, sb, sb + cout, nullptr, ws.f, ws.st_sum,
               ws.st_sq, nullptr, n, h, w, cin, cout, 1};
    a.branches = NB;
    for (int b = 0; b < NB; ++b) a.bdil[b] = rates[b];
    a.sb_stride = 2 * cout;
    const cudaError_t e = atrous_wg_conv<EPI_STATS>(ws.q, false, wbk, a, st);
    if (e != cudaSuccess) return e;
  } else {
    for (int b = 0; b < NB; ++b)
      launch_conv<EPI_STATS, false, false>(
          ConvArgs{ws.q, wbk + static_cast<long>(b) * cout * 9 * cin, ws.xscale,
                   sb + 2 * b * cout, sb + (2 * b + 1) * cout, nullptr,
                   ws.f + b * mc, ws.st_sum + b * nc, ws.st_sq + b * nc, nullptr, n,
                   h, w, cin, cout, rates[b]},
          st);
  }
  in_stats_kernel<false><<<NB * n, EW_THREADS, 0, st>>>(
      ws.st_sum, ws.st_sq, nullptr, cout, static_cast<float>(h * w), eps, ws.mean,
      ws.rsig, nullptr, nullptr);
  return cudaSuccess;
}

template <typename T>
int atrous_resblock(const T* x, const int8_t* wbk, const int8_t* wck, const float* sb,
                    T* out, void* workspace, int n, int h, int w, int c,
                    const int* rates, float eps, cudaStream_t st) {
  AtrousWs ws;
  atrous_layout(n, h, w, c, c, static_cast<char*>(workspace), &ws);
  const long per_image = static_cast<long>(h) * w * c;
  const long mc = n * per_image;
  const size_t nc = static_cast<size_t>(n) * c;
  const bool wg = conv_variant(n, h, w, c, c) != 0;
  cudaError_t e = branches(ws, x, dense(per_image), wbk, sb, n, h, w, c, c, rates, eps, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaMemsetAsync(ws.samax, 0, n * 4, st);
  branch_sum_kernel<float, true><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
      ws.f, per_image, mc, c, n, ws.mean, ws.rsig, ws.f, ws.samax);
  if (wg)
    quant_pad_kernel<float><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
        ws.f, per_image, ws.samax, ws.q, ws.sscale, h, w, c);
  else
    quant_kernel<float><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
        ws.f, per_image, dense(per_image), ws.samax, ws.q, ws.sscale);
  cudaMemsetAsync(ws.st_sum, 0, nc * 4, st);
  cudaMemsetAsync(ws.st_sq, 0, nc * 4, st);
  const ConvArgs a{ws.q, wck, ws.sscale, sb + 2 * NB * c, sb + (2 * NB + 1) * c, nullptr,
                   ws.f, ws.st_sum, ws.st_sq, nullptr, n, h, w, c, c, 1};
  if (wg) {
    e = atrous_wg_conv<EPI_STATS>(ws.q, true, wck, a, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    launch_conv<EPI_STATS, false, true>(a, st);
  }
  in_stats_kernel<false><<<n, EW_THREADS, 0, st>>>(ws.st_sum, ws.st_sq, nullptr, c,
                                                   static_cast<float>(h * w), eps,
                                                   ws.mean, ws.rsig, nullptr, nullptr);
  in_skip_out_kernel<T, T, false><<<ew_grid(per_image, n), EW_THREADS, 0, st>>>(
      ws.f, per_image, c, ws.mean, ws.rsig, x, nullptr, out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int multi_atrous_stage(const T* x, int hin, int win, const int8_t* wbk, const float* sb,
                       T* out, void* workspace, int n, int h, int w, int cin,
                       int cout, const int* rates, float eps, cudaStream_t st) {
  AtrousWs ws;
  atrous_layout(n, h, w, cin, cout, static_cast<char*>(workspace), &ws);
  const Sub sub{2, w, win, cin, static_cast<long>(hin) * win * cin};
  const cudaError_t e = branches(ws, x, sub, wbk, sb, n, h, w, cin, cout, rates, eps, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long per_out = static_cast<long>(h) * w * cout;
  branch_sum_kernel<T, false><<<ew_grid(per_out, n), EW_THREADS, 0, st>>>(
      ws.f, per_out, n * per_out, cout, n, ws.mean, ws.rsig, out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Workspace of K5 (cin = cout = C) or K6 at (n, h, w) output pixels.
size_t cistar_atrous_workspace_bytes(int n, int h, int w, int cin, int cout) {
  return atrous_layout(n, h, w, cin, cout, nullptr, nullptr);
}

// Which conv K5's and K6's branch convs, K5's reflect conv and
// cistar_conv3x3_zero_s8_acc run at (n, h, w, cin -> cout): the BN of
// wg_conv_kernel (128), or 0 for conv_s8_kernel.
int cistar_atrous_conv_variant(int n, int h, int w, int cin, int cout) {
  return conv_variant(n, h, w, cin, cout);
}

// int32 accumulators of the zero-pad 3x3 conv at dilation dil: xq
// (N,H,W,Cin) int8, wk (Cout, 9*Cin) int8 -> acc (N,H,W,Cout) int32. The
// conv of K5's branches at every rate (conv_variant).
int cistar_conv3x3_zero_s8_acc(const void* xq, const void* wk, void* acc, int n,
                               int h, int w, int cin, int cout, int dil,
                               void* stream) {
  if (!conv_shape_ok(n, h, w, cin, cout) || dil < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* wp = static_cast<const int8_t*>(wk);
  const ConvArgs a{x, wp, nullptr, nullptr, nullptr, static_cast<int32_t*>(acc), nullptr,
                   nullptr, nullptr, nullptr, n, h, w, cin, cout, dil};
  if (conv_variant(n, h, w, cin, cout) != 0) {
    const cudaError_t e = atrous_wg_conv<EPI_RAW>(x, false, wp, a, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    launch_conv<EPI_RAW, false, false>(a, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5: x, out (N,H,W,C) bf16 (is_bf16 = 1) or fp32; wbk (4, C, 9*C) and
// wck (C, 9*C) int8; sb (10, C) fp32 rows [s0, b0, ..., s3, b3, sc, bc];
// rates: the four branch dilations.
int cistar_atrous_resblock_int8(const void* x, int is_bf16, const void* wbk,
                                const void* wck, const void* sb, void* out,
                                void* workspace, int n, int h, int w, int c, int r0,
                                int r1, int r2, int r3, float eps, void* stream) {
  const int rates[NB] = {r0, r1, r2, r3};
  if (!conv_shape_ok(n, h, w, c, c) || r0 < 1 || r1 < 1 || r2 < 1 || r3 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(wbk);
  const int8_t* b = static_cast<const int8_t*>(wck);
  const float* s = static_cast<const float*>(sb);
  if (is_bf16)
    return atrous_resblock(static_cast<const __nv_bfloat16*>(x), a, b, s,
                           static_cast<__nv_bfloat16*>(out), workspace, n, h, w, c,
                           rates, eps, st);
  return atrous_resblock(static_cast<const float*>(x), a, b, s, static_cast<float*>(out),
                         workspace, n, h, w, c, rates, eps, st);
}

// K6: x (N, hin, win, Cin) bf16 (is_bf16 = 1) or fp32, read at x[:, ::2,
// ::2]; out (N, h, w, Cout) in x's dtype with h = ceil(hin / 2), w =
// ceil(win / 2); wbk (4, Cout, 9*Cin) int8; sb (8, Cout) fp32 rows
// [s0, b0, ..., s3, b3]; rates: the four dilations on the subsampled image.
int cistar_multi_atrous_stage_int8(const void* x, int is_bf16, int hin, int win,
                                   const void* wbk, const void* sb, void* out,
                                   void* workspace, int n, int h, int w, int cin,
                                   int cout, int r0, int r1, int r2, int r3, float eps,
                                   void* stream) {
  const int rates[NB] = {r0, r1, r2, r3};
  if (!conv_shape_ok(n, h, w, cin, cout) || h != (hin + 1) / 2 || w != (win + 1) / 2 ||
      r0 < 1 || r1 < 1 || r2 < 1 || r3 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(wbk);
  const float* s = static_cast<const float*>(sb);
  if (is_bf16)
    return multi_atrous_stage(static_cast<const __nv_bfloat16*>(x), hin, win, a, s,
                              static_cast<__nv_bfloat16*>(out), workspace, n, h, w, cin,
                              cout, rates, eps, st);
  return multi_atrous_stage(static_cast<const float*>(x), hin, win, a, s,
                            static_cast<float*>(out), workspace, n, h, w, cin, cout,
                            rates, eps, st);
}

}  // extern "C"
