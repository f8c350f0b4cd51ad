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
//   absmax_kernel, quant_kernel   per-image quantize (the absmax grid sized
//                                 to fill the card); K6 reads the
//                                 full-resolution x at stride 2 and writes
//                                 the subsampled q, so no other copy is
//                                 made
// K5:
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
//   branch_sum_kernel             sum_b relu(IN f_b), in branch order, over
//                                 f_0, with its per-image absmax
//   quant_pad_kernel (the branch sum, straight into the reflect-padded
//   layout TMA reads) -> wg_conv_kernel (reflect, EPI_STATS) ->
//   in_stats_kernel -> in_skip_out_kernel.
// K1's requantization shortcut (max |relu(IN f)| from per-channel maxima)
// does not hold for a sum of four branches, so K5 reduces |sum| for real.
// K6 keeps its branch outputs on chip: two passes over the same products,
// each a launch of wg_branch_kernel (wgmma_conv.cuh: a tile's K loop walks
// the four branches, 4 x 9 taps of 64 bytes, its A operand the tile's
// input and halo loaded once, each branch flushed by a warpgroup of its
// own while the next one's products run):
//   branch_weights_kernel          the weights as one swizzled B tile a K
//                                  stage (both passes read them)
//   wg_branch_kernel (EPI_BSTATS)  each branch's IN sums of f; writes no f
//   in_stats_kernel                IN finalize of the four branches
//   wg_branch_kernel (EPI_BSUM)    the same f, relu(IN f_b) added into
//                                  fp32 registers in branch order, the sum
//                                  written once in the input dtype:
//                                  branch_sum_kernel's ops, so given the
//                                  same statistics the output equals the
//                                  route through f_b bit for bit
// A shape outside wg_tile_ok takes conv_s8_kernel (cp.async + mma.sync,
// four launches, zero taps filled in shared memory; reflect index in the
// loader) on unpadded inputs. K6 off wg_branch_kernel's shapes (its 256²
// stage 1, 32 -> 64 channels) runs K5's branch convs and sends f_b through
// device memory to branch_sum_kernel. The conv's BN and K stage, by shape,
// are what cistar_atrous_conv_variant reports.
//
// What bounds it. K5 at (32, 64, 64, 128): 5 convs x 131,072 px x 9 x 128 x
// 128 MACs = 1.93e11 int8 operations, 0.098 ms at 1,979 dense int8 TOPS,
// against 67 MB of bf16 carrier in and out (0.020 ms at 3.35 TB/s):
// operation-bound. K6 at (32, 64, 64, 64 -> 128): 4 convs, 7.7e10
// operations (0.039 ms) against 50 MB of carrier read (the even pixels
// only) and written (0.015 ms): operation-bound too. K5 sends each
// branch's fp32 f_b through device memory, which the TPU kernel kept in
// VMEM: ~970 MB at batch 32 (the four f_b written and read back, the
// branch sum, the fifth conv's f), ~0.29 ms at 3.35 TB/s, more than its
// convs take at the wgmma conv's rate. K6's f_b would be 537 MB at batch
// 32 (0.16 ms, four times its bound); its two passes instead compute the
// products twice (0.078 ms at the int8 peak) and move ~75 MB.
//
// Numerics: the rules of int8_common.cuh. The IN statistics are summed with
// atomics in a changing order: K6's output can differ from the plain
// version by a bf16 ulp, K5's requantized sum by an LSB. The int32
// accumulators (cistar_conv3x3_zero_s8_acc, on K5's and K6's conv at
// every rate) are compared bit for bit.
//
// Interface: plain C, loaded with ctypes. Every entry returns
// cudaGetLastError() as an int. Nothing here allocates: the caller passes a
// workspace of cistar_atrous_workspace_bytes() bytes.

#include "wgmma_conv.cuh"

namespace {

constexpr int NB = 4;  // branches
// BN of the wgmma conv here: K5's and K6's convs have Cout 128 (where
// wg_bn too answers 128), so one build serves them
constexpr int ATROUS_BN = 128;

// The conv the branch convs, K5's reflect conv and the RAW entry run at
// (n, h, w, cin -> cout): 1000 * BN + the bytes of K a stage of
// wg_conv_kernel (128128, or 128064 where Cin is 64 bytes but not 128:
// K6's stage 2), or 0 for conv_s8_kernel.
int conv_variant(int n, int h, int w, int cin, int cout) {
  const int kb = wg_kbytes(n, h, w, cin, cout, 1);
  return kb != 0 ? 1000 * ATROUS_BN + kb : 0;
}

// The wgmma conv of this library: BN 128, persistent blocks (9 K stages a
// tile at Cin 128), K stages of 128 bytes where 128 divide Cin, else 64.
template <int EPI>
cudaError_t atrous_wg_conv(const int8_t* x, bool padded, const int8_t* wk,
                           const ConvArgs& a, cudaStream_t st) {
  if (a.cin % 128 == 0)
    return launch_wg_conv_bn<ATROUS_BN, int8_t, EPI, false, 3, float, true, 128>(x, padded,
                                                                                 wk, a, st);
  return launch_wg_conv_bn<ATROUS_BN, int8_t, EPI, false, 3, float, true, 64>(x, padded, wk,
                                                                             a, st);
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
                  // the branch sum, then the reflect conv's output, in slab
                  // 0 (null where K6 keeps them on chip)
  float* st_sum;  // NB*N*Cout, followed by
  float* st_sq;   // NB*N*Cout (one memset clears both)
  float* mean;    // NB*N*Cout
  float* rsig;    // NB*N*Cout
  float* amax;    // N: absmax of the input
  float* xscale;  // N: its quantization scale
  float* samax;   // N: absmax of the branch sum (K5)
  float* sscale;  // N: its quantization scale
  int8_t* wbulk;  // NB*Cout*9*Cin: K6's weights as B tiles (branch_weights_kernel)
};

// with_f: room for f_b (K5, and K6 off its fused passes).
size_t atrous_layout(long n, long h, long w, long cin, long cout, bool with_f, char* base,
                     AtrousWs* wsp) {
  const size_t mc = static_cast<size_t>(n * h * w * cout);
  const size_t nbc = static_cast<size_t>(NB * n * cout);
  Carver cv{base};
  AtrousWs ws;
  const long cmax = cin > cout ? cin : cout;
  ws.q = cv.take<int8_t>(static_cast<size_t>(n * (h + 2) * (w + 2) * cmax));
  ws.f = with_f ? cv.take<float>(NB * mc * 4) : nullptr;
  ws.st_sum = cv.take<float>(2 * nbc * 4);
  ws.st_sq = ws.st_sum ? ws.st_sum + nbc : nullptr;
  ws.mean = cv.take<float>(nbc * 4);
  ws.rsig = cv.take<float>(nbc * 4);
  ws.amax = cv.take<float>(n * 4);
  ws.xscale = cv.take<float>(n * 4);
  ws.samax = cv.take<float>(n * 4);
  ws.sscale = cv.take<float>(n * 4);
  ws.wbulk = cv.take<int8_t>(static_cast<size_t>(NB * cout * 9 * cin));
  if (wsp != nullptr) *wsp = ws;
  return cv.off;
}

// Quantize x per image into ws.q (dense, (N, per_in)) and ws.xscale; sub
// picks the pixels read. The absmax grid fills the card at small batches
// (absmax_grid); a max, so its result does not depend on the grid.
template <typename T>
void quantize_input(const AtrousWs& ws, const T* x, Sub sub, int n, long per_in,
                    cudaStream_t st) {
  cudaMemsetAsync(ws.amax, 0, n * 4, st);
  absmax_kernel<T><<<absmax_grid(per_in, n), EW_THREADS, 0, st>>>(x, per_in, sub, ws.amax);
  quant_kernel<T><<<ew_grid(per_in, n), EW_THREADS, 0, st>>>(x, per_in, sub, ws.amax,
                                                             ws.q, ws.xscale);
}

// The four branch convs of ws.q: weights wbk (NB*Cout, 9*Cin); branch b's
// f, statistics and sb rows at the offsets of ConvArgs::branches; K6's
// passes read the weights from ws.wbulk and a halo of the largest rate.
ConvArgs branch_args(const AtrousWs& ws, const int8_t* wbk, const float* sb, int n, int h,
                     int w, int cin, int cout, const int* rates) {
  ConvArgs a{ws.q, wbk, ws.xscale, sb, sb + cout, nullptr, ws.f, ws.st_sum,
             ws.st_sq, nullptr, n, h, w, cin, cout, 1};
  a.branches = NB;
  for (int b = 0; b < NB; ++b) a.bdil[b] = rates[b];
  a.sb_stride = 2 * cout;
  a.wbulk = ws.wbulk;
  for (int b = 0; b < NB; ++b) a.hpad = rates[b] > a.hpad ? rates[b] : a.hpad;
  return a;
}

// wbk (NB*Cout, 9*64) into ws.wbulk, the B tiles of K6's two passes.
void branch_weights(const AtrousWs& ws, const int8_t* wbk, int cout, cudaStream_t st) {
  launch_branch_weights(wbk, ws.wbulk, NB, cout, st);
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
  const long mc = static_cast<long>(n) * h * w * cout;
  const size_t nc = static_cast<size_t>(n) * cout;
  quantize_input(ws, x, sub, n, static_cast<long>(h) * w * cin, st);
  cudaMemsetAsync(ws.st_sum, 0, 2 * NB * nc * 4, st);
  if (conv_variant(n, h, w, cin, cout) != 0) {
    const ConvArgs a = branch_args(ws, wbk, sb, n, h, w, cin, cout, rates);
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
  atrous_layout(n, h, w, c, c, true, static_cast<char*>(workspace), &ws);
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

// K6's first half on the fused passes (stage_fused): quantize x[::2, ::2]
// and lay the weights out as B tiles, then pass A (the four branches' IN
// sums, no f written) and the IN finalize, leaving the statistics in
// ws.mean / ws.rsig.
template <typename T>
cudaError_t stage_stats(const AtrousWs& ws, const T* x, Sub sub, const int8_t* wbk,
                        const float* sb, int n, int h, int w, int cin, int cout,
                        const int* rates, float eps, cudaStream_t st) {
  const ConvArgs a = branch_args(ws, wbk, sb, n, h, w, cin, cout, rates);
  quantize_input(ws, x, sub, n, static_cast<long>(h) * w * cin, st);
  branch_weights(ws, wbk, cout, st);
  cudaMemsetAsync(ws.st_sum, 0, 2 * NB * static_cast<size_t>(n) * cout * 4, st);
  const cudaError_t e = launch_wg_branches<EPI_BSTATS, float>(ws.q, a, st);
  if (e != cudaSuccess) return e;
  in_stats_kernel<false><<<NB * n, EW_THREADS, 0, st>>>(
      ws.st_sum, ws.st_sq, nullptr, cout, static_cast<float>(h * w), eps, ws.mean,
      ws.rsig, nullptr, nullptr);
  return cudaSuccess;
}

// K6's second half: pass B, the branch sum of ws.q's four convs (weights
// in ws.wbulk) under the statistics in ws.mean / ws.rsig, written to out
// (N, h, w, Cout) as T.
template <typename T>
cudaError_t stage_sum(const AtrousWs& ws, const int8_t* wbk, const float* sb, T* out, int n,
                      int h, int w, int cin, int cout, const int* rates, cudaStream_t st) {
  ConvArgs a = branch_args(ws, wbk, sb, n, h, w, cin, cout, rates);
  a.mean = ws.mean;
  a.rsig = ws.rsig;
  a.out = out;
  return launch_wg_branches<EPI_BSUM, T>(ws.q, a, st);
}

// K6's route through f_b in device memory: the branch convs (EPI_STATS),
// then branch_sum_kernel. Its path off stage_fused's shapes.
template <typename T>
cudaError_t stage_via_f(const AtrousWs& ws, const T* x, Sub sub, const int8_t* wbk,
                        const float* sb, T* out, int n, int h, int w, int cin, int cout,
                        const int* rates, float eps, cudaStream_t st) {
  const cudaError_t e = branches(ws, x, sub, wbk, sb, n, h, w, cin, cout, rates, eps, st);
  if (e != cudaSuccess) return e;
  const long per_out = static_cast<long>(h) * w * cout;
  branch_sum_kernel<T, false><<<ew_grid(per_out, n), EW_THREADS, 0, st>>>(
      ws.f, per_out, n * per_out, cout, n, ws.mean, ws.rsig, out, nullptr);
  return cudaSuccess;
}

// Whether K6 takes its fused passes (wg_branch_kernel) at (n, h, w, cin ->
// cout) and rates: on the wgmma conv, Cin 64, and a halo of the largest
// rate that the kernel takes (wb_shape_ok); else the route through f_b.
bool stage_fused(int n, int h, int w, int cin, int cout, const int* rates) {
  int rmax = 0;
  for (int b = 0; b < NB; ++b) rmax = rates[b] > rmax ? rates[b] : rmax;
  return conv_variant(n, h, w, cin, cout) != 0 && wb_shape_ok(w, cin, rmax);
}

template <typename T>
int multi_atrous_stage(const T* x, int hin, int win, const int8_t* wbk, const float* sb,
                       T* out, void* workspace, int n, int h, int w, int cin,
                       int cout, const int* rates, float eps, cudaStream_t st) {
  const bool fused = stage_fused(n, h, w, cin, cout, rates);
  AtrousWs ws;
  atrous_layout(n, h, w, cin, cout, !fused, static_cast<char*>(workspace), &ws);
  const Sub sub{2, w, win, cin, static_cast<long>(hin) * win * cin};
  cudaError_t e;
  if (fused) {
    e = stage_stats(ws, x, sub, wbk, sb, n, h, w, cin, cout, rates, eps, st);
    if (e == cudaSuccess) e = stage_sum(ws, wbk, sb, out, n, h, w, cin, cout, rates, st);
  } else {
    e = stage_via_f(ws, x, sub, wbk, sb, out, n, h, w, cin, cout, rates, eps, st);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Workspace of K5 (k6_rmax = 0, cin = cout = C) or K6 (k6_rmax: its
// largest rate) at (n, h, w) output pixels.
size_t cistar_atrous_workspace_bytes(int n, int h, int w, int cin, int cout, int k6_rmax) {
  const int rates[NB] = {k6_rmax, 1, 1, 1};
  const bool fused = k6_rmax > 0 && stage_fused(n, h, w, cin, cout, rates);
  return atrous_layout(n, h, w, cin, cout, !fused, nullptr, nullptr);
}

// Which conv K5's and K6's branch convs, K5's reflect conv and
// cistar_conv3x3_zero_s8_acc run at (n, h, w, cin -> cout): 1000 * BN +
// the K stage's bytes of wg_conv_kernel (128128 or 128064), or 0 for
// conv_s8_kernel.
int cistar_atrous_conv_variant(int n, int h, int w, int cin, int cout) {
  return conv_variant(n, h, w, cin, cout);
}

// int32 accumulators of the zero-pad 3x3 conv at dilation dil: xq
// (N,H,W,Cin) int8, wk (Cout, 9*Cin) int8 -> acc (N,H,W,Cout) int32. The
// conv of K5's and K6's branches at every rate (conv_variant).
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
