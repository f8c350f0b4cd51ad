// Measurement only (tools/conv_schedule.py): the schedules of the wgmma
// conv (csrc/wgmma_conv.cuh) that K5 and K7a could take, and K6's two
// routes, on the same inputs. Not part of any path; built by the script
// into the kernel build directory.

#include "../csrc/int8_atrous.cu"

namespace {

// Sets the preferred shared-memory carveout of the one-tile-a-block
// instantiations of want_max's conv: the most (L1 28 KB) or the default.
cudaError_t set_carveout(bool want_max, int n, int h, int w, int c, bool most) {
  const int v = most ? static_cast<int>(cudaSharedmemCarveoutMaxShared)
                     : static_cast<int>(cudaSharedmemCarveoutDefault);
  const auto attr = cudaFuncAttributePreferredSharedMemoryCarveout;
  if (!want_max)
    return cudaFuncSetAttribute(
        wg_conv_kernel<int8_t, 128, EPI_STATS, false, 3, float, false>, attr, v);
  return wg_bn(n, h, w, c) == 256
             ? cudaFuncSetAttribute(
                   wg_conv_kernel<int8_t, 256, EPI_STATS, true, 3, float, false>, attr, v)
             : cudaFuncSetAttribute(
                   wg_conv_kernel<int8_t, 128, EPI_STATS, true, 3, float, false>, attr, v);
}

}  // namespace

extern "C" {

// K5's four branch convs of q (n, h, w, c) int8 at rates r0-r3: mode 0
// four launches, one block a tile; 1 one launch, one block a tile; 2 one
// launch, persistent (K5's schedule). f: 4 slabs (n, h, w, c); st: 8*n*c.
int sched_branches(const void* q, const void* wbk, const void* sb, const void* xs, void* f,
                   void* st, int n, int h, int w, int c, int r0, int r1, int r2, int r3,
                   int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rates[4] = {r0, r1, r2, r3};
  const size_t nc = static_cast<size_t>(n) * c;
  const long mc = static_cast<long>(n) * h * w * c;
  float* ss = static_cast<float*>(st);
  cudaMemsetAsync(ss, 0, 8 * nc * 4, s);
  const int8_t* x = static_cast<const int8_t*>(q);
  const int8_t* wk = static_cast<const int8_t*>(wbk);
  const float* b = static_cast<const float*>(sb);
  const float* xsc = static_cast<const float*>(xs);
  float* fo = static_cast<float*>(f);
  if (mode == 0) {
    for (int i = 0; i < 4; ++i) {
      const ConvArgs a{x, wk + static_cast<long>(i) * c * 9 * c, xsc, b + 2 * i * c,
                       b + (2 * i + 1) * c, nullptr, fo + i * mc, ss + i * nc,
                       ss + (4 + i) * nc, nullptr, n, h, w, c, c, rates[i]};
      const cudaError_t e =
          launch_wg_conv_bn<128, int8_t, EPI_STATS, false>(x, false, a.wk, a, s);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    return static_cast<int>(cudaGetLastError());
  }
  ConvArgs a{x, wk, xsc, b, b + c, nullptr, fo, ss, ss + 4 * nc, nullptr, n, h, w, c, c, 1};
  a.branches = 4;
  for (int i = 0; i < 4; ++i) a.bdil[i] = rates[i];
  a.sb_stride = 2 * c;
  const cudaError_t e =
      mode == 1 ? launch_wg_conv_bn<128, int8_t, EPI_STATS, false>(x, false, wk, a, s)
                : atrous_wg_conv<EPI_STATS>(x, false, wk, a, s);
  return static_cast<int>(e);
}

// One reflect 3x3 conv of the padded xp (n, h+2, w+2, c): K5's fifth conv
// (want_max 0, BN 128) or K7a's (want_max 1, BN of wg_bn). mode 0 one block
// a tile; 1 persistent; 2 one block a tile with the shared-memory carveout
// at its most. f (n, h, w, c); stats 3*n*c.
int sched_conv(const void* xp, const void* wk, const void* xs, const void* sb, void* f,
               void* stats, int n, int h, int w, int c, int want_max, int mode,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t nc = static_cast<size_t>(n) * c;
  float* ss = static_cast<float*>(stats);
  cudaMemsetAsync(ss, 0, 2 * nc * 4, s);
  cudaMemsetAsync(ss + 2 * nc, 0xFF, nc * 4, s);
  const int8_t* x = static_cast<const int8_t*>(xp);
  const int8_t* wp = static_cast<const int8_t*>(wk);
  const float* b = static_cast<const float*>(sb);
  const ConvArgs a{x, wp, static_cast<const float*>(xs), b, b + c, nullptr,
                   static_cast<float*>(f), ss, ss + nc, want_max ? ss + 2 * nc : nullptr,
                   n, h, w, c, c, 1};
  cudaError_t e = cudaSuccess;
  if (mode == 2 && (e = set_carveout(want_max, n, h, w, c, true)) != cudaSuccess)
    return static_cast<int>(e);
  if (mode == 1)
    e = want_max ? launch_wg_conv<int8_t, EPI_STATS, true, true>(x, true, wp, a, s)
                 : atrous_wg_conv<EPI_STATS>(x, true, wp, a, s);
  else
    e = want_max ? launch_wg_conv<int8_t, EPI_STATS, true>(x, true, wp, a, s)
                 : launch_wg_conv_bn<128, int8_t, EPI_STATS, false>(x, true, wp, a, s);
  if (mode == 2) {
    const cudaError_t r = set_carveout(want_max, n, h, w, c, false);
    if (e == cudaSuccess) e = r;
  }
  return static_cast<int>(e);
}

// K6 of x (n, hin, win, cin) bf16, read at x[:, ::2, ::2], into out (n, h,
// w, cout) bf16. mode 0: route 2, the four branch convs as one launch
// writing f_b, then branch_sum_kernel (csrc/int8_atrous.cu's path at shapes
// off the wgmma conv, here on it); 1: route 3, the two passes that keep f_b
// on chip (K6's path); 2: route 3's pass B alone on the statistics that a
// mode-0 call left in the same workspace with the quantized input, so that
// its output must equal mode 0's bit for bit.
// workspace: cistar_atrous_workspace_bytes(n, h, w, cin, cout, 0) bytes
// (with room for f_b).
int sched_k6(const void* x, int hin, int win, const void* wbk, const void* sb, void* out,
             void* workspace, int n, int h, int w, int cin, int cout, int r0, int r1, int r2,
             int r3, float eps, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rates[4] = {r0, r1, r2, r3};
  if (!stage_fused(n, h, w, cin, cout, rates)) return static_cast<int>(cudaErrorInvalidValue);
  AtrousWs ws;
  atrous_layout(n, h, w, cin, cout, true, static_cast<char*>(workspace), &ws);
  const Sub sub{2, w, win, cin, static_cast<long>(hin) * win * cin};
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wk = static_cast<const int8_t*>(wbk);
  const auto* b = static_cast<const float*>(sb);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaError_t e = cudaSuccess;
  if (mode == 0) {
    e = stage_via_f(ws, xb, sub, wk, b, o, n, h, w, cin, cout, rates, eps, s);
  } else {
    if (mode == 1) {
      e = stage_stats(ws, xb, sub, wk, b, n, h, w, cin, cout, rates, eps, s);
    } else {
      branch_weights(ws, wk, cout, s);
    }
    if (e == cudaSuccess) e = stage_sum(ws, wk, b, o, n, h, w, cin, cout, rates, s);
  }
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
