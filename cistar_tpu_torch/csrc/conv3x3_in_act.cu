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
//   conv_bf16_kernel   bf16 x and w: implicit GEMM, M = N*H*W pixels,
//                      N = Cout, K = 9*Cin, tensor cores through
//                      mma.sync.m16n8k16.f32.bf16.bf16.f32, double-buffered
//                      cp.async, 128 x 128 (or 64) x 32 tiles, 8 warps. The
//                      loader computes the reflect index (or zero-fills a
//                      tap outside the image): no padded copy. The epilogue
//                      adds the bias, writes fp32 acc and adds each (image,
//                      channel)'s sum and sum of squares into global
//                      statistics with atomics. It is K1's int8 conv
//                      (int8_common.cuh) with bf16 operands: the fragments
//                      of m16n8k16 bf16 sit at the same byte offsets as
//                      those of m16n8k32 s8.
//   conv_ffma_kernel   any other operands (fp32 x or w, or a shape the
//                      tiles do not divide): the same GEMM in fp32 FFMA on
//                      32 x 32 shared-memory tiles, no TF32. Only narrow
//                      shapes reach K3 with fp32 weights under the rule.
//   in_stats_kernel    the IN finalize (int8_common.cuh)
//   in_act_out_kernel  (acc - mean) * rsigma (+ residual) (ReLU) -> x dtype
//
// What bounds it: operations. At (64, 32, 32, 512) bf16 one launch does
// 309.2 GFLOP, 0.313 ms at 989 TFLOP/s, against at most 0.2 GB of traffic.
// This first version is far from that: mma.sync, not wgmma, and the fp32
// accumulator makes a round trip through device memory.
//
// Numerics: fp32 sums in another order than the plain version; the IN
// with IEEE division and 1/sqrt (--fmad=false: each op rounds once). The
// statistics are summed with atomics, in an order that changes from run
// to run.
//
// Interface: plain C, loaded with ctypes; returns cudaGetLastError(). The
// caller passes a workspace of cistar_conv3x3_in_act_workspace_bytes().

#include "int8_common.cuh"

namespace {

constexpr int BKE = 32;            // K elements (bf16) per stage: 64 bytes
constexpr int SROW = 2 * BKE + 16; // smem row stride in bytes
constexpr int CPR = 2 * BKE / 16;  // 16-byte chunks per smem row
constexpr int FT = 32;             // FFMA tile: pixels, couts and K

__device__ __forceinline__ void mma_bf16(float* c, unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

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
};

// Tensor-core conv. Requires Cin % 32 == 0 (a K-stage lies inside one tap),
// Cout % BN == 0 and (H*W) % BM == 0 (a block's rows lie in one image).
template <int BN, bool REFLECT>
__global__ void __launch_bounds__(CONV_THREADS) conv_bf16_kernel(const Args a) {
  constexpr int A_ITERS = BM * CPR / CONV_THREADS;
  constexpr int B_CHUNKS = BN * CPR;
  constexpr int B_ITERS = (B_CHUNKS + CONV_THREADS - 1) / CONV_THREADS;
  constexpr int WN = BN / 4;  // columns per warp
  constexpr int NI = WN / 8;  // n fragments per warp
  __shared__ __align__(16) char As[2][BM * SROW];
  __shared__ __align__(16) char Bs[2][BN * SROW];
  __shared__ float red[2][2][BN];

  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(a.wk);
  const int H = a.h, W = a.w, Cin = a.cin, Cout = a.cout;
  const int HW = H * W;
  const long K = 9L * Cin;
  const int CPT = Cin / BKE;  // K-stages per tap
  const int KT = 9 * CPT;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int img = m0 / HW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;

  int a_y[A_ITERS], a_x[A_ITERS], a_col[A_ITERS], a_row[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int id = tid + i * CONV_THREADS;
    a_row[i] = id / CPR;
    a_col[i] = (id % CPR) * 16;  // bytes
    const int rem = m0 + a_row[i] - img * HW;
    a_y[i] = rem / W;
    a_x[i] = rem - a_y[i] * W;
  }

  auto load_stage = [&](int kt, int buf) {
    const int tap = kt / CPT;
    const int cin0 = (kt - tap * CPT) * BKE;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      int yy = a_y[i] + dy, xx = a_x[i] + dx;
      bool in = true;
      if (REFLECT) {
        yy = reflect1(yy, H);
        xx = reflect1(xx, W);
      } else {
        in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      }
      const __nv_bfloat16* s =
          in ? xp + ((static_cast<long>(img) * H + yy) * W + xx) * Cin + cin0 + a_col[i] / 2
             : xp;
      cp_async16(&As[buf][a_row[i] * SROW + a_col[i]], s, in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int id = tid + i * CONV_THREADS;
      if (id < B_CHUNKS) {
        const int row = id / CPR, col = (id % CPR) * 16;
        cp_async16(&Bs[buf][row * SROW + col],
                   wp + static_cast<long>(n0 + row) * K + static_cast<long>(tap) * Cin +
                       cin0 + col / 2);
      }
    }
    cp_async_commit();
  };

  // Fragment (mi, ni, r): row = wm*64 + mi*16 + g + 8*(r >> 1),
  // col = wn*WN + ni*8 + 2*t + (r & 1).
  float acc[4][NI][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  load_stage(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) {
      load_stage(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const char* as = As[buf];
    const char* bs = Bs[buf];
#pragma unroll
    for (int kk = 0; kk < 2 * BKE; kk += 32) {  // bytes: 16 bf16 per mma
      unsigned af[4][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const unsigned*>(as + r * SROW + kk + t * 4);
        af[mi][1] = *reinterpret_cast<const unsigned*>(as + (r + 8) * SROW + kk + t * 4);
        af[mi][2] = *reinterpret_cast<const unsigned*>(as + r * SROW + kk + 16 + t * 4);
        af[mi][3] = *reinterpret_cast<const unsigned*>(as + (r + 8) * SROW + kk + 16 + t * 4);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int c = wn * WN + ni * 8 + g;
        bf[ni][0] = *reinterpret_cast<const unsigned*>(bs + c * SROW + kk + t * 4);
        bf[ni][1] = *reinterpret_cast<const unsigned*>(bs + c * SROW + kk + 16 + t * 4);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_bf16(acc[mi][ni], af[mi][0], af[mi][1], af[mi][2], af[mi][3], bf[ni][0],
                   bf[ni][1]);
    }
    __syncthreads();
  }

  // Epilogue: + bias, f out, statistics.
  float s[NI][2], sq[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float b = a.bias[n0 + wn * WN + ni * 8 + 2 * t + j];
      s[ni][j] = 0.f;
      sq[ni][j] = 0.f;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = __fadd_rn(acc[mi][ni][2 * h + j], b);
          acc[mi][ni][2 * h + j] = v;
          s[ni][j] = __fadd_rn(s[ni][j], v);
          sq[ni][j] = __fadd_rn(sq[ni][j], __fmul_rn(v, v));
        }
    }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long row = m0 + wm * 64 + mi * 16 + g + 8 * h;
        const int col = n0 + wn * WN + ni * 8 + 2 * t;
        store2(a.f + row * Cout + col, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
  // Reduce over the 8 row groups of the warp (lane bits 2..4), then over
  // the two warps that share a column, then into global.
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s[ni][j] = __fadd_rn(s[ni][j], __shfl_xor_sync(0xffffffffu, s[ni][j], o));
        sq[ni][j] = __fadd_rn(sq[ni][j], __shfl_xor_sync(0xffffffffu, sq[ni][j], o));
      }
  if (g == 0) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * WN + ni * 8 + 2 * t + j;
        red[wm][0][c] = s[ni][j];
        red[wm][1][c] = sq[ni][j];
      }
  }
  __syncthreads();
  if (tid < BN) {
    const long o = static_cast<long>(img) * Cout + n0 + tid;
    atomicAdd(a.st_sum + o, __fadd_rn(red[0][0][tid], red[1][0][tid]));
    atomicAdd(a.st_sq + o, __fadd_rn(red[0][1][tid], red[1][1][tid]));
  }
}

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
  float* f;       // M * Cout
  float* st_sum;  // N * Cout, then st_sq right after it
  float* st_sq;
  float* mean;    // N * Cout
  float* rsig;    // N * Cout
};

size_t workspace_layout(long n, long hw, long cout, char* base, Workspace* w) {
  const size_t mc = static_cast<size_t>(n * hw * cout), nc = static_cast<size_t>(n * cout);
  Carver cv{base};
  Workspace ws;
  ws.f = cv.take<float>(mc * 4);
  ws.st_sum = cv.take<float>(2 * nc * 4);  // one memset clears both
  ws.st_sq = ws.st_sum ? ws.st_sum + nc : nullptr;
  ws.mean = cv.take<float>(nc * 4);
  ws.rsig = cv.take<float>(nc * 4);
  if (w != nullptr) *w = ws;
  return cv.off;
}

template <bool REFLECT>
void launch_gemm(const Args& a, bool x_bf16, bool w_bf16, cudaStream_t st) {
  const long m = static_cast<long>(a.n) * a.h * a.w;
  if (x_bf16 && w_bf16 && a.cin % BKE == 0 && a.cout % 64 == 0 && (a.h * a.w) % BM == 0) {
    const unsigned gm = static_cast<unsigned>(m / BM);
    if (a.cout % 128 == 0)
      conv_bf16_kernel<128, REFLECT><<<dim3(gm, a.cout / 128), CONV_THREADS, 0, st>>>(a);
    else
      conv_bf16_kernel<64, REFLECT><<<dim3(gm, a.cout / 64), CONV_THREADS, 0, st>>>(a);
    return;
  }
  const dim3 grid(static_cast<unsigned>((m + FT - 1) / FT), (a.cout + FT - 1) / FT);
  if (x_bf16 && w_bf16)
    conv_ffma_kernel<__nv_bfloat16, __nv_bfloat16, REFLECT><<<grid, 256, 0, st>>>(a);
  else if (x_bf16)
    conv_ffma_kernel<__nv_bfloat16, float, REFLECT><<<grid, 256, 0, st>>>(a);
  else if (w_bf16)
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

size_t cistar_conv3x3_in_act_workspace_bytes(int n, int h, int w, int cout) {
  return workspace_layout(n, static_cast<long>(h) * w, cout, nullptr, nullptr);
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
  Workspace ws;
  workspace_layout(n, static_cast<long>(h) * w, cout, static_cast<char*>(workspace), &ws);
  cudaMemsetAsync(ws.st_sum, 0, 2 * static_cast<size_t>(n) * cout * 4, st);
  const Args a{x, wk, static_cast<const float*>(bias), ws.f, ws.st_sum, ws.st_sq,
               n, h, w, cin, cout};
  if (reflect)
    launch_gemm<true>(a, x_bf16, w_bf16, st);
  else
    launch_gemm<false>(a, x_bf16, w_bf16, st);
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

}  // extern "C"
