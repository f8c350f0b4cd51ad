// The cout=1 7x7 reflect head conv for Hopper (sm_90a): K9 of the port.
//
// One kernel for the four TPU kernels that compute the same function,
//   K9a cistar_tpu/ops/pallas_kernels.py::_conv7_cout1_kernel
//       (conv2d_reflect_cout1, :292)
//   K9b pallas_kernels.py::_conv7_cout1_masked_kernel
//       (conv2d_reflect_cout1_masked, :402)
//   K9c pallas_kernels.py::_conv7_cout1_loop_kernel
//       (conv2d_reflect_cout1_loop, :494)
//   K9d cistar_tpu/ops/head_conv.py::_head_kernel
//       (head_conv_tanh_pallas, :341), with its optional pre_in
// (N,H,W,Cin) -> (N,H,W,1): out = act(sum_{dy,dx,c} xp[y+dy, x+dx, c] *
// w[dy, dx, c] + b), xp the reflect-pad-3 input, the taps rounded to the
// input dtype (the caller passes them so), products and sums in fp32, bias
// and tanh in fp32, one cast to the input dtype. With pre_in the input is
// first relu((x - mean) * rsqrt(var + eps)) with the single-pass statistics
// (E[x^2] - E[x]^2 clamped at 0), normalized and ReLU'd in fp32 and rounded
// to the input dtype, as _head_kernel does.
//
// Design of the bf16 kernel (head_tc_kernel): K9a's tap matmul on the
// tensor cores, with the tap rows folded into its depth. A block owns a
// 16 x 26 output tile and stages its 22 x 32 input halo (reflect index in
// the loader, no padded copy). Plane dx of halo row y is
//   P_dx[y, x] = sum_{dy, c} halo[y + dy, x, c] * w[dy, dx, c]
// for y < 16, x < 32: a (512, 7 Cin) x (7 Cin, 8) product (dx 7 a zero
// column) whose k step (dy, 16 channels) reads the halo rows 32 dy further
// on, so mma.sync.m16n8k16 (bf16 in, fp32 sums) adds the seven tap rows
// itself, and the 49 tap planes never leave the accumulators. With 32
// halo columns, dy moves an m-tile of 16 rows by exactly two m-tiles: a
// warp owns four m-tiles two apart, and each A fragment it loads serves up
// to four of them at four dy (10 loads for 28 products a k step, where
// one load a product would make the kernel wait on shared memory). The 7
// planes go to shared memory, and each output sums its 7 shifted planes,
// out[y, x] = sum_dx P_dx[y, x + dx] in dx order from 0.0 (K9a's shifted
// adds, one per tap column), adds the bias, applies tanhf, and casts once.
// The halo is staged with 16-byte cp.async, 64 channels (128 bytes a pixel,
// 16-byte pieces XOR-swizzled by pixel & 7 so that ldmatrix reads no bank
// twice); Cin > 64 loops over 64-channel chunks into the same
// accumulators; channels past Cin are zeros. Two persistent blocks an SM
// walk the tiles gridDim.x apart; a block stages its next (tile, chunk)
// as soon as its products have read the halo, and the other block's
// products overlap its loads. With pre_in each thread normalizes the
// pieces it staged, in place, before the block's barrier; the statistics
// come from a first pass (sums_kernel: per-(image, channel) sum and sum of
// squares by atomics; stats_kernel: mean and 1 / sigma).
//
// fp32 inputs keep the first version's kernel (head_kernel: one output
// pixel a thread, fp32 FMA): tensor cores would take fp32 as TF32 and
// change the numbers. The choice is made by dtype.
//
// What bounds it: bytes. At (64, 256, 256, 64) bf16 the input is 537 MB
// and the output 8.4 MB, 0.163 ms at 3.35 TB/s; the 26.3 GFLOP of the taps
// (41 GFLOP of mma with the 6 extra halo columns and the zero column) are
// 0.03-0.04 ms at the bf16 tensor-core rate. L2 delivers each halo 1.7
// times over (22 x 32 pixels for 16 x 26 outputs). With pre_in the
// statistics read x once more.
//
// Numerics: fp32 sums in another order than the plain version (an ulp of
// the bf16 output at Cin 64; the tensor cores' fp32 sums of thousands of
// terms can reach two at Cin 2048); IEEE division and 1/sqrt for the
// statistics; tanhf.
//
// Interface: plain C, loaded with ctypes; returns cudaGetLastError(). The
// caller passes a workspace of cistar_head_cout1_workspace_bytes() bytes.

#include <algorithm>

#include "int8_common.cuh"

namespace {

constexpr int TILE = 16;                   // output tile edge
constexpr int HALO = 3;                     // reflect pad of the 7x7 conv
constexpr int SPAN = TILE + 2 * HALO;       // staged input tile edge
constexpr int CC = EW_VEC;                  // fp32 kernel: channels staged per step
constexpr int HEAD_THREADS = TILE * TILE;   // one output pixel a thread

// The tensor-core kernel's tile (see the note above)
constexpr int TAPS = 49;
constexpr int TC_TH = 16, TC_TW = 26;       // output tile: 16 rows of 26
constexpr int TC_SH = TC_TH + 2 * HALO;     // 22 halo rows
constexpr int TC_SW = TC_TW + 2 * HALO;     // 32 halo columns
constexpr int TC_KCH = 64;                  // channels a staged chunk
constexpr int TC_PIX = TC_SH * TC_SW;       // 704 halo pixels
constexpr int TC_ROWS = TC_TH * TC_SW;      // 512 plane rows (y < 16, x < 32)
constexpr int TC_MT = TC_ROWS / 16;         // 32 m-tiles; dy moves 2 of them
constexpr int TC_WARPS = HEAD_THREADS / 32;
constexpr int TC_MPW = TC_MT / TC_WARPS;    // 4 m-tiles a warp, 2 apart
constexpr int TC_ROW = TC_KCH * 2;          // 128 bytes a staged pixel
constexpr int TC_HALO_BYTES = TC_PIX * TC_ROW;
constexpr int TC_PS = TC_ROWS + 4;          // plane stride: 516 = 4 mod 32 banks
constexpr int TC_SMEM = TC_HALO_BYTES + 7 * TC_PS * 4;
constexpr int TC_BLOCKS_PER_SM = 2;

// ReflectionPad2d(3) index for n > 3. Rows and columns further out than 3
// feed only outputs outside the image (the ragged edge tiles): clamped.
__device__ __forceinline__ int reflect3(int v, int n) {
  v = v < 0 ? -v : (v >= n ? 2 * n - 2 - v : v);
  return min(max(v, 0), n - 1);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The single-pass statistics, in place: st[i] = sum, st[count + i] = sum of
// squares of (image, channel) i become its mean and 1 / sqrt(var + eps).
__global__ void __launch_bounds__(HEAD_THREADS)
    stats_kernel(float* __restrict__ st, int count, float fhw, float eps) {
  const int i = blockIdx.x * HEAD_THREADS + threadIdx.x;
  if (i >= count) return;
  const float m = __fdiv_rn(st[i], fhw);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(st[count + i], fhw), __fmul_rn(m, m)), 0.f);
  st[i] = m;
  st[count + i] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// Per-(image, channel) sum and sum of squares of x, added into st_sum /
// st_sq (N, Cin). grid (chunks, N); thread tid reads channels 8 * (tid %
// tv) .. + 7 of pixels tid / tv + k * rows * chunks; tv = Cin / 8 <= 256.
template <typename T>
__global__ void __launch_bounds__(HEAD_THREADS)
    sums_kernel(const T* __restrict__ x, long hw, int cin, float* __restrict__ st_sum,
                float* __restrict__ st_sq) {
  __shared__ float red[2][HEAD_THREADS * EW_VEC];
  const int n = blockIdx.y, tid = threadIdx.x;
  const int tv = cin / EW_VEC, rows = HEAD_THREADS / tv;
  const int v = tid % tv, r0 = tid / tv;
  float s[EW_VEC], q[EW_VEC];
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) s[i] = q[i] = 0.f;
  if (r0 < rows) {
    const T* xi = x + static_cast<long>(n) * hw * cin + v * EW_VEC;
    for (long p = static_cast<long>(blockIdx.x) * rows + r0; p < hw;
         p += static_cast<long>(gridDim.x) * rows) {
      float xv[EW_VEC];
      load8<T>(xi + p * cin, xv);
#pragma unroll
      for (int i = 0; i < EW_VEC; ++i) {
        s[i] = __fadd_rn(s[i], xv[i]);
        q[i] = __fadd_rn(q[i], __fmul_rn(xv[i], xv[i]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < EW_VEC; ++i) {
    red[0][tid * EW_VEC + i] = s[i];
    red[1][tid * EW_VEC + i] = q[i];
  }
  __syncthreads();
  for (int ch = tid; ch < cin; ch += HEAD_THREADS) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < rows; ++r) {
      const int k = (r * tv + ch / EW_VEC) * EW_VEC + ch % EW_VEC;
      a = __fadd_rn(a, red[0][k]);
      b = __fadd_rn(b, red[1][k]);
    }
    atomicAdd(st_sum + static_cast<long>(n) * cin + ch, a);
    atomicAdd(st_sq + static_cast<long>(n) * cin + ch, b);
  }
}

// fp32 inputs. grid (ceil(W / 16), ceil(H / 16), N), HEAD_THREADS threads:
// thread (ty, tx) computes output pixel (y0 + ty, x0 + tx), staging 8
// channels at a time. wt: (49, Cin) fp32, tap = 7 * dy + dx.
template <bool PRE_IN, bool TANH>
__global__ void __launch_bounds__(HEAD_THREADS)
    head_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                const float* __restrict__ bias, const float* __restrict__ st_mu,
                const float* __restrict__ st_rs, float* __restrict__ out, int h, int w,
                int cin) {
  __shared__ __align__(16) float xs[SPAN * SPAN * CC];
  __shared__ float ws[TAPS * CC];
  __shared__ float mu[CC], rs[CC];
  const int n = blockIdx.z, y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const int ty = threadIdx.x / TILE, tx = threadIdx.x % TILE;
  const float* xi = x + static_cast<long>(n) * h * w * cin;
  float acc = 0.f;
  for (int c0 = 0; c0 < cin; c0 += CC) {
    if (PRE_IN && threadIdx.x < CC) {
      mu[threadIdx.x] = st_mu[static_cast<long>(n) * cin + c0 + threadIdx.x];
      rs[threadIdx.x] = st_rs[static_cast<long>(n) * cin + c0 + threadIdx.x];
    }
    for (int i = threadIdx.x; i < TAPS * CC; i += HEAD_THREADS)
      ws[i] = wt[(i / CC) * cin + c0 + i % CC];
    __syncthreads();
    for (int p = threadIdx.x; p < SPAN * SPAN; p += HEAD_THREADS) {
      const int yy = reflect3(y0 + p / SPAN - HALO, h);
      const int xx = reflect3(x0 + p % SPAN - HALO, w);
      float v[EW_VEC];
      load8<float>(xi + (static_cast<long>(yy) * w + xx) * cin + c0, v);
      if (PRE_IN) {
#pragma unroll
        for (int i = 0; i < EW_VEC; ++i)
          v[i] = fmaxf(__fmul_rn(__fsub_rn(v[i], mu[i]), rs[i]), 0.f);
      }
      store8<float>(xs + p * CC, v);
    }
    __syncthreads();
#pragma unroll
    for (int dy = 0; dy < 7; ++dy)
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) {
        float v[EW_VEC];
        load8<float>(xs + ((ty + dy) * SPAN + tx + dx) * CC, v);
        const float* wp = ws + (dy * 7 + dx) * CC;
#pragma unroll
        for (int i = 0; i < EW_VEC; ++i) acc = fmaf(v[i], wp[i], acc);
      }
    __syncthreads();
  }
  const int oy = y0 + ty, ox = x0 + tx;
  if (oy < h && ox < w) {
    float y = bias != nullptr ? __fadd_rn(acc, bias[0]) : acc;
    if (TANH) y = tanhf(y);
    store1(out + (static_cast<long>(n) * h + oy) * w + ox, y);
  }
}

// Where tile t and chunk c of the tensor-core kernel lie.
struct TcGeom {
  int h, w, cin, tiles_x, tiles_img, chunks;
  long tiles;
};

// Stage the halo of tile t, channels c * 64 .. + 63, into buf: thread tid
// copies the 16-byte piece j = tid % 8 of pixels tid / 8 + 32 k (halo row
// p / 32, column p % 32), the pieces past the chunk's last k step skipped
// and those past Cin zero-filled.
__device__ __forceinline__ void tc_stage(const __nv_bfloat16* __restrict__ x,
                                         const TcGeom& g, long t, int c,
                                         unsigned char* buf) {
  const int n = static_cast<int>(t / g.tiles_img), r = static_cast<int>(t % g.tiles_img);
  const int y0 = r / g.tiles_x * TC_TH - HALO, x0 = r % g.tiles_x * TC_TW - HALO;
  const int j = threadIdx.x & 7, ch = c * TC_KCH + j * 8;
  const int kc = min(4, (g.cin - c * TC_KCH + 15) / 16);
  if (j >= 2 * kc) return;
  const bool real = ch < g.cin;
  const __nv_bfloat16* xi = x + static_cast<long>(n) * g.h * g.w * g.cin + ch;
  const int xx = reflect3(x0 + ((threadIdx.x >> 3) & (TC_SW - 1)), g.w);
  for (int p = threadIdx.x >> 3; p < TC_PIX; p += HEAD_THREADS / 8) {
    const int yy = reflect3(y0 + p / TC_SW, g.h);
    const __nv_bfloat16* src = real ? xi + (static_cast<long>(yy) * g.w + xx) * g.cin : x;
    cp_async16(buf + p * TC_ROW + ((j ^ (p & 7)) << 4), src, real ? 16 : 0);
  }
}

// bf16 inputs: TC_BLOCKS_PER_SM persistent blocks an SM, HEAD_THREADS
// threads each, walk the (image, 16 x 26 tile) pairs gridDim.x apart, each
// tile in ceil(Cin / 64) chunks. wt: (49, Cin) fp32 (bf16 values), tap = 7
// dy + dx. Row r = 32 y + x (y < 16, x < 32) of the product is plane row
// (y, x); its k step (dy, ks) reads halo pixel r + 32 dy, channels 16 ks ..
// + 15, so m-tile mt at dy reads halo m-tile mt + 2 dy; column dx of B is
// tap (dy, dx), 0 at dx = 7. Warp w owns the m-tiles w % 2 + 8 (w / 2) +
// 2 j (j < 4): each halo m-tile it loads serves up to 4 of them at
// different dy.
template <bool PRE_IN, bool TANH>
__global__ void __launch_bounds__(HEAD_THREADS, TC_BLOCKS_PER_SM)
    head_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ wt,
                   const float* __restrict__ bias, const float* __restrict__ st_mu,
                   const float* __restrict__ st_rs, __nv_bfloat16* __restrict__ out,
                   TcGeom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* buf = smem;                                          // the halo
  float* planes = reinterpret_cast<float*>(smem + TC_HALO_BYTES);    // (7, TC_PS)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int mt0 = (warp & 1) + 8 * (warp >> 1);  // this warp's first m-tile
  // this lane's ldmatrix row of halo m-tile mt0 + 2 i: abase + i * 32 rows;
  // its swizzle (row & 7) is lane & 7 for every i
  const unsigned char* abase =
      buf + (mt0 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_ROW;
  const int akc = lane >> 4, asw = lane & 7;

  unsigned bq[7][4][2];  // this chunk's B fragments, by dy and k step
  float acc[TC_MPW][4];  // plane rows of m-tiles mt0 + 2 j
  long t = blockIdx.x;
  int c = 0;
  if (t < g.tiles) tc_stage(x, g, t, c, buf);
  cp_async_commit();
  for (int s = 0; t < g.tiles; ++s) {
    const int n = static_cast<int>(t / g.tiles_img);
    const int kc = min(4, (g.cin - c * TC_KCH + 15) / 16);
    if (g.chunks > 1 || s == 0) {
      // B[k][dx] = tap (dy, dx) of channel c * 64 + 16 ks + k; 0 at dx 7, past Cin
#pragma unroll
      for (int dy = 0; dy < 7; ++dy)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ch = c * TC_KCH + ks * 16 + 2 * t4 + (i & 1) + (i >> 1) * 8;
            v[i] = gq < 7 && ch < g.cin ? wt[(7 * dy + gq) * g.cin + ch] : 0.f;
          }
          bq[dy][ks][0] = pack_bf16(v[0], v[1]);
          bq[dy][ks][1] = pack_bf16(v[2], v[3]);
        }
    }
    cp_async_wait<0>();
    if (PRE_IN) {
      // normalize the pieces this thread staged, in place; zero pieces stay
      const int j = tid & 7, ch = c * TC_KCH + j * 8;
      if (j < 2 * kc && ch < g.cin) {
        float mu[EW_VEC], rs[EW_VEC];
        load8<float>(st_mu + static_cast<long>(n) * g.cin + ch, mu);
        load8<float>(st_rs + static_cast<long>(n) * g.cin + ch, rs);
        for (int p = tid >> 3; p < TC_PIX; p += HEAD_THREADS / 8) {
          __nv_bfloat16* q =
              reinterpret_cast<__nv_bfloat16*>(buf + p * TC_ROW + ((j ^ (p & 7)) << 4));
          float v[EW_VEC];
          load8<__nv_bfloat16>(q, v);
#pragma unroll
          for (int i = 0; i < EW_VEC; ++i)
            v[i] = fmaxf(__fmul_rn(__fsub_rn(v[i], mu[i]), rs[i]), 0.f);
          store8<__nv_bfloat16>(q, v);  // rounds to bf16, as the TPU kernel's cast
        }
      }
    }
    __syncthreads();  // the halo is in; the last tile's output pass is done
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < TC_MPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    // halo m-tile mt0 + 2 i feeds m-tile mt0 + 2 j at dy = i - j
#pragma unroll
    for (int i = 0; i < TC_MPW + 6; ++i) {
      unsigned a[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (ks < kc)
          ldmatrix_x4(a[ks], abase + i * 32 * TC_ROW + (((2 * ks + akc) ^ asw) << 4));
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int j = 0; j < TC_MPW; ++j)
          if (ks < kc && i - j >= 0 && i - j < 7)
            mma_bf16(acc[j], a[ks], bq[i - j][ks][0], bq[i - j][ks][1]);
    }
    __syncthreads();  // no warp reads the halo any more
    long tn = t;
    int cn = c + 1;
    if (cn == g.chunks) {
      cn = 0;
      tn += gridDim.x;
    }
    if (tn < g.tiles) tc_stage(x, g, tn, cn, buf);
    cp_async_commit();
    if (c == g.chunks - 1) {
      // plane dx of row r at planes[dx * TC_PS + r]
#pragma unroll
      for (int j = 0; j < TC_MPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = (mt0 + 2 * j) * 16 + gq + (e >> 1) * 8, dx = 2 * t4 + (e & 1);
          if (dx < 7) planes[dx * TC_PS + r] = acc[j][e];
        }
      __syncthreads();
      // each output of the tile: its 7 dx planes in order from 0.0, + b
      const int r = static_cast<int>(t % g.tiles_img);
      const int y0 = r / g.tiles_x * TC_TH, x0 = r % g.tiles_x * TC_TW;
      for (int o = tid; o < TC_TH * TC_TW; o += HEAD_THREADS) {
        const int ty = o / TC_TW, tx = o % TC_TW;
        float y = 0.f;
#pragma unroll
        for (int dx = 0; dx < 7; ++dx)
          y = __fadd_rn(y, planes[dx * TC_PS + ty * TC_SW + tx + dx]);
        y = __fadd_rn(y, bias != nullptr ? bias[0] : 0.f);
        if (TANH) y = tanhf(y);
        if (y0 + ty < g.h && x0 + tx < g.w)
          store1(out + (static_cast<long>(n) * g.h + y0 + ty) * g.w + x0 + tx, y);
      }
    }
    t = tn;
    c = cn;
  }
  cp_async_wait<0>();
}

template <bool PRE_IN, bool TANH>
cudaError_t launch_tc(const void* x, const float* wt, const float* bias, const float* st,
                      void* out, int n, int h, int w, int cin, cudaStream_t s) {
  auto kern = head_tc_kernel<PRE_IN, TANH>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  TcGeom g;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.tiles_x = (w + TC_TW - 1) / TC_TW;
  g.tiles_img = g.tiles_x * ((h + TC_TH - 1) / TC_TH);
  g.chunks = (cin + TC_KCH - 1) / TC_KCH;
  g.tiles = static_cast<long>(n) * g.tiles_img;
  const long blocks = std::min<long>(g.tiles, static_cast<long>(TC_BLOCKS_PER_SM) * sms);
  kern<<<static_cast<unsigned>(blocks), HEAD_THREADS, TC_SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(x), wt, bias, st, st + static_cast<long>(n) * cin,
      static_cast<__nv_bfloat16*>(out), g);
  return cudaGetLastError();
}

template <bool PRE_IN, bool TANH>
void launch_fp32(const void* x, const float* wt, const float* bias, const float* st,
                 void* out, int n, int h, int w, int cin, cudaStream_t s) {
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, n);
  head_kernel<PRE_IN, TANH><<<grid, HEAD_THREADS, 0, s>>>(
      static_cast<const float*>(x), wt, bias, st, st + static_cast<long>(n) * cin,
      static_cast<float*>(out), h, w, cin);
}

template <bool PRE_IN, bool TANH>
int launch(int is_bf16, const void* x, const float* wt, const float* bias, const float* st,
           void* out, int n, int h, int w, int cin, cudaStream_t s) {
  if (is_bf16)
    return static_cast<int>(launch_tc<PRE_IN, TANH>(x, wt, bias, st, out, n, h, w, cin, s));
  launch_fp32<PRE_IN, TANH>(x, wt, bias, st, out, n, h, w, cin, s);
  return static_cast<int>(cudaGetLastError());
}

// pre_in's statistics into st: (N, Cin) means, then (N, Cin) 1 / sigma.
template <typename T>
void stats(const void* x, float* st, int n, int h, int w, int cin, float eps,
           cudaStream_t s) {
  const long hw = static_cast<long>(h) * w;
  const int rows = HEAD_THREADS / (cin / EW_VEC);
  const int chunks = static_cast<int>(std::min<long>((hw + rows - 1) / rows, 64));
  const int count = n * cin;
  cudaMemsetAsync(st, 0, 2 * static_cast<size_t>(count) * 4, s);
  sums_kernel<T><<<dim3(chunks, n), HEAD_THREADS, 0, s>>>(
      static_cast<const T*>(x), hw, cin, st, st + count);
  stats_kernel<<<(count + HEAD_THREADS - 1) / HEAD_THREADS, HEAD_THREADS, 0, s>>>(
      st, count, static_cast<float>(hw), eps);
}

}  // namespace

extern "C" {

// The statistics of pre_in: 2 * N * Cin fp32.
size_t cistar_head_cout1_workspace_bytes(int n, int cin) {
  return align256(2 * static_cast<size_t>(n) * cin * 4);
}

// Dynamic shared memory of the tensor-core kernel, bytes.
int cistar_head_cout1_smem_bytes() { return TC_SMEM; }

// x (N,H,W,Cin) bf16 (is_bf16 = 1) or fp32, Cin % 8 == 0, Cin <= 2048,
// H, W > 3; wt (49, Cin) fp32; bias (1,) fp32 or null; out (N,H,W) in x's
// dtype.
int cistar_head_cout1(const void* x, int is_bf16, const void* wt, const void* bias,
                      void* out, void* workspace, int n, int h, int w, int cin,
                      int tanh, int pre_in, float eps, void* stream) {
  if (n <= 0 || n > 65535 || h <= HALO || w <= HALO || cin <= 0 || cin % EW_VEC ||
      cin > HEAD_THREADS * EW_VEC)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(wt);
  const float* bf = static_cast<const float*>(bias);
  float* st = static_cast<float*>(workspace);
  if (pre_in) {
    if (is_bf16)
      stats<__nv_bfloat16>(x, st, n, h, w, cin, eps, s);
    else
      stats<float>(x, st, n, h, w, cin, eps, s);
    return tanh ? launch<true, true>(is_bf16, x, wf, bf, st, out, n, h, w, cin, s)
                : launch<true, false>(is_bf16, x, wf, bf, st, out, n, h, w, cin, s);
  }
  return tanh ? launch<false, true>(is_bf16, x, wf, bf, st, out, n, h, w, cin, s)
              : launch<false, false>(is_bf16, x, wf, bf, st, out, n, h, w, cin, s);
}

}  // extern "C"
