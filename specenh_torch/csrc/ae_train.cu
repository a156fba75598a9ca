// K5 + K5b + K7: conv-autoencoder training (forward + backward) at depth 2
// and 3, for Hopper (sm_90a).
//
// Replaces specenh/ops/ae_train_kernel.py:_make_train_kernel, called as
//   K5  _pallas_train      (per-batch conversion of f32 tiles), and
//   K5b _pallas_train_pre  (tiles converted to the kernel dtype once per
//                           epoch; pre_layout=True),
// and specenh/ops/ae3_train_kernel.py:_make_train_kernel3, called as
//   K7  _pallas_train3     (the depth-3 family, f32 tiles).
// The stages are the same at both depths; the Python side chains them over
// the layer table (ops/ae_train_kernel.py _forward / _backward).
// The TPU kernel ran a tile's whole forward and backward in VMEM.  Here, as
// in the serving kernels (ae.cu), each stage is a kernel of its own on NCHW
// activations in device memory, and what the backward needs is stored by
// the forward stages in the kernel dtype (bf16 or float32):
//
//   forward   ae_train_in[_pre]   conv 0 + relu + pool: p1, routing bits
//             ae_train_conv_pool  the other encoder convs + relu + pool,
//                                 with their routing bits
//             (ae.cu ae_convt_relu, once per transposed conv, up to e)
//             ae_train_loss[_pre] out-conv -> float32 logits; masked
//                                 sigmoid-BCE sum; dz5 = (sigmoid(z) - y) *
//                                 tile mask, UNNORMALISED; db5 partials
//   backward  ae_train_dgrad_conv   stride-1 input gradient (out-conv,
//                                   encoder convs 1..), gated, + bias-
//                                   gradient partials
//             ae_train_dgrad_convt  stride-2 transposed-conv input gradient
//             ae_train_wgrad[_x]    weight-gradient partials, one per tile
//             ae_train_sum          partials -> sums, in a fixed order
//
// Semantics carried over from the TPU kernel: x and the labels y are
// rounded to the kernel dtype as they are loaded (the _pre entry points
// read tiles already in it: the same values); sums, biases, logits and
// bias gradients are float32; every dz is rounded to the kernel dtype once
// and that value feeds both of its products (dW and the input gradient);
// the pool backward routes to every maximal phase of a window whose max is
// > 0 (bits from the float32 values, 4 per pooled value); relu' (0) = 0.
// The relu gates read the stored activation, act > 0: the same as the f32
// sum > 0 except for a positive sum below bf16's smallest subnormal
// (2^-133), which bf16 rounds to 0 (then the stored activation, and so the
// forward, is 0 there too).  Cross-block sums are per-block partials
// summed in a fixed order: no float atomics, so a step is repeatable bit
// for bit, and K5 and K5b give identical results.
//
// What bounds it on this card: per 256x128 tile of the flagship (k3, 32/32)
// the forward is ~189 M MAC, and the backward twice that (input gradients
// and weight gradients): ~1.13 GFLOP per tile, ~145 GFLOP per 128-tile
// step, 0.15 ms at the card's 989 TFLOP/s peak for bf16 operands.  The
// stages write ~7 MB per tile in bf16 and read it back: ~3 GB per step,
// 0.9 ms at 3.35 TB/s.  So the step is bound by bytes.  That these stages
// run their FMAs on the CUDA cores (67 TFLOP/s fp32, 2.2 ms for the step)
// is a choice of this first design, not the bound.  The deep3 preset
// (16/32/64, k5) does ~0.5 G MAC per tile forward and twice that backward:
// ~379 GFLOP per 128-tile step, 0.38 ms at the bf16 peak, about as long as
// its ~1 GB of stored activations and gradients take at 3.35 TB/s.
//
// Design: the forward and input-gradient stages reuse conv_quad_kernel
// (ae_conv.cuh) with new epilogues, or mirror convt_relu_kernel's
// thread-per-position register tiling.  The weight gradient is a GEMM over
// the positions of a tile, one block per (tile, tap): a 64-position chunk
// of the layer input and of the tap-shifted dz is staged in shared memory,
// and each thread accumulates a register tile of up to 4 x 4 (ci, co).
// No tensor cores yet.

#include "ae_conv.cuh"

namespace {

constexpr int WT = 256;  // threads of a weight-gradient block
constexpr int WP = 64;   // positions per shared-memory chunk
constexpr int WC = 64;   // most channels a weight-gradient block stages
constexpr int WS = WC * WP / WT;  // most staged values per thread and operand

// conv1 / conv2: bias + relu + 2x2 max pool, plus the routing bits of the
// window: bit q (q = a * 2 + b for pixel (2m+a, 2n+b)) where that pixel's
// float32 relu value equals the max and the max is > 0.
template <typename T>
struct PoolMaskEpi {
  T* out;
  uint8_t* bits;
  int Cout, h2, w2;  // the pooled grid
  __device__ __forceinline__ void operator()(float (&acc)[4][COB],
                                             const float* bias, bool active,
                                             int b, int m, int n,
                                             int co0) const {
    if (!active) return;
#pragma unroll
    for (int co = 0; co < COB; ++co) {
      const float bv = bias[co0 + co];
      float r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] = fmaxf(acc[q][co] + bv, 0.f);
      const float p = fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3]));
      unsigned k = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) k |= (p > 0.f && r[q] == p) ? (1u << q) : 0u;
      const long long o = (((long long)b * Cout + co0 + co) * h2 + m) * w2 + n;
      out[o] = sx_cast<T>(p);
      bits[o] = (uint8_t)k;
    }
  }
};

// The out-conv's logits z (float32), the labels y rounded to T, the tile
// mask: dz5 = (sigmoid(z) - y) * mask stored in T, and per block the sums
// of the masked BCE (from z) and of the float32 dz5.
template <typename TY, typename T>
struct LossEpi {
  const TY* y;
  const float* tmask;
  float* logits;
  T* dz;
  float* part;
  int H, W;
  __device__ __forceinline__ void operator()(float (&acc)[4][1],
                                             const float* bias, bool active,
                                             int b, int m, int n, int) const {
    float s[2] = {0.f, 0.f};
    if (active) {
      const float mk = tmask[b], bv = bias[0];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long o =
            ((long long)b * H + 2 * m + q / 2) * W + 2 * n + q % 2;
        const float z = acc[q][0] + bv;
        const float yv = sx_round<T>(sx_load(y + o));
        const float d = (1.f / (1.f + expf(-z)) - yv) * mk;
        logits[o] = z;
        dz[o] = sx_cast<T>(d);
        s[0] += (fmaxf(z, 0.f) - z * yv + log1pf(expf(-fabsf(z)))) * mk;
        s[1] += d;
      }
    }
    block_sums<2>(s, part + ((long long)b * gridDim.x + blockIdx.x) * 2);
  }
};

// Input gradient of a stride-1 'same' conv, computed by conv_quad_kernel as
// a conv of dz with the flipped, transposed weights; gated per pixel, with
// the bias-gradient partials of the COB channels.
template <typename T, int MODE>
struct GateQuadEpi {
  GateOut<T, MODE> g;  // (B, Cout, H, W)
  float* part;
  int Cout, H, W;
  __device__ __forceinline__ void operator()(float (&acc)[4][COB],
                                             const float*, bool active, int b,
                                             int m, int n, int co0) const {
    float db[COB];
#pragma unroll
    for (int co = 0; co < COB; ++co) {
      db[co] = 0.f;
      if (!active) continue;
      const long long base = ((long long)b * Cout + co0 + co) * H;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        db[co] += g.put((base + 2 * m + q / 2) * W + 2 * n + q % 2, acc[q][co]);
    }
    block_sums<COB>(db, part + ((long long)b * gridDim.x + blockIdx.x) * Cout + co0);
  }
};

// Input gradient of the stride-2 transposed conv (convt_relu_kernel's
// adjoint), again a gather: out[ci, m, n] = sum_co sum_ij w[ci, i, j, co] *
// dz[co, 2m + PA - i, 2n + PA - j] over the taps inside dz's (2H, 2W) grid.
// wt (Cz, K, K, Cout) is w transposed.  One thread per position (m, n) and
// COB channels; gated per pixel, with bias-gradient partials.
template <typename T, int K, int MODE>
__global__ void __launch_bounds__(NT) convt_dgrad_kernel(
    const T* __restrict__ dz, const T* __restrict__ wt, GateOut<T, MODE> g,
    float* __restrict__ part, int Cz, int Cout, int H, int W) {
  constexpr int PA = ConvtGeom<K>::PA;
  __shared__ float ws[CC][K * K][COB];

  const int pos = blockIdx.x * NT + threadIdx.x;
  const bool active = pos < H * W;
  const int m = pos / W, n = pos % W;
  const int co0 = blockIdx.y * COB;
  const int b = blockIdx.z;
  const int h2 = 2 * H, w2 = 2 * W;
  const T* dzb = dz + (long long)b * Cz * h2 * w2;

  float acc[COB];
#pragma unroll
  for (int co = 0; co < COB; ++co) acc[co] = 0.f;

  for (int c0 = 0; c0 < Cz; c0 += CC) {
    const int nc = min(CC, Cz - c0);
    __syncthreads();
    stage_weights<T, K, COB>(ws, wt, c0, nc, co0, Cout);
    __syncthreads();
    if (!active) continue;
    for (int cc = 0; cc < nc; ++cc) {
      const T* pl = dzb + (long long)(c0 + cc) * h2 * w2;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int y = 2 * m + PA - i;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int x = 2 * n + PA - j;
          const float v = (y >= 0 && y < h2 && x >= 0 && x < w2)
                              ? sx_load(pl + (long long)y * w2 + x)
                              : 0.f;
#pragma unroll
          for (int co = 0; co < COB; ++co)
            acc[co] = fmaf(v, ws[cc][i * K + j][co], acc[co]);
        }
      }
    }
  }
  float db[COB];
#pragma unroll
  for (int co = 0; co < COB; ++co)
    db[co] = active ? g.put((((long long)b * Cout + co0 + co) * H + m) * W + n,
                            acc[co])
                    : 0.f;
  block_sums<COB>(db, part + ((long long)b * gridDim.x + blockIdx.x) * Cout + co0);
}

// Weight gradient of one tile and one tap (i, j):
//   part[b][ci][i][j][co] = sum_{m, n} in[b, ci, m, n] *
//                           dz[b, co, S*m + OFF - i, S*n + OFF - j]
// over the layer input's (H, W) grid, dz zero outside its (Hz, Wz) grid.
// A stride-1 'same' conv is S = 1, OFF = (K-1)/2; the transposed conv is
// S = 2, OFF = PA.  Threads: tx over co (min(16, Cout)), ty over ci
// (min(16, Cin)), tp over positions when a side has one channel; each
// holds NI x NO sums (NI = Cin / 16 or 1, NO = Cout / 16 or 1).
template <int NI, int NO, class SrcIn, class SrcDz>
__global__ void __launch_bounds__(WT) wgrad_kernel(
    SrcIn in, SrcDz dz, float* __restrict__ part, int Cin, int Cout, int H,
    int W, int Hz, int Wz, int K, int S, int OFF) {
  __shared__ float si[WC][WP + 1];
  __shared__ float sd[WC][WP + 1];
  const int tap = blockIdx.y, ti = tap / K, tj = tap % K, b = blockIdx.z;
  const int txd = min(16, Cout), tyd = min(16, Cin), tpd = WT / (txd * tyd);
  const int t = threadIdx.x, tx = t % txd, ty = (t / txd) % tyd,
            tp = t / (txd * tyd);
  const int npos = H * W;
  const auto tin = in.tile(b);
  const auto tdz = dz.tile(b);

  float acc[NI][NO];
#pragma unroll
  for (int u = 0; u < NI; ++u)
#pragma unroll
    for (int v = 0; v < NO; ++v) acc[u][v] = 0.f;

  // A thread stages one position of each chunk, pp = t % WP, for the
  // channels t / WP + k * (WT / WP): the position's index math once per
  // chunk, and the loads of the unrolled loop in flight together.
  constexpr int CSTEP = WT / WP;
  const int pp0 = t % WP, c0 = t / WP;
  for (int p0 = 0; p0 < npos; p0 += WP) {
    const int pos = p0 + pp0, m = pos / W, n = pos % W;
    const int y = S * m + OFF - ti, x = S * n + OFF - tj;
    const bool in_ok = pos < npos;
    const bool dz_ok = in_ok && y >= 0 && y < Hz && x >= 0 && x < Wz;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WS; ++k) {
      const int c = c0 + k * CSTEP;
      if (c < Cin) si[c][pp0] = in_ok ? tin.at(c).load(m, n) : 0.f;
      if (c < Cout) sd[c][pp0] = dz_ok ? tdz.at(c).load(y, x) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int pp = tp; pp < WP; pp += tpd) {
      float a[NI], d[NO];
#pragma unroll
      for (int u = 0; u < NI; ++u) a[u] = si[ty + tyd * u][pp];
#pragma unroll
      for (int v = 0; v < NO; ++v) d[v] = sd[tx + txd * v][pp];
#pragma unroll
      for (int u = 0; u < NI; ++u)
#pragma unroll
        for (int v = 0; v < NO; ++v) acc[u][v] = fmaf(a[u], d[v], acc[u][v]);
    }
  }
  if (tpd > 1) {  // then NI * NO <= 4: sum the tp slices in order
    static_assert(NI * NO * WT <= WC * (WP + 1), "the sums fit in si");
    float* red = &si[0][0];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < NI; ++u)
#pragma unroll
      for (int v = 0; v < NO; ++v) red[(u * NO + v) * WT + t] = acc[u][v];
    __syncthreads();
    if (tp == 0) {
#pragma unroll
      for (int u = 0; u < NI; ++u)
#pragma unroll
        for (int v = 0; v < NO; ++v) {
          float s = 0.f;
          for (int q = 0; q < tpd; ++q) s += red[(u * NO + v) * WT + t + q * txd * tyd];
          acc[u][v] = s;
        }
    }
  }
  if (tp != 0) return;
#pragma unroll
  for (int u = 0; u < NI; ++u)
#pragma unroll
    for (int v = 0; v < NO; ++v)
      part[(((long long)b * Cin + ty + tyd * u) * K * K + tap) * Cout + tx + txd * v] =
          acc[u][v];
}

// out[c] = sum over the n rows of part (n, m), in a fixed order: one block
// per column, a strided sum per thread, then a shared-memory tree.
__global__ void __launch_bounds__(256) sum_rows_kernel(
    const float* __restrict__ part, float* __restrict__ out, int n, int m) {
  __shared__ float red[256];
  const int col = blockIdx.x;
  float s = 0.f;
  for (int r = threadIdx.x; r < n; r += 256) s += part[(long long)r * m + col];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[col] = red[0];
}

bool wgrad_channels_ok(int c) { return c == 1 || (c % 16 == 0 && c <= WC); }

// One register tile NI x NO, NO chosen at run time.
template <int NI, class SrcIn, class SrcDz>
int launch_wgrad_ni(SrcIn in, SrcDz dz, float* part, int no, dim3 grid,
                    int Cin, int Cout, int H, int W, int Hz, int Wz, int K,
                    int S, int OFF, cudaStream_t st) {
#define SX_NO(NO_)                                                          \
  case NO_:                                                                 \
    wgrad_kernel<NI, NO_, SrcIn, SrcDz><<<grid, WT, 0, st>>>(               \
        in, dz, part, Cin, Cout, H, W, Hz, Wz, K, S, OFF);                  \
    return cudaGetLastError();
  switch (no) { SX_NO(1) SX_NO(2) SX_NO(3) SX_NO(4) }
#undef SX_NO
  return cudaErrorInvalidValue;
}

// The register tiles: NI, NO = channels / 16 (16 to 64 channels) or 1 (one
// channel), each 1..4, every pair of which some depth-2 or depth-3
// geometry runs (the 48-channel filters give 3).  MAXNI bounds NI where the
// caller reads one input channel (conv 0's tiles), so that only the tiles
// it can run are instantiated.
template <int MAXNI, class SrcIn, class SrcDz>
int launch_wgrad(SrcIn in, SrcDz dz, float* part, int B, int Cin, int Cout,
                 int H, int W, int Hz, int Wz, int K, int S, int OFF,
                 cudaStream_t st) {
  if (!wgrad_channels_ok(Cin) || !wgrad_channels_ok(Cout) || B < 1 ||
      B > 65535 || K < 1 || K > 7)
    return cudaErrorInvalidValue;
  const int ni = Cin / min(16, Cin), no = Cout / min(16, Cout);
  const dim3 grid(1, K * K, B);
#define SX_NI(NI_)                                                          \
  case NI_:                                                                 \
    if constexpr (NI_ <= MAXNI)                                             \
      return launch_wgrad_ni<NI_>(in, dz, part, no, grid, Cin, Cout, H, W,  \
                                  Hz, Wz, K, S, OFF, st);                   \
    break;
  switch (ni) { SX_NI(1) SX_NI(2) SX_NI(3) SX_NI(4) }
#undef SX_NI
  return cudaErrorInvalidValue;
}

template <typename TIN, typename T>
int train_in(const void* x, const void* w, const float* bias, void* out,
             uint8_t* bits, int B, int Cout, int H, int W, int K,
             cudaStream_t st) {
  return launch_conv_quad<T, COB>(
      PlaneSrc<TIN, T>{static_cast<const TIN*>(x), nchw(1, H, W)}, w, bias,
      PoolMaskEpi<T>{static_cast<T*>(out), bits, Cout, H / 2, W / 2}, B, 1,
      Cout, H, W, K, st);
}

template <typename TY, typename T>
int train_loss(const void* e, const void* w, const float* bias, const void* y,
               const float* tmask, float* logits, void* dz, float* part,
               int rows, int B, int Cin, int H, int W, int K,
               cudaStream_t st) {
  if (rows != B * quad_blocks(H, W)) return cudaErrorInvalidValue;
  return launch_conv_quad<T, 1>(
      PlaneSrc<T, T>{static_cast<const T*>(e), nchw(Cin, H, W)}, w, bias,
      LossEpi<TY, T>{static_cast<const TY*>(y), tmask, logits,
                     static_cast<T*>(dz), part, H, W},
      B, Cin, 1, H, W, K, st);
}

template <typename T>
int dgrad_conv(const void* dz, const uint8_t* dz_bits, const void* w,
               const void* gate, void* out, float* part, int rows, int B,
               int Cz, int Cout, int H, int W, int K, cudaStream_t st) {
  if (rows != B * quad_blocks(H, W)) return cudaErrorInvalidValue;
  const auto* d = static_cast<const T*>(dz);
  auto* o = static_cast<T*>(out);
  if (dz_bits == nullptr)
    return launch_conv_quad<T, COB>(
        PlaneSrc<T, T>{d, nchw(Cz, H, W)}, w, nullptr,
        GateQuadEpi<T, GATE_RELU>{{o, gate}, part, Cout, H, W}, B, Cz, Cout,
        H, W, K, st);
  return launch_conv_quad<T, COB>(
      RouteSrc<T>{d, dz_bits, Cz, H / 2, W / 2}, w, nullptr,
      GateQuadEpi<T, GATE_ROUTE>{{o, gate}, part, Cout, H, W}, B, Cz, Cout, H,
      W, K, st);
}

template <typename T, int MODE>
int dgrad_convt(const void* dz, const void* w, const void* gate, void* out,
                float* part, int rows, int B, int Cz, int Cout, int H, int W,
                int K, cudaStream_t st) {
  const int nblk = (H * W + NT - 1) / NT;
  if (Cout % COB != 0 || B < 1 || B > 65535 || rows != B * nblk)
    return cudaErrorInvalidValue;
  const dim3 grid(nblk, Cout / COB, B);
  const auto* d = static_cast<const T*>(dz);
  const auto* wt = static_cast<const T*>(w);
  const GateOut<T, MODE> g{static_cast<T*>(out), gate};
  SX_K_SWITCH(K, convt_dgrad_kernel<T, KK, MODE>
                     <<<grid, NT, 0, st>>>(d, wt, g, part, Cz, Cout, H, W));
  return cudaGetLastError();
}

template <typename T>
int wgrad(const void* in, const void* dz, const uint8_t* dz_bits, float* part,
          int B, int Cin, int Cout, int H, int W, int Hz, int Wz, int K,
          int S, int OFF, cudaStream_t st) {
  const PlaneSrc<T, T> src{static_cast<const T*>(in), nchw(Cin, H, W)};
  const auto* d = static_cast<const T*>(dz);
  if (dz_bits == nullptr)
    return launch_wgrad<4>(src, PlaneSrc<T, T>{d, nchw(Cout, Hz, Wz)}, part,
                           B, Cin, Cout, H, W, Hz, Wz, K, S, OFF, st);
  return launch_wgrad<4>(src, RouteSrc<T>{d, dz_bits, Cout, Hz / 2, Wz / 2},
                         part, B, Cin, Cout, H, W, Hz, Wz, K, S, OFF, st);
}

}  // namespace

// Dispatch on the kernel dtype: returns the expression with T = float or
// __nv_bfloat16.
#define SX_DTYPE(dtype, ...)                                              \
  do {                                                                    \
    if ((dtype) == SX_F32) { using T = float; return __VA_ARGS__; }       \
    if ((dtype) == SX_BF16) { using T = __nv_bfloat16; return __VA_ARGS__; } \
    return cudaErrorInvalidValue;                                         \
  } while (0)

// Forward 1 (K5).  x: (B, H, W) float32 tiles, rounded to dtype as loaded;
// w (1, K, K, Cout), out (B, Cout, H/2, W/2) in dtype, bits uint8 alike.
extern "C" int ae_train_in(const float* x, const void* w, const float* bias,
                           void* out, uint8_t* bits, int dtype, int B,
                           int Cout, int H, int W, int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  SX_DTYPE(dtype, train_in<float, T>(x, w, bias, out, bits, B, Cout, H, W, K, st));
}

// Forward 1 (K5b): the same from (B, H, W) tiles already in dtype.
extern "C" int ae_train_in_pre(const void* x, const void* w, const float* bias,
                               void* out, uint8_t* bits, int dtype, int B,
                               int Cout, int H, int W, int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  SX_DTYPE(dtype, train_in<T, T>(x, w, bias, out, bits, B, Cout, H, W, K, st));
}

// Forward 2.  in (B, Cin, H, W) -> out, bits (B, Cout, H/2, W/2).
extern "C" int ae_train_conv_pool(const void* in, const void* w,
                                  const float* bias, void* out, uint8_t* bits,
                                  int dtype, int B, int Cin, int Cout, int H,
                                  int W, int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  SX_DTYPE(dtype, launch_conv_quad<T, COB>(
                      PlaneSrc<T, T>{static_cast<const T*>(in), nchw(Cin, H, W)},
                      w, bias,
                      PoolMaskEpi<T>{static_cast<T*>(out), bits, Cout, H / 2, W / 2},
                      B, Cin, Cout, H, W, K, st));
}

// Loss (K5).  e (B, Cin, H, W) in dtype, w (Cin, K, K, 1); y (B, H, W)
// float32 labels, tmask (B,) float32 -> logits (B, H, W) float32, dz
// (B, 1, H, W) in dtype, part (rows = B * quad blocks, 2): BCE, db5.
extern "C" int ae_train_loss(const void* e, const void* w, const float* bias,
                             const float* y, const float* tmask, float* logits,
                             void* dz, float* part, int rows, int dtype, int B,
                             int Cin, int H, int W, int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  SX_DTYPE(dtype, train_loss<float, T>(e, w, bias, y, tmask, logits, dz, part,
                                       rows, B, Cin, H, W, K, st));
}

// Loss (K5b): the same with labels already in dtype.
extern "C" int ae_train_loss_pre(const void* e, const void* w,
                                 const float* bias, const void* y,
                                 const float* tmask, float* logits, void* dz,
                                 float* part, int rows, int dtype, int B,
                                 int Cin, int H, int W, int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  SX_DTYPE(dtype, train_loss<T, T>(e, w, bias, y, tmask, logits, dz, part,
                                   rows, B, Cin, H, W, K, st));
}

// Input gradient of a stride-1 'same' conv over an (H, W) grid.  w
// (Cz, K, K, Cout) is the layer's kernel flipped and transposed.  dz_bits
// null: dz (B, Cz, H, W), gate = the layer input (relu), out = gated dz of
// the layer below.  Otherwise dz is routed from (B, Cz, H/2, W/2) values and
// dz_bits, gate = the routing bits of the pool below (B, Cout, H, W), out =
// the pooled gradient.  part (rows = B * quad blocks, Cout): bias grads.
extern "C" int ae_train_dgrad_conv(const void* dz, const uint8_t* dz_bits,
                                   const void* w, const void* gate, void* out,
                                   float* part, int rows, int dtype, int B,
                                   int Cz, int Cout, int H, int W, int K,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  SX_DTYPE(dtype, dgrad_conv<T>(dz, dz_bits, w, gate, out, part, rows, B, Cz,
                                Cout, H, W, K, st));
}

// Input gradient of the stride-2 transposed conv: dz (B, Cz, 2H, 2W), w
// (Cz, K, K, Cout) = the Flax kernel transposed, out (B, Cout, H, W).
// route 0: gate = the layer input (relu); 1: gate = pool routing bits.
// part (rows = B * ceil(H*W / 128), Cout): bias grads.
extern "C" int ae_train_dgrad_convt(const void* dz, const void* w,
                                    const void* gate, int route, void* out,
                                    float* part, int rows, int dtype, int B,
                                    int Cz, int Cout, int H, int W, int K,
                                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (route)
    SX_DTYPE(dtype, (dgrad_convt<T, GATE_ROUTE>(dz, w, gate, out, part, rows,
                                                B, Cz, Cout, H, W, K, st)));
  SX_DTYPE(dtype, (dgrad_convt<T, GATE_RELU>(dz, w, gate, out, part, rows, B,
                                             Cz, Cout, H, W, K, st)));
}

// Weight gradient partials, part (B, Cin, K, K, Cout) float32: in
// (B, Cin, H, W) in dtype; dz (B, Cout, Hz, Wz) in dtype, or routed from
// (B, Cout, Hz/2, Wz/2) values and dz_bits; S / OFF as wgrad_kernel.
extern "C" int ae_train_wgrad(const void* in, const void* dz,
                              const uint8_t* dz_bits, float* part, int dtype,
                              int B, int Cin, int Cout, int H, int W, int Hz,
                              int Wz, int K, int S, int OFF, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  SX_DTYPE(dtype, (wgrad<T>(in, dz, dz_bits, part, B, Cin, Cout, H, W, Hz,
                            Wz, K, S, OFF, st)));
}

// conv1's weight gradient partials (K5): x (B, H, W) float32 tiles rounded
// to dtype as loaded, dz routed from (B, Cout, H/2, W/2) and dz_bits.
extern "C" int ae_train_wgrad_x(const float* x, const void* dz,
                                const uint8_t* dz_bits, float* part, int dtype,
                                int B, int Cout, int H, int W, int K,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dz_bits == nullptr) return cudaErrorInvalidValue;
  SX_DTYPE(dtype, (launch_wgrad<1>(
                      PlaneSrc<float, T>{x, nchw(1, H, W)},
                      RouteSrc<T>{static_cast<const T*>(dz), dz_bits, Cout, H / 2, W / 2},
                      part, B, 1, Cout, H, W, H, W, K, 1, (K - 1) / 2, st)));
}

// out (m,) = the sum of part's n rows (n, m), float32.
extern "C" int ae_train_sum(const float* part, float* out, int n, int m,
                            void* stream) {
  if (n < 1 || m < 1) return cudaErrorInvalidValue;
  sum_rows_kernel<<<m, 256, 0, static_cast<cudaStream_t>(stream)>>>(part, out,
                                                                    n, m);
  return cudaGetLastError();
}
