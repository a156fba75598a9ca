// The conv-AE kernels' shared building blocks, for Hopper (sm_90a): used by
// the serving stages (ae.cu) and the training stages (ae_train.cu).
//
//   conv_quad_kernel   'same' K x K convolution, stride 1, one thread per
//                      2x2 quad of output pixels and CB output channels; what
//                      it reads comes from a source functor (a plain NCHW
//                      plane, or a max-pool gradient routed from the pooled
//                      grid) and what it writes from an epilogue functor.
//   convt_relu_kernel  Flax 'SAME' stride-2 transposed conv + bias + relu.
//   GateOut, block_sums  the training epilogues' per-pixel gate and the
//                      per-block channel sums (deterministic: warp shuffles
//                      and a fixed-order sum over the warps, no atomics).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 128;  // threads per block, one output position each
constexpr int CC = 8;    // input channels per shared-memory weight stage
constexpr int COB = 16;  // output channels per thread (pool / convT stages)

// Element (b, ch, y, x) of a stage's input or output lies at
// base(b) + ch * chan + y * ld + x, with tile b = (b / kt, b % kt).
struct Plane {
  long long outer, inner, chan, ld;
  int kt;
  __device__ __forceinline__ long long base(int b) const {
    return (long long)(b / kt) * outer + (long long)(b % kt) * inner;
  }
};

inline Plane nchw(int C, int H, int W) {
  return Plane{(long long)C * H * W, 0, (long long)H * W, W, 1};
}

// A source is read as src.tile(b).at(c).load(y, x): the tile's base is
// computed once per block, a channel's once per channel.  Every thread of
// the block calls tile(b) once before any load, so a source may stage the
// block's input in shared memory there (NormPlaneSrc).

// Source: plane p in TIN, each value rounded to TACT as it is loaded.
template <typename TIN, typename TACT>
struct PlaneSrc {
  const TIN* p;
  Plane pl;
  struct Ch {
    const TIN* q;
    long long ld;
    __device__ __forceinline__ float load(int y, int x) const {
      return sx_round<TACT>(sx_load(q + (long long)y * ld + x));
    }
  };
  struct Tile {
    const TIN* q;
    long long chan, ld;
    __device__ __forceinline__ Ch at(int c) const { return Ch{q + c * chan, ld}; }
  };
  __device__ __forceinline__ Tile tile(int b) const {
    return Tile{p + pl.base(b), pl.chan, pl.ld};
  }
};

// Source: a raw float32 log-PSD, min-max normalized as the block stages
// it.  Tile b = (b / kt, b % kt) is channel b / kt at frames (b % kt) * W ..;
// its value (y, x) lies at p + (b / kt) * outer + y * fs + ((b % kt) * W + x)
// * ts, so the (F, T) layout has ts = 1 and the (T, F) layout fs = 1.  Each
// value becomes (v - mn[c]) / (mx[c] - mn[c]) with an IEEE division (no
// reciprocal), rounded to TACT: the bits that PlaneSrc reads from the
// normalized spectrogram, where the division is done the same way.
//
// One input channel (S1).  The block stages the input its quads read (its
// quad rows' rows with a halo of R = K/2 on each side, the tile's W
// columns with the same halo) in shared memory, normalized, in tile(b):
// each value is loaded and divided once per block, not once per thread
// that reads it (~4x), and the (T, F) layout is read along its contiguous
// frequency rows.  All of a thread's loads are issued before its first
// division: the division's slow-path branch would otherwise hold each load
// until the one before has been divided.  The staged window is SROWS x
// SCOLS whatever K (constant index arithmetic); what lies outside the
// block's rows x cols is not loaded.  Needs W = SW (one block = two quad
// rows) and K <= 7.
constexpr int SW = 128;                     // tile width
constexpr int SROWS = 2 * NT / SW + 7 + 1;  // K + 3 rows at K <= 7
constexpr int SCOLS = SW + 7 + 1;           // W + K columns, one spare
constexpr int SPER = (SROWS * SCOLS + NT - 1) / NT;  // staged values a thread

template <typename TACT>
struct NormPlaneSrc {
  const float* p;
  const float* mn;
  const float* mx;
  long long outer, fs, ts;
  int kt, H, K;
  struct Ch {
    const float* s;  // staged (y - y0, x - x0)
    int y0, x0;
    __device__ __forceinline__ float load(int y, int x) const {
      return s[(y - y0) * SCOLS + x - x0];
    }
  };
  struct Tile {
    Ch ch;
    __device__ __forceinline__ Ch at(int) const { return ch; }
  };
  // Element e of the window: consecutive threads on consecutive addresses,
  // along x in (F, T) (ts = 1), along y in (T, F).
  __device__ __forceinline__ void window(int e, int& i, int& j) const {
    i = ts == 1 ? e / SCOLS : e % SROWS;
    j = ts == 1 ? e % SCOLS : e / SROWS;
  }
  // Every thread of the block calls it once, before any load.
  __device__ __forceinline__ Tile tile(int b) const {
    __shared__ float st[SROWS][SCOLS];
    const int c = b / kt, r = (K - 1) / 2;
    const float* q = p + c * outer + (long long)(b % kt) * SW * ts;
    const int y0 = 2 * (blockIdx.x * NT / (SW / 2)) - r, x0 = -r;
    const int rows = 2 * NT / SW + K + 1, cols = SW + K;
    float v[SPER];
    unsigned in = 0;  // bit u: v[u] was loaded
#pragma unroll
    for (int u = 0; u < SPER; ++u) {
      const int e = threadIdx.x + u * NT;
      int i, j;
      window(e, i, j);
      const int y = y0 + i, x = x0 + j;
      v[u] = 0.f;
      if (e < SROWS * SCOLS && i < rows && j < cols && y >= 0 && y < H && x >= 0 &&
          x < SW) {
        v[u] = q[(long long)y * fs + (long long)x * ts];
        in |= 1u << u;
      }
    }
    const float lo = mn[c], span = mx[c] - lo;
#pragma unroll
    for (int u = 0; u < SPER; ++u) {
      const int e = threadIdx.x + u * NT;
      int i, j;
      window(e, i, j);
      if (e < SROWS * SCOLS)  // outside the tile: 0, never read ('same' padding)
        st[i][j] = (in >> u) & 1 ? sx_round<TACT>(__fdiv_rn(v[u] - lo, span)) : 0.f;
    }
    __syncthreads();
    return Tile{Ch{&st[0][0], y0, x0}};
  }
};

// Source: the gradient at the input of a 2x2 max pool, routed from the
// pooled grid.  v (B, C, H/2, W/2) holds the pooled gradient in T, bits the
// routing mask: bit (y & 1) * 2 + (x & 1) of bits[y/2][x/2] is set where
// pixel (y, x) is maximal in its window and the max is > 0.
template <typename T>
struct RouteSrc {
  const T* v;
  const uint8_t* bits;
  int C, hh, wh;
  struct Ch {
    const T* v;
    const uint8_t* m;
    int wh;
    __device__ __forceinline__ float load(int y, int x) const {
      const long long o = (long long)(y >> 1) * wh + (x >> 1);
      const float val = sx_load(v + o);  // not behind the bits: both in flight
      return ((m[o] >> (((y & 1) << 1) | (x & 1))) & 1) ? val : 0.f;
    }
  };
  struct Tile {
    const T* v;
    const uint8_t* m;
    long long chan;
    int wh;
    __device__ __forceinline__ Ch at(int c) const {
      return Ch{v + c * chan, m + c * chan, wh};
    }
  };
  __device__ __forceinline__ Tile tile(int b) const {
    const long long chan = (long long)hh * wh, o = (long long)b * C * chan;
    return Tile{v + o, bits + o, chan, wh};
  }
};

// Stage the float weights of input channels [c0, c0 + nc) and output
// channels [co0, co0 + cob) from w (Cin, K, K, Cout).
template <typename TW, int K, int CB>
__device__ __forceinline__ void stage_weights(float (&ws)[CC][K * K][CB],
                                              const TW* __restrict__ w, int c0,
                                              int nc, int co0, int Cout) {
  for (int e = threadIdx.x; e < nc * K * K * CB; e += NT) {
    const int co = e % CB, rest = e / CB;
    ws[rest / (K * K)][rest % (K * K)][co] =
        sx_load(w + ((long long)c0 * K * K + rest) * Cout + co0 + co);
  }
}

// 'same' K x K convolution (stride 1) of the quad (2m+a, 2n+b), a, b in
// {0, 1}, for CB output channels: acc[a * 2 + b][co], without bias.  Then
// epi(acc, bias, active, b, m, n, co0) writes the result; every thread of
// the block reaches it (epilogues may reduce over the block).
template <typename TACT, int K, int CB, class Src, class Epi>
__global__ void __launch_bounds__(NT) conv_quad_kernel(
    Src src, const TACT* __restrict__ w, const float* __restrict__ bias,
    Epi epi, int Cin, int Cout, int H, int W) {
  constexpr int R = (K - 1) / 2;
  constexpr int P = K + 1;
  __shared__ float ws[CC][K * K][CB];

  const int wq = W / 2;
  const int pos = blockIdx.x * NT + threadIdx.x;
  const bool active = pos < (H / 2) * wq;
  const int m = pos / wq, n = pos % wq;
  const int co0 = blockIdx.y * CB;
  const int b = blockIdx.z;

  const auto tile = src.tile(b);

  float acc[4][CB];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int co = 0; co < CB; ++co) acc[q][co] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    const int nc = min(CC, Cin - c0);
    __syncthreads();
    stage_weights<TACT, K, CB>(ws, w, c0, nc, co0, Cout);
    __syncthreads();
    if (!active) continue;
    for (int cc = 0; cc < nc; ++cc) {
      const auto ch = tile.at(c0 + cc);
      float p[P][P];
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int y = 2 * m - R + r;
#pragma unroll
        for (int s = 0; s < P; ++s) {
          const int xx = 2 * n - R + s;
          p[r][s] = (y >= 0 && y < H && xx >= 0 && xx < W) ? ch.load(y, xx) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j)
#pragma unroll
          for (int co = 0; co < CB; ++co) {
            const float wv = ws[cc][i * K + j][co];
            acc[0][co] = fmaf(p[i][j], wv, acc[0][co]);
            acc[1][co] = fmaf(p[i][j + 1], wv, acc[1][co]);
            acc[2][co] = fmaf(p[i + 1][j], wv, acc[2][co]);
            acc[3][co] = fmaf(p[i + 1][j + 1], wv, acc[3][co]);
          }
    }
  }
  epi(acc, bias, active, b, m, n, co0);
}

// Flax nn.ConvTranspose (transpose_kernel=False), stride 2, 'SAME', + bias
// + relu: out[y] = sum_i x[(y + i - PA) / 2] * w[i] over the taps i where
// y + i - PA is even and the source row exists, PA = jax.lax's pad_a.  One
// thread per input position (m, n) computes the output quad (2m+a, 2n+b):
// every tap lands on exactly one quad pixel, and the sources lie in rows
// and columns m + DMIN .. m + DMAX.
template <int K>
struct ConvtGeom {
  static constexpr int PA = (2 > K - 1) ? K - 1 : (K + 1) / 2;
  static constexpr int DMIN = -(PA / 2);
  static constexpr int DMAX = (K - PA) / 2;
  static constexpr int NR = DMAX - DMIN + 1;
};

template <typename T, int K>
__global__ void __launch_bounds__(NT) convt_relu_kernel(
    const T* __restrict__ in, const T* __restrict__ w,
    const float* __restrict__ bias, T* __restrict__ out, int Cin, int Cout,
    int H, int W) {
  using G = ConvtGeom<K>;
  constexpr int PA = G::PA, DMIN = G::DMIN, NR = G::NR;
  __shared__ float ws[CC][K * K][COB];

  const int pos = blockIdx.x * NT + threadIdx.x;
  const bool active = pos < H * W;
  const int m = pos / W, n = pos % W;
  const int co0 = blockIdx.y * COB;
  const int b = blockIdx.z;
  const T* inb = in + (long long)b * Cin * H * W;

  float acc[4][COB];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int co = 0; co < COB; ++co) acc[q][co] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    const int nc = min(CC, Cin - c0);
    __syncthreads();
    stage_weights<T, K, COB>(ws, w, c0, nc, co0, Cout);
    __syncthreads();
    if (!active) continue;
    for (int cc = 0; cc < nc; ++cc) {
      const T* pl = inb + (long long)(c0 + cc) * H * W;
      float p[NR][NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int y = m + DMIN + r;
#pragma unroll
        for (int s = 0; s < NR; ++s) {
          const int xx = n + DMIN + s;
          p[r][s] = (y >= 0 && y < H && xx >= 0 && xx < W)
                        ? sx_load(pl + (long long)y * W + xx)
                        : 0.f;
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if ((a + i - PA) & 1) continue;
          const int r = (a + i - PA) / 2 - DMIN;
#pragma unroll
          for (int bb = 0; bb < 2; ++bb)
#pragma unroll
            for (int j = 0; j < K; ++j) {
              if ((bb + j - PA) & 1) continue;
              const int s = (bb + j - PA) / 2 - DMIN;
#pragma unroll
              for (int co = 0; co < COB; ++co)
                acc[a * 2 + bb][co] =
                    fmaf(p[r][s], ws[cc][i * K + j][co], acc[a * 2 + bb][co]);
            }
        }
    }
  }
  if (!active) return;

  const int ho = 2 * H, wo = 2 * W;
#pragma unroll
  for (int co = 0; co < COB; ++co) {
    const float bv = bias[co0 + co];
    T* oc = out + ((long long)b * Cout + co0 + co) * ho * wo;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      oc[(long long)(2 * m + q / 2) * wo + 2 * n + q % 2] =
          sx_cast<T>(fmaxf(acc[q][co] + bv, 0.f));
  }
}

// Blocks along x of a conv_quad_kernel launch over an H x W grid.
inline int quad_blocks(int H, int W) { return ((H / 2) * (W / 2) + NT - 1) / NT; }

// The K cases every launcher instantiates (ae_kernel.supports: odd, <= 7).
#define SX_K_SWITCH(K, ...)                                   \
  switch (K) {                                                \
    case 1: { constexpr int KK = 1; __VA_ARGS__; } break;     \
    case 3: { constexpr int KK = 3; __VA_ARGS__; } break;     \
    case 5: { constexpr int KK = 5; __VA_ARGS__; } break;     \
    case 7: { constexpr int KK = 7; __VA_ARGS__; } break;     \
    default: return cudaErrorInvalidValue;                    \
  }

template <typename TACT, int CB, class Src, class Epi>
int launch_conv_quad(Src src, const void* w, const float* bias, Epi epi,
                     int B, int Cin, int Cout, int H, int W, int K,
                     cudaStream_t st) {
  if (Cout % CB != 0 || H % 2 != 0 || W % 2 != 0 || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(quad_blocks(H, W), Cout / CB, B);
  const auto* wt = static_cast<const TACT*>(w);
  SX_K_SWITCH(K, conv_quad_kernel<TACT, KK, CB, Src, Epi>
                     <<<grid, NT, 0, st>>>(src, wt, bias, epi, Cin, Cout, H, W));
  return cudaGetLastError();
}

template <typename T>
int launch_convt(const void* in, const void* w, const float* bias, void* out,
                 int B, int Cin, int Cout, int H, int W, int K,
                 cudaStream_t st) {
  if (Cout % COB != 0 || B < 1 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((H * W + NT - 1) / NT, Cout / COB, B);
  const auto* i = static_cast<const T*>(in);
  const auto* wt = static_cast<const T*>(w);
  auto* o = static_cast<T*>(out);
  SX_K_SWITCH(K, convt_relu_kernel<T, KK>
                     <<<grid, NT, 0, st>>>(i, wt, bias, o, Cin, Cout, H, W));
  return cudaGetLastError();
}

// Sum v[0..N) over the block's NT threads and write the N sums to out[0..N)
// (thread 0..N-1 each write one).  Fixed order: a warp shuffle tree, then
// the warps in order.  Every thread of the block must call it.
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float* out) {
  __shared__ float red[NT / 32][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += red[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// The gate of a backward stage's output pixel v (an input-gradient sum in
// float32) at element offset o of the (B, C, H, W) output:
//   RELU:  g = (act[o] > 0), store round(v * g)           (relu' of the
//          forward activation; see ae_train.cu for why the stored act)
//   ROUTE: g = popcount(bits[o]), store round(v)          (the pooled
//          gradient; the routing is applied where it is read, RouteSrc)
// and the bias gradient takes v * g: the sum of the float32 dz over the
// pixels it reaches.
enum GateMode { GATE_RELU = 0, GATE_ROUTE = 1 };

template <typename T, int MODE>
struct GateOut {
  T* out;
  const void* gate;
  __device__ __forceinline__ float put(long long o, float v) const {
    float g;
    if constexpr (MODE == GATE_RELU) {
      g = sx_load(static_cast<const T*>(gate) + o) > 0.f ? 1.f : 0.f;
      out[o] = sx_cast<T>(v * g);
    } else {
      g = (float)__popc(static_cast<const uint8_t*>(gate)[o]);
      out[o] = sx_cast<T>(v);
    }
    return v * g;
  }
};

}  // namespace
