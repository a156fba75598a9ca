// The conv-AE kernels' shared building blocks, for Hopper (sm_90a): used by
// the serving stages (ae.cu) and the training stages (ae_train.cu).
//
//   conv_quad_kernel   'same' K x K convolution, stride 1, one thread per
//                      2x2 quad of output pixels and CB output channels; what
//                      it reads comes from a source functor (a plain NCHW
//                      plane, or a max-pool gradient routed from the pooled
//                      grid) and what it writes from an epilogue functor.
//   conv_igemm_kernel  the same convolution for bf16 launches with >= 16
//                      input and output channels, as an implicit GEMM on the
//                      tensor cores (mma.sync), with its own source and
//                      epilogue functors.
//   convt_relu_kernel  Flax 'SAME' stride-2 transposed conv + bias + relu,
//                      for float32 launches.
//   convt_igemm_kernel the same for bf16 launches, as four implicit GEMMs
//                      (one per output parity) on the tensor cores.
//   conv_out_mma_kernel  a bf16 conv to one output channel (the out-conv:
//                      the serving S4, the training loss), each tap row a
//                      GEMM on the tensor cores over an input staged once,
//                      cp.async double-buffered, with an epilogue functor.
//   conv_in_mma_kernel a bf16 conv from one input channel (the serving S1,
//                      the training conv 0, the out-conv's input gradient),
//                      a GEMM whose K is the taps, on the tensor cores, with
//                      its own source and epilogue functors.
//   GateOut, block_sums  the training epilogues' per-pixel gate and the
//                      per-block channel sums (deterministic: warp shuffles
//                      and a fixed-order sum over the warps, no atomics).
//
// Which template a launch takes is decided by its dtype and channel counts
// alone: in bf16 the multi-channel stride-1 convs run conv_igemm_kernel,
// the out-conv (S4, the loss) conv_out_mma_kernel, the convs from one input
// channel (S1, conv 0, the out-conv's input gradient) conv_in_mma_kernel;
// every float32 stride-1 conv runs conv_quad_kernel; the transposed convs
// run convt_igemm_kernel in bf16 and convt_relu_kernel in float32.  Nothing
// falls back from one to the other: a bf16 launch that a tensor-core
// template refuses raises.
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
// it (the float32 ae_tile_in_norm; bf16 runs CiSpecSrc on
// conv_in_mma_kernel).  Tile b = (b / kt, b % kt) is channel b / kt at
// frames (b % kt) * W ..; its value (y, x) lies at p + (b / kt) * outer + y
// * fs + ((b % kt) * W + x) * ts, so the (F, T) layout has ts = 1 and the
// (T, F) layout fs = 1.  Each
// value becomes (v - mn[c]) / (mx[c] - mn[c]) with an IEEE division (no
// reciprocal): the values that PlaneSrc reads from the normalized
// spectrogram, where the division is done the same way.
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
        st[i][j] = (in >> u) & 1 ? __fdiv_rn(v[u] - lo, span) : 0.f;
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

template <int K>
__global__ void __launch_bounds__(NT) convt_relu_kernel(
    const float* __restrict__ in, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int Cin, int Cout,
    int H, int W) {
  using G = ConvtGeom<K>;
  constexpr int PA = G::PA, DMIN = G::DMIN, NR = G::NR;
  __shared__ float ws[CC][K * K][COB];

  const int pos = blockIdx.x * NT + threadIdx.x;
  const bool active = pos < H * W;
  const int m = pos / W, n = pos % W;
  const int co0 = blockIdx.y * COB;
  const int b = blockIdx.z;
  const float* inb = in + (long long)b * Cin * H * W;

  float acc[4][COB];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int co = 0; co < COB; ++co) acc[q][co] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    const int nc = min(CC, Cin - c0);
    __syncthreads();
    stage_weights<float, K, COB>(ws, w, c0, nc, co0, Cout);
    __syncthreads();
    if (!active) continue;
    for (int cc = 0; cc < nc; ++cc) {
      const float* pl = inb + (long long)(c0 + cc) * H * W;
      float p[NR][NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int y = m + DMIN + r;
#pragma unroll
        for (int s = 0; s < NR; ++s) {
          const int xx = n + DMIN + s;
          p[r][s] = (y >= 0 && y < H && xx >= 0 && xx < W)
                        ? pl[(long long)y * W + xx]
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
    float* oc = out + ((long long)b * Cout + co0 + co) * ho * wo;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      oc[(long long)(2 * m + q / 2) * wo + 2 * n + q % 2] = fmaxf(acc[q][co] + bv, 0.f);
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

// Launches of each conv template since the library was loaded (0:
// conv_quad_kernel, 1: conv_igemm_kernel, 2: convt_relu_kernel, 3:
// convt_igemm_kernel, 4: conv_out_mma_kernel, 5: conv_in_mma_kernel),
// counted on the host where a launch succeeds: a run can show which
// template each launch site took.
constexpr int SX_TEMPLATES = 6;
long long sx_conv_launches[SX_TEMPLATES];

inline int count_conv_launch(int which) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++sx_conv_launches[which];
  return err;
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
  return count_conv_launch(0);
}

// ---------------------------------------------------------------------------
// conv_igemm_kernel: the 'same' K x K stride-1 convolution of a bf16 launch
// with Cin and Cout multiples of 16 (Cout <= 64), as an implicit GEMM on
// bf16 mma.sync.m16n8k16 (bf16 in, float32 out):
//   D[p, co] = sum_{(c, tap)} A[p, (c, tap)] * Wt[(c, tap), co]
// over the output positions p of a strip of R rows of one tile (M), all Cout
// channels in 8-channel fragments (N) and the reduction over the input
// channels c in 16-channel chunks per tap (K).  A is the input read through
// the tap's shift, zero outside the tile ('same' padding).  wt is
// (K, K, Cout, Cin): the layer's weight with the input channel fastest,
// arranged once when the layer table is built.  It computes the math of
// conv_quad_kernel (its epilogues keep their functors' semantics) for the
// multi-channel launches in bf16: the S2 (ae_conv_pool), the training
// forward (ae_train_conv_pool) and the encoder convs' routed input
// gradient (ae_train_dgrad_conv).
//
// Block: 8 warps, one tile b, one strip of R rows (blockIdx.x).  Each warp
// holds a row pair (2m, 2m + 1) x 16 columns (two 16-position fragments)
// and NW 8-channel fragments; for up to 32 channels one group of 8 warps
// covers every channel, for 48 and 64 two groups of 4 warps take half each
// (at most 2 x NW x 4 = 32 accumulators a thread, and as many for a chunk's
// fresh sums).  Fragment row r is column x0 + 2 (r mod 8) + r / 8, so the
// two positions a thread holds (rows gq and gq + 8) are a horizontal pair
// and its two fragments the vertical pair: a 2x2 pool window is max-pooled
// in registers.
//
// Staging, per 16-channel chunk: the strip's input rows y0 - r .. y0 + R -
// 1 + r (r = K / 2) with the taps' halo columns, zeros outside the tile,
// each staged position one run of 16 channels (32 bytes, channel fastest:
// each half of a run is one 8x8 row of an ldmatrix), the columns split
// into their two phases (staged column s = x + XO, XO = r rounded up to
// even, in phase s & 1 at index s / 2) so that the 8 positions of a fragment
// load are 8 consecutive runs; a run's two 16-byte halves swap where bit 2
// of its index is set (run_word), so those 8 runs fall in 32 banks.  A
// thread stages a column pair of one row: 16 32-bit loads of the channel
// planes (a routed gradient: the pooled value and its bits, decoded once
// here, not once per tap), split by byte permutes.  Then the chunk's
// weights for every tap and output channel, run tap * Cout + co holding
// wt[tap][co][c0 ..] (two 16-byte loads, four runs in flight a thread).
// A and B fragments are read by ldmatrix (one x4 for a 16-position A
// fragment, one for a pair of 8-channel B fragments).
//
// Accumulation: a chain is Cin K^2 products (3136 at 64 channels, k7); the
// tensor cores' float32 accumulation drifts with its length, so each chunk
// (16 K^2 products) accumulates in fresh fragments that are then added into
// float32 registers, chunk by chunk in order (as convt_dgrad_kernel).
//
// What bounds it: 2 * H * W * Cin * Cout * K^2 FLOP a tile (the flagship S2
// 90.6 GFLOP a shot, 0.092 ms at the bf16 peak) against the input read once
// and the pooled output written once (0.117 ms at 3.35 TB/s): bytes.  This
// first design stages with plain loads, does not overlap staging and MMAs,
// re-reads the halo rows and the layer's weights (up to 401 KB at 64 x 64
// channels, k7) from L2 in every block.
constexpr int IG_WARPS = 8;
constexpr int IG_NT = 32 * IG_WARPS;

template <int NF>
struct IgShape {
  static constexpr int NG = NF > 4 ? 2 : 1;      // groups of warps over Cout
  static constexpr int NW = NF / NG;             // 8-channel fragments a warp
  static constexpr int PW = IG_WARPS / NG;       // warps of a group
  static constexpr int POS = PW * 32;            // positions a block
};

// Strip rows of a conv_igemm_kernel launch with Cout channels over a grid W
// columns wide (a block's positions / W), or -1 where the kernel does not
// take the width.  ops/ae_train_kernel.py conv_igemm_rows mirrors it.
inline int ig_strip_rows(int Cout, int W) {
  const int pos = Cout > 32 ? IgShape<8>::POS : IgShape<4>::POS;
  if (W < 16 || W % 16 != 0 || pos % W != 0 || pos / W < 2) return -1;
  return pos / W;
}

struct IgGeom {
  int Cin, Cout, H, W, K, r;  // r = K / 2
  int R, RT, XO, WH;          // strip rows, staged rows, column offset, runs a
                              // staged row has in each column phase
};

// Word q (0..7) of a 32-byte run L of 16 bf16: the run's two 16-byte halves
// swap where bit 2 of L is set.
__device__ __forceinline__ int run_word(int L, int q) { return L * 8 + (q ^ (L & 4)); }

// Four (two) 8x8 b16 matrices from shared memory: lane l gives the address
// of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); register i of
// thread t holds row t / 4, columns 2 (t % 4) and 2 (t % 4) + 1 of matrix i:
// an mma.sync fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint32_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const uint32_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Source: an NCHW bf16 plane (B, Cin, H, W), as PlaneSrc reads it.  pair()
// gives channels c0 .. c0 + 15 at columns (x, x + 1) of row y, x even: word
// c holds column x in its low half.
struct IgPlaneSrc {
  const __nv_bfloat16* p;
  bool aligned() const { return reinterpret_cast<uintptr_t>(p) % 4 == 0; }
  __device__ __forceinline__ void pair(uint32_t (&v)[16], const IgGeom& g, int b,
                                       int c0, int y, int x) const {
    const long long chan = (long long)g.H * g.W;
    const __nv_bfloat16* q = p + ((long long)b * g.Cin + c0) * chan + (long long)y * g.W + x;
#pragma unroll
    for (int c = 0; c < 16; ++c) v[c] = *reinterpret_cast<const uint32_t*>(q + c * chan);
  }
};

// Source: the gradient at the input of a 2x2 max pool, routed from the
// pooled grid, as RouteSrc reads it: v (B, Cin, H/2, W/2) bf16 and bits
// (bit (y & 1) * 2 + (x & 1) of bits[y/2][x/2]: pixel (y, x) takes the
// pooled value).  A column pair (x, x + 1), x even, is one pooled value and
// its bits.
struct IgRouteSrc {
  const __nv_bfloat16* v;
  const uint8_t* bits;
  bool aligned() const { return reinterpret_cast<uintptr_t>(v) % 2 == 0; }
  __device__ __forceinline__ void pair(uint32_t (&out)[16], const IgGeom& g, int b,
                                       int c0, int y, int x) const {
    const long long chan = (long long)(g.H / 2) * (g.W / 2);
    const long long o = ((long long)b * g.Cin + c0) * chan + (long long)(y >> 1) * (g.W / 2) +
                        (x >> 1);
    const unsigned short* raw = reinterpret_cast<const unsigned short*>(v) + o;
    const uint8_t* m = bits + o;
    uint32_t val[16], k[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {  // every load in flight before the decode
      val[c] = raw[c * chan];
      k[c] = m[c * chan];
    }
    const int sh = (y & 1) * 2;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      out[c] = ((k[c] >> sh) & 1u ? val[c] : 0u) | ((k[c] >> (sh + 1)) & 1u ? val[c] << 16 : 0u);
  }
};

// Stage input channels c0 .. c0 + 15 of the strip at row y0: run
// (t * 2 + s % 2) * WH + s / 2 holds staged row t (input row y0 - r + t) at
// staged column s (input column s - XO).  A unit is a column pair of a row.
template <class Src>
__device__ __forceinline__ void ig_stage_in(const Src& src, uint32_t* as, const IgGeom& g,
                                            int b, int c0, int y0) {
  const int total = g.RT * g.WH;
  for (int e = threadIdx.x; e < total; e += IG_NT) {
    const int t = e / g.WH, i = e % g.WH;
    const int y = y0 - g.r + t, x = 2 * i - g.XO;
    uint32_t v[16];  // a unit's 16 loads in flight before its stores
    if (y >= 0 && y < g.H && x >= 0 && x < g.W) {
      src.pair(v, g, b, c0, y, x);
    } else {
#pragma unroll
      for (int c = 0; c < 16; ++c) v[c] = 0u;
    }
    const int L0 = 2 * t * g.WH + i, L1 = L0 + g.WH;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      as[run_word(L0, q)] = __byte_perm(v[2 * q], v[2 * q + 1], 0x5410);
      as[run_word(L1, q)] = __byte_perm(v[2 * q], v[2 * q + 1], 0x7632);
    }
  }
}

// Stage a chunk's weights from wt (taps, Cout, Cin) for nco output channels
// from co0: run tap * nco + co holds wt[tap][co0 + co][c0 ..].  Blocks of
// IG_NT threads.
__device__ __forceinline__ void ig_stage_w(const __nv_bfloat16* __restrict__ wt, uint32_t* ws,
                                           int taps, int Cout, int co0, int nco, int Cin,
                                           int c0) {
  constexpr int U = 4;  // runs in flight a thread: all loads of a round before its stores
  const int total = taps * nco;
  for (int e0 = threadIdx.x; e0 < total; e0 += IG_NT * U) {
    uint4 v[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * IG_NT;
      if (e < total) {
        const long long row = (long long)(e / nco) * Cout + co0 + e % nco;
        const uint4* src = reinterpret_cast<const uint4*>(wt + row * Cin + c0);
        v[u][0] = src[0];
        v[u][1] = src[1];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * IG_NT;
      if (e >= total) continue;
      *reinterpret_cast<uint4*>(ws + run_word(e, 0)) = v[u][0];
      *reinterpret_cast<uint4*>(ws + run_word(e, 4)) = v[u][1];
    }
  }
}

// The sums of the warp's positions: acc[f][n][h * 2 + e] is position
// (y + f, x0 + 2 gq + h), channel co0 + 8 n + 2 tq + e.  Then epi(acc,
// bias, b, y, x0, co0) writes them; every thread of the block reaches it.
template <int NF, class Src, class Epi>
__global__ void __launch_bounds__(IG_NT, 2) conv_igemm_kernel(
    Src src, const __nv_bfloat16* __restrict__ wt, const float* __restrict__ bias, Epi epi,
    IgGeom g) {
  using S = IgShape<NF>;
  constexpr int NW = S::NW;
  extern __shared__ __align__(16) unsigned char ig_smem[];
  uint32_t* as = reinterpret_cast<uint32_t*>(ig_smem);
  uint32_t* ws = as + g.RT * 2 * g.WH * 8;

  const int b = blockIdx.z, y0 = blockIdx.x * g.R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, mat = lane >> 3;
  const int grp = warp / S::PW, pw = warp % S::PW, cgs = g.W / 16;
  const int rp = pw / cgs, x0 = (pw % cgs) * 16, co0 = grp * NW * 8;

  float acc[2][NW][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[f][n][q] = 0.f;

  const int kk = g.K * g.K;
  for (int c0 = 0; c0 < g.Cin; c0 += 16) {
    __syncthreads();
    ig_stage_in(src, as, g, b, c0, y0);
    ig_stage_w(wt, ws, g.K * g.K, g.Cout, 0, g.Cout, g.Cin, c0);
    __syncthreads();
    float cacc[2][NW][4];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) cacc[f][n][q] = 0.f;
    for (int tap = 0; tap < kk; ++tap) {
      const int dy = tap / g.K, s0 = x0 + tap % g.K - g.r + g.XO;
      // B: matrix m of a pair of fragments is fragment n + m / 2, channel
      // half m % 2; lane l reads the run of output channel l % 8
      const uint32_t* wb = ws + run_word(tap * g.Cout + co0 + (lane & 7) + 8 * (mat >> 1),
                                         4 * (mat & 1));
      uint32_t bq[NW][2];
#pragma unroll
      for (int n = 0; n + 1 < NW; n += 2) {
        uint32_t r4[4];
        ldmatrix_x4(r4, wb + 64 * n);
        bq[n][0] = r4[0];
        bq[n][1] = r4[1];
        bq[n + 1][0] = r4[2];
        bq[n + 1][1] = r4[3];
      }
      if constexpr (NW % 2 == 1) ldmatrix_x2(bq[NW - 1], wb + 64 * (NW - 1));
      // A: matrix m is fragment rows 8 (m % 2) .. (staged columns s0 + 2 i
      // and s0 + 1 + 2 i for row i and 8 + i), channel half m / 2
      const int s = s0 + (mat & 1);
      const int la = (s & 1) * g.WH + (s >> 1) + (lane & 7);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        uint32_t a[4];
        ldmatrix_x4(a, as + run_word((2 * rp + f + dy) * 2 * g.WH + la, 4 * (mat >> 1)));
#pragma unroll
        for (int n = 0; n < NW; ++n)
          mma_bf16(cacc[f][n], a[0], a[1], a[2], a[3], bq[n][0], bq[n][1]);
      }
    }
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[f][n][q] += cacc[f][n][q];
  }
  epi(acc, bias, b, y0 + 2 * rp, x0, co0);
}

template <int NF, class Src, class Epi>
int launch_igemm_nf(Src src, const __nv_bfloat16* wt, const float* bias, Epi epi, int B,
                    const IgGeom& g, cudaStream_t st) {
  const long long smem = (2LL * g.RT * g.WH + (long long)g.K * g.K * g.Cout) * 32;
  if (smem > 227 * 1024 - (long long)sizeof(float) * IG_WARPS * 32) return cudaErrorInvalidValue;
  auto kern = conv_igemm_kernel<NF, Src, Epi>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(g.H / g.R, 1, B), IG_NT, smem, st>>>(src, wt, bias, epi, g);
  return count_conv_launch(1);
}

// The launch: the source's rows 4-byte aligned, wt 16-byte aligned;
// K odd up to 7; Cin a multiple of 16; Cout 16, 32, 48 or 64; W 32 or 64
// (ig_strip_rows), H a multiple of the strip rows.  Returns
// cudaErrorInvalidValue for anything else: the caller raises.
template <class Src, class Epi>
int launch_conv_igemm(Src src, const void* w, const float* bias, Epi epi, int B, int Cin,
                      int Cout, int H, int W, int K, cudaStream_t st) {
  const int R = ig_strip_rows(Cout, W);
  if (K < 1 || K > 7 || K % 2 == 0 || Cin < 16 || Cin % 16 != 0 || Cout < 16 || Cout > 64 ||
      Cout % 16 != 0 || R < 2 || H < R || H % R != 0 || B < 1 || B > 65535 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || !src.aligned())
    return cudaErrorInvalidValue;
  IgGeom g{Cin, Cout, H, W, K, K / 2};
  g.R = R;
  g.RT = R + 2 * g.r;
  g.XO = (g.r + 1) & ~1;
  g.WH = (g.XO + W + g.r + 1) / 2;
  const auto* wt = static_cast<const __nv_bfloat16*>(w);
  switch (Cout / 8) {
    case 2: return launch_igemm_nf<2>(src, wt, bias, epi, B, g, st);
    case 4: return launch_igemm_nf<4>(src, wt, bias, epi, B, g, st);
    case 6: return launch_igemm_nf<6>(src, wt, bias, epi, B, g, st);
    case 8: return launch_igemm_nf<8>(src, wt, bias, epi, B, g, st);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// convt_igemm_kernel: convt_relu_kernel's function (the Flax 'SAME'
// stride-2 transposed conv + bias + relu) for bf16 launches with Cin and
// Cout multiples of 16, as implicit GEMMs on bf16 mma.sync.m16n8k16 (bf16
// in, float32 out).  Output (2m + a, 2n + b) is parity (a, b): a stride-1
// product over the input grid with the taps {(i, j): a + i - PA and b + j -
// PA even}, tap (i, j) at shift (dy, dx) = ((a + i - PA) / 2, (b + j - PA)
// / 2) (ConvtGeom):
//   D_ab[p, co] = sum_{(c, (i, j) in T_ab)} A[p + (dy, dx), c] * wt[i][j][co][c]
// over the input positions p (M, 16-position fragments), the output
// channels co (N, 8-channel fragments) and the input channels in 16-channel
// chunks times the parity's taps (K).  Taps per parity (0,0), (0,1), (1,0),
// (1,1): k1 1, 0, 0, 0 (three parities are relu(bias)); k3 4, 2, 2, 1; k5
// 4, 6, 6, 9; k7 16, 12, 12, 9.  Each tap is in one parity, so a position
// costs K^2 Cin Cout MACs, as in the direct form.  wt is (K, K, Cout, Cin),
// the Flax kernel with its input channel fastest, arranged once with the
// layer table.  The JAX kernels (K3's L3/L4, K6's dec2..dec0) decompose it
// the same way, one matmul per parity on the MXU.
//
// Block: 8 warps, one tile b (blockIdx.z), one strip of R = 128 / W input
// rows (blockIdx.y) and 16 output channels (blockIdx.x: a strip's channel
// groups are neighbouring blocks, which read its input from L2).  Warp w
// holds one 16-position fragment (row w / (W / 16) of the strip, columns
// x0 .. x0 + 15) and all four parities of the block's 16 channels: 32
// float32 totals a thread, 32 more for a chunk's fresh sums.  Per 16-channel
// chunk the block stages the strip's input rows y0 + DMIN .. y0 + R - 1 +
// DMAX and columns DMIN .. W - 1 + DMAX (zeros outside the tile), each
// position one 32-byte run, channel fastest, whose 16-byte halves swap
// where bit 2 of the run's index is set (run_word): the 8 consecutive
// positions of a fragment load fall in 32 banks at any shift.  A thread
// stages a column pair of a row: 16 32-bit loads of the channel planes.
// Then the chunk's weights for every tap and the block's channels: run
// tap * 16 + co.  Each input value is loaded from device memory once per
// block and feeds every tap of the four parities: a warp walks the NR x NR
// shifts, one ldmatrix A fragment a shift, and for each parity with a tap
// at that shift one ldmatrix of two B fragments and two mma.sync.  Each
// chunk accumulates in fresh fragments, added into the totals chunk by
// chunk in order (a chain is up to Cin x 16 products; the tensor cores'
// float32 accumulation drifts with its length, as in convt_dgrad_kernel).
//
// Epilogue: bias, relu and one bf16 rounding; the block's (16, 2R, 2W)
// output goes through shared memory (the staging area) and out in 16-byte
// runs along each NCHW row: the output is 4x the input and most of the
// bytes (the flagship's second transposed conv writes 1.26 GB a shot),
// while a thread's accumulators are pairs of channels at scattered
// positions.
//
// What bounds it: 2 H W Cin Cout K^2 FLOP a tile (the flagship's two
// transposed convs 113 GFLOP a shot, deep3's three 315: 0.11 and 0.32 ms at
// the bf16 peak) against the input read once and the output written once
// (1.97 and 1.61 GB a shot: 0.59 and 0.48 ms at 3.35 TB/s): bytes.  This
// first design stages with plain loads, does not overlap staging and MMAs,
// and each block re-reads the halo rows and its channels' weights from L2.
constexpr int CT_POS = 16 * IG_WARPS;     // input positions a block: a fragment a warp
constexpr int CT_CO = 16;                 // output channels a block
constexpr int CT_OCS = 4 * CT_POS + 8;    // bf16 a channel in the output stage (+8: banks)

// Strip rows of a convt_igemm_kernel launch over an input grid W columns
// wide, or -1 where the kernel does not take the width.
// ops/ae_kernel.py convt_igemm_rows mirrors it.
inline int ct_strip_rows(int W) {
  if (W < 16 || W % 16 != 0 || CT_POS % W != 0) return -1;
  return CT_POS / W;
}

struct CtGeom {
  int Cin, Cout, H, W, R, RT, WT;  // strip rows; staged rows and columns
};

template <int K>
__global__ void __launch_bounds__(IG_NT, 2) convt_igemm_kernel(
    const __nv_bfloat16* __restrict__ in, const __nv_bfloat16* __restrict__ wt,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, CtGeom g) {
  using G = ConvtGeom<K>;
  constexpr int PA = G::PA, DMIN = G::DMIN, DMAX = G::DMAX, NR = G::NR;
  constexpr int XLO = DMIN & ~1;  // the first staged column pair
  extern __shared__ __align__(16) unsigned char ct_smem[];
  uint32_t* as = reinterpret_cast<uint32_t*>(ct_smem);
  uint32_t* ws = as + g.RT * g.WT * 8;

  const int cg = blockIdx.x, y0 = blockIdx.y * g.R, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, mat = lane >> 3;
  const int cgs = g.W / 16, row = warp / cgs, x0 = (warp % cgs) * 16;
  const long long chan = (long long)g.H * g.W;
  const int pairs = (g.W - 1 + DMAX - XLO) / 2 + 1;

  float acc[4][2][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][n][q] = 0.f;

  for (int c0 = 0; c0 < g.Cin; c0 += 16) {
    __syncthreads();
    // staged run t * WT + s: input row y0 + DMIN + t, column s + DMIN
    for (int e = threadIdx.x; e < g.RT * pairs; e += IG_NT) {
      const int t = e / pairs, x = XLO + 2 * (e % pairs), y = y0 + DMIN + t;
      uint32_t v[16];  // a unit's 16 loads in flight before its stores
      if (y >= 0 && y < g.H && x >= 0 && x < g.W) {
        const __nv_bfloat16* q = in + ((long long)b * g.Cin + c0) * chan + (long long)y * g.W + x;
#pragma unroll
        for (int c = 0; c < 16; ++c) v[c] = *reinterpret_cast<const uint32_t*>(q + c * chan);
      } else {
#pragma unroll
        for (int c = 0; c < 16; ++c) v[c] = 0u;
      }
      const int s = x - DMIN, L = t * g.WT + s;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (s >= 0) as[run_word(L, q)] = __byte_perm(v[2 * q], v[2 * q + 1], 0x5410);
        if (s + 1 < g.WT) as[run_word(L + 1, q)] = __byte_perm(v[2 * q], v[2 * q + 1], 0x7632);
      }
    }
    ig_stage_w(wt, ws, K * K, g.Cout, cg * CT_CO, CT_CO, g.Cin, c0);
    __syncthreads();
    float cacc[4][2][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) cacc[p][n][q] = 0.f;
#pragma unroll
    for (int sy = 0; sy < NR; ++sy)
#pragma unroll
      for (int sx = 0; sx < NR; ++sx) {
        // A: matrix m is fragment rows 8 (m % 2) .. (positions x0 + sx + ..
        // of staged row row + sy), channel half m / 2
        uint32_t a[4];
        ldmatrix_x4(a, as + run_word((row + sy) * g.WT + x0 + sx + 8 * (mat & 1) + (lane & 7),
                                     4 * (mat >> 1)));
#pragma unroll
        for (int pa = 0; pa < 2; ++pa)
#pragma unroll
          for (int pb = 0; pb < 2; ++pb) {
            const int i = 2 * (sy + DMIN) + PA - pa, j = 2 * (sx + DMIN) + PA - pb;
            if (i < 0 || i >= K || j < 0 || j >= K) continue;  // no tap of (pa, pb) here
            // B: matrix m is fragment m / 2, channel half m % 2; lane l reads
            // the run of output channel l % 8
            uint32_t r4[4];
            ldmatrix_x4(r4, ws + run_word((i * K + j) * CT_CO + (lane & 7) + 8 * (mat >> 1),
                                          4 * (mat & 1)));
            mma_bf16(cacc[pa * 2 + pb][0], a[0], a[1], a[2], a[3], r4[0], r4[1]);
            mma_bf16(cacc[pa * 2 + pb][1], a[0], a[1], a[2], a[3], r4[2], r4[3]);
          }
      }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][n][q] += cacc[p][n][q];
  }

  // acc[a * 2 + b][n][h * 2 + e]: output (2 (y0 + row) + a, 2 (x0 + gq + 8 h)
  // + b), channel 8 n + 2 tq + e; the pair b = 0, 1 is one 32-bit store
  __syncthreads();
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(ct_smem);
  const int gq = lane >> 2, tq = lane & 3, wo = 2 * g.W;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int co = 8 * n + 2 * tq + (q & 1), x = x0 + gq + 8 * (q >> 1);
      const float bv = bias[cg * CT_CO + co];
#pragma unroll
      for (int pa = 0; pa < 2; ++pa)
        *reinterpret_cast<__nv_bfloat162*>(os + co * CT_OCS + (2 * row + pa) * wo + 2 * x) =
            __floats2bfloat162_rn(fmaxf(acc[pa * 2][n][q] + bv, 0.f),
                                  fmaxf(acc[pa * 2 + 1][n][q] + bv, 0.f));
    }
  __syncthreads();
  const int runs = wo / 8, per = 2 * g.R * runs;  // 16-byte runs a row, a channel
  for (int e = threadIdx.x; e < CT_CO * per; e += IG_NT) {
    const int co = e / per, r = e % per;
    const uint4 v = *reinterpret_cast<const uint4*>(os + co * CT_OCS + r * 8);
    __nv_bfloat16* dst = out + (((long long)b * g.Cout + cg * CT_CO + co) * 2 * g.H + 2 * y0 +
                                r / runs) * wo + (r % runs) * 8;
    *reinterpret_cast<uint4*>(dst) = v;
  }
}

template <int K>
int launch_convt_igemm_k(const __nv_bfloat16* in, const __nv_bfloat16* wt, const float* bias,
                         __nv_bfloat16* out, int B, CtGeom g, cudaStream_t st) {
  g.RT = g.R + ConvtGeom<K>::NR - 1;
  g.WT = g.W + ConvtGeom<K>::NR - 1;
  const long long smem = max((long long)(g.RT * g.WT + K * K * CT_CO) * 32,
                             (long long)CT_CO * CT_OCS * 2);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = convt_igemm_kernel<K>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(g.Cout / CT_CO, g.H / g.R, B), IG_NT, smem, st>>>(in, wt, bias, out, g);
  return count_conv_launch(3);
}

// ---------------------------------------------------------------------------
// conv_out_mma_kernel: the out-conv of a bf16 launch (Cin -> 1 channel, 'same'
// K x K, stride 1) + bias, then an epilogue functor, on bf16
// mma.sync.m16n8k16: the serving S4 (ae_tile_out, CoSigmoidEpi in ae.cu) and
// the training loss (ae_train_loss[_pre], CoLossEpi in ae_train.cu).
// Replaces conv_quad_kernel + SigmoidEpi / LossEpi for bf16 (the float32
// launches stay there); the JAX kernels (K3's L5, K6's out-conv, K5's and
// K7's z5) sum the same taps as matmuls on the MXU, then K4 / K8-out
// restitch or K5 / K7 take the masked BCE and dz5.
//
// For output row y and tap row i the input row is y + i - r (r = K / 2), so
//   S[y, x', j] = sum_i sum_c in[c, y + i - r, x'] * w[c, i, j]
// is a GEMM for each output row over the input positions x' (M), the pairs
// (tap row i, input channel c) in 16-channel chunks (K) and the K taps j of a
// row padded to 8 (N: one n8 fragment for every K <= 7); then
//   out[y, x] = sigmoid(bias + sum_j S[y, x + j - r, j])
// each S term outside the tile's columns adding nothing.  A is the input read
// as staged: no column shift reaches the A fragments, the shifts move to the
// float32 gather of S.
//
// Block: 8 warps, one band of CO_BAND rows of one tile (blockIdx.x: band,
// blockIdx.y: tile), walked in strips of ROWS output rows.  Warp w holds
// columns 16 w .. 16 w + 15 of every row of the strip: ROWS x 4 float32 sums
// a thread, and as many for a chunk's fresh ones.  The band's input rows
// stream through a ring of NR = 2 r + (PF + 1) ROWS rows in shared memory,
// every input channel of a row, loaded once per band with cp.async in
// 16-byte runs (zeros outside the tile's rows): a strip reads its ROWS + 2 r
// rows from the ring while the rows of the next PF strips are in flight, and
// each strip loads only its ROWS new rows (its halo rows are in the ring
// already).  co_plan picks ROWS (8, 4 or 2) and PF (1 to 3): the most that
// keep two blocks an SM in shared memory.  A channel's ring plane is padded
// by 8 bf16, so the 8 channel rows of an ldmatrix tile fall in distinct
// banks.  An 8 x 8 tile of 8 channels x 8 positions is the transpose of an A
// fragment's quarter: ldmatrix.trans reads it, and one A fragment of staged
// row t serves every tap row i with an output row t - i in the strip.  The
// B fragments (w[c][i][j], j = the fragment's column, 0 for j >= K) are
// built once per block in shared memory from w (Cin, K, K, 1), one 8-byte
// load a lane, chunk and tap row.  A chunk's products (its K tap rows, 16 K
// a sum) accumulate in fresh fragments, added into the running sums chunk
// by chunk in order (as conv_igemm_kernel's chunks).
//
// A strip's gather: S goes to shared memory (K floats a position: a lane's
// pixel reads stride K, odd, conflict-free); a thread sums its pixels' taps
// j in ascending order and adds the bias: the logit z.  Then the epilogue,
// for each of the thread's pixels in turn (every lane of the block calls
// it: it may gather 4 lanes' pixels by shuffles), through the epilogue of
// the block's tile, t = epi.tile(b), taken once a block (its output rows'
// bases, the tile's mask):
//   t.pre(y, x)           what pixel (y, x) reads from device memory (the
//                         loss: its label, as stored), loaded at the
//                         strip's start so that the load's latency hides
//                         behind the MMAs
//   t.put(z, v, y, x, s)  writes pixel (y, x), v = t.pre(y, x); s: 2
//                         float32 running sums of the thread, kept across
//                         strips
//   t.end(s)              after the band's last strip (every thread)
// CoSigmoidEpi stores the sigmoid in 16-byte runs along each restitched row;
// CoLossEpi the logits and dz5 in 16- and 8-byte runs and, at the band's
// end, the block's two sums (masked BCE, dz5) as one partial row per (tile,
// band), in a fixed order.
//
// What bounds it: the input read once (1.26 GB a flagship shot of 32
// channels, 0.63 GB at deep3's 16) and the float32 output written once
// (78.6 MB): bytes.  The MMAs (2 x 8 x K x Cin FLOP a position: 30 GFLOP a
// flagship shot) are ~0.03 ms at the bf16 peak; a band's 2 r halo rows are
// read again by its neighbours, from L2.  The loss also reads the labels
// and writes float32 logits and bf16 dz5 (0.31 GB a flagship 128-tile
// step: 0.093 ms at 3.35 TB/s).
constexpr int CO_NT = 256;    // 8 warps
constexpr int CO_W = 128;     // tile width: 8 warps x 16 columns
constexpr int CO_BAND = 64;   // rows a block walks

struct CoGeom {
  int Cin, H, PF, NR;  // strips in flight ahead, ring rows
};

// Shared memory of a conv_out_mma_kernel block: the ring (Cin planes of NR
// rows, +8 bf16 each), a strip's S, the B fragments.
inline long long co_smem_bytes(int K, int Cin, int rows, int NR) {
  return (long long)Cin * (NR * CO_W + 8) * 2 + (long long)rows * CO_W * K * 4 +
         (long long)(Cin / 16) * K * 32 * 8;
}

// The strip rows and strips ahead of a launch: the largest ROWS of 8, 4, 2
// whose ring with one strip ahead keeps two blocks an SM (of its 228 KB, 1
// KB reserved a block), else the largest that fits one block (227 KB); then
// the most strips ahead (up to 3) that keep as many blocks an SM.  Returns
// false where nothing fits.  ops/ae_kernel.py conv_out_plan mirrors it.
inline bool co_plan(int K, int Cin, int& rows, int& pf) {
  const int r = K / 2;
  for (int per_sm = 2; per_sm >= 1; --per_sm) {
    const long long room = per_sm == 2 ? 228 * 1024 / 2 - 1024 : 227 * 1024;
    for (rows = 8; rows >= 2; rows /= 2) {
      if (co_smem_bytes(K, Cin, rows, 2 * r + 2 * rows) > room) continue;
      pf = 1;
      while (pf < 3 && co_smem_bytes(K, Cin, rows, 2 * r + (pf + 2) * rows) <= room) ++pf;
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Wait until at most n (1..3) committed groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

template <int K, int ROWS, class Epi>
__global__ void __launch_bounds__(CO_NT, 2) conv_out_mma_kernel(
    const __nv_bfloat16* __restrict__ in, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, Epi epi, CoGeom g) {
  constexpr int R = K / 2, RT = ROWS + 2 * R;
  constexpr int NP = ROWS * CO_W / CO_NT;  // output pixels a thread
  constexpr int NS = CO_BAND / ROWS;       // strips a band
  extern __shared__ __align__(16) unsigned char co_smem[];
  const int PS = g.NR * CO_W + 8;  // bf16 a channel's ring plane (+8: banks)
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(co_smem);
  float* sb = reinterpret_cast<float*>(ring + (long long)g.Cin * PS);  // (r * 128 + x) * K + j
  uint2* wf = reinterpret_cast<uint2*>(sb + ROWS * CO_W * K);         // (chunk, i, lane)

  const int nch = g.Cin / 16;
  const int b = blockIdx.y, yb = blockIdx.x * CO_BAND;
  const int tid = threadIdx.x, lane = tid & 31, x0 = 16 * (tid >> 5);
  const __nv_bfloat16* inb = in + (long long)b * g.Cin * g.H * CO_W;

  // input rows yb - R + q .. + n - 1 into ring rows (q ..) % NR, one group:
  // run e is channel e / (16 n), row (e / 16) % n, columns 8 (e % 16) ..;
  // consecutive threads on consecutive 16 bytes of a channel's rows
  auto load_rows = [&](int q, int n) {
#pragma unroll 1
    for (int e = tid; e < n * g.Cin * 16; e += CO_NT) {
      const int seg = e & 15, m = (e >> 4) % n, ch = (e >> 4) / n;
      const int y = yb - R + q + m, slot = (q + m) % g.NR;
      const bool ok = y >= 0 && y < g.H;
      cp_async16(ring + ch * PS + slot * CO_W + seg * 8,
                 inb + ((long long)ch * g.H + (ok ? y : 0)) * CO_W + seg * 8, ok);
    }
    cp_async_commit();
  };
  // strip s reads ring rows (s ROWS + t) % NR, t < RT; its own new rows are
  // t >= 2 R (strip 0: all RT); group s holds strip s's
  load_rows(0, RT);
  for (int s = 1; s <= g.PF; ++s) {
    if (s < NS) load_rows(s * ROWS + 2 * R, ROWS);
    else cp_async_commit();
  }
  // B fragments: lane (gq, tq) of chunk c, tap row i holds w[c0 + 2 tq (+1)]
  // and w[c0 + 2 tq + 8 (+9)] at tap (i, gq), the lower channel in the low half
  for (int e = tid; e < nch * K * 32; e += CO_NT) {
    const int ln = e & 31, i = (e >> 5) % K, c = (e >> 5) / K, j = ln >> 2;
    uint32_t lo = 0u, hi = 0u;
    if (j < K) {
      const unsigned short* p = reinterpret_cast<const unsigned short*>(w) +
                                (long long)(16 * c + 2 * (ln & 3)) * K * K + i * K + j;
      lo = p[0] | (uint32_t)p[K * K] << 16;
      hi = p[8 * K * K] | (uint32_t)p[9 * K * K] << 16;
    }
    wf[e] = make_uint2(lo, hi);
  }

  // A: matrix m is channels 8 (m / 2) .., positions x0 + 8 (m % 2) ..; lane l
  // gives the row of channel l % 8 of matrix l / 8
  const int arow = ((lane & 7) + 8 * (lane >> 4)) * PS + x0 + 8 * ((lane >> 3) & 1);
  const int gq = lane >> 2, tq = lane & 3, px = tid % CO_W;
  const float bv = bias[0];
  const auto et = epi.tile(b);
  float es[2] = {0.f, 0.f};  // the epilogue's running sums

#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    const int y0 = yb + s * ROWS;
    decltype(et.pre(0, 0)) pre[NP];  // what the epilogue reads, loaded before the MMAs
#pragma unroll
    for (int u = 0; u < NP; ++u) pre[u] = et.pre(y0 + tid / CO_W + 2 * u, px);
    cp_async_wait(g.PF);  // group s is in; the next PF strips' may not be
    __syncthreads();
    // acc[r]: S at output row r, positions x0 + gq and x0 + gq + 8, taps 2 tq
    // and 2 tq + 1
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    const int base = (s * ROWS) % g.NR;
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      uint32_t bq[K][2];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const uint2 v = wf[(c * K + i) * 32 + lane];
        bq[i][0] = v.x;
        bq[i][1] = v.y;
      }
      float cacc[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) cacc[r][q] = 0.f;
      const __nv_bfloat16* ap = ring + c * 16 * PS + arow;
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const int slot = base + t < g.NR ? base + t : base + t - g.NR;
        uint32_t a[4];
        ldmatrix_x4_trans(a, ap + slot * CO_W);
#pragma unroll
        for (int i = 0; i < K; ++i) {  // output row t - i, tap rows ascending
          const int r = t - i;
          if (r < 0 || r >= ROWS) continue;
          mma_bf16(cacc[r], a[0], a[1], a[2], a[3], bq[i][0], bq[i][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] += cacc[r][q];
    }
    __syncthreads();  // strip s's first ROWS ring rows are free: strip s + PF + 1's
    if (s + g.PF + 1 < NS) load_rows((s + g.PF + 1) * ROWS + 2 * R, ROWS);
    else cp_async_commit();

    // the gather: pixel u of a thread is (r, x) = (tid / 128 + 2 u, tid % 128)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 2 * tq + (q & 1);
        if (j < K) sb[(r * CO_W + x0 + gq + 8 * (q >> 1)) * K + j] = acc[r][q];
      }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int r = tid / CO_W + 2 * u;
      float z = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int xs = px + j - R;
        if (xs >= 0 && xs < CO_W) z += sb[(r * CO_W + xs) * K + j];
      }
      et.put(z + bv, pre[u], y0 + r, px, es);
    }
  }
  et.end(es);
}

template <int K, int ROWS, class Epi>
int launch_conv_out_kr(const __nv_bfloat16* in, const __nv_bfloat16* w, const float* bias,
                       Epi epi, int B, const CoGeom& g, cudaStream_t st) {
  const long long smem = co_smem_bytes(K, g.Cin, ROWS, g.NR);
  auto kern = conv_out_mma_kernel<K, ROWS, Epi>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(g.H / CO_BAND, B), CO_NT, smem, st>>>(in, w, bias, epi, g);
  return count_conv_launch(4);
}

template <int K, class Epi>
int launch_conv_out_k(const __nv_bfloat16* in, const __nv_bfloat16* w, const float* bias,
                      Epi epi, int B, CoGeom g, cudaStream_t st) {
  int rows, pf;
  if (!co_plan(K, g.Cin, rows, pf)) return cudaErrorInvalidValue;
  g.PF = pf;
  g.NR = 2 * (K / 2) + (pf + 1) * rows;
  switch (rows) {
    case 8:  // co_plan never takes 8 rows at k7 (16 channels: 4)
      if constexpr (K < 7) return launch_conv_out_kr<K, 8>(in, w, bias, epi, B, g, st);
      break;
    case 4: return launch_conv_out_kr<K, 4>(in, w, bias, epi, B, g, st);
    case 2: return launch_conv_out_kr<K, 2>(in, w, bias, epi, B, g, st);
  }
  return cudaErrorInvalidValue;
}

// The launch: in (B, Cin, H, 128) bf16 16-byte aligned, w (Cin, K, K, 1)
// bf16; K odd up to 7; Cin a multiple of 16 (co_plan: up to 64 at k7); H a
// multiple of CO_BAND.  The epilogue checks its own outputs.  Returns
// cudaErrorInvalidValue for anything else: the caller raises.
template <class Epi>
int launch_conv_out(const void* in, const void* w, const float* bias, Epi epi, int B, int Cin,
                    int H, int W, int K, cudaStream_t st) {
  if (W != CO_W || Cin < 16 || Cin % 16 != 0 || H < CO_BAND || H % CO_BAND != 0 || B < 1 ||
      B > 65535 || reinterpret_cast<uintptr_t>(in) % 16 != 0)
    return cudaErrorInvalidValue;
  const CoGeom g{Cin, H, 0, 0};
  const auto* i = static_cast<const __nv_bfloat16*>(in);
  const auto* wt = static_cast<const __nv_bfloat16*>(w);
  SX_K_SWITCH(K, return launch_conv_out_k<KK>(i, wt, bias, epi, B, g, st));
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// conv_in_mma_kernel: the 'same' K x K stride-1 convolution of a bf16 launch
// from ONE input channel to Cout (16, 32, 48 or 64) channels, on bf16
// mma.sync.m16n8k16 (bf16 in, float32 out):
//   D[p, co] = sum_kappa A[p, kappa] * W[kappa, co]
// over the output positions p of a strip of R rows of one 128-wide tile (M),
// the output channels in 8-channel fragments (N) and the taps (K).  The
// taps go into K as pairs of horizontal neighbours (i, j), (i, j + 1), j
// even, so that the two values of an A register are one 32-bit word of the
// staged input: tap row i's K taps make (K + 1) / 2 pairs, the last one half
// a pair (its second tap masked to 0), K (K + 1) / 2 pairs in all: 16, 16,
// 32 and 64 kappa slots (the GEMM's K) for k1, k3, k5 and k7, the slots past
// the last pair zero in A and in W.  Replaces conv_quad_kernel for the bf16
// launches that read one channel: the serving S1 (ae_tile_in,
// ae_tile_in_norm: the JAX kernels K3 and K6 run conv1 on the MXU after the
// tile turns K2 / K8-in / K9 / K10), the training conv 0 (ae_train_in[_pre]:
// K5, K5b and K7's conv1 with its pool and routing mask) and the out-conv's
// input gradient (ae_train_dgrad_conv, K5 and K7).
//
// Block: 8 warps, one tile (blockIdx.y), one strip of R rows (blockIdx.x;
// Epi::rows).  A warp takes a pair of fragments at a time: a row pair y, y +
// 1 and 16 columns from x0, fragment m's row q < 8 at (y, x0 + 2 q + m) and
// row q + 8 at (y + 1, x0 + 2 q + m).  So a thread holds a whole 2x2 pool
// window across its two fragments (pooled in registers, no shuffle) and
// horizontal neighbours for 32-bit stage accesses.  Warp w takes pairs w, w
// + 8, .. of the strip's R / 2 x 8.
//
// Staging: the strip's input rows y0 - r .. y0 + R - 1 + r (r = K / 2) and
// columns -CI_XO .. 131, zeros outside the tile, rounded to bf16 by the
// source functor (the float32 spectrogram, the raw log-PSD normalized as
// NormPlaneSrc normalizes it, or a bf16 plane), two columns an element,
// read along the source's contiguous axis, all of a thread's loads in
// flight before its first store.  It is held twice: the even copy, word w =
// staged columns (2w, 2w + 1), and the odd copy, word w = (2w + 1, 2w + 2),
// built from the even one; a pair starting at column x is one aligned word
// of one of them.  The columns of a pair's first tap have the parity of r
// in fragment 0 and the other in fragment 1, so each fragment reads one
// copy and fragment 1's words are fragment 0's plus a constant.  A lane's
// pairs (its row and word offsets, and the mask of a half or missing pair)
// are fixed for the whole block and computed once.  Rows of CI_RS = 76
// words put the 32 words of every A load in 32 banks, for every K.  The
// weights' B fragments (at most 64 kappa x 64 channels) are built once a
// block in shared memory from w (1, K, K, Cout).  The GEMM's chain is at
// most 64 products: accumulated in one fragment.
//
// Epilogue (Epi::put, right after each fragment pair's MMAs): the block's
// output goes through a stage in shared memory and out in 16-byte runs
// along each NCHW row (Epi::end): the output is ~80 % of S1's bytes (315 of
// 393 MB a flagship shot) and all of the input gradient's but dz.  Conv 0's
// routing bytes leave the same way, through their own part of the stage.
//
// What bounds it: the input read once and the output written once (S1:
// 0.117 ms a flagship shot at 3.35 TB/s; the out-conv's gradient, which
// also reads its gate, 0.163 ms a 128-tile step): bytes.  The MMAs, padded
// taps included, are 20 GFLOP a flagship shot (0.02 ms at the bf16 peak);
// the instructions that stage, assemble A and pool come closer (a first
// design, one fragment at a time with a shuffle to pool, ran S1 at 2x its
// bound at 16 and at 32 channels alike).
constexpr int CI_NT = 256;   // 8 warps
constexpr int CI_W = 128;    // tile width
constexpr int CI_XO = 4;     // staged column of input column 0
constexpr int CI_EW = 68;    // words of the even copy a row: staged columns 0 .. 135
constexpr int CI_OW = 67;    // words of the odd copy a row
constexpr int CI_RS = 76;    // words a staged row takes in each copy

template <int K>
struct CiTaps {
  static constexpr int NPR = (K + 1) / 2;          // pairs a tap row
  static constexpr int NP = K * NPR;               // pairs
  static constexpr int KC = (2 * NP + 15) / 16;    // 16-slot chunks of the GEMM's K
};

// Shared memory of a conv_in_mma_kernel block: the two copies of RT rows,
// the B fragments, the epilogue's stage.  ops/ae_kernel.py _conv_in_smem
// mirrors it.
__host__ __device__ constexpr long long ci_smem_bytes(int K, int NF, int R, int stage_words) {
  return (long long)2 * (R + 2 * (K / 2)) * CI_RS * 4 +
         (long long)((K * (K + 1) + 15) / 16) * NF * 32 * 8 + (long long)stage_words * 4;
}

// Stage the window of a strip: word (t, w) of the even copy (input row ylo +
// t, columns x = 2 w - CI_XO and x + 1) is val(load(y, x)) rounded to bf16
// inside the tile and 0 outside (x even: both columns lie on the same
// side).  Consecutive threads take consecutive words (along_x) or rows;
// all loads are issued before the first val (a division's slow path would
// otherwise hold each load until the one before has been divided).
template <int RT, class Load, class Val>
__device__ __forceinline__ void ci_stage(uint32_t* st, int ylo, int H, bool along_x, Load load,
                                         Val val) {
  constexpr int TOTAL = RT * CI_EW, PER = (TOTAL + CI_NT - 1) / CI_NT;
  float2 v[PER];
  unsigned in = 0;  // bit u: v[u] was loaded
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * CI_NT;
    const int t = along_x ? e / CI_EW : e % RT, w = along_x ? e % CI_EW : e / RT;
    const int y = ylo + t, x = 2 * w - CI_XO;
    v[u] = make_float2(0.f, 0.f);
    if (e < TOTAL && y >= 0 && y < H && x >= 0 && x < CI_W) {
      v[u] = load(y, x);
      in |= 1u << u;
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * CI_NT;
    if (e >= TOTAL) continue;
    const int t = along_x ? e / CI_EW : e % RT, w = along_x ? e % CI_EW : e / RT;
    uint32_t word = 0u;
    if ((in >> u) & 1) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(val(v[u].x), val(v[u].y));
      word = *reinterpret_cast<const uint32_t*>(&h);
    }
    st[t * CI_RS + w] = word;
  }
}

// Source: a float32 plane of tiles, tile b = (b / kt, b % kt) at p + (b /
// kt) * outer + (b % kt) * 128 * ts, value (y, x) at y * fs + x * ts: the
// spectrograms of ae_tile_in (ts = 1), or, with mn and mx, the raw log-PSD
// of ae_tile_in_norm in the (F, T) (ts = 1) or (T, F) (fs = 1) layout,
// each value (v - mn[c]) / (mx[c] - mn[c]) with an IEEE division (no
// reciprocal), as NormPlaneSrc: the bits ae_tile_in stages from the
// normalized spectrogram.  Read along its contiguous axis.
struct CiSpecSrc {
  const float* p;
  const float* mn;  // null: no normalization
  const float* mx;
  long long outer, fs, ts;
  int kt;
  template <int RT>
  __device__ __forceinline__ void stage(uint32_t* st, int b, int ylo, int H) const {
    const int c = b / kt;
    const float* q = p + c * outer + (long long)(b % kt) * CI_W * ts;
    const long long f = fs, t = ts;
    const float lo = mn ? mn[c] : 0.f, span = mn ? mx[c] - lo : 1.f;
    const bool norm = mn != nullptr;
    ci_stage<RT>(st, ylo, H, ts == 1,
                 [=](int y, int x) {
                   const float* r = q + y * f + x * t;
                   return make_float2(r[0], r[t]);
                 },
                 [=](float v) { return norm ? __fdiv_rn(v - lo, span) : v; });
  }
};

// Source: a bf16 plane (B, 1, H, 128), 4-byte aligned, a column pair one
// 32-bit load: the out-conv's dz, or K5b's tiles (the bits CiSpecSrc stages
// from the float32 tiles).
struct CiBf16Src {
  const __nv_bfloat16* p;
  template <int RT>
  __device__ __forceinline__ void stage(uint32_t* st, int b, int ylo, int H) const {
    const __nv_bfloat16* q = p + (long long)b * H * CI_W;
    ci_stage<RT>(st, ylo, H, true,
                 [=](int y, int x) {
                   return __bfloat1622float2(
                       *reinterpret_cast<const __nv_bfloat162*>(q + y * CI_W + x));
                 },
                 [](float v) { return v; });
  }
};

// Epilogue: bias + relu + 2x2 max pool, the window being the thread's four
// positions in its fragment pair; out (B, Cout, H/2, 64) bf16 through the
// stage: channel c's pooled row yp at word c * CS + yp * 32, CS = R / 2 * 32
// + 4, so that a put's 4 channels x 8 columns fall in 16 banks; then 16-byte
// runs along each row.  The serving S1.
struct CiPoolEpi {
  __nv_bfloat16* out;
  template <int NF>
  __host__ __device__ static constexpr int rows() { return NF > 4 ? 8 : 16; }
  template <int NF>
  __host__ __device__ static constexpr int cs() { return rows<NF>() / 2 * 32 + 4; }
  template <int NF>
  __host__ __device__ static constexpr int stage_words() { return 8 * NF * cs<NF>(); }
  template <int NF>
  __device__ __forceinline__ void begin(uint32_t*, int, int, int) const {}
  template <int NF>
  __device__ __forceinline__ void put(const float (&acc)[2][NF][4], uint32_t* os,
                                      const float (&bv)[NF][2], int yy, int x0,
                                      float (&)[NF][2]) const {
    const int lane = threadIdx.x & 31, tq = lane & 3;
    unsigned short* o = reinterpret_cast<unsigned short*>(os) + yy / 2 * 64 + x0 / 2 + (lane >> 2);
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // max(z_q + bias) == max(z_q) + bias, and relu commutes with max
        const float z = fmaxf(fmaxf(acc[0][n][e], acc[0][n][2 + e]),
                              fmaxf(acc[1][n][e], acc[1][n][2 + e])) + bv[n][e];
        o[2 * (8 * n + 2 * tq + e) * cs<NF>()] =
            __bfloat16_as_ushort(__float2bfloat16_rn(fmaxf(z, 0.f)));
      }
  }
  template <int NF>
  __device__ __forceinline__ void end(const uint32_t* os, int b, int y0, int H,
                                      float (&)[NF][2]) const {
    constexpr int PER = rows<NF>() / 2 * 8, COUT = 8 * NF;  // 16-byte runs a channel
    __nv_bfloat16* ob = out + ((long long)b * COUT * (H / 2) + y0 / 2) * 64;
    for (int e = threadIdx.x; e < COUT * PER; e += CI_NT) {
      const int co = e / PER, q = e % PER;
      *reinterpret_cast<uint4*>(ob + (long long)co * (H / 2) * 64 + 8 * q) =
          *reinterpret_cast<const uint4*>(os + co * cs<NF>() + 4 * q);
    }
  }
};

// Epilogue of the training conv 0: CiPoolEpi's pooled output, and the
// routing byte of each pooled value, bit a * 2 + b (pixel (2m + a, 2n + b):
// row y + h, column x0 + 2 (lane / 4) + m of fragment m, so a = h, b = m)
// set where that pixel's float32 relu value equals the window's max and the
// max is > 0, as PoolMaskEpi sets it.  The bytes go through their own part
// of the stage after the pooled values (channel c's pooled row yp at byte 4
// c BS + 64 yp, BS = R / 2 * 16 + 4 words: a put's 4 channels fall 8 banks
// apart) and out in 16-byte runs along each row of bits (B, Cout, H/2, 64).
struct CiPoolMaskEpi {
  __nv_bfloat16* out;
  uint8_t* bits;
  template <int NF>
  __host__ __device__ static constexpr int rows() { return CiPoolEpi::rows<NF>(); }
  template <int NF>
  __host__ __device__ static constexpr int bs() { return rows<NF>() / 2 * 16 + 4; }
  template <int NF>
  __host__ __device__ static constexpr int stage_words() {
    return CiPoolEpi::stage_words<NF>() + 8 * NF * bs<NF>();
  }
  template <int NF>
  __device__ __forceinline__ void begin(uint32_t*, int, int, int) const {}
  template <int NF>
  __device__ __forceinline__ void put(const float (&acc)[2][NF][4], uint32_t* os,
                                      const float (&bv)[NF][2], int yy, int x0,
                                      float (&)[NF][2]) const {
    const int lane = threadIdx.x & 31, tq = lane & 3;
    const int at = yy / 2 * 64 + x0 / 2 + (lane >> 2);
    unsigned short* o = reinterpret_cast<unsigned short*>(os) + at;
    uint8_t* ob = reinterpret_cast<uint8_t*>(os + CiPoolEpi::stage_words<NF>()) + at;
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // z[2 h + m] before the relu: where the max zm is > 0, relu(z[q])
        // equals the pooled relu(zm) exactly where z[q] == zm
        float z[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) z[q] = acc[q & 1][n][(q >> 1) * 2 + e] + bv[n][e];
        const float zm = fmaxf(fmaxf(z[0], z[1]), fmaxf(z[2], z[3]));
        unsigned k = 0;
        if (zm > 0.f) {
#pragma unroll
          for (int q = 0; q < 4; ++q) k |= z[q] == zm ? 1u << q : 0u;
        }
        const int c = 8 * n + 2 * tq + e;
        o[2 * c * CiPoolEpi::cs<NF>()] =
            __bfloat16_as_ushort(__float2bfloat16_rn(fmaxf(zm, 0.f)));
        ob[4 * c * bs<NF>()] = (uint8_t)k;
      }
  }
  template <int NF>
  __device__ __forceinline__ void end(const uint32_t* os, int b, int y0, int H,
                                      float (&db)[NF][2]) const {
    CiPoolEpi{out}.end<NF>(os, b, y0, H, db);
    constexpr int PER = rows<NF>() / 2 * 4, COUT = 8 * NF;  // 16-byte runs a channel
    const uint8_t* sb = reinterpret_cast<const uint8_t*>(os + CiPoolEpi::stage_words<NF>());
    uint8_t* bb = bits + ((long long)b * COUT * (H / 2) + y0 / 2) * 64;
    for (int e = threadIdx.x; e < COUT * PER; e += CI_NT) {
      const int co = e / PER, q = e % PER;
      *reinterpret_cast<uint4*>(bb + (long long)co * (H / 2) * 64 + 16 * q) =
          *reinterpret_cast<const uint4*>(sb + 4 * co * bs<NF>() + 16 * q);
    }
  }
};

// W[kappa][co] of w (1, K, K, Cout) for GEMM slot kappa (pair kappa / 2,
// its tap kappa % 2), 0 past the last pair and for a half pair's second
// tap; two slots kappa, kappa + 1 in one word, kappa in the low half.
template <int K>
__device__ __forceinline__ uint32_t ci_w_pair(const __nv_bfloat16* w, int kappa, int co,
                                              int Cout) {
  uint32_t out = 0u;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int p = (kappa + e) / 2, j = 2 * (p % CiTaps<K>::NPR) + (kappa + e) % 2;
    if (p < CiTaps<K>::NP && j < K)
      out |= (uint32_t)__bfloat16_as_ushort(w[((p / CiTaps<K>::NPR) * K + j) * Cout + co])
             << (16 * e);
  }
  return out;
}

// acc[m][n][h * 2 + e] of a fragment pair is position (y + h, x0 + 2 (lane
// / 4) + m), channel 8 n + 2 (lane % 4) + e; bv[n][e] that channel's bias
// (0 without one).  epi.put writes each pair into the stage, epi.end the
// stage out (after the block's last put; every thread reaches both).  db:
// the epilogue's per-thread sums.
template <int K, int NF, class Src, class Epi>
__global__ void __launch_bounds__(CI_NT, NF > 4 ? 2 : 3) conv_in_mma_kernel(
    Src src, const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias, Epi epi,
    int H) {
  using T = CiTaps<K>;
  constexpr int R = Epi::template rows<NF>(), r = K / 2, RT = R + 2 * r, KC = T::KC;
  constexpr int OB = RT * CI_RS, COUT = 8 * NF;
  // fragment 1's word of a pair: the other copy, one word on from the odd one
  constexpr int D1 = r & 1 ? 1 - OB : OB;
  extern __shared__ __align__(16) unsigned char ci_smem[];
  uint32_t* as = reinterpret_cast<uint32_t*>(ci_smem);
  uint2* wf = reinterpret_cast<uint2*>(as + 2 * OB);             // (chunk, n, lane)
  uint32_t* os = reinterpret_cast<uint32_t*>(wf + KC * NF * 32);  // the epilogue's stage

  const int b = blockIdx.y, y0 = blockIdx.x * R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;

  epi.template begin<NF>(os, b, y0, H);
  src.template stage<RT>(as, b, y0 - r, H);
  // B fragments: lane (gq, tq) of chunk c, fragment n holds slots 16 c + 2 tq
  // (+1) and 16 c + 2 tq + 8 (+9) of channel 8 n + gq
  for (int e = tid; e < KC * NF * 32; e += CI_NT) {
    const int ln = e & 31, n = (e >> 5) % NF, c = (e >> 5) / NF;
    const int co = 8 * n + (ln >> 2), k0 = 16 * c + 2 * (ln & 3);
    wf[e] = make_uint2(ci_w_pair<K>(w, k0, co, COUT), ci_w_pair<K>(w, k0 + 8, co, COUT));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // an epilogue's prefetch
  __syncthreads();
  for (int e = tid; e < RT * CI_OW; e += CI_NT) {
    const int t = e / CI_OW, q = e % CI_OW;
    as[OB + t * CI_RS + q] = __funnelshift_r(as[t * CI_RS + q], as[t * CI_RS + q + 1], 16);
  }
  __syncthreads();

  // the lane's A words in fragment 0: register h of chunk c is pair 8 c + 4
  // h + tq at column x0 + 2 gq of the pair's row pair; a missing pair reads
  // the word of pair 8 c + 4 h (or 0) and masks it to 0
  int off[KC][2];
  uint32_t msk[KC][2];
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 8 * c + 4 * h + tq;
      const int q = p < T::NP ? p : (8 * c + 4 * h < T::NP ? 8 * c + 4 * h : 0);
      const int i = q / T::NPR, j = 2 * (q % T::NPR);
      off[c][h] = (r & 1 ? OB : 0) + i * CI_RS + gq + ((j - r + CI_XO) >> 1);
      msk[c][h] = p >= T::NP ? 0u : j + 1 < K ? 0xffffffffu : 0x0000ffffu;
    }
  float bv[NF][2];
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[n][e] = bias ? bias[8 * n + 2 * tq + e] : 0.f;

  float db[NF][2];
#pragma unroll
  for (int n = 0; n < NF; ++n) db[n][0] = db[n][1] = 0.f;
#pragma unroll 1
  for (int g = warp; g < 4 * R; g += CI_NT / 32) {
    const int yy = 2 * (g >> 3), x0 = 16 * (g & 7);  // row pair g / 8, columns x0 ..
    const uint32_t* pa = as + yy * CI_RS + x0 / 2;
    float acc[2][NF][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t bq[NF][2];
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        const uint2 v = wf[(c * NF + n) * 32 + lane];
        bq[n][0] = v.x;
        bq[n][1] = v.y;
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t* p0 = pa + off[c][0] + m * D1;
        const uint32_t* p1 = pa + off[c][1] + m * D1;
        const uint32_t a0 = p0[0] & msk[c][0], a1 = p0[CI_RS] & msk[c][0];
        const uint32_t a2 = p1[0] & msk[c][1], a3 = p1[CI_RS] & msk[c][1];
#pragma unroll
        for (int n = 0; n < NF; ++n) mma_bf16(acc[m][n], a0, a1, a2, a3, bq[n][0], bq[n][1]);
      }
    }
    epi.template put<NF>(acc, os, bv, yy, x0, db);
  }
  __syncthreads();
  epi.template end<NF>(os, b, y0, H, db);
}

template <int K, int NF, class Src, class Epi>
int launch_conv_in_knf(Src src, const __nv_bfloat16* w, const float* bias, Epi epi, int B,
                       int H, cudaStream_t st) {
  constexpr int R = Epi::template rows<NF>();
  constexpr long long smem = ci_smem_bytes(K, NF, R, Epi::template stage_words<NF>());
  static_assert(smem <= 227 * 1024 - 2048, "conv_in_mma_kernel: shared memory");
  if (H % R != 0) return cudaErrorInvalidValue;
  auto kern = conv_in_mma_kernel<K, NF, Src, Epi>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(H / R, B), CI_NT, smem, st>>>(src, w, bias, epi, H);
  return count_conv_launch(5);
}

template <int K, class Src, class Epi>
int launch_conv_in_k(Src src, const __nv_bfloat16* w, const float* bias, Epi epi, int B,
                     int Cout, int H, cudaStream_t st) {
  switch (Cout / 8) {
    case 2: return launch_conv_in_knf<K, 2>(src, w, bias, epi, B, H, st);
    case 4: return launch_conv_in_knf<K, 4>(src, w, bias, epi, B, H, st);
    case 6: return launch_conv_in_knf<K, 6>(src, w, bias, epi, B, H, st);
    case 8: return launch_conv_in_knf<K, 8>(src, w, bias, epi, B, H, st);
  }
  return cudaErrorInvalidValue;
}

// The launch: one input channel, W = 128, K odd up to 7, Cout 16, 32, 48 or
// 64, H a multiple of the epilogue's strip rows; w (1, K, K, Cout) bf16.
// Returns cudaErrorInvalidValue for anything else: the caller raises.
template <class Src, class Epi>
int launch_conv_in(Src src, const void* w, const float* bias, Epi epi, int B, int Cout, int H,
                   int W, int K, cudaStream_t st) {
  if (W != CI_W || Cout < 16 || Cout > 64 || Cout % 16 != 0 || H < 2 || B < 1 ||
      B > 65535 || reinterpret_cast<uintptr_t>(w) % 2 != 0)
    return cudaErrorInvalidValue;
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  SX_K_SWITCH(K, return launch_conv_in_k<KK>(src, wb, bias, epi, B, Cout, H, st));
  return cudaErrorInvalidValue;
}

// Sum v[0..N) over the block's NTH threads (conv_quad_kernel's NT, or
// conv_out_mma_kernel's CO_NT) and write the N sums to out[0..N) (thread
// 0..N-1 each write one).  Fixed order: a warp shuffle tree, then the warps
// in order.  Every thread of the block must call it.
template <int N, int NTH = NT>
__device__ __forceinline__ void block_sums(float (&v)[N], float* out) {
  __shared__ float red[NTH / 32][N];
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
    for (int w = 0; w < NTH / 32; ++w) s += red[w][threadIdx.x];
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

// The launches of the six conv templates in this library so far, in
// sx_conv_launches' order.
extern "C" void specenh_conv_launches(long long* out) {
  for (int i = 0; i < SX_TEMPLATES; ++i) out[i] = sx_conv_launches[i];
}
