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
//             ae_train_sum          partials -> sums, in a fixed order: a
//                                   step's every array in one call
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
// 0.9 ms at 3.35 TB/s.  So the step is bound by bytes.  That every float32
// stage runs its FMAs on the CUDA cores (67 TFLOP/s fp32) is a choice of
// the design, not the bound.
// The deep3 preset
// (16/32/64, k5) does ~0.5 G MAC per tile forward and twice that backward:
// ~379 GFLOP per 128-tile step, 0.38 ms at the bf16 peak, about as long as
// its ~1 GB of stored activations and gradients take at 3.35 TB/s.
//
// Design: the forward and stride-1 input-gradient stages reuse the serving
// stages' conv templates (ae_conv.cuh) with new epilogues, in bf16 all on
// the tensor cores: the multi-channel ones (ae_train_conv_pool, the encoder
// convs' ae_train_dgrad_conv) the implicit GEMM conv_igemm_kernel; the
// convs from one input channel (conv 0, ae_train_in[_pre], with
// CiPoolMaskEpi; the out-conv's input gradient, one dz channel, with
// CiGateEpi) conv_in_mma_kernel, whose GEMM K is the taps; the out-conv
// (the loss, ae_train_loss[_pre], with CoLossEpi) conv_out_mma_kernel, one
// GEMM an output row.  Every float32 launch runs conv_quad_kernel.
// The weight gradient
// (wgrad_kernel) and the transposed convs' input gradient
// (convt_dgrad_kernel) are implicit GEMMs over strips of a tile staged
// once per block for all taps, on the bf16 tensor cores (mma.sync) or, in
// float32, on the CUDA cores.

#include <type_traits>

#include "ae_conv.cuh"

namespace {

// The float32 encoder convs: bias + relu + 2x2 max pool, plus the routing
// bits of the window: bit q (q = a * 2 + b for pixel (2m+a, 2n+b)) where
// that pixel's float32 relu value equals the max and the max is > 0.
struct PoolMaskEpi {
  float* out;
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
      out[o] = p;
      bits[o] = (uint8_t)k;
    }
  }
};

// The float32 loss: the out-conv's logits z, the labels y, the tile mask:
// dz5 = (sigmoid(z) - y) * mask, and per block the sums of the masked BCE
// (from z) and of dz5.
struct LossEpi {
  const float* y;
  const float* tmask;
  float* logits;
  float* dz;
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
        const float yv = y[o];
        const float d = (1.f / (1.f + expf(-z)) - yv) * mk;
        logits[o] = z;
        dz[o] = d;
        s[0] += (fmaxf(z, 0.f) - z * yv + log1pf(expf(-fabsf(z)))) * mk;
        s[1] += d;
      }
    }
    block_sums<2>(s, part + ((long long)b * gridDim.x + blockIdx.x) * 2);
  }
};

// The loss on the tensor cores (conv_out_mma_kernel): LossEpi for logit z
// at pixel (y, x) of tile b, the labels read at the strip's start (pre),
// rounded to bf16 as LossEpi rounds them (TY: float32 for K5, bf16 for K5b:
// the same bits).  The logits
// (float32) and dz5 (bf16) leave in 16- and 8-byte runs, 4 lanes' pixels
// gathered by shuffles; the thread's running sums s of the masked BCE and
// of the float32 dz5 take its pixels in a fixed order (strips, then its
// pixels in a strip), and at the band's end the block sums them in a fixed
// order (block_sums) into one partial row per (tile, band): rows = B * H /
// CO_BAND.
template <typename TY>
struct CoLossEpi {
  const TY* y;
  const float* tmask;
  float* logits;
  __nv_bfloat16* dz;
  float* part;
  int H;
  struct Tile {  // tile b's planes, its partial row and its mask
    const TY* y;
    float* logits;
    __nv_bfloat16* dz;
    float* part;
    float mk;
    __device__ __forceinline__ TY pre(int yy, int x) const { return y[yy * CO_W + x]; }
    __device__ __forceinline__ void put(float z, TY label, int yy, int x, float (&s)[2]) const {
      const int o = yy * CO_W + x;
      const float yv = sx_round<__nv_bfloat16>(sx_load(&label));
      const float d = (1.f / (1.f + expf(-z)) - yv) * mk;
      s[0] += (fmaxf(z, 0.f) - z * yv + log1pf(expf(-fabsf(z)))) * mk;
      s[1] += d;
      const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(d));
      const float z1 = __shfl_down_sync(0xffffffffu, z, 1);
      const float z2 = __shfl_down_sync(0xffffffffu, z, 2);
      const float z3 = __shfl_down_sync(0xffffffffu, z, 3);
      const unsigned h1 = __shfl_down_sync(0xffffffffu, h, 1);
      const unsigned h2 = __shfl_down_sync(0xffffffffu, h, 2);
      const unsigned h3 = __shfl_down_sync(0xffffffffu, h, 3);
      if ((threadIdx.x & 3) == 0) {
        *reinterpret_cast<float4*>(logits + o) = make_float4(z, z1, z2, z3);
        *reinterpret_cast<uint2*>(dz + o) = make_uint2(h | h1 << 16, h2 | h3 << 16);
      }
    }
    __device__ __forceinline__ void end(float (&s)[2]) const { block_sums<2, CO_NT>(s, part); }
  };
  __device__ __forceinline__ Tile tile(int b) const {
    const long long o = (long long)b * H * CO_W;
    return Tile{y + o, logits + o, dz + o, part + ((long long)b * gridDim.x + blockIdx.x) * 2,
                tmask[b]};
  }
};

// Input gradient of a stride-1 'same' conv in float32, computed by
// conv_quad_kernel as a conv of dz with the flipped, transposed weights;
// gated per pixel, with the bias-gradient partials of the COB channels.
template <int MODE>
struct GateQuadEpi {
  GateOut<float, MODE> g;  // (B, Cout, H, W)
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

// ae_train_conv_pool on the tensor cores (conv_igemm_kernel): PoolMaskEpi's
// bias + relu + pool and routing bits, the window being the thread's two
// positions (bit 2 f + h: row y + f, column x + h) in its two fragments.
struct IgPoolMaskEpi {
  __nv_bfloat16* out;
  uint8_t* bits;
  int Cout, h2, w2;
  template <int NW>
  __device__ __forceinline__ void operator()(float (&acc)[2][NW][4], const float* bias,
                                             int b, int y, int x0, int co0) const {
    const int lane = threadIdx.x & 31, tq = lane & 3;
    const long long pix = (long long)(y >> 1) * w2 + (x0 >> 1) + (lane >> 2);
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co0 + 8 * n + 2 * tq + e;
        const float bv = bias[co];
        float r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) r[q] = fmaxf(acc[q >> 1][n][(q & 1) * 2 + e] + bv, 0.f);
        const float p = fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3]));
        unsigned k = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) k |= (p > 0.f && r[q] == p) ? (1u << q) : 0u;
        const long long o = ((long long)b * Cout + co) * h2 * w2 + pix;
        out[o] = __float2bfloat16_rn(p);
        bits[o] = (uint8_t)k;
      }
  }
};

// The encoder convs' routed input gradient on the tensor cores: GateQuadEpi
// through GateOut, and the bias-gradient partials of the Cout channels, one
// row per (tile, strip): each thread sums its gated values in a fixed
// order, then the 8 lanes of a channel by a fixed shuffle tree, then the
// warps of the channel's group in order.
template <int MODE>
struct IgGateEpi {
  GateOut<__nv_bfloat16, MODE> g;  // (B, Cout, H, W)
  float* part;
  int Cout, H, W;
  template <int NW>
  __device__ __forceinline__ void operator()(float (&acc)[2][NW][4], const float*, int b,
                                             int y, int x0, int co0) const {
    __shared__ float red[IG_WARPS][32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
    const int x = x0 + 2 * (lane >> 2);
    float db[NW][2];
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co0 + 8 * n + 2 * tq + e;
        float s = 0.f;
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const long long o = (((long long)b * Cout + co) * H + y + f) * W + x;
          s += g.put(o, acc[f][n][e]);
          s += g.put(o + 1, acc[f][n][2 + e]);
        }
        db[n][e] = s;
      }
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = db[n][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane < 4) red[warp][8 * n + 2 * tq + e] = s;
      }
    __syncthreads();
    if (threadIdx.x < Cout) {
      const int per = Cout > 32 ? Cout / 2 : Cout;  // channels of a group of warps
      const int pw = Cout > 32 ? IG_WARPS / 2 : IG_WARPS;
      const int grp = threadIdx.x / per, c = threadIdx.x % per;
      float s = 0.f;
      for (int w = 0; w < pw; ++w) s += red[grp * pw + w][c];
      part[((long long)b * gridDim.x + blockIdx.x) * Cout + threadIdx.x] = s;
    }
  }
};

// The out-conv's input gradient on the tensor cores (conv_in_mma_kernel):
// GateOut<bf16, GATE_RELU>'s gate against the layer input e (B, Cout, H,
// 128), read into the stage with cp.async in 16-byte runs when the block
// starts (channel c's row yy at word c * CS + yy * 64, CS = R * 64 + 4: a
// put's 4 channels x 8 column pairs fall in 32 banks); each thread gates
// its values there, a column pair a word, and writes them back in place,
// then the stage goes out in 16-byte runs along each row.  The bias-gradient partials, one row per
// (tile, strip): each thread sums its gated values in a fixed order, then
// the 8 lanes of a channel by a fixed shuffle tree, then the warps in
// order.  Strips of R = 8, 4, 2 rows for 16, 32, 48-64 channels keep the
// stage <= 33 KB (ops/ae_train_kernel.py conv_in_rows).
struct CiGateEpi {
  __nv_bfloat16* out;
  const __nv_bfloat16* gate;
  float* part;
  __host__ __device__ static constexpr int rows_of(int Cout) {
    return Cout <= 16 ? 8 : Cout <= 32 ? 4 : 2;
  }
  template <int NF>
  __host__ __device__ static constexpr int rows() { return rows_of(8 * NF); }
  template <int NF>
  __host__ __device__ static constexpr int cs() { return rows<NF>() * 64 + 4; }
  template <int NF>
  __host__ __device__ static constexpr int stage_words() { return 8 * NF * cs<NF>(); }
  template <int NF>
  __device__ __forceinline__ void begin(uint32_t* os, int b, int y0, int H) const {
    constexpr int PER = rows<NF>() * 16, COUT = 8 * NF;  // 16-byte runs a channel
    const __nv_bfloat16* gb = gate + ((long long)b * COUT * H + y0) * CI_W;
    for (int e = threadIdx.x; e < COUT * PER; e += CI_NT) {
      const int co = e / PER, q = e % PER;
      cp_async16(os + co * cs<NF>() + 4 * q, gb + (long long)co * H * CI_W + 8 * q, true);
    }
    cp_async_commit();
  }
  template <int NF>
  __device__ __forceinline__ void put(const float (&acc)[2][NF][4], uint32_t* os,
                                      const float (&)[NF][2], int yy, int x0,
                                      float (&db)[NF][2]) const {
    const int lane = threadIdx.x & 31, tq = lane & 3;
    // the thread's column pair x0 + 2 (lane / 4) + m, m = 0, 1: one word
    uint32_t* o = os + (yy * CI_W + x0) / 2 + (lane >> 2);
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t* oc = o + (8 * n + 2 * tq + e) * cs<NF>() + h * CI_W / 2;
          const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(oc));
          const float v0 = acc[0][n][2 * h + e] * (g.x > 0.f ? 1.f : 0.f);
          const float v1 = acc[1][n][2 * h + e] * (g.y > 0.f ? 1.f : 0.f);
          const __nv_bfloat162 s = __floats2bfloat162_rn(v0, v1);
          *oc = *reinterpret_cast<const uint32_t*>(&s);
          db[n][e] += v0;
          db[n][e] += v1;
        }
  }
  template <int NF>
  __device__ __forceinline__ void end(const uint32_t* os, int b, int y0, int H,
                                      float (&db)[NF][2]) const {
    constexpr int PER = rows<NF>() * 16, COUT = 8 * NF;
    __shared__ float red[CI_NT / 32][64];
    __nv_bfloat16* ob = out + ((long long)b * COUT * H + y0) * CI_W;
    for (int e = threadIdx.x; e < COUT * PER; e += CI_NT) {
      const int co = e / PER, q = e % PER;
      *reinterpret_cast<uint4*>(ob + (long long)co * H * CI_W + 8 * q) =
          *reinterpret_cast<const uint4*>(os + co * cs<NF>() + 4 * q);
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = db[n][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane < 4) red[warp][8 * n + 2 * tq + e] = s;
      }
    __syncthreads();
    if (threadIdx.x < COUT) {
      float s = 0.f;
      for (int w = 0; w < CI_NT / 32; ++w) s += red[w][threadIdx.x];
      part[((long long)b * gridDim.x + blockIdx.x) * COUT + threadIdx.x] = s;
    }
  }
};

// Weight gradient of a layer, per tile:
//   part[b][ci][i][j][co] = sum_{m, n} in[b, ci, m, n] *
//                           dz[b, co, S*m + OFF - i, S*n + OFF - j]
// over the layer input's (H, W) grid, dz zero outside its (S*H, S*W) grid.
// A stride-1 'same' conv is S = 1, OFF = (K-1)/2; the transposed conv is
// S = 2, OFF = PA.  As a GEMM over the positions p of a grid:
//   D[(t, tap), c] = sum_p T[t][p + shift(tap)] * P[c][p]
// - S = 1: p runs over dz's grid (the input's), P = dz (c = co; routed from
//   the pooled gradient and its bits for the encoder convs), T = the input
//   (t = ci), shifted by (i - OFF, j - OFF);
// - S = 2: p runs over the input's grid, P = the input (c = ci), T = dz
//   (t = co) as its four phase planes dz[2u + ry][2v + rx]: tap (i, j) reads
//   plane ((OFF - i) & 1, (OFF - j) & 1) shifted by (floor((OFF - i) / 2),
//   floor((OFF - j) / 2)).
// T is zero outside its planes' (H, W) grid: the 'same' padding.
//
// A block owns one tile b, one group sg of its rows (the partial row
// b * sg_count + sg), and one slice of D's rows (t, tap), at most
// gm * mw * 16 of them.  It walks its rows of the grid in strips of R rows.
// For each strip it stages, in shared memory and in the kernel dtype, the
// T channels its slice reads, with the halo of the taps (hlo .. hhi rows and
// columns; zeros outside the grid), and the strip of P (routed dz decoded
// from its bits here, once); then every tap of the slice is computed from
// shared memory.  Each staged value serves all the taps the block computes.
//
// The 8 warps split the slice's 16-row fragments (gm groups of mw) and the
// strip's positions (gp = 8 / gm groups of 16-position steps).  bf16: each
// step is mma.sync.m16n8k16 (bf16 -> fp32) on fragments gathered from the
// staged strips with 32-bit loads (a pair of positions that starts at an
// odd column of a shifted window: two loads and a byte permute).  float32:
// the same fragments' elements by fmaf on the CUDA cores (no TF32).
// Staging moves 16-byte chunks (T's rows start at a multiple of 8 columns,
// xs0, so that the halo columns are whole chunks of zeros).  Padding of the
// MMA: conv 0 (one input channel) has K^2 rows of D in whole 16-row
// fragments, 9 of 16 (44 % padding) at k3, 25 of 32 (22 %) at k5, 49 of 64
// (23 %) at k7; the out-conv (one output channel) has one of each 8
// columns (88 % padding).
// No float atomics: each thread sums its positions in a fixed order over
// the strips, the gp position groups are summed in order through shared
// memory, and ae_train_sum adds the partial rows in order.  The row groups
// also bound how many steps one accumulator takes (wgrad_plan): the error
// of the tensor cores' float32 accumulation grows with the chain.
constexpr int WG_WARPS = 8;
constexpr int WG_NT = 32 * WG_WARPS;

// The most M fragments a warp holds with NP column fragments of 8: at most
// 64 accumulators a thread.
template <int NP>
struct WgShape {
  static constexpr int MW = NP <= 4 ? 4 : 2;
};

struct WgGeom {
  int Ct, Cp, K, H, W;  // T's and P's channels, taps per side, the grid
  int S, OFF, nph;      // stride, offset, T planes per channel (1 or 4)
  int hlo, hhi;         // the taps' shifts span hlo .. hhi (rows and columns)
  int R, sg, mw, gm;    // strip rows, row groups, fragments a warp, warp groups
  int M, RT, xs0, NC, LDT, PCS, tmax;  // D's rows; T strip rows, first
                                       // column, 8-column chunks a row, row
                                       // stride; P's channel stride; T
                                       // channels a block
};

// Tap (i, j) -> T plane and shift (see above).
__host__ __device__ inline void wg_tap(int tap, int K, int S, int OFF,
                                       int& plane, int& dy, int& dx) {
  const int i = tap / K, j = tap % K;
  if (S == 1) {
    plane = 0;
    dy = i - OFF;
    dx = j - OFF;
    return;
  }
  const int a = OFF - i, c = OFF - j, ry = a & 1, rx = c & 1;
  plane = ry * 2 + rx;
  dy = (a - ry) / 2;
  dx = (c - rx) / 2;
}

// 8 consecutive values at p (16-byte aligned) as float, and 8 floats
// stored at p (16-byte aligned) in T, rounded to nearest.
__device__ __forceinline__ void wg_load8(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void wg_load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 c = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}
__device__ __forceinline__ void wg_store8(__nv_bfloat16* p, const float* v) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}
__device__ __forceinline__ void wg_store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// T source: (B, C, Hs, Ws) in TIN (T's values rounded to T as they are
// staged); rows 16-byte aligned (Ws a multiple of 16).
template <typename TIN>
struct WgPlaneT {
  const TIN* p;
  int C, Hs, Ws;
  __device__ __forceinline__ const TIN* row(int b, int c, int y) const {
    return p + (((long long)b * C + c) * Hs + y) * Ws;
  }
};

// Stages go 8 values (16 bytes) at a time, 2 units a thread in flight: all
// loads of a round before its stores.
constexpr int WG_U = 2;

// P source: (B, Cp, H, W) in T, copied.
template <typename T>
struct WgPlainP {
  const T* p;
  __device__ __forceinline__ void stage(T* ps, const WgGeom& g, int b, int y0) const {
    const int nc = g.W / 8, total = g.Cp * g.R * nc;
    for (int e0 = threadIdx.x; e0 < total; e0 += WG_NT * WG_U) {
      float v[WG_U][8];
#pragma unroll
      for (int u = 0; u < WG_U; ++u) {
        const int e = e0 + u * WG_NT, c = e / (g.R * nc), q = e % (g.R * nc);
        if (e < total)
          wg_load8(p + (((long long)b * g.Cp + c) * g.H + y0) * g.W + q * 8, v[u]);
      }
#pragma unroll
      for (int u = 0; u < WG_U; ++u) {
        const int e = e0 + u * WG_NT, c = e / (g.R * nc), q = e % (g.R * nc);
        if (e < total) wg_store8(ps + c * g.PCS + q * 8, v[u]);
      }
    }
  }
};

// P source: dz routed from the pooled gradient v (B, Cp, H/2, W/2) and its
// bits (RouteSrc's encoding), each pooled value and its bits read once.
template <typename T>
struct WgRouteP {
  const T* v;
  const uint8_t* bits;
  __device__ __forceinline__ void stage(T* ps, const WgGeom& g, int b, int y0) const {
    const int hh = g.H / 2, nc = g.W / 16, rows = g.R / 2, total = g.Cp * rows * nc;
    for (int e0 = threadIdx.x; e0 < total; e0 += WG_NT * WG_U) {
      float val[WG_U][8];
      uint2 m[WG_U];
#pragma unroll
      for (int u = 0; u < WG_U; ++u) {
        const int e = e0 + u * WG_NT, c = e / (rows * nc), q = e % (rows * nc);
        const long long o =
            (((long long)b * g.Cp + c) * hh + y0 / 2 + q / nc) * (g.W / 2) + (q % nc) * 8;
        if (e < total) {
          wg_load8(v + o, val[u]);
          m[u] = *reinterpret_cast<const uint2*>(bits + o);
        }
      }
#pragma unroll
      for (int u = 0; u < WG_U; ++u) {
        const int e = e0 + u * WG_NT, c = e / (rows * nc), q = e % (rows * nc);
        if (e >= total) continue;
        T* d = ps + c * g.PCS + 2 * (q / nc) * g.W + (q % nc) * 16;
#pragma unroll
        for (int a = 0; a < 2; ++a) {  // pixel row 2 u + a
          float out[16];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const unsigned k = ((i < 4 ? m[u].x : m[u].y) >> (8 * (i & 3))) & 0xffu;
            out[2 * i] = (k >> (2 * a)) & 1u ? val[u][i] : 0.f;
            out[2 * i + 1] = (k >> (2 * a + 1)) & 1u ? val[u][i] : 0.f;
          }
          wg_store8(d + a * g.W, out);
          wg_store8(d + a * g.W + 8, out + 8);
        }
      }
    }
  }
};

// Stage T channels tc0 .. tc0 + ntc - 1 for the strip at row y0: smem
// (t, plane, r, c) holds T plane value (y0 + hlo + r, xs0 + c), zero outside
// the grid.  A unit is 8 columns of one plane row (of phase planes: both
// column phases, from 16 source values of the row).
template <typename T, class TSrc>
__device__ __forceinline__ void wg_stage_t(const TSrc& src, T* ts, const WgGeom& g,
                                           int b, int tc0, int ntc, int y0) {
  const int ny = g.nph == 4 ? 2 : 1, per = g.RT * ny * g.NC, total = ntc * per;
  for (int e0 = threadIdx.x; e0 < total; e0 += WG_NT * WG_U) {
    float v[WG_U][16];
#pragma unroll
    for (int u = 0; u < WG_U; ++u) {
      const int e = e0 + u * WG_NT, t = e / per, q = e % per;
      const int j = q % g.NC, ry = (q / g.NC) % ny, r = q / (g.NC * ny);
      const int y = y0 + g.hlo + r, x = g.xs0 + 8 * j;
      const bool in = e < total && y >= 0 && y < g.H && x >= 0 && x < g.W;
#pragma unroll
      for (int i = 0; i < 16; ++i) v[u][i] = 0.f;
      if (in) {
        const auto* row = src.row(b, tc0 + t, ny * y + ry) + ny * x;
        wg_load8(row, v[u]);
        if (ny == 2) wg_load8(row + 8, v[u] + 8);
      }
    }
#pragma unroll
    for (int u = 0; u < WG_U; ++u) {
      const int e = e0 + u * WG_NT, t = e / per, q = e % per;
      if (e >= total) continue;
      const int j = q % g.NC, ry = (q / g.NC) % ny, r = q / (g.NC * ny);
      T* d = ts + ((long long)(t * g.nph + ry * 2) * g.RT + r) * g.LDT + 8 * j;
      if (ny == 1) {
        wg_store8(d, v[u]);
      } else {  // deinterleave the column phases
        float ev[8], od[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          ev[i] = v[u][2 * i];
          od[i] = v[u][2 * i + 1];
        }
        wg_store8(d, ev);
        wg_store8(d + (long long)g.RT * g.LDT, od);
      }
    }
  }
}

// The 32-bit word of two bf16 at element offset e of s (e even: one
// aligned load; e odd: two, and the middle half-words).
__device__ __forceinline__ uint32_t wg_pair(const uint32_t* s, int e) {
  const uint32_t lo = s[e >> 1];
  if (!(e & 1)) return lo;
  return __byte_perm(lo, s[(e >> 1) + 1], 0x5432);
}

template <typename T, int NP, class TSrc, class PSrc>
__global__ void __launch_bounds__(WG_NT, 2) wgrad_kernel(TSrc tsrc, PSrc psrc,
                                                          float* __restrict__ part,
                                                          WgGeom g) {
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  constexpr int MW = WgShape<NP>::MW;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  T* ts = reinterpret_cast<T*>(wg_smem);
  T* ps = ts + (long long)g.tmax * g.nph * g.RT * g.LDT;

  const int KK = g.K * g.K;
  const int sgi = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * g.gm * g.mw * 16;
  const int row1 = min(g.M, row0 + g.gm * g.mw * 16);
  const int tc0 = row0 / KK, ntc = (row1 - 1) / KK + 1 - tc0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int gp = WG_WARPS / g.gm, gmi = warp / gp, gpi = warp % gp;
  const int wrow0 = row0 + gmi * g.mw * 16;  // this warp's first row of D

  // The smem offset of each of the thread's two rows (gq, gq + 8) per
  // fragment, at position (0, 0) of the strip; rows past the slice read 0.
  int off[MW][2];
#pragma unroll
  for (int f = 0; f < MW; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wrow0 + f * 16 + gq + 8 * h;
      off[f][h] = 0;
      if (f < g.mw && row < row1) {
        int plane, dy, dx;
        wg_tap(row % KK, g.K, g.S, g.OFF, plane, dy, dx);
        off[f][h] = ((row / KK - tc0) * g.nph + plane) * g.RT * g.LDT +
                    (dy - g.hlo) * g.LDT + dx - g.xs0;
      }
    }

  float acc[MW][NP][4];
#pragma unroll
  for (int f = 0; f < MW; ++f)
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[f][n][q] = 0.f;

  const bool busy = wrow0 < row1;
  const int rows = g.H / g.sg, kw = g.W / 16, nks = g.R * kw;
  for (int y0 = sgi * rows; y0 < (sgi + 1) * rows; y0 += g.R) {
    __syncthreads();
    wg_stage_t<T>(tsrc, ts, g, b, tc0, ntc, y0);
    psrc.stage(ps, g, b, y0);
    __syncthreads();
    if (!busy) continue;
    for (int ks = gpi; ks < nks; ks += gp) {
      const int yl = ks / kw, x0 = (ks % kw) * 16;
      if constexpr (MMA) {
        const uint32_t* t32 = reinterpret_cast<const uint32_t*>(ts);
        const uint32_t* p32 = reinterpret_cast<const uint32_t*>(ps);
        uint32_t bq[NP][2];
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          const int o = (min(n * 8 + gq, g.Cp - 1) * g.PCS + yl * g.W + x0 + 2 * tq) >> 1;
          bq[n][0] = p32[o];
          bq[n][1] = p32[o + 4];
        }
        const int base = yl * g.LDT + x0 + 2 * tq;
#pragma unroll
        for (int f = 0; f < MW; ++f) {
          if (f >= g.mw) break;
          const uint32_t a0 = wg_pair(t32, off[f][0] + base);
          const uint32_t a1 = wg_pair(t32, off[f][1] + base);
          const uint32_t a2 = wg_pair(t32, off[f][0] + base + 8);
          const uint32_t a3 = wg_pair(t32, off[f][1] + base + 8);
#pragma unroll
          for (int n = 0; n < NP; ++n) mma_bf16(acc[f][n], a0, a1, a2, a3, bq[n][0], bq[n][1]);
        }
      } else {
        const float* tf = reinterpret_cast<const float*>(ts);
        const float* pf = reinterpret_cast<const float*>(ps);
        int pc[NP][2];
#pragma unroll
        for (int n = 0; n < NP; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            pc[n][e] = min(n * 8 + 2 * tq + e, g.Cp - 1) * g.PCS + yl * g.W + x0;
        const int base = yl * g.LDT + x0;
#pragma unroll 4
        for (int k = 0; k < 16; ++k) {
          float bv[NP][2];
#pragma unroll
          for (int n = 0; n < NP; ++n) {
            bv[n][0] = pf[pc[n][0] + k];
            bv[n][1] = pf[pc[n][1] + k];
          }
#pragma unroll
          for (int f = 0; f < MW; ++f) {
            if (f >= g.mw) break;
            const float a0 = tf[off[f][0] + base + k], a1 = tf[off[f][1] + base + k];
#pragma unroll
            for (int n = 0; n < NP; ++n) {
              acc[f][n][0] = fmaf(a0, bv[n][0], acc[f][n][0]);
              acc[f][n][1] = fmaf(a0, bv[n][1], acc[f][n][1]);
              acc[f][n][2] = fmaf(a1, bv[n][0], acc[f][n][2]);
              acc[f][n][3] = fmaf(a1, bv[n][1], acc[f][n][3]);
            }
          }
        }
      }
    }
  }

  if (gp > 1) {  // the position groups' sums, in order
    float* red = reinterpret_cast<float*>(wg_smem);
    __syncthreads();
#pragma unroll
    for (int f = 0; f < MW; ++f)
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          red[(((warp * MW + f) * NP + n) * 4 + q) * 32 + lane] = acc[f][n][q];
    __syncthreads();
    if (gpi == 0) {
#pragma unroll
      for (int f = 0; f < MW; ++f)
#pragma unroll
        for (int n = 0; n < NP; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float s = 0.f;
            for (int w = 0; w < gp; ++w)
              s += red[((((gmi * gp + w) * MW + f) * NP + n) * 4 + q) * 32 + lane];
            acc[f][n][q] = s;
          }
    }
  }
  if (gpi != 0 || !busy) return;
  const int cout = g.S == 1 ? g.Cp : g.Ct;
  float* prow = part + ((long long)b * g.sg + sgi) * g.M * g.Cp;
#pragma unroll
  for (int f = 0; f < MW; ++f) {
    if (f >= g.mw) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wrow0 + f * 16 + gq + 8 * h;
      if (row >= row1) continue;
      const int t = row / KK, tap = row % KK;
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * tq + e;
          if (col >= g.Cp) continue;
          const int ci = g.S == 1 ? t : col, co = g.S == 1 ? col : t;
          prow[((long long)ci * KK + tap) * cout + co] = acc[f][n][h * 2 + e];
        }
    }
  }
}

// Input gradient of the stride-2 transposed conv (convt_relu_kernel's
// adjoint), gated per pixel, with the bias-gradient partials of the layer
// below:
//   out[c, m, n] = sum_{cz, i, j} w[c, i, j, cz] * dz[cz, 2m + PA - i, 2n + PA - j]
// over dz's (2H, 2W) grid (zero outside: the 'same' padding).  With dz as
// its four phase planes dz[2u + ry][2v + rx], tap (i, j) reads plane
// ((PA - i) & 1, (PA - j) & 1) at (m + dy, n + dx), dy = floor((PA - i) / 2),
// dx = floor((PA - j) / 2): a plain shifted window of an (H, W) grid.  So
// the stage is an implicit GEMM
//   D[p, c] = sum_{(cz, tap)} A[p, (cz, tap)] * W[(cz, tap), c]
// over the positions p of the output grid (M), the Cout channels c (N, in
// 8-column fragments) and the reduction (cz, tap) (K), A being dz read
// through the tap's shift.  wt is (K, K, Cout, Cz): w with dz's channel
// fastest.
//
// A block owns one tile b and a strip of R output rows (R * W positions:
// 8 warps of MW 16-position fragments).  It walks dz's channels in chunks
// of CH (16 in bf16, 8 in float32).  For each chunk it stages, in shared
// memory and in T, the strip's four phase planes with the taps' halo
// (plane rows y0 + hlo .. y0 + R - 1 + hhi, columns hlo .. W - 1 + hhi,
// zeros outside the grid) and the chunk's weights for every tap and output
// channel; every tap and every output channel is computed from there.  Each
// dz value is loaded from device memory once per block.
//
// Layout: a staged position (plane, row, column) or weight (tap, c) is one
// run of CH channels (32 bytes).  bf16: the pair of reduction values a
// thread holds in an m16n8k16 A fragment (channels 2tq, 2tq + 1 at one
// position) is one aligned 32-bit load, and its B fragment's pair (the same
// channels at one output channel) likewise; the two 16-byte halves of a run
// swap places where bit 2 of its index is set, so that the 8 positions or
// channels of a fragment load fall in 32 different banks.  No permute at
// the fragment loads (staging splits the column phases), and no padding in
// the MMA: M is whole 16-position fragments (W a multiple of
// 16), N whole 8-channel fragments (Cout a multiple of 16), K whole
// 16-channel steps (Cz a multiple of 16).
//
// bf16: each k step is mma.sync.m16n8k16 (bf16 -> fp32).  The tensor
// cores' float32 accumulation drifts with the length of a chain (see
// wgrad_kernel's row groups), and a chain here is Cz * K^2 products
// (3136 at (64, 32, 64)/k7), so each channel chunk (at most 49 k steps)
// accumulates in fresh fragments that are then added into float32
// registers, chunk by chunk in order.  float32: the same fragments'
// elements by fmaf on the CUDA cores (no TF32).
//
// The gate and the bias partials as GateOut gives them: each thread sums
// its gated values in a fixed order, then the 8 lanes of a channel by a
// fixed shuffle tree, then the 8 warps in order: one partial row per
// (tile, strip), summed in order by ae_train_sum.  No float atomics.
//
// What bounds it: 2 * H * W * Cz * Cout * K^2 FLOP a tile (flagship 24.2,
// deep3 67.1 GFLOP per 128-tile step): 0.025 / 0.068 ms at the bf16 peak,
// under the byte bound (dz, the gate and the output once: 0.15 / 0.13 ms).
// This design stages with plain loads, does not overlap the staging with
// the MMAs, and each block reads the layer's weights (up to 401 KB) from L2.
constexpr int DG_WARPS = 8;
constexpr int DG_NT = 32 * DG_WARPS;

template <int NF>
struct DgShape {  // 16-position fragments a warp, with NF * MW <= 8
  static constexpr int MW = NF >= 6 ? 1 : 8 / NF;
  static constexpr int POS = DG_WARPS * MW * 16;
};
template <typename T>
struct DgChunk {  // dz channels a chunk: one 32-byte run
  static constexpr int CH = sizeof(T) == 2 ? 16 : 8;
};

struct DgGeom {
  int Cz, Cout, H, W, K, PA;
  int hlo, hhi, R, RT, WT;  // the taps' shifts, strip rows, staged rows and columns
};

// 32-bit word of word q (0..7) of run L: bf16 runs swap their halves where
// bit 2 of L is set; float32 runs are stored as they are.
template <typename T>
__device__ __forceinline__ int dg_word(int L, int q) {
  if constexpr (sizeof(T) == 2) return run_word(L, q);
  return L * 8 + q;
}

// Stage dz channels c0 .. c0 + CH - 1 of the strip at y0 as runs of the
// four phase planes: run ((ry * 2 + rx) * RT + r) * WT + x holds plane
// (ry, rx) at (y0 + hlo + r, hlo + x).  A unit is one plane row's column
// pair: CH loads of both column phases (32 bits in bf16, 64 in float32).
template <typename T>
__device__ __forceinline__ void dg_stage_dz(const T* __restrict__ dz, uint32_t* as,
                                            const DgGeom& g, int b, int c0, int y0) {
  constexpr int CH = DgChunk<T>::CH;
  const int total = g.RT * 2 * g.WT, w2 = 2 * g.W;
  const long long chan = (long long)(2 * g.H) * w2;
  const T* base = dz + ((long long)b * g.Cz + c0) * chan;
  for (int e = threadIdx.x; e < total; e += DG_NT) {
    const int x = e % g.WT, ry = (e / g.WT) & 1, r = e / (2 * g.WT);
    const int u = y0 + g.hlo + r, v = g.hlo + x;
    const bool in = u >= 0 && u < g.H && v >= 0 && v < g.W;
    const long long o = in ? (long long)(2 * u + ry) * w2 + 2 * v : 0;
    const int L0 = (ry * 2 * g.RT + r) * g.WT + x, L1 = L0 + g.RT * g.WT;
    if constexpr (sizeof(T) == 2) {
      uint32_t p[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c)
        p[c] = in ? *reinterpret_cast<const uint32_t*>(base + c * chan + o) : 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        as[dg_word<T>(L0, q)] = __byte_perm(p[2 * q], p[2 * q + 1], 0x5410);
        as[dg_word<T>(L1, q)] = __byte_perm(p[2 * q], p[2 * q + 1], 0x7632);
      }
    } else {
      float2 p[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c)
        p[c] = in ? *reinterpret_cast<const float2*>(base + c * chan + o)
                  : make_float2(0.f, 0.f);
      float* f = reinterpret_cast<float*>(as);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        f[L0 * 8 + c] = p[c].x;
        f[L1 * 8 + c] = p[c].y;
      }
    }
  }
}

// Stage the chunk's weights: run tap * Cout + c holds wt[tap][c][c0 ..],
// two 16-byte loads.
template <typename T>
__device__ __forceinline__ void dg_stage_w(const T* __restrict__ wt, uint32_t* ws,
                                           const DgGeom& g, int c0) {
  const int total = g.K * g.K * g.Cout;
  for (int e = threadIdx.x; e < total; e += DG_NT) {
    const uint4* src = reinterpret_cast<const uint4*>(wt + (long long)e * g.Cz + c0);
    const uint4 lo = src[0], hi = src[1];
    *reinterpret_cast<uint4*>(ws + dg_word<T>(e, 0)) = lo;
    *reinterpret_cast<uint4*>(ws + dg_word<T>(e, 4)) = hi;
  }
}

template <typename T, int NF, int MODE>
__global__ void __launch_bounds__(DG_NT, 2) convt_dgrad_kernel(
    const T* __restrict__ dz, const T* __restrict__ wt, GateOut<T, MODE> gout,
    float* __restrict__ part, DgGeom g) {
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  constexpr int MW = DgShape<NF>::MW, CH = DgChunk<T>::CH;
  extern __shared__ __align__(16) unsigned char dg_smem[];
  __shared__ float red[DG_WARPS][64];
  uint32_t* as = reinterpret_cast<uint32_t*>(dg_smem);
  uint32_t* ws = as + 4 * g.RT * g.WT * 8;

  const int strip = blockIdx.x, b = blockIdx.z, y0 = strip * g.R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int nmf = g.R * g.W / 16, kk = g.K * g.K;

  // each fragment's run for its row gq at plane 0, shift (hlo, hlo)
  int lb[MW];
#pragma unroll
  for (int f = 0; f < MW; ++f) {
    const int p0 = (warp * MW + f) * 16;
    lb[f] = (p0 / g.W) * g.WT + p0 % g.W + gq;
  }

  float acc[MW][NF][4];
#pragma unroll
  for (int f = 0; f < MW; ++f)
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[f][n][q] = 0.f;

  for (int c0 = 0; c0 < g.Cz; c0 += CH) {
    __syncthreads();
    dg_stage_dz<T>(dz, as, g, b, c0, y0);
    dg_stage_w<T>(wt, ws, g, c0);
    __syncthreads();
    float cacc[MW][NF][4];
#pragma unroll
    for (int f = 0; f < MW; ++f)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) cacc[f][n][q] = 0.f;
    for (int tap = 0; tap < kk; ++tap) {
      const int ai = g.PA - tap / g.K, aj = g.PA - tap % g.K;
      const int plane = (ai & 1) * 2 + (aj & 1);
      const int toff = (plane * g.RT + (ai >> 1) - g.hlo) * g.WT + (aj >> 1) - g.hlo;
      const int wl = tap * g.Cout;
      if constexpr (MMA) {
        uint32_t bq[NF][2];
#pragma unroll
        for (int n = 0; n < NF; ++n) {
          bq[n][0] = ws[dg_word<T>(wl + 8 * n + gq, tq)];
          bq[n][1] = ws[dg_word<T>(wl + 8 * n + gq, tq + 4)];
        }
#pragma unroll
        for (int f = 0; f < MW; ++f) {
          if (warp * MW + f >= nmf) break;
          const int L = lb[f] + toff;
          const uint32_t a0 = as[dg_word<T>(L, tq)], a1 = as[dg_word<T>(L + 8, tq)];
          const uint32_t a2 = as[dg_word<T>(L, tq + 4)], a3 = as[dg_word<T>(L + 8, tq + 4)];
#pragma unroll
          for (int n = 0; n < NF; ++n)
            mma_bf16(cacc[f][n], a0, a1, a2, a3, bq[n][0], bq[n][1]);
        }
      } else {
        const float* af = reinterpret_cast<const float*>(as);
        const float* wf = reinterpret_cast<const float*>(ws);
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          float bv[NF][2];
#pragma unroll
          for (int n = 0; n < NF; ++n) {
            bv[n][0] = wf[(wl + 8 * n + 2 * tq) * 8 + k];
            bv[n][1] = wf[(wl + 8 * n + 2 * tq + 1) * 8 + k];
          }
#pragma unroll
          for (int f = 0; f < MW; ++f) {
            if (warp * MW + f >= nmf) break;
            const int L = lb[f] + toff;
            const float a0 = af[L * 8 + k], a1 = af[(L + 8) * 8 + k];
#pragma unroll
            for (int n = 0; n < NF; ++n) {
              acc[f][n][0] = fmaf(a0, bv[n][0], acc[f][n][0]);
              acc[f][n][1] = fmaf(a0, bv[n][1], acc[f][n][1]);
              acc[f][n][2] = fmaf(a1, bv[n][0], acc[f][n][2]);
              acc[f][n][3] = fmaf(a1, bv[n][1], acc[f][n][3]);
            }
          }
        }
      }
    }
    if constexpr (MMA) {
#pragma unroll
      for (int f = 0; f < MW; ++f)
#pragma unroll
        for (int n = 0; n < NF; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[f][n][q] += cacc[f][n][q];
    }
  }

  // the gate, the store and the bias partials of channel 8n + 2tq + e at
  // positions gq and gq + 8 of each fragment
  float db[NF][2];
#pragma unroll
  for (int n = 0; n < NF; ++n) db[n][0] = db[n][1] = 0.f;
#pragma unroll
  for (int f = 0; f < MW; ++f) {
    if (warp * MW + f >= nmf) break;
    const int p0 = (warp * MW + f) * 16;
    const int y = y0 + p0 / g.W, x = p0 % g.W + gq;
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long o =
            (((long long)b * g.Cout + 8 * n + 2 * tq + e) * g.H + y) * g.W + x;
        db[n][e] += gout.put(o, acc[f][n][e]);
        db[n][e] += gout.put(o + 8, acc[f][n][2 + e]);
      }
  }
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = db[n][e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (gq == 0) red[warp][8 * n + 2 * tq + e] = s;
    }
  __syncthreads();
  if (threadIdx.x < g.Cout) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < DG_WARPS; ++w) s += red[w][threadIdx.x];
    part[((long long)b * gridDim.x + strip) * g.Cout + threadIdx.x] = s;
  }
}

// Fixed-order sums of partial rows, for up to SUM_SEGS segments in one
// launch (a step's partials: the loss's, each input gradient's bias
// partials, each weight gradient's).  Segment s sums its (n, m) rows into
// (slabs, m): slab y holds rows n * y / slabs .. n * (y + 1) / slabs - 1;
// its blocks are blk0 .. blk0 + groups * slabs - 1, block l taking 32
// consecutive columns (group l % groups: lane j reads column 32 group + j,
// so a warp's loads of a row are coalesced) of slab l / groups.  Warp w sums
// the slab's rows w, w + 8, .. in order; then a fixed tree over the 8 warps:
// ((w0 + w4) + (w2 + w6)) + ((w1 + w5) + (w3 + w7)).  The table is a
// __grid_constant__ parameter (SUM_SEGS * 32 bytes, far under the 4 KB
// limit), and a block finds its segment by the table's block offsets.
constexpr int SUM_WARPS = 8;
constexpr int SUM_SEGS = 32;

struct SumSeg {
  const float* src;
  float* dst;
  int n, m, slabs, blk0;
};
struct SumTable {
  SumSeg seg[SUM_SEGS];
  int count;
};

__global__ void __launch_bounds__(32 * SUM_WARPS)
    sum_rows_kernel(const __grid_constant__ SumTable t) {
  __shared__ float red[SUM_WARPS][32];
  int i = 0;
  while (i + 1 < t.count && (int)blockIdx.x >= t.seg[i + 1].blk0) ++i;
  const SumSeg& g = t.seg[i];
  const float* __restrict__ part = g.src;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n = g.n, m = g.m;
  const int groups = (m + 31) / 32, l = blockIdx.x - g.blk0;
  const int col = (l % groups) * 32 + lane, slab = l / groups;
  const int r0 = (int)((long long)n * slab / g.slabs);
  const int r1 = (int)((long long)n * (slab + 1) / g.slabs);
  float s = 0.f;
  if (col < m) {
    int r = r0 + warp;
    for (; r + 7 * SUM_WARPS < r1; r += 8 * SUM_WARPS) {  // 8 loads in flight, added in order
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = part[(long long)(r + u * SUM_WARPS) * m + col];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; r < r1; r += SUM_WARPS) s += part[(long long)r * m + col];
  }
  red[warp][lane] = s;
  __syncthreads();
  for (int w = SUM_WARPS / 2; w > 0; w >>= 1) {
    if (warp < w) red[warp][lane] += red[warp + w][lane];
    __syncthreads();
  }
  if (warp == 0 && col < m) g.dst[(long long)slab * m + col] = red[0][lane];
}

// The rest of a launch's geometry from (Ct, Cp, K, H, W, S, OFF) and the
// plan (R, sg, mw, gm); returns the dynamic shared memory it needs, or -1
// for a geometry or plan the kernel does not take.  ops/ae_train_kernel.py
// (wgrad_plan) chooses the plan with the same sizes.
inline long long wg_geometry(WgGeom& g, int item, int mw_max) {
  if (g.K < 1 || g.K > 7 || g.Ct < 1 || g.Cp < 1 || g.Cp > 64 || g.W % 16 != 0 ||
      g.R < 2 || g.R % 2 != 0 || g.sg < 1 || g.H % (g.sg * g.R) != 0 || g.mw < 1 ||
      g.mw > mw_max || (g.gm != 1 && g.gm != 2 && g.gm != 4 && g.gm != 8) ||
      (g.S != 1 && g.S != 2))
    return -1;
  g.nph = g.S == 2 ? 4 : 1;
  g.hlo = 1 << 20;
  g.hhi = -(1 << 20);
  for (int i = 0; i < g.K; ++i) {  // rows and columns shift alike
    int plane, dy, dx;
    wg_tap(i * g.K + i, g.K, g.S, g.OFF, plane, dy, dx);
    g.hlo = min(g.hlo, dy);
    g.hhi = max(g.hhi, dy);
  }
  g.M = g.Ct * g.K * g.K;
  g.RT = g.R + g.hhi - g.hlo;
  // T rows start at the multiple of 8 columns at or left of hlo, so that 8
  // columns are one aligned 16-byte chunk of the source row; row and channel
  // strides are 4 words past a multiple of 8 (of 32 for P's channels), so
  // that the fragment loads of 8 rows or channels spread over the banks
  g.xs0 = g.hlo >= 0 ? 0 : -8 * ((7 - g.hlo) / 8);
  g.NC = (g.W + g.hhi - g.xs0 + 7) / 8;
  g.LDT = 8 * g.NC + (item == 2 ? (g.NC % 2 == 0 ? 8 : 0) : 4);
  const int wpe = item == 2 ? 2 : 1;  // elements per 4-byte word
  const int words = g.R * g.W / wpe;
  g.PCS = (words + (36 - words % 32) % 32) * wpe;
  const int rows = g.gm * g.mw * 16, kk = g.K * g.K;
  g.tmax = min(g.Ct, (rows - 1) / kk + 2);
  const long long stage =
      ((long long)g.tmax * g.nph * g.RT * g.LDT + (long long)g.Cp * g.PCS) * item;
  const int np = (g.Cp + 7) / 8;
  const long long red = g.gm < WG_WARPS ? (long long)WG_NT * mw_max * np * 4 * 4 : 0;
  return max(stage, red);
}

template <typename T, int NP, class TSrc, class PSrc>
int launch_wgrad_np(TSrc ts, PSrc ps, float* part, int B, WgGeom g, cudaStream_t st) {
  const long long smem = wg_geometry(g, sizeof(T), WgShape<NP>::MW);
  const int slices = (g.Ct * g.K * g.K + g.gm * g.mw * 16 - 1) / (g.gm * g.mw * 16);
  if (smem < 0 || smem > 227 * 1024 || B < 1 || B > 65535 || slices > 65535)
    return cudaErrorInvalidValue;
  auto kern = wgrad_kernel<T, NP, TSrc, PSrc>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(slices, g.sg, B), WG_NT, smem, st>>>(ts, ps, part, g);
  return cudaGetLastError();
}

// Column fragments NP = ceil(Cp / 8): 1 for the out-conv's one channel
// (ONE), else 2, 4, 6 or 8 (16 to 64 channels): only the tiles some
// geometry runs are instantiated.
template <typename T, bool ONE, class TSrc, class PSrc>
int launch_wgrad(TSrc ts, PSrc ps, float* part, int B, WgGeom g, cudaStream_t st) {
  const int np = (g.Cp + 7) / 8;
  if constexpr (ONE) {
    if (np == 1) return launch_wgrad_np<T, 1>(ts, ps, part, B, g, st);
  } else {
    switch (np) {
      case 2: return launch_wgrad_np<T, 2>(ts, ps, part, B, g, st);
      case 4: return launch_wgrad_np<T, 4>(ts, ps, part, B, g, st);
      case 6: return launch_wgrad_np<T, 6>(ts, ps, part, B, g, st);
      case 8: return launch_wgrad_np<T, 8>(ts, ps, part, B, g, st);
    }
  }
  return cudaErrorInvalidValue;
}

// In bf16 conv_in_mma_kernel with CiPoolMaskEpi, from the float32 tiles
// (CiSpecSrc, rounded to bf16 as staged) or the bf16 tiles (CiBf16Src): the
// same bits; float32 conv_quad_kernel with PoolMaskEpi.
template <typename TIN, typename T>
int train_in(const void* x, const void* w, const float* bias, void* out,
             uint8_t* bits, int B, int Cout, int H, int W, int K,
             cudaStream_t st) {
  const auto* xi = static_cast<const TIN*>(x);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (reinterpret_cast<uintptr_t>(x) % 4 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(bits) % 16 != 0)
      return cudaErrorInvalidValue;
    const CiPoolMaskEpi epi{static_cast<__nv_bfloat16*>(out), bits};
    if constexpr (std::is_same<TIN, float>::value)
      return launch_conv_in(CiSpecSrc{xi, nullptr, nullptr, (long long)H * W, W, 1, 1}, w, bias,
                            epi, B, Cout, H, W, K, st);
    else
      return launch_conv_in(CiBf16Src{xi}, w, bias, epi, B, Cout, H, W, K, st);
  } else {
    return launch_conv_quad<T, COB>(
        PlaneSrc<TIN, T>{xi, nchw(1, H, W)}, w, bias,
        PoolMaskEpi{static_cast<float*>(out), bits, Cout, H / 2, W / 2}, B, 1,
        Cout, H, W, K, st);
  }
}

// In bf16 conv_out_mma_kernel with CoLossEpi, one partial row per (tile,
// band); float32 conv_quad_kernel with LossEpi, one per quad block.
template <typename TY, typename T>
int train_loss(const void* e, const void* w, const float* bias, const void* y,
               const float* tmask, float* logits, void* dz, float* part,
               int rows, int B, int Cin, int H, int W, int K,
               cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (H % CO_BAND != 0 || rows != B * (H / CO_BAND) ||
        reinterpret_cast<uintptr_t>(logits) % 16 != 0 || reinterpret_cast<uintptr_t>(dz) % 8 != 0)
      return cudaErrorInvalidValue;
    return launch_conv_out(e, w, bias,
                           CoLossEpi<TY>{static_cast<const TY*>(y), tmask, logits,
                                         static_cast<__nv_bfloat16*>(dz), part, H},
                           B, Cin, H, W, K, st);
  } else {
    if (rows != B * quad_blocks(H, W)) return cudaErrorInvalidValue;
    return launch_conv_quad<T, 1>(
        PlaneSrc<T, T>{static_cast<const T*>(e), nchw(Cin, H, W)}, w, bias,
        LossEpi{static_cast<const float*>(y), tmask, logits, static_cast<float*>(dz), part,
                H, W},
        B, Cin, 1, H, W, K, st);
  }
}

// In bf16 a routed dz (the encoder convs) runs conv_igemm_kernel, w (K, K,
// Cout, Cz), and the out-conv's one dz channel conv_in_mma_kernel, w (1, K,
// K, Cout), each one partial row per (tile, strip); float32
// conv_quad_kernel, w (Cz, K, K, Cout), one partial row per quad block.
template <typename T>
int dgrad_conv(const void* dz, const uint8_t* dz_bits, const void* w,
               const void* gate, void* out, float* part, int rows, int B,
               int Cz, int Cout, int H, int W, int K, cudaStream_t st) {
  const auto* d = static_cast<const T*>(dz);
  auto* o = static_cast<T*>(out);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (dz_bits != nullptr) {
      const int R = ig_strip_rows(Cout, W);
      if (R < 2 || H % R != 0 || rows != B * (H / R)) return cudaErrorInvalidValue;
      return launch_conv_igemm(
          IgRouteSrc{d, dz_bits}, w, nullptr,
          IgGateEpi<GATE_ROUTE>{{o, gate}, part, Cout, H, W}, B, Cz, Cout, H, W, K, st);
    }
    const int R = CiGateEpi::rows_of(Cout);
    if (Cz != 1 || H % R != 0 || rows != B * (H / R) || reinterpret_cast<uintptr_t>(dz) % 4 != 0 ||
        reinterpret_cast<uintptr_t>(gate) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return cudaErrorInvalidValue;
    return launch_conv_in(CiBf16Src{d}, w, nullptr,
                          CiGateEpi{o, static_cast<const __nv_bfloat16*>(gate), part}, B, Cout,
                          H, W, K, st);
  } else {
    if (rows != B * quad_blocks(H, W)) return cudaErrorInvalidValue;
    if (dz_bits == nullptr)
      return launch_conv_quad<T, COB>(
          PlaneSrc<T, T>{d, nchw(Cz, H, W)}, w, nullptr,
          GateQuadEpi<GATE_RELU>{{o, gate}, part, Cout, H, W}, B, Cz, Cout,
          H, W, K, st);
    return launch_conv_quad<T, COB>(
        RouteSrc<T>{d, dz_bits, Cz, H / 2, W / 2}, w, nullptr,
        GateQuadEpi<GATE_ROUTE>{{o, gate}, part, Cout, H, W}, B, Cz, Cout, H,
        W, K, st);
  }
}

template <typename T, int NF, int MODE>
int launch_dgrad_convt(const T* dz, const T* wt, GateOut<T, MODE> g, float* part,
                       int B, const DgGeom& geo, cudaStream_t st) {
  const long long smem =
      (4LL * geo.RT * geo.WT + (long long)geo.K * geo.K * geo.Cout) * 32;
  if (smem > 227 * 1024 - (long long)sizeof(float) * DG_WARPS * 64)
    return cudaErrorInvalidValue;
  auto kern = convt_dgrad_kernel<T, NF, MODE>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(geo.H / geo.R, 1, B), DG_NT, smem, st>>>(dz, wt, g, part, geo);
  return cudaGetLastError();
}

// One partial row per (tile, strip): the strips are R = min(POS / W, H)
// rows, POS the positions of a block (ops/ae_train_kernel.py
// dgrad_convt_rows).
template <typename T, int MODE>
int dgrad_convt(const void* dz, const void* w, const void* gate, void* out,
                float* part, int rows, int B, int Cz, int Cout, int H, int W,
                int K, cudaStream_t st) {
  if (K < 1 || K > 7 || K % 2 == 0 || Cz < 16 || Cz % 16 != 0 || Cout < 16 ||
      Cout > 64 || Cout % 16 != 0 || W < 16 || W % 16 != 0 || H < 1 || B < 1 ||
      B > 65535)
    return cudaErrorInvalidValue;
  DgGeom geo{Cz, Cout, H, W, K, K - 1 < 2 ? K - 1 : (K + 1) / 2};
  geo.hlo = (geo.PA - K + 1) >> 1;
  geo.hhi = geo.PA >> 1;
  const int nf = Cout / 8;
  const int pos = nf == 2 ? DgShape<2>::POS : nf == 4 ? DgShape<4>::POS : DgShape<8>::POS;
  geo.R = min(pos / W, H);
  if (geo.R < 1 || H % geo.R != 0 || rows != B * (H / geo.R)) return cudaErrorInvalidValue;
  geo.RT = geo.R + geo.hhi - geo.hlo;
  geo.WT = W + geo.hhi - geo.hlo;
  const auto* d = static_cast<const T*>(dz);
  const auto* wt = static_cast<const T*>(w);
  const GateOut<T, MODE> g{static_cast<T*>(out), gate};
  switch (nf) {
    case 2: return launch_dgrad_convt<T, 2, MODE>(d, wt, g, part, B, geo, st);
    case 4: return launch_dgrad_convt<T, 4, MODE>(d, wt, g, part, B, geo, st);
    case 6: return launch_dgrad_convt<T, 6, MODE>(d, wt, g, part, B, geo, st);
    case 8: return launch_dgrad_convt<T, 8, MODE>(d, wt, g, part, B, geo, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int wgrad(const void* in, const void* dz, const uint8_t* dz_bits, float* part,
          int B, int Cin, int Cout, int H, int W, int Hz, int Wz, int K, int S,
          int OFF, int R, int sg, int mw, int gm, cudaStream_t st) {
  if (Hz != S * H || Wz != S * W) return cudaErrorInvalidValue;
  const auto* i = static_cast<const T*>(in);
  const auto* d = static_cast<const T*>(dz);
  if (S == 2) {  // T = dz's phase planes, P = the input
    const WgGeom g{Cout, Cin, K, H, W, S, OFF, 0, 0, 0, R, sg, mw, gm};
    return launch_wgrad<T, false>(WgPlaneT<T>{d, Cout, Hz, Wz}, WgPlainP<T>{i},
                                  part, B, g, st);
  }
  const WgGeom g{Cin, Cout, K, H, W, S, OFF, 0, 0, 0, R, sg, mw, gm};
  const WgPlaneT<T> src{i, Cin, H, W};
  if (dz_bits == nullptr)
    return launch_wgrad<T, true>(src, WgPlainP<T>{d}, part, B, g, st);
  return launch_wgrad<T, false>(src, WgRouteP<T>{d, dz_bits}, part, B, g, st);
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
// float32 runs conv_quad_kernel, bf16 conv_in_mma_kernel (W = 128).
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

// Forward 2.  in (B, Cin, H, W) -> out, bits (B, Cout, H/2, W/2).  float32
// runs conv_quad_kernel, w (Cin, K, K, Cout); bf16 conv_igemm_kernel, w
// (K, K, Cout, Cin).
extern "C" int ae_train_conv_pool(const void* in, const void* w,
                                  const float* bias, void* out, uint8_t* bits,
                                  int dtype, int B, int Cin, int Cout, int H,
                                  int W, int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == SX_F32)
    return launch_conv_quad<float, COB>(
        PlaneSrc<float, float>{static_cast<const float*>(in), nchw(Cin, H, W)}, w, bias,
        PoolMaskEpi{static_cast<float*>(out), bits, Cout, H / 2, W / 2}, B, Cin,
        Cout, H, W, K, st);
  if (dtype == SX_BF16)
    return launch_conv_igemm(
        IgPlaneSrc{static_cast<const __nv_bfloat16*>(in)}, w, bias,
        IgPoolMaskEpi{static_cast<__nv_bfloat16*>(out), bits, Cout, H / 2, W / 2}, B, Cin,
        Cout, H, W, K, st);
  return cudaErrorInvalidValue;
}

// Loss (K5).  e (B, Cin, H, W) in dtype, w (Cin, K, K, 1); y (B, H, W)
// float32 labels, tmask (B,) float32 -> logits (B, H, W) float32, dz
// (B, 1, H, W) in dtype, part (rows, 2): BCE, db5.  float32 runs
// conv_quad_kernel, rows = B * quad blocks; bf16 conv_out_mma_kernel (W =
// 128), rows = B * H / CO_BAND (ops/ae_train_kernel.py _loss_rows).
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

// Input gradient of a stride-1 'same' conv over an (H, W) grid.  w is the
// layer's kernel flipped and transposed: (Cz, K, K, Cout), or for a routed
// launch on the tensor cores (bf16, dz routed) (K, K, Cout, Cz).  dz_bits
// null: dz (B, Cz, H, W), gate = the layer input (relu), out = gated dz of
// the layer below (in bf16 Cz = 1: the out-conv).  Otherwise dz is routed
// from (B, Cz, H/2, W/2) values and dz_bits, gate = the routing bits of the
// pool below (B, Cout, H, W), out = the pooled gradient.  part (rows, Cout):
// bias grads, rows = B * quad blocks in float32, or on the tensor cores B *
// strips (ops/ae_train_kernel.py conv_igemm_rows, conv_in_rows).
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
// (K, K, Cout, Cz) = the Flax kernel with dz's channel fastest, out
// (B, Cout, H, W).  route 0: gate = the layer input (relu); 1: gate = pool
// routing bits.  part (rows = B * strips, Cout): bias grads.
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

// Weight gradient partials, part (B * sg, Cin, K, K, Cout) float32, one row
// per (tile, row group): in (B, Cin, H, W) in dtype; dz (B, Cout, Hz, Wz)
// in dtype, or routed from (B, Cout, Hz/2, Wz/2) values and dz_bits; S /
// OFF as wgrad_kernel; R, sg, mw, gm the plan (ops/ae_train_kernel.py
// wgrad_plan).
extern "C" int ae_train_wgrad(const void* in, const void* dz,
                              const uint8_t* dz_bits, float* part, int dtype,
                              int B, int Cin, int Cout, int H, int W, int Hz,
                              int Wz, int K, int S, int OFF, int R, int sg,
                              int mw, int gm, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  SX_DTYPE(dtype, (wgrad<T>(in, dz, dz_bits, part, B, Cin, Cout, H, W, Hz,
                            Wz, K, S, OFF, R, sg, mw, gm, st)));
}

// conv1's weight gradient partials (K5): x (B, H, W) float32 tiles rounded
// to dtype as loaded, dz routed from (B, Cout, H/2, W/2) and dz_bits.
extern "C" int ae_train_wgrad_x(const float* x, const void* dz,
                                const uint8_t* dz_bits, float* part, int dtype,
                                int B, int Cout, int H, int W, int K, int R,
                                int sg, int mw, int gm, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dz_bits == nullptr) return cudaErrorInvalidValue;
  const WgGeom g{1, Cout, K, H, W, 1, (K - 1) / 2, 0, 0, 0, R, sg, mw, gm};
  SX_DTYPE(dtype, (launch_wgrad<T, false>(
                      WgPlaneT<float>{x, 1, H, W},
                      WgRouteP<T>{static_cast<const T*>(dz), dz_bits}, part,
                      B, g, st)));
}

// The sums of count segments of partial rows, float32, each in a fixed
// order, in at most two launches.  seg[6 i ..] describes segment i: its
// partials (n, m), its output (m,), n, m, its slabs (ops/ae_train_kernel.py
// sum_slabs) and, for slabs > 1, the offset (in floats) of its (slabs, m)
// slab sums in scratch.  Pass 1 sums every segment's slabs (straight into
// the output where a segment has one slab); pass 2, for the segments with
// more than one slab, sums the slabs' sums in order.  Segment by segment
// this is the order of one call per segment.
extern "C" int ae_train_sum(const long long* seg, int count, float* scratch, void* stream) {
  if (count < 1 || count > SUM_SEGS) return cudaErrorInvalidValue;
  SumTable one{}, two{};
  int blocks1 = 0, blocks2 = 0;
  for (int i = 0; i < count; ++i) {
    const long long* e = seg + 6 * i;
    const int n = (int)e[2], m = (int)e[3], slabs = (int)e[4];
    if (e[0] == 0 || e[1] == 0 || n < 1 || m < 1 || slabs < 1 || slabs > n ||
        (slabs > 1 && (scratch == nullptr || e[5] < 0)))
      return cudaErrorInvalidValue;
    const auto* part = reinterpret_cast<const float*>(e[0]);
    auto* out = reinterpret_cast<float*>(e[1]);
    const int groups = (m + 31) / 32;
    float* slab_sums = slabs > 1 ? scratch + e[5] : out;
    one.seg[one.count++] = SumSeg{part, slab_sums, n, m, slabs, blocks1};
    blocks1 += groups * slabs;
    if (slabs > 1) {
      two.seg[two.count++] = SumSeg{slab_sums, out, slabs, m, 1, blocks2};
      blocks2 += groups;
    }
  }
  auto st = static_cast<cudaStream_t>(stream);
  sum_rows_kernel<<<blocks1, 32 * SUM_WARPS, 0, st>>>(one);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || two.count == 0) return err;
  sum_rows_kernel<<<blocks2, 32 * SUM_WARPS, 0, st>>>(two);
  return cudaGetLastError();
}
