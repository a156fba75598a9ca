// K2 + K3 + K4: depth-2 conv-autoencoder inference, for Hopper (sm_90a).
//
// Replaces, on the serving path (ae_kernel_enhance_specs):
//   K2 specenh/ops/parity_turn.py:_make_turn_in_kernel  (specs_to_x16_2d:
//      patch + bf16 cast into the AE kernel's layout)
//   K3 specenh/ops/ae_kernel.py:_make_kernel            (_pallas_ae: the
//      whole AE, activations resident in VMEM)
//   K4 specenh/ops/parity_turn.py:_make_turn_out_kernel (o16_2d_to_specs:
//      unpatch of the f32 output)
//
// The TPU kernel kept a tile's activations in up to 64 MiB of VMEM, in a
// parity-plane layout built for Mosaic.  A Hopper block has 227 KB of
// shared memory, so here each stage is its own kernel and activations go
// through device memory, NCHW per tile, in the service dtype (bf16 or
// float32), always accumulated in float32:
//
//   ae_tile_in    S1 = K2 + conv1 + relu + maxpool2: reads tile (c, j)
//                 straight from the (C, 256, T) spectrograms, columns
//                 j*128 .. j*128+127, rounds to the service dtype; 'same'
//                 zero padding at the tile's border (the reference patches
//                 before it convolves, so no neighbour columns leak in).
//   ae_conv_pool  S2 = conv2 + relu + maxpool2.
//   ae_convt_relu S3 = Flax 'SAME' stride-2 transposed conv + relu (twice).
//   ae_tile_out   S4 = out-conv (C1 -> 1) + sigmoid, written straight into
//                 the restitched (C, 256, k*128) float32 output: K4.
//
// What bounds it on this card: ~189 M MAC per 256x128 tile (conv2 and the
// second transposed conv are 75 M each), 600 tiles a shot: ~226 GFLOP of
// FMA on the CUDA cores, and ~3.5 GB of bf16 activation traffic (the
// largest, the second convT output, is 1.26 GB).  Compute first.
//
// Design: direct convolution, one thread per 2x2 quad of output pixels and
// 16 output channels (64 float accumulators).  The thread loads the
// (K+1)x(K+1) input patch its quad needs into registers once per input
// channel, so each load feeds 4*K*K*16/((K+1)^2) FMAs; the weights of 8
// input channels at a time are staged in shared memory as float and read
// as warp-wide broadcasts.  Kernel size is a template argument (1, 3, 5,
// 7), channel counts are runtime: every geometry ae_kernel.supports()
// accepts.  No tensor cores yet: wgmma, TMA and fusing the stages with
// halo recompute are later work.

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

enum Epilogue { EPI_POOL = 0, EPI_SIGMOID = 1 };

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
// {0, 1}, for CB output channels; then either bias + relu + 2x2 max pool
// (EPI_POOL, output (m, n) in TOUT) or, with one output channel, bias +
// sigmoid of each quad pixel (EPI_SIGMOID, float output).
template <typename TIN, typename TACT, typename TOUT, int K, int CB, int EPI>
__global__ void __launch_bounds__(NT) conv_quad_kernel(
    const TIN* __restrict__ in, Plane src, const TACT* __restrict__ w,
    const float* __restrict__ bias, TOUT* __restrict__ out, Plane dst,
    int Cin, int Cout, int H, int W) {
  constexpr int R = (K - 1) / 2;
  constexpr int P = K + 1;
  __shared__ float ws[CC][K * K][CB];

  const int wq = W / 2;
  const int pos = blockIdx.x * NT + threadIdx.x;
  const bool active = pos < (H / 2) * wq;
  const int m = pos / wq, n = pos % wq;
  const int co0 = blockIdx.y * CB;
  const int b = blockIdx.z;
  const TIN* inb = in + src.base(b);

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
      const TIN* pl = inb + (long long)(c0 + cc) * src.chan;
      float p[P][P];
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int y = 2 * m - R + r;
#pragma unroll
        for (int s = 0; s < P; ++s) {
          const int xx = 2 * n - R + s;
          p[r][s] = (y >= 0 && y < H && xx >= 0 && xx < W)
                        ? sx_round<TACT>(sx_load(pl + (long long)y * src.ld + xx))
                        : 0.f;
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
  if (!active) return;

  TOUT* ob = out + dst.base(b);
  if constexpr (EPI == EPI_POOL) {
#pragma unroll
    for (int co = 0; co < CB; ++co) {
      // max(z_q + bias) == max(z_q) + bias, and relu commutes with max
      const float z = fmaxf(fmaxf(acc[0][co], acc[1][co]),
                            fmaxf(acc[2][co], acc[3][co])) + bias[co0 + co];
      ob[(long long)(co0 + co) * dst.chan + (long long)m * dst.ld + n] =
          sx_cast<TOUT>(fmaxf(z, 0.f));
    }
  } else {
    const float bv = bias[0];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float z = acc[q][0] + bv;
      ob[(long long)(2 * m + q / 2) * dst.ld + 2 * n + q % 2] =
          sx_cast<TOUT>(1.f / (1.f + expf(-z)));
    }
  }
}

// Flax nn.ConvTranspose (transpose_kernel=False), stride 2, 'SAME', + bias
// + relu: out[y] = sum_i x[(y + i - PA) / 2] * w[i] over the taps i where
// y + i - PA is even and the source row exists, PA = jax.lax's pad_a.  One
// thread per input position (m, n) computes the output quad (2m+a, 2n+b):
// every tap lands on exactly one quad pixel, and the sources lie in rows
// and columns m + DMIN .. m + DMAX.
template <typename T, int K>
__global__ void __launch_bounds__(NT) convt_relu_kernel(
    const T* __restrict__ in, const T* __restrict__ w,
    const float* __restrict__ bias, T* __restrict__ out, int Cin, int Cout,
    int H, int W) {
  constexpr int PA = (2 > K - 1) ? K - 1 : (K + 1) / 2;
  constexpr int DMIN = -(PA / 2);
  constexpr int DMAX = (K - PA) / 2;
  constexpr int NR = DMAX - DMIN + 1;
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

template <typename TIN, typename TACT, typename TOUT, int CB, int EPI>
int launch_conv_quad(const void* in, Plane src, const void* w,
                     const float* bias, void* out, Plane dst, int B, int Cin,
                     int Cout, int H, int W, int K, cudaStream_t st) {
  if (Cout % CB != 0 || H % 2 != 0 || W % 2 != 0 || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(((H / 2) * (W / 2) + NT - 1) / NT, Cout / CB, B);
  const auto* i = static_cast<const TIN*>(in);
  const auto* wt = static_cast<const TACT*>(w);
  auto* o = static_cast<TOUT*>(out);
  switch (K) {
#define SX_CASE(KK)                                                          \
  case KK:                                                                   \
    conv_quad_kernel<TIN, TACT, TOUT, KK, CB, EPI>                           \
        <<<grid, NT, 0, st>>>(i, src, wt, bias, o, dst, Cin, Cout, H, W);    \
    break;
    SX_CASE(1) SX_CASE(3) SX_CASE(5) SX_CASE(7)
#undef SX_CASE
    default:
      return cudaErrorInvalidValue;
  }
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
  switch (K) {
#define SX_CASE(KK)                                                          \
  case KK:                                                                   \
    convt_relu_kernel<T, KK><<<grid, NT, 0, st>>>(i, wt, bias, o, Cin, Cout, \
                                                  H, W);                     \
    break;
    SX_CASE(1) SX_CASE(3) SX_CASE(5) SX_CASE(7)
#undef SX_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

Plane nchw(int C, int H, int W) {
  return Plane{(long long)C * H * W, 0, (long long)H * W, W, 1};
}

}  // namespace

// S1.  specs: (C, H, >= kt*W) float32, tile b = (b / kt, b % kt) at columns
// (b % kt) * W ..; spec_outer / spec_ld are its channel and row strides.
// out: (B, Cout, H/2, W/2) in dtype.  w: (1, K, K, Cout) in dtype.
extern "C" int ae_tile_in(const float* specs, int kt, long long spec_outer,
                          long long spec_ld, const void* w, const float* bias,
                          void* out, int dtype, int B, int Cout, int H, int W,
                          int K, void* stream) {
  const Plane src{spec_outer, W, 0, spec_ld, kt};
  const Plane dst = nchw(Cout, H / 2, W / 2);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == SX_F32)
    return launch_conv_quad<float, float, float, COB, EPI_POOL>(
        specs, src, w, bias, out, dst, B, 1, Cout, H, W, K, st);
  if (dtype == SX_BF16)
    return launch_conv_quad<float, __nv_bfloat16, __nv_bfloat16, COB, EPI_POOL>(
        specs, src, w, bias, out, dst, B, 1, Cout, H, W, K, st);
  return cudaErrorInvalidValue;
}

// S2.  in: (B, Cin, H, W), out: (B, Cout, H/2, W/2), w: (Cin, K, K, Cout),
// all in dtype.
extern "C" int ae_conv_pool(const void* in, const void* w, const float* bias,
                            void* out, int dtype, int B, int Cin, int Cout,
                            int H, int W, int K, void* stream) {
  const Plane src = nchw(Cin, H, W);
  const Plane dst = nchw(Cout, H / 2, W / 2);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == SX_F32)
    return launch_conv_quad<float, float, float, COB, EPI_POOL>(
        in, src, w, bias, out, dst, B, Cin, Cout, H, W, K, st);
  if (dtype == SX_BF16)
    return launch_conv_quad<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, COB,
                            EPI_POOL>(in, src, w, bias, out, dst, B, Cin, Cout,
                                      H, W, K, st);
  return cudaErrorInvalidValue;
}

// S3.  in: (B, Cin, H, W), out: (B, Cout, 2H, 2W), w: (Cin, K, K, Cout), the
// Flax kernel unflipped; all in dtype.
extern "C" int ae_convt_relu(const void* in, const void* w, const float* bias,
                             void* out, int dtype, int B, int Cin, int Cout,
                             int H, int W, int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == SX_F32)
    return launch_convt<float>(in, w, bias, out, B, Cin, Cout, H, W, K, st);
  if (dtype == SX_BF16)
    return launch_convt<__nv_bfloat16>(in, w, bias, out, B, Cin, Cout, H, W, K,
                                       st);
  return cudaErrorInvalidValue;
}

// S4.  in: (B, Cin, H, W) in dtype, w: (Cin, K, K, 1) in dtype.  out:
// float32 (B / kt, H, >= kt*W) restitched, channel and row strides
// out_outer / out_ld; tile b lands at columns (b % kt) * W ..
extern "C" int ae_tile_out(const void* in, const void* w, const float* bias,
                           float* out, int kt, long long out_outer,
                           long long out_ld, int dtype, int B, int Cin, int H,
                           int W, int K, void* stream) {
  const Plane src = nchw(Cin, H, W);
  const Plane dst{out_outer, W, 0, out_ld, kt};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == SX_F32)
    return launch_conv_quad<float, float, float, 1, EPI_SIGMOID>(
        in, src, w, bias, out, dst, B, Cin, 1, H, W, K, st);
  if (dtype == SX_BF16)
    return launch_conv_quad<__nv_bfloat16, __nv_bfloat16, float, 1,
                            EPI_SIGMOID>(in, src, w, bias, out, dst, B, Cin, 1,
                                         H, W, K, st);
  return cudaErrorInvalidValue;
}
