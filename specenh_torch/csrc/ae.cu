// K2 + K3 + K4 and K8-in + K6 + K8-out: conv-autoencoder inference at depth
// 2 and 3, for Hopper (sm_90a).
//
// Replaces, on the serving path (ae_kernel_enhance_specs):
//   K2 specenh/ops/parity_turn.py:_make_turn_in_kernel  (specs_to_x16_2d:
//      patch + bf16 cast into the AE kernel's layout)
//   K9 specenh/ops/stft_fused.py:_make_turn_tf_kernel   (specs_tf_to_x16_2d)
//   K10 specenh/ops/stft_fused.py:_make_turn_ft_norm_kernel
//      (specs_ft_to_x16_2d: K2 fed the raw log-PSD in the (T, F) or the
//      (F, T) layout, min-max normalized in the turn), as ae_tile_in_norm
//      on ae_kernel_enhance_raw, stft_mode="fused"
//   K3 specenh/ops/ae_kernel.py:_make_kernel            (_pallas_ae: the
//      whole AE, activations resident in VMEM)
//   K4 specenh/ops/parity_turn.py:_make_turn_out_kernel (o16_2d_to_specs:
//      unpatch of the f32 output)
// and their depth-3 counterparts (ops/ae3_kernel.py):
//   K8-in  specenh/ops/parity_turn.py:_make_turn3_in_kernel (specs_to_x64_2d)
//   K6     specenh/ops/ae3_kernel.py:_make_kernel3           (_pallas_ae3)
//   K8-out specenh/ops/parity_turn.py:_make_turn3_out_kernel (o64_2d_to_specs)
// The stages below are generic in channels and kernel size; the Python side
// runs them over the layer table of either depth (one S1, d-1 S2, d S3, one
// S4).
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
//   ae_tile_in_norm  S1 on the raw log-PSD, in either layout, normalized as
//                 the block stages it in shared memory (K9, K10): in bf16
//                 the same template and the same bits as ae_tile_in on the
//                 normalized spectrograms.
//   ae_conv_pool  S2 = conv2 (and conv3 at depth 3) + relu + maxpool2.
//   ae_convt_relu S3 = Flax 'SAME' stride-2 transposed conv + relu (once per
//                 level).
//   ae_tile_out   S4 = out-conv (C1 -> 1) + sigmoid, written straight into
//                 the restitched (C, 256, k*128) float32 output: K4.
//
// What bounds it on this card: ~189 M MAC per 256x128 tile (conv2 and the
// second transposed conv are 75 M each), 600 tiles a shot: ~226 GFLOP of
// FMA on the CUDA cores, and ~3.5 GB of bf16 activation traffic (the
// largest, the second convT output, is 1.26 GB).  Compute first.  deep3
// (16/32/64, k5) does ~498 M MAC per tile, ~598 GFLOP a shot, and moves
// ~2.9 GB.
//
// Design, float32 (every stage but S3): conv_quad_kernel, a direct
// convolution, one thread per 2x2 quad of output pixels and 16 output
// channels (64 float accumulators), the (K+1)x(K+1) input patch of its quad
// in registers once per input channel, the weights of 8 input channels at a
// time staged in shared memory as float; float32 S3 convt_relu_kernel.
// bf16, on the tensor cores (mma.sync): S1 conv_in_mma_kernel, one GEMM
// whose K is the taps (in pairs of horizontal neighbours, one 32-bit word of
// the staged window each), pooled in registers, out through shared memory in
// 16-byte runs; S2 conv_igemm_kernel, an implicit GEMM over strips of a tile
// staged once per 16-channel chunk, pooled in registers; S3
// convt_igemm_kernel, four such GEMMs (one per output parity) over one
// staged strip; S4 conv_out_mma_kernel, one GEMM an output row (K: tap rows
// x channels, N: a row's taps) over its input streamed once with cp.async,
// the taps' column shifts summed in float32 afterwards.  Kernel size is a
// template argument (1, 3, 5, 7), channel counts are runtime for float32
// and a template argument for bf16: every geometry ae_kernel.supports()
// and supports3() accept.  wgmma, TMA and fusing the stages with halo
// recompute are later work.  The kernel templates live in ae_conv.cuh,
// shared with the training stages (ae_train.cu).

#include "ae_conv.cuh"

namespace {

// The float32 S1 / S2: bias + relu + 2x2 max pool of the quad, output (m,
// n).
template <int CB>
struct PoolEpi {
  float* out;
  Plane dst;
  __device__ __forceinline__ void operator()(float (&acc)[4][CB],
                                             const float* bias, bool active,
                                             int b, int m, int n,
                                             int co0) const {
    if (!active) return;
    float* ob = out + dst.base(b);
#pragma unroll
    for (int co = 0; co < CB; ++co) {
      // max(z_q + bias) == max(z_q) + bias, and relu commutes with max
      const float z = fmaxf(fmaxf(acc[0][co], acc[1][co]),
                            fmaxf(acc[2][co], acc[3][co])) + bias[co0 + co];
      ob[(long long)(co0 + co) * dst.chan + (long long)m * dst.ld + n] = fmaxf(z, 0.f);
    }
  }
};

// S2 on the tensor cores (conv_igemm_kernel): PoolEpi's bias + relu + 2x2
// max pool, the window being the thread's two positions in its two
// fragments; out (B, Cout, h2, w2) bf16.
struct IgPoolEpi {
  __nv_bfloat16* out;
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
        const float z = fmaxf(fmaxf(acc[0][n][e], acc[0][n][2 + e]),
                              fmaxf(acc[1][n][e], acc[1][n][2 + e])) + bias[co];
        out[((long long)b * Cout + co) * h2 * w2 + pix] = __float2bfloat16_rn(fmaxf(z, 0.f));
      }
  }
};

// The bf16 S1: conv_in_mma_kernel from src, out 16-byte aligned.
int launch_tile_in(CiSpecSrc src, const void* w, const float* bias, void* out, int B, int Cout,
                   int H, int W, int K, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return cudaErrorInvalidValue;
  return launch_conv_in(src, w, bias, CiPoolEpi{static_cast<__nv_bfloat16*>(out)}, B, Cout, H,
                        W, K, st);
}

// The float32 S4: one output channel, bias + sigmoid of each quad pixel,
// float output (CoSigmoidEpi computes the sigmoid the same way).
struct SigmoidEpi {
  float* out;
  Plane dst;
  __device__ __forceinline__ void operator()(float (&acc)[4][1],
                                             const float* bias, bool active,
                                             int b, int m, int n, int) const {
    if (!active) return;
    float* ob = out + dst.base(b);
    const float bv = bias[0];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float z = acc[q][0] + bv;
      ob[(long long)(2 * m + q / 2) * dst.ld + 2 * n + q % 2] =
          1.f / (1.f + expf(-z));
    }
  }
};

// The bf16 S4 on conv_out_mma_kernel: the sigmoid of logit z at pixel (y,
// x) of tile b, stored into the restitched float32 output (tile b at
// channel b / kt, columns (b % kt) * 128 ..; channel and row strides outer,
// ld) in 16-byte runs, 4 lanes' pixels gathered by shuffles.
struct CoSigmoidEpi {
  float* out;
  long long outer, ld;
  int kt;
  struct Tile {
    float* o;  // the tile's row 0 in the restitched output
    long long ld;
    __device__ __forceinline__ float pre(int, int) const { return 0.f; }
    __device__ __forceinline__ void put(float z, float, int y, int x, float (&)[2]) const {
      const float v = 1.f / (1.f + expf(-z));
      const float v1 = __shfl_down_sync(0xffffffffu, v, 1);
      const float v2 = __shfl_down_sync(0xffffffffu, v, 2);
      const float v3 = __shfl_down_sync(0xffffffffu, v, 3);
      if ((threadIdx.x & 3) == 0)
        *reinterpret_cast<float4*>(o + (long long)y * ld + x) = make_float4(v, v1, v2, v3);
    }
    __device__ __forceinline__ void end(float (&)[2]) const {}
  };
  __device__ __forceinline__ Tile tile(int b) const {
    return Tile{out + (long long)(b / kt) * outer + (long long)(b % kt) * CO_W, ld};
  }
};

// float32 S3: convt_relu_kernel.
int launch_convt(const float* in, const float* w, const float* bias, float* out, int B,
                 int Cin, int Cout, int H, int W, int K, cudaStream_t st) {
  if (Cout % COB != 0 || B < 1 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((H * W + NT - 1) / NT, Cout / COB, B);
  SX_K_SWITCH(K, convt_relu_kernel<KK><<<grid, NT, 0, st>>>(in, w, bias, out, Cin, Cout, H, W));
  return count_conv_launch(2);
}

// The launch: in 4-byte aligned, wt and out 16-byte aligned; K odd up to 7;
// Cin and Cout multiples of 16; W a multiple of 16 that divides 128
// (ct_strip_rows), H a multiple of the strip rows.  Returns
// cudaErrorInvalidValue for anything else: the caller raises.
int launch_convt_igemm(const void* in, const void* w, const float* bias, void* out, int B,
                       int Cin, int Cout, int H, int W, int K, cudaStream_t st) {
  const int R = ct_strip_rows(W);
  if (K < 1 || K > 7 || K % 2 == 0 || Cin < 16 || Cin % 16 != 0 || Cout < 16 ||
      Cout % 16 != 0 || R < 1 || H < R || H % R != 0 || H / R > 65535 || B < 1 || B > 65535 ||
      reinterpret_cast<uintptr_t>(in) % 4 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  const CtGeom g{Cin, Cout, H, W, R, 0, 0};
  const auto* i = static_cast<const __nv_bfloat16*>(in);
  const auto* wt = static_cast<const __nv_bfloat16*>(w);
  auto* o = static_cast<__nv_bfloat16*>(out);
  SX_K_SWITCH(K, return launch_convt_igemm_k<KK>(i, wt, bias, o, B, g, st));
  return cudaErrorInvalidValue;
}

// The bf16 S4, conv_out_mma_kernel with CoSigmoidEpi: out float32 (B /
// kt, H, >= kt * 128) with 16-byte aligned rows (out_outer and out_ld
// multiples of 4); otherwise as launch_conv_out.  Returns
// cudaErrorInvalidValue for anything else: the caller raises.
int launch_tile_out(const void* in, const void* w, const float* bias, float* out, int B, int Cin,
                    int H, int W, int K, int kt, long long out_outer, long long out_ld,
                    cudaStream_t st) {
  if (kt < 1 || out_outer % 4 != 0 || out_ld % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  return launch_conv_out(in, w, bias, CoSigmoidEpi{out, out_outer, out_ld, kt}, B, Cin, H, W, K,
                         st);
}

}  // namespace

// S1.  specs: (C, H, >= kt*W) float32, tile b = (b / kt, b % kt) at columns
// (b % kt) * W ..; spec_outer / spec_ld are its channel and row strides.
// out: (B, Cout, H/2, W/2) in dtype.  w: (1, K, K, Cout) in dtype.  float32
// runs conv_quad_kernel, bf16 conv_in_mma_kernel (W = 128).
extern "C" int ae_tile_in(const float* specs, int kt, long long spec_outer,
                          long long spec_ld, const void* w, const float* bias,
                          void* out, int dtype, int B, int Cout, int H, int W,
                          int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == SX_F32)
    return launch_conv_quad<float, COB>(
        PlaneSrc<float, float>{specs, Plane{spec_outer, W, 0, spec_ld, kt}}, w, bias,
        PoolEpi<COB>{static_cast<float*>(out), nchw(Cout, H / 2, W / 2)}, B, 1, Cout,
        H, W, K, st);
  if (dtype == SX_BF16)
    return launch_tile_in(CiSpecSrc{specs, nullptr, nullptr, spec_outer, spec_ld, 1, kt}, w,
                          bias, out, B, Cout, H, W, K, st);
  return cudaErrorInvalidValue;
}

// S1 on the raw log-PSD (K9 and K10, stft_mode="fused"): raw (C, >= H,
// >= kt*W) float32 read through frequency stride raw_fs and time stride
// raw_ts (the (F, T) layout of stft_logpsd, or the (T, F) layout of
// stft_logpsd_tf), normalized by the channel's min and max, mn and mx (C,)
// float32, as each block stages its input (float32: NormPlaneSrc on
// conv_quad_kernel; bf16: CiSpecSrc on conv_in_mma_kernel, the bits
// ae_tile_in stages from the normalized spectrograms); otherwise as
// ae_tile_in, for W = 128 and K <= 7.
extern "C" int ae_tile_in_norm(const float* raw, const float* mn,
                               const float* mx, int kt, long long raw_outer,
                               long long raw_fs, long long raw_ts,
                               const void* w, const float* bias, void* out,
                               int dtype, int B, int Cout, int H, int W, int K,
                               void* stream) {
  if (W != SW || K > 7) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == SX_F32)
    return launch_conv_quad<float, COB>(
        NormPlaneSrc{raw, mn, mx, raw_outer, raw_fs, raw_ts, kt, H, K},
        w, bias, PoolEpi<COB>{static_cast<float*>(out), nchw(Cout, H / 2, W / 2)}, B,
        1, Cout, H, W, K, st);
  if (dtype == SX_BF16)
    return launch_tile_in(CiSpecSrc{raw, mn, mx, raw_outer, raw_fs, raw_ts, kt}, w, bias, out,
                          B, Cout, H, W, K, st);
  return cudaErrorInvalidValue;
}

// S2.  in: (B, Cin, H, W), out: (B, Cout, H/2, W/2), all in dtype.  float32
// runs conv_quad_kernel, w (Cin, K, K, Cout); bf16 conv_igemm_kernel, w
// (K, K, Cout, Cin).
extern "C" int ae_conv_pool(const void* in, const void* w, const float* bias,
                            void* out, int dtype, int B, int Cin, int Cout,
                            int H, int W, int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == SX_F32)
    return launch_conv_quad<float, COB>(
        PlaneSrc<float, float>{static_cast<const float*>(in), nchw(Cin, H, W)}, w, bias,
        PoolEpi<COB>{static_cast<float*>(out), nchw(Cout, H / 2, W / 2)}, B, Cin,
        Cout, H, W, K, st);
  if (dtype == SX_BF16)
    return launch_conv_igemm(
        IgPlaneSrc{static_cast<const __nv_bfloat16*>(in)}, w, bias,
        IgPoolEpi{static_cast<__nv_bfloat16*>(out), Cout, H / 2, W / 2}, B, Cin,
        Cout, H, W, K, st);
  return cudaErrorInvalidValue;
}

// S3.  in: (B, Cin, H, W), out: (B, Cout, 2H, 2W), all in dtype.  float32
// runs convt_relu_kernel, w (Cin, K, K, Cout), the Flax kernel unflipped;
// bf16 convt_igemm_kernel, w (K, K, Cout, Cin).
extern "C" int ae_convt_relu(const void* in, const void* w, const float* bias,
                             void* out, int dtype, int B, int Cin, int Cout,
                             int H, int W, int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == SX_F32)
    return launch_convt(static_cast<const float*>(in), static_cast<const float*>(w), bias,
                        static_cast<float*>(out), B, Cin, Cout, H, W, K, st);
  if (dtype == SX_BF16)
    return launch_convt_igemm(in, w, bias, out, B, Cin, Cout, H, W, K, st);
  return cudaErrorInvalidValue;
}

// S4.  in: (B, Cin, H, W) in dtype, w: (Cin, K, K, 1) in dtype.  out:
// float32 (B / kt, H, >= kt*W) restitched, channel and row strides
// out_outer / out_ld; tile b lands at columns (b % kt) * W ..  float32 runs
// conv_quad_kernel with SigmoidEpi; bf16 conv_out_mma_kernel (W = 128).
extern "C" int ae_tile_out(const void* in, const void* w, const float* bias,
                           float* out, int kt, long long out_outer,
                           long long out_ld, int dtype, int B, int Cin, int H,
                           int W, int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == SX_F32)
    return launch_conv_quad<float, 1>(
        PlaneSrc<float, float>{static_cast<const float*>(in), nchw(Cin, H, W)}, w, bias,
        SigmoidEpi{out, Plane{out_outer, W, 0, out_ld, kt}}, B, Cin, 1, H, W, K, st);
  if (dtype == SX_BF16)
    return launch_tile_out(in, w, bias, out, B, Cin, H, W, K, kt, out_outer, out_ld, st);
  return cudaErrorInvalidValue;
}
