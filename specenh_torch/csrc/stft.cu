// K1: STFT log-PSD with per-block min/max partials, for Hopper (sm_90a).
//
// Replaces specenh/ops/stft_fused.py:_stft_tf_kernel (called through
// _stft_log, stft_ft_log and spectrogram_fused), the serving path's STFT.
//
// Math: frame t of channel c is x[c, hop*t : hop*t + nperseg].  Its
// detrended, windowed one-sided DFT is one row of frames @ [Br | Bi], with
// the basis built once in float64 on the host (detrend projection x
// periodic Hamming x DFT) and passed as float32.  The kernel writes
//   out[c, f, t] = logf((re^2 + im^2) * w[f] + eps)
// in the (F, T) layout with T contiguous, and one (min, max) pair per block
// over its valid frames and all one-sided rows, Nyquist included (the
// reference normalizes before dropping Nyquist).  Blocks run in no order,
// so the per-channel reduction of the partials, the normalization and the
// Nyquist drop are a second step, in the Python wrapper.
//
// What bounds it on this card: 20 channels x 3905 frames x 512 samples x
// 640 basis columns (257 re + 257 im, each padded to 320) x 2 = 51 GFLOP
// of float32 FMA per shot, against 80 MB of trace read and 80 MB written:
// compute on the CUDA cores.  The operands stay float32 (bf16 operands
// cost spectrogram SSIM, and TF32 tensor-core inputs would drop the same
// digits), so the tensor cores are not used.
//
// Design: a register-tiled SGEMM.  A block owns 64 frames x 64 frequencies
// of one channel, 256 threads, 4 frames x 4 frequencies x (re, im) = 32
// accumulators each.  Overlapping frames are read straight from the trace
// into shared memory, 16 samples of the K loop at a time; the TPU kernel's
// split basis and 8-row roll are not needed.  The log, the weights and the
// min/max are the epilogue, computed from registers.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;  // frames per block
constexpr int BN = 64;  // frequencies per block (a re and an im column each)
constexpr int BK = 16;  // samples per step of the K loop
constexpr int TM = 4;   // frames per thread: t0 + tx + 16 * i
constexpr int TN = 4;   // frequencies per thread: f0 + ty * TN + j
constexpr int NTX = BM / TM;            // 16
constexpr int NT = NTX * (BN / TN);     // 256 threads

__global__ void __launch_bounds__(NT) stft_logpsd_kernel(
    const float* __restrict__ x, long long x_stride, int hop, int nperseg,
    int n_frames, int n_freqs, int fpad, const float* __restrict__ basis,
    const float* __restrict__ weight, float eps, float* __restrict__ out,
    float* __restrict__ partials) {
  __shared__ float as[BK][BM + 1];  // +1: conflict-free transposed stores
  __shared__ float brs[BK][BN];
  __shared__ float bis[BK][BN];
  __shared__ float red[2][NT / 32];

  const int c = blockIdx.z;
  const int t0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;
  const float* xc = x + c * x_stride;

  float acc_r[TM][TN], acc_i[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_r[i][j] = 0.f;
      acc_i[i][j] = 0.f;
    }

  for (int k0 = 0; k0 < nperseg; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int t = e / BK, k = e % BK;
      const int tg = t0 + t;
      as[k][t] = tg < n_frames ? xc[(long long)tg * hop + k0 + k] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int k = e / BN, f = e % BN;
      const float* row = basis + (long long)(k0 + k) * 2 * fpad + f0 + f;
      brs[k][f] = row[0];
      bis[k][f] = row[fpad];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], br[TN], bi[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[k][tx + NTX * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        br[j] = brs[k][ty * TN + j];
        bi[j] = bis[k][ty * TN + j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_r[i][j] = fmaf(a[i], br[j], acc_r[i][j]);
          acc_i[i][j] = fmaf(a[i], bi[j], acc_i[i][j]);
        }
    }
    __syncthreads();
  }

  float mn = INFINITY, mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int f = f0 + ty * TN + j;
    if (f >= n_freqs) continue;
    const float w = weight[f];
    float* orow = out + ((long long)c * n_freqs + f) * n_frames;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int t = t0 + tx + NTX * i;
      if (t >= n_frames) continue;
      const float psd = acc_r[i][j] * acc_r[i][j] + acc_i[i][j] * acc_i[i][j];
      const float v = logf(psd * w + eps);
      orow[t] = v;
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if (tid % 32 == 0) {
    red[0][tid / 32] = mn;
    red[1][tid / 32] = mx;
  }
  __syncthreads();
  if (tid == 0) {
    for (int wi = 1; wi < NT / 32; ++wi) {
      mn = fminf(mn, red[0][wi]);
      mx = fmaxf(mx, red[1][wi]);
    }
    float* p = partials +
        (((long long)c * gridDim.x + blockIdx.x) * gridDim.y + blockIdx.y) * 2;
    p[0] = mn;
    p[1] = mx;
  }
}

}  // namespace

// x: (C, >= (n_frames-1)*hop + nperseg) float32 traces, row stride x_stride.
// basis: (nperseg, 2 * fpad) float32, [Br | Bi] with zero columns past
// n_freqs.  weight: (n_freqs,) one-sided PSD weights.  out: (C, n_freqs,
// n_frames).  partials: (C, ceil(n_frames/64), fpad/64, 2) (min, max).
extern "C" int stft_logpsd(const float* x, long long x_stride, int C, int hop,
                           int nperseg, int n_frames, int n_freqs, int fpad,
                           const float* basis, const float* weight, float eps,
                           float* out, float* partials, void* stream) {
  if (nperseg % BK != 0 || fpad % BN != 0 || fpad < n_freqs || C > 65535 ||
      n_frames < 1)
    return cudaErrorInvalidValue;
  const dim3 grid((n_frames + BM - 1) / BM, fpad / BN, C);
  stft_logpsd_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_stride, hop, nperseg, n_frames, n_freqs, fpad, basis, weight, eps,
      out, partials);
  return cudaGetLastError();
}
