// K1: STFT log-PSD with per-block min/max partials, for Hopper (sm_90a).
//
// Replaces specenh/ops/stft_fused.py:_stft_tf_kernel (called through
// _stft_log, stft_ft_log and spectrogram_fused), the serving path's STFT,
// and in its (T, F) form (stft_tf_log) the front of stft_mode="fused".
//
// Math: frame t of channel c is x[c, hop*t : hop*t + 512].  The kernel
// detrends it (linear: the least-squares line, as scipy.signal.detrend;
// constant: the mean; or none), windows it, takes its one-sided DFT and
// writes
//   out[c, f, t] = logf((re^2 + im^2) * w[f] + eps)
// in the (F, T) layout with T contiguous (stft_logpsd), or in the (T, F)
// layout with F contiguous (stft_logpsd_tf), and one (min, max) pair per
// block over its valid frames and all 257 one-sided rows, Nyquist included
// (the reference normalizes before dropping Nyquist).  Blocks run in no
// order, so the per-channel reduction of the partials, the normalization
// and the Nyquist drop are a second step, in the Python wrapper.
//
// What bounds it on this card: the FFT of a shot's 20 x 3905 frames is
// ~1.3 GFLOP of float32, 0.02 ms on the CUDA cores, against 80 MB of trace
// read and 80 MB of log-PSD written, 0.048 ms at 3.35 TB/s: bytes.  (The
// first design was a dense DFT as a float32 GEMM, 51 GFLOP a shot.)  The
// arithmetic stays float32: bf16 operands cost spectrogram SSIM, and the
// bins near eps are where two float32 algorithms already differ most.
//
// Design: a block owns one channel and TB = 16 consecutive frames, 16
// threads a frame.  It loads the frames' (TB + 1) hop blocks once (frames
// overlap by half: each sample is read once), into shared memory.  Per
// frame: the mean and the slope about the frame's centre as two reductions
// over the frame's 16 threads (the mean subtracted first, to limit
// cancellation; an xor-butterfly gives every thread the same bits), then
// the window.  The 512-point real FFT is a 256-point complex FFT of z[n] =
// x[2n] + i x[2n+1] as 16 x 16: thread j's 16-point DFT over z[j + 16 n2]
// in registers, the twiddles W256^(j k2), a transpose through padded shared
// memory, a second 16-point DFT; then the real-to-complex split X[k] =
// (Z[k] + Z*[256-k]) / 2 - i W512^k (Z[k] - Z*[256-k]) / 2.  Window and
// twiddles are tables computed on the host in float64 and passed as
// float32.  The log-PSD of the block's frames is staged in shared memory,
// and both layouts store along their contiguous dimension from there: the
// same arithmetic, so the (T, F) output is the (F, T) output transposed,
// bit for bit.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int N = 512;        // nperseg
constexpr int NH = N / 2;     // the complex FFT's length
constexpr int NF = NH + 1;    // one-sided bins
constexpr int TB = 16;        // frames per block
constexpr int TPF = 16;       // threads per frame
constexpr int NT = TB * TPF;  // 256 threads
constexpr int LDY = 17;       // padded row of the 16 x 16 transpose
constexpr int LDR = NF;       // a frame's row of the staged log-PSD (odd)
// the table: window (512), W256^k (cos, -sin) k < 256, W512^k (cos, -sin)
// k <= 256
constexpr int TAB_W = 0, TAB_C256 = N, TAB_S256 = N + NH, TAB_C512 = N + 2 * NH,
              TAB_S512 = N + 2 * NH + NF, TAB_N = N + 2 * NH + 2 * NF;
constexpr float S2 = 11184768.f;  // sum over the frame of (t - 255.5)^2
// the buffer: the samples ((TB + 1) hop blocks), the transposes (2 x 16 x
// LDY a frame) or the log-PSD (LDR a frame), whichever is largest
constexpr int BUF = 2 * TPF * LDY * TB > (TB + 1) * NH ? 2 * TPF * LDY * TB : (TB + 1) * NH;
constexpr int SMEM = (TAB_N + NF + 1 + 2 * (NT / 32) + BUF) * 4;
static_assert(TB * LDR <= BUF, "the log-PSD fits in the buffer");

// 16-point DFT in registers, radix 2, the input in natural order: the
// result in natural order.  Twiddles W16^m = W256^(16 m) from the table.
__device__ __forceinline__ void dft16(float (&re)[16], float (&im)[16],
                                      const float* tab) {
  // bit reversal of the 4-bit index
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = ((i & 1) << 3) | ((i & 2) << 1) | ((i & 4) >> 1) | ((i & 8) >> 3);
    if (r > i) {
      const float tr = re[i], ti = im[i];
      re[i] = re[r];
      im[i] = im[r];
      re[r] = tr;
      im[r] = ti;
    }
  }
#pragma unroll
  for (int len = 2; len <= 16; len <<= 1) {
#pragma unroll
    for (int i = 0; i < 16; i += len) {
#pragma unroll
      for (int j = 0; j < len / 2; ++j) {
        const int a = i + j, b = i + j + len / 2;
        float vr = re[b], vi = im[b];
        if (j != 0) {
          const int k = j * (NH / len);
          const float c = tab[TAB_C256 + k], s = tab[TAB_S256 + k];
          const float tr = vr * c - vi * s;
          vi = vr * s + vi * c;
          vr = tr;
        }
        re[b] = re[a] - vr;
        im[b] = im[a] - vi;
        re[a] += vr;
        im[a] += vi;
      }
    }
  }
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// TF_OUT false: out[c, f, t] at out + c * out_c + f * out_ld + t.  TF_OUT
// true: out[c, t, f] at out + c * out_c + t * out_ld + f.
template <bool TF_OUT>
__global__ void __launch_bounds__(NT) stft_logpsd_kernel(
    const float* __restrict__ x, long long x_stride, int hop, int n_frames,
    int detrend, const float* __restrict__ table, const float* __restrict__ weight,
    float eps, float* __restrict__ out, long long out_c, long long out_ld,
    float* __restrict__ partials) {
  // dynamic: the table, the weights, the warps' min/max, and one buffer
  // that holds the block's samples, then the frames' 16 x 16 transposes,
  // then their log-PSD rows
  extern __shared__ float smem[];
  float* tab = smem;
  float* wts = tab + TAB_N;
  float* red = wts + NF + 1;  // [2][NT / 32]
  float* buf = red + 2 * (NT / 32);

  const int c = blockIdx.y, t0 = blockIdx.x * TB, tid = threadIdx.x;
  const int fr = tid / TPF, j = tid % TPF;  // frame of the block, its thread
  const int nvalid = min(TB, n_frames - t0);
  const float* xc = x + c * x_stride + (long long)t0 * hop;
  for (int e = tid; e < TAB_N; e += NT) tab[e] = table[e];
  for (int e = tid; e < NF; e += NT) wts[e] = weight[e];
  const int nload = (nvalid - 1) * hop + N;
  for (int e = tid; e < (TB - 1) * hop + N; e += NT) buf[e] = e < nload ? xc[e] : 0.f;
  __syncthreads();

  // thread j holds samples 2 (j + 16 n2) + {0, 1} of its frame, n2 < 16
  const float* xf = buf + fr * hop;
  float re[16], im[16];
#pragma unroll
  for (int n2 = 0; n2 < 16; ++n2) {
    const int s = 2 * (j + 16 * n2);
    re[n2] = xf[s];
    im[n2] = xf[s + 1];
  }
  __syncthreads();  // the samples are in registers: buf takes the transposes
  if (detrend > 0) {
    float s = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < 16; ++n2) s += re[n2] + im[n2];
    const float mean = sum16(s) / (float)N;
#pragma unroll
    for (int n2 = 0; n2 < 16; ++n2) {
      re[n2] -= mean;
      im[n2] -= mean;
    }
    if (detrend > 1) {
      float m = 0.f;
#pragma unroll
      for (int n2 = 0; n2 < 16; ++n2) {
        const float tc = (float)(2 * (j + 16 * n2)) - 255.5f;
        m = fmaf(re[n2], tc, m);
        m = fmaf(im[n2], tc + 1.f, m);
      }
      const float slope = sum16(m) / S2;
#pragma unroll
      for (int n2 = 0; n2 < 16; ++n2) {
        const float tc = (float)(2 * (j + 16 * n2)) - 255.5f;
        re[n2] = fmaf(-slope, tc, re[n2]);
        im[n2] = fmaf(-slope, tc + 1.f, im[n2]);
      }
    }
  }
#pragma unroll
  for (int n2 = 0; n2 < 16; ++n2) {
    const int s = 2 * (j + 16 * n2);
    re[n2] *= tab[TAB_W + s];
    im[n2] *= tab[TAB_W + s + 1];
  }

  // Z[k2 + 16 k1] = sum_n1 W16^(n1 k1) W256^(n1 k2) sum_n2 W16^(n2 k2) z[n1 + 16 n2]
  dft16(re, im, tab);
  float* ar = buf + fr * 2 * TPF * LDY;
  float* ai = ar + TPF * LDY;
#pragma unroll
  for (int k2 = 0; k2 < 16; ++k2) {
    float vr = re[k2], vi = im[k2];
    const int k = j * k2;  // < 256
    if (k != 0) {
      const float cw = tab[TAB_C256 + k], sw = tab[TAB_S256 + k];
      const float tr = vr * cw - vi * sw;
      vi = vr * sw + vi * cw;
      vr = tr;
    }
    ar[j * LDY + k2] = vr;
    ai[j * LDY + k2] = vi;
  }
  __syncwarp();
#pragma unroll
  for (int n1 = 0; n1 < 16; ++n1) {
    re[n1] = ar[n1 * LDY + j];
    im[n1] = ai[n1 * LDY + j];
  }
  dft16(re, im, tab);  // thread j now holds Z[j + 16 k1], k1 < 16
  __syncwarp();
#pragma unroll
  for (int k1 = 0; k1 < 16; ++k1) {
    ar[j + 16 * k1] = re[k1];
    ai[j + 16 * k1] = im[k1];
  }
  __syncwarp();  // a frame's 16 threads are one half of a warp

  float v[17];  // the log-PSD of bins j + 16 k1, and Nyquist (j = 0)
  float mn = INFINITY, mx = -INFINITY;
  const bool valid = fr < nvalid;
#pragma unroll
  for (int k1 = 0; k1 < 16; ++k1) {
    const int k = j + 16 * k1;
    const int kb = (NH - k) & (NH - 1);  // Z[256 - k], Z[256] = Z[0]
    const float zr = re[k1], zi = im[k1], br = ar[kb], bi = ai[kb];
    const float fer = 0.5f * (zr + br), fei = 0.5f * (zi - bi);
    const float for_ = 0.5f * (zi + bi), foi = 0.5f * (br - zr);
    const float wc = tab[TAB_C512 + k], ws = tab[TAB_S512 + k];
    const float xr = fer + (wc * for_ - ws * foi);
    const float xi = fei + (wc * foi + ws * for_);
    v[k1] = logf((xr * xr + xi * xi) * wts[k] + eps);
    if (valid) {
      mn = fminf(mn, v[k1]);
      mx = fmaxf(mx, v[k1]);
    }
  }
  {  // Nyquist: X[256] = Re Z[0] - Im Z[0], with thread 0 of the frame
    const float xn = re[0] - im[0];
    v[16] = logf((xn * xn) * wts[NH] + eps);
    if (valid && j == 0) {
      mn = fminf(mn, v[16]);
      mx = fmaxf(mx, v[16]);
    }
  }
  __syncthreads();  // every frame's split is done: buf takes the log-PSD
  float* rs = buf + fr * LDR;
#pragma unroll
  for (int k1 = 0; k1 < 16; ++k1) rs[j + 16 * k1] = v[k1];
  if (j == 0) rs[NH] = v[16];
  __syncthreads();

  float* oc = out + (long long)c * out_c;
  if constexpr (TF_OUT) {
    for (int e = tid; e < nvalid * NF; e += NT) {
      const int t = e / NF, f = e % NF;
      oc[(long long)(t0 + t) * out_ld + f] = buf[t * LDR + f];
    }
  } else {
    for (int e = tid; e < TB * NF; e += NT) {
      const int f = e / TB, t = e % TB;
      if (t < nvalid) oc[(long long)f * out_ld + t0 + t] = buf[t * LDR + f];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if (tid % 32 == 0) {
    red[tid / 32] = mn;
    red[NT / 32 + tid / 32] = mx;
  }
  __syncthreads();
  if (tid == 0) {
    for (int wi = 1; wi < NT / 32; ++wi) {
      mn = fminf(mn, red[wi]);
      mx = fmaxf(mx, red[NT / 32 + wi]);
    }
    float* p = partials + ((long long)c * gridDim.x + blockIdx.x) * 2;
    p[0] = mn;
    p[1] = mx;
  }
}

template <bool TF_OUT>
int launch_stft(const float* x, long long x_stride, int C, int hop, int nperseg,
                int n_frames, int n_freqs, int detrend, const float* table,
                const float* weight, float eps, float* out, long long out_c,
                long long out_ld, float* partials, void* stream) {
  if (nperseg != N || hop != NH || n_freqs != NF || C < 1 || C > 65535 ||
      n_frames < 1 || detrend < 0 || detrend > 2)
    return cudaErrorInvalidValue;
  const dim3 grid((n_frames + TB - 1) / TB, C);
  auto kern = stft_logpsd_kernel<TF_OUT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      x, x_stride, hop, n_frames, detrend, table, weight, eps, out, out_c, out_ld,
      partials);
  return cudaGetLastError();
}

}  // namespace

// x: (C, >= (n_frames-1)*hop + nperseg) float32 traces, row stride x_stride;
// nperseg 512, hop 256.  detrend: 0 none, 1 constant, 2 linear.  table:
// (512 + 2*256 + 2*257,) float32, the window and the twiddles (see above).
// weight: (257,) one-sided PSD weights.  out: (C, 257, n_frames).
// partials: (C, ceil(n_frames/16), 2) (min, max).
extern "C" int stft_logpsd(const float* x, long long x_stride, int C, int hop,
                           int nperseg, int n_frames, int n_freqs, int detrend,
                           const float* table, const float* weight, float eps,
                           float* out, float* partials, void* stream) {
  return launch_stft<false>(x, x_stride, C, hop, nperseg, n_frames, n_freqs,
                            detrend, table, weight, eps, out,
                            (long long)n_freqs * n_frames, n_frames, partials,
                            stream);
}

// The same in the (T, F) layout: out (C, n_frames, out_ld), out_ld >=
// n_freqs; columns n_freqs .. out_ld - 1 are left as they are.
extern "C" int stft_logpsd_tf(const float* x, long long x_stride, int C,
                              int hop, int nperseg, int n_frames, int n_freqs,
                              int detrend, const float* table,
                              const float* weight, float eps, float* out,
                              long long out_ld, float* partials,
                              void* stream) {
  if (out_ld < n_freqs) return cudaErrorInvalidValue;
  return launch_stft<true>(x, x_stride, C, hop, nperseg, n_frames, n_freqs,
                           detrend, table, weight, eps, out,
                           (long long)n_frames * out_ld, out_ld, partials,
                           stream);
}
