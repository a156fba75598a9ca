// K11: probes of the Hopper toolchain, for sm_90a: the three constructs
// whose absence once retired the TPU's split-basis STFT kernel, as a
// kernel of this port writes them.
//
// Replaces the three pl.pallas_call probes of scripts/probe_mosaic_walls.py
// (:32, :43, :54), which asked the TPU's compiler for:
//   probe_row_slice   a value slice at row offset 1: x[1:257] of a
//                     (264, 256) float32 block (on the TPU, a sublane
//                     offset; here a shared-memory read one row down)
//   probe_transpose   an in-kernel transpose of a (256, 256) float32 block,
//                     through a padded shared-memory tile
//   probe_stride2     a stride-2 slice along the fast axis: x[:, ::2] of a
//                     (256, 512) float32 block, read at stride 2 from
//                     shared memory
// A probe that compiles, launches and equals torch's slicing is OK.
//
// What bounds them on this card: each moves 0.27-0.52 MB, under a
// microsecond at 3.35 TB/s; a launch costs more, so they are launch-bound:
// the time is the host's path to the launch and one round trip to memory.
// Design: each probe spreads over the card (256 blocks of 64 threads for
// the probes' shapes, against 132 SMs), stages its input with 16-byte
// cp.async copies (a row's copies one run of contiguous bytes), and writes
// 16-byte float4s; the row slice stages a band of 4 rows and the halo row
// below it, and reads each output row from the staged row below.  The
// entries call the CUDA runtime only to launch and to read the launch's
// error (static shared memory only).  probe_walls.py mirrors the geometry
// (grid()).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 64;       // threads of a block, every probe
constexpr int RS_OUT = 256;  // the row slice's output rows (its input has RS_OUT + 8)
constexpr int RS_BAND = 4;   // its output rows a block (one halo row staged below)
constexpr int RS_W = 64;     // its columns a block (256 bytes a row)
constexpr int T = 16;        // the transpose's tile side
constexpr int TP = T + 4;    // its padded row: 16-byte rows for cp.async
constexpr int S2_BAND = 4;   // the stride-2 slice's output rows a block
constexpr int S2_W = 64;     // its output columns a block (128 input columns)

// x (RS_OUT + 8, ld) -> out (RS_OUT, ld) = x[1 : RS_OUT + 1]; block = a
// band of 4 output rows by 64 columns.  It stages input rows r0 .. r0 + 4
// (the band and the halo row below it: 80 copies of 16 bytes, 16 a row);
// thread t then writes output row r0 + t / 16 at columns 4 g .. 4 g + 3
// (g = t % 16) from staged row t / 16 + 1: the read one row down, a float4
// of a 256-byte row (every 8 threads' reads one conflict-free 128 bytes).
__global__ void __launch_bounds__(NT) row_slice_kernel(
    const float* __restrict__ x, float* __restrict__ out, int ld) {
  __shared__ __align__(16) float s[RS_BAND + 1][RS_W];
  const int r0 = blockIdx.y * RS_BAND, c0 = blockIdx.x * RS_W;
  const float* src = x + (long long)r0 * ld + c0;
  for (int e = threadIdx.x; e < (RS_BAND + 1) * RS_W / 4; e += NT) {
    const int r = e / (RS_W / 4), q = e % (RS_W / 4);
    cp_async16(&s[r][4 * q], src + (long long)r * ld + 4 * q);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int r = threadIdx.x / (RS_W / 4), g = threadIdx.x % (RS_W / 4);
  *reinterpret_cast<float4*>(out + (long long)(r0 + r) * ld + c0 + 4 * g) =
      *reinterpret_cast<const float4*>(&s[r + 1][4 * g]);
}

// x (n, n) -> out = x^T; block = one 16 x 16 tile, 64 threads.  Thread t
// copies 16 bytes of tile row t / 4, then writes out row c = t % 16 at
// columns 4 q .. 4 q + 3 (q = t / 16) from tile column c: with rows of 20
// floats, a warp's column reads (c 0-15, q 0-1) fall in 32 distinct banks.
__global__ void __launch_bounds__(NT) transpose_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n) {
  __shared__ __align__(16) float s[T][TP];
  const int r0 = blockIdx.y * T, c0 = blockIdx.x * T, t = threadIdx.x;
  cp_async16(&s[t / 4][4 * (t % 4)], x + (long long)(r0 + t / 4) * n + c0 + 4 * (t % 4));
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int c = t % T, q = t / T;
  const float4 v = make_float4(s[4 * q][c], s[4 * q + 1][c], s[4 * q + 2][c], s[4 * q + 3][c]);
  *reinterpret_cast<float4*>(out + (long long)(c0 + c) * n + r0 + 4 * q) = v;
}

// x (rows, 2 * w) -> out (rows, w) = x[:, ::2]; block = a band of 4 rows
// by 64 output columns (128 input columns, 512 bytes a row: one warp's
// copies).  Thread t writes output row t / 16 at columns 4 g .. 4 g + 3
// (g = t % 16): the .x of the staged row's float2s 4 g .. 4 g + 3.
__global__ void __launch_bounds__(NT) stride2_kernel(
    const float* __restrict__ x, float* __restrict__ out, int w) {
  __shared__ __align__(16) float s[S2_BAND][2 * S2_W];
  const int r0 = blockIdx.y * S2_BAND, c0 = blockIdx.x * S2_W;
  const float* src = x + (long long)r0 * 2 * w + 2 * c0;
#pragma unroll
  for (int j = 0; j < S2_BAND * 2 * S2_W / 4 / NT; ++j) {
    const int e = threadIdx.x + j * NT, r = e / (2 * S2_W / 4), q = e % (2 * S2_W / 4);
    cp_async16(&s[r][4 * q], src + (long long)r * 2 * w + 4 * q);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int r = threadIdx.x / (S2_W / 4), g = threadIdx.x % (S2_W / 4);
  const float2* row = reinterpret_cast<const float2*>(s[r]);
  const float4 v = make_float4(row[4 * g].x, row[4 * g + 1].x, row[4 * g + 2].x,
                               row[4 * g + 3].x);
  *reinterpret_cast<float4*>(out + (long long)(r0 + r) * w + c0 + 4 * g) = v;
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

}  // namespace

// x: (RS_OUT + 8, ld) float32, out: (RS_OUT, ld), ld a multiple of 64,
// both 16-byte aligned.
extern "C" int probe_row_slice(const float* x, float* out, int ld,
                               void* stream) {
  if (ld < RS_W || ld % RS_W || !aligned16(x, out)) return cudaErrorInvalidValue;
  row_slice_kernel<<<dim3(ld / RS_W, RS_OUT / RS_BAND), NT, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, out, ld);
  return cudaGetLastError();
}

// x, out: (n, n) float32, n a multiple of 16, both 16-byte aligned.
extern "C" int probe_transpose(const float* x, float* out, int n,
                               void* stream) {
  if (n < T || n % T || n / T > 65535 || !aligned16(x, out)) return cudaErrorInvalidValue;
  transpose_kernel<<<dim3(n / T, n / T), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n);
  return cudaGetLastError();
}

// x: (rows, 2 * w) float32, out: (rows, w), w a multiple of 64, rows of 4,
// both 16-byte aligned.
extern "C" int probe_stride2(const float* x, float* out, int rows, int w,
                             void* stream) {
  if (w < S2_W || w % S2_W || rows < S2_BAND || rows % S2_BAND ||
      rows / S2_BAND > 65535 || !aligned16(x, out))
    return cudaErrorInvalidValue;
  stride2_kernel<<<dim3(w / S2_W, rows / S2_BAND), NT, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, out, w);
  return cudaGetLastError();
}
