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
//                     through padded shared memory (32 x 33 tiles)
//   probe_stride2     a stride-2 slice along the fast axis: x[:, ::2] of a
//                     (256, 512) float32 block
// A probe that compiles, launches and equals torch's slicing is OK.
//
// What bounds them on this card: each moves 0.27-0.52 MB, under a
// microsecond at 3.35 TB/s; a launch costs more, so they are launch-bound.
// Design: one block per 32-column strip (row slice, stride 2) or 32 x 32
// tile (transpose), each staged whole in shared memory and written from
// there, so the construct under probe is the shared-memory access pattern.

#include "common.cuh"

namespace {

constexpr int S = 32;       // strip width / tile side
constexpr int ROWS = 264;   // the row-slice probe's input rows (FB + 8)
constexpr int OUT = 256;    // output rows / side

// x (ROWS, ld) -> out (OUT, ld) = x[1 : OUT + 1]; block = one 32-column strip.
__global__ void __launch_bounds__(256) row_slice_kernel(
    const float* __restrict__ x, float* __restrict__ out, int ld) {
  __shared__ float s[ROWS][S];
  const int c0 = blockIdx.x * S;
  for (int e = threadIdx.x; e < ROWS * S; e += blockDim.x)
    s[e / S][e % S] = x[(long long)(e / S) * ld + c0 + e % S];
  __syncthreads();
  for (int e = threadIdx.x; e < OUT * S; e += blockDim.x)
    out[(long long)(e / S) * ld + c0 + e % S] = s[e / S + 1][e % S];
}

// x (n, n) -> out = x^T; block = one 32 x 32 tile, 32 x 8 threads.
__global__ void __launch_bounds__(256) transpose_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n) {
  __shared__ float s[S][S + 1];  // +1: conflict-free column reads
  const int r0 = blockIdx.y * S, c0 = blockIdx.x * S;
  for (int r = threadIdx.y; r < S; r += blockDim.y)
    s[r][threadIdx.x] = x[(long long)(r0 + r) * n + c0 + threadIdx.x];
  __syncthreads();
  for (int r = threadIdx.y; r < S; r += blockDim.y)
    out[(long long)(c0 + r) * n + r0 + threadIdx.x] = s[threadIdx.x][r];
}

// x (rows, 2 * w) -> out (rows, w) = x[:, ::2]; block = 32 output columns
// (64 input columns) of every row.
__global__ void __launch_bounds__(256) stride2_kernel(
    const float* __restrict__ x, float* __restrict__ out, int rows, int w) {
  extern __shared__ float s[];  // (rows, 2 * S)
  const int c0 = blockIdx.x * S;
  for (int e = threadIdx.x; e < rows * 2 * S; e += blockDim.x)
    s[e] = x[(long long)(e / (2 * S)) * 2 * w + 2 * c0 + e % (2 * S)];
  __syncthreads();
  for (int e = threadIdx.x; e < rows * S; e += blockDim.x)
    out[(long long)(e / S) * w + c0 + e % S] = s[(e / S) * 2 * S + 2 * (e % S)];
}

}  // namespace

// x: (264, ld) float32, out: (256, ld), ld a multiple of 32.
extern "C" int probe_row_slice(const float* x, float* out, int ld,
                               void* stream) {
  if (ld < S || ld % S) return cudaErrorInvalidValue;
  row_slice_kernel<<<ld / S, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, ld);
  return cudaGetLastError();
}

// x, out: (n, n) float32, n a multiple of 32.
extern "C" int probe_transpose(const float* x, float* out, int n,
                               void* stream) {
  if (n < S || n % S) return cudaErrorInvalidValue;
  transpose_kernel<<<dim3(n / S, n / S), dim3(S, 8), 0,
                     static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return cudaGetLastError();
}

// x: (rows, 2 * w) float32, out: (rows, w), w a multiple of 32; the block
// stages rows x 64 floats (64 KB at rows = 256) in dynamic shared memory.
extern "C" int probe_stride2(const float* x, float* out, int rows, int w,
                             void* stream) {
  const size_t smem = sizeof(float) * rows * 2 * S;
  if (w < S || w % S || rows < 1 || smem > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stride2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  stride2_kernel<<<w / S, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, rows, w);
  return cudaGetLastError();
}
