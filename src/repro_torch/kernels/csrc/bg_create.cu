// Standalone grid creation (GC, B4) for Hopper, sm_90a: frames -> the
// (count, sum) grid in HBM, in the JAX package's (b, gx, gy, gz, 2) layout.
//
// Replaces the TPU kernel src/repro/kernels/bg_create.py::_kernel
// (pallas_call at bg_create.py:68): one x-plane per grid step, the (r, w)
// rows of the plane (rows padded top by r//2) reduced to (2, gz, gy) by a
// one-hot z matmul against the column one-hot. The top pad of r//2 is the
// same row map as gc_row_split: raw plane x takes rows
// [(x-1)r + split, x r + split), column cell y the columns
// [(y-1)r + split, y r + split).
//
// What bounds it on this card: HBM bytes. A frame is read once (8.3 MB at
// 1080x1920) and the grid written once (gx*gy*gz*2*4 B, 0.48 MB at r=12):
// 2.62 us at 3.35 TB/s. About 5 FLOP per pixel, far below the fp32 rate.
// What the design does about it: owner-computes, as B1. One thread owns one
// (frame, x plane, y cell) column of gz bins and adds its r x r pixels in
// row-major order (no float atomics, so every launch and every batch gives
// the same bits); its 2*gz sums sit in shared memory in the output's own
// order, so the block writes its run of the grid with coalesced stores and
// no transpose pass.
#include <cuda_runtime.h>

#include "bg_common.cuh"

namespace {

// grid: (ceil(gy / blockDim.x), gx, frames); shared [blockDim.x][gz][2]
__global__ void bg_create_kernel(const float* __restrict__ img,
                                 float* __restrict__ grid, int h, int w, int r,
                                 int gx, int gy, int gz, int split, float inv_rs) {
  extern __shared__ float bins[];
  const int x = blockIdx.y;
  const int y_base = blockIdx.x * blockDim.x;
  const int y = y_base + threadIdx.x;
  float* mine = bins + threadIdx.x * gz * 2;
  for (int k = 0; k < 2 * gz; ++k) mine[k] = 0.f;
  if (y < gy) {
    const float* im = img + static_cast<size_t>(blockIdx.z) * h * w;
    const int i_lo = max((x - 1) * r + split, 0);
    const int i_hi = min(x * r + split, h);
    const int j_lo = max((y - 1) * r + split, 0);
    const int j_hi = min(y * r + split, w);
    bg::gc_cell<true>(im + static_cast<size_t>(i_lo) * w, w, i_hi - i_lo, j_lo,
                      j_hi, inv_rs, gz, mine, mine + 1, 2);
  }
  __syncthreads();
  const int n = (min(y_base + static_cast<int>(blockDim.x), gy) - y_base) * gz * 2;
  float* dst = grid + ((static_cast<size_t>(blockIdx.z) * gx + x) * gy + y_base) * gz * 2;
  for (int t = threadIdx.x; t < n; t += blockDim.x) dst[t] = bins[t];
}

}  // namespace

extern "C" {

const char* bg_create_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch on `stream`: `b` contiguous (h, w) fp32 frames -> the contiguous
// (b, gx, gy, gz, 2) grid. `threads` threads per block, each with 2*gz
// floats of shared memory (the wrapper keeps the block within 48 KB).
// Returns cudaGetLastError(); never synchronizes.
int bg_create_launch(const float* img, float* grid, int b, int h, int w, int r,
                     int gx, int gy, int gz, int split, float inv_rs,
                     int threads, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = threads * gz * 2 * static_cast<int>(sizeof(float));
  const dim3 blocks((gy + threads - 1) / threads, gx, b);
  bg_create_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      img, grid, h, w, r, gx, gy, gz, split, inv_rs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
