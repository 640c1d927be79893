// Standalone grid filter (GF, B5) for Hopper, sm_90a: the 3x3x3 separable
// Gaussian on both homogeneous channels of a (b, gx, gy, gz, 2) grid in HBM,
// zero borders, into a grid of the same shape.
//
// Replaces the TPU kernel src/repro/kernels/bg_blur.py::_kernel
// (pallas_call at bg_blur.py:57): one x-plane per grid step with its prev
// and next planes as halos (zeroed at the x borders), the x taps, then z,
// then y.
//
// What bounds it on this card: HBM bytes, the grid read once and written
// once (0.95 MB per frame at r=12, 1080x1920: 0.285 us at 3.35 TB/s);
// 27 x 2 FLOP per value is far below the fp32 rate.
// What the design does about it: one thread per output value, threads laid
// along the grid's minor (y, z, channel) order, so every tap is a coalesced
// read of a plane that neighbouring threads share through L1. The taps are
// B1's own (bg_common.cuh blur_zy): x, then z, then y.
#include <cuda_runtime.h>

#include "bg_common.cuh"

namespace {

constexpr int kThreads = 256;

// x-mixed value of one channel at (z, y) of plane x, zero outside the grid
struct GridMix {
  const float* g;  // the frame's (gx, gy, gz, 2) grid, offset to the channel
  int x, gx, gy, gz;
  float t0, t1, t2;
  __device__ __forceinline__ float at(int xx, int z, int y) const {
    return (xx >= 0 && xx < gx)
               ? __ldg(g + ((static_cast<size_t>(xx) * gy + y) * gz + z) * 2)
               : 0.f;
  }
  __device__ __forceinline__ float operator()(int z, int y) const {
    return t0 * at(x - 1, z, y) + t1 * at(x, z, y) + t2 * at(x + 1, z, y);
  }
};

// grid: (ceil(gy*gz*2 / kThreads), gx, frames)
__global__ void __launch_bounds__(kThreads)
bg_blur_kernel(const float* __restrict__ grid, float* __restrict__ out, int gx,
               int gy, int gz, float t0, float t1, float t2) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= gy * gz * 2) return;
  const int x = blockIdx.y;
  const int c = t & 1;
  const int zy = t >> 1;
  const int y = zy / gz;
  const int z = zy - y * gz;
  const size_t frame = static_cast<size_t>(blockIdx.z) * gx * gy * gz * 2;
  const GridMix xm{grid + frame + c, x, gx, gy, gz, t0, t1, t2};
  out[frame + static_cast<size_t>(x) * gy * gz * 2 + t] =
      bg::blur_zy(xm, z, y, gz, gy, t0, t1, t2);
}

}  // namespace

extern "C" {

const char* bg_blur_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch on `stream`: the contiguous (b, gx, gy, gz, 2) fp32 grid -> `out`
// of the same shape (not aliased). Returns cudaGetLastError().
int bg_blur_launch(const float* grid, float* out, int b, int gx, int gy, int gz,
                   float t0, float t1, float t2, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 blocks((gy * gz * 2 + kThreads - 1) / kThreads, gx, b);
  bg_blur_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      grid, out, gx, gy, gz, t0, t1, t2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
