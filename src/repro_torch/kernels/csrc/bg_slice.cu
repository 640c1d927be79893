// Standalone trilinear slice (TI, B6) for Hopper, sm_90a: a normalized grid
// (b, gx, gy, gz) in HBM and the frames (b, h, w) -> the filtered frames.
//
// Replaces the TPU kernel src/repro/kernels/bg_slice.py::_kernel
// (pallas_call at bg_slice.py:90): one r-row stripe per grid step against
// planes floor(x) and min(floor(x) + 1, gx - 1), the y corners as one-hot
// matmuls, the z corners as a one-hot lerp tensor and x weights i/r.
//
// What bounds it on this card: HBM bytes. The frame is read once and
// written once and the scalar grid read once (16.8 MB per 1080x1920 frame
// at r=12: 5.02 us at 3.35 TB/s); about 27 FLOP per pixel, far below the
// fp32 rate.
// What the design does about it: one thread per pixel, neighbouring threads
// on neighbouring pixels, so frame reads and writes are coalesced; the eight
// corners come from a grid small enough to stay in L2. The corners, the
// host's yf and xf, and the lerp order are B1's (bg_common.cuh ti_pixel).
#include <cuda_runtime.h>

#include "bg_common.cuh"

namespace {

constexpr int kThreads = 256;

// planes x0 and x1 of one frame's (gx, gy, gz) grid, read at (z, y)
struct GridPlanes {
  const float *p0, *p1;
  int gz;
  __device__ __forceinline__ float operator()(int p, int z, int y) const {
    return __ldg((p ? p1 : p0) + static_cast<size_t>(y) * gz + z);
  }
};

// grid: (ceil(h*w / kThreads), frames)
__global__ void __launch_bounds__(kThreads)
bg_slice_kernel(const float* __restrict__ grid_f, const float* __restrict__ img,
                float* __restrict__ out, const float* __restrict__ yf,
                const float* __restrict__ xf, int h, int w, int r, int gx,
                int gy, int gz, float inv_rs) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= h * w) return;
  const int i = t / w;
  const int j = t - i * w;
  const int x0 = i / r;
  const int x1 = min(x0 + 1, gx - 1);
  const int y0 = j / r;
  const size_t plane = static_cast<size_t>(gy) * gz;
  const float* g = grid_f + static_cast<size_t>(blockIdx.y) * gx * plane;
  const size_t off = static_cast<size_t>(blockIdx.y) * h * w + t;
  out[off] = bg::ti_pixel(GridPlanes{g + x0 * plane, g + x1 * plane, gz},
                          __ldg(img + off), inv_rs, y0, min(y0 + 1, gy - 1), gz,
                          __ldg(xf + (i - x0 * r)), __ldg(yf + j));
}

}  // namespace

extern "C" {

const char* bg_slice_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch on `stream`: the contiguous (b, gx, gy, gz) fp32 grid and (b, h, w)
// frames -> `out` (b, h, w). Returns cudaGetLastError().
int bg_slice_launch(const float* grid_f, const float* img, float* out,
                    const float* yf, const float* xf, int b, int h, int w, int r,
                    int gx, int gy, int gz, float inv_rs, int device,
                    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 blocks((h * w + kThreads - 1) / kThreads, b);
  bg_slice_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      grid_f, img, out, yf, xf, h, w, r, gx, gy, gz, inv_rs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
