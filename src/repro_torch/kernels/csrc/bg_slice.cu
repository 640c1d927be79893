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
// What the design does about it: one block owns (frame, band of `band`
// stripes, tile of `tile` column cells) and one thread one column of the
// tile, so neighbouring threads read and write neighbouring pixels
// (coalesced). Per stripe a thread loads its column's corners of planes x0
// and x1 once and y-lerps them at every z into its own table (bg::YLerp's
// values, the same bits as B1's table), then walks the stripe's rows four
// at a time, their loads in flight together: per pixel one x lerp at z0, one
// at z0+1 and the z lerp, as B1's TI. The column cell comes from a
// multiply-high; no division per pixel. The corners, the host's yf and xf
// and the lerp order are B1's (bg_common.cuh).
#include <cuda_runtime.h>

#include <atomic>

#include "bg_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows sliced together
constexpr int kMaxDevices = 64;

// planes x0 and x1 of one frame's (gx, gy, gz) grid, read at (z, y)
struct GridPlanes {
  const float *p0, *p1;
  int gz;
  __device__ __forceinline__ float operator()(int p, int z, int y) const {
    return __ldg((p ? p1 : p0) + static_cast<size_t>(y) * gz + z);
  }
};

struct Args {
  const float* grid;
  const float* img;
  float* out;
  const float* yf;
  const float* xf;
  int h, w, r, gx, gy, gz, band, tile, n_stripes, n_cells;
  unsigned r_magic;  // ceil(2^32 / r): j / r == umulhi(j, r_magic) for r > 1
  float inv_rs;
};

// grid: (bands, tiles, frames). Shared memory: [2 gz][kThreads], each
// thread's y-lerped corners of planes x0 (even rows) and x1 (odd rows).
__global__ void __launch_bounds__(kThreads) bg_slice_kernel(const Args a) {
  extern __shared__ float table[];
  float* tab = table + threadIdx.x;
  const int r = a.r, w = a.w, gy = a.gy, gz = a.gz;
  const int k0 = blockIdx.x * a.band;
  const int k1 = min(k0 + a.band, a.n_stripes);
  const int c0 = blockIdx.y * a.tile;
  const int col_hi = min(min(c0 + a.tile, a.n_cells) * r, w);
  const size_t plane = static_cast<size_t>(gy) * gz;
  const float* g = a.grid + static_cast<size_t>(blockIdx.z) * a.gx * plane;
  const size_t frame = static_cast<size_t>(blockIdx.z) * a.h * w;
  const float* im = a.img + frame;
  float* o = a.out + frame;
  const auto lut = [tab](int p, int z) { return tab[(2 * z + p) * kThreads]; };

  for (int j = c0 * r + threadIdx.x; j < col_hi; j += kThreads) {
    const int y0 = r > 1 ? static_cast<int>(__umulhi(j, a.r_magic)) : j;
    const int y1 = min(y0 + 1, gy - 1);
    const float wy = __ldg(a.yf + j);
    for (int k = k0; k < k1; ++k) {
      const GridPlanes planes{g + k * plane, g + min(k + 1, a.gx - 1) * plane, gz};
      const bg::YLerp<GridPlanes> yl{planes, y0, y1, wy};
#pragma unroll 4
      for (int z = 0; z < gz; ++z) {
        tab[(2 * z) * kThreads] = yl(0, z);
        tab[(2 * z + 1) * kThreads] = yl(1, z);
      }
      const int m_hi = min(r, a.h - k * r);
      const float* src = im + static_cast<size_t>(k) * r * w + j;
      float* dst = o + static_cast<size_t>(k) * r * w + j;
      for (int m0 = 0; m0 < m_hi; m0 += kRows) {
        float px[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          px[u] = m0 + u < m_hi ? __ldg(src + static_cast<size_t>(m0 + u) * w) : 0.f;
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (m0 + u < m_hi)
            dst[static_cast<size_t>(m0 + u) * w] =
                bg::ti_pixel_y(lut, px[u], a.inv_rs, gz, __ldg(a.xf + m0 + u));
        }
      }
    }
  }
}

// Opts the kernel in to `bytes` of dynamic shared memory on `device` once
// per size (the largest so far); the table passes 48 KB only at gz > 24.
cudaError_t opt_in(int device, int bytes) {
  static std::atomic<int> granted[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= granted[device].load()) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(bg_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) granted[device].store(bytes);
  return e;
}

}  // namespace

// The launch's shape and geometry, packed once per shape by the wrapper and
// passed by pointer.
struct SliceShape {
  int b, h, w, r, gx, gy, gz, band, tile;
  float inv_rs;
  int smem_bytes, device;
};

extern "C" {

// Largest dynamic shared memory a block may opt in to on `device`, in bytes
// (or a negative CUDA error code).
int bg_slice_smem_optin(int device) {
  int v = 0;
  cudaError_t e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? v : -static_cast<int>(e);
}

const char* bg_slice_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch on `stream`: the contiguous (b, gx, gy, gz) fp32 grid and (b, h, w)
// frames -> `out` (b, h, w), blocks of `band` stripes x `tile` column cells.
// Returns cudaGetLastError().
int bg_slice_launch(const float* grid_f, const float* img, float* out, const float* yf,
                    const float* xf, const SliceShape* s, void* stream) {
  cudaError_t e = cudaSetDevice(s->device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = opt_in(s->device, s->smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int r = s->r;
  const Args a{grid_f, img, out, yf, xf, s->h, s->w, r, s->gx, s->gy, s->gz, s->band, s->tile,
               (s->h + r - 1) / r, (s->w + r - 1) / r,
               r > 1 ? static_cast<unsigned>(((1ull << 32) + r - 1) / r) : 0u, s->inv_rs};
  const dim3 blocks((a.n_stripes + a.band - 1) / a.band, (a.n_cells + a.tile - 1) / a.tile, s->b);
  bg_slice_kernel<<<blocks, kThreads, s->smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
