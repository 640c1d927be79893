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
// 27 x 2 FLOP per value is far below the fp32 rate. At these sizes a launch
// is a few microseconds of latency, so what the design must avoid is work
// per value beyond the taps: re-reading each input 27 times, and index
// arithmetic per tap.
// What the design does about it: one block owns (frame, run of `run`
// consecutive x-planes, tile of `ytile` y-cells) and walks its planes in
// order with a ring of four raw planes in shared memory (planes x-1, x, x+1
// and x+2 in flight), each copied once from HBM with 8-byte cp.async while
// the block filters the plane before it. A plane tile (ytile + 2 cells with
// the y halo, all z, both channels) is one contiguous run of the grid. The
// x taps are computed once per value into shared memory; the z and y taps
// read them from there (bg_common.cuh blur_zy, B1's own order: x, then z,
// then y, each bg::tap3, so B5's values equal B1's bit for bit), and the
// output plane tile is stored coalesced. The y tiles exist for grids whose
// plane does not fit (r=2 at full HD) and for small batches, which fill the
// SMs with more tiles.
#include <cuda_runtime.h>

#include <atomic>

#include "bg_common.cuh"
#include "bg_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// x-mixed values of one channel of a plane tile in shared memory, [y][z][2],
// starting at y cell `y_lo`
struct TileMix {
  const float* xm;  // offset to the channel
  int y_lo, gz;
  __device__ __forceinline__ float operator()(int z, int y) const {
    return xm[((y - y_lo) * gz + z) * 2];
  }
};

// grid: (ceil(gx / run), ceil(gy / ytile), frames). Shared memory, with
// tile = (ytile + 2) * gz * 2 floats: ring [4][tile], then xm [tile].
__global__ void __launch_bounds__(kThreads)
bg_blur_kernel(const float* __restrict__ grid, float* __restrict__ out, int gx,
               int gy, int gz, int run, int ytile, int tile, float t0, float t1,
               float t2) {
  extern __shared__ __align__(16) float smem[];
  float* xm = smem + 4 * tile;
  const int x0 = blockIdx.x * run;
  const int x1 = min(x0 + run, gx);
  const int ya = blockIdx.y * ytile;
  const int yb = min(ya + ytile, gy);
  const int lo = max(ya - 1, 0);       // y cells held: [lo, hi)
  const int hi = min(yb + 1, gy);
  const int n = (hi - lo) * gz * 2;    // floats of a plane tile (even)
  const size_t plane = static_cast<size_t>(gy) * gz * 2;
  const float* g = grid + static_cast<size_t>(blockIdx.z) * gx * plane + lo * gz * 2;
  float* o = out + static_cast<size_t>(blockIdx.z) * gx * plane + ya * gz * 2;

  // plane x lives in ring slot (x + 1) & 3; planes outside [0, gx) are zeros
  // and never copied
  auto issue = [&](int x) {
    if (x >= 0 && x < gx) {
      float* dst = smem + ((x + 1) & 3) * tile;
      const float* src = g + x * plane;
      for (int k = 2 * threadIdx.x; k < n; k += 2 * kThreads) bg::cp_async8(dst + k, src + k);
    }
  };
  issue(x0 - 1);
  issue(x0);
  issue(x0 + 1);
  bg::cp_async_commit();

  const int n_out = (yb - ya) * gz * 2;
  for (int x = x0; x < x1; ++x) {
    if (x + 1 < x1) {  // plane x+2 (for output x+1) lands while x is filtered
      issue(x + 2);
      bg::cp_async_commit();
      bg::cp_async_wait<1>();
    } else {
      bg::cp_async_wait<0>();
    }
    __syncthreads();
    const float* rm = smem + (x & 3) * tile;
    const float* rc = smem + ((x + 1) & 3) * tile;
    const float* rp = smem + ((x + 2) & 3) * tile;
    const bool has_lo = x > 0, has_hi = x + 1 < gx;
    // ---- x taps, once per value (bg::tap3, zeros outside)
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const float lo_v = has_lo ? rm[k] : 0.f;
      const float hi_v = has_hi ? rp[k] : 0.f;
      xm[k] = bg::tap3(lo_v, rc[k], hi_v, t0, t1, t2);
    }
    __syncthreads();
    // ---- z, then y taps from shared memory; the output tile is contiguous
    float* ox = o + x * plane;
    for (int k = threadIdx.x; k < n_out; k += kThreads) {
      const int c = k & 1;
      const int zy = k >> 1;
      const int yl = zy / gz;
      const int z = zy - yl * gz;
      ox[k] = bg::blur_zy(TileMix{xm + c, lo, gz}, z, ya + yl, gz, gy, t0, t1, t2);
    }
    __syncthreads();  // xm and the ring slot of plane x-1 are free
  }
}

// Opts the kernel in to `bytes` of dynamic shared memory on `device` once
// per size (the largest so far), not at every launch: the call costs host
// time on every launch of a kernel that takes a few microseconds.
cudaError_t opt_in(int device, int bytes) {
  static std::atomic<int> granted[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= granted[device].load()) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(bg_blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) granted[device].store(bytes);
  return e;
}

}  // namespace

// The launch's shape, packed once per shape by the wrapper and passed by
// pointer (a ctypes call converts each scalar argument on the host, and a
// launch of a few microseconds must not wait on that).
struct BlurShape {
  int b, gx, gy, gz, run, ytile;
  float t0, t1, t2;
  int smem_bytes, device;
};

extern "C" {

const char* bg_blur_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest dynamic shared memory a block may opt in to on `device`, in bytes
// (or a negative CUDA error code).
int bg_blur_smem_optin(int device) {
  int v = 0;
  cudaError_t e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? v : -static_cast<int>(e);
}

// Launch on `stream`: the contiguous (b, gx, gy, gz, 2) fp32 grid -> `out`
// of the same shape (not aliased), `run` x-planes and `ytile` y-cells per
// block, `smem_bytes` = 5 * (ytile + 2) * gz * 2 * 4. Returns
// cudaGetLastError().
int bg_blur_launch(const float* grid, float* out, const BlurShape* s, void* stream) {
  cudaError_t e = cudaSetDevice(s->device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = opt_in(s->device, s->smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tile = (s->ytile + 2) * s->gz * 2;
  const dim3 blocks((s->gx + s->run - 1) / s->run, (s->gy + s->ytile - 1) / s->ytile, s->b);
  bg_blur_kernel<<<blocks, kThreads, s->smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      grid, out, s->gx, s->gy, s->gz, s->run, s->ytile, tile, s->t0, s->t1, s->t2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
