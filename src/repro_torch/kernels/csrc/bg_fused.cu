// Fused bilateral-grid filter (GC -> GF -> TI) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/bg_fused.py::_kernel with
// _pipeline_step, per-frame launch (pallas_call at bg_fused.py:645,
// temporal=False), fp32 storage. It computes what that kernel computes, per
// frame: the paper's grid creation, 3x3x3 Gaussian filter with per-cell
// normalization (eq. 4), and trilinear slice, unquantized.
//
// What bounds it on this card: HBM bytes. A frame is read once and written
// once, 8 B per pixel: 16.6 MB for a 1080x1920 frame, 4.95 us at 3.35 TB/s.
// The arithmetic is about 10^2 FLOP per pixel, far below the fp32 rate.
// What the design does about it: the grid never touches HBM. Each block
// builds the raw grid planes it needs in shared memory, blurs and normalizes
// them there, and slices its output rows from there.
//
// Decomposition. The TPU walks the stripes of a frame in order and carries
// a three-plane working set from one grid step to the next. Blocks here run
// in no order, so one block owns (frame, band of `band` stripes) and
// recomputes its halo: TI of stripe k reads normalized planes k and k+1,
// those need raw planes k-1..k+2, so a band [k0, k1) builds raw planes
// k0-1..k1+1 from the image rows that round to them. A halo plane is
// computed by the same code in every block that needs it, so its bits do
// not depend on the band, the batch or the launch.
//
// Deterministic GC, no float atomics: one thread owns one (raw plane, y
// cell) column of gz bins and adds its r x r pixels into them in row-major
// order. The TPU's one-hot matmul was a workaround for the missing scatter
// and is gone. The validity mask is implicit: a thread visits only rows
// < h of its own frame.
//
// Arithmetic that decides bins matches the reference exactly:
//   z bin        floor(px * fp32(1/rs) + 0.5), without FMA contraction
//   row/col cell round-half-up(i / r) in integers (common.py gc_row_split)
//   TI corners   y0 = j / r, y1 = min(y0 + 1, gy - 1); yf, xf from the host
//   normalize    count > 1e-12 ? sum / max(count, 1e-12) : 0
// with zero borders in x, y and z.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int gc_bin(float px, float inv_rs) {
  return static_cast<int>(floorf(__fadd_rn(__fmul_rn(px, inv_rs), 0.5f)));
}

// x taps over the three raw planes of one channel at flat (z, y) index idx
__device__ __forceinline__ float xmix(const float* rm, const float* rc,
                                      const float* rp, int idx, float t0,
                                      float t1, float t2) {
  return t0 * rm[idx] + t1 * rc[idx] + t2 * rp[idx];
}

// Blurred value of one channel at (z, y): x, then z, then y, each
// t0*lo + t1*mid + t2*hi with zeros outside the grid (the reference order).
__device__ __forceinline__ float blur_cell(const float* rm, const float* rc,
                                           const float* rp, int z, int y,
                                           int gz, int gy, float t0, float t1,
                                           float t2) {
  float zc[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int yy = y + d - 1;
    float v = 0.f;
    if (yy >= 0 && yy < gy) {
      const float lo = z > 0 ? xmix(rm, rc, rp, (z - 1) * gy + yy, t0, t1, t2) : 0.f;
      const float mid = xmix(rm, rc, rp, z * gy + yy, t0, t1, t2);
      const float hi = z + 1 < gz ? xmix(rm, rc, rp, (z + 1) * gy + yy, t0, t1, t2) : 0.f;
      v = t0 * lo + t1 * mid + t2 * hi;
    }
    zc[d] = v;
  }
  return t0 * zc[0] + t1 * zc[1] + t2 * zc[2];
}

// x/y lerp of normalized planes n0 (stripe's floor plane) and n1 at bin z
__device__ __forceinline__ float ti_bin(const float* n0, const float* n1, int z,
                                        int y0, int y1, int gz, int gy,
                                        float wx, float wy) {
  if (z < 0 || z >= gz) return 0.f;
  const float a0 = n0[z * gy + y0] * (1.f - wy) + n0[z * gy + y1] * wy;
  const float a1 = n1[z * gy + y0] * (1.f - wy) + n1[z * gy + y1] * wy;
  return a0 * (1.f - wx) + a1 * wx;
}

// grid: (ceil(n_stripes / band), frames). Shared memory:
//   raw  [band + 3][2][gz][gy]   count, sum of raw planes k0-1 .. k1+1
//   norm [band + 1][gz][gy]      normalized blurred planes k0 .. k1
__global__ void __launch_bounds__(kThreads)
bg_fused_kernel(const float* __restrict__ img, float* __restrict__ out,
                const float* __restrict__ yf, const float* __restrict__ xf,
                int h, int w, int r, int gy, int gz, int split, int band,
                int n_stripes, float inv_rs, float t0, float t1, float t2) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * band;
  const int k1 = min(k0 + band, n_stripes);
  const int plane = gz * gy;
  const int n_raw = k1 - k0 + 3;
  const int n_norm = k1 - k0 + 1;
  float* raw = smem;
  float* norm = smem + (band + 3) * 2 * plane;
  const size_t frame = static_cast<size_t>(blockIdx.y) * h * w;
  const float* im = img + frame;
  float* o = out + frame;

  // ---- GC: raw plane p holds rows [(p-1)r + split, p r + split), column
  // cell y holds columns [(y-1)r + split, y r + split), both cut to the frame
  for (int t = threadIdx.x; t < n_raw * gy; t += blockDim.x) {
    const int pl = t / gy;
    const int y = t - pl * gy;
    const int p = k0 - 1 + pl;
    float* cnt = raw + pl * 2 * plane + y;
    float* sum = cnt + plane;
    for (int z = 0; z < gz; ++z) {
      cnt[z * gy] = 0.f;
      sum[z * gy] = 0.f;
    }
    const int i_lo = max((p - 1) * r + split, 0);
    const int i_hi = min(p * r + split, h);
    const int j_lo = max((y - 1) * r + split, 0);
    const int j_hi = min(y * r + split, w);
    for (int i = i_lo; i < i_hi; ++i) {
      const float* row = im + static_cast<size_t>(i) * w;
      for (int j = j_lo; j < j_hi; ++j) {
        const float px = __ldg(row + j);
        const int z = gc_bin(px, inv_rs);
        if (z >= 0 && z < gz) {
          cnt[z * gy] += 1.f;
          sum[z * gy] += px;
        }
      }
    }
  }
  __syncthreads();

  // ---- GF + normalize: plane k0+ql from raw planes k0+ql-1 .. k0+ql+1
  for (int t = threadIdx.x; t < n_norm * plane; t += blockDim.x) {
    const int ql = t / plane;
    const int zy = t - ql * plane;
    const int z = zy / gy;
    const int y = zy - z * gy;
    const float* rm = raw + ql * 2 * plane;
    const float* rc = rm + 2 * plane;
    const float* rp = rc + 2 * plane;
    const float c = blur_cell(rm, rc, rp, z, y, gz, gy, t0, t1, t2);
    const float s = blur_cell(rm + plane, rc + plane, rp + plane, z, y, gz, gy,
                              t0, t1, t2);
    norm[t] = c > 1e-12f ? s / fmaxf(c, 1e-12f) : 0.f;
  }
  __syncthreads();

  // ---- TI of the band's rows against normalized planes k and k+1
  const int row_lo = k0 * r;
  const int row_hi = min(k1 * r, h);
  const int npx = (row_hi - row_lo) * w;
  for (int t = threadIdx.x; t < npx; t += blockDim.x) {
    const int ii = t / w;
    const int j = t - ii * w;
    const int kl = ii / r;
    const int m = ii - kl * r;
    const size_t off = static_cast<size_t>(row_lo + ii) * w + j;
    const float px = __ldg(im + off);
    const float fz = __fmul_rn(px, inv_rs);
    const float zfl = floorf(fz);
    const int z0 = static_cast<int>(zfl);
    const float zf = __fsub_rn(fz, zfl);
    const int y0 = j / r;
    const int y1 = min(y0 + 1, gy - 1);
    const float wy = __ldg(yf + j);
    const float wx = __ldg(xf + m);
    const float* n0 = norm + kl * plane;
    const float* n1 = n0 + plane;
    const float q0 = ti_bin(n0, n1, z0, y0, y1, gz, gy, wx, wy);
    const float q1 = ti_bin(n0, n1, z0 + 1, y0, y1, gz, gy, wx, wy);
    o[off] = (1.f - zf) * q0 + zf * q1;
  }
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may opt in to on `device`, in bytes
// (or a negative CUDA error code).
int bg_fused_smem_optin(int device) {
  int v = 0;
  cudaError_t e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? v : -static_cast<int>(e);
}

const char* bg_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch on `stream` for `b` contiguous (h, w) fp32 frames. Returns
// cudaGetLastError() after the launch (0 on success); never synchronizes.
int bg_fused_launch(const float* img, float* out, const float* yf,
                    const float* xf, int b, int h, int w, int r, int gy, int gz,
                    int split, int band, float inv_rs, float t0, float t1,
                    float t2, int smem_bytes, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(bg_fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_stripes = (h + r - 1) / r;
  const dim3 grid((n_stripes + band - 1) / band, b);
  bg_fused_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      img, out, yf, xf, h, w, r, gy, gz, split, band, n_stripes, inv_rs, t0,
      t1, t2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
