// Fused bilateral-grid filter (GC -> GF -> TI) for Hopper, sm_90a, per frame
// (B1) and with the temporal grid EMA (B2).
//
// Replaces the TPU kernel src/repro/kernels/bg_fused.py::_kernel with
// _pipeline_step, fp32 storage, in both of its launches: per frame
// (pallas_call at bg_fused.py:645, temporal=False) and temporal (pallas_call
// at bg_fused.py:569, temporal=True). It computes what that kernel computes,
// per frame: the paper's grid creation, 3x3x3 Gaussian filter with per-cell
// normalization (eq. 4), and trilinear slice, unquantized. The temporal
// launch blends each blurred homogeneous plane with the frame's carry,
// B' = (1-a) B + a C, before normalizing it for TI, and writes B' as the
// new carry.
//
// What bounds it on this card: HBM bytes. A frame is read once and written
// once, 8 B per pixel: 16.6 MB for a 1080x1920 frame, 4.95 us at 3.35 TB/s.
// The temporal launch adds the carry, read once and written once:
// 2 x 4 x gx*gy*gz*2 B, 0.48 MB per frame at r=12 (5.24 us in all). The
// arithmetic is about 10^2 FLOP per pixel, far below the fp32 rate.
// What the design does about it: the grid never touches HBM. Each block
// builds the raw grid planes it needs in shared memory, blurs (and blends)
// and normalizes them there, and slices its output rows from there.
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
// Carry planes (temporal). A band blends planes k0..k1 (k1 is its halo,
// which the next band blends too, with the same bits) and writes carry
// planes k0..k1-1; the last band also writes k1..gx-1. With h % r == 0 the
// last plane gx-1 = n+1 is one TI never reads, but the EMA must advance it,
// so the last band builds one more raw plane (n+2, empty) and blends plane
// n+1: the TPU kernel's extra drain step. Each carry plane has exactly one
// writer, and carry_out must not alias carry_in: a neighbour may still read
// C[k1] while its owner writes it. The carry is kept in the JAX package's
// (b, gx, gy, gz, 2) layout; its reads and writes are strided against the
// (plane, channel, z, y) order of shared memory.
//
// Deterministic GC, no float atomics: one thread owns one (raw plane, y
// cell) column of gz bins and adds its r x r pixels into them in row-major
// order. The TPU's one-hot matmul was a workaround for the missing scatter
// and is gone. The validity mask is implicit: a thread visits only rows
// < h of its own frame.
//
// The arithmetic (bins, taps, normalization, lerp order) lives in
// bg_common.cuh, shared with the streamed kernel B3 and the staged kernels
// B4-B6. B1 and B2 are one template, so GC, GF, normalization and TI are the
// same instructions in both; at a == 0 the blend is 1*B + 0*C == B exactly
// (C finite), so an alpha-0 row of B2 is B1 bit for bit.
#include <cuda_runtime.h>

#include "bg_common.cuh"

namespace {

constexpr int kThreads = 256;

// grid: (ceil(n_stripes / band), frames). Shared memory, with T = kTemporal:
//   raw  [band + 3 + T][2][gz][gy]   count, sum of raw planes k0-1 .. p_hi+1
//   norm [band + 1 + T][gz][gy]      normalized (blended) planes k0 .. p_hi
// where p_hi = k1, or gx-1 for the last band of a temporal launch.
// carry_in / carry_out: (frames, gx, gy, gz, 2); alpha: (frames,).
template <bool kTemporal>
__global__ void __launch_bounds__(kThreads)
bg_fused_kernel(const float* __restrict__ img, float* __restrict__ out,
                const float* __restrict__ yf, const float* __restrict__ xf,
                const float* __restrict__ carry_in, float* __restrict__ carry_out,
                const float* __restrict__ alpha,
                int h, int w, int r, int gx, int gy, int gz, int split, int band,
                int n_stripes, float inv_rs, float t0, float t1, float t2) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * band;
  const int k1 = min(k0 + band, n_stripes);
  const bool last = k1 == n_stripes;
  const int p_hi = (kTemporal && last) ? gx - 1 : k1;
  const int plane = gz * gy;
  const int n_norm = p_hi - k0 + 1;
  const int n_raw = n_norm + 2;
  float* raw = smem;
  float* norm = smem + (band + 3 + (kTemporal ? 1 : 0)) * 2 * plane;
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
    bg::gc_cell<true>(im + static_cast<size_t>(i_lo) * w, w, i_hi - i_lo, j_lo,
                      j_hi, inv_rs, gz, cnt, sum, gy);
  }
  __syncthreads();

  // ---- GF (+ EMA) + normalize: plane k0+ql from raw planes k0+ql-1 .. +1
  float a = 0.f, one_minus_a = 1.f;
  const float* c_in = nullptr;
  float* c_out = nullptr;
  if constexpr (kTemporal) {
    a = __ldg(alpha + blockIdx.y);
    one_minus_a = 1.f - a;
    const size_t fc = static_cast<size_t>(blockIdx.y) * gx * plane * 2;
    c_in = carry_in + fc;
    c_out = carry_out + fc;
  }
  const int write_hi = last ? p_hi : k1 - 1;  // last carry plane this band owns
  for (int t = threadIdx.x; t < n_norm * plane; t += blockDim.x) {
    const int ql = t / plane;
    const int zy = t - ql * plane;
    const int z = zy / gy;
    const int y = zy - z * gy;
    const float* rm = raw + ql * 2 * plane;
    const float* rc = rm + 2 * plane;
    const float* rp = rc + 2 * plane;
    float c = bg::blur_cell(rm, rc, rp, z, y, gz, gy, t0, t1, t2);
    float s = bg::blur_cell(rm + plane, rc + plane, rp + plane, z, y, gz, gy,
                            t0, t1, t2);
    if constexpr (kTemporal) {
      const int p = k0 + ql;
      const size_t ci = ((static_cast<size_t>(p) * gy + y) * gz + z) * 2;
      const float2 prev = __ldg(reinterpret_cast<const float2*>(c_in + ci));
      c = bg::blend(c, prev.x, a, one_minus_a);
      s = bg::blend(s, prev.y, a, one_minus_a);
      if (p <= write_hi) *reinterpret_cast<float2*>(c_out + ci) = make_float2(c, s);
    }
    norm[t] = bg::normalize(c, s);
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
    const int y0 = j / r;
    const float* n0 = norm + kl * plane;
    o[off] = bg::ti_pixel(bg::SmemPlanes{n0, n0 + plane, gy}, __ldg(im + off),
                          inv_rs, y0, min(y0 + 1, gy - 1), gz, __ldg(xf + m),
                          __ldg(yf + j));
  }
}

template <bool kTemporal>
int launch(const float* img, float* out, const float* yf, const float* xf,
           const float* carry_in, float* carry_out, const float* alpha, int b,
           int h, int w, int r, int gx, int gy, int gz, int split, int band,
           float inv_rs, float t0, float t1, float t2, int smem_bytes,
           int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(bg_fused_kernel<kTemporal>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_stripes = (h + r - 1) / r;
  const dim3 grid((n_stripes + band - 1) / band, b);
  bg_fused_kernel<kTemporal>
      <<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
          img, out, yf, xf, carry_in, carry_out, alpha, h, w, r, gx, gy, gz,
          split, band, n_stripes, inv_rs, t0, t1, t2);
  return static_cast<int>(cudaGetLastError());
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
                    const float* xf, int b, int h, int w, int r, int gx,
                    int gy, int gz, int split, int band, float inv_rs,
                    float t0, float t1, float t2, int smem_bytes, int device,
                    void* stream) {
  return launch<false>(img, out, yf, xf, nullptr, nullptr, nullptr, b, h, w,
                       r, gx, gy, gz, split, band, inv_rs, t0, t1, t2,
                       smem_bytes, device, stream);
}

// The temporal launch: as bg_fused_launch, plus the contiguous fp32 carries
// (b, gx, gy, gz, 2) in and out (distinct buffers) and alpha (b,).
int bg_fused_temporal_launch(const float* img, float* out,
                             const float* carry_in, float* carry_out,
                             const float* alpha, const float* yf,
                             const float* xf, int b, int h, int w, int r,
                             int gx, int gy, int gz, int split, int band,
                             float inv_rs, float t0, float t1, float t2,
                             int smem_bytes, int device, void* stream) {
  return launch<true>(img, out, yf, xf, carry_in, carry_out, alpha, b, h, w, r,
                      gx, gy, gz, split, band, inv_rs, t0, t1, t2, smem_bytes,
                      device, stream);
}

}  // extern "C"
