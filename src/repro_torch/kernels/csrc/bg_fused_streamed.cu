// Streamed fused bilateral-grid filter (B3) for Hopper, sm_90a: the fused
// GC -> GF -> TI of bg_fused.cu with the image staged through a two-slot
// asynchronous copy ring in shared memory.
//
// Replaces the TPU kernel src/repro/kernels/bg_fused.py::_stream_kernel
// (pallas_call at bg_fused.py:620): the image stays in HBM and the kernel
// copies stripe s+1 into one of two VMEM slots while stripe s computes from
// the other; the validity mask is made from counters. Its contract is the
// TPU kernel's: bit for bit the output of the fused kernel (B1).
//
// What bounds it on this card: HBM bytes, as for B1. A frame is read once
// and written once, 8 B per pixel: 16.6 MB for a 1080x1920 frame, 4.95 us at
// 3.35 TB/s; about 10^2 FLOP per pixel, far below the fp32 rate.
// What the design does about it: the grid never touches HBM, and the image
// reaches GC and TI only through shared memory, copied with cp.async while
// the block computes, so the copy of the next chunk hides behind the work on
// the current one.
//
// Decomposition. One block owns (frame, band of `band` stripes [k0, k1)) and
// walks it in order, as the TPU grid walks a frame: step g bins the rows of
// stripe g (GC), normalizes plane g-1 (GF) and slices stripe g-2 (TI), for
// g = k0-2 .. k1+1. It carries a ring of four raw planes (g-2 .. g+1, the
// last one partial) and two normalized planes from step to step. The first
// step bins only the tail of stripe k0-2 and the last only the head of
// stripe k1+1: exactly the raw planes k0-1 .. k1+1 that B1 builds for the
// same band.
//
// Chunks. A stripe is r rows of the full width (92,160 B at r=12 and full
// HD, 122,880 B at r=16), and two slots of that size do not fit beside the
// planes at every radius. So a slot holds a chunk of at most `chunk` rows.
// The block's input is one sequence of chunks, GC chunks of stripe g then
// TI chunks of stripe g-2 (the rows are copied a second time for TI, as B1
// reads them twice), and chunk c+1 is in flight while chunk c is binned or
// sliced. A chunk's rows are one contiguous run of global memory; it is
// copied 16 B at a time where source and slot are both 16-byte aligned, and
// 4 B at a time for the unaligned head and tail, so any width works (a
// 1918-wide row is 7,672 B, not a multiple of 16).
//
// Bit equality with B1. Raw plane p takes rows [(p-1)r + split, p r +
// split), which straddle two stripes; every cell still adds its pixels rows
// ascending and columns ascending within a row, one owner thread at a time,
// so its sums are B1's. GF, normalization and TI call the same functions of
// bg_common.cuh as B1, on the same operand values.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "bg_common.cuh"
#include "bg_copy.cuh"

namespace {

constexpr int kThreads = 512;

// One staged run of rows [row0, row0 + nrows) of the frame: binned into the
// raw planes of stripe `stripe` (ti false) or sliced as rows of stripe
// `stripe` (ti true). Before it, planes up to `gf_hi` are normalized.
struct Chunk {
  int row0, nrows, stripe, gf_hi;
  bool ti;
};

// The block's chunk sequence; every thread walks it in step.
struct Schedule {
  int k0, k1, r, h, split, chunk;
  int g, phase, row;

  __device__ void rows(int& lo, int& hi) const {
    if (phase == 0) {  // GC rows of stripe g, cut to planes k0-1 .. k1+1
      lo = g * r + (g == k0 - 2 ? split : 0);
      hi = g * r + (g == k1 + 1 ? split : r);
    } else {  // TI rows of stripe g-2 when it is in the band
      const int k = g - 2;
      lo = k * r;
      hi = (k >= k0 && k < k1) ? k * r + r : lo;
    }
    lo = max(lo, 0);
    hi = min(hi, h);
  }

  __device__ bool next(Chunk& c) {
    while (g <= k1 + 1) {
      int lo, hi;
      rows(lo, hi);
      if (row == INT_MIN) row = lo;
      if (row < hi) {
        c.row0 = row;
        c.nrows = min(chunk, hi - row);
        c.ti = phase == 1;
        c.stripe = c.ti ? g - 2 : g;
        // GC of stripe g needs planes <= g-2 normalized (their raw slots
        // are reused); TI of stripe g-2 needs planes g-2 and g-1
        c.gf_hi = min(c.ti ? g - 1 : g - 2, k1);
        row += c.nrows;
        return true;
      }
      row = INT_MIN;
      if (phase == 0) {
        phase = 1;
      } else {
        phase = 0;
        ++g;
      }
    }
    return false;
  }
};

// Copy the chunk's rows into `slot`; returns the slot offset of element 0
// (the source's float index mod 4, so that both sides share 16 B alignment).
__device__ __forceinline__ int issue(const Chunk& c, const float* im, int w,
                                     float* slot) {
  const float* src = im + static_cast<size_t>(c.row0) * w;
  const int n = c.nrows * w;
  const int off = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min(n, (4 - off) & 3);
  const int quads = (n - head) >> 2;
  float* dst = slot + off;
  for (int q = threadIdx.x; q < quads; q += blockDim.x)
    bg::cp_async16(dst + head + 4 * q, src + head + 4 * q);
  const int tail0 = head + 4 * quads;
  const int t = threadIdx.x;
  if (t < head) bg::cp_async4(dst + t, src + t);
  if (t >= 4 && t - 4 < n - tail0) bg::cp_async4(dst + tail0 + t - 4, src + tail0 + t - 4);
  bg::cp_async_commit();
  return off;
}

__device__ __forceinline__ int ring(int p) { return (p + 4) & 3; }

// grid: (ceil(n_stripes / band), frames). Shared memory:
//   raw  [4][2][gz][gy]  ring of raw planes (count, sum), plane p in slot p mod 4
//   norm [2][gz][gy]     normalized planes, plane q in slot q mod 2
//   slots[2][slot_floats] the staged chunks, from the first 16-byte boundary
__global__ void __launch_bounds__(kThreads, 1)
bg_fused_streamed_kernel(const float* __restrict__ img, float* __restrict__ out,
                         const float* __restrict__ yf, const float* __restrict__ xf,
                         int h, int w, int r, int gy, int gz, int split, int band,
                         int n_stripes, int chunk, int slot_floats, float inv_rs,
                         float t0, float t1, float t2) {
  extern __shared__ __align__(16) float smem[];
  const int plane = gz * gy;
  float* raw = smem;
  float* norm = raw + 8 * plane;
  float* slots = smem + ((10 * plane + 3) & ~3);  // 16-byte aligned
  const int k0 = blockIdx.x * band;
  const int k1 = min(k0 + band, n_stripes);
  const size_t frame = static_cast<size_t>(blockIdx.y) * h * w;
  const float* im = img + frame;
  float* o = out + frame;

  for (int t = threadIdx.x; t < 8 * plane; t += blockDim.x) raw[t] = 0.f;

  Schedule sched{k0, k1, r, h, split, chunk, k0 - 2, 0, INT_MIN};
  Chunk cur, nxt;
  bool have = sched.next(cur);
  int cur_off = have ? issue(cur, im, w, slots) : 0;
  int slot = 0;
  int gf_next = k0;  // next plane to normalize
  __syncthreads();

  while (have) {
    const bool more = sched.next(nxt);
    int nxt_off = 0;
    if (more) nxt_off = issue(nxt, im, w, slots + (slot ^ 1) * slot_floats);

    // ---- GF + normalize of planes gf_next .. cur.gf_hi (overlaps the copies)
    for (; gf_next <= cur.gf_hi; ++gf_next) {
      const int q = gf_next;
      const float* rm = raw + ring(q - 1) * 2 * plane;
      const float* rc = raw + ring(q) * 2 * plane;
      const float* rp = raw + ring(q + 1) * 2 * plane;
      float* nq = norm + (q & 1) * plane;
      for (int t = threadIdx.x; t < plane; t += blockDim.x) {
        const int z = t / gy;
        const int y = t - z * gy;
        const float c = bg::blur_cell(rm, rc, rp, z, y, gz, gy, t0, t1, t2);
        const float s = bg::blur_cell(rm + plane, rc + plane, rp + plane, z, y,
                                      gz, gy, t0, t1, t2);
        nq[t] = bg::normalize(c, s);
      }
      __syncthreads();
      // raw plane q-1 is dead: its slot becomes plane q+3
      float* dead = raw + ring(q - 1) * 2 * plane;
      for (int t = threadIdx.x; t < 2 * plane; t += blockDim.x) dead[t] = 0.f;
      __syncthreads();
    }

    if (more) bg::cp_async_wait<1>(); else bg::cp_async_wait<0>();
    __syncthreads();
    const float* px = slots + slot * slot_floats + cur_off;

    if (!cur.ti) {
      // ---- GC: rows before stripe*r + split go to plane `stripe`, the rest
      // to plane stripe+1; one owner per (plane, column cell)
      const int cut = cur.stripe * r + split;
      const int end = cur.row0 + cur.nrows;
      for (int t = threadIdx.x; t < 2 * gy; t += blockDim.x) {
        const int part = t >= gy;
        const int y = t - part * gy;
        const int i_lo = part ? max(cur.row0, cut) : cur.row0;
        const int i_hi = part ? end : min(end, cut);
        if (i_lo >= i_hi) continue;
        float* cnt = raw + ring(cur.stripe + part) * 2 * plane + y;
        const int j_lo = max((y - 1) * r + split, 0);
        const int j_hi = min(y * r + split, w);
        bg::gc_cell<false>(px + (i_lo - cur.row0) * w, w, i_hi - i_lo, j_lo, j_hi,
                           inv_rs, gz, cnt, cnt + plane, gy);
      }
    } else {
      // ---- TI of the chunk's rows against normalized planes k and k+1
      const int k = cur.stripe;
      const bg::SmemPlanes planes{norm + (k & 1) * plane, norm + ((k + 1) & 1) * plane, gy};
      const int npx = cur.nrows * w;
      const int m0 = cur.row0 - k * r;
      for (int t = threadIdx.x; t < npx; t += blockDim.x) {
        const int ii = t / w;
        const int j = t - ii * w;
        const int y0 = j / r;
        o[static_cast<size_t>(cur.row0 + ii) * w + j] =
            bg::ti_pixel(planes, px[t], inv_rs, y0, min(y0 + 1, gy - 1), gz,
                         __ldg(xf + m0 + ii), __ldg(yf + j));
      }
    }
    __syncthreads();  // the slot is free for the copy after next
    cur = nxt;
    cur_off = nxt_off;
    have = more;
    slot ^= 1;
  }
}

}  // namespace

extern "C" {

const char* bg_fused_streamed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch on `stream` for `b` contiguous (h, w) fp32 frames. Returns
// cudaGetLastError() after the launch (0 on success); never synchronizes.
int bg_fused_streamed_launch(const float* img, float* out, const float* yf,
                             const float* xf, int b, int h, int w, int r,
                             int gy, int gz, int split, int band, int chunk,
                             int slot_floats, float inv_rs, float t0, float t1,
                             float t2, int smem_bytes, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(bg_fused_streamed_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_stripes = (h + r - 1) / r;
  const dim3 grid((n_stripes + band - 1) / band, b);
  bg_fused_streamed_kernel<<<grid, kThreads, smem_bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      img, out, yf, xf, h, w, r, gy, gz, split, band, n_stripes, chunk,
      slot_floats, inv_rs, t0, t1, t2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
