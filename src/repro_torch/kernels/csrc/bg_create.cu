// Standalone grid creation (GC, B4) for Hopper, sm_90a: frames -> the
// (count, sum) grid in HBM, in the JAX package's (b, gx, gy, gz, 2) layout.
//
// Replaces the TPU kernel src/repro/kernels/bg_create.py::_kernel
// (pallas_call at bg_create.py:68): one x-plane per grid step, the (r, w)
// rows of the plane (rows padded top by r//2) reduced to (2, gz, gy) by a
// one-hot z matmul against the column one-hot. The top pad of r//2 is the
// same row map as gc_row_split: raw plane x takes rows
// [(x-1)r + split, x r + split), column cell y the columns
// [(y-1)r + split, y r + split). A pixel lies in exactly one cell, so a
// block needs no halo.
//
// What bounds it on this card: HBM bytes. A frame is read once (8.3 MB at
// 1080x1920) and the grid written once (gx*gy*gz*2*4 B, 0.48 MB at r=12):
// 2.62 us at 3.35 TB/s. About 5 FLOP per pixel, far below the fp32 rate.
// What the design does about it: the frame is read once, by the copy engine
// (no thread spends instructions on the bulk of a row), each pixel's z bin
// is computed once, and a cell's sums are added in registers, with no
// shared-memory read-modify-write. What is left above the bound is the
// instruction work of the sums (a task adds each pixel of its cell in
// order, one chain per bin) and the copy of a block's rows, which overlaps
// only other blocks' work at a band of one plane (PERF.md).
//
// Decomposition. One block owns (frame, band of `band` raw planes
// [x0, x1), tile of `tile` column cells [c0, c1)) and walks its planes in
// order. Each plane's rows of the tile's columns are copied into a ring of
// rows in shared memory (bg_copy.cuh): a row's 16-byte-aligned body by one
// bulk copy of the copy engine (cp.async.bulk, Hopper's TMA, counted on an
// mbarrier), its unaligned head and tail by 4-byte cp.async, so any width
// and any frame offset work; plane x+1's copies are in flight while plane
// x is binned (a band of one plane keeps a ring of one plane; the rule
// keeps one plane per block at PAPER_DEFAULT, where the blocks resident
// beside it hide its copy). A ring row holds the tile's
// columns as they lie in HBM: its stride is w mod 4 and the ring's rows a
// multiple of 4, so every row's columns sit at the same offset in it (B3's
// scheme, bg_fused_streamed.cu).
//
// Bins. Thread t takes window columns t, t + kThreads, ... of the plane,
// neighbouring threads on neighbouring columns, walks each down the plane's
// rows and computes each pixel's z bin once (bg::gc_bin) into a byte; a
// pixel whose bin is outside [0, gz), or that lies outside the frame, gets
// 255 (so gz <= 255).
//
// Sums. One task per (z group of kZ bins, cell) of the plane, the z group
// fastest, so the threads of a cell read the same pixels: it adds the
// cell's pixels into registers, rows ascending and columns ascending within
// a row, the order of bg::gc_cell (B1's and B3's GC), so the sums are
// theirs bit for bit; a pixel whose byte is not one of the task's bins
// never touches a sum. No float atomics, so every launch, band, tile and
// batch gives the same bits. A task's kZ (count, sum) pairs are one
// contiguous run of the output, and the tasks of a plane's tile one run of
// tile * gz * 2 floats: each thread stores its run from registers, 16
// bytes a store where aligned, neighbouring threads on neighbouring runs.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "bg_common.cuh"
#include "bg_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

struct Args {
  const float* img;
  float* grid;
  int h, w, r, gx, gy, gz, split;
  int band, tile, ring_rows;
  float rs, rcp_rs;
};

// grid: (ceil(gx / band), ceil(gy / tile), frames). Shared memory, with
// NW = tile * r window columns, ZS = NW to a multiple of 4, RR = ring_rows
// (a multiple of 4) and RW = NW + 3 to a multiple of 4, plus w mod 4:
//   bar   16 bytes              the mbarrier of the rows' bulk copies
//   bins  [r][ZS] bytes         z bin of each pixel of the plane, at least
//                               4r bytes, to a multiple of 16 (a task of
//                               the frame's first cell reads up to r - 1
//                               floats before the ring, into this array,
//                               and drops them: their bytes are 255)
//   ring  [RR][RW] floats       the rows, row i in slot (i - row0) mod RR
template <int kZ>
__global__ void __launch_bounds__(kThreads) bg_create_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int r = a.r, w = a.w, h = a.h, gz = a.gz;
  const int NW = a.tile * r;
  const int ZS = (NW + 3) & ~3;
  const int RR = a.ring_rows;
  const int RW = ((NW + 6) & ~3) + (w & 3);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* zbytes = reinterpret_cast<unsigned char*>(smem + 4);
  float* ring = smem + 4 + ((max(r * ZS, 4 * r) + 15) & ~15) / 4;

  const int x0 = blockIdx.x * a.band;
  const int x1 = min(x0 + a.band, a.gx);
  const int c0 = blockIdx.y * a.tile;
  const int nt = min(c0 + a.tile, a.gy) - c0;  // cells of this tile
  const int ncol = nt * r;                       // their window columns
  const float* im = a.img + static_cast<size_t>(blockIdx.z) * h * w;

  // The window: column jw + q is column q % r of cell c0 + q / r; the frame
  // holds columns [ja, jb) of it (none for a tile past the frame's edge).
  // Rows start at row0, the first row of plane x0, uncut. Row i lies in
  // ring slot (i - row0) mod RR with column ja at offset off0, the float
  // address mod 4 of column ja of row0, so column jw + q of the row in
  // slot s is at ring[s * RW + q + lead].
  const int jw = (c0 - 1) * r + a.split;
  const int ja = max(jw, 0);
  const int jb = min(jw + ncol, w);
  const int nw = jb - ja;
  const int row0 = (x0 - 1) * r + a.split;
  const int off0 = static_cast<int>(
      ((reinterpret_cast<uintptr_t>(im) / sizeof(float)) + static_cast<long long>(row0) * w + ja) &
      3);
  const int lead = off0 - (ja - jw);
  const auto rows_of = [&](int x, int& lo, int& n) {
    lo = max((x - 1) * r + a.split, 0);
    n = max(min(x * r + a.split, h) - lo, 0);
  };

  // A row's 16-byte-aligned body is one bulk copy, issued by thread 0 and
  // counted on the mbarrier; its unaligned head and tail, up to three floats
  // each, are 4-byte copies by the other threads, one float each.
  unsigned phase = 0;
  if (threadIdx.x == 0) bg::mbar_init(bar);
  __syncthreads();
  const auto body = [&](int slot, int& head, int& quads) {
    head = min(nw, (4 - ((slot * RW + off0) & 3)) & 3);
    quads = (nw - head) >> 2;
  };
  const auto issue = [&](int x) {
    int lo, n;
    rows_of(x, lo, n);
    if (nw <= 0) n = 0;
    const int s_lo = (lo - row0) % RR;
    if (threadIdx.x == 0) {
      unsigned bytes = 0;
      for (int m = 0, slot = s_lo; m < n; ++m, slot = slot + 1 == RR ? 0 : slot + 1) {
        int head, quads;
        body(slot, head, quads);
        bytes += 16u * quads;
      }
      bg::mbar_expect(bar, bytes);
      for (int m = 0, slot = s_lo; m < n; ++m, slot = slot + 1 == RR ? 0 : slot + 1) {
        int head, quads;
        body(slot, head, quads);
        if (quads > 0) {
          bg::bulk_copy(ring + slot * RW + off0 + head, im + static_cast<size_t>(lo + m) * w + ja + head,
                        16u * quads, bar);
        }
      }
    }
    for (int i = static_cast<int>(threadIdx.x) - 1; i >= 0 && i < 6 * n; i += kThreads - 1) {
      const int m = i / 6, k = i - 6 * m;
      int slot = s_lo + m;
      if (slot >= RR) slot -= RR;
      int head, quads;
      body(slot, head, quads);
      const int e = k < 3 ? (k < head ? k : nw) : head + 4 * quads + k - 3;
      if (e < nw) bg::cp_async4(ring + slot * RW + off0 + e, im + static_cast<size_t>(lo + m) * w + ja + e);
    }
    bg::cp_async_commit();
  };

  const int n_groups = (gz + kZ - 1) / kZ;
  const int n_tasks = nt * n_groups;

  issue(x0);
  for (int x = x0; x < x1; ++x) {
    bg::mbar_wait(bar, phase);
    phase ^= 1u;
    bg::cp_async_wait<0>();
    __syncthreads();  // plane x has landed; every task of plane x-1 is done
    if (x + 1 < x1) issue(x + 1);  // into the slots of plane x-1: in flight while x is binned
    int lo, n;
    rows_of(x, lo, n);
    const int s_lo = (lo - row0) % RR;

    // ---- z bin bytes of the plane's pixels: thread t takes window columns
    // t, t + kThreads, ... and walks each down the plane's rows
    for (int q = threadIdx.x; q < ncol; q += kThreads) {
      unsigned char* zb = zbytes + q;
      if (static_cast<unsigned>(jw + q - ja) < static_cast<unsigned>(max(nw, 0))) {
        int at = s_lo * RW + lead + q;  // the ring index of row m
#pragma unroll 4
        for (int m = 0; m < n; ++m) {
          const unsigned z = static_cast<unsigned>(bg::gc_bin(ring[at], a.rs, a.rcp_rs));
          zb[m * ZS] = static_cast<unsigned char>(z < static_cast<unsigned>(gz) ? z : 255u);
          at += RW;
          if (at >= RR * RW) at -= RR * RW;
        }
      } else {
        for (int m = 0; m < n; ++m) zb[m * ZS] = 255;
      }
    }
    __syncthreads();

    // ---- (z group, cell) tasks: the cell's pixels added in registers, in
    // bg::gc_cell's order, then stored as the task's run of the output
    float* plane_out = a.grid + ((static_cast<size_t>(blockIdx.z) * a.gx + x) * a.gy + c0) * gz * 2;
    for (int t = threadIdx.x; t < n_tasks; t += kThreads) {
      const int yl = t / n_groups;
      const int z0 = (t - yl * n_groups) * kZ;
      float cnt[kZ], sum[kZ];
#pragma unroll
      for (int k = 0; k < kZ; ++k) cnt[k] = sum[k] = 0.f;
      int slot = s_lo;
      for (int m = 0; m < n; ++m) {
        const float* px_row = ring + slot * RW + lead + yl * r;
        const unsigned char* z_row = zbytes + m * ZS + yl * r;
#pragma unroll 4
        for (int j = 0; j < r; ++j) {
          const int z = z_row[j];
          const float px = px_row[j];  // outside the frame: never added
#pragma unroll
          for (int k = 0; k < kZ; ++k) {
            if (z == z0 + k) {
              cnt[k] += 1.f;
              sum[k] += px;
            }
          }
        }
        if (++slot == RR) slot = 0;
      }
      float* dst = plane_out + (yl * gz + z0) * 2;
#pragma unroll
      for (int k = 0; k < kZ; k += 2) {
        const bool two = k + 1 < kZ && z0 + k + 1 < gz;
        if (two && (reinterpret_cast<uintptr_t>(dst + 2 * k) & 15) == 0) {
          *reinterpret_cast<float4*>(dst + 2 * k) = make_float4(cnt[k], sum[k], cnt[k + 1], sum[k + 1]);
        } else {
          if (z0 + k < gz) *reinterpret_cast<float2*>(dst + 2 * k) = make_float2(cnt[k], sum[k]);
          if (two) *reinterpret_cast<float2*>(dst + 2 * k + 2) = make_float2(cnt[k + 1], sum[k + 1]);
        }
      }
    }
  }
}

// Opts kernel<kZ> in to `bytes` of dynamic shared memory on `device` once
// per size (the largest so far), not at every launch.
template <int kZ>
cudaError_t opt_in(int device, int bytes) {
  static std::atomic<int> granted[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= granted[device].load()) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      bg_create_kernel<kZ>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) granted[device].store(bytes);
  return e;
}

template <int kZ>
int launch(const Args& a, int b, int smem_bytes, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = opt_in<kZ>(device, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.gx + a.band - 1) / a.band, (a.gy + a.tile - 1) / a.tile, b);
  bg_create_kernel<kZ><<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch's shape and geometry, packed once per shape by the wrapper and
// passed by pointer.
struct CreateShape {
  int b, h, w, r, gx, gy, gz, split, band, tile, zgroup, ring_rows;
  float rs, rcp_rs;
  int smem_bytes, device;
};

extern "C" {

const char* bg_create_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest dynamic shared memory a block may opt in to on `device`, in bytes
// (or a negative CUDA error code).
int bg_create_smem_optin(int device) {
  int v = 0;
  cudaError_t e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? v : -static_cast<int>(e);
}

// Launch on `stream`: `s->b` contiguous (h, w) fp32 frames -> the
// contiguous (b, gx, gy, gz, 2) grid, blocks of `band` raw planes x `tile`
// column cells, tasks of `zgroup` (1, 2 or 4) z bins, a ring of
// `ring_rows` rows (a multiple of 4: r or 2r rounded up), `smem_bytes` of
// dynamic shared memory (the wrapper's create_smem_bytes). Returns
// cudaGetLastError() after the launch (0 on success); never synchronizes.
int bg_create_launch(const float* img, float* grid, const CreateShape* s, void* stream) {
  const Args a{img, grid, s->h, s->w, s->r, s->gx, s->gy, s->gz, s->split, s->band, s->tile,
               s->ring_rows, s->rs, s->rcp_rs};
  switch (s->zgroup) {
    case 1:
      return launch<1>(a, s->b, s->smem_bytes, s->device, stream);
    case 2:
      return launch<2>(a, s->b, s->smem_bytes, s->device, stream);
    case 4:
      return launch<4>(a, s->b, s->smem_bytes, s->device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
