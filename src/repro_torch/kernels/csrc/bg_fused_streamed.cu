// Streamed fused bilateral-grid filter (B3) for Hopper, sm_90a: the fused
// GC -> GF -> TI of bg_fused.cu with the frame read from HBM once, streamed
// through a ring of rows in shared memory.
//
// Replaces the TPU kernel src/repro/kernels/bg_fused.py::_stream_kernel
// (pallas_call at bg_fused.py:620): the image stays in HBM and the kernel
// copies stripe s+1 into VMEM while stripe s computes; the validity mask is
// made from counters. Its contract is the TPU kernel's: bit for bit the
// output of the fused kernel (B1), in both storage types (fp32 and bf16,
// the template parameter T, with B1's rounding points; bg_common.cuh).
//
// What bounds it on this card: HBM bytes, as for B1. A frame is read once
// and written once, 8 B per pixel: 16.6 MB for a 1080x1920 frame, 4.95 us at
// 3.35 TB/s; about 10^2 FLOP per pixel, far below the fp32 rate. bf16
// storage halves the bytes (2.48 us).
// What the design does about it: the grid never touches HBM, and each pixel
// of the block's window is copied from HBM once (cp.async, in flight while
// the block bins the rows before it) and stays in shared memory until TI
// of its stripe has read it; B1 reads its window for GC and the rows again
// for TI. What a block reads beyond its own pixels is its halo: one raw
// plane above and two below its band, one raw cell left and two right of
// its tile.
//
// Decomposition. One block owns (frame, band of `band` stripes [k0, k1),
// tile of `tile` column cells [c0, c1)), as B1 does, and walks its band
// in order, as the TPU grid walks a frame: it bins raw planes k0-1 .. k1+1
// over raw cells c0-1 .. c1+1, and when raw plane p is complete it
// normalizes plane p-1 (GF) and slices stripe p-2 (TI). It carries a ring
// of four raw planes (p-2 .. p+1) and two normalized planes. A halo plane
// or cell is computed by the same code in every block that needs it, so
// its bits do not depend on the band, the tile, the batch or the launch.
//
// Rows. Raw plane p takes rows [(p-1)r + split, pr + split); the block
// copies them in chunks of at most `chunk` rows, chunk c+1 in flight while
// chunk c is binned, 16 bytes a copy (cp.async; 4 bytes for a row's
// unaligned head and tail, so any width and any frame offset work). A ring
// row holds the window's columns as they lie in HBM; its stride is w mod 4
// and the ring's rows a multiple of 4, so every row's columns sit at the
// same offset in it. In bf16 a copy moves whole 4-byte words, 8 or 2
// pixels, with w mod 8, rows a multiple of 8: a row whose first or last
// pixel is the odd half of a word copies the word, and its other half
// lands in the row's padding, where nothing reads it. That half is a
// neighbour's pixel, or the 2 bytes just before the tensor or just after
// it, which lie inside the tensor's device allocation (CUDA allocations
// start at 256-byte boundaries and PyTorch's caching allocator rounds its
// blocks up to multiples of 512 bytes: the kernel assumes a granularity of
// at least 4 bytes, as B1 does). TI of stripe k reads its rows when raw
// plane k+2 is complete, with the first chunk of plane k+3 in flight, so
// the ring holds 2r + split + chunk rows, rounded up to a multiple of 4.
//
// GC. When a chunk has landed, a thread computes the z bins of four
// neighbouring pixels of a cell (bg::gc_bin, once per pixel) into the bytes
// of one word, ceil(r/4) words per cell made odd; a pixel outside [0, gz)
// or outside the frame gets no bin (255). Then one thread owns one (z group
// of kZ bins, window
// cell) of the plane for every chunk, z group fastest, so the threads that
// share a cell read the same pixel: it loads those bins, adds the chunk's
// pixels in registers, rows ascending and columns ascending (the order of
// bg::gc_cell, shared with B1 and B4, so the sums are theirs bit for bit:
// a pixel that does not match a bin never touches it), four pixels per
// word of bin bytes, and stores them back. No float atomics. With kZ < gz
// a plane has more tasks than cells.
//
// GF takes the x taps once per value into shared memory (bg::xmix, the
// value B1 computes where it needs it), then bg::blur_zy's z and y taps.
//
// TI is B1's: a thread takes one column of the stripe, y-lerps the corners
// of both planes at every z once into its own table (bg::YLerp's values,
// the same bits), and slices the column's rows four at a time, here from
// the ring, with the x fractions from shared memory. The column cell comes
// from a multiply-high, not a division. GF, normalization and the lerps
// call the functions of bg_common.cuh, as B1 does, on the same operand
// values.
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "bg_common.cuh"
#include "bg_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // TI rows sliced together
constexpr int kMaxDevices = 64;

// x-mixed values of one channel held as [z][cell] with `stride` cells, read
// at global cell y (cell y_lo is at index 0)
struct MixedTile {
  const float* xm;
  int stride, y_lo;
  __device__ __forceinline__ float operator()(int z, int y) const {
    return xm[z * stride + y - y_lo];
  }
};

template <class T>
struct Args {
  const T* img;
  T* out;
  const float* yf;
  const float* xf;
  int h, w, r, gy, gz, split;
  int band, tile, chunk, ring_rows, n_stripes, n_cells;
  unsigned r_magic;  // ceil(2^32 / r): j / r == umulhi(j, r_magic) for r > 1
  float inv_rs, rs, rcp_rs, t0, t1, t2;
};

// grid: (bands, tiles, frames). Shared memory, with NR = tile + 3 raw cells,
// NN = tile + 1 normalized cells, RR = ring_rows (a multiple of E, the T
// elements of 16 bytes: 4 fp32, 8 bf16), RW = the ring's row stride in T
// (fp32: NR*r + 3 to a multiple of 4, plus w mod 4; bf16: NR*r + 8 to a
// multiple of 8, plus w mod 8) and CB = ceil(r/4) | 1:
//   raw   [4][2][gz][NR]        count, sum of raw plane p in slot p & 3
//   norm  [2][gz][NN]           normalized plane q in slot q & 1
//   table [gz][kThreads][2]     each TI thread's y-lerped corners, both
//                               planes of a bin together
//   xmix  [2][gz][NR]           a plane's x-mixed values, for GF
//   xf    [r]                   TI's x lerp fractions
//   ring  [RR][RW] of T         from the next 16-byte boundary: the window's
//                               rows, row i in slot (i - row0) mod RR
//   bins  [chunk][NR][4 CB]     z bin bytes of the chunk's pixels
template <int kZ, class T>
__global__ void __launch_bounds__(kThreads) bg_fused_streamed_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kE = 16 / sizeof(T);   // elements of a 16-byte copy
  constexpr int kW = 4 / sizeof(T);    // elements of a 4-byte word
  const int r = a.r, gz = a.gz, gy = a.gy, w = a.w, h = a.h;
  const int NR = a.tile + 3;
  const int NN = a.tile + 1;
  const int RR = a.ring_rows;
  const int RW =
      bg::kIsFloat<T> ? ((NR * r + 6) & ~3) + (w & 3) : ((NR * r + 15) & ~7) + (w & 7);
  const int CB = ((r + 3) >> 2) | 1;
  const int plane = 2 * gz * NR;  // one raw plane, both channels
  float* raw = smem;
  float* norm = raw + 4 * plane;
  float* table = norm + 2 * gz * NN;
  float* xmix = table + 2 * gz * kThreads;
  float* xfs = xmix + plane;
  T* ring =
      reinterpret_cast<T*>(smem + ((5 * plane + 2 * gz * NN + 2 * gz * kThreads + r + 3) & ~3));
  unsigned* zwords = reinterpret_cast<unsigned*>(ring + RR * RW);
  float2* tab = reinterpret_cast<float2*>(table) + threadIdx.x;

  const int k0 = blockIdx.x * a.band;
  const int k1 = min(k0 + a.band, a.n_stripes);
  const int c0 = blockIdx.y * a.tile;
  const int c1 = min(c0 + a.tile, a.n_cells);
  const int nn_y = c1 - c0 + 1;
  const int nr_y = nn_y + 2;
  const size_t frame = static_cast<size_t>(blockIdx.z) * h * w;
  const T* im = a.img + frame;
  T* o = a.out + frame;

  // The window: column jw + q is column q % r of window cell q / r (raw
  // cell c0-1 + q / r), q in [0, nr_y * r); the frame holds columns
  // [ja, jb) of it. Its rows start at row0, the first row of raw plane
  // k0-1, uncut. Row i lies in ring slot (i - row0) mod RR with column ja
  // at offset off0, the element address mod E of column ja of row0 (the
  // same for every row, as RW = w and RR = 0 mod E), so column jw + q of
  // the row in slot s is at ring[s * RW + q + lead].
  const int jw = (c0 - 2) * r + a.split;
  const int ja = max(jw, 0);
  const int jb = min(jw + nr_y * r, w);
  const int nw = jb - ja;
  const int row0 = (k0 - 2) * r + a.split;
  const int off0 = static_cast<int>(
      ((reinterpret_cast<uintptr_t>(im) / sizeof(T)) + static_cast<long long>(row0) * w + ja) &
      (kE - 1));
  const int lead = off0 - (ja - jw);

  for (int t = threadIdx.x; t < 4 * plane; t += kThreads) raw[t] = 0.f;
  for (int t = threadIdx.x; t < r; t += kThreads) xfs[t] = __ldg(a.xf + t);

  // The chunk sequence: rows [lo, lo + n) of raw plane p, planes k0-1 ..
  // k1+1 in order, each cut to the frame and into chunks of a.chunk rows.
  int seq_p = k0 - 1, seq_row = INT_MIN;
  const auto next_chunk = [&](int& p, int& lo, int& n) {
    for (; seq_p <= k1 + 1; ++seq_p, seq_row = INT_MIN) {
      const int hi = min(seq_p * r + a.split, h);
      seq_row = max(seq_row, max((seq_p - 1) * r + a.split, 0));
      if (seq_row < hi) {
        p = seq_p;
        lo = seq_row;
        n = min(a.chunk, hi - seq_row);
        seq_row += n;
        return true;
      }
    }
    return false;
  };
  // A row is `items` copies of the 4-byte words that hold its pixels: its
  // 16-byte body, then up to three words before it and three after it;
  // thread t takes item t of the chunk's rows laid end to end, `items`
  // apart. In bf16 a row starts at the word of its first pixel, `lag` = 0
  // or 1 pixels before it.
  const int items = ((nw + 2 * (kW - 1)) / kW >> 2) + 6;
  const int item_m = threadIdx.x / items, item_q = threadIdx.x - item_m * items;
  const auto issue = [&](int lo, int n) {
    const int s_lo = (lo - row0) % RR;
    for (int m = item_m, q = item_q; m < n;) {
      int slot = s_lo + m;
      if (slot >= RR) slot -= RR;
      const int lag = (slot * RW + off0) % kW;
      const T* src = im + static_cast<size_t>(lo + m) * w + ja - lag;
      T* dst = ring + slot * RW + off0 - lag;
      const int words = (nw + lag + kW - 1) / kW;
      const int head = min(words, (4 - (((slot * RW + off0 - lag) / kW) & 3)) & 3);
      const int quads = (words - head) >> 2;
      if (q < quads) {
        bg::cp_async16(dst + kW * (head + 4 * q), src + kW * (head + 4 * q));
      } else if (q < quads + head) {
        const int e = q - quads;
        bg::cp_async4(dst + kW * e, src + kW * e);
      } else {
        const int e = head + 4 * quads + q - quads - head;
        if (e < words) bg::cp_async4(dst + kW * e, src + kW * e);
      }
      for (q += kThreads; q >= items; q -= items) ++m;
    }
    bg::cp_async_commit();
  };

  const int n_groups = (gz + kZ - 1) / kZ;
  const int n_tasks = nr_y * n_groups;
  const auto pair = [tab](int z) { return tab[z * kThreads]; };
  const int col_lo = c0 * r;
  const int col_hi = min(c1 * r, w);

  int cur_p = 0, cur_lo = 0, cur_n = 0;
  bool have = next_chunk(cur_p, cur_lo, cur_n);
  if (have) issue(cur_lo, cur_n);
  __syncthreads();  // the zeroed raw planes, xf

  for (int p = k0 - 1; p <= k1 + 1; ++p) {
    // ---- GC of raw plane p, chunk by chunk. A task keeps its thread from
    // chunk to chunk, so its bins need no barrier between chunks.
    float* bins_p = raw + (p & 3) * plane;
    while (have && cur_p == p) {
      int nxt_p = 0, nxt_lo = 0, nxt_n = 0;
      const bool more = next_chunk(nxt_p, nxt_lo, nxt_n);
      if (more) {
        issue(nxt_lo, nxt_n);
        bg::cp_async_wait<1>();
      } else {
        bg::cp_async_wait<0>();
      }
      __syncthreads();  // every thread's copies of the chunk
      const int s_lo = (cur_lo - row0) % RR;
      // z bin bytes: thread t fills word wq of window cell yl in every row
      for (int t = threadIdx.x; t < nr_y * CB; t += kThreads) {
        const int yl = t / CB;
        const int jj0 = 4 * (t - yl * CB);
        const int col0 = jw + yl * r + jj0;
        for (int m = 0; m < cur_n; ++m) {
          int slot = s_lo + m;
          if (slot >= RR) slot -= RR;
          const T* px = ring + slot * RW + lead + yl * r + jj0;
          unsigned word = 0;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int col = col0 + u;
            const int z =
                jj0 + u < r && col >= ja && col < jb ? bg::gc_bin(bg::ld(px + u), a.rs, a.rcp_rs) : -1;
            word |= static_cast<unsigned>(z >= 0 && z < gz ? z : 255) << (8 * u);
          }
          zwords[(m * NR + yl) * CB + t - yl * CB] = word;
        }
      }
      __syncthreads();
      for (int t = threadIdx.x; t < n_tasks; t += kThreads) {
        const int yl = t / n_groups;
        const int z0 = (t - yl * n_groups) * kZ;
        float* bins = bins_p + yl;
        float cnt[kZ], sum[kZ];
#pragma unroll
        for (int k = 0; k < kZ; ++k) {
          cnt[k] = z0 + k < gz ? bins[(z0 + k) * NR] : 0.f;
          sum[k] = z0 + k < gz ? bins[(gz + z0 + k) * NR] : 0.f;
        }
        for (int m = 0; m < cur_n; ++m) {
          int slot = s_lo + m;
          if (slot >= RR) slot -= RR;
          const T* row = ring + slot * RW + lead + yl * r;
          const unsigned* zw = zwords + (m * NR + yl) * CB;
          for (int jj = 0; jj < r; jj += 4) {
            const unsigned word = zw[jj >> 2];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int d = static_cast<int>((word >> (8 * u)) & 255u) - z0;
              const float px = bg::ld(row + jj + u);  // past the cell's r columns: no bin
#pragma unroll
              for (int k = 0; k < kZ; ++k) {
                if (d == k) {
                  cnt[k] += 1.f;
                  sum[k] += px;
                }
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kZ; ++k) {
          if (z0 + k < gz) {
            bins[(z0 + k) * NR] = cnt[k];
            bins[(gz + z0 + k) * NR] = sum[k];
          }
        }
      }
      cur_p = nxt_p;
      cur_lo = nxt_lo;
      cur_n = nxt_n;
      have = more;
    }
    __syncthreads();  // raw plane p is complete

    // ---- GF + normalize of plane q = p-1, cells c0 .. c1, from raw planes
    // q-1 .. q+1 and raw cells c0-1 .. c1+1: the x taps once per value
    // (bg::xmix<T>, the bits of B1's), then the z and y taps
    const int q = p - 1;
    if (q >= k0 && q <= k1) {
      const float* rm = raw + ((q - 1) & 3) * plane;
      const float* rc = raw + (q & 3) * plane;
      const float* rp = raw + ((q + 1) & 3) * plane;
      for (int t = threadIdx.x; t < plane; t += kThreads)
        xmix[t] = bg::xmix<T>(rm, rc, rp, t, a.t0, a.t1, a.t2);
      __syncthreads();
      float* nq = norm + (q & 1) * gz * NN;
      for (int t = threadIdx.x; t < gz * nn_y; t += kThreads) {
        const int z = t / nn_y;
        const int yl = t - z * nn_y;
        const int y = c0 + yl;
        const float c = bg::blur_zy(MixedTile{xmix, NR, c0 - 1}, z, y, gz, gy, a.t0, a.t1, a.t2);
        const float s = bg::blur_zy(MixedTile{xmix + gz * NR, NR, c0 - 1}, z, y, gz, gy, a.t0,
                                    a.t1, a.t2);
        nq[z * NN + yl] = bg::round_to<T>(bg::normalize(c, s));
      }
      __syncthreads();
    }

    // ---- TI of stripe k = p-2 against normalized planes k, k+1, its rows
    // read from the ring
    const int k = p - 2;
    if (k >= k0 && k < k1) {
      const float* n0 = norm + (k & 1) * gz * NN;
      const bg::SmemPlanes planes{n0, norm + ((k + 1) & 1) * gz * NN, NN};
      const int m_hi = min(r, h - k * r);
      const int s0 = (k * r - row0) % RR;
      T* dst = o + static_cast<size_t>(k) * r * w;
      const T* col0 = ring + lead - jw;  // column j of the row in slot s: col0[s * RW + j]
      for (int j = col_lo + threadIdx.x; j < col_hi; j += kThreads) {
        const int y0 = r > 1 ? static_cast<int>(__umulhi(j, a.r_magic)) : j;
        const bg::YLerp<bg::SmemPlanes> yl{planes, y0 - c0, min(y0 + 1, gy - 1) - c0,
                                           __ldg(a.yf + j)};
#pragma unroll 4
        for (int z = 0; z < gz; ++z) tab[z * kThreads] = make_float2(yl(0, z), yl(1, z));
        for (int m0 = 0; m0 < m_hi; m0 += kRows) {
          float px[kRows];
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            int slot = s0 + m0 + u;
            if (slot >= RR) slot -= RR;
            px[u] = m0 + u < m_hi ? bg::ld(col0 + slot * RW + j) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            if (m0 + u < m_hi) {
              // the value first, then its address (as `dst[i] = value`
              // sequences them): fewer registers live across TI
              const float v = bg::ti_pixel_pairs<T>(pair, px[u], a.inv_rs, gz, xfs[m0 + u]);
              bg::st(dst + static_cast<size_t>(m0 + u) * w + j, v);
            }
          }
        }
      }
    }
    // raw plane p-2 is dead (planes p-3 and p-1 are normalized): its slot
    // becomes plane p+2
    float* dead = raw + ((p - 2) & 3) * plane;
    for (int t = threadIdx.x; t < plane; t += kThreads) dead[t] = 0.f;
    __syncthreads();  // the stripe's rows and norm slot are free
  }
}

// Opts kernel<kZ, T> in to `bytes` of dynamic shared memory on `device`
// once per size (the largest so far), not at every launch.
template <int kZ, class T>
cudaError_t opt_in(int device, int bytes) {
  static std::atomic<int> granted[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= granted[device].load()) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      bg_fused_streamed_kernel<kZ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) granted[device].store(bytes);
  return e;
}

template <int kZ, class T>
int launch(const Args<T>& a, int b, int smem_bytes, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = opt_in<kZ, T>(device, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.n_stripes + a.band - 1) / a.band, (a.n_cells + a.tile - 1) / a.tile, b);
  bg_fused_streamed_kernel<kZ, T>
      <<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch's shape and geometry, packed once per shape by the wrapper and
// passed by pointer.
struct StreamShape {
  int b, h, w, r, gy, gz, split, band, tile, chunk, zgroup, ring_rows;
  float inv_rs, rs, rcp_rs, t0, t1, t2;
  int smem_bytes, device;
};

template <class T>
static int launch_shape(const T* img, T* out, const float* yf, const float* xf,
                        const StreamShape* s, void* stream) {
  const int r = s->r;
  const Args<T> a{img, out, yf, xf, s->h, s->w, r, s->gy, s->gz, s->split, s->band, s->tile,
                  s->chunk, s->ring_rows, (s->h + r - 1) / r, (s->w + r - 1) / r,
                  r > 1 ? static_cast<unsigned>(((1ull << 32) + r - 1) / r) : 0u, s->inv_rs,
                  s->rs, s->rcp_rs, s->t0, s->t1, s->t2};
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

extern "C" {

const char* bg_fused_streamed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch on `stream` for `s->b` contiguous (h, w) fp32 frames: blocks of
// `band` stripes x `tile` column cells, chunks of `chunk` rows, GC tasks of
// `zgroup` (1, 2 or 4) z bins, a ring of `ring_rows` rows. Returns
// cudaGetLastError() after the launch (0 on success); never synchronizes.
int bg_fused_streamed_launch(const float* img, float* out, const float* yf, const float* xf,
                             const StreamShape* s, void* stream) {
  return launch_shape<float>(img, out, yf, xf, s, stream);
}

// The same for bf16 frames in and out (ring_rows a multiple of 8, the
// shape's smem_bytes for a bf16 ring); yf and xf stay fp32.
int bg_fused_streamed_bf16_launch(const __nv_bfloat16* img, __nv_bfloat16* out, const float* yf,
                                  const float* xf, const StreamShape* s, void* stream) {
  return launch_shape<__nv_bfloat16>(img, out, yf, xf, s, stream);
}

}  // extern "C"
