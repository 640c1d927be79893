// Fused bilateral-grid filter (GC -> GF -> TI) for Hopper, sm_90a, per frame
// (B1) and with the temporal grid EMA (B2).
//
// Replaces the TPU kernel src/repro/kernels/bg_fused.py::_kernel with
// _pipeline_step, in both of its launches and both storage types (fp32 and
// bf16, the template parameter T; bg_common.cuh): per frame
// (pallas_call at bg_fused.py:645, temporal=False) and temporal (pallas_call
// at bg_fused.py:569, temporal=True). It computes what that kernel computes,
// per frame: the paper's grid creation, 3x3x3 Gaussian filter with per-cell
// normalization (eq. 4), and trilinear slice, unquantized unless the shape
// asks for the plan's output quantization, which TI's store then applies
// (bg::st_out). The temporal
// launch blends each blurred homogeneous plane with the frame's carry,
// B' = (1-a) B + a C, before normalizing it for TI, and writes B' as the
// new carry.
//
// What bounds it on this card: HBM bytes. A frame is read once and written
// once, 8 B per pixel: 16.6 MB for a 1080x1920 frame, 4.95 us at 3.35 TB/s.
// The temporal launch adds the carry, read once and written once:
// 2 x 4 x gx*gy*gz*2 B, 0.48 MB per frame at r=12 (5.24 us in all). The
// arithmetic is about 10^2 FLOP per pixel, far below the fp32 rate. bf16
// storage halves every one of those bytes (2.48 us and 2.62 us per frame).
// What the design does about it: the grid never touches HBM. Each block
// builds the raw grid cells it needs in shared memory, blurs (and blends)
// and normalizes them there, and slices its output pixels from there. Short
// of the bound, what costs is latency and instructions per pixel in GC
// (the copy of the block's window and the binning) and in TI, so both keep
// many loads in flight and little work per pixel.
//
// Decomposition. Blocks run in no order, so one block owns (frame, band of
// `band` stripes [k0, k1), tile of `tile` column cells [c0, c1)) and
// recomputes its halo in both directions: TI of stripe k and column cell y
// reads normalized planes k, k+1 and cells y, y+1; those need raw planes
// k-1..k+2 and cells y-1..y+2, so the block builds raw planes k0-1..k1+1 and
// raw cells c0-1..c1+1. A halo plane or cell is computed by the same code
// in every block that needs it, so its bits do not depend on the band, the
// tile, the batch or the launch. Tiling the columns bounds the working set
// (r=2 at full HD fits), and gives a small batch enough blocks to fill the
// card.
//
// GC. The block's image window (the rows of its raw planes, the columns of
// its raw cells) streams through a two-slot ring in shared memory in steps
// of `rows` rows of every raw plane at once, copied with 4-byte cp.async
// (coalesced reads of global memory) while the block bins the step before
// it. A slot holds the rows transposed, [plane][row][column in cell][cell],
// so the threads that bin neighbouring cells read neighbouring words. One
// thread owns one (raw plane, raw cell, group of kZ = 4 z bins) per step: it
// loads those bins, adds the step's pixels in registers, rows ascending and
// columns ascending (the order of bg::gc_cell, shared with B3 and B4, so
// the sums are theirs bit for bit), and stores them back. No float atomics.
// Taking every plane in each step gives the block (band + 3) x as many
// binning tasks and as many fewer round trips to memory as per-plane steps.
// bf16 frames cannot go through the transposed slot (cp.async moves 4 bytes
// at least, two pixels): a bf16 slot holds each row as it lies in HBM, in
// 4-byte words aligned as in HBM (the row's first column at the parity of
// its element address), and the binning threads read the cell's columns
// from it, in the same order. A row's first or last word may hold a pixel
// outside the window, which nothing reads: a neighbour's, or the 2 bytes
// just before the tensor or just after it. Those lie inside the tensor's
// device allocation: CUDA allocations start at 256-byte boundaries and
// PyTorch's caching allocator rounds its blocks up to multiples of 512
// bytes, so a 4-byte-aligned word that holds a byte of the tensor lies in
// its allocation. The kernel assumes that granularity (at least 4 bytes).
//
// Carry planes (temporal). A block blends planes k0..k1 and cells c0..c1
// (the last halo plane and cell are blended by its neighbours too, with the
// same bits) and writes the carry of planes k0..k1-1 and cells c0..c1-1; the
// last band also writes planes k1..gx-1 and the last tile cells c1..gy-1.
// With h % r == 0 the last plane gx-1 = n+1 is one TI never reads, but the
// EMA must advance it, so the last band builds one more raw plane (n+2,
// empty) and blends plane n+1: the TPU kernel's extra drain step. The y
// axis drains the same way (w % r == 0 gives a cell gy-1 that TI never
// reads). Each carry cell has exactly one writer, and carry_out must not
// alias carry_in: a neighbour may still read a halo cell while its owner
// writes it. The carry is kept in the JAX package's (b, gx, gy, gz, 2)
// layout.
//
// bf16 storage (T = __nv_bfloat16) rounds where kernels/bg_fused.py's
// docstring says: the frames are bf16 in HBM; a raw cell is summed in fp32
// and rounded as GF reads it (bg::xmix<T>); GF, the blend and the
// normalization compute in fp32; the carry is read and written as bf16; a
// normalized value is rounded as it is stored; TI's z weights are rounded
// (bg::zlerp<T>); the output is stored as bf16, quantized (when asked)
// from its bf16 value.
//
// TI. A thread takes one column of a stripe (neighbouring threads on
// neighbouring columns, so loads and stores are coalesced), y-lerps the
// corners of both planes at every z once for the stripe, and slices the
// column's rows four at a time, their loads issued together. The column
// cell comes from a multiply-high, not a division.
//
// The arithmetic (bins, taps, normalization, lerp order) lives in
// bg_common.cuh, shared with the streamed kernel B3 and the staged kernels
// B4-B6. B1 and B2 are one template, so GC, GF, normalization and TI are the
// same instructions in both; at a == 0 the blend is 1*B + 0*C == B exactly
// (C finite), so an alpha-0 row of B2 is B1 bit for bit.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "bg_common.cuh"
#include "bg_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kZ = 4;  // z bins per GC task (all of them at gz <= 4)
constexpr int kMaxDevices = 64;

template <class T>
struct Args {
  const T* img;
  T* out;
  const float* yf;
  const float* xf;
  const T* carry_in;
  T* carry_out;
  const float* alpha;
  int h, w, r, gx, gy, gz, split;
  int band, tile, rows, n_stripes, n_cells;
  unsigned r_magic;  // ceil(2^32 / r): j / r == umulhi(j, r_magic) for r > 1
  float inv_rs, rs, rcp_rs, t0, t1, t2;
  int quantize;  // TI stores bg::quantize of each pixel, clamped to imax
  float imax;
};

// x-mixed values of three raw planes held as [z][cell] with `stride` cells,
// read at global cell y (cell y_lo is at index 0), each raw value rounded to
// the storage type T
template <class T>
struct TileMix {
  const float *rm, *rc, *rp;
  int stride, y_lo;
  float t0, t1, t2;
  __device__ __forceinline__ float operator()(int z, int y) const {
    return bg::xmix<T>(rm, rc, rp, z * stride + y - y_lo, t0, t1, t2);
  }
};

// grid: (bands, tiles, frames). Shared memory, with kT = kTemporal,
// NR = tile + 3 raw cells, NN = tile + 1 normalized cells and SC = NR | 1:
//   raw   [band + 3 + kT][2][gz][NR]  count, sum of raw planes k0-1 ..
//   norm  [band + 1][gz][NN]          normalized planes k0 .. k1, cells
//                                     c0 .. c1 (what TI reads)
//   slots [2][band + 3][rows][r][SC]  GC steps: `rows` rows of every raw
//                                     plane that has rows, transposed per
//                                     cell (fp32), or [2][band + 3][rows][RS]
//                                     of T, RS = NR*r + 2 made even, each
//                                     slot to 16 bytes (bf16); in TI
//                                     [gz][2][kThreads], each thread's
//                                     y-lerped corners
// A temporal drain plane (or cell) is blended into the carry but never
// normalized. The raw plane past it has no rows but is read as zeros; the
// raw cell past it has no columns and is never read (blur_zy's y bound),
// so it has no room.
// carry_in / carry_out: (frames, gx, gy, gz, 2); alpha: (frames,).
template <bool kTemporal, class T>
__global__ void __launch_bounds__(kThreads) bg_fused_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kF = bg::kIsFloat<T>;
  constexpr int kT = kTemporal ? 1 : 0;
  const int r = a.r, gz = a.gz, gy = a.gy, w = a.w;
  const int NR = a.tile + 3;
  const int NN = a.tile + 1;
  const int SC = NR | 1;
  const int RS = (NR * r + 3) & ~1;  // a bf16 slot row, in elements
  float* raw = smem;
  float* norm = raw + (a.band + 3 + kT) * 2 * gz * NR;
  float* slots = norm + (a.band + 1) * gz * NN;
  const int slot_floats =
      kF ? (a.band + 3) * a.rows * r * SC : ((a.band + 3) * a.rows * RS * 2 + 15) / 16 * 4;
  float* ylerp = slots + threadIdx.x;  // TI reuses the GC slots

  const int k0 = blockIdx.x * a.band;
  const int k1 = min(k0 + a.band, a.n_stripes);
  const bool last_x = k1 == a.n_stripes;
  const int c0 = blockIdx.y * a.tile;
  const int c1 = min(c0 + a.tile, a.n_cells);
  const bool last_y = c1 == a.n_cells;
  const int nx_hi = (kTemporal && last_x) ? a.gx - 1 : k1;  // last normalized plane
  const int ny_hi = (kTemporal && last_y) ? gy - 1 : c1;    // last normalized cell
  const int n_norm = nx_hi - k0 + 1;
  const int n_raw = n_norm + 2;
  const int nn_y = ny_hi - c0 + 1;
  const int nr_y = nn_y + 2;
  const size_t frame = static_cast<size_t>(blockIdx.z) * a.h * w;
  const T* im = a.img + frame;
  T* o = a.out + frame;

  for (int t = threadIdx.x; t < n_raw * 2 * gz * NR; t += kThreads) raw[t] = 0.f;

  // ---- GC. Window column jw + q is column q % r of raw cell c0-1 + q / r;
  // raw plane k0-1+pl holds rows row0 + pl*r + m, m in [0, r), cut to the
  // frame. Step s copies offsets m in [s*R, s*R + R) of every raw plane.
  const int jw = (c0 - 2) * r + a.split;
  const int ja = max(jw, 0);
  const int jb = min(jw + nr_y * r, w);
  const int row0 = (k0 - 2) * r + a.split;
  const int R = a.rows;
  const int n_steps = (r + R - 1) / R;
  const int q0 = ja - jw + threadIdx.x;
  const int cell0 = q0 / r, jj0 = q0 - cell0 * r;
  const int step_c = kThreads / r, step_j = kThreads - step_c * r;
  // bf16: the parity of column ja's element address in row 0; row i's is
  // par0 ^ (i * w & 1)
  const int par0 = static_cast<int>(((reinterpret_cast<uintptr_t>(im) >> 1) + ja) & 1);
  const int nw = jb - ja;
  auto issue = [&](int step, float* slot) {
    const int m0 = step * R, m1 = min(m0 + R, r);
    if constexpr (!kF) {
      // row (pl, m) of the step in slot row pl*R + m - m0, column j at
      // element p + j - ja: ceil((p + nw) / 2) words, the first one from
      // column ja - p (its other half is never read; see the top of the
      // file for why it lies inside the tensor's allocation)
      const int nm = m1 - m0;
      const int words = (nw + 2) >> 1;
      T* dst0 = reinterpret_cast<T*>(slot);
      for (int it = threadIdx.x; it < n_raw * nm * words; it += kThreads) {
        const int row = it / words;
        const int k = it - row * words;
        const int pl = row / nm;
        const int m = m0 + row - pl * nm;
        const int i = row0 + pl * r + m;
        if (i < 0 || i >= a.h) continue;
        const int p = par0 ^ (i & w & 1);
        if (2 * k >= p + nw) continue;
        bg::cp_async4(dst0 + (pl * R + m - m0) * RS + 2 * k,
                      im + static_cast<size_t>(i) * w + ja - p + 2 * k);
      }
    } else {
      for (int pl = 0; pl < n_raw; ++pl) {
        for (int m = m0; m < m1; ++m) {
          const int i = row0 + pl * r + m;
          if (i < 0 || i >= a.h) continue;
          const T* src = im + static_cast<size_t>(i) * w;
          float* dst = slot + (pl * R + m - m0) * r * SC;
          int cell = cell0, jj = jj0;
          for (int j = ja + threadIdx.x; j < jb; j += kThreads) {
            bg::cp_async4(dst + jj * SC + cell, src + j);
            jj += step_j;
            cell += step_c;
            if (jj >= r) {
              jj -= r;
              ++cell;
            }
          }
        }
      }
    }
    bg::cp_async_commit();
  };
  const int n_groups = (gz + kZ - 1) / kZ;
  const int n_tasks = n_raw * n_groups * nr_y;
  issue(0, slots);
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      issue(step + 1, slots + ((step + 1) & 1) * slot_floats);
      bg::cp_async_wait<1>();
    } else {
      bg::cp_async_wait<0>();
    }
    __syncthreads();
    const float* slot = slots + (step & 1) * slot_floats;
    const int m0 = step * R, m1 = min(m0 + R, r);
    for (int t = threadIdx.x; t < n_tasks; t += kThreads) {
      const int yl = t % nr_y;
      const int rest = t / nr_y;
      const int pl = rest / n_groups;
      const int z0 = (rest - pl * n_groups) * kZ;
      const int first = row0 + pl * r;  // the plane's first row, uncut
      const int m_lo = max(m0, -first);
      const int m_hi = min(m1, a.h - first);
      if (m_lo >= m_hi) continue;
      const int cs = jw + yl * r;  // first column of raw cell c0-1+yl, uncut
      const int jj_lo = max(cs, 0) - cs;
      const int jj_hi = min(cs + r, w) - cs;
      if (jj_lo >= jj_hi) continue;  // no columns: its bins stay zero
      float* bins = raw + pl * 2 * gz * NR + yl;
      float cnt[kZ], sum[kZ];
#pragma unroll
      for (int k = 0; k < kZ; ++k) {
        cnt[k] = z0 + k < gz ? bins[(z0 + k) * NR] : 0.f;
        sum[k] = z0 + k < gz ? bins[(gz + z0 + k) * NR] : 0.f;
      }
      for (int m = m_lo; m < m_hi; ++m) {
        const float* row = slot + (pl * R + m - m0) * r * SC + yl;
        // bf16: the cell's first column, uncut, in its slot row
        const T* trow = reinterpret_cast<const T*>(slot) + (pl * R + m - m0) * RS +
                        (par0 ^ ((first + m) & w & 1)) + cs - ja;
        for (int jj = jj_lo; jj < jj_hi; ++jj) {
          const float px = kF ? row[jj * SC] : bg::ld(trow + jj);
          const int d = bg::gc_bin(px, a.rs, a.rcp_rs) - z0;
#pragma unroll
          for (int k = 0; k < kZ; ++k) {
            if (d == k) {
              cnt[k] += 1.f;
              sum[k] += px;
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
    __syncthreads();  // the slot is free for the step after next
  }

  // ---- GF (+ EMA) + normalize: plane k0+ql, cell c0+yl from raw planes
  // k0+ql-1 .. +1 and raw cells c0+yl-1 .. +1
  float al = 0.f, one_minus_a = 1.f;
  const T* c_in = nullptr;
  T* c_out = nullptr;
  if constexpr (kTemporal) {
    al = __ldg(a.alpha + blockIdx.z);
    one_minus_a = 1.f - al;
    const size_t fc = static_cast<size_t>(blockIdx.z) * a.gx * gy * gz * 2;
    c_in = a.carry_in + fc;
    c_out = a.carry_out + fc;
  }
  const int wx_hi = last_x ? nx_hi : k1 - 1;  // last carry plane this block owns
  const int wy_hi = last_y ? ny_hi : c1 - 1;  // last carry cell this block owns
  const int per_plane = gz * nn_y;
  for (int t = threadIdx.x; t < n_norm * per_plane; t += kThreads) {
    const int ql = t / per_plane;
    const int zy = t - ql * per_plane;
    const int z = zy / nn_y;
    const int yl = zy - z * nn_y;
    const int y = c0 + yl;
    const float* rm = raw + ql * 2 * gz * NR;
    const float* rc = rm + 2 * gz * NR;
    const float* rp = rc + 2 * gz * NR;
    float c = bg::blur_zy(TileMix<T>{rm, rc, rp, NR, c0 - 1, a.t0, a.t1, a.t2}, z, y, gz,
                          gy, a.t0, a.t1, a.t2);
    float s = bg::blur_zy(TileMix<T>{rm + gz * NR, rc + gz * NR, rp + gz * NR, NR, c0 - 1,
                                     a.t0, a.t1, a.t2},
                          z, y, gz, gy, a.t0, a.t1, a.t2);
    if constexpr (kTemporal) {
      const int p = k0 + ql;
      const size_t ci = ((static_cast<size_t>(p) * gy + y) * gz + z) * 2;
      float2 prev;
      if constexpr (kF) {
        prev = __ldg(reinterpret_cast<const float2*>(c_in + ci));
      } else {
        prev = make_float2(bg::ldg(c_in + ci), bg::ldg(c_in + ci + 1));
      }
      c = bg::blend(c, prev.x, al, one_minus_a);
      s = bg::blend(s, prev.y, al, one_minus_a);
      if (p <= wx_hi && y <= wy_hi) {
        if constexpr (kF) {
          *reinterpret_cast<float2*>(c_out + ci) = make_float2(c, s);
        } else {
          bg::st(c_out + ci, c);
          bg::st(c_out + ci + 1, s);
        }
      }
    }
    if (k0 + ql <= k1 && y <= c1)
      norm[ql * gz * NN + z * NN + yl] = bg::round_to<T>(bg::normalize(c, s));
  }
  __syncthreads();

  // ---- TI of the band's rows and the tile's columns against normalized
  // planes k, k+1 and cells y, y+1. A thread takes one column of a stripe:
  // it y-lerps the corners of both planes at every z once into its own
  // table (bg::YLerp's values, the same bits), then loads kRows of the
  // column's rows before it slices them, so that many image loads are in
  // flight at once.
  constexpr int kRows = 4;
  const int col_lo = c0 * r;
  const int col_hi = min(c1 * r, w);
  const auto table = [ylerp](int p, int z) { return ylerp[(2 * z + p) * kThreads]; };
  for (int k = k0; k < k1; ++k) {
    const float* n0 = norm + (k - k0) * gz * NN;
    const bg::SmemPlanes planes{n0, n0 + gz * NN, NN};
    const int m_hi = min(r, a.h - k * r);
    const T* src = im + static_cast<size_t>(k) * r * w;
    T* dst = o + static_cast<size_t>(k) * r * w;
    for (int j = col_lo + threadIdx.x; j < col_hi; j += kThreads) {
      const int y0 = r > 1 ? static_cast<int>(__umulhi(j, a.r_magic)) : j;
      const bg::YLerp<bg::SmemPlanes> yl{planes, y0 - c0, min(y0 + 1, gy - 1) - c0,
                                         __ldg(a.yf + j)};
      for (int z = 0; z < gz; ++z) {
        ylerp[(2 * z) * kThreads] = yl(0, z);
        ylerp[(2 * z + 1) * kThreads] = yl(1, z);
      }
      for (int m0 = 0; m0 < m_hi; m0 += kRows) {
        float px[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          px[u] = m0 + u < m_hi ? bg::ldg(src + static_cast<size_t>(m0 + u) * w + j) : 0.f;
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (m0 + u < m_hi) {
            // the value first, then its address (as `dst[i] = value`
            // sequences them): fewer registers live across TI
            const float v = bg::ti_pixel_y<T>(table, px[u], a.inv_rs, gz, __ldg(a.xf + m0 + u));
            bg::st_out(dst + static_cast<size_t>(m0 + u) * w + j, v, a.quantize, a.imax);
          }
        }
      }
    }
  }
}

// Opts `kernel` in to `bytes` of dynamic shared memory on `device` once per
// size (the largest so far), not at every launch: the call costs host time
// on every launch of a kernel that takes a few microseconds.
template <bool kTemporal, class T>
cudaError_t opt_in(int device, int bytes) {
  static std::atomic<int> granted[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= granted[device].load()) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      bg_fused_kernel<kTemporal, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) granted[device].store(bytes);
  return e;
}

template <bool kTemporal, class T>
int launch(const Args<T>& a, int b, int smem_bytes, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = opt_in<kTemporal, T>(device, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.n_stripes + a.band - 1) / a.band, (a.n_cells + a.tile - 1) / a.tile, b);
  bg_fused_kernel<kTemporal, T>
      <<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch's shape and geometry, packed once per shape by the wrapper and
// passed by pointer (a ctypes call converts each scalar argument on the
// host, and a launch of tens of microseconds must not wait on that).
struct LaunchShape {
  int b, h, w, r, gx, gy, gz, split, band, tile, rows;
  float inv_rs, rs, rcp_rs, t0, t1, t2;
  int smem_bytes, device;
  int quantize;  // 1: the plan's output quantization in TI's store
  float imax;    // its clamp, the config's intensity_max
};

template <class T>
static Args<T> make_args(const T* img, T* out, const float* yf, const float* xf,
                         const T* carry_in, T* carry_out, const float* alpha,
                         const LaunchShape& s) {
  const int r = s.r;
  return Args<T>{img, out, yf, xf, carry_in, carry_out, alpha, s.h, s.w, r, s.gx, s.gy, s.gz,
              s.split, s.band, s.tile, s.rows, (s.h + r - 1) / r, (s.w + r - 1) / r,
              r > 1 ? static_cast<unsigned>(((1ull << 32) + r - 1) / r) : 0u, s.inv_rs,
              s.rs, s.rcp_rs, s.t0, s.t1, s.t2, s.quantize, s.imax};
}

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

// Launch on `stream` for `s->b` contiguous (h, w) fp32 frames: blocks of
// `band` stripes x `tile` column cells, GC steps of `rows` rows of every raw
// plane. Returns cudaGetLastError() after the launch (0 on success); never
// synchronizes.
int bg_fused_launch(const float* img, float* out, const float* yf, const float* xf,
                    const LaunchShape* s, void* stream) {
  const Args<float> a = make_args<float>(img, out, yf, xf, nullptr, nullptr, nullptr, *s);
  return launch<false>(a, s->b, s->smem_bytes, s->device, stream);
}

// The temporal launch: as bg_fused_launch, plus the contiguous fp32 carries
// (b, gx, gy, gz, 2) in and out (distinct buffers) and alpha (b,).
int bg_fused_temporal_launch(const float* img, float* out, const float* carry_in,
                             float* carry_out, const float* alpha, const float* yf,
                             const float* xf, const LaunchShape* s, void* stream) {
  const Args<float> a = make_args<float>(img, out, yf, xf, carry_in, carry_out, alpha, *s);
  return launch<true>(a, s->b, s->smem_bytes, s->device, stream);
}

// bg_fused_launch with bf16 frames in and out (the shape's smem_bytes for
// bf16 slots); yf and xf stay fp32.
int bg_fused_bf16_launch(const __nv_bfloat16* img, __nv_bfloat16* out, const float* yf,
                         const float* xf, const LaunchShape* s, void* stream) {
  const Args<__nv_bfloat16> a =
      make_args<__nv_bfloat16>(img, out, yf, xf, nullptr, nullptr, nullptr, *s);
  return launch<false>(a, s->b, s->smem_bytes, s->device, stream);
}

// bg_fused_temporal_launch with bf16 frames and carries; alpha stays fp32.
int bg_fused_temporal_bf16_launch(const __nv_bfloat16* img, __nv_bfloat16* out,
                                  const __nv_bfloat16* carry_in, __nv_bfloat16* carry_out,
                                  const float* alpha, const float* yf, const float* xf,
                                  const LaunchShape* s, void* stream) {
  const Args<__nv_bfloat16> a =
      make_args<__nv_bfloat16>(img, out, yf, xf, carry_in, carry_out, alpha, *s);
  return launch<true>(a, s->b, s->smem_bytes, s->device, stream);
}

}  // extern "C"
