// Device arithmetic shared by the bilateral-grid kernels: the GC z bin and
// cell sums, the GF taps, the eq. (4) normalization and the TI lerp.
//
// B1/B2 (bg_fused.cu), B3 (bg_fused_streamed.cu), B4 (bg_create.cu), B5
// (bg_blur.cu) and B6 (bg_slice.cu) all call these functions, so a grid cell,
// a blurred value or a sliced pixel is the same expression in every kernel:
// the streamed kernel equals the fused one bit for bit because both compile
// the same instructions here, whatever they read their operands from.
//
// Arithmetic that decides bins matches the reference exactly:
//   z bin        floor(px / rs + 0.5), quotient and sum each rounded once
//   row/col cell round-half-up(i / r) in integers (common.py gc_row_split)
//   TI corners   y0 = j / r, y1 = min(y0 + 1, gy - 1); yf, xf from the host
//   TI lerps     y, then x, then z, each a(1-t) + bt rounded op by op
//   normalize    count > 1e-12 ? sum / max(count, 1e-12) : 0
//   blend        (1-a)*B + a*C, each product and the sum rounded on its own
// GF applies the x taps, then z, then y, each (t0*lo + t1*mid) + t2*hi with
// every product and sum rounded on its own (no FMA contraction) and zeros
// outside the grid: the reference order, and the plain version's rounding.
//
// Storage type. The fused kernels hold frames, the carry and the grid they
// store in T, float (fp32) or __nv_bfloat16 (bf16), and compute in fp32
// either way: ld/ldg upcast, st and round_to round to nearest even
// (__float2bfloat16_rn, what torch's .to(torch.bfloat16) does). For float
// every one of them is the identity, so a float instantiation compiles the
// fp32 kernel's instructions. The rounding points of the bf16 form are in
// the module docstring of kernels/bg_fused.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace bg {

template <class T>
constexpr bool kIsFloat = std::is_same_v<T, float>;

// a T value as fp32 (shared or global memory)
template <class T>
__device__ __forceinline__ float ld(const T* p) {
  if constexpr (kIsFloat<T>) {
    return *p;
  } else {
    return __bfloat162float(*p);
  }
}

// the same through the read-only cache (global memory)
template <class T>
__device__ __forceinline__ float ldg(const T* p) {
  if constexpr (kIsFloat<T>) {
    return __ldg(p);
  } else {
    return __bfloat162float(
        __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
  }
}

// v stored as T, rounded to nearest even
template <class T>
__device__ __forceinline__ void st(T* p, float v) {
  if constexpr (kIsFloat<T>) {
    *p = v;
  } else {
    *p = __float2bfloat16_rn(v);
  }
}

// v rounded to T and back: the value a T store would keep
template <class T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (kIsFloat<T>) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// z bin of a pixel by the reference's rule, floor(px / rs + 0.5) with the
// quotient and the sum each rounded once: a product with fp32(1/rs) differs
// from the quotient by an ulp, enough to move an input a few ulps below a
// bin edge into the next bin. The quotient is Markstein's: with rcp_rs the
// correctly rounded 1/rs, q = px * rcp_rs is within an ulp of px / rs, the
// residual px - q * rs is exact in one FMA, and q + residual * rcp_rs
// rounds to the correctly rounded quotient, what __fdiv_rn gives, without
// the division routine's slow-path call (which slowed B3 by about 70 % by
// call on an H100)
__device__ __forceinline__ int gc_bin(float px, float rs, float rcp_rs) {
  const float q = __fmul_rn(px, rcp_rs);
  const float res = __fmaf_rn(-q, rs, px);
  return static_cast<int>(floorf(__fadd_rn(__fmaf_rn(res, rcp_rs, q), 0.5f)));
}

// GC of one grid cell: adds the pixels of `n_rows` rows (`stride` floats
// apart, columns [j_lo, j_hi)) into the gz bins cnt[z * bin_stride] and
// sum[z * bin_stride], rows ascending and columns ascending within a row.
// kGlobal reads through the read-only cache; otherwise `rows` is shared.
template <bool kGlobal>
__device__ __forceinline__ void gc_cell(const float* rows, int stride, int n_rows,
                                        int j_lo, int j_hi, float rs, float rcp_rs, int gz,
                                        float* cnt, float* sum, int bin_stride) {
  for (int i = 0; i < n_rows; ++i) {
    const float* row = rows + static_cast<size_t>(i) * stride;
    for (int j = j_lo; j < j_hi; ++j) {
      const float px = kGlobal ? __ldg(row + j) : row[j];
      const int z = gc_bin(px, rs, rcp_rs);
      if (z >= 0 && z < gz) {
        cnt[z * bin_stride] += 1.f;
        sum[z * bin_stride] += px;
      }
    }
  }
}

// One GF tap, (t0*lo + t1*mid) + t2*hi rounded op by op: left to the
// compiler, the expression contracts into FMAs in an order that depends on
// its context, so two kernels that inline it could disagree in the last bit
__device__ __forceinline__ float tap3(float lo, float mid, float hi, float t0,
                                      float t1, float t2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(t0, lo), __fmul_rn(t1, mid)), __fmul_rn(t2, hi));
}

// x taps over the three raw planes of one channel at flat (z, y) index idx,
// each raw value rounded to the storage type T first (a raw plane is
// summed in fp32 and stored as T once complete)
template <class T = float>
__device__ __forceinline__ float xmix(const float* rm, const float* rc,
                                      const float* rp, int idx, float t0,
                                      float t1, float t2) {
  return tap3(round_to<T>(rm[idx]), round_to<T>(rc[idx]), round_to<T>(rp[idx]), t0, t1, t2);
}

// z, then y taps at (z, y) over x-mixed values xm(z', y'), zeros outside
template <class XMix>
__device__ __forceinline__ float blur_zy(const XMix& xm, int z, int y, int gz,
                                         int gy, float t0, float t1, float t2) {
  float zc[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int yy = y + d - 1;
    float v = 0.f;
    if (yy >= 0 && yy < gy) {
      const float lo = z > 0 ? xm(z - 1, yy) : 0.f;
      const float mid = xm(z, yy);
      const float hi = z + 1 < gz ? xm(z + 1, yy) : 0.f;
      v = tap3(lo, mid, hi, t0, t1, t2);
    }
    zc[d] = v;
  }
  return tap3(zc[0], zc[1], zc[2], t0, t1, t2);
}

// (1-a)*b + a*c with no contraction, as the plain version rounds it
__device__ __forceinline__ float blend(float b, float c, float a, float one_minus_a) {
  return __fadd_rn(__fmul_rn(one_minus_a, b), __fmul_rn(a, c));
}

// eq. (4): blurred sum over blurred count, 0 where the count is empty
__device__ __forceinline__ float normalize(float c, float s) {
  return c > 1e-12f ? s / fmaxf(c, 1e-12f) : 0.f;
}

// a (1-t) + b t, each product and the sum rounded on its own (no FMA
// contraction), so that a lerp has the same bits in every kernel, and when a
// kernel hoists it out of a loop
__device__ __forceinline__ float lerp(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, t)), __fmul_rn(b, t));
}

// TI's z lerp: a w0 + b w1 with the weights w0 = 1-t and w1 = t each
// rounded to the storage type T, as the TPU kernel stores its z weights;
// for float it is lerp(a, b, t), the same operations
template <class T>
__device__ __forceinline__ float zlerp(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(a, round_to<T>(__fsub_rn(1.f, t))), __fmul_rn(b, round_to<T>(t)));
}

// TI of one pixel of intensity px from its y-lerped corners: pair(z) is
// (plane 0, plane 1) at bin z, each lerp(corner at column cell y0, corner
// at y1, wy) of normalized plane p (0: the stripe's floor plane, 1: the
// next). Then x, then z (bg::zlerp, its weights rounded to T).
template <class T = float, class Pair>
__device__ __forceinline__ float ti_pixel_pairs(const Pair& pair, float px, float inv_rs, int gz,
                                                float wx) {
  const float fz = __fmul_rn(px, inv_rs);
  const float zfl = floorf(fz);
  const int z0 = static_cast<int>(zfl);
  const float zf = __fsub_rn(fz, zfl);
  float q[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int z = z0 + d;
    if (z < 0 || z >= gz) {
      q[d] = 0.f;
    } else {
      const float2 v = pair(z);
      q[d] = lerp(v.x, v.y, wx);
    }
  }
  return zlerp<T>(q[0], q[1], zf);
}

// The same from ylerp(p, z), the value of plane p at bin z
template <class T = float, class YLerp>
__device__ __forceinline__ float ti_pixel_y(const YLerp& ylerp, float px, float inv_rs,
                                            int gz, float wx) {
  return ti_pixel_pairs<T>([&](int z) { return make_float2(ylerp(0, z), ylerp(1, z)); }, px,
                           inv_rs, gz, wx);
}

// y lerp of the corners read through planes(p, z, y)
template <class Planes>
struct YLerp {
  const Planes& planes;
  int y0, y1;
  float wy;
  __device__ __forceinline__ float operator()(int p, int z) const {
    return lerp(planes(p, z, y0), planes(p, z, y1), wy);
  }
};

// two normalized planes held as [z][y] in shared memory
struct SmemPlanes {
  const float *n0, *n1;
  int gy;
  __device__ __forceinline__ float operator()(int p, int z, int y) const {
    return (p ? n1 : n0)[z * gy + y];
  }
};

}  // namespace bg
