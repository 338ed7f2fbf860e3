// Go-bilinear output pixel shared by kernels B2 (fused_resample.cu) and B4
// (planar_resample.cu).
//
// Per output pixel, taps (i0, i1, fy) per row and (j0, j1, fx) per column
// come from the host (Go half-pixel coordinates with clamped taps, a crop
// window folded into the offsets). Vertical lerp (1-fy)*S[i0] + fy*S[i1]
// first, then the horizontal lerp, in fp32, then Go xdraw's
// floor(v * 257/256) clipped to [0, 255]. Explicit round-to-nearest
// intrinsics keep the arithmetic identical to the plain PyTorch version
// (ops/fused_resample.py `resample_plain`): no FMA contraction.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ipk {

struct Output {
  const int* r0;     // (B, h) source row taps
  const int* r1;
  const float* fy;   // (B, h) vertical lerp weight
  const int* c0;     // (B, w) source column taps
  const int* c1;
  const float* fx;   // (B, w)
  uint8_t* dst;      // (B, 3, h, w)
  int h;
  int w;
};

// Writes all three channels of output pixel p (= y * o.w + x) of image
// `img`; src is (B, 3, sh, sw) u8.
__device__ __forceinline__ void resample_pixel(const uint8_t* __restrict__ src,
                                               int sh, int sw, const Output& o,
                                               int img, long long p) {
  const int y = static_cast<int>(p / o.w);
  const int x = static_cast<int>(p % o.w);
  const int i0 = o.r0[img * o.h + y], i1 = o.r1[img * o.h + y];
  const int j0 = o.c0[img * o.w + x], j1 = o.c1[img * o.w + x];
  const float fy = o.fy[img * o.h + y], fx = o.fx[img * o.w + x];
  const float wy = __fsub_rn(1.0f, fy), wx = __fsub_rn(1.0f, fx);

  const size_t splane = static_cast<size_t>(sh) * sw;
  const size_t oplane = static_cast<size_t>(o.h) * o.w;
  const uint8_t* s = src + static_cast<size_t>(img) * 3 * splane;
  uint8_t* d = o.dst + static_cast<size_t>(img) * 3 * oplane + p;
  const size_t row0 = static_cast<size_t>(i0) * sw;
  const size_t row1 = static_cast<size_t>(i1) * sw;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint8_t* sp = s + c * splane;
    const float v0 = __fadd_rn(__fmul_rn(wy, static_cast<float>(sp[row0 + j0])),
                               __fmul_rn(fy, static_cast<float>(sp[row1 + j0])));
    const float v1 = __fadd_rn(__fmul_rn(wy, static_cast<float>(sp[row0 + j1])),
                               __fmul_rn(fy, static_cast<float>(sp[row1 + j1])));
    const float v = __fadd_rn(__fmul_rn(wx, v0), __fmul_rn(fx, v1));
    const float qv = floorf(__fmul_rn(v, 1.00390625f));  // 257 / 256, exact
    d[c * oplane] = static_cast<uint8_t>(fminf(fmaxf(qv, 0.0f), 255.0f));
  }
}

inline Output make_output(const void* r0, const void* r1, const void* fy,
                          const void* c0, const void* c1, const void* fx,
                          void* dst, int h, int w) {
  return Output{static_cast<const int*>(r0), static_cast<const int*>(r1),
                static_cast<const float*>(fy), static_cast<const int*>(c0),
                static_cast<const int*>(c1), static_cast<const float*>(fx),
                static_cast<uint8_t*>(dst), h, w};
}

}  // namespace ipk
