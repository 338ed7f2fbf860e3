// Kernel B2: fused two-output Go-bilinear resample of a planar u8 bucket,
// for sm_90a. One launch writes both outputs (the keep-aspect resize and
// the thumbnail) from one pass over the source.
//
// Replaces: imageprocessor_tpu/ops/pallas_fused.py `_kernel` (built by
// `_build_call`, entry `fused_resample`), called from
// models/pipeline.py `step_chw`. The plain version beside it is
// imageprocessor_tpu_torch/ops/fused_resample.py `resample_plain`.
// Semantics: per output pixel, taps (i0, i1, fy) per row and (j0, j1, fx)
// per column come from the host (Go half-pixel coordinates with clamped
// taps, the thumbnail's centre crop folded into the offsets; per-image
// dims, so content never recompiles anything). Vertical lerp
// (1-fy)*S[i0] + fy*S[i1] first, then the horizontal lerp, in fp32, then
// Go xdraw's floor(v * 257/256) clipped to [0, 255].
//
// What bounds it: device memory, and only the source rows and columns the
// taps touch. Per 8 x 12 MP batch the outputs are 8 x 3 x (768 x 1024 +
// 200 x 200) = 19.8 MB; the reads are ~2 sampled source rows per output
// row, each read at 32-byte sector granularity: ~19 MB per image for the
// resize and ~4 MB for the thumbnail (~180 MB per batch, ~0.06 ms at
// 3.35 TB/s), against 302 MB for one full read of the source.
//
// Design: one thread per output pixel computes all three channels from
// the same taps; consecutive threads own consecutive output columns, so
// stores are coalesced and the four source reads of a warp fall in a few
// sectors of two source rows (served from L1/L2). Any scale works — the
// TPU kernel's band geometry, garbage zones and one-hot matmuls have no
// counterpart here. Explicit round-to-nearest intrinsics keep the
// arithmetic identical to the plain PyTorch version (no FMA contraction).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

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

__global__ void __launch_bounds__(NT)
fused_kernel(const uint8_t* __restrict__ src, int sh, int sw, Output a,
             Output b) {
  const int img = blockIdx.y;
  long long p = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const long long na = static_cast<long long>(a.h) * a.w;
  const long long nb = static_cast<long long>(b.h) * b.w;
  if (p >= na + nb) return;
  const Output& o = p < na ? a : b;
  if (p >= na) p -= na;
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

}  // namespace

// src (B, 3, src_h, src_w) u8. Each output: taps r0/r1/fy (B, h) and
// c0/c1/fx (B, w), dst (B, 3, h, w) u8; h = w = 0 leaves it absent.
extern "C" int ip_fused_resample(
    const void* src, int batch, int src_h, int src_w,
    const void* a_r0, const void* a_r1, const void* a_fy, const void* a_c0,
    const void* a_c1, const void* a_fx, void* a_dst, int a_h, int a_w,
    const void* b_r0, const void* b_r1, const void* b_fy, const void* b_c0,
    const void* b_c1, const void* b_fx, void* b_dst, int b_h, int b_w,
    void* stream) {
  if (batch <= 0 || batch > 65535 || a_h < 0 || a_w < 0 || b_h < 0 || b_w < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Output a{static_cast<const int*>(a_r0), static_cast<const int*>(a_r1),
                 static_cast<const float*>(a_fy), static_cast<const int*>(a_c0),
                 static_cast<const int*>(a_c1), static_cast<const float*>(a_fx),
                 static_cast<uint8_t*>(a_dst), a_h, a_w};
  const Output b{static_cast<const int*>(b_r0), static_cast<const int*>(b_r1),
                 static_cast<const float*>(b_fy), static_cast<const int*>(b_c0),
                 static_cast<const int*>(b_c1), static_cast<const float*>(b_fx),
                 static_cast<uint8_t*>(b_dst), b_h, b_w};
  const long long total = static_cast<long long>(a_h) * a_w +
                          static_cast<long long>(b_h) * b_w;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((total + NT - 1) / NT), batch);
  fused_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), src_h, src_w, a, b);
  return static_cast<int>(cudaGetLastError());
}
