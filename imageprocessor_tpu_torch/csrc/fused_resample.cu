// Kernel B2: fused two-output Go-bilinear resample of a planar u8 bucket,
// for sm_90a. One launch writes both outputs (the keep-aspect resize and
// the thumbnail) from one pass over the source.
//
// Replaces: imageprocessor_tpu/ops/pallas_fused.py `_kernel` (built by
// `_build_call`, entry `fused_resample`), called from
// models/pipeline.py `step_chw`. The plain version beside it is
// imageprocessor_tpu_torch/ops/fused_resample.py `resample_plain`.
// Semantics (csrc/bilinear.cuh): Go half-pixel bilinear taps from the
// host, the thumbnail's centre crop folded into the offsets, per-image
// dims (content never recompiles anything); vertical lerp, then
// horizontal, in fp32, then Go xdraw's floor(v * 257/256).
//
// What bounds it: device memory, and only the source rows and columns the
// taps touch, in the 32-byte sectors the memory moves. Per 8 x 12 MP
// batch the outputs are 8 x 3 x (768 x 1024 + 200 x 200) = 19.8 MB. The
// resize reads ~2 source rows per output row, and its tap pairs fall
// every ~3.9 pixels, so every sector of a touched row is needed (~18 MB
// per 3000 x 4000 image); the thumbnail adds the rows of its crop window
// that the resize does not touch (~2 MB). chip_smoke.py counts the
// sectors of its timing batch (six 12 MP images, a 1920 x 1080 and a
// 640 x 480 one): 141.0 MB with outputs and tap tables, 0.042 ms at
// 3.35 TB/s, against 80.6 MB if only the touched bytes counted and
// 302 MB for one full read of the source.
//
// Design: one thread per output pixel computes all three channels from
// the same taps (csrc/bilinear.cuh, shared with kernel B4); consecutive
// threads own consecutive output columns, so stores are coalesced and the
// four source reads of a warp fall in a few sectors of two source rows
// (served from L1/L2). Any scale works — the TPU kernel's band geometry,
// garbage zones and one-hot matmuls have no counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

#include "bilinear.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
fused_kernel(const uint8_t* __restrict__ src, int sh, int sw, ipk::Output a,
             ipk::Output b) {
  const int img = blockIdx.y;
  long long p = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const long long na = static_cast<long long>(a.h) * a.w;
  const long long nb = static_cast<long long>(b.h) * b.w;
  if (p >= na + nb) return;
  if (p < na) {
    ipk::resample_pixel(src, sh, sw, a, img, p);
  } else {
    ipk::resample_pixel(src, sh, sw, b, img, p - na);
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
  const ipk::Output a =
      ipk::make_output(a_r0, a_r1, a_fy, a_c0, a_c1, a_fx, a_dst, a_h, a_w);
  const ipk::Output b =
      ipk::make_output(b_r0, b_r1, b_fy, b_c0, b_c1, b_fx, b_dst, b_h, b_w);
  const long long total = static_cast<long long>(a_h) * a_w +
                          static_cast<long long>(b_h) * b_w;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((total + NT - 1) / NT), batch);
  fused_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), src_h, src_w, a, b);
  return static_cast<int>(cudaGetLastError());
}
