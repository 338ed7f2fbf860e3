// Kernel B4: one Go-bilinear resample of a planar u8 bucket, for sm_90a.
//
// Replaces: imageprocessor_tpu/ops/pallas_resample.py `_kernel` (built by
// `_build_call`, entry `planar_resample`; host arguments `make_args` and
// `_axis_coords`), called from models/pipeline.py `step_chw` for every
// resize or thumbnail op that is not the fused pair (kernel B2). The plain
// version beside it is imageprocessor_tpu_torch/ops/fused_resample.py
// `resample_plain` with one tap table. Semantics (csrc/bilinear.cuh): Go
// half-pixel taps from the host, the thumbnail's centre crop folded into
// the source offsets, per-image dims; vertical lerp, then horizontal, in
// fp32 with round-to-nearest intrinsics, then floor(v * 257/256) clipped
// to [0, 255]. Any scale, upscale included.
//
// What bounds it: device memory, and only the source rows and columns the
// taps touch, in the 32-byte sectors the memory moves. Per 8 x 12 MP
// batch resized to 1024 x 768 the output is 8 x 3 x 768 x 1024 = 18.9 MB
// and the reads ~2 source rows per output row, every sector of each (the
// tap pairs fall every ~3.9 pixels). chip_smoke.py counts the sectors of
// its timing batch: 129.0 MB with the output and tap tables, 0.039 ms at
// 3.35 TB/s, against 77.5 MB if only the touched bytes counted and
// 302 MB for a full read of the source.
//
// Design: one thread per output pixel computes its three channels from one
// set of taps; consecutive threads own consecutive output columns, so
// stores coalesce and a warp's source reads fall in a few sectors of two
// source rows (served from L1/L2). The TPU kernel's row bands, DMA
// windows, 128-column chunks and one-hot matmuls have no counterpart:
// taps are gathered directly.

#include <cstdint>
#include <cuda_runtime.h>

#include "bilinear.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
planar_kernel(const uint8_t* __restrict__ src, int sh, int sw, ipk::Output o) {
  const long long p = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (p >= static_cast<long long>(o.h) * o.w) return;
  ipk::resample_pixel(src, sh, sw, o, blockIdx.y, p);
}

}  // namespace

// src (B, 3, src_h, src_w) u8; taps r0/r1/fy (B, h) and c0/c1/fx (B, w);
// dst (B, 3, h, w) u8.
extern "C" int ip_planar_resample(const void* src, int batch, int src_h,
                                  int src_w, const void* r0, const void* r1,
                                  const void* fy, const void* c0,
                                  const void* c1, const void* fx, void* dst,
                                  int h, int w, int device,
                                  void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ipk::Output o = ipk::make_output(r0, r1, fy, c0, c1, fx, dst, h, w);
  // this library links its own static CUDA runtime: make the operands'
  // card current in it too (a no-op when it already is)
  const cudaError_t on = cudaSetDevice(device);
  if (on != cudaSuccess) return static_cast<int>(on);
  const long long total = static_cast<long long>(h) * w;
  const dim3 grid(static_cast<unsigned>((total + NT - 1) / NT), batch);
  planar_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), src_h, src_w, o);
  return static_cast<int>(cudaGetLastError());
}
