// Kernel B3: JPEG encode front half, planar u8 RGB -> int16 4:2:0
// quantized coefficient canvases, for sm_90a.
//
// Replaces: imageprocessor_tpu/ops/pallas_jpeg.py `_encode_kernel` (built
// by `_build_encode_call`, entry `encode_420`), reached from
// runtime/engine.py `_encode_coefs_pallas`. Same arithmetic as
// ops/jpeg_encode.py `batched_encode_420` with the exact float32 basis
// (the plain version beside it is imageprocessor_tpu_torch/ops/
// jpeg_encode.py `encode_420_plain`): replicate each image's last valid
// row and column past its valid (h, w), BT.601 RGB -> YCbCr, 2x2 box-mean
// chroma, orthonormal 8x8 FDCT of (x - 128), divide by the quality table,
// round half to even (rintf), clamp to +-1023. The host entropy emitter
// (native/jpeg_emit.cpp) consumes the canvases.
//
// What bounds it: device memory. Per 8 x 12 MP (3072 x 4096) batch it
// reads 302 MB of u8 RGB and writes 201 MB of luma and 101 MB of chroma
// coefficients (302 MB of int16): ~604 MB, ~0.18 ms at 3.35 TB/s. The
// FDCT is 16 FMAs per sample and pass, far below the FP32 rate.
//
// Design: one fused pass; only the int16 coefficients are written. A
// 256-thread block owns a 16 x 128 pixel strip (8 MCUs): it reads the
// strip's RGB with row and column indices clamped to the image's valid
// extent (the edge replication), converts to Y/Cb/Cr in shared memory,
// box-means the chroma, runs the vertical and then the horizontal 8-point
// FDCT of all its luma and chroma blocks in shared memory with the basis
// in __constant__ memory, and each thread quantizes and stores 8
// consecutive coefficients of a block row (consecutive threads write
// consecutive 16-byte runs). Strips wholly past ceil16 of the valid
// extent are never emitted and return at once. The colour, mean and
// quantize arithmetic uses explicit round-to-nearest intrinsics in the
// plain version's order, so only the FDCT's summation order differs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TY = 16;    // pixel rows per block (one MCU row)
constexpr int TX = 128;   // pixel cols per block (8 MCUs)
constexpr int NT = 256;   // threads per block
constexpr float kClamp = 1023.0f;

// D[k][n] = c_k cos((2n+1) k pi / 16), c_0 = sqrt(1/8), c_k = 1/2: the
// float32 values of ops/jpeg_decode.idct_basis() (a CPU test checks them).
__constant__ float kDct[64] = {
    3.535533845e-01f, 3.535533845e-01f, 3.535533845e-01f, 3.535533845e-01f,
    3.535533845e-01f, 3.535533845e-01f, 3.535533845e-01f, 3.535533845e-01f,
    4.903926253e-01f, 4.157347977e-01f, 2.777851224e-01f, 9.754516184e-02f,
    -9.754516184e-02f, -2.777851224e-01f, -4.157347977e-01f, -4.903926253e-01f,
    4.619397521e-01f, 1.913417131e-01f, -1.913417131e-01f, -4.619397521e-01f,
    -4.619397521e-01f, -1.913417131e-01f, 1.913417131e-01f, 4.619397521e-01f,
    4.157347977e-01f, -9.754516184e-02f, -4.903926253e-01f, -2.777851224e-01f,
    2.777851224e-01f, 4.903926253e-01f, 9.754516184e-02f, -4.157347977e-01f,
    3.535533845e-01f, -3.535533845e-01f, -3.535533845e-01f, 3.535533845e-01f,
    3.535533845e-01f, -3.535533845e-01f, -3.535533845e-01f, 3.535533845e-01f,
    2.777851224e-01f, -4.903926253e-01f, 9.754516184e-02f, 4.157347977e-01f,
    -4.157347977e-01f, -9.754516184e-02f, 4.903926253e-01f, -2.777851224e-01f,
    1.913417131e-01f, -4.619397521e-01f, 4.619397521e-01f, -1.913417131e-01f,
    -1.913417131e-01f, 4.619397521e-01f, -4.619397521e-01f, 1.913417131e-01f,
    9.754516184e-02f, -2.777851224e-01f, 4.157347977e-01f, -4.903926253e-01f,
    4.903926253e-01f, -4.157347977e-01f, 2.777851224e-01f, -9.754516184e-02f,
};

// One plane of a block's strip in shared memory and where it goes.
struct Plane {
  float* s;        // rows x cols samples, row-major
  int rows;
  int cols;
  const float* q;  // 8 x 8 quant table (shared memory)
  int16_t* out;    // the image's coefficient canvas at the strip's origin
  int stride;      // canvas row stride (elements)
  int valid_cols;  // columns of the strip inside the canvas
};

// Vertical FDCT of every 8-row column segment, in place, of (x - 128).
__device__ void fdct_cols(const Plane& p) {
  const int n = (p.rows / 8) * p.cols;
  for (int s = threadIdx.x; s < n; s += NT) {
    float* base = p.s + (s / p.cols) * 8 * p.cols + (s % p.cols);
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __fsub_rn(base[i * p.cols], 128.0f);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(kDct[k * 8 + i], x[i], acc);
      base[k * p.cols] = acc;
    }
  }
}

// Horizontal FDCT of every 8-col row segment, then quantize and store the
// 8 coefficients to the canvas.
__device__ void fdct_rows_store(const Plane& p) {
  const int nbc = p.cols / 8;
  const int n = p.rows * nbc;
  for (int s = threadIdx.x; s < n; s += NT) {
    const int r = s / nbc, c0 = (s % nbc) * 8;
    if (c0 >= p.valid_cols) continue;
    const float* base = p.s + r * p.cols + c0;
    const float* q = p.q + (r % 8) * 8;
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = base[j];
    int16_t o[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = fmaf(x[j], kDct[l * 8 + j], acc);
      const float v = rintf(__fdiv_rn(acc, q[l]));
      o[l] = static_cast<int16_t>(fminf(fmaxf(v, -kClamp), kClamp));
    }
    int16_t* dst = p.out + static_cast<size_t>(r) * p.stride + c0;
#pragma unroll
    for (int l = 0; l < 8; ++l) dst[l] = o[l];
  }
}

__global__ void __launch_bounds__(NT)
encode_kernel(const uint8_t* __restrict__ rgb, long long s_img,
              long long s_chan, long long s_row, const int* __restrict__ valid,
              const float* __restrict__ qt, int16_t* __restrict__ yc,
              int16_t* __restrict__ cbc, int16_t* __restrict__ crc, int h,
              int w) {
  __shared__ float ys[TY * TX];
  __shared__ float cbs[TY * TX];
  __shared__ float crs[TY * TX];
  __shared__ float cbd[TY / 2 * TX / 2];
  __shared__ float crd[TY / 2 * TX / 2];
  __shared__ float q[128];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int vh = min(max(valid[2 * b], 1), h);
  const int vw = min(max(valid[2 * b + 1], 1), w);
  // strips wholly past ceil16(valid) are never emitted
  if (y0 >= ((vh + 15) / 16) * 16 || x0 >= ((vw + 15) / 16) * 16) return;

  for (int i = threadIdx.x; i < 128; i += NT) q[i] = qt[i];
  const uint8_t* img = rgb + b * s_img;
  for (int i = threadIdx.x; i < TY * TX; i += NT) {
    const int r = i / TX, c = i % TX;
    const long long off = static_cast<long long>(min(y0 + r, vh - 1)) * s_row +
                          min(x0 + c, vw - 1);
    const float R = static_cast<float>(img[off]);
    const float G = static_cast<float>(img[s_chan + off]);
    const float B = static_cast<float>(img[2 * s_chan + off]);
    ys[i] = __fadd_rn(__fadd_rn(__fmul_rn(0.299f, R), __fmul_rn(0.587f, G)),
                      __fmul_rn(0.114f, B));
    cbs[i] = __fadd_rn(
        __fadd_rn(__fsub_rn(__fmul_rn(-0.168735892f, R), __fmul_rn(0.331264108f, G)),
                  __fmul_rn(0.5f, B)),
        128.0f);
    crs[i] = __fadd_rn(
        __fsub_rn(__fsub_rn(__fmul_rn(0.5f, R), __fmul_rn(0.418687589f, G)),
                  __fmul_rn(0.081312411f, B)),
        128.0f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TY / 2 * TX / 2; i += NT) {
    const int r = 2 * (i / (TX / 2)), c = 2 * (i % (TX / 2));
    const int a = r * TX + c;
    cbd[i] = __fmul_rn(__fadd_rn(__fadd_rn(cbs[a], cbs[a + 1]),
                                 __fadd_rn(cbs[a + TX], cbs[a + TX + 1])), 0.25f);
    crd[i] = __fmul_rn(__fadd_rn(__fadd_rn(crs[a], crs[a + 1]),
                                 __fadd_rn(crs[a + TX], crs[a + TX + 1])), 0.25f);
  }
  __syncthreads();

  const size_t yplane = static_cast<size_t>(h) * w;
  const size_t cplane = yplane / 4;
  const int valid_cols = min(TX, w - x0);
  const Plane planes[3] = {
      {ys, TY, TX, q, yc + b * yplane + static_cast<size_t>(y0) * w + x0, w,
       valid_cols},
      {cbd, TY / 2, TX / 2, q + 64,
       cbc + b * cplane + static_cast<size_t>(y0 / 2) * (w / 2) + x0 / 2, w / 2,
       valid_cols / 2},
      {crd, TY / 2, TX / 2, q + 64,
       crc + b * cplane + static_cast<size_t>(y0 / 2) * (w / 2) + x0 / 2, w / 2,
       valid_cols / 2},
  };
  for (const Plane& p : planes) fdct_cols(p);
  __syncthreads();
  for (const Plane& p : planes) fdct_rows_store(p);
}

}  // namespace

// rgb: (B, 3, h, w) u8 with element strides s_img, s_chan, s_row (columns
// contiguous); valid (B, 2) int32; qt (2, 8, 8) float32 luma then chroma;
// yc (B, h, w), cbc and crc (B, h/2, w/2) int16, contiguous. h and w must
// be multiples of 16.
extern "C" int ip_encode_420(const void* rgb, long long s_img, long long s_chan,
                             long long s_row, const void* valid, const void* qt,
                             void* yc, void* cbc, void* crc, int batch, int h,
                             int w, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || h % 16 || w % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + TX - 1) / TX, h / TY, batch);
  encode_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), s_img, s_chan, s_row,
      static_cast<const int*>(valid), static_cast<const float*>(qt),
      static_cast<int16_t*>(yc), static_cast<int16_t*>(cbc),
      static_cast<int16_t*>(crc), h, w);
  return static_cast<int>(cudaGetLastError());
}
