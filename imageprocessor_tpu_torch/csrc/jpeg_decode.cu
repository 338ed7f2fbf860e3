// Kernel B1: fused JPEG coefficient decode, int16 coefficient canvases ->
// planar u8 RGB, for sm_90a.
//
// Replaces: imageprocessor_tpu/ops/pallas_jpeg.py `_kernel` (built by
// `_build_call`, entry `decode_420`), reached from
// runtime/engine.py `_decode_coefs_pallas`. Same arithmetic as
// ops/jpeg_decode.py `batched_decode_ycbcr` (the plain version beside it is
// imageprocessor_tpu_torch/ops/jpeg_decode.py `decode_ycbcr`): dequantize
// with the image's own tables, clamp +-4096, separable 8-point IDCT, +128,
// for subsampled chroma clamp to [0, 255] and libjpeg's fancy 2x upsample
// with taps clamped to the image's valid chroma extent, BT.601 -> RGB,
// round half to even, clip. Modes 4:2:0, 4:2:2, 4:4:0, 4:4:4.
//
// What bounds it: device memory. Per 8 x 12 MP (3072 x 4096) 4:2:0 batch
// the minimum traffic is 201 MB of luma coefficients + 101 MB of chroma
// coefficients read and 302 MB of RGB written (~604 MB, ~0.18 ms at
// 3.35 TB/s); the IDCT is 16 FMAs per sample, far below the FP32 rate.
//
// Design: one fused pass, nothing but u8 pixels is written. A 256-thread
// block owns a 32 x 128 luma tile. It loads the tile's luma coefficients
// and the chroma blocks it needs (plus a one-block halo on each
// upsampled axis for the fancy-upsample taps) into shared memory as
// dequantized floats, runs both IDCT passes in place there with the basis
// in __constant__ memory, and writes each output row coalesced. Halo
// chroma blocks are transformed by both neighbouring tiles (4:2:0: 2x the
// chroma IDCT work) — cheap next to the bytes saved by fusing. The colour
// and upsample arithmetic uses explicit round-to-nearest intrinsics so no
// FMA contraction moves a result against the plain version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TY = 32;    // luma rows per block
constexpr int TX = 128;   // luma cols per block
constexpr int NT = 256;   // threads per block
constexpr float kClamp = 4096.0f;

// D[k][n] = c_k cos((2n+1) k pi / 16), c_0 = sqrt(1/8), c_k = 1/2: the
// float32 values of ops/jpeg_decode.idct_basis() (a CPU test checks them).
__constant__ float kIdct[64] = {
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

// Chroma window (rows x cols of chroma samples) a tile needs: its own
// TY/FH x TX/FW samples plus 8 on each side of an upsampled axis.
template <int FH, int FW>
struct Geo {
  static constexpr bool kUp = FH == 2 || FW == 2;
  static constexpr int kCR = TY / FH + (FH == 2 ? 16 : 0);
  static constexpr int kCC = TX / FW + (FW == 2 ? 16 : 0);
  static constexpr size_t kSmem = sizeof(float) * (TY * TX + 2 * kCR * kCC);
};

// Vertical 8-point IDCT of every 8-row column segment, in place.
__device__ void idct_cols(float* p, int rows, int cols) {
  const int n = (rows / 8) * cols;
  for (int s = threadIdx.x; s < n; s += NT) {
    float* base = p + (s / cols) * 8 * cols + (s % cols);
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = base[k * cols];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = fmaf(kIdct[k * 8 + i], x[k], acc);
      base[i * cols] = acc;
    }
  }
}

// Horizontal 8-point IDCT of every 8-col row segment, in place, then the
// +128 level shift and (chroma of an upsampled mode) the [0, 255] clamp.
__device__ void idct_rows(float* p, int rows, int cols, bool clamp) {
  const int nbc = cols / 8;
  const int n = rows * nbc;
  for (int s = threadIdx.x; s < n; s += NT) {
    float* base = p + (s / nbc) * cols + (s % nbc) * 8;
    float x[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) x[l] = base[l];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int l = 0; l < 8; ++l) acc = fmaf(x[l], kIdct[l * 8 + j], acc);
      acc = __fadd_rn(acc, 128.0f);
      base[j] = clamp ? fminf(fmaxf(acc, 0.0f), 255.0f) : acc;
    }
  }
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// (3 * near + far) / 4, rounded step by step like the plain version.
__device__ __forceinline__ float tri(float near_v, float far_v) {
  return __fmul_rn(__fadd_rn(__fmul_rn(3.0f, near_v), far_v), 0.25f);
}

// Upsampled chroma at luma (y, x) from the tile's chroma window `s`
// (window origin (cy0, cx0)); (cvh, cvw) is the image's valid chroma
// extent. Window-relative indices are clamped into the window: only
// pixels outside the image's valid region can reach that clamp.
template <int FH, int FW>
__device__ float chroma_at(const float* s, int y, int x, int cy0, int cx0,
                           int cvh, int cvw) {
  using G = Geo<FH, FW>;
  if constexpr (!G::kUp) return s[(y - cy0) * G::kCC + (x - cx0)];
  int i = FH == 2 ? y >> 1 : y;
  int io = FH == 2 ? ((y & 1) ? i + 1 : i - 1) : i;
  int j = FW == 2 ? x >> 1 : x;
  int jo = FW == 2 ? ((x & 1) ? j + 1 : j - 1) : j;
  i = clampi(clampi(i, 0, cvh - 1) - cy0, 0, G::kCR - 1);
  io = clampi(clampi(io, 0, cvh - 1) - cy0, 0, G::kCR - 1);
  j = clampi(clampi(j, 0, cvw - 1) - cx0, 0, G::kCC - 1);
  jo = clampi(clampi(jo, 0, cvw - 1) - cx0, 0, G::kCC - 1);
  const float* r0 = s + i * G::kCC;
  const float* r1 = s + io * G::kCC;
  if constexpr (FH == 2 && FW == 2) {
    return tri(tri(r0[j], r1[j]), tri(r0[jo], r1[jo]));
  } else if constexpr (FH == 2) {
    return tri(r0[j], r1[j]);
  } else {
    return tri(r0[j], r0[jo]);
  }
}

__device__ __forceinline__ uint8_t to_u8(float v) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

template <int FH, int FW>
__global__ void __launch_bounds__(NT)
decode_kernel(const int16_t* __restrict__ yc, const int16_t* __restrict__ cbc,
              const int16_t* __restrict__ crc, const float* __restrict__ qt,
              const int* __restrict__ cv, uint8_t* __restrict__ out, int ch,
              int cw, int out_h, int out_w) {
  using G = Geo<FH, FW>;
  extern __shared__ float smem[];
  float* ys = smem;
  float* cbs = ys + TY * TX;
  float* crs = cbs + G::kCR * G::kCC;
  __shared__ float q[3 * 64];

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TY;
  const int tx0 = blockIdx.x * TX;
  const int chc = ch / FH;
  const int cwc = cw / FW;
  const int cy0 = ty0 / FH - (FH == 2 ? 8 : 0);
  const int cx0 = tx0 / FW - (FW == 2 ? 8 : 0);
  const int cvh = clampi(cv[2 * b], 1, chc);
  const int cvw = clampi(cv[2 * b + 1], 1, cwc);

  for (int i = threadIdx.x; i < 3 * 64; i += NT) q[i] = qt[b * 192 + i];
  __syncthreads();

  // Load + dequantize + clamp. Tile and window origins are multiples of
  // 8, so (r & 7, c & 7) is the coefficient's (u, v) within its block.
  const int16_t* yb = yc + static_cast<size_t>(b) * ch * cw;
  for (int i = threadIdx.x; i < TY * TX; i += NT) {
    const int r = i / TX, c = i % TX;
    const int gy = ty0 + r, gx = tx0 + c;
    float v = 0.0f;
    if (gy < ch && gx < cw) {
      v = __fmul_rn(static_cast<float>(yb[static_cast<size_t>(gy) * cw + gx]),
                    q[(r & 7) * 8 + (c & 7)]);
      v = fminf(fmaxf(v, -kClamp), kClamp);
    }
    ys[i] = v;
  }
  const size_t coff = static_cast<size_t>(b) * chc * cwc;
  for (int i = threadIdx.x; i < G::kCR * G::kCC; i += NT) {
    const int r = i / G::kCC, c = i % G::kCC;
    const int gy = cy0 + r, gx = cx0 + c;
    float vb = 0.0f, vr = 0.0f;
    if (gy >= 0 && gy < chc && gx >= 0 && gx < cwc) {
      const size_t o = coff + static_cast<size_t>(gy) * cwc + gx;
      const int u = (r & 7) * 8 + (c & 7);
      vb = __fmul_rn(static_cast<float>(cbc[o]), q[64 + u]);
      vr = __fmul_rn(static_cast<float>(crc[o]), q[128 + u]);
      vb = fminf(fmaxf(vb, -kClamp), kClamp);
      vr = fminf(fmaxf(vr, -kClamp), kClamp);
    }
    cbs[i] = vb;
    crs[i] = vr;
  }
  __syncthreads();

  idct_cols(ys, TY, TX);
  idct_cols(cbs, G::kCR, G::kCC);
  idct_cols(crs, G::kCR, G::kCC);
  __syncthreads();
  idct_rows(ys, TY, TX, false);
  idct_rows(cbs, G::kCR, G::kCC, G::kUp);
  idct_rows(crs, G::kCR, G::kCC, G::kUp);
  __syncthreads();

  const size_t plane = static_cast<size_t>(out_h) * out_w;
  uint8_t* ob = out + static_cast<size_t>(b) * 3 * plane;
  for (int i = threadIdx.x; i < TY * TX; i += NT) {
    const int y = ty0 + i / TX, x = tx0 + i % TX;
    if (y >= out_h || x >= out_w) continue;
    const float lum = ys[i];
    const float cb = __fsub_rn(chroma_at<FH, FW>(cbs, y, x, cy0, cx0, cvh, cvw), 128.0f);
    const float cr = __fsub_rn(chroma_at<FH, FW>(crs, y, x, cy0, cx0, cvh, cvw), 128.0f);
    const float rr = __fadd_rn(lum, __fmul_rn(1.402f, cr));
    const float gg = __fsub_rn(__fsub_rn(lum, __fmul_rn(0.344136f, cb)),
                               __fmul_rn(0.714136f, cr));
    const float bb = __fadd_rn(lum, __fmul_rn(1.772f, cb));
    const size_t o = static_cast<size_t>(y) * out_w + x;
    ob[o] = to_u8(rr);
    ob[plane + o] = to_u8(gg);
    ob[2 * plane + o] = to_u8(bb);
  }
}

template <int FH, int FW>
cudaError_t launch(const void* yc, const void* cbc, const void* crc,
                   const void* qt, const void* cv, void* out, int batch,
                   int ch, int cw, int out_h, int out_w, cudaStream_t stream) {
  using G = Geo<FH, FW>;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<FH, FW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((out_w + TX - 1) / TX, (out_h + TY - 1) / TY, batch);
  decode_kernel<FH, FW><<<grid, NT, G::kSmem, stream>>>(
      static_cast<const int16_t*>(yc), static_cast<const int16_t*>(cbc),
      static_cast<const int16_t*>(crc), static_cast<const float*>(qt),
      static_cast<const int*>(cv), static_cast<uint8_t*>(out), ch, cw, out_h,
      out_w);
  return cudaGetLastError();
}

}  // namespace

// yc (B, ch, cw) i16; cbc/crc (B, ch/fh, cw/fw) i16; qt (B, 3, 8, 8) f32;
// cv (B, 2) i32; out (B, 3, out_h, out_w) u8 with out_h <= ch, out_w <= cw.
extern "C" int ip_decode_coefs(const void* yc, const void* cbc,
                               const void* crc, const void* qt, const void* cv,
                               void* out, int batch, int ch, int cw, int fh,
                               int fw, int out_h, int out_w, void* stream) {
  if (batch <= 0 || out_h <= 0 || out_w <= 0 || out_h > ch || out_w > cw ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fh * 10 + fw) {
    case 22: err = launch<2, 2>(yc, cbc, crc, qt, cv, out, batch, ch, cw, out_h, out_w, s); break;
    case 12: err = launch<1, 2>(yc, cbc, crc, qt, cv, out, batch, ch, cw, out_h, out_w, s); break;
    case 21: err = launch<2, 1>(yc, cbc, crc, qt, cv, out, batch, ch, cw, out_h, out_w, s); break;
    case 11: err = launch<1, 1>(yc, cbc, crc, qt, cv, out, batch, ch, cw, out_h, out_w, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
