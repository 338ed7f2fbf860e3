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
// round half to even, clamp to +-1023. The host entropy emitter
// (native/jpeg_emit.cpp) consumes the canvases.
//
// What bounds it: device memory. Counted over the full bucket, an
// 8 x 12 MP (3072 x 4096) batch reads 302 MB of u8 RGB and writes 201 MB
// of luma and 101 MB of chroma coefficients (302 MB of int16): 604 MB,
// 0.180 ms at 3.35 TB/s. chip_smoke.py's b3_bound counts what a batch's
// valid extents need instead (each valid pixel read once, each
// coefficient of the ceil16(valid) grids written once): 430.2 MB,
// 0.1284 ms for the batch it times. The arithmetic is about 70 FP32
// operations per pixel (5.0 GFLOP, 0.075 ms at 67 TFLOP/s for that
// batch); the conversions, divisions, packing and shared-memory accesses
// around it take instruction slots too, so the transforms stay lean.
//
// Design. A block owns a 64 x 256 pixel tile (8 warps, 64 MCUs); thread t
// owns luma block (t / 32, t % 32), so a warp is one row of 32 adjacent
// 8x8 blocks. The geometry is compile-time: no runtime divide anywhere.
//  1. Loads: the thread's 8 pixels of a row and channel arrive in one
//     8-byte load (a warp reads 256 contiguous bytes per instruction), 24
//     loads per thread, all started before the arithmetic that needs them.
//     The row clamp min(y, vh - 1) redirects the whole row's load. The
//     column clamp is applied to the loaded bytes: inside an emitted MCU
//     an 8-pixel run is wholly valid, or holds column vw - 1 (a byte
//     permute replicates it upward), or lies wholly past it beside the run
//     that holds it (the value comes from the neighbouring lane by one
//     shuffle). Only tiles that hold an image's right edge take that path.
//  2. Phases: one barrier, between writing the chroma window and reading
//     it. Luma never passes through shared memory: BT.601 Y, the level
//     shift, both FDCT passes, the division and the rounding run in
//     registers, one thread per block.
//  3. Bank conflicts: the only shared array is the chroma window, 2 planes
//     x 32 x 128 floats (32 KB). A thread box-means its own 8x8 Cb and Cr
//     samples row pair by row pair into float4 quarters and writes them
//     under a swizzle (swz: bit 3 of a float4 slot flips bit 0), so the
//     writes of 8 adjacent lanes and the block-row reads of 8 lanes on
//     adjacent chroma blocks both hit 8 distinct 4-bank groups. After the
//     barrier threads 0..127 each take one chroma block through the same
//     register FDCT with the chroma table.
//  4. Stores: one 16-byte store per coefficient row of a block (a warp
//     writes 512 contiguous bytes of luma; 16 lanes write 256 of chroma).
//  5. Transform: the even/odd form of the 8-point FDCT (sums and
//     differences x[n] +- x[7 - n], then two 4x4 products: 40 operations
//     instead of 64), with the basis in __constant__ memory as immediate
//     operands. Its sums are grouped differently from the plain einsum,
//     which moves a result by a few float32 ulps, so a quantized
//     coefficient that sits on a rounding boundary can land one step away
//     (<= 1 step, the reference's own kernel-vs-XLA limit).
// The colour, box-mean and quantize arithmetic uses explicit
// round-to-nearest intrinsics in the plain version's order, and the
// division is a correctly rounded division, so the FDCT's summation order
// is the only source of that step. Blocks past ceil16 of an image's valid
// extent make no loads and no stores; tiles wholly past it return at
// once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TY = 64;             // pixel rows per tile: 8 warps of blocks
constexpr int TX = 256;            // pixel cols per tile: 32 blocks, one warp
constexpr int NT = TY / 8 * 32;    // one thread per luma block
constexpr int CR = TY / 2;         // chroma window rows per plane
constexpr int CC = TX / 2;         // chroma window cols (floats) per plane
constexpr int NCB = CR / 8 * (CC / 8);   // chroma blocks per plane (64)
constexpr int kClamp = 1023;
constexpr unsigned kFull = 0xffffffffu;

// D[k][n] = c_k cos((2n+1) k pi / 16), c_0 = sqrt(1/8), c_k = 1/2: the
// float32 values of ops/jpeg_decode.idct_basis() (a CPU test checks them).
// The transform uses its mirror symmetry D[k][7-n] = (-1)^k D[k][n].
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

// 1-D forward transform, out[k] = sum_n D[k][n] x[n]: even k from the sums
// x[n] + x[7 - n], odd k from the differences.
__device__ __forceinline__ void fdct8(const float (&x)[8], float (&out)[8]) {
  float s[4], d[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    s[n] = __fadd_rn(x[n], x[7 - n]);
    d[n] = __fsub_rn(x[n], x[7 - n]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float* t = (k & 1) ? d : s;
    float acc = __fmul_rn(kDct[8 * k], t[0]);
#pragma unroll
    for (int n = 1; n < 4; ++n) acc = fmaf(kDct[8 * k + n], t[n], acc);
    out[k] = acc;
  }
}

// Two quantized coefficients (each within +-1023) into one word, the
// first in the low half.
__device__ __forceinline__ int pack2(int a, int b) {
  return static_cast<int>(__byte_perm(a, b, 0x5410));
}

// acc / q, round half to even, clamp (the conversion rounds to nearest
// even, as rintf does).
__device__ __forceinline__ int quantize(float acc, float q) {
  return min(max(__float2int_rn(__fdiv_rn(acc, q)), -kClamp), kClamp);
}

// A block of level-shifted samples x[8 * row + col] (every index a
// compile-time constant, so it stays in registers): the vertical pass in
// place, then row by row the horizontal pass, the division by table q
// (row-major, 16-byte aligned) and one 16-byte store of the 8
// coefficients to dst + row * pitch.
__device__ __forceinline__ void fdct_quantize_store(float (&x)[64],
                                                    const float* __restrict__ q,
                                                    int16_t* dst, int pitch) {
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    float c[8], o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = x[i * 8 + v];
    fdct8(c, o);
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k * 8 + v] = o[k];
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float c[8], o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = x[r * 8 + j];
    fdct8(c, o);
    const float4 qa = __ldg(reinterpret_cast<const float4*>(q + 8 * r));
    const float4 qb = __ldg(reinterpret_cast<const float4*>(q + 8 * r + 4));
    *reinterpret_cast<int4*>(dst + static_cast<size_t>(r) * pitch) = make_int4(
        pack2(quantize(o[0], qa.x), quantize(o[1], qa.y)),
        pack2(quantize(o[2], qa.z), quantize(o[3], qa.w)),
        pack2(quantize(o[4], qb.x), quantize(o[5], qb.y)),
        pack2(quantize(o[6], qb.z), quantize(o[7], qb.w)));
  }
}

// Shared-memory float4 slot of float4 column f of a window row: bit 3 of
// f flips bit 0, so 8 lanes on 8 adjacent slots and 8 lanes on 8 adjacent
// chroma blocks (slots 2t or 2t + 1) both land on 8 distinct 4-bank
// groups.
__device__ __forceinline__ int swz(int f) { return f ^ ((f >> 3) & 1); }

// Pixel j (0..7) of an 8-byte run, as a float.
__device__ __forceinline__ float px(const uint2& v, int j) {
  return static_cast<float>(((j < 4 ? v.x : v.y) >> (8 * (j & 3))) & 0xffu);
}

__global__ void __launch_bounds__(NT, 2)
encode_kernel(const uint8_t* __restrict__ rgb, long long s_img,
              long long s_chan, long long s_row, const int* __restrict__ valid,
              const float* __restrict__ qt, int16_t* __restrict__ yc,
              int16_t* __restrict__ cbc, int16_t* __restrict__ crc, int h,
              int w) {
  __shared__ __align__(16) float win[2 * CR * CC];

  const int tid = threadIdx.x, lane = tid & 31, by = tid >> 5;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int vh = min(max(valid[2 * b], 1), h);
  const int vw = min(max(valid[2 * b + 1], 1), w);
  // the emitted grid: ceil16 of the valid extent (inside the canvas, as h
  // and w are multiples of 16)
  const int gh = (vh + 15) & ~15, gw = (vw + 15) & ~15;
  if (y0 >= gh || x0 >= gw) return;   // tiles wholly past it

  const int gy0 = y0 + 8 * by, gx0 = x0 + 8 * lane;
  const size_t yplane = static_cast<size_t>(h) * w;

  if (gy0 < gh) {   // warp-uniform: this row of blocks is emitted
    const bool active = gx0 < gw;
    // an emitted block whose run starts past the last valid column takes
    // its pixels from the neighbouring lane and loads nothing
    const bool loads = gx0 < vw;
    uint2 raw[3][8];
    const uint8_t* img = rgb + b * s_img + gx0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint8_t* p = img + min(gy0 + r, vh - 1) * s_row;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        raw[c][r] = loads ? __ldg(reinterpret_cast<const uint2*>(p + c * s_chan))
                          : make_uint2(0u, 0u);
    }

    if (x0 + TX > vw) {   // block-uniform: the tile holds the right edge
      // byte j of a run takes byte min(j, k), k the run's index of column
      // vw - 1; a run wholly past it (k < 0) takes the top byte of the
      // lane before it, which holds that column in the same MCU
      const int k = vw - 1 - gx0;
      const int kk = min(max(k, 0), 7);
      uint32_t sel_lo = 0, sel_hi = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sel_lo |= static_cast<uint32_t>(min(j, kk)) << (4 * j);
        sel_hi |= static_cast<uint32_t>(min(j + 4, kk)) << (4 * j);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const uint2 v = raw[c][r];
          uint2 o = make_uint2(__byte_perm(v.x, v.y, sel_lo),
                               __byte_perm(v.x, v.y, sel_hi));
          const uint32_t up = __shfl_up_sync(kFull, o.y, 1);
          if (k < 0) o.x = o.y = __byte_perm(up, 0u, 0x3333);
          raw[c][r] = o;
        }
      }
    }

    if (active) {
      // Colour, a row pair at a time: Y - 128 stays in registers, the
      // pair's Cb and Cr are box-meaned to 4 samples each and written to
      // the window.
      float y[64];
      float* wb = win + (4 * by) * CC + 4 * swz(lane);
      float* wr = wb + CR * CC;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float mb[4], mr[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float cb[4], cr[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 2 * p + (e >> 1), j = 2 * q + (e & 1);
            const float R = px(raw[0][r], j), G = px(raw[1][r], j),
                        B = px(raw[2][r], j);
            y[r * 8 + j] = __fsub_rn(
                __fadd_rn(__fadd_rn(__fmul_rn(0.299f, R), __fmul_rn(0.587f, G)),
                          __fmul_rn(0.114f, B)),
                128.0f);
            cb[e] = __fadd_rn(
                __fadd_rn(__fsub_rn(__fmul_rn(-0.168735892f, R),
                                    __fmul_rn(0.331264108f, G)),
                          __fmul_rn(0.5f, B)),
                128.0f);
            cr[e] = __fadd_rn(
                __fsub_rn(__fsub_rn(__fmul_rn(0.5f, R),
                                    __fmul_rn(0.418687589f, G)),
                          __fmul_rn(0.081312411f, B)),
                128.0f);
          }
          mb[q] = __fmul_rn(__fadd_rn(__fadd_rn(cb[0], cb[1]),
                                      __fadd_rn(cb[2], cb[3])), 0.25f);
          mr[q] = __fmul_rn(__fadd_rn(__fadd_rn(cr[0], cr[1]),
                                      __fadd_rn(cr[2], cr[3])), 0.25f);
        }
        *reinterpret_cast<float4*>(wb + p * CC) =
            make_float4(mb[0], mb[1], mb[2], mb[3]);
        *reinterpret_cast<float4*>(wr + p * CC) =
            make_float4(mr[0], mr[1], mr[2], mr[3]);
      }
      fdct_quantize_store(y, qt, yc + b * yplane + static_cast<size_t>(gy0) * w + gx0,
                          w);
    }
  }
  __syncthreads();

  // Chroma: threads 0..127, one block each (plane, block row, block col).
  if (tid >= 2 * NCB) return;
  const int plane = tid / NCB, br = (tid % NCB) / (CC / 8), bc = tid % (CC / 8);
  if (y0 + 16 * br >= gh || x0 + 16 * bc >= gw) return;   // its MCU is not emitted
  const float* rows = win + (plane * CR + 8 * br) * CC;
  float x[64];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(rows + r * CC + 4 * swz(2 * bc));
    const float4 c = *reinterpret_cast<const float4*>(rows + r * CC + 4 * swz(2 * bc + 1));
    const float v[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) x[r * 8 + j] = __fsub_rn(v[j], 128.0f);
  }
  const int cw = w / 2;
  int16_t* dst = (plane ? crc : cbc) + b * (yplane / 4) +
                 static_cast<size_t>(y0 / 2 + 8 * br) * cw + x0 / 2 + 8 * bc;
  fdct_quantize_store(x, qt + 64, dst, cw);
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

// rgb: (B, 3, h, w) u8 with element strides s_img, s_chan, s_row (columns
// contiguous), its base and the three strides multiples of 8 (the 8-byte
// loads); valid (B, 2) int32; qt (2, 8, 8) float32 luma then chroma; yc
// (B, h, w), cbc and crc (B, h/2, w/2) int16, contiguous; qt, yc, cbc and
// crc 16-byte aligned. h and w must be multiples of 16.
extern "C" int ip_encode_420(const void* rgb, long long s_img, long long s_chan,
                             long long s_row, const void* valid, const void* qt,
                             void* yc, void* cbc, void* crc, int batch, int h,
                             int w, int device, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || h % 16 || w % 16 ||
      !aligned(rgb, 8) || s_img % 8 || s_chan % 8 || s_row % 8 ||
      !aligned(qt, 16) || !aligned(yc, 16) || !aligned(cbc, 16) ||
      !aligned(crc, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own static CUDA runtime: make the operands'
  // card current in it too (a no-op when it already is)
  const cudaError_t on = cudaSetDevice(device);
  if (on != cudaSuccess) return static_cast<int>(on);
  const dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY, batch);
  encode_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), s_img, s_chan, s_row,
      static_cast<const int*>(valid), static_cast<const float*>(qt),
      static_cast<int16_t*>(yc), static_cast<int16_t*>(cbc),
      static_cast<int16_t*>(crc), h, w);
  return static_cast<int>(cudaGetLastError());
}
