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
// the least traffic is 201 MB of luma and 101 MB of chroma coefficients
// read and 302 MB of RGB written (604 MB, 0.180 ms at 3.35 TB/s). The
// arithmetic is 5.6 GFLOP of FP32 (0.084 ms at 67 TFLOP/s), counted as
// chip_smoke.py's b1_bound does; the conversions, selects, shared-memory
// accesses, shuffles and packing around it take instruction slots too, so the
// transforms have to stay lean as well.
//
// Design. A block owns a TY x 256 luma tile (64 x 256 for 4:2:0, 32 x 256
// for 4:2:2 and 4:4:0, 16 x 256 for 4:4:4); thread t owns luma block
// (t / 32, t % 32), so a warp is one row of 32 adjacent 8x8 blocks.
//  1. Loads: each coefficient row of an 8x8 block (8 x int16) arrives in one
//     16-byte load into registers, so a warp reads 512 contiguous bytes
//     per load instruction, with no per-coefficient branch. A thread
//     starts its luma block's 8 loads first and keeps them in flight while
//     the block transforms its chroma; two blocks share an SM, so one's
//     loads overlap the other's arithmetic.
//  2. Phases: there is one barrier, between writing the chroma window and
//     reading it. Luma never passes through shared memory: dequantize, the
//     clamp and both IDCT passes run in registers, one thread per block.
//  3. Bank conflicts: the chroma window's rows hold float4 slots under a
//     swizzle (swz: bit 3 of a slot flips bit 0), so the block-row writes
//     of 8 lanes on adjacent blocks and the colour pass's reads of
//     adjacent slots hit 8 distinct 4-bank groups.
//  4. Chroma halo: the tile's own chroma blocks plus one whole block on
//     each upsampled side go through the same register IDCT into the
//     window (4:2:0: 216 blocks for 128 of its own, 1.7x). Whole halo
//     blocks are transformed, not just the row or column the upsample
//     reads.
//  5. Stores: the colour pass runs from registers, row by row: the
//     horizontal IDCT of one luma row, one chroma row segment per plane (a
//     float4 with its neighbours from the adjacent lanes by shuffle), the
//     upsample taps, BT.601, and one 8-byte packed store per plane (a warp
//     writes 256 contiguous bytes) where out_w % 8 == 0 (every rung of the
//     bucket ladder); otherwise bytewise. The width is chosen per launch.
// The transform is the even/odd form of the 8-point IDCT (40 operations
// instead of 64): its sums are grouped differently from the plain einsum,
// which moves a result by a few float32 ulps, so a rounded output can
// differ by one step (<= 1 LSB, the reference's own kernel-vs-XLA limit).
// The valid-extent clamp of the chroma taps is applied to the row
// segments in registers. The colour and upsample arithmetic uses explicit
// round-to-nearest intrinsics in the plain version's order (the exact /4
// of each upsample tap is taken once, at the end), so the IDCT is the only
// source of that 1 LSB.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 256;   // luma cols per tile: 32 blocks, one warp
constexpr float kClamp = 4096.0f;
constexpr unsigned kFull = 0xffffffffu;

// D[k][n] = c_k cos((2n+1) k pi / 16), c_0 = sqrt(1/8), c_k = 1/2: the
// float32 values of ops/jpeg_decode.idct_basis() (a CPU test checks them).
// The transform uses its mirror symmetry D[k][7-n] = (-1)^k D[k][n].
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

// Tile geometry for subsampling FH x FW. The chroma window in shared
// memory holds, per plane, the tile's own CR x CC chroma samples with
// HR rows and HC cols of halo blocks on each upsampled side.
template <int FH, int FW>
struct Geo {
  static constexpr bool kUpH = FH == 2, kUpW = FW == 2;
  static constexpr bool kUp = kUpH || kUpW;
  static constexpr int TY = (kUpH && kUpW) ? 64 : (kUp ? 32 : 16);
  static constexpr int NT = TY / 8 * 32;            // one thread per luma block
  static constexpr int CR = TY / FH, CC = TX / FW;  // own chroma samples
  static constexpr int HR = kUpH ? 8 : 0, HC = kUpW ? 8 : 0;
  static constexpr int ROWS = CR + 2 * HR;          // window rows
  static constexpr int SC = CC + 2 * HC;            // window row, floats
  static constexpr int WBC = SC / 8;                // window blocks per row
  static constexpr int NBLK = ROWS / 8 * WBC;       // window blocks per plane
  static constexpr int MIN_BLOCKS = 512 / NT;       // 2 x 256 threads per SM
  static constexpr size_t kSmem = sizeof(float) * 2 * ROWS * SC;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// 1-D inverse, outputs n and 7 - n (n = 0..3) of coefficients c: the even
// and odd halves of the sum, then their sum and difference.
__device__ __forceinline__ void idct_pair(const float (&c)[8], int n,
                                          float& lo, float& hi) {
  float e = __fmul_rn(kIdct[n], c[0]);
  e = fmaf(kIdct[16 + n], c[2], e);
  e = fmaf(kIdct[32 + n], c[4], e);
  e = fmaf(kIdct[48 + n], c[6], e);
  float o = __fmul_rn(kIdct[8 + n], c[1]);
  o = fmaf(kIdct[24 + n], c[3], o);
  o = fmaf(kIdct[40 + n], c[5], o);
  o = fmaf(kIdct[56 + n], c[7], o);
  lo = __fadd_rn(e, o);
  hi = __fsub_rn(e, o);
}

// 1-D inverse of all 8 outputs: out[n] = sum_k D[k][n] c[k].
__device__ __forceinline__ void idct8(const float (&c)[8], float (&out)[8]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) idct_pair(c, n, out[n], out[7 - n]);
}

// Row r of a block held as x[8 * row + col].
__device__ __forceinline__ void get_row(const float (&x)[64], int r,
                                        float (&c)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = x[r * 8 + k];
}

// The vertical pass of a whole block, in place (every index is a
// compile-time constant, so the block stays in registers).
__device__ __forceinline__ void idct_cols(float (&x)[64]) {
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    float c[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = x[k * 8 + v];
    idct8(c, o);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i * 8 + v] = o[i];
  }
}

// A block's 8 coefficient rows, one 16-byte load each (zeros off the
// canvas, where p is not read).
__device__ __forceinline__ void load_block(int4 (&raw)[8],
                                           const int16_t* p, int pitch,
                                           bool inside) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
    raw[r] = inside ? __ldg(reinterpret_cast<const int4*>(
                          p + static_cast<size_t>(r) * pitch))
                    : make_int4(0, 0, 0, 0);
}

// Dequantize a block with table q (row-major, 16-byte aligned) and clamp.
__device__ __forceinline__ void dequant(const int4 (&raw)[8],
                                        const float* __restrict__ q,
                                        float (&x)[64]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float4 qa = __ldg(reinterpret_cast<const float4*>(q + 8 * r));
    const float4 qb = __ldg(reinterpret_cast<const float4*>(q + 8 * r + 4));
    const float qs[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
    const int w[4] = {raw[r].x, raw[r].y, raw[r].z, raw[r].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float lo = static_cast<float>(static_cast<int16_t>(w[k] & 0xffff));
      const float hi = static_cast<float>(w[k] >> 16);
      x[r * 8 + 2 * k] = fminf(fmaxf(__fmul_rn(lo, qs[2 * k]), -kClamp), kClamp);
      x[r * 8 + 2 * k + 1] =
          fminf(fmaxf(__fmul_rn(hi, qs[2 * k + 1]), -kClamp), kClamp);
    }
  }
}

// Shared-memory float4 slot of float4 column f of a window row: bit 3 of
// f flips bit 0, so 8 lanes on 8 adjacent blocks (slots 2t or 2t + 1)
// and 8 lanes on 8 adjacent slots (from an even one) both land on 8
// distinct 4-bank groups.
__device__ __forceinline__ int swz(int f) { return f ^ ((f >> 3) & 1); }

// Address of float column c of a window row under that swizzle.
__device__ __forceinline__ int swz_col(int c) {
  return (swz(c >> 2) << 2) | (c & 3);
}

__device__ __forceinline__ float4 ld4(const float* row, int slot) {
  return *reinterpret_cast<const float4*>(row + 4 * swz(slot));
}

// +128, and the [0, 255] clamp of chroma that is upsampled.
template <bool kUp>
__device__ __forceinline__ float shift_clamp(float v) {
  v = __fadd_rn(v, 128.0f);
  return kUp ? fminf(fmaxf(v, 0.0f), 255.0f) : v;
}

// 3 * near + far, rounded step by step like the plain version: its fancy
// upsample tap is this / 4. The / 4 of each axis is exact (a power of
// two; no subnormals here), so it is taken once, at the end.
__device__ __forceinline__ float tri3(float near_v, float far_v) {
  return __fadd_rn(__fmul_rn(3.0f, near_v), far_v);
}

__device__ __forceinline__ float4 tri3(float4 n, float4 f) {
  return make_float4(tri3(n.x, f.x), tri3(n.y, f.y), tri3(n.z, f.z),
                     tri3(n.w, f.w));
}

// One chroma plane's samples for a luma row of this thread's block, from
// window rows `near` and `far` (vertically upsampled, x4, when FH == 2):
// FW == 2: own chroma cols 4 * lane - 1 .. 4 * lane + 4 in v[0..5] (the
// float4 in the middle from shared memory, its neighbours from the
// adjacent lanes, the warp's two edge samples from the halo columns);
// FW == 1: own chroma cols 8 * lane .. 8 * lane + 7.
template <int FH, int FW>
__device__ __forceinline__ void chroma_seg(const float* near, const float* far,
                                           int lane, float (&v)[8]) {
  using G = Geo<FH, FW>;
  if constexpr (FW == 2) {
    float4 m = ld4(near, G::HC / 4 + lane);
    float el = near[swz_col(G::HC - 1)], er = near[swz_col(G::HC + G::CC)];
    if constexpr (FH == 2) {
      m = tri3(m, ld4(far, G::HC / 4 + lane));
      el = tri3(el, far[swz_col(G::HC - 1)]);
      er = tri3(er, far[swz_col(G::HC + G::CC)]);
    }
    const float left = __shfl_up_sync(kFull, m.w, 1);
    const float right = __shfl_down_sync(kFull, m.x, 1);
    v[0] = lane == 0 ? el : left;
    v[1] = m.x; v[2] = m.y; v[3] = m.z; v[4] = m.w;
    v[5] = lane == 31 ? er : right;
  } else {
    float4 a = ld4(near, 2 * lane), c = ld4(near, 2 * lane + 1);
    if constexpr (FH == 2) {
      a = tri3(a, ld4(far, 2 * lane));
      c = tri3(c, ld4(far, 2 * lane + 1));
    }
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
  }
}

// The valid-extent clamp of a FW == 2 segment whose v[0] is chroma col
// c0: col -1 takes col 0, and every col from cvw on takes col cvw - 1
// (the plain version's replicated edge; a valid pixel's near tap is
// always inside, so it never reads a replaced value).
__device__ __forceinline__ void clamp_seg(float (&v)[8], int c0, int cvw) {
  if (c0 < 0) v[0] = v[1];
#pragma unroll
  for (int m = 1; m < 6; ++m)
    if (c0 + m >= cvw) v[m] = v[m - 1];
}

// Round half to even and clip to [0, 255] (the conversion saturates
// below 0).
__device__ __forceinline__ uint32_t to_u8(float v) {
  return min(__float2uint_rn(v), 255u);
}

// Four bytes (each < 256) into one word, the first in the low byte.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

template <int FH, int FW, bool kPacked>
__global__ void __launch_bounds__(Geo<FH, FW>::NT, Geo<FH, FW>::MIN_BLOCKS)
decode_kernel(const int16_t* __restrict__ yc, const int16_t* __restrict__ cbc,
              const int16_t* __restrict__ crc, const float* __restrict__ qt,
              const int* __restrict__ cv, uint8_t* __restrict__ out, int ch,
              int cw, int out_h, int out_w) {
  using G = Geo<FH, FW>;
  extern __shared__ __align__(16) float win[];   // 2 planes x ROWS x SC

  const int tid = threadIdx.x, lane = tid & 31, by = tid >> 5;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * G::TY, tx0 = blockIdx.x * TX;
  const int chc = ch / FH, cwc = cw / FW;
  const int cy0 = ty0 / FH, cx0 = tx0 / FW;   // own chroma origin
  const float* qb = qt + static_cast<size_t>(b) * 192;

  // This thread's luma block: in flight while the chroma is transformed.
  const int gy0 = ty0 + 8 * by, gx0 = tx0 + 8 * lane;
  const bool yin = gy0 < ch && gx0 < cw;
  int4 yraw[8];
  load_block(yraw, yc + (yin ? (static_cast<size_t>(b) * ch + gy0) * cw + gx0 : 0),
             cw, yin);

  // Chroma: the window's blocks (own and halo), each through the register
  // IDCT, level-shifted (and clamped where upsampled), into shared memory.
  const size_t coff = static_cast<size_t>(b) * chc * cwc;
  for (int item = tid; item < 2 * G::NBLK; item += G::NT) {
    const int plane = item / G::NBLK, k = item % G::NBLK;
    const int br = k / G::WBC, bc = k % G::WBC;
    const int gy = cy0 - G::HR + 8 * br, gx = cx0 - G::HC + 8 * bc;
    const bool inside = gy >= 0 && gy < chc && gx >= 0 && gx < cwc;
    int4 raw[8];
    load_block(raw, (plane ? crc : cbc) + coff +
                        (inside ? static_cast<size_t>(gy) * cwc + gx : 0),
               cwc, inside);
    float x[64];
    dequant(raw, qb + 64 * (plane + 1), x);
    idct_cols(x);
    float* rows = win + (plane * G::ROWS + 8 * br) * G::SC;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float c[8], o[8];
      get_row(x, r, c);
      idct8(c, o);
      float* row = rows + r * G::SC;
      *reinterpret_cast<float4*>(row + 4 * swz(2 * bc)) =
          make_float4(shift_clamp<G::kUp>(o[0]), shift_clamp<G::kUp>(o[1]),
                      shift_clamp<G::kUp>(o[2]), shift_clamp<G::kUp>(o[3]));
      *reinterpret_cast<float4*>(row + 4 * swz(2 * bc + 1)) =
          make_float4(shift_clamp<G::kUp>(o[4]), shift_clamp<G::kUp>(o[5]),
                      shift_clamp<G::kUp>(o[6]), shift_clamp<G::kUp>(o[7]));
    }
  }

  // Luma: dequantize and the vertical pass, in registers.
  float y[64];
  dequant(yraw, qb, y);
  idct_cols(y);
  __syncthreads();

  const int cvh = clampi(cv[2 * b], 1, chc);
  const int cvw = clampi(cv[2 * b + 1], 1, cwc);
  const int c0 = cx0 + 4 * lane - 1;   // chroma col of v[0] when FW == 2
  const bool xedge = G::kUpW && (c0 < 0 || c0 + 5 >= cvw);
  const float* wb = win + G::HR * G::SC;             // own chroma row 0
  const float* wr = wb + G::ROWS * G::SC;
  const size_t plane_px = static_cast<size_t>(out_h) * out_w;
  uint8_t* ob = out + static_cast<size_t>(b) * 3 * plane_px;
  const int nx = out_w - gx0;   // output bytes of this block's rows
  // the two upsample taps' exact / 4s, taken at the end
  constexpr float kScale = (FH == 2 ? 0.25f : 1.0f) * (FW == 2 ? 0.25f : 1.0f);

  // Row by row: the horizontal pass of one luma row, its chroma, BT.601
  // and the stores.
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    // own chroma row of this luma row, and the far row of its vertical
    // tap (the near one where that lies outside the valid extent)
    const int i = FH == 2 ? 4 * by + r / 2 : 8 * by + r;
    int io = i;
    if constexpr (FH == 2) {
      io = (r & 1) ? i + 1 : i - 1;
      if (cy0 + io < 0 || cy0 + io >= cvh) io = i;
    }
    float vb[8], vr[8];
    chroma_seg<FH, FW>(wb + i * G::SC, wb + io * G::SC, lane, vb);
    chroma_seg<FH, FW>(wr + i * G::SC, wr + io * G::SC, lane, vr);
    if (xedge) {
      clamp_seg(vb, c0, cvw);
      clamp_seg(vr, c0, cvw);
    }
    float c[8], lum[8];
    get_row(y, r, c);
    idct8(c, lum);
    uint32_t u[3][8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float hb, hr;
      if constexpr (FW == 2) {
        const int j = k / 2 + 1, jo = (k & 1) ? j + 1 : j - 1;
        hb = tri3(vb[j], vb[jo]);
        hr = tri3(vr[j], vr[jo]);
      } else {
        hb = vb[k];
        hr = vr[k];
      }
      // chroma - 128: the scale is exact, so this is one rounding
      const float cb = fmaf(hb, kScale, -128.0f);
      const float cr = fmaf(hr, kScale, -128.0f);
      const float l = __fadd_rn(lum[k], 128.0f);
      u[0][k] = to_u8(__fadd_rn(l, __fmul_rn(1.402f, cr)));
      u[1][k] = to_u8(__fsub_rn(__fsub_rn(l, __fmul_rn(0.344136f, cb)),
                                __fmul_rn(0.714136f, cr)));
      u[2][k] = to_u8(__fadd_rn(l, __fmul_rn(1.772f, cb)));
    }
    const int gy = gy0 + r;
    if (gy < out_h && nx > 0) {
      uint8_t* p = ob + static_cast<size_t>(gy) * out_w + gx0;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if constexpr (kPacked) {   // out_w % 8 == 0: the row is whole
          *reinterpret_cast<uint2*>(p + k * plane_px) =
              make_uint2(pack4(u[k][0], u[k][1], u[k][2], u[k][3]),
                         pack4(u[k][4], u[k][5], u[k][6], u[k][7]));
        } else {
#pragma unroll
          for (int m = 0; m < 8; ++m)
            if (m < nx) p[k * plane_px + m] = static_cast<uint8_t>(u[k][m]);
        }
      }
    }
  }
}

template <int FH, int FW, bool kPacked>
cudaError_t launch(const void* yc, const void* cbc, const void* crc,
                   const void* qt, const void* cv, void* out, int batch,
                   int ch, int cw, int out_h, int out_w, cudaStream_t stream) {
  using G = Geo<FH, FW>;
  const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<FH, FW, kPacked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(G::kSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((out_w + TX - 1) / TX, (out_h + G::TY - 1) / G::TY, batch);
  decode_kernel<FH, FW, kPacked><<<grid, G::NT, G::kSmem, stream>>>(
      static_cast<const int16_t*>(yc), static_cast<const int16_t*>(cbc),
      static_cast<const int16_t*>(crc), static_cast<const float*>(qt),
      static_cast<const int*>(cv), static_cast<uint8_t*>(out), ch, cw, out_h,
      out_w);
  return cudaGetLastError();
}

// 8-byte packed stores where every row start is a multiple of 8 bytes
// from the 16-byte aligned base (out_w % 8 == 0), else bytewise.
template <int FH, int FW>
cudaError_t launch_mode(const void* yc, const void* cbc, const void* crc,
                        const void* qt, const void* cv, void* out, int batch,
                        int ch, int cw, int out_h, int out_w, cudaStream_t s) {
  if (out_w % 8 == 0)
    return launch<FH, FW, true>(yc, cbc, crc, qt, cv, out, batch, ch, cw, out_h, out_w, s);
  return launch<FH, FW, false>(yc, cbc, crc, qt, cv, out, batch, ch, cw, out_h, out_w, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// yc (B, ch, cw) i16; cbc/crc (B, ch/fh, cw/fw) i16; qt (B, 3, 8, 8) f32;
// cv (B, 2) i32; out (B, 3, out_h, out_w) u8 with out_h <= ch, out_w <= cw.
// Every buffer contiguous; yc, cbc, crc, qt and out 16-byte aligned; ch a
// multiple of 8 * fh and cw of 8 * fw.
extern "C" int ip_decode_coefs(const void* yc, const void* cbc,
                               const void* crc, const void* qt, const void* cv,
                               void* out, int batch, int ch, int cw, int fh,
                               int fw, int out_h, int out_w, int device,
                               void* stream) {
  if (batch <= 0 || out_h <= 0 || out_w <= 0 || out_h > ch || out_w > cw ||
      batch > 65535 || fh < 1 || fw < 1 || ch % (8 * fh) || cw % (8 * fw) ||
      !aligned16(yc) || !aligned16(cbc) || !aligned16(crc) || !aligned16(qt) ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own static CUDA runtime: make the operands'
  // card current in it too (a no-op when it already is)
  const cudaError_t on = cudaSetDevice(device);
  if (on != cudaSuccess) return static_cast<int>(on);
  auto s = static_cast<cudaStream_t>(stream);
  switch (fh * 10 + fw) {
    case 22: return launch_mode<2, 2>(yc, cbc, crc, qt, cv, out, batch, ch, cw, out_h, out_w, s);
    case 12: return launch_mode<1, 2>(yc, cbc, crc, qt, cv, out, batch, ch, cw, out_h, out_w, s);
    case 21: return launch_mode<2, 1>(yc, cbc, crc, qt, cv, out, batch, ch, cw, out_h, out_w, s);
    case 11: return launch_mode<1, 1>(yc, cbc, crc, qt, cv, out, batch, ch, cw, out_h, out_w, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
