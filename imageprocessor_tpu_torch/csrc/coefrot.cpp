// Host code, not a kernel: runtime/hostcodec.py compiles it with g++ into
// the port's host library beside native/jpeg_scan.cpp, jpeg_emit.cpp and
// gifquant.cpp (kernels.py builds only csrc/*.cu). A copy of
// native/ipcodec.cpp's ip_coef_rot_i16, which cannot be built on a host
// without libjpeg's headers; runtime/coeftx.py fuses a mirror + transpose
// pair onto it (hostcodec.coef_rot_i16).

#include <cstdint>

extern "C" {

// Blocked coefficient-plane rotation for the lossless JPEG transforms
// (runtime/coeftx.py). The plane is an (hb*8, wb*8) int16 grid of 8x8
// DCT blocks; a 90-degree image rotation is a transpose of the block
// GRID combined with a transpose of EACH block plus a frequency sign
// flip inherited from the mirror half of the decomposition:
//   mode 0: pure transpose          out_blk(I,J) = T(src_blk(J,I))
//   mode 1: rot90 ccw               out_blk(I,J) = T(src_blk(J,wb-1-I)),
//           out[u][v] *= (u&1) ? -1 : 1   (flip_h's (-1)^v pre-transpose)
//   mode 2: rot270 ccw              out_blk(I,J) = T(src_blk(hb-1-J,I)),
//           out[u][v] *= (v&1) ? -1 : 1   (flip_v's (-1)^u pre-transpose)
// dst dims are (wb*8, hb*8). Output blocks are written sequentially
// (row-major) so the pass runs at copy bandwidth instead of the
// cache-hostile element-wise transpose numpy performs (~6x measured).
// Returns 0 on success, nonzero on bad arguments.
int ip_coef_rot_i16(const int16_t* src, int64_t hb, int64_t wb,
                    int16_t* dst, int mode) {
  if (!src || !dst || hb <= 0 || wb <= 0 || mode < 0 || mode > 2)
    return 1;
  const int64_t sstride = wb * 8;   // src row stride (elements)
  const int64_t dstride = hb * 8;   // dst row stride
  for (int64_t I = 0; I < wb; ++I) {
    for (int64_t J = 0; J < hb; ++J) {
      int64_t sr = J, sc = I;
      if (mode == 1) sc = wb - 1 - I;
      else if (mode == 2) sr = hb - 1 - J;
      const int16_t* s = src + (sr * 8) * sstride + sc * 8;
      int16_t* d = dst + (I * 8) * dstride + J * 8;
      if (mode == 1) {
        for (int u = 0; u < 8; ++u) {
          int16_t* drow = d + u * dstride;
          const int16_t sign = (u & 1) ? -1 : 1;
          for (int v = 0; v < 8; ++v)
            drow[v] = static_cast<int16_t>(s[v * sstride + u] * sign);
        }
      } else if (mode == 2) {
        for (int u = 0; u < 8; ++u) {
          int16_t* drow = d + u * dstride;
          for (int v = 0; v < 8; ++v)
            drow[v] = static_cast<int16_t>(
                s[v * sstride + u] * ((v & 1) ? -1 : 1));
        }
      } else {
        for (int u = 0; u < 8; ++u) {
          int16_t* drow = d + u * dstride;
          for (int v = 0; v < 8; ++v)
            drow[v] = s[v * sstride + u];
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
