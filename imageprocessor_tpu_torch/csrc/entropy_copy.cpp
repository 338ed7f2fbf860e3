// Host code, not a kernel: runtime/hostcodec.py compiles it with g++ into
// the port's host library beside native/jpeg_scan.cpp (kernels.py builds
// only csrc/*.cu). It stages a baseline JPEG's entropy-coded segment for
// kernel B0 (csrc/jpeg_entropy.cu): one copy of the scan's bytes with the
// byte stuffing taken out, each restart segment's start recorded, and a
// zero tail, so that the card reads the bits the host scanner's BitReader
// would read (native/jpeg_scan.cpp: an FF 00 pair is one FF byte, any
// other marker ends the data and zero bits follow it).

#include <cstdint>
#include <cstring>

namespace {

// Bytes of zeros written past the data: the card reads its bits in
// aligned 32-bit words and looks up to 32 bits ahead of a code's start.
constexpr int64_t kTail = 16;

// Offset of the first entropy-coded byte: the marker walk of the host
// scanner's header parse (fill bytes, standalone markers, segment
// lengths) up to the end of the first SOS segment; -1 if there is none.
int64_t scan_start(const uint8_t* data, int64_t len) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;
  int64_t pos = 2;
  while (pos + 4 <= len) {
    if (data[pos] != 0xFF) return -1;
    const uint8_t m = data[pos + 1];
    if (m == 0xFF) {
      ++pos;
      continue;
    }
    pos += 2;
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    const int64_t seglen = (static_cast<int64_t>(data[pos]) << 8) | data[pos + 1];
    if (seglen < 2 || pos + seglen > len) return -1;
    if (m == 0xDA) return pos + seglen;
    pos += seglen;
  }
  return -1;
}

}  // namespace

extern "C" {

// Copies the entropy-coded data of the stream's first scan into `out`,
// destuffed: FF 00 becomes FF; with restart_interval > 0 an RSTn marker
// ends a segment and the next one starts at the following byte, each
// segment's first byte offset going into seg_start (at most max_segs
// segments: the copy stops at the marker that would start one more);
// any other marker, or the end of the stream, ends the data. kTail zero
// bytes follow the data, then zeros up to a multiple of 16 bytes.
// `out` must hold len + 32 bytes. *nbytes gets the data's length
// (without the tail), *nsegs the segments found, *complete whether an
// FF D9 (EOI) follows the SOS segment anywhere in the stream, which is
// runtime/codecs.py jpeg_stream_complete's test once both walks reach
// the same SOS. Returns 0, or 1 when the headers hold no SOS, 2 for a
// bad argument.
int ip_jpeg_entropy_copy(const uint8_t* data, int64_t len,
                         int restart_interval, uint8_t* out, int64_t cap,
                         int64_t* seg_start, int64_t max_segs,
                         int64_t* nbytes, int64_t* nsegs, int* complete) {
  if (!data || !out || !seg_start || !nbytes || !nsegs || !complete
      || max_segs < 1 || cap < len + 32)
    return 2;
  const int64_t start = scan_start(data, len);
  if (start < 0) return 1;
  const uint8_t* p = data + start;
  const uint8_t* end = data + len;
  int64_t n = 0, segs = 1;
  seg_start[0] = 0;
  while (p < end) {
    // bulk path: 8 bytes with no FF among them
    if (p + 8 <= end) {
      uint64_t chunk;
      memcpy(&chunk, p, 8);
      const uint64_t inv = ~chunk;
      if (((inv - 0x0101010101010101ull) & ~inv & 0x8080808080808080ull)
          == 0) {
        memcpy(out + n, p, 8);
        n += 8;
        p += 8;
        continue;
      }
    }
    const uint8_t b = *p++;
    if (b != 0xFF) {
      out[n++] = b;
      continue;
    }
    const uint8_t b2 = p < end ? *p : 0xD9;
    if (b2 == 0x00) {  // stuffed byte
      out[n++] = 0xFF;
      ++p;
      continue;
    }
    if (restart_interval > 0 && b2 >= 0xD0 && b2 <= 0xD7 && segs < max_segs) {
      ++p;
      seg_start[segs++] = n;
      continue;
    }
    --p;  // any other marker ends the data; p is its FF
    break;
  }
  // no FF before p was followed by D9: look for the EOI from p on
  *complete = 0;
  for (const uint8_t* q = p; q + 1 < end; ++q) {
    q = static_cast<const uint8_t*>(memchr(q, 0xFF, static_cast<size_t>(end - q - 1)));
    if (q == nullptr) break;
    if (q[1] == 0xD9) {
      *complete = 1;
      break;
    }
  }
  *nbytes = n;
  *nsegs = segs;
  int64_t padded = n + kTail;
  padded = (padded + 15) & ~static_cast<int64_t>(15);
  memset(out + n, 0, static_cast<size_t>(padded - n));
  return 0;
}

}  // extern "C"
