// Kernel B0: entropy decode of baseline JPEG scans on the card, for sm_90a.
//
// Replaces no TPU kernel: the reference entropy-scans every upload on the
// host (native/jpeg_scan.cpp) and uploads int16 coefficient planes. B0
// takes the scan's destuffed bytes (csrc/entropy_copy.cpp stages them)
// and writes the same planes, coefficient for coefficient, straight into a
// group's zeroed canvases, in the spatial block layout kernel B1 reads.
// It was added because the host scan was the largest host cost per upload
// while the card sat idle. The plain version beside it is
// imageprocessor_tpu_torch/ops/jpeg_entropy.py `decode_plain`; the phases
// and their order are documented there.
//
// Design (Weißenberger & Schmidt, "Accelerating JPEG Decompression on
// GPUs", 2021): each image's stream is cut into subsequences of
// `subseq_bits` bits, one thread each. A thread decodes the codes that
// start in its subsequence from a state: bit position, block of the MCU,
// zigzag index. `entropy_round` round 0 starts every thread from a guess
// (block 0, index 0); round r >= 1 restarts a thread from its
// predecessor's exit state of round r - 1 wherever that differs from where
// it started, and counts the threads whose exit changed. Rounds run
// until a round changes nothing; a round after such a round returns at
// once, so the host launches a few and reads one counter. They always
// get there: round r leaves thread r's start right at the latest, so no
// more rounds run than the most subsequences of an image, plus one that
// changes nothing. A subsequence
// that begins a restart segment starts in a known state, and a thread
// that reaches a segment's end jumps to the next segment's start in its
// known state. `entropy_scan` turns the threads' block counts and DC sums
// into each thread's first block and DC predictions (a segmented prefix
// sum: a segment start resets both); `entropy_write` decodes once more
// and writes; `entropy_status` reports per image.
//
// Lookup tables: per image and Huffman table, a 9-bit (DC) or 11-bit (AC)
// table gives code length, run and size category; longer codes take the
// canonical decode (ITU T.81 F.2.2.3) from global memory. A block of
// threads serves one image and holds its tables in shared memory.
//
// What bounds it: the serial chain inside a subsequence (a code's length
// gives the next code's start), not bytes. Its least bytes are the
// stream, some 3.9 MB per 12 MP upload, read once, and the 32-byte
// sectors that hold a non-zero coefficient written once (chip_smoke.py
// phase 23 counts both); the init round, the rounds that redo a thread
// and the write pass each read the stream again.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDcBits = 9, kAcBits = 11;
constexpr int kLut = 1 << kAcBits;
constexpr uint32_t kLutErr = 0xFFFF;
constexpr int kTile = 256;
constexpr int kScan = 1024;
constexpr int kSpec = 17 + 256;
// one table in the table buffer: lut uint16[kLut], then int32 maxcode[18],
// valptr[17], mincode[17], then uint8 values[256]
constexpr int kTabBytes = 2 * kLut + 4 * (18 + 17 + 17) + 256;
constexpr int kBadCode = 1, kBadCount = 2;

// image descriptor (ops/jpeg_entropy.py D_*)
enum {
  D_OFF = 0, D_NBITS, D_SEG0, D_NSEGS, D_SEGBLK, D_TOTBLK, D_MCUSX, D_BPM,
  D_SUB0, D_NSUB, D_SLOT, D_TILE0, D_DCID, D_ACID, D_NCOMP,
  D_BLK = 16, D_HV = 26, kDesc = 32
};
// per subsequence int32 element: anchored, blocks, DC sums x3, then the
// carry: first block, DC predictions x3
constexpr int kElem = 9;

__constant__ int8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

__device__ __forceinline__ int64_t pack(int pos, int c, int zz) {
  return (static_cast<int64_t>(pos) << 16) | (c << 8) | zz;
}

struct __align__(16) Shared {
  uint16_t ac[4][kLut];   // first: the 16-byte copies need aligned rows
  uint16_t dc[4][1 << kDcBits];
  int d[kDesc];
  int img;
  int changed;
};

struct Acc {
  int anch, nblk, dc[3];
};

struct Out {  // the write pass's canvases and what it found
  int16_t* plane[3];
  int slot_stride[3], row_stride[3];
  bool bad;
  int seg_ok;
};

__device__ __forceinline__ uint32_t peek(const uint32_t* words, int pos) {
  const int w = pos >> 5;
  const uint32_t hi = __byte_perm(__ldg(words + w), 0, 0x0123);
  const uint32_t lo = __byte_perm(__ldg(words + w + 1), 0, 0x0123);
  return __funnelshift_l(lo, hi, pos & 31);
}

__device__ __forceinline__ int seg_end(const int* d, const int* segs, int seg) {
  return seg + 1 < d[D_NSEGS] ? segs[seg + 1] * 8 : d[D_NBITS];
}

// the last segment starting at or before bit `bit`
__device__ int seg_of(const int* d, const int* segs, int bit) {
  int lo = 0, hi = d[D_NSEGS] - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (segs[mid] * 8 <= bit) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Block i's image, its descriptor and its lookup tables into shared
// memory. Every thread of the block calls it.
__device__ void load_image(Shared& sh, const int* desc, const uint8_t* tabs,
                           int n) {
  if (threadIdx.x == 0) {
    int i = 0;
    while (i + 1 < n && desc[(i + 1) * kDesc + D_TILE0] <= static_cast<int>(blockIdx.x)) ++i;
    sh.img = i;
    sh.changed = 0;
  }
  __syncthreads();
  const int* d = desc + sh.img * kDesc;
  if (threadIdx.x < kDesc) sh.d[threadIdx.x] = d[threadIdx.x];
  const uint8_t* t = tabs + static_cast<size_t>(sh.img) * 8 * kTabBytes;
  const int ncomp = d[D_NCOMP];
  for (int c = 0; c < ncomp; ++c) {
    const int dc = (d[D_DCID] >> (4 * c)) & 15, ac = (d[D_ACID] >> (4 * c)) & 15;
    const uint4* sd = reinterpret_cast<const uint4*>(t + dc * kTabBytes);
    const uint4* sa = reinterpret_cast<const uint4*>(t + (4 + ac) * kTabBytes);
    uint4* dd = reinterpret_cast<uint4*>(sh.dc[dc]);
    uint4* da = reinterpret_cast<uint4*>(sh.ac[ac]);
    for (int k = threadIdx.x; k < (2 << kDcBits) / 16; k += blockDim.x) dd[k] = sd[k];
    for (int k = threadIdx.x; k < (2 * kLut) / 16; k += blockDim.x) da[k] = sa[k];
  }
  __syncthreads();
}

// Decode one lane from (pos, c, zz) until the next code would start at or
// past `end` (or past the last segment): the plain version's
// `_Image.lanes`, code for code.
template <bool kWrite>
__device__ void run_lane(const int* d, const Shared& sh, const uint8_t* gtab,
                         const uint32_t* words, const int* segs, int& pos,
                         int& c, int& zz, int end, int seg, Acc& acc,
                         Out* out) {
  const int segblk = d[D_SEGBLK], total = d[D_TOTBLK], bpm = d[D_BPM];
  const int mcusx = d[D_MCUSX];
  int send = seg_end(d, segs, seg);
  while (true) {
    if (pos >= send) {
      if (seg + 1 < d[D_NSEGS] && send < end) {
        pos = send;
        ++seg;
        c = zz = 0;
        acc.anch = 1;
        acc.nblk = seg * segblk;
        acc.dc[0] = acc.dc[1] = acc.dc[2] = 0;
        send = seg_end(d, segs, seg);
        continue;
      }
      break;
    }
    if (pos >= end) break;
    const uint32_t bits = peek(words, pos);
    const int comp = d[D_BLK + c] >> 8;
    const bool isdc = zz == 0;
    const int tab = isdc ? (d[D_DCID] >> (4 * comp)) & 15
                         : (d[D_ACID] >> (4 * comp)) & 15;
    const uint32_t e = isdc ? sh.dc[tab][bits >> (32 - kDcBits)]
                            : sh.ac[tab][bits >> (32 - kAcBits)];
    bool err = e == kLutErr;
    int ln = e & 31, run = (e >> 5) & 15, s = (e >> 9) & 15;
    if (e == 0) {  // a code longer than the lookup: canonical decode
      const uint8_t* tb = gtab + (isdc ? tab : 4 + tab) * kTabBytes;
      const int* maxcode = reinterpret_cast<const int*>(tb + 2 * kLut);
      const int* valptr = maxcode + 18;
      const int* mincode = valptr + 17;
      const uint8_t* vals = reinterpret_cast<const uint8_t*>(mincode + 17);
      bool found = false;
      for (int k = (isdc ? kDcBits : kAcBits) + 1; k <= 16; ++k) {
        const int cd = static_cast<int>(bits >> (32 - k));
        if (cd <= maxcode[k]) {
          const int sym = vals[min(max(valptr[k] + cd - mincode[k], 0), 255)];
          ln = k;
          run = isdc ? 0 : sym >> 4;
          s = isdc ? sym : sym & 15;
          found = true;
          break;
        }
      }
      err = !found || s > (isdc ? 11 : 10);
    }
    int ext = 0;
    if (!err && s > 0) {
      const int v = static_cast<int>((bits >> (32 - ln - s)) & ((1u << s) - 1));
      ext = v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
    }
    const int k = zz + run;
    bool coef = !isdc && !err && s > 0;
    if (coef && k > 63) {
      err = true;
      coef = false;
    }
    const bool zrl = !isdc && !err && s == 0 && run == 15;
    const int step = err ? 1 : ln + ((coef || isdc) ? s : 0);
    const int newz = (isdc && !err) ? 1 : coef ? k + 1 : zrl ? zz + 16 : 0;
    const bool ends = newz == 0 || newz >= 64;
    if (kWrite) {
      const int b = isdc ? acc.nblk : acc.nblk - 1;
      const int lim = min((seg + 1) * segblk, total);
      const bool valid = b >= seg * segblk && b < lim;
      if (valid && (err || (isdc && b % bpm != c))) out->bad = true;
      if (valid && ((isdc && !err) || coef)) {
        const int m = b / bpm, r = b - m * bpm;
        const int blk = d[D_BLK + r], bc = blk >> 8;
        const int hv = d[D_HV + bc];
        const int by = (m / mcusx) * (hv & 15) + ((blk >> 4) & 15);
        const int bx = (m % mcusx) * (hv >> 4) + (blk & 15);
        const int z = isdc ? 0 : kZigzag[k];
        const int val = isdc ? acc.dc[comp] + ext : ext;
        out->plane[bc][static_cast<int64_t>(d[D_SLOT]) * out->slot_stride[bc]
                       + static_cast<int64_t>(by * 8 + (z >> 3)) * out->row_stride[bc]
                       + bx * 8 + (z & 7)] = static_cast<int16_t>(val);
      }
      if (valid && !err && ends && !isdc && b == lim - 1) {
        const int at = pos + step;
        if (at <= send && at > send - 8) ++out->seg_ok;
      }
    }
    if (isdc && !err) acc.dc[comp] += ext;
    if (isdc) ++acc.nblk;
    pos += step;
    zz = ends ? 0 : newz;
    if (ends) c = c + 1 == bpm ? 0 : c + 1;
  }
}

__global__ void entropy_tables(const uint8_t* huff, uint8_t* tabs) {
  const int t = blockIdx.x % 8;
  const uint8_t* spec = huff + static_cast<size_t>(blockIdx.x) * kSpec;
  uint8_t* out = tabs + static_cast<size_t>(blockIdx.x) * kTabBytes;
  __shared__ int maxcode[18], valptr[17], mincode[17];
  if (threadIdx.x == 0) {
    int code = 0, k = 0;
    maxcode[0] = maxcode[17] = -1;
    valptr[0] = mincode[0] = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += spec[l];
      k += spec[l];
      maxcode[l] = code - 1;
      code <<= 1;
    }
  }
  __syncthreads();
  uint16_t* lut = reinterpret_cast<uint16_t*>(out);
  int* mc = reinterpret_cast<int*>(out + 2 * kLut);
  const bool dc = t < 4;
  const int nb = dc ? kDcBits : kAcBits;
  for (int w = threadIdx.x; w < kLut; w += blockDim.x) {
    uint32_t e = 0;
    if (w < (1 << nb)) {
      for (int l = 1; l <= nb; ++l) {
        const int cd = w >> (nb - l);
        if (cd <= maxcode[l]) {
          const int sym = spec[17 + min(max(valptr[l] + cd - mincode[l], 0), 255)];
          const int run = dc ? 0 : sym >> 4, s = dc ? sym : sym & 15;
          e = s > (dc ? 11 : 10) ? kLutErr : (l | run << 5 | s << 9);
          break;
        }
      }
    }
    lut[w] = static_cast<uint16_t>(e);
  }
  for (int i = threadIdx.x; i < 18; i += blockDim.x) mc[i] = maxcode[i];
  for (int i = threadIdx.x; i < 17; i += blockDim.x) {
    mc[18 + i] = valptr[i];
    mc[35 + i] = mincode[i];
  }
  uint8_t* vals = out + 2 * kLut + 4 * 52;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) vals[i] = spec[17 + i];
}

// states: per subsequence start, exit (round even), exit (round odd)
__global__ void __launch_bounds__(kTile)
entropy_round(const uint8_t* stream, const int* desc, const int* segs_all,
              const uint8_t* tabs, int64_t* states, int* elems, int* changed,
              int n, int subseq_bits, int round) {
  if (round >= 2 && changed[round - 1] == 0) return;  // converged
  __shared__ Shared sh;
  load_image(sh, desc, tabs, n);
  const int* d = sh.d;
  const int t = (blockIdx.x - d[D_TILE0]) * kTile + threadIdx.x;
  if (t < d[D_NSUB]) {
    const int64_t g = d[D_SUB0] + t;
    const int* segs = segs_all + d[D_SEG0];
    const int s0 = t * subseq_bits;
    const int end = min(s0 + subseq_bits, d[D_NBITS]);
    const int seg = seg_of(d, segs, s0);
    const bool known = segs[seg] * 8 == s0;
    int64_t want, prev = 0;
    if (round == 0) {
      want = pack(s0, 0, 0);
    } else {
      prev = states[g * 3 + 1 + ((round - 1) & 1)];
      want = known ? states[g * 3] : states[(g - 1) * 3 + 1 + ((round - 1) & 1)];
    }
    if (round > 0 && want == states[g * 3]) {
      states[g * 3 + 1 + (round & 1)] = prev;
    } else {
      int pos = static_cast<int>(want >> 16), c = (want >> 8) & 255, zz = want & 255;
      Acc acc{known ? 1 : 0, known ? seg * d[D_SEGBLK] : 0, {0, 0, 0}};
      run_lane<false>(d, sh, tabs + static_cast<size_t>(sh.img) * 8 * kTabBytes,
                      reinterpret_cast<const uint32_t*>(stream + d[D_OFF]),
                      segs, pos, c, zz, end, seg, acc, nullptr);
      const int64_t ex = pack(pos, c, zz);
      states[g * 3] = want;
      states[g * 3 + 1 + (round & 1)] = ex;
      int* e = elems + g * kElem;
      e[0] = acc.anch;
      e[1] = acc.nblk;
      e[2] = acc.dc[0];
      e[3] = acc.dc[1];
      e[4] = acc.dc[2];
      if (round > 0 && ex != prev) sh.changed = 1;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (round == 0 && blockIdx.x == 0) changed[0] = 1;
    if (round > 0 && sh.changed) atomicAdd(changed + round, 1);
  }
}

struct Sum {
  int anch, n, d0, d1, d2;
};

__device__ __forceinline__ Sum combine(const Sum& a, const Sum& b) {
  if (b.anch) return b;
  return Sum{a.anch, a.n + b.n, a.d0 + b.d0, a.d1 + b.d1, a.d2 + b.d2};
}

__device__ __forceinline__ Sum shfl_up(const Sum& v, int off) {
  return Sum{__shfl_up_sync(0xffffffffu, v.anch, off),
             __shfl_up_sync(0xffffffffu, v.n, off),
             __shfl_up_sync(0xffffffffu, v.d0, off),
             __shfl_up_sync(0xffffffffu, v.d1, off),
             __shfl_up_sync(0xffffffffu, v.d2, off)};
}

// One block per image: each subsequence's carry (the inclusive segmented
// sum of the subsequences before it), kScan subsequences at a time.
__global__ void __launch_bounds__(kScan)
entropy_scan(const int* desc, int* elems) {
  const int* d = desc + blockIdx.x * kDesc;
  const int nsub = d[D_NSUB];
  int* base = elems + static_cast<int64_t>(d[D_SUB0]) * kElem;
  __shared__ Sum warp_sum[kScan / 32];
  __shared__ Sum carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = Sum{0, 0, 0, 0, 0};
  __syncthreads();
  for (int at = 0; at < nsub; at += kScan) {
    const int t = at + threadIdx.x;
    Sum v{0, 0, 0, 0, 0};
    if (t < nsub) {
      const int* e = base + static_cast<int64_t>(t) * kElem;
      v = Sum{e[0], e[1], e[2], e[3], e[4]};
    }
    for (int off = 1; off < 32; off <<= 1) {
      const Sum u = shfl_up(v, off);
      if (lane >= off) v = combine(u, v);
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      Sum w = warp_sum[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const Sum u = shfl_up(w, off);
        if (lane >= off) w = combine(u, w);
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v = combine(warp_sum[warp - 1], v);
    v = combine(carry, v);   // inclusive through t
    // exclusive: the inclusive sum through t - 1
    Sum prev = shfl_up(v, 1);
    if (lane == 0) prev = warp > 0 ? combine(carry, warp_sum[warp - 1]) : carry;
    if (t < nsub) {
      int* e = base + static_cast<int64_t>(t) * kElem;
      e[5] = prev.n;
      e[6] = prev.d0;
      e[7] = prev.d1;
      e[8] = prev.d2;
    }
    __syncthreads();
    if (threadIdx.x == kScan - 1) carry = v;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kTile)
entropy_write(const uint8_t* stream, const int* desc, const int* segs_all,
              const uint8_t* tabs, const int64_t* states, const int* elems,
              int* img, int n, int subseq_bits, Out out) {
  __shared__ Shared sh;
  load_image(sh, desc, tabs, n);
  const int* d = sh.d;
  const int t = (blockIdx.x - d[D_TILE0]) * kTile + threadIdx.x;
  if (t < d[D_NSUB]) {
    const int64_t g = d[D_SUB0] + t;
    const int* segs = segs_all + d[D_SEG0];
    const int s0 = t * subseq_bits;
    const int end = min(s0 + subseq_bits, d[D_NBITS]);
    const int seg = seg_of(d, segs, s0);
    const bool known = segs[seg] * 8 == s0;
    const int64_t st = states[g * 3];
    int pos = static_cast<int>(st >> 16), c = (st >> 8) & 255, zz = st & 255;
    const int* e = elems + g * kElem;
    Acc acc = known ? Acc{1, seg * d[D_SEGBLK], {0, 0, 0}}
                    : Acc{0, e[5], {e[6], e[7], e[8]}};
    Out o = out;
    o.bad = false;
    o.seg_ok = 0;
    run_lane<true>(d, sh, tabs + static_cast<size_t>(sh.img) * 8 * kTabBytes,
                   reinterpret_cast<const uint32_t*>(stream + d[D_OFF]), segs,
                   pos, c, zz, end, seg, acc, &o);
    if (o.bad) atomicOr(img + sh.img * 2 + 1, kBadCode);
    if (o.seg_ok) atomicAdd(img + sh.img * 2, o.seg_ok);
  }
}

__global__ void entropy_status(const int* desc, int* img, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (img[i * 2] != desc[i * kDesc + D_NSEGS]) img[i * 2 + 1] |= kBadCount;
}

}  // namespace

extern "C" {

// Kernel B0 over one group, every phase, waiting for the card: the
// tables, round 0, then `rounds_per_check` rounds at a time until one
// changes no exit state (the host reads the per-round counters once per
// batch), the scan, the write and the status. `max_rounds` is at least
// one more than the most subsequences of an image, which the sync never
// needs. The caller zeroes img (n x 2 int32: segments that ended well,
// status) and changed (max_rounds + 1 int32) and allocates the rest
// (ops/jpeg_entropy.py). Each image's status goes to host_status[n];
// host_info gets the sync rounds, the launches and 1 when a round changed
// nothing (0 had none of `max_rounds`: the group's canvases are not
// written).
int ip_entropy_decode(const void* stream, const void* desc, const void* segs,
                      const void* huff, void* tabs, void* states, void* elems,
                      void* img, void* changed, int n, int tiles, int nsub,
                      int subseq_bits, int max_rounds, int rounds_per_check,
                      void* y, void* cb, void* cr, int y_slot, int y_row,
                      int cb_slot, int cb_row, int cr_slot, int cr_row,
                      void* host_status, void* host_info, int device,
                      void* cstream) {
  if (n <= 0 || nsub < 0 || subseq_bits < 64 || subseq_bits % 32
      || max_rounds < 1 || rounds_per_check < 1 || rounds_per_check > 16
      || (nsub > 0 && tiles <= 0) || !host_status || !host_info)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t on = cudaSetDevice(device);
  if (on != cudaSuccess) return static_cast<int>(on);
  const auto s = static_cast<cudaStream_t>(cstream);
  const auto* st = static_cast<const uint8_t*>(stream);
  const auto* d = static_cast<const int*>(desc);
  const auto* sg = static_cast<const int*>(segs);
  auto* tb = static_cast<uint8_t*>(tabs);
  auto* im = static_cast<int*>(img);
  auto* ch = static_cast<int*>(changed);
  int launches = 0, rounds = 0, converged = 1;
  cudaError_t rc;
  entropy_tables<<<n * 8, 256, 0, s>>>(static_cast<const uint8_t*>(huff), tb);
  ++launches;
  if (nsub > 0) {
    entropy_round<<<tiles, kTile, 0, s>>>(st, d, sg, tb, static_cast<int64_t*>(states),
                                          static_cast<int*>(elems), ch, n,
                                          subseq_bits, 0);
    ++launches;
    int got[16];
    for (int r = 1;; r += rounds_per_check) {
      const int hi = r + rounds_per_check < max_rounds + 1 ? r + rounds_per_check
                                                           : max_rounds + 1;
      for (int k = r; k < hi; ++k) {
        entropy_round<<<tiles, kTile, 0, s>>>(st, d, sg, tb, static_cast<int64_t*>(states),
                                              static_cast<int*>(elems), ch, n,
                                              subseq_bits, k);
        ++launches;
      }
      rc = cudaMemcpyAsync(got, ch + r, sizeof(int) * (hi - r),
                           cudaMemcpyDeviceToHost, s);
      if (rc == cudaSuccess) rc = cudaStreamSynchronize(s);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      int k = 0;
      while (k < hi - r && got[k] != 0) ++k;
      if (k < hi - r) {
        rounds = r + k;
        break;
      }
      if (hi > max_rounds) {
        rounds = max_rounds;
        converged = 0;
        break;
      }
    }
    if (!converged) {
      static_cast<int*>(host_info)[0] = rounds;
      static_cast<int*>(host_info)[1] = launches;
      static_cast<int*>(host_info)[2] = 0;
      return static_cast<int>(cudaGetLastError());
    }
    entropy_scan<<<n, kScan, 0, s>>>(d, static_cast<int*>(elems));
    Out out{{static_cast<int16_t*>(y), static_cast<int16_t*>(cb),
             static_cast<int16_t*>(cr)},
            {y_slot, cb_slot, cr_slot},
            {y_row, cb_row, cr_row},
            false,
            0};
    entropy_write<<<tiles, kTile, 0, s>>>(st, d, sg, tb,
                                          static_cast<const int64_t*>(states),
                                          static_cast<const int*>(elems), im, n,
                                          subseq_bits, out);
    launches += 2;
  }
  entropy_status<<<(n + 127) / 128, 128, 0, s>>>(d, im, n);
  ++launches;
  rc = cudaGetLastError();
  if (rc == cudaSuccess)
    rc = cudaMemcpy2DAsync(host_status, sizeof(int), im + 1, 2 * sizeof(int),
                           sizeof(int), n, cudaMemcpyDeviceToHost, s);
  if (rc == cudaSuccess) rc = cudaStreamSynchronize(s);
  static_cast<int*>(host_info)[0] = rounds;
  static_cast<int*>(host_info)[1] = launches;
  static_cast<int*>(host_info)[2] = 1;
  return static_cast<int>(rc);
}

}  // extern "C"
