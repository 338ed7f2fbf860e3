"""Kernel B0, the entropy decode of baseline JPEG uploads on the card
(csrc/jpeg_entropy.cu), its plain version and its wrapper.

B0 replaces no TPU kernel: the reference scans every upload's Huffman
data on the host (native/jpeg_scan.cpp) and uploads coefficient planes.
The port moves that scan to the card, where it was the host's largest
cost per upload and the card sat idle. It writes natural-order
coefficients straight into a group's zeroed canvases (``yc``, ``cbc``,
``crc``), slot by slot, in the spatial block layout kernel B1 reads: what
``hostcodec.scan_jpeg_coefficients`` gives, coefficient for coefficient.

The design is Weißenberger & Schmidt's ("Accelerating JPEG Decompression
on GPUs", 2021): decoding that synchronises itself over fixed-size
subsequences of the scan, so that streams without restart markers (an
OpenCV encode has none) decode in parallel. Per group, in one set of
launches:

1. tables: each image's Huffman lookup tables from its DHT specs;
2. init: one thread per ``subseq_bits`` bits of each image's destuffed
   stream decodes from the subsequence's first bit with a guessed state
   (block 0 of the MCU, coefficient 0) until the next code would start in
   the following subsequence, and keeps its exit state (bit, block of
   the MCU, zigzag index);
3. sync rounds: each thread decodes again from its predecessor's exit
   state wherever that differs from where it started, until no exit state
   changes. A subsequence that starts a restart segment starts in a known
   state. The sync always converges: round r leaves subsequence r's start
   right at the latest, so it takes at most as many rounds as an image
   has subsequences, and one more that changes nothing. Rounds run
   ``ROUNDS_PER_CHECK`` at a time; the host reads one device counter per
   batch, inside the one C call that runs every phase (so the
   interpreter is not entered between launches);
4. scan: per image, a segmented prefix sum over the subsequences' block
   counts and DC differences gives each one its first block's index and
   the DC predictions it starts from (both restart at a segment start);
5. write: each thread decodes its subsequence once more and writes the
   non-zero coefficients of the blocks that belong to the frame, DC as
   the prediction plus its difference;
6. status: per image, 0 when every code was valid, every block
   position agreed with its MCU slot and each restart segment's last
   block ended within the segment's final byte; else a bitmask
   (``BAD_CODE``, ``BAD_COUNT``): faults in the data. An upload with a
   status goes back to the host scan.

What bounds B0 is not bytes but the serial chain inside each
subsequence: one code's length gives the next code's start. Its least
bytes are the stream (some 3.9 MB per 12 MP upload) read once and the
32-byte sectors holding a non-zero coefficient written once; the passes
read the stream about three times.

The plain version below runs the same phases, lane for lane, with NumPy:
the wrapper takes it for tensors on the CPU and launches the kernel for
tensors on a card, or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from imageprocessor_tpu_torch import kernels
from imageprocessor_tpu_torch.runtime import hostcodec

# bits of stream per subsequence (one thread each)
SUBSEQ_BITS = 2048
# threads per block of the decode launches: a block's threads share one
# image, whose tables it holds in shared memory
TILE = 256
ROUNDS_PER_CHECK = 4
# lookahead bits of the DC and AC lookup tables
DC_BITS, AC_BITS = 9, 11
# a lookup entry of a code of at most DC_BITS / AC_BITS bits whose size
# category the baseline scan forbids (0: no such code, take the slow path)
LUT_ERR = 0xFFFF
# status bits
BAD_CODE, BAD_COUNT = 1, 2
# a table's spec: BITS[0..16] (index 0 unused) then HUFFVAL[256]
SPEC = 17 + 256
# the largest upload B0 takes: a group of the engine's largest batch (64)
# then addresses its stream buffer, bits included, with int32 offsets
MAX_STREAM_BYTES = 1 << 25

# image descriptor: one row of int32 per image
(D_OFF, D_NBITS, D_SEG0, D_NSEGS, D_SEGBLK, D_TOTBLK, D_MCUSX, D_BPM,
 D_SUB0, D_NSUB, D_SLOT, D_TILE0, D_DCID, D_ACID, D_NCOMP) = range(15)
D_BLK = 16     # 10 entries: block r of the MCU -> comp << 8 | v << 4 | h
D_HV = 26      # 3 entries: component c -> H << 4 | V
DESC = 32

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    dtype=np.int64)

# Launches of B0's kernels in this process, every card's (reset by
# callers that count a run; kernels.count_lock guards it).
launches = 0


@dataclass
class Stream:
    """One upload's entropy-coded data, staged for B0 on the host."""

    data: np.ndarray        # uint8: destuffed bytes, then zeros (x16 long)
    nbytes: int             # the destuffed bytes
    segs: np.ndarray        # int64: each restart segment's first byte
    restart_interval: int   # MCUs per segment, 0 for one segment
    size: tuple[int, int]   # (w, h)
    sampling: list          # per component (h, v)
    dc: tuple               # per component: its DC table's id
    ac: tuple               # per component: its AC table's id
    huff: np.ndarray        # (8, SPEC) uint8: DC tables 0-3, AC tables 0-3
    qtabs: np.ndarray       # (n, 8, 8) float32, natural order

    def geometry(self):
        """(mcus_x, mcus_y, blocks per MCU, blocks of the frame)."""
        w, h = self.size
        n = len(self.sampling)
        hmax = max(s[0] for s in self.sampling) if n == 3 else 1
        vmax = max(s[1] for s in self.sampling) if n == 3 else 1
        mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
        bpm = sum(hh * vv for hh, vv in self.sampling) if n == 3 else 1
        return mx, my, bpm, mx * my * bpm


def stage(data: bytes, out: np.ndarray | None = None,
          layout=None) -> Stream:
    """``data``'s scan staged for B0: its destuffed entropy bytes in
    ``out`` (uint8, at least ``len(data) + 32`` long; a new array when
    None) and what B0 needs of its headers. ``layout`` is
    ``hostcodec.scan_jpeg_layout(data)`` where the caller has it. Raises
    HostCodecError for a
    stream B0 does not decode: one the host scanner refuses, progressive,
    a component whose Huffman table is missing, no EOI after the scan
    (the test of codecs.jpeg_stream_complete), restart markers that do
    not match the restart interval, or more than MAX_STREAM_BYTES."""
    if len(data) > MAX_STREAM_BYTES - 64:
        raise hostcodec.HostCodecError(f"stream of {len(data)} bytes")
    tables, ri, progressive = hostcodec.entropy_tables(data)
    if progressive:
        raise hostcodec.HostCodecError("progressive stream")
    shapes, size, sampling = layout or hostcodec.scan_jpeg_layout(data)
    n = len(shapes)
    if n not in (1, 3):
        raise hostcodec.HostCodecError(f"unsupported component count {n}")
    dc = tuple(int(v) for v in tables["comp_dc"][:n])
    ac = tuple(int(v) for v in tables["comp_ac"][:n])
    present = tables["dht_present"]
    if not all(present[t] for t in dc) or not all(present[4 + t] for t in ac):
        raise hostcodec.HostCodecError("a component's Huffman table is missing")
    if out is None:
        out = np.empty(len(data) + 32, dtype=np.uint8)
    s = Stream(data=out, nbytes=0, segs=np.zeros(1, np.int64),
               restart_interval=ri, size=size, sampling=sampling, dc=dc,
               ac=ac, huff=np.concatenate([tables["dht_bits"],
                                           tables["dht_vals"]], axis=1),
               qtabs=np.stack([tables["qt_slots"][tables["comp_tq"][c]]
                               for c in range(n)]).reshape(n, 8, 8)
               .astype(np.float32))
    mx, my, _bpm, _total = s.geometry()
    nseg = -(-mx * my // ri) if ri > 0 else 1
    nbytes, segs, complete = hostcodec.copy_entropy(data, ri, nseg, out)
    if not complete:
        raise hostcodec.HostCodecError("no EOI after the scan")
    if len(segs) != nseg:
        raise hostcodec.HostCodecError(
            f"{len(segs)} restart segments, the frame has {nseg}")
    s.nbytes, s.segs = nbytes, segs
    s.data = out[:padded(nbytes)]
    return s


def padded(nbytes: int) -> int:
    """Bytes a stream of ``nbytes`` takes with its zero tail."""
    return (nbytes + 16 + 15) // 16 * 16


@dataclass
class Layout:
    """A group's streams laid out for one set of B0 launches."""

    offsets: list           # each stream's first byte in the group buffer
    nbytes: int             # the group buffer's length
    desc: np.ndarray        # (n, DESC) int32
    segs: np.ndarray        # int32: every image's segment starts, in bytes
    huff: np.ndarray        # (n, 8, SPEC) uint8
    tiles: int              # blocks of TILE threads of the decode launches
    max_nsub: int           # the most subsequences of one image


def layout(streams: list[Stream], slots: list[int],
           subseq_bits: int = SUBSEQ_BITS) -> Layout:
    """Where each stream goes in the group's buffer, and its descriptor:
    ``slots[i]`` is its row of the canvases."""
    n = len(streams)
    desc = np.zeros((n, DESC), dtype=np.int32)
    offsets, segs = [], []
    at = sub = tile = 0
    for i, s in enumerate(streams):
        mx, _my, bpm, total = s.geometry()
        nsub = -(-s.nbytes * 8 // subseq_bits)
        d = desc[i]
        d[D_OFF], d[D_NBITS] = at, s.nbytes * 8
        d[D_SEG0], d[D_NSEGS] = len(segs), len(s.segs)
        d[D_SEGBLK] = s.restart_interval * bpm if s.restart_interval else total
        d[D_TOTBLK], d[D_MCUSX], d[D_BPM] = total, mx, bpm
        d[D_SUB0], d[D_NSUB], d[D_SLOT], d[D_TILE0] = sub, nsub, slots[i], tile
        d[D_DCID] = sum(t << (4 * c) for c, t in enumerate(s.dc))
        d[D_ACID] = sum(t << (4 * c) for c, t in enumerate(s.ac))
        d[D_NCOMP] = len(s.sampling)
        samp = s.sampling if len(s.sampling) == 3 else [(1, 1)]
        r = 0
        for c, (hh, vv) in enumerate(samp):
            d[D_HV + c] = hh << 4 | vv
            for v in range(vv):
                for h in range(hh):
                    d[D_BLK + r] = c << 8 | v << 4 | h
                    r += 1
        offsets.append(at)
        segs.extend(s.segs.tolist())
        at += len(s.data)
        sub += nsub
        tile += -(-nsub // TILE)
    huff = (np.stack([s.huff for s in streams]) if n
            else np.zeros((0, 8, SPEC), np.uint8))
    return Layout(offsets=offsets, nbytes=at, desc=desc,
                  segs=np.asarray(segs, dtype=np.int32), huff=huff,
                  tiles=tile, max_nsub=int(desc[:, D_NSUB].max(initial=0)))


@dataclass
class Operands:
    """B0's operands of one group on its device (``upload``)."""

    stream: torch.Tensor    # uint8: each staged stream at its offset
    desc: torch.Tensor      # (n, DESC) int32
    segs: torch.Tensor      # int32
    huff: torch.Tensor      # (n, 8, SPEC) uint8
    tiles: int
    max_nsub: int
    subseq_bits: int

    @property
    def nbytes(self) -> int:
        """Bytes copied to the device."""
        return sum(t.nbytes for t in (self.stream, self.desc, self.segs, self.huff))


def upload(streams: list[Stream], slots: list[int], device,
           subseq_bits: int = SUBSEQ_BITS) -> Operands:
    """``streams`` laid out as one group (``layout``) and copied to
    ``device``, each stream straight from its array into the group's
    buffer without blocking: from a page-locked slab that is a DMA the
    host does not wait for."""
    lay = layout(streams, slots, subseq_bits)
    buf = torch.empty(lay.nbytes, dtype=torch.uint8, device=device)
    for s, off in zip(streams, lay.offsets):
        buf[off:off + s.data.size].copy_(torch.from_numpy(s.data),
                                         non_blocking=True)
    desc, segs, huff = (torch.from_numpy(a).to(device)
                        for a in (lay.desc, lay.segs, lay.huff))
    return Operands(stream=buf, desc=desc, segs=segs, huff=huff,
                    tiles=lay.tiles, max_nsub=lay.max_nsub,
                    subseq_bits=subseq_bits)


def decode(ops: Operands, canvases) -> tuple[np.ndarray, int]:
    """B0 over a group: ``ops`` from ``upload``; ``canvases`` the group's
    three (B, H, W) int16 coefficient canvases on its device, zero where
    B0 writes (a grayscale group reads only the first). -> (each image's
    status as int32, the sync rounds run). Waits for the card."""
    yc = canvases[0]
    dev = yc.device
    if any(t.device != dev for t in (ops.stream, ops.desc, ops.segs, ops.huff,
                                     *canvases)):
        raise ValueError("all operands must share a device")
    if ops.stream.dtype != torch.uint8 or ops.desc.dtype != torch.int32:
        raise ValueError("stream must be uint8 and desc int32")
    if any(c.dtype != torch.int16 or c.dim() != 3 or not c.is_contiguous()
           for c in canvases):
        raise ValueError("canvases must be contiguous (B, H, W) int16")
    if ops.subseq_bits < 64 or ops.subseq_bits % 32:
        raise ValueError("subseq_bits must be a multiple of 32, at least 64")
    if dev.type == "cpu":
        return decode_plain(ops.stream.numpy(), ops.desc.numpy(),
                            ops.segs.numpy(), ops.huff.numpy(),
                            [c.numpy() for c in canvases], ops.subseq_bits)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _decode_card(ops, canvases)


def max_rounds(max_nsub: int) -> int:
    """The sync rounds B0 may run for images of at most ``max_nsub``
    subsequences: one more than it ever needs, whole batches of
    ROUNDS_PER_CHECK."""
    return -(-(max_nsub + 1) // ROUNDS_PER_CHECK) * ROUNDS_PER_CHECK


# ------------------------------------------------------------ card path


def _decode_card(ops: Operands, canvases):
    global launches
    n = ops.desc.shape[0]
    dev = ops.stream.device
    if ops.stream.data_ptr() % 16 or ops.stream.numel() % 16:
        raise ValueError("stream must be 16-byte aligned and x16 long")
    status = np.zeros(n, dtype=np.int32)
    if n == 0:
        return status, 0
    nsub = ops.tiles * TILE   # at least the group's subsequences
    cap = max_rounds(ops.max_nsub)
    canvases = list(canvases) + [canvases[0]] * (3 - len(canvases))
    # per image and table: the lookup table, then the canonical arrays;
    # per subsequence: its start and two exit states, its block-count
    # element and its carry; per image: the segments that ended well and
    # its status; per round: the threads whose exit changed
    tabs = torch.empty((n, 8, TABLE_BYTES), dtype=torch.uint8, device=dev)
    states = torch.empty((max(nsub, 1), 3), dtype=torch.int64, device=dev)
    elems = torch.empty((max(nsub, 1), 9), dtype=torch.int32, device=dev)
    img = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    changed = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    info = np.zeros(3, dtype=np.int32)
    kernels.launch(
        "ip_entropy_decode", dev, *(t.data_ptr() for t in (
            ops.stream, ops.desc, ops.segs, ops.huff, tabs, states, elems,
            img, changed)),
        n, ops.tiles, nsub, ops.subseq_bits, cap, ROUNDS_PER_CHECK,
        *(c.data_ptr() for c in canvases),
        *(v for c in canvases for v in (c.shape[1] * c.shape[2], c.shape[2])),
        status.ctypes.data, info.ctypes.data)
    with kernels.count_lock:
        launches += int(info[1])
    if not info[2]:
        raise kernels.KernelError(
            f"B0's sync changed exit states in each of its {cap} rounds")
    return status, int(info[0])


# bytes of one table in the card's table buffer: the AC-sized lookup
# table (uint16), maxcode[18], valptr[17], mincode[17] (int32), values
TABLE_BYTES = 2 * (1 << AC_BITS) + 4 * (18 + 17 + 17) + 256


# ----------------------------------------------------------- plain version


def huff_tables(spec: np.ndarray):
    """One image's (8, SPEC) DHT specs -> (lut (8, 2**AC_BITS) uint16,
    maxcode (8, 18), valptr (8, 17), mincode (8, 17) int64, vals (8, 256)
    int64): the canonical decode tables of ITU T.81 F.2.2.3 and, per
    table, a lookup over its first DC_BITS (DC) or AC_BITS (AC) bits."""
    lut = np.zeros((8, 1 << AC_BITS), dtype=np.uint16)
    maxcode = np.full((8, 18), -1, dtype=np.int64)
    valptr = np.zeros((8, 17), dtype=np.int64)
    mincode = np.zeros((8, 17), dtype=np.int64)
    vals = spec[:, 17:].astype(np.int64)
    for t in range(8):
        bits = spec[t, :17].astype(np.int64)
        code = k = 0
        for ln in range(1, 17):
            valptr[t, ln], mincode[t, ln] = k, code
            code += bits[ln]
            k += bits[ln]
            maxcode[t, ln] = code - 1
            code <<= 1
        nb = DC_BITS if t < 4 else AC_BITS
        w = np.arange(1 << nb, dtype=np.int64)
        done = np.zeros(len(w), dtype=bool)
        for ln in range(1, nb + 1):
            cd = w >> (nb - ln)
            m = ~done & (cd <= maxcode[t, ln])
            sym = vals[t, np.clip(valptr[t, ln] + cd[m] - mincode[t, ln], 0, 255)]
            run = np.zeros_like(sym) if t < 4 else sym >> 4
            s = sym if t < 4 else sym & 15
            e = np.where(s > (11 if t < 4 else 10), LUT_ERR,
                         ln | run << 5 | s << 9)
            lut[t, :len(w)][m] = e
            done |= m
    return lut, maxcode, valptr, mincode, vals


class _Image:
    """One image of a group, as the plain version's lanes read it."""

    def __init__(self, stream, d, segs, spec, subseq_bits):
        off, self.nbits = int(d[D_OFF]), int(d[D_NBITS])
        nbytes = self.nbits // 8
        buf = stream[off:off + nbytes + 8].astype(np.uint64)
        # 40 bits from every byte on: a code's 32-bit window at any bit
        self.w40 = sum(buf[k:k + nbytes] << np.uint64(32 - 8 * k)
                       for k in range(5))
        nsegs = int(d[D_NSEGS])
        self.seg_bits = segs[d[D_SEG0]:d[D_SEG0] + nsegs].astype(np.int64) * 8
        self.seg_end = np.append(self.seg_bits[1:], self.nbits)
        self.nsegs = nsegs
        self.segblk, self.total = int(d[D_SEGBLK]), int(d[D_TOTBLK])
        self.mcusx, self.bpm = int(d[D_MCUSX]), int(d[D_BPM])
        self.slot = int(d[D_SLOT])
        blk = d[D_BLK:D_BLK + self.bpm].astype(np.int64)
        self.blk_comp, self.blk_v, self.blk_h = blk >> 8, (blk >> 4) & 15, blk & 15
        hv = d[D_HV:D_HV + 3].astype(np.int64)
        self.comp_h, self.comp_v = hv >> 4, hv & 15
        self.dcid = np.array([(int(d[D_DCID]) >> (4 * c)) & 15 for c in range(3)])
        self.acid = np.array([(int(d[D_ACID]) >> (4 * c)) & 15 for c in range(3)])
        (self.lut, self.maxcode, self.valptr, self.mincode,
         self.vals) = huff_tables(spec)
        self.nsub = int(d[D_NSUB])
        self.starts = np.arange(self.nsub, dtype=np.int64) * subseq_bits
        self.ends = np.minimum(self.starts + subseq_bits, self.nbits)
        self.first_seg = np.searchsorted(self.seg_bits, self.starts,
                                         side="right") - 1
        self.known = self.seg_bits[self.first_seg] == self.starts

    def symbols(self, pos, c, zz):
        """Decode the code at each lane's ``pos``: (is_dc, comp, length of
        code and value bits, run, size, extended value, error)."""
        bits = (self.w40[pos >> 3] >> (8 - (pos & 7)).astype(np.uint64)
                ) & np.uint64(0xFFFFFFFF)
        bits = bits.astype(np.int64)
        comp = self.blk_comp[c]
        isdc = zz == 0
        tab = np.where(isdc, self.dcid[comp], 4 + self.acid[comp])
        nb = np.where(isdc, DC_BITS, AC_BITS)
        e = self.lut[tab, bits >> (32 - nb)].astype(np.int64)
        err = e == LUT_ERR
        ln, run, s = e & 31, (e >> 5) & 15, (e >> 9) & 15
        slow = np.flatnonzero(e == 0)
        if len(slow):
            b, t, n0 = bits[slow], tab[slow], nb[slow]
            found = np.zeros(len(slow), dtype=bool)
            sl, sr, ss = np.zeros_like(b), np.zeros_like(b), np.zeros_like(b)
            for k in range(DC_BITS + 1, 17):
                cd = b >> (32 - k)
                m = ~found & (k > n0) & (cd <= self.maxcode[t, k])
                if m.any():
                    sym = self.vals[t[m], np.clip(
                        self.valptr[t[m], k] + cd[m] - self.mincode[t[m], k], 0, 255)]
                    dcm = t[m] < 4
                    sl[m] = k
                    sr[m] = np.where(dcm, 0, sym >> 4)
                    ss[m] = np.where(dcm, sym, sym & 15)
                    found |= m
            bad = ~found | (ss > np.where(t < 4, 11, 10))
            ln[slow], run[slow], s[slow] = sl, sr, ss
            err[slow] = bad
        v = np.where(s > 0, (bits >> np.maximum(32 - ln - s, 0))
                     & ((1 << s) - 1), 0)
        ext = np.where((s > 0) & (v < (1 << np.maximum(s - 1, 0))),
                       v - (1 << s) + 1, v)
        return isdc, comp, ln, run, s, ext, err

    def lanes(self, lane, pos, c, zz, write=None):
        """Decode each lane (a subsequence) from its state to its end.
        -> exit (pos, c, zz) and the block-count elements (anchored,
        blocks, DC sums per component); with ``write`` = (canvases, cur,
        pred, flags) the frame's coefficients are written instead."""
        n = len(lane)
        out = np.zeros((n, 3), dtype=np.int64)
        elem = np.zeros((n, 5), dtype=np.int64)
        pos, c, zz = pos.copy(), c.copy(), zz.copy()
        seg = self.first_seg[lane].copy()
        end = self.ends[lane]
        anch = self.known[lane].astype(np.int64)
        nblk = np.where(anch == 1, seg * self.segblk, 0)
        dsum = np.zeros((n, 3), dtype=np.int64)
        if write is not None:
            planes, cur, pred, flags = write
            known = anch == 1
            nblk = np.where(known, nblk, cur)
            dsum = np.where(known[:, None], 0, pred)
        idx = np.arange(n)
        while len(idx):
            segend = self.seg_end[seg]
            past = pos >= segend
            jump = past & (seg + 1 < self.nsegs) & (segend < end)
            fin = ~jump & ((pos >= end) | past)
            if jump.any():
                pos[jump] = segend[jump]
                seg[jump] += 1
                c[jump] = zz[jump] = 0
                anch[jump] = 1
                nblk[jump] = seg[jump] * self.segblk
                dsum[jump] = 0
            if fin.any():
                f = idx[fin]
                out[f] = np.stack([pos[fin], c[fin], zz[fin]], axis=1)
                elem[f, 0], elem[f, 1], elem[f, 2:] = anch[fin], nblk[fin], dsum[fin]
                keep = ~fin
                idx, pos, c, zz, seg, end, anch, nblk, dsum = (
                    a[keep] for a in (idx, pos, c, zz, seg, end, anch, nblk, dsum))
                jump = jump[keep]
            dec = np.flatnonzero(~jump)
            if not len(dec):
                continue
            p, cc, z = pos[dec], c[dec], zz[dec]
            isdc, comp, ln, run, s, ext, err = self.symbols(p, cc, z)
            k = z + run
            coef = ~isdc & ~err & (s > 0)
            err = err | (coef & (k > 63))
            coef &= ~err
            zrl = ~isdc & ~err & (s == 0) & (run == 15)
            step = np.where(err, 1, ln + np.where(coef | isdc, s, 0))
            newz = np.where(isdc & ~err, 1, np.where(
                coef, k + 1, np.where(zrl, z + 16, 0)))
            ends = (newz == 0) | (newz >= 64)
            dcok = isdc & ~err
            if write is not None:
                # the block a code belongs to: the one a DC starts, else
                # the one open; written only while it lies in the frame's
                # blocks of the lane's restart segment
                b = np.where(isdc, nblk[dec], nblk[dec] - 1)
                sg = seg[dec]
                lim = np.minimum((sg + 1) * self.segblk, self.total)
                valid = (b >= sg * self.segblk) & (b < lim)
                r = np.where(b >= 0, b % self.bpm, 0)
                if (valid & (err | (isdc & (r != cc)))).any():
                    flags[0] = 1
                wr = valid & (dcok | coef)
                if wr.any():
                    val = np.where(isdc, dsum[dec, comp] + ext, ext)
                    self._write(planes, b[wr], np.where(isdc, 0, k)[wr], val[wr])
                last = valid & ~err & ends & ~isdc & (b == lim - 1)
                if last.any():
                    e2 = self.seg_end[sg[last]]
                    at = p[last] + step[last]
                    flags[1] += int(((at <= e2) & (at > e2 - 8)).sum())
            if dcok.any():
                dsum[dec[dcok], comp[dcok]] += ext[dcok]
            nblk[dec[isdc]] += 1
            pos[dec] = p + step
            zz[dec] = np.where(ends, 0, newz)
            c[dec] = np.where(ends, (cc + 1) % self.bpm, cc)
        return out, elem

    def _write(self, planes, b, k, val):
        m, r = b // self.bpm, b % self.bpm
        bc = self.blk_comp[r]
        by = (m // self.mcusx) * self.comp_v[bc] + self.blk_v[r]
        bx = (m % self.mcusx) * self.comp_h[bc] + self.blk_h[r]
        z = ZIGZAG[k]
        for ci in np.unique(bc):
            sel = bc == ci
            planes[ci][self.slot][by[sel] * 8 + z[sel] // 8,
                                  bx[sel] * 8 + z[sel] % 8] = (
                val[sel].astype(np.int16))


def decode_plain(stream, desc, segs, huff, planes,
                 subseq_bits: int = SUBSEQ_BITS) -> tuple[np.ndarray, int]:
    """B0's phases with NumPy, one image at a time and its subsequences
    side by side: the plain version of the kernel (see the module's
    docstring). ``planes`` are the canvases as numpy arrays, written in
    place. -> (status per image, sync rounds)."""
    n = desc.shape[0]
    status = np.zeros(n, dtype=np.int32)
    group_rounds = 0
    for i in range(n):
        img = _Image(stream, desc[i], segs, huff[i], subseq_bits)
        if img.nsub == 0:
            status[i] = BAD_COUNT
            continue
        lane = np.arange(img.nsub)
        zero = np.zeros(img.nsub, dtype=np.int64)
        start = np.stack([img.starts, zero, zero], axis=1)
        exit_, elem = img.lanes(lane, img.starts, zero, zero)
        rounds, converged = 0, False
        for r in range(1, max_rounds(img.nsub) + 1):
            want = np.concatenate([start[:1], exit_[:-1]])
            want[img.known] = start[img.known]
            redo = np.flatnonzero((want != start).any(axis=1))
            new_exit = exit_.copy()
            if len(redo):
                new_exit[redo], elem[redo] = img.lanes(
                    redo, want[redo, 0], want[redo, 1], want[redo, 2])
                start[redo] = want[redo]
            rounds = r
            if not (new_exit != exit_).any():
                converged = True
                break
            exit_ = new_exit
        if not converged:
            raise kernels.KernelError(
                f"B0's sync changed exit states in each of its {rounds} rounds")
        group_rounds = max(group_rounds, rounds)
        # segmented scan: each subsequence's first block and DC predictions
        anch = elem[:, 0] == 1
        t = np.arange(img.nsub)
        a = np.maximum.accumulate(np.where(anch, t, 0))
        vals = elem[:, 1:].copy()
        cs = np.cumsum(np.where(anch[:, None], 0, vals), axis=0)
        incl = vals[a] + cs - cs[a]
        carry = np.concatenate([np.zeros((1, 4), np.int64), incl[:-1]])
        flags = np.zeros(2, dtype=np.int64)
        img.lanes(lane, start[:, 0], start[:, 1], start[:, 2],
                  write=(planes, carry[:, 0], carry[:, 1:], flags))
        st = BAD_CODE if flags[0] else 0
        if flags[1] != img.nsegs:
            st |= BAD_COUNT
        status[i] = st
    return status, group_rounds
