"""Kernel B0's plain version (ops/jpeg_entropy.py) against the host scan.

* over sizes 8x8 to 640x480, samplings 4:4:4, 4:2:2, 4:2:0 and grayscale,
  qualities 50, 85 and 95 and restart intervals 0, 1 and 7, the plain
  version writes ``hostcodec.scan_jpeg_coefficients``'s planes
  coefficient for coefficient, and nothing outside them;
* with subsequences so short that the sync takes several rounds it still
  does, and a group of mixed images in one set of canvases lands each in
  its own slot;
* what it cannot decode it flags: a cut entropy segment, an invalid code,
  a shortened restart segment the host scanner refuses; its sync always
  converges, with subsequences however short, and it raises rather than
  flag an upload were it ever not to;
* the host side: the destuffed copy of csrc/entropy_copy.cpp against a
  plain Python one, its EOI test against codecs.jpeg_stream_complete,
  and the streams ``stage`` refuses (progressive, restart markers the
  interval does not match, no EOI, over its size cap).
"""

import numpy as np
import pytest

from imageprocessor_tpu_torch.ops import jpeg_entropy as je
from imageprocessor_tpu_torch.runtime import hostcodec
from jpeg_streams import (
    SAMPLING,
    SIZES,
    assert_scans_equal,
    bad_code,
    cut,
    decode,
    entropy_span,
    jpeg,
)


@pytest.mark.parametrize("restart", [0, 1, 7])
@pytest.mark.parametrize("quality", [50, 85, 95])
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_matches_the_host_scan(size, sampling, quality, restart):
    blob = jpeg(*size, sampling, quality, restart, seed=size[0] * size[1] + quality)
    canvases, status, _rounds = decode([blob])
    assert status.tolist() == [0]
    assert_scans_equal(canvases, [blob])


@pytest.mark.parametrize("restart", [0, 7])
@pytest.mark.parametrize("sampling", ["444", "420", "gray"])
def test_short_subsequences_sync_over_several_rounds(sampling, restart):
    blob = jpeg(255, 129, sampling, 85, restart, seed=5)
    canvases, status, rounds = decode([blob], subseq_bits=128)
    assert rounds >= 3
    assert status.tolist() == [0]
    assert_scans_equal(canvases, [blob])


def test_a_group_lands_each_stream_in_its_slot():
    blobs = [jpeg(64, 96, "420", 90, 0, seed=1), jpeg(40, 30, "420", 50, 3, seed=2),
             jpeg(17, 23, "420", 95, 1, seed=3), jpeg(8, 8, "420", 85, 0, seed=4)]
    canvases, status, rounds = decode(blobs, subseq_bits=256)
    assert status.tolist() == [0, 0, 0, 0] and rounds >= 1
    assert_scans_equal(canvases, blobs)


def test_a_cut_segment_is_flagged():
    blob = cut(jpeg(255, 129, "420", 85, 0, seed=7))
    _c, status, _r = decode([blob])
    assert status[0] & je.BAD_COUNT


@pytest.mark.parametrize("offset", [40, 100, 300, 600])
def test_a_shortened_restart_segment_decodes_as_the_host_scan_or_is_flagged(offset):
    """Six bytes out of a segment: the segment count still matches the
    interval. Where the host scanner refuses the stream B0 flags it; where
    B0 does not flag it (the decode found its way back in time), its
    planes are the host scan's."""
    blob = jpeg(255, 129, "420", 85, 40, seed=7)
    start, _eoi = entropy_span(blob)
    mid = start + offset
    while 0xFF in blob[mid - 1:mid + 7]:
        mid += 1
    blob = blob[:mid] + blob[mid + 6:]
    canvases, status, _r = decode([blob])
    try:
        hostcodec.scan_jpeg_coefficients(blob)
    except hostcodec.HostCodecError:
        assert status[0] != 0
        return
    if status[0] == 0:
        assert_scans_equal(canvases, [blob])


def test_a_cut_restart_stream_is_refused():
    with pytest.raises(hostcodec.HostCodecError, match="restart segments"):
        je.stage(cut(jpeg(255, 129, "420", 85, 5, seed=7)))


def test_an_invalid_code_is_flagged():
    blob = bad_code(jpeg(255, 129, "420", 85, 0, seed=8))
    with pytest.raises(hostcodec.HostCodecError):
        hostcodec.scan_jpeg_coefficients(blob)
    _c, status, _r = decode([blob, jpeg(64, 64, "420", 85, 0, seed=9)])
    assert status[0] & je.BAD_CODE and status[1] == 0


def test_the_sync_converges_however_short_the_subsequences():
    """Subsequences of 64 bits, hundreds to an image: the sync runs until
    a round changes nothing, never into a cap of its own, and the planes
    are the host scan's."""
    blob = jpeg(255, 129, "420", 95, 0, seed=10)
    canvases, status, rounds = decode([blob], subseq_bits=64)
    nsub = je.stage(blob).nbytes * 8 // 64
    assert status.tolist() == [0] and 3 <= rounds <= nsub
    assert_scans_equal(canvases, [blob])


def test_a_sync_that_does_not_converge_raises(monkeypatch):
    """Were the sync ever to change exit states in every round it may
    run, the wrapper raises: it does not hand the upload to the host."""
    monkeypatch.setattr(je, "max_rounds", lambda _nsub: 1)
    with pytest.raises(je.kernels.KernelError, match="sync"):
        decode([jpeg(255, 129, "420", 95, 0, seed=10)], subseq_bits=64)


def destuff(blob, restart):
    """A plain copy of the destuffing: (bytes, segment starts)."""
    start, _eoi = entropy_span(blob)
    out, segs, i = bytearray(), [0], start
    while i < len(blob):
        b = blob[i]
        nxt = blob[i + 1] if i + 1 < len(blob) else 0xD9
        if b != 0xFF:
            out.append(b)
            i += 1
        elif nxt == 0:
            out.append(0xFF)
            i += 2
        elif restart and 0xD0 <= nxt <= 0xD7:
            segs.append(len(out))
            i += 2
        else:
            break
    return bytes(out), segs


@pytest.mark.parametrize("restart", [0, 1, 4])
def test_the_copy_destuffs_and_finds_each_segment(restart):
    blob = jpeg(128, 96, "444", 95, restart, seed=11)
    want, segs = destuff(blob, restart)
    out = np.full(len(blob) + 32, 0xAA, dtype=np.uint8)
    n, got_segs, complete = hostcodec.copy_entropy(blob, restart, 10**6, out)
    assert out[:n].tobytes() == want and got_segs.tolist() == segs and complete
    assert not out[n:je.padded(n)].any() and je.padded(n) % 16 == 0
    if restart:   # at most max_segs segments: the copy stops at the next RST
        n2, s2, _complete = hostcodec.copy_entropy(blob, restart, 2, out)
        assert s2.tolist() == segs[:2] and n2 == segs[2]


@pytest.mark.parametrize("cut_at", [0.5, 0.999, 1.0])
def test_the_copy_finds_the_eoi_as_jpeg_stream_complete_does(cut_at):
    """The copy's EOI test agrees with codecs.jpeg_stream_complete: on a
    stream cut inside its entropy data, one cut at the EOI's FF, and one
    whole, each with and without a restart interval and a trailing
    thumbnail-like FF D9 inside an APP segment."""
    from imageprocessor_tpu_torch.runtime.codecs import jpeg_stream_complete

    for restart in (0, 2):
        blob = jpeg(64, 48, "420", 85, restart, seed=17)
        blob = blob[:2] + b"\xff\xe1\x00\x06\xff\xd9\x00\x00" + blob[2:]
        data = blob[:int(len(blob) * cut_at)] if cut_at < 1 else blob
        if cut_at == 0.999:
            data = blob[:-1]
        out = np.zeros(len(data) + 32, dtype=np.uint8)
        _n, _s, complete = hostcodec.copy_entropy(data, restart, 10**6, out)
        assert complete == jpeg_stream_complete(data)


def test_stage_refuses_what_b0_does_not_decode():
    with pytest.raises(hostcodec.HostCodecError, match="progressive"):
        je.stage(jpeg(64, 64, "420", 85, 0, progressive=True))
    blob = jpeg(64, 64, "420", 85, 1, seed=12)
    # restart markers taken out: fewer segments than the interval asks
    start, eoi = entropy_span(blob)
    body = bytearray(blob[start:eoi])
    stripped = bytearray()
    i = 0
    while i < len(body):
        if body[i] == 0xFF and i + 1 < len(body) and 0xD0 <= body[i + 1] <= 0xD7:
            i += 2
            continue
        stripped.append(body[i])
        i += 1
    with pytest.raises(hostcodec.HostCodecError, match="restart segments"):
        je.stage(blob[:start] + bytes(stripped) + blob[eoi:])
    with pytest.raises(hostcodec.HostCodecError, match="no EOI"):
        je.stage(blob[:-2])


def test_stage_refuses_a_stream_over_its_cap(monkeypatch):
    blob = jpeg(64, 64, "420", 85, 0, seed=14)
    monkeypatch.setattr(je, "MAX_STREAM_BYTES", len(blob) + 63)
    with pytest.raises(hostcodec.HostCodecError, match="bytes"):
        je.stage(blob)
    monkeypatch.setattr(je, "MAX_STREAM_BYTES", len(blob) + 64)
    assert je.stage(blob).nbytes > 0


def test_huffman_lookups_agree_with_the_canonical_decode():
    """Every lookup entry is the code the canonical tables decode from its
    window; a size category the baseline scan forbids reads LUT_ERR."""
    s = je.stage(jpeg(64, 64, "420", 85, 0, seed=13))
    lut, maxcode, valptr, mincode, vals = je.huff_tables(s.huff)
    for t in (s.dc[0], 4 + s.ac[0]):
        nb = je.DC_BITS if t < 4 else je.AC_BITS
        for w in range(0, 1 << nb, 7):
            e = int(lut[t, w])
            for ln in range(1, nb + 1):
                cd = w >> (nb - ln)
                if cd <= maxcode[t, ln]:
                    sym = vals[t, valptr[t, ln] + cd - mincode[t, ln]]
                    assert e & 31 == ln
                    assert (e >> 9) & 15 == (sym if t < 4 else sym & 15)
                    break
            else:
                assert e == 0
