"""In-process FLAC decoder vs a test-local spec-following encoder.

FLAC decode is exactly specified integer arithmetic, so the contract is
IDENTITY: encode known PCM with this test's independent encoder (written
straight from RFC 9639 — subframe types, Rice partitions, stereo
decorrelation, CRCs) and require the decoder to return the original
samples bit-exactly.  CRC implementations are pinned against published
check values first, so encoder and decoder cannot share a CRC mistake.
"""

import io
import os
import struct

import numpy as np
import pytest

from synthesizer_tpu.utils import flac as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SR = 22050


# ---------------------------------------------------------------------------
# test-local encoder (subset, independent of the decoder's structure)
# ---------------------------------------------------------------------------

class BitWriter:
    def __init__(self):
        self.bits = []

    def uint(self, v, n):
        assert 0 <= v < (1 << n), (v, n)
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def sint(self, v, n):
        self.uint(v & ((1 << n) - 1), n)

    def unary(self, q):
        self.bits.extend([0] * q + [1])

    def align(self):
        while len(self.bits) % 8:
            self.bits.append(0)

    def bytes(self):
        assert len(self.bits) % 8 == 0
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def rice_write(w, residuals, k):
    for r in residuals:
        u = (-int(r) - 1) * 2 + 1 if r < 0 else int(r) * 2
        w.unary(u >> k)
        if k:
            w.uint(u & ((1 << k) - 1), k)


def encode_subframe(w, samples, kind, bps, order=2, coefs=(3, -1),
                    shift=1, k=6, part_order=0, escape=False):
    w.uint(0, 1)                              # padding
    if kind == "constant":
        w.uint(0, 6)
        w.uint(0, 1)                          # no wasted bits
        w.sint(int(samples[0]), bps)
        return
    if kind == "verbatim":
        w.uint(1, 6)
        w.uint(0, 1)
        for s in samples:
            w.sint(int(s), bps)
        return
    if kind == "fixed":
        w.uint(8 + order, 6)
        w.uint(0, 1)
        res = list(map(int, samples[:order]))
        for s in res:
            w.sint(s, bps)
        resid = _fixed_residual(samples, order)
    else:                                     # lpc
        w.uint(0b100000 | (order - 1), 6)
        w.uint(0, 1)
        for s in samples[:order]:
            w.sint(int(s), bps)
        prec = 15                             # stored as prec-1 = 14
        w.uint(prec - 1, 4)
        w.sint(shift, 5)
        for c in coefs:
            w.sint(int(c), prec)
        resid = _lpc_residual(samples, coefs, shift, order)
    # residual: method 0 (4-bit rice), chosen partition order
    w.uint(0, 2)
    w.uint(part_order, 4)
    n = len(samples)
    ppart = n >> part_order
    idx = 0
    for p in range(1 << part_order):
        count = ppart - (order if p == 0 else 0)
        part = resid[idx:idx + count]
        idx += count
        if escape:
            w.uint(0xF, 4)
            rb = max((int(abs(int(r))).bit_length() + 1 for r in part),
                     default=1)
            w.uint(rb, 5)
            for r in part:
                w.sint(int(r), rb)
        else:
            w.uint(k, 4)
            rice_write(w, part, k)


def _fixed_residual(samples, order):
    s = list(map(int, samples))
    res = []
    for i in range(order, len(s)):
        if order == 0:
            pred = 0
        elif order == 1:
            pred = s[i - 1]
        elif order == 2:
            pred = 2 * s[i - 1] - s[i - 2]
        elif order == 3:
            pred = 3 * s[i - 1] - 3 * s[i - 2] + s[i - 3]
        else:
            pred = 4 * s[i - 1] - 6 * s[i - 2] + 4 * s[i - 3] - s[i - 4]
        res.append(s[i] - pred)
    return res


def _lpc_residual(samples, coefs, shift, order):
    s = list(map(int, samples))
    res = []
    for i in range(order, len(s)):
        acc = sum(coefs[j] * s[i - 1 - j] for j in range(order))
        res.append(s[i] - (acc >> shift))
    return res


def make_flac(channels, bps=16, blocksize=None, kinds=("fixed",),
              chan_mode=None, rate=SR, **kw):
    """channels: list of 1-D int arrays (the PCM to encode).  kinds:
    subframe kind per channel (cycled).  chan_mode: None/'ls'/'rs'/'ms'
    for stereo decorrelation."""
    n = len(channels[0])
    blocksize = blocksize or n
    nch = len(channels)
    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block)
    si = BitWriter()
    si.uint(blocksize, 16)
    si.uint(blocksize, 16)
    si.uint(0, 24)
    si.uint(0, 24)
    si.uint(rate, 20)
    si.uint(nch - 1, 3)
    si.uint(bps - 1, 5)
    si.uint(n, 36)
    body = si.bytes() + b"\x00" * 16
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    frameno = 0
    for start in range(0, n, blocksize):
        bs = min(blocksize, n - start)
        w = BitWriter()
        w.uint(0x3FFE, 14)
        w.uint(0, 1)
        w.uint(0, 1)                          # fixed blocking
        w.uint(7, 4)                          # 16-bit blocksize-1 follows
        w.uint(0, 4)                          # samplerate from STREAMINFO
        if chan_mode is None:
            w.uint(nch - 1, 4)
        else:
            w.uint({"ls": 8, "rs": 9, "ms": 10}[chan_mode], 4)
        w.uint({8: 1, 16: 4, 24: 6}[bps], 3)
        w.uint(0, 1)
        if frameno < 128:
            w.uint(frameno, 8)                # coded number (1 byte)
        else:                                 # 2-byte UTF-8 form (< 2048)
            assert frameno < 2048
            w.uint(0b110_00000 | (frameno >> 6), 8)
            w.uint(0b10_000000 | (frameno & 0x3F), 8)
        w.uint(bs - 1, 16)
        w.align()
        hdr = w.bytes()
        hdr += bytes([F.crc8(hdr)])
        w = BitWriter()
        subs = []
        if chan_mode is None:
            subs = [(np.asarray(c[start:start + bs]), bps)
                    for c in channels]
        else:
            L = channels[0][start:start + bs].astype(np.int64)
            R = channels[1][start:start + bs].astype(np.int64)
            side = L - R
            if chan_mode == "ls":
                subs = [(L, bps), (side, bps + 1)]
            elif chan_mode == "rs":
                subs = [(side, bps + 1), (R, bps)]
            else:
                subs = [((L + R) >> 1, bps), (side, bps + 1)]
        for i, (samples, sbps) in enumerate(subs):
            encode_subframe(w, samples, kinds[i % len(kinds)], sbps, **kw)
        w.align()
        frame = hdr + w.bytes()
        frame += struct.pack(">H", F.crc16(frame))
        out += frame
        frameno += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# CRC known-answer pins (so encoder+decoder cannot share a CRC bug)
# ---------------------------------------------------------------------------

def test_crc_known_vectors():
    assert F.crc8(b"123456789") == 0xF4          # CRC-8 (poly 0x07)
    assert F.crc16(b"123456789") == 0xFEE8       # CRC-16/BUYPASS (0x8005)


# ---------------------------------------------------------------------------
# decode == original
# ---------------------------------------------------------------------------

def tone(n=1000, ch=2, amp=12000):
    t = np.arange(n)
    base = np.rint(np.sin(2 * np.pi * 220.0 * t / SR) * amp)
    outs = [base.astype(np.int32), -(base // 2).astype(np.int32)][:ch]
    return [np.ascontiguousarray(o) for o in outs]


@pytest.mark.parametrize("kind", ["constant", "verbatim", "fixed", "lpc"])
def test_subframe_kinds_roundtrip(kind):
    if kind == "constant":
        chans = [np.full(600, -123, np.int32), np.full(600, 77, np.int32)]
    else:
        chans = tone(600)
    blob = make_flac(chans, kinds=(kind,))
    frames, rate, width, nch = F.read_flac(io.BytesIO(blob))
    assert (rate, width, nch) == (SR, 2, 2)
    for c in range(2):
        np.testing.assert_array_equal(frames[:, c], chans[c])


@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
def test_fixed_orders_roundtrip(order):
    chans = tone(512, ch=1)
    blob = make_flac(chans, kinds=("fixed",), order=order)
    frames, *_ = F.read_flac(io.BytesIO(blob))
    np.testing.assert_array_equal(frames[:, 0], chans[0])


def test_multi_frame_and_partitions(rng):
    x = rng.integers(-20000, 20000, size=1536).astype(np.int32)
    y = rng.integers(-20000, 20000, size=1536).astype(np.int32)
    blob = make_flac([x, y], blocksize=512, kinds=("fixed", "lpc"),
                     part_order=2, k=9)
    frames, *_ = F.read_flac(io.BytesIO(blob))
    np.testing.assert_array_equal(frames[:, 0], x)
    np.testing.assert_array_equal(frames[:, 1], y)


def test_escape_partitions(rng):
    x = rng.integers(-30000, 30000, size=256).astype(np.int32)
    blob = make_flac([x], kinds=("fixed",), escape=True)
    frames, *_ = F.read_flac(io.BytesIO(blob))
    np.testing.assert_array_equal(frames[:, 0], x)


@pytest.mark.parametrize("mode", ["ls", "rs", "ms"])
def test_stereo_decorrelation_roundtrip(mode, rng):
    L = rng.integers(-25000, 25000, size=640).astype(np.int32)
    R = rng.integers(-25000, 25000, size=640).astype(np.int32)
    blob = make_flac([L, R], kinds=("fixed",), chan_mode=mode)
    frames, *_ = F.read_flac(io.BytesIO(blob))
    np.testing.assert_array_equal(frames[:, 0], L)
    np.testing.assert_array_equal(frames[:, 1], R)


def test_bps8_and_bps24_widths(rng):
    x8 = rng.integers(-120, 120, size=300).astype(np.int32)
    blob = make_flac([x8], bps=8, kinds=("verbatim",))
    frames, rate, width, nch = F.read_flac(io.BytesIO(blob))
    assert width == 1
    np.testing.assert_array_equal(frames[:, 0].astype(np.int32), x8)
    x24 = rng.integers(-(1 << 23), 1 << 23, size=300).astype(np.int32)
    blob = make_flac([x24], bps=24, kinds=("verbatim",))
    frames, rate, width, nch = F.read_flac(io.BytesIO(blob))
    assert width == 4
    np.testing.assert_array_equal(frames[:, 0] >> 8, x24)


def test_crc_corruption_detected(rng):
    chans = tone(400, ch=1)
    blob = bytearray(make_flac(chans))
    blob[-1] ^= 0x40                   # corrupt the frame CRC-16 itself
    with pytest.raises(F.FlacError, match="CRC"):
        F.read_flac(io.BytesIO(bytes(blob)))
    # corruption INSIDE the frame also fails (CRC or structural error)
    blob2 = bytearray(make_flac(chans))
    blob2[-10] ^= 0x40
    with pytest.raises(F.FlacError):
        F.read_flac(io.BytesIO(bytes(blob2)))


def test_probe_flac_headers_only():
    chans = tone(777)
    blob = make_flac(chans)
    assert F.probe_flac(io.BytesIO(blob)) == (777, SR, 2)


def test_python_twin_matches_native(monkeypatch, rng):
    """The pure-Python residual/predictor twin decodes identically to the
    C hot loop (toolchain-less installs take that path)."""
    x = rng.integers(-20000, 20000, size=512).astype(np.int32)
    blob = make_flac([x], kinds=("lpc",), part_order=1, k=8)
    a, *_ = F.read_flac(io.BytesIO(blob))
    if F.native_available():
        monkeypatch.setattr(F, "_lib", None)
        monkeypatch.setattr(F, "_tried", True)   # force the Python twin
        b, *_ = F.read_flac(io.BytesIO(blob))
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[:, 0], x)


def test_flac_through_streaming_and_jukebox(tmp_path):
    from synthesizer_tpu.streaming import AudiofileToWavStream, SampleStream
    from synthesizer_tpu.utils.decoders import (decode_audio_file,
                                                probe_audio_file)
    chans = tone(2000)
    p = tmp_path / "t.flac"
    p.write_bytes(make_flac(chans))
    frames, rate, width, nch = decode_audio_file(str(p))
    np.testing.assert_array_equal(frames[:, 0], chans[0])
    assert probe_audio_file(str(p)) == (2000, SR, 2)
    with AudiofileToWavStream(str(p), samplerate=SR, nchannels=2,
                              samplewidth=2) as st:
        got = np.concatenate([c.get_frame_array()
                              for c in SampleStream(st, 640)])
    want = np.stack([c.astype(np.int16) for c in chans], axis=1)
    np.testing.assert_array_equal(got, want)
    from jukebox.backend import MusicLibrary
    lib = MusicLibrary(str(tmp_path / "lib.sqlite"))
    assert lib.scan(str(tmp_path)) == 1
    hit = lib.search("t")[0]
    assert hit.duration == pytest.approx(2000 / SR, abs=1e-6)
    lib.close()


# ---------------------------------------------------------------------------
# encoder (write_flac): decode(encode(x)) is identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 2, 4])
def test_write_flac_roundtrip_widths(width, rng):
    dt = {1: np.int8, 2: np.int16, 4: np.int32}[width]
    info = np.iinfo(dt)
    n = 9000
    t = np.arange(n)
    smooth = np.rint(np.sin(2 * np.pi * 220 * t / SR)
                     * (info.max * 0.7)).astype(np.int64)
    noisy = rng.integers(info.min, info.max + 1, n).astype(np.int64)
    x = np.stack([smooth, noisy], axis=1).astype(dt)
    x[:500] = info.min                       # constant run + extremes
    bio = io.BytesIO()
    F.write_flac(bio, x, SR, width, 2)
    y, rate, w2, nch = F.read_flac(io.BytesIO(bio.getvalue()))
    assert (rate, w2, nch) == (SR, width, 2)
    np.testing.assert_array_equal(y, x)


def test_write_flac_compresses_smooth_audio():
    n = 40000
    t = np.arange(n)
    sig = np.rint(np.sin(2 * np.pi * 220 * t / SR) * 12000).astype(np.int16)
    x = np.stack([sig, sig], axis=1)
    bio = io.BytesIO()
    F.write_flac(bio, x, SR, 2, 2)
    assert bio.tell() < 0.6 * x.nbytes       # fixed predictors earn keep


def test_sample_write_flac_and_cli(tmp_path):
    import subprocess
    import sys as _sys
    from synthesizer_tpu import WaveSynth
    from synthesizer_tpu.sample import Sample
    smp = WaveSynth(samplerate=SR, samplewidth=2) \
        .sine(330, 0.2, amplitude=0.6).stereo()
    p = tmp_path / "s.flac"
    smp.write_flac(str(p))
    back = Sample(wave_file=str(p))          # loader round-trips via magic
    np.testing.assert_array_equal(back.get_frame_array(),
                                  smp.get_frame_array())
    # write_audio dispatches on extension
    smp.write_audio(str(tmp_path / "s2.flac"))
    assert (tmp_path / "s2.flac").read_bytes()[:4] == b"fLaC"
    # trackmixer -o out.flac goes through the same path
    WaveSynth(samplerate=44100, samplewidth=2).sine(200, 0.05).stereo() \
        .write_wav(str(tmp_path / "k.wav"))
    (tmp_path / "s.ini").write_text(
        "[song]\nbpm = 240\nticks = 4\npatterns = a\n"
        "[instruments]\nk = k.wav\n[pattern.a]\nk = x.x.\n")
    out = subprocess.run(
        [_sys.executable, os.path.join(ROOT, "trackmixer.py"),
         str(tmp_path / "s.ini"), "-o", str(tmp_path / "mix.flac")],
        capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    frames, rate, width, nch = F.read_flac(str(tmp_path / "mix.flac"))
    assert rate == 44100 and nch == 2 and len(frames) > 1000
