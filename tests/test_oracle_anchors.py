"""Absolute anchors for the golden oracle.

The PCM side of goldref is anchored to the real C audioop
(test_goldref_pcm.py).  These tests give the oscillator side the same kind
of EXTERNAL reference: pure-python/f64/Fraction first-principles values
computed without numpy vectorization or any goldref/product code, plus a
static check that goldref imports nothing from synthesizer_tpu (so a
product-side semantics bug cannot shift the oracle).
"""

import math
import os
import struct
from fractions import Fraction

import numpy as np
import pytest

import goldref.osc as go
import goldref.spec as gS

SR = 44100


def test_goldref_is_decoupled_from_product():
    """goldref must not import synthesizer_tpu (source-level check)."""
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "goldref")
    for fn in os.listdir(root):
        if not fn.endswith(".py"):
            continue
        src = open(os.path.join(root, fn)).read()
        for line in src.splitlines():
            ls = line.strip()
            if ls.startswith(("import ", "from ")):
                assert "synthesizer_tpu" not in ls, f"{fn}: {ls}"


def test_phase_increment_exact_fraction():
    """DDS increment == round(f/sr * 2^32) computed with exact rationals."""
    for f, sr in [(440.0, 44100), (123.456, 44100), (0.25, 8000),
                  (19999.5, 44100), (60.0, 22050)]:
        exact = Fraction(f).limit_denominator(10**12) * (1 << 32) / sr
        # python round() on the float ratio is what the spec pins; check it
        # agrees with the exact-rational rounding for these values
        want = int(round(f / sr * 4294967296.0)) & 0xFFFFFFFF
        assert gS.phase_increment(f, sr) == want
        # and the float rounding is within 1 unit of the exact value
        assert abs(want - round(exact)) <= 1, (f, sr)


def test_phase_offset_wraps_turns():
    assert gS.phase_offset(0.0) == 0
    assert gS.phase_offset(1.0) == 0
    assert gS.phase_offset(0.5) == 1 << 31
    assert gS.phase_offset(-0.25) == 3 * (1 << 30)


def test_sine_oracle_vs_pure_python_f64():
    """Oracle sine values vs math.sin over the exact integer DDS phase
    sequence, computed per-sample in pure python (f64)."""
    n = 2048
    f = 440.0
    inc = gS.phase_increment(f, SR)
    p0 = gS.phase_offset(0.13)
    node = gS.Osc("sine", f, amplitude=1.0, phase=0.13)
    got = go.render_oracle(node, n, SR)
    for i in range(0, n, 97):
        p = (p0 + i * inc) & 0xFFFFFFFF
        # oracle computes sin(2*pi*f32(p)*2^-32) in f32; ideal is f64 of
        # the same exact phase — the gap is f32 phase+sin rounding only
        ideal = math.sin(2.0 * math.pi * (p / 2.0**32))
        assert abs(float(got[i]) - ideal) < 2e-6, i


def test_fm_phase_recurrence_pure_python():
    """The FM integer phase path vs a per-sample pure-python loop
    implementing the spec recurrence (f32 multiply via struct packing,
    truncation toward zero, wrapped u32 accumulate)."""
    def f32(x: float) -> float:
        return struct.unpack("f", struct.pack("f", x))[0]

    n = 512
    f, lfo_f, depth = 880.0, 6.0, 0.02
    base = gS.phase_increment(f, SR)
    lfo_inc = gS.phase_increment(lfo_f, SR)
    # pure-python fm values: depth * sin(2*pi*x), f32-rounded like the oracle
    phase = 0
    pure = []
    for i in range(n):
        lp = (i * lfo_inc) & 0xFFFFFFFF
        fm = f32(f32(depth) * f32(math.sin(f32(2.0 * math.pi) * f32(f32(lp) * 2.0**-32))))
        inc_f = f32(f32(base) * f32(1.0 + fm))
        inc_f = min(max(inc_f, -(2.0**31 - 256)), 2.0**31 - 256)
        pure.append(phase)                       # exclusive cumsum
        phase = (phase + int(inc_f)) & 0xFFFFFFFF

    node = gS.Osc("sine", f, amplitude=1.0,
                  fm_lfo=gS.Osc("sine", lfo_f, amplitude=depth))
    got = go.render_oracle(node, n, SR)
    for i in range(0, n, 37):
        ideal = math.sin(2.0 * math.pi * (pure[i] / 2.0**32))
        # f32 rounding in the vectorized path can move an increment by 1
        # unit (2^-32 turn) per step; over <=512 steps that bounds the
        # phase drift far below one 16-bit LSB of output
        assert abs(float(got[i]) - ideal) < 1e-4, i


def test_envelope_gains_closed_form():
    a, d, s, sl, r = 0.01, 0.02, 0.05, 0.6, 0.03
    e = gS.Envelope(gS.Const(1.0), a, d, s, sl, r)
    n = np.arange(int(SR * 0.12))
    g = go.envelope_gains(n, SR, e)
    for t, want in [(0.005, 0.5), (0.01, 1.0), (0.02, 1.0 + (sl - 1) * 0.5),
                    (0.05, sl), (0.08 + 0.015, sl * 0.5), (0.115, 0.0)]:
        i = int(round(t * SR))
        assert abs(float(g[i]) - want) < 2e-3, (t, float(g[i]), want)


def test_noise_hash_pure_python():
    def hash32(idx: int, seed: int) -> int:
        x = (idx * 0x9E3779B9 + (seed & 0xFFFFFFFF)) & 0xFFFFFFFF
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        x ^= x >> 16
        return x

    idx = np.arange(100, dtype=np.uint32)
    got = go.noise_u32(idx, seed=12345)
    for i in (0, 1, 17, 99):
        assert int(got[i]) == hash32(i, 12345)
    vals = go.noise_values(idx, seed=12345)
    for i in (0, 42):
        want = (hash32(i, 12345) >> 8) * 2.0**-23 - 1.0
        assert abs(float(vals[i]) - np.float32(want)) < 1e-7


def test_oracle_accepts_product_spec_trees():
    """Structural dispatch: a product spec tree evaluates identically to
    the goldref twin — but through goldref's OWN constants."""
    from synthesizer_tpu.models import spec as pS
    prod = pS.Envelope(pS.Osc("triangle", 220.0, 0.8,
                              fm_lfo=pS.Osc("sine", 3.0, 0.01)),
                       0.01, 0.02, 0.05, 0.7, 0.02)
    gold = gS.Envelope(gS.Osc("triangle", 220.0, 0.8,
                              fm_lfo=gS.Osc("sine", 3.0, 0.01)),
                       0.01, 0.02, 0.05, 0.7, 0.02)
    np.testing.assert_array_equal(go.render_oracle(prod, 4096, SR),
                                  go.render_oracle(gold, 4096, SR))
