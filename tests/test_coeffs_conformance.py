"""Product-owned coefficient tables == the oracle's copies.

``synthesizer_tpu.ops.coeffs`` and ``goldref`` each own a verbatim copy of
the knob→coefficient mappings (goldref may not import the product, and the
product must deploy without goldref).  These tests pin
the two copies EQUAL over knob grids, so the shared-code blind spot the
split was made to remove cannot silently reopen, plus first-principles
anchors for the mappings themselves.
"""

import math
import os

import numpy as np
import pytest

from synthesizer_tpu.ops import coeffs as C

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

goldfx = pytest.importorskip("goldref.effects")
goldspec = pytest.importorskip("goldref.spec")
goldosc = pytest.importorskip("goldref.osc")


def test_compressor_coeffs_match():
    for sr in (8000, 22050, 44100, 48000):
        for attack in (0.0, -1.0, 0.0005, 0.005, 0.1, 2.0):
            for release in (0.0, -1.0, 0.01, 0.1, 1.5):
                assert C.compressor_coeffs(sr, attack, release) \
                    == goldfx.compressor_coeffs(sr, attack, release)


def test_gate_coeffs_match():
    for sr in (8000, 44100):
        for attack in (0.0, 0.001, 0.05):
            for release in (0.0, 0.05, 0.5):
                for range_db in (20.0, 80.0, -60.0):
                    assert C.gate_coeffs(sr, attack, release, range_db) \
                        == goldfx.gate_coeffs(sr, attack, release, range_db)


def test_biquad_coeffs_match():
    for sr in (8000, 44100, 48000):
        for kind in ("lowpass", "highpass", "bandpass"):
            for cutoff in (10.0, 200.0, 1000.0, 8000.0, 30000.0):
                for q in (0.5, 0.7071, 4.0, 18.0):
                    assert C.biquad_coeffs(kind, cutoff, q, sr) \
                        == goldspec.biquad_coeffs(kind, cutoff, q, sr)
    with pytest.raises(ValueError):
        C.biquad_coeffs("notch", 1000.0, 1.0, 44100)


def test_reverb_tables_match():
    assert C.COMB_TUNING == goldfx.COMB_TUNING
    assert C.ALLPASS_TUNING == goldfx.ALLPASS_TUNING
    assert C.STEREO_SPREAD == goldfx.STEREO_SPREAD
    assert C.FIXED_GAIN == goldfx.FIXED_GAIN
    assert C.ALLPASS_FEEDBACK == goldfx.ALLPASS_FEEDBACK
    for sr in (8000, 22050, 44100, 48000, 96000):
        for ch in (0, 1):
            assert C.reverb_delays(sr, ch) == goldfx.reverb_delays(sr, ch)
    for roomsize in (0.0, 0.3, 0.7, 1.0):
        for damping in (0.0, 0.5, 1.0):
            for wet in (0.0, 0.33, 1.0):
                for width in (0.0, 0.5, 1.0):
                    assert C.reverb_params(roomsize, damping, wet, width) \
                        == goldfx.reverb_params(roomsize, damping, wet,
                                                width)


def test_stretch_grid_matches():
    for n in (100, 2048, 50000):
        for factor in (0.5, 0.9, 1.0, 1.31, 2.0):
            for frame, hop in ((2048, 512), (1024, 256), (512, 200)):
                sa, ta = C.stretch_grid(n, factor, frame, hop)
                sb, tb = goldfx.stretch_grid(n, factor, frame, hop)
                assert ta == tb
                np.testing.assert_array_equal(sa, sb)


def test_noise_hash_and_grain_grid_match():
    idx = np.arange(4096, dtype=np.uint64)
    for seed in (0, 1, 0xDEADBEEF):
        np.testing.assert_array_equal(C.noise_u32(idx, seed),
                                      goldosc.noise_u32(idx, seed))
    for n_in in (500, 44100):
        for duration in (0.1, 1.0):
            for jitter in (0.0, 0.02):
                a = C.grain_grid(n_in, 44100, duration, 0.05, 25.0,
                                 jitter, 7)
                b = goldfx.grain_grid(n_in, 44100, duration, 0.05, 25.0,
                                      jitter, 7)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)


# -- first-principles anchors (the mappings themselves, not the copies) ----

def test_compressor_coeffs_anchor():
    # alpha = 1 - e^(-1/(attack*sr)): at attack = 1/sr, alpha = 1 - 1/e
    sr = 1000
    alpha, decay = C.compressor_coeffs(sr, 1.0 / sr, 1.0 / sr)
    assert alpha == pytest.approx(1.0 - math.exp(-1.0))
    assert decay == pytest.approx(math.exp(-1.0))
    # instant attack/release degenerate exactly
    assert C.compressor_coeffs(sr, 0.0, 0.0) == (1.0, 0.0)


def test_biquad_lowpass_anchor():
    # DC gain of a lowpass must be exactly 1: sum(b) / (1 + sum(a)) == 1
    b0, b1, b2, a1, a2 = C.biquad_coeffs("lowpass", 1000.0, 0.7071, 44100)
    assert (b0 + b1 + b2) / (1.0 + a1 + a2) == pytest.approx(1.0)
    # highpass blocks DC entirely
    b0, b1, b2, a1, a2 = C.biquad_coeffs("highpass", 1000.0, 0.7071, 44100)
    assert b0 + b1 + b2 == pytest.approx(0.0, abs=1e-15)


def test_reverb_delay_anchor():
    # at the native 44100 tuning the table is verbatim, +23 on channel 1
    combs, aps = C.reverb_delays(44100, 0)
    assert combs == C.COMB_TUNING and aps == C.ALLPASS_TUNING
    combs1, _ = C.reverb_delays(44100, 1)
    assert combs1 == tuple(d + 23 for d in C.COMB_TUNING)
    # delay floor: tiny samplerates never collapse below 2 frames
    combs_t, aps_t = C.reverb_delays(80, 0)
    assert min(combs_t + aps_t) >= 2


def test_product_imports_without_goldref(tmp_path):
    """Deployment decoupling: `import synthesizer_tpu` + the coefficient
    surface works in a subprocess where goldref is IMPORT-BLOCKED."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "class B:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'goldref' or name.startswith('goldref.'):\n"
        "            raise ImportError('goldref hidden')\n"
        "        return None\n"
        "sys.meta_path.insert(0, B())\n"
        "sys.modules.pop('goldref', None)\n"
        "import synthesizer_tpu\n"
        "from synthesizer_tpu.effects import FxChain\n"
        "from synthesizer_tpu.ops.coeffs import biquad_coeffs\n"
        "FxChain([('compress', {'threshold_db': -18.0}),\n"
        "         ('filter', {'kind': 'lowpass', 'cutoff': 800.0}),\n"
        "         ('reverb', {'roomsize': 0.5})], 44100, 2)\n"
        "biquad_coeffs('lowpass', 1000.0, 0.7071, 44100)\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu",
                              "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


def test_eq_band_coeffs_match():
    for sr in (8000, 44100, 48000):
        for kind in ("lowshelf", "highshelf", "peaking"):
            for freq in (60.0, 1000.0, 8000.0, 30000.0):
                for gain in (-12.0, -3.0, 0.0, 4.5, 12.0):
                    for q in (0.5, 0.7071, 1.0, 4.0):
                        assert C.eq_band_coeffs(kind, freq, gain, q, sr) \
                            == goldspec.eq_band_coeffs(kind, freq, gain,
                                                       q, sr)
    with pytest.raises(ValueError):
        C.eq_band_coeffs("notch", 1000.0, 3.0, 1.0, 44100)


def test_eq_coeff_grids_match():
    g = np.linspace(-12.0, 12.0, 257)
    for sr in (8000, 44100):
        for kind in ("lowshelf", "highshelf", "peaking"):
            for freq in (120.0, 1000.0, 8000.0):
                for q in (0.7071, 2.0):
                    a = C.eq_coeff_grids(kind, freq, g, q, sr)
                    b = goldspec.eq_coeff_grids(kind, freq, g, q, sr)
                    for x, y in zip(a, b):
                        np.testing.assert_array_equal(x, y)
    # a constant grid reproduces the scalar coefficients (f32-cast) exactly
    for kind in ("lowshelf", "highshelf", "peaking"):
        grids = C.eq_coeff_grids(kind, 1000.0, np.full(8, 5.0), 1.0, 44100)
        scal = C.eq_band_coeffs(kind, 1000.0, 5.0, 1.0, 44100)
        for gr, s in zip(grids, scal):
            assert np.all(gr == np.float32(s))
    with pytest.raises(ValueError):
        C.eq_coeff_grids("notch", 1000.0, g, 1.0, 44100)


def test_eq_freqs_coeff_grids_match():
    f = np.geomspace(20.0, 20000.0, 257)
    for sr in (8000, 44100):
        for kind in ("lowshelf", "highshelf", "peaking"):
            for gain in (-9.0, 6.0):
                for q in (0.7071, 2.0):
                    a = C.eq_freqs_coeff_grids(kind, f, gain, q, sr)
                    b = goldspec.eq_freqs_coeff_grids(kind, f, gain, q,
                                                      sr)
                    for x, y in zip(a, b):
                        np.testing.assert_array_equal(x, y)
    # constant frequency grid == the scalar coefficients bit-exactly
    for kind in ("lowshelf", "highshelf", "peaking"):
        grids = C.eq_freqs_coeff_grids(kind, np.full(8, 700.0), 5.0, 1.0,
                                       44100, dtype=np.float64)
        scal = C.eq_band_coeffs(kind, 700.0, 5.0, 1.0, 44100)
        for gr, s in zip(grids, scal):
            assert np.all(gr == s)
    with pytest.raises(ValueError):
        C.eq_freqs_coeff_grids("notch", f, 3.0, 1.0, 44100)


def test_phaser_coeff_grids_match():
    for n0 in (0, 44100, 10 ** 7):
        for rate in (0.2, 0.5, 3.0):
            for depth in (0.0, 0.5, 1.0):
                for fmin, fmax, q in ((300.0, 3000.0, 0.7071),
                                      (50.0, 2000.0, 1.0),
                                      (120.0, 8000.0, 0.5)):
                    for dtype in (np.float32, np.float64):
                        a = C.phaser_coeff_grids(n0, 64, 44100, rate,
                                                 depth, fmin, fmax, q,
                                                 dtype=dtype)
                        b = goldspec.phaser_coeff_grids(n0, 64, 44100,
                                                        rate, depth, fmin,
                                                        fmax, q,
                                                        dtype=dtype)
                        for x, y in zip(a, b):
                            np.testing.assert_array_equal(x, y)


def test_phaser_coeff_grids_swept_match():
    rng = np.random.default_rng(7)
    P = rng.integers(0, 1 << 32, size=64, dtype=np.uint64)
    depth = rng.uniform(0.0, 1.0, size=64)
    for fmin, fmax, q in ((300.0, 3000.0, 0.7071), (50.0, 2000.0, 1.0)):
        for dtype in (np.float32, np.float64):
            a = C.phaser_coeff_grids_swept(P, depth, fmin, fmax, q,
                                           44100, dtype=dtype)
            b = goldspec.phaser_coeff_grids_swept(P, depth, fmin, fmax,
                                                  q, 44100, dtype=dtype)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    # constant rate reproduces the static function's grids bit-exactly
    inc = int(round(1.5 / 44100 * 4294967296.0)) & 0xFFFFFFFF
    Pc = (np.arange(1000, 1064, dtype=np.uint64) * np.uint64(inc)) \
        & np.uint64(0xFFFFFFFF)
    a = C.phaser_coeff_grids_swept(Pc, np.full(64, 0.7), 300.0, 3000.0,
                                   0.7071, 44100)
    b = C.phaser_coeff_grids(1000, 64, 44100, 1.5, 0.7, 300.0, 3000.0,
                             0.7071)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_echo_tail_frames_match():
    for sr in (22050, 44100, 48000):
        for delay in (0.01, 0.25, 1.0):
            for fb in (0.0, 0.3, 0.7, 0.95):
                for wet in (0.0, 1e-6, 0.4, 1.0):
                    for tail in (None, 0.0, 0.5):
                        assert C.echo_tail_frames(sr, delay, fb, wet,
                                                  tail) \
                            == goldfx.echo_tail_frames(sr, delay, fb, wet,
                                                       tail)


def test_phaser_allpass_anchor():
    # RBJ allpass: |H(e^jw)| == 1 at every frequency; at w0 the phase is
    # -pi (the notch point of the wet/dry sum).  First-principles check
    # of the allpass_coeffs row.
    b0, b1, b2, a1, a2 = C.allpass_coeffs(1000.0, 0.7071, 44100)
    for w in (0.01, 0.1423, 0.5, 1.0, 2.0):
        z = np.exp(1j * w)
        h = (b0 + b1 / z + b2 / z ** 2) / (1 + a1 / z + a2 / z ** 2)
        assert abs(abs(h) - 1.0) < 1e-12
    w0 = 2 * math.pi * 1000.0 / 44100
    z = np.exp(1j * w0)
    h = (b0 + b1 / z + b2 / z ** 2) / (1 + a1 / z + a2 / z ** 2)
    assert abs(np.angle(h) - (-math.pi)) < 1e-9 or \
        abs(np.angle(h) - math.pi) < 1e-9


def test_limiter_ceiling_anchor():
    # 0 dB = full scale exactly; -6.0206 dB = half scale (the house
    # exp2(db/6.0206) convention); width 4 stays exact past f32
    assert C.limiter_ceiling(0.0, 2) == 32767
    assert C.limiter_ceiling(0.0, 4) == 2147483647
    assert abs(C.limiter_ceiling(-6.0206, 2) - 16384) <= 1


def test_lfo_gain_grids_match():
    rng = np.random.default_rng(11)
    P = rng.integers(0, 1 << 32, size=64, dtype=np.uint64)
    for depth in (0.0, 0.5, np.full(64, 0.8)):
        np.testing.assert_array_equal(
            C.tremolo_gain_grid(P, depth),
            goldspec.tremolo_gain_grid(P, depth))
        np.testing.assert_array_equal(
            C.autopan_pan_grid(P, depth),
            goldspec.autopan_pan_grid(P, depth))
