"""Biquad filters (beyond-reference): RBJ lowpass/highpass/bandpass as a
parallel affine scan vs the oracle's sequential f64 recurrence, plus
spectral behavior and the documented approximate block-size invariance."""

import numpy as np
import pytest

import goldref.osc as go
from synthesizer_tpu.models import graph as G
from synthesizer_tpu.models import spec as S

SR = 44100
SRC = S.Osc("sawtooth", 330.0, 0.8)


def lsb_diff(node, n=SR // 2, blocksize=2048):
    want = go.render_oracle(node, n, SR)
    got = np.asarray(G.render_patch(node, n, SR, blocksize))
    g = np.clip(np.rint(got.astype(np.float64) * 32767), -32768, 32767)
    w = np.clip(np.rint(want.astype(np.float64) * 32767), -32768, 32767)
    return np.abs(g - w)


@pytest.mark.parametrize("kind,fc,q,tol", [
    ("lowpass", 1000.0, 0.7071, 2),
    ("lowpass", 3000.0, 2.0, 3),
    ("lowpass", 500.0, 8.0, 16),         # strong resonance: wider budget
    ("highpass", 2000.0, 1.0, 2),
    ("highpass", 300.0, 0.7071, 16),     # poles near the unit circle
    ("bandpass", 800.0, 4.0, 3),
])
def test_biquad_matches_sequential_oracle(kind, fc, q, tol):
    d = lsb_diff(S.Biquad(SRC, kind, fc, q))
    assert d.max() <= tol, f"max {d.max()} LSB"


def test_biquad_spectral_behavior():
    """The filters actually filter: stopband energy drops hard."""
    n = SR
    def spectrum(node):
        v = np.asarray(G.render_patch(node, n, SR, 8192), np.float64)
        return np.abs(np.fft.rfft(v * np.hanning(n)))
    freqs = np.fft.rfftfreq(n, 1 / SR)
    raw = spectrum(SRC)
    lp = spectrum(S.Biquad(SRC, "lowpass", 600.0, 0.7071))
    hp = spectrum(S.Biquad(SRC, "highpass", 3000.0, 0.7071))
    hi = freqs > 5000
    lo = (freqs > 200) & (freqs < 500)
    assert lp[hi].sum() < 0.02 * raw[hi].sum()     # lowpass kills highs
    assert hp[lo].sum() < 0.05 * raw[lo].sum()     # highpass kills lows
    assert lp[lo].sum() > 0.5 * raw[lo].sum()      # passband survives
    # resonance peaks at the cutoff
    res = spectrum(S.Biquad(SRC, "lowpass", 990.0, 8.0))
    band = (freqs > 900) & (freqs < 1100)
    assert res[band].max() > 3.0 * raw[band].max()


def test_biquad_blocksize_near_invariance():
    """IIR via parallel scan: block-size invariance holds to a few LSB
    (the documented exception to the bit-exact rule)."""
    node = S.Biquad(SRC, "lowpass", 700.0, 2.0)
    a = np.asarray(G.render_patch(node, 30000, SR, 512))
    b = np.asarray(G.render_patch(node, 30000, SR, 8192))
    assert np.abs(a - b).max() < 3.0 / 32767


def test_filter_oscillator_classes_and_server_json():
    from synthesizer_tpu import oscillators as osc
    from synthesizer_tpu.server import spec_from_json
    f = osc.LowpassFilter(osc.Sawtooth(220.0, samplerate=SR), 900.0, q=2.0)
    assert isinstance(f.spec, S.Biquad) and f.spec.cutoff == 900.0
    block = next(f.blocks(512))
    assert block.shape == (512,) and np.isfinite(block).all()
    node = spec_from_json({"node": "lowpass", "cutoff": 800,
                           "source": {"node": "osc", "kind": "square",
                                      "frequency": 110}})
    assert isinstance(node, S.Biquad) and node.kind == "lowpass"
    with pytest.raises(ValueError):
        S.Biquad(SRC, "notch", 500.0)
    with pytest.raises(ValueError):
        S.Biquad(SRC, "lowpass", -1.0)


def test_swept_cutoff_matches_oracle():
    """cutoff_lfo sweeps the cutoff in octaves (time-varying companion
    matrices in the same parallel scan); parity vs the per-sample-coeff
    sequential f64 oracle."""
    sweep = S.Osc("sine", 0.5, amplitude=2.0)       # +-2 octaves
    for q, tol in [(0.7071, 3), (4.0, 6)]:
        node = S.Biquad(S.Osc("sawtooth", 110.0, 0.8), "lowpass", 800.0, q,
                        cutoff_lfo=sweep)
        d = lsb_diff(node)
        assert d.max() <= tol, f"q={q}: max {d.max()} LSB"


def test_swept_cutoff_moves_the_spectrum():
    """The sweep is audible: the bright half (cutoff up) carries far more
    high-frequency energy than the dark half."""
    n = SR
    sweep = S.Osc("sine", 0.5, amplitude=2.0, phase=0.25)  # cos: starts high
    node = S.Biquad(S.Osc("sawtooth", 110.0, 0.8), "lowpass", 700.0, 1.0,
                    cutoff_lfo=sweep)
    v = np.asarray(G.render_patch(node, n, SR, 8192), np.float64)
    bright, dark = v[: n // 4], v[n // 2: 3 * n // 4]
    def hf(seg):
        s = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        f = np.fft.rfftfreq(len(seg), 1 / SR)
        return s[f > 2000].sum()
    assert hf(bright) > 10.0 * hf(dark)


def test_sweepable_filter_class():
    from synthesizer_tpu import oscillators as osc
    f = osc.LowpassFilter(osc.Sawtooth(110.0, samplerate=SR), 800.0, q=1.0,
                          cutoff_lfo=osc.Sine(0.5, amplitude=2.0,
                                              samplerate=SR))
    assert f.spec.cutoff_lfo is not None
    block = next(f.blocks(512))
    assert np.isfinite(block).all()


# ---------------------------------------------------------------------------
# Derived conditioning bound for the companion-matrix parallel scan
# (budget derived, not observed)
# ---------------------------------------------------------------------------

def _pole_gain(coeffs, ngrid=8192):
    """max |1/A(e^jw)| of a biquad from its actual denominator — the
    conditioning gain of the SCAN (which evaluates the all-pole
    recurrence; the numerator zeros shape H but cannot shrink the scan's
    intermediate state)."""
    _b0, _b1, _b2, a1, a2 = coeffs
    w = np.linspace(0, np.pi, ngrid)
    z1 = np.exp(-1j * w)
    z2 = np.exp(-2j * w)
    return float((1.0 / np.abs(1.0 + a1 * z1 + a2 * z2)).max())


def scan_error_bound_lsb(coeffs, n):
    """Derived bound on |parallel scan - sequential f32| at 16-bit.

    The companion scan solves the all-pole recurrence y = u - a1 y' -
    a2 y'' on the precomputed numerator signal u (|u| <= ||B||_1 = O(1)).
    Its conditioning follows the DENOMINATOR alone:

    * Gpole = max |1/A| — the factor by which a rounding perturbation can
      be amplified into the state (for a resonator ~ Q/sin(w0); this is
      why low-cutoff highpass drifts more than its overall 0 dB gain
      suggests: the zeros at DC cancel the pole gain in H but not in the
      scan);
    * tau = 1/(1 - r), r = sqrt(a2) — the pole time constant in samples:
      a perturbation rings for ~tau samples, so the log-depth tree
      accumulates a random-walk of ~sqrt(tau) effective roundings, each
      of size eps relative to the Gpole-scaled state.

        err <= 2 + 2 * eps * 32768 * log2(n) * Gpole * sqrt(tau)   [LSB]

    (+2 output-quantization floor, x2 safety).  Measured errors across
    the (kind, Q, n) grid sit below this with >= 2x margin at the worst
    point (highpass Q=40) and far below elsewhere."""
    a2 = coeffs[4]
    r = np.sqrt(max(a2, 0.0))
    tau = 1.0 / max(1.0 - r, 1e-9)
    return 2.0 + 2.0 * 2.0 ** -24 * 32768.0 * np.log2(n) \
        * _pole_gain(coeffs) * np.sqrt(tau)


def test_biquad_scan_error_within_derived_bound(rng):
    """Device parallel scan vs the sequential f32 recurrence stays inside
    the conditioning-model bound across Q, kind, and length — if the scan
    ever degrades past the model (a regression in precision handling,
    e.g. a matmul left at bf16 or TF32 precision), this fails."""
    import jax.numpy as jnp
    from synthesizer_tpu.ops import effects as dfx
    from synthesizer_tpu.ops.coeffs import biquad_coeffs

    def sequential_f32(s, coeffs):
        b0, b1, b2, a1, a2 = (np.float32(c) for c in coeffs)
        y = np.zeros_like(s)
        x1 = x2 = y1 = y2 = np.float32(0)
        for i in range(len(s)):
            x = s[i]
            v = np.float32(b0 * x + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2)
            y[i] = v
            x2, x1 = x1, x
            y2, y1 = y1, v
        return y

    for n in (1000, 8000):
        s = rng.uniform(-0.9, 0.9, n).astype(np.float32)
        for q in (0.7071, 5.0, 18.0, 40.0):
            for kind, fc in (("lowpass", 1200.0), ("bandpass", 2000.0),
                             ("highpass", 600.0)):
                c = biquad_coeffs(kind, fc, q, SR)
                ref = sequential_f32(s, c)
                dev, _ = dfx.biquad_apply(jnp.asarray(s[:, None]), c)
                err_lsb = np.abs(np.asarray(dev)[:, 0] - ref).max() * 32768
                bound = scan_error_bound_lsb(c, n)
                assert err_lsb <= bound, \
                    (kind, q, n, err_lsb, bound)


# ---------------------------------------------------------------------------
# Compensated (float-float) scan: badly-conditioned biquads route through
# ops.effects.biquad_apply_ff with (hi, lo) coefficient pairs — ~1 LSB of
# the sequential-f64 oracle where the plain scan drifts tens-to-thousands
# of LSB (low shelves, high-Q low cutoffs).
# ---------------------------------------------------------------------------

def _seq_f64(x, coeffs):
    b0, b1, b2, a1, a2 = (np.float64(c) for c in coeffs)
    s = x.astype(np.float64)
    out = np.empty_like(s)
    for ch in range(s.shape[1]):
        x1 = x2 = y1 = y2 = 0.0
        v = s[:, ch]
        for i in range(len(v)):
            y = b0 * v[i] + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
            x2, x1 = x1, v[i]
            y2, y1 = y1, y
            out[i, ch] = y
    return out


FF_CASES = [
    ("lowshelf", 120.0, 4.0, 0.7071),
    ("lowshelf", 60.0, 12.0, 0.7071),
    ("lowshelf", 120.0, -9.0, 0.7071),
    ("highshelf", 200.0, 6.0, 0.7071),
    ("peaking", 100.0, 8.0, 4.0),
]


@pytest.mark.parametrize("kind,freq,gain,q", FF_CASES)
def test_ff_scan_tracks_f64_oracle(kind, freq, gain, q, rng):
    import jax.numpy as jnp
    from synthesizer_tpu.ops import effects as dfx
    from synthesizer_tpu.ops.coeffs import (eq_band_coeffs, ff_split,
                                            wants_ff_scan)
    co = eq_band_coeffs(kind, freq, gain, q, SR)
    assert wants_ff_scan(co), "case should route ff"
    n = 30000
    x = (rng.integers(-32768, 32768, size=(n, 2)) / 32767.0) \
        .astype(np.float32)
    want = np.rint(np.clip(_seq_f64(x, co) * 32767, -32768, 32767))
    pairs = tuple(ff_split(c) for c in co)
    y, _ = dfx.biquad_apply_ff(jnp.asarray(x), pairs)
    got = np.rint(np.clip(np.asarray(y, np.float64) * 32767,
                          -32768, 32767))
    d = np.abs(got - want).max()
    assert d <= 2, f"{kind}@{freq}: {d} LSB vs f64 oracle"


def test_ff_scan_pathological_highpass(rng):
    """highpass Q=30 at 40 Hz: the plain scan drifts thousands of LSB
    from the f64 oracle (coefficient quantization + conditioning); the
    float-float path stays within 2."""
    import jax.numpy as jnp
    from synthesizer_tpu.ops import effects as dfx
    from synthesizer_tpu.ops.coeffs import biquad_coeffs, ff_split
    co = biquad_coeffs("highpass", 40.0, 30.0, SR)
    n = 30000
    x = (rng.integers(-32768, 32768, size=(n, 1)) / 32767.0) \
        .astype(np.float32)
    want = np.rint(np.clip(_seq_f64(x, co) * 32767, -32768, 32767))
    yp, _ = dfx.biquad_apply(jnp.asarray(x), co)
    dp = np.abs(np.rint(np.clip(np.asarray(yp, np.float64) * 32767,
                                -32768, 32767)) - want).max()
    yf, _ = dfx.biquad_apply_ff(
        jnp.asarray(x), tuple(ff_split(c) for c in co))
    df = np.abs(np.rint(np.clip(np.asarray(yf, np.float64) * 32767,
                                -32768, 32767)) - want).max()
    assert dp > 100, f"plain unexpectedly accurate ({dp} LSB)"
    assert df <= 2, f"ff path {df} LSB"


def test_ff_state_carries_across_chunks(rng):
    """Chunked biquad_apply_ff (carried 6-tuple state incl. the y lo
    parts) == whole-signal within 1 LSB at any chunk size."""
    import jax.numpy as jnp
    from synthesizer_tpu.ops import effects as dfx
    from synthesizer_tpu.ops.coeffs import eq_band_coeffs, ff_split
    co = eq_band_coeffs("lowshelf", 120.0, 4.0, 0.7071, SR)
    pairs = tuple(ff_split(c) for c in co)
    n = 20000
    x = (rng.integers(-32768, 32768, size=(n, 2)) / 32767.0) \
        .astype(np.float32)
    whole, _ = dfx.biquad_apply_ff(jnp.asarray(x), pairs)
    whole = np.asarray(whole)
    for chunk in (997, 4096):
        state = None
        parts = []
        for i in range(0, n, chunk):
            y, state = dfx.biquad_apply_ff(jnp.asarray(x[i:i + chunk]),
                                           pairs, state)
            parts.append(np.asarray(y))
        got = np.concatenate(parts)
        d = np.abs(np.rint(got.astype(np.float64) * 32767)
                   - np.rint(whole.astype(np.float64) * 32767)).max()
        assert d <= 1, (chunk, d)


def test_ff_split_exact():
    """The (hi, lo) split carries ~49 bits: hi = fl32(c), lo = fl32 of
    the exact residual — so hi + lo recovers c to 2^-24 OF THE RESIDUAL
    (~2^-48 relative), and the pair is non-overlapping."""
    from synthesizer_tpu.ops.coeffs import eq_band_coeffs, ff_split
    for c in eq_band_coeffs("lowshelf", 60.0, 12.0, 0.7071, SR):
        hi, lo = ff_split(c)
        err = abs(np.float64(hi) + np.float64(lo) - np.float64(c))
        assert err <= 2.0 ** -46 * abs(np.float64(c)), (c, err)
        assert abs(lo) <= 2.0 ** -24 * abs(hi) * 1.01


def test_routing_predictor_matches_test_model():
    """Product-owned predictor == this file's independently derived
    bound (the two-copies rule: routing must not drift from the model
    the tests pin)."""
    from synthesizer_tpu.ops.coeffs import (biquad_coeffs,
                                            eq_band_coeffs,
                                            predicted_scan_error_lsb)
    cases = [biquad_coeffs("lowpass", 500.0, 8.0, SR),
             biquad_coeffs("highpass", 300.0, 0.7071, SR),
             eq_band_coeffs("lowshelf", 120.0, 4.0, 0.7071, SR)]
    for co in cases:
        a = predicted_scan_error_lsb(co, n=1 << 20)
        b = scan_error_bound_lsb(co, 1 << 20)
        assert abs(a - b) <= 1e-6 * max(abs(a), abs(b)), (a, b)


def test_sample_filter_routes_and_matches_streaming(rng):
    """Sample.filter (staged biquad_ff) and StreamingBiquad (chunked)
    make the same routing decision and agree within 1 LSB for a
    conditioned shelf."""
    import jax.numpy as jnp
    from synthesizer_tpu.effects import StreamingBiquad
    from synthesizer_tpu.sample import Sample
    x = rng.integers(-28000, 28000, size=(12000, 2)).astype(np.int16)
    dev = Sample.from_raw_frames(x.tobytes(), 2, SR, 2)
    off = dev.filter("lowshelf", 120.0, 0.7071, gain_db=6.0) \
        .get_frame_array()
    proc = StreamingBiquad(SR, 2, "lowshelf", 120.0, 0.7071, gain_db=6.0)
    assert proc._ff
    parts = [np.asarray(proc.process(jnp.asarray(x[i:i + 1470])))
             for i in range(0, len(x), 1470)]
    got = np.concatenate(parts)
    d = np.abs(got.astype(np.int64) - off.astype(np.int64)).max()
    assert d <= 1, d
