"""Effects rack (beyond-reference): device twins vs the goldref.effects
oracle, with the tolerance budgets documented in goldref.effects:

  compressor  <= 2 LSB  (parallel-scan regrouping of the f32 recurrences)
  reverb      <= 4 LSB  (blocked-parallel comb/allpass arithmetic)
  chorus      <= 2 LSB  (turn-unit device sine vs libm + f32 lerp)
  convolve    <= max(8 LSB, 1e-4 * peak)  (f32 FFT vs f64 direct)
"""

import math

import numpy as np
import pytest

import goldref.sample as gs
import goldref.effects as gfx
from synthesizer_tpu.sample import Sample
from synthesizer_tpu.ops import effects as dfx
from synthesizer_tpu.utils import profiling

SR = 44100


def make_pair(rng, n=5000, width=2, nch=2, sr=SR, quiet=False):
    lo, hi = gs.MINVAL[width], gs.MAXVAL[width]
    div = 8 if quiet else 2
    a = rng.integers(lo // div, hi // div, size=(n, nch)).astype(
        gs._DTYPES[width])
    gold = gs.Sample(a.copy(), sr, width, nch)
    dev = Sample.from_raw_frames(a.tobytes(), width, sr, nch)
    return gold, dev


def check_lsb(gold, dev, budget, width=2):
    got = dev.get_frame_array()
    assert got.shape == gold.frames.shape
    d = got.astype(np.int64) - gold.frames.astype(np.int64)
    scale = gs.MAXVAL[width] / 32767.0    # budgets are quoted at 16-bit
    assert np.abs(d).max() <= math.ceil(budget * scale), \
        f"max diff {np.abs(d).max()} over budget {budget} (16-bit scale)"


# ---------------------------------------------------------------------------
# Compressor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nch", [1, 2])
def test_compress_matches_oracle(rng, nch):
    gold, dev = make_pair(rng, n=4000, nch=nch)
    kw = dict(threshold_db=-18.0, ratio=4.0, attack=0.003, release=0.08,
              makeup_db=3.0)
    check_lsb(gold.compress(**kw), dev.compress(**kw), 2)


def test_compress_limiter_and_edges(rng):
    # ratio=inf (limiter), zero attack/release (instant)
    gold, dev = make_pair(rng, n=3000)
    kw = dict(threshold_db=-12.0, ratio=math.inf, attack=0.0, release=0.0)
    check_lsb(gold.compress(**kw), dev.compress(**kw), 2)


def test_compress_below_threshold_is_transparent(rng):
    # a quiet signal (<= -24 dBFS) under a -6 dB threshold: gain stays 1
    gold, dev = make_pair(rng, n=2000, quiet=True)
    out = dev.compress(threshold_db=-6.0, ratio=8.0).get_frame_array()
    np.testing.assert_array_equal(out, gold.frames)


def test_compress_width4(rng):
    gold, dev = make_pair(rng, n=2000, width=4, nch=1)
    kw = dict(threshold_db=-20.0, ratio=3.0, attack=0.002, release=0.05)
    check_lsb(gold.compress(**kw), dev.compress(**kw), 2, width=4)


def test_limiter_caps_peak(rng):
    _, dev = make_pair(rng, n=4000, nch=1)
    out = dev.compress(threshold_db=-20.0, ratio=math.inf, attack=0.0,
                       release=0.05).get_frame_array()
    ceiling = 32767.0 * 10 ** (-20.0 / 20.0)
    assert np.abs(out).max() <= ceiling * 1.01 + 1


# ---------------------------------------------------------------------------
# Reverb
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nch", [1, 2])
def test_reverb_matches_oracle(rng, nch):
    gold, dev = make_pair(rng, n=3000, nch=nch)
    kw = dict(roomsize=0.8, damping=0.4, wet=0.3, dry=0.6, tail=0.15)
    g, d = gold.reverb(**kw), dev.reverb(**kw)
    assert d.nframes == 3000 + int(0.15 * SR)
    check_lsb(g, d, 4)


def test_reverb_low_samplerate_small_delays(rng):
    # sr 8000 shrinks the shortest allpass below the 128 block default
    gold, dev = make_pair(rng, n=2500, nch=1, sr=8000)
    kw = dict(roomsize=0.6, damping=0.7, wet=0.4, dry=0.5, width=0.5,
              tail=0.1)
    check_lsb(gold.reverb(**kw), dev.reverb(**kw), 4)


def test_reverb_of_silence_is_silence():
    dev = Sample.from_raw_frames(np.zeros((1000, 2), np.int16).tobytes(),
                                 2, SR, 2)
    out = dev.reverb(tail=0.05).get_frame_array()
    assert np.abs(out).max() == 0


def test_reverb_long_signal_fallback_matches_packed(rng, monkeypatch):
    # past COMB_PACK_BYTES_CAP the whole-signal path routes through the
    # chunked streaming twin; both evaluate the same goldref recurrences,
    # so against the oracle each stays within the documented 4-LSB budget
    from synthesizer_tpu.ops import effects as dfx
    gold, dev = make_pair(rng, n=4000, nch=2)
    kw = dict(roomsize=0.75, damping=0.5, wet=0.35, dry=0.6, tail=0.1)
    g = gold.reverb(**kw)
    packed = dev.reverb(**kw)
    check_lsb(g, packed, 4)
    monkeypatch.setattr(dfx, "COMB_PACK_BYTES_CAP", 0)
    gold2, dev2 = make_pair(rng, n=4000, nch=2)
    fallback = dev2.reverb(**kw)
    check_lsb(gold2.reverb(**kw), fallback, 4)


# ---------------------------------------------------------------------------
# Chorus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nch", [1, 2])
def test_chorus_matches_oracle(rng, nch):
    gold, dev = make_pair(rng, n=4000, nch=nch)
    kw = dict(rate=1.5, depth=0.003, delay=0.015, voices=3, wet=0.5, dry=0.9)
    g, d = gold.chorus(**kw), dev.chorus(**kw)
    assert d.nframes == 4000
    check_lsb(g, d, 2)


@pytest.mark.parametrize("nch,width", [(2, 2), (1, 2), (2, 4)])
def test_chorus_banded_matches_oracle(rng, nch, width):
    """Inputs >= 16384 frames route to the host-block-planned BANDED
    form (ops.coeffs.chorus_block_plan — the round-5 gather escape):
    same goldref budget as the gather form."""
    gold, dev = make_pair(rng, n=30000, nch=nch, width=width)
    kw = dict(rate=1.5, depth=0.003, delay=0.015, voices=3, wet=0.5,
              dry=0.9)
    check_lsb(gold.chorus(**kw), dev.chorus(**kw), 2, width=width)


@pytest.mark.parametrize("kw", [
    dict(rate=0.5, depth=0.002, delay=0.02, voices=3, wet=0.4, dry=1.0),
    dict(rate=3.0, depth=0.0005, delay=0.002, voices=2, wet=0.6, dry=0.6),
    dict(rate=0.05, depth=0.004, delay=0.03, voices=4, wet=0.5, dry=0.8),
])
def test_chorus_banded_bit_compatible_with_gather(rng, kw):
    """The banded path computes the IDENTICAL two-term f32 lerp in the
    identical order as the pair-gather form — bit-identical output
    (the round-5 contract; the battery re-proves it on chip)."""
    import jax.numpy as jnp
    n = 25000
    x = rng.integers(-32768, 32768, size=(n, 2)).astype(np.int16)
    banded = np.asarray(dfx.chorus(jnp.asarray(x), SR, kw["rate"],
                                   kw["depth"], kw["delay"], kw["voices"],
                                   kw["wet"], kw["dry"]))
    gathered = np.asarray(dfx.to_int_samples(dfx.chorus_core(
        dfx._norm(jnp.asarray(x)), jnp.int32(0),
        jnp.zeros((0, 2), jnp.float32), SR, kw["rate"], kw["depth"],
        kw["delay"], kw["voices"], kw["wet"], kw["dry"]), 2))
    np.testing.assert_array_equal(banded, gathered)


def test_chorus_plan_band_covers_device_curve_large_delay():
    """The plan's host/device margin must scale with the DELAY knob: the
    device's f32 sum and final *samplerate product each round at 2^-24
    RELATIVE to (delay + depth), so a 5 s delay rounds by ~0.05 frames —
    past any fixed constant.  Every device floor(d) must land inside the
    planned [dfmax-K, dfmax] band or a lerp tap is silently dropped."""
    import jax.numpy as jnp
    from synthesizer_tpu.ops.coeffs import chorus_block_plan
    n, delay, voices = 30000, 5.0, 2
    G, K, nb, pad0, padtot, starts, dfmax = chorus_block_plan(
        n, SR, 0.5, 0.002, delay, voices, 2)
    assert K <= dfx.CHORUS_BANDED_MAX_TAPS
    for ch in range(2):
        for v in range(voices):
            d = np.asarray(dfx._chorus_lfo_delay(
                jnp.int32(0), nb * G, SR, 0.5, 0.002, delay, v, voices, ch))
            df = np.floor(d).astype(np.int64).reshape(nb, G)
            k0 = dfmax[ch * voices + v][:, None].astype(np.int64) - df
            assert k0.min() >= 0, "device curve below the planned band"
            assert (k0 + 1).max() <= K + 1, "device curve above the band"


def test_chorus_banded_bit_compatible_at_long_delay(rng):
    """Long (but in-signal) delay knobs stay bit-identical to the gather
    form — the delay-scaled margin keeps every tap in band."""
    import jax.numpy as jnp
    n, kw = 120000, dict(rate=0.5, depth=0.002, delay=2.2, voices=2,
                         wet=0.5, dry=0.9)
    x = rng.integers(-32768, 32768, size=(n, 2)).astype(np.int16)
    banded = np.asarray(dfx.chorus(jnp.asarray(x), SR, kw["rate"],
                                   kw["depth"], kw["delay"], kw["voices"],
                                   kw["wet"], kw["dry"]))
    gathered = np.asarray(dfx.to_int_samples(dfx.chorus_core(
        dfx._norm(jnp.asarray(x)), jnp.int32(0),
        jnp.zeros((0, 2), jnp.float32), SR, kw["rate"], kw["depth"],
        kw["delay"], kw["voices"], kw["wet"], kw["dry"]), 2))
    np.testing.assert_array_equal(banded, gathered)


def test_chorus_banded_fuzz_bit_compatible(rng):
    """Randomized static knobs across the banded plan region: every draw
    must be BIT-identical to the pair-gather form (knobs that plan past
    the tap cap route to the gather and are trivially identical — the
    draw range keeps most in-plan)."""
    import jax.numpy as jnp
    n = 20000
    for _ in range(8):
        kw = dict(rate=float(rng.uniform(0.05, 3.0)),
                  depth=float(rng.uniform(0.0002, 0.004)),
                  delay=float(rng.uniform(0.001, 0.4)),
                  voices=int(rng.integers(1, 5)),
                  wet=float(rng.uniform(0.1, 1.0)),
                  dry=float(rng.uniform(0.0, 1.0)))
        x = rng.integers(-32768, 32768, size=(n, 2)).astype(np.int16)
        banded = np.asarray(dfx.chorus(
            jnp.asarray(x), SR, kw["rate"], kw["depth"], kw["delay"],
            kw["voices"], kw["wet"], kw["dry"]))
        gathered = np.asarray(dfx.to_int_samples(dfx.chorus_core(
            dfx._norm(jnp.asarray(x)), jnp.int32(0),
            jnp.zeros((0, 2), jnp.float32), SR, kw["rate"], kw["depth"],
            kw["delay"], kw["voices"], kw["wet"], kw["dry"]), 2))
        np.testing.assert_array_equal(banded, gathered, err_msg=str(kw))


def test_chorus_banded_tap_cap_routes_to_gather(rng, monkeypatch):
    """Fast/deep LFO knobs whose plan would unroll past
    CHORUS_BANDED_MAX_TAPS static tap slices (an HLO-size blowup with
    ~K/2 wasted full-length ops per useful tap) route back to the pair
    gather — their measured roofline form."""
    import jax.numpy as jnp
    from synthesizer_tpu.ops.coeffs import chorus_block_plan
    _, K, *_ = chorus_block_plan(25000, SR, 6.0, 0.02, 0.02, 3, 2)
    assert K > dfx.CHORUS_BANDED_MAX_TAPS
    hit = {}
    orig = dfx.chorus_core

    def spy(*a, **k):
        hit["gather"] = True
        return orig(*a, **k)

    monkeypatch.setattr(dfx, "chorus_core", spy)
    x = rng.integers(-32768, 32768, size=(25000, 2)).astype(np.int16)
    dfx.chorus(jnp.asarray(x), SR, 6.0, 0.02, 0.02, 3, 0.5, 0.9)
    assert hit.get("gather"), "tap-capped knobs must use the gather form"


def test_chorus_small_and_zero_delay_route_to_gather(rng):
    """Routing floor: tiny inputs and sub-frame delays keep the
    pair-gather form (the clip at delay ~0 defines that contract)."""
    gold, dev = make_pair(rng, n=4000)
    kw = dict(rate=1.5, depth=0.003, delay=0.0, voices=2, wet=0.5, dry=0.9)
    check_lsb(gold.chorus(**kw), dev.chorus(**kw), 2)


def test_chorus_dry_only_is_identity(rng):
    gold, dev = make_pair(rng, n=1000, nch=1)
    out = dev.chorus(wet=0.0, dry=1.0).get_frame_array()
    # dry=1, wet=0: rint(s*maxval) round-trips int16 values exactly
    np.testing.assert_array_equal(out, gold.frames)


# ---------------------------------------------------------------------------
# Convolve
# ---------------------------------------------------------------------------

def _ir(rng, m=300, nch=1, width=2):
    decay = np.exp(-np.arange(m) / (m / 4.0))
    a = (rng.normal(0, 0.2, size=(m, nch)) * decay[:, None] * 20000)
    a = np.clip(a, gs.MINVAL[width], gs.MAXVAL[width]).astype(
        gs._DTYPES[width])
    return a


@pytest.mark.parametrize("sig_nch,ir_nch", [(1, 1), (2, 1), (2, 2)])
def test_convolve_matches_oracle(rng, sig_nch, ir_nch):
    gold, dev = make_pair(rng, n=2000, nch=sig_nch)
    ira = _ir(rng, nch=ir_nch)
    gold_ir = gs.Sample(ira.copy(), SR, 2, ir_nch)
    dev_ir = Sample.from_raw_frames(ira.tobytes(), 2, SR, ir_nch)
    g = gold.convolve(gold_ir, wet=0.02, dry=0.5)
    d = dev.convolve(dev_ir, wet=0.02, dry=0.5)
    assert d.nframes == 2000 + 300 - 1
    got = d.get_frame_array()
    diff = np.abs(got.astype(np.int64) - g.frames.astype(np.int64)).max()
    budget = max(8, 1e-4 * np.abs(g.frames).max())
    assert diff <= budget


def test_convolve_identity_impulse(rng):
    gold, dev = make_pair(rng, n=1500, nch=1)
    imp = np.zeros((1, 1), np.int16)
    imp[0, 0] = 32767
    dev_ir = Sample.from_raw_frames(imp.tobytes(), 2, SR, 1)
    out = dev.convolve(dev_ir, wet=1.0, dry=0.0).get_frame_array()
    # unit impulse: rint(s * (32767/32767) * maxval) == original within 1
    d = np.abs(out.astype(np.int64) - gold.frames.astype(np.int64)).max()
    assert d <= 1


def test_convolve_format_checks(rng):
    _, dev = make_pair(rng, n=100, nch=1)
    bad = Sample.from_raw_frames(np.zeros((10, 1), np.int16).tobytes(),
                                 2, 22050, 1)
    with pytest.raises(ValueError):
        dev.convolve(bad)
    _, mono = make_pair(rng, n=100, nch=1)
    stereo_ir = Sample.from_raw_frames(np.zeros((10, 2), np.int16).tobytes(),
                                       2, SR, 2)
    with pytest.raises(ValueError):
        mono.convolve(stereo_ir)


# ---------------------------------------------------------------------------
# Staging / fusion behavior
# ---------------------------------------------------------------------------

def test_effects_chain_fuses_to_one_program(rng):
    _, dev = make_pair(rng, n=2000, nch=2)
    with profiling.count_program_launches() as cnt:
        dev.compress(threshold_db=-15.0).chorus().reverb(tail=0.1) \
           .fadeout(0.01).amplify(0.9)
        assert cnt[0] == 0                    # still staged
        dev.get_frame_array()
    assert cnt[0] == 1


def test_effect_knobs_reuse_compiled_program(rng):
    # same chain shape with different knob values must not recompile
    from synthesizer_tpu import sample as sample_mod
    _, dev1 = make_pair(rng, n=1000, nch=2)
    dev1.compress(threshold_db=-15.0, ratio=4.0).reverb(roomsize=0.3,
                                                        tail=0.1)
    dev1.get_frame_array()
    ncached = len(sample_mod._program_cache)
    _, dev2 = make_pair(rng, n=1000, nch=2)
    dev2.compress(threshold_db=-9.0, ratio=2.0).reverb(roomsize=0.9,
                                                       tail=0.1)
    dev2.get_frame_array()
    assert len(sample_mod._program_cache) == ncached


def test_ops_parallel_scan_primitives_match_sequential(rng):
    # unit-level pins for the scan building blocks
    a = rng.random(777, dtype=np.float32).astype(np.float32)
    e = dfx.decaying_max_scan(np.asarray(a), 0.95, init=0.25)
    ref = np.empty_like(a)
    acc = 0.25
    for i, v in enumerate(a):
        acc = max(float(v), acc * 0.95)
        ref[i] = acc
    np.testing.assert_allclose(np.asarray(e), ref, rtol=1e-5, atol=1e-6)

    y = dfx.one_pole_scan(np.asarray(a), 0.125, init=1.0)
    refy = np.empty_like(a)
    acc = 1.0
    for i, v in enumerate(a):
        acc = acc + 0.125 * (float(v) - acc)
        refy[i] = acc
    np.testing.assert_allclose(np.asarray(y), refy, rtol=1e-4, atol=1e-5)


def test_chorus_lfo_phase_exact_at_large_index():
    # the LFO phase is an integer DDS, so the delay curve at absolute frame
    # ~2^26 (25 minutes) is as accurate as at frame 0 (an f32 n*rate/sr
    # phase would be quantized to ~1/4 frame there)
    n0, n = 1 << 26, 256
    ref = gfx.chorus_delay_f32(n0, n, SR, rate=0.8, depth=0.002,
                               delay=0.02, voice=1, voices=3, channel=1)
    got = np.asarray(dfx._chorus_lfo_delay(
        np.int32(n0), n, SR, 0.8, np.float32(0.002), np.float32(0.02),
        1, 3, 1))
    # device turn-unit sine vs libm: 7.8e-7 * depth * sr ~ 7e-5 frames
    np.testing.assert_allclose(got, ref, atol=1e-3)


# ---------------------------------------------------------------------------
# Phase-vocoder stretch / pitch shift
# ---------------------------------------------------------------------------

def _tone_mix(n, nch):
    t = np.arange(n) / SR
    v = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.25 * np.sin(2 * np.pi * 661 * t)
         + 0.1 * np.sin(2 * np.pi * 1333 * t + 0.7))
    a = np.clip(np.rint(v * 32767), -32768, 32767).astype(np.int16)
    return np.repeat(a[:, None], nch, axis=1)


@pytest.mark.parametrize("factor", [0.7, 1.0, 1.6])
def test_stretch_matches_oracle(factor):
    a = _tone_mix(9000, 2)
    gold = gs.Sample(a.copy(), SR, 2, 2)
    dev = Sample.from_raw_frames(a.tobytes(), 2, SR, 2)
    g = gold.stretch(factor, frame=1024, hop=256)
    d = dev.stretch(factor, frame=1024, hop=256)
    assert d.nframes == g.nframes == round(9000 * factor)
    got = d.get_frame_array()
    diff = np.abs(got.astype(np.int64) - g.frames.astype(np.int64)).max()
    assert diff <= 64, diff    # goldref.effects.stretch budget


def test_stretch_preserves_pitch():
    n = 22050
    a = _tone_mix(n, 1)
    dev = Sample.from_raw_frames(a.tobytes(), 2, SR, 1)
    out = dev.stretch(1.5).get_frame_array()[:, 0].astype(np.float64)
    # dominant FFT bin stays at 440 Hz though duration grew 1.5x
    spec = np.abs(np.fft.rfft(out * np.hanning(len(out))))
    peak_hz = np.argmax(spec) * SR / len(out)
    assert abs(peak_hz - 440.0) < 6.0, peak_hz
    assert len(out) == round(n * 1.5)


def test_pitch_shift_moves_pitch_keeps_duration():
    n = 22050
    a = _tone_mix(n, 1)
    gold = gs.Sample(a.copy(), SR, 2, 1)
    dev = Sample.from_raw_frames(a.tobytes(), 2, SR, 1)
    g = gold.pitch_shift(12.0)
    d = dev.pitch_shift(12.0)
    assert d.nframes == g.nframes
    assert abs(d.nframes - n) <= 2
    out = d.get_frame_array()[:, 0].astype(np.float64)
    spec = np.abs(np.fft.rfft(out * np.hanning(len(out))))
    peak_hz = np.argmax(spec) * SR / len(out)
    assert abs(peak_hz - 880.0) < 8.0, peak_hz
    diff = np.abs(d.get_frame_array().astype(np.int64)
                  - g.frames.astype(np.int64)).max()
    assert diff <= 64, diff


def test_pitch_shift_hq_suppresses_speed_leg_images():
    """quality='hq' routes pitch_shift's speed leg through the
    windowed-sinc resampler: a 15 kHz partial shifted +12
    lands above Nyquist (30 kHz) and must be REMOVED, where the linear
    leg folds it back as a ~14.1 kHz alias; default stays the exact
    linear composition (bit-identical)."""
    n = 32768
    t = np.arange(n)
    x = ((np.sin(2 * np.pi * 1000 * t / SR)
          + np.sin(2 * np.pi * 15000 * t / SR)) * 12000).astype(np.int16)
    x = x.reshape(-1, 1)

    def alias_db(quality):
        d = Sample.from_raw_frames(x.tobytes(), 2, SR, 1) \
            .pitch_shift(12.0, quality=quality)
        out = d.get_frame_array()[:, 0].astype(np.float64)
        seg = out[2048:2048 + 16384] * np.hanning(16384)
        spec = np.abs(np.fft.rfft(seg))
        freqs = np.fft.rfftfreq(16384, 1 / SR)
        tone = spec[(freqs > 1900) & (freqs < 2100)].max()
        alias = spec[(freqs > 13500) & (freqs < 14700)].max()
        return 20 * np.log10(tone / max(alias, 1e-12))

    rej_linear = alias_db("linear")
    rej_hq = alias_db("hq")
    assert rej_hq > rej_linear + 25.0, (rej_linear, rej_hq)
    assert rej_hq > 45.0, rej_hq
    # default == explicit linear, bit-identical
    a = Sample.from_raw_frames(x.tobytes(), 2, SR, 1).pitch_shift(12.0)
    b = Sample.from_raw_frames(x.tobytes(), 2, SR, 1) \
        .pitch_shift(12.0, quality="linear")
    assert np.array_equal(a.get_frame_array(), b.get_frame_array())


def test_framed_rows_bit_identical():
    # the round-4 row-packed analysis-window gather is a pure load
    # rearrangement: must equal the direct element gather bitwise for
    # packed (frame % W == 0) and fallback (frame % W != 0) shapes
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    s1 = jnp.asarray(rng.random(30000, dtype=np.float32))
    for frame in (2048, 1024, 1000):       # 1000 % 16 != 0 -> fallback
        starts = np.sort(rng.integers(0, 30000 - frame, size=63))
        direct = np.asarray(s1)[starts[:, None] + np.arange(frame)[None, :]]
        packed = np.asarray(dfx._framed_rows(s1, starts, frame))
        assert (direct == packed).all(), frame


def test_stretch_non_divisible_hop_matches_oracle():
    # frame % hop != 0 routes the overlap-add through the scatter-add
    # fallback (oa_ratio == 0) — same goldref budget as the canvas path
    a = _tone_mix(9000, 2)
    gold = gs.Sample(a.copy(), SR, 2, 2)
    dev = Sample.from_raw_frames(a.tobytes(), 2, SR, 2)
    g = gold.stretch(1.4, frame=1024, hop=300)
    d = dev.stretch(1.4, frame=1024, hop=300)
    assert d.nframes == g.nframes
    diff = np.abs(d.get_frame_array().astype(np.int64)
                  - g.frames.astype(np.int64)).max()
    assert diff <= 64, diff


def test_stretch_short_input_no_nan():
    # inputs shorter than one FFT frame: the grid floors hops at 1 frame
    # (a zero analysis hop used to emit NaN audio on both sides)
    a = _tone_mix(1500, 1)
    gold = gs.Sample(a.copy(), SR, 2, 1)
    dev = Sample.from_raw_frames(a.tobytes(), 2, SR, 1)
    g = gold.stretch(1.5)            # frame=2048 > 1500
    d = dev.stretch(1.5)
    assert d.nframes == g.nframes == round(1500 * 1.5)
    got = d.get_frame_array()
    assert np.abs(got).max() <= 32767        # finite, in range
    assert np.abs(g.frames).max() > 0        # oracle produced audio
    diff = np.abs(got.astype(np.int64) - g.frames.astype(np.int64)).max()
    assert diff <= 64, diff


def test_pitch_shift_short_hit():
    # a 30 ms hat (1323 frames) — the reviewer's failing case
    rng = np.random.default_rng(5)
    a = (rng.normal(0, 0.3, 1323) * 20000).clip(-32768, 32767) \
        .astype(np.int16)[:, None]
    dev = Sample.from_raw_frames(a.tobytes(), 2, SR, 1)
    out = dev.pitch_shift(7.0).get_frame_array()
    assert np.isfinite(out.astype(np.float64)).all()
    assert np.abs(out).max() > 0


# ---------------------------------------------------------------------------
# Sample-level biquad filter & noise gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,cutoff,q,budget", [
    ("lowpass", 1000.0, 0.7071, 4),
    ("highpass", 300.0, 0.7071, 16),
    ("bandpass", 800.0, 4.0, 4),
    ("lowpass", 500.0, 8.0, 24),     # strong resonance (graph Biquad budget)
])
def test_sample_filter_matches_oracle(rng, kind, cutoff, q, budget):
    gold, dev = make_pair(rng, n=4000, nch=2)
    check_lsb(gold.filter(kind, cutoff, q), dev.filter(kind, cutoff, q),
              budget)


@pytest.mark.parametrize("nch", [1, 2])
def test_gate_matches_oracle(rng, nch):
    # bursts separated by near-silence: the gate opens and closes
    n = 7000
    a = rng.integers(-15000, 15000, size=(n, nch)).astype(np.int16)
    a[1500:4500] //= 600                 # quiet region under the threshold
    gold = gs.Sample(a.copy(), SR, 2, nch)
    dev = Sample.from_raw_frames(a.tobytes(), 2, SR, nch)
    kw = dict(threshold_db=-30.0, range_db=60.0, attack=0.001, release=0.01)
    g, d = gold.gate(**kw), dev.gate(**kw)
    check_lsb(g, d, 2)
    # it actually gated: past the release hold the quiet region is silenced
    got = d.get_frame_array()
    assert np.abs(got[3500:4400]).max() <= np.abs(a[3500:4400]).max() // 4


def test_streaming_filter_and_gate_chunk_invariance(rng):
    from synthesizer_tpu.effects import StreamingBiquad, StreamingGate
    x = rng.integers(-15000, 15000, size=(7000, 2)).astype(np.int16)
    a = _chunked(lambda: StreamingBiquad(SR, 2, "lowpass", 900.0, 2.0),
                 x, [7000])
    b = _chunked(lambda: StreamingBiquad(SR, 2, "lowpass", 900.0, 2.0),
                 x, [997, 1024, 333])
    assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 4
    a = _chunked(lambda: StreamingGate(SR, threshold_db=-25.0), x, [7000])
    b = _chunked(lambda: StreamingGate(SR, threshold_db=-25.0), x,
                 [640, 2048])
    assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 2


def _chunked(proc_factory, x, sizes):
    import jax.numpy as jnp
    proc = proc_factory()
    outs, i, k = [], 0, 0
    while i < len(x):
        n = sizes[k % len(sizes)]
        outs.append(np.asarray(proc.process(jnp.asarray(x[i:i + n]))))
        i += n
        k += 1
    return np.concatenate(outs)


@pytest.mark.parametrize("key_len", [2000, 6000])
def test_sidechain_compress_matches_oracle(rng, key_len):
    # the detector listens to the key (shorter/longer than the target)
    gold, dev = make_pair(rng, n=4000, nch=2)
    key = rng.integers(-30000, 30000, size=(key_len, 1)).astype(np.int16)
    gkey = gs.Sample(key.copy(), SR, 2, 1)
    dkey = Sample.from_raw_frames(key.tobytes(), 2, SR, 1)
    kw = dict(threshold_db=-12.0, ratio=6.0, attack=0.002, release=0.03)
    g = gold.compress(sidechain=gkey, **kw)
    d = dev.compress(sidechain=dkey, **kw)
    check_lsb(g, d, 2)


def test_sidechain_ducking_behavior(rng):
    # a loud key duck the (quiet, sustained) target while the key sounds
    n = 8000
    target = (np.ones((n, 1)) * 8000).astype(np.int16)
    key = np.zeros((n, 1), np.int16)
    key[1000:3000] = 30000
    dev = Sample.from_raw_frames(target.tobytes(), 2, SR, 1)
    dkey = Sample.from_raw_frames(key.tobytes(), 2, SR, 1)
    out = dev.compress(threshold_db=-20.0, ratio=8.0, attack=0.001,
                       release=0.01, sidechain=dkey).get_frame_array()
    assert out[2500, 0] < 5000            # ducked while the key is loud
    assert out[500, 0] == 8000            # untouched before the key
    assert out[-1, 0] > 7000              # released after the key ends


# ---------------------------------------------------------------------------
# Granular synthesis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nch,seed", [(1, 0), (2, 7)])
def test_granulate_matches_oracle(rng, nch, seed):
    gold, dev = make_pair(rng, n=6000, nch=nch)
    kw = dict(duration=0.3, grain=0.03, density=40.0, jitter=0.01,
              amplitude=0.6, seed=seed)
    g, d = gold.granulate(**kw), dev.granulate(**kw)
    assert d.nframes == g.nframes == int(0.3 * SR)
    check_lsb(g, d, 2)
    assert np.abs(g.frames).max() > 0


def test_granulate_deterministic_seed(rng):
    _, dev1 = make_pair(rng, n=4000, nch=1)
    rng2 = np.random.default_rng(0xC0FFEE)
    _, dev2 = make_pair(rng2, n=4000, nch=1)
    a = dev1.granulate(duration=0.2, seed=3).get_frame_array()
    b = dev2.granulate(duration=0.2, seed=3).get_frame_array()
    np.testing.assert_array_equal(a, b)
    _, dev3 = make_pair(np.random.default_rng(0xC0FFEE), n=4000, nch=1)
    c = dev3.granulate(duration=0.2, seed=4).get_frame_array()
    assert not np.array_equal(a, c)       # the seed matters


def test_granulate_short_input():
    a = _tone_mix(500, 1)                 # shorter than one grain
    dev = Sample.from_raw_frames(a.tobytes(), 2, SR, 1)
    out = dev.granulate(duration=0.1, grain=0.05).get_frame_array()
    assert len(out) == int(0.1 * SR)
    assert np.abs(out).max() > 0


# ---------------------------------------------------------------------------
# Parametric EQ (shelving/peaking biquads)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,freq,gain,q,budget", [
    # badly-conditioned bands (poles near z=1: low shelves, high-Q
    # peaking — ops.coeffs.wants_ff_scan) route through the compensated
    # float-float scan and track the f64 oracle to ~1-2 LSB (they
    # measured ~35-110 LSB on the plain scan); the well-conditioned
    # rest keep the plain scan's scan-conditioning-model budget
    ("peaking", 1000.0, 6.0, 1.0, 4),
    ("peaking", 3000.0, -9.0, 4.0, 4),
    ("peaking", 250.0, 12.0, 8.0, 4),     # ff: was 256 on the plain scan
    ("lowshelf", 200.0, 5.0, 0.7071, 4),  # ff: was 96
    ("lowshelf", 120.0, -12.0, 0.7071, 4),  # ff: was 96
    ("highshelf", 6000.0, -6.0, 0.7071, 4),
    ("highshelf", 8000.0, 9.0, 0.7071, 4),
])
def test_filter_gain_kinds_match_oracle(rng, kind, freq, gain, q, budget):
    gold, dev = make_pair(rng, n=4000, nch=2)
    check_lsb(gold.filter(kind, freq, q, gain_db=gain),
              dev.filter(kind, freq, q, gain_db=gain), budget)


def test_eq_matches_oracle(rng):
    gold, dev = make_pair(rng, n=4000, nch=2, quiet=True)
    kw = dict(low_db=4.0, mid_db=-6.0, high_db=3.0, low_freq=150.0,
              mid_freq=900.0, mid_q=1.4, high_freq=5000.0)
    # low shelf + mid route through the ff scan, high shelf stays plain:
    # three chained scans, each ~1 LSB of the f64 oracle
    check_lsb(gold.eq(**kw), dev.eq(**kw), 4)


def test_eq_equals_chained_filters(rng):
    _, dev1 = make_pair(rng, n=3000, nch=2)
    rng2 = np.random.default_rng(0xC0FFEE)
    _, dev2 = make_pair(rng2, n=3000, nch=2)
    a = dev1.eq(low_db=3.0, mid_db=-4.0, high_db=2.0).get_frame_array()
    b = dev2.filter("lowshelf", 120.0, 0.7071, gain_db=3.0) \
            .filter("peaking", 1000.0, 1.0, gain_db=-4.0) \
            .filter("highshelf", 8000.0, 0.7071, gain_db=2.0) \
            .get_frame_array()
    np.testing.assert_array_equal(a, b)


def test_eq_zero_gain_bands_stage_nothing(rng):
    _, dev = make_pair(rng, n=2000, nch=2)
    before = dev.get_frame_array().copy()
    out = dev.eq().get_frame_array()      # all-zero gains: identity
    np.testing.assert_array_equal(out, before)


def test_peaking_gain_anchor():
    """First-principles: a sine at the peaking band's center frequency
    comes out boosted by gain_db (the RBJ |H| at w0 is exactly A^2 ...
    normalized a/b symmetry makes it 10^(gain/20))."""
    n = SR
    t = np.arange(n) / SR
    a = (0.1 * 32767.0 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.int16)
    dev = Sample.from_raw_frames(np.repeat(a[:, None], 2, 1).tobytes(),
                                 2, SR, 2)
    out = dev.filter("peaking", 1000.0, 2.0, gain_db=6.0).get_frame_array()
    seg = slice(n // 2, n)                # past the transient
    ratio = (np.sqrt(np.mean(out[seg, 0].astype(np.float64) ** 2))
             / np.sqrt(np.mean(np.asarray(a[seg], np.float64) ** 2)))
    assert abs(ratio - 10 ** (6.0 / 20.0)) < 0.03 * ratio


def test_shelf_gain_anchor():
    """A low-frequency sine through a +6 dB low shelf gains ~6 dB; the
    same sine through a high shelf centred far above it is untouched."""
    n = SR
    t = np.arange(n) / SR
    a = (0.1 * 32767.0 * np.sin(2 * np.pi * 80.0 * t)).astype(np.int16)
    dev1 = Sample.from_raw_frames(a.tobytes(), 2, SR, 1)
    dev2 = Sample.from_raw_frames(a.tobytes(), 2, SR, 1)
    seg = slice(n // 2, n)
    rms0 = np.sqrt(np.mean(np.asarray(a[seg], np.float64) ** 2))
    lo = dev1.filter("lowshelf", 500.0, gain_db=6.0).get_frame_array()
    hi = dev2.filter("highshelf", 8000.0, gain_db=6.0).get_frame_array()
    r_lo = np.sqrt(np.mean(lo[seg, 0].astype(np.float64) ** 2)) / rms0
    r_hi = np.sqrt(np.mean(hi[seg, 0].astype(np.float64) ** 2)) / rms0
    assert abs(r_lo - 10 ** (6.0 / 20.0)) < 0.05 * r_lo
    assert abs(r_hi - 1.0) < 0.02


def test_streaming_eq_chunk_invariance(rng):
    from synthesizer_tpu.effects import StreamingEQ
    x = rng.integers(-15000, 15000, size=(7000, 2)).astype(np.int16)
    kw = dict(low_db=4.0, mid_db=-5.0, high_db=3.0, mid_q=2.0)
    a = _chunked(lambda: StreamingEQ(SR, 2, **kw), x, [7000])
    b = _chunked(lambda: StreamingEQ(SR, 2, **kw), x, [997, 1024, 333])
    # the 120 Hz low-shelf poles sit near z=1: scan-regrouping error
    # follows the conditioning model (measured ~90 LSB on full-scale
    # noise, -51 dB relative)
    assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 192


# ---------------------------------------------------------------------------
# Feedback echo / stereo width / limiter / phaser (round-3 continuation)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nch", [1, 2])
def test_feedback_echo_matches_oracle(rng, nch):
    gold, dev = make_pair(rng, n=4000, nch=nch)
    kw = dict(delay=0.02, feedback=0.55, wet=0.6, dry=0.9)
    check_lsb(gold.feedback_echo(**kw), dev.feedback_echo(**kw), 1)


def test_feedback_echo_tail_rings_and_decays(rng):
    gold, dev = make_pair(rng, n=2000)
    n0 = 2000
    dev.feedback_echo(0.01, feedback=0.5, wet=0.5)
    got = dev.get_frame_array()
    assert got.shape[0] > n0                      # decay room appended
    D = int(0.01 * SR)
    tail = got[n0:]
    assert np.abs(tail[:2 * D]).max() > 0         # the train actually rings
    assert np.abs(tail[-D:]).max() <= 1           # and has decayed below 1 LSB


def test_feedback_echo_explicit_tail_and_validation(rng):
    _, dev = make_pair(rng, n=1000)
    n0 = dev.nframes
    dev.feedback_echo(0.01, feedback=0.5, wet=0.5, tail=0.1)
    assert dev.nframes == n0 + int(0.1 * SR)
    with pytest.raises(ValueError, match="feedback"):
        make_pair(np.random.default_rng(0))[1].feedback_echo(0.01,
                                                             feedback=0.99)


def test_feedback_echo_core_chunk_invariance(rng):
    import jax.numpy as jnp
    n, D = 6000, 700
    s = jnp.asarray(rng.normal(0, 0.3, (n, 2)).astype(np.float32))
    whole, _ = dfx.feedback_echo_core(s, D, 0.55,
                                      jnp.zeros((D, 2), jnp.float32))
    hist = jnp.zeros((D, 2), jnp.float32)
    outs, i = [], 0
    for cf in (977, 1536, 300, 2048, 3000):
        c = s[i:i + cf]
        if c.shape[0] == 0:
            break
        e, hist = dfx.feedback_echo_core(c, D, 0.55, hist)
        outs.append(np.asarray(e))
        i += int(c.shape[0])
    got = np.concatenate(outs)
    np.testing.assert_array_equal(got, np.asarray(whole)[:len(got)])


@pytest.mark.parametrize("amount", [0.0, 0.7, 1.0, 2.5])
def test_stereo_width_matches_oracle(rng, amount):
    gold, dev = make_pair(rng, n=3000)
    check_lsb(gold.stereo_width(amount), dev.stereo_width(amount), 1)


def test_stereo_width_semantics(rng):
    # amount=0 collapses to mono; amount=1 is (near-)identity
    _, dev = make_pair(rng, n=1000)
    a = dev.get_frame_array()
    mono = Sample.from_raw_frames(a.tobytes(), 2, SR, 2).stereo_width(0.0) \
        .get_frame_array()
    assert np.abs(mono[:, 0].astype(np.int64)
                  - mono[:, 1].astype(np.int64)).max() == 0
    unity = Sample.from_raw_frames(a.tobytes(), 2, SR, 2) \
        .stereo_width(1.0).get_frame_array()
    assert np.abs(unity.astype(np.int64) - a.astype(np.int64)).max() <= 1
    with pytest.raises(ValueError, match="stereo"):
        Sample.from_raw_frames(a[:, :1].tobytes(), 2, SR, 1) \
            .stereo_width(1.0)


@pytest.mark.parametrize("nch", [1, 2])
def test_limiter_matches_oracle(rng, nch):
    gold, dev = make_pair(rng, n=4000, nch=nch)
    kw = dict(ceiling_db=-3.0, release=0.05, lookahead=0.003)
    check_lsb(gold.limit(**kw), dev.limit(**kw), 2)


def test_limiter_is_brickwall_and_transparent(rng):
    from synthesizer_tpu.ops.coeffs import limiter_ceiling
    _, dev = make_pair(rng, n=4000)
    ceil_int = limiter_ceiling(-1.0, 2)
    out = dev.limit(ceiling_db=-1.0).get_frame_array()
    assert np.abs(out.astype(np.int64)).max() <= ceil_int
    # quiet audio passes ~untouched (gain pinned at 1)
    _, quiet = make_pair(np.random.default_rng(7), n=2000, quiet=True)
    a = quiet.get_frame_array()
    out = quiet.limit(ceiling_db=-1.0).get_frame_array()
    assert np.abs(out.astype(np.int64) - a.astype(np.int64)).max() <= 1


def test_limiter_lookahead_predips():
    # silence, then a full-scale spike: the gain must dip BEFORE the spike
    a = np.zeros((3000, 1), np.int16)
    a[2000] = 30000
    g = gfx.limiter_gains(a, 2, SR, -6.0, 0.05, 0.002)
    L = int(0.002 * SR)
    assert g[2000 - L] < 1.0          # dipping a full window early
    assert g[2000] < 0.6              # full reduction at the peak
    assert g[:2000 - L - 1].min() == 1.0


def test_phaser_matches_oracle(rng):
    gold, dev = make_pair(rng, n=4000)
    kw = dict(rate=0.8, depth=1.0, min_freq=300.0, max_freq=3000.0,
              stages=4, q=0.7071, wet=0.5, dry=1.0)
    check_lsb(gold.phaser(**kw), dev.phaser(**kw), 2 + 2 * 4)


def test_phaser_ff_routing_low_floor(rng):
    # sweep floors below ~120 Hz route through the float-float scan
    # (ops.coeffs.phaser_wants_ff) and hold ~1 LSB of the f64 oracle
    from synthesizer_tpu.ops.coeffs import phaser_wants_ff
    assert phaser_wants_ff(60.0) and not phaser_wants_ff(300.0)
    gold, dev = make_pair(rng, n=4000)
    kw = dict(rate=0.8, depth=1.0, min_freq=60.0, max_freq=2000.0,
              stages=4, q=1.0, wet=0.5, dry=1.0)
    check_lsb(gold.phaser(grids_dtype=np.float64, **kw), dev.phaser(**kw),
              2)


def test_phaser_validation(rng):
    _, dev = make_pair(rng, n=100)
    with pytest.raises(ValueError, match="stages"):
        dev.phaser(stages=0)
    with pytest.raises(ValueError, match="min_freq"):
        Sample.from_raw_frames(b"\0\0\0\0", 2, SR, 2).phaser(min_freq=20.0)


def test_new_fx_stage_lazily(rng):
    # the whole strip fuses into one program (echo/width/phaser/limit are
    # staged IR ops like the rest of the rack)
    _, dev = make_pair(rng, n=2000)
    with profiling.count_program_launches() as n:
        dev.feedback_echo(0.01, 0.4, 0.4, tail=0.05) \
           .phaser(rate=1.0).stereo_width(1.3).limit(-2.0)
        dev.get_frame_array()
    assert n[0] == 1


def test_compressor_soft_knee_matches_oracle():
    """knee_db > 0: the static curve's corner softens (second-order
    knee); a level ramp THROUGH the knee region pins the device twin to
    the oracle, and knee 0 keeps the hard-knee output bit-identical."""
    n = 8000
    t = np.arange(n) / SR
    amp = 10 ** (np.linspace(-40, -2, n) / 20.0)
    a = (np.sin(2 * np.pi * 220 * t) * amp * 32767.0).astype(np.int16)
    a = np.stack([a, a], axis=1)
    kw = dict(threshold_db=-15.0, ratio=4.0, attack=0.003, release=0.08,
              knee_db=12.0)
    gold = gs.Sample(a.copy(), SR, 2, 2).compress(**kw).frames
    dev = Sample.from_raw_frames(a.tobytes(), 2, SR, 2).compress(
        **kw).get_frame_array()
    assert np.abs(dev.astype(np.int64) - gold.astype(np.int64)).max() <= 2
    # the knee is audible vs the hard corner on the same signal
    hard = Sample.from_raw_frames(a.tobytes(), 2, SR, 2).compress(
        threshold_db=-15.0, ratio=4.0, attack=0.003,
        release=0.08).get_frame_array()
    assert np.abs(dev.astype(np.int64) - hard.astype(np.int64)).max() > 8
    # knee 0 IS the hard path (same program, untouched arithmetic)
    zero = Sample.from_raw_frames(a.tobytes(), 2, SR, 2).compress(
        threshold_db=-15.0, ratio=4.0, attack=0.003, release=0.08,
        knee_db=0.0).get_frame_array()
    np.testing.assert_array_equal(zero, hard)
    with pytest.raises(ValueError, match="knee_db"):
        Sample.from_raw_frames(a.tobytes(), 2, SR, 2).compress(knee_db=30.0)


def test_compressor_soft_knee_sidechain_and_streaming(rng):
    """The knee composes with ducking (sidechain detector) and the
    streaming twin carries it across chunks identically."""
    from synthesizer_tpu.effects import StreamingCompressor
    a = rng.integers(-20000, 20000, size=(6000, 2)).astype(np.int16)
    n = 6000
    t = np.arange(n) / SR
    kamp = 10 ** (np.linspace(-35, -3, n) / 20.0)
    key = (np.sin(2 * np.pi * 80 * t) * kamp * 32767.0).astype(np.int16)
    key = np.stack([key, key], axis=1)
    kw = dict(threshold_db=-12.0, ratio=8.0, knee_db=9.0)
    gold = gs.Sample(a.copy(), SR, 2, 2).compress(
        sidechain=gs.Sample(key.copy(), SR, 2, 2), **kw).frames
    dev = Sample.from_raw_frames(a.tobytes(), 2, SR, 2).compress(
        sidechain=Sample.from_raw_frames(key.tobytes(), 2, SR, 2),
        **kw).get_frame_array()
    assert np.abs(dev.astype(np.int64) - gold.astype(np.int64)).max() <= 2
    # streaming chunk invariance with the knee on (scan regrouping
    # budget, same as the hard-knee compressor: <= 2 LSB)
    whole = _chunked(lambda: StreamingCompressor(SR, **kw), a, [6000])
    parts = _chunked(lambda: StreamingCompressor(SR, **kw), a,
                     [977, 1536, 333])
    assert np.abs(whole.astype(np.int64)
                  - parts.astype(np.int64)).max() <= 2


@pytest.mark.parametrize("meth,kw", [
    ("tremolo", dict(rate=5.0, depth=0.7)),
    ("autopan", dict(rate=2.0, depth=0.9)),
])
def test_lfo_gain_fx_match_oracle(rng, meth, kw):
    """Tremolo / autopan: host-derived LFO grids through the house gain
    rule — bit-exact vs the oracle (same grid both sides), and the
    streaming twin is stateless in the absolute frame (chunk/seek
    invariant)."""
    from synthesizer_tpu import effects as fxmod
    a = rng.integers(-20000, 20000, size=(5000, 2)).astype(np.int16)
    gold = getattr(gs.Sample(a.copy(), SR, 2, 2), meth)(**kw).frames
    dev = getattr(Sample.from_raw_frames(a.tobytes(), 2, SR, 2),
                  meth)(**kw).get_frame_array()
    np.testing.assert_array_equal(dev, gold)
    cls = (fxmod.StreamingTremolo if meth == "tremolo"
           else fxmod.StreamingAutopan)
    whole = _chunked(lambda: cls(SR, 2, **kw), a, [5000])
    parts = _chunked(lambda: cls(SR, 2, **kw), a, [977, 333, 2048])
    np.testing.assert_array_equal(whole, parts)
    np.testing.assert_array_equal(whole, gold)
    with pytest.raises(ValueError, match="depth"):
        getattr(Sample.from_raw_frames(a.tobytes(), 2, SR, 2),
                meth)(depth=1.5)


def test_autopan_needs_stereo(rng):
    a = rng.integers(-1000, 1000, size=(100, 1)).astype(np.int16)
    with pytest.raises(ValueError, match="stereo"):
        Sample.from_raw_frames(a.tobytes(), 2, SR, 1).autopan()
