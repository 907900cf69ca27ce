"""VoiceBank batched render vs oracle rendering.

Non-FM bank voices must match the equivalent single-patch spec (rendered by
the goldref oracle) within 1 LSB at 16-bit.  FM voices follow the bank's
documented closed-form discrete-integral phase (module docstring of
models.voicebank) and are pinned against an independent float64 numpy twin.
The bank is stateless: chunk size and streaming cannot affect output.
"""

import math

import numpy as np
import pytest

import goldref.osc as go
from synthesizer_tpu.models import spec as S
from synthesizer_tpu.models.voicebank import (BankLayout, Voice, VoiceBank,
                                              pack_voices)

SR = 44100


def _pluck_shim(v: Voice, n: int) -> np.ndarray:
    """Spec twin of the BANK's pluck voice (goldref/spec.py docstring):
    absolute DDS phase but decay from the voice's start frame (the bank's
    n_rel = n - start convention).  Built on goldref hash primitives."""
    start = int(v.start * SR)
    K = max(1, _PLUCK_K)
    inc = int(round(v.frequency / SR * 2 ** 32)) & 0xFFFFFFFF
    ratio = np.float32(np.float32(inc) * np.float32(2.0 ** -32))
    active = [k for k in range(1, K + 1) if inc and k * inc < 2 ** 31]
    u = go.noise_values(np.asarray(active or [1], np.uint32), v.seed)
    denom = np.float32(max(np.abs(u.astype(np.float64)).sum(), 1e-30))
    nn = np.arange(n, dtype=np.int64)
    p0 = int(round((v.phase % 1.0) * 2 ** 32)) & 0xFFFFFFFF
    p = (np.uint64(p0) + nn.astype(np.uint64) * np.uint64(inc)) \
        & np.uint64(0xFFFFFFFF)
    nrel = np.maximum(nn - start, 0).astype(np.float32)
    acc = np.zeros(n, np.float32)
    for j, k in enumerate(active):
        a = np.float32(u[j] / denom)
        phi = go.noise_u32(np.asarray([K + k], np.uint32), v.seed)[0]
        g = np.float32(np.cos(np.float32(np.pi) * np.float32(k) * ratio))
        alpha = np.float32(np.float32(v.damping) * ratio
                           * np.log(max(g, np.float32(1e-30))))
        pk = (p * np.uint64(k) + np.uint64(phi)) & np.uint64(0xFFFFFFFF)
        x = pk.astype(np.uint32).astype(np.float32) * np.float32(2.0 ** -32)
        acc = acc + (a * np.exp(nrel * alpha)
                     * np.sin(np.float32(2 * np.pi) * x).astype(np.float32))
    return (np.float32(v.bias)
            + np.float32(v.amplitude) * acc).astype(np.float32)


#: harmonic budget the pluck shim mirrors (= the bank's num_harmonics)
_PLUCK_K = 4


def oracle_voice(v: Voice, n: int) -> np.ndarray:
    """Render one Voice -> stereo f32 [n, 2] via the goldref patch oracle
    (non-FM voices) or the closed-form f64 FM twin.

    Bank semantics: the oscillator phase runs from absolute sample 0
    (stateless closed form); the envelope is shifted to the voice's start
    frame and gates everything outside [start, start+total).
    """
    start = int(v.start * SR)
    if v.wave == "pluck":
        vals = _pluck_shim(v, n)
        g = go.envelope_gains(np.arange(n) - start, SR, _env_spec(v))
        mono = (vals * g).astype(np.float32)
        total = sum(_env_args(v)[:3]) + _env_args(v)[4]
        t = (np.arange(n) - start) / SR
        mono = np.where((t >= 0) & (t < total), mono, 0.0).astype(np.float32)
        lg = np.float32(min(1.0, 1.0 - v.pan))
        rg = np.float32(min(1.0, 1.0 + v.pan))
        return np.stack([mono * lg, mono * rg], axis=1)
    if v.fm_depth != 0.0:
        mono = _fm_twin(v, n)
        g = go.envelope_gains(np.arange(n) - start, SR, _env_spec(v))
        mono = (mono * g).astype(np.float32)
    else:
        kw = {}
        if v.wave == "pulse":
            kw["pulse_width"] = v.pulse_width
        if v.wave == "harmonics":
            kw["harmonics"] = tuple((float(i + 1), float(a))
                                    for i, a in enumerate(v.harmonics))
        if v.wave == "white_noise":
            kw["seed"] = v.seed
        if v.wave == "wavetable":
            from synthesizer_tpu.models.voicebank import bank_table
            kw["table"] = tuple(float(x) for x in bank_table(v.table))
            osc = S.Osc(v.wave, v.frequency or SR, v.amplitude, v.phase,
                        v.bias, **kw)
        else:
            osc = S.Osc(v.wave, v.frequency, v.amplitude, v.phase, v.bias, **kw)
        vals = go.render_oracle(osc, n, SR)
        g = go.envelope_gains(np.arange(n) - start, SR, _env_spec(v))
        mono = (vals * g).astype(np.float32)
    total = sum(_env_args(v)[:3]) + _env_args(v)[4]
    t = (np.arange(n) - start) / SR
    mono = np.where((t >= 0) & (t < total), mono, 0.0).astype(np.float32)
    lg = np.float32(min(1.0, 1.0 - v.pan))
    rg = np.float32(min(1.0, 1.0 + v.pan))
    return np.stack([mono * lg, mono * rg], axis=1)


def _env_args(v: Voice):
    gate = int(v.duration * SR) / SR
    sus = max(gate - v.attack - v.decay, 0.0)
    return (v.attack, v.decay, sus, v.sustain_level, v.release)


def _env_spec(v: Voice):
    a, d, s, sl, r = _env_args(v)
    return S.Envelope(S.Const(0.0), a, d, s, sl, r)


def _fm_twin(v: Voice, n: int) -> np.ndarray:
    """f64 closed-form FM phase: p_n = p0 + inc*n + inc*d*S_n."""
    inc = S.phase_increment(v.frequency, SR)
    finc = S.phase_increment(v.fm_frequency, SR)
    p0 = S.phase_offset(v.phase)
    fp0 = S.phase_offset(v.fm_phase)
    b = finc / 2**32
    phi = fp0 / 2**32
    k = np.arange(n, dtype=np.float64)
    s_n = ((math.cos(2 * math.pi * phi - math.pi * b)
            - np.cos(2 * np.pi * (b * k + phi) - math.pi * b))
           / (2 * math.sin(math.pi * b)))
    p = (p0 + inc * k + inc * v.fm_depth * s_n) % 2**32
    p_u32 = p.astype(np.uint64).astype(np.uint32)
    node = S.Osc(v.wave, v.frequency, v.amplitude, v.phase, v.bias,
                 pulse_width=getattr(v, "pulse_width", 0.5))
    w = go._wave_values(node, p_u32, SR, np.arange(n), None)
    return (np.float32(v.bias) + np.float32(v.amplitude) * w).astype(np.float32)


VOICES = [
    Voice("sine", 440.0, amplitude=0.3, pan=-0.5, duration=0.3),
    Voice("triangle", 220.0, amplitude=0.25, pan=0.5, duration=0.3, phase=0.2),
    Voice("square", 110.0, amplitude=0.2, duration=0.25),
    Voice("sawtooth", 330.0, amplitude=0.2, duration=0.25, pan=0.3),
    Voice("pulse", 165.0, amplitude=0.2, pulse_width=0.3, duration=0.3),
    Voice("semicircle", 550.0, amplitude=0.2, duration=0.2),
    Voice("pointy", 660.0, amplitude=0.2, duration=0.2, pan=-0.2),
    Voice("sine", 880.0, amplitude=0.3, fm_frequency=6.0, fm_depth=0.02,
          duration=0.3),
    Voice("harmonics", 110.0, amplitude=0.3, harmonics=[1.0, 0.5, 0.25, 0.125],
          duration=0.3),
    Voice("white_noise", 0.0, amplitude=0.15, duration=0.2, seed=9),
    Voice("white_noise", 5000.0, amplitude=0.15, duration=0.2, seed=11),
]


def _oracle_sum(n):
    want = np.zeros((n, 2), np.float32)
    for v in VOICES:
        want = want + oracle_voice(v, n)
    return want


def test_bank_matches_oracle_sum():
    n = SR // 4
    vp = pack_voices(VOICES, SR, num_harmonics=8)
    bank = VoiceBank(vp.base_inc.shape[0], SR, chunk_frames=2048, num_harmonics=8)
    got = np.asarray(bank.render_song(vp, n))
    want = _oracle_sum(n)
    got16 = np.clip(np.rint(got * 32767.0), -32768, 32767)
    want16 = np.clip(np.rint(want * 32767.0), -32768, 32767)
    d = np.abs(got16 - want16).max()
    # f32-exact mix: only per-voice quantization + summation order remain
    # (a loose bound here would mask reduced-precision matmul inputs)
    assert d <= 3, f"max diff {d}"


def test_grouped_layout_matches_oracle_sum():
    n = SR // 4
    vp, layout = pack_voices(VOICES, SR, num_harmonics=8, sort_by_wave=True)
    bank = VoiceBank.for_voices(VOICES, SR, chunk_frames=2048,
                                num_harmonics=8, layout=layout,
                                nvoices=layout.nvoices)
    got = np.asarray(bank.render_song(vp, n))
    want = _oracle_sum(n)
    got16 = np.clip(np.rint(got * 32767.0), -32768, 32767)
    want16 = np.clip(np.rint(want * 32767.0), -32768, 32767)
    assert np.abs(got16 - want16).max() <= 3


def test_bank_chunk_invariance():
    vp = pack_voices(VOICES, SR, num_harmonics=8)
    n = 12000
    a = np.asarray(VoiceBank(0, SR, chunk_frames=512, num_harmonics=8).render_song(vp, n))
    b = np.asarray(VoiceBank(0, SR, chunk_frames=4096, num_harmonics=8).render_song(vp, n))
    np.testing.assert_array_equal(a, b)


def test_bank_streaming_matches_offline():
    vp = pack_voices(VOICES, SR, num_harmonics=8)
    bank = VoiceBank(0, SR, chunk_frames=1024, num_harmonics=8)
    off = np.asarray(bank.render_song(vp, 8 * 1024))
    outs = [np.asarray(bank.render_chunk(vp, i * 1024)) for i in range(8)]
    np.testing.assert_array_equal(np.concatenate(outs), off)


def test_start_offset_and_silence_before():
    v = [Voice("sine", 440.0, amplitude=0.5, start=0.1, duration=0.1)]
    vp = pack_voices(v, SR)
    bank = VoiceBank(0, SR, chunk_frames=1024)
    out = np.asarray(bank.render_song(vp, SR // 2))
    pre = out[:int(0.1 * SR) - 1]
    assert np.abs(pre).max() == 0.0
    active = out[int(0.11 * SR):int(0.15 * SR)]
    assert np.abs(active).max() > 0.1


def test_to_int16_saturates():
    bank = VoiceBank(0, SR)
    x = np.array([[2.0, -2.0], [0.5, -0.5]], np.float32)
    y = np.asarray(bank.to_int16(x))
    assert y[0, 0] == 32767 and y[0, 1] == -32768
    assert y[1, 0] in (16383, 16384)


def test_bandlimited_bank_voice():
    vs = [Voice("sawtooth_bl", 2000.0, amplitude=0.5, duration=0.15),
          Voice("square_bl", 3000.0, amplitude=0.4, duration=0.15, pan=0.5)]
    vp, layout = pack_voices(vs, SR, num_harmonics=0, sort_by_wave=True)
    bank = VoiceBank.for_voices(vs, SR, chunk_frames=1024, num_harmonics=0,
                                layout=layout, nvoices=layout.nvoices)
    got = np.asarray(bank.render_song(vp, 8192))
    want = np.zeros((8192, 2), np.float32)
    for v in vs:
        want = want + oracle_voice(v, 8192)
    g16 = np.clip(np.rint(got * 32767), -32768, 32767)
    w16 = np.clip(np.rint(want * 32767), -32768, 32767)
    assert np.abs(g16 - w16).max() <= 3


def test_adsr_zero_segment_edges():
    """Zero attack/decay/release boundary samples match the oracle exactly
    (regression guard for the min/max envelope form)."""
    for v in (Voice("sine", 441.0, amplitude=0.5, duration=0.1,
                    attack=0.0, decay=0.02, sustain_level=0.6, release=0.05),
              Voice("sine", 441.0, amplitude=0.5, duration=0.1,
                    attack=0.01, decay=0.0, sustain_level=0.6, release=0.05),
              Voice("sine", 441.0, amplitude=0.5, duration=0.1,
                    attack=0.01, decay=0.02, sustain_level=0.6, release=0.0),
              Voice("sine", 441.0, amplitude=0.5, duration=0.005,
                    attack=0.01, decay=0.05, sustain_level=0.6, release=0.02)):
        vp = pack_voices([v], SR)
        bank = VoiceBank(0, SR, chunk_frames=2048)
        got = np.asarray(bank.render_song(vp, 8192))
        want = oracle_voice(v, 8192)
        g16 = np.clip(np.rint(got * 32767), -32768, 32767)
        w16 = np.clip(np.rint(want * 32767), -32768, 32767)
        assert np.abs(g16 - w16).max() <= 1, v


WAVE_POOL = ["sine", "triangle", "square", "sawtooth", "pulse", "pointy",
             "semicircle", "harmonics", "white_noise", "sawtooth_bl",
             "square_bl", "wavetable", "pluck"]


def rand_voice(rng):
    wave = WAVE_POOL[rng.integers(len(WAVE_POOL))]
    kw = {}
    if wave == "harmonics":
        kw["harmonics"] = [1.0, 0.5, 0.25]
    if wave == "pulse":
        kw["pulse_width"] = float(rng.uniform(0.1, 0.9))
    if wave == "white_noise":
        kw["seed"] = int(rng.integers(0, 1000))
    if wave == "wavetable":
        kw["table"] = tuple(float(x) for x in
                            rng.uniform(-1, 1, int(rng.integers(3, 300))))
    if wave == "pluck":
        kw["seed"] = int(rng.integers(0, 1000))
        kw["damping"] = float(rng.uniform(0.3, 3.0))
    fm = wave in ("sine", "triangle") and rng.random() < 0.4
    return Voice(
        wave=wave, frequency=float(rng.uniform(40, 2000)),
        amplitude=float(rng.uniform(0.05, 0.3)),
        phase=float(rng.uniform(0, 1)),
        pan=float(rng.uniform(-1, 1)),
        start=float(rng.uniform(0, 0.05)),
        duration=float(rng.uniform(0.02, 0.15)),
        attack=float(rng.uniform(0, 0.02)),
        decay=float(rng.uniform(0, 0.04)),
        sustain_level=float(rng.uniform(0.2, 1.0)),
        release=float(rng.uniform(0.005, 0.05)),
        fm_frequency=float(rng.uniform(1, 12)) if fm else 0.0,
        fm_depth=float(rng.uniform(0.002, 0.03)) if fm else 0.0,
        **kw)


@pytest.mark.parametrize("seed", range(6))
def test_random_bank_matches_oracle(seed):
    rng = np.random.default_rng(seed + 9000)
    voices = [rand_voice(rng) for _ in range(int(rng.integers(4, 16)))]
    n = 8192
    vp, layout = pack_voices(voices, SR, num_harmonics=4, sort_by_wave=True)
    bank = VoiceBank.for_voices(voices, SR, chunk_frames=1024, num_harmonics=4,
                                layout=layout, nvoices=layout.nvoices)
    got = np.asarray(bank.render_song(vp, n))
    want = np.zeros((n, 2), np.float32)
    for v in voices:
        want = want + oracle_voice(v, n)
    g16 = np.clip(np.rint(got * 32767), -32768, 32767)
    w16 = np.clip(np.rint(want * 32767), -32768, 32767)
    d = np.abs(g16 - w16)
    tol = 2 + len(voices) // 4
    assert (d > tol).mean() < 1e-4, \
        f"seed {seed}: {(d > tol).sum()} beyond {tol}, max {d.max()}"


def test_short_gate_envelope():
    """Gate shorter than attack+decay with a small release: regression for
    the min-of-lines envelope bug (release must wait until attack+decay
    finish, not start wherever its line crosses them)."""
    v = Voice("sine", 441.0, amplitude=0.5, duration=0.02,
              attack=0.015, decay=0.013, sustain_level=0.58, release=0.038)
    vp = pack_voices([v], SR)
    bank = VoiceBank(0, SR, chunk_frames=2048)
    got = np.asarray(bank.render_song(vp, 4096))
    want = oracle_voice(v, 4096)
    g16 = np.clip(np.rint(got * 32767), -32768, 32767)
    w16 = np.clip(np.rint(want * 32767), -32768, 32767)
    assert np.abs(g16 - w16).max() <= 1


# ---------------------------------------------------------------------------
# Portamento (glide) — exact integer-DDS chirp
# ---------------------------------------------------------------------------

def _glide_phase_twin(freq, glide_from, glide_time, start, sr, total):
    """Exact Python-int twin of _phases' glide closed form (mod 2^32)."""
    inc0 = int(S.phase_increment(glide_from, sr))
    inc1 = int(S.phase_increment(freq, sr))
    G = max(1, int(glide_time * sr))
    d = (inc1 - inc0) // G
    n = np.arange(total, dtype=object)
    m = n - int(start * sr)
    tri = [(int(x) * (int(x) - 1)) // 2 for x in m]
    triG = (G * (G - 1)) // 2
    ph = [
        (inc0 * int(mm) + d * tt) if mm < G
        else (inc0 * G + d * triG + (int(mm) - G) * (inc0 + d * G))
        for mm, tt in zip(m, tri)]
    return np.asarray([p % (2 ** 32) for p in ph], np.float64)


def test_glide_matches_integer_twin():
    sr = 44100
    v = Voice(wave="sine", frequency=880.0, glide_from=220.0,
              glide_time=0.05, start=0.01, duration=0.3, amplitude=0.5,
              attack=0.0, decay=0.0, sustain_level=1.0, release=0.01)
    vp, layout = pack_voices([v], sr, sort_by_wave=True)
    bank = VoiceBank.for_voices([v], sr, layout=layout,
                                nvoices=layout.nvoices)
    assert bank.use_glide
    total = int(0.35 * sr)
    out = np.asarray(bank.render_song(vp, total))[:, 0]
    ph = _glide_phase_twin(880.0, 220.0, 0.05, 0.01, sr, total)
    ref = 0.5 * np.sin(2 * np.pi * ph / 2 ** 32)
    start = int(0.01 * sr)
    lo, hi = start + 100, start + int(0.29 * sr)   # inside the sustain
    # f32 sine evaluation is the only error source (phase is exact)
    assert np.max(np.abs(out[lo:hi] - ref[lo:hi])) < 1e-6


def test_glide_downward_and_landing_increment():
    # downward glide (negative step, floor division) must land within
    # G phase units of the target increment and hold steady after
    sr = 44100
    v = Voice(wave="sine", frequency=110.0, glide_from=440.0,
              glide_time=0.02, start=0.0, duration=0.5, amplitude=0.5,
              attack=0.0, decay=0.0, sustain_level=1.0, release=0.01)
    vp, layout = pack_voices([v], sr, sort_by_wave=True)
    bank = VoiceBank.for_voices([v], sr, layout=layout,
                                nvoices=layout.nvoices)
    out = np.asarray(bank.render_song(vp, int(0.5 * sr)))[:, 0]
    seg = out[int(0.2 * sr):int(0.45 * sr)]
    zc = np.where((seg[:-1] < 0) & (seg[1:] >= 0))[0]
    f = sr / np.mean(np.diff(zc))
    assert abs(f - 110.0) < 0.5


def test_no_glide_banks_untouched():
    # a glide-free bank must compile WITHOUT the glide formula and render
    # exactly as before (use_glide=False is the static default)
    sr = 44100
    v = Voice(wave="sine", frequency=440.0, duration=0.1)
    vp, layout = pack_voices([v], sr, sort_by_wave=True)
    bank = VoiceBank.for_voices([v], sr, layout=layout,
                                nvoices=layout.nvoices)
    assert not bank.use_glide
    out = np.asarray(bank.render_song(vp, 4410))
    assert np.abs(out).max() > 0.1


# ---------------------------------------------------------------------------
# Pitch/amp curves (continuous MIDI bend / CC) + glide refinements — round 4
# ---------------------------------------------------------------------------

def test_glide_pluck_excluded():
    # pluck's spectral decay rates are tied to ONE pitch, so glide is
    # excluded by construction: a glided pluck renders EXACTLY as the
    # same voice without glide (target pitch)
    sr = 44100
    base = dict(wave="pluck", frequency=440.0, start=0.005, duration=0.3,
                amplitude=0.5, seed=7)
    vg = Voice(glide_from=110.0, glide_time=0.05, **base)
    vn = Voice(**base)
    vpg, lyg = pack_voices([vg], sr, sort_by_wave=True)
    vpn, lyn = pack_voices([vn], sr, sort_by_wave=True)
    bg = VoiceBank.for_voices([vg], sr, layout=lyg, nvoices=lyg.nvoices)
    bn = VoiceBank.for_voices([vn], sr, layout=lyn, nvoices=lyn.nvoices)
    assert bg.use_glide and not bn.use_glide
    a = np.asarray(bg.render_song(vpg, 8192))
    b = np.asarray(bn.render_song(vpn, 8192))
    assert np.array_equal(a, b)


def test_glide_blep_dt_tracks_instantaneous_pitch():
    # long upward glide on sawtooth_bl: with dt from base_inc (the old
    # behavior) the BLEP window early in the glide is ~16x too wide; the
    # fixed engine must match an f64 twin that uses the instantaneous
    # increment.  Compare early in the glide where the discrepancy is
    # largest; a few isolated samples may still flip the BLEP branch
    # (f32 vs f64 boundary compare), so assert on the 99.9th percentile.
    sr = 44100
    v = Voice(wave="sawtooth_bl", frequency=1760.0, glide_from=110.0,
              glide_time=0.2, start=0.0, duration=0.4, amplitude=0.5,
              attack=0.0, decay=0.0, sustain_level=1.0, release=0.01)
    vp, layout = pack_voices([v], sr, sort_by_wave=True)
    bank = VoiceBank.for_voices([v], sr, layout=layout,
                                nvoices=layout.nvoices)
    total = int(0.1 * sr)
    out = np.asarray(bank.render_song(vp, total))[:, 0]

    ph = _glide_phase_twin(1760.0, 110.0, 0.2, 0.0, sr, total)
    inc0 = int(S.phase_increment(110.0, sr))
    inc1 = int(S.phase_increment(1760.0, sr))
    G = int(0.2 * sr)
    d = (inc1 - inc0) // G
    m = np.arange(total)
    inc_inst = (inc0 + np.minimum(m, G) * d) % 2 ** 32

    x = ph / 2 ** 32
    dt = np.maximum(inc_inst / 2 ** 32, 1e-9)
    u0 = x / dt
    lo = 2 * u0 - u0 * u0 - 1
    u1 = (x - 1) / dt
    hi = u1 * u1 + 2 * u1 + 1
    blep = np.where(x < dt, lo, np.where(x > 1 - dt, hi, 0.0))
    ref = 0.5 * ((2 * x - 1) - blep)
    err = np.abs(out - ref)
    assert np.quantile(err, 0.999) < 1e-5
    # and the OLD dt (base_inc) twin must clearly NOT match — proves the
    # test discriminates
    dt_old = np.full(total, inc1 / 2 ** 32)
    u0o = x / dt_old
    lo_o = 2 * u0o - u0o * u0o - 1
    u1o = (x - 1) / dt_old
    hi_o = u1o * u1o + 2 * u1o + 1
    blep_o = np.where(x < dt_old, lo_o, np.where(x > 1 - dt_old, hi_o, 0.0))
    ref_old = 0.5 * ((2 * x - 1) - blep_o)
    assert np.quantile(np.abs(out - ref_old), 0.999) > 1e-3


def test_pitch_curve_matches_integer_twin():
    # piecewise chirp segments vs an independent per-frame iterative
    # integer DDS (ground truth) — phase exact, f32 sine eval only
    from synthesizer_tpu.models.voicebank import compile_pitch_segments
    sr = 44100
    curve = ((0.0, 1.0), (0.05, 1.5), (0.09, 1.5), (0.14, 0.75))
    v = Voice(wave="sine", frequency=440.0, pitch_curve=curve, start=0.01,
              duration=0.3, amplitude=0.5, attack=0.0, decay=0.0,
              sustain_level=1.0, release=0.01)
    vp, layout = pack_voices([v], sr, sort_by_wave=True)
    bank = VoiceBank.for_voices([v], sr, layout=layout,
                                nvoices=layout.nvoices)
    assert bank.use_bend and not bank.use_glide
    total = int(0.35 * sr)
    out = np.asarray(bank.render_song(vp, total))[:, 0]

    starts, phases, incs, ds = compile_pitch_segments(curve, 440.0, sr)
    start_f = int(0.01 * sr)
    ph, phs = 0, {}
    for m in range(total - start_f + 1):
        phs[m] = ph
        cur = 0
        while cur + 1 < len(starts) and m >= starts[cur + 1]:
            cur += 1
        ph = (ph + incs[cur] + (m - starts[cur]) * ds[cur]) % (2 ** 32)
    lo, hi = start_f + 10, start_f + int(0.29 * sr)
    ref = 0.5 * np.sin(2 * np.pi * np.array(
        [phs[m - start_f] for m in range(lo, hi)], np.float64) / 2 ** 32)
    assert np.max(np.abs(out[lo:hi] - ref)) < 1e-6


def test_pitch_curve_streaming_equals_offline():
    # statelessness: chunked renders at arbitrary n0 == offline slices
    sr = 44100
    v = Voice(wave="triangle", frequency=220.0,
              pitch_curve=((0.0, 1.0), (0.1, 2.0)), start=0.0,
              duration=0.25, amplitude=0.5)
    vp, layout = pack_voices([v], sr, sort_by_wave=True)
    bank = VoiceBank.for_voices([v], sr, chunk_frames=1024, layout=layout,
                                nvoices=layout.nvoices)
    song = np.asarray(bank.render_song(vp, 8192))
    for n0 in (0, 1024, 3072, 7168):
        chunk = np.asarray(bank.render_chunk(vp, n0))
        assert np.array_equal(chunk, song[n0:n0 + 1024])


def test_amp_curve_matches_f64_twin():
    sr = 44100
    curve = ((0.0, 1.0), (0.05, 0.2), (0.1, 0.6))
    v = Voice(wave="sine", frequency=440.0, amp_curve=curve, start=0.01,
              duration=0.25, amplitude=0.5, attack=0.0, decay=0.0,
              sustain_level=1.0, release=0.01)
    vp, layout = pack_voices([v], sr, sort_by_wave=True)
    bank = VoiceBank.for_voices([v], sr, layout=layout,
                                nvoices=layout.nvoices)
    assert bank.use_amp and not bank.use_bend
    total = int(0.3 * sr)
    out = np.asarray(bank.render_song(vp, total))[:, 0]
    start_f = int(0.01 * sr)
    inc = int(S.phase_increment(440.0, sr))
    n = np.arange(total, dtype=np.uint64)
    ph = (n * inc) % 2 ** 32
    m = np.arange(total) - start_f
    pts = [(int(t * sr), g) for t, g in curve]
    g = np.ones(total)
    for j, (f0, g0) in enumerate(pts):
        if j + 1 < len(pts):
            f1, g1 = pts[j + 1]
            sel = (m >= f0) & (m < f1)
            g[sel] = g0 + (m[sel] - f0) * (g1 - g0) / (f1 - f0)
        else:
            g[m >= f0] = g0
    ref = 0.5 * np.sin(2 * np.pi * ph / 2 ** 32) * g
    lo, hi = start_f + 10, start_f + int(0.24 * sr)
    g16 = np.clip(np.rint(out[lo:hi] * 32767), -32768, 32767)
    w16 = np.clip(np.rint(ref[lo:hi] * 32767), -32768, 32767)
    assert np.abs(g16 - w16).max() <= 1


def test_curves_reject_glide_mix():
    sr = 44100
    bad = Voice(wave="sine", frequency=440.0, glide_from=220.0,
                glide_time=0.05, pitch_curve=((0.0, 1.0), (0.1, 2.0)))
    with pytest.raises(ValueError, match="mutually exclusive"):
        pack_voices([bad], sr)


def test_curve_decimation_caps_segments():
    from synthesizer_tpu.models.voicebank import (MAX_CURVE_SEGS,
                                                  compile_pitch_segments)
    sr = 44100
    curve = [(i * 0.001, 1.0 + 0.0001 * i) for i in range(1000)]
    starts, phases, incs, ds = compile_pitch_segments(curve, 440.0, sr)
    assert len(starts) <= MAX_CURVE_SEGS
    assert starts[0] == 0 and starts[-1] == int(0.999 * sr)
