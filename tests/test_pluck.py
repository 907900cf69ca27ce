"""Karplus-Strong pluck (spectral form) across every surface: graph engine
vs goldref oracle, voice bank vs the spec shim, WaveSynth/oscillators API,
and sequencer [synth.*] wave=pluck tracks.

Numeric spec: goldref/spec.py docstring ("Pluck" bullet).  The classic KS
delay-line + averager loop is evaluated closed-form: each harmonic k of a
seeded random excitation decays as cos(pi*k*f/sr) per period — batched
over harmonics, stateless over time (data-parallel; no sequential recurrence).
"""

import numpy as np
import pytest

import goldref.osc as go
from synthesizer_tpu import WaveSynth, oscillators as osc
from synthesizer_tpu.models import graph as G
from synthesizer_tpu.models import spec as S
from synthesizer_tpu.models.voicebank import Voice, VoiceBank, pack_voices
from synthesizer_tpu.sequencer import Song, SynthDef

SR = 44100


@pytest.mark.parametrize("freq,K,seed,damp", [
    (220.0, 16, 3, 1.0),
    (110.0, 32, 7, 2.5),
    (1000.0, 24, 1, 0.5),
    (82.4, 48, 12, 1.0),     # low E: dense harmonics
    (15000.0, 8, 2, 1.0),    # most harmonics above Nyquist
])
def test_graph_pluck_matches_oracle(freq, K, seed, damp):
    node = S.Osc("pluck", freq, amplitude=0.8, phase=0.1,
                 num_harmonics=K, seed=seed, damping=damp)
    n = SR // 2
    want = go.to_int_samples(go.render_oracle(node, n, SR), 2)
    got = np.asarray(G.to_int_device(G.render_patch(node, n, SR, 4096), 2))
    d = np.abs(want.astype(np.int64) - got.astype(np.int64)).max()
    assert d <= 1, d


def test_pluck_decays_like_a_string():
    """Physics: the tail is quieter than the attack, and higher damping
    decays faster (the KS loop-loss ordering)."""
    s1 = np.asarray(G.render_patch(
        S.Osc("pluck", 220.0, num_harmonics=24, seed=5, damping=1.0),
        SR, SR, 8192))
    s3 = np.asarray(G.render_patch(
        S.Osc("pluck", 220.0, num_harmonics=24, seed=5, damping=4.0),
        SR, SR, 8192))
    def rms(x):
        return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))
    head1, tail1 = rms(s1[:4410]), rms(s1[-8820:])
    head3, tail3 = rms(s3[:4410]), rms(s3[-8820:])
    assert tail1 < head1 * 0.8
    # more damping decays faster (mostly the high harmonics — the
    # fundamental's loop loss cos(pi*f/sr) is tiny, so the gap is modest)
    assert tail3 < tail1
    assert np.abs(s1).max() <= 1.0 + 1e-6   # unit-peak excitation norm


def test_pluck_nyquist_mask_silences_ultrasonics():
    """At f > sr/2 every harmonic is masked: exact silence, no aliasing."""
    out = np.asarray(G.render_patch(
        S.Osc("pluck", 30000.0, num_harmonics=16, seed=1), 4096, SR, 4096))
    assert np.abs(out).max() == 0.0


def test_wavesynth_pluck_surface():
    ws = WaveSynth(samplerate=SR, samplewidth=2)
    s = ws.pluck(220.0, duration=0.5, amplitude=0.6, seed=4)
    assert s.nframes == SR // 2
    a = s.get_frame_array()
    assert np.abs(a).max() > 1000
    # gen variant streams the same signal
    chunks = []
    gen = ws.pluck_gen(220.0, amplitude=0.6, seed=4)
    while sum(len(c.get_frame_array()) for c in chunks) < s.nframes:
        chunks.append(next(gen))
    whole = np.concatenate([c.get_frame_array() for c in chunks])[:s.nframes]
    # blocksize changes the XLA program shape: the exp*sin multiply-add
    # chain may contract to FMA differently (documented <=1 LSB class,
    # docs/NUMERICS.md) — isolated samples only
    d = np.abs(whole.astype(np.int64) - a.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_oscillator_pluck_through_render():
    ws = WaveSynth(samplerate=SR, samplewidth=2)
    voice = osc.EnvelopeFilter(osc.Pluck(330.0, seed=2, damping=1.5),
                               0.005, 0.02, 0.4, 0.7, 0.1)
    s = ws.render_oscillator(voice, 0.6)
    assert s.nframes == int(0.6 * SR)
    assert np.abs(s.get_frame_array()).max() > 500


def test_bank_pluck_matches_spec_shim():
    """Banked pluck voices (decay from the NOTE start, absolute phase)
    match the numpy spec twin within 1 LSB."""
    from tests.test_voicebank import oracle_voice
    voices = [
        Voice(wave="pluck", frequency=196.0, amplitude=0.3, start=0.0,
              duration=0.3, attack=0.0, decay=0.0, sustain_level=1.0,
              release=0.05, seed=3, damping=1.0, pan=-0.4),
        Voice(wave="pluck", frequency=294.0, amplitude=0.25, start=0.1,
              duration=0.25, attack=0.002, decay=0.01, sustain_level=0.8,
              release=0.04, seed=8, damping=2.0, pan=0.4),
    ]
    n = SR // 2
    vp, layout = pack_voices(voices, SR, num_harmonics=4, sort_by_wave=True)
    bank = VoiceBank.for_voices(voices, SR, chunk_frames=2048,
                                num_harmonics=4, layout=layout,
                                nvoices=layout.nvoices)
    got = np.asarray(bank.render_song(vp, n))
    want = np.zeros((n, 2), np.float32)
    for v in voices:
        want = want + oracle_voice(v, n)
    g16 = np.clip(np.rint(got * 32767), -32768, 32767)
    w16 = np.clip(np.rint(want * 32767), -32768, 32767)
    assert np.abs(g16 - w16).max() <= 1


def test_bank_pluck_chunk_invariant():
    v = Voice(wave="pluck", frequency=220.0, amplitude=0.4, start=0.02,
              duration=0.4, seed=6)
    n = 8192
    outs = []
    for cf in (512, 4096):
        vp, layout = pack_voices([v], SR, num_harmonics=4, sort_by_wave=True)
        bank = VoiceBank.for_voices([v], SR, chunk_frames=cf,
                                    num_harmonics=4, layout=layout,
                                    nvoices=layout.nvoices)
        outs.append(np.asarray(bank.render_song(vp, n)))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_sequencer_pluck_track(tmp_path):
    ini = tmp_path / "song.ini"
    ini.write_text("""
[song]
bpm = 120
ticks = 4
patterns = a
[synth.gtr]
wave = pluck
amplitude = 0.4
damping = 1.5
seed = 9
attack = 0.0
decay = 0.0
sustain_level = 1.0
release = 0.08
[pattern.a]
gtr = E3 .. A3 .. D4 .. G4 ..
""")
    song = Song.from_ini(str(ini))
    assert song.synths["gtr"].wave == "pluck"
    assert song.synths["gtr"].damping == 1.5
    assert song.synths["gtr"].seed == 9
    off = song.mix(normalize=False, tail_seconds=0.1).get_frame_array()
    assert np.abs(off).max() > 500
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=1470)])
    np.testing.assert_array_equal(got, off[:len(got)])
