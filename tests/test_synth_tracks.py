"""Melodic synth tracks in the sequencer (beyond-reference feature)."""

import os

import numpy as np
import pytest

from synthesizer_tpu import Sample, WaveSynth, note_freq
from synthesizer_tpu.sequencer import Song, SynthDef

SR = 44100


def make_song(with_drums=True):
    song = Song()
    song.bpm = 240
    song.ticks = 4
    if with_drums:
        synth = WaveSynth(samplerate=SR, samplewidth=2)
        kick = synth.sine(60.0, 0.1, amplitude=0.8).fadeout(0.06).stereo()
        song.add_instrument("kick", kick)
    song.add_synth("lead", SynthDef(wave="square_bl", amplitude=0.3,
                                    attack=0.005, decay=0.02,
                                    sustain_level=0.7, release=0.05, pan=0.3))
    song.add_synth("bass", SynthDef(wave="sine", amplitude=0.4,
                                    release=0.08, pan=-0.2))
    tracks = {
        "lead": "C4 .. E4 G4 -  -  .. C5",
        "bass": "C2 -  -  -  G2 -  -  - ",
    }
    if with_drums:
        tracks["kick"] = "x.x. x.x."
    song.add_pattern("a", tracks)
    song.pattern_sequence = ["a", "a"]
    return song


def test_voice_compilation():
    song = make_song(with_drums=False)
    voices = song.compile_synth_voices()
    # per bar: lead C4, E4, G4(tied x3), C5 = 4; bass C2(x4), G2(x4) = 2
    assert len(voices) == 2 * 6
    tick = song.tick_duration
    lead_g4 = [v for v in voices if abs(v.frequency - note_freq("G4")) < 0.01]
    assert len(lead_g4) == 2
    assert lead_g4[0].duration == pytest.approx(3 * tick)
    bass = [v for v in voices if abs(v.frequency - note_freq("C2")) < 0.01]
    assert bass[0].duration == pytest.approx(4 * tick)
    assert bass[0].start == pytest.approx(0.0)
    # second bar starts after 8 ticks
    assert lead_g4[1].start == pytest.approx((8 + 3) * tick)


def test_synth_only_song_mixes():
    song = make_song(with_drums=False)
    mixed = song.mix(normalize=False)
    a = mixed.get_frame_array()
    assert mixed.nchannels == 2
    assert np.abs(a).max() > 3000
    # pan: lead is right-leaning, bass left-leaning; both channels sound
    assert np.abs(a[:, 0]).max() > 1000 and np.abs(a[:, 1]).max() > 1000


def test_combined_song_streaming_equals_offline():
    song = make_song(with_drums=True)
    offline = song.mix(normalize=False)
    chunks = [c.get_frame_array() for c in song.mix_generator(chunk_frames=1024)]
    got = np.concatenate(chunks)
    np.testing.assert_array_equal(got, offline.get_frame_array()[:len(got)])


def test_ini_with_synth_sections(tmp_path):
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    instdir = tmp_path / "s"
    instdir.mkdir()
    synth.sine(60.0, 0.1, amplitude=0.8).stereo().write_wav(str(instdir / "kick.wav"))
    ini = tmp_path / "song.ini"
    ini.write_text("""
[song]
bpm = 240
ticks = 4
patterns = a

[paths]
samples = s/

[instruments]
kick = kick.wav

[synth.lead]
wave = square_bl
amplitude = 0.3
release = 0.05
pan = 0.3

[pattern.a]
kick = x.x. x.x.
lead = C#4 .. E4 G4 - - .. C5
""")
    song = Song.from_ini(str(ini))
    assert "lead" in song.synths
    assert song.synths["lead"].wave == "square_bl"
    voices = song.compile_synth_voices()
    assert any(abs(v.frequency - note_freq("C#4")) < 0.01 for v in voices)
    mixed = song.mix()
    assert mixed.duration > 0.5


def test_wavetable_synth_track_end_to_end():
    """A [synth.*] wavetable track renders through the batched bank and
    matches the per-voice oracle (bank_table canonicalization shared)."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_voicebank as T
    from synthesizer_tpu.sequencer import Song, SynthDef
    table = (0.0, 0.9, 0.3, -0.6, -1.0, -0.2)
    song = Song()
    song.bpm = 240
    song.ticks = 4
    song.add_synth("wt", SynthDef(wave="wavetable", amplitude=0.4,
                                  release=0.05, table=table))
    song.add_pattern("a", {"wt": "C4 - E4 - G4 - - -"})
    song.pattern_sequence = ["a"]
    mixed = song.mix(normalize=False)
    got = mixed.get_frame_array()
    assert np.abs(got).max() > 3000
    voices = song.compile_synth_voices()
    assert all(v.wave == "wavetable" and v.table == table for v in voices)
    n = got.shape[0]
    want = np.zeros((n, 2), np.float32)
    for v in voices:
        want = want + T.oracle_voice(v, n)
    w16 = np.clip(np.rint(want.astype(np.float64) * 32767), -32768, 32767)
    d = np.abs(got.astype(np.int64) - w16.astype(np.int64))
    assert d.max() <= 2, d.max()
    # ini round trip carries the table
    text = ("[song]\nbpm=240\nticks=4\npatterns = a\n"
            "[synth.wt]\nwave = wavetable\namplitude = 0.4\nrelease = 0.05\n"
            "table = 0.0 0.9 0.3 -0.6 -1.0 -0.2\n"
            "[pattern.a]\nwt = C4 - E4 - G4 - - -\n")
    song2 = Song.from_string(text)
    np.testing.assert_array_equal(song2.mix(normalize=False).get_frame_array(),
                                  got)


# ---------------------------------------------------------------------------
# Portamento ([synth.*] glide =)
# ---------------------------------------------------------------------------

def _glide_song():
    song = Song()
    song.bpm = 120
    song.ticks = 2
    song.add_synth("mono", SynthDef(wave="sine", amplitude=0.5,
                                    attack=0.0, decay=0.0,
                                    sustain_level=1.0, release=0.02,
                                    glide=0.08))
    song.add_pattern("a", {"mono": "C3 -  G3 -  C4 -  .. .."})
    song.pattern_sequence = ["a"]
    return song


def test_glide_voice_compilation():
    song = _glide_song()
    voices = song.compile_synth_voices()
    assert len(voices) == 3
    v1, v2, v3 = sorted(voices, key=lambda v: v.start)
    # the track's first note never glides; later notes slide from the
    # previous pitch over the configured seconds (across any rests)
    assert v1.glide_time == 0.0 and v1.glide_from == 0.0
    assert v2.glide_from == pytest.approx(note_freq("C3"))
    assert v2.glide_time == pytest.approx(0.08)
    assert v3.glide_from == pytest.approx(note_freq("G3"))


def test_glide_repeated_note_does_not_glide():
    song = _glide_song()
    song.patterns["a"]["mono"] = "A3 -  A3 -  .. .. .. .."
    voices = sorted(song.compile_synth_voices(), key=lambda v: v.start)
    assert voices[1].glide_time == 0.0     # same pitch: nothing to slide


def test_glide_streaming_equals_offline():
    song = _glide_song()
    offline = song.mix(normalize=False).get_frame_array()
    chunks = [c.get_frame_array()
              for c in song.mix_generator(chunk_frames=1000)]
    got = np.concatenate(chunks)
    np.testing.assert_array_equal(got, offline[:len(got)])


def test_glide_audibly_sweeps():
    # the middle of the C3->G3 slide must sit strictly between the two
    # pitches (zero-crossing estimate), and the note must land on target
    song = _glide_song()
    a = song.mix(normalize=False).get_frame_array()[:, 0].astype(np.float64)
    sr = song.samplerate
    tick = song.tick_duration
    g3_start = int(2 * tick * sr)          # G3 note starts at tick 2

    def f_est(seg):
        zc = np.where((seg[:-1] < 0) & (seg[1:] >= 0))[0]
        return sr / np.mean(np.diff(zc))

    mid = f_est(a[g3_start + int(0.02 * sr): g3_start + int(0.06 * sr)])
    end = f_est(a[g3_start + int(0.12 * sr): g3_start + int(0.24 * sr)])
    assert note_freq("C3") + 5 < mid < note_freq("G3") - 5
    assert abs(end - note_freq("G3")) < 1.5


def test_glide_ini_roundtrip(tmp_path):
    ini = tmp_path / "glide.ini"
    ini.write_text("""
[song]
bpm = 120
ticks = 2
patterns = a

[synth.mono]
wave = sine
amplitude = 0.5
attack = 0.0
decay = 0.0
sustain_level = 1.0
release = 0.02
glide = 0.08

[pattern.a]
mono = C3 -  G3 -  C4 -  .. ..
""")
    song = Song.from_ini(str(ini))
    assert song.synths["mono"].glide == pytest.approx(0.08)
    ref = _glide_song().mix(normalize=False).get_frame_array()
    got = song.mix(normalize=False).get_frame_array()
    np.testing.assert_array_equal(got, ref)


def test_glide_mesh_matches_single_device():
    import jax
    from synthesizer_tpu.parallel.mesh import voice_mesh
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    song = _glide_song()
    single = song.mix(normalize=False).get_frame_array()
    sharded = song.mix(normalize=False,
                       mesh=voice_mesh()).get_frame_array()
    assert np.max(np.abs(single.astype(np.int64)
                         - sharded.astype(np.int64))) <= 1
