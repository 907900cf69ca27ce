"""Sequencer: batched device mixdown vs the oracle's per-hit mix_at loop
(the reference algorithm, SURVEY.md §4.2), plus .ini parsing and streaming
== offline invariance.  Covers benchmark config 3's op set.
"""

import os

import numpy as np
import pytest

import goldref.sample as gs
from synthesizer_tpu import Sample, WaveSynth
from synthesizer_tpu.sequencer import Song

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SR = 44100


def make_instruments():
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    kick = synth.sine(60.0, 0.12, amplitude=0.9).fadeout(0.08).stereo()
    snare = synth.white_noise(duration=0.08, amplitude=0.5, seed=3).fadeout(0.05).stereo()
    hat = synth.white_noise(duration=0.03, amplitude=0.3, seed=4).fadeout(0.02).stereo()
    bass = synth.triangle(110.0, 0.2, amplitude=0.7).fadeout(0.15).stereo()
    return {"kick": kick, "snare": snare, "hat": hat, "bass": bass}


def make_song():
    song = Song()
    song.bpm = 240
    song.ticks = 4
    for name, smp in make_instruments().items():
        song.add_instrument(name, smp)
    song.add_pattern("a", {
        "kick":  "x... x... x... x...",
        "snare": ".... x... .... x...",
        "hat":   "x.x. x.x. x.x. x.x.",
        "bass":  "x... .... ..x. ....",
    })
    song.add_pattern("b", {
        "kick":  "x.x. x... x.x. x...",
        "hat":   "xxxx xxxx xxxx xxxx",
    })
    song.pattern_sequence = ["a", "b", "a"]
    return song


def oracle_mix(song: Song, total_frames: int) -> np.ndarray:
    """Reference algorithm: widened per-hit mix_at loop via goldref."""
    out = gs.Sample(np.zeros((total_frames, 2), np.int32), SR, 4, 2)
    sched = song.compile_schedule()
    for inst_i, start in sched.hits:
        arr = song.instruments[sched.instruments[inst_i]].get_frame_array()
        g = gs.Sample(arr.astype(np.int32), SR, 4, 2)
        out.mix_at(start / SR, g, pad_shortest=False)
    return out.frames


def test_mix_matches_oracle_loop():
    song = make_song()
    mixed = song.mix(normalize=False)
    want32 = oracle_mix(song, mixed.nframes)
    want = np.clip(want32, -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(mixed.get_frame_array(), want)


def test_mix_normalized_full_scale():
    song = make_song()
    mixed = song.mix(normalize=True)
    assert mixed.samplewidth == 2
    peak = np.abs(mixed.get_frame_array().astype(np.int64)).max()
    assert peak >= 32000  # amplified to (near) full scale


def test_streaming_equals_offline():
    song = make_song()
    offline = song.mix(normalize=False)
    chunks = [c.get_frame_array() for c in song.mix_generator(chunk_frames=1000)]
    got = np.concatenate(chunks)
    want = offline.get_frame_array()[:len(got)]
    np.testing.assert_array_equal(got, want)
    assert abs(len(got) - song.compile_schedule().total_frames) < 1000


def test_ini_roundtrip(tmp_path):
    instdir = tmp_path / "samples"
    instdir.mkdir()
    for name, smp in make_instruments().items():
        smp.write_wav(str(instdir / f"{name}.wav"))
    ini = tmp_path / "song.ini"
    ini.write_text("""
[song]
bpm = 240
ticks = 4
patterns = a b a

[paths]
samples = samples/

[instruments]
kick = kick.wav
snare = snare.wav
hat = hat.wav
bass = bass.wav

[pattern.a]
kick  = x... x... x... x...
snare = .... x... .... x...
hat   = x.x. x.x. x.x. x.x.
bass  = x... .... ..x. ....

[pattern.b]
kick = x.x. x... x.x. x...
hat  = xxxx xxxx xxxx xxxx
""")
    song = Song.from_ini(str(ini))
    assert song.bpm == 240 and song.pattern_sequence == ["a", "b", "a"]
    ref = make_song().mix(normalize=False)
    got = song.mix(normalize=False)
    np.testing.assert_array_equal(got.get_frame_array(), ref.get_frame_array())


def test_mismatched_instrument_formats_rejected(monkeypatch):
    # add_instrument normalizes, so differing input WAVs converge on the
    # norm format rather than silently mixing at the wrong rate...
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    song = Song()
    song.add_instrument("kick", synth.sine(60, 0.1).stereo())
    other = WaveSynth(samplerate=22050, samplewidth=2).sine(60, 0.1)
    song.add_instrument("snare", other)
    assert song.instruments["snare"].samplerate == SR
    assert song.instruments["snare"].nchannels == 2
    # ...and if the normalization targets change mid-song (the one way a
    # mismatch can still arise), the guard raises instead of last-one-wins.
    from synthesizer_tpu import params
    monkeypatch.setattr(params, "norm_samplerate", 22050)
    with pytest.raises(ValueError, match="convert"):
        song.add_instrument("hat", synth.sine(60, 0.1).stereo())


def test_from_string_ignores_paths_section(tmp_path):
    (tmp_path / "inner").mkdir()
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    synth.sine(60, 0.1).stereo().write_wav(str(tmp_path / "inner" / "k.wav"))
    text = ("[song]\nbpm=120\nticks=4\npatterns = p\n"
            f"[paths]\nsamples = {tmp_path}/\n"   # ignored by from_string
            "[instruments]\nk = k.wav\n"
            "[pattern.p]\nk = x...\n")
    song = Song.from_string(text, sample_dir=str(tmp_path / "inner"))
    assert song.mix(normalize=False).nframes > 0
    with pytest.raises(FileNotFoundError):
        Song.from_string(text, sample_dir=str(tmp_path))  # [paths] not honored


def test_config3_sixteen_track_mixdown():
    """Benchmark config 3: 16-track mixdown exercising mix/mix_at +
    resample/amplify/fadein/fadeout ops."""
    synth = WaveSynth(samplerate=22050, samplewidth=2)
    total = Sample.from_raw_frames(b"", 2, SR, 2)
    last_len = 0
    for t in range(16):
        s = synth.sine(100.0 + 50 * t, 0.25, amplitude=0.4)
        s.resample(SR).amplify(0.5 + 0.02 * t).fadein(0.02).fadeout(0.05).stereo()
        last_len = s.nframes
        total.mix_at(0.05 * t, s)
    assert total.nframes == int(0.05 * 15 * SR) + last_len
    a = total.get_frame_array().astype(np.int64)
    assert a.max() <= 32767 and a.min() >= -32768  # saturating mix stayed in range


def test_config3_fuses_to_one_program():
    """The whole 16-track config-3 workload — synthesis included — must
    compile to at most 3 device programs (it is 1 today:
    WaveSynth renders stage as gen_patch IR nodes and every mix_at fuses
    the track's chain as a sub-program)."""
    from synthesizer_tpu.utils import profiling
    synth = WaveSynth(samplerate=22050, samplewidth=2)
    with profiling.count_program_launches() as n:
        total = Sample.from_raw_frames(b"", 2, SR, 2)
        for t in range(16):
            s = synth.sine(100.0 + 50 * t, 0.25, amplitude=0.4)
            s.resample(SR).amplify(0.5 + 0.02 * t).fadein(0.02).fadeout(0.05).stereo()
            total.mix_at(0.05 * t, s)
        total.get_frame_array()
    assert n[0] <= 3, f"config-3 chain launched {n[0]} device programs"


def test_streaming_seek_resume_bit_exact():
    """mix_generator(start_frame=k): resuming mid-song — mid-hit, mid-note,
    not chunk-aligned — is BIT-exact with the offline slice (SURVEY §6
    checkpoint/resume: renders are stateless in the absolute frame)."""
    song = make_song()
    from synthesizer_tpu.sequencer import SynthDef
    song.add_synth("lead", SynthDef(wave="sine", amplitude=0.2, release=0.05))
    for p in song.patterns.values():
        p["lead"] = "C4 - E4 - G4 - C5 -"
    offline = song.mix(normalize=False).get_frame_array()
    for k in (0, 1, 5170, 44100 + 13):
        chunks = [c.get_frame_array()
                  for c in song.mix_generator(chunk_frames=1000, start_frame=k)]
        got = np.concatenate(chunks)
        np.testing.assert_array_equal(got, offline[k:k + len(got)],
                                      err_msg=f"start_frame={k}")
    # past the end: empty stream; negative: rejected
    assert list(song.mix_generator(start_frame=10 ** 9)) == []
    with pytest.raises(ValueError):
        next(song.mix_generator(start_frame=-1))


def test_mixdown_scatter_batching_bit_exact(monkeypatch):
    """The memory-bounded batched scatter (scan over hit batches) is
    bit-exact vs the single-gather path — a dense song with long samples
    must not materialize an [H, Lmax, C] gather of several GB."""
    import synthesizer_tpu.sequencer as seq
    song = make_song()
    want = song.mix(normalize=False).get_frame_array()
    # force tiny batches (3 hits per scatter step) and a padded tail
    monkeypatch.setattr(seq, "_SCATTER_BATCH_ELEMS",
                        3 * song.instruments["kick"].nframes * 2)
    got = song.mix(normalize=False).get_frame_array()
    np.testing.assert_array_equal(got, want)
    # and the streaming path still slices identically
    chunks = [c.get_frame_array() for c in song.mix_generator(chunk_frames=1000)]
    np.testing.assert_array_equal(np.concatenate(chunks),
                                  want[:sum(len(c) for c in chunks)])


def test_long_dense_song_streaming_scales():
    """>=5 min song with >=5k hits: mix_generator's schedule indexing is a
    single bucketed pass (not O(nchunks x hits)) and the stream sustains
    well over realtime on CPU."""
    import time
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    song = Song()
    song.bpm = 240                     # tick = 62.5 ms
    song.ticks = 4
    song.add_instrument("kick", synth.sine(60, 0.08, amplitude=0.8)
                        .fadeout(0.06).stereo())
    song.add_instrument("hat", synth.white_noise(duration=0.02, amplitude=0.3,
                                                 seed=2).stereo())
    song.add_pattern("d", {"kick": "x" * 16, "hat": "x" * 16})
    song.pattern_sequence = ["d"] * 160          # 160 * 16 ticks = 160 s...
    # stretch to >= 5 min by slowing the tick AFTER pattern entry
    song.bpm = 80                                # tick = 187.5 ms -> 480 s
    sched = song.compile_schedule()
    assert len(sched.hits) >= 5000
    assert sched.total_frames >= 5 * 60 * SR

    t0 = time.perf_counter()
    audio = 0.0
    for i, chunk in enumerate(song.mix_generator(chunk_frames=8192)):
        audio += chunk.duration
        if i % 200 == 0:
            chunk.get_frame_array()              # force real compute sometimes
    wall = time.perf_counter() - t0
    assert audio >= 5 * 60
    rtf = audio / wall
    assert rtf > 20, f"dense-song streaming at {rtf:.1f}x realtime"


def test_swing_delays_odd_ticks(tmp_path):
    """swing shifts odd-tick hits by swing*tick/2 on every engine (drums,
    synth notes, sampler notes), identically offline and streaming."""
    from synthesizer_tpu.sequencer import SynthDef
    synth = WaveSynth(samplerate=SR, samplewidth=2)

    def build(swing):
        song = Song()
        song.bpm = 240
        song.ticks = 4
        song.swing = swing
        song.add_instrument("hat", synth.white_noise(
            duration=0.02, amplitude=0.4, seed=5).fadeout(0.01).stereo())
        song.add_pattern("a", {"hat": "xxxx xxxx"})
        song.pattern_sequence = ["a"]
        return song

    straight = build(0.0).compile_schedule()
    swung = build(0.4).compile_schedule()
    tickf = build(0.0).tick_duration * SR
    shift = np.asarray(swung.hits[:, 1]) - np.asarray(straight.hits[:, 1])
    want = [0 if t % 2 == 0 else int((t + 0.2) * tickf) - int(t * tickf)
            for t in range(8)]
    assert shift.tolist() == want
    song = build(0.4)
    off = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=1000)])
    np.testing.assert_array_equal(got, off[:len(got)])


def test_swing_ini_and_validation(tmp_path):
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    synth.sine(60, 0.05).stereo().write_wav(str(tmp_path / "k.wav"))
    ini = tmp_path / "s.ini"
    ini.write_text("""
[song]
bpm = 240
ticks = 4
swing = 0.33
patterns = a
[instruments]
k = k.wav
[pattern.a]
k = x.x.x.x.
""")
    song = Song.from_ini(str(ini))
    assert song.swing == 0.33
    ini.write_text(ini.read_text().replace("swing = 0.33", "swing = 1.5"))
    with pytest.raises(ValueError, match="swing"):
        Song.from_ini(str(ini))


def test_inline_drum_dynamics():
    """Tracker accents: 'X' = 1.5x, 'o' = 0.5x, 'x' unchanged; they
    multiply any velocity curve and reach both paths bit-exactly."""
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    song = Song()
    song.bpm = 240
    song.ticks = 4
    song.add_instrument("kick", synth.sine(60.0, 0.05, amplitude=0.4)
                        .fadeout(0.03).stereo())
    song.add_pattern("a", {"kick": "x...X...o...x..."})
    song.pattern_sequence = ["a"]
    sched = song.compile_schedule()
    np.testing.assert_allclose(sched.gains[:, 0], [1.0, 1.5, 0.5, 1.0])
    off = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=977)])
    np.testing.assert_array_equal(got, off[:len(got)])
    kick = song.instruments["kick"].get_frame_array().astype(np.float64)
    tickf = song.tick_duration * SR
    s4 = int(4 * tickf)
    np.testing.assert_array_equal(
        off[s4:s4 + len(kick)].astype(np.int64),
        np.rint(kick * np.float32(1.5)).astype(np.int64))


def test_inline_note_velocity():
    """'C4@0.5' halves that note's amplitude (synth and sampler)."""
    from synthesizer_tpu.sequencer import SynthDef
    song = Song()
    song.bpm = 240
    song.ticks = 4
    song.add_synth("lead", SynthDef(wave="sine", amplitude=0.4))
    song.add_pattern("a", {"lead": "C4 .. C4@0.5 .."})
    song.pattern_sequence = ["a"]
    voices = song.compile_synth_voices()
    assert [v.amplitude for v in voices] == pytest.approx([0.4, 0.2])

    synth = WaveSynth(samplerate=SR, samplewidth=2)
    song2 = Song()
    song2.bpm = 240
    song2.ticks = 4
    song2.add_sampler("g", synth.sine(261.63, 0.05, amplitude=0.4).stereo())
    song2.add_pattern("a", {"g": "C4 .. C4@0.25 .."})
    song2.pattern_sequence = ["a"]
    gains = song2.compile_pitched_hits()[5]
    np.testing.assert_allclose(gains[:, 0], [1.0, 0.25])
    with pytest.raises(ValueError, match="velocity"):
        song2.add_pattern("b", {"g": "C4@oops"})
        song2.pattern_sequence = ["b"]
        song2.compile_pitched_hits()


# ---------------------------------------------------------------------------
# Stem export (round 3): every track as its own pre-master Sample
# ---------------------------------------------------------------------------

def _stems_song():
    from synthesizer_tpu import WaveSynth
    from synthesizer_tpu.sequencer import Song, SynthDef
    ws = WaveSynth(samplerate=44100, samplewidth=2)
    song = Song()
    song.bpm = 240
    song.ticks = 4
    song.add_instrument("kick", ws.sine(60, 0.08, amplitude=0.5)
                        .fadeout(0.05).stereo())
    song.add_instrument("hat", ws.white_noise(duration=0.02, amplitude=0.3,
                                              seed=3).stereo())
    song.add_sampler("gtr", ws.pluck(261.63, 0.12, amplitude=0.4, seed=7)
                     .fadeout(0.03).stereo(), base_note="C4")
    song.add_synth("lead", SynthDef(wave="square_bl", amplitude=0.2,
                                    release=0.02, pan=0.3))
    song.add_synth("bass", SynthDef(wave="sine", amplitude=0.25,
                                    release=0.02, pan=-0.4))
    song.add_pattern("a", {"kick": "x.x.x.X.", "hat": "xxoxxxox",
                           "gtr": "C4 .. E4 .. G4 .. .. ..",
                           "lead": "C4 . E4 . G4 . C5 .",
                           "bass": "C2 - - - G2 - - -"})
    song.pattern_sequence = ["a", "a"]
    return song


def test_mix_stems_sum_equals_premaster_mix():
    """Summing the stems reproduces mix(normalize=False): drum/sampler
    stems partition the integer scatter exactly; synth stems differ only
    by the per-track grouped matmul's summation order (<= 1 LSB/track)."""
    song = _stems_song()
    stems = song.mix_stems(tail_seconds=0.3)
    assert set(stems) == {"kick", "hat", "gtr", "lead", "bass"}
    lens = {s.nframes for s in stems.values()}
    assert len(lens) == 1, "stems must share one length"
    total = np.zeros((lens.pop(), 2), np.int64)
    for s in stems.values():
        assert s.samplewidth == 2 and s.nchannels == 2
        total += s.get_frame_array().astype(np.int64)
    mix = song.mix(normalize=False, tail_seconds=0.3).get_frame_array()
    summed = np.clip(total, -32768, 32767)
    d = np.abs(summed - mix.astype(np.int64)).max()
    assert d <= 3, d


def test_mix_stems_track_fx_and_sidechain():
    """Per-track chains apply to their stem; a sidechain entry sees the
    drum key exactly as in mix()."""
    from synthesizer_tpu.effects import parse_fx_items
    song = _stems_song()
    song.synth_fx["bass"] = parse_fx_items(
        [("compress", "threshold_db=-16 ratio=10 attack=0.001 "
                      "release=0.08 sidechain=kick")])
    stems = song.mix_stems(tail_seconds=0.1)
    # the unducked render of the same stem is louder on average
    plain = _stems_song().mix_stems(tail_seconds=0.1)
    b_d = stems["bass"].get_frame_array().astype(np.float64)
    b_p = plain["bass"].get_frame_array().astype(np.float64)
    assert np.sqrt(np.mean(b_d ** 2)) < 0.9 * np.sqrt(np.mean(b_p ** 2))
    # and the ducked-stem song still sums to its own mix
    total = np.zeros((stems["kick"].nframes, 2), np.int64)
    for s in stems.values():
        total += s.get_frame_array().astype(np.int64)
    mix = song.mix(normalize=False, tail_seconds=0.1).get_frame_array()
    d = np.abs(np.clip(total, -32768, 32767) - mix.astype(np.int64)).max()
    assert d <= 3, d


def test_stems_cli(tmp_path):
    import subprocess
    import sys as _sys
    import wave as _wave
    from synthesizer_tpu import WaveSynth
    ws = WaveSynth(samplerate=44100, samplewidth=2)
    ws.sine(200, 0.05, amplitude=0.5).stereo().write_wav(
        str(tmp_path / "k.wav"))
    (tmp_path / "s.ini").write_text("""
[song]
bpm = 240
ticks = 4
patterns = a
[instruments]
k = k.wav
[synth.lead]
wave = sine
amplitude = 0.2
release = 0.02
[pattern.a]
k = x.x.
lead = C4 . E4 .
""")
    out = subprocess.run(
        [_sys.executable, os.path.join(ROOT, "trackmixer.py"),
         str(tmp_path / "s.ini"), "--stems", str(tmp_path / "stems")],
        capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    for name in ("k", "lead"):
        with _wave.open(str(tmp_path / "stems" / f"{name}.wav")) as w:
            assert w.getnframes() > 0


def test_mono_song_stems_and_sidechain(monkeypatch):
    """Mono songs (params.norm_nchannels = 1 — instrument normalization
    otherwise upmixes everything to stereo) go through mix_stems and
    sidechain keys too (the from_jax width-vs-channels argument bug
    class, review r3 #1)."""
    from synthesizer_tpu import WaveSynth, params
    from synthesizer_tpu.sequencer import Song
    from synthesizer_tpu.effects import parse_fx_items
    monkeypatch.setattr(params, "norm_nchannels", 1)
    ws = WaveSynth(samplerate=44100, samplewidth=2)
    song = Song()
    song.bpm = 240
    song.ticks = 4
    song.add_instrument("kick", ws.sine(60, 0.08, amplitude=0.5)
                        .fadeout(0.05))             # MONO instrument
    song.add_sampler("gtr", ws.pluck(261.63, 0.1, amplitude=0.4, seed=5)
                     .fadeout(0.03), base_note="C4")
    song.add_pattern("a", {"kick": "x.x.x.x.", "gtr": "C4 .. E4 .. .. .."})
    song.pattern_sequence = ["a"]
    song.sampler_fx["gtr"] = parse_fx_items(
        [("compress", "threshold_db=-16 ratio=8 sidechain=kick")])
    assert song.nchannels == 1
    off = song.mix(normalize=False, tail_seconds=0.1).get_frame_array()
    assert off.shape[1] == 1 and np.abs(off).max() > 1000
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=1024)])
    d = np.abs(got.astype(np.int64)
               - off[:len(got)].astype(np.int64)).max()
    assert d <= 8, d
    stems = song.mix_stems(tail_seconds=0.1)
    assert set(stems) == {"kick", "gtr"}
    for s in stems.values():
        assert s.samplewidth == 2
