"""Application-layer tests: trackmixer CLI, keyboard synth controller,
jukebox engine + library backend.  All headless (no display, no audio HW).
"""

import io
import os
import wave

import numpy as np
import pytest

from synthesizer_tpu import Sample, WaveSynth

import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import trackmixer  # noqa: E402
from keyboard_gui import EnvSettings, OscSettings, SynthController  # noqa: E402
from jukebox.backend import MusicLibrary  # noqa: E402
from jukebox.box import Jukebox  # noqa: E402

SR = 44100


@pytest.fixture
def song_dir(tmp_path):
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    instdir = tmp_path / "samples"
    instdir.mkdir()
    synth.sine(60.0, 0.1, amplitude=0.8).fadeout(0.05).stereo().write_wav(
        str(instdir / "kick.wav"))
    synth.white_noise(duration=0.05, amplitude=0.4, seed=1).fadeout(0.03).stereo(
    ).write_wav(str(instdir / "hat.wav"))
    ini = tmp_path / "song.ini"
    ini.write_text("""
[song]
bpm = 250
ticks = 4
patterns = a a

[paths]
samples = samples/

[instruments]
kick = kick.wav
hat = hat.wav

[pattern.a]
kick = x... x...
hat  = x.x. x.x.
""")
    return tmp_path


def test_trackmixer_offline_mix(song_dir, capsys):
    out = str(song_dir / "out.wav")
    rc = trackmixer.main([str(song_dir / "song.ini"), "-o", out])
    assert rc == 0
    with wave.open(out) as w:
        assert w.getnchannels() == 2 and w.getframerate() == SR
        assert w.getnframes() > SR // 4
    assert "x realtime" in capsys.readouterr().out

def test_trackmixer_midi_export(song_dir, capsys):
    """-o file.mid exports the song's note events as an SMF (no audio
    render) and the exported file parses back with the drum hits on the
    GM percussion channel."""
    from synthesizer_tpu.midi import parse_midi
    out = str(song_dir / "out.mid")
    rc = trackmixer.main([str(song_dir / "song.ini"), "-o", out])
    assert rc == 0
    assert "exported note events" in capsys.readouterr().out
    notes = parse_midi(out)
    assert len(notes) == 12                     # 4 kick + 8 hat hits
    assert {n.channel for n in notes} == {9}    # all percussion

def test_trackmixer_midi_input_rejects_midi_output(song_dir, capsys, tmp_path):
    """-o .mid with a .mid INPUT is refused (it would be a lossy rewrite,
    and must never silently write WAV bytes into a .mid path)."""
    import pytest as _pytest
    from synthesizer_tpu.midi import MidiNote, write_midi
    mid = tmp_path / "in.mid"
    mid.write_bytes(write_midi([MidiNote(0.0, 0.2, 60, 100, 0)]))
    with _pytest.raises(SystemExit):
        trackmixer.main([str(mid), "-o", str(tmp_path / "out.mid")])
    assert "already a MIDI file" in capsys.readouterr().err

def test_trackmixer_midi_play(song_dir, capsys, tmp_path):
    """--play with a .mid input streams the render through the output
    sink ladder (null sink here) instead of silently writing a WAV."""
    from synthesizer_tpu.midi import MidiNote, write_midi
    mid = tmp_path / "p.mid"
    mid.write_bytes(write_midi([MidiNote(0.0, 0.2, 60, 100, 0),
                                MidiNote(0.2, 0.2, 64, 100, 0)]))
    rc = trackmixer.main([str(mid), "--play"])
    assert rc == 0
    assert "played MIDI" in capsys.readouterr().out
    assert not (tmp_path / "p.wav").exists()

def test_trackmixer_midi_stems(song_dir, capsys, tmp_path):
    """--stems with a .mid input renders one stem per MIDI channel."""
    import wave as _wave
    from synthesizer_tpu.midi import MidiNote, write_midi
    mid = tmp_path / "s.mid"
    mid.write_bytes(write_midi([MidiNote(0.0, 0.2, 60, 100, 0),
                                MidiNote(0.0, 0.2, 45, 100, 1),
                                MidiNote(0.2, 0.2, 36, 110, 9)]))
    stems = tmp_path / "stems"
    rc = trackmixer.main([str(mid), "--stems", str(stems)])
    assert rc == 0
    assert "3 MIDI channel stems" in capsys.readouterr().out
    names = sorted(p.name for p in stems.iterdir())
    assert names == ["ch00.wav", "ch01.wav", "ch09_drums.wav"]
    for n in names:
        with _wave.open(str(stems / n)) as w:
            assert w.getnframes() > 1000


def test_trackmixer_repl_commands(song_dir, capsys, tmp_path):
    from synthesizer_tpu.sequencer import Song
    song = Song.from_ini(str(song_dir / "song.ini"))
    repl = trackmixer.TrackmixerRepl(song, "song.ini")
    repl.do_info("")
    repl.do_patterns("")
    out = capsys.readouterr().out
    assert "bpm 250" in out and "[pattern.a]" in out
    mixfile = str(tmp_path / "m.wav")
    repl.do_mix(mixfile)
    assert os.path.exists(mixfile)
    assert repl.do_quit("") is True


def test_synth_controller_renders_keys():
    c = SynthController(samplerate=SR)
    s = c.render_key(49)   # A4
    assert s.samplerate == SR and s.nframes > 0
    a = s.get_frame_array()
    assert np.abs(a).max() > 1000
    # envelope should have released to silence by the end
    assert np.abs(a[-100:]).max() < 500


def test_synth_controller_fm_routing_and_mix():
    c = SynthController(samplerate=SR)
    c.oscs[1].waveform = "sine"
    c.oscs[1].ratio = 0.01        # low-freq LFO panel
    c.oscs[1].amplitude = 0.01
    c.oscs[0].fm_source = 1       # panel 1 modulates panel 0
    patch = c.build_patch(49)
    # panel 1 is routed as an LFO so only one sounding source remains
    from synthesizer_tpu.models import spec as S
    assert isinstance(patch.spec, S.Envelope)
    assert patch.spec.source.fm_lfo is not None
    s = c.render_key(49)
    assert s.nframes > 0


def test_synth_controller_echo_and_presets(tmp_path):
    c = SynthController(samplerate=SR)
    c.echo.enabled = True
    c.env.release = 0.05
    s = c.render_key(45)
    assert s.duration > c.echo.after + c.echo.amount * c.echo.delay
    p = str(tmp_path / "preset.ini")
    c.oscs[0].waveform = "pulse"
    c.save_preset(p)
    c2 = SynthController(samplerate=SR)
    c2.load_preset(p)
    assert c2.oscs[0].waveform == "pulse"
    assert c2.echo.enabled is True
    assert c2.env.release == pytest.approx(0.05)


def test_music_library_scan_and_search(tmp_path):
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    for name in ("alpha", "beta", "gamma"):
        synth.sine(220.0, 0.2).stereo().write_wav(str(tmp_path / f"{name}.wav"))
    lib = MusicLibrary()
    assert lib.scan(str(tmp_path)) == 3
    assert len(lib.search("")) == 3
    hits = lib.search("bet")
    assert len(hits) == 1 and hits[0].title == "beta"
    assert hits[0].duration == pytest.approx(0.2, abs=0.01)
    t = lib.get(hits[0].track_id)
    assert t.path.endswith("beta.wav")
    lib.close()


def test_music_library_indexes_aiff_and_au(tmp_path):
    """Round 3: the library probes AIFF/AU (and compressed WAV) through
    the in-process decoders — full duration metadata, no ffmpeg — and the
    jukebox deck streams them through AudiofileToWavStream."""
    import aifc as _aifc
    import warnings as _warnings
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    tone = synth.sine(220.0, 0.25).stereo()
    frames = tone.get_frame_array()
    with _warnings.catch_warnings():
        _warnings.simplefilter("ignore")
        with _aifc.open(str(tmp_path / "brass.aiff"), "wb") as f:
            f.setnchannels(2)
            f.setsampwidth(2)
            f.setframerate(SR)
            f.writeframes(frames.astype(">i2").tobytes())
    synth.sine(330.0, 0.2).stereo().write_wav(str(tmp_path / "plain.wav"))
    lib = MusicLibrary()
    assert lib.scan(str(tmp_path)) == 2
    hits = lib.search("brass")
    assert len(hits) == 1
    assert hits[0].duration == pytest.approx(0.25, abs=0.01)
    assert hits[0].samplerate == SR and hits[0].nchannels == 2
    # the deck path decodes it too
    from jukebox.box import Jukebox
    box = Jukebox(lib, crossfade=0.05)
    box.enqueue(hits[0])
    chunks = list(box.chunks())
    total = sum(c.nframes for c in chunks)
    assert total >= int(0.2 * 44100)
    lib.close()


def test_jukebox_crossfade(tmp_path):
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    # two 1s tones at normalized format
    synth.sine(440.0, 1.0, amplitude=0.5).stereo().write_wav(str(tmp_path / "a.wav"))
    synth.sine(660.0, 1.0, amplitude=0.5).stereo().write_wav(str(tmp_path / "b.wav"))
    lib = MusicLibrary()
    lib.scan(str(tmp_path))
    tracks = lib.search("")
    box = Jukebox(lib, crossfade=0.3, frames_per_chunk=4410)
    for t in tracks:
        box.enqueue(t)
    chunks = list(box.chunks())
    total = sum(c.nframes for c in chunks)
    # two 1s tracks with a 0.3s crossfade overlap: ~1.7s +- slack
    assert 1.4 * SR <= total <= 2.2 * SR
    audio = np.concatenate([c.get_frame_array() for c in chunks])
    assert np.abs(audio).max() > 5000


def test_arpeggiator():
    import time as _time
    from synthesizer_tpu import Output
    c = SynthController(samplerate=SR)
    c.arp.enabled = True
    cycle = c.render_arpeggio(49)
    assert cycle.nframes == int(len(c.arp.intervals) / c.arp.rate * SR)
    a = cycle.get_frame_array()
    # four audible note segments
    step = int(SR / c.arp.rate)
    for i in range(4):
        seg = a[i * step + step // 8:(i + 1) * step - step // 2]
        assert np.abs(seg).max() > 500, f"arp note {i} silent"
    # looping through the mixer; key_up stops it
    out = Output(samplerate=SR, nchannels=2, frames_per_chunk=1470, mixing="mixed")
    try:
        c.output = out
        c.key_down(49)
        assert out.mixer.active_count == 1
        _time.sleep(0.1)
        assert out.mixer.active_count == 1  # still looping
        c.key_up(49)
        assert out.mixer.active_count == 0
    finally:
        out.close()


def test_arp_preset_roundtrip(tmp_path):
    c = SynthController(samplerate=SR)
    c.arp.enabled = True
    c.arp.intervals = (0, 3, 7)
    c.arp.rate = 6.0
    p = str(tmp_path / "arp.ini")
    c.save_preset(p)
    c2 = SynthController(samplerate=SR)
    c2.load_preset(p)
    assert c2.arp.enabled and c2.arp.intervals == (0, 3, 7) and c2.arp.rate == 6.0


def test_jukebox_pause_resume(tmp_path):
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    synth.sine(440.0, 0.3, amplitude=0.5).stereo().write_wav(str(tmp_path / "t.wav"))
    lib = MusicLibrary()
    lib.scan(str(tmp_path))
    box = Jukebox(lib, frames_per_chunk=2205)
    box.enqueue(lib.search("")[0])
    gen = box.chunks()
    first = next(gen)
    assert np.abs(first.get_frame_array()).max() > 1000
    box.pause()
    silent = next(gen)
    assert np.abs(silent.get_frame_array()).max() == 0
    box.resume()
    loud = next(gen)
    assert np.abs(loud.get_frame_array()).max() > 1000


def test_repl_load_command(song_dir, capsys):
    from synthesizer_tpu.sequencer import Song
    song = Song.from_ini(str(song_dir / "song.ini"))
    repl = trackmixer.TrackmixerRepl(song, "song.ini")
    repl.do_load(str(song_dir / "song.ini"))
    out = capsys.readouterr().out
    assert "bpm 250" in out
    repl.do_load("/does/not/exist.ini")
    assert "no such file" in capsys.readouterr().out


def test_repl_play_melodic_pattern(tmp_path, capsys):
    """REPL 'play' on a pattern with synth tracks (regression: sub-song
    must inherit the synth definitions)."""
    from synthesizer_tpu.sequencer import Song, SynthDef
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    song = Song()
    song.bpm, song.ticks = 240, 4
    song.add_instrument("kick", synth.sine(60, 0.05, amplitude=0.5).stereo())
    song.add_synth("lead", SynthDef(wave="sine", amplitude=0.3))
    song.add_pattern("a", {"kick": "x...", "lead": "C4 . E4 ."})
    song.pattern_sequence = ["a"]
    repl = trackmixer.TrackmixerRepl(song, "song")
    repl.do_play("a")
    out = capsys.readouterr().out
    assert "played pattern a" in out


def test_keyboard_wavetable_panel(tmp_path):
    """The keyboard's wavetable panel renders through the graph engine and
    presets round-trip the table."""
    import io as _io
    import numpy as _np
    from keyboard_gui import SynthController, WAVEFORMS
    assert "wavetable" in WAVEFORMS and "sawtooth_bl" in WAVEFORMS
    c = SynthController(samplerate=44100)
    c.oscs[0].waveform = "wavetable"
    c.oscs[0].table = (0.0, 1.0, 0.5, -0.5, -1.0)
    a = c.render_key(49).get_frame_array()
    assert _np.abs(a).max() > 5000
    buf = _io.StringIO()
    c.save_preset(buf)
    buf.seek(0)
    c2 = SynthController(samplerate=44100)
    c2.load_preset(buf)
    assert c2.oscs[0].table == (0.0, 1.0, 0.5, -0.5, -1.0)


def test_keyboard_filter_section(tmp_path):
    """The controller's biquad filter section shapes the spectrum and
    round-trips through presets."""
    import io as _io
    import numpy as _np
    from keyboard_gui import SynthController
    c = SynthController(samplerate=44100)
    c.oscs[0].waveform = "sawtooth"
    raw = c.render_key(49).get_frame_array().astype(_np.float64)[:, 0]
    c.filter.enabled = True
    c.filter.kind = "lowpass"
    c.filter.cutoff = 500.0
    filt = c.render_key(49).get_frame_array().astype(_np.float64)[:, 0]
    n = min(len(raw), len(filt), 44100)
    freqs = _np.fft.rfftfreq(n, 1 / 44100)
    hi = freqs > 4000
    s_raw = _np.abs(_np.fft.rfft(raw[:n] * _np.hanning(n)))
    s_f = _np.abs(_np.fft.rfft(filt[:n] * _np.hanning(n)))
    assert s_f[hi].sum() < 0.05 * s_raw[hi].sum()
    buf = _io.StringIO()
    c.save_preset(buf)
    buf.seek(0)
    c2 = SynthController(samplerate=44100)
    c2.load_preset(buf)
    assert c2.filter.enabled and c2.filter.cutoff == 500.0


def test_keyboard_filter_lfo_routing():
    """An osc panel routed as the filter's cutoff LFO sweeps the filter
    and stops sounding directly."""
    import numpy as _np
    from keyboard_gui import SynthController
    c = SynthController(samplerate=44100)
    c.oscs[0].waveform = "sawtooth"
    c.oscs[1].waveform = "sine"        # the sweep LFO
    c.oscs[1].ratio = 0.0
    c.oscs[1].detune = 1.0             # 1 Hz
    c.oscs[1].amplitude = 2.0          # +-2 octaves
    c.filter.enabled = True
    c.filter.kind = "lowpass"
    c.filter.cutoff = 600.0
    c.filter.lfo_source = 1
    patch = c.build_raw_patch(49)
    from synthesizer_tpu.models import spec as S
    assert isinstance(patch.spec, S.Biquad)
    assert patch.spec.cutoff_lfo is not None        # swept
    assert not isinstance(patch.spec.source, S.Mix)  # LFO panel muted
    a = c.render_key(49).get_frame_array().astype(_np.float64)[:, 0]
    # brightness varies over the sweep: split-half HF energy differs
    n = len(a) // 2
    def hf(seg):
        s = _np.abs(_np.fft.rfft(seg * _np.hanning(len(seg))))
        f = _np.fft.rfftfreq(len(seg), 1 / 44100)
        return s[f > 2000].sum()
    lo, hi = sorted([hf(a[:n]), hf(a[n:2 * n])])
    assert hi > 2.0 * max(lo, 1e-9)


def test_controller_master_reverb(tmp_path):
    """The keyboard's master reverb installs an FxChain on the output and
    round-trips through presets."""
    import io
    import time as _t
    from synthesizer_tpu import Output
    from keyboard_gui import SynthController

    out = Output(samplerate=44100, nchannels=2, frames_per_chunk=2000,
                 mixing="mixed", wav_file=str(tmp_path / "kb.wav"))
    try:
        ctrl = SynthController(output=out)
        ctrl.reverb.enabled = True
        ctrl.reverb.wet = 0.5
        ctrl.apply_reverb()
        assert out.fx is not None and out.fx.tail_frames > 0
        ctrl.key_down(40)
        _t.sleep(0.15)
        ctrl.key_up(40)
        deadline = _t.time() + 8.0
        while out.still_playing() and _t.time() < deadline:
            _t.sleep(0.01)
        # preset round trip
        buf = io.StringIO()
        ctrl.save_preset(buf)
        buf.seek(0)
        ctrl2 = SynthController(output=out)
        ctrl2.load_preset(buf)
        assert ctrl2.reverb.enabled and abs(ctrl2.reverb.wet - 0.5) < 1e-9
        ctrl2.reverb.enabled = False
        ctrl2.apply_reverb()
        assert out.fx is None
    finally:
        out.close()


def test_keyboard_sampler_mode(tmp_path):
    """Sampler mode: keys play the loaded WAV repitched from base_key
    (an octave up halves the length); clear_sampler returns to synth."""
    from keyboard_gui import SynthController
    from synthesizer_tpu import Output, WaveSynth
    ws = WaveSynth(samplerate=44100, samplewidth=2)
    src = ws.sine(261.63, 0.2, amplitude=0.5).fadeout(0.05)
    c = SynthController()
    c.load_sampler(src.copy().stereo(), base_key=60)
    up = c.render_sampler_key(72)
    assert abs(up.nframes - src.nframes / 2) <= 2
    same = c.render_sampler_key(60)
    assert same.nframes == src.nframes
    # plays through an Output like any sample
    wav = str(tmp_path / "smp.wav")
    with Output(mixing="mixed", frames_per_chunk=2048, wav_file=wav) as out:
        c.output = out
        c.key_down(67)
        import time as _t
        deadline = _t.time() + 10.0
        while out.still_playing() and _t.time() < deadline:
            _t.sleep(0.01)
        c.key_up(67)
    import wave as _w
    import numpy as _np
    w = _w.open(wav)
    a = _np.frombuffer(w.readframes(w.getnframes()), _np.int16)
    assert _np.abs(a).max() > 1000
    c.clear_sampler()
    assert c.sampler_sample is None


def test_tracker_example_song(tmp_path):
    """examples/make_tracker_song.py exercises the whole song-layer
    surface (samplers + loops + accents + swing + per-track fx + full
    automation) through the real ini path."""
    import importlib.util
    import sys as _sys
    spec = importlib.util.spec_from_file_location(
        "make_tracker_song",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "examples", "make_tracker_song.py"))
    mod = importlib.util.module_from_spec(spec)
    _sys.argv = ["make_tracker_song", str(tmp_path)]
    spec.loader.exec_module(mod)
    mod.main()
    from synthesizer_tpu.sequencer import Song
    song = Song.from_ini(str(tmp_path / "tracker.ini"))
    assert song.swing == 0.25
    assert song.samplers["pad"].looped and not song.samplers["pluck"].looped
    assert "pluck" in song.sampler_fx and "fx.filter.cutoff" in song.automation
    # round 3: the snare arrives as AIFF through the in-process decoder,
    # and the recurrence-internal curves parse
    assert "snare" in song.instruments
    assert song.instruments["snare"].nframes > 1000
    assert "fx.compress.release" in song.automation
    assert "fx.reverb.roomsize" in song.automation
    assert any(n == "compress" and p.get("sidechain") == "kick"
               for n, p in song.sampler_fx["pad"])
    song.pattern_sequence = ["a"]        # one bar keeps CI light
    off = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    assert np.abs(off).max() > 1000
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=2048)])
    assert len(got) == len(off)
    d = np.abs(got.astype(np.int64) - off.astype(np.int64)).max()
    assert d <= 8, d


def test_repl_play_pattern_with_samplers(tmp_path, capsys, monkeypatch):
    """REPL 'play <pattern>' works on songs with sampler tracks and
    carries the song's samplers/fx/automation into the sub-song."""
    from synthesizer_tpu import WaveSynth
    from synthesizer_tpu.sequencer import Song
    ws = WaveSynth(samplerate=44100, samplewidth=2)
    ws.sine(261.63, 0.08, amplitude=0.5).stereo().write_wav(
        str(tmp_path / "g.wav"))
    (tmp_path / "s.ini").write_text("""
[song]
bpm = 240
ticks = 4
patterns = a
[sampler.g]
file = g.wav
base_note = C4
[pattern.a]
g = C4 .. E4 ..
[automation]
track.g.volume = 0:1 2:0.5
""")
    song = Song.from_ini(str(tmp_path / "s.ini"))
    repl = trackmixer.TrackmixerRepl(song, str(tmp_path / "s.ini"))
    repl.onecmd("play a")
    out = capsys.readouterr().out
    assert "played pattern a" in out, out


def test_jukebox_level_match(tmp_path):
    """R128 loudness normalization: the library measures + caches
    integrated LUFS / sample peak, and level-matched decks play a loud
    and a quiet track at comparable level (the unmatched gap is ~20 dB)."""
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    synth.sine(997.0, 1.2, amplitude=0.5).stereo() \
        .write_wav(str(tmp_path / "loud.wav"))
    synth.sine(997.0, 1.2, amplitude=0.05).stereo() \
        .write_wav(str(tmp_path / "quiet.wav"))
    lib = MusicLibrary()
    assert lib.scan(str(tmp_path)) == 2
    loud = lib.search("loud")[0]
    quiet = lib.search("quiet")[0]
    assert loud.lufs is None                 # scan stays headers-only
    loud = lib.measure_loudness(loud.track_id)
    quiet = lib.measure_loudness(quiet.track_id)
    # a 997 Hz stereo sine at amplitude A reads 20*log10(A) LUFS (the
    # EBU-3341 anchor convention: -23 dBFS sine == -23 LUFS)
    assert abs(loud.lufs - -6.02) < 0.3, loud.lufs
    assert abs(quiet.lufs - -26.02) < 0.3, quiet.lufs
    assert loud.peak == pytest.approx(0.5, abs=0.01)
    # cached: a second get() returns the stored values
    assert lib.get(loud.track_id).lufs == loud.lufs

    box = Jukebox(lib, crossfade=0.05, frames_per_chunk=4410,
                  level_match=True, target_lufs=-18.0)
    t_loud = box._trim_for(loud)
    t_quiet = box._trim_for(quiet)
    assert t_loud == pytest.approx(10 ** ((-18.0 - loud.lufs) / 20), rel=1e-6)
    assert t_quiet > 1.0 > t_loud
    # peak-cap: an absurd target can never push the peak past full scale
    box_hot = Jukebox(lib, level_match=True, target_lufs=6.0)
    assert box_hot._trim_for(loud) == pytest.approx(1.0 / loud.peak,
                                                    rel=1e-6)

    box.enqueue(loud)
    box.enqueue(quiet)
    out = np.concatenate([c.get_frame_array() for c in box.chunks()])

    def rms_db(x):
        return 10 * np.log10(np.mean(np.square(x.astype(np.float64)))
                             + 1e-12)
    head = rms_db(out[: int(0.8 * SR)])             # loud track, trimmed
    tail = rms_db(out[-int(0.8 * SR):])             # quiet track, boosted
    assert abs(head - tail) < 2.0, (head, tail)
    # and without level matching the same two tracks differ by ~20 dB
    box2 = Jukebox(lib, crossfade=0.05, frames_per_chunk=4410)
    box2.enqueue(lib.get(loud.track_id))
    box2.enqueue(lib.get(quiet.track_id))
    out2 = np.concatenate([c.get_frame_array() for c in box2.chunks()])
    gap = abs(rms_db(out2[: int(0.8 * SR)]) - rms_db(out2[-int(0.8 * SR):]))
    assert gap > 15.0, gap
    lib.close()


def test_jukebox_level_match_enqueue_path(tmp_path):
    """enqueue_path tracks (no library row) still level-match via an
    ad-hoc measurement."""
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    p = tmp_path / "adhoc.wav"
    synth.sine(440.0, 0.8, amplitude=0.4).stereo().write_wav(str(p))
    box = Jukebox(level_match=True, target_lufs=-18.0)
    box.enqueue_path(str(p))
    track = box.playlist[0]
    trim = box._trim_for(track)
    assert 0.1 < trim < 1.0                  # -11ish LUFS -> cut to -18
    chunks = list(box.chunks())
    assert sum(c.nframes for c in chunks) >= int(0.7 * SR)


def test_library_migrates_old_schema(tmp_path):
    """A pre-loudness database gains the lufs/peak columns in place."""
    import sqlite3
    db = tmp_path / "old.db"
    con = sqlite3.connect(str(db))
    con.execute("""CREATE TABLE tracks (
        id INTEGER PRIMARY KEY, path TEXT UNIQUE NOT NULL,
        title TEXT NOT NULL, duration REAL NOT NULL DEFAULT 0,
        samplerate INTEGER NOT NULL DEFAULT 0,
        nchannels INTEGER NOT NULL DEFAULT 0)""")
    con.execute("INSERT INTO tracks(path, title, duration, samplerate, "
                "nchannels) VALUES ('x.wav', 'x', 1.0, 44100, 2)")
    con.commit()
    con.close()
    lib = MusicLibrary(str(db))
    t = lib.search("x")[0]
    assert t.lufs is None and t.peak is None
    lib.close()


def test_controller_master_limiter(tmp_path):
    """The keyboard's master limiter caps the output bus at its ceiling
    (reverb -> limiter console order) and round-trips through presets."""
    import io
    import time as _t
    from synthesizer_tpu import Output
    from synthesizer_tpu.ops.coeffs import limiter_ceiling
    from keyboard_gui import SynthController

    wav = str(tmp_path / "kb_lim.wav")
    out = Output(samplerate=44100, nchannels=2, frames_per_chunk=2000,
                 mixing="mixed", wav_file=wav)
    try:
        ctrl = SynthController(output=out)
        ctrl.oscs[0].amplitude = 0.9
        ctrl.limiter.enabled = True
        ctrl.limiter.ceiling_db = -6.0
        ctrl.apply_reverb()
        assert out.fx is not None and out.fx.flush_frames > 0
        for key in (40, 44, 47):                # a loud chord
            ctrl.key_down(key)
        _t.sleep(0.2)
        for key in (40, 44, 47):
            ctrl.key_up(key)
        # gate voices are tracked by mixer.active_count (still_playing
        # only covers play_sample ids); generous deadline — the voice
        # AND limiter-chain first-jit compiles land inside it on a
        # loaded CI box
        deadline = _t.time() + 120.0
        while out.mixer.active_count and _t.time() < deadline:
            _t.sleep(0.02)
        assert out.mixer.active_count == 0
        _t.sleep(0.5)       # let the pump drain the holdback/fx tail
        # preset round trip carries the limiter section
        buf = io.StringIO()
        ctrl.save_preset(buf)
        buf.seek(0)
        ctrl2 = SynthController(output=out)
        ctrl2.load_preset(buf)
        assert ctrl2.limiter.enabled
        assert ctrl2.limiter.ceiling_db == pytest.approx(-6.0)
        # reverb + limiter both enabled -> chain of two, limiter last
        ctrl2.reverb.enabled = True
        ctrl2.apply_reverb()
        assert out.fx is not None and len(out.fx.processors) == 2
        ctrl2.limiter.enabled = False
        ctrl2.reverb.enabled = False
        ctrl2.apply_reverb()
        assert out.fx is None
    finally:
        out.close()
    import wave as wavemod
    w = wavemod.open(wav)
    a = np.frombuffer(w.readframes(w.getnframes()),
                      np.int16).reshape(-1, 2)
    assert np.abs(a).max() > 1000               # something played
    assert np.abs(a.astype(np.int64)).max() <= limiter_ceiling(-6.0, 2)


def test_jukebox_output_limiter(tmp_path):
    """Jukebox(limiter_db=): two hot tracks crossfading (their overlap
    would clip) stay under the brickwall ceiling, and the holdback's
    flush preserves the total output length."""
    from synthesizer_tpu.ops.coeffs import limiter_ceiling
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    synth.sine(440.0, 1.0, amplitude=0.95).stereo() \
        .write_wav(str(tmp_path / "a.wav"))
    synth.sine(445.0, 1.0, amplitude=0.95).stereo() \
        .write_wav(str(tmp_path / "b.wav"))
    lib = MusicLibrary()
    lib.scan(str(tmp_path))
    tracks = lib.search("")

    def run(limiter_db):
        box = Jukebox(lib, crossfade=0.4, frames_per_chunk=4410,
                      limiter_db=limiter_db)
        for t in tracks:
            box.enqueue(t)
        chunks = [c.get_frame_array() for c in box.chunks()]
        return np.concatenate(chunks)

    raw = run(None)
    limited = run(-3.0)
    assert len(limited) == len(raw)            # flush preserved length
    # the raw 0.95-amplitude tones exceed the -3 dB ceiling (the fade
    # ramps keep the overlap itself below full scale)
    assert np.abs(raw.astype(np.int64)).max() > limiter_ceiling(-3.0, 2)
    assert np.abs(limited.astype(np.int64)).max() \
        <= limiter_ceiling(-3.0, 2)
    # outside the overlap the tracks are untouched by more than the
    # gain ramp: the head still carries full-level audio
    assert np.abs(limited[: SR // 4].astype(np.int64)).max() > 20000
