"""MIDI import/export: writer<->parser round trip, tempo map, rendering."""

import numpy as np
import pytest

from synthesizer_tpu.midi import (MidiNote, midi_to_voices, note_to_freq,
                                  parse_midi, render_midi, write_midi)
from synthesizer_tpu.sequencer import SynthDef

SR = 44100


def test_note_to_freq():
    assert note_to_freq(69) == pytest.approx(440.0)
    assert note_to_freq(60) == pytest.approx(261.6255653)


def test_write_parse_roundtrip():
    notes = [MidiNote(0.0, 0.5, 60, 100, 0),
             MidiNote(0.25, 0.5, 64, 90, 0),
             MidiNote(0.5, 1.0, 67, 80, 1)]
    data = write_midi(notes, bpm=120)
    back = parse_midi(data)
    assert len(back) == 3
    for orig, got in zip(notes, back):
        assert got.note == orig.note and got.channel == orig.channel
        assert got.velocity == orig.velocity
        assert got.start == pytest.approx(orig.start, abs=2e-3)
        assert got.duration == pytest.approx(orig.duration, abs=4e-3)


def test_tempo_change_scales_time():
    # one note at tick 480 (one quarter): 120 bpm -> 0.5 s; 60 bpm -> 1.0 s
    fast = parse_midi(write_midi([MidiNote(0.5, 0.5, 60, 100, 0)], bpm=120))
    slow = parse_midi(write_midi([MidiNote(1.0, 1.0, 60, 100, 0)], bpm=60))
    assert fast[0].start == pytest.approx(0.5, abs=2e-3)
    assert slow[0].start == pytest.approx(1.0, abs=4e-3)


def test_running_status_and_overlap():
    # chords (simultaneous notes) exercise running status in the writer
    notes = [MidiNote(0.0, 0.4, n, 100, 0) for n in (60, 64, 67)]
    back = parse_midi(write_midi(notes))
    assert sorted(n.note for n in back) == [60, 64, 67]


def test_midi_to_voices_velocity_and_instruments():
    notes = [MidiNote(0.0, 0.5, 69, 127, 0), MidiNote(0.5, 0.5, 69, 64, 3)]
    voices = midi_to_voices(notes, {3: SynthDef(wave="sine", amplitude=0.5)})
    assert voices[0].frequency == pytest.approx(440.0)
    assert voices[0].wave == "harmonics"            # GM program 0 = piano family
    assert voices[1].wave == "sine"
    assert voices[1].amplitude == pytest.approx(0.5 * 64 / 127)


def test_render_midi_end_to_end(tmp_path):
    notes = [MidiNote(0.0, 0.3, 60, 110, 0),
             MidiNote(0.3, 0.3, 64, 110, 0),
             MidiNote(0.6, 0.4, 67, 110, 0)]
    p = str(tmp_path / "t.mid")
    open(p, "wb").write(write_midi(notes))
    s = render_midi(p, samplerate=SR)
    assert s.nchannels == 2 and s.samplerate == SR
    assert s.duration > 1.0
    a = s.get_frame_array()
    sr = SR
    # each note region sounds
    for t0 in (0.05, 0.35, 0.7):
        seg = a[int(t0 * sr):int((t0 + 0.1) * sr)]
        assert np.abs(seg).max() > 1000, t0
    # silence well after the last release
    assert np.abs(a[-100:]).max() == 0


def test_parse_rejects_garbage():
    with pytest.raises(ValueError):
        parse_midi(b"RIFFnotmidi")


def _smf(track_bytes: bytes) -> bytes:
    import struct
    return (b"MThd" + struct.pack(">IHHH", 6, 0, 1, 480)
            + b"MTrk" + struct.pack(">I", len(track_bytes)) + track_bytes)


def test_meta_event_cancels_running_status():
    # SMF spec: a meta/sysex event cancels channel running status, so a
    # data byte following one must be rejected, not parsed as another meta.
    eot = bytes([0x00, 0xFF, 0x2F, 0x00])
    on = bytes([0x00, 0x90, 60, 100])
    text_meta = bytes([0x00, 0xFF, 0x01, 0x03]) + b"abc"
    # illegal: running-status note-off after the meta event
    bad = on + text_meta + bytes([0x60, 60, 0]) + eot
    with pytest.raises(ValueError, match="running status"):
        parse_midi(_smf(bad))
    # legal: status byte restated after the meta event
    good = on + text_meta + bytes([0x60, 0x90, 60, 0]) + eot
    notes = parse_midi(_smf(good))
    assert len(notes) == 1 and notes[0].note == 60
    # running status around a meta does NOT break within-status runs
    chord = bytes([0x00, 0x90, 60, 100, 0x00, 64, 100,
                   0x60, 60, 0, 0x00, 64, 0]) + eot
    assert sorted(n.note for n in parse_midi(_smf(chord))) == [60, 64]


def test_sysex_cancels_running_status():
    eot = bytes([0x00, 0xFF, 0x2F, 0x00])
    sysex = bytes([0x00, 0xF0, 0x02, 0x7E, 0xF7])
    bad = bytes([0x00, 0x90, 60, 100]) + sysex + bytes([0x60, 60, 0]) + eot
    with pytest.raises(ValueError, match="running status"):
        parse_midi(_smf(bad))


def test_program_change_and_percussion(tmp_path):
    import struct
    from synthesizer_tpu.midi import _vlq
    # hand-build a track: program 32 (bass) on ch0, a note, and a ch9 kick
    ev = b""
    ev += _vlq(0) + bytes([0xC0, 32])                  # program change ch0
    ev += _vlq(0) + bytes([0x90, 60, 100])             # ch0 note on
    ev += _vlq(240) + bytes([0x80, 60, 0])             # ch0 note off
    ev += _vlq(0) + bytes([0x99, 36, 120])             # ch9 kick on
    ev += _vlq(120) + bytes([0x89, 36, 0])             # ch9 kick off
    ev += _vlq(0) + bytes([0xFF, 0x2F, 0x00])
    data = (b"MThd" + struct.pack(">IHHH", 6, 0, 1, 480)
            + b"MTrk" + struct.pack(">I", len(ev)) + ev)
    notes = parse_midi(data)
    assert len(notes) == 2
    assert notes[0].program == 32 and notes[0].channel == 0
    voices = midi_to_voices(notes)
    assert voices[0].wave == "sine"          # GM bass family
    assert voices[1].wave == "sine" and voices[1].frequency == 60.0  # kick
    s = render_midi(data, samplerate=SR)
    assert np.abs(s.get_frame_array()).max() > 1000


def test_song_export_midi():
    from synthesizer_tpu import WaveSynth
    from synthesizer_tpu.sequencer import Song, SynthDef
    song = Song()
    song.bpm = 240
    song.ticks = 4
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    song.add_instrument("kick", synth.sine(60, 0.05, amplitude=0.5).stereo())
    song.add_synth("lead", SynthDef(wave="sine", amplitude=0.4))
    song.add_pattern("a", {"kick": "x...x...", "lead": "A4 . C5 . E5 . . ."})
    song.pattern_sequence = ["a"]
    data = song.export_midi()
    back = parse_midi(data)
    melodic = [n for n in back if n.channel != 9]
    drums = [n for n in back if n.channel == 9]
    assert sorted(n.note for n in melodic) == [69, 72, 76]  # A4 C5 E5
    assert len(drums) == 2


def test_format1_multitrack():
    import struct
    from synthesizer_tpu.midi import _vlq
    def track(evts):
        return b"MTrk" + struct.pack(">I", len(evts)) + evts
    t1 = (_vlq(0) + bytes([0x90, 60, 100]) + _vlq(480) + bytes([0x80, 60, 0])
          + _vlq(0) + bytes([0xFF, 0x2F, 0x00]))
    t2 = (_vlq(240) + bytes([0x91, 67, 90]) + _vlq(480) + bytes([0x81, 67, 0])
          + _vlq(0) + bytes([0xFF, 0x2F, 0x00]))
    data = b"MThd" + struct.pack(">IHHH", 6, 1, 2, 480) + track(t1) + track(t2)
    notes = parse_midi(data)
    assert len(notes) == 2
    assert notes[0].note == 60 and notes[0].start == pytest.approx(0.0)
    assert notes[1].note == 67 and notes[1].start == pytest.approx(0.25, abs=1e-3)


@pytest.mark.parametrize("seed", range(4))
def test_midi_roundtrip_fuzz(seed):
    rng = np.random.default_rng(seed + 8000)
    notes = []
    t = 0.0
    for _ in range(int(rng.integers(5, 40))):
        t += float(rng.uniform(0, 0.3))
        notes.append(MidiNote(round(t, 3), round(float(rng.uniform(0.05, 1.0)), 3),
                              int(rng.integers(30, 100)),
                              int(rng.integers(1, 128)),
                              int(rng.integers(0, 16))))
    back = parse_midi(write_midi(notes, bpm=float(rng.uniform(60, 240))))
    assert len(back) == len(notes)
    want = sorted(notes, key=lambda n: (n.start, n.note))
    got = sorted(back, key=lambda n: (n.start, n.note))
    for w, g in zip(want, got):
        assert g.note == w.note and g.channel == w.channel and g.velocity == w.velocity
        assert g.start == pytest.approx(w.start, abs=5e-3)
        assert g.duration == pytest.approx(w.duration, abs=1e-2)


def test_export_midi_velocity_automation():
    """track.NAME.volume curves reach exported drum velocities."""
    from synthesizer_tpu import WaveSynth
    from synthesizer_tpu.midi import parse_midi
    from synthesizer_tpu.sequencer import Song
    ws = WaveSynth(samplerate=44100, samplewidth=2)
    song = Song()
    song.bpm = 240
    song.ticks = 4
    song.add_instrument("kick", ws.sine(60, 0.05, amplitude=0.5).stereo())
    song.add_pattern("a", {"kick": "x...x...x...x..."})
    song.pattern_sequence = ["a"]
    song.add_automation("track.kick.volume", "0:1 12:0.25")
    notes = parse_midi(song.export_midi())
    vels = [n.velocity for n in sorted(notes, key=lambda n: n.start)]
    assert vels == [100, 75, 50, 25]


def _smf1(ev: bytes) -> bytes:
    import struct
    ev += b"\x00" + bytes([0xFF, 0x2F, 0x00])
    return (b"MThd" + struct.pack(">IHHH", 6, 0, 1, 480)
            + b"MTrk" + struct.pack(">I", len(ev)) + ev)


def test_sustain_pedal_extends_notes():
    from synthesizer_tpu.midi import _vlq
    # pedal down, note on, note off at 240 ticks (0.25 s at 120 bpm),
    # pedal up at 960 ticks (1.0 s): the note rings to the pedal release
    ev = b""
    ev += _vlq(0) + bytes([0xB0, 64, 127])             # CC64 down
    ev += _vlq(0) + bytes([0x90, 60, 100])             # note on
    ev += _vlq(240) + bytes([0x80, 60, 0])             # note off (held)
    ev += _vlq(720) + bytes([0xB0, 64, 0])             # CC64 up @960
    notes = parse_midi(_smf1(ev))
    assert len(notes) == 1
    assert notes[0].duration == pytest.approx(1.0, abs=1e-6)
    # without the pedal the same file stops at 0.25 s
    ev2 = b""
    ev2 += _vlq(0) + bytes([0x90, 60, 100])
    ev2 += _vlq(240) + bytes([0x80, 60, 0])
    assert parse_midi(_smf1(ev2))[0].duration == pytest.approx(
        0.25, abs=1e-6)


def test_sustain_pedal_retrigger_and_eof():
    from synthesizer_tpu.midi import _vlq
    # a retriggered note closes the pedal-held instance at the retrigger;
    # a pedal still down at EOF closes held notes at the last event
    ev = b""
    ev += _vlq(0) + bytes([0xB0, 64, 127])
    ev += _vlq(0) + bytes([0x90, 60, 100])
    ev += _vlq(240) + bytes([0x80, 60, 0])             # held by pedal
    ev += _vlq(240) + bytes([0x90, 60, 90])            # retrigger @480
    ev += _vlq(480) + bytes([0x80, 60, 0])             # off @960, held
    notes = sorted(parse_midi(_smf1(ev)), key=lambda n: n.start)
    assert len(notes) == 2
    assert notes[0].duration == pytest.approx(0.5, abs=1e-6)   # to retrig
    assert notes[1].duration == pytest.approx(0.5, abs=1e-6)   # to EOF


def test_cc_volume_expression_pan():
    from synthesizer_tpu.midi import _vlq, midi_to_voices
    ev = b""
    ev += _vlq(0) + bytes([0xB0, 7, 64])               # half volume
    ev += _vlq(0) + bytes([0xB0, 11, 64])              # half expression
    ev += _vlq(0) + bytes([0xB0, 10, 127])             # hard right
    ev += _vlq(0) + bytes([0x90, 60, 100])
    ev += _vlq(240) + bytes([0x80, 60, 0])
    ev += _vlq(0) + bytes([0x91, 60, 100])             # ch1: no CCs
    ev += _vlq(240) + bytes([0x81, 60, 0])
    notes = sorted(parse_midi(_smf1(ev)), key=lambda n: n.channel)
    assert notes[0].volume == pytest.approx((64 / 127.0) ** 2)
    assert notes[0].pan == pytest.approx(1.0)
    assert notes[1].volume == 1.0 and notes[1].pan is None
    v0, v1 = midi_to_voices(notes)
    assert v0.amplitude == pytest.approx(v1.amplitude * (64 / 127.0) ** 2)
    assert v0.pan == pytest.approx(1.0)
    assert v1.pan == 0.0                               # SynthDef default


def test_cc_all_notes_off():
    from synthesizer_tpu.midi import _vlq
    ev = b""
    ev += _vlq(0) + bytes([0x90, 60, 100])
    ev += _vlq(0) + bytes([0x90, 64, 100])
    ev += _vlq(480) + bytes([0xB0, 123, 0])            # all notes off @0.5s
    notes = parse_midi(_smf1(ev))
    assert len(notes) == 2
    assert all(n.duration == pytest.approx(0.5, abs=1e-6) for n in notes)


def test_pitch_bend_sampled_at_note_on():
    from synthesizer_tpu.midi import _vlq, midi_to_voices, note_to_freq
    # full-up wheel (8191/8192 of the default ±2 semitone range) before
    # the note-on; a second note after re-centering is unbent
    ev = b""
    ev += _vlq(0) + bytes([0xE0, 0x7F, 0x7F])          # wheel max
    ev += _vlq(0) + bytes([0x90, 60, 100])
    ev += _vlq(240) + bytes([0x80, 60, 0])
    ev += _vlq(0) + bytes([0xE0, 0x00, 0x40])          # center (8192)
    ev += _vlq(0) + bytes([0x90, 60, 100])
    ev += _vlq(240) + bytes([0x80, 60, 0])
    notes = sorted(parse_midi(_smf1(ev)), key=lambda n: n.start)
    assert notes[0].bend == pytest.approx(8191 / 8192 * 2.0)
    assert notes[1].bend == 0.0
    v0, v1 = midi_to_voices(notes)
    # the recenter at note 0's off reaches its RELEASE TAIL (round-4
    # grace window): the note renders as a curve that holds the note-on
    # bend through the whole gate (the anchor) and recenters 1 ms into
    # the tail — the audible gate pitch is unchanged vs note-on sampling
    ratio = 2.0 ** (notes[0].bend / 12.0)
    assert v0.frequency == pytest.approx(note_to_freq(60))
    assert v0.pitch_curve[0] == (0.0, pytest.approx(ratio))
    assert v0.pitch_curve[1] == (pytest.approx(0.25, abs=2e-3),
                                 pytest.approx(ratio))
    assert v0.pitch_curve[2][1] == pytest.approx(1.0)
    assert v1.frequency == pytest.approx(note_to_freq(60))
    assert v1.pitch_curve == ()


def test_pitch_bend_rpn_range():
    from synthesizer_tpu.midi import _vlq, parse_midi
    # RPN 0,0 sets the bend range to 12.50 semitones (CC6=12, CC38=50);
    # a half-up wheel then bends by half of that
    ev = b""
    ev += _vlq(0) + bytes([0xB0, 101, 0])              # RPN MSB 0
    ev += _vlq(0) + bytes([0xB0, 100, 0])              # RPN LSB 0
    ev += _vlq(0) + bytes([0xB0, 6, 12])               # 12 semitones
    ev += _vlq(0) + bytes([0xB0, 38, 50])              # + 50 cents
    ev += _vlq(0) + bytes([0xE0, 0x00, 0x60])          # +4096 (half up)
    ev += _vlq(0) + bytes([0x90, 60, 100])
    ev += _vlq(240) + bytes([0x80, 60, 0])
    notes = parse_midi(_smf1(ev))
    assert notes[0].bend == pytest.approx(0.5 * 12.5)


def test_pitch_bend_rpn_null_guard():
    from synthesizer_tpu.midi import _vlq, parse_midi
    # CC6 with a non-bend RPN selected (or the null RPN) must NOT change
    # the bend range — the GM default ±2 stays in force
    ev = b""
    ev += _vlq(0) + bytes([0xB0, 101, 0])              # RPN 0,1 = fine tune
    ev += _vlq(0) + bytes([0xB0, 100, 1])
    ev += _vlq(0) + bytes([0xB0, 6, 12])               # fine tune data
    ev += _vlq(0) + bytes([0xE0, 0x7F, 0x7F])
    ev += _vlq(0) + bytes([0x90, 60, 100])
    ev += _vlq(240) + bytes([0x80, 60, 0])
    notes = parse_midi(_smf1(ev))
    assert notes[0].bend == pytest.approx(8191 / 8192 * 2.0)


# ---------------------------------------------------------------------------
# Continuous (mid-note) pitch bend and CC curves — round 4
# ---------------------------------------------------------------------------

def test_nrpn_select_nulls_rpn():
    from synthesizer_tpu.midi import _vlq, parse_midi
    # select RPN 0,0 and set range 12; then address an NRPN — its CC6
    # data entry must NOT be misread as another bend-range change
    ev = b""
    ev += _vlq(0) + bytes([0xB0, 101, 0])              # RPN 0,0
    ev += _vlq(0) + bytes([0xB0, 100, 0])
    ev += _vlq(0) + bytes([0xB0, 6, 12])               # range = 12 semis
    ev += _vlq(0) + bytes([0xB0, 99, 1])               # NRPN select MSB
    ev += _vlq(0) + bytes([0xB0, 98, 8])               # NRPN select LSB
    ev += _vlq(0) + bytes([0xB0, 6, 64])               # NRPN data entry
    ev += _vlq(0) + bytes([0xE0, 0x00, 0x60])          # +half wheel
    ev += _vlq(0) + bytes([0x90, 60, 100])
    ev += _vlq(240) + bytes([0x80, 60, 0])
    notes = parse_midi(_smf1(ev))
    assert notes[0].bend == pytest.approx(0.5 * 12.0)  # not 0.5 * 64


def test_mid_note_bend_becomes_curve():
    # wheel movement DURING a note -> bend_curve with the note-on value
    # at t=0 and each event at its note-relative time; notes without
    # mid-note events keep bend_curve=None (the pre-curve fast path)
    note = MidiNote(0.25, 1.0, 60, 100, 0)
    bends = [(0.5, 0, 2048), (0.75, 0, 4096), (1.0, 0, 8191)]
    notes = parse_midi(write_midi([note], bends=bends))
    n = notes[0]
    assert n.bend == 0.0
    assert n.bend_curve is not None
    ts = [t for t, _ in n.bend_curve]
    vs = [v for _, v in n.bend_curve]
    assert ts[0] == 0.0 and vs[0] == 0.0
    assert ts[1] == pytest.approx(0.25, abs=2e-3)
    assert vs[-1] == pytest.approx(8191 / 8192 * 2.0)
    # a second identical note with no wheel movement: no curve
    n2 = parse_midi(write_midi([note]))[0]
    assert n2.bend_curve is None and n2.gain_curve is None
    v2 = midi_to_voices([n2])[0]
    assert v2.pitch_curve == () and v2.amp_curve == ()


def test_bend_sweep_renders_sweep_not_stairs():
    # a +2 semitone wheel sweep over an A3: the rendered pitch must climb
    # monotonically through the note (zero-crossing estimate), ending at
    # ~the full bend — the note-on-only sampling of round 3 rendered a
    # constant 220 Hz here
    note = MidiNote(0.1, 1.0, 57, 100, 0)
    bends = [(0.1 + 0.8 * i / 16, 0, int(8191 * i / 16)) for i in range(17)]
    s = render_midi(write_midi([note], bends=bends))
    sr = s.samplerate
    x = np.frombuffer(s.view_frame_data(), np.int16).reshape(-1, 2)[:, 0]
    x = x.astype(np.float64)

    def freq_at(t0, t1):
        seg = x[int(t0 * sr):int(t1 * sr)]
        zc = np.where((seg[:-1] < 0) & (seg[1:] >= 0))[0]
        return sr / np.mean(np.diff(zc))

    f1, f2, f3 = freq_at(0.15, 0.25), freq_at(0.45, 0.55), freq_at(0.92, 1.02)
    assert f1 < f2 < f3
    assert f1 == pytest.approx(222.0, abs=4.0)        # just past onset
    assert f3 == pytest.approx(220.0 * 2 ** (2 / 12), abs=4.0)  # landed


def test_bend_curve_voice_matches_integer_twin():
    # the packed chirp segments must reproduce an independent per-frame
    # iterative integer DDS (inc_m accumulated frame by frame in exact
    # Python ints) — phase exact, sample error = f32 sine eval only
    from synthesizer_tpu.models.voicebank import (VoiceBank, pack_voices,
                                                  compile_pitch_segments)
    note = MidiNote(0.01, 0.4, 69, 100, 0)            # A4
    bends = [(0.01 + 0.3 * i / 8, 0, int(-8192 + 16383 * i / 8))
             for i in range(9)]                        # -2 .. +2 semis
    notes = parse_midi(write_midi([note], bends=bends))
    v = notes[0]
    assert v.bend_curve is not None
    voice = midi_to_voices(notes)[0]
    import dataclasses
    voice = dataclasses.replace(voice, attack=0.0, decay=0.0,
                                sustain_level=1.0, release=0.01, bias=0.0,
                                wave="sine", amplitude=0.5, harmonics=())
    vp, layout = pack_voices([voice], SR, sort_by_wave=True)
    bank = VoiceBank.for_voices([voice], SR, layout=layout,
                                nvoices=layout.nvoices)
    assert bank.use_bend
    total = int(0.45 * SR)
    out = np.asarray(bank.render_song(vp, total))[:, 0]

    starts, phases, incs, ds = compile_pitch_segments(
        voice.pitch_curve, voice.frequency, SR)
    start_f = int(voice.start * SR)
    ph, phs = 0, {}
    maxm = total - start_f
    for m in range(maxm + 1):
        phs[m] = ph
        cur = 0
        while cur + 1 < len(starts) and m >= starts[cur + 1]:
            cur += 1
        inc_m = (incs[cur] + (m - starts[cur]) * ds[cur]) % (2 ** 32)
        ph = (ph + inc_m) % (2 ** 32)
    lo, hi = start_f + 10, start_f + int(0.39 * SR)
    ref = 0.5 * np.sin(2 * np.pi * np.array(
        [phs[m - start_f] for m in range(lo, hi)], np.float64) / 2 ** 32)
    assert np.max(np.abs(out[lo:hi] - ref)) < 1e-6


def test_mid_note_cc_expression_fade():
    # CC11 ramp 127 -> 0 during the note: amplitude follows (linear-ramp
    # segments between events); mid-fade level ~= gain * sustain relative
    # to the pre-fade level
    note = MidiNote(0.0, 1.0, 69, 100, 0)
    ccs = [(0.2 + 0.6 * i / 8, 0, 11, 127 - int(127 * i / 8))
           for i in range(9)]
    data = write_midi([note], controls=ccs)
    n = parse_midi(data)[0]
    assert n.gain_curve is not None and n.gain_curve[0] == (0.0, 1.0)
    voice = midi_to_voices([n])[0]
    assert voice.amp_curve and not voice.pitch_curve
    s = render_midi(data)
    sr = s.samplerate
    x = np.frombuffer(s.view_frame_data(), np.int16).reshape(-1, 2)[:, 0]
    x = np.abs(x.astype(np.float64))
    a_pre = x[int(0.1 * sr):int(0.18 * sr)].max()
    a_mid = x[int(0.48 * sr):int(0.52 * sr)].max()
    a_end = x[int(0.78 * sr):int(0.85 * sr)].max()
    assert a_pre > a_mid > a_end
    assert a_end < 0.05 * a_pre                       # faded to ~silence
    # pedal-sustained notes keep collecting curve points too
    from synthesizer_tpu.midi import _vlq
    ev = b""
    ev += _vlq(0) + bytes([0x90, 60, 100])
    ev += _vlq(0) + bytes([0xB0, 64, 127])            # pedal down
    ev += _vlq(240) + bytes([0x80, 60, 0])            # off @0.25s (held)
    ev += _vlq(240) + bytes([0xB0, 11, 32])           # expr drop @0.5s
    ev += _vlq(240) + bytes([0xB0, 64, 0])            # pedal up @0.75s
    nn = parse_midi(_smf1(ev))[0]
    assert nn.duration == pytest.approx(0.75, abs=1e-6)
    assert nn.gain_curve is not None
    assert nn.gain_curve[-1][0] == pytest.approx(0.5, abs=2e-3)
    assert nn.gain_curve[-1][1] == pytest.approx(32 / 127.0)


def test_bend_free_render_identical_to_r3_path():
    # files without mid-note events must take the EXACT pre-curve path:
    # the packed bank carries no curve flags and renders bit-identically
    # to voices constructed the round-3 way (scalar bend ratio)
    from synthesizer_tpu.models.voicebank import VoiceBank, pack_voices
    from synthesizer_tpu.midi import render_notes
    notes = [MidiNote(0.05 * i, 0.2, 57 + 2 * i, 90, 0) for i in range(4)]
    parsed = parse_midi(write_midi(notes))
    voices = midi_to_voices(parsed)
    assert all(not v.pitch_curve and not v.amp_curve for v in voices)
    vp, layout = pack_voices(voices, SR, num_harmonics=8, sort_by_wave=True)
    bank = VoiceBank.for_voices(voices, SR, num_harmonics=8, layout=layout,
                                nvoices=layout.nvoices)
    assert not bank.use_bend and not bank.use_amp
    s = render_notes(parsed)
    assert len(s.view_frame_data()) > 0


# ---------------------------------------------------------------------------
# CC1 mod-wheel vibrato (continuous FM depth curves) — round-4 continuation
# ---------------------------------------------------------------------------

def test_cc1_mod_wheel_curve_recorded():
    # wheel movement DURING a note -> mod_curve with the note-on value at
    # t=0; a CC1-free file keeps mod_curve=None (the pre-curve fast path)
    note = MidiNote(0.0, 1.0, 69, 100, 0)
    ccs = [(0.25, 0, 1, 40), (0.5, 0, 1, 90), (0.75, 0, 1, 127)]
    n = parse_midi(write_midi([note], controls=ccs))[0]
    assert n.mod == 0.0
    assert n.mod_curve is not None and n.mod_curve[0] == (0.0, 0.0)
    assert [round(v * 127) for _, v in n.mod_curve] == [0, 40, 90, 127]
    assert n.mod_curve[1][0] == pytest.approx(0.25, abs=2e-3)
    n2 = parse_midi(write_midi([note]))[0]
    assert n2.mod == 0.0 and n2.mod_curve is None
    v2 = midi_to_voices([n2])[0]
    assert not v2.fm_depth_curve and v2.fm_depth == 0.0


def test_cc1_curve_becomes_fm_depth_curve():
    from synthesizer_tpu.midi import VIBRATO_SEMITONES, VIBRATO_RATE_HZ
    note = MidiNote(0.0, 1.0, 69, 100, 0)
    ccs = [(0.25, 0, 1, 64), (0.5, 0, 1, 127)]
    n = parse_midi(write_midi([note], controls=ccs))[0]
    v = midi_to_voices([n])[0]
    assert v.fm_depth == 0.0 and v.fm_frequency == VIBRATO_RATE_HZ
    unit = 2.0 ** (VIBRATO_SEMITONES / 12.0) - 1.0
    assert v.fm_depth_curve[0] == (0.0, 0.0)
    assert v.fm_depth_curve[-1][1] == pytest.approx(unit)
    # the bank compiles with the dmod flag
    from synthesizer_tpu.models.voicebank import VoiceBank, pack_voices
    vp, layout = pack_voices([v], SR, sort_by_wave=True)
    bank = VoiceBank.for_voices([v], SR, layout=layout, nvoices=layout.nvoices)
    assert bank.use_dmod


def test_cc1_static_wheel_maps_to_constant_fm():
    # a wheel that never moves mid-note: the constant fm_depth path (no
    # curve, no dmod flag — the exact pre-curve HLO)
    from synthesizer_tpu.midi import VIBRATO_SEMITONES
    from synthesizer_tpu.models.voicebank import VoiceBank, pack_voices
    note = MidiNote(0.1, 0.5, 69, 100, 0)
    n = parse_midi(write_midi([note], controls=[(0.0, 0, 1, 64)]))[0]
    assert n.mod == pytest.approx(64 / 127.0)
    v = midi_to_voices([n])[0]
    unit = 2.0 ** (VIBRATO_SEMITONES / 12.0) - 1.0
    assert not v.fm_depth_curve
    assert v.fm_depth == pytest.approx((64 / 127.0) * unit)
    vp, layout = pack_voices([v], SR, sort_by_wave=True)
    bank = VoiceBank.for_voices([v], SR, layout=layout, nvoices=layout.nvoices)
    assert bank.use_fm and not bank.use_dmod


def test_channel_pressure_curve_recorded():
    # channel pressure (0xD0) during a note -> mod_curve through the SAME
    # machinery as CC1; a pressure-free file keeps mod_curve=None
    note = MidiNote(0.0, 1.0, 69, 100, 0)
    presses = [(0.25, 0, 40), (0.5, 0, 90), (0.75, 0, 127)]
    n = parse_midi(write_midi([note], pressures=presses))[0]
    assert n.mod == 0.0
    assert n.mod_curve is not None and n.mod_curve[0] == (0.0, 0.0)
    assert [round(v * 127) for _, v in n.mod_curve] == [0, 40, 90, 127]
    assert n.mod_curve[1][0] == pytest.approx(0.25, abs=2e-3)
    # static pressure sampled at note-on -> the constant fm_depth path
    note2 = MidiNote(0.1, 0.5, 69, 100, 0)
    n2 = parse_midi(write_midi([note2], pressures=[(0.0, 0, 64)]))[0]
    assert n2.mod == pytest.approx(64 / 127.0) and n2.mod_curve is None
    v2 = midi_to_voices([n2])[0]
    assert not v2.fm_depth_curve and v2.fm_depth > 0.0


def test_pressure_merges_with_cc1_by_max():
    # when both the wheel and pressure move, the stronger one drives the
    # vibrato (max merge rule)
    note = MidiNote(0.0, 1.0, 69, 100, 0)
    data = write_midi([note],
                      controls=[(0.2, 0, 1, 80), (0.6, 0, 1, 10)],
                      pressures=[(0.4, 0, 30), (0.8, 0, 100)])
    n = parse_midi(write_midi([note]))[0]
    assert n.mod_curve is None            # baseline: no events, no curve
    n = parse_midi(data)[0]
    # CC1=80 > press=0; press=30 < cc1=80 -> 80; cc1=10 < press=30 -> 30;
    # press=100 > cc1=10 -> 100
    assert [round(v * 127) for _, v in n.mod_curve] == [0, 80, 80, 30, 100]


def test_pressure_sweep_matches_f64_twin():
    """A pressure-sweep SMF renders the sweep through the CC1 depth-curve
    closed form, within the CC1 budget class of the per-frame f64 twin
    ()."""
    import math
    from synthesizer_tpu.midi import VIBRATO_RATE_HZ, render_midi
    from synthesizer_tpu.models import spec as S
    sd = SynthDef(wave="sine", amplitude=0.5, attack=0.0, decay=0.0,
                  sustain_level=1.0, release=0.01)
    note = MidiNote(0.01, 0.95, 69, 127, 0)
    presses = [(0.1, 0, 10), (0.35, 0, 80), (0.8, 0, 127)]
    data = write_midi([note], pressures=presses)
    n = parse_midi(data)[0]
    v = midi_to_voices([n], instruments={0: sd})[0]
    assert v.fm_depth_curve and v.fm_frequency == VIBRATO_RATE_HZ
    s = render_midi(data, instruments={0: sd})
    out = np.frombuffer(s.view_frame_data(), np.int16).reshape(-1, 2)[:, 0]
    out = out.astype(np.float64) / 32767.0

    inc = int(S.phase_increment(440.0, SR))
    fm_inc = int(S.phase_increment(VIBRATO_RATE_HZ, SR))
    start = int(v.start * SR)            # note start is tick-quantized
    pts = [(int(t * SR), d) for t, d in v.fm_depth_curve]

    def depth(u):
        if u <= pts[0][0]:
            return pts[0][1]
        for j in range(len(pts) - 1):
            f0, d0 = pts[j]
            f1, d1 = pts[j + 1]
            if u < f1:
                return d0 + (d1 - d0) * (u - f0) / (f1 - f0)
        return pts[-1][1]

    hi = start + int(0.94 * SR)          # stop before the release ramp
    acc = 0.0
    ref = np.zeros(hi)
    for m in range(hi - start):
        nf = start + m
        p = ((nf * inc) % 2 ** 32 + inc * acc) / 2 ** 32
        ref[nf] = 0.5 * math.sin(2 * math.pi * (p % 1.0))
        lfo = (nf * fm_inc) % 2 ** 32
        acc += depth(m) * math.sin(2 * math.pi * lfo / 2 ** 32)
    # int16 quantization adds 0.5 LSB on top of the CC1 engine budget
    err = np.max(np.abs(out[start + 1:hi] - ref[start + 1:hi]))
    assert err < 8e-6 + 0.5 / 32767.0


def test_pressure_free_file_bit_identical():
    """The pressure machinery must not perturb a pressure-free render:
    same bytes in -> same voices out as before the 0xD0 support."""
    note = MidiNote(0.0, 0.5, 64, 90, 0)
    ccs = [(0.2, 0, 1, 70)]
    d_plain = write_midi([note], controls=ccs)
    v_plain = midi_to_voices(parse_midi(d_plain))
    # a zero-pressure event is the identity under the max merge
    d_zero = write_midi([note], controls=ccs, pressures=[(0.3, 0, 0)])
    v_zero = midi_to_voices(parse_midi(d_zero))
    assert len(v_plain) == len(v_zero) == 1
    a, b = v_plain[0], v_zero[0]
    assert a.fm_depth == b.fm_depth
    # the zero-pressure event adds an inert point but the same values
    assert [x[1] for x in b.fm_depth_curve][:2] == \
        [x[1] for x in a.fm_depth_curve][:2]


def test_poly_aftertouch_targets_only_its_note():
    # 0xA0 is per-NOTE pressure: a sweep on one key moves only that
    # note's depth curve; the other concurrent note on the channel is
    # untouched (stays curve-free)
    notes = [MidiNote(0.0, 1.0, 60, 100, 0), MidiNote(0.0, 1.0, 67, 100, 0)]
    pps = [(0.25, 0, 60, 40), (0.5, 0, 60, 90), (0.75, 0, 60, 127)]
    parsed = {n.note: n for n in parse_midi(write_midi(notes,
                                                       poly_pressures=pps))}
    n60, n67 = parsed[60], parsed[67]
    assert n60.mod_curve is not None
    assert [round(v * 127) for _, v in n60.mod_curve] == [0, 40, 90, 127]
    assert n67.mod == 0.0 and n67.mod_curve is None
    v60 = midi_to_voices([n60])[0]
    assert v60.fm_depth_curve


def test_poly_aftertouch_merges_with_channel_controllers():
    # the keyed note's depth = max(CC1, channel pressure, its own 0xA0);
    # the un-keyed note sees only the channel-wide controllers
    notes = [MidiNote(0.0, 1.0, 60, 100, 0), MidiNote(0.0, 1.0, 67, 100, 0)]
    data = write_midi(
        notes,
        controls=[(0.2, 0, 1, 50)],           # CC1 -> both notes: 50
        poly_pressures=[(0.4, 0, 60, 90),     # key 60 only: max(50,90)=90
                        (0.8, 0, 60, 20)],    # key 60: max(50,70,20)=70
        pressures=[(0.6, 0, 70)])             # ch-wide: 60 records
    #                                           max(50,70,90)=90, 67
    #                                           records max(50,70)=70
    parsed = {n.note: n for n in parse_midi(data)}
    assert [round(v * 127) for _, v in parsed[60].mod_curve] == \
        [0, 50, 90, 90, 70]
    assert [round(v * 127) for _, v in parsed[67].mod_curve] == [0, 50, 70]


def test_poly_aftertouch_resets_at_note_on():
    # a new instance of the same key starts poly-pressure-free: the
    # first note's 0xA0 must not leak into the retriggered note
    notes = [MidiNote(0.0, 0.4, 60, 100, 0), MidiNote(0.6, 0.4, 60, 100, 0)]
    data = write_midi(notes, poly_pressures=[(0.2, 0, 60, 120)])
    # release grace: the 0xA0 at 0.2 reaches only the first instance
    a, b = sorted(parse_midi(data), key=lambda n: n.start)
    assert a.mod_curve is not None and a.mod == 0.0
    assert b.mod == 0.0 and b.mod_curve is None


def test_poly_aftertouch_at_note_start_applies_to_that_note():
    # write_midi orders same-tick controllers BEFORE the note-on ("the
    # state the note starts in"): the note-on pressure reset must KEEP a
    # 0xA0 event from its own moment (only strictly-older stored values
    # are stale) — previously the pop ate it and the note started at
    # depth 0, losing the writer's round-trip contract
    notes = [MidiNote(0.0, 0.4, 60, 100, 0), MidiNote(0.6, 0.4, 60, 100, 0)]
    data = write_midi(notes, poly_pressures=[(0.0, 0, 60, 127)])
    a, b = sorted(parse_midi(data), key=lambda n: n.start)
    assert a.mod == 1.0                   # starts at full poly depth
    assert b.mod == 0.0 and b.mod_curve is None   # next instance: reset


def test_poly_aftertouch_zero_is_identity():
    # a zero-value 0xA0 event is inert under the max merge (the analog
    # of test_pressure_free_file_bit_identical for the poly path)
    note = MidiNote(0.0, 0.5, 64, 90, 0)
    ccs = [(0.2, 0, 1, 70)]
    v_plain = midi_to_voices(parse_midi(write_midi([note], controls=ccs)))
    v_zero = midi_to_voices(parse_midi(write_midi(
        [note], controls=ccs, poly_pressures=[(0.3, 0, 64, 0)])))
    a, b = v_plain[0], v_zero[0]
    assert a.fm_depth == b.fm_depth
    assert [x[1] for x in b.fm_depth_curve][:2] == \
        [x[1] for x in a.fm_depth_curve][:2]


def test_poly_aftertouch_renders():
    # end-to-end: a poly-AT sweep renders through the per-voice depth
    # curve engine (nonzero audio, modulated voice)
    from synthesizer_tpu.midi import render_midi
    sd = SynthDef(wave="sine", amplitude=0.4, attack=0.005, decay=0.02,
                  sustain_level=0.8, release=0.05)
    notes = [MidiNote(0.0, 0.5, 60, 100, 0), MidiNote(0.0, 0.5, 67, 100, 0)]
    data = write_midi(notes, poly_pressures=[(0.1, 0, 60, 30),
                                             (0.3, 0, 60, 127)])
    s = render_midi(data, instruments={0: sd}, samplerate=SR)
    out = np.frombuffer(s.view_frame_data(), np.int16)
    assert np.abs(out.astype(np.int64)).max() > 1000


def test_cc1_ignored_on_percussion_and_fm_instruments():
    # percussion channel: no vibrato; an instrument with its own FM keeps
    # its patch modulator (CC1 must not silently replace it)
    note9 = MidiNote(0.0, 0.3, 36, 100, 9)
    ccs = [(0.1, 9, 1, 127)]
    n9 = parse_midi(write_midi([note9], controls=ccs))[0]
    v9 = midi_to_voices([n9])[0]
    assert not v9.fm_depth_curve
    fmdef = SynthDef(wave="sine", fm_frequency=3.0, fm_depth=0.02)
    note0 = MidiNote(0.0, 0.3, 60, 100, 0)
    n0 = parse_midi(write_midi([note0], controls=[(0.1, 0, 1, 127)]))[0]
    v0 = midi_to_voices([n0], instruments={0: fmdef})[0]
    assert not v0.fm_depth_curve
    assert v0.fm_frequency == 3.0 and v0.fm_depth == 0.02


def test_vibrato_voice_matches_f64_twin():
    # the per-segment weighted-trig-sum closed form must reproduce the
    # per-frame f64 accumulation  inc * sum_{u<m} D(u) sin(2*pi*lfo(u))
    # within the derived budget (~0.2 LSB at full scale; amp 0.5 here)
    import math
    from synthesizer_tpu.models import spec as S
    from synthesizer_tpu.models.voicebank import (Voice, VoiceBank,
                                                  pack_voices)
    curve = ((0.0, 0.0), (0.1, 0.005), (0.3, 0.03), (0.35, 0.02),
             (0.8, 0.028))
    v = Voice(wave="sine", frequency=440.0, amplitude=0.5, start=0.01,
              duration=1.0, attack=0.0, decay=0.0, sustain_level=1.0,
              release=0.01, fm_frequency=5.5, fm_depth_curve=curve)
    vp, layout = pack_voices([v], SR, sort_by_wave=True)
    bank = VoiceBank.for_voices([v], SR, layout=layout,
                                nvoices=layout.nvoices)
    assert bank.use_dmod
    total = SR
    out = np.asarray(bank.render_song(vp, total))[:, 0]

    inc = int(S.phase_increment(440.0, SR))
    fm_inc = int(S.phase_increment(5.5, SR))
    start = int(0.01 * SR)
    pts = [(int(t * SR), d) for t, d in curve]

    def depth(u):
        if u <= pts[0][0]:
            return pts[0][1]
        for j in range(len(pts) - 1):
            f0, d0 = pts[j]
            f1, d1 = pts[j + 1]
            if u < f1:
                return d0 + (d1 - d0) * (u - f0) / (f1 - f0)
        return pts[-1][1]

    hi = total - 600                     # stop before the release ramp
    acc = 0.0
    ref = np.zeros(total)
    for n in range(start, hi):
        m = n - start
        p = ((n * inc) % 2 ** 32 + inc * acc) / 2 ** 32
        ref[n] = 0.5 * math.sin(2 * math.pi * (p % 1.0))
        lfo = ((start + m) * fm_inc) % 2 ** 32
        acc += depth(m) * math.sin(2 * math.pi * lfo / 2 ** 32)
    err = np.max(np.abs(out[start + 1:hi] - ref[start + 1:hi]))
    assert err < 8e-6                    # ~0.5 LSB at 16-bit, amp 0.5


def test_compile_depth_segments_closed_form_matches_direct_sum():
    import math
    from synthesizer_tpu.models import spec as S
    from synthesizer_tpu.models.voicebank import compile_depth_segments
    curve = ((0.0, 0.01), (0.05, 0.0), (0.21, 0.03), (0.6, 0.004))
    start = 777
    starts, cs, a0s, bs = compile_depth_segments(curve, 6.25, 0.1,
                                                 start, SR)
    fm_inc = int(S.phase_increment(6.25, SR))
    ph0 = int(S.phase_offset(0.1))
    pts = [(int(t * SR), d) for t, d in curve]

    def depth(u):
        for j in range(len(pts) - 1):
            if u < pts[j + 1][0]:
                f0, d0 = pts[j]
                f1, d1 = pts[j + 1]
                return d0 + (d1 - d0) * (u - f0) / (f1 - f0)
        return pts[-1][1]

    acc, k = 0.0, 0
    for m in range(max(starts) + 1):
        if k < len(starts) and m == starts[k]:
            assert abs(acc - cs[k]) < 1e-9
            k += 1
        lfo = (ph0 + (start + m) * fm_inc) % 2 ** 32
        acc += depth(m) * math.sin(2 * math.pi * lfo / 2 ** 32)
    assert k == len(starts)
    assert bs[-1] == 0.0                 # final hold segment


def test_vibrato_swell_renders_growing_wobble():
    # CC1 swell 0 -> 127 during a note: the instantaneous frequency
    # wobble (interpolated zero crossings) must grow to ~2 * f0 *
    # (2^(semis/12) - 1) peak-to-peak and start near zero
    from synthesizer_tpu.midi import VIBRATO_SEMITONES
    note = MidiNote(0.0, 1.5, 69, 100, 0)
    ccs = [(0.2 + 1.0 * i / 8, 0, 1, int(127 * i / 8)) for i in range(9)]
    s = render_midi(write_midi([note], controls=ccs))
    sr = s.samplerate
    x = np.frombuffer(s.view_frame_data(), np.int16).reshape(-1, 2)[:, 0]
    x = x.astype(np.float64)

    def wobble(t0, t1):
        seg = x[int(t0 * sr):int(t1 * sr)]
        i = np.where((seg[:-1] < 0) & (seg[1:] >= 0))[0]
        frac = seg[i] / (seg[i] - seg[i + 1])      # linear interp crossing
        t = i + frac
        f = sr / np.diff(t)
        return f.max() - f.min()

    w_early = wobble(0.05, 0.2)          # wheel still at 0
    w_late = wobble(1.0, 1.45)           # full wheel
    full = 2.0 * 440.0 * (2.0 ** (VIBRATO_SEMITONES / 12.0) - 1.0)
    assert w_early < 0.15 * full
    assert w_late == pytest.approx(full, rel=0.25)


def test_bend_after_note_off_bends_release_tail():
    # the wheel moves right after note-off: the release tail (0.4 s) must
    # bend — round 4 closed the "events after note-off are dropped"
    # limitation with a grace window
    sd = SynthDef(wave="sine", amplitude=0.4, attack=0.0, decay=0.0,
                  sustain_level=1.0, release=0.4)
    note = MidiNote(0.0, 0.5, 69, 100, 0)
    # wheel still centered at the off, then sweeps +2 semis during the
    # tail (events are SAMPLES of continuous wheel motion — the curve
    # ramps between them, hence the 0.5 anchor)
    bends = [(0.5, 0, 0), (0.52, 0, 4096), (0.6, 0, 8191)]
    data = write_midi([note], bends=bends)
    n = parse_midi(data)[0]
    assert n.bend_curve is not None
    assert n.bend_curve[-1][0] == pytest.approx(0.6, abs=2e-3)
    from synthesizer_tpu.midi import render_notes
    s = render_notes([n], instruments={0: sd})
    sr = s.samplerate
    x = np.frombuffer(s.view_frame_data(), np.int16).reshape(-1, 2)[:, 0]
    x = x.astype(np.float64)

    def freq(t0, t1):
        seg = x[int(t0 * sr):int(t1 * sr)]
        i = np.where((seg[:-1] < 0) & (seg[1:] >= 0))[0]
        t = i + seg[i] / (seg[i] - seg[i + 1])
        return sr / np.mean(np.diff(t))

    assert freq(0.2, 0.4) == pytest.approx(440.0, abs=1.5)   # in-note
    assert freq(0.7, 0.85) == pytest.approx(440.0 * 2 ** (2 / 12), abs=2.5)


def test_events_past_release_grace_are_dropped():
    from synthesizer_tpu.midi import _RELEASE_GRACE
    note = MidiNote(0.0, 0.3, 60, 100, 0)
    late = 0.3 + _RELEASE_GRACE + 0.5
    data = write_midi([note], bends=[(late, 0, 8191)],
                      controls=[(late, 0, 11, 5)])
    n = parse_midi(data)[0]
    assert n.bend_curve is None and n.gain_curve is None


def test_release_grace_derivation():
    """release_grace_for: the 2 s floor for GM/default instruments (so
    pre-derivation behavior is bit-identical), extended past a user
    instrument whose release outlasts it."""
    from synthesizer_tpu.midi import (_RELEASE_GRACE, _RELEASE_GRACE_MARGIN,
                                      release_grace_for)
    assert release_grace_for(None) == _RELEASE_GRACE
    assert release_grace_for({}) == _RELEASE_GRACE
    sd_short = SynthDef(wave="sine", release=0.3)
    assert release_grace_for({0: sd_short}) == _RELEASE_GRACE
    sd_long = SynthDef(wave="sine", release=4.0)
    assert release_grace_for({0: sd_long}) == 4.0 + _RELEASE_GRACE_MARGIN


def test_long_release_tail_follows_post_grace_bend():
    """A 4 s-release pad's tail must follow a bend 3 s after note-off
    (past the old fixed 2 s grace) — the grace derives from the
    instrument's actual ADSR release."""
    from synthesizer_tpu.midi import release_grace_for, render_midi
    sd = SynthDef(wave="sine", amplitude=0.4, attack=0.0, decay=0.0,
                  sustain_level=1.0, release=4.0)
    note = MidiNote(0.0, 0.5, 69, 100, 0)
    bends = [(0.5, 0, 0), (3.0, 0, 8191)]      # sweep to +2 over the tail
    data = write_midi([note], bends=bends)
    # the default (floor) grace drops the 3.0 s event ...
    n_default = parse_midi(data)[0]
    assert n_default.bend_curve is None or \
        n_default.bend_curve[-1][0] < 2.6
    # ... the derived grace keeps it
    n = parse_midi(data, release_grace=release_grace_for({0: sd}))[0]
    assert n.bend_curve is not None
    assert n.bend_curve[-1][0] == pytest.approx(3.0, abs=2e-3)
    # and render_midi wires the derivation in end to end
    s = render_midi(data, instruments={0: sd})
    sr = s.samplerate
    x = np.frombuffer(s.view_frame_data(), np.int16).reshape(-1, 2)[:, 0]
    x = x.astype(np.float64)

    def freq(t0, t1):
        seg = x[int(t0 * sr):int(t1 * sr)]
        i = np.where((seg[:-1] < 0) & (seg[1:] >= 0))[0]
        t = i + seg[i] / (seg[i] - seg[i + 1])
        return sr / np.mean(np.diff(t))

    assert freq(0.2, 0.4) == pytest.approx(440.0, abs=1.5)   # in-note
    # end of tail: the wheel landed at +2 semitones at 3.0 s and holds
    assert freq(3.2, 3.8) == pytest.approx(440.0 * 2 ** (2 / 12), abs=2.5)


def test_cc11_after_note_off_fades_release_tail():
    sd = SynthDef(wave="sine", amplitude=0.4, attack=0.0, decay=0.0,
                  sustain_level=1.0, release=0.6)
    note = MidiNote(0.0, 0.3, 69, 100, 0)
    # expression chop right after the off: the tail must go near-silent
    # well before the 0.6 s release would have decayed it (0.3 anchor:
    # full expression until the off, then the chop)
    data = write_midi([note], controls=[(0.3, 0, 11, 127), (0.33, 0, 11, 2)])
    n = parse_midi(data)[0]
    assert n.gain_curve is not None
    from synthesizer_tpu.midi import render_notes
    s = render_notes([n], instruments={0: sd})
    sr = s.samplerate
    x = np.abs(np.frombuffer(s.view_frame_data(), np.int16)
               .reshape(-1, 2)[:, 0].astype(np.float64))
    a_tail = x[int(0.4 * sr):int(0.5 * sr)].max()
    # without the post-off event the tail at 0.45 s is ~half the gate
    # level; with CC11=2 it must sit at ~2/127 of it
    a_gate = x[int(0.1 * sr):int(0.25 * sr)].max()
    assert a_tail < 0.05 * a_gate


# -- SMPTE time divisions ----------------------------------------------------

def _smf_smpte(track_bytes: bytes, fps: int, tpf: int) -> bytes:
    import struct
    division = ((256 - fps) << 8) | tpf       # negative fps, ticks/frame
    return (b"MThd" + struct.pack(">IHHH", 6, 0, 1, division)
            + b"MTrk" + struct.pack(">I", len(track_bytes)) + track_bytes)


def test_smpte_division_timing():
    """25 fps x 40 ticks/frame = exactly 1 ms per tick (the common SMPTE
    millisecond grid); a 500-tick note is 0.5 s starting at 0.25 s."""
    eot = bytes([0x00, 0xFF, 0x2F, 0x00])
    trk = (bytes([0x81, 0x7A, 0x90, 60, 100])     # delta 250 -> note on
           + bytes([0x83, 0x74, 0x80, 60, 0])     # delta 500 -> note off
           + eot)
    (n,) = parse_midi(_smf_smpte(trk, 25, 40))
    assert n.note == 60
    assert abs(n.start - 0.25) < 1e-9
    assert abs(n.duration - 0.5) < 1e-9


def test_smpte_timing_ignores_tempo_events():
    """SMPTE timing is absolute: a tempo meta event must NOT rescale it."""
    eot = bytes([0x00, 0xFF, 0x2F, 0x00])
    tempo = bytes([0x00, 0xFF, 0x51, 0x03, 0x03, 0x0D, 0x40])  # 200000 us
    trk = (tempo + bytes([0x81, 0x7A, 0x90, 60, 100])
           + bytes([0x83, 0x74, 0x80, 60, 0]) + eot)
    (n,) = parse_midi(_smf_smpte(trk, 25, 40))
    assert abs(n.start - 0.25) < 1e-9 and abs(n.duration - 0.5) < 1e-9


def test_smpte_2997_drop_frame_rate():
    """fps byte -29 means 29.97 drop-frame (SMF spec), not 29 — and the
    exact NTSC rate 30000/1001, not the 29.97 literal (1 ppm drift)."""
    eot = bytes([0x00, 0xFF, 0x2F, 0x00])
    trk = (bytes([0x00, 0x90, 60, 100])
           + bytes([0x81, 0x0B, 0x80, 60, 0]) + eot)    # delta 139 ticks
    (n,) = parse_midi(_smf_smpte(trk, 29, 4))
    assert abs(n.duration - 139 / (30000.0 / 1001.0 * 4)) < 1e-9


def test_smpte_bad_division_rejected():
    eot = bytes([0x00, 0xFF, 0x2F, 0x00])
    trk = bytes([0x00, 0x90, 60, 100, 0x10, 0x80, 60, 0]) + eot
    with pytest.raises(ValueError, match="SMPTE"):
        parse_midi(_smf_smpte(trk, 23, 40))    # 23 fps is not a SMPTE rate
    with pytest.raises(ValueError, match="SMPTE"):
        parse_midi(_smf_smpte(trk, 25, 0))     # zero ticks/frame


def test_write_midi_derives_pan_and_program_events():
    """Note pan/program fields round-trip through the SMF: the writer
    emits CC10 / 0xC0 before any note-on whose field differs from the
    channel's tracked state, and parse_midi reads them back (pan to the
    nearest 7-bit step); default-only files serialize without any
    derived events."""
    notes = [MidiNote(0.0, 0.5, 60, 100, 0, program=24, pan=-0.3),
             MidiNote(0.5, 0.5, 64, 90, 0, program=24, pan=-0.3),
             MidiNote(0.0, 1.0, 45, 80, 1, program=33, pan=0.5)]
    back = sorted(parse_midi(write_midi(notes)),
                  key=lambda n: (n.channel, n.start))
    assert [n.program for n in back] == [24, 24, 33]
    for orig, got in zip(notes, back):
        assert got.pan == pytest.approx(orig.pan, abs=1 / 63)
    # state-tracked: the repeated (program, pan) on channel 0 emits ONE
    # CC10 and ONE program change, not one per note
    data = write_midi(notes)
    assert data.count(bytes([0xB0, 10])) == 1
    assert data.count(bytes([0xC0, 24])) == 1
    # defaults emit nothing derived (byte-level: no 0xC0/0xB0-10 events)
    plain = write_midi([MidiNote(0.0, 0.5, 60, 100, 0)])
    assert bytes([0xC0]) not in plain and bytes([0xB0, 10]) not in plain
    assert parse_midi(plain)[0].pan is None


def test_write_midi_explicit_cc10_disables_pan_derivation():
    """A caller-provided CC10 lane owns the channel's pan: the writer
    must not interleave derived pan events with it."""
    notes = [MidiNote(0.1, 0.5, 60, 100, 0, pan=-1.0)]
    data = write_midi(notes, controls=[(0.0, 0, 10, 127)])
    assert data.count(bytes([0xB0, 10])) == 1      # only the explicit one
    assert parse_midi(data)[0].pan == pytest.approx(1.0)


def test_write_parse_fixed_point_fuzz(rng):
    """After ONE write->parse round trip every time is tick-quantized and
    every controller value is 7-bit, so a SECOND round trip must be a
    FIXED POINT: identical SMF bytes and identical parsed fields
    (including derived pan/program events and controller curves)."""
    for _ in range(6):
        notes, t = [], 0.0
        nch = int(rng.integers(1, 4))
        for _ in range(int(rng.integers(4, 25))):
            t += float(rng.uniform(0, 0.3))
            notes.append(MidiNote(
                round(t, 3), round(float(rng.uniform(0.05, 1.0)), 3),
                int(rng.integers(30, 100)), int(rng.integers(1, 128)),
                int(rng.integers(0, nch)),
                program=int(rng.integers(0, 128)),
                pan=float(rng.uniform(-1, 1)) if rng.random() < 0.5
                else None))
        end = t + 1.5
        bends = [(float(rng.uniform(0, end)), int(rng.integers(0, nch)),
                  int(rng.integers(-8192, 8192)))
                 for _ in range(int(rng.integers(0, 12)))]
        controls = [(float(rng.uniform(0, end)), int(rng.integers(0, nch)),
                     int(rng.choice([1, 7, 11])), int(rng.integers(0, 128)))
                    for _ in range(int(rng.integers(0, 12)))]
        pressures = [(float(rng.uniform(0, end)), int(rng.integers(0, nch)),
                      int(rng.integers(0, 128)))
                     for _ in range(int(rng.integers(0, 8)))]
        smf1 = write_midi(notes, bends=bends, controls=controls,
                          pressures=pressures)
        p1 = parse_midi(smf1)
        # fixed point on the note/pan/program lanes: every scalar field
        # survives a second round trip.  Times are tick-exact; the float
        # SECONDS may differ by ulps because the parser accumulates
        # per-event deltas and the rewritten file has fewer interleaved
        # events — compare at tick resolution (1e-9 << one tick)
        p2 = parse_midi(write_midi(p1))
        assert len(p2) == len(p1)
        key = lambda n: (round(n.start, 6), n.channel, n.note)
        for a, b in zip(sorted(p1, key=key), sorted(p2, key=key)):
            assert (a.note, a.velocity, a.channel, a.program) == \
                (b.note, b.velocity, b.channel, b.program)
            assert b.start == pytest.approx(a.start, abs=1e-9)
            assert b.duration == pytest.approx(a.duration, abs=1e-9)
            if a.pan is None:
                assert b.pan is None
            else:
                assert b.pan == pytest.approx(a.pan, abs=1e-9)


def test_write_midi_same_tick_state_changes_interleave():
    """Two same-tick notes on one channel with different programs/pans
    must each parse back with THEIR value: the derived channel-state
    events interleave immediately before their own note-on instead of
    all sorting ahead of both ons."""
    notes = [MidiNote(0.0, 1.0, 60, 100, 0, program=5, pan=-0.5),
             MidiNote(0.0, 1.0, 64, 100, 0, program=7, pan=0.5)]
    back = sorted(parse_midi(write_midi(notes)), key=lambda n: n.note)
    assert [n.program for n in back] == [5, 7]
    assert back[0].pan == pytest.approx(-0.5, abs=1 / 63)
    assert back[1].pan == pytest.approx(0.5, abs=1 / 63)


def test_write_midi_accepts_iterator():
    """A one-shot generator input serializes every note (the writer
    materializes the sequence once)."""
    data = write_midi(MidiNote(0.1 * i, 0.2, 60 + i, 100, 0)
                      for i in range(5))
    assert len(parse_midi(data)) == 5
