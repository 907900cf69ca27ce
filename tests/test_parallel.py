"""Voice-axis sharding over the 8-device CPU mesh + graft entry points."""

import numpy as np
import pytest

import jax

from synthesizer_tpu.models.voicebank import VoiceBank, pack_voices
from synthesizer_tpu.parallel.mesh import (render_song_sharded,
                                           shard_voice_params, voice_mesh)

import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__ as graft  # noqa: E402

SR = 8000


def test_sharded_matches_single_device():
    voices = graft._demo_voices(64)
    vp = pack_voices(voices, SR, num_harmonics=4)
    total = 2048
    single = np.asarray(VoiceBank(64, SR, chunk_frames=512,
                                  num_harmonics=4).render_song(vp, total))
    mesh = voice_mesh(8)
    sharded = np.asarray(render_song_sharded(vp, total, SR, chunk_frames=512,
                                             num_harmonics=4, mesh=mesh))
    # identical voices, different f32 summation order across shards
    np.testing.assert_allclose(sharded, single, atol=2e-5)


def test_mesh_uses_requested_devices():
    mesh = voice_mesh(4)
    assert mesh.devices.size == 4


def test_indivisible_voice_count_raises():
    vp = pack_voices(graft._demo_voices(12), SR, pad_to=4)  # 12 voices
    with pytest.raises(ValueError):
        render_song_sharded(vp, 256, SR, chunk_frames=128,
                            mesh=voice_mesh(8))


def _make_song():
    from synthesizer_tpu import WaveSynth
    from synthesizer_tpu.sequencer import Song, SynthDef
    ws = WaveSynth(samplerate=44100, samplewidth=2)
    song = Song()
    song.bpm = 480
    song.ticks = 2
    song.add_instrument("kick", ws.sine(60, 0.05, amplitude=0.8)
                        .fadeout(0.04).stereo())
    song.add_instrument("hat", ws.white_noise(duration=0.02, amplitude=0.4,
                                              seed=3).stereo())
    song.add_synth("lead", SynthDef(wave="square_bl", amplitude=0.2,
                                    release=0.02))
    song.add_synth("bass", SynthDef(wave="sine", amplitude=0.25, release=0.02,
                                    fm_frequency=4.0, fm_depth=0.01))
    song.add_pattern("a", {"kick": "x.x.x.x.", "hat": "xxxxxxxx",
                           "lead": "C4 . E4 . G4 . C5 .",
                           "bass": "C2 - - - G2 - - -"})
    song.pattern_sequence = ["a", "a"]
    return song


def test_song_mix_sharded_matches_single_device():
    """Flagship song path over the 8-device mesh: the drum
    scatter-add psum is bit-exact; synth voices differ only by f32 psum
    summation order (<= 1 LSB after int16 quantization)."""
    song = _make_song()
    mesh = voice_mesh(8)
    single = song.mix(normalize=False).get_frame_array()
    sharded = song.mix(normalize=False, mesh=mesh).get_frame_array()
    d = np.abs(sharded.astype(np.int64) - single.astype(np.int64))
    assert d.max() <= 1, f"max {d.max()} LSB"

    # drum-only song: int32 psum must be BIT-exact vs single device
    drum = _make_song()
    drum.synths.clear()
    for p in drum.patterns.values():
        p.pop("lead", None)
        p.pop("bass", None)
    a = drum.mix(normalize=False).get_frame_array()
    b = drum.mix(normalize=False, mesh=mesh).get_frame_array()
    np.testing.assert_array_equal(a, b)


def test_song_streaming_sharded_equals_offline():
    song = _make_song()
    mesh = voice_mesh(8)
    offline = song.mix(normalize=False, mesh=mesh).get_frame_array()
    chunks = [c.get_frame_array()
              for c in song.mix_generator(chunk_frames=1000, mesh=mesh)]
    got = np.concatenate(chunks)
    np.testing.assert_array_equal(got, offline[:len(got)])
    # seek composes with sharding: resume mid-song, mid-chunk, on the mesh
    k = 3217
    chunks = [c.get_frame_array()
              for c in song.mix_generator(chunk_frames=1000, mesh=mesh,
                                          start_frame=k)]
    got = np.concatenate(chunks)
    np.testing.assert_array_equal(got, offline[k:k + len(got)])


def test_midi_render_sharded_matches_single_device():
    """render_midi(mesh=) shards the voice axis — including continuous
    bend, CC7/CC11 gain, and CC1+pressure depth curves —
    and matches the single-device render within 1 LSB (one f32 psum,
    quantized once)."""
    from synthesizer_tpu.midi import MidiNote, render_midi, write_midi
    from synthesizer_tpu.sequencer import SynthDef
    sd = SynthDef(wave="sine", amplitude=0.4, attack=0.005, decay=0.02,
                  sustain_level=0.8, release=0.05)
    notes = [MidiNote(0.02 * i, 0.25, 52 + 3 * i, 90 + i, 0)
             for i in range(10)]
    data = write_midi(
        notes,
        bends=[(0.05, 0, 0), (0.15, 0, 4096), (0.25, 0, 8191)],
        controls=[(0.1, 0, 1, 30), (0.2, 0, 1, 100),      # CC1 sweep
                  (0.12, 0, 11, 90), (0.22, 0, 11, 40)],  # CC11 fade
        pressures=[(0.18, 0, 80)])
    single = render_midi(data, instruments={0: sd}, samplerate=SR)
    mesh = voice_mesh(8)
    sharded = render_midi(data, instruments={0: sd}, samplerate=SR,
                          mesh=mesh)
    a = single.get_frame_array().astype(np.int64)
    b = sharded.get_frame_array().astype(np.int64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1
    assert np.abs(a).max() > 1000       # actually rendered something


def test_graft_entry_compiles():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (2048, 2)
    assert np.isfinite(np.asarray(out)).all()


def test_graft_dryrun_multichip():
    graft.dryrun_multichip(8)


def test_track_fx_automation_sharded_matches_single_device():
    """Per-track fx automation under mesh=: the lead's swept filter and
    the kick's bus echo curve process identically on the gathered
    post-psum buses (<= the synth bus's 1-LSB f32-psum class, amplified
    through the filter — budget 4)."""
    song = _make_song()
    song.add_track_fx("lead", [("filter", "kind=lowpass cutoff=2000")])
    song.add_track_fx("kick", [("echo", "delay=0.03 feedback=0.4 wet=0.1")],
                      bus=True)
    song.add_automation("fx.lead.filter.cutoff", "0:300 16:8000")
    song.add_automation("fx.kick.echo.wet", "0:0.0 16:0.7")
    mesh = voice_mesh(8)
    single = song.mix(normalize=False).get_frame_array()
    sharded = song.mix(normalize=False, mesh=mesh).get_frame_array()
    assert sharded.shape == single.shape
    d = np.abs(sharded.astype(np.int64) - single.astype(np.int64)).max()
    assert d <= 4, f"max {d} LSB"
    # streaming twin on the mesh agrees with the sharded offline mix
    got = np.concatenate([c.get_frame_array() for c in
                          song.mix_generator(chunk_frames=1000, mesh=mesh)])
    d2 = np.abs(got.astype(np.int64)
                - sharded[:len(got)].astype(np.int64)).max()
    assert d2 <= 4, f"max {d2} LSB"


def test_master_chain_budget_formula_tracks():
    """The mesh swept-chain budget is DERIVED:
    ops.coeffs.master_chain_error_bound composes the pre-master bus
    error through each stage's gain bound.  Vary the chain and check the
    formula tracks — measured error stays under the bound for each
    variant, and the bound itself responds to the knobs."""
    from synthesizer_tpu.ops.coeffs import master_chain_error_bound

    def mixes(fx_lines, autos):
        song = _make_song()
        for name, params in fx_lines:
            song.add_fx(name, **params)
        for target, curve in autos:
            song.add_automation(target, curve)
        single = song.mix(normalize=False).get_frame_array()
        sharded = song.mix(normalize=False,
                           mesh=voice_mesh(8)).get_frame_array()
        return np.abs(sharded.astype(np.int64)
                      - single.astype(np.int64)).max()

    sr = 44100
    light = [
        ("eq_band", {"kind": "peaking", "freq": 1200.0, "q": 1.0,
                     "gains_db": [2.0]}),
        ("echo", {"feedback": 0.2, "wet": 0.2, "dry": 1.0}),
        ("width", {"amount": 1.1}),
    ]
    heavy = [
        ("eq_band", {"kind": "peaking", "freq": 1200.0, "q": 1.0,
                     "gains_db": [-9.0, 6.0]}),
        ("echo", {"feedback": 0.6, "wet": 0.5, "dry": 1.0}),
        ("phaser", {"stages": 4, "q": 0.7071, "min_freq": 300.0,
                    "max_freq": 3000.0, "wet": 0.7, "dry": 1.0}),
        ("width", {"amount": 2.0}),
        ("limiter", {}),
    ]
    b_light = master_chain_error_bound(light, sr, e_in_lsb=2.0)
    b_heavy = master_chain_error_bound(heavy, sr, e_in_lsb=2.0)
    assert b_heavy > b_light > 2.0          # the formula responds to knobs

    d_light = mixes(
        [("eq", dict(mid_db=2, mid_freq=1200)),
         ("echo", dict(delay=0.05, feedback=0.2, wet=0.2)),
         ("width", dict(amount=1.1))], [])
    assert d_light <= b_light, (d_light, b_light)

    d_heavy = mixes(
        [("eq", dict(mid_db=6, mid_freq=1200)),
         ("echo", dict(delay=0.05, feedback=0.6, wet=0.5)),
         ("phaser", dict(rate=0.8, depth=1.0, stages=4, wet=0.7)),
         ("width", dict(amount=2.0)),
         ("limiter", dict(ceiling_db=-2, lookahead=0.003))],
        [("fx.eq.mid_db", "0:-9 2:6")])
    assert d_heavy <= b_heavy, (d_heavy, b_heavy)
