"""Master-bus [fx] chain: ini parsing, offline (fused Sample ops) vs
streaming (stateful chunk processors) agreement, tail draining, and the
chunk-size invariance of each streaming processor.
"""

import numpy as np
import pytest

from synthesizer_tpu import Sample, WaveSynth
from synthesizer_tpu.sequencer import Song
from synthesizer_tpu import effects as fxmod
from synthesizer_tpu.effects import (FxChain, parse_fx_items,
                                     StreamingChorus, StreamingCompressor,
                                     StreamingConvolver, StreamingReverb)

SR = 44100


def make_song(fx=()):
    synth = WaveSynth(samplerate=SR, samplewidth=2)
    song = Song()
    song.bpm = 240
    song.ticks = 4
    song.add_instrument("kick", synth.sine(60.0, 0.12, amplitude=0.9)
                        .fadeout(0.08).stereo())
    song.add_instrument("hat", synth.white_noise(duration=0.03, amplitude=0.3,
                                                 seed=4).fadeout(0.02).stereo())
    song.add_pattern("a", {"kick": "x... x... x... x...",
                           "hat": "x.x. x.x. x.x. x.x."})
    song.pattern_sequence = ["a", "a"]
    for name, kw in fx:
        song.add_fx(name, **kw)
    return song


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

def test_parse_fx_items():
    fx = parse_fx_items([("chorus", "rate=1.5 depth=0.003 voices=2"),
                         ("compress", "threshold_db=-15 ratio=4"),
                         ("reverb", ""),
                         ("convolve", "ir=hall.wav wet=0.5")])
    assert [n for n, _ in fx] == ["chorus", "compress", "reverb", "convolve"]
    assert fx[0][1] == {"rate": 1.5, "depth": 0.003, "voices": 2}
    assert isinstance(fx[0][1]["voices"], int)
    assert fx[3][1]["ir"] == "hall.wav"


def test_parse_fx_rejects_garbage():
    with pytest.raises(ValueError, match="unknown effect"):
        parse_fx_items([("flanger", "")])
    with pytest.raises(ValueError, match="unknown parameter"):
        parse_fx_items([("reverb", "room=0.5")])
    with pytest.raises(ValueError, match="key=value"):
        parse_fx_items([("reverb", "0.5")])
    with pytest.raises(ValueError, match="ir="):
        parse_fx_items([("convolve", "wet=1.0")])


def test_song_ini_fx_roundtrip(tmp_path):
    ini = tmp_path / "song.ini"
    wav = tmp_path / "beep.wav"
    WaveSynth(samplerate=SR, samplewidth=2).sine(200, 0.05).stereo() \
        .write_wav(str(wav))
    ini.write_text("""
[song]
bpm = 240
ticks = 4
patterns = a
[instruments]
beep = beep.wav
[pattern.a]
beep = x... x...
[fx]
compress = threshold_db=-12 ratio=3
reverb = roomsize=0.6 wet=0.25 tail=0.2
""")
    song = Song.from_ini(str(ini))
    assert [n for n, _ in song.fx] == ["compress", "reverb"]
    mixed = song.mix(normalize=False, tail_seconds=0.0)
    # reverb extends the mix by its tail
    assert mixed.nframes == song.duration_frames() + int(0.2 * SR)


# ---------------------------------------------------------------------------
# Offline vs streaming agreement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1000, 4096])
def test_streaming_fx_equals_offline(chunk):
    fx = [("chorus", dict(rate=2.0, depth=0.002, delay=0.012, wet=0.4)),
          ("compress", dict(threshold_db=-15.0, ratio=4.0, attack=0.002,
                            release=0.05)),
          ("reverb", dict(roomsize=0.7, damping=0.5, wet=0.3, dry=0.7,
                          tail=0.25))]
    song = make_song(fx)
    offline = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=chunk)])
    assert len(got) == len(offline)
    d = np.abs(got.astype(np.int64) - offline.astype(np.int64)).max()
    # chorus exact; compressor 2 + reverb 4 budgets, composed
    assert d <= 8, d


def test_streaming_fx_tail_drains():
    song = make_song([("reverb", dict(tail=0.3, wet=0.5))])
    chunks = [c.get_frame_array() for c in song.mix_generator(chunk_frames=2000)]
    got = np.concatenate(chunks)
    assert len(got) == song.duration_frames() + int(0.3 * SR)
    # the drained tail actually rings (reverb energy past the programme)
    tail = got[song.duration_frames():]
    assert np.abs(tail[: int(0.05 * SR)]).max() > 0


def test_convolve_fx_through_song(tmp_path):
    ir = WaveSynth(samplerate=SR, samplewidth=2) \
        .white_noise(duration=0.01, amplitude=0.5, seed=9).fadeout(0.008)
    song = make_song()
    song.add_fx("convolve", ir=ir, wet=0.3, dry=0.8)
    offline = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=1500)])
    assert len(got) == len(offline)
    d = np.abs(got.astype(np.int64) - offline.astype(np.int64)).max()
    assert d <= max(8, 1e-4 * np.abs(offline).max())


# ---------------------------------------------------------------------------
# Chunk-size invariance of the processors themselves
# ---------------------------------------------------------------------------

def _chunked(proc_factory, x, sizes):
    proc = proc_factory()
    outs = []
    i = 0
    k = 0
    import jax.numpy as jnp
    while i < len(x):
        n = sizes[k % len(sizes)]
        outs.append(np.asarray(proc.process(jnp.asarray(x[i:i + n]))))
        i += n
        k += 1
    return np.concatenate(outs)


@pytest.mark.parametrize("factory,budget", [
    (lambda: StreamingCompressor(SR, threshold_db=-15.0, ratio=4.0,
                                 attack=0.002, release=0.05), 2),
    (lambda: StreamingReverb(SR, 2, roomsize=0.8, wet=0.4, tail=0.0), 4),
    (lambda: StreamingChorus(SR, 2, rate=3.0, depth=0.002, delay=0.01), 1),
])
def test_processor_chunk_invariance(rng, factory, budget):
    x = rng.integers(-15000, 15000, size=(7000, 2)).astype(np.int16)
    a = _chunked(factory, x, [7000])
    b = _chunked(factory, x, [997, 1024, 333])
    d = np.abs(a.astype(np.int64) - b.astype(np.int64)).max()
    assert d <= budget, d


def test_convolver_chunk_invariance(rng):
    x = rng.integers(-15000, 15000, size=(5000, 2)).astype(np.int16)
    irn = (rng.normal(0, 0.1, size=200) *
           np.exp(-np.arange(200) / 50.0)).astype(np.float32)
    a = _chunked(lambda: StreamingConvolver(irn, wet=0.5, dry=0.5), x, [5000])
    b = _chunked(lambda: StreamingConvolver(irn, wet=0.5, dry=0.5), x,
                 [640, 2048])
    d = np.abs(a.astype(np.int64) - b.astype(np.int64)).max()
    assert d <= 8, d


def test_streaming_chorus_equals_sample_op_1lsb(rng):
    # gathers are exact; the remaining <=1 LSB is backend FMA contraction
    # differing between the per-chunk-shape compilations (the same class
    # budgeted for to_mono/fades, see ops.pcm.to_mono)
    x = rng.integers(-15000, 15000, size=(6000, 2)).astype(np.int16)
    whole = Sample.from_raw_frames(x.tobytes(), 2, SR, 2) \
        .chorus(rate=2.5, depth=0.002, delay=0.01).get_frame_array()
    chunked = _chunked(lambda: StreamingChorus(SR, 2, rate=2.5, depth=0.002,
                                               delay=0.01), x, [700, 1100])
    d = np.abs(chunked.astype(np.int64) - whole.astype(np.int64)).max()
    assert d <= 1, d


# ---------------------------------------------------------------------------
# Per-track [fx.INSTRUMENT] chains
# ---------------------------------------------------------------------------

def test_track_fx_applies_to_instrument(tmp_path):
    ini = tmp_path / "song.ini"
    WaveSynth(samplerate=SR, samplewidth=2).sine(200, 0.05).stereo() \
        .write_wav(str(tmp_path / "beep.wav"))
    ini.write_text("""
[song]
bpm = 240
ticks = 4
patterns = a
[instruments]
beep = beep.wav
[pattern.a]
beep = x... x...
[fx.beep]
reverb = roomsize=0.5 wet=0.4 tail=0.1
""")
    song = Song.from_ini(str(ini))
    # the banked instrument grew by the reverb tail
    assert song.instruments["beep"].nframes == int(0.05 * SR) + int(0.1 * SR)
    # and per-track fx reach offline AND streaming identically (the
    # processed sample enters the hit bank before scheduling)
    offline = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=1000)])
    np.testing.assert_array_equal(got, offline[:len(got)])


def test_track_fx_unknown_instrument(tmp_path):
    ini = tmp_path / "song.ini"
    WaveSynth(samplerate=SR, samplewidth=2).sine(200, 0.05).stereo() \
        .write_wav(str(tmp_path / "beep.wav"))
    ini.write_text("""
[song]
bpm = 240
ticks = 4
patterns = a
[instruments]
beep = beep.wav
[pattern.a]
beep = x...
[fx.ghost]
reverb = wet=0.4
""")
    with pytest.raises(ValueError, match="unknown instrument"):
        Song.from_ini(str(ini))


def test_output_master_fx(tmp_path):
    """Output(fx=FxChain) processes the realtime mix through the master
    chain (incl. the reverb tail ringing past the voice end)."""
    import time as _t
    import wave as _wave
    from synthesizer_tpu import Output
    chain = FxChain([("reverb", dict(roomsize=0.8, wet=0.6, dry=0.5,
                                     tail=0.2))], SR, 2)
    wavpath = str(tmp_path / "fx.wav")
    with Output(samplerate=SR, nchannels=2, frames_per_chunk=2000,
                mixing="mixed", wav_file=wavpath, fx=chain) as out:
        tone = WaveSynth(samplerate=SR, samplewidth=2) \
            .sine(440, 0.15, amplitude=0.7).stereo()
        out.play_sample(tone)
        deadline = _t.time() + 10.0
        while out.still_playing() and _t.time() < deadline:
            _t.sleep(0.01)
        _t.sleep(0.3)   # let tail chunks pump
    w = _wave.open(wavpath)
    a = np.frombuffer(w.readframes(w.getnframes()), np.int16).reshape(-1, 2)
    n_tone = int(0.15 * SR)
    assert len(a) > n_tone
    tail = a[n_tone + 2000:]
    assert np.abs(tail).max() > 50   # the reverb tail rings after the tone


def test_output_fx_lookahead_superblocks(tmp_path):
    """Output(fx=, fx_lookahead=4) runs the chain once per 4 chunks (one
    device sync per superblock).  The chain is
    stateful at any chunk size, so the audio matches lookahead=1 within
    the effect's chunk-regrouping budget, and the reverb tail still rings
    past the voice end."""
    import time as _t
    import wave as _wave
    from synthesizer_tpu import Output

    def render(lookahead):
        chain = FxChain([("reverb", dict(roomsize=0.8, wet=0.6, dry=0.5,
                                         tail=0.2))], SR, 2)
        # pre-compile this run's chunk shape through a THROWAWAY chain
        # (the jitted programs are cached per shape at module level): a
        # cold reverb compile takes tens of seconds on CPU and would
        # stall the pump past the Output close timeout, losing the tone
        import jax.numpy as jnp
        warm = FxChain([("reverb", dict(roomsize=0.8, wet=0.6, dry=0.5,
                                        tail=0.2))], SR, 2)
        warm.process(jnp.zeros((2000 * lookahead, 2), jnp.int16))
        wavpath = str(tmp_path / f"fx_la{lookahead}.wav")
        with Output(samplerate=SR, nchannels=2, frames_per_chunk=2000,
                    mixing="mixed", wav_file=wavpath, fx=chain,
                    fx_lookahead=lookahead) as out:
            tone = WaveSynth(samplerate=SR, samplewidth=2) \
                .sine(440, 0.15, amplitude=0.7).stereo()
            out.play_sample(tone)
            deadline = _t.time() + 15.0
            while out.still_playing() and _t.time() < deadline:
                _t.sleep(0.01)
            _t.sleep(0.5)   # let tail superblocks pump
        w = _wave.open(wavpath)
        return np.frombuffer(w.readframes(w.getnframes()),
                             np.int16).reshape(-1, 2)

    a1 = render(1)
    a4 = render(4)
    n_tone = int(0.15 * SR)

    def from_onset(a):
        # the pump races play_sample, so each render has a different
        # count of leading silence chunks (the fx chain is untouched by
        # them — it only engages with the first active chunk); align on
        # the audio itself
        nz = np.argwhere(np.abs(a).max(axis=1) > 100)
        assert len(nz), "no audio rendered"
        return a[int(nz[0][0]):]

    b1 = from_onset(a1)
    b4 = from_onset(a4)
    # the reverb tail rings on the superblocked path too
    assert np.abs(b4[n_tone + 2000:]).max() > 50
    # identical recurrences, different scan chunking: tiny budget
    n = min(len(b1), len(b4))
    assert n > n_tone
    d = np.abs(b1[:n].astype(np.int64) - b4[:n].astype(np.int64)).max()
    assert d <= 8, d


def test_output_fx_requires_mixed():
    from synthesizer_tpu import Output
    chain = FxChain([("compress", {})], SR, 2)
    with pytest.raises(ValueError, match="mixed"):
        Output(samplerate=SR, nchannels=2, mixing="sequential", fx=chain)


# ---------------------------------------------------------------------------
# Per-SYNTH-track fx ([fx.SYNTHNAME] — the track's bus is rendered by the
# grouped voice bank and processed before joining the int32 mix)
# ---------------------------------------------------------------------------

def make_synth_song(lead_fx=None, with_pad=False, with_drums=False,
                    amplitude=0.25):
    from synthesizer_tpu.sequencer import SynthDef
    song = Song()
    song.bpm = 240
    song.ticks = 4
    song.samplerate = SR
    song.nchannels = 2
    song.add_synth("lead", SynthDef(wave="square_bl", amplitude=amplitude,
                                    attack=0.005, release=0.05, pan=0.2))
    tracks = {"lead": "C4 .. E4 G4 - .. C5 ..", }
    if with_pad:
        song.add_synth("pad", SynthDef(wave="sine", amplitude=amplitude,
                                       attack=0.02, release=0.1, pan=-0.3))
        tracks["pad"] = "C3 - - - G2 - - -"
    if with_drums:
        synth = WaveSynth(samplerate=SR, samplewidth=2)
        song.add_instrument("kick", synth.sine(60.0, 0.1, amplitude=0.5)
                            .fadeout(0.06).stereo())
        tracks["kick"] = "x.x.x.x."
    song.add_pattern("a", tracks)
    song.pattern_sequence = ["a", "a"]
    if lead_fx:
        song.add_track_fx("lead", lead_fx)
    return song


def test_synth_track_fx_ini_roundtrip(tmp_path):
    ini = tmp_path / "song.ini"
    ini.write_text("""
[song]
bpm = 240
ticks = 4
patterns = a
[synth.lead]
wave = sawtooth_bl
amplitude = 0.3
[pattern.a]
lead = C4 E4 G4 C5
[fx.lead]
filter = kind=lowpass cutoff=1200 q=1.2
compress = threshold_db=-18 ratio=3
""")
    song = Song.from_ini(str(ini))
    assert "lead" in song.synth_fx
    assert [n for n, _ in song.synth_fx["lead"]] == ["filter", "compress"]
    # still rejects chains on names that are neither samples nor synths
    ini.write_text(ini.read_text().replace("[fx.lead]", "[fx.ghost]"))
    with pytest.raises(ValueError, match="unknown instrument"):
        Song.from_ini(str(ini))


def test_synth_track_fx_offline_matches_solo_oracle():
    """A solo fx'd synth track mixes to: quantize the track's bus to int16,
    run the chain over the tail-padded song length."""
    from synthesizer_tpu.effects import run_fx_chain_ops
    fx = [("filter", "kind=lowpass cutoff=1500 q=2.0"),
          ("compress", "threshold_db=-20 ratio=4")]
    song = make_synth_song(lead_fx=fx)
    got = song.mix(normalize=False, tail_seconds=0.1).get_frame_array()

    oracle = make_synth_song(lead_fx=None)
    voices = oracle.compile_synth_voices()
    total = len(got) // 1  # frames (stereo array is [n, 2]? get_frame_array)
    total = got.shape[0]
    bank, vp = oracle._synth_bank(voices, chunk_frames=32768)
    stereo = bank.render_song(vp, total)
    t16 = np.clip(np.rint(np.asarray(stereo) * 32767.0), -32768, 32767) \
        .astype(np.int16)
    ts = Sample.from_jax(__import__("jax").numpy.asarray(t16), SR, 2)
    run_fx_chain_ops(ts, song.synth_fx["lead"], {})
    expect = ts.get_frame_array()
    d = np.abs(got.astype(np.int64) - expect.astype(np.int64)).max()
    # grouped-vs-flat pan matmul order (1) amplified through a Q=2 filter
    assert d <= 4, d


def test_synth_track_fx_clean_tracks_unaffected():
    """The fx'd track's chain must not touch the clean bus or the drums:
    at non-saturating levels the mix decomposes into solo mixes."""
    fx = [("filter", "kind=lowpass cutoff=1000 q=0.7071")]
    full = make_synth_song(lead_fx=fx, with_pad=True, with_drums=True,
                           amplitude=0.15)
    lead_only = make_synth_song(lead_fx=fx, amplitude=0.15)
    rest = make_synth_song(lead_fx=None, with_pad=True, with_drums=True,
                           amplitude=0.15)
    # render all to the full song's length
    n = full.duration_frames(0.1)
    a = full.mix(normalize=False, tail_seconds=0.1).get_frame_array()
    def solo(song, drop_lead=False):
        s = song.mix(normalize=False, tail_seconds=0.1).get_frame_array()
        out = np.zeros((n, 2), np.int64)
        out[:len(s)] += s.astype(np.int64)
        return out
    b = solo(lead_only)
    rest.synths.pop("lead", None)
    for p in rest.patterns.values():
        p.pop("lead", None)
    c = solo(rest)
    d = np.abs(a.astype(np.int64) - (b + c)).max()
    assert d <= 2, d


@pytest.mark.parametrize("chunk", [1000, 4096])
def test_synth_track_fx_streaming_equals_offline(chunk):
    fx = [("compress", "threshold_db=-18 ratio=4 attack=0.002 release=0.05"),
          ("reverb", "roomsize=0.6 wet=0.3 dry=0.7 tail=0.15")]
    song = make_synth_song(lead_fx=fx, with_pad=True, with_drums=True)
    offline = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=chunk)])
    assert len(got) == len(offline)
    d = np.abs(got.astype(np.int64) - offline.astype(np.int64)).max()
    assert d <= 8, d


def test_synth_track_fx_tail_rings():
    """A reverb on a synth track extends the song by its tail, and the
    tail actually rings (on both paths)."""
    fx = [("reverb", "roomsize=0.8 wet=0.6 dry=0.5 tail=0.2")]
    song = make_synth_song(lead_fx=fx)
    base = make_synth_song(lead_fx=None)
    assert song.duration_frames() == base.duration_frames() + int(0.2 * SR)
    out = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    tail = out[base.duration_frames():]
    assert np.abs(tail[: int(0.05 * SR)]).max() > 0


def test_synth_track_fx_mesh_matches_single_device():
    """Per-synth-track fx under mesh= (round-3): the tagged voices shard
    over the 8-device mesh and the psum'ed bus stack feeds the SAME chain
    processing as single-device.  The bus differs only by cross-shard f32
    summation order (≤1 LSB after int16 quantization); a chain maps that
    to a few LSB at most (rounding once more at its output)."""
    from synthesizer_tpu.parallel.mesh import voice_mesh
    fx = [("filter", "kind=lowpass cutoff=6000"),
          ("compress", "threshold_db=-18 ratio=4")]
    song = make_synth_song(lead_fx=fx, with_pad=True, with_drums=True)
    mesh = voice_mesh(8)
    single = song.mix(normalize=False).get_frame_array()
    sharded = song.mix(normalize=False, mesh=mesh).get_frame_array()
    d = np.abs(sharded.astype(np.int64) - single.astype(np.int64)).max()
    assert d <= 3, f"mesh grouped mix off by {d} LSB"


def test_synth_track_fx_mesh_streaming_equals_offline():
    """The sharded streaming grouped path carries the same stateful chains
    as the single-device one: chunks must match the sharded offline render
    within the chain's chunk-regrouping budget."""
    from synthesizer_tpu.parallel.mesh import voice_mesh
    fx = [("compress", "threshold_db=-18 ratio=4")]
    song = make_synth_song(lead_fx=fx)
    mesh = voice_mesh(8)
    offline = song.mix(normalize=False, tail_seconds=0.0,
                       mesh=mesh).get_frame_array()
    got = np.concatenate(
        [c.get_frame_array()
         for c in song.mix_generator(chunk_frames=1000, mesh=mesh)])
    assert len(got) == len(offline)
    d = np.abs(got.astype(np.int64) - offline.astype(np.int64)).max()
    assert d <= 2, f"sharded streaming off by {d} LSB vs sharded offline"


# ---------------------------------------------------------------------------
# Sidechain ducking (round 3): compress sidechain=INSTRUMENT in track /
# master chains — the detector listens to a drum track's own hits bus.
# ---------------------------------------------------------------------------

def make_duck_song(sidechain=True, master=False, with_pad=True):
    from synthesizer_tpu.sequencer import SynthDef
    ws = WaveSynth(samplerate=SR, samplewidth=2)
    song = Song()
    song.bpm = 240
    song.ticks = 4
    song.add_instrument("kick", ws.sine(60.0, 0.1, amplitude=0.7)
                        .fadeout(0.08).stereo())
    tracks = {"kick": "x...x...x...x..."}
    if with_pad:
        song.add_synth("pad", SynthDef(wave="sine", amplitude=0.12,
                                       attack=0.005, release=0.05))
        tracks["pad"] = "C3 - - - - - - - - - - - - - - -"
    song.add_pattern("a", tracks)
    song.pattern_sequence = ["a", "a"]
    # the PAD (-18 dBFS) sits just under the threshold: without the
    # sidechain the compressor never acts on it; the KICK (-3 dBFS) key
    # punches well above it
    fx = "threshold_db=-16 ratio=12 attack=0.001 release=0.08"
    if sidechain:
        fx += " sidechain=kick"
    from synthesizer_tpu.effects import parse_fx_items
    if master:
        song.fx = parse_fx_items([("compress", fx)])
    elif with_pad:
        song.synth_fx["pad"] = parse_fx_items([("compress", fx)])
    return song


def test_sidechain_ducking_pumps_the_pad():
    """With sidechain=kick the pad dips when the kick hits and recovers
    between hits; without it the (under-threshold) pad is untouched.  The
    pad bus is recovered exactly by subtracting a kick-only render (the
    int32 mix never saturates at these levels)."""
    ducked = make_duck_song(sidechain=True) \
        .mix(normalize=False, tail_seconds=0.0).get_frame_array()
    plain = make_duck_song(sidechain=False) \
        .mix(normalize=False, tail_seconds=0.0).get_frame_array()
    kick_only = make_duck_song(with_pad=False) \
        .mix(normalize=False, tail_seconds=0.0).get_frame_array()
    n = len(kick_only)
    pad_d = ducked[:n].astype(np.int64) - kick_only.astype(np.int64)
    pad_p = plain[:n].astype(np.int64) - kick_only.astype(np.int64)
    tickf = 60.0 / 240 / 4 * SR
    kick_len = int(0.1 * SR)

    def rms(a, f0, f1):
        seg = a[int(f0):int(f1)].astype(np.float64)
        return np.sqrt(np.mean(np.square(seg))) if len(seg) else 0.0

    k = 8 * tickf                       # third kick of bar 1
    during = rms(pad_d, k + kick_len * 0.2, k + kick_len * 0.8)
    between = rms(pad_d, k + 2.8 * tickf, k + 3.8 * tickf)
    assert between > 2.0 * during, (during, between)
    # un-sidechained: the pad is below threshold, so no pump at all
    during_p = rms(pad_p, k + kick_len * 0.2, k + kick_len * 0.8)
    between_p = rms(pad_p, k + 2.8 * tickf, k + 3.8 * tickf)
    assert 0.7 < between_p / max(during_p, 1e-9) < 1.5, \
        (during_p, between_p)


@pytest.mark.parametrize("chunk", [1000, 4096])
def test_sidechain_streaming_equals_offline(chunk):
    song = make_duck_song(sidechain=True)
    off = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=chunk)])
    assert len(got) == len(off)
    d = np.abs(got.astype(np.int64) - off.astype(np.int64)).max()
    assert d <= 8, d


def test_sidechain_master_chain_and_seek():
    song = make_duck_song(sidechain=True, master=True)
    off = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=1024)])
    d = np.abs(got.astype(np.int64) - off.astype(np.int64)).max()
    assert d <= 8, d
    # seek: the key provider is stateless in the absolute index; only the
    # compressor envelope starts cold (like every seek-with-fx), so the
    # stream re-converges within a release time
    k = 7000
    got2 = np.concatenate([
        c.get_frame_array()
        for c in song.mix_generator(chunk_frames=1024, start_frame=k)])
    warm = int(0.2 * SR)
    d2 = np.abs(got2[warm:].astype(np.int64)
                - off[k + warm:k + len(got2)].astype(np.int64)).max()
    assert d2 <= 8, d2


def test_sidechain_validation():
    song = make_duck_song(sidechain=False)
    # unknown key instrument fails at mix time with a clear message
    from synthesizer_tpu.effects import parse_fx_items
    song.synth_fx["pad"] = parse_fx_items(
        [("compress", "threshold_db=-30 sidechain=ghost")])
    with pytest.raises(ValueError, match="unknown sample instrument"):
        song.mix(normalize=False)
    # a drum chain WITH sidechain routes to its own bus (round 3);
    # timeline-free drum chains still bake into the WAV
    song2 = make_duck_song(sidechain=False)
    song2.add_track_fx(
        "kick", [("compress", "threshold_db=-30 sidechain=kick")])
    assert "kick" in song2.drum_fx_bus
    nbaked = song2.instruments["kick"].nframes
    song2.add_track_fx("kick", [("filter", "kind=lowpass cutoff=2000")])
    assert song2.instruments["kick"].nframes == nbaked   # baked in place
    # sidechain + compress automation curves are mutually exclusive
    song3 = make_duck_song(sidechain=True, master=True)
    song3.add_automation("fx.compress.release", "0:0.05 16:0.3")
    with pytest.raises(ValueError, match="cannot be combined"):
        song3.mix(normalize=False)


def test_sidechain_under_mesh():
    """Sidechain ducking composes with mesh=: the pad bus shards (f32
    psum, <=1 LSB) and the key bus/chain run on the replicated result."""
    from synthesizer_tpu.parallel.mesh import voice_mesh
    song = make_duck_song(sidechain=True)
    single = song.mix(normalize=False).get_frame_array()
    sharded = song.mix(normalize=False,
                       mesh=voice_mesh(8)).get_frame_array()
    d = np.abs(sharded.astype(np.int64) - single.astype(np.int64)).max()
    assert d <= 3, d


def test_drum_bus_sidechain_duck_hat_by_kick():
    """[fx.hat] compress sidechain=kick — a DRUM chain with a timeline
    routes the hat onto its own bus instead of baking (round-3
    completion of the sidechain story): the hat dips under each kick,
    offline == streaming, and the hat stem is post-chain."""
    ws = WaveSynth(samplerate=SR, samplewidth=2)

    def build(duck=True):
        song = Song()
        song.bpm = 240
        song.ticks = 4
        song.add_instrument("kick", ws.sine(55.0, 0.1, amplitude=0.7)
                            .fadeout(0.08).stereo())
        song.add_instrument("hat", ws.white_noise(duration=0.25,
                                                  amplitude=0.25, seed=5)
                            .fadeout(0.2).stereo())
        song.add_pattern("a", {"kick": "x...x...x...x...",
                               "hat": "x...x...x...x..."})
        song.pattern_sequence = ["a", "a"]
        if duck:
            song.add_track_fx("hat", [
                ("compress", "threshold_db=-16 ratio=10 attack=0.001 "
                             "release=0.06 sidechain=kick")])
        return song

    song = build(True)
    assert "hat" in song.drum_fx_bus       # routed to a bus, not baked
    off = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    # hat-only bus recovered by subtracting a kick-only render
    kick_only = build(False)
    for p in kick_only.patterns.values():
        p.pop("hat", None)
    ko = kick_only.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    n = min(len(off), len(ko))
    hat_bus = off[:n].astype(np.int64) - ko[:n].astype(np.int64)
    plain = build(False).mix(normalize=False,
                             tail_seconds=0.0).get_frame_array()
    hat_plain = plain[:n].astype(np.int64) - ko[:n].astype(np.int64)

    def rms(a, f0, f1):
        seg = a[int(f0):int(f1)].astype(np.float64)
        return np.sqrt(np.mean(np.square(seg)))

    tickf = 60.0 / 240 / 4 * SR
    k = 8 * tickf
    during_d = rms(hat_bus, k + 200, k + 0.05 * SR)
    during_p = rms(hat_plain, k + 200, k + 0.05 * SR)
    assert during_d < 0.5 * during_p, (during_d, during_p)

    # streaming equals offline within the compressor budget
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=1300)])
    assert len(got) == len(off)
    d = np.abs(got.astype(np.int64) - off.astype(np.int64)).max()
    assert d <= 8, d

    # the hat stem is post-chain and the stem sum still matches the mix
    stems = song.mix_stems(tail_seconds=0.0)
    total = np.zeros((stems["hat"].nframes, 2), np.int64)
    for s in stems.values():
        total += s.get_frame_array().astype(np.int64)
    mix = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    d2 = np.abs(np.clip(total, -32768, 32767)
                - mix[:len(total)].astype(np.int64)).max()
    assert d2 <= 3, d2


# ---------------------------------------------------------------------------
# Parametric EQ in the chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1500, 4096])
def test_eq_fx_streaming_equals_offline(chunk):
    song = make_song([("eq", dict(low_db=4.0, mid_db=-5.0, high_db=3.0,
                                  mid_freq=1200.0, mid_q=2.0))])
    offline = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=chunk)])
    assert len(got) == len(offline)
    d = np.abs(got.astype(np.int64) - offline.astype(np.int64)).max()
    # the 120 Hz low shelf's poles sit near z=1 and the kick is
    # full-scale right in that band: scan-regrouping error follows the
    # conditioning model (tests/test_filters.scan_error_bound_lsb;
    # measured ~220 LSB = -43 dB relative to the kick peaks)
    assert d <= 512, d


def test_eq_fx_ini_roundtrip(tmp_path):
    items = parse_fx_items([("eq", "low_db=3 high_db=-2 mid_q=1.5")])
    assert items == [("eq", dict(low_db=3.0, high_db=-2.0, mid_q=1.5))]
    with pytest.raises(ValueError, match="unknown parameter"):
        parse_fx_items([("eq", "bass=3")])


def test_filter_fx_gain_kinds_parse():
    items = parse_fx_items([("filter",
                             "kind=highshelf cutoff=6000 gain_db=4")])
    assert items[0][1]["kind"] == "highshelf"
    with pytest.raises(ValueError, match="unknown kind"):
        parse_fx_items([("filter", "kind=notch cutoff=1000")])


def test_cutoff_automation_shelf_kinds_use_host_grids():
    """The device-grid sweep still rejects gain kinds (it cannot carry
    gain_db), but the song layer routes them to SweptGainKindBiquad
    (host-derived frequency-varying grids) instead — shelf/peaking
    cutoff sweeps are supported end to end (test_automation pins the
    numerics)."""
    from synthesizer_tpu.effects import (SweptGainKindBiquad,
                                         SweptStreamingBiquad)
    with pytest.raises(ValueError, match="lowpass/highpass/bandpass"):
        SweptStreamingBiquad(SR, 2, "highshelf", 0.7071,
                             [(0, 500.0), (4, 2000.0)], tickf=5512.5)
    proc = SweptGainKindBiquad(SR, 2, "highshelf", 0.7071, 6.0,
                               [(0, 500.0), (4, 2000.0)], tickf=5512.5)
    import jax.numpy as jnp
    rng2 = np.random.default_rng(5)
    x = rng2.integers(-20000, 20000, size=(3000, 2)).astype(np.int16)
    y = np.asarray(proc.process(jnp.asarray(x)))
    assert y.shape == x.shape and np.abs(y).max() > 0


# ---------------------------------------------------------------------------
# Round-3 continuation fx: echo / width / limiter / phaser
# ---------------------------------------------------------------------------

def test_parse_new_fx_and_validation():
    fx = parse_fx_items([("echo", "delay=0.3 feedback=0.4 wet=0.5"),
                         ("width", "amount=1.5"),
                         ("limiter", "ceiling_db=-1 lookahead=0.004"),
                         ("phaser", "rate=0.5 stages=6 wet=0.6")])
    assert [n for n, _ in fx] == ["echo", "width", "limiter", "phaser"]
    assert fx[3][1]["stages"] == 6
    with pytest.raises(ValueError, match="delay"):
        parse_fx_items([("echo", "feedback=0.4")])
    with pytest.raises(ValueError, match="exactly one"):
        parse_fx_items([("echo", "delay=0.3 beats=1")])
    with pytest.raises(ValueError, match="amount"):
        parse_fx_items([("width", "")])


def test_echo_beats_resolves_against_bpm():
    song = make_song()
    song.add_fx("echo", beats=1.0, feedback=0.3)
    name, p = song.fx[0]
    assert name == "echo" and "beats" not in p
    assert p["delay"] == pytest.approx(60.0 / 240.0)
    ini = """
[song]
bpm = 120
ticks = 4
patterns = a

[synth.s]
wave = sine
amplitude = 0.3

[pattern.a]
s = C4 . . .

[fx]
echo = beats=0.5 feedback=0.4 wet=0.4
"""
    s2 = Song.from_string(ini)
    assert dict(s2.fx)["echo"]["delay"] == pytest.approx(0.25)


def test_lfo_rate_beats_resolves_against_bpm():
    # rate_beats = LFO period in beats: rate = bpm / (60 * beats)
    song = make_song()                       # bpm 240
    song.add_fx("phaser", rate_beats=2.0, depth=0.8)
    song.add_fx("chorus", rate_beats=4.0)
    p = dict(song.fx)
    assert "rate_beats" not in p["phaser"] and "rate_beats" not in \
        p["chorus"]
    assert p["phaser"]["rate"] == pytest.approx(240.0 / 120.0)
    assert p["chorus"]["rate"] == pytest.approx(240.0 / 240.0)
    with pytest.raises(ValueError, match="not both"):
        song.add_fx("phaser", rate=1.0, rate_beats=1.0)
    with pytest.raises(ValueError, match="> 0"):
        song.add_fx("phaser", rate_beats=0.0)


def test_new_fx_streaming_equals_offline():
    fx = [("echo", dict(delay=0.11, feedback=0.5, wet=0.45)),
          ("phaser", dict(rate=0.9, depth=1.0, wet=0.5)),
          ("width", dict(amount=1.5)),
          ("limiter", dict(ceiling_db=-2.0, lookahead=0.004))]
    song = make_song(fx)
    off = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=1333)])
    # the limiter's holdback flushes through the tail feed: EXACT length
    assert got.shape == off.shape
    d = np.abs(got.astype(np.int64) - off.astype(np.int64)).max()
    # echo exact + phaser scan regroup + width FMA + limiter gain budget
    assert d <= 12, d


def test_echo_tail_rings_past_programme():
    song = make_song([("echo", dict(delay=0.15, feedback=0.5, wet=0.6))])
    from synthesizer_tpu.ops.coeffs import echo_tail_frames
    tail = echo_tail_frames(SR, 0.15, 0.5, 0.6, None)
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=2000)])
    prog = song.duration_frames()
    assert len(got) == prog + tail
    D = int(0.15 * SR)
    assert np.abs(got[prog:prog + D]).max() > 0


def test_limiter_rejected_on_track_bus():
    song = make_song()
    with pytest.raises(ValueError, match="master-chain only"):
        song.add_track_fx("kick", [("limiter", "ceiling_db=-1")])


def test_width_needs_stereo_chain():
    # a Song's instruments normalize to stereo, so the mono case can only
    # reach the chain from an ini-loaded mono song — pin the constructor
    with pytest.raises(ValueError, match="stereo"):
        FxChain([("width", {"amount": 1.2})], SR, 1)
    with pytest.raises(ValueError, match="amount"):
        FxChain([("width", {})], SR, 2)


def test_limiter_caps_hot_master():
    from synthesizer_tpu.ops.coeffs import limiter_ceiling
    song = make_song()
    # stack the kick hot enough to clip, then limit at -3 dB
    song.instruments["kick"].amplify(3.0)
    unlimited = song.mix(normalize=False, tail_seconds=0.0) \
        .get_frame_array()
    assert np.abs(unlimited.astype(np.int64)).max() > limiter_ceiling(-3.0, 2)
    song.add_fx("limiter", ceiling_db=-3.0)
    out = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    assert np.abs(out.astype(np.int64)).max() <= limiter_ceiling(-3.0, 2)
    assert np.abs(out).max() > 0
