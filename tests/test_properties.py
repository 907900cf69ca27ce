"""Property tests (SURVEY.md §5): mix algebra, saturation, chainability,
chunked-vs-whole invariance, profiling counters, demo song end-to-end."""

import os
import sys

import goldref.sample as gs
import numpy as np
import pytest

from synthesizer_tpu import Sample, WaveSynth
from synthesizer_tpu.utils.profiling import RenderTimer, timed_stream

SR = 44100


def rand_sample(rng, n=4000, amp=8000):
    a = rng.integers(-amp, amp, size=(n, 2)).astype(np.int16)
    return Sample.from_raw_frames(a.tobytes(), 2, SR, 2)


def test_mix_commutative_without_saturation(rng):
    a, b = rand_sample(rng), rand_sample(rng)
    ab = a.copy().mix(b)
    ba = b.copy().mix(a)
    assert ab == ba


def test_mix_associative_without_saturation(rng):
    a, b, c = (rand_sample(rng, amp=5000) for _ in range(3))
    left = a.copy().mix(b).mix(c)
    right = b.copy().mix(c).mix(a)
    assert left == right


def test_mix_saturates_not_wraps(rng):
    a = Sample.from_raw_frames(np.full(100, 30000, np.int16).tobytes(), 2, SR, 1)
    b = Sample.from_raw_frames(np.full(100, 30000, np.int16).tobytes(), 2, SR, 1)
    m = a.mix(b).get_frame_array()
    assert (m == 32767).all()


def test_chain_returns_self(rng):
    s = rand_sample(rng)
    out = s.amplify(0.5).fadein(0.01).fadeout(0.01).reverse().invert()
    assert out is s


def test_amplify_monotone(rng):
    s = rand_sample(rng)
    half = s.copy().amplify(0.5).get_frame_array().astype(np.int64)
    full = s.get_frame_array().astype(np.int64)
    assert (np.abs(half) <= np.abs(full)).all()


def test_join_then_split_roundtrip(rng):
    a, b = rand_sample(rng, n=3000), rand_sample(rng, n=2000)
    joined = a.copy().join(b)
    tail = joined.split(3000 / SR)
    assert joined == a and tail == b


def test_resample_up_down_length(rng):
    s = rand_sample(rng, n=8000)
    up = s.copy().resample(88200)
    assert abs(up.nframes - 16000) <= 2
    down = s.copy().resample(22050)
    assert abs(down.nframes - 4000) <= 2


def test_delay_keep_length_preserves_nframes(rng):
    s = rand_sample(rng)
    n = s.nframes
    assert s.copy().delay(0.01, keep_length=True).nframes == n
    assert s.copy().delay(-0.01, keep_length=True).nframes == n


def test_render_timer():
    t = RenderTimer(SR)
    with t.chunk(4410):
        pass
    assert t.stats.chunks == 1
    assert t.stats.audio_seconds == pytest.approx(0.1)
    assert t.stats.realtime_factor > 0
    assert "realtime" in str(t.stats)


def test_timed_stream(rng):
    s = rand_sample(rng, n=3000)
    chunks = (Sample.from_raw_frames(c, 2, SR, 2)
              for c in s.chunked_frame_data(1000))
    wrapped, timer = timed_stream(chunks, SR)
    assert sum(c.nframes for c in wrapped) == 3000
    assert timer.stats.chunks == 3


def test_demo_song_end_to_end(tmp_path):
    """examples/make_demo_song.py -> trackmixer offline mix -> valid WAV."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))
    import make_demo_song
    outdir = str(tmp_path / "kit")
    make_demo_song.make_kit(outdir)
    with open(os.path.join(outdir, "demo.ini"), "w") as f:
        f.write(make_demo_song.SONG_INI)
    from synthesizer_tpu.sequencer import Song
    song = Song.from_ini(os.path.join(outdir, "demo.ini"))
    mixed = song.mix()
    assert mixed.duration > 10.0
    peak = np.abs(mixed.get_frame_array().astype(np.int64)).max()
    assert peak >= 32000  # normalized


def test_output_meter_hook(tmp_path):
    import time as _t
    from synthesizer_tpu import LevelMeter, Output, WaveSynth
    meter = LevelMeter()
    with Output(samplerate=SR, nchannels=2, frames_per_chunk=1000,
                mixing="mixed", wav_file=str(tmp_path / "m.wav"),
                meter=meter) as out:
        out.play_sample(WaveSynth(samplerate=SR, samplewidth=2)
                        .sine(440, 0.05, amplitude=0.8).stereo())
        deadline = _t.time() + 5.0
        while out.still_playing() and _t.time() < deadline:
            _t.sleep(0.01)
    assert meter.level_left > meter.lowest  # meter saw the audio


def test_profiler_trace_smoke(tmp_path):
    from synthesizer_tpu import WaveSynth
    from synthesizer_tpu.utils.profiling import trace
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        WaveSynth(samplerate=SR, samplewidth=2).sine(220, 0.05).get_frame_array()
    import os
    assert any(os.scandir(logdir))  # profiler wrote something


def test_edge_guards(rng, tmp_path):
    from synthesizer_tpu import Output, Sample
    empty = Sample.from_raw_frames(b"", 2, SR, 2)
    with pytest.raises(ValueError):
        next(empty.chunked_frame_data(100, repeat=True))
    with pytest.raises(ValueError):
        Output(samplewidth=4, mixing="mixed")


def test_parallel_sample_staging_is_thread_safe():
    """Independent Samples staged+materialized from 8 threads concurrently:
    the lazy-IR machinery (shared program cache, launch counter) must not
    cross-contaminate results."""
    import concurrent.futures as cf

    def work(i):
        rng = np.random.default_rng(i)
        a = rng.integers(-10000, 10000, size=(2000, 2)).astype(np.int16)
        s = Sample.from_raw_frames(a.tobytes(), 2, SR, 2)
        s.amplify(0.5).fadein(0.01).fadeout(0.01).reverse()
        g = gs.Sample(a.copy(), SR, 2, 2)
        g.amplify(0.5).fadein(0.01).fadeout(0.01).reverse()
        d = np.abs(s.get_frame_array().astype(np.int64)
                   - g.frames.astype(np.int64)).max()
        return d

    with cf.ThreadPoolExecutor(8) as ex:
        diffs = list(ex.map(work, range(16)))
    assert max(diffs) <= 2, diffs
