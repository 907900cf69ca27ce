"""Playback (Output/RealTimeMixer) and streaming layer tests.

No audio hardware in CI: sinks are the WAV-file / null backends, exactly the
degradation ladder the reference falls back to (SURVEY.md §5, §6).
"""

import io
import os
import time
import wave

import numpy as np
import pytest

from synthesizer_tpu import Sample, WaveSynth
from synthesizer_tpu.playback import Output, RealTimeMixer, NullAudio, best_api
from synthesizer_tpu.streaming import (
    AudiofileToWavStream, EndlessFramesFilter, SampleStream, StreamMixer,
    StreamingError, VolumeFilter)

SR = 44100


def tone(freq=440.0, dur=0.1, amp=0.5):
    return WaveSynth(samplerate=SR, samplewidth=2).sine(freq, dur, amplitude=amp).stereo()


def test_realtime_mixer_mixes_and_ends():
    m = RealTimeMixer(chunk_frames=1000, samplerate=SR, nchannels=2)
    a = tone(440, dur=0.05, amp=0.3)   # 2205 frames
    b = tone(660, dur=0.05, amp=0.3)
    ended = []
    m.register_ended_callback(ended.append)
    sid_a = m.add_sample(a)
    sid_b = m.add_sample(b)
    gen = m.chunks()
    chunks = [next(gen) for _ in range(4)]
    assert all(c.shape == (1000, 2) for c in chunks)
    # after 3 chunks both samples (2205 frames) are exhausted
    assert m.active_count == 0 and set(ended) == {sid_a, sid_b}
    # silence afterwards
    assert np.abs(chunks[3]).max() == 0
    # first chunk must equal saturated sum of both tones
    want = (a.get_frame_array()[:1000].astype(np.int32)
            + b.get_frame_array()[:1000].astype(np.int32))
    want = np.clip(want, -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(chunks[0], want)


def test_mixer_stop_and_repeat():
    m = RealTimeMixer(chunk_frames=500, samplerate=SR, nchannels=2)
    sid = m.add_sample(tone(dur=0.005), repeat=True)  # 220 frames, loops
    gen = m.chunks()
    for _ in range(5):
        next(gen)
    assert m.active_count == 1  # still looping
    m.remove_sample(sid)
    assert m.active_count == 0


def test_output_mixed_to_wav_sink(tmp_path):
    p = str(tmp_path / "out.wav")
    with Output(samplerate=SR, nchannels=2, frames_per_chunk=1000,
                mixing="mixed", wav_file=p) as out:
        assert out.api.name == "wavsink"  # no realtime API on this machine
        out.play_sample(tone(dur=0.05))
        out.play_sample(tone(880, dur=0.05), delay=0.01)
        deadline = time.time() + 5.0
        while out.still_playing() and time.time() < deadline:
            time.sleep(0.01)
        assert not out.still_playing()
    with wave.open(p) as w:
        assert w.getnframes() >= int(0.05 * SR)


def test_output_sequential(tmp_path):
    p = str(tmp_path / "seq.wav")
    played = []
    with Output(samplerate=SR, nchannels=2, mixing="sequential", wav_file=p) as out:
        out.register_notify_played(lambda s: played.append(s.name))
        out.play_sample(tone(440, dur=0.03))
        out.play_sample(tone(550, dur=0.03))
        out.wait_all_played(timeout=5.0)
    assert played == ["sine", "sine"]
    with wave.open(p) as w:
        assert abs(w.getnframes() - 2 * int(0.03 * SR)) <= 1


def test_best_api_fallback_null():
    api = best_api(SR, 2, 2)
    assert isinstance(api, NullAudio)


def test_samplestream_chunks(tmp_path):
    s = tone(dur=0.07)
    p = str(tmp_path / "t.wav")
    s.write_wav(p)
    chunks = list(SampleStream(p, frames_per_chunk=1000))
    got = np.concatenate([c.get_frame_array() for c in chunks])
    np.testing.assert_array_equal(got, s.get_frame_array())


def test_audiofile_stream_passthrough_and_convert(tmp_path):
    s = tone(dur=0.05)
    p = str(tmp_path / "t.wav")
    s.write_wav(p)
    # target format == file format: passthrough
    with AudiofileToWavStream(p, samplerate=SR, nchannels=2, samplewidth=2) as st:
        ss = SampleStream(st, 512)
        got = np.concatenate([c.get_frame_array() for c in ss])
    np.testing.assert_array_equal(got, s.get_frame_array())
    # different target rate: converted via the device pipeline
    with AudiofileToWavStream(p, samplerate=22050, nchannels=2, samplewidth=2) as st:
        ss = SampleStream(st, 512)
        assert ss.samplerate == 22050
        got = np.concatenate([c.get_frame_array() for c in ss])
    want = s.copy().resample(22050).get_frame_array()
    np.testing.assert_array_equal(got, want)


def test_audiofile_stream_non_wav_raises_without_ffmpeg(tmp_path):
    p = tmp_path / "t.mp3"
    p.write_bytes(b"not really audio")
    import shutil
    if shutil.which("ffmpeg") is None:
        with pytest.raises(StreamingError):
            AudiofileToWavStream(str(p))


def test_volume_and_endless_filters(tmp_path):
    s = tone(dur=0.03, amp=0.8)
    p = str(tmp_path / "t.wav")
    s.write_wav(p)
    st = VolumeFilter(SampleStream(p, 512), 0.5)
    got = np.concatenate([c.get_frame_array() for c in st])
    want = s.copy().amplify(0.5).get_frame_array()
    np.testing.assert_array_equal(got, want)

    endless = EndlessFramesFilter(SampleStream(p, 512), frames_per_chunk=512)
    chunks = [next(endless) for _ in range(6)]
    assert all(c.nframes == 512 for c in chunks[3:])
    assert np.abs(chunks[-1].get_frame_array()).max() == 0


def test_stream_mixer(tmp_path):
    a, b = tone(440, 0.05, 0.3), tone(660, 0.03, 0.3)
    pa, pb = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    a.write_wav(pa)
    b.write_wav(pb)
    mixer = StreamMixer([SampleStream(pa, 512), SampleStream(pb, 512)],
                        frames_per_chunk=512)
    out = list(mixer)
    ts = [t for t, _ in out]
    assert ts[0] == 0.0 and ts[1] == pytest.approx(512 / SR)
    got = np.concatenate([c.get_frame_array() for _, c in out])
    # both streams mixed while live
    am = a.get_frame_array()[:512].astype(np.int32)
    bm = b.get_frame_array()[:512].astype(np.int32)
    np.testing.assert_array_equal(
        got[:512], np.clip(am + bm, -32768, 32767).astype(np.int16))
    assert len(got) >= a.nframes


def test_rate_convert_filter(tmp_path):
    from synthesizer_tpu.streaming import RateConvertFilter
    import goldref.pcm as gp
    s = tone(dur=0.1, amp=0.6)
    p = str(tmp_path / "rc.wav")
    s.write_wav(p)
    conv = RateConvertFilter(SampleStream(p, 700), 32000)
    chunks = [c for c in conv]
    assert all(c.samplerate == 32000 for c in chunks)
    got = np.concatenate([c.get_frame_array() for c in chunks])
    want_b, _ = gp.ratecv(s.view_frame_data(), 2, 2, 44100, 32000, None)
    want = gp.frombytes(want_b, 2).reshape(-1, 2)
    np.testing.assert_array_equal(got, want)


def test_mixed_mode_notify_and_channel_adapt(tmp_path):
    played = []
    with Output(samplerate=SR, nchannels=2, frames_per_chunk=1000,
                mixing="mixed", wav_file=str(tmp_path / "n.wav")) as out:
        out.register_notify_played(lambda s: played.append(s.name))
        mono = WaveSynth(samplerate=SR, samplewidth=2).sine(440, 0.04, amplitude=0.4)
        assert mono.nchannels == 1
        out.play_sample(mono)        # mono into a stereo output: adapted
        deadline = time.time() + 5.0
        while out.still_playing() and time.time() < deadline:
            time.sleep(0.01)
    assert played == ["sine"]        # mixed mode fires completion callbacks


def _soak_song(seconds=10.0):
    from synthesizer_tpu.sequencer import Song, SynthDef
    ws = WaveSynth(samplerate=SR, samplewidth=2)
    song = Song()
    song.bpm = 120
    song.ticks = 4
    song.add_instrument("kick", ws.sine(60, 0.1, amplitude=0.8)
                        .fadeout(0.08).stereo())
    song.add_instrument("hat", ws.white_noise(duration=0.03, amplitude=0.3,
                                              seed=4).fadeout(0.02).stereo())
    song.add_synth("lead", SynthDef(wave="sawtooth_bl", amplitude=0.25,
                                    release=0.08))
    song.add_pattern("a", {"kick": "x... x... x... x...",
                           "hat":  "x.x. x.x. x.x. x.x.",
                           "lead": "C3 - E3 - G3 - E3 - C3 - E3 - G3 - B3 -"})
    bars = max(1, int(seconds / (16 * song.tick_duration)))
    song.pattern_sequence = ["a"] * bars
    return song


def test_streaming_soak_realtime_with_meter(tmp_path):
    """10 s song: mix_generator -> Output(wav sink) with the level meter on
    must sustain > 1x realtime wall-clock on CPU (— metering
    is one host materialization per chunk, so it cannot eat the budget)."""
    from synthesizer_tpu import LevelMeter
    song = _soak_song(10.0)
    next(song.mix_generator())                      # compile warmup
    meter = LevelMeter(rms_mode=False)
    audio_seconds = 0.0
    out = Output(samplerate=song.samplerate, nchannels=2,
                 mixing="sequential", wav_file=str(tmp_path / "soak.wav"))
    t0 = time.perf_counter()
    try:
        for chunk in song.mix_generator():
            out.play_sample(chunk)
            meter.update_frames(chunk.get_frame_array(), song.samplerate)
            audio_seconds += chunk.duration
        out.wait_all_played(timeout=30.0)
    finally:
        out.close()
    wall = time.perf_counter() - t0
    assert audio_seconds >= 9.0, audio_seconds
    rtf = audio_seconds / wall
    assert rtf > 1.0, f"streaming with metering at {rtf:.2f}x realtime"
    assert meter.peak_left > meter.lowest           # the meter saw signal
    with wave.open(str(tmp_path / "soak.wav")) as w:
        assert w.getnframes() > 9 * SR              # audio really hit the sink


# -- decode ladder: the subprocess plumbing runs in CI via
# fake binaries; a real-codec smoke runs wherever ffmpeg exists ------------

def _write_fake_decoder(tmp_path, name, wav_path):
    """An executable that ignores its args and emits a WAV on stdout —
    exercises the real Popen/pipe path without the codec binary."""
    p = tmp_path / "bin" / name
    p.parent.mkdir(exist_ok=True)
    p.write_text("#!/bin/sh\n/bin/cat '%s'\n" % wav_path)
    p.chmod(0o755)
    return p


def test_ffmpeg_pipe_path_with_fake_binary(tmp_path, monkeypatch):
    """The ffmpeg subprocess branch (spawn, WAV-pipe parse, chunking,
    process teardown) runs for real against a fake ffmpeg."""
    import synthesizer_tpu.streaming as streaming
    want = tone(660, dur=0.2, amp=0.5)
    src = tmp_path / "src.wav"
    want.write_wav(str(src))
    _write_fake_decoder(tmp_path, "ffmpeg", src)
    probe = tmp_path / "bin" / "ffprobe"
    probe.write_text('#!/bin/sh\necho \'{"format": {"format_name": "fake"}}\'\n')
    probe.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path / "bin") + ":" + os.environ["PATH"])
    fake_mp3 = tmp_path / "song.mp3"
    fake_mp3.write_bytes(b"ID3fake")
    with AudiofileToWavStream(str(fake_mp3)) as stream:
        assert stream.format_probe == {"format": {"format_name": "fake"}}
        chunks = list(SampleStream(stream, 1000))
    got = np.concatenate([c.get_frame_array() for c in chunks])
    np.testing.assert_array_equal(got, want.get_frame_array())


def test_oggdec_fallback_with_fake_binary(tmp_path, monkeypatch):
    """No ffmpeg + .ogg + oggdec present -> the oggdec rung decodes and
    normalizes through the Sample pipeline."""
    import synthesizer_tpu.streaming as streaming
    want = WaveSynth(samplerate=22050, samplewidth=2).sine(
        440, 0.2, amplitude=0.5)                      # mono 22050: normalized
    src = tmp_path / "src.wav"
    want.write_wav(str(src))
    _write_fake_decoder(tmp_path, "oggdec", src)
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))  # no ffmpeg anywhere
    assert streaming._ffmpeg_path() is None
    fake_ogg = tmp_path / "song.ogg"
    fake_ogg.write_bytes(b"OggSfake")
    with AudiofileToWavStream(str(fake_ogg)) as stream:
        chunks = list(SampleStream(stream, 1000))
    got = np.concatenate([c.get_frame_array() for c in chunks])
    assert chunks[0].samplerate == SR and got.shape[1] == 2   # normalized
    ref = want.copy().resample(SR).stereo().get_frame_array()
    np.testing.assert_array_equal(got, ref)


def test_oggdec_failure_raises_streaming_error(tmp_path, monkeypatch):
    bad = tmp_path / "bin" / "oggdec"
    bad.parent.mkdir(exist_ok=True)
    bad.write_text("#!/bin/sh\nexit 1\n")
    bad.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    f = tmp_path / "broken.ogg"
    f.write_bytes(b"OggS")
    with pytest.raises(StreamingError, match="oggdec failed"):
        AudiofileToWavStream(str(f))


@pytest.mark.skipif(__import__("shutil").which("ffmpeg") is None,
                    reason="no ffmpeg binary on this machine")
def test_real_ffmpeg_decode_smoke(tmp_path):
    """Lights up the moment an environment has ffmpeg: encode a tone to a
    lossy codec with the real binary and decode it back through the
    streaming layer."""
    import subprocess
    src = tmp_path / "tone.wav"
    tone(440, dur=0.5, amp=0.6).write_wav(str(src))
    enc = tmp_path / "tone.ogg"
    subprocess.run(["ffmpeg", "-v", "quiet", "-i", str(src), str(enc)],
                   check=True)
    with AudiofileToWavStream(str(enc)) as stream:
        got = np.concatenate([c.get_frame_array()
                              for c in SampleStream(stream, 2000)])
    assert len(got) > 0.4 * SR
    # lossy but the 440 Hz fundamental must dominate
    spec = np.abs(np.fft.rfft(got[: SR // 2, 0].astype(np.float64)))
    freqs = np.fft.rfftfreq(SR // 2, 1 / SR)
    assert abs(freqs[np.argmax(spec)] - 440.0) < 5.0
