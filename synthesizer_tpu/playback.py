"""Playback engine: Output facade, RealTimeMixer, audio sink backends.

Rebuild of ``synthplayer/playback.py`` (SURVEY.md §3.1 row 6, §4.3): an
``Output`` facade selects the best available host audio API and offers two
modes — ``"mixed"`` (a RealTimeMixer additively mixes any number of
concurrently playing samples into fixed-size chunks pumped from a feeder
thread) and ``"sequential"`` (a FIFO of whole samples).

Audio output is host I/O, not compute (SURVEY.md §3.3): the backends here
are miniaudio / sounddevice when installed, else a WAV-file or null sink
(this machine has neither library, so the file/null sinks are the CI path).
The K-way chunk mix itself runs on device (one jitted sum+clip per chunk);
sources are device-resident sample chunks.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from . import params
from .sample import Sample
from .utils import native, wavio

__all__ = ["Output", "RealTimeMixer", "best_api"]


# ---------------------------------------------------------------------------
# Sink backends
# ---------------------------------------------------------------------------

class AudioApi:
    """Base class for audio sinks consuming raw int16 frame chunks."""

    supports_realtime = False
    name = "base"

    def __init__(self, samplerate: int, samplewidth: int, nchannels: int):
        self.samplerate = samplerate
        self.samplewidth = samplewidth
        self.nchannels = nchannels

    def play_chunk(self, frames: np.ndarray) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullAudio(AudioApi):
    """Discards audio; with ``pace=True`` it sleeps to simulate realtime."""

    name = "null"

    def __init__(self, samplerate, samplewidth, nchannels, pace: bool = False):
        super().__init__(samplerate, samplewidth, nchannels)
        self.pace = pace

    def play_chunk(self, frames: np.ndarray) -> None:
        if self.pace:
            time.sleep(len(frames) / self.samplerate)


class WavSinkAudio(AudioApi):
    """Streams all played audio into a growing WAV file."""

    name = "wavsink"

    def __init__(self, samplerate, samplewidth, nchannels, filename: str):
        super().__init__(samplerate, samplewidth, nchannels)
        import wave
        self.filename = filename
        self._closed = False
        self._wav = wave.open(filename, "wb")
        self._wav.setnchannels(nchannels)
        self._wav.setsampwidth(samplewidth)
        self._wav.setframerate(samplerate)

    def play_chunk(self, frames: np.ndarray) -> None:
        if self._closed:
            return          # close() raced a slow pump iteration (fx/jit)
        self._wav.writeframes(np.ascontiguousarray(frames).tobytes())

    def close(self) -> None:
        self._closed = True
        self._wav.close()


class MiniaudioSink(AudioApi):
    """miniaudio-backed realtime playback (preferred when installed)."""

    supports_realtime = True
    name = "miniaudio"

    def __init__(self, samplerate, samplewidth, nchannels):
        super().__init__(samplerate, samplewidth, nchannels)
        import miniaudio
        fmt = {2: miniaudio.SampleFormat.SIGNED16,
               4: miniaudio.SampleFormat.SIGNED32}[samplewidth]
        self._device = miniaudio.PlaybackDevice(
            output_format=fmt, nchannels=nchannels, sample_rate=samplerate)
        self._queue: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=8)

        def generator():
            required = yield b""
            while True:
                try:
                    chunk = self._queue.get(timeout=0.2)
                    data = np.ascontiguousarray(chunk).tobytes()
                except queue.Empty:
                    data = b"\0" * required * nchannels * samplewidth
                required = yield data

        gen = generator()
        next(gen)
        self._device.start(gen)

    def play_chunk(self, frames: np.ndarray) -> None:
        self._queue.put(frames)

    def close(self) -> None:
        self._device.close()


class SounddeviceSink(AudioApi):
    """sounddevice/PortAudio-backed realtime playback."""

    supports_realtime = True
    name = "sounddevice"

    def __init__(self, samplerate, samplewidth, nchannels):
        super().__init__(samplerate, samplewidth, nchannels)
        import sounddevice
        dtype = {2: "int16", 4: "int32"}[samplewidth]
        self._stream = sounddevice.RawOutputStream(
            samplerate=samplerate, channels=nchannels, dtype=dtype)
        self._stream.start()

    def play_chunk(self, frames: np.ndarray) -> None:
        self._stream.write(np.ascontiguousarray(frames).tobytes())

    def close(self) -> None:
        self._stream.stop()
        self._stream.close()


def best_api(samplerate: int, samplewidth: int, nchannels: int,
             wav_file: Optional[str] = None) -> AudioApi:
    """Backend autoselect ladder: miniaudio -> sounddevice -> wav/null sink
    (the reference degrades across host APIs the same way, SURVEY.md §6)."""
    for cls in (MiniaudioSink, SounddeviceSink):
        try:
            return cls(samplerate, samplewidth, nchannels)
        except Exception:
            continue
    if wav_file:
        return WavSinkAudio(samplerate, samplewidth, nchannels, wav_file)
    return NullAudio(samplerate, samplewidth, nchannels)


# ---------------------------------------------------------------------------
# RealTimeMixer
# ---------------------------------------------------------------------------

class _Voice:
    __slots__ = ("sid", "chunks", "repeat", "delay_chunks", "name")

    def __init__(self, sid, chunks, repeat, delay_chunks, name):
        self.sid = sid
        self.chunks = chunks
        self.repeat = repeat
        self.delay_chunks = delay_chunks
        self.name = name


class RealTimeMixer:
    """Additively mixes any number of active sample streams into fixed-size
    chunks (the reference's mixed-mode engine, SURVEY.md §4.3).  Chunk
    addition runs on device; the host only sequences streams."""

    def __init__(self, chunk_frames: int, samplerate: int, nchannels: int,
                 pop_prevention: Optional[bool] = None):
        self.chunk_frames = chunk_frames
        self.samplerate = samplerate
        self.nchannels = nchannels
        self.pop_prevention = (params.auto_sample_pop_prevention
                               if pop_prevention is None else pop_prevention)
        self._voices: Dict[int, _Voice] = {}
        self._next_sid = 1
        self._lock = threading.Lock()
        self._ended_callbacks: List[Callable[[int], None]] = []

    def add_sample(self, sample: Sample, repeat: bool = False,
                   delay: float = 0.0, sid: Optional[int] = None,
                   chunk_delay: Optional[int] = None) -> int:
        if self.pop_prevention and not repeat:
            sample = sample.copy().fadein(params.antipop_fadein).fadeout(
                params.antipop_fadeout)
        chunks = sample.chunked_frame_data(self.chunk_frames, repeat=repeat)
        with self._lock:
            if sid is None:
                sid = self._next_sid
                self._next_sid += 1
            dc = chunk_delay if chunk_delay is not None else int(
                delay * self.samplerate / self.chunk_frames)
            self._voices[sid] = _Voice(sid, chunks, repeat, dc, sample.name)
        return sid

    def add_stream(self, chunk_iter: Iterator[bytes], sid: Optional[int] = None) -> int:
        with self._lock:
            if sid is None:
                sid = self._next_sid
                self._next_sid += 1
            self._voices[sid] = _Voice(sid, chunk_iter, False, 0, "stream")
        return sid

    def remove_sample(self, sid: int) -> None:
        with self._lock:
            self._voices.pop(sid, None)

    def register_ended_callback(self, cb: Callable[[int], None]) -> None:
        self._ended_callbacks.append(cb)

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._voices)

    def chunks(self) -> Iterator[np.ndarray]:
        """Endless generator of mixed [chunk_frames, nchannels] int16 arrays."""
        nbytes = self.chunk_frames * self.nchannels * 2
        while True:
            parts: List[np.ndarray] = []
            ended: List[int] = []
            with self._lock:
                voices = list(self._voices.values())
            for v in voices:
                if v.delay_chunks > 0:
                    v.delay_chunks -= 1
                    continue
                try:
                    raw = next(v.chunks)
                except StopIteration:
                    ended.append(v.sid)
                    continue
                a = np.frombuffer(raw, np.int16)
                if len(raw) < nbytes:
                    a = np.concatenate(
                        [a, np.zeros((nbytes - len(raw)) // 2, np.int16)])
                    ended.append(v.sid)
                parts.append(a.reshape(self.chunk_frames, self.nchannels))
            for sid in ended:
                self.remove_sample(sid)
                for cb in self._ended_callbacks:
                    cb(sid)
            if not parts:
                yield np.zeros((self.chunk_frames, self.nchannels), np.int16)
            elif len(parts) == 1:
                yield parts[0]
            else:
                # realtime chunks are tiny (33 ms): per-chunk device dispatch
                # latency would dominate, so the K-way saturating add runs in
                # the native pcmops library (bulk DSP stays on device)
                yield native.mix_k_i16(parts).reshape(
                    self.chunk_frames, self.nchannels)


# ---------------------------------------------------------------------------
# Output facade
# ---------------------------------------------------------------------------

class Output:
    """Host audio output facade (the reference's ``Output``).

    mixing="mixed":      concurrent samples additively mixed in realtime.
    mixing="sequential": whole samples played one after another.

    Usable as a context manager.  When no realtime audio API is available
    the output degrades to a WAV-file sink (``wav_file=``) or a null sink.
    """

    def __init__(self, samplerate: int = 0, samplewidth: int = 0,
                 nchannels: int = 0, frames_per_chunk: int = 0,
                 mixing: str = "mixed", queue_size: int = 100,
                 wav_file: Optional[str] = None, api: Optional[AudioApi] = None,
                 meter=None, fx=None, fx_lookahead: int = 1):
        self.samplerate = samplerate or params.norm_samplerate
        self.samplewidth = samplewidth or params.norm_samplewidth
        self.nchannels = nchannels or params.norm_nchannels
        self.frames_per_chunk = frames_per_chunk or params.norm_frames_per_chunk
        assert mixing in ("mixed", "sequential")
        if mixing == "mixed" and self.samplewidth != 2:
            raise ValueError("mixed-mode output requires 16-bit samples")
        self.mixing = mixing
        self.api = api or best_api(self.samplerate, self.samplewidth,
                                   self.nchannels, wav_file)
        self.meter = meter  # optional LevelMeter updated per mixed chunk
        #: optional master-bus FxChain (synthesizer_tpu.effects) applied to
        #: every mixed chunk before the sink — the playback twin of the
        #: song [fx] section.  Mixed mode only.
        #:
        #: ``fx_lookahead`` (the realtime-voice superblock trick applied
        #: to the master bus): process N chunks per device round trip —
        #: ONE host->device->host sync per N*chunk frames instead of per
        #: chunk, for hosts where one sync would eat most of the ~33 ms
        #: chunk budget.  Trade-off: new voices join
        #: the fx bus up to N-1 chunks late (the mixer itself still mixes
        #: them immediately).  The chain is stateful and evaluates the
        #: same recurrences at any chunk size, so lookahead changes audio
        #: only within each effect's documented chunk-regrouping budget.
        self.fx = fx
        self.fx_lookahead = max(1, int(fx_lookahead))
        if fx is not None and mixing != "mixed":
            raise ValueError("fx requires mixed-mode output")
        self._notify_played: List[Callable[[Sample], None]] = []
        self._all_played = threading.Event()
        self._all_played.set()
        self._closing = False
        self._played_count = 0
        self._mixed_samples: Dict[int, Sample] = {}
        if mixing == "mixed":
            self.mixer = RealTimeMixer(self.frames_per_chunk, self.samplerate,
                                       self.nchannels)
            self.mixer.register_ended_callback(self._voice_ended)
            self._thread = threading.Thread(target=self._mix_pump, daemon=True)
        else:
            self.mixer = None
            self._queue: "queue.Queue[Optional[Sample]]" = queue.Queue(maxsize=queue_size)
            self._thread = threading.Thread(target=self._seq_pump, daemon=True)
        self._thread.start()

    # -- pumps --------------------------------------------------------------

    def _mix_pump(self) -> None:
        gen = self.mixer.chunks()
        had_audio = False
        while not self._closing:
            L = self.fx_lookahead if self.fx is not None else 1
            chunks = [next(gen)]
            # capture voice activity NOW: a short voice can start AND end
            # inside one superblock, and a post-collection check would
            # then skip the fx for the very block that carries it
            active = self.mixer.active_count > 0
            if L > 1 and (active or had_audio):
                # superblock: pull L-1 more chunks so the fx chain runs
                # ONE fused device program (and one host sync) per
                # superblock — the voice.py lookahead trick on the bus
                for _ in range(L - 1):
                    if self._closing:
                        return
                    chunks.append(next(gen))
                active = active or self.mixer.active_count > 0
            if self.fx is not None:
                if active or had_audio:
                    # keep feeding the chain while tails ring after the
                    # last voice ends (reverb/convolution decay)
                    block = (chunks[0] if len(chunks) == 1
                             else np.concatenate(chunks, axis=0))
                    out = np.asarray(self.fx.process(block))
                    cf = self.frames_per_chunk
                    chunks = [out[j * cf:(j + 1) * cf]
                              for j in range(len(chunks))]
                had_audio = active or (
                    had_audio and any(np.any(c) for c in chunks))
            if self._closing:
                break
            for chunk in chunks:
                try:
                    self.api.play_chunk(chunk)
                except Exception:
                    # close() joins with a timeout; if a slow iteration
                    # (first fx/jit compile) overran it, the sink may
                    # already be shut
                    if self._closing:
                        break
                    raise
                if self.meter is not None and self.mixer.active_count:
                    # the mixed chunk is already host memory: meter
                    # natively, no device round-trip on the realtime path
                    self.meter.update_frames(chunk, self.samplerate)
                if self._closing:
                    break
            if self.mixer.active_count == 0:
                self._all_played.set()
                if not isinstance(self.api, (MiniaudioSink, SounddeviceSink)):
                    # no realtime device pacing the loop: idle politely
                    time.sleep(0.001)

    def _seq_pump(self) -> None:
        while not self._closing:
            try:
                sample = self._queue.get(timeout=0.1)
            except queue.Empty:
                self._all_played.set()
                continue
            if sample is None:
                break
            for raw in sample.chunked_frame_data(self.frames_per_chunk):
                a = np.frombuffer(raw, np.int16).reshape(-1, self.nchannels)
                self.api.play_chunk(a)
            self._played_count += 1
            for cb in self._notify_played:
                cb(sample)
            if self._queue.empty():
                self._all_played.set()

    def _voice_ended(self, sid: int) -> None:
        self._played_count += 1
        sample = self._mixed_samples.pop(sid, None)
        if sample is not None:
            for cb in self._notify_played:
                cb(sample)

    # -- public API -----------------------------------------------------------

    def play_sample(self, sample: Sample, repeat: bool = False,
                    delay: float = 0.0) -> Optional[int]:
        """Play (or queue) a sample; in mixed mode returns a stream id."""
        if sample.samplewidth != self.samplewidth:
            sample = sample.copy().make_16bit(maximize_amplitude=False)
        if sample.nchannels == 1 and self.nchannels == 2:
            sample = sample.copy().stereo()
        elif sample.nchannels == 2 and self.nchannels == 1:
            sample = sample.copy().mono()
        if self.mixing == "mixed":
            self._all_played.clear()
            sid = self.mixer.add_sample(sample, repeat, delay)
            self._mixed_samples[sid] = sample
            return sid
        self._all_played.clear()
        self._queue.put(sample)
        return None

    def stop_sample(self, sid: int) -> None:
        if self.mixer:
            self.mixer.remove_sample(sid)

    def register_notify_played(self, cb: Callable[[Sample], None]) -> None:
        self._notify_played.append(cb)

    def still_playing(self) -> bool:
        return not self._all_played.is_set()

    def wait_all_played(self, timeout: Optional[float] = None) -> None:
        self._all_played.wait(timeout)

    def close(self) -> None:
        self._closing = True
        if self.mixing == "sequential":
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                pass
        self._thread.join(timeout=2.0)
        self.api.close()

    def __enter__(self) -> "Output":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
