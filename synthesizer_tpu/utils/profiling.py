"""Render profiling & observability.

The reference has no built-in tracing (SURVEY.md §6) — its authors added
Fast* oscillator variants after ad-hoc profiling.  Here the north-star
metric (realtime factor) is a first-class counter: wrap any render path in
a :class:`RenderTimer` to accumulate audio-seconds vs wall-seconds, and use
:func:`trace` to capture a ``jax.profiler`` trace for xprof/tensorboard.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import subprocess
import time
from typing import Iterator, Optional

log = logging.getLogger("synthesizer_tpu")


@dataclasses.dataclass
class RenderStats:
    chunks: int = 0
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    peak_wall_chunk: float = 0.0

    @property
    def realtime_factor(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def __str__(self) -> str:
        return (f"{self.chunks} chunks, {self.audio_seconds:.2f}s audio in "
                f"{self.wall_seconds:.3f}s wall -> {self.realtime_factor:.0f}x "
                f"realtime (worst chunk {self.peak_wall_chunk*1e3:.2f} ms)")


class RenderTimer:
    """Accumulates per-chunk render timings and the realtime factor.

    >>> timer = RenderTimer(samplerate=44100)
    >>> with timer.chunk(1470):
    ...     render_one_chunk()
    >>> timer.stats.realtime_factor
    """

    def __init__(self, samplerate: int):
        self.samplerate = samplerate
        self.stats = RenderStats()

    @contextlib.contextmanager
    def chunk(self, nframes: int) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.stats.chunks += 1
        self.stats.audio_seconds += nframes / self.samplerate
        self.stats.wall_seconds += dt
        self.stats.peak_wall_chunk = max(self.stats.peak_wall_chunk, dt)

    def reset(self) -> None:
        self.stats = RenderStats()

    def log_summary(self, level: int = logging.INFO) -> None:
        log.log(level, "render: %s", self.stats)


#: device-program launch counter — incremented by the Sample lazy-IR
#: materializer and the graph renderer, so tests can assert fusion claims
#: ("this 16-track chain compiles to <= N device programs").
program_launches = 0


def record_program_launch() -> None:
    global program_launches
    program_launches += 1


@contextlib.contextmanager
def count_program_launches() -> Iterator[list]:
    """Yield a single-element list whose [0] is the number of device
    programs our render paths launched inside the block."""
    start = program_launches
    out = [0]
    try:
        yield out
    finally:
        out[0] = program_launches - start


@contextlib.contextmanager
def trace(logdir: str = "/tmp/synthesizer_tpu_trace") -> Iterator[None]:
    """Capture a jax.profiler trace around a render (view with xprof)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", logdir)


def timed_stream(chunks, samplerate: int, timer: Optional[RenderTimer] = None):
    """Wrap a Sample-chunk iterator so every pull is timed."""
    timer = timer or RenderTimer(samplerate)

    def gen():
        for c in chunks:
            t0 = time.perf_counter()
            yield c
            dt = time.perf_counter() - t0
            timer.stats.chunks += 1
            timer.stats.audio_seconds += c.nframes / samplerate
            timer.stats.wall_seconds += dt
            timer.stats.peak_wall_chunk = max(timer.stats.peak_wall_chunk, dt)
    return gen(), timer


def require_gpu():
    """The first JAX device, which must be a GPU: a measurement that finds
    no card fails instead of reporting a CPU number."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default device is {dev.platform} "
                           f"({dev.device_kind})")
    return dev


def card_info() -> str:
    """Each card's name and power limit as ``nvidia-smi`` reports them
    (one ``name, limit`` line per card).  A card may be capped below its
    maximum power and then runs slower under load, so every timing is
    printed beside this."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
