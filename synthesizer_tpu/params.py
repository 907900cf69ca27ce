"""Global audio parameters.

Device-side analog of the reference's ``synthplayer/params.py`` module-global
knobs (SURVEY.md §3.1 row 1): normalization targets (44.1 kHz / stereo /
16-bit), streaming/playback chunk size, oscillator block size, and the
pop-prevention flag.

Two forms are provided:

* module globals named like the reference's, for API compatibility
  (``norm_samplerate`` etc.) — these are read at object-construction time;
* a frozen :class:`AudioParams` dataclass that is threaded explicitly through
  the device-side render engine (jit-static, hashable).
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Reference-compatible module globals (synthplayer/params.py equivalents).
# ---------------------------------------------------------------------------

#: Default sample rate for synthesis and normalization (Hz).
norm_samplerate: int = 44100

#: Default number of channels for normalized samples.
norm_nchannels: int = 2

#: Default sample width in bytes (2 = 16-bit signed PCM).
norm_samplewidth: int = 2

#: Frames per streaming/playback chunk (~33 ms at 44.1 kHz).
norm_frames_per_chunk: int = norm_samplerate // 30

#: Oscillator block size in samples for the lazy ``blocks()`` generator API.
norm_osc_blocksize: int = 512

#: Apply a tiny fade-in/out to samples queued for playback to avoid clicks.
auto_sample_pop_prevention: bool = False

#: Micro-fade length (seconds) used by pop prevention.
antipop_fadein: float = 0.005
antipop_fadeout: float = 0.005


# ---------------------------------------------------------------------------
# Explicit, hashable parameter bundle for the device-side engine.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AudioParams:
    """Immutable audio-format parameters threaded through the render engine.

    Hashable and jit-static: passing a different ``AudioParams`` retraces the
    compiled render functions.
    """

    samplerate: int = 44100
    samplewidth: int = 2
    nchannels: int = 2
    chunk_frames: int = 1470          # norm_samplerate // 30
    osc_blocksize: int = 512

    @property
    def chunk_duration(self) -> float:
        return self.chunk_frames / self.samplerate

    def replace(self, **kw) -> "AudioParams":
        return dataclasses.replace(self, **kw)


def default_params() -> AudioParams:
    """AudioParams snapshot of the current module globals."""
    return AudioParams(
        samplerate=norm_samplerate,
        samplewidth=norm_samplewidth,
        nchannels=norm_nchannels,
        chunk_frames=norm_frames_per_chunk,
        osc_blocksize=norm_osc_blocksize,
    )
