"""synthesizer_tpu — an accelerator-native audio DSP framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of irmen/synthesizer
("synthplayer"): a device-resident ``Sample`` PCM buffer with chainable DSP
ops, a declarative oscillator graph lowered to fused device programs, the
``WaveSynth`` eager renderer, a batched voice-bank engine, a pattern
sequencer that compiles songs to one batched render, and a streaming
mixer/playback layer with host control + device chunks.  See SURVEY.md for
the reference's structure and goldref/ for the behavioral oracle.
"""

__version__ = "0.1.0"

from . import params  # noqa: F401
from .sample import Sample, LevelMeter  # noqa: F401
from .ops.loudness import StreamingLoudness  # noqa: F401
from .synth import WaveSynth, key_freq, note_freq  # noqa: F401
from . import oscillators  # noqa: F401
from .playback import Output, RealTimeMixer  # noqa: F401
from .streaming import (AudiofileToWavStream, SampleStream,  # noqa: F401
                        StreamMixer, VolumeFilter, EndlessFramesFilter)
from .sequencer import Song  # noqa: F401
from .models.voicebank import Voice, VoiceBank, pack_voices  # noqa: F401
from .voice import RealtimeVoice  # noqa: F401
from .utils.profiling import RenderTimer  # noqa: F401
from .server import RenderServer  # noqa: F401
from .midi import render_midi  # noqa: F401
