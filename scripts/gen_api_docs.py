#!/usr/bin/env python3
"""Generate docs/API.md from the LIVE public surface.

Introspection keeps the reference complete and honest: every name in the
package __all__s, every public Sample method/property, every oscillator
class, every Song/streaming/playback/app entry point appears with its
real signature and the first line of its real docstring.  Numeric budget
classes and streaming-twin pointers come from the curated tables below
(the budgets themselves are DERIVED in docs/NUMERICS.md and pinned by
the test suite / on-chip battery — this file only labels which class
each method belongs to).

Run:    python scripts/gen_api_docs.py          (rewrites docs/API.md)
Check:  tests/test_api_docs.py regenerates and diffs — a stale API.md
        fails CI, so the doc cannot drift from the code.
"""

import inspect
import io
import sys

import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: numeric budget classes (docs/NUMERICS.md has the derivations)
B_INT = "bit-exact (integer audioop semantics)"
B_F32 = "bit-exact f32 spec (product+floor+clamp)"
B_FMA = "<=1 LSB (FMA-contraction class)"
B_SCAN = "derived scan bound (ops.coeffs.predicted_scan_error_lsb; ff-scan routed)"
B_SPEC = "documented spec tolerance (see docstring)"
B_HOST = "host/metadata (no device numerics)"
B_DDS = "exact integer DDS phase; f32 waveform eval <=1 LSB"

#: Sample method -> (budget class, streaming twin or "")
SAMPLE_BUDGETS = {
    "amplify": (B_F32, ""), "amplify_max": (B_F32, ""),
    "invert": (B_INT, ""), "bias": (B_INT, ""), "clip": (B_INT, ""),
    "cut": (B_HOST, ""), "split": (B_HOST, ""), "dup": (B_HOST, ""),
    "copy": (B_HOST, ""),
    "add_silence": (B_INT, ""), "pad_frames": (B_INT, ""),
    "truncate_frames": (B_HOST, ""), "join": (B_INT, ""),
    "reverse": (B_INT, ""), "delay": (B_INT, ""),
    "fadein": (B_FMA, ""), "fadeout": (B_FMA, ""),
    "envelope": (B_FMA, ""),
    "modulate_amp": (B_FMA, ""),
    "mix": (B_INT, ""), "mix_at": (B_INT, ""), "stereo_mix": (B_INT, ""),
    "echo": (B_FMA, ""),
    "make_16bit": (B_INT, ""), "make_32bit": (B_INT, ""),
    "resample": (B_INT,
                 "streaming.RateConvertFilter (quality='hq': "
                 "ops.resample.StreamingHQResampler)"),
    "speed": (B_INT, ""),
    "mono": (B_FMA, ""), "stereo": (B_INT, ""), "pan": (B_FMA, ""),
    "normalize": (B_INT, ""),
    "compress": (B_SPEC, "effects.StreamingCompressor"),
    "gate": (B_SPEC, "effects.StreamingGate"),
    "filter": (B_SCAN, "effects.StreamingBiquad / SweptGainKindBiquad"),
    "eq": (B_SCAN, "effects.StreamingEQ / SweptEQBand"),
    "reverb": (B_SPEC, "effects.StreamingReverb"),
    "chorus": (B_SPEC, "effects.StreamingChorus"),
    "feedback_echo": (B_SPEC, "effects.StreamingFeedbackEcho"),
    "phaser": (B_SCAN, "effects.StreamingPhaser"),
    "tremolo": (B_F32, "effects.StreamingTremolo"),
    "autopan": (B_F32, "effects.StreamingAutopan"),
    "stereo_width": (B_FMA, "effects.StreamingWidth"),
    "limit": (B_SPEC, "effects.StreamingLimiter (holdback)"),
    "convolve": (B_SPEC, "effects.StreamingConvolver (overlap-add)"),
    "granulate": (B_SPEC, ""),
    "stretch": (B_SPEC, ""), "pitch_shift": (B_SPEC, ""),
    "loudness_lufs": (B_SPEC, "StreamingLoudness"),
    "loudness_stats": (B_SPEC, "StreamingLoudness"),
    "true_peak_dbtp": (B_SPEC, ""),
    "normalize_lufs": (B_SPEC, ""),
    "write_wav": (B_HOST, ""), "write_flac": (B_HOST, ""),
    "write_mp3": (B_HOST, ""), "write_ogg": (B_HOST, ""),
    "write_opus": (B_HOST, ""), "write_m4a": (B_HOST, ""),
    "write_audio": (B_HOST, ""),
    "chunked_frame_data": (B_HOST, ""),
    "get_frame_array": (B_HOST, ""), "view_frame_data": (B_HOST, ""),
    "from_array": (B_HOST, ""), "from_jax": (B_HOST, ""),
    "from_patch": (B_DDS, ""), "from_raw_frames": (B_HOST, ""),
}


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _doc1(obj) -> str:
    d = inspect.getdoc(obj)
    if not d:
        return ""
    line = d.strip().split("\n\n")[0].replace("\n", " ")
    return line if len(line) <= 300 else line[:297] + "..."


def _method_rows(cls, names, budgets=None):
    rows = []
    for n in names:
        m = getattr(cls, n)
        entry = f"`{n}{_sig(m)}`"
        doc = _doc1(m)
        if budgets and n in budgets:
            b, twin = budgets[n]
            doc += f"  \n  *budget*: {b}"
            if twin:
                doc += f"; *streaming twin*: `{twin}`"
        rows.append((entry, doc))
    return rows


def _class_section(out, cls, title=None, budgets=None, skip=()):
    names = [n for n in dir(cls)
             if not n.startswith("_") and callable(getattr(cls, n))
             and n not in skip]
    out.write(f"### `{title or cls.__name__}`\n\n")
    head = _doc1(cls)
    if head:
        out.write(head + "\n\n")
    for entry, doc in _method_rows(cls, names, budgets):
        out.write(f"* {entry}  \n  {doc}\n")
    out.write("\n")


def generate() -> str:
    import synthesizer_tpu as st
    from synthesizer_tpu import (LevelMeter, Output, RealTimeMixer,
                                 RealtimeVoice, Sample, Song,
                                 StreamingLoudness, StreamMixer, VoiceBank,
                                 WaveSynth)
    from synthesizer_tpu import oscillators as O
    from synthesizer_tpu import effects as FX
    from synthesizer_tpu import midi as M
    from synthesizer_tpu import streaming as STR
    from synthesizer_tpu.models import voicebank as VB
    from synthesizer_tpu.parallel import mesh as MESH
    from synthesizer_tpu.server import RenderServer

    out = io.StringIO()
    out.write("""# Public API reference

**GENERATED** from the live package by `scripts/gen_api_docs.py` —
regenerate after changing any public surface (`tests/test_api_docs.py`
fails when this file is stale).  Each entry: real signature + the first
line of the real docstring.  *Budget* labels the numeric contract class
(derivations: `docs/NUMERICS.md`; pinned by the CPU suite and the
on-card battery `scripts/chip_verify.py`):

* **bit-exact (integer audioop semantics)** — integer PCM ops equal the
  measured C audioop behavior bit for bit.
* **bit-exact f32 spec** — float-factor ops: f32 product + floor +
  clamp, bit-exact vs the goldref f32 twin.
* **<=1 LSB (FMA class)** — multiply-add chains the backend may
  contract to FMA; pinned at <=1 LSB of int16.
* **derived scan bound** — IIR biquads through the parallel companion
  scan; per-coefficient bound `predicted_scan_error_lsb`, with badly
  conditioned sets routed to the compensated float-float scan (<=1-2
  LSB of the f64 oracle).
* **exact integer DDS** — oscillator phase is exact mod 2^32 (closed
  form, incl. glide chirps and MIDI bend segments); the f32 waveform
  evaluation is the only error source.
* **documented spec tolerance** — ops whose docstring/goldref twin
  states a specific tolerance (reverb, vocoder, dynamics, loudness).

Top-level: `import synthesizer_tpu` exposes
""")
    names = sorted(n for n in dir(st)
                   if not n.startswith("_") and n not in
                   ("sample", "sequencer", "synth", "voice", "playback",
                    "streaming", "server", "models", "ops", "params",
                    "utils", "midi", "oscillators"))
    out.write("`" + "`, `".join(names) + "`\n\n")

    out.write("## Sample — device-resident PCM buffer\n\n")
    out.write(_doc1(Sample) + "\n\n")
    out.write("Properties: `nframes`, `duration`, `samplerate`, "
              "`samplewidth`, `nchannels`, `maxvalue`, `jax_frames`.  "
              "Ops are chainable and LAZY: each call stages IR; the fused "
              "device program compiles/runs on materialization "
              "(`get_frame_array`, `view_frame_data`, `write_*`).\n\n")
    meths = [n for n in dir(Sample) if not n.startswith("_")
             and callable(getattr(Sample, n))]
    for entry, doc in _method_rows(Sample, meths, SAMPLE_BUDGETS):
        out.write(f"* {entry}  \n  {doc}\n")
    out.write("\n")

    out.write("## Synthesis\n\n")
    _class_section(out, WaveSynth)
    out.write("### Oscillator graph (`synthesizer_tpu.oscillators`)\n\n")
    out.write(_doc1(O) + "\n\n")
    out.write("*budget*: exact integer DDS phase (closed form; FM per the "
              "frozen spec in `models/spec.py`); f32 waveform eval <=1 LSB "
              "vs `goldref/osc.py`; Biquad filters carry the derived scan "
              "bound.\n\n")
    for name in O.__all__:
        cls = getattr(O, name)
        out.write(f"* `{name}{_sig(cls.__init__ if inspect.isclass(cls) else cls)}` — {_doc1(cls)}\n")
    out.write("\n")
    out.write("### Voice bank (`synthesizer_tpu.models.voicebank`)\n\n")
    out.write(_doc1(VB) + "\n\n")
    out.write(f"* `Voice` — fields: "
              + ", ".join(f"`{f}`" for f in VB.Voice.__dataclass_fields__)
              + "\n")
    out.write(f"* `pack_voices{_sig(VB.pack_voices)}` — {_doc1(VB.pack_voices)}\n")
    out.write(f"* `compile_pitch_segments{_sig(VB.compile_pitch_segments)}` — {_doc1(VB.compile_pitch_segments)}\n")
    _class_section(out, VoiceBank)
    _class_section(out, RealtimeVoice)

    out.write("## Playback & streaming\n\n")
    _class_section(out, Output)
    _class_section(out, RealTimeMixer)
    for name in ("AudiofileToWavStream", "SampleStream", "StreamMixer",
                 "VolumeFilter", "EndlessFramesFilter",
                 "RateConvertFilter"):
        cls = getattr(STR, name)
        out.write(f"* `{name}{_sig(cls.__init__)}` — {_doc1(cls)}\n")
    out.write("\n")
    _class_section(out, LevelMeter)
    _class_section(out, StreamingLoudness)

    out.write("## Songs (`synthesizer_tpu.Song`)\n\n")
    _class_section(out, Song)

    out.write("## Effects chains (`synthesizer_tpu.effects`)\n\n")
    out.write(_doc1(FX.FxChain) + "\n\n")
    out.write(f"* `FxChain{_sig(FX.FxChain.__init__)}`\n")
    streaming_classes = [n for n in dir(FX)
                         if n.startswith(("Streaming", "Swept"))
                         and inspect.isclass(getattr(FX, n))]
    for n in sorted(streaming_classes):
        out.write(f"* `{n}{_sig(getattr(FX, n).__init__)}` — "
                  f"{_doc1(getattr(FX, n))}\n")
    out.write(f"* `apply_fx_sample{_sig(FX.apply_fx_sample)}` — "
              f"{_doc1(FX.apply_fx_sample)}\n")
    out.write(f"* `run_fx_chain_ops{_sig(FX.run_fx_chain_ops)}` — "
              f"{_doc1(FX.run_fx_chain_ops)}\n\n")

    out.write("## MIDI (`synthesizer_tpu.midi`)\n\n")
    out.write(_doc1(M) + "\n\n")
    for n in M.__all__:
        fn = getattr(M, n)
        out.write(f"* `{n}{_sig(fn) if callable(fn) and not inspect.isclass(fn) else ''}` — {_doc1(fn)}\n")
    out.write("\n")

    out.write("## Multi-chip (`synthesizer_tpu.parallel.mesh`)\n\n")
    out.write(_doc1(MESH) + "\n\n")
    for n in ("voice_mesh", "render_song_sharded", "shard_voice_params",
              "scatter_mix_sharded"):
        if hasattr(MESH, n):
            fn = getattr(MESH, n)
            out.write(f"* `{n}{_sig(fn)}` — {_doc1(fn)}\n")
    out.write("\n")

    out.write("## Server & apps\n\n")
    _class_section(out, RenderServer)
    out.write("""* `trackmixer.py` — CLI mixdown (`-o out.wav/.flac/.mp3/...`,
  `--lufs`, `--stems`, `--no-normalize`, `song.mid` input) + REPL
  (`load patterns play mix record stems stream loudness info`).
* `keyboard_gui.py` — `SynthController` (headless brain) + Tk piano view.
* `jukebox/` — `MusicLibrary` (sqlite), `Jukebox(crossfade=,
  level_match=, target_lufs=, limiter_db=)`, Tk playlist view.
""")
    return out.getvalue()


if __name__ == "__main__":
    text = generate()
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "API.md")
    with open(path, "w") as f:
        f.write(text)
    print(f"wrote {path}: {len(text.splitlines())} lines")
