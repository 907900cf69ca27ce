#!/usr/bin/env python3
"""Benchmark: 64-voice stereo song mixdown on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": realtime_factor, "unit": "x_realtime",
   "vs_baseline": ..., plus secondary fields}

The headline metric follows BASELINE.json: realtime factor (audio seconds
rendered per wall second) for a 64-voice stereo mixdown, with
Msamples/sec/chip (voice-samples = voices x frames) reported alongside.
Baseline: the pure-Python reference plays a handful of streams at ~1x
realtime, so vs_baseline == the realtime factor itself.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def build_song(nvoices: int, duration: float, samplerate: int):
    """A dense 64-voice synth song: chords/arps across all waveforms with
    FM on a third of the voices and harmonic stacks on an eighth."""
    from synthesizer_tpu.models.voicebank import Voice

    waves = ["sine", "triangle", "square", "sawtooth", "pulse",
             "semicircle", "pointy", "harmonics"]
    voices = []
    for i in range(nvoices):
        w = waves[i % len(waves)]
        note_len = 0.25 + (i % 7) * 0.05
        voices.append(Voice(
            wave=w,
            frequency=55.0 * (2 ** ((i % 36) / 12.0)),
            amplitude=0.5 / 8,
            pan=((i % 17) - 8) / 8.0,
            start=(i / nvoices) * (duration - 1.0),
            duration=min(note_len * 8, duration / 2),
            attack=0.01, decay=0.05, sustain_level=0.7, release=0.1,
            fm_frequency=5.0 + (i % 5) if i % 3 == 0 else 0.0,
            fm_depth=0.015 if i % 3 == 0 else 0.0,
            harmonics=[1.0, 0.5, 0.33, 0.25, 0.2, 0.16, 0.14, 0.125]
            if w == "harmonics" else (),
            seed=i,
        ))
    return voices


def main() -> int:
    import functools

    from synthesizer_tpu.utils.compile_cache import enable_compile_cache
    from synthesizer_tpu.utils.profiling import card_info, require_gpu

    enable_compile_cache()
    import jax
    try:
        dev = require_gpu()
    except RuntimeError as e:
        print(f"error: {e}; bench.py measures the GPU only", file=sys.stderr)
        return 1
    card = card_info()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"card: {card}", file=sys.stderr)

    import jax.numpy as jnp
    import numpy as np

    from synthesizer_tpu.models.voicebank import VoiceBank, pack_voices

    samplerate = 44100
    nvoices = 64
    duration = 60.0
    chunk = 131072      # few large chunks: per-scan-step overhead amortizes
    nharm = 8

    total_frames = int(duration * samplerate)
    voices = build_song(nvoices, duration, samplerate)
    vp, layout = pack_voices(voices, samplerate, num_harmonics=nharm,
                             sort_by_wave=True)
    bank = VoiceBank.for_voices(voices, samplerate, chunk_frames=chunk,
                                num_harmonics=nharm, layout=layout,
                                nvoices=layout.nvoices)
    nchunks = -(-total_frames // chunk)

    # Timing: K data-dependent full-song renders chained inside ONE jit
    # call (phase perturbed by the previous checksum so XLA cannot CSE
    # them), and the slope between two K values; "value" is the per-render
    # time, "single_call_x_realtime" one whole call with its host sync.

    def slope_fit(timed, k_lo, k_hi, min_delta=0.02, escalations=4):
        """Two-point slope of timed(k) (min wall seconds of the compiled
        k-repeat chain), escalating (k_lo, k_hi) x4 until the delta clears
        min_delta, so that fast configs do not measure timer noise."""
        for _ in range(escalations + 1):
            lo, hi = timed(k_lo), timed(k_hi)
            if hi - lo >= min_delta:
                break
            k_lo, k_hi = k_lo * 4, k_hi * 4
        return max((hi - lo) / (k_hi - k_lo), 1e-9)
    @functools.partial(jax.jit, static_argnames=("k", "nchunks"))
    def rep_render(vp, k, nchunks):
        def body(c, _):
            vp2 = vp._replace(phase0=vp.phase0 + c.astype(jnp.uint32))
            out = bank._song_fn(vp2, nchunks)
            s = jnp.mean(jnp.abs(bank.to_int16(out).astype(jnp.float32)))
            return (s * 0) + s % 1, None
        c, _ = jax.lax.scan(body, jnp.float32(0), None, length=k)
        return c

    # warmup / compile
    t0 = time.perf_counter()
    checksum = float(np.asarray(rep_render(vp, k=1, nchunks=nchunks)))
    compile_and_first = time.perf_counter() - t0
    float(np.asarray(rep_render(vp, k=9, nchunks=nchunks)))  # compile k=9

    def best(k):
        float(np.asarray(rep_render(vp, k=k, nchunks=nchunks)))  # compile
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            np.asarray(rep_render(vp, k=k, nchunks=nchunks))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    single_call = best(1)
    elapsed = slope_fit(best, 1, 9)           # per-render compute time
    out = bank.to_int16(bank.render_song(vp, total_frames))

    rtf = duration / elapsed
    voice_msamples = layout.nvoices * total_frames / elapsed / 1e6
    out_msamples = total_frames / elapsed / 1e6

    # secondary: config 3 (the chainable per-op API) — the whole 16-track
    # workload incl. synthesis fuses to ONE device program
    from synthesizer_tpu import Sample, WaveSynth

    def config3(track_sec=2.0, gap=1.0):
        synth3 = WaveSynth(samplerate=22050, samplewidth=2)
        total3 = Sample.from_raw_frames(b"", 2, samplerate, 2)
        for t in range(16):
            s = synth3.sine(100.0 + 50 * t, track_sec, amplitude=0.4)
            s.resample(samplerate).amplify(0.5 + 0.02 * t) \
             .fadein(0.02).fadeout(0.05).stereo()
            total3.mix_at(gap * t, s)
        return total3

    c3_dur = len(config3().get_frame_array()) / samplerate   # + compile
    c3_wall = min(
        (lambda t0: (config3().get_frame_array(),
                     time.perf_counter() - t0)[1])(time.perf_counter())
        for _ in range(4))

    # scaling gates (the flat-throughput claim is checked
    # by every round, not a one-off): 1024 simultaneous voices, and a
    # 10-minute render — both via the same slope methodology
    def bank_rtf(v2, dur, k_hi=5, nh=nharm, ck=chunk):
        vp2, ly2 = pack_voices(v2, samplerate, num_harmonics=nh,
                               sort_by_wave=True)
        bank2 = VoiceBank.for_voices(v2, samplerate, chunk_frames=ck,
                                     num_harmonics=nh, layout=ly2,
                                     nvoices=ly2.nvoices)
        nck = -(-int(dur * samplerate) // ck)

        @functools.partial(jax.jit, static_argnames=("k", "nchunks"))
        def rep2(vp, k, nchunks):
            def body(c, _):
                vpp = vp._replace(phase0=vp.phase0 + c.astype(jnp.uint32))
                o = bank2._song_fn(vpp, nchunks)
                s = jnp.mean(jnp.abs(bank2.to_int16(o).astype(jnp.float32)))
                return (s * 0) + s % 1, None
            c, _ = jax.lax.scan(body, jnp.float32(0), None, length=k)
            return c

        def best2(k):
            float(np.asarray(rep2(vp2, k=k, nchunks=nck)))  # compile
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                np.asarray(rep2(vp2, k=k, nchunks=nck))
                ts.append(time.perf_counter() - t0)
            return min(ts)

        el = slope_fit(best2, max(k_hi // 2, 1), k_hi)
        return (dur / el,
                ly2.nvoices * int(dur * samplerate) / el / 1e6)

    def scaled_rtf(nv, dur, k_hi=5):
        return bank_rtf(build_song(nv, dur, samplerate), dur, k_hi)

    scale_rtf, scale_vms = scaled_rtf(1024, 10.0)
    long_rtf, _ = scaled_rtf(64, 600.0, k_hi=3)

    # round-5 gate: sparse bucketed song render (VoiceBank.sparse_plan)
    # — a MIDI-style workload (many notes, few sounding) renders over
    # per-chunk active-voice buckets instead of the whole bank; the gate
    # measures the bucketed program with the same k-repeat slope
    def sparse_rtf(nnotes, dur, k_hi=4):
        from synthesizer_tpu.models.voicebank import Voice as BankVoice
        rng3 = np.random.default_rng(5)
        v3 = [BankVoice(
            wave=("sine", "sawtooth_bl", "triangle")[i % 3],
            frequency=float(rng3.uniform(80, 2000)), amplitude=0.08,
            pan=float(rng3.uniform(-1, 1)),
            start=round(float(rng3.uniform(0, dur - 1.0)), 3),
            duration=0.4, attack=0.005, decay=0.05, sustain_level=0.7,
            release=0.1) for i in range(nnotes)]
        vp3, ly3 = pack_voices(v3, samplerate, num_harmonics=8,
                               sort_by_wave=True)
        bank3 = VoiceBank.for_voices(v3, samplerate, chunk_frames=chunk,
                                     num_harmonics=8, layout=ly3,
                                     nvoices=ly3.nvoices)
        plan = bank3.sparse_plan(vp3, int(dur * samplerate))
        assert plan is not None, "sparse workload fell back to flat"
        fn, idx, pad_start, nck3 = plan

        @functools.partial(jax.jit, static_argnames=("k", "nchunks"))
        def rep3(vp, k, nchunks):
            def body(c, _):
                vpp = vp._replace(phase0=vp.phase0
                                  + c.astype(jnp.uint32))
                o = fn(vpp, idx, pad_start, nchunks)
                s = jnp.mean(jnp.abs(bank3.to_int16(o)
                                     .astype(jnp.float32)))
                return (s * 0) + s % 1, None
            c, _ = jax.lax.scan(body, jnp.float32(0), None, length=k)
            return c

        def best3(k):
            float(np.asarray(rep3(vp3, k=k, nchunks=nck3)))
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                np.asarray(rep3(vp3, k=k, nchunks=nck3))
                ts.append(time.perf_counter() - t0)
            return min(ts)

        el = slope_fit(best3, max(k_hi // 2, 1), k_hi)
        return dur / el, ly3.nvoices, int(idx.shape[1])

    sparse_midi_rtf, sparse_v, sparse_k = sparse_rtf(600, 300.0)

    # configs 1/2/4 (all five BASELINE.json configs gated
    # by every driver capture, same amortized-sync slope methodology).
    # Graph patches have no perturbable input array, so the anti-CSE data
    # dependence threads the checksum into the block offset as
    # (c*0).astype(i32) — symbolically data-dependent, numerically zero.
    from synthesizer_tpu.models import graph as G
    from synthesizer_tpu.models import spec as Spec

    def patch_rtf(node, total, block, k_hi=9):
        st0, step = G.lower(node, samplerate, block)
        nblocks = -(-total // block)

        @functools.partial(jax.jit, static_argnames=("k",))
        def rep(k):
            def body(c, _):
                off = (c * jnp.float32(0)).astype(jnp.int32)

                def inner(carry, i):
                    st, acc = carry
                    vals, st = step(st, i * block + off)
                    return (st, acc + jnp.sum(jnp.abs(vals))), None

                (_, acc), _ = jax.lax.scan(
                    inner, (st0, jnp.float32(0)),
                    jnp.arange(nblocks, dtype=jnp.int32))
                return acc % jnp.float32(1), None

            c, _ = jax.lax.scan(body, jnp.float32(0), None, length=k)
            return c

        def bestp(k):
            float(np.asarray(rep(k=k)))                     # compile
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                np.asarray(rep(k=k))
                ts.append(time.perf_counter() - t0)
            return min(ts)

        el = slope_fit(bestp, max(k_hi // 2, 1), k_hi)
        return (total / samplerate) / el

    # config 1: 2 s 440 Hz sine -> mono (battery fidelity twin:
    # scripts/chip_verify.py config1/sine_2s)
    config1_rtf = patch_rtf(Spec.Osc("sine", 440.0, 0.9999),
                            2 * samplerate, 32768, k_hi=8192)
    # config 4: LFO-modulated graph + echo chain at the 1470-frame
    # streaming chunk size (battery twin: config4/lfo_echo_chunks)
    patch4 = Spec.Echo(
        Spec.AmpMod(Spec.Osc("sawtooth", 330.0, 0.7,
                             fm_lfo=Spec.Osc("sine", 5.0, 0.01)),
                    Spec.Osc("sine", 2.0, amplitude=0.4, bias=0.6)),
        0.05, 4, 0.07, 0.6)
    config4_rtf = patch_rtf(patch4, 1470 * 30, 1470, k_hi=400)
    # config 2: 8-voice FM + harmonics + ADSR bank -> stereo, 2 s
    # (battery twin: config2/fm_bank_8v)
    from synthesizer_tpu.models.voicebank import Voice as BankVoice
    c2_voices = []
    for i in range(8):
        fm = i % 2 == 0
        c2_voices.append(BankVoice(
            wave="harmonics" if i % 4 == 3 else "sine",
            frequency=220.0 * 2 ** (i / 12), amplitude=0.1,
            pan=(i - 3.5) / 4, start=0.01 * i, duration=1.6,
            attack=0.01, decay=0.05, sustain_level=0.7, release=0.1,
            fm_frequency=5.0 if fm else 0.0, fm_depth=0.02 if fm else 0.0,
            harmonics=(1.0, 0.5, 0.33) if i % 4 == 3 else ()))
    config2_rtf, _ = bank_rtf(c2_voices, 2.0, k_hi=512, nh=4, ck=16384)

    # master-fx gates: the gather-free Freeverb comb scan and the
    # row-packed/group-canvas phase-vocoder stretch — same chained-repeat
    # slope methodology over a 20 s stereo programme; scalar reduction
    # keeps the per-call sync payload tiny
    from synthesizer_tpu.ops import effects as dfx
    fx_n = 20 * samplerate
    fx_sig = jnp.asarray(
        ((np.random.default_rng(7).random((fx_n, 2)) * 2 - 1) * 12000)
        .astype(np.int32))

    def fx_rtf(op, k_hi=4):
        # the op keeps [fx_n, 2] int32 shape (tails sliced off), so the
        # k-repeat chain is a scan whose carry IS the audio — inherently
        # data-dependent, no anti-CSE trick needed
        @functools.partial(jax.jit, static_argnames=("k",))
        def rep(frames, k):
            def body(c, _):
                return op(c)[:fx_n], None
            out, _ = jax.lax.scan(body, frames, None, length=k)
            return jnp.sum(jnp.abs(out.astype(jnp.float32)))

        def best(k):
            float(np.asarray(rep(fx_sig, k=k)))             # compile
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                float(np.asarray(rep(fx_sig, k=k)))
                ts.append(time.perf_counter() - t0)
            return min(ts)

        el = slope_fit(best, max(k_hi // 2, 1), k_hi)
        return (fx_n / samplerate) / el

    reverb_rtf = fx_rtf(lambda f: dfx.reverb(
        f, samplerate, 0.85, 0.4, 0.35, 0.6, 1.0, samplerate // 2))
    stretch_rtf = fx_rtf(lambda f: dfx.stretch(f, 1.5))
    chorus_rtf = fx_rtf(lambda f: dfx.chorus(
        f, samplerate, 0.5, 0.002, 0.02, 3, 0.4, 1.0))
    # the windowed-sinc hq resample — ONE strided f32 conv, 44.1k->48k
    # (reduced 160/147), clamped to fx_n output rows so the k-repeat
    # carry keeps a static shape
    from synthesizer_tpu.ops.resample import hq_resample as dhq
    hq_resample_rtf = fx_rtf(lambda f: dhq(f, 160, 147, fx_n), k_hi=8)

    peak = int(np.abs(np.asarray(out)).max())
    print(json.dumps({
        "metric": "realtime_factor_64voice_stereo_mixdown",
        "value": round(rtf, 1),
        "unit": "x_realtime",
        "vs_baseline": round(rtf, 1),
        "voice_msamples_per_sec_per_chip": round(voice_msamples, 1),
        "output_msamples_per_sec_per_chip": round(out_msamples, 2),
        "audio_seconds": duration,
        "render_seconds": round(elapsed, 5),
        "single_call_x_realtime": round(duration / single_call, 1),
        "single_call_seconds": round(single_call, 4),
        "compile_plus_first_run_seconds": round(compile_and_first, 2),
        "nvoices": layout.nvoices,
        "chunk_frames": chunk,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
        "peak_int16": peak,
        "checksum": checksum,
        "config3_wall_x_realtime": round(c3_dur / c3_wall, 1),
        "config3_audio_seconds": round(c3_dur, 2),
        "config3_wall_seconds": round(c3_wall, 4),
        "scale_1024voice_x_realtime": round(scale_rtf, 1),
        "scale_1024voice_voice_msamples": round(scale_vms, 1),
        "long_render_600s_x_realtime": round(long_rtf, 1),
        "config1_rtf": round(config1_rtf, 1),
        "config2_rtf": round(config2_rtf, 1),
        "config4_rtf": round(config4_rtf, 1),
        "reverb_rtf": round(reverb_rtf, 1),
        "stretch_rtf": round(stretch_rtf, 1),
        "chorus_rtf": round(chorus_rtf, 1),
        "hq_resample_rtf": round(hq_resample_rtf, 1),
        "sparse_midi_rtf": round(sparse_midi_rtf, 1),
        "sparse_midi_voices": sparse_v,
        "sparse_midi_bucket_rows": sparse_k,
    }))


if __name__ == "__main__":
    sys.exit(main())
