#!/usr/bin/env python3
"""On-card verification battery: proves the 1-LSB contract on the GPU.

The test suite runs on CPU; this script runs the differential checks
against the real device, where reduced-precision matmuls (TF32), FMA
contraction, reduction order and cuFFT can differ from the CPU backend.

Coverage:
  A. graph engine: every waveform x {plain, FM, ADSR, echo} (+ PWM on
     pulse) vs the host golden oracle,
  B. voice bank: every bank waveform vs the per-voice host oracle, plus
     the glide, pitch/amp/FM-depth curve and sparse-render twins,
  C. all five BASELINE.json benchmark configs rendered on the card and
     differenced against their host oracles,
  D. the effects rack and its streaming twins vs goldref.

    python scripts/chip_verify.py             # on a GPU host
    python scripts/chip_verify.py --allow-cpu --fast   # self-check on CPU

Without ``--allow-cpu`` the script exits 2 unless the device is a GPU.
Prints one PASS/FAIL line per check and exits nonzero on any failure.
"""

import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402

FAILURES = []
#: per-thread time of the previous check: each line shows what its own
#: check cost (compile + render + oracle), sections running concurrently
_LAST = threading.local()


def check(name, ok, detail=""):
    now = time.time()
    dt = now - getattr(_LAST, "t", now)
    _LAST.t = now
    # one write per line: the sections print from concurrent threads
    sys.stdout.write(f"{'PASS' if ok else 'FAIL'}  {name}  {detail}  "
                     f"[{dt:.1f}s]\n")
    sys.stdout.flush()
    if not ok:
        FAILURES.append(name)


def max_lsb(got_f32, want_f32):
    g = np.clip(np.rint(np.asarray(got_f32, np.float64) * 32767), -32768, 32767)
    w = np.clip(np.rint(np.asarray(want_f32, np.float64) * 32767), -32768, 32767)
    return np.abs(g - w)


# -- section A: graph engine per-waveform ------------------------------------

GRAPH_KINDS = ("sine", "triangle", "square", "sawtooth", "pulse",
               "square_h", "sawtooth_h", "harmonics", "white_noise",
               "semicircle", "pointy", "sawtooth_bl", "square_bl",
               "wavetable", "pluck")
#: waveforms with an infinite-slope edge: phase rounding puts isolated
#: samples on the other side of the edge (documented budget, CLAUDE.md)
EDGE_KINDS = {"semicircle", "square", "pulse", "square_bl", "sawtooth",
              "sawtooth_bl", "sawtooth_h", "square_h"}


def section_graph(SR, n, blocksize):
    import goldref.osc as go
    from synthesizer_tpu.models import graph as G
    from synthesizer_tpu.models import spec as S

    def osc(kind, **over):
        kw = dict(amplitude=0.8, phase=0.13, bias=0.01)
        if kind in ("square_h", "sawtooth_h"):
            kw["num_harmonics"] = 8
        if kind == "harmonics":
            kw["harmonics"] = ((1.0, 1.0), (2.0, 0.5), (3.0, 0.25), (5.0, 0.1))
        if kind == "pulse":
            kw["pulse_width"] = 0.3
        if kind == "white_noise":
            kw["seed"] = 42
        if kind == "wavetable":
            rng = np.random.default_rng(7)
            kw["table"] = tuple(float(x) for x in rng.uniform(-1, 1, 64))
        if kind == "pluck":
            kw["num_harmonics"] = 12
            kw["seed"] = 5
        kw.update(over)
        freq = SR if kind == "white_noise" else 440.0
        return S.Osc(kind, freq, **kw)

    def diff(node):
        want = go.render_oracle(node, n, SR)
        got = np.asarray(G.render_patch(node, n, SR, blocksize))
        return max_lsb(got, want)

    for kind in GRAPH_KINDS:
        variants = {"plain": osc(kind)}
        if kind != "white_noise":
            variants["fm"] = osc(kind, fm_lfo=S.Osc("sine", 6.0, 0.015))
        variants["adsr"] = S.Envelope(osc(kind), 0.01, 0.03, 0.08, 0.6, 0.05)
        variants["echo"] = S.Echo(
            S.Envelope(osc(kind), 0.0, 0.0, 0.05, 1.0, 0.01),
            0.02, 3, 0.03, 0.5)
        if kind == "pulse":
            variants["pwm"] = osc(kind, pwm_lfo=S.Osc(
                "sine", 3.0, amplitude=0.2, bias=0.5))
        for vn, node in variants.items():
            d = diff(node)
            if kind in EDGE_KINDS:
                # isolated edge samples may land on the other side of a
                # discontinuity; everything else must hold 1 LSB
                ok = (d > 1).mean() < 2e-3 and d.max() <= 2 * 32767 * 0.82
                detail = f"max {d.max():.0f} LSB, frac>1 {(d > 1).mean():.1e}"
            else:
                ok = d.max() <= 1
                detail = f"max {d.max():.0f} LSB"
            check(f"graph/{kind}/{vn}", ok, detail)


# -- section B: voice bank vs oracle -----------------------------------------

def section_bank(SR, n):
    from synthesizer_tpu.models.voicebank import (Voice, VoiceBank, WAVE_IDS,
                                                  pack_voices)
    sys.path.insert(0, os.path.join(_ROOT, "tests"))
    import test_voicebank as T

    for wave in WAVE_IDS:
        kw = {}
        if wave == "harmonics":
            kw["harmonics"] = (1.0, 0.5, 0.25)
        if wave == "pulse":
            kw["pulse_width"] = 0.3
        if wave == "white_noise":
            kw["seed"] = 7
        if wave == "wavetable":
            rngw = np.random.default_rng(13)
            kw["table"] = tuple(float(x) for x in rngw.uniform(-1, 1, 48))
        if wave == "pluck":
            kw["seed"] = 21
            kw["damping"] = 1.5
        fm_ok = wave in ("sine", "triangle")
        voices = []
        for i in range(4):
            voices.append(Voice(
                wave=wave, frequency=110.0 * (i + 1) * 1.01,
                amplitude=0.15, phase=0.1 * i, pan=(i - 1.5) / 2,
                start=0.002 * i, duration=0.05,
                attack=0.004, decay=0.01, sustain_level=0.7, release=0.02,
                fm_frequency=6.0 if (fm_ok and i % 2) else 0.0,
                fm_depth=0.02 if (fm_ok and i % 2) else 0.0,
                **kw))
        vp, layout = pack_voices(voices, SR, num_harmonics=4, sort_by_wave=True)
        bank = VoiceBank.for_voices(voices, SR, chunk_frames=1024,
                                    num_harmonics=4, layout=layout,
                                    nvoices=layout.nvoices)
        got = np.asarray(bank.render_song(vp, n))
        want = np.zeros((n, 2), np.float32)
        for v in voices:
            want = want + T.oracle_voice(v, n)
        d = max_lsb(got, want)
        tol = 3
        check(f"bank/{wave}/vs_oracle", (d > tol).mean() < 1e-4,
              f"max {d.max():.0f} LSB, frac>tol {(d > tol).mean():.1e}")

    # portamento: the integer-chirp glide phase must match the exact
    # Python-int twin on hardware (the tri(m) halving trick relies on
    # modular int32 multiply semantics — a compiler that widened or
    # reassociated it would break the closed form)
    gv = [Voice(wave="sine", frequency=880.0, glide_from=220.0,
                glide_time=0.05, start=0.01, duration=0.3, amplitude=0.5,
                attack=0.0, decay=0.0, sustain_level=1.0, release=0.01)]
    gvp, glayout = pack_voices(gv, SR, num_harmonics=4, sort_by_wave=True)
    gbank = VoiceBank.for_voices(gv, SR, chunk_frames=1024,
                                 num_harmonics=4, layout=glayout,
                                 nvoices=glayout.nvoices)
    total = int(0.35 * SR)
    gout = np.asarray(gbank.render_song(gvp, total))[:, 0]
    ph = T._glide_phase_twin(880.0, 220.0, 0.05, 0.01, SR, total)
    ref = 0.5 * np.sin(2 * np.pi * ph / 2 ** 32)
    s0 = int(0.01 * SR)
    lo, hi = s0 + 100, s0 + int(0.29 * SR)
    dx = np.max(np.abs(gout[lo:hi] - ref[lo:hi]))
    check("bank/glide/xla_vs_int_twin", dx < 1e-6, f"max {dx:.2e}")

    # glide excludes pluck (its spectral decay is pinned to one pitch):
    # glided pluck == plain pluck bit-exactly
    pv = dict(wave="pluck", frequency=440.0, start=0.005, duration=0.3,
              amplitude=0.5, seed=7)
    pg = [Voice(glide_from=110.0, glide_time=0.05, **pv)]
    pn = [Voice(**pv)]
    pgp, ply = pack_voices(pg, SR, num_harmonics=8, sort_by_wave=True)
    pnp, nly = pack_voices(pn, SR, num_harmonics=8, sort_by_wave=True)
    gb = VoiceBank.for_voices(pg, SR, chunk_frames=1024, num_harmonics=8,
                              layout=ply, nvoices=ply.nvoices)
    nb = VoiceBank.for_voices(pn, SR, chunk_frames=1024, num_harmonics=8,
                              layout=nly, nvoices=nly.nvoices)
    eq_x = np.array_equal(np.asarray(gb.render_song(pgp, 8192)),
                          np.asarray(nb.render_song(pnp, 8192)))
    check("bank/glide/pluck_excluded", eq_x, f"bit-equal {eq_x}")

    # continuous MIDI pitch bend (round 4): piecewise integer chirp
    # segments vs the exact per-frame iterative integer DDS twin — phase
    # exact mod 2^32 on hardware, f32 sine eval is the only error source
    from synthesizer_tpu.models.voicebank import compile_pitch_segments
    curve = ((0.0, 1.0), (0.05, 2.0 ** (2 / 12)), (0.12, 2.0 ** (-1 / 12)))
    cv = [Voice(wave="sine", frequency=440.0, pitch_curve=curve,
                start=0.01, duration=0.3, amplitude=0.5, attack=0.0,
                decay=0.0, sustain_level=1.0, release=0.01)]
    cvp, clayout = pack_voices(cv, SR, num_harmonics=0, sort_by_wave=True)
    cbank = VoiceBank.for_voices(cv, SR, chunk_frames=2048, layout=clayout,
                                 nvoices=clayout.nvoices)
    ctotal = int(0.35 * SR)
    cout = np.asarray(cbank.render_song(cvp, ctotal))[:, 0]
    starts, phases, incs, ds = compile_pitch_segments(curve, 440.0, SR)
    s0 = int(0.01 * SR)
    phi, phs = 0, []
    for m in range(ctotal - s0 + 1):
        phs.append(phi)
        cur = 0
        while cur + 1 < len(starts) and m >= starts[cur + 1]:
            cur += 1
        phi = (phi + incs[cur] + (m - starts[cur]) * ds[cur]) % (2 ** 32)
    lo, hi = s0 + 10, s0 + int(0.29 * SR)
    cref = 0.5 * np.sin(2 * np.pi * np.asarray(
        phs[lo - s0:hi - s0], np.float64) / 2 ** 32)
    dc = np.max(np.abs(cout[lo:hi] - cref))
    check("midi/bend_curve_vs_int_twin", dc < 1e-6, f"max {dc:.2e}")

    # continuous CC7/CC11 amplitude curve vs the f64 linear-ramp twin
    acurve = ((0.0, 1.0), (0.05, 0.2), (0.1, 0.6))
    av = [Voice(wave="sine", frequency=440.0, amp_curve=acurve, start=0.01,
                duration=0.25, amplitude=0.5, attack=0.0, decay=0.0,
                sustain_level=1.0, release=0.01)]
    avp, alayout = pack_voices(av, SR, num_harmonics=0, sort_by_wave=True)
    abank = VoiceBank.for_voices(av, SR, chunk_frames=2048, layout=alayout,
                                 nvoices=alayout.nvoices)
    atotal = int(0.3 * SR)
    aout = np.asarray(abank.render_song(avp, atotal))[:, 0]
    from synthesizer_tpu.models import spec as Spec
    inc = int(Spec.phase_increment(440.0, SR))
    nn = np.arange(atotal, dtype=np.uint64)
    aph = (nn * inc) % 2 ** 32
    mm = np.arange(atotal) - s0
    apts = [(int(t * SR), g) for t, g in acurve]
    gain = np.ones(atotal)
    for j, (f0, g0) in enumerate(apts):
        if j + 1 < len(apts):
            f1, g1 = apts[j + 1]
            sel = (mm >= f0) & (mm < f1)
            gain[sel] = g0 + (mm[sel] - f0) * (g1 - g0) / (f1 - f0)
        else:
            gain[mm >= f0] = g0
    aref = 0.5 * np.sin(2 * np.pi * aph / 2 ** 32) * gain
    alo, ahi = s0 + 10, s0 + int(0.24 * SR)
    da = max_lsb(aout[alo:ahi], aref[alo:ahi]).max()
    check("midi/amp_curve_vs_f64_twin", da <= 1, f"max {da:.0f} LSB")

    # CC1 mod-wheel vibrato (round-4 continuation): the per-segment
    # weighted-trig-sum closed form (time-varying FM depth) vs the f64
    # per-frame accumulation twin — budget ~0.2 LSB at full scale, so
    # 8e-6 at amp 0.5 (the trig-poly error composition derived in
    # models/voicebank._dmod_delta)
    dcurve = ((0.0, 0.0), (0.04, 0.02), (0.1, 0.005), (0.18, 0.029))
    dv = [Voice(wave="sine", frequency=440.0, fm_frequency=5.5,
                fm_depth_curve=dcurve, start=0.01, duration=0.25,
                amplitude=0.5, attack=0.0, decay=0.0, sustain_level=1.0,
                release=0.01)]
    dvp, dlayout = pack_voices(dv, SR, num_harmonics=0, sort_by_wave=True)
    dbank = VoiceBank.for_voices(dv, SR, chunk_frames=2048, layout=dlayout,
                                 nvoices=dlayout.nvoices)
    dtotal = int(0.3 * SR)
    dout = np.asarray(dbank.render_song(dvp, dtotal))[:, 0]
    fm_inc = int(Spec.phase_increment(5.5, SR))
    dpts = [(int(t * SR), d) for t, d in dcurve]

    def _depth_at(u):
        for j in range(len(dpts) - 1):
            if u < dpts[j + 1][0]:
                f0, d0 = dpts[j]
                f1, d1 = dpts[j + 1]
                return d0 + (d1 - d0) * (u - f0) / (f1 - f0)
        return dpts[-1][1]

    dhi = s0 + int(0.24 * SR)
    dref = np.zeros(dtotal)
    acc = 0.0
    for n_ in range(s0, dhi):
        m = n_ - s0
        p = ((n_ * inc) % 2 ** 32 + inc * acc) / 2 ** 32
        dref[n_] = 0.5 * np.sin(2 * np.pi * (p % 1.0))
        lfo = ((s0 + m) * fm_inc) % 2 ** 32
        acc += _depth_at(m) * np.sin(2 * np.pi * lfo / 2 ** 32)
    dd = np.max(np.abs(dout[s0 + 1:dhi] - dref[s0 + 1:dhi]))
    check("midi/vibrato_cc1_vs_f64_twin", dd < 8e-6, f"max {dd:.2e}")

    # channel-pressure aftertouch (round 5): a pressure-sweep SMF must
    # take the SAME depth-curve engine end to end (parse -> merge-by-max
    # -> fm_depth_curve -> closed form); rendered against the f64 twin
    # with the curve taken from the materialized voice
    from synthesizer_tpu.midi import (VIBRATO_RATE_HZ, MidiNote,
                                      midi_to_voices, parse_midi,
                                      render_notes, write_midi)
    from synthesizer_tpu.sequencer import SynthDef
    psd = SynthDef(wave="sine", amplitude=0.5, attack=0.0, decay=0.0,
                   sustain_level=1.0, release=0.01)
    pdata = write_midi([MidiNote(0.01, 0.28, 69, 127, 0)],
                       pressures=[(0.05, 0, 20), (0.15, 0, 100),
                                  (0.25, 0, 127)])
    pnotes = parse_midi(pdata)
    pv = midi_to_voices(pnotes, instruments={0: psd})[0]
    psmp = render_notes(pnotes, instruments={0: psd}, samplerate=SR)
    pout = np.frombuffer(psmp.view_frame_data(), np.int16)
    pout = pout.reshape(-1, 2)[:, 0].astype(np.float64) / 32767.0
    ps0 = int(pv.start * SR)
    pfm_inc = int(Spec.phase_increment(VIBRATO_RATE_HZ, SR))
    ppts = [(int(t * SR), d) for t, d in pv.fm_depth_curve]

    def _pdepth(u):
        if u <= ppts[0][0]:
            return ppts[0][1]
        for j in range(len(ppts) - 1):
            if u < ppts[j + 1][0]:
                f0, d0 = ppts[j]
                f1, d1 = ppts[j + 1]
                return d0 + (d1 - d0) * (u - f0) / (f1 - f0)
        return ppts[-1][1]

    phi = ps0 + int(0.26 * SR)
    pref = np.zeros(phi)
    acc = 0.0
    for n_ in range(ps0, phi):
        m = n_ - ps0
        p = ((n_ * inc) % 2 ** 32 + inc * acc) / 2 ** 32
        pref[n_] = 0.5 * np.sin(2 * np.pi * (p % 1.0))
        lfo = (n_ * pfm_inc) % 2 ** 32
        acc += _pdepth(m) * np.sin(2 * np.pi * lfo / 2 ** 32)
    pdd = np.max(np.abs(pout[ps0 + 1:phi] - pref[ps0 + 1:phi]))
    check("midi/aftertouch_pressure_vs_f64_twin",
          pdd < 8e-6 + 0.5 / 32767.0, f"max {pdd:.2e}")

    # sparse bucketed song render (round 5): per-chunk active-voice
    # gathers + sentinel pad row vs the flat grouped render — the ONLY
    # difference is the [K,2]-vs-[V,2] pan matmul reduction tree, so on
    # hardware the int16 outputs must agree within 1 LSB (and the pan
    # matmul must stay at HIGHEST precision, not TF32, through the
    # gathered path)
    from synthesizer_tpu.models.voicebank import (Voice as BankVoice,
                                                  VoiceBank, pack_voices)
    sprng = np.random.default_rng(11)
    spv = []
    st = 0.0
    for i in range(48):
        st += float(sprng.uniform(0.02, 0.25))
        spv.append(BankVoice(
            wave=("sine", "sawtooth_bl", "harmonics")[i % 3],
            frequency=float(sprng.uniform(100, 1500)),
            amplitude=float(sprng.uniform(0.05, 0.2)),
            pan=float(sprng.uniform(-1, 1)), start=round(st, 3),
            duration=float(sprng.uniform(0.05, 0.4)), attack=0.005,
            decay=0.05, sustain_level=0.7, release=0.1,
            harmonics=(1.0, 0.5, 0.25) if i % 3 == 2 else ()))
    svp, sly = pack_voices(spv, SR, num_harmonics=8, sort_by_wave=True)
    sbank = VoiceBank.for_voices(spv, SR, num_harmonics=8,
                                 chunk_frames=4096, layout=sly,
                                 nvoices=sly.nvoices)
    stot = int((st + 1.0) * SR)
    # the comparison is vacuous if the cost model routed back to flat —
    # prove the bucketed program actually ran
    splan = sbank.sparse_plan(svp, stot)
    sflat = np.asarray(sbank.to_int16(sbank.render_song(svp, stot)))
    ssp = np.asarray(sbank.to_int16(sbank.render_song_sparse(svp, stot)))
    sd = int(np.abs(sflat.astype(np.int32) - ssp.astype(np.int32)).max())
    check("bank/sparse_bucketed_vs_flat", splan is not None and sd <= 1
          and int(np.abs(sflat).max()) > 1000,
          f"max {sd} LSB (budget 1), K={0 if splan is None else splan[1].shape[1]}")



# -- section C: the five BASELINE configs -------------------------------------

def section_configs(SR):
    import goldref.osc as go
    import goldref.sample as gs
    from synthesizer_tpu import Sample, WaveSynth
    from synthesizer_tpu.models import graph as G
    from synthesizer_tpu.models import spec as S
    from synthesizer_tpu.models.voicebank import VoiceBank, pack_voices
    from synthesizer_tpu.sequencer import Song, SynthDef
    sys.path.insert(0, os.path.join(_ROOT, "tests"))
    import test_voicebank as T

    # biquad filters (beyond-reference): parallel-scan IIR vs the
    # sequential f64 oracle — reduced-precision 2x2 companion products
    # (bf16 or TF32) would show here first
    fsrc = S.Osc("sawtooth", 330.0, 0.8)
    for kind, fc, q, tol in [("lowpass", 1000.0, 0.7071, 2),
                             ("lowpass", 500.0, 8.0, 24),
                             ("highpass", 300.0, 0.7071, 16),
                             ("bandpass", 800.0, 4.0, 3)]:
        fnode = S.Biquad(fsrc, kind, fc, q)
        want = go.render_oracle(fnode, SR // 4, SR)
        got = np.asarray(G.render_patch(fnode, SR // 4, SR, 2048))
        d = max_lsb(got, want)
        check(f"filter/{kind}_q{q}", d.max() <= tol, f"max {d.max():.0f} LSB")
    swept = S.Biquad(fsrc, "lowpass", 800.0, 1.0,
                     cutoff_lfo=S.Osc("sine", 0.5, amplitude=2.0))
    want = go.render_oracle(swept, SR // 4, SR)
    got = np.asarray(G.render_patch(swept, SR // 4, SR, 2048))
    d = max_lsb(got, want)
    check("filter/lowpass_swept", d.max() <= 6, f"max {d.max():.0f} LSB")

    # config 1: 2 s 440 Hz sine -> 16-bit mono
    node = S.Osc("sine", 440.0, 0.9999)
    want = go.to_int_samples(go.render_oracle(node, 2 * SR, SR), 2)
    got = np.asarray(G.to_int_device(G.render_patch(node, 2 * SR, SR, 32768), 2))
    d = np.abs(got.astype(np.int64) - want.astype(np.int64)).max()
    check("config1/sine_2s", d <= 1, f"max {d} LSB")

    # config 2: 8-voice FM + harmonics + ADSR bank -> stereo
    from synthesizer_tpu.models.voicebank import Voice
    voices = []
    for i in range(8):
        fm = i % 2 == 0
        voices.append(Voice(
            wave="harmonics" if i % 4 == 3 else "sine",
            frequency=220.0 * 2 ** (i / 12), amplitude=0.1,
            pan=(i - 3.5) / 4, start=0.01 * i, duration=0.4,
            attack=0.01, decay=0.05, sustain_level=0.7, release=0.1,
            fm_frequency=5.0 if fm else 0.0, fm_depth=0.02 if fm else 0.0,
            harmonics=(1.0, 0.5, 0.33) if i % 4 == 3 else ()))
    n = SR // 2
    vp, layout = pack_voices(voices, SR, num_harmonics=4, sort_by_wave=True)
    bank = VoiceBank.for_voices(voices, SR, chunk_frames=4096,
                                num_harmonics=4, layout=layout,
                                nvoices=layout.nvoices)
    got = np.asarray(bank.render_song(vp, n))
    want = np.zeros((n, 2), np.float32)
    for v in voices:
        want = want + T.oracle_voice(v, n)
    d = max_lsb(got, want)
    check("config2/fm_bank_8v", (d > 3).mean() < 1e-4,
          f"max {d.max():.0f} LSB, frac>3 {(d > 3).mean():.1e}")

    # config 3: 16-track Sample-op mixdown vs goldref per-hit loop
    synth = WaveSynth(samplerate=22050, samplewidth=2)
    total = Sample.from_raw_frames(b"", 2, SR, 2)
    gtotal = gs.Sample(np.zeros((0, 2), np.int16), SR, 2, 2)
    for t in range(16):
        nd = S.Osc("sine", 100.0 + 50 * t, 0.4)
        s = synth.sine(100.0 + 50 * t, 0.25, amplitude=0.4)
        s.resample(SR).amplify(0.5 + 0.02 * t).fadein(0.02).fadeout(0.05).stereo()
        total.mix_at(0.05 * t, s)
        ga = go.to_int_samples(go.render_oracle(nd, int(0.25 * 22050), 22050), 2)
        g = gs.Sample(ga[:, None], 22050, 2, 1)
        g.resample(SR).amplify(0.5 + 0.02 * t).fadein(0.02).fadeout(0.05).stereo()
        gtotal.mix_at(0.05 * t, g)
    d = np.abs(total.get_frame_array().astype(np.int64)
               - gtotal.frames.astype(np.int64)).max()
    check("config3/16track_mixdown", d <= 2, f"max {d} LSB")

    # config 4: LFO-modulated graph + echo at streaming chunk size
    patch = S.Echo(S.AmpMod(S.Osc("sawtooth", 330.0, 0.7,
                                  fm_lfo=S.Osc("sine", 5.0, 0.01)),
                            S.Osc("sine", 2.0, amplitude=0.4, bias=0.6)),
                   0.05, 4, 0.07, 0.6)
    n4 = 1470 * 30
    want = go.render_oracle(patch, n4, SR)
    got = np.asarray(G.render_patch(patch, n4, SR, 1470))
    d = max_lsb(got, want)
    check("config4/lfo_echo_chunks", (d > 1).mean() < 2e-3 and d.max() <= 3,
          f"max {d.max():.0f} LSB, frac>1 {(d > 1).mean():.1e}")
    # chunk invariance on-chip: 1470-frame blocks == one whole render
    whole = np.asarray(G.render_patch(patch, n4, SR, 32768))
    check("config4/chunk_invariance", np.allclose(got, whole, atol=0),
          "1470-frame scan == 32768-frame scan bit-exact"
          if np.array_equal(got, whole) else "DIFFERS")

    # config 5: pattern-sequencer song, offline batched render vs goldref
    # per-hit loop, and streaming chunks == offline slice (on-chip)
    ws = WaveSynth(samplerate=SR, samplewidth=2)
    kick = ws.sine(60, 0.1, amplitude=0.8).fadeout(0.08).stereo()
    hat = ws.white_noise(duration=0.04, amplitude=0.4, seed=5).fadeout(0.03).stereo()
    song = Song()
    song.bpm = 240
    song.ticks = 4
    song.add_instrument("kick", kick)
    song.add_instrument("hat", hat)
    song.add_synth("lead", SynthDef(wave="square_bl", amplitude=0.2,
                                    release=0.05))
    song.add_pattern("a", {"kick": "x... x...", "hat": "x.x. x.x.",
                           "lead": "C4 .. E4 .. G4 .. C5 .."})
    song.pattern_sequence = ["a", "a"]
    offline = song.mix(normalize=False)
    off = offline.get_frame_array()
    sched = song.compile_schedule()
    # per-hit oracle loop at exact FRAME offsets (never round-trip frames
    # through seconds — float division loses frames, CLAUDE.md)
    gout = np.zeros((off.shape[0], 2), np.int64)
    for inst_i, start in sched.hits:
        arr = song.instruments[sched.instruments[inst_i]].get_frame_array()
        m = min(len(arr), len(gout) - start)
        gout[start:start + m] += arr[:m].astype(np.int64)
    gout = np.clip(gout, -2**31, 2**31 - 1)  # widened int32 domain
    # synth voices: device render is the pinned engine; drums must match
    import jax.numpy as jnp
    from synthesizer_tpu.sequencer import _mixdown_kernel
    drums_dev = np.asarray(jnp.clip(_mixdown_kernel(
        jnp.asarray(sched.bank),
        jnp.asarray(sched.hits[:, 0].astype(np.int32)),
        jnp.asarray(sched.hits[:, 1].astype(np.int32)),
        off.shape[0]), -32768, 32767))
    d = np.abs(drums_dev.astype(np.int64) - np.clip(gout, -32768, 32767)).max()
    check("config5/drum_scatter_vs_oracle", d == 0, f"max {d} LSB (int exact)")
    chunks = [c.get_frame_array() for c in song.mix_generator(chunk_frames=1470)]
    got_stream = np.concatenate(chunks)
    check("config5/streaming_equals_offline",
          np.array_equal(got_stream, off[:len(got_stream)]),
          f"{len(chunks)} chunks")


def _fx_inputs(SR):
    """The effects sections' seeded test signals, drawn in one fixed order
    from one generator: a (4000 frames), ab (1 s), ir (300-tap impulse
    response), xr (full-range int32)."""
    rng = np.random.default_rng(0xFACADE)
    a = rng.integers(-15000, 15000, size=(4000, 2)).astype(np.int16)
    ab = rng.integers(-15000, 15000, size=(SR, 2)).astype(np.int16)
    ir = (rng.normal(0, 0.2, size=300)
          * np.exp(-np.arange(300) / 75.0) * 20000).astype(np.int16)[:, None]
    xr = rng.integers(-2**31, 2**31, size=(400, 2),
                      dtype=np.int64).astype(np.int32)
    return a, ab, ir, xr


def _fx_pair(a, SR):
    import goldref.sample as gs
    from synthesizer_tpu.sample import Sample
    return (gs.Sample(a.copy(), SR, 2, 2),
            Sample.from_raw_frames(a.tobytes(), 2, SR, 2))


def section_effects_a(SR, a, ab, ir, xr):
    """Effects rack on the card, part A: dynamics, reverb, hq resampling, chorus, convolution, filter, gate — device twins vs
    goldref.effects with the budgets documented there (the scans and
    cuFFT paths have no CPU-suite coverage on the real backend)."""
    import jax.numpy as jnp
    import goldref.effects as _gfx
    import goldref.sample as gs
    from synthesizer_tpu import WaveSynth
    from synthesizer_tpu.sample import Sample
    from synthesizer_tpu.sequencer import Song, SynthDef
    ws = WaveSynth(samplerate=SR, samplewidth=2)

    gold, dev = _fx_pair(a, SR)
    kw = dict(threshold_db=-15.0, ratio=4.0, attack=0.003, release=0.08,
              makeup_db=2.0)
    d = np.abs(dev.compress(**kw).get_frame_array().astype(np.int64)
               - gold.compress(**kw).frames.astype(np.int64)).max()
    check("fx/compress", d <= 2, f"max {d} LSB")

    # soft knee: a level ramp THROUGH the knee region (the random _fx_pair(a, SR)
    # signal pegs the detector above it, where soft == hard)
    ramp_amp = 10 ** (np.linspace(-40, -2, 8000) / 20.0)
    ramp = (np.sin(2 * np.pi * 220 * np.arange(8000) / SR)
            * ramp_amp * 32767.0).astype(np.int16)
    ramp2 = np.stack([ramp, ramp], axis=1)
    kw = dict(threshold_db=-15.0, ratio=4.0, attack=0.003, release=0.08,
              knee_db=12.0)
    gk = gs.Sample(ramp2.copy(), SR, 2, 2).compress(**kw).frames
    dk = Sample.from_raw_frames(ramp2.tobytes(), 2, SR, 2) \
        .compress(**kw).get_frame_array()
    d = np.abs(dk.astype(np.int64) - gk.astype(np.int64)).max()
    check("fx/compress_soft_knee", d <= 2, f"max {d} LSB")

    gold, dev = _fx_pair(a, SR)
    kw = dict(roomsize=0.8, damping=0.4, wet=0.3, dry=0.6, tail=0.1)
    d = np.abs(dev.reverb(**kw).get_frame_array().astype(np.int64)
               - gold.reverb(**kw).frames.astype(np.int64)).max()
    check("fx/reverb", d <= 4, f"max {d} LSB")

    # hq polyphase resampler: ONE strided f32 conv (precision=HIGHEST —
    # a TF32 conv is exactly the true-peak bug class this battery exists
    # to catch) vs the f64 oracle, up and down
    for outr in (48000, 8000):
        gold, dev = _fx_pair(a, SR)
        d = np.abs(dev.resample(outr, quality="hq").get_frame_array()
                   .astype(np.int64)
                   - gold.resample(outr, quality="hq").frames
                   .astype(np.int64)).max()
        check(f"fx/hq_resample_{outr}", d <= 1, f"max {d} LSB")

    # the streaming hq twin must be BIT-IDENTICAL to the offline conv at
    # any chunking (round-5 HQ_STREAM_BLOCK padding keeps the streaming
    # conv out of the tiny-spatial regime where the backend regroups the
    # window reduction) — proven here ON THE CHIP for the worst measured
    # regime (heavy downsample) at a small and a practical chunk size
    import math as _math

    import jax.numpy as jnp

    from synthesizer_tpu.ops import resample as _dres
    rng_s = np.random.default_rng(23)
    xs = rng_s.integers(-32768, 32768, size=(882, 2)).astype(np.int16)
    g_ = _math.gcd(SR, 8000)
    Ls, Ms = 8000 // g_, SR // g_
    off_ = np.asarray(_dres.hq_resample(
        jnp.asarray(xs), Ls, Ms, _dres.nframes_out(len(xs), Ms, Ls)))
    for ck in (21, 441):
        rs_ = _dres.StreamingHQResampler(SR, 8000, nchannels=2)
        outs_ = []
        for i0 in range(0, len(xs), ck):
            y_, c_ = rs_.push(jnp.asarray(xs[i0:i0 + ck]))
            if c_:
                outs_.append(np.asarray(y_))
        y_, c_ = rs_.flush()
        if c_:
            outs_.append(np.asarray(y_))
        got_ = np.concatenate(outs_)
        check(f"fx/hq_stream_bitexact_chunk{ck}",
              got_.shape == off_.shape and np.array_equal(got_, off_),
              f"{got_.shape[0]} rows vs offline")

    gold, dev = _fx_pair(a, SR)
    kw = dict(rate=1.5, depth=0.003, delay=0.015)
    d = np.abs(dev.chorus(**kw).get_frame_array().astype(np.int64)
               - gold.chorus(**kw).frames.astype(np.int64)).max()
    check("fx/chorus", d <= 2, f"max {d} LSB")

    # banded chorus: inputs >= 16384 frames route to the
    # host-block-planned banded form (ops.coeffs.chorus_block_plan).  Prove ON CHIP that the banded
    # program is bit-compatible with the pair-gather form (the identical
    # two-term f32 lerp must survive XLA's GPU lowering of both shapes)
    # and holds the same goldref budget.
    from synthesizer_tpu.ops import effects as _dfx
    kwb = dict(rate=1.5, depth=0.003, delay=0.015, voices=3,
               wet=0.4, dry=1.0)
    banded = np.asarray(_dfx.chorus(jnp.asarray(ab), SR, **kwb))
    gathered = np.asarray(_dfx.to_int_samples(_dfx.chorus_core(
        _dfx._norm(jnp.asarray(ab)), jnp.int32(0),
        jnp.zeros((0, 2), jnp.float32), SR, kwb["rate"], kwb["depth"],
        kwb["delay"], kwb["voices"], kwb["wet"], kwb["dry"]), 2))
    dvb = np.abs(banded.astype(np.int64) - gathered.astype(np.int64)).max()
    check("fx/chorus_banded_vs_gather", dvb == 0, f"max {dvb} LSB (1 s)")
    gref = gs.Sample(ab.copy(), SR, 2, 2).chorus(**kwb).frames
    dgb = np.abs(banded.astype(np.int64) - gref.astype(np.int64)).max()
    check("fx/chorus_banded_vs_oracle", dgb <= 2, f"max {dgb} LSB")

    gold, dev = _fx_pair(a, SR)
    gir = gs.Sample(ir.copy(), SR, 2, 1)
    dir_ = Sample.from_raw_frames(ir.tobytes(), 2, SR, 1)
    g = gold.convolve(gir, wet=0.05, dry=0.5)
    d = np.abs(dev.convolve(dir_, wet=0.05, dry=0.5).get_frame_array()
               .astype(np.int64) - g.frames.astype(np.int64)).max()
    budget = max(8, 1e-4 * np.abs(g.frames).max())
    check("fx/convolve_fft", d <= budget, f"max {d} LSB (budget {budget:.0f})")

    gold, dev = _fx_pair(a, SR)
    d = np.abs(dev.filter("lowpass", 900.0, q=2.0).get_frame_array()
               .astype(np.int64)
               - gold.filter("lowpass", 900.0, q=2.0).frames
               .astype(np.int64)).max()
    check("fx/sample_filter", d <= 4, f"max {d} LSB")

    gold, dev = _fx_pair(a, SR)
    kw = dict(threshold_db=-25.0, range_db=60.0, attack=0.001, release=0.02)
    d = np.abs(dev.gate(**kw).get_frame_array().astype(np.int64)
               - gold.gate(**kw).frames.astype(np.int64)).max()
    check("fx/gate", d <= 2, f"max {d} LSB")


def section_effects_b(SR, a, ab, ir, xr):
    """Effects rack on the card, part B: EQ, loudness, stretch, master and synth-track chains streaming vs offline — device twins vs
    goldref.effects with the budgets documented there (the scans and
    cuFFT paths have no CPU-suite coverage on the real backend)."""
    import jax.numpy as jnp
    import goldref.effects as _gfx
    import goldref.sample as gs
    from synthesizer_tpu import WaveSynth
    from synthesizer_tpu.sample import Sample
    from synthesizer_tpu.sequencer import Song, SynthDef
    ws = WaveSynth(samplerate=SR, samplewidth=2)

    # parametric EQ (shelving/peaking): the low shelf and mid bands
    # route through the compensated float-float scan (was budget 96 on
    # the plain scan — the 120 Hz shelf conditioning), so the whole
    # chain now tracks the f64 oracle to a few LSB
    gold, dev = _fx_pair(a, SR)
    kw = dict(low_db=4.0, mid_db=-6.0, high_db=3.0, mid_freq=900.0,
              mid_q=1.4)
    d = np.abs(dev.eq(**kw).get_frame_array().astype(np.int64)
               - gold.eq(**kw).frames.astype(np.int64)).max()
    check("fx/eq_three_band", d <= 8, f"max {d} LSB (ff scan)")

    # BS.1770 loudness + true peak: the EBU 3341 anchor (a -23 dBFS
    # stereo 997 Hz sine reads -23 LUFS) and the f64 oracle, on chip
    t = np.arange(SR)
    # NB: own name — `a` is the fx test signal the recurrence-automation
    # checks below slice (shadowing it broke them silently once)
    tone23 = np.rint(10 ** (-23 / 20) * 32767.0
                     * np.sin(2 * np.pi * 997.0 / SR * t)).astype(np.int16)
    st = np.repeat(tone23[:, None], 2, 1)
    dev = Sample.from_raw_frames(st.tobytes(), 2, SR, 2)
    gold = gs.Sample(st.copy(), SR, 2, 2)
    li, lg = dev.loudness_lufs(), gold.loudness_lufs()
    tp, tg = dev.true_peak_dbtp(), gold.true_peak_dbtp()
    check("fx/loudness_lufs", abs(li + 23.0) < 0.1 and abs(li - lg) < 0.01,
          f"dev {li:.3f} LUFS oracle {lg:.3f}")
    check("fx/true_peak", abs(tp - tg) < 0.01,
          f"dev {tp:.3f} dBTP oracle {tg:.3f}")

    # LIVE loudness meter: chunk-fed StreamingLoudness == the one-program
    # whole-signal loudness_stats, on chip (carried K-weight biquad state
    # across chunk boundaries is the thing only hardware can disprove)
    import jax.numpy as _jnp
    from synthesizer_tpu.ops.loudness import StreamingLoudness
    sl = StreamingLoudness(SR, 2)
    for i in range(0, len(st), 4410):
        sl.update(_jnp.asarray(st[i:i + 4410]))
    live = sl.stats()
    whole = dev.loudness_stats()
    dmom = abs(live["momentary_max"] - whole["momentary_max"])
    dint = abs(live["integrated"] - whole["integrated"])
    check("fx/live_loudness_meter", dmom < 0.02 and dint < 0.02,
          f"Mmax live {live['momentary_max']:.3f} whole "
          f"{whole['momentary_max']:.3f}, I live {live['integrated']:.3f} "
          f"whole {whole['integrated']:.3f}")

    # phase-vocoder stretch: batched on-chip FFT + phase cumsum vs the
    # f64 host oracle (the FFT path has no other on-hardware coverage)
    t = np.arange(9000) / SR
    tone = np.clip(np.rint((0.4 * np.sin(2 * np.pi * 440 * t)
                            + 0.25 * np.sin(2 * np.pi * 661 * t)) * 32767),
                   -32768, 32767).astype(np.int16)[:, None]
    gold = gs.Sample(tone.copy(), SR, 2, 1)
    dev = Sample.from_raw_frames(tone.tobytes(), 2, SR, 1)
    g = gold.stretch(1.5, frame=1024, hop=256)
    d = np.abs(dev.stretch(1.5, frame=1024, hop=256).get_frame_array()
               .astype(np.int64) - g.frames.astype(np.int64)).max()
    check("fx/stretch_pv", d <= 64, f"max {d} LSB (budget 64)")

    # master [fx] chain: streaming chunk processors == offline fused ops
    ws = WaveSynth(samplerate=SR, samplewidth=2)
    song = Song()
    song.bpm = 240
    song.ticks = 4
    song.add_instrument("kick", ws.sine(60, 0.1, amplitude=0.8)
                        .fadeout(0.08).stereo())
    song.add_pattern("a", {"kick": "x.x. x..."})
    song.pattern_sequence = ["a", "a"]
    song.add_fx("chorus", rate=2.0, depth=0.002, delay=0.012, wet=0.4)
    song.add_fx("compress", threshold_db=-15.0, ratio=4.0, attack=0.002,
                release=0.05)
    song.add_fx("reverb", roomsize=0.7, wet=0.3, dry=0.7, tail=0.15)
    offline = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=1470)])
    d = np.abs(got.astype(np.int64) - offline.astype(np.int64)).max()
    check("fx/chain_stream_eq_offline", len(got) == len(offline) and d <= 8,
          f"max {d} LSB over {len(got)} frames")

    # per-SYNTH-track fx: the grouped bank's segment-scatter matmul
    # must hold the f32 contract, and the track chain must agree between
    # the offline bus and the streaming per-chunk processors
    from synthesizer_tpu.sequencer import SynthDef
    song2 = Song()
    song2.bpm = 240
    song2.ticks = 4
    song2.add_synth("lead", SynthDef(wave="square_bl", amplitude=0.25,
                                     attack=0.005, release=0.05, pan=0.2))
    song2.add_synth("pad", SynthDef(wave="sine", amplitude=0.2,
                                    attack=0.02, release=0.1, pan=-0.3))
    song2.add_instrument("kick", ws.sine(60, 0.1, amplitude=0.5)
                         .fadeout(0.06).stereo())
    song2.add_pattern("a", {"lead": "C4 .. E4 G4 - .. C5 ..",
                            "pad": "C3 - - - G2 - - -",
                            "kick": "x.x.x.x."})
    song2.pattern_sequence = ["a", "a"]
    song2.add_track_fx("lead", [("compress",
                                 "threshold_db=-18 ratio=4"),
                                ("reverb",
                                 "roomsize=0.6 wet=0.3 dry=0.7 tail=0.15")])
    off2 = song2.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got2 = np.concatenate([c.get_frame_array()
                           for c in song2.mix_generator(chunk_frames=1470)])
    d2 = np.abs(got2.astype(np.int64) - off2.astype(np.int64)).max()
    check("fx/synth_track_stream_eq_offline",
          len(got2) == len(off2) and d2 <= 8,
          f"max {d2} LSB over {len(got2)} frames")


def section_effects_c(SR, a, ab, ir, xr):
    """Effects rack on the card, part C: echo, width, limiter, phaser (swept and float-float), LFO gain fx, automation, sampler tracks — device twins vs
    goldref.effects with the budgets documented there (the scans and
    cuFFT paths have no CPU-suite coverage on the real backend)."""
    import jax.numpy as jnp
    import goldref.effects as _gfx
    import goldref.sample as gs
    from synthesizer_tpu import WaveSynth
    from synthesizer_tpu.sample import Sample
    from synthesizer_tpu.sequencer import Song, SynthDef
    ws = WaveSynth(samplerate=SR, samplewidth=2)

    # round-3 continuation strip: feedback echo (blocked lax.scan), stereo
    # width, lookahead limiter (reduce_window + decaying-max scan), and the
    # swept-allpass phaser (companion scans over host DDS grids) — each vs
    # its goldref oracle ON THE CHIP, plus the chained master agreement
    gold, dev = _fx_pair(a, SR)
    kw = dict(delay=0.02, feedback=0.55, wet=0.6, dry=0.9)
    d = np.abs(dev.feedback_echo(**kw).get_frame_array().astype(np.int64)
               - gold.feedback_echo(**kw).frames.astype(np.int64)).max()
    check("fx/feedback_echo", d <= 1, f"max {d} LSB")

    gold, dev = _fx_pair(a, SR)
    d = np.abs(dev.stereo_width(1.7).get_frame_array().astype(np.int64)
               - gold.stereo_width(1.7).frames.astype(np.int64)).max()
    check("fx/stereo_width", d <= 1, f"max {d} LSB")

    gold, dev = _fx_pair(a, SR)
    kw = dict(ceiling_db=-6.0, release=0.05, lookahead=0.003)
    d = np.abs(dev.limit(**kw).get_frame_array().astype(np.int64)
               - gold.limit(**kw).frames.astype(np.int64)).max()
    from synthesizer_tpu.ops.coeffs import limiter_ceiling
    peak = np.abs(dev.get_frame_array().astype(np.int64)).max()
    check("fx/limiter", d <= 2 and peak <= limiter_ceiling(-6.0, 2),
          f"max {d} LSB, peak {peak}")

    gold, dev = _fx_pair(a, SR)
    kw = dict(rate=0.8, depth=1.0, min_freq=300.0, max_freq=3000.0,
              stages=4)
    d = np.abs(dev.phaser(**kw).get_frame_array().astype(np.int64)
               - gold.phaser(**kw).frames.astype(np.int64)).max()
    check("fx/phaser", d <= 10, f"max {d} LSB (budget 2+2*stages)")

    gold, dev = _fx_pair(a, SR)
    kw = dict(rate=0.8, depth=1.0, min_freq=60.0, max_freq=2000.0,
              stages=4, q=1.0)
    d = np.abs(dev.phaser(**kw).get_frame_array().astype(np.int64)
               - gold.phaser(grids_dtype=np.float64, **kw).frames
               .astype(np.int64)).max()
    check("fx/phaser_ff_low_floor", d <= 2, f"max {d} LSB (ff scan)")

    # rate/depth-swept phaser (fx.phaser.rate/.depth): host-mirrored
    # cumulative u32 phase + per-frame depth grid vs the per-sample oracle
    import jax.numpy as jnp
    from synthesizer_tpu.effects import StreamingPhaser
    from synthesizer_tpu.ops.coeffs import (chorus_inc_grid,
                                            chorus_phase_grid, curve_grid)
    gold, dev = _fx_pair(a, SR)
    x = dev.get_frame_array()
    npts = len(x)
    tickf = SR / 8.0
    rate_c = [(0.0, 0.3), (8.0, 5.0)]
    depth_c = [(0.0, 0.2), (8.0, 1.0)]
    kw = dict(rate=0.5, depth=1.0, min_freq=300.0, max_freq=3000.0,
              stages=3, q=0.7071, wet=0.6, dry=0.9)
    proc = StreamingPhaser(SR, 2, rate_curve=rate_c, depth_curve=depth_c,
                           tickf=tickf, **kw)
    got = np.asarray(proc.process(jnp.asarray(x)))
    inc = chorus_inc_grid(curve_grid(rate_c, 0, npts, tickf), SR)
    P, _ = chorus_phase_grid(inc, 0)
    dg = curve_grid(depth_c, 0, npts, tickf)
    import goldref.effects as _gfx
    want = _gfx.phaser(x, 2, SR, P=P, depth_curve=dg, **kw)
    d = np.abs(got.astype(np.int64) - want.astype(np.int64)).max()
    check("fx/phaser_rate_depth_swept", d <= 8, f"max {d} LSB")

    # release-swept limiter (fx.limiter.release): per-element decay
    # coefficients through the decaying-max scan vs the oracle
    from synthesizer_tpu.effects import StreamingLimiter
    gold, dev = _fx_pair(a, SR)
    x = dev.get_frame_array()
    rel_c = [(0.0, 0.004), (8.0, 0.4)]
    Lh = max(1, int(0.003 * SR))
    proc = StreamingLimiter(SR, 2, ceiling_db=-6.0, lookahead=0.003,
                            release_curve=rel_c, tickf=tickf)
    fed = np.concatenate([x, np.zeros((Lh, 2), x.dtype)])
    got = np.asarray(proc.process(jnp.asarray(fed)))
    rel = curve_grid(rel_c, 0, len(x), tickf)
    want = _gfx.limiter(x, 2, SR, ceiling_db=-6.0, release=rel,
                        lookahead=0.003)
    d = np.abs(got.astype(np.int64) - want.astype(np.int64)).max()
    check("fx/limiter_release_swept", d <= 2, f"max {d} LSB")

    # LFO gain fx (tremolo/autopan): host grids through the house gain
    # rule — must be BIT-exact on chip (same grid arrays both sides)
    gold, dev = _fx_pair(a, SR)
    kw = dict(rate=5.0, depth=0.7)
    eq = np.array_equal(dev.tremolo(**kw).get_frame_array(),
                        gold.tremolo(**kw).frames)
    check("fx/tremolo", eq, "bit-exact")
    gold, dev = _fx_pair(a, SR)
    kw = dict(rate=2.0, depth=0.9)
    eq = np.array_equal(dev.autopan(**kw).get_frame_array(),
                        gold.autopan(**kw).frames)
    check("fx/autopan", eq, "bit-exact")

    song_n = Song()
    song_n.bpm = 240
    song_n.ticks = 4
    song_n.add_instrument("kick", ws.sine(60, 0.1, amplitude=0.9)
                          .fadeout(0.08).stereo())
    song_n.add_pattern("a", {"kick": "x.x. x..."})
    song_n.pattern_sequence = ["a", "a"]
    song_n.add_fx("echo", delay=0.09, feedback=0.45, wet=0.4)
    song_n.add_fx("phaser", rate=0.9, depth=1.0, wet=0.5)
    song_n.add_fx("width", amount=1.4)
    song_n.add_fx("limiter", ceiling_db=-2.0, lookahead=0.004)
    song_n.add_automation("fx.echo.wet", "0:0.1 8:0.6")
    song_n.add_automation("fx.limiter.ceiling_db", "0:-1 8:-8")
    offn = song_n.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    gotn = np.concatenate([c.get_frame_array()
                           for c in song_n.mix_generator(chunk_frames=1470)])
    dn = np.abs(gotn.astype(np.int64) - offn.astype(np.int64)).max()
    check("fx/new_strip_stream_eq_offline",
          len(gotn) == len(offn) and dn <= 12,
          f"max {dn} LSB over {len(gotn)} frames")

    # automation curves: per-hit velocity must be rint-exact on the chip
    # and the continuous master fade bit-equal between paths
    song3 = Song()
    song3.bpm = 240
    song3.ticks = 4
    song3.add_instrument("kick", ws.sine(60, 0.08, amplitude=0.6)
                         .fadeout(0.05).stereo())
    song3.add_pattern("a", {"kick": "x...x...x...x..."})
    song3.pattern_sequence = ["a"]
    song3.add_automation("track.kick.volume", "0:1 12:0.25")
    song3.add_automation("master.volume", "0:1 16:0.1")
    off3 = song3.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got3 = np.concatenate([c.get_frame_array()
                           for c in song3.mix_generator(chunk_frames=1470)])
    exact = (len(got3) == len(off3)
             and np.array_equal(got3, off3[:len(got3)]))
    kick = song3.instruments["kick"].get_frame_array().astype(np.float64)
    tickf = song3.tick_duration * SR
    s2 = int(8 * tickf)       # third hit: velocity 0.5
    vel = np.rint(kick * np.float32(0.5)).astype(np.float32)
    n = (s2 + np.arange(len(kick))).astype(np.float32)
    g = np.interp(n / np.float32(tickf), [0.0, 16.0], [1.0, 0.1]) \
        .astype(np.float32)
    expect = np.clip(np.rint(vel * g[:, None]), -32768, 32767)
    d3 = np.abs(off3[s2:s2 + len(kick)].astype(np.int64)
                - expect.astype(np.int64)).max()
    check("fx/automation_velocity_and_fade", exact and d3 <= 1,
          f"stream==offline {exact}, hit3 max {d3} LSB")

    # fx.filter.cutoff automation: the per-frame-coefficient companion
    # scan (2x2 products) must agree between the offline whole-signal
    # call and streaming chunks on the chip
    song4 = Song()
    song4.bpm = 240
    song4.ticks = 4
    song4.add_synth("saw", SynthDef(wave="sawtooth_bl", amplitude=0.4,
                                    attack=0.002, release=0.05))
    song4.add_pattern("a", {"saw": "C3 - - - C3 - - - C3 - - - C3 - - -"})
    song4.pattern_sequence = ["a"]
    song4.add_fx("filter", kind="lowpass", cutoff=1000.0, q=2.0)
    song4.add_automation("fx.filter.cutoff", "0:300 8:6000 16:300")
    off4 = song4.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got4 = np.concatenate([c.get_frame_array()
                           for c in song4.mix_generator(chunk_frames=1470)])
    d4 = np.abs(got4.astype(np.int64) - off4.astype(np.int64)).max()
    check("fx/automation_filter_sweep", len(got4) == len(off4) and d4 <= 8,
          f"max {d4} LSB over {len(got4)} frames")

    # pitched sampler tracks: the f32 interp gathers must behave
    # identically on the chip — rate-1 passthrough bit-exact, streaming
    # == offline bit-exact
    song5 = Song()
    song5.bpm = 240
    song5.ticks = 4
    gtr = ws.pluck(261.6255653005986, 0.25, amplitude=0.6, seed=3) \
        .fadeout(0.04).stereo()
    song5.add_sampler("gtr", gtr, base_note="C4")
    pad = ws.sine(261.6255653005986, 0.1, amplitude=0.4).stereo()
    song5.add_sampler("pad", pad, base_note="C4", loop_start=0.02,
                      loop_end=0.08, release=0.02)   # DDS sustain loop
    song5.add_pattern("a", {"gtr": "C4 .. E4 G4 .. .. C5 C3",
                            "pad": "E3 - - - - - - -"})
    song5.pattern_sequence = ["a"]
    off5 = song5.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got5 = np.concatenate([c.get_frame_array()
                           for c in song5.mix_generator(chunk_frames=1470)])
    solo = Song()
    solo.bpm = 240
    solo.ticks = 4
    solo.add_sampler("gtr", gtr, base_note="C4")
    solo.add_pattern("a", {"gtr": "C4 .. .. .. .. .. .. .."})
    solo.pattern_sequence = ["a"]
    src = solo.samplers["gtr"].sample.get_frame_array()
    rate1 = solo.mix(normalize=False,
                     tail_seconds=0.0).get_frame_array()[:len(src)]
    check("fx/sampler_tracks",
          np.array_equal(got5, off5[:len(got5)])
          and np.array_equal(rate1, src),
          f"stream==offline {np.array_equal(got5, off5[:len(got5)])}, "
          f"rate1 passthrough {np.array_equal(rate1, src)}")


def section_effects_d(SR, a, ab, ir, xr):
    """Effects rack on the card, part D: recurrence-internal automation, the float-float scan, wide ratecv — device twins vs
    goldref.effects with the budgets documented there (the scans and
    cuFFT paths have no CPU-suite coverage on the real backend)."""
    import jax.numpy as jnp
    import goldref.effects as _gfx
    import goldref.sample as gs
    from synthesizer_tpu import WaveSynth
    from synthesizer_tpu.sample import Sample
    from synthesizer_tpu.sequencer import Song, SynthDef
    ws = WaveSynth(samplerate=SR, samplewidth=2)

    # recurrence-internal automation (round 3): the swept-coefficient
    # compressor, roomsize-swept reverb, and constant-rate chorus
    # identity — on the chip, vs the per-sample goldref oracles
    import jax.numpy as jnp
    import goldref.effects as _gfx
    from synthesizer_tpu.effects import (StreamingChorus,
                                         StreamingCompressor,
                                         StreamingReverb)
    from synthesizer_tpu.ops.coeffs import (compressor_coeff_grids,
                                            curve_grid,
                                            reverb_feedback_grid)
    tickf = SR / 8.0
    xa = a[:3000]
    att_c = [(0.0, 0.001), (8.0, 0.05)]
    rel_c = [(0.0, 0.02), (8.0, 0.4)]
    proc = StreamingCompressor(SR, threshold_db=-20.0, ratio=4.0,
                               attack_curve=att_c, release_curve=rel_c,
                               tickf=tickf)
    got_c = np.asarray(proc.process(jnp.asarray(xa)))
    alpha, decay = compressor_coeff_grids(
        curve_grid(att_c, 0, 3000, tickf),
        curve_grid(rel_c, 0, 3000, tickf), SR)
    lvl = np.max(np.abs(xa.astype(np.float32) / np.float32(32767.0)),
                 axis=1).astype(np.float32)
    gains = _gfx.compressor_gains_swept(lvl, alpha, decay,
                                        np.float32(-20.0),
                                        np.float32(0.75))
    want_c = _gfx._gain_floor(xa, gains[:, None], 2)
    dc = np.abs(got_c.astype(np.int64) - want_c.astype(np.int64)).max()
    check("fx/auto_compress_coeff_grids", dc <= 2,
          f"max {dc} LSB (budget 2)")

    room_c = [(0.0, 0.2), (8.0, 0.9)]
    procr = StreamingReverb(SR, 2, roomsize=0.5, damping=0.4, wet=0.3,
                            dry=0.7, tail=0.0, roomsize_curve=room_c,
                            tickf=tickf)
    got_r = np.asarray(procr.process(jnp.asarray(xa)))
    fbg = reverb_feedback_grid(curve_grid(room_c, 0, 3000, tickf))
    want_r = _gfx.reverb(xa, 2, SR, roomsize=0.5, damping=0.4, wet=0.3,
                         dry=0.7, tail_frames=0, feedback_curve=fbg)
    dr2 = np.abs(got_r.astype(np.int64) - want_r.astype(np.int64)).max()
    check("fx/auto_reverb_roomsize", dr2 <= 4, f"max {dr2} LSB (budget 4)")

    pc = StreamingChorus(SR, 2, rate=1.5, depth=0.002, delay=0.012,
                         voices=3, wet=0.5, dry=0.9,
                         rate_curve=[(0.0, 1.5)], tickf=tickf)
    ps = StreamingChorus(SR, 2, rate=1.5, depth=0.002, delay=0.012,
                         voices=3, wet=0.5, dry=0.9)
    yc = np.asarray(pc.process(jnp.asarray(xa)))
    ys = np.asarray(ps.process(jnp.asarray(xa)))
    check("fx/auto_chorus_const_rate_exact", np.array_equal(yc, ys),
          "P_n == n*inc identity")

    # swept EQ band (fx.eq.*_db automation): per-frame RBJ coefficient
    # grids through the companion scan vs the sequential-f64 oracle
    from synthesizer_tpu.effects import SweptEQBand
    gain_c = [(0.0, -10.0), (8.0, 8.0)]
    pe = SweptEQBand(SR, 2, "peaking", 1500.0, 1.2, gain_c, tickf)
    got_e = np.asarray(pe.process(jnp.asarray(xa)))
    # the band routes through the float-float scan -> f64 oracle grids
    want_e = _gfx.eq_swept(xa, 2, SR, "peaking", 1500.0, 1.2,
                           curve_grid(gain_c, 0, len(xa), tickf),
                           grids_dtype=np.float64 if pe._ff else None)
    de = np.abs(got_e.astype(np.int64) - want_e.astype(np.int64)).max()
    check("fx/auto_eq_gain_grids", de <= 4, f"max {de} LSB (budget 4)")

    # float-float compensated scan on HARDWARE: Dekker/Knuth EFTs assume
    # exact IEEE f32 add/mul — FMA contraction in the GPU code generator
    # is exactly what could silently break them.  Pathological
    # highpass (Q=30 @ 40 Hz): plain scan drifts >1000 LSB from the f64
    # oracle; the ff path must stay <= 2.
    from synthesizer_tpu.ops.coeffs import (biquad_coeffs as _bq,
                                            ff_split as _ffs)
    from synthesizer_tpu.ops.effects import (biquad_apply as _ba,
                                             biquad_apply_ff as _baff)
    co_ff = _bq("highpass", 40.0, 30.0, SR)
    xs32 = (xa.astype(np.float32) / np.float32(32767.0))
    b0, b1, b2, a1, a2 = (np.float64(c) for c in co_ff)
    sd = xs32.astype(np.float64)
    outd = np.empty_like(sd)
    for ch2 in range(2):
        x1 = x2 = yy1 = yy2 = 0.0
        v = sd[:, ch2]
        for i in range(len(v)):
            yv = b0 * v[i] + b1 * x1 + b2 * x2 - a1 * yy1 - a2 * yy2
            x2, x1 = x1, v[i]
            yy2, yy1 = yy1, yv
            outd[i, ch2] = yv
    want_ff = np.rint(np.clip(outd * 32767, -32768, 32767))
    yp, _ = _ba(jnp.asarray(xs32), co_ff)
    d_plain = np.abs(np.rint(np.clip(
        np.asarray(yp, np.float64) * 32767, -32768, 32767)) - want_ff).max()
    yf, _ = _baff(jnp.asarray(xs32), tuple(_ffs(c) for c in co_ff))
    d_ff = np.abs(np.rint(np.clip(
        np.asarray(yf, np.float64) * 32767, -32768, 32767)) - want_ff).max()
    check("fx/ff_scan_eft_on_hw", d_ff <= 2 and d_plain > 100,
          f"ff {d_ff:.0f} LSB vs f64 oracle (plain {d_plain:.0f})")

    # general wide-division ratecv (round 3): pathological reduced rates
    # run the sign-magnitude limb path ON THE CHIP, bit-exact vs the
    # int64 oracle at full int32 range (uint32 semantics are exactly the
    # kind of thing backends can diverge on — check on hw)
    from synthesizer_tpu.ops import resample as drs
    from goldref import pcm as gpcm
    xr = xr.copy()
    xr[0] = (-2**31, 2**31 - 1)
    yw, stw = drs.resample(xr, 44100, 96001, width=4)
    wb, wst = gpcm.ratecv(gpcm.tobytes(xr.reshape(-1), 4), 4, 2,
                          44100, 96001, None)
    wantw = gpcm.frombytes(wb, 4).reshape(-1, 2)
    check("fx/ratecv_wide_division",
          np.array_equal(yw, wantw) and stw.to_audioop(4) == wst,
          f"{len(wantw)} frames, width 4, reduced outr 96001")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--allow-cpu", action="store_true",
                    help="permit running on the CPU backend (self-check of "
                         "the battery; results say nothing of the GPU)")
    ap.add_argument("--fast", action="store_true",
                    help="skip section B (voice bank) for quick iteration")
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    print(f"device: {dev.device_kind} ({dev.platform})", flush=True)
    if dev.platform != "gpu" and not args.allow_cpu:
        print("ERROR: battery must run on a GPU (use --allow-cpu to "
              "self-check on the CPU)")
        return 2

    FAILURES.clear()
    SR = 44100
    fx_in = _fx_inputs(SR)
    sections = {"graph": lambda: section_graph(SR, n=SR // 4, blocksize=4096),
                "bank": lambda: section_bank(SR, n=4096),
                "configs": lambda: section_configs(SR),
                "effects_a": lambda: section_effects_a(SR, *fx_in),
                "effects_b": lambda: section_effects_b(SR, *fx_in),
                "effects_c": lambda: section_effects_c(SR, *fx_in),
                "effects_d": lambda: section_effects_d(SR, *fx_in)}
    if args.fast:
        del sections["bank"]

    def timed(fn):
        t = _LAST.t = time.time()
        fn()
        return time.time() - t

    # import before the threads start: concurrent first imports of one
    # package race on its partially initialized modules
    import importlib
    sys.path.insert(0, os.path.join(_ROOT, "tests"))
    for mod in ("synthesizer_tpu", "synthesizer_tpu.midi",
                "synthesizer_tpu.effects", "synthesizer_tpu.ops.effects",
                "synthesizer_tpu.ops.loudness", "synthesizer_tpu.ops.resample",
                "synthesizer_tpu.parallel.mesh", "goldref.effects",
                "goldref.osc", "goldref.pcm", "goldref.sample",
                "test_voicebank"):
        importlib.import_module(mod)

    # the sections are independent: threads overlap their XLA compilations
    # (which release the GIL), most of a cold run's wall time on a GPU
    t0 = time.time()
    with ThreadPoolExecutor(len(sections)) as pool:
        futures = {k: pool.submit(timed, fn) for k, fn in sections.items()}
        for name, fut in futures.items():
            print(f"section {name}: {fut.result():.1f}s", flush=True)
    print(f"\nbattery wall time {time.time()-t0:.1f}s on {dev.device_kind}")
    print(f"{'ALL PASS' if not FAILURES else f'FAILURES: {FAILURES}'}")
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
