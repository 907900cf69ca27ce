"""Effects-rack oracle: sequential reference implementations.

The reference library has no effects beyond the feed-forward echo
(SURVEY.md §3.1 row 2 lists the full op set); this module is the
behavioral contract for the rebuild's *beyond-reference* effects rack —
dynamics compression, Freeverb-style reverb, multi-voice chorus, and
impulse-response convolution.  Like the rest of ``goldref``, everything
here is straightforward sequential host code (numpy, python loops for the
recurrences); the device twins in ``synthesizer_tpu/ops/effects.py``
implement the SAME formulas as parallel/blocked scans and are tested
against this module with the tolerance documented per function.

Shared conventions:

* the working signal is the normalized float32 value ``s = f32(x)/maxval``
  per channel (maxval from the sample width);
* pure-gain effects (the compressor) convert back with the house gain
  rule ``floor(f32(x) * f32(gain))``, clamp — identical to fades/envelope;
* signal-synthesizing effects (reverb/chorus/convolve wet mixes) convert
  back with the house synthesis rule ``clip(rint(f32(y * maxval)))`` —
  identical to the oscillator path (goldref.osc.to_int_samples).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

MAXVAL = {1: 127, 2: 32767, 4: 2147483647}
MINVAL = {1: -128, 2: -32768, 4: -2147483648}
_DTYPES = {1: np.int8, 2: np.int16, 4: np.int32}


def _norm(frames: np.ndarray, width: int) -> np.ndarray:
    """int frames [n, ch] -> normalized f32 (|x|/maxval may exceed 1 at MIN)."""
    return frames.astype(np.float32) / np.float32(MAXVAL[width])


def _to_int(values_f32: np.ndarray, width: int) -> np.ndarray:
    """House synthesis quantization: clip(rint(f32(v*maxval))), f32 product."""
    v = np.rint(values_f32.astype(np.float32) * np.float32(MAXVAL[width]))
    v64 = v.astype(np.float64)
    return np.clip(v64, MINVAL[width], MAXVAL[width]).astype(_DTYPES[width])


def _gain_floor(frames: np.ndarray, gains: np.ndarray, width: int) -> np.ndarray:
    """House gain quantization: floor(f32(x) * f32(g)), clamp."""
    v = frames.astype(np.float32) * gains.astype(np.float32)
    v64 = np.floor(v.astype(np.float64))
    return np.clip(v64, MINVAL[width], MAXVAL[width]).astype(_DTYPES[width])


# ---------------------------------------------------------------------------
# Dynamics compressor / limiter
# ---------------------------------------------------------------------------

def compressor_coeffs(samplerate: int, attack: float,
                      release: float) -> Tuple[float, float]:
    """Host-side f64 coefficient computation, shared verbatim by both
    evaluators: attack one-pole alpha and release decay-per-sample.

    attack <= 0 -> alpha 1 (instant); release <= 0 -> decay 0 (instant)."""
    alpha = 1.0 if attack <= 0 else 1.0 - math.exp(-1.0 / (attack * samplerate))
    decay = 0.0 if release <= 0 else math.exp(-1.0 / (release * samplerate))
    return alpha, decay


def _static_curve_db_f32(level_db, thr, slope, knee):
    """Per-sample static curve (f32): hard knee is
    min(0, (thr - level)*slope); a soft knee of width W dB replaces the
    corner with the quadratic -slope*(level - thr + W/2)^2 / (2W) for
    |level - thr| <= W/2 (value + first derivative continuous at both
    edges — the textbook second-order knee)."""
    hard = min(np.float32(0.0), np.float32((thr - level_db) * slope))
    if knee is None:
        return hard
    half = np.float32(knee * np.float32(0.5))
    t = np.float32(level_db - thr + half)
    if t <= np.float32(0.0):
        return np.float32(0.0)
    if level_db > np.float32(thr + half):
        return hard
    return np.float32(-(np.float32(slope * np.float32(t * t)))
                      / np.float32(np.float32(2.0) * knee))


def compressor_gains(frames: np.ndarray, width: int, samplerate: int,
                     threshold_db: float, ratio: float, attack: float,
                     release: float, knee_db: float = 0.0) -> np.ndarray:
    """Per-sample gain curve of the feed-forward peak compressor.  Spec:

    * detector input  a_n = max over channels of |s_n| (normalized f32);
    * envelope        e_n = max(a_n, e_{n-1} * decay),  e_{-1} = 0
      (instant-attack decaying-max peak follower — an associative
      recurrence, which is what makes the device twin a parallel scan);
    * static curve    g_db = min(0, (threshold_db - level_db) * (1 - 1/ratio))
      with level_db = 20*log10(max(e_n, 1e-10)); ratio = inf is a limiter;
    * attack smoothing on the LINEAR gain:
      y_n = y_{n-1} + alpha * (g_n - y_{n-1}),  y_{-1} = 1;
    * soft knee (``knee_db`` = width W > 0): the static curve's corner is
      replaced by -slope*(level - thr + W/2)^2 / (2W) over
      |level - thr| <= W/2 (:func:`_static_curve_db_f32`) — knee 0 keeps
      the hard-knee arithmetic bit-identical.

    All per-sample math is float32 (log10/exp2 included).  The device twin
    evaluates the same recurrences as parallel scans whose f32 rounding
    regroups; the agreed budget is |gain| <= 2e-6 absolute, <= 2 LSB after
    application at 16-bit.  (The device evaluates the smoother in the
    algebraically-equal deviation form z = 1 - y so the g == 1 fixpoint is
    exact — under-threshold audio is bit-transparent on BOTH sides.)
    """
    a = np.max(np.abs(_norm(frames, width)), axis=1).astype(np.float32)
    return compressor_gains_from_level(a, samplerate, threshold_db, ratio,
                                       attack, release, knee_db=knee_db)


def compressor_gains_from_level(a: np.ndarray, samplerate: int,
                                threshold_db: float, ratio: float,
                                attack: float, release: float,
                                knee_db: float = 0.0) -> np.ndarray:
    """The gain recurrences from a precomputed f32 detector level ``a``
    (also the sidechain entry point — the device twin mirrors the split)."""
    alpha, decay = compressor_coeffs(samplerate, attack, release)
    slope = np.float32(1.0 if math.isinf(ratio) else 1.0 - 1.0 / ratio)
    thr = np.float32(threshold_db)
    knee = np.float32(knee_db) if knee_db and knee_db > 0 else None
    n = a.shape[0]
    gains = np.empty(n, np.float32)
    e = np.float32(0.0)
    y = np.float32(1.0)
    dec = np.float32(decay)
    al = np.float32(alpha)
    for i in range(n):
        e = max(a[i], np.float32(e * dec))
        level_db = np.float32(20.0) * np.float32(
            np.log10(max(e, np.float32(1e-10))))
        g_db = _static_curve_db_f32(level_db, thr, slope, knee)
        g = np.float32(np.exp2(np.float32(g_db * np.float32(1.0 / 6.0206))))
        y = np.float32(y + al * np.float32(g - y))
        gains[i] = y
    return gains


def compressor_gains_swept(a: np.ndarray, alpha: np.ndarray,
                           decay: np.ndarray, threshold_db,
                           slope, knee=None) -> np.ndarray:
    """Per-sample-coefficient twin of :func:`compressor_gains_from_level`
    — the [automation] ``fx.compress.attack``/``.release`` spec: ``alpha``
    and ``decay`` are per-sample f32 COEFFICIENT GRIDS (derived on host
    in f64 from the breakpoint curves, see synthesizer_tpu.ops.coeffs),
    entering the recurrences at their frame:

        e_n = max(a_n, e_{n-1} * decay_n)
        y_n = y_{n-1} + alpha_n (g_n - y_{n-1})

    Constant grids reproduce the static recurrence bit-exactly.  The
    device twin evaluates the same per-sample-coefficient recurrences as
    associative scans (the decaying max still composes:
    (x1,d1)∘(x2,d2) = (max(x2, x1 d2), d1 d2) with per-element d); same
    budget as the static compressor (<= 2e-6 on gains, <= 2 LSB applied).
    ``threshold_db``/``slope``/``knee`` may be scalars or per-sample
    arrays (knee: dB width grid — fx.compress.knee_db automation; None
    or 0 = hard knee)."""
    n = a.shape[0]
    alpha = np.broadcast_to(np.asarray(alpha, np.float32), (n,))
    decay = np.broadcast_to(np.asarray(decay, np.float32), (n,))
    thr = np.broadcast_to(np.asarray(threshold_db, np.float32), (n,))
    slope = np.broadcast_to(np.asarray(slope, np.float32), (n,))
    kneev = (np.broadcast_to(np.asarray(knee, np.float32), (n,))
             if knee is not None else None)
    gains = np.empty(n, np.float32)
    e = np.float32(0.0)
    y = np.float32(1.0)
    for i in range(n):
        e = max(a[i], np.float32(e * decay[i]))
        level_db = np.float32(20.0) * np.float32(
            np.log10(max(e, np.float32(1e-10))))
        kn = None if kneev is None or kneev[i] <= 0 else kneev[i]
        g_db = _static_curve_db_f32(level_db, thr[i], slope[i], kn)
        g = np.float32(np.exp2(np.float32(g_db * np.float32(1.0 / 6.0206))))
        y = np.float32(y + alpha[i] * np.float32(g - y))
        gains[i] = y
    return gains


def sidechain_level(key_frames: np.ndarray, key_width: int,
                    n: int) -> np.ndarray:
    """Detector input from a SIDECHAIN key: a_n = max over channels of
    |key_n| for n < len(key), else 0 (past the key the envelope decays and
    the gain releases back to 1).  f32; shared by both evaluators."""
    a = np.max(np.abs(_norm(key_frames, key_width)), axis=1)         .astype(np.float32)
    if len(a) >= n:
        return a[:n]
    return np.concatenate([a, np.zeros(n - len(a), np.float32)])


def compress(frames: np.ndarray, width: int, samplerate: int,
             threshold_db: float = -20.0, ratio: float = 4.0,
             attack: float = 0.005, release: float = 0.1,
             makeup_db: float = 0.0, knee_db: float = 0.0,
             sidechain: "np.ndarray" = None,
             sidechain_width: int = 2) -> np.ndarray:
    """Apply the compressor: house gain rule with gain_n * makeup.  With
    ``sidechain`` (key frames [m, ch]) the detector listens to the KEY
    while the gain applies to ``frames`` — classic ducking."""
    if sidechain is not None:
        det = sidechain_level(sidechain, sidechain_width, frames.shape[0])
        gains = compressor_gains_from_level(det, samplerate, threshold_db,
                                            ratio, attack, release,
                                            knee_db=knee_db)
    else:
        gains = compressor_gains(frames, width, samplerate, threshold_db,
                                 ratio, attack, release, knee_db=knee_db)
    makeup = np.float32(np.exp2(np.float32(makeup_db) / np.float32(6.0206)))
    return _gain_floor(frames, (gains * makeup)[:, None], width)


def tremolo(frames: np.ndarray, width: int, g: np.ndarray) -> np.ndarray:
    """Apply a per-frame tremolo gain grid (spec.tremolo_gain_grid):
    the house gain rule floor(f32(x) * f32(g)), clamp.  Stateless in the
    absolute frame index — streaming == offline == seek by construction;
    device budget <= 1 LSB (FMA contraction class)."""
    return _gain_floor(frames, np.asarray(g, np.float32)[:, None], width)


def autopan(frames: np.ndarray, width: int, pan: np.ndarray) -> np.ndarray:
    """Apply a per-frame pan-position grid (spec.autopan_pan_grid)
    through the house equal-gain pan law lg = min(1, 1-pan),
    rg = min(1, 1+pan) (the voice-bank/hit-pan law), house gain rule.
    Stereo only; same statelessness/budget as :func:`tremolo`."""
    p = np.asarray(pan, np.float32)
    lg = np.minimum(np.float32(1.0), np.float32(1.0) - p)
    rg = np.minimum(np.float32(1.0), np.float32(1.0) + p)
    return _gain_floor(frames, np.stack([lg, rg], axis=1), width)


# ---------------------------------------------------------------------------
# Freeverb-style reverb
# ---------------------------------------------------------------------------

#: classic Freeverb tuning (delay lengths in frames at 44100 Hz)
COMB_TUNING = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
ALLPASS_TUNING = (556, 441, 341, 225)
STEREO_SPREAD = 23
FIXED_GAIN = 0.015
ALLPASS_FEEDBACK = 0.5


def reverb_delays(samplerate: int, channel: int) -> Tuple[Tuple[int, ...],
                                                          Tuple[int, ...]]:
    """Delay lengths for one channel's network, scaled from the 44100 Hz
    tuning: D = max(2, int(round((D44 + 23*channel) * sr / 44100)))."""
    scale = samplerate / 44100.0
    sp = STEREO_SPREAD * channel
    combs = tuple(max(2, int(round((d + sp) * scale))) for d in COMB_TUNING)
    aps = tuple(max(2, int(round((d + sp) * scale))) for d in ALLPASS_TUNING)
    return combs, aps


def reverb_params(roomsize: float, damping: float, wet: float,
                  width: float) -> Tuple[float, float, float, float]:
    """(feedback, damp, wet1, wet2) from the user knobs (Freeverb mapping):
    feedback = 0.7 + 0.28*roomsize; damp = 0.4*damping;
    wet1 = wet*(width/2 + 0.5); wet2 = wet*(1 - width)/2."""
    return (0.7 + 0.28 * roomsize, 0.4 * damping,
            wet * (width / 2.0 + 0.5), wet * (1.0 - width) / 2.0)


def _reverb_network(mono_in: np.ndarray, combs, aps, feedback: float,
                    damp: float) -> np.ndarray:
    """One channel's network, sequential f32: 8 parallel damped-feedback
    combs summed, then 4 series allpasses.  Per-sample comb recurrence
    (zero-initial buffers; pos starts at 0 and increments per sample):

        y_n     = buf[pos]                       (the D-delayed output)
        fs      = y_n*(1-damp) + fs*damp         (one-pole damping state)
        buf[pos] = in_n + fs*feedback

    Allpass (Freeverb form, feedback 0.5):

        b       = buf[pos]
        out_n   = b - in_n
        buf[pos] = in_n + b*0.5
    """
    n = mono_in.shape[0]
    # feedback may be a per-sample array (fx.reverb.roomsize automation:
    # fb_n = 0.7 + 0.28*roomsize_n, entering the comb WRITE of its frame —
    # the recurrence structure is unchanged)
    fb = np.broadcast_to(np.asarray(feedback, np.float32), (n,))
    d1 = np.float32(damp)
    d2 = np.float32(1.0 - damp)
    cbufs = [np.zeros(D, np.float32) for D in combs]
    fstores = np.zeros(len(combs), np.float32)
    out = np.zeros(n, np.float32)
    for i in range(n):
        x = mono_in[i]
        acc = np.float32(0.0)
        for k, D in enumerate(combs):
            p = i % D
            y = cbufs[k][p]
            fstores[k] = np.float32(y * d2 + fstores[k] * d1)
            cbufs[k][p] = np.float32(x + fstores[k] * fb[i])
            acc = np.float32(acc + y)
        out[i] = acc
    g = np.float32(ALLPASS_FEEDBACK)
    for D in aps:
        buf = np.zeros(D, np.float32)
        nxt = np.empty(n, np.float32)
        for i in range(n):
            p = i % D
            b = buf[p]
            nxt[i] = np.float32(b - out[i])
            buf[p] = np.float32(out[i] + b * g)
        out = nxt
    return out


def reverb(frames: np.ndarray, width: int, samplerate: int,
           roomsize: float = 0.7, damping: float = 0.5, wet: float = 0.33,
           dry: float = 0.7, stereo_width: float = 1.0,
           tail_frames: int = 0,
           feedback_curve: "np.ndarray" = None) -> np.ndarray:
    """Freeverb-style reverb.  The input (zero-padded by ``tail_frames``)
    feeds every network as ``in = (sum of channels) * 0.015``; mono samples
    run one network (channel-0 tuning), stereo runs two (channel 1 spread
    +23 frames) with cross-mixed wets:

        outL = dry*sL + wet1*revL + wet2*revR   (and symmetrically for R)

    Output = clip(rint(out * maxval)), length n + tail_frames.  Device-twin
    tolerance: the blocked-parallel scan regroups the f32 comb/allpass
    arithmetic; agreed budget <= 4 LSB at 16-bit for |signal| <= full scale.
    """
    n = frames.shape[0]
    nch = frames.shape[1]
    total = n + int(tail_frames)
    s = np.zeros((total, nch), np.float32)
    s[:n] = _norm(frames, width)
    mono_in = (np.sum(s, axis=1) * np.float32(FIXED_GAIN)).astype(np.float32)
    feedback, damp, wet1, wet2 = reverb_params(roomsize, damping, wet,
                                               stereo_width)
    if feedback_curve is not None:
        # fx.reverb.roomsize automation: per-sample feedback grid [total]
        # (host f64 fb_n = 0.7 + 0.28*roomsize_n, cast f32) replaces the
        # static knob in every comb write
        feedback = np.asarray(feedback_curve, np.float32)
    if nch == 1:
        combs, aps = reverb_delays(samplerate, 0)
        rev = _reverb_network(mono_in, combs, aps, feedback, damp)
        out = np.float32(dry) * s[:, 0] + np.float32(wet1 + wet2) * rev
        return _to_int(out[:, None], width)
    revs = []
    for ch in range(2):
        combs, aps = reverb_delays(samplerate, ch)
        revs.append(_reverb_network(mono_in, combs, aps, feedback, damp))
    out = np.stack([
        np.float32(dry) * s[:, 0] + np.float32(wet1) * revs[0]
        + np.float32(wet2) * revs[1],
        np.float32(dry) * s[:, 1] + np.float32(wet1) * revs[1]
        + np.float32(wet2) * revs[0],
    ], axis=1)
    return _to_int(out, width)


# ---------------------------------------------------------------------------
# Multi-voice chorus
# ---------------------------------------------------------------------------

def chorus_delay_f32(n0: int, n: int, samplerate: int, rate: float,
                     depth: float, delay: float, voice: int, voices: int,
                     channel: int) -> np.ndarray:
    """Voice delay curve in FRAMES, float32.  The LFO phase is the house
    integer DDS (exact wrapped u32 accumulator — spec.phase_increment
    convention), so the curve is exactly computable at ANY absolute frame
    index (an f32 ``n * rate/sr`` would quantize the phase to 1/4 frame
    past ~2^24 frames):

        inc    = round(rate/sr * 2^32)  (wrapped u32)
        phase0 = round(frac(voice/voices + 0.25*channel) * 2^32)
        p_n    = (phase0 + (n0+n)*inc) mod 2^32 ;  x = f32(p_n) * 2^-32
        lfo    = 0.5 + 0.5*sin(2*pi*x)           (f32; device: turn-unit poly)
        d_n    = (f32(delay) + f32(depth)*lfo) * f32(sr)
    """
    inc = int(round(rate / samplerate * 4294967296.0)) & 0xFFFFFFFF
    phi = (voice / voices + 0.25 * channel) % 1.0
    phase0 = int(round(phi * 4294967296.0)) & 0xFFFFFFFF
    idx = np.arange(n0, n0 + n, dtype=np.uint64)
    p = (np.uint64(phase0) + idx * np.uint64(inc)) & np.uint64(0xFFFFFFFF)
    x = p.astype(np.float32) * np.float32(2.0 ** -32)
    lfo = (np.float32(0.5) + np.float32(0.5)
           * np.sin(2.0 * np.pi * x.astype(np.float64)).astype(np.float32))
    return ((np.float32(delay) + np.float32(depth) * lfo)
            * np.float32(samplerate))


def chorus(frames: np.ndarray, width: int, samplerate: int,
           rate: float = 0.5, depth: float = 0.002, delay: float = 0.02,
           voices: int = 3, wet: float = 0.4, dry: float = 1.0) -> np.ndarray:
    """Multi-voice chorus: each voice reads the input at an LFO-modulated
    fractional delay (linear interpolation, zero before the start):

        out_c = dry*s_c + (wet/voices) * sum_v lerp(s_c, n - d_v,c(n))

    The read position splits EXACTLY in integer/f32 parts: with
    df = floor(d) and fr = d - df (f32), the lerp is
    ``s[n-df-1]*fr + s[n-df]*(1-fr)`` — both sides compute identical gather
    indices at any length.  Output = clip(rint(out * maxval)), same length.
    Device twin budget: the device sine is the turn-unit minimax poly
    (max err 7.8e-7) and its mix accumulates in f32 (oracle: f64); agreed
    budget <= 2 LSB at 16-bit.
    """
    n, nch = frames.shape
    s = _norm(frames, width).astype(np.float64)
    out = np.float64(dry) * s
    wv = np.float64(wet) / voices
    idx = np.arange(n, dtype=np.int64)
    for ch in range(nch):
        for v in range(voices):
            d = chorus_delay_f32(0, n, samplerate, rate, depth, delay, v,
                                 voices, ch)
            df = np.floor(d)
            fr = (d - df).astype(np.float64)
            i0 = idx - df.astype(np.int64)
            v0 = (i0 - 1 >= 0) & (i0 - 1 < n)
            v1 = (i0 >= 0) & (i0 < n)
            x0 = np.where(v0, s[np.clip(i0 - 1, 0, n - 1), ch], 0.0)
            x1 = np.where(v1, s[np.clip(i0, 0, n - 1), ch], 0.0)
            out[:, ch] += wv * (x0 * fr + x1 * (1.0 - fr))
    return _to_int(out.astype(np.float32), width)


def chorus_delay_swept(P: np.ndarray, depth: np.ndarray, samplerate: int,
                       delay: float, voice: int, voices: int,
                       channel: int) -> np.ndarray:
    """Per-frame voice delay curve for RATE/DEPTH-automated chorus
    (fx.chorus.rate/.depth spec).  The LFO phase comes from a shared
    CUMULATIVE phase ``P`` [n] (u32): P_n = (sum_{m<n} inc_m) mod 2^32
    with per-frame increments inc_m = round(rate_m/sr * 2^32) derived on
    host in f64 from the breakpoint curve (synthesizer_tpu.ops.coeffs).
    A constant rate curve gives P_n = n*inc — bit-identical to the static
    chorus_delay_f32 phase.  ``depth`` is the per-frame f32 depth grid:

        p_n = (phase0(voice, channel) + P_n) mod 2^32
        d_n = (f32(delay) + depth_n * lfo_n) * f32(sr)
    """
    phi = (voice / voices + 0.25 * channel) % 1.0
    phase0 = int(round(phi * 4294967296.0)) & 0xFFFFFFFF
    p = (np.uint64(phase0) + np.asarray(P, np.uint64)) \
        & np.uint64(0xFFFFFFFF)
    x = p.astype(np.float32) * np.float32(2.0 ** -32)
    lfo = (np.float32(0.5) + np.float32(0.5)
           * np.sin(2.0 * np.pi * x.astype(np.float64)).astype(np.float32))
    return ((np.float32(delay) + np.asarray(depth, np.float32) * lfo)
            * np.float32(samplerate))


def chorus_swept(frames: np.ndarray, width: int, samplerate: int,
                 P: np.ndarray, depth: np.ndarray, delay: float,
                 voices: int, wet, dry) -> np.ndarray:
    """Rate/depth-automated chorus: :func:`chorus` with every voice's
    delay from :func:`chorus_delay_swept` (shared cumulative phase P and
    per-frame depth grid); ``wet``/``dry`` may be scalars or per-frame
    arrays (output-stage automation composes).  Same device budget as the
    static chorus (<= 2 LSB at 16-bit)."""
    n, nch = frames.shape
    s = _norm(frames, width).astype(np.float64)
    dryv = np.broadcast_to(np.asarray(dry, np.float64), (n,))
    wv = np.broadcast_to(np.asarray(wet, np.float64), (n,)) / voices
    out = dryv[:, None] * s
    idx = np.arange(n, dtype=np.int64)
    for ch in range(nch):
        for v in range(voices):
            d = chorus_delay_swept(P, depth, samplerate, delay, v,
                                   voices, ch)
            df = np.floor(d)
            fr = (d - df).astype(np.float64)
            i0 = idx - df.astype(np.int64)
            v0 = (i0 - 1 >= 0) & (i0 - 1 < n)
            v1 = (i0 >= 0) & (i0 < n)
            x0 = np.where(v0, s[np.clip(i0 - 1, 0, n - 1), ch], 0.0)
            x1 = np.where(v1, s[np.clip(i0, 0, n - 1), ch], 0.0)
            out[:, ch] += wv * (x0 * fr + x1 * (1.0 - fr))
    return _to_int(out.astype(np.float32), width)


# ---------------------------------------------------------------------------
# Impulse-response convolution
# ---------------------------------------------------------------------------

def convolve(frames: np.ndarray, width: int, ir: np.ndarray, ir_width: int,
             wet: float = 1.0, dry: float = 0.0) -> np.ndarray:
    """Full convolution with a normalized impulse response:

        y = dry * pad(s, m-1) + wet * (s * ir_norm)    (length n + m - 1)

    where ir_norm = f32(ir)/maxval(ir_width).  A mono IR applies to every
    channel; a stereo IR convolves channel-wise with a stereo signal.
    Oracle math is f64 direct convolution; the device twin uses f32 FFT
    convolution — agreed budget <= max(8 LSB, 1e-4 * peak) at 16-bit.
    """
    n, nch = frames.shape
    m = ir.shape[0]
    s = _norm(frames, width).astype(np.float64)
    irn = (ir.astype(np.float64) / MAXVAL[ir_width])
    if irn.ndim == 1:
        irn = irn[:, None]
    out = np.zeros((n + m - 1, nch), np.float64)
    for ch in range(nch):
        kern = irn[:, ch] if irn.shape[1] == nch else irn[:, 0]
        out[:, ch] = np.float64(wet) * np.convolve(s[:, ch], kern)
        out[:n, ch] += np.float64(dry) * s[:, ch]
    return _to_int(out.astype(np.float32), width)


# ---------------------------------------------------------------------------
# Phase-vocoder time stretch (and pitch shift via stretch + exact ratecv)
# ---------------------------------------------------------------------------

def stretch_grid(n: int, factor: float, frame: int,
                 hop: int) -> Tuple[np.ndarray, int]:
    """(analysis start positions [T], target output length) — computed once
    in f64 host math and shared VERBATIM by both evaluators.

    Synthesis frames sit at j*hop; analysis frames are anchored at both
    ends of the input (0 and n_pad-frame) and rounded to integers, so the
    per-step analysis hop varies by ±1 around hop/factor.  ``last`` is
    floored at T-1 so every analysis hop is >= 1 even when the input is
    shorter than one FFT frame (a zero hop would divide by zero in the
    phase rescale and emit NaN audio — the short frames just read into the
    zero padding)."""
    target = max(int(round(n * factor)), 1)
    T = max(2, -(-(target - frame) // hop) + 1)
    n_pad = max(n, frame)
    last = max(n_pad - frame, T - 1)
    starts = np.rint(np.arange(T, dtype=np.float64)
                     * (last / (T - 1))).astype(np.int64)
    return starts, target


def _princarg(x: np.ndarray) -> np.ndarray:
    two_pi = 2.0 * np.pi
    return x - two_pi * np.round(x / two_pi)


def stretch(frames: np.ndarray, width: int, factor: float,
            frame: int = 2048, hop: int = 512) -> np.ndarray:
    """Phase-vocoder time stretch by ``factor`` (pitch preserved): Hann
    STFT on the shared analysis grid, per-bin instantaneous-frequency
    phase propagation rescaled to the synthesis hop, Hann overlap-add
    resynthesis normalized by the exact window-square overlap.

    This oracle (f64 FFT/atan2/cumsum) IS the spec; the device twin runs
    the same algorithm in f32 with batched device FFTs.  Phases accumulate
    over frames, so the agreed budget is generous: <= 64 LSB at 16-bit
    (about -54 dB) for programme material — the PV is a creative effect,
    not a bit-exact op like the rest of the Sample set.
    """
    n, nch = frames.shape
    starts, target = stretch_grid(n, factor, frame, hop)
    T = len(starts)
    n_pad = max(n, int(starts[-1]) + frame)
    s = np.zeros((n_pad, nch), np.float64)
    s[:n] = _norm(frames, width).astype(np.float64)
    win = np.hanning(frame + 1)[:frame]          # periodic Hann
    K = frame // 2 + 1
    omega = 2.0 * np.pi * np.arange(K) / frame   # rad/sample per bin
    out_len = (T - 1) * hop + frame
    out = np.zeros((out_len, nch), np.float64)
    wsum = np.zeros(out_len, np.float64)
    for j in range(T):
        wsum[j * hop:j * hop + frame] += win * win
    for ch in range(nch):
        seg = np.stack([s[p:p + frame, ch] for p in starts]) * win
        spec = np.fft.rfft(seg, axis=1)                    # [T, K]
        mag = np.abs(spec)
        phi = np.angle(spec)
        hops = np.diff(starts).astype(np.float64)          # [T-1]
        dphi = phi[1:] - phi[:-1] - omega[None, :] * hops[:, None]
        adv = omega[None, :] * hops[:, None] + _princarg(dphi)
        adv_syn = adv * (hop / hops)[:, None]
        psi = np.concatenate([phi[:1], phi[:1] + np.cumsum(adv_syn, axis=0)])
        spec_s = mag * np.exp(1j * psi)
        seg_s = np.fft.irfft(spec_s, n=frame, axis=1) * win
        for j in range(T):
            out[j * hop:j * hop + frame, ch] += seg_s[j]
    out /= np.maximum(wsum, 1e-8)[:, None]
    if target > out_len:
        out = np.concatenate([out, np.zeros((target - out_len, nch))])
    return _to_int(out[:target].astype(np.float32), width)


# ---------------------------------------------------------------------------
# Sample-level biquad filter & noise gate
# ---------------------------------------------------------------------------

def biquad_filter(frames: np.ndarray, width: int, samplerate: int,
                  kind: str, cutoff: float, q: float = 0.7071) -> np.ndarray:
    """RBJ biquad on PCM (channels independent, zero initial state):

        y_n = b0 x_n + b1 x_{n-1} + b2 x_{n-2} - a1 y_{n-1} - a2 y_{n-2}

    on the normalized f32 signal, coefficients from the frozen
    goldref.spec.biquad_coeffs; output via the synthesis rule.  The oracle
    recurrence runs in SEQUENTIAL f64 — the arbiter for the device's
    parallel companion-matrix scan, same budget as the graph Biquad node
    (a few LSB; up to ~16 LSB near the unit circle at q >~ 8)."""
    from .spec import biquad_coeffs
    return biquad_seq_coeffs(frames, width,
                             biquad_coeffs(kind, cutoff, q, samplerate))


def biquad_seq_coeffs(frames: np.ndarray, width: int,
                      coeffs) -> np.ndarray:
    """The sequential-f64 biquad arbiter with explicit normalized
    (b0, b1, b2, a1, a2) — shared by :func:`biquad_filter` and the
    parametric-EQ oracle."""
    b0, b1, b2, a1, a2 = coeffs
    s = _norm(frames, width).astype(np.float64)
    n, nch = s.shape
    out = np.empty_like(s)
    for ch in range(nch):
        x1 = x2 = y1 = y2 = 0.0
        x = s[:, ch]
        for i in range(n):
            y = b0 * x[i] + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
            x2, x1 = x1, x[i]
            y2, y1 = y1, y
            out[i, ch] = y
    return _to_int(out.astype(np.float32), width)


def eq_swept(frames: np.ndarray, width: int, samplerate: int, kind: str,
             freq: float, q: float, gains_db: np.ndarray,
             grids_dtype=None) -> np.ndarray:
    """One EQ band with a per-frame gain curve: the sequential-f64
    recurrence driven by the shared per-frame coefficient grids
    (goldref.spec.eq_coeff_grids — the recurrence-internal-automation
    rule: grids are derived on host in f64 and BOTH evaluators consume
    the same grids; ``grids_dtype`` matches the evaluator under test —
    f32 for the plain scan, float64 for the compensated float-float
    path, whose coefficients are f64-split pairs)."""
    from .spec import eq_coeff_grids
    b0, b1, b2, a1, a2 = (np.asarray(g, np.float64) for g in
                          eq_coeff_grids(kind, freq, gains_db, q,
                                         samplerate, dtype=grids_dtype))
    s = _norm(frames, width).astype(np.float64)
    n, nch = s.shape
    out = np.empty_like(s)
    for ch in range(nch):
        x1 = x2 = y1 = y2 = 0.0
        x = s[:, ch]
        for i in range(n):
            y = (b0[i] * x[i] + b1[i] * x1 + b2[i] * x2
                 - a1[i] * y1 - a2[i] * y2)
            x2, x1 = x1, x[i]
            y2, y1 = y1, y
            out[i, ch] = y
    return _to_int(out.astype(np.float32), width)


def filter_swept_freq(frames: np.ndarray, width: int, samplerate: int,
                      kind: str, q: float, gain_db: float,
                      freqs: np.ndarray, grids_dtype=None) -> np.ndarray:
    """A gain-kind biquad whose corner/center FREQUENCY follows a
    per-frame curve (fx.filter.cutoff on shelving/peaking kinds): the
    sequential-f64 recurrence driven by the shared frequency-varying
    grids (goldref.spec.eq_freqs_coeff_grids)."""
    from .spec import eq_freqs_coeff_grids
    b0, b1, b2, a1, a2 = (np.asarray(g, np.float64) for g in
                          eq_freqs_coeff_grids(kind, freqs, gain_db, q,
                                               samplerate,
                                               dtype=grids_dtype))
    s = _norm(frames, width).astype(np.float64)
    n, nch = s.shape
    out = np.empty_like(s)
    for ch in range(nch):
        x1 = x2 = y1 = y2 = 0.0
        x = s[:, ch]
        for i in range(n):
            y = (b0[i] * x[i] + b1[i] * x1 + b2[i] * x2
                 - a1[i] * y1 - a2[i] * y2)
            x2, x1 = x1, x[i]
            y2, y1 = y1, y
            out[i, ch] = y
    return _to_int(out.astype(np.float32), width)


def eq(frames: np.ndarray, width: int, samplerate: int,
       bands) -> np.ndarray:
    """Parametric-EQ oracle: each ``(kind, freq, gain_db, q)`` band runs
    the sequential biquad with the oracle's own
    :func:`goldref.spec.eq_band_coeffs`, round-tripping through int PCM
    between bands (matching the product's chain of staged per-band
    biquad ops)."""
    from .spec import eq_band_coeffs
    out = frames
    for kind, freq, gain_db, q in bands:
        out = biquad_seq_coeffs(
            out, width, eq_band_coeffs(kind, freq, gain_db, q, samplerate))
    return out


def _biquad_seq_f64(s: np.ndarray, coeffs) -> np.ndarray:
    """Pure-f64 sequential biquad on a normalized [n, ch] signal (no int
    round trip) — the loudness oracle's K-weighting stage."""
    b0, b1, b2, a1, a2 = coeffs
    n, nch = s.shape
    out = np.empty_like(s)
    for ch in range(nch):
        x1 = x2 = y1 = y2 = 0.0
        x = s[:, ch]
        for i in range(n):
            y = b0 * x[i] + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
            x2, x1 = x1, x[i]
            y2, y1 = y1, y
            out[i, ch] = y
    return out


def loudness_lufs(frames: np.ndarray, width: int,
                  samplerate: int) -> float:
    """Integrated programme loudness (LUFS) per ITU-R BS.1770-4, pure
    host f64: K-weighting (goldref.spec.kweight_coeffs, sequential
    biquads), 400 ms gating blocks at 75 % overlap, -70 LUFS absolute
    gate then the -10 LU relative gate.  Channel weights 1.0 (the
    pipeline is mono/stereo).  -inf when no block survives."""
    from .spec import kweight_coeffs
    s = _norm(frames, width).astype(np.float64)
    for coeffs in kweight_coeffs(samplerate):
        s = _biquad_seq_f64(s, coeffs)
    hop = int(round(0.1 * samplerate))
    th = s.shape[0] // hop
    nblocks = th - 3
    if nblocks <= 0:
        return float("-inf")
    hs = (s[:th * hop] ** 2).reshape(th, hop, s.shape[1]).sum(axis=1)
    zsum = sum(hs[k:k + nblocks] for k in range(4)).sum(axis=1) \
        / (4 * hop)
    lj = -0.691 + 10.0 * np.log10(np.maximum(zsum, 1e-300))
    keep = lj > -70.0
    if not keep.any():
        return float("-inf")
    gamma = -0.691 + 10.0 * np.log10(zsum[keep].mean()) - 10.0
    keep &= lj > gamma
    if not keep.any():
        return float("-inf")
    return float(-0.691 + 10.0 * np.log10(zsum[keep].mean()))


def _kweighted_hop_sums_f64(frames: np.ndarray, width: int,
                            samplerate: int):
    """([hops, ch] f64 K-weighted energy sums over 100 ms hops, hop)."""
    from .spec import kweight_coeffs
    s = _norm(frames, width).astype(np.float64)
    for coeffs in kweight_coeffs(samplerate):
        s = _biquad_seq_f64(s, coeffs)
    hop = int(round(0.1 * samplerate))
    th = s.shape[0] // hop
    hs = (s[:th * hop] ** 2).reshape(th, hop, s.shape[1]).sum(axis=1)
    return hs, hop


def _window_loudness_f64(hs: np.ndarray, hop: int,
                         window_hops: int) -> np.ndarray:
    h1 = hs.sum(axis=1)
    n = h1.shape[0] - (window_hops - 1)
    if n <= 0:
        return np.zeros(0, np.float64)
    c = np.concatenate([[0.0], np.cumsum(h1)])
    z = (c[window_hops:] - c[:n]) / (window_hops * hop)
    return -0.691 + 10.0 * np.log10(np.maximum(z, 1e-300))


def loudness_stats(frames: np.ndarray, width: int,
                   samplerate: int) -> dict:
    """EBU R128 meter-set oracle, pure host f64: integrated (BS.1770-4
    gating), LRA (Tech 3342: p95 - p10 of the 3 s short-term
    distribution after -70 LUFS absolute and -20 LU relative gates),
    momentary (400 ms) and short-term maxima."""
    hs, hop = _kweighted_hop_sums_f64(frames, width, samplerate)
    nblocks = hs.shape[0] - 3
    if nblocks <= 0:
        integrated = float("-inf")
    else:
        zsum = sum(hs[k:k + nblocks] for k in range(4)).sum(axis=1) \
            / (4 * hop)
        lj = -0.691 + 10.0 * np.log10(np.maximum(zsum, 1e-300))
        keep = lj > -70.0
        if not keep.any():
            integrated = float("-inf")
        else:
            gamma = -0.691 + 10.0 * np.log10(zsum[keep].mean()) - 10.0
            keep &= lj > gamma
            integrated = float("-inf") if not keep.any() else \
                float(-0.691 + 10.0 * np.log10(zsum[keep].mean()))
    mom = _window_loudness_f64(hs, hop, 4)
    st = _window_loudness_f64(hs, hop, 30)
    stg = st[st > -70.0]
    if stg.size == 0:
        lra = 0.0
    else:
        mean_lufs = 10.0 * np.log10(np.mean(10.0 ** (stg / 10.0)))
        stg = stg[stg > mean_lufs - 20.0]
        lra = 0.0 if stg.size < 2 else \
            float(np.percentile(stg, 95.0) - np.percentile(stg, 10.0))
    return dict(
        integrated=integrated,
        lra=lra,
        momentary_max=float(mom.max()) if mom.size else float("-inf"),
        short_term_max=float(st.max()) if st.size else float("-inf"),
    )


def true_peak_dbtp(frames: np.ndarray, width: int,
                   samplerate: int) -> float:
    """True peak (dBTP) per BS.1770-4 Annex 2, pure host f64: 4x
    oversample by zero-stuffed convolution with the polyphase
    interpolation FIR (goldref.spec.true_peak_filter), max |y| with the
    sampled peak included.  -inf for silence."""
    from .spec import true_peak_filter
    s = _norm(frames, width).astype(np.float64)
    if s.shape[0] == 0:
        return float("-inf")
    h = true_peak_filter()
    peak = float(np.abs(s).max())
    for ch in range(s.shape[1]):
        up = np.zeros(s.shape[0] * 4, np.float64)
        up[::4] = s[:, ch]
        peak = max(peak, float(np.abs(np.convolve(up, h)).max()))
    if peak <= 0.0:
        return float("-inf")
    return 20.0 * math.log10(peak)


def gate_coeffs(samplerate: int, attack: float, release: float,
                range_db: float) -> Tuple[float, float, float]:
    """(alpha, decay, floor_gain) for the gate — host f64, shared."""
    alpha, decay = compressor_coeffs(samplerate, attack, release)
    floor_gain = float(np.exp2(np.float32(-abs(range_db))
                               / np.float32(6.0206)))
    return alpha, decay, floor_gain


def gate_gains(frames: np.ndarray, width: int, samplerate: int,
               threshold_db: float, range_db: float, attack: float,
               release: float) -> np.ndarray:
    """Noise-gate gain curve.  Spec (f32 per-sample math):

    * detector: the compressor's decaying-max envelope (e_{-1} = 0), with
      ``release`` as the decay time (doubling as gate hold);
    * target: g_n = 1 when 20*log10(max(e,1e-10)) >= threshold_db, else
      floor_gain = 2^(-|range_db|/6.0206);
    * smoother: z_n = z_{n-1} + alpha (g_n - z_{n-1}), z_{-1} = floor_gain
      (a stream starts closed).

    Applied with the house gain rule.  Device budget: <= 2 LSB (parallel
    scan regrouping, like the compressor).
    """
    alpha, decay, floor_gain = gate_coeffs(samplerate, attack, release,
                                           range_db)
    a = np.max(np.abs(_norm(frames, width)), axis=1).astype(np.float32)
    thr = np.float32(threshold_db)
    n = a.shape[0]
    gains = np.empty(n, np.float32)
    e = np.float32(0.0)
    z = np.float32(floor_gain)
    dec = np.float32(decay)
    al = np.float32(alpha)
    fg = np.float32(floor_gain)
    for i in range(n):
        e = max(a[i], np.float32(e * dec))
        level_db = np.float32(20.0) * np.float32(
            np.log10(max(e, np.float32(1e-10))))
        g = np.float32(1.0) if level_db >= thr else fg
        z = np.float32(z + al * np.float32(g - z))
        gains[i] = z
    return gains


def gate(frames: np.ndarray, width: int, samplerate: int,
         threshold_db: float = -50.0, range_db: float = 80.0,
         attack: float = 0.001, release: float = 0.05) -> np.ndarray:
    """Apply the noise gate (house gain rule)."""
    g = gate_gains(frames, width, samplerate, threshold_db, range_db,
                   attack, release)
    return _gain_floor(frames, g[:, None], width)


# ---------------------------------------------------------------------------
# Granular synthesis
# ---------------------------------------------------------------------------

def grain_grid(n_in: int, samplerate: int, duration: float, grain: float,
               density: float, jitter: float, seed: int):
    """(in_pos [G], out_pos [G], grain_len, out_len) — host integer math
    shared VERBATIM by both evaluators (like stretch_grid).

    Grains land at regular output positions (density per second); each
    reads a Hann-windowed slice whose input position walks the source
    start-to-end, displaced by a deterministic jitter from the house
    counter hash (goldref.osc.noise_u32): j_g = (h_g/2^31 - 1) in [-1, 1).
    """
    from .osc import noise_u32
    out_len = max(int(duration * samplerate), 1)
    L = max(int(grain * samplerate), 2)
    G = max(int(duration * density), 1)
    out_pos = (np.arange(G, dtype=np.float64)
               * (samplerate / density)).astype(np.int64)
    span = max(n_in - L, 0)
    prog = np.rint(np.arange(G, dtype=np.float64)
                   * (span / max(G - 1, 1))).astype(np.int64)
    h = noise_u32(np.arange(G, dtype=np.uint64), seed)
    j = (h.astype(np.float64) / 2147483648.0 - 1.0) * jitter * samplerate
    in_pos = np.clip(prog + np.rint(j).astype(np.int64), 0, span)
    return in_pos, out_pos, L, out_len


def granulate(frames: np.ndarray, width: int, samplerate: int,
              duration: float, grain: float = 0.05, density: float = 25.0,
              jitter: float = 0.02, amplitude: float = 0.7,
              seed: int = 0) -> np.ndarray:
    """Granular resynthesis: scatter Hann-windowed grains of the source
    onto a ``duration``-second canvas (grain_grid defines every position).

        out[p_g + i] += amplitude * win_i * s[q_g + i]      (f32)

    Output via the synthesis rule, length duration*sr.  Device twin: one
    [G, L] gather + window multiply + scatter-add; budget <= 2 LSB at
    16-bit per unit of overlap (add-order regrouping only — positions are
    shared host integers)."""
    n, nch = frames.shape
    in_pos, out_pos, L, out_len = grain_grid(n, samplerate, duration, grain,
                                             density, jitter, seed)
    s = np.zeros((max(n, L), nch), np.float32)
    s[:n] = _norm(frames, width)
    win = (np.hanning(L + 1)[:L] * amplitude).astype(np.float32)
    out = np.zeros((out_len, nch), np.float64)
    for q, p in zip(in_pos, out_pos):
        m = min(L, out_len - p)
        if m <= 0:
            continue
        out[p:p + m] += (s[q:q + m] * win[:m, None]).astype(np.float64)
    return _to_int(out.astype(np.float32), width)


# ---------------------------------------------------------------------------
# Feedback echo ([fx] echo / Sample.feedback_echo)
# ---------------------------------------------------------------------------

def feedback_echo(frames: np.ndarray, width: int, samplerate: int,
                  delay: float, feedback: float = 0.4, wet: float = 0.5,
                  dry: float = 1.0, tail_frames: int = 0,
                  feedback_curve: "np.ndarray" = None,
                  wet_curve: "np.ndarray" = None,
                  dry_curve: "np.ndarray" = None) -> np.ndarray:
    """Feedback delay line (the chain generalization of the reference's
    feed-forward ``Sample.echo`` — an infinite geometric echo train).  With
    D = int(delay*samplerate) >= 1 (the house frames spec) and the input
    zero-padded by ``tail_frames``:

        d_n = s_n + fb_n * d_{n-D}        (f32; d_{n<0} = 0)
        e_n = d_{n-D}                     (first echo at D, k-th at k*D
                                           with amplitude fb^{k-1})
        out = dry_n * s_n + wet_n * e_n   (f32)

    Output = clip(rint(out * maxval)), length n + tail_frames.  Channels
    are independent.  ``feedback_curve``/``wet_curve``/``dry_curve`` are
    optional per-frame f32 grids (fx.echo.* automation) replacing the
    static knobs.  Device twin: the same recurrence evaluated blockwise
    (a lax.scan over length-D blocks — identical arithmetic order per
    element, no regrouping); agreed budget <= 1 LSB at 16-bit (the FMA
    contraction class on s + fb*d)."""
    D = max(1, int(delay * samplerate))
    n, nch = frames.shape
    total = n + int(tail_frames)
    s = np.zeros((total, nch), np.float32)
    s[:n] = _norm(frames, width)
    fb = np.broadcast_to(np.asarray(
        feedback_curve if feedback_curve is not None else feedback,
        np.float32), (total,))
    wetv = np.broadcast_to(np.asarray(
        wet_curve if wet_curve is not None else wet, np.float32), (total,))
    dryv = np.broadcast_to(np.asarray(
        dry_curve if dry_curve is not None else dry, np.float32), (total,))
    d = np.zeros((total, nch), np.float32)
    for i in range(total):
        prev = d[i - D] if i >= D else np.zeros(nch, np.float32)
        d[i] = (s[i] + fb[i] * prev).astype(np.float32)
    e = np.zeros((total, nch), np.float32)
    e[D:] = d[:-D] if total > D else e[D:]
    out = dryv[:, None] * s + wetv[:, None] * e
    return _to_int(out.astype(np.float32), width)


def echo_tail_frames(samplerate: int, delay: float, feedback: float,
                     wet: float, tail: float = None) -> int:
    """The chain's decay-room rule for the feedback echo: an explicit
    ``tail`` wins; otherwise enough whole echo periods for the echo train
    to fall below 1 LSB at 16-bit (wet * fb^{k-1} < 1/32768), capped at
    10 s.  Shared verbatim by goldref and the product
    (synthesizer_tpu.ops.coeffs.echo_tail_frames — conformance-pinned)."""
    D = max(1, int(delay * samplerate))
    if tail is not None:
        return int(tail * samplerate)
    w = max(abs(wet), 1e-9)
    fb = min(abs(feedback), 0.98)
    if w * 32768.0 <= 1.0:
        return 0
    if fb <= 1e-9:
        k = 1
    else:
        k = 1 + int(math.ceil(math.log(1.0 / (w * 32768.0))
                              / math.log(fb)))
    return min(k * D, 10 * samplerate)


# ---------------------------------------------------------------------------
# Stereo width ([fx] width / Sample.stereo_width)
# ---------------------------------------------------------------------------

def stereo_width(frames: np.ndarray, width: int, amount) -> np.ndarray:
    """Mid/side stereo-width control on a STEREO signal:

        m_n = 0.5*(L_n + R_n);  sd_n = 0.5*(L_n - R_n)      (f32)
        L'_n = m_n + amount_n * sd_n;  R'_n = m_n - amount_n * sd_n

    amount 0 collapses to mono, 1 is unity, >1 widens.  ``amount`` may be
    a scalar or a per-frame f32 grid (fx.width.amount automation).
    Output = clip(rint(out * maxval)).  Device twin budget <= 1 LSB at
    16-bit (FMA contraction on m + a*sd)."""
    if frames.shape[1] != 2:
        raise ValueError("stereo_width needs a stereo signal")
    s = _norm(frames, width)
    a = np.broadcast_to(np.asarray(amount, np.float32),
                        (frames.shape[0],)).astype(np.float32)
    m = (np.float32(0.5) * (s[:, 0] + s[:, 1])).astype(np.float32)
    sd = (np.float32(0.5) * (s[:, 0] - s[:, 1])).astype(np.float32)
    out = np.stack([m + a * sd, m - a * sd], axis=1)
    return _to_int(out.astype(np.float32), width)


# ---------------------------------------------------------------------------
# Lookahead brickwall limiter ([fx] limiter / Sample.limit)
# ---------------------------------------------------------------------------

def limiter_gains(frames: np.ndarray, width: int, samplerate: int,
                  ceiling_db, release: float,
                  lookahead: float) -> np.ndarray:
    """Per-sample gain curve of the lookahead brickwall limiter.  Spec
    (all per-sample math float32, channels linked):

    * detector        a_n = max over channels of |s_n|;
    * overshoot (dB)  need_n = max(0, 20*log10(max(a_n, 1e-10)) - ceil_db)
      (``ceiling_db`` may be a per-frame grid — fx.limiter.ceiling_db);
    * lookahead max   w_n = max(need_n .. need_{n+L}) with
      L = max(1, int(lookahead*samplerate)) — the gain starts dipping L
      frames BEFORE a peak arrives (need past the end is 0);
    * release         R_n = max(w_n, R_{n-1} * decay_n), R_{-1} = 0, with
      decay_n = exp(-1/(release_n*sr)) (release <= 0 -> 0): the reduction
      decays exponentially in dB — an associative decaying max, which is
      what makes the device twin a parallel scan (``release`` may be a
      per-frame grid — fx.limiter.release automation; the decay mapping
      is the compressor's, host f64);
    * gain            g_n = exp2(-R_n / 6.0206);
    * attack ramp     gs_n = mean(g_{n-L} .. g_n) (g_{k<0} = 1) — a box
      FIR whose window equals the lookahead, so gs reaches the full
      reduction exactly when the peak arrives.

    Device twin budget: |gain| <= 2e-6 absolute (f32 log/exp ulp + scan
    regrouping), <= 2 LSB after application at 16-bit."""
    L = max(1, int(lookahead * samplerate))
    n = frames.shape[0]
    if np.ndim(release) == 0:
        decay = np.full(n, np.float32(
            0.0 if release <= 0
            else math.exp(-1.0 / (release * samplerate))), np.float32)
    else:
        # per-frame grid: the compressor's vectorized decay mapping
        rel = np.asarray(release, np.float64)
        decay = np.where(rel <= 0, 0.0,
                         np.exp(-1.0 / (np.maximum(rel, 1e-300)
                                        * samplerate))).astype(np.float32)
    a = np.max(np.abs(_norm(frames, width)), axis=1).astype(np.float32)
    ceil_v = np.broadcast_to(np.asarray(ceiling_db, np.float32), (n,))
    level_db = (np.float32(20.0)
                * np.log10(np.maximum(a, np.float32(1e-10)))).astype(
                    np.float32)
    need = np.maximum(np.float32(0.0), level_db - ceil_v).astype(np.float32)
    padded = np.concatenate([need, np.zeros(L, np.float32)])
    w = np.empty(n, np.float32)
    for i in range(n):
        w[i] = padded[i:i + L + 1].max()
    R = np.empty(n, np.float32)
    r = np.float32(0.0)
    for i in range(n):
        r = max(w[i], np.float32(r * decay[i]))
        R[i] = r
    g = np.exp2((-R * np.float32(1.0 / 6.0206)).astype(np.float32)) \
        .astype(np.float32)
    gpad = np.concatenate([np.ones(L, np.float32), g])
    gs = np.empty(n, np.float32)
    inv = np.float32(1.0 / (L + 1))
    for i in range(n):
        gs[i] = np.float32(np.sum(gpad[i:i + L + 1], dtype=np.float32)
                           * inv)
    return gs


def limiter(frames: np.ndarray, width: int, samplerate: int,
            ceiling_db=-1.0, release: float = 0.05,
            lookahead: float = 0.005) -> np.ndarray:
    """Apply the limiter: the house gain rule floor(f32(x) * f32(gs)),
    then a hard integer clamp at C = rint(exp2(ceil_db/6.0206) * maxval)
    (per-frame when ``ceiling_db`` is a grid) — true brickwall even where
    the box ramp is still converging.  Length preserved."""
    gs = limiter_gains(frames, width, samplerate, ceiling_db, release,
                       lookahead)
    y = _gain_floor(frames, gs[:, None], width).astype(np.int64)
    ceil_v = np.broadcast_to(np.asarray(ceiling_db, np.float32),
                             (frames.shape[0],))
    c = np.rint(np.exp2((ceil_v * np.float32(1.0 / 6.0206)).astype(
        np.float32)).astype(np.float64) * MAXVAL[width]).astype(np.int64)
    out = np.clip(y, -c[:, None], c[:, None])
    return out.astype(_DTYPES[width])


# ---------------------------------------------------------------------------
# Phaser ([fx] phaser / Sample.phaser)
# ---------------------------------------------------------------------------

def phaser(frames: np.ndarray, width: int, samplerate: int,
           rate: float = 0.5, depth: float = 1.0, min_freq: float = 300.0,
           max_freq: float = 3000.0, stages: int = 4, q: float = 0.7071,
           wet: float = 0.5, dry: float = 1.0,
           wet_curve: "np.ndarray" = None,
           dry_curve: "np.ndarray" = None, n0: int = 0,
           grids_dtype=None, P: "np.ndarray" = None,
           depth_curve: "np.ndarray" = None) -> np.ndarray:
    """LFO-swept allpass cascade: ``stages`` identical second-order RBJ
    allpass filters whose center frequency sweeps exponentially between
    ``min_freq`` and ``max_freq`` under the house integer-DDS LFO
    (goldref.spec.phaser_coeff_grids — the grids are host-derived and
    shared by BOTH evaluators at absolute frames, so offline == streaming
    by construction).  The cascade runs in float end to end (ONE int
    quantization at the output):

        y^(0) = s;  y^(k) = allpass(y^(k-1), coeffs_n)   k = 1..stages
        out_n = dry_n * s_n + wet_n * y^(stages)_n

    Oracle recurrences in f64 over the f32 grids; device twin runs
    ``stages`` chained companion scans (f32) in one program.  Agreed
    budget <= 2 + 2*stages LSB at 16-bit at q <= 1 and min_freq >= 50
    (per-stage scan drift compounds through the unity-gain cascade)."""
    from .spec import phaser_coeff_grids, phaser_coeff_grids_swept
    n, nch = frames.shape
    if P is not None or depth_curve is not None:
        # rate/depth automation (fx.phaser.rate/.depth): shared cumulative
        # u32 phase + per-frame depth grid — the chorus_swept rule
        if P is None:
            inc = int(round(rate / samplerate * 4294967296.0)) & 0xFFFFFFFF
            P = (np.arange(n0, n0 + n, dtype=np.uint64) * np.uint64(inc)) \
                & np.uint64(0xFFFFFFFF)
        dg = (np.asarray(depth_curve, np.float64)
              if depth_curve is not None else np.full(n, float(depth)))
        grids = phaser_coeff_grids_swept(P, dg, min_freq, max_freq, q,
                                         samplerate,
                                         dtype=grids_dtype or np.float32)
    else:
        grids = phaser_coeff_grids(n0, n, samplerate, rate, depth,
                                   min_freq, max_freq, q,
                                   dtype=grids_dtype or np.float32)
    b0, b1, b2, a1, a2 = (np.asarray(g, np.float64) for g in grids)
    s = _norm(frames, width).astype(np.float64)
    y = s
    for _ in range(int(stages)):
        nxt = np.empty_like(y)
        for ch in range(nch):
            x1 = x2 = y1 = y2 = 0.0
            x = y[:, ch]
            for i in range(n):
                v = (b0[i] * x[i] + b1[i] * x1 + b2[i] * x2
                     - a1[i] * y1 - a2[i] * y2)
                x2, x1 = x1, x[i]
                y2, y1 = y1, v
                nxt[i, ch] = v
        y = nxt
    wetv = np.broadcast_to(np.asarray(
        wet_curve if wet_curve is not None else wet, np.float64), (n,))
    dryv = np.broadcast_to(np.asarray(
        dry_curve if dry_curve is not None else dry, np.float64), (n,))
    out = dryv[:, None] * s + wetv[:, None] * y
    return _to_int(out.astype(np.float32), width)


# ---------------------------------------------------------------------------
# High-quality polyphase resampler (oracle)
# ---------------------------------------------------------------------------

def hq_resample(frames: np.ndarray, width: int, inrate: int,
                outrate: int) -> np.ndarray:
    """Windowed-sinc polyphase rational resampler, sequential f64 oracle.

    Spec (shared with the device twin ops.resample.hq_resample, which is
    ONE strided f32 convolution):

    * reduce the ratio: L = outrate/g, M = inrate/g (g = gcd) — the
      signal is conceptually zero-stuffed by L, filtered by the
      spec.hq_resample_filter prototype h (length N = T*L', centered at
      C = (N-1)//2, per-leg unit DC gain), and decimated by M;
    * output length matches the linear ratecv path exactly:
      nframes_out(n, M, L) = (n-1)*L//M + 1 (n >= 1), so swapping
      quality never changes a Sample's frame count;
    * output j reads phase leg phi = (j*M + C) % L at input anchor
      k0 = (j*M + C) // L:  y[j] = sum_t h[phi + t*L] * s[k0 - t]
      (out-of-range input = 0);
    * the working signal is the house-normalized f32 value promoted to
      f64; the result converts back with the house synthesis rule
      _to_int(f32(y)).

    Tolerance for the device twin (f32 conv, precision=HIGHEST, XLA
    reduction order): <= 1 LSB at width 2 (measured; the per-output dot
    is <= N/L taps of an f32 kernel against |s| <= 1).
    """
    g = math.gcd(int(inrate), int(outrate))
    M, L = int(inrate) // g, int(outrate) // g
    from . import spec as _spec
    h = _spec.hq_resample_filter(L, M)
    n = frames.shape[0]
    if n == 0:
        return frames[:0]
    out_n = (n - 1) * L // M + 1
    C = (len(h) - 1) // 2
    T = len(h) // L
    s = _norm(frames, width).astype(np.float64)
    j = np.arange(out_n, dtype=np.int64)
    phi = (j * M + C) % L
    k0 = (j * M + C) // L
    acc = np.zeros((out_n, frames.shape[1]), np.float64)
    for t in range(T):
        idx = k0 - t
        valid = (idx >= 0) & (idx < n)
        acc += np.where(valid[:, None],
                        h[phi + t * L, None] * s[np.clip(idx, 0, n - 1)],
                        0.0)
    return _to_int(acc.astype(np.float32), width)
