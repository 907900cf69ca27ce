"""Product-owned knob→coefficient tables for the effects rack.

These are the host-side f64 mappings from user-facing effect knobs to the
recurrence coefficients, delay-line tunings, and analysis grids that the
device kernels consume.  They are part of the PRODUCT's frozen numeric
contract: ``goldref`` keeps its *own verbatim copies*
(the oracle may not import the product — goldref/spec.py rule), and
``tests/test_coeffs_conformance.py`` pins the two copies equal over knob
grids, so the differential effect tests actually test the device
recurrences, not shared code.  ``synthesizer_tpu`` deploys without
``goldref`` on the path.

Every function is pure host math (f64 where noted, with the same f32
casts the per-sample specs use) — nothing here touches jax.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = [
    "compressor_coeffs", "gate_coeffs", "biquad_coeffs", "eq_band_coeffs",
    "kweight_coeffs", "true_peak_filter", "hq_resample_filter",
    "reverb_delays", "reverb_params", "FIXED_GAIN", "ALLPASS_FEEDBACK",
    "COMB_TUNING", "ALLPASS_TUNING", "STEREO_SPREAD",
    "stretch_grid", "grain_grid", "noise_u32",
    "curve_grid", "compressor_coeff_grids", "reverb_feedback_grid",
    "chorus_inc_grid", "chorus_phase_grid", "chorus_block_plan",
    "phaser_coeff_grids", "phaser_coeff_grids_swept", "echo_tail_frames",
    "tremolo_gain_grid", "autopan_pan_grid", "static_phase",
]


# ---------------------------------------------------------------------------
# Automation coefficient grids (recurrence-internal automation, round 3)
#
# Breakpoint curves that automate parameters INSIDE a recurrence
# (compressor attack/release, chorus rate/depth, reverb roomsize) are
# evaluated on HOST in f64 at absolute frame positions and shipped to the
# device as f32/u32 coefficient grids — the one evaluation rule shared by
# the offline and streaming paths, so both are bit-identical by
# construction at any chunk size or seek position.
# ---------------------------------------------------------------------------

def curve_grid(points, n0: int, n: int, tickf: float) -> np.ndarray:
    """Evaluate a tick:value breakpoint curve at absolute frames
    [n0, n0+n) — f64 linear interpolation over ticks, ends held (the same
    rule as the device-side jnp.interp curves, but in host f64)."""
    xs = np.asarray([t for t, _ in points], np.float64)
    vs = np.asarray([v for _, v in points], np.float64)
    t = (n0 + np.arange(n, dtype=np.float64)) / float(tickf)
    return np.interp(t, xs, vs)


def compressor_coeff_grids(attack: np.ndarray, release: np.ndarray,
                           samplerate: int):
    """Per-frame (alpha, decay) f32 grids from per-frame attack/release
    values in seconds — the vectorized :func:`compressor_coeffs` (f64,
    same <= 0 -> instant convention)."""
    attack = np.asarray(attack, np.float64)
    release = np.asarray(release, np.float64)
    alpha = np.where(attack <= 0, 1.0,
                     1.0 - np.exp(-1.0 / (np.maximum(attack, 1e-300)
                                          * samplerate)))
    decay = np.where(release <= 0, 0.0,
                     np.exp(-1.0 / (np.maximum(release, 1e-300)
                                    * samplerate)))
    return alpha.astype(np.float32), decay.astype(np.float32)


def reverb_feedback_grid(roomsize: np.ndarray) -> np.ndarray:
    """Per-frame comb feedback f32 grid from per-frame roomsize values
    (the Freeverb mapping's feedback row: 0.7 + 0.28*roomsize)."""
    return (0.7 + 0.28 * np.asarray(roomsize, np.float64)) \
        .astype(np.float32)


def chorus_inc_grid(rate: np.ndarray, samplerate: int) -> np.ndarray:
    """Per-frame LFO DDS increments (u32) from per-frame rates in Hz:
    inc_n = round(rate_n/sr * 2^32) mod 2^32, exact f64 rounding (the
    host-exact-round rule of the static chorus)."""
    inc = np.rint(np.asarray(rate, np.float64) / samplerate
                  * 4294967296.0).astype(np.int64)
    return (inc % (1 << 32)).astype(np.uint32)


def chorus_phase_grid(inc: np.ndarray, p_carry: int):
    """(P [n] u32, new_carry): cumulative LFO phase P_n = p_carry +
    sum_{m<n} inc_m (mod 2^32) — exclusive prefix sum, plus the carry for
    the next chunk.  A constant-rate grid reproduces P_n = n*inc, the
    static chorus phase, bit-exactly."""
    inc = np.asarray(inc, np.uint64)
    csum = np.concatenate([np.zeros(1, np.uint64), np.cumsum(inc)[:-1]]) \
        if len(inc) else np.zeros(0, np.uint64)
    P = ((np.uint64(p_carry & 0xFFFFFFFF) + csum)
         & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    new_carry = int((p_carry + int(inc.sum())) & 0xFFFFFFFF)
    return P, new_carry


def chorus_block_plan(n: int, samplerate: int, rate: float, depth: float,
                      delay: float, voices: int, nch: int,
                      target_taps: int = 12):
    """Host-side blocking plan for the BANDED offline chorus
    (ops.effects.chorus): the static-knob LFO delay curve is a pure host
    function of the absolute frame index (the same property the
    phase-vocoder windows use), so
    per-block window starts are TRACE-TIME CONSTANTS and the per-frame
    modulated gather disappears entirely.

    Within a block of G frames the LFO moves the delay by at most
    ``depth*pi*rate*G`` frames, so G is sized to keep the per-block
    integer-delay spread near ``target_taps``; the device then reads one
    host-anchored window per block (a ~n/G-row sliced gather — hundreds
    of rows) and reduces K+2 static tap
    slices with exact one-hot lerp weights.

    The host mirrors the device delay curve (goldref.effects
    .chorus_delay_f32 spec: exact wrapped-u32 DDS phase, f32 curve
    arithmetic) with np.sin in f64 where the device uses the turn-unit
    minimax poly (max err 7.8e-7), so block bounds carry a conservative
    margin that covers the poly error and every f32 rounding gap.

    Returns ``(G, K, nb, pad0, padtot, starts, dfmax)`` — ``starts`` and
    ``dfmax`` are ``[nch*voices, nb]`` i32 (row order ch-major like the
    device loop), starts already shifted by ``pad0``; the device signal
    must be zero-padded to ``pad0 + n + (padtot - pad0 - n)`` rows.
    """
    # in-block delay spread <= depth*sr * (pi*rate/sr) * G frames; size G
    # so it stays near target_taps, pow2-clamped (small G wastes window
    # rows, huge G re-grows the static tap count)
    move_per_frame = depth * math.pi * max(rate, 1e-9)
    G = 1 << int(np.clip(
        np.log2(max(target_taps / max(move_per_frame, 1e-12), 1.0)), 9, 14))
    nb = -(-n // G)
    # device-vs-host curve gap: turn-unit poly error (7.8e-7 of depth*sr,
    # covered by the 2e-6 term with the signed-vs-unsigned phase-cast gap)
    # + f32 rounding of the device's sum and final *sr product — each
    # rounds at 2^-24 RELATIVE to the curve magnitude (delay + depth), so
    # the bound must scale with delay too (a 5 s delay knob rounds by
    # ~0.05 frames, far past any fixed constant); 4 ulps covers the
    # three rounded f32 ops with headroom
    margin = (0.01 + depth * samplerate * 2e-6
              + (delay + depth) * samplerate * 4.0 * 2.0 ** -24)
    inc = int(round(rate / samplerate * 4294967296.0)) & 0xFFFFFFFF
    idx = np.arange(nb * G, dtype=np.uint64)
    bidx = np.arange(nb, dtype=np.int64) * G
    starts = np.empty((nch * voices, nb), np.int64)
    dfmax = np.empty((nch * voices, nb), np.int64)
    K = 0
    for ch in range(nch):
        for v in range(voices):
            phi = (v / voices + 0.25 * ch) % 1.0
            phase0 = int(round(phi * 4294967296.0)) & 0xFFFFFFFF
            p = (np.uint64(phase0) + idx * np.uint64(inc)) \
                & np.uint64(0xFFFFFFFF)
            x = p.astype(np.float32).astype(np.float64) * 2.0 ** -32
            d = (np.float64(np.float32(delay))
                 + np.float64(np.float32(depth))
                 * (0.5 + 0.5 * np.sin(2.0 * np.pi * x))) * samplerate
            blk = d.reshape(nb, G)
            row = ch * voices + v
            dfmax[row] = np.floor(blk.max(axis=1) + margin).astype(np.int64)
            dfmin_b = np.floor(blk.min(axis=1) - margin).astype(np.int64)
            K = max(K, int((dfmax[row] - dfmin_b).max()))
            starts[row] = bidx - dfmax[row] - 1
    pad0 = int(max(0, -starts.min()))
    starts += pad0
    padtot = int(max(pad0 + n, int(starts.max()) + G + K + 2))
    return (G, K, nb, pad0, padtot,
            starts.astype(np.int32), dfmax.astype(np.int32))


# ---------------------------------------------------------------------------
# Dynamics (compressor / gate)
# ---------------------------------------------------------------------------

def compressor_coeffs(samplerate: int, attack: float,
                      release: float) -> Tuple[float, float]:
    """(alpha, decay) for the peak compressor: attack one-pole alpha and
    release decay-per-sample, host f64.

    attack <= 0 -> alpha 1 (instant); release <= 0 -> decay 0 (instant)."""
    alpha = 1.0 if attack <= 0 else 1.0 - math.exp(-1.0 / (attack * samplerate))
    decay = 0.0 if release <= 0 else math.exp(-1.0 / (release * samplerate))
    return alpha, decay


def gate_coeffs(samplerate: int, attack: float, release: float,
                range_db: float) -> Tuple[float, float, float]:
    """(alpha, decay, floor_gain) for the noise gate: the compressor's
    attack/release coefficients plus the closed-state floor gain
    2^(-|range_db|/6.0206) (the f32 cast matches the per-sample spec)."""
    alpha, decay = compressor_coeffs(samplerate, attack, release)
    floor_gain = float(np.exp2(np.float32(-abs(range_db))
                               / np.float32(6.0206)))
    return alpha, decay, floor_gain


# ---------------------------------------------------------------------------
# RBJ biquad
# ---------------------------------------------------------------------------

def biquad_coeffs(kind: str, cutoff: float, q: float,
                  samplerate: int) -> Tuple[float, float, float, float, float]:
    """RBJ cookbook coefficients (b0, b1, b2, a1, a2), normalized by a0,
    host f64; cutoff clamped to 0.49*samplerate."""
    w0 = 2.0 * math.pi * min(cutoff, samplerate * 0.49) / samplerate
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    if kind == "lowpass":
        b0, b1, b2 = (1 - cw) / 2, 1 - cw, (1 - cw) / 2
    elif kind == "highpass":
        b0, b1, b2 = (1 + cw) / 2, -(1 + cw), (1 + cw) / 2
    elif kind == "bandpass":                # constant 0 dB peak gain
        b0, b1, b2 = alpha, 0.0, -alpha
    else:
        raise ValueError(f"unknown filter kind {kind!r}")
    a0 = 1 + alpha
    return (b0 / a0, b1 / a0, b2 / a0, (-2 * cw) / a0, (1 - alpha) / a0)


def eq_band_coeffs(kind: str, freq: float, gain_db: float, q: float,
                   samplerate: int) -> Tuple[float, float, float, float,
                                             float]:
    """RBJ cookbook shelving/peaking coefficients (b0, b1, b2, a1, a2),
    normalized by a0, host f64 — the parametric-EQ bands.  ``gain_db`` is
    boost (+) or cut (-); A = 10^(gain_db/40) per the cookbook; freq
    clamped to 0.49*samplerate."""
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * math.pi * min(freq, samplerate * 0.49) / samplerate
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    if kind == "peaking":
        b0, b1, b2 = 1 + alpha * A, -2 * cw, 1 - alpha * A
        a0, a1, a2 = 1 + alpha / A, -2 * cw, 1 - alpha / A
    elif kind == "lowshelf":
        sa = 2.0 * math.sqrt(A) * alpha
        b0 = A * ((A + 1) - (A - 1) * cw + sa)
        b1 = 2 * A * ((A - 1) - (A + 1) * cw)
        b2 = A * ((A + 1) - (A - 1) * cw - sa)
        a0 = (A + 1) + (A - 1) * cw + sa
        a1 = -2 * ((A - 1) + (A + 1) * cw)
        a2 = (A + 1) + (A - 1) * cw - sa
    elif kind == "highshelf":
        sa = 2.0 * math.sqrt(A) * alpha
        b0 = A * ((A + 1) + (A - 1) * cw + sa)
        b1 = -2 * A * ((A - 1) + (A + 1) * cw)
        b2 = A * ((A + 1) + (A - 1) * cw - sa)
        a0 = (A + 1) - (A - 1) * cw + sa
        a1 = 2 * ((A - 1) - (A + 1) * cw)
        a2 = (A + 1) - (A - 1) * cw - sa
    else:
        raise ValueError(f"unknown eq band kind {kind!r}")
    return (b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


def eq_coeff_grids(kind: str, freq: float, gains_db: np.ndarray, q: float,
                   samplerate: int, dtype=np.float32):
    """Per-frame (b0, b1, b2, a1, a2) f32 grids from a per-frame gain_db
    array — the vectorized :func:`eq_band_coeffs` (host f64, same
    formulas), for recurrence-internal EQ gain automation.  A constant
    gains_db array reproduces the static coefficients bit-exactly.
    ``dtype=np.float64`` keeps the unrounded grids (the compensated-scan
    path splits them into float-float pairs)."""
    A = 10.0 ** (np.asarray(gains_db, np.float64) / 40.0)
    w0 = 2.0 * math.pi * min(freq, samplerate * 0.49) / samplerate
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    one = np.ones_like(A)
    if kind == "peaking":
        b0, b1, b2 = 1 + alpha * A, -2 * cw * one, 1 - alpha * A
        a0, a1, a2 = 1 + alpha / A, -2 * cw * one, 1 - alpha / A
    elif kind == "lowshelf":
        sa = 2.0 * np.sqrt(A) * alpha
        b0 = A * ((A + 1) - (A - 1) * cw + sa)
        b1 = 2 * A * ((A - 1) - (A + 1) * cw)
        b2 = A * ((A + 1) - (A - 1) * cw - sa)
        a0 = (A + 1) + (A - 1) * cw + sa
        a1 = -2 * ((A - 1) + (A + 1) * cw)
        a2 = (A + 1) + (A - 1) * cw - sa
    elif kind == "highshelf":
        sa = 2.0 * np.sqrt(A) * alpha
        b0 = A * ((A + 1) + (A - 1) * cw + sa)
        b1 = -2 * A * ((A - 1) + (A + 1) * cw)
        b2 = A * ((A + 1) + (A - 1) * cw - sa)
        a0 = (A + 1) - (A - 1) * cw + sa
        a1 = 2 * ((A - 1) - (A + 1) * cw)
        a2 = (A + 1) - (A - 1) * cw - sa
    else:
        raise ValueError(f"unknown eq band kind {kind!r}")
    return tuple(np.asarray(c / a0, dtype)
                 for c in (b0, b1, b2, a1, a2))


def eq_freqs_coeff_grids(kind: str, freqs: np.ndarray, gain_db: float,
                         q: float, samplerate: int, dtype=np.float64):
    """Per-frame (b0, b1, b2, a1, a2) grids from a per-frame FREQUENCY
    array at a static gain — :func:`eq_band_coeffs` vectorized over the
    corner/center frequency (host f64, same formulas), for
    ``fx.filter.cutoff`` automation on the gain kinds (shelves/peaking).
    A constant freqs array reproduces the static coefficients
    bit-exactly."""
    A = 10.0 ** (gain_db / 40.0)
    f = np.minimum(np.asarray(freqs, np.float64), samplerate * 0.49)
    w0 = 2.0 * math.pi * f / samplerate
    alpha = np.sin(w0) / (2.0 * q)
    cw = np.cos(w0)
    if kind == "peaking":
        b0, b1, b2 = 1 + alpha * A, -2 * cw, 1 - alpha * A
        a0, a1, a2 = 1 + alpha / A, -2 * cw, 1 - alpha / A
    elif kind == "lowshelf":
        sa = 2.0 * math.sqrt(A) * alpha
        b0 = A * ((A + 1) - (A - 1) * cw + sa)
        b1 = 2 * A * ((A - 1) - (A + 1) * cw)
        b2 = A * ((A + 1) - (A - 1) * cw - sa)
        a0 = (A + 1) + (A - 1) * cw + sa
        a1 = -2 * ((A - 1) + (A + 1) * cw)
        a2 = (A + 1) + (A - 1) * cw - sa
    elif kind == "highshelf":
        sa = 2.0 * math.sqrt(A) * alpha
        b0 = A * ((A + 1) + (A - 1) * cw + sa)
        b1 = -2 * A * ((A - 1) + (A + 1) * cw)
        b2 = A * ((A + 1) + (A - 1) * cw - sa)
        a0 = (A + 1) - (A - 1) * cw + sa
        a1 = 2 * ((A - 1) - (A + 1) * cw)
        a2 = (A + 1) - (A - 1) * cw - sa
    else:
        raise ValueError(f"unknown eq band kind {kind!r}")
    return tuple(np.asarray(c / a0, dtype)
                 for c in (b0, b1, b2, a1, a2))


# ---------------------------------------------------------------------------
# Compensated-scan routing: which coefficient sets need float-float
# ---------------------------------------------------------------------------

def ff_split(c):
    """Split f64 scalar/array coefficients into a non-overlapping f32
    (hi, lo) pair: hi = fl32(c), lo = fl32(c - hi) — the exact residual
    (representable because it is ~2^-24 of hi).  Consumed by
    ``ops.effects.biquad_apply_ff``."""
    c64 = np.asarray(c, np.float64)
    hi = c64.astype(np.float32)
    lo = (c64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def pole_gain(a1: float, a2: float, ngrid: int = 8192) -> float:
    """max |1/A(e^jw)| over the frequency axis — the factor by which the
    companion scan amplifies an f32 rounding into the filter state (the
    derived conditioning model's Gpole)."""
    w = np.linspace(0.0, np.pi, ngrid)
    z1 = np.exp(-1j * w)
    return float((1.0 / np.abs(1.0 + a1 * z1 + a2 * z1 * z1)).max())


def predicted_scan_error_lsb(coeffs, n: int = 1 << 20) -> float:
    """Host predictor of the plain-f32 companion scan's drift vs the
    sequential recurrence at 16-bit full scale — the derived bound
    err <= 2 + 2*eps*32768*log2(n)*Gpole*sqrt(tau) (independently
    re-derived and measured in tests/test_filters.scan_error_bound_lsb;
    n defaults to a long-programme worst case so the routing decision
    does not depend on signal length)."""
    a1, a2 = float(coeffs[3]), float(coeffs[4])
    r = math.sqrt(max(a2, 0.0))
    tau = 1.0 / max(1.0 - r, 1e-9)
    return 2.0 + 2.0 * 2.0 ** -24 * 32768.0 * math.log2(n) \
        * pole_gain(a1, a2) * math.sqrt(tau)


#: plain-scan drift (LSB) above which the staged/streaming biquads route
#: through the float-float scan
FF_SCAN_THRESHOLD_LSB = 6.0


def wants_ff_scan(coeffs) -> bool:
    """True when ``coeffs`` (f64 (b0, b1, b2, a1, a2)) are conditioned
    badly enough that the plain f32 scan would drift past
    FF_SCAN_THRESHOLD_LSB — route these through biquad_apply_ff."""
    return predicted_scan_error_lsb(coeffs) > FF_SCAN_THRESHOLD_LSB


def biquad_peak_gain(coeffs, ngrid: int = 4096) -> float:
    """max |H(e^jw)| of a biquad over the frequency axis (f64) — the
    steady-state amplification any input perturbation can see through
    the filter.  For swept bands this is the frozen-coefficient bound:
    evaluate at the sweep extremes and take the max."""
    b0, b1, b2, a1, a2 = (float(c) for c in coeffs)
    w = np.linspace(0.0, np.pi, ngrid)
    z = np.exp(-1j * w)
    h = (b0 + b1 * z + b2 * z * z) / (1.0 + a1 * z + a2 * z * z)
    return float(np.abs(h).max())


def master_chain_error_bound(stages, samplerate: int,
                             e_in_lsb: float) -> float:
    """Derived LSB error bound for an input perturbation of ``e_in_lsb``
    (16-bit LSB) through a master fx chain — the mesh swept-chain
    budget, composed the way the scan-conditioning model is:
    per-stage worst-case gain bounds from the ACTUAL parameters, not an
    observed constant.

    ``stages``: ordered (kind, params) pairs; params carry the chain's
    knob EXTREMES (automation endpoints included):

      ("eq_band",  {kind, freq, q, gains_db: [..extremes..]})
      ("echo",     {feedback, wet, dry})        # maxima
      ("phaser",   {stages, q, min_freq, max_freq, wet, dry})  # wet max
      ("width",    {amount})                    # max
      ("limiter",  {})

    Per-stage gains (all steady-state / Lipschitz bounds):
      eq band   max over gain extremes of biquad_peak_gain (peaking tops
                out at 10^(db/20), shelves likewise)
      echo      dry + wet/(1-fb): the feedback resonance's geometric sum
      phaser    dry + wet * 1^stages (allpass |H| == 1); the sweep only
                moves the phase response
      width     max(1, amount): the M/S matrix row-L1 norm
      limiter   2: y = g(p)*x with g = min(1, c/p) gives
                |dy| <= g|dx| + |dg||x|, and |dg||x| <= (c/p^2)|dp|*p
                = g|dp| <= |dx| — box-attack smoothing and the release
                decay are convex combinations, preserving the bound

    Stages re-quantize to int PCM between them (the staged-op
    semantics), so the composition is e := e*g + 0.5 per stage.
    """
    e = float(e_in_lsb)
    for kind, p in stages:
        if kind == "eq_band":
            g = max(biquad_peak_gain(
                eq_band_coeffs(p["kind"], p["freq"], gdb, p["q"],
                               samplerate))
                for gdb in p["gains_db"])
        elif kind == "echo":
            g = p.get("dry", 1.0) + p["wet"] / (1.0 - p["feedback"])
        elif kind == "phaser":
            g = p.get("dry", 1.0) + p["wet"]
        elif kind == "width":
            g = max(1.0, p["amount"])
        elif kind == "limiter":
            g = 2.0
        else:
            raise ValueError(f"unknown master-chain stage {kind!r}")
        e = e * g + 0.5
    return e


# ---------------------------------------------------------------------------
# BS.1770-4 loudness (K-weighting) and true peak
# ---------------------------------------------------------------------------

#: analog-domain parameters that reproduce the ITU-R BS.1770 filter tables
#: (the published 48 kHz coefficients) when re-run through the bilinear
#: transform — the standard re-derivation used to K-weight at any rate.
_KW_SHELF = (1681.974450955533, 3.999843853973347, 0.7071752369554196)
_KW_SHELF_VB_EXP = 0.499666774155
_KW_HIGHPASS = (38.13547087602444, 0.5003270373238773)


def kweight_coeffs(samplerate: int):
    """The two K-weighting stages as normalized (b0, b1, b2, a1, a2)
    biquads, host f64: a +4 dB high shelf (head model, bilinear-
    transformed analog prototype with the band gain Vb = Vh^0.499667)
    then the RLB high-pass with the ITU's unit numerator (1, -2, 1).
    At 48 kHz this reproduces the BS.1770-4 table coefficients to 1e-13
    (pinned in tests/test_loudness.py)."""
    f0, G, Q = _KW_SHELF
    K = math.tan(math.pi * f0 / samplerate)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** _KW_SHELF_VB_EXP
    a0 = 1.0 + K / Q + K * K
    stage1 = ((Vh + Vb * K / Q + K * K) / a0,
              2.0 * (K * K - Vh) / a0,
              (Vh - Vb * K / Q + K * K) / a0,
              2.0 * (K * K - 1.0) / a0,
              (1.0 - K / Q + K * K) / a0)
    f0, Q = _KW_HIGHPASS
    w0 = 2.0 * math.pi * f0 / samplerate
    alpha = math.sin(w0) / (2.0 * Q)
    cw = math.cos(w0)
    a0 = 1.0 + alpha
    stage2 = (1.0, -2.0, 1.0, (-2.0 * cw) / a0, (1.0 - alpha) / a0)
    return stage1, stage2


_TP_PHASES = 4
_TP_TAPS = 48


def true_peak_filter() -> np.ndarray:
    """The 4x-oversampling interpolation FIR for true-peak (dBTP)
    measurement: 48-tap Kaiser(beta=8)-windowed sinc, each polyphase leg
    normalized to unit DC gain, f64.  Consumed zero-stuffed (every 4th
    output sample uses one leg h[p::4])."""
    L, N = _TP_PHASES, _TP_TAPS
    n = np.arange(N, dtype=np.float64)
    x = (n - (N - 1) / 2.0) / L
    h = np.sinc(x) * np.kaiser(N, 8.0)
    for p in range(L):
        h[p::L] /= h[p::L].sum()
    return h


_HQ_TAPS_PER_PHASE = 32
_HQ_BETA = 9.0


def hq_resample_filter(up: int, down: int,
                       taps_per_phase: int = _HQ_TAPS_PER_PHASE,
                       beta: float = _HQ_BETA) -> np.ndarray:
    """Prototype lowpass for the high-quality polyphase resampler
    (``Sample.resample(quality='hq')``): Kaiser(beta)-windowed sinc of
    ``taps_per_phase * up`` taps at the ``up``-times-oversampled rate,
    cutoff at the lower of the input/output Nyquists
    (``min(1/up, 1/down)`` cycles per oversampled sample), each of the
    ``up`` polyphase legs normalized to unit DC gain, f64.  The length
    scales with ``max(up, down)`` (rounded up to a multiple of ``up``) so
    the sinc always spans ``taps_per_phase`` zero crossings of the
    NARROWER Nyquist — a decimator keeps its stopband, not just an
    interpolator.  The oracle keeps its own copy
    (``goldref.spec.hq_resample_filter``, conformance-pinned) — the same
    per-leg-normalization recipe as the BS.1770 true-peak FIR above."""
    L = int(up)
    N = int(taps_per_phase) * max(int(up), int(down))
    N = -(-N // L) * L
    c = min(1.0 / up, 1.0 / down)
    n = np.arange(N, dtype=np.float64)
    x = (n - (N - 1) / 2.0) * c
    h = np.sinc(x) * np.kaiser(N, beta)
    for p in range(L):
        h[p::L] /= h[p::L].sum()
    return h


# ---------------------------------------------------------------------------
# Freeverb tuning
# ---------------------------------------------------------------------------

#: classic Freeverb delay lengths in frames at 44100 Hz
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


# ---------------------------------------------------------------------------
# Analysis grids (phase vocoder / granular)
# ---------------------------------------------------------------------------

def stretch_grid(n: int, factor: float, frame: int,
                 hop: int) -> Tuple[np.ndarray, int]:
    """(analysis start positions [T], target output length) for the
    phase-vocoder stretch — f64 host math, shared by both evaluators.

    Synthesis frames sit at j*hop; analysis frames are anchored at both
    ends of the input (0 and n_pad-frame) and rounded to integers, so the
    per-step analysis hop varies by ±1 around hop/factor.  ``last`` is
    floored at T-1 so every analysis hop is >= 1 even when the input is
    shorter than one FFT frame."""
    target = max(int(round(n * factor)), 1)
    T = max(2, -(-(target - frame) // hop) + 1)
    n_pad = max(n, frame)
    last = max(n_pad - frame, T - 1)
    starts = np.rint(np.arange(T, dtype=np.float64)
                     * (last / (T - 1))).astype(np.int64)
    return starts, target


_U32_MASK = np.uint64(0xFFFFFFFF)


def noise_u32(idx: np.ndarray, seed: int) -> np.ndarray:
    """The house counter hash -> u32 (u32 wrap arithmetic):

    x = idx*0x9E3779B9 + seed; x ^= x>>16; x *= 0x7FEB352D; x ^= x>>15;
    x *= 0x846CA68B; x ^= x>>16
    """
    x = (np.asarray(idx).astype(np.uint64) * np.uint64(0x9E3779B9)
         + np.uint64(seed & 0xFFFFFFFF)) & _U32_MASK
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & _U32_MASK
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & _U32_MASK
    x ^= x >> np.uint64(16)
    return x.astype(np.uint32)


def grain_grid(n_in: int, samplerate: int, duration: float, grain: float,
               density: float, jitter: float, seed: int):
    """(in_pos [G], out_pos [G], grain_len, out_len) for the granulator —
    host integer math shared by both evaluators.

    Grains land at regular output positions (density per second); each
    reads a Hann-windowed slice whose input position walks the source
    start-to-end, displaced by a deterministic jitter from the house
    counter hash: j_g = (h_g/2^31 - 1) in [-1, 1)."""
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


def phaser_coeff_grids(n0: int, n: int, samplerate: int, rate: float,
                       depth: float, min_freq: float, max_freq: float,
                       q: float, dtype=None):
    """Per-frame RBJ ALLPASS (b0, b1, b2, a1, a2) grids for the phaser's
    LFO sweep, evaluated at absolute frames [n0, n0+n) — host f64 over
    the house integer-DDS LFO phase (phase0 = 0):

        inc   = round(rate/sr * 2^32) (wrapped u32)
        p_k   = (n0+k) * inc mod 2^32 ;  x = f32(p_k) * 2^-32
        lfo   = 0.5 + 0.5*sin(2*pi*x)                    (f64)
        pos   = 0.5 + depth*(lfo - 0.5)
        f_k   = min_freq * (max_freq/min_freq)^pos       (exponential sweep)
        w0 = 2*pi*f_k/sr; alpha = sin(w0)/(2q); a0 = 1+alpha
        b = [(1-alpha), -2*cos(w0), (1+alpha)] / a0;  a1 = b1;  a2 = b0

    Verbatim copy of goldref.spec.phaser_coeff_grids (conformance-pinned
    in tests/test_coeffs_conformance.py)."""
    if dtype is None:
        dtype = np.float32
    inc = int(round(rate / samplerate * 4294967296.0)) & 0xFFFFFFFF
    idx = np.arange(n0, n0 + n, dtype=np.uint64)
    p = (idx * np.uint64(inc)) & np.uint64(0xFFFFFFFF)
    x = p.astype(np.float32) * np.float32(2.0 ** -32)
    lfo = 0.5 + 0.5 * np.sin(2.0 * np.pi * x.astype(np.float64))
    pos = 0.5 + float(depth) * (lfo - 0.5)
    f = float(min_freq) * (float(max_freq) / float(min_freq)) ** pos
    w0 = 2.0 * np.pi * np.minimum(f, samplerate * 0.49) / samplerate
    alpha = np.sin(w0) / (2.0 * float(q))
    cw = np.cos(w0)
    a0 = 1.0 + alpha
    b0 = (1.0 - alpha) / a0
    b1 = (-2.0 * cw) / a0
    b2 = (1.0 + alpha) / a0
    return (b0.astype(dtype), b1.astype(dtype), b2.astype(dtype),
            b1.astype(dtype), b0.astype(dtype))


def tremolo_gain_grid(P, depth):
    """Per-frame tremolo gain grid from a cumulative u32 LFO phase ``P``
    [n] and per-frame/scalar depth: g_n = f32(1 - depth_n * lfo_n) with
    lfo = 0.5 + 0.5*sin(2*pi*f32(P)*2^-32).  Verbatim copy of
    goldref.spec.tremolo_gain_grid (conformance-pinned)."""
    p = np.asarray(P, np.uint64) & np.uint64(0xFFFFFFFF)
    x = p.astype(np.float32) * np.float32(2.0 ** -32)
    lfo = (np.float32(0.5) + np.float32(0.5)
           * np.sin(2.0 * np.pi * x.astype(np.float64)).astype(np.float32))
    d = np.asarray(depth, np.float32)
    return (np.float32(1.0) - d * lfo).astype(np.float32)


def autopan_pan_grid(P, depth):
    """Per-frame autopan position grid: pan_n = f32(depth_n *
    sin(2*pi*f32(P)*2^-32)) — applied through the house equal-gain pan
    law.  Verbatim copy of goldref.spec.autopan_pan_grid
    (conformance-pinned)."""
    p = np.asarray(P, np.uint64) & np.uint64(0xFFFFFFFF)
    x = p.astype(np.float32) * np.float32(2.0 ** -32)
    s = np.sin(2.0 * np.pi * x.astype(np.float64)).astype(np.float32)
    return (np.asarray(depth, np.float32) * s).astype(np.float32)


def static_phase(n0: int, n: int, samplerate: int, rate: float) -> np.ndarray:
    """u32 phase P_n = (n0+k)*inc mod 2^32 for a CONSTANT LFO rate — the
    stateless absolute-frame form all the LFO fx share (identical to the
    cumulative sum of a constant inc grid)."""
    inc = int(round(rate / samplerate * 4294967296.0)) & 0xFFFFFFFF
    return (np.arange(n0, n0 + n, dtype=np.uint64) * np.uint64(inc)) \
        & np.uint64(0xFFFFFFFF)


def phaser_coeff_grids_swept(P, depth, min_freq: float, max_freq: float,
                             q: float, samplerate: int, dtype=None):
    """RATE/DEPTH-automated row of :func:`phaser_coeff_grids`
    (fx.phaser.rate/.depth): the LFO phase comes from a shared CUMULATIVE
    u32 phase ``P`` [n] (P_n = sum_{m<n} inc_m mod 2^32, per-frame
    increments from :func:`chorus_inc_grid` — the chorus-rate rule), and
    ``depth`` is a per-frame f64 grid.  A constant rate reproduces
    P_n = n*inc, so the grids are bit-identical to the static function's.
    Verbatim copy of goldref.spec.phaser_coeff_grids_swept
    (conformance-pinned in tests/test_coeffs_conformance.py)."""
    if dtype is None:
        dtype = np.float32
    p = np.asarray(P, np.uint64) & np.uint64(0xFFFFFFFF)
    x = p.astype(np.float32) * np.float32(2.0 ** -32)
    lfo = 0.5 + 0.5 * np.sin(2.0 * np.pi * x.astype(np.float64))
    pos = 0.5 + np.asarray(depth, np.float64) * (lfo - 0.5)
    f = float(min_freq) * (float(max_freq) / float(min_freq)) ** pos
    w0 = 2.0 * np.pi * np.minimum(f, samplerate * 0.49) / samplerate
    alpha = np.sin(w0) / (2.0 * float(q))
    cw = np.cos(w0)
    a0 = 1.0 + alpha
    b0 = (1.0 - alpha) / a0
    b1 = (-2.0 * cw) / a0
    b2 = (1.0 + alpha) / a0
    return (b0.astype(dtype), b1.astype(dtype), b2.astype(dtype),
            b1.astype(dtype), b0.astype(dtype))


def echo_tail_frames(samplerate: int, delay: float, feedback: float,
                     wet: float, tail: float = None) -> int:
    """The chain's decay-room rule for the feedback echo: an explicit
    ``tail`` wins; otherwise enough whole echo periods for the echo train
    to fall below 1 LSB at 16-bit (wet * fb^{k-1} < 1/32768), capped at
    10 s.  Verbatim copy of goldref.effects.echo_tail_frames
    (conformance-pinned)."""
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


def allpass_coeffs(freq: float, q: float,
                   samplerate: int) -> Tuple[float, float, float, float,
                                             float]:
    """RBJ second-order ALLPASS (b0, b1, b2, a1, a2), normalized by a0,
    host f64 — the scalar row of :func:`phaser_coeff_grids` (used for the
    phaser's conditioning routing at its lowest sweep frequency)."""
    w0 = 2.0 * math.pi * min(freq, samplerate * 0.49) / samplerate
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    a0 = 1.0 + alpha
    return ((1.0 - alpha) / a0, (-2.0 * cw) / a0, (1.0 + alpha) / a0,
            (-2.0 * cw) / a0, (1.0 - alpha) / a0)


def limiter_ceiling(ceiling_db: float, width: int) -> int:
    """Integer brickwall clamp for the limiter:
    rint(f64(f32(exp2(f32(ceiling_db/6.0206)))) * maxval) — the exact
    inline rule of goldref.effects.limiter (f32 exp2, f64 product, so
    width-4 ceilings stay exact past the f32 mantissa)."""
    maxval = {1: 127, 2: 32767, 4: 2147483647}[width]
    c = np.exp2(np.float32(ceiling_db)
                * np.float32(1.0 / 6.0206)).astype(np.float64)
    return int(np.rint(c * maxval))


PHASER_FF_MIN_FREQ = 120.0


def phaser_wants_ff(min_freq: float) -> bool:
    """Conditioning routing for the phaser's swept allpass cascade.  The
    static pole bound (predicted_scan_error_lsb) over-predicts for a
    SWEPT filter — the LFO spends only a fraction of its period near the
    sweep floor, so the worst-case pole never accumulates its full
    random walk.  Measured on white noise (6 stages, q <= 1, depth 1):
    plain-scan drift vs the f64 oracle is 1-4 LSB for floors >= 200 Hz,
    11-13 at 100 Hz, 31-57 at 50 Hz — crossing the 2 + 2*stages budget
    near 120 Hz.  Below that the cascade runs the compensated
    float-float scan (1 LSB measured at 50 Hz).  Shared by the staged
    Sample.phaser op and the streaming twin."""
    return float(min_freq) < PHASER_FF_MIN_FREQ
