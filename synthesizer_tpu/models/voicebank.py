"""Batched voice-bank render engine — the framework's flagship model.

This is the data-parallel replacement for the reference's per-voice generator
pipeline (BASELINE.json north_star: "batched, fused … render whole voice
banks per chunk").  A bank holds V uniform voices described by parameter
*arrays* (structure-of-arrays); one fused device program renders a whole
[V, chunk] block per step: DDS phase accumulation (u32), closed-form
sine-LFO FM, waveform evaluation, per-voice ADSR from note start/duration,
equal-gain pan, and the stereo mixdown as a fixed-order pairwise sum over
the voices.

The render is **stateless**: every block is a pure function of the absolute
sample index, so chunk size never affects output and streaming equals
offline by construction.  FM uses the exact discrete geometric-sum phase:

    p_n = p0 + inc*n + inc*d*S_n,
    S_n = sum_{k<n} sin(2*pi*(b k + phi))
        = (cos(2*pi*phi - pi*b) - cos(2*pi*(b n + phi) - pi*b)) / (2 sin(pi*b))

(the constants R = 1/(2 sin(pi b)) and C0 = cos(2 pi phi - pi b) are
precomputed per voice on host in f64).  This is the exact sum of the real-
valued per-sample increments — no cumsum, no carried integral.  The lazy
oscillator API (models.graph) keeps the reference-compatible per-sample
integer FM spec; the bank is the performance engine with this documented
closed form (tests/test_voicebank.py pins it against an f64 numpy twin).

For speed, ``pack_voices(..., sort_by_wave=True)`` orders voices into
per-waveform groups so each group evaluates only its own waveform (a mixed
bank pays for 1 waveform per voice, not all of them); a group computes the
FM path only if one of its members uses FM.

Voice waveforms: 0=sine 1=triangle 2=square 3=sawtooth 4=pulse 5=semicircle
6=pointy 7=white_noise (sample-and-hold via ``frequency``) 8=harmonics
(integer partials 1..H with per-voice amplitudes) 9=sawtooth_bl
10=square_bl (polyBLEP bandlimited) 11=wavetable (canonical 256-sample
single-cycle table, linear interp; XLA engine only) 12=pluck
(Karplus-Strong in spectral form, per-harmonic exponential decay; spec in
goldref/spec.py; XLA + Pallas engines).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import spec as S
from ..ops.trig import cos_turns, sin_turns

_TWO_PI = np.float32(2.0 * math.pi)
_TWO_NEG32 = np.float32(2.0 ** -32)

WAVE_IDS = {
    "sine": 0, "triangle": 1, "square": 2, "sawtooth": 3, "pulse": 4,
    "semicircle": 5, "pointy": 6, "white_noise": 7, "harmonics": 8,
    "sawtooth_bl": 9, "square_bl": 10, "wavetable": 11, "pluck": 12,
}
ALL_WAVES = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12)

#: canonical single-cycle table length for banked wavetable voices: user
#: tables of any length are resampled to this at pack time (linear interp
#: with wraparound, f32 — bank_table() is the documented canonicalization,
#: shared with the test oracle so parity is exact)
BANK_TABLE_LEN = 256


def bank_table(table) -> np.ndarray:
    """Resample a single-cycle table to BANK_TABLE_LEN (f32 linear interp
    with wraparound).  A table already of length BANK_TABLE_LEN passes
    through bit-identically."""
    t = np.asarray(table, np.float32)
    T = len(t)
    if T == 0:
        return np.zeros(BANK_TABLE_LEN, np.float32)
    if T == BANK_TABLE_LEN:
        return t
    pos = (np.arange(BANK_TABLE_LEN, dtype=np.float32)
           * np.float32(T) / np.float32(BANK_TABLE_LEN)).astype(np.float32)
    i = np.minimum(pos.astype(np.int64), T - 1)
    frac = (pos - i.astype(np.float32)).astype(np.float32)
    lo = t[i]
    hi = t[(i + 1) % T]
    return (lo + (hi - lo) * frac).astype(np.float32)


class VoiceParams(NamedTuple):
    """Structure-of-arrays voice parameters; every field has shape [V]
    (except harm_amps: [V, H])."""
    wave: jax.Array        # i32 waveform id
    base_inc: jax.Array    # u32 DDS increment
    phase0: jax.Array      # u32 initial phase
    amp: jax.Array         # f32
    bias: jax.Array        # f32
    pan: jax.Array         # f32 in [-1, 1]
    start: jax.Array       # i32 note start frame
    gate: jax.Array        # i32 gate duration in frames (before release)
    attack: jax.Array      # f32 seconds
    decay: jax.Array       # f32 seconds
    sustain_level: jax.Array  # f32
    release: jax.Array     # f32 seconds
    fm_inc: jax.Array      # u32 FM LFO increment
    fm_phase0: jax.Array   # u32
    fm_depth: jax.Array    # f32 (0 = no FM)
    fm_r: jax.Array        # f32 R = 1/(2 sin(pi b)), 0 when no FM
    fm_c0: jax.Array       # f32 C0 = cos(2 pi phi - pi b)
    pulse_width: jax.Array  # f32
    seed: jax.Array        # u32 noise seed
    noise_hold: jax.Array  # i32 sample-and-hold period (frames, >=1)
    harm_amps: jax.Array   # f32 [V, H] partial amplitudes (wave id 8)
    table: jax.Array       # f32 [V, BANK_TABLE_LEN] wavetable (wave id 11)
    damping: jax.Array     # f32 pluck loop-loss exponent scale (wave 12)
    glide_inc0: jax.Array  # u32 glide start increment (== base_inc: none)
    glide_d: jax.Array     # u32 per-frame increment step (two's complement)
    glide_frames: jax.Array  # i32 glide length in frames (0 = no glide)
    # pitch-curve (MIDI bend) chirp segments, [V, S] each; slot 0 starts at
    # note-relative frame 0 for curve voices, INT32_MAX rows = no curve
    bend_start: jax.Array  # i32 [V, S] segment start (note-relative frames)
    bend_phase: jax.Array  # u32 [V, S] exact phase accumulated at start
    bend_inc: jax.Array    # u32 [V, S] DDS increment at segment start
    bend_d: jax.Array      # u32 [V, S] per-frame increment step (2's compl)
    # amplitude-curve (MIDI CC7/CC11) gain segments, [V, K] each; same
    # slot-0 convention (INT32_MAX rows = no curve, gain 1.0)
    acurve_start: jax.Array  # i32 [V, K] segment start (note-rel frames)
    acurve_g0: jax.Array     # f32 [V, K] gain at segment start
    acurve_dg: jax.Array     # f32 [V, K] per-frame gain slope
    # FM-depth-curve (MIDI CC1 mod-wheel vibrato) segments, [V, D] each;
    # same slot-0 convention (INT32_MAX rows = no curve)
    dcurve_start: jax.Array  # i32 [V, D] segment start (note-rel frames)
    dcurve_c: jax.Array      # f32 [V, D] depth-weighted LFO sum at start
    dcurve_a: jax.Array      # f32 [V, D] depth at segment start
    dcurve_b: jax.Array      # f32 [V, D] per-frame depth slope


@dataclasses.dataclass(frozen=True)
class Voice:
    """Host-side description of one voice (converted into VoiceParams)."""
    wave: str = "sine"
    frequency: float = 440.0
    amplitude: float = 1.0
    phase: float = 0.0
    bias: float = 0.0
    pan: float = 0.0
    start: float = 0.0          # seconds
    duration: float = 1.0       # gate seconds (release follows)
    attack: float = 0.01
    decay: float = 0.05
    sustain_level: float = 0.8
    release: float = 0.05
    fm_frequency: float = 0.0
    fm_depth: float = 0.0
    fm_phase: float = 0.0
    pulse_width: float = 0.5
    seed: int = 0
    table: Sequence[float] = ()       # wave="wavetable": one cycle
    harmonics: Sequence[float] = ()   # partial amps for wave="harmonics"
    damping: float = 1.0              # wave="pluck": loop-loss scale
    # Portamento: slide from ``glide_from`` Hz to ``frequency`` over
    # ``glide_time`` seconds from note start (0 on either = no glide).
    # Exact integer-DDS chirp — see _phases for the closed form.  Applies
    # to the phase-based waveform families; pluck (wave 12: its closed
    # spectral form ties each partial's decay to ONE pitch, so its phase
    # is deliberately NOT swept) and noise (index-hashed) are excluded.
    glide_from: float = 0.0
    glide_time: float = 0.0
    # Pitch curve (continuous MIDI bend): ((t_rel_seconds, freq_ratio),
    # ...) control points relative to note start, multiplying
    # ``frequency``.  The DDS increment ramps LINEARLY (in Hz) between
    # consecutive points and holds after the last — each span compiles to
    # an exact integer chirp segment (compile_pitch_segments), so phase
    # is exact mod 2^32 and streaming == offline by construction.  A
    # first point later than t=0 is preceded by a hold at its ratio.
    # Mutually exclusive with glide_from/glide_time; pluck is excluded
    # exactly like glide.
    pitch_curve: Sequence[Tuple[float, float]] = ()
    # Amplitude curve (continuous MIDI CC7*CC11): ((t_rel_seconds, gain),
    # ...) control points, linear ramps between points, held after the
    # last; multiplies the ADSR envelope (f32).
    amp_curve: Sequence[Tuple[float, float]] = ()
    # FM depth curve (continuous MIDI CC1 mod-wheel vibrato):
    # ((t_rel_seconds, depth), ...) control points for a TIME-VARYING
    # ``fm_depth`` — the instantaneous frequency is
    # f0 * (1 + D(m) * sin(2*pi*(fm_phase + m*b))) with D piecewise-linear
    # between points and held after the last.  The phase contribution is
    # the exact discrete sum  inc * sum_{u<m} D(u) sin(...), evaluated
    # closed-form per segment (compile_depth_segments / _dmod_delta — the
    # Lagrange weighted trig sums; no scan, stateless in the absolute
    # frame, so streaming == offline by construction).  Requires
    # ``fm_frequency`` > 0; mutually exclusive with a non-zero constant
    # ``fm_depth``.  XLA engine only (like pitch/amp curves).
    fm_depth_curve: Sequence[Tuple[float, float]] = ()


@dataclasses.dataclass(frozen=True)
class BankLayout:
    """Static voice grouping: tuple of (wave_id, has_fm, start, count)."""
    groups: Tuple[Tuple[int, bool, int, int], ...]
    nvoices: int
    num_harmonics: int

    @classmethod
    def ungrouped(cls, nvoices: int, num_harmonics: int,
                  use_fm: bool = True) -> "BankLayout":
        # a single mixed group: per-voice waveform select (the waveform
        # set restriction is render_block's used_waves arg), FM optional
        return cls(((-1, use_fm, 0, nvoices),), nvoices, num_harmonics)


def _fm_constants(fm_inc: int, fm_phase0: int) -> Tuple[float, float]:
    b = fm_inc / 4294967296.0
    phi = fm_phase0 / 4294967296.0
    if fm_inc == 0:
        return 0.0, 0.0
    r = 1.0 / (2.0 * math.sin(math.pi * b))
    c0 = math.cos(2.0 * math.pi * phi - math.pi * b)
    return r, c0


_I32_MAX = 2 ** 31 - 1
#: pitch/amp curves denser than this are decimated (evenly, keeping the
#: first and last points) at pack time — bounds the static segment dim
MAX_CURVE_SEGS = 128


def _decimate_points(pts: list, cap: int) -> list:
    if len(pts) <= cap:
        return pts
    idx = np.unique(np.round(np.linspace(0, len(pts) - 1, cap)).astype(int))
    return [pts[i] for i in idx]


def compile_pitch_segments(curve, frequency: float, samplerate: int):
    """(t_rel, freq_ratio) control points -> exact integer chirp segments.

    Returns (starts, phases, incs, ds): per-segment note-relative start
    frame, phase accumulated at that frame (mod 2^32, exact Python-int
    arithmetic — the device closed form reproduces it bit-exactly), DDS
    increment at the start, and per-frame increment step (u32 two's
    complement, floor-division toward the next point's increment; the
    same convention as the single-segment glide in ``_pack_flat``).  The
    last segment has d=0 and holds forever.
    """
    pts = sorted((float(t), float(r)) for t, r in curve)
    if not pts:
        return [0], [0], [int(S.phase_increment(frequency, samplerate))], [0]
    if pts[0][0] > 0.0:
        pts.insert(0, (0.0, pts[0][1]))            # hold before first point
    pts = _decimate_points(pts, MAX_CURVE_SEGS)
    # frame-count spec (CLAUDE.md): int(seconds * samplerate) at point of
    # use; same-frame duplicates keep the LAST event (later event wins)
    framed: list = []
    for t, r in pts:
        f = int(t * samplerate)
        if framed and framed[-1][0] == f:
            framed[-1] = (f, r)
        else:
            framed.append((f, r))
    incs = [int(S.phase_increment(frequency * r, samplerate)) for _, r in framed]
    starts, phases, segincs, ds = [], [], [], []
    phase = 0
    for j, (f, _) in enumerate(framed):
        starts.append(f)
        phases.append(phase)
        segincs.append(incs[j])
        if j + 1 < len(framed):
            L = framed[j + 1][0] - f
            d = ((incs[j + 1] - incs[j]) // L) & 0xFFFFFFFF
            phase = (phase + L * incs[j] + d * (L * (L - 1) // 2)) % (2 ** 32)
        else:
            d = 0
        ds.append(d)
    return starts, phases, segincs, ds


def compile_amp_segments(curve, samplerate: int):
    """(t_rel, gain) control points -> (starts, g0s, dgs) linear-ramp
    segments (f32 per-frame slope; last segment holds, dg=0)."""
    pts = sorted((float(t), float(g)) for t, g in curve)
    if pts[0][0] > 0.0:
        pts.insert(0, (0.0, pts[0][1]))
    pts = _decimate_points(pts, MAX_CURVE_SEGS)
    framed: list = []
    for t, g in pts:
        f = int(t * samplerate)
        if framed and framed[-1][0] == f:
            framed[-1] = (f, g)
        else:
            framed.append((f, g))
    starts, g0s, dgs = [], [], []
    for j, (f, g) in enumerate(framed):
        starts.append(f)
        g0s.append(g)
        if j + 1 < len(framed):
            L = framed[j + 1][0] - f
            dgs.append((framed[j + 1][1] - g) / L)
        else:
            dgs.append(0.0)
    return starts, g0s, dgs


def compile_depth_segments(curve, fm_frequency: float, fm_phase: float,
                           start_frame: int, samplerate: int):
    """(t_rel, depth) control points -> FM-depth-curve segments.

    Returns (starts, cs, a0s, bs): per-segment note-relative start frame,
    the depth-weighted LFO sum accumulated at that frame
    (C_j = sum_{u<S_j} D(u) sin(2*pi*(phi_s + u*b)), f64 closed form),
    depth at the segment start, and per-frame depth slope (0 on the final
    hold segment).  The device completes the sum within the active segment
    with the same closed forms in f32 (``_dmod_delta``); the phase
    contribution is inc * (C_j + a_j*S1 + b_j*S2).

    Closed forms (b = LFO increment in turns, alpha = 2*pi*b,
    r1 = 1/(2 sin(pi b)), r2 = r1^2, theta_j = LFO phase at the segment's
    first frame, K = L-1):

        S1(L) = [cos(theta_j - alpha/2) - cos(theta_j + L*alpha - alpha/2)] * r1
        A(K)  = sum_{u=1..K} u sin(u alpha) = sin(K alpha) r2 - K cos((K+1/2) alpha) r1
        B(K)  = sum_{u=1..K} u cos(u alpha) = K sin((K+1/2) alpha) r1 - (1 - cos(K alpha)) r2
        S2(L) = sin(theta_j) B(K) + cos(theta_j) A(K)

    (verified against direct f64 summation in tests).  LFO phases are
    exact u32 DDS values — the host mirror here uses the same integer
    phases mod 2^32, so host C_j and the device's within-segment sums
    describe one identical real-valued series.
    """
    inc = int(S.phase_increment(fm_frequency, samplerate))
    if inc == 0:
        raise ValueError("fm_depth_curve requires fm_frequency > 0")
    ph0 = int(S.phase_offset(fm_phase))
    b = inc / 4294967296.0
    alpha = 2.0 * math.pi * b
    r1 = 1.0 / (2.0 * math.sin(math.pi * b))
    r2 = r1 * r1
    pts = sorted((float(t), float(d)) for t, d in curve)
    if pts[0][0] > 0.0:
        pts.insert(0, (0.0, pts[0][1]))
    pts = _decimate_points(pts, MAX_CURVE_SEGS)
    framed: list = []
    for t, d in pts:
        f = int(t * samplerate)
        if framed and framed[-1][0] == f:
            framed[-1] = (f, d)
        else:
            framed.append((f, d))

    def _theta(m_rel: int) -> float:
        return ((ph0 + (start_frame + m_rel) * inc) % 2 ** 32) \
            / 4294967296.0 * 2.0 * math.pi

    starts, cs, a0s, bs = [], [], [], []
    C = 0.0
    for j, (f, d) in enumerate(framed):
        starts.append(f)
        cs.append(C)
        a0s.append(d)
        if j + 1 < len(framed):
            L = framed[j + 1][0] - f
            slope = (framed[j + 1][1] - d) / L
            th = _theta(f)
            s1 = (math.cos(th - alpha / 2.0)
                  - math.cos(_theta(f + L) - alpha / 2.0)) * r1
            K = L - 1
            A = math.sin(alpha * K) * r2 - K * math.cos(alpha * (K + 0.5)) * r1
            B = (K * math.sin(alpha * (K + 0.5)) * r1
                 - (1.0 - math.cos(alpha * K)) * r2)
            s2 = math.sin(th) * B + math.cos(th) * A
            C += d * s1 + slope * s2
        else:
            slope = 0.0
        bs.append(slope)
    return starts, cs, a0s, bs


def pack_voices(voices: Sequence[Voice], samplerate: int,
                num_harmonics: int = 8, pad_to: int = 8,
                sort_by_wave: bool = False, tags: Optional[Sequence[int]] = None):
    """Pack host voice descriptions into device parameter arrays.

    Pads the voice count up to a multiple of ``pad_to`` with silent voices.
    With ``sort_by_wave`` the voices are ordered into per-(waveform, has_fm)
    groups, each padded to ``pad_to``, and a (VoiceParams, BankLayout) pair
    is returned (the grouped fast path); otherwise just VoiceParams.

    ``tags`` (sort_by_wave only): per-voice integer labels (e.g. the request
    index in a coalesced serving batch) carried through the sort — returns
    (vp, layout, packed_tags) where pad voices get tag 0 (they are silent,
    so the mix column they land in receives exact zeros).
    """
    silent = Voice(amplitude=0.0, frequency=0.0, duration=0.0)

    if sort_by_wave:
        # group by waveform only: FM (if any voice in the group uses it) is
        # cheap closed-form per group, while a finer (wave, fm) split would
        # double the padding for mixed banks
        keyed = sorted(range(len(voices)), key=lambda i: WAVE_IDS[voices[i].wave])
        ordered: list = []
        otags: list = []
        groups: list = []
        i = 0
        while i < len(keyed):
            v0 = voices[keyed[i]]
            wid = WAVE_IDS[v0.wave]
            members = []
            mtags = []
            while i < len(keyed) and WAVE_IDS[voices[keyed[i]].wave] == wid:
                members.append(voices[keyed[i]])
                mtags.append(tags[keyed[i]] if tags is not None else 0)
                i += 1
            has_fm = any(v.fm_depth != 0.0 for v in members)
            start = len(ordered)
            npad = -len(members) % pad_to
            members = members + [dataclasses.replace(silent, wave=v0.wave)] * npad
            mtags = mtags + [0] * npad
            ordered.extend(members)
            otags.extend(mtags)
            groups.append((wid, has_fm, start, len(members)))
        vp = _pack_flat(ordered, samplerate, num_harmonics)
        layout = BankLayout(tuple(groups), len(ordered), num_harmonics)
        if tags is not None:
            return vp, layout, np.asarray(otags, np.int32)
        return vp, layout

    npad = -len(voices) % pad_to
    ordered = list(voices) + [silent] * max(npad, pad_to - len(voices)
                                            if len(voices) < pad_to else npad)
    return _pack_flat(ordered, samplerate, num_harmonics)


def _pack_flat(voices: Sequence[Voice], samplerate: int,
               num_harmonics: int) -> VoiceParams:
    V = len(voices)
    H = num_harmonics

    def arr(fn, dtype):
        out = np.zeros(V, dtype)
        for i, vc in enumerate(voices):
            out[i] = fn(vc)
        return jnp.asarray(out)

    fm_r = np.zeros(V, np.float32)
    fm_c0 = np.zeros(V, np.float32)
    for i, vc in enumerate(voices):
        inc = S.phase_increment(vc.fm_frequency, samplerate)
        r, c0 = _fm_constants(inc, S.phase_offset(vc.fm_phase))
        fm_r[i], fm_c0[i] = r, c0

    harm = np.zeros((V, max(H, 1)), np.float32)
    for i, vc in enumerate(voices):
        for j, a in enumerate(vc.harmonics[:H]):
            harm[i, j] = a

    tables = np.zeros((V, BANK_TABLE_LEN), np.float32)
    for i, vc in enumerate(voices):
        if vc.wave == "wavetable":
            tables[i] = bank_table(vc.table)

    # portamento constants (exact Python-int arithmetic mod 2^32):
    # per-frame increment step d = floor((inc1 - inc0) / G) — the landing
    # increment inc0 + d*G sits within G phase units BELOW inc1 in the
    # floor-division direction (for upward glides an undershoot, for
    # downward glides a slight overshoot past the target; < G units
    # either way — at 44.1 kHz one unit is ~1e-5 Hz)
    g_inc0 = np.zeros(V, np.uint32)
    g_d = np.zeros(V, np.uint32)
    g_frames = np.zeros(V, np.int32)
    for i, vc in enumerate(voices):
        if vc.glide_from > 0.0 and vc.glide_time > 0.0 and vc.frequency > 0.0:
            if vc.pitch_curve:
                raise ValueError(
                    "glide_from/glide_time and pitch_curve are mutually "
                    "exclusive on one voice (both sweep the DDS increment)")
            inc0 = int(S.phase_increment(vc.glide_from, samplerate))
            inc1 = int(S.phase_increment(vc.frequency, samplerate))
            G = max(1, int(vc.glide_time * samplerate))
            g_inc0[i] = np.uint32(inc0)
            g_d[i] = np.uint32(((inc1 - inc0) // G) & 0xFFFFFFFF)
            g_frames[i] = G

    # pitch/amp curve segments (static [V, S]/[V, K] dims sized to the
    # densest curve in the bank; no-curve rows are INT32_MAX-start
    # sentinels so the device gate bend_start[:, 0] == 0 skips them)
    bsegs = {i: compile_pitch_segments(vc.pitch_curve, vc.frequency,
                                       samplerate)
             for i, vc in enumerate(voices) if vc.pitch_curve}
    asegs = {i: compile_amp_segments(vc.amp_curve, samplerate)
             for i, vc in enumerate(voices) if vc.amp_curve}
    for vc in voices:
        if vc.fm_depth_curve and vc.fm_depth != 0.0:
            raise ValueError(
                "fm_depth_curve and a non-zero constant fm_depth are "
                "mutually exclusive on one voice (the curve IS the depth)")
    dsegs = {i: compile_depth_segments(vc.fm_depth_curve, vc.fm_frequency,
                                       vc.fm_phase,
                                       int(vc.start * samplerate), samplerate)
             for i, vc in enumerate(voices) if vc.fm_depth_curve}
    SB = max([len(s[0]) for s in bsegs.values()], default=0) or 1
    KA = max([len(s[0]) for s in asegs.values()], default=0) or 1
    b_start = np.full((V, SB), _I32_MAX, np.int32)
    b_phase = np.zeros((V, SB), np.uint32)
    b_inc = np.zeros((V, SB), np.uint32)
    b_d = np.zeros((V, SB), np.uint32)
    for i, (st, ph, inc, d) in bsegs.items():
        k = len(st)
        b_start[i, :k] = st
        b_phase[i, :k] = np.asarray(ph, np.uint64).astype(np.uint32)
        b_inc[i, :k] = np.asarray(inc, np.uint64).astype(np.uint32)
        b_d[i, :k] = np.asarray(d, np.uint64).astype(np.uint32)
    a_start = np.full((V, KA), _I32_MAX, np.int32)
    a_g0 = np.ones((V, KA), np.float32)
    a_dg = np.zeros((V, KA), np.float32)
    for i, (st, g0, dg) in asegs.items():
        k = len(st)
        a_start[i, :k] = st
        a_g0[i, :k] = g0
        a_dg[i, :k] = dg
        if k < KA:            # pad by replicating the hold segment (never
            a_start[i, k:] = _I32_MAX      # selected: starts at I32_MAX)
            a_g0[i, k:] = g0[-1]
    KD = max([len(s[0]) for s in dsegs.values()], default=0) or 1
    d_start = np.full((V, KD), _I32_MAX, np.int32)
    d_c = np.zeros((V, KD), np.float32)
    d_a = np.zeros((V, KD), np.float32)
    d_b = np.zeros((V, KD), np.float32)
    for i, (st, cs, a0, bsl) in dsegs.items():
        k = len(st)
        d_start[i, :k] = st
        d_c[i, :k] = cs
        d_a[i, :k] = a0
        d_b[i, :k] = bsl
    return VoiceParams(
        wave=arr(lambda x: WAVE_IDS[x.wave], np.int32),
        base_inc=arr(lambda x: S.phase_increment(x.frequency, samplerate), np.uint32),
        phase0=arr(lambda x: S.phase_offset(x.phase), np.uint32),
        amp=arr(lambda x: x.amplitude, np.float32),
        bias=arr(lambda x: x.bias, np.float32),
        pan=arr(lambda x: x.pan, np.float32),
        start=arr(lambda x: int(x.start * samplerate), np.int32),
        gate=arr(lambda x: int(x.duration * samplerate), np.int32),
        attack=arr(lambda x: x.attack, np.float32),
        decay=arr(lambda x: x.decay, np.float32),
        sustain_level=arr(lambda x: x.sustain_level, np.float32),
        release=arr(lambda x: x.release, np.float32),
        fm_inc=arr(lambda x: S.phase_increment(x.fm_frequency, samplerate), np.uint32),
        fm_phase0=arr(lambda x: S.phase_offset(x.fm_phase), np.uint32),
        fm_depth=arr(lambda x: x.fm_depth, np.float32),
        fm_r=jnp.asarray(fm_r),
        fm_c0=jnp.asarray(fm_c0),
        pulse_width=arr(lambda x: min(max(x.pulse_width, 1.0 / 65536.0),
                                      1.0 - 1.0 / 65536.0), np.float32),
        seed=arr(lambda x: x.seed & 0xFFFFFFFF, np.uint32),
        noise_hold=arr(lambda x: max(1, int(round(samplerate / x.frequency)))
                       if (x.wave == "white_noise" and x.frequency > 0) else 1,
                       np.int32),
        harm_amps=jnp.asarray(harm),
        table=jnp.asarray(tables),
        damping=arr(lambda x: x.damping, np.float32),
        glide_inc0=jnp.asarray(g_inc0),
        glide_d=jnp.asarray(g_d),
        glide_frames=jnp.asarray(g_frames),
        bend_start=jnp.asarray(b_start),
        bend_phase=jnp.asarray(b_phase),
        bend_inc=jnp.asarray(b_inc),
        bend_d=jnp.asarray(b_d),
        acurve_start=jnp.asarray(a_start),
        acurve_g0=jnp.asarray(a_g0),
        acurve_dg=jnp.asarray(a_dg),
        dcurve_start=jnp.asarray(d_start),
        dcurve_c=jnp.asarray(d_c),
        dcurve_a=jnp.asarray(d_a),
        dcurve_b=jnp.asarray(d_b),
    )


# ---------------------------------------------------------------------------
# Waveform evaluation
# ---------------------------------------------------------------------------

def _phase_x(p):
    return p.astype(jnp.float32) * _TWO_NEG32


def _triangle(x):
    four = jnp.float32(4.0)
    return jnp.where(x < 0.25, four * x,
                     jnp.where(x < 0.75, jnp.float32(2.0) - four * x,
                               four * x - four))


def _noise_u32(idx, seed):
    x = idx.astype(jnp.uint32) * jnp.uint32(0x9E3779B9) + seed[:, None]
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _noise(idx, seed):
    x = _noise_u32(idx, seed)
    return (x >> 8).astype(jnp.float32) * jnp.float32(2.0 ** -23) - jnp.float32(1.0)


def _one_wave(wid: int, p, vp: VoiceParams, n, num_harmonics: int,
              inst_inc=None):
    """Evaluate a single statically-known waveform at phases p [v, N].

    ``inst_inc`` (u32 [v, N], optional): the instantaneous DDS increment
    for voices whose pitch sweeps (glide/bend) — the polyBLEP waveforms
    place their antialiasing residual at the CURRENT chirp pitch from it
    instead of the landing ``base_inc`` (audible aliasing otherwise on
    long upward glides).  None = constant-pitch bank, identical HLO to
    the pre-glide formula."""
    x = _phase_x(p)
    one = jnp.float32(1.0)
    if wid == 0:
        return sin_turns(x)
    if wid == 1:
        return _triangle(x)
    if wid == 2:
        return jnp.where(p < jnp.uint32(1 << 31), one, -one)
    if wid == 3:
        return jnp.float32(2.0) * x - one
    if wid == 4:
        wu = (vp.pulse_width[:, None] * jnp.float32(4294967296.0)).astype(jnp.uint32)
        return jnp.where(p < wu, one, -one)
    if wid == 5:
        up = jnp.sqrt(jnp.maximum(jnp.float32(0.0),
                                  one - (jnp.float32(4.0) * x - one) ** 2))
        dn = -jnp.sqrt(jnp.maximum(jnp.float32(0.0),
                                   one - (jnp.float32(4.0) * x - jnp.float32(3.0)) ** 2))
        return jnp.where(x < 0.5, up, dn)
    if wid == 6:
        t = _triangle(x)
        return t * t * t
    if wid == 7:
        idx = (n[None, :] // vp.noise_hold[:, None]).astype(jnp.uint32)
        return _noise(idx, vp.seed)
    if wid == 8:
        acc = jnp.zeros(p.shape, jnp.float32)
        for k in range(1, num_harmonics + 1):
            pk = p * jnp.uint32(k)
            acc = acc + vp.harm_amps[:, k - 1][:, None] * sin_turns(_phase_x(pk))
        return acc
    if wid in (9, 10):
        # polyBLEP bandlimited saw/square: per-voice dt = f/sr = inc * 2^-32
        # (residual formula: goldref.osc.poly_blep)
        x = _phase_x(p)
        if inst_inc is None:
            dt = vp.base_inc.astype(jnp.float32)[:, None] * _TWO_NEG32
        else:
            dt = inst_inc.astype(jnp.float32) * _TWO_NEG32
        dt = jnp.maximum(dt, jnp.float32(1e-9))
        u0 = x / dt
        lo = (u0 + u0) - u0 * u0 - one
        u1 = (x - one) / dt
        hi = u1 * u1 + (u1 + u1) + one
        blep = jnp.where(x < dt, lo, jnp.where(x > one - dt, hi, jnp.float32(0.0)))
        if wid == 9:
            return (jnp.float32(2.0) * x - one) - blep
        naive = jnp.where(p < jnp.uint32(1 << 31), one, -one)
        x2 = jnp.where(x < 0.5, x + jnp.float32(0.5), x - jnp.float32(0.5))
        u0b = x2 / dt
        lob = (u0b + u0b) - u0b * u0b - one
        u1b = (x2 - one) / dt
        hib = u1b * u1b + (u1b + u1b) + one
        blep2 = jnp.where(x2 < dt, lob, jnp.where(x2 > one - dt, hib, jnp.float32(0.0)))
        return naive + blep - blep2
    if wid == 12:
        # pluck (Karplus-Strong, spectral form; spec: goldref/spec.py).
        # Per-voice constants are device-computed from seed/inc/damping
        # (voices are traced data here, unlike the static graph nodes):
        # the k loop is static over the bank's harmonic budget.
        K = max(1, num_harmonics)
        inc = vp.base_inc                                  # u32 [v]
        ratio = inc.astype(jnp.float32) * _TWO_NEG32       # f32 [v]
        nrel = jnp.maximum(n[None, :] - vp.start[:, None], 0).astype(jnp.float32)
        ks = jnp.arange(1, K + 1, dtype=jnp.uint32)[None, :]          # [1,K]
        u = _noise(jnp.broadcast_to(ks, (inc.shape[0], K)), vp.seed)  # [v,K]
        # active iff k*inc < 2^31 (exact integer Nyquist mask)
        lim = jnp.asarray([(2 ** 31 - 1) // k for k in range(1, K + 1)],
                          jnp.uint32)[None, :]
        active = (inc[:, None] <= lim) & (inc[:, None] > 0)           # [v,K]
        denom = jnp.maximum(jnp.sum(jnp.abs(u) * active, axis=1),
                            jnp.float32(1e-30))                       # [v]
        phi = _noise_u32(jnp.broadcast_to(
            jnp.arange(K + 1, 2 * K + 1, dtype=jnp.uint32)[None, :],
            (inc.shape[0], K)), vp.seed)                              # [v,K]
        g = jnp.cos(jnp.float32(math.pi)
                    * ks.astype(jnp.float32) * ratio[:, None])
        alpha = (vp.damping[:, None] * ratio[:, None]
                 * jnp.log(jnp.maximum(g, jnp.float32(1e-30))))       # [v,K]
        acc = jnp.zeros((inc.shape[0],) + n.shape, jnp.float32)
        for j in range(K):
            kk = j + 1
            pk = p * jnp.uint32(kk) + phi[:, j][:, None]
            term = ((u[:, j] / denom)[:, None]
                    * jnp.exp(nrel * alpha[:, j][:, None])
                    * sin_turns(_phase_x(pk)))
            acc = acc + jnp.where(active[:, j][:, None], term,
                                  jnp.float32(0.0))
        return acc
    if wid == 11:
        # banked wavetable: canonical [v, BANK_TABLE_LEN] table, linear
        # interp with wraparound (same arithmetic as the graph engine on
        # the canonicalized table)
        T = vp.table.shape[1]
        pos = x * jnp.float32(T)
        i = jnp.minimum(pos.astype(jnp.int32), T - 1)
        frac = pos - i.astype(jnp.float32)
        lo = jnp.take_along_axis(vp.table, i, axis=1)
        hi = jnp.take_along_axis(vp.table, (i + 1) % T, axis=1)
        return lo + (hi - lo) * frac
    raise ValueError(f"bad wave id {wid}")


def _wave_select(p, vp: VoiceParams, n, num_harmonics: int,
                 used_waves: tuple = ALL_WAVES, inst_inc=None):
    """Per-voice waveform select (mixed group): computes every used family."""
    used = tuple(w for w in used_waves
                 if w not in (8, 12) or num_harmonics > 0)
    wid = vp.wave[:, None]
    out = None
    for w in used:
        vals = _one_wave(w, p, vp, n, num_harmonics, inst_inc)
        out = vals if out is None else jnp.where(wid == w, vals, out)
    return out if out is not None else jnp.zeros(p.shape, jnp.float32)


def _tri_u32(m):
    """Triangular number m*(m-1)/2 mod 2^32 (u32 in, u32 out).

    Halve the EVEN factor before the wrapped multiply — dividing a
    wrapped product by 2 would need mod 2^33.  Exact for m >= 0; values
    for wrapped negative m are garbage but always envelope-masked."""
    even = (m & jnp.uint32(1)) == 0
    a = jnp.where(even, m >> 1, m)
    b = jnp.where(even, m - jnp.uint32(1), (m - jnp.uint32(1)) >> 1)
    return a * b


def _bend_idx(vp: VoiceParams, m):
    """Active pitch-curve segment index per (voice, frame): the largest s
    with m >= bend_start[s] (clamped to 0; pre-note frames are envelope-
    masked garbage, like glide)."""
    cnt = jnp.sum((m[:, None, :] >= vp.bend_start[:, :, None])
                  .astype(jnp.int32), axis=1)
    return jnp.clip(cnt - 1, 0, vp.bend_start.shape[1] - 1)


def _dmod_delta(vp: VoiceParams, n) -> jax.Array:
    """FM phase contribution for depth-curve voices, f32 [v, N]:
    inc * sum_{u<m} D(u) sin(2*pi*(phi_s + u*b)) with D the piecewise-
    linear depth — C_j (host f64, exact u32 LFO phases) plus the within-
    segment weighted trig sums of compile_depth_segments' docstring,
    all elementwise (no scan).

    Budget (composed, worst case CC1 full-swell at depth_max ~ 0.03 and a
    5.5 Hz LFO, r1 ~ 1.3e3): the trig-poly error (7.8e-7 abs) enters the
    slope term as depth_delta*r1*eps ~ 3e-5 and the a*S1 term as
    2*depth*r1*eps ~ 6e-5 — phase error <= inc * 1e-4 units
    = (f0/sr) * 1e-4 turns ~ 1e-6 turns at 440 Hz, i.e. ~0.2 LSB at
    16-bit full scale (pinned against the f64 per-sample twin in
    tests/test_midi.py).  Pre-note frames (m < 0) produce finite
    envelope-masked garbage, like the bend segments."""
    m = n[None, :] - vp.start[:, None]                 # i32, note-relative
    cnt = jnp.sum((m[:, None, :] >= vp.dcurve_start[:, :, None])
                  .astype(jnp.int32), axis=1)
    idx = jnp.clip(cnt - 1, 0, vp.dcurve_start.shape[1] - 1)
    st = jnp.take_along_axis(vp.dcurve_start, idx, axis=1)
    c = jnp.take_along_axis(vp.dcurve_c, idx, axis=1)
    a = jnp.take_along_axis(vp.dcurve_a, idx, axis=1)
    b = jnp.take_along_axis(vp.dcurve_b, idx, axis=1)
    inc = vp.fm_inc[:, None]
    half = inc >> 1
    # exact u32 LFO phases at the current frame and the segment start
    ph_n = vp.fm_phase0[:, None] + n[None, :].astype(jnp.uint32) * inc
    ph_j = (vp.fm_phase0[:, None]
            + (vp.start[:, None] + st).astype(jnp.uint32) * inc)
    r1 = vp.fm_r[:, None]
    r2 = r1 * r1
    s1 = (cos_turns(_phase_x(ph_j - half))
          - cos_turns(_phase_x(ph_n - half))) * r1
    K = jnp.maximum(m - st - 1, 0)                     # L-1, clamped
    Ku = K.astype(jnp.uint32)
    xK = _phase_x(Ku * inc)                            # K*b mod 1 (exact)
    xKh = _phase_x(Ku * inc + half)                    # (K+1/2)*b mod 1
    Kf = K.astype(jnp.float32)
    A = sin_turns(xK) * r2 - Kf * cos_turns(xKh) * r1
    B = Kf * sin_turns(xKh) * r1 - (jnp.float32(1.0) - cos_turns(xK)) * r2
    xj = _phase_x(ph_j)
    s2 = sin_turns(xj) * B + cos_turns(xj) * A
    return vp.base_inc.astype(jnp.float32)[:, None] * (c + a * s1 + b * s2)


def _phases(vp: VoiceParams, n, use_fm: bool, use_glide: bool = False,
            use_bend: bool = False, use_dmod: bool = False):
    """Closed-form DDS phases [v, N] for absolute frames n [N].

    Portamento (use_glide): a linear-in-increment integer chirp, still
    closed-form — for note-relative frame m, inc_m = inc0 + m*d, so
    phase_m = phase0 + m*inc0 + d*m(m-1)/2 (mod 2^32) during the glide
    and phase_G + (m-G)*incG after it (incG = inc0 + G*d).  All integer,
    elementwise, no scan; a glide voice's phase is relative to its note
    START (a plain voice's is relative to frame 0 — both are exact DDS).

    Pitch curves (use_bend): the same chirp closed form applied per
    segment — the active segment is found by counting starts <= m and its
    host-precomputed boundary phase anchors the chirp, so the piecewise
    phase is exact mod 2^32 with no scan (compile_pitch_segments)."""
    nu = n[None, :].astype(jnp.uint32)
    p = vp.phase0[:, None] + nu * vp.base_inc[:, None]
    if use_bend:
        m = n[None, :] - vp.start[:, None]             # i32, note-relative
        idx = _bend_idx(vp, m)
        st = jnp.take_along_axis(vp.bend_start, idx, axis=1)
        ph = jnp.take_along_axis(vp.bend_phase, idx, axis=1)
        bi = jnp.take_along_axis(vp.bend_inc, idx, axis=1)
        bd = jnp.take_along_axis(vp.bend_d, idx, axis=1)
        mrel = (m - st).astype(jnp.uint32)
        pb = vp.phase0[:, None] + ph + mrel * bi + bd * _tri_u32(mrel)
        has_bend = ((vp.bend_start[:, 0] == 0)
                    & (vp.wave != jnp.int32(12)))[:, None]  # pluck: as glide
        p = jnp.where(has_bend, pb, p)
    if use_glide:
        m = n[None, :] - vp.start[:, None]             # i32, note-relative
        mu = m.astype(jnp.uint32)
        inc0 = vp.glide_inc0[:, None]
        d = vp.glide_d[:, None]
        G = vp.glide_frames[:, None]
        Gu = G.astype(jnp.uint32)
        during = inc0 * mu + d * _tri_u32(mu)
        phase_g = inc0 * Gu + d * _tri_u32(Gu)         # phase at m == G
        inc_g = inc0 + d * Gu
        after = phase_g + (mu - Gu) * inc_g
        pg = vp.phase0[:, None] + jnp.where(m < G, during, after)
        # pluck (wave 12) is excluded by construction: its closed spectral
        # form ties each harmonic's decay rate to ONE pitch, so a swept
        # phase would chirp the partials while their decays stay at the
        # target — a glide on a pluck voice renders at the target pitch
        # (pinned by test_glide_pluck_excluded, both engines)
        p = jnp.where((G > 0) & (vp.wave[:, None] != jnp.int32(12)), pg, p)
    if not (use_fm or use_dmod):
        return p
    # exact discrete FM integral (module docstring): delta = inc*d*S_n
    fm_phase = vp.fm_phase0[:, None] + nu * vp.fm_inc[:, None]
    x_half = _phase_x(fm_phase - (vp.fm_inc[:, None] >> 1))
    s_n = (vp.fm_c0[:, None] - cos_turns(x_half)) * vp.fm_r[:, None]
    delta = vp.base_inc.astype(jnp.float32)[:, None] * vp.fm_depth[:, None] * s_n
    has_fm = ((vp.fm_depth != 0.0) & (vp.fm_inc != 0))[:, None]
    if use_dmod:
        # CC1 mod-wheel vibrato: time-varying depth replaces the constant
        # integral for curve voices (static flag — curve-free banks keep
        # the exact pre-curve HLO)
        has_dc = (vp.dcurve_start[:, 0] == 0)[:, None] & (vp.fm_inc != 0)[:, None]
        delta = jnp.where(has_dc, _dmod_delta(vp, n), delta)
        has_fm = has_fm | has_dc
    # wrap to [-2^31, 2^31) before the integer cast (phase is modular)
    q = delta * jnp.float32(2.0 ** -32)
    frac = q - jnp.rint(q)
    dunits = (frac * jnp.float32(4294967296.0)).astype(jnp.int32).astype(jnp.uint32)
    return jnp.where(has_fm, p + dunits, p)


def _inst_inc(vp: VoiceParams, n, use_glide: bool, use_bend: bool):
    """Instantaneous DDS increment (u32 [v, N]) under glide/bend — feeds
    the polyBLEP dt so the antialiasing residual tracks the chirp pitch.
    None when the bank has no pitch sweeps (BLEP dt = base_inc, the
    pre-sweep HLO)."""
    if not (use_glide or use_bend):
        return None
    inc = jnp.broadcast_to(vp.base_inc[:, None],
                           (vp.base_inc.shape[0], n.shape[0]))
    m = n[None, :] - vp.start[:, None]
    if use_bend:
        idx = _bend_idx(vp, m)
        st = jnp.take_along_axis(vp.bend_start, idx, axis=1)
        bi = jnp.take_along_axis(vp.bend_inc, idx, axis=1)
        bd = jnp.take_along_axis(vp.bend_d, idx, axis=1)
        mrel = jnp.maximum(m - st, 0).astype(jnp.uint32)
        has_bend = (vp.bend_start[:, 0] == 0)[:, None]
        inc = jnp.where(has_bend, bi + mrel * bd, inc)
    if use_glide:
        G = vp.glide_frames[:, None]
        mcl = jnp.clip(m, 0, G).astype(jnp.uint32)
        gi = vp.glide_inc0[:, None] + mcl * vp.glide_d[:, None]
        inc = jnp.where(G > 0, gi, inc)
    return inc


def _amp_curve_gain(vp: VoiceParams, n) -> jax.Array:
    """Per-voice amplitude-curve gain [v, N]: linear ramps between control
    points, held after the last; 1.0 for rows without a curve."""
    m = n[None, :] - vp.start[:, None]                 # i32, note-relative
    cnt = jnp.sum((m[:, None, :] >= vp.acurve_start[:, :, None])
                  .astype(jnp.int32), axis=1)
    idx = jnp.clip(cnt - 1, 0, vp.acurve_start.shape[1] - 1)
    st = jnp.take_along_axis(vp.acurve_start, idx, axis=1)
    g0 = jnp.take_along_axis(vp.acurve_g0, idx, axis=1)
    dg = jnp.take_along_axis(vp.acurve_dg, idx, axis=1)
    # f32 frame offsets: exact below 2^24 note-relative frames (~380 s);
    # beyond that the <=2-frame rounding times the per-frame slope is far
    # below 1 LSB of int16 audio
    g = g0 + jnp.maximum(m - st, 0).astype(jnp.float32) * dg
    has = (vp.acurve_start[:, 0] == 0)[:, None]
    return jnp.where(has, g, jnp.float32(1.0))


def _adsr(n: jax.Array, vp: VoiceParams, samplerate: int) -> jax.Array:
    """Per-voice ADSR gain at absolute frames n [N] -> [v, N] (f32).

    Sustain duration = max(0, gate/sr - attack - decay); release follows the
    gate; outside [start, start+total) the gain is 0.
    """
    sr_r = jnp.float32(1.0 / samplerate)
    t = (n[None, :] - vp.start[:, None]).astype(jnp.float32) * sr_r
    a = jnp.maximum(vp.attack, 0.0)[:, None]
    d = jnp.maximum(vp.decay, 0.0)[:, None]
    r = jnp.maximum(vp.release, 0.0)[:, None]
    sl = vp.sustain_level[:, None]
    gate = vp.gate.astype(jnp.float32)[:, None] * sr_r
    s = jnp.maximum(gate - a - d, 0.0)
    t2 = a + d
    t4 = t2 + s + r
    t3 = t2 + s
    eps = jnp.float32(1e-30)
    # Piecewise ADSR (division-free via per-voice reciprocal slopes).  NOTE:
    # this must stay a region select — a min-of-lines form is NOT equivalent:
    # for short gates (sustain ~ 0) the release line sl*(t4-t)/r dips below
    # the attack/decay lines before t3 and a min() releases early (caught by
    # the random-bank fuzzer; regression: test_short_gate_envelope).
    a_r = jnp.float32(1.0) / jnp.maximum(a, eps)
    d_r = jnp.float32(1.0) / jnp.maximum(d, eps)
    r_r = jnp.float32(1.0) / jnp.maximum(r, eps)
    g = jnp.where(t < a, t * a_r,
        jnp.where(t < t2, jnp.float32(1.0) + (sl - jnp.float32(1.0)) * (t - a) * d_r,
        jnp.where(t < t3, sl,
        jnp.where(t < t4, sl * (t4 - t) * r_r,
                  jnp.float32(0.0)))))
    g = jnp.where(t < 0, jnp.float32(0.0), g)
    return jnp.clip(g, jnp.float32(0.0), jnp.float32(1.0))


def _slice_params(vp: VoiceParams, start: int, count: int) -> VoiceParams:
    return VoiceParams(*(f[start:start + count] for f in vp))


def render_block(vp: VoiceParams, n0: jax.Array, blocksize: int,
                 samplerate: int, num_harmonics: int,
                 layout: Optional[BankLayout] = None,
                 used_waves: tuple = ALL_WAVES, use_fm: bool = True,
                 seg: Optional[jax.Array] = None, nseg: int = 0,
                 use_glide: bool = False, use_bend: bool = False,
                 use_amp: bool = False, use_dmod: bool = False):
    """Render one block -> stereo f32 [blocksize, 2] (stateless, pure in n0).

    With a grouped ``layout`` each (waveform, fm) group evaluates only its
    own waveform; otherwise the mixed-group select path is used.  With
    ``seg`` (per-voice segment ids [V]) the mixdown is grouped into
    ``nseg`` independent stereo buses -> [blocksize, nseg, 2].
    ``use_bend``/``use_amp`` enable the per-voice pitch/amplitude curve
    segments (continuous MIDI bend and CC7/CC11) — static flags like
    ``use_glide`` so curve-free banks keep their exact pre-curve HLO.
    """
    n = n0 + jnp.arange(blocksize, dtype=jnp.int32)
    if layout is None:
        layout = BankLayout.ungrouped(vp.wave.shape[0], num_harmonics, use_fm)
    sigs = []
    gains = []
    for (wid, has_fm, start, count) in layout.groups:
        sub = _slice_params(vp, start, count)
        p = _phases(sub, n, has_fm, use_glide, use_bend, use_dmod)
        blep_here = wid in (9, 10) or (
            wid < 0 and any(w in (9, 10) for w in used_waves))
        inst = (_inst_inc(sub, n, use_glide, use_bend)
                if blep_here else None)
        if wid < 0:
            w = _wave_select(p, sub, n, num_harmonics, used_waves, inst)
        else:
            w = _one_wave(wid, p, sub, n, num_harmonics, inst)
        v = sub.bias[:, None] + sub.amp[:, None] * w
        env = _adsr(n, sub, samplerate)
        if use_amp:
            env = env * _amp_curve_gain(sub, n)
        sigs.append(v * env)
        lg = jnp.minimum(jnp.float32(1.0), jnp.float32(1.0) - sub.pan)
        rg = jnp.minimum(jnp.float32(1.0), jnp.float32(1.0) + sub.pan)
        gains.append(jnp.stack([lg, rg], axis=1))
    sig = jnp.concatenate(sigs, axis=0)        # [V, N]
    g = jnp.concatenate(gains, axis=0)         # [V, 2]
    if seg is not None:
        # grouped mixdown (coalesced serving): scatter each voice's pan
        # gains into its request's column pair -> ONE [N,V]x[V,2R] matmul
        V = g.shape[0]
        g2 = jnp.zeros((V, 2 * nseg), jnp.float32)
        rows = jnp.arange(V, dtype=jnp.int32)
        g2 = g2.at[rows, 2 * seg].set(g[:, 0]).at[rows, 2 * seg + 1].set(g[:, 1])
        # precision=HIGHEST: at default precision a GPU may run this f32
        # matmul in TF32 (preferred_element_type only controls
        # accumulation), which keeps ~10 mantissa bits and would quantize
        # the mix to ~2^-11 relative — far outside the 1-LSB contract.
        out = jnp.dot(sig.T, g2, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
        return out.reshape(-1, nseg, 2)
    return _mix_voices(sig, g)


def _mix_voices(sig: jax.Array, g: jax.Array) -> jax.Array:
    """Pan mixdown [V, N] x [V, 2] -> [N, 2] as a pairwise tree over the
    voices (zero rows pad V to a power of two; adding them is exact).

    A matmul would sum the voices in an order the GPU picks per shape
    (tiling, split-K), so an offline render (one N) and its streaming
    twin (another N) could differ in the last bit.  The tree fixes the
    order for every N and backend, which keeps offline == streaming
    bit-exact.  ``sig`` is materialized first (the barrier), so the
    waveform work is not recomputed for each channel of the fused sum."""
    x = jax.lax.optimization_barrier(sig)[:, :, None] * g[:, None, :]
    V = x.shape[0]
    P = 1 << max(0, V - 1).bit_length()
    if P > V:
        x = jnp.concatenate([x, jnp.zeros((P - V,) + x.shape[1:], x.dtype)])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


#: compiled (chunk_fn, song_fn) pairs keyed by the bank's static config —
#: a fresh jit closure per VoiceBank instance would recompile for EVERY
#: request in a serving loop, even for identical bank shapes
_bank_fn_cache: dict = {}


def _bank_fns(cf: int, sr: int, H: int, uw: tuple, uf: bool,
              ly: Optional[BankLayout], ug: bool = False,
              ub: bool = False, ua: bool = False, ud: bool = False):
    key = (cf, sr, H, uw, uf, ly, ug, ub, ua, ud)
    fns = _bank_fn_cache.get(key)
    if fns is None:
        @jax.jit
        def chunk_fn(vp: VoiceParams, n0):
            return render_block(vp, n0, cf, sr, H, ly, uw, uf, use_glide=ug,
                                use_bend=ub, use_amp=ua, use_dmod=ud)

        @functools.partial(jax.jit, static_argnames=("nchunks",))
        def song_fn(vp: VoiceParams, nchunks: int):
            def body(_, i):
                return 0, render_block(vp, i * cf, cf, sr, H, ly, uw, uf,
                                       use_glide=ug, use_bend=ub, use_amp=ua,
                                       use_dmod=ud)
            _, out = jax.lax.scan(body, 0, jnp.arange(nchunks, dtype=jnp.int32))
            return out.reshape(-1, 2)

        fns = (chunk_fn, song_fn)
        _bank_fn_cache[key] = fns
    return fns


#: pad-slot fills for the sparse-render sentinel row (every other field
#: is 0 of its dtype).  The row is DOUBLY silent: amp=0 AND gate=0 make
#: _adsr exactly 0.0 at every frame (sig = v*env = v*0 = 0 exactly), and
#: start sits past the song so t < 0 everywhere too.  Zero-increment
#: waveform math is already guarded by the silent-pad-voice contract
#: ("silent pad voices contribute exact zeros" — pack_voices pads every
#: grouped bank with frequency-0 voices of each group's wave).
_SPARSE_PAD_FILLS = {"pulse_width": 0.5, "noise_hold": 1, "damping": 1.0,
                     "bend_start": 2147483647, "acurve_start": 2147483647,
                     "acurve_g0": 1.0, "dcurve_start": 2147483647}


def _append_pad_voice(vp: VoiceParams, start_frame) -> VoiceParams:
    """Append ONE silent sentinel row (index V) for sparse-render pad
    slots, preserving every field's dtype and trailing segment dims.
    Called INSIDE the jitted bucketed program (start_frame may be a
    traced scalar), so the 30+ per-field concatenates fuse into the
    compiled render instead of paying host dispatches per call."""
    rows = []
    for name, a in zip(VoiceParams._fields, vp):
        fill = _SPARSE_PAD_FILLS.get(name, 0)
        a = jnp.asarray(a)
        pad = (jnp.full((1,) + a.shape[1:], fill, a.dtype)
               if name != "start"
               else jnp.asarray(start_frame, a.dtype)[None])
        rows.append(jnp.concatenate([a, pad], axis=0))
    return VoiceParams(*rows)


def _bank_bucketed_fn(cf: int, sr: int, H: int, uw: tuple, uf: bool,
                      ug: bool = False, ub: bool = False, ua: bool = False,
                      ud: bool = False):
    """Sparse song mixdown: ONE scan over chunks whose xs carry the
    per-chunk ACTIVE voice rows (host-bucketed indices into vp, pad
    slots -> the appended sentinel row), so each chunk renders
    [K, chunk] instead of [V, chunk] — K = max concurrent voices.  Long
    sparse songs (a MIDI file with thousands of notes, ~tens sounding
    at once) drop from O(V * frames) to O(K * frames) voice-samples.

    Rows render UNGROUPED (the mixed-wave select path): per-chunk
    gathers cannot keep a static wave grouping, so every row pays each
    used waveform once — bounded by len(used_waves), orders below the
    V/K win.  The [K, 2] pan matmul's f32 reduction tree differs from
    the flat [V, 2] one, so output matches the flat render within the
    same <=1-LSB-at-int16 class as render_song_grouped/mesh renders
    (active rows keep their packed ORDER; dropped rows are the flat
    sum's exact zeros)."""
    key = ("bucketed", cf, sr, H, uw, uf, ug, ub, ua, ud)
    fn = _bank_fn_cache.get(key)
    if fn is None:
        @functools.partial(jax.jit, static_argnames=("nchunks",))
        def fn(vp: VoiceParams, idx, pad_start, nchunks: int):
            vp_pad = _append_pad_voice(vp, pad_start)
            def body(_, xs):
                i, idx_k = xs
                vpk = jax.tree_util.tree_map(
                    lambda a: jnp.take(a, idx_k, axis=0), vp_pad)
                return 0, render_block(vpk, i * cf, cf, sr, H, None, uw,
                                       uf, use_glide=ug, use_bend=ub,
                                       use_amp=ua, use_dmod=ud)
            _, out = jax.lax.scan(
                body, 0, (jnp.arange(nchunks, dtype=jnp.int32), idx))
            return out.reshape(-1, 2)
        _bank_fn_cache[key] = fn
    return fn


def _bank_grouped_fn(cf: int, sr: int, H: int, uw: tuple, uf: bool,
                     ly: Optional[BankLayout], nseg: int, ug: bool = False,
                     ub: bool = False, ua: bool = False, ud: bool = False):
    key = ("grouped", cf, sr, H, uw, uf, ly, nseg, ug, ub, ua, ud)
    fn = _bank_fn_cache.get(key)
    if fn is None:
        @functools.partial(jax.jit, static_argnames=("nchunks",))
        def fn(vp: VoiceParams, seg, nchunks: int):
            def body(_, i):
                return 0, render_block(vp, i * cf, cf, sr, H, ly, uw, uf,
                                       seg=seg, nseg=nseg, use_glide=ug,
                                       use_bend=ub, use_amp=ua, use_dmod=ud)
            _, out = jax.lax.scan(body, 0,
                                  jnp.arange(nchunks, dtype=jnp.int32))
            return out.reshape(-1, nseg, 2)
        _bank_fn_cache[key] = fn
    return fn


def _bank_grouped_chunk_fn(cf: int, sr: int, H: int, uw: tuple, uf: bool,
                           ly: Optional[BankLayout], nseg: int,
                           ug: bool = False, ub: bool = False,
                           ua: bool = False, ud: bool = False):
    key = ("grouped_chunk", cf, sr, H, uw, uf, ly, nseg, ug, ub, ua, ud)
    fn = _bank_fn_cache.get(key)
    if fn is None:
        @jax.jit
        def fn(vp: VoiceParams, seg, n0):
            return render_block(vp, n0, cf, sr, H, ly, uw, uf,
                                seg=seg, nseg=nseg, use_glide=ug,
                                use_bend=ub, use_amp=ua, use_dmod=ud)
        _bank_fn_cache[key] = fn
    return fn


class VoiceBank:
    """Compiled batched renderer for a fixed (V, chunk, samplerate) shape."""

    def __init__(self, nvoices: int, samplerate: int = 44100,
                 chunk_frames: int = 8192, num_harmonics: int = 8,
                 used_waves: tuple = ALL_WAVES, use_fm: bool = True,
                 layout: Optional[BankLayout] = None,
                 use_glide: bool = False, use_bend: bool = False,
                 use_amp: bool = False, use_dmod: bool = False):
        self.nvoices = nvoices
        self.samplerate = samplerate
        self.chunk_frames = chunk_frames
        self.num_harmonics = num_harmonics
        self.used_waves = tuple(sorted(used_waves))
        self.use_fm = use_fm
        self.use_glide = use_glide
        self.use_bend = use_bend
        self.use_amp = use_amp
        self.use_dmod = use_dmod
        self.layout = layout
        self._chunk_fn, self._song_fn = _bank_fns(
            chunk_frames, samplerate, num_harmonics, self.used_waves,
            use_fm, layout, use_glide, use_bend, use_amp, use_dmod)

    @classmethod
    def for_voices(cls, voices: Sequence[Voice], samplerate: int = 44100,
                   chunk_frames: int = 8192, num_harmonics: int = 8,
                   layout: Optional[BankLayout] = None,
                   nvoices: Optional[int] = None) -> "VoiceBank":
        """Bank statically specialized to the waveforms/FM these voices use."""
        used = tuple(sorted({WAVE_IDS[v.wave] for v in voices})) or (0,)
        use_fm = any(v.fm_depth != 0.0 for v in voices)
        use_glide = any(v.glide_from > 0.0 and v.glide_time > 0.0
                        and v.frequency > 0.0 for v in voices)
        use_bend = any(v.pitch_curve for v in voices)
        use_amp = any(v.amp_curve for v in voices)
        use_dmod = any(v.fm_depth_curve for v in voices)
        if 8 not in used and 12 not in used:
            num_harmonics = 0
        return cls(nvoices or len(voices), samplerate, chunk_frames,
                   num_harmonics, used_waves=used, use_fm=use_fm,
                   layout=layout, use_glide=use_glide, use_bend=use_bend,
                   use_amp=use_amp, use_dmod=use_dmod)

    def render_chunk(self, vp: VoiceParams, n0: int) -> jax.Array:
        """One streaming chunk: stereo f32 [chunk, 2] (stateless)."""
        return self._chunk_fn(vp, jnp.int32(n0))

    def render_song(self, vp: VoiceParams, total_frames: int) -> jax.Array:
        """Offline mixdown: stereo f32 [total_frames, 2] — one jitted scan
        over chunks."""
        nchunks = -(-total_frames // self.chunk_frames)
        out = self._song_fn(vp, nchunks)
        return out[:total_frames]

    def render_song_sparse(self, vp: VoiceParams,
                           total_frames: int) -> jax.Array:
        """Sparse offline mixdown: stereo f32 [total_frames, 2].

        Host-buckets the voices by their active frame range (start ..
        start + gate + release, +2 frames of slack for the f32 envelope
        edge) and renders each chunk over only its K = max-concurrent
        active rows instead of all V — the voice-bank analog of the
        pitched sampler's hit bucketing (sequencer._bucket_pitched).  A
        3,000-note MIDI file with ~15 notes sounding renders ~V/K times
        fewer voice-samples than :meth:`render_song`.

        Output matches render_song within 1 LSB at int16 (the [K, 2]
        pan matmul's f32 reduction tree vs the flat [V, 2] one — the
        same class as render_song_grouped / the mesh psum path; active
        rows keep their packed order and the dropped rows are exact
        zeros in the flat sum).  Falls back to render_song when the
        bucketed shape would not be smaller.  One compile per (chunk,
        K) shape — callers that need the one-compile-per-bank-shape
        guarantee (realtime/serving) should keep render_song."""
        plan = self.sparse_plan(vp, total_frames)
        if plan is None:
            return self.render_song(vp, total_frames)
        fn, idx, pad_start, nchunks = plan
        return fn(vp, idx, pad_start, nchunks)[:total_frames]

    def sparse_plan(self, vp: VoiceParams, total_frames: int,
                    ranges=None):
        """Host side of :meth:`render_song_sparse`: bucket the voices'
        active frame ranges per chunk -> (jitted_fn, idx [nchunks, K]
        i32, pad_start, nchunks), or None when the bucketed shape would
        not beat the flat render (the cost model below).  Call the fn
        as ``fn(vp, idx, pad_start, nchunks)`` — the silent sentinel
        row appends INSIDE the compiled program.

        ``ranges``: optional (starts, ends, live) int64/int64/bool host
        arrays (conservative cover: starts a lower bound, ends an upper
        bound of each voice's audible frames; live False = never
        audible).  Callers that still hold the host note list (e.g.
        midi.render_notes) should pass them — deriving the ranges from
        ``vp`` here costs several device->host transfers."""
        cf = self.chunk_frames
        nchunks = -(-total_frames // cf)
        sr = self.samplerate
        if ranges is not None:
            starts, ends, live = ranges
            V = int(starts.shape[0])
        else:
            starts = np.asarray(vp.start, np.int64)
            gates = np.asarray(vp.gate, np.int64)
            rel = np.ceil(np.asarray(vp.release, np.float64)
                          * sr).astype(np.int64)
            # _adsr's envelope runs to max(gate, attack+decay) +
            # release: a short-gate voice still completes its
            # attack+decay before the release leg (sustain span clamps
            # to >= 0, not the total)
            ad = np.ceil((np.asarray(vp.attack, np.float64)
                          + np.asarray(vp.decay, np.float64))
                         * sr).astype(np.int64)
            dur = np.maximum(gates, ad) + rel
            # slack: +2 frames for the f32 boundary compare, plus the
            # f32 ulp of the envelope TIME SCALE — _adsr evaluates
            # t = n_rel/sr and t4 = a+d+s+r in f32, which round at
            # 2^-24 RELATIVE, so a 10-minute note's end can land a few
            # frames past the f64 bound (dur >> 20 = dur * 2^-20,
            # 16x the worst single rounding, vectorized integer shift)
            ends = starts + dur + 2 + (dur >> 20)
            V = int(starts.shape[0])
            # silent rows never contribute: sig = (bias + amp*w) * env,
            # so a row needs amp or bias to be audible (curves only
            # SCALE env)
            live = (np.asarray(vp.amp) != 0.0) \
                | (np.asarray(vp.bias) != 0.0)
        first_c = np.maximum(0, starts // cf)
        last_c = np.minimum(nchunks - 1, (ends - 1) // cf)
        span_ok = live & (last_c >= first_c)
        # K first, vectorized (difference array + cumsum), so dense
        # songs bail out below WITHOUT paying the O(V x span) python
        # bucket fill
        delta = np.zeros(nchunks + 1, np.int64)
        np.add.at(delta, first_c[span_ok], 1)
        np.add.at(delta, last_c[span_ok] + 1, -1)
        K = int(np.cumsum(delta)[:nchunks].max(initial=0)) or 1
        K += -K % 8                                    # lane-pad
        # cost model: bucketed rows pay every used waveform (ungrouped
        # select) where grouped flat rows pay one — sparse wins when
        # V > K * (1 + n_waves)/2 (waveform eval ~ half the row cost)
        if K * (1 + len(self.used_waves)) >= 2 * V:
            return None
        idx = np.full((nchunks, K), V, np.int32)       # V = sentinel row
        fill = np.zeros(nchunks, np.int32)
        for v in np.flatnonzero(span_ok):
            for c in range(int(first_c[v]), int(last_c[v]) + 1):
                idx[c, fill[c]] = v
                fill[c] += 1
        fn = _bank_bucketed_fn(cf, sr, self.num_harmonics,
                               self.used_waves, self.use_fm,
                               self.use_glide, self.use_bend,
                               self.use_amp, self.use_dmod)
        return fn, jnp.asarray(idx), total_frames + cf + 8, nchunks

    def render_song_grouped(self, vp: VoiceParams, seg, nseg: int,
                            total_frames: int) -> jax.Array:
        """Coalesced mixdown: every voice renders in ONE bank program and
        the pan matmul scatters each voice into its segment's stereo bus ->
        f32 [total_frames, nseg, 2].  Silent pad voices contribute exact
        zeros, and a request's own voices sum in their packed order, so a
        segment's bus matches its solo render within 1 LSB (reduction-tree
        order may differ between the [V_all] and [V_i] matmul shapes)."""
        fn = _bank_grouped_fn(self.chunk_frames, self.samplerate,
                              self.num_harmonics, self.used_waves,
                              self.use_fm, self.layout, int(nseg),
                              self.use_glide, self.use_bend, self.use_amp,
                              self.use_dmod)
        nchunks = -(-total_frames // self.chunk_frames)
        out = fn(vp, jnp.asarray(seg, jnp.int32), nchunks)
        return out[:total_frames]

    def render_chunk_grouped(self, vp: VoiceParams, seg, nseg: int,
                             n0: int) -> jax.Array:
        """One streaming chunk of the grouped render: stereo buses
        f32 [chunk, nseg, 2] (stateless in the absolute frame index, like
        ``render_chunk``).  Used by the sequencer's per-synth-track fx
        path, where each fx'd track needs its own bus per chunk."""
        fn = _bank_grouped_chunk_fn(self.chunk_frames, self.samplerate,
                                    self.num_harmonics, self.used_waves,
                                    self.use_fm, self.layout, int(nseg),
                                    self.use_glide, self.use_bend,
                                    self.use_amp, self.use_dmod)
        return fn(vp, jnp.asarray(seg, jnp.int32), jnp.int32(n0))

    @staticmethod
    def to_int16(stereo_f32: jax.Array,
                 master_gain: float = 1.0) -> jax.Array:
        """f32 mix -> saturating int16 (trackmixer's widen-then-narrow
        path).  Static: the sharded render paths (parallel/mesh.py,
        midi.render_notes(mesh=)) quantize through THIS function too, so
        mesh output can never silently diverge from the single-device
        rule."""
        v = jnp.rint(stereo_f32 * jnp.float32(32767.0 * master_gain))
        return jnp.clip(v, -32768, 32767).astype(jnp.int16)
