"""Oracle-owned FROZEN copy of the patch-spec node types and DDS constants.

The golden oracle must not share code with the product it arbitrates:
if ``goldref`` imported ``synthesizer_tpu.models.spec``, a
semantics bug in the product's spec helpers (e.g. ``phase_increment``
rounding) would shift both sides of every differential test in lockstep.
This module is a deliberate copy, pinned by ``tests/test_oracle_anchors.py``
to absolute first-principles values (exact ``fractions.Fraction`` DDS
increments, pure-python f64 closed forms), so the oscillator contract has
an external anchor the way the PCM side is anchored to the real C audioop.

Node field names double as the structural contract: ``goldref.osc``
dispatches on type NAME + attributes, so it evaluates either this module's
trees or the product's ``synthesizer_tpu.models.spec`` trees — through its
OWN constants and math only.

Numeric spec (the contract both evaluators implement):

* Phase is a 32-bit fixed-point turn accumulator (DDS): 2**32 units = one
  cycle.  Static-frequency oscillators use a host-computed exact integer
  increment ``round(freq/samplerate * 2**32)``; under FM the per-sample
  increment is ``int32(clamp(f32(base_inc) * (1 + fm_n)))`` (f32 multiply,
  truncation toward zero, clamp to ±(2**31 - 256)).
* The waveform value for phase p is a float32 function of x = f32(p)*2**-32;
  harmonic partials with integer ratio k use the exact wrapped phase ``p*k``
  (uint32 multiply).
* value_n = bias + amplitude * wave(phase_n); the ``phase`` constructor
  argument is in turns.
* White noise: sample-and-hold counter hash (``noise_u32``), seeded.
* Pluck (Karplus–Strong in spectral form — the data-parallel formulation of
  the classic delay-line/averager loop): with K = num_harmonics,
  inc = phase_increment(f, sr), ratio = f32(inc) * 2**-32, and harmonic
  k in 1..K active iff k*inc < 2**31 (below Nyquist):

      u_k     = noise_values([k], seed)                      (excitation)
      a_k     = u_k / f32(sum_f64 of |u_j| over active j)    (unit peak)
      phi_k   = noise_u32([K + k], seed)                     (u32 phase)
      alpha_k = damping * ratio * f32(log(cos(pi*k*ratio)))  (f32 steps)
      value_n = sum_k a_k * exp(f32(n_rel) * alpha_k)
                      * sin(2*pi * x(p*k + phi_k))

  (the normalizing sum runs over the ACTIVE harmonics in float64, cast to
  f32 once — |value| <= 1 by construction, like every other waveform)

  cos(pi*k*ratio) is the one-pass gain of the KS averaging loop filter at
  harmonic k; raising it to n*f/sr trips (= exp(n_rel*alpha)) is exactly
  the recirculating decay, evaluated closed-form instead of sequentially.
  n_rel is n_abs in the graph engine and (n - voice_start) in the voice
  bank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

Node = Union[
    "Osc", "Linear", "Envelope", "Mix", "AmpMod", "Delay", "Echo",
    "Clip", "Abs", "Null", "Const", "Biquad",
]

WAVEFORMS = (
    "sine", "triangle", "square", "sawtooth", "pulse", "semicircle",
    "pointy", "square_h", "sawtooth_h", "harmonics", "white_noise",
    "sawtooth_bl", "square_bl", "wavetable", "pluck",
)


@dataclasses.dataclass(frozen=True)
class Osc:
    kind: str
    frequency: float
    amplitude: float = 1.0
    phase: float = 0.0
    bias: float = 0.0
    fm_lfo: Optional[Node] = None
    pwm_lfo: Optional[Node] = None     # pulse only
    pulse_width: float = 0.5           # pulse only (no pwm_lfo)
    num_harmonics: int = 8             # square_h / sawtooth_h / pluck
    harmonics: Tuple[Tuple[float, float], ...] = ()  # harmonics kind: (ratio, amp)
    seed: int = 0                      # white_noise / pluck excitation
    table: Tuple[float, ...] = ()      # wavetable: one cycle, f32 values
    damping: float = 1.0               # pluck: loop-loss exponent scale

    def __post_init__(self):
        if self.kind not in WAVEFORMS:
            raise ValueError(f"unknown waveform kind {self.kind!r}")
        if self.kind == "wavetable" and len(self.table) < 2:
            raise ValueError("wavetable needs a table of >= 2 samples")


@dataclasses.dataclass(frozen=True)
class Linear:
    """Ramp LFO: value_n = clip(start + n*increase, min, max), f32."""
    start: float
    increase: float = 0.0
    min_value: float = -1.0e6
    max_value: float = 1.0e6


@dataclasses.dataclass(frozen=True)
class Const:
    value: float


@dataclasses.dataclass(frozen=True)
class Envelope:
    """ADSR gain applied to a source; sustain is a *duration*.

    gain(t): t<a: t/a; t<a+d: 1+(sl-1)(t-a)/d; t<a+d+s: sl;
             t<a+d+s+r: sl*(t4-t)/r; else 0.   All f32.
    """
    source: Node
    attack: float
    decay: float
    sustain: float
    sustain_level: float
    release: float
    stop_at_end: bool = False

    @property
    def end_time(self) -> float:
        return self.attack + self.decay + self.sustain + self.release


@dataclasses.dataclass(frozen=True)
class Mix:
    sources: Tuple[Node, ...]


@dataclasses.dataclass(frozen=True)
class AmpMod:
    source: Node
    modulator: Node


@dataclasses.dataclass(frozen=True)
class Delay:
    """Shift the source ``seconds`` later in time (zeros before)."""
    source: Node
    seconds: float


@dataclasses.dataclass(frozen=True)
class Echo:
    """Feed-forward echo: out_n = src_n + sum_k decay^k * src_{n - D(k)},
    D(k) = round(after*sr) + k*round(delay*sr), k = 1..amount."""
    source: Node
    after: float
    amount: int
    delay: float
    decay: float


@dataclasses.dataclass(frozen=True)
class Biquad:
    """Second-order IIR filter (RBJ audio-EQ-cookbook coefficients), a
    beyond-reference node — the reference has no filters.

    y_n = b0 x_n + b1 x_{n-1} + b2 x_{n-2} - a1 y_{n-1} - a2 y_{n-2}
    with zero initial state.  The exact arbiter is the oracle's f64
    SEQUENTIAL recurrence; the device evaluates the same recurrence as a
    parallel affine scan in f32, specified to agree within
    a few LSB at 16-bit — up to ~16 LSB (-66 dB) when the poles
    approach the unit circle (strong resonance q >~ 8, or cutoff <<
    samplerate).  Block-size
    invariance holds to the same tolerance (f32 rounding depends on the
    scan grouping), unlike every other node's bit-exact invariance.
    """
    source: Node
    kind: str                      # "lowpass" | "highpass" | "bandpass"
    cutoff: float                  # Hz
    q: float = 0.7071              # resonance (Butterworth default)
    #: optional cutoff modulation in OCTAVES: fc_n = clip(cutoff *
    #: 2**lfo_n, 10 Hz, 0.49*sr); coefficients recompute per sample (the
    #: classic swept-filter sound — time-varying matrices drop straight
    #: into the same parallel scan)
    cutoff_lfo: Optional[Node] = None

    def __post_init__(self):
        if self.kind not in ("lowpass", "highpass", "bandpass"):
            raise ValueError(f"unknown filter kind {self.kind!r}")
        if self.cutoff <= 0 or self.q <= 0:
            raise ValueError("cutoff and q must be positive")


def biquad_coeffs(kind: str, cutoff: float, q: float,
                  samplerate: int) -> Tuple[float, float, float, float, float]:
    """RBJ cookbook coefficients (b0, b1, b2, a1, a2), normalized by a0,
    computed in f64 on host — shared verbatim by both evaluators."""
    import math
    w0 = 2.0 * math.pi * min(cutoff, samplerate * 0.49) / samplerate
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    if kind == "lowpass":
        b0, b1, b2 = (1 - cw) / 2, 1 - cw, (1 - cw) / 2
    elif kind == "highpass":
        b0, b1, b2 = (1 + cw) / 2, -(1 + cw), (1 + cw) / 2
    else:                                   # bandpass (constant 0 dB peak)
        b0, b1, b2 = alpha, 0.0, -alpha
    a0 = 1 + alpha
    return (b0 / a0, b1 / a0, b2 / a0, (-2 * cw) / a0, (1 - alpha) / a0)


def eq_band_coeffs(kind: str, freq: float, gain_db: float, q: float,
                   samplerate: int) -> Tuple[float, float, float, float,
                                             float]:
    """RBJ cookbook shelving/peaking coefficients (b0, b1, b2, a1, a2),
    normalized by a0, host f64 — the oracle's OWN copy of the parametric-EQ
    mapping (conformance-pinned against the product's in
    tests/test_coeffs_conformance.py).  A = 10^(gain_db/40); freq clamped
    to 0.49*samplerate."""
    import math
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


def eq_coeff_grids(kind: str, freq: float, gains_db, q: float,
                   samplerate: int, dtype=None):
    """Per-frame (b0, b1, b2, a1, a2) f32 grids from a per-frame gain_db
    array — the oracle's own copy of the vectorized eq_band_coeffs
    (conformance-pinned in tests/test_automation.py).  ``dtype=float64``
    keeps the unrounded grids (the compensated-scan comparison)."""
    import math
    import numpy as np
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
    return tuple(np.asarray(c / a0, dtype or np.float32)
                 for c in (b0, b1, b2, a1, a2))


def eq_freqs_coeff_grids(kind: str, freqs, gain_db: float, q: float,
                         samplerate: int, dtype=None):
    """Per-frame (b0, b1, b2, a1, a2) grids from a per-frame FREQUENCY
    array at a static gain — the oracle's own copy of the vectorized
    eq_band_coeffs over frequency (fx.filter.cutoff automation on the
    gain kinds; conformance-pinned in tests/test_coeffs_conformance)."""
    import math
    import numpy as np
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
    return tuple(np.asarray(c / a0, dtype or np.float64)
                 for c in (b0, b1, b2, a1, a2))


# -- BS.1770-4 loudness / true peak (the oracle's OWN copies, pinned equal
#    to the product's in tests/test_loudness.py) ------------------------------

_KW_SHELF = (1681.974450955533, 3.999843853973347, 0.7071752369554196)
_KW_SHELF_VB_EXP = 0.499666774155
_KW_HIGHPASS = (38.13547087602444, 0.5003270373238773)


def kweight_coeffs(samplerate: int):
    """The two K-weighting stages as normalized (b0, b1, b2, a1, a2)
    biquads, host f64 (bilinear re-derivation that reproduces the
    BS.1770-4 48 kHz tables to 1e-13)."""
    import math
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


def true_peak_filter():
    """The 4x-oversampling interpolation FIR for true-peak measurement:
    48-tap Kaiser(beta=8)-windowed sinc, each polyphase leg normalized to
    unit DC gain, f64 (the oracle's own copy)."""
    import numpy as np
    L, N = _TP_PHASES, _TP_TAPS
    n = np.arange(N, dtype=np.float64)
    x = (n - (N - 1) / 2.0) / L
    h = np.sinc(x) * np.kaiser(N, 8.0)
    for p in range(L):
        h[p::L] /= h[p::L].sum()
    return h


_HQ_TAPS_PER_PHASE = 32
_HQ_BETA = 9.0


def hq_resample_filter(up, down, taps_per_phase=_HQ_TAPS_PER_PHASE,
                       beta=_HQ_BETA):
    """Prototype lowpass for the hq polyphase resampler (the oracle's own
    copy; conformance-pinned against ops.coeffs.hq_resample_filter):
    Kaiser-windowed sinc at the up-times-oversampled rate, cutoff at the
    lower Nyquist, length taps_per_phase * max(up, down) rounded up to a
    multiple of up, per-leg unit-DC normalization, f64."""
    import numpy as np
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


@dataclasses.dataclass(frozen=True)
class Clip:
    source: Node
    minimum: float = -1.0
    maximum: float = 1.0


@dataclasses.dataclass(frozen=True)
class Abs:
    source: Node


@dataclasses.dataclass(frozen=True)
class Null:
    source: Node


def phase_increment(frequency: float, samplerate: int) -> int:
    """Exact host-side DDS increment: round(freq/sr * 2**32), wrapped u32."""
    return int(round(frequency / samplerate * 4294967296.0)) & 0xFFFFFFFF


def phase_offset(phase_turns: float) -> int:
    return int(round((phase_turns % 1.0) * 4294967296.0)) & 0xFFFFFFFF


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

    Copied verbatim into synthesizer_tpu.ops.coeffs (the oracle may not
    import the product); tests/test_coeffs_conformance.py pins the two
    copies equal."""
    import numpy as np
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
    [n] (the chorus/phaser phase rule — P_n = sum inc mod 2^32, constant
    rate == n*inc) and a per-frame (or scalar) depth in [0, 1]:

        x   = f32(P_n) * 2^-32
        lfo = 0.5 + 0.5*sin(2*pi*x)              (host f64 -> f32)
        g_n = f32(1 - depth_n * lfo_n)           (gain in [1-depth, 1])

    Copied verbatim into synthesizer_tpu.ops.coeffs; conformance-pinned
    in tests/test_coeffs_conformance.py."""
    import numpy as np
    p = np.asarray(P, np.uint64) & np.uint64(0xFFFFFFFF)
    x = p.astype(np.float32) * np.float32(2.0 ** -32)
    lfo = (np.float32(0.5) + np.float32(0.5)
           * np.sin(2.0 * np.pi * x.astype(np.float64)).astype(np.float32))
    d = np.asarray(depth, np.float32)
    return (np.float32(1.0) - d * lfo).astype(np.float32)


def autopan_pan_grid(P, depth):
    """Per-frame pan-position grid for the autopanner: pan_n =
    f32(depth_n * sin(2*pi*x)) in [-depth, depth]; applied through the
    house equal-gain pan law lg = min(1, 1-pan), rg = min(1, 1+pan).
    Same phase rule as :func:`tremolo_gain_grid`; conformance-pinned."""
    import numpy as np
    p = np.asarray(P, np.uint64) & np.uint64(0xFFFFFFFF)
    x = p.astype(np.float32) * np.float32(2.0 ** -32)
    s = np.sin(2.0 * np.pi * x.astype(np.float64)).astype(np.float32)
    return (np.asarray(depth, np.float32) * s).astype(np.float32)


def phaser_coeff_grids_swept(P, depth, min_freq: float, max_freq: float,
                             q: float, samplerate: int, dtype=None):
    """RATE/DEPTH-automated row of :func:`phaser_coeff_grids`
    (fx.phaser.rate/.depth spec): the LFO phase comes from a shared
    CUMULATIVE u32 phase ``P`` [n] (P_n = sum_{m<n} inc_m mod 2^32, with
    per-frame increments inc_m = round(rate_m/sr * 2^32) derived on host
    f64 from the breakpoint curve — the chorus-rate rule), and ``depth``
    is a per-frame f64 grid.  A constant rate reproduces P_n = n*inc, so
    the grids are bit-identical to the static function's.  Copied
    verbatim into synthesizer_tpu.ops.coeffs; conformance-pinned."""
    import numpy as np
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
