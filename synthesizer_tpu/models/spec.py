"""Oscillator patch specification — pure data, no jax/numpy.

A *patch* is a DAG of these frozen dataclasses.  The same spec tree is
consumed by two independent evaluators:

* ``goldref.osc.render_oracle``      — numpy, whole-signal, the arbiter;
* ``synthesizer_tpu.models.graph``   — JAX lowering to a scan step function.

This mirrors the reference's oscillator DAG (SURVEY.md §3.1 row 4) where a
patch is a tree of lazy generator objects; here the tree is explicit data so
it can be lowered to one fused device program.

Numeric spec (shared by both evaluators — this docstring is the contract):

* Phase is a 32-bit fixed-point turn accumulator (DDS): 2**32 units = one
  cycle.  Static-frequency oscillators use a host-computed exact integer
  increment ``round(freq/samplerate * 2**32)``; under FM the per-sample
  increment is ``int32(clamp(f32(base_inc) * (1 + fm_n)))`` (f32 multiply,
  truncation toward zero, clamp to ±(2**31 - 256)).
* The waveform value for phase p is a float32 function of x = f32(p)*2**-32;
  harmonic partials with integer ratio k use the exact wrapped phase ``p*k``
  (uint32 multiply).
* value_n = bias + amplitude * wave(phase_n); phase advances after the
  sample is emitted; the ``phase`` constructor argument is in turns.
* White noise: sample-and-hold counter hash (see ``noise_u32`` in
  goldref.osc) — identical integer recurrence on both sides, seeded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

Node = Union[
    "Osc", "Linear", "Envelope", "Mix", "AmpMod", "Delay", "Echo",
    "Clip", "Abs", "Null", "Const", "Biquad", "HostSource",
]

#: waveform kinds for Osc.  The *_bl variants are polyBLEP-bandlimited
#: (aliasing-suppressed) editions of the naive discontinuous waves — a
#: cheaper alternative to the reference's additive *_h approximations.
#: "wavetable" (beyond-reference) reads a user-supplied single-cycle table
#: with linear interpolation: pos = x*T, v = lerp(table[i mod T],
#: table[(i+1) mod T], frac), all f32.
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
    """ADSR gain applied to a source; sustain is a *duration* (the reference's
    EnvelopeFilter renders without a gate, SURVEY.md §3.1 row 4).

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


@dataclasses.dataclass(frozen=True)
class HostSource:
    """A host-produced f32 sample stream — the graph's USER EXTENSION
    point (the reference's open pull model: any object with ``blocks()``
    composes into a patch; SURVEY §3.1 row 4).  The node itself is pure
    identity: ``key`` refers to a pull function registered with the graph
    engine (``models.graph.register_host_source``); before lowering, keys
    are canonicalized to per-patch slots so structurally-equal patches
    share one compiled program regardless of instance identity.

    Evaluation is a HYBRID: the device program for the whole downstream
    patch (envelopes, echos, filters, mixes…) compiles once and runs per
    block; the host source's block is staged into device memory each
    step (one host->device transfer per block — the documented boundary
    cost).
    Host-source patches stream block-by-block; they cannot inline into a
    single offline ``lax.scan`` (the host cannot inject data mid-scan),
    so ``render_patch`` falls back to the per-block loop for them."""
    key: int


#: node child attributes that may hold a single sub-node
_CHILD_ATTRS = ("source", "modulator", "fm_lfo", "pwm_lfo", "cutoff_lfo")


def map_children(node: Node, fn) -> Node:
    """Rebuild ``node`` with ``fn`` applied to each direct child node
    (identity-preserving: returns ``node`` itself when nothing changed)."""
    changes = {}
    for name in _CHILD_ATTRS:
        v = getattr(node, name, None)
        if v is not None and dataclasses.is_dataclass(v):
            nv = fn(v)
            if nv is not v:
                changes[name] = nv
    if isinstance(node, Mix):
        new = tuple(fn(s) for s in node.sources)
        if any(a is not b for a, b in zip(new, node.sources)):
            changes["sources"] = new
    return dataclasses.replace(node, **changes) if changes else node


def has_host_source(node: Node) -> bool:
    if isinstance(node, HostSource):
        return True
    found = False

    def walk(nd):
        nonlocal found
        if isinstance(nd, HostSource):
            found = True
        else:
            map_children(nd, walk)
        return nd

    map_children(node, walk)
    return found


def canonical_host_patch(node: Node):
    """Renumber HostSource keys to per-patch slots in traversal order ->
    (canonical_node, [original keys by slot]).  Two patches with the same
    structure then share one compiled program; the stream driver maps
    slots back to the registered pulls."""
    keys: list = []

    def walk(nd):
        if isinstance(nd, HostSource):
            if nd.key in keys:
                slot = keys.index(nd.key)
            else:
                slot = len(keys)
                keys.append(nd.key)
            return HostSource(slot) if nd.key != slot else nd
        return map_children(nd, walk)

    return walk(node), keys


def phase_increment(frequency: float, samplerate: int) -> int:
    """Exact host-side DDS increment: round(freq/sr * 2**32), wrapped u32."""
    return int(round(frequency / samplerate * 4294967296.0)) & 0xFFFFFFFF


def phase_offset(phase_turns: float) -> int:
    return int(round((phase_turns % 1.0) * 4294967296.0)) & 0xFFFFFFFF
