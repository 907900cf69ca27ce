"""Device lowering of oscillator patch specs.

Turns a ``models.spec`` patch tree into a single fused JAX step function

    step(state, n0) -> (f32 values[blocksize], new_state)

which renders one fixed-size block of samples at absolute offset ``n0``.
Whole renders run the step under ``lax.scan`` in one jit (control on host,
chunks on device — SURVEY.md §7); realtime streams call the jitted step
block by block.  Results are block-size invariant by construction: phase
accumulators and FM integrals are integer (wrapping u32), delay/echo tails
are carried exactly, envelopes/LFOs are closed-form in the absolute sample
index.  The ONE approximate node is ``Biquad`` (IIR): its parallel affine
scan's f32 rounding depends on the grouping, so block-size invariance and
oracle agreement hold to a few LSB, not bit-exactly (documented in the
spec node).

This replaces the reference's per-sample Python generator DAG
(``synthplayer/oscillators.py``, SURVEY.md §4.1 hot loop) with one compiled
program per patch structure.  Numeric contract: ``goldref.osc``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import spec as S
from ..ops.trig import cos_turns, sin_turns

_TWO_PI = np.float32(2.0 * math.pi)
_TWO_NEG32 = np.float32(2.0 ** -32)

State = Any
StepFn = Callable[[State, jax.Array], Tuple[jax.Array, State]]


def _phase_x(p: jax.Array) -> jax.Array:
    return p.astype(jnp.float32) * _TWO_NEG32


def _triangle(x: jax.Array) -> jax.Array:
    four = jnp.float32(4.0)
    return jnp.where(x < 0.25, four * x,
                     jnp.where(x < 0.75, jnp.float32(2.0) - four * x,
                               four * x - four))


def poly_blep(t: jax.Array, dt: float) -> jax.Array:
    """Quadratic polyBLEP residual (spec: goldref.osc.poly_blep)."""
    dt = np.float32(max(dt, 1e-9))
    u0 = t / dt
    lo = (u0 + u0) - u0 * u0 - jnp.float32(1.0)
    u1 = (t - jnp.float32(1.0)) / dt
    hi = u1 * u1 + (u1 + u1) + jnp.float32(1.0)
    return jnp.where(t < dt, lo, jnp.where(t > jnp.float32(1.0) - dt, hi,
                                           jnp.float32(0.0)))


def _noise_u32_host(idx: int, seed: int) -> int:
    """Host twin of the counter hash (pluck's static per-harmonic
    excitation constants; spec: goldref/spec.py docstring)."""
    M = 0xFFFFFFFF
    x = (idx * 0x9E3779B9 + (seed & M)) & M
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M
    x ^= x >> 15
    x = (x * 0x846CA68B) & M
    x ^= x >> 16
    return x


def _noise_u32(idx: jax.Array, seed: int) -> jax.Array:
    x = idx.astype(jnp.uint32) * jnp.uint32(0x9E3779B9) + jnp.uint32(seed & 0xFFFFFFFF)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _noise_values(idx: jax.Array, seed: int) -> jax.Array:
    x = _noise_u32(idx, seed)
    return (x >> 8).astype(jnp.float32) * jnp.float32(2.0 ** -23) - jnp.float32(1.0)


def _wave_values(node: S.Osc, p: jax.Array, sr: int, n_abs: jax.Array,
                 pwm_vals) -> jax.Array:
    k = node.kind
    if k == "sine":
        return sin_turns(_phase_x(p))
    if k == "triangle":
        return _triangle(_phase_x(p))
    if k == "square":
        return jnp.where(p < jnp.uint32(1 << 31), jnp.float32(1.0), jnp.float32(-1.0))
    if k == "sawtooth":
        return jnp.float32(2.0) * _phase_x(p) - jnp.float32(1.0)
    if k == "pulse":
        if pwm_vals is not None:
            w = jnp.clip(pwm_vals, jnp.float32(1.0 / 65536.0),
                         jnp.float32(1.0 - 1.0 / 65536.0))
            wu = (w * jnp.float32(4294967296.0)).astype(jnp.uint32)
        else:
            w = min(max(node.pulse_width, 1.0 / 65536.0), 1.0 - 1.0 / 65536.0)
            wu = jnp.uint32(int(np.float32(w) * 4294967296.0) & 0xFFFFFFFF)
        return jnp.where(p < wu, jnp.float32(1.0), jnp.float32(-1.0))
    if k == "square_h":
        acc = jnp.zeros(p.shape, jnp.float32)
        for i in range(node.num_harmonics):
            kk = 2 * i + 1
            pk = p * jnp.uint32(kk)
            acc = acc + sin_turns(_phase_x(pk)) / jnp.float32(kk)
        return acc
    if k == "sawtooth_h":
        acc = jnp.zeros(p.shape, jnp.float32)
        for kk in range(1, node.num_harmonics + 1):
            pk = p * jnp.uint32(kk)
            term = sin_turns(_phase_x(pk)) / jnp.float32(kk)
            acc = acc + (term if kk % 2 == 1 else -term)
        return acc
    if k == "harmonics":
        acc = jnp.zeros(p.shape, jnp.float32)
        for ratio, amp in node.harmonics:
            if float(ratio).is_integer():
                pk = p * jnp.uint32(int(ratio))
                acc = acc + jnp.float32(amp) * sin_turns(_phase_x(pk))
            else:
                acc = acc + jnp.float32(amp) * jnp.sin(
                    _TWO_PI * (jnp.float32(ratio) * _phase_x(p)))
        return acc
    if k == "white_noise":
        hold = max(1, int(round(sr / node.frequency))) if node.frequency > 0 else 1
        idx = (n_abs // jnp.int32(hold)).astype(jnp.uint32)
        return _noise_values(idx, node.seed)
    if k == "semicircle":
        x = _phase_x(p)
        one = jnp.float32(1.0)
        up = jnp.sqrt(jnp.maximum(jnp.float32(0.0),
                                  one - (jnp.float32(4.0) * x - one) ** 2))
        dn = -jnp.sqrt(jnp.maximum(jnp.float32(0.0),
                                   one - (jnp.float32(4.0) * x - jnp.float32(3.0)) ** 2))
        return jnp.where(x < 0.5, up, dn)
    if k == "pointy":
        t = _triangle(_phase_x(p))
        return t * t * t
    if k == "wavetable":
        # single-cycle table, linear interp with wraparound (spec:
        # goldref.osc; one gather — beyond-reference waveform)
        table = jnp.asarray(np.asarray(node.table, np.float32))
        T = len(node.table)
        x = _phase_x(p)
        pos = x * jnp.float32(T)
        i = jnp.minimum(pos.astype(jnp.int32), T - 1)
        frac = pos - i.astype(jnp.float32)
        lo = table[i]
        hi = table[(i + 1) % T]
        return lo + (hi - lo) * frac
    if k == "pluck":
        # Karplus-Strong, spectral form (spec: goldref/spec.py docstring).
        # The node is static, so the per-harmonic excitation amps, phase
        # offsets, and decay exponents are host-computed f32 numpy (same
        # steps as the spec); only exp(n*alpha)*sin(phase) traces.
        K = max(1, int(node.num_harmonics))
        inc = S.phase_increment(node.frequency, sr)
        ratio = np.float32(np.float32(inc) * np.float32(2.0 ** -32))
        active = [kk for kk in range(1, K + 1)
                  if inc != 0 and kk * inc < (1 << 31)]
        u = np.asarray([np.float32(
            (_noise_u32_host(kk, node.seed) >> 8)
            * np.float32(2.0 ** -23) - np.float32(1.0))
            for kk in (active or [1])], np.float32)
        denom = np.float32(max(np.abs(u.astype(np.float64)).sum(), 1e-30))
        nrel = jnp.maximum(n_abs, 0).astype(jnp.float32)
        acc = jnp.zeros(p.shape, jnp.float32)
        for j, kk in enumerate(active):
            a_k = np.float32(u[j] / denom)
            phi = _noise_u32_host(K + kk, node.seed)
            g = np.float32(np.cos(np.float32(np.pi) * np.float32(kk) * ratio))
            alpha = np.float32(np.float32(node.damping) * ratio
                               * np.log(max(g, np.float32(1e-30))))
            pk = p * jnp.uint32(kk) + jnp.uint32(phi)
            acc = acc + (jnp.float32(a_k) * jnp.exp(nrel * jnp.float32(alpha))
                         * sin_turns(_phase_x(pk)))
        return acc
    if k == "sawtooth_bl":
        x = _phase_x(p)
        dt = node.frequency / sr
        return (jnp.float32(2.0) * x - jnp.float32(1.0)) - poly_blep(x, dt)
    if k == "square_bl":
        x = _phase_x(p)
        dt = node.frequency / sr
        naive = jnp.where(p < jnp.uint32(1 << 31), jnp.float32(1.0), jnp.float32(-1.0))
        x2 = jnp.where(x < 0.5, x + jnp.float32(0.5), x - jnp.float32(0.5))
        return naive + poly_blep(x, dt) - poly_blep(x2, dt)
    raise ValueError(f"unknown waveform {k}")


@jax.tree_util.register_pytree_node_class
class HostBuf:
    """State leaf for a HostSource node: the per-block staging buffer the
    stream driver refills from the host pull before every step.  A custom
    pytree node so the driver can find/replace these leaves robustly in
    the composed patch state (``slot`` rides the static treedef)."""

    def __init__(self, slot: int, data):
        self.slot = slot
        self.data = data

    def tree_flatten(self):
        return (self.data,), self.slot

    @classmethod
    def tree_unflatten(cls, slot, children):
        return cls(slot, children[0])


#: HostSource key -> pull FACTORY (zero-arg callable returning a fresh
#: ``pull(n0, nframes) -> np.float32[<=nframes] | None`` for one stream).
#: Registered by oscillators.UserOscillator; entries are removed by its
#: weakref finalizer when the wrapper is garbage-collected.
_HOST_PULLS: dict = {}
_host_key_counter = [0]


def new_host_key() -> int:
    _host_key_counter[0] += 1
    return _host_key_counter[0]


def register_host_source(key: int, pull_factory) -> None:
    _HOST_PULLS[key] = pull_factory


def unregister_host_source(key: int) -> None:
    _HOST_PULLS.pop(key, None)


def lower(node: S.Node, samplerate: int, blocksize: int) -> Tuple[State, StepFn]:
    """Recursively lower a spec tree to (init_state, step)."""
    B = blocksize

    if isinstance(node, S.HostSource):
        def step(state, n0):
            return state.data, state
        return HostBuf(node.key, jnp.zeros((B,), jnp.float32)), step

    if isinstance(node, S.Const):
        def step(state, n0):
            return jnp.full((B,), jnp.float32(node.value)), state
        return (), step

    if isinstance(node, S.Linear):
        def step(state, n0):
            n = (n0 + jnp.arange(B, dtype=jnp.int32)).astype(jnp.float32)
            v = jnp.float32(node.start) + n * jnp.float32(node.increase)
            return jnp.clip(v, jnp.float32(node.min_value), jnp.float32(node.max_value)), state
        return (), step

    if isinstance(node, S.Osc):
        inc0 = S.phase_increment(node.frequency, samplerate)
        p0 = S.phase_offset(node.phase)
        pwm_init, pwm_step = (None, None)
        if node.kind == "pulse" and node.pwm_lfo is not None:
            pwm_init, pwm_step = lower(node.pwm_lfo, samplerate, blocksize)

        if node.fm_lfo is None:
            def step(state, n0):
                pwm_state = state
                n = n0 + jnp.arange(B, dtype=jnp.int32)
                p = jnp.uint32(p0) + n.astype(jnp.uint32) * jnp.uint32(inc0)
                pwm_vals = None
                if pwm_step is not None:
                    pwm_vals, pwm_state = pwm_step(pwm_state, n0)
                w = _wave_values(node, p, samplerate, n, pwm_vals)
                out = jnp.float32(node.bias) + jnp.float32(node.amplitude) * w
                return out, pwm_state
            return (pwm_init if pwm_step is not None else ()), step

        fm_init, fm_step = lower(node.fm_lfo, samplerate, blocksize)

        def step(state, n0):
            phase, fm_state, pwm_state = state
            fm, fm_state = fm_step(fm_state, n0)
            base = jnp.float32(np.float32(np.uint32(inc0)))
            inc_f = base * (jnp.float32(1.0) + fm)
            inc_f = jnp.clip(inc_f, jnp.float32(-(2**31 - 256)), jnp.float32(2**31 - 256))
            inc = inc_f.astype(jnp.int32).astype(jnp.uint32)
            csum = jnp.cumsum(inc)
            p = phase + csum - inc            # exclusive cumsum
            new_phase = phase + csum[-1]
            n = n0 + jnp.arange(B, dtype=jnp.int32)
            pwm_vals = None
            if pwm_step is not None:
                pwm_vals, pwm_state = pwm_step(pwm_state, n0)
            w = _wave_values(node, p, samplerate, n, pwm_vals)
            out = jnp.float32(node.bias) + jnp.float32(node.amplitude) * w
            return out, (new_phase, fm_state, pwm_state)

        init = (jnp.uint32(p0), fm_init, pwm_init if pwm_step is not None else ())
        return init, step

    if isinstance(node, S.Envelope):
        src_init, src_step = lower(node.source, samplerate, blocksize)

        def step(state, n0):
            v, state = src_step(state, n0)
            n = n0 + jnp.arange(B, dtype=jnp.int32)
            g = envelope_gains_device(n, samplerate, node)
            return v * g, state
        return src_init, step

    if isinstance(node, S.Mix):
        lowered = [lower(s, samplerate, blocksize) for s in node.sources]

        def step(state, n0):
            acc = jnp.zeros((B,), jnp.float32)
            new_states = []
            for (_, st_fn), st in zip(lowered, state):
                v, st2 = st_fn(st, n0)
                acc = acc + v
                new_states.append(st2)
            return acc, tuple(new_states)
        return tuple(init for init, _ in lowered), step

    if isinstance(node, S.AmpMod):
        a_init, a_step = lower(node.source, samplerate, blocksize)
        m_init, m_step = lower(node.modulator, samplerate, blocksize)

        def step(state, n0):
            sa, sm = state
            va, sa = a_step(sa, n0)
            vm, sm = m_step(sm, n0)
            return va * vm, (sa, sm)
        return (a_init, m_init), step

    if isinstance(node, S.Delay):
        d = int(round(node.seconds * samplerate))
        src_init, src_step = lower(node.source, samplerate, blocksize)
        if d <= 0:
            return src_init, src_step

        def step(state, n0):
            tail, sstate = state
            v, sstate = src_step(sstate, n0)
            buf = jnp.concatenate([tail, v])
            return buf[:B], (buf[-d:], sstate)
        return (jnp.zeros((d,), jnp.float32), src_init), step

    if isinstance(node, S.Echo):
        d_after = int(round(node.after * samplerate))
        d_delay = int(round(node.delay * samplerate))
        dmax = d_after + node.amount * d_delay
        gains = []
        g = 1.0
        for _ in range(node.amount):
            g *= node.decay
            gains.append(np.float32(g))
        src_init, src_step = lower(node.source, samplerate, blocksize)
        if dmax <= 0:
            return src_init, src_step

        def step(state, n0):
            tail, sstate = state
            v, sstate = src_step(sstate, n0)
            buf = jnp.concatenate([tail, v])       # [dmax + B]
            out = v
            for k, gk in enumerate(gains, start=1):
                dk = d_after + k * d_delay
                out = out + jnp.float32(gk) * jax.lax.dynamic_slice_in_dim(
                    buf, dmax - dk, B)
            return out, (buf[-dmax:], sstate)
        return (jnp.zeros((dmax,), jnp.float32), src_init), step

    if isinstance(node, S.Biquad):
        src_init, src_step = lower(node.source, samplerate, blocksize)
        swept = node.cutoff_lfo is not None
        if swept:
            lfo_init, lfo_step = lower(node.cutoff_lfo, samplerate, blocksize)
        else:
            sb0, sb1, sb2, sa1, sa2 = S.biquad_coeffs(
                node.kind, node.cutoff, node.q, samplerate)

        # the shared parallel companion-matrix IIR scan (its precision
        # notes are documented there)
        from ..ops.effects import companion_scan as _affine_scan

        def step(state, n0):
            if swept:
                x1, x2, y1, y2, lstate, sstate = state
                lv, lstate = lfo_step(lstate, n0)
                fc = jnp.clip(jnp.float32(node.cutoff) * jnp.exp2(lv),
                              jnp.float32(10.0),
                              jnp.float32(0.49 * samplerate))
                w0 = jnp.float32(2.0 * math.pi / samplerate) * fc
                alpha = jnp.sin(w0) / jnp.float32(2.0 * node.q)
                cw = jnp.cos(w0)
                if node.kind == "lowpass":
                    b0 = (1.0 - cw) * jnp.float32(0.5)
                    b1 = 1.0 - cw
                    b2 = b0
                elif node.kind == "highpass":
                    b0 = (1.0 + cw) * jnp.float32(0.5)
                    b1 = -(1.0 + cw)
                    b2 = b0
                else:
                    b0 = alpha
                    b1 = jnp.zeros_like(alpha)
                    b2 = -alpha
                a0r = jnp.float32(1.0) / (1.0 + alpha)
                b0, b1, b2 = b0 * a0r, b1 * a0r, b2 * a0r
                a1 = (-2.0 * cw) * a0r
                a2 = (1.0 - alpha) * a0r
            else:
                x1, x2, y1, y2, sstate = state
                b0, b1, b2 = (jnp.float32(sb0), jnp.float32(sb1),
                              jnp.float32(sb2))
                a1, a2 = jnp.float32(sa1), jnp.float32(sa2)
            x, sstate = src_step(sstate, n0)
            xp1 = jnp.concatenate([x1[None], x[:-1]])
            xp2 = jnp.concatenate([x2[None], x1[None], x[:-2]])
            u = b0 * x + b1 * xp1 + b2 * xp2
            y = _affine_scan(u, a1, a2, y1, y2)
            if swept:
                return y, (x[-1], x[-2], y[-1], y[-2], lstate, sstate)
            return y, (x[-1], x[-2], y[-1], y[-2], sstate)

        z = jnp.float32(0.0)
        if swept:
            init = (z, z, z, z, lfo_init, src_init)
        else:
            init = (z, z, z, z, src_init)
        return init, step

    if isinstance(node, S.Clip):
        src_init, src_step = lower(node.source, samplerate, blocksize)

        def step(state, n0):
            v, state = src_step(state, n0)
            return jnp.clip(v, jnp.float32(node.minimum), jnp.float32(node.maximum)), state
        return src_init, step

    if isinstance(node, S.Abs):
        src_init, src_step = lower(node.source, samplerate, blocksize)

        def step(state, n0):
            v, state = src_step(state, n0)
            return jnp.abs(v), state
        return src_init, step

    if isinstance(node, S.Null):
        return lower(node.source, samplerate, blocksize)

    raise TypeError(f"unknown spec node {type(node)}")


def envelope_gains_device(n: jax.Array, samplerate: int, e: S.Envelope) -> jax.Array:
    t = n.astype(jnp.float32) / jnp.float32(samplerate)
    a = np.float32(max(e.attack, 0.0))
    d = np.float32(max(e.decay, 0.0))
    s = np.float32(max(e.sustain, 0.0))
    r = np.float32(max(e.release, 0.0))
    sl = np.float32(e.sustain_level)
    t2, t3, t4 = a + d, a + d + s, a + d + s + r
    g = jnp.where(t < a, t / max(a, np.float32(1e-30)),
        jnp.where(t < t2, jnp.float32(1.0) + (sl - np.float32(1.0)) * (t - a) / max(d, np.float32(1e-30)),
        jnp.where(t < t3, sl,
        jnp.where(t < t4, sl * (t4 - t) / max(r, np.float32(1e-30)),
                  jnp.float32(0.0)))))
    return jnp.maximum(g, jnp.float32(0.0))


# ---------------------------------------------------------------------------
# Whole-patch rendering
# ---------------------------------------------------------------------------

_render_cache: dict = {}


def patch_values(node: S.Node, nsamples: int, samplerate: int,
                 blocksize: int = 8192) -> jax.Array:
    """Traceable patch render: samples [0, nsamples) -> f32[nsamples].

    Pure jax (scan over fixed-size blocks), so it can run standalone under
    ``render_patch``'s jit OR inline inside a larger fused program (the
    ``Sample`` lazy-IR stages it to keep whole chains one dispatch)."""
    if S.has_host_source(node):
        raise ValueError(
            "host-source patches cannot inline into one scan (the host "
            "cannot inject blocks mid-scan) — render via render_patch / "
            "block_stream, which run the per-block hybrid loop")
    nblocks = -(-nsamples // blocksize)
    init, step = lower(node, samplerate, blocksize)

    def body(carry, i):
        v, carry = step(carry, i * blocksize)
        return carry, v
    _, out = jax.lax.scan(body, init, jnp.arange(nblocks, dtype=jnp.int32))
    return out.reshape(-1)[:nsamples]


def render_patch(node: S.Node, nsamples: int, samplerate: int,
                 blocksize: int = 8192) -> jax.Array:
    """Render samples [0, nsamples) of a patch on device -> f32[nsamples].

    One jitted scan over fixed-size blocks; compiled once per
    (patch structure, nsamples, samplerate, blocksize).  Host-source
    patches (user oscillators) run the per-block hybrid loop instead —
    one staged transfer + dispatch per block (S.HostSource docstring).
    """
    if S.has_host_source(node):
        out = []
        got = 0
        for blk in block_stream(node, samplerate, blocksize):
            out.append(blk)
            got += len(blk)
            if got >= nsamples:
                break
        if not out:
            return jnp.zeros((nsamples,), jnp.float32)
        vals = np.concatenate(out)[:nsamples]
        if len(vals) < nsamples:            # source exhausted early: pad
            vals = np.pad(vals, (0, nsamples - len(vals)))
        return jnp.asarray(vals)
    key = (node, nsamples, samplerate, blocksize)
    fn = _render_cache.get(key)
    if fn is None:
        fn = jax.jit(lambda: patch_values(node, nsamples, samplerate, blocksize))
        _render_cache[key] = fn
    from ..utils import profiling
    profiling.record_program_launch()
    return fn()


#: compiled stream steps keyed by (node, samplerate, blocksize, samplewidth
#: or None) — a fresh jit closure per stream would recompile the patch for
#: every replay of the same sound (the per-instance-closure bug class
#: found on the serving path, see voicebank._bank_fns)
_stream_step_cache: dict = {}


def _stream_step(node: S.Node, samplerate: int, blocksize: int,
                 samplewidth: Optional[int]):
    key = (node, samplerate, blocksize, samplewidth)
    entry = _stream_step_cache.get(key)
    if entry is None:
        init, step = lower(node, samplerate, blocksize)

        @jax.jit
        def jstep(state, n0):
            vals, state = step(state, n0)
            if samplewidth is not None:
                vals = to_int_device(vals, samplewidth)
            return vals, state

        entry = (init, jstep)
        _stream_step_cache[key] = entry
    return entry


def block_stream(node: S.Node, samplerate: int, blocksize: int = 512,
                 samplewidth: Optional[int] = None) -> Iterator[np.ndarray]:
    """Host generator of blocks (the reference's ``Oscillator.blocks()``
    pull model): device renders block k while the host consumes block k-1.

    With ``samplewidth`` the int quantization fuses into the same
    per-block device program.  Programs are cached per patch structure, so
    replaying a sound never recompiles.

    Host-source patches (user oscillators) run the hybrid loop: the whole
    downstream patch is ONE compiled step, and each HostBuf state leaf is
    refilled from its registered pull before the step — one host->device
    staging per block.  The stream ends when a host source is exhausted
    (the reference's semantics: a finite custom generator ends the
    sound); its final short block is zero-padded and emitted."""
    if S.has_host_source(node):
        yield from _host_block_stream(node, samplerate, blocksize,
                                      samplewidth)
        return
    state, jstep = _stream_step(node, samplerate, blocksize, samplewidth)
    n0 = 0
    pending = None
    while True:
        vals, state = jstep(state, jnp.int32(n0))
        n0 += blocksize
        if pending is not None:
            yield np.asarray(pending)
        pending = vals


def _host_block_stream(node: S.Node, samplerate: int, blocksize: int,
                       samplewidth: Optional[int]) -> Iterator[np.ndarray]:
    canon, keys = S.canonical_host_patch(node)
    pulls = {}
    for slot, key in enumerate(keys):
        factory = _HOST_PULLS.get(key)
        if factory is None:
            raise ValueError(
                "host source not registered (was the UserOscillator "
                "garbage-collected while its patch was still in use?)")
        pulls[slot] = factory()
    state, jstep = _stream_step(canon, samplerate, blocksize, samplewidth)
    is_buf = lambda x: isinstance(x, HostBuf)
    n0 = 0
    while True:
        stop_before = False          # a source returned None: emit nothing
        stop_after = False           # a source returned a short final block

        def refill(x):
            nonlocal stop_before, stop_after
            if not isinstance(x, HostBuf):
                return x
            blk = pulls[x.slot](n0, blocksize)
            if blk is None or (blk := np.asarray(blk, np.float32)
                               .reshape(-1)).size == 0:
                stop_before = True
                return x
            if len(blk) < blocksize:
                stop_after = True
                blk = np.pad(blk, (0, blocksize - len(blk)))
            return HostBuf(x.slot, jnp.asarray(blk[:blocksize]))

        state = jax.tree_util.tree_map(refill, state, is_leaf=is_buf)
        if stop_before:
            return
        vals, state = jstep(state, jnp.int32(n0))
        yield np.asarray(vals)
        n0 += blocksize
        if stop_after:
            return


def int_block_stream(node: S.Node, samplerate: int, blocksize: int,
                     samplewidth: int) -> Iterator[np.ndarray]:
    """:func:`block_stream` quantized to int samples ON DEVICE in the same
    fused program as the patch step — one dispatch per block for the
    realtime ``*_gen`` paths (quantizing outside the jit would cost 2-3
    extra dispatches per 33 ms chunk)."""
    return block_stream(node, samplerate, blocksize, samplewidth=samplewidth)


def to_int_device(values: jax.Array, samplewidth: int) -> jax.Array:
    """f32 [-1,1] -> int samples: clip(rint(v * maxval)) (nearest-even)."""
    maxval = {1: 127.0, 2: 32767.0, 4: 2147483647.0}[samplewidth]
    dt = {1: jnp.int8, 2: jnp.int16, 4: jnp.int32}[samplewidth]
    v = jnp.rint(values * jnp.float32(maxval))
    if samplewidth == 4:
        hi = jnp.float32(2147483648.0)
        return jnp.where(v >= hi, jnp.int32(2**31 - 1),
                         jnp.where(v < -hi, jnp.int32(-2**31),
                                   jnp.clip(v, -hi, hi - 128).astype(jnp.int32)))
    return jnp.clip(v, {1: -128, 2: -32768}[samplewidth],
                    {1: 127, 2: 32767}[samplewidth]).astype(dt)
