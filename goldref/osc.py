"""Golden-oracle oscillator evaluator (numpy, whole-signal).

Evaluates a patch tree with the exact numeric conventions of the
``goldref.spec`` docstring (fixed-point DDS phase, f32 waveform math,
integer harmonic phase multiply, hash-based noise).  The device evaluator
(``synthesizer_tpu.models.graph``) must match this to ≤1 LSB at 16-bit for
transcendental waveforms and bit-exactly for the integer-comparison
waveforms (square/pulse) given identical phase sequences.

The oracle owns its spec: node types and DDS constants come from
``goldref.spec`` (a deliberate frozen copy anchored to first principles in
``tests/test_oracle_anchors.py``), and dispatch is by type NAME +
attributes, so the product's ``synthesizer_tpu.models.spec`` trees evaluate
through the oracle's OWN constants — a product-side semantics bug cannot
shift the oracle.  Nothing here imports from
``synthesizer_tpu``.

Always renders from absolute sample 0 (the chunk-invariance of the device
scan is tested against this whole-signal evaluation).
"""

from __future__ import annotations

import math

import numpy as np

from . import spec as S

_MASK = np.uint64(0xFFFFFFFF)
_F32 = np.float32
_TWO_NEG32 = np.float32(2.0 ** -32)
_TWO_PI = np.float32(2.0 * math.pi)


def noise_u32(idx: np.ndarray, seed: int) -> np.ndarray:
    """Counter hash -> u32 (the white-noise spec; u32 wrap arithmetic).

    x = idx*0x9E3779B9 + seed; x ^= x>>16; x *= 0x7FEB352D; x ^= x>>15;
    x *= 0x846CA68B; x ^= x>>16
    """
    x = (idx.astype(np.uint64) * np.uint64(0x9E3779B9) + np.uint64(seed & 0xFFFFFFFF)) & _MASK
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & _MASK
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & _MASK
    x ^= x >> np.uint64(16)
    return x.astype(np.uint32)


def noise_values(idx: np.ndarray, seed: int) -> np.ndarray:
    """u32 hash -> f32 in [-1, 1): (x >> 8) * 2**-23 - 1."""
    x = noise_u32(idx, seed)
    return (x >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -23) - np.float32(1.0)


def _phase_x(p_u32: np.ndarray) -> np.ndarray:
    return p_u32.astype(np.float32) * _TWO_NEG32


def _triangle(x: np.ndarray) -> np.ndarray:
    four = _F32(4.0)
    return np.where(x < _F32(0.25), four * x,
                    np.where(x < _F32(0.75), _F32(2.0) - four * x,
                             four * x - four)).astype(np.float32)


def poly_blep(t: np.ndarray, dt: float) -> np.ndarray:
    """Two-sample polyBLEP residual at a downward unit step at t=0/1.

    t in [0,1) is the phase distance from the discontinuity, dt = f/sr.
    Standard quadratic polyBLEP (f32): smooths a -2 step into the naive
    waveform, suppressing aliasing above ~f_nyquist.
    """
    dt = _F32(max(dt, 1e-9))
    u0 = t / dt
    lo = (u0 + u0) - u0 * u0 - _F32(1.0)
    u1 = (t - _F32(1.0)) / dt
    hi = u1 * u1 + (u1 + u1) + _F32(1.0)
    return np.where(t < dt, lo, np.where(t > _F32(1.0) - dt, hi,
                                         _F32(0.0))).astype(np.float32)


def _wave_values(node: S.Osc, p: np.ndarray, sr: int,
                 n_abs: np.ndarray, pwm_vals) -> np.ndarray:
    k = node.kind
    if k == "sine":
        return np.sin(_TWO_PI * _phase_x(p)).astype(np.float32)
    if k == "triangle":
        return _triangle(_phase_x(p))
    if k == "square":
        return np.where(p < np.uint32(1 << 31), _F32(1.0), _F32(-1.0))
    if k == "sawtooth":
        return (_F32(2.0) * _phase_x(p) - _F32(1.0)).astype(np.float32)
    if k == "pulse":
        if pwm_vals is not None:
            w = np.clip(pwm_vals.astype(np.float32), _F32(1.0 / 65536.0),
                        _F32(1.0 - 1.0 / 65536.0))
            # f32 product then truncating u32 cast — identical on device
            wu = (w * np.float32(4294967296.0)).astype(np.uint32)
        else:
            w = min(max(node.pulse_width, 1.0 / 65536.0), 1.0 - 1.0 / 65536.0)
            wu = np.uint32(int(np.float32(w) * 4294967296.0) & 0xFFFFFFFF)
        return np.where(p < wu, _F32(1.0), _F32(-1.0))
    if k == "square_h":
        acc = np.zeros(p.shape, np.float32)
        for i in range(node.num_harmonics):
            kk = 2 * i + 1
            pk = (p.astype(np.uint64) * np.uint64(kk)) & _MASK
            acc = acc + np.sin(_TWO_PI * _phase_x(pk.astype(np.uint32))).astype(np.float32) / _F32(kk)
        return acc
    if k == "sawtooth_h":
        acc = np.zeros(p.shape, np.float32)
        for kk in range(1, node.num_harmonics + 1):
            pk = (p.astype(np.uint64) * np.uint64(kk)) & _MASK
            term = np.sin(_TWO_PI * _phase_x(pk.astype(np.uint32))).astype(np.float32) / _F32(kk)
            acc = acc + (term if kk % 2 == 1 else -term)
        return acc
    if k == "harmonics":
        acc = np.zeros(p.shape, np.float32)
        for ratio, amp in node.harmonics:
            if float(ratio).is_integer():
                pk = (p.astype(np.uint64) * np.uint64(int(ratio))) & _MASK
                acc = acc + _F32(amp) * np.sin(_TWO_PI * _phase_x(pk.astype(np.uint32))).astype(np.float32)
            else:
                acc = acc + _F32(amp) * np.sin(
                    _TWO_PI * (_F32(ratio) * _phase_x(p))).astype(np.float32)
        return acc
    if k == "white_noise":
        if node.frequency > 0:
            hold = max(1, int(round(sr / node.frequency)))
        else:
            hold = 1
        idx = (n_abs // hold).astype(np.uint32)
        return noise_values(idx, node.seed)
    if k == "semicircle":
        x = _phase_x(p)
        up = np.sqrt(np.maximum(_F32(0.0), _F32(1.0) - (_F32(4.0) * x - _F32(1.0)) ** 2))
        dn = -np.sqrt(np.maximum(_F32(0.0), _F32(1.0) - (_F32(4.0) * x - _F32(3.0)) ** 2))
        return np.where(x < _F32(0.5), up, dn).astype(np.float32)
    if k == "pointy":
        t = _triangle(_phase_x(p))
        return (t * t * t).astype(np.float32)
    if k == "wavetable":
        # pos = x*T (f32); i = min(floor(pos), T-1); linear interp with
        # wraparound — identical arithmetic on device
        table = np.asarray(node.table, np.float32)
        T = len(table)
        x = _phase_x(p)
        pos = (x * _F32(T)).astype(np.float32)
        i = np.minimum(pos.astype(np.int64), T - 1)
        frac = (pos - i.astype(np.float32)).astype(np.float32)
        lo = table[i]
        hi = table[(i + 1) % T]
        return (lo + (hi - lo) * frac).astype(np.float32)
    if k == "pluck":
        # Karplus-Strong, spectral form (goldref.spec docstring): random
        # flat excitation with per-harmonic exponential decay whose rate
        # is the KS averaging-loop gain cos(pi*k*f/sr) per period.
        K = max(1, int(node.num_harmonics))
        inc = S.phase_increment(node.frequency, sr)
        ratio = np.float32(np.float32(inc) * np.float32(2.0 ** -32))
        active = [kk for kk in range(1, K + 1)
                  if inc != 0 and kk * inc < (1 << 31)]
        u = noise_values(np.asarray(active or [1], np.uint32), node.seed)
        denom = np.float32(max(np.abs(u.astype(np.float64)).sum(), 1e-30))
        nrel = np.maximum(n_abs, 0).astype(np.float32)
        acc = np.zeros(p.shape, np.float32)
        for j, kk in enumerate(active):
            a_k = np.float32(u[j] / denom)
            phi = noise_u32(np.asarray([K + kk], np.uint32), node.seed)[0]
            g = np.float32(np.cos(np.float32(math.pi) * np.float32(kk) * ratio))
            alpha = (_F32(node.damping) * ratio
                     * np.float32(np.log(np.maximum(g, np.float32(1e-30)))))
            pk = ((p.astype(np.uint64) * np.uint64(kk)) + np.uint64(phi)) & _MASK
            acc = acc + (a_k * np.exp(nrel * alpha)
                         * np.sin(_TWO_PI * _phase_x(pk.astype(np.uint32)))
                         .astype(np.float32))
        return acc.astype(np.float32)
    if k == "sawtooth_bl":
        x = _phase_x(p)
        dt = node.frequency / sr
        return ((_F32(2.0) * x - _F32(1.0)) - poly_blep(x, dt)).astype(np.float32)
    if k == "square_bl":
        x = _phase_x(p)
        dt = node.frequency / sr
        naive = np.where(p < np.uint32(1 << 31), _F32(1.0), _F32(-1.0))
        x2 = np.where(x < _F32(0.5), x + _F32(0.5), x - _F32(0.5))
        return (naive + poly_blep(x, dt) - poly_blep(x2, dt)).astype(np.float32)
    raise ValueError(f"unknown waveform {k}")


def render_oracle(node: S.Node, nsamples: int, samplerate: int) -> np.ndarray:
    """Evaluate a patch tree over samples [0, nsamples) -> f32 array.

    Dispatch is structural (type name + fields): goldref.spec trees and
    product spec trees evaluate identically, through goldref's own
    constants."""
    n = np.arange(nsamples, dtype=np.int64)
    kind = type(node).__name__

    if kind == "Const":
        return np.full(nsamples, np.float32(node.value))

    if kind == "Linear":
        v = _F32(node.start) + n.astype(np.float32) * _F32(node.increase)
        return np.clip(v, _F32(node.min_value), _F32(node.max_value)).astype(np.float32)

    if kind == "Osc":
        inc0 = S.phase_increment(node.frequency, samplerate)
        p0 = S.phase_offset(node.phase)
        if node.fm_lfo is None:
            p = ((np.uint64(p0) + n.astype(np.uint64) * np.uint64(inc0)) & _MASK).astype(np.uint32)
        else:
            fm = render_oracle(node.fm_lfo, nsamples, samplerate)
            base = np.float32(np.uint32(inc0))
            inc_f = base * (_F32(1.0) + fm.astype(np.float32))
            inc_f = np.clip(inc_f, _F32(-(2**31 - 256)), _F32(2**31 - 256))
            inc = inc_f.astype(np.int32)
            csum = np.cumsum(inc.astype(np.int64)) - inc.astype(np.int64)  # exclusive
            p = ((np.uint64(p0) + csum.astype(np.uint64)) & _MASK).astype(np.uint32)
        pwm_vals = None
        if node.kind == "pulse" and node.pwm_lfo is not None:
            pwm_vals = render_oracle(node.pwm_lfo, nsamples, samplerate)
        w = _wave_values(node, p, samplerate, n, pwm_vals)
        return (_F32(node.bias) + _F32(node.amplitude) * w).astype(np.float32)

    if kind == "Envelope":
        src = render_oracle(node.source, nsamples, samplerate)
        g = envelope_gains(n, samplerate, node)
        return (src * g).astype(np.float32)

    if kind == "Mix":
        acc = np.zeros(nsamples, np.float32)
        for s in node.sources:
            acc = acc + render_oracle(s, nsamples, samplerate)
        return acc

    if kind == "AmpMod":
        return (render_oracle(node.source, nsamples, samplerate)
                * render_oracle(node.modulator, nsamples, samplerate)).astype(np.float32)

    if kind == "Delay":
        d = int(round(node.seconds * samplerate))
        src = render_oracle(node.source, nsamples, samplerate)
        if d <= 0:
            return src
        out = np.zeros(nsamples, np.float32)
        out[d:] = src[:max(0, nsamples - d)]
        return out

    if kind == "Echo":
        src = render_oracle(node.source, nsamples, samplerate)
        out = src.copy()
        d_after = int(round(node.after * samplerate))
        d_delay = int(round(node.delay * samplerate))
        gain = 1.0
        for k in range(1, node.amount + 1):
            gain *= node.decay
            dk = d_after + k * d_delay
            if dk < nsamples:
                out[dk:] = out[dk:] + _F32(gain) * src[:nsamples - dk]
        return out.astype(np.float32)

    if kind == "Biquad":
        src = render_oracle(node.source, nsamples, samplerate)
        lfo = getattr(node, "cutoff_lfo", None)
        if lfo is None:
            coeffs = [S.biquad_coeffs(node.kind, node.cutoff, node.q,
                                      samplerate)] * 1
            def coeff_at(i):
                return coeffs[0]
        else:
            lv = render_oracle(lfo, nsamples, samplerate).astype(np.float64)
            fc = np.clip(node.cutoff * np.exp2(lv), 10.0, 0.49 * samplerate)
            def coeff_at(i):
                return S.biquad_coeffs(node.kind, float(fc[i]), node.q,
                                       samplerate)
        # the exact arbiter: SEQUENTIAL direct-form recurrence in f64
        x = src.astype(np.float64)
        y = np.zeros(nsamples, np.float64)
        x1 = x2 = y1 = y2 = 0.0
        for i in range(nsamples):
            b0, b1, b2, a1, a2 = coeff_at(i)
            yi = b0 * x[i] + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
            x2, x1 = x1, x[i]
            y2, y1 = y1, yi
            y[i] = yi
        return y.astype(np.float32)

    if kind == "Clip":
        src = render_oracle(node.source, nsamples, samplerate)
        return np.clip(src, _F32(node.minimum), _F32(node.maximum)).astype(np.float32)

    if kind == "Abs":
        return np.abs(render_oracle(node.source, nsamples, samplerate))

    if kind == "Null":
        return render_oracle(node.source, nsamples, samplerate)

    raise TypeError(f"unknown spec node {type(node)}")


def envelope_gains(n: np.ndarray, samplerate: int, e: S.Envelope) -> np.ndarray:
    """Piecewise-linear ADSR gain at absolute sample indices (f32)."""
    t = n.astype(np.float32) / _F32(samplerate)
    a = _F32(max(e.attack, 0.0))
    d = _F32(max(e.decay, 0.0))
    s = _F32(max(e.sustain, 0.0))
    r = _F32(max(e.release, 0.0))
    sl = _F32(e.sustain_level)
    t2, t3, t4 = a + d, a + d + s, a + d + s + r
    g = np.where(t < a, t / np.maximum(a, _F32(1e-30)),
        np.where(t < t2, _F32(1.0) + (sl - _F32(1.0)) * (t - a) / np.maximum(d, _F32(1e-30)),
        np.where(t < t3, sl,
        np.where(t < t4, sl * (t4 - t) / np.maximum(r, _F32(1e-30)),
                 _F32(0.0)))))
    return np.maximum(g, _F32(0.0)).astype(np.float32)


def to_int_samples(values: np.ndarray, samplewidth: int) -> np.ndarray:
    """f32 [-1, 1] -> int samples: clip(rint(f32(v * maxval))), nearest-even.

    The product stays in f32 (device formula, graph.to_int_device).
    """
    v = np.rint(values.astype(np.float32)
                * np.float32({1: 127.0, 2: 32767.0, 4: 2147483647.0}[samplewidth]))
    if samplewidth == 4:
        hi = np.float64(2147483648.0)
        v64 = v.astype(np.float64)
        return np.where(v64 >= hi, np.int32(2**31 - 1),
                        np.where(v64 < -hi, np.int32(-2**31),
                                 np.clip(v64, -hi, hi - 128).astype(np.int32))).astype(np.int32)
    minval = {1: -128, 2: -32768}[samplewidth]
    maxval = {1: 127, 2: 32767}[samplewidth]
    return np.clip(v.astype(np.float64), minval, maxval).astype(
        {1: np.int8, 2: np.int16}[samplewidth])
