"""Device effects rack: dynamics, reverb, chorus, convolution (JAX).

Beyond-reference effects (the reference's only effect is the feed-forward
echo — SURVEY.md §3.1 row 2); the behavioral contract and the tolerance
budget per effect live in :mod:`goldref.effects`.  Every recurrence here is
deliberately *not* a per-sample loop:

* the compressor's peak follower is a **decaying-max associative scan**
  (``e_n = max(a_n, e_{n-1} d)`` composes as
  ``(x1,d1)∘(x2,d2) = (max(x2, x1 d2), d1 d2)``) and its attack smoother is
  a scalar **affine associative scan** — both log-depth;
* the offline reverb is a **lag-aligned gather-free scan**: each comb's
  scan row is its own delay length D, so the lag-D ring read is exactly the
  previous row of that lane — all lanes of both channel networks batch into
  ONE scan with no gather/scatter; the only true per-sample recurrence
  (comb damping) is an affine scan inside the row.  The streaming twin
  keeps the carried-ring blocked form (block ≤ the shortest delay line);
* the chorus is pure gather + lerp (no recurrence);
* convolution runs as an f32 FFT product (``jnp.fft``).

All scalar scans are elementwise f32 — no matmuls, so the reduced-
precision matmul trap of the Biquad companion scan (bf16 or TF32 inputs,
see companion_scan) cannot apply.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import pcm as dpcm
from .trig import sin_turns

MAXVAL = dpcm.MAXVAL
MINVAL = dpcm.MINVAL


def _norm(frames: jax.Array) -> jax.Array:
    w = dpcm.width_of(frames)
    return frames.astype(jnp.float32) / jnp.float32(MAXVAL[w])


def to_int_samples(values: jax.Array, width: int) -> jax.Array:
    """House synthesis quantization clip(rint(f32(v*maxval))) — the same
    formula as models.graph.to_int_device (duplicated to keep ops/ free of
    a models/ dependency)."""
    dt = {1: jnp.int8, 2: jnp.int16, 4: jnp.int32}[width]
    v = jnp.rint(values * jnp.float32(MAXVAL[width]))
    if width == 4:
        hi = jnp.float32(2147483648.0)
        return jnp.where(v >= hi, jnp.int32(MAXVAL[4]),
                         jnp.where(v < -hi, jnp.int32(MINVAL[4]),
                                   jnp.clip(v, -hi, hi - 128).astype(jnp.int32)))
    return jnp.clip(v, MINVAL[width], MAXVAL[width]).astype(dt)


# ---------------------------------------------------------------------------
# Parallel-scan primitives
# ---------------------------------------------------------------------------

def decaying_max_scan(a: jax.Array, decay: float, init: float = 0.0) -> jax.Array:
    """e_n = max(a_n, e_{n-1} * decay) with e_{-1} = init, as an associative
    scan: element (x, d) is the map e ↦ max(x, e*d)."""
    d = jnp.broadcast_to(jnp.asarray(decay, jnp.float32), a.shape)

    def combine(l, r):
        xl, dl = l
        xr, dr = r
        return jnp.maximum(xr, xl * dr), dl * dr

    xs, ds = jax.lax.associative_scan(combine, (a, d))
    return jnp.maximum(xs, ds * jnp.asarray(init, jnp.float32))


def affine_scan(coeff: jax.Array, add: jax.Array, init, axis: int = 0) -> jax.Array:
    """y_n = coeff_n * y_{n-1} + add_n with y_{-1} = init — affine
    recurrence as an associative scan along ``axis`` (map composition
    l-then-r: (Al,Bl)∘(Ar,Br) = (Al*Ar, Bl*Ar + Br)); other axes are
    independent lanes.  ``init`` must broadcast against the result.
    Elementwise f32 — no matmul."""
    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, bl * ar + br

    acum, bcum = jax.lax.associative_scan(combine, (coeff, add), axis=axis)
    return acum * jnp.asarray(init, jnp.float32) + bcum


def one_pole_scan(target: jax.Array, alpha: float, init: float) -> jax.Array:
    """y_n = y_{n-1} + alpha*(t_n - y_{n-1})."""
    al = jnp.asarray(alpha, jnp.float32)
    a = jnp.broadcast_to(jnp.float32(1.0) - al, target.shape)
    return affine_scan(a, al * target, init)


def companion_scan(u: jax.Array, a1, a2, y1, y2) -> jax.Array:
    """y_n = u_n - a1_n y_{n-1} - a2_n y_{n-2} as a PARALLEL affine scan
    over 2x2 companion matrices (log-depth IIR).
    ``a1``/``a2`` may be scalars (constant-coefficient biquads) or [B]
    arrays (swept filters); ``y1``/``y2`` carry state across blocks.

    precision=HIGHEST everywhere: at default precision a GPU may multiply
    f32 matrices in TF32 (~2^-11 relative), which quantizes the
    cumulative 2x2 products and destroys the recurrence (the bug class
    the on-card battery's filter checks exist for).  Shared by the graph
    Biquad lowering and the Sample-level filter op.

    Numeric conditioning (root cause of the high-Q drift, derived in
    tests/test_filters.scan_error_bound_lsb): the scan's error vs the
    sequential f32 recurrence is governed by the DENOMINATOR only —
    Gpole = max|1/A| amplifies each f32 regrouping rounding into the
    state, and the pole time constant tau = 1/(1-r) sets how many such
    roundings accumulate (as a ~sqrt(tau) random walk through the
    log-depth tree):  err <= 2 + 2*eps*maxval*log2(n)*Gpole*sqrt(tau).
    High-Q low-cutoff filters (r -> 1) therefore drift several LSB; a
    bound-model test fails if the scan ever degrades past this (e.g. a
    precision regression)."""
    ones = jnp.ones_like(u)
    zeros = jnp.zeros_like(u)
    row0 = jnp.stack([-a1 * ones, -a2 * ones], axis=-1)       # [B, 2]
    row1 = jnp.stack([ones, zeros], axis=-1)
    Ms = jnp.stack([row0, row1], axis=-2)                     # [B, 2, 2]
    cs = jnp.stack([u, zeros], axis=-1)                       # [B, 2]
    hi = jax.lax.Precision.HIGHEST

    def combine(l, r):
        Ml, cl = l
        Mr, cr = r
        return (jnp.matmul(Mr, Ml, precision=hi),
                jnp.einsum("...ij,...j->...i", Mr, cl, precision=hi) + cr)

    Mcum, ccum = jax.lax.associative_scan(combine, (Ms, cs))
    s0 = jnp.stack([jnp.asarray(y1, jnp.float32),
                    jnp.asarray(y2, jnp.float32)])            # [2]
    ys = jnp.einsum("nij,j->ni", Mcum, s0, precision=hi) + ccum
    return ys[:, 0]


# ---------------------------------------------------------------------------
# Compensated (float-float) companion scan
#
# Near-unit-pole filters (low shelves at bass frequencies, high-Q low
# cutoffs) defeat plain f32 twice over: (a) the scan conditioning above
# (Gpole * sqrt(tau) amplification of every f32 regrouping), and (b) the
# f32 COEFFICIENT quantization itself — a low shelf at 120 Hz has
# |A(1)| ~ w0^2 ~ 3e-4, so the ~1e-7 relative rounding of a1/a2 shifts
# the DC gain by ~1e-3 relative (~tens of LSB at full scale) before any
# arithmetic happens.  The fix is therefore float-float end to end:
# coefficients arrive as non-overlapping (hi, lo) f32 pairs split from
# f64 on host, and the feed-forward taps, companion-matrix products, and
# affine terms all run in Dekker/Knuth error-free-transformation
# arithmetic (~2^-45 effective precision) — f64 in disguise, inside
# JAX's default 32-bit types.  ~8x the flops of the plain scan; used
# only where ops.coeffs.predicted_scan_error_lsb says the plain scan
# would drift (the staged filter/eq ops and the streaming twins decide
# per coefficient set on host).
#
# EFT safety under FMA contraction: TwoSum is contraction-proof (no
# multiply); Dekker's product error term survives because ah*bh is EXACT
# in f32 (12-bit x 12-bit splits), so fma(ah, bh, -p) == round(ah*bh - p)
# == the uncontracted value.  A contracted Veltkamp split (t - a with
# t = a*c) is the remaining risk; the battery's fx/ff_scan_eft_on_hw
# checks the whole scan on the card (0 LSB from the f64 oracle on an H100).
# ---------------------------------------------------------------------------

def _ff_norm(hi, lo):
    """Renormalize a (hi, lo) pair (Knuth fast-two-sum, |lo| <= |hi|)."""
    s = hi + lo
    return s, lo - (s - hi)


def _prod_err(a, b, p):
    """Dekker: the exact f32 rounding error of p = fl(a * b)."""
    c = jnp.float32(4097.0)             # 2^12 + 1 splits f32's 24 bits
    t = a * c
    ah = t - (t - a)
    al = a - ah
    t = b * c
    bh = t - (t - b)
    bl = b - bh
    return ((ah * bh - p) + ah * bl + al * bh) + al * bl


def ff_add(ah, al, bh, bl):
    """(ah, al) + (bh, bl) in float-float (Knuth TwoSum + tail fold)."""
    s = ah + bh
    bb = s - ah
    err = (ah - (s - bb)) + (bh - bb)
    return _ff_norm(s, err + (al + bl))


def ff_mul(ah, al, bh, bl):
    """(ah, al) * (bh, bl) in float-float (Dekker TwoProd + cross terms)."""
    p = ah * bh
    e = _prod_err(ah, bh, p) + (ah * bl + al * bh)
    return _ff_norm(p, e)


def _ff_mat2mul(Ah, Al, Bh, Bl):
    """2x2 float-float matrix product A @ B, batched over leading dims
    ([..., 2, 2] hi/lo arrays)."""
    ch = [[None, None], [None, None]]
    cl = [[None, None], [None, None]]
    for i in range(2):
        for j in range(2):
            t0 = ff_mul(Ah[..., i, 0], Al[..., i, 0],
                        Bh[..., 0, j], Bl[..., 0, j])
            t1 = ff_mul(Ah[..., i, 1], Al[..., i, 1],
                        Bh[..., 1, j], Bl[..., 1, j])
            ch[i][j], cl[i][j] = ff_add(*t0, *t1)
    Ch = jnp.stack([jnp.stack(ch[0], axis=-1),
                    jnp.stack(ch[1], axis=-1)], axis=-2)
    Cl = jnp.stack([jnp.stack(cl[0], axis=-1),
                    jnp.stack(cl[1], axis=-1)], axis=-2)
    return Ch, Cl


def _ff_mat2vec(Ah, Al, vh, vl):
    """2x2 float-float matrix times float-float 2-vector ([..., 2])."""
    out_h, out_l = [], []
    for i in range(2):
        t0 = ff_mul(Ah[..., i, 0], Al[..., i, 0], vh[..., 0], vl[..., 0])
        t1 = ff_mul(Ah[..., i, 1], Al[..., i, 1], vh[..., 1], vl[..., 1])
        h, l = ff_add(*t0, *t1)
        out_h.append(h)
        out_l.append(l)
    return jnp.stack(out_h, axis=-1), jnp.stack(out_l, axis=-1)


def companion_scan_ff(uh, ul, a1h, a1l, a2h, a2l, y1h, y1l, y2h, y2l):
    """Float-float twin of :func:`companion_scan`: solves y_n = u_n -
    a1 y_{n-1} - a2 y_{n-2} with every quantity a (hi, lo) pair.  The
    a1/a2 pairs may be scalars or [B] grids (swept coefficients); the u
    pair carries the feed-forward taps' own compensation; y1/y2 pairs
    carry state across chunks without re-rounding it to f32.  Returns
    (y_hi, y_lo) — y_hi is fl(y_hi + y_lo), the correctly rounded f32
    output."""
    zeros = jnp.zeros_like(uh)
    ones = jnp.ones_like(uh)

    def bc(c):
        return jnp.asarray(c, jnp.float32) * ones

    row0h = jnp.stack([-bc(a1h), -bc(a2h)], axis=-1)
    row0l = jnp.stack([-bc(a1l), -bc(a2l)], axis=-1)
    row1h = jnp.stack([ones, zeros], axis=-1)
    row1l = jnp.stack([zeros, zeros], axis=-1)
    Msh = jnp.stack([row0h, row1h], axis=-2)               # [B, 2, 2]
    Msl = jnp.stack([row0l, row1l], axis=-2)
    csh = jnp.stack([uh, zeros], axis=-1)                  # [B, 2]
    csl = jnp.stack([ul, zeros], axis=-1)

    def combine(l, r):
        Mlh, Mll, clh, cll = l
        Mrh, Mrl, crh, crl = r
        Ch, Cl = _ff_mat2mul(Mrh, Mrl, Mlh, Mll)
        dh, dl = _ff_mat2vec(Mrh, Mrl, clh, cll)
        eh, el = ff_add(dh, dl, crh, crl)
        return Ch, Cl, eh, el

    Mh, Ml, ch, cl = jax.lax.associative_scan(
        combine, (Msh, Msl, csh, csl))
    s0h = jnp.stack([jnp.asarray(y1h, jnp.float32),
                     jnp.asarray(y2h, jnp.float32)])
    s0l = jnp.stack([jnp.asarray(y1l, jnp.float32),
                     jnp.asarray(y2l, jnp.float32)])
    vh, vl = _ff_mat2vec(Mh, Ml, s0h[None, :], s0l[None, :])
    yh, yl = ff_add(vh, vl, ch, cl)
    return yh[:, 0], yl[:, 0]


def biquad_apply_ff(s: jax.Array, coeff_pairs, state=None):
    """Compensated twin of :func:`biquad_apply`.  ``coeff_pairs`` is
    ((b0h, b0l), ..., (a2h, a2l)) — five (hi, lo) pairs split from f64
    coefficients on host (``ops.coeffs.ff_split``), scalars or [n]
    grids.  ``state`` is (x1, x2, y1h, y1l, y2h, y2l), each [ch]: the x
    history is exact f32, the y history carries its compensation so
    chunk boundaries do not re-round the state.  Returns (y, state) with
    y the correctly rounded f32 signal."""
    n, nch = s.shape
    (b0h, b0l), (b1h, b1l), (b2h, b2l), (a1h, a1l), (a2h, a2l) = \
        tuple((jnp.asarray(h, jnp.float32), jnp.asarray(l, jnp.float32))
              for h, l in coeff_pairs)
    if state is None:
        z = jnp.zeros(nch, jnp.float32)
        state = (z, z, z, z, z, z)
    x1, x2, y1h, y1l, y2h, y2l = state

    def tap(bh, bl, x):
        # ff coefficient times EXACT f32 signal value
        p = bh * x
        e = _prod_err(bh, x, p) + bl * x
        return _ff_norm(p, e)

    cols_h, ny1h, ny1l, ny2h, ny2l = [], [], [], [], []
    for ch_i in range(nch):
        x = s[:, ch_i]
        xp1 = jnp.concatenate([x1[ch_i][None], x[:-1]])
        xp2 = jnp.concatenate([x2[ch_i][None], x1[ch_i][None], x[:-2]])
        uh, ul = ff_add(*ff_add(*tap(b0h, b0l, x), *tap(b1h, b1l, xp1)),
                        *tap(b2h, b2l, xp2))
        yh, yl = companion_scan_ff(uh, ul, a1h, a1l, a2h, a2l,
                                   y1h[ch_i], y1l[ch_i],
                                   y2h[ch_i], y2l[ch_i])
        cols_h.append(yh)
        ny1h.append(yh[-1])
        ny1l.append(yl[-1])
        ny2h.append(yh[-2] if n >= 2 else y1h[ch_i])
        ny2l.append(yl[-2] if n >= 2 else y1l[ch_i])
    out = jnp.stack(cols_h, axis=1)
    new_state = (s[-1], s[-2] if n >= 2 else x1,
                 jnp.stack(ny1h), jnp.stack(ny1l),
                 jnp.stack(ny2h), jnp.stack(ny2l))
    return out, new_state


def biquad_apply(s: jax.Array, coeffs, state=None):
    """Constant-coefficient biquad on a normalized f32 signal [n, ch]:
    y_n = b0 x_n + b1 x_{n-1} + b2 x_{n-2} - a1 y_{n-1} - a2 y_{n-2},
    channels independent.  ``state`` carries (x1, x2, y1, y2) each [ch]
    across chunks (zeros at start).  Returns (y, new_state).  Spec:
    goldref.effects.biquad_filter."""
    n, nch = s.shape
    b0, b1, b2, a1, a2 = (jnp.asarray(c, jnp.float32) for c in coeffs)
    if state is None:
        z = jnp.zeros(nch, jnp.float32)
        state = (z, z, z, z)
    x1, x2, y1, y2 = state
    cols = []
    ny1, ny2 = [], []
    for ch in range(nch):
        x = s[:, ch]
        xp1 = jnp.concatenate([x1[ch][None], x[:-1]])
        xp2 = jnp.concatenate([x2[ch][None], x1[ch][None], x[:-2]])
        u = b0 * x + b1 * xp1 + b2 * xp2
        y = companion_scan(u, a1, a2, y1[ch], y2[ch])
        cols.append(y)
        ny1.append(y[-1])
        ny2.append(y[-2] if n >= 2 else y1[ch])
    out = jnp.stack(cols, axis=1)
    new_state = (s[-1], s[-2] if n >= 2 else x1,
                 jnp.stack(ny1), jnp.stack(ny2))
    return out, new_state


def gate_gains_from_coeffs(frames: jax.Array, threshold_db, floor_gain,
                           alpha, decay, e0, z0,
                           with_state: bool = False):
    """Noise-gate gain curve; spec: goldref.effects.gate_gains.  The same
    scan machinery as the compressor: decaying-max peak detector, a hard
    open(1.0)/closed(floor_gain) target from the threshold comparison, and
    a one-pole smoother z_n = (1-a) z_{n-1} + a g_n.  ``e0``/``z0`` carry
    the detector and smoother across chunks (the spec starts a stream
    CLOSED: z_{-1} = floor_gain)."""
    a = jnp.max(jnp.abs(_norm(frames)), axis=1)
    e = decaying_max_scan(a, decay, init=e0)
    level_db = jnp.float32(20.0) * jnp.log10(jnp.maximum(e, jnp.float32(1e-10)))
    g = jnp.where(level_db >= jnp.asarray(threshold_db, jnp.float32),
                  jnp.float32(1.0), jnp.asarray(floor_gain, jnp.float32))
    al = jnp.asarray(alpha, jnp.float32)
    coeff = jnp.broadcast_to(jnp.float32(1.0) - al, g.shape)
    z = affine_scan(coeff, al * g, init=z0)
    if with_state:
        return z, e[-1], z[-1]
    return z


# ---------------------------------------------------------------------------
# Compressor
# ---------------------------------------------------------------------------

def compressor_gains(frames: jax.Array, samplerate: int, threshold_db: float,
                     ratio: float, attack: float, release: float) -> jax.Array:
    """Per-sample linear gain curve of the peak compressor; formulas and
    sequential-vs-parallel rounding budget: goldref.effects.compressor_gains.
    Both recurrences (decaying-max detector, one-pole attack smoother) run
    as log-depth associative scans."""
    from .coeffs import compressor_coeffs
    alpha, decay = compressor_coeffs(samplerate, attack, release)
    slope = 1.0 if math.isinf(ratio) else 1.0 - 1.0 / ratio
    return compressor_gains_from_coeffs(frames, threshold_db, slope, alpha,
                                        decay)


def compressor_gains_from_level(a: jax.Array, threshold_db, slope, alpha,
                                decay, e0=0.0, z0=0.0,
                                with_state: bool = False, knee=None):
    """Gain curve from a precomputed detector level ``a`` [n] (normalized
    |signal|) — the sidechain entry point; formulas as below.  ``knee``
    (dB width, scalar or [n] grid) switches the static curve to the
    soft-knee form — None keeps the hard-knee arithmetic untouched."""
    e = decaying_max_scan(a, decay, init=e0)
    level_db = jnp.float32(20.0) * jnp.log10(jnp.maximum(e, jnp.float32(1e-10)))
    g_db = _static_curve_db(level_db, threshold_db, slope, knee)
    g = jnp.exp2(g_db * jnp.float32(1.0 / 6.0206))
    # attack smoother in deviation-from-1 form: z = 1-y, z_n = (1-a) z_{n-1}
    # + a (1-g_n), z_{-1} = 0 — algebraically the oracle's recurrence, but
    # the parallel scan keeps the g == 1 fixpoint EXACT (under-threshold
    # audio is bit-transparent instead of losing 1 LSB to a 0.99999994 gain)
    al = jnp.asarray(alpha, jnp.float32)
    coeff = jnp.broadcast_to(jnp.float32(1.0) - al, g.shape)
    z = affine_scan(coeff, al * (jnp.float32(1.0) - g), init=z0)
    gains = jnp.float32(1.0) - z
    if with_state:
        return gains, e[-1], z[-1]
    return gains


def _static_curve_db(level_db: jax.Array, threshold_db, slope, knee):
    """The compressor's static curve in dB.  Hard knee (knee=None):
    g_db = min(0, (thr - level)*slope) — unchanged arithmetic.  Soft
    knee (width W dB, spec goldref.effects.compressor_gains): below
    thr - W/2 no reduction, above thr + W/2 the hard line, inside the
    quadratic interpolation -slope*(level - thr + W/2)^2 / (2W) (the
    textbook second-order knee: value and first derivative continuous
    at both edges)."""
    thr = jnp.asarray(threshold_db, jnp.float32)
    sl = jnp.asarray(slope, jnp.float32)
    hard = jnp.minimum(jnp.float32(0.0), (thr - level_db) * sl)
    if knee is None:
        return hard
    kn = jnp.asarray(knee, jnp.float32)
    half = kn * jnp.float32(0.5)
    t = level_db - thr + half
    soft = -(sl * (t * t)) / (jnp.float32(2.0) * kn)
    return jnp.where(t <= jnp.float32(0.0), jnp.float32(0.0),
                     jnp.where(level_db > thr + half, hard, soft))


def compressor_gains_from_coeffs(frames: jax.Array, threshold_db, slope,
                                 alpha, decay, e0=0.0, z0=0.0,
                                 with_state: bool = False, knee=None):
    """Same as :func:`compressor_gains` with the host-derived coefficients
    passed explicitly (scalars may be tracers — the staged-IR path feeds
    them from the Sample's dyn vector so knob changes don't recompile).

    ``e0``/``z0`` carry the detector envelope and smoother deviation across
    chunks (the streaming processor's state); with_state also returns the
    final (e, z) pair — there is exactly ONE implementation of these
    recurrences, shared by the whole-signal op and the streaming twin."""
    a = jnp.max(jnp.abs(_norm(frames)), axis=1)
    e = decaying_max_scan(a, decay, init=e0)
    level_db = jnp.float32(20.0) * jnp.log10(jnp.maximum(e, jnp.float32(1e-10)))
    g_db = _static_curve_db(level_db, threshold_db, slope, knee)
    g = jnp.exp2(g_db * jnp.float32(1.0 / 6.0206))
    # attack smoother in deviation-from-1 form: z = 1-y, z_n = (1-a) z_{n-1}
    # + a (1-g_n), z_{-1} = 0 — algebraically the oracle's recurrence, but
    # the parallel scan keeps the g == 1 fixpoint EXACT (under-threshold
    # audio is bit-transparent instead of losing 1 LSB to a 0.99999994 gain)
    al = jnp.asarray(alpha, jnp.float32)
    coeff = jnp.broadcast_to(jnp.float32(1.0) - al, g.shape)
    z = affine_scan(coeff, al * (jnp.float32(1.0) - g), init=z0)
    gains = jnp.float32(1.0) - z
    if with_state:
        return gains, e[-1], z[-1]
    return gains


# ---------------------------------------------------------------------------
# Freeverb-style reverb (blocked scan)
# ---------------------------------------------------------------------------

# Whole-signal lag-aligned comb packing cap: beyond this many bytes of
# packed [M, L, Dmax] input+output the offline path routes through the
# chunked streaming twin instead (tests shrink this to force the fallback).
COMB_PACK_BYTES_CAP = 1_500_000_000

def reverb_zero_state(combs: Tuple[int, ...], aps: Tuple[int, ...]):
    """Fresh (comb ring buffers, damping states, allpass ring buffers,
    write position) carry for one channel's network."""
    return (jnp.zeros((len(combs), max(combs)), jnp.float32),
            jnp.zeros(len(combs), jnp.float32),
            jnp.zeros((len(aps), max(aps)), jnp.float32),
            jnp.int32(0))


def _network_step(combs: Tuple[int, ...], aps: Tuple[int, ...], block: int,
                  fb, d1, d2, fb_swept: bool = False):
    """One blocked step of the Freeverb network: reads/writes ``block``
    frames of every ring buffer.  Requires block <= min delay, so all
    delayed reads land at least ``block`` frames behind the write head and
    the whole block evaluates in parallel; the comb damping one-pole is the
    only within-block recurrence and runs as an affine associative scan.
    With ``fb_swept`` the scan input is (xblk, fbblk) and each frame's
    comb write uses ITS feedback value (fx.reverb.roomsize automation —
    elementwise in the write, the recurrence structure is unchanged).
    Formulas: goldref.effects._reverb_network."""
    apg = jnp.float32(0.5)
    arange_b = jnp.arange(block, dtype=jnp.int32)

    def step(carry, xs):
        if fb_swept:
            xblk, fbv = xs
        else:
            xblk, fbv = xs, fb
        comb_buf, fstores, ap_buf, n0 = carry
        offs = n0 + arange_b
        acc = jnp.zeros(block, jnp.float32)
        new_rows, new_fs = [], []
        for k, D in enumerate(combs):
            idx = offs % jnp.int32(D)
            y = comb_buf[k, idx]
            fs = affine_scan(jnp.broadcast_to(d1, (block,)), d2 * y,
                             fstores[k])
            new_rows.append(comb_buf[k].at[idx].set(xblk + fs * fbv))
            new_fs.append(fs[-1])
            acc = acc + y
        comb_buf = jnp.stack(new_rows)
        fstores = jnp.stack(new_fs)
        out = acc
        ap_rows = []
        for k, D in enumerate(aps):
            idx = offs % jnp.int32(D)
            b = ap_buf[k, idx]
            ap_rows.append(ap_buf[k].at[idx].set(out + b * apg))
            out = b - out
        ap_buf = jnp.stack(ap_rows)
        return (comb_buf, fstores, ap_buf, n0 + jnp.int32(block)), out

    return step


def reverb_network_apply(state, mono_in: jax.Array, combs: Tuple[int, ...],
                         aps: Tuple[int, ...], feedback, damp):
    """Run ``mono_in`` (any length) through one channel's network from
    ``state``, returning (new_state, output).  Whole blocks go through one
    ``lax.scan``; the remainder (< block) is a single differently-shaped
    step — the write position advances by exactly len(mono_in), so chunked
    invocation is the same recurrence as whole-signal (f32 scan regrouping
    differs; goldref.effects.reverb documents the budget).  ``feedback``
    may be a per-frame [n] grid (roomsize automation)."""
    n = int(mono_in.shape[0])
    block = min(128, min(min(combs), min(aps)))
    fb = jnp.asarray(feedback, jnp.float32)
    fb_swept = fb.ndim == 1
    d1 = jnp.asarray(damp, jnp.float32)
    d2 = jnp.float32(1.0) - d1
    nb, rem = divmod(n, block)
    outs = []
    if nb:
        step = _network_step(combs, aps, block, fb, d1, d2, fb_swept)
        head = mono_in[:nb * block].reshape(nb, block)
        xs = (head, fb[:nb * block].reshape(nb, block)) if fb_swept else head
        state, out_full = jax.lax.scan(step, state, xs)
        outs.append(out_full.reshape(-1))
    if rem:
        step_r = _network_step(combs, aps, rem, fb, d1, d2, fb_swept)
        tail_x = mono_in[nb * block:]
        xs_r = (tail_x, fb[nb * block:]) if fb_swept else tail_x
        state, out_r = step_r(state, xs_r)
        outs.append(out_r)
    if not outs:
        return state, jnp.zeros((0,), jnp.float32)
    return state, outs[0] if len(outs) == 1 else jnp.concatenate(outs)


def _comb_stage_whole(mono_in: jax.Array, comb_sets, fb, d1,
                      d2) -> jax.Array:
    """Whole-signal parallel comb banks with NO gather and NO scatter
    (round 4): each comb's block size is its OWN delay D, so the lag-D
    ring-buffer read is exactly the previous scan row of that lane — the
    write head never has to be indexed.  Every lane (the 8 combs of EVERY
    channel network in ``comb_sets``) pads its [ceil(n/D), D] row view of
    the input to a common [M, Dmax] with identity-affine padding columns
    (a=1, b=0 keeps the damping state flowing past the pad), so ONE
    lax.scan of M = ceil(n/Dmin) steps serves all lanes with one in-row
    affine scan per step.  This replaced a gather/scatter blocked scan;
    same goldref recurrence, f32 scan regrouping
    within the documented <=4 LSB budget (goldref.effects.reverb).
    Returns [n, len(comb_sets)] (each network's comb sum)."""
    total = int(mono_in.shape[0])
    all_ds = tuple(D for cs in comb_sets for D in cs)
    dmax = max(all_ds)
    M = -(-total // min(all_ds))
    xl = []
    for D in all_ds:
        mk = -(-total // D)
        rows = jnp.concatenate(
            [mono_in, jnp.zeros(mk * D - total, jnp.float32)]).reshape(mk, D)
        xl.append(jnp.pad(rows, ((0, M - mk), (0, dmax - D))))
    xl = jnp.stack(xl, axis=1)                              # [M, L, Dmax]
    nlanes = len(all_ds)
    mask = (jnp.arange(dmax, dtype=jnp.int32)[None, :]
            < jnp.asarray(all_ds, jnp.int32)[:, None])      # [L, Dmax]
    coeff = jnp.where(mask, jnp.asarray(d1, jnp.float32), jnp.float32(1.0))
    fbv = jnp.asarray(fb, jnp.float32)

    def step(carry, xrow):
        brow, fstores = carry                               # [L, Dmax], [L]
        y = brow
        fs = affine_scan(coeff, jnp.where(mask, d2 * y, jnp.float32(0.0)),
                         fstores[:, None], axis=1)
        return (xrow + fs * fbv, fs[:, -1]), y

    carry0 = (jnp.zeros((nlanes, dmax), jnp.float32),
              jnp.zeros(nlanes, jnp.float32))
    _, ys = jax.lax.scan(step, carry0, xl)                  # [M, L, Dmax]
    outs, lane = [], 0
    for cs in comb_sets:
        acc = jnp.zeros(total, jnp.float32)
        for D in cs:
            mk = -(-total // D)
            acc = acc + ys[:mk, lane, :D].reshape(-1)[:total]
            lane += 1
        outs.append(acc)
    return jnp.stack(outs, axis=1)


def _allpass_whole(x: jax.Array, D: int, g=jnp.float32(0.5)) -> jax.Array:
    """Whole-signal Freeverb allpass with NO sequential scan: the buffer
    recurrence b_n = x_{n-D} + g*b_{n-D} couples only indices D apart, so
    it splits into D independent lag-1 lanes — reshape to [M, D] and run
    one parallel affine scan along the block axis.  y_n = b_n - x_n."""
    n = x.shape[0]
    M = -(-n // D) + 1
    xd = jnp.concatenate(
        [jnp.zeros(D, jnp.float32), x,
         jnp.zeros(M * D - n - D, jnp.float32)]).reshape(M, D)
    b = affine_scan(jnp.full((M, D), g, jnp.float32), xd,
                    jnp.float32(0.0), axis=0)
    return b.reshape(-1)[:n] - x


def _reverb_networks_whole(mono_in: jax.Array, nets, feedback,
                           damp) -> list:
    """Whole-signal networks from zero state (the offline Sample op):
    one comb-limited blocked scan batched over every channel's lanes +
    lane-decomposed allpasses (the streaming twin reverb_network_apply
    keeps the combined small-block form; both evaluate
    goldref.effects._reverb_network's recurrences, f32 regrouping within
    the documented budget)."""
    fb = jnp.asarray(feedback, jnp.float32)
    d1 = jnp.asarray(damp, jnp.float32)
    d2 = jnp.float32(1.0) - d1
    total = int(mono_in.shape[0])
    all_ds = tuple(D for combs, _ in nets for D in combs)
    # the lag-aligned comb stage materializes [M, L, Dmax] packed input +
    # output (~2 * ceil(n/Dmin) * L * Dmax f32); past the byte cap fall
    # back to the chunked streaming twin (identical recurrences, carried
    # state — same goldref budget class)
    packed = 2 * (-(-total // min(all_ds))) * len(all_ds) * max(all_ds) * 4
    if packed > COMB_PACK_BYTES_CAP:
        outs = []
        for combs, aps in nets:
            _, out = reverb_network_apply(
                reverb_zero_state(combs, aps), mono_in, combs, aps, fb, d1)
            outs.append(out)
        return outs
    # ONE batched comb scan over every network's lanes (no gathers, so
    # extra lanes are nearly free — unlike the round-3 gather/scatter form
    # where per-lane row cost made batching networks a measured loss)
    comb_sums = _comb_stage_whole(mono_in, [c for c, _ in nets], fb, d1, d2)
    outs = []
    for i, (_, aps) in enumerate(nets):
        out = comb_sums[:, i]
        for D in aps:
            out = _allpass_whole(out, D)
        outs.append(out)
    return outs


def _reverb_network_device(mono_in: jax.Array, combs: Tuple[int, ...],
                           aps: Tuple[int, ...], feedback: float,
                           damp: float) -> jax.Array:
    """Single whole-signal network (mono samples)."""
    return _reverb_networks_whole(mono_in, [(combs, aps)], feedback, damp)[0]


def reverb(frames: jax.Array, samplerate: int, roomsize: float,
           damping: float, wet: float, dry: float, stereo_width: float,
           tail_frames: int) -> jax.Array:
    """Freeverb-style reverb on an int [n, ch] array; spec and tolerance:
    goldref.effects.reverb."""
    from . import coeffs as gfx
    feedback, damp, wet1, wet2 = gfx.reverb_params(roomsize, damping, wet,
                                                   stereo_width)
    return reverb_from_params(frames, samplerate, feedback, damp, wet1, wet2,
                              dry, tail_frames)


def reverb_from_params(frames: jax.Array, samplerate: int, feedback, damp,
                       wet1, wet2, dry, tail_frames: int) -> jax.Array:
    """Reverb with the derived (feedback, damp, wet1, wet2, dry) parameters,
    which may be tracers (the staged-IR path passes them via the Sample's
    dyn vector so knob changes don't recompile the blocked scan)."""
    from . import coeffs as gfx
    width = dpcm.width_of(frames)
    n, nch = frames.shape
    total = n + int(tail_frames)
    s = jnp.concatenate(
        [_norm(frames), jnp.zeros((total - n, nch), jnp.float32)], axis=0)
    mono_in = jnp.sum(s, axis=1) * jnp.float32(gfx.FIXED_GAIN)
    dry = jnp.asarray(dry, jnp.float32)
    wet1 = jnp.asarray(wet1, jnp.float32)
    wet2 = jnp.asarray(wet2, jnp.float32)
    if nch == 1:
        combs, aps = gfx.reverb_delays(samplerate, 0)
        rev = _reverb_network_device(mono_in, combs, aps, feedback, damp)
        out = dry * s[:, 0] + (wet1 + wet2) * rev
        return to_int_samples(out[:, None], width)
    revs = _reverb_networks_whole(
        mono_in, [gfx.reverb_delays(samplerate, ch) for ch in range(2)],
        feedback, damp)
    out = jnp.stack([
        dry * s[:, 0] + wet1 * revs[0] + wet2 * revs[1],
        dry * s[:, 1] + wet1 * revs[1] + wet2 * revs[0],
    ], axis=1)
    return to_int_samples(out, width)


# ---------------------------------------------------------------------------
# Chorus
# ---------------------------------------------------------------------------

def _chorus_lfo_delay(n0, n: int, samplerate: int, rate: float, depth,
                      delay, voice: int, voices: int,
                      channel: int, P=None) -> jax.Array:
    """The spec's integer-DDS delay curve (goldref.effects.chorus_delay_f32)
    in-trace: wrapped i32 phase (wrap == mod 2^32 in two's complement; the
    f32 reinterpretation x = p*2^-32 lands in [-0.5, 0.5), which the
    turn-unit sine folds identically to [0, 1)).

    ``rate`` is STATIC: the DDS increment must be the host's exact f64
    round (a traced f32 rint would mis-round by up to ~inc*2^-24 and drift
    the phase visibly over minutes of audio).  With ``P`` (a traced i32
    [n] cumulative-phase grid — fx.chorus.rate automation, derived on
    host by ops.coeffs.chorus_phase_grid) the phase is phase0 + P_n
    instead, and ``rate``/``n0`` are unused; ``depth`` may be a traced
    per-frame grid (fx.chorus.depth automation)."""
    phi = (voice / voices + 0.25 * channel) % 1.0
    p0 = int(round(phi * 4294967296.0)) & 0xFFFFFFFF
    phase0 = jnp.int32(p0 - (1 << 32) if p0 >= (1 << 31) else p0)
    if P is not None:
        p = phase0 + P                          # wrapping i32 == mod 2^32
    else:
        i = int(round(float(rate) / samplerate * 4294967296.0)) & 0xFFFFFFFF
        inc = jnp.int32(i - (1 << 32) if i >= (1 << 31) else i)
        idx = n0 + jnp.arange(n, dtype=jnp.int32)
        p = phase0 + idx * inc                  # wrapping i32 == mod 2^32
    x = p.astype(jnp.float32) * jnp.float32(2.0 ** -32)
    lfo = jnp.float32(0.5) + jnp.float32(0.5) * sin_turns(x)
    return (jnp.asarray(delay, jnp.float32)
            + jnp.asarray(depth, jnp.float32) * lfo) \
        * jnp.float32(samplerate)


def chorus_core(s: jax.Array, n0, hist: jax.Array, samplerate: int, rate,
                depth, delay, voices: int, wet, dry, P=None) -> jax.Array:
    """Chorus on a normalized f32 chunk [n, ch] starting at absolute frame
    ``n0``, reading past input from ``hist`` [H, ch] (the H frames before
    n0; zeros at stream start).  Pure gathers + lerp — no recurrence.
    ``P``/per-frame ``depth`` thread through to the LFO (rate/depth
    automation); ``wet``/``dry`` may be per-frame arrays.

    Round 4 measured (and rejected) a grouped-row alternative to the
    per-frame gather — G consecutive frames sharing one W-wide row with
    one-hot in-row extraction, the trick used for the host-known
    stretch windows: vmap(dynamic_slice) rows and a device-built
    shifted-copies row gather were both tried, and the data-dependent
    per-frame pair gather below is the form kept."""
    n, nch = s.shape
    H = hist.shape[0]
    ext = jnp.concatenate([hist, s], axis=0)    # position j maps to ext[H+j]
    # pair-packing (the pitched-sampler trick): the lerp needs
    # (ext[i0-1], ext[i0]) — gather ONE row of a pair-packed array
    # instead of two rows, halving the gathered index rows; values are
    # identical, so output is bit-identical to the two-gather form.
    # prev[0] = 0 matches the i0 == 0 edge of the old v0 mask.
    prev = jnp.concatenate([jnp.zeros((1, nch), jnp.float32), ext[:-1]],
                           axis=0)
    pairs = jnp.stack([prev, ext], axis=2)      # [H+n, ch, 2]
    dryv = jnp.asarray(dry, jnp.float32)
    if dryv.ndim == 1:                          # per-frame automation curve
        dryv = dryv[:, None]
    out = dryv * s
    wv = jnp.asarray(wet, jnp.float32) / jnp.float32(voices)
    idx = jnp.arange(n, dtype=jnp.int32)
    cols = []
    for ch in range(nch):
        acc = out[:, ch]
        for v in range(voices):
            d = _chorus_lfo_delay(n0, n, samplerate, rate, depth, delay,
                                  v, voices, ch, P=P)
            df = jnp.floor(d)
            fr = d - df
            i0 = H + idx - df.astype(jnp.int32)     # ext row of s[n - df]
            v0 = i0 - 1 >= 0
            v1 = i0 >= 0
            lim = H + n - 1
            g = pairs[jnp.clip(i0, 0, lim), ch, :]  # [n, 2] = (x[i0-1], x[i0])
            x0 = jnp.where(v0, g[:, 0], 0.0)
            x1 = jnp.where(v1, g[:, 1], 0.0)
            acc = acc + wv * (x0 * fr + x1 * (jnp.float32(1.0) - fr))
        cols.append(acc)
    return jnp.stack(cols, axis=1)


#: Banded-chorus tap cap: the K+2 static tap slices unroll in Python, so
#: the HLO grows as (K+2)*voices*nch full-length slice/where/fma ops.  K
#: tracks depth*pi*rate*G (the in-block delay spread); past this bound the
#: pair gather is the better program (compile size and wasted FLOPs
#: outweigh the gather saved), so chorus() routes back to it.
CHORUS_BANDED_MAX_TAPS = 64


def chorus(frames: jax.Array, samplerate: int, rate: float, depth: float,
           delay: float, voices: int, wet: float, dry: float) -> jax.Array:
    """Multi-voice modulated fractional delay; spec and tolerance:
    goldref.effects.chorus.

    Offline knobs are STATIC, which makes the LFO delay curve a pure
    host function of the absolute frame index — the same property that
    lets the phase-vocoder windows avoid an element gather.  The banded
    form exploits it: the host plans per-block window starts
    (ops.coeffs.chorus_block_plan), the device reads ~n/G anchored
    window rows (a few-hundred-row sliced gather) and reduces K+2 STATIC
    tap slices with exact one-hot lerp weights — the per-frame modulated
    pair gather (15.9 M index rows per 60 s render) is gone.  Arithmetic
    per output is the identical two-term f32 lerp in the identical order,
    so the banded path is bit-compatible with the gather form (pinned by
    tests/test_effects.py) and holds the same goldref budget."""
    width = dpcm.width_of(frames)
    n, nch = int(frames.shape[0]), int(frames.shape[1])

    def _gather_form():
        out = chorus_core(_norm(frames), jnp.int32(0),
                          jnp.zeros((0, nch), jnp.float32), samplerate,
                          rate, depth, delay, voices, wet, dry)
        return to_int_samples(out, width)

    if (not isinstance(depth, (int, float))
            or not isinstance(delay, (int, float))
            or delay * samplerate < 1.0 or n < 16384):
        # the host plan needs depth/delay as host scalars (a traced knob
        # routes to the gather form); zero-delay edge (the banded window
        # would read past the input; the gather path's clip defines the
        # contract) and small inputs (plan overhead beats the gather win)
        # keep the pair-gather form too
        return _gather_form()
    from .coeffs import chorus_block_plan
    G, K, nb, pad0, padtot, starts, dfmax = chorus_block_plan(
        n, samplerate, rate, depth, delay, voices, nch)
    if K > CHORUS_BANDED_MAX_TAPS:
        # fast/deep LFOs (depth*pi*rate per-frame delay motion past
        # ~target_taps/G_min) would unroll K+2 full-length tap slices per
        # voice per channel — hundreds of wasted O(n) ops and an HLO-size
        # blowup; those knobs stay on the pair gather
        return _gather_form()
    s = _norm(frames)
    dryv = jnp.asarray(dry, jnp.float32)
    wv = jnp.asarray(wet, jnp.float32) / jnp.float32(voices)
    W = G + K + 2
    cols = []
    for ch in range(nch):
        # zero flanks: reads before frame 0 are the spec's zeros (the
        # gather path's v0/v1 masks); reads past n-1 only feed outputs
        # u >= n, which the final [:n] slice discards
        sch = jnp.concatenate([
            jnp.zeros((pad0,), jnp.float32), s[:, ch],
            jnp.zeros((padtot - pad0 - n,), jnp.float32)])
        acc = dryv * s[:, ch]
        for v in range(voices):
            d = _chorus_lfo_delay(jnp.int32(0), nb * G, samplerate, rate,
                                  depth, delay, v, voices, ch)
            df = jnp.floor(d)
            fr = (d - df).reshape(nb, G)
            one_m_fr = jnp.float32(1.0) - fr
            # tap index of the x0 read (one frame older than x1): the
            # window is anchored at dfmax_b + 1 frames of delay
            k0 = (dfmax[ch * voices + v][:, None]
                  - df.astype(jnp.int32).reshape(nb, G))
            Z = jax.vmap(lambda s0: jax.lax.dynamic_slice(
                sch, (s0,), (W,)))(jnp.asarray(starts[ch * voices + v]))
            vacc = jnp.zeros((nb, G), jnp.float32)
            for k in range(K + 2):
                zk = jax.lax.slice(Z, (0, k), (nb, k + G))
                w = (jnp.where(k0 == k, fr, jnp.float32(0.0))
                     + jnp.where(k0 + 1 == k, one_m_fr, jnp.float32(0.0)))
                vacc = vacc + w * zk
            acc = acc + wv * vacc.reshape(-1)[:n]
        cols.append(acc)
    return to_int_samples(jnp.stack(cols, axis=1), width)


# ---------------------------------------------------------------------------
# FFT convolution
# ---------------------------------------------------------------------------

def _fft_conv_full(s: jax.Array, ir_norm: jax.Array, wet, dry) -> jax.Array:
    """y = dry*pad(s) + wet*(s ⊛ ir), full length n+m-1, f32 (the single
    FFT-convolution implementation; spec: goldref.effects.convolve)."""
    n, nch = s.shape
    if ir_norm.ndim == 1:
        ir_norm = ir_norm[:, None]
    m = ir_norm.shape[0]
    out_len = n + m - 1
    fft_len = 1 << (out_len - 1).bit_length()
    X = jnp.fft.rfft(s, n=fft_len, axis=0)
    if ir_norm.shape[1] != nch:
        ir_norm = jnp.broadcast_to(ir_norm[:, :1], (m, nch))
    H = jnp.fft.rfft(ir_norm, n=fft_len, axis=0)
    y = jnp.fft.irfft(X * H, n=fft_len, axis=0)[:out_len]
    y = jnp.asarray(wet, jnp.float32) * y
    return y.at[:n].add(jnp.asarray(dry, jnp.float32) * s)


def convolve(frames: jax.Array, ir_norm: jax.Array, wet: float,
             dry: float) -> jax.Array:
    """Whole-signal convolution op (length n+m-1); spec and tolerance:
    goldref.effects.convolve."""
    width = dpcm.width_of(frames)
    return to_int_samples(_fft_conv_full(_norm(frames), ir_norm, wet, dry),
                          width)


def convolve_chunk(frames: jax.Array, ir_norm: jax.Array, wet, dry,
                   tail: jax.Array):
    """Streaming overlap-add twin: convolve one chunk, emit the first n
    frames (plus the carried tail) and return the new (m-1)-frame tail."""
    width = dpcm.width_of(frames)
    n = frames.shape[0]
    m = ir_norm.shape[0]
    y = _fft_conv_full(_norm(frames), ir_norm, wet, dry)
    if m > 1:
        y = y.at[:m - 1].add(tail)
        new_tail = y[n:]
    else:
        new_tail = tail
    return to_int_samples(y[:n], width), new_tail


# ---------------------------------------------------------------------------
# Phase-vocoder time stretch
# ---------------------------------------------------------------------------

#: Lane width for the row-packed analysis-window gather below: W shifted
#: copies of the signal turn the [T, frame] element gather into a
#: [T, frame/W]-row gather, W x fewer index rows for W x the staging
#: memory (W * n * 4 bytes).  Whether this still pays over the plain
#: element gather on a GPU is not measured yet.
FRAME_GATHER_WIDTH = 16


def _framed_rows(s1: jax.Array, starts_np: np.ndarray,
                 frame: int) -> jax.Array:
    """All [T, frame] analysis windows of the 1-D signal ``s1`` at the
    host-known ``starts_np`` — bit-identical to ``s1[starts[:,None] +
    arange(frame)]`` but gathered as frame/W rows of W lanes per window:
    start = W*q + r lands the window on rows q..q+frame/W-1 of the r-th
    shifted copy (each copy reshaped [rows, W]), so the lag never crosses
    a row.  ``s1`` must already be padded past starts[-1] + frame."""
    W = FRAME_GATHER_WIDTH
    T = len(starts_np)
    if frame % W:                                   # exotic frame sizes
        idx = jnp.asarray(starts_np[:, None] + np.arange(frame)[None, :])
        return s1[idx]
    nrows = -(-int(s1.shape[0]) // W) + 1
    base = nrows * W
    spad = jnp.concatenate(
        [s1, jnp.zeros(base + W - int(s1.shape[0]), jnp.float32)])
    copies = jnp.stack(
        [spad[r:r + base].reshape(nrows, W) for r in range(W)])
    scall = copies.reshape(W * nrows, W)
    q = (starts_np // W).astype(np.int64)
    r = (starts_np % W).astype(np.int64)
    m = np.arange(frame // W, dtype=np.int64)
    ridx = jnp.asarray(r[:, None] * nrows + q[:, None] + m[None, :])
    return scall[ridx].reshape(T, frame)


def stretch(frames: jax.Array, factor: float, frame: int = 2048,
            hop: int = 512) -> jax.Array:
    """Phase-vocoder time stretch; spec, grid, and tolerance:
    goldref.effects.stretch.  Device shape: ONE row-packed gather builds all
    [T, frame] windows (_framed_rows), batched rfft/irfft over the frame
    axis, the per-bin phase accumulation is a cumsum (parallel prefix),
    and the overlap-add is R contiguous slice-adds — no per-frame host
    loop and no element-granularity gather/scatter."""
    from .coeffs import stretch_grid
    width = dpcm.width_of(frames)
    n, nch = frames.shape
    starts_np, target = stretch_grid(n, factor, frame, hop)
    T = len(starts_np)
    n_pad = max(n, int(starts_np[-1]) + frame)
    s = jnp.concatenate(
        [_norm(frames), jnp.zeros((n_pad - n, nch), jnp.float32)], axis=0)
    win = jnp.asarray(np.hanning(frame + 1)[:frame], jnp.float32)
    K = frame // 2 + 1
    omega = (2.0 * np.pi / frame) * np.arange(K)
    hops = np.diff(starts_np).astype(np.float64)                  # host f64
    # host-precomputed per-step constants (exact f64, cast once)
    om_hops = jnp.asarray(omega[None, :] * hops[:, None], jnp.float32)
    hop_scale = jnp.asarray((hop / hops), jnp.float32)
    two_pi = jnp.float32(2.0 * np.pi)

    out_len = (T - 1) * hop + frame
    wsum_np = np.zeros(out_len, np.float64)
    w2 = np.asarray(np.hanning(frame + 1)[:frame]) ** 2
    for j in range(T):
        wsum_np[j * hop:j * hop + frame] += w2
    inv_wsum = jnp.asarray(1.0 / np.maximum(wsum_np, 1e-8), jnp.float32)
    oa_ratio = frame // hop if frame % hop == 0 else 0
    oa_idx = None if oa_ratio else \
        (np.arange(T)[:, None] * hop + np.arange(frame)[None, :])

    def overlap_add(seg_s):
        if not oa_ratio:
            acc = jnp.zeros(out_len, jnp.float32)
            return acc.at[oa_idx.reshape(-1)].add(seg_s.reshape(-1))
        # frame = R*hop: group R consecutive windows j = b*R + r — window
        # (b, r) starts at b*frame + r*hop, so each group fits a 2*frame
        # canvas row at column r*hop (max (R-1)*hop + frame < 2*frame) and
        # row b occupies absolute [b*frame, (b+2)*frame).  R static
        # column-slice adds place the windows, then the half-overlapped
        # rows land with TWO contiguous slice-adds.  (The earlier
        # r::R-strided grouping fused with the irfft into a measured ~10x
        # slower program — the major-axis stride broke the batched FFT's
        # preferred layout; this grouping keeps rows consecutive.)
        R = oa_ratio
        B = -(-T // R)
        segp = jnp.concatenate(
            [seg_s, jnp.zeros((B * R - T, frame), jnp.float32)]
        ).reshape(B, R, frame)
        canvas = jnp.zeros((B, 2 * frame), jnp.float32)
        for r in range(R):
            canvas = canvas.at[:, r * hop:r * hop + frame].add(segp[:, r])
        acc = jnp.zeros(B * frame + frame, jnp.float32)
        acc = acc.at[:B * frame].add(canvas[:, :frame].reshape(-1))
        acc = acc.at[frame:].add(canvas[:, frame:].reshape(-1))
        return acc[:out_len]

    cols = []
    for ch in range(nch):
        seg = _framed_rows(s[:, ch], starts_np, frame) \
            * win[None, :]                                   # [T, frame]
        spec = jnp.fft.rfft(seg, axis=1)                     # [T, K] c64
        mag = jnp.abs(spec).astype(jnp.float32)
        phi = jnp.arctan2(spec.imag, spec.real).astype(jnp.float32)
        dphi = phi[1:] - phi[:-1] - om_hops
        wrapped = dphi - two_pi * jnp.round(dphi / two_pi)
        adv_syn = (om_hops + wrapped) * hop_scale[:, None]
        psi = jnp.concatenate(
            [phi[:1], phi[:1] + jnp.cumsum(adv_syn, axis=0)], axis=0)
        spec_s = (mag * jnp.cos(psi)) + 1j * (mag * jnp.sin(psi))
        seg_s = jnp.fft.irfft(spec_s, n=frame, axis=1).astype(jnp.float32) \
            * win[None, :]
        cols.append(overlap_add(seg_s) * inv_wsum)
    out = jnp.stack(cols, axis=1)
    if target > out_len:
        out = jnp.concatenate(
            [out, jnp.zeros((target - out_len, nch), jnp.float32)])
    return to_int_samples(out[:target], width)


# ---------------------------------------------------------------------------
# Granular synthesis
# ---------------------------------------------------------------------------

def granulate(frames: jax.Array, samplerate: int, duration: float,
              grain: float, density: float, jitter: float, amplitude,
              seed: int) -> jax.Array:
    """Granular resynthesis; spec/grid/tolerance: goldref.effects.granulate.
    Device shape: ONE [G, L] gather builds every grain, one window multiply,
    one scatter-add onto the canvas — positions are the shared host grid."""
    from .coeffs import grain_grid
    width = dpcm.width_of(frames)
    n, nch = frames.shape
    in_pos, out_pos, L, out_len = grain_grid(n, samplerate, duration, grain,
                                             density, jitter, seed)
    s = jnp.concatenate(
        [_norm(frames), jnp.zeros((max(n, L) - n, nch), jnp.float32)], axis=0)
    win = jnp.asarray(np.hanning(L + 1)[:L], jnp.float32) \
        * jnp.asarray(amplitude, jnp.float32)
    gi = jnp.asarray(in_pos[:, None] + np.arange(L)[None, :])      # [G, L]
    grains = s[gi] * win[None, :, None]                            # [G, L, ch]
    oi = jnp.asarray(out_pos[:, None] + np.arange(L)[None, :])
    out = jnp.zeros((out_len, nch), jnp.float32)
    out = out.at[oi.reshape(-1)].add(grains.reshape(-1, nch), mode="drop")
    return to_int_samples(out, width)


def tremolo(frames: jax.Array, g: jax.Array) -> jax.Array:
    """Per-frame tremolo gain grid (host-derived,
    ops.coeffs.tremolo_gain_grid) through the house gain rule.  Spec:
    goldref.effects.tremolo; <= 1 LSB (FMA class)."""
    return dpcm.gain_apply(frames, g[:, None])


def autopan(frames: jax.Array, pan: jax.Array) -> jax.Array:
    """Per-frame pan grid (host-derived, ops.coeffs.autopan_pan_grid)
    through the equal-gain pan law.  Spec: goldref.effects.autopan."""
    lg = jnp.minimum(jnp.float32(1.0), jnp.float32(1.0) - pan)
    rg = jnp.minimum(jnp.float32(1.0), jnp.float32(1.0) + pan)
    return dpcm.gain_apply(frames, jnp.stack([lg, rg], axis=1))


# ---------------------------------------------------------------------------
# Feedback echo
# ---------------------------------------------------------------------------

def feedback_echo_core(s: jax.Array, D: int, fb, hist: jax.Array):
    """The feedback-delay recurrence d_n = s_n + fb_n * d_{n-D} evaluated
    blockwise (spec: goldref.effects.feedback_echo): a ``lax.scan`` over
    length-D blocks whose carry is the previous d block — each element's
    arithmetic order is IDENTICAL to the per-sample oracle (element i of
    block j depends only on element i of block j-1), so the only device
    deviation is FMA contraction of ``s + fb*d`` (<= 1 LSB applied).

    ``s`` [n, ch] normalized f32; ``fb`` scalar or [n] grid; ``hist``
    [D, ch] = d values for the D frames before s (zeros at a cold start).
    Returns (e, new_hist) with e_n = d_{n-D} (the wet tap)."""
    n, nch = s.shape
    nb = -(-n // D)
    pad = nb * D - n
    sp = jnp.concatenate([s, jnp.zeros((pad, nch), jnp.float32)]) \
        .reshape(nb, D, nch)
    fbv = jnp.broadcast_to(jnp.asarray(fb, jnp.float32), (n,))
    fbp = jnp.concatenate([fbv, jnp.zeros(pad, jnp.float32)]) \
        .reshape(nb, D, 1)

    def step(prev, xs):
        sb, fbb = xs
        d = sb + fbb * prev
        return d, d

    _, dblocks = jax.lax.scan(step, hist, (sp, fbp))
    d = dblocks.reshape(nb * D, nch)[:n]
    e = jnp.concatenate([hist, d])[:n]
    new_hist = jnp.concatenate([hist, d])[n:n + D] if n < D \
        else d[n - D:n]
    return e, new_hist


def feedback_echo(frames: jax.Array, D: int, fb, wet, dry,
                  tail_frames: int) -> jax.Array:
    """Whole-signal feedback echo (the staged Sample op): zero-pads by
    ``tail_frames``, runs the blocked recurrence cold, mixes
    dry*s + wet*e, house synthesis quantization.  Spec/budget:
    goldref.effects.feedback_echo."""
    width = dpcm.width_of(frames)
    n, nch = frames.shape
    total = n + int(tail_frames)
    s = jnp.concatenate([_norm(frames),
                         jnp.zeros((total - n, nch), jnp.float32)])
    e, _ = feedback_echo_core(s, D, fb, jnp.zeros((D, nch), jnp.float32))
    out = (jnp.asarray(dry, jnp.float32) * s
           + jnp.asarray(wet, jnp.float32) * e)
    return to_int_samples(out, width)


# ---------------------------------------------------------------------------
# Stereo width
# ---------------------------------------------------------------------------

def stereo_width(frames: jax.Array, amount) -> jax.Array:
    """Mid/side width control; spec: goldref.effects.stereo_width.
    ``amount`` scalar or [n] grid; budget <= 1 LSB (FMA contraction)."""
    width = dpcm.width_of(frames)
    s = _norm(frames)
    a = jnp.broadcast_to(jnp.asarray(amount, jnp.float32),
                         (frames.shape[0],))
    m = jnp.float32(0.5) * (s[:, 0] + s[:, 1])
    sd = jnp.float32(0.5) * (s[:, 0] - s[:, 1])
    out = jnp.stack([m + a * sd, m - a * sd], axis=1)
    return to_int_samples(out, width)


# ---------------------------------------------------------------------------
# Lookahead brickwall limiter
# ---------------------------------------------------------------------------

def limiter_gains_core(a: jax.Array, ceil_db, decay, L: int,
                       r0=jnp.float32(0.0), gpad0=None):
    """Per-sample limiter gains from the linked detector level ``a`` [n]
    (spec: goldref.effects.limiter_gains).  Device shape: the lookahead
    window max and the box attack ramp are ``reduce_window`` ops, the
    release is the associative decaying-max scan — no sequential loops.

    ``a`` must already INCLUDE the L frames of lookahead context past the
    emission range (the whole-signal caller pads with zeros; the
    streaming caller appends the held-back frames), i.e. gains are
    returned for the first n-L positions... whole-signal: pass a padded
    by L zeros, get n gains back.  ``r0`` carries the release state;
    ``gpad0`` [L] carries the previous chunk's trailing gains for the box
    ramp (ones at a cold start).  Returns (gs, new_r, new_gpad)."""
    n_em = a.shape[0] - L
    level_db = jnp.float32(20.0) * jnp.log10(
        jnp.maximum(a, jnp.float32(1e-10)))
    need = jnp.maximum(jnp.float32(0.0),
                       level_db - jnp.asarray(ceil_db, jnp.float32))
    w = jax.lax.reduce_window(need, -jnp.inf, jax.lax.max,
                              (L + 1,), (1,), "valid")          # [n_em]
    R = decaying_max_scan(w, decay, init=r0)
    g = jnp.exp2(-R * jnp.float32(1.0 / 6.0206))
    if gpad0 is None:
        gpad0 = jnp.ones((L,), jnp.float32)
    gp = jnp.concatenate([gpad0, g])
    gs = jax.lax.reduce_window(gp, jnp.float32(0.0), jax.lax.add,
                               (L + 1,), (1,), "valid") \
        * jnp.float32(1.0 / (L + 1))
    new_r = R[-1] if n_em > 0 else r0
    new_gpad = gp[n_em:n_em + L]
    return gs, new_r, new_gpad


def limiter(frames: jax.Array, ceil_db, decay, L: int,
            ceil_int) -> jax.Array:
    """Whole-signal lookahead limiter (the staged Sample op): gains via
    the padded window (need past the end is 0), applied with the house
    gain rule, then the hard integer clamp at ``ceil_int`` (host-derived
    rint(exp2(ceil_db/6.0206)*maxval)).  Length preserved.  Spec:
    goldref.effects.limiter."""
    a = jnp.max(jnp.abs(_norm(frames)), axis=1)
    ap = jnp.concatenate([a, jnp.zeros((L,), jnp.float32)])
    gs, _, _ = limiter_gains_core(ap, ceil_db, decay, L)
    y = dpcm.gain_apply(frames, gs[:, None])
    c = jnp.asarray(ceil_int, frames.dtype)
    return jnp.clip(y, -c, c)


# ---------------------------------------------------------------------------
# Phaser (LFO-swept allpass cascade)
# ---------------------------------------------------------------------------

def phaser_apply(s: jax.Array, grids, states, ff: bool):
    """Run the phaser's allpass cascade on a normalized f32 signal: every
    stage shares the SAME per-frame coefficient grids (host-derived,
    ops.coeffs.phaser_coeff_grids) and keeps its own carried biquad
    state; the cascade stays in float end to end (one quantization at the
    caller's output).  ``states`` is a tuple of per-stage biquad states
    (len == stages); ``ff`` routes badly-conditioned sweeps (low
    min_freq) through the compensated float-float scan.  Returns
    (y, new_states).  Spec/budget: goldref.effects.phaser."""
    new_states = []
    y = s
    for st in states:
        if ff:
            y, ns = biquad_apply_ff(y, grids, st)
        else:
            y, ns = biquad_apply(y, grids, st)
        new_states.append(ns)
    return y, tuple(new_states)
