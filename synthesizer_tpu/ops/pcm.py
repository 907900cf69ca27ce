"""Device PCM primitives (XLA, int32-native).

Device equivalents of the C ``audioop`` primitives the reference's
``synthplayer/sample.py`` delegates all hot PCM arithmetic to (SURVEY.md
§3.3).  Numeric contract, tested against :mod:`goldref.pcm`:

* **Integer ops** (saturating add, wrapping bias, width conversion) are
  bit-exact to audioop.  Saturation is implemented with pure int32
  overflow detection — no int64, no floats — so it runs as plain int32
  elementwise work.
* **Float-factor ops** (mul/amplify, mono/stereo matrixing, gain ramps)
  follow the float32 spec: IEEE-f32 product, ``floor``, clamp.  This is
  bit-identical to ``goldref.pcm.*_f32`` and within 1 LSB of audioop's
  C-double path (see goldref docs).

Arrays are plain jnp integer arrays (int8/int16/int32 for widths 1/2/4),
any shape; channel layout is handled by callers.  All public functions are
jit-compiled with dtype-generic tracing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

DTYPES = {1: jnp.int8, 2: jnp.int16, 4: jnp.int32}
MINVAL = {1: -(1 << 7), 2: -(1 << 15), 4: -(1 << 31)}
MAXVAL = {1: (1 << 7) - 1, 2: (1 << 15) - 1, 4: (1 << 31) - 1}

_WIDTH_OF = {jnp.dtype(jnp.int8): 1, jnp.dtype(jnp.int16): 2, jnp.dtype(jnp.int32): 4}


def width_of(x) -> int:
    return _WIDTH_OF[jnp.dtype(x.dtype)]


# ---------------------------------------------------------------------------
# Saturating / wrapping integer arithmetic
# ---------------------------------------------------------------------------

@jax.jit
def sat_add(a: jax.Array, b: jax.Array) -> jax.Array:
    """Element-wise saturating add (audioop.add). a and b share an int dtype."""
    w = width_of(a)
    if w < 4:
        s = a.astype(jnp.int32) + b.astype(jnp.int32)
        return jnp.clip(s, MINVAL[w], MAXVAL[w]).astype(a.dtype)
    # int32: wrap-add then fix up overflow (XLA int add is two's-complement).
    s = a + b
    overflow = ((a ^ s) & (b ^ s)) < 0
    sat = jnp.where(a >= 0, jnp.int32(MAXVAL[4]), jnp.int32(MINVAL[4]))
    return jnp.where(overflow, sat, s)


@jax.jit
def bias_wrap(a: jax.Array, b: jax.Array) -> jax.Array:
    """Wrapping constant add (audioop.bias — no clamp)."""
    return a + jnp.asarray(b, dtype=a.dtype)


def lin2lin(a: jax.Array, newwidth: int) -> jax.Array:
    """Width conversion: widen = left shift, narrow = arithmetic right shift."""
    w = width_of(a)
    if newwidth == w:
        return a
    v32 = a.astype(jnp.int32) << (32 - 8 * w)
    return (v32 >> (32 - 8 * newwidth)).astype(DTYPES[newwidth])


# ---------------------------------------------------------------------------
# Float32-spec scaling ops
# ---------------------------------------------------------------------------

def floor_clamp(v_f32: jax.Array, width: int, dtype) -> jax.Array:
    v = jnp.floor(v_f32)
    if width < 4:
        out = jnp.clip(v, np.float32(MINVAL[width]), np.float32(MAXVAL[width])).astype(jnp.int32)
        return out.astype(dtype)
    # width 4: INT32_MAX is not f32-representable; saturate explicitly.  Any
    # f32 in (-2^31, 2^31) is an exact integer after floor, so the cast below
    # is exact for in-range values.
    hi = np.float32(2147483648.0)   # 2^31, exactly representable
    out = jnp.where(v >= hi, jnp.int32(MAXVAL[4]),
                    jnp.where(v < -hi, jnp.int32(MINVAL[4]),
                              jnp.clip(v, -hi, hi - 128).astype(jnp.int32)))
    return out.astype(dtype)


@jax.jit
def mul_floor(a: jax.Array, factor: jax.Array) -> jax.Array:
    """audioop.mul under the f32 spec: floor(f32(a) * f32(factor)), clamp."""
    w = width_of(a)
    prod = a.astype(jnp.float32) * jnp.asarray(factor, jnp.float32)
    return floor_clamp(prod, w, a.dtype)


@jax.jit
def gain_apply(a: jax.Array, gains: jax.Array) -> jax.Array:
    """Per-sample gain (fades, envelopes, amplitude modulation, LFO pan):
    floor(f32(a) * f32(gain)), clamp.  ``gains`` broadcasts against ``a``."""
    w = width_of(a)
    prod = a.astype(jnp.float32) * gains.astype(jnp.float32)
    return floor_clamp(prod, w, a.dtype)


@jax.jit
def to_mono(a: jax.Array, lfactor: jax.Array, rfactor: jax.Array) -> jax.Array:
    """[n, 2] -> [n, 1]: floor(L*lf + R*rf), clamp (audioop.tomono, f32 spec).

    Note: the backend is free to contract the multiply-add into an FMA
    (LLVM codegen does this regardless of HLO-level barriers), so this
    op is specified to ≤1 LSB of the host oracle rather than bit-exact —
    exactly the tolerance BASELINE.json grants the float path.  Single-product
    ops (mul_floor/gain_apply/to_stereo) have no add to contract and remain
    bit-exact.
    """
    w = width_of(a)
    af = a.astype(jnp.float32)
    v = af[..., 0] * jnp.asarray(lfactor, jnp.float32) \
        + af[..., 1] * jnp.asarray(rfactor, jnp.float32)
    return floor_clamp(v, w, a.dtype)[..., None]


@jax.jit
def to_stereo(a: jax.Array, lfactor: jax.Array, rfactor: jax.Array) -> jax.Array:
    """[n, 1] -> [n, 2]: per-channel floor(v*f), clamp (audioop.tostereo)."""
    w = width_of(a)
    af = a.astype(jnp.float32)[..., 0]
    l = floor_clamp(af * jnp.asarray(lfactor, jnp.float32), w, a.dtype)
    r = floor_clamp(af * jnp.asarray(rfactor, jnp.float32), w, a.dtype)
    return jnp.stack([l, r], axis=-1)


# ---------------------------------------------------------------------------
# Metering reductions
# ---------------------------------------------------------------------------

@jax.jit
def peak(a: jax.Array) -> jax.Array:
    """max(|x|) saturated to the width's max (audioop.max modulo INT_MIN edge)."""
    w = width_of(a)
    hi = jnp.max(a.astype(jnp.int32)) if a.size else jnp.int32(0)
    lo = jnp.min(a.astype(jnp.int32)) if a.size else jnp.int32(0)
    neg = jnp.where(lo == jnp.int32(MINVAL[4]), jnp.int32(MAXVAL[4]), -lo) if w == 4 else -lo
    return jnp.maximum(hi, neg)


@jax.jit
def rms_mean_square(a: jax.Array) -> jax.Array:
    """Mean of squares in f32 (callers take sqrt/int on host for the meter)."""
    af = a.astype(jnp.float32)
    return jnp.mean(af * af)


@jax.jit
def vu_levels(a2: jax.Array) -> jax.Array:
    """One stacked f32 [4] array (peak_l, peak_r, ms_l, ms_r) for [n, 2] int.

    Stacked so a metering caller pays ONE host sync per chunk instead of
    four."""
    l, r = a2[..., 0], a2[..., 1]
    return jnp.stack([peak(l).astype(jnp.float32), peak(r).astype(jnp.float32),
                      rms_mean_square(l), rms_mean_square(r)])
