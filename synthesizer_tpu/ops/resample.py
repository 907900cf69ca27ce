"""Exact ratecv resampling on device.

The reference resamples through C ``audioop.ratecv`` — a stateful DDA
linear interpolator (SURVEY.md §8; exact recurrence documented in
``goldref.pcm.ratecv``).  Here the same recurrence is evaluated as a
**closed-form gather** on device, fully vectorized — no sequential loop:

    output k gathers input frames ``i_k-1`` / ``i_k-2`` where
    ``i_k = ceil((k*inrate - d0) / outrate)`` and blends them at weight
    ``d_k = d0 + i_k*outrate - k*inrate``.

For widths 1/2 the emission is provably ``floor(S / outrate)`` in the
*sample* domain with ``S = prev*d + cur*(outrate-d)`` whenever the reduced
``outrate < 2**(32-8w)`` (derivation: the 32-bit-domain trunc-toward-zero
followed by the arithmetic narrowing shift collapses to a single floor
division) — pure int32, bit-exact to audioop.  Width 4 (the
32-bit domain itself, trunc-toward-zero division) runs via exact
16-bit-limb long division (``_interp_trunc_i32`` — no int64 in 32-bit JAX)
for reduced ``outrate <= 2**15``.  Pathological reduced rates beyond
those bounds take the fully general device path (round 3): the exact
32-bit-domain interpolation in sign-magnitude uint32 limb arithmetic
with a bit-serial 63-step long division (``_interp_trunc_wide``) — every
width, every rate pair, all on device; no host fallback remains.

Chunked/streaming use carries ``(d, prev, cur)`` state exactly like
audioop, so scan-over-chunks output is bit-identical to whole-buffer
output (verified property, SURVEY.md §8).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import pcm as dpcm


class RatecvState(NamedTuple):
    """Resampler carry in the *sample* domain (not audioop's 32-bit domain)."""
    d: int
    prev: np.ndarray  # [nchannels] int
    cur: np.ndarray   # [nchannels] int

    def to_audioop(self, width: int) -> Tuple[int, Tuple[Tuple[int, int], ...]]:
        sh = 32 - 8 * width
        return (int(self.d), tuple(
            (int(p) << sh, int(c) << sh) for p, c in zip(self.prev, self.cur)))

    @classmethod
    def initial(cls, nchannels: int, outrate_reduced: int) -> "RatecvState":
        return cls(-outrate_reduced,
                   np.zeros(nchannels, np.int32), np.zeros(nchannels, np.int32))


def _reduce(inrate: int, outrate: int) -> Tuple[int, int]:
    if inrate <= 0 or outrate <= 0:
        raise ValueError("sampling rates must be > 0")
    if inrate >= (1 << 31) or outrate >= (1 << 31):
        # audioop's own domain (C int rates); the device kernels assume
        # reduced rates < 2^31 (the wide path's uint32 long division)
        raise ValueError("sampling rates must be < 2**31")
    g = math.gcd(inrate, outrate)
    return inrate // g, outrate // g


def nframes_out(nframes_in: int, inrate: int, outrate: int,
                d0: Optional[int] = None) -> int:
    inr, outr = _reduce(inrate, outrate)
    if d0 is None:
        d0 = -outr
    kmax = nframes_in * outr + d0
    return 0 if kmax < 0 else kmax // inr + 1


def _interp_trunc_i32(prev: jax.Array, cur: jax.Array, dk: jax.Array,
                      outr: int) -> jax.Array:
    """Exact ``(int)((prev*d + cur*(outr-d)) / outr)`` (trunc toward zero)
    for FULL-RANGE int32 samples, entirely in int32 — 16-bit-limb long
    division, since JAX's default 32-bit mode has no int64.

    Let v = vh*2^16 + vl (vh = v>>16 arithmetic, vl = v & 0xFFFF).  Then
    S = A*2^16 + B with A = ph*d + ch*e, B = pl*d + cl*e (e = outr-d).
    Bounds for outr <= 2^15: |A| <= max(|ph|,|ch|)*outr <= 2^30,
    B <= 65535*outr < 2^31.  Fold B's high half into A (H = A + (B>>16)),
    long-divide: S = H*2^16 + B0, floor(S/outr) = (H//outr)*2^16 +
    (rem*2^16 + B0)//outr with rem < outr, so rem*2^16 + B0 < outr*2^16
    <= 2^31.  Truncation = floor + 1 when S < 0 and S % outr != 0
    (sign(S) == sign(H) because B0 >= 0 < 2^16)."""
    d = dk
    e = outr - dk
    ph, pl = prev >> 16, prev & 0xFFFF
    ch, cl = cur >> 16, cur & 0xFFFF
    A = ph * d + ch * e
    B = pl * d + cl * e
    H = A + (B >> 16)
    B0 = B & 0xFFFF
    qH = H // outr
    rem = (H - qH * outr) * 65536 + B0
    q2 = rem // outr
    r2 = rem - q2 * outr
    floor_q = qH * 65536 + q2
    return floor_q + ((H < 0) & (r2 != 0)).astype(jnp.int32)


def _mul_u32(a: jax.Array, b: jax.Array):
    """Full 32x32 -> 64-bit UNSIGNED product as a (hi, lo) uint32 pair,
    via 16-bit limbs (JAX's default 32-bit mode has no int64/uint64)."""
    mask = jnp.uint32(0xFFFF)
    a0, a1 = a & mask, a >> 16
    b0, b1 = b & mask, b >> 16
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = lh + hl                               # may wrap once (2^32)
    midc = (mid < lh).astype(jnp.uint32)
    lo = ll + (mid << 16)                       # wrapping low word
    c1 = (lo < ll).astype(jnp.uint32)
    hi = hh + (mid >> 16) + (midc << 16) + c1
    return hi, lo


def _interp_trunc_wide(prev32: jax.Array, cur32: jax.Array, dk: jax.Array,
                       outr: int) -> jax.Array:
    """Exact ``(int)((prev32*d + cur32*(outr-d)) / outr)`` (trunc toward
    zero) for FULL-RANGE int32 values and ANY reduced ``outr < 2^31`` —
    the general 32-bit-domain ratecv interpolation (spec:
    goldref.pcm.ratecv, exact int64 there; exact uint32 limbs here).

    Shape: sign-magnitude.  |v|*d products via :func:`_mul_u32` are 63-bit
    (hi, lo) pairs; S combines them with a 64-bit add (same signs) or
    ordered subtract (mixed signs); the magnitude divides by ``outr``
    with a bit-serial long division — 63 fori_loop steps of vector
    uint32 ops (rem < outr <= 2^31-1, so rem<<1|bit fits uint32).
    Truncation toward zero == sign * floor(|S|/outr).  The quotient
    magnitude is <= 2^31 (a weighted average of two int32 magnitudes),
    so the uint32->int32 cast (with 2^31 -> INT32_MIN on the all-minimum
    edge) is exact."""
    d = dk.astype(jnp.uint32)
    e = jnp.uint32(outr) - d

    def mag(v):
        neg = v < 0
        m = v.astype(jnp.uint32)
        return jnp.where(neg, ~m + jnp.uint32(1), m), neg

    mp, sp = mag(prev32)
    mc, sc = mag(cur32)
    h1, l1 = _mul_u32(mp, d)
    h2, l2 = _mul_u32(mc, e)
    same = sp == sc
    ge = (h1 > h2) | ((h1 == h2) & (l1 >= l2))
    # sum (same signs) — carries; |difference| (mixed signs) — borrows
    lo_a = l1 + l2
    hi_a = h1 + h2 + (lo_a < l1).astype(jnp.uint32)
    lo_d1 = l1 - l2
    hi_d1 = h1 - h2 - (l1 < l2).astype(jnp.uint32)
    lo_d2 = l2 - l1
    hi_d2 = h2 - h1 - (l2 < l1).astype(jnp.uint32)
    hm = jnp.where(same, hi_a, jnp.where(ge, hi_d1, hi_d2))
    lm = jnp.where(same, lo_a, jnp.where(ge, lo_d1, lo_d2))
    sign = jnp.where(same, sp, jnp.where(ge, sp, sc))

    outr_u = jnp.uint32(outr)
    nbits = 63

    def body(i, carry):
        rem, q = carry
        bitpos = jnp.uint32(nbits - 1) - i.astype(jnp.uint32)
        from_hi = bitpos >= 32
        sh_hi = jnp.where(from_hi, bitpos - 32, jnp.uint32(0))
        sh_lo = jnp.where(from_hi, jnp.uint32(0), bitpos)
        bit = jnp.where(from_hi, (hm >> sh_hi) & 1, (lm >> sh_lo) & 1)
        rem = (rem << 1) | bit
        geq = rem >= outr_u
        rem = jnp.where(geq, rem - outr_u, rem)
        q = (q << 1) | geq.astype(jnp.uint32)
        return rem, q

    zeros = jnp.zeros_like(hm)
    _, q = jax.lax.fori_loop(0, nbits, body, (zeros, zeros))
    qi = q.astype(jnp.int32)
    return jnp.where(sign, -qi, qi)


def _interp_exact(prev: jax.Array, cur: jax.Array, dk: jax.Array,
                  outr: int, dtype) -> jax.Array:
    """Route one (prev, cur, d) interpolation batch to the cheapest EXACT
    device formula for this (width, reduced outrate): the collapsed
    sample-domain floor division (widths 1/2, small outr), the width-4
    limb division (outr <= 2^15), or the fully general 32-bit-domain
    sign-magnitude path.  ``prev``/``cur`` are int32 in the SAMPLE
    domain; returns samples in ``dtype``."""
    width = jnp.dtype(dtype).itemsize
    if width == 4:
        if outr <= (1 << 15):
            return _interp_trunc_i32(prev, cur, dk, outr).astype(dtype)
        return _interp_trunc_wide(prev, cur, dk, outr).astype(dtype)
    if outr < (1 << (32 - 8 * width)):
        s = prev * dk + cur * (outr - dk)
        return (s // outr).astype(dtype)
    sh = 32 - 8 * width
    q = _interp_trunc_wide(prev << sh, cur << sh, dk, outr)
    return (q >> sh).astype(dtype)


@functools.partial(jax.jit, static_argnames=("inr", "outr", "d0", "nout"))
def _ratecv_kernel(x: jax.Array, prev0: jax.Array, cur0: jax.Array,
                   *, inr: int, outr: int, d0: int, nout: int):
    """x: [L, ch] int8/int16/int32. Returns (y [nout, ch], prev_end, cur_end)."""
    L = x.shape[0]
    xi = x.astype(jnp.int32)
    p0 = prev0.astype(jnp.int32)
    c0 = cur0.astype(jnp.int32)
    k = jnp.arange(nout, dtype=jnp.int32)
    # ceil((k*inr - d0)/outr) via floor-div identity
    ik = -((d0 - k * inr) // outr)
    dk = d0 + ik * outr - k * inr
    cur_idx = ik - 1
    prev_idx = ik - 2
    safe = lambda idx: jnp.clip(idx, 0, max(L - 1, 0))
    cur = jnp.where(cur_idx[:, None] >= 0, xi[safe(cur_idx)], c0[None, :])
    prev = jnp.where(prev_idx[:, None] >= 0, xi[safe(prev_idx)],
                     jnp.where(prev_idx[:, None] == -1, c0[None, :], p0[None, :]))
    y = _interp_exact(prev, cur, dk[:, None], outr, x.dtype)
    if L >= 2:
        prev_end, cur_end = xi[L - 2], xi[L - 1]
    elif L == 1:
        prev_end, cur_end = c0, xi[0]
    else:
        prev_end, cur_end = p0, c0
    return y, prev_end.astype(x.dtype), cur_end.astype(x.dtype)


def _max_segment(inr: int, outr: int) -> int:
    # Keep k*inr and i*outr well inside int32.
    return max(1, min((1 << 30) // max(inr, 1), (1 << 30) // max(outr, 1)))


def resample(
    x: np.ndarray,
    inrate: int,
    outrate: int,
    state: Optional[RatecvState] = None,
    width: Optional[int] = None,
) -> Tuple[np.ndarray, RatecvState]:
    """Resample [n, ch] int samples from inrate to outrate, audioop-exact.

    Every width and rate pair runs the closed-form int32 gather on device
    (_interp_exact routes to the cheapest exact formula).  Returns the
    output array and the carry state for chunked streaming.
    """
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    nch = x.shape[1]
    if width is not None and width != x.dtype.itemsize:
        raise ValueError(f"width {width} does not match array dtype "
                         f"{x.dtype} (the sample domain is the dtype)")
    inr, outr = _reduce(inrate, outrate)
    if state is None:
        state = RatecvState.initial(nch, outr)

    seg = _max_segment(inr, outr)
    outs = []
    d, prev, cur = state.d, np.asarray(state.prev, x.dtype), np.asarray(state.cur, x.dtype)
    if len(x) <= seg:
        # single-kernel fast path: static d0/nout, no padding
        kmax = len(x) * outr + d
        nout = 0 if kmax < 0 else kmax // inr + 1
        y, prev_j, cur_j = _ratecv_kernel(
            jnp.asarray(x), jnp.asarray(prev), jnp.asarray(cur),
            inr=inr, outr=outr, d0=int(d), nout=int(nout))
        d = d + len(x) * outr - nout * inr
        return np.asarray(y), RatecvState(
            int(d), np.asarray(prev_j), np.asarray(cur_j))
    # segmented path (keeps k*inr / i*outr inside int32 for any rates):
    # the STREAM kernel traces d0, so every full segment reuses ONE
    # compiled program — a static-d0 kernel per segment would recompile
    # for each carried phase (pathological rates make seg tiny)
    for s0 in range(0, len(x), seg):
        xs = x[s0:s0 + seg]
        L = len(xs)
        kmax = L * outr + d
        nout = 0 if kmax < 0 else kmax // inr + 1
        max_out = L * outr // inr + 1
        y, prev_j, cur_j = _ratecv_stream_kernel(
            jnp.asarray(xs), jnp.int32(d), jnp.asarray(prev),
            jnp.asarray(cur), inr=inr, outr=outr, max_out=int(max_out))
        outs.append(np.asarray(y)[:nout])
        prev, cur = np.asarray(prev_j), np.asarray(cur_j)
        d = d + L * outr - nout * inr
    y = np.concatenate(outs, axis=0) if outs else np.zeros((0, nch), x.dtype)
    return y, RatecvState(int(d), prev, cur)


def resample_jax(x: jax.Array, inrate: int, outrate: int) -> jax.Array:
    """Whole-buffer device resample for jit pipelines ([n, ch], any width).

    Stateless (fresh stream), static output length; stays on device.
    """
    inr, outr = _reduce(inrate, outrate)
    L = x.shape[0]
    nch = x.shape[1]
    nout = nframes_out(L, inr, outr)
    zeros = jnp.zeros((nch,), x.dtype)
    y, _, _ = _ratecv_kernel(x, zeros, zeros, inr=inr, outr=outr,
                             d0=-outr, nout=nout)
    return y


@functools.partial(jax.jit, static_argnames=("inr", "outr", "max_out"))
def _ratecv_stream_kernel(x: jax.Array, d0: jax.Array, prev0: jax.Array,
                          cur0: jax.Array, *, inr: int, outr: int,
                          max_out: int):
    """Streaming variant: traced d0, padded static output length.

    Emits garbage rows beyond the (host-computed) valid count; the final
    prev/cur carry is exact regardless.
    """
    L = x.shape[0]
    xi = x.astype(jnp.int32)
    p0 = prev0.astype(jnp.int32)
    c0 = cur0.astype(jnp.int32)
    k = jnp.arange(max_out, dtype=jnp.int32)
    ik = -((d0 - k * inr) // outr)
    dk = d0 + ik * outr - k * inr
    cur_idx = jnp.clip(ik - 1, -2, L - 1)
    prev_idx = jnp.clip(ik - 2, -2, L - 1)
    safe = lambda idx: jnp.clip(idx, 0, max(L - 1, 0))
    cur = jnp.where(cur_idx[:, None] >= 0, xi[safe(cur_idx)], c0[None, :])
    prev = jnp.where(prev_idx[:, None] >= 0, xi[safe(prev_idx)],
                     jnp.where(prev_idx[:, None] == -1, c0[None, :], p0[None, :]))
    y = _interp_exact(prev, cur, dk[:, None], outr, x.dtype)
    if L >= 2:
        prev_end, cur_end = xi[L - 2], xi[L - 1]
    elif L == 1:
        prev_end, cur_end = c0, xi[0]
    else:
        prev_end, cur_end = p0, c0
    return y, prev_end.astype(x.dtype), cur_end.astype(x.dtype)


class StreamingResampler:
    """Device-resident chunked ratecv: push fixed-size chunks, get exact
    audioop-compatible output without the signal ever leaving the device.

    The ``d`` phase of the DDA evolves deterministically
    (d' = d + L*outr - nout*inr), so the host mirrors it with integer
    arithmetic and always knows each chunk's valid output count — no
    device->host sync is needed.  Output arrays are padded to the static
    maximum; slice with the returned count.

    >>> rs = StreamingResampler(44100, 48000, nchannels=2)
    >>> y, n = rs.push(chunk)          # y: [max_out, ch] device, y[:n] valid
    """

    def __init__(self, inrate: int, outrate: int, nchannels: int = 2,
                 dtype=jnp.int16):
        self.inr, self.outr = _reduce(inrate, outrate)
        self.d = -self.outr
        self.prev = jnp.zeros((nchannels,), dtype)
        self.cur = jnp.zeros((nchannels,), dtype)

    def out_count(self, nframes_in: int) -> int:
        kmax = nframes_in * self.outr + self.d
        return 0 if kmax < 0 else kmax // self.inr + 1

    def max_out(self, nframes_in: int) -> int:
        """Static padded output size for a given input chunk size."""
        # d ranges in (-outr-inr, 0]; the largest count occurs at d = 0
        return nframes_in * self.outr // self.inr + 1

    def push(self, x: jax.Array):
        """x: [L, ch] device array -> (padded device output, valid_count)."""
        L = int(x.shape[0])
        nout = self.out_count(L)
        y, self.prev, self.cur = _ratecv_stream_kernel(
            x, jnp.int32(self.d), self.prev, self.cur,
            inr=self.inr, outr=self.outr, max_out=self.max_out(L))
        self.d = self.d + L * self.outr - nout * self.inr
        return y, nout


# ---------------------------------------------------------------------------
# High-quality polyphase resampler (windowed sinc, one strided conv)
# ---------------------------------------------------------------------------

#: Largest reduced up-factor the hq path accepts.  The conv kernel embeds
#: one feature row per polyphase leg, so its size is O(L * (taps + M));
#: every standard audio-rate pair (8k/11025/16k/22050/24k/32k/44.1k/48k/
#: 88.2k/96k/192k in any combination) reduces to L, M <= 640.  A
#: pathological coprime pair (e.g. 44100 -> 44101) would need a ~2 GB
#: kernel — reject it honestly instead.
HQ_MAX_FACTOR = 2048


def bounded_ratio(outrate: int, inrate: int,
                  maxterm: int = HQ_MAX_FACTOR) -> Tuple[int, int]:
    """Best rational approximation (L, M) of outrate/inrate with BOTH
    terms <= ``maxterm`` (continued-fraction convergent via
    Fraction.limit_denominator).  Used by Sample.speed(quality='hq') for
    arbitrary-real speed ratios: micro-cents of pitch error in the
    musical range (bounds pinned in tests/test_hq_resample.py), orders
    below the ``int(samplerate*speed)`` truncation the speed API itself
    applies.  Spec twin: goldref.sample._bounded_ratio.
    Raises for ratios that cannot fit (|log2 ratio| > log2 maxterm)."""
    from fractions import Fraction
    if outrate < 1 or inrate < 1:
        raise ValueError("rates must be positive")
    # bound the denominator so the numerator lands under maxterm too
    # (numerator ~= ratio*denominator); back off if the convergent's
    # rounding still overshoots by one
    limit = min(maxterm, maxterm * inrate // outrate)
    while limit >= 1:
        f = Fraction(outrate, inrate).limit_denominator(limit)
        if f.numerator < 1:
            break
        if max(f.numerator, f.denominator) <= maxterm:
            return f.numerator, f.denominator
        limit -= 1
    raise ValueError(
        f"speed ratio {inrate}/{outrate} is beyond the {maxterm}x range "
        f"of the quality='hq' polyphase bank")


@functools.lru_cache(maxsize=32)
def _hq_kernel(L: int, M: int) -> Tuple[np.ndarray, int, int]:
    """Phase-embedded conv kernel for hq_resample.

    Output j of the resampler reads phase leg ``phi_j = (j*M + C) % L`` at
    input anchor ``k0_j = (j*M + C) // L`` (goldref.effects.hq_resample is
    the spec).  Outputs j and j+L share the phase and their anchors differ
    by exactly M, so the first L output indices j0 define L conv FEATURES:
    feature j0's kernel row carries leg phi(j0) placed at offset k0(j0),
    and a single stride-M cross-correlation then yields
    ``out[j0, m] == y[j0 + m*L]`` — the interleave is one transpose+
    reshape, no gather.  Returns (K [L, 1, Kw] f32, PL, Kw) where PL is
    the left input padding (= taps-1) baked into the row offsets.
    """
    from .coeffs import hq_resample_filter
    h = hq_resample_filter(L, M)
    N = len(h)
    T = N // L
    C = (N - 1) // 2
    k0 = [(j * M + C) // L for j in range(L)]
    phi = [(j * M + C) % L for j in range(L)]
    PL = T - 1
    Kw = PL + max(k0) + 1
    K = np.zeros((L, 1, Kw), np.float64)
    for j in range(L):
        for t in range(T):
            K[j, 0, PL + k0[j] - t] = h[phi[j] + t * L]
    return K.astype(np.float32), PL, Kw


def hq_resample(x: jax.Array, L: int, M: int, nout: int) -> jax.Array:
    """Windowed-sinc polyphase resample by the reduced ratio L/M as ONE
    strided f32 convolution (precision=HIGHEST — a TF32 conv at default
    precision would miss the 1-LSB budget).  Spec, output-length rule, and the
    <= 1 LSB (width 2) device budget: goldref.effects.hq_resample."""
    if max(L, M) > HQ_MAX_FACTOR:
        raise ValueError(
            f"quality='hq' supports rational rate ratios up to "
            f"{HQ_MAX_FACTOR} after gcd reduction; got {L}/{M}")
    width = dpcm.width_of(x)
    n, nch = x.shape
    if n == 0 or nout == 0:
        return x[:0]
    K, PL, Kw = _hq_kernel(L, M)
    t_count = -(-nout // L)
    PR = max(0, (t_count - 1) * M + Kw - PL - n)
    s = x.astype(jnp.float32) / jnp.float32(dpcm.MAXVAL[width])
    y = jax.lax.conv_general_dilated(
        s.T[:, None, :], jnp.asarray(K), window_strides=(M,),
        padding=[(PL, PR)], precision=jax.lax.Precision.HIGHEST)
    y = y[:, :, :t_count]                        # [ch, L, t_count]
    y = y.transpose(0, 2, 1).reshape(nch, -1)[:, :nout].T
    from .effects import to_int_samples
    return to_int_samples(y, width)


#: Streaming conv blocks are padded up to a multiple of this many output
#: rows (of L legs each).  XLA regroups a conv's window reduction when
#: the spatial extent is tiny (measured in round 4: 1 LSB vs offline on
#: heavy downsampling at chunk size 1, where mcount=1 made the conv
#: input Kw-wide); padding every block to >= 32 strides keeps the
#: streaming conv in the same large-spatial regime as the offline op, so
#: the per-output reduction order matches and streaming == offline
#: BIT-EXACTLY at every chunk size (tests/test_hq_streaming.py pins
#: bit-identity at chunks {1, 7, 160, 997, 1470, 65536}).  Cost bound:
#: <= MB-1 discarded rows per block (at most 2x work at chunk size 1 —
#: the pathological case; steady streams with chunk >> M*MB pad < 3%).
HQ_STREAM_BLOCK = 32


@functools.partial(jax.jit,
                   static_argnames=("L", "M", "mcount", "width", "hmax"))
def _hq_stream_kernel(hist: jax.Array, chunk: jax.Array, start: jax.Array,
                      *, L: int, M: int, mcount: int, width: int, hmax: int):
    """One streaming hq block: the SAME conv kernel row and Kw-wide
    window per output as the offline ``hq_resample``; callers pad
    ``mcount`` to a multiple of ``HQ_STREAM_BLOCK`` so the conv's
    spatial extent never enters the tiny-shape regime where XLA's
    window-reduction grouping diverges from the offline op — making
    every emitted output the bit-identical f32 dot (the rows past the
    caller's valid range read zero-flank future input and are
    discarded).

    ``hist`` is the fixed-size device history ring (global input frames
    ``[n0-hmax, n0)``, zero rows for negative indices), ``chunk`` the new
    frames ``[n0, n0+Lc)``, ``start`` the traced offset of the block's
    conv window inside the zero-flanked concat (host-computed — the DDA
    phase is mirrored in exact host integers, no device->host sync).
    Returns ([mcount*L, ch] int outputs for global j = jA + row, new
    history ring).
    """
    K, PL, Kw = _hq_kernel(L, M)
    W = (mcount - 1) * M + Kw
    nch = hist.shape[1]
    buf = jnp.concatenate([hist, chunk], axis=0)
    zpad = jnp.zeros((W, nch), buf.dtype)
    # left flank covers pre-stream zeros, the double right flank covers
    # the flush tail (reads up to ~C/L past the final input frame)
    zbuf = jnp.concatenate([zpad, buf, zpad, zpad], axis=0)
    xin = jax.lax.dynamic_slice(zbuf, (start, jnp.int32(0)), (W, nch))
    s = xin.astype(jnp.float32) / jnp.float32(dpcm.MAXVAL[width])
    y = jax.lax.conv_general_dilated(
        s.T[:, None, :], jnp.asarray(K), window_strides=(M,),
        padding=[(0, 0)], precision=jax.lax.Precision.HIGHEST)
    y = y[:, :, :mcount].transpose(0, 2, 1).reshape(nch, -1).T
    from .effects import to_int_samples
    return to_int_samples(y, width), buf[buf.shape[0] - hmax:]


class StreamingHQResampler:
    """Chunked twin of ``hq_resample``: push arbitrary-size chunks, get
    windowed-sinc resampled output BIT-IDENTICAL to the offline op at
    every chunk size — same conv kernel, same per-output window, blocks
    padded to ``HQ_STREAM_BLOCK`` strides (see ``_hq_stream_kernel``) —
    with the signal staying on device.

    The output phase is a pure function of the global output index
    (``y[j]`` reads input anchor ``k0_j = (j*M + C) // L`` back through
    ``T`` taps — goldref.effects.hq_resample is the spec), so the host
    mirrors everything in exact integers: ``j`` (next output), ``n``
    (inputs fed).  A fixed ``hmax = (T-1) + M + C//L + 2`` device history
    ring bounds the carry — the derivation: the first un-emittable output
    has ``k0 >= n``, hence ``(j//L)*M >= n - C/L - M``, so the earliest
    input the next block can touch is ``(j//L)*M - (T-1) >= n - hmax``.

    Offline emits ``nframes_out`` rows, the last ~``C/(L*M)`` of which
    read zero-padded FUTURE input — call :meth:`flush` at end-of-stream
    to get that tail.

    >>> rs = StreamingHQResampler(44100, 48000, nchannels=2)
    >>> y, n = rs.push(chunk)     # y: [n, ch] device rows, globally contiguous
    >>> y, n = rs.flush()         # the zero-padded tail
    """

    def __init__(self, inrate: int, outrate: int, nchannels: int = 2,
                 dtype=jnp.int16):
        g = math.gcd(int(inrate), int(outrate))
        self.M, self.L = int(inrate) // g, int(outrate) // g
        if max(self.L, self.M) > HQ_MAX_FACTOR:
            raise ValueError(
                f"quality='hq' supports rational rate ratios up to "
                f"{HQ_MAX_FACTOR} after gcd reduction; "
                f"got {self.L}/{self.M}")
        _, PL, Kw = _hq_kernel(self.L, self.M)
        self._pl, self._kw = PL, Kw
        self._t = PL + 1                       # taps per leg
        self._c = (self._t * self.L - 1) // 2  # filter center
        self.hmax = PL + self.M + self._c // self.L + 2
        widths = {jnp.dtype(jnp.int8): 1, jnp.dtype(jnp.int16): 2,
                  jnp.dtype(jnp.int32): 4}
        if jnp.dtype(dtype) not in widths:
            raise ValueError(
                f"unsupported dtype {jnp.dtype(dtype).name!r}: the hq "
                "resampler operates on integer PCM samples "
                "(int8/int16/int32)")
        self.width = widths[jnp.dtype(dtype)]
        self.hist = jnp.zeros((self.hmax, nchannels), dtype)
        self.j = 0      # next global output index to emit
        self.n = 0      # global input frames consumed

    def _emittable(self, n_in: int) -> int:
        """Outputs [0, j_end) whose full window is inside the first
        ``n_in`` input frames: k0_j <= n_in - 1."""
        num = n_in * self.L - 1 - self._c
        return 0 if num < 0 else num // self.M + 1

    def total_out(self, n_in: int) -> int:
        """The offline output-length rule (nframes_out: (n-1)*L//M + 1)."""
        return nframes_out(n_in, self.M, self.L)

    def _block(self, chunk: jax.Array, j_end: int):
        jA = (self.j // self.L) * self.L       # leg-aligned block start
        mcount = -(-(j_end - jA) // self.L)
        n0 = self.n - int(chunk.shape[0])
        if mcount <= 0:
            # nothing to emit; still roll the history ring
            buf = jnp.concatenate([self.hist, chunk], axis=0)
            self.hist = buf[buf.shape[0] - self.hmax:]
            return self.hist[:0], 0
        # pad the block to the bit-identity floor (HQ_STREAM_BLOCK doc);
        # the padded rows read zero-flank future input and are discarded
        mcount = -(-mcount // HQ_STREAM_BLOCK) * HQ_STREAM_BLOCK
        istart = (jA // self.L) * self.M - self._pl
        assert istart >= n0 - self.hmax, "history ring bound violated"
        W = (mcount - 1) * self.M + self._kw
        start = istart - (n0 - self.hmax - W)
        # dynamic_slice CLAMPS an out-of-range start silently — prove the
        # padded window sits inside the zero-flanked concat instead
        assert 0 <= start and start + W <= 3 * W + self.hmax + \
            int(chunk.shape[0]), "hq stream window outside zero flanks"
        y, self.hist = _hq_stream_kernel(
            self.hist, chunk, jnp.int32(start), L=self.L, M=self.M,
            mcount=mcount, width=self.width, hmax=self.hmax)
        off, cnt = self.j - jA, j_end - self.j
        self.j = j_end
        return y[off:off + cnt], cnt

    def push(self, x: jax.Array):
        """x: [Lc, ch] device int array -> ([n, ch] device rows, n).
        Rows continue exactly where the previous push/flush ended."""
        self.n += int(x.shape[0])
        return self._block(x, max(self.j, self._emittable(self.n)))

    def flush(self):
        """Emit the zero-padded tail so the total row count equals the
        offline ``nframes_out`` rule.  Idempotent once drained."""
        empty = self.hist[:0]
        return self._block(empty, max(self.j, self.total_out(self.n)))
