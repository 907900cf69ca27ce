"""BS.1770-4 programme loudness (LUFS) and true peak (dBTP) on device.

Device/host split of the standard's pipeline:

* the HOT part — K-weighting (two biquads through the shared parallel
  companion-matrix scan, ``ops.effects.biquad_apply``), squaring, and the
  100 ms gating-hop energy sums — runs as ONE jitted device program over
  the whole signal;
* the data-dependent gating logic (absolute -70 LUFS gate, then the
  relative -10 LU gate) runs on HOST in f64 over the tiny [hops, ch]
  energy table — gating selects a varying subset of blocks, which would
  force dynamic shapes on device for microseconds of host work.

True peak follows BS.1770-4 Annex 2: the signal is 4x oversampled with a
polyphase interpolation FIR (``ops.coeffs.true_peak_filter``) — on device
this is one ``lax.conv_general_dilated`` with ``lhs_dilation=4`` (the
transposed-conv zero-stuffing, so the device sees a dense conv) — and the
true peak is the max |oversampled| (the sampled peak included: no
polyphase leg is an exact identity).

Channel weights are 1.0 (the pipeline's channel model is mono/stereo —
the standard's 1.41 surround weights have no surface here).  Oracle:
``goldref.effects.loudness_lufs`` / ``true_peak_dbtp`` (sequential f64).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from . import effects as dfx
from . import pcm as dpcm
from .coeffs import kweight_coeffs, true_peak_filter

__all__ = ["kweighted_hop_sums", "gated_loudness", "loudness_integrated",
           "true_peak_norm", "window_loudness", "loudness_range",
           "loudness_stats", "StreamingLoudness", "BLOCK_HOPS",
           "SHORT_TERM_HOPS", "ABS_GATE_LUFS", "REL_GATE_LU",
           "LRA_REL_GATE_LU", "LOUDNESS_OFFSET"]

#: 400 ms gating blocks at 75 % overlap = 4 hops of 100 ms
BLOCK_HOPS = 4
#: 3 s short-term windows = 30 hops (EBU R128 / Tech 3342)
SHORT_TERM_HOPS = 30
ABS_GATE_LUFS = -70.0
REL_GATE_LU = -10.0
#: the LRA relative gate is -20 LU (Tech 3342), not the -10 of BS.1770
LRA_REL_GATE_LU = -20.0
LOUDNESS_OFFSET = -0.691

_cache: dict = {}


def _cached(key, build):
    fn = _cache.get(key)
    if fn is None:
        fn = _cache[key] = build()
    return fn


def hop_frames(samplerate: int) -> int:
    return int(round(0.1 * samplerate))


def kweighted_hop_sums(x: jax.Array, samplerate: int) -> np.ndarray:
    """[hops, ch] f32 sums of squares of the K-weighted normalized signal
    over consecutive 100 ms hops (trailing partial hop dropped — the
    standard gates on full 400 ms blocks only)."""
    hop = hop_frames(samplerate)
    n, ch = x.shape
    th = n // hop
    if th == 0:
        return np.zeros((0, ch), np.float32)
    key = ("kw_hops", x.shape, str(x.dtype), samplerate)

    def build():
        s1, s2 = kweight_coeffs(samplerate)
        c1 = tuple(jnp.float32(c) for c in s1)
        c2 = tuple(jnp.float32(c) for c in s2)
        width = dpcm.width_of(x)

        @jax.jit
        def fn(x):
            s = (x[:th * hop].astype(jnp.float32)
                 / jnp.float32(dpcm.MAXVAL[width]))
            y, _ = dfx.biquad_apply(s, c1)
            y, _ = dfx.biquad_apply(y, c2)
            return (y * y).reshape(th, hop, ch).sum(axis=1)
        return fn

    return np.asarray(_cached(key, build)(x))


def gated_loudness(hop_sums: np.ndarray, hop: int) -> float:
    """Integrated loudness (LUFS) from per-hop K-weighted energy sums —
    the BS.1770-4 two-stage gating, host f64.  -inf when no block
    survives (silence, or programme shorter than one 400 ms block)."""
    hs = np.asarray(hop_sums, np.float64)
    nblocks = hs.shape[0] - (BLOCK_HOPS - 1)
    if nblocks <= 0:
        return float("-inf")
    block = BLOCK_HOPS * hop
    # z_j = channel-weighted mean square of gating block j (weights 1.0)
    zsum = sum(hs[k:k + nblocks] for k in range(BLOCK_HOPS)).sum(axis=1) \
        / block
    lj = LOUDNESS_OFFSET + 10.0 * np.log10(np.maximum(zsum, 1e-300))
    keep = lj > ABS_GATE_LUFS
    if not keep.any():
        return float("-inf")
    gamma = (LOUDNESS_OFFSET + 10.0 * np.log10(zsum[keep].mean())
             + REL_GATE_LU)
    keep &= lj > gamma
    if not keep.any():
        return float("-inf")
    return float(LOUDNESS_OFFSET + 10.0 * np.log10(zsum[keep].mean()))


def loudness_integrated(x: jax.Array, samplerate: int) -> float:
    """Integrated programme loudness of int PCM frames [n, ch], LUFS."""
    return gated_loudness(kweighted_hop_sums(x, samplerate),
                          hop_frames(samplerate))


def window_loudness(hop_sums: np.ndarray, hop: int,
                    window_hops: int) -> np.ndarray:
    """Per-position loudness (LUFS) of every full sliding window of
    ``window_hops`` hops — window_hops=4 gives the momentary (400 ms)
    meter values, 30 the short-term (3 s) ones; host f64."""
    hs = np.asarray(hop_sums, np.float64).sum(axis=1)
    n = hs.shape[0] - (window_hops - 1)
    if n <= 0:
        return np.zeros(0, np.float64)
    c = np.concatenate([[0.0], np.cumsum(hs)])
    z = (c[window_hops:] - c[:n]) / (window_hops * hop)
    return LOUDNESS_OFFSET + 10.0 * np.log10(np.maximum(z, 1e-300))


def loudness_range(hop_sums: np.ndarray, hop: int) -> float:
    """Loudness range (LRA, LU) per EBU Tech 3342: the p95 - p10 spread
    of the short-term (3 s) loudness distribution after an absolute
    -70 LUFS gate and a relative -20 LU gate.  0.0 when fewer than two
    windows survive (short or constant programmes)."""
    st = window_loudness(hop_sums, hop, SHORT_TERM_HOPS)
    st = st[st > ABS_GATE_LUFS]
    if st.size == 0:
        return 0.0
    # gate relative to the power mean of the absolute-gated values
    mean_lufs = 10.0 * np.log10(np.mean(10.0 ** (st / 10.0)))
    st = st[st > mean_lufs + LRA_REL_GATE_LU]
    if st.size < 2:
        return 0.0
    lo, hi = np.percentile(st, [10.0, 95.0])
    return float(hi - lo)


def loudness_stats(x: jax.Array, samplerate: int) -> dict:
    """One-pass EBU R128 meter set from a single device program:
    ``integrated`` (LUFS), ``lra`` (LU), ``momentary_max`` and
    ``short_term_max`` (LUFS; -inf when the programme is shorter than
    the respective window)."""
    hop = hop_frames(samplerate)
    hs = kweighted_hop_sums(x, samplerate)
    mom = window_loudness(hs, hop, BLOCK_HOPS)
    st = window_loudness(hs, hop, SHORT_TERM_HOPS)
    return dict(
        integrated=gated_loudness(hs, hop),
        lra=loudness_range(hs, hop),
        momentary_max=float(mom.max()) if mom.size else float("-inf"),
        short_term_max=float(st.max()) if st.size else float("-inf"),
    )


def _np_affine_scan2(u: np.ndarray, a1: float, a2: float,
                     y1: np.ndarray, y2: np.ndarray) -> np.ndarray:
    """Host-f64 twin of ``ops.effects.companion_scan`` for CONSTANT
    coefficients: y_n = u_n - a1 y_{n-1} - a2 y_{n-2} as a Hillis-Steele
    doubling scan (log2(n) vectorized numpy passes — no Python
    per-sample loop, so the realtime meter path never touches the
    device).  With a constant companion matrix M the combine matrix at
    doubling offset o is just M^o, shared by every position and channel.
    ``u`` is [n, ch]; ``y1``/``y2`` are [ch] initial state."""
    n, ch = u.shape
    M = np.array([[-a1, -a2], [1.0, 0.0]], np.float64)
    b = np.zeros((n, ch, 2), np.float64)
    b[:, :, 0] = u
    # fold the initial state into element 0:  s_0 = M s_{-1} + [u_0, 0]
    b[0, :, 0] += -a1 * y1 - a2 * y2
    b[0, :, 1] = y1
    off, Ap = 1, M
    while off < n:
        b[off:] += np.einsum("rs,mcs->mcr", Ap, b[:-off])
        Ap = Ap @ Ap
        off *= 2
    return b[:, :, 0]


def _np_biquad(s: np.ndarray, coeffs, state):
    """Host-f64 chunked biquad (feed-forward taps + the doubling scan)
    with carried (x1, x2, y1, y2) state — the realtime loudness meter's
    K-weighting stage.  Mirrors ``ops.effects.biquad_apply``."""
    b0, b1, b2, a1, a2 = (float(c) for c in coeffs)
    n, ch = s.shape
    x1, x2, y1, y2 = state
    xp1 = np.concatenate([x1[None], s[:-1]])
    if n >= 2:
        xp2 = np.concatenate([x2[None], x1[None], s[:-2]])
    else:
        xp2 = x2[None]
    u = b0 * s + b1 * xp1 + b2 * xp2
    y = _np_affine_scan2(u, a1, a2, y1, y2)
    new_state = (s[-1], s[-2] if n >= 2 else x1,
                 y[-1], y[-2] if n >= 2 else y1)
    return y, new_state


class StreamingLoudness:
    """LIVE EBU R128 meter: feed int PCM chunks of ANY size; exposes the
    running ``momentary`` (400 ms) and ``short_term`` (3 s) LUFS values,
    their maxima, and (via :meth:`stats`) the gated integrated loudness
    and LRA of everything heard so far — the chunk-fed twin of
    :func:`loudness_stats` (same hop grid, gating, and windows; spec
    goldref.effects.loudness_stats).

    Two feed paths share one hop accumulator:

    * :meth:`update` — device chunks: one jitted program (K-weighting
      biquads through the shared companion scan + squaring) and ONE host
      materialization per chunk; biquad state carries on device.
    * :meth:`update_host` — realtime host chunks (the mixer's buffers
      are already host memory): the same pipeline in f64 numpy via a
      log-depth doubling scan (``_np_affine_scan2``) — no device round
      trip, so no host sync enters the realtime audio path.

    State is ~30 hop energies + biquad taps: O(1) memory live, plus the
    (tiny, 10/s) full hop-sum history for integrated/LRA."""

    def __init__(self, samplerate: int, nchannels: int):
        self.samplerate = int(samplerate)
        self.nchannels = int(nchannels)
        self.hop = hop_frames(samplerate)
        self._c1, self._c2 = kweight_coeffs(samplerate)
        self._dev_state = None          # ((x1,x2,y1,y2), (…)) on device
        z = np.zeros(nchannels, np.float64)
        self._host_state = ((z, z, z, z), (z, z, z, z))
        self._resid = np.zeros(nchannels, np.float64)
        self._resid_n = 0
        self._hops: list = []           # completed [ch] f64 energy sums
        self.momentary = float("-inf")
        self.short_term = float("-inf")
        self.momentary_max = float("-inf")
        self.short_term_max = float("-inf")

    # -- device path --------------------------------------------------------
    def update(self, x: jax.Array):
        """Feed one device int chunk [n, ch]; returns
        (momentary, short_term) LUFS after this chunk."""
        n, ch = x.shape
        if ch != self.nchannels:
            raise ValueError(f"chunk has {ch} channels, meter was built "
                             f"for {self.nchannels}")
        if n == 0:
            return self.momentary, self.short_term
        key = ("live_kw", x.shape, str(x.dtype), self.samplerate)

        def build():
            c1 = tuple(jnp.float32(c) for c in self._c1)
            c2 = tuple(jnp.float32(c) for c in self._c2)
            width = dpcm.width_of(x)

            @jax.jit
            def fn(x, s1, s2):
                s = x.astype(jnp.float32) / jnp.float32(dpcm.MAXVAL[width])
                y, s1 = dfx.biquad_apply(s, c1, s1)
                y, s2 = dfx.biquad_apply(y, c2, s2)
                return y * y, s1, s2
            return fn

        s1, s2 = self._dev_state or (None, None)
        y2, s1, s2 = _cached(key, build)(x, s1, s2)
        self._dev_state = (s1, s2)
        self._accumulate(np.asarray(y2, np.float64))
        return self.momentary, self.short_term

    # -- host path -----------------------------------------------------------
    def update_host(self, frames: np.ndarray, maxvalue: float = 32767.0):
        """Feed one host int chunk [n, ch] (realtime mixer buffers);
        returns (momentary, short_term) LUFS after this chunk."""
        a = np.asarray(frames)
        if a.ndim == 1:
            a = a[:, None]
        if a.shape[1] != self.nchannels:
            raise ValueError(f"chunk has {a.shape[1]} channels, meter "
                             f"was built for {self.nchannels}")
        if len(a) == 0:
            return self.momentary, self.short_term
        s = a.astype(np.float64) / float(maxvalue)
        st1, st2 = self._host_state
        y, st1 = _np_biquad(s, self._c1, st1)
        y, st2 = _np_biquad(y, self._c2, st2)
        self._host_state = (st1, st2)
        self._accumulate(y * y)
        return self.momentary, self.short_term

    # -- shared hop accumulator ----------------------------------------------
    def _accumulate(self, y2: np.ndarray) -> None:
        n, ch = y2.shape
        t = self._resid_n
        if t + n < self.hop:                     # still inside one hop
            self._resid += y2.sum(axis=0)
            self._resid_n += n
            return
        k0 = self.hop - t
        self._hops.append(self._resid + y2[:k0].sum(axis=0))
        rest = y2[k0:]
        m = len(rest) // self.hop
        if m:
            mid = rest[: m * self.hop].reshape(m, self.hop, ch).sum(axis=1)
            self._hops.extend(mid)
        tail = rest[m * self.hop:]
        self._resid = tail.sum(axis=0)
        self._resid_n = len(tail)
        self._refresh()

    def _window_lufs(self, window_hops: int) -> float:
        if len(self._hops) < window_hops:
            return float("-inf")
        z = float(np.sum(self._hops[-window_hops:])) \
            / (window_hops * self.hop)
        return LOUDNESS_OFFSET + 10.0 * math.log10(max(z, 1e-300))

    def _refresh(self) -> None:
        self.momentary = self._window_lufs(BLOCK_HOPS)
        self.short_term = self._window_lufs(SHORT_TERM_HOPS)
        self.momentary_max = max(self.momentary_max, self.momentary)
        self.short_term_max = max(self.short_term_max, self.short_term)

    def stats(self) -> dict:
        """The R128 meter set over everything fed so far (same keys as
        :func:`loudness_stats`)."""
        hs = (np.asarray(self._hops, np.float64) if self._hops
              else np.zeros((0, self.nchannels)))
        return dict(
            integrated=gated_loudness(hs, self.hop),
            lra=loudness_range(hs, self.hop),
            momentary_max=self.momentary_max,
            short_term_max=self.short_term_max,
        )


def true_peak_norm(x: jax.Array) -> float:
    """max |4x-oversampled normalized signal| (linear; >= sampled peak).
    dBTP = 20*log10 of this."""
    n, ch = x.shape
    if n == 0:
        return 0.0
    key = ("true_peak", x.shape, str(x.dtype))

    def build():
        h = true_peak_filter()
        L = 4
        N = len(h)
        taps = jnp.asarray(h[::-1].copy(), jnp.float32)[None, None, :]
        width = dpcm.width_of(x)

        @jax.jit
        def fn(x):
            s = x.astype(jnp.float32) / jnp.float32(dpcm.MAXVAL[width])
            lhs = s.T[:, None, :]                       # [ch, 1, n]
            # precision=HIGHEST: at default precision a GPU may run this
            # f32 conv in TF32 (~2^-11 relative), enough to move the true
            # peak measurably (fx/true_peak in the battery checks it);
            # the polyphase FIR must run in full f32
            y = jax.lax.conv_general_dilated(
                lhs, taps, window_strides=(1,),
                padding=[(N - 1, N - 1)], lhs_dilation=(L,),
                precision=jax.lax.Precision.HIGHEST)
            return jnp.maximum(jnp.abs(y).max(), jnp.abs(s).max())
        return fn

    return float(np.asarray(_cached(key, build)(x)))
