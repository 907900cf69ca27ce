"""Golden-oracle PCM primitives (pure numpy, host-side).

This module is an independent, vectorized reimplementation of the exact
numeric semantics of CPython's C ``audioop`` module — the primitive layer
underneath the reference's ``synthplayer/sample.py`` ops (SURVEY.md §3.1
row 2 and §8).  Every function is cross-checked bit-exactly against the
local C ``audioop`` in ``tests/test_goldref_pcm.py``; the device ops in
``synthesizer_tpu.ops.pcm`` are in turn tested against *this* module, making
it the arbiter of the rebuild's 1-LSB / bit-exact contract.

Verified semantics reproduced here (SURVEY.md §8, re-measured on this host):

* ``add``      — element-wise int add, saturating at the width's range.
* ``mul``      — C-double multiply, **floor**, clamp (fbound semantics).
* ``tomono``   — ``floor(L*lf + R*rf)`` then clamp.
* ``tostereo`` — per-channel ``floor(v*f)`` then clamp.
* ``lin2lin``  — widen = left shift; narrow = **arithmetic** right shift
  (floors, does not round or truncate toward zero).
* ``bias``     — wrapping add (no clamp).
* ``ratecv``   — stateful DDA linear-interpolation resampler; the emission
  value is ``(int)((prev*d + cur*(R-d)) / R)`` computed in C double
  (truncation toward zero) in the 32-bit-scaled domain, then narrowed with
  an arithmetic shift.  State is ``(d, ((prev, cur),) * nchannels)``.
  Chunked invocation with carried state is bit-identical to whole-buffer
  invocation.
* ``max/minmax/avg/rms/maxpp/avgpp/cross`` — metering reductions with the
  exact floor/extreme-detection behavior of audioop.

Frames are raw little-endian interleaved PCM ``bytes``; widths 1, 2 and 4
are supported (the widths the reference uses).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

_DTYPES = {1: np.int8, 2: np.int16, 4: np.int32}
_MINVAL = {1: -(1 << 7), 2: -(1 << 15), 4: -(1 << 31)}
_MAXVAL = {1: (1 << 7) - 1, 2: (1 << 15) - 1, 4: (1 << 31) - 1}

RatecvState = Tuple[int, Tuple[Tuple[int, int], ...]]


def _check_width(width: int) -> None:
    if width not in _DTYPES:
        raise ValueError(f"unsupported sample width {width} (use 1, 2 or 4)")


def frombytes(fragment: bytes, width: int) -> np.ndarray:
    """Raw PCM bytes -> 1-D numpy array of the width's int dtype."""
    _check_width(width)
    if len(fragment) % width:
        raise ValueError("fragment length not a multiple of the sample width")
    return np.frombuffer(fragment, dtype=np.dtype(_DTYPES[width]).newbyteorder("<")).astype(
        _DTYPES[width], copy=False
    )


def tobytes(arr: np.ndarray, width: int) -> bytes:
    _check_width(width)
    return np.ascontiguousarray(arr.astype(_DTYPES[width], copy=False)).tobytes()


def _clamp(v: np.ndarray, width: int) -> np.ndarray:
    return np.clip(v, _MINVAL[width], _MAXVAL[width])


# ---------------------------------------------------------------------------
# Arithmetic primitives
# ---------------------------------------------------------------------------

def add(f1: bytes, f2: bytes, width: int) -> bytes:
    """Element-wise saturating add of two equal-length fragments."""
    a = frombytes(f1, width).astype(np.int64)
    b = frombytes(f2, width).astype(np.int64)
    if a.shape != b.shape:
        raise ValueError("fragments have different lengths")
    return tobytes(_clamp(a + b, width), width)


def mul(fragment: bytes, width: int, factor: float) -> bytes:
    """Scale by a float factor: C-double product, floor, clamp."""
    a = frombytes(fragment, width).astype(np.float64)
    return tobytes(_clamp(np.floor(a * float(factor)), width), width)


def mul_f32(fragment: bytes, width: int, factor: float) -> bytes:
    """float32-spec variant of :func:`mul` (the device contract).

    The rebuild's device ops compute float-factor scaling in IEEE float32
    on the device); this host twin uses numpy float32 so device-vs-oracle tests
    are bit-exact.  Differs from audioop's float64 path by at most 1 LSB.
    """
    a = frombytes(fragment, width).astype(np.float32)
    prod = a * np.float32(factor)
    return tobytes(_clamp(np.floor(prod).astype(np.float64), width), width)


def bias(fragment: bytes, width: int, b: int) -> bytes:
    """Add a constant with wrap-around (no clamping)."""
    a = frombytes(fragment, width)
    nbits = 8 * width
    v = (a.astype(np.int64) + int(b) - _MINVAL[width]) % (1 << nbits) + _MINVAL[width]
    return tobytes(v, width)


def lin2lin(fragment: bytes, width: int, newwidth: int) -> bytes:
    """Width conversion: widen by left shift, narrow by arithmetic right shift."""
    _check_width(newwidth)
    a = frombytes(fragment, width).astype(np.int64)
    v32 = a << (32 - 8 * width)           # GETSAMPLE32
    out = v32 >> (32 - 8 * newwidth)      # SETSAMPLE32 (arithmetic, floors)
    return tobytes(out, newwidth)


def tomono(fragment: bytes, width: int, lfactor: float, rfactor: float) -> bytes:
    """Stereo -> mono: floor(L*lf + R*rf), clamp."""
    a = frombytes(fragment, width).astype(np.float64)
    if a.size % 2:
        raise ValueError("stereo fragment has odd number of samples")
    l, r = a[0::2], a[1::2]
    return tobytes(_clamp(np.floor(l * float(lfactor) + r * float(rfactor)), width), width)


def tomono_f32(fragment: bytes, width: int, lfactor: float, rfactor: float) -> bytes:
    """float32-spec variant of :func:`tomono` (the device contract)."""
    a = frombytes(fragment, width).astype(np.float32)
    l, r = a[0::2], a[1::2]
    v = l * np.float32(lfactor) + r * np.float32(rfactor)
    return tobytes(_clamp(np.floor(v).astype(np.float64), width), width)


def tostereo(fragment: bytes, width: int, lfactor: float, rfactor: float) -> bytes:
    """Mono -> stereo: per-channel floor(v*f), clamp, interleave."""
    a = frombytes(fragment, width).astype(np.float64)
    out = np.empty(a.size * 2, dtype=np.float64)
    out[0::2] = np.floor(a * float(lfactor))
    out[1::2] = np.floor(a * float(rfactor))
    return tobytes(_clamp(out, width), width)


def tostereo_f32(fragment: bytes, width: int, lfactor: float, rfactor: float) -> bytes:
    """float32-spec variant of :func:`tostereo` (the device contract)."""
    a = frombytes(fragment, width).astype(np.float32)
    out = np.empty(a.size * 2, dtype=np.float64)
    out[0::2] = np.floor(a * np.float32(lfactor)).astype(np.float64)
    out[1::2] = np.floor(a * np.float32(rfactor)).astype(np.float64)
    return tobytes(_clamp(out, width), width)


def reverse(fragment: bytes, width: int) -> bytes:
    """Reverse the order of samples (note: samples, not frames)."""
    return tobytes(frombytes(fragment, width)[::-1], width)


# ---------------------------------------------------------------------------
# Metering reductions
# ---------------------------------------------------------------------------

def max_(fragment: bytes, width: int) -> int:
    a = frombytes(fragment, width)
    if a.size == 0:
        return 0
    return int(np.abs(a.astype(np.int64)).max())


def minmax(fragment: bytes, width: int) -> Tuple[int, int]:
    a = frombytes(fragment, width)
    if a.size == 0:
        return (0x7FFFFFFF, -0x80000000)
    return (int(a.min()), int(a.max()))


def avg(fragment: bytes, width: int) -> int:
    a = frombytes(fragment, width)
    if a.size == 0:
        return 0
    return int(math.floor(a.astype(np.float64).sum() / a.size))


def rms(fragment: bytes, width: int) -> int:
    a = frombytes(fragment, width).astype(np.float64)
    if a.size == 0:
        return 0
    return int(math.sqrt((a * a).sum() / a.size))


def cross(fragment: bytes, width: int) -> int:
    """Number of zero crossings (audioop counts the first sample too)."""
    a = frombytes(fragment, width)
    signs = (a < 0).astype(np.int8)
    ncross = -1
    prev = 17  # sentinel unequal to 0/1, as in audioop.c
    for s in signs:
        if s != prev:
            ncross += 1
            prev = int(s)
    return ncross


def _extremes(a: np.ndarray):
    """Yield successive confirmed extreme-to-extreme differences (audioop.c)."""
    if a.size == 0:
        return
    prevval = int(a[0])
    prevextreme_valid = False
    prevextreme = 0
    prevdiff = None
    for i in range(1, a.size):
        val = int(a[i])
        if val != prevval:
            diff = val < prevval
            if prevdiff == (not diff):
                if prevextreme_valid:
                    yield abs(prevval - prevextreme)
                prevextreme_valid = True
                prevextreme = prevval
            prevval = val
            prevdiff = diff


def maxpp(fragment: bytes, width: int) -> int:
    return max(_extremes(frombytes(fragment, width)), default=0)


def avgpp(fragment: bytes, width: int) -> int:
    diffs = list(_extremes(frombytes(fragment, width)))
    if not diffs:
        return 0
    return int(sum(float(d) for d in diffs) / len(diffs))


# ---------------------------------------------------------------------------
# ratecv — the stateful linear-interpolation resampler
# ---------------------------------------------------------------------------

def ratecv(
    fragment: bytes,
    width: int,
    nchannels: int,
    inrate: int,
    outrate: int,
    state: Optional[RatecvState],
) -> Tuple[bytes, RatecvState]:
    """Exact audioop.ratecv (weightA=1, weightB=0), vectorized.

    The DDA recurrence (verified on this host, SURVEY.md §8): rates are
    reduced by their gcd; the carried ``d`` starts at ``-outrate``; consuming
    an input frame does ``prev <- cur; cur <- x[i] (scaled to 32-bit)`` and
    ``d += outrate``; while ``d >= 0`` an output
    ``(int)((prev*d + cur*(outrate-d)) / outrate)`` is emitted (C-double
    division, truncation toward zero — exact in int64 here) and
    ``d -= inrate``.  Output samples are narrowed from the 32-bit domain with
    an arithmetic right shift.

    Closed form used below: with ``d0`` the incoming state and ``k`` the
    output index, output *k* is emitted after consuming
    ``i_k = ceil((k*inrate - d0) / outrate)`` frames, at
    ``d_k = d0 + i_k*outrate - k*inrate``; ``cur = x[i_k - 1]``,
    ``prev = x[i_k - 2]`` (indices -1/-2 resolve to the carried state).
    """
    _check_width(width)
    if nchannels < 1:
        raise ValueError("nchannels must be >= 1")
    if inrate <= 0 or outrate <= 0:
        raise ValueError("sampling rates must be > 0")
    g = math.gcd(inrate, outrate)
    inrate //= g
    outrate //= g

    a = frombytes(fragment, width)
    if a.size % nchannels:
        raise ValueError("fragment not a whole number of frames")
    nframes = a.size // nchannels
    x = a.reshape(nframes, nchannels).astype(np.int64) << (32 - 8 * width)

    if state is None:
        d0 = -outrate
        prev0 = np.zeros(nchannels, dtype=np.int64)
        cur0 = np.zeros(nchannels, dtype=np.int64)
    else:
        d0, chanstate = state
        if len(chanstate) != nchannels:
            raise ValueError("state does not match nchannels")
        prev0 = np.array([pc[0] for pc in chanstate], dtype=np.int64)
        cur0 = np.array([pc[1] for pc in chanstate], dtype=np.int64)

    # Number of outputs: k emitted iff i_k <= nframes  <=>  k*inrate <= L*outrate + d0
    kmax_num = nframes * outrate + d0
    nout = 0 if kmax_num < 0 else kmax_num // inrate + 1

    if nout > 0:
        k = np.arange(nout, dtype=np.int64)
        ik = -((d0 - k * inrate) // outrate)          # ceil((k*in - d0)/out)
        dk = d0 + ik * outrate - k * inrate
        cur_idx = ik - 1
        prev_idx = ik - 2
        cur = np.where(
            cur_idx[:, None] >= 0,
            x[np.clip(cur_idx, 0, max(nframes - 1, 0))],
            cur0[None, :],
        )
        prev = np.where(
            prev_idx[:, None] >= 0,
            x[np.clip(prev_idx, 0, max(nframes - 1, 0))],
            np.where(prev_idx[:, None] == -1, cur0[None, :], prev0[None, :]),
        )
        num = prev * dk[:, None] + cur * (outrate - dk[:, None])
        # C (int)(double/double): truncation toward zero; exact in int64 here.
        q = np.abs(num) // outrate
        y32 = np.where(num < 0, -q, q)
        y = (y32 >> (32 - 8 * width)).reshape(-1)
        out_bytes = tobytes(y, width)
    else:
        out_bytes = b""

    d_end = d0 + nframes * outrate - nout * inrate
    if nframes >= 2:
        prev_end = x[-2]
        cur_end = x[-1]
    elif nframes == 1:
        prev_end = cur0
        cur_end = x[-1]
    else:
        prev_end = prev0
        cur_end = cur0
    new_state: RatecvState = (
        int(d_end),
        tuple((int(p), int(c)) for p, c in zip(prev_end, cur_end)),
    )
    return out_bytes, new_state


def ratecv_nframes_out(nframes_in: int, inrate: int, outrate: int,
                       d0: Optional[int] = None) -> int:
    """Number of output frames ratecv will emit (for static shapes on device)."""
    g = math.gcd(inrate, outrate)
    inrate //= g
    outrate //= g
    if d0 is None:
        d0 = -outrate
    kmax_num = nframes_in * outrate + d0
    return 0 if kmax_num < 0 else kmax_num // inrate + 1
