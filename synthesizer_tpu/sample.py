"""Device-resident ``Sample`` PCM buffer and ``LevelMeter``.

Device-resident rebuild of the reference's ``synthplayer/sample.py`` (SURVEY.md
§3.1 rows 2-3): an immutable-metadata, rebindable-buffer PCM sample whose
~30 chainable ops run on an int array held in device memory.  The numeric
contract for every op is defined by ``goldref.sample.Sample`` and enforced
in ``tests/test_sample.py``.

**Lazy op capture.**  The reference's chainable API mutates eagerly; here
each op *stages* a node of a tiny IR instead, and the whole pending chain
compiles into ONE device program when the data is actually needed
(``get_frame_array`` / ``write_wav`` / mixing into another sample / …).
This is the graph-capture veneer SURVEY.md §7 calls for: users keep the
chainable API, the device sees a single fused program per chain shape
(compiled once, cached by structure), and a chain costs one dispatch
instead of one per op.  Even data-dependent scaling (``amplify_max``,
``make_16bit``) stages, because the peak factor is computed in-graph.

Shape/format metadata is tracked eagerly through staged ops, so
``nframes``/``duration``/format queries never force materialization.
"""

from __future__ import annotations

import math
from typing import Iterator, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import params
from .ops import pcm as dpcm
from .ops import resample as dresample
from .utils import wavio

_DTYPES = {1: jnp.int8, 2: jnp.int16, 4: jnp.int32}
_NPDT = {1: np.int8, 2: np.int16, 4: np.int32}
MAXVAL = dpcm.MAXVAL
MINVAL = dpcm.MINVAL

#: auto-materialize when a chain grows beyond this many staged ops
_MAX_PENDING = 160


class _Op(NamedTuple):
    name: str
    static: Tuple       # hashable static params
    ndyn: int           # f32 scalars consumed from the dyn vector
    nleaf: int          # leaf arrays consumed


# ---------------------------------------------------------------------------
# Staged-op executors.  Each runs inside the fused trace:
#   exec(x, static, dyn_scalars: list[f32 tracer], leaves: list[array]) -> x
# ---------------------------------------------------------------------------

def _x_amplify(x, st, dyn, leaves):
    return dpcm.mul_floor(x, dyn[0])


def _x_amplify_max(x, st, dyn, leaves):
    w = dpcm.width_of(x)
    pk = dpcm.peak(x)
    factor = jnp.where(pk == 0, jnp.float32(1.0),
                       jnp.float32(MAXVAL[w]) / pk.astype(jnp.float32))
    return dpcm.mul_floor(x, factor)


def _x_bias(x, st, dyn, leaves):
    return dpcm.bias_wrap(x, np.asarray(st[0]).astype(_NPDT[dpcm.width_of(x)]))


def _x_slice(x, st, dyn, leaves):
    a, b = st
    return x[a:b]


def _x_cut(x, st, dyn, leaves):
    a, b = st
    return jnp.concatenate([x[:a], x[b:]], axis=0)


def _x_pad(x, st, dyn, leaves):
    n, at_start = st
    z = jnp.zeros((n, x.shape[1]), x.dtype)
    return jnp.concatenate([z, x] if at_start else [x, z], axis=0)


def _x_join(x, st, dyn, leaves):
    other = _run_ops(leaves[0], st[0], dyn, leaves[1:])
    return jnp.concatenate([x, other], axis=0)


def _x_reverse(x, st, dyn, leaves):
    return x[::-1]


def _x_fadein(x, st, dyn, leaves):
    (n,) = st
    start = dyn[0]
    i = jnp.arange(n, dtype=jnp.float32)
    g = start + (jnp.float32(1.0) - start) * (i / jnp.float32(n))
    head = dpcm.gain_apply(x[:n], g[:, None])
    return jnp.concatenate([head, x[n:]], axis=0)


def _x_fadeout(x, st, dyn, leaves):
    (n, total) = st
    target = dyn[0]
    j = jnp.arange(n, dtype=jnp.float32)
    g = target + (jnp.float32(1.0) - target) * \
        ((jnp.float32(n) - jnp.float32(1.0) - j) / jnp.float32(n))
    tail = dpcm.gain_apply(x[total - n:], g[:, None])
    return jnp.concatenate([x[:total - n], tail], axis=0)


def _x_envelope(x, st, dyn, leaves):
    (n, samplerate) = st
    a = jnp.maximum(dyn[0], jnp.float32(0.0))
    d = jnp.maximum(dyn[1], jnp.float32(0.0))
    sl = dyn[2]
    r = jnp.maximum(dyn[3], jnp.float32(0.0))
    i = jnp.arange(n, dtype=jnp.float32)
    t = i / jnp.float32(samplerate)
    dur = jnp.float32(n / samplerate)
    eps = jnp.float32(1e-30)
    g = jnp.ones_like(t)
    g = jnp.where(a > 0, jnp.minimum(g, t / jnp.maximum(a, eps)), g)
    in_decay = (t >= a) & (t < a + d)
    g = jnp.where(in_decay, 1.0 + (sl - 1.0) * (t - a) / jnp.maximum(d, eps), g)
    g = jnp.where(t >= a + d, sl, g)
    in_rel = t >= dur - r
    rel_gain = jnp.where(r > 0, g * (dur - t) / jnp.maximum(r, eps), g)
    g = jnp.where(in_rel, rel_gain, g)
    return dpcm.gain_apply(x, jnp.maximum(g, 0.0)[:, None])


def _x_modulate(x, st, dyn, leaves):
    return dpcm.gain_apply(x, leaves[0][:, None])


def _x_modulate_sample(x, st, dyn, leaves):
    maxval, sub_ops = st
    mod = _run_ops(leaves[0], sub_ops, dyn, leaves[1:])
    g = mod[:, 0].astype(jnp.float32) / jnp.float32(maxval)
    n = x.shape[0]
    if g.shape[0] < n:
        g = jnp.concatenate([g, jnp.ones(n - g.shape[0], jnp.float32)])
    return dpcm.gain_apply(x, g[:n][:, None])


def _x_mix_at(x, st, dyn, leaves):
    start, m, out_len, sub_ops = st
    other = _run_ops(leaves[0], sub_ops, dyn, leaves[1:])[:m]
    cur = x.shape[0]
    if out_len > cur:
        x = jnp.concatenate(
            [x, jnp.zeros((out_len - cur, x.shape[1]), x.dtype)], axis=0)
    mixed = dpcm.sat_add(x[start:start + m], other)
    return jnp.concatenate([x[:start], mixed, x[start + m:]], axis=0)


def _x_echo(x, st, dyn, leaves):
    total, offsets = st                 # offsets: exact per-echo start frames
    decay = dyn[0]
    orig = x
    cur = x.shape[0]
    if total > cur:
        x = jnp.concatenate(
            [x, jnp.zeros((total - cur, x.shape[1]), x.dtype)], axis=0)
    else:
        x = x[:total]
    gain = jnp.float32(1.0)
    for dk in offsets:
        gain = gain * decay
        if dk >= total:
            continue
        m = min(orig.shape[0], total - dk)
        copy_k = dpcm.mul_floor(orig[:m], gain)
        mixed = dpcm.sat_add(x[dk:dk + m], copy_k)
        x = jnp.concatenate([x[:dk], mixed, x[dk + m:]], axis=0)
    return x


def _x_lin2lin(x, st, dyn, leaves):
    return dpcm.lin2lin(x, st[0])


def _x_astype_i32(x, st, dyn, leaves):
    return x.astype(jnp.int32)


def _x_tomono(x, st, dyn, leaves):
    return dpcm.to_mono(x, dyn[0], dyn[1])


def _x_tostereo(x, st, dyn, leaves):
    return dpcm.to_stereo(x, dyn[0], dyn[1])


def _x_stereo_mix(x, st, dyn, leaves):
    ch, m, sub_ops = st
    other = _run_ops(leaves[0], sub_ops, dyn[1:], leaves[1:])
    scaled = dpcm.mul_floor(other[:m, 0], dyn[0])
    mixed = dpcm.sat_add(x[:m, ch], scaled)
    return x.at[:m, ch].set(mixed)


def _x_pan_const(x, st, dyn, leaves):
    amount = dyn[0]
    la = jnp.minimum(jnp.float32(1.0), jnp.float32(1.0) - amount)
    ra = jnp.minimum(jnp.float32(1.0), jnp.float32(1.0) + amount)
    return dpcm.gain_apply(x, jnp.stack([jnp.broadcast_to(la, (x.shape[0],)),
                                         jnp.broadcast_to(ra, (x.shape[0],))],
                                        axis=-1))


def _x_pan_lfo(x, st, dyn, leaves):
    amt = leaves[0]
    la = jnp.minimum(jnp.float32(1.0), jnp.float32(1.0) - amt)
    ra = jnp.minimum(jnp.float32(1.0), jnp.float32(1.0) + amt)
    return dpcm.gain_apply(x, jnp.stack([la, ra], axis=-1))


def _x_gen_patch(x, st, dyn, leaves):
    """Generate a Sample's data from an oscillator patch spec in-trace.

    This is how WaveSynth renders stage lazily: the patch scan + int
    quantization fuse into whatever program consumes the sample, so e.g. a
    16-track mixdown of synthesized tracks is ONE device dispatch total."""
    node, n, sr, width, blocksize = st
    from .models import graph as G
    vals = G.patch_values(node, n, sr, blocksize)
    return G.to_int_device(vals, width)[:, None]


def _x_modulate_patch(x, st, dyn, leaves):
    node, n, sr = st
    from .models import graph as G
    g = G.patch_values(node, n, sr)
    return dpcm.gain_apply(x, g[:, None])


def _x_pan_patch(x, st, dyn, leaves):
    node, n, sr = st
    from .models import graph as G
    amt = G.patch_values(node, n, sr)
    la = jnp.minimum(jnp.float32(1.0), jnp.float32(1.0) - amt)
    ra = jnp.minimum(jnp.float32(1.0), jnp.float32(1.0) + amt)
    return dpcm.gain_apply(x, jnp.stack([la, ra], axis=-1))


def _x_pan_sample(x, st, dyn, leaves):
    maxval, n, sub_ops = st
    mod = _run_ops(leaves[0], sub_ops, dyn, leaves[1:])
    amt = mod[:, 0].astype(jnp.float32) / jnp.float32(maxval)
    if amt.shape[0] < n:
        amt = jnp.concatenate([amt, jnp.ones(n - amt.shape[0], jnp.float32)])
    amt = amt[:n]
    la = jnp.minimum(jnp.float32(1.0), jnp.float32(1.0) - amt)
    ra = jnp.minimum(jnp.float32(1.0), jnp.float32(1.0) + amt)
    return dpcm.gain_apply(x, jnp.stack([la, ra], axis=-1))


def _x_tremolo(x, st, dyn, leaves):
    from .ops import effects as dfx
    return dfx.tremolo(x, leaves[0])


def _x_autopan(x, st, dyn, leaves):
    from .ops import effects as dfx
    return dfx.autopan(x, leaves[0])


def _x_compress(x, st, dyn, leaves):
    from .ops import effects as dfx
    # st = (has_knee,) — a STATIC flag so the hard-knee program's
    # arithmetic is untouched when knee_db == 0 (the knee value itself
    # stays dyn: tweaking a nonzero knee does not recompile)
    knee = dyn[5] if st and st[0] else None
    g = dfx.compressor_gains_from_coeffs(x, dyn[0], dyn[1], dyn[2], dyn[3],
                                         knee=knee)
    return dpcm.gain_apply(x, (g * dyn[4])[:, None])


def _x_compress_sc(x, st, dyn, leaves):
    """Sidechain compression: the detector listens to the fused key
    sub-program; the gain applies to x (goldref.effects.sidechain_level)."""
    key_maxval, sub_ops, has_knee = st
    nk = 6 if has_knee else 5
    key = _run_ops(leaves[0], sub_ops, dyn[nk:], leaves[1:])
    from .ops import effects as dfx
    a = jnp.max(jnp.abs(key.astype(jnp.float32)
                        / jnp.float32(key_maxval)), axis=1)
    n = x.shape[0]
    if a.shape[0] >= n:
        a = a[:n]
    else:
        a = jnp.concatenate([a, jnp.zeros(n - a.shape[0], jnp.float32)])
    g = dfx.compressor_gains_from_level(a, dyn[0], dyn[1], dyn[2], dyn[3],
                                        knee=dyn[5] if has_knee else None)
    return dpcm.gain_apply(x, (g * dyn[4])[:, None])


def _x_reverb(x, st, dyn, leaves):
    samplerate, tail_frames = st
    from .ops import effects as dfx
    return dfx.reverb_from_params(x, samplerate, dyn[0], dyn[1], dyn[2],
                                  dyn[3], dyn[4], tail_frames)


def _x_chorus(x, st, dyn, leaves):
    samplerate, rate, depth, delay, voices = st
    from .ops import effects as dfx
    return dfx.chorus(x, samplerate, rate, depth, delay, voices,
                      dyn[0], dyn[1])


def _x_biquad(x, st, dyn, leaves):
    from .ops import effects as dfx
    w = dpcm.width_of(x)
    s = x.astype(jnp.float32) / jnp.float32(MAXVAL[w])
    y, _ = dfx.biquad_apply(s, tuple(dyn[:5]))
    return dfx.to_int_samples(y, w)


def _x_biquad_ff(x, st, dyn, leaves):
    # badly-conditioned coefficients (ops.coeffs.wants_ff_scan): the
    # float-float scan with (hi, lo) coefficient pairs in the dyn vector
    from .ops import effects as dfx
    w = dpcm.width_of(x)
    s = x.astype(jnp.float32) / jnp.float32(MAXVAL[w])
    pairs = tuple((dyn[2 * i], dyn[2 * i + 1]) for i in range(5))
    y, _ = dfx.biquad_apply_ff(s, pairs)
    return dfx.to_int_samples(y, w)


def _x_gate(x, st, dyn, leaves):
    from .ops import effects as dfx
    g = dfx.gate_gains_from_coeffs(x, dyn[0], dyn[1], dyn[2], dyn[3],
                                   e0=0.0, z0=dyn[1])
    return dpcm.gain_apply(x, g[:, None])


def _x_convolve(x, st, dyn, leaves):
    ir_maxval, sub_ops = st
    from .ops import effects as dfx
    ir_int = _run_ops(leaves[0], sub_ops, dyn[2:], leaves[1:])
    ir_norm = ir_int.astype(jnp.float32) / jnp.float32(ir_maxval)
    return dfx.convolve(x, ir_norm, dyn[0], dyn[1])


def _x_granulate(x, st, dyn, leaves):
    samplerate, duration, grain, density, jitter, seed = st
    from .ops import effects as dfx
    return dfx.granulate(x, samplerate, duration, grain, density, jitter,
                         dyn[0], seed)


def _x_stretch(x, st, dyn, leaves):
    factor, frame, hop = st
    from .ops import effects as dfx
    return dfx.stretch(x, factor, frame, hop)


def _x_fb_echo(x, st, dyn, leaves):
    D, tail_frames = st
    from .ops import effects as dfx
    return dfx.feedback_echo(x, D, dyn[0], dyn[1], dyn[2], tail_frames)


def _x_width(x, st, dyn, leaves):
    from .ops import effects as dfx
    return dfx.stereo_width(x, dyn[0])


def _x_limit(x, st, dyn, leaves):
    samplerate, L, cint = st
    from .ops import effects as dfx
    return dfx.limiter(x, dyn[0], dyn[1], L, cint)


def _x_phaser(x, st, dyn, leaves):
    stages, ff = st
    from .ops import effects as dfx
    w = dpcm.width_of(x)
    s = x.astype(jnp.float32) / jnp.float32(MAXVAL[w])
    if ff:
        grids = tuple((leaves[2 * i], leaves[2 * i + 1]) for i in range(5))
        z = jnp.zeros(x.shape[1], jnp.float32)
        states = tuple((z, z, z, z, z, z) for _ in range(stages))
    else:
        grids = tuple(leaves)
        z = jnp.zeros(x.shape[1], jnp.float32)
        states = tuple((z, z, z, z) for _ in range(stages))
    y, _ = dfx.phaser_apply(s, grids, states, ff)
    out = dyn[1] * s + dyn[0] * y
    return dfx.to_int_samples(out, w)


def _x_ratecv(x, st, dyn, leaves):
    inr, outr, nout = st
    nch = x.shape[1]
    zeros = jnp.zeros((nch,), x.dtype)
    y, _, _ = dresample._ratecv_kernel(x, zeros, zeros, inr=inr, outr=outr,
                                       d0=-outr, nout=nout)
    return y


def _x_hq_resample(x, st, dyn, leaves):
    L, M, nout = st
    return dresample.hq_resample(x, L, M, nout)


_EXEC = {
    "amplify": _x_amplify, "amplify_max": _x_amplify_max, "bias": _x_bias,
    "slice": _x_slice, "cut": _x_cut, "pad": _x_pad, "join": _x_join,
    "reverse": _x_reverse, "fadein": _x_fadein, "fadeout": _x_fadeout,
    "envelope": _x_envelope, "modulate": _x_modulate,
    "modulate_sample": _x_modulate_sample, "mix_at": _x_mix_at,
    "echo": _x_echo, "lin2lin": _x_lin2lin, "astype_i32": _x_astype_i32,
    "tomono": _x_tomono, "tostereo": _x_tostereo, "stereo_mix": _x_stereo_mix,
    "pan_const": _x_pan_const, "pan_lfo": _x_pan_lfo, "ratecv": _x_ratecv,
    "hq_resample": _x_hq_resample,
    "gen_patch": _x_gen_patch, "modulate_patch": _x_modulate_patch,
    "pan_patch": _x_pan_patch, "pan_sample": _x_pan_sample,
    "compress": _x_compress, "reverb": _x_reverb, "chorus": _x_chorus,
    "convolve": _x_convolve, "stretch": _x_stretch,
    "biquad": _x_biquad, "biquad_ff": _x_biquad_ff,
    "gate": _x_gate, "compress_sc": _x_compress_sc,
    "granulate": _x_granulate,
    "fb_echo": _x_fb_echo, "width": _x_width, "limit": _x_limit,
    "phaser": _x_phaser, "tremolo": _x_tremolo, "autopan": _x_autopan,
}

_program_cache: dict = {}
_empty_cache: dict = {}


def _empty_base(nchannels: int, samplewidth: int) -> jax.Array:
    """Shared zero-frame device array (immutable) — saves a fresh
    device-put per Sample construction."""
    key = (nchannels, samplewidth)
    arr = _empty_cache.get(key)
    if arr is None:
        arr = jnp.zeros((0, nchannels), _DTYPES[samplewidth])
        _empty_cache[key] = arr
    return arr


def _run_ops(x, ops: Tuple[_Op, ...], dyn, leaves):
    """Execute a (sub-)program inside the fused trace.

    ``dyn``/``leaves`` are flat sequences consumed in op order — sub-programs
    (a mixed-in sample's own staged chain) nest recursively via an op's
    trailing dyn/leaf slices.
    """
    di = li = 0
    for op in ops:
        d = [dyn[di + j] for j in range(op.ndyn)]
        lv = [leaves[li + j] for j in range(op.nleaf)]
        x = _EXEC[op.name](x, op.static, d, lv)
        di += op.ndyn
        li += op.nleaf
    return x


def _compile_program(key, ops: Tuple[_Op, ...]):
    fn = _program_cache.get(key)
    if fn is None:
        def run(base, dyn_vec, leaves):
            return _run_ops(base, ops, dyn_vec, leaves)
        fn = jax.jit(run)
        _program_cache[key] = fn
    return fn


class Sample:
    """A device-resident PCM sample with chainable, lazily-fused DSP ops.

    API-compatible with the reference's ``Sample`` (SURVEY.md §3.2): ops
    mutate in place and return ``self`` for chaining.  Internally each op
    stages an IR node; the chain compiles to one device program on demand
    (see module docstring).
    """

    def __init__(self, wave_file=None, name: str = ""):
        self.name = name
        self._ops: List[_Op] = []
        self._dyn: List[float] = []
        self._leaves: List[jax.Array] = []
        self._host_cache: Optional[np.ndarray] = None
        self._host_base: Optional[jax.Array] = None
        if wave_file is not None:
            frames, rate, width, nch = wavio.read_wav(wave_file)
            self._base = jnp.asarray(frames)
            self._samplerate = rate
            self._samplewidth = width
            self._nchannels = nch
            self._nframes = frames.shape[0]
            if isinstance(wave_file, str) and not name:
                self.name = wave_file
        else:
            self._base = _empty_base(params.norm_nchannels,
                                     params.norm_samplewidth)
            self._samplerate = params.norm_samplerate
            self._samplewidth = params.norm_samplewidth
            self._nchannels = params.norm_nchannels
            self._nframes = 0

    # -- staging machinery -----------------------------------------------------

    def _stage(self, name: str, static: Tuple = (), dyn: Tuple = (),
               leaves: Tuple = ()) -> None:
        self._ops.append(_Op(name, static, len(dyn), len(leaves)))
        self._dyn.extend(float(d) for d in dyn)
        self._leaves.extend(leaves)
        if len(self._ops) > _MAX_PENDING:
            self._materialize()

    def _materialize(self) -> jax.Array:
        if self._ops:
            from .utils import profiling
            ops = tuple(self._ops)
            key = (ops, self._base.shape, str(self._base.dtype),
                   tuple((l.shape, str(l.dtype)) for l in self._leaves))
            fn = _compile_program(key, ops)
            dyn_vec = jnp.asarray(np.asarray(self._dyn, np.float32))
            self._base = fn(self._base, dyn_vec, tuple(self._leaves))
            profiling.record_program_launch()
            self._ops, self._dyn, self._leaves = [], [], []
        return self._base

    def _as_subprogram(self):
        """(sub_ops, dyn, leaves) for fusing this sample into another's
        program without materializing it (very long chains materialize
        first to bound compile sizes)."""
        if len(self._ops) > 48:
            self._materialize()
        return (tuple(self._ops), tuple(self._dyn),
                (self._base, *self._leaves))

    # -- constructors ------------------------------------------------------------

    @classmethod
    def from_raw_frames(cls, frames: bytes, samplewidth: int, samplerate: int,
                        nchannels: int, name: str = "") -> "Sample":
        s = cls(name=name)
        a = np.frombuffer(frames, dtype=_NPDT[samplewidth]).reshape(-1, nchannels)
        s._base = _empty_base(nchannels, samplewidth) if a.shape[0] == 0 \
            else jnp.asarray(a)
        s._samplerate, s._samplewidth, s._nchannels = samplerate, samplewidth, nchannels
        s._nframes = a.shape[0]
        return s

    @classmethod
    def from_array(cls, array, samplerate: int, nchannels: int,
                   name: str = "") -> "Sample":
        """From a sequence of ints (int16 range) or floats in [-1, 1]."""
        a = np.asarray(array)
        if a.dtype.kind == "f":
            a = np.clip(np.rint(a * 32767.0), -32768, 32767).astype(np.int16)
        elif a.dtype != np.int16:
            a = a.astype(np.int16)
        return cls.from_raw_frames(a.tobytes(), 2, samplerate, nchannels, name)

    @classmethod
    def from_patch(cls, node, nframes: int, samplerate: int,
                   samplewidth: int, name: str = "",
                   blocksize: int = 8192) -> "Sample":
        """A mono Sample whose data is a *staged* oscillator-patch render.

        Nothing runs at construction: the patch scan is an IR node like any
        other op, so downstream chains (and cross-sample mixes) fuse the
        synthesis itself into one device program."""
        s = cls(name=name)
        s._base = _empty_base(1, samplewidth)
        s._samplerate, s._samplewidth, s._nchannels = \
            int(samplerate), int(samplewidth), 1
        s._nframes = 0
        s._stage("gen_patch", static=(node, int(nframes), int(samplerate),
                                      int(samplewidth), int(blocksize)))
        s._nframes = int(nframes)
        return s

    @classmethod
    def from_jax(cls, data: jax.Array, samplerate: int, samplewidth: int,
                 name: str = "") -> "Sample":
        """Wrap an existing on-device [n, ch] int array (no copy)."""
        s = cls(name=name)
        assert data.ndim == 2 and data.dtype == _DTYPES[samplewidth]
        s._base = data
        s._samplerate, s._samplewidth = samplerate, samplewidth
        s._nchannels = int(data.shape[1])
        s._nframes = int(data.shape[0])
        return s

    def _replace_frames(self, data: jax.Array) -> "Sample":
        """Swap in new device frames of the same format, in place (used by
        the eager fx-automation path, which computes outside the lazy IR).
        Any staged ops must already be materialized by the caller."""
        assert not self._ops and data.ndim == 2 \
            and data.dtype == _DTYPES[self._samplewidth]
        self._base = data
        self._nchannels = int(data.shape[1])
        self._nframes = int(data.shape[0])
        return self

    def copy(self) -> "Sample":
        s = Sample(name=self.name)
        s._base = self._base          # jax arrays are immutable
        s._ops = list(self._ops)
        s._dyn = list(self._dyn)
        s._leaves = list(self._leaves)
        s._samplerate, s._samplewidth, s._nchannels, s._nframes = \
            self._samplerate, self._samplewidth, self._nchannels, self._nframes
        return s

    dup = copy

    # -- introspection (never materializes) ---------------------------------------

    @property
    def samplerate(self) -> int:
        return self._samplerate

    @samplerate.setter
    def samplerate(self, rate: int) -> None:
        """Change the rate metadata only (alters pitch/duration)."""
        assert rate > 0
        self._samplerate = int(rate)

    @property
    def samplewidth(self) -> int:
        return self._samplewidth

    @property
    def nchannels(self) -> int:
        return self._nchannels

    @property
    def nframes(self) -> int:
        return self._nframes

    @property
    def duration(self) -> float:
        return self._nframes / self._samplerate

    @property
    def maxvalue(self) -> int:
        return MAXVAL[self._samplewidth]

    @property
    def jax_frames(self) -> jax.Array:
        """The on-device [nframes, nchannels] int array (materializes)."""
        return self._materialize()

    def __len__(self) -> int:
        return self._nframes

    def __repr__(self) -> str:
        pending = f" +{len(self._ops)} staged" if self._ops else ""
        return (f"<Sample '{self.name}' {self.duration:.3f}s "
                f"{self._samplerate}Hz {8 * self._samplewidth}bit "
                f"{self._nchannels}ch{pending}>")

    def __eq__(self, other) -> bool:
        if not isinstance(other, Sample):
            return NotImplemented
        return (self._samplerate, self._samplewidth, self._nchannels) == \
               (other._samplerate, other._samplewidth, other._nchannels) and \
               self._nframes == other._nframes and \
               bool(jnp.array_equal(self._materialize(), other._materialize()))

    def view_frame_data(self) -> bytes:
        """Raw interleaved little-endian frame bytes (device -> host copy)."""
        return np.asarray(self._materialize()).astype(_NPDT[self._samplewidth]).tobytes()

    def get_frame_array(self) -> np.ndarray:
        """Frames as a host numpy array [nframes, nchannels].

        The host copy is cached per materialized buffer (device arrays are
        immutable, so it stays valid until the next staged op rebinds the
        base) — repeated calls cost zero device syncs (the sequencer
        compiles its instrument bank from these on every mix/stream
        call).  The
        returned array is read-only; copy before writing."""
        base = self._materialize()
        if self._host_cache is not None and self._host_base is base:
            return self._host_cache
        a = np.asarray(base)
        a.setflags(write=False)
        self._host_cache, self._host_base = a, base
        return a

    def _n(self, seconds: float) -> int:
        return int(seconds * self._samplerate)

    # -- WAV I/O --------------------------------------------------------------------

    def write_wav(self, file) -> "Sample":
        wavio.write_wav(file, self.get_frame_array(), self._samplerate,
                        self._samplewidth, self._nchannels)
        return self

    def write_flac(self, file) -> "Sample":
        """Write the sample losslessly as FLAC (utils.flac encoder —
        fixed predictors + native Rice coding; decode is bit-identical)."""
        from .utils.flac import write_flac
        write_flac(file, self.get_frame_array(), self._samplerate,
                   self._samplewidth, self._nchannels)
        return self

    def _frames_16bit(self) -> np.ndarray:
        """int16 frame array for the lossy encoders (width-converted
        through the product's own make_16bit semantics, self untouched)."""
        if self._samplewidth == 2:
            return self.get_frame_array()
        return self.copy().make_16bit(
            maximize_amplitude=False).get_frame_array()

    def write_mp3(self, file, bitrate: int = 192) -> "Sample":
        """Encode to MP3 (CBR kbps, LAME info tag for gapless decode)
        via the system libmp3lame binding (utils.codecs).  Lossy: the
        sample is width-converted to 16-bit for the encoder."""
        from .utils.codecs import write_mp3
        write_mp3(file, self._frames_16bit(), self._samplerate,
                  self._nchannels, bitrate=bitrate)
        return self

    def write_ogg(self, file, quality: float = 0.4) -> "Sample":
        """Encode to Ogg Vorbis (VBR quality -0.1..1.0) via the system
        libvorbisenc binding (utils.codecs).  Lossy: 16-bit input."""
        from .utils.codecs import write_vorbis
        write_vorbis(file, self._frames_16bit(), self._samplerate,
                     self._nchannels, quality=quality)
        return self

    def write_opus(self, file, bitrate: int = 128000) -> "Sample":
        """Encode to Ogg Opus via the system libopus binding
        (utils.codecs; the Ogg mux is ours).  Opus encodes only at
        8/12/16/24/48 kHz — other rates resample a COPY to 48 kHz with
        the product's exact ratecv first (self untouched)."""
        from .utils.codecs import write_opus
        smp = self
        if self._samplerate not in (8000, 12000, 16000, 24000, 48000):
            smp = self.copy().resample(48000)
        write_opus(file, smp._frames_16bit(), smp._samplerate,
                   smp._nchannels, bitrate=bitrate)
        return self

    def write_m4a(self, file, bitrate: int = 128000) -> "Sample":
        """Encode to AAC in MP4 (.m4a) — or raw ADTS when the name ends
        in .aac — via the libav shim (utils.libav).  Lossy: 16-bit."""
        import os
        from .utils.libav import write_with_libav
        write_with_libav(os.fspath(file), self._frames_16bit(),
                         self._samplerate, self._nchannels,
                         bitrate=bitrate)
        return self

    def write_audio(self, file) -> "Sample":
        """Write WAV, FLAC, MP3, Ogg Vorbis, Opus, or AAC/M4A, chosen by
        the filename extension (lossy formats need the system codec
        libraries)."""
        import os as _os
        name = _os.fspath(file) if isinstance(file, (str, _os.PathLike)) \
            else None
        if isinstance(name, str):
            lower = name.lower()
            if lower.endswith(".flac"):
                return self.write_flac(name)
            if lower.endswith(".mp3"):
                return self.write_mp3(name)
            if lower.endswith((".ogg", ".oga")):
                return self.write_ogg(name)
            if lower.endswith(".opus"):
                return self.write_opus(name)
            if lower.endswith((".m4a", ".aac")):
                return self.write_m4a(name)
        return self.write_wav(name if name is not None else file)

    # -- scaling -----------------------------------------------------------------------

    def amplify(self, factor: float) -> "Sample":
        """floor(f32(v) * f32(factor)), clamp (audioop.mul, f32 spec)."""
        self._stage("amplify", dyn=(factor,))
        return self

    def amplify_max(self) -> "Sample":
        """Amplify to full scale; the f32 factor maxval/peak is computed
        in-graph on device (stages without a host sync)."""
        self._stage("amplify_max")
        return self

    def invert(self) -> "Sample":
        return self.amplify(-1.0)

    def bias(self, amount: int) -> "Sample":
        """Wrapping DC offset (audioop.bias)."""
        self._stage("bias", static=(int(amount),))
        return self

    # -- arrangement ----------------------------------------------------------------------

    def clip(self, start_seconds: float, end_seconds: float) -> "Sample":
        a = min(self._n(start_seconds), self._nframes)
        b = min(max(self._n(end_seconds), a), self._nframes)
        self._stage("slice", static=(a, b))
        self._nframes = b - a
        return self

    def cut(self, start_seconds: float, end_seconds: float) -> "Sample":
        a = min(self._n(start_seconds), self._nframes)
        b = min(max(self._n(end_seconds), a), self._nframes)
        self._stage("cut", static=(a, b))
        self._nframes -= (b - a)
        return self

    def split(self, seconds: float) -> "Sample":
        n = min(self._n(seconds), self._nframes)
        tail = self.copy()
        tail._stage("slice", static=(n, tail._nframes))
        tail._nframes = self._nframes - n
        self._stage("slice", static=(0, n))
        self._nframes = n
        return tail

    def add_silence(self, seconds: float, at_start: bool = False) -> "Sample":
        n = self._n(seconds)
        self._stage("pad", static=(n, bool(at_start)))
        self._nframes += n
        return self

    def pad_frames(self, nframes: int, at_start: bool = False) -> "Sample":
        """Frame-precise silence padding (no seconds round-trip)."""
        if nframes > 0:
            self._stage("pad", static=(int(nframes), bool(at_start)))
            self._nframes += int(nframes)
        return self

    def truncate_frames(self, nframes: int) -> "Sample":
        """Keep only the first ``nframes`` frames (frame-precise clip)."""
        n = min(int(nframes), self._nframes)
        self._stage("slice", static=(0, n))
        self._nframes = n
        return self

    def join(self, other: "Sample") -> "Sample":
        self._check_format(other)
        sub_ops, dyn, leaves = other._as_subprogram()
        self._stage("join", static=(sub_ops,), dyn=dyn, leaves=leaves)
        self._nframes += other._nframes
        return self

    def reverse(self) -> "Sample":
        self._stage("reverse")
        return self

    def delay(self, seconds: float, keep_length: bool = False) -> "Sample":
        n = self._n(abs(seconds))
        if seconds >= 0:
            self.add_silence(abs(seconds), at_start=True)
            if keep_length and n > 0:
                end = max(self._nframes - n, 0)
                self._stage("slice", static=(0, end))
                self._nframes = end
        else:
            n = min(n, self._nframes)
            self._stage("slice", static=(n, self._nframes))
            self._nframes -= n
            if keep_length:
                self.add_silence(abs(seconds))
        return self

    # -- fades & envelopes ---------------------------------------------------------------

    def fadein(self, seconds: float, start_volume: float = 0.0) -> "Sample":
        n = min(self._n(seconds), self._nframes)
        if n > 0:
            self._stage("fadein", static=(n,), dyn=(start_volume,))
        return self

    def fadeout(self, seconds: float, target_volume: float = 0.0) -> "Sample":
        n = min(self._n(seconds), self._nframes)
        if n > 0:
            self._stage("fadeout", static=(n, self._nframes), dyn=(target_volume,))
        return self

    def envelope(self, attack: float, decay: float, sustainlevel: float,
                 release: float) -> "Sample":
        """ADSR gain curve over the whole buffer (goldref.sample.adsr_gains)."""
        self._stage("envelope", static=(self._nframes, self._samplerate),
                    dyn=(attack, decay, sustainlevel, release))
        return self

    def modulate_amp(self, modulator) -> "Sample":
        """Per-sample amplitude modulation by a Sample, f32 array, or an
        object exposing ``gains(n)`` (oscillators).  A Sample modulator's
        own staged chain fuses in as a sub-program."""
        if isinstance(modulator, Sample):
            sub_ops, dyn, leaves = modulator._as_subprogram()
            self._stage("modulate_sample",
                        static=(MAXVAL[modulator._samplewidth], sub_ops),
                        dyn=dyn, leaves=leaves)
            return self
        if hasattr(modulator, "spec"):   # Oscillator: stage the patch render
            from .models import spec as _spec
            if _spec.has_host_source(modulator.spec):
                # user-oscillator LFO: the host source cannot inline into
                # the fused scan — materialize its gains NOW via the
                # hybrid per-block loop and stage the array (one staged
                # buffer; the rest of the chain still fuses)
                g = np.asarray(modulator.gains(self._nframes),
                               np.float32)
                self._stage("modulate", leaves=(jnp.asarray(g),))
                return self
            self._stage("modulate_patch",
                        static=(modulator.spec, self._nframes,
                                modulator.samplerate))
            return self
        g = _modulator_gains(modulator, self._nframes)
        self._stage("modulate", leaves=(g,))
        return self

    # -- mixing -------------------------------------------------------------------------------

    def mix(self, other: "Sample", other_seconds: Optional[float] = None,
            pad_shortest: bool = True) -> "Sample":
        return self.mix_at(0.0, other, other_seconds, pad_shortest=pad_shortest)

    def mix_at(self, seconds: float, other: "Sample",
               other_seconds: Optional[float] = None,
               pad_shortest: bool = True) -> "Sample":
        """Saturating add of ``other`` at a frame offset (the trackmixer hot
        loop, SURVEY.md §4.2) — staged, and ``other``'s own pending chain is
        fused in as a sub-program, so a whole multi-track mixdown of staged
        samples compiles to ONE device program."""
        self._check_format(other)
        if seconds < 0:
            raise ValueError("mix_at offset must be >= 0")
        m = other._nframes
        if other_seconds is not None:
            m = min(m, other._n(other_seconds))
        start = self._n(seconds)
        if start + m > self._nframes and not pad_shortest:
            m = max(0, self._nframes - start)
        if m == 0:
            return self
        out_len = max(self._nframes, start + m)
        sub_ops, dyn, leaves = other._as_subprogram()
        self._stage("mix_at", static=(start, m, out_len, sub_ops),
                    dyn=dyn, leaves=leaves)
        self._nframes = out_len
        return self

    def echo(self, length: float, amount: int, delay: float, decay: float) -> "Sample":
        """Feed-forward echo (spec: goldref.sample.Sample.echo).  Per-echo
        offsets are rounded from seconds individually (int(k*delay*sr)),
        matching the oracle's per-copy mix_at exactly."""
        total = self._n(length)
        offsets = tuple(self._n(k * delay) for k in range(1, int(amount) + 1))
        self._stage("echo", static=(total, offsets), dyn=(decay,))
        self._nframes = total
        return self

    # -- effects rack (beyond-reference; contract: goldref.effects) -------------------------------

    def compress(self, threshold_db: float = -20.0, ratio: float = 4.0,
                 attack: float = 0.005, release: float = 0.1,
                 makeup_db: float = 0.0, knee_db: float = 0.0,
                 sidechain: Optional["Sample"] = None) -> "Sample":
        """Peak compressor / limiter (``ratio=math.inf``).  The detector and
        attack smoother run as log-depth associative scans on device
        (ops.effects); spec/tolerance: goldref.effects.compressor_gains.
        Knobs travel in the dyn vector, so tweaking them reuses the compiled
        program.

        ``knee_db`` > 0 softens the static curve's corner over a
        knee_db-wide dB window (second-order knee, value+slope continuous
        — goldref.effects._static_curve_db_f32); 0 keeps the hard knee
        bit-identically (a static program flag, so toggling recompiles
        but tweaking a nonzero knee does not).

        With ``sidechain`` the detector listens to the KEY sample (classic
        ducking — a kick keyed against a bass); the key's own staged chain
        fuses in as a sub-program.  Past the key's end the envelope decays
        and the gain releases back to 1."""
        from .ops.coeffs import compressor_coeffs
        alpha, decay = compressor_coeffs(self._samplerate, attack, release)
        slope = 1.0 if math.isinf(ratio) else 1.0 - 1.0 / ratio
        makeup = float(np.exp2(np.float32(makeup_db) / np.float32(6.0206)))
        if not 0.0 <= knee_db <= 24.0:
            raise ValueError("compress knee_db must be in [0, 24]")
        has_knee = knee_db > 0.0
        knobs = (threshold_db, slope, alpha, decay, makeup)
        if has_knee:
            knobs = knobs + (knee_db,)
        if sidechain is None:
            self._stage("compress", static=(has_knee,), dyn=knobs)
            return self
        if sidechain._samplerate != self._samplerate:
            raise ValueError("sidechain samplerate mismatch")
        sub_ops, dyn, leaves = sidechain._as_subprogram()
        self._stage("compress_sc",
                    static=(MAXVAL[sidechain._samplewidth], sub_ops,
                            has_knee),
                    dyn=knobs + dyn, leaves=leaves)
        return self

    def reverb(self, roomsize: float = 0.7, damping: float = 0.5,
               wet: float = 0.33, dry: float = 0.7, width: float = 1.0,
               tail: float = 1.5) -> "Sample":
        """Freeverb-style reverb (gather-free lag-aligned comb scan on
        device, see ops.effects); extends the sample by ``tail`` seconds
        of decay.  Spec/tolerance: goldref.effects.reverb.  Knobs are dyn
        — no recompile on tweak."""
        from .ops.coeffs import reverb_params
        feedback, damp, wet1, wet2 = reverb_params(roomsize, damping, wet,
                                                   width)
        tail_frames = self._n(tail)
        self._stage("reverb", static=(self._samplerate, tail_frames),
                    dyn=(feedback, damp, wet1, wet2, dry))
        self._nframes += tail_frames
        return self

    def chorus(self, rate: float = 0.5, depth: float = 0.002,
               delay: float = 0.02, voices: int = 3, wet: float = 0.4,
               dry: float = 1.0) -> "Sample":
        """Multi-voice chorus (LFO-modulated fractional delays).
        Spec/tolerance: goldref.effects.chorus.  ``rate`` is static (its
        DDS increment needs the host's exact f64 round);
        ``depth``/``delay`` are static too since round 5 — the host
        block-plans the banded gather-free form from them
        (ops.effects.chorus, 12x the pair-gather's throughput on chip;
        a depth/delay tweak recompiles, wet/dry stay dyn)."""
        self._stage("chorus", static=(self._samplerate, float(rate),
                                      float(depth), float(delay),
                                      int(voices)),
                    dyn=(wet, dry))
        return self

    def filter(self, kind: str, cutoff: float, q: float = 0.7071,
               gain_db: float = 0.0) -> "Sample":
        """Resonant RBJ biquad on the PCM (parallel companion-matrix scan
        on device — ops.effects.companion_scan); spec/tolerance:
        goldref.effects.biquad_filter.  Kinds: lowpass/highpass/bandpass,
        plus the gain kinds lowshelf/highshelf/peaking (``gain_db`` boosts
        or cuts; spec goldref.effects.eq).  Coefficients travel in the dyn
        vector, so knob tweaks reuse the compiled program."""
        from .ops.coeffs import biquad_coeffs, eq_band_coeffs
        if kind in ("lowshelf", "highshelf", "peaking"):
            coeffs = eq_band_coeffs(kind, cutoff, gain_db, q,
                                    self._samplerate)
        else:
            coeffs = biquad_coeffs(kind, cutoff, q, self._samplerate)
        self._stage_biquad(coeffs)
        return self

    def _stage_biquad(self, coeffs) -> None:
        """Stage one biquad, routed by conditioning: badly-conditioned
        coefficient sets (near-unit poles — low shelves, high-Q low
        cutoffs; ops.coeffs.wants_ff_scan) run the compensated
        float-float scan with (hi, lo) pairs in the dyn vector (~1 LSB
        of the f64 oracle where the plain scan drifts tens-to-thousands
        of LSB); the rest keep the plain scan.  The streaming twin
        (effects.StreamingBiquad) makes the identical decision from the
        identical f64 coefficients."""
        from .ops.coeffs import ff_split, wants_ff_scan
        if wants_ff_scan(coeffs):
            self._stage("biquad_ff",
                        dyn=tuple(float(v) for c in coeffs
                                  for v in ff_split(c)))
        else:
            self._stage("biquad", dyn=coeffs)

    def eq(self, low_db: float = 0.0, mid_db: float = 0.0,
           high_db: float = 0.0, low_freq: float = 120.0,
           mid_freq: float = 1000.0, mid_q: float = 1.0,
           high_freq: float = 8000.0) -> "Sample":
        """Three-band parametric EQ: low shelf at ``low_freq``, peaking
        mid at ``(mid_freq, mid_q)``, high shelf at ``high_freq``.  Each
        NONZERO band stages one RBJ biquad (the parallel companion scan),
        identical to chaining ``filter()`` calls; zero-gain bands stage
        nothing (a unity band would still drift the f32 scan by an LSB).
        Spec/tolerance: goldref.effects.eq."""
        from .ops.coeffs import eq_band_coeffs
        for kind, f, g, q in (("lowshelf", low_freq, low_db, 0.7071),
                              ("peaking", mid_freq, mid_db, mid_q),
                              ("highshelf", high_freq, high_db, 0.7071)):
            if g != 0.0:
                self._stage_biquad(eq_band_coeffs(kind, f, g, q,
                                                  self._samplerate))
        return self

    def loudness_lufs(self) -> float:
        """Integrated programme loudness (LUFS, ITU-R BS.1770-4):
        K-weighted 400 ms gating-block energies as one device program,
        the two-stage gate on host f64 (ops/loudness.py).  -inf for
        silence or programmes shorter than one 400 ms block.
        Spec/tolerance: goldref.effects.loudness_lufs."""
        from .ops import loudness as dl
        return dl.loudness_integrated(self.jax_frames, self._samplerate)

    def loudness_stats(self) -> dict:
        """The EBU R128 meter set in one device pass: ``integrated``
        (LUFS), ``lra`` (loudness range, LU, EBU Tech 3342),
        ``momentary_max`` (400 ms) and ``short_term_max`` (3 s) LUFS
        maxima.  Spec/tolerance: goldref.effects.loudness_stats."""
        from .ops import loudness as dl
        return dl.loudness_stats(self.jax_frames, self._samplerate)

    def true_peak_dbtp(self) -> float:
        """True peak (dBTP, BS.1770-4 Annex 2): 4x polyphase
        oversampling as one device transposed-conv; -inf for silence.
        Spec/tolerance: goldref.effects.true_peak_dbtp."""
        from .ops import loudness as dl
        tp = dl.true_peak_norm(self.jax_frames)
        return float("-inf") if tp <= 0.0 else 20.0 * math.log10(tp)

    def normalize_lufs(self, target_lufs: float = -14.0,
                       true_peak_db: float = -1.0) -> "Sample":
        """Loudness-normalize to a streaming target (default -14 LUFS,
        the common platform spec): gain = target - measured, capped so
        the predicted true peak stays <= ``true_peak_db`` dBTP — the
        EBU R128 mastering workflow.  Measures eagerly (two device
        reductions), then stages one ``amplify`` (f32-factor contract).
        Silence is returned unchanged."""
        from .ops import loudness as dl
        li = dl.loudness_integrated(self.jax_frames, self._samplerate)
        if not math.isfinite(li):
            return self
        gain_db = target_lufs - li
        tp = dl.true_peak_norm(self.jax_frames)
        if tp > 0.0:
            gain_db = min(gain_db,
                          true_peak_db - 20.0 * math.log10(tp))
        return self.amplify(float(10.0 ** (gain_db / 20.0)))

    def gate(self, threshold_db: float = -50.0, range_db: float = 80.0,
             attack: float = 0.001, release: float = 0.05) -> "Sample":
        """Noise gate (decaying-max detector + one-pole smoother as
        parallel scans); spec/tolerance: goldref.effects.gate_gains."""
        from .ops.coeffs import gate_coeffs
        alpha, decay, floor_gain = gate_coeffs(self._samplerate, attack,
                                               release, range_db)
        self._stage("gate", dyn=(threshold_db, floor_gain, alpha, decay))
        return self

    def feedback_echo(self, delay: float, feedback: float = 0.4,
                      wet: float = 0.5, dry: float = 1.0,
                      tail: Optional[float] = None) -> "Sample":
        """Feedback delay line — the chain generalization of the
        reference's feed-forward :meth:`echo` (an infinite geometric echo
        train: first echo at ``delay`` seconds with amplitude ``wet``,
        k-th at k*delay with wet*feedback^(k-1)).  Extends the sample by
        the decay room (``tail`` seconds, or the 1-LSB rule of
        ops.coeffs.echo_tail_frames).  The recurrence runs blockwise on
        device (ops.effects.feedback_echo_core — identical per-element
        arithmetic to the oracle); spec/budget:
        goldref.effects.feedback_echo."""
        from .ops.coeffs import echo_tail_frames
        if not 0.0 <= feedback <= 0.95:
            raise ValueError("feedback must be in [0, 0.95]")
        D = max(1, self._n(delay))
        tail_frames = echo_tail_frames(self._samplerate, delay, feedback,
                                       wet, tail)
        self._stage("fb_echo", static=(D, tail_frames),
                    dyn=(feedback, wet, dry))
        self._nframes += tail_frames
        return self

    def tremolo(self, rate: float = 5.0, depth: float = 0.5,
                start_frame: int = 0) -> "Sample":
        """LFO amplitude modulation: per-frame gains in [1-depth, 1]
        from the house integer-DDS sine LFO, derived on host at absolute
        frames [start_frame, ...) (ops.coeffs.tremolo_gain_grid), so
        offline == streaming == seek by construction.  Spec/budget:
        goldref.effects.tremolo (<= 1 LSB)."""
        from .ops.coeffs import static_phase, tremolo_gain_grid
        if not 0.0 <= depth <= 1.0:
            raise ValueError("tremolo depth must be in [0, 1]")
        if not 0.0 < rate <= 20.0:
            raise ValueError("tremolo rate must be in (0, 20] Hz")
        P = static_phase(int(start_frame), self._nframes,
                         self._samplerate, rate)
        g = jnp.asarray(tremolo_gain_grid(P, depth))
        self._stage("tremolo", leaves=(g,))
        return self

    def autopan(self, rate: float = 0.5, depth: float = 1.0,
                start_frame: int = 0) -> "Sample":
        """LFO auto-panner: per-frame pan positions depth*sin through
        the house equal-gain pan law (the voice-bank law), host-derived
        at absolute frames (ops.coeffs.autopan_pan_grid).  Stereo only.
        Spec/budget: goldref.effects.autopan (<= 1 LSB)."""
        from .ops.coeffs import autopan_pan_grid, static_phase
        if self._nchannels != 2:
            raise ValueError("autopan needs a stereo sample")
        if not 0.0 <= depth <= 1.0:
            raise ValueError("autopan depth must be in [0, 1]")
        if not 0.0 < rate <= 20.0:
            raise ValueError("autopan rate must be in (0, 20] Hz")
        P = static_phase(int(start_frame), self._nframes,
                         self._samplerate, rate)
        pan = jnp.asarray(autopan_pan_grid(P, depth))
        self._stage("autopan", leaves=(pan,))
        return self

    def stereo_width(self, amount: float) -> "Sample":
        """Mid/side stereo-width control (0 = mono, 1 = unity,
        up to 4 = wider).  Spec/budget: goldref.effects.stereo_width."""
        if self._nchannels != 2:
            raise ValueError("stereo_width needs a stereo sample")
        if not 0.0 <= amount <= 4.0:
            raise ValueError("width amount must be in [0, 4]")
        self._stage("width", dyn=(amount,))
        return self

    def limit(self, ceiling_db: float = -1.0, release: float = 0.05,
              lookahead: float = 0.005) -> "Sample":
        """Lookahead brickwall limiter: the gain starts dipping
        ``lookahead`` seconds before a peak (sliding window max +
        box attack ramp, both reduce_window ops), releases as an
        associative decaying max in dB, and a hard integer clamp at the
        ceiling guarantees true brickwall.  Length preserved.
        Spec/tolerance: goldref.effects.limiter_gains."""
        from .ops.coeffs import compressor_coeffs, limiter_ceiling
        if not -60.0 <= ceiling_db <= 0.0:
            raise ValueError("limiter ceiling_db must be in [-60, 0]")
        L = max(1, self._n(lookahead))
        decay = compressor_coeffs(self._samplerate, 0.0, release)[1]
        cint = limiter_ceiling(ceiling_db, self._samplewidth)
        self._stage("limit", static=(self._samplerate, L, cint),
                    dyn=(ceiling_db, decay))
        return self

    def phaser(self, rate: float = 0.5, depth: float = 1.0,
               min_freq: float = 300.0, max_freq: float = 3000.0,
               stages: int = 4, q: float = 0.7071, wet: float = 0.5,
               dry: float = 1.0) -> "Sample":
        """LFO-swept allpass cascade: ``stages`` identical RBJ allpasses
        sweep exponentially between ``min_freq`` and ``max_freq`` under
        the house integer-DDS LFO; the per-frame coefficient grids are
        host-derived at absolute frames (ops.coeffs.phaser_coeff_grids)
        so offline == streaming by construction.  Sweep floors below
        ~120 Hz route through the compensated float-float scan
        (ops.coeffs.phaser_wants_ff).  Spec/budget:
        goldref.effects.phaser."""
        from .ops.coeffs import (ff_split, phaser_coeff_grids,
                                 phaser_wants_ff)
        if not 1 <= int(stages) <= 12:
            raise ValueError("phaser stages must be in [1, 12]")
        if min_freq < 30.0 or max_freq <= min_freq:
            raise ValueError("phaser needs 30 <= min_freq < max_freq")
        ff = phaser_wants_ff(min_freq)
        grids = phaser_coeff_grids(
            0, self._nframes, self._samplerate, rate, depth, min_freq,
            max_freq, q, dtype=np.float64 if ff else np.float32)
        if ff:
            leaves = tuple(jnp.asarray(part) for g in grids
                           for part in ff_split(g))
        else:
            leaves = tuple(jnp.asarray(g) for g in grids)
        self._stage("phaser", static=(int(stages), ff), dyn=(wet, dry),
                    leaves=leaves)
        return self

    def convolve(self, ir: "Sample", wet: float = 1.0,
                 dry: float = 0.0) -> "Sample":
        """Convolve with an impulse-response sample (f32 FFT product on
        device; mono IR applies to all channels); extends by len(ir)-1
        frames.  The IR's own staged chain fuses in as a sub-program.
        Spec/tolerance: goldref.effects.convolve."""
        if ir._samplerate != self._samplerate:
            raise ValueError("impulse response samplerate mismatch")
        if ir._nchannels not in (1, self._nchannels):
            raise ValueError("impulse response channel mismatch")
        if ir._nframes == 0:
            raise ValueError("empty impulse response")
        sub_ops, dyn, leaves = ir._as_subprogram()
        self._stage("convolve", static=(MAXVAL[ir._samplewidth], sub_ops),
                    dyn=(wet, dry) + dyn, leaves=leaves)
        self._nframes += ir._nframes - 1
        return self

    def granulate(self, duration: float, grain: float = 0.05,
                  density: float = 25.0, jitter: float = 0.02,
                  amplitude: float = 0.7, seed: int = 0) -> "Sample":
        """Granular resynthesis onto a ``duration``-second canvas (one
        gather + one scatter-add on device); spec/tolerance:
        goldref.effects.granulate.  Position/jitter params are static (the
        grain grid is host-computed, jitter from the house counter hash)."""
        from .ops.coeffs import grain_grid
        _, _, _, out_len = grain_grid(self._nframes, self._samplerate,
                                      duration, grain, density, jitter, seed)
        self._stage("granulate",
                    static=(self._samplerate, float(duration), float(grain),
                            float(density), float(jitter), int(seed)),
                    dyn=(amplitude,))
        self._nframes = out_len
        return self

    def stretch(self, factor: float, frame: int = 2048,
                hop: int = 512) -> "Sample":
        """Phase-vocoder time stretch (duration x factor, pitch kept) —
        batched device FFTs + parallel phase cumsum (ops.effects.stretch);
        spec/tolerance: goldref.effects.stretch.  ``factor`` is static
        (the analysis grid is host-computed)."""
        from .ops.coeffs import stretch_grid
        _, target = stretch_grid(self._nframes, factor, frame, hop)
        self._stage("stretch", static=(float(factor), int(frame), int(hop)))
        self._nframes = target
        return self

    def pitch_shift(self, semitones: float, frame: int = 2048,
                    hop: int = 512, quality: str = "linear") -> "Sample":
        """Shift pitch by equal-tempered semitones, duration preserved:
        stretch(r) + speed(r), r = 2**(semitones/12) (goldref twin is the
        same composition).  ``quality='hq'`` routes the speed leg through
        the windowed-sinc polyphase resampler instead of linear
        interpolation (the linear leg's -6 dB/oct image rolloff is
        audible on upward shifts); default stays the exact bit-identical
        composition."""
        r = 2.0 ** (semitones / 12.0)
        return self.stretch(r, frame, hop).speed(r, quality=quality)

    # -- format conversion -----------------------------------------------------------------------

    def make_32bit(self, scale_amplitude: bool = True) -> "Sample":
        if self._samplewidth == 4:
            return self
        self._stage("lin2lin" if scale_amplitude else "astype_i32",
                    static=(4,) if scale_amplitude else ())
        self._samplewidth = 4
        return self

    def make_16bit(self, maximize_amplitude: bool = True) -> "Sample":
        if maximize_amplitude:
            self.amplify_max()
        if self._samplewidth != 2:
            self._stage("lin2lin", static=(2,))
            self._samplewidth = 2
        return self

    def resample(self, samplerate: int, quality: str = "linear") -> "Sample":
        """Resample to a new rate (pitch preserved).

        quality='linear' (default) is the reference's exact audioop
        ratecv interpolator, bit-exact; quality='hq' is the windowed-sinc
        polyphase resampler — ONE strided f32 convolution on device
        (ops.resample.hq_resample; spec + <=1 LSB budget vs the f64
        oracle: goldref.effects.hq_resample) with the SAME output length,
        ~80 dB stopband instead of linear interpolation's -6 dB/oct
        image rolloff."""
        if samplerate == self._samplerate:
            return self
        if quality == "hq":
            self._hq_resample(self._samplerate, samplerate)
        elif quality == "linear":
            self._ratecv(self._samplerate, samplerate)
        else:
            raise ValueError(f"unknown resample quality {quality!r}")
        self._samplerate = samplerate
        return self

    def speed(self, speed: float, quality: str = "linear") -> "Sample":
        """Change playback speed (and pitch), keeping the samplerate meta.

        quality='hq' snaps the speed ratio to the nearest rational with
        both terms <= ops.resample.HQ_MAX_FACTOR (continued-fraction best
        approximation — micro-cents of pitch error in the musical range,
        bounded in tests/test_hq_resample.py; smaller than this method's
        own ``int(samplerate*speed)`` truncation that the linear leg has
        always applied), because the polyphase filter bank is L phases of
        a K-tap sinc; arbitrary-precision ratios would need an unbounded
        bank.  Spec twin: goldref.sample.Sample.speed."""
        if speed == 1.0:
            return self
        if quality == "hq":
            self._hq_resample(int(self._samplerate * speed),
                              self._samplerate, snap=True)
        elif quality == "linear":
            self._ratecv(int(self._samplerate * speed), self._samplerate)
        else:
            raise ValueError(f"unknown resample quality {quality!r}")
        return self

    def _hq_resample(self, inrate: int, outrate: int,
                     snap: bool = False) -> None:
        g = math.gcd(inrate, outrate)
        M, L = inrate // g, outrate // g
        if max(L, M) > dresample.HQ_MAX_FACTOR:
            if not snap:
                # resample(quality='hq') keeps exactness: named-rate
                # conversions (44100<->48000 etc.) always reduce; an
                # irreducible pair is a caller error, not a snap case
                raise ValueError(
                    f"quality='hq' supports rational rate ratios up to "
                    f"{dresample.HQ_MAX_FACTOR} after gcd reduction; "
                    f"got {L}/{M}")
            L, M = dresample.bounded_ratio(outrate, inrate)
        nout = dresample.nframes_out(self._nframes, M, L)
        self._stage("hq_resample", static=(L, M, nout))
        self._nframes = nout

    def _ratecv(self, inrate: int, outrate: int) -> None:
        g = math.gcd(inrate, outrate)
        inr, outr = inrate // g, outrate // g
        nout = dresample.nframes_out(self._nframes, inr, outr)
        if self._nframes < (1 << 30) // max(inr, outr):
            self._stage("ratecv", static=(inr, outr, nout))
        else:
            # huge inputs: the segmented device wrapper keeps k*inr and
            # i*outr inside int32 (still exact, still on device)
            y, _ = dresample.resample(np.asarray(self._materialize()),
                                      inr, outr, width=self._samplewidth)
            self._base = jnp.asarray(y)
        self._nframes = nout

    def mono(self, left_factor: float = 1.0, right_factor: float = 1.0) -> "Sample":
        if self._nchannels == 1:
            return self
        self._stage("tomono", dyn=(left_factor, right_factor))
        self._nchannels = 1
        return self

    def stereo(self, left_factor: float = 1.0, right_factor: float = 1.0) -> "Sample":
        if self._nchannels == 2:
            return self
        self._stage("tostereo", dyn=(left_factor, right_factor))
        self._nchannels = 2
        return self

    def stereo_mix(self, other: "Sample", other_channel: str,
                   other_mix_factor: float = 1.0) -> "Sample":
        assert other_channel in ("L", "R") and other._nchannels == 1
        if self._nchannels == 1:
            self.stereo()
        ch = 0 if other_channel == "L" else 1
        m = min(self._nframes, other._nframes)
        sub_ops, dyn, leaves = other._as_subprogram()
        self._stage("stereo_mix", static=(ch, m, sub_ops),
                    dyn=(other_mix_factor,) + dyn, leaves=leaves)
        return self

    def pan(self, amount: float = 0.0, lfo=None) -> "Sample":
        if self._nchannels == 1:
            self.stereo()
        if lfo is None:
            self._stage("pan_const", dyn=(amount,))
        elif hasattr(lfo, "spec"):       # Oscillator: stage the patch render
            self._stage("pan_patch",
                        static=(lfo.spec, self._nframes, lfo.samplerate))
        elif isinstance(lfo, Sample):    # Sample LFO fuses as a sub-program
            sub_ops, dyn, leaves = lfo._as_subprogram()
            self._stage("pan_sample",
                        static=(MAXVAL[lfo._samplewidth], self._nframes,
                                sub_ops),
                        dyn=dyn, leaves=leaves)
        else:
            amt = _modulator_gains(lfo, self._nframes)
            self._stage("pan_lfo", leaves=(amt,))
        return self

    # -- chunking -------------------------------------------------------------------------------------

    def chunked_frame_data(self, chunksize_frames: int,
                           repeat: bool = False) -> Iterator[bytes]:
        """Yield raw frame bytes chunk by chunk (host copies of device data)."""
        host = self.get_frame_array()
        n = len(host)
        if repeat:
            if n == 0:
                raise ValueError("cannot repeat an empty sample")
            i = 0
            while True:
                idx = np.arange(i, i + chunksize_frames) % max(n, 1)
                yield host[idx].astype(_NPDT[self._samplewidth]).tobytes()
                i = (i + chunksize_frames) % max(n, 1)
        else:
            for i in range(0, n, chunksize_frames):
                yield host[i:i + chunksize_frames].astype(_NPDT[self._samplewidth]).tobytes()

    # -- misc ------------------------------------------------------------------------------------------

    def normalize(self) -> "Sample":
        """Convert to the global normalization targets (params module)."""
        self.resample(params.norm_samplerate)
        if self._samplewidth != params.norm_samplewidth:
            if params.norm_samplewidth == 2:
                self.make_16bit(maximize_amplitude=False)
            else:
                self._stage("lin2lin", static=(params.norm_samplewidth,))
                self._samplewidth = params.norm_samplewidth
        if self._nchannels == 1 and params.norm_nchannels == 2:
            self.stereo()
        elif self._nchannels == 2 and params.norm_nchannels == 1:
            self.mono()
        return self

    def _check_format(self, other: "Sample") -> None:
        if (other._samplerate, other._samplewidth, other._nchannels) != \
                (self._samplerate, self._samplewidth, self._nchannels):
            raise ValueError(
                f"sample format mismatch: {other!r} vs {self!r}")


def _modulator_gains(modulator, n: int) -> jax.Array:
    if isinstance(modulator, Sample):
        g = modulator.jax_frames[:, 0].astype(jnp.float32) / jnp.float32(
            MAXVAL[modulator.samplewidth])
    elif hasattr(modulator, "gains"):
        g = jnp.asarray(modulator.gains(n), dtype=jnp.float32)
    else:
        g = jnp.asarray(np.asarray(modulator, dtype=np.float32))
    if g.shape[0] < n:
        g = jnp.concatenate([g, jnp.ones(n - g.shape[0], jnp.float32)])
    return g[:n]


class LevelMeter:
    """Peak / RMS dB level meter with decay (VU meter).

    Rebuild of the reference's ``LevelMeter`` (SURVEY.md §3.1 row 3): call
    :meth:`update` once per chunk; levels are in dB relative to full scale,
    floored at ``lowest``.  The level decays at 30 dB/s between updates and
    the peak markers hold for 0.4 s before falling.  The per-chunk
    peak/RMS reductions run on device (``ops.pcm.vu_levels``).
    """

    DECAY_DB_PER_SEC = 30.0
    PEAK_HOLD_SEC = 0.4

    def __init__(self, rms_mode: bool = False, lowest: float = -60.0,
                 loudness: bool = False):
        """``loudness=True`` adds a LIVE EBU R128 readout: ``momentary``
        / ``short_term`` LUFS (and their maxima) track every chunk fed
        through :meth:`update` / :meth:`update_frames`, via
        ``ops.loudness.StreamingLoudness`` (device chunks run one jitted
        K-weight program; realtime host chunks use the f64 numpy
        doubling scan, no device round trip)."""
        assert lowest < 0
        self.rms_mode = rms_mode
        self.lowest = float(lowest)
        self.level_left = self.level_right = lowest
        self.peak_left = self.peak_right = lowest
        self._peak_left_hold = self._peak_right_hold = 0.0
        self._want_loudness = bool(loudness)
        self.loudness_meter = None      # built lazily (needs samplerate)

    def reset(self) -> None:
        self.level_left = self.level_right = self.lowest
        self.peak_left = self.peak_right = self.lowest
        self._peak_left_hold = self._peak_right_hold = 0.0
        self.loudness_meter = None

    @property
    def momentary_lufs(self) -> float:
        return (self.loudness_meter.momentary if self.loudness_meter
                else float("-inf"))

    @property
    def short_term_lufs(self) -> float:
        return (self.loudness_meter.short_term if self.loudness_meter
                else float("-inf"))

    def _loudness(self, samplerate: int, nchannels: int):
        if self.loudness_meter is None:
            from .ops.loudness import StreamingLoudness
            self.loudness_meter = StreamingLoudness(samplerate, nchannels)
        return self.loudness_meter

    def update(self, sample: Sample):
        """Process one sample/chunk; returns (level_l, peak_l, level_r, peak_r)."""
        maxvalue = float(sample.maxvalue)
        data = sample.jax_frames
        if self._want_loudness:
            # original channel layout (dual-mono VU expansion would read
            # +3 LU high); its own single-sync program per chunk
            self._loudness(sample.samplerate,
                           sample.nchannels).update(data)
        if sample.nchannels == 1:
            data = jnp.concatenate([data, data], axis=1)
        # one stacked device reduction -> ONE host materialization per chunk
        pl, pr, msl, msr = np.asarray(dpcm.vu_levels(data), np.float64)
        return self._advance(pl, pr, msl, msr, maxvalue, sample.duration)

    def update_frames(self, frames: np.ndarray, samplerate: int,
                      maxvalue: float = 32767.0):
        """Host-side metering for realtime int16 chunks: the mixer's chunk
        is already host memory, so the reductions run in the native pcmops
        library (numpy fallback) with NO device round-trip (the live
        loudness readout, when enabled, stays on host too)."""
        from .utils import native
        a = np.asarray(frames)
        if a.ndim == 1:
            a = a[:, None]
        if self._want_loudness:
            self._loudness(samplerate, a.shape[1]).update_host(
                a, maxvalue)
        if a.shape[1] == 1:
            a = np.repeat(a, 2, axis=1)
        pl, pr, msl, msr = native.vu_i16(a)
        return self._advance(float(pl), float(pr), msl, msr, maxvalue,
                             len(a) / samplerate)

    def _advance(self, pl, pr, msl, msr, maxvalue, dt):
        if self.rms_mode:
            ampl_l = math.sqrt(max(msl, 0.0)) / maxvalue
            ampl_r = math.sqrt(max(msr, 0.0)) / maxvalue
        else:
            ampl_l = pl / maxvalue
            ampl_r = pr / maxvalue
        decay = self.DECAY_DB_PER_SEC * dt
        db_l = 20.0 * math.log10(ampl_l) if ampl_l > 0 else self.lowest
        db_r = 20.0 * math.log10(ampl_r) if ampl_r > 0 else self.lowest
        db_l = max(db_l, self.lowest)
        db_r = max(db_r, self.lowest)
        self.level_left = max(db_l, self.level_left - decay)
        self.level_right = max(db_r, self.level_right - decay)
        self._peak_left_hold += dt
        self._peak_right_hold += dt
        if db_l >= self.peak_left:
            self.peak_left = db_l
            self._peak_left_hold = 0.0
        elif self._peak_left_hold > self.PEAK_HOLD_SEC:
            self.peak_left = max(self.peak_left - decay, db_l)
        if db_r >= self.peak_right:
            self.peak_right = db_r
            self._peak_right_hold = 0.0
        elif self._peak_right_hold > self.PEAK_HOLD_SEC:
            self.peak_right = max(self.peak_right - decay, db_r)
        return self.level_left, self.peak_left, self.level_right, self.peak_right

    def print(self, bar_width: int = 60):
        """Render a console VU bar (like the reference's console meter)."""
        db_mixed = (self.level_left + self.level_right) / 2
        peak_mixed = (self.peak_left + self.peak_right) / 2
        db_level = int(bar_width - bar_width * db_mixed / self.lowest)
        peak_indicator = int(bar_width - bar_width * peak_mixed / self.lowest)
        db_meter = ("#" * db_level).ljust(bar_width)
        db_meter = db_meter[:peak_indicator] + ":" + db_meter[peak_indicator:]
        lufs = ""
        if self.loudness_meter is not None:
            # fixed width: the \r-overwritten console line must not vary
            m = self.loudness_meter.momentary
            s = self.loudness_meter.short_term
            ms = f"{m:6.1f}" if math.isfinite(m) else "  ----"
            ss = f"{s:6.1f}" if math.isfinite(s) else "  ----"
            lufs = f"  M {ms} S {ss} LUFS"
        print(f"{int(db_mixed):d} dB |{db_meter}| 0 dB{lufs}", end="\r")
