"""Gate-driven realtime voices.

The reference's keyboard synth holds a note while the key is down and
triggers the envelope *release* on key-up (SURVEY.md §4.5); the offline
``EnvelopeFilter`` uses a fixed sustain duration instead.  A
:class:`RealtimeVoice` streams an un-enveloped patch block by block
(device-rendered) and applies a gate ADSR on device:

* held:     g(t) = attack ramp -> decay -> sustain_level (indefinitely)
* released: g(t) = level_at_release * (1 - (t - t_release)/release)

Release is **sample-accurate**: ``release(at_frame=k)`` starts the ramp at
exactly frame ``k`` — the block containing it renders piecewise
(held gains before ``k``, release ramp from ``k``) in one fused select,
with zero-frame quantization.  A bare ``release()`` starts
the ramp at the next block boundary, the honest realtime default (earlier
frames may already be queued at the audio device).  The block stream ends
once the release ramp completes, which makes the playback mixer drop the
voice and fire its ended-callback.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import params
from .models import graph as G
from .oscillators import Oscillator


import functools


_HELD = 2**31 - 1   # release_start sentinel: never released


@functools.partial(jax.jit, static_argnames=("n",))
def _gate_gains(n0: jax.Array, n: int, samplerate: float, attack: jax.Array,
                decay: jax.Array, sustain_level: jax.Array,
                release_start: jax.Array, release_level: jax.Array,
                release: jax.Array) -> jax.Array:
    """Piecewise gate envelope for one block at absolute frame ``n0``.

    Frames (integer index) before ``release_start`` get the held A/D/S
    curve; frames at or after it get the release ramp from
    ``release_level``.  The held/released SPLIT is an exact int32 frame
    comparison — an f32 time comparison would lose single-frame resolution
    past ~2^22 frames.  A held voice passes ``release_start = _HELD``
    (one compiled program covers held, released, and split blocks)."""
    idx = n0 + jnp.arange(n, dtype=jnp.int32)          # exact frame index
    t = idx.astype(jnp.float32) / samplerate
    eps = jnp.float32(1e-30)
    g = jnp.ones((n,), jnp.float32)
    g = jnp.where(attack > 0, jnp.minimum(g, t / jnp.maximum(attack, eps)), g)
    in_decay = (t >= attack) & (t < attack + decay)
    g = jnp.where(in_decay,
                  1.0 + (sustain_level - 1.0) * (t - attack) / jnp.maximum(decay, eps),
                  g)
    g = jnp.where(t >= attack + decay, sustain_level, g)
    held = jnp.maximum(g, 0.0)
    # ramp position in whole frames (exact), then seconds in f32
    dt_rel = (idx - release_start).astype(jnp.float32) / samplerate
    rel = jnp.clip(release_level * (1.0 - dt_rel / jnp.maximum(release, eps)),
                   0.0, 1.0)
    return jnp.where(idx < release_start, held, rel)


@functools.partial(jax.jit, static_argnames=("offsets", "tap_gains"))
def _echo_step(gated: jax.Array, tail: jax.Array, offsets: tuple,
               tap_gains: tuple):
    """One streaming feed-forward echo block (same math as the offline
    ``spec.Echo`` lowering): ``out = gated + sum_k g_k * gated[n - d_k]``
    with the cross-block history carried in ``tail`` [dmax]."""
    B = gated.shape[0]
    dmax = tail.shape[0]
    buf = jnp.concatenate([tail, gated])
    out = gated
    for dk, gk in zip(offsets, tap_gains):
        out = out + jnp.float32(gk) * jax.lax.dynamic_slice_in_dim(
            buf, dmax - dk, B)
    return out, buf[-dmax:]


#: compiled voice programs keyed by the full static config — re-pressing a
#: key (same patch/ADSR/echo) must reuse the compiled program, not rebuild
#: a fresh jit closure (the per-instance-closure bug class, see
#: voicebank._bank_fns)
_voice_program_cache: dict = {}


def _voice_program(spec, samplerate: int, rbs: int, attack: float,
                   decay: float, sustain_level: float, release_time: float,
                   echo_offsets: tuple, echo_gains: tuple):
    key = (spec, samplerate, rbs, attack, decay, sustain_level,
           release_time, echo_offsets, echo_gains)
    entry = _voice_program_cache.get(key)
    if entry is None:
        init_state, step = G.lower(spec, samplerate, rbs)
        sr = jnp.float32(samplerate)
        a = jnp.float32(attack)
        d = jnp.float32(decay)
        sl = jnp.float32(sustain_level)
        r = jnp.float32(release_time)
        has_echo = bool(echo_offsets)

        @jax.jit
        def voice_step(state, tail, n0, rn, rlevel):
            vals, state = step(state, n0)
            gains = _gate_gains(n0, rbs, sr, a, d, sl, rn, rlevel, r)
            gated = vals * gains
            if has_echo:
                gated, tail = _echo_step(gated, tail, echo_offsets,
                                         echo_gains)
            v = jnp.clip(jnp.rint(gated * jnp.float32(32767.0)),
                         -32768, 32767).astype(jnp.int16)
            return v, state, tail

        entry = (init_state, voice_step)
        _voice_program_cache[key] = entry
    return entry


class RealtimeVoice:
    """One sounding note: streaming patch render x gate ADSR -> int16 chunks."""

    def __init__(self, patch: Oscillator, attack: float, decay: float,
                 sustain_level: float, release: float,
                 samplerate: int = 0, blocksize: int = 0, stereo: bool = True,
                 echo: Optional[tuple] = None, lookahead_blocks: int = 1):
        """``echo=(after, amount, delay, decay)`` applies a feed-forward
        echo AFTER the gate envelope — the reference's offline order
        (envelope, then echo); the tail keeps ringing for the echo span
        after the release ramp ends.

        ``lookahead_blocks``: render N mixer blocks per device round trip
        and slice on host.  The engine is block-size invariant, so the
        audio is BIT-identical; the tradeoff is bare-``release()`` latency
        (it takes effect at the next superblock).  Meant for hosts where
        one device round trip costs a large share of a 33 ms block —
        with N=4 it amortizes over four blocks."""
        self.samplerate = samplerate or patch.samplerate
        self.blocksize = blocksize or params.norm_frames_per_chunk
        self.lookahead = max(1, int(lookahead_blocks))
        self._rbs = self.blocksize * self.lookahead
        self.attack = float(attack)
        self.decay = float(decay)
        self.sustain_level = float(sustain_level)
        self.release_time = max(float(release), 1e-4)
        self.stereo = stereo
        self._echo_offsets: tuple = ()
        self._echo_gains: tuple = ()
        self._echo_tail = None
        if echo is not None:
            after, amount, delay, decay_g = echo
            offs, gains, g = [], [], 1.0
            for k in range(1, int(amount) + 1):
                g *= float(decay_g)
                dk = int(round(after * self.samplerate)) \
                    + k * int(round(delay * self.samplerate))
                if dk > 0:
                    offs.append(dk)
                    gains.append(np.float32(g))
            if offs:
                self._echo_offsets = tuple(offs)
                self._echo_gains = tuple(gains)
                self._echo_tail = jnp.zeros((max(offs),), jnp.float32)
        self._released = threading.Event()
        self._release_at: Optional[int] = None
        self._release_n: Optional[int] = None
        self._release_level: Optional[float] = None

        # ONE fused device program per superblock (lookahead x block):
        # patch render, gate gains, echo, int16 quantization — one
        # dispatch and one host sync per superblock, amortized over the
        # lookahead.
        if self._echo_tail is None:
            self._echo_tail = jnp.zeros((1,), jnp.float32)   # static pytree
        self._voice_state, self._voice_step = _voice_program(
            patch.spec, self.samplerate, self._rbs, self.attack, self.decay,
            self.sustain_level, self.release_time, self._echo_offsets,
            self._echo_gains)

    def release(self, at_frame: Optional[int] = None) -> None:
        """Key-up.  ``at_frame`` pins the ramp start to that exact absolute
        frame (sample-accurate: the containing block renders piecewise
        around it; a future frame holds the note until then).  Without it
        the ramp starts at the next block boundary — the realtime default,
        since earlier frames may already sit in the audio device queue."""
        self._release_at = int(at_frame) if at_frame is not None else None
        self._released.set()

    def _held_level_at(self, n: int) -> float:
        t = n / self.samplerate
        if self.attack > 0 and t < self.attack:
            return t / self.attack
        if t < self.attack + self.decay and self.decay > 0:
            return 1.0 + (self.sustain_level - 1.0) * (t - self.attack) / self.decay
        return self.sustain_level

    def chunks(self) -> Iterator[bytes]:
        """Yield interleaved int16 frame bytes; ends after the release ramp."""
        n0 = 0
        state = self._voice_state
        tail = self._echo_tail
        while True:
            if self._release_n is None and self._released.is_set():
                rn = n0 if self._release_at is None else self._release_at
                # frames before n0 are already rendered/queued; the ramp
                # cannot rewrite them, so it starts no earlier than n0.
                # Clamp into int32 (the whole engine indexes frames in
                # int32): an absurd at_frame degrades to "held forever"
                # rather than crashing the mixer thread.
                self._release_n = min(max(int(rn), n0), _HELD - 1)
                self._release_level = self._held_level_at(self._release_n)
            if self._release_n is None:
                rn_arg, level_arg = _HELD, 1.0
            else:
                rn_arg, level_arg = self._release_n, self._release_level
            out, state, tail = self._voice_step(
                state, tail, jnp.int32(n0), jnp.int32(rn_arg),
                jnp.float32(level_arg))
            sup = np.asarray(out)            # ONE host sync per superblock
            if self.stereo:
                sup = np.repeat(sup[:, None], 2, axis=1)
            for j in range(self.lookahead):
                yield sup[j * self.blocksize:(j + 1) * self.blocksize].tobytes()
                n0 += self.blocksize
                if n0 >= _HELD - self._rbs:
                    # ~13.5 h at 44.1 kHz: the engine's int32 frame index
                    # is about to wrap — end the stream cleanly instead
                    return
                if self._release_n is not None and \
                        n0 >= self._release_n \
                        + int(self.release_time * self.samplerate) \
                        + (max(self._echo_offsets) if self._echo_offsets else 0) + 1:
                    return
