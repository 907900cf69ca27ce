"""Voice-axis data parallelism over a device mesh.

The reference is single-process/single-node (SURVEY.md §3.4); the scaling
axis here is the *voice bank*: voices shard trivially as data parallelism
across devices, and the only collective is one ``psum`` of each chunk's
[N, 2] stereo partial mix.  This module provides the mesh plumbing used by the
driver's ``dryrun_multichip`` and by multi-chip offline renders.

Layout: every ``VoiceParams`` leaf is sharded on its leading (voice) axis
with ``PartitionSpec('voices')``; per-voice FM phase carries stay sharded
across the whole scan; the psum crosses the device interconnect once per
chunk (bytes per chunk = N * 2 * 4, tiny next to the per-device compute).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.voicebank import ALL_WAVES, VoiceParams, render_block

AXIS = "voices"
HITS_AXIS = "voices"   # hit-parallel song mixdowns reuse the same 1-D mesh


def voice_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh over the voice axis, on the default backend's devices
    unless ``devices`` is given.  Raises when fewer than ``n_devices``
    are available: a mesh never moves to another platform."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def shard_voice_params(vp: VoiceParams, mesh: Mesh) -> VoiceParams:
    """Place every parameter array with its leading axis sharded over the mesh."""
    sh = NamedSharding(mesh, P(AXIS))
    return jax.tree.map(lambda x: jax.device_put(x, sh), vp)


#: compiled sharded programs keyed by (kind, mesh, static config) — fresh
#: jit+shard_map closures per call would recompile on every mix/stream of
#: the same shapes (the per-instance-closure bug class, see
#: voicebank._bank_fns)
_sharded_fn_cache: dict = {}


def stream_chunk_sharded_fn(mesh: Mesh, cf: int, lmax: int):
    """Jitted sharded streaming drum chunk: hit rows shard over the mesh,
    int32 psum merge (bit-exact)."""
    key = ("stream_chunk", mesh, cf, lmax)
    fn = _sharded_fn_cache.get(key)
    if fn is None:
        from ..sequencer import _scale_hits

        @jax.jit
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(), P(HITS_AXIS), P(HITS_AXIS), P(HITS_AXIS),
                      P(HITS_AXIS), P()),
            out_specs=P())
        def fn(bank, inst_k, start_k, valid_k, gain_k, c0):
            pos = (c0 + jnp.arange(cf, dtype=jnp.int32))[None, :] - start_k[:, None]
            inrange = (pos >= 0) & (pos < lmax) & valid_k[:, None]
            pos_c = jnp.clip(pos, 0, lmax - 1)
            vals = bank[inst_k[:, None], pos_c]
            vals = _scale_hits(vals, gain_k[:, None, :])
            vals = jnp.where(inrange[:, :, None], vals, 0)
            return jax.lax.psum(vals.sum(axis=0), HITS_AXIS)
        _sharded_fn_cache[key] = fn
    return fn


def _any_glide(voices) -> bool:
    return any(v.glide_from > 0.0 and v.glide_time > 0.0
               and v.frequency > 0.0 for v in voices)


def song_synth_shards(voices, samplerate: int, mesh: Mesh,
                      num_harmonics: int = 8):
    """Pack a song's synth voices for the mesh: (sharded VoiceParams,
    used_waves, use_fm, use_glide, use_bend, use_amp, use_dmod).  One
    place owns the padding rule and the compiled-waveform-set/flag
    derivation for every sharded voice path (ini songs AND MIDI renders —
    the curve flags carry continuous MIDI bend / CC7+CC11 / CC1+pressure
    depth curves onto the mesh)."""
    from ..models.voicebank import WAVE_IDS, pack_voices
    vp = pack_voices(voices, samplerate, num_harmonics=num_harmonics,
                     pad_to=int(mesh.devices.size))
    used = tuple(sorted({WAVE_IDS[v.wave] for v in voices}))
    use_fm = any(v.fm_depth != 0.0 for v in voices)
    use_glide = _any_glide(voices)
    use_bend = any(v.pitch_curve for v in voices)
    use_amp = any(v.amp_curve for v in voices)
    use_dmod = any(v.fm_depth_curve for v in voices)
    return (shard_voice_params(vp, mesh), used, use_fm, use_glide,
            use_bend, use_amp, use_dmod)


def song_synth_shards_grouped(voices, vtracks, fx_tracks, samplerate: int,
                              mesh: Mesh, num_harmonics: int = 8):
    """Pack a song's synth voices WITH per-track segment tags for the mesh:
    (sharded VoiceParams, sharded seg [V] i32, used_waves, use_fm,
    use_glide).

    Segment 0 is the shared clean bus; segment i+1 is ``fx_tracks[i]``'s own
    stereo bus (the per-synth-track fx path).  Tags shard over the same
    voice axis as the params; pad voices are silent and carry tag 0, so the
    clean bus they land in receives exact zeros."""
    from ..models.voicebank import WAVE_IDS, pack_voices
    seg_index = {n: i + 1 for i, n in enumerate(fx_tracks)}
    tags = [seg_index.get(t, 0) for t in vtracks]
    vp = pack_voices(voices, samplerate, num_harmonics=num_harmonics,
                     pad_to=int(mesh.devices.size))
    V = int(vp.base_inc.shape[0])
    seg = jnp.asarray(np.asarray(tags + [0] * (V - len(tags)), np.int32))
    used = tuple(sorted({WAVE_IDS[v.wave] for v in voices}))
    use_fm = any(v.fm_depth != 0.0 for v in voices)
    use_glide = _any_glide(voices)
    sh = NamedSharding(mesh, P(AXIS))
    return (shard_voice_params(vp, mesh), jax.device_put(seg, sh), used,
            use_fm, use_glide)


def render_song_grouped_sharded(vp: VoiceParams, seg: jax.Array, nseg: int,
                                total_frames: int, samplerate: int,
                                chunk_frames: int, num_harmonics: int,
                                mesh: Mesh, used_waves: tuple,
                                use_fm: bool,
                                use_glide: bool = False) -> jax.Array:
    """Offline GROUPED mixdown over the mesh: each device scans the song's
    chunks over its local voice shard, scattering every local voice into
    its segment's stereo bus (the grouped pan matmul of
    ``render_block(seg=)``), and one f32 psum per chunk merges the
    [chunk, nseg, 2] partial buses.  Output is the replicated bus stack
    f32 [total_frames, nseg, 2] — ≤1 LSB vs the single-device grouped
    render after int16 quantization (cross-shard summation order)."""
    nchunks = -(-total_frames // chunk_frames)
    key = ("song_grouped", mesh, nchunks, chunk_frames, samplerate,
           num_harmonics, used_waves, use_fm, int(nseg), use_glide)
    run = _sharded_fn_cache.get(key)
    if run is None:
        @jax.jit
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(AXIS), P(AXIS)), out_specs=P())
        def run(vp_shard: VoiceParams, seg_shard) -> jax.Array:
            def body(_, i):
                buses = render_block(vp_shard, i * chunk_frames,
                                     chunk_frames, samplerate,
                                     num_harmonics, used_waves=used_waves,
                                     use_fm=use_fm, seg=seg_shard,
                                     nseg=nseg, use_glide=use_glide)
                return 0, jax.lax.psum(buses, AXIS)
            _, out = jax.lax.scan(body, 0,
                                  jnp.arange(nchunks, dtype=jnp.int32))
            return out.reshape(-1, nseg, 2)
        _sharded_fn_cache[key] = run
    return run(vp, seg)[:total_frames]


def render_chunk_grouped_sharded_fn(mesh: Mesh, chunk_frames: int,
                                    samplerate: int, num_harmonics: int,
                                    used_waves: tuple, use_fm: bool,
                                    nseg: int, use_glide: bool = False):
    """Jitted (vp_shard, seg_shard, c0) -> psum'ed [chunk, nseg, 2] bus
    stack (the streaming counterpart of
    :func:`render_song_grouped_sharded`'s scan body)."""
    key = ("chunk_grouped", mesh, chunk_frames, samplerate, num_harmonics,
           used_waves, use_fm, int(nseg), use_glide)
    fn = _sharded_fn_cache.get(key)
    if fn is None:
        @jax.jit
        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P(AXIS), P(AXIS), P()), out_specs=P())
        def fn(vp_shard: VoiceParams, seg_shard, c0) -> jax.Array:
            buses = render_block(vp_shard, c0, chunk_frames, samplerate,
                                 num_harmonics, used_waves=used_waves,
                                 use_fm=use_fm, seg=seg_shard, nseg=nseg,
                                 use_glide=use_glide)
            return jax.lax.psum(buses, AXIS)
        _sharded_fn_cache[key] = fn
    return fn


def render_chunk_sharded_fn(mesh: Mesh, chunk_frames: int, samplerate: int,
                            num_harmonics: int, used_waves: tuple,
                            use_fm: bool, use_glide: bool = False,
                            use_bend: bool = False, use_amp: bool = False,
                            use_dmod: bool = False):
    """Jitted (vp_shard, c0) -> psum'ed stereo chunk over the mesh (the
    streaming counterpart of :func:`render_song_sharded`'s scan body;
    same static curve flags — keep the two in lockstep)."""
    key = ("chunk", mesh, chunk_frames, samplerate, num_harmonics,
           used_waves, use_fm, use_glide, use_bend, use_amp, use_dmod)
    fn = _sharded_fn_cache.get(key)
    if fn is None:
        @jax.jit
        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P(AXIS), P()), out_specs=P())
        def fn(vp_shard: VoiceParams, c0) -> jax.Array:
            stereo = render_block(vp_shard, c0, chunk_frames, samplerate,
                                  num_harmonics, used_waves=used_waves,
                                  use_fm=use_fm, use_glide=use_glide,
                                  use_bend=use_bend, use_amp=use_amp,
                                  use_dmod=use_dmod)
            return jax.lax.psum(stereo, AXIS)
        _sharded_fn_cache[key] = fn
    return fn


def render_song_sharded(vp: VoiceParams, total_frames: int,
                        samplerate: int = 44100, chunk_frames: int = 8192,
                        num_harmonics: int = 8,
                        mesh: Optional[Mesh] = None,
                        used_waves: tuple = ALL_WAVES,
                        use_fm: bool = True,
                        use_glide: bool = False,
                        use_bend: bool = False,
                        use_amp: bool = False,
                        use_dmod: bool = False) -> jax.Array:
    """Offline mixdown with the voice axis sharded over the mesh.

    Each device scans the song's chunks over its local voice shard; the
    stereo partial mixes are psum'ed across the mesh.  Output is replicated
    f32 [total_frames, 2] and matches the single-device render (up to f32
    summation order across shards).  ``used_waves``/``use_fm`` restrict the
    compiled waveform set (compile time + per-sample work);
    ``use_bend``/``use_amp``/``use_dmod`` enable the per-voice pitch/
    amplitude/FM-depth curve segments (continuous MIDI bend, CC7/CC11,
    CC1+pressure vibrato) — static flags like the single-device bank's, so
    curve-free songs keep their exact pre-curve HLO.
    """
    if mesh is None:
        mesh = voice_mesh()
    nchunks = -(-total_frames // chunk_frames)
    V = vp.base_inc.shape[0]
    ndev = mesh.devices.size
    if V % ndev:
        raise ValueError(f"voice count {V} not divisible by mesh size {ndev}")

    vp = shard_voice_params(vp, mesh)

    key = ("song", mesh, nchunks, chunk_frames, samplerate, num_harmonics,
           used_waves, use_fm, use_glide, use_bend, use_amp, use_dmod)
    run = _sharded_fn_cache.get(key)
    if run is None:
        @jax.jit
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(AXIS),), out_specs=P())
        def run(vp_shard: VoiceParams) -> jax.Array:
            def body(_, i):
                stereo = render_block(vp_shard, i * chunk_frames, chunk_frames,
                                      samplerate, num_harmonics,
                                      used_waves=used_waves, use_fm=use_fm,
                                      use_glide=use_glide, use_bend=use_bend,
                                      use_amp=use_amp, use_dmod=use_dmod)
                return 0, jax.lax.psum(stereo, AXIS)
            _, out = jax.lax.scan(body, 0, jnp.arange(nchunks, dtype=jnp.int32))
            return out.reshape(-1, 2)
        _sharded_fn_cache[key] = run

    return run(vp)[:total_frames]


def scatter_mix_sharded(bank: jax.Array, hits_inst, hits_start,
                        total: int, mesh: Mesh,
                        hits_gain=None) -> jax.Array:
    """Sharded song scatter-add: hits distributed over the mesh, one int32
    ``psum`` merge.

    Integer (wrapping) addition is associative and commutative, so the
    result is BIT-EXACT vs the single-device scatter regardless of how
    hits land on devices.  The instrument bank is replicated (it is small:
    S x Lmax x C); each device gathers + scatter-adds only its hit shard.
    ``hits_gain`` velocity-scales each hit before the int32 add (rounded
    per hit, so sharding stays bit-exact).
    """
    from ..sequencer import _mixdown_kernel

    ndev = mesh.devices.size
    H = int(hits_inst.shape[0])
    pad = -H % ndev if H else ndev
    inst = np.concatenate([np.asarray(hits_inst, np.int32),
                           np.zeros(pad, np.int32)])
    # padded rows scatter at index `total`: dropped by mode='drop', so no
    # valid-mask multiply is needed
    start = np.concatenate([np.asarray(hits_start, np.int32),
                            np.full(pad, total, np.int32)])
    C = int(bank.shape[2])
    if hits_gain is None:
        hits_gain = np.ones((H, C), np.float32)
    gain = np.concatenate([np.asarray(hits_gain, np.float32)
                           .reshape(H, C),
                           np.zeros((pad, C), np.float32)])

    key = ("scatter", mesh, total)
    run = _sharded_fn_cache.get(key)
    if run is None:
        @jax.jit
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(), P(HITS_AXIS), P(HITS_AXIS), P(HITS_AXIS)),
            out_specs=P())
        def run(bank, inst, start, gain):
            # memory-bounded batched scatter (shared with the single-device
            # path), then one int32 psum across the mesh
            out = _mixdown_kernel(bank, inst, start, total, gain)
            return jax.lax.psum(out, HITS_AXIS)
        _sharded_fn_cache[key] = run

    return run(jnp.asarray(bank), jnp.asarray(inst), jnp.asarray(start),
               jnp.asarray(gain))


def pitched_chunk_sharded_fn(mesh: Mesh, cf: int, lmax: int):
    """Sharded pitched-sampler chunk: hit rows shard over the mesh, one
    int32 psum merge (bit-exact — per-hit rint happens before the add)."""
    key = ("pitched_chunk", mesh, cf, lmax)
    fn = _sharded_fn_cache.get(key)
    if fn is None:
        from ..sequencer import _pitched_chunk_body

        @jax.jit
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(), P(), P(HITS_AXIS), P(HITS_AXIS), P(HITS_AXIS),
                      P(HITS_AXIS), P(HITS_AXIS), P(HITS_AXIS),
                      P(HITS_AXIS), P()),
            out_specs=P())
        def fn(bank, lens, idx_k, start_k, rate_k, gain_k, valid_k,
               loopf_k, loopu_k, c0):
            out = _pitched_chunk_body(bank, lens, idx_k, start_k, rate_k,
                                      gain_k, valid_k, loopf_k, loopu_k,
                                      c0, cf, lmax)
            return jax.lax.psum(out, HITS_AXIS)
        _sharded_fn_cache[key] = fn
    return fn


def pitched_song_sharded(bank, lens, idx_b, start_b, rate_b, gain_b,
                         valid_b, loopf_b, loopu_b, c0s, cf: int,
                         lmax: int, mesh: Mesh) -> jax.Array:
    """Sharded offline pitched mixdown: the bucketed hit ROWS (K axis)
    shard over the mesh; each device scans all chunks over its rows and
    ONE int32 psum merges at the end (bit-exact)."""
    key = ("pitched_song", mesh, cf, lmax, tuple(idx_b.shape))
    run = _sharded_fn_cache.get(key)
    if run is None:
        from ..sequencer import _pitched_chunk_body

        @jax.jit
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(), P(), P(None, HITS_AXIS), P(None, HITS_AXIS),
                      P(None, HITS_AXIS), P(None, HITS_AXIS, None),
                      P(None, HITS_AXIS), P(None, HITS_AXIS, None),
                      P(None, HITS_AXIS, None), P()),
            out_specs=P())
        def run(bank, lens, idx_b, start_b, rate_b, gain_b, valid_b,
                loopf_b, loopu_b, c0s):
            def body(_, xs):
                ib, sb, rb, gb, vb, lf, lu, c0 = xs
                return 0, _pitched_chunk_body(bank, lens, ib, sb, rb, gb,
                                              vb, lf, lu, c0, cf, lmax)
            _, out = jax.lax.scan(
                body, 0, (idx_b, start_b, rate_b, gain_b, valid_b,
                          loopf_b, loopu_b, c0s))
            return jax.lax.psum(out.reshape(-1, bank.shape[2] // 2),
                                HITS_AXIS)
        _sharded_fn_cache[key] = run
    return run(jnp.asarray(bank), jnp.asarray(lens), jnp.asarray(idx_b),
               jnp.asarray(start_b), jnp.asarray(rate_b),
               jnp.asarray(gain_b), jnp.asarray(valid_b),
               jnp.asarray(loopf_b), jnp.asarray(loopu_b),
               jnp.asarray(c0s))
