"""Pattern sequencer: .ini song model -> batched device mixdown.

Rebuild of the reference's ``trackmixer.py`` song layer (SURVEY.md §3.1
row 8, §4.2).  Song files use the same schema:

    [song]
    bpm = 128
    ticks = 4
    swing = 0.0                  ; optional shuffle (odd ticks delayed)
    patterns = pat1 pat2 pat1
    [paths]                      ; optional
    samples = samples/
    [instruments]
    kick = kick.wav
    [pattern.pat1]
    kick  = x... X... x... o...   ; X = accent (1.5x), o = soft (0.5x)
    snare = .... x... .... x...

Where the reference mixes offline with a Python loop of per-hit
``Sample.mix_at`` calls (audioop.add per hit — the §4.2 hot loop), this
implementation compiles the whole song to **one batched device render**:
instrument samples are padded into a bank array, every hit becomes a row of
a gather, and a single scatter-add over the widened int32 output buffer
places all hits at once (BASELINE.json: "single batched render over all
tracks and patterns").  Streaming playback renders fixed-size chunks on
device from the same hit schedule (host control / device chunks).

**Beyond the reference — melodic synth tracks.**  Songs may also define
synth instruments rendered through the batched voice bank:

    [synth.lead]
    wave = square_bl
    amplitude = 0.4
    attack = 0.01
    decay = 0.05
    sustain_level = 0.7
    release = 0.1
    pan = 0.3
    [pattern.pat1]
    lead = C4 .. E4@0.5 G4 - - .. C5   ; note@velocity inline dynamics

Synth pattern tracks are whitespace-token based: a note name starts a note
at that tick, ``-`` ties (extends) the previous note, ``.``/``..`` is a
rest.  All synth notes of the whole song compile into ONE VoiceBank render
that is mixed with the sample scatter-add in the widened int32 domain.

**Beyond the reference — pitched sampler tracks** (tracker/FL-style
melodic WAV playback):

    [sampler.gtr]
    file = guitar.wav
    base_note = C4
    [pattern.pat1]
    gtr = C4 .. E4 G4 .. .. C5 ..

Each note token plays the WAV resampled by note_freq(note)/base_note's
frequency — on device as batched linear-interp gathers at
pos = (n - start) * rate (f32 on the note-relative index; rate 1.0 is a
bit-exact passthrough), polyphonic, velocity/pan automation per note.
With ``loop_start``/``loop_end`` keys the note SUSTAINS by cycling the
loop region for its tie length ('-' tokens) and then fades over
``release`` seconds; the looped read position is a 32-bit DDS phase over
the loop (the oscillators' fixed-point-turn trick), so it cannot drift
no matter how long the hold.
Offline the whole song's pitched notes render as ONE scan over chunks;
streaming shares the same stateless body, so both paths are
bit-identical; under ``mesh=`` the note rows shard with an int32 psum.

**Beyond the reference — effects and automation sections.**

    [fx]                          ; master-bus chain, in order
    compress = threshold_db=-15 ratio=4
    reverb = roomsize=0.7 wet=0.3 tail=0.25
    [fx.pad]                      ; sidechain ducking (tracker pump):
    compress = threshold_db=-30 ratio=8 sidechain=kick
    ;   the detector listens to the NAMED [instruments] track's own hits
    ;   bus while the gain applies to this chain's audio — valid on
    ;   synth/sampler track chains and the master [fx] chain
    [fx.kick]                     ; per-track chain (sample instrument:
    filter = kind=lowpass cutoff=500   ; baked into the banked WAV)
    [fx.lead]                     ; per-track chain (synth: processes the
    chorus = rate=1.5                  ; track's own grouped-bank bus)
    [automation]                  ; tick:value breakpoint curves
    master.volume = 0:1 32:0.5 64:1    ; continuous per-frame fade
    track.kick.volume = 0:1 16:0.25    ; per-hit / per-note velocity
    track.kick.pan = 0:-1 64:1         ; per-hit / per-note placement
    fx.filter.cutoff = 0:200 64:8000   ; master-chain filter sweep (Hz)
    fx.reverb.wet = 0:0 32:0.4         ; reverb send rides up
    ; (also automatable: fx.reverb.dry/.roomsize, fx.chorus.wet/.dry,
    ;  fx.chorus.rate/.depth, fx.compress.makeup_db/.threshold_db/.ratio,
    ;  fx.compress.attack/.release/.knee_db, fx.gate.threshold_db,
    ;  fx.eq.low_db/.mid_db/.high_db, fx.echo.feedback/.wet/.dry,
    ;  fx.width.amount, fx.limiter.ceiling_db/.release,
    ;  fx.phaser.wet/.dry/.rate/.depth,
    ;  fx.tremolo.rate/.depth, fx.autopan.rate/.depth
    ;  — the recurrence-internal ones
    ;  ride host-derived coefficient grids; every knob also works
    ;  TRACK-SCOPED as fx.TRACK.EFFECT.KNOB on a [fx.TRACK] chain,
    ;  e.g. fx.lead.filter.cutoff — automated drum chains route to a
    ;  mix-time bus instead of baking into the WAV)

Tempo-synced knobs resolve against [song] bpm at parse: ``echo beats=``
(delay in quarter notes) and ``chorus``/``phaser`` ``rate_beats=`` (LFO
period in beats).  The complete schema reference is docs/SONGS.md.
"""

from __future__ import annotations

import configparser
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

import dataclasses

from . import params
from .sample import Sample
from .synth import note_freq
from .models.voicebank import Voice, VoiceBank, pack_voices

__all__ = ["Song", "HitSchedule", "SynthDef"]

#: every automatable EFFECT.KNOB — valid as fx.EFFECT.KNOB on the master
#: [fx] chain AND as fx.TRACK.EFFECT.KNOB on a per-track chain
_FX_AUTO_SUBKEYS = frozenset((
    "filter.cutoff", "reverb.wet", "reverb.dry", "reverb.roomsize",
    "chorus.wet", "chorus.dry", "chorus.rate", "chorus.depth",
    "compress.makeup_db", "compress.threshold_db", "compress.ratio",
    "compress.attack", "compress.release", "compress.knee_db",
    "gate.threshold_db",
    "eq.low_db", "eq.mid_db", "eq.high_db",
    "echo.feedback", "echo.wet", "echo.dry",
    "width.amount", "limiter.ceiling_db", "limiter.release",
    "phaser.wet", "phaser.dry", "phaser.rate", "phaser.depth",
    "tremolo.rate", "tremolo.depth", "autopan.rate", "autopan.depth",
))


@dataclasses.dataclass
class SamplerDef:
    """A pitched sampler instrument (the [sampler.NAME] ini section) —
    tracker-style melodic sample playback: a note token plays the WAV
    resampled by note_freq(note)/note_freq(base_note), polyphonic (notes
    on the track may overlap).  Without a loop the full sample always
    plays out; with ``loop_start < loop_end`` (seconds in the source)
    the note sustains by cycling the loop region while held (its tie
    length gates it), then fades linearly over ``release`` seconds."""
    sample: Sample
    base_freq: float = 261.6255653005986      # C4
    loop_start: float = -1.0                  # seconds; <0 = no loop
    loop_end: float = -1.0
    release: float = 0.01                     # post-gate fade (looped)

    @property
    def looped(self) -> bool:
        return 0.0 <= self.loop_start < self.loop_end


@dataclasses.dataclass
class SynthDef:
    """A synth instrument definition (the [synth.NAME] ini section)."""
    wave: str = "sawtooth_bl"
    amplitude: float = 0.4
    attack: float = 0.01
    decay: float = 0.05
    sustain_level: float = 0.7
    release: float = 0.1
    pan: float = 0.0
    fm_frequency: float = 0.0
    fm_depth: float = 0.0
    pulse_width: float = 0.5
    harmonics: tuple = ()
    table: tuple = ()            # wave="wavetable": one cycle of samples
    damping: float = 1.0         # wave="pluck": loop-loss exponent scale
    seed: int = 0                # wave="pluck"/"white_noise" excitation
    glide: float = 0.0           # portamento seconds: each note slides
    #                              from the track's PREVIOUS note's pitch


class HitSchedule:
    """A flat schedule of (instrument index, start frame) hits plus the
    padded instrument bank — the device-side song representation."""

    def __init__(self, bank: np.ndarray, lengths: np.ndarray,
                 instruments: Sequence[str], hits: np.ndarray,
                 samplerate: int, nchannels: int,
                 gains: Optional[np.ndarray] = None):
        self.bank = bank              # [S, Lmax, C] int32 (unscaled values)
        self.lengths = lengths        # [S] valid frames per instrument
        self.instruments = list(instruments)
        self.hits = hits              # [H, 2] (instrument_idx, start_frame)
        self.samplerate = samplerate
        self.nchannels = nchannels
        #: per-hit per-channel gains [H, C] f32 (track volume/pan
        #: automation); 1.0 reproduces the pure-integer path bit-exactly
        #: (bank values are int16-scale, exact in f32)
        self.gains = (np.ones((len(hits), nchannels), np.float32)
                      if gains is None else np.asarray(gains, np.float32))

    @property
    def total_frames(self) -> int:
        if len(self.hits) == 0:
            return 0
        ends = self.hits[:, 1] + self.lengths[self.hits[:, 0]]
        return int(ends.max())


#: cap on the materialized [batch, Lmax, C] gather per scatter step —
#: ~32 M int32 elements = 128 MB of HBM regardless of song length
_SCATTER_BATCH_ELEMS = 32 * 1024 * 1024

#: compiled streaming-chunk programs keyed by (chunk_frames, Lmax) — a
#: fresh jit closure per mix_generator() call (with the bank baked in as
#: a constant) would recompile on every replay of the same song
_chunk_fn_cache: dict = {}


def _stream_chunk_fn(cf: int, lmax: int):
    key = (cf, lmax)
    fn = _chunk_fn_cache.get(key)
    if fn is None:
        @jax.jit
        def fn(bank, inst_k, start_k, valid_k, gain_k, c0):
            # rows: [K, cf] sample positions inside each hit's waveform
            pos = (c0 + jnp.arange(cf, dtype=jnp.int32))[None, :] - start_k[:, None]
            inrange = (pos >= 0) & (pos < lmax) & valid_k[:, None]
            pos_c = jnp.clip(pos, 0, lmax - 1)
            vals = bank[inst_k[:, None], pos_c]          # [K, cf, C]
            vals = _scale_hits(vals, gain_k[:, None, :])
            vals = jnp.where(inrange[:, :, None], vals, 0)
            return vals.sum(axis=0)                       # int32 [cf, C]
        _chunk_fn_cache[key] = fn
    return fn


def _pitched_chunk_body(bank, lens, idx_k, start_k, rate_k, gain_k,
                        valid_k, loopf_k, loopu_k, c0,
                        cf: int, lmax: int) -> jax.Array:
    """One chunk of pitched-sampler playback: each row reads its WAV at
    pos = (n - start) * rate with f32 linear interpolation (n relative to
    the note start, so f32 is exact to <0.05 frame over any realistic
    sample length; rate == 1.0 reproduces the source bit-exactly incl.
    the final frame), velocity/pan gains apply per channel, rows sum in
    int32.  Stateless in the absolute frame index — streaming == offline
    by construction.

    LOOPED rows (loopf = (flag, ls, lp, gate_total, fade_r); loopu =
    (inc, p0)): past the loop end the read position comes from a 32-bit
    DDS phase over the loop — pos = ls + x(p0 + n_rel*inc) * lp, exact
    and non-drifting for any hold length (the same fixed-point-turn trick
    as the oscillators) — and a linear release fade gates the note after
    its tie length: g = clip((gate_total - n_rel) * fade_r, 0, 1)."""
    C = bank.shape[2] // 2
    n_rel = (c0 + jnp.arange(cf, dtype=jnp.int32))[None, :] - start_k[:, None]
    n_rel_f = n_rel.astype(jnp.float32)
    pos = n_rel_f * rate_k[:, None]                            # [K, cf]
    last = (lens[idx_k] - 1).astype(jnp.float32)[:, None]
    flag = loopf_k[:, 0:1] > 0
    ls = loopf_k[:, 1:2]
    lp = loopf_k[:, 2:3]
    gate_total = loopf_k[:, 3:4]
    fade_r = loopf_k[:, 4:5]
    phase = (loopu_k[:, 1:2]
             + n_rel.astype(jnp.uint32) * loopu_k[:, 0:1])
    pos_loop = ls + phase.astype(jnp.float32)         * jnp.float32(2.0 ** -32) * lp
    use_loop = flag & (pos > ls + lp)
    pos = jnp.where(use_loop, pos_loop, pos)
    # a loop region ending at the sample's last frame (le == len) sweeps
    # pos through (len-1, len): clamp to the final frame instead of
    # letting frac > 1 extrapolate past wav[len-1]
    pos = jnp.where(flag, jnp.minimum(pos, last), pos)
    env = jnp.where(flag,
                    jnp.clip((gate_total - n_rel_f) * fade_r,
                             jnp.float32(0.0), jnp.float32(1.0)),
                    jnp.float32(1.0))
    inr = (n_rel >= 0) & valid_k[:, None]         & jnp.where(flag, n_rel_f < gate_total, pos <= last)
    i = jnp.clip(pos.astype(jnp.int32), 0,
                 jnp.maximum(lens[idx_k][:, None] - 2, 0))
    frac = pos - i.astype(jnp.float32)
    # bank is PAIR-packed [P, Lmax, 2C]: position i carries
    # (wav[i], wav[i+1]) so ONE gather fetches both interp endpoints
    # (this halves the gathered index rows)
    v01 = bank[idx_k[:, None], i].astype(jnp.float32)          # [K, cf, 2C]
    v0 = v01[..., :C]
    v1 = v01[..., C:]
    vals = v0 + (v1 - v0) * frac[:, :, None]
    vals = jnp.rint(vals * (gain_k[:, None, :]
                            * env[:, :, None])).astype(jnp.int32)
    vals = jnp.where(inr[:, :, None], vals, 0)
    return vals.sum(axis=0)                                    # [cf, C] i32


def _pitched_chunk_fn(cf: int, lmax: int):
    key = ("pitched", cf, lmax)
    fn = _chunk_fn_cache.get(key)
    if fn is None:
        @jax.jit
        def fn(bank, lens, idx_k, start_k, rate_k, gain_k, valid_k,
               loopf_k, loopu_k, c0):
            return _pitched_chunk_body(bank, lens, idx_k, start_k, rate_k,
                                       gain_k, valid_k, loopf_k, loopu_k,
                                       c0, cf, lmax)
        _chunk_fn_cache[key] = fn
    return fn


def _pitched_song_fn(cf: int, lmax: int):
    """Whole-song pitched mixdown: ONE scan over chunks with the
    per-chunk (bucketed) hit rows as scan inputs -> [nchunks*cf, C]."""
    key = ("pitched_song", cf, lmax)
    fn = _chunk_fn_cache.get(key)
    if fn is None:
        import functools as _ft

        @_ft.partial(jax.jit, static_argnames=("nchunks",))
        def fn(bank, lens, idx_b, start_b, rate_b, gain_b, valid_b,
               loopf_b, loopu_b, c0s, nchunks: int):
            def body(_, xs):
                idx_k, start_k, rate_k, gain_k, valid_k, lf, lu, c0 = xs
                return 0, _pitched_chunk_body(
                    bank, lens, idx_k, start_k, rate_k, gain_k, valid_k,
                    lf, lu, c0, cf, lmax)
            _, out = jax.lax.scan(
                body, 0, (idx_b, start_b, rate_b, gain_b, valid_b,
                          loopf_b, loopu_b, c0s))
            return out.reshape(-1, bank.shape[2] // 2)
        _chunk_fn_cache[key] = fn
    return fn


def _scale_hits(vals: jax.Array, gains: jax.Array) -> jax.Array:
    """Velocity-scale gathered int32 hit waveforms: f32 product, round to
    nearest.  Bank values are int16-scale (|v| <= 32767, exact in f32), so
    a gain of 1.0 is the identity and the no-automation path stays
    bit-exact with the historic pure-integer kernel."""
    return jnp.rint(vals.astype(jnp.float32) * gains).astype(jnp.int32)


@jax.jit
def _master_volume_fn(x16, xs, vs, n0, tickf):
    """Continuous master-volume automation: per-frame gain from the
    breakpoint curve (linear interp over ticks, ends held), applied to
    the int16-saturated mix.  Stateless in the absolute frame index, so
    offline and streaming slices are bit-identical."""
    n = (n0 + jnp.arange(x16.shape[0], dtype=jnp.int32)).astype(jnp.float32)
    g = jnp.interp(n / tickf, xs, vs)
    return jnp.clip(jnp.rint(x16.astype(jnp.float32) * g[:, None]),
                    -32768, 32767).astype(jnp.int16)


@jax.jit
def _finish_chunk(acc32, synth_stereo):
    if synth_stereo is not None:
        acc32 = acc32 + jnp.rint(
            synth_stereo * jnp.float32(32767.0)).astype(jnp.int32)
    return jnp.clip(acc32, -32768, 32767).astype(jnp.int16)


def _mixdown_kernel(bank: jax.Array, hits_inst: jax.Array,
                    hits_start: jax.Array, total: int,
                    hits_gain: Optional[jax.Array] = None) -> jax.Array:
    """All hits -> one scatter-add into the widened int32 song buffer.

    bank: [S, Lmax, C] int32; hits: [H].  Builds [batch, Lmax] frame
    indices (clipped rows drop via mode='drop') and scatter-adds the
    gathered waveforms, velocity-scaled by ``hits_gain`` (track volume
    automation; None == all-ones == bit-exact integer path).  Hits are
    processed in memory-bounded batches under ONE ``lax.scan`` (still a
    single device program): a dense song with long samples would
    otherwise materialize an [H, Lmax, C] gather of several GB.  Integer
    add is associative, so batching is bit-exact.
    """
    H = int(hits_inst.shape[0])
    Lmax = int(bank.shape[1])
    C = int(bank.shape[2])
    if hits_gain is None:
        hits_gain = jnp.ones((H, C), jnp.float32)
    arange_l = jnp.arange(Lmax, dtype=jnp.int32)[None, :]
    out = jnp.zeros((total, C), jnp.int32)

    batch = max(1, min(H, _SCATTER_BATCH_ELEMS // max(Lmax * C, 1)))
    if batch >= H:
        vals = _scale_hits(bank[hits_inst],
                           hits_gain[:, None, :])             # [H, Lmax, C]
        idx = hits_start[:, None] + arange_l
        return out.at[idx.reshape(-1)].add(vals.reshape(-1, C), mode="drop")

    nb = -(-H // batch)
    pad = nb * batch - H
    # padded rows scatter zeros at a dropped (out-of-range) index
    inst_p = jnp.concatenate([hits_inst, jnp.zeros(pad, jnp.int32)])
    start_p = jnp.concatenate([hits_start,
                               jnp.full(pad, total, jnp.int32)])
    gain_p = jnp.concatenate([hits_gain,
                              jnp.zeros((pad, C), jnp.float32)])
    inst_b = inst_p.reshape(nb, batch)
    start_b = start_p.reshape(nb, batch)
    gain_b = gain_p.reshape(nb, batch, C)

    def body(acc, ib_sb):
        ib, sb, gb = ib_sb
        vals = _scale_hits(bank[ib], gb[:, None, :])      # [batch, Lmax, C]
        idx = sb[:, None] + arange_l
        return acc.at[idx.reshape(-1)].add(vals.reshape(-1, C),
                                           mode="drop"), None

    out, _ = jax.lax.scan(body, out, (inst_b, start_b, gain_b))
    return out


class Song:
    """Sample-based pattern song (the trackmixer model)."""

    def __init__(self):
        self.bpm = 128
        self.ticks = 4
        #: shuffle feel ([song] swing, 0..0.95): every ODD tick is
        #: delayed by swing * half a tick — 0 is straight time, ~0.33
        #: lands off-beats on the triplet.  Applied at schedule compile
        #: (one place, _tick_pos), so drums, synth notes, and sampler
        #: notes swing together bit-exactly on every path
        self.swing = 0.0
        self.pattern_sequence: List[str] = []
        self.patterns: Dict[str, Dict[str, str]] = {}
        self.instruments: Dict[str, Sample] = {}
        self.synths: Dict[str, SynthDef] = {}
        #: pitched sampler instruments ([sampler.NAME] ini sections) —
        #: tracker-style melodic WAV playback through per-note-rate
        #: interpolating gathers (see compile_pitched_hits)
        self.samplers: Dict[str, SamplerDef] = {}
        self.samplerate = params.norm_samplerate
        self.nchannels = params.norm_nchannels
        #: master-bus effects ([fx] ini section), applied in order to the
        #: final mix — offline as fused lazy Sample ops, streaming via
        #: stateful chunk processors (synthesizer_tpu.effects)
        self.fx: List[Tuple[str, dict]] = []
        self.fx_irs: Dict[str, Sample] = {}      # convolve IRs by filename
        #: per-SYNTH-track effects ([fx.SYNTHNAME] ini sections): unlike a
        #: sample instrument (whose chain bakes into the banked WAV), a
        #: synth track's chain processes the track's own stereo bus —
        #: rendered per-segment by the grouped voice bank — before it
        #: joins the int32 mix
        self.synth_fx: Dict[str, List[Tuple[str, dict]]] = {}
        #: per-SAMPLER-track effects ([fx.SAMPLERNAME]): the track's
        #: pitched mix renders as its own int16 bus and the chain
        #: processes it before it joins the int32 mix (same pattern as
        #: synth_fx)
        self.sampler_fx: Dict[str, List[Tuple[str, dict]]] = {}
        #: DRUM-instrument chains that need a TIMELINE (sidechain
        #: compression): instead of baking into the banked WAV, the
        #: instrument's own hits render as a separate bus and the chain
        #: processes it at mix time — what makes "duck the hat by the
        #: kick" expressible
        self.drum_fx_bus: Dict[str, List[Tuple[str, dict]]] = {}
        #: drum chains that were BAKED into the banked WAV at
        #: add_track_fx time (no timeline): automation can no longer
        #: reach them — add_automation raises with guidance
        self._baked_fx: set = set()
        #: tracks whose [fx.NAME] knobs will be automated (pre-scanned
        #: from [automation] in from_ini): their drum chains route to a
        #: bus instead of baking, like sidechain chains
        self._auto_fx_tracks: set = set()
        #: automation curves ([automation] ini section): breakpoint lists
        #: of (tick, value) pairs, linearly interpolated, ends held.
        #: ``track.NAME.volume`` scales each hit/note by the curve at its
        #: start tick (velocity automation — applied at schedule compile,
        #: so offline == streaming trivially); ``master.volume`` is a
        #: continuous per-frame gain on the int16-saturated mix, applied
        #: before the master [fx] chain (both paths evaluate the same
        #: stateless absolute-frame formula)
        self.automation: Dict[str, List[Tuple[float, float]]] = {}

    # -- loading ----------------------------------------------------------

    @classmethod
    def from_ini(cls, ini_file: str, sample_dir: Optional[str] = None) -> "Song":
        song = cls()
        song.read(ini_file, sample_dir)
        return song

    def read(self, ini_file: str, sample_dir: Optional[str] = None) -> None:
        # ';' only: '#' appears in note names (C#4)
        cp = configparser.ConfigParser(inline_comment_prefixes=(";",))
        with open(ini_file) as f:
            cp.read_file(f)
        base = sample_dir
        if base is None:
            base = cp.get("paths", "samples", fallback="")
            if not os.path.isabs(base):
                base = os.path.join(os.path.dirname(os.path.abspath(ini_file)), base)
        self._read_cp(cp, base)

    @classmethod
    def from_string(cls, ini_text: str, sample_dir: str = "") -> "Song":
        """Build a Song directly from ini text (no temp file).

        Instrument WAVs resolve under ``sample_dir`` only; any ``[paths]``
        section in the text is ignored (callers that accept untrusted song
        text — e.g. the render server — must control the sample root)."""
        song = cls()
        cp = configparser.ConfigParser(inline_comment_prefixes=(";",))
        cp.read_string(ini_text)
        song._read_cp(cp, sample_dir)
        return song

    def _read_cp(self, cp: configparser.ConfigParser, base: str) -> None:
        self.bpm = cp.getint("song", "bpm")
        self.ticks = cp.getint("song", "ticks")
        if self.bpm <= 0 or self.ticks <= 0:
            raise ValueError(f"bpm and ticks must be positive "
                             f"(got bpm={self.bpm}, ticks={self.ticks})")
        self.swing = cp.getfloat("song", "swing", fallback=0.0)
        if not 0.0 <= self.swing <= 0.95:
            raise ValueError(f"swing must be in [0, 0.95] "
                             f"(got {self.swing})")
        self.pattern_sequence = cp.get("song", "patterns").split()
        for name, filename in cp.items("instruments") if cp.has_section("instruments") else []:
            smp = Sample(wave_file=os.path.join(base, filename), name=name)
            smp.normalize()
            self._check_format(name, smp)
            self.instruments[name] = smp
            self.samplerate = smp.samplerate
            self.nchannels = smp.nchannels
        self._read_sections(cp, base)

    def _read_sections(self, cp: configparser.ConfigParser,
                       base: str = "") -> None:
        for section in cp.sections():
            if section.startswith("synth."):
                name = section[len("synth."):]
                g = cp[section]
                self.synths[name] = SynthDef(
                    wave=g.get("wave", "sawtooth_bl"),
                    amplitude=g.getfloat("amplitude", 0.4),
                    attack=g.getfloat("attack", 0.01),
                    decay=g.getfloat("decay", 0.05),
                    sustain_level=g.getfloat("sustain_level", 0.7),
                    release=g.getfloat("release", 0.1),
                    pan=g.getfloat("pan", 0.0),
                    fm_frequency=g.getfloat("fm_frequency", 0.0),
                    fm_depth=g.getfloat("fm_depth", 0.0),
                    pulse_width=g.getfloat("pulse_width", 0.5),
                    harmonics=tuple(float(x) for x in g.get("harmonics", "").split()),
                    table=tuple(float(x) for x in g.get("table", "").split()),
                    damping=g.getfloat("damping", 1.0),
                    seed=g.getint("seed", 0),
                    glide=g.getfloat("glide", 0.0),
                )
        for section in cp.sections():
            if section.startswith("sampler."):
                name = section[len("sampler."):]
                g = cp[section]
                smp = Sample(wave_file=os.path.join(base, g["file"]),
                             name=name)
                self.add_sampler(name, smp, g.get("base_note", "C4"),
                                 loop_start=g.getfloat("loop_start", -1.0),
                                 loop_end=g.getfloat("loop_end", -1.0),
                                 release=g.getfloat("release", 0.01))
        for section in cp.sections():
            if section.startswith("pattern."):
                pname = section[len("pattern."):]
                self.add_pattern(pname, dict(cp.items(section)))
        if cp.has_section("fx"):
            from .effects import parse_fx_items
            self.fx = parse_fx_items(cp.items("fx"))
            for name, p in self.fx:
                if name == "convolve":
                    self._load_fx_ir(p["ir"], base)
                self._resolve_fx_tempo(name, p)
        if cp.has_section("automation"):
            # pre-scan BEFORE [fx.X] processing: a drum chain whose knobs
            # will be automated needs the bus route, not the baked WAV
            for key in cp.options("automation"):
                parts = key.split(".")
                if len(parts) == 4 and parts[0] == "fx":
                    self._auto_fx_tracks.add(parts[1])
        for section in cp.sections():
            if section.startswith("fx."):
                inst = section[len("fx."):]
                self.add_track_fx(inst, cp.items(section), base)
        if cp.has_section("automation"):
            for key, value in cp.items("automation"):
                self.add_automation(key, value)

    def _load_fx_ir(self, filename: str, base: str) -> None:
        """Load a convolution impulse response, converted to the song's
        rate (mono IRs stay mono — they apply to every channel)."""
        ir = Sample(wave_file=os.path.join(base, filename), name=filename)
        self.fx_irs[filename] = self._prep_fx_ir(ir)

    def _prep_fx_ir(self, ir: Sample) -> Sample:
        ir.resample(self.samplerate)
        if ir.nchannels == 2 and self.nchannels == 1:
            ir.mono()
        return ir

    def _resolve_fx_tempo(self, name: str, p: dict) -> None:
        """Resolve tempo-synced effect knobs against the song's bpm:
        ``echo beats=`` becomes ``delay=`` seconds (beats are quarter
        notes — delay = beats * 60/bpm), and ``chorus``/``phaser``
        ``rate_beats=`` (LFO period in beats) becomes ``rate=`` Hz
        (rate = bpm / (60 * rate_beats)), so every downstream consumer
        (FxChain, the offline ops, tail accounting) sees plain
        seconds/Hz."""
        if name == "echo" and "beats" in p:
            p["delay"] = float(p.pop("beats")) * 60.0 / float(self.bpm)
        if name in ("chorus", "phaser", "tremolo", "autopan") \
                and "rate_beats" in p:
            b = float(p.pop("rate_beats"))
            if b <= 0:
                raise ValueError(f"[fx] {name}: rate_beats must be > 0")
            p["rate"] = float(self.bpm) / (60.0 * b)

    def add_track_fx(self, instrument: str, items, base: str = "",
                     bus: bool = False) -> None:
        """Per-track effects ([fx.NAME] ini sections).

        A sample instrument's chain is applied to its sample once at load,
        so it reaches BOTH the offline scatter-add and the streaming path
        through the hit bank (a reverb/convolve tail simply lengthens the
        banked sample).  A synth track's chain is stored and processes the
        track's own stereo bus at mix time (synths shadow same-named
        sample instruments here, matching pattern-track resolution).
        ``bus=True`` forces a drum instrument's chain onto a mix-time bus
        even without a timeline-dependent entry — required when its knobs
        will be automated programmatically (fx.NAME.EFFECT.KNOB)."""
        from .effects import apply_fx_sample, parse_fx_items
        if (instrument not in self.instruments
                and instrument not in self.synths
                and instrument not in self.samplers):
            raise ValueError(f"[fx.{instrument}]: unknown instrument "
                             f"{instrument!r} (define it in [instruments], "
                             f"[synth.{instrument}], or "
                             f"[sampler.{instrument}] first)")
        fx = parse_fx_items(list(items))
        irs = {}
        from .effects import HOLDBACK_FX
        for name, p in fx:
            if name in HOLDBACK_FX:
                raise ValueError(
                    f"[fx.{instrument}]: {name} is master-chain only (its "
                    f"lookahead holdback cannot ride a fixed-size track "
                    f"bus — put it in [fx])")
            if name == "convolve":
                self._load_fx_ir(p["ir"], base)
                irs[p["ir"]] = self.fx_irs[p["ir"]]
            self._resolve_fx_tempo(name, p)
        if instrument in self.synths:
            self.synth_fx[instrument] = fx
        elif instrument in self.samplers:
            self.sampler_fx[instrument] = fx
        else:
            if (bus or any(n == "compress" and p.get("sidechain")
                           for n, p in fx)
                    or instrument in self._auto_fx_tracks):
                # a timeline-dependent chain (sidechain ducking, or knob
                # automation) cannot bake into the WAV: the instrument's
                # hits get their own bus at mix time
                self.drum_fx_bus[instrument] = fx
            else:
                apply_fx_sample(self.instruments[instrument], fx, irs)
                self._baked_fx.add(instrument)

    def add_automation(self, key: str, points) -> None:
        """Attach an automation curve (the [automation] ini section).

        ``key`` is ``master.volume`` or ``track.NAME.volume``; ``points``
        is a breakpoint list — either ``[(tick, value), ...]`` or the ini
        string form ``"0:1.0 16:0.5 32:1.0"``.  Ticks must be strictly
        ascending; values are linearly interpolated between breakpoints
        and held outside them.
        """
        if isinstance(points, str):
            parsed = []
            for tok in points.split():
                if ":" not in tok:
                    raise ValueError(f"automation {key}: breakpoint {tok!r} "
                                     f"is not tick:value")
                t, v = tok.split(":", 1)
                parsed.append((float(t), float(v)))
            points = parsed
        pts = [(float(t), float(v)) for t, v in points]
        if not pts:
            raise ValueError(f"automation {key}: empty curve")
        for (t0, _), (t1, _) in zip(pts, pts[1:]):
            if t1 <= t0:
                raise ValueError(f"automation {key}: ticks must be strictly "
                                 f"ascending (got {t0} then {t1})")
        parts = key.split(".")
        subkey = None
        if parts[0] == "fx" and len(parts) == 3 \
                and ".".join(parts[1:]) in _FX_AUTO_SUBKEYS:
            subkey = ".".join(parts[1:])
        elif parts[0] == "fx" and len(parts) == 4 \
                and ".".join(parts[2:]) in _FX_AUTO_SUBKEYS:
            subkey = ".".join(parts[2:])
        neg_ok = (key.endswith(".pan") or key.endswith(".makeup_db")
                  or key.endswith(".threshold_db")
                  or key.endswith(".ceiling_db")
                  or (subkey is not None and subkey.startswith("eq.")))
        for t, v in pts:
            if (not (np.isfinite(t) and np.isfinite(v))
                    or (v < 0 and not neg_ok)):
                raise ValueError(f"automation {key}: bad breakpoint "
                                 f"({t}, {v})")
        if key == "master.volume":
            pass
        elif subkey is not None and len(parts) == 3:
            self._check_fx_automation(key, subkey, self.fx, "[fx]", pts)
        elif subkey is not None:
            # per-track chain knob (fx.TRACK.EFFECT.KNOB): the same
            # validation against the TRACK's own chain
            tname = parts[1]
            if tname in self.synth_fx:
                chain = self.synth_fx[tname]
            elif tname in self.sampler_fx:
                chain = self.sampler_fx[tname]
            elif tname in self.drum_fx_bus:
                chain = self.drum_fx_bus[tname]
            elif tname in self._baked_fx:
                raise ValueError(
                    f"automation {key}: the [fx.{tname}] chain was baked "
                    f"into the instrument sample at load (no timeline to "
                    f"automate against) — in a song file this routes to a "
                    f"bus automatically (the [automation] section is "
                    f"pre-scanned); programmatically pass bus=True to "
                    f"add_track_fx")
            else:
                raise ValueError(f"automation {key}: no [fx.{tname}] "
                                 f"chain (add it first)")
            self._check_fx_automation(key, subkey, chain,
                                      f"[fx.{tname}]", pts)
        elif (len(parts) == 3 and parts[0] == "track"
              and parts[2] in ("volume", "pan")):
            name = parts[1]
            if (name not in self.instruments and name not in self.synths
                    and name not in self.samplers):
                raise ValueError(f"automation {key}: unknown track "
                                 f"{name!r}")
            if parts[2] == "pan":
                if self.nchannels != 2:
                    raise ValueError(f"automation {key}: pan automation "
                                     f"needs a stereo song")
                for t, v in pts:
                    if not -1.0 <= v <= 1.0:
                        raise ValueError(f"automation {key}: pan values "
                                         f"must be in [-1, 1] (got {v})")
        else:
            raise ValueError(f"automation key {key!r} not understood "
                             f"(master.volume, track.NAME.volume, "
                             f"track.NAME.pan, fx.filter.cutoff, "
                             f"fx.reverb.wet/.dry/.roomsize, "
                             f"fx.chorus.wet/.dry/.rate/.depth, "
                             f"fx.compress.makeup_db/.threshold_db/"
                             f".ratio/.attack/.release, "
                             f"fx.gate.threshold_db, "
                             f"fx.eq.low_db/.mid_db/.high_db, "
                             f"fx.echo.feedback/.wet/.dry, "
                             f"fx.width.amount, "
                             f"fx.limiter.ceiling_db/.release, "
                             f"fx.phaser.wet/.dry/.rate/.depth, or any "
                             f"of those fx knobs track-scoped as "
                             f"fx.TRACK.EFFECT.KNOB)")
        self.automation[key] = pts

    def _check_fx_automation(self, key: str, subkey: str, chain,
                             where: str, pts) -> None:
        """Validate an EFFECT.KNOB curve against a chain (the master [fx]
        or a track's [fx.NAME]): the effect must appear exactly once, and
        knob values must sit in the effect's legal range."""
        target = subkey.split(".")[0]
        nfx = sum(1 for n, _ in chain if n == target)
        if nfx == 0:
            raise ValueError(f"automation {key}: the {where} chain has "
                             f"no {target} entry (add it first)")
        if nfx > 1:
            raise ValueError(f"automation {key}: the {where} chain has "
                             f"several {target} entries — only one "
                             f"can be automated")
        _RANGES = {
            "reverb.roomsize": (0.0, 1.0, "roomsize", "[0, 1]"),
            "echo.feedback": (0.0, 0.95, "feedback", "[0, 0.95]"),
            "width.amount": (0.0, 4.0, "width amount", "[0, 4]"),
            "limiter.ceiling_db": (-60.0, 0.0, "ceiling", "[-60, 0] dB"),
            "phaser.depth": (0.0, 1.0, "depth", "[0, 1]"),
            "tremolo.depth": (0.0, 1.0, "depth", "[0, 1]"),
            "autopan.depth": (0.0, 1.0, "depth", "[0, 1]"),
        }
        _OPEN_RANGES = {
            "limiter.release": (0.0, 5.0, "release", "(0, 5] s"),
            "phaser.rate": (0.0, 20.0, "rate", "(0, 20] Hz"),
            "tremolo.rate": (0.0, 20.0, "rate", "(0, 20] Hz"),
            "autopan.rate": (0.0, 20.0, "rate", "(0, 20] Hz"),
            # strictly positive: the soft-knee form divides by the width
            "compress.knee_db": (0.0, 24.0, "knee", "(0, 24] dB"),
        }
        if subkey in _RANGES:
            lo, hi, what, rng = _RANGES[subkey]
            for t, v in pts:
                if not lo <= v <= hi:
                    raise ValueError(f"automation {key}: {what} must be "
                                     f"in {rng} (got {v})")
        if subkey in _OPEN_RANGES:
            lo, hi, what, rng = _OPEN_RANGES[subkey]
            for t, v in pts:
                if not lo < v <= hi:
                    raise ValueError(f"automation {key}: {what} must be "
                                     f"in {rng} (got {v})")

    def _fx_tickf(self) -> float:
        return self.tick_duration * self.samplerate

    def _track_fx_automation(self, name: str):
        """The track's fx.NAME.EFFECT.KNOB curves, with the track prefix
        stripped to the master-key form the FxChain machinery reads
        (fx.EFFECT.KNOB) — None when the track has no fx automation."""
        pre = f"fx.{name}."
        out = {}
        for k, pts in self.automation.items():
            parts = k.split(".")
            if len(parts) == 4 and k.startswith(pre):
                out[f"fx.{parts[2]}.{parts[3]}"] = pts
        return out or None

    def _track_gain_at(self, name: str, tick: float) -> float:
        pts = self.automation.get(f"track.{name}.volume")
        if not pts:
            return 1.0
        xs = [t for t, _ in pts]
        vs = [v for _, v in pts]
        return float(np.interp(tick, xs, vs))

    def _track_pan_at(self, name: str, tick: float):
        """Pan-automation value at a tick, or None when not automated."""
        pts = self.automation.get(f"track.{name}.pan")
        if not pts:
            return None
        xs = [t for t, _ in pts]
        vs = [v for _, v in pts]
        return float(np.interp(tick, xs, vs))

    def _hit_gain_at(self, name: str, tick: float) -> np.ndarray:
        """Per-channel gain for one hit: velocity x the equal-gain pan
        law (lg = min(1, 1-p), rg = min(1, 1+p) — the voice-bank law),
        so a pan-automated drum hit places like a panned synth voice."""
        vel = self._track_gain_at(name, tick)
        pan = self._track_pan_at(name, tick)
        if pan is None or self.nchannels == 1:
            return np.full(self.nchannels, vel, np.float32)
        return np.asarray([vel * min(1.0, 1.0 - pan),
                           vel * min(1.0, 1.0 + pan)], np.float32)

    def _apply_master_volume(self, x16: jax.Array, n0: int) -> jax.Array:
        pts = self.automation["master.volume"]
        xs = jnp.asarray([t for t, _ in pts], jnp.float32)
        vs = jnp.asarray([v for _, v in pts], jnp.float32)
        tickf = jnp.float32(self.tick_duration * self.samplerate)
        return _master_volume_fn(x16, xs, vs, jnp.int32(n0), tickf)

    def add_fx(self, name: str, ir: Optional[Sample] = None,
               **fx_params) -> None:
        """Append a master-bus effect programmatically (same validation as
        the [fx] ini section; ``ir`` supplies the convolve impulse and is
        converted to the song format like an ini-loaded one)."""
        from .effects import validate_fx_params
        params = dict(fx_params)
        if name == "convolve":
            if ir is None:
                raise ValueError("convolve needs an ir Sample")
            key = f"__ir{len(self.fx_irs)}__"
            self.fx_irs[key] = self._prep_fx_ir(ir)
            params["ir"] = key
        params = validate_fx_params(name, params)
        self._resolve_fx_tempo(name, params)
        self.fx.append((name, params))

    def _check_format(self, name: str, sample: Sample) -> None:
        """All instruments AND samplers must agree on rate/channels — a
        silent mismatch would schedule and bank hits at the wrong rate
        (last-one-wins bug)."""
        if not self.instruments and not self.samplers:
            return
        if (sample.samplerate != self.samplerate
                or sample.nchannels != self.nchannels):
            raise ValueError(
                f"instrument {name!r} is {sample.samplerate} Hz/"
                f"{sample.nchannels}ch but the song's instruments are "
                f"{self.samplerate} Hz/{self.nchannels}ch — convert with "
                f"resample()/stereo() first")

    def add_instrument(self, name: str, sample: Sample) -> None:
        sample = sample.copy().normalize()
        self._check_format(name, sample)
        self.instruments[name] = sample
        self.samplerate = sample.samplerate
        self.nchannels = sample.nchannels

    def add_synth(self, name: str, synthdef: SynthDef) -> None:
        if name in self.samplers:
            raise ValueError(f"synth {name!r}: a sampler with that name "
                             f"already exists (one instrument per track "
                             f"name)")
        self.synths[name] = synthdef

    def add_sampler(self, name: str, sample: Sample,
                    base_note: str = "C4", loop_start: float = -1.0,
                    loop_end: float = -1.0,
                    release: float = 0.01) -> None:
        """Register a pitched sampler instrument: ``sample`` is played
        back at note_freq(note)/note_freq(base_note) for each note token
        on the track (normalized like a drum instrument; must match the
        song's rate/channels).  ``loop_start``/``loop_end`` (seconds)
        define an optional sustain loop (see SamplerDef).

        The per-hit repitch is DELIBERATELY the linear-interp gather
        (reference parity: the upstream sampler repitches via ratecv's
        linear interpolation) — per-note ratios are arbitrary reals, so
        the windowed-sinc hq rung's bounded-rational polyphase form does
        not apply; use ``Sample.resample(quality='hq')`` offline to
        pre-render fixed-ratio variants when imaging matters."""
        if name in self.synths:
            raise ValueError(f"sampler {name!r}: a synth with that name "
                             f"already exists (one instrument per track "
                             f"name)")
        sample = sample.copy().normalize()
        self._check_format(name, sample)
        sd = SamplerDef(sample, note_freq(base_note), loop_start, loop_end,
                        release)
        if (loop_start >= 0.0 or loop_end >= 0.0) and not sd.looped:
            raise ValueError(
                f"sampler {name!r}: loop region [{loop_start}, "
                f"{loop_end}]s is inverted or incomplete (need "
                f"0 <= loop_start < loop_end)")
        if sd.looped:
            n = sample.nframes
            le = int(sd.loop_end * sample.samplerate)
            ls = int(sd.loop_start * sample.samplerate)
            if le > n or le - ls < 2:
                raise ValueError(
                    f"sampler {name!r}: loop region [{sd.loop_start}, "
                    f"{sd.loop_end}]s is outside the sample or too short")
        self.samplers[name] = sd
        self.samplerate = sample.samplerate
        self.nchannels = sample.nchannels

    def add_pattern(self, name: str, tracks: Dict[str, str]) -> None:
        """Drum tracks are contiguous x/. strings (spaces cosmetic); synth
        tracks are whitespace-separated note tokens and keep their spacing."""
        out = {}
        for inst, pat in tracks.items():
            if inst in self.synths or inst in self.samplers:
                out[inst] = " ".join(pat.split())
            else:
                out[inst] = pat.replace(" ", "")
        self.patterns[name] = out

    # -- schedule compilation ----------------------------------------------

    @property
    def tick_duration(self) -> float:
        return 60.0 / self.bpm / self.ticks

    #: drum-pattern dynamics characters (tracker-style accents); any
    #: other non-rest character stays a normal 1.0 hit.  NOTE: a legacy
    #: song that used 'X' or 'o' as plain hit markers (the reference's
    #: own demos used 'x') now renders them accented — documented in
    #: docs/MIGRATION.md
    DRUM_DYNAMICS = {"X": 1.5, "o": 0.5}

    @staticmethod
    def _split_note_token(tok: str):
        """'C4' -> ('C4', 1.0); 'C4@0.5' -> ('C4', 0.5) (inline per-note
        velocity, multiplying any track volume curve)."""
        if "@" in tok:
            note, _, v = tok.partition("@")
            try:
                vel = float(v)
            except ValueError:
                raise ValueError(f"bad note velocity in token {tok!r}")
            if not 0.0 <= vel:
                raise ValueError(f"negative velocity in token {tok!r}")
            return note, vel
        return tok, 1.0

    def _tick_pos(self, tick_idx: int) -> float:
        """Grid tick index -> (possibly swung) tick position."""
        if self.swing and tick_idx % 2:
            return tick_idx + self.swing * 0.5
        return float(tick_idx)

    def pattern_ticks(self, pattern: Dict[str, str]) -> int:
        n = 0
        for inst, p in pattern.items():
            n = max(n, len(p.split())
                    if (inst in self.synths or inst in self.samplers)
                    else len(p))
        return n

    def compile_schedule(self) -> HitSchedule:
        """Song -> flat hit schedule + padded device instrument bank."""
        names = sorted(self.instruments)
        index = {n: i for i, n in enumerate(names)}
        arrays = [self.instruments[n].get_frame_array().astype(np.int32)
                  for n in names]
        lmax = max((len(a) for a in arrays), default=1)
        C = self.nchannels
        bank = np.zeros((max(len(arrays), 1), lmax, C), np.int32)
        lengths = np.zeros(max(len(arrays), 1), np.int64)
        for i, a in enumerate(arrays):
            bank[i, :len(a)] = a
            lengths[i] = len(a)

        hits: List[Tuple[int, int]] = []
        gains: List[float] = []
        tickf = self.tick_duration * self.samplerate
        bar_start_ticks = 0
        for pname in self.pattern_sequence:
            pattern = self.patterns[pname]
            nticks = self.pattern_ticks(pattern)
            for inst, patstr in pattern.items():
                if inst in self.synths or inst in self.samplers:
                    continue
                if inst not in index:
                    raise KeyError(f"pattern {pname} uses unknown instrument {inst}")
                for t, ch in enumerate(patstr):
                    if ch not in ". ":
                        start = int(self._tick_pos(bar_start_ticks + t)
                                    * tickf)
                        hits.append((index[inst], start))
                        dyn = np.float32(self.DRUM_DYNAMICS.get(ch, 1.0))
                        gains.append(dyn * self._hit_gain_at(
                            inst, bar_start_ticks + t))
            bar_start_ticks += nticks
        hits_arr = np.asarray(hits, np.int64).reshape(-1, 2)
        return HitSchedule(bank, lengths, names, hits_arr,
                           self.samplerate, C,
                           gains=np.asarray(gains, np.float32)
                           .reshape(-1, C))

    def compile_synth_voices(self, return_tracks: bool = False):
        """All melodic notes of the song -> one flat Voice list.

        A note token starts a voice at its tick; following '-' tokens tie
        (extend the gate); '.'-only tokens are rests.  With
        ``return_tracks`` also returns the aligned list of synth-track
        names (one per voice — the per-track fx path groups on it).

        Portamento (``glide =`` on the [synth.*] section): every note
        after a track's first slides from the PREVIOUS note's pitch over
        the configured seconds (mono-synth always-glide, across rests) —
        the bank renders it as an exact integer-DDS chirp, so offline,
        streaming, and mesh paths inherit it from this ONE compile.
        """
        voices: List[Voice] = []
        tracks: List[str] = []
        last_freq: Dict[str, float] = {}
        tick = self.tick_duration
        bar_start = 0
        for pname in self.pattern_sequence:
            pattern = self.patterns[pname]
            nticks = self.pattern_ticks(pattern)
            for inst, patstr in pattern.items():
                if inst not in self.synths:
                    continue
                sd = self.synths[inst]
                tokens = patstr.split()
                t = 0
                while t < len(tokens):
                    tok = tokens[t]
                    if tok == "-" or set(tok) <= {"."}:
                        t += 1
                        continue
                    held = 1
                    while t + held < len(tokens) and tokens[t + held] == "-":
                        held += 1
                    tracks.append(inst)
                    note_pan = self._track_pan_at(inst, bar_start + t)
                    note, vel = self._split_note_token(tok)
                    freq = note_freq(note)
                    prev = last_freq.get(inst)
                    glide_from = (prev if sd.glide > 0.0 and prev is not None
                                  and prev != freq else 0.0)
                    last_freq[inst] = freq
                    voices.append(Voice(
                        wave=sd.wave,
                        frequency=freq,
                        amplitude=sd.amplitude * vel
                        * self._track_gain_at(inst, bar_start + t),
                        pan=sd.pan if note_pan is None else note_pan,
                        start=self._tick_pos(bar_start + t) * tick,
                        duration=held * tick,
                        attack=sd.attack, decay=sd.decay,
                        sustain_level=sd.sustain_level, release=sd.release,
                        fm_frequency=sd.fm_frequency, fm_depth=sd.fm_depth,
                        pulse_width=sd.pulse_width,
                        harmonics=sd.harmonics,
                        table=sd.table,
                        damping=sd.damping,
                        seed=sd.seed,
                        glide_from=glide_from,
                        glide_time=sd.glide if glide_from else 0.0,
                    ))
                    t += held
            bar_start += nticks
        if return_tracks:
            return voices, tracks
        return voices

    def compile_pitched_hits(self):
        """All sampler-track notes -> flat pitched-hit arrays plus the
        padded sampler bank: (bank [P, Lmax, 2C] i32 pair-packed,
        lens [P] i64, idx [N] i32, start [N] i64, rate [N] f32,
        gains [N, C] f32, loopf [N, 5] f32, loopu [N, 2] u32).

        rate = note_freq(note)/base_freq; '.' tokens are rests.  For a
        LOOPED sampler a note's '-' ties set its gate (sustain) length;
        loopf rows are (flag, loop_start, loop_len, gate_total, 1/fade)
        in source/output frames and loopu rows are the loop-phase DDS
        (increment, initial phase) — see _pitched_chunk_body.  One-shot
        samplers ignore ties (the full sample always plays out)."""
        names = sorted(self.samplers)
        index = {n: i for i, n in enumerate(names)}
        arrays = [self.samplers[n].sample.get_frame_array().astype(np.int32)
                  for n in names]
        lmax = max((len(a) for a in arrays), default=1)
        C = self.nchannels
        bank = np.zeros((max(len(arrays), 1), lmax, C), np.int32)
        lens = np.zeros(max(len(arrays), 1), np.int64)
        for i, a in enumerate(arrays):
            bank[i, :len(a)] = a
            lens[i] = len(a)
        # pair-pack for the device kernel: position i holds
        # (wav[i], wav[i+1]) so the interp needs ONE gather per read
        bank = np.concatenate(
            [bank, np.concatenate([bank[:, 1:], bank[:, -1:]], axis=1)],
            axis=2)
        idx: List[int] = []
        starts: List[int] = []
        rates: List[float] = []
        gains: List[np.ndarray] = []
        loopf: List[tuple] = []
        loopu: List[tuple] = []
        ptracks: List[str] = []
        tickf = self.tick_duration * self.samplerate
        sr = self.samplerate
        bar_start = 0
        for pname in self.pattern_sequence:
            pattern = self.patterns[pname]
            nticks = self.pattern_ticks(pattern)
            for inst, patstr in pattern.items():
                if inst not in self.samplers or inst in self.synths:
                    continue
                sd = self.samplers[inst]
                tokens = patstr.split()
                t = 0
                while t < len(tokens):
                    tok = tokens[t]
                    if tok == "-" or set(tok) <= {"."}:
                        t += 1
                        continue
                    held = 1
                    while t + held < len(tokens) and tokens[t + held] == "-":
                        held += 1
                    note, vel = self._split_note_token(tok)
                    rate = note_freq(note) / sd.base_freq
                    ptracks.append(inst)
                    idx.append(index[inst])
                    starts.append(int(self._tick_pos(bar_start + t) * tickf))
                    rates.append(rate)
                    gains.append(np.float32(vel)
                                 * self._hit_gain_at(inst, bar_start + t))
                    if sd.looped:
                        ls = float(int(sd.loop_start * sr))
                        le = float(int(sd.loop_end * sr))
                        lp = le - ls
                        fade = max(1, int(sd.release * sr))
                        gate_total = held * tickf + fade
                        inc = int(round(rate / lp * 4294967296.0))                             & 0xFFFFFFFF
                        p0 = int(round(((-ls / lp) % 1.0)
                                       * 4294967296.0)) & 0xFFFFFFFF
                        loopf.append((1.0, ls, lp, gate_total, 1.0 / fade))
                        loopu.append((inc, p0))
                    else:
                        loopf.append((0.0, 0.0, 1.0, 0.0, 1.0))
                        loopu.append((0, 0))
                    t += held
            bar_start += nticks
        self._last_pitched_tracks = ptracks   # aligned with the hit rows
        return (bank, lens, np.asarray(idx, np.int32),
                np.asarray(starts, np.int64),
                np.asarray(rates, np.float32),
                np.asarray(gains, np.float32).reshape(-1, C),
                np.asarray(loopf, np.float32).reshape(-1, 5),
                np.asarray(loopu, np.uint32).reshape(-1, 2))

    def _pitched_end_frames(self, lens, idx, starts, rates,
                            loopf=None) -> np.ndarray:
        """Per-hit end frame (exclusive): one-shot hits end when
        n_rel * rate passes len-1; looped hits end at their gate_total
        (tie length + release fade)."""
        if len(idx) == 0:
            return np.zeros(0, np.int64)
        # +2 frames of slack: the device mask decides in f32; a frame the
        # host f64 bound would exclude must still be inside the rendered
        # / bucketed range (it contributes zeros when masked out)
        ends = (starts + np.floor((lens[idx] - 1)
                                  / np.maximum(rates, 1e-9)).astype(np.int64)
                + 2)
        if loopf is not None and len(loopf):
            looped = loopf[:, 0] > 0
            ends = np.where(looped,
                            starts + loopf[:, 3].astype(np.int64) + 2,
                            ends)
        return ends

    def _bucket_pitched(self, starts, ends, nchunks: int, cf: int,
                        start_frame: int, ndev: int = 0):
        """Per-chunk hit-row indices for the pitched path (chunk ci covers
        [start_frame + ci*cf, ...)); returns (per_chunk lists, K)."""
        first_c = np.maximum(0, (starts - start_frame) // cf)
        last_c = np.minimum(nchunks - 1, (ends - 1 - start_frame) // cf)
        per_chunk: List[List[int]] = [[] for _ in range(nchunks)]
        for h in range(len(starts)):
            for c in range(int(first_c[h]), int(last_c[h]) + 1):
                per_chunk[c].append(h)
        K = max((len(h) for h in per_chunk), default=1) or 1
        if ndev:
            K += -K % ndev
        return per_chunk, K

    def _pitched_rows(self, per_chunk, K, idx, starts, rates, gains,
                      loopf, loopu):
        """Pad bucketed hits into dense [nchunks, K(, ...)] row arrays."""
        nchunks = len(per_chunk)
        C = self.nchannels
        idx_b = np.zeros((nchunks, K), np.int32)
        start_b = np.zeros((nchunks, K), np.int32)
        rate_b = np.ones((nchunks, K), np.float32)
        gain_b = np.zeros((nchunks, K, C), np.float32)
        valid_b = np.zeros((nchunks, K), bool)
        loopf_b = np.zeros((nchunks, K, 5), np.float32)
        loopf_b[:, :, 2] = 1.0
        loopf_b[:, :, 4] = 1.0
        loopu_b = np.zeros((nchunks, K, 2), np.uint32)
        for c, hs in enumerate(per_chunk):
            for j, h in enumerate(hs[:K]):
                idx_b[c, j] = idx[h]
                start_b[c, j] = starts[h]
                rate_b[c, j] = rates[h]
                gain_b[c, j] = gains[h]
                loopf_b[c, j] = loopf[h]
                loopu_b[c, j] = loopu[h]
                valid_b[c, j] = True
        return idx_b, start_b, rate_b, gain_b, valid_b, loopf_b, loopu_b

    def _pitched_mix(self, bank, lens, idx, starts, rates, gains,
                     loopf, loopu, ends, total: int, mesh=None,
                     cf: int = 32768) -> jax.Array:
        """Offline pitched-sampler mixdown: ONE scan over chunks (rows
        bucketed per chunk); with ``mesh`` the rows shard over devices
        and merge with one int32 psum (bit-exact — the per-hit rint
        happens before the add)."""
        nchunks = -(-total // cf)
        ndev = int(mesh.devices.size) if mesh is not None else 0
        per_chunk, K = self._bucket_pitched(starts, ends, nchunks, cf, 0,
                                            ndev)
        rows = self._pitched_rows(per_chunk, K, idx, starts, rates, gains,
                                  loopf, loopu)
        c0s = np.arange(nchunks, dtype=np.int32) * cf
        lmax = int(bank.shape[1])
        lens32 = jnp.asarray(np.asarray(lens, np.int64).astype(np.int32))
        if mesh is not None:
            from .parallel.mesh import pitched_song_sharded
            out = pitched_song_sharded(
                jnp.asarray(bank), lens32,
                *(jnp.asarray(r) for r in rows),
                jnp.asarray(c0s), cf, lmax, mesh)
        else:
            fn = _pitched_song_fn(cf, lmax)
            out = fn(jnp.asarray(bank), lens32,
                     *(jnp.asarray(r) for r in rows),
                     jnp.asarray(c0s), nchunks=nchunks)
        return out[:total]

    def _synth_end_frame(self, voices: Sequence[Voice]) -> int:
        if not voices:
            return 0
        # envelope end = attack + decay + max(gate - attack - decay, 0) + release
        return max(
            int((v.start + v.attack + v.decay
                 + max(v.duration - v.attack - v.decay, 0.0)
                 + v.release) * self.samplerate) + 1
            for v in voices)

    def export_midi(self, bpm: Optional[int] = None) -> bytes:
        """Serialize the song to a format-0 SMF byte string.

        Melodic synth notes map to their nearest MIDI note per synth track
        (one channel each); drum hits go to the GM percussion channel 10.
        """
        import math as _math
        from .midi import MidiNote, write_midi
        notes = []
        synth_channels = {name: i if i < 9 else i + 1
                          for i, name in enumerate(sorted(self.synths))}
        tick = self.tick_duration
        bar_start = 0
        drum_keys = {name: 35 + i for i, name in
                     enumerate(sorted(self.instruments))}
        for pname in self.pattern_sequence:
            pattern = self.patterns[pname]
            nticks = self.pattern_ticks(pattern)
            for inst, patstr in pattern.items():
                if inst in self.synths:
                    continue
                if inst in self.samplers:
                    # pitched sampler notes export melodically on their
                    # own channel (after the synth channels)
                    base = len(self.synths)
                    si = sorted(self.samplers).index(inst) + base
                    chn = si if si < 9 else si + 1
                    sd = self.samplers[inst]
                    tokens = patstr.split()
                    t = 0
                    while t < len(tokens):
                        tok = tokens[t]
                        if tok == "-" or set(tok) <= {"."}:
                            t += 1
                            continue
                        held = 1
                        while (t + held < len(tokens)
                               and tokens[t + held] == "-"):
                            held += 1
                        tok, nv = self._split_note_token(tok)
                        f = note_freq(tok)
                        note = int(round(69 + 12 * _math.log2(f / 440.0)))
                        vel = max(1, min(127, int(round(
                            100 * nv * self._track_gain_at(
                                inst, bar_start + t)))))
                        if sd.looped:
                            # a looped note holds for its tie length
                            dur = held * tick
                        else:
                            dur = ((sd.sample.nframes / self.samplerate)
                                   / max(f / sd.base_freq, 1e-9))
                        notes.append(MidiNote(
                            self._tick_pos(bar_start + t) * tick, dur,
                            max(0, min(127, note)), vel, min(chn, 15)))
                        t += held
                    continue
                for t, ch in enumerate(patstr):
                    if ch not in ". ":
                        # velocity automation + accent chars reach the
                        # exported file (synth notes carry them in their
                        # amplitudes)
                        dyn = self.DRUM_DYNAMICS.get(ch, 1.0)
                        vel = max(1, min(127, int(round(
                            100 * dyn
                            * self._track_gain_at(inst, bar_start + t)))))
                        notes.append(MidiNote(
                            self._tick_pos(bar_start + t) * tick,
                            tick * 0.9, drum_keys[inst], vel, 9))
            bar_start += nticks
        for v in self.compile_synth_voices():
            # invert note_to_freq: nearest equal-tempered note
            note = int(round(69 + 12 * _math.log2(max(v.frequency, 1e-3) / 440.0)))
            ch = 0
            for name, c in synth_channels.items():
                if self.synths[name].wave == v.wave:
                    ch = c
                    break
            vel = max(1, min(127, int(round(v.amplitude / 0.4 * 100))))
            notes.append(MidiNote(v.start, v.duration, max(0, min(127, note)),
                                  vel, ch))
        notes.sort(key=lambda n: n.start)
        return write_midi(notes, bpm=bpm or self.bpm)

    def _check_synth_format(self, voices: Sequence[Voice]) -> None:
        """Every path that renders synth voices (single-device, sharded
        offline, sharded streaming) shares this guard."""
        if voices and self.nchannels != 2:
            raise ValueError("synth tracks require a stereo song format")

    def _fx_synth_tracks(self, vtracks: Sequence[str]) -> List[str]:
        """The fx'd synth tracks that actually sound in this song, in
        their stable (sorted) segment order."""
        present = set(vtracks)
        return [n for n in sorted(self.synth_fx) if n in present]

    def _synth_fx_tail(self, vtracks: Sequence[str]) -> int:
        """Longest per-synth-track chain decay tail, in frames."""
        names = self._fx_synth_tracks(vtracks)
        if not names:
            return 0
        from .effects import chain_tail_frames
        return max(chain_tail_frames(self.synth_fx[n], self.samplerate,
                                     self.fx_irs) for n in names)

    def _fx_sampler_tracks(self, ptracks: Sequence[str]) -> List[str]:
        present = set(ptracks)
        return [n for n in sorted(self.sampler_fx) if n in present]

    def _sampler_fx_masks(self, ptracks: Sequence[str]):
        """(mask, track-or-None) groups for the pitched paths: one clean
        group for un-fx'd tracks plus a group per fx'd sampler track.
        ONE place owns the grouping, shared by mix() and mix_generator().
        Under ``mesh=`` each group's hit rows shard over the devices and
        merge with a bit-exact int32 psum, so an fx'd track's bus — and
        its chain output — is IDENTICAL to the single-device render."""
        ptr = np.asarray(ptracks)
        sfx = self._fx_sampler_tracks(ptracks)
        if not sfx:
            return [(np.ones(len(ptr), bool), None)]
        masks = []
        clean = ~np.isin(ptr, sfx)
        if clean.any():
            masks.append((clean, None))
        masks += [(ptr == n, n) for n in sfx]
        return masks

    def _drum_bus_tail(self) -> int:
        """Longest drum-bus chain decay tail, in frames."""
        if not self.drum_fx_bus:
            return 0
        from .effects import chain_tail_frames
        return max(chain_tail_frames(fx, self.samplerate, self.fx_irs)
                   for fx in self.drum_fx_bus.values())

    def _sampler_fx_tail(self, ptracks: Sequence[str]) -> int:
        """Longest per-sampler-track chain decay tail, in frames."""
        names = self._fx_sampler_tracks(ptracks)
        if not names:
            return 0
        from .effects import chain_tail_frames
        return max(chain_tail_frames(self.sampler_fx[n], self.samplerate,
                                     self.fx_irs) for n in names)

    def _drum_bus_split(self, sched: HitSchedule):
        """(main_mask [H] bool, {name: hit_mask}) — hits of drum-bus
        instruments leave the main scatter and render as their own
        buses."""
        main = np.ones(len(sched.hits), bool)
        buses = {}
        for name in sorted(self.drum_fx_bus):
            if name not in sched.instruments:
                continue
            idx = sched.instruments.index(name)
            m = sched.hits[:, 0] == idx
            if m.any():
                buses[name] = m
                main &= ~m
        return main, buses

    def _used_sidechains(self) -> set:
        """Instrument names referenced by ``compress sidechain=`` entries
        across the master and per-track chains."""
        names = set()
        for chain in ([self.fx] + list(self.synth_fx.values())
                      + list(self.sampler_fx.values())
                      + list(self.drum_fx_bus.values())):
            for n, p in chain:
                if n == "compress" and p.get("sidechain"):
                    names.add(p["sidechain"])
        return names

    def _sidechain_hit_rows(self, name: str, sched=None):
        """(bank jnp, lmax, starts [H], gains [H, C], length) for one
        instrument's own hits — the ducking KEY source.  Pass a
        precompiled ``sched`` when building several providers (one
        schedule compile, one bank materialization)."""
        if sched is None:
            sched = self.compile_schedule()
        if name not in sched.instruments:
            raise ValueError(
                f"compress sidechain={name!r}: unknown sample instrument "
                f"(sidechain keys come from [instruments] tracks)")
        idx = sched.instruments.index(name)
        m = sched.hits[:, 0] == idx
        return (jnp.asarray(sched.bank), int(sched.bank.shape[1]), idx,
                sched.hits[m, 1], sched.gains[m],
                int(sched.lengths[idx]))

    def _sidechain_key_samples(self, total: int) -> Dict[str, Sample]:
        """Offline KEY buses: {name: int16 Sample of length ``total``} of
        each referenced instrument's own hits (velocity/pan automation
        included — what the listener would hear of that track)."""
        out: Dict[str, Sample] = {}
        names = self._used_sidechains()
        sched = self.compile_schedule() if names else None
        for name in names:
            bank, _lmax, idx, starts, gains, _length = \
                self._sidechain_hit_rows(name, sched)
            acc = _mixdown_kernel(
                bank, jnp.asarray(np.full(len(starts), idx, np.int32)),
                jnp.asarray(np.asarray(starts, np.int64).astype(np.int32)),
                total, jnp.asarray(gains))
            k16 = jnp.clip(acc, -32768, 32767).astype(jnp.int16)
            out[name] = Sample.from_jax(k16, self.samplerate, 2,
                                        name=f"key:{name}")
        return out

    def _sidechain_key_fns(self) -> Dict[str, "object"]:
        """Streaming KEY providers: {name: key_fn(n0, n) -> int16 [n, C]}
        — stateless in the absolute frame index (seek-exact), hit rows
        padded to a power of two so chunk-size recompiles stay bounded."""
        fns: Dict[str, "object"] = {}
        C = self.nchannels
        names = self._used_sidechains()
        sched = self.compile_schedule() if names else None
        for name in names:
            bank, lmax, idx, starts, gains, length = \
                self._sidechain_hit_rows(name, sched)
            starts = np.asarray(starts, np.int64)
            gains = np.asarray(gains, np.float32).reshape(-1, C)

            def key_fn(n0, n, idx=idx, starts=starts, gains=gains,
                       length=length, bank=bank, lmax=lmax):
                act = np.nonzero((starts < n0 + n)
                                 & (starts + length > n0))[0]
                K = 1 << max(0, max(len(act), 1) - 1).bit_length()
                pad = K - len(act)
                inst_k = jnp.asarray(np.full(K, idx, np.int32))
                start_k = jnp.asarray(np.concatenate(
                    [starts[act], np.zeros(pad, np.int64)])
                    .astype(np.int32))
                valid_k = jnp.asarray(np.concatenate(
                    [np.ones(len(act), bool), np.zeros(pad, bool)]))
                gain_k = jnp.asarray(np.concatenate(
                    [gains[act], np.zeros((pad, C), np.float32)]))
                fn = _stream_chunk_fn(int(n), lmax)
                acc = fn(bank, inst_k, start_k, valid_k, gain_k,
                         jnp.int32(n0))
                return jnp.clip(acc, -32768, 32767).astype(jnp.int16)

            fns[name] = key_fn
        return fns

    def _synth_fx_groups(self, voices: Sequence[Voice],
                         vtracks: Sequence[str], chunk_frames: int):
        """Pack ALL synth voices into ONE grouped bank whose pan matmul
        scatters each voice onto its track's stereo bus: segment 0 is the
        shared clean bus (tracks without fx), segments 1..N the fx'd
        tracks in ``_fx_synth_tracks`` order.  Still a single device
        render per chunk/song."""
        fx_tracks = self._fx_synth_tracks(vtracks)
        seg_index = {n: i + 1 for i, n in enumerate(fx_tracks)}
        tags = [seg_index.get(t, 0) for t in vtracks]
        vp, layout, seg = pack_voices(voices, self.samplerate,
                                      num_harmonics=8, sort_by_wave=True,
                                      tags=tags)
        bank = VoiceBank.for_voices(voices, self.samplerate,
                                    chunk_frames=chunk_frames,
                                    num_harmonics=8, layout=layout,
                                    nvoices=layout.nvoices)
        return bank, vp, seg, fx_tracks

    def _add_synth_buses(self, out32: jax.Array, buses: jax.Array,
                         fx_tracks: Sequence[str], total: int,
                         sidechain_keys=None) -> jax.Array:
        """Fold a grouped bus stack [total, nseg, 2] into the int32 mix:
        bus 0 (clean) adds directly; each fx'd track's bus quantizes to
        int16 (exactly what a banked sample instrument would be), runs its
        chain over the already-tail-padded song length, and joins the mix.
        ONE place owns this, shared by the single-device and mesh grouped
        offline paths."""
        from .effects import run_fx_chain_ops
        out32 = out32 + jnp.rint(
            buses[:, 0] * jnp.float32(32767.0)).astype(jnp.int32)
        for i, tname in enumerate(fx_tracks):
            t16 = jnp.clip(
                jnp.rint(buses[:, i + 1] * jnp.float32(32767.0)),
                -32768, 32767).astype(jnp.int16)
            ts = Sample.from_jax(t16, self.samplerate, 2,
                                 name=f"track:{tname}")
            run_fx_chain_ops(ts, self.synth_fx[tname], self.fx_irs,
                             automation=self._track_fx_automation(tname),
                             tickf=self._fx_tickf(),
                             sidechain_keys=sidechain_keys)
            out32 = out32 + ts.jax_frames[:total].astype(jnp.int32)
        return out32

    def _synth_bank(self, voices: Sequence[Voice], chunk_frames: int):
        if self.nchannels != 2:
            raise ValueError("synth tracks require a stereo song format")
        vp, layout = pack_voices(voices, self.samplerate, num_harmonics=8,
                                 sort_by_wave=True)
        bank = VoiceBank.for_voices(voices, self.samplerate,
                                    chunk_frames=chunk_frames,
                                    num_harmonics=8, layout=layout,
                                    nvoices=layout.nvoices)
        return bank, vp

    def duration_frames(self, tail_seconds: float = 0.0) -> int:
        """Total frames of song content (schedule end + optional tail).

        With the default ``tail_seconds=0`` this is exactly where
        ``mix_generator`` ends, so it is the valid ``start_frame`` bound
        for seeking; ``mix()`` adds its own ``tail_seconds`` (default
        0.3 s) on top."""
        sched = self.compile_schedule()
        voices, vtracks = self.compile_synth_voices(return_tracks=True)
        (_, plens, pidx, pstart, prate, _pg, ploopf,
         _plu) = self.compile_pitched_hits()
        pends = self._pitched_end_frames(plens, pidx, pstart, prate, ploopf)
        pitched_end = int(pends.max()) if len(pends) else 0
        return (max(sched.total_frames, self._synth_end_frame(voices),
                    pitched_end)
                + max(self._synth_fx_tail(vtracks),
                      self._sampler_fx_tail(self._last_pitched_tracks),
                      self._drum_bus_tail())
                + int(tail_seconds * self.samplerate))

    # -- offline mixdown ------------------------------------------------------

    def mix(self, normalize: bool = True, tail_seconds: float = 0.3,
            mesh=None, max_frames: Optional[int] = None) -> Sample:
        """Offline song mixdown as one batched device render.

        Sums all hits in a widened int32 buffer (overflow-free headroom, the
        reference's make_32bit trick), then narrows: with ``normalize`` the
        peak is amplified to full scale first (make_16bit semantics),
        otherwise values saturate at int16.

        With ``mesh`` (a 1-D ``jax.sharding.Mesh``) the whole mixdown runs
        data-parallel over the devices: sample hits shard over the mesh and
        merge with one int32 ``psum`` (bit-exact — integer add is
        associative), and synth voices shard over the same axis with an f32
        ``psum`` per chunk (≤1 LSB vs single-device from summation order).
        """
        sched = self.compile_schedule()
        voices, vtracks = self.compile_synth_voices(return_tracks=True)
        self._check_synth_format(voices)
        fx_tracks = self._fx_synth_tracks(vtracks)
        (pbank, plens, pidx, pstart, prate, pgains, ploopf,
         ploopu) = self.compile_pitched_hits()
        pends = self._pitched_end_frames(plens, pidx, pstart, prate, ploopf)
        pitched_end = int(pends.max()) if len(pends) else 0
        total = max(sched.total_frames, self._synth_end_frame(voices),
                    pitched_end) \
            + max(self._synth_fx_tail(vtracks),
                  self._sampler_fx_tail(self._last_pitched_tracks),
                  self._drum_bus_tail()) \
            + int(tail_seconds * self.samplerate)
        if max_frames is not None:
            # a caller-imposed limit (the render server's DoS bound) must
            # count the master chain's decay tails too — an [fx] reverb
            # tail extends the render arbitrarily past the schedule end
            from .effects import chain_tail_frames
            with_tail = total + chain_tail_frames(self.fx, self.samplerate,
                                                  self.fx_irs)
            if with_tail > max_frames:
                raise ValueError(
                    f"mixdown of {with_tail} frames "
                    f"({with_tail / self.samplerate:.1f}s incl. fx tails) "
                    f"exceeds the caller's limit of {max_frames} frames")
        if len(sched.hits) == 0 and not voices and len(pidx) == 0:
            return Sample.from_raw_frames(b"", 2, self.samplerate, self.nchannels)
        #: ducking KEY buses (compress sidechain= entries), length-`total`
        sc_keys = (self._sidechain_key_samples(total)
                   if self._used_sidechains() else {})
        out32 = jnp.zeros((total, self.nchannels), jnp.int32)
        if len(pidx):
            from .effects import run_fx_chain_ops
            for m, tname in self._sampler_fx_masks(
                    self._last_pitched_tracks):
                bus32 = self._pitched_mix(
                    pbank, plens, pidx[m], pstart[m], prate[m],
                    pgains[m], ploopf[m], ploopu[m], pends[m], total,
                    mesh=mesh)
                if tname is None:
                    out32 = out32 + bus32
                    continue
                t16 = jnp.clip(bus32, -32768, 32767).astype(jnp.int16)
                ts = Sample.from_jax(t16, self.samplerate, 2,
                                     name=f"strack:{tname}")
                run_fx_chain_ops(ts, self.sampler_fx[tname], self.fx_irs,
                                 automation=self._track_fx_automation(
                                     tname),
                                 tickf=self._fx_tickf(),
                                 sidechain_keys=sc_keys)
                out32 = out32 + ts.jax_frames[:total].astype(jnp.int32)
        if len(sched.hits):
            main_m, drum_buses = self._drum_bus_split(sched)
            if mesh is not None:
                from .parallel.mesh import scatter_mix_sharded
                if main_m.any():
                    out32 = out32 + scatter_mix_sharded(
                        jnp.asarray(sched.bank),
                        sched.hits[main_m, 0].astype(np.int32),
                        sched.hits[main_m, 1].astype(np.int32), total,
                        mesh, hits_gain=sched.gains[main_m])
            elif main_m.any():
                out32 = out32 + _mixdown_kernel(
                    jnp.asarray(sched.bank),
                    jnp.asarray(sched.hits[main_m, 0].astype(np.int32)),
                    jnp.asarray(sched.hits[main_m, 1].astype(np.int32)),
                    total, jnp.asarray(sched.gains[main_m]))
            from .effects import run_fx_chain_ops
            for name, m in drum_buses.items():
                acc = _mixdown_kernel(
                    jnp.asarray(sched.bank),
                    jnp.asarray(sched.hits[m, 0].astype(np.int32)),
                    jnp.asarray(sched.hits[m, 1].astype(np.int32)),
                    total, jnp.asarray(sched.gains[m]))
                ds = Sample.from_jax(
                    jnp.clip(acc, -32768, 32767).astype(jnp.int16),
                    self.samplerate, 2, name=f"dbus:{name}")
                run_fx_chain_ops(ds, self.drum_fx_bus[name], self.fx_irs,
                                 automation=self._track_fx_automation(
                                     name),
                                 tickf=self._fx_tickf(),
                                 sidechain_keys=sc_keys)
                out32 = out32 + ds.jax_frames[:total].astype(jnp.int32)
        if voices:
            if mesh is not None and fx_tracks:
                # grouped render OVER THE MESH: voices (with their segment
                # tags) shard across devices; one f32 psum per chunk merges
                # the per-track bus stack, then each fx'd bus runs its
                # chain on the replicated result — same bus processing as
                # the single-device grouped path (≤1 LSB per bus from
                # cross-shard summation order)
                from .parallel.mesh import (render_song_grouped_sharded,
                                            song_synth_shards_grouped)
                vp, seg, uw, ufm, ugl = song_synth_shards_grouped(
                    voices, vtracks, fx_tracks, self.samplerate, mesh)
                buses = render_song_grouped_sharded(
                    vp, seg, len(fx_tracks) + 1, total, self.samplerate,
                    chunk_frames=32768, num_harmonics=8, mesh=mesh,
                    used_waves=uw, use_fm=ufm, use_glide=ugl)
                out32 = self._add_synth_buses(out32, buses, fx_tracks,
                                              total, sc_keys)
            elif mesh is not None:
                from .parallel.mesh import (render_song_sharded,
                                            song_synth_shards)
                vp, uw, ufm, ugl, ub, ua, ud = song_synth_shards(
                    voices, self.samplerate, mesh)
                stereo = render_song_sharded(
                    vp, total, self.samplerate, chunk_frames=32768,
                    num_harmonics=8, mesh=mesh, used_waves=uw, use_fm=ufm,
                    use_glide=ugl, use_bend=ub, use_amp=ua, use_dmod=ud)
                out32 = out32 + jnp.rint(
                    stereo * jnp.float32(32767.0)).astype(jnp.int32)
            elif fx_tracks:
                # grouped render: one program yields the clean bus plus a
                # stereo bus per fx'd track; each bus quantizes to int16
                # (exactly what a banked sample instrument would be) and
                # its chain runs over the already-tail-padded song length
                bank, vp, seg, fx_tracks = self._synth_fx_groups(
                    voices, vtracks, chunk_frames=32768)
                buses = bank.render_song_grouped(vp, seg,
                                                 len(fx_tracks) + 1, total)
                out32 = self._add_synth_buses(out32, buses, fx_tracks,
                                              total, sc_keys)
            else:
                bank, vp = self._synth_bank(voices, chunk_frames=32768)
                stereo = bank.render_song(vp, total)
                out32 = out32 + jnp.rint(
                    stereo * jnp.float32(32767.0)).astype(jnp.int32)
        mv = self.automation.get("master.volume")
        if self.fx or mv:
            # the master chain processes the int16-saturated mix — the SAME
            # signal the streaming path feeds its chunk processors, so fx
            # thresholds mean the same thing on both paths — and
            # normalization happens LAST (mastering order: volume
            # automation, chain, then maximize).  The staged ops fuse into
            # the mixdown program.
            from .effects import apply_fx_sample
            out16 = jnp.clip(out32, -32768, 32767).astype(jnp.int16)
            if mv:
                out16 = self._apply_master_volume(out16, 0)
            mixed = Sample.from_jax(out16, self.samplerate, 2, name="mixdown")
            if self.fx:
                apply_fx_sample(mixed, self.fx, self.fx_irs,
                                automation=self.automation,
                                tickf=self.tick_duration * self.samplerate,
                                sidechain_keys=sc_keys)
            if normalize:
                mixed.amplify_max()
            return mixed
        if normalize:
            mixed = Sample.from_jax(out32, self.samplerate, 4, name="mixdown")
            return mixed.make_16bit(maximize_amplitude=True)
        out16 = jnp.clip(out32, -32768, 32767).astype(jnp.int16)
        return Sample.from_jax(out16, self.samplerate, 2, name="mixdown")

    def mix_stems(self, tail_seconds: float = 0.3) -> Dict[str, Sample]:
        """Render every track as its own stereo int16 STEM (the DAW
        export convention): one Sample per drum instrument, synth track,
        and sampler track, all of identical length, with per-track fx
        applied.  The master [fx] chain, master.volume automation, and
        normalization are NOT applied — stems are pre-master by
        definition; summing them reproduces ``mix(normalize=False)``'s
        pre-master bus (exactly for the integer drum/sampler stems;
        within 1 LSB for synth stems, whose grouped pan matmul sums
        voices per track instead of all at once) — PROVIDED no single
        track's solo bus exceeds int16 full scale: each stem clips
        independently at ±32767, while mix() sums every track in int32
        headroom and clips once, so a clipping solo bus diverges from
        the mix by the clipped amount.

        Track fx: a drum instrument's [fx.NAME] chain is already baked
        into its banked WAV; synth/sampler chains run on the track's own
        bus exactly as in ``mix()``.
        """
        sched = self.compile_schedule()
        voices, vtracks = self.compile_synth_voices(return_tracks=True)
        self._check_synth_format(voices)
        (pbank, plens, pidx, pstart, prate, pgains, ploopf,
         ploopu) = self.compile_pitched_hits()
        pends = self._pitched_end_frames(plens, pidx, pstart, prate, ploopf)
        pitched_end = int(pends.max()) if len(pends) else 0
        total = max(sched.total_frames, self._synth_end_frame(voices),
                    pitched_end) \
            + max(self._synth_fx_tail(vtracks),
                  self._sampler_fx_tail(self._last_pitched_tracks),
                  self._drum_bus_tail()) \
            + int(tail_seconds * self.samplerate)
        if total == 0:
            return {}
        sc_keys = (self._sidechain_key_samples(total)
                   if self._used_sidechains() else {})
        from .effects import run_fx_chain_ops
        stems: Dict[str, Sample] = {}

        # drum instruments: each one's own scatter (velocity/pan incl.)
        for i, name in enumerate(sched.instruments):
            m = sched.hits[:, 0] == i
            if not m.any():
                continue
            acc = _mixdown_kernel(
                jnp.asarray(sched.bank),
                jnp.asarray(sched.hits[m, 0].astype(np.int32)),
                jnp.asarray(sched.hits[m, 1].astype(np.int32)),
                total, jnp.asarray(sched.gains[m]))
            smp = Sample.from_jax(
                jnp.clip(acc, -32768, 32767).astype(jnp.int16),
                self.samplerate, 2, name=f"stem:{name}")
            if name in self.drum_fx_bus:
                # timeline-dependent drum chain: the stem is post-chain,
                # exactly what this track contributes to mix()
                run_fx_chain_ops(smp, self.drum_fx_bus[name],
                                 self.fx_irs,
                                 automation=self._track_fx_automation(
                                     name),
                                 tickf=self._fx_tickf(),
                                 sidechain_keys=sc_keys)
                smp.truncate_frames(total)
            stems[name] = smp

        # sampler tracks: each track's own pitched rows (+ its chain)
        ptr = np.asarray(self._last_pitched_tracks)
        for name in sorted(self.samplers):
            m = ptr == name
            if not m.any():
                continue
            bus32 = self._pitched_mix(pbank, plens, pidx[m], pstart[m],
                                      prate[m], pgains[m], ploopf[m],
                                      ploopu[m], pends[m], total)
            smp = Sample.from_jax(
                jnp.clip(bus32, -32768, 32767).astype(jnp.int16),
                self.samplerate, 2, name=f"stem:{name}")
            if name in self.sampler_fx:
                run_fx_chain_ops(smp, self.sampler_fx[name], self.fx_irs,
                                 automation=self._track_fx_automation(
                                     name),
                                 tickf=self._fx_tickf(),
                                 sidechain_keys=sc_keys)
                smp.truncate_frames(total)
            stems[name] = smp

        # synth tracks: ONE grouped render scatters every voice onto its
        # track's bus (the per-track-fx machinery, with every track
        # getting a segment instead of only the fx'd ones)
        if voices:
            track_names = sorted(set(vtracks))
            seg_index = {n: i for i, n in enumerate(track_names)}
            tags = [seg_index[t] for t in vtracks]
            vp, layout, seg = pack_voices(voices, self.samplerate,
                                          num_harmonics=8,
                                          sort_by_wave=True, tags=tags)
            bank = VoiceBank.for_voices(voices, self.samplerate,
                                        chunk_frames=32768,
                                        num_harmonics=8, layout=layout,
                                        nvoices=layout.nvoices)
            buses = bank.render_song_grouped(vp, seg, len(track_names),
                                             total)
            for i, name in enumerate(track_names):
                t16 = jnp.clip(
                    jnp.rint(buses[:, i] * jnp.float32(32767.0)),
                    -32768, 32767).astype(jnp.int16)
                smp = Sample.from_jax(t16, self.samplerate, 2,
                                      name=f"stem:{name}")
                if name in self.synth_fx:
                    run_fx_chain_ops(smp, self.synth_fx[name],
                                     self.fx_irs,
                                     automation=self._track_fx_automation(
                                         name),
                                     tickf=self._fx_tickf(),
                                     sidechain_keys=sc_keys)
                    smp.truncate_frames(total)
                stems[name] = smp
        return stems

    # -- streaming mixdown ------------------------------------------------------

    def mix_generator(self, chunk_frames: Optional[int] = None,
                      mesh=None, start_frame: int = 0) -> Iterator[Sample]:
        """Stream the song as fixed-size chunks rendered on device.

        With a master ``[fx]`` chain, every chunk runs through the
        stateful streaming processors (synthesizer_tpu.effects) and extra
        silence-fed chunks drain the reverb/convolution tails at the end;
        the result matches ``mix(normalize=False, tail_seconds=0)`` within
        the per-effect budgets (goldref.effects).  Seeking with fx starts
        the effect state cold at ``start_frame`` (the pre-seek reverb tail
        is absent) — sonically fine, not bit-comparable.
        """
        sc_fns = (self._sidechain_key_fns() if self._used_sidechains()
                  else {})
        gen = self._mix_generator_raw(chunk_frames, mesh, start_frame,
                                      sc_fns)
        if "master.volume" in self.automation:
            gen = self._volume_chunks(gen, start_frame)
        if not self.fx:
            yield from gen
            return
        from .effects import FxChain
        chain = FxChain(self.fx, self.samplerate, self.nchannels,
                        self.fx_irs, automation=self.automation,
                        tickf=self.tick_duration * self.samplerate,
                        start_frame=int(start_frame),
                        sidechain_keys=sc_fns)
        cf = chunk_frames or params.norm_frames_per_chunk
        ck = 0
        for chunk in gen:
            ck += 1
            yield Sample.from_jax(chain.process(chunk.jax_frames),
                                  self.samplerate, 2, name=chunk.name)
        left = chain.tail_frames + chain.flush_frames
        zeros_full = None
        while left > 0:
            n = min(cf, left)
            if n == cf:
                if zeros_full is None:
                    zeros_full = jnp.zeros((cf, self.nchannels), jnp.int16)
                z = zeros_full
            else:
                z = jnp.zeros((n, self.nchannels), jnp.int16)
            yield Sample.from_jax(chain.process(z), self.samplerate, 2,
                                  name=f"fxtail@{ck}")
            ck += 1
            left -= n

    def _volume_chunks(self, gen: Iterator[Sample],
                       start_frame: int) -> Iterator[Sample]:
        """Apply master-volume automation chunk-wise (same absolute-frame
        formula as the offline path — bit-exact at any chunk size)."""
        n0 = int(start_frame)
        for chunk in gen:
            yield Sample.from_jax(
                self._apply_master_volume(chunk.jax_frames, n0),
                self.samplerate, 2, name=chunk.name)
            n0 += chunk.nframes

    def _mix_generator_raw(self, chunk_frames: Optional[int] = None,
                           mesh=None, start_frame: int = 0,
                           sidechain_keys: Optional[Dict] = None
                           ) -> Iterator[Sample]:
        """Stream the song as fixed-size chunks rendered on device.

        Host control flow walks the hit schedule; each chunk is one device
        gather+sum over the (bounded) set of hits overlapping the chunk.
        Output is bit-identical to ``mix(normalize=False)``, sliced (the
        streaming path saturates at int16; it cannot normalize because the
        global peak is not known until the song ends).

        ``start_frame`` seeks: because every render is stateless in the
        absolute frame index (SURVEY.md §6 checkpoint/resume), resuming
        mid-song is BIT-exact with the corresponding offline slice — the
        first chunk starts exactly at ``start_frame`` (not a chunk
        boundary), including mid-hit and mid-note.

        With ``mesh`` each chunk's hit rows shard over the devices (int32
        psum — bit-exact) and synth voices shard over the same axis (f32
        psum, ≤1 LSB vs single-device).
        """
        sched = self.compile_schedule()
        voices, vtracks = self.compile_synth_voices(return_tracks=True)
        self._check_synth_format(voices)
        fx_tracks = self._fx_synth_tracks(vtracks)
        cf = chunk_frames or params.norm_frames_per_chunk
        (pbank, plens, pidx, pstart, prate, pgains, ploopf,
         ploopu) = self.compile_pitched_hits()
        pends = self._pitched_end_frames(plens, pidx, pstart, prate, ploopf)
        pitched_end = int(pends.max()) if len(pends) else 0
        total = (max(sched.total_frames, self._synth_end_frame(voices),
                     pitched_end)
                 + max(self._synth_fx_tail(vtracks),
                       self._sampler_fx_tail(self._last_pitched_tracks),
                       self._drum_bus_tail()))
        start_frame = int(start_frame)
        if start_frame < 0:
            raise ValueError("start_frame must be >= 0")
        if total == 0 or start_frame >= total:
            return
        lmax = sched.bank.shape[1]
        bank = jnp.asarray(sched.bank)
        starts = sched.hits[:, 1]
        insts = sched.hits[:, 0]
        sbank = svp = None
        synth_chunk_fn = None
        grouped_chunk_fn = None
        track_chains: Dict[str, "object"] = {}
        if voices:
            if fx_tracks:
                # grouped chunk render + one stateful chain per fx'd
                # track (the mesh variant shards the tagged voices and
                # psums the bus stack — same downstream processing).
                # Seeking starts the chains cold at start_frame (same
                # caveat as the master [fx] chain).
                from .effects import FxChain
                nseg = len(fx_tracks) + 1
                if mesh is not None:
                    from .parallel.mesh import (
                        render_chunk_grouped_sharded_fn,
                        song_synth_shards_grouped)
                    gvp, gseg, uw, ufm, ugl = song_synth_shards_grouped(
                        voices, vtracks, fx_tracks, self.samplerate, mesh)
                    gfn = render_chunk_grouped_sharded_fn(
                        mesh, cf, self.samplerate, 8, uw, ufm, nseg,
                        use_glide=ugl)

                    def grouped_chunk_fn(c0):
                        return gfn(gvp, gseg, jnp.int32(c0))
                else:
                    gbank, gvp, gseg, fx_tracks = self._synth_fx_groups(
                        voices, vtracks, chunk_frames=cf)

                    def grouped_chunk_fn(c0):
                        return gbank.render_chunk_grouped(gvp, gseg,
                                                          nseg, c0)
                sc_fns = (sidechain_keys
                          if sidechain_keys is not None
                          else self._sidechain_key_fns())
                track_chains = {
                    n: FxChain(self.synth_fx[n], self.samplerate, 2,
                               self.fx_irs,
                               automation=self._track_fx_automation(n),
                               tickf=self._fx_tickf(),
                               start_frame=start_frame,
                               sidechain_keys=sc_fns)
                    for n in fx_tracks}
            elif mesh is not None:
                from .parallel.mesh import (render_chunk_sharded_fn,
                                            song_synth_shards)
                svp, uw, ufm, ugl, ub, ua, ud = song_synth_shards(
                    voices, self.samplerate, mesh)
                synth_chunk_fn = render_chunk_sharded_fn(
                    mesh, cf, self.samplerate, 8, uw, ufm, use_glide=ugl,
                    use_bend=ub, use_amp=ua, use_dmod=ud)
            else:
                sbank, svp = self._synth_bank(voices, chunk_frames=cf)
                synth_chunk_fn = None

        # static bound on concurrently-sounding hits per chunk; one
        # bucketed pass (the old per-chunk rescan was
        # O(nchunks * hits) on long dense songs).  Chunk ci covers
        # [start_frame + ci*cf, start_frame + (ci+1)*cf).
        nchunks = -(-(total - start_frame) // cf)
        pitched_groups = []     # (fn(ci, c0) -> int32 [cf, C], chain|None)
        if len(pidx):
            ndev = int(mesh.devices.size) if mesh is not None else 0
            masks = self._sampler_fx_masks(self._last_pitched_tracks)
            plmax = int(pbank.shape[1])
            pbank_d = jnp.asarray(pbank)
            plens_d = jnp.asarray(np.asarray(plens, np.int64)
                                  .astype(np.int32))
            if mesh is not None:
                from .parallel.mesh import pitched_chunk_sharded_fn
                base_pfn = pitched_chunk_sharded_fn(mesh, cf, plmax)
            else:
                base_pfn = _pitched_chunk_fn(cf, plmax)
            from .effects import FxChain
            for m, tname in masks:
                pper, PK = self._bucket_pitched(
                    pstart[m], pends[m], nchunks, cf, start_frame, ndev)
                rows = self._pitched_rows(pper, PK, pidx[m], pstart[m],
                                          prate[m], pgains[m], ploopf[m],
                                          ploopu[m])

                def pfn(ci, c0, rows=rows):
                    ib, sb, rb, gb, vb, lf, lu = (r[ci] for r in rows)
                    return base_pfn(pbank_d, plens_d, jnp.asarray(ib),
                                    jnp.asarray(sb), jnp.asarray(rb),
                                    jnp.asarray(gb), jnp.asarray(vb),
                                    jnp.asarray(lf), jnp.asarray(lu),
                                    jnp.int32(c0))

                chain = None
                if tname is not None:
                    chain = FxChain(
                        self.sampler_fx[tname], self.samplerate,
                        self.nchannels, self.fx_irs,
                        automation=self._track_fx_automation(tname),
                        tickf=self._fx_tickf(),
                        start_frame=start_frame,
                        sidechain_keys=(sidechain_keys
                                        if sidechain_keys is not None
                                        else self._sidechain_key_fns()))
                pitched_groups.append((pfn, chain))
        lengths_of_hit = sched.lengths[insts]
        first_c = np.maximum(0, (starts - start_frame) // cf)
        last_c = np.minimum(nchunks - 1,
                            (starts + lengths_of_hit - 1 - start_frame) // cf)
        # drum-bus instruments leave the main chunk rows and run their
        # own per-chunk scatter + stateful chain (mirrors the offline
        # split; the bus renders unsharded even under mesh= — it is one
        # instrument's hits, tiny next to the main scatter)
        main_m, drum_buses = self._drum_bus_split(sched)
        bus_of_hit: Dict[int, str] = {}
        for bname, bm in drum_buses.items():
            for h in np.nonzero(bm)[0]:
                bus_of_hit[int(h)] = bname
        per_chunk: List[List[int]] = [[] for _ in range(nchunks)]
        bus_chunks: Dict[str, List[List[int]]] = {
            bname: [[] for _ in range(nchunks)] for bname in drum_buses}
        for h in range(len(starts)):
            target = (bus_chunks[bus_of_hit[h]] if h in bus_of_hit
                      else per_chunk)
            for c in range(int(first_c[h]), int(last_c[h]) + 1):
                target[c].append(h)
        max_active = max((len(h) for h in per_chunk), default=1) or 1
        drum_chains: Dict[str, "object"] = {}
        bus_K: Dict[str, int] = {}
        if drum_buses:
            from .effects import FxChain
            sc = (sidechain_keys if sidechain_keys is not None
                  else self._sidechain_key_fns())
            for bname in drum_buses:
                drum_chains[bname] = FxChain(
                    self.drum_fx_bus[bname], self.samplerate,
                    self.nchannels, self.fx_irs,
                    automation=self._track_fx_automation(bname),
                    tickf=self._fx_tickf(),
                    start_frame=start_frame, sidechain_keys=sc)
                kb = max((len(h) for h in bus_chunks[bname]),
                         default=1) or 1
                bus_K[bname] = 1 << max(0, kb - 1).bit_length()

        K = max_active
        if mesh is not None:
            K += -K % int(mesh.devices.size)

        if mesh is None:
            base_fn = _stream_chunk_fn(cf, lmax)

            def chunk_fn(inst_k, start_k, valid_k, gain_k, c0):
                return base_fn(bank, inst_k, start_k, valid_k, gain_k, c0)
        else:
            from .parallel.mesh import stream_chunk_sharded_fn
            sharded_fn = stream_chunk_sharded_fn(mesh, cf, lmax)

            def chunk_fn(inst_k, start_k, valid_k, gain_k, c0):
                return sharded_fn(bank, inst_k, start_k, valid_k, gain_k, c0)

        finish = _finish_chunk

        for ci, c0 in enumerate(range(start_frame, total, cf)):
            hs = per_chunk[ci][:K]
            ii = insts[hs]
            ss = starts[hs]
            gg = sched.gains[hs]
            pad = K - len(ii)
            inst_k = jnp.asarray(np.concatenate([ii, np.zeros(pad, np.int64)]).astype(np.int32))
            start_k = jnp.asarray(np.concatenate([ss, np.zeros(pad, np.int64)]).astype(np.int32))
            valid_k = jnp.asarray(np.concatenate([np.ones(len(ii), bool),
                                                  np.zeros(pad, bool)]))
            gain_k = jnp.asarray(np.concatenate(
                [gg, np.zeros((pad, self.nchannels), np.float32)])
                .astype(np.float32))
            acc = chunk_fn(inst_k, start_k, valid_k, gain_k, jnp.int32(c0))
            for bname, chunks_b in bus_chunks.items():
                hb = chunks_b[ci][:bus_K[bname]]
                padb = bus_K[bname] - len(hb)
                accb = _stream_chunk_fn(cf, lmax)(
                    bank,
                    jnp.asarray(np.concatenate(
                        [insts[hb], np.zeros(padb, np.int64)])
                        .astype(np.int32)),
                    jnp.asarray(np.concatenate(
                        [starts[hb], np.zeros(padb, np.int64)])
                        .astype(np.int32)),
                    jnp.asarray(np.concatenate(
                        [np.ones(len(hb), bool), np.zeros(padb, bool)])),
                    jnp.asarray(np.concatenate(
                        [sched.gains[hb],
                         np.zeros((padb, self.nchannels), np.float32)])
                        .astype(np.float32)),
                    jnp.int32(c0))
                b16 = jnp.clip(accb, -32768, 32767).astype(jnp.int16)
                acc = acc + drum_chains[bname].process(b16) \
                    .astype(jnp.int32)
            for pfn, pchain in pitched_groups:
                pc = pfn(ci, c0)
                if pchain is None:
                    acc = acc + pc
                else:
                    p16 = jnp.clip(pc, -32768, 32767).astype(jnp.int16)
                    acc = acc + pchain.process(p16).astype(jnp.int32)
            if synth_chunk_fn is not None:
                synth_chunk = synth_chunk_fn(svp, jnp.int32(c0))
            elif grouped_chunk_fn is not None:
                buses = grouped_chunk_fn(c0)
                synth_chunk = buses[:, 0]
                for i, tname in enumerate(fx_tracks):
                    t16 = jnp.clip(
                        jnp.rint(buses[:, i + 1] * jnp.float32(32767.0)),
                        -32768, 32767).astype(jnp.int16)
                    acc = acc + track_chains[tname].process(t16) \
                        .astype(jnp.int32)
            elif sbank is not None:
                synth_chunk = sbank.render_chunk(svp, c0)
            else:
                synth_chunk = None
            chunk = finish(acc, synth_chunk)
            n = min(cf, total - c0)
            yield Sample.from_jax(chunk[:n], self.samplerate, 2, name=f"chunk@{c0}")
