#!/usr/bin/env python3
"""Smoke run of the system's main paths on the GPU, each checked against a
reference.

    python chip_smoke.py           # one card: song, bank, midi, server, fidelity
    python chip_smoke.py --four    # four cards: the mesh paths vs one card

Everything runs in this one process (a second JAX process could not get
the card's memory).  Each phase compares what the card renders with the
CPU backend of the same process, with the streaming twin, or with the
battery's host oracles; any failure raises, and the exit code is non-zero.
With no GPU the script exits non-zero before any phase.  The last line of
standard output is one JSON object naming the device.

The phase functions take their sizes as arguments, so that the tests can
rehearse them on the CPU at tiny sizes.
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import importlib.util
import io
import json
import os
import sys
import tempfile
import time
import wave

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from synthesizer_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from synthesizer_tpu.utils.profiling import card_info, require_gpu  # noqa: E402

SR = 44100
#: white-noise render checksum: pure integer hashing plus one f32 scale,
#: so it is the same on every backend (tests/test_golden_checksums.py)
NOISE_SHA = "7d5f6f9b694b18a5"


class SmokeFailure(RuntimeError):
    pass


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def max_lsb(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    expect(a.shape == b.shape, f"shape {a.shape} != {b.shape}")
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max(initial=0))


def _load_example(name: str):
    path = os.path.join(ROOT, "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: card vs CPU limit for the demo song WITH its effect chains: each
#: effect's own card-vs-oracle budget holds (goldref.effects), and their
#: rounding differs between backends (libdevice log10/exp2 in the
#: compressor, FMA contraction in the log-depth scans).  Measured 2-3 LSB
#: on an H100; 4 is the largest per-effect budget in the chain (reverb).
#: The mix before the chains is held to 1 LSB.
CHAIN_LSB = 4


def _mix16(ini: str, chains: bool) -> np.ndarray:
    from synthesizer_tpu.sequencer import Song
    song = Song.from_ini(ini)
    if not chains:
        song.fx = []
        song.synth_fx = {}
    return song.mix(normalize=False).get_frame_array()


def phase_song(workdir: str, cpu, patterns=None) -> dict:
    """Demo kit -> trackmixer -> WAV; offline == streaming; card vs CPU.

    ``patterns``: the song's pattern sequence (None keeps the demo's)."""
    import jax

    import trackmixer
    from synthesizer_tpu.sequencer import Song

    demo = _load_example("make_demo_song")
    demo.make_kit(workdir)
    ini_text = demo.SONG_INI
    if patterns is not None:
        ini_text = "\n".join(
            f"patterns = {' '.join(patterns)}"
            if line.startswith("patterns =") else line
            for line in ini_text.splitlines()) + "\n"
    ini = os.path.join(workdir, "demo.ini")
    with open(ini, "w") as f:
        f.write(ini_text)
    wav_path = os.path.join(workdir, "demo.wav")
    t0 = time.perf_counter()
    rc = trackmixer.main([ini, "-o", wav_path])
    t_cli = time.perf_counter() - t0
    expect(rc == 0, f"trackmixer exited {rc}")
    with wave.open(wav_path) as w:
        expect(w.getnchannels() == 2 and w.getframerate() == SR
               and w.getnframes() > 0, "trackmixer wrote no stereo WAV")
        nframes = w.getnframes()

    # the bit-exact offline == streaming contract covers the mix before
    # effect chains (each streaming effect keeps its own budget,
    # goldref.effects), so it is checked on the song without them
    song = Song.from_ini(ini)
    song.fx = []
    song.synth_fx = {}
    off = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    stream = np.concatenate([c.get_frame_array()
                             for c in song.mix_generator()])
    expect(np.array_equal(off, stream),
           f"mix() != mix_generator() (max {max_lsb(off, stream)} LSB)")

    d = {}
    for chains in (False, True):
        card = _mix16(ini, chains)
        with jax.default_device(cpu):
            ref = _mix16(ini, chains)
        d[chains] = max_lsb(card, ref)
        expect(np.abs(card.astype(np.int64)).max() > 1000, "song is silent")
    expect(d[False] <= 1, f"song before fx: card vs CPU {d[False]} LSB > 1")
    expect(d[True] <= CHAIN_LSB,
           f"song with fx: card vs CPU {d[True]} LSB > {CHAIN_LSB}")
    return {"frames": nframes, "cli_seconds": t_cli,
            "stream_frames": len(stream), "card_vs_cpu_lsb_before_fx": d[False],
            "card_vs_cpu_lsb_with_fx": d[True]}


def phase_bank(nvoices: int, seconds: float, check_seconds: float, cpu,
               chunk_frames: int = 131072, repeats: int = 5) -> dict:
    """BASELINE.json config 5 (bench.build_song) through
    VoiceBank.render_song: compile and warm wall times, and the first
    ``check_seconds`` against a CPU render."""
    import jax

    from bench import build_song
    from synthesizer_tpu.models.voicebank import VoiceBank, pack_voices

    voices = build_song(nvoices, seconds, SR)
    vp, layout = pack_voices(voices, SR, num_harmonics=8, sort_by_wave=True)
    bank = VoiceBank.for_voices(voices, SR, chunk_frames=chunk_frames,
                                num_harmonics=8, layout=layout,
                                nvoices=layout.nvoices)
    total = int(seconds * SR)
    t0 = time.perf_counter()
    out = jax.block_until_ready(bank.render_song(vp, total))
    t_compile = time.perf_counter() - t0
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(bank.render_song(vp, total))
        walls.append(time.perf_counter() - t0)
    card16 = np.asarray(bank.to_int16(out))
    expect(card16.shape == (total, 2), f"bank shape {card16.shape}")
    expect(np.isfinite(np.asarray(out)).all(), "bank render not finite")
    n = int(check_seconds * SR)
    with jax.default_device(cpu):
        vpc = jax.device_put(vp, cpu)
        ref16 = np.asarray(bank.to_int16(bank.render_song(vpc, n)))
    d = max_lsb(card16[:n], ref16)
    expect(d <= 1, f"bank card vs CPU {d} LSB > 1")
    expect(np.abs(card16.astype(np.int64)).max() > 1000, "bank is silent")
    return {"voices": layout.nvoices, "frames": total,
            "compile_plus_first_seconds": t_compile,
            "warm_median_seconds": float(np.median(walls)),
            "card_vs_cpu_lsb": d}


def dense_midi(nnotes: int, seconds: float, seed: int = 5) -> bytes:
    """A seeded dense performance: ``nnotes`` notes over ``seconds`` on
    four channels, with pitch-bend, CC1 (mod wheel) and CC11
    (expression) lanes."""
    from synthesizer_tpu.midi import MidiNote, write_midi

    rng = np.random.default_rng(seed)
    programs = (0, 24, 33, 81)
    notes = []
    for _ in range(nnotes):
        ch = int(rng.integers(0, 4))
        notes.append(MidiNote(
            float(rng.uniform(0.0, seconds - 2.0)),
            float(rng.uniform(0.1, 1.2)), int(rng.integers(36, 90)),
            int(rng.integers(30, 127)), ch, program=programs[ch]))
    bends, controls = [], []
    for ch in range(4):
        for t in np.arange(0.5 + 0.3 * ch, seconds - 1.0, 2.0):
            bends.append((float(t), ch, int(rng.integers(-8192, 8192))))
        for t in np.arange(0.2 + 0.2 * ch, seconds - 1.0, 1.5):
            controls.append((float(t), ch, 1, int(rng.integers(0, 128))))
        for t in np.arange(0.1 + 0.1 * ch, seconds - 1.0, 1.0):
            controls.append((float(t), ch, 11, int(rng.integers(40, 128))))
    return write_midi(notes, bends=bends, controls=controls)


def phase_midi(nnotes: int, seconds: float, cpu) -> dict:
    """render_midi of a dense file: the automatic sparse path vs the flat
    render, and the card vs the CPU."""
    import jax

    from synthesizer_tpu.midi import render_midi
    from synthesizer_tpu.models import voicebank

    data = dense_midi(nnotes, seconds)
    voicebank._bank_fn_cache.clear()
    t0 = time.perf_counter()
    sparse = render_midi(data).get_frame_array()
    t_sparse = time.perf_counter() - t0
    expect(any(k[0] == "bucketed" for k in voicebank._bank_fn_cache),
           "render_midi did not take the sparse path")
    flat = render_midi(data, sparse=False).get_frame_array()
    d_flat = max_lsb(sparse, flat)
    expect(d_flat <= 1, f"midi sparse vs flat {d_flat} LSB > 1")
    with jax.default_device(cpu):
        ref = render_midi(data).get_frame_array()
    d_cpu = max_lsb(sparse, ref)
    expect(d_cpu <= 1, f"midi card vs CPU {d_cpu} LSB > 1")
    expect(np.abs(sparse.astype(np.int64)).max() > 1000, "midi is silent")
    return {"frames": len(sparse), "sparse_compile_plus_first_seconds":
            t_sparse, "sparse_vs_flat_lsb": d_flat, "card_vs_cpu_lsb": d_cpu}


SERVER_SONG = """\
[song]
bpm = 140
ticks = 4
patterns = a a
[synth.lead]
wave = square_bl
amplitude = 0.3
release = 0.05
[synth.pad]
wave = sine
amplitude = 0.25
attack = 0.02
release = 0.1
[pattern.a]
lead = C4 E4 G4 C5 G4 E4 C4 .
pad = C3 - - - G2 - - -
"""


def phase_server(platform: str) -> dict:
    """RenderServer in-process: /health and one request per endpoint."""
    from synthesizer_tpu.midi import MidiNote, write_midi
    from synthesizer_tpu.server import RenderServer

    srv = RenderServer(port=0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=300)
        conn.request("GET", "/health")
        r = conn.getresponse()
        health = json.loads(r.read())
        expect(r.status == 200 and health["platform"] == platform,
               f"/health said {health}")
        midi = write_midi([MidiNote(0.1 * i, 0.3, 60 + i, 100, 0)
                           for i in range(8)], bends=[(0.2, 0, 2000)])
        bodies = {
            "/render/song": SERVER_SONG.encode(),
            "/render/voices": json.dumps({"duration": 1.0, "voices": [
                {"wave": "sawtooth_bl", "frequency": 220.0, "duration": 0.5,
                 "amplitude": 0.3},
                {"wave": "sine", "frequency": 330.0, "start": 0.2,
                 "duration": 0.6, "amplitude": 0.3, "pan": 0.5}]}).encode(),
            "/render/midi": midi,
            "/render/patch": json.dumps({"duration": 0.5, "patch": {
                "node": "osc", "kind": "sine", "frequency": 440}}).encode(),
        }
        sizes = {}
        for path, body in bodies.items():
            conn.request("POST", path, body=body)
            r = conn.getresponse()
            data = r.read()
            expect(r.status == 200 and data[:4] == b"RIFF",
                   f"{path}: HTTP {r.status} {data[:80]!r}")
            with wave.open(io.BytesIO(data)) as w:
                expect(w.getnframes() > 0, f"{path}: empty WAV")
            sizes[path] = len(data)
        conn.close()
    finally:
        srv.stop()
    return {"wav_bytes": sizes}


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def phase_fidelity(battery_argv=()) -> dict:
    """The on-card battery (scripts/chip_verify.py) and the golden
    checksums: the noise checksum is asserted, the float renders' are
    printed (they may move between backends)."""
    from synthesizer_tpu.models import graph as G
    from synthesizer_tpu.models import spec as S
    from synthesizer_tpu.models.voicebank import Voice, VoiceBank, pack_voices

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_verify
    rc = chip_verify.main(list(battery_argv))
    expect(rc == 0, f"battery exited {rc}: {chip_verify.FAILURES}")

    noise = np.asarray(G.render_patch(S.Osc("white_noise", SR, 0.5, seed=42),
                                      10000, SR))
    expect(_sha(noise) == NOISE_SHA,
           f"noise checksum {_sha(noise)} != {NOISE_SHA}")
    sine = np.asarray(G.to_int_device(G.render_patch(
        S.Osc("sine", 440.0, 0.9999), SR // 2, SR), 2))
    vs = [Voice("harmonics", 110.0, amplitude=0.3, harmonics=[1, 0.5, 0.25],
                duration=0.2),
          Voice("square_bl", 220.0, amplitude=0.3, duration=0.2, pan=0.5),
          Voice("sine", 440.0, amplitude=0.3, duration=0.2,
                fm_frequency=6.0, fm_depth=0.02)]
    vp, lay = pack_voices(vs, SR, num_harmonics=4, sort_by_wave=True)
    bank = VoiceBank.for_voices(vs, SR, chunk_frames=2048, num_harmonics=4,
                                layout=lay, nvoices=lay.nvoices)
    bank16 = np.asarray(bank.to_int16(bank.render_song(vp, SR // 4)))
    return {"noise_sha": _sha(noise), "sine_sha": _sha(sine),
            "bank_sha": _sha(bank16)}


def phase_four(n_devices: int, nvoices: int, seconds: float,
               platform: str) -> dict:
    """The mesh paths on ``n_devices`` devices vs one device: the
    __graft_entry__ song (swept master chain included) and MIDI curve
    render, and an ``nvoices`` render_song_sharded."""
    import jax

    import __graft_entry__ as graft
    from bench import build_song
    from synthesizer_tpu.models.voicebank import VoiceBank, pack_voices
    from synthesizer_tpu.parallel.mesh import (render_song_sharded,
                                               shard_voice_params, voice_mesh)

    mesh = voice_mesh(n_devices)
    devs = list(mesh.devices.flat)
    expect(len({d.id for d in devs}) == n_devices
           and all(d.platform == platform for d in devs),
           f"mesh devices {devs}")
    out = graft.dryrun_multichip(n_devices)
    expect(out["song_lsb"] <= 2, f"sharded song {out['song_lsb']} LSB > 2")
    expect(out["swept_chain_lsb"] <= out["swept_chain_bound"],
           f"sharded swept chain {out['swept_chain_lsb']} LSB > derived "
           f"bound {out['swept_chain_bound']:.1f}")
    expect(out["midi_lsb"] <= 1, f"sharded MIDI {out['midi_lsb']} LSB > 1")

    voices = build_song(nvoices, seconds, SR)
    vp = pack_voices(voices, SR, num_harmonics=8, pad_to=8 * n_devices)
    vps = shard_voice_params(vp, mesh)
    held = {s.device.id for s in vps.base_inc.addressable_shards}
    expect(len(held) == n_devices,
           f"voice shards sit on {len(held)} devices, not {n_devices}")
    total = int(seconds * SR)
    V = int(vp.base_inc.shape[0])
    t0 = time.perf_counter()
    sharded = jax.block_until_ready(render_song_sharded(
        vps, total, SR, chunk_frames=8192, num_harmonics=8, mesh=mesh))
    t_sharded = time.perf_counter() - t0
    one = jax.device_put(vp, devs[0])
    single = VoiceBank(V, SR, chunk_frames=8192,
                       num_harmonics=8).render_song(one, total)
    d = max_lsb(VoiceBank.to_int16(sharded), VoiceBank.to_int16(single))
    expect(d <= 1, f"sharded {V}-voice render vs one device {d} LSB > 1")
    out.update({"sharded_voices": V, "sharded_frames": total,
                "sharded_compile_plus_first_seconds": t_sharded,
                "sharded_vs_single_lsb": d})
    return out


def _report(name: str, t0: float, result: dict, card: str) -> None:
    print(f"[{name}] PASS in {time.perf_counter() - t0:.1f}s ({card}): "
          + json.dumps(result, default=float), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the mesh paths, on four cards")
    args = ap.parse_args(argv)

    cache = enable_compile_cache()
    import jax
    # the CPU backend renders the references, so it must stay available
    plats = jax.config.jax_platforms
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")
    dev = require_gpu()
    count = len(jax.devices())
    card = card_info()
    print(f"[device] {dev.platform} {dev.device_kind} x{count}, "
          f"jax {jax.__version__}, compile cache {cache}", flush=True)
    print(f"[device] card: {card}", flush=True)
    card_line = card.splitlines()[0]
    cpu = jax.devices("cpu")[0]

    if args.four:
        expect(count >= 4, f"--four needs 4 cards, found {count}")
        t0 = time.perf_counter()
        _report("four", t0, phase_four(4, 1024, 10.0, "gpu"), card_line)
        count = 4
    else:
        with tempfile.TemporaryDirectory() as td:
            t0 = time.perf_counter()
            _report("song", t0, phase_song(td, cpu), card_line)
        t0 = time.perf_counter()
        _report("bank", t0, phase_bank(64, 60.0, 5.0, cpu), card_line)
        t0 = time.perf_counter()
        _report("midi", t0, phase_midi(600, 300.0, cpu), card_line)
        t0 = time.perf_counter()
        _report("server", t0, phase_server("gpu"), card_line)
        t0 = time.perf_counter()
        _report("fidelity", t0, phase_fidelity(), card_line)
    print(f"card: {card_line}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
