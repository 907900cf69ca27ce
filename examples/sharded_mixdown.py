#!/usr/bin/env python3
"""Multi-chip song mixdown demo (runs on 8 VIRTUAL CPU devices).

The flagship song path scales by data parallelism over a 1-D
``jax.sharding.Mesh``: sample hits shard across devices and merge with one
int32 ``psum`` (bit-exact — integer add is associative), synth voices shard
over the same axis with an f32 ``psum`` per chunk.  On several GPUs the
same code runs over their interconnect; here we force 8 virtual CPU
devices so the demo works anywhere:

    python examples/sharded_mixdown.py [out.wav]
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from synthesizer_tpu import WaveSynth  # noqa: E402
from synthesizer_tpu.sequencer import Song, SynthDef  # noqa: E402
from synthesizer_tpu.parallel.mesh import voice_mesh  # noqa: E402


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else "sharded_mix.wav"
    ws = WaveSynth()
    song = Song()
    song.bpm = 120
    song.ticks = 4
    song.add_instrument("kick", ws.sine(55, 0.12, amplitude=0.9)
                        .fadeout(0.1).stereo())
    song.add_instrument("hat", ws.white_noise(duration=0.04, amplitude=0.35,
                                              seed=11).fadeout(0.03).stereo())
    song.add_synth("lead", SynthDef(wave="square_bl", amplitude=0.22,
                                    attack=0.01, release=0.12, pan=0.3))
    song.add_synth("bass", SynthDef(wave="sine", amplitude=0.3, release=0.1,
                                    fm_frequency=3.0, fm_depth=0.008, pan=-0.2))
    song.add_pattern("a", {
        "kick": "x... x... x... x...",
        "hat":  "x.x. x.x. x.x. xxx.",
        "lead": "C4 - E4 - G4 - E4 - C4 - E4 - A4 - G4 -",
        "bass": "C2 - - - - - - - G1 - - - - - - -",
    })
    song.pattern_sequence = ["a", "a"]

    mesh = voice_mesh(8)
    print(f"mesh: {mesh.shape} over {mesh.devices.size} devices "
          f"({mesh.devices.flat[0].platform})")
    sharded = song.mix(normalize=False, mesh=mesh)
    single = song.mix(normalize=False)
    d = np.abs(sharded.get_frame_array().astype(np.int64)
               - single.get_frame_array().astype(np.int64))
    print(f"sharded vs single-device mixdown: max {d.max()} LSB "
          f"(drums bit-exact via int32 psum; synths differ only by f32 "
          f"summation order)")
    sharded.write_wav(out)
    print(f"{sharded.duration:.2f}s -> {out}")


if __name__ == "__main__":
    main()
