"""Golden output checksums — drift alarms across rounds.

These pin exact CPU-rendered bytes for a few fixed renders.  A failure here
does NOT necessarily mean a bug: an intentional spec change, a JAX/XLA
upgrade, or different FMA contraction will shift float paths by ulps.  It
means *look* — outputs changed and the change should be deliberate (update
the constants with the maintenance snippet in this file's docstring region
after confirming the differential suites still pass).

Computed on this machine (CPU backend, JAX 0.9.0, 2026-08-16) via:

    sha256(int16_bytes)[:16] of each render below.
"""

import hashlib

import numpy as np
import pytest

import goldref.osc as go
from synthesizer_tpu.models import graph as G
from synthesizer_tpu.models import spec as S
from synthesizer_tpu.models.voicebank import Voice, VoiceBank, pack_voices

SR = 44100


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def test_sine_render_checksums():
    node = S.Osc("sine", 440.0, 0.9999)
    dev = np.asarray(G.to_int_device(G.render_patch(node, SR // 2, SR), 2))
    gold = go.to_int_samples(go.render_oracle(node, SR // 2, SR), 2)
    assert sha(gold) == "387a7600e7d56047"   # oracle: numpy-only, very stable
    assert sha(dev) == "00dc9f36f9aa22ca"    # device: may shift on XLA upgrades


def test_bank_render_checksum():
    vs = [Voice("harmonics", 110.0, amplitude=0.3, harmonics=[1, 0.5, 0.25],
                duration=0.2),
          Voice("square_bl", 220.0, amplitude=0.3, duration=0.2, pan=0.5),
          Voice("sine", 440.0, amplitude=0.3, duration=0.2,
                fm_frequency=6.0, fm_depth=0.02)]
    vp, lay = pack_voices(vs, SR, num_harmonics=4, sort_by_wave=True)
    bank = VoiceBank.for_voices(vs, SR, chunk_frames=2048, num_harmonics=4,
                                layout=lay, nvoices=lay.nvoices)
    out = np.asarray(bank.to_int16(bank.render_song(vp, SR // 4)))
    # the pan mix sums voices in a fixed pairwise tree (voicebank
    # _mix_voices), the same order on every backend and chunk size
    assert sha(out) == "1b1da7cc83baa6e9"


def test_noise_checksum_platform_independent():
    # the noise value pipeline is pure integer hashing + one f32 scale:
    # identical on every backend and library version by construction
    noise = np.asarray(G.render_patch(S.Osc("white_noise", SR, 0.5, seed=42),
                                      10000, SR))
    assert sha(noise) == "7d5f6f9b694b18a5"
