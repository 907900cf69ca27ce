"""User-extensible oscillators: any reference-style
object with blocks(), iterator, or random-access callable composes into
the device graph through UserOscillator / Oscillator.from_blocks."""

import numpy as np
import pytest

from synthesizer_tpu.oscillators import (AmpModulationFilter,
                                         EnvelopeFilter, EchoFilter,
                                         LowpassFilter, MixingFilter,
                                         Oscillator, Sine, UserOscillator)

SR = 44100


class Chirp:
    """A classic user oscillator: plain numpy in a blocks() generator."""

    def __init__(self, f0, f1, seconds, amplitude=0.5, blocksize=512):
        self.f0, self.f1 = f0, f1
        self.seconds, self.amplitude, self.bs = seconds, amplitude, blocksize

    def full(self):
        t = np.arange(int(self.seconds * SR)) / SR
        f = self.f0 + (self.f1 - self.f0) * t / self.seconds
        return (self.amplitude * np.sin(2 * np.pi * f * t)).astype(np.float32)

    def blocks(self):
        sig = self.full()
        for i in range(0, len(sig), self.bs):
            yield sig[i:i + self.bs]


def test_blocks_object_roundtrips_exactly():
    src = Chirp(200, 800, 0.25)
    out = np.concatenate(list(UserOscillator(src).blocks(512)))
    want = src.full()
    assert np.array_equal(out[:len(want)], want)
    assert np.abs(out[len(want):]).max() == 0.0        # zero-padded tail
    # finite source ends the stream
    assert len(out) < len(want) + 512


def test_wrapped_in_adsr_and_echo():
    src = Chirp(300, 300, 0.2)
    env = EnvelopeFilter(UserOscillator(src), 0.01, 0.02, 0.1, 0.8, 0.05)
    echoed = EchoFilter(env, 0.05, 3, 0.03, 0.5)
    out = np.concatenate(list(echoed.blocks(512)))
    # independent numpy twin: envelope gains * chirp, then feed-forward echos
    sig = np.zeros(len(out), np.float32)
    full = src.full()
    sig[:len(full)] = full
    t = np.arange(len(out), dtype=np.float32) / SR
    a, d, s, sl, r = 0.01, 0.02, 0.1, np.float32(0.8), 0.05
    t2, t3, t4 = a + d, a + d + s, a + d + s + r
    g = np.where(t < a, t / a,
        np.where(t < t2, 1 + (sl - 1) * (t - a) / d,
        np.where(t < t3, sl,
        np.where(t < t4, sl * (t4 - t) / r, 0.0)))).astype(np.float32)
    enved = (sig * np.maximum(g, 0)).astype(np.float32)
    want = enved.copy()
    d_after, d_delay = int(round(0.05 * SR)), int(round(0.03 * SR))
    gk = 1.0
    for k in range(1, 4):
        gk *= 0.5
        dk = d_after + k * d_delay
        want[dk:] += np.float32(gk) * enved[:-dk]
    assert np.abs(out - want).max() < 1e-5


def test_mixes_with_builtin_and_filters():
    patch = LowpassFilter(
        MixingFilter(UserOscillator(Chirp(300, 300, 0.2)),
                     Sine(440, amplitude=0.2)), 1000.0)
    out = np.concatenate(list(patch.blocks(256)))
    assert len(out) >= int(0.2 * SR) and np.abs(out).max() > 0.1


def test_random_access_callable_render_and_seek():
    fn = lambda n0, n: (0.3 * np.sin(
        2 * np.pi * 330 * (np.arange(n0, n0 + n) / SR))).astype(np.float32)
    u = Oscillator.from_blocks(fn)
    r = np.asarray(u.render(4096))
    assert np.abs(r - fn(0, 4096)).max() < 1e-7
    # two streams from the same callable are identical (stateless);
    # islice: a callable source is ENDLESS by construction
    from itertools import islice
    a = np.concatenate(list(islice(u.blocks(128), 4)))
    b = np.concatenate(list(islice(u.blocks(128), 4)))
    assert np.array_equal(a, b)


def test_structural_compile_sharing_instance_independence():
    # two DIFFERENT user sources under the SAME patch structure must not
    # leak into each other (canonical slots map back to their own pulls)
    e1 = EnvelopeFilter(UserOscillator(Chirp(100, 200, 0.1)),
                        0.01, 0.01, 0.05, 0.8, 0.01)
    e2 = EnvelopeFilter(UserOscillator(Chirp(400, 100, 0.1)),
                        0.01, 0.01, 0.05, 0.8, 0.01)
    a1 = np.concatenate(list(e1.blocks(512)))
    a2 = np.concatenate(list(e2.blocks(512)))
    assert not np.allclose(a1[:2000], a2[:2000])


def test_two_user_sources_in_one_patch():
    m = MixingFilter(UserOscillator(Chirp(200, 200, 0.1, amplitude=0.3)),
                     UserOscillator(Chirp(500, 500, 0.1, amplitude=0.3)))
    out = np.concatenate(list(m.blocks(256)))
    want = Chirp(200, 200, 0.1, amplitude=0.3).full() \
        + Chirp(500, 500, 0.1, amplitude=0.3).full()
    assert np.abs(out[:len(want)] - want).max() < 1e-6


def test_ring_modulation_by_user_lfo():
    from itertools import islice
    am = AmpModulationFilter(Sine(440, amplitude=0.5),
                             UserOscillator(lambda n0, n: np.full(
                                 n, 0.25, np.float32)))
    out = np.concatenate(list(islice(am.blocks(256), 4)))
    ref = np.concatenate(list(islice(Sine(440, amplitude=0.125)
                                     .blocks(256), 4)))
    assert np.abs(out - ref).max() < 1e-6


def test_sample_modulate_amp_by_user_oscillator():
    from synthesizer_tpu import WaveSynth
    s = WaveSynth(samplerate=SR, samplewidth=2).sine(440, 0.2, amplitude=0.5)
    ramp = lambda n0, n: np.clip(
        1.0 - np.arange(n0, n0 + n, dtype=np.float32) / (0.2 * SR), 0, 1)
    s.modulate_amp(Oscillator.from_blocks(ramp))
    arr = s.get_frame_array()
    assert np.abs(arr[:400]).max() > 10 * max(np.abs(arr[-400:]).max(), 1)


def test_iterator_sources_single_pass():
    it = iter([np.zeros(100, np.float32)])
    u = UserOscillator(it)
    assert len(list(u.blocks(64))) >= 1
    with pytest.raises(RuntimeError, match="already consumed"):
        list(u.blocks(64))


def test_offline_scan_guard():
    from synthesizer_tpu.models import graph as G
    u = UserOscillator(lambda n0, n: np.zeros(n, np.float32))
    with pytest.raises(ValueError, match="host-source"):
        G.patch_values(u.spec, 1024, SR)


def test_blocks_object_is_replayable_and_seekable():
    src = Chirp(250, 250, 0.1)
    u = UserOscillator(src)
    a = np.concatenate(list(u.blocks(128)))
    b = np.concatenate(list(u.blocks(128)))
    assert np.array_equal(a, b)                        # fresh blocks() each


def test_bad_source_type_raises():
    with pytest.raises(TypeError, match="UserOscillator"):
        UserOscillator(42)
