"""Gate-driven RealtimeVoice tests (the reference's key-down/up flow §4.5)."""

import time

import numpy as np
import pytest

from synthesizer_tpu import Output, oscillators as osc
from synthesizer_tpu.voice import RealtimeVoice

import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from keyboard_gui import SynthController  # noqa: E402

SR = 44100
BS = 1470


def collect(voice, n_before_release, n_max=200):
    gen = voice.chunks()
    chunks = []
    for i in range(n_max):
        try:
            c = next(gen)
        except StopIteration:
            break
        chunks.append(np.frombuffer(c, np.int16).reshape(-1, 2))
        if i == n_before_release - 1:
            voice.release()
    else:
        pytest.fail("voice never ended")
    return np.concatenate(chunks)


def test_voice_attack_sustain_release():
    patch = osc.Sine(440.0, amplitude=0.9, samplerate=SR)
    v = RealtimeVoice(patch, attack=0.02, decay=0.03, sustain_level=0.6,
                      release=0.05, samplerate=SR, blocksize=BS)
    audio = collect(v, n_before_release=6)
    # attack: first ms quiet, later loud
    assert np.abs(audio[:40]).max() < np.abs(audio[2000:4000]).max()
    # sustained region roughly at sustain_level * amp
    sus = np.abs(audio[4 * BS:5 * BS]).max()
    assert 0.45 * 32767 * 0.9 < sus < 0.75 * 32767 * 0.9
    # ends in silence after release
    assert np.abs(audio[-BS // 4:]).max() == 0
    # stream terminated (release 0.05s ~ 3 blocks after release point)
    assert len(audio) <= (6 + 4) * BS


def test_voice_hold_indefinitely_until_release():
    patch = osc.Square(110.0, amplitude=0.5, samplerate=SR)
    v = RealtimeVoice(patch, 0.005, 0.01, 0.7, 0.02, samplerate=SR, blocksize=BS)
    audio = collect(v, n_before_release=40, n_max=100)
    held = np.abs(audio[30 * BS:31 * BS]).max()
    assert held > 0.5 * 32767 * 0.5  # still sounding at block 30


def test_sample_accurate_release_mid_block():
    """release(at_frame=k) with k mid-block: zero-frame quantization, the
    whole output matches a whole-signal host oracle within 1 LSB."""
    a, d, sl, r = 0.02, 0.03, 0.6, 0.05
    rn = 3 * BS + 517                       # lands mid-block 3
    patch = osc.Sine(440.0, amplitude=0.9, samplerate=SR)
    v = RealtimeVoice(patch, attack=a, decay=d, sustain_level=sl, release=r,
                      samplerate=SR, blocksize=BS)
    v.release(at_frame=rn)                  # set before streaming: exact
    audio = np.concatenate([np.frombuffer(c, np.int16).reshape(-1, 2)
                            for c in v.chunks()])
    N = len(audio)
    # whole-signal oracle in f64: held A/D/S before rn, ramp from rn
    vals = np.asarray(patch.render(N), np.float64)
    t = np.arange(N) / SR
    held = np.where(t < a, t / a,
                    np.where(t < a + d, 1.0 + (sl - 1.0) * (t - a) / d, sl))
    t_r = rn / SR
    level = held[rn]
    rel = np.clip(level * (1.0 - (t - t_r) / r), 0.0, 1.0)
    g = np.where(np.arange(N) < rn, held, rel)
    want = np.clip(np.rint(vals * g * 32767.0), -32768, 32767)
    diff = np.abs(audio[:, 0].astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1, f"max {diff.max()} LSB at {np.argmax(diff)}"
    # the ramp really starts inside the block, not at its boundary: a
    # block-quantized release (frame 4*BS) would disagree with the output
    # by far more than 1 LSB in the ramp region
    t_q = (4 * BS) / SR
    rel_q = np.clip(level * (1.0 - (t - t_q) / r), 0.0, 1.0)
    g_q = np.where(np.arange(N) < 4 * BS, held, rel_q)
    want_q = np.clip(np.rint(vals * g_q * 32767.0), -32768, 32767)
    dq = np.abs(audio[:, 0].astype(np.int64) - want_q.astype(np.int64))
    assert dq.max() > 100, "output is block-quantized, not sample-accurate"
    # ends in silence after the ramp
    assert np.abs(audio[-10:]).max() == 0


def test_release_at_future_frame_holds_until_then():
    patch = osc.Square(110.0, amplitude=0.5, samplerate=SR)
    v = RealtimeVoice(patch, 0.005, 0.01, 0.7, 0.02, samplerate=SR,
                      blocksize=BS)
    rn = 5 * BS + 100
    v.release(at_frame=rn)
    audio = np.concatenate([np.frombuffer(c, np.int16).reshape(-1, 2)
                            for c in v.chunks()])
    # still sounding at sustain right before the release frame
    assert np.abs(audio[rn - 200:rn - 1]).max() > 0.5 * 32767 * 0.5 * 0.7
    # silent after the ramp
    assert np.abs(audio[rn + int(0.02 * SR) + 10:]).max() == 0


def test_voice_echo_after_gate_matches_offline_order():
    """Realtime echo applies AFTER the gate envelope (the reference's
    offline envelope->echo order) with the tail carried across blocks and
    ringing past the release end."""
    a, d, sl, r = 0.01, 0.02, 0.7, 0.04
    after, amount, delay, decay = 0.02, 3, 0.03, 0.5
    rn = 2 * BS + 300
    patch = osc.Sine(330.0, amplitude=0.8, samplerate=SR)
    v = RealtimeVoice(patch, a, d, sl, r, samplerate=SR, blocksize=BS,
                      echo=(after, amount, delay, decay))
    v.release(at_frame=rn)
    audio = np.concatenate([np.frombuffer(c, np.int16).reshape(-1, 2)
                            for c in v.chunks()])
    N = len(audio)
    # oracle: gate-gained signal, then feed-forward echo, all whole-signal
    vals = np.asarray(patch.render(N), np.float64)
    t = np.arange(N) / SR
    held = np.where(t < a, t / a,
                    np.where(t < a + d, 1.0 + (sl - 1.0) * (t - a) / d, sl))
    level = held[rn]
    rel = np.clip(level * (1.0 - (t - rn / SR) / r), 0.0, 1.0)
    gated = vals * np.where(np.arange(N) < rn, held, rel)
    out = gated.copy()
    g = 1.0
    for k in range(1, amount + 1):
        g *= decay
        dk = int(round(after * SR)) + k * int(round(delay * SR))
        out[dk:] += g * gated[:N - dk]
    want = np.clip(np.rint(out * 32767.0), -32768, 32767)
    diff = np.abs(audio[:, 0].astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 2, f"max {diff.max()} LSB"   # echo taps sum f32 diffs
    # the tail rings past the release end (echo-after-gate, not silence)
    rel_end = rn + int(r * SR)
    ring = audio[rel_end + 10: rel_end + int(0.05 * SR), 0]
    assert np.abs(ring).max() > 100
    # and the stream still terminates
    assert N <= rel_end + int((after + amount * delay) * SR) + 2 * BS


def test_lookahead_is_bit_identical():
    """lookahead_blocks renders N blocks per device round trip; the engine
    is block-size invariant, so the stream is BIT-identical to the
    per-block voice (pinned release frame makes both deterministic)."""
    def run(la):
        patch = osc.Sine(440.0, amplitude=0.9, samplerate=SR)
        v = RealtimeVoice(patch, 0.01, 0.02, 0.7, 0.05, samplerate=SR,
                          blocksize=BS, echo=(0.02, 2, 0.03, 0.5),
                          lookahead_blocks=la)
        v.release(at_frame=4 * BS + 777)
        return [c for c in v.chunks()]

    a, b = run(1), run(3)
    assert all(len(c) == BS * 2 * 2 for c in b)      # still mixer-sized blocks
    na, nb = b"".join(a), b"".join(b)
    # lookahead may render past the end by < one superblock; the overlap
    # must be bit-identical and the excess silent
    m = min(len(na), len(nb))
    assert na[:m] == nb[:m]
    tail = np.frombuffer(nb[m:] or na[m:], np.int16)
    assert np.abs(tail).max(initial=0) == 0


def test_controller_realtime_voice_lifecycle():
    out = Output(samplerate=SR, nchannels=2, frames_per_chunk=BS, mixing="mixed")
    try:
        c = SynthController(samplerate=SR, output=out)
        c.key_down(49)
        assert len(c._active) == 1
        assert out.mixer.active_count == 1
        c.key_up(49)
        deadline = time.time() + 10.0
        while out.mixer.active_count and time.time() < deadline:
            time.sleep(0.02)
        assert out.mixer.active_count == 0  # release completed, voice dropped
    finally:
        out.close()
