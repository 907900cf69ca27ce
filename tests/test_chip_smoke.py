"""chip_smoke.py rehearsed on the CPU at tiny sizes, and the guards that
keep a CPU run from passing for a GPU one."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


def test_phase_song_tiny(tmp_path, cpu):
    out = chip_smoke.phase_song(str(tmp_path), cpu, patterns=["intro"])
    assert out["frames"] > 0 and out["card_vs_cpu_lsb_before_fx"] == 0
    assert out["card_vs_cpu_lsb_with_fx"] == 0
    assert (tmp_path / "demo.wav").stat().st_size > 44


def test_phase_bank_tiny(cpu):
    out = chip_smoke.phase_bank(16, 1.0, 0.5, cpu, chunk_frames=8192,
                                repeats=2)
    assert out["voices"] >= 16 and out["frames"] == 44100
    assert out["card_vs_cpu_lsb"] == 0


def test_phase_midi_tiny(cpu):
    out = chip_smoke.phase_midi(40, 12.0, cpu)
    assert out["sparse_vs_flat_lsb"] <= 1 and out["card_vs_cpu_lsb"] == 0


def test_dense_midi_is_seeded_and_carries_curves():
    from synthesizer_tpu.midi import parse_midi
    a = chip_smoke.dense_midi(30, 10.0)
    assert a == chip_smoke.dense_midi(30, 10.0)
    notes = parse_midi(a)
    assert len(notes) == 30
    assert any(n.bend_curve for n in notes)
    assert any(n.mod_curve for n in notes)


def test_phase_server(cpu):
    out = chip_smoke.phase_server("cpu")
    assert set(out["wav_bytes"]) == {"/render/song", "/render/voices",
                                     "/render/midi", "/render/patch"}


def test_phase_server_rejects_wrong_platform():
    with pytest.raises(chip_smoke.SmokeFailure, match="/health"):
        chip_smoke.phase_server("gpu")


def test_phase_four_on_virtual_devices():
    out = chip_smoke.phase_four(4, 64, 0.25, "cpu")
    assert out["sharded_vs_single_lsb"] <= 1 and out["midi_lsb"] <= 1
    assert out["swept_chain_lsb"] <= out["swept_chain_bound"]


def test_expect_raises():
    with pytest.raises(chip_smoke.SmokeFailure, match="boom"):
        chip_smoke.expect(False, "boom")
    chip_smoke.expect(True, "fine")


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_gpu_exits_nonzero_without_ok_line(tmp_path):
    r = _run([os.path.join(ROOT, "chip_smoke.py")], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_alone_without_the_repo_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu(tmp_path):
    r = _run([os.path.join(ROOT, "bench.py")], tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "GPU only" in r.stderr


def test_battery_gate_refuses_cpu(capsys):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_verify
    assert chip_verify.main([]) == 2
    assert "must run on a GPU" in capsys.readouterr().out


def test_require_gpu_refuses_cpu():
    from synthesizer_tpu.utils.profiling import require_gpu
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


def test_compile_cache_dir_follows_env(monkeypatch):
    from synthesizer_tpu.utils import compile_cache as cc
    monkeypatch.setenv(cc.ENV_VAR, "/cache/x")
    assert cc.compile_cache_dir() == "/cache/x"
    monkeypatch.setenv(cc.ENV_VAR, "")
    assert cc.compile_cache_dir() == cc.DEFAULT_DIR
    monkeypatch.delenv(cc.ENV_VAR)
    assert cc.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_enable_compile_cache_sets_only_the_default(monkeypatch):
    from synthesizer_tpu.utils import compile_cache as cc
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv(cc.ENV_VAR, "/cache/y")
    assert cc.enable_compile_cache() == "/cache/y"
    assert calls == []
    monkeypatch.delenv(cc.ENV_VAR)
    assert cc.enable_compile_cache() == cc.DEFAULT_DIR
    assert calls == [("jax_compilation_cache_dir", cc.DEFAULT_DIR)]


def test_gitignore_lists_the_cache_dir():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_voice_mesh_raises_instead_of_falling_back():
    from synthesizer_tpu.parallel.mesh import voice_mesh
    with pytest.raises(ValueError, match="need 64 devices"):
        voice_mesh(64)
    gpu_like = jax.devices()[:2]
    with pytest.raises(ValueError, match="need 4 devices"):
        voice_mesh(4, devices=gpu_like)
