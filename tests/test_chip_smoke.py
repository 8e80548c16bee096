"""chip_smoke.py's pieces on the CPU: the GPU refusal, the compile-cache
rule, the card label, the last-line format, main's pass/fail control flow,
and every phase through its own function at a tiny size."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from raytracing_test_tpu.config import FitConfig, WorldConfig
from raytracing_test_tpu.utils import compile_cache, profiling

# A 48x48-column world whose water level sits above part of the terrain, so
# the animated-water check has water to see.
TINY = cs.Sizes(
    world=WorldConfig(width=48, length=48, water_level=40, grid_shape=(64, 64, 64)),
    res=32,
    cam_pos=(4.0, 60.0, 4.0),
    cam_dir=(0.55, -0.6, 0.55),
    blind_stride=4,
    blind_steps=192,
    fit=FitConfig(guided=True, steps=2, views=2, resolution=16),
    fit_batch=64,
    edit_column=(24, 24),
    reps=1,
)


@pytest.fixture(scope="module")
def rep():
    return cs.Report("cpu (test)")


@pytest.fixture(scope="module")
def session(rep):
    return cs.phase_world(rep, TINY)


@pytest.fixture(scope="module")
def frame_out(rep, session):
    return cs.phase_frame(rep, session, TINY)


def _failed_since(rep, n):
    return rep.failed[n:]


def test_phase_world_uses_native_runtime(rep, session):
    n = len(rep.failed)
    assert session.grid.shape == TINY.world.grid_shape
    assert session._native is not None
    np.testing.assert_allclose(
        session.camera_dir(), np.asarray(TINY.cam_dir) / np.linalg.norm(TINY.cam_dir),
        atol=1e-6)
    assert _failed_since(rep, n) == []


def test_phase_frame(rep, session, frame_out):
    assert not rep.failed, rep.failed
    assert frame_out["frame"].shape == (TINY.res, TINY.res, 3)
    assert frame_out["seed"].shape == (TINY.res * TINY.res,)


def test_phase_edit(rep, session, frame_out):
    n = len(rep.failed)
    cs.phase_edit(rep, session, TINY, frame_out["fast"])
    assert _failed_since(rep, n) == []
    assert session.sync() == 0  # the edit left nothing dirty


def test_phase_window(rep, session, frame_out):
    n = len(rep.failed)
    cs.phase_window(rep, session, TINY, frame_out["seed"], frame_out["dirs"])
    assert _failed_since(rep, n) == []


def test_phase_fit(rep, session):
    n = len(rep.failed)
    cs.phase_fit(rep, session, TINY)
    assert _failed_since(rep, n) == []


def test_run_multi_on_four_devices(capsys):
    r = cs.Report("cpu (test)")
    cs.run_multi(r, TINY, n=4)
    out = capsys.readouterr().out
    assert r.failed == [], out
    for name in ("spatial_vs_one_card_fast", "handoff_vs_one_card_fast",
                 "dp_loss_vs_one_card", "dp_density_raw_vs_one_card"):
        assert f"check multi.{name}: ok" in out


def test_run_multi_needs_four_devices(monkeypatch):
    import jax

    r = cs.Report("cpu (test)")
    monkeypatch.setattr(jax, "devices", lambda *a: [object()] * 2)
    cs.run_multi(r, TINY, n=4)
    assert r.failed == ["multi.devices"]


def test_main_refuses_without_gpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_without_gpu():
    import bench

    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo, the
    script exits non-zero and prints no result."""
    import shutil

    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _fake_gpu(monkeypatch, run):
    info = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    monkeypatch.setattr(profiling, "require_gpu", lambda: info)
    monkeypatch.setattr(profiling, "gpu_label", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: "/cache")
    monkeypatch.setattr(cs, "run_single", run)
    return info


def test_main_last_line_when_all_checks_pass(monkeypatch, capsys):
    info = _fake_gpu(monkeypatch, lambda rep, sz: rep.check("x", True, ""))
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": info}
    assert lines[-2] == "card (name, power.limit): NVIDIA H100 80GB HBM3, 700.00 W"


def test_main_fails_on_a_failed_check(monkeypatch, capsys):
    _fake_gpu(monkeypatch, lambda rep, sz: rep.check("x", False, ""))
    assert cs.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_last_line_format():
    info = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}
    line = cs.last_line(info)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": info}


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_cache_dir_defaults_to_checkout(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.abspath(cs.__file__))
    assert compile_cache.cache_dir() == os.path.join(root, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(root, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_gpu_label_reads_nvidia_smi(monkeypatch, tmp_path):
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n"
                    "echo 'NVIDIA H100 80GB HBM3, 650.00 W'\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    assert profiling.gpu_label() == (
        "NVIDIA H100 80GB HBM3, 700.00 W; NVIDIA H100 80GB HBM3, 650.00 W")


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        profiling.require_gpu()


def test_time_call_and_memory_summary():
    import jax
    import jax.numpy as jnp

    comp = jax.jit(lambda x: x * 2).lower(jnp.ones(8)).compile()
    times = profiling.time_call(comp, jnp.ones(8), reps=3)
    assert len(times) == 3 and all(t >= 0 for t in times)
    mem = profiling.memory_summary(comp)
    assert mem["argument"] == 32 and mem["output"] == 32


def test_bench_yaw_pitch_inverts_camera_model():
    from raytracing_test_tpu.render.camera import yaw_pitch_dir

    for d in (cs.BENCH_DIR, (0.0, -1.0, 1.0), (-0.3, 0.2, -0.9)):
        got = np.asarray(yaw_pitch_dir(*cs.bench_yaw_pitch(d)))
        np.testing.assert_allclose(got, np.asarray(d) / np.linalg.norm(d), atol=1e-6)


def test_fit_batch_matches_fit_world_draw():
    o = np.arange(30, dtype=np.float32).reshape(10, 3)
    bo, bd, bt = cs.fit_batch(o, o + 1, o + 2, batch=7, ndev=2)
    assert bo.shape == (6, 3)
    idx = np.random.default_rng(0).integers(0, 10, 6)
    np.testing.assert_array_equal(bo, o[idx])
    np.testing.assert_array_equal(bt, o[idx] + 2)


@pytest.mark.gpu
def test_phases_compile_and_agree_on_gpu(gpu_device):
    """Every single-card phase at the tiny size, compiled for the card."""
    import jax

    r = cs.Report(profiling.gpu_label())
    with jax.default_device(gpu_device):
        s = cs.phase_world(r, TINY)
        fr = cs.phase_frame(r, s, TINY)
        cs.phase_edit(r, s, TINY, fr["fast"])
        cs.phase_window(r, s, TINY, fr["seed"], fr["dirs"])
        cs.phase_fit(r, s, TINY)
    assert r.failed == []
