"""App layer: picking, interactive session editing + incremental sync,
checkpointing, debug channels, CLI."""

import os
import subprocess
import sys

import numpy as np
import pytest

from raytracing_test_tpu.config import RenderConfig, WorldConfig
from raytracing_test_tpu.app import checkpoint, debug as dbg, picking
from raytracing_test_tpu.app.session import WorldSession
from raytracing_test_tpu.core import flatten
from raytracing_test_tpu.core.tree import Palette, VoxelTree
from raytracing_test_tpu.core.color import rgb_to_u64
from raytracing_test_tpu.core.types import Block, Properties
from raytracing_test_tpu.worldgen import terrain

SMALL = WorldConfig(width=48, length=48, grid_shape=(64, 64, 64))


@pytest.fixture(scope="module")
def session():
    return WorldSession(SMALL, use_native=True)


def test_picking_semantics():
    """Pick ray stops at the first non-liquid block and reports the face cell."""
    t = VoxelTree()
    t.put_block((10, 5, 5), Block(0, int(rgb_to_u64(255, 0, 0))), 6)
    res = picking.cast_ray(t, (5.5, 5.5, 5.5), (1.0, 0.0, 0.0), 30)
    assert res.pos == (10, 5, 5)
    assert res.last_pos == (9, 5, 5)
    assert res.steps > 0
    # liquid is transparent to the pick ray (ray_caster.cpp:82)
    t.put_block(
        (8, 5, 5),
        Block(int(Properties.REFRACTIVE | Properties.LIQUID), int(rgb_to_u64(0, 150, 10))),
        6,
    )
    res2 = picking.cast_ray(t, (5.5, 5.5, 5.5), (1.0, 0.0, 0.0), 30)
    assert res2.pos == (10, 5, 5)
    # nothing in range -> steps == 0
    res3 = picking.cast_ray(t, (5.5, 5.5, 5.5), (-1.0, 0.0, 0.0), 10)
    assert res3.steps == 0


def test_session_edit_cycle(session):
    s = session
    s.pos = np.asarray([24.0, 45.0, 24.0])
    s.yaw, s.pitch = 45.0, 60.0  # look down (positive pitch = down, ref convention)
    res = s.pick()
    assert res.steps > 0, "expected terrain under the camera"
    before = s.render(RenderConfig(width=32, height=32), highlight=False)
    placed = s.place(slot=0)  # red block at the pick face
    assert placed is not None
    assert s.sync() > 0
    blk = s.tree.get_block(placed)
    assert not blk.is_air
    mid = s.grid[placed]
    assert mid != 0
    after = s.render(RenderConfig(width=32, height=32), highlight=False)
    assert np.abs(after - before).sum() > 0.1, "placed block must be visible"
    # delete it again
    deleted = s.delete()
    assert deleted == placed
    s.sync()
    assert s.tree.get_block(placed).is_air
    restored = s.render(RenderConfig(width=32, height=32), highlight=False)
    np.testing.assert_allclose(restored, before, atol=1e-6)


def test_camera_parity(session):
    # yaw=0 pitch=0 -> +z (input.cpp rotateCamera: Ry(yaw) Rx(pitch) (0,0,1))
    s = session
    s.yaw, s.pitch = 0.0, 0.0
    np.testing.assert_allclose(s.camera_dir(), [0, 0, 1], atol=1e-6)
    s.pitch = 45.0
    d = s.camera_dir()
    assert d[1] < 0  # positive pitch looks down in the reference convention
    s.rotate(0.0, 60.0)  # would exceed the clamp -> rejected
    assert s.pitch == 45.0
    s.yaw, s.pitch = 170.0, 0.0
    s.rotate(20.0, 0.0)
    assert s.yaw == -170.0  # wraps


def test_camera_from_yaw_pitch_matches_session(session):
    # one source of truth: the render.camera helper must agree with the
    # session's (reference-verified, input.cpp:19-28) camera_dir for all poses
    from raytracing_test_tpu.render.camera import camera_from_yaw_pitch

    s = session
    for yaw, pitch in [(0, 0), (90, 0), (-45, 30), (120, -60), (180, 89)]:
        s.yaw, s.pitch = float(yaw), float(pitch)
        cam = camera_from_yaw_pitch((0.0, 0.0, 0.0), float(yaw), float(pitch))
        np.testing.assert_allclose(np.asarray(cam.dir), s.camera_dir(), atol=1e-6)


def test_checkpoint_roundtrip(tmp_path, session):
    s = session
    path = str(tmp_path / "world.npz")
    s.sync()
    checkpoint.save_world(path, s.grid, s.palette)
    grid2, pal2 = checkpoint.load_world(path)
    np.testing.assert_array_equal(grid2, s.grid)
    assert len(pal2) == len(s.palette)
    # interning still works after load
    assert pal2.id_for(s.palette.block(1)) == 1


def test_debug_channels(session):
    s = session
    s.pos = np.asarray([24.0, 45.0, 24.0])
    s.yaw, s.pitch = 45.0, 50.0
    ch = dbg.render_debug(s.scene, s.camera(), RenderConfig(width=16, height=16))
    assert set(ch) >= {"color", "hit_pos", "steps", "normal", "mat", "hit"}
    probe = dbg.probe_pixel(ch, 8, 8)
    assert probe["hit"] in (True, False)
    if probe["hit"]:
        assert probe["steps"] > 0


def test_cli_render_and_edit(tmp_path):
    env = dict(os.environ, RTT_PLATFORM="cpu", XLA_FLAGS="")
    out = str(tmp_path / "cli.png")
    r = subprocess.run(
        [
            sys.executable, "-m", "raytracing_test_tpu.app.cli",
            "--world", "32", "--width", "24", "--height", "24",
            "render", "--out", out,
        ],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-1500:]
    assert os.path.exists(out)

    script = tmp_path / "script.txt"
    out2 = str(tmp_path / "edited.png")
    script.write_text(
        f"goto 16 40 16\nlook 45 -60\nplace 1\npick\nrender {out2}\n"
        f"save {tmp_path}/w.npz\n"
    )
    r2 = subprocess.run(
        [
            sys.executable, "-m", "raytracing_test_tpu.app.cli",
            "--world", "32", "--width", "24", "--height", "24",
            "edit", str(script),
        ],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r2.returncode == 0, r2.stderr[-1500:]
    assert os.path.exists(out2)
    assert os.path.exists(f"{tmp_path}/w.npz")


def test_frame_stats_and_phase_timer(tmp_path, capsys):
    """Profiling utilities: rolling frame stats (the reference's 40-frame
    average, main.cpp:221-225) and the phase timer."""
    import time as _time

    from raytracing_test_tpu.utils import profiling

    st = profiling.FrameStats(window=4)
    for _ in range(6):
        st.start()
        _time.sleep(0.001)
        st.stop(rays=100)
    assert len(st.times) == 4
    assert st.avg_ms >= 1.0
    assert st.fps > 0
    assert st.rays_per_s > 0
    assert "fps" in st.status()
    with profiling.phase("unit-test-phase"):
        pass
    with profiling.trace(None):
        pass


@pytest.fixture(scope="module")
def mode_session():
    s = WorldSession(SMALL, use_native=False)
    s.yaw, s.pitch = 45.0, 25.0
    return s, s.render(RenderConfig(width=16, height=16), mode="fast")


@pytest.mark.parametrize(
    "mode", ["reference", "bricks", "progressive", "spatial", "handoff"])
def test_session_render_modes(mode_session, mode):
    """Every CLI-exposed render mode produces the same scene as the fast
    anchor (progressive within its coarse-seeding bound)."""
    s, base = mode_session
    img = np.asarray(s.render(RenderConfig(width=16, height=16), mode=mode))
    assert img.shape == base.shape and np.isfinite(img).all()
    atol = 1e-3 if mode == "progressive" else 1e-6
    bad = (np.abs(img - base) > atol).any(axis=-1)
    assert bad.mean() <= 0.01, (mode, bad.sum())


@pytest.mark.parametrize("mode", ["fused", "bricks-pallas", "pallas"])
def test_session_removed_modes_raise(mode_session, mode):
    """The removed kernel render modes are gone: asking for one is an error, not
    a silent fallback to another engine."""
    s, _ = mode_session
    with pytest.raises(ValueError, match="unknown render mode"):
        s.render(RenderConfig(width=16, height=16), mode=mode)


@pytest.mark.parametrize("argv", [
    ["render", "--mode", "fused"],
    ["render", "--mode", "bricks-pallas"],
    ["render", "--mode", "pallas"],
    ["fit", "--engine", "fused"],
])
def test_cli_rejects_removed_engines(argv, capsys):
    from raytracing_test_tpu.app import cli

    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2  # argparse usage error


def test_cli_fit_flags_route_to_cmd_fit(monkeypatch):
    """`fit --guided --shading` parses and reaches cmd_fit's args."""
    from raytracing_test_tpu.app import cli

    seen = {}
    monkeypatch.setattr(cli, "cmd_fit", lambda args: seen.update(vars(args)))
    monkeypatch.setattr(
        "raytracing_test_tpu.utils.compile_cache.enable_compile_cache", lambda: "")
    cli.main(["fit", "--guided", "--shading", "--steps", "1"])
    assert seen["guided"] is True and seen["shading"] is True
    assert seen["steps"] == 1 and "engine" not in seen


def test_profiler_trace_failure_raises(monkeypatch, tmp_path):
    """A profiler that cannot start is an error, never an untraced run."""
    import jax

    from raytracing_test_tpu.utils import profiling

    def broken(log_dir):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(jax.profiler, "trace", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with profiling.trace(str(tmp_path)):
            pass
