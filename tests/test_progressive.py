"""Progressive refinement (the reference's disabled mid/full_res scheme):
coarse depth seeding must (a) reduce marching work and (b) approximate the
full render with only sparse thin-feature error."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_test_tpu.config import RenderConfig, WorldConfig
from raytracing_test_tpu.core import flatten
from raytracing_test_tpu.render import fast, progressive
from raytracing_test_tpu.render.camera import Camera, ray_directions
from raytracing_test_tpu.worldgen import terrain


def test_progressive_approximates_and_saves_steps():
    cfg = WorldConfig(width=64, length=64, grid_shape=(64, 64, 64))
    grid, pal = terrain.gen_world_grid(cfg)
    scene = flatten.scene_from_grid(grid, pal)
    cam = Camera(
        pos=jnp.asarray((35.0, 50.0, 35.0), jnp.float32),
        dir=jnp.asarray((0.6, -0.5, 0.5), jnp.float32),
    )
    rcfg = RenderConfig(width=64, height=64)
    full = np.asarray(fast.render_fast_jit(scene, cam, rcfg))
    img, aux = jax.jit(
        lambda s, c: progressive.render_image_progressive(s, c, rcfg)
    )(scene, cam)
    d = np.abs(np.asarray(img) - full).max(-1)
    assert (d > 1e-3).mean() < 0.01, f"{(d > 1e-3).mean():.3%} pixels off"

    dirs = ray_directions(cam, 64, 64)
    _, aux_full = fast.render_rays_fast(scene, cam.pos, dirs, rcfg)
    saved = float(np.asarray(aux_full["steps"]).mean()) / max(
        float(np.asarray(aux["steps"]).mean()), 1e-6
    )
    assert saved > 1.5, f"expected step reduction, got {saved:.2f}x"


def test_progressive_seeds_refracted_rays_from_the_camera():
    """Coarse pixels whose ray a material bent (here: refraction into
    animated water) carry no straight-ray depth; seeding their fine rays past
    the water surface would render them as if the camera were submerged."""
    cfg = WorldConfig(width=48, length=48, water_level=40, grid_shape=(64, 64, 64))
    grid, pal = terrain.gen_world_grid(cfg)
    scene = flatten.scene_from_grid(grid, pal)
    cam = Camera(
        pos=jnp.asarray((4.0, 60.0, 4.0), jnp.float32),
        dir=jnp.asarray((0.55, -0.6, 0.55), jnp.float32),
    )
    rcfg = RenderConfig(width=32, height=32, time=1.3)
    full = np.asarray(fast.render_fast_jit(scene, cam, rcfg))
    still = np.asarray(fast.render_fast_jit(scene, cam, RenderConfig(width=32, height=32)))
    assert (np.abs(full - still).max(-1) > 0).mean() > 0.02  # water in view
    img, _ = jax.jit(
        lambda s, c: progressive.render_image_progressive(s, c, rcfg)
    )(scene, cam)
    d = np.abs(np.asarray(img) - full).max(-1)
    assert (d > 1e-3).mean() < 0.01, f"{(d > 1e-3).mean():.3%} pixels off"


def test_far_seed_never_wraps_into_the_window():
    """A seed past the ray's exit from the grid window (all-sky coarse
    neighborhoods seed 1e5) must render what the unseeded ray renders: the
    far start cell would otherwise wrap (&1023) onto solid floor."""
    cfg = WorldConfig(width=64, length=64, grid_shape=(64, 64, 64))
    grid, pal = terrain.gen_world_grid(cfg)
    scene = flatten.scene_from_grid(grid, pal)
    o = np.asarray([32.5, 60.5, 32.5], np.float32)
    # a sky-bound ray whose point at t lands on cell (10, 3, 10) mod 1024
    p = np.asarray([10.5 + 1024 * 60, 3.5 + 1024 * 60, 10.5 + 1024 * 60])
    assert grid[10, 3, 10] != 0
    d = (p - o) / np.linalg.norm(p - o)
    t = np.float32(np.linalg.norm(p - o))
    dirs = jnp.asarray(np.stack([d, d]).astype(np.float32))
    rcfg = RenderConfig(width=1, height=2)
    ref, _ = fast.render_rays_fast(scene, jnp.asarray(o), dirs, rcfg)
    for start in (t, 1e5):
        got, aux = fast.render_rays_fast(
            scene, jnp.asarray(o), dirs, rcfg, start_t=jnp.full((2,), start, jnp.float32))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        assert not np.asarray(aux["hit"]).any()
