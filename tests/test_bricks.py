"""Brick-hierarchical march (render/bricks.py) vs the fast path: the brick
path must reproduce the oracle-validated fast path bit-for-bit on the material
coverage cases (same boxes-are-exact argument as fast vs reference, applied at
brick granularity)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_test_tpu.config import RenderConfig, WorldConfig
from raytracing_test_tpu.core import flatten
from raytracing_test_tpu.render import bricks, fast
from raytracing_test_tpu.render.camera import Camera, ray_directions
from raytracing_test_tpu.worldgen import terrain
from tests.test_render_parity import CASES, _material_world, assert_images_close


@pytest.fixture(scope="module")
def mat_scene():
    grid, pal = _material_world()
    return grid, pal, flatten.scene_from_grid(grid, pal)


@pytest.fixture(scope="module")
def terrain_scene():
    wcfg = WorldConfig(width=48, length=48, grid_shape=(64, 64, 64))
    grid, pal = terrain.gen_world_grid(wcfg)
    return flatten.scene_from_grid(grid, pal)


def _render_both(scene, pos, dirn, rcfg, time_s):
    cam = Camera(pos=jnp.asarray(pos, jnp.float32), dir=jnp.asarray(dirn, jnp.float32))
    dirs = ray_directions(cam, rcfg.width, rcfg.height)
    t = jnp.float32(time_s)
    cf, af = jax.jit(lambda t: fast.render_rays_fast(scene, cam.pos, dirs, rcfg, time_s=t))(t)
    cb, ab = jax.jit(lambda t: bricks.render_rays_bricks(scene, cam.pos, dirs, rcfg, time_s=t))(t)
    return np.asarray(cf), af, np.asarray(cb), ab


@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_bricks_matches_fast_material_cases(mat_scene, case):
    grid, pal, scene = mat_scene
    pos, dirn, time_s = case
    rcfg = RenderConfig(width=24, height=24, max_steps=150, shadow_steps=40)
    cf, af, cb, ab = _render_both(scene, pos, dirn, rcfg, time_s)
    assert_images_close(
        cb.reshape(rcfg.height, rcfg.width, 3), cf.reshape(rcfg.height, rcfg.width, 3)
    )


def test_bricks_matches_fast_terrain_exact(terrain_scene):
    scene = terrain_scene
    rcfg = RenderConfig(width=32, height=32, max_steps=150, shadow_steps=40)
    cf, af, cb, ab = _render_both(scene, (24.0, 45.0, -8.0), (0.25, -0.65, 0.9), rcfg, 0.0)
    np.testing.assert_array_equal(cb, cf)
    np.testing.assert_array_equal(np.asarray(ab["mat"]), np.asarray(af["mat"]))
    np.testing.assert_array_equal(np.asarray(ab["steps"]), np.asarray(af["steps"]))
    np.testing.assert_array_equal(np.asarray(ab["cell"]), np.asarray(af["cell"]))


def test_bricks_outside_window_and_sky(terrain_scene):
    # camera far outside the window moving in; and looking away (pure sky)
    scene = terrain_scene
    rcfg = RenderConfig(width=16, height=16, max_steps=200, shadow_steps=40)
    for pos, dirn in [
        ((-40.0, 30.0, -40.0), (0.6, -0.2, 0.6)),  # enter through the slab
        ((32.0, 90.0, 32.0), (0.1, 0.9, 0.1)),  # sky-up exit
        ((200.0, 30.0, 200.0), (1.0, 0.1, 1.0)),  # outside moving away
    ]:
        cf, af, cb, ab = _render_both(scene, pos, dirn, rcfg, 0.0)
        np.testing.assert_array_equal(cb, cf)
        assert not np.isnan(cb).any()


def test_bricks_progressive_seed(terrain_scene):
    # start_t fast-forward must behave like the fast path's
    scene = terrain_scene
    rcfg = RenderConfig(width=16, height=16, max_steps=150, shadow_steps=30)
    cam = Camera(pos=jnp.asarray([24.0, 50.0, -10.0], jnp.float32),
                 dir=jnp.asarray([0.2, -0.7, 0.8], jnp.float32))
    dirs = ray_directions(cam, rcfg.width, rcfg.height)
    seed = jnp.full((dirs.shape[0],), 5.0, jnp.float32)
    cf, _ = jax.jit(lambda: fast.render_rays_fast(scene, cam.pos, dirs, rcfg, start_t=seed))()
    cb, _ = jax.jit(lambda: bricks.render_rays_bricks(scene, cam.pos, dirs, rcfg, start_t=seed))()
    np.testing.assert_array_equal(np.asarray(cb), np.asarray(cf))


def test_brick_tables_consistent(terrain_scene):
    """brick_dist licenses must certify genuinely-empty brick boxes, and the
    nibble tables must decode back to brick_dist."""
    scene = terrain_scene
    from raytracing_test_tpu.ops.mxu_lookup import mxu_nibble_lookup2

    dist = np.asarray(scene.brick_dist)
    occ = (np.asarray(scene.brick_mat) > 0).any(axis=1).reshape(dist.shape)
    assert (dist[occ] == 0).all()
    assert (dist[~occ] >= 1).all()
    # license check: d >= 1 certifies all bricks within Chebyshev d-1 are empty
    Bx, By, Bz = dist.shape
    rng = np.random.default_rng(0)
    for _ in range(200):
        b = (rng.integers(0, Bx), rng.integers(0, By), rng.integers(0, Bz))
        d = int(dist[b])
        if d <= 1:
            continue
        r = d - 1
        sl = tuple(slice(max(0, b[i] - r), min(dist.shape[i], b[i] + r + 1)) for i in range(3))
        assert not occ[sl].any(), (b, d)
    # table decode round-trip
    lin = jnp.asarray(rng.integers(0, dist.size, 4096, dtype=np.int32))
    got = np.asarray(mxu_nibble_lookup2(scene.brick_nib, lin))
    np.testing.assert_array_equal(got, dist.reshape(-1)[np.asarray(lin)])
