"""Spatially-sharded world rendering (config 5 semantics): the grid split over
the mesh's space axis must render identically to single-device."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_test_tpu.config import RenderConfig, WorldConfig
from raytracing_test_tpu.core import flatten
from raytracing_test_tpu.parallel import mesh as meshlib, spatial
from raytracing_test_tpu.render import renderer
from raytracing_test_tpu.render.camera import Camera
from raytracing_test_tpu.worldgen import terrain


@pytest.fixture(scope="module")
def world():
    cfg = WorldConfig(width=64, length=64, grid_shape=(64, 64, 64))
    grid, pal = terrain.gen_world_grid(cfg)
    return flatten.scene_from_grid(grid, pal)


@pytest.mark.parametrize("n_data,n_space", [(4, 2), (2, 4), (1, 8)])
def test_spatial_render_matches_single(world, n_data, n_space):
    scene = world
    cam = Camera(
        pos=jnp.asarray((35.0, 50.0, 35.0), jnp.float32),
        dir=jnp.asarray((0.6, -0.5, 0.5), jnp.float32),
    )
    rcfg = RenderConfig(width=32, height=16)
    single = np.asarray(renderer.render_jit(scene, cam, rcfg))
    mesh = meshlib.make_mesh(n_data, n_space)
    sharded = spatial.shard_scene_spatial(scene, mesh)
    img = spatial.render_image_spatial(sharded, cam, rcfg, mesh)
    np.testing.assert_array_equal(img, single)


def test_spatial_memory_is_sharded(world):
    mesh = meshlib.make_mesh(1, 8)
    sharded = spatial.shard_scene_spatial(world, mesh)
    # each device holds a 1/8 x-slab of the grid
    shard = sharded.mat.addressable_shards[0]
    assert shard.data.shape[0] == world.mat.shape[0] // 8


def test_spatial_with_materials(world):
    """Reflection/refraction paths cross slab boundaries correctly."""
    from tests.test_render_parity import _material_world

    grid, pal = _material_world()
    scene = flatten.scene_from_grid(grid, pal)
    cam = Camera(
        pos=jnp.asarray((32.0, 12.0, 5.0), jnp.float32),
        dir=jnp.asarray((0.1, 0.05, 1.0), jnp.float32),
    )
    rcfg = RenderConfig(width=16, height=16, time=0.3)
    single = np.asarray(renderer.render_jit(scene, cam, rcfg))
    mesh = meshlib.make_mesh(2, 4)
    img = spatial.render_image_spatial(
        spatial.shard_scene_spatial(scene, mesh), cam, rcfg, mesh
    )
    np.testing.assert_allclose(img, single, atol=1e-6)


@pytest.mark.parametrize("kind", ["spatial", "handoff"])
def test_repeated_frames_reuse_one_executable(world, kind):
    """A frame loop over a sharded world (session modes spatial/handoff)
    must not retrace per frame: equal configs and equal meshes share one
    jitted function, and a new camera is data, not a new program."""
    from raytracing_test_tpu.parallel import handoff

    render, cached = {
        "spatial": (spatial.render_image_spatial, spatial._render_spatial_jit),
        "handoff": (handoff.render_image_handoff, handoff._render_handoff_jit),
    }[kind]
    rcfg = RenderConfig(width=16, height=8, enable_ao=False)
    for i in range(3):
        mesh = meshlib.make_mesh(1, 4)  # a fresh but equal mesh each frame
        cam = Camera(
            pos=jnp.asarray((35.0 + i, 50.0, 35.0), jnp.float32),
            dir=jnp.asarray((0.6, -0.5, 0.5), jnp.float32),
        )
        img = render(spatial.shard_scene_spatial(world, mesh), cam, rcfg, mesh)
        assert np.isfinite(img).all()
    fn = cached(rcfg, meshlib.make_mesh(1, 4))
    assert fn._cache_size() == 1
