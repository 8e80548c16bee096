"""End-to-end inverse rendering through the public entry point
``app.fit.fit_world`` (the function the CLI ``fit`` subcommand calls): target
generation, the guided step with guide re-thresholding, and the blind step."""

import numpy as np
import pytest

from raytracing_test_tpu.config import FitConfig, WorldConfig
from raytracing_test_tpu.core import flatten
from raytracing_test_tpu.worldgen import terrain


@pytest.fixture(scope="module")
def small_world():
    wcfg = WorldConfig(width=24, length=24, grid_shape=(32, 32, 32))
    grid, pal = terrain.gen_world_grid(wcfg)
    return flatten.scene_from_grid(grid, pal), grid


@pytest.mark.parametrize("guided", [True, False], ids=["guided", "blind"])
def test_fit_world_public_entry(small_world, guided):
    """fit_world runs end to end: finite losses, one per step, parameters
    moved, and (guided) a mid-run guide re-threshold."""
    from raytracing_test_tpu.app import fit as fitmod
    from raytracing_test_tpu.parallel import sharding as shardlib

    scene, grid = small_world
    fcfg = FitConfig(
        guided=guided, views=2, steps=3, resolution=16, guided_steps=8,
        rethreshold_every=2,
    )
    params, losses = fitmod.fit_world(scene, grid.shape, fcfg, batch=64, log_every=1)
    assert len(losses) == fcfg.steps
    assert np.isfinite(losses).all(), losses
    init = shardlib.init_params(grid.shape)
    assert not np.allclose(np.asarray(params.density_raw), np.asarray(init.density_raw))


def test_fit_targets_shapes(small_world):
    """fit_targets renders one ray per pixel of every ring view."""
    from raytracing_test_tpu.app import fit as fitmod

    scene, grid = small_world
    fcfg = FitConfig(views=3, resolution=8)
    o, d, t = fitmod.fit_targets(scene, grid.shape, fcfg)
    assert o.shape == d.shape == t.shape == (3 * 8 * 8, 3)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d), axis=1), 1.0, atol=1e-5)
    assert np.isfinite(np.asarray(t)).all()
