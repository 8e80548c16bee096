"""Multi-device semantics on the 8-device virtual CPU mesh: sharded render
equals single-device render; data-parallel training step runs and learns."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from raytracing_test_tpu.config import RenderConfig, WorldConfig
from raytracing_test_tpu.core import flatten
from raytracing_test_tpu.parallel import mesh as meshlib
from raytracing_test_tpu.parallel import sharding as shardlib
from raytracing_test_tpu.render import diff, renderer
from raytracing_test_tpu.render.camera import Camera, ray_directions
from raytracing_test_tpu.worldgen import terrain


@pytest.fixture(scope="module")
def world():
    cfg = WorldConfig(width=48, length=48, grid_shape=(64, 64, 64))
    grid, pal = terrain.gen_world_grid(cfg)
    return grid, pal


def test_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_single_device(world):
    grid, pal = world
    scene = flatten.scene_from_grid(grid, pal)
    cam = Camera(
        pos=jnp.asarray([24.0, 45.0, 24.0], jnp.float32),
        dir=jnp.asarray([0.5, -0.6, 0.5], jnp.float32),
    )
    rcfg = RenderConfig(width=32, height=16)  # 512 rays over 8 devices
    single = np.asarray(renderer.render_jit(scene, cam, rcfg))
    mesh = meshlib.make_mesh(8, 1)
    sharded = np.asarray(
        shardlib.render_image_sharded(scene, cam, rcfg, mesh)
    )
    np.testing.assert_allclose(sharded, single, atol=1e-6)


def test_train_step_decreases_loss(world):
    grid, pal = world
    albedo, _, _ = flatten.palette_arrays(pal)
    true_scene = diff.diff_scene_from_grid(grid, albedo, solid_density=20.0)
    mesh = meshlib.make_mesh(8, 1)
    rs = meshlib.rays_sharding(mesh)
    rep = meshlib.replicated(mesh)

    rng = np.random.default_rng(0)
    N = 256
    origins = np.full((N, 3), 32.0, np.float32)
    origins[:, 1] = 40.0
    dirs = rng.normal(size=(N, 3)).astype(np.float32)
    dirs[:, 1] = -np.abs(dirs[:, 1]) - 0.5
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    targets = diff.render_rays_diff(
        true_scene, jnp.asarray(origins), jnp.asarray(dirs), num_steps=48, sky=False
    )

    params = shardlib.init_params((64, 64, 64))
    params = jax.device_put(params, rep)
    optimizer = optax.adam(5e-2)
    opt_state = jax.device_put(optimizer.init(params), rep)
    step = shardlib.make_train_step(mesh, optimizer, num_steps=48)
    origins_s = jax.device_put(jnp.asarray(origins), rs)
    dirs_s = jax.device_put(jnp.asarray(dirs), rs)
    targets_s = jax.device_put(targets, rs)

    losses = []
    for _ in range(8):
        params, opt_state, loss = step(params, opt_state, origins_s, dirs_s, targets_s)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses
    assert np.isfinite(losses).all()


def test_graft_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)
    g.dryrun_multichip(2)


def test_guided_train_step_with_rethresholding(world):
    """Guided fitting: train against a thresholded occupancy guide, re-build
    the guide mid-run from the evolving density (fit-time re-thresholding),
    and keep learning."""
    grid, pal = world
    albedo, _, _ = flatten.palette_arrays(pal)
    true_scene = diff.diff_scene_from_grid(grid, albedo, solid_density=20.0)
    mesh = meshlib.make_mesh(8, 1)
    rs = meshlib.rays_sharding(mesh)
    rep = meshlib.replicated(mesh)

    rng = np.random.default_rng(1)
    N = 256
    origins = np.full((N, 3), 32.0, np.float32)
    origins[:, 1] = 40.0
    dirs = rng.normal(size=(N, 3)).astype(np.float32)
    dirs[:, 1] = -np.abs(dirs[:, 1]) - 0.5
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    targets = diff.render_rays_diff(
        true_scene, jnp.asarray(origins), jnp.asarray(dirs), num_steps=48, sky=False
    )

    params = jax.device_put(shardlib.init_params((64, 64, 64)), rep)
    optimizer = optax.adam(5e-2)
    opt_state = jax.device_put(optimizer.init(params), rep)
    step = shardlib.make_train_step_guided(mesh, optimizer, num_steps=24)
    origins_s = jax.device_put(jnp.asarray(origins), rs)
    dirs_s = jax.device_put(jnp.asarray(dirs), rs)
    targets_s = jax.device_put(targets, rs)

    losses = []
    guide = jax.device_put(shardlib.guide_scene_from_params(params, tau=1.0), rep)
    for i in range(8):
        if i == 4:  # re-threshold mid-run against the evolved field
            guide = jax.device_put(
                shardlib.guide_scene_from_params(params, tau=1.0), rep
            )
        params, opt_state, loss = step(
            params, opt_state, guide, origins_s, dirs_s, targets_s
        )
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses
    assert np.isfinite(losses).all()


def test_scaling_harness_runs(world):
    """The scaling-efficiency harness (BASELINE's >=85% metric) runs on the
    virtual mesh and reports rates + efficiencies for each device count."""
    from raytracing_test_tpu.parallel import scaling

    grid, pal = world
    scene = flatten.scene_from_grid(grid, pal)
    cam = Camera(
        pos=jnp.asarray([24.0, 45.0, 24.0], jnp.float32),
        dir=jnp.asarray([0.5, -0.6, 0.5], jnp.float32),
    )
    rcfg = RenderConfig(width=32, height=8, max_steps=48, shadow_steps=16)
    rates = scaling.measure_render_scaling(
        scene, cam, rcfg, device_counts=[1, 2], iters=1
    )
    assert set(rates) == {1, 2} and all(v > 0 for v in rates.values())
    eff = scaling.efficiency(rates)
    assert eff[1] == 1.0 and eff[2] > 0


@pytest.mark.parametrize("shading", [False, True], ids=["plain", "shaded"])
def test_guided_train_step_dp_matches_single_device(shading):
    """make_train_step_guided (rays sharded, field replicated, gradient psum
    from the sharding annotations) gives the same loss and parameter update
    on an 8-way data mesh as on one device."""
    from raytracing_test_tpu.config import WorldConfig

    wcfg = WorldConfig(width=24, length=24, grid_shape=(32, 32, 32))
    grid, pal = terrain.gen_world_grid(wcfg)
    albedo, _, _ = flatten.palette_arrays(pal)
    true_scene = diff.diff_scene_from_grid(grid, albedo, solid_density=20.0)
    rng = np.random.default_rng(3)
    N = 16 * len(jax.devices())
    origins = np.full((N, 3), 16.0, np.float32)
    origins[:, 1] = 28.0
    dirs = rng.normal(size=(N, 3)).astype(np.float32)
    dirs[:, 1] = -np.abs(dirs[:, 1]) - 0.5
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    targets = np.asarray(diff.render_rays_diff(
        true_scene, jnp.asarray(origins), jnp.asarray(dirs), num_steps=48, sky=False))
    p0 = jax.tree_util.tree_map(np.asarray, shardlib.init_params((32, 32, 32)))
    guide = shardlib.guide_scene_from_params(p0, tau=1.0)
    optimizer = optax.adam(1e-2)

    outs = {}
    for n in (1, len(jax.devices())):
        mesh = meshlib.make_mesh(n, 1)
        rs, rep = meshlib.rays_sharding(mesh), meshlib.replicated(mesh)
        step = shardlib.make_train_step_guided(
            mesh, optimizer, num_steps=8, shading=shading)
        p, o, loss = step(
            jax.device_put(p0, rep), jax.device_put(optimizer.init(p0), rep),
            jax.device_put(guide, rep), jax.device_put(origins, rs),
            jax.device_put(dirs, rs), jax.device_put(targets, rs))
        outs[n] = (float(loss), np.asarray(p.density_raw), np.asarray(p.albedo_raw))
    l1, d1, a1 = outs[1]
    ln, dn, an = outs[len(jax.devices())]
    assert np.isfinite(l1) and abs(l1 - ln) <= 1e-6 * abs(l1), (l1, ln)
    np.testing.assert_allclose(dn, d1, atol=1e-6)
    np.testing.assert_allclose(an, a1, atol=1e-6)
