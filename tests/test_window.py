"""The XLA guided window (render/diff.render_rays_diff_window): every
accumulator x enumeration x feature set against the sequential scan
(render_rays_diff) or, where the scan has no such feature, against the
scatter/scan window and finite differences; pose gradients; and the guided
seed split (diff.guided_seed)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_test_tpu.core import flatten
from raytracing_test_tpu.core.color import rgb_to_u64
from raytracing_test_tpu.core.tree import Palette
from raytracing_test_tpu.core.types import Block
from raytracing_test_tpu.render import diff
from raytracing_test_tpu.render.camera import Camera, ray_directions

VARIANTS = [("scatter", "scan"), ("scatter", "vec"), ("dedup", "scan"), ("dedup", "vec")]
FEATURES = {
    "plain": dict(sky=False),
    "sky": dict(sky=True),
    "shading": dict(sky=False, shading=True),
    "shadow": dict(sky=False, shading=True, shadow_steps=6),
}
CAM = Camera(
    pos=jnp.asarray([16.0, 20.0, 16.0], jnp.float32),
    dir=jnp.asarray([0.3, -0.8, 0.4], jnp.float32),
)


@pytest.fixture(scope="module")
def dscene():
    pal = Palette()
    red = pal.id_for(Block(0, int(rgb_to_u64(200, 30, 30))))
    green = pal.id_for(Block(0, int(rgb_to_u64(30, 200, 30))))
    grid = np.zeros((64, 64, 64), np.uint8)
    grid[:, 0:8, :] = red
    grid[10:14, 8:12, 10:14] = green
    albedo, _, _ = flatten.palette_arrays(pal)
    return diff.DiffScene(
        density=jnp.asarray(np.where(grid > 0, 8.0, 0.0).astype(np.float32)),
        albedo=jnp.asarray(albedo[grid]),
    )


def _rgb_and_grads(fn, ds):
    """(rgb, field grads of mean(rgb^2)) of ``fn(scene)``, jitted."""
    def loss(s):
        rgb = fn(s)
        return jnp.mean(rgb ** 2), rgb

    (_, rgb), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(ds)
    return np.asarray(rgb), g


def _window(accum, emode, feats, dirs=None, origin=None, seed=None):
    dirs = ray_directions(CAM, 12, 12) if dirs is None else dirs
    origin = CAM.pos if origin is None else origin
    seed = jnp.zeros(dirs.shape[0], jnp.float32) if seed is None else seed
    return lambda s: diff.render_rays_diff_window(
        s, origin, dirs, num_steps=24, start_t=seed, accum=accum,
        enumerate_mode=emode, **feats)


def _assert_grads_close(g, g_ref, tol, msg):
    for k in ("density", "albedo"):
        a, b = np.asarray(getattr(g, k)), np.asarray(getattr(g_ref, k))
        sc = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / sc, b / sc, atol=tol, err_msg=f"{msg}:{k}")


@pytest.mark.parametrize("feature", list(FEATURES))
@pytest.mark.parametrize("accum,emode", VARIANTS, ids=["/".join(v) for v in VARIANTS])
def test_window_variant_matches_anchor(dscene, accum, emode, feature):
    """rgb and field gradients of each window variant. Plain and sky windows
    are compared with the sequential scan (the same segments composited as a
    running product); the scan has no face shading or soft shadows, so
    shaded windows are compared with the scatter/scan window, which itself is
    checked against central finite differences."""
    feats = FEATURES[feature]
    rgb, g = _rgb_and_grads(_window(accum, emode, feats), dscene)
    assert np.isfinite(rgb).all()
    if feature in ("plain", "sky"):
        dirs = ray_directions(CAM, 12, 12)
        seed = jnp.zeros(dirs.shape[0], jnp.float32)
        ref_rgb, g_ref = _rgb_and_grads(
            lambda s: diff.render_rays_diff(
                s, CAM.pos, dirs, num_steps=24, start_t=seed, sky=feats["sky"]),
            dscene)
        np.testing.assert_allclose(rgb, ref_rgb, atol=2e-5)
        _assert_grads_close(g, g_ref, 2e-4, f"{accum}/{emode}/{feature}")
        return
    if (accum, emode) != ("scatter", "scan"):
        ref_rgb, g_ref = _rgb_and_grads(_window("scatter", "scan", feats), dscene)
        np.testing.assert_allclose(rgb, ref_rgb, atol=2e-5)
        _assert_grads_close(g, g_ref, 2e-4, f"{accum}/{emode}/{feature}")
        return
    # the anchor window: density gradients vs central finite differences at
    # the solid cells with the largest gradients (the soft shadow's start
    # point is detached, so air cells near the camera, which only move that
    # point, are not probed)
    f = jax.jit(lambda s: jnp.mean(_window(accum, emode, feats)(s) ** 2))
    gd = np.asarray(g.density)
    solid = np.asarray(dscene.density) > 0
    eps = 1e-2
    for idx in np.argsort(-np.abs(np.where(solid, gd, 0.0)).ravel())[:4]:
        cell = np.unravel_index(idx, gd.shape)
        d0 = np.asarray(dscene.density).copy()
        d0[cell] += eps
        fp = float(f(dscene._replace(density=jnp.asarray(d0))))
        d0[cell] -= 2 * eps
        fm = float(f(dscene._replace(density=jnp.asarray(d0))))
        fd = (fp - fm) / (2 * eps)
        assert abs(fd - gd[cell]) <= 2e-2 * abs(fd) + 1e-7, (cell, fd, gd[cell])


@pytest.mark.parametrize("accum,emode", VARIANTS, ids=["/".join(v) for v in VARIANTS])
def test_window_pose_gradients(dscene, accum, emode):
    """Gradients w.r.t. ray directions and a shared origin (the camera-pose
    fit path) flow through the window's crossing parameters and match the
    sequential scan's autodiff."""
    dirs = ray_directions(CAM, 8, 8)
    seed = jnp.zeros(dirs.shape[0], jnp.float32)

    def win(o, d):
        return jnp.mean(diff.render_rays_diff_window(
            dscene, o, d, num_steps=24, start_t=seed, sky=False, accum=accum,
            enumerate_mode=emode) ** 2)

    def scan(o, d):
        return jnp.mean(diff.render_rays_diff(
            dscene, o, d, num_steps=24, start_t=seed, sky=False) ** 2)

    go, gdir = jax.jit(jax.grad(win, argnums=(0, 1)))(CAM.pos, dirs)
    ro, rdir = jax.jit(jax.grad(scan, argnums=(0, 1)))(CAM.pos, dirs)
    for got, ref in ((go, ro), (gdir, rdir)):
        got, ref = np.asarray(got), np.asarray(ref)
        assert np.isfinite(got).all() and np.abs(ref).max() > 0
        sc = np.abs(ref).max()
        np.testing.assert_allclose(got / sc, ref / sc, atol=2e-4)


def test_guided_render_is_window_from_guided_seed():
    """render_rays_diff_guided == the window started at diff.guided_seed."""
    from raytracing_test_tpu.config import WorldConfig
    from raytracing_test_tpu.worldgen import terrain

    grid, pal = terrain.gen_world_grid(
        WorldConfig(width=24, length=24, grid_shape=(32, 32, 32)))
    hard = flatten.scene_from_grid(grid, pal)
    albedo, _, _ = flatten.palette_arrays(pal)
    ds = diff.diff_scene_from_grid(grid, albedo, solid_density=50.0)
    cam = Camera(pos=jnp.asarray([4.0, 40.0, 4.0], jnp.float32),
                 dir=jnp.asarray([0.55, -0.6, 0.55], jnp.float32))
    dirs = ray_directions(cam, 16, 16)
    seed = diff.guided_seed(hard, cam.pos, dirs, image_hw=(16, 16))
    s = np.asarray(seed)
    assert (s < diff.MISS_SEED_MIN).any() and (s >= 0).all()
    got = diff.render_rays_diff_guided(
        ds, hard, cam.pos, dirs, num_steps=24, image_hw=(16, 16), accum="scatter")
    ref = diff.render_rays_diff_window(
        ds, cam.pos, dirs, num_steps=24, start_t=seed, accum="scatter")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    with pytest.raises(ValueError, match="unknown engine"):
        diff.guided_seed(hard, cam.pos, dirs, engine="bricks-pallas")
