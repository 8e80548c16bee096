"""Sharded execution: ray/tile-parallel rendering and data-parallel training.

The renderer is embarrassingly parallel over rays, so the forward path shards
the pixel axis over the mesh's "data" axis with the scene replicated — the
analog of DP. For training (inverse rendering), rays+targets are sharded and
the voxel-field gradients are all-reduced: the psum is inserted by XLA
from the sharding annotations (scene replicated in, replicated grads out), per
the standard jax.sharding recipe. Spatial world sharding (the "space" axis)
lives in parallel/spatial.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RenderConfig
from ..core.flatten import Scene
from ..render import renderer
from ..render.camera import Camera, ray_directions
from ..render.diff import DiffScene, render_rays_diff
from .mesh import DATA_AXIS, rays_sharding, replicated


def shard_scene(scene: Scene, mesh: Mesh) -> Scene:
    """Replicate the scene on every device of the mesh."""
    rep = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, rep), scene)


def render_image_sharded(
    scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh
):
    """Forward render with rays sharded over the mesh's data axis."""
    rs = rays_sharding(mesh)
    rep = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, rep, rs),
        out_shardings=rs,
    )
    def _render(scene, pos, dirs):
        col, _ = renderer.render_rays(scene, pos, dirs, cfg)
        return col

    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    dirs = jax.device_put(dirs, rs)
    col = _render(shard_scene(scene, mesh), camera.pos, dirs)
    return col.reshape(cfg.height, cfg.width, 3)


# --------------------------------------------------------------- training step


class FitParams(NamedTuple):
    """Optimizable voxel fields: density through softplus for positivity."""

    density_raw: jnp.ndarray  # f32 [Sx,Sy,Sz]; sigma = softplus(density_raw)
    albedo_raw: jnp.ndarray  # f32 [Sx,Sy,Sz,3]; albedo = sigmoid(albedo_raw)


def params_to_scene(p: FitParams, density_scale: float = 25.0) -> DiffScene:
    return DiffScene(
        density=jax.nn.softplus(p.density_raw) * density_scale,
        albedo=jax.nn.sigmoid(p.albedo_raw),
    )


def init_params(grid_shape, key=None) -> FitParams:
    Sx, Sy, Sz = grid_shape
    return FitParams(
        density_raw=jnp.full((Sx, Sy, Sz), -2.0, jnp.float32),
        albedo_raw=jnp.zeros((Sx, Sy, Sz, 3), jnp.float32),
    )


def loss_fn(params: FitParams, origins, dirs, targets, num_steps: int = 128):
    scene = params_to_scene(params)
    rgb = render_rays_diff(scene, origins, dirs, num_steps=num_steps, sky=False)
    return jnp.mean((rgb - targets) ** 2)


def guide_scene_from_params(
    params: FitParams, tau: float = 1.0, density_scale: float = 25.0
) -> Scene:
    """Threshold the EVOLVING density field into an occupancy guide Scene
    (fit-time occupancy re-thresholding).

    The guide's distance-encoded grid steers surface-guided sampling
    (render/diff.py render_rays_diff_guided) during fitting: the hard march
    finds the current surface estimate, the volumetric window samples around
    it. Re-threshold every K optimizer steps so the guide tracks the field.
    Pruning is one-directional (carving): matter cannot re-emerge inside a
    region the guide has pruned, which is the standard occupancy-grid
    trade-off — keep ``tau`` below the rendering-relevant density.
    """
    import numpy as np
    from ..core.color import rgb_to_u64
    from ..core.tree import Palette
    from ..core.types import Block

    dens = np.asarray(jax.nn.softplus(params.density_raw)) * density_scale
    occ = (dens > tau).astype(np.uint8)  # material id 1 where occupied
    pal = Palette()
    pal.id_for(Block(0, int(rgb_to_u64(255, 255, 255))))
    from ..core import flatten as _fl

    return _fl.scene_from_grid(occ, pal)


def make_train_step_guided(
    mesh: Mesh, optimizer, num_steps: int = 24, shading: bool = False,
    shadow_steps: int = 0,
):
    """Training step using surface-guided sampling against a (periodically
    re-thresholded) occupancy guide scene. Same sharding recipe as
    make_train_step; the guide is replicated and non-differentiable.
    ``shading``/``shadow_steps`` enable the face-shaded (+ soft sun shadow)
    volumetric model so targets rendered with shading can be fit directly."""
    from ..render.diff import render_rays_diff_guided

    rs = rays_sharding(mesh)
    rep = replicated(mesh)

    def loss_g(params, guide, origins, dirs, targets):
        scene = params_to_scene(params)
        rgb = render_rays_diff_guided(
            scene, guide, origins, dirs, num_steps=num_steps, sky=False,
            shading=shading, shadow_steps=shadow_steps,
        )
        return jnp.mean((rgb - targets) ** 2)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, rep, rep, rs, rs, rs),
        out_shardings=(rep, rep, rep),
        donate_argnums=(0, 1),
    )
    def train_step(params, opt_state, guide, origins, dirs, targets):
        loss, grads = jax.value_and_grad(loss_g)(
            params, guide, origins, dirs, targets
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


def make_train_step(mesh: Mesh, optimizer, num_steps: int = 128):
    """Data-parallel training step: rays sharded, params replicated, gradient
    all-reduce inserted by XLA from the sharding annotations."""
    rs = rays_sharding(mesh)
    rep = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, rep, rs, rs, rs),
        out_shardings=(rep, rep, rep),
        donate_argnums=(0, 1),
    )
    def train_step(params, opt_state, origins, dirs, targets):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, origins, dirs, targets, num_steps
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step
