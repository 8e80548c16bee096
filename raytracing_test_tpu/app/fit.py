"""Inverse rendering: fit voxel densities/albedos (and optionally camera
poses) from target views — BASELINE config 4 and the framework's headline
differentiable workload (no reference analog; the reference pipeline is
non-differentiable GLSL).

Targets are rendered with the hard renderer from a ring of cameras around the
world; the optimization recovers the continuous fields with the volumetric
renderer under data-parallel sharding (rays + views sharded over the mesh's
"data" axis, gradient psum from sharding annotations).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
import optax

from ..config import FitConfig, RenderConfig, WorldConfig
from ..core import flatten
from ..parallel import mesh as meshlib
from ..parallel import sharding as shardlib
from ..render import fast
from ..render.camera import Camera, camera_from_yaw_pitch, ray_directions
from ..utils.log import debug
from . import checkpoint


def ring_cameras(center, radius: float, height: float, n: int) -> List[Camera]:
    """n cameras on a ring looking at ``center``."""
    cams = []
    cx, cy, cz = center
    for i in range(n):
        a = 2 * math.pi * i / n
        pos = (cx + radius * math.cos(a), height, cz + radius * math.sin(a))
        d = np.asarray([cx - pos[0], cy - pos[1], cz - pos[2]], np.float32)
        d /= np.linalg.norm(d)
        cams.append(Camera(pos=jnp.asarray(pos, jnp.float32), dir=jnp.asarray(d)))
    return cams


def make_targets(scene, cams: List[Camera], res: int):
    """Ground-truth views via the fast hard renderer (no shadows — the
    volumetric model has no shadow term)."""
    rcfg = RenderConfig(width=res, height=res, enable_shadows=False)
    render = jax.jit(lambda sc, pos, d: fast.render_rays_fast(sc, pos, d, rcfg)[0])
    origins, dirs, rgbs = [], [], []
    for cam in cams:
        d = ray_directions(cam, res, res)
        col = render(scene, cam.pos, d)
        origins.append(jnp.broadcast_to(cam.pos[None, :], d.shape))
        dirs.append(d)
        rgbs.append(col)
    return (
        jnp.concatenate(origins),
        jnp.concatenate(dirs),
        jnp.concatenate(rgbs),
    )


def fit_targets(scene, grid_shape, fcfg: FitConfig):
    """(origins, dirs, targets) of every target ray: ``fcfg.views`` ring
    cameras around the grid window at ``fcfg.resolution``."""
    Sx, Sy, Sz = grid_shape
    center = (Sx / 2, Sy / 3, Sz / 2)
    cams = ring_cameras(center, radius=0.8 * Sx, height=0.9 * Sy, n=fcfg.views)
    return make_targets(scene, cams, fcfg.resolution)


def fit_world(
    scene,
    grid_shape,
    fcfg: FitConfig = FitConfig(),
    mesh=None,
    batch: int = 16384,
    seed: int = 0,
    ckpt_path: Optional[str] = None,
    log_every: int = 20,
):
    """Run the fit; returns (params, losses)."""
    mesh = mesh or meshlib.make_mesh(len(jax.devices()), 1)
    rs = meshlib.rays_sharding(mesh)
    rep = meshlib.replicated(mesh)

    origins, dirs, targets = fit_targets(scene, grid_shape, fcfg)
    N = origins.shape[0]
    debug(1, f"fit: {fcfg.views} views, {N} target rays")

    params = jax.device_put(shardlib.init_params(grid_shape), rep)
    optimizer = optax.adam(fcfg.lr)
    opt_state = jax.device_put(optimizer.init(params), rep)
    if fcfg.guided:
        step_fn = shardlib.make_train_step_guided(
            mesh, optimizer, num_steps=fcfg.guided_steps,
            shading=fcfg.shading,
        )
    else:
        step_fn = shardlib.make_train_step(mesh, optimizer, num_steps=96)
    guide = None

    rng = np.random.default_rng(seed)
    # batch must divide evenly over devices
    ndev = mesh.devices.size
    batch = (batch // ndev) * ndev
    losses = []
    for step in range(fcfg.steps):
        if fcfg.guided and (guide is None or step % fcfg.rethreshold_every == 0):
            # occupancy re-thresholding: rebuild the guide from the current
            # density so guided sampling tracks the evolving field
            guide = jax.device_put(
                shardlib.guide_scene_from_params(params, tau=fcfg.guide_tau), rep
            )
        idx = rng.integers(0, N, batch)
        o = jax.device_put(origins[idx], rs)
        d = jax.device_put(dirs[idx], rs)
        t = jax.device_put(targets[idx], rs)
        if fcfg.guided:
            params, opt_state, loss = step_fn(params, opt_state, guide, o, d, t)
        else:
            params, opt_state, loss = step_fn(params, opt_state, o, d, t)
        losses.append(float(loss))
        if step % log_every == 0:
            debug(1, f"fit step {step}: loss {losses[-1]:.5f}")
        if ckpt_path and step and step % 100 == 0:
            checkpoint.save_fit(ckpt_path, params, opt_state, step)
    if ckpt_path:
        checkpoint.save_fit(ckpt_path, params, opt_state, fcfg.steps)
    return params, losses
