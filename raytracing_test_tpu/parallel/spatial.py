"""Spatial world sharding: the voxel grid split across devices, rays exchanged
collectively (BASELINE config 5).

The reference caps world size at one GPU's memory (4 GiB SSBO pools,
voxel_allocator.hpp:12-14). Here the grid's x axis is sharded over the mesh's
"space" axis so each device stores 1/K of the world; the march runs under
``shard_map`` with rays replicated across the space axis, and every voxel
lookup becomes a one-hot collective: each device answers for cells inside its
slab (anything else contributes 0 = air) and a ``psum`` over the space axis
assembles the true material id. Rays remain sharded over the "data" axis, so
the two parallelism forms compose: dp = rays/pixels, sp = world extent.

This is the halo-free formulation — communication is one small [N] psum per
DDA step, and marching work is duplicated across the space axis. It
trades compute for world memory (the scarce resource config 5 is
about). A segment-handoff formulation (each slab marches only its resident
rays, exchanging boundary-crossing rays via ppermute) is the follow-up
optimization; the collective-lookup version is the semantics anchor it will be
validated against.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import RenderConfig
from ..core.flatten import Scene
from ..render import renderer
from ..render.camera import Camera, ray_directions
from .mesh import DATA_AXIS, SPACE_AXIS


def shard_scene_spatial(scene: Scene, mesh: Mesh) -> Scene:
    """Place the scene with the material grid sharded along x over SPACE.

    Only ``mat`` is spatially sharded (it dominates memory at scale); the small
    palette tables and the acceleration structure stay replicated. (The fast
    path's brick tables would shard the same way; the spatial march uses the
    reference path for now.)
    """
    rep = NamedSharding(mesh, P())
    mat_sh = NamedSharding(mesh, P(SPACE_AXIS, None, None))
    return Scene(
        mat=jax.device_put(scene.mat, mat_sh),
        macro=jax.device_put(scene.macro, rep),
        albedo=jax.device_put(scene.albedo, rep),
        flags=jax.device_put(scene.flags, rep),
        metadata=jax.device_put(scene.metadata, rep),
        grid_enc=jax.device_put(scene.grid_enc, mat_sh),
        y_max=jax.device_put(scene.y_max, rep),
    )


def _slab_lookup(mat_slab, shape3, slab_x0, cell):
    """Material lookup against the local x-slab; 0 outside. psum over SPACE
    assembles the full answer (exactly one slab owns any in-window cell)."""
    Sx, Sy, Sz = shape3
    slab_w = mat_slab.shape[0]
    c = cell & 1023
    inside = (c[:, 0] < Sx) & (c[:, 1] < Sy) & (c[:, 2] < Sz)
    lx = c[:, 0] - slab_x0
    local = inside & (lx >= 0) & (lx < slab_w)
    lin = (jnp.where(local, lx, 0) * Sy + c[:, 1]) * Sz + c[:, 2]
    m = jnp.take(mat_slab.reshape(-1), lin).astype(jnp.int32)
    m = jnp.where(local, m, 0)
    return jax.lax.psum(m, SPACE_AXIS)


def render_rays_spatial(
    scene: Scene, origin, dirs, cfg: RenderConfig, mesh: Mesh
):
    """Full-feature render over a spatially-sharded world.

    ``scene`` must be placed by shard_scene_spatial; ``dirs`` is [N,3] with N
    divisible by the data-axis size. Returns rgb [N,3] sharded over data.
    """
    Sx, Sy, Sz = scene.shape3
    n_space = mesh.shape[SPACE_AXIS]
    slab_w = Sx // n_space

    scene_specs = Scene(
        mat=P(SPACE_AXIS, None, None),
        macro=P(), albedo=P(), flags=P(), metadata=P(),
        grid_enc=P(SPACE_AXIS, None, None), y_max=P(),
    )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(scene_specs, P(), P(DATA_AXIS, None)),
        out_specs=P(DATA_AXIS, None),
        check_vma=False,
    )
    def _render(scene_slab, origin, dirs):
        idx = jax.lax.axis_index(SPACE_AXIS)
        x0 = idx * slab_w

        def lookup(cell):
            return _slab_lookup(scene_slab.mat, (Sx, Sy, Sz), x0, cell)

        s, raw0, mat0, sun = renderer._primary_march(
            scene_slab, origin, dirs, cfg, lookup_fn=lookup
        )

        def shadow_fn(p, cell, last_axis, step, active):
            return renderer._shadow_march(
                scene_slab, p, cell, last_axis, step, cfg, sun, active,
                lookup_fn=lookup,
            )

        col, _ = renderer.shade(scene_slab, s, raw0, mat0, sun, cfg, shadow_fn,
                                ao_lookup_fn=lookup)
        return col

    return _render(scene, jnp.asarray(origin, jnp.float32), jnp.asarray(dirs, jnp.float32))


@functools.lru_cache(maxsize=16)
def _render_spatial_jit(cfg: RenderConfig, mesh: Mesh):
    # one executable per (config, mesh): repeated frames must not retrace
    return jax.jit(lambda sc, pos, d: render_rays_spatial(sc, pos, d, cfg, mesh))


def render_image_spatial(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh):
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    rs = NamedSharding(mesh, P(DATA_AXIS, None))
    dirs = jax.device_put(dirs, rs)
    col = _render_spatial_jit(cfg, mesh)(scene, camera.pos, dirs)
    return np.asarray(col).reshape(cfg.height, cfg.width, 3)
