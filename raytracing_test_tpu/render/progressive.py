"""Progressive refinement: coarse depth pass seeds the full-resolution march.

The reference ships (disabled) mid_res/full_res shaders implementing exactly
this idea: a low-res pass writes hit distances; each refinement pass samples
the 3x3 neighborhood of the coarser result, takes the minimum distance, and
fast-forwards its rays to that depth before continuing the DDA
(mid_res.frag:156-265, full_res.frag:215-277; wired out at setup.cpp:419-420).

Here the scheme runs on the fast path: a coarse render records per-pixel hit
parameter t (straight-line camera distance); the fine pass starts each ray at
min over its coarse 3x3 neighborhood of (t - margin). Material-bent coarse
pixels (reflection/refraction, hit or miss) seed 0 — their t is not a
straight-ray depth.
Like the reference's version this is an approximation: thin features smaller
than a coarse pixel can be skipped; the tests bound the error.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig, replace
from ..core.flatten import Scene
from .camera import Camera, ray_directions
from . import fast
from .renderer import _build_ray


def coarse_depth(scene: Scene, camera: Camera, cfg: RenderConfig, factor: int):
    """Render at 1/factor resolution; returns straight-ray hit t [h, w]."""
    h, w = cfg.height // factor, cfg.width // factor
    ccfg = replace(cfg, width=w, height=h, enable_shadows=False, enable_ao=False)
    dirs = ray_directions(camera, w, h, cfg.fov_degrees)
    _, aux = fast.render_rays_fast(scene, camera.pos, dirs, ccfg)
    p = aux["hit_pos"]
    t = jnp.linalg.norm(p - jnp.asarray(camera.pos)[None, :], axis=1)
    # a ray bent by a material (reflection, or refraction into water or
    # glass) ends at a t that is no straight-ray depth, hit or not: seed 0
    straight = jnp.all(aux["ray_dir"] == _build_ray(dirs)[0], axis=1)
    # straight sky pixels seed "very far" — min-of-neighborhood keeps edges safe
    t = jnp.where(straight, jnp.where(aux["hit"], t, 1e6), 0.0)
    return t.reshape(h, w)


def seed_from_depth(depth, factor: int, H: int, W: int, margin: float = 2.0):
    """Min over the 3x3 coarse neighborhood, upsampled to [H*W] seeds
    (the mid_res 8-neighbor minimum, mid_res.frag:211-217)."""
    d = depth
    pad = jnp.pad(d, 1, mode="edge")
    mins = d
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            mins = jnp.minimum(mins, pad[1 + dy : 1 + dy + d.shape[0], 1 + dx : 1 + dx + d.shape[1]])
    seeds = jnp.maximum(mins - margin, 0.0)
    seeds = jnp.repeat(jnp.repeat(seeds, factor, axis=0), factor, axis=1)
    seeds = seeds[:H, :W]
    # never skip past the far sentinel
    return jnp.minimum(seeds, 1e5).reshape(H * W)


def render_image_progressive(
    scene: Scene, camera: Camera, cfg: RenderConfig, factor: int = 4, margin: float = 2.0
):
    """Coarse-to-fine frame render; returns (image [H,W,3], fine aux)."""
    depth = coarse_depth(scene, camera, cfg, factor)
    seeds = seed_from_depth(depth, factor, cfg.height, cfg.width, margin)
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    col, aux = fast.render_rays_fast(scene, camera.pos, dirs, cfg, start_t=seeds)
    return col.reshape(cfg.height, cfg.width, 3), aux
