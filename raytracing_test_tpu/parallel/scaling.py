"""Scaling-efficiency harness: rays/s vs device count.

Measures the ray-sharded forward render on meshes of 1..N devices of one
host and reports throughput + efficiency vs linear scaling. Every timed call
ends in ``block_until_ready``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..core.flatten import Scene
from ..render import fast
from ..render.camera import Camera, ray_directions
from .mesh import make_mesh, rays_sharding, replicated


def measure_render_scaling(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    device_counts: List[int] = None,
    iters: int = 3,
) -> Dict[int, float]:
    """rays/s of the fast forward render for each device count."""
    ndev = len(jax.devices())
    device_counts = device_counts or sorted(
        {1, 2, 4, 8, ndev} & set(range(1, ndev + 1))
    )
    dirs = np.asarray(ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees))
    N = dirs.shape[0]
    out = {}
    for k in device_counts:
        if N % k:
            continue
        mesh = make_mesh(k, 1, jax.devices()[:k])
        rs = rays_sharding(mesh)
        rep = replicated(mesh)
        sc = jax.tree_util.tree_map(lambda x: jax.device_put(x, rep), scene)
        fwd = jax.jit(
            lambda s, p, d: fast.render_rays_fast(s, p, d, cfg)[0],
            in_shardings=(rep, rep, rs),
            out_shardings=rs,
        )
        d = jax.device_put(jnp.asarray(dirs), rs)
        pos = jax.device_put(camera.pos, rep)
        fwd(sc, pos, d).block_until_ready()  # warmup/compile
        t0 = time.perf_counter()
        for _ in range(iters):
            fwd(sc, pos, d).block_until_ready()
        dt = (time.perf_counter() - t0) / iters
        out[k] = N / dt
    return out


def efficiency(rates: Dict[int, float]) -> Dict[int, float]:
    """Scaling efficiency relative to the smallest measured device count."""
    if not rates:
        return {}
    k0 = min(rates)
    base = rates[k0] / k0
    return {k: rates[k] / (k * base) for k in rates}
