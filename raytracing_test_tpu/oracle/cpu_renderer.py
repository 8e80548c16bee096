"""CPU oracle renderer: scalar, obviously-correct transcription of the render
semantics (src/shaders/low_res.frag), used as the allclose target for the JAX
device paths.

Deliberately written as straight-line per-ray Python/numpy-scalar code — slow,
independent of the vectorized implementation, and easy to audit against the
reference GLSL side by side. Shares only the Scene container and config with
the device path. See render/renderer.py's module docstring for the documented
deviations from the reference (position tracking via segment origin + t, unified
march budget, sanitized zero direction components) — the oracle implements the
same choices so device parity is exact.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from ..config import RenderConfig
from ..core.types import Properties

_EPS_DIR = 1e-12


def _lookup(mat_grid: np.ndarray, x: int, y: int, z: int) -> int:
    Sx, Sy, Sz = mat_grid.shape
    x &= 1023
    y &= 1023
    z &= 1023
    if x < Sx and y < Sy and z < Sz:
        return int(mat_grid[x, y, z])
    return 0


def _build_ray(d):
    d = np.where(np.abs(d) < _EPS_DIR, _EPS_DIR, d).astype(np.float32)
    step = np.where(d < 0, -1.0, 1.0).astype(np.float32)
    delta = (1.0 / d).astype(np.float32)
    return d, step, delta, np.abs(delta)


def _init_tmax(p, cell, step, delta, abs_delta):
    shifted = p + np.minimum(step, 0.0, dtype=np.float32)
    return (abs_delta - (shifted - cell.astype(np.float32)) * delta).astype(np.float32)


def _axis(tmax) -> int:
    if tmax[0] < tmax[1] and tmax[0] < tmax[2]:
        return 0
    if tmax[1] < tmax[2]:
        return 1
    return 2


def _sigmoid(x, scale, steep):
    return 1.0 / (1.0 + math.exp(-x * steep)) * scale


def skybox_scalar(d, sun_dir):
    d = d.copy()
    if d[1] < 0:
        d[1] *= 1.4
    haze = (0.1 - abs(np.clip(d[1], -0.3, 0.3))) * 0.8 + 0.1
    modifier = np.clip(_sigmoid(1.0 - haze * 2.0, 1.0, 2.0), 0.0, 1.0)
    sky = np.array([0.2, 0.4, 1.0], np.float32)
    b = float(np.linalg.norm(d - sun_dir)) * 50.0
    sun = np.array([1.0, 1.0, 0.0], np.float32) * _sigmoid(1.5 - b, 1.0, 1.6)
    return (sky + np.clip(haze, 0.0, 1.0) * 3.0) * modifier + sun


def trace_ray(
    mat_grid: np.ndarray,
    flags_tab: np.ndarray,
    albedo_tab: np.ndarray,
    origin: np.ndarray,
    direction: np.ndarray,
    cfg: RenderConfig,
    sun: np.ndarray,
) -> np.ndarray:
    """Trace one ray; returns rgb float32[3]."""
    f32 = np.float32
    d, step, delta, abs_delta = _build_ray(direction.astype(f32))
    origin = origin.astype(f32)
    cell = np.floor(origin).astype(np.int64)
    tmax = _init_tmax(origin, cell, step, delta, abs_delta)
    seg_origin = origin.copy()
    last_t = f32(0.0)
    last_axis = 0
    color_mod = np.ones(3, f32)
    ior = 1.0
    reflected = False

    mat = _lookup(mat_grid, *cell)
    fl = int(flags_tab[mat])
    if mat != 0 and not (fl & Properties.REFRACTIVE):
        return albedo_tab[mat].astype(f32)  # camera inside a solid block
    if mat != 0:
        ior = 1.1  # starting submerged

    hit = False
    for _ in range(cfg.max_steps):
        if mat != 0:
            f7 = int(flags_tab[mat]) & 0x7
            if f7 == 0x3:  # reflect
                p = seg_origin + last_t * d
                d = d.copy()
                step = step.copy()
                d[last_axis] *= -1
                step[last_axis] *= -1
                tmax = tmax.copy()
                tmax[last_axis] -= abs_delta[last_axis]
                seg_origin = (p - last_t * d).astype(f32)
                color_mod = color_mod * f32(0.94)
                reflected = True
            elif f7 == 0x5:  # refract
                liquid = bool(int(flags_tab[mat]) & Properties.LIQUID)
                color_mod = color_mod * (
                    np.array([0.94, 0.97, 1.0], f32) if liquid else f32(0.95)
                )
                if ior != 1.1:
                    p = seg_origin + last_t * d
                    normal = np.zeros(3, f32)
                    normal[last_axis] = step[last_axis]
                    if liquid:
                        normal[0] += (
                            math.sin((cfg.time + p[0] * 0.2 - p[2] * 0.1) * 10.0) * 0.2
                        )
                        normal = normal / np.linalg.norm(normal)
                    r = ior / 1.1
                    c1 = float(np.dot(normal, d))
                    if c1 < 0:
                        normal = -normal
                        c1 = -c1
                    c2 = math.sqrt(max(1.0 - r * r * (1.0 - c1 * c1), 0.0))
                    d_new = (r * d + (r * c1 - c2) * normal).astype(f32)
                    d, step, delta, abs_delta = _build_ray(d_new)
                    seg_origin = p
                    tmax = _init_tmax(p, cell, step, delta, abs_delta)
                    last_t = f32(0.0)
                ior = 1.1
            else:
                hit = True
                break
        ax = _axis(tmax)
        last_t = f32(tmax[ax])
        tmax = tmax.copy()
        tmax[ax] += abs_delta[ax]
        cell = cell.copy()
        cell[ax] += int(step[ax])
        last_axis = ax
        mat = _lookup(mat_grid, *cell)

    if mat != 0:
        hit = True  # budget-exhausted on a block still shades it

    albedo = albedo_tab[mat].astype(f32)
    p = seg_origin + last_t * d

    # looked-at highlight precedes the air branch
    if tuple(int(c) for c in cell) == tuple(cfg.looking_at):
        base = albedo if hit else np.full(3, (2**21 - 1) / 2**21, f32)
        return base * 2.0 + 0.3

    if not hit:
        return (skybox_scalar(d, sun) * color_mod).astype(f32)

    lam = float(sun[last_axis] * -step[last_axis])
    facing = lam > 0
    intensity = min(max(0.0, lam) + 0.4 + (0.15 if facing else 0.0), 1.0)

    if reflected:
        return albedo * f32(intensity) * color_mod
    if not facing:
        return albedo * f32(0.3) * color_mod

    if cfg.enable_shadows:
        # shadow ray: rebuild toward the sun, step out through the hit face
        sd, sstep, sdelta, sabs = _build_ray(sun.astype(f32))
        stmax = _init_tmax(p, cell, sstep, sdelta, sabs)
        stmax[last_axis] -= sabs[last_axis]
        scell = cell.copy()
        smat = 0
        for _ in range(cfg.shadow_steps):
            ax = _axis(stmax)
            stmax[ax] += sabs[ax]
            scell[ax] += int(sstep[ax])
            smat = _lookup(mat_grid, *scell)
            if smat != 0 and not (int(flags_tab[smat]) & Properties.LIQUID):
                break
        if smat != 0:
            return albedo * f32(0.3) * color_mod

    return albedo * f32(intensity) * color_mod


def ao_factor_scalar(mat_grid, p, normal, ao_rays: int, ao_steps: int) -> float:
    """Hemisphere occlusion at a hit point — scalar twin of renderer._ao_march
    (itself the proper version of the reference's light_scattering pass)."""
    from ..render.hemisphere import fibonacci_hemisphere

    table = fibonacci_hemisphere(ao_rays, 0.85)
    n = normal.astype(np.float32)
    vertical = abs(float(n[1])) > 0.9
    up = np.array([1.0, 0.0, 0.0], np.float32) if vertical else np.array([0.0, 1.0, 0.0], np.float32)
    t1 = np.cross(up, n)
    t1 = t1 / np.linalg.norm(t1)
    t2 = np.cross(n, t1)
    start = p + n * np.float32(1e-3)
    hits = 0
    for k in range(ao_rays):
        d = table[k, 0] * t1 + table[k, 1] * n + table[k, 2] * t2
        dd, sstep, sdelta, sabs = _build_ray(d.astype(np.float32))
        cell = np.floor(start).astype(np.int64)
        tmax = _init_tmax(start, cell, sstep, sdelta, sabs)
        for _ in range(ao_steps):
            ax = _axis(tmax)
            tmax = tmax.copy()
            tmax[ax] += sabs[ax]
            cell = cell.copy()
            cell[ax] += int(sstep[ax])
            if _lookup(mat_grid, *cell) != 0:
                hits += 1
                break
    return hits / ao_rays


def render_image_oracle(
    mat_grid: np.ndarray,
    flags_tab: np.ndarray,
    albedo_tab: np.ndarray,
    cam_pos,
    cam_dir,
    cfg: RenderConfig,
) -> np.ndarray:
    """Render [H, W, 3]; same camera model as render/camera.py, recomputed
    here independently in float32."""
    H, W = cfg.height, cfg.width
    sun = np.asarray(cfg.sun_dir, np.float64)
    sun = (sun / np.linalg.norm(sun)).astype(np.float32)
    proj_x = math.tan(math.radians(cfg.fov_degrees / 2.0))
    proj_y = proj_x * H / W
    cd = np.asarray(cam_dir, np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    ppl = np.cross(cd, up)
    ppd = np.cross(cd, ppl)
    pos = np.asarray(cam_pos, np.float32)

    img = np.zeros((H, W, 3), np.float32)
    for row in range(H):
        fy = 1.0 - (row + 0.5) / H
        cy = (0.5 - fy) * proj_y
        for colx in range(W):
            fx = (colx + 0.5) / W
            cx = -(proj_x * (fx - 0.5))
            d = cd + ppl * np.float32(cx) + ppd * np.float32(cy)
            d = d / np.linalg.norm(d)
            img[row, colx] = trace_ray(
                mat_grid, flags_tab, albedo_tab, pos, d, cfg, sun
            )
    return img
