"""Pure-JAX vectorized voxel raytracer — the framework's reference device path.

This re-expresses the reference's per-pixel fragment-shader raytrace
(src/shaders/low_res.frag:256-393) as one batched computation over all rays:
every per-pixel scalar in the GLSL becomes an [N]-shaped array, GLSL early
returns become masks, and the unbounded-looking marches become a
``lax.while_loop`` with an all-rays-done early exit. The voxel lookup is a
dense-grid gather (core/flatten.py) instead of the shader's Morton-incremental
tree descent (low_res.frag:493-532) — identical results, vector-friendly shape.

Feature parity with the reference kernel:
  - Amanatides-Woo DDA march, ref tie-breaking (x strictly smallest, else y<z,
    else z — nextIntersectDDA, low_res.frag:446-491)
  - camera-inside-block handling incl. starting submerged (low_res.frag:299-307)
  - reflection: axis flip + 0.94 tint, marching state preserved
    (reflectRay, low_res.frag:178-194)
  - refraction: Snell bend to IOR 1.1 at first refractive contact, per-voxel
    tint (water (0.94,0.97,1.0), glass 0.95), animated sine water surface
    normal (refractRay, low_res.frag:198-240)
  - sun shadow ray: 75 steps, exits through the hit face, skips LIQUID
    (low_res.frag:373-391)
  - face-shaded diffuse + facing bonus + back-face 0.3 (calcLightIntensity,
    low_res.frag:242-252, 361-371)
  - skybox: haze sigmoid + sun disc (genSkyBox, low_res.frag:153-168)
  - looked-at-block highlight and crosshair overlays (low_res.frag:259-262,347)
  - hemisphere AO (the reference's wired-but-dead light_scattering pass,
    implemented properly as optional shading)

Documented deviations from the reference (shared by the CPU oracle, so
oracle <-> device parity is exact):
  - positions are tracked via segment origin + ray parameter t instead of the
    shader's incrementally-patched pos.exact; this fixes the reference's stale-
    ratios drift after reflection (low_res.frag:183-187 commented out) and its
    double-shift of the crossing axis on refraction rebuild (low_res.frag:235).
  - the march budget is one unified loop (step-for-step identical except when a
    material event lands exactly on step 300).
  - zero direction components are clamped to ±1e-12 instead of producing
    inf/NaN tMax lanes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..core.flatten import Scene
from ..core.types import Properties
from .camera import Camera, ray_directions
from .hemisphere import HEMISPHERE_DIRS_20, oriented_dirs

_EPS_DIR = 1e-12


def _sanitize(d):
    """Replace ~zero direction components with tiny positive values.

    The reference leaves 1/0 = inf in ray.delta; a +/-1e-12 floor gives the same
    marching behavior (that axis is never the closest crossing) without NaNs.
    """
    return jnp.where(jnp.abs(d) < _EPS_DIR, _EPS_DIR, d)


def _build_ray(d):
    """step/delta/absDelta from a direction (ref buildRay, low_res.frag:61-97).

    Note the reference's step is +1 for a zero component (only `< 0` flips)."""
    d = _sanitize(d)
    step = jnp.where(d < 0, -1.0, 1.0)
    delta = 1.0 / d
    abs_delta = jnp.abs(delta)
    return d, step, delta, abs_delta


def _init_tmax(p, cell, step, delta, abs_delta):
    """Per-axis parameter distance from p to the first crossing.

    Ref init (low_res.frag:290-296): exact -= 1 on negative axes, then
    deltaPos = absDelta - (exact - round) * delta.
    """
    shifted = p + jnp.minimum(step, 0.0)
    return abs_delta - (shifted - cell.astype(p.dtype)) * delta


def _argmin_axis(tmax):
    """Ref tie-breaking: x iff strictly smallest, else y iff y<z, else z
    (nextIntersectDDA, low_res.frag:450-476)."""
    tx, ty, tz = tmax[:, 0], tmax[:, 1], tmax[:, 2]
    return jnp.where((tx < ty) & (tx < tz), 0, jnp.where(ty < tz, 1, 2)).astype(jnp.int32)


def _onehot(ax, dtype=jnp.float32):
    return (jnp.arange(3, dtype=jnp.int32)[None, :] == ax[:, None]).astype(dtype)


def _get(v, ax):
    """v[:, ax] per row."""
    return jnp.take_along_axis(v, ax[:, None], axis=1)[:, 0]


def _lookup(scene: Scene, cell):
    """Material id at integer cells [N,3]; wraps &1023, air outside the window."""
    Sx, Sy, Sz = scene.mat.shape
    c = cell & 1023
    inside = (c[:, 0] < Sx) & (c[:, 1] < Sy) & (c[:, 2] < Sz)
    lin = (c[:, 0] * Sy + c[:, 1]) * Sz + c[:, 2]
    lin = jnp.where(inside, lin, 0)
    m = jnp.take(scene.mat.reshape(-1), lin).astype(jnp.int32)
    return jnp.where(inside, m, 0)


def _sigmoid(x, scale, steep):
    return scale / (1.0 + jnp.exp(-x * steep))


def skybox(d, sun_dir, dtype=jnp.float32):
    """genSkyBox (low_res.frag:157-168). ``d`` is the (normalized) ray dir
    [N,3]; the reference pre-scales dir.y by 1.4 when negative."""
    dy = jnp.where(d[:, 1] < 0, d[:, 1] * 1.4, d[:, 1])
    d2 = jnp.stack([d[:, 0], dy, d[:, 2]], axis=1)
    haze = (0.1 - jnp.abs(jnp.clip(dy, -0.3, 0.3))) * 0.8 + 0.1
    modifier = jnp.clip(_sigmoid(1.0 - haze * 2.0, 1.0, 2.0), 0.0, 1.0)
    sky = jnp.asarray([0.2, 0.4, 1.0], dtype)
    b = jnp.linalg.norm(d2 - sun_dir[None, :], axis=1) * 50.0
    sun = jnp.asarray([1.0, 1.0, 0.0], dtype)[None, :] * _sigmoid(1.5 - b, 1.0, 1.6)[:, None]
    return (sky[None, :] + jnp.clip(haze, 0.0, 1.0)[:, None] * 3.0) * modifier[:, None] + sun


class _March(NamedTuple):
    mat: jnp.ndarray  # i32[N] material at the current cell
    cell: jnp.ndarray  # i32[N,3]
    dir: jnp.ndarray  # f32[N,3]
    step: jnp.ndarray  # f32[N,3]
    abs_delta: jnp.ndarray  # f32[N,3]
    tmax: jnp.ndarray  # f32[N,3]
    seg_origin: jnp.ndarray  # f32[N,3] origin of the current ray segment
    last_t: jnp.ndarray  # f32[N] segment-parameter of the last crossing
    last_axis: jnp.ndarray  # i32[N]
    color_mod: jnp.ndarray  # f32[N,3] accumulated tint (finalColorMod)
    ior: jnp.ndarray  # f32[N]
    reflected: jnp.ndarray  # bool[N]
    done: jnp.ndarray  # bool[N] frozen (solid hit)
    steps: jnp.ndarray  # i32[N] steps actually marched (debug channel)


def classify(flags, mat, active, cfg: RenderConfig):
    """Split active lanes at a non-air block into reflect/refract/hit, matching
    the reference's flags==0x3 / ==0x5 / else-break dispatch (frag:317-328)."""
    f7 = flags & 0x7
    solid = active & (mat != 0)
    if cfg.enable_materials:
        is_refl = solid & (f7 == 0x3)
        is_refr = solid & (f7 == 0x5)
    else:
        is_refl = solid & False
        is_refr = solid & False
    return is_refl, is_refr, solid & ~is_refl & ~is_refr


def material_step(s: "_March", is_refl, is_refr, flags, cfg: RenderConfig, time_s=None):
    """Apply reflection/refraction state updates for the masked lanes.

    Returns (dir, step, abs_delta, tmax, seg_origin, last_t, color_mod, ior,
    reflected) — the post-material marching state, unchanged where unmasked.
    Shared by the reference-path march (_primary_march) and the fast brick
    march (render/fast.py). ``time_s`` is the (traced) animation clock —
    passing it as data keeps per-frame renders on one compiled executable.
    """
    if time_s is None:
        time_s = cfg.time
    p = s.seg_origin + s.last_t[:, None] * s.dir
    oh = _onehot(s.last_axis, s.dir.dtype)

    # ---- reflection (reflectRay, low_res.frag:178-194)
    refl_m = is_refl[:, None]
    dir_r = jnp.where(refl_m, s.dir * (1.0 - 2.0 * oh), s.dir)
    step_r = jnp.where(refl_m, s.step * (1.0 - 2.0 * oh), s.step)
    tmax_r = jnp.where(refl_m, s.tmax - oh * s.abs_delta, s.tmax)
    seg_r = jnp.where(refl_m, p - s.last_t[:, None] * dir_r, s.seg_origin)
    cmod = jnp.where(refl_m, s.color_mod * 0.94, s.color_mod)
    reflected = s.reflected | is_refl

    # ---- refraction (refractRay, low_res.frag:198-240)
    liquid = (flags & int(Properties.LIQUID)) > 0
    tint = jnp.where(
        liquid[:, None],
        jnp.asarray([0.94, 0.97, 1.0], s.dir.dtype)[None, :],
        jnp.asarray([0.95, 0.95, 0.95], s.dir.dtype)[None, :],
    )
    cmod = jnp.where(is_refr[:, None], cmod * tint, cmod)
    bend = is_refr & (s.ior != 1.1)
    normal = oh * step_r  # points along travel through the face
    wob = jnp.sin((time_s + p[:, 0] * 0.2 - p[:, 2] * 0.1) * 10.0) * 0.2
    normal = jnp.where(
        (bend & liquid)[:, None],
        normal + wob[:, None] * jnp.asarray([1.0, 0.0, 0.0], s.dir.dtype)[None, :],
        normal,
    )
    nn = jnp.linalg.norm(normal, axis=1, keepdims=True)
    normal = normal / jnp.where(nn > 0, nn, 1.0)
    r = s.ior / 1.1
    c1 = jnp.sum(normal * dir_r, axis=1)
    normal = jnp.where((c1 < 0)[:, None], -normal, normal)
    c1 = jnp.abs(c1)
    c2 = jnp.sqrt(jnp.maximum(1.0 - r * r * (1.0 - c1 * c1), 0.0))
    dir_b = r[:, None] * dir_r + (r * c1 - c2)[:, None] * normal
    bend_m = bend[:, None]
    new_dir = jnp.where(bend_m, dir_b, dir_r)
    new_dir_s, new_step, new_delta, new_abs = _build_ray(new_dir)
    dirx = jnp.where(bend_m, new_dir_s, dir_r)
    stepx = jnp.where(bend_m, new_step, step_r)
    absx = jnp.where(bend_m, new_abs, s.abs_delta)
    tmax_b = _init_tmax(p, s.cell, new_step, new_delta, new_abs)
    tmaxx = jnp.where(bend_m, tmax_b, tmax_r)
    segx = jnp.where(bend_m, p, seg_r)
    last_t = jnp.where(bend, 0.0, s.last_t)
    ior = jnp.where(is_refr, 1.1, s.ior)
    return dirx, stepx, absx, tmaxx, segx, last_t, cmod, ior, reflected


def _primary_march(scene: Scene, origin, dirs, cfg: RenderConfig, lookup_fn=None, time_s=None):
    """The unified primary+material march loop.

    ``lookup_fn(cell) -> mat`` overrides the voxel lookup — parallel/spatial.py
    injects a collective lookup over a spatially-sharded grid here.
    """
    lookup = lookup_fn if lookup_fn is not None else (lambda c: _lookup(scene, c))
    N = dirs.shape[0]
    f32 = dirs.dtype
    d, step, delta, abs_delta = _build_ray(dirs)
    cell = jnp.floor(origin).astype(jnp.int32)
    cell = jnp.broadcast_to(cell[None, :], (N, 3))
    origin_b = jnp.broadcast_to(origin[None, :], (N, 3)).astype(f32)
    tmax = _init_tmax(origin_b, cell, step, delta, abs_delta)
    mat0 = lookup(cell)
    flags0 = jnp.take(scene.flags, mat0)

    # camera-inside-block special cases (low_res.frag:299-307)
    refr0 = (flags0 & int(Properties.REFRACTIVE)) > 0
    raw0 = (mat0 != 0) & ~refr0  # solid start: flat color, no shading
    ior = jnp.where((mat0 != 0) & refr0, 1.1, 1.0).astype(f32)

    state = _March(
        mat=mat0,
        cell=cell,
        dir=d,
        step=step,
        abs_delta=abs_delta,
        tmax=tmax,
        seg_origin=origin_b,
        last_t=jnp.zeros(N, f32),
        last_axis=jnp.zeros(N, jnp.int32),
        color_mod=jnp.ones((N, 3), f32),
        ior=ior,
        reflected=jnp.zeros(N, bool),
        done=raw0,
        steps=jnp.zeros(N, jnp.int32),
    )

    flags_tab = scene.flags
    sun = jnp.asarray(cfg.sun_dir, f32)
    sun = sun / jnp.linalg.norm(sun)

    def body(carry):
        s, i = carry
        flags = jnp.take(flags_tab, s.mat)
        active = ~s.done
        is_refl, is_refr, is_hit = classify(flags, s.mat, active, cfg)
        done = s.done | is_hit

        (dirx, stepx, absx, tmaxx, segx, last_t, cmod, ior, reflected) = (
            material_step(s, is_refl, is_refr, flags, cfg, time_s)
        )

        # ---- DDA step for rays still marching (nextIntersectDDA)
        march = ~done
        ax = _argmin_axis(tmaxx)
        oh2 = _onehot(ax, s.dir.dtype)
        t_cross = _get(tmaxx, ax)
        tmax_n = tmaxx + oh2 * absx
        cell_n = s.cell + (oh2 * stepx).astype(jnp.int32)
        m = march[:, None]
        cell_f = jnp.where(m, cell_n, s.cell)
        new = _March(
            mat=jnp.where(march, lookup(cell_f), s.mat),
            cell=cell_f,
            dir=dirx,
            step=stepx,
            abs_delta=absx,
            tmax=jnp.where(m, tmax_n, tmaxx),
            seg_origin=segx,
            last_t=jnp.where(march, t_cross, last_t),
            last_axis=jnp.where(march, ax, s.last_axis),
            color_mod=cmod,
            ior=ior,
            reflected=reflected,
            done=done,
            steps=s.steps + march.astype(jnp.int32),
        )
        return new, i + 1

    def cond(carry):
        s, i = carry
        return (i < cfg.max_steps) & jnp.any(~s.done)

    state, _ = jax.lax.while_loop(cond, body, (state, jnp.asarray(0, jnp.int32)))
    return state, raw0, mat0, sun


def _shadow_march(scene: Scene, p, cell, last_axis, step, cfg, sun, active, lookup_fn=None):
    """Sun shadow ray (low_res.frag:373-391): rebuild toward the sun, exit
    through the hit face first, march <=75 steps skipping LIQUID blocks."""
    lookup = lookup_fn if lookup_fn is not None else (lambda c: _lookup(scene, c))
    N = p.shape[0]
    d, sstep, sdelta, sabs = _build_ray(jnp.broadcast_to(sun[None, :], p.shape))
    tmax = _init_tmax(p, cell, sstep, sdelta, sabs)
    oh = _onehot(last_axis, p.dtype)
    tmax = tmax - oh * sabs  # step out through the hit face (frag:380)
    liquid_bit = int(Properties.LIQUID)

    def body(carry):
        cell, tmax, mat, alive, i = carry
        ax = _argmin_axis(tmax)
        oh2 = _onehot(ax, p.dtype)
        tmax_n = tmax + oh2 * sabs
        cell_n = cell + (oh2 * sstep).astype(jnp.int32)
        m = alive[:, None]
        cell_f = jnp.where(m, cell_n, cell)
        tmax_f = jnp.where(m, tmax_n, tmax)
        mat_n = jnp.where(alive, lookup(cell_f), mat)
        fl = jnp.take(scene.flags, mat_n)
        alive_n = alive & ((mat_n == 0) | ((fl & liquid_bit) > 0))
        return cell_f, tmax_f, mat_n, alive_n, i + 1

    def cond(carry):
        *_, alive, i = carry
        return (i < cfg.shadow_steps) & jnp.any(alive)

    mat0 = jnp.zeros(N, jnp.int32)
    cell, tmax, mat, alive, _ = jax.lax.while_loop(
        cond, body, (cell, tmax, mat0, active, jnp.asarray(0, jnp.int32))
    )
    return mat != 0  # occluded (any non-air terminator, incl. budget-exhausted
    # liquid, matching frag:389)


def _ao_march(scene: Scene, p, normal, cfg, lookup_fn=None):
    """Hemisphere occlusion: K short rays from the hit point (the reference's
    light_scattering pass, done properly). Returns occlusion fraction [N].
    ``lookup_fn`` overrides the voxel lookup (spatially-sharded paths inject
    their collective slab lookup here, like the primary march's)."""
    lookup = lookup_fn if lookup_fn is not None else (lambda c: _lookup(scene, c))
    N = p.shape[0]
    dirs = oriented_dirs(normal)  # [N, K, 3]
    K = dirs.shape[1]
    dirs_f = dirs.reshape(N * K, 3)
    start = jnp.repeat(p + normal * 1e-3, K, axis=0)
    cell = jnp.floor(start).astype(jnp.int32)
    d, sstep, sdelta, sabs = _build_ray(dirs_f)
    tmax = _init_tmax(start, cell, sstep, sdelta, sabs)

    def body(i, carry):
        cell, tmax, hit = carry
        ax = _argmin_axis(tmax)
        oh = _onehot(ax, p.dtype)
        tmax = tmax + oh * sabs
        cell = cell + (oh * sstep).astype(jnp.int32)
        m = lookup(cell)
        return cell, tmax, hit | (m != 0)

    hit = jnp.zeros(N * K, bool)
    _, _, hit = jax.lax.fori_loop(0, cfg.ao_steps, body, (cell, tmax, hit))
    return hit.reshape(N, K).mean(axis=1, dtype=p.dtype)


def shade(scene: Scene, s: "_March", raw0, mat0, sun, cfg: RenderConfig, shadow_fn,
          ao_lookup_fn=None):
    """Post-march shading + overlays shared by the naive and fast renderers.

    ``shadow_fn(p, cell, last_axis, step, active) -> bool[N]`` runs the sun
    shadow march (each renderer supplies its own marching machinery).
    ``ao_lookup_fn`` overrides the hemisphere march's voxel lookup (sharded
    scenes route it through their collective lookup).
    """
    f32 = jnp.float32
    hit = s.mat != 0
    albedo = jnp.take(scene.albedo, s.mat, axis=0)
    p = s.seg_origin + s.last_t[:, None] * s.dir

    # face shading (calcLightIntensity, low_res.frag:242-252)
    sun_ax = _get(jnp.broadcast_to(sun[None, :], s.dir.shape), s.last_axis)
    step_ax = _get(s.step, s.last_axis)
    lam = sun_ax * -step_ax
    facing = lam > 0
    intensity = jnp.minimum(jnp.maximum(lam, 0.0) + 0.4 + jnp.where(facing, 0.15, 0.0), 1.0)

    shadowed = jnp.zeros_like(facing)
    if cfg.enable_shadows:
        shadow_active = hit & facing & ~s.reflected & ~raw0
        shadowed = shadow_fn(p, s.cell, s.last_axis, s.step, shadow_active)
        shadowed = shadowed & shadow_active

    dark = (~facing) | shadowed
    shade_f = jnp.where(
        s.reflected, intensity, jnp.where(dark, 0.3, intensity)
    )[:, None]
    hit_col = albedo * shade_f * s.color_mod

    if cfg.enable_ao:
        normal = _onehot(s.last_axis, f32) * -s.step
        occ = _ao_march(scene, p, normal, cfg, lookup_fn=ao_lookup_fn)
        hit_col = hit_col * (1.0 - 0.6 * occ)[:, None]

    sky_col = skybox(s.dir, sun) * s.color_mod
    col = jnp.where(hit[:, None], hit_col, sky_col)

    # looked-at highlight (frag:347-350) — checked before the air branch; air's
    # "color" unpacks to ~(1,1,1) in the reference
    look = jnp.asarray(cfg.looking_at, jnp.int32)
    is_look = jnp.all(s.cell == look[None, :], axis=1)
    base = jnp.where(hit[:, None], albedo, jnp.full_like(albedo, (2**21 - 1) / 2**21))
    col = jnp.where(is_look[:, None], base * 2.0 + 0.3, col)

    # camera-inside-solid: flat unshaded color (frag:300-306)
    raw_col = jnp.take(scene.albedo, mat0, axis=0)
    col = jnp.where(raw0[:, None], raw_col, col)

    aux = {
        "hit": hit,
        "mat": s.mat,
        "cell": s.cell,
        "hit_pos": p,
        "steps": s.steps,
        "last_axis": s.last_axis,
        "normal": _onehot(s.last_axis, f32) * -s.step,
        "reflected": s.reflected,
        # mid-march ray-construction internals (the reference's debug frames
        # 2-6: ray dir / ratios / deltas / origin, main.cpp:21-33)
        "ray_dir": s.dir,
        "ray_origin": s.seg_origin,
        "ray_deltas": s.abs_delta,
        "ray_ratios_a": jnp.stack(  # "Y/X, Y/Z, X/Y" (debug frame 3)
            [s.dir[:, 1] / s.dir[:, 0], s.dir[:, 1] / s.dir[:, 2],
             s.dir[:, 0] / s.dir[:, 1]], axis=1),
        "ray_ratios_b": jnp.stack(  # "X/Z, Z/X, Z/Y" (debug frame 4)
            [s.dir[:, 0] / s.dir[:, 2], s.dir[:, 2] / s.dir[:, 0],
             s.dir[:, 2] / s.dir[:, 1]], axis=1),
    }
    return col, aux


def render_rays(scene: Scene, origin, dirs, cfg: RenderConfig, time_s=None):
    """Render arbitrary rays: returns (rgb [N,3], aux dict of debug channels).

    This is the semantically-reference path (single-level DDA); render/fast.py
    provides the brick-hierarchical fast path validated against this one.
    """
    f32 = jnp.float32
    origin = jnp.asarray(origin, f32)
    dirs = jnp.asarray(dirs, f32)
    s, raw0, mat0, sun = _primary_march(scene, origin, dirs, cfg, time_s=time_s)

    def shadow_fn(p, cell, last_axis, step, active):
        return _shadow_march(scene, p, cell, last_axis, step, cfg, sun, active)

    return shade(scene, s, raw0, mat0, sun, cfg, shadow_fn)


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig, time_s=None):
    """Full-frame render: [H, W, 3] float32 in [0, ~1.3]."""
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    col, _ = render_rays(scene, camera.pos, dirs, cfg, time_s=time_s)
    img = col.reshape(cfg.height, cfg.width, 3)
    if cfg.crosshair:
        # dist(fragCoord, mousePos) <= 3 -> white (frag:259-262); mouse_px is in
        # image coordinates (row, col from top-left)
        yy = jnp.arange(cfg.height, dtype=jnp.float32)[:, None]
        xx = jnp.arange(cfg.width, dtype=jnp.float32)[None, :]
        mrow, mcol = cfg.mouse_px
        d2 = (yy - mrow) ** 2 + (xx - mcol) ** 2
        img = jnp.where((d2 <= 9.0)[:, :, None], 1.0, img)
    return img


import functools


@functools.lru_cache(maxsize=64)
def _render_jit_for(cfg: RenderConfig):
    # cached per-config so repeated calls reuse the compiled executable; the
    # animation clock is passed as DATA so time-varying frames do not recompile
    return jax.jit(lambda sc, cam, t: render_image(sc, cam, cfg, time_s=t))


def render_jit(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Jitted full-frame render (cfg minus the clock is the compile key)."""
    from dataclasses import replace as _rep

    key = _rep(cfg, time=0.0)
    return _render_jit_for(key)(scene, camera, jnp.float32(cfg.time))
