"""Fast renderer — the performance path.

Same semantics as render/renderer.py (which is oracle-validated), structured
so that each lockstep loop iteration does one gather and as few full-width
iterations as possible run, because worst-case lanes dominate a lockstep
loop. Three mechanisms:

  1. **Distance-encoded grid** (core/flatten.py Scene.grid_enc): ONE u8 gather
     per iteration returns either the cell's material (solid) or a certified
     Chebyshev all-air radius (air). Air lanes bulk-advance their DDA through
     the whole (2d-1)^3 empty box in closed form — the hierarchical
     generalization of the reference tree's bitmap empty-space skip
     (low_res.frag:520-524) — so typical rays finish in ~30-80 iterations
     instead of the 300-step budget.
  2. **Analytic exits**: rays above the world's max solid y moving up, or
     outside the grid window moving away, terminate immediately; rays outside
     moving toward the window bulk-advance through the exterior slab.
  3. **Ray compaction**: full-width iterations run only while > N/8 lanes are
     active; survivors are gathered into a compact array (recursively N/64,
     ...), drained, and scattered back — the straggler tail (grazing rays that
     legitimately need ~300 steps) stops taxing the full width.

Exactness vs the reference path: bulk advances reproduce sequential stepping's
cell/tmax state (order-independent sums); divergences are FP near-ties at box
corners and budget-frozen mid-air rays (sky either way) — tests bound both
with a small pixel budget.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..core.flatten import Scene
from ..core.types import Properties
from .camera import Camera, ray_directions
from .renderer import (
    _March,
    _argmin_axis,
    _build_ray,
    _get,
    _init_tmax,
    _onehot,
    classify,
    material_step,
    shade,
)

_BIG = 1 << 20  # "infinite" AABB bound (cells)
_MAX_JUMP = 512  # max crossings consumed per bulk advance


def _gather_enc(scene: Scene, cell):
    """The one gather: distance-encoded voxel value at integer cells.

    Wraps &1023 (reference address-digest behavior); outside the window
    returns air with a minimal license (the outside-slab rule supersedes it).
    """
    Sx, Sy, Sz = scene.shape3
    c = cell & 1023
    inside = (c[:, 0] < Sx) & (c[:, 1] < Sy) & (c[:, 2] < Sz)
    lin = (c[:, 0] * Sy + c[:, 1]) * Sz + c[:, 2]
    lin = jnp.where(inside, lin, 0)
    v = jnp.take(scene.grid_enc.reshape(-1), lin).astype(jnp.int32)
    return jnp.where(inside, v, 129)  # air, d >= 1


def lookup_mat_flags(scene: Scene, cell):
    """(mat, flags) at integer cells; air outside the window."""
    v = _gather_enc(scene, cell)
    mat = jnp.where(v < 128, v, 0)
    return mat, jnp.take(scene.flags, mat)


def _aabb_advance_bounds(s: _March, lo, hi, mask, budget):
    """Advance masked lanes' DDA to the exit of the all-air AABB [lo, hi]
    (inclusive cell bounds), exactly as sequential stepping would. A lane with
    lo == hi == cell performs precisely one ordinary DDA step, so this is the
    uniform stepper for air lanes at any distance."""
    f32 = s.dir.dtype
    istep = s.step.astype(jnp.int32)
    n = jnp.where(istep > 0, hi + 1 - s.cell, s.cell - lo + 1)
    n = jnp.clip(n, 1, _MAX_JUMP)
    t_exit = s.tmax + (n - 1).astype(f32) * s.abs_delta
    m = _argmin_axis(t_exit)
    oh = _onehot(m, f32)
    t_m = _get(t_exit, m)
    c = jnp.where(
        t_m[:, None] >= s.tmax,
        jnp.floor((t_m[:, None] - s.tmax) / s.abs_delta).astype(jnp.int32) + 1,
        0,
    )
    c = jnp.minimum(c, n - 1)  # stay inside the box on non-exit axes
    c = jnp.where(oh > 0, n, c)
    c = jnp.maximum(c, 0)

    mask3 = mask[:, None]
    cell = jnp.where(mask3, s.cell + c * istep, s.cell)
    tmax = jnp.where(mask3, s.tmax + c.astype(f32) * s.abs_delta, s.tmax)
    last_axis = jnp.where(mask, m, s.last_axis)
    last_t = jnp.where(mask, t_m, s.last_t)
    steps = s.steps + jnp.where(mask, c.sum(axis=1), 0)
    done = s.done | (mask & (steps >= budget))
    return s._replace(
        cell=cell, tmax=tmax, last_axis=last_axis, last_t=last_t, steps=steps, done=done
    )


def _march_body(scene: Scene, s: _March, enc, cfg: RenderConfig, budget, shadow: bool, time_s, shape3=None):
    """One unified march iteration: process the current cell (materials / hit
    via the reference semantics), then advance air lanes through their
    certified empty box (a plain DDA step when the box is a single cell).

    ``shape3`` overrides the world-window extent for the exit rules — the
    spatially-sharded handoff march (parallel/handoff.py) passes the GLOBAL
    window while ``scene`` holds only the local slab.
    """
    Sx, Sy, Sz = shape3 if shape3 is not None else scene.shape3
    istep = s.step.astype(jnp.int32)
    active = ~s.done

    # ---- current-cell processing (identical to the reference-path body)
    mat = jnp.where(enc < 128, enc, 0)
    fl = jnp.take(scene.flags, mat)
    if shadow:
        liquid = (fl & int(Properties.LIQUID)) > 0
        is_hit = active & (mat != 0) & ~liquid
        is_refl = is_hit & False
        is_refr = is_hit & False
    else:
        is_refl, is_refr, is_hit = classify(fl, mat, active, cfg)
    done = s.done | is_hit
    s = s._replace(mat=jnp.where(active, mat, s.mat), done=done)

    if not shadow:
        def _with_materials(s):
            out = material_step(s, is_refl, is_refr, fl, cfg, time_s)
            (dirx, stepx, absx, tmaxx, segx, last_t, cmod, ior, refl) = out
            return s._replace(
                dir=dirx, step=stepx, abs_delta=absx, tmax=tmaxx,
                seg_origin=segx, last_t=last_t, color_mod=cmod, ior=ior,
                reflected=refl,
            )

        s = jax.lax.cond(
            jnp.any(is_refl | is_refr), _with_materials, lambda s: s, s
        )
        istep = s.step.astype(jnp.int32)

    # ---- exit rules
    shape = jnp.asarray([Sx, Sy, Sz], jnp.int32)[None, :]
    out_pos = s.cell >= shape
    out_neg = s.cell < 0
    inside = ~(out_pos | out_neg).any(axis=1)
    moving_away = ((out_pos & (istep > 0)) | (out_neg & (istep < 0))).any(axis=1)
    sky_up = (s.cell[:, 1] > scene.y_max) & (istep[:, 1] > 0)
    s = s._replace(done=s.done | (~s.done & (moving_away | sky_up)))

    # ---- advance air lanes through their empty box
    march = ~s.done
    r = jnp.maximum(enc - 128 - 1, 0)[:, None]  # license radius (0 => 1 step)
    box_lo = s.cell - r
    box_hi = s.cell + r
    # outside the window: slab up to the window face (overrides the license)
    out_lo = jnp.where(out_pos, shape, -_BIG)
    out_hi = jnp.where(out_neg, -1, _BIG)
    lo = jnp.where(inside[:, None], box_lo, out_lo)
    hi = jnp.where(inside[:, None], box_hi, out_hi)
    s = _aabb_advance_bounds(s, lo, hi, march, budget)
    return s


def fast_march(
    scene: Scene,
    state: _March,
    cfg: RenderConfig,
    budget,
    shadow: bool = False,
    compact_fraction: int = 8,
    time_s=None,
):
    """The full march with straggler compaction. Returns (state, iterations)."""
    N = state.cell.shape[0]
    M = _compact_size_static(N, compact_fraction)

    def cond_many(carry):
        s, i = carry
        return (i < 2048) & (jnp.sum(~s.done) > M)

    def cond_all(carry):
        s, i = carry
        return (i < 2048) & jnp.any(~s.done)

    def body(carry):
        s, i = carry
        enc = _gather_enc(scene, s.cell)
        s = _march_body(scene, s, enc, cfg, budget, shadow, time_s)
        return s, i + 1

    if M >= N:
        state, i = jax.lax.while_loop(cond_all, body, (state, jnp.asarray(0, jnp.int32)))
        return state, i

    state, i = jax.lax.while_loop(cond_many, body, (state, jnp.asarray(0, jnp.int32)))

    # compact the stragglers and recurse (N/8, N/64, ...)
    active = ~state.done
    count = jnp.sum(active)
    (idx,) = jnp.nonzero(active, size=M, fill_value=0)
    valid = jnp.arange(M) < count
    sub = jax.tree_util.tree_map(lambda a: a[idx], state)
    sub = sub._replace(done=sub.done | ~valid)
    sub, i2 = fast_march(scene, sub, cfg, budget, shadow, compact_fraction, time_s)
    scatter_idx = jnp.where(valid, idx, N)  # out-of-bounds rows are dropped
    state = jax.tree_util.tree_map(
        lambda full, part: full.at[scatter_idx].set(part, mode="drop"),
        state,
        sub,
    )
    return state, i + i2


def _compact_size_static(n: int, frac: int) -> int:
    m = max(n // frac, 256)
    return ((m + 127) // 128) * 128


def _init_state(origin, dirs, ior, start_t=None, shape3=None):
    N = dirs.shape[0]
    f32 = dirs.dtype
    d, step, delta, abs_delta = _build_ray(dirs)
    if origin.ndim == 1:
        origin = jnp.broadcast_to(origin[None, :], (N, 3))
    origin = origin.astype(f32)
    if start_t is not None:
        # fast-forward along the ray (progressive refinement seeding — the
        # mid/full_res "sourceRay" trick, mid_res.frag:219), but never past
        # the ray's exit from the grid window ``shape3``: a start cell beyond
        # it can wrap (&1023) back into the window and alias solid terrain,
        # while nothing past the exit is renderable
        t1 = (0.0 - origin) * delta
        t2 = (jnp.asarray(shape3, f32)[None, :] - origin) * delta
        t_exit = jnp.min(jnp.maximum(t1, t2), axis=1)
        t_start = jnp.minimum(jnp.maximum(start_t, 0.0), jnp.maximum(t_exit, 0.0) + 1e-3)
        origin = origin + t_start[:, None] * d
    cell = jnp.floor(origin).astype(jnp.int32)
    tmax = _init_tmax(origin, cell, step, delta, abs_delta)
    return _March(
        mat=jnp.zeros(N, jnp.int32),
        cell=cell,
        dir=d,
        step=step,
        abs_delta=abs_delta,
        tmax=tmax,
        seg_origin=origin,
        last_t=jnp.zeros(N, f32),
        last_axis=jnp.zeros(N, jnp.int32),
        color_mod=jnp.ones((N, 3), f32),
        ior=ior,
        reflected=jnp.zeros(N, bool),
        done=jnp.zeros(N, bool),
        steps=jnp.zeros(N, jnp.int32),
    )


def _shadow_march_fast(scene: Scene, p, cell, last_axis, step, cfg, sun, active):
    """Sun shadow via the fast machinery (semantics of renderer._shadow_march)."""
    N = p.shape[0]
    d, sstep, sdelta, sabs = _build_ray(jnp.broadcast_to(sun[None, :], p.shape))
    tmax = _init_tmax(p, cell, sstep, sdelta, sabs)
    oh = _onehot(last_axis, p.dtype)
    tmax = tmax - oh * sabs  # step out through the hit face (frag:380)
    s = _March(
        mat=jnp.zeros(N, jnp.int32),
        cell=cell,
        dir=d,
        step=sstep,
        abs_delta=sabs,
        tmax=tmax,
        seg_origin=p,
        last_t=jnp.zeros(N, p.dtype),
        last_axis=last_axis,
        color_mod=jnp.ones((N, 3), p.dtype),
        ior=jnp.ones(N, p.dtype),
        reflected=jnp.zeros(N, bool),
        done=~active,
        steps=jnp.zeros(N, jnp.int32),
    )
    # the shadow loop starts by stepping (frag:383-387): the hit block itself
    # is not re-tested, so take one plain DDA step before the main march
    ax = _argmin_axis(s.tmax)
    oh2 = _onehot(ax, p.dtype)
    t_cross = _get(s.tmax, ax)
    m3 = active[:, None]
    s = s._replace(
        cell=jnp.where(m3, s.cell + (oh2 * s.step).astype(jnp.int32), s.cell),
        tmax=jnp.where(m3, s.tmax + oh2 * s.abs_delta, s.tmax),
        last_axis=jnp.where(active, ax, s.last_axis),
        last_t=jnp.where(active, t_cross, s.last_t),
        steps=s.steps + active.astype(jnp.int32),
    )
    s, _ = fast_march(
        scene, s, cfg, jnp.asarray(cfg.shadow_steps, jnp.int32), shadow=True
    )
    return active & (s.mat != 0)


def render_rays_fast(scene: Scene, origin, dirs, cfg: RenderConfig, start_t=None, time_s=None):
    """Fast-path render of arbitrary rays -> (rgb [N,3], aux).

    ``start_t`` (f32[N], optional) fast-forwards each ray by a known-safe
    parameter distance before marching (progressive-refinement seeding);
    ``time_s`` is the traced animation clock.
    """
    f32 = jnp.float32
    origin = jnp.asarray(origin, f32)
    dirs = jnp.asarray(dirs, f32)
    N = dirs.shape[0]
    if time_s is None:
        time_s = cfg.time

    sun = jnp.asarray(cfg.sun_dir, f32)
    sun = sun / jnp.linalg.norm(sun)

    # starting-cell specials (frag:299-307), evaluated at the (possibly
    # fast-forwarded) start point
    s = _init_state(origin, dirs, jnp.ones(N, f32), start_t=start_t,
                    shape3=scene.shape3)
    mat0, flags0 = lookup_mat_flags(scene, s.cell)
    refr0 = (flags0 & int(Properties.REFRACTIVE)) > 0
    raw0 = (mat0 != 0) & ~refr0
    ior = jnp.where((mat0 != 0) & refr0, 1.1, 1.0).astype(f32)
    s = s._replace(ior=ior, done=raw0, mat=jnp.where(raw0, mat0, 0))

    s, iters = fast_march(
        scene, s, cfg, jnp.asarray(cfg.max_steps, jnp.int32), shadow=False,
        time_s=time_s,
    )

    def shadow_fn(p, cell, last_axis, step, active):
        return _shadow_march_fast(scene, p, cell, last_axis, step, cfg, sun, active)

    col, aux = shade(scene, s, raw0, mat0, sun, cfg, shadow_fn)
    aux["march_iters"] = iters
    return col, aux


def render_image_fast(scene: Scene, camera: Camera, cfg: RenderConfig, time_s=None):
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    col, _ = render_rays_fast(scene, camera.pos, dirs, cfg, time_s=time_s)
    img = col.reshape(cfg.height, cfg.width, 3)
    if cfg.crosshair:
        yy = jnp.arange(cfg.height, dtype=jnp.float32)[:, None]
        xx = jnp.arange(cfg.width, dtype=jnp.float32)[None, :]
        mrow, mcol = cfg.mouse_px
        d2 = (yy - mrow) ** 2 + (xx - mcol) ** 2
        img = jnp.where((d2 <= 9.0)[:, :, None], 1.0, img)
    return img


@functools.lru_cache(maxsize=64)
def _render_fast_jit_for(cfg: RenderConfig):
    return jax.jit(lambda sc, cam, t: render_image_fast(sc, cam, cfg, time_s=t))


def render_fast_jit(scene: Scene, camera: Camera, cfg: RenderConfig):
    from dataclasses import replace as _rep

    key = _rep(cfg, time=0.0)
    return _render_fast_jit_for(key)(scene, camera, jnp.float32(cfg.time))
