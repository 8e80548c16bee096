"""Brick-hierarchical march — an alternative XLA forward engine.

The fast path (render/fast.py) does ONE u8 gather per march iteration. This
path removes the per-step gather entirely by marching at 4^3-BRICK
granularity:

  - **brick phase**: the per-iteration lookup is the brick-level Chebyshev
    distance (Scene.brick_dist), fetched via a one-hot matmul
    (ops/mxu_lookup.mxu_nibble_lookup2) from a small table.
    Air lanes bulk-advance through certified-empty brick boxes with the same
    exact AABB arithmetic as render/fast.py.
  - **fine phase**: on entering an occupied brick, the brick's voxel row
    (brick_mat, 64 bytes) is row-gathered ONCE, and the per-voxel DDA steps
    inside the brick resolve materials from the in-register row via a one-hot
    VPU select — no further memory traffic until the ray leaves the brick.

Rounds alternate fine -> brick until all rays terminate, with straggler
compaction between rounds (same scheme as fast.fast_march). Reflection /
refraction / shadow semantics are IDENTICAL to render/fast.py (shared
classify / material_step / shade helpers); parity is asserted in
tests/test_bricks.py over the material-coverage cases.

Its speed on the GPU against render/fast.py is not measured. Reference
anchor: the march/descent of
src/shaders/low_res.frag:309-315,493-532, with the tree descent re-expressed
as distance-field jumps at brick granularity.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..core.flatten import Scene
from ..core.types import Properties
from ..ops.mxu_lookup import mxu_nibble_lookup2
from .camera import Camera, ray_directions
from .fast import _BIG, _MAX_JUMP, _aabb_advance_bounds, _compact_size_static, _init_state
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

_FINE_CAP = 64  # safety bound on fine-phase iterations per round
_BRICK_CAP = 512  # safety bound on brick-phase iterations per round
_ROUND_CAP = 512  # safety bound on rounds (budget freeze terminates earlier)


def _wrap_window(scene: Scene, cell):
    """Reference address-digest coords + in-window mask (fast._gather_enc)."""
    Sx, Sy, Sz = scene.shape3
    wc = cell & 1023
    in_w = (wc[:, 0] < Sx) & (wc[:, 1] < Sy) & (wc[:, 2] < Sz)
    return wc, in_w


def brick_lin(scene: Scene, wc):
    s = scene.brick_shift
    Bx, By, Bz = scene.brick_grid
    bc = wc >> s
    return (bc[:, 0] * By + bc[:, 1]) * Bz + bc[:, 2]


def brick_dist_at(scene: Scene, table, cell):
    """(dist, in_window): brick-level Chebyshev distance at the voxel cell.
    dist == 0 -> the brick contains solids; d >= 1 licenses a (d-1)-brick
    all-air box. Outside the window reports air (slab rules supersede)."""
    wc, in_w = _wrap_window(scene, cell)
    lin = jnp.where(in_w, brick_lin(scene, wc), 0)
    d = mxu_nibble_lookup2(table, lin)
    return jnp.where(in_w, d, 1), in_w


def fetch_rows(scene: Scene, cell, want):
    """Row-gather the brick voxel rows for masked lanes -> (rows u8[N,bs^3],
    blin i32[N]). Unwanted lanes fetch row 0 (harmlessly)."""
    wc, in_w = _wrap_window(scene, cell)
    lin = jnp.where(want & in_w, brick_lin(scene, wc), 0)
    return jnp.take(scene.brick_mat, lin, axis=0), lin


def row_mat(scene: Scene, rows, cell):
    """Material id at `cell` from the in-register brick row (one-hot VPU
    select — no gather)."""
    s = scene.brick_shift
    bs = 1 << s
    m = bs - 1
    wc = cell & 1023
    vox = ((wc[:, 0] & m) * bs + (wc[:, 1] & m)) * bs + (wc[:, 2] & m)
    oh = vox[:, None] == jnp.arange(bs**3, dtype=jnp.int32)[None, :]
    return jnp.where(oh, rows.astype(jnp.int32), 0).sum(axis=1, dtype=jnp.int32)


def _exit_rules(scene: Scene, s: _March, istep):
    """Window/sky analytic exits (fast._march_body's rules)."""
    Sx, Sy, Sz = scene.shape3
    shape = jnp.asarray([Sx, Sy, Sz], jnp.int32)[None, :]
    out_pos = s.cell >= shape
    out_neg = s.cell < 0
    inside = ~(out_pos | out_neg).any(axis=1)
    moving_away = ((out_pos & (istep > 0)) | (out_neg & (istep < 0))).any(axis=1)
    sky_up = (s.cell[:, 1] > scene.y_max) & (istep[:, 1] > 0)
    return out_pos, out_neg, inside, moving_away, sky_up


def _fine_loop(scene: Scene, s: _March, rows, blin, cfg, budget, shadow, time_s):
    """Per-voxel DDA inside the fetched brick. Processes the CURRENT cell
    exactly like fast._march_body (hit / reflect / refract), then single-steps;
    a lane leaves the loop when done, out of its fetched brick, or frozen."""

    def in_fetched(cell, blin):
        wc = cell & 1023
        Sx, Sy, Sz = scene.shape3
        in_w = (wc[:, 0] < Sx) & (wc[:, 1] < Sy) & (wc[:, 2] < Sz)
        return in_w & (brick_lin(scene, wc) == blin)

    def fine_active(s):
        return ~s.done & in_fetched(s.cell, blin)

    def body(carry):
        s, i = carry
        active = fine_active(s)

        # ---- current-cell processing (fast._march_body semantics)
        mat = jnp.where(active, row_mat(scene, rows, s.cell), 0)
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

        if not shadow and cfg.enable_materials:
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

        # ---- one DDA step for lanes still marching in this brick
        march = active & ~s.done
        ax = _argmin_axis(s.tmax)
        oh = _onehot(ax, s.dir.dtype)
        t_cross = _get(s.tmax, ax)
        m3 = march[:, None]
        steps = s.steps + march.astype(jnp.int32)
        s = s._replace(
            cell=jnp.where(m3, s.cell + (oh * s.step).astype(jnp.int32), s.cell),
            tmax=jnp.where(m3, s.tmax + oh * s.abs_delta, s.tmax),
            last_axis=jnp.where(march, ax, s.last_axis),
            last_t=jnp.where(march, t_cross, s.last_t),
            steps=steps,
            done=s.done | (march & (steps >= budget)),
        )
        return s, i + 1

    def cond(carry):
        s, i = carry
        return (i < _FINE_CAP) & jnp.any(fine_active(s))

    s, _ = jax.lax.while_loop(cond, body, (s, jnp.zeros((), jnp.int32)))
    return s


def _brick_loop(scene: Scene, table, s: _March, budget):
    """Bulk-advance lanes through certified-empty brick boxes until every
    active lane sits in an occupied brick (or terminates). Exact cell/tmax
    parity with sequential stepping (the boxes are voxel-aligned AABBs)."""
    sh = scene.brick_shift

    def body(carry):
        s, i = carry
        d, in_w = brick_dist_at(scene, table, s.cell)
        istep = s.step.astype(jnp.int32)
        out_pos, out_neg, inside, moving_away, sky_up = _exit_rules(scene, s, istep)
        # "process current cell": an active lane in empty-brick space sits in a
        # provably-air (or outside-window) cell, so its mat is 0 — exactly what
        # fast._march_body's per-iteration mat write would produce. Lanes
        # waiting at occupied bricks keep mat for the next fine round.
        air_here = ~s.done & ~(in_w & (d == 0))
        s = s._replace(
            mat=jnp.where(air_here, 0, s.mat),
            done=s.done | (~s.done & (moving_away | sky_up)),
        )
        march = ~s.done & ~(in_w & (d == 0))

        # empty-box bounds: license radius in BRICKS inside the window,
        # window slab outside (fast._march_body's lo/hi, brick-aligned)
        Sx, Sy, Sz = scene.shape3
        shape = jnp.asarray([Sx, Sy, Sz], jnp.int32)[None, :]
        r = jnp.maximum(d - 1, 0)[:, None]
        bc = (s.cell & 1023) >> sh
        box_lo = (bc - r) << sh
        box_hi = (((bc + r + 1) << sh) - 1)
        out_lo = jnp.where(out_pos, shape, -_BIG)
        out_hi = jnp.where(out_neg, -1, _BIG)
        lo = jnp.where(inside[:, None], box_lo, out_lo)
        hi = jnp.where(inside[:, None], box_hi, out_hi)
        s = _aabb_advance_bounds(s, lo, hi, march, budget)
        return s, i + 1

    def cond(carry):
        s, i = carry
        d, in_w = brick_dist_at(scene, table, s.cell)
        istep = s.step.astype(jnp.int32)
        _, _, _, moving_away, sky_up = _exit_rules(scene, s, istep)
        pending = ~s.done & ~(in_w & (d == 0)) & ~moving_away & ~sky_up
        return (i < _BRICK_CAP) & jnp.any(pending)

    s, _ = jax.lax.while_loop(cond, body, (s, jnp.zeros((), jnp.int32)))
    # final exit-rule sweep so lanes parked outside/above are marked done;
    # their current cell is outside the window or above y_max, i.e. air
    istep = s.step.astype(jnp.int32)
    _, _, _, moving_away, sky_up = _exit_rules(scene, s, istep)
    newly = ~s.done & (moving_away | sky_up)
    return s._replace(mat=jnp.where(newly, 0, s.mat), done=s.done | newly)


def brick_march(
    scene: Scene,
    state: _March,
    cfg: RenderConfig,
    budget,
    shadow: bool = False,
    compact_fraction: int = 8,
    time_s=None,
):
    """The full rounds-structured march with straggler compaction.
    Returns (state, rounds)."""
    if time_s is None:
        time_s = cfg.time
    table = scene.brick_nib_shadow if shadow else scene.brick_nib
    N = state.cell.shape[0]
    M = _compact_size_static(N, compact_fraction)

    def round_body(carry):
        s, r = carry
        d, in_w = brick_dist_at(scene, table, s.cell)
        want = ~s.done & in_w & (d == 0)
        rows, blin = fetch_rows(scene, s.cell, want)
        blin = jnp.where(want, blin, -1)  # lanes not at an occupied brick fetch nothing
        s = _fine_loop(scene, s, rows, blin, cfg, budget, shadow, time_s)
        s = _brick_loop(scene, table, s, budget)
        return s, r + 1

    def cond_many(carry):
        s, r = carry
        return (r < _ROUND_CAP) & (jnp.sum(~s.done) > M)

    def cond_all(carry):
        s, r = carry
        return (r < _ROUND_CAP) & jnp.any(~s.done)

    if M >= N:
        state, r = jax.lax.while_loop(cond_all, round_body, (state, jnp.zeros((), jnp.int32)))
        return state, r

    state, r = jax.lax.while_loop(cond_many, round_body, (state, jnp.zeros((), jnp.int32)))

    # compact the stragglers and recurse (N/8, N/64, ...)
    active = ~state.done
    count = jnp.sum(active)
    (idx,) = jnp.nonzero(active, size=M, fill_value=0)
    valid = jnp.arange(M) < count
    sub = jax.tree_util.tree_map(lambda a: a[idx], state)
    sub = sub._replace(done=sub.done | ~valid)
    sub, r2 = brick_march(scene, sub, cfg, budget, shadow, compact_fraction, time_s)
    scatter_idx = jnp.where(valid, idx, N)
    state = jax.tree_util.tree_map(
        lambda full, part: full.at[scatter_idx].set(part, mode="drop"),
        state,
        sub,
    )
    return state, r + r2


def _shadow_march_bricks(scene, p, cell, last_axis, cfg, sun, active):
    """Sun-shadow occlusion via the brick machinery (fast._shadow_march_fast
    semantics: exit through the hit face, one geometric first step, skip
    LIQUID, <=75 steps)."""
    N = p.shape[0]
    d, sstep, sdelta, sabs = _build_ray(jnp.broadcast_to(sun[None, :], p.shape))
    tmax = _init_tmax(p, cell, sstep, sdelta, sabs)
    oh = _onehot(last_axis, p.dtype)
    tmax = tmax - oh * sabs  # step out through the hit face (frag:380)
    s = _March(
        mat=jnp.zeros(N, jnp.int32),
        cell=cell, dir=d, step=sstep, abs_delta=sabs, tmax=tmax,
        seg_origin=p,
        last_t=jnp.zeros(N, p.dtype),
        last_axis=last_axis,
        color_mod=jnp.ones((N, 3), p.dtype),
        ior=jnp.ones(N, p.dtype),
        reflected=jnp.zeros(N, bool),
        done=~active,
        steps=jnp.zeros(N, jnp.int32),
    )
    # first step is geometric — the hit block itself is not re-tested (frag:383)
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
    s, _ = brick_march(
        scene, s, cfg, jnp.asarray(cfg.shadow_steps, jnp.int32), shadow=True
    )
    return active & (s.mat != 0)


def render_rays_bricks(
    scene: Scene,
    origin,
    dirs,
    cfg: RenderConfig,
    start_t=None,
    time_s=None,
):
    """Brick-path render of arbitrary rays -> (rgb [N,3], aux). Same semantics
    and signature shape as fast.render_rays_fast."""
    f32 = jnp.float32
    origin = jnp.asarray(origin, f32)
    dirs = jnp.asarray(dirs, f32)
    N = dirs.shape[0]
    if time_s is None:
        time_s = cfg.time

    sun = jnp.asarray(cfg.sun_dir, f32)
    sun = sun / jnp.linalg.norm(sun)

    # starting-cell specials (frag:299-307), identical to the fast path
    from .fast import lookup_mat_flags

    s = _init_state(origin, dirs, jnp.ones(N, f32), start_t=start_t,
                    shape3=scene.shape3)
    mat0, flags0 = lookup_mat_flags(scene, s.cell)
    refr0 = (flags0 & int(Properties.REFRACTIVE)) > 0
    raw0 = (mat0 != 0) & ~refr0
    ior = jnp.where((mat0 != 0) & refr0, 1.1, 1.0).astype(f32)
    s = s._replace(ior=ior, done=raw0, mat=jnp.where(raw0, mat0, 0))

    s, rounds = brick_march(
        scene, s, cfg, jnp.asarray(cfg.max_steps, jnp.int32), shadow=False,
        time_s=time_s,
    )

    def shadow_fn(p, cell, last_axis, step, active):
        return _shadow_march_bricks(scene, p, cell, last_axis, cfg, sun, active)

    col, aux = shade(scene, s, raw0, mat0, sun, cfg, shadow_fn)
    aux["march_rounds"] = rounds
    return col, aux


def render_image_bricks(scene: Scene, camera: Camera, cfg: RenderConfig, time_s=None):
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    col, _ = render_rays_bricks(scene, camera.pos, dirs, cfg, time_s=time_s)
    img = col.reshape(cfg.height, cfg.width, 3)
    if cfg.crosshair:
        yy = jnp.arange(cfg.height, dtype=jnp.float32)[:, None]
        xx = jnp.arange(cfg.width, dtype=jnp.float32)[None, :]
        mrow, mcol = cfg.mouse_px
        d2 = (yy - mrow) ** 2 + (xx - mcol) ** 2
        img = jnp.where((d2 <= 9.0)[:, :, None], 1.0, img)
    return img


@functools.lru_cache(maxsize=64)
def _render_bricks_jit_for(cfg: RenderConfig):
    return jax.jit(lambda sc, cam, t: render_image_bricks(sc, cam, cfg, time_s=t))


def render_bricks_jit(scene: Scene, camera: Camera, cfg: RenderConfig):
    from dataclasses import replace as _rep

    key = _rep(cfg, time=0.0)
    return _render_bricks_jit_for(key)(scene, camera, jnp.float32(cfg.time))
