"""Differentiable volumetric voxel renderer.

New capability vs the reference (whose GLSL kernel is opaque to gradients): the
same DDA march expressed as emission-absorption volume rendering over continuous
per-voxel density and albedo fields, so images differentiate w.r.t.

  - voxel densities  (occupancy -> soft opacity, sigma >= 0)
  - voxel albedos    (rgb per voxel)
  - camera pose      (through ray origins/directions and crossing parameters)

Along each ray the DDA enumerates voxel crossings t_0=0 < t_1 < ... ; segment i
of length dt_i = t_{i+1} - t_i lies inside one voxel with density sigma_i and
albedo c_i. Standard transmittance accumulation:

    alpha_i = 1 - exp(-sigma_i * dt_i)
    C = sum_i T_i * alpha_i * c_i + T_end * sky(dir),   T_i = prod_{j<i} (1-alpha_j)

In the limit sigma -> inf on solid voxels this reproduces the hard renderer's
first-hit albedo (tested), tying the differentiable path to the reference
semantics.

Implementation notes:
  - fixed-trip-count ``lax.scan`` (reverse-mode differentiable; while_loop is
    not), with ``jax.checkpoint`` over the scan body so the backward pass
    re-marches instead of storing all per-step state — the custom-VJP
    "re-march" strategy from SURVEY.md §7, expressed via remat.
  - the march reuses the hard renderer's ray building/tie-breaking so the
    visited voxel sequence is identical to the oracle's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from .camera import Camera, ray_directions
from .renderer import _argmin_axis, _build_ray, _init_tmax, _onehot, _get, skybox

# Guided seeds at/above this value are the "no surface" sentinel (the guided
# path seeds misses with 1e6): window renders treat such rays as pure sky —
# matching the hard renderers — instead of compositing the &1023-wrapped
# cells a t=1e6 window lands on.
MISS_SEED_MIN = 9.9e5


class DiffScene(NamedTuple):
    """Continuous voxel fields over the grid window (origin-anchored)."""

    density: jnp.ndarray  # f32 [Sx, Sy, Sz] >= 0
    albedo: jnp.ndarray  # f32 [Sx, Sy, Sz, 3]


def diff_scene_from_grid(grid, albedo_table, solid_density: float = 1e4) -> DiffScene:
    """Hard material grid -> continuous fields (solid voxels get a large
    density so the volumetric render matches the hard first-hit limit)."""
    import numpy as np

    g = np.asarray(grid)
    density = np.where(g > 0, solid_density, 0.0).astype(np.float32)
    albedo = np.asarray(albedo_table)[g]
    return DiffScene(jnp.asarray(density), jnp.asarray(albedo))


def _gather_fields(scene: DiffScene, cell):
    """Density and albedo at integer cells; air outside the window/wrap."""
    Sx, Sy, Sz = scene.density.shape
    c = cell & 1023
    inside = (c[:, 0] < Sx) & (c[:, 1] < Sy) & (c[:, 2] < Sz)
    lin = (c[:, 0] * Sy + c[:, 1]) * Sz + c[:, 2]
    lin = jnp.where(inside, lin, 0)
    sigma = jnp.take(scene.density.reshape(-1), lin)
    alb = jnp.take(scene.albedo.reshape(-1, 3), lin, axis=0)
    z = inside.astype(sigma.dtype)
    return sigma * z, alb * z[:, None]


def _pack_fields(scene: DiffScene):
    """[V, 4] rows of (sigma, r, g, b): one packed 16-byte row gather per scan
    step instead of a separate sigma (lane) and albedo (row) gather, and its
    transpose is ONE scatter-add per step in the backward instead of two."""
    return jnp.concatenate(
        [scene.density.reshape(-1, 1), scene.albedo.reshape(-1, 3)], axis=1
    )


def _gather_packed(packed, shape3, cell):
    from ..ops.scatter import take_rows

    Sx, Sy, Sz = shape3
    c = cell & 1023
    inside = (c[:, 0] < Sx) & (c[:, 1] < Sy) & (c[:, 2] < Sz)
    lin = (c[:, 0] * Sy + c[:, 1]) * Sz + c[:, 2]
    lin = jnp.where(inside, lin, 0)
    row = take_rows(packed, lin)  # VJP = dedup scatter (ops/scatter.py)
    z = inside.astype(row.dtype)[:, None]
    row = row * z
    return row[:, 0], row[:, 1:]


def render_rays_diff(
    scene: DiffScene,
    origin,
    dirs,
    num_steps: int = 192,
    sun_dir=(2.0, 1.0, 4.0),
    sky: bool = True,
    start_t=None,
    remat=None,
):
    """Volumetric render of arbitrary rays -> rgb f32[N, 3]. Differentiable
    w.r.t. scene fields, ``origin`` and ``dirs``.

    ``start_t`` (f32[N], no gradient) fast-forwards rays before the scan —
    surface-guided sampling: seed with hard-render hit depths minus a margin
    and a short ``num_steps`` window captures all non-zero-density segments.
    Gradients for provably-empty skipped cells are culled (they are the
    occupancy-grid culling standard in voxel radiance fields).
    """
    f32 = jnp.float32
    dirs = jnp.asarray(dirs, f32)
    origin = jnp.asarray(origin, f32)
    N = dirs.shape[0]
    d, step, delta, abs_delta = _build_ray(dirs)
    if origin.ndim == 1:  # shared origin or per-ray origins both supported
        origin = jnp.broadcast_to(origin[None, :], (N, 3))
    origin_b = origin.astype(f32)
    # analytic fast-forward to the grid bounding box (slab method): everything
    # outside contributes zero density, so skipping it changes nothing — and
    # its zero integrand keeps autodiff gradients exact. Saves most of the
    # fixed step budget for cameras outside the world (e.g. fit ring views).
    Sx, Sy, Sz = scene.density.shape
    hi = jnp.asarray([Sx, Sy, Sz], f32)
    t1 = (0.0 - origin_b) * delta
    t2 = (hi[None, :] - origin_b) * delta
    t_entry = jnp.max(jnp.minimum(t1, t2), axis=1)
    t0 = jnp.maximum(t_entry - 1e-3, 0.0)
    if start_t is not None:
        t0 = jnp.maximum(t0, jax.lax.stop_gradient(jnp.asarray(start_t, f32)))
    origin_b = origin_b + t0[:, None] * d
    cell = jnp.floor(origin_b).astype(jnp.int32)
    tmax = _init_tmax(origin_b, cell, step, delta, abs_delta)
    istep = step.astype(jnp.int32)

    packed = _pack_fields(scene)
    shape3 = (Sx, Sy, Sz)

    def body(carry, _):
        cell, tmax, t_cur, trans, rgb = carry
        ax = _argmin_axis(tmax)
        oh = _onehot(ax, f32)
        t_next = _get(tmax, ax)
        dt = jnp.maximum(t_next - t_cur, 0.0)
        sigma, alb = _gather_packed(packed, shape3, cell)
        alpha = 1.0 - jnp.exp(-sigma * dt)
        rgb = rgb + (trans * alpha)[:, None] * alb
        trans = trans * (1.0 - alpha)
        cell = cell + (oh.astype(jnp.int32)) * istep
        tmax = tmax + oh * abs_delta
        return (cell, tmax, t_next, trans, rgb), None

    init = (
        cell,
        tmax,
        jnp.zeros(N, f32),
        jnp.ones(N, f32),
        jnp.zeros((N, 3), f32),
    )
    # rematerialization is a memory/time trade: per-step remat re-gathers in
    # the backward. Short guided windows save residuals instead
    # (~32 B/ray/step); long blind marches remat.
    if remat is None:
        remat = num_steps > 48
    body_s = jax.checkpoint(body, prevent_cse=False) if remat else body
    (cell, tmax, t_cur, trans, rgb), _ = jax.lax.scan(
        body_s, init, None, length=num_steps
    )

    if sky:
        sun = jnp.asarray(sun_dir, f32)
        sun = sun / jnp.linalg.norm(sun)
        rgb = rgb + trans[:, None] * skybox(d, sun)
    return rgb


def _enumerate_window(shape3, origin_b, d, step, abs_delta, cell, tmax, num_steps):
    """Enumerate the next `num_steps` DDA crossings WITHOUT any memory access:
    returns (lin i32[N,S], inside bool[N,S], dt f32[N,S], ax_in i32[N,S]) —
    the visited cell, its window membership, the in-cell segment length, and
    the axis the ray ENTERED the cell through (the face normal axis in the
    hard limit). Differentiable w.r.t. the ray geometry (dt carries the
    tmax/abs_delta gradients); the cell indices are integral (no gradient),
    as in any DDA."""
    f32 = d.dtype
    Sx, Sy, Sz = shape3
    istep = step.astype(jnp.int32)
    # entry axis of the FIRST cell: the most recent crossing before the seed
    ax0 = _argmin_axis(tmax - abs_delta)

    def body(carry, _):
        cell, tmax, t_cur, ax_in = carry
        ax = _argmin_axis(tmax)
        oh = _onehot(ax, f32)
        t_next = _get(tmax, ax)
        dt = jnp.maximum(t_next - t_cur, 0.0)
        wc = cell & 1023
        inside = (wc[:, 0] < Sx) & (wc[:, 1] < Sy) & (wc[:, 2] < Sz)
        lin = jnp.where(inside, (wc[:, 0] * Sy + wc[:, 1]) * Sz + wc[:, 2], 0)
        carry = (
            cell + (oh.astype(jnp.int32)) * istep, tmax + oh * abs_delta, t_next, ax
        )
        return carry, (lin, inside, dt, ax_in)

    _, (lin, inside, dt, ax_in) = jax.lax.scan(
        body, (cell, tmax, jnp.zeros(cell.shape[0], f32), ax0), None,
        length=num_steps,
    )
    return lin.T, inside.T, dt.T, ax_in.T  # -> [N, S]


def _enumerate_window_vec(shape3, origin_b, d, step, abs_delta, cell, tmax, num_steps):
    """Scan-free twin of _enumerate_window: the DDA's crossing sequence is the
    merge of three arithmetic progressions t0_ax + n*abs_ax, so every step's
    (cell, dt, entry axis) has a CLOSED FORM — rank-select the merged order in
    parallel over [N, S] instead of carrying a 24-step sequential scan.

    Order replication: ranks use exact comparisons of the closed-form values
    (division candidates corrected by direct compare) with the reference
    tie-priority z > y > x (renderer._argmin_axis). The closed-form value
    t0 + n*a differs from the scan's accumulated t by ulps, so isolated
    near-tie rays may enumerate a different (still valid) crossing order —
    fwd/bwd stay self-consistent because both use the same enumeration.
    """
    f32 = d.dtype
    i32 = jnp.int32
    N = cell.shape[0]
    S = num_steps
    Sx, Sy, Sz = shape3
    istep = step.astype(i32)
    ax0 = _argmin_axis(tmax - abs_delta)

    ns = jnp.arange(S, dtype=f32)[None, None, :]  # [1, 1, S]
    t0 = tmax.T[:, :, None]  # [3, N, 1]
    a = abs_delta.T[:, :, None]
    vals = t0 + ns * a  # [3, N, S] closed-form crossing values

    def count_before(tA, A, B):
        """#{m >= 0 : t0_B + m*a_B  strictly-before  key (tA, axis A)}.
        tA: [N, S]."""
        t0b = tmax[:, B][:, None]
        ab = abs_delta[:, B][:, None]
        q = jnp.floor((tA - t0b) / ab).astype(i32)
        q = jnp.clip(q, -1, S + 1)
        # correct the division rounding by direct comparison (exact)
        qf = q.astype(f32)
        q = jnp.where(t0b + qf * ab >= tA, q - 1, q)
        qf = q.astype(f32)
        q = jnp.where(t0b + qf * ab >= tA, q - 1, q)
        qf = q.astype(f32)
        q = jnp.where(t0b + (qf + 1.0) * ab < tA, q + 1, q)
        cnt = jnp.clip(q + 1, 0, S)
        if B > A:  # equal keys: higher axis steps first (ref tie-break)
            tie = t0b + (cnt.astype(f32)) * ab == tA
            cnt = jnp.where(tie & (cnt < S), cnt + 1, cnt)
        return cnt

    ranks = []
    for A in range(3):
        r = jnp.arange(S, dtype=i32)[None, :] + jnp.zeros((N, 1), i32)
        for B in range(3):
            if B != A:
                r = r + count_before(vals[A], A, B)
        ranks.append(r)  # [N, S]

    ss = jnp.arange(S, dtype=i32)[None, None, :]  # [1, 1, S_out]
    nA = [
        (ranks[A][:, :, None] < ss).sum(axis=1).astype(i32)  # [N, S_out]
        for A in range(3)
    ]
    # cell after s crossings
    cellx = cell[:, 0][:, None] + nA[0] * istep[:, 0][:, None]
    celly = cell[:, 1][:, None] + nA[1] * istep[:, 1][:, None]
    cellz = cell[:, 2][:, None] + nA[2] * istep[:, 2][:, None]
    wx, wy, wz = cellx & 1023, celly & 1023, cellz & 1023
    inside = (wx < Sx) & (wy < Sy) & (wz < Sz)
    lin = jnp.where(inside, (wx * Sy + wy) * Sz + wz, 0)

    # value & axis of the s-th crossing (s >= 1): the latest taken per axis
    NEG = jnp.float32(-3e38)

    def last_t(A):
        n = nA[A]
        return jnp.where(
            n > 0, tmax[:, A][:, None] + (n - 1).astype(f32) * abs_delta[:, A][:, None],
            NEG,
        )

    lx, ly, lz = last_t(0), last_t(1), last_t(2)
    t_s = jnp.maximum(lx, jnp.maximum(ly, lz))  # [N, S_out], s=0 -> NEG
    # tie priority z > y > x: pick the highest axis achieving the max
    ax_s = jnp.where(lz == t_s, 2, jnp.where(ly == t_s, 1, 0)).astype(i32)
    ax_in = jnp.where(ss[0] == 0, ax0[:, None], ax_s)

    # t(s+1): value of the next crossing = min of each axis's next value
    nxt = jnp.minimum(
        jnp.minimum(
            tmax[:, 0][:, None] + nA[0].astype(f32) * abs_delta[:, 0][:, None],
            tmax[:, 1][:, None] + nA[1].astype(f32) * abs_delta[:, 1][:, None],
        ),
        tmax[:, 2][:, None] + nA[2].astype(f32) * abs_delta[:, 2][:, None],
    )
    t_prev = jnp.where(ss[0] == 0, 0.0, t_s)
    dt = jnp.maximum(nxt - t_prev, 0.0)
    return lin, inside, dt, ax_in


def render_rays_diff_window(
    scene: DiffScene,
    origin,
    dirs,
    num_steps: int = 24,
    sun_dir=(2.0, 1.0, 4.0),
    sky: bool = True,
    start_t=None,
    accum: str = "dedup",
    shading: bool = False,
    shadow_steps: int = 0,
    enumerate_mode: str = "scan",
):
    """Window-formulated volumetric render: mathematically identical to
    render_rays_diff (exp-of-cumsum transmittance == product of per-segment
    exponentials), but restructured for the backward pass:

      1. the DDA crossings are enumerated WITHOUT memory access (cheap scan),
      2. ALL window cells are fetched in ONE differentiable row gather,
      3. compositing is pure vector math over [N, S] arrays.

    The whole backward therefore performs ONE batched accumulation (the
    gather's VJP) instead of one scatter per scan step. ``accum`` picks the
    VJP engine: 'dedup' (ops/scatter sort-based) or 'scatter' (plain XLA
    scatter-add, the correctness anchor); ``enumerate_mode`` picks the
    crossing enumeration: 'scan' or 'vec' (closed form).

    ``shading=True`` multiplies each segment's albedo by the reference's
    face-shading intensity (calcLightIntensity, low_res.frag:242-252) computed
    from the segment's ENTRY axis — in the hard-density limit this equals the
    hard renderer's shaded color at the hit face, so fits can target shaded
    images. ``shadow_steps > 0`` adds a differentiable soft sun-shadow term:
    the accumulated surface color is scaled by 0.3 + 0.7*T_sun, where T_sun is
    the volumetric transmittance toward the sun from the expected hit point
    (the soft analog of low_res.frag:373-391's hard 0.3 factor)."""
    f32 = jnp.float32
    dirs = jnp.asarray(dirs, f32)
    origin = jnp.asarray(origin, f32)
    N = dirs.shape[0]
    d, step, delta, abs_delta = _build_ray(dirs)
    if origin.ndim == 1:
        origin = jnp.broadcast_to(origin[None, :], (N, 3))
    origin_b = origin.astype(f32)
    Sx, Sy, Sz = scene.density.shape
    hi = jnp.asarray([Sx, Sy, Sz], f32)
    t1 = (0.0 - origin_b) * delta
    t2 = (hi[None, :] - origin_b) * delta
    t_entry = jnp.max(jnp.minimum(t1, t2), axis=1)
    t0 = jnp.maximum(t_entry - 1e-3, 0.0)
    dead = None
    if start_t is not None:
        st = jax.lax.stop_gradient(jnp.asarray(start_t, f32))
        t0 = jnp.maximum(t0, st)
        # miss-sentinel seeds (the guided convention, >= ~1e6) mean "no
        # surface": render pure sky like the hard renderers instead of
        # compositing the &1023-wrapped cells a t=1e6 window lands on
        # (MISS_SEED_MIN)
        dead = st >= MISS_SEED_MIN
    origin_b = origin_b + t0[:, None] * d
    cell = jnp.floor(origin_b).astype(jnp.int32)
    if dead is not None:
        # park dead rays at cell 1023: wraps to 1023 (outside any window
        # with S* <= ~1000), and <= S window steps cannot re-enter
        cell = jnp.where(dead[:, None], 1023, cell)
    tmax = _init_tmax(origin_b, cell, step, delta, abs_delta)

    enum_fn = _enumerate_window_vec if enumerate_mode == "vec" else _enumerate_window
    lin, inside, dt, ax_in = enum_fn(
        (Sx, Sy, Sz), origin_b, d, step, abs_delta, cell, tmax, num_steps
    )

    packed = _pack_fields(scene)
    if accum == "dedup":
        from ..ops.scatter import take_rows

        rows = take_rows(packed, lin.reshape(-1))
    else:
        rows = jnp.take(packed, lin.reshape(-1), axis=0)
    rows = rows.reshape(N, num_steps, 4)
    z = inside.astype(f32)
    sigma = rows[:, :, 0] * z
    alb = rows[:, :, 1:] * z[:, :, None]

    sun = jnp.asarray(sun_dir, f32)
    sun = sun / jnp.linalg.norm(sun)
    if shading:
        # face shading from the entry axis (calcLightIntensity): the segment's
        # entry face normal is -step on ax_in; lam = sun . normal
        sun_ax = jnp.take(sun, ax_in)  # [N, S]
        step_ax = jnp.take_along_axis(
            jnp.broadcast_to(step[:, None, :], (N, num_steps, 3)), ax_in[:, :, None], axis=2
        )[:, :, 0]
        lam = sun_ax * -step_ax
        facing = lam > 0
        # facing: min(lam + 0.4 + 0.15, 1); back-facing: flat 0.3
        # (calcLightIntensity + the back-face rule, low_res.frag:242-252,368)
        intensity = jnp.where(
            facing, jnp.minimum(lam + 0.55, 1.0), 0.3
        )
        alb = alb * intensity[:, :, None]

    od = sigma * dt  # per-segment optical depth
    tau = jnp.concatenate(
        [jnp.zeros((N, 1), f32), jnp.cumsum(od[:, :-1], axis=1)], axis=1
    )
    T = jnp.exp(-tau)
    w = T * (1.0 - jnp.exp(-od))
    surf = (w[:, :, None] * alb).sum(axis=1)

    if shadow_steps > 0:
        # expected hit point along the ray (weight-averaged segment midpoints;
        # for a hard surface this IS the hit point), pushed off the surface
        t_mid = jnp.cumsum(dt, axis=1) - 0.5 * dt
        w_sum = w.sum(axis=1)
        t_hit = (w * t_mid).sum(axis=1) / jnp.maximum(w_sum, 1e-8)
        p = origin_b + jax.lax.stop_gradient(t_hit)[:, None] * d
        t_sun = transmittance(
            scene, jax.lax.stop_gradient(p) + sun[None, :] * 0.75,
            jnp.broadcast_to(sun[None, :], (N, 3)), num_steps=shadow_steps,
        )
        # hard analog: occluded -> color * 0.3 (low_res.frag:389)
        surf = surf * (0.3 + 0.7 * t_sun)[:, None]

    rgb = surf
    if sky:
        T_end = jnp.exp(-(tau[:, -1] + od[:, -1]))
        rgb = rgb + T_end[:, None] * skybox(d, sun)
    return rgb


def guided_seed(
    hard_scene,
    origin,
    dirs,
    margin: float = 3.0,
    image_hw=None,
    coarse_factor: int = 4,
    engine: str = "fast",
):
    """Window start parameters for surface-guided rendering (no gradient): a
    hard-path forward march finds first-solid depths along the STRAIGHT rays
    (materials disabled); each ray's window starts ``margin`` cells before its
    surface, and rays that hit nothing get the miss sentinel 1e6.

    ``image_hw=(H, W)``: when the rays form a camera image, the hard march is
    itself seeded by a 1/coarse_factor-resolution depth pass (the reference's
    progressive-refinement scheme, render/progressive.py); the fine march
    remains exact from the conservative coarse seed."""
    from ..config import RenderConfig
    from . import fast, progressive

    if engine == "fast":
        hard_render = fast.render_rays_fast
    elif engine == "bricks":
        from . import bricks as _bx

        hard_render = _bx.render_rays_bricks
    else:
        raise ValueError(f"unknown engine {engine!r}")

    N = jnp.asarray(dirs).shape[0]
    cfg = RenderConfig(
        width=1, height=N, enable_materials=False, enable_shadows=False
    )
    start_t = None
    if image_hw is not None:
        H, W = image_hw
        assert H % coarse_factor == 0 and W % coarse_factor == 0, (
            f"image_hw {image_hw} must be divisible by coarse_factor {coarse_factor}"
        )
        ccfg = RenderConfig(
            width=W // coarse_factor, height=H // coarse_factor,
            enable_materials=False, enable_shadows=False,
        )
        cdirs = jnp.asarray(dirs).reshape(H, W, 3)[
            coarse_factor // 2 :: coarse_factor, coarse_factor // 2 :: coarse_factor
        ].reshape(-1, 3)
        _, caux = hard_render(hard_scene, origin, cdirs, ccfg)
        o1 = jnp.asarray(origin, jnp.float32)
        ct = jnp.linalg.norm(caux["hit_pos"] - o1[None, :], axis=1)
        ct = jnp.where(caux["hit"], ct, 1e6)
        depth = ct.reshape(H // coarse_factor, W // coarse_factor)
        start_t = progressive.seed_from_depth(depth, coarse_factor, H, W)
    _, aux = hard_render(hard_scene, origin, dirs, cfg, start_t=start_t)
    o = jnp.asarray(origin, jnp.float32)
    if o.ndim == 1:
        o = o[None, :]
    t_hit = jnp.linalg.norm(aux["hit_pos"] - o, axis=1)
    seed = jnp.where(aux["hit"], jnp.maximum(t_hit - margin, 0.0), 1e6)
    return jax.lax.stop_gradient(seed)


def render_rays_diff_guided(
    scene: DiffScene,
    hard_scene,
    origin,
    dirs,
    num_steps: int = 24,
    margin: float = 3.0,
    sun_dir=(2.0, 1.0, 4.0),
    sky: bool = True,
    image_hw=None,
    coarse_factor: int = 4,
    window: bool = True,
    accum: str = "dedup",
    engine: str = "fast",
    shading: bool = False,
    shadow_steps: int = 0,
):
    """Surface-guided differentiable render: the volumetric scan runs only a
    short window starting ``margin`` cells before each ray's first surface
    (``guided_seed``). ~10x fewer scan steps than blind marching at equal
    fidelity; empty-space gradients are culled (standard occupancy-grid
    practice)."""
    seed = guided_seed(
        hard_scene, origin, dirs, margin=margin, image_hw=image_hw,
        coarse_factor=coarse_factor, engine=engine,
    )
    if window:
        return render_rays_diff_window(
            scene, origin, dirs, num_steps=num_steps, sun_dir=sun_dir, sky=sky,
            start_t=seed, accum=accum, shading=shading, shadow_steps=shadow_steps,
        )
    assert not shading and not shadow_steps, "shading requires the window path"
    return render_rays_diff(
        scene, origin, dirs, num_steps=num_steps, sun_dir=sun_dir, sky=sky,
        start_t=seed,
    )


def transmittance(scene: DiffScene, origins, dirs, num_steps: int = 8):
    """Volumetric transmittance along short rays — the differentiable
    occlusion primitive (no color accumulation). origins/dirs: f32[N,3]."""
    f32 = jnp.float32
    dirs = jnp.asarray(dirs, f32)
    origins = jnp.asarray(origins, f32)
    d, step, delta, abs_delta = _build_ray(dirs)
    cell = jnp.floor(origins).astype(jnp.int32)
    tmax = _init_tmax(origins, cell, step, delta, abs_delta)
    istep = step.astype(jnp.int32)

    def body(carry, _):
        cell, tmax, t_cur, trans = carry
        ax = _argmin_axis(tmax)
        oh = _onehot(ax, f32)
        t_next = _get(tmax, ax)
        dt = jnp.maximum(t_next - t_cur, 0.0)
        sigma, _ = _gather_fields(scene, cell)
        trans = trans * jnp.exp(-sigma * dt)
        return (cell + oh.astype(jnp.int32) * istep, tmax + oh * abs_delta, t_next, trans), None

    N = dirs.shape[0]
    init = (cell, tmax, jnp.zeros(N, f32), jnp.ones(N, f32))
    (c, t, tc, trans), _ = jax.lax.scan(jax.checkpoint(body, prevent_cse=False), init, None, length=num_steps)
    return trans


def ao_diff(
    scene: DiffScene, points, normals, key, n_rays: int = 20, num_steps: int = 5
):
    """Differentiable hemisphere ambient occlusion.

    The volumetric re-expression of the reference's light_scattering pass (20
    rays x 5 steps per shaded point, light_scattering.frag:226-231) with
    stochastic cosine-weighted directions instead of the fixed table, and soft
    transmittance instead of binary hits — so occlusion differentiates w.r.t.
    the density field. Returns occlusion in [0, 1], shape [N].
    """
    from .hemisphere import sample_hemisphere

    N = points.shape[0]
    dirs = sample_hemisphere(key, normals, n_rays).reshape(N * n_rays, 3)
    starts = jnp.repeat(points + normals * 1e-2, n_rays, axis=0)
    trans = transmittance(scene, starts, dirs, num_steps=num_steps)
    return 1.0 - trans.reshape(N, n_rays).mean(axis=1)


def render_image_diff(
    scene: DiffScene, camera: Camera, cfg: RenderConfig, num_steps: int = 192
):
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    rgb = render_rays_diff(
        scene, camera.pos, dirs, num_steps=num_steps, sun_dir=cfg.sun_dir
    )
    return rgb.reshape(cfg.height, cfg.width, 3)
