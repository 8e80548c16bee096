"""Smoke run of the system's main path on one GPU, through the normal entry
points, at the reference deployment's full size.

    python chip_smoke.py            # one GPU: world, frame, edit, window, fit
    python chip_smoke.py --multi    # four GPUs: spatial + handoff frames and
                                    # the data-parallel train step only

Every phase prints its wall times (median of a few warm runs, each ending in
``block_until_ready``, labelled with the card's name and power limit), its
compile time as set-up, ``compiled.memory_analysis()`` and the device's peak
memory, and its parity checks with their tolerances. Any failed phase or
check exits non-zero before the last line; the last line is one JSON object
``{"ok": true, "device": {...}}``. The script refuses to run without a GPU.
All phases run in this one process (one JAX process per card).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_test_tpu.config import FitConfig, RenderConfig, WorldConfig
from raytracing_test_tpu.core import flatten
from raytracing_test_tpu.utils import profiling

# The bench camera (bench.py): 9% of its 1024^2 pixels see animated water.
BENCH_POS = (100.0, 60.0, 40.0)
BENCH_DIR = (0.55, -0.4, 0.55)

# ---- tolerances (each with its reason)
# Fast engine vs the anchor (renderer.py): pixel-exact up to f32 noise except
# silhouette pixels where a 1-ulp ray difference flips the discrete
# traversal; the bound tests/test_render_parity.py uses for FP near-ties.
FRAME_ATOL, FRAME_BAD_FRAC = 1e-5, 0.01
# Coarse-to-fine seeding is an approximation that may skip features thinner
# than a coarse pixel (render/progressive.py); tests/test_progressive.py bound.
PROG_ATOL, PROG_BAD_FRAC = 1e-3, 0.01
# Window forward: 'scan' and 'vec' enumerate the same crossings, but the
# closed-form crossing values differ from the scan's running sums by ulps, so
# near-tie rays may take another valid order (tests/test_diff_vec.py: <=0.2%
# of rays); exp-of-cumsum compositing is f32-accurate to ~1e-4 per channel.
WIN_RGB_ATOL, WIN_RGB_BAD_FRAC = 2e-4, 0.002
# Window gradients, max |g - g_ref| / max |g_ref| per field: GPU scatter-add
# sums with atomics in a run-dependent order, 'dedup' sums per-cell runs as
# differences of one f32 prefix sum over the whole batch (ops/scatter.py), and
# 'vec' near-tie rays touch a few different cells.
WIN_GRAD_REL = 1e-3
# Guided window vs the blind scan anchor (render_rays_diff) on a ray subset:
# the same segments composited as exp-of-cumsum vs a running product
# (tests/test_diff.py guided-vs-blind bound), except rays the 24-crossing
# window truncates (a grazing ray clips a surface corner and flies on to a
# farther surface): their share is bounded. Gradients are compared over the
# rays whose colors agree to BLIND_SAT_ATOL (a truncated tail enters every
# density gradient along its ray as the light behind each cell), on solid
# cells (the guided path culls empty-space gradients by design). A surface
# cell's density gradient is the difference of its own light and the light
# behind it, which cancels, so the two formulations' f32 rounding of the
# transmittance (exp of a cumsum vs a running product) shows at ~1e-3 of the
# largest gradient. The blind scan runs in chunks of BLIND_CHUNK rays:
# its per-step gradient gather (ops/scatter.take_rows) takes the plain
# scatter-add branch at <= 256 rows, so the anchor is free of the dedup
# prefix-sum error.
BLIND_RGB_ATOL, BLIND_BAD_FRAC, BLIND_CHUNK = 2e-4, 0.01, 256
BLIND_SAT_ATOL, BLIND_GRAD_REL = 1e-6, 5e-3
# Fit: the train step's first loss and the same loss computed directly sum
# 3*batch squared errors in different orders.
FIT_LOSS_RTOL = 1e-5
# Data-parallel step vs one card: the loss is a mean of per-shard means and
# field gradients are psum'ed across cards (allclose, not bit-exact). One Adam
# step moves each parameter by ~lr*sign(g), so a cell whose gradient is ~0
# may move either way; bound the share of such cells instead of all cells.
DP_LOSS_RTOL, DP_PARAM_ATOL, DP_PARAM_BAD_FRAC = 1e-5, 1e-5, 1e-4


@dataclass(frozen=True)
class Sizes:
    """One run's shapes. FULL is the reference deployment; tests use smaller."""

    world: WorldConfig = WorldConfig()
    res: int = 1024
    cam_pos: Tuple[float, float, float] = BENCH_POS
    cam_dir: Tuple[float, float, float] = BENCH_DIR
    window_steps: int = 24
    blind_stride: int = 256  # every k-th ray of the image for the blind anchor
    blind_steps: int = 640  # >= Sx + Sy + Sz: the blind march crosses the window
    fit: FitConfig = FitConfig(guided=True, steps=3)
    fit_batch: int = 65536
    edit_column: Tuple[int, int] = (100, 100)
    reps: int = 5
    time_s: float = 1.3


FULL = Sizes()


class Report:
    """Prints one line per measurement or check and remembers failed checks."""

    def __init__(self, label: str):
        self.label = label
        self.failed: List[str] = []

    def line(self, text: str) -> None:
        print(text, flush=True)

    def timing(self, name: str, times: List[float]) -> None:
        self.line(
            f"time {name}: median {profiling.median_ms(times):.3f} ms (min "
            f"{1e3 * min(times):.3f}, max {1e3 * max(times):.3f}, "
            f"{len(times)} runs) [{self.label}]")

    def compiled(self, name: str, seconds: float, mem: Dict[str, int]) -> None:
        mib = {k: round(v / 2**20, 1) for k, v in mem.items()}
        self.line(f"setup {name}: compile {seconds:.2f} s; memory_analysis MiB {mib}")

    def check(self, name: str, ok: bool, detail: str) -> None:
        self.line(f"check {name}: {'ok' if ok else 'FAIL'} {detail}")
        if not ok:
            self.failed.append(name)

    def peak(self, phase: str) -> None:
        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        self.line(f"memory {phase}: peak_bytes_in_use "
                  + (f"{peak / 2**30:.3f} GiB" if peak is not None else "not reported"))


def compile_timed(fn, *args):
    """(compiled, seconds, memory summary) of ``jax.jit(fn)`` at ``args``."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0, profiling.memory_summary(compiled)


def bad_fraction(img, ref, atol) -> Tuple[float, float]:
    """(share of pixels/rays whose max-channel |diff| > atol, max |diff|)."""
    d = np.abs(np.asarray(img, np.float64) - np.asarray(ref, np.float64))
    d = d.max(axis=-1)
    return float((d > atol).mean()), float(d.max())


def rel_err(got, ref, mask=None) -> Tuple[float, float, float]:
    """(max |got - ref| / max |ref|, max |got - ref|, ||got - ref|| / ||ref||),
    over ``mask`` if given."""
    g, r = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if mask is not None:
        g, r = g[mask], r[mask]
    err = float(np.abs(g - r).max()) if g.size else 0.0
    scale = float(np.abs(r).max()) if r.size else 0.0
    l2 = float(np.linalg.norm(g - r)) / max(float(np.linalg.norm(r)), 1e-30)
    return err / max(scale, 1e-30), err, l2


def bench_yaw_pitch(d) -> Tuple[float, float]:
    """Session yaw/pitch whose camera direction is ``d`` (render/camera.py:
    dir = Ry(yaw) Rx(pitch) (0,0,1); positive pitch looks down)."""
    x, y, z = (float(v) for v in d)
    n = math.sqrt(x * x + y * y + z * z)
    return math.degrees(math.atan2(x, z)), math.degrees(math.asin(-y / n))


# ------------------------------------------------------------------ phases


def phase_world(rep: Report, sz: Sizes):
    """The session over the reference world, built by the native runtime."""
    from raytracing_test_tpu.app.session import WorldSession
    from raytracing_test_tpu.native import runtime

    t0 = time.perf_counter()
    s = WorldSession(sz.world)
    dt = time.perf_counter() - t0
    native = s._native is not None
    rep.line(f"world: {sz.world.width}x{sz.world.length} columns in grid "
             f"{s.grid.shape}, native runtime used: {native}, build "
             f"{dt:.3f} s (set-up, host)")
    if not native:
        rep.line(f"native build error: {runtime.build_error()}")
    rep.check("world.native", native, "(the native C++ runtime built the world)")
    s.pos = np.asarray(sz.cam_pos, np.float64)
    s.yaw, s.pitch = bench_yaw_pitch(sz.cam_dir)
    s.time = sz.time_s
    return s


def phase_frame(rep: Report, s, sz: Sizes) -> Dict[str, object]:
    """Full-feature frame (materials, water, shadows, traced clock) through
    ``WorldSession.render``; fast engine vs the anchor, fast+progressive, and
    the guided seed march."""
    from raytracing_test_tpu.render import diff, fast, progressive, renderer
    from raytracing_test_tpu.render.camera import ray_directions

    rcfg = RenderConfig(width=sz.res, height=sz.res)
    cam = s.camera()
    t = jnp.float32(s.time)
    px = f"{sz.res}x{sz.res}"

    frame = s.render(rcfg, highlight=False)  # the entry point (compiles)
    times = []
    for _ in range(sz.reps):
        t0 = time.perf_counter()
        s.render(rcfg, highlight=False)
        times.append(time.perf_counter() - t0)
    rep.timing(f"frame.session_render {px} (host wall incl. readback)", times)

    fast_fn = lambda sc, c, tt: fast.render_image_fast(sc, c, rcfg, time_s=tt)
    comp, cs, mem = compile_timed(fast_fn, s.scene, cam, t)
    rep.compiled(f"frame.fast {px}", cs, mem)
    rep.timing(f"frame.fast {px} full-feature",
               profiling.time_call(comp, s.scene, cam, t, reps=sz.reps))
    img = np.asarray(comp(s.scene, cam, t))
    rep.check("frame.entry_point", bool(np.array_equal(img, frame)),
              "(session.render frame == compiled fast frame, bitwise)")
    still = np.asarray(comp(s.scene, cam, jnp.float32(0.0)))
    anim, _ = bad_fraction(img, still, 0.0)
    rep.check("frame.animated_water", anim > 0.0,
              f"(share of pixels that change between time 0 and {s.time}: {anim:.4f})")
    rep.check("frame.finite", bool(np.isfinite(img).all()),
              f"(shape {img.shape})")

    with jax.default_matmul_precision("highest"):
        anchor_fn = lambda sc, c, tt: renderer.render_image(sc, c, rcfg, time_s=tt)
        acomp, acs, amem = compile_timed(anchor_fn, s.scene, cam, t)
        rep.compiled(f"frame.anchor {px}", acs, amem)
        rep.timing(f"frame.anchor {px} full-feature (renderer.py)",
                   profiling.time_call(acomp, s.scene, cam, t, reps=sz.reps))
        ref = np.asarray(acomp(s.scene, cam, t))
    frac, dmax = bad_fraction(img, ref, FRAME_ATOL)
    rep.check("frame.fast_vs_anchor", frac <= FRAME_BAD_FRAC,
              f"bad-pixel fraction {frac:.6f} (atol {FRAME_ATOL}, bound "
              f"{FRAME_BAD_FRAC}), max |d| {dmax:.3e}")

    pcfg = replace(rcfg, time=s.time)  # progressive reads the clock statically
    prog_fn = lambda sc, c: progressive.render_image_progressive(sc, c, pcfg)[0]
    pcomp, pcs, pmem = compile_timed(prog_fn, s.scene, cam)
    rep.compiled(f"frame.fast+progressive {px}", pcs, pmem)
    rep.timing(f"frame.fast+progressive {px} full-feature",
               profiling.time_call(pcomp, s.scene, cam, reps=sz.reps))
    frac, dmax = bad_fraction(np.asarray(pcomp(s.scene, cam)), img, PROG_ATOL)
    rep.check("frame.progressive_vs_fast", frac <= PROG_BAD_FRAC,
              f"bad-pixel fraction {frac:.6f} (atol {PROG_ATOL}, bound "
              f"{PROG_BAD_FRAC}), max |d| {dmax:.3e}")

    dirs = ray_directions(cam, sz.res, sz.res)
    seed_fn = lambda sc, o, d: diff.guided_seed(sc, o, d, image_hw=(sz.res, sz.res))
    scomp, scs, smem = compile_timed(seed_fn, s.scene, cam.pos, dirs)
    rep.compiled(f"seed.fast+progressive {px}", scs, smem)
    rep.timing(f"seed.fast+progressive {px} (materials/shadows off)",
               profiling.time_call(scomp, s.scene, cam.pos, dirs, reps=sz.reps))
    seed = scomp(s.scene, cam.pos, dirs)
    plain_fn = lambda sc, o, d: diff.guided_seed(sc, o, d)
    ucomp, ucs, umem = compile_timed(plain_fn, s.scene, cam.pos, dirs)
    rep.compiled(f"seed.fast {px}", ucs, umem)
    rep.timing(f"seed.fast {px} (materials/shadows off, no coarse pass)",
               profiling.time_call(ucomp, s.scene, cam.pos, dirs, reps=sz.reps))
    frac, dmax = bad_fraction(np.asarray(seed)[:, None],
                              np.asarray(ucomp(s.scene, cam.pos, dirs))[:, None], 1e-3)
    rep.check("seed.progressive_vs_plain", frac <= PROG_BAD_FRAC,
              f"share of seeds off by > 1e-3: {frac:.6f} (bound {PROG_BAD_FRAC})")
    rep.peak("frame")
    return {"frame": img, "seed": seed, "dirs": dirs, "fast": comp}


def _top_solid(grid, x: int, z: int) -> int:
    ys = np.nonzero(grid[x, :, z])[0]
    return int(ys.max()) if ys.size else 0


def phase_edit(rep: Report, s, sz: Sizes, fast_frame) -> None:
    """Place then delete a block (the reference's RMB/LMB) and render after
    each; the incrementally mirrored scene (core/mirror.py) must equal a scene
    flattened from scratch, field for field and frame for frame."""
    rcfg = RenderConfig(width=sz.res, height=sz.res)
    x, z = sz.edit_column
    saved = (s.pos.copy(), s.yaw, s.pitch)
    s.pos = np.asarray([x + 0.5, _top_solid(s.grid, x, z) + 6.0, z + 0.5])
    s.yaw, s.pitch = 45.0, 60.0
    cam = s.camera()
    t = jnp.float32(s.time)
    before = np.asarray(fast_frame(s.scene, cam, t))

    def against_rebuild(tag: str) -> None:
        rebuilt = flatten.scene_from_grid(s.grid, s.palette)
        same = all(
            (a is None and b is None)
            or np.array_equal(np.asarray(a), np.asarray(b))
            for a, b in zip(s.scene, rebuilt))
        rep.check(f"edit.{tag}.scene_vs_rebuild", same,
                  "(incremental mirror == full flatten, every field, bitwise)")
        img = np.asarray(fast_frame(s.scene, cam, t))
        ref = np.asarray(fast_frame(rebuilt, cam, t))
        rep.check(f"edit.{tag}.frame_vs_rebuild", bool(np.array_equal(img, ref)),
                  "(frame from the mirrored scene == frame from the rebuilt scene)")

    pick = s.pick()
    rep.check("edit.pick", pick.steps > 0, f"(pick hit {pick.pos})")
    was_air = int(s.grid[tuple(pick.last_pos)]) == 0  # water is see-through to picks
    t0 = time.perf_counter()
    placed = s.place(slot=0)
    n = s.sync()
    t_sync = time.perf_counter() - t0
    img = s.render(rcfg, highlight=False)
    t_all = time.perf_counter() - t0
    rep.line(f"time edit.place+sync: {1e3 * t_sync:.3f} ms host ({n} dirty "
             f"bricks); place+sync+frame {1e3 * t_all:.3f} ms [{rep.label}]")
    changed, _ = bad_fraction(img, before, 0.0)
    rep.check("edit.place_visible", changed > 0.0,
              f"(placed at {placed}; share of pixels changed {changed:.6f})")
    against_rebuild("place")

    t0 = time.perf_counter()
    deleted = s.delete()
    n = s.sync()
    t_sync = time.perf_counter() - t0
    img = s.render(rcfg, highlight=False)
    t_all = time.perf_counter() - t0
    rep.line(f"time edit.delete+sync: {1e3 * t_sync:.3f} ms host ({n} dirty "
             f"bricks); delete+sync+frame {1e3 * t_all:.3f} ms [{rep.label}]")
    restored = bool(np.array_equal(img, before)) if was_air else int(s.grid[placed]) == 0
    rep.check("edit.delete_restores", deleted == placed and restored,
              f"(deleted {deleted}; " + ("frame equals the pre-edit frame bitwise)"
                                         if was_air else "the placed cell is air again)"))
    against_rebuild("delete")
    s.pos, s.yaw, s.pitch = saved
    rep.peak("edit")


def _window_fb(accum: str, emode: str, num_steps: int):
    """fn(dscene, origin, dirs, seed, w) -> (rgb, field grads of
    mean(w * rgb)); ``w`` weighs each ray's share of the loss."""
    from raytracing_test_tpu.render import diff

    def fn(ds, origin, dirs, seed, w):
        def loss(ds):
            rgb = diff.render_rays_diff_window(
                ds, origin, dirs, num_steps=num_steps, sky=False, start_t=seed,
                accum=accum, enumerate_mode=emode)
            return jnp.mean(w[:, None] * rgb), rgb

        (_, rgb), g = jax.value_and_grad(loss, has_aux=True)(ds)
        return rgb, g

    return fn


def phase_window(rep: Report, s, sz: Sizes, seed, dirs) -> None:
    """Guided-window forward+backward at full size for every accumulator x
    enumeration, cross-checked and against the blind scan on a ray subset."""
    from raytracing_test_tpu.render import diff

    albedo, _, _ = flatten.palette_arrays(s.palette)
    ds = diff.diff_scene_from_grid(s.grid, albedo, solid_density=50.0)
    cam = s.camera()
    px = f"{sz.res}x{sz.res}x{sz.window_steps}"
    ones = jnp.ones(dirs.shape[0], jnp.float32)
    out = {}
    for accum, emode in (("scatter", "scan"), ("scatter", "vec"),
                         ("dedup", "scan"), ("dedup", "vec")):
        name = f"window.fwd+bwd[{accum}/{emode}] {px}"
        fn = _window_fb(accum, emode, sz.window_steps)
        args = (ds, cam.pos, dirs, seed, ones)
        if (accum, emode) == ("scatter", "scan"):  # the reference variant
            with jax.default_matmul_precision("highest"):
                comp, cs, mem = compile_timed(fn, *args)
        else:
            comp, cs, mem = compile_timed(fn, *args)
        rep.compiled(name, cs, mem)
        rep.timing(name, profiling.time_call(comp, *args, reps=sz.reps))
        out[(accum, emode)] = jax.device_get(comp(*args))
        del comp
    rgb_ref, g_ref = out[("scatter", "scan")]
    rep.check("window.rgb_finite", bool(np.isfinite(rgb_ref).all()),
              f"(shape {rgb_ref.shape}; mean {float(rgb_ref.mean()):.6f})")
    for key, (rgb, g) in out.items():
        if key == ("scatter", "scan"):
            continue
        tag = "/".join(key)
        frac, dmax = bad_fraction(rgb, rgb_ref, WIN_RGB_ATOL)
        rep.check(f"window.rgb[{tag}]_vs_scatter/scan", frac <= WIN_RGB_BAD_FRAC,
                  f"rays off by > {WIN_RGB_ATOL}: {frac:.6f} (bound "
                  f"{WIN_RGB_BAD_FRAC}), max-abs {dmax:.3e}")
        for f in ("density", "albedo"):
            rel, err, _ = rel_err(getattr(g, f), getattr(g_ref, f))
            rep.check(f"window.grad.{f}[{tag}]_vs_scatter/scan", rel <= WIN_GRAD_REL,
                      f"relative {rel:.3e} (bound {WIN_GRAD_REL}), max-abs {err:.3e}")

    # the blind scan anchor on a ray subset, in chunks of BLIND_CHUNK rays
    k = sz.blind_stride
    d_sub, s_sub = dirs[::k], seed[::k]
    n = d_sub.shape[0]
    assert n % BLIND_CHUNK == 0, (n, BLIND_CHUNK)
    w1 = jnp.ones(n, jnp.float32)

    def blind(ds, origin, d, w):
        def loss(ds):
            rgb = diff.render_rays_diff(ds, origin, d, num_steps=sz.blind_steps, sky=False)
            return jnp.sum(w[:, None] * rgb) / (3 * n), rgb

        (_, rgb), g = jax.value_and_grad(loss, has_aux=True)(ds)
        return rgb, g

    with jax.default_matmul_precision("highest"):
        wcomp = jax.jit(_window_fb("scatter", "scan", sz.window_steps)).lower(
            ds, cam.pos, d_sub, s_sub, w1).compile()
        bcomp, bcs, bmem = compile_timed(
            blind, ds, cam.pos, d_sub[:BLIND_CHUNK], w1[:BLIND_CHUNK])
        rep.compiled(f"window.blind_anchor {BLIND_CHUNK} rays x {sz.blind_steps}", bcs, bmem)

        def blind_all(w):
            rgbs, g = [], None
            for i in range(0, n, BLIND_CHUNK):
                r, gi = bcomp(ds, cam.pos, d_sub[i:i + BLIND_CHUNK], w[i:i + BLIND_CHUNK])
                rgbs.append(np.asarray(r))
                g = gi if g is None else jax.tree_util.tree_map(jnp.add, g, gi)
            return np.concatenate(rgbs), g

        rgb_w, _ = wcomp(ds, cam.pos, d_sub, s_sub, w1)
        rgb_b, _ = blind_all(w1)
        d_rgb = np.abs(np.asarray(rgb_w, np.float64) - np.asarray(rgb_b, np.float64)).max(-1)
        agree = d_rgb <= BLIND_RGB_ATOL
        sat = d_rgb <= BLIND_SAT_ATOL
        w_agree = jnp.asarray(sat, jnp.float32)
        _, g_w = wcomp(ds, cam.pos, d_sub, s_sub, w_agree)
        _, g_b = blind_all(w_agree)
    frac = float(1.0 - agree.mean())
    rep.check("window.rgb_vs_blind", frac <= BLIND_BAD_FRAC,
              f"{n} rays: off by > {BLIND_RGB_ATOL}: {frac:.6f} (bound "
              f"{BLIND_BAD_FRAC}, truncated windows), max-abs {float(d_rgb.max()):.3e}")
    solid = np.asarray(ds.density) > 0
    for f in ("density", "albedo"):
        rel, err, l2 = rel_err(getattr(g_w, f), getattr(g_b, f), solid)
        rep.check(f"window.grad.{f}_vs_blind", rel <= BLIND_GRAD_REL,
                  f"solid cells, {int(sat.sum())} rays agreeing to {BLIND_SAT_ATOL}: relative "
                  f"{rel:.3e} (bound {BLIND_GRAD_REL}), max-abs {err:.3e}, "
                  f"relative L2 {l2:.3e}")
    rep.peak("window")


def fit_batch(origins, dirs, targets, batch: int, ndev: int, seed: int = 0):
    """The first batch ``fit_world`` draws (same generator, same rounding)."""
    batch = (batch // ndev) * ndev
    idx = np.random.default_rng(seed).integers(0, origins.shape[0], batch)
    return origins[idx], dirs[idx], targets[idx]


def phase_fit(rep: Report, s, sz: Sizes) -> None:
    """A few guided ``fit_world`` steps at FitConfig's default view set; the
    first loss against the same loss computed directly; the step alone timed."""
    import optax

    from raytracing_test_tpu.app import fit as fitmod
    from raytracing_test_tpu.parallel import mesh as meshlib
    from raytracing_test_tpu.parallel import sharding as shardlib
    from raytracing_test_tpu.render import diff

    fc = sz.fit
    t0 = time.perf_counter()
    params, losses = fitmod.fit_world(
        s.scene, s.grid.shape, fc, batch=sz.fit_batch, log_every=1)
    wall = time.perf_counter() - t0
    rep.line(f"fit: {fc.views} views at {fc.resolution}^2, batch {sz.fit_batch}, "
             f"{fc.steps} guided steps; losses {[round(x, 6) for x in losses]}; "
             f"wall {wall:.2f} s incl. targets + compile (set-up) [{rep.label}]")
    rep.check("fit.finite", bool(np.isfinite(losses).all()), "(all losses finite)")

    origins, dirs, targets = fitmod.fit_targets(s.scene, s.grid.shape, fc)
    o, d, tg = fit_batch(origins, dirs, targets, sz.fit_batch, len(jax.devices()))
    # host copies: the train step below donates its device buffers
    p0 = jax.tree_util.tree_map(np.asarray, shardlib.init_params(s.grid.shape))
    guide = shardlib.guide_scene_from_params(p0, tau=fc.guide_tau)

    def direct(p, guide, o, d, tg):
        rgb = diff.render_rays_diff_guided(
            shardlib.params_to_scene(p), guide, o, d,
            num_steps=fc.guided_steps, sky=False, shading=fc.shading)
        return jnp.mean((rgb - tg) ** 2)

    with jax.default_matmul_precision("highest"):
        ref = float(jax.jit(direct)(p0, guide, o, d, tg))
    rel = abs(losses[0] - ref) / max(abs(ref), 1e-30)
    rep.check("fit.first_loss_vs_direct", rel <= FIT_LOSS_RTOL,
              f"step loss {losses[0]:.8f} vs direct {ref:.8f}: relative "
              f"{rel:.3e} (bound {FIT_LOSS_RTOL})")

    mesh = meshlib.make_mesh(len(jax.devices()), 1)
    opt = optax.adam(fc.lr)
    step = shardlib.make_train_step_guided(mesh, opt, num_steps=fc.guided_steps,
                                           shading=fc.shading)
    p, st = jax.device_put(p0), jax.device_put(opt.init(p0))
    t0 = time.perf_counter()
    comp = step.lower(p, st, guide, o, d, tg).compile()
    rep.compiled(f"fit.train_step batch {o.shape[0]}", time.perf_counter() - t0,
                 profiling.memory_summary(comp))
    p, st, loss = comp(p, st, guide, o, d, tg)
    jax.block_until_ready(loss)
    times = []
    for _ in range(sz.reps):
        t0 = time.perf_counter()
        p, st, loss = comp(p, st, guide, o, d, tg)
        jax.block_until_ready((p, st, loss))
        times.append(time.perf_counter() - t0)
    rep.timing(f"fit.train_step guided batch {o.shape[0]} x {fc.guided_steps}", times)
    rep.peak("fit")


def dp_step_outputs(guide, p0, o, d, tg, mesh, fc: FitConfig):
    """(loss, density_raw, albedo_raw) after one guided dp train step on
    ``mesh`` from ``p0``."""
    import optax

    from raytracing_test_tpu.parallel import mesh as meshlib
    from raytracing_test_tpu.parallel import sharding as shardlib

    opt = optax.adam(fc.lr)
    step = shardlib.make_train_step_guided(mesh, opt, num_steps=fc.guided_steps,
                                           shading=fc.shading)
    rep_sh = meshlib.replicated(mesh)
    rs = meshlib.rays_sharding(mesh)
    p = jax.device_put(p0, rep_sh)
    st = jax.device_put(opt.init(p0), rep_sh)
    p, st, loss = step(p, st, jax.device_put(guide, rep_sh), jax.device_put(o, rs),
                       jax.device_put(d, rs), jax.device_put(tg, rs))
    return float(loss), np.asarray(p.density_raw), np.asarray(p.albedo_raw)


def run_multi(rep: Report, sz: Sizes, n: int = 4) -> None:
    """The four-card paths and what each is compared with, nothing else:
    spatial and handoff frames over a (1, n) mesh vs the one-card fast
    frame; the guided data-parallel train step over (n, 1) vs one card."""
    from raytracing_test_tpu.app import fit as fitmod
    from raytracing_test_tpu.parallel import handoff, spatial
    from raytracing_test_tpu.parallel import mesh as meshlib
    from raytracing_test_tpu.parallel import sharding as shardlib
    from raytracing_test_tpu.render import fast

    devs = jax.devices()
    rep.check("multi.devices", len(devs) >= n, f"({len(devs)} devices, need {n})")
    if len(devs) < n:
        return
    s = phase_world(rep, sz)
    rcfg = RenderConfig(width=sz.res, height=sz.res, time=s.time)
    cam = s.camera()
    px = f"{sz.res}x{sz.res}"
    base = np.asarray(fast.render_fast_jit(s.scene, cam, rcfg))

    mesh = meshlib.make_mesh(1, n, devs[:n])
    sc = spatial.shard_scene_spatial(s.scene, mesh)
    for name, fn, cfg in (
        ("spatial", spatial.render_image_spatial, rcfg),
        ("handoff", handoff.render_image_handoff, replace(rcfg, enable_ao=False)),
    ):
        t0 = time.perf_counter()
        img = np.asarray(fn(sc, cam, cfg, mesh))
        rep.line(f"setup multi.{name} {px}: first call {time.perf_counter() - t0:.2f} s "
                 "(compile + run)")
        times = []
        for _ in range(sz.reps):
            t0 = time.perf_counter()
            np.asarray(fn(sc, cam, cfg, mesh))
            times.append(time.perf_counter() - t0)
        rep.timing(f"multi.{name} {px} over mesh (1, {n}) (host wall incl. readback)", times)
        frac, dmax = bad_fraction(img, base, FRAME_ATOL)
        rep.check(f"multi.{name}_vs_one_card_fast", frac <= FRAME_BAD_FRAC,
                  f"bad-pixel fraction {frac:.6f} (atol {FRAME_ATOL}, bound "
                  f"{FRAME_BAD_FRAC}), max |d| {dmax:.3e}")

    fc = sz.fit
    origins, dirs, targets = fitmod.fit_targets(s.scene, s.grid.shape, fc)
    o, d, tg = fit_batch(origins, dirs, targets, sz.fit_batch, n)
    # host copies: every step below gets fresh device buffers to donate
    p0 = jax.tree_util.tree_map(np.asarray, shardlib.init_params(s.grid.shape))
    guide = shardlib.guide_scene_from_params(p0, tau=fc.guide_tau)
    l1, d1, a1 = dp_step_outputs(guide, p0, o, d, tg,
                                 meshlib.make_mesh(1, 1, devs[:1]), fc)
    ln, dn, an = dp_step_outputs(guide, p0, o, d, tg,
                                 meshlib.make_mesh(n, 1, devs[:n]), fc)
    rel = abs(ln - l1) / max(abs(l1), 1e-30)
    rep.check("multi.dp_loss_vs_one_card", rel <= DP_LOSS_RTOL,
              f"loss {ln:.8f} vs {l1:.8f}: relative {rel:.3e} (bound {DP_LOSS_RTOL})")
    for f, got, ref in (("density_raw", dn, d1), ("albedo_raw", an, a1)):
        diff_ = np.abs(got - ref)
        frac = float((diff_ > DP_PARAM_ATOL).mean())
        rep.check(f"multi.dp_{f}_vs_one_card", frac <= DP_PARAM_BAD_FRAC,
                  f"share of params off by > {DP_PARAM_ATOL}: {frac:.3e} (bound "
                  f"{DP_PARAM_BAD_FRAC}), max-abs {float(diff_.max()):.3e}")
    mesh_dp = meshlib.make_mesh(n, 1, devs[:n])
    import optax

    opt = optax.adam(fc.lr)
    step = shardlib.make_train_step_guided(mesh_dp, opt, num_steps=fc.guided_steps)
    rsh, rs = meshlib.replicated(mesh_dp), meshlib.rays_sharding(mesh_dp)
    p, st = jax.device_put(p0, rsh), jax.device_put(opt.init(p0), rsh)
    args = (jax.device_put(guide, rsh), jax.device_put(o, rs),
            jax.device_put(d, rs), jax.device_put(tg, rs))
    p, st, loss = step(p, st, *args)
    jax.block_until_ready(loss)
    times = []
    for _ in range(sz.reps):
        t0 = time.perf_counter()
        p, st, loss = step(p, st, *args)
        jax.block_until_ready((p, st, loss))
        times.append(time.perf_counter() - t0)
    rep.timing(f"multi.dp_train_step guided batch {o.shape[0]} over mesh ({n}, 1)", times)
    rep.peak("multi")


def run_single(rep: Report, sz: Sizes) -> None:
    s = phase_world(rep, sz)
    fr = phase_frame(rep, s, sz)
    phase_edit(rep, s, sz, fr["fast"])
    phase_window(rep, s, sz, fr["seed"], fr["dirs"])
    phase_fit(rep, s, sz)


def last_line(info: Dict[str, object]) -> str:
    return json.dumps({"ok": True, "device": info})


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU paths and their one-card references")
    args = ap.parse_args(argv)

    info = profiling.require_gpu()
    from raytracing_test_tpu.utils.compile_cache import enable_compile_cache

    rep = Report(profiling.gpu_label())
    rep.line(f"card (name, power.limit): {rep.label}")
    rep.line(f"jax {jax.__version__}; devices {info}; compile cache "
             f"{enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.multi:
        run_multi(rep, FULL)
    else:
        run_single(rep, FULL)
    rep.line(f"total wall {time.perf_counter() - t0:.1f} s")
    if rep.failed:
        rep.line(f"FAILED checks: {rep.failed}")
        return 1
    rep.line(f"card (name, power.limit): {rep.label}")
    print(last_line(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
