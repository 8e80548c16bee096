"""Spatial sharding via ray SEGMENT HANDOFF — the ppermute formulation of
BASELINE config 5 (large worlds split across devices).

parallel/spatial.py (the semantics anchor) answers every voxel lookup with a
one-hot psum over the space axis: one [N] collective per DDA step. This module
removes that per-step collective: each device marches only the rays whose
current cell lies inside its x-slab, using the LOCAL slab of the
distance-encoded grid (so the march inherits the fast path's jump boxes,
analytic exits and material handling from render/fast.py), and rays that cross
a slab boundary are frozen and shipped to the neighbor with ``lax.ppermute`` —
one masked full-state exchange per ROUND instead of one psum per STEP. This is
the renderer analog of ring/context parallelism: ray segments ≈ sequence
blocks, the slab boundary crossing ≈ the block handoff (SURVEY.md §5.7).

Protocol (all arrays full ray width [N] on every space device; `resident`
marks the single owner of each lane — the invariant is exactly one resident
device per lane at all times):

  round := march all resident lanes until each is done or out-of-slab
           (inner ``lax.while_loop`` over render/fast.py's ``_march_body``
           against the local slab, global window semantics via ``shape3``)
        →  route: owner(cell.x & 1023) ≠ self ⇒ ship one hop toward the owner
           (two masked ppermutes, left and right; multi-slab jumps from large
           empty-space licenses take one hop per round)
        →  global active count via psum decides termination.

After the loop each lane's authoritative state lives on exactly one device;
``psum`` of resident-masked fields assembles the full result everywhere.
Exactness: the marched state is the same as render/fast.py's on a replicated
grid — tests require bit-identical output vs the single-device fast path.

The reference has no analog (one GPU, 4 GiB ceiling, voxel_allocator.hpp:12-14);
this is how the same scene model scales past one chip's HBM.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RenderConfig
from ..core.flatten import Scene
from ..core.types import Properties
from ..render import fast, renderer
from ..render.camera import Camera, ray_directions
from .mesh import DATA_AXIS, SPACE_AXIS
from .spatial import _slab_lookup, shard_scene_spatial  # noqa: F401 (re-export)

_INNER_CAP = 2048  # safety cap on one round's march iterations
_MAX_ROUNDS = 512  # safety cap on handoff rounds


def _owner(cell_x, slab_w: int, n_space: int):
    """Space-axis coordinate owning a cell: by WRAPPED x (the gather wraps
    &1023, flatten.lookup_material semantics), clamped so out-of-window
    addresses (which read as air everywhere) go to the edge slab."""
    return jnp.minimum((cell_x & 1023) // slab_w, n_space - 1)


def _mask_where(mask, a, b):
    """Per-lane select over a _March pytree (mask broadcasts over trailing dims)."""
    def sel(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - 1))
        return jnp.where(m, x, y)
    return jax.tree_util.tree_map(sel, a, b)


def _slab_gather_enc(scene_slab: Scene, shape3, x0, cell):
    """Distance-encoded gather against the local x-slab; exact vs the global
    fast._gather_enc for any cell this device owns (out-of-window cells read
    129 = air everywhere, matching the global rule)."""
    Sx, Sy, Sz = shape3
    w = scene_slab.grid_enc.shape[0]
    c = cell & 1023
    inside = (c[:, 0] < Sx) & (c[:, 1] < Sy) & (c[:, 2] < Sz)
    lx = c[:, 0] - x0
    local = inside & (lx >= 0) & (lx < w)
    lin = (jnp.where(local, lx, 0) * Sy + c[:, 1]) * Sz + c[:, 2]
    v = jnp.take(scene_slab.grid_enc.reshape(-1), lin).astype(jnp.int32)
    return jnp.where(local, v, 129)


def _handoff_march(
    scene_slab: Scene,
    shape3,
    slab_w: int,
    n_space: int,
    state,
    resident,
    cfg: RenderConfig,
    budget,
    shadow: bool,
    time_s,
):
    """Run the round loop; returns the ASSEMBLED final state (identical on all
    space devices). ``state`` must be identical across the space axis on entry;
    ``resident`` is each device's ownership mask."""
    idx = lax.axis_index(SPACE_AXIS)
    x0 = idx * slab_w
    perm_r = [(i, i + 1) for i in range(n_space - 1)]
    perm_l = [(i + 1, i) for i in range(n_space - 1)]

    def local_active(s, res):
        return res & ~s.done & (_owner(s.cell[:, 0], slab_w, n_space) == idx)

    def inner(s, res):
        def cond(c):
            s, i = c
            return (i < _INNER_CAP) & jnp.any(local_active(s, res))

        def body(c):
            s, i = c
            loc = local_active(s, res)
            enc = _slab_gather_enc(scene_slab, shape3, x0, s.cell)
            s_in = s._replace(done=s.done | ~loc)
            s2 = fast._march_body(
                scene_slab, s_in, enc, cfg, budget, shadow, time_s, shape3=shape3
            )
            return s2._replace(done=jnp.where(loc, s2.done, s.done)), i + 1

        s, _ = lax.while_loop(cond, body, (s, jnp.asarray(0, jnp.int32)))
        return s

    def ship(s, res):
        """Move each misplaced lane one hop toward its owner. Returns the
        number of lanes shipped from this device (the exchange-volume
        counter backing docs/SCALING.md's comms model)."""
        own = _owner(s.cell[:, 0], slab_w, n_space)
        move = res & ~s.done & (own != idx)
        send_r = move & (own > idx)
        send_l = move & (own < idx)
        shipped = jnp.sum(send_r) + jnp.sum(send_l)
        res = res & ~(send_r | send_l)
        if n_space > 1:
            def pp(perm):
                def f(a):  # collectives on pred types are backend-fragile
                    if a.dtype == jnp.bool_:
                        return lax.ppermute(a.astype(jnp.int32), SPACE_AXIS, perm) > 0
                    return lax.ppermute(a, SPACE_AXIS, perm)
                return f

            in_r = lax.ppermute(send_r.astype(jnp.int32), SPACE_AXIS, perm_r) > 0
            s_r = jax.tree_util.tree_map(pp(perm_r), s)
            s = _mask_where(in_r, s_r, s)
            in_l = lax.ppermute(send_l.astype(jnp.int32), SPACE_AXIS, perm_l) > 0
            s_l = jax.tree_util.tree_map(pp(perm_l), s)
            s = _mask_where(in_l, s_l, s)
            res = res | in_r | in_l
        return s, res, shipped

    def g_active(s, res):
        # over BOTH mesh axes: every device must run the same number of
        # rounds or the ppermute rendezvous deadlocks (data rows would
        # otherwise exit the loop after different round counts)
        return lax.psum(jnp.sum(res & ~s.done), (DATA_AXIS, SPACE_AXIS))

    def cond(carry):
        s, res, n, r, shp = carry
        return (r < _MAX_ROUNDS) & (n > 0)

    def body(carry):
        s, res, n, r, shp = carry
        s = inner(s, res)
        s, res, shipped = ship(s, res)
        return s, res, g_active(s, res), r + 1, shp + shipped

    state, resident, _, rounds, shipped = lax.while_loop(
        cond, body,
        (state, resident, g_active(state, resident), jnp.asarray(0, jnp.int32),
         jnp.asarray(0, jnp.int32)),
    )
    stats = {
        "rounds": rounds,
        "lanes_shipped": lax.psum(shipped, (DATA_AXIS, SPACE_AXIS)),
    }

    # assemble: exactly one device is resident per lane
    def merge(x):
        m = resident.reshape(resident.shape + (1,) * (x.ndim - 1))
        if x.dtype == jnp.bool_:
            return lax.psum(jnp.where(m, x, False).astype(jnp.int32), SPACE_AXIS) > 0
        return lax.psum(jnp.where(m, x, jnp.zeros((), x.dtype)), SPACE_AXIS)

    return jax.tree_util.tree_map(merge, state), stats


def render_rays_handoff(scene: Scene, origin, dirs, cfg: RenderConfig, mesh: Mesh,
                        return_stats: bool = False):
    """Full-feature fast-path render over a spatially-sharded world with ray
    segment handoff. ``scene`` must be placed by shard_scene_spatial; rays are
    sharded over the data axis (dp × sp compose). Hemisphere AO runs through
    the collective slab lookup (one psum per AO step — the budget is only
    ao_rays x ao_steps = 20 x 5, so the per-step collective the handoff loop
    exists to avoid is immaterial here)."""
    Sx, Sy, Sz = scene.shape3
    shape3 = (Sx, Sy, Sz)
    n_space = mesh.shape[SPACE_AXIS]
    slab_w = Sx // n_space
    assert slab_w * n_space == Sx, (Sx, n_space)
    f32 = jnp.float32

    scene_specs = Scene(
        mat=P(SPACE_AXIS, None, None),
        macro=P(), albedo=P(), flags=P(), metadata=P(),
        grid_enc=P(SPACE_AXIS, None, None), y_max=P(),
    )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(scene_specs, P(), P(DATA_AXIS, None), P()),
        out_specs=(P(DATA_AXIS, None), P(), P()),
        check_vma=False,
    )
    def _render(scene_slab, origin, dirs, time_s):
        idx = lax.axis_index(SPACE_AXIS)
        x0 = idx * slab_w
        N = dirs.shape[0]
        sun = jnp.asarray(cfg.sun_dir, f32)
        sun = sun / jnp.linalg.norm(sun)

        # starting-cell specials (frag:299-307): one collective lookup
        s = fast._init_state(origin, dirs, jnp.ones(N, f32))
        mat0 = _slab_lookup(scene_slab.mat, shape3, x0, s.cell)
        flags0 = jnp.take(scene_slab.flags, mat0)
        refr0 = (flags0 & int(Properties.REFRACTIVE)) > 0
        raw0 = (mat0 != 0) & ~refr0
        ior = jnp.where((mat0 != 0) & refr0, 1.1, 1.0).astype(f32)
        s = s._replace(ior=ior, done=raw0, mat=jnp.where(raw0, mat0, 0))

        resident = _owner(s.cell[:, 0], slab_w, n_space) == idx
        s, stats = _handoff_march(
            scene_slab, shape3, slab_w, n_space, s, resident, cfg,
            jnp.asarray(cfg.max_steps, jnp.int32), shadow=False, time_s=time_s,
        )

        def shadow_fn(p, cell, last_axis, step, active):
            return _shadow_handoff(
                scene_slab, shape3, slab_w, n_space, p, cell, last_axis,
                cfg, sun, active,
            )

        col, _ = renderer.shade(
            scene_slab, s, raw0, mat0, sun, cfg, shadow_fn,
            ao_lookup_fn=lambda cell: _slab_lookup(scene_slab.mat, shape3, x0, cell),
        )
        return col, stats["rounds"], stats["lanes_shipped"]

    col, rounds, shipped = _render(
        scene,
        jnp.asarray(origin, f32),
        jnp.asarray(dirs, f32),
        jnp.asarray(cfg.time, f32),
    )
    if return_stats:
        # 112 B of _March state cross the wire per shipped lane (28 fields x 4 B)
        return col, {"rounds": rounds, "lanes_shipped": shipped,
                     "bytes_shipped": shipped.astype(jnp.int64) * 112}
    return col


def _shadow_handoff(scene_slab, shape3, slab_w, n_space, p, cell, last_axis, cfg, sun, active):
    """Sun-shadow march through the handoff machinery (semantics of
    fast._shadow_march_fast). Shadow rays start at hit points, so their initial
    residency is naturally spread across slabs."""
    N = p.shape[0]
    d, sstep, sdelta, sabs = renderer._build_ray(jnp.broadcast_to(sun[None, :], p.shape))
    tmax = renderer._init_tmax(p, cell, sstep, sdelta, sabs)
    oh = renderer._onehot(last_axis, p.dtype)
    tmax = tmax - oh * sabs  # step out through the hit face (frag:380)
    s = fast._March(
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
    # first step is geometric (the hit block itself is not re-tested, frag:383)
    ax = renderer._argmin_axis(s.tmax)
    oh2 = renderer._onehot(ax, p.dtype)
    t_cross = renderer._get(s.tmax, ax)
    m3 = active[:, None]
    s = s._replace(
        cell=jnp.where(m3, s.cell + (oh2 * s.step).astype(jnp.int32), s.cell),
        tmax=jnp.where(m3, s.tmax + oh2 * s.abs_delta, s.tmax),
        last_axis=jnp.where(active, ax, s.last_axis),
        last_t=jnp.where(active, t_cross, s.last_t),
        steps=s.steps + active.astype(jnp.int32),
    )
    idx = lax.axis_index(SPACE_AXIS)
    resident = _owner(s.cell[:, 0], slab_w, n_space) == idx
    s, _ = _handoff_march(
        scene_slab, shape3, slab_w, n_space, s, resident, cfg,
        jnp.asarray(cfg.shadow_steps, jnp.int32), shadow=True, time_s=None,
    )
    return active & (s.mat != 0)


@functools.lru_cache(maxsize=16)
def _render_handoff_jit(cfg: RenderConfig, mesh: Mesh):
    # one executable per (config, mesh): repeated frames must not retrace
    return jax.jit(lambda sc, pos, d: render_rays_handoff(sc, pos, d, cfg, mesh))


def render_image_handoff(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh):
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    rs = NamedSharding(mesh, P(DATA_AXIS, None))
    dirs = jax.device_put(dirs, rs)
    col = _render_handoff_jit(cfg, mesh)(scene, camera.pos, dirs)
    return np.asarray(col).reshape(cfg.height, cfg.width, 3)
