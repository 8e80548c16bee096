"""Incremental device mirroring — the dirty-slab protocol, done right.

The reference re-uploads only dirty 4 MiB slabs per frame (glBufferSubData,
voxel_allocator.hpp:38-78). A full rebuild of the derived scene per edit
costs O(world log world) host work plus a full re-upload. This module makes
the per-edit sync cost independent of world size:

  - the authoritative dense grid lives on the host (the session already owns
    it); edits arrive as dirty 8^3 bricks;
  - every derived structure is recomputed only in the LOCAL box that can be
    affected: grid_enc within Chebyshev 31 of the brick (its largest dilation
    radius), brick_dist within BRICK_DIST_CAP bricks, brick rows / macro
    within the brick itself;
  - one jitted device call applies all boxes via dynamic_update_slice (the
    glBufferSubData analog), batched over dirty bricks (padded to a power of
    two so recompiles are bounded);
  - y_max is maintained from per-height solid counts (O(box) per edit).

Axes shorter than the recompute boxes degrade gracefully to full-axis boxes
(still local along the other axes); the incremental result is asserted equal
to a from-scratch rebuild in tests/test_mirror.py.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import flatten
from .flatten import (
    BRICK_DIST_CAP,
    Scene,
    brick_distance,
    brick_rows,
    build_grid_enc,
    build_macro,
    nib_table,
    palette_arrays,
    pick_brick_shift,
)

_ENC_MARGIN = 32  # grid_enc's largest dilation radius is 31
_EDIT_BRICK = 8  # host dirty tracking granularity (core/tree.py BRICK_SHIFT)


def y_brick_counts(grid: np.ndarray, brick) -> np.ndarray:
    """Per-height solid counts of one dirty brick's current content (captured
    BEFORE rasterizing an edit so y_max can be maintained in O(box))."""
    bx, by, bz = brick
    x0, y0, z0 = bx * _EDIT_BRICK, by * _EDIT_BRICK, bz * _EDIT_BRICK
    sub = grid[x0 : x0 + _EDIT_BRICK, y0 : y0 + _EDIT_BRICK, z0 : z0 + _EDIT_BRICK]
    return (sub > 0).sum(axis=(0, 2)).astype(np.int64)


def _box_dims(shape, core, margin):
    """Per-axis (write, read) box extents for recomputing a derived field
    whose value at a cell depends on content within `margin`: the write box is
    core + 2*margin (everything the edit can affect), the read box adds
    another margin of context. Axes too short fall back to full extent
    (still exact — the whole axis is recomputed)."""
    w, r = [], []
    for s in shape:
        wi = core + 2 * margin
        ri = wi + 2 * margin
        if s >= ri:
            w.append(wi)
            r.append(ri)
        else:
            w.append(s)
            r.append(s)
    return tuple(w), tuple(r)


class SceneMirror:
    """Host mirrors + incremental updater for one Scene."""

    def __init__(self, grid: np.ndarray, pal):
        self.grid = grid  # authoritative host grid (shared with the session)
        self.pal = pal
        self.shift = pick_brick_shift(grid.shape)
        self.scene = flatten.scene_from_grid(grid, pal)
        self.brick_dist = np.array(self.scene.brick_dist)  # writable host copy
        self.brick_dist_shadow = self._shadow_dist_full()
        self.y_counts = (grid > 0).sum(axis=(0, 2)).astype(np.int64)

    # ------------------------------------------------------------- helpers

    def _flags(self):
        _, flags, _ = palette_arrays(self.pal)
        return flags

    def _shadow_occ(self, grid_box: np.ndarray) -> np.ndarray:
        from .types import Properties

        flags = self._flags()
        liquid = (flags & int(Properties.LIQUID)) > 0
        s = self.shift
        bs = 1 << s
        g = grid_box.reshape(
            grid_box.shape[0] >> s, bs, grid_box.shape[1] >> s, bs,
            grid_box.shape[2] >> s, bs,
        )
        solid_hard = (g > 0) & ~liquid[g]
        return solid_hard.any(axis=(1, 3, 5))

    def _occ(self, grid_box: np.ndarray) -> np.ndarray:
        s = self.shift
        bs = 1 << s
        g = grid_box.reshape(
            grid_box.shape[0] >> s, bs, grid_box.shape[1] >> s, bs,
            grid_box.shape[2] >> s, bs,
        )
        return (g > 0).any(axis=(1, 3, 5))

    def _shadow_dist_full(self) -> np.ndarray:
        return brick_distance(self._shadow_occ(self.grid))

    # --------------------------------------------------------------- sync

    def apply_bricks(
        self, bricks: Sequence[Tuple[int, int, int]], old_counts=None
    ) -> Scene:
        """Incrementally update the device Scene after the host grid changed
        inside the given dirty 8^3 bricks. ``old_counts`` (optional) is the
        per-height solid count of the OLD content {brick: int64[8]} for exact
        y_max maintenance; if omitted, y_counts is recomputed (O(world))."""
        if not bricks:
            return self.scene
        grid = self.grid
        Sx, Sy, Sz = grid.shape
        sh = self.shift
        if sh > 3 or min(grid.shape) < _EDIT_BRICK:
            # no local decomposition at this brick size: full rebuild
            self.scene = flatten.scene_from_grid(grid, self.pal)
            self.brick_dist = np.asarray(self.scene.brick_dist)
            self.brick_dist_shadow = self._shadow_dist_full()
            return self.scene

        if old_counts is not None:
            for b, old in old_counts.items():
                y0 = b[1] * _EDIT_BRICK
                new = y_brick_counts(grid, b)
                self.y_counts[y0 : y0 + len(new)] += new - old
        else:
            self.y_counts = (grid > 0).sum(axis=(0, 2)).astype(np.int64)
        nz = np.nonzero(self.y_counts)[0]
        y_max = np.int32(int(nz.max()) + 1 if len(nz) else 0)

        enc_w, enc_r = _box_dims(grid.shape, _EDIT_BRICK, _ENC_MARGIN)
        Bx, By, Bz = Sx >> sh, Sy >> sh, Sz >> sh
        bd_w, bd_r = _box_dims((Bx, By, Bz), max(_EDIT_BRICK >> sh, 1), BRICK_DIST_CAP)

        mats, mat_off = [], []
        encs, enc_off = [], []
        rows_vals, rows_idx = [], []
        macros, mac_off = [], []
        bds, bdss, bd_off = [], [], []
        for bx, by, bz in bricks:
            x0, y0, z0 = bx * _EDIT_BRICK, by * _EDIT_BRICK, bz * _EDIT_BRICK
            if not (0 <= x0 < Sx and 0 <= y0 < Sy and 0 <= z0 < Sz):
                continue
            # mat brick box, shifted inward at borders (idempotent: the values
            # come from the authoritative grid either way)
            mx = min(x0, Sx - _EDIT_BRICK)
            my = min(y0, Sy - _EDIT_BRICK)
            mz = min(z0, Sz - _EDIT_BRICK)
            mb = grid[mx : mx + _EDIT_BRICK, my : my + _EDIT_BRICK, mz : mz + _EDIT_BRICK]
            mats.append(mb)
            mat_off.append((mx, my, mz))

            # grid_enc write box (recomputed from a read box with margin)
            ws = [
                int(np.clip(o - (w - _EDIT_BRICK) // 2, 0, s - w))
                for o, w, s in zip((mx, my, mz), enc_w, grid.shape)
            ]
            rs = [
                int(np.clip(w0 - (r - w) // 2, 0, s - r))
                for w0, w, r, s in zip(ws, enc_w, enc_r, grid.shape)
            ]
            sub = grid[
                rs[0] : rs[0] + enc_r[0], rs[1] : rs[1] + enc_r[1], rs[2] : rs[2] + enc_r[2]
            ]
            enc_full = build_grid_enc(sub)
            o = [w0 - r0 for w0, r0 in zip(ws, rs)]
            encs.append(
                enc_full[
                    o[0] : o[0] + enc_w[0], o[1] : o[1] + enc_w[1], o[2] : o[2] + enc_w[2]
                ]
            )
            enc_off.append(tuple(ws))

            # brick rows + macro for the edit brick
            rows = brick_rows(mb, sh)  # [(8/bs)^3 * ..., bs^3] in brick order
            nbx = _EDIT_BRICK >> sh
            ids = []
            for dx in range(nbx):
                for dy in range(nbx):
                    for dz in range(nbx):
                        ids.append(
                            ((mx >> sh) + dx) * By * Bz
                            + ((my >> sh) + dy) * Bz
                            + ((mz >> sh) + dz)
                        )
            rows_vals.append(rows)
            rows_idx.append(np.asarray(ids, np.int32))
            macros.append(build_macro(mb))
            mac_off.append((mx >> 2, my >> 2, mz >> 2))

            # brick_dist write box (both variants), recomputed locally
            bc = (mx >> sh, my >> sh, mz >> sh)
            core_b = max(_EDIT_BRICK >> sh, 1)
            bws = [
                int(np.clip(c - (w - core_b) // 2, 0, s - w))
                for c, w, s in zip(bc, bd_w, (Bx, By, Bz))
            ]
            brs = [
                int(np.clip(w0 - (r - w) // 2, 0, s - r))
                for w0, w, r, s in zip(bws, bd_w, bd_r, (Bx, By, Bz))
            ]
            gsub = grid[
                brs[0] << sh : (brs[0] + bd_r[0]) << sh,
                brs[1] << sh : (brs[1] + bd_r[1]) << sh,
                brs[2] << sh : (brs[2] + bd_r[2]) << sh,
            ]
            occ = self._occ(gsub)
            occ_sh = self._shadow_occ(gsub)
            o = [w0 - r0 for w0, r0 in zip(bws, brs)]
            cut = lambda a: a[
                o[0] : o[0] + bd_w[0], o[1] : o[1] + bd_w[1], o[2] : o[2] + bd_w[2]
            ]
            bds.append(cut(brick_distance(occ)))
            bdss.append(cut(brick_distance(occ_sh)))
            bd_off.append(tuple(bws))
            # host mirrors
            self.brick_dist[
                bws[0] : bws[0] + bd_w[0], bws[1] : bws[1] + bd_w[1], bws[2] : bws[2] + bd_w[2]
            ] = bds[-1]
            self.brick_dist_shadow[
                bws[0] : bws[0] + bd_w[0], bws[1] : bws[1] + bd_w[1], bws[2] : bws[2] + bd_w[2]
            ] = bdss[-1]

        if not mats:
            return self.scene

        # pad the batch to a power of two (repeat the last brick: idempotent)
        k = len(mats)
        kp = 1 << int(np.ceil(np.log2(k)))
        rep = lambda lst: lst + [lst[-1]] * (kp - k)
        albedo, flags, meta = palette_arrays(self.pal)
        nib = nib_table(self.brick_dist)
        nib_sh = nib_table(self.brick_dist_shadow)

        self.scene = _device_apply(
            self.scene,
            jnp.asarray(np.stack(rep(mats))),
            jnp.asarray(np.stack(rep(mat_off)), jnp.int32),
            jnp.asarray(np.stack(rep(encs))),
            jnp.asarray(np.stack(rep(enc_off)), jnp.int32),
            jnp.asarray(np.stack(rep(rows_vals))),
            jnp.asarray(np.stack(rep(rows_idx))),
            jnp.asarray(np.stack(rep(macros))),
            jnp.asarray(np.stack(rep(mac_off)), jnp.int32),
            jnp.asarray(np.stack(rep(bds))),
            jnp.asarray(np.stack(rep(bd_off)), jnp.int32),
            jnp.asarray(albedo),
            jnp.asarray(flags),
            jnp.asarray(meta),
            jnp.asarray(nib),
            jnp.asarray(nib_sh),
            jnp.asarray(y_max),
        )
        return self.scene


@jax.jit
def _device_apply(
    scene: Scene,
    mats, mat_off, encs, enc_off, rows_vals, rows_idx, macros, mac_off,
    bds, bd_off, albedo, flags, meta, nib, nib_sh, y_max,
):
    """Apply a batch of box updates on device (the glBufferSubData analog).
    The shadow brick-distance field has no raw device mirror — only its nib
    table (rebuilt wholesale from the host mirror, it is tiny) ships."""

    def dus(a, box, off):
        return jax.lax.dynamic_update_slice(a, box, (off[0], off[1], off[2]))

    def body(carry, upd):
        mat, enc, macro, bmat, bdist = carry
        mb, mo, eb, eo, rv, ri, mcb, mco, bd, bo = upd
        mat = dus(mat, mb, mo)
        enc = dus(enc, eb, eo)
        macro = dus(macro, mcb, mco)
        bmat = bmat.at[ri].set(rv)
        bdist = dus(bdist, bd, bo)
        return (mat, enc, macro, bmat, bdist), None

    (mat, enc, macro, bmat, bdist), _ = jax.lax.scan(
        body,
        (scene.mat, scene.grid_enc, scene.macro, scene.brick_mat, scene.brick_dist),
        (mats, mat_off, encs, enc_off, rows_vals, rows_idx, macros, mac_off,
         bds, bd_off),
    )
    return Scene(
        mat=mat,
        macro=macro,
        albedo=albedo,
        flags=flags,
        metadata=meta,
        grid_enc=enc,
        y_max=y_max,
        brick_mat=bmat,
        brick_dist=bdist,
        brick_nib=nib,
        brick_nib_shadow=nib_sh,
    )
