"""Interactive world session: the framework's analog of the reference's frame
loop + input handling (src/main.cpp, src/input.cpp), headless.

Owns the authoritative host tree (native C++ runtime when available, python
twin otherwise), the dense grid + palette, and the device Scene, and keeps
them in sync incrementally: edits mark bricks dirty in the tree, and ``sync``
re-rasterizes only those bricks into the grid before rebuilding the device
arrays — the analog of updateSsboData's dirty-slab upload
(voxel_allocator.hpp:38-78).

Camera parity (src/input.cpp):
  - dir = Ry(yaw) · Rx(pitch) · (0,0,1), pitch clamped to (-90, 90), yaw
    wrapped to [-180, 180] (rotateCamera, input.cpp:19-29)
  - move: forward along dir, strafe along -cross(dir, up), vertical along
    -cross(dir, cross(dir, up)), shift x4 (doInputUpdates, input.cpp:31-65)
  - LMB = delete picked block, RMB = place hotbar block at the pick's
    last_pos face, 30-step pick ray (input.cpp:135-168)
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from ..config import CameraConfig, RenderConfig, WorldConfig, replace
from ..core import flatten
from ..core.color import rgb_to_u64
from ..core.tree import Palette, VoxelTree
from ..core.types import HOTBAR_RGB, Block
from ..render import fast, renderer
from ..render.camera import Camera
from ..utils.log import Timer, debug
from . import picking


def _hotbar():
    return [
        Block(int(flags), int(rgb_to_u64(*rgb)), meta) for flags, rgb, meta in HOTBAR_RGB
    ]


class WorldSession:
    def __init__(self, wcfg: WorldConfig = WorldConfig(), use_native: bool = True):
        self.wcfg = wcfg
        self.palette = Palette()
        self.hotbar = _hotbar()
        self.selected = 0
        self._native = None
        if use_native:
            try:
                from ..native.runtime import NativeVoxelTree, is_available

                if is_available():
                    self._native = NativeVoxelTree()
            except Exception as e:  # pragma: no cover - env without compiler
                debug(1, f"native runtime unavailable ({e}); using python tree")

        with Timer("worldgen"):
            if self._native is not None:
                self._native.gen_world(wcfg)
                self.tree = self._native
                self.grid = self._export_native_grid()
            else:
                from ..worldgen import terrain

                self.grid, self.palette = terrain.gen_world_grid(wcfg)
                self.tree = terrain.gen_world_tree(wcfg, self.grid, self.palette)
        self._clear_dirty()
        with Timer("device flatten"):
            from ..core.mirror import SceneMirror

            self._mirror = SceneMirror(self.grid, self.palette)
            self.scene = self._mirror.scene

        # camera state (ref defaults: globals.cpp:20-21)
        cam = CameraConfig()
        self.pos = np.asarray(cam.pos, np.float64)
        self.yaw = 45.0  # matches the (1,0,1) default direction
        self.pitch = 0.0
        self.time = 0.0

    # ----------------------------------------------------------- tree helpers

    def _export_native_grid(self) -> np.ndarray:
        grid, pf, pc, pm = self._native.export_dense(self.wcfg.grid_shape)
        remap = np.zeros(len(pf), np.uint8)
        for i in range(1, len(pf)):
            remap[i] = self.palette.id_for(Block(int(pf[i]), int(pc[i]), float(pm[i])))
        return remap[grid]

    def _dirty(self):
        if self._native is not None:
            return self._native.dirty_bricks()
        return list(self.tree.dirty_bricks)

    def _clear_dirty(self):
        if self._native is not None:
            self._native.clear_dirty()
        else:
            self.tree.dirty_bricks.clear()

    # --------------------------------------------------------------- camera

    def camera_dir(self) -> np.ndarray:
        from ..render.camera import yaw_pitch_dir

        return np.asarray(yaw_pitch_dir(self.yaw, self.pitch), np.float32)

    def rotate(self, yaw_delta: float, pitch_delta: float) -> None:
        """rotateCamera parity: pitch hard-clamped, yaw wrapped."""
        if not (-90 < self.pitch + pitch_delta < 90):
            pitch_delta = 0.0
        self.pitch += pitch_delta
        self.yaw += yaw_delta
        if self.yaw > 180:
            self.yaw -= 360
        if self.yaw < -180:
            self.yaw += 360

    def move(self, forward=0.0, strafe=0.0, vertical=0.0, sprint=False) -> None:
        d = self.camera_dir().astype(np.float64)
        up = np.array([0.0, 1.0, 0.0])
        left = np.cross(d, up)
        down = np.cross(d, left)
        speed = 4.0 if sprint else 1.0
        self.pos = (
            self.pos + d * forward * speed - left * strafe * speed - down * vertical * speed
        )

    def camera(self) -> Camera:
        import jax.numpy as jnp

        return Camera(
            pos=jnp.asarray(self.pos, jnp.float32),
            dir=jnp.asarray(self.camera_dir(), jnp.float32),
        )

    # --------------------------------------------------------------- editing

    def pick(self, steps: int = 30) -> picking.RayResult:
        return picking.cast_ray(self.tree, self.pos, self.camera_dir(), steps)

    def place(self, slot: Optional[int] = None) -> Optional[Tuple[int, int, int]]:
        """RMB parity: put the hotbar block at the face cell of the pick."""
        res = self.pick()
        if slot is not None:
            self.selected = slot % len(self.hotbar)
        pos = res.last_pos
        self.tree.put_block(pos, self.hotbar[self.selected], 6)
        return pos

    def delete(self) -> Optional[Tuple[int, int, int]]:
        """LMB parity: delete the picked block (only if something was hit)."""
        res = self.pick()
        if not res.steps:
            return None
        self.tree.delete_block(res.pos, 6)
        return res.pos

    def sync(self) -> int:
        """Mirror dirty bricks into the grid + device scene; returns count.

        Incremental end-to-end: only dirty 8^3 bricks are re-rasterized into
        the host grid, and only the derived boxes they can affect are
        recomputed and uploaded (core/mirror.py) — the analog of the
        reference's dirty-slab glBufferSubData protocol, with per-edit cost
        independent of the world size."""
        from ..core.mirror import y_brick_counts

        bricks = self._dirty()
        if not bricks:
            return 0
        Sx, Sy, Sz = self.grid.shape
        bs = 8
        in_window = []
        old_counts = {}
        for b in bricks:
            bx, by, bz = b
            x0, y0, z0 = bx * bs, by * bs, bz * bs
            if not (0 <= x0 < Sx and 0 <= y0 < Sy and 0 <= z0 < Sz):
                continue
            in_window.append(b)
            old_counts[b] = y_brick_counts(self.grid, b)
            for dx in range(min(bs, Sx - x0)):
                for dy in range(min(bs, Sy - y0)):
                    for dz in range(min(bs, Sz - z0)):
                        blk = self.tree.get_block((x0 + dx, y0 + dy, z0 + dz))
                        self.grid[x0 + dx, y0 + dy, z0 + dz] = (
                            0 if blk.is_air else self.palette.id_for(blk)
                        )
        self._clear_dirty()
        self.scene = self._mirror.apply_bricks(in_window, old_counts)
        return len(bricks)

    # --------------------------------------------------------------- render

    def render(
        self,
        rcfg: RenderConfig,
        highlight: bool = True,
        fast_path: bool = True,
        mode: str = None,
    ) -> np.ndarray:
        """One frame, mirroring the reference render() flow: sync dirty state,
        pick for the looked-at highlight, then draw (main.cpp:68-108).

        ``mode`` selects the render path: fast (default), reference (the
        semantics anchor), progressive (coarse-to-fine, the reference's C11
        scheme), bricks (the brick-hierarchical XLA march), spatial / handoff
        (the world sharded over all devices' space axis).
        """
        self.sync()
        if highlight:
            res = self.pick()
            if res.steps:
                rcfg = replace(rcfg, looking_at=res.pos)
        rcfg = replace(rcfg, time=self.time)
        mode = mode or ("fast" if fast_path else "reference")
        cam = self.camera()
        if mode == "fast":
            return np.asarray(fast.render_fast_jit(self.scene, cam, rcfg))
        if mode == "bricks":
            from ..render import bricks as _bricks

            return np.asarray(_bricks.render_bricks_jit(self.scene, cam, rcfg))
        if mode == "reference":
            return np.asarray(renderer.render_jit(self.scene, cam, rcfg))
        if mode == "progressive":
            import jax

            from ..render import progressive

            img, _ = jax.jit(
                lambda sc, c: progressive.render_image_progressive(sc, c, rcfg)
            )(self.scene, cam)
            return np.asarray(img)
        if mode in ("spatial", "handoff"):
            import jax

            from ..parallel import handoff as ho, mesh as meshlib, spatial as sp

            mesh = meshlib.make_mesh(1, len(jax.devices()))
            sc = sp.shard_scene_spatial(self.scene, mesh)
            if mode == "handoff":
                rcfg = replace(rcfg, enable_ao=False)
                return ho.render_image_handoff(sc, cam, rcfg, mesh)
            return sp.render_image_spatial(sc, cam, rcfg, mesh)
        raise ValueError(f"unknown render mode {mode!r}")
