"""Flattening: host world -> device-resident render structure.

The reference mirrors its pointer-free node pools into GPU SSBOs with per-slab
dirty tracking (voxel_allocator.hpp:38-78) and the shader walks the tree per
pixel per step (low_res.frag:493-532). Here the march runs as [N]-lane
vectorized XLA programs, where per-ray pointer chasing is the worst possible
shape, so the device structure is gather-friendly instead:

  - ``mat``: dense uint8 material-id grid over a window of the 1024^3 address
    space (0 = air). One dynamic gather per ray per DDA step.
  - palette arrays (``albedo`` f32[P,3], ``flags`` i32[P], ``metadata`` f32[P]):
    tiny tables, gathered only when resolving hits.
  - ``macro``: occupancy of 4^3 cells (uint8), the analog of the reference
    tree's branch bitmaps (empty-space skip, low_res.frag:520-524), used for
    hierarchical DDA skips.

Semantic equivalence: the dense grid is exactly the rasterization of the sparse
tree over the window (multi-res leaves expand to their covered voxels); lookups
wrap coordinates with & 1023 like the reference's bit-digest addressing, and
anything outside the window is air.

Incremental mirroring lives in core/mirror.py: edits mark 8^3 bricks dirty and
only the affected local boxes of each derived field are recomputed and
device-updated — the analog of the reference's dirty-slab glBufferSubData
upload (voxel_allocator.hpp:38-78). This module is the FULL flatten (initial
build / fallback); it has no incremental path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .color import u64_to_unit_f32
from .tree import Palette, VoxelTree
from .types import WORLD_MASK

MACRO_SHIFT = 2  # macro cells are 4^3 voxels
BRICK_SHIFT = 3  # host dirty tracking granularity, 8^3


class Scene(NamedTuple):
    """Device-resident render scene. All fields are arrays (jit-friendly pytree).

    The grid window is anchored at the address-space origin; its extent is the
    (static) array shape. Alongside the raw material grid it carries the
    render-time acceleration structure used by render/fast.py:

      - ``grid_enc``: the material grid with the empty space REPURPOSED as a
        cell-level Chebyshev distance field: solid cells carry their material
        id (< 128), air cells carry 128 + distance-to-nearest-solid. The fast
        march then needs exactly ONE u8 gather per iteration — it returns
        either the hit material or a certified all-air jump box (the
        generalization of the reference tree's bitmap empty-space skip,
        low_res.frag:520-524).
      - ``y_max``: one above the highest solid voxel; everything above is
        provably air, enabling analytic sky skips.
    """

    mat: jax.Array  # uint8 [Sx, Sy, Sz] material ids, 0 = air
    macro: jax.Array  # uint8 [Sx/4, Sy/4, Sz/4] occupancy of 4^3 cells
    albedo: jax.Array  # f32 [P, 3] canonical unpacked color (color.py)
    flags: jax.Array  # i32 [P] property bitfields (leaf bit included)
    metadata: jax.Array  # f32 [P]
    grid_enc: jax.Array  # uint8 [Sx, Sy, Sz]: v < 128 -> material id at the
    # cell (0 never occurs); v >= 128 -> air with Chebyshev distance v-128 >= 1
    # to the nearest solid cell (capped), licensing a radius-(d-1) jump box.
    # ONE gather yields both the material and the empty-space skip license.
    y_max: jax.Array  # i32 scalar: max solid y + 1
    # ---- brick hierarchy (render/bricks.py): marching at 4^3-brick
    # granularity with a one-hot matmul distance lookup (no gather), dropping
    # to per-voxel steps only inside occupied bricks whose 64-byte material
    # rows are row-gathered on entry. Fields default to None on paths that
    # don't render with bricks (spatially-sharded slabs build their own local
    # Scenes).
    brick_mat: Optional[jax.Array] = None  # u8 [NB, bs^3] per-brick voxel rows,
    # vox index (dx*bs + dy)*bs + dz, brick lin (bx*By + by)*Bz + bz
    brick_dist: Optional[jax.Array] = None  # u8 [Bx, By, Bz] exact Chebyshev
    # distance in BRICK units to the nearest solid-containing brick, capped at
    # BRICK_DIST_CAP; 0 = this brick contains solids (license = d-1 bricks)
    brick_nib: Optional[jax.Array] = None  # f32 [A, B] MXU one-hot byte table
    # of nibble-PAIRED brick distances (ops/mxu_lookup.pack_nibble_pairs)
    brick_nib_shadow: Optional[jax.Array] = None  # same, liquid-only bricks
    # counted as air (shadow rays skip LIQUID, low_res.frag:382-387)

    @property
    def shape3(self) -> Tuple[int, int, int]:
        return self.mat.shape

    @property
    def brick_dims(self) -> Tuple[int, int, int]:
        Sx, Sy, Sz = self.mat.shape
        return Sx // 4, Sy // 4, Sz // 4

    @property
    def brick_shift(self) -> int:
        """log2 of the brick edge (static: derived from array shape)."""
        bs3 = self.brick_mat.shape[1]
        return {64: 2, 512: 3, 4096: 4}[bs3]

    @property
    def brick_grid(self) -> Tuple[int, int, int]:
        s = self.brick_shift
        Sx, Sy, Sz = self.mat.shape
        return Sx >> s, Sy >> s, Sz >> s


def build_macro(grid: np.ndarray) -> np.ndarray:
    """Occupancy of each 4^3 cell of the grid."""
    s = 1 << MACRO_SHIFT
    Sx, Sy, Sz = grid.shape
    g = grid.reshape(Sx // s, s, Sy // s, s, Sz // s, s)
    return (g.max(axis=(1, 3, 5)) > 0).astype(np.uint8)


def palette_arrays(pal: Palette, pad_to: int = 8):
    """Palette -> (albedo f32[P,3], flags i32[P], metadata f32[P]) numpy arrays."""
    n = max(len(pal), 1)
    P = max(pad_to, int(2 ** np.ceil(np.log2(n))))
    albedo = np.zeros((P, 3), dtype=np.float32)
    flags = np.zeros(P, dtype=np.int32)
    meta = np.zeros(P, dtype=np.float32)
    albedo[:n] = u64_to_unit_f32(pal.color)
    albedo[0] = 0.0  # air's sentinel color must not leak into shading
    flags[:n] = pal.flags
    flags[0] = 0
    meta[:n] = pal.metadata
    return albedo, flags, meta


def _dilate_cheb(occ: np.ndarray, radius_log2: int) -> np.ndarray:
    """occ dilated by an L-inf cube of radius 2^radius_log2 - 1, via
    log-doubling shift-ORs (separable per axis)."""
    m = occ.copy()
    for j in range(radius_log2):
        k = 1 << j
        for ax in range(3):
            shifted = np.zeros_like(m)
            sl = [slice(None)] * 3
            sr = [slice(None)] * 3
            sl[ax] = slice(k, None)
            sr[ax] = slice(None, -k)
            shifted[tuple(sl)] = m[tuple(sr)]
            m |= shifted
            shifted[:] = False
            shifted[tuple(sr)] = m[tuple(sl)]
            m |= shifted
    return m


def build_grid_enc(grid: np.ndarray) -> np.ndarray:
    """Material grid -> distance-encoded grid (see Scene.grid_enc).

    Air distances are power-of-two LOWER BOUNDS (1, 2, 4, 8, 16, 32) built with
    log-doubling dilations — exact cell-level Chebyshev would cost O(cap)
    passes; the bounds cost O(log cap) and give within-2x jump radii.
    """
    assert int(grid.max(initial=0)) < 128, "material ids must fit 7 bits"
    occ = grid > 0
    enc = np.full(grid.shape, 128 + 1, np.uint8)  # air, distance >= 1
    for j in range(1, 6):  # dilation radii 1, 3, 7, 15, 31
        covered = _dilate_cheb(occ, j)
        enc[~covered] = 128 + (1 << j)  # distance > 2^j - 1  =>  >= 2^j
    enc[occ] = grid[occ]
    return enc


BRICK_DIST_CAP = 8  # max brick-level Chebyshev distance (license <= 7 bricks);
# nibble-packable, and keeps the incremental-update neighborhood small


def pick_brick_shift(shape) -> int:
    """Smallest brick edge 2^s in {4, 8, 16} keeping the brick count within
    the MXU one-hot table budget (<= 2^18 bricks -> <= 128K-byte table)."""
    for s in (2, 3, 4):
        nb = (shape[0] >> s) * (shape[1] >> s) * (shape[2] >> s)
        if nb <= (1 << 18) and all(d % (1 << s) == 0 for d in shape):
            return s
    raise ValueError(f"no brick decomposition for grid shape {shape}")


def brick_rows(grid: np.ndarray, s: int) -> np.ndarray:
    """Dense grid -> per-brick voxel rows u8[NB, (2^s)^3] (vox (dx*bs+dy)*bs+dz)."""
    bs = 1 << s
    Sx, Sy, Sz = grid.shape
    g = grid.reshape(Sx >> s, bs, Sy >> s, bs, Sz >> s, bs)
    return np.ascontiguousarray(g.transpose(0, 2, 4, 1, 3, 5)).reshape(-1, bs**3)


def brick_distance(occ_brick: np.ndarray) -> np.ndarray:
    """Brick occupancy -> exact capped Chebyshev distance field (u8)."""
    from ..ops.mxu_lookup import chebyshev_distance_field

    return chebyshev_distance_field(occ_brick, cap=BRICK_DIST_CAP)


def nib_table(dist: np.ndarray) -> np.ndarray:
    """Brick distance field -> f32[A, B] MXU one-hot byte table of packed
    nibble pairs (ops/mxu_lookup.mxu_nibble_lookup2 consumes this)."""
    from ..ops.mxu_lookup import byte_table_decomp, pack_bytes_rect, pack_nibble_pairs

    pairs = pack_nibble_pairs(dist.reshape(-1))
    A, B = byte_table_decomp(pairs.shape[0])
    return pack_bytes_rect(pairs, A, B)


def build_brick_fields(grid: np.ndarray, flags: np.ndarray):
    """(brick_mat, brick_dist, brick_nib, brick_nib_shadow) numpy arrays."""
    from ..core.types import Properties

    s = pick_brick_shift(grid.shape)
    rows = brick_rows(grid, s)
    occ = (rows > 0).any(axis=1).reshape((grid.shape[0] >> s,
                                          grid.shape[1] >> s,
                                          grid.shape[2] >> s))
    dist = brick_distance(occ)
    liquid_ids = (np.asarray(flags) & int(Properties.LIQUID)) > 0
    solid_hard = (rows > 0) & ~liquid_ids[rows]
    occ_sh = solid_hard.any(axis=1).reshape(occ.shape)
    dist_sh = brick_distance(occ_sh)
    return rows, dist, nib_table(dist), nib_table(dist_sh)


def world_y_max(grid: np.ndarray) -> np.int32:
    solid_y = np.nonzero(grid.any(axis=(0, 2)))[0]
    return np.int32(int(solid_y.max()) + 1 if len(solid_y) else 0)


def scene_from_grid(grid: np.ndarray, pal: Palette, device=None) -> Scene:
    """Build the device Scene from a dense material grid + palette."""
    albedo, flags, meta = palette_arrays(pal)
    put = (lambda x: jax.device_put(x, device)) if device is not None else jnp.asarray
    b_mat, b_dist, b_nib, b_nib_sh = build_brick_fields(grid, flags)
    return Scene(
        mat=put(grid),
        macro=put(build_macro(grid)),
        albedo=put(albedo),
        flags=put(flags),
        metadata=put(meta),
        grid_enc=put(build_grid_enc(grid)),
        y_max=put(world_y_max(grid)),
        brick_mat=put(b_mat),
        brick_dist=put(b_dist),
        brick_nib=put(b_nib),
        brick_nib_shadow=put(b_nib_sh),
    )


def scene_from_tree(tree: VoxelTree, pal: Palette, grid_shape, device=None) -> Scene:
    """Rasterize a tree window and build the Scene (full flatten)."""
    grid = rasterize_tree(tree, pal, grid_shape)
    return scene_from_grid(grid, pal, device)


def rasterize_tree(tree: VoxelTree, pal: Palette, grid_shape) -> np.ndarray:
    """Tree -> dense material-id grid over the window [0, shape)."""
    from .types import Block

    ext = max(grid_shape)
    flags, color, meta = tree.to_dense(ext)
    grid = np.zeros((ext,) * 3, dtype=np.uint8)
    solid = (flags & 1) == 1
    if solid.any():
        # dedupe (flags, color, meta) triples before the python palette loop
        f, c, m = flags[solid], color[solid], meta[solid]
        triples = np.stack([f.astype(np.int64), c.astype(np.int64), m.view(np.int32).astype(np.int64)], -1)
        uniq, inv = np.unique(triples, axis=0, return_inverse=True)
        uniq_ids = np.array(
            [
                pal.id_for(Block(int(uf), int(np.uint64(uc)), float(np.int32(um).view(np.float32))))
                for uf, uc, um in uniq
            ],
            dtype=np.uint8,
        )
        grid[solid] = uniq_ids[inv]
    return grid[: grid_shape[0], : grid_shape[1], : grid_shape[2]]


def lookup_material(scene: Scene, x, y, z):
    """Vectorized material lookup at integer voxel coords (any int arrays).

    Coordinates wrap with & 1023 (the reference's address-digest behavior,
    tetrahexa_tree.cpp:127); anything outside the grid window is air (0).
    """
    Sx, Sy, Sz = scene.shape3
    xm = x & WORLD_MASK
    ym = y & WORLD_MASK
    zm = z & WORLD_MASK
    inside = (xm < Sx) & (ym < Sy) & (zm < Sz)
    xc = jnp.where(inside, xm, 0)
    yc = jnp.where(inside, ym, 0)
    zc = jnp.where(inside, zm, 0)
    m = scene.mat[xc, yc, zc]
    return jnp.where(inside, m, 0).astype(jnp.int32)
