"""One-hot matmul table lookups: turning gathers into matmuls.

For tables that fit a 64x64 factorization (<= 4096 entries), a lookup can be
expressed as two one-hot contractions instead of a gather:

    idx = hi*64 + lo
    M1  = onehot(hi) @ table.reshape(64, 64*C)      (matmul, bf16 x bf16 -> f32)
    out = sum_j onehot(lo)[:, j] * M1[:, j, :]      (select-reduce)

Exactness: table values are split into bytes (0..255), which bf16 represents
exactly; one-hot products and f32 accumulation are then exact, so u32 words
survive bit-for-bit.

This is the lookup engine for the render-time occupancy hierarchy
(core/flatten.py packs brick occupancy into exactly 4096 u32 words for the
256x128x256 default window).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pack_words_to_bytes_f32(words: np.ndarray, pad_to: int = 4096) -> np.ndarray:
    """u32[W] -> f32[pad, 4] little-endian bytes. ``pad_to`` must be a square
    of a multiple of 64 (4096 -> 64x64 decomposition, 16384 -> 128x128)."""
    w = np.asarray(words, dtype=np.uint32)
    assert w.ndim == 1 and w.shape[0] <= pad_to, (w.shape, pad_to)
    out = np.zeros((pad_to, 4), dtype=np.float32)
    for b in range(4):
        out[: w.shape[0], b] = ((w >> (8 * b)) & 0xFF).astype(np.float32)
    return out


def mxu_word_lookup(table_bytes: jax.Array, idx: jax.Array) -> jax.Array:
    """Lookup u32 words (as exact byte planes) by index.

    table_bytes: f32[W, 4] from pack_words_to_bytes_f32, W in {4096, 16384}
    (decomposed as 64x64 or 128x128).
    idx: int32[N] in [0, W).
    returns: int32[N] (the u32 word bit pattern; safe for bit ops).
    """
    W = table_bytes.shape[0]
    A = {4096: 64, 16384: 128}[W]
    hi = (idx // A).astype(jnp.int32)
    lo = (idx % A).astype(jnp.int32)
    ar = jnp.arange(A, dtype=jnp.int32)
    oh_hi = (hi[:, None] == ar[None, :]).astype(jnp.bfloat16)
    # bf16 holds integers <= 256 exactly, so byte planes survive bit-for-bit;
    # keeping the [N, A*4] intermediate in bf16 halves the bandwidth
    tab = table_bytes.reshape(A, A * 4).astype(jnp.bfloat16)
    m1 = jax.lax.dot_general(
        oh_hi, tab, (((1,), (0,)), ((), ())), preferred_element_type=jnp.bfloat16
    ).reshape(-1, A, 4)
    # select the lo row: broadcast one-hot multiply + reduce. NOT an
    # einsum — 'nj,njb->nb' lowers to N tiny batched matvecs.
    oh_lo = (lo[:, None] == ar[None, :]).astype(jnp.bfloat16)
    bytes_ = (m1 * oh_lo[:, :, None]).sum(axis=1)
    b = bytes_.astype(jnp.int32)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def byte_table_decomp(n_bytes: int):
    """(A, B) power-of-two factorization for an n-byte one-hot lookup table:
    A = one-hot width (matmul contraction dim), B = row width (select dim).
    MAC cost per lookup is A*B = W regardless of split; B is capped at 512 to
    bound the VPU select and the (N, B) intermediate."""
    W = 1 << int(np.ceil(np.log2(max(n_bytes, 1))))
    W = max(W, 4096)
    # balanced split: the (N, A) one-hot and (N, B) row intermediates are the
    # bandwidth cost — keep both <= 256
    B = min(256, W)
    A = W // B
    while A < 64 and B > 1:  # keep the matmul contraction >= 64 wide
        A *= 2
        B //= 2
    return A, B


def pack_bytes_rect(vals: np.ndarray, A: int, B: int) -> np.ndarray:
    """uint8[n] byte values -> f32[A, B] one-hot lookup table (row-major:
    byte i lives at [i // B, i % B])."""
    v = np.asarray(vals, np.uint8).ravel()
    assert v.shape[0] <= A * B, (v.shape, A, B)
    out = np.zeros(A * B, np.float32)
    out[: v.shape[0]] = v.astype(np.float32)
    return out.reshape(A, B)


def mxu_byte_lookup(table: jax.Array, idx: jax.Array) -> jax.Array:
    """Lookup byte values from an f32[A, B] table (pack_bytes_rect) by flat
    index — two one-hot stages: an MXU contraction over A then a VPU select
    over B. Exact for values <= 255 (bf16 holds small ints exactly).

    idx: int32[N] in [0, A*B). returns int32[N].
    """
    A, B = table.shape
    hi = (idx // B).astype(jnp.int32)
    lo = (idx % B).astype(jnp.int32)
    oh_hi = (hi[:, None] == jnp.arange(A, dtype=jnp.int32)[None, :]).astype(jnp.bfloat16)
    m1 = jax.lax.dot_general(
        oh_hi, table.astype(jnp.bfloat16), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (N, B) — row hi of the table per lookup
    oh_lo = lo[:, None] == jnp.arange(B, dtype=jnp.int32)[None, :]
    return jnp.where(oh_lo, m1, 0.0).sum(axis=1).astype(jnp.int32)


def pack_nibble_pairs(vals: np.ndarray) -> np.ndarray:
    """uint8[n] (values < 16) -> uint8[ceil(n/2)] little-endian nibble pairs
    (nibble i is bits [4*(i&1), 4*(i&1)+4) of byte i>>1)."""
    v = np.asarray(vals).astype(np.uint8).ravel()
    if v.shape[0] % 2:
        v = np.concatenate([v, np.zeros(1, np.uint8)])
    return (v[0::2] | (v[1::2] << 4)).astype(np.uint8)


def mxu_nibble_lookup2(table: jax.Array, nib_idx: jax.Array) -> jax.Array:
    """Nibble lookup through an f32[A, B] byte table of packed nibble pairs."""
    byte = mxu_byte_lookup(table, nib_idx >> 1)
    return (byte >> ((nib_idx & 1) << 2)) & 0xF


def mxu_nibble_lookup(table_bytes: jax.Array, nib_idx: jax.Array) -> jax.Array:
    """Lookup 4-bit values packed 8-per-u32-word (little-endian nibbles)."""
    word = mxu_word_lookup(table_bytes, nib_idx >> 3)
    return (word >> ((nib_idx & 7) << 2)) & 0xF


def chebyshev_distance_field(occupied: np.ndarray, cap: int = 15) -> np.ndarray:
    """L-inf distance (in cells) to the nearest occupied cell, capped.

    occupied: bool [X, Y, Z]; returns uint8 with 0 = occupied. Distance d >= 1
    certifies that every cell within Chebyshev radius d-1 is empty — the jump
    license used by the fast renderer's empty-space advance.
    """
    occ = np.asarray(occupied, bool)
    dist = np.where(occ, 0, cap).astype(np.uint8)
    cur = occ.copy()
    for d in range(1, cap):
        # one Chebyshev dilation = 3^3 max-pool; separable as composed
        # per-axis +/-1 shift-ORs (each axis applied to the running result)
        nxt = cur.copy()
        for ax in range(3):
            sl = [slice(None)] * 3
            sr = [slice(None)] * 3
            sl[ax] = slice(1, None)
            sr[ax] = slice(None, -1)
            grown = nxt.copy()
            grown[tuple(sl)] |= nxt[tuple(sr)]
            grown[tuple(sr)] |= nxt[tuple(sl)]
            nxt = grown
        newly = nxt & ~cur
        dist[newly] = d
        cur = nxt
        if cur.all():
            break
    return dist


def pack_nibbles(vals: np.ndarray) -> np.ndarray:
    """uint8[n] (values < 16) -> u32[ceil(n/8)] little-endian nibble packing."""
    v = np.asarray(vals).astype(np.uint32).ravel()
    pad = (-len(v)) % 8
    if pad:
        v = np.concatenate([v, np.zeros(pad, np.uint32)])
    v = v.reshape(-1, 8)
    shifts = (np.arange(8, dtype=np.uint32) * 4).astype(np.uint32)
    return (v << shifts[None, :]).sum(axis=1, dtype=np.uint32)


def mxu_bit_lookup(table_bytes: jax.Array, bit_idx: jax.Array) -> jax.Array:
    """Test bit ``bit_idx`` of a packed bitfield stored as u32 words.

    bit_idx: int32[N] in [0, 131072). returns int32[N] in {0, 1}.
    """
    word = mxu_word_lookup(table_bytes, bit_idx >> 5)
    return (word >> (bit_idx & 31)) & 1


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """bool[n] -> u32[ceil(n/32)] little-endian bit packing."""
    b = np.asarray(bits).astype(np.uint8).ravel()
    pad = (-len(b)) % 32
    if pad:
        b = np.concatenate([b, np.zeros(pad, np.uint8)])
    b = b.reshape(-1, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return (b << shifts[None, :]).sum(axis=1, dtype=np.uint32)
