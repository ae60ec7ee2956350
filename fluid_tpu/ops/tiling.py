"""Tile-block <-> dense-grid assembly, fully dense (no scatter/gather).

The tiled backend computes per-TILE expanded blocks (tile of T^D cells plus
a 1-cell stencil halo on every side => E = T+2 per axis) and moves between
blocks and the dense grid with *static strided reshapes only* — no scatter
or gather:

* ``assemble``: overlap-add all tile blocks into the dense grid.  For each
  axis and each local index e in [0, E), block values land at global
  ``t*T + e - 1`` — a stride-T comb, realized by writing column ``e % T`` of
  a zero [nt, T] panel and reshaping (a single static column write, dense).
  Axis passes compose because the block offsets factorize per axis.
* ``extract``: the transpose — slice the 1-padded dense grid with stride-T
  combs (``canvas[e::T]``) and stack.

Out-of-grid halo (global cell -1 / shape) is cropped, matching the
reference's stencil bounds checks (2d_multi.rs:165-167).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def _axis_pass_assemble(x: jnp.ndarray, axis: int, T: int) -> jnp.ndarray:
    """One axis of overlap-add: [..., nt, E, ...] -> [..., nt*T + 2, ...].

    Output index along the merged axis is ``t*T + e`` (an offset of +1 vs the
    global grid — i.e. the canvas includes the out-of-grid halo cell at each
    end; callers crop).
    """
    nt = x.shape[axis]
    E = x.shape[axis + 1]
    out_len = nt * T + (E - T)
    lead = x.shape[:axis]
    trail = x.shape[axis + 2 :]
    canvas = jnp.zeros((*lead, out_len, *trail), x.dtype)
    for e in range(E):
        col = e % T
        base = (e // T) * T
        panel = jnp.zeros((*lead, nt, T, *trail), x.dtype)
        sl = (slice(None),) * axis + (slice(None), slice(col, col + 1))
        panel = panel.at[sl].set(
            jnp.take(x, jnp.array([e]), axis=axis + 1)
        )
        flat = panel.reshape(*lead, nt * T, *trail)
        # for e >= T the comb starts at base=T and its tail (all zeros, since
        # col < T) would overrun the canvas — trim it
        seg = min(nt * T, out_len - base)
        src = (slice(None),) * axis + (slice(0, seg),)
        dst = (slice(None),) * axis + (slice(base, base + seg),)
        canvas = canvas.at[dst].add(flat[src])
    return canvas


def _axis_pass_extract(x: jnp.ndarray, axis: int, T: int, E: int) -> jnp.ndarray:
    """One axis of windowed read: [..., nt*T + 2, ...] -> [..., nt, E, ...]."""
    canvas_len = x.shape[axis]
    nt = (canvas_len - (E - T)) // T
    parts = []
    for e in range(E):
        sl = (slice(None),) * axis + (slice(e, e + nt * T, 1),)
        v = x[sl]
        # take every T-th starting at 0 => global positions t*T + e
        sl2 = (slice(None),) * axis + (slice(0, nt * T, T),)
        parts.append(v[sl2])
    out = jnp.stack(parts, axis=axis + 1)  # [..., nt, E, ...]
    return out


def assemble(blocks: jnp.ndarray, tshape: Tuple[int, ...], T: int) -> jnp.ndarray:
    """Overlap-add tile blocks into the dense grid.

    blocks: [n_tiles, E, ..., E, *chan] with n_tiles = prod(tshape) (C-order).
    The halo width h = (E - T) // 2 is inferred from the block shape (window
    cell e maps to global cell t*T + e - h).  Returns dense grid
    [tshape[0]*T, ..., tshape[-1]*T, *chan]; out-of-grid halo cells are
    cropped (dropped, like the reference bounds checks).
    """
    D = len(tshape)
    E = blocks.shape[1]
    h = (E - T) // 2
    chan = blocks.shape[1 + D :]
    x = blocks.reshape(*tshape, *(E,) * D, *chan)
    # interleave to [nt0, E, nt1, E, ...]
    perm = []
    for d in range(D):
        perm += [d, D + d]
    perm += [2 * D + i for i in range(len(chan))]
    x = x.transpose(perm)
    for d in range(D):
        # merged axes before d are single axes; axis index of nt_d is d
        x = _axis_pass_assemble(x, d, T)
    # crop the h halo cells at each end of each axis
    crop = tuple(slice(h, h + tshape[d] * T) for d in range(D))
    return x[crop]


def extract(grid: jnp.ndarray, tshape: Tuple[int, ...], T: int, halo: int = 1) -> jnp.ndarray:
    """Windowed read of expanded tile blocks from the dense grid.

    grid: [tshape[0]*T, ..., *chan].  Returns [n_tiles, E, ..., E, *chan]
    with E = T + 2*halo.  Out-of-grid halo reads as 0.
    """
    D = len(tshape)
    E = T + 2 * halo
    chan = grid.shape[D:]
    pad = [(halo, halo)] * D + [(0, 0)] * len(chan)
    x = jnp.pad(grid, pad)
    for d in range(D):
        # current axis d is at position 2*d (after earlier splits)
        x = _axis_pass_extract(x, 2 * d, T, E)
    # x: [nt0, E, nt1, E, ..., *chan] -> [n_tiles, E..., *chan]
    perm = [2 * d for d in range(D)] + [2 * d + 1 for d in range(D)]
    perm += [2 * D + i for i in range(len(chan))]
    x = x.transpose(perm)
    import math

    return x.reshape(math.prod(tshape), *(E,) * D, *chan)


def halo_sum(blocks: jnp.ndarray, tshape: Tuple[int, ...], T: int) -> jnp.ndarray:
    """Overlap-add entirely in block space (no dense grid round-trip).

    Each grid cell is replicated in up to 2^D neighboring tiles' expanded
    blocks; after this halo summation every replica holds the GLOBAL sum of
    deposits at its cell: for each tile-offset delta in {-1,0,1}^D, local
    cells e with e - T*delta_d in [0, E) receive the neighbor's aligned
    slice.  27 (3D) static slice-adds over [*tshape, E, ..., *chan]; edge
    tiles simply receive nothing from missing neighbors.

    This is the tile-block analog of the reference's p_rect halo (SURVEY.md
    §5.7); out-of-grid cells are NOT cropped here — apply ``edge_mask`` after.
    """
    D = len(tshape)
    E = blocks.shape[1]
    chan = blocks.shape[1 + D :]
    x = blocks.reshape(*tshape, *(E,) * D, *chan)
    nc = (slice(None),) * len(chan)
    # Separable: one pass per axis (the 3^D neighbor shifts are the tensor
    # product of per-axis 3-shifts; sequential per-axis accumulation computes
    # that product by distributivity).  Each pass: 2 slice-adds.
    for d in range(D):
        t_ax, e_ax = d, D + d

        def sl(tile_s, e_s, which_t, which_e):
            idx = [slice(None)] * (2 * D)
            idx[which_t] = tile_s
            idx[which_e] = e_s
            return tuple(idx) + nc

        out = x
        # from +1 neighbor: my e in [T, E) == their [0, E-T)
        out = out.at[sl(slice(None, -1), slice(T, E), t_ax, e_ax)].add(
            x[sl(slice(1, None), slice(0, E - T), t_ax, e_ax)]
        )
        # from -1 neighbor: my e in [0, E-T) == their [T, E)
        out = out.at[sl(slice(1, None), slice(0, E - T), t_ax, e_ax)].add(
            x[sl(slice(None, -1), slice(T, E), t_ax, e_ax)]
        )
        x = out
    import math

    return x.reshape((math.prod(tshape),) + (E,) * D + chan)


def edge_mask(tshape: Tuple[int, ...], T: int, dtype=jnp.float32, halo: int = 1) -> jnp.ndarray:
    """[n_tiles, E, ..., E] mask: 1 where the block cell maps to a real grid
    cell, 0 for the out-of-grid halo of boundary tiles (the reference drops
    those stencil taps, 2d_multi.rs:165-167).  E = T + 2*halo."""
    import math

    D = len(tshape)
    E = T + 2 * halo
    per_axis = []
    for d in range(D):
        t_io = jnp.arange(tshape[d])[:, None]
        e_io = jnp.arange(E)[None, :]
        g = t_io * T + e_io - halo
        per_axis.append(((g >= 0) & (g < tshape[d] * T)).astype(dtype))
    m = per_axis[0]
    for d in range(1, D):
        m = m[..., None, None] * per_axis[d][None, None, ...]
        # shape grows as [t0, E, t1, E, ...]; reorder at the end
    # m currently [t0, E, t1, E, (t2, E)]
    perm = [2 * d for d in range(D)] + [2 * d + 1 for d in range(D)]
    m = m.transpose(perm)
    return m.reshape((math.prod(tshape),) + (E,) * D)
