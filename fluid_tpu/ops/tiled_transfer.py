"""Tiled transfer — P2G/G2P without per-tap random access.

This backend restructures the transfer so that per-substep random access is
exactly: one key sort, one PACKED binned gather (wide rows), and one packed
un-bin — everything else is dense tensor algebra (batched contractions and
elementwise work):

1. **Bin**: argsort by tile id (tiles of T^D cells); per-tile start offsets
   via a boundary scatter-min + reverse cummin (no searchsorted); compact
   OCCUPIED tiles into a static ``active`` budget (dam-break fluid occupies
   a small fraction of the padded domain — the active list plays the role
   of the reference's sparse chunk map, ``particles_mul`` 2d_multi.rs:52);
   gather all particle fields in ONE [slots, 16]-row packed gather.
2. **Profiles**: per-axis quadratic-B-spline weight profiles over the
   expanded window (E = T+2) in [tile, E, cap] layout (``cap`` minor).
3. **Deposit (P2G)**: tap weight = prod_d p_d and the APIC/eq-16 tap values
   are AFFINE in the tap offset (o_d - 1):  m(v + C dpos_tap) =
   m(v - C dvec) + sum_d (o_d-1) m C[:,d], so every scatter becomes staged
   tensor-product contractions ending in a per-tile matmul over ``cap``.
4. **Assemble**: scatter the few active blocks into the dense block array
   (wide rows — cheap), then overlap-add with static strided reshapes
   (ops/tiling.py).
5. **Extract + G2P**: the transposed path; per-slot contractions give
   density, velocity and the affine B matrix
   (B_ij = v_i*(-dvec_j) + sum_taps w (o_j-1) v_i).
6. **Un-bin**: one packed scatter back to the original particle order.

Capacity: ``cap`` slots per tile; overflowing particles (slot >= cap) and
particles in tiles beyond the ``active`` budget freeze for one substep (old
state passes through) and are countable via ``overflow_count`` — size
``cap``/``active`` so this never fires (tests assert it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import Config
from ..domain import Domain
from ..state import GridState, ParticleState
from .eos import tait_pressure
from .tiling import assemble, edge_mask, halo_sum


@dataclasses.dataclass(frozen=True)
class TileSpec:
    tile: int = 4  # cells per tile edge
    cap: int = 256  # particle slots per tile
    active: Optional[int] = None  # occupied-tile budget (None = all tiles)
    # strict=True skips the frozen-fallback machinery (one [N]-row gather per
    # substep) by ASSERTING overflow never happens — verify with
    # overflow_count first; overflowing particles would get wrong state.
    strict: bool = False


def default_spec(cfg: Config, n_particles: Optional[int] = None) -> TileSpec:
    """~6x rest-density headroom; bump ``cap`` for deliberately over-dense
    scenes.  ``active`` defaults to all tiles (safe); pass a budget for
    large sparse domains."""
    t = 4
    cap = int(math.ceil(cfg.rest_density * t**cfg.dim * 6.0))
    cap = max(32, -(-cap // 8) * 8)
    return TileSpec(tile=t, cap=cap, active=None)


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------


def _tile_geometry(domain: Domain, spec: TileSpec):
    T = spec.tile
    if any(s % T for s in domain.shape):
        raise ValueError(f"grid shape {domain.shape} not divisible by tile={T}")
    tshape = tuple(s // T for s in domain.shape)
    return tshape, math.prod(tshape)


def _flatten_coords(c: jnp.ndarray, shape: Tuple[int, ...]) -> jnp.ndarray:
    strides = []
    s = 1
    for d in range(len(shape) - 1, -1, -1):
        strides.append(s)
        s *= shape[d]
    strides = jnp.asarray(strides[::-1], jnp.int32)
    return (c * strides).sum(axis=-1)


def _unflatten(idx: jnp.ndarray, shape: Tuple[int, ...]) -> jnp.ndarray:
    out = []
    for d in range(len(shape) - 1, -1, -1):
        out.append(idx % shape[d])
        idx = idx // shape[d]
    return jnp.stack(out[::-1], axis=-1)


# ---------------------------------------------------------------------------
# Binning (sort + active-tile compaction + packed gather)
# ---------------------------------------------------------------------------


def bin_particles(pos: jnp.ndarray, domain: Domain, spec: TileSpec):
    """Sort by tile id, compact occupied tiles, build the slot structure.

    Returns a dict with:
      order [N], sid [N] (sorted tile ids), start [nt+1],
      tile_of_active [A] (int32, nt = inactive), act_start [A],
      bsrc [A, cap] (original particle index per slot), valid [A, cap],
      frozen [N] (sorted-order mask: slot/budget overflow), tshape, n_active.
    """
    tshape, nt = _tile_geometry(domain, spec)
    T, cap = spec.tile, spec.cap
    A = spec.active if spec.active is not None else nt
    n = pos.shape[0]
    shape = jnp.asarray(domain.shape, jnp.int32)
    origin = jnp.asarray(domain.origin, jnp.int32)

    cell = jnp.clip(jnp.floor(pos).astype(jnp.int32) - origin, 0, shape - 1)
    tid = _flatten_coords(cell // T, tshape)

    order = jnp.argsort(tid)
    sid = jnp.take(tid, order)
    ranks = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones((1,), bool), sid[1:] != sid[:-1]])
    start = jnp.full((nt + 1,), n, jnp.int32)
    start = start.at[sid].min(jnp.where(first, ranks, n))
    start = lax.cummin(start[::-1])[::-1]
    count = start[1:] - start[:-1]  # [nt]

    occ = count > 0
    rank = jnp.cumsum(occ.astype(jnp.int32)) - 1  # occupied rank per tile
    act_of_tile = jnp.where(occ & (rank < A), rank, A)  # A = "inactive"
    tile_of_active = jnp.full((A,), -1, jnp.int32)
    tile_of_active = tile_of_active.at[jnp.clip(act_of_tile, 0, A - 1)].max(
        jnp.where(act_of_tile < A, jnp.arange(nt, dtype=jnp.int32), -1)
    )
    tile_of_active = jnp.where(tile_of_active < 0, nt, tile_of_active)

    act_start = jnp.take(jnp.append(start[:-1], n), jnp.clip(tile_of_active, 0, nt))
    act_count = jnp.take(jnp.append(count, 0), jnp.clip(tile_of_active, 0, nt))

    s_arange = jnp.arange(cap, dtype=jnp.int32)
    bidx = act_start[:, None] + s_arange[None, :]
    valid = s_arange[None, :] < act_count[:, None]
    bsrc = jnp.take(order, jnp.clip(bidx, 0, n - 1).ravel()).reshape(A, cap)

    # frozen = slot overflow OR inactive-tile overflow (sorted order)
    start_at = jnp.take(start[:-1], sid)
    slot_rank = ranks - start_at
    tile_inactive = jnp.take(act_of_tile, sid) >= A
    frozen = (slot_rank >= cap) | tile_inactive

    return dict(
        order=order,
        sid=sid,
        start=start,
        tile_of_active=tile_of_active,
        act_start=act_start,
        bsrc=bsrc,
        valid=valid,
        frozen=frozen,
        tshape=tshape,
        n_active=A,
    )


# ---------------------------------------------------------------------------
# Profiles ([A, E, cap] — cap minor) and contractions
# ---------------------------------------------------------------------------


def _axis_weights(dv: jnp.ndarray) -> jnp.ndarray:
    """dv: [A, cap] -> [A, 3, cap] quadratic weights (2d_multi.rs:368-374)."""
    return jnp.stack(
        [0.5 * (0.5 - dv) ** 2, 0.75 - dv * dv, 0.5 * (0.5 + dv) ** 2], axis=1
    )


def _profiles_axis(blc_d: jnp.ndarray, w3_d: jnp.ndarray, E: int):
    """blc_d: [A, cap] int32; w3_d: [A, 3, cap].  Returns (plain, moment)
    [A, E, cap]."""
    e_io = jnp.arange(E, dtype=jnp.int32)[None, :, None]
    plain = jnp.zeros(w3_d.shape[:1] + (E,) + w3_d.shape[2:], w3_d.dtype)
    moment = jnp.zeros_like(plain)
    for o in range(3):
        eq = e_io == (blc_d[:, None, :] + o)
        plain = plain + jnp.where(eq, w3_d[:, o : o + 1, :], 0.0)
        moment = moment + jnp.where(eq, w3_d[:, o : o + 1, :] * (o - 1.0), 0.0)
    return plain, moment


def _deposit(profs: List[jnp.ndarray], ch: jnp.ndarray) -> jnp.ndarray:
    """profs: D arrays [A, E, cap]; ch: [A, C, cap].
    Returns blocks [A, E0, C * E1 * ... * E_{D-1}] (axis-0 window leading,
    channel-major trailing: [C, E1, ..., E_{D-1}] flattened)."""
    A, C, cap = ch.shape
    E = profs[0].shape[1]
    X = ch  # [A, C_flat, cap]; ascending d keeps trailing layout (C, E1, E2, ...)
    for d in range(1, len(profs)):
        X = (X[:, :, None, :] * profs[d][:, None, :, :]).reshape(A, -1, cap)
    # contract cap: [A, E, cap] x [A, F, cap] -> [A, E, F]
    return lax.dot_general(
        profs[0], X, (((2,), (2,)), ((0,), (0,))), precision=lax.Precision.HIGHEST, preferred_element_type=jnp.float32
    )


def _collect(profs: List[jnp.ndarray], blocks: jnp.ndarray, C: int) -> jnp.ndarray:
    """Transpose of _deposit: blocks [A, E, C*E*...*E] -> per-slot [A, C, cap]."""
    A = blocks.shape[0]
    E = profs[0].shape[1]
    cap = profs[0].shape[-1]
    # contract E0: [A, E, cap] x [A, E, F] -> [A, F, cap]
    X = lax.dot_general(
        blocks, profs[0], (((1,), (1,)), ((0,), (0,))), precision=lax.Precision.HIGHEST, preferred_element_type=jnp.float32
    )  # [A, F, cap]
    for d in range(1, len(profs)):
        # X: [A, C*rest*E_d? ...] — current layout [A, C*E_d*rest, cap] with
        # E_d the leading expanded axis after C
        F = X.shape[1]
        rest = F // (C * E)
        X = X.reshape(A, C, E, rest, cap)
        X = jnp.sum(X * profs[d][:, None, :, None, :], axis=2).reshape(A, -1, cap)
    return X  # [A, C, cap]


def _axis_variants(plain, moment, d):
    return [moment[i] if i == d else plain[i] for i in range(len(plain))]


def _cat_profiles(plain, moment):
    """Per-axis K-concat of the 1+D variant groups along the slot axis.

    Group g uses the moment profile on axis g-1 and plain elsewhere;
    sum_g dot(P_g, X_g) == dot(concat_K(P_g), concat_K(X_g)) — one big
    matmul instead of 1+D small ones.
    Returns list of D arrays [A, E, (1+D)*cap].
    """
    D = len(plain)
    out = []
    for axis in range(D):
        groups = [plain[axis]]
        for g in range(D):
            groups.append(moment[axis] if g == axis else plain[axis])
        out.append(jnp.concatenate(groups, axis=-1))
    return out


def _deposit_merged(plain, moment, ch_groups) -> jnp.ndarray:
    """Sum of 1+D variant deposits as ONE contraction.

    ch_groups: list of 1+D channel tensors [A, C, cap] (same C — zero-pad
    rows that a group doesn't use).  Returns blocks like _deposit.
    """
    profs_cat = _cat_profiles(plain, moment)
    ch_cat = jnp.concatenate(ch_groups, axis=-1)  # [A, C, (1+D)*cap]
    return _deposit(profs_cat, ch_cat)


def _collect_all_variants(plain, moment, blocks: jnp.ndarray, C: int):
    """All 1+D variant collects (plain + per-axis moment) in one contraction.

    Returns list of 1+D tensors [A, C, cap] (plain first).
    """
    A = blocks.shape[0]
    E = plain[0].shape[1]
    cap = plain[0].shape[-1]
    D = len(plain)
    G = 1 + D
    profs_cat = _cat_profiles(plain, moment)
    X = _collect(profs_cat, blocks, C)  # [A, C, G*cap]
    return [X[:, :, g * cap : (g + 1) * cap] for g in range(G)]


# ---------------------------------------------------------------------------
# Fused substep
# ---------------------------------------------------------------------------


def substep(
    p: ParticleState,
    cfg: Config,
    domain: Domain,
    mouse_pos: jnp.ndarray,
    mouse_active: jnp.ndarray,
    spec: Optional[TileSpec] = None,
    preserve_order: bool = True,
) -> Tuple[ParticleState, GridState]:
    """One MLS-MPM substep on the tile-binned layout.

    Same physics as ops.transfer (p2g_1 2d_multi.rs:148-180, p2g_2 :182-238,
    update :240-250, g2p :252-359, incl. quirks Q2/Q3); only the data
    movement differs.  Matches the dense backend to f32 reduction-order
    tolerance (tests/test_tiled.py).

    ``preserve_order=False`` returns particles in tile-sorted order instead
    of the caller's, skipping the inverse-permutation scatter — physically
    identical (particle identity is just array values) and cheaper in frame
    loops that don't care about slot stability.
    """
    if spec is None:
        spec = default_spec(cfg, p.n)
    D = p.dim
    T, cap = spec.tile, spec.cap
    E = T + 2
    dtype = p.pos.dtype
    n = p.n

    b = bin_particles(p.pos, domain, spec)
    tshape, nt = _tile_geometry(domain, spec)
    A = b["n_active"]
    origin = jnp.asarray(domain.origin, jnp.int32)
    shape = jnp.asarray(domain.shape, jnp.int32)

    # ---- packed binned gather (ONE wide-row gather) ---------------------
    packed = jnp.concatenate(
        [p.pos, p.vel, p.C.reshape(n, D * D), p.mass[:, None]], axis=1
    )  # [N, F] with F = 2D + D^2 + 1
    F = packed.shape[1]
    binned = jnp.take(packed, b["bsrc"].ravel(), axis=0).reshape(A, cap, F)
    binned = jnp.swapaxes(binned, 1, 2)  # [A, F, cap] — cap minor
    bpos = binned[:, 0:D, :]
    bvel = binned[:, D : 2 * D, :]
    bC = binned[:, 2 * D : 2 * D + D * D, :].reshape(A, D, D, cap)
    bmass = jnp.where(b["valid"], binned[:, F - 1, :], 0.0)  # [A, cap]

    # ---- local geometry --------------------------------------------------
    tco = _unflatten(jnp.clip(b["tile_of_active"], 0, nt - 1), tshape)  # [A, D]
    bcell = jnp.clip(
        jnp.floor(bpos).astype(jnp.int32) - origin[None, :, None],
        0,
        (shape - 1)[None, :, None],
    )  # [A, D, cap]
    blc = jnp.clip(bcell - (tco * T)[:, :, None], 0, T - 1)
    dvec = bpos - (bcell + origin[None, :, None]).astype(dtype) - 0.5  # [A, D, cap]

    plain, moment = [], []
    for d in range(D):
        w3_d = _axis_weights(dvec[:, d, :])  # [A, 3, cap]
        pl, mo = _profiles_axis(blc[:, d, :], w3_d, E)
        plain.append(pl)
        moment.append(mo)

    # ---- p2g_1: mass + APIC momentum ------------------------------------
    # tap momentum value: m(v + C dpos_tap), dpos_tap = -dvec + (o-1);
    # the 1+D variant groups (plain + per-axis moment) run as ONE K-concat
    # contraction — a zero mass row aligns the moment groups' channels
    Cdv = jnp.einsum("aijs,ajs->ais", bC, dvec, precision=jax.lax.Precision.HIGHEST)  # [A, D, cap]
    Aval = bmass[:, None, :] * (bvel - Cdv)  # [A, D, cap]
    CH0 = 1 + D
    zrow = jnp.zeros((A, 1, cap), dtype)
    ch_groups = [jnp.concatenate([bmass[:, None, :], Aval], axis=1)]
    for d in range(D):
        Bd = bmass[:, None, :] * bC[:, :, d, :]  # [A, D, cap]
        ch_groups.append(jnp.concatenate([zrow, Bd], axis=1))
    dep = _deposit_merged(plain, moment, ch_groups)  # [A, E, CH0*E^{D-1}]

    # scatter active blocks into the dense per-tile array (wide rows — cheap)
    def to_dense_blocks(active_blocks, C):
        flat = active_blocks.reshape(A, -1)
        dense = jnp.zeros((nt + 1, flat.shape[1]), dtype)
        dense = dense.at[b["tile_of_active"]].add(flat, mode="drop")
        dense = dense[:nt].reshape((nt, E, C) + (E,) * (D - 1))
        # -> [nt, E, E, ..., C] (channels trailing, the tiling.py layout)
        perm = (0, 1) + tuple(range(3, 2 + D)) + (2,)
        return dense.transpose(perm)

    perm_in = (0, 1, 1 + D) + tuple(range(2, 1 + D))

    def to_active_blocks(dense_blocks, C):
        x = dense_blocks.transpose(perm_in)  # [nt, E, C, E...]
        x = x.reshape(nt, -1)
        x = jnp.concatenate([x, jnp.zeros((1, x.shape[1]), dtype)], axis=0)
        act = jnp.take(x, b["tile_of_active"], axis=0)
        return act.reshape(A, E, -1)

    # out-of-grid halo cells of boundary tiles read as 0 (the reference drops
    # those taps, 2d_multi.rs:165-167) — masked on the active blocks only
    emask_act = to_active_blocks(
        edge_mask(tshape, T, dtype)[..., None], 1
    )  # [A, E, E^{D-1}]

    def mask_act(act, C):
        x = act.reshape(A, E, C, -1)
        return (x * emask_act[:, :, None, :]).reshape(A, E, -1)

    # halo-complete the deposit blocks entirely in block space — no dense
    # grid round-trip in the hot loop (halo_sum == assemble+extract, tested)
    dense_dep = to_dense_blocks(dep, CH0)  # [nt, E..., 1+D]
    hs1 = halo_sum(dense_dep, tshape, T)
    act1 = mask_act(to_active_blocks(hs1, CH0), CH0)  # [A, E, CH0*E^{D-1}]
    act1_r = act1.reshape(A, E, CH0, -1)
    mact = act1_r[:, :, 0, :].reshape(A, E, -1)

    rho = _collect(plain, mact, 1)[:, 0, :]  # [A, cap]
    rho_pos = jnp.where(rho > 0.0, rho, 1.0)
    volume = jnp.where(rho > 0.0, bmass / rho_pos, 0.0)
    pressure = tait_pressure(
        rho, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power, cfg.pressure_floor
    )
    strain = bC + jnp.swapaxes(bC, 1, 2)
    eye = jnp.eye(D, dtype=dtype)[None, :, :, None]
    stress = -pressure[:, None, None, :] * eye + cfg.dynamic_viscosity * strain
    term = (-4.0 * cfg.dt) * volume[:, None, None, :] * stress  # [A, D, D, cap]

    A2 = -jnp.einsum("aijs,ajs->ais", term, dvec, precision=jax.lax.Precision.HIGHEST)  # [A, D, cap]
    dep2 = _deposit_merged(
        plain, moment, [A2] + [term[:, :, d, :] for d in range(D)]
    )
    dense_dep2 = to_dense_blocks(dep2, D)
    hs2 = halo_sum(dense_dep2, tshape, T)
    act2 = mask_act(to_active_blocks(hs2, D), D).reshape(A, E, D, -1)

    # ---- grid update (on active blocks only; halo replicas consistent) --
    g = jnp.asarray(cfg.gravity, dtype)
    m_b = act1_r[:, :, 0:1, :]  # [A, E, 1, F]
    mom_b = act1_r[:, :, 1:, :] + act2  # [A, E, D, F]
    v_b = jnp.where(
        m_b > 0.0,
        mom_b / jnp.where(m_b > 0.0, m_b, 1.0) + cfg.dt * g[None, None, :, None],
        0.0,
    )

    # ---- g2p ------------------------------------------------------------
    vact = v_b.reshape(A, E, -1)
    collected = _collect_all_variants(plain, moment, vact, D)
    v_slot = collected[0]  # [A, D, cap]
    B = v_slot[:, :, None, :] * (-dvec)[:, None, :, :]  # v_i * (-dvec_j)
    for d in range(D):
        B = B.at[:, :, d, :].add(collected[1 + d])  # sum_taps w (o_d-1) v_i
    newC = 4.0 * B
    newpos = bpos + v_slot * cfg.dt

    # mouse (quirk Q3) + clamp + soft wall (quirk Q2)
    plane = newpos[:, :2, :]
    dist = plane - mouse_pos[None, :, None]
    dist_sq = jnp.sum(dist * dist, axis=1)  # [A, cap]
    norm = jnp.sqrt(dist_sq)
    push2 = jnp.where(
        norm[:, None, :] > 0.0, dist / jnp.where(norm > 0.0, norm, 1.0)[:, None, :], 0.0
    )
    hit = mouse_active & (dist_sq < cfg.mouse_radius * cfg.mouse_radius)
    push = jnp.concatenate(
        [push2, jnp.zeros((A, D - 2, cap), dtype)], axis=1
    )
    newvel = v_slot + jnp.where(hit[:, None, :], push, 0.0)

    lo = jnp.asarray(cfg.boundary_clip[0], dtype)[None, :, None]
    hi = jnp.asarray(cfg.boundary_clip[1], dtype)[None, :, None]
    newpos = jnp.clip(newpos, lo, hi)
    nxt = newpos + newvel
    wall_min = lo + cfg.boundary_damp_dist
    wall_max = hi - cfg.boundary_damp_dist
    newvel = newvel + jnp.where(nxt < wall_min, wall_min - nxt, 0.0)
    newvel = newvel + jnp.where(nxt > wall_max, wall_max - nxt, 0.0)

    # ---- un-bin (ONE packed scatter back to original order) -------------
    out_packed = jnp.concatenate(
        [
            newpos,
            newvel,
            newC.reshape(A, D * D, cap),
            rho[:, None, :],
            pressure[:, None, :],
            jnp.where(b["valid"], binned[:, F - 1, :], 0.0)[:, None, :],  # mass
        ],
        axis=1,
    )  # [A, FO, cap]
    FO = out_packed.shape[1]
    out_flat = jnp.swapaxes(out_packed, 1, 2).reshape(A * cap, FO)

    ranks = jnp.arange(n, dtype=jnp.int32)
    start_at = jnp.take(b["start"][:-1], b["sid"])
    s_rank = ranks - start_at
    # active slot id for each sorted particle
    occ_rank = jnp.take(
        jnp.cumsum((b["start"][1:] - b["start"][:-1] > 0).astype(jnp.int32)) - 1,
        b["sid"],
    )
    slot = jnp.clip(occ_rank, 0, A - 1) * cap + jnp.clip(s_rank, 0, cap - 1)
    sorted_out = jnp.take(out_flat, slot, axis=0)  # [N, FO] packed gather

    if not spec.strict:
        fallback = jnp.concatenate(
            [p.pos, p.vel, p.C.reshape(n, D * D), p.density[:, None],
             p.pressure[:, None], p.mass[:, None]],
            axis=1,
        )
        fb_sorted = jnp.take(fallback, b["order"], axis=0)
        sorted_out = jnp.where(b["frozen"][:, None], fb_sorted, sorted_out)

    if preserve_order:
        unpacked = jnp.zeros_like(sorted_out)
        unpacked = unpacked.at[b["order"]].set(
            sorted_out, mode="promise_in_bounds", unique_indices=True
        )
        mass_out = p.mass
    else:
        unpacked = sorted_out  # tile-sorted order; mass travels in the pack
        mass_out = unpacked[:, FO - 1]

    out = ParticleState(
        pos=unpacked[:, 0:D],
        vel=unpacked[:, D : 2 * D],
        C=unpacked[:, 2 * D : 2 * D + D * D].reshape(n, D, D),
        mass=mass_out,
        density=unpacked[:, FO - 3],
        pressure=unpacked[:, FO - 2],
    )

    # Dense GridState for API/diagnostic parity — assembled from the pre-halo
    # deposit blocks; XLA dead-code-eliminates this whenever the caller
    # discards the grid (e.g. the frame loop), so the hot path never pays it.
    grid_all = assemble(dense_dep, tshape, T)  # [*shape, 1+D]
    grid_m = grid_all[..., 0]
    grid_mv = grid_all[..., 1:] + assemble(dense_dep2, tshape, T)
    m = grid_m[..., None]
    grid_v = jnp.where(m > 0.0, grid_mv / jnp.where(m > 0.0, m, 1.0) + cfg.dt * g, 0.0)
    grid = GridState(mass=grid_m, vel=grid_v)
    return out, grid


def overflow_count(pos: jnp.ndarray, domain: Domain, spec: TileSpec) -> jnp.ndarray:
    """Diagnostic: particles that would freeze (slot or active-budget
    overflow)."""
    b = bin_particles(pos, domain, spec)
    return b["frozen"].sum()
