"""Multi-device spatial domain decomposition (shard_map + collectives).

The reference's one "parallelism-shaped" structure is its chunked sparse
domain: particles keyed by chunk, a 1-chunk halo (``p_rect`` vs ``a_rect``,
``2d_multi.rs:79-87``), and ``swap_mul`` migration buffers
(``2d_multi.rs:327-358``) — an owner-computes + ghost-exchange pattern inside
one process (SURVEY.md §2.4, §5.7).  This module is its multi-device
scaling equivalent:

* the dense grid is split into x-slabs across a 1-D ``"space"`` mesh axis,
  each device holding its slab plus a 1-cell halo on each side (the stencil
  radius — the analog of ``p_rect``'s chunk halo);
* after local P2G scatters, halo contributions are **added** into their owning
  neighbor and completed edge cells are **copied** back into halos with
  ``lax.ppermute`` (4 thin slice exchanges per substep; NCCL on GPUs);
* particles crossing a slab boundary migrate via fixed-capacity emigrant
  buffers ppermuted to the neighbor (the ``swap_mul`` analog), landing in
  free slots of the neighbor's fixed-capacity array.

Everything is static-shaped: each device holds ``capacity`` particle slots
with an ``alive`` mask; dead slots carry zero mass and contribute nothing
(the P2G volume guard keeps them NaN-free).

Edge devices exchange with nobody (non-circular ppermute yields zeros), which
reproduces the reference's drop-out-of-grid-taps semantics at the global
boundary (``2d_multi.rs:165-167``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Config
from ..domain import Domain
from ..state import ParticleState
from ..ops.transfer import stencil_geometry_raw
from ..ops.eos import stress_tensor, tait_pressure

AXIS = "space"


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Static decomposition geometry (hashable => jit-static)."""

    domain: Domain
    n_shards: int
    capacity: int  # particle slots per device
    migrate_cap: int  # max emigrants per direction per substep

    def __post_init__(self):
        if self.n_shards > self.domain.shape[0]:
            raise ValueError(
                f"{self.n_shards} shards exceed grid x-extent {self.domain.shape[0]}"
            )

    @property
    def slab(self) -> int:
        """Owned cells along x per device (ceil — the conceptual grid is
        padded up to slab*n_shards; the pad region is never touched because
        particles are clamped well inside the real domain)."""
        return -(-self.domain.shape[0] // self.n_shards)

    @property
    def local_grid_shape(self) -> Tuple[int, ...]:
        return (self.slab + 2, *self.domain.shape[1:])


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LocalParticles:
    """Per-device fixed-capacity particle slots (leading axis sharded)."""

    p: ParticleState
    alive: jax.Array  # [cap] bool
    uid: jax.Array  # [cap] int32 — global particle id (test/gather support)


# ---------------------------------------------------------------------------
# Halo exchange helpers (run inside shard_map)
# ---------------------------------------------------------------------------


def _perm_left(s):  # send to lower device index
    return [(i, i - 1) for i in range(1, s)]


def _perm_right(s):  # send to higher device index
    return [(i, i + 1) for i in range(s - 1)]


def _exchange_add(arr: jnp.ndarray, slab: int, s: int) -> jnp.ndarray:
    """Fold halo-slice partial sums into the owning neighbor's edge cells."""
    from_right = lax.ppermute(arr[0:1], AXIS, _perm_left(s))  # neighbor's left halo
    from_left = lax.ppermute(arr[slab + 1 : slab + 2], AXIS, _perm_right(s))
    arr = arr.at[slab : slab + 1].add(from_right)
    arr = arr.at[1:2].add(from_left)
    return arr


def _exchange_fill(arr: jnp.ndarray, slab: int, s: int) -> jnp.ndarray:
    """Copy completed owned edge cells into the neighbors' halo slices."""
    from_right = lax.ppermute(arr[1:2], AXIS, _perm_left(s))  # their first owned
    from_left = lax.ppermute(arr[slab : slab + 1], AXIS, _perm_right(s))
    arr = arr.at[slab + 1 : slab + 2].set(from_right)
    arr = arr.at[0:1].set(from_left)
    return arr


# ---------------------------------------------------------------------------
# Local (per-device) substep
# ---------------------------------------------------------------------------


def _local_substep(
    lp: LocalParticles,
    cfg: Config,
    spec: ShardSpec,
    mouse_pos: jnp.ndarray,
    mouse_active: jnp.ndarray,
) -> LocalParticles:
    dom = spec.domain
    slab, s, dim = spec.slab, spec.n_shards, dom.dim
    my = lax.axis_index(AXIS)
    # This device's slab origin in cell coordinates (traced), minus the halo.
    x0 = my * slab  # grid-index space
    local_origin = jnp.asarray(dom.origin, jnp.int32).at[0].add(x0 - 1)
    lshape = spec.local_grid_shape

    p = lp.p
    mass_eff = jnp.where(lp.alive, p.mass, 0.0)

    idx, dpos, w, valid = stencil_geometry_raw(p.pos, local_origin, lshape)
    # Also drop taps outside the GLOBAL grid along non-sharded axes and at the
    # global x edges (the halo beyond the grid receives zeros anyway, but the
    # explicit mask keeps semantics identical to the dense path).
    w = jnp.where(valid, w, 0.0)

    coords = tuple(idx.reshape(-1, dim)[:, d] for d in range(dim))

    def scatter(grid, vals):
        vals = vals.reshape((len(coords[0]),) + vals.shape[idx.ndim - 1 :])
        return grid.at[coords].add(vals, mode="promise_in_bounds")

    def gather(grid):
        out = grid[coords]
        return out.reshape((p.pos.shape[0], 3**dim) + grid.shape[dim:])

    # ---- p2g_1 ----------------------------------------------------------
    mc = w * mass_eff[:, None]
    q = jnp.einsum("nij,nkj->nki", p.C, dpos, precision=jax.lax.Precision.HIGHEST)
    mom = mc[..., None] * (p.vel[:, None, :] + q)
    grid_m = scatter(jnp.zeros(lshape, p.pos.dtype), mc)
    grid_mv = scatter(jnp.zeros((*lshape, dim), p.pos.dtype), mom)

    # ---- halo: complete mass (add partials to owners, fill halos) -------
    grid_m = _exchange_add(grid_m, slab, s)
    grid_m = _exchange_fill(grid_m, slab, s)

    # ---- p2g_2 ----------------------------------------------------------
    density = jnp.sum(gather(grid_m) * w, axis=-1)
    pos_density = jnp.where(density > 0.0, density, 1.0)
    volume = jnp.where(density > 0.0, mass_eff / pos_density, 0.0)
    pressure = tait_pressure(
        density, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power, cfg.pressure_floor
    )
    stress = stress_tensor(p.C, pressure, cfg.dynamic_viscosity)
    term = (-4.0 * cfg.dt) * volume[:, None, None] * stress
    grid_mv = scatter(grid_mv, w[..., None] * jnp.einsum("nij,nkj->nki", term, dpos, precision=jax.lax.Precision.HIGHEST))

    # ---- halo: complete momentum; grid update; fill velocity halos ------
    grid_mv = _exchange_add(grid_mv, slab, s)
    g = jnp.asarray(cfg.gravity, p.pos.dtype)
    m = grid_m[..., None]
    grid_v = jnp.where(m > 0.0, grid_mv / jnp.where(m > 0.0, m, 1.0) + cfg.dt * g, 0.0)
    grid_v = _exchange_fill(grid_v, slab, s)

    # ---- g2p ------------------------------------------------------------
    wv = w[..., None] * gather(grid_v)
    vel = jnp.sum(wv, axis=1)
    C = 4.0 * jnp.einsum("nki,nkj->nij", wv, dpos, precision=jax.lax.Precision.HIGHEST)
    pos = p.pos + vel * cfg.dt

    plane = pos[..., :2]
    dist = plane - mouse_pos
    dist_sq = jnp.sum(dist * dist, axis=-1)
    norm = jnp.sqrt(dist_sq)
    push2 = jnp.where(
        norm[..., None] > 0.0, dist / jnp.where(norm > 0.0, norm, 1.0)[..., None], 0.0
    )
    hit = mouse_active & (dist_sq < cfg.mouse_radius * cfg.mouse_radius)
    push = jnp.zeros_like(vel).at[..., :2].set(push2)
    vel = vel + jnp.where(hit[..., None], push, 0.0)

    lo = jnp.asarray(cfg.boundary_clip[0], pos.dtype)
    hi = jnp.asarray(cfg.boundary_clip[1], pos.dtype)
    pos = jnp.clip(pos, lo, hi)
    nxt = pos + vel
    wall_min = lo + cfg.boundary_damp_dist
    wall_max = hi - cfg.boundary_damp_dist
    vel = vel + jnp.where(nxt < wall_min, wall_min - nxt, 0.0)
    vel = vel + jnp.where(nxt > wall_max, wall_max - nxt, 0.0)

    new_p = ParticleState(
        pos=pos, vel=vel, C=C, mass=p.mass, density=density, pressure=pressure
    )
    lp = LocalParticles(p=new_p, alive=lp.alive, uid=lp.uid)

    # ---- migration (the swap_mul analog, 2d_multi.rs:327-358) -----------
    return _migrate(lp, cfg, spec, my)


# ---------------------------------------------------------------------------
# Particle migration between neighboring slabs
# ---------------------------------------------------------------------------


def _tree_arrays(lp: LocalParticles):
    p = lp.p
    return (p.pos, p.vel, p.C, p.mass, p.density, p.pressure, lp.uid)


def _rebuild(lp: LocalParticles, arrays, alive) -> LocalParticles:
    pos, vel, C, mass, density, pressure, uid = arrays
    return LocalParticles(
        p=ParticleState(pos=pos, vel=vel, C=C, mass=mass, density=density, pressure=pressure),
        alive=alive,
        uid=uid,
    )


def _first_k_slots(mask: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Indices of the first k True entries of mask (stable), plus a validity
    mask for slots where fewer than k exist."""
    n = mask.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    prio = jnp.where(mask, iota, n)
    order = jnp.argsort(prio)[:k]
    sel_valid = jnp.take(mask, order)
    return order, sel_valid


def _migrate(lp: LocalParticles, cfg: Config, spec: ShardSpec, my) -> LocalParticles:
    """Lossless migration with receiver backpressure.

    The reference never deletes particles (quirk Q6, ``2d_multi.rs:302-306``,
    327-358), so neither may the sharded path — even when ``migrate_cap`` or
    the receiver's free slots are exhausted.  Protocol per substep:

    1. each device advertises to each neighbor how many immigrants it can
       accept this substep (its free slots, split between the two directions
       — one scalar ``ppermute`` each way);
    2. senders extract at most ``min(migrate_cap, budget)`` emigrants per
       direction; the REST STAY ALIVE at the sender (their stencil taps
       beyond the local halo are dropped for the substeps they wait — a
       bounded, conservative degradation instead of deletion);
    3. receivers place arrivals into free slots — guaranteed to fit by (1).
    """
    dom, slab, s, cap, mcap = (
        spec.domain,
        spec.slab,
        spec.n_shards,
        spec.capacity,
        spec.migrate_cap,
    )
    x0 = my * slab
    cx = jnp.floor(lp.p.pos[:, 0]).astype(jnp.int32) - dom.origin[0]
    go_left = lp.alive & (cx < x0)
    go_right = lp.alive & (cx >= x0 + slab)

    alive = lp.alive
    arrays = _tree_arrays(lp)

    # ---- 1. budget exchange ----------------------------------------------
    free_total = (cap - alive.sum()).astype(jnp.int32)
    budget_for_left_nbr = free_total // 2  # quota for arrivals from the left
    budget_for_right_nbr = free_total - free_total // 2
    # send each quota to the neighbor it applies to; senders receive the
    # budget their own emigrants are subject to (edge devices get 0 from the
    # non-circular ppermute — nothing to send off-grid anyway)
    budget_r = lax.ppermute(budget_for_left_nbr, AXIS, _perm_left(s))
    budget_l = lax.ppermute(budget_for_right_nbr, AXIS, _perm_right(s))

    def extract(mask, budget):
        sel, sel_valid = _first_k_slots(mask, mcap)
        rank = jnp.arange(mcap, dtype=jnp.int32)
        sel_valid = sel_valid & (rank < budget)  # backpressure: defer the rest
        em = tuple(jnp.take(a, sel, axis=0) for a in arrays)
        em = tuple(
            jnp.where(
                sel_valid.reshape((mcap,) + (1,) * (a.ndim - 1)), a, jnp.zeros_like(a)
            )
            for a in em
        )
        return sel, sel_valid, em

    # ---- 2. bounded extraction (deferred emigrants stay alive) ------------
    sel_l, val_l, em_l = extract(go_left, budget_l)
    sel_r, val_r, em_r = extract(go_right, budget_r)
    alive = alive.at[sel_l].set(alive[sel_l] & ~val_l)
    alive = alive.at[sel_r].set(alive[sel_r] & ~val_r)

    # ship emigrants (validity flag travels along)
    send_l = (*em_l, val_l)
    send_r = (*em_r, val_r)
    recv_from_right = lax.ppermute(send_l, AXIS, _perm_left(s))
    recv_from_left = lax.ppermute(send_r, AXIS, _perm_right(s))
    im_r, imv_r = recv_from_right[:-1], recv_from_right[-1]
    im_l, imv_l = recv_from_left[:-1], recv_from_left[-1]

    # ---- 3. placement (arrivals <= advertised budgets <= free slots) ------
    # left immigrants take the first free slots, right immigrants the next
    # ones after them (compacted, so both directions share the free pool)
    free, free_valid = _first_k_slots(~alive, 2 * mcap)
    n_l = imv_l.sum().astype(jnp.int32)
    slots_l = free[:mcap]
    idx_r = jnp.clip(n_l + jnp.arange(mcap, dtype=jnp.int32), 0, 2 * mcap - 1)
    slots_r = jnp.take(free, idx_r)
    ok_l = imv_l & free_valid[:mcap]
    ok_r = imv_r & jnp.take(free_valid, idx_r)

    new_arrays = []
    for a, il, ir in zip(arrays, im_l, im_r):
        expand = (slice(None),) + (None,) * (a.ndim - 1)
        a = a.at[slots_l].set(jnp.where(ok_l[expand], il, a[slots_l]))
        a = a.at[slots_r].set(jnp.where(ok_r[expand], ir, a[slots_r]))
        new_arrays.append(a)
    alive = alive.at[slots_l].set(alive[slots_l] | ok_l)
    alive = alive.at[slots_r].set(alive[slots_r] | ok_r)

    return _rebuild(lp, tuple(new_arrays), alive)


# ---------------------------------------------------------------------------
# Host-side shard construction / gathering
# ---------------------------------------------------------------------------


def default_spec(
    domain: Domain, n_shards: int, n_particles: int, capacity_factor: float = 6.0
) -> ShardSpec:
    """Static per-device capacity.  The factor covers spatial imbalance: a
    dam-break seed concentrates all particles in the few slabs under the seed
    box, so worst-slab occupancy far exceeds n/n_shards until the fluid
    spreads.  6x mean covers the reference scenes; pass a tighter factor for
    well-spread workloads (capacity is just memory — slots are masked)."""
    cap = int(np.ceil(n_particles / n_shards * capacity_factor))
    cap = max(cap, 8)
    mcap = max(cap // 4, 4)
    return ShardSpec(domain=domain, n_shards=n_shards, capacity=cap, migrate_cap=mcap)


def shard_particles(p: ParticleState, spec: ShardSpec, mesh: Mesh) -> LocalParticles:
    """Bin particles into their owner slabs and lay them out as global arrays
    with the leading axis sharded over the mesh's "space" axis."""
    dom, s, cap = spec.domain, spec.n_shards, spec.capacity
    pos = np.asarray(p.pos)
    n = pos.shape[0]
    cx = np.floor(pos[:, 0]).astype(np.int64) - dom.origin[0]
    owner = np.clip(cx // spec.slab, 0, s - 1)

    fields = {
        "pos": np.asarray(p.pos),
        "vel": np.asarray(p.vel),
        "C": np.asarray(p.C),
        "mass": np.asarray(p.mass),
        "density": np.asarray(p.density),
        "pressure": np.asarray(p.pressure),
    }
    out = {k: np.zeros((s * cap,) + v.shape[1:], v.dtype) for k, v in fields.items()}
    alive = np.zeros((s * cap,), bool)
    uid = np.full((s * cap,), -1, np.int32)
    for shard in range(s):
        ids = np.nonzero(owner == shard)[0]
        if len(ids) > cap:
            raise ValueError(
                f"shard {shard} holds {len(ids)} particles > capacity {cap}"
            )
        base = shard * cap
        for k, v in fields.items():
            out[k][base : base + len(ids)] = v[ids]
        alive[base : base + len(ids)] = True
        uid[base : base + len(ids)] = ids

    sharding = NamedSharding(mesh, P(AXIS))
    dev = {k: jax.device_put(v, sharding) for k, v in out.items()}
    return LocalParticles(
        p=ParticleState(**dev),
        alive=jax.device_put(alive, sharding),
        uid=jax.device_put(uid, sharding),
    )


def gather_particles(lp: LocalParticles, n: int) -> ParticleState:
    """Collect alive particles back into canonical uid order."""
    alive = np.asarray(lp.alive)
    uid = np.asarray(lp.uid)
    sel = np.nonzero(alive)[0]
    order = uid[sel]
    assert len(order) == n, f"expected {n} alive particles, found {len(order)}"
    out = {}
    for f in ("pos", "vel", "C", "mass", "density", "pressure"):
        a = np.asarray(getattr(lp.p, f))[sel]
        full = np.zeros((n,) + a.shape[1:], a.dtype)
        full[order] = a
        out[f] = jnp.asarray(full)
    return ParticleState(**out)


# ---------------------------------------------------------------------------
# Top-level sharded frame
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("cfg", "spec", "mesh", "substeps"), donate_argnames=("lp",)
)
def sharded_frame(
    lp: LocalParticles,
    cfg: Config,
    spec: ShardSpec,
    mesh: Mesh,
    mouse_pos: jnp.ndarray,
    mouse_active: jnp.ndarray,
    substeps: int | None = None,
) -> LocalParticles:
    """Run one frame (``cfg.iterations`` substeps) under shard_map over the
    "space" mesh axis — the multi-device analog of ``step.frame``."""
    n_sub = cfg.iterations if substeps is None else substeps

    def local_frame(lp, mouse_pos, mouse_active):
        def body(_, lp):
            return _local_substep(lp, cfg, spec, mouse_pos, mouse_active)

        return lax.fori_loop(0, n_sub, body, lp)

    fn = jax.shard_map(
        local_frame,
        mesh=mesh,
        in_specs=(P(AXIS), P(), P()),
        out_specs=P(AXIS),
    )
    return fn(lp, mouse_pos, mouse_active)
