"""ASCII density renderer — parity with the reference's ``draw``
(``2d_multi.rs:438-489`` / ``3d_multi.rs:461-512``).

Particles are binned into an 80x40 console grid (3D projects onto the xy
plane, ``3d_multi.rs:473``) and bin counts map onto the ASCII ramp
``' .-=*%$#'`` at thresholds 1..7 (``2d_multi.rs:465-474``).

Device/host split: the histogram is computed **on device** inside a jitted
scatter (so an interactive frame transfers only 80x40 ints to the host, not
N particle positions — SURVEY.md §7.3 hard part 5); the count->char mapping
is host-side string work.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .state import ParticleState

# Ramp thresholds 1..7 (2d_multi.rs:465-474): count<1 -> ' ', <2 -> '.', ...
RAMP = " .-=*%$#"

DEFAULT_VIEWPORT = (64.0, 64.0)  # 2d_multi.rs:515
DEFAULT_CONSOLE = (80, 40)  # 2d_multi.rs:516  (width, height)


@functools.partial(jax.jit, static_argnames=("console_size",))
def histogram(
    pos: jnp.ndarray,
    viewport_size: jnp.ndarray,
    console_size: Tuple[int, int] = DEFAULT_CONSOLE,
) -> jnp.ndarray:
    """Bin particle positions into an (H, W) int32 count grid on device.

    pos: [N, D]; only the first two components are used (xy projection in 3D,
    ``3d_multi.rs:473``).  Out-of-console particles are skipped
    (``2d_multi.rs:452-454``).
    """
    w, h = console_size
    xy = pos[..., :2]
    console = jnp.asarray([w, h], pos.dtype)
    cxy = jnp.floor(xy / viewport_size * console).astype(jnp.int32)  # [N, 2]
    valid = jnp.all((cxy >= 0) & (cxy < jnp.asarray([w, h])), axis=-1)
    cxy = jnp.clip(cxy, 0, jnp.asarray([w - 1, h - 1]))
    counts = jnp.zeros((h, w), jnp.int32)
    return counts.at[cxy[:, 1], cxy[:, 0]].add(valid.astype(jnp.int32))


def ascii_frame(counts: np.ndarray) -> list[str]:
    """Map an (H, W) count grid to console lines via the reference ramp."""
    counts = np.asarray(counts)
    idx = np.clip(counts, 0, len(RAMP) - 1)
    lut = np.array(list(RAMP))
    return ["".join(row) for row in lut[idx]]


def render(
    p: ParticleState,
    viewport_size=DEFAULT_VIEWPORT,
    console_size: Tuple[int, int] = DEFAULT_CONSOLE,
) -> list[str]:
    """Full render path: device histogram -> host ASCII lines."""
    counts = histogram(p.pos, jnp.asarray(viewport_size, jnp.float32), console_size)
    return ascii_frame(np.asarray(counts))
