"""Per-phase device timing — parity with the reference's instrumentation.

The reference wraps each of the five pipeline phases in ``Instant`` timers and
shows the **last** substep's durations under the sim view
(``2d_multi.rs:112-132,479-487``).  A fused XLA frame has no host-visible
phase boundaries, so ``PhaseTimer`` jits each phase separately and blocks on
the result — same labels (``clear`` is gone: zero-init fuses into the scatter
and costs nothing, SURVEY.md §5.1).

This path exists for the diagnostic overlay only; the production path is the
fused ``step.frame``.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import jax
import jax.numpy as jnp

from ..config import Config
from ..domain import Domain
from ..state import ParticleState
from ..step import _get_backend


class PhaseTimer:
    """Runs a frame phase-by-phase, reporting the last substep's times."""

    def __init__(self, cfg: Config, domain: Domain, backend: str = "dense"):
        self.cfg = cfg
        self.domain = domain
        ops = _get_backend(backend)
        if not hasattr(ops, "p2g_1"):
            # Fused backend (sorted/tiled): all phases run in one XLA
            # program, so the honest granularity is the whole substep.  The
            # simulation ALWAYS runs the requested backend — timing must never
            # change what is being simulated.
            self._fused = jax.jit(
                lambda p, mp, ma: ops.substep(p, cfg, domain, mp, ma)[0]
            )
            return
        self._fused = None
        self._p2g_1 = jax.jit(lambda p: ops.p2g_1(p, cfg, domain))
        self._p2g_2 = jax.jit(lambda p, g: ops.p2g_2(p, g, cfg, domain))
        self._update = jax.jit(lambda g: ops.grid_update(g, cfg))
        self._g2p = jax.jit(
            lambda p, g, mp, ma, rho, prs: ops.g2p(
                p, g, cfg, domain, mp, ma, rho, prs
            )
        )

    def frame(
        self, p: ParticleState, mouse_pos, mouse_active
    ) -> Tuple[ParticleState, List[Tuple[str, float]]]:
        times: List[Tuple[str, float]] = []
        if self._fused is not None:
            for _ in range(self.cfg.iterations):
                times.clear()
                t0 = time.perf_counter()
                p = jax.block_until_ready(self._fused(p, mouse_pos, mouse_active))
                times.append(("substep", time.perf_counter() - t0))
            return p, times
        for _ in range(self.cfg.iterations):
            times.clear()  # keep only the last substep (2d_multi.rs:112)

            t0 = time.perf_counter()
            grid = jax.block_until_ready(self._p2g_1(p))
            times.append(("p2g 1", time.perf_counter() - t0))

            t0 = time.perf_counter()
            grid, rho, prs = jax.block_until_ready(self._p2g_2(p, grid))
            times.append(("p2g 2", time.perf_counter() - t0))

            t0 = time.perf_counter()
            grid = jax.block_until_ready(self._update(grid))
            times.append(("update", time.perf_counter() - t0))

            t0 = time.perf_counter()
            p = jax.block_until_ready(
                self._g2p(p, grid, mouse_pos, mouse_active, rho, prs)
            )
            times.append(("g2p", time.perf_counter() - t0))
        return p, times
