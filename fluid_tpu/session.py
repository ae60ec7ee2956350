"""Persistent-state frame driver — the library's interactive loop.

The reference keeps its ``Simulation`` alive across frames
(``3d_multi.rs:541-563`` re-uses it every iteration of the main loop).
``Session`` is that object: the app, the bench and library users all drive
frames through it.  It holds the particle state on the device between
frames, donates it to each frame program (in-place update), and renders the
console histogram on the device, so an interactive frame transfers only the
80x40 count grid to the host.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from . import step
from .config import Config
from .domain import Domain
from .state import ParticleState


def default_backend() -> str:
    """The transfer backend a ``Session`` uses when none is named: the dense
    reference, on every device.  Choosing by problem size needs measured
    costs per backend on the card."""
    return "dense"


class Session:
    """Holds simulation state across frames (``Simulation`` analog).

    Parameters
    ----------
    cfg, domain : static simulation setup (``Simulation::new`` + ``set_rect``)
    p : initial particles (``add_particle`` loop, ``2d_multi.rs:502-512``)
    backend : transfer backend (see ``step``); None -> ``default_backend()``
    """

    def __init__(
        self,
        cfg: Config,
        domain: Domain,
        p: ParticleState,
        backend: Optional[str] = None,
    ):
        self.cfg = cfg
        self.domain = domain
        self.backend = backend or default_backend()
        step._get_backend(self.backend)  # reject unknown names up front
        self.n = p.n
        self.dim = p.dim
        self._p = p
        self._frames = 0
        self._run_fns = {}  # frames -> jitted (or AOT-compiled) k-frame program

    # -- frame loop ---------------------------------------------------------

    def _run_fn(self, frames: int):
        """The ``frames``-frame program (cached per k): one device dispatch
        for the whole span, state donated."""
        fn = self._run_fns.get(frames)
        if fn is None:
            cfg, domain, backend = self.cfg, self.domain, self.backend

            @functools.partial(jax.jit, donate_argnums=0)
            def _run(p, mp, ma):
                return jax.lax.fori_loop(
                    0, frames,
                    lambda _, q: step.frame_body(q, cfg, domain, mp, ma, backend),
                    p,
                )

            fn = _run
            self._run_fns[frames] = fn
        return fn

    def compile_run(self, frames: int):
        """AOT-compile the ``frames``-frame program without executing it, so
        a timed ``run`` excludes compilation.  ``run`` then uses the compiled
        executable.  Returns it (``memory_analysis()``, ``cost_analysis()``)."""
        compiled = (
            self._run_fn(frames).lower(self._p, *step.no_mouse()).compile()
        )
        self._run_fns[frames] = compiled
        return compiled

    def run(self, frames: int, mouse: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None) -> None:
        """Advance ``frames`` frames in ONE device program.  ``mouse``
        applies to every frame in the span."""
        mp, ma = mouse if mouse is not None else step.no_mouse()
        self._p = self._run_fn(frames)(self._p, mp, ma)
        self._frames += frames

    def frame(self, mouse: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None) -> None:
        """Advance one frame (``cfg.iterations`` substeps) on device."""
        self.run(1, mouse)

    def block_until_ready(self) -> None:
        leaves = jax.tree_util.tree_leaves(self._p)
        jax.block_until_ready(leaves)
        float(leaves[0].ravel()[0])  # real fetch — surfaces device faults

    # -- state snapshot -----------------------------------------------------

    def snapshot(self):
        """Deep-copy the live simulation state (device buffers).

        With ``restore`` a caller replays the same frame span through the
        already-compiled program (warm-up without moving the measured
        span).  The replay is bit-identical where the scatters sum in a fixed
        order (the CPU); on a GPU they are atomics, so a replay agrees only
        to floating-point reordering."""
        return (self._frames, jax.tree.map(lambda a: a.copy(), self._p))

    def restore(self, snap) -> None:
        """Reset to a ``snapshot()``.  Copies again so the snapshot survives
        repeated restores (``run`` donates the state buffers)."""
        frames, src = snap
        self._p = jax.tree.map(lambda a: a.copy(), src)
        self._frames = frames

    # -- state access -------------------------------------------------------

    def particles(self) -> ParticleState:
        """Current particle state.  The arrays are donated to the next
        frame program, so copy them to keep them past ``frame``/``run``."""
        return self._p

    def histogram(self, viewport_size, console_size) -> jnp.ndarray:
        """(H, W) int32 console count grid, computed on the device."""
        from . import render as render_mod

        return render_mod.histogram(
            self._p.pos, jnp.asarray(viewport_size, jnp.float32), tuple(console_size)
        )

    def render(self, viewport_size, console_size) -> list:
        from . import render as render_mod
        import numpy as np

        return render_mod.ascii_frame(
            np.asarray(self.histogram(viewport_size, console_size))
        )
