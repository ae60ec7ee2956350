"""fluid-tpu: an MLS-MPM/APIC weakly-compressible fluid framework in JAX,
run on an NVIDIA GPU.

Built from scratch in JAX/XLA with capability parity to the Rust
reference GossiperLoturot/fluid-rs (2D/3D dam-break, Tait EOS, viscosity,
APIC transfer, interactive TUI).  See SURVEY.md for the structural analysis
of the reference and the build plan.

Quick start::

    import jax
    from fluid_tpu import scene, step

    cfg, p, dom = scene.reference_scene_2d(seed=0)
    mp, ma = step.no_mouse()
    p = step.frame(p, cfg, dom, mp, ma)   # one 31-substep frame, one XLA program
"""

from .config import Config, default_2d, default_3d
from .domain import Domain, make_domain
from .state import GridState, ParticleState
from . import checkpoint, diagnostics, ops, render, scene, step

__version__ = "0.1.0"

__all__ = [
    "Config",
    "default_2d",
    "default_3d",
    "Domain",
    "make_domain",
    "GridState",
    "ParticleState",
    "checkpoint",
    "diagnostics",
    "ops",
    "render",
    "scene",
    "step",
]
