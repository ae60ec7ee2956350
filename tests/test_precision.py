"""Every float32 contraction in the transfer backends pins
``Precision.HIGHEST``: on the GPU that keeps matrix products off TF32
(about three decimal digits), which the 1e-3 parity bars could not absorb."""

import jax
import pytest
from jax import lax
from jax.extend.core import ClosedJaxpr, Jaxpr

from fluid_tpu import scene, step
from fluid_tpu.config import default_2d, default_3d


def _dot_precisions(jaxpr):
    """Precision of every dot_general in ``jaxpr``, nested jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                if isinstance(sub, ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, Jaxpr):
                    out += _dot_precisions(sub)
    return out


@pytest.mark.parametrize("make", [default_2d, default_3d], ids=["2d", "3d"])
@pytest.mark.parametrize("backend", ["dense", "sorted", "tiled"])
def test_every_dot_general_is_highest(backend, make):
    cfg = make()
    p, dom = scene.dam_break(jax.random.key(0), cfg, n=64)
    mp, ma = step.no_mouse()
    jaxpr = jax.make_jaxpr(
        lambda q: step.substep(q, cfg, dom, mp, ma, backend=backend)[0]
    )(p)
    precs = _dot_precisions(jaxpr.jaxpr)
    assert precs, "no contraction found — the check would be vacuous"
    highest = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
    assert all(pr == highest for pr in precs), precs
