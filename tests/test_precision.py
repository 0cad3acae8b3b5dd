"""Float32 matrix products ask for full precision.

On a GPU an f32 product with default precision may run in TF32, which keeps
about three decimal digits. The geometry and EM products below ask for
``Precision.HIGHEST``; this reads each one's jaxpr and checks every
``dot_general`` in it.
"""

import jax
import jax.numpy as jnp
import pytest

from differt_tpu.em import sp_rotation_matrix, transition_matrix
from differt_tpu.geometry import Mesh, Scene
from differt_tpu.rt._fermat import _path_points

HIGHEST = jax.lax.Precision.HIGHEST


def dot_precisions(fn, *args) -> list:
    """The ``precision`` parameter of every dot_general traced from ``fn``."""
    found = []

    def walk(jaxpr) -> None:
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for value in eqn.params.values():
                subs = value if isinstance(value, (tuple, list)) else (value,)
                for sub in subs:
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


ROTATION = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
FRAME = jnp.eye(3)[None].repeat(4, axis=0)[:, :, :]

SITES = {
    "em.sp_rotation_matrix": lambda: dot_precisions(
        sp_rotation_matrix, FRAME[:, 0], FRAME[:, 1], FRAME[:, 1], FRAME[:, 2]
    ),
    "em.transition_matrix": lambda: dot_precisions(
        transition_matrix,
        jnp.array([[[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [2.0, 1.0, 0.0], [3.0, 0.0, 1.0]]]),
        jnp.array([[[0.0, 0.0, 1.0], [0.0, -1.0, 0.0]]]),
        jnp.array([[2.0 - 0.1j, 2.0 - 0.1j]], dtype=jnp.complex64),
        jnp.array([[-1.0, -1.0]]),
        jnp.array(0.1),
    ),
    "rt.fermat_path_points": lambda: dot_precisions(
        _path_points, jnp.ones((3, 2)), jnp.zeros((3, 3)), jnp.ones((3, 2, 3))
    ),
    "geometry.Mesh.rotate": lambda: dot_precisions(
        lambda r: Mesh.box(1.0, 1.0, 1.0).rotate(r).vertices, ROTATION
    ),
    "geometry.Mesh.plane": lambda: dot_precisions(
        lambda a: Mesh.plane(
            jnp.zeros(3), normal=jnp.array([0.0, 0.0, 1.0]), rotate=a
        ).vertices,
        jnp.array(0.3),
    ),
    "geometry.Scene.rotate": lambda: dot_precisions(
        lambda r: Scene(
            transmitters=jnp.zeros((2, 3)),
            receivers=jnp.ones((3, 3)),
            mesh=Mesh.box(1.0, 1.0, 1.0),
        )
        .rotate(r)
        .receivers,
        ROTATION,
    ),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_products_ask_for_highest_precision(site: str) -> None:
    precisions = SITES[site]()
    assert precisions, f"{site}: no dot_general traced"
    for precision in precisions:
        assert precision in ((HIGHEST, HIGHEST), HIGHEST), f"{site}: {precision}"
