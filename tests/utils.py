"""Shared test fixtures: analytic oracles for path solvers.

The corridor oracle mirrors the reference's canonical test setup
(differt/tests/geometry/fixtures.py:82-117): two pairs of parallel mirrors
at y = +-1 between (0,0,0) and (1,0,0) — the unique 4-bounce specular path
hits y = +-1 at x = 1/8, 3/8, 5/8, 7/8.
"""

import jax
import jax.numpy as jnp
from differt_tpu._typing import Array, Float, PRNGKeyArray

from differt_tpu import treekit as tk


class PlanarMirrorsSetup(tk.Module):
    """A from/to vertex pair, ordered mirrors, and the known solution path."""

    from_vertices: Float[Array, "*batch 3"]
    to_vertices: Float[Array, "*batch 3"]
    mirror_vertices: Float[Array, "*batch num_mirrors 3"]
    mirror_normals: Float[Array, "*batch num_mirrors 3"]
    paths: Float[Array, "*batch num_mirrors 3"]

    def broadcast_to(self, *batch: int) -> "PlanarMirrorsSetup":
        num_mirrors = self.mirror_vertices.shape[-2]
        return PlanarMirrorsSetup(
            from_vertices=jnp.broadcast_to(self.from_vertices, (*batch, 3)),
            to_vertices=jnp.broadcast_to(self.to_vertices, (*batch, 3)),
            mirror_vertices=jnp.broadcast_to(
                self.mirror_vertices, (*batch, num_mirrors, 3)
            ),
            mirror_normals=jnp.broadcast_to(
                self.mirror_normals, (*batch, num_mirrors, 3)
            ),
            paths=jnp.broadcast_to(self.paths, (*batch, num_mirrors, 3)),
        )

    def add_noeffect_noise(
        self, scale: float = 1.0, *, key: PRNGKeyArray
    ) -> "PlanarMirrorsSetup":
        """Perturbations that must not change the solution.

        Mirror origins may shift within their plane (perpendicular to the
        normal) and normals may flip sign.
        """
        key_sign, key_shift = jax.random.split(key, 2)
        shift = jax.random.normal(key_shift, self.mirror_vertices.shape) * scale
        shift = (
            shift
            - jnp.sum(shift * self.mirror_normals, axis=-1, keepdims=True)
            * self.mirror_normals
        )
        sign = jax.random.choice(
            key_sign, jnp.array([1.0, -1.0]), shape=self.mirror_vertices.shape[:-1]
        )
        return PlanarMirrorsSetup(
            from_vertices=self.from_vertices,
            to_vertices=self.to_vertices,
            mirror_vertices=self.mirror_vertices + shift,
            mirror_normals=self.mirror_normals * sign[..., None],
            paths=self.paths,
        )


def corridor_setup() -> PlanarMirrorsSetup:
    """The 4-mirror corridor with a known analytic solution."""
    return PlanarMirrorsSetup(
        from_vertices=jnp.array([0.0, 0.0, 0.0]),
        to_vertices=jnp.array([1.0, 0.0, 0.0]),
        mirror_vertices=jnp.array([
            [0.0, +1.0, 0.0],
            [0.0, -1.0, 0.0],
            [0.0, +1.0, 0.0],
            [0.0, -1.0, 0.0],
        ]),
        mirror_normals=jnp.array([
            [0.0, -1.0, 0.0],
            [0.0, +1.0, 0.0],
            [0.0, -1.0, 0.0],
            [0.0, +1.0, 0.0],
        ]),
        paths=jnp.array([
            [1.0 / 8.0, +1.0, 0.0],
            [3.0 / 8.0, -1.0, 0.0],
            [5.0 / 8.0, +1.0, 0.0],
            [7.0 / 8.0, -1.0, 0.0],
        ]),
    )
