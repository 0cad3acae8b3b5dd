"""Scene container: a mesh plus transmitters and receivers.

Reference parity: ``differt.geometry.Scene``
(differt/src/differt/geometry/_scene.py:305-1427).
"""

import dataclasses
import math
import warnings
from collections.abc import Iterator, Sequence  # noqa: F401 (Sequence: docstring types)
from os import PathLike
from typing import TYPE_CHECKING, Any, Literal

from differt_tpu import treekit as eqx
import jax
import jax.numpy as jnp
from .._typing import Array, ArrayLike, Float, Int

from ._mesh import Mesh

if TYPE_CHECKING:
    from ..rt._solvers import (
        AbstractPathLauncher,
        AbstractPathTracer,
    )
    from ._paths import LaunchedPaths, TracedPaths
    from ._candidates import SizedIterator


def _resolve_solver(solver, shortcuts: dict, options: dict):
    """Materialize a solver from a registered shortcut name or an instance.

    Shortcut names instantiate the registered solver class with ``options``;
    explicit instances must come fully configured (``options`` then conflict).
    """
    if isinstance(solver, str):
        cls = shortcuts.get(solver)
        if cls is None:
            known = ", ".join(sorted(shortcuts))
            msg = f"No solver is registered under {solver!r}; known shortcuts: {known}."
            raise ValueError(msg)
        return cls(**options)
    if options:
        msg = (
            f"Solver options {sorted(options)} conflict with an explicit solver"
            f" instance; configure the {type(solver).__name__} directly instead."
        )
        raise ValueError(msg)
    return solver


class Scene(eqx.Module):
    """A scene made of a triangle mesh, transmitters, and receivers.

    Examples:
        Trace the single ground bounce inside an open box:

        >>> import jax.numpy as jnp
        >>> from differt_tpu.geometry import Mesh, Scene
        >>> scene = Scene(
        ...     transmitters=jnp.array([[-2.0, 0.0, 1.0]]),
        ...     receivers=jnp.array([[2.0, 0.0, 1.0]]),
        ...     mesh=Mesh.plane(jnp.zeros(3), normal=jnp.array([0.0, 0.0, 1.0]), side_length=10.0),
        ... )
        >>> paths = scene.trace_paths(order=1)
        >>> paths.shape  # [num_tx, num_rx, num_candidates]
        (1, 1, 2)
        >>> int(paths.num_valid_paths)  # bounce on the diagonal: in both
        2
        >>> [round(v, 3) + 0.0 for v in paths.masked_vertices[0, 1].tolist()]
        [0.0, 0.0, 0.0]
    """

    transmitters: Float[Array, "*transmitters_batch 3"] = eqx.field(
        default_factory=lambda: jnp.empty((0, 3))
    )
    """Transmitter positions (arbitrary batch shape)."""
    receivers: Float[Array, "*receivers_batch 3"] = eqx.field(
        default_factory=lambda: jnp.empty((0, 3))
    )
    """Receiver positions (arbitrary batch shape)."""
    mesh: Mesh = eqx.field(default_factory=Mesh.empty)
    """The scene geometry."""

    @property
    def num_transmitters(self) -> int:
        """Total number of transmitters."""
        return math.prod(self.transmitters.shape[:-1])

    @property
    def num_receivers(self) -> int:
        """Total number of receivers."""
        return math.prod(self.receivers.shape[:-1])

    def set_assume_quads(self, flag: bool = True) -> "Scene":
        """Convenience wrapper for :meth:`Mesh.set_assume_quads`."""
        return eqx.tree_at(lambda s: s.mesh, self, self.mesh.set_assume_quads(flag))

    def with_transmitters_grid(
        self, m: int = 50, n: int | None = 50, *, height: Float[ArrayLike, ""] = 1.5
    ) -> "Scene":
        """Place an ``m x n`` grid of transmitters over the scene footprint."""
        return eqx.tree_at(
            lambda s: s.transmitters, self, self._grid(m, n, height=height)
        )

    def with_receivers_grid(
        self, m: int = 50, n: int | None = 50, *, height: Float[ArrayLike, ""] = 1.5
    ) -> "Scene":
        """Place an ``m x n`` grid of receivers over the scene footprint."""
        return eqx.tree_at(
            lambda s: s.receivers, self, self._grid(m, n, height=height)
        )

    def _grid(
        self, m: int, n: int | None, *, height: Float[ArrayLike, ""]
    ) -> Float[Array, "n m 3"]:
        if n is None:
            n = m
        dtype = self.mesh.vertices.dtype
        (min_x, min_y, _), (max_x, max_y, _) = self.mesh.bounding_box
        x, y = jnp.meshgrid(
            jnp.linspace(min_x, max_x, m, dtype=dtype),
            jnp.linspace(min_y, max_y, n, dtype=dtype),
        )
        return jnp.stack((x, y, jnp.full_like(x, height)), axis=-1)

    def rotate(self, rotation_matrix: Float[ArrayLike, "3 3"]) -> "Scene":
        """Rotate the whole scene."""
        rotation_matrix = jnp.asarray(rotation_matrix)
        return eqx.tree_at(
            lambda s: (s.transmitters, s.receivers, s.mesh),
            self,
            (
                jnp.matmul(
                    rotation_matrix, self.transmitters.reshape(-1, 3).T, precision=jax.lax.Precision.HIGHEST
                ).T.reshape(self.transmitters.shape),
                jnp.matmul(
                    rotation_matrix, self.receivers.reshape(-1, 3).T, precision=jax.lax.Precision.HIGHEST
                ).T.reshape(self.receivers.shape),
                self.mesh.rotate(rotation_matrix),
            ),
        )

    def scale(self, scale_factor: Float[ArrayLike, ""]) -> "Scene":
        """Scale the whole scene."""
        return eqx.tree_at(
            lambda s: (s.transmitters, s.receivers, s.mesh),
            self,
            (
                self.transmitters * scale_factor,
                self.receivers * scale_factor,
                self.mesh.scale(scale_factor),
            ),
        )

    def translate(self, translation: Float[ArrayLike, "3"]) -> "Scene":
        """Translate the whole scene."""
        translation = jnp.asarray(translation)
        return eqx.tree_at(
            lambda s: (s.transmitters, s.receivers, s.mesh),
            self,
            (
                self.transmitters + translation,
                self.receivers + translation,
                self.mesh.translate(translation),
            ),
        )

    @classmethod
    def load_xml(cls, file: str | PathLike[str]) -> "Scene":
        """Load a Mitsuba/Sionna XML scene (meshes, materials, colors)."""
        from ..io import load_scene_xml

        return cls(mesh=load_scene_xml(file))

    def _batched(self, paths, trailing: int):
        """Reshape flat solver output to ``[*tx_batch, *rx_batch, trailing]``."""
        return paths.reshape(
            *self.transmitters.shape[:-1], *self.receivers.shape[:-1], trailing
        )

    def trace_paths(
        self,
        order: "int | Sequence[int] | None" = None,
        *,
        solver: "AbstractPathTracer | Literal['exhaustive', 'hybrid']" = "exhaustive",
        path_candidates: Int[ArrayLike, "num_path_candidates order"] | None = None,
        merge_orders: bool = False,
        **solver_kwargs: Any,
    ) -> "TracedPaths | SizedIterator[TracedPaths] | Iterator[TracedPaths]":
        """Trace exact paths between all TX/RX pairs.

        Feature parity: reference ``Scene.trace_paths`` (_scene.py:650-764) —
        solver shortcuts, chunked iteration, and a user-supplied
        ``path_candidates`` bypass. Fully on device (no Warp).

        A sequence of orders yields one :class:`TracedPaths` per order (the
        reference raises ``NotImplementedError`` for this, _scene.py:704-708);
        the result plugs into :func:`differt_tpu.plugins.deepmimo.export`.
        With ``merge_orders=True``, the per-order batches are instead padded
        to the highest order and merged into ONE static-shape
        :class:`TracedPaths` (:func:`differt_tpu.geometry.concatenate_paths`)
        — each order still compiles its own fixed-width trace program.
        """
        from ..rt._solvers import (
            ExhaustivePathTracer,
            HybridPathTracer,
        )
        from ._candidates import SizedIterator

        if order is None and path_candidates is None:
            msg = "trace_paths needs a path 'order' or explicit 'path_candidates'."
            raise ValueError(msg)
        if order is not None and path_candidates is not None:
            msg = "'order' and 'path_candidates' are mutually exclusive; pass only one."
            raise ValueError(msg)

        if order is not None and not isinstance(order, int):
            # A sequence of orders fans out into one traced batch per order.
            from ._paths import TracedPaths, concatenate_paths

            orders = list(order)

            def per_order() -> Iterator:
                for o in orders:
                    result = self.trace_paths(o, solver=solver, **solver_kwargs)
                    if isinstance(result, TracedPaths):
                        yield result
                    else:
                        yield from result

            if merge_orders:
                return concatenate_paths(list(per_order()))
            chunked = solver_kwargs.get("chunk_size") or getattr(
                solver, "chunk_size", None
            )
            if chunked:
                return per_order()
            return SizedIterator(per_order(), size=len(orders))

        tracer = _resolve_solver(
            solver,
            {"exhaustive": ExhaustivePathTracer, "hybrid": HybridPathTracer},
            solver_kwargs,
        )

        if isinstance(tracer, HybridPathTracer):
            if order is None:
                msg = (
                    "The hybrid tracer prunes candidates by TX/RX visibility"
                    " and therefore needs an explicit 'order'."
                )
                raise ValueError(msg)
            if getattr(tracer, "smoothing_factor", None) is not None:
                warnings.warn(
                    "The hybrid tracer's visibility pruning is hard (non-"
                    "differentiable); its 'smoothing_factor' has no effect.",
                    UserWarning,
                    stacklevel=2,
                )

        if path_candidates is not None:
            if getattr(tracer, "chunk_size", None):
                warnings.warn(
                    "Explicit 'path_candidates' bypass candidate generation,"
                    " so 'chunk_size' has no effect.",
                    UserWarning,
                    stacklevel=2,
                )
                tracer = dataclasses.replace(tracer, chunk_size=None)
            candidates = jnp.asarray(path_candidates)
            if self.mesh.assume_quads:
                # Quad candidates address the even (first) triangle of a pair.
                candidates = candidates & ~1
            types = jnp.zeros(candidates.shape, dtype=jnp.int32)
            return self._batched(
                tracer.trace_path_candidates(self, candidates, types),
                candidates.shape[0],
            )

        chunk_size = getattr(tracer, "chunk_size", None)
        if chunk_size is not None:
            chunks = tracer.generate_path_candidates_chunks_iter(
                self, order, chunk_size=chunk_size
            )
            traced: Iterator = (
                self._batched(
                    tracer.trace_path_candidates(self, cands, types),
                    cands.shape[0],
                )
                for cands, types in chunks
            )
            num_chunks = getattr(chunks, "__len__", None)
            if num_chunks is None:
                return traced
            return SizedIterator(traced, size=num_chunks)

        candidates, types = tracer.generate_path_candidates(self, order)
        return self._batched(
            tracer.trace_path_candidates(self, candidates, types),
            candidates.shape[0],
        )

    def launch_paths(
        self,
        order: int | None = None,
        *,
        solver: "AbstractPathLauncher | Literal['sbr']" = "sbr",
        **solver_kwargs: Any,
    ) -> "LaunchedPaths":
        """Launch SBR paths and capture those passing near receivers.

        Feature parity: reference ``Scene.launch_paths`` (_scene.py:783-835).
        """
        from ..rt._solvers import SBRPathLauncher

        if order is None:
            msg = "launch_paths needs a maximum bounce 'order'."
            raise ValueError(msg)
        launcher = _resolve_solver(solver, {"sbr": SBRPathLauncher}, solver_kwargs)
        return self._batched(launcher.launch_paths(self, order=order), -1)

    @classmethod
    def from_mitsuba(cls, mi_scene) -> "Scene":
        """Build a scene from a loaded Mitsuba scene object.

        Requires the optional ``mitsuba`` package.
        Reference parity: _scene.py:510-548.
        """
        import mitsuba as mi
        import numpy as np

        mesh = Mesh.empty()
        params = mi.traverse(mi_scene)
        shapes = [
            key.removesuffix(".vertex_positions")
            for key in params.keys()
            if key.endswith(".vertex_positions")
        ]
        for shape in shapes:
            vertices = jnp.asarray(
                np.asarray(params[f"{shape}.vertex_positions"]).reshape(-1, 3)
            )
            triangles = jnp.asarray(
                np.asarray(params[f"{shape}.faces"]).reshape(-1, 3).astype(np.int32)
            )
            mesh = mesh + Mesh(vertices=vertices, triangles=triangles)
        return cls(mesh=mesh)

    @classmethod
    def from_sionna(cls, sionna_scene) -> "Scene":
        """Build a scene from a loaded Sionna RT scene object.

        Requires the optional ``sionna`` package.
        Reference parity: _scene.py:550-590.
        """
        return cls.from_mitsuba(sionna_scene.mi_scene)

    def compute_paths(
        self,
        order: int | None = None,
        *,
        method: Literal["exhaustive", "hybrid", "sbr"] = "exhaustive",
        **kwargs: Any,
    ):
        """Deprecated alias dispatching to :meth:`trace_paths` / :meth:`launch_paths`.

        .. deprecated::
            Use :meth:`trace_paths` (method='exhaustive'/'hybrid') or
            :meth:`launch_paths` (method='sbr') instead.
            Reference parity: _scene.py:1046-1248.
        """
        warnings.warn(
            "compute_paths is deprecated, use trace_paths or launch_paths instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        if method == "sbr":
            return self.launch_paths(order, solver="sbr", **kwargs)
        return self.trace_paths(order, solver=method, **kwargs)

    def trace_diffraction_paths(self, **solver_kwargs: Any):
        """Trace first-order diffraction paths over all mesh edges.

        See :class:`differt_tpu.rt.DiffractionPathTracer`. This extends the
        reference, which extracts diffraction edges but has no diffraction
        solver.
        """
        from ..rt._diffraction import DiffractionPathTracer

        return DiffractionPathTracer(**solver_kwargs).trace_paths(self)

    def trace_mixed_paths(self, interactions, **solver_kwargs: Any):
        """Trace paths matching a mixed interaction-type signature.

        ``interactions`` is a sequence of :class:`InteractionType` values,
        e.g. ``(REFLECTION, DIFFRACTION)``. See
        :class:`differt_tpu.rt.MixedPathTracer`. This extends the reference,
        which has no mixed reflection/diffraction solver.
        """
        from ..rt._mixed import MixedPathTracer

        return MixedPathTracer(**solver_kwargs).trace_paths(self, interactions)

    def trace_scattering_paths(self, **solver_kwargs: Any):
        """Trace single-bounce diffuse-scattering paths.

        See :class:`differt_tpu.rt.ScatteringPathTracer`. The reference
        accepts a ``diffuse_scattering`` flag but never implements it
        (_solvers.py accepts and ignores it); here scattering is a
        first-class solver + field model (Degli-Esposti effective
        roughness).
        """
        from ..rt._scattering import ScatteringPathTracer

        return ScatteringPathTracer(**solver_kwargs).trace_paths(self)

    def compute_tx_mlm(
        self,
        *,
        num_rays: int = int(1e4),
        order: int = 2,
        min_order: int = 0,
        receiver_plane_z: Float[ArrayLike, ""] = 0.0,
        grid_bounds: Float[ArrayLike, "2 2"] | None = None,
        grid_size: tuple[int, int] = (100, 100),
    ) -> Int[Array, "num_tx grid_m grid_n"]:
        """Multipath lifetime map (SBR coverage hash per grid cell).

        See :func:`differt_tpu.rt.compute_tx_mlm`; reference parity:
        _scene.py:1250-1371 (Warp kernel re-designed as pure XLA scatter).
        """
        from ..rt._mlm import compute_tx_mlm

        return compute_tx_mlm(
            self,
            num_rays=num_rays,
            order=order,
            min_order=min_order,
            receiver_plane_z=receiver_plane_z,
            grid_bounds=grid_bounds,
            grid_size=grid_size,
        )

    def plot(self, **kwargs: Any):
        """Plot the scene (mesh + TX/RX markers)."""
        from ..plotting import draw_markers, draw_mesh, reuse

        with reuse(**kwargs, pass_all_kwargs=True) as output:
            draw_mesh(self.mesh)
            if self.num_transmitters:
                draw_markers(self.transmitters.reshape(-1, 3), labels=["tx"])
            if self.num_receivers:
                draw_markers(self.receivers.reshape(-1, 3), labels=["rx"])
        return output


class TriangleScene(Scene):
    """Deprecated alias for :class:`Scene` (reference parity: _scene.py:1413-1426)."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        warnings.warn(
            "TriangleScene was renamed to Scene; this alias will be removed.",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(*args, **kwargs)
