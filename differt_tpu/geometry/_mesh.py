"""Triangle mesh container (immutable JAX pytree).

Reference parity: ``differt.geometry.Mesh``
(differt/src/differt/geometry/_mesh.py:612-3254). Unlike the reference,
whose accelerated ray-cast methods bridge into NVIDIA Warp CUDA kernels via
host callbacks, every accelerated method here runs natively on device:
Pallas kernels on a GPU, with the pure-JAX tiled kernels of
:mod:`differt_tpu.rt` as the portable backend.
"""

import warnings
from collections.abc import Iterator
from os import PathLike
from typing import Any

from differt_tpu import treekit as eqx
import jax
import jax.numpy as jnp
from .._typing import Array, ArrayLike, Bool, Float, Int, PRNGKeyArray

from ._vectors import normalize, orthogonal_basis, rotation_matrix_along_axis


_AT_KWARGS = {"mode": "drop", "wrap_negative_indices": False}


def _warn_non_manifold_edges(count) -> None:
    """Host-side warning hook for :meth:`Mesh._connectivity`."""
    count = int(count)
    if count:
        warnings.warn(
            f"Mesh contains {count} non-manifold edge(s): more than two"
            " faces share the same pair of vertices. These edges are"
            " excluded from diffraction-edge extraction.",
            UserWarning,
            stacklevel=2,
        )


class _VertexSelection:
    """Out-of-place, differentiable vertex edits for a triangle selection.

    Obtained through ``mesh.at[selection]``; every update builds a new
    :class:`Mesh`. Triangle selections resolve to *vertex* ids through a
    sort-free first-occurrence dedup (a scatter-min race over slot
    positions), so vertices shared between selected triangles receive
    exactly one update — required for accumulating updates like ``add`` to
    be well defined — without the sorted ``jnp.unique`` the reference
    relies on (_mesh.py:447-451), whose sort XLA cannot avoid.
    """

    __slots__ = ("_mesh", "_selection")

    def __init__(self, mesh: "Mesh", selection) -> None:
        if not isinstance(selection, slice):
            sel = jnp.asarray(selection)
            if sel.ndim > 1:
                msg = (
                    "Triangle selections must be scalars, slices, or 1-D"
                    f" arrays; got a {sel.ndim}-D array of shape {sel.shape}."
                )
                raise ValueError(msg)
        self._mesh = mesh
        self._selection = selection

    def __repr__(self) -> str:
        return f"{type(self._mesh).__name__}.at[{self._selection!r}]"

    def _corner_ids(self, **kwargs: Any):
        """Vertex ids of the selected triangles' corners (with duplicates)."""
        return self._mesh.triangles.at[self._selection, :].get(**kwargs).reshape(-1)

    def _unique_vertex_ids(self, **kwargs: Any):
        ids = self._corner_ids(**kwargs)
        num_vertices = self._mesh.vertices.shape[0]
        slots = jnp.arange(ids.shape[0], dtype=jnp.int32)
        guarded = jnp.where((ids >= 0) & (ids < num_vertices), ids, num_vertices)
        # Every slot races for its vertex id; the smallest slot wins and
        # keeps the id, losers are parked out of range (dropped on scatter).
        winner = (
            jnp.full(num_vertices + 1, ids.shape[0], dtype=jnp.int32)
            .at[guarded]
            .min(slots, mode="drop")
        )
        return jnp.where(winner[guarded] == slots, guarded, num_vertices)

    def get(self, **kwargs: Any):
        """Gather the selected triangles' corner coordinates (flattened)."""
        ids = self._corner_ids(**kwargs)
        return self._mesh.vertices.at[ids, :].get(wrap_negative_indices=False)

    def _edited(self, scatter_op: str, operand, **kwargs: Any) -> "Mesh":
        ids = self._unique_vertex_ids(**kwargs)
        rows = self._mesh.vertices.at[ids, :]
        return eqx.tree_at(
            lambda m: m.vertices,
            self._mesh,
            getattr(rows, scatter_op)(operand, **_AT_KWARGS),
        )

    def apply(self, func, **kwargs: Any) -> "Mesh":
        """Apply ``func`` to each selected vertex row (shared rows once)."""
        return self._edited("apply", func, **kwargs)


def _install_vertex_update_ops() -> None:
    """Attach the jnp-scatter-backed update methods to _VertexSelection."""

    def make(name: str, scatter_op: str):
        def update(self: _VertexSelection, values, **kwargs: Any) -> "Mesh":
            return self._edited(scatter_op, values, **kwargs)

        update.__name__ = name
        update.__qualname__ = f"_VertexSelection.{name}"
        update.__doc__ = (
            f"Return a new mesh with ``{scatter_op}`` applied to the"
            " selected triangles' vertices (shared vertices updated once)."
        )
        return update

    for name, scatter_op in (
        ("set", "set"),
        ("add", "add"),
        ("sub", "subtract"),
        ("mul", "multiply"),
        ("div", "divide"),
        ("pow", "power"),
        ("min", "min"),
        ("max", "max"),
    ):
        setattr(_VertexSelection, name, make(name, scatter_op))


_install_vertex_update_ops()


class _VertexUpdates:
    """Indexable entry point for :attr:`Mesh.at`."""

    __slots__ = ("_mesh",)

    def __init__(self, mesh: "Mesh") -> None:
        self._mesh = mesh

    def __getitem__(self, selection) -> _VertexSelection:
        return _VertexSelection(self._mesh, selection)

    def __repr__(self) -> str:
        return f"{type(self._mesh).__name__}.at"


class Mesh(eqx.Module):
    """A triangle mesh with optional colors, materials, sub-objects and mask."""

    vertices: Float[Array, "num_vertices 3"]
    """Vertex coordinates."""
    triangles: Int[Array, "num_triangles 3"]
    """Per-triangle vertex indices."""
    face_colors: Float[Array, "num_triangles 3"] | None = eqx.field(default=None)
    """Optional per-face RGB colors."""
    face_materials: Int[Array, " num_triangles"] | None = eqx.field(default=None)
    """Optional per-face material indices into :attr:`material_names` (-1 = unset)."""
    material_names: tuple[str, ...] = eqx.field(default_factory=tuple, static=True)
    """Unique material names."""
    object_bounds: Int[Array, "num_objects 2"] | None = eqx.field(default=None)
    """Start/end triangle indices of each sub-object (sorted, covering)."""
    assume_quads: bool = eqx.field(default=False, static=True)
    """If set, each two consecutive triangles form a quadrilateral primitive."""
    assume_unique_vertices: bool = eqx.field(default=False, static=True)
    """If set, vertices are assumed deduplicated (edge connectivity relies on it)."""
    mask: Bool[Array, " num_triangles"] | None = eqx.field(default=None)
    """Optional fixed-shape active-triangle mask (JIT-stable sub-meshes)."""

    def __check_init__(self) -> None:
        if self.assume_quads and (self.triangles.shape[0] % 2) != 0:
            msg = (
                "'assume_quads' needs an even triangle count (each quad is a"
                f" triangle pair), but this mesh has {self.triangles.shape[0]}."
            )
            raise ValueError(msg)
        if len(set(self.material_names)) != len(self.material_names):
            msg = f"Duplicate entries in material_names: {self.material_names!r}."
            raise ValueError(msg)

    # -- Sizes ------------------------------------------------------------

    @property
    def num_triangles(self) -> int:
        """Triangle count (including masked-out ones)."""
        return self.triangles.shape[0]

    @property
    def num_active_triangles(self) -> int | Int[Array, ""]:
        """Number of active triangles (traceable if :attr:`mask` is set)."""
        return jnp.sum(self.mask) if self.mask is not None else self.num_triangles

    @property
    def num_quads(self) -> int:
        """The number of quadrilaterals (requires :attr:`assume_quads`)."""
        if not self.assume_quads:
            msg = "num_quads is only defined when 'assume_quads' is enabled."
            raise ValueError(msg)
        return self.triangles.shape[0] // 2

    @property
    def num_active_quads(self) -> int | Int[Array, ""]:
        """Number of active quads (traceable if :attr:`mask` is set)."""
        if not self.assume_quads:
            msg = "num_active_quads is only defined when 'assume_quads' is enabled."
            raise ValueError(msg)
        return jnp.sum(self.mask[::2]) if self.mask is not None else self.num_quads

    @property
    def num_primitives(self) -> int:
        """Quads if :attr:`assume_quads` else triangles."""
        return self.num_quads if self.assume_quads else self.num_triangles

    @property
    def num_active_primitives(self) -> int | Int[Array, ""]:
        """Active primitive count (traceable if :attr:`mask` is set)."""
        return self.num_active_quads if self.assume_quads else self.num_active_triangles

    @property
    def num_objects(self) -> int:
        """Number of sub-objects (1 if no :attr:`object_bounds`)."""
        return self.object_bounds.shape[0] if self.object_bounds is not None else 1

    @property
    def is_empty(self) -> bool:
        """Whether this mesh has no triangle."""
        return self.triangles.size == 0

    # -- Derived geometry --------------------------------------------------

    @property
    def triangle_vertices(self) -> Float[Array, "num_triangles 3 3"]:
        """Gathered per-triangle vertex coordinates."""
        if self.triangles.size == 0:
            return jnp.empty_like(self.vertices, shape=(0, 3, 3))
        return jnp.take(self.vertices, self.triangles, axis=0)

    @property
    def normals(self) -> Float[Array, "num_triangles 3"]:
        """Unit triangle normals (computed, hence differentiable w.r.t. vertices)."""
        tv = self.triangle_vertices
        edges = jnp.diff(tv, axis=1)
        return normalize(jnp.cross(edges[:, 0, :], edges[:, 1, :]))[0]

    @property
    def triangle_edges(self) -> Float[Array, "num_triangles 3 2 3"]:
        """Per-triangle edges as (start, end) vertex pairs."""
        tv = self.triangle_vertices
        return jnp.stack((tv, jnp.roll(tv, 1, axis=-2)), axis=-2)

    @property
    def bounding_box(self) -> Float[Array, "2 3"]:
        """Axis-aligned bounding box (min and max corners)."""
        return jnp.vstack((
            jnp.min(self.vertices, axis=0),
            jnp.max(self.vertices, axis=0),
        ))

    # -- Flag setters ------------------------------------------------------

    def set_assume_quads(self, flag: bool = True) -> "Mesh":
        """Return a copy with :attr:`assume_quads` set (with runtime checks)."""
        mesh = eqx.tree_at(lambda m: m.assume_quads, self, flag)
        mesh.__check_init__()
        return mesh

    def set_assume_unique_vertices(self, flag: bool = True) -> "Mesh":
        """Return a copy with :attr:`assume_unique_vertices` set."""
        return eqx.tree_at(lambda m: m.assume_unique_vertices, self, flag)

    def set_mask(self, mask: Bool[ArrayLike, " num_triangles"] | None) -> "Mesh":
        """Return a copy with the active-triangle mask replaced."""
        return eqx.tree_at(
            lambda m: m.mask, self, jnp.asarray(mask) if mask is not None else None,
            is_leaf=lambda x: x is None,
        )

    # -- Colors and materials ---------------------------------------------

    def set_face_colors(
        self,
        colors: Float[ArrayLike, "#num_triangles 3"] | Float[ArrayLike, "3"] | None = None,
        *,
        key: PRNGKeyArray | None = None,
    ) -> "Mesh":
        """Return a copy with face colors set (or randomized per object).

        Reference parity: _mesh.py:1770-1936.
        """
        if (colors is None) == (key is None):
            msg = "You must specify one of 'colors' or 'key', not both."
            raise ValueError(msg)
        if key is not None:
            if self.object_bounds is not None:
                num_objects = self.object_bounds.shape[0]
                object_colors = jax.random.uniform(key, (num_objects, 3))
                counts = self.object_bounds[:, 1] - self.object_bounds[:, 0]
                colors = jnp.repeat(
                    object_colors, counts, axis=0, total_repeat_length=self.num_triangles
                )
            else:
                colors = jnp.broadcast_to(
                    jax.random.uniform(key, (3,)), (self.num_triangles, 3)
                )
        else:
            colors = jnp.broadcast_to(jnp.asarray(colors), (self.num_triangles, 3))
        return eqx.tree_at(
            lambda m: m.face_colors, self, colors, is_leaf=lambda x: x is None
        )

    def set_materials(self, *names: str) -> "Mesh":
        """Register material names; assign the single material to all faces if one.

        Reference parity: _mesh.py:1938-1975.
        """
        mesh = eqx.tree_at(
            lambda m: m.material_names, self, tuple(names), is_leaf=lambda x: x is None
        )
        if len(names) == 1:
            mesh = mesh.set_face_materials(0)
        return mesh

    def set_face_materials(
        self, materials: Int[ArrayLike, ""] | Int[ArrayLike, "#num_triangles"]
    ) -> "Mesh":
        """Return a copy with per-face material indices set.

        Reference parity: _mesh.py:1977-2004.
        """
        materials = jnp.broadcast_to(jnp.asarray(materials), (self.num_triangles,))
        return eqx.tree_at(
            lambda m: m.face_materials, self, materials, is_leaf=lambda x: x is None
        )

    # -- Transforms --------------------------------------------------------

    def rotate(self, rotation_matrix: Float[ArrayLike, "3 3"]) -> "Mesh":
        """Rotate all vertices by the given 3x3 matrix."""
        rotation_matrix = jnp.asarray(rotation_matrix)
        return eqx.tree_at(
            lambda m: m.vertices,
            self,
            jnp.matmul(rotation_matrix, self.vertices.T, precision=jax.lax.Precision.HIGHEST).T,
        )

    def scale(self, scale_factor: Float[ArrayLike, ""]) -> "Mesh":
        """Scale all vertices by a scalar factor."""
        return eqx.tree_at(lambda m: m.vertices, self, self.vertices * scale_factor)

    def translate(self, translation: Float[ArrayLike, "3"]) -> "Mesh":
        """Translate all vertices."""
        return eqx.tree_at(
            lambda m: m.vertices, self, self.vertices + jnp.asarray(translation)
        )

    def center(self) -> tuple["Mesh", Float[Array, "3"]]:
        """Center the mesh at the origin; also return the applied translation.

        Reference parity: _mesh.py:2887-2926.
        """
        offset = self.bounding_box.mean(axis=0)
        return self.translate(-offset), -offset

    # -- Constructors ------------------------------------------------------

    @classmethod
    def empty(cls) -> "Mesh":
        """An empty mesh."""
        return cls(
            vertices=jnp.empty((0, 3)),
            triangles=jnp.empty((0, 3), dtype=jnp.int32),
        )

    @classmethod
    def plane(
        cls,
        vertex_a: Float[ArrayLike, "3"],
        vertex_b: Float[ArrayLike, "3"] | None = None,
        vertex_c: Float[ArrayLike, "3"] | None = None,
        *,
        normal: Float[ArrayLike, "3"] | None = None,
        side_length: Float[ArrayLike, ""] = 1.0,
        rotate: Float[ArrayLike, ""] | None = None,
    ) -> "Mesh":
        """Square plane (two triangles) centered at ``vertex_a``.

        Orientation comes either from two extra in-plane vertices or from a
        unit ``normal``. Quad-compatible. Reference parity: _mesh.py:2006-2108.
        """
        if (vertex_b is None) != (vertex_c is None):
            msg = "You must specify either of both of 'vertex_b' and 'vertex_c', or none."
            raise ValueError(msg)
        if (vertex_b is None) == (normal is None):
            msg = (
                "A plane is defined either by two extra vertices or by a"
                " normal; pass ('vertex_b', 'vertex_c') or 'normal', not both."
            )
            raise ValueError(msg)

        vertex_a = jnp.asarray(vertex_a)
        if vertex_b is not None:
            u0 = jnp.asarray(vertex_b) - vertex_a
            v0 = jnp.asarray(vertex_c) - vertex_a
            normal = normalize(jnp.cross(u0, v0))[0]
        else:
            normal = jnp.asarray(normal)

        u, v = orthogonal_basis(normal)
        s = 0.5 * side_length
        vertices = s * jnp.stack((u + v, v - u, -u - v, u - v))
        if rotate is not None:
            vertices = jnp.matmul(
                rotation_matrix_along_axis(rotate, normal), vertices.T, precision=jax.lax.Precision.HIGHEST
            ).T
        vertices = vertices + vertex_a
        triangles = jnp.array([[0, 1, 2], [0, 2, 3]], dtype=jnp.int32)
        return cls(
            vertices=vertices, triangles=triangles, assume_unique_vertices=True
        )

    @classmethod
    def box(
        cls,
        length: Float[ArrayLike, ""] = 1.0,
        width: Float[ArrayLike, ""] = 1.0,
        height: Float[ArrayLike, ""] = 1.0,
        *,
        with_top: bool = False,
        with_bottom: bool = True,
    ) -> "Mesh":
        """Axis-aligned box, optionally open at top/bottom (quad-compatible).

        Same vertex ordering as the reference (_mesh.py:2109-2217) so traced
        paths, object bounds and normals match exactly.

        Examples:
            >>> from differt_tpu.geometry import Mesh
            >>> mesh = Mesh.box(2.0, 3.0, 4.0, with_top=True)
            >>> mesh.num_triangles  # 6 faces x 2 triangles
            12
            >>> mesh.bounding_box.tolist()
            [[-1.0, -1.5, -2.0], [1.0, 1.5, 2.0]]
        """
        dx = jnp.array([length * 0.5, 0.0, 0.0])
        dy = jnp.array([0.0, width * 0.5, 0.0])
        dz = jnp.array([0.0, 0.0, height * 0.5])
        vertices = jnp.stack((
            +dx + dy + dz,
            +dx + dy - dz,
            -dx + dy - dz,
            -dx + dy + dz,
            -dx - dy - dz,
            -dx - dy + dz,
            +dx - dy - dz,
            +dx - dy + dz,
        ))
        triangles = [
            [0, 1, 2],
            [0, 2, 3],
            [3, 2, 4],
            [3, 4, 5],
            [5, 4, 6],
            [5, 6, 7],
            [7, 6, 1],
            [7, 1, 0],
        ]
        if with_bottom:
            triangles += [[1, 4, 2], [1, 6, 4]]
        if with_top:
            triangles += [[0, 3, 5], [0, 5, 7]]
        triangles = jnp.asarray(triangles, dtype=jnp.int32)
        edges = jnp.arange(0, triangles.shape[0] + 1, 2)
        object_bounds = jnp.column_stack((edges[:-1], edges[1:]))
        return cls(
            vertices=vertices,
            triangles=triangles,
            object_bounds=object_bounds,
            assume_unique_vertices=True,
        )

    @classmethod
    def load_obj(cls, file: str | PathLike[str]) -> "Mesh":
        """Load a Wavefront .obj file (vertices, triangles, MTL colors/materials)."""
        from ..io import load_obj

        return load_obj(file)

    @classmethod
    def load_ply(cls, file: str | PathLike[str]) -> "Mesh":
        """Load a Stanford .ply file (ascii or binary little/big endian)."""
        from ..io import load_ply

        return load_ply(file)

    # -- Structure ops -----------------------------------------------------

    def __getitem__(self, key: slice | Int[ArrayLike, " n"]) -> "Mesh":
        """Select a subset of triangles (dropping object bounds).

        Reference parity: _mesh.py:701-740.
        """
        triangles = self.triangles[key]
        return Mesh(
            vertices=self.vertices,
            triangles=triangles,
            face_colors=self.face_colors[key] if self.face_colors is not None else None,
            face_materials=self.face_materials[key]
            if self.face_materials is not None
            else None,
            material_names=self.material_names,
            object_bounds=None,
            assume_quads=False,
            assume_unique_vertices=self.assume_unique_vertices,
            mask=self.mask[key] if self.mask is not None else None,
        )

    def iter_objects(self) -> Iterator["Mesh"]:
        """Iterate over sub-objects (whole mesh if no :attr:`object_bounds`).

        Reference parity: _mesh.py:742-788.
        """
        if self.object_bounds is None:
            yield self
            return
        for start, end in self.object_bounds.tolist():
            sub = self[start:end]
            yield eqx.tree_at(
                lambda m: m.assume_quads,
                sub,
                self.assume_quads and ((end - start) % 2 == 0),
            )

    def append(self, other: "Mesh") -> "Mesh":
        """Concatenate two meshes (vertices re-indexed, materials merged by name).

        Optional attributes present on only one side get defaults on the
        other (black colors, -1 materials, all-active masks). Object bounds
        are preserved/offset; if neither side has them, each input becomes
        one object. Reference parity: _mesh.py:1555-1735.
        """
        offset = self.vertices.shape[0]
        num_self = self.num_triangles
        num_other = other.num_triangles

        vertices = jnp.concatenate((self.vertices, other.vertices), axis=0)
        triangles = jnp.concatenate((self.triangles, other.triangles + offset), axis=0)

        face_colors = None
        if self.face_colors is not None or other.face_colors is not None:
            self_colors = (
                self.face_colors
                if self.face_colors is not None
                else jnp.zeros((num_self, 3))
            )
            other_colors = (
                other.face_colors
                if other.face_colors is not None
                else jnp.zeros((num_other, 3))
            )
            face_colors = jnp.concatenate((self_colors, other_colors), axis=0)

        material_names = list(self.material_names)
        remap: dict[int, int] = {}
        for i, name in enumerate(other.material_names):
            if name in material_names:
                remap[i] = material_names.index(name)
            else:
                remap[i] = len(material_names)
                material_names.append(name)

        face_materials = None
        if self.face_materials is not None or other.face_materials is not None:
            self_mats = (
                self.face_materials
                if self.face_materials is not None
                else jnp.full((num_self,), -1, dtype=jnp.int32)
            )
            other_mats = (
                other.face_materials
                if other.face_materials is not None
                else jnp.full((num_other,), -1, dtype=jnp.int32)
            )
            if remap and any(k != v for k, v in remap.items()):
                lut = jnp.asarray(
                    [remap.get(i, -1) for i in range(len(other.material_names))],
                    dtype=other_mats.dtype,
                )
                other_mats = jnp.where(
                    other_mats >= 0, lut[other_mats.clip(min=0)], other_mats
                )
            face_materials = jnp.concatenate((self_mats, other_mats), axis=0)

        # Each side contributes its own object bounds, a bound-less
        # (non-empty) side counting as a single object — so appending meshes
        # always records the sub-object structure (as the reference's scene
        # merge does, scene.rs:47-68).
        segments = []
        if self.object_bounds is not None:
            segments.append(jnp.asarray(self.object_bounds, dtype=jnp.int32))
        elif num_self > 0:
            segments.append(jnp.asarray([[0, num_self]], dtype=jnp.int32))
        if other.object_bounds is not None:
            segments.append(
                jnp.asarray(other.object_bounds, dtype=jnp.int32) + num_self
            )
        elif num_other > 0:
            segments.append(
                jnp.asarray([[num_self, num_self + num_other]], dtype=jnp.int32)
            )
        object_bounds = (
            jnp.concatenate(segments, axis=0) if segments else None
        )

        mask = None
        if self.mask is not None or other.mask is not None:
            self_mask = (
                self.mask if self.mask is not None else jnp.ones(num_self, dtype=bool)
            )
            other_mask = (
                other.mask if other.mask is not None else jnp.ones(num_other, dtype=bool)
            )
            mask = jnp.concatenate((self_mask, other_mask), axis=0)

        return Mesh(
            vertices=vertices,
            triangles=triangles,
            face_colors=face_colors,
            face_materials=face_materials,
            material_names=tuple(material_names),
            object_bounds=object_bounds,
            assume_quads=self.assume_quads and other.assume_quads,
            assume_unique_vertices=False,
            mask=mask,
        )

    def __add__(self, other: "Mesh") -> "Mesh":
        return self.append(other)

    def dedup_vertices(self, num_decimals: int | None = None) -> "Mesh":
        """Merge duplicate vertices (optionally rounding first) and re-index.

        Reference parity: _mesh.py:790-835.
        """
        vertices = self.vertices
        key_vertices = (
            jnp.round(vertices, num_decimals) if num_decimals is not None else vertices
        )
        unique, index, inverse = jnp.unique(
            key_vertices, axis=0, return_index=True, return_inverse=True
        )
        new_vertices = vertices[index]
        new_triangles = inverse[self.triangles].astype(self.triangles.dtype)
        mesh = eqx.tree_at(
            lambda m: (m.vertices, m.triangles), self, (new_vertices, new_triangles)
        )
        return eqx.tree_at(lambda m: m.assume_unique_vertices, mesh, True)

    def drop_unused_vertices(self) -> "Mesh":
        """Remove vertices not referenced by any triangle.

        Reference parity: _mesh.py:1736-1754.
        """
        used = jnp.zeros(self.vertices.shape[0], dtype=bool).at[
            self.triangles.reshape(-1)
        ].set(True)
        new_index = jnp.cumsum(used) - 1
        vertices = self.vertices[used]
        triangles = new_index[self.triangles].astype(self.triangles.dtype)
        return eqx.tree_at(
            lambda m: (m.vertices, m.triangles), self, (vertices, triangles)
        )

    def drop_duplicates(self) -> "Mesh":
        """Remove duplicate triangles (same vertex index set).

        Reference parity: _mesh.py:1756-1769.
        """
        sorted_tris = jnp.sort(self.triangles, axis=-1)
        _, index = jnp.unique(sorted_tris, axis=0, return_index=True)
        return self[jnp.sort(index)]

    def masked(self) -> "Mesh":
        """Materialize :attr:`mask` by dropping inactive triangles (not jittable).

        Reference parity: _mesh.py:1384-1432.
        """
        if self.mask is None:
            return self
        return eqx.tree_at(
            lambda m: m.mask,
            self[self.mask],
            None,
            is_leaf=lambda x: x is None,
        )

    def sample(
        self,
        size: int,
        replace: bool = False,
        preserve: bool = False,
        *,
        by_masking: bool = False,
        key: PRNGKeyArray,
    ) -> "Mesh":
        """Randomly sample ``size`` triangles, by index or by masking.

        ``by_masking=True`` keeps the full arrays and sets :attr:`mask`,
        which is the JIT-stable (fixed-shape) variant.
        Reference parity: _mesh.py:2375-2533.
        """
        num = self.num_triangles
        if by_masking:
            if replace:
                idx = jax.random.randint(key, (size,), 0, num)
                mask = jnp.zeros(num, dtype=bool).at[idx].set(True)
            else:
                scores = jax.random.uniform(key, (num,))
                threshold = -jnp.sort(-scores)[size - 1] if size > 0 else jnp.inf
                mask = scores >= threshold
            if preserve and self.mask is not None:
                mask = mask & self.mask
            return self.set_mask(mask)
        idx = jax.random.choice(key, num, shape=(size,), replace=replace)
        return self[idx]

    def shuffle(self, *, key: PRNGKeyArray) -> "Mesh":
        """Shuffle triangle order. Reference parity: _mesh.py:2552-2600."""
        perm = jax.random.permutation(key, self.num_triangles)
        return self[perm]

    def clip(
        self,
        x_min: Float[ArrayLike, ""] | None = None,
        x_max: Float[ArrayLike, ""] | None = None,
        y_min: Float[ArrayLike, ""] | None = None,
        y_max: Float[ArrayLike, ""] | None = None,
        z_min: Float[ArrayLike, ""] | None = None,
        z_max: Float[ArrayLike, ""] | None = None,
    ) -> "Mesh":
        """Mask out triangles whose centroid is outside the given limits.

        Reference parity: _mesh.py:1482-1539.
        """
        centers = self.triangle_vertices.mean(axis=-2)
        keep = jnp.ones(self.num_triangles, dtype=bool)
        for axis, (lo, hi) in enumerate(
            ((x_min, x_max), (y_min, y_max), (z_min, z_max))
        ):
            if lo is not None:
                keep &= centers[:, axis] >= lo
            if hi is not None:
                keep &= centers[:, axis] <= hi
        if self.mask is not None:
            keep &= self.mask
        return self.set_mask(keep)

    def keep_all_within(self, bounding_box: Float[ArrayLike, "2 3"]) -> "Mesh":
        """Mask keeping triangles with *all* vertices inside the box.

        Reference parity: _mesh.py:2701-2787.
        """
        bounding_box = jnp.asarray(bounding_box)
        tv = self.triangle_vertices
        inside = jnp.all(
            (tv >= bounding_box[0, :]) & (tv <= bounding_box[1, :]), axis=-1
        )
        keep = inside.all(axis=-1)
        if self.mask is not None:
            keep &= self.mask
        return self.set_mask(keep)

    def keep_any_within(self, bounding_box: Float[ArrayLike, "2 3"]) -> "Mesh":
        """Mask keeping triangles with *any* vertex inside the box.

        Reference parity: _mesh.py:2789-2885.
        """
        bounding_box = jnp.asarray(bounding_box)
        tv = self.triangle_vertices
        inside = jnp.all(
            (tv >= bounding_box[0, :]) & (tv <= bounding_box[1, :]), axis=-1
        )
        keep = inside.any(axis=-1)
        if self.mask is not None:
            keep &= self.mask
        return self.set_mask(keep)

    def add_ground(
        self,
        side_length: Float[ArrayLike, ""] | None = None,
        *,
        elevation: Float[ArrayLike, ""] = 0.0,
    ) -> "Mesh":
        """Append a horizontal square ground plane below the mesh.

        Reference parity: _mesh.py:2928-3016.
        """
        bbox = self.bounding_box
        center = bbox.mean(axis=0)
        if side_length is None:
            side_length = 2.0 * jnp.max(bbox[1, :2] - bbox[0, :2])
        ground = Mesh.plane(
            jnp.array([center[0], center[1], 0.0]) + jnp.array([0.0, 0.0, 1.0]) * elevation,
            normal=jnp.array([0.0, 0.0, 1.0]),
            side_length=side_length,
        )
        return self.append(ground)

    @property
    def at(self) -> _VertexUpdates:
        """Differentiable per-triangle vertex updates.

        ``mesh.at[triangle_index].add(delta)`` etc., with shared vertices
        deduplicated so each vertex is updated exactly once.
        Feature parity: reference ``Mesh.at`` (_mesh.py:1284-1382).
        """
        return _VertexUpdates(self)

    # -- Diffraction edges -------------------------------------------------

    @eqx.filter_jit
    def _connectivity(self) -> tuple[Int[Array, "num_triangles 3"], Int[Array, "num_triangles 3"]]:
        """Edge-to-triangle adjacency via lexsorted half-edges.

        For each of the 3 half-edges of each triangle, returns the adjacent
        triangle index and its local edge index (-1 for boundary or
        non-manifold edges; quad diagonals are excluded when
        :attr:`assume_quads`). Requires :attr:`assume_unique_vertices`.
        Reference parity: _mesh.py:966-1068.
        """
        triangles = self.triangles
        num_triangles = triangles.shape[0]
        if num_triangles == 0:
            empty = jnp.empty((0, 3), dtype=jnp.int32)
            return empty, empty

        # Half-edge e of a triangle joins vertex e and vertex (e - 1) % 3,
        # i.e. edge 0: v0-v2, edge 1: v1-v0, edge 2: v2-v1.
        half_edges = jnp.stack(
            (
                triangles[:, [0, 2]],
                triangles[:, [1, 0]],
                triangles[:, [2, 1]],
            ),
            axis=1,
        ).reshape(-1, 2)
        undirected = jnp.sort(half_edges, axis=-1)
        n_half = undirected.shape[0]

        order = jnp.lexsort((undirected[:, 1], undirected[:, 0]))
        sorted_edges = undirected[order]

        same_as_prev = jnp.concatenate((
            jnp.array([False]),
            jnp.all(sorted_edges[1:] == sorted_edges[:-1], axis=-1),
        ))
        group_ids = jnp.cumsum(~same_as_prev) - 1
        group_counts = jnp.bincount(group_ids, length=n_half)
        pair_sizes = group_counts[group_ids]
        is_manifold = pair_sizes == 2

        # Surface non-manifold geometry to the user (reference parity:
        # _mesh.py:1047-1057 warns through jax.debug.callback so the check
        # stays jit-compatible). Edges shared by >2 faces are silently
        # excluded from diffraction, which is easy to misread as "no edges
        # found" without this warning.
        jax.debug.callback(_warn_non_manifold_edges, jnp.sum(group_counts > 2))

        partner_sorted = jnp.where(
            same_as_prev, jnp.arange(n_half) - 1, jnp.arange(n_half) + 1
        )
        partner = order[partner_sorted.clip(max=n_half - 1)]

        adj = jnp.full(n_half, -1, dtype=jnp.int32)
        adj = adj.at[order].set(
            jnp.where(is_manifold, partner, -1).astype(jnp.int32)
        )

        adj_t = jnp.where(adj != -1, adj // 3, -1).reshape(num_triangles, 3)
        adj_e = jnp.where(adj != -1, adj % 3, -1).reshape(num_triangles, 3)

        if self.assume_quads:
            # The shared diagonal inside a quad is not a geometric edge.
            t_idx = jnp.arange(num_triangles)[:, None]
            is_diagonal = jnp.where(
                t_idx % 2 == 0, adj_t == t_idx + 1, adj_t == t_idx - 1
            )
            adj_t = jnp.where(is_diagonal, -1, adj_t)
            adj_e = jnp.where(is_diagonal, -1, adj_e)
        return adj_t, adj_e

    @property
    def diffraction_edges_mask(self) -> Bool[Array, "num_triangles 3"]:
        """Per-half-edge mask of valid diffraction edges.

        A half-edge diffracts when it is manifold (exactly two adjacent
        triangles), both triangles are active, and the faces are not
        coplanar. Reference parity: _mesh.py:1070-1104.
        """
        if not self.assume_unique_vertices:
            return self.dedup_vertices().diffraction_edges_mask
        num_triangles = self.num_triangles
        if num_triangles == 0:
            return jnp.empty((0, 3), dtype=bool)

        adj_t, _ = self._connectivity()
        mask = adj_t != -1

        if self.mask is not None:
            mask = mask & self.mask[:, None]
            adj_safe = jnp.where(adj_t != -1, adj_t, num_triangles)
            padded = jnp.append(self.mask, False)
            mask = mask & padded[adj_safe]

        normals = self.normals
        adj_safe = jnp.where(adj_t != -1, adj_t, num_triangles)
        padded_normals = jnp.vstack((normals, jnp.zeros((1, 3))))
        cos_phi = jnp.sum(normals[:, None, :] * padded_normals[adj_safe], axis=-1)
        coplanar = cos_phi > 1.0 - 10.0 * jnp.finfo(cos_phi.dtype).eps
        return mask & ~coplanar

    @property
    def wedge_angles(self) -> Float[Array, "num_triangles 3"]:
        """Wedge parameter n (exterior angle = n * pi) per half-edge.

        Convex wedges (adjacent face bending away from the normal) have
        n > 1, reflex ones n < 1; non-diffracting edges report 1.
        Reference parity: _mesh.py:1204-1247.
        """
        if not self.assume_unique_vertices:
            return self.dedup_vertices().wedge_angles
        num_triangles = self.num_triangles
        if num_triangles == 0:
            return jnp.empty((0, 3))

        normals = self.normals
        adj_t, adj_e = self._connectivity()
        adj_safe = jnp.where(adj_t != -1, adj_t, num_triangles)
        padded_normals = jnp.vstack((normals, jnp.zeros((1, 3))))
        cos_phi = jnp.clip(
            jnp.sum(normals[:, None, :] * padded_normals[adj_safe], axis=-1),
            -1.0,
            1.0,
        )
        phi = jnp.arccos(cos_phi)

        # Side test: where does the adjacent triangle's opposite vertex lie
        # relative to this face's plane? Above (+normal) means a reflex
        # wedge, below a convex one.
        vertices = self.triangle_vertices
        opposite_of_edge = jnp.array([1, 2, 0])
        opp_idx = opposite_of_edge[jnp.where(adj_e != -1, adj_e, 0)]
        padded_vertices = jnp.vstack((vertices, jnp.zeros((1, 3, 3))))
        v_opposite = padded_vertices[adj_safe, opp_idx]
        to_opposite = v_opposite - vertices
        side = jnp.sign(jnp.sum(normals[:, None, :] * to_opposite, axis=-1))

        n = 1.0 - side * phi / jnp.pi
        return jnp.where(self.diffraction_edges_mask, n, 1.0)

    def _diffraction_edges_info(
        self,
    ) -> tuple[
        Float[Array, "num_edges 2 3"],
        Int[Array, "num_edges 2"],
        Float[Array, " num_edges"],
    ]:
        """Unique diffraction edges: coordinates, adjacent triangles, wedge n.

        Not jittable (dynamic edge count). Reference parity:
        _mesh.py:1106-1176.
        """
        mask = self.diffraction_edges_mask
        t_idx, e_idx = jnp.where(mask)
        if t_idx.shape[0] == 0:
            return (
                jnp.empty((0, 2, 3)),
                jnp.empty((0, 2), dtype=jnp.int32),
                jnp.empty((0,)),
            )

        v_start = self.triangles[t_idx, e_idx]
        v_end = self.triangles[t_idx, (e_idx - 1) % 3]
        keys = jnp.stack(
            (jnp.minimum(v_start, v_end), jnp.maximum(v_start, v_end)), axis=-1
        )
        _, unique_idx, inverse = jnp.unique(
            keys, axis=0, return_index=True, return_inverse=True
        )
        num_edges = unique_idx.shape[0]

        flat_half = t_idx * 3 + e_idx
        edges = self.triangle_edges.reshape(-1, 2, 3)[flat_half[unique_idx]]

        sort_idx = jnp.argsort(inverse)
        sorted_inverse = inverse[sort_idx]
        sorted_t = t_idx[sort_idx]
        is_second = jnp.concatenate((
            jnp.array([False]),
            sorted_inverse[1:] == sorted_inverse[:-1],
        ))
        adj_triangles = jnp.full((num_edges, 2), -1, dtype=jnp.int32)
        adj_triangles = adj_triangles.at[sorted_inverse[~is_second], 0].set(
            sorted_t[~is_second].astype(jnp.int32)
        )
        adj_triangles = adj_triangles.at[sorted_inverse[is_second], 1].set(
            sorted_t[is_second].astype(jnp.int32)
        )

        wedge_n = self.wedge_angles[t_idx[unique_idx], e_idx[unique_idx]]
        return edges, adj_triangles, wedge_n

    @property
    def diffraction_edges(self) -> Float[Array, "num_edges 2 3"]:
        """Coordinates of the unique diffraction edges (start/end vertices)."""
        if not self.assume_unique_vertices:
            return self.dedup_vertices().diffraction_edges
        return self._diffraction_edges_info()[0]

    @property
    def diffraction_edges_to_triangles(self) -> Int[Array, "num_edges 2"]:
        """Adjacent triangle indices per diffraction edge (-1 if single-sided)."""
        if not self.assume_unique_vertices:
            return self.dedup_vertices().diffraction_edges_to_triangles
        return self._diffraction_edges_info()[1]

    @property
    def wedge_parameters(self) -> Float[Array, " num_edges"]:
        """Wedge parameter n per unique diffraction edge."""
        if not self.assume_unique_vertices:
            return self.dedup_vertices().wedge_parameters
        return self._diffraction_edges_info()[2]

    # -- Accelerated ray casting ------------------------------------------

    def ray_intersect_any_triangle(
        self,
        ray_origins: Float[ArrayLike, "*batch 3"],
        ray_directions: Float[ArrayLike, "*batch 3"],
        **kwargs: Any,
    ) -> Bool[Array, " *batch"]:
        """Occlusion test against all (active) mesh triangles.

        Dispatches to the Pallas any-hit kernel on a GPU, else the pure-JAX
        tiled scan. Replaces the reference's Warp BVH
        callback (_mesh.py:3018-3094).
        """
        from ..ops import dispatch_ray_intersect_any_triangle

        return dispatch_ray_intersect_any_triangle(
            self, jnp.asarray(ray_origins), jnp.asarray(ray_directions), **kwargs
        )

    def first_triangle_hit_by_ray(
        self,
        ray_origins: Float[ArrayLike, "*batch 3"],
        ray_directions: Float[ArrayLike, "*batch 3"],
        **kwargs: Any,
    ) -> tuple[Int[Array, " *batch"], Float[Array, " *batch"]]:
        """Closest-hit query with a differentiable distance.

        The forward pass finds the hit index with a non-differentiable
        argmin; the backward pass re-derives ``t`` from the frozen hit index
        with the Moeller-Trumbore formula so gradients flow to vertices and
        ray parameters (same custom-VJP trick as the reference,
        _mesh.py:226-344, made substrate-independent).
        """
        from ..ops import dispatch_first_triangle_hit_by_ray

        return dispatch_first_triangle_hit_by_ray(
            self, jnp.asarray(ray_origins), jnp.asarray(ray_directions), **kwargs
        )

    def triangles_visible_from_vertex(
        self,
        vertex: Float[ArrayLike, "*batch 3"],
        num_rays: int = int(1e6),
        **kwargs: Any,
    ) -> Bool[Array, "*batch num_triangles"]:
        """Ray-launching visibility estimate from one or more vertices.

        Reference parity: _mesh.py:3164-3253.
        """
        from ..ops import dispatch_triangles_visible_from_vertex

        return dispatch_triangles_visible_from_vertex(
            self, jnp.asarray(vertex), num_rays=num_rays, **kwargs
        )

    def plot(self, **kwargs: Any):
        """Plot this mesh. See :func:`differt_tpu.plotting.draw_mesh`."""
        from ..plotting import draw_mesh

        return draw_mesh(self, **kwargs)
