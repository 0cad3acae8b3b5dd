"""Path solvers: exhaustive / hybrid tracers and the SBR launcher.

Reference parity: differt/src/differt/geometry/_solvers.py. The key design
change is candidate generation: instead of host-side Rust iterators, the
exhaustive tracer decodes its candidates *on device* from the closed-form
index mapping (:mod:`differt_tpu.geometry._candidates`), so chunking and
multi-chip sharding are just index-range arithmetic.
"""

import abc
from collections.abc import Callable, Iterator, Sequence
from typing import TYPE_CHECKING, Any

from differt_tpu import treekit as eqx
import jax
import jax.numpy as jnp
import numpy as np
from differt_tpu.treekit import AbstractVar
from .._typing import Array, ArrayLike, Bool, Float, Int

from ..geometry._candidates import (
    SizedIterator,
    count_path_candidates,
    generate_path_candidates,
)
from ..geometry._lattice import fibonacci_lattice, viewing_frustum
from ..geometry._mesh import Mesh
from ..geometry._paths import LaunchedPaths, TracedPaths
from ..geometry._vectors import assemble_path
from ..utils import smoothing_function
from ._image_method import (
    consecutive_vertices_are_on_same_side_of_mirror,
    image_method,
)
from ._scan import ray_intersect_any_triangle
from ._triangle import ray_intersect_triangle

if TYPE_CHECKING:
    from ..geometry._scene import Scene


class AbstractPathSolver(eqx.Module):
    """Base class for all path solvers and launchers."""

    epsilon: AbstractVar[float]
    """Tolerance for ray / object intersection checks."""
    hit_tol: AbstractVar[float]
    """Hit-distance tolerance when testing path segments for blockage."""


class AbstractPathTracer(AbstractPathSolver):
    """Base class for exact path tracers (candidates -> traced paths)."""

    @abc.abstractmethod
    def generate_path_candidates(
        self,
        scene: "Scene",
        order: int | Sequence[int],
        specular_reflection: bool = True,
        diffuse_scattering: bool = False,
    ) -> tuple[
        Int[Array, "num_candidates max_order"],
        Int[Array, "num_candidates max_order"],
    ]:
        """Return ``(path_candidates, interaction_types)`` (-1 = inactive)."""

    def generate_path_candidates_chunks_iter(
        self,
        scene: "Scene",
        order: int | Sequence[int],
        *args: Any,
        chunk_size: int,
        pad_chunks: bool = False,
        **kwargs: Any,
    ) -> SizedIterator[tuple[Array, Array]]:
        """Chunked candidate generation (default: slice the full result)."""
        candidates, interactions = self.generate_path_candidates(
            scene, order, *args, **kwargs
        )
        num = candidates.shape[-2]
        num_chunks, rem = divmod(num, chunk_size)
        total = num_chunks + (1 if rem else 0)

        def gen() -> Iterator[tuple[Array, Array]]:
            for i in range(num_chunks):
                sl = slice(i * chunk_size, (i + 1) * chunk_size)
                yield candidates[..., sl, :], interactions[..., sl, :]
            if rem:
                tail = (candidates[..., -rem:, :], interactions[..., -rem:, :])
                if pad_chunks:
                    pad = chunk_size - rem

                    def pad_fn(x: Array) -> Array:
                        widths = [(0, 0)] * x.ndim
                        widths[-2] = (0, pad)
                        return jnp.pad(x, widths, constant_values=-1)

                    tail = (pad_fn(tail[0]), pad_fn(tail[1]))
                yield tail

        return SizedIterator(gen(), size=total)

    @abc.abstractmethod
    def trace_path_candidates(
        self,
        scene: "Scene",
        path_candidates: Int[Array, "num_candidates max_order"],
        interaction_types: Int[Array, "num_candidates max_order"],
    ) -> TracedPaths:
        """Trace exact paths from the proposed candidates."""

    def trace_paths(
        self,
        scene: "Scene",
        order: int | Sequence[int],
        chunk_size: int | None = None,
        pad_chunks: bool = False,
    ) -> TracedPaths | Iterator[TracedPaths]:
        """Trace paths, optionally streaming candidate chunks.

        With a sequence of orders, returns a :class:`SizedIterator` yielding
        one :class:`TracedPaths` per order (consumable by, e.g.,
        :func:`differt_tpu.plugins.deepmimo.export`). The reference raises
        ``NotImplementedError`` for this case (_scene.py:704-708).
        """
        if isinstance(order, Sequence):
            orders = list(order)

            def gen() -> Iterator[TracedPaths]:
                for o in orders:
                    result = self.trace_paths(
                        scene, o, chunk_size=chunk_size, pad_chunks=pad_chunks
                    )
                    if isinstance(result, TracedPaths):
                        yield result
                    else:
                        yield from result

            if chunk_size is None:
                return SizedIterator(gen(), size=len(orders))
            return gen()
        if chunk_size is not None:
            return (
                self.trace_path_candidates(scene, cands, types)
                for cands, types in self.generate_path_candidates_chunks_iter(
                    scene, order, chunk_size=chunk_size, pad_chunks=pad_chunks
                )
            )
        candidates, interactions = self.generate_path_candidates(scene, order)
        return self.trace_path_candidates(scene, candidates, interactions)


class AbstractPathLauncher(AbstractPathSolver):
    """Base class for ray-launching solvers (SBR)."""

    max_dist: AbstractVar[float]
    """Maximal squared ray-to-receiver distance for capture."""

    @abc.abstractmethod
    def launch_rays(
        self, scene: "Scene"
    ) -> tuple[Float[Array, "num_tx num_rays 3"], Float[Array, "num_tx num_rays 3"]]:
        """Return initial ray origins and directions per transmitter."""

    def bounce_rays(
        self,
        scene: "Scene",
        ray_origins: Float[Array, "num_tx num_rays 3"],
        ray_directions: Float[Array, "num_tx num_rays 3"],
        triangles: Int[Array, "num_tx num_rays"],
        t_hit: Float[Array, "num_tx num_rays"],
        valid_rays: Bool[Array, "num_tx num_rays"],
    ) -> tuple[Array, Array, Array]:
        """Advance rays to their hit points and reflect specularly."""
        inside = jnp.isfinite(t_hit)
        valid_rays = valid_rays & inside
        t_hit = jnp.where(inside, t_hit, jnp.zeros_like(t_hit))
        ray_origins = ray_origins + t_hit[..., None] * ray_directions
        normals = jnp.take(scene.mesh.normals, triangles, axis=0)
        ray_directions = (
            ray_directions
            - 2.0 * jnp.sum(ray_directions * normals, axis=-1, keepdims=True) * normals
        )
        return ray_origins, ray_directions, valid_rays

    def filter_rays(
        self,
        scene: "Scene",
        ray_origins: Float[Array, "num_tx num_rays 3"],
        ray_directions: Float[Array, "num_tx num_rays 3"],
        rx_vertices: Float[Array, "num_rx 3"],
        t_hit: Float[Array, "num_tx num_rays"],
        valid_rays: Bool[Array, "num_tx num_rays"],
    ) -> Bool[Array, "num_tx num_rx num_rays"]:
        """Mark rays passing within ``sqrt(max_dist)`` of each receiver."""
        del scene
        to_rx = rx_vertices[None, :, None, :] - ray_origins[:, None, ...]
        dist_sq = jnp.square(
            jnp.cross(ray_directions[:, None, ...], to_rx)
        ).sum(axis=-1)
        t_rx = jnp.sum(ray_directions[:, None, ...] * to_rx, axis=-1)
        return jnp.where(
            (t_rx > 0) & (t_rx < t_hit[:, None, :]) & valid_rays[:, None, :],
            dist_sq < self.max_dist,
            False,
        )

    @eqx.filter_jit
    def launch_paths(self, scene: "Scene", order: int) -> LaunchedPaths:
        """Launch, bounce (scan), filter, and assemble ray paths."""
        tx_vertices = scene.transmitters.reshape(-1, 3)
        rx_vertices = scene.receivers.reshape(-1, 3)
        num_tx = tx_vertices.shape[0]
        num_rx = rx_vertices.shape[0]

        ray_origins, ray_directions = self.launch_rays(scene)
        num_rays = ray_origins.shape[1]

        def step(carry, _):
            origins, directions, valid = carry
            triangles, t_hit = scene.mesh.first_triangle_hit_by_ray(
                origins, directions
            )
            masks = self.filter_rays(
                scene, origins, directions, rx_vertices, t_hit, valid
            )
            origins, directions, valid = self.bounce_rays(
                scene, origins, directions, triangles, t_hit, valid
            )
            return (origins, directions, valid), (triangles, origins, masks)

        valid = jnp.ones(ray_origins.shape[:-1], dtype=bool)
        _, (path_candidates, vertices, masks) = jax.lax.scan(
            step, (ray_origins, ray_directions, valid), length=order + 1
        )

        path_candidates = jnp.moveaxis(path_candidates[:-1, ...], 0, -1)
        vertices = jnp.moveaxis(vertices[:-1, ...], 0, -2)
        masks = jnp.moveaxis(masks, 0, -1)

        vertices = assemble_path(
            tx_vertices[:, None, None, :],
            vertices[:, None, ...],
            rx_vertices[None, :, None, :],
        )

        dtype = path_candidates.dtype
        tx_objects = jnp.broadcast_to(
            jnp.arange(num_tx, dtype=dtype)[:, None, None, None],
            (num_tx, num_rx, num_rays, 1),
        )
        rx_objects = jnp.broadcast_to(
            jnp.arange(num_rx, dtype=dtype)[None, :, None, None],
            (num_tx, num_rx, num_rays, 1),
        )
        path_candidates = jnp.broadcast_to(
            path_candidates[:, None, ...], (num_tx, num_rx, num_rays, order)
        )
        objects = jnp.concatenate((tx_objects, path_candidates, rx_objects), axis=-1)
        interaction_types = jnp.zeros(
            (num_tx, num_rx, num_rays, order), dtype=jnp.int32
        )
        return LaunchedPaths(
            vertices=vertices,
            objects=objects,
            masks=masks,
            interaction_types=interaction_types,
        )


@eqx.filter_jit
def trace_path_candidates(
    mesh: Mesh,
    tx_vertices: Float[Array, "num_tx 3"],
    rx_vertices: Float[Array, "num_rx 3"],
    path_candidates: Int[Array, "num_candidates order"],
    interaction_types: Int[Array, "num_candidates order"] | None = None,
    *,
    epsilon: Float[ArrayLike, ""] | None = None,
    hit_tol: Float[ArrayLike, ""] | None = None,
    min_len: Float[ArrayLike, ""] | None = None,
    smoothing_factor: Float[ArrayLike, ""] | None = None,
    confidence_threshold: Float[ArrayLike, ""] = 0.5,
    batch_size: int | None = 512,
) -> TracedPaths:
    """Trace and validate exact specular paths for a batch of candidates.

    Pipeline (reference parity: _solvers.py:499-770): gather candidate
    mirrors -> image method -> five validity checks (inside-triangle,
    same-side-of-mirror, blocked-by-scene, too-short-segment, finiteness),
    each with a hard boolean or sigmoid-smoothed differentiable variant.
    """
    if min_len is None:
        dtype = jnp.result_type(mesh.vertices, tx_vertices, rx_vertices)
        min_len = 10.0 * jnp.finfo(dtype).eps
    min_len = jnp.asarray(min_len)

    num_tx = tx_vertices.shape[0]
    num_rx = rx_vertices.shape[0]
    num_candidates, order = path_candidates.shape

    if mesh.assume_quads:
        # Each quad primitive expands to its two triangles.
        path_candidates = jnp.repeat(path_candidates, 2, axis=-1)
        path_candidates = path_candidates.at[..., 1::2].add(1)
        k = 2
    else:
        k = 1

    triangles = jnp.take(mesh.triangles, path_candidates, axis=0).reshape(
        num_candidates, k * order, 3
    )
    triangle_vertices = jnp.take(mesh.vertices, triangles, axis=0).reshape(
        num_candidates, k * order, 3, 3
    )

    if mesh.mask is not None:
        active_rays = jnp.take(mesh.mask, path_candidates, axis=0).all(axis=-1)
    else:
        active_rays = None

    stride = 2 if mesh.assume_quads else 1
    mirror_vertices = triangle_vertices[..., ::stride, 0, :]
    mirror_normals = jnp.take(mesh.normals, path_candidates[..., ::stride], axis=0)

    if num_candidates == 0:
        dtype = jnp.result_type(tx_vertices, rx_vertices, mesh.vertices)
        full_paths = jnp.empty((num_tx, num_rx, 0, order + 2, 3), dtype=dtype)
    else:
        paths = image_method(
            tx_vertices[:, None, None, :],
            rx_vertices[None, :, None, :],
            mirror_vertices,
            mirror_normals,
        )
        full_paths = assemble_path(
            tx_vertices[:, None, None, :],
            paths,
            rx_vertices[None, :, None, :],
        )

    ray_origins = full_paths[..., :-1, :]
    ray_directions = jnp.diff(full_paths, axis=-2)
    smooth = smoothing_factor is not None

    # Check 1: reflection points lie inside their triangles (or either
    # triangle of the quad).
    if mesh.assume_quads:
        hits = ray_intersect_triangle(
            jnp.repeat(ray_origins[..., :-1, :], 2, axis=-2),
            jnp.repeat(ray_directions[..., :-1, :], 2, axis=-2),
            triangle_vertices,
            epsilon=epsilon,
            smoothing_factor=smoothing_factor,
        )[1].reshape(num_tx, num_rx, num_candidates, order, 2)
        if smooth:
            inside = hits.max(axis=-1, initial=0.0).min(axis=-1, initial=1.0)
        else:
            inside = hits.any(axis=-1).all(axis=-1)
    else:
        hits = ray_intersect_triangle(
            ray_origins[..., :-1, :],
            ray_directions[..., :-1, :],
            triangle_vertices,
            epsilon=epsilon,
            smoothing_factor=smoothing_factor,
        )[1]
        inside = hits.min(axis=-1, initial=1.0) if smooth else hits.all(axis=-1)

    # Check 2: consecutive vertices on the same side of each mirror.
    same_side = consecutive_vertices_are_on_same_side_of_mirror(
        full_paths,
        mirror_vertices,
        mirror_normals,
        smoothing_factor=smoothing_factor,
    )
    valid_reflections = (
        same_side.min(axis=-1, initial=1.0) if smooth else same_side.all(axis=-1)
    )

    # Check 4: no degenerate (too short) segment.
    seg_sq = jnp.sum(ray_directions * ray_directions, axis=-1)
    if smooth:
        too_small = smoothing_function(min_len - seg_sq, smoothing_factor).max(
            axis=-1, initial=0.0
        )
    else:
        too_small = (seg_sq < min_len).any(axis=-1)

    # Check 5: finiteness (image method emits inf for impossible paths).
    is_finite = jnp.isfinite(full_paths).all(axis=(-1, -2))
    full_paths = jnp.where(
        is_finite[..., None, None], full_paths, jnp.zeros_like(full_paths)
    )

    # Check 3 (last on purpose): no segment blocked by the scene. The final
    # mask is an AND of every check, so only paths that survived the cheap
    # geometric checks need the O(num_triangles) blockage sweep — the
    # accelerated backend culls the rest via a per-ray threshold, which is
    # what keeps city-scale tracing from brute-forcing the mesh against the
    # wild segments of already-invalid image-method candidates.
    if smooth:
        # Exclude each segment's own mirror triangles from the smoothed
        # blockage sum. The hard path dodges self-intersections with
        # hit_tol origin offsets, but a sigmoid in ABSOLUTE t cannot
        # resolve a ~1e-5 offset (sigmoid(-1e-5 * alpha) ~ 0.5): with the
        # reference's formulation (_solvers.py:664-674) every reflection
        # counts its own mirrors as half-blockers, the clipped sum
        # saturates, and the confidence of every valid bounce path
        # collapses to ~0 — the relaxation is only exact for LOS there.
        # Masking the endpoint mirrors per segment restores meaningful
        # confidences at every order.
        kq = 2 if mesh.assume_quads else 1
        pc = path_candidates.reshape(num_candidates, order, kq)
        none = jnp.full((num_candidates, 1, kq), -1, dtype=pc.dtype)
        seg_end = jnp.concatenate((pc, none), axis=1)
        seg_start = jnp.concatenate((none, pc), axis=1)
        endpoint_ids = jnp.concatenate((seg_start, seg_end), axis=-1)
        tri_ids = jnp.arange(mesh.num_triangles, dtype=pc.dtype)
        own_mirror = (endpoint_ids[..., None] == tri_ids).any(axis=-2)
        active_smooth = (
            ~own_mirror if mesh.mask is None else (mesh.mask & ~own_mirror)
        )
        blocked = ray_intersect_any_triangle(
            ray_origins,
            ray_directions,
            mesh.triangle_vertices,
            active_triangles=active_smooth,
            epsilon=epsilon,
            hit_tol=hit_tol,
            smoothing_factor=smoothing_factor,
            batch_size=batch_size,
        ).max(axis=-1, initial=0.0)
    else:
        alive = inside & valid_reflections & ~too_small & is_finite
        blocked = mesh.ray_intersect_any_triangle(
            ray_origins,
            ray_directions,
            hit_tol=hit_tol,
            active_rays=alive[..., None],
        ).any(axis=-1)

    if smooth:
        mask = jnp.stack(
            (
                inside,
                valid_reflections,
                1.0 - blocked,
                1.0 - too_small,
                is_finite.astype(inside.dtype),
            ),
            axis=-1,
        ).min(axis=-1, initial=1.0)
        if active_rays is not None:
            mask = mask * active_rays
    else:
        mask = inside & valid_reflections & ~blocked & ~too_small & is_finite
        if active_rays is not None:
            mask = mask & active_rays

    return _assemble_traced_paths(
        full_paths,
        mask,
        path_candidates,
        interaction_types,
        k,
        num_tx,
        num_rx,
        num_candidates,
        order,
        confidence_threshold,
    )


def _assemble_traced_paths(
    full_paths: Array,
    mask: Array,
    path_candidates: Array,
    interaction_types: Array | None,
    k: int,
    num_tx: int,
    num_rx: int,
    num_candidates: int,
    order: int,
    confidence_threshold,
) -> TracedPaths:
    """Attach object indices and interaction types to traced geometry."""
    dtype = path_candidates.dtype
    tx_objects = jnp.broadcast_to(
        jnp.arange(num_tx, dtype=dtype)[:, None, None, None],
        (num_tx, num_rx, num_candidates, 1),
    )
    rx_objects = jnp.broadcast_to(
        jnp.arange(num_rx, dtype=dtype)[None, :, None, None],
        (num_tx, num_rx, num_candidates, 1),
    )
    mid_objects = jnp.broadcast_to(
        path_candidates[:, ::k], (num_tx, num_rx, num_candidates, order)
    )
    objects = jnp.concatenate((tx_objects, mid_objects, rx_objects), axis=-1)

    if interaction_types is not None:
        out_types = jnp.broadcast_to(
            interaction_types, (num_tx, num_rx, num_candidates, order)
        )
    else:
        out_types = jnp.zeros((num_tx, num_rx, num_candidates, order), dtype=jnp.int32)

    return TracedPaths(
        full_paths,
        objects,
        mask=mask,
        interaction_types=out_types,
        confidence_threshold=confidence_threshold,
    )


class ExhaustivePathTracer(AbstractPathTracer):
    """Exhaustive image-method tracer over all candidates.

    Candidates are decoded on device via the closed-form index mapping; the
    ``shard`` argument restricts generation to an index sub-range so each
    chip enumerates exactly its own shard without host work.
    Reference parity: _solvers.py:778-957.

    >>> import jax.numpy as jnp
    >>> from differt_tpu.geometry import Mesh, Scene
    >>> scene = Scene(
    ...     transmitters=jnp.array([-1.0, 0.0, 0.5]),
    ...     receivers=jnp.array([1.0, 0.0, 0.5]),
    ...     mesh=Mesh.plane(
    ...         jnp.zeros(3), normal=jnp.array([0.0, 0.0, 1.0]), side_length=10.0
    ...     ),
    ... )
    >>> paths = ExhaustivePathTracer().trace_paths(scene, order=1)
    >>> int(paths.num_valid_paths)  # one specular point per quad triangle
    2
    >>> [round(float(v), 3) for v in paths.masked().vertices[0, 1]]
    [0.0, 0.0, 0.0]
    """

    epsilon: Float[ArrayLike, ""] | None = None
    """Tolerance for ray / object intersection checks."""
    hit_tol: Float[ArrayLike, ""] | None = None
    """Hit-distance tolerance when testing path segments for blockage."""
    min_len: Float[ArrayLike, ""] | None = None
    """Minimal (squared) segment length for a valid path."""
    smoothing_factor: Float[ArrayLike, ""] | None = None
    """Slope of the smoothing function (None = hard checks)."""
    confidence_threshold: Float[ArrayLike, ""] = 0.5
    """Smoothed-mask confidence above which a path counts as valid."""
    batch_size: int | None = 512
    """Triangle tile size for occlusion checks."""
    disconnect_inactive_triangles: bool = False
    """Whether to drop candidates touching masked-out primitives up front."""
    chunk_size: int | None = None
    """Default chunk size for chunked iteration."""

    def generate_path_candidates(
        self,
        scene: "Scene",
        order: int | Sequence[int],
        specular_reflection: bool = True,
        diffuse_scattering: bool = False,
    ) -> tuple[Array, Array]:
        del specular_reflection, diffuse_scattering
        if isinstance(order, Sequence):
            # Multi-order: a static tuple pytree, one array per order.
            # Every order keeps its own compiled width (no ragged shapes in
            # the trace); trace_path_candidates merges the results into one
            # container. The reference raises here (_scene.py:704-708).
            per_order = [self.generate_path_candidates(scene, o) for o in order]
            return (
                tuple(c for c, _ in per_order),
                tuple(t for _, t in per_order),
            )

        num_primitives = scene.mesh.num_primitives

        if (
            self.disconnect_inactive_triangles
            and scene.mesh.mask is not None
            and order > 0
        ):
            from ..geometry._candidates import generate_filtered_path_candidates

            mask = scene.mesh.mask
            if scene.mesh.assume_quads:
                mask = mask[0::2] & mask[1::2]
            # Chunked decode -> filter -> concat: never materializes the
            # unpruned N*(N-1)**(order-1) space (reference: chunked
            # PathsChunksIter, graph.rs:77-116).
            candidates = generate_filtered_path_candidates(
                num_primitives,
                order,
                lambda chunk: jnp.take(mask, chunk, axis=0).all(axis=-1),
            )
        else:
            candidates = generate_path_candidates(num_primitives, order)

        if scene.mesh.assume_quads:
            candidates = 2 * candidates

        interaction_types = jnp.zeros_like(candidates, dtype=jnp.int32)
        return candidates, interaction_types

    def generate_path_candidates_chunks_iter(
        self,
        scene: "Scene",
        order: int | Sequence[int],
        *args: Any,
        chunk_size: int | None = None,
        pad_chunks: bool = False,
        **kwargs: Any,
    ) -> SizedIterator[tuple[Array, Array]]:
        """Chunked generation, decoding each index range on device."""
        effective = chunk_size or self.chunk_size
        if effective is None:
            candidates, interactions = self.generate_path_candidates(
                scene, order, *args, **kwargs
            )
            return SizedIterator(iter([(candidates, interactions)]), size=1)
        if isinstance(order, Sequence):
            # One unified chunked enumeration across all orders: chain the
            # per-order chunk iterators into a single sized stream.
            iters = [
                self.generate_path_candidates_chunks_iter(
                    scene,
                    o,
                    *args,
                    chunk_size=effective,
                    pad_chunks=pad_chunks,
                    **kwargs,
                )
                for o in order
            ]
            total_chunks = sum(len(it) for it in iters)

            def chained() -> Iterator[tuple[Array, Array]]:
                for it in iters:
                    yield from it

            return SizedIterator(chained(), size=total_chunks)

        num_primitives = scene.mesh.num_primitives
        total = count_path_candidates(num_primitives, order)
        num_chunks = -(-total // effective) if total else 0
        assume_quads = scene.mesh.assume_quads

        def gen() -> Iterator[tuple[Array, Array]]:
            for start in range(0, total, effective):
                size = min(effective, total - start)
                chunk = generate_path_candidates(
                    num_primitives, order, start=start, size=size
                )
                if pad_chunks and size < effective:
                    chunk = jnp.pad(
                        chunk, ((0, effective - size), (0, 0)), constant_values=-1
                    )
                if assume_quads:
                    chunk = 2 * chunk
                yield chunk, jnp.zeros_like(chunk, dtype=jnp.int32)

        return SizedIterator(gen(), size=num_chunks)

    @eqx.filter_jit
    def trace_path_candidates(
        self,
        scene: "Scene",
        path_candidates: Int[Array, "num_candidates order"],
        interaction_types: Int[Array, "num_candidates order"],
    ) -> TracedPaths:
        if isinstance(path_candidates, tuple):
            # Multi-order tuple pytree: one static-width trace per order,
            # merged into a single padded container.
            from ..geometry._paths import concatenate_paths

            return concatenate_paths([
                self.trace_path_candidates(scene, c, t)
                for c, t in zip(path_candidates, interaction_types, strict=True)
            ])
        return trace_path_candidates(
            scene.mesh,
            scene.transmitters.reshape(-1, 3),
            scene.receivers.reshape(-1, 3),
            path_candidates,
            interaction_types=interaction_types,
            epsilon=self.epsilon,
            hit_tol=self.hit_tol,
            min_len=self.min_len,
            smoothing_factor=self.smoothing_factor,
            confidence_threshold=self.confidence_threshold,
            batch_size=self.batch_size,
        )


class HybridPathTracer(AbstractPathTracer):
    """Hybrid tracer: ray-launching visibility pruning + exhaustive tracing.

    Visibility masks are estimated on device; candidates whose first/last
    primitives are invisible from TX/RX (or masked out) are compacted away
    before tracing. Reference parity: _solvers.py:960-1176.
    """

    num_rays: int = int(1e6)
    """Number of visibility-estimation rays."""
    epsilon: Float[ArrayLike, ""] | None = None
    """Tolerance for ray / object intersection checks."""
    hit_tol: Float[ArrayLike, ""] | None = None
    """Hit-distance tolerance when testing path segments for blockage."""
    min_len: Float[ArrayLike, ""] | None = None
    """Minimal (squared) segment length for a valid path."""
    smoothing_factor: Float[ArrayLike, ""] | None = None
    """Slope of the smoothing function (None = hard checks)."""
    confidence_threshold: Float[ArrayLike, ""] = 0.5
    """Smoothed-mask confidence above which a path counts as valid."""
    batch_size: int | None = 512
    """Triangle tile size for occlusion checks."""
    chunk_size: int | None = None
    """Default chunk size for chunked iteration."""

    def _visibility(
        self, scene: "Scene"
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
        tx_vertices = scene.transmitters.reshape(-1, 3)
        rx_vertices = scene.receivers.reshape(-1, 3)

        visible_tx = scene.mesh.triangles_visible_from_vertex(
            tx_vertices, num_rays=self.num_rays
        ).any(axis=0)
        visible_rx = scene.mesh.triangles_visible_from_vertex(
            rx_vertices, num_rays=self.num_rays
        ).any(axis=0)

        if scene.mesh.assume_quads:
            visible_tx = visible_tx.reshape(-1, 2).any(axis=-1)
            visible_rx = visible_rx.reshape(-1, 2).any(axis=-1)

        mask = None
        if scene.mesh.mask is not None:
            mask = scene.mesh.mask
            if scene.mesh.assume_quads:
                mask = mask[0::2] & mask[1::2]
            mask = np.asarray(mask)
        return np.asarray(visible_tx), np.asarray(visible_rx), mask

    def generate_path_candidates(
        self,
        scene: "Scene",
        order: int | Sequence[int],
        specular_reflection: bool = True,
        diffuse_scattering: bool = False,
    ) -> tuple[Array, Array]:
        del specular_reflection, diffuse_scattering
        if isinstance(order, Sequence):
            # Multi-order: one static per-order tuple pytree (see
            # ExhaustivePathTracer.generate_path_candidates). Visibility
            # pruning runs once per order on the shared masks.
            per_order = [self.generate_path_candidates(scene, o) for o in order]
            return (
                tuple(c for c, _ in per_order),
                tuple(t for _, t in per_order),
            )

        visible_tx, visible_rx, mask = self._visibility(scene)
        num_primitives = scene.mesh.num_primitives

        from .. import native

        if order > 0 and native.is_available():
            # Native DFS never materializes the unpruned candidate space —
            # O(num_filtered) memory instead of O(N * (N-1)**(order-1)).
            candidates = jnp.asarray(
                native.filtered_path_candidates(
                    num_primitives,
                    order,
                    from_adjacency=visible_tx,
                    to_adjacency=visible_rx,
                    node_mask=mask,
                )
            )
        elif order > 0:
            from ..geometry._candidates import generate_filtered_path_candidates

            vis_tx = jnp.asarray(visible_tx)
            vis_rx = jnp.asarray(visible_rx)
            mask_arr = jnp.asarray(mask) if mask is not None else None

            def keep_fn(chunk: Array) -> Array:
                keep = vis_tx[chunk[:, 0]] & vis_rx[chunk[:, -1]]
                if mask_arr is not None:
                    keep &= jnp.take(mask_arr, chunk, axis=0).all(axis=-1)
                return keep

            # Chunked decode -> filter -> concat: O(chunk + kept) memory
            # even for order-3 on 10k primitives (10^12 raw candidates).
            candidates = generate_filtered_path_candidates(
                num_primitives, order, keep_fn
            )
        else:
            candidates = generate_path_candidates(num_primitives, order)

        if scene.mesh.assume_quads:
            candidates = 2 * candidates
        return candidates, jnp.zeros_like(candidates, dtype=jnp.int32)

    @eqx.filter_jit
    def trace_path_candidates(
        self,
        scene: "Scene",
        path_candidates: Int[Array, "num_candidates order"],
        interaction_types: Int[Array, "num_candidates order"],
    ) -> TracedPaths:
        if isinstance(path_candidates, tuple):
            from ..geometry._paths import concatenate_paths

            return concatenate_paths([
                self.trace_path_candidates(scene, c, t)
                for c, t in zip(path_candidates, interaction_types, strict=True)
            ])
        return trace_path_candidates(
            scene.mesh,
            scene.transmitters.reshape(-1, 3),
            scene.receivers.reshape(-1, 3),
            path_candidates,
            interaction_types=interaction_types,
            epsilon=self.epsilon,
            hit_tol=self.hit_tol,
            min_len=self.min_len,
            smoothing_factor=self.smoothing_factor,
            confidence_threshold=self.confidence_threshold,
            batch_size=self.batch_size,
        )


class SBRPathLauncher(AbstractPathLauncher):
    """Shooting-and-bouncing-rays launcher.

    Reference parity: _solvers.py:1179-1226.
    """

    num_rays: int = int(1e6)
    """Number of launched rays."""
    epsilon: Float[ArrayLike, ""] | None = None
    """Tolerance for ray / object intersection checks."""
    hit_tol: Float[ArrayLike, ""] | None = None
    """Hit-distance tolerance when testing path segments for blockage."""
    max_dist: Float[ArrayLike, ""] = 1e-3
    """Maximal squared ray-to-receiver distance for capture."""

    def launch_rays(
        self, scene: "Scene"
    ) -> tuple[Float[Array, "num_tx num_rays 3"], Float[Array, "num_tx num_rays 3"]]:
        tx_vertices = scene.transmitters.reshape(-1, 3)
        rx_vertices = scene.receivers.reshape(-1, 3)
        num_tx = tx_vertices.shape[0]

        world_vertices = jnp.concatenate(
            (scene.mesh.triangle_vertices.reshape(-1, 3), rx_vertices), axis=0
        )
        frustums = jax.vmap(viewing_frustum, in_axes=(0, None))(
            tx_vertices, world_vertices
        )
        ray_origins = jnp.broadcast_to(
            tx_vertices[:, None, :], (num_tx, self.num_rays, 3)
        )
        ray_directions = jax.vmap(
            lambda f: fibonacci_lattice(self.num_rays, frustum=f)
        )(frustums)
        return ray_origins, ray_directions


_SOLVER_REGISTRY: dict[str, Callable[..., AbstractPathSolver]] = {
    "exhaustive": ExhaustivePathTracer,
    "hybrid": HybridPathTracer,
    "sbr": SBRPathLauncher,
}
