"""Culled any-hit and closest-hit ray casting as Pallas kernels (Triton route).

The reference casts rays through a Warp BVH (_mesh.py:142-401). Here the
mesh is Morton-sorted instead, so that every chunk of ``t_sub`` consecutive
triangles is spatially compact, and each chunk (and each tile of
``chunks_per_tile`` chunks) gets an axis-aligned bounding box. One program
owns a block of ``block_r`` rays and walks the boxes in a loop: a box is
opened only if some still-pending ray of the block reaches it, and only
then are its triangles tested, all ``t_sub x block_r`` pairs at once.

A ray is pending while its answer can still change. For any-hit, until it
is blocked; a negative threshold marks a ray whose answer does not matter,
and such a ray is never pending, so the dead segments of invalid path
candidates cost nothing. For closest-hit, while its slab interval starts
before its best hit so far, so geometry behind the first hits is skipped.

Per-ray state (the blocked flag, or the running ``(t, index)``) lives in
registers across the loop; no state passes between programs. Coordinates
are stored structure-of-arrays ([8, rays] and [9, triangles]) so every load
is a contiguous row. Masked-out and padding triangles have zero edges and
can never be hit.

The plain-JAX scans of :mod:`differt_tpu.rt` implement the same contracts
and are the reference these kernels are tested against.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .._typing import Array, Bool, Float, Int
from ..geometry._morton import morton_perm_points


class KernelConfig(NamedTuple):
    """Block shape and launch parameters of the ray-casting kernels."""

    block_r: int = 32
    """Rays per program (a power of two)."""
    t_sub: int = 8
    """Triangles per chunk: the unit of box culling and of one MT tile."""
    chunks_per_tile: int = 64
    """Chunks per tile: the coarse culling level."""
    num_warps: int = 1
    num_stages: int = 1


DEFAULT_CONFIG = KernelConfig()

# Slab-test reciprocal clamp: |d| below this is treated as +-1e-30, giving
# huge-but-finite slab distances (no 0 * inf NaNs, conservative).
_SLAB_TINY = 1e-30


def _chunk_boxes(tris: Array, active: Array, t_sub: int) -> Array:
    """Per-chunk boxes of the ``[9, T]`` v0/e1/e2 layout: ``[8, T // t_sub]``.

    Rows 0-2 hold the minimum corner, rows 3-5 the maximum corner, both
    widened by a margin relative to the scene extent so that rounding can
    never cull a grazing ray. A chunk without an active triangle gets an
    inverted box (min 1, max -1), which :func:`_slab` rejects.
    """
    v0 = tris[0:3]
    v1 = v0 + tris[3:6]
    v2 = v0 + tris[6:9]
    mn = jnp.minimum(jnp.minimum(v0, v1), v2)
    mx = jnp.maximum(jnp.maximum(v0, v1), v2)
    mn = jnp.where(active, mn, jnp.inf).reshape(3, -1, t_sub).min(axis=-1)
    mx = jnp.where(active, mx, -jnp.inf).reshape(3, -1, t_sub).max(axis=-1)
    empty = ~jnp.isfinite(mn[0])
    extent = jnp.max(jnp.where(empty, -jnp.inf, mx)) - jnp.min(
        jnp.where(empty, jnp.inf, mn)
    )
    margin = 1e-5 * jnp.where(jnp.isfinite(extent), jnp.abs(extent), 0.0) + 1e-12
    mn = jnp.where(empty, 1.0, mn - margin)
    mx = jnp.where(empty, -1.0, mx + margin)
    zeros = jnp.zeros((2, mn.shape[1]), mn.dtype)
    return jnp.concatenate((mn, mx, zeros), axis=0).astype(jnp.float32)


def _tile_boxes(chunk_boxes: Array, chunks_per_tile: int) -> Array:
    """Fold chunk boxes into tile boxes: ``[8, num_chunks // chunks_per_tile]``."""
    mn = chunk_boxes[0:3].reshape(3, -1, chunks_per_tile)
    mx = chunk_boxes[3:6].reshape(3, -1, chunks_per_tile)
    empty = mn[0:1] > mx[0:1]
    mn = jnp.where(empty, jnp.inf, mn).min(axis=-1)
    mx = jnp.where(empty, -jnp.inf, mx).max(axis=-1)
    none = ~jnp.isfinite(mn[0])
    mn = jnp.where(none, 1.0, mn)
    mx = jnp.where(none, -1.0, mx)
    zeros = jnp.zeros((2, mn.shape[1]), mn.dtype)
    return jnp.concatenate((mn, mx, zeros), axis=0)


def _any(mask: Array) -> Array:
    return jnp.max(mask.astype(jnp.int32)) > 0


def _slab(o, inv_d, box_ref, g, t_hi):
    """Conservative segment-vs-box test for every ray of the block.

    ``o``/``inv_d`` are 3-lists of ``[block_r]`` vectors, ``t_hi`` the
    per-ray upper bound of the parameter. Never a false miss for a ray
    whose ``[0, t_hi]`` segment touches box ``g``; an inverted box is a miss.
    """
    lo = [box_ref[c, g] for c in range(3)]
    hi = [box_ref[3 + c, g] for c in range(3)]
    tnear = jnp.zeros_like(o[0])
    tfar = t_hi
    for c in range(3):
        t1 = (lo[c] - o[c]) * inv_d[c]
        t2 = (hi[c] - o[c]) * inv_d[c]
        tnear = jnp.maximum(tnear, jnp.minimum(t1, t2))
        tfar = jnp.minimum(tfar, jnp.maximum(t1, t2))
    return (tnear <= tfar) & (lo[0] <= hi[0])


def _ray_block(rays_ref):
    """Origins, directions, slab reciprocals and row 6 of a ray block."""
    o = [rays_ref[c, :] for c in range(3)]
    d = [rays_ref[3 + c, :] for c in range(3)]
    inv_d = [
        1.0
        / jnp.where(
            jnp.abs(dc) < _SLAB_TINY,
            jnp.where(dc < 0.0, -_SLAB_TINY, _SLAB_TINY),
            dc,
        )
        for dc in d
    ]
    return o, d, inv_d, rays_ref[6, :]


def _moeller_trumbore(o, d, tris_ref, start, t_sub, epsilon):
    """``(t, hit)`` of a ``[t_sub, block_r]`` triangle-chunk x ray-block tile.

    The same arithmetic, in the same order, as
    :func:`differt_tpu.rt.ray_intersect_triangle`.
    """
    rows = [tris_ref[r, pl.ds(start, t_sub)][:, None] for r in range(9)]
    v0, e1, e2 = rows[0:3], rows[3:6], rows[6:9]
    o = [x[None, :] for x in o]
    d = [x[None, :] for x in d]

    h0 = d[1] * e2[2] - d[2] * e2[1]
    h1 = d[2] * e2[0] - d[0] * e2[2]
    h2 = d[0] * e2[1] - d[1] * e2[0]
    det = h0 * e1[0] + h1 * e1[1] + h2 * e1[2]
    inv_det = jnp.where(det == 0.0, 0.0, 1.0 / jnp.where(det == 0.0, 1.0, det))

    s0 = o[0] - v0[0]
    s1 = o[1] - v0[1]
    s2 = o[2] - v0[2]
    u = inv_det * (s0 * h0 + s1 * h1 + s2 * h2)

    q0 = s1 * e1[2] - s2 * e1[1]
    q1 = s2 * e1[0] - s0 * e1[2]
    q2 = s0 * e1[1] - s1 * e1[0]
    v = inv_det * (q0 * d[0] + q1 * d[1] + q2 * d[2])
    t = inv_det * (q0 * e2[0] + q1 * e2[1] + q2 * e2[2])

    hit = (
        (jnp.abs(det) > epsilon)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > epsilon)
    )
    return t, hit


def _anyhit_kernel(
    rays_ref, tris_ref, chunk_box_ref, tile_box_ref, out_ref, *, epsilon, cfg
):
    o, d, inv_d, thresh = _ray_block(rays_ref)
    num_tiles = tile_box_ref.shape[1]
    cpt = cfg.chunks_per_tile

    def pending(blocked):
        return blocked == 0

    def chunk_step(k, blocked, j):
        g = j * cpt + k

        def test(blocked):
            t, hit = _moeller_trumbore(
                o, d, tris_ref, g * cfg.t_sub, cfg.t_sub, epsilon
            )
            hit = hit & (t < thresh[None, :])
            return blocked | jnp.max(hit.astype(jnp.int32), axis=0)

        need = _any(_slab(o, inv_d, chunk_box_ref, g, thresh) & pending(blocked))
        return jax.lax.cond(need, test, lambda b: b, blocked)

    def tile_step(carry):
        j, blocked = carry

        def sweep(blocked):
            return jax.lax.fori_loop(
                0, cpt, lambda k, b: chunk_step(k, b, j), blocked
            )

        need = _any(_slab(o, inv_d, tile_box_ref, j, thresh) & pending(blocked))
        return j + 1, jax.lax.cond(need, sweep, lambda b: b, blocked)

    def more(carry):
        # A block whose rays are all blocked or dead stops early.
        j, blocked = carry
        alive = pending(blocked) & (thresh > 0.0)
        return (j < num_tiles) & _any(alive)

    blocked = jnp.zeros(thresh.shape, jnp.int32)
    _, blocked = jax.lax.while_loop(more, tile_step, (0, blocked))
    out_ref[0, :] = blocked


def _closest_kernel(
    rays_ref,
    tris_ref,
    chunk_box_ref,
    tile_box_ref,
    idx_ref,
    t_ref,
    *,
    epsilon,
    cfg,
):
    # Row 6 holds the initial best t: +inf for real rays, -inf for padding
    # (an empty slab interval, so padding never opens a box).
    o, d, inv_d, best_t0 = _ray_block(rays_ref)
    num_tiles = tile_box_ref.shape[1]
    cpt = cfg.chunks_per_tile
    lane = jax.lax.broadcasted_iota(jnp.int32, (cfg.t_sub, cfg.block_r), 0)

    def chunk_step(k, best, j):
        g = j * cpt + k

        def test(best):
            best_t, best_i = best
            start = g * cfg.t_sub
            t, hit = _moeller_trumbore(o, d, tris_ref, start, cfg.t_sub, epsilon)
            t = jnp.where(hit, t, jnp.inf)
            chunk_t = jnp.min(t, axis=0)
            # Lowest index among equal distances, as jnp.argmin.
            chunk_i = (
                jnp.min(jnp.where(t == chunk_t[None, :], lane, cfg.t_sub), axis=0)
                + start
            )
            # An equal distance in a later chunk wins, as in the scan's
            # combine step.
            closer = (chunk_t <= best_t) & (chunk_t < jnp.inf)
            return (
                jnp.where(closer, chunk_t, best_t),
                jnp.where(closer, chunk_i, best_i),
            )

        need = _any(_slab(o, inv_d, chunk_box_ref, g, best[0]))
        return jax.lax.cond(need, test, lambda b: b, best)

    def tile_step(j, best):
        def sweep(best):
            return jax.lax.fori_loop(0, cpt, lambda k, b: chunk_step(k, b, j), best)

        need = _any(_slab(o, inv_d, tile_box_ref, j, best[0]))
        return jax.lax.cond(need, sweep, lambda b: b, best)

    best = (best_t0, jnp.full(best_t0.shape, -1, jnp.int32))
    best_t, best_i = jax.lax.fori_loop(0, num_tiles, tile_step, best)
    idx_ref[0, :] = best_i
    t_ref[0, :] = best_t


def _pad_to(x: Array, size: int, axis: int, value) -> Array:
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=value)


def _prepare_triangles(
    triangle_vertices: Float[Array, "num_triangles 3 3"],
    active_triangles: Bool[Array, " num_triangles"] | None,
    cfg: KernelConfig,
):
    """Morton-sorted SoA triangles plus chunk and tile boxes.

    Returns ``(tris, chunk_boxes, tile_boxes, perm)`` where ``perm`` maps
    sorted positions back to the caller's triangle indices.
    """
    num_tris = triangle_vertices.shape[0]
    tile = cfg.t_sub * cfg.chunks_per_tile
    tris_padded = pl.cdiv(max(num_tris, 1), tile) * tile

    perm = morton_perm_points(triangle_vertices.mean(axis=1))
    triangle_vertices = jnp.take(triangle_vertices, perm, axis=0)
    v0 = triangle_vertices[:, 0, :]
    e1 = triangle_vertices[:, 1, :] - v0
    e2 = triangle_vertices[:, 2, :] - v0
    if active_triangles is None:
        active = jnp.ones((num_tris,), dtype=bool)
    else:
        active = jnp.take(active_triangles, perm)
    # Zero edges give det == 0: an inactive triangle is never hit.
    e1 = jnp.where(active[:, None], e1, 0.0)
    e2 = jnp.where(active[:, None], e2, 0.0)
    tris = jnp.concatenate((v0, e1, e2), axis=-1).T.astype(jnp.float32)
    tris = _pad_to(tris, tris_padded, 1, 0.0)
    active = _pad_to(active, tris_padded, 0, False)

    chunk_boxes = _chunk_boxes(tris, active, cfg.t_sub)
    tile_boxes = _tile_boxes(chunk_boxes, cfg.chunks_per_tile)
    return tris, chunk_boxes, tile_boxes, perm


def _prepare_rays(ray_origins, ray_directions, row6, pad_value, block_r):
    """``[8, rays_padded]`` SoA rays: origin, direction, per-ray bound, zero."""
    num_rays = ray_origins.shape[0]
    rays_padded = pl.cdiv(max(num_rays, 1), block_r) * block_r
    rays = jnp.concatenate(
        (
            ray_origins.T,
            ray_directions.T,
            row6[None, :],
            jnp.zeros((1, num_rays), ray_origins.dtype),
        ),
        axis=0,
    ).astype(jnp.float32)
    rays = _pad_to(rays, rays_padded, 1, 0.0)
    return rays.at[6, num_rays:].set(pad_value)


def _specs(rays, tris, chunk_boxes, tile_boxes, block_r):
    return [
        pl.BlockSpec((8, block_r), lambda i: (0, i)),
        pl.BlockSpec(tris.shape, lambda i: (0, 0)),
        pl.BlockSpec(chunk_boxes.shape, lambda i: (0, 0)),
        pl.BlockSpec(tile_boxes.shape, lambda i: (0, 0)),
    ]


def _compiler_params(cfg: KernelConfig):
    return pl_triton.CompilerParams(
        num_warps=cfg.num_warps, num_stages=cfg.num_stages
    )


def _check_compilable(interpret: bool) -> None:
    if not interpret and jax.default_backend() != "gpu":
        msg = (
            "The Pallas ray-casting kernels compile only for an NVIDIA GPU, "
            f"not for {jax.default_backend()!r}; use the 'jax' backend there, "
            "or ask for the interpreter explicitly with "
            "set_backend('pallas', interpret=True)."
        )
        raise RuntimeError(msg)


def _epsilon(epsilon) -> float:
    if epsilon is None:
        return 10.0 * float(jnp.finfo(jnp.float32).eps)
    return float(epsilon)


@functools.partial(jax.jit, static_argnames=("epsilon", "cfg", "interpret"))
def _run_anyhit(rays, tris, chunk_boxes, tile_boxes, *, epsilon, cfg, interpret):
    out = pl.pallas_call(
        functools.partial(_anyhit_kernel, epsilon=epsilon, cfg=cfg),
        out_shape=jax.ShapeDtypeStruct((1, rays.shape[1]), jnp.int32),
        grid=(rays.shape[1] // cfg.block_r,),
        in_specs=_specs(rays, tris, chunk_boxes, tile_boxes, cfg.block_r),
        out_specs=pl.BlockSpec((1, cfg.block_r), lambda i: (0, i)),
        compiler_params=_compiler_params(cfg),
        interpret=interpret,
        name="ray_intersect_any_triangle",
    )(rays, tris, chunk_boxes, tile_boxes)
    return out[0] > 0


@functools.partial(jax.jit, static_argnames=("epsilon", "cfg", "interpret"))
def _run_closest(rays, tris, chunk_boxes, tile_boxes, *, epsilon, cfg, interpret):
    spec = pl.BlockSpec((1, cfg.block_r), lambda i: (0, i))
    idx, t = pl.pallas_call(
        functools.partial(_closest_kernel, epsilon=epsilon, cfg=cfg),
        out_shape=(
            jax.ShapeDtypeStruct((1, rays.shape[1]), jnp.int32),
            jax.ShapeDtypeStruct((1, rays.shape[1]), jnp.float32),
        ),
        grid=(rays.shape[1] // cfg.block_r,),
        in_specs=_specs(rays, tris, chunk_boxes, tile_boxes, cfg.block_r),
        out_specs=(spec, spec),
        compiler_params=_compiler_params(cfg),
        interpret=interpret,
        name="first_triangle_hit_by_ray",
    )(rays, tris, chunk_boxes, tile_boxes)
    return idx[0], t[0]


def _flatten_rays(ray_origins, ray_directions):
    batch = jnp.broadcast_shapes(ray_origins.shape[:-1], ray_directions.shape[:-1])
    ray_origins = jnp.broadcast_to(ray_origins, (*batch, 3)).reshape(-1, 3)
    ray_directions = jnp.broadcast_to(ray_directions, (*batch, 3)).reshape(-1, 3)
    return batch, ray_origins, ray_directions


def pallas_ray_intersect_any_triangle(
    ray_origins: Float[Array, "*batch 3"],
    ray_directions: Float[Array, "*batch 3"],
    triangle_vertices: Float[Array, "num_triangles 3 3"],
    active_triangles: Bool[Array, " num_triangles"] | None = None,
    *,
    hit_threshold: Float[Array, "*#batch"] | float = 1.0,
    epsilon: Float[Array, ""] | float | None = None,
    interpret: bool = False,
    config: KernelConfig = DEFAULT_CONFIG,
) -> Bool[Array, " *batch"]:
    """Any-hit occlusion test: does each ray hit anything before ``t = thr``.

    Same contract as :func:`differt_tpu.rt.ray_intersect_any_triangle` with
    ``hit_threshold = 1 - hit_tol``. ``hit_threshold`` may be per ray; a
    negative value marks a ray whose answer does not matter (it reports
    "not blocked" and costs no triangle tests).
    """
    _check_compilable(interpret)
    batch, ray_origins, ray_directions = _flatten_rays(ray_origins, ray_directions)
    num_rays = ray_origins.shape[0]
    thresh = jnp.broadcast_to(
        jnp.asarray(hit_threshold, dtype=jnp.float32), batch
    ).reshape(-1)
    rays = _prepare_rays(ray_origins, ray_directions, thresh, -1.0, config.block_r)
    tris, chunk_boxes, tile_boxes, _ = _prepare_triangles(
        triangle_vertices, active_triangles, config
    )
    out = _run_anyhit(
        rays,
        tris,
        chunk_boxes,
        tile_boxes,
        epsilon=_epsilon(epsilon),
        cfg=config,
        interpret=interpret,
    )
    return out[:num_rays].reshape(batch)


def pallas_first_triangle_hit_by_ray(
    ray_origins: Float[Array, "*batch 3"],
    ray_directions: Float[Array, "*batch 3"],
    triangle_vertices: Float[Array, "num_triangles 3 3"],
    active_triangles: Bool[Array, " num_triangles"] | None = None,
    *,
    epsilon: Float[Array, ""] | float | None = None,
    interpret: bool = False,
    config: KernelConfig = DEFAULT_CONFIG,
) -> tuple[Int[Array, " *batch"], Float[Array, " *batch"]]:
    """Closest-hit query: ``(index, t)`` of the first triangle hit (-1/inf).

    Same contract as :func:`differt_tpu.rt.first_triangle_hit_by_ray`, up to
    the choice among triangles hit at exactly the same distance.
    """
    _check_compilable(interpret)
    batch, ray_origins, ray_directions = _flatten_rays(ray_origins, ray_directions)
    num_rays = ray_origins.shape[0]
    init_t = jnp.full((num_rays,), jnp.inf, jnp.float32)
    rays = _prepare_rays(
        ray_origins, ray_directions, init_t, -jnp.inf, config.block_r
    )
    tris, chunk_boxes, tile_boxes, perm = _prepare_triangles(
        triangle_vertices, active_triangles, config
    )
    idx, t = _run_closest(
        rays,
        tris,
        chunk_boxes,
        tile_boxes,
        epsilon=_epsilon(epsilon),
        cfg=config,
        interpret=interpret,
    )
    idx = idx[:num_rays].reshape(batch)
    t = t[:num_rays].reshape(batch)
    hit = idx >= 0
    # The kernel reports positions in the Morton-sorted order; map back.
    idx = jnp.take(perm, idx.clip(min=0))
    return jnp.where(hit, idx, -1), jnp.where(hit, t, jnp.inf)
