"""Accelerated ray-casting ops with Pallas (GPU) / plain-JAX dispatch.

This package replaces the reference's NVIDIA Warp kernel stack
(differt/src/differt/geometry/_mesh.py:142-401, bridged via host callbacks).
Here both backends run natively inside XLA:

- ``pallas``: culled any-hit and closest-hit kernels written in Pallas and
  compiled for the GPU through Triton (:mod:`differt_tpu.ops._pallas_rt`).
- ``jax``: the portable tiled scans of :mod:`differt_tpu.rt` (also the
  correctness references).

The closest-hit query is made differentiable with a custom VJP that
re-derives the hit distance from the frozen hit indices (the
substrate-independent trick from _mesh.py:226-344).
"""

from ._dispatch import (
    dispatch_first_triangle_hit_by_ray,
    dispatch_ray_intersect_any_triangle,
    dispatch_triangles_visible_from_vertex,
    get_backend,
    set_backend,
)

__all__ = [
    "dispatch_first_triangle_hit_by_ray",
    "dispatch_ray_intersect_any_triangle",
    "dispatch_triangles_visible_from_vertex",
    "get_backend",
    "set_backend",
]
