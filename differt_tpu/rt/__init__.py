"""Ray tracing: kernels, path solvers, and launchers.

API parity with ``differt.rt`` (differt/src/differt/rt/__init__.py), but all
accelerated paths run inside XLA (Pallas / XLA) instead of Warp CUDA.
"""

from ..geometry._candidates import (
    SizedIterator,
    generate_all_path_candidates,
    generate_all_path_candidates_chunks_iter,
    generate_all_path_candidates_iter,
)
from ._image_method import (
    consecutive_vertices_are_on_same_side_of_mirror,
    image_method,
    image_of_vertex_with_respect_to_mirror,
    intersection_of_ray_with_plane,
)
from ._diffraction import (
    DiffractionPathTracer,
    diffraction_amplitudes,
    diffraction_point_on_edge,
)
from ._fermat import (
    fermat_path_on_linear_objects,
    fermat_path_on_planar_mirrors,
)
from ._mixed import (
    MixedPathTracer,
    count_mixed_path_candidates,
    generate_mixed_path_candidates,
    mixed_amplitudes,
)
from ._mlm import compute_tx_mlm
from ._scattering import (
    ScatteringPathTracer,
    directive_pattern_normalization,
    scattering_amplitudes,
    triangle_sample_points,
)
from ._scan import (
    first_triangle_hit_by_ray,
    ray_intersect_any_triangle,
    triangles_visible_from_vertex,
)
from ._solvers import (
    AbstractPathLauncher,
    AbstractPathSolver,
    AbstractPathTracer,
    ExhaustivePathTracer,
    HybridPathTracer,
    SBRPathLauncher,
    trace_path_candidates,
)
from ._triangle import (
    ray_intersect_triangle,
    triangle_contains_vertex_assuming_inside_same_plane,
)

__all__ = [
    "AbstractPathLauncher",
    "AbstractPathSolver",
    "AbstractPathTracer",
    "DiffractionPathTracer",
    "ExhaustivePathTracer",
    "diffraction_amplitudes",
    "diffraction_point_on_edge",
    "HybridPathTracer",
    "MixedPathTracer",
    "SBRPathLauncher",
    "ScatteringPathTracer",
    "SizedIterator",
    "directive_pattern_normalization",
    "scattering_amplitudes",
    "triangle_sample_points",
    "compute_tx_mlm",
    "count_mixed_path_candidates",
    "generate_mixed_path_candidates",
    "mixed_amplitudes",
    "consecutive_vertices_are_on_same_side_of_mirror",
    "fermat_path_on_linear_objects",
    "fermat_path_on_planar_mirrors",
    "first_triangle_hit_by_ray",
    "generate_all_path_candidates",
    "generate_all_path_candidates_chunks_iter",
    "generate_all_path_candidates_iter",
    "image_method",
    "image_of_vertex_with_respect_to_mirror",
    "intersection_of_ray_with_plane",
    "ray_intersect_any_triangle",
    "ray_intersect_triangle",
    "trace_path_candidates",
    "triangle_contains_vertex_assuming_inside_same_plane",
    "triangles_visible_from_vertex",
]
