"""Validate the Pallas ray-cast kernels against the plain-JAX scans.

Off the GPU the kernels run only when the interpreter is asked for
explicitly (``interpret=True``); these tests do so and compare with
:mod:`differt_tpu.rt`. The compiled kernels are checked on the card by
``chip_smoke.py`` (phase 2).
"""

import chex
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from differt_tpu.geometry import Mesh, fibonacci_lattice
from differt_tpu.ops import get_backend, set_backend
from differt_tpu.ops._pallas_rt import (
    DEFAULT_CONFIG,
    KernelConfig,
    pallas_first_triangle_hit_by_ray,
    pallas_ray_intersect_any_triangle,
)
from differt_tpu.rt import first_triangle_hit_by_ray, ray_intersect_any_triangle

# Small blocks keep the interpreter fast and force several ray blocks,
# chunks and tiles even on these small meshes.
SMALL = KernelConfig(block_r=32, t_sub=4, chunks_per_tile=2)


def anyhit(o, d, tv, active=None, **kwargs):
    return pallas_ray_intersect_any_triangle(
        o, d, tv, active, interpret=True, config=kwargs.pop("config", SMALL), **kwargs
    )


def closest(o, d, tv, active=None, config=SMALL):
    return pallas_first_triangle_hit_by_ray(
        o, d, tv, active, interpret=True, config=config
    )


@pytest.fixture(scope="module")
def box_rays():
    mesh = Mesh.box(2.0, 1.5, 1.0, with_top=True)
    key = jax.random.key(0)
    origins = jax.random.uniform(key, (200, 3), minval=-0.3, maxval=0.3)
    directions = fibonacci_lattice(200) * 3.0
    return mesh, origins, directions


def test_anyhit_matches_oracle(box_rays) -> None:
    mesh, origins, directions = box_rays
    tv = mesh.triangle_vertices
    got = anyhit(origins, directions, tv)
    expected = ray_intersect_any_triangle(origins, directions, tv, hit_tol=0.0)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))


def test_anyhit_threshold(box_rays) -> None:
    mesh, origins, directions = box_rays
    tv = mesh.triangle_vertices
    for thr in (0.05, 0.3):
        got = anyhit(origins, directions, tv, hit_threshold=thr)
        expected = ray_intersect_any_triangle(
            origins, directions, tv, hit_tol=1.0 - thr
        )
        np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))


def test_closest_hit_matches_oracle(box_rays) -> None:
    mesh, origins, directions = box_rays
    tv = mesh.triangle_vertices
    idx_got, t_got = closest(origins, directions, tv)
    idx_exp, t_exp = first_triangle_hit_by_ray(origins, directions, tv)
    np.testing.assert_array_equal(np.asarray(idx_got), np.asarray(idx_exp))
    chex.assert_trees_all_close(t_got, t_exp, atol=1e-6)


def test_closest_hit_active_mask(box_rays) -> None:
    mesh, origins, directions = box_rays
    tv = mesh.triangle_vertices
    active = jnp.arange(mesh.num_triangles) % 3 != 0
    idx_got, t_got = closest(origins, directions, tv, active)
    idx_exp, t_exp = first_triangle_hit_by_ray(origins, directions, tv, active)
    np.testing.assert_array_equal(np.asarray(idx_got), np.asarray(idx_exp))
    chex.assert_trees_all_close(t_got, t_exp, atol=1e-6)


def test_many_triangles_multi_tile() -> None:
    # More triangles than one default tile (t_sub * chunks_per_tile = 512)
    # exercises the loop over tiles and the tile-level culling.
    key = jax.random.key(3)
    meshes = [Mesh.box(1.0 + 0.1 * i, 1.0, 1.0, with_top=True) for i in range(60)]
    mesh = meshes[0]
    for m in meshes[1:]:
        mesh = mesh + m
    assert mesh.num_triangles > 512
    origins = jax.random.uniform(key, (64, 3), minval=-0.3, maxval=0.3)
    directions = fibonacci_lattice(64) * 3.0
    tv = mesh.triangle_vertices
    idx_got, t_got = closest(origins, directions, tv, config=DEFAULT_CONFIG)
    idx_exp, t_exp = first_triangle_hit_by_ray(origins, directions, tv)
    chex.assert_trees_all_close(t_got, t_exp, atol=1e-5)
    # This mesh stacks many exactly-coincident wall triangles, so the
    # chosen index may legitimately differ between tie-breaking orders; the
    # chosen triangle must be an actual hit at the same distance.
    from differt_tpu.rt import ray_intersect_triangle

    t_direct, hit_direct = ray_intersect_triangle(
        origins, directions, tv[idx_got.clip(min=0)]
    )
    valid = np.asarray(idx_got) >= 0
    assert np.asarray(hit_direct)[valid].all()
    chex.assert_trees_all_close(t_direct[valid], t_got[valid], atol=1e-5)


@pytest.fixture(scope="module")
def canyon():
    from differt_tpu.scenes import street_canyon_scene

    return street_canyon_scene().mesh.triangle_vertices


def rand_rays(n, salt):
    k1, k2 = jax.random.split(jax.random.fold_in(jax.random.key(42), salt))
    origins = jax.random.uniform(k1, (n, 3), minval=-40.0, maxval=40.0)
    origins = origins.at[:, 2].set(jnp.abs(origins[:, 2]) + 1.0)
    return origins, jax.random.normal(k2, (n, 3)) * 30.0


@pytest.mark.parametrize("num_rays", [1, 33, 257])
def test_anyhit_odd_ray_counts(canyon, num_rays: int) -> None:
    o, d = rand_rays(num_rays, num_rays)
    got = anyhit(o, d, canyon, hit_threshold=0.98)
    expected = ray_intersect_any_triangle(o, d, canyon, hit_tol=0.02, batch_size=8)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))


def test_anyhit_active_mask(canyon) -> None:
    o, d = rand_rays(300, 1)
    active = (jnp.arange(canyon.shape[0]) % 5) != 2
    got = anyhit(o, d, canyon, active, hit_threshold=0.98)
    expected = ray_intersect_any_triangle(o, d, canyon, active, hit_tol=0.02)
    assert 0 < int(expected.sum()) < 300
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))


def test_anyhit_negative_thresholds(canyon) -> None:
    # A negative per-ray threshold marks a ray whose answer does not
    # matter: it reports "not blocked" whatever it would hit.
    o, d = rand_rays(300, 2)
    dead = (jnp.arange(300) % 3) == 0
    thr = jnp.where(dead, -1.0, 0.98)
    got = np.asarray(anyhit(o, d, canyon, hit_threshold=thr))
    expected = np.asarray(
        ray_intersect_any_triangle(o, d, canyon, hit_tol=0.02)
    ) & ~np.asarray(dead)
    assert not got[np.asarray(dead)].any()
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("num_rays", [7, 129])
def test_closest_hit_odd_ray_counts(canyon, num_rays: int) -> None:
    o, d = rand_rays(num_rays, 100 + num_rays)
    active = (jnp.arange(canyon.shape[0]) % 7) != 3
    i_p, t_p = map(np.asarray, closest(o, d, canyon, active))
    i_x, t_x = map(
        np.asarray, first_triangle_hit_by_ray(o, d, canyon, active, batch_size=8)
    )
    # The canyon has coincident coplanar faces: a ray hitting one can
    # resolve to either triangle at the same distance.
    both = np.isfinite(t_p) & np.isfinite(t_x)
    gap = np.abs(np.where(both, t_p, 0.0) - np.where(both, t_x, 0.0))
    tie = both & (gap <= 1e-6 + 1e-5 * np.abs(t_x))
    assert np.all((i_p == i_x) | tie)
    np.testing.assert_allclose(
        np.where(np.isfinite(t_p), t_p, -1.0),
        np.where(np.isfinite(t_x), t_x, -1.0),
        rtol=1e-5,
        atol=1e-6,
    )


@pytest.mark.parametrize(
    "config",
    [
        KernelConfig(block_r=16, t_sub=8, chunks_per_tile=1),
        KernelConfig(block_r=64, t_sub=2, chunks_per_tile=8),
        KernelConfig(block_r=128, t_sub=16, chunks_per_tile=2),
    ],
    ids=str,
)
def test_block_shapes_agree(canyon, config: KernelConfig) -> None:
    o, d = rand_rays(150, 7)
    got = anyhit(o, d, canyon, hit_threshold=0.98, config=config)
    expected = ray_intersect_any_triangle(o, d, canyon, hit_tol=0.02)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))
    _, t_p = closest(o, d, canyon, config=config)
    _, t_x = first_triangle_hit_by_ray(o, d, canyon)
    np.testing.assert_allclose(
        np.where(np.isfinite(t_p), t_p, -1.0),
        np.where(np.isfinite(t_x), t_x, -1.0),
        rtol=1e-5,
        atol=1e-6,
    )


@pytest.mark.parametrize(
    "kernel", [pallas_ray_intersect_any_triangle, pallas_first_triangle_hit_by_ray]
)
def test_compiled_kernels_refuse_the_cpu(box_rays, kernel) -> None:
    # Interpretation happens only on request, never as a quiet fallback.
    mesh, origins, directions = box_rays
    with pytest.raises(RuntimeError, match="compile only for an NVIDIA GPU"):
        kernel(origins, directions, mesh.triangle_vertices)


def test_pallas_backend_without_interpret_raises(box_rays) -> None:
    mesh, origins, directions = box_rays
    set_backend("pallas")
    try:
        with pytest.raises(RuntimeError, match="interpret=True"):
            mesh.ray_intersect_any_triangle(origins, directions)
    finally:
        set_backend("auto")


@pytest.mark.parametrize(("platform", "expected"), [("gpu", "pallas"), ("cpu", "jax")])
def test_auto_backend_choice(monkeypatch, platform: str, expected: str) -> None:
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert get_backend() == expected


def test_set_backend_rejects_unknown() -> None:
    with pytest.raises(ValueError, match="Unknown backend"):
        set_backend("cuda")
    assert get_backend() == "jax"  # auto on the CPU


@pytest.mark.gpu
def test_compiled_kernels_on_the_gpu(canyon) -> None:
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py phase 2 runs this check")
    o, d = rand_rays(4096, 9)
    got = pallas_ray_intersect_any_triangle(o, d, canyon, hit_threshold=0.98)
    expected = ray_intersect_any_triangle(o, d, canyon, hit_tol=0.02)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))
