"""The trace pipeline under the Pallas backend matches the "jax" backend.

The blockage check of every traced path runs through the any-hit kernel
when the backend is "pallas"; here the kernel is interpreted (asked for
explicitly) and the whole trace is compared with the plain-JAX backend.
"""

import chex
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from differt_tpu.geometry import Mesh, Scene, generate_all_path_candidates
from differt_tpu.ops import set_backend
from differt_tpu.rt import trace_path_candidates


@pytest.fixture(autouse=True)
def _restore_backend():
    yield
    set_backend("auto")


def under(backend: str, fn):
    if backend == "pallas":
        set_backend("pallas", interpret=True)
    else:
        set_backend("jax")
    return fn()


def run_both(scene: Scene, order: int):
    mesh = scene.mesh
    tx = scene.transmitters.reshape(-1, 3)
    rx = scene.receivers.reshape(-1, 3)
    candidates = generate_all_path_candidates(mesh.num_primitives, order)
    if mesh.assume_quads:
        candidates = 2 * candidates
    types = jnp.zeros_like(candidates, dtype=jnp.int32)

    def trace():
        return trace_path_candidates(mesh, tx, rx, candidates, types)

    return under("jax", trace), under("pallas", trace)


def assert_same(reference, got) -> None:
    np.testing.assert_array_equal(np.asarray(got.mask), np.asarray(reference.mask))
    valid = np.asarray(reference.mask)
    chex.assert_trees_all_close(
        jnp.asarray(np.asarray(got.vertices)[valid]),
        jnp.asarray(np.asarray(reference.vertices)[valid]),
        atol=1e-4,
    )


@pytest.mark.parametrize("order", [1, 2])
def test_matches_xla_pipeline(order: int) -> None:
    mesh = Mesh.box(length=10.0, width=3.0, height=2.0, with_top=True)
    scene = Scene(
        transmitters=jnp.array([[-4.0, 0.0, 0.0]]),
        receivers=jnp.array([[4.0, 0.0, 0.0], [3.0, 0.5, 0.3]]),
        mesh=mesh,
    )
    reference, got = run_both(scene, order)
    assert int(np.asarray(reference.mask).sum()) > 0
    assert_same(reference, got)


def test_matches_with_masked_mesh() -> None:
    mesh = Mesh.box(length=10.0, width=3.0, height=2.0, with_top=True)
    mask = jnp.ones(mesh.num_triangles, dtype=bool).at[:2].set(False)
    scene = Scene(
        transmitters=jnp.array([[-4.0, 0.0, 0.0]]),
        receivers=jnp.array([[4.0, 0.0, 0.0]]),
        mesh=mesh.set_mask(mask),
    )
    reference, got = run_both(scene, 1)
    assert_same(reference, got)


def test_multi_tx_multi_rx_grid() -> None:
    mesh = Mesh.box(length=20.0, width=8.0, height=6.0, with_top=True)
    scene = Scene(
        transmitters=jnp.array([[-6.0, 0.0, 0.0], [6.0, 1.0, 1.0]]),
        receivers=jnp.array(
            [[x, y, 0.0] for x in (-3.0, 0.0, 3.0) for y in (-1.0, 1.0)]
        ),
        mesh=mesh,
    )
    reference, got = run_both(scene, 1)
    assert int(np.asarray(reference.mask).sum()) > 0
    assert_same(reference, got)


def test_gradient_matches_xla() -> None:
    """TX-position gradients do not depend on the blockage backend."""
    mesh = Mesh.box(length=10.0, width=3.0, height=2.0, with_top=True)
    rx = jnp.array([[4.0, 0.0, 0.0], [3.0, 0.5, 0.3]])
    candidates = generate_all_path_candidates(mesh.num_primitives, 1)
    types = jnp.zeros_like(candidates, dtype=jnp.int32)

    def total_length(tx):
        paths = trace_path_candidates(mesh, tx.reshape(-1, 3), rx, candidates, types)
        seg = jnp.diff(paths.vertices, axis=-2)
        lengths = jnp.sqrt(jnp.sum(seg * seg, axis=-1) + 1e-12).sum(axis=-1)
        return jnp.sum(jnp.where(paths.mask, lengths, 0.0))

    tx = jnp.array([-4.0, 0.1, 0.2])
    g_xla = under("jax", lambda: jax.grad(total_length)(tx))
    g_pallas = under("pallas", lambda: jax.grad(total_length)(tx))
    assert bool(jnp.isfinite(g_pallas).all())
    assert float(jnp.abs(g_pallas).max()) > 0.0
    chex.assert_trees_all_close(g_pallas, g_xla, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("order", [1, 2])
def test_matches_xla_pipeline_with_quads(order: int) -> None:
    # Quad meshes test two triangles per mirror; a reflection point may
    # land inside either one.
    mesh = Mesh.box(length=10.0, width=3.0, height=2.0, with_top=True)
    scene = Scene(
        transmitters=jnp.array([[-4.0, 0.0, 0.0], [0.0, 1.0, 0.5]]),
        receivers=jnp.array([[4.0, 0.0, 0.0], [3.0, 0.5, 0.3]]),
        mesh=mesh.set_assume_quads(),
    )
    reference, got = run_both(scene, order)
    assert int(np.asarray(reference.mask).sum()) > 0
    assert_same(reference, got)


def test_sbr_launch_matches_xla() -> None:
    """SBR bounces run through the closest-hit kernel under "pallas"."""
    from differt_tpu.scenes import street_canyon_scene

    scene = street_canyon_scene()
    scene = Scene(
        transmitters=jnp.array([-30.0, 0.0, 20.0]),
        receivers=jnp.array([[0.0, 1.0, 1.5], [10.0, -2.0, 1.5]]),
        mesh=scene.mesh,
    )

    def launch():
        return scene.launch_paths(order=2, num_rays=512)

    reference = under("jax", launch)
    got = under("pallas", launch)
    objects, ref_objects = np.asarray(got.objects), np.asarray(reference.objects)
    assert (objects[..., 1] >= 0).any()
    assert (objects == ref_objects).mean() > 0.99
    np.testing.assert_array_equal(np.asarray(got.masks), np.asarray(reference.masks))
