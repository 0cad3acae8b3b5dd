"""Tests for mixed reflection+diffraction path tracing and fields."""

import itertools

import chex
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from differt_tpu.coverage import complex_amplitudes
from differt_tpu.em import InteractionType
from differt_tpu.geometry import Mesh, Scene
from differt_tpu.rt import (
    MixedPathTracer,
    count_mixed_path_candidates,
    diffraction_amplitudes,
    generate_mixed_path_candidates,
    mixed_amplitudes,
)

R = InteractionType.REFLECTION
D = InteractionType.DIFFRACTION
FREQUENCY = 2.4e9
ETA_R = jnp.array([5.24])
CONDUCTIVITY = jnp.array([0.1])


@pytest.fixture
def knife_edge_scene() -> Scene:
    """Ground plane + box obstacle; single-edge diffraction TX->edge->RX."""
    ground = Mesh.plane(
        jnp.array([0.0, 0.0, 0.0]),
        normal=jnp.array([0.0, 0.0, 1.0]),
        side_length=40.0,
    )
    box = Mesh.box(2.0, 6.0, 3.0, with_top=True).translate(
        jnp.array([0.0, 0.0, 1.5])
    )
    mesh = (ground + box).dedup_vertices().set_materials("Concrete")
    return Scene(
        transmitters=jnp.array([[-8.0, 0.0, 1.6]]),
        receivers=jnp.array([[8.0, 0.0, 5.0]]),
        mesh=mesh,
    )


@pytest.fixture
def corridor_scene() -> Scene:
    mesh = Mesh.box(10.0, 3.0, 2.0, with_top=True).set_materials("Concrete")
    return Scene(
        transmitters=jnp.array([[-4.0, 0.0, 0.0]]),
        receivers=jnp.array([[4.0, 0.0, 0.0]]),
        mesh=mesh,
    )


class TestMixedCandidates:
    def test_full_product_row_major(self) -> None:
        got = np.asarray(generate_mixed_path_candidates((3, 2, 4)))
        want = np.array(list(itertools.product(range(3), range(2), range(4))))
        np.testing.assert_array_equal(got, want)
        assert count_mixed_path_candidates((3, 2, 4)) == 24

    def test_sharded_ranges_concatenate(self) -> None:
        full = np.asarray(generate_mixed_path_candidates((5, 3)))
        parts = [
            np.asarray(generate_mixed_path_candidates((5, 3), start=s, size=4))
            for s in range(0, 15, 4)
        ]
        np.testing.assert_array_equal(np.concatenate(parts)[:15], full)

    def test_zero_size_slot(self) -> None:
        assert generate_mixed_path_candidates((4, 0)).shape == (0, 2)
        assert count_mixed_path_candidates((4, 0)) == 0


class TestMixedGeometry:
    def test_pure_reflection_matches_exhaustive(self, corridor_scene: Scene) -> None:
        mixed = MixedPathTracer().trace_paths(corridor_scene, [R])
        exact = corridor_scene.trace_paths(order=1)
        assert int(mixed.mask.sum()) == int(exact.mask.sum())
        got = np.sort(
            np.asarray(mixed.vertices[np.asarray(mixed.mask)])[:, 1], axis=0
        )
        want = np.sort(
            np.asarray(exact.vertices[np.asarray(exact.mask)])[:, 1], axis=0
        )
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_pure_diffraction_matches_closed_form(
        self, knife_edge_scene: Scene
    ) -> None:
        mixed = MixedPathTracer().trace_paths(knife_edge_scene, [D])
        closed = knife_edge_scene.trace_diffraction_paths()
        assert int(mixed.mask.sum()) == int(closed.mask.sum()) == 1
        got = np.asarray(mixed.vertices[np.asarray(mixed.mask)])[0, 1]
        want = np.asarray(closed.vertices[np.asarray(closed.mask)])[0, 1]
        np.testing.assert_allclose(got, want, atol=5e-3)

    def test_reflection_diffraction_path(self, knife_edge_scene: Scene) -> None:
        """Ground bounce then over-the-top diffraction; hand-checkable."""
        paths = MixedPathTracer().trace_paths(knife_edge_scene, [R, D])
        assert int(paths.mask.sum()) == 1
        v = np.asarray(paths.vertices[np.asarray(paths.mask)])[0]
        tx, ground_pt, edge_pt, rx = v
        # Ground point: image of TX in z=0 aimed at the edge point (-1, 0, 3).
        np.testing.assert_allclose(ground_pt[2], 0.0, atol=1e-3)
        x_expected = -8.0 + 7.0 * 1.6 / 4.6
        np.testing.assert_allclose(ground_pt[0], x_expected, atol=5e-3)
        np.testing.assert_allclose(edge_pt, [-1.0, 0.0, 3.0], atol=5e-3)
        # Specular law at the ground.
        k_in = (ground_pt - tx) / np.linalg.norm(ground_pt - tx)
        k_out = (edge_pt - ground_pt) / np.linalg.norm(edge_pt - ground_pt)
        np.testing.assert_allclose(k_in[2], -k_out[2], atol=1e-3)
        # Keller cone at the edge (edge runs along y).
        k_in2 = (edge_pt - ground_pt) / np.linalg.norm(edge_pt - ground_pt)
        k_out2 = (rx - edge_pt) / np.linalg.norm(rx - edge_pt)
        np.testing.assert_allclose(k_in2[1], k_out2[1], atol=1e-3)

    def test_interaction_types_and_objects(self, knife_edge_scene: Scene) -> None:
        paths = MixedPathTracer().trace_paths(knife_edge_scene, [R, D])
        assert paths.interaction_types.shape[-1] == 2
        types = np.asarray(paths.interaction_types).reshape(-1, 2)
        assert (types[:, 0] == int(R)).all()
        assert (types[:, 1] == int(D)).all()

    def test_quads_rejected(self, corridor_scene: Scene) -> None:
        scene = corridor_scene.set_assume_quads()
        with pytest.raises(ValueError, match="triangle mesh"):
            MixedPathTracer().trace_paths(scene, [R])

    def test_scene_convenience_method(self, knife_edge_scene: Scene) -> None:
        paths = knife_edge_scene.trace_mixed_paths([D])
        assert int(paths.mask.sum()) == 1


class TestMixedAmplitudes:
    def _edges_info(self, scene: Scene):
        mesh = (
            scene.mesh
            if scene.mesh.assume_unique_vertices
            else scene.mesh.dedup_vertices()
        )
        return mesh._diffraction_edges_info()

    def test_single_diffraction_matches_utd(self, knife_edge_scene: Scene) -> None:
        edges, adj, wn = self._edges_info(knife_edge_scene)
        mixed = MixedPathTracer().trace_paths(knife_edge_scene, [D])
        a_mixed = mixed_amplitudes(
            mixed,
            knife_edge_scene,
            FREQUENCY,
            edges=edges,
            adjacent_triangles=adj,
            wedge_n=wn,
            eta_r=ETA_R,
            conductivity=CONDUCTIVITY,
        )
        closed = knife_edge_scene.trace_diffraction_paths()
        a_ref = diffraction_amplitudes(
            closed,
            knife_edge_scene,
            FREQUENCY,
            edges=edges,
            adjacent_triangles=adj,
            wedge_n=wn,
            eta_r=ETA_R,
            conductivity=CONDUCTIVITY,
        )
        got = complex(np.asarray(a_mixed)[np.asarray(mixed.mask)][0])
        want = complex(np.asarray(a_ref)[np.asarray(closed.mask)][0])
        # The Fermat point sits ~1e-3 off the closed-form one: compare
        # magnitudes tightly and phases loosely.
        np.testing.assert_allclose(abs(got), abs(want), rtol=1e-3)

    def test_pure_reflection_matches_jones_chain(
        self, corridor_scene: Scene
    ) -> None:
        edges, adj, wn = self._edges_info(corridor_scene)
        mixed = MixedPathTracer().trace_paths(corridor_scene, [R])
        a_mixed = mixed_amplitudes(
            mixed,
            corridor_scene,
            FREQUENCY,
            edges=edges,
            adjacent_triangles=adj,
            wedge_n=wn,
            eta_r=ETA_R,
            conductivity=CONDUCTIVITY,
        )
        exact = corridor_scene.trace_paths(order=1)
        a_ref = complex_amplitudes(
            exact, corridor_scene, FREQUENCY, eta_r=ETA_R, conductivity=CONDUCTIVITY
        )
        got = np.sort(np.abs(np.asarray(a_mixed)[np.asarray(mixed.mask)]))
        want = np.sort(np.abs(np.asarray(a_ref)[np.asarray(exact.mask)]))
        np.testing.assert_allclose(got, want, rtol=1e-4)

    def test_mixed_amplitude_finite_and_differentiable(
        self, knife_edge_scene: Scene
    ) -> None:
        edges, adj, wn = self._edges_info(knife_edge_scene)
        paths = MixedPathTracer().trace_paths(knife_edge_scene, [R, D])

        def power(eta_r):
            a = mixed_amplitudes(
                paths,
                knife_edge_scene,
                FREQUENCY,
                edges=edges,
                adjacent_triangles=adj,
                wedge_n=wn,
                eta_r=eta_r,
                conductivity=CONDUCTIVITY,
            )
            return jnp.sum(jnp.abs(a) ** 2)


        value, grad = jax.value_and_grad(power)(ETA_R)
        assert bool(jnp.isfinite(value)) and value > 0.0
        assert bool(jnp.isfinite(grad).all())
        assert bool((grad != 0.0).any())


class TestDoubleDiffraction:
    def test_over_the_top_path(self) -> None:
        """Both endpoints low: over-the-top needs double diffraction."""
        ground = Mesh.plane(
            jnp.array([0.0, 0.0, 0.0]),
            normal=jnp.array([0.0, 0.0, 1.0]),
            side_length=40.0,
        )
        box = Mesh.box(2.0, 6.0, 3.0, with_top=True).translate(
            jnp.array([0.0, 0.0, 1.5])
        )
        mesh = (ground + box).dedup_vertices().set_materials("Concrete")
        scene = Scene(
            transmitters=jnp.array([[-8.0, 0.0, 1.6]]),
            receivers=jnp.array([[8.0, 0.0, 1.4]]),
            mesh=mesh,
        )
        # Sanity: no LoS, no single diffraction over the top.
        assert int(scene.trace_paths(order=0).mask.sum()) == 0

        paths = MixedPathTracer().trace_paths(scene, [D, D])
        assert int(paths.mask.sum()) > 0
        v = np.asarray(paths.vertices[np.asarray(paths.mask)])
        top = v[(np.abs(v[:, 1, 2] - 3) < 1e-3) & (np.abs(v[:, 2, 2] - 3) < 1e-3)]
        assert len(top) == 1
        np.testing.assert_allclose(top[0, 1], [-1.0, 0.0, 3.0], atol=5e-3)
        np.testing.assert_allclose(top[0, 2], [1.0, 0.0, 3.0], atol=5e-3)

        # Cascaded UTD amplitudes stay finite.
        m2 = scene.mesh.dedup_vertices()
        edges, adj, wn = m2._diffraction_edges_info()
        a = mixed_amplitudes(
            paths,
            scene,
            FREQUENCY,
            edges=edges,
            adjacent_triangles=adj,
            wedge_n=wn,
            eta_r=ETA_R,
            conductivity=CONDUCTIVITY,
        )
        assert bool(jnp.isfinite(a).all())
        assert bool((jnp.abs(a) > 0).any())


def test_power_map_mixed_signatures(knife_edge_scene: Scene) -> None:
    """power_map adds mixed-chain contributions coherently."""
    from differt_tpu.coverage import power_map

    base = power_map(
        knife_edge_scene, FREQUENCY, order=1, with_diffraction=True,
        coherent=False,
    )
    both = power_map(
        knife_edge_scene, FREQUENCY, order=1, with_diffraction=True,
        coherent=False, mixed_signatures=[(R, D)],
    )
    # The knife-edge scene has exactly one valid R-D path: power increases.
    assert float(both.sum()) > float(base.sum())
