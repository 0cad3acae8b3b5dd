"""Executable docstring examples (reference parity: --doctest-modules over
every public module, differt/pyproject.toml:197-199).

Each listed module must contain at least one doctest example and all of
them must pass. Examples are written against stable printable values
(.tolist(), float(), bool()) so they do not depend on array repr details.
"""

import doctest

import pytest

MODULE_NAMES = [
    "differt_tpu.utils",
    "differt_tpu.geometry._vectors",
    "differt_tpu.geometry._lattice",
    "differt_tpu.geometry._candidates",
    "differt_tpu.rt._image_method",
    "differt_tpu.rt._triangle",
    "differt_tpu.em._fresnel",
    "differt_tpu.em._material",
    "differt_tpu.em._utils",
    "differt_tpu.em._utd",
    "differt_tpu.geometry._mesh",
    "differt_tpu.geometry._paths",
    "differt_tpu.geometry._scene",
    "differt_tpu.coverage",
    "differt_tpu.treekit",
    "differt_tpu.scenes",
    "differt_tpu.profiling",
    "differt_tpu.rt._scan",
    "differt_tpu.rt._fermat",
    "differt_tpu.rt._diffraction",
    "differt_tpu.em._antenna",
    "differt_tpu.ops._dispatch",
    "differt_tpu.parallel._sharding",
    "differt_tpu.plotting._utils",
    "differt_tpu.io._export",
    "differt_tpu.em._constants",
    "differt_tpu.em._interaction_type",
    "differt_tpu.rt._mixed",
    "differt_tpu.rt._scattering",
    "differt_tpu.rt._mlm",
    "differt_tpu.rt._solvers",
    "differt_tpu.io._obj",
    "differt_tpu.io._ply",
    "differt_tpu.io._xml",
    "differt_tpu.io._sionna",
    "differt_tpu.geometry._morton",
    "differt_tpu._typing",
    "differt_tpu.plotting._core",
    "differt_tpu.plugins.deepmimo",
]
# Not doctested: io.__main__ (CLI entry point, covered by test_io.py),
# plotting._vispy (vispy not installable here; covered by skip-marked
# tests), ops._pallas_rt (kernel-only module, covered by test_pallas.py and
# test_pallas_backend.py, and compiled on the GPU by chip_smoke.py).


@pytest.mark.parametrize("name", MODULE_NAMES)
def test_module_doctests(name):
    module = __import__(name, fromlist=["_"])
    results = doctest.testmod(
        module,
        optionflags=doctest.NORMALIZE_WHITESPACE | doctest.ELLIPSIS,
        verbose=False,
    )
    assert results.failed == 0, f"{results.failed} doctest failures in {name}"
    assert results.attempted > 0, f"{name} has no doctest examples"


TUTORIAL_FILES = [
    "docs/tutorials/cityscale_optimization.md",
]


@pytest.mark.slow  # ~2 min: full streamed-gradient + FD walkthrough.
@pytest.mark.parametrize("relpath", TUTORIAL_FILES)
def test_tutorial_doctests(relpath):
    """Tutorial pages with ``>>>`` blocks execute end-to-end.

    (The other tutorial pages use fenced non-doctest code blocks mirroring
    the runnable scripts in examples/; pages written in doctest style are
    executed here directly.)
    """
    import pathlib

    path = pathlib.Path(__file__).parent.parent / relpath
    results = doctest.testfile(
        str(path),
        module_relative=False,
        optionflags=doctest.NORMALIZE_WHITESPACE | doctest.ELLIPSIS,
        verbose=False,
    )
    assert results.failed == 0, f"{results.failed} doctest failures in {relpath}"
    assert results.attempted > 0, f"{relpath} has no doctest examples"
