"""differt-tpu: differentiable ray tracing for radio propagation.

A brand-new JAX/XLA/Pallas framework with the capabilities of DiffeRT
(https://github.com/jeertmans/DiffeRT), designed device-first:

- All ray casting runs on-device (pure-JAX reference kernels + Pallas
  kernels compiled for the GPU), no host callbacks in the hot path.
- Path-candidate enumeration is a closed-form ``index -> candidate`` decode
  executed on-device (replacing the reference's host-side Rust iterators).
- Everything is differentiable end-to-end: received power gradients flow to
  geometry vertices, TX/RX positions, and material parameters.
- Multi-device scaling via ``jax.sharding`` meshes: TX x RX x candidate axes
  are sharded, scene geometry is replicated in device memory.
"""

__version__ = "0.1.0"

from . import em, geometry, plugins, rt, utils  # noqa: F401
