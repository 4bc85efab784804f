"""PyTorch port of the ptx path tracer for one NVIDIA H100.

The JAX package ``ptx`` is the reference.  This package imports its host-only
modules (``ptx.config``, ``ptx.scene.{gltf,flatten,arch,synthetic}``,
``ptx.accel.{bvh,native}``, ``ptx.io.png``) so both packages render from the
same numpy scene arrays, and replaces the device code: plain torch for the
array code, hand-written CUDA kernels (``ptx_torch/csrc``) for the TPU
kernels.  Nothing here imports ``jax``.
"""
