"""PyTorch port of the ptx path tracer for one NVIDIA H100.

The JAX package ``ptx`` is the reference.  This package keeps its own copies
of that package's numpy host modules (``ptx_torch.config``,
``ptx_torch.scene.{gltf,flatten,arch,synthetic}``,
``ptx_torch.accel.{bvh,native}``, ``ptx_torch.io.{png,hdr,checkpoint}``),
which build bit-identical scene arrays and files, and replaces the device
code: plain torch for the array code, hand-written CUDA kernels
(``ptx_torch/csrc``) for the TPU kernels and for the BVH walk.  Nothing here imports ``jax`` or ``ptx``.
"""
