"""lsr_tpu — an accelerator software-rendering framework (JAX / XLA / Pallas).

A ground-up re-design of the capabilities of the SHS CPU software renderer
(reference: sharavsambuu/leisure-software-renderer) as array programs for
an NVIDIA GPU:

- framebuffers are device-resident jax arrays threaded functionally through
  passes,
- the triangle rasterizer is a tiled Pallas kernel on the Triton route
  (screen-tile grid, per-tile triangle lists, edge-function coverage,
  z-buffer resolution inside the tile; varyings are interpolated after),
- shading models are fused, jitted fullscreen array transforms,
- the pass/pipeline layer is plain-Python value code (frame graph, contracts,
  recipes) producing static, jit-compiled frame programs,
- multi-chip scaling shards the framebuffer across a jax.sharding.Mesh.

Coordinate conventions match the reference (docs/spec/conventions.md):
left-handed, +Y up, +Z forward, NDC z in [-1, 1], canvas origin bottom-left,
1.0 world unit = 1 meter.
"""

__version__ = "0.1.0"
