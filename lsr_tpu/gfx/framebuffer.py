"""Framebuffer / render-target pytrees: HBM-resident jax arrays.

JAX analog of gfx/rt_types.hpp: the reference's RT structs
(RT_ColorHDR :79, RT_DepthBuffer :91, RT_ColorDepthVelocity :130,
RT_ShadowDepth rt_shadow.hpp:18) become immutable array pytrees threaded
through passes.  Layout is (H, W, C) row-major with row 0 = bottom
(canvas convention, conventions.md §2); W is the fastest axis so screen
rows are contiguous in memory.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

DEPTH_CLEAR = 1.0  # far plane in the [0,1] normalized view-z depth scheme


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["color", "depth", "motion"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Framebuffer:
    """HDR color + depth + motion target (analog of RT_ColorDepthVelocity).

    color:  (H, W, 4) f32 linear HDR RGBA
    depth:  (H, W)    f32 normalized view-z in [0, 1] (1 = far/clear)
    motion: (H, W, 2) f32 screen-space motion vectors in pixels
    """

    color: jnp.ndarray
    depth: jnp.ndarray
    motion: jnp.ndarray

    @property
    def height(self) -> int:
        return self.color.shape[0]

    @property
    def width(self) -> int:
        return self.color.shape[1]


def make_framebuffer(height: int, width: int, clear_color=(0.0, 0.0, 0.0, 1.0)) -> Framebuffer:
    color = jnp.broadcast_to(
        jnp.asarray(clear_color, jnp.float32), (height, width, 4)
    )
    depth = jnp.full((height, width), DEPTH_CLEAR, jnp.float32)
    motion = jnp.zeros((height, width, 2), jnp.float32)
    return Framebuffer(color=color, depth=depth, motion=motion)


def clear_color(fb: Framebuffer, rgba) -> Framebuffer:
    c = jnp.broadcast_to(jnp.asarray(rgba, jnp.float32), fb.color.shape)
    return dataclasses.replace(fb, color=c)


def clear_depth(fb: Framebuffer, value: float = DEPTH_CLEAR) -> Framebuffer:
    return dataclasses.replace(fb, depth=jnp.full_like(fb.depth, value))


def make_ldr(height: int, width: int, rgb=(0, 0, 0)) -> jnp.ndarray:
    """(H, W, 3) u8 LDR canvas (analog of RT_ColorLDR), bottom-left origin."""
    return jnp.broadcast_to(
        jnp.asarray(rgb, jnp.uint8), (height, width, 3)
    ).copy()


def make_shadow_depth(size: int, clear: float = 1.0) -> jnp.ndarray:
    """(S, S) f32 shadow depth map (analog of RT_ShadowDepth), cleared to far."""
    return jnp.full((size, size), clear, jnp.float32)
