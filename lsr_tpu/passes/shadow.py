"""Directional shadow-map pass (PassShadowMap analog, pass_shadow_map.hpp:30-210).

Gathers the shadow-caster scene AABB, fits the directional light camera
(ortho, texel-snapped), and rasterizes caster geometry depth-only with the
tiled kernel in DEPTH_NDC01 mode (z01 = z_ndc*0.5+0.5, min-z resolve, no
backface culling — matching pass_shadow_map.hpp:143-202).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lsr_tpu.camera.light_camera import build_dir_light_camera
from lsr_tpu.lighting.shadow_sample import make_shadow_context
from lsr_tpu.raster.brute import rasterize_brute
from lsr_tpu.raster.setup import CULL_NONE, DEPTH_NDC01
from lsr_tpu.raster.tiled import rasterize_direct
from lsr_tpu.scene.scene import shadow_caster_aabb


@functools.partial(
    jax.jit, static_argnames=("map_size", "use_tiled", "depth_margin")
)
def render_shadow_map(
    geom,
    objects,
    sun_dir_ws,
    map_size: int = 2048,
    use_tiled: bool = True,
    depth_margin: float = 10.0,
):
    """Returns (shadow_depth (S,S), light_viewproj (4,4))."""
    smin, smax = shadow_caster_aabb(objects)
    _, _, light_vp = build_dir_light_camera(
        smin, smax, sun_dir_ws, map_size, depth_margin=depth_margin
    )
    caster_mask = objects.casts_shadow & objects.visible
    # Depth-only setup: skips the normal/uv/attribute work a shadow raster
    # never reads (~2x cheaper front-end; raster/setup.scene_setup_depth).
    from lsr_tpu.raster.setup import scene_setup_depth

    setup = scene_setup_depth(
        geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
        objects.model, light_vp, map_size, map_size,
        cull_mode=CULL_NONE, obj_visible=caster_mask,
    )
    one = jnp.float32(1.0)
    if use_tiled:
        depth, _, _ = rasterize_direct(
            setup, map_size, map_size, jnp.float32(0.0), one,
            depth_mode=DEPTH_NDC01, track_ids=False, spatial_sort=True,
        )
    else:
        depth, _ = rasterize_brute(
            setup, map_size, map_size, jnp.float32(0.0), one,
            depth_mode=DEPTH_NDC01,
        )
    return depth, light_vp


def make_sun_shadow(geom, objects, sun_dir_ws, params):
    """Convenience: render the map and build the sampling context.
    params: core.frame.ShadowPassParams."""
    depth, light_vp = render_shadow_map(
        geom, objects, sun_dir_ws, map_size=params.map_size
    )
    return make_shadow_context(
        depth, light_vp,
        bias_const=params.bias_const,
        bias_slope=params.bias_slope,
        strength=params.strength,
        pcf_radius=params.pcf_radius,
        pcf_step=params.pcf_step,
        filter_mode=params.filter_mode,
    )
