"""FrameParams: the per-frame configuration plane.

Mirrors the reference's de-facto config system (frame/frame_params.hpp:117):
a plain value struct with per-pass parameter blocks, technique parameters and
feature toggles.  Static fields steer jit specialization (pass chains,
resolutions, modes); float fields may be traced.
"""

from __future__ import annotations

import dataclasses
import enum


class TechniqueMode(enum.IntFlag):
    """Rendering technique bitmask (technique_mode.hpp:19-61)."""

    NONE = 0
    FORWARD = 1
    FORWARD_PLUS = 2
    DEFERRED = 4
    TILED_DEFERRED = 8
    CLUSTERED_FORWARD = 16
    ALL = 31


class DebugViewMode(enum.Enum):
    NONE = "none"
    ALBEDO = "albedo"
    NORMAL = "normal"
    DEPTH = "depth"


class LightCullingMode(enum.Enum):
    """light_culling_mode.hpp:16."""

    NONE = "none"
    TILED = "tiled"
    TILED_DEPTH_RANGE = "tiled_depth_range"
    CLUSTERED = "clustered"


@dataclasses.dataclass
class TonemapParams:
    exposure: float = 1.0
    gamma: float = 2.2


@dataclasses.dataclass
class ShadowPassParams:
    map_size: int = 2048
    bias_const: float = 0.0008
    bias_slope: float = 0.0015
    pcf_radius: int = 2
    pcf_step: int = 1
    strength: float = 1.0
    filter_mode: str = "pcf"   # "pcf" (reference-exact window filter,
                               # shadow_sample.hpp:65) | "esm" (prefiltered
                               # soft map, one fetch per pixel — the r4
                               # production stack, PARITY.md deviation)
    sun_vis_scale: int = 1     # sampling-resolution divisor for the sun
                               # visibility plane (2 = half-res + bilinear
                               # upsample; pairs with filter_mode="esm")


@dataclasses.dataclass
class MotionBlurParams:
    samples: int = 8
    strength: float = 1.0
    depth_reject: float = 0.02
    target_dt: float = 1.0 / 60.0


@dataclasses.dataclass
class LightShaftsParams:
    steps: int = 48
    density: float = 0.9
    decay: float = 0.94
    weight: float = 0.35
    exposure: float = 0.25
    luma_threshold: float = 0.55


@dataclasses.dataclass
class DepthOfFieldParams:
    focus_depth: float = -1.0  # <0 -> autofocus from median center depth
    focus_range: float = 0.08
    blur_radius: int = 4


@dataclasses.dataclass
class TaaParams:
    blend: float = 0.1
    clamp_neighborhood: bool = True


@dataclasses.dataclass
class BloomParams:
    threshold: float = 1.0
    intensity: float = 0.5
    blur_passes: int = 3


@dataclasses.dataclass
class LocalShadowParams:
    """Local shadow atlas (shadow_technique.hpp:34-50 quality/budget defaults
    + hello_rendering_paths.cpp:104-109 flagship workload).

    spot_ids/point_ids are the budgeted shadow casters — host-side static
    tuples produced by lighting.local_shadows.plan_shadow_casters (the
    analog of the flagship's per-frame budget selection, which is stable
    for a fixed light set)."""

    enabled: bool = True
    spot_ids: tuple = ()
    point_ids: tuple = ()
    map_size: int = 1024       # local_resolution (spot / area-proxy maps)
    point_size: int = 512      # point_resolution (cube faces)
    pcf_radius: int = 2        # flagship PCF5x5 for locals (:2894; per-
                               # light radius = sun's 2.0 at :6397/:6650)
    bias_const: float = 2e-3
    bias_slope: float = 6e-3
    filter_mode: str = "pcf"   # "pcf" | "esm" (see ShadowPassParams)
    vis_scale: int = 1         # sampling-resolution divisor for the
                               # visibility planes (1 = per-pixel exact;
                               # 2 = half-res + bilinear upsample, a
                               # perf knob documented in PARITY.md)
    vis_crop: tuple = ()       # static crop cascade for plane evaluation:
                               # (ch, cw) or smallest-first
                               # ((ch0,cw0),(ch1,cw1),...) — exact to 1 ULP
                               # (planes are 1.0 outside the light's
                               # footprint; each level falls through to the
                               # next, then full-screen)


@dataclasses.dataclass
class CullingPassParams:
    """Per-frame scene + light culling (hello_rendering_paths.cpp:94-97
    proxy buffers; culling_runtime.hpp:111 frustum + :150 hysteresis)."""

    frustum: bool = True
    occlusion: bool = True
    occ_width: int = 320
    occ_height: int = 180
    hold_frames: int = 4
    cull_lights: bool = True


@dataclasses.dataclass
class PassParamBlocks:
    tonemap: TonemapParams = dataclasses.field(default_factory=TonemapParams)
    shadow: ShadowPassParams = dataclasses.field(default_factory=ShadowPassParams)
    motion_blur: MotionBlurParams = dataclasses.field(default_factory=MotionBlurParams)
    light_shafts: LightShaftsParams = dataclasses.field(default_factory=LightShaftsParams)
    dof: DepthOfFieldParams = dataclasses.field(default_factory=DepthOfFieldParams)
    taa: TaaParams = dataclasses.field(default_factory=TaaParams)
    bloom: BloomParams = dataclasses.field(default_factory=BloomParams)
    local_shadow: LocalShadowParams = dataclasses.field(
        default_factory=LocalShadowParams)
    culling: CullingPassParams = dataclasses.field(
        default_factory=CullingPassParams)


@dataclasses.dataclass
class TechniqueParams:
    """frame_params.hpp:73-85."""

    mode: TechniqueMode = TechniqueMode.FORWARD
    depth_prepass: bool = False
    light_culling: LightCullingMode = LightCullingMode.NONE
    tile_size: int = 16
    max_lights_per_tile: int = 128
    cluster_slices: int = 16


@dataclasses.dataclass
class FrameParams:
    """The frame-level parameter block (frame_params.hpp:117-160)."""

    width: int = 1280
    height: int = 720
    dt: float = 1.0 / 60.0
    time: float = 0.0

    enable_shadows: bool = True
    enable_motion_vectors: bool = False
    enable_motion_blur: bool = False
    enable_light_shafts: bool = False
    enable_dof: bool = False
    enable_fxaa: bool = False
    enable_taa: bool = False
    enable_bloom: bool = False
    enable_ibl: bool = False

    debug_view: DebugViewMode = DebugViewMode.NONE
    shading_model: str = "pbr_mr"
    cull_mode: int = 1  # CULL_BACK

    pass_params: PassParamBlocks = dataclasses.field(default_factory=PassParamBlocks)
    technique: TechniqueParams = dataclasses.field(default_factory=TechniqueParams)

    # False routes the camera raster to the brute XLA anchor (parity runs).
    use_tiled_raster: bool = True
    # Density switch for the compact geometry front-end (r5: cull+compact
    # before the wide setup work; rasterizer.hpp:37-39's strategy-switch
    # intent).  Scenes above the threshold cull+compact to
    # compact_cap_fraction * T rows; overflow (dropped triangles) is
    # surfaced in raster_stats, the bin-cap monitoring contract.
    compact_setup_threshold: int = 300_000
    compact_cap_fraction: float = 0.62

    background: tuple = (0.04, 0.06, 0.1)
