"""Configuration: the seven dataclass sections, ``TrainConfig`` and the
``--section.field value`` command line.

The port's own copy of ``dreamwaltz_g_tpu/configs/__init__.py`` (it imports
nothing of the JAX package). Every section, field, default and coercion is
the JAX package's, so one argv parses to the same values in both packages
(``to_dict`` compares them); range strings are parsed with
``ast.literal_eval``. Fields the port does not read yet are parsed all the
same, and the trainer warns about or refuses them as the JAX trainer does.
"""
from __future__ import annotations

import ast
import dataclasses
import json
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Any, Optional, Tuple, Union


def _ranges(s) -> Tuple[Tuple[float, float], ...]:
    """Parse a multi-interval range spec like '(0, 90),(270,360)' or '(60, 120)'.

    Returns a tuple of (lo, hi) tuples. Accepts already-parsed tuples.
    """
    if s is None:
        return None
    if isinstance(s, (tuple, list)):
        if len(s) == 2 and all(isinstance(x, (int, float)) for x in s):
            return (tuple(s),)
        return tuple(tuple(x) for x in s)
    v = ast.literal_eval(str(s))
    if isinstance(v, tuple) and len(v) == 2 and all(isinstance(x, (int, float)) for x in v):
        return (v,)
    return tuple(tuple(x) for x in v)


def _schedule(v) -> Any:
    """A scalar-or-schedule field: either a float or a 4-tuple
    (start_step, v0, v1, end_step) (reference: core/guidance/time_prior.py:17-33)."""
    if isinstance(v, str):
        return ast.literal_eval(v)
    return v


@dataclass
class NeRFConfig:
    """Instant-NGP NeRF renderer parameters (reference: configs/__init__.py:9-91)."""

    desired_resolution: int = 2048
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    density_activation: str = "exp"  # {'exp', 'softplus'}

    grid_size: int = 128
    num_steps: int = 96          # static samples per ray (coarse, occupancy-masked)
    compact_steps: int = 32
    upsample_steps: int = 0      # PDF importance samples per ray (ref: 0)
    update_extra_interval: int = 16
    max_ray_batch: int = 4096
    density_thresh: float = 10.0

    bound: float = 2.0
    min_near: float = 0.1

    backbone: str = "triplane"  # {'tiledgrid', 'hashgrid', 'triplane'}
    triplane_resolution: int = 256
    triplane_dim: int = 32
    triplane_weight_decay: float = 0.1
    triplane_volume_sparsity: float = 3e-3
    export_min_neighbors: int = 2
    grid_dtype: str = "f32"      # {'f32', 'bf16'} encoder-table gather dtype
    nerf_type: str = "rgb"       # {'rgb', 'latent'}
    structure: str = "shared_mlp"  # {'shared_mlp', 'dual_mlp', 'dual_enc'}
    density_prior: str = "none"  # {'none', 'gaussian', 'sqrt'}
    bg_mode: str = "gray"
    bg_radius: float = 3.0
    rand_bg_prob: Optional[float] = None

    optimizer: str = "adam"
    lr: float = 1e-3
    bg_lr: float = 1e-3
    lr_policy: str = "constant"
    encoder_lr_scale: float = 10.0  # encoder gets lr x10 (reference: nerf_model.py:171-211)

    lambda_opacity: float = 0.0
    lambda_entropy: float = 0.0
    lambda_emptiness: float = 0.0
    sparsity_multiplier: float = 20.0
    sparsity_step: float = 1.0
    lambda_shape: float = 5e-6

    cuda_ray: bool = True
    max_steps: int = 1024
    dt_gamma: float = 0.0
    bg_suppress: bool = False
    bg_suppress_dist: float = 0.5
    detach_bg_weights_sum: bool = False
    dmtet: bool = False
    dmtet_reso_scale: float = 8.0
    lock_geo: bool = False
    tet_grid_size: int = 128
    lambda_normal: float = 0.0
    lambda_2d_normal_smooth: float = 0.0
    lambda_3d_normal_smooth: float = 0.0   # dead in the reference
    lambda_mesh_normal: float = 0.5
    lambda_mesh_laplacian: float = 0.5
    start_shading_iter: Optional[int] = None  # dead in the reference


@dataclass
class RenderConfig:
    """3DGS avatar / rendering parameters (reference: configs/__init__.py:94-219)."""

    gs_type: str = "dreamwaltz-g"  # {'vanilla', 'hash', 'dreamwaltz-g'}

    deform_type: str = "glbs"    # {'lbs', 'glbs', 'non_rigid'}
    deform_with_shape: bool = False
    deform_rotation_mode: str = "quaternion"
    lbs_lr: float = 1e-4
    betas_lr: float = 1e-2
    always_animate: bool = True
    lbs_weight_smooth: bool = False
    lbs_weight_smooth_K: int = 30
    lbs_weight_smooth_N: int = 5000

    use_non_rigid_offsets: bool = True
    use_non_rigid_scales: bool = True
    use_non_rigid_rotations: bool = False
    non_rigid_scale_mode: str = "add"
    non_rigid_rotation_mode: str = "add"

    sh_levels: int = 4
    spatial_scale: Optional[float] = None
    init_opacity: float = 0.99
    init_offset: float = 0.01
    init_scale: float = 0.001
    init_scale_radius_rate: float = 1.0
    max_scale: float = 0.01
    bg_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    use_mlp_background: bool = False
    use_video_background: Optional[str] = None

    gaussian_color_init: str = "rand"
    gaussian_point_init: str = "mesh_surface"
    gaussian_scale_init: str = "default"

    n_gaussians: int = 1_000_000   # capacity of the padded unconstrained buffer
    n_gaussians_per_vertex: int = 1
    n_gaussians_per_triangle: int = 6

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    feature_lr: float = 0.0125
    opacity_lr: float = 0.01
    scaling_lr: float = 0.0025
    rotation_lr: float = 0.001

    use_densifier: bool = False
    densify_from_iter: Optional[int] = None
    densify_until_iter: Optional[int] = None
    densification_interval: Optional[int] = None
    densify_min_opacity: float = 0.005
    opacity_reset_interval: Optional[int] = None
    densify_grad_threshold: float = 100.0
    densify_disable_clone: bool = False
    densify_disable_split: bool = False
    densify_disable_prune: bool = False
    densify_disable_reset: bool = True
    enable_grad_prune: bool = False

    from_nerf: Optional[str] = None
    nerf_resolution: int = 400
    reset_nerf: bool = False
    use_nerf_opacities: bool = True
    use_nerf_scales_and_quaternions: bool = True
    use_nerf_encoded_position: bool = True
    use_nerf_mesh_scales_and_quaternions: bool = True

    prune_points_close_to_mesh: bool = True
    prune_dists_close_to_mesh: float = 0.01

    learn_positions: bool = True
    learn_scales: bool = True
    learn_quaternions: bool = True
    learn_lbs_weights: bool = False
    learn_hand_betas: bool = False
    learn_face_betas: bool = False
    learn_mesh_bary_coords: bool = True
    learn_mesh_scales: bool = True
    learn_mesh_quaternions: bool = False

    lambda_outfit_offset: float = 20.0
    lambda_outfit_scale: float = 1.0

    render_mesh_binding_3d_gaussians_only: bool = False
    render_unconstrained_3d_gaussians_only: bool = False
    use_zero_scales: bool = False
    use_constant_colors: Optional[Tuple[float, float, float]] = None
    use_constant_opacities: Optional[float] = None
    use_fixed_n_gaussians: Optional[int] = None

    deform_learn_v_template: bool = False
    deform_learn_shapedirs: bool = False
    deform_learn_posedirs: bool = False
    deform_learn_expr_dirs: bool = False
    deform_learn_lbs_weights: bool = False
    deform_learn_J_regressor: bool = False
    use_joint_shape_offsets: bool = False
    use_vertex_shape_offsets: bool = False
    use_vertex_pose_offsets: bool = False
    use_gs_background: Optional[str] = None
    nerf_exclusion_bboxes: Optional[str] = None
    use_nerf_scales: bool = False
    use_nerf_quaternions: bool = False
    use_deform_scales_and_quaternions: bool = False
    use_nerf_mesh_opacities: bool = False
    learn_mesh_vertex_coords: bool = False
    avatar_scale: Optional[str] = None
    avatar_transl: Optional[str] = None

    tile_size: int = 32
    tile_capacity: int = 1024     # max gaussians blended per tile (depth-sorted)
    chunk: int = 128


@dataclass
class GuideConfig:
    """Diffusion guidance parameters (reference: configs/__init__.py:222-294)."""

    text: str = ""
    text_set: Optional[str] = None
    null_text: str = ""
    negative_text: str = (
        "lowres, bad anatomy, bad hands, text, error, missing fingers, extra "
        "digit, fewer digits, cropped, worst quality, low quality, jpeg "
        "artifacts, signature, watermark, blurry, disfigured, missing arms, "
        "long neck, ugly, bad proportions, fused fingers, extra legs, poorly "
        "drawn hands, cloned face, malformed hands, missing limb"
    )
    use_negative_text: bool = True

    dtype: str = "bf16"
    diffusion: str = "sd15"
    lora_name: Optional[str] = None
    lora_scale: float = 1.0
    concept_name: Optional[str] = None
    negative_text_in_SBP: str = (
        "oversaturated, smooth, pixelated, cartoon, foggy, hazy, blurry, "
        "bad structure, noisy, malformed")
    grad_viz: bool = False
    diffusion_fp16: bool = False
    controlnet_fp16: bool = False
    grad_rgb_clip_mask_guidance: bool = False
    use_controlnet: bool = True
    controlnet: str = "sd15"
    controlnet_condition: str = "pose"  # comma-separated: 'pose', 'depth', 'depth_raw', ...
    controlnet_scale: float = 1.0

    guidance_scale: float = 50.0
    guidance_adjust: str = "constant"

    min_timestep: Any = 0.02
    max_timestep: Any = 0.98
    time_sampling: str = "annealed"
    time_annealing: str = "linear"
    time_annealing_window: str = "impluse"

    sds_loss_type: str = "sds"
    sds_weight_type: str = "sjc"  # {'dreamfusion', 'latent-nerf', 'sjc', 'ism'}
    input_interpolate: bool = True

    guidance_rescale: float = 0.0   # CFG std-rescale (arXiv 2305.08891)
    denoise_timesteps: int = 50     # z0/x0 inference grid
    grad_latent_clip: bool = False
    grad_latent_clip_scale: float = 3.0
    grad_latent_norm: bool = False
    grad_latent_nan_to_num: bool = True
    grad_rgb_clip: bool = False
    grad_rgb_clip_scale: float = 3.0
    grad_rgb_norm: bool = False
    pgc_clip_rgb: float = -1.0
    pgc_suppress_type: int = 0
    lambda_guidance: float = 1.0

    weights_dir: Optional[str] = None

    def __post_init__(self):
        self.min_timestep = _schedule(self.min_timestep)
        self.max_timestep = _schedule(self.max_timestep)
        if isinstance(self.controlnet_condition, str):
            self.controlnet_condition = self.controlnet_condition.split(",")


@dataclass
class DataConfig:
    """Camera sampling / dataloading (reference: configs/__init__.py:297-399)."""

    train_w: Union[int, str] = 512
    train_h: Union[int, str] = 512
    grid_milestone: Optional[str] = None
    progressive_grid: bool = True
    eval_w: int = 512
    eval_h: int = 512
    test_w: int = 1024
    test_h: int = 1024

    elevation_range: Any = "(60, 120)"
    azimuth_range: Any = "(0, 360)"
    fovy_range: Tuple[float, float] = (40.0, 70.0)
    radius_range: Tuple[float, float] = (1.0, 2.0)
    z_near: float = 0.01
    z_far: float = 1000.0
    progressive_radius: bool = False
    progressive_radius_ranges: Optional[str] = None

    batched_view: bool = False
    uniform_sphere_rate: float = 0.0
    jitter_pose: bool = False
    objaverse_id: str = "ff30e709302d47a683b5b0e98148b5a7"
    vertical_jitter: Optional[Tuple[float, float]] = None
    use_human_vertical_jitter: bool = True
    camera_offset: Optional[Tuple[float, float, float]] = None

    eval_size: int = 8
    full_eval_size: int = 60
    eval_azimuth: float = 0.0
    eval_elevation: float = 80.0
    eval_radius: Optional[float] = 2.4
    eval_radius_rate: float = 1.2
    eval_save_video: bool = True
    eval_save_image: bool = True
    eval_video_fps: int = 30
    eval_fix_animation: bool = False
    eval_camera_track: str = "circle"
    eval_camera_offset: Optional[Tuple[float, float, float]] = None
    eval_bg_mode: Optional[str] = None
    eval_body_part: Optional[str] = None

    body_prob: float = 0.8
    head_prob: float = 0.0
    face_prob: float = 0.2
    hand_prob: float = 0.0
    arm_prob: float = 0.0
    foot_prob: float = 0.0

    head_azimuth_range: Any = "(0, 360)"
    head_elevation_range: Any = "(75, 105)"
    head_radius_range: Tuple[float, float] = (0.5, 1.5)
    face_azimuth_range: Any = "(0, 90),(270,360)"
    face_elevation_range: Any = "(75, 105)"
    face_radius_range: Tuple[float, float] = (0.5, 1.0)
    hand_left_azimuth_range: Any = "(0, 180)"
    hand_right_azimuth_range: Any = "(180, 360)"
    hand_elevation_range: Any = "(60, 120)"
    hand_radius_range: Tuple[float, float] = (0.5, 1.0)
    foot_left_azimuth_range: Any = "(0, 360)"
    foot_right_azimuth_range: Any = "(0, 360)"
    foot_elevation_range: Any = "(75, 105)"
    foot_radius_range: Tuple[float, float] = (0.5, 1.5)

    cameras: Optional[str] = None
    random_pose_iter: int = 0
    per_view_poses: bool = False

    def __post_init__(self):
        for name in (
            "azimuth_range", "elevation_range",
            "head_azimuth_range", "head_elevation_range",
            "face_azimuth_range", "face_elevation_range",
            "hand_left_azimuth_range", "hand_right_azimuth_range",
            "hand_elevation_range",
            "foot_left_azimuth_range", "foot_right_azimuth_range",
            "foot_elevation_range",
        ):
            setattr(self, name, _ranges(getattr(self, name)))
        if self.grid_milestone is not None and isinstance(self.grid_milestone, str):
            self.grid_milestone = list(ast.literal_eval(self.grid_milestone))


@dataclass
class PromptConfig:
    """SMPL prompt / text augmentation (reference: configs/__init__.py:402-448)."""

    text_augmentation: bool = True
    text_augmentation_mode: str = "dreamwaltz-g"
    angle_front: float = 90.0
    angle_overhead: float = 60.0
    flat_hand_mean: bool = False
    smpl_type: str = "smplx"
    smpl_gender: str = "neutral"
    smpl_age: str = "adult"
    use_smplx_2020_neutral: bool = True
    num_person: Optional[int] = None
    scene: str = "canonical"
    canonical_pose: str = "canonical-A-adjust"
    canonical_mixup_prob: float = 0.5
    frame_interval: Optional[int] = None
    canonical_betas: Optional[str] = None
    observed_betas: Optional[str] = None
    pop_betas: bool = True
    max_beta_iteration: int = 25
    nerf_depth: bool = False
    centralize_pelvis: bool = True
    pop_transl: bool = False
    normalize_transl: bool = False
    pop_global_orient: bool = False

    use_occlusion_culling: bool = True
    draw_body_keypoints: bool = True
    draw_hand_keypoints: bool = True
    draw_face_landmarks: bool = False
    ignore_body_self_occlusion: bool = True
    openpose_left_right_flip: bool = False

    nerf_depth_step: float = 0.2
    num_object: int = 0
    adaptive_hand_dist_thres: Optional[float] = None


@dataclass
class OptimConfig:
    """Optimization loop parameters (reference: configs/__init__.py:451-467)."""

    batch_size: int = 1
    seed: int = 0
    iters: int = 5000
    resume: bool = False
    ckpt: Optional[str] = None
    ckpt_extra: Optional[str] = None
    fp16: bool = False
    fused_step: bool = True


@dataclass
class LogConfig:
    """Logging / checkpointing (reference: configs/__init__.py:470-506)."""

    exp_name: str = "default"
    exp_root: str = "outputs/"
    save_interval: int = 5000
    snapshot_interval: int = 500
    evaluate_interval: int = 500
    eval_only: bool = False
    eval_dirname: Optional[str] = None
    resume_pretrain: bool = True
    pretrain_only: bool = False
    nerf2gs: bool = False
    nerf2mesh: bool = False
    mesh_resolution: int = 128
    mesh_decimate_target: int = -1
    mesh_texture_size: int = 1024
    max_keep_ckpts: int = 1
    debug: bool = False
    check: bool = False
    check_sd: bool = False
    check_sd_steps: int = 50  # DDIM grid for the check_sd samples
    nvstrain_only: bool = False
    anytrain_only: bool = False
    skip_rgb: bool = False
    platform: Optional[str] = None

    @property
    def exp_dir(self) -> Path:
        return Path(self.exp_root) / self.exp_name


@dataclass
class ParallelConfig:
    """Device-mesh / precision policy of the JAX package, parsed so that the
    same command lines work; the port runs on one card and reads none of
    it."""

    dp: int = -1
    tp: int = 1
    axis_name: str = "data"
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    donate: bool = True


@dataclass
class TrainConfig:
    """Top-level configuration (reference: configs/__init__.py:509-555)."""

    log: LogConfig = field(default_factory=LogConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    nerf: NeRFConfig = field(default_factory=NeRFConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    guide: GuideConfig = field(default_factory=GuideConfig)
    prompt: PromptConfig = field(default_factory=PromptConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    character: Optional[str] = None

    use_sigma_guidance: bool = False
    use_sigma_hand_guidance: bool = False
    use_sigma_face_guidance: bool = False
    sigma_loss_type: str = "margin"
    sigma_prob: float = 1.0
    sigma_num_points: int = 5000
    sigma_surface_thickness: float = 0.005
    sigma_guidance_peak: float = 15.0
    sigma_noise_range: float = 0.05
    sigma_guidance_delta: float = 0.2
    lambda_sigma_sigma: float = 1.0
    lambda_sigma_albedo: float = 0.0
    lambda_sigma_normal: float = 0.0
    predefined_body_parts: str = "hands"

    stage: str = "gs"  # {'nerf', 'gs'}

    def __post_init__(self):
        if self.log.eval_only and not self.optim.resume and self.optim.ckpt is None:
            self.optim.resume = True
        if self.log.pretrain_only and self.guide.controlnet_condition[0] != "depth_raw":
            self.guide.controlnet_condition = ["depth_raw"]
        if self.log.nerf2gs and self.stage != "gs":
            self.stage = "gs"


_BOOL_TRUE = {"1", "true", "True", "yes", "on"}
_BOOL_FALSE = {"0", "false", "False", "no", "off"}


def _coerce(value: str, annotation) -> Any:
    origin = getattr(annotation, "__origin__", None)
    if origin is Union:  # Optional[...] and Union[int, str]
        args = [a for a in annotation.__args__ if a is not type(None)]
        if value in ("None", "none", "null"):
            return None
        for a in args:
            try:
                return _coerce(value, a)
            except (ValueError, SyntaxError):
                continue
        return value
    if annotation is bool or origin is bool:
        if value in _BOOL_TRUE:
            return True
        if value in _BOOL_FALSE:
            return False
        raise ValueError(f"not a bool: {value!r}")
    if annotation is int:
        return int(value)
    if annotation is float:
        return float(value)
    if origin is tuple or annotation is tuple:
        return tuple(ast.literal_eval(value))
    if annotation is Any:
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value
    return value  # str and everything else


def parse_args(argv, base: Optional[TrainConfig] = None) -> TrainConfig:
    """Parse ['--guide.text', 'a wizard', '--stage', 'nerf', ...] into a
    TrainConfig. Unknown flags raise; values are type-coerced from the
    dataclass annotations."""
    cfg = base or TrainConfig()
    sections = {f.name: getattr(cfg, f.name) for f in fields(cfg)
                if dataclasses.is_dataclass(getattr(cfg, f.name))}
    i = 0
    updates = []
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"expected a --flag, got {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, value = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"flag {tok} is missing a value")
            value = argv[i + 1]
            i += 2
        updates.append((key, value))

    for key, value in updates:
        if "." in key:
            sec_name, field_name = key.split(".", 1)
            if sec_name not in sections:
                raise ValueError(f"unknown config section {sec_name!r}")
            target = sections[sec_name]
        else:
            field_name, target = key, cfg
        matching = [f for f in fields(target) if f.name == field_name]
        if not matching:
            raise ValueError(f"unknown config field {key!r}")
        setattr(target, field_name, _coerce(value, matching[0].type_resolved
                                            if hasattr(matching[0], "type_resolved")
                                            else _resolve_type(target, matching[0])))
    for sec in (cfg.guide, cfg.data, cfg):
        if hasattr(sec, "__post_init__"):
            sec.__post_init__()
    return cfg


def _resolve_type(obj, f):
    """dataclass field .type may be a string under PEP 563; resolve it."""
    if isinstance(f.type, str):
        import typing
        ns = {**vars(typing), "Path": Path, "Any": Any}
        try:
            return eval(f.type, ns)  # noqa: S307 - resolving our own annotations
        except Exception:
            return str
    return f.type


def to_dict(cfg) -> dict:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, Path):
        return str(cfg)
    if isinstance(cfg, (list, tuple)):
        return [to_dict(x) for x in cfg]
    return cfg


def save_config(cfg: TrainConfig, path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(to_dict(cfg), indent=2, default=str))
