"""Top-level trainer: config -> models -> data -> train loop -> checkpoints.

Port of ``dreamwaltz_g_tpu/training/trainer.py`` for the two-stage run of
``scripts/train_w_expr.sh`` steps 1.1-2.3: ``--stage nerf`` (the stage-1
NeRF SDS run, progressive resolutions included) and ``--stage gs`` with the
default ``gs_type`` (the animatable avatar, seeded from a stage-1
checkpoint through ``--render.from_nerf``, from the SMPL-X mesh without
one, or warm-started from an earlier avatar through ``--optim.ckpt``); and
for inference and evaluation: ``evaluate`` (the eval track, motion scenes
with their camera tracks, the video background and its overlay export,
PNGs and an mp4), ``full_eval`` with ``compute_r_precision``
(``--log.eval_only``, step 3 of the script and ``scripts/inference_*.sh``)
and the snapshots of a training run; and for the CLI's other modes:
``pretrain`` (``--log.pretrain_only``: the field fitted to the SMPL-X depth
and mask, ``scripts/pretrain_nerf.sh``), ``pretrain_nerf2gs``
(``--log.nerf2gs``: the avatar distilled from the frozen stage-1 field),
``export_mesh`` (``--log.nerf2mesh``: the field as a textured mesh) and
``check`` (``--log.check`` / ``--log.check_sd``: the condition images and
DDIM samples of the frozen guidance, written at construction); and for
the other geometries: ``--stage nerf --nerf.dmtet true`` (the DMTet
finetune of ``training/dmtet_trainer.py``, its tet grid seeded from the
warm-started field) and ``--stage gs --render.gs_type vanilla`` (plain
Gaussians rigged by LBS, ``system/vanilla.py``) or ``hash`` (the avatar's
scales and rotations from an MLP over the field encoding, no mesh parts),
each through training, checkpoints, snapshots and evaluation.

The Trainer owns the host-side providers (pose prompt, camera sampler,
timestep scheduler, checkpointer) and the device state: the field or the
avatar with its optimizer, on ``cfg.log.platform`` (None: the card;
'cpu': the CPU). Asset gating is the JAX package's: without the SMPL-X
npz under ``HUMAN_TEMPLATES`` or a diffusers-layout weights directory under
``GUIDANCE_WEIGHTS``, ``--log.debug true`` runs the synthetic body and the
tiny random guidance.

Randomness: the numpy ``Generator``s are the JAX trainer's, seeded alike
and drawn in its order (``rng``: sigma guidance and random backgrounds;
``_batch_rng``; the camera sampler's, the scheduler's and the prompt's
own), so one seed gives both packages the same cameras, timesteps,
guidance scales and view indices. The JAX trainer's ``jax.random`` keys
become ``generator``, one ``torch.Generator`` seeded from ``optim.seed``
that only the main thread draws from; the prompt's pose draws come from
the prompt's own generator, on the prefetch worker. A checkpoint carries
every generator's state, so a resumed run draws what an uninterrupted one
would.

The scene options: ``--render.use_mlp_background`` (the ray-direction
MLP background, trained with the avatar under its own Adan through the
split step, ``gs_trainer.make_avatar_sds_step_split``, rendered at the
eval camera by ``evaluate`` and saved in the checkpoint under
"background"), ``--render.use_gs_background`` (a trained-3DGS PLY merged
after the avatar into every step and render), ``--render.avatar_scale`` /
``avatar_transl`` (the scene placement) and ``--optim.ckpt_extra`` (a
second avatar from another run's checkpoint, composed into the renders).
The field's backbone is ``--nerf.backbone`` triplane, hashgrid or
tiledgrid.

The guidance: every ``--guide.sds_loss_type`` of the JAX package (the
csd / nfsd negative branch from ``--guide.negative_text``, ``progress``
from the batch into every step; the x0 modes take the fused stage-2 step
even with the MLP background, which then is not trained, as in the JAX
trainer) and every ``--guide.diffusion`` card (SD1.x, the HumanNorm
finetunes, SD2.x and ``sdxl*``, the last through ``load_guidance_xl``
with the pooled embeddings of the prompt's first view).

Multi-view SDS (``--optim.batch_size B > 1``, stage 1 and every stage-2
``gs_type``, the MLP background included): each step draws B cameras, B
view texts, B timesteps and B condition images (each from its own pose
with ``--data.per_view_poses``) and trains through the B-view steps of
``parallel/dp.py``, the JAX trainer's DP step constructors; each view
draws its noise and its render's jitter from a generator of its own,
seeded from ``_view_rng``. ``--nerf.dmtet`` runs single-view (on several
ranks its step averages their gradients too).

Several cards: one process a card in one ``torch.distributed`` group
(``main.py`` starts it under ``torchrun``). Several ranks train through
those steps on the (data, model) mesh of ``parallel/mesh.py`` (the JAX
trainer's ``_train_mesh_and_gshard``): each model group takes B / dp
views, the guidance's Megatron weights split over the model group
(``parallel/tp.py``). Every rank draws the same host randomness (the
numpy generators, the trainer's generator, each view's generator), so the
views are drawn whole and sliced, and the occupancy refresh, the
densifier and the snapshots agree on every rank; a step's gradients are
all-reduced, so the states stay equal (one view at tp = 1 too: the ranks
are then replicas of one data index), and each checkpoint raises unless
they do. ``evaluate`` splits the eval track's frames over the ranks (the
JAX eval mesh). Rank 0 alone writes: the config, the log file,
checkpoints, snapshots, the check images, the mesh export and the eval
PNGs and videos; every rank reads a resumed checkpoint.
"""
from __future__ import annotations

import ast
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .._device import resolve_device
from ..configs import TrainConfig, paths, save_config
from ..data.camera import make_camera_batch
from ..data.sampler import CyclicalCamera4Avatar, RandomCamera4Avatar
from ..gaussian.densify import DensifyConfig
from ..guidance.sds import resize_images
from ..guidance.text_aug import TextAugmentation
from ..guidance.time_prior import TimePrioritizedScheduler, draw_curves
from ..human.keypoints import load_landmark_data, openpose_keypoints
from ..human.prompt import SMPLPrompt, load_hand_components
from ..human.smplx_model import (SMPLXParams, load_smplx_npz,
                                 make_synthetic_model)
from ..nerf.network import build_nerf
from ..nerf.renderer import init_occupancy
from ..system.background import COLOR_PRESETS, VideoBackground
from ..utils.media import read_video, save_image, write_video
from ..utils.overlay import overlay_frames_on_video
from ..utils.timing import span
from . import gs_trainer, nerf_trainer
from .checkpoint import Checkpointer, load_pytree, resolve_ckpt_path
from .losses import make_sigma_guidance_points
from .optim import build_avatar_optimizer, build_nerf_optimizer

logger = logging.getLogger("dreamwaltz_g_tpu_torch")


def _find_smplx_npz(cfg: TrainConfig) -> Optional[str]:
    root = Path(paths.HUMAN_TEMPLATES)
    for c in (root / "smplx" / "SMPLX_NEUTRAL_2020.npz",
              root / "smplx" / f"SMPLX_{cfg.prompt.smpl_gender.upper()}.npz"):
        if c.is_file():
            return str(c)
    return None


def guidance_dtype(name: str) -> torch.dtype:
    """The guidance's compute type for ``guide.dtype``: float32 for
    'fp32' / 'f32', bf16 otherwise ('fp16' included), as the JAX
    trainer's ``_cast_guidance_dtype`` casts."""
    return torch.float32 if name in ("fp32", "f32") else torch.bfloat16


# -- the torch checkpoint trees ---------------------------------------------

def avatar_tree(state, model) -> dict:
    """The avatar's tensors and networks as a tree of tensors."""
    p = state.params
    return {
        "positions": p.positions, "log_scales": p.log_scales,
        "quats": p.quats, "lbs_weights": p.lbs_weights,
        **p.encoder._asdict(),    # "planes" or the grid's "tables"
        "mesh": {k: {"bary_coords": m.bary_coords,
                     "vertex_coords": m.vertex_coords, "scales": m.scales}
                 for k, m in p.mesh.items()},
        "extra_betas": p.extra_betas, "smpl_learn": dict(p.smpl_learn),
        "alive": state.alive, "grad_accum": state.grad_accum,
        "grad_denom": state.grad_denom, "max_radii": state.max_radii,
        "vertex_indices": state.vertex_indices,
        "color_mlp": model.color_mlp.state_dict(),
        "sq_net": model.sq_net.state_dict(),
    }


@torch.no_grad()
def _copy_into(dst, src, name):
    """Copy the tensors of tree ``src`` into tree ``dst`` in place; keys
    and shapes must match."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"{name}: keys {sorted(src)} vs {sorted(dst)}")
        for k in dst:
            _copy_into(dst[k], src[k], f"{name}.{k}")
    elif dst is None or src is None:
        if (dst is None) != (src is None):
            raise ValueError(f"{name}: present on one side only")
    else:
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"{name}: checkpoint {tuple(src.shape)} vs "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)


@torch.no_grad()
def load_avatar_tree(state, model, tree: dict) -> None:
    """Copy a tree of ``avatar_tree`` into ``state`` and ``model`` in place
    (the optimizer keeps its references); shapes must match."""
    cur = avatar_tree(state, model)
    for k in cur:
        if k not in ("color_mlp", "sq_net"):
            _copy_into(cur[k], tree[k], k)
    model.color_mlp.load_state_dict(tree["color_mlp"])
    model.sq_net.load_state_dict(tree["sq_net"])


def vanilla_tree(state) -> dict:
    """The vanilla avatar's tensors: its ``GaussianParams`` fields, the
    alive mask, the statistics and the LBS weights."""
    g = state.gaussians
    return {**g.params._asdict(), "alive": g.alive,
            "grad_accum": g.grad_accum, "grad_denom": g.grad_denom,
            "max_radii": g.max_radii, "lbs_weights": state.lbs_weights}


@torch.no_grad()
def load_vanilla_tree(state, tree: dict) -> None:
    """Copy a tree of ``vanilla_tree`` into ``state`` in place."""
    _copy_into(vanilla_tree(state), tree, "vanilla")


def _opt_tree(opt_state) -> dict:
    if isinstance(opt_state, tuple):     # the DMTet finetune's pair
        return {"nerf": _opt_tree(opt_state[0]),
                "dmtet": _opt_tree(opt_state[1])}
    if isinstance(opt_state, nerf_trainer.NeRFOptState):
        return {label: state for label, (_, _, state)
                in opt_state.groups.items()}
    return {"adam": opt_state.adam.state_dict(), "count": opt_state.count}


@torch.no_grad()
def _load_opt_tree(opt_state, tree: dict) -> None:
    if isinstance(opt_state, tuple):
        _load_opt_tree(opt_state[0], tree["nerf"])
        _load_opt_tree(opt_state[1], tree["dmtet"])
        return
    if isinstance(opt_state, nerf_trainer.NeRFOptState):
        for label, (_, _, state) in opt_state.groups.items():
            for k, v in tree[label].items():
                if isinstance(v, list):
                    for dst, src in zip(state[k], v):
                        dst.copy_(src)
                else:
                    state[k] = v
        return
    opt_state.adam.load_state_dict(tree["adam"])
    opt_state.count = int(tree["count"])


class Trainer:
    """The two-stage run's trainer (module docstring)."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self._refuse_unported()
        self.device = resolve_device(
            "cuda" if cfg.log.platform in (None, "cuda", "gpu")
            else cfg.log.platform)
        import torch.distributed as dist

        self.world, self.rank = (dist.get_world_size(), dist.get_rank()) \
            if dist.is_available() and dist.is_initialized() else (1, 0)
        # rank 0 writes every file; the other ranks compute alike
        self.is_writer = self.rank == 0
        self.exp_dir = Path(cfg.log.exp_dir)
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        if self.is_writer:
            save_config(cfg, self.exp_dir / "config.json")
        if not logger.handlers:
            logger.setLevel(logging.INFO if self.is_writer
                            else logging.WARNING)
            fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
            handlers = [logging.StreamHandler()]
            if self.is_writer:
                handlers.append(logging.FileHandler(self.exp_dir / "log.txt"))
            for h in handlers:
                h.setFormatter(fmt)
                logger.addHandler(h)
            logger.propagate = False

        self.rng = np.random.default_rng(cfg.optim.seed)
        # _train_batch's own: it runs on the prefetch worker
        self._batch_rng = np.random.default_rng(cfg.optim.seed + 7919)
        # the seeds of each multi-view step's per-view generators
        self._view_rng = np.random.default_rng(cfg.optim.seed + 104729)
        self.batch_size = cfg.optim.batch_size
        self.tp = max(int(cfg.parallel.tp or 1), 1)
        self.mesh = self._train_mesh()
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.optim.seed)
        self.max_iteration = cfg.optim.iters
        self.train_step = 0
        self.losses = []
        self.neg_embeds = None
        self.export_stats: Dict[str, Any] = {}
        self.dmtet_model = None
        self.extra_states = ()
        self.extra_models = ()
        self.bg_state = None   # the MLP background's BackgroundTrainState
        self.bg_net = None

        self._warn_unsupported_knobs()
        self._init_human()
        self._init_guidance()
        self._init_cameras()
        self.checkpointer = Checkpointer(self.exp_dir / "checkpoints",
                                         max_keep=cfg.log.max_keep_ckpts)
        if cfg.stage == "nerf":
            self._init_nerf()
        else:
            self._init_avatar()
        if cfg.log.check or cfg.log.check_sd:
            self.check()

    def _refuse_unported(self):
        """The flag combinations the JAX trainer asserts against raise
        here."""
        cfg = self.cfg
        lg = cfg.log
        if cfg.stage not in ("nerf", "gs"):
            raise ValueError(f"unknown stage {cfg.stage!r}")
        if lg.platform not in (None, "cuda", "gpu", "cpu"):
            raise ValueError(f"log.platform {lg.platform!r}: the port runs "
                             "on 'cuda' (the default) or 'cpu'")
        if cfg.optim.batch_size < 1:
            raise ValueError(f"optim.batch_size {cfg.optim.batch_size} < 1")
        if cfg.stage == "nerf" and cfg.nerf.dmtet \
                and (cfg.optim.batch_size > 1 or cfg.parallel.tp > 1):
            raise ValueError("--nerf.dmtet runs single-view without tensor "
                             "parallelism (batch_size=1, parallel.tp=1)")

    def _train_mesh(self):
        """The (data, model) mesh of the multi-view steps when
        ``--parallel.tp > 1``, ``--optim.batch_size > 1`` or the process
        group holds several ranks, else None (the JAX trainer's
        ``_train_mesh_and_gshard``): tp must divide the ranks, ``self.dp``
        is ``--parallel.dp`` (-1: every data group) resolved against the
        ranks / tp data groups and the batch. Several ranks always take
        the mesh, so that a single view's ranks are replicas whose
        gradients the step averages: the JAX package's one controller has
        one state, and ranks that stepped alone would part (the card's
        render backward adds in no fixed order)."""
        from ..parallel.mesh import make_mesh_2d, resolve_dp

        if self.world % self.tp:
            raise ValueError(f"parallel.tp={self.tp} must divide the "
                             f"{self.world} ranks")
        self.dp = resolve_dp(int(self.cfg.parallel.dp or -1),
                             self.world // self.tp, self.batch_size)
        if self.batch_size == 1 and self.tp == 1 and self.world == 1:
            return None
        return make_mesh_2d(self.dp, self.tp, self.device)

    def _warn_unsupported_knobs(self):
        """Knobs parsed for reference-CLI compatibility that have no effect,
        warned about as the JAX trainer warns (knob for knob)."""
        r, g, d = self.cfg.render, self.cfg.guide, self.cfg.data
        n, p, lg = self.cfg.nerf, self.cfg.prompt, self.cfg.log
        checks = [
            (r.non_rigid_scale_mode != "add",
             "render.non_rigid_scale_mode (dead in the reference: stored at "
             "avatar.py:1126, never read — the scale branch gates on "
             "non_rigid_rotation_mode, avatar.py:1471)"),
            (r.use_nerf_opacities is False, "render.use_nerf_opacities "
             "(dead in the reference: defaulted at configs/__init__.py:179, "
             "never read by any core module)"),
            (r.use_nerf_scales_and_quaternions is False,
             "render.use_nerf_scales_and_quaternions (use gs_type=hash)"),
            (r.use_nerf_mesh_scales_and_quaternions is False,
             "render.use_nerf_mesh_scales_and_quaternions (only read by "
             "the reference's dead HashAvatarWithMesh, avatar.py:520)"),
            (not r.learn_mesh_quaternions is False,
             "render.learn_mesh_quaternions (dead for the shipped avatar: "
             "only read by the reference's dead HashAvatarWithMesh, "
             "avatar.py:518/563/746 — DreamWaltzG's mesh quats always "
             "derive from triangle frames, avatar.py:1027-1079)"),
            (d.batched_view, "data.batched_view (dead in the reference: "
             "parsed at configs/__init__.py:319, never read)"),
            (d.uniform_sphere_rate not in (None, 0, 0.0),
             "data.uniform_sphere_rate (dead in the reference: parsed at "
             "configs/__init__.py:320, never read)"),
            (d.jitter_pose, "data.jitter_pose (dead in the reference: "
             "parsed at configs/__init__.py:322, never read)"),
            (g.concept_name is not None and g.diffusion.startswith("sdxl"),
             "guide.concept_name with SDXL (sd-concepts are 768-dim SD1.x "
             "embeddings — dimensionally incompatible with the bigG tower; "
             "the reference would inject them into tower 1 only)"),
            (g.diffusion_fp16 or g.controlnet_fp16,
             "guide.diffusion_fp16/controlnet_fp16 (precision comes from "
             "guide.dtype here: bf16 default, f32 available)"),
            (not n.cuda_ray, "nerf.cuda_ray=false (the static-shape marcher "
             "is the only one; tune nerf.num_steps instead)"),
            (n.max_steps != 1024, "nerf.max_steps (use nerf.num_steps/"
             "compact_steps — static-shape marching)"),
            (n.dt_gamma != 0.0, "nerf.dt_gamma (fixed-step marching)"),
            (n.bg_suppress, "nerf.bg_suppress (dead in the reference: "
             "consumer commented out, nerf_renderer.py:445-462)"),
            (n.lambda_normal > 0, "nerf.lambda_normal (normal_image loss "
             "never consumed by the reference trainer)"),
            (n.lambda_2d_normal_smooth > 0,
             "nerf.lambda_2d_normal_smooth (normal_image loss never "
             "consumed by the reference trainer)"),
            (n.lambda_3d_normal_smooth > 0,
             "nerf.lambda_3d_normal_smooth (dead in the reference)"),
            (n.start_shading_iter is not None,
             "nerf.start_shading_iter (dead in the reference)"),
            (r.use_nerf_scales or r.use_nerf_quaternions
             or r.use_deform_scales_and_quaternions,
             "render.use_nerf_scales/use_nerf_quaternions/"
             "use_deform_scales_and_quaternions (dead in the reference)"),
            (r.use_nerf_mesh_opacities, "render.use_nerf_mesh_opacities "
             "(only read by the reference's dead HashAvatarWithMesh)"),
            (p.nerf_depth_step != 0.2,
             "prompt.nerf_depth_step (dead in the reference)"),
            (p.num_object != 0, "prompt.num_object (dead in the reference)"),
            (p.adaptive_hand_dist_thres is not None,
             "prompt.adaptive_hand_dist_thres (dead in the reference: "
             "consumer commented out, smpl_condition.py:152)"),
            (lg.nvstrain_only or lg.anytrain_only or lg.skip_rgb,
             "log.nvstrain_only/anytrain_only/skip_rgb (dead in the "
             "reference)"),
        ]
        for cond, name in checks:
            if cond:
                logger.warning("config knob %s is parsed for reference-CLI "
                               "compatibility but has no effect in this "
                               "build", name)
        if g.grad_rgb_clip_mask_guidance and self.cfg.stage != "nerf":
            raise ValueError(
                "guide.grad_rgb_clip_mask_guidance is a stage-1 (nerf) "
                "feature — the mask is the NeRF render's weights_sum")
        if r.deform_type == "lbs":
            # pure-LBS deform: no non-rigid residuals
            r.use_non_rigid_offsets = False
            r.use_non_rigid_scales = False
            r.use_non_rigid_rotations = False

    def _common_step_kwargs(self) -> dict:
        """Builder kwargs shared by every stage-2 step constructor, in one
        place so the first build and the progressive-resolution rebuilds
        agree."""
        r = self.cfg.render
        return dict(lambda_guidance=self.cfg.guide.lambda_guidance,
                    neg_embeds=self.neg_embeds, pgc=self.pgc, tile_size=r.tile_size,
                    capacity=r.tile_capacity, chunk=r.chunk,
                    placement=self._placement(),
                    static_gaussians=self._static_bg_gaussians(),
                    device=self.device)

    def _placement(self):
        """The scene placement of ``--render.avatar_scale`` /
        ``avatar_transl`` (Python literals: a scalar or per-avatar list,
        a 3-vector or per-avatar list of them), or None."""
        r = self.cfg.render
        if r.avatar_scale is None and r.avatar_transl is None:
            return None
        sc = None if r.avatar_scale is None else np.asarray(
            ast.literal_eval(str(r.avatar_scale)), np.float32)
        tr = None if r.avatar_transl is None else np.asarray(
            ast.literal_eval(str(r.avatar_transl)), np.float32)
        return (sc, tr)

    def _static_bg_gaussians(self):
        """The frozen Gaussian background of ``--render.use_gs_background``
        (a trained-3DGS PLY), read once; None without the flag."""
        if not self.cfg.render.use_gs_background:
            return None
        if getattr(self, "_gs_bg_cache", None) is None:
            from ..system.background import load_gaussian_background

            self._gs_bg_cache = load_gaussian_background(
                self.cfg.render.use_gs_background, device=self.device)
        return self._gs_bg_cache

    # ------------------------------------------------------------------
    # builders
    # ------------------------------------------------------------------

    def _init_human(self):
        cfg = self.cfg
        npz = _find_smplx_npz(cfg)
        if npz is not None:
            kid_path = None
            if cfg.prompt.smpl_age == "kid":
                cand = Path(npz).parent / "smplx_kid_template.npy"
                if cand.is_file():
                    kid_path = str(cand)
                else:
                    logger.warning("smpl_age='kid' but %s is missing — "
                                   "training the adult template", cand)
            self.smpl = load_smplx_npz(
                npz, flat_hand_mean=cfg.prompt.flat_hand_mean,
                kid_template_path=kid_path, device=self.device)
            if kid_path is not None:
                kid_vec = np.zeros((1, self.smpl.num_betas), np.float32)
                kid_vec[0, -1] = 0.7   # the kid interpolation rate
                if cfg.prompt.canonical_betas is None:
                    cfg.prompt.canonical_betas = kid_vec
                if cfg.prompt.observed_betas is None:
                    cfg.prompt.observed_betas = kid_vec
            landmarks = load_landmark_data(npz)
            hand_components = load_hand_components(npz)
        else:
            assert cfg.log.debug, (
                "SMPL-X npz not found under HUMAN_TEMPLATES; "
                "pass --log.debug true to run with the synthetic body")
            logger.warning("debug: using the synthetic stick body")
            self.smpl = make_synthetic_model(device=self.device)
            landmarks, hand_components = None, None
        self.prompt = SMPLPrompt(
            cfg.prompt, self.smpl,
            cond_type=list(cfg.guide.controlnet_condition),
            height=512, width=512,   # the ControlNet's native condition
            landmarks=landmarks, hand_components=hand_components,
            seed=cfg.optim.seed)

    def _init_guidance(self):
        cfg = self.cfg
        g = cfg.guide
        self.view_prompt = TextAugmentation(
            g.text or "a person",
            mode=cfg.prompt.text_augmentation_mode
            if cfg.prompt.text_augmentation else "suffix",
            angle_front=cfg.prompt.angle_front,
            angle_overhead=cfg.prompt.angle_overhead)
        # the model card: 'sdxl*' takes the XL stack (two text towers, the
        # pooled embeddings)
        is_xl = str(g.diffusion).startswith("sdxl")
        weights_dir = Path(g.weights_dir or paths.GUIDANCE_WEIGHTS)
        dtype = guidance_dtype(g.dtype)
        texts = list(self.view_prompt.texts)
        three_way = g.sds_loss_type in ("csd", "nfsd")
        self.neg_embeds = None
        if (weights_dir / "unet").is_dir():
            from ..guidance.convert import load_guidance, load_guidance_xl

            common = dict(
                loss_type=g.sds_loss_type, weight_type=g.sds_weight_type,
                guidance_scale=g.guidance_scale,
                controlnet_scale=g.controlnet_scale,
                guidance_rescale=g.guidance_rescale,
                denoise_timesteps=g.denoise_timesteps,
                use_controlnet=g.use_controlnet, lora_name=g.lora_name,
                lora_scale=g.lora_scale, device=self.device, dtype=dtype)
            uncond = g.negative_text if g.use_negative_text else g.null_text
            if is_xl:
                self.guidance, self.guidance_params, text_embed_fn = \
                    load_guidance_xl(str(weights_dir), **common)
                self.text_embeds, pooled_t = text_embed_fn(texts)
                self.uncond_embeds, pooled_u = text_embed_fn([uncond])
                # the view variants share the base prompt's pooled
                # embedding (the view suffix lives in the context tokens)
                self.guidance.pooled_text = pooled_t[:1]
                self.guidance.pooled_uncond = pooled_u[:1]
                if three_way:
                    self.neg_embeds, _ = text_embed_fn([g.negative_text])
            else:
                self.guidance, self.guidance_params, text_embed_fn = \
                    load_guidance(str(weights_dir), model=g.diffusion,
                                  concept_name=g.concept_name, **common)
                self.text_embeds = text_embed_fn(texts)
                self.uncond_embeds = text_embed_fn([uncond])
                if three_way:
                    self.neg_embeds = text_embed_fn([g.negative_text])
        else:
            assert cfg.log.debug, (
                f"guidance weights not found at {weights_dir} (a diffusers "
                "model directory with unet/); pass --log.debug true")
            logger.warning("debug: using tiny randomly-initialized guidance")
            if is_xl:
                from ..tests_support import tiny_guidance_xl

                self.guidance, self.guidance_params, text_embed_fn = \
                    tiny_guidance_xl(cfg.optim.seed, device=self.device,
                                     dtype=dtype)
                self.text_embeds, pooled_t = text_embed_fn(texts)
                self.uncond_embeds, pooled_u = text_embed_fn([g.null_text])
                self.guidance.pooled_text = pooled_t[:1]
                self.guidance.pooled_uncond = pooled_u[:1]
            else:
                from ..tests_support import tiny_guidance

                self.guidance, self.guidance_params = tiny_guidance(
                    cfg.optim.seed, with_controlnet=g.use_controlnet,
                    device=self.device, dtype=dtype)
                D = self.guidance_params.unet.cfg.cross_attention_dim
                self.text_embeds = torch.randn(
                    (len(texts), 4, D), generator=self.generator,
                    device=self.device) * 0.02
                self.uncond_embeds = torch.zeros((1, 4, D),
                                                 device=self.device)
            self.guidance.loss_type = g.sds_loss_type
            self.guidance.weight_type = g.sds_weight_type
            self.guidance.guidance_scale = g.guidance_scale
            self.guidance.guidance_rescale = g.guidance_rescale
            self.guidance.denoise_timesteps = g.denoise_timesteps
            if three_way:
                # the debug negative branch: a random context of the
                # prompt's length (the JAX trainer's debug draw)
                D = self.guidance_params.unet.cfg.cross_attention_dim
                L = self.text_embeds.shape[1]
                self.neg_embeds = torch.randn(
                    (1, L, D), generator=self.generator,
                    device=self.device) * 0.02
        self._cast_guidance_dtype()
        if self.tp > 1:
            # the UNet's and the ControlNet's Megatron weights: this rank's
            from ..parallel.tp import shard_guidance_params

            shard_guidance_params(self.guidance_params, self.mesh)
        self.guidance.input_interpolate = g.input_interpolate
        from ..guidance.sds import build_pixel_grad_hook

        self.pgc = build_pixel_grad_hook(g)
        self.t_scheduler = TimePrioritizedScheduler(
            g, schedule=self.guidance.schedule, seed=cfg.optim.seed)
        self.guidance.schedule = self.t_scheduler.schedule
        vae_factor = 2 ** (len(
            self.guidance_params.vae.cfg.block_out_channels) - 1)
        self.cond_size = self.guidance.latent_size * vae_factor

    def _cast_guidance_dtype(self):
        """The text embeddings (the negative branch's and the XL pooled
        ones too) in the guidance's compute type (``guide.dtype``, bf16 by
        default); the UNet, ControlNet and VAE are built in it."""
        dt = guidance_dtype(self.cfg.guide.dtype)
        self.text_embeds = self.text_embeds.to(dt)
        self.uncond_embeds = self.uncond_embeds.to(dt)
        if self.neg_embeds is not None:
            self.neg_embeds = self.neg_embeds.to(dt)
        for name in ("pooled_text", "pooled_uncond"):
            if getattr(self.guidance, name, None) is not None:
                setattr(self.guidance, name,
                        getattr(self.guidance, name).to(dt))

    def _canonical_keypoints(self) -> np.ndarray:
        return openpose_keypoints(
            self.smpl, self.prompt.canonical_outputs,
            self.prompt.condition.landmarks).cpu().numpy()

    def _init_cameras(self):
        cfg = self.cfg
        if isinstance(cfg.data.train_w, str):
            self.train_resolutions = [int(x) for x in
                                      str(cfg.data.train_w).split(",")]
        else:
            self.train_resolutions = [int(cfg.data.train_w)]
        if not cfg.data.progressive_grid:
            self.train_resolutions = self.train_resolutions[-1:]
        if cfg.data.grid_milestone:
            self.grid_milestones = list(cfg.data.grid_milestone)
        else:  # equal splits of the run
            n = len(self.train_resolutions)
            self.grid_milestones = [i / n for i in range(1, n)]
        self._res_index = 0
        self.train_res = self.train_resolutions[0]
        self.train_camera = RandomCamera4Avatar(
            cfg.data, self.train_res, self.train_res, seed=cfg.optim.seed,
            device=self.device)
        self.eval_camera = CyclicalCamera4Avatar(
            cfg.data, cfg.data.eval_h, cfg.data.eval_w, device=self.device)
        self.test_camera = CyclicalCamera4Avatar(
            cfg.data, cfg.data.test_h, cfg.data.test_w, device=self.device)
        kp = self._canonical_keypoints()
        if np.isfinite(kp[:, :18]).all():
            for camera in (self.train_camera, self.eval_camera,
                           self.test_camera):
                camera.setup_camera_offset(kp)

    def _init_nerf(self):
        cfg = self.cfg
        self.nerf = build_nerf(
            cfg.nerf, with_background=cfg.nerf.bg_mode == "nerf"
            or cfg.nerf.bg_radius > 0, generator=self.generator,
            device=self.device)
        ac = self.guidance.schedule.alphas_cumprod.cpu().numpy()
        self.tx = build_nerf_optimizer(cfg.nerf, self.max_iteration,
                                       alphas_cumprod=ac)
        # the 'ddpm' lr policy: per-timestep update weights in the step
        self._tp_lr_weights = None
        if cfg.nerf.lr_policy == "ddpm":
            from ..guidance.time_prior import TimePrioritizedLR

            self._tp_lr_weights = TimePrioritizedLR(
                self.guidance.schedule).weights
        self.state = nerf_trainer.init_train_state(self.nerf, self.tx)
        if cfg.optim.ckpt:
            # model-only warm start
            step_dir = resolve_ckpt_path(cfg.optim.ckpt)
            if step_dir is not None:
                raw = load_pytree(step_dir, map_location=self.device)
                with torch.no_grad():
                    self.nerf.load_state_dict(raw["params"])
                logger.info("warm-started NeRF from %s", step_dir)
        self.grid = init_occupancy(cfg.nerf.grid_size, device=self.device)
        self.dmtet_model = None
        if cfg.nerf.dmtet:
            # the DMTet finetune: the tet grid seeded from the (warm-
            # started) field; the surface and the field train by SDS
            from . import dmtet_trainer

            with span("trainer.init_dmtet", self.device):
                self.dmtet_model, dparams, self._tet_edges = \
                    dmtet_trainer.init_dmtet(
                        self.nerf, int(cfg.nerf.tet_grid_size),
                        density_thresh=cfg.nerf.density_thresh)
            self._tx_dmtet = dmtet_trainer.build_dmtet_optimizer(
                cfg.nerf, self.max_iteration)
            self.state = dmtet_trainer.init_train_state(
                self.nerf, dparams, self.tx, self._tx_dmtet)
            logger.info("DMTet finetune: %d tets in the surface band "
                        "(grid %d)", self.dmtet_model.tets.shape[0],
                        cfg.nerf.tet_grid_size)
        self._build_nerf_sds_step(self.train_res)
        self._build_pretrain_step(self.train_res)
        if self.dmtet_model is not None:
            from . import dmtet_trainer

            r = cfg.render
            self.eval_render = dmtet_trainer.make_dmtet_eval_render(
                self.nerf, self.dmtet_model, cfg.data.eval_h,
                cfg.data.eval_w, tile_size=r.tile_size,
                capacity=r.tile_capacity, chunk=r.chunk, device=self.device)
        else:
            self.eval_render = nerf_trainer.make_eval_render(
                self.nerf, cfg.data.eval_h, cfg.data.eval_w,
                device=self.device)

    def _build_nerf_sds_step(self, H: int):
        cfg = self.cfg
        if getattr(self, "dmtet_model", None) is not None:
            from . import dmtet_trainer

            r = cfg.render
            self.sds_step_fn = dmtet_trainer.make_dmtet_sds_step(
                self.nerf, self.dmtet_model, self._tet_edges, self.guidance,
                H, H, cfg.nerf, lambda_guidance=cfg.guide.lambda_guidance,
                neg_embeds=self.neg_embeds, pgc=self.pgc, tile_size=r.tile_size,
                capacity=r.tile_capacity, chunk=r.chunk, device=self.device)
            return
        make = nerf_trainer.make_nerf_sds_step
        kw = {}
        if self.mesh is not None:
            from ..parallel.dp import make_nerf_sds_step_dp as make

            kw = dict(mesh=self.mesh)
        self.sds_step_fn = make(
            self.nerf, self.guidance, H, H, cfg.nerf,
            num_steps=cfg.nerf.num_steps,
            lambda_guidance=cfg.guide.lambda_guidance,
            neg_embeds=self.neg_embeds,
            lambda_sigma=cfg.lambda_sigma_sigma,
            sigma_peak=cfg.sigma_guidance_peak,
            sigma_loss_type=cfg.sigma_loss_type,
            max_iteration=self.max_iteration,
            bg_mode="nerf" if cfg.nerf.bg_mode == "nerf" else "color",
            ray_chunk=cfg.nerf.max_ray_batch, pgc=self.pgc,
            tp_lr_weights=self._tp_lr_weights, device=self.device, **kw)

    def _build_pretrain_step(self, H: int):
        self.pretrain_step_fn = nerf_trainer.make_pretrain_step(
            self.nerf, H, H, num_steps=self.cfg.nerf.num_steps,
            compact_steps=self.cfg.nerf.compact_steps, device=self.device)

    def _build_avatar_model(self):
        from ..human.deform import DeformNetwork
        from ..nerf.encoder import enc_cfg_from_nerf
        from ..nerf.network import SigmaMLP
        from ..system import avatar as A

        cfg = self.cfg
        r = cfg.render
        enc_cfg = enc_cfg_from_nerf(cfg.nerf)
        # 'hash': no mesh-bound parts; the scales and rotations come from
        # an MLP over the field encoding in place of the deform net
        hash_mode = r.gs_type == "hash"
        mesh_parts = {}
        if hash_mode:
            pass
        elif self.smpl.num_vertices < 1000:
            # the synthetic debug body has no semantic tables: bind the top
            # of the chain as 'face'
            faces = self.smpl.faces
            v = self.smpl.v_template.cpu().numpy()
            top = np.argsort(-v[faces].mean(1)[:, 1])[:10]
            vids = np.unique(faces[top].reshape(-1))
            mesh_parts["face"] = A.make_mesh_binding_static(
                faces, vids, top, n_per_triangle=r.n_gaussians_per_triangle)
        else:
            from ..human.semantics import get_semantic_parts

            for name in cfg.predefined_body_parts.split(","):
                part = get_semantic_parts(self.smpl, name)
                if part is not None:
                    vids, fids = part
                    mesh_parts[name] = A.make_mesh_binding_static(
                        self.smpl.faces, vids, fids,
                        n_per_triangle=r.n_gaussians_per_triangle)
        out_ch = 1 + (4 if cfg.nerf.nerf_type == "latent" else 3)
        if r.use_joint_shape_offsets and r.use_vertex_shape_offsets:
            raise ValueError("joint and vertex shape offsets are mutually "
                             "exclusive")
        deform_learn = tuple(
            k for k in ("v_template", "shapedirs", "posedirs", "expr_dirs",
                        "lbs_weights", "J_regressor")
            if getattr(r, f"deform_learn_{k}"))
        return A.AvatarModel(
            smpl=self.smpl,
            canonical_inputs=self.prompt.canonical_inputs,
            enc_cfg=enc_cfg,
            nerf_bound=cfg.nerf.bound,
            color_mlp=SigmaMLP(enc_cfg.output_dim, hidden=64, num_layers=3,
                               out_channels=out_ch, device=self.device),
            sq_net=SigmaMLP(enc_cfg.output_dim, hidden=64, num_layers=3,
                            out_channels=7, device=self.device)
            if hash_mode else DeformNetwork(
                xyz_input_ch=enc_cfg.output_dim
                if r.use_nerf_encoded_position else None,
                device=self.device),
            hash_mode=hash_mode,
            mesh_parts=mesh_parts,
            init_scale=r.init_scale,
            max_scale=r.max_scale,
            init_offset=r.init_offset,
            use_non_rigid_offsets=r.use_non_rigid_offsets,
            use_non_rigid_scales=r.use_non_rigid_scales,
            use_non_rigid_rotations=r.use_non_rigid_rotations,
            use_joint_shape_offsets=r.use_joint_shape_offsets,
            use_vertex_shape_offsets=r.use_vertex_shape_offsets,
            use_vertex_pose_offsets=r.use_vertex_pose_offsets,
            non_rigid_rotation_mode=r.non_rigid_rotation_mode,
            deform_with_shape=r.deform_with_shape,
            deform_rotation_mode=r.deform_rotation_mode,
            use_nerf_encoded_position=r.use_nerf_encoded_position,
            deform_learn=deform_learn,
            learn_hand_betas=r.learn_hand_betas,
            learn_face_betas=r.learn_face_betas,
            use_zero_scales=r.use_zero_scales,
            use_constant_colors=r.use_constant_colors,
            use_constant_opacities=r.use_constant_opacities,
            use_fixed_n_gaussians=r.use_fixed_n_gaussians,
            render_only="mesh" if r.render_mesh_binding_3d_gaussians_only
            else "unconstrained"
            if r.render_unconstrained_3d_gaussians_only else "all",
        )

    def _seed_cloud(self):
        """Gaussian seeds from the canonical SMPL-X mesh when no stage-1
        cloud exists: (cloud (N, 3), colors (N, 3), linear scales (N, 3)
        or None for gaussian_scale_init='default')."""
        from ..gaussian.seed import (
            seed_colors,
            seed_positions,
            seed_scales_radius,
        )

        r = self.cfg.render
        verts = self.prompt.canonical_outputs.vertices[0]
        faces = self.smpl.faces
        cloud = seed_positions(r.gaussian_point_init, self.generator, verts,
                               faces, r.n_gaussians, r.n_gaussians_per_vertex)
        colors = seed_colors(r.gaussian_color_init, self.generator, cloud,
                             verts, faces)
        scales = None
        if r.gaussian_scale_init == "radius":
            scales = seed_scales_radius(cloud, verts,
                                        r.init_scale_radius_rate)
        logger.info("seeded %d gaussians from the SMPL-X mesh (point_init="
                    "%s, color_init=%s, scale_init=%s)", cloud.shape[0],
                    r.gaussian_point_init, r.gaussian_color_init,
                    r.gaussian_scale_init)
        return cloud, colors, scales

    def _export_cloud(self, nerf):
        """The stage-1 field's point cloud, its counts in
        ``export_stats``."""
        from ..nerf import export

        cfg = self.cfg
        st = self.export_stats
        pc = export.export_point_cloud(
            nerf, resolution=cfg.render.nerf_resolution,
            density_thresh=cfg.nerf.density_thresh,
            max_points=cfg.render.n_gaussians,
            min_neighbors=cfg.nerf.export_min_neighbors, stats=st)
        if cfg.render.nerf_exclusion_bboxes is not None:
            n0 = pc.points.shape[0]
            pc = export.remove_points_inside_bboxes(
                pc, ast.literal_eval(cfg.render.nerf_exclusion_bboxes))
            logger.info("removed %d points inside exclusion bboxes",
                        n0 - pc.points.shape[0])
        st["points"] = int(pc.points.shape[0])
        return pc

    def _load_stage1_field(self, step_dir):
        """The stage-1 checkpoint's field, frozen."""
        cfg = self.cfg
        nerf = build_nerf(
            cfg.nerf, with_background=cfg.nerf.bg_mode == "nerf"
            or cfg.nerf.bg_radius > 0, device=self.device)
        raw = load_pytree(step_dir, map_location=self.device)
        with torch.no_grad():
            nerf.load_state_dict(raw["params"])
        return nerf.requires_grad_(False)

    def _init_vanilla_avatar(self):
        """``--render.gs_type vanilla``: plain Gaussians rigged by LBS,
        seeded from the stage-1 field's cloud (``--render.from_nerf``) or
        from the SMPL-X mesh, warm-started from ``--optim.ckpt``; the six
        Adam groups of ``build_gaussian_optimizer``; densification and the
        periodic opacity reset on the trainer's cadence."""
        from ..system.vanilla import VanillaAvatarModel, init_vanilla_avatar
        from .optim import build_gaussian_optimizer

        cfg = self.cfg
        r = cfg.render
        self._nerf_guidance = None
        self.avatar_model = VanillaAvatarModel(
            smpl=self.smpl, canonical_inputs=self.prompt.canonical_inputs,
            max_scale=r.max_scale)
        colors = seed_scales = None
        nerf_step_dir = resolve_ckpt_path(r.from_nerf) if r.from_nerf \
            else None
        if nerf_step_dir is not None:
            nerf = self._load_stage1_field(nerf_step_dir)
            with span("trainer.export", self.device):
                pc = self._export_cloud(nerf)
            cloud = torch.as_tensor(pc.points, device=self.device)
            if pc.colors is not None:
                colors = torch.as_tensor(pc.colors, dtype=torch.float32,
                                         device=self.device)
        else:
            cloud, colors, seed_scales = self._seed_cloud()
        capacity = min(r.n_gaussians,
                       max(2 * cloud.shape[0], cloud.shape[0] + 1024))
        with span("trainer.init_avatar_state", self.device):
            vstate = init_vanilla_avatar(
                self.avatar_model, cloud, colors=colors, capacity=capacity,
                sh_levels=r.sh_levels,
                init_scale=seed_scales if seed_scales is not None
                else r.init_scale,
                init_opacity=r.init_opacity,
                lbs_weight_smooth=r.lbs_weight_smooth,
                lbs_weight_smooth_K=r.lbs_weight_smooth_K,
                lbs_weight_smooth_N=r.lbs_weight_smooth_N)
        self.export_stats["capacity"] = capacity
        spatial = r.spatial_scale or 1.0
        self.tx = build_gaussian_optimizer(r, self.max_iteration,
                                           spatial_scale=spatial)
        self.state = gs_trainer.init_vanilla_train_state(vstate, self.tx)
        if cfg.optim.ckpt:
            step_dir = resolve_ckpt_path(cfg.optim.ckpt)
            if step_dir is not None:
                restored = load_pytree(step_dir, map_location=self.device)
                load_vanilla_tree(self.state.avatar, restored["params"])
                logger.info("warm-started vanilla avatar from %s", step_dir)
        self._build_avatar_step(self.train_res)
        rk = dict(tile_size=r.tile_size, capacity=r.tile_capacity,
                  chunk=r.chunk, placement=self._placement(),
                  static_gaussians=self._static_bg_gaussians(),
                  device=self.device)
        self.eval_render = gs_trainer.make_vanilla_render(
            self.avatar_model, cfg.data.eval_h, cfg.data.eval_w, **rk)
        self.test_render = gs_trainer.make_vanilla_render(
            self.avatar_model, cfg.data.test_h, cfg.data.test_w, **rk)
        self._init_densify_cadence(spatial)

    def _init_densify_cadence(self, spatial: float):
        r = self.cfg.render
        self.densify_cfg = DensifyConfig(
            grad_threshold=r.densify_grad_threshold,
            spatial_scale=spatial,
            min_opacity=r.densify_min_opacity,
            enable_clone=not r.densify_disable_clone,
            enable_split=not r.densify_disable_split,
            enable_prune=not r.densify_disable_prune)
        # the reference's 15k-iteration cadence scaled to this run
        self.densification_interval = r.densification_interval \
            or max(int(self.max_iteration * 100 / 15000), 1)
        self.opacity_reset_interval = r.opacity_reset_interval \
            or max(int(self.max_iteration * 3000 / 15000), 1)

    def _init_avatar(self):
        from ..system import avatar as A

        cfg = self.cfg
        r = cfg.render
        if r.gs_type == "vanilla":
            return self._init_vanilla_avatar()
        self.avatar_model = self._build_avatar_model()
        self._nerf_guidance = None
        nerf_model = None
        nerf_step_dir = resolve_ckpt_path(r.from_nerf) if r.from_nerf \
            else None
        seed_scales = None
        if nerf_step_dir is not None:
            # the stage-1 handoff: the checkpoint's field -> its point cloud
            # and the continued encoder tables and head
            nerf = self._load_stage1_field(nerf_step_dir)
            with span("trainer.export", self.device):
                pc = self._export_cloud(nerf)
            cloud = torch.as_tensor(pc.points, device=self.device)
            logger.info("NeRF point cloud: %d points", cloud.shape[0])
            self._nerf_guidance = (nerf,)   # frozen
            if not r.reset_nerf:
                nerf_model = nerf
        forced_capacity = None
        sizing_dir = self._sizing_checkpoint()
        if nerf_step_dir is None and sizing_dir is not None:
            # sub-stage handoff without from_nerf, or a resumed run: buffers
            # sized like the checkpoint, whose tensors overwrite everything
            # learnable below (or in load_checkpoint)
            raw = load_pytree(sizing_dir)
            forced_capacity = raw["params"]["positions"].shape[0]
            rng = np.random.default_rng(cfg.optim.seed)
            cloud = torch.as_tensor(
                rng.normal(size=(forced_capacity, 3)) * 0.2,
                dtype=torch.float32, device=self.device)
        elif nerf_step_dir is None:
            cloud, _, seed_scales = self._seed_cloud()

        capacity = forced_capacity or min(
            r.n_gaussians, max(2 * cloud.shape[0], cloud.shape[0] + 1024))
        with span("trainer.init_avatar_state", self.device):
            avatar_state = A.init_avatar_state(
                self.avatar_model, cloud, self.generator, capacity=capacity,
                prune_dists_close_to_mesh=r.prune_dists_close_to_mesh
                if r.prune_points_close_to_mesh
                and self.avatar_model.mesh_parts else None,
                lbs_weight_smooth=r.lbs_weight_smooth,
                lbs_weight_smooth_K=r.lbs_weight_smooth_K,
                lbs_weight_smooth_N=r.lbs_weight_smooth_N,
                init_scales=seed_scales, device=self.device,
                nerf_model=nerf_model,
                placeholder=forced_capacity is not None)
        self.export_stats["capacity"] = capacity

        spatial = r.spatial_scale or 1.0
        self.tx = build_avatar_optimizer(r, self.max_iteration,
                                         spatial_scale=spatial)
        self.state = gs_trainer.init_avatar_train_state(
            avatar_state, self.tx, self.avatar_model)

        if cfg.optim.ckpt:
            # sub-stage warm start from an earlier avatar (train_w_expr.sh
            # passes --optim.ckpt between the cnl / rcnl / rand sub-stages);
            # the optimizer starts afresh
            step_dir = resolve_ckpt_path(cfg.optim.ckpt)
            if step_dir is not None:
                restored = load_pytree(step_dir, map_location=self.device)
                try:
                    load_avatar_tree(self.state.avatar, self.avatar_model,
                                     restored["params"])
                except (KeyError, ValueError, RuntimeError) as e:
                    raise RuntimeError(
                        f"avatar checkpoint at {step_dir} does not match "
                        f"this configuration (capacity / mesh parts): {e}")
                logger.info("warm-started avatar from %s", step_dir)

        if r.use_mlp_background:
            # the trainable background: its own Adan beside the avatar's
            from ..system.background import BackgroundMLPNet
            from .optim import adan

            self.bg_net = BackgroundMLPNet(device=self.device)
            self.bg_net.reset_parameters(self.generator)
            self.bg_tx = adan(1e-3, eps=1e-8, weight_decay=2e-5,
                              max_grad_norm=5.0)
            self.bg_state = gs_trainer.init_background_train_state(
                self.bg_net, self.bg_tx)
        self._build_avatar_step(self.train_res)
        if cfg.optim.ckpt_extra:
            self._load_extra_avatar(cfg.optim.ckpt_extra)
        rk = dict(tile_size=r.tile_size, capacity=r.tile_capacity,
                  chunk=r.chunk, extra_models=self.extra_models,
                  placement=self._placement(),
                  static_gaussians=self._static_bg_gaussians(),
                  device=self.device)
        self.eval_render = gs_trainer.make_avatar_render(
            self.avatar_model, cfg.data.eval_h, cfg.data.eval_w, **rk)
        self.test_render = gs_trainer.make_avatar_render(
            self.avatar_model, cfg.data.test_h, cfg.data.test_w, **rk)
        self._init_densify_cadence(spatial)

    def _sizing_checkpoint(self) -> Optional[Path]:
        """The step directory whose avatar sizes the buffers: the latest
        checkpoint of this experiment under ``--optim.resume``, else
        ``--optim.ckpt``'s; None without either."""
        cfg = self.cfg
        if cfg.optim.resume:
            step_dir = resolve_ckpt_path(self.checkpointer.dir)
            if step_dir is not None:
                return step_dir
        if cfg.optim.ckpt:
            return resolve_ckpt_path(cfg.optim.ckpt)
        return None

    def _load_extra_avatar(self, ckpt) -> None:
        """Scene composition: a second avatar from another run's port
        checkpoint (its step directory or experiment), buffers sized like
        it, the tensors and networks restored."""
        from ..system import avatar as A

        step_dir = resolve_ckpt_path(ckpt)
        if step_dir is None:
            return
        raw = load_pytree(step_dir, map_location=self.device)
        cap2 = raw["params"]["positions"].shape[0]
        rng = np.random.default_rng(self.cfg.optim.seed + 7)
        cloud2 = torch.as_tensor(rng.normal(size=(cap2, 3)) * 0.2,
                                 dtype=torch.float32, device=self.device)
        model2 = self._build_avatar_model()
        state2 = A.init_avatar_state(
            model2, cloud2, self.generator, capacity=cap2,
            prune_dists_close_to_mesh=None, device=self.device,
            placeholder=True)
        load_avatar_tree(state2, model2, raw["params"])
        self.extra_states = (state2,)
        self.extra_models = (model2,)
        logger.info("loaded extra avatar from %s", step_dir)

    def _build_avatar_step(self, H: int):
        kw = self._common_step_kwargs()
        if self.mesh is not None:
            # the B-view steps, the JAX trainer's DP steps (their tile
            # cap of 8 a Gaussian: its trainer does not pass one)
            from ..parallel import dp

            kw.update(per_view_poses=self.cfg.data.per_view_poses,
                      mesh=self.mesh)
            if self.cfg.render.gs_type == "vanilla":
                make = dp.make_vanilla_sds_step_dp
            else:
                make = dp.make_avatar_sds_step_dp
                kw.update(bg_net=self.bg_net,
                          bg_tx=getattr(self, "bg_tx", None))
        elif self.cfg.render.gs_type == "vanilla":
            make = gs_trainer.make_vanilla_sds_step
        elif self._split_step():
            # the trainable background's host: the split step (on the card
            # only then; the JAX trainer also takes it on a TPU without
            # --optim.fused_step)
            make = gs_trainer.make_avatar_sds_step_split
            kw.update(bg_net=self.bg_net, bg_tx=self.bg_tx)
        else:
            make = gs_trainer.make_avatar_sds_step
        self.sds_step_fn = make(self.avatar_model, self.guidance, H, H, **kw)

    def _split_step(self) -> bool:
        """Whether the avatar trains through the split step: with the MLP
        background, but for the x0 modes, whose pixel-space loss has no
        latent gradient to split on; they take the fused step, and the
        background then is not trained (the JAX trainer's routing). The
        B-view step trains the background itself."""
        return self.bg_state is not None and self.mesh is None \
            and not self.cfg.guide.sds_loss_type.startswith("x0")

    # ------------------------------------------------------------------
    # data assembly (host side; the prefetch worker runs it)
    # ------------------------------------------------------------------

    def _train_batch(self, step: Optional[int] = None) -> Dict[str, Any]:
        """One training draw for ``step``: B = ``--optim.batch_size``
        cameras and view texts, the pose (one a view with
        ``--data.per_view_poses`` in stage gs, drawn at ``batch_idx = step
        * B + i``), the B condition images (each from its view's pose), B
        timesteps, the guidance scale and the progress, in the JAX
        trainer's order. ``step`` is the step the batch is for: the worker
        builds step N + 1's while the card runs step N."""
        if step is None:
            step = self.train_step
        cfg = self.cfg
        B = self.batch_size
        with record_function("trainer.batch"):
            rpi = cfg.data.random_pose_iter
            per_view = cfg.data.per_view_poses and B > 1 \
                and cfg.stage == "gs"
            if rpi and self.prompt.scene_type == "random" \
                    and getattr(self, "_pose_cache", None) is not None \
                    and step % rpi != 0:
                smpl_inputs, smpl_outputs, view_outputs = self._pose_cache
            elif per_view:
                draws = [self.prompt(batch_idx=step * B + i)
                         for i in range(B)]
                smpl_inputs = SMPLXParams(*[
                    torch.cat(xs) for xs in zip(*[d[0] for d in draws])])
                view_outputs = [d[1] for d in draws]
                smpl_outputs = view_outputs[0]
                self._pose_cache = (smpl_inputs, smpl_outputs, view_outputs)
            else:
                smpl_inputs, smpl_outputs = self.prompt(batch_idx=step)
                view_outputs = None
                self._pose_cache = (smpl_inputs, smpl_outputs, None)

            # --render.always_animate=false in the plain canonical scene:
            # the render observes the canonical pose (one a view), the
            # conditions and text the sampled one
            render_inputs = smpl_inputs
            if cfg.stage == "gs" and not cfg.render.always_animate \
                    and cfg.prompt.scene == "canonical":
                n = smpl_inputs.body_pose.shape[0]
                render_inputs = SMPLXParams(*[
                    x.expand((n,) + x.shape[1:])
                    for x in self.prompt.canonical_inputs])

            cams, parts, view_indices = [], [], []
            for _ in range(B):
                cam, part = self.train_camera(1)
                cams.append(cam)
                parts.append(part)
                view_indices.append(int(self.view_prompt(
                    cam.azimuth.cpu().numpy(), cam.elevation.cpu().numpy(),
                    part)[0]))
            cam = cams[0] if B == 1 else type(cams[0])(*[
                torch.cat(xs) if torch.is_tensor(xs[0]) else xs[0]
                for xs in zip(*cams)])
        cond_image = None
        if cfg.guide.use_controlnet:
            with record_function("trainer.condition"):
                imgs = self.prompt.get_cond_images_batch(
                    view_outputs or [smpl_outputs] * B, cam.extrinsic,
                    cam.intrinsics,
                    cond_type=cfg.guide.controlnet_condition[0],
                    height=self.cond_size, width=self.cond_size)
                cond_image = torch.as_tensor(
                    np.stack([np.asarray(im, np.float32) / 255.0
                              for im in imgs]), device=self.device)
        if cfg.guide.sds_loss_type == "ism":
            t = self.t_scheduler.get_ism_timestep(B, step,
                                                  self.max_iteration)
        else:
            t = self.t_scheduler.get_timestep(B, step, self.max_iteration)
        gs_scale = self.t_scheduler.get_guidance_scale(step,
                                                       self.max_iteration)
        return dict(cam=cam, part=parts[0], view_idx=view_indices[0],
                    view_indices=view_indices,
                    smpl_inputs=render_inputs, cond_image=cond_image,
                    text=torch.stack([self.text_embeds[i]
                                      for i in view_indices]),
                    uncond=self.uncond_embeds[:1].expand(
                        B, *self.uncond_embeds.shape[1:]),
                    t=torch.as_tensor(np.asarray(t), device=self.device),
                    guidance_scale=float(gs_scale),
                    progress=step / max(self.max_iteration, 1))

    def _resolution_target(self) -> int:
        ratio = self.train_step / self.max_iteration
        target = sum(1 for m in self.grid_milestones if ratio >= m)
        return min(target, len(self.train_resolutions) - 1)

    def _maybe_switch_resolution(self) -> bool:
        """The progressive training resolution (64 -> 128 -> 256); True
        when it changed (a batch prefetched at the old one is dropped)."""
        target = self._resolution_target()
        if target == self._res_index:
            return False
        self._res_index = target
        self.train_res = self.train_resolutions[target]
        logger.info("switching train resolution to %d", self.train_res)
        self.train_camera = RandomCamera4Avatar(
            self.cfg.data, self.train_res, self.train_res,
            seed=self.cfg.optim.seed + target, device=self.device)
        self.train_camera.training_ratio = \
            self.train_step / self.max_iteration
        kp = self._canonical_keypoints()
        if np.isfinite(kp[:, :18]).all():
            self.train_camera.setup_camera_offset(kp)
        self._rebuild_train_step()
        return True

    def _rebuild_train_step(self):
        if self.cfg.stage == "nerf":
            self._build_nerf_sds_step(self.train_res)
            self._build_pretrain_step(self.train_res)
        else:
            self._build_avatar_step(self.train_res)

    def _bg_color(self) -> torch.Tensor:
        if self.cfg.stage == "nerf":
            c = COLOR_PRESETS.get(self.cfg.nerf.bg_mode, (0.5, 0.5, 0.5))
            if self.cfg.nerf.rand_bg_prob \
                    and self.rng.random() < self.cfg.nerf.rand_bg_prob:
                c = tuple(self.rng.random(3))
        else:
            c = tuple(self.cfg.render.bg_color)
        return torch.as_tensor(c, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------

    def train(self, on_step=None, prefetch: bool = True) -> None:
        """The loop; a runtime failure saves an emergency checkpoint and
        renders the eval track, then re-raises (an error of the eval
        raises in its place, chained to it). ``on_step(step)`` runs on the
        main thread after each step's update, before its logging,
        snapshots, evaluation and checkpoint; ``prefetch=False`` builds
        each batch on the main thread just before its step."""
        try:
            self._train_loop(on_step, prefetch)
        except RuntimeError:
            logger.exception("training crashed at step %d — saving "
                             "emergency checkpoint", self.train_step)
            self.save_checkpoint()
            self.evaluate()
            raise

    def _train_loop(self, on_step=None, prefetch: bool = True) -> None:
        """The next step's batch is built on a worker thread while this
        step runs. Both threads issue to the card's one stream, so the
        worker's tensors are complete before the step's kernels, which are
        queued after the future's result; the worker draws only from
        generators of its own (the camera's, the scheduler's, the
        prompt's)."""
        import concurrent.futures as cf

        cfg = self.cfg
        log_interval = max(cfg.log.snapshot_interval, 1)
        t0 = time.time()
        pool = cf.ThreadPoolExecutor(max_workers=1)
        pending = None
        try:
            while self.train_step < self.max_iteration:
                self.train_step += 1
                if pending is not None and self._will_mutate_shared_state():
                    pending.result()
                    pending = None
                self.prompt.training_ratio = \
                    self.train_step / self.max_iteration
                self.train_camera.training_ratio = self.prompt.training_ratio
                switched = self._maybe_switch_resolution()
                if pending is not None and not switched:
                    batch = pending.result()
                else:
                    if pending is not None:
                        pending.result()
                    batch = self._train_batch(self.train_step)
                pending = None
                if prefetch and self.train_step < self.max_iteration \
                        and not self._post_step_mutates(self.train_step):
                    pending = pool.submit(self._train_batch,
                                          self.train_step + 1)
                metrics = self._train_one(batch)
                if on_step is not None:
                    on_step(self.train_step)
                self._post_step(batch, metrics, log_interval, t0)
                if prefetch and pending is None \
                        and self.train_step < self.max_iteration:
                    pending = pool.submit(self._train_batch,
                                          self.train_step + 1)
            self.save_checkpoint()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def _post_step_mutates(self, step: int) -> bool:
        """Whether the step's post-step work must run before the next batch
        draws: a snapshot or an evaluation draws from the prompt and reads
        the cameras, a checkpoint saves the generators' states."""
        lg = self.cfg.log
        return any(n and step % n == 0 for n in (
            lg.snapshot_interval, lg.evaluate_interval, lg.save_interval))

    def _will_mutate_shared_state(self) -> bool:
        # a resolution switch rebuilds self.train_camera
        return self._resolution_target() != self._res_index

    def _post_step(self, batch, metrics, log_interval, t0) -> None:
        cfg = self.cfg
        if self.train_step % log_interval == 0 or self.train_step == 1:
            loss = float(metrics.get("loss", np.nan))
            self.losses.append(loss)
            ovf = metrics.get("tile_overflow")
            logger.info("step %d/%d loss=%.4f (%.2f s/it)%s",
                        self.train_step, self.max_iteration, loss,
                        (time.time() - t0) / self.train_step,
                        "" if ovf is None
                        else " tile_overflow=%.4f" % float(ovf))
        if cfg.log.snapshot_interval and \
                self.train_step % cfg.log.snapshot_interval == 0:
            self._snapshot(batch)
        if cfg.log.evaluate_interval and \
                self.train_step % cfg.log.evaluate_interval == 0:
            self.evaluate()
        if cfg.log.save_interval and \
                self.train_step % cfg.log.save_interval == 0:
            self.save_checkpoint()

    def _train_one(self, batch) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        cam = batch["cam"]
        with record_function("trainer.step"):
            if self.dmtet_model is not None:
                # no occupancy grid and no sigma guidance: the surface is
                # the density structure now
                self.state, metrics = self.sds_step_fn(
                    self.state, self.guidance_params, cam.extrinsic[0],
                    cam.intrinsics[0], cam.c2w[0][:3, 3], self._bg_color(),
                    batch["text"], batch["uncond"], batch["t"],
                    generator=self.generator,
                    cond_image=batch["cond_image"],
                    guidance_scale=batch["guidance_scale"],
                    progress=batch["progress"])
            elif cfg.stage == "nerf":
                self.grid = nerf_trainer.maybe_update_occupancy(
                    self.state, self.grid, self.nerf,
                    interval=cfg.nerf.update_extra_interval,
                    density_thresh=cfg.nerf.density_thresh,
                    generator=self.generator)
                sigma_pts = None
                use_sigma = cfg.use_sigma_guidance \
                    and self.rng.random() < cfg.sigma_prob
                if use_sigma:
                    sigma_pts = make_sigma_guidance_points(
                        self.prompt.canonical_outputs.vertices[0],
                        self.smpl.faces, num_points=cfg.sigma_num_points,
                        noise_range=cfg.sigma_noise_range,
                        surface_thickness=cfg.sigma_surface_thickness,
                        generator=self.generator)
                kw = dict(cond_image=batch["cond_image"],
                          guidance_scale=batch["guidance_scale"],
                          sigma_pts=sigma_pts, use_sigma=use_sigma,
                          progress=batch["progress"])
                if self.mesh is not None:
                    # a background colour and a generator a view
                    B = self.batch_size
                    bg = torch.stack([self._bg_color() for _ in range(B)])
                    self.state, metrics = self.sds_step_fn(
                        self.state, self.grid, self.guidance_params,
                        cam.c2w, cam.intrinsics, bg, batch["text"],
                        batch["uncond"], batch["t"],
                        generator=self._view_generators(B), **kw)
                else:
                    self.state, metrics = self.sds_step_fn(
                        self.state, self.grid, self.guidance_params,
                        cam.c2w[0], cam.intrinsics[0], self._bg_color(),
                        batch["text"], batch["uncond"], batch["t"],
                        generator=self.generator, **kw)
            elif self.mesh is not None:
                B = self.batch_size
                bg = self._bg_color().expand(B, self.train_res,
                                             self.train_res, 3)
                args = (self.state, self.guidance_params,
                        batch["smpl_inputs"], cam.extrinsic, cam.intrinsics,
                        cam.tanfov, bg, batch["text"], batch["uncond"],
                        batch["t"])
                kw = dict(cond_image=batch["cond_image"],
                          guidance_scale=batch["guidance_scale"],
                          generator=self._view_generators(B),
                          progress=batch["progress"])
                if self.bg_state is not None:
                    self.state, self.bg_state, metrics = self.sds_step_fn(
                        *args, bg_state=self.bg_state, c2w=cam.c2w, **kw)
                else:
                    self.state, metrics = self.sds_step_fn(*args, **kw)
                self._maybe_densify()
            else:
                bg = self._bg_color().expand(self.train_res, self.train_res,
                                             3)
                args = (self.state, self.guidance_params,
                        batch["smpl_inputs"], cam.extrinsic[0],
                        cam.intrinsics[0], cam.tanfov[0], bg, batch["text"],
                        batch["uncond"], batch["t"][:1])
                kw = dict(cond_image=batch["cond_image"],
                          guidance_scale=batch["guidance_scale"],
                          generator=self.generator,
                          progress=batch["progress"])
                if self._split_step():
                    self.state, self.bg_state, metrics = self.sds_step_fn(
                        *args, bg_state=self.bg_state, c2w=cam.c2w[0], **kw)
                else:
                    self.state, metrics = self.sds_step_fn(*args, **kw)
                self._maybe_densify()
        return metrics

    def _view_generators(self, B: int) -> List[torch.Generator]:
        """One generator a view for a multi-view step (the JAX trainer's
        ``jax.random.split(key, B)``), seeded from ``_view_rng``."""
        seeds = self._view_rng.integers(0, 2 ** 62, size=B)
        return [torch.Generator(device=self.device).manual_seed(int(x))
                for x in seeds]

    def _maybe_densify(self):
        """Clone / split / prune every ``densification_interval`` steps in
        the [densify_from_iter, densify_until_iter) window."""
        r = self.cfg.render
        if not r.use_densifier or r.densify_from_iter is None:
            return
        in_window = r.densify_from_iter <= self.train_step \
            and (r.densify_until_iter is None
                 or self.train_step < r.densify_until_iter)
        if not in_window:
            return
        vanilla = r.gs_type == "vanilla"
        if self.train_step % self.densification_interval == 0:
            dcfg = self.densify_cfg
            if r.enable_grad_prune:
                # grad-prune holds for the first third of the window; the
                # mode flips off only after the first event past the
                # boundary
                until = r.densify_until_iter or self.max_iteration
                window = (until - r.densify_from_iter) / 3
                dcfg = dcfg._replace(
                    grad_prune=self.train_step - self.densification_interval
                    <= r.densify_from_iter + window)
            def alive():
                a = self.state.avatar
                return int((a.gaussians if vanilla else a).alive.sum())

            n_before = alive()
            if vanilla:
                self.state = gs_trainer.densify_vanilla(self.state, dcfg,
                                                        self.generator)
            else:
                self.state = gs_trainer.densify(self.state, dcfg,
                                                self.generator,
                                                model=self.avatar_model)
            logger.info("densify @%d: %d -> %d alive", self.train_step,
                        n_before, alive())
        # the periodic opacity reset: vanilla only, where opacity is a
        # parameter
        if vanilla and not r.densify_disable_reset \
                and self.train_step % self.opacity_reset_interval == 0:
            self.state = gs_trainer.reset_vanilla_opacity(
                self.state, value=self.densify_cfg.opacity_reset_value)
            logger.info("opacity reset @%d", self.train_step)

    def pretrain(self) -> None:
        """``--log.pretrain_only``: fit the field to the SMPL-X body's depth
        and mask (``scripts/pretrain_nerf.sh``; the human template that a
        stage-1 run warm-starts from with ``--optim.ckpt``). Each step: a
        training camera, the prompt's pose, its metric depth and mask at
        the training resolution, the occupancy refresh on its cadence, one
        ``make_pretrain_step`` update; a checkpoint at the end. With
        ``--log.resume_pretrain`` (the default) an existing checkpoint of
        the experiment is restored and nothing is trained. Spans:
        ``trainer.pretrain_batch`` (camera, pose, depth raster) and
        ``trainer.pretrain_step`` (occupancy refresh and update)."""
        cfg = self.cfg
        if cfg.stage != "nerf":
            raise ValueError("log.pretrain_only needs --stage nerf")
        if cfg.log.resume_pretrain:
            try:
                self.load_checkpoint()
                logger.info("resume_pretrain: reusing checkpoint at step "
                            "%d", self.train_step)
                return
            except FileNotFoundError:
                pass
        H = self.train_res
        while self.train_step < self.max_iteration:
            self.train_step += 1
            with span("trainer.pretrain_batch", self.device):
                cam, _ = self.train_camera(1)
                _, smpl_outputs = self.prompt()
                depth, mask = self.prompt.condition.render_depth(
                    smpl_outputs, cam.extrinsic[0], cam.intrinsics[0], H, H,
                    raw=True)
            with span("trainer.pretrain_step", self.device):
                self.grid = nerf_trainer.maybe_update_occupancy(
                    self.state, self.grid, self.nerf,
                    interval=cfg.nerf.update_extra_interval,
                    density_thresh=cfg.nerf.density_thresh,
                    generator=self.generator)
                self.state, metrics = self.pretrain_step_fn(
                    self.state, self.grid, cam.c2w[0], cam.intrinsics[0],
                    torch.as_tensor(depth, dtype=torch.float32,
                                    device=self.device),
                    torch.as_tensor(mask, device=self.device),
                    generator=self.generator)
            if self.train_step % max(cfg.log.snapshot_interval, 1) == 0 \
                    or self.train_step == 1:
                loss = float(metrics["loss"])
                self.losses.append(loss)
                logger.info("pretrain %d/%d loss=%.5f", self.train_step,
                            self.max_iteration, loss)
        self.save_checkpoint()

    def pretrain_nerf2gs(self) -> None:
        """``--log.nerf2gs``: distill the frozen stage-1 field
        (``--render.from_nerf``) into the avatar. Each step: a training
        camera, the prompt's pose, the field's render from that camera
        (``make_eval_render`` on a fresh all-occupied grid, over the
        training background), one ``make_nerf2gs_step`` update (L1 + DSSIM
        on the field's foreground); a checkpoint at the end. The field
        takes no gradient and is never written. Spans:
        ``trainer.nerf2gs_target`` and ``trainer.nerf2gs_step``."""
        cfg = self.cfg
        if cfg.stage != "gs" or self._nerf_guidance is None:
            raise ValueError("nerf2gs needs --stage gs and --render.from_nerf "
                             "pointing at a stage-1 checkpoint")
        (nerf,) = self._nerf_guidance
        H = self.train_res
        grid = init_occupancy(cfg.nerf.grid_size, device=self.device)
        nerf_render = nerf_trainer.make_eval_render(
            nerf, H, H, num_steps=cfg.nerf.num_steps, device=self.device)
        r = cfg.render
        step_fn = gs_trainer.make_nerf2gs_step(
            self.avatar_model, H, H, tile_size=r.tile_size,
            capacity=r.tile_capacity, chunk=r.chunk, device=self.device)
        while self.train_step < self.max_iteration:
            self.train_step += 1
            cam, _ = self.train_camera(1)
            smpl_inputs, _ = self.prompt()
            bg = self._bg_color()
            with span("trainer.nerf2gs_target", self.device):
                target, _, alpha = nerf_render(grid, cam.c2w[0],
                                               cam.intrinsics[0], bg)
            with span("trainer.nerf2gs_step", self.device):
                self.state, metrics = step_fn(
                    self.state, smpl_inputs, cam.extrinsic[0],
                    cam.intrinsics[0], cam.tanfov[0], bg.expand(H, H, 3),
                    target, alpha)
            if self.train_step % max(cfg.log.snapshot_interval, 1) == 0 \
                    or self.train_step == 1:
                loss = float(metrics["loss"])
                self.losses.append(loss)
                logger.info("nerf2gs %d/%d loss=%.5f", self.train_step,
                            self.max_iteration, loss)
        self.save_checkpoint()

    def export_mesh(self) -> str:
        """``--log.nerf2mesh``: the stage-1 field as ``mesh/mesh.obj``,
        ``mesh.mtl`` and ``albedo.png`` under the experiment (marching
        tets at ``--log.mesh_resolution``, cleaned, decimated to
        ``--log.mesh_decimate_target`` when > 0, UV-unwrapped, its albedo
        baked at ``--log.mesh_texture_size``). Restore the field first
        (``--optim.resume true``). Returns the OBJ's path."""
        if self.cfg.stage != "nerf":
            raise ValueError("log.nerf2mesh needs --stage nerf")
        from ..nerf.mesh_export import export_textured_mesh

        lg = self.cfg.log
        if not self.is_writer:
            return str(self.exp_dir / "mesh" / "mesh.obj")
        with span("trainer.export_mesh", self.device):
            out = export_textured_mesh(
                self.nerf, str(self.exp_dir / "mesh"),
                resolution=lg.mesh_resolution,
                density_thresh=self.cfg.nerf.density_thresh,
                decimate_target=lg.mesh_decimate_target,
                texture_size=lg.mesh_texture_size)
        logger.info("exported textured mesh to %s", out)
        return out

    def check(self) -> None:
        """``--log.check``: sanity exports under ``check/`` before training:
        the timestep schedule's curve (skipped with a warning when
        matplotlib is absent, and in a 0-step run, which has no schedule)
        and the condition images of a pose draw at azimuths 0, 90, 180 and
        270 (the metric ``depth_raw`` pair is not an image and is skipped);
        with ``--log.check_sd`` also the frozen guidance's DDIM samples
        (``_check_sd``). Any other error raises."""
        cfg = self.cfg
        d = self.exp_dir / "check"
        if self.max_iteration < 1:
            logger.warning("timestep curve skipped: a run of %d steps has "
                           "no schedule", self.max_iteration)
        elif self.is_writer:
            try:
                draw_curves(self.t_scheduler, self.max_iteration,
                            str(d / "timestep_curve.png"))
            except ImportError as e:
                logger.warning("timestep curve export failed: %s", e)
        _, smpl_outputs = self.prompt()
        cond_arrays = {}
        first = cfg.guide.controlnet_condition[0]
        for azim in (0.0, 90.0, 180.0, 270.0):
            cam = make_camera_batch(2.0, azim, 80.0, 60.0, self.cond_size,
                                    self.cond_size, device=self.device)
            for cond in cfg.guide.controlnet_condition:
                img = self.prompt.get_cond_images(
                    smpl_outputs, cam.extrinsic[0], cam.intrinsics[0],
                    cond_type=cond, height=self.cond_size,
                    width=self.cond_size)[0]
                if isinstance(img, tuple):
                    continue
                self._save_image(d / f"cond_{cond}_az{int(azim)}.png", img)
                # the samples pair the ControlNet with the modality that
                # training uses, controlnet_condition[0]
                if cond == first:
                    cond_arrays[azim] = np.asarray(img, np.float32) / 255.0
        if cfg.log.check_sd:
            self._check_sd(d, cond_arrays)
        logger.info("sanity exports written to %s", d)

    def _check_sd(self, d: Path, cond_arrays: Dict[float, np.ndarray]
                  ) -> None:
        """The frozen guidance's DDIM samples of the prompt's first view
        text (``--log.check_sd_steps`` steps): with a ControlNet, one
        sample per condition view (``control_az<azimuth>.png``), then one
        without it at each guidance scale of {7.5, guide.guidance_scale}
        (``sd_<scale>.png``); the noise from the trainer's generator."""
        steps = self.cfg.log.check_sd_steps
        g, gp = self.guidance, self.guidance_params
        txt, unc = self.text_embeds[:1], self.uncond_embeds[:1]
        with span("trainer.check_sd", self.device):
            if gp.controlnet is not None:
                for azim, cond in cond_arrays.items():
                    img = g.sample_images(
                        gp, txt, unc, self.generator,
                        num_inference_steps=steps,
                        cond_image=torch.as_tensor(
                            cond, device=self.device)[None])
                    self._save_image(d / f"control_az{int(azim)}.png",
                                     img[0].float().cpu().numpy())
            for gs_val in {7.5, float(self.cfg.guide.guidance_scale)}:
                img = g.sample_images(gp, txt, unc, self.generator,
                                      num_inference_steps=steps,
                                      guidance_scale=gs_val)
                self._save_image(d / f"sd_{gs_val:g}.png",
                                 img[0].float().cpu().numpy())
        logger.info("check_sd samples written to %s", d)

    # ------------------------------------------------------------------
    # snapshots, evaluation, inference
    # ------------------------------------------------------------------

    def _snapshot(self, batch) -> None:
        """The current model from the eval track's first camera, in the
        batch's pose, and the batch's condition image, under
        ``snapshots/train/``; with ``--guide.grad_viz`` the SDS gradient's
        picture too. An error raises: nothing here may hide a failed
        launch."""
        cfg = self.cfg
        d = self.exp_dir / "snapshots" / "train"
        cam = self.eval_camera(0.0)
        if cfg.stage == "gs":
            # the first view's pose (a multi-view batch may hold one a view)
            obs = SMPLXParams(*[x[:1] for x in batch["smpl_inputs"]])
            img, _, _ = self.eval_render(
                self.state.avatar, obs, cam.extrinsic[0],
                cam.intrinsics[0], cam.tanfov[0],
                torch.zeros((cfg.data.eval_h, cfg.data.eval_w, 3),
                            device=self.device), self.extra_states)
        elif self.dmtet_model is not None:
            img, _, _ = self.eval_render(
                self.state, cam.c2w[0], cam.intrinsics[0],
                torch.full((3,), 0.5, device=self.device))
        else:
            img, _, _ = self.eval_render(
                self.grid, cam.c2w[0], cam.intrinsics[0],
                torch.full((3,), 0.5, device=self.device))
        self._save_image(d / f"{self.train_step:06d}_rgb.png",
                         torch.clamp(img, 0, 1).cpu().numpy())
        if batch.get("cond_image") is not None:
            self._save_image(d / f"{self.train_step:06d}_cond.png",
                             batch["cond_image"][0].float().cpu().numpy())
        if cfg.guide.grad_viz:
            self._snapshot_grad_viz(d, batch, img)

    @torch.no_grad()
    def _snapshot_grad_viz(self, d, batch, img) -> None:
        """The latent SDS gradient of the snapshot's render: its per-pixel
        magnitude and the VAE decode of the latents moved against it (the
        direction SDS pulls toward)."""
        g, gp = self.guidance, self.guidance_params
        if img.shape[-1] != 3:
            return
        if g.loss_type.startswith("x0"):
            # pixel-space: no latent gradient (the JAX trainer's snapshot
            # fails on it and logs a warning)
            logger.warning("grad_viz: the x0 modes have no latent gradient")
            return
        latents = g.encode_images(gp, img[None].to(batch["text"].dtype))
        grad = g.latent_gradients(
            gp, latents, batch["text"][:1], batch["uncond"][:1],
            batch["t"][:1], cond_image=None if batch.get("cond_image") is None
            else batch["cond_image"][:1],
            guidance_scale=batch.get("guidance_scale"),
            generator=self.generator, neg_embeds=self.neg_embeds,
            progress=batch.get("progress"))
        mag = torch.linalg.norm(grad[0], dim=-1)
        mag = mag / torch.clamp(mag.max(), min=1e-8)
        self._save_image(d / f"{self.train_step:06d}_gradmag.png",
                         mag.cpu().numpy())
        target = gp.vae.decode(latents.float() - grad)
        self._save_image(d / f"{self.train_step:06d}_gradtarget.png",
                         torch.clamp(target[0].float(), 0, 1).cpu().numpy())

    def _save_image(self, path: Path, img) -> None:
        """``save_image`` on rank 0; the other ranks computed the same
        image and write nothing."""
        if self.is_writer:
            save_image(str(path), img)

    def _eval_background(self, Hc: int, Wc: int, i: int, video_bg,
                         cam=None) -> torch.Tensor:
        """Frame ``i``'s background: the video's frame resized to the
        render, else the MLP background at the eval camera ``cam`` (None on
        a predefined camera track: the eval color then), else the eval
        color (stage 2: (Hc, Wc, 3); stage 1: (3,))."""
        cfg = self.cfg
        if video_bg is not None:
            bg = video_bg.frames[i % video_bg.frames.shape[0]]
            if tuple(bg.shape[:2]) != (Hc, Wc):
                bg = resize_images(bg[None], Hc, Wc)[0]
            return bg
        if self.bg_state is not None and cam is not None:
            from ..system.background import mlp_background_image

            with torch.no_grad():
                return mlp_background_image(self.bg_net, cam.c2w[0],
                                            cam.intrinsics[0], Hc, Wc)
        if cfg.stage == "gs":
            c = COLOR_PRESETS.get(cfg.data.eval_bg_mode, cfg.render.bg_color) \
                if cfg.data.eval_bg_mode else cfg.render.bg_color
            return torch.as_tensor(c, dtype=torch.float32,
                                   device=self.device).expand(Hc, Wc, 3)
        c = COLOR_PRESETS.get(cfg.data.eval_bg_mode or "gray",
                              (0.5, 0.5, 0.5))
        return torch.as_tensor(c, dtype=torch.float32, device=self.device)

    def evaluate(self, size: Optional[int] = None,
                 save_dir: Optional[Path] = None,
                 use_test_res: bool = False) -> List[np.ndarray]:
        """Render ``size`` frames of the eval track (the test resolution
        with ``use_test_res``) and write them as PNGs and an mp4 under
        ``results/step_<step>``; returns the (H, W, 3) frames in [0, 1].

        A motion scene animates frame i of its sequence (frame 0 under
        ``--data.eval_fix_animation``), any other scene draws a pose from
        the prompt. The reenact / TRAM scenes take their own camera track
        at its own size (not under ``--data.cameras cyclical``). A
        ``--render.use_video_background`` ending in '.mp4' is read as the
        background, and the avatar's RGBA is also laid over it at its own
        size (``results/step_<step>_overlay.mp4``). Stage-2 frames on the
        eval track render in chunks of at most 8 through
        ``make_avatar_render_frames``: the sorted blend (B2) once a frame,
        with no padded frames, since nothing here is compiled for a
        static chunk length."""
        cfg = self.cfg
        size = size or cfg.data.eval_size
        save_dir = Path(save_dir or (
            self.exp_dir / (cfg.log.eval_dirname or "results")))
        camera = self.test_camera if use_test_res else self.eval_camera
        # stage 2's avatar render (stage 1 renders through its field below)
        render = getattr(self, "test_render", None) if use_test_res \
            else self.eval_render
        H = cfg.data.test_h if use_test_res else cfg.data.eval_h
        W = cfg.data.test_w if use_test_res else cfg.data.eval_w
        rk = dict(tile_size=cfg.render.tile_size,
                  capacity=cfg.render.tile_capacity, chunk=cfg.render.chunk,
                  device=self.device)

        predefined = self.prompt.camera_sequences is not None \
            and cfg.data.cameras != "cyclical" and cfg.stage == "gs"
        video_bg = None
        vb = cfg.render.use_video_background
        if vb and str(vb).endswith(".mp4"):
            frames_arr = read_video(str(vb))
            if frames_arr.size:
                video_bg = VideoBackground(frames_arr, device=self.device)
        reenact_render = None
        overlay_rgba = [] if video_bg is not None else None
        # the vanilla avatar and a composed scene render frame by frame, as
        # in the JAX package; the chunked frames take neither the placement
        # nor the Gaussian background, as the JAX package's do not
        pending = [] if cfg.stage == "gs" and not predefined and size > 1 \
            and cfg.render.gs_type != "vanilla" \
            and not self.extra_states else None

        def rgba(img, alpha):
            return np.concatenate([torch.clamp(img, 0, 1).cpu().numpy(),
                                   alpha.cpu().numpy()[..., None]], -1)

        frames = []
        with span("evaluate.render", self.device):
            for i in range(size):
                p = i / max(size, 1)
                if self.prompt.scene_type == "motion":
                    smpl_inputs, _ = self.prompt(
                        frame_idx=0 if cfg.data.eval_fix_animation else i)
                else:
                    smpl_inputs, _ = self.prompt()
                if predefined:
                    cp = self.prompt.get_camera_params_from_sequences(i)
                    extr, intr = cp["extrinsic"], cp["intrinsics"]
                    tanfov = torch.tensor(cp["tanfov"], dtype=torch.float32,
                                          device=self.device)
                    Hc, Wc = cp["image_height"], cp["image_width"]
                    if reenact_render is None:
                        # the camera track's render composes the extra
                        # avatars, unplaced and without the Gaussian
                        # background, as the JAX package's does
                        reenact_render = \
                            gs_trainer.make_vanilla_render(
                                self.avatar_model, Hc, Wc, **rk) \
                            if cfg.render.gs_type == "vanilla" else \
                            gs_trainer.make_avatar_render(
                                self.avatar_model, Hc, Wc,
                                extra_models=self.extra_models, **rk)
                else:
                    cam = camera(p)
                    extr, intr = cam.extrinsic[0], cam.intrinsics[0]
                    tanfov = cam.tanfov[0]
                    Hc, Wc = H, W
                bg = self._eval_background(Hc, Wc, i, video_bg,
                                           None if predefined else cam)

                if self.dmtet_model is not None:
                    img, _, _ = self.eval_render(self.state, cam.c2w[0],
                                                 cam.intrinsics[0], bg)
                elif cfg.stage == "nerf":
                    img, _, _ = self.eval_render(self.grid, cam.c2w[0],
                                                 cam.intrinsics[0], bg)
                elif pending is not None:
                    pending.append((smpl_inputs, extr, intr, tanfov, bg))
                    frames.append(None)   # filled by the chunked pass
                    continue
                else:
                    r = reenact_render if predefined else render
                    if overlay_rgba is not None:
                        # over a transparent background, composited here;
                        # the RGBA kept for the overlay export
                        img0, alpha, _ = r(
                            self.state.avatar, smpl_inputs, extr, intr,
                            tanfov, torch.zeros((Hc, Wc, 3),
                                                device=self.device),
                            self.extra_states)
                        overlay_rgba.append(rgba(img0, alpha))
                        img = img0 + (1.0 - alpha)[..., None] * bg
                    else:
                        img, _, _ = r(self.state.avatar, smpl_inputs, extr,
                                      intr, tanfov, bg, self.extra_states)
                frames.append(torch.clamp(img, 0, 1).cpu().numpy())

            if pending:
                eval_mesh = self._eval_mesh(len(pending))
                rf = gs_trainer.make_avatar_render_frames(
                    self.avatar_model, H, W, mesh=eval_mesh, **rk)
                if eval_mesh is None:
                    Fc = min(8, len(pending))
                else:
                    # a multiple of D, at most 8 frames a rank a chunk
                    D = eval_mesh.world
                    Fc = min(8 * D, -(-len(pending) // D) * D)
                for s0 in range(0, len(pending), Fc):
                    chunk = pending[s0: s0 + Fc]
                    n = len(chunk)
                    if eval_mesh is not None:
                        # the last chunk padded with its last frame
                        chunk = chunk + [chunk[-1]] * (Fc - n)
                    obs = type(chunk[0][0])(*[
                        torch.stack(xs) for xs in zip(*[c[0] for c in chunk])])
                    extr, intr, tf, bgs = (torch.stack([c[k] for c in chunk])
                                           for k in range(1, 5))
                    if overlay_rgba is not None:
                        imgs, alphas, _ = rf(
                            self.state.avatar, obs, extr, intr, tf,
                            torch.zeros((H, W, 3), device=self.device))
                        for j in range(n):
                            overlay_rgba.append(rgba(imgs[j], alphas[j]))
                        imgs = imgs + (1.0 - alphas)[..., None] * bgs
                    else:
                        imgs, _, _ = rf(self.state.avatar, obs, extr, intr,
                                        tf, bgs)
                    imgs = torch.clamp(imgs[:n], 0, 1).cpu().numpy()
                    frames[s0: s0 + n] = list(imgs)

        if not self.is_writer:
            return frames
        with span("evaluate.write"):
            step_dir = save_dir / f"step_{self.train_step:06d}"
            if cfg.data.eval_save_image:
                for i, f in enumerate(frames):
                    save_image(str(step_dir / f"{i:04d}.png"), f)
            if cfg.data.eval_save_video and len(frames) > 1:
                write_video(str(step_dir) + ".mp4", frames,
                            fps=cfg.data.eval_video_fps)
            if overlay_rgba:
                n = video_bg.frames.shape[0]
                vid = [video_bg.frames[i % n].cpu().numpy()
                       for i in range(len(overlay_rgba))]
                overlay_frames_on_video(
                    overlay_rgba, vid, str(step_dir) + "_overlay.mp4",
                    fps=cfg.data.eval_video_fps, premultiplied=True)
        return frames

    def _eval_mesh(self, n_frames: int):
        """The frame-parallel eval's data axis (the JAX eval mesh): D = the
        ranks, or ``--parallel.dp`` when it is set and smaller, when D > 1
        and at least D frames are pending, else None. Rank r renders as
        data index r % D; a list ``all_gather`` over every rank brings the
        frames back."""
        from ..parallel.mesh import make_mesh_2d

        req = int(self.cfg.parallel.dp or -1)
        D = self.world if req < 0 else min(req, self.world)
        if D <= 1 or n_frames < D:
            return None
        return make_mesh_2d(D, 1, self.device)

    def full_eval(self) -> List[np.ndarray]:
        """``--log.eval_only``: ``data.full_eval_size`` frames at the test
        resolution, then their R-Precision against the run's prompt."""
        frames = self.evaluate(size=self.cfg.data.full_eval_size,
                               use_test_res=True)
        with span("trainer.r_precision", self.device):
            score = self.compute_r_precision(frames)
        if score is not None:
            logger.info("CLIP R-Precision(top-1) vs view prompts: %.3f",
                        score)
        return frames

    def compute_r_precision(self, frames) -> Optional[float]:
        """The CLIP retrieval score of the frames against the run's prompt,
        from the towers under ``<guidance weights>/clip_retrieval/``
        (``utils/r_precision.py:load_r_precision``); None when that
        directory holds no weights. With ``--log.debug`` the tiny random
        towers and random ids exercise the path (the score means
        nothing). Every other error raises."""
        from ..utils import r_precision as RP

        cfg = self.cfg
        if cfg.log.debug:
            rp = RP.make_tiny_r_precision(self.generator, device=self.device)
            ids = np.asarray(self.rng.integers(1, 200, size=(len(frames),
                                                             16)), np.int32)
            return rp.retrieve(np.stack(frames), ids)
        weights_dir = Path(cfg.guide.weights_dir or paths.GUIDANCE_WEIGHTS)
        rp = RP.load_r_precision(weights_dir / "clip_retrieval",
                                 device=self.device)
        if rp is None:
            logger.warning("R-Precision skipped: no CLIP weights under %s",
                           weights_dir / "clip_retrieval")
            return None
        return rp.retrieve(np.stack(frames), [cfg.guide.text] * len(frames))

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def _rng_tree(self) -> dict:
        return {
            "numpy": {name: g.bit_generator.state for name, g in (
                ("trainer", self.rng), ("batch", self._batch_rng),
                ("views", self._view_rng),
                ("camera", self.train_camera.rng),
                ("scheduler", self.t_scheduler.rng),
                ("prompt", self.prompt._rng))},
            "torch": {"trainer": self.generator.get_state(),
                      "prompt": self.prompt.generator.get_state()},
        }

    def _load_rng_tree(self, tree: dict) -> None:
        for name, g in (("trainer", self.rng), ("batch", self._batch_rng),
                        ("views", self._view_rng),
                        ("camera", self.train_camera.rng),
                        ("scheduler", self.t_scheduler.rng),
                        ("prompt", self.prompt._rng)):
            if name in tree["numpy"]:
                g.bit_generator.state = tree["numpy"][name]
        self.generator.set_state(tree["torch"]["trainer"].cpu())
        self.prompt.generator.set_state(tree["torch"]["prompt"].cpu())

    def _avatar_params_tree(self) -> dict:
        if self.cfg.render.gs_type == "vanilla":
            return vanilla_tree(self.state.avatar)
        return avatar_tree(self.state.avatar, self.avatar_model)

    def save_checkpoint(self) -> None:
        """The state, the optimizer, the step and the generators; a DMTet
        finetune's sdf and deform under "dmtet", the MLP background's
        weights and Adan state under "background"."""
        if self.cfg.stage == "nerf":
            params = self.nerf.state_dict()
            extra = {"grid": self.grid._asdict()}
            if self.dmtet_model is not None:
                extra["dmtet"] = self.state.dmtet._asdict()
        else:
            params = self._avatar_params_tree()
            extra = {}
        if self.bg_state is not None:
            extra["background"] = {"net": self.bg_net.state_dict(),
                                   "opt": self.bg_state.opt_state}
        tree = {"params": params, "opt_state": _opt_tree(self.state.opt_state),
                "step": self.train_step, "rng": self._rng_tree(), **extra}
        if self.world > 1:
            self._check_ranks_agree(tree)
        if not self.is_writer:
            return
        self.checkpointer.save(self.train_step, tree)
        logger.info("saved checkpoint at step %d", self.train_step)

    def _check_ranks_agree(self, tree) -> None:
        """Every rank holds the same checkpoint tree, to the bit: each
        tensor's words (4-byte types) or bytes summed as integers on each
        rank, the sums' maximum and minimum over the ranks compared (two
        all-reduces). Logged; a difference raises on every rank, since
        rank 0 alone writes the checkpoint and the frame-parallel eval
        renders from every rank's state."""
        import torch.distributed as dist

        sums = []

        def walk(x):
            if isinstance(x, dict):
                for v in x.values():
                    walk(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    walk(v)
            elif torch.is_tensor(x) and x.numel():
                x = x.detach().contiguous().view(-1)
                x = x.view(torch.int32) if x.element_size() == 4 \
                    else x.view(torch.uint8)
                sums.append(x.long().sum().to(self.device))
        walk([tree[k] for k in ("params", "opt_state", "grid", "dmtet",
                                "background") if k in tree])
        hi = torch.stack(sums)
        lo = -hi
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MAX)
        differ = int((hi != -lo).sum())
        if differ:
            raise RuntimeError(
                f"step {self.train_step}: the {self.world} ranks' states "
                f"differ in {differ} of {len(sums)} tensors")
        logger.info("step %d: the %d ranks' states agree (%d tensors)",
                    self.train_step, self.world, len(sums))

    def load_checkpoint(self, step: Optional[int] = None) -> None:
        """Restore the state, the optimizer, the step and the generators
        of a checkpoint of this experiment (the latest by default)."""
        restored, step = self.checkpointer.restore(
            step, map_location=self.device)
        self.train_step = int(restored["step"])
        if self.cfg.stage == "nerf":
            with torch.no_grad():
                self.nerf.load_state_dict(restored["params"])
            if "grid" in restored:
                self.grid = type(self.grid)(**restored["grid"])
            if self.dmtet_model is not None:
                _copy_into(self.state.dmtet._asdict(), restored["dmtet"],
                           "dmtet")
        elif self.cfg.render.gs_type == "vanilla":
            load_vanilla_tree(self.state.avatar, restored["params"])
        else:
            load_avatar_tree(self.state.avatar, self.avatar_model,
                             restored["params"])
        _load_opt_tree(self.state.opt_state, restored["opt_state"])
        if self.bg_state is not None and "background" in restored:
            bg = restored["background"]
            self.bg_net.load_state_dict(bg["net"])
            opt = self.bg_state.opt_state
            with torch.no_grad():
                for k, v in bg["opt"].items():
                    if isinstance(v, list):
                        for dst, src in zip(opt[k], v):
                            dst.copy_(src)
                    else:
                        opt[k] = v
        self.state = self.state._replace(step=self.train_step)
        if "rng" in restored:
            self._load_rng_tree(restored["rng"])
        logger.info("restored checkpoint step %d", step)
