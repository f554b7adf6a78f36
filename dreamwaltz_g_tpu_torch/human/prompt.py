"""SMPLPrompt: the per-step human-pose provider.

Port of ``dreamwaltz_g_tpu/human/prompt.py`` for the canonical scenes
('canonical', its named variants, 'canonical-R', '-choice', '-loop') and
the random ones ('random', 'random-<parts>'): the canonical pose, the
observed-pose draw, the betas schedule and the condition fan-out. The
numpy draws (canonical mixup, '-choice') come from a ``Generator`` seeded
as the JAX package's, in its order; the pose draws, from ``jax.random``
keys there, come from a ``torch.Generator`` of the prompt's own here, or
are handed in (``draws``). The motion scenes (``data/motion/``) and the
'vposer' sampler are not ported yet and raise.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from .condition import ConditionRenderer
from .keypoints import LandmarkData
from .poses import (
    canonical_body_pose,
    canonical_params,
    centralized,
    flat_hands,
    sample_random_pose,
)
from .smplx_model import (
    SMPLXModelData,
    SMPLXOutput,
    SMPLXParams,
    default_params,
    smplx_forward,
)


def parse_scene_type(scene: str) -> str:
    if scene.startswith("canonical"):
        return "canonical"
    if scene.startswith("random") or scene == "vposer":
        return "random"
    return "motion"


def parse_betas(betas, num_betas: int, device="cuda"
                ) -> Optional[torch.Tensor]:
    """'(b0, b1, ...)' or '((..),(..))' -> (N, num_betas), zero-padded."""
    device = resolve_device(device)
    if betas is None:
        return None
    if isinstance(betas, str):
        betas = ast.literal_eval(betas)
    arr = np.asarray(betas, np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    if arr.shape[-1] < num_betas:
        arr = np.pad(arr, ((0, 0), (0, num_betas - arr.shape[-1])))
    return torch.as_tensor(arr[:, :num_betas], device=device)


def sample_betas(betas: torch.Tensor, i: Optional[int] = None,
                 max_iteration: int = 25) -> torch.Tensor:
    """Interpolate canonical -> observed betas over the first
    ``max_iteration`` iterations."""
    if betas.shape[0] == 1 or i is None:
        return betas[:1]
    r = min(i / max_iteration, 1.0)
    return betas[:1] * (1 - r) + betas[1:2] * r


def get_smpl_inputs(
    model: SMPLXModelData,
    pose_type: str,
    generator: Optional[torch.Generator] = None,
    batch_size: int = 1,
    flat_hand: bool = True,
    centralize_pelvis: bool = True,
    canonical_mixup_prob: float = 0.5,
    training_ratio: float = 0.0,
    rng: Optional[np.random.Generator] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> SMPLXParams:
    """Pose-type dispatch: the canonical variants, 'canonical-choice',
    'canonical-loop(2)', and 'random[-body,hand,expr]' with canonical-R
    mixup. ``draws`` may hold 'uniform' (canonical-R's two) and the
    normals of ``sample_random_pose``."""
    rng = rng or np.random.default_rng()
    draws = draws or {}
    if pose_type == "vposer":
        raise NotImplementedError("the 'vposer' pose sampler is not ported "
                                  "yet")
    if pose_type.startswith("random") and rng.random() < canonical_mixup_prob:
        pose_type = "canonical-R"

    dev = model.device
    if pose_type.startswith("random"):
        parts = tuple(pose_type.split("-")[-1].split(",")) \
            if "-" in pose_type else ("body", "hand", "expr")
        p = sample_random_pose(model, generator, parts=parts,
                               batch_size=batch_size, normals=draws)
    elif pose_type.startswith("canonical"):
        if pose_type == "canonical-choice":
            pose_type = str(rng.choice([
                "canonical-Y", "canonical-T", "canonical-A",
                "canonical-Y-adjust", "canonical-T-adjust",
                "canonical-A-adjust"]))
            body = canonical_body_pose(pose_type, batch_size=batch_size,
                                       device=dev)
        elif pose_type in ("canonical-loop", "canonical-loop2"):
            r = training_ratio
            if pose_type == "canonical-loop2":
                r = 2.0 * r if r <= 0.5 else 2.0 - 2.0 * r
            a = canonical_body_pose("canonical-A-adjust",
                                    batch_size=batch_size, device=dev)
            b = canonical_body_pose("canonical-Y", batch_size=batch_size,
                                    device=dev)
            body = a * (1 - r) + b * r
        else:
            body = canonical_body_pose(pose_type, generator, batch_size,
                                       device=dev,
                                       uniform=draws.get("uniform"))
        p = default_params(model, batch_size)._replace(body_pose=body)
        if flat_hand:
            p = flat_hands(model, p)
    else:
        raise ValueError(f"unknown pose_type {pose_type!r}")
    if centralize_pelvis:
        p = centralized(model, p)
    return p


class SMPLPrompt:
    """The observed-pose provider of the trainer."""

    def __init__(
        self,
        cfg,
        model: SMPLXModelData,
        cond_type: Union[str, List[str]] = "pose",
        height: int = 512,
        width: int = 512,
        landmarks: Optional[LandmarkData] = None,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.model = model
        self.cond_type = [cond_type] if isinstance(cond_type, str) \
            else list(cond_type)
        self.height, self.width = height, width
        self.scene = cfg.scene
        self.scene_type = parse_scene_type(cfg.scene)
        if self.scene_type == "motion":
            raise NotImplementedError(
                f"motion scene {cfg.scene!r}: the motion loaders "
                "(data/motion/) are not ported yet")
        if cfg.scene == "vposer":
            raise NotImplementedError("the 'vposer' scene is not ported yet")
        self.canonical_pose = cfg.canonical_pose
        self.canonical_mixup_prob = cfg.canonical_mixup_prob
        self.training_ratio = 0.0
        self._rng = np.random.default_rng(seed)
        # the pose draws' own generator: the trainer's prefetch worker draws
        # from it, and shares it with nothing on the main thread
        self.generator = torch.Generator(device=model.device).manual_seed(seed)

        self.condition = ConditionRenderer(
            model, landmarks=landmarks,
            use_occlusion_culling=cfg.use_occlusion_culling,
            draw_body_keypoints=cfg.draw_body_keypoints,
            draw_hand_keypoints=cfg.draw_hand_keypoints,
            draw_face_landmarks=cfg.draw_face_landmarks,
            openpose_left_right_flip=cfg.openpose_left_right_flip,
        )
        dev = model.device
        self.canonical_betas = parse_betas(cfg.canonical_betas,
                                           model.num_betas, dev)
        self.observed_betas = parse_betas(cfg.observed_betas,
                                          model.num_betas, dev)
        self.max_beta_iteration = cfg.max_beta_iteration

        # canonical (zero-pose-space anchor of the avatar)
        self.canonical_inputs = canonical_params(
            model, cfg.canonical_pose, centralize_pelvis=True,
            flat_hand=not cfg.flat_hand_mean)
        if self.canonical_betas is not None:
            self.canonical_inputs = self.canonical_inputs._replace(
                betas=self.canonical_betas[:1])
        self.canonical_outputs = smplx_forward(model, self.canonical_inputs)

    def __call__(self, frame_idx: Optional[int] = None,
                 batch_idx: Optional[int] = None,
                 draws: Optional[Dict[str, torch.Tensor]] = None,
                 ) -> Tuple[SMPLXParams, SMPLXOutput]:
        """One observed pose draw; ``draws`` hands in the pose draws (see
        ``get_smpl_inputs``)."""
        extra = {}
        if self.observed_betas is not None:
            extra["betas"] = sample_betas(
                self.observed_betas, i=batch_idx,
                max_iteration=self.max_beta_iteration)
        if self.scene_type == "canonical":
            if self.scene in ("canonical", self.canonical_pose) \
                    and not extra:
                return self.canonical_inputs, self.canonical_outputs
            p = get_smpl_inputs(
                self.model, self.scene, self.generator,
                training_ratio=self.training_ratio, rng=self._rng,
                draws=draws)
        else:
            p = get_smpl_inputs(
                self.model, self.scene, self.generator,
                canonical_mixup_prob=self.canonical_mixup_prob,
                rng=self._rng, draws=draws)
        if extra:
            B = p.body_pose.shape[0]
            p = p._replace(betas=extra["betas"].expand(
                B, self.model.num_betas).clone())
        return p, smplx_forward(self.model, p)

    def get_cond_images(self, smpl_outputs: SMPLXOutput, extrinsic,
                        intrinsics, cond_type=None, height=None,
                        width=None) -> list:
        if cond_type is None:
            cond_type = self.cond_type
        if isinstance(cond_type, str):
            cond_type = [cond_type]
        h = height or self.height
        w = width or self.width
        return [self.condition(smpl_outputs, extrinsic, intrinsics, c, h, w)
                for c in cond_type]

    def get_cond_images_batch(self, smpl_outputs_per_view, extrinsics,
                              intrinsics, cond_type=None, height=None,
                              width=None) -> list:
        """B views' condition images; for 'pose' every projection and ray
        cast in one pass with one host pull."""
        if cond_type is None:
            cond_type = self.cond_type
        if isinstance(cond_type, (list, tuple)):
            cond_type = cond_type[0]
        h = height or self.height
        w = width or self.width
        if cond_type in ("pose", "openpose"):
            return self.condition.render_pose_batch(
                smpl_outputs_per_view, extrinsics, intrinsics, h, w)
        return [self.condition(o, extrinsics[i], intrinsics[i], cond_type,
                               h, w)
                for i, o in enumerate(smpl_outputs_per_view)]
