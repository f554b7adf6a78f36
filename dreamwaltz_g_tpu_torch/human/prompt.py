"""SMPLPrompt: the per-step human-pose provider.

Port of ``dreamwaltz_g_tpu/human/prompt.py`` for the canonical scenes
('canonical', its named variants, 'canonical-R', '-choice', '-loop'), the
random ones ('random', 'random-<parts>') and the motion scenes
('<dataset>,<name>[,<start>-<end>[-<interval>]]', ``data/motion/``, with
the reenact and TRAM camera tracks): the canonical pose, the observed-pose
draw, the betas schedule and the condition fan-out. The numpy draws
(canonical mixup, '-choice', a motion scene's random frame) come from a
``Generator`` seeded as the JAX package's, in its order; the pose draws,
from ``jax.random`` keys there, come from a ``torch.Generator`` of the
prompt's own here, or are handed in (``draws``). 'vposer' samples body
poses only, through ``sample_body_fn`` when one is given (a
``human/vposer.py`` decoder; the trainer, like the JAX trainer, hands none
in) and from the scaled-normal prior otherwise.
"""
from __future__ import annotations

import ast
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from ..data.motion import load_smpl_sequences
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


def load_hand_components(path: str, ncomps: int = 45):
    """The PCA hand bases (left, right) of a SMPL-X npz, numpy float32, for
    the TalkSHOW decode; None when the file has none."""
    with np.load(path, allow_pickle=True) as data:
        if "hands_componentsl" not in data:
            return None
        return (np.asarray(data["hands_componentsl"], np.float32)[:ncomps],
                np.asarray(data["hands_componentsr"], np.float32)[:ncomps])


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
    sample_body_fn: Optional[Callable] = None,
) -> SMPLXParams:
    """Pose-type dispatch: the canonical variants, 'canonical-choice',
    'canonical-loop(2)', 'random[-body,hand,expr]' with canonical-R mixup,
    and 'vposer' (body only; its body pose from ``sample_body_fn(generator,
    batch_size)`` when given). ``draws`` may hold 'uniform' (canonical-R's
    two) and the normals of ``sample_random_pose``."""
    rng = rng or np.random.default_rng()
    draws = draws or {}
    if pose_type.startswith("random") and rng.random() < canonical_mixup_prob:
        pose_type = "canonical-R"

    dev = model.device
    if pose_type == "vposer" or pose_type.startswith("random"):
        if pose_type == "vposer":
            parts = ("body",)
        elif "-" in pose_type:
            parts = tuple(pose_type.split("-")[-1].split(","))
        else:
            parts = ("body", "hand", "expr")
        p = sample_random_pose(model, generator, parts=parts,
                               batch_size=batch_size, normals=draws)
        if "body" in parts and sample_body_fn is not None:
            p = p._replace(body_pose=sample_body_fn(generator, batch_size))
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


def _params_from_seq_frame(model: SMPLXModelData, seqs: Dict[str, np.ndarray],
                           frame_idx: int) -> SMPLXParams:
    """One frame of the (P, F, D) sequence dict as SMPLXParams of batch P on
    the model's device; betas and expression zero-padded or cut to the
    model's sizes."""
    P = seqs["body_pose"].shape[0]
    p = default_params(model, P)
    updates = {}
    for k, v in seqs.items():
        if k not in SMPLXParams._fields:
            continue
        updates[k] = torch.as_tensor(v[:, frame_idx] if v.ndim >= 3 else v,
                                     dtype=torch.float32,
                                     device=model.device)
    for k, n in (("betas", model.num_betas), ("expression", model.num_expr)):
        if k in updates:
            x = updates[k]
            if x.shape[-1] < n:
                x = torch.nn.functional.pad(x, (0, n - x.shape[-1]))
            updates[k] = x[:, :n]
    return p._replace(**updates)


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
        hand_components=None,
        sample_body_fn: Optional[Callable] = None,
        seed: int = 0,
        _dataset=None,
    ):
        self.cfg = cfg
        self.model = model
        self.cond_type = [cond_type] if isinstance(cond_type, str) \
            else list(cond_type)
        self.height, self.width = height, width
        self.scene = cfg.scene
        self.scene_type = parse_scene_type(cfg.scene)
        self.sample_body_fn = sample_body_fn
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

        # the observed source: a motion scene's sequences (host numpy) and,
        # for the reenact / TRAM datasets, their camera track
        self.num_frame = 1
        self.num_person = cfg.num_person or 1
        self.camera_sequences: Optional[dict] = None
        self.sequences = None
        if self.scene_type == "motion":
            cam_seqs: dict = {}
            pelvis = torch.einsum("v,vc->c", model.J_regressor[0],
                                  model.v_template).cpu().numpy()
            self.sequences, self.num_person, self.num_frame = \
                load_smpl_sequences(
                    self.scene, model_type="smplx",
                    camera_sequences=cam_seqs, num_person=cfg.num_person,
                    pop_betas=cfg.pop_betas, pop_transl=cfg.pop_transl,
                    normalize_transl=cfg.normalize_transl,
                    centralize_pelvis=cfg.centralize_pelvis,
                    pop_global_orient=cfg.pop_global_orient,
                    frame_interval=cfg.frame_interval,
                    num_betas=model.num_betas,
                    pelvis_position=pelvis if cfg.centralize_pelvis
                    else None,
                    hand_components=hand_components, _dataset=_dataset)
            self.camera_sequences = cam_seqs or None

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
        elif self.scene_type == "random":
            p = get_smpl_inputs(
                self.model, self.scene, self.generator,
                canonical_mixup_prob=self.canonical_mixup_prob,
                rng=self._rng, draws=draws,
                sample_body_fn=self.sample_body_fn)
        else:
            if self.observed_betas is not None \
                    and self.observed_betas.shape[0] > 1 \
                    and frame_idx is not None:
                frame_idx = max(self.max_beta_iteration, frame_idx)
            if frame_idx is None:
                frame_idx = int(self._rng.integers(0, self.num_frame))
            frame_idx %= self.num_frame
            p = _params_from_seq_frame(self.model, self.sequences, frame_idx)
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

    def get_camera_params_from_sequences(self, frame_idx: int
                                         ) -> Optional[dict]:
        """The predefined camera of frame ``frame_idx`` (the reenact / TRAM
        tracks, cycled), on the model's device; None without a track."""
        if self.camera_sequences is None:
            return None
        cs = self.camera_sequences
        i = frame_idx % cs["extrinsic"].shape[0]
        dev = self.model.device
        return {
            "extrinsic": torch.as_tensor(cs["extrinsic"][i],
                                         dtype=torch.float32, device=dev),
            "intrinsics": torch.as_tensor(cs["intrinsics"][i],
                                          dtype=torch.float32, device=dev),
            "image_height": cs["image_height"],
            "image_width": cs["image_width"],
            "tanfov": float(cs["tanfov"][i]),
        }
