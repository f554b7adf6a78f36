"""Asset roots, read from the environment variables of the same name.

``HUMAN_TEMPLATES`` holds ``smplx/SMPLX_NEUTRAL_2020.npz`` (or
``smplx/SMPLX_<GENDER>.npz``) and the segmentation json;
``GUIDANCE_WEIGHTS`` is a diffusers-layout model directory (``unet/``,
``vae/``, ``text_encoder/``, ``tokenizer/``, ``controlnet_pose/``), read by
``guidance/convert.py:load_guidance``, with the R-Precision towers under
``clip_retrieval/`` (``utils/r_precision.py:load_r_precision``). The JAX
package's directory of converted msgpack weights is not read by the port.
The dataset roots and ``DEMO_MOTIONS`` are the motion loaders'
(``data/motion/loaders.py``), each in its dataset's own layout.
"""
import os

HUMAN_TEMPLATES = os.environ.get("HUMAN_TEMPLATES",
                                 "./external/human_templates/")

AIST_ROOT = os.environ.get("AIST_ROOT", "./datasets/AIST++/")
MOTIONX_ROOT = os.environ.get("MOTIONX_ROOT", "./datasets/Motion-X/")
MOTIONX_REENACT_ROOT = os.environ.get("MOTIONX_REENACT_ROOT",
                                      "./datasets/Motion-X-ReEnact/")
PW3D_ROOT = os.environ.get("PW3D_ROOT", "./datasets/3DPW/")
TALKSHOW_ROOT = os.environ.get("TALKSHOW_ROOT", "./datasets/TalkShow/")
AMASS_ROOT = os.environ.get("AMASS_ROOT", "./datasets/AMASS/")
TRAM_ROOT = os.environ.get("TRAM_ROOT", "./datasets/tram/")

# the demo motion bundles (<name>.npy, 265 values a frame)
DEMO_MOTIONS = os.environ.get("DEMO_MOTIONS", "./assets/motions/")

GUIDANCE_WEIGHTS = os.environ.get("GUIDANCE_WEIGHTS",
                                  "./external/guidance_diffusers/")
