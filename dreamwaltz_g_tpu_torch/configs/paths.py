"""Asset roots, read from the environment variables of the same name.

``HUMAN_TEMPLATES`` holds ``smplx/SMPLX_NEUTRAL_2020.npz`` (or
``smplx/SMPLX_<GENDER>.npz``) and the segmentation json;
``GUIDANCE_WEIGHTS`` is a diffusers-layout model directory (``unet/``,
``vae/``, ``text_encoder/``, ``tokenizer/``, ``controlnet_pose/``), read by
``guidance/convert.py:load_guidance``. The JAX package's directory of
converted msgpack weights is not read by the port.
"""
import os

HUMAN_TEMPLATES = os.environ.get("HUMAN_TEMPLATES",
                                 "./external/human_templates/")
GUIDANCE_WEIGHTS = os.environ.get("GUIDANCE_WEIGHTS",
                                  "./external/guidance_diffusers/")
