"""Backgrounds.

Port of ``COLOR_PRESETS`` from ``dreamwaltz_g_tpu/system/background.py``,
the named solid colors of the stage-1 background and the eval renders. The
MLP, Gaussian-scene and video backgrounds are not ported yet.
"""
COLOR_PRESETS = {
    "black": (0.0, 0.0, 0.0),
    "white": (1.0, 1.0, 1.0),
    "gray": (0.5, 0.5, 0.5),
}
