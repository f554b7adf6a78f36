"""View-dependent text augmentation.

Port of ``dreamwaltz_g_tpu/guidance/text_aug.py`` (numpy only): 6 view
texts + 8 body-part texts in the prefix / suffix / dreamwaltz /
dreamwaltz-g modes, and the azimuth / elevation -> view index rule.
Elevation is the polar angle from +y, so overhead views have small
elevations.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

VIEW_FRONT, VIEW_LEFT, VIEW_BACK, VIEW_RIGHT, VIEW_OVERHEAD, VIEW_BOTTOM = range(6)

BODY_PARTS = ("head", "face", "arm_left", "arm_right",
              "hand_left", "hand_right", "foot_left", "foot_right")


class TextAugmentation:
    def __init__(self, text: str, mode: str = "dreamwaltz-g",
                 angle_front: float = 90.0, angle_overhead: float = 60.0):
        self.mode = mode
        assert 0 <= angle_front <= 180 and 0 <= angle_overhead <= 90
        f = angle_front / 2
        self.azimuth_bounds = (f, 180 - f, 180 + f, 360 - f)
        self.elevation_bounds = (angle_overhead, 180 - angle_overhead)
        self.texts = self._view_texts(text)
        self.part2index: Dict[str, int] = {}
        if mode in ("dreamwaltz", "dreamwaltz-g"):
            start = len(self.texts)
            self.texts += self._part_texts(text)
            self.part2index = {p: start + i for i, p in enumerate(BODY_PARTS)}

    def _view_texts(self, text: str) -> List[str]:
        if self.mode == "prefix":
            views = ["front view of {}", "side view of {}", "backside view of {}",
                     "side view of {}", "overhead view of {}", "bottom view of {}"]
        elif self.mode == "suffix":
            return [f"{text}, front view", f"{text}, side view",
                    f"{text}, back view", f"{text}, side view",
                    f"{text}, overhead view", f"{text}, bottom view"]
        elif self.mode == "dreamwaltz":
            views = ["front view of {}", "side view of {}", "back view of {}",
                     "side view of {}", "overhead view of {}", "bottom view of {}"]
        elif self.mode == "dreamwaltz-g":
            views = ["front view of {}", "left side view of {}",
                     "back view of {}", "right side view of {}",
                     "overhead view of {}", "bottom view of {}"]
        else:
            raise NotImplementedError(self.mode)
        return [v.format(text) for v in views]

    @staticmethod
    def _part_texts(text: str) -> List[str]:
        return [
            f"head of {text}", f"face of {text}",
            f"left arm of {text}", f"right arm of {text}",
            f"left hand of {text}", f"right hand of {text}",
            f"left foot of {text}", f"right foot of {text}",
        ]

    def __call__(self, azim, elev, part: Optional[str] = None) -> np.ndarray:
        """(B,) azimuth/elevation degrees -> (B,) text index."""
        azim = np.asarray(azim) % 360.0
        elev = np.asarray(elev)
        a = self.azimuth_bounds
        e = self.elevation_bounds
        res = np.zeros(azim.shape, np.int64)
        res[(azim >= a[0]) & (azim < a[1])] = VIEW_LEFT
        res[(azim >= a[1]) & (azim < a[2])] = VIEW_BACK
        res[(azim >= a[2]) & (azim < a[3])] = VIEW_RIGHT
        res[elev < e[0]] = VIEW_OVERHEAD
        res[elev > e[1]] = VIEW_BOTTOM
        if part is not None and part in self.part2index:
            res[...] = self.part2index[part]
        return res
