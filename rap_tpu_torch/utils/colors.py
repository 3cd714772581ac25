"""The part palette of point-cloud artifacts (counterpart of
rap_tpu/utils/render.py:22-37, a copy: the port imports nothing of rap_tpu).
"""

from __future__ import annotations

import colorsys

import numpy as np

_N_PART_COLORS = 64


def part_colormap(n: int = _N_PART_COLORS) -> np.ndarray:
    """(n, 3) float RGB palette with evenly spaced hues (golden-angle order)."""
    cols = []
    for i in range(n):
        h = (i * 0.61803398875) % 1.0
        s = 0.65 + 0.25 * ((i // 7) % 2)
        v = 0.95 - 0.25 * ((i // 3) % 2)
        cols.append(colorsys.hsv_to_rgb(h, min(s, 1.0), v))
    return np.asarray(cols, np.float32)


def part_ids_to_colors(part_ids: np.ndarray) -> np.ndarray:
    """(N, 3) float RGB of each point's part id."""
    cmap = part_colormap()
    return cmap[np.asarray(part_ids) % len(cmap)]
