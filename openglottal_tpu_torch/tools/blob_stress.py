"""Masks and dual region codes that are hard for a union-find, made from a
seed with numpy alone, for holding the connected-component kernels
(``csrc/blobs.cu``, ``ops/blobs_cuda``) against their plain versions and the
plain versions against the JAX package:

  ``ones``, ``background``    one component covering the frame (as a mask:
                              all ones; as dual codes: all code 2);
  ``checker``, ``checker2``   checkerboards of 1-px and 2-px cells: joined
                              only across corners, so one 8-connected
                              component and many 4-connected ones;
  ``comb``                    1-px vertical teeth joined only by the bottom
                              row: every tooth's top pixel is a root until
                              the last row, the worst order for unions that
                              keep the minimum index;
  ``spiral``                  a 1-px spiral with 1-px gaps: one chain as
                              long as a third of the frame;
  ``staircase``               1-px diagonals: connected only through the
                              8-connected diagonal rule;
  ``random_0.3``, ``random_0.5``, ``random_0.59``
                              uniform noise at these densities (0.59: at the
                              4-connected percolation threshold);
  ``row``, ``column``         frames of a single row (1, w) or a single
                              column (h, 1), noise at density 0.5.

Frame ``i`` of a stack is the family's frame flipped left-right when ``i``
is odd and upside down when ``i % 4 >= 2`` (so the comb is also joined at
its top, the diagonals run both ways); the noise families draw every frame
anew.

    masks = stress_masks("comb", 48, 40, t=4, seed=0)     # (4, 48, 40) bool
    codes = stress_codes("comb", 48, 40, t=4, seed=0)     # (4, 48, 40) uint8
"""

from __future__ import annotations

import numpy as np

FAMILIES = ("ones", "background", "checker", "checker2", "comb", "spiral",
            "staircase", "random_0.3", "random_0.5", "random_0.59", "row",
            "column")


def spiral_path(h: int, w: int) -> np.ndarray:
    """A one-pixel-wide spiral walked inwards from the top-left corner with
    one-pixel gaps between its turns: a single 4- and 8-connected chain."""
    m = np.zeros((h, w), bool)
    top, bottom, left, right = 0, h - 1, 0, w - 1
    r = c = 0
    m[0, 0] = True
    leg = 0
    while True:
        n = 0
        d = leg % 4
        while True:
            if d == 0 and c + 1 <= right:
                c += 1
            elif d == 1 and r + 1 <= bottom:
                r += 1
            elif d == 2 and c - 1 >= left:
                c -= 1
            elif d == 3 and r - 1 >= top:
                r -= 1
            else:
                break
            m[r, c] = True
            n += 1
        if d == 0:
            top += 2
        elif d == 1:
            right -= 2
        elif d == 2:
            bottom -= 2
        else:
            left += 2
        if n == 0 and leg > 0:
            return m
        leg += 1


def _frame(family: str, h: int, w: int, rng) -> np.ndarray:
    r, c = np.ogrid[:h, :w]
    if family == "ones":
        return np.ones((h, w), bool)
    if family == "background":
        return np.zeros((h, w), bool)
    if family == "checker":
        return (r + c) % 2 == 0
    if family == "checker2":
        return (r // 2 + c // 2) % 2 == 0
    if family == "comb":
        m = np.zeros((h, w), bool)
        m[:, ::2] = True
        m[-1, :] = True
        return m
    if family == "spiral":
        return spiral_path(h, w)
    if family == "staircase":
        return np.broadcast_to((c - r) % 4 == 0, (h, w)).copy()
    if family.startswith("random_"):
        return rng.random((h, w)) < float(family.split("_")[1])
    if family in ("row", "column"):
        return rng.random((h, w)) < 0.5
    raise ValueError(f"unknown blob stress family {family!r}; "
                     f"one of {FAMILIES}")


def stress_masks(family: str, h: int, w: int, t: int = 1,
                 seed: int = 0) -> np.ndarray:
    """(t, h, w) bool frames of ``family`` (``row``: (t, 1, w); ``column``:
    (t, h, 1)); see the module's note for how the frames of a stack
    differ."""
    if family == "row":
        h = 1
    elif family == "column":
        w = 1
    rng = np.random.default_rng(seed)
    out = np.empty((t, h, w), bool)
    for i in range(t):
        m = _frame(family, h, w, rng)
        if i % 2:
            m = m[:, ::-1]
        if i % 4 >= 2:
            m = m[::-1]
        out[i] = m
    return out


def stress_codes(family: str, h: int, w: int, t: int = 1,
                 seed: int = 0) -> np.ndarray:
    """(t, h, w) uint8 dual region codes of ``family`` as the blob filter's
    dual route makes them: 1 (8-connected) on the mask, 2 (4-connected)
    off it.  With ``t >= 2`` the last frame also has a fifth of its pixels,
    drawn from ``seed``, set to 0 (inactive: walls for both regions)."""
    m = stress_masks(family, h, w, t, seed)
    codes = np.where(m, 1, 2).astype(np.uint8)
    if t >= 2:
        rng = np.random.default_rng(seed + 1)
        codes[-1][rng.random(codes.shape[1:]) < 0.2] = 0
    return codes
