"""float32 fused multiply-add, correctly rounded, from eager tensor ops.

PyTorch has no fused multiply-add operator, and the reference's compiled CPU
code fuses some of its float32 multiply-adds (the blur's taps, the resize's
row pass, the trackers' recurrences), so the port emulates the fma where it
must round as the reference does.  The product of two float32 values is
exact in float64.  The float64 sum of that product and a float32 addend is
not, and rounding it to float64 and then to float32 can round twice the
wrong way (an exact sum just off a float32 tie that float64 rounds onto the
tie).  So the float64 sum is rounded to odd: when TwoSum's error term says
the sum was inexact and its last bit is even, it moves one unit toward the
exact value.  Rounding a round-to-odd float64 to float32 (53 >= 24 + 2 bits)
equals rounding the exact value once.
"""

from __future__ import annotations

import torch


def fma32(a, b, c):
    """fma(a, b, c) rounded once to float32.  ``a`` may be a Python float
    holding a float32 value (a tap, a weight) or a tensor; ``b`` and ``c``
    are float32 tensors (or tensors exactly representable as such)."""
    p = b.double() * (a if isinstance(a, float) else a.double())   # exact
    c = c.double()
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)           # TwoSum: p + c - s, exactly
    bits = s.view(torch.int64)
    # round to odd: an inexact sum with an even last bit moves one unit in
    # the last place toward the exact value (+1 raises the magnitude)
    step = (torch.sign(err) * torch.sign(s)).to(torch.int64)
    bits = bits + step * (1 - (bits & 1))
    return bits.view(torch.float64).float()

