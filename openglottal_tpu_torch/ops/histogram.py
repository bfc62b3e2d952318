"""uint8 histogram-based ops: exact masked percentiles and the Otsu
threshold.

Counterpart of ``openglottal_tpu/ops/histogram.py``.  The reference computes
``np.percentile(pixels_in_roi, pct)`` per frame; for integer-valued [0, 255]
pixels that is exactly computable from counts, with no data-dependent shapes.
Its Otsu threshold (cv2's THRESH_OTSU semantics) is a float32 walk over the
256 bins, written here step by step as the reference's compiled code rounds
it (found by comparing bits): sequential float32 cumulative sums, never
``torch.cumsum``, whose CPU accumulator is wider than float32.
"""

from __future__ import annotations

import torch


def masked_histogram_u8(values: torch.Tensor, mask: torch.Tensor):
    """256-bin histogram (float32 counts, exact) of ``values`` (any shape,
    integer-valued 0..255) where ``mask`` is true."""
    v = torch.where(mask.reshape(-1), values.reshape(-1).to(torch.int64), 256)
    hist = torch.zeros(257, dtype=torch.int64, device=values.device)
    hist.index_add_(0, v, torch.ones_like(v))
    return hist[:256].to(torch.float32)


def percentile_from_hist(hist: torch.Tensor, q: float):
    """np.percentile(sorted_values, q) (linear interpolation) from a histogram.

    Returns (value, n) where n is the number of selected pixels; value is
    garbage when n == 0 (the caller gates on n)."""
    cum = torch.cumsum(hist, 0)
    n = cum[-1]
    rank = (q / 100.0) * torch.clamp(n - 1.0, min=0.0)
    k = torch.floor(rank)
    frac = rank - k
    # v_k = smallest value whose cumulative count exceeds k
    ks = torch.stack([k, k + 1.0])
    v = torch.searchsorted(cum, ks, right=True).clamp(0, 255).to(torch.float32)
    return v[0] * (1.0 - frac) + v[1] * frac, n


def masked_percentile_u8_batch(values: torch.Tensor, mask: torch.Tensor,
                               q: float):
    """Batched exact ``np.percentile(values[t][mask[t]], q)`` for
    integer-valued [0, 255] pixels — the frame-parallel tracker's percentile.

    Finds the two order statistics by bitwise binary search on the VALUE:
    8 count passes per order statistic (compare + masked count), 16 passes in
    all, elementwise + reductions only (no sort, no quantile call).

    values: (T, ...) integer-valued; mask: same shape bool.
    Returns (value (T,) f32, n (T,) f32); value is garbage where n == 0.
    """
    t = values.shape[0]
    v = values.reshape(t, -1).to(torch.int32)
    m = mask.reshape(t, -1)
    n_i = m.sum(1)
    n = n_i.to(torch.float32)
    rank = (q / 100.0) * torch.clamp(n - 1.0, min=0.0)
    k = torch.floor(rank)
    frac = rank - k
    # masked-out pixels can never satisfy v <= cand (cand <= 255)
    vm = torch.where(m, v, 256)

    def order_stat(kk):
        """Smallest value s with count(masked <= s) >= kk + 1 == sorted[kk]."""
        thr = torch.zeros((t,), dtype=torch.int32, device=values.device)
        for bit in (128, 64, 32, 16, 8, 4, 2, 1):
            cand = thr + (bit - 1)
            cnt = (vm <= cand[:, None]).sum(1)
            thr = torch.where(cnt >= kk + 1, thr, thr + bit)
        return thr.to(torch.float32)

    ki = k.to(torch.int64)
    last = torch.clamp(n_i - 1, min=0)
    v_lo = order_stat(torch.minimum(ki, last))
    v_hi = order_stat(torch.minimum(ki + 1, last))
    return v_lo * (1.0 - frac) + v_hi * frac, n


def masked_percentile_u8(values, mask, q: float, fallback):
    """Exact np.percentile of uint8 ``values[mask]``; ``fallback`` when the
    mask is empty."""
    val, n = percentile_from_hist(masked_histogram_u8(values, mask), q)
    if not isinstance(fallback, torch.Tensor):   # filled on the device
        fallback = torch.full((), float(fallback), device=val.device)
    return torch.where(n > 0, val, fallback)


def otsu_threshold_from_hist(hist: torch.Tensor):
    """Otsu threshold of (..., 256) float32 histograms -> (...,) float32,
    the first bin of maximum between-class variance.  Every step rounds to
    float32 once, as the reference's compiled code rounds it:

      p = hist / max(n, 1); w0, mu = sequential float32 cumulative sums of
      p and p * v; w1 = 1 - w0; denom = w0 * w1; num = mu_total * w0 - mu
      (two roundings, not one fma); sigma = (num * num) / max(denom, 1e-12)
      where denom > 1e-12, else -1.

    Eager float32 tensor ops each round once; the cumulative sums are a loop
    over the bins (each add one rounding)."""
    hist = hist.to(torch.float32)
    n = hist.sum(-1, keepdim=True)          # integers: exact in any order
    p = hist / torch.clamp(n, min=1.0)
    pv = p * torch.arange(256, dtype=torch.float32, device=hist.device)
    w0, mu = torch.empty_like(p), torch.empty_like(p)
    a = torch.zeros_like(p[..., 0])
    b = torch.zeros_like(a)
    for i in range(256):
        a = a + p[..., i]
        b = b + pv[..., i]
        w0[..., i] = a
        mu[..., i] = b
    denom = w0 * (1.0 - w0)
    num = mu[..., 255:] * w0 - mu
    sigma = torch.where(denom > 1e-12,
                        (num * num) / torch.clamp(denom, min=1e-12), -1.0)
    return torch.argmax(sigma, -1).to(torch.float32)


def otsu_threshold(values: torch.Tensor, mask: torch.Tensor | None = None):
    """Otsu threshold of uint8 ``values`` (optionally masked), cv2
    THRESH_OTSU semantics -> 0-d float32; binarise with ``values > t``."""
    if mask is None:
        mask = torch.ones(values.shape, dtype=torch.bool,
                          device=values.device)
    return otsu_threshold_from_hist(masked_histogram_u8(values, mask))
