"""Wrappers of the hand-written CUDA min-propagation kernels
(``csrc/blobs.cu``) and their plain PyTorch versions.

Replaces ``openglottal_tpu/ops/blobs_pallas.py``:

  ``dual_cc_batch``        <- ``dual_cc_pallas_batch``
  ``dual_min_prop_batch``  <- ``dual_min_prop_pallas_batch``
  ``min_prop_batch``       <- ``min_prop_pallas_batch``
  ``cc_batch``             <- ``connected_components_pallas_batch``
  ``cc``                   <- ``connected_components_pallas``

Shared semantics: min-propagation to the fixpoint over connected pixels of a
``(T, H, W)`` stack of independent frames; a component's id is its minimum
frame-local flat index ``r*W + c``; pixels outside the region read ``H*W``.

Bound on the card: bytes.  A launch must read 1 B/pixel of region code (plus
4 B/pixel of ``init`` where there is one) and write 4 B/pixel of int32 output;
the kernels keep their parent grids and the codes in shared memory when they
fit, so device memory sees each input once and the output once.  Without
``init`` (``dual_cc_batch``, ``cc_batch``, ``cc``) a frame is labelled by a
group of warps over bit planes of its codes and 16-bit parents; with
``init`` a block a frame runs the fixpoint body, a component's value in its
root's parent slot (see the note at the top of ``csrc/blobs.cu``).

Each wrapper checks device, dtype, shape and contiguity, allocates its output
with ``torch.empty``, launches on the current stream without synchronising,
and counts its launches in ``LAUNCHES``.  A CUDA tensor goes to the kernel or
the call raises; a CPU tensor goes to the plain version.  ``use_plain=True``
is a test hook that forces the plain version on any device (used to hold the
kernels against their plain versions end to end).
"""

from __future__ import annotations

import ctypes

import torch

from openglottal_tpu_torch.ops import _build

LAUNCHES = {"dual_cc_batch": 0, "dual_min_prop_batch": 0, "min_prop_batch": 0,
            "cc_batch": 0, "cc": 0}

# Measurement hook: set to a list and every kernel launch appends
# (wrapper name, input tensors, keyword arguments), so that a script can time
# each kernel and hold it against its plain version on the very inputs the
# pipeline gave it.  None (the default) records nothing.
RECORD: list | None = None

_configured = False


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launched(name: str, inputs: tuple, **kwargs) -> None:
    LAUNCHES[name] += 1
    if RECORD is not None:
        RECORD.append((name, inputs, kwargs))


def _lib() -> ctypes.CDLL:
    global _configured
    lib = _build.load("blobs")
    if not _configured:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.og_scratch_bytes.argtypes = [i, i, i, i]
        lib.og_scratch_bytes.restype = ctypes.c_longlong
        lib.og_dual_cc.argtypes = [p, p, i, i, i, p]
        lib.og_dual_min_prop.argtypes = [p, p, p, p, i, i, i, p]
        lib.og_min_prop.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.og_cc_batch.argtypes = [p, p, i, i, i, i, p]
        lib.og_cc.argtypes = [p, p, i, i, i, p]
        for fn in (lib.og_dual_cc, lib.og_dual_min_prop, lib.og_min_prop,
                   lib.og_cc_batch, lib.og_cc):
            fn.restype = ctypes.c_int
        _configured = True
    return lib


def _check(name: str, x: torch.Tensor, dtypes, like: torch.Tensor | None = None,
           dims: int = 3):
    if x.dim() != dims:
        want = "(T, H, W)" if dims == 3 else "(H, W)"
        raise ValueError(f"{name}: expected {want}, got {tuple(x.shape)}")
    if dims == 2:
        x = x[None]
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype} not in {dtypes}")
    if x.shape[0] == 0 or x.shape[1] * x.shape[2] == 0:
        raise ValueError(f"{name}: empty shape {tuple(x.shape)}")
    if x.shape[1] * x.shape[2] >= 2 ** 31 - 1:
        raise ValueError(f"{name}: H*W must be below 2^31")
    if like is not None and (x.shape != like.shape or x.device != like.device):
        raise ValueError(f"{name}: shape/device differ from the region's")
    return x.contiguous()


def _scratch(lib, x: torch.Tensor, with_init: bool):
    """Device scratch for frames too large for shared memory, or (None, None).
    The caller drops the buffer right after the launch; PyTorch's caching
    allocator is stream-ordered, so the memory is not handed out again before
    the kernel queued on this stream has run."""
    t, h, w = x.shape
    n = lib.og_scratch_bytes(t, h, w, int(with_init))
    if n == 0:
        return None, None
    buf = torch.empty(n // 4, dtype=torch.int32, device=x.device)
    return buf, buf.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ── plain PyTorch versions ──────────────────────────────────────────────────

def _neighbor_min(lab: torch.Tensor, big: int, connectivity: int):
    p = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=big)
    h, w = lab.shape[-2:]
    out = lab
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy == 0 and dx == 0) or (connectivity == 4 and dy and dx):
                continue
            out = torch.minimum(out, p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return out


def cc_plain(masks: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Per-frame CC labels of a (T, H, W) bool stack by neighbour-min +
    pointer jumping to a fixpoint (component id = min flat index; background
    = H*W).  int64 labels internally (gather indices), int32 out."""
    masks = masks.bool()
    t, h, w = masks.shape
    hw = h * w
    idx = torch.arange(hw, device=masks.device).view(1, h, w)
    lab = torch.where(masks, idx, hw)
    big_col = torch.full((t, 1), hw, dtype=lab.dtype, device=masks.device)
    while True:
        new = torch.where(masks, _neighbor_min(lab, hw, connectivity), hw)
        flat = new.view(t, hw)
        for _ in range(3):  # pointer jumping: compress label chains
            flat = torch.cat([flat, big_col], 1).gather(1, flat)
        new = flat.view(t, h, w)
        if torch.equal(new, lab):
            return lab.to(torch.int32)
        lab = new


def min_prop_plain(region: torch.Tensor, init: torch.Tensor,
                   connectivity: int = 8, labels: torch.Tensor | None = None):
    """Component broadcast: every pixel of each component of ``region`` gets
    the min of ``init`` over that component (labels + scatter-min + gather);
    pixels outside = H*W."""
    region = region.bool()
    t, h, w = region.shape
    hw = h * w
    if labels is None:
        labels = cc_plain(region, connectivity)
    lf = labels.view(t, hw).long()
    vals = torch.where(region.view(t, hw), init.view(t, hw).long(), hw)
    tbl = torch.full((t, hw + 1), hw, dtype=torch.long, device=region.device)
    tbl.scatter_reduce_(1, lf, vals, reduce="amin", include_self=True)
    out = torch.where(region.view(t, hw), tbl.gather(1, lf), hw)
    return out.view(t, h, w).to(torch.int32)


def dual_cc_plain(code: torch.Tensor) -> torch.Tensor:
    """Two single-region runs: code 1 8-connected, code 2 4-connected."""
    lab8 = cc_plain(code == 1, 8)
    lab4 = cc_plain(code == 2, 4)
    return torch.where(code == 1, lab8, lab4)   # lab4 is H*W where code == 0


def dual_min_prop_plain(code: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    v8 = min_prop_plain(code == 1, init, 8)
    v4 = min_prop_plain(code == 2, init, 4)
    return torch.where(code == 1, v8, v4)


# ── wrappers ────────────────────────────────────────────────────────────────

_CODE_DTYPES = (torch.uint8,)
_REGION_DTYPES = (torch.bool, torch.uint8)
_INIT_DTYPES = (torch.int32,)


def dual_cc_batch(code: torch.Tensor, use_plain: bool = False) -> torch.Tensor:
    """Per-frame CC labels of two disjoint regions at once.

    code: (T, H, W) uint8 — 1: 8-connected region, 2: 4-connected region,
    0: inactive.  Returns (T, H, W) int32 labels (frame-local min flat index
    per component; inactive = H*W).  Replaces ``dual_cc_pallas_batch``."""
    code = _check("dual_cc_batch", code, _CODE_DTYPES)
    if use_plain or not code.is_cuda:
        return dual_cc_plain(code)
    lib = _lib()
    t, h, w = code.shape
    out = torch.empty((t, h, w), dtype=torch.int32, device=code.device)
    with torch.cuda.device(code.device):
        err = lib.og_dual_cc(code.data_ptr(), out.data_ptr(), t, h, w,
                             _stream())
    _build.check(err, "dual_cc_batch")
    _launched("dual_cc_batch", (code,))
    return out


def dual_min_prop_batch(code: torch.Tensor, init: torch.Tensor,
                        use_plain: bool = False) -> torch.Tensor:
    """Component broadcast over two disjoint regions at once: every pixel gets
    the min of ``init`` (int32, values <= H*W) over its component; code-1
    components are 8-connected, code-2 components 4-connected.  Replaces
    ``dual_min_prop_pallas_batch``."""
    code = _check("dual_min_prop_batch", code, _CODE_DTYPES)
    init = _check("dual_min_prop_batch init", init, _INIT_DTYPES, code)
    if use_plain or not code.is_cuda:
        return dual_min_prop_plain(code, init)
    lib = _lib()
    t, h, w = code.shape
    out = torch.empty((t, h, w), dtype=torch.int32, device=code.device)
    scratch, scratch_ptr = _scratch(lib, code, True)
    with torch.cuda.device(code.device):
        err = lib.og_dual_min_prop(code.data_ptr(), init.data_ptr(),
                                   out.data_ptr(), scratch_ptr, t, h, w,
                                   _stream())
    _build.check(err, "dual_min_prop_batch")
    _launched("dual_min_prop_batch", (code, init))
    return out


def min_prop_batch(region: torch.Tensor, init: torch.Tensor,
                   connectivity: int = 8, use_plain: bool = False,
                   labels: torch.Tensor | None = None):
    """Component broadcast over one bool region, 4- or 8-connected: every
    pixel of each component gets the min of ``init`` (int32, values <= H*W)
    over it; pixels outside = H*W.  Replaces ``min_prop_pallas_batch``.
    ``labels`` (the region's CC labels, where the caller has them) only saves
    the plain version its own labelling pass; the kernel does not use them."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    region = _check("min_prop_batch", region, _REGION_DTYPES)
    init = _check("min_prop_batch init", init, _INIT_DTYPES, region)
    if use_plain or not region.is_cuda:
        return min_prop_plain(region, init, connectivity, labels)
    lib = _lib()
    t, h, w = region.shape
    out = torch.empty((t, h, w), dtype=torch.int32, device=region.device)
    scratch, scratch_ptr = _scratch(lib, region, True)
    with torch.cuda.device(region.device):
        err = lib.og_min_prop(region.data_ptr(), init.data_ptr(),
                              out.data_ptr(), scratch_ptr, t, h, w,
                              connectivity, _stream())
    _build.check(err, "min_prop_batch")
    _launched("min_prop_batch", (region, init), connectivity=connectivity)
    return out


def cc_batch(masks: torch.Tensor, connectivity: int = 8,
             use_plain: bool = False) -> torch.Tensor:
    """Per-frame connected-component labels of a (T, H, W) bool stack, 4- or
    8-connected: (T, H, W) int32, component id = min frame-local flat index,
    pixels outside = H*W.  Replaces ``connected_components_pallas_batch``."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    masks = _check("cc_batch", masks, _REGION_DTYPES)
    if use_plain or not masks.is_cuda:
        return cc_plain(masks, connectivity)
    lib = _lib()
    t, h, w = masks.shape
    out = torch.empty((t, h, w), dtype=torch.int32, device=masks.device)
    with torch.cuda.device(masks.device):
        err = lib.og_cc_batch(masks.data_ptr(), out.data_ptr(), t, h, w,
                              connectivity, _stream())
    _build.check(err, "cc_batch")
    _launched("cc_batch", (masks,), connectivity=connectivity)
    return out


def cc(mask: torch.Tensor, connectivity: int = 8,
       use_plain: bool = False) -> torch.Tensor:
    """Connected-component labels of ONE (H, W) bool frame: (H, W) int32.
    One launch of one thread block.  Replaces
    ``connected_components_pallas``."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    mask = _check("cc", mask, _REGION_DTYPES, dims=2)[0]
    if use_plain or not mask.is_cuda:
        return cc_plain(mask[None], connectivity)[0]
    lib = _lib()
    h, w = mask.shape
    out = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    with torch.cuda.device(mask.device):
        err = lib.og_cc(mask.data_ptr(), out.data_ptr(), h, w, connectivity,
                        _stream())
    _build.check(err, "cc")
    _launched("cc", (mask,), connectivity=connectivity)
    return out
