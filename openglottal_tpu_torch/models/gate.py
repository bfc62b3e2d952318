"""Temporal detection gate: the reference's TemporalDetector state machine
run over per-frame detection summaries (has_detection, x1, y1, x2, y2).

Counterpart of ``openglottal_tpu/models/gate.py`` (a ``lax.scan`` there):

  * centre drift-clamp: a fresh detection whose centre jumps more than
    ``max_shift_px`` from the previous centre is rejected (hold previous);
  * size update: every accepted detection sets the box size to the raw
    detection size + 2*padding (int-truncated toward zero);
  * hold/zero: up to ``max_hold_frames`` consecutive misses hold the previous
    box; one more miss zeroes the gate AND resets all state so re-acquisition
    starts fresh;
  * output clamp: the centre is clamped so the box stays inside the frame
    (``clip(lo > hi) -> hi`` semantics preserved).

The FSM is ~30 scalar ops per frame and strictly sequential.  On a CUDA
tensor it runs as ONE launch of a one-block kernel (``csrc/scan.cu``
``og_gate_scan``: the block stages the frames in shared memory and does in
parallel what does not read the carry, one thread walks the FSM with the
state in registers; ``(has, raw)`` in, ``(valid, box)`` out, no host
round-trip).  Its plain version is the Python loop below over numpy float32
scalars on the host (IEEE single arithmetic step by step, which eager 0-d
tensors would only repeat more slowly); CPU tensors take it.

:func:`gate_scan_batch` gates the K videos of a cohort, flattened into one
(sum T,) stack with their offsets, in ONE launch of ``og_gate_scan_batch``
(one block per video, the same body; the JAX package runs ``gate_scan``
under ``jax.vmap`` over padded videos).  Its plain version is a loop of the
per-video plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openglottal_tpu_torch.ops import _build, scan_cuda


class GateParams(NamedTuple):
    max_shift_px: float = 30.0
    padding: int = 8
    max_hold_frames: int = 3


class GateState(NamedTuple):
    """Carry of the FSM.  Python/numpy scalars on the host path; 0-d device
    tensors when returned by the kernel path (no synchronisation)."""

    valid: object   # bool  — have we a held detection?
    cx: object      # f32   — previous centre x
    cy: object      # f32   — previous centre y
    w: object       # i32   — current box width (incl. padding)
    h: object       # i32   — current box height
    miss: object    # i32   — consecutive misses


def gate_init() -> GateState:
    return GateState(False, np.float32(0.0), np.float32(0.0), 0, 0, 0)


def _hypot_f32(a: np.float32, b: np.float32) -> np.float32:
    """``jnp.hypot`` as the reference lowers it: max * sqrt(1 + (min/max)^2),
    every step rounded to float32."""
    a, b = np.abs(a), np.abs(b)
    if np.isinf(a) or np.isinf(b):
        return np.float32(np.inf)
    hi, lo = np.maximum(a, b), np.minimum(a, b)
    if hi == 0:
        return hi
    q = np.float32(lo / hi)
    return np.float32(hi * np.sqrt(np.float32(np.float32(1.0) + np.float32(q * q))))


def gate_step(state: GateState, det, frame_h: int, frame_w: int,
              params: GateParams):
    """One FSM step on host scalars.  det = (has, x1, y1, x2, y2).

    Returns (new_state, (out_valid, box int[4]))."""
    f32 = np.float32
    has = bool(det[0])
    x1, y1, x2, y2 = (f32(v) for v in det[1:])
    p = int(params.padding)
    s_valid = bool(state.valid)
    s_cx, s_cy = f32(state.cx), f32(state.cy)
    s_w, s_h, s_miss = int(state.w), int(state.h), int(state.miss)

    new_cx = f32(f32(x1 + x2) * f32(0.5))
    new_cy = f32(f32(y1 + y2) * f32(0.5))
    new_w = int(np.trunc(f32(x2 - x1))) + 2 * p   # C cast toward zero
    new_h = int(np.trunc(f32(y2 - y1))) + 2 * p

    jump = _hypot_f32(f32(new_cx - s_cx), f32(new_cy - s_cy))
    fresh = has and (not s_valid or bool(jump <= f32(params.max_shift_px)))

    miss = 0 if fresh else (s_miss + 1 if s_valid else s_miss)
    expired = s_valid and not fresh and miss > params.max_hold_frames

    valid = (fresh or s_valid) and not expired
    cx = new_cx if fresh else s_cx
    cy = new_cy if fresh else s_cy
    w = new_w if fresh else s_w
    h = new_h if fresh else s_h

    if expired:
        new_state = GateState(valid, f32(0.0), f32(0.0), 0, 0, 0)
    else:
        new_state = GateState(valid, cx, cy, w, h, miss)

    hw, hh = w // 2, h // 2
    ocx = int(np.trunc(np.minimum(np.maximum(cx, f32(hw)),
                                  f32(f32(frame_w) - f32(hw)))))
    ocy = int(np.trunc(np.minimum(np.maximum(cy, f32(hh)),
                                  f32(f32(frame_h) - f32(hh)))))
    return new_state, (valid, (ocx - hw, ocy - hh, ocx + hw, ocy + hh))


def gate_scan_plain(state: GateState, has: torch.Tensor, boxes: torch.Tensor,
                    frame_h: int, frame_w: int, params: GateParams):
    """Plain version: the FSM as a Python loop on the host.  Tensors on a
    device are copied to the host and the outputs copied back."""
    dev = has.device
    has_np = has.detach().cpu().numpy().astype(bool)
    raw_np = boxes.detach().to(torch.float32).cpu().numpy()
    st = GateState(*(v.item() if isinstance(v, torch.Tensor) else v
                     for v in state))
    t = has_np.shape[0]
    ov = np.zeros((t,), bool)
    ob = np.zeros((t, 4), np.int32)
    with np.errstate(all="ignore"):
        for i in range(t):
            st, (v, b) = gate_step(st, (has_np[i], *raw_np[i]), frame_h,
                                   frame_w, params)
            ov[i] = v
            ob[i] = b
    return st, (torch.from_numpy(ov).to(dev), torch.from_numpy(ob).to(dev))


def _state_buffer(state: GateState, device) -> torch.Tensor:
    """The carry as the kernel takes it: one int32 buffer of 6, ``state_i`` =
    (valid, w, h, miss) followed by ``state_f`` = (cx, cy) as float32 bits."""
    vals = list(state)
    if any(isinstance(v, torch.Tensor) for v in vals):
        vals = [torch.as_tensor(v, device=device) for v in vals]
        ints = torch.stack([vals[0].to(torch.int32), vals[3].to(torch.int32),
                            vals[4].to(torch.int32), vals[5].to(torch.int32)])
        flts = torch.stack([vals[1].to(torch.float32),
                            vals[2].to(torch.float32)])
        return torch.cat([ints, flts.view(torch.int32)])
    host = [int(bool(vals[0])), int(vals[3]), int(vals[4]), int(vals[5]),
            *np.array([vals[1], vals[2]], np.float32).view(np.int32).tolist()]
    if not any(host):
        # the initial state: filled on the device, no host-to-device copy
        return torch.zeros(6, dtype=torch.int32, device=device)
    return torch.tensor(host, dtype=torch.int32, device=device)


def _check_inputs(has: torch.Tensor, boxes: torch.Tensor) -> None:
    if has.dim() != 1 or boxes.shape != (has.shape[0], 4):
        raise ValueError(f"gate_scan: has {tuple(has.shape)} / boxes "
                         f"{tuple(boxes.shape)} are not (T,) and (T, 4)")
    if boxes.device != has.device:
        raise ValueError("gate_scan: has and boxes lie on different devices")


def _gate_scan_cuda(buf: torch.Tensor, has: torch.Tensor,
                    boxes: torch.Tensor, frame_h: int, frame_w: int,
                    params: GateParams):
    """One launch of ``og_gate_scan`` over a non-empty segment on the card,
    from the carry in ``buf`` (:func:`_state_buffer`), which the kernel
    overwrites with the carry after the segment.  Returns (out_valid,
    out_boxes)."""
    t = has.shape[0]
    dev = has.device
    # a bool or uint8 ``has`` goes by its storage (the kernel reads any
    # non-zero byte as a detection); other dtypes are compared with 0
    if has.dtype not in (torch.bool, torch.uint8):
        has = has != 0
    has_c = has.contiguous()
    raw = boxes.to(torch.float32).contiguous()
    # a recorded launch keeps the carry it started from
    state_in = buf.clone() if scan_cuda.RECORD is not None else None
    ov = torch.empty((t,), dtype=torch.bool, device=dev)   # written 0 / 1
    ob = torch.empty((t, 4), dtype=torch.int32, device=dev)
    so = scan_cuda.lib()
    with torch.cuda.device(dev):
        err = so.og_gate_scan(
            has_c.data_ptr(), raw.data_ptr(), ov.data_ptr(), ob.data_ptr(),
            buf[4:].data_ptr(), buf.data_ptr(), t, float(frame_h),
            float(frame_w), float(params.max_shift_px), int(params.padding),
            int(params.max_hold_frames), scan_cuda.stream())
    _build.check(err, "gate_scan")
    scan_cuda.launched("gate_scan", (has, boxes), frame_h=frame_h,
                       frame_w=frame_w, params=params, state=state_in)
    return ov, ob


def state_from_buffer(buf: torch.Tensor) -> GateState:
    """The carry of a kernel state buffer as a :class:`GateState` of 0-d
    device tensors (views of ``buf``; no synchronisation)."""
    si, sf = buf[:4], buf[4:].view(torch.float32)
    # valid is the low byte of state_i[0], which the kernel writes as 0 or 1
    valid = si[:1].view(torch.bool)[0]
    return GateState(valid, sf[0], sf[1], si[1], si[2], si[3])


class GateCarry:
    """The temporal gate fed a video one segment at a time, bit-exact with
    one :func:`gate_scan` over the whole video.  On the card the kernel's
    state buffer passes from one launch to the next as it is, so segments
    cost one launch each and no tensor operation in between; on the host
    (or with ``use_plain``) the plain version carries its state.  Calling
    it with a segment's (has, raw boxes) returns the segment's (out_valid,
    out_boxes)."""

    def __init__(self, frame_h: int, frame_w: int,
                 params: GateParams = GateParams(), use_plain: bool = False):
        self.frame_h, self.frame_w = frame_h, frame_w
        self.params = params
        self.use_plain = use_plain
        self.state = gate_init()
        self._buf = None

    def __call__(self, has: torch.Tensor, boxes: torch.Tensor):
        _check_inputs(has, boxes)
        if self.use_plain or not has.is_cuda:
            self.state, out = gate_scan_plain(self.state, has, boxes,
                                              self.frame_h, self.frame_w,
                                              self.params)
            return out
        if has.shape[0] == 0:
            return _empty_outputs(has.device)
        if self._buf is None:
            self._buf = _state_buffer(self.state, has.device)
        return _gate_scan_cuda(self._buf, has, boxes, self.frame_h,
                               self.frame_w, self.params)


def _empty_outputs(device):
    return (torch.empty((0,), dtype=torch.bool, device=device),
            torch.empty((0, 4), dtype=torch.int32, device=device))


def gate_scan_carry(state: GateState, has: torch.Tensor, boxes: torch.Tensor,
                    frame_h: int, frame_w: int,
                    params: GateParams = GateParams(), use_plain: bool = False):
    """Gate scan resumable across video segments: runs the FSM over this
    segment starting from ``state`` and returns the carry for the next one.
    Chunked calls are bit-exact with one scan over the concatenation.

    Returns (new_state, (out_valid (T,) bool, out_boxes (T, 4) int32)).
    """
    _check_inputs(has, boxes)
    if use_plain or not has.is_cuda:
        return gate_scan_plain(state, has, boxes, frame_h, frame_w, params)
    if has.shape[0] == 0:
        return state, _empty_outputs(has.device)
    buf = _state_buffer(state, has.device)
    out = _gate_scan_cuda(buf, has, boxes, frame_h, frame_w, params)
    return state_from_buffer(buf), out


def _state_rows(state: torch.Tensor) -> list[GateState]:
    """The carries of a (K, 6) int32 state buffer as host GateStates."""
    rows = state.detach().cpu().numpy()
    return [GateState(bool(r[0]), r[4:6].view(np.float32)[0],
                      r[4:6].view(np.float32)[1], int(r[1]), int(r[2]),
                      int(r[3])) for r in rows]


def _state_into(state: torch.Tensor, rows: list[GateState]) -> None:
    """Write host GateStates into a (K, 6) int32 state buffer."""
    buf = np.stack([np.asarray(_state_buffer(st, "cpu")) for st in rows])
    state.copy_(torch.from_numpy(buf.astype(np.int32)))


def gate_scan_batch(has: torch.Tensor, boxes: torch.Tensor, offsets,
                    frame_h: int, frame_w: int,
                    params: GateParams = GateParams(), state=None,
                    use_plain: bool = False):
    """The gate over K videos at once: video i is frames [offsets[i],
    offsets[i + 1]) of the flat (sum T,) ``has`` and (sum T, 4) raw
    ``boxes``; each is gated on its own from its own carry, exactly as
    :func:`gate_scan` (or :func:`gate_scan_carry`) gates it alone.

    offsets: K + 1 host ints, non-decreasing from 0 to sum T (a video of 0
    frames is allowed).  state: None (every video from :func:`gate_init`),
    or the carried form: a (K, 6) int32 tensor on ``has``'s device, one
    :func:`_state_buffer` row per video, read as the carries the videos
    start from and overwritten with their carries after this segment (pass
    it to the next call to resume K videos).

    Returns (out_valid (sum T,) bool, out_boxes (sum T, 4) int32).  On a
    CUDA tensor ONE launch of ``og_gate_scan_batch`` (one block per video);
    on a CPU tensor, or with ``use_plain``, a loop of the plain version."""
    _check_inputs(has, boxes)
    off = scan_cuda.check_offsets(offsets, has.shape[0])
    k = len(off) - 1
    if state is not None and (state.shape != (k, 6)
                              or state.dtype != torch.int32
                              or state.device != has.device):
        raise ValueError(f"gate_scan_batch: state must be ({k}, 6) int32 on "
                         f"{has.device}")
    if use_plain or not has.is_cuda:
        starts = _state_rows(state) if state is not None else [gate_init()] * k
        outs, ends = [], []
        for i in range(k):
            a, b = off[i], off[i + 1]
            st, out = gate_scan_plain(starts[i], has[a:b], boxes[a:b],
                                      frame_h, frame_w, params)
            outs.append(out)
            ends.append(st)
        if state is not None:
            _state_into(state, ends)
        if not outs:
            return _empty_outputs(has.device)
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))
    t = has.shape[0]
    dev = has.device
    if state is None:
        state = torch.zeros((k, 6), dtype=torch.int32, device=dev)
    if has.dtype not in (torch.bool, torch.uint8):
        has = has != 0
    has_c = has.contiguous()
    raw = boxes.to(torch.float32).contiguous()
    state_in = state.clone() if scan_cuda.RECORD is not None else None
    ov = torch.empty((t,), dtype=torch.bool, device=dev)
    ob = torch.empty((t, 4), dtype=torch.int32, device=dev)
    so = scan_cuda.lib()
    with torch.cuda.device(dev):
        err = so.og_gate_scan_batch(
            has_c.data_ptr(), raw.data_ptr(), ov.data_ptr(), ob.data_ptr(),
            state.data_ptr(), scan_cuda.offsets_arg(off), k, float(frame_h),
            float(frame_w), float(params.max_shift_px), int(params.padding),
            int(params.max_hold_frames), scan_cuda.stream())
    _build.check(err, "gate_scan_batch")
    scan_cuda.launched("gate_scan_batch", (has, boxes), offsets=off,
                       frame_h=frame_h, frame_w=frame_w, params=params,
                       state=state_in)
    return ov, ob


def gate_scan(has: torch.Tensor, boxes: torch.Tensor, frame_h: int,
              frame_w: int, params: GateParams = GateParams(),
              use_plain: bool = False):
    """Run the gate over a whole video.

    has:   (T,) bool   — the detector produced a detection this frame.
    boxes: (T, 4) f32  — raw max-conf (x1, y1, x2, y2) per frame.

    Returns (out_valid (T,) bool, out_boxes (T, 4) int32).  Frames where
    out_valid is False correspond to the reference returning None.  (The
    carry is not made into a state: on the card that would be six more
    tensor operations on the host per video.)
    """
    _check_inputs(has, boxes)
    if use_plain or not has.is_cuda:
        _, out = gate_scan_plain(gate_init(), has, boxes, frame_h, frame_w,
                                 params)
        return out
    if has.shape[0] == 0:
        return _empty_outputs(has.device)
    return _gate_scan_cuda(_state_buffer(gate_init(), has.device), has, boxes,
                           frame_h, frame_w, params)


def gate_single(has: torch.Tensor, boxes: torch.Tensor, frame_h: int,
                frame_w: int, params: GateParams = GateParams()):
    """Stateless per-frame gate: :func:`gate_step` from :func:`gate_init`
    on every frame (the detector reset before each frame, for frames with no
    temporal order), vectorised over frames as tensor operations on the
    tensors' device.  From the initial state a step reduces to: valid =
    has; the box is the raw detection's centre and size + 2 * padding (zero
    without a detection), its centre clamped into the frame.

    Returns (out_valid (T,) bool, out_boxes (T, 4) int32)."""
    _check_inputs(has, boxes)
    if has.dtype != torch.bool:
        has = has != 0
    b = boxes.to(torch.float32)
    p = 2 * int(params.padding)
    zero = torch.zeros((), dtype=torch.float32, device=b.device)
    cx = torch.where(has, (b[:, 0] + b[:, 2]) * 0.5, zero)
    cy = torch.where(has, (b[:, 1] + b[:, 3]) * 0.5, zero)
    # float32 -> int32 truncates toward zero, as the reference's cast
    w = torch.where(has, (b[:, 2] - b[:, 0]).to(torch.int32) + p, 0)
    h = torch.where(has, (b[:, 3] - b[:, 1]).to(torch.int32) + p, 0)
    hw = torch.div(w, 2, rounding_mode="floor")
    hh = torch.div(h, 2, rounding_mode="floor")
    hwf, hhf = hw.to(torch.float32), hh.to(torch.float32)
    ocx = torch.minimum(torch.maximum(cx, hwf), float(frame_w) - hwf
                        ).to(torch.int32)
    ocy = torch.minimum(torch.maximum(cy, hhf), float(frame_h) - hhf
                        ).to(torch.int32)
    return has, torch.stack([ocx - hw, ocy - hh, ocx + hw, ocy + hh], 1)


class TemporalGate:
    """The gate's parameters in one object, as the reference's
    TemporalDetector holds them (the confidence threshold is applied
    upstream, in the detector's decode).  Calling it gates a video:
    :func:`gate_scan` in order, or :func:`gate_single` frame by frame."""

    def __init__(self, max_shift_px: float = 30.0, padding: int = 8,
                 max_hold_frames: int = 3):
        self.params = GateParams(float(max_shift_px), int(padding),
                                 int(max_hold_frames))

    def __call__(self, has, boxes, frame_h: int, frame_w: int,
                 sequential: bool = True):
        fn = gate_scan if sequential else gate_single
        return fn(has, boxes, frame_h, frame_w, params=self.params)
