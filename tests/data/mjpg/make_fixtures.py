"""Writes the MJPG fixtures of this directory and ``digests.json``.

    python tests/data/mjpg/make_fixtures.py

Needs cv2 (its FFmpeg MJPG writer and ``cv2.VideoCapture``) and PIL, so it
runs on a development machine, not on the GPU machine, which has neither:
there ``chip_smoke.py`` checks the card's frames against the digests of
cv2's frames written here.  The fixtures:

  real_256_64.avi        64 frames of the realistic synthetic video, 256²
                         (cv2, 4:2:0; chip_smoke.py repeats its frames into
                         a 502-frame clip, MJPG frames being independent)
  colour_64x80.avi       cv2, colour, 4:2:0
  gray_64x80.avi         cv2 with isColor=False (still 4:2:0 colour frames)
  odd_37x53.avi          cv2 asked for 37x53: it writes 36x52 frames
  wide_240x320.avi       cv2, 240x320
  pil_444_37x53.avi      PIL frames wrapped in an AVI: 4:4:4, odd size
  pil_422_38x54.avi      4:2:2
  pil_420_38x53.avi      4:2:0, odd width
  pil_gray_37x53.avi     one component
  pil_rst_48x64.avi      4:2:0 with a restart interval of 3 MCUs
  pil_annexk_48x64.avi   4:2:0 with its DHT segments removed (Annex K)
  pil_420_odd_37x53.avi  4:2:0 of odd height, blurred colour noise
                         (swscale's bicubic chroma path, not ported: the
                         port refuses it)

``digests.json`` holds, per file, the shape of cv2's frames, the sha256 of
each of its (H, W, 3) BGR frames, and the largest difference and share of
samples between the port's plain decode and cv2's, or, for a file the port
refuses, its message (``refused``).
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from openglottal_tpu_torch.data.synthetic import synthetic_video  # noqa: E402
from openglottal_tpu_torch.data.video import load_frames_bgr  # noqa: E402
from openglottal_tpu_torch.tools.jpeg_stress import (  # noqa: E402
    write_mjpg_avi,
)


def cv2_frames(path) -> np.ndarray:
    cap, out = cv2.VideoCapture(str(path)), []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return np.stack(out)


def content(rng, t, h, w, kind):
    """Colour test frames: blurred noise, or saturated 4x4 squares with a
    white and a black band (flat blocks of extreme DC)."""
    if kind == "blur":
        return np.stack([cv2.GaussianBlur(f, (0, 0), 1.5) for f in
                         rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)])
    f = rng.integers(0, 2, (t, h // 4 + 1, w // 4 + 1, 3),
                     dtype=np.uint8) * 255
    f = np.repeat(np.repeat(f, 4, 1), 4, 2)[:, :h, :w]
    f[:, :h // 3] = 255
    f[:, h // 3:h // 2] = 0
    return np.ascontiguousarray(f)


def cv2_clip(path, frames, color=True):
    h, w = frames.shape[1:3]
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30,
                         (w, h), isColor=color)
    for f in frames:
        wr.write(f)
    wr.release()


def pil_jpeg(bgr, **kw) -> bytes:
    b = io.BytesIO()
    img = Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])
                          if bgr.ndim == 3 else bgr)
    img.save(b, "JPEG", **kw)
    return b.getvalue()


def strip_dht(jpeg: bytes) -> bytes:
    """The frame without its DHT segments (markers before the scan)."""
    out, pos = bytearray(jpeg[:2]), 2
    while pos < len(jpeg):
        m = jpeg[pos + 1]
        if m == 0xDA:
            return bytes(out + jpeg[pos:])
        n = int.from_bytes(jpeg[pos + 2:pos + 4], "big")
        if m != 0xC4:
            out += jpeg[pos:pos + 2 + n]
        pos += 2 + n
    return bytes(out)


def pil_clip(path, frames, **kw):
    js = [pil_jpeg(f, **{k: v for k, v in kw.items() if k != "strip"})
          for f in frames]
    if kw.get("strip"):
        js = [strip_dht(j) for j in js]
    h, w = frames.shape[1:3]
    write_mjpg_avi(path, js, w, h)


def main() -> None:
    rng = np.random.default_rng(2024)
    real, _ = synthetic_video(t=64, size=256, seed=5, realistic=True)
    cv2_clip(HERE / "real_256_64.avi", real)
    mixed = lambda t, h, w: np.concatenate(  # noqa: E731
        [content(rng, t // 2, h, w, "blur"),
         content(rng, t - t // 2, h, w, "sharp")])
    cv2_clip(HERE / "colour_64x80.avi", mixed(4, 64, 80))
    cv2_clip(HERE / "gray_64x80.avi", mixed(4, 64, 80)[..., 1], color=False)
    cv2_clip(HERE / "odd_37x53.avi", mixed(3, 37, 53))
    cv2_clip(HERE / "wide_240x320.avi", content(rng, 3, 240, 320, "blur"))
    pil_clip(HERE / "pil_444_37x53.avi", mixed(3, 37, 53), quality=90,
             subsampling=0)
    pil_clip(HERE / "pil_422_38x54.avi", mixed(3, 38, 54), quality=75,
             subsampling=1)
    pil_clip(HERE / "pil_420_38x53.avi", mixed(3, 38, 53), quality=50,
             subsampling=2)
    pil_clip(HERE / "pil_gray_37x53.avi", mixed(3, 37, 53)[..., 0],
             quality=95)
    pil_clip(HERE / "pil_rst_48x64.avi", mixed(3, 48, 64), quality=85,
             subsampling=2, restart_marker_blocks=3)
    pil_clip(HERE / "pil_annexk_48x64.avi", mixed(3, 48, 64), quality=85,
             subsampling=2, strip=True)
    pil_clip(HERE / "pil_420_odd_37x53.avi", content(rng, 3, 37, 53, "blur"),
             quality=75, subsampling=2)
    digests = {}
    for path in sorted(HERE.glob("*.avi")):
        want = cv2_frames(path)
        digests[path.name] = {
            "shape": list(want.shape),
            "sha256": [hashlib.sha256(f.tobytes()).hexdigest()
                       for f in want]}
        try:
            got = load_frames_bgr(path, device="cpu")
        except ValueError as e:
            digests[path.name]["refused"] = str(e)
            print(path.name, want.shape, "refused:", e)
            continue
        d = np.abs(want.astype(np.int64) - got.astype(np.int64))
        digests[path.name].update(max_abs_diff=int(d.max()),
                                  share_differing=float((d > 0).mean()))
        print(path.name, want.shape, path.stat().st_size, "bytes, max diff",
              int(d.max()))
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    main()
