"""Per-pass SM cycles of the union-find's labelling kernels, on one CUDA
device.

    python3 -m openglottal_tpu_torch.tools.blob_cycles [--against DIR ...]
        [--out DIR]

Copies ``csrc/blobs.cu`` of this checkout (and of every ``--against``
checkout), instruments the copy and builds it beside the package's own
libraries: in every ``__global__`` kernel, thread 0 of each block stores
``clock64()`` when the kernel starts, after every barrier between passes
(``__syncthreads();`` and calls of the source's ``pass_barrier``) and where
the kernel ends, and there also the block's SM.  The differences are the
cycles each pass took in that block.  Nothing of the instrumentation is kept
in ``csrc/``.

Inputs: the launches of ``og_dual_cc`` (guided-vft's 500 windows of 128x128)
and ``og_cc_batch`` (vft's crops, 502x48x40, 8- and 4-connected) that the
served 502-frame synthetic video gives (demo weights, bfloat16), and
one-component frames of the same shapes (all code 1; all code 2; all ones).
Prints one JSON line per (checkout, input): blocks, marks a block, each
pass's cycles (median, mean and max over blocks), the launch's device time
by CUDA events, and the SM clock nvidia-smi read beside it.  With ``--out``
the lines also go to ``DIR/blob_cycles.jsonl``.  Fails without a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

MAX_BLOCKS = 4096
MARKS = 24          # clock slots a block; the last two hold the block's SM
                    # and its mark count

_HEADER = f"""
__device__ long long og_pass_clock[{MAX_BLOCKS * MARKS}];
__device__ __forceinline__ unsigned og_block() {{
  return blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
}}
__device__ __forceinline__ void og_mark(int& k) {{
  if (threadIdx.x == 0 && og_block() < {MAX_BLOCKS} && k < {MARKS - 2})
    og_pass_clock[og_block() * {MARKS} + k] = clock64();
  ++k;
}}
__device__ __forceinline__ void og_end(int& k) {{
  og_mark(k);
  if (threadIdx.x == 0 && og_block() < {MAX_BLOCKS}) {{
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    og_pass_clock[og_block() * {MARKS} + {MARKS - 2}] = sm;
    og_pass_clock[og_block() * {MARKS} + {MARKS - 1}] = k;
  }}
}}
"""

_FOOTER = f"""
extern "C" int og_read_pass_clock(long long* host, int blocks) {{
  const int n = blocks < {MAX_BLOCKS} ? blocks : {MAX_BLOCKS};
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, og_pass_clock, sizeof(long long) * {MARKS} * n));
}}
extern "C" int og_clear_pass_clock() {{
  static long long zero[{MAX_BLOCKS * MARKS}];
  return static_cast<int>(cudaMemcpyToSymbol(og_pass_clock, zero,
                                             sizeof(zero)));
}}
"""

_BARRIER = re.compile(r"(__syncthreads\(\)\s*;|pass_barrier\([^;]*\)\s*;)")


def _body_end(src: str, open_brace: int) -> int:
    """Index of the brace that closes the one at ``open_brace``."""
    depth = 0
    for i in range(open_brace, len(src)):
        if src[i] == "{":
            depth += 1
        elif src[i] == "}":
            depth -= 1
            if depth == 0:
                return i
    raise ValueError("unbalanced braces")


def instrument(src: str, barrier: re.Pattern = _BARRIER,
               footer: str = "") -> str:
    """``src`` with a clock mark at the start of every ``__global__``
    kernel's body, after each statement that ``barrier`` matches in it, and
    at each of its ends (where thread 0 also stores the block's SM and its
    mark count); ``footer`` goes after the readers."""
    out, pos = [], 0
    for m in re.finditer(r"__global__[^{;]*?\(", src):
        open_brace = src.index("{", m.end())
        close = _body_end(src, open_brace)
        body = src[open_brace + 1:close]
        body = barrier.sub(lambda b: b.group(1) + " og_mark(og_k);", body)
        body = re.sub(r"\breturn\s*;", "{ og_end(og_k); return; }", body)
        out += [src[pos:open_brace + 1], " int og_k = 0; og_mark(og_k);",
                body, " og_end(og_k);\n"]
        pos = close
    out.append(src[pos:])
    text = "".join(out)
    # the helpers go after the includes, the readers at the end
    last_include = max(i.end() for i in re.finditer(r"#include[^\n]*\n", text))
    return (text[:last_include] + _HEADER + text[last_include:] + _FOOTER
            + footer)


def _sm_clock() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread: {e}"


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", nargs="*", default=[],
                    help="other checkouts whose csrc/blobs.cu to instrument")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("blob_cycles: no CUDA device available", file=sys.stderr)
        return 1

    from openglottal_tpu_torch.data.synthetic import synthetic_video
    from openglottal_tpu_torch.ops import _build, blobs_cuda
    from openglottal_tpu_torch.pipelines import GlottalPipelines

    root = Path(__file__).resolve().parents[2]
    _build.build_all()        # every source at once (the pipelines use them)
    checkouts = {"this": root, **{d: Path(d) for d in a.against}}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = {}
    for i, (tag, d) in enumerate(checkouts.items()):
        patched = _build.BUILD_DIR / f"blobs_cycles{i}.cu"
        patched.write_text(instrument(
            (d / "openglottal_tpu_torch/csrc/blobs.cu").read_text()))
        sources[tag] = patched
    built = _build.build_others({f"blobs_cycles_{i}": p for i, p in
                                 enumerate(sources.values())})
    libs = {tag: built[f"blobs_cycles_{i}"][0]
            for i, tag in enumerate(sources)}

    # the served inputs: one 502-frame synthetic video through both trackers
    frames, _ = synthetic_video(t=502, size=256, seed=0, realistic=False)
    pipe = GlottalPipelines(dtype=torch.bfloat16,
                            unet_variables="weights/demo_unet.npz",
                            yolo_variables="weights/demo_yolo.npz", conf=0.25)
    record = []
    blobs_cuda.RECORD = record
    try:
        for p in ("guided-vft", "vft"):
            pipe.extract_features(np.ascontiguousarray(frames[..., 0]), p)
    finally:
        blobs_cuda.RECORD = None
    dev = torch.device("cuda")
    cases = []
    for name, inputs, kw in record:
        if name == "dual_cc_batch":
            cases.append(("og_dual_cc", "served", inputs[0], 0))
        elif name == "cc_batch":
            cases.append(("og_cc_batch", "served", inputs[0],
                          kw["connectivity"]))
    for v in (1, 2):
        cases.append(("og_dual_cc", f"one component, code {v}",
                      torch.full((500, 128, 128), v, dtype=torch.uint8,
                                 device=dev), 0))
    for conn in (8, 4):
        cases.append(("og_cc_batch", "one component",
                      torch.ones((502, 48, 40), dtype=torch.bool, device=dev),
                      conn))

    lines = []
    stream = torch.cuda.current_stream().cuda_stream
    for tag, lib in libs.items():
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.og_dual_cc.argtypes = [p, p, i, i, i, p]
        lib.og_cc_batch.argtypes = [p, p, i, i, i, i, p]
        lib.og_read_pass_clock.argtypes = [p, i]
        for k, (entry, what, x, conn) in enumerate(cases):
            t, h, w = x.shape
            out = torch.empty((t, h, w), dtype=torch.int32, device=dev)
            args = (x.data_ptr(), out.data_ptr(), t, h, w,
                    *((conn,) if entry == "og_cc_batch" else ()), stream)
            launch = getattr(lib, entry)
            _build.check(lib.og_clear_pass_clock(), "clear")
            _build.check(launch(*args), entry)
            torch.cuda.synchronize()
            clk = np.zeros((MAX_BLOCKS, MARKS), np.int64)
            _build.check(lib.og_read_pass_clock(clk.ctypes.data, t), "read")
            want = (blobs_cuda.dual_cc_plain(x) if entry == "og_dual_cc"
                    else blobs_cuda.cc_plain(x, conn))
            equal = bool(torch.equal(out, want))
            blocks = clk[:, MARKS - 1] > 0
            n_marks = min(int(clk[blocks, MARKS - 1].max()), MARKS - 2)
            cyc = np.diff(clk[blocks, :n_marks], axis=1)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            launch(*args)
            e0.record()
            for _ in range(20):
                launch(*args)
            e1.record()
            torch.cuda.synchronize()
            line = {"checkout": tag, "entry": entry, "input": what,
                    "case": k, "shape": [t, h, w], "connectivity": conn,
                    "equal_to_plain": equal, "blocks": int(blocks.sum()),
                    "marks_a_block": n_marks,
                    "pass_cycles_median": np.median(cyc, 0).tolist(),
                    "pass_cycles_mean": cyc.mean(0).tolist(),
                    "pass_cycles_max": cyc.max(0).tolist(),
                    "block_cycles_median": float(np.median(cyc.sum(1))),
                    "ms": e0.elapsed_time(e1) / 20,
                    "sm_clock_mhz_now_max": _sm_clock()}
            print(json.dumps(line), flush=True)
            lines.append(line)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if a.out:
        Path(a.out).mkdir(parents=True, exist_ok=True)
        with open(Path(a.out) / "blob_cycles.jsonl", "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0 if all(x["equal_to_plain"] for x in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
