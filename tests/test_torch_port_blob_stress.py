"""The connected-component plain versions on inputs that are hard for a
union-find (``tools/blob_stress.py``: one frame-covering component,
checkerboards, combs, a one-pixel spiral, diagonal staircases, noise at three
densities, single-row and single-column frames), held exactly against the
JAX package's functions on the CPU.

``cc_plain`` stands for ``og_cc_batch`` and ``dual_cc_plain`` for
``og_dual_cc``: they are what each kernel is held against on the card.  The
JAX side runs as ``tests/test_torch_port_blobs.py`` runs it: the CPU branch
of ``openglottal_tpu/ops/blobs.py`` (``_propagate_batch``), which on a TPU
is ``connected_components_pallas_batch``; ``dual_cc_pallas_batch`` is the
code-1 8-connected labels where code == 1 and the code-2 4-connected labels
where code == 2.  Every family's four frames at one shape go through one JAX
call (one compile per shape and connectivity).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu.ops import blobs as jblobs
from openglottal_tpu_torch.ops import blobs_cuda
from openglottal_tpu_torch.tools.blob_stress import (
    FAMILIES,
    stress_codes,
    stress_masks,
)

H, W, T = 48, 40, 4
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape_of(family):
    return {"row": (1, W), "column": (H, 1)}.get(family, (H, W))


def _jax_labels(shape, conn):
    """The JAX package's labels of every family's masks and codes at
    ``shape``: {family: (masks, codes, labels of the masks, labels of
    code == 1 at 8 / code == 2 at 4)}, one JAX call per region kind."""
    key = (shape, conn)
    if key not in _CACHE:
        fams = [f for f in FAMILIES if _shape_of(f) == shape]
        masks = np.concatenate([stress_masks(f, H, W, T, seed=i)
                                for i, f in enumerate(fams)])
        codes = np.concatenate([stress_codes(f, H, W, T, seed=i)
                                for i, f in enumerate(fams)])
        region = codes == (1 if conn == 8 else 2)
        both = np.asarray(jblobs._propagate_batch(
            jnp.asarray(np.concatenate([masks, region])), 4096, conn))
        n = len(masks)
        _CACHE[key] = {f: (masks[i * T:(i + 1) * T], codes[i * T:(i + 1) * T],
                           both[i * T:(i + 1) * T],
                           both[n + i * T:n + (i + 1) * T])
                       for i, f in enumerate(fams)}
    return _CACHE[key]


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("family", FAMILIES)
def test_cc_plain_matches_jax_on_stress_family(family, conn):
    masks, _, want, _ = _jax_labels(_shape_of(family), conn)[family]
    got = blobs_cuda.cc_plain(torch.from_numpy(masks), conn).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", FAMILIES)
def test_dual_cc_plain_matches_jax_on_stress_family(family):
    shape = _shape_of(family)
    _, codes, _, lab8 = _jax_labels(shape, 8)[family]
    lab4 = _jax_labels(shape, 4)[family][3]
    got = blobs_cuda.dual_cc_plain(torch.from_numpy(codes)).numpy()
    hw = codes.shape[1] * codes.shape[2]
    want = np.where(codes == 1, lab8, np.where(codes == 2, lab4, hw))
    np.testing.assert_array_equal(got, want)
    assert (got[codes == 0] == hw).all()


def test_stress_families_are_what_they_say():
    """The spiral and the comb are one chain each, the checkerboards and the
    staircase connect only across corners, the code frames are 2 - mask
    with inactive pixels in the last frame only."""
    hw = H * W
    for family, n8, n4 in (("spiral", 1, 1), ("comb", 1, 1), ("ones", 1, 1),
                           ("checker", 1, hw // 2), ("staircase", None, None)):
        m = stress_masks(family, H, W, 1)
        lab8 = blobs_cuda.cc_plain(torch.from_numpy(m), 8).numpy()
        lab4 = blobs_cuda.cc_plain(torch.from_numpy(m), 4).numpy()
        c8 = len(np.unique(lab8[m]))
        c4 = len(np.unique(lab4[m]))
        if n8 is None:          # diagonals: 8-joined only
            assert c8 < c4 == int(m.sum())
        else:
            assert (c8, c4) == (n8, n4), family
    codes = stress_codes("random_0.5", H, W, T, seed=3)
    masks = stress_masks("random_0.5", H, W, T, seed=3)
    np.testing.assert_array_equal(codes[:-1], np.where(masks[:-1], 1, 2))
    assert (codes[-1] == 0).mean() > 0.1 and (codes[:-1] != 0).all()
    assert stress_masks("row", H, W, 2).shape == (2, 1, W)
    assert stress_masks("column", H, W, 2).shape == (2, H, 1)


# ── a model of csrc/blobs.cu's labelling form (label_kernel) ─────────────
# The kernel's bit-plane arithmetic, line for line, run by one thread: run
# starts from the planes and the carries, the union masks (vertical at the
# leftmost column of each overlap, diagonals for code 1), the rows joined in
# rounds (round j: the rows 2^j (2i + 1); on the card a thread a row, the
# lanes of a warp joining in lock-step), every run start flattened to its
# root, one read a pixel.  A slot
# read before it was set raises; so does a round that would touch a tree
# outside the two blocks of rows it joins, and an output slot that is not a
# root.  Change label_kernel and this model together.

M32 = 0xFFFFFFFF


def _run_starts(a, b, ca, cb):
    return ((a & ~(((a << 1) & M32) | ca)) | (b & ~(((b << 1) & M32) | cb))
            ) & M32


def _last_start(m, k, carry):
    return (k << 5) + m.bit_length() - 1 if m else carry


class _Forest:
    def __init__(self, n):
        self.p = [None] * n
        self.rows = None             # (lo, hi) pixel span a round may touch

    def get(self, i):
        if self.p[i] is None:
            raise AssertionError(f"slot {i} read before it was set")
        if self.rows and not self.rows[0] <= i < self.rows[1]:
            raise AssertionError(f"slot {i} outside the round's blocks")
        return self.p[i]

    def find(self, x):
        p = self.get(x)
        while p != x:
            gp = self.get(p)
            if gp == p:
                return p
            self.p[x] = gp
            x, p = gp, self.get(gp)
        return x

    def root(self, x):
        p = self.get(x)
        while p != x:
            x, p = p, self.get(p)
        return x

    def unite(self, a0, b0):
        a, b = self.find(a0), self.find(b0)
        for x in (max(a, b), a0, b0):     # the joined starts point at the root
            self.p[x] = min(a, b)


def _merge_row(f, pa, pb, r, w, words):
    ca = cb = cau = cbu = 0
    rs = rsu = 0
    row, up = r * w, (r - 1) * w
    for k in range(words):
        a, b, au, bu = pa[r][k], pb[r][k], pa[r - 1][k], pb[r - 1][k]
        an = pa[r - 1][k + 1] if k + 1 < words else 0
        s = _run_starts(a, b, ca, cb)
        su = _run_starts(au, bu, cau, cbu)
        va, vb = a & au, b & bu
        vert = ((va & ~(((va << 1) & M32) | (ca & cau)))
                | (vb & ~(((vb << 1) & M32) | (cb & cbu)))) & M32
        da = a & ~au & M32
        dl = da & (((au << 1) & M32) | cau)
        dr = da & ((au >> 1) | ((an << 31) & M32))
        todo = vert | dl | dr
        while todo:
            i = (todo & -todo).bit_length() - 1
            todo &= todo - 1
            le = M32 >> (31 - i)
            p = row + _last_start(s & le, k, rs)
            if vert >> i & 1:
                f.unite(p, up + _last_start(su & le, k, rsu))
            if dl >> i & 1:
                f.unite(p, up + _last_start(su & (le >> 1), k, rsu))
            if dr >> i & 1:
                f.unite(p, up + (k << 5) + i + 1)
        rs, rsu = _last_start(s, k, rs), _last_start(su, k, rsu)
        ca, cb, cau, cbu = a >> 31, b >> 31, au >> 31, bu >> 31


def _starts(pa, pb, r, k):
    ca = pa[r][k - 1] >> 31 if k else 0
    cb = pb[r][k - 1] >> 31 if k else 0
    s = _run_starts(pa[r][k], pb[r][k], ca, cb)
    return [(k << 5) + i for i in range(32) if s >> i & 1]


def label_model(code, conn_code):
    """One (h, w) frame through the labelling form: ``conn_code`` 0 (dual
    codes), 1 (a mask, 8-connected) or 2 (4-connected)."""
    h, w = code.shape
    words = (w + 31) >> 5
    c = code.astype(np.int64) if conn_code == 0 else (code != 0) * conn_code
    pa = [[0] * words for _ in range(h)]
    pb = [[0] * words for _ in range(h)]
    for r in range(h):
        for x in range(w):
            if c[r, x] == 1:
                pa[r][x >> 5] |= 1 << (x & 31)
            elif c[r, x] == 2:
                pb[r][x >> 5] |= 1 << (x & 31)
    f = _Forest(h * w)
    for r in range(h):
        for k in range(words):
            for x in _starts(pa, pb, r, k):
                f.p[r * w + x] = r * w + x
    step = 1
    while step < h:
        for r in range(step, h, 2 * step):
            f.rows = ((r - step) * w, min(r + step, h) * w)
            _merge_row(f, pa, pb, r, w, words)
        f.rows = None
        step *= 2
    for r in range(h):
        for k in range(words):
            for x in _starts(pa, pb, r, k):
                f.p[r * w + x] = f.root(r * w + x)
    out = np.full((h, w), h * w, np.int32)
    for r in range(h):
        ca = cb = rs = 0
        for k in range(words):
            a, b = pa[r][k], pb[r][k]
            s = _run_starts(a, b, ca, cb)
            for lane in range(32):
                x = (k << 5) + lane
                if x < w and ((a | b) >> lane & 1):
                    v = f.get(r * w + _last_start(s & (M32 >> (31 - lane)), k,
                                                  rs))
                    assert f.get(v) == v
                    out[r, x] = v
            rs = _last_start(s, k, rs)
            ca, cb = a >> 31, b >> 31
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_label_model_matches_plain_on_stress_family(family):
    """The model equals the plain versions on every family: masks 8- and
    4-connected, dual codes."""
    masks = stress_masks(family, H, W, T, seed=5)
    codes = stress_codes(family, H, W, T, seed=5)
    want8 = blobs_cuda.cc_plain(torch.from_numpy(masks), 8).numpy()
    want4 = blobs_cuda.cc_plain(torch.from_numpy(masks), 4).numpy()
    dual = blobs_cuda.dual_cc_plain(torch.from_numpy(codes)).numpy()
    for i in range(T):
        np.testing.assert_array_equal(label_model(masks[i], 1), want8[i])
        np.testing.assert_array_equal(label_model(masks[i], 2), want4[i])
        np.testing.assert_array_equal(label_model(codes[i], 0), dual[i])


@pytest.mark.parametrize("h", [1, 2, 3, 16, 37])
@pytest.mark.parametrize("w", [1, 31, 32, 33, 40, 63, 64, 65, 127, 128, 129])
def test_label_model_width_and_height_edges(w, h):
    """Every width edge of the 32-bit words and heights around the rounds'
    powers of two, three-valued codes with a column joining the rows."""
    rng = np.random.default_rng(w * 100 + h)
    code = rng.integers(0, 3, (1, h, w)).astype(np.uint8)
    code[0, :, w // 2] = 2
    want = blobs_cuda.dual_cc_plain(torch.from_numpy(code)).numpy()[0]
    np.testing.assert_array_equal(label_model(code[0], 0), want)
