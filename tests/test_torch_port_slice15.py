"""K5's backward as csrc/local_attention.cu computes it since its redesign
for the H100: a query side that writes each row's lse and writes ds once
as drel, in the caller's [B, HW, H x 225] layout, and a key side that
recomputes P^T from that lse and re-indexes mirrored window rows. The
plain forms of those stages, f32 on the CPU, against the plain backward,
against each other and against the JAX package's rule (_trainable_bwd, the
VJP of tiled_local_attention), at one and two heads, on grids of at least
8 a side (whole 8 x 8 tiles in one axis and ragged in both). The kernels
run only on the card, where chip_smoke.py holds them to their plain
version."""

import jax
import numpy as np
import pytest
import torch

from rmem_tpu.kernels.local_attention import _trainable_bwd
from rmem_tpu_torch.kernels import local_attention as kl

# f32 on both sides, summed in other orders: a few f32 ulps of O(1) values
TOL = dict(rtol=1e-4, atol=1e-4)
# the same arithmetic in the same library, gathered in another order
SAME_TOL = dict(rtol=1e-5, atol=1e-5)
# 8 x 9: whole 8 x 8 tiles down, ragged across; 9 x 13: ragged on both
GRIDS = [(8, 9), (9, 13)]
B, DH, DV, M = 2, 32, 64, 7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(heads, size, seed):
    rng = np.random.RandomState(seed)
    hw = size[0] * size[1]
    args = [rng.randn(B, hw, heads * d).astype(np.float32)
            for d in (DH, DH, DV, 225)]
    g = rng.randn(B, hw, heads * DV).astype(np.float32)
    return args, g, DH ** -0.5


def _window_logits(q, k, rel, size, heads, scale):
    """[B, heads, HW, 225] logits of each query's window, -inf where the key
    lies outside the image, by a loop over the window's offsets."""
    h, w = size
    qh = q.reshape(B, h, w, heads, DH)
    kh = k.reshape(B, h, w, heads, DH)
    out = np.full((B, heads, h * w, 225), -np.inf, dtype=np.float64)
    relh = rel.reshape(B, h * w, heads, 225)
    for wy in range(15):
        for wx in range(15):
            dy, dx = wy - M, wx - M
            ys = slice(max(0, -dy), min(h, h - dy))
            xs = slice(max(0, -dx), min(w, w - dx))
            kys = slice(ys.start + dy, ys.stop + dy)
            kxs = slice(xs.start + dx, xs.stop + dx)
            dots = (qh[:, ys, xs] * kh[:, kys, kxs]).sum(-1) * scale
            grid = np.full((B, h, w, heads), -np.inf)
            grid[:, ys, xs] = dots
            s = grid.reshape(B, h * w, heads) + relh[..., wy * 15 + wx]
            out[..., wy * 15 + wx] = np.where(np.isfinite(grid.reshape(
                B, h * w, heads)), s, -np.inf).transpose(0, 2, 1)
    return out


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("size", GRIDS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_stages_match_jax_rule(size, heads):
    """dq, dk, dv, drel of the stages composed (the query side's lse rows,
    p, dp, delta, ds and dq; the key side's P^T from that lse, ds^T from
    mirrored drel rows, dv and dk) against pallas_local_attention_
    trainable's backward rule at the same inputs."""
    args, g, scale = _inputs(heads, size, 10 * heads + size[1])
    refs = jax.jit(lambda *a: _trainable_bwd(size, heads, 7, scale, True,
                                             a[:4], a[4]))(*args, g)
    got = kl.local_attention_bwd_stages_plain(
        *map(torch.tensor, args), torch.tensor(g), size, heads, 7, scale)
    for name, t, r in zip(("dq", "dk", "dv", "drel"), got, refs):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("heads", [1, 2])
def test_stages_compose_to_the_plain_backward(heads):
    """The stages, gathered window by window, give what
    local_attention_bwd_plain gives through dense [HW x HW] products."""
    size = (9, 13)
    args, g, scale = _inputs(heads, size, 20 + heads)
    ins = (*map(torch.tensor, args), torch.tensor(g), size, heads, 7, scale)
    for name, a, r in zip(("dq", "dk", "dv", "drel"),
                          kl.local_attention_bwd_stages_plain(*ins),
                          kl.local_attention_bwd_plain(*ins)):
        np.testing.assert_allclose(a.numpy(), r.numpy(), **SAME_TOL,
                                   err_msg=name)


def test_lse_rows_are_each_windows_logsumexp():
    """The query side's lse [B, H, HW]: the log of the sum of exp over each
    query's window keys inside the image, bias included (a loop over the
    window's offsets in f64)."""
    size, heads = (9, 13), 2
    (q, k, v, rel), _, scale = _inputs(heads, size, 30)
    ref = _window_logits(q, k, rel, size, heads, scale)
    mx = ref.max(-1, keepdims=True)
    ref = (mx + np.log(np.exp(ref - mx).sum(-1, keepdims=True)))[..., 0]
    got = kl.local_bwd_lse_plain(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(rel), size, heads, 7, scale)
    assert got.shape == (B, heads, size[0] * size[1])
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_key_probs_are_the_query_probs_mirrored():
    """The key side's P^T, recomputed from q, k, the bias and the lse rows,
    equals the query side's p re-indexed to the mirrored offsets; and each
    key-major row j holds column j of the dense [query x key] softmax."""
    size, heads = (9, 13), 2
    (q, k, v, rel), _, scale = _inputs(heads, size, 31)
    tq, tk, trel = map(torch.tensor, (q, k, rel))
    lse = kl.local_bwd_lse_plain(tq, tk, trel, size, heads, 7, scale)
    s = torch.tensor(_window_logits(q, k, rel, size, heads, scale),
                     dtype=torch.float32)
    p = torch.exp(s - lse[..., None])                  # 0 outside the image
    pt = kl.local_bwd_key_probs_plain(tq, tk, trel, lse, size, heads, 7,
                                      scale)
    np.testing.assert_allclose(
        pt.numpy(), kl.mirror_rows(p, size, 7).numpy(), **TOL)
    # the dense softmax, column by column
    hw = size[0] * size[1]
    idx, ok = kl._window_keys(*size, 7)
    dense = np.zeros((B, heads, hw, hw), dtype=np.float32)
    rows = np.arange(hw)[:, None].repeat(225, 1)
    for bb in range(B):
        for hh in range(heads):
            dense[bb, hh, rows[ok], idx[ok]] = p[bb, hh].numpy()[ok]
    got = np.zeros_like(dense)
    for bb in range(B):
        for hh in range(heads):
            # key j's row: the query idx[j, w] sees it
            got[bb, hh, idx[ok], rows[ok]] = pt[bb, hh].numpy()[ok]
    np.testing.assert_allclose(got, dense, **TOL)


def test_mirror_rows_twice_keeps_the_image():
    """Mirroring window rows twice gives them back wherever the window lies
    inside the image, and zeros elsewhere: a query at offset w from a key
    has that key at the mirrored offset."""
    size = (9, 13)
    hw = size[0] * size[1]
    x = torch.tensor(np.random.RandomState(32).randn(B, 2, hw, 225)
                     .astype(np.float32))
    _, ok = kl._window_keys(*size, 7)
    twice = kl.mirror_rows(kl.mirror_rows(x, size, 7), size, 7)
    assert torch.equal(twice, torch.where(torch.tensor(ok), x, 0.0))


def test_drel_in_the_callers_layout():
    """drel comes back [B, HW, H x 225], head h's ds in columns h 225 ..
    +225 (each head's as that head alone gives it), and 0 wherever the
    window leaves the image: from the stages and from the plain backward."""
    size, heads = (9, 13), 2
    args, g, scale = _inputs(heads, size, 33)
    ts = [torch.tensor(a) for a in (*args, g)]
    _, ok = kl._window_keys(*size, 7)
    for fn in (kl.local_attention_bwd_stages_plain,
               kl.local_attention_bwd_plain):
        drel = fn(*ts, size, heads, 7, scale)[3]
        assert drel.shape == (B, size[0] * size[1], heads * 225)
        for h in range(heads):
            cols = slice(h * 225, (h + 1) * 225)
            one = [t[..., h * (t.shape[-1] // heads):
                       (h + 1) * (t.shape[-1] // heads)] for t in ts]
            np.testing.assert_allclose(
                drel[..., cols].numpy(),
                fn(*one, size, 1, 7, scale)[3].numpy(), **SAME_TOL)
            assert torch.all(drel[..., cols][:, torch.tensor(~ok)] == 0)
