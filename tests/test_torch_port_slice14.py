"""K2's split backward (csrc/bank_attention_bwd.cu: a dq, a dk and a dv
kernel that each recompute p and ds from the lse, dV split across blocks by
value columns, dq summed over slot groups) in its plain form, against the
JAX package (jax.vjp of pallas_bank_attention in interpret mode) at one
head of 128 with values 512 and at two heads of 128 with values 256 a head;
the form's groups against the whole sums, the wrapper on the CPU and the
route by head shape. The CUDA kernels are held to this form on the card by
chip_smoke.py."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from rmem_tpu.kernels.bank_attention import pallas_bank_attention
from rmem_tpu_torch.kernels import bank_attention as kb

# f32 on both sides; the form sums in another order than Pallas (slot
# groups, value groups, the row term from the plain forward): a few f32
# ulps of the gradients' scale
GRAD_TOL = 1e-4
SOURCE = (Path(kb.__file__).resolve().parents[1] / "csrc"
          / "bank_attention_bwd.cu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores, and
    PyTorch's default of one thread per visible CPU makes each of them
    wait on the others many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _close(got, ref, rel):
    """max |got - ref| <= rel * max |ref|, shapes equal."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _inputs(seed, heads, values, s=5, b=1, lq=40, lk=50):
    """q, bank_k, bank_v, dout, drec at `heads` heads of 128 with `values`
    a head (numpy, f32), 5 slots of 50 keys, 40 queries."""
    rng = np.random.RandomState(seed)
    c, v = heads * 128, heads * values
    return (_rand(rng, b, lq, c) * 0.3, _rand(rng, s, b, lk, c) * 0.3,
            _rand(rng, s, b, lk, v), _rand(rng, b, lq, v),
            _rand(rng, b, lq, s))


def _rows(q, bk, bv, cnt, dout, drec, heads, scale):
    """The forward's lse_h and each head's row term delta_h [B, h, Lq], from
    the plain forward, as the wrapper hands them to the kernels."""
    out, rec, lse = kb.bank_attention_lse_plain(q, bk, bv, cnt, scale, heads)
    b, lq = q.shape[:2]
    rec_h, lse_h = rec.reshape(b, heads, lq, -1), lse.reshape(b, heads, lq)
    return lse_h, kb.bwd_delta_mh(dout, out, drec, rec_h), (out, rec, lse)


@pytest.mark.parametrize("heads,values,count", [
    # one head, two value groups a head: 3 of 5 slots (two dq groups, the
    # second with one slot) and all 5
    pytest.param(1, 512, 3, id="h1-v512-3"),
    pytest.param(1, 512, 5, id="h1-v512-5"),
    # two heads of 128 with 256 values a head
    pytest.param(2, 256, 3, id="h2-v256-3"),
    pytest.param(2, 256, 5, id="h2-v256-5")])
def test_split_plain_matches_pallas_vjp(heads, values, count):
    """The split route's plain form (`bank_attention_bwd_split_plain`: p
    and ds recomputed from the lse per role, dv per group of
    SPLIT_DV_COLUMNS value columns, dq the fixed-order sum of the slot
    groups' partials), fed the plain forward's lse and each head's row
    term, against jax.vjp of pallas_bank_attention (interpret mode) with
    nonzero cotangents of the output and of the head-mean record: dq, dk,
    dv, and dk, dv exactly 0 in the invalid slots; autograd of the plain
    forward agrees."""
    q, bk, bv, dout, drec = _inputs(60 + 10 * heads + count, heads, values)
    scale = 128 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: pallas_bank_attention(
            *a, jnp.int32(count), heads, scale=scale),
            *map(jnp.asarray, (q, bk, bv)))
        refs = vjp((jnp.asarray(dout), jnp.asarray(drec)))
    cnt = torch.tensor(count, dtype=torch.int32)
    ins = (_t(q), _t(bk), _t(bv), cnt)
    lse_h, delta_h, _ = _rows(*ins, _t(dout), _t(drec), heads, scale)
    got = kb.bank_attention_bwd_split_plain(*ins, _t(dout), lse_h, delta_h,
                                            _t(drec), scale)
    auto = kb.bank_attention_bwd_plain(*ins, _t(dout), _t(drec), scale,
                                       heads)
    for g, a, r in zip(got, auto, refs):
        _close(g, r, GRAD_TOL)
        _close(a, r, GRAD_TOL)
    assert torch.all(got[1][count:] == 0) and torch.all(got[2][count:] == 0)


def test_split_groups_partition_the_sums():
    """The form's groups are partitions: dq as the sum of the slot groups'
    partials (3 valid slots: a group of SPLIT_DQ_SLOTS and one of one) is
    the sum over the valid slots, and dv by groups of SPLIT_DV_COLUMNS value
    columns (two a head at 512 values a head) is the one product over all
    of a head's columns; both within f32 rounding of the head-generic plain
    stages, dk too."""
    heads, count, scale = 2, 3, 128 ** -0.5
    q, bk, bv, dout, drec = map(_t, _inputs(90, heads, 512, b=2, lq=37,
                                            lk=20))
    cnt = torch.tensor(count, dtype=torch.int32)
    lse_h, delta_h, _ = _rows(q, bk, bv, cnt, dout, drec, heads, scale)
    args = (q, bk, bv, cnt, dout, lse_h, delta_h, drec, scale)
    dq, dk, dv = kb.bank_attention_bwd_split_plain(*args)
    rdk, rdv = kb.bank_attention_bwd_mh_dkv_plain(*args)
    _close(dq, kb.bank_attention_bwd_mh_dq_plain(*args), 1e-6)
    _close(dk, rdk, 1e-6)
    _close(dv, rdv, 1e-6)
    assert kb.SPLIT_DQ_SLOTS < count and 512 // kb.SPLIT_DV_COLUMNS == 2


def test_split_wrapper_on_cpu_takes_the_plain_form():
    """`bank_attention_bwd` (the backward training's autograd Function
    calls) on CPU tensors, at one head of 128 with values 512 (the
    forward's head axes dropped, as K1' gives them at one head) and at two
    heads of 128 with values 256 a head: the split route's plain form, fed
    each head's row term from `bwd_delta_mh`, and no launch counted."""
    before = kb.bank_attention_bwd_split.launches
    for heads, values in ((1, 512), (2, 256)):
        q, bk, bv, dout, drec = map(_t, _inputs(95 + heads, heads, values))
        cnt, scale = torch.tensor(3, dtype=torch.int32), 128 ** -0.5
        lse_h, delta_h, (out, rec, lse) = _rows(q, bk, bv, cnt, dout, drec,
                                                heads, scale)
        got = kb.bank_attention_bwd(q, bk, bv, cnt, out, rec, lse, dout,
                                    drec, scale, heads)
        want = kb.bank_attention_bwd_split_plain(q, bk, bv, cnt, dout, lse_h,
                                                 delta_h, drec, scale)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kb.bank_attention_bwd_split.launches == before


def test_split_route_by_head_shape():
    """The backward's route by head shape: one or two heads of 128 with
    values a multiple of 256 a head to the split kernels (K2 at one head
    with 1024, K2×2 at two with 512), two heads of 128 with values 128 a
    head to the fused pair, 8 heads of 32 to K2ʰ; any other shape
    raises."""
    for shape in ((1, 128, 1024), (2, 128, 512), (1, 128, 256),
                  (2, 128, 1024)):
        assert kb.bwd_route(*shape) == "split"
    assert kb.bwd_route(2, 128, 128) == "fused"
    assert kb.bwd_route(8, 32, 32) == "heads"
    for shape in ((1, 128, 128), (2, 128, 384), (2, 64, 512)):
        with pytest.raises(ValueError, match="heads of width"):
            kb.bwd_route(*shape)


def test_split_form_constants_match_the_source():
    """The plain form's value group, dq slot group and widest head are the
    source's NV, G and MAX_DV (the wrapper also checks the first two
    against the library when it loads it), and the source exports no p/ds
    scratch stage."""
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("NV") == kb.SPLIT_DV_COLUMNS
    assert const("G") == kb.SPLIT_DQ_SLOTS
    assert const("MAX_DV") == kb.SPLIT_MAX_VALUES
    assert "rmem_bank_attention_bwd_ds" not in text
    assert all(f"rmem_bank_attention_bwd_split_{stage}(" in text
               for stage in ("dq", "dk", "dv"))
