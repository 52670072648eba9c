"""The plain forms of the two kernels redesigned for their shape, against
the JAX package on the CPU: K8 (the gated depthwise conv, a band of rows
streamed with a window of output rows in registers), whose plain version
must give the Pallas kernel's bits, and K1×2ᵛ¹²⁸ (AOT no_memory_gap's
serving bank attention), whose tile walk over the valid (slot, chunk)
pairs is cut into a cluster's ranges and merged; the cluster size the
launcher picks. The CUDA kernels themselves are held to these on the card
by chip_smoke.py."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from rmem_tpu.kernels.bank_attention import pallas_bank_attention_infer
from rmem_tpu_torch.kernels import bank_attention as kb
from rmem_tpu_torch.kernels import dwconv as kd

REPO = Path(__file__).resolve().parents[1]
# f32 on both sides; the split walk sums in another order than Pallas (each
# range's softmax state merged after): a few f32 ulps of O(1) values
FWD_TOL = 1e-5


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
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, ref, rel):
    """max |got - ref| <= rel * max |ref|, shapes equal."""
    got = got.detach().float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


# ---- K8: the plain version gives the Pallas kernel's bits ----------------

# (B, H, W, C): rows not a multiple of the kernel's 8-row bands at batch 2
# with 128 channels, fewer rows than a band, and rows narrower than the
# 5-wide window
K8_GRIDS = {"b2_13x21_c128": (2, 13, 21, 128), "b1_5x9_c32": (1, 5, 9, 32),
            "b1_7x3_c32": (1, 7, 3, 32)}

# Pallas in interpret mode, as the JAX package's tests run it, on bf16
# inputs made from numpy seeds. XLA on the CPU may keep a bf16 product in
# f32 before the next op (its excess-precision rule; ~40 % of the outputs
# then move by one bf16 rounding), so this runs with the rule off, which
# must be set before the backend starts: in a process of its own.
_K8_PALLAS = """
import sys
import numpy as np
import jax.numpy as jnp
from rmem_tpu.kernels.dwconv import pallas_gated_dwconv
out = {}
for key, (b, h, w, c) in eval(sys.argv[1]).items():
    rng = np.random.RandomState(b * 1000 + h * 10 + w)
    x = rng.randn(b, h, w, c).astype(np.float32)
    g = rng.randn(b, h, w, c).astype(np.float32)
    k = (rng.randn(5, 5, 1, c) * 0.2).astype(np.float32)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    y = pallas_gated_dwconv(bf(x), bf(g), bf(k), interpret=True)
    out[key] = np.asarray(y.astype(jnp.float32))
    out[key + "_in"] = np.stack([x, g])
    out[key + "_k"] = k
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def k8_pallas(tmp_path_factory):
    path = tmp_path_factory.mktemp("k8") / "pallas.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _K8_PALLAS, repr(K8_GRIDS),
                        str(path)], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("key", list(K8_GRIDS))
def test_k8_plain_matches_pallas_bit_for_bit(k8_pallas, key):
    """K8's plain version (x * gate rounded to bf16, each tap's product
    rounded to bf16, the 25 taps summed in f32 in the order dy then dx, the
    sum rounded) gives pallas_gated_dwconv's bf16 bits on grids the band
    split makes awkward; the wrapper launches nothing on the CPU."""
    b, h, w, c = K8_GRIDS[key]
    x, g = k8_pallas[key + "_in"]
    k = k8_pallas[key + "_k"]
    weight = _t(k).permute(3, 2, 0, 1).contiguous().bfloat16()
    before = kd.gated_dwconv.launches
    out = kd.gated_dwconv(_t(x).reshape(b, h * w, c).bfloat16(),
                          _t(g).reshape(b, h * w, c).bfloat16(), weight,
                          (h, w))
    ref = torch.from_numpy(k8_pallas[key]).reshape(b, h * w, c)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.float(), ref)
    assert kd.gated_dwconv.launches == before


# ---- K1×2ᵛ¹²⁸: the tile walk cut into a cluster's ranges -----------------

@pytest.mark.parametrize("count,lk,true_lk,bias", [
    # one slot of two chunks: at clusters of 3 and 4 some ranks are empty
    pytest.param(1, 70, 70, False, id="one-slot-no-bias"),
    # 3 of 4 slots, keys padded 10 past true_lk (a masked last chunk of 12
    # keys): the cuts fall inside slots
    pytest.param(3, 150, 140, True, id="three-slots-padded"),
    # every slot valid, 3 chunks a slot
    pytest.param(4, 130, 130, True, id="all-slots")])
def test_k1v128_split_walk_matches_pallas_infer(count, lk, true_lk, bias):
    """K1×2ᵛ¹²⁸'s form (`bank_attention_infer_v128_plain`: each range's
    maximum, sum, per-slot sums booked when its walk leaves a slot, and
    output, merged as the cluster merges) at clusters of 1 to 4 against
    pallas_bank_attention_infer (interpret mode) at 2 heads of 128 with
    values 128 a head: the output, the head mean of the slot mass, and 0
    past count."""
    rng = np.random.RandomState(160 + count)
    s, b, lq = 4, 1, 40
    q = _rand(rng, b, lq, 256) * 0.5
    bk, bv = _rand(rng, s, b, lk, 256) * 0.5, _rand(rng, s, b, lk, 256)
    qbias = _rand(rng, b, 2, lq, s) if bias else None
    scale = 128 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref, rrec = pallas_bank_attention_infer(
            *map(jnp.asarray, (q, bk, bv)), jnp.int32(count), 2,
            scale=scale, true_lk=true_lk,
            qbias=None if qbias is None else jnp.asarray(
                qbias.reshape(b * 2, lq, s)))
    cnt = torch.tensor(count, dtype=torch.int32)
    for cl in (1, 2, 3, 4):
        out, rec_h = kb.bank_attention_infer_v128_plain(
            _t(q), _t(bk), _t(bv), cnt, scale, true_lk,
            None if qbias is None else _t(qbias), cluster=cl)
        _close(out, ref, FWD_TOL)
        _close(rec_h.mean(dim=1), rrec, FWD_TOL)
        assert torch.all(rec_h[..., count:] == 0)


def test_k1v128_ranges_cut_the_walk():
    """The ranges a cluster's blocks take: even cuts of the tile's n valid
    (slot, chunk) pairs in order, covering each pair once; a block whose
    range is empty books nothing, and the merge still gives the whole
    softmax (one slot of one chunk over a cluster of 4)."""
    assert kb.v128_ranges(243, 4) == [(0, 60), (60, 121), (121, 182),
                                      (182, 243)]
    assert kb.v128_ranges(2, 4) == [(0, 0), (0, 1), (1, 1), (1, 2)]
    for n in (1, 7, 27, 243):
        for cl in (1, 2, 3, 4, 8):
            cuts = kb.v128_ranges(n, cl)
            assert cuts[0][0] == 0 and cuts[-1][1] == n
            assert all(a[1] == c[0] for a, c in zip(cuts, cuts[1:]))
    rng = np.random.RandomState(7)
    q, bk, bv = (_t(_rand(rng, *shape)) for shape in
                 ((1, 30, 256), (2, 1, 20, 256), (2, 1, 20, 256)))
    cnt = torch.tensor(1, dtype=torch.int32)
    out, rec_h = kb.bank_attention_infer_v128_plain(q, bk, bv, cnt, 0.1,
                                                    cluster=4)
    whole, rec = kb.bank_attention_plain(q, bk, bv, cnt, 2, 0.1)
    _close(out, whole, 1e-6)
    _close(rec_h.mean(dim=1), rec, 1e-6)


def test_v128_cluster_is_one_wave():
    """The launcher's cluster size, a pure function of the units (128-query
    tiles × batch × 2 heads) and the SMs: the most blocks a cluster, up to
    4, that keep the grid one wave on 132 SMs at one block an SM. Phase
    17's call (batch 1, Lq 1674: 28 units) takes 4 (112 blocks), batch 2
    takes 2 (112); clusters the card cannot hold at once take a smaller
    size; more units than SMs take 1."""
    units = lambda b, lq: -(-lq // kb.V128_TILE) * b * 2
    assert (units(1, 1674), units(2, 1674)) == (28, 56)
    assert kb.V128_MAX_CLUSTER == 4
    assert kb.v128_cluster(28, 132) == 4 and 28 * 4 <= 132
    assert kb.v128_cluster(56, 132) == 2 and 56 * 2 <= 132
    assert kb.v128_cluster(44, 132) == 3
    assert kb.v128_cluster(200, 132) == 1
    assert kb.v128_cluster(28, 132, lambda cl: 32 if cl < 4 else 24) == 3
    assert kb.v128_cluster(56, 132, lambda cl: 40) == 1


def test_k1v128_route_and_cpu_path():
    """2 heads of 128 with values 128 a head stays an inference "slots"
    shape (`_slots_call` sends it to K1×2ᵛ¹²⁸ on the card); on the CPU the
    wrapper takes the plain version and counts no launch."""
    assert kb.infer_route(*kb.NARROW_VALUES) == "slots"
    rng = np.random.RandomState(8)
    q, bk, bv = (_t(_rand(rng, *shape)) for shape in
                 ((1, 20, 256), (3, 1, 40, 256), (3, 1, 40, 256)))
    cnt = torch.tensor(2, dtype=torch.int32)
    before = kb.bank_attention_infer.launches
    got = kb.bank_attention_infer(q, bk, bv, cnt, 2, 0.1, 30)
    want = kb.bank_attention_plain(q, bk, bv, cnt, 2, 0.1, 30)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert kb.bank_attention_infer.launches == before
    form = kb.bank_attention_infer_v128_plain(q, bk, bv, cnt, 0.1, 30,
                                              cluster=2)
    _close(form[0], want[0], 1e-6)
    _close(form[1].mean(dim=1), want[1], 1e-6)
