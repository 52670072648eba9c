"""The plain version of each CUDA kernel against the JAX kernel it replaces
(Pallas in interpret mode on the CPU, or the JAX plain chain), and the
CPU-side rules of the kernel modules: a CPU tensor takes the plain version,
modules import without nvcc, and nothing is built until a card asks."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from rmem_tpu.kernels.bank_attention import (pallas_bank_attention,
                                             pallas_bank_attention_infer)
from rmem_tpu.kernels.local_attention import pallas_local_attention
from rmem_tpu.kernels.stem import pallas_stem, xla_stem_chain
from rmem_tpu_torch.kernels import bank_attention as kbank
from rmem_tpu_torch.kernels import build
from rmem_tpu_torch.kernels import local_attention as klocal
from rmem_tpu_torch.kernels import stem as kstem

REPO = Path(__file__).resolve().parents[1]

# f32 on both sides; the Pallas kernels sum in another order (online
# softmax over key tiles), so agreement is to a few f32 ulps of O(1) values
TOL = dict(rtol=2e-5, atol=2e-5)


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


@pytest.mark.parametrize("heads,count,true_lk,b,lk,dv", [
    pytest.param(1, 3, 40, 1, 48, 64, id="1-3-40"),
    pytest.param(2, 4, 48, 1, 48, 64, id="2-4-48"),
    # two id groups; one slot, and keys padded 72 past true_lk (more than
    # the kernel's 64-key chunk, so a chunk lies wholly in the padding)
    pytest.param(1, 1, 40, 2, 112, 64, id="b2-count1-padded"),
    # two id groups, every slot valid
    pytest.param(1, 5, 48, 2, 48, 64, id="b2-full"),
    # AOT's 8 heads of 32 (K1h's shape): partial slots with keys padded 13
    # past true_lk; two id groups
    pytest.param(8, 3, 43, 1, 56, 32, id="h8-3-43-padded"),
    pytest.param(8, 4, 48, 2, 48, 32, id="h8-b2")])
def test_bank_attention_plain_matches_pallas_infer(heads, count, true_lk, b,
                                                   lk, dv):
    """Partial, single and full slot counts, key padding past true_lk, the
    per-(query, slot) bias and two id groups, at one, two and eight heads,
    against pallas_bank_attention_infer."""
    rng = np.random.RandomState(0)
    s, lq, dh = 5, 40, 32
    q = _rand(rng, b, lq, heads * dh)
    bk = _rand(rng, s, b, lk, heads * dh)
    bv = _rand(rng, s, b, lk, heads * dv)
    bias = _rand(rng, b, heads, lq, s)
    scale = dh ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref, rrec = pallas_bank_attention_infer(
            jnp.asarray(q), jnp.asarray(bk), jnp.asarray(bv),
            jnp.int32(count), heads, scale=scale, true_lk=true_lk,
            qbias=jnp.asarray(bias.reshape(b * heads, lq, s)))
    out, rec = kbank.bank_attention_plain(
        _t(q), _t(bk), _t(bv), torch.tensor(count, dtype=torch.int32), heads,
        scale, true_lk=true_lk, qbias=_t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rrec), **TOL)
    assert np.all(rec.numpy()[..., count:] == 0.0)


def test_bank_attention_plain_matches_pallas_self_memory():
    """The reference frame's call: one slot, no bias, no padding."""
    rng = np.random.RandomState(1)
    q, bk = _rand(rng, 1, 50, 32), _rand(rng, 1, 1, 50, 32)
    bv = _rand(rng, 1, 1, 50, 64)
    with pltpu.force_tpu_interpret_mode():
        ref, _ = pallas_bank_attention(jnp.asarray(q), jnp.asarray(bk),
                                       jnp.asarray(bv), jnp.int32(1), 1)
    out, rec = kbank.bank_attention_infer(
        _t(q), _t(bk), _t(bv), torch.ones((), dtype=torch.int32), 1,
        32 ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(rec.numpy(), 1.0, atol=1e-6)


def test_bank_attention_plain_matches_pallas_self_memory_8_heads():
    """The reference frame's call at AOT's 8 heads of 32: one slot, no
    bias, no padding; the head-mean slot mass is 1."""
    rng = np.random.RandomState(5)
    q, bk = _rand(rng, 1, 50, 256), _rand(rng, 1, 1, 50, 256)
    bv = _rand(rng, 1, 1, 50, 256)
    with pltpu.force_tpu_interpret_mode():
        ref, rrec = pallas_bank_attention(jnp.asarray(q), jnp.asarray(bk),
                                          jnp.asarray(bv), jnp.int32(1), 8)
    out, rec = kbank.bank_attention_infer(
        _t(q), _t(bk), _t(bv), torch.ones((), dtype=torch.int32), 8,
        32 ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rrec), **TOL)
    np.testing.assert_allclose(rec.numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("size,b", [
    pytest.param((4, 4), 1, id="size0"),
    pytest.param((11, 17), 1, id="size1"),
    # two id groups on a ragged grid (not a multiple of the kernel's 8 x 8
    # tile on either side) whose windows cross every edge
    pytest.param((13, 21), 2, id="b2-13x21")])
def test_local_attention_plain_matches_pallas(size, b):
    """A grid smaller than the 15x15 window (the window shrinks to the grid
    and the relative table is cropped on the JAX side), one larger, and a
    ragged one at batch 2."""
    rng = np.random.RandomState(2)
    hw = size[0] * size[1]
    q, k = _rand(rng, b, hw, 32), _rand(rng, b, hw, 32)
    v, rel = _rand(rng, b, hw, 64), _rand(rng, b, hw, 225)
    ref = pallas_local_attention(*map(jnp.asarray, (q, k, v, rel)), size, 1,
                                 max_dis=7, interpret=True)
    out = klocal.local_attention(_t(q), _t(k), _t(v), _t(rel), size, 1, 7,
                                 32 ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("hw,with_pallas", [((33, 47), True),
                                             ((29, 30), False)])
def test_stem_plain_matches_jax_chain(hw, with_pallas):
    """bf16 on both sides, as the JAX chain is bf16: the conv sums in f32 in
    another order, so the bf16-rounded results may differ by one bf16 ulp
    (2^-8 relative). The Pallas kernel (interpret mode, slow) is checked at
    one size; xla_stem_chain, which it matches, at both."""
    rng = np.random.RandomState(3)
    x = _rand(rng, 1, *hw, 3)
    w = _rand(rng, 7, 7, 3, 64) * 0.2
    scale, bias = 1.0 + 0.1 * _rand(rng, 64), 0.1 * _rand(rng, 64)
    args = tuple(map(jnp.asarray, (x, w, scale, bias)))
    refs = [np.asarray(xla_stem_chain(*args).astype(jnp.float32))]
    if with_pallas:
        with pltpu.force_tpu_interpret_mode():
            refs.append(np.asarray(pallas_stem(*args, interpret=True)
                                   .astype(jnp.float32)))
    w_oihw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    out = kstem.stem(_t(x), w_oihw.to(torch.bfloat16), _t(scale), _t(bias))
    assert out.dtype == torch.bfloat16 and out.shape == refs[0].shape
    for r in refs:
        np.testing.assert_allclose(out.float().numpy(), r, rtol=2 ** -7,
                                   atol=1e-6)


def test_wrappers_on_cpu_take_the_plain_version_and_count_nothing():
    rng = np.random.RandomState(4)
    before = (kbank.bank_attention_infer.launches,
              klocal.local_attention.launches, kstem.stem.launches)
    q = _t(_rand(rng, 1, 16, 64))
    k = _t(_rand(rng, 2, 1, 16, 64))
    v = _t(_rand(rng, 2, 1, 16, 256))
    cnt = torch.tensor(2, dtype=torch.int32)
    a = kbank.bank_attention_infer(q, k, v, cnt, 1, 0.125)
    b = kbank.bank_attention_plain(q, k, v, cnt, 1, 0.125)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    rel = _t(_rand(rng, 1, 16, 225))
    assert torch.equal(
        klocal.local_attention(q, q, v[0], rel, (4, 4), 1, 7, 0.125),
        klocal.local_attention_plain(q, q, v[0], rel, (4, 4), 1, 7, 0.125))
    x, w = _t(_rand(rng, 1, 20, 20, 3)), _t(_rand(rng, 64, 3, 7, 7))
    s1, b0 = torch.ones(64), torch.zeros(64)
    assert torch.equal(kstem.stem(x, w, s1, b0),
                       kstem.stem_plain(x, w, s1, b0))
    after = (kbank.bank_attention_infer.launches,
             klocal.local_attention.launches, kstem.stem.launches)
    assert after == before


def test_kernel_modules_import_without_nvcc_and_build_lazily(tmp_path):
    """With no nvcc reachable the kernel modules still import, nothing is
    built or loaded, and asking for a library raises instead."""
    code = (
        "import sys\n"
        "from rmem_tpu_torch.kernels import build, bank_attention, "
        "local_attention, stem\n"
        "import rmem_tpu_torch.engine\n"
        "assert build._loaded == {}\n"
        "try:\n"
        "    build._nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n"
        "else:\n"
        "    sys.exit('nvcc found')\n")
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc at /usr/local/cuda")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = str(tmp_path)
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "raised nvcc not found" in r.stdout
    assert set(build.KERNELS) == {p.stem for p in build.CSRC.glob("*.cu")}
