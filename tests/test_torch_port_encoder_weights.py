"""Reference .pth files of the other encoder families through the port's
converter and `load_model_params`, against the JAX package's converter and
merge, on the CPU: MobileNetV2 (aotl), MobileNetV3 (aotl_v3), ResNeSt-101
(rs101_aotl), Swin-B (swinb_aotl) and the top-down ResNet-50
(r50_topdown_aotl).

Each file is fabricated from the JAX model's parameter shapes
(jax.eval_shape: no compute): the encoder by the family's fabricator of
tests/test_checkpoint.py (reference names and layouts, BN running
statistics with a positive variance, transposed convs [in, out, kh, kw]),
the rest by `_fabricate_torch_sd`, then given the reference's wrapping
(`module.` prefixes under `state_dict`, the id bank's 11 input channels, a
dead TIME_ENCODE key). Both sides must give the same weights bit for bit
and the same skipped, extra, dead and unexpected lists."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_checkpoint import (_fabricate_encoder_sd, _fabricate_mnv3_sd,
                             _fabricate_resnest_sd, _fabricate_topdown_sd,
                             _fabricate_torch_sd)

from rmem_tpu.config import get_config as jget_config
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_forward
from rmem_tpu.utils import checkpoint as jckpt
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.models import build_vos_model, load_model_params
from rmem_tpu_torch.utils.checkpoint import flax_path, params_from_jax

DEAD_KEY = "LSTT.layers.0.Q_time_encode.0.weight"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores, and
    PyTorch's default of one thread per visible CPU makes each of them
    wait on the others many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# each family: its model preset, its encoder fabricator and the side of the
# image its init runs on (the parameters do not depend on it, but the model
# must run there: the top-down encoder's decoders need a side 1 past a
# multiple of 16, and Swin one that is not 1-3 past it, ROADMAP Queue 3)
FAMILIES = {
    "mobilenetv2": ("aotl", lambda flat, rng: _fabricate_encoder_sd(
        flat, "mobilenetv2"), 33),
    "mobilenetv3": ("aotl_v3", _fabricate_mnv3_sd, 33),
    "resnest": ("rs101_aotl", _fabricate_resnest_sd, 33),
    "swin": ("swinb_aotl", lambda flat, rng: _fabricate_encoder_sd(
        flat, "swin"), 48),
    "topdown": ("r50_topdown_aotl", _fabricate_topdown_sd, 33),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_pth_of_each_family_loads_as_jax_loads_it(family, tmp_path):
    """The same leaves bit for bit (unskipped ones), and the same skipped,
    extra, dead and unexpected lists. Nothing is skipped or unexpected but
    for ResNeSt-101: both converters read the stages at ResNet-50's depth
    (6 blocks in stage 3), so its blocks 6-22 are skipped (keeping the
    init) and their keys unexpected, on both sides alike (ROADMAP Queue
    3)."""
    model_name, fabricate, side = FAMILIES[family]
    cfg = jget_config("pre_vost", model=model_name, compute_dtype="float32")
    jm = jbuild(cfg.model_vos, cfg)
    hw = (side, side)
    shapes = jax.eval_shape(lambda r: jm.init(
        r, jnp.zeros((1, *hw, 3)), jnp.zeros((1, *hw, cfg.id_channels)),
        method=init_forward), jax.random.PRNGKey(0))["params"]
    jparams = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    flat = dict(_flat(jparams))
    sd = _fabricate_torch_sd({k: v for k, v in flat.items()
                              if k[0] != "encoder"}, cfg.model_vos)
    sd.update(fabricate({k: v for k, v in flat.items()
                         if k[0] == "encoder"}, np.random.RandomState(7)))
    sd["patch_wise_id_bank.weight"] = sd["patch_wise_id_bank.weight"][:, :11]
    sd[DEAD_KEY] = np.ones((4, 4), np.float32)
    path = str(tmp_path / f"{family}.pth")
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(
        np.ascontiguousarray(v)) for k, v in sd.items()}}, path)

    jtree, jskipped, jextra = jckpt.load_pretrained(
        jparams, path, cfg.model_vos, cfg.id_channels)
    jrep = {}       # the JAX converter's report on the same state dict
    jckpt.convert_torch_checkpoint(sd, cfg.model_vos, cfg.model_lstt_num,
                                   cfg.id_channels, report=jrep)
    model = build_vos_model(cfg.model_vos, get_config("pre_vost",
                                                      model=model_name))
    rep, lines = {}, []
    load_model_params(model, path, report=rep, log=lines.append)

    assert sorted(rep["skipped"]) == sorted(jskipped)
    assert sorted(rep["extra"]) == sorted(jextra) == []
    assert rep["dead_keys"] == jrep["dead_keys"] == [DEAD_KEY]
    assert rep["unexpected_keys"] == jrep["unexpected_keys"]
    if family == "resnest":
        deep = {f"layer3_{i}" for i in range(6, 23)}
        assert jskipped and {s[1][1] for s in jskipped} == deep
        assert all(s[0] == "missing" for s in jskipped)
        assert {k.split(".")[2] for k in jrep["unexpected_keys"]} == {
            str(i) for i in range(6, 23)}
    else:
        assert jskipped == [] and jrep["unexpected_keys"] == []
    skipped = {s[1] for s in jskipped}
    ref = params_from_jax(jtree)
    got = model.state_dict()
    assert sorted(got) == sorted(ref)
    for name, t in got.items():
        if flax_path(name) not in skipped:
            assert torch.equal(t, ref[name]), name
    bank = got["patch_wise_id_bank.weight"]               # OIHW, 12 in
    assert bank.shape[1] == 12 and not bank[:, 11].any()
