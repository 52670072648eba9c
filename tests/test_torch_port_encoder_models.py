"""The models on the other encoders in the port against the JAX package,
f32 on the CPU: every model preset field by field at every stage the port
has, the encoder registry, the Swin grid at sizes the id bank does not
share, and an aott engine (MobileNetV2 + one LSTT layer) teacher-forced
through an eviction, with the same weights (params_from_jax) on the same
inputs made from numpy seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_encoders import _draw

from rmem_tpu import config as jconfig
from rmem_tpu.config import get_config as jget_config
from rmem_tpu.engine import InferenceEngine as JEngine
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_forward
from rmem_tpu.models.encoders import build_encoder as jbuild_encoder
from rmem_tpu.ops.resize import resize_bilinear as jresize_bilinear
from rmem_tpu.ops.resize import resize_nearest as jresize_nearest
from rmem_tpu.ops.resize import upsample_argmax as jupsample_argmax
from rmem_tpu_torch import config as port_config
from rmem_tpu_torch.config import Config, get_config
from rmem_tpu_torch.engine import InferenceEngine
from rmem_tpu_torch.models import build_vos_model
from rmem_tpu_torch.models.encoders import ENCODERS, build_encoder
from rmem_tpu_torch.ops.resize import upsample_argmax
from rmem_tpu_torch.utils import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEW_MODELS = ("aott", "aots", "aotb", "aotl", "deaott", "aotl_v3",
              "r101_aotl", "rs101_aotl", "swinb_aotl", "r50_topdown_aotl")
# every encoder name the JAX package's build_encoder takes
JAX_ENCODERS = ("resnet50", "resnet101", "mobilenetv2", "tiny",
                "tiny_topdown", "swin_base", "swinb", "mobilenetv3",
                "resnest50", "resnest101", "resnet50_topdown")
# f32 on both sides: MobileNetV2, one LSTT layer and the FPN, summed in
# another order (XLA vs ATen)
LOGIT_TOL = 1e-4
# labels may differ only where the top-2 upsampled logits are this close
TIE_EPS = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores, and
    PyTorch's default of one thread per visible CPU makes each of them
    wait on the others many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("stage", sorted(port_config.STAGE_PRESETS))
def test_presets_match_jax(stage):
    """Every field of the port's Config reads as in rmem_tpu's for each new
    model preset, with and without no_memory_gap; the port has every JAX
    model preset; only `resnet50` takes the R50_ prefix, and the fixed
    R101_AOTL names stay (ResNeSt-101's too)."""
    assert set(port_config.MODEL_PRESETS) == set(jconfig.MODEL_PRESETS)
    for model in NEW_MODELS:
        for nmg in (False, True):
            port = get_config(stage, model=model, no_memory_gap=nmg)
            ref = jget_config(stage, model=model, no_memory_gap=nmg)
            for f in dataclasses.fields(port):
                assert getattr(port, f.name) == getattr(ref, f.name), (
                    model, nmg, f.name)
    names = {m: get_config(stage, model=m).model_name for m in NEW_MODELS}
    assert names["aotl"] == "AOTL_Temp_pe_Slot_4"
    assert names["deaott"] == "DeAOTL_Temp_pe_Slot_4"
    assert names["r101_aotl"] == names["rs101_aotl"] == "R101_AOTL"
    assert get_config(stage, model="r50_topdown_aotl").var_loss_weight \
        == 0.01


def test_build_encoder_takes_every_jax_name():
    """Each name the JAX registry builds, the port builds, as the same
    family (the same class name, the same stage depths; the parameters
    themselves are held in test_torch_port_encoders.py and
    test_torch_port_encoder_parts.py). An unknown name raises on both
    sides, the port's message listing what it has. The default Config
    (MobileNetV2) builds."""
    assert set(ENCODERS) == set(JAX_ENCODERS)
    for name in JAX_ENCODERS:
        jenc = jbuild_encoder(name)
        with torch.device("meta"):     # the structure alone: no init
            enc = build_encoder(name)
        assert type(enc).__name__ == type(jenc).__name__, name
        if hasattr(jenc, "layers"):   # ResNet, ResNeSt: blocks a stage
            assert [len(s) for s in enc.stages] == list(jenc.layers[:3])
    with pytest.raises(NotImplementedError):
        jbuild_encoder("vgg")
    with pytest.raises(NotImplementedError, match="mobilenetv2"):
        build_encoder("vgg")
    assert Config().model_encoder == "mobilenetv2"
    model = build_vos_model("aot", Config())
    assert type(model.encoder).__name__ == "MobileNetV2"


def test_swin_grid_against_the_id_bank():
    """Swin's VALID 4x4 patch embed: at 481 x 849 (the evaluator's size)
    its 16x grid is 30 x 53 where the id bank's is 31 x 54, in both
    packages (jax.eval_shape of each module), so neither engine can serve
    it there; at 480 x 848 both are 30 x 53 (1590 tokens). The port's
    engine names the mismatch."""
    def jax_grids(h, w):
        cfg = jget_config("pre_vost", model="swinb_aotl",
                          compute_dtype="float32")
        enc = jbuild_encoder("swin_base")
        img = jnp.zeros((1, h, w, 3))
        pyr = jax.eval_shape(lambda: enc.init_with_output(
            jax.random.PRNGKey(0), img)[0])
        k = 17 if cfg.model_align_corners else 16
        id_h, id_w = (h + 16 - k) // 16 + 1, (w + 16 - k) // 16 + 1
        return tuple(pyr[-1].shape[1:3]), (id_h, id_w)

    assert jax_grids(481, 849) == ((30, 53), (31, 54))
    assert jax_grids(480, 848) == ((30, 53), (30, 53))

    # tiny_aotl's grid at 65 x 65 is 5 x 5, the id bank's too; a Swin-like
    # 4 x 4 one by a stand-in encode that drops a row and a column
    cfg = get_config("pre_vost", model="tiny_aotl", compute_dtype="float32")
    engine = InferenceEngine(build_vos_model("aot", cfg), cfg, device="cpu")
    encode = engine.model.encode_image
    engine.model.encode_image = lambda img: tuple(
        x[..., :-1, :-1] for x in encode(img))
    img = np.zeros((1, 65, 65, 3), np.float32)
    mask = np.zeros((1, 65, 65), np.int32)
    with pytest.raises(ValueError, match="4x4 grid"):
        engine.add_reference(img, mask, [1])


HW = (65, 65)
OUT_HW = (60, 70)
FRAMES = 5


def test_aott_engine_matches_jax_teacher_forced():
    """aott (MobileNetV2, one LSTT layer of 8 heads of 32) at 65 x 65 with
    1 + 1 slots and a long-term write every 2 frames: the bank fills on
    frame 2 and evicts on frame 4. Both engines share the weights (drawn as
    the encoder tests draw them, offset by 0.05 N(0, 1) on every leaf, so
    the BN affines and biases take part) and are teacher-forced with the
    JAX labels. Per frame:
    logits within LOGIT_TOL of scale, labels equal except at near ties,
    and the bank's count and contents as the JAX bank's."""
    over = dict(compute_dtype="float32", former_mem_len=1, latter_mem_len=1)
    jcfg = jget_config("pre_vost", model="aott", **over)
    jmodel = jbuild(jcfg.model_vos, jcfg)
    params = _draw(jax.eval_shape(lambda r: jmodel.init(
        r, jnp.zeros((1, *HW, 3)), jnp.zeros((1, *HW, jcfg.id_channels)),
        method=init_forward), jax.random.PRNGKey(0))["params"],
        np.random.RandomState(1), amount=0.05)
    jeng = JEngine(jmodel, params, jcfg, donate=False)
    model = build_vos_model("aot", get_config("pre_vost", model="aott",
                                              **over))
    model.load_state_dict(params_from_jax(params), strict=True)
    peng = InferenceEngine(model, model.cfg, device="cpu")

    rng = np.random.RandomState(0)
    imgs = rng.rand(FRAMES + 1, 1, *HW, 3).astype(np.float32)
    mask = np.zeros((1, *HW), np.int32)
    mask[:, 8:30, 6:28] = 1
    mask[:, 36:60, 30:58] = 2
    mask[:, 0:4, 0:64] = 255          # an ignore band
    js, jlog = jeng.add_reference(jnp.asarray(imgs[0]), jnp.asarray(mask),
                                  [2], gap=2)
    ps, plog = peng.add_reference(imgs[0], mask, [2], gap=2)
    assert ps.short_k.shape[2] == 25          # the 5 x 5 grid
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL * np.abs(jlog).max(), rtol=0)
    counts = []
    for t in range(1, FRAMES + 1):
        js, jlog = jeng.propagate(js, jnp.asarray(imgs[t]))
        ps, plog = peng.propagate(ps, imgs[t])
        err = np.abs(plog.numpy() - np.asarray(jlog)).max()
        assert err <= LOGIT_TOL * np.abs(np.asarray(jlog)).max(), (t, err)
        lab_j = np.asarray(jupsample_argmax(jlog, OUT_HW))
        lab_p = upsample_argmax(plog, OUT_HW).numpy()
        up = np.asarray(jresize_bilinear(jlog, OUT_HW))[0]
        top2 = np.sort(up, axis=-1)[..., -2:]
        assert np.all((lab_p == lab_j) | (top2[..., 1] - top2[..., 0]
                                          < TIE_EPS))
        lab_in = np.array(jresize_nearest(jnp.asarray(lab_j)[None, ..., None],
                                          HW))[..., 0]
        js = jeng.update_memory(js, jnp.asarray(lab_in))
        ps = peng.update_memory(ps, lab_in)
        assert int(ps.bank.count) == int(js.bank.count)
        np.testing.assert_array_equal(ps.bank.order.numpy(),
                                      np.asarray(js.bank.order))
        for a, b in ((ps.bank.k, js.bank.k), (ps.bank.v, js.bank.v)):
            np.testing.assert_allclose(
                a.numpy(), np.asarray(b),
                atol=LOGIT_TOL * np.abs(np.asarray(b)).max(), rtol=0)
        counts.append(int(ps.bank.count))
    assert counts == [1, 2, 2, 2, 2]
