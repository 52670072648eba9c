"""The single-video tools against the JAX package on the CPU: the demo
(masks and overlay JPEGs) on one set of weights, the demo against the
port's own evaluator on its per-frame path, the comparison video, and the
CLIs' flags.

`tiny_deaotl`, `test` stage, f32 on both sides, 112 x 176 frames: on a
grid under 8 cells on its short side that is not square the JAX local
attention clamps its window (ROADMAP Queue 3) and the two packages part.
The JAX demo has no flag for the activations' dtype, so its config is made
f32 here by wrapping `rmem_tpu.config.get_config`, which it imports when
it runs."""

import argparse
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rmem_tpu import config as jconfig
from rmem_tpu.config import get_config as jget_config
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_params as jinit
from rmem_tpu.tools import demo as jdemo
from rmem_tpu.tools import video as jvideo
from rmem_tpu.utils.checkpoint import save_pytree
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.managers.evaluator import Evaluator
from rmem_tpu_torch.models import build_vos_model, init_params
from rmem_tpu_torch.tools import demo
from rmem_tpu_torch.tools import video
from rmem_tpu_torch.utils.image import (encode_png_pal8, label_colormap,
                                        read_png)

cv2 = pytest.importorskip("cv2")

HW = (112, 176)
FRAMES = 4
# as many objects as the model has ids: the evaluator writes an id past a
# video's objects (a ghost identity's) as 0, the demo as it is
OBJECTS = 10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores, and
    PyTorch's default of one thread per visible CPU makes each of them
    wait on the others many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _frame(t, h, w):
    """A smooth background with a bright blob that moves with t."""
    rng = np.random.RandomState(100 + t)
    low = rng.rand(h // 8, w // 8, 3).astype(np.float32)
    img = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    blob = np.exp(-(((yy - h * (0.4 + 0.02 * t)) / (0.2 * h)) ** 2
                    + ((xx - w * (0.3 + 0.03 * t)) / (0.2 * w)) ** 2))
    return np.clip((img * 0.5 + 0.4 * blob[..., None]) * 255, 0,
                   255).astype(np.uint8)


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """A VOST tree of one video (JPEG frames, the first annotation with
    OBJECTS objects), which is also the demo's frames directory and first
    mask."""
    root = tmp_path_factory.mktemp("tools") / "data" / "VOST"
    frames = root / "JPEGImages_10fps" / "vid"
    ann = root / "Annotations" / "vid"
    frames.mkdir(parents=True)
    ann.mkdir(parents=True)
    (root / "ImageSets").mkdir()
    (root / "ImageSets" / "val.txt").write_text("vid\n")
    for t in range(FRAMES):
        cv2.imwrite(str(frames / f"{t:05d}.jpg"), _frame(t, *HW)[:, :, ::-1])
    lab = np.zeros(HW, np.uint8)
    for i in range(OBJECTS):          # 2 rows of 5 boxes
        y, x = 15 + 45 * (i // 5), 8 + 34 * (i % 5)
        lab[y:y + 35, x:x + 26] = i + 1
    (ann / "00000.png").write_bytes(encode_png_pal8(lab, label_colormap()))
    return root, frames, ann / "00000.png"


def _f32_jax_config(monkeypatch):
    real = jconfig.get_config
    monkeypatch.setattr(jconfig, "get_config", lambda *a, **kw: real(
        *a, **{**kw, "compute_dtype": "float32"}))


def _port_demo(frames, first, out, *extra):
    demo.main(["--model", "tiny_deaotl", "--stage", "test", "--device",
               "cpu", "--frames_dir", str(frames), "--first_mask",
               str(first), "--output_dir", str(out), *extra])


def test_demo_matches_jax_demo(video_dir, tmp_path, monkeypatch):
    """One msgpack of weights that JAX wrote, read by both demos: every
    mask equal on every pixel, every overlay JPEG byte for byte."""
    _, frames, first = video_dir
    jcfg = jget_config("test", model="tiny_deaotl")
    weights = str(tmp_path / "w.msgpack")
    save_pytree(jinit(jbuild(jcfg.model_vos, jcfg), jax.random.PRNGKey(3)),
                weights)
    _f32_jax_config(monkeypatch)
    monkeypatch.setattr(sys, "argv", [
        "demo", "--model", "tiny_deaotl", "--stage", "test", "--ckpt_path",
        weights, "--frames_dir", str(frames), "--first_mask", str(first),
        "--output_dir", str(tmp_path / "jax")])
    jdemo.main()
    _port_demo(frames, first, tmp_path / "port", "--ckpt_path", weights)
    for t in range(FRAMES):
        got = read_png(str(tmp_path / "port" / "masks" / f"{t:05d}.png"))
        ref = np.asarray(Image.open(tmp_path / "jax" / "masks"
                                    / f"{t:05d}.png"))
        np.testing.assert_array_equal(got, ref, err_msg=f"frame {t}")
        assert (tmp_path / "port" / f"{t:05d}_overlay.jpg").read_bytes() == \
            (tmp_path / "jax" / f"{t:05d}_overlay.jpg").read_bytes(), t
    assert len(np.unique(got)) > 1      # the objects survive to the end


def test_demo_matches_port_evaluator(video_dir, tmp_path):
    """The demo is the evaluator's per-frame path (force_slow) on the same
    frames and weights (init_params(model, 0), the demo's `test`), mask
    for mask."""
    root, frames, first = video_dir
    _port_demo(frames, first, tmp_path / "demo")
    cfg = get_config("test", model="tiny_deaotl", compute_dtype="float32",
                     test_dataset="vost", dir_root=str(tmp_path / "res"))
    model = init_params(build_vos_model(cfg.model_vos, cfg), 0)
    ev = Evaluator(cfg, params=model.state_dict(), data_root=str(root.parent),
                   output_root=str(tmp_path / "ev"), log=lambda *a: None,
                   device="cpu")
    ev.force_slow = True
    ev.evaluate()
    for t in range(FRAMES):
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "demo" / "masks" / f"{t:05d}.png")),
            read_png(str(tmp_path / "ev" / "vid" / f"{t:05d}.png")),
            err_msg=f"frame {t}")


def _read_video(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def test_video_matches_jax_video(video_dir, tmp_path, monkeypatch):
    """The same frames and mask directories (B missing a mask, whose panel
    repeats the frame) through both tools: the same frames read back."""
    _, frames, first = video_dir
    _port_demo(frames, first, tmp_path / "demo")
    masks_a = tmp_path / "demo" / "masks"
    masks_b = tmp_path / "b"
    shutil.copytree(masks_a, masks_b)
    os.remove(masks_b / "00002.png")
    monkeypatch.setattr(sys, "argv", [
        "video", "--frames_dir", str(frames), "--masks_a", str(masks_a),
        "--masks_b", str(masks_b), "--output", str(tmp_path / "jax.mp4")])
    jvideo.main()
    n = video.main(["--frames_dir", str(frames), "--masks_a", str(masks_a),
                    "--masks_b", str(masks_b), "--output",
                    str(tmp_path / "port.mp4")])
    got, ref = _read_video(tmp_path / "port.mp4"), _read_video(
        tmp_path / "jax.mp4")
    assert n == len(got) == len(ref) == FRAMES
    for a, b in zip(got, ref):
        assert a.shape == b.shape == (HW[0], 3 * HW[1], 3)
        np.testing.assert_array_equal(a, b)


class _Parsed(Exception):
    pass


def _jax_parser(module, monkeypatch):
    """The parser the JAX tool's main builds, caught at parse_args."""
    def catch(self, *a, **kw):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as info:
        module.main()
    monkeypatch.undo()
    return info.value.args[0]


def _flags(parser):
    return {a.dest: (a.default, a.required, a.type, a.option_strings)
            for a in parser._actions if a.dest != "help"}


def test_cli_flags_match_jax(monkeypatch):
    """Every flag of the JAX demo and video tools, with its default,
    requiredness and type; the port's demo adds --device only."""
    got = _flags(demo.build_parser())
    assert got.pop("device") == (None, False, None, ["--device"])
    assert got == _flags(_jax_parser(jdemo, monkeypatch))
    assert _flags(video.build_parser()) == _flags(_jax_parser(jvideo,
                                                              monkeypatch))


def test_overlay_mask_matches_jax_on_arrays_and_tensors():
    """One overlay for both tools: on numpy arrays (the video tool) and on
    tensors (the demo, on the engine's device) it gives the JAX package's
    overlay bit for bit, ids past the objects and 255 included."""
    from rmem_tpu.utils.image import overlay_mask as joverlay

    from rmem_tpu_torch.utils.image import overlay_mask
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (*HW, 3), dtype=np.uint8)
    mask = rng.integers(0, 12, HW).astype(np.uint8)
    mask[:4] = 255
    ref = joverlay(img, mask)
    out = overlay_mask(img, mask)
    assert isinstance(out, np.ndarray) and np.array_equal(out, ref)
    out = overlay_mask(torch.from_numpy(img), torch.from_numpy(mask))
    assert out.dtype == torch.uint8 and np.array_equal(out.numpy(), ref)


def test_logits_conv_runs_without_tf32(monkeypatch):
    """The head's f32 logits conv runs with cuDNN's TF32 off whatever the
    caller's flag, and the flag is the caller's again after it: on the card
    the served masks would otherwise depend on the flag of the process
    that serves them."""
    from rmem_tpu_torch.models.decoders.fpn import FPNSegmentationHead
    head = FPNSegmentationHead(16, 3, decode_intermediate_input=False,
                               hidden_dim=16, shortcut_dims=(8, 8, 8, 16))
    flags = []
    conv2d = torch.nn.functional.conv2d

    def spy(x, weight, *args, **kw):
        flags.append((weight.shape[0], torch.backends.cudnn.allow_tf32))
        return conv2d(x, weight, *args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    g = torch.Generator().manual_seed(0)
    shortcuts = [torch.randn(1, c, s, s, generator=g)
                 for c, s in ((8, 9), (8, 5), (8, 3), (16, 3))]
    out = head([shortcuts[-1]], shortcuts)
    assert out.shape == (1, 3, 9, 9) and out.dtype == torch.float32
    assert flags[-1] == (3, False)
    assert all(on for _, on in flags[:-1]) and len(flags) > 1
    assert torch.backends.cudnn.allow_tf32
