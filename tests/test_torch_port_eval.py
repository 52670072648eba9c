"""The evaluator and its parts against the JAX package on the CPU: the PNG
codec, the JPEG reader's CPU branch, the dataset readers, the metrics and
the offline scorer, the sharding helpers, the Config's eval fields, the
Evaluator itself (single-aug VOST, and multi-scale + flip on YouTube-VOS
with an object first annotated mid-video), and the CLI.

Both sides run `tiny_deaotl` in f32 with one set of weights (the JAX
tree through `params_from_jax`), on trees this file writes from seeded
numpy as `parity/make_dataset.py` writes them (cv2 for the JPEGs, PIL for
the palette PNGs), with chunks of 4 frames."""

import argparse
import io
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import cv2
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rmem_tpu import config as jconfig
from rmem_tpu.config import get_config as jget_config
from rmem_tpu.data import eval_datasets as jdatasets
from rmem_tpu.evaluation import metrics as jmetrics
from rmem_tpu.evaluation.evaluation import Evaluation as JEvaluation
from rmem_tpu.evaluation.evaluation import summarize as jsummarize
from rmem_tpu.evaluation.evaluation_method import write_csvs as jwrite_csvs
from rmem_tpu.managers.evaluator import Evaluator as JEvaluator
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_params as jinit
from rmem_tpu.parallel import eval_sharding as jsharding
from rmem_tpu.tools import eval as jeval_cli
from rmem_tpu.utils.image import label_colormap as jlabel_colormap
from rmem_tpu_torch.config import Config, get_config
from rmem_tpu_torch.data import eval_datasets as datasets
from rmem_tpu_torch.data.jpeg import read_jpeg
from rmem_tpu_torch.evaluation import metrics
from rmem_tpu_torch.evaluation.evaluation import Evaluation, summarize
from rmem_tpu_torch.evaluation.evaluation_method import write_csvs
from rmem_tpu_torch.kernels import jpeg_color
from rmem_tpu_torch.managers.evaluator import Evaluator
from rmem_tpu_torch.parallel import eval_sharding as sharding
from rmem_tpu_torch.tools import eval as eval_cli
from rmem_tpu_torch.utils import params_from_jax
from rmem_tpu_torch.utils.image import decode_png, encode_png_pal8, \
    label_colormap, read_png

REPO = Path(__file__).resolve().parents[1]
# 112 x 176 frames: a 113 x 177 input, an 8 x 12 grid (10 x 15 at scale
# 1.3). On a grid under 8 on its short side that is not square the JAX
# package clamps the local window on both axes (ROADMAP Queue 3), which
# the port does not copy: at 64 x 96 (a 5 x 7 grid) the two evaluators
# differ from the reference frame on
HW = (112, 176)
FRAMES = 8
OVER = dict(compute_dtype="float32", eval_scan_chunk=4)
# the masks of the two evaluators: f32 on both sides, the frame prep and
# ~30 layers summing in another order, so a pixel whose top-2
# probabilities nearly tie may flip and feed a slightly different memory
# (measured: every pixel equal)
AGREE_FLOOR = 0.999


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores, and
    PyTorch's default of one thread per visible CPU makes each of them
    wait on the others many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- trees written as parity/make_dataset.py writes them ------------------
def _frame(seed, t, h, w):
    rng = np.random.RandomState(seed * 10_000 + t)
    low = rng.rand(h // 8, w // 8, 3).astype(np.float32)
    img = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h * (0.3 + 0.02 * t), w * (0.25 + 0.03 * t)
    blob = np.exp(-(((yy - cy) / (0.15 * h)) ** 2
                    + ((xx - cx) / (0.15 * w)) ** 2))
    img = img * 0.5 + 0.4 * blob[..., None]
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def _label(h, w, t, objects=(1, 2, 3), void=False):
    """Stripes that drift with t; object ids as given (original ids)."""
    lab = np.zeros((h, w), np.uint8)
    for i, obj in enumerate(objects):
        x0 = (i * w // len(objects) + t) % w
        lab[h // 6 + 3 * i:h - h // 6, x0:x0 + w // (2 * len(objects))] = obj
    if void:
        lab[:3, :5] = 255
    return lab


def _write_png_pil(path, lab, palette=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = Image.fromarray(lab, mode="P")
    img.putpalette(jlabel_colormap().reshape(-1).tolist()
                   if palette is None else palette)
    img.save(path)


def _write_video(img_dir, ann_dir, seed, frames, hw, labels):
    os.makedirs(img_dir, exist_ok=True)
    for t in range(frames):
        cv2.imwrite(os.path.join(img_dir, f"{t:05d}.jpg"),
                    _frame(seed, t, *hw)[:, :, ::-1])
    for t, lab in labels.items():
        _write_png_pil(os.path.join(ann_dir, f"{t:05d}.png"), lab)


def _vost_tree(root, names=("seqa", "seqb"), frames=FRAMES, hw=HW,
               images="JPEGImages_10fps", sets="ImageSets", sub="",
               gt_all=False):
    os.makedirs(os.path.join(root, sets), exist_ok=True)
    with open(os.path.join(root, sets, "val.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    for si, name in enumerate(names):
        labels = {t: _label(*hw, t, void=t == 2)
                  for t in (range(frames) if gt_all else [0])}
        _write_video(os.path.join(root, images, sub, name),
                     os.path.join(root, "Annotations", sub, name), si,
                     frames, hw, labels)


def _ytb_tree(root, frames=FRAMES, hw=HW):
    """One video: objects 3 and 5 annotated at frame 0, object 7 first at
    frame 4 (with 5 again)."""
    base = os.path.join(root, "YTB", "2019", "valid")
    _write_video(os.path.join(base, "JPEGImages", "vid"),
                 os.path.join(base, "Annotations", "vid"), 3, frames, hw,
                 {0: _label(*hw, 0, (3, 5)), 4: _label(*hw, 4, (5, 7))})


# -- the evaluators, each run once -------------------------------------------
@pytest.fixture(scope="module")
def weights():
    cfg = jget_config("pre_vost", model="tiny_deaotl", **OVER)
    jparams = jinit(jbuild(cfg.model_vos, cfg), jax.random.PRNGKey(0))
    return jparams, params_from_jax(jparams)


def _pngs(out):
    return {str(p.relative_to(out)): p for p in sorted(Path(out).rglob("*.png"))}


def _run_both(tmp, weights, dataset, **over):
    jparams, params = weights
    runs = {}
    for side in ("jax", "port"):
        out = str(tmp / side)
        if side == "jax":
            cfg = jget_config("pre_vost", model="tiny_deaotl",
                              test_dataset=dataset, **OVER, **over)
            ev = JEvaluator(cfg, params=jparams, data_root=str(tmp / "data"),
                            output_root=out, log=lambda *a: None)
        else:
            cfg = get_config("pre_vost", model="tiny_deaotl",
                             test_dataset=dataset, **OVER, **over)
            ev = Evaluator(cfg, params=params, data_root=str(tmp / "data"),
                           output_root=out, log=lambda *a: None,
                           device="cpu")
        runs[side] = (ev, ev.evaluate(), out)
    return runs


@pytest.fixture(scope="module")
def vost_runs(tmp_path_factory, weights):
    tmp = tmp_path_factory.mktemp("vost")
    _vost_tree(str(tmp / "data" / "VOST"))
    return tmp, _run_both(tmp, weights, "vost")


@pytest.fixture(scope="module")
def ytb_runs(tmp_path_factory, weights):
    tmp = tmp_path_factory.mktemp("ytb")
    _ytb_tree(str(tmp / "data"))
    return tmp, _run_both(tmp, weights, "youtubevos", test_flip=True,
                          test_multiscale=(1.0, 1.3))


def _hold_masks(runs, first_files):
    """Every frame's PNG of the port against the JAX evaluator's; the
    first annotation copied byte for byte; the same stats keys (less the
    memory figure: the port reports the card's peak, which the CPU has
    not, and JAX its live bytes)."""
    (_, jstats, jout), (_, stats, out) = runs["jax"], runs["port"]
    jpngs, pngs = _pngs(jout), _pngs(out)
    assert sorted(pngs) == sorted(jpngs) and pngs
    worst = 1.0
    for name, path in pngs.items():
        got, ref = np.asarray(Image.open(path)), np.asarray(
            Image.open(jpngs[name]))
        assert got.shape == ref.shape
        worst = min(worst, float((got == ref).mean()))
    assert worst >= AGREE_FLOOR, worst
    for name, src in first_files.items():
        assert Path(out, name).read_bytes() == Path(src).read_bytes()
    mem = {"peak_hbm_gb", "live_device_mb"}
    assert set(stats) - mem == set(jstats) - mem
    assert stats["all_frame_fps"] > 0


def test_evaluator_vost_matches_jax(vost_runs):
    """2 videos x 8 frames at 112 x 176, 3 objects, one aug: a chunk of 4
    and a padded one of 3."""
    tmp, runs = vost_runs
    ann = tmp / "data" / "VOST" / "Annotations"
    _hold_masks(runs, {f"{s}/00000.png": ann / s / "00000.png"
                       for s in ("seqa", "seqb")})
    assert len(_pngs(runs["port"][2])) == 2 * FRAMES


def test_evaluator_ytb_multiaug_midvideo_matches_jax(ytb_runs):
    """Scales 1.0 and 1.3, each plain and flipped, and a new object at
    frame 4: frames 1-3 run unpadded one at a time, frame 4 merges its
    annotation and re-references, frames 5-7 run as one padded chunk."""
    tmp, runs = ytb_runs
    ann = tmp / "data" / "YTB" / "2019" / "valid" / "Annotations" / "vid"
    _hold_masks(runs, {"vid/00000.png": ann / "00000.png"})
    out = runs["port"][2]
    # the merged frame keeps the new object, under its original id
    assert 7 in np.unique(read_png(os.path.join(out, "vid", "00004.png")))


def test_slow_path_matches_fused(vost_runs, weights):
    """The per-frame path (force_slow) writes the fused path's masks. (On
    the YouTube-VOS video the two differ by design, as in the JAX
    package: the per-frame path maps a frame's squeezed ids back with the
    id map of its own frame, the fused path with the video's last, so a
    ghost id, an unused id channel that wins the argmax, is written as
    background before frame 4 by one and as object 7 by the other.)"""
    tmp, runs = vost_runs
    cfg = get_config("pre_vost", model="tiny_deaotl", test_dataset="vost",
                     **OVER)
    ev = Evaluator(cfg, params=weights[1], data_root=str(tmp / "data"),
                   output_root=str(tmp / "slow"), log=lambda *a: None,
                   device="cpu")
    ev.force_slow = True
    ev.evaluate()
    fused = _pngs(runs["port"][2])
    slow = _pngs(tmp / "slow")
    assert sorted(slow) == sorted(fused)
    for name in fused:
        np.testing.assert_array_equal(read_png(str(slow[name])),
                                      read_png(str(fused[name])))


# -- PNG and JPEG ---------------------------------------------------------------
@pytest.mark.parametrize("mode", ["P", "L", "RGB"])
def test_png_codec_matches_pil(mode, tmp_path):
    """PNGs written by PIL (palette ones at 8 bits and, with 4 colours,
    at 2; grey and RGB with PIL's adaptive row filters, Sub, Up, Average
    and Paeth among them) read as PIL reads them; and (palette) the
    port's PNG read by PIL: the same indices and the label colormap,
    equal to the JAX package's."""
    if mode == "P":
        rng = np.random.RandomState(0)
        mask = rng.randint(0, 12, (37, 53)).astype(np.uint8)
        mask[:4] = 255
        np.testing.assert_array_equal(label_colormap(), jlabel_colormap())
        data = encode_png_pal8(mask, label_colormap())
        img = Image.open(io.BytesIO(data))
        assert img.mode == "P"
        np.testing.assert_array_equal(np.asarray(img), mask)
        np.testing.assert_array_equal(
            np.asarray(img.getpalette(), np.uint8).reshape(-1, 3)[:256],
            label_colormap())
        pix, pal = decode_png(data)
        np.testing.assert_array_equal(pix, mask)
        np.testing.assert_array_equal(pal, label_colormap())
    h, w = 41, 67
    yy, xx = np.mgrid[:h, :w]
    smooth = ((np.sin(xx / 5.0) + np.cos(yy / 4.0)) * 60 + 128).astype(
        np.uint8)
    noise = np.random.RandomState(1).randint(0, 256, (h, w)).astype(np.uint8)
    rows = np.where((yy // 6) % 2 == 0, smooth, noise).astype(np.uint8)
    if mode == "P":
        images = [Image.fromarray(rows).convert("P"),
                  Image.fromarray((rows % 4).astype(np.uint8), mode="P")]
        images[1].putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0, 0, 0, 255])
    elif mode == "L":
        images = [Image.fromarray(rows)]
    else:
        images = [Image.fromarray(np.stack([rows, rows[::-1], noise], -1))]
    filters = set()
    for i, img in enumerate(images):
        path = tmp_path / f"{i}.png"
        img.save(path)
        ref = Image.open(path)
        np.testing.assert_array_equal(read_png(str(path)), np.asarray(ref))
        if mode == "P":
            assert ref.mode == "P"
            pal = decode_png(path.read_bytes())[1]
            np.testing.assert_array_equal(
                pal.reshape(-1), np.asarray(ref.getpalette()[:pal.size]))
        else:
            filters |= _filter_types(path.read_bytes(), img)
    if mode != "P":
        assert filters >= {1, 2, 4}, filters


def _filter_types(buf, img):
    """The row filter bytes of an 8-bit PNG PIL wrote."""
    import struct
    import zlib
    pos, idat = 8, b""
    while pos < len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        if kind == b"IDAT":
            idat += buf[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    stride = img.size[0] * len(img.getbands()) + 1
    return {raw[i * stride] for i in range(img.size[1])}


def test_read_jpeg_cpu_is_cv2_and_modules_need_neither(tmp_path):
    """On the CPU read_jpeg gives cv2's RGB bits, from a path and from
    bytes; and every module of the package imports with cv2 and PIL
    blocked (cv2 is imported only inside read_jpeg's CPU branch)."""
    path = tmp_path / "f.jpg"
    cv2.imwrite(str(path), _frame(0, 3, 47, 81)[:, :, ::-1])
    ref = cv2.imread(str(path))[..., ::-1]
    got = read_jpeg(str(path), "cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(read_jpeg(path.read_bytes(), "cpu")
                                  .numpy(), ref)
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            .removesuffix(".__init__")
            for p in sorted((REPO / "rmem_tpu_torch").rglob("*.py"))]
    code = ("import sys\n"
            "for m in ('cv2', 'PIL', 'jax', 'flax', 'rmem_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_ycc_to_rgb_plain_matches_libjpeg():
    """The plain version of the card's upsampling + colour kernel, fed
    libjpeg's own planes of a 4:2:0 and a 4:4:4 JPEG, gives libjpeg's RGB
    bit for bit (cv2's decode). libjpeg's planes come through PIL: its
    YCbCr decode at full size gives Y (and 4:4:4's chroma), at half size
    the chroma planes before upsampling (libjpeg then runs the chroma's
    full 8 x 8 IDCT and upsamples 1:1). 480 x 854 has an odd chroma
    width; a grey JPEG's RGB is its Y three times."""
    rng = np.random.RandomState(0)
    s420 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420
    for h, w, factor in ((48, 80, s420), (480, 854, s420),
                         (46, 78, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)):
        img = _frame(1, 2, h, w)
        data = cv2.imencode(".jpg", img[:, :, ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            factor])[1].tobytes()
        ref = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_COLOR)[..., ::-1]
        full = Image.open(io.BytesIO(data))
        full.draft("YCbCr", full.size)
        planes = np.asarray(full)
        if factor == s420:
            half = Image.open(io.BytesIO(data))
            half.draft("YCbCr", ((w + 1) // 2, (h + 1) // 2))
            chroma = np.asarray(half)
            assert chroma.shape[:2] == ((h + 1) // 2, (w + 1) // 2)
            mode = jpeg_color.YCC420
        else:
            chroma, mode = planes, jpeg_color.YCC444
        got = jpeg_color.ycc_to_rgb(*(torch.from_numpy(p.copy()) for p in (
            planes[..., 0], chroma[..., 1], chroma[..., 2])), mode)
        np.testing.assert_array_equal(got.numpy(), ref)
    grey = rng.randint(0, 256, (9, 11)).astype(np.uint8)
    got = jpeg_color.ycc_to_rgb(torch.from_numpy(grey), None, None,
                                jpeg_color.GREY)
    np.testing.assert_array_equal(got.numpy(), np.repeat(grey[..., None],
                                                         3, -1))


# -- datasets, metrics, scorer ---------------------------------------------------
def test_readers_match_jax(tmp_path):
    """VOST, DAVIS, YouTube-VOS (objects first annotated mid-video, void
    pixels) and Long Videos: the JAX readers' names, labels, obj_num and
    obj_idx, and their float images' values."""
    root = tmp_path
    hw = (24, 40)
    _vost_tree(str(root / "VOST"), frames=4, hw=hw)
    _vost_tree(str(root / "DAVIS"), frames=4, hw=hw, images="JPEGImages",
               sets=os.path.join("ImageSets", "2017"), sub="480p")
    _vost_tree(str(root / "long_videos"), names=("lv",), frames=3, hw=hw,
               images="JPEGImages")
    base = root / "YTB" / "2019" / "valid"
    _write_video(str(base / "JPEGImages" / "v"), str(base / "Annotations" /
                                                      "v"), 7, 5, hw,
                 {0: _label(*hw, 0, (4,), void=True),
                  2: _label(*hw, 2, (4, 9)), 3: _label(*hw, 3, (9, 2))})
    for name in ("vost", "davis2017", "long_videos", "youtubevos"):
        jcfg = jget_config("default", test_dataset=name)
        cfg = get_config("default", test_dataset=name)
        jds = jdatasets.build_eval_dataset(jcfg, str(root))
        ds = datasets.build_eval_dataset(cfg, str(root), device="cpu")
        assert ds.seq_names == jds.seq_names and len(ds) == len(jds)
        assert datasets.sequence_lengths(ds) == \
            jdatasets.sequence_lengths(jds)
        for i in range(len(ds)):
            jseq, seq = jds.sequence(i), ds.sequence(i)
            assert (seq.obj_nums, seq.obj_indices) == (jseq.obj_nums,
                                                       jseq.obj_indices)
            assert seq.first_label_file() == jseq.first_label_file()
            for jf, f in zip(jseq, seq):
                assert (f.name, f.obj_num, f.obj_idx) == (
                    jf.name, jf.obj_num, jf.obj_idx)
                assert f.image.dtype == torch.uint8
                np.testing.assert_array_equal(f.image.float().numpy(),
                                              jf.image)
                if jf.label is None:
                    assert f.label is None
                else:
                    np.testing.assert_array_equal(f.label, jf.label)
    jsyn = jdatasets.SyntheticEvalDataset(num_seqs=1, num_frames=2,
                                          hw=(8, 12)).sequence(0)
    syn = datasets.SyntheticEvalDataset(num_seqs=1, num_frames=2, hw=(8, 12),
                                        device="cpu").sequence(0)
    for jf, f in zip(jsyn, syn):
        np.testing.assert_array_equal(f.image.numpy(), jf.image)
        np.testing.assert_array_equal(f.label, jf.label)


def test_metrics_and_scorer_match_jax(tmp_path):
    """db_eval_iou, db_eval_boundary (F bit for bit: scipy's dilation for
    cv2's) and db_statistics on seeded masks; then Evaluation.evaluate,
    summarize and write_csvs on one GT tree with void pixels."""
    rng = np.random.RandomState(0)
    gt = np.zeros((6, 60, 90), bool)
    seg = np.zeros((6, 60, 90), bool)
    for t in range(6):
        gt[t, 10 + t:40, 20:50 + 2 * t] = True
        seg[t, 12:38 + t, 18 + t:52] = True
        seg[t] ^= rng.rand(60, 90) < 0.02
    seg[4] = False                         # an empty prediction
    gt[5] = False                          # an empty annotation
    void = rng.rand(6, 60, 90) < 0.05
    np.testing.assert_array_equal(metrics.db_eval_iou(gt, seg),
                                  jmetrics.db_eval_iou(gt, seg))
    np.testing.assert_array_equal(metrics.db_eval_iou(gt, seg, void),
                                  jmetrics.db_eval_iou(gt, seg, void))
    for v in (None, void):
        np.testing.assert_array_equal(
            metrics.db_eval_boundary(gt, seg, v),
            jmetrics.db_eval_boundary(gt, seg, v))
    assert metrics.db_eval_boundary(gt[0], seg[0], bound_th=3) == \
        jmetrics.db_eval_boundary(gt[0], seg[0], bound_th=3)
    vals = np.concatenate([rng.rand(300), [np.nan]])
    np.testing.assert_array_equal(metrics.db_statistics(vals),
                                  jmetrics.db_statistics(vals))

    root = str(tmp_path / "ds")
    _vost_tree(root, frames=7, hw=(30, 44), gt_all=True)
    res = tmp_path / "res"
    for s in ("seqa", "seqb"):
        for t in range(7):
            lab = np.asarray(Image.open(os.path.join(
                root, "Annotations", s, f"{t:05d}.png")))
            pred = np.where(lab == 255, 0, np.roll(lab, t % 3, axis=1))
            pred[(rng.rand(*pred.shape) < 0.03)] = 2
            _write_png_pil(str(res / s / f"{t:05d}.png"), pred.astype(
                np.uint8))
    metric = ("J", "J_last", "F")
    jm = JEvaluation(root, "val").evaluate(str(res), metric=metric)
    m = Evaluation(root, "val").evaluate(str(res), metric=metric)
    assert summarize(m) == jsummarize(jm)
    for key in metric:
        for stat in ("M", "R", "D"):
            np.testing.assert_array_equal(m[key][stat], jm[key][stat])
        assert m[key]["M_per_object"] == jm[key]["M_per_object"]
    out = [write_csvs(str(res), m, metric, "val"),
           jwrite_csvs(str(tmp_path), jm, metric, "val")]
    for got, ref in zip(*out):
        assert Path(got).read_bytes() == Path(ref).read_bytes()


# -- sharding, config, CLI -------------------------------------------------------
def test_sharding_helpers_match_jax(tmp_path):
    lengths = [30, 120, 45, 45, 300, 12, 80, 7, 64]
    for pc in (1, 2, 3, 4):
        for pi in range(pc):
            for lens in (None, lengths):
                assert sharding.host_sequence_indices(
                    len(lengths), pi, pc, lens) == \
                    jsharding.host_sequence_indices(len(lengths), pi, pc,
                                                    lens)
        for frac in (0.0, 0.1, 0.3):
            assert sharding.split_bulk_tail(len(lengths), lengths, pc,
                                            frac) == \
                jsharding.split_bulk_tail(len(lengths), lengths, pc, frac)
    claims = [sharding.claim_next(str(tmp_path / "p"), [3, 5], "a"),
              sharding.claim_next(str(tmp_path / "p"), [3, 5], "b"),
              sharding.claim_next(str(tmp_path / "p"), [3, 5], "c")]
    jclaims = [jsharding.claim_next(str(tmp_path / "j"), [3, 5], "a"),
               jsharding.claim_next(str(tmp_path / "j"), [3, 5], "b"),
               jsharding.claim_next(str(tmp_path / "j"), [3, 5], "c")]
    assert claims == jclaims == [3, 5, None]
    stats = {"frames": 12.0, "seconds_sum": 3.5}
    assert sharding.allreduce_stats(stats) == jsharding.allreduce_stats(
        stats) == stats


EVAL_FIELDS = ("exp_name", "stage_name", "model_name", "dir_root",
               "dir_data", "test_dataset", "test_dataset_split",
               "test_ckpt_path", "test_ckpt_step", "test_ema",
               "test_workers", "eval_scan_chunk", "eval_fps_window",
               "eval_device_prep", "eval_yuv420_upload")


def test_config_eval_fields_match_jax(tmp_path):
    """The eval fields' defaults, get_config's names and result
    directory (its exp_name argument positional or not), and save/load;
    the YUV upload raises."""
    for f in EVAL_FIELDS:
        assert getattr(Config(), f) == getattr(jconfig.Config(), f), f
    for kw in (dict(no_memory_gap=True), dict(no_long_memory=True), {}):
        for model in ("r50_deaotl", "r50_aotl", "tiny_deaotl"):
            cfg = get_config("pre_vost_2", "rmem", model, **kw)
            ref = jget_config("pre_vost_2", "rmem", model, **kw)
            assert cfg.dir_result == ref.dir_result
            for f in EVAL_FIELDS:
                assert getattr(cfg, f) == getattr(ref, f), f
    cfg = get_config("test", model="tiny_deaotl", test_multiscale=(1.0, 1.3))
    assert Config.load(cfg.save(str(tmp_path / "c.json"))) == cfg
    jpath = jget_config("test", model="tiny_deaotl").save(
        str(tmp_path / "j.json"))
    assert Config.load(jpath) == get_config("test", model="tiny_deaotl")
    with pytest.raises(NotImplementedError, match="Not to port"):
        Evaluator(cfg.replace(eval_yuv420_upload=True), device="cpu")


def test_cli_defaults_match_jax_and_cpu_run_writes_pngs(tmp_path):
    """Every flag of the JAX CLI with its default (the port adds
    --device, and --claim_dir for runs as several ranks); then a CPU run of the synthetic dataset writes a PNG for each
    of its frames."""
    parsers = []

    def capture(self, args=None, namespace=None):
        parsers.append(self)
        raise SystemExit(0)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        with pytest.raises(SystemExit):
            jeval_cli.main()
    ref = {a.dest: (a.default, a.nargs, a.type) for a in parsers[0]._actions}
    got = {a.dest: (a.default, a.nargs, a.type)
           for a in eval_cli.build_parser()._actions}
    for dest in ("device", "claim_dir"):
        assert got.pop(dest) == (None, None, None)
    assert got == ref
    out = tmp_path / "out"
    eval_cli.main(["--dataset", "test", "--device", "cpu", "--max_frames",
                   "3", "--max_seqs", "2", "--model", "tiny_deaotl",
                   "--output_root", str(out), "--exp_name", "t",
                   "--opt", f"dir_root={tmp_path / 'results'}"])
    for seq in ("test0", "test1"):
        names = sorted(os.listdir(out / seq))
        assert names == ["00000.png", "00001.png", "00002.png"]
        assert read_png(str(out / seq / "00001.png")).shape == (240, 432)
