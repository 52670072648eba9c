"""The static-image pretraining chain of the port
(rmem_tpu_torch/data/image_transforms.py and StaticTrainDataset) against
the JAX package's, which runs it on PIL: the cases of
tests/test_image_transforms.py, each transform held to the JAX/PIL
function on seeded images. Tolerance: none. Every transform equals PIL
bit for bit (the affine's a = -1 cubic, the resize's 22-bit weights, the
8-bit blends and Pillow's uint8 HSV are each written out as Pillow
computes them). The dataset's clips are held in labels and obj_nums bit
for bit; their frames to JPEG_LEVELS (the port decodes with cv2 on the
CPU, the JAX package with PIL)."""

import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from rmem_tpu.data import image_transforms as jit
from rmem_tpu.data import train_datasets as jdata
from rmem_tpu.config import get_config as jget_config
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.data import image_transforms as it
from rmem_tpu_torch.data import train_datasets as pdata

JPEG_LEVELS = 1.0      # frames: PIL's and cv2's decode of the same JPEG


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _noise(w=64, h=48, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3), np.uint8)


def _smooth(w=64, h=48):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(xx * 3) % 256, (yy * 5) % 256, (xx + 2 * yy) % 256],
                    -1).astype(np.uint8)


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_affine_identity():
    a = _noise()
    for resample, jres in ((it.NEAREST, jit.NEAREST),
                           (it.BICUBIC, jit.BICUBIC)):
        got = it.affine(torch.from_numpy(a), 0.0, (0, 0), 1.0, (0.0, 0.0),
                        resample=resample)
        _same(got, jit.affine(Image.fromarray(a), 0.0, (0, 0), 1.0,
                              (0.0, 0.0), resample=jres))
        _same(got, a)


def test_affine_pure_translation():
    a = _noise()
    got = it.affine(torch.from_numpy(a), 0.0, (5, 3), 1.0, (0.0, 0.0),
                    fill=(0, 0, 0)).numpy()
    _same(got, jit.affine(Image.fromarray(a), 0.0, (5, 3), 1.0, (0.0, 0.0),
                          resample=jit.NEAREST, fillcolor=(0, 0, 0)))
    np.testing.assert_array_equal(got[3:, 5:], a[:-3, :-5])


def test_affine_rotation_90_center_invariant():
    a = np.random.RandomState(1).randint(0, 255, (33, 33, 3), np.uint8)
    got = it.affine(torch.from_numpy(a), 90.0, (0, 0), 1.0,
                    (0.0, 0.0)).numpy()
    _same(got, jit.affine(Image.fromarray(a), 90.0, (0, 0), 1.0, (0.0, 0.0),
                          resample=jit.NEAREST))
    assert (got == np.rot90(a)).all() or (got == np.rot90(a, -1)).all()


def test_affine_matches_numpy_gather():
    """The mask at NEAREST (16.16 fixed point, fill 255) and the frame at
    BICUBIC (fill (124, 116, 104)), noise and a smooth image, under two
    rotation + shear matrices, equal PIL's transform bit for bit."""
    lab = np.random.RandomState(2).randint(0, 5, (40, 56), np.uint8)
    for params in ((17.0, (4.0, -3.0), 1.07, (8.0, 0.0)),
                   (-12.3, (0.0, 5.0), 0.93, (-6.0, 0.0))):
        _same(it.affine(lab, *params, fill=255),
              jit.affine(Image.fromarray(lab, mode="L"), *params,
                         resample=jit.NEAREST, fillcolor=255))
        for a in (_noise(50, 40, 3), _smooth(50, 40)):
            _same(it.affine(torch.from_numpy(a), *params,
                            resample=it.BICUBIC, fill=(124, 116, 104)),
                  jit.affine(Image.fromarray(a), *params,
                             resample=jit.BICUBIC,
                             fillcolor=(124, 116, 104)))


def test_resized_crop_equals_pil_crop_resize():
    """The frame's bicubic (antialiased) and the mask's nearest resize of
    a crop, down, up and each axis its own way."""
    a = _noise(80, 60)
    lab = a[..., 0] // 40
    for i, j, h, w, size in ((7, 11, 40, 50, (30, 30)),
                             (3, 5, 50, 70, (75, 85)),
                             (10, 20, 45, 50, (45, 65))):
        _same(it.resized_crop(torch.from_numpy(a), i, j, h, w, size),
              jit.resized_crop(Image.fromarray(a), i, j, h, w, size,
                               interpolation=jit.BICUBIC))
        _same(it.resized_crop(lab, i, j, h, w, size, it.NEAREST),
              jit.resized_crop(Image.fromarray(lab, mode="L"), i, j, h, w,
                               size, interpolation=jit.NEAREST))


def test_random_resized_crop_params_in_range():
    """The same draws as the JAX sampler, inside the image, area and ratio
    in range."""
    rrc = it.RandomResizedCrop((465, 465), scale=(0.8, 1.0))
    jrrc = jit.RandomResizedCrop((465, 465), scale=(0.8, 1.0))
    rng, jrng = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(50):
        i, j, h, w = rrc.get_params(rng, (640, 480))
        assert (i, j, h, w) == jrrc.get_params(jrng, (640, 480))
        assert 0 <= i and 0 <= j and i + h <= 480 and j + w <= 640
        assert 0.6 <= (h * w) / (640 * 480) <= 1.01
        assert math.isclose(w / h, 1.0, rel_tol=0.45)


def test_color_jitter_deterministic_and_bounded():
    """ColorJitter and each of its four ops equal ImageEnhance's and the
    HSV shift's, on noise and a smooth image."""
    for a in (_noise(), _smooth()):
        t, img = torch.from_numpy(a), Image.fromarray(a)
        for seed in range(4):
            got = it.ColorJitter()(np.random.RandomState(seed), t)
            _same(got, jit.ColorJitter()(np.random.RandomState(seed), img))
        for f in (0.9, 1.07):
            _same(it.adjust_brightness(t, f), jit.adjust_brightness(img, f))
            _same(it.adjust_contrast(t, f), jit.adjust_contrast(img, f))
            _same(it.adjust_saturation(t, f), jit.adjust_saturation(img, f))
    d = np.abs(got.numpy().astype(np.float32) - a.astype(np.float32)).mean()
    assert d < 40


def test_adjust_hue_wraps_uint8():
    a = _noise()
    t, img = torch.from_numpy(a), Image.fromarray(a)
    for f in (0.5, -0.5, 0.03, -0.021):
        _same(it.adjust_hue(t, f), jit.adjust_hue(img, f))
    back = it.adjust_hue(it.adjust_hue(t, 0.5), -0.5).numpy()
    assert np.median(np.abs(back.astype(np.int16) - a.astype(np.int16))) <= 2
    with pytest.raises(ValueError):
        it.adjust_hue(t, 0.6)


def test_compact_relabel_shuffles_and_persists():
    m0 = np.zeros((10, 10), np.uint8)
    m0[:3, :3] = 4
    m0[5:, 5:] = 9
    rng, jrng = np.random.RandomState(7), np.random.RandomState(7)
    lab0, objs = it.compact_relabel(m0, None, rng, max_obj_n=10)
    jlab0, jobjs = jit.compact_relabel(m0, None, jrng, max_obj_n=10)
    assert objs == jobjs and sorted(objs) == [4, 9]
    _same(lab0, jlab0)
    m1 = np.where(m0 == 4, 0, m0)
    m1[0, 9] = 255                  # void and unlisted ids: background
    lab1 = it.compact_relabel(m1, objs, rng, 10)[0]
    _same(lab1, jit.compact_relabel(m1, jobjs, jrng, 10)[0])
    assert lab1[0, 9] == 0
    _same(it.hflip(m1), np.asarray(jit.hflip(Image.fromarray(m1))))


def _write_static(root, specs):
    """Static/JPEGImages/<name>.jpg and Static/Annotations/<name>.png."""
    imgd = os.path.join(root, "Static", "JPEGImages")
    labd = os.path.join(root, "Static", "Annotations")
    os.makedirs(imgd)
    os.makedirs(labd)
    rng = np.random.RandomState(0)
    for name, h, w, boxes in specs:
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        lab = np.zeros((h, w), np.uint8)
        for oid, (y0, y1, x0, x1) in boxes:
            lab[y0:y1, x0:x1] = oid
        Image.fromarray(img).save(os.path.join(imgd, f"{name}.jpg"))
        Image.fromarray(lab, mode="P").save(os.path.join(labd, f"{name}.png"))
    return (imgd, labd)


def _hold_clip(clip, jclip):
    (imgs, labels, n), (jimgs, jlabels, jn) = clip, jclip
    assert n == jn and imgs.dtype == torch.float32
    np.testing.assert_array_equal(labels, jlabels)
    assert labels.dtype == np.int32 and tuple(imgs.shape) == jimgs.shape
    std = np.array([0.229, 0.224, 0.225], np.float32) * 255
    levels = np.abs(imgs.numpy() - jimgs) * std
    assert levels.max() <= JPEG_LEVELS + 1e-3, levels.max()


def test_static_train_dataset_clip(tmp_path):
    imgd, labd = _write_static(str(tmp_path), [
        ("a", 120, 160, [(1, (30, 80, 40, 100)), (2, (90, 110, 120, 150))])])
    kw = dict(seq_len=4, crop_hw=(65, 65), merge_prob=0.0,
              dynamic_merge=False)
    ds = pdata.StaticTrainDataset(imgd, labd, ["a.jpg"], **kw)
    jds = jdata.StaticTrainDataset(imgd, labd, ["a.jpg"], **kw)
    for seed in (11, 12):
        clip = ds.sample_clip(np.random.RandomState(seed), "cpu")
        _hold_clip(clip, jds.sample_clip(np.random.RandomState(seed)))
    imgs, labels, n = clip
    assert tuple(imgs.shape) == (4, 65, 65, 3) and n >= 1
    assert labels.max() <= n
    assert (imgs[0] - imgs[1]).abs().max() > 1e-3


def test_static_train_dataset_dynamic_merge(tmp_path):
    imgd, labd = _write_static(str(tmp_path), [
        ("a", 100, 100, [(1, (20, 80, 20, 80))]),
        ("b", 100, 100, [(1, (20, 80, 20, 80))])])
    kw = dict(seq_len=3, crop_hw=(65, 65), merge_prob=1.0)
    ds = pdata.StaticTrainDataset(imgd, labd, ["a.jpg", "b.jpg"], **kw)
    jds = jdata.StaticTrainDataset(imgd, labd, ["a.jpg", "b.jpg"], **kw)
    clip = ds.sample_clip(np.random.RandomState(1), "cpu")
    _hold_clip(clip, jds.sample_clip(np.random.RandomState(1)))
    assert clip[2] == 2 and clip[1].max() == 2


def test_stage_pre_batches_match_jax(tmp_path):
    """get_config("pre") and build_train_dataset's `static` layout: the
    loader's batch of 3 clips (ids past max_obj dropped, one image with
    none, so a merge is forced) as the JAX loader gives it."""
    _write_static(str(tmp_path), [
        ("a", 90, 120, [(1, (10, 60, 10, 70)), (3, (60, 85, 70, 110))]),
        ("b", 80, 100, [(2, (5, 40, 5, 50)), (7, (40, 75, 50, 95)),
                        (5, (0, 10, 0, 10))]),
        ("c", 70, 90, [])])
    over = dict(model_max_obj_num=2, data_randomcrop=(49, 49),
                data_seq_len=3)
    cfg = get_config("pre", model="tiny_deaotl", **over)
    jcfg = jget_config("pre", model="tiny_deaotl", **over)
    assert cfg.datasets == ("static",) and cfg.train_total_steps == 100_000
    batch = next(pdata.InlineBatchLoader(
        pdata.build_train_dataset(cfg, str(tmp_path)), 3, seed=5, max_obj=2,
        device="cpu"))
    jbatch = next(jdata.InlineBatchLoader(
        jdata.build_train_dataset(jcfg, str(tmp_path)), 3, seed=5,
        max_obj=2))
    for key in ("labels", "obj_nums"):
        np.testing.assert_array_equal(batch[key].numpy(), jbatch[key])
    std = np.array([0.229, 0.224, 0.225], np.float32) * 255
    levels = np.abs(batch["imgs"].numpy() - jbatch["imgs"]) * std
    assert levels.max() <= JPEG_LEVELS + 1e-3
