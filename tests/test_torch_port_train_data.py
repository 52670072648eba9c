"""Training on dataset trees in the port against the JAX package, on the
CPU: trees in the VOST, DAVIS, YouTube-VOS and VISOR layouts written by
the test (seeded JPEGs by cv2, palette PNGs by PIL), drawn by the port's
loader and the JAX InlineBatchLoader at the same seed (labels and
obj_nums bit for bit, frames within cv2's fixed-point rounding), with the
dynamic merge and the crop's zero padding; the prefetch loader; the
stage presets' datasets; the trainer's image dumps, the run logs, and the
training CLI for one step on a tree with --data_root."""

import json
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from rmem_tpu.config import get_config as jget_config
from rmem_tpu.data import train_datasets as jdata
from rmem_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.data import train_datasets as pdata
from rmem_tpu_torch.managers.trainer import Trainer
from rmem_tpu_torch.tools import train as train_cli
from rmem_tpu_torch.utils import logging as plog
from rmem_tpu_torch.utils.image import read_png

# the JAX loader scales uint8 frames with cv2's fixed-point INTER_CUBIC,
# the port with the f32 cubic rounded: a pixel may differ by one level
# (1/255 of the range before normalising). Measured on these trees: at
# most one level everywhere, on at most 0.005 % of the values
LEVEL_TOL = 1.0 + 1e-3
LEVEL_SHARE = 1e-3
# frames of SEQS: (name, frames, objects); the objects drift right
SEQS = (("seqa", 8, 3), ("seqb", 6, 2), ("seqc", 7, 1))
FRAME_HW = (54, 96)
DATA = dict(data_short_edge_len=48, data_randomcrop=(41, 41),
            data_seq_len=4, train_batch_size=2, model_max_obj_num=2)
LAYOUTS = {
    "vost": ("VOST/JPEGImages_10fps", "VOST/Annotations",
             "VOST/ImageSets/train.txt"),
    "davis2017": ("DAVIS/JPEGImages/480p", "DAVIS/Annotations/480p",
                  "DAVIS/ImageSets/2017/train.txt"),
    "youtubevos": ("YTB/2019/train/JPEGImages", "YTB/2019/train/Annotations",
                   None),
    "visor": ("VISOR/JPEGImages", "VISOR/Annotations",
              "VISOR/ImageSets/train.txt"),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def write_tree(root, layout: str, seed: int = 0):
    """The SEQS videos under root in `layout`: smooth noise frames with
    coloured boxes, JPEG at cv2's defaults; palette PNG labels with the
    boxes' ids and an ignored (255) band at the top."""
    img_dir, ann_dir, listing = LAYOUTS[layout]
    rng = np.random.RandomState(seed)
    h, w = FRAME_HW
    palette = np.random.RandomState(9).randint(0, 256, (256, 3)).astype(
        np.uint8).flatten().tolist()
    for name, frames, objects in SEQS:
        os.makedirs(os.path.join(root, img_dir, name))
        os.makedirs(os.path.join(root, ann_dir, name))
        boxes = rng.randint(0, 30, (objects, 2))
        for t in range(frames):
            low = rng.rand(h // 6, w // 6, 3).astype(np.float32)
            img = cv2.resize(low, (w, h), interpolation=cv2.INTER_LINEAR)
            img = (img * 200).astype(np.uint8)
            lab = np.zeros((h, w), np.uint8)
            lab[:3] = 255
            for i, (y, x) in enumerate(boxes):
                y0, x0 = 8 + y, (x + 4 * t) % (w - 20)
                lab[y0:y0 + 14, x0:x0 + 18] = i + 1
                img[y0:y0 + 14, x0:x0 + 18] = (60 * i, 255 - 50 * i, 128)
            cv2.imwrite(os.path.join(root, img_dir, name, f"{t:05d}.jpg"),
                        img[:, :, ::-1])
            png = Image.fromarray(lab, mode="P")
            png.putpalette(palette)
            png.save(os.path.join(root, ann_dir, name, f"{t:05d}.png"))
    if listing:
        path = os.path.join(root, listing)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(n for n, *_ in SEQS) + "\n")
    return root


def _levels(x):
    """Normalised frames back to pixel levels 0..255."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x * IMAGENET_STD * 255.0 + IMAGENET_MEAN * 255.0


def _loaders(root, layout, seed=3, **over):
    kw = dict(DATA, datasets=(layout,), **over)
    jcfg = jget_config("default", model="tiny_aotl", **kw)
    cfg = get_config("default", model="tiny_aotl", **kw)
    jl = jdata.InlineBatchLoader(jdata.build_train_dataset(jcfg, str(root)),
                                 jcfg.train_batch_size, seed,
                                 jcfg.model_max_obj_num)
    pl = pdata.InlineBatchLoader(pdata.build_train_dataset(cfg, str(root)),
                                 cfg.train_batch_size, seed,
                                 cfg.model_max_obj_num, device="cpu")
    return jl, pl


def _assert_batches_equal(jl, pl, n):
    """n batches: labels and obj_nums equal, frames within LEVEL_TOL with
    at most LEVEL_SHARE of the values off. Returns the share off."""
    off = []
    for _ in range(n):
        jb, pb = next(jl), next(pl)
        np.testing.assert_array_equal(pb["labels"].numpy(), jb["labels"])
        np.testing.assert_array_equal(pb["obj_nums"].numpy(), jb["obj_nums"])
        assert pb["imgs"].shape == jb["imgs"].shape
        assert pb["imgs"].dtype == torch.float32
        diff = np.abs(_levels(pb["imgs"]) - _levels(jb["imgs"]))
        assert diff.max() <= LEVEL_TOL, diff.max()
        off.append((diff > 1e-3).mean())
    assert max(off) <= LEVEL_SHARE, off
    return max(off)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_loader_matches_jax(layout, tmp_path):
    """Four batches of two clips of 4 from each layout at seed 3: the
    scale to a short side of 48 x 0.7..1.3 (so the 41 x 41 crop is
    sometimes padded), the crop draws, the flip, the merge (p 0.2) and the
    max_obj cap of 2 (seqa has 3 objects): the same labels and obj_nums
    as the JAX loader, the frames within a level."""
    write_tree(str(tmp_path), layout)
    jl, pl = _loaders(tmp_path, layout)
    _assert_batches_equal(jl, pl, 4)


@pytest.mark.parametrize("case", ["merge_always", "padded_crop",
                                  "no_scale_no_flip"])
def test_merge_and_crop_padding_match_jax(case, tmp_path):
    """The dynamic merge on every clip (the second clip's ids shifted, the
    ignore band kept), a crop larger than every scaled frame (zero-padded
    at the bottom and right on both sides; no flip), and clips neither scaled
    (factor 1 at the frame's own short side) nor flipped."""
    over = {"merge_always": dict(data_dynamic_merge_prob=1.0,
                                 model_max_obj_num=10),
            "padded_crop": dict(data_randomcrop=(65, 121),
                                data_randomflip=0.0),
            "no_scale_no_flip": dict(data_short_edge_len=FRAME_HW[0],
                                     data_min_scale_factor=1.0,
                                     data_max_scale_factor=1.0,
                                     data_randomflip=0.0)}[case]
    write_tree(str(tmp_path), "vost", seed=1)
    jl, pl = _loaders(tmp_path, "vost", seed=5, **over)
    share = _assert_batches_equal(jl, pl, 3)
    if case == "no_scale_no_flip":
        assert share == 0.0             # no resize: the same pixels
    if case == "padded_crop":
        # scaled frames are at most 62 x 111 and nothing flips: the rows
        # from 63 and the columns from 112 are padding, level 0, label 0
        b = next(pl)
        assert np.abs(_levels(b["imgs"][:, :, 63:])).max() < 1e-3
        assert np.abs(_levels(b["imgs"][:, :, :, 112:])).max() < 1e-3
        assert not b["labels"][:, :, 63:].any()


def test_synthetic_test_stage_and_presets_match_jax():
    """The `test` stage's constant clips as the JAX loader gives them, and
    every stage preset's datasets as the JAX presets name them (`pre`, the
    static-image stage, included: its clips are held in
    test_torch_port_image_transforms.py)."""
    jcfg = jget_config("test", model="tiny_aotl", train_batch_size=2)
    cfg = get_config("test", model="tiny_aotl", train_batch_size=2)
    jb = next(jdata.InlineBatchLoader(jdata.build_train_dataset(jcfg), 2))
    pb = next(pdata.InlineBatchLoader(pdata.build_train_dataset(cfg), 2,
                                      device="cpu"))
    for key in ("imgs", "labels", "obj_nums"):
        np.testing.assert_array_equal(pb[key].numpy(), jb[key])
    from rmem_tpu.config import STAGE_PRESETS as JSTAGES
    from rmem_tpu_torch.config import STAGE_PRESETS
    assert set(JSTAGES) == set(STAGE_PRESETS)
    for stage in STAGE_PRESETS:
        assert get_config(stage).datasets == jget_config(stage).datasets


def test_prefetch_loader_gives_the_inline_batches(tmp_path):
    """make_batch_loader with workers prepares the inline loader's batches
    at the same seed, in order, a batch ahead on its thread, and stops
    when closed; with 0 workers it is the inline loader."""
    write_tree(str(tmp_path), "vost")
    cfg = get_config("default", model="tiny_aotl", datasets=("vost",),
                     **DATA)
    ds = pdata.build_train_dataset(cfg, str(tmp_path))
    inline = pdata.make_batch_loader(ds, 2, seed=4, max_obj=2, num_workers=0)
    assert isinstance(inline, pdata.InlineBatchLoader)
    ahead = pdata.make_batch_loader(ds, 2, seed=4, max_obj=2, num_workers=4)
    assert isinstance(ahead, pdata.PrefetchBatchLoader)
    for _ in range(3):
        a, b = next(inline), next(ahead)
        for key in a:
            assert torch.equal(a[key], b[key]), key
    ahead.close()
    assert not ahead._thread.is_alive()


def test_run_logs(tmp_path, capsys):
    """Tee mirrors stdout into its file until closed, JsonlLogger writes a
    line a step, zip_results takes the PNGs only, copy_codes copies the
    package without caches."""
    tee = plog.Tee(str(tmp_path / "logs"), "train").install()
    print("to both")
    tee.close()
    print("to stdout only")
    assert open(tee.path).read() == "to both\n"
    assert "to both" in capsys.readouterr().out
    jl = plog.JsonlLogger(str(tmp_path / "m" / "metrics.jsonl"))
    jl.log(3, loss=np.float32(0.5), iou=1)
    jl.close()
    assert json.loads(open(tmp_path / "m" / "metrics.jsonl").read()) == {
        "step": 3, "loss": 0.5, "iou": 1.0}
    res = tmp_path / "res" / "seq"
    res.mkdir(parents=True)
    (res / "a.png").write_bytes(b"png")
    (res / "b.txt").write_text("no")
    import zipfile
    with zipfile.ZipFile(plog.zip_results(str(tmp_path / "res"))) as z:
        assert z.namelist() == ["seq/a.png"]
    dst = plog.copy_codes(str(tmp_path / "run"))
    assert os.path.isfile(os.path.join(dst, "data", "train_datasets.py"))
    assert not any("__pycache__" in d for d, _, _ in os.walk(dst))


def test_train_cli_trains_on_a_tree(tmp_path):
    """`python -m rmem_tpu_torch.tools.train --stage pre_vost_2 --data_root
    <tree>` for one step on the CPU (tiny_aotl, the GRU memory, reverse
    decodes and SGD, clips of 4 at 41 x 41): the config, the stdout log
    and the source snapshot under the run's directory, the step's log
    line, and the overlay PNGs of train_tblog_step."""
    write_tree(str(tmp_path / "data"), "vost")
    out = tmp_path / "results"
    train_cli.main([
        "--stage", "pre_vost_2", "--model", "tiny_aotl", "--device", "cpu",
        "--data_root", str(tmp_path / "data"), "--max_steps", "1",
        "--batch_size", "1", "--opt", f"dir_root={out}", "data_seq_len=4",
        "data_short_edge_len=48", "data_randomcrop=(41, 41)",
        "gru_memory=true", "reverse_infer=true", "train_opt=sgd",
        "train_long_term_mem_gap=1", "latter_mem_len=1", "train_tblog_step=1",
        "train_log_step=1", "data_workers=1"])
    (run,) = [p for p in out.iterdir()]
    stage = run / "pre_vost_2"
    saved = json.loads((stage / "config.json").read_text())
    assert saved["datasets"] == ["vost"] and saved["gru_memory"] is True
    (log,) = list((stage / "logs").iterdir())
    text = log.read_text()
    assert "step 1/20000 loss " in text and "final metrics:" in text
    assert (stage / "codes" / "managers" / "trainer.py").is_file()
    shapes = {p.name: read_png(str(p)).shape
              for p in (stage / "img_logs").iterdir()}
    assert shapes == {"00000001_img.png": (41, 41, 3),
                      "00000001_gt.png": (41, 41),
                      "00000001_pred.png": (41, 41)}


def test_trainer_draws_from_its_datasets(tmp_path):
    """Trainer builds its loader from cfg.datasets under data_root at the
    first batch; `batches` replaces it. pre_dav auto-resumes, and a run
    without a checkpoint stream starts fresh."""
    write_tree(str(tmp_path), "davis2017")
    cfg = get_config("pre_dav", model="tiny_aotl", compute_dtype="float32",
                     data_workers=0, dir_root=str(tmp_path / "results"),
                     **DATA)
    assert cfg.train_auto_resume
    trainer = Trainer(cfg, data_root=str(tmp_path), device="cpu",
                      log=lambda s: None)
    assert trainer.batches is None
    batch, shuffle = trainer.next_batch()
    ref = next(pdata.InlineBatchLoader(
        pdata.build_train_dataset(cfg, str(tmp_path)), 2, 0, 2,
        device="cpu"))
    for key in ref:
        assert torch.equal(batch[key], ref[key]), key
    assert shuffle.shape == (2, 3, 3)          # max_obj 2 + background
    given = Trainer(cfg, device="cpu", log=lambda s: None,
                    batches=iter([ref]))
    assert given.next_batch()[0] is ref
