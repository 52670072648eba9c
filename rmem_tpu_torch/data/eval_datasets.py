"""Eval datasets: the videos of VOST, DAVIS, YouTube-VOS and Long Videos as
streams of frames.

Counterpart of `rmem_tpu/data/eval_datasets.py`. Each dataset gives
`VideoSequence`s; a sequence yields `Frame`s: the image as a uint8 [H, W,
3] RGB tensor on the dataset's device (decoded there, by nvJPEG on the
card), the ground-truth label where the frame has one (numpy uint8, ids
squeezed to the order in which objects first appear), and the frame's
object count and id map. A video whose later annotations bring new objects
(YouTube-VOS) is scanned once, label by label, to find where each object
first appears. The synthetic dataset keeps the JAX package's float frames,
seeded per frame.
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Union

import numpy as np
import torch

from rmem_tpu_torch.data.jpeg import read_jpeg
from rmem_tpu_torch.engine.inference import resolve_device
from rmem_tpu_torch.utils.image import read_png

Device = Union[None, str, torch.device]


@dataclass
class Frame:
    image: torch.Tensor               # uint8 (synthetic: f32) [H, W, 3] RGB
    label: Optional[np.ndarray]       # uint8 [H, W] squeezed ids, or None
    name: str
    obj_num: int
    obj_idx: List[int]                # squeezed -> original id map


@dataclass
class VideoSequence:
    """One video's frames, read lazily in order."""

    name: str
    image_root: str
    label_root: str
    images: List[str] = field(default_factory=list)
    labels: List[str] = field(default_factory=list)
    single_obj: bool = False
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        # the frame at which each object first appears
        self.obj_nums: List[int] = []
        self.obj_indices: List[List[int]] = []
        curr_objs = [0]
        for img_name in self.images:
            self.obj_nums.append(len(curr_objs) - 1)
            lbl = os.path.splitext(img_name)[0] + ".png"
            if lbl in self.labels:
                lab = self._read_label(lbl)
                for obj in np.unique(lab):
                    if obj not in curr_objs and obj != 255:
                        curr_objs.append(int(obj))
            self.obj_indices.append(curr_objs.copy())
        if len(self.obj_nums) > 1:
            self.obj_nums[0] = self.obj_nums[1]

    def __len__(self):
        return len(self.images)

    def _read_image(self, name: str) -> torch.Tensor:
        return read_jpeg(os.path.join(self.image_root, self.name, name),
                         self.device)

    def _read_label(self, name: str,
                    squeeze_idx: Optional[List[int]] = None) -> np.ndarray:
        label = read_png(os.path.join(self.label_root, self.name, name))
        if self.single_obj:
            label = (label > 0).astype(np.uint8)
        elif squeeze_idx is not None:
            out = np.zeros_like(label)
            for new_id, obj_id in enumerate(squeeze_idx):
                if obj_id == 0:
                    continue
                out += ((label == obj_id) * new_id).astype(np.uint8)
            label = out
        return label

    def first_label_file(self) -> Optional[str]:
        """The first annotation PNG, which the evaluator copies byte for
        byte into its results."""
        if not self.labels or not getattr(self, "label_root", None):
            return None
        p = os.path.join(self.label_root, self.name, self.labels[0])
        return p if os.path.isfile(p) else None

    def __iter__(self) -> Iterator[Frame]:
        for idx, img_name in enumerate(self.images):
            lbl = os.path.splitext(img_name)[0] + ".png"
            label = None
            if lbl in self.labels:
                label = self._read_label(lbl, self.obj_indices[idx])
            yield Frame(image=self._read_image(img_name), label=label,
                        name=img_name, obj_num=self.obj_nums[idx],
                        obj_idx=self.obj_indices[idx])


class _Listed:
    """A dataset of sequence names under one image root; the first
    frame's annotation drives inference, the rest are ground truth for
    scoring."""

    single_obj = False

    def __len__(self):
        return len(self.seq_names)

    def sequence(self, idx: int) -> VideoSequence:
        name = self.seq_names[idx]
        images = sorted(os.listdir(os.path.join(self.image_root, name)))
        labels = [os.path.splitext(images[0])[0] + ".png"]
        return VideoSequence(name, self.image_root, self.label_root, images,
                             labels, self.single_obj, self.device)


def _read_names(path: str) -> List[str]:
    with open(path) as f:
        return [s.strip() for s in f if s.strip()]


class VOSTestDataset(_Listed):
    """VOST: JPEGImages_10fps (JPEGImages with `oracle`), Annotations,
    ImageSets/<split>.txt."""

    def __init__(self, root: str, split: str = "val", oracle: bool = False,
                 device: Device = None):
        self.device = resolve_device(device)
        self.image_root = os.path.join(
            root, "JPEGImages" if oracle else "JPEGImages_10fps")
        self.label_root = os.path.join(root, "Annotations")
        self.seq_names = _read_names(
            os.path.join(root, "ImageSets", f"{split}.txt"))


class DAVISTestDataset(_Listed):
    """DAVIS 2017: JPEGImages/480p, Annotations/480p,
    ImageSets/<year>/<split>.txt."""

    def __init__(self, root: str, split: str = "val", year: int = 2017,
                 resolution: str = "480p", device: Device = None):
        self.device = resolve_device(device)
        self.image_root = os.path.join(root, "JPEGImages", resolution)
        self.label_root = os.path.join(root, "Annotations", resolution)
        self.seq_names = _read_names(
            os.path.join(root, "ImageSets", str(year), f"{split}.txt"))


class LongVideosTestDataset(_Listed):
    """Long Videos (1000+ frames), one object a video."""

    single_obj = True

    def __init__(self, root: str, split: str = "val",
                 device: Device = None):
        self.device = resolve_device(device)
        self.image_root = os.path.join(root, "JPEGImages")
        self.label_root = os.path.join(root, "Annotations")
        self.seq_names = _read_names(
            os.path.join(root, "ImageSets", f"{split}.txt"))


class YouTubeVOSTestDataset:
    """YouTube-VOS valid: every annotation of a video drives inference,
    so objects may first appear mid-video; `dense` runs every frame of
    the _all_frames image set against the sparse annotations."""

    def __init__(self, root: str, year: int = 2019, split: str = "valid",
                 dense: bool = False, device: Device = None):
        self.device = resolve_device(device)
        base = os.path.join(root, f"{year}", split)
        self.image_root = os.path.join(
            base + ("_all_frames" if dense else ""), "JPEGImages")
        self.label_root = os.path.join(base, "Annotations")
        self.seq_names = sorted(os.listdir(self.label_root))

    def __len__(self):
        return len(self.seq_names)

    def sequence(self, idx: int) -> VideoSequence:
        name = self.seq_names[idx]
        images = sorted(os.listdir(os.path.join(self.image_root, name)))
        labels = sorted(os.listdir(os.path.join(self.label_root, name)))
        return VideoSequence(name, self.image_root, self.label_root, images,
                             labels, device=self.device)


class _SyntheticSequence(VideoSequence):
    """num_frames seeded float frames with a 2-object first mask."""

    def __init__(self, name: str, num_frames: int = 10, hw=(240, 432),
                 device: torch.device = torch.device("cpu")):
        self.name = name
        self.hw = hw
        self.images = [f"{i:05d}.jpg" for i in range(num_frames)]
        self.labels = ["00000.png"]
        self.single_obj = False
        self.device = device
        super().__post_init__()

    def _read_image(self, name):
        # zlib.crc32, not hash(): str hashes are salted per process
        seed = zlib.crc32(f"{self.name}/{name}".encode()) % (2 ** 31)
        rng = np.random.RandomState(seed)
        img = rng.rand(*self.hw, 3).astype(np.float32) * 255.0
        return torch.from_numpy(img).to(self.device)

    def _read_label(self, name, squeeze_idx=None):
        h, w = self.hw
        label = np.zeros(self.hw, np.uint8)
        label[h // 5: h // 2, w // 5: w // 2] = 1
        label[h // 2: 4 * h // 5, w // 2: 4 * w // 5] = 2
        return label


class SyntheticEvalDataset:
    def __init__(self, num_seqs: int = 3, num_frames: int = 10,
                 hw=(240, 432), device: Device = None):
        self.device = resolve_device(device)
        self.seq_names = [f"test{i}" for i in range(num_seqs)]
        self.num_frames = num_frames
        self.hw = hw

    def __len__(self):
        return len(self.seq_names)

    def sequence(self, idx: int) -> VideoSequence:
        return _SyntheticSequence(self.seq_names[idx], self.num_frames,
                                  self.hw, self.device)


def sequence_lengths(dataset) -> Optional[List[int]]:
    """Each sequence's frame count from the dataset's index (one listdir a
    sequence, nothing decoded), or None where there is no cheap index."""
    if hasattr(dataset, "num_frames"):  # synthetic
        return [int(dataset.num_frames)] * len(dataset)
    if hasattr(dataset, "seq_names") and hasattr(dataset, "image_root"):
        try:
            return [len(os.listdir(os.path.join(dataset.image_root, n)))
                    for n in dataset.seq_names]
        except OSError:
            return None
    return None


def build_eval_dataset(cfg, data_root: Optional[str] = None,
                       device: Device = None):
    """The dataset cfg.test_dataset names, under data_root (default
    cfg.dir_data), its frames on `device` (default: the card)."""
    name = cfg.test_dataset
    root = data_root or cfg.dir_data
    if name == "test":
        return SyntheticEvalDataset(device=device)
    if name == "vost":
        return VOSTestDataset(os.path.join(root, "VOST"),
                               cfg.test_dataset_split, device=device)
    if name in ("davis2017", "davis"):
        return DAVISTestDataset(os.path.join(root, "DAVIS"),
                                cfg.test_dataset_split, device=device)
    if name == "long_videos":
        return LongVideosTestDataset(os.path.join(root, "long_videos"),
                                     cfg.test_dataset_split, device=device)
    if name == "youtubevos":
        return YouTubeVOSTestDataset(os.path.join(root, "YTB"),
                                     split="valid", device=device)
    if name == "youtubevos_dense":
        return YouTubeVOSTestDataset(os.path.join(root, "YTB"),
                                     split="valid", dense=True,
                                     device=device)
    raise NotImplementedError(f"eval dataset {name!r}")
