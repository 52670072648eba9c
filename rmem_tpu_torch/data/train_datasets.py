"""Training clips from dataset trees: the VOST, DAVIS, YouTube-VOS and
VISOR samplers, the static-image clips, the constant `test` clips, and
their batch loaders.

Counterpart of `rmem_tpu/data/train_datasets.py` (VOSTrainDataset,
StaticTrainDataset, _dynamic_merge, SyntheticTrainDataset,
build_train_dataset, ConcatClipDataset and make_batch_loader's
loaders). A video clip is drawn as
there: a sequence, a reference frame kept only if it has foreground and
at most ignore_thresh of it ignored (5 tries), random gaps to the next
frames reflected at the sequence's end, an optional reversal, then
random_scale, balanced_random_crop and random_hflip, and with probability
merge_prob a second clip whose objects are drawn over the first's
(_dynamic_merge). The batch takes batch_size clips, sets labels above
max_obj (but not 255) to 0 and clips obj_nums to max_obj.

The host reads the files and makes every random draw, from one
np.random.RandomState, in the JAX package's order (sequence, reference,
gaps, reversal, scale, crop windows, flip, merge, and the weighted choice
of dataset before each clip), and does the labels' work: labels are read
by utils/image.read_png and resized by resize_label's index rule, so for a
seed the labels and obj_nums equal the JAX loader's. The pixel work runs
on the loader's device: the JPEG decode (nvJPEG and the colour kernel on
the card, cv2 on the CPU: data/jpeg.py), the cubic scale, the crop with
its zero padding, the flip, the merge and the normalisation. On the card
none of it falls back to the host.

`make_batch_loader` follows the JAX package's num_workers rule: 0 loads
each batch in the caller's thread; more gives one prefetch thread that
prepares batch i + 1 on a CUDA stream of its own while step i runs (the
pixel work is on the card, so more host threads would only share the
GIL). Its batches are the inline loader's at the same seed, in order.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rmem_tpu_torch.data.jpeg import read_jpeg
from rmem_tpu_torch.data.transforms import (balanced_random_crop,
                                            normalize_pixels, random_hflip,
                                            random_scale)
from rmem_tpu_torch.utils.image import decode_png, read_png

Device = Union[str, torch.device]


def read_frame(path: str, device: torch.device) -> torch.Tensor:
    """uint8 [H, W, 3] RGB of a .jpg (data/jpeg.read_jpeg) or a .png
    (palette and grey expanded, as cv2.imread does) on `device`."""
    if not path.endswith(".png"):
        return read_jpeg(path, device)
    with open(path, "rb") as f:
        pix, palette = decode_png(f.read())
    if pix.ndim == 2:
        pix = palette[pix] if palette is not None else np.repeat(
            pix[..., None], 3, axis=-1)
    return torch.from_numpy(np.ascontiguousarray(pix[..., :3])).to(device)


class SyntheticTrainDataset:
    """The `test` dataset: zero frames, every pixel object 1."""

    def __init__(self, seq_len: int = 5, hw=(465, 465), length: int = 3000):
        self.seq_len = seq_len
        self.hw = tuple(hw)
        self.length = length

    def __len__(self):
        return self.length

    def sample_clip(self, rng: np.random.RandomState, device: Device):
        h, w = self.hw
        imgs = torch.zeros((self.seq_len, h, w, 3), dtype=torch.float32,
                           device=device)
        return imgs, np.ones((self.seq_len, h, w), np.int32), 1


class VOSTrainDataset:
    """Clips of the sequences `seq_names` (each `repeat` times) under
    image_root/<seq>/ (.jpg, else .png) and label_root/<seq>/*.png, the
    frames listed by the label directory."""

    def __init__(self, image_root: str, label_root: str, seq_names: List[str],
                 seq_len: int = 15, rand_gap: int = 3, repeat: int = 1,
                 rand_reverse: bool = True, crop_hw=(465, 465),
                 ignore_thresh: float = 0.2, merge_prob: float = 0.2,
                 ignore_in_merge: bool = True,
                 short_edge: int = 480, min_scale: float = 0.7,
                 max_scale: float = 1.3, flip_prob: float = 0.5):
        self.image_root = image_root
        self.label_root = label_root
        self.seq_names = seq_names * repeat
        self.seq_len = seq_len
        self.rand_gap = rand_gap
        self.rand_reverse = rand_reverse
        self.crop_hw = tuple(crop_hw)
        self.ignore_thresh = ignore_thresh
        self.merge_prob = merge_prob
        self.ignore_in_merge = ignore_in_merge
        self.short_edge = short_edge
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.flip_prob = flip_prob
        self._frames_cache: Dict[str, List[str]] = {}

    def __len__(self):
        return len(self.seq_names)

    def _frames(self, seq: str) -> List[str]:
        if seq not in self._frames_cache:
            self._frames_cache[seq] = sorted(
                os.listdir(os.path.join(self.label_root, seq)))
        return self._frames_cache[seq]

    def _image_path(self, seq: str, label_name: str) -> str:
        stem = os.path.splitext(label_name)[0]
        for ext in (".jpg", ".png"):
            p = os.path.join(self.image_root, seq, stem + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no image for {seq}/{label_name} under "
                                f"{self.image_root}")

    def _sample_indices(self, n: int, rng) -> List[int]:
        """The reference, then gaps of 1..rand_gap, reflected at the end."""
        cur = rng.randint(0, n)
        idxs = [cur]
        for _ in range(self.seq_len - 1):
            cur = cur + rng.randint(1, self.rand_gap + 1)
            if cur >= n:
                cur = max(min(2 * (n - 1) - cur, n - 1), 0)
            idxs.append(cur)
        return idxs

    def _sample_raw_clip(self, rng) -> Tuple[List[str], List[np.ndarray]]:
        """(image paths, labels) of a clip whose first frame has
        foreground and at most ignore_thresh ignored, in 5 tries (else the
        last)."""
        for _ in range(5):
            seq = self.seq_names[rng.randint(0, len(self.seq_names))]
            frames = self._frames(seq)
            if len(frames) == 0:
                continue
            idxs = self._sample_indices(len(frames), rng)
            if self.rand_reverse and rng.rand() < 0.5:
                idxs = idxs[::-1]
            paths = [self._image_path(seq, frames[i]) for i in idxs]
            labels = [read_png(os.path.join(self.label_root, seq, frames[i]))
                      for i in idxs]
            ref = labels[0]
            fg = ((ref > 0) & (ref != 255)).sum()
            if fg > 0 and (ref == 255).mean() <= self.ignore_thresh:
                return paths, labels
        return paths, labels

    def _clip(self, rng, device: torch.device):
        """One augmented clip: (pixels [T, h, w, 3] f32 0..255 on device,
        uint8 labels, object count)."""
        paths, labels = self._sample_raw_clip(rng)
        imgs = torch.stack([read_frame(p, device) for p in paths])
        imgs, labels = random_scale(imgs, labels, rng, self.short_edge,
                                    self.min_scale, self.max_scale)
        imgs, labels, obj_num = balanced_random_crop(
            imgs, labels, rng, self.crop_hw, ignore_thresh=self.ignore_thresh)
        imgs, labels = random_hflip(imgs, labels, rng, self.flip_prob)
        return imgs, labels, obj_num

    def sample_clip(self, rng: np.random.RandomState, device: Device):
        """(normalised f32 frames [T, h, w, 3] on device, int32 labels [T,
        h, w] on the host, object count)."""
        device = torch.device(device)
        imgs, labels, obj_num = self._clip(rng, device)
        if rng.rand() < self.merge_prob:
            imgs2, labels2, obj2 = self._clip(rng, device)
            imgs, labels, obj_num = dynamic_merge(
                imgs, labels, obj_num, imgs2, labels2, obj2,
                self.ignore_in_merge)
        return (normalize_pixels(imgs), np.stack(labels).astype(np.int32),
                obj_num)


def dynamic_merge(imgs1: torch.Tensor, labels1: Sequence[np.ndarray],
                  n1: int, imgs2: torch.Tensor,
                  labels2: Sequence[np.ndarray], n2: int,
                  ignore_in_merge: bool):
    """Clip 2's objects over clip 1: its foreground pixels replace clip 1's
    in the frames and the labels (its ids shifted by n1); with
    ignore_in_merge a pixel ignored in either clip is ignored."""
    out = []
    for lb1, lb2 in zip(labels1, labels2):
        fg2 = (lb2 > 0) & (lb2 != 255)
        lab = lb1.copy()
        lab[fg2] = (lb2[fg2] + n1).astype(lb1.dtype)
        if ignore_in_merge:
            lab[(lb1 == 255) | (lb2 == 255)] = 255
        out.append(lab)
    fg2 = np.stack([(lb > 0) & (lb != 255) for lb in labels2])
    mask = torch.from_numpy(fg2).to(imgs1.device, non_blocking=True)
    return torch.where(mask[..., None], imgs2, imgs1), out, n1 + n2


class StaticTrainDataset:
    """Static-image pretraining: one image jittered into a clip of
    seq_len frames (data/image_transforms.py). Frame 0 is the image,
    flipped with p 0.5; each later frame independently flips with p 0.3,
    then ColorJitter(.1, .1, .1, .03), then RandomAffine(20 degrees,
    translate 0.1, scale 0.9-1.1, shear 10, bicubic, fill (124, 116,
    104)); every frame then takes its own RandomResizedCrop(crop_hw, scale
    0.8-1), and compact_relabel numbers the objects by frame 0's (shuffled)
    list, at most max_obj_n. A clip with no object, or with probability
    merge_prob, has a second clip's objects drawn over it
    (dynamic_merge). Frames are read by read_frame on the device and
    masks by read_png on the host."""

    def __init__(self, image_root: str, label_root: str, names: List[str],
                 seq_len: int = 5, crop_hw=(465, 465), max_obj_n: int = 10,
                 merge_prob: float = 0.2, dynamic_merge: bool = True,
                 ignore_in_merge: bool = False):
        from rmem_tpu_torch.data import image_transforms as it
        self.image_root = image_root
        self.label_root = label_root
        self.names = names
        self.seq_len = seq_len
        self.crop_hw = tuple(crop_hw)
        self.max_obj_n = max_obj_n
        self.merge_prob = merge_prob
        self.dynamic_merge = dynamic_merge
        self.ignore_in_merge = ignore_in_merge
        self.jitter = it.ColorJitter(0.1, 0.1, 0.1, 0.03)
        self.affine = it.RandomAffine(degrees=20, translate=(0.1, 0.1),
                                      scale=(0.9, 1.1), shear=10,
                                      fillcolor=(124, 116, 104))
        self.resized_crop = it.RandomResizedCrop(self.crop_hw,
                                                 scale=(0.8, 1.0))

    def __len__(self):
        return len(self.names)

    def _clip(self, rng, device: torch.device):
        """(uint8 frames [T, h, w, 3] on device, int32 labels, object
        count) of one image."""
        from rmem_tpu_torch.data import image_transforms as it
        name = self.names[rng.randint(0, len(self.names))]
        img0 = read_frame(os.path.join(self.image_root, name), device)
        mask0 = read_png(os.path.join(
            self.label_root, os.path.splitext(name)[0] + ".png"))
        if mask0.ndim != 2:
            raise ValueError(f"{name}: the mask must be a palette or grey "
                             "PNG")
        mask0 = mask0.astype(np.uint8)
        if rng.rand() < 0.5:
            img0, mask0 = it.hflip(img0), it.hflip(mask0)
        imgs, labels, obj_list = [], [], None
        for i in range(self.seq_len):
            img, mask = img0, mask0
            if i > 0:
                if rng.rand() < 0.3:
                    img, mask = it.hflip(img), it.hflip(mask)
                img = self.jitter(rng, img)
                img, mask = self.affine(rng, img, mask)
            img, mask = self.resized_crop(rng, img, mask)
            lab, obj_list = it.compact_relabel(mask, obj_list, rng,
                                               self.max_obj_n)
            imgs.append(img)
            labels.append(lab)
        return torch.stack(imgs), labels, len(obj_list)

    def sample_clip(self, rng: np.random.RandomState, device: Device):
        """(normalised f32 frames [T, h, w, 3] on device, int32 labels [T,
        h, w] on the host, object count)."""
        device = torch.device(device)
        imgs, labels, obj_num = self._clip(rng, device)
        if self.dynamic_merge and (obj_num == 0
                                   or rng.rand() < self.merge_prob):
            imgs2, labels2, obj2 = self._clip(rng, device)
            imgs, labels, obj_num = dynamic_merge(
                imgs, labels, obj_num, imgs2, labels2, obj2,
                self.ignore_in_merge)
        return (normalize_pixels(imgs), np.stack(labels).astype(np.int32),
                obj_num)


class ConcatClipDataset:
    """Each clip from one of the datasets, chosen with probability
    proportional to its length."""

    def __init__(self, datasets):
        self.datasets = datasets

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def sample_clip(self, rng: np.random.RandomState, device: Device):
        weights = np.array([len(d) for d in self.datasets], np.float64)
        i = rng.choice(len(self.datasets), p=weights / weights.sum())
        return self.datasets[i].sample_clip(rng, device)


def _read_list(path: str) -> List[str]:
    with open(path) as f:
        return [s.strip() for s in f if s.strip()]


def build_train_dataset(cfg, data_root: Optional[str] = None
                        ) -> ConcatClipDataset:
    """The datasets cfg.datasets names under data_root (else cfg.dir_data),
    each in its layout:

    - vost: VOST/JPEGImages_10fps, VOST/Annotations, VOST/ImageSets/
      train.txt;
    - davis2017 (or davis): DAVIS/JPEGImages/480p, DAVIS/Annotations/480p,
      DAVIS/ImageSets/2017/train.txt;
    - youtubevos: YTB/2019/train/JPEGImages and Annotations, every
      sequence of Annotations;
    - visor: VISOR/JPEGImages, VISOR/Annotations, VISOR/ImageSets/
      train.txt;
    - static: Static/JPEGImages and Static/Annotations/<stem>.png, every
      image, sorted by name (StaticTrainDataset);
    - test: constant synthetic clips."""
    root = data_root or cfg.dir_data
    scale = dict(short_edge=cfg.data_short_edge_len,
                 min_scale=cfg.data_min_scale_factor,
                 max_scale=cfg.data_max_scale_factor,
                 flip_prob=cfg.data_randomflip, seq_len=cfg.data_seq_len,
                 crop_hw=cfg.data_randomcrop,
                 merge_prob=cfg.data_dynamic_merge_prob)
    datasets = []
    for name in cfg.datasets:
        if name == "test":
            datasets.append(SyntheticTrainDataset(cfg.data_seq_len,
                                                  cfg.data_randomcrop))
        elif name == "vost":
            base = os.path.join(root, "VOST")
            datasets.append(VOSTrainDataset(
                os.path.join(base, "JPEGImages_10fps"),
                os.path.join(base, "Annotations"),
                _read_list(os.path.join(base, "ImageSets", "train.txt")),
                rand_gap=cfg.data_random_gap_vost,
                repeat=cfg.data_vost_repeat,
                ignore_thresh=cfg.data_vost_ignore_thresh,
                ignore_in_merge=cfg.ignore_in_merge, **scale))
        elif name in ("davis2017", "davis"):
            base = os.path.join(root, "DAVIS")
            datasets.append(VOSTrainDataset(
                os.path.join(base, "JPEGImages", "480p"),
                os.path.join(base, "Annotations", "480p"),
                _read_list(os.path.join(base, "ImageSets", "2017",
                                        "train.txt")),
                rand_gap=cfg.data_random_gap_davis,
                repeat=cfg.data_davis_repeat, **scale))
        elif name == "youtubevos":
            base = os.path.join(root, "YTB", "2019", "train")
            datasets.append(VOSTrainDataset(
                os.path.join(base, "JPEGImages"),
                os.path.join(base, "Annotations"),
                sorted(os.listdir(os.path.join(base, "Annotations"))),
                rand_gap=cfg.data_random_gap_ytb, **scale))
        elif name == "visor":
            base = os.path.join(root, "VISOR")
            datasets.append(VOSTrainDataset(
                os.path.join(base, "JPEGImages"),
                os.path.join(base, "Annotations"),
                _read_list(os.path.join(base, "ImageSets", "train.txt")),
                rand_gap=cfg.data_random_gap_visor,
                ignore_thresh=cfg.data_visor_ignore_thresh,
                ignore_in_merge=cfg.ignore_in_merge, **scale))
        elif name == "static":
            base = os.path.join(root, "Static")
            datasets.append(StaticTrainDataset(
                os.path.join(base, "JPEGImages"),
                os.path.join(base, "Annotations"),
                sorted(os.listdir(os.path.join(base, "JPEGImages"))),
                seq_len=cfg.data_seq_len, crop_hw=cfg.data_randomcrop,
                max_obj_n=cfg.model_max_obj_num,
                merge_prob=cfg.data_dynamic_merge_prob,
                ignore_in_merge=cfg.ignore_in_merge))
        else:
            raise NotImplementedError(f"train dataset {name!r}")
    return ConcatClipDataset(datasets)


class InlineBatchLoader:
    """Batches loaded in the caller's thread: a dict of imgs [B, T, H, W, 3]
    f32, labels [B, T, H, W] int32 and obj_nums [B] int32, on `device`."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 max_obj: int = 10, device: Device = "cpu"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_obj = max_obj
        self.device = torch.device(device)
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        imgs, labels, obj_nums = [], [], []
        for _ in range(self.batch_size):
            im, lb, n = self.dataset.sample_clip(self.rng, self.device)
            imgs.append(im)
            labels.append(np.where((lb > self.max_obj) & (lb != 255), 0,
                                   lb).astype(np.int32))
            obj_nums.append(min(n, self.max_obj))
        host = {"labels": torch.from_numpy(np.stack(labels)),
                "obj_nums": torch.tensor(obj_nums, dtype=torch.int32)}
        if self.device.type == "cuda":     # no wait for the queued work
            host = {k: v.pin_memory() for k, v in host.items()}
        return {"imgs": torch.stack(imgs),
                **{k: v.to(self.device, non_blocking=True)
                   for k, v in host.items()}}

    def close(self):
        pass


class PrefetchBatchLoader:
    """InlineBatchLoader's batches, in order, each prepared on a thread one
    batch ahead of the caller; on the card on a CUDA stream of its own,
    each batch reaching the caller's stream through an event."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 max_obj: int = 10, device: Device = "cpu"):
        self._inline = InlineBatchLoader(dataset, batch_size, seed, max_obj,
                                         device)
        self.device = self._inline.device
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        dev = self.device
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        try:
            with (torch.cuda.device(dev) if side is not None
                  else contextlib.nullcontext()), \
                    (torch.cuda.stream(side) if side is not None
                     else contextlib.nullcontext()):
                while not self._stop.is_set():
                    batch = next(self._inline)
                    ready = None
                    if side is not None:
                        ready = torch.cuda.Event()
                        ready.record(side)
                    self._put((batch, ready))
        except Exception as e:      # raised in the caller's thread
            self._put(e)

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def close(self):
        self._stop.set()
        while self._thread.is_alive():     # unblock a put on the full queue
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()


def make_batch_loader(dataset, batch_size: int, seed: int = 0,
                      max_obj: int = 10, num_workers: int = 4,
                      device: Device = "cpu"):
    """InlineBatchLoader for num_workers <= 0, else PrefetchBatchLoader."""
    cls = InlineBatchLoader if num_workers <= 0 else PrefetchBatchLoader
    return cls(dataset, batch_size, seed, max_obj, device)
