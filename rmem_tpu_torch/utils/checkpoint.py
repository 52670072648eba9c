"""Checkpoints in and out: the JAX package's flax msgpack files, the
reference's PyTorch .pth files, and this package's own checkpoint stream.

Counterpart of `rmem_tpu/utils/checkpoint.py`, without flax and without
the `msgpack` package (the card's machine has neither):

- `params_from_jax`: a flax parameter tree (nested mappings of arrays)
  becomes this package's state dict. The port names its modules after the
  flax paths, so the mapping is a fixed rule: the path joined with dots; a
  `kernel` leaf becomes `weight`, a Dense kernel [in, out] transposed to
  Linear's [out, in] and a conv kernel HWIO permuted to OIHW; every other
  leaf keeps its name and layout.
- `load_msgpack`: a file that `flax.serialization.to_bytes` wrote (the JAX
  package's `save_pytree`) as nested dicts of numpy arrays, read by this
  module's own decoder of the msgpack subset flax writes. bfloat16 leaves
  are widened to f32, which is exact.
- `convert_torch_checkpoint` and `load_pretrained`: the reference's
  AOT / DeAOT state dicts, on any of its encoders (ResNet, MobileNetV2,
  MobileNetV3, ResNeSt, Swin, the top-down ResNet-50), onto the flax-path
  tree, in the JAX converter's numpy expressions (conv OIHW -> HWIO,
  linear [out, in] -> [in, out], transposed conv [in, out, kh, kw] ->
  flipped [kh, kw, in, out], BN folded into scale and bias, `module.`
  stripped, the id bank padded from 11 to 12 input channels), then through
  `params_from_jax`, so that a file loads bit for bit as the JAX package
  loads it.
- `load_file`: every file of either kind is read with
  `torch.load(weights_only=True)`: the released files are plain state
  dicts, and a file that needs other pickles raises.
- `save_checkpoint`, `latest_checkpoint`, `load_latest_checkpoint`: the
  trainer's stream of `torch.save` files (`<prefix><step>.pt`), written to
  a temporary name and renamed into place, pruned to the newest
  `max_keep`, and read back newest first, past any file that fails to
  load.
"""

from __future__ import annotations

import os
import pickle
import re
import struct
from collections.abc import Mapping
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# flax params tree -> state dict
# ---------------------------------------------------------------------------

def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(val)


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax params tree (nested mappings of arrays) -> f32 state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(tree):
        arr = np.asarray(arr, dtype=np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{'/'.join(path)}: kernel of rank "
                                 f"{arr.ndim}")
            leaf = "weight"
        out[".".join(path[:-1] + (leaf,))] = torch.from_numpy(
            np.array(arr, order="C", copy=True))
    return out


def flax_path(name: str) -> Tuple[str, ...]:
    """The flax path of a state-dict name: params_from_jax's rule undone
    (flax trees have no `weight` leaves)."""
    path = tuple(name.split("."))
    return path[:-1] + ("kernel",) if path[-1] == "weight" else path


def flax_shape(name: str, shape) -> Tuple[int, ...]:
    """The flax layout's shape of a state-dict entry's."""
    shape = tuple(shape)
    if name.rsplit(".", 1)[-1] != "weight":
        return shape
    if len(shape) == 2:
        return shape[::-1]
    o, i, h, w = shape
    return (h, w, i, o)


# ---------------------------------------------------------------------------
# flax msgpack, read
# ---------------------------------------------------------------------------

class ExtType(NamedTuple):
    """An extension value the decoder has no meaning for (equal, as a
    tuple, to the `msgpack` package's ExtType of the same code and
    data)."""

    code: int
    data: bytes


# flax.serialization._MsgpackExtType
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
          0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# (length field's format, payload kind) of the sized types
_SIZED = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
          0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xdc: (">H", "array"), 0xdd: (">I", "array"),
          0xde: (">H", "map"), 0xdf: (">I", "map")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    """A msgpack decoder over one buffer: maps to dicts, arrays to lists,
    str to str, bin to bytes, ext to `ext_hook(code, data)`."""

    def __init__(self, buf, ext_hook):
        self.buf = memoryview(buf)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data is truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def sized(self, kind: str, n: int):
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            out = {}
            for _ in range(n):
                key = self.value()
                out[key] = self.value()
            return out
        code = self.unpack(">b")                 # ext
        return self.ext_hook(code, bytes(self.take(n)))

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0x8f:
            return self.sized("map", b & 0x0f)
        if b <= 0x9f:
            return self.sized("array", b & 0x0f)
        if b <= 0xbf:
            return self.sized("str", b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            return self.sized(kind, self.unpack(fmt))
        if b in _FIXEXT:
            return self.sized("ext", _FIXEXT[b])
        raise ValueError(f"msgpack type byte 0x{b:02x} at {self.pos - 1}")


def unpackb(data: bytes, ext_hook=ExtType):
    """One msgpack object from `data` (which it must fill exactly)."""
    reader = _Reader(data, ext_hook)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the "
                         "msgpack object")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray encoding: msgpack of (shape, dtype name, C-order
    bytes). bfloat16, which numpy lacks, is widened to f32 from its bits."""
    shape, dtype, raw = unpackb(data)
    if dtype == "bfloat16":
        bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(raw, np.dtype(dtype)).copy()
    return arr.reshape(shape)


def _flax_ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    return ExtType(code, data)


def _seq(d: dict) -> list:
    """flax's _tuple_to_dict undone: keys "0", "1", ... -> a list."""
    return [d[str(i)] for i in range(len(d))]


def _unchunk(tree):
    """flax's chunked arrays (`__msgpack_chunked_array__` dicts, written
    for arrays over MAX_CHUNK_SIZE bytes) joined back, in place."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        flat = np.concatenate(_seq(tree["chunks"]))
        return flat.reshape(_seq(tree["shape"]))
    for key, val in tree.items():
        tree[key] = _unchunk(val)
    return tree


def msgpack_restore(data: bytes):
    """`flax.serialization.msgpack_restore`'s result (bfloat16 widened to
    f32): nested dicts of numpy arrays and Python values."""
    return _unchunk(unpackb(data, _flax_ext))


def load_msgpack(path: str):
    """A flax msgpack file (the JAX package's `save_pytree`)."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# ---------------------------------------------------------------------------
# the reference's .pth files
# ---------------------------------------------------------------------------

BN_EPS = 1e-5


def _fold_bn(sd: Dict[str, np.ndarray], prefix: str):
    gamma = sd[f"{prefix}.weight"]
    beta = sd[f"{prefix}.bias"]
    mean = sd[f"{prefix}.running_mean"]
    var = sd[f"{prefix}.running_var"]
    scale = gamma / np.sqrt(var + BN_EPS)
    bias = beta - mean * scale
    return {"scale": scale.astype(np.float32),
            "bias": bias.astype(np.float32)}


def _conv(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def _dense(w: np.ndarray) -> np.ndarray:
    """[out, in] -> [in, out]; 1x1 conv weights squeeze first."""
    if w.ndim == 4:  # 1x1 conv used as a dense layer
        w = w[:, :, 0, 0]
    return np.transpose(w, (1, 0))


def _conv_t(w: np.ndarray) -> np.ndarray:
    """PyTorch ConvTranspose2d [in, out, kh, kw] -> flax ConvTranspose
    [kh, kw, in, out], spatially flipped (flax's kernel is not)."""
    return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]


def torch_state_dict(obj) -> Dict[str, np.ndarray]:
    """A loaded reference checkpoint -> {name: numpy array}: a
    `state_dict` entry unwrapped, `module.` prefixes stripped."""
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("module.")
        out[k] = v.numpy() if hasattr(v, "numpy") else np.asarray(v)
    return out


def load_file(path: str, map_location="cpu"):
    """torch.load(weights_only=True): tensors, numbers, strings and
    containers of them. A file that needs other pickles raises ValueError.
    Among such files are the trainer's from before its checkpoint stream,
    which pickled the host RNG as a numpy tuple; their weights are under
    `state` in torch.load(path, weights_only=False), for a file trusted."""
    try:
        return torch.load(path, map_location=map_location, weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path} holds objects other than tensors and numbers, which "
            "this package does not unpickle (a trainer file from before "
            "the checkpoint stream keeps its RNG as a numpy tuple; its "
            "weights are under 'state' in torch.load(path, "
            f"weights_only=False)): {e}") from e


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    return torch_state_dict(load_file(path))


class _RecordingDict(dict):
    """Tracks which source keys a conversion actually read, so unconsumed
    checkpoint content is reported instead of silently dropped."""

    def __init__(self, sd):
        super().__init__(sd)
        self.consumed = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return super().__getitem__(k)


# Keys that exist in reference checkpoints but are dead at runtime in the
# reference itself, so dropping them loses nothing:
# - Q_time_encode / K_time_encode: constructed when TIME_ENCODE=True but
#   never called anywhere (the engine computes a sinusoidal table and
#   never passes it to the transformer, and the MLPs have no call site).
# - num_batches_tracked: torch BN bookkeeping, irrelevant once BN is folded.
_KNOWN_DEAD_PATTERNS = (
    re.compile(r"\.(Q|K)_time_encode\.\d+\.(weight|bias)$"),
    re.compile(r"num_batches_tracked$"),
)


def classify_unconsumed(sd: _RecordingDict) -> Tuple[List[str], List[str]]:
    """Split unread source keys into (known-dead, unexpected)."""
    dead, unexpected = [], []
    for k in sd:
        if k in sd.consumed:
            continue
        if any(p.search(k) for p in _KNOWN_DEAD_PATTERNS):
            dead.append(k)
        else:
            unexpected.append(k)
    return sorted(dead), sorted(unexpected)


def _convert_resnet(sd, out: Dict[Tuple[str, ...], np.ndarray],
                    layers=(3, 4, 6)):
    p = ("encoder",)
    out[p + ("conv1", "kernel")] = _conv(sd["encoder.conv1.weight"])
    for k, v in _fold_bn(sd, "encoder.bn1").items():
        out[p + ("bn1", k)] = v
    for stage, blocks in enumerate(layers, start=1):
        for i in range(blocks):
            tp = f"encoder.layer{stage}.{i}"
            fp = p + (f"layer{stage}_{i}",)
            for c in ("conv1", "conv2", "conv3"):
                out[fp + (c, "kernel")] = _conv(sd[f"{tp}.{c}.weight"])
            for b in ("bn1", "bn2", "bn3"):
                for k, v in _fold_bn(sd, f"{tp}.{b}").items():
                    out[fp + (b, k)] = v
            if f"{tp}.downsample.0.weight" in sd:
                out[fp + ("downsample_conv", "kernel")] = _conv(
                    sd[f"{tp}.downsample.0.weight"])
                for k, v in _fold_bn(sd, f"{tp}.downsample.1").items():
                    out[fp + ("downsample_bn", k)] = v


def _convert_swin(sd, out: Dict[Tuple[str, ...], np.ndarray],
                  depths=(2, 2, 18)):
    """Swin-B trunk (mmseg-style naming: patch_embed.proj, layers.i.blocks.j,
    layers.i.downsample, norm{i}) -> models/encoders/swin.py names. The dead
    32x stage (layers.3) is ignored."""
    e = ("encoder",)
    out[e + ("patch_embed", "kernel")] = _conv(
        sd["encoder.patch_embed.proj.weight"])
    out[e + ("patch_embed", "bias")] = sd["encoder.patch_embed.proj.bias"]
    _put_norm(sd, out, "encoder.patch_embed.norm", e + ("patch_norm",))
    for i, depth in enumerate(depths):
        for j in range(depth):
            t = f"encoder.layers.{i}.blocks.{j}"
            f = e + (f"stage{i}_block{j}",)
            _put_norm(sd, out, f"{t}.norm1", f + ("norm1",))
            _put_dense(sd, out, f"{t}.attn.qkv", f + ("attn", "qkv"))
            _put_dense(sd, out, f"{t}.attn.proj", f + ("attn", "proj"))
            out[f + ("attn", "relative_position_bias_table")] = \
                sd[f"{t}.attn.relative_position_bias_table"]
            _put_norm(sd, out, f"{t}.norm2", f + ("norm2",))
            _put_dense(sd, out, f"{t}.mlp.fc1", f + ("fc1",))
            _put_dense(sd, out, f"{t}.mlp.fc2", f + ("fc2",))
        _put_norm(sd, out, f"encoder.norm{i}", e + (f"out_norm{i}",))
        if i < len(depths) - 1:
            t = f"encoder.layers.{i}.downsample"
            f = e + (f"merge{i}",)
            _put_norm(sd, out, f"{t}.norm", f + ("norm",))
            _put_dense(sd, out, f"{t}.reduction", f + ("reduction",))


def _convert_mobilenetv2(sd, out: Dict[Tuple[str, ...], np.ndarray]):
    """Reference MobileNetV2 naming (features.N nested Sequentials,
    mobilenetv2.py:62-205) -> models/encoders/mobilenet.py names."""
    e = ("encoder",)
    out[e + ("stem", "conv", "kernel")] = _conv(
        sd["encoder.features.0.0.weight"])
    for k, v in _fold_bn(sd, "encoder.features.0.1").items():
        out[e + ("stem", "bn", k)] = v
    # inverted residual blocks: features.1..17
    setting = [(1, 1), (6, 2), (6, 3), (6, 4), (6, 3), (6, 3), (6, 1)]
    idx = 1
    for t_exp, n in setting:
        for _ in range(n):
            tp = f"encoder.features.{idx}.conv"
            f = e + (f"block{idx}",)
            if t_exp != 1:
                out[f + ("pw", "conv", "kernel")] = _conv(
                    sd[f"{tp}.0.0.weight"])
                for k, v in _fold_bn(sd, f"{tp}.0.1").items():
                    out[f + ("pw", "bn", k)] = v
                dw, pwl, bno = f"{tp}.1", f"{tp}.2", f"{tp}.3"
            else:
                dw, pwl, bno = f"{tp}.0", f"{tp}.1", f"{tp}.2"
            out[f + ("dw", "conv", "kernel")] = _conv(sd[f"{dw}.0.weight"])
            for k, v in _fold_bn(sd, f"{dw}.1").items():
                out[f + ("dw", "bn", k)] = v
            out[f + ("pw_linear", "kernel")] = _conv(sd[f"{pwl}.weight"])
            for k, v in _fold_bn(sd, bno).items():
                out[f + ("bn_out", k)] = v
            idx += 1
    out[e + ("head", "conv", "kernel")] = _conv(
        sd["encoder.features.18.0.weight"])
    for k, v in _fold_bn(sd, "encoder.features.18.1").items():
        out[e + ("head", "bn", k)] = v


def _convert_mobilenetv3(sd, out: Dict[Tuple[str, ...], np.ndarray]):
    """Reference MobileNetV3-Large naming (flat block Sequentials,
    mobilenetv3.py:78-205) -> models/encoders/mobilenetv3.py names."""
    e = ("encoder",)
    out[e + ("stem", "kernel")] = _conv(sd["encoder.features.0.0.weight"])
    for k, v in _fold_bn(sd, "encoder.features.0.1").items():
        out[e + ("stem_bn", k)] = v
    # (k, t, c, SE, HS, s) rows of the cfgs table (mobilenetv3.py:150-166);
    # only block 1 has inp == hidden (t=1), which drops the leading pw conv
    # and shifts every index down by 3
    se_blocks = {4, 5, 6, 11, 12, 13, 14, 15}
    for idx in range(1, 16):
        tp = f"encoder.features.{idx}.conv"
        f = e + (f"block{idx}",)
        has_pw = f"{tp}.0.weight" in sd and sd[f"{tp}.0.weight"].shape[2] == 1
        if has_pw:
            out[f + ("pw", "kernel")] = _conv(sd[f"{tp}.0.weight"])
            for k, v in _fold_bn(sd, f"{tp}.1").items():
                out[f + ("pw_bn", k)] = v
            dw, dwbn, se, pwl, bno = (f"{tp}.3", f"{tp}.4", f"{tp}.5",
                                      f"{tp}.7", f"{tp}.8")
        else:
            dw, dwbn, se, pwl, bno = (f"{tp}.0", f"{tp}.1", f"{tp}.3",
                                      f"{tp}.4", f"{tp}.5")
        out[f + ("dw", "kernel")] = _conv(sd[f"{dw}.weight"])
        for k, v in _fold_bn(sd, dwbn).items():
            out[f + ("dw_bn", k)] = v
        if idx in se_blocks:
            _put_dense(sd, out, f"{se}.fc.0", f + ("se", "fc1"))
            _put_dense(sd, out, f"{se}.fc.2", f + ("se", "fc2"))
        out[f + ("pw_linear", "kernel")] = _conv(sd[f"{pwl}.weight"])
        for k, v in _fold_bn(sd, bno).items():
            out[f + ("out_bn", k)] = v
    out[e + ("head", "kernel")] = _conv(sd["encoder.conv.0.weight"])
    for k, v in _fold_bn(sd, "encoder.conv.1").items():
        out[e + ("head_bn", k)] = v


def _convert_resnest(sd, out: Dict[Tuple[str, ...], np.ndarray],
                     layers=(3, 4, 6)):
    """ResNeSt deep-stem + split-attention naming (resnest/resnet.py:27-357,
    splat.py:15-115) -> models/encoders/resnest.py names."""
    e = ("encoder",)
    # deep stem: conv1 = Sequential(conv,bn,relu,conv,bn,relu,conv) + bn1
    for ti, fn, bn in ((0, "stem0", "stem0_bn"), (3, "stem1", "stem1_bn"),
                       (6, "stem2", "bn1")):
        out[e + (fn, "kernel")] = _conv(sd[f"encoder.conv1.{ti}.weight"])
        bkey = "encoder.bn1" if bn == "bn1" else f"encoder.conv1.{ti + 1}"
        for k, v in _fold_bn(sd, bkey).items():
            out[e + (bn, k)] = v
    for stage, blocks in enumerate(layers, start=1):
        for i in range(blocks):
            tp = f"encoder.layer{stage}.{i}"
            fp = e + (f"layer{stage}_{i}",)
            for c in ("conv1", "conv3"):
                out[fp + (c, "kernel")] = _conv(sd[f"{tp}.{c}.weight"])
            for b in ("bn1", "bn3"):
                for k, v in _fold_bn(sd, f"{tp}.{b}").items():
                    out[fp + (b, k)] = v
            sp = fp + ("conv2",)
            out[sp + ("conv", "kernel")] = _conv(sd[f"{tp}.conv2.conv.weight"])
            for k, v in _fold_bn(sd, f"{tp}.conv2.bn0").items():
                out[sp + ("bn0", k)] = v
            out[sp + ("fc1", "kernel")] = _conv(sd[f"{tp}.conv2.fc1.weight"])
            out[sp + ("fc1", "bias")] = sd[f"{tp}.conv2.fc1.bias"]
            for k, v in _fold_bn(sd, f"{tp}.conv2.bn1").items():
                out[sp + ("bn1", k)] = v
            out[sp + ("fc2", "kernel")] = _conv(sd[f"{tp}.conv2.fc2.weight"])
            out[sp + ("fc2", "bias")] = sd[f"{tp}.conv2.fc2.bias"]
            # avg_down shortcut: Sequential(AvgPool, Conv, BN) -> indices 1,2
            if f"{tp}.downsample.1.weight" in sd:
                out[fp + ("downsample_conv", "kernel")] = _conv(
                    sd[f"{tp}.downsample.1.weight"])
                for k, v in _fold_bn(sd, f"{tp}.downsample.2").items():
                    out[fp + ("downsample_bn", k)] = v


def _convert_topdown(sd, out: Dict[Tuple[str, ...], np.ndarray]):
    """The top-down ResNet-50: the ResNet trunk plus the feedback decoders,
    the prompt and the top-down transform."""
    _convert_resnet(sd, out)
    e = ("encoder",)
    # decoders.0 = Sequential(ConvTranspose(bias), Decode_Block(k7 s2))
    out[e + ("dec0", "unpool", "kernel")] = _conv_t(
        sd["encoder.decoders.0.0.weight"])
    out[e + ("dec0", "unpool", "bias")] = sd["encoder.decoders.0.0.bias"]
    out[e + ("dec0", "linear", "kernel")] = _conv_t(
        sd["encoder.decoders.0.1.linear.weight"])
    out[e + ("dec0", "linear2", "kernel")] = _conv(
        sd["encoder.decoders.0.1.linear2.weight"])
    for i in (1, 2, 3):
        out[e + (f"dec{i}", "linear", "kernel")] = _conv_t(
            sd[f"encoder.decoders.{i}.linear.weight"])
        out[e + (f"dec{i}", "linear2", "kernel")] = _conv(
            sd[f"encoder.decoders.{i}.linear2.weight"])
    out[e + ("prompt",)] = sd["encoder.prompt"]
    out[e + ("top_down_transform",)] = sd["encoder.top_down_transform"]


def _put_dense(sd, out, tname: str, fpath: Tuple[str, ...],
               required: bool = True):
    wkey = f"{tname}.weight"
    if wkey not in sd:
        if required:
            raise KeyError(wkey)
        return
    out[fpath + ("kernel",)] = _dense(sd[wkey])
    if f"{tname}.bias" in sd:
        out[fpath + ("bias",)] = sd[f"{tname}.bias"]


def _put_norm(sd, out, tname: str, fpath: Tuple[str, ...]):
    out[fpath + ("scale",)] = sd[f"{tname}.weight"]
    out[fpath + ("bias",)] = sd[f"{tname}.bias"]


def _convert_lstt_block(sd, out, i: int):
    t = f"LSTT.layers.{i}"
    f = ("lstt", f"block{i}")
    _put_norm(sd, out, f"{t}.norm1", f + ("norm1",))
    for q in ("linear_Q", "linear_K", "linear_V"):
        _put_dense(sd, out, f"{t}.self_attn.{q}", f + ("self_attn", q))
    _put_dense(sd, out, f"{t}.self_attn.projection",
               f + ("self_attn", "projection"))
    _put_norm(sd, out, f"{t}.norm2", f + ("norm2",))
    for q in ("linear_Q", "linear_V", "linear_QMem", "linear_VMem"):
        _put_dense(sd, out, f"{t}.{q}", f + (q,))
    if f"{t}.norm4.weight" in sd:
        _put_norm(sd, out, f"{t}.norm4", f + ("norm4",))
    _put_dense(sd, out, f"{t}.long_term_attn.projection", f + ("long_proj",))
    _put_dense(sd, out, f"{t}.short_term_attn.projection",
               f + ("short_proj",))
    _put_norm(sd, out, f"{t}.norm3", f + ("norm3",))
    _put_dense(sd, out, f"{t}.linear1", f + ("linear1",))
    _put_dense(sd, out, f"{t}.linear2", f + ("linear2",))
    _put_norm(sd, out, f"{t}.activation.gn", f + ("activation", "gn"))
    out[f + ("activation", "conv", "kernel")] = _conv(
        sd[f"{t}.activation.conv.weight"])
    # GRU_MEMORY compressed-eviction cells: memory_grus[0] compresses the K
    # plane (kernel 2x2), memory_grus[1] the V plane (kernel 1x1); a model
    # built with gru_memory takes them (models/conv_gru.py), any other
    # reports them as `extra`
    for gi, gname in ((0, "memory_gru_k"), (1, "memory_gru_v")):
        tg = f"{t}.memory_grus.{gi}"
        if f"{tg}.conv_gru_cell.conv_gates.weight" not in sd:
            continue
        fg = f + (gname,)
        for c in ("conv_gates", "conv_can"):
            out[fg + ("cell", c, "kernel")] = _conv(
                sd[f"{tg}.conv_gru_cell.{c}.weight"])
            out[fg + ("cell", c, "bias")] = sd[f"{tg}.conv_gru_cell.{c}.bias"]
        out[fg + ("output_conv", "kernel")] = _conv(
            sd[f"{tg}.output_conv.weight"])
        out[fg + ("output_conv", "bias")] = sd[f"{tg}.output_conv.bias"]


def _convert_gpm_block(sd, out, i: int):
    t = f"LSTT.layers.{i}"
    f = ("lstt", f"block{i}")
    _put_norm(sd, out, f"{t}.norm1", f + ("norm1",))
    _put_dense(sd, out, f"{t}.linear_QV", f + ("linear_QV",))
    _put_dense(sd, out, f"{t}.linear_U", f + ("linear_U",))
    _put_dense(sd, out, f"{t}.linear_ID_V", f + ("linear_ID_V",))
    if f"{t}.linear_ID_U.weight" in sd:
        _put_dense(sd, out, f"{t}.linear_ID_U", f + ("linear_ID_U",))
        _put_norm(sd, out, f"{t}.id_norm1", f + ("id_norm1",))
    # long/short gated tails
    out[f + ("long_tail", "dw_conv", "conv", "kernel")] = _conv(
        sd[f"{t}.long_term_attn.dw_conv.conv.weight"])
    _put_dense(sd, out, f"{t}.long_term_attn.projection",
               f + ("long_tail", "projection"))
    _put_dense(sd, out, f"{t}.short_term_attn.relative_emb_k",
               f + ("relative_emb_k",))
    out[f + ("short_tail", "dw_conv", "conv", "kernel")] = _conv(
        sd[f"{t}.short_term_attn.dw_conv.conv.weight"])
    _put_dense(sd, out, f"{t}.short_term_attn.projection",
               f + ("short_tail", "projection"))
    _put_norm(sd, out, f"{t}.norm2", f + ("norm2",))
    _put_norm(sd, out, f"{t}.id_norm2", f + ("id_norm2",))
    sa = f + ("self_attn",)
    for q in ("linear_QK", "linear_V1", "linear_V2", "linear_U1",
              "linear_U2"):
        _put_dense(sd, out, f"{t}.self_attn.{q}", sa + (q,))
    out[sa + ("tail", "dw_conv", "conv", "kernel")] = _conv(
        sd[f"{t}.self_attn.dw_conv.conv.weight"])
    _put_dense(sd, out, f"{t}.self_attn.projection",
               sa + ("tail", "projection"))


def _convert_fpn(sd, out):
    f = ("decoder",)
    for name in ("conv_in", "conv_16x", "conv_8x", "conv_4x"):
        out[f + (name, "conv", "kernel")] = _conv(
            sd[f"decoder.{name}.conv.weight"])
        out[f + (name, "conv", "bias")] = sd[f"decoder.{name}.conv.bias"]
        _put_norm(sd, out, f"decoder.{name}.gn", f + (name, "gn"))
    for name in ("adapter_16x", "adapter_8x", "adapter_4x", "conv_out"):
        out[f + (name, "kernel")] = _conv(sd[f"decoder.{name}.weight"])
        out[f + (name, "bias")] = sd[f"decoder.{name}.bias"]


def _unflatten(flat: Dict[Tuple[str, ...], Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, val in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return tree


def convert_torch_checkpoint(sd: Dict[str, np.ndarray], model_vos: str,
                             num_layers: int = 3,
                             id_channels: int = 12,
                             report: Optional[dict] = None
                             ) -> Dict[str, Any]:
    """Torch state_dict -> nested flax-path param dict for AOT/DeAOT. The
    encoder is told by its marker key, in the JAX converter's order: Swin,
    MobileNetV3, MobileNetV2, ResNeSt, the top-down ResNet-50, else ResNet
    (the converters read the JAX converter's fixed depths: ResNet's and
    ResNeSt's stage 3 at 6 blocks, Swin's at 18).

    If `report` is a dict, it is filled with `dead_keys` (source keys that
    are dead in the reference itself, e.g. TIME_ENCODE MLPs) and
    `unexpected_keys` (source content the converter does not understand;
    empty for reference models)."""
    sd = _RecordingDict(sd)
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    if "encoder.patch_embed.proj.weight" in sd:
        _convert_swin(sd, out)
    elif "encoder.conv.0.weight" in sd:  # MobileNetV3's final 1x1 conv
        _convert_mobilenetv3(sd, out)
    elif "encoder.features.0.0.weight" in sd:
        _convert_mobilenetv2(sd, out)
    elif "encoder.conv1.0.weight" in sd:  # ResNeSt's deep stem
        _convert_resnest(sd, out)
    elif "encoder.prompt" in sd:
        _convert_topdown(sd, out)
    else:
        _convert_resnet(sd, out)
    out[("encoder_projector", "kernel")] = _conv(
        sd["encoder_projector.weight"])
    out[("encoder_projector", "bias")] = sd["encoder_projector.bias"]

    # id bank; pad 11 -> 12 input channels for the ignore token
    w = _conv(sd["patch_wise_id_bank.weight"])  # [k,k,in,out]
    if w.shape[2] < id_channels:
        pad = np.zeros(w.shape[:2] + (id_channels - w.shape[2], w.shape[3]),
                       w.dtype)
        w = np.concatenate([w, pad], axis=2)
    out[("patch_wise_id_bank", "kernel")] = w
    out[("patch_wise_id_bank", "bias")] = sd["patch_wise_id_bank.bias"]

    if "cur_pos_emb" in sd:
        out[("cur_pos_emb",)] = sd["cur_pos_emb"]
        out[("mem_pos_emb",)] = sd["mem_pos_emb"]

    for i in range(num_layers):
        if model_vos == "aot":
            _convert_lstt_block(sd, out, i)
        else:
            _convert_gpm_block(sd, out, i)
    n_norms = len([k for k in sd if k.startswith("LSTT.decoder_norms.")
                   and k.endswith(".weight")])
    for i in range(n_norms):
        t = f"LSTT.decoder_norms.{i}"
        if f"{t}.gn.weight" in sd:
            # DeAOT: GroupNorm1D wraps an nn.GroupNorm under `.gn`
            _put_norm(sd, out, f"{t}.gn", ("lstt", f"decoder_norm{i}"))
        else:
            _put_norm(sd, out, t, ("lstt", f"decoder_norm{i}"))
    _convert_fpn(sd, out)
    if model_vos == "deaot":
        _put_norm(sd, out, "id_norm", ("id_norm",))
    if report is not None:
        dead, unexpected = classify_unconsumed(sd)
        report["dead_keys"] = dead
        report["unexpected_keys"] = unexpected
    return _unflatten(out)


def load_pretrained(model: torch.nn.Module, src, model_vos: str,
                    id_channels: int = 12, report: Optional[dict] = None,
                    log=print):
    """Shape-tolerant merge of a reference checkpoint (a path, or the
    object torch.load gave) into `model`'s current weights, in place.
    Returns (skipped, extra) in the JAX package's terms: flax paths, and
    shapes in the flax layout. `report` also takes the converter's
    dead_keys and unexpected_keys, and skipped and extra."""
    sd = (load_torch_state_dict(src) if isinstance(src, (str, os.PathLike))
          else torch_state_dict(src))
    num_layers = len({k.split(".")[2] for k in sd
                      if k.startswith("LSTT.layers.")})
    rep: dict = {}
    conv = convert_torch_checkpoint(sd, model_vos, num_layers, id_channels,
                                    report=rep)
    if rep["dead_keys"]:
        log(f"converter: dropped {len(rep['dead_keys'])} reference-dead "
            "params (TIME_ENCODE MLPs / BN counters)")
    if rep["unexpected_keys"]:
        log("converter: UNCONSUMED source keys "
            f"{rep['unexpected_keys'][:10]}"
            f"{' ...' if len(rep['unexpected_keys']) > 10 else ''}")
    new = params_from_jax(conv)
    new_flax = {flax_path(k): v for k, v in new.items()}
    old = model.state_dict()
    merged, skipped = {}, []
    for name, v in old.items():
        path = flax_path(name)
        if name in new and new[name].shape == v.shape:
            merged[name] = new[name]
        elif name in new:
            skipped.append(("shape", path,
                            flax_shape(name, new[name].shape),
                            flax_shape(name, v.shape)))
        else:
            skipped.append(("missing", path))
    old_paths = {flax_path(name) for name in old}
    extra = [path for path in new_flax if path not in old_paths]
    model.load_state_dict(merged, strict=False)
    if report is not None:
        report.update(rep, skipped=skipped, extra=extra)
    return skipped, extra


# ---------------------------------------------------------------------------
# the checkpoint stream
# ---------------------------------------------------------------------------

def _step_of(name: str) -> int:
    return int(re.findall(r"\d+", name)[-1])


def _stream(ckpt_dir: str, prefix: str) -> List[str]:
    """The stream's file names in ckpt_dir, oldest step first."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted((f for f in os.listdir(ckpt_dir)
                   if f.startswith(prefix) and f.endswith(".pt")),
                  key=_step_of)


def save_file(obj, path: str) -> None:
    """torch.save to a temporary name, then renamed into place: a process
    killed mid-save leaves no truncated file at the final name."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(obj, ckpt_dir: str, step: int, max_keep: int = 8,
                    prefix: str = "save_step_", log=print) -> str:
    """Save `obj` as <ckpt_dir>/<prefix><step>.pt and prune the stream to
    its newest max_keep files. A write that fails with OSError (a full or
    unwritable result volume) is retried in ./saved_models, as the
    reference does. Returns the path written."""
    path = os.path.join(ckpt_dir, f"{prefix}{step}.pt")
    try:
        save_file(obj, path)
    except OSError as e:
        fallback = "./saved_models"
        log(f"checkpoint save to {path} failed ({e}); retrying in "
            f"{fallback}")
        ckpt_dir = fallback
        path = os.path.join(ckpt_dir, f"{prefix}{step}.pt")
        save_file(obj, path)
    for f in _stream(ckpt_dir, prefix)[:-max_keep]:
        os.remove(os.path.join(ckpt_dir, f))
    return path


def latest_checkpoint(ckpt_dir: str, prefix: str = "save_step_"
                      ) -> Optional[Tuple[str, int]]:
    """(path, step) of the stream's newest file, or None."""
    names = _stream(ckpt_dir, prefix)
    if not names:
        return None
    return os.path.join(ckpt_dir, names[-1]), _step_of(names[-1])


def load_latest_checkpoint(ckpt_dir: str, prefix: str = "save_step_",
                           log=print, map_location="cpu"):
    """The newest file of the stream that loads, newest to oldest: a file
    that fails to load (truncated, torn storage) is logged and skipped.
    Returns (object, step, path) or None."""
    for name in reversed(_stream(ckpt_dir, prefix)):
        path = os.path.join(ckpt_dir, name)
        try:
            obj = load_file(path, map_location)
        except (RuntimeError, OSError, EOFError,
                ValueError) as e:   # truncated or corrupt
            log(f"checkpoint {path} unreadable ({type(e).__name__}: {e}); "
                "falling back to the previous save")
            continue
        return obj, _step_of(name), path
    return None
