"""Mask images: the label colormap, palette PNG writing and PNG reading on
numpy + zlib, the background mask writer and the overlay.

Counterpart of `rmem_tpu/utils/image.py`, without PIL and without a
compiler: `encode_png_rgb` writes 8-bit RGB; `encode_png_pal8` writes the format of the JAX package's native
encoder (`rmem_tpu/native/rmem_native.cpp:encode_png_pal8`: 8-bit palette,
a 256-colour PLTE, every row unfiltered, zlib level 6), and `read_png`
reads the PNGs annotation tools write: palette and grey at 1, 2, 4 or 8
bits, RGB at 8, every row filter undone, as `np.asarray(Image.open(p))`
gives them.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import List, Optional, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1}      # colour type -> samples a pixel


def label_colormap(n: int = 256) -> np.ndarray:
    """The VOC/DAVIS colormap (bit-shuffled), [n, 3] uint8."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png_pal8(mask: np.ndarray, palette: np.ndarray) -> bytes:
    """uint8 [H, W] indices and a [256, 3] uint8 palette -> PNG bytes."""
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    rows = np.zeros((h, w + 1), np.uint8)      # filter byte 0 a row
    rows[:, 1:] = mask
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"PLTE", np.ascontiguousarray(palette, np.uint8)
                     .tobytes())
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prior[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth) ->
    [h, stride] uint8 scanlines."""
    data = np.frombuffer(raw, np.uint8)
    if data.size < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    data = data[:h * (stride + 1)].reshape(h, stride + 1)
    ftypes, rows = data[:, 0], data[:, 1:]
    if not ftypes.any():
        return rows.copy()
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        f, row = int(ftypes[y]), rows[y]
        if f == 0:
            out[y] = row
        elif f == 1:      # Sub: a running sum along each byte of a pixel
            acc = row.astype(np.int64)
            for k in range(bpp):
                acc[k::bpp] = np.cumsum(acc[k::bpp])
            out[y] = acc & 0xFF
        elif f == 2:      # Up
            out[y] = row + prior
        elif f in (3, 4):
            cur = bytearray(row.tobytes())
            (_average_row if f == 3 else _paeth_row)(cur, prior.tobytes(),
                                                     bpp)
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row filter {f}")
        prior = out[y]
    return out


def decode_png(buf: bytes) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """PNG bytes -> (pixels, palette): uint8 [H, W] palette indices or
    grey values, or [H, W, 3] RGB; the palette [N, 3] uint8 of a palette
    image, else None."""
    if buf[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos + 8 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3).copy()
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG colour type {ctype}, interlace {interlace}: "
                         "only non-interlaced palette, grey and RGB are read")
    ch = _CHANNELS[ctype]
    if depth not in ((1, 2, 4, 8) if ch == 1 else (8,)):
        raise ValueError(f"PNG bit depth {depth} for colour type {ctype}")
    stride = (w * ch * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride,
                     max(1, ch * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        pix = (bits.reshape(h, w, depth) * weights).sum(-1).astype(np.uint8)
        if ctype == 0:    # grey samples scale to 0..255, as PIL's "L"
            pix = (pix * (255 // ((1 << depth) - 1))).astype(np.uint8)
    else:
        pix = rows.reshape(h, w, ch) if ch > 1 else rows
    return pix, palette


def read_png(path: str) -> np.ndarray:
    """A PNG file's pixels (see decode_png)."""
    with open(path, "rb") as f:
        return decode_png(f.read())[0]


def encode_png_rgb(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB -> PNG bytes (8-bit RGB, rows unfiltered)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    rows = np.zeros((h, 3 * w + 1), np.uint8)
    rows[:, 1:] = img.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _save_mask(mask: np.ndarray, path: str,
               squeeze_idx: Optional[List[int]] = None) -> None:
    """Write a palette PNG, the squeezed ids mapped back to the original
    ones."""
    if squeeze_idx is not None:
        out = np.zeros_like(mask)
        for idx in range(1, len(squeeze_idx)):
            out += ((mask == idx) * squeeze_idx[idx]).astype(np.uint8)
        mask = out
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = encode_png_pal8(mask.astype(np.uint8), label_colormap())
    with open(path, "wb") as f:
        f.write(data)


class AsyncMaskWriter:
    """Writes mask PNGs on background threads; `join` waits for them all
    and raises the first error one of them met."""

    def __init__(self):
        self._threads: List[threading.Thread] = []
        self._errors: List[BaseException] = []

    def _run(self, *args) -> None:
        try:
            _save_mask(*args)
        except Exception as e:   # surfaced by join()
            self._errors.append(e)

    def save(self, mask: np.ndarray, path: str,
             squeeze_idx: Optional[List[int]] = None) -> None:
        t = threading.Thread(target=self._run,
                             args=(mask, path, squeeze_idx), daemon=True)
        t.start()
        self._threads.append(t)

    def join(self) -> None:
        for t in self._threads:
            t.join()
        self._threads.clear()
        if self._errors:
            err, self._errors = self._errors[0], []
            raise err


def overlay_mask(image, mask, alpha: float = 0.7):
    """Blend the colormap of a mask over an RGB image where the mask is not
    background, in the f64 arithmetic of the JAX package's numpy version.
    `image` [H, W, 3] uint8 and `mask` [H, W]: numpy arrays, giving one,
    or tensors on one device, giving a tensor there."""
    import torch
    img = torch.as_tensor(image).double()
    lab = torch.as_tensor(mask, device=img.device)
    colored = torch.as_tensor(_COLORMAP, device=img.device)[
        lab.to(torch.uint8).long()].double()
    out = torch.where((lab > 0)[..., None],
                      img * alpha + colored * (1 - alpha),
                      img).to(torch.uint8)
    return out.numpy() if isinstance(image, np.ndarray) else out


_COLORMAP = label_colormap()
