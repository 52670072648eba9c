"""Static-image pretraining augmentations: one image jittered into a clip.

Counterpart of `rmem_tpu/data/image_transforms.py`, which runs the
reference's chain (hflip, ColorJitter, RandomAffine, RandomResizedCrop,
the one-hot relabel) on PIL. Here the pixels of a frame are a uint8
tensor [H, W, 3] on its device (the card, or the CPU) and every step of
them runs there, with no PIL and no cv2; the masks are uint8 numpy arrays
on the host, where the relabel's draws depend on them. Every random draw
is made on the host from the caller's np.random.RandomState in the JAX
package's order, so for a seed the clips' masks and object lists equal
the JAX package's, and the frames follow PIL's 8-bit rules:

- `affine` on a frame is Pillow's Geometry.c bicubic transform: the
  output pixel centre through the inverse matrix, the fill outside
  [0, W) x [0, H), else the a = -1 cubic on the 4 x 4 taps (clamped to
  the edge) around the point less 0.5, in f64, then clipped to 0..255
  and truncated;
- `affine` on a mask (and a frame at NEAREST) is Pillow's nearest
  transform: a pure scale or translation by its pretabulated double
  coordinates (ImagingScaleAffine), anything else in 16.16 fixed point
  (affine_fixed), each pixel outside taking the fill;
- `resized_crop` on a frame is Pillow's Resample.c bicubic resize (a =
  -0.5, antialiased): per output pixel the filter's taps with 22-bit
  integer weights, horizontal then vertical, each pass rounded and
  clipped to 0..255; on a mask it is the nearest scale above;
- the jitter is ImageEnhance's blends at 8 bits (brightness with black,
  contrast with the grey mean of convert("L"), saturation with
  convert("L") as RGB) and the hue shift through Pillow's uint8 HSV, each
  op rounding to uint8 before the next.

All of these equal PIL bit for bit on the test's images
(tests/test_torch_port_image_transforms.py).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

BICUBIC = "bicubic"
NEAREST = "nearest"
PRECISION_BITS = 32 - 8 - 2       # Resample.c's weights at 8 bits


# ---------------------------------------------------------------------------
# affine
# ---------------------------------------------------------------------------

def inverse_affine_matrix(center: Tuple[float, float], angle: float,
                          translate: Tuple[float, float], scale: float,
                          shear: Tuple[float, float]) -> List[float]:
    """Inverse of T(translate) * C(center) * R(angle)S(scale)Sh(shear) *
    C^-1, as a PIL Image.AFFINE 6-tuple (maps output coords -> input
    coords). Mirrors torchvision's `_get_inverse_affine_matrix`."""
    rot = math.radians(angle)
    sx = math.radians(shear[0])
    sy = math.radians(shear[1])
    cx, cy = center
    tx, ty = translate

    # rotation+shear block (no scale)
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)

    # inverted, with scale: det(RSS) = scale^2 * (ad - bc) and the cos/tan
    # construction keeps ad - bc == 1, so the inverse is adj / scale
    matrix = [d, -b, 0.0, -c, a, 0.0]
    matrix = [m / scale for m in matrix]
    # RSS^-1 * C^-1 * T^-1
    matrix[2] += matrix[0] * (-cx - tx) + matrix[1] * (-cy - ty)
    matrix[5] += matrix[3] * (-cx - tx) + matrix[4] * (-cy - ty)
    # C * ...
    matrix[2] += cx
    matrix[5] += cy
    return matrix


def _coord(v: np.ndarray) -> np.ndarray:
    """Geometry.c's COORD: -1 below 0, else truncated."""
    return np.where(v < 0.0, -1, v.astype(np.int64))


def _scale_index(n_out: int, a: float, b: float) -> np.ndarray:
    """ImagingScaleAffine's source indices: b + a/2, then + a per pixel,
    accumulated in double."""
    steps = np.full(n_out, a, np.float64)
    steps[0] = b + a * 0.5
    return _coord(np.add.accumulate(steps))


def nearest_index(out_hw: Tuple[int, int], in_hw: Tuple[int, int],
                  m: Sequence[float]) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """(rows, cols, inside) [H, W] of Pillow's nearest affine transform of
    an in_hw image to out_hw under the inverse matrix m."""
    h, w = out_hw
    hi, wi = in_hw
    if m[1] == 0 and m[3] == 0:           # a pure scale or translation
        cols = _scale_index(w, m[0], m[2])[None, :].repeat(h, 0)
        rows = _scale_index(h, m[4], m[5])[:, None].repeat(w, 1)
    else:                                 # 16.16 fixed point
        fix = lambda v: int(math.floor(v * 65536.0 + 0.5))
        a0, a1, a3, a4 = fix(m[0]), fix(m[1]), fix(m[3]), fix(m[4])
        a2 = fix(m[2] + m[0] * 0.5 + m[1] * 0.5)
        a5 = fix(m[5] + m[3] * 0.5 + m[4] * 0.5)
        ys, xs = np.mgrid[0:h, 0:w].astype(np.int64)
        cols = (a2 + ys * a1 + xs * a0) >> 16
        rows = (a5 + ys * a4 + xs * a3) >> 16
    inside = (cols >= 0) & (cols < wi) & (rows >= 0) & (rows < hi)
    return np.where(inside, rows, 0), np.where(inside, cols, 0), inside


def _nearest(x, rows, cols, inside, fill):
    """Gather x[rows, cols] where inside, else fill: a host mask [H, W] or
    a frame tensor [H, W, C]."""
    if isinstance(x, np.ndarray):
        return np.where(inside, x[rows, cols], np.asarray(fill, x.dtype))
    dev = x.device
    out = x[torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)]
    fill_t = torch.as_tensor(fill, dtype=x.dtype, device=dev)
    return torch.where(torch.from_numpy(inside).to(dev)[..., None], out,
                       fill_t)


def _cubic(v1, v2, v3, v4, d):
    """Geometry.c's BICUBIC (a = -1), evaluated in its order."""
    p2 = -v1 + v3
    p3 = 2 * (v1 - v2) + v3 - v4
    p4 = -v1 + v2 - v3 + v4
    return v2 + d * (p2 + d * (p3 + d * p4))


def _affine_bicubic(img: torch.Tensor, m: Sequence[float],
                    fill) -> torch.Tensor:
    """Pillow's bicubic affine transform of a uint8 frame [H, W, C]."""
    h, w = img.shape[:2]
    dev = img.device
    f64 = torch.float64
    ys = torch.arange(h, dtype=f64, device=dev)[:, None] + 0.5
    xs = torch.arange(w, dtype=f64, device=dev)[None, :] + 0.5
    xin = xs * m[0] + ys * m[1] + m[2]
    yin = xs * m[3] + ys * m[4] + m[5]
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin, yin = xin - 0.5, yin - 0.5
    x0, y0 = torch.floor(xin), torch.floor(yin)
    dx, dy = (xin - x0)[..., None], (yin - y0)[..., None]
    x0 = x0.to(torch.int64) - 1
    y0 = y0.to(torch.int64) - 1
    cols = [(x0 + i).clamp(0, w - 1) for i in range(4)]
    src = img.to(f64)
    rows = []
    for j in range(4):
        r = (y0 + j).clamp(0, h - 1)
        rows.append(_cubic(*(src[r, c] for c in cols), dx))
    v = _cubic(*rows, dy)
    out = torch.where(v <= 0.0, 0.0, torch.where(v >= 255.0, 255.0,
                                                 torch.trunc(v)))
    fill_t = torch.as_tensor(fill, dtype=f64, device=dev)
    return torch.where(inside[..., None], out, fill_t).to(torch.uint8)


def affine(x, angle: float, translate: Tuple[float, float], scale: float,
           shear: Tuple[float, float], resample: str = NEAREST, fill=0):
    """torchvision TF.affine on PIL's rules, same output size,
    centre-invariant: a uint8 frame tensor [H, W, C] (bicubic or nearest)
    or a host mask [H, W] (nearest)."""
    h, w = x.shape[:2]
    m = inverse_affine_matrix((w * 0.5, h * 0.5), angle, translate, scale,
                              shear)
    if resample == BICUBIC:
        return _affine_bicubic(x, m, fill)
    return _nearest(x, *nearest_index((h, w), (h, w), m), fill)


class RandomAffine:
    """Uniform angle, translations rounded to whole pixels, scale and an
    x-shear; the mask takes the same parameters at NEAREST with fill 0."""

    def __init__(self, degrees: float = 20.0,
                 translate: Tuple[float, float] = (0.1, 0.1),
                 scale: Tuple[float, float] = (0.9, 1.1),
                 shear: float = 10.0, resample: str = BICUBIC,
                 fillcolor=(124, 116, 104)):
        self.degrees = (-degrees, degrees)
        self.translate = translate
        self.scale = scale
        self.shear = (-shear, shear)
        self.resample = resample
        self.fillcolor = fillcolor

    def get_params(self, rng: np.random.RandomState,
                   img_size: Tuple[int, int]):
        """img_size is (W, H), as PIL's size."""
        angle = float(rng.uniform(*self.degrees))
        max_dx = self.translate[0] * img_size[0]
        max_dy = self.translate[1] * img_size[1]
        translations = (float(np.round(rng.uniform(-max_dx, max_dx))),
                        float(np.round(rng.uniform(-max_dy, max_dy))))
        scale = float(rng.uniform(*self.scale))
        shear = (float(rng.uniform(*self.shear)), 0.0)
        return angle, translations, scale, shear

    def __call__(self, rng, img: torch.Tensor, mask: np.ndarray):
        params = self.get_params(rng, (img.shape[1], img.shape[0]))
        img = affine(img, *params, resample=self.resample,
                     fill=self.fillcolor)
        mask = affine(mask, *params, resample=NEAREST, fill=0)
        return img, mask


# ---------------------------------------------------------------------------
# resized crop
# ---------------------------------------------------------------------------

def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    """Resample.c's bicubic (a = -0.5)."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def resample_weights(in_size: int, out_size: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc for the box
    (0, in_size): (source indices [out, K], int32 weights [out, K]), the
    taps past each pixel's span at weight 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    wts = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = _bicubic_filter((np.arange(xmax) + xmin - center + 0.5) * ss)
        ww = 0.0
        for v in k:                        # the C loop's sequential sum
            ww += float(v)
        if ww != 0.0:
            k = k / ww
        pre = k * (1 << PRECISION_BITS)
        wts[xx, :xmax] = np.where(k < 0, np.trunc(-0.5 + pre),
                                  np.trunc(0.5 + pre)).astype(np.int64)
        idx[xx, :xmax] = np.arange(xmin, xmin + xmax)
        idx[xx, xmax:] = xmin
    return idx, wts


def _resample_pass(x: torch.Tensor, idx: np.ndarray, wts: np.ndarray,
                   dim: int) -> torch.Tensor:
    """One pass of Resample.c's 8-bit resize along dim (0 rows, 1 cols)
    of a uint8 [H, W, C] frame."""
    dev = x.device
    i = torch.from_numpy(idx).to(dev)
    wt = torch.from_numpy(wts).to(dev)
    if dim == 0:
        taps = x[i].to(torch.int64)                   # [out, K, W, C]
        acc = (taps * wt[:, :, None, None]).sum(1)
    else:
        taps = x[:, i].to(torch.int64)                # [H, out, K, C]
        acc = (taps * wt[None, :, :, None]).sum(2)
    acc = acc + (1 << (PRECISION_BITS - 1))
    return torch.div(acc, 1 << PRECISION_BITS,
                     rounding_mode="floor").clamp_(0, 255).to(torch.uint8)


def resize_bicubic(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """PIL's `resize(size[::-1], BICUBIC)` of a uint8 frame [H, W, C]:
    horizontal pass, then vertical, each where its side changes."""
    h, w = img.shape[:2]
    oh, ow = size
    if ow != w:
        img = _resample_pass(img, *resample_weights(w, ow), dim=1)
    if oh != h:
        img = _resample_pass(img, *resample_weights(h, oh), dim=0)
    return img


def resized_crop(x, i: int, j: int, h: int, w: int, size: Tuple[int, int],
                 interpolation: str = BICUBIC):
    """The crop box (top i, left j, h, w), then PIL's resize to size (h,
    w): a frame tensor at BICUBIC, a host mask at NEAREST."""
    x = x[i:i + h, j:j + w]
    if (h, w) == tuple(size):
        return x
    if interpolation == BICUBIC:
        return resize_bicubic(x, size)
    m = (w / size[1], 0.0, 0.0, 0.0, h / size[0], 0.0)
    return _nearest(x, *nearest_index(tuple(size), (h, w), m), 0)


class RandomResizedCrop:
    """10 tries of (area in the scale range, log-uniform aspect), else the
    centred fallback crop."""

    def __init__(self, size: Tuple[int, int],
                 scale: Tuple[float, float] = (0.8, 1.0),
                 ratio: Optional[Tuple[float, float]] = None,
                 interpolation: str = BICUBIC):
        self.size = tuple(size)
        self.scale = scale
        if ratio is None:
            base = float(size[1]) / size[0]
            ratio = (base * 3.0 / 4.0, base * 4.0 / 3.0)
        self.ratio = ratio
        self.interpolation = interpolation

    def get_params(self, rng: np.random.RandomState,
                   img_size: Tuple[int, int]):
        """img_size is (W, H), as PIL's size."""
        width, height = img_size
        area = height * width
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = rng.uniform(*self.scale) * area
            aspect_ratio = math.exp(rng.uniform(*log_ratio))
            w = int(round(math.sqrt(target_area * aspect_ratio)))
            h = int(round(math.sqrt(target_area / aspect_ratio)))
            if 0 < w <= width and 0 < h <= height:
                i = int(rng.randint(0, height - h + 1))
                j = int(rng.randint(0, width - w + 1))
                return i, j, h, w
        in_ratio = float(width) / float(height)
        if in_ratio < min(self.ratio):
            w = width
            h = int(round(w / min(self.ratio)))
        elif in_ratio > max(self.ratio):
            h = height
            w = int(round(h * max(self.ratio)))
        else:
            w, h = width, height
        i = (height - h) // 2
        j = (width - w) // 2
        return i, j, h, w

    def __call__(self, rng, img: torch.Tensor, mask: np.ndarray):
        i, j, h, w = self.get_params(rng, (img.shape[1], img.shape[0]))
        img = resized_crop(img, i, j, h, w, self.size, self.interpolation)
        mask = resized_crop(mask, i, j, h, w, self.size, NEAREST)
        return img, mask


# ---------------------------------------------------------------------------
# colour jitter
# ---------------------------------------------------------------------------

def _blend(degenerate: torch.Tensor, img: torch.Tensor,
           factor: float) -> torch.Tensor:
    """ImagingBlend at 8 bits: in1 + alpha * (in2 - in1) in f32, truncated
    (clipped first when alpha is outside [0, 1])."""
    alpha = float(np.float32(factor))
    if alpha == 0.0:
        return degenerate.expand_as(img).clone()
    if alpha == 1.0:
        return img.clone()
    a = degenerate.to(torch.float32)
    v = a + alpha * (img.to(torch.float32) - a)
    if not 0.0 <= alpha <= 1.0:
        v = v.clamp(0.0, 255.0)
    return v.to(torch.uint8)


def _grey(img: torch.Tensor) -> torch.Tensor:
    """convert("L"): (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    x = img.to(torch.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
             + 0x8000) >> 16)


def adjust_brightness(img: torch.Tensor, factor: float) -> torch.Tensor:
    return _blend(torch.zeros_like(img), img, factor)


def adjust_contrast(img: torch.Tensor, factor: float) -> torch.Tensor:
    """Blend with the grey mean, int(mean + 0.5), kept on the device."""
    grey = _grey(img)
    mean = grey.sum(dtype=torch.int64).to(torch.float64) / grey.numel()
    mean = torch.floor(mean + 0.5).to(torch.uint8)
    return _blend(mean.expand(img.shape[:2])[..., None].expand_as(img), img,
                  factor)


def adjust_saturation(img: torch.Tensor, factor: float) -> torch.Tensor:
    grey = _grey(img).to(torch.uint8)[..., None].expand_as(img)
    return _blend(grey, img, factor)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C's round() of non-negative doubles, exactly."""
    t = torch.trunc(x)
    return t + ((x - t) >= 0.5).to(x.dtype)


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """Pillow's uint8 RGB -> HSV (Convert.c rgb2hsv_row)."""
    f32, f64 = torch.float32, torch.float64
    x = img.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(r, torch.maximum(g, b))
    minc = torch.minimum(r, torch.minimum(g, b))
    grey = maxc == minc
    cr = (maxc - minc).to(f32)
    cr = torch.where(grey, 1.0, cr)
    s = cr / maxc.to(f32).clamp(min=1)
    rc = (maxc - r).to(f32) / cr
    gc = (maxc - g).to(f32) / cr
    bc = (maxc - b).to(f32) / cr
    h_r = bc - gc
    h_g = ((2.0 + rc.to(f64)) - bc.to(f64)).to(f32)
    h_b = ((4.0 + gc.to(f64)) - rc.to(f64)).to(f32)
    h = torch.where(r == maxc, h_r, torch.where(g == maxc, h_g, h_b))
    h = torch.fmod(h.to(f64) / 6.0 + 1.0, 1.0).to(f32)
    uh = torch.trunc(h.to(f64) * 255.0).clamp(0, 255)
    us = torch.trunc(s.to(f64) * 255.0).clamp(0, 255)
    uh = torch.where(grey, 0.0, uh)
    us = torch.where(grey, 0.0, us)
    return torch.stack([uh.to(torch.uint8), us.to(torch.uint8),
                        maxc.to(torch.uint8)], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Pillow's uint8 HSV -> RGB (Convert.c hsv2rgb)."""
    f32, f64 = torch.float32, torch.float64
    h = hsv[..., 0].to(f64)
    s = hsv[..., 1]
    v = hsv[..., 2].to(f64)
    h6 = h * 6.0 / 255.0
    i = torch.floor(h6)
    f = (h6 - i).to(f32)
    fs = (s.to(f64) / 255.0).to(f32)
    clip8 = lambda t: t.clamp(0, 255)
    p = clip8(_round_half_away(v * (1.0 - fs.to(f64))))
    q = clip8(_round_half_away(v * (1.0 - (fs * f).to(f64))))
    t = clip8(_round_half_away(v * (1.0 - fs.to(f64)
                                    * (1.0 - f.to(f64)))))
    i = i.to(torch.int64) % 6
    sel = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = [torch.zeros_like(v) for _ in range(3)]
    for k, chans in enumerate(sel):
        here = i == k
        out = [torch.where(here, c, o) for c, o in zip(chans, out)]
    rgb = torch.stack(out, dim=-1)
    rgb = torch.where((s == 0)[..., None], v[..., None].expand_as(rgb), rgb)
    return rgb.to(torch.uint8)


def adjust_hue(img: torch.Tensor, hue_factor: float) -> torch.Tensor:
    """Shift the hue by hue_factor in [-0.5, 0.5] through Pillow's uint8
    HSV, with the uint8 wrap-around add of int(hue_factor * 255)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError(f"hue_factor {hue_factor} not in [-0.5, 0.5]")
    hsv = rgb_to_hsv(img)
    shift = int(hue_factor * 255) % 256
    h = ((hsv[..., 0].to(torch.int32) + shift) % 256).to(torch.uint8)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


class ColorJitter:
    """Brightness, contrast and saturation factors in [max(0, 1 - v),
    1 + v] and a hue in [-h, h], drawn in that order, then applied in the
    order of rng.permutation(4)."""

    def __init__(self, brightness=0.1, contrast=0.1, saturation=0.1,
                 hue=0.03):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, rng: np.random.RandomState,
                 img: torch.Tensor) -> torch.Tensor:
        ops = []
        for v, fn in ((self.brightness, adjust_brightness),
                      (self.contrast, adjust_contrast),
                      (self.saturation, adjust_saturation)):
            factor = float(rng.uniform(max(0.0, 1.0 - v), 1.0 + v))
            ops.append(lambda im, f=factor, fn=fn: fn(im, f))
        hue = float(rng.uniform(-self.hue, self.hue))
        ops.append(lambda im, f=hue: adjust_hue(im, f))
        for k in rng.permutation(len(ops)):
            img = ops[k](img)
        return img


# ---------------------------------------------------------------------------
# relabel and flip
# ---------------------------------------------------------------------------

def compact_relabel(mask: np.ndarray, obj_list: Optional[List[int]],
                    rng: np.random.RandomState, max_obj_n: int,
                    shuffle: bool = True
                    ) -> Tuple[np.ndarray, List[int]]:
    """Map raw mask ids to 1..len(obj_list) (frame 0 defines, and with
    `shuffle` permutes, the id order; later frames reuse it). Ids outside
    obj_list (255 among them) become background."""
    if obj_list is None:
        ids = [i for i in range(1, int(mask.max()) + 1) if (mask == i).any()]
        if shuffle and len(ids) > 1:
            ids = [ids[k] for k in rng.permutation(len(ids))]
        obj_list = ids[:max_obj_n]
    out = np.zeros_like(mask, dtype=np.int32)
    for pos, oid in enumerate(obj_list):
        out[mask == oid] = pos + 1
    return out, obj_list


def hflip(x):
    """Left-right flip of a frame tensor [H, W, C] or a host mask [H, W]."""
    if isinstance(x, np.ndarray):
        return x[:, ::-1].copy()
    return x.flip(1)
