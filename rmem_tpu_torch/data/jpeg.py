"""JPEG frames as uint8 RGB tensors: decoded (and encoded) on the card by
nvJPEG, on the CPU by cv2.

On the card `read_jpeg` hands the compressed bytes to nvJPEG
(`libnvjpeg.so` of the CUDA toolkit, loaded with ctypes as the kernels
are), which decodes the image's planes (Y, and Cb and Cr at the image's
own subsampling) into a device buffer on the caller's current stream;
the kernel `kernels/jpeg_color.py:ycc_to_rgb` then upsamples the chroma
and converts to RGB with libjpeg's arithmetic, on the same stream.
(nvJPEG's own RGB output replicates the chroma, ~6 dB further from the
source than libjpeg's decode on 4:2:0 frames.) Grey, 4:4:4 and 4:2:0
images are decoded; another subsampling raises, and no failure falls back
to the host. On the CPU it is `cv2.imread` (imported when called), the
decoder of the JAX package's readers, so that the CPU tests see the same
bits.

`encode_jpeg` and `write_jpeg` go the other way: an RGB frame on the card
becomes baseline JPEG bytes by nvJPEG's encoder (quality 95, chroma 4:2:0),
one on the CPU by `cv2.imencode` at its defaults (the same quality and
subsampling), the writer of the JAX package's tools.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
import threading
from typing import Union

import numpy as np
import torch

from rmem_tpu_torch.kernels.jpeg_color import (GREY, YCC420, YCC444,
                                               ycc_to_rgb)

# nvjpeg.h: NVJPEG_MAX_COMPONENT; nvjpegOutputFormat_t's NVJPEG_OUTPUT_YUV
# and NVJPEG_OUTPUT_Y; nvjpegChromaSubsampling_t's NVJPEG_CSS_444, _420
# and _GRAY
MAX_COMPONENT = 4
OUTPUT_YUV, OUTPUT_Y = 1, 2
_MODES = {0: YCC444, 2: YCC420, 6: GREY}
_STATUS = {1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG",
           4: "JPEG_NOT_SUPPORTED", 5: "ALLOCATOR_FAILURE",
           6: "EXECUTION_FAILED", 7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR",
           9: "IMPLEMENTATION_NOT_SUPPORTED"}


class NvjpegImage(ctypes.Structure):
    """nvjpegImage_t: a plane pointer and a row pitch per component."""

    _fields_ = [("channel", ctypes.c_void_p * MAX_COMPONENT),
                ("pitch", ctypes.c_size_t * MAX_COMPONENT)]


def library_path() -> str:
    """libnvjpeg of the CUDA toolkit ($CUDA_HOME, else /usr/local/cuda),
    else the loader's search path."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if not home:
            continue
        for sub in ("lib64", "targets/x86_64-linux/lib", "lib"):
            found = sorted(glob.glob(os.path.join(home, sub,
                                                  "libnvjpeg.so*")))
            if found:
                return found[0]
    found = ctypes.util.find_library("nvjpeg")
    if found is None:
        raise RuntimeError("libnvjpeg not found: set CUDA_HOME to a CUDA "
                           "toolkit that has it")
    return found


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: nvJPEG status {status} "
                           f"({_STATUS.get(status, 'unknown')})")


class Nvjpeg:
    """One nvJPEG library handle, shared by the threads of the process,
    and one decoder state per thread (a state serves one decode at a
    time)."""

    def __init__(self):
        lib = ctypes.CDLL(library_path())
        p, vp = ctypes.POINTER, ctypes.c_void_p
        lib.nvjpegCreateSimple.argtypes = [p(vp)]
        lib.nvjpegJpegStateCreate.argtypes = [vp, p(vp)]
        lib.nvjpegGetImageInfo.argtypes = [
            vp, ctypes.c_char_p, ctypes.c_size_t, p(ctypes.c_int),
            p(ctypes.c_int), p(ctypes.c_int), p(ctypes.c_int)]
        lib.nvjpegDecode.argtypes = [vp, vp, ctypes.c_char_p,
                                     ctypes.c_size_t, ctypes.c_int,
                                     p(NvjpegImage), vp]
        for fn in ("nvjpegCreateSimple", "nvjpegJpegStateCreate",
                   "nvjpegGetImageInfo", "nvjpegDecode"):
            getattr(lib, fn).restype = ctypes.c_int
        self.lib = lib
        self.handle = vp()
        check(lib.nvjpegCreateSimple(ctypes.byref(self.handle)),
              "nvjpegCreateSimple")
        self._local = threading.local()

    def _state(self):
        state = getattr(self._local, "state", None)
        if state is None:
            state = ctypes.c_void_p()
            check(self.lib.nvjpegJpegStateCreate(self.handle,
                                                 ctypes.byref(state)),
                  "nvjpegJpegStateCreate")
            self._local.state = state
        return state

    def image_info(self, data: bytes):
        """(subsampling, [(height, width)] of each component)."""
        comps, subsampling = ctypes.c_int(), ctypes.c_int()
        widths = (ctypes.c_int * MAX_COMPONENT)()
        heights = (ctypes.c_int * MAX_COMPONENT)()
        check(self.lib.nvjpegGetImageInfo(
            self.handle, data, len(data), ctypes.byref(comps),
            ctypes.byref(subsampling), widths, heights),
            "nvjpegGetImageInfo")
        return subsampling.value, [(heights[c], widths[c])
                                   for c in range(comps.value)]

    def decode_planes(self, data: bytes, device: torch.device):
        """(mode, Y [H, W], Cb, Cr): the image's planes as nvJPEG decodes
        them, uint8 on `device`, written on its current stream (Cb and Cr
        None for grey)."""
        subsampling, sizes = self.image_info(data)
        mode = _MODES.get(subsampling)
        if mode is None:
            raise NotImplementedError(
                f"JPEG chroma subsampling {subsampling} (nvjpegChroma"
                "Subsampling_t): only grey, 4:4:4 and 4:2:0 are decoded on "
                "the card")
        (h, w), (ch, cw) = sizes[0], sizes[-1]
        buf = torch.empty(h * w + (2 * ch * cw if mode != GREY else 0),
                          dtype=torch.uint8, device=device)
        y = buf[:h * w].view(h, w)
        img = NvjpegImage()
        img.channel[0], img.pitch[0] = y.data_ptr(), w
        cb = cr = None
        if mode != GREY:
            cb = buf[h * w:h * w + ch * cw].view(ch, cw)
            cr = buf[h * w + ch * cw:].view(ch, cw)
            img.channel[1], img.pitch[1] = cb.data_ptr(), cw
            img.channel[2], img.pitch[2] = cr.data_ptr(), cw
        stream = torch.cuda.current_stream(device)
        # the state's buffers serve one decode at a time, on the card too:
        # where the host runs ahead of a busy card, the last decode's
        # copies may not have run yet
        done = getattr(self._local, "done", None)
        if done is not None:
            done.synchronize()
        check(self.lib.nvjpegDecode(self.handle, self._state(), data,
                                    len(data), OUTPUT_Y if mode == GREY
                                    else OUTPUT_YUV, ctypes.byref(img),
                                    stream.cuda_stream), "nvjpegDecode")
        self._local.done = torch.cuda.Event()
        self._local.done.record(stream)
        # the host bytes stay referenced until this thread's next decode
        self._local.last = data
        return mode, y, cb, cr

    def decode(self, data: bytes, device: torch.device) -> torch.Tensor:
        """uint8 [H, W, 3] RGB on `device`, written on its current stream."""
        mode, y, cb, cr = self.decode_planes(data, device)
        return ycc_to_rgb(y, cb, cr, mode)


class NvjpegEncoder:
    """nvJPEG's encoder on the process's nvJPEG handle: uint8 [H, W, 3]
    RGB on the card -> baseline JPEG bytes at `quality`, chroma 4:2:0
    (`subsampling`, an nvjpegChromaSubsampling_t: 2 is NVJPEG_CSS_420, 0
    NVJPEG_CSS_444). One encoder serves one thread."""

    def __init__(self, device: torch.device, quality: int = 95,
                 subsampling: int = 2):
        nv = nvjpeg()
        lib, vp, p = nv.lib, ctypes.c_void_p, ctypes.POINTER
        lib.nvjpegEncoderStateCreate.argtypes = [vp, p(vp), vp]
        lib.nvjpegEncoderParamsCreate.argtypes = [vp, p(vp), vp]
        lib.nvjpegEncoderParamsSetQuality.argtypes = [vp, ctypes.c_int, vp]
        lib.nvjpegEncoderParamsSetSamplingFactors.argtypes = [
            vp, ctypes.c_int, vp]
        lib.nvjpegEncodeImage.argtypes = [
            vp, vp, vp, p(NvjpegImage), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, vp]
        lib.nvjpegEncodeRetrieveBitstream.argtypes = [
            vp, vp, ctypes.c_char_p, p(ctypes.c_size_t), vp]
        for fn in ("nvjpegEncoderStateCreate", "nvjpegEncoderParamsCreate",
                   "nvjpegEncoderParamsSetQuality",
                   "nvjpegEncoderParamsSetSamplingFactors",
                   "nvjpegEncodeImage", "nvjpegEncodeRetrieveBitstream"):
            getattr(lib, fn).restype = ctypes.c_int
        self.lib, self.handle, self.device = lib, nv.handle, device
        self.state, self.params = vp(), vp()
        s = torch.cuda.current_stream(device).cuda_stream
        check(lib.nvjpegEncoderStateCreate(
            nv.handle, ctypes.byref(self.state), s), "encoder state")
        check(lib.nvjpegEncoderParamsCreate(
            nv.handle, ctypes.byref(self.params), s), "encoder params")
        check(lib.nvjpegEncoderParamsSetQuality(self.params, quality, s),
              "quality")
        check(lib.nvjpegEncoderParamsSetSamplingFactors(
            self.params, subsampling, s), "sampling factors")

    def encode(self, img: torch.Tensor) -> bytes:
        """Waits for the caller's current stream (the bytes are on the
        host when it returns)."""
        img = img.contiguous()
        h, w = img.shape[:2]
        src = NvjpegImage()
        src.channel[0] = img.data_ptr()
        src.pitch[0] = 3 * w
        stream = torch.cuda.current_stream(self.device)
        # nvjpegInputFormat_t: NVJPEG_INPUT_RGBI = 5
        check(self.lib.nvjpegEncodeImage(
            self.handle, self.state, self.params, ctypes.byref(src), 5, w, h,
            stream.cuda_stream), "nvjpegEncodeImage")
        n = ctypes.c_size_t(0)
        check(self.lib.nvjpegEncodeRetrieveBitstream(
            self.handle, self.state, None, ctypes.byref(n),
            stream.cuda_stream), "bitstream size")
        stream.synchronize()
        buf = ctypes.create_string_buffer(n.value)
        check(self.lib.nvjpegEncodeRetrieveBitstream(
            self.handle, self.state, buf, ctypes.byref(n),
            stream.cuda_stream), "bitstream")
        stream.synchronize()
        return buf.raw[:n.value]


_decoder_lock = threading.Lock()
_decoder = []


def nvjpeg() -> Nvjpeg:
    """The process's nvJPEG, created at first use."""
    with _decoder_lock:
        if not _decoder:
            _decoder.append(Nvjpeg())
        return _decoder[0]


def read_jpeg(src: Union[str, os.PathLike, bytes],
              device: Union[str, torch.device]) -> torch.Tensor:
    """A JPEG file's (or its bytes') pixels as uint8 [H, W, 3] RGB on
    `device`: nvJPEG on a CUDA device, cv2 on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        import cv2
        if isinstance(src, bytes):
            img = cv2.imdecode(np.frombuffer(src, np.uint8), cv2.IMREAD_COLOR)
        else:
            img = cv2.imread(os.fspath(src))
        if img is None:
            raise ValueError(f"cannot decode {src if not isinstance(src, bytes) else 'JPEG bytes'}")
        return torch.from_numpy(np.ascontiguousarray(img[:, :, ::-1]))
    if device.type != "cuda":
        raise ValueError(f"read_jpeg decodes on cuda or cpu, not {device}")
    if not isinstance(src, bytes):
        with open(src, "rb") as f:
            src = f.read()
    return nvjpeg().decode(src, device)


_encoders = threading.local()


def encode_jpeg(img: torch.Tensor) -> bytes:
    """uint8 [H, W, 3] RGB -> JPEG bytes at quality 95, chroma 4:2:0:
    nvJPEG for a tensor on the card (one encoder a thread and device), cv2
    for one on the CPU."""
    if img.device.type == "cpu":
        import cv2
        ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(
            img.numpy()[:, :, ::-1]))
        if not ok:
            raise ValueError("cv2.imencode failed")
        return buf.tobytes()
    if img.device.type != "cuda":
        raise ValueError(f"encode_jpeg encodes on cuda or cpu, not "
                         f"{img.device}")
    cache = _encoders.__dict__.setdefault("by_device", {})
    if img.device not in cache:
        cache[img.device] = NvjpegEncoder(img.device)
    return cache[img.device].encode(img)


def write_jpeg(path: Union[str, os.PathLike], img: torch.Tensor) -> None:
    """encode_jpeg's bytes to `path`."""
    data = encode_jpeg(img)
    with open(path, "wb") as f:
        f.write(data)
