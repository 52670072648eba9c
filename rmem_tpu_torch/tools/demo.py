"""Single-video demo: propagate a first-frame mask through a directory of
frames, write the predicted masks and overlaid frames.

    python -m rmem_tpu_torch.tools.demo --frames_dir <dir> \\
        --first_mask <first.png> --ckpt_path R50_DeAOTL.pth
    python -m rmem_tpu_torch.tools.demo ... --model tiny_deaotl \\
        --stage test --device cpu

The flags and defaults are those of `rmem_tpu/tools/demo.py`, plus
--device. It runs on the card unless --device cpu is given (f32 there).
--ckpt_path takes what models.load_model_params reads (a reference .pth,
a JAX msgpack params tree, or a checkpoint of this package's trainer), or
`test` for random weights from init_params(model, 0).

Per frame, on the engine's device, the evaluator's per-frame path: `.jpg`
frames are decoded by read_jpeg (nvJPEG on the card), `.png` ones by
utils/image.py:read_png; the engine's `prep` resizes and normalises; frame
0 is the reference (every id group told it has model_max_obj_num objects,
as the evaluator's groups are); later frames `propagate`, their logits
upsampled to the frame's size, group-merged and argmaxed, and the label
goes back into the memory through `write_label` (nearest resize to the
input size, the split into id groups, `update_memory`). The masks go to
<output_dir>/masks/<stem>.png through the background PNG writer, the
overlays (utils/image.py:overlay_mask) to <output_dir>/<stem>_overlay.jpg,
made and JPEG-encoded on the engine's device.
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="rmem_tpu_torch demo")
    p.add_argument("--model", default="r50_deaotl")
    p.add_argument("--stage", default="pre_vost_2")
    p.add_argument("--ckpt_path", default="test")
    p.add_argument("--frames_dir", required=True,
                   help="directory of ordered video frames (jpg/png)")
    p.add_argument("--first_mask", required=True,
                   help="palettized PNG mask for the first frame")
    p.add_argument("--output_dir", default="./demo_out")
    p.add_argument("--gap", type=int, default=5)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def read_frame(path: str, device):
    """uint8 [H, W, 3] RGB on `device`."""
    import numpy as np
    import torch

    from rmem_tpu_torch.data.jpeg import read_jpeg
    from rmem_tpu_torch.utils.image import read_png
    if path.lower().endswith(".png"):
        pix = read_png(path)
        if pix.ndim == 2:
            pix = np.repeat(pix[..., None], 3, axis=-1)
        return torch.from_numpy(np.ascontiguousarray(pix)).to(device)
    return read_jpeg(path, device)


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from rmem_tpu_torch.config import get_config
    from rmem_tpu_torch.data.jpeg import write_jpeg
    from rmem_tpu_torch.data.transforms import restrict_size
    from rmem_tpu_torch.engine.inference import (InferenceEngine,
                                                 separate_mask,
                                                 soft_logit_aggregation)
    from rmem_tpu_torch.models import (build_vos_model, init_params,
                                       load_model_params)
    from rmem_tpu_torch.ops.resize import resize_nearest
    from rmem_tpu_torch.utils.image import (AsyncMaskWriter, overlay_mask,
                                            read_png)

    over = dict(test_ckpt_path=args.ckpt_path)
    if args.device == "cpu":
        over["compute_dtype"] = "float32"
    cfg = get_config(args.stage, "demo", args.model, **over)
    model = build_vos_model(cfg.model_vos, cfg)
    if args.ckpt_path == "test":
        init_params(model, 0)
    else:
        load_model_params(model, args.ckpt_path)
    engine = InferenceEngine(model, cfg, device=args.device)
    dev, max_obj = engine.device, cfg.model_max_obj_num

    frames = sorted(f for f in os.listdir(args.frames_dir)
                    if f.lower().endswith((".jpg", ".png", ".jpeg")))
    if args.max_frames:
        frames = frames[: args.max_frames]
    first = read_png(args.first_mask)
    writer = AsyncMaskWriter()
    os.makedirs(args.output_dir, exist_ok=True)

    state = None
    groups = max(int(np.ceil(first.max() / max_obj)), 1)
    t0 = time.perf_counter()
    for i, fname in enumerate(frames):
        raw = read_frame(os.path.join(args.frames_dir, fname), dev)
        ori_h, ori_w = raw.shape[:2]
        hw = restrict_size(ori_h, ori_w, cfg.test_max_size,
                           cfg.test_min_size, 1.0, cfg.model_align_corners)
        img = engine.prep(raw[None], hw)[0]
        if i == 0:
            lab = resize_nearest(torch.from_numpy(first).to(dev)[None, ...,
                                                                 None],
                                 hw)[..., 0]
            state, _ = engine.add_reference(
                img, separate_mask(lab, groups, max_obj), [max_obj] * groups,
                gap=args.gap)
            pred = torch.from_numpy(first).to(dev)
        else:
            state, logits4 = engine.propagate(state, img)
            logits = engine.predict_logits_at(logits4, (ori_h, ori_w))
            merged = soft_logit_aggregation(logits, max_obj)
            pred = torch.argmax(merged, -1).to(torch.uint8)
            state = engine.write_label(state, pred, hw)
        stem = os.path.splitext(fname)[0]
        writer.save(pred.cpu().numpy(),
                    os.path.join(args.output_dir, "masks", stem + ".png"))
        write_jpeg(os.path.join(args.output_dir, stem + "_overlay.jpg"),
                   overlay_mask(raw, pred))
        print(f"frame {i + 1}/{len(frames)}: {fname}")
    writer.join()
    secs = time.perf_counter() - t0
    print(f"wrote {len(frames)} overlays + masks to {args.output_dir} in "
          f"{secs:.3f} s ({len(frames) / max(secs, 1e-9):.3f} frames/s on "
          f"{dev})")


if __name__ == "__main__":
    main()
