"""Side-by-side comparison video: each frame beside the overlays of one or
two result directories' masks, written as an mp4.

    python -m rmem_tpu_torch.tools.video --frames_dir <dir> \\
        --masks_a <demo_out>/masks [--masks_b <other>] --output cmp.mp4

The flags and defaults are those of `rmem_tpu/tools/video.py`. Each row
of the video is [frame | overlay A | overlay B]; a frame without a mask in
a directory repeats the frame in that panel. Frames are read on the host
(`.jpg` by cv2, `.png` by utils/image.py:read_png) and the mp4 is written
by cv2.VideoWriter (`mp4v`), the one mp4 writer of either machine. A
writer that fails to open raises, and the frames written are counted.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="rmem_tpu_torch comparison "
                                "video")
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--masks_a", required=True, help="result dir A (PNG masks)")
    p.add_argument("--masks_b", default=None, help="optional result dir B")
    p.add_argument("--output", default="comparison.mp4")
    p.add_argument("--fps", type=float, default=10.0)
    return p


def main(argv=None) -> int:
    """Returns the number of frames written."""
    args = build_parser().parse_args(argv)

    import cv2
    import numpy as np

    from rmem_tpu_torch.tools.demo import read_frame
    from rmem_tpu_torch.utils.image import overlay_mask, read_png

    frames = sorted(f for f in os.listdir(args.frames_dir)
                    if f.lower().endswith((".jpg", ".png")))
    if not frames:
        raise ValueError(f"no .jpg or .png frames in {args.frames_dir}")
    writer, written = None, 0
    try:
        for fname in frames:
            img = read_frame(os.path.join(args.frames_dir, fname),
                             "cpu").numpy()
            stem = os.path.splitext(fname)[0]
            panels = [img]
            for mdir in (args.masks_a, args.masks_b):
                if mdir is None:
                    continue
                mpath = os.path.join(mdir, stem + ".png")
                panels.append(overlay_mask(img, read_png(mpath))
                              if os.path.exists(mpath) else img)
            frame = np.concatenate(panels, axis=1)
            if writer is None:
                writer = cv2.VideoWriter(
                    args.output, cv2.VideoWriter_fourcc(*"mp4v"), args.fps,
                    (frame.shape[1], frame.shape[0]))
                if not writer.isOpened():
                    raise RuntimeError(
                        f"cv2.VideoWriter could not open {args.output} "
                        "with the mp4v codec")
            writer.write(np.ascontiguousarray(frame[:, :, ::-1]))
            written += 1
    finally:
        if writer is not None:
            writer.release()
    print(f"wrote {args.output} ({written} frames)")
    return written


if __name__ == "__main__":
    main()
