"""Run logs: stdout mirrored into a file, a JSON-lines metric stream, a
snapshot of the package's source beside the results, and a zip of the
predicted masks.

Counterpart of `rmem_tpu/utils/logging.py`, the same behaviour on the
host.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
import zipfile
from typing import Optional


class Tee:
    """Mirror stdout into log_dir/<name>_<timestamp>.txt (line-buffered)
    once installed; close restores stdout."""

    def __init__(self, log_dir: str, name: str = "log"):
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.path = os.path.join(log_dir, f"{name}_{stamp}.txt")
        self._file = open(self.path, "a", buffering=1)
        self._stdout = sys.stdout

    def write(self, data):
        self._stdout.write(data)
        self._file.write(data)

    def flush(self):
        self._stdout.flush()
        self._file.flush()

    def install(self) -> "Tee":
        sys.stdout = self
        return self

    def close(self):
        sys.stdout = self._stdout
        self._file.close()


def copy_codes(dst_dir: str, src_root: Optional[str] = None) -> str:
    """Copy the package's source (src_root, by default this package) to
    dst_dir/codes, replacing an older copy; caches left out."""
    src_root = src_root or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(dst_dir, "codes")
    if os.path.isdir(dst):
        shutil.rmtree(dst)
    shutil.copytree(src_root, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    return dst


def zip_results(results_dir: str, zip_path: Optional[str] = None) -> str:
    """Zip the PNG masks under results_dir (names relative to it), by
    default to results_dir.zip."""
    zip_path = zip_path or results_dir.rstrip("/") + ".zip"
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for root, _, files in os.walk(results_dir):
            for f in files:
                if f.endswith(".png"):
                    full = os.path.join(root, f)
                    z.write(full, os.path.relpath(full, results_dir))
    return zip_path


class JsonlLogger:
    """One JSON object a call, {"step": step, name: float(value), ...}, a
    line each, appended to `path`."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, step: int, **scalars):
        rec = {"step": step}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()
