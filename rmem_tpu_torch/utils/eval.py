"""Packaging results for a benchmark server."""

from __future__ import annotations

import os
import zipfile


def zip_folder(source_folder: str, zip_path: str) -> str:
    """Zip a result tree, the archive's names rooted at the folder's
    basename."""
    pre_len = len(os.path.dirname(source_folder))
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for dirpath, _dirnames, filenames in os.walk(source_folder):
            for filename in filenames:
                pathfile = os.path.join(dirpath, filename)
                arcname = pathfile[pre_len:].strip(os.path.sep)
                zf.write(pathfile, arcname)
    return zip_path
