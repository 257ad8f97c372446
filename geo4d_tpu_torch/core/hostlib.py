"""Host C++ libraries built with g++ at first use and loaded with ctypes
(the JPEG decoder and encoder of data/jpeg.py, the mesh rasteriser of
geometry/raster.py).

A library is named by a hash of its source and flags, so an edited source
builds anew; it is compiled into a temporary file renamed into place, so a
concurrent build or load never sees half a file. A failed build raises with
the compiler's output; nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "geo4d_tpu_torch"


def library_path(source: Path, stem: str, flags: Sequence[str], build_dir: Path) -> Path:
    h = hashlib.sha256(" ".join(flags).encode() + Path(source).read_bytes())
    return Path(build_dir) / f"{stem}_{h.hexdigest()[:16]}.so"


def build(source: Path, stem: str, flags: Sequence[str], build_dir: Path, what: str) -> Path:
    """Compile `source` into a shared library unless one of the same source
    and flags exists; raises RuntimeError with g++'s output if it fails."""
    out = library_path(source, stem, flags, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *flags, str(source), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} could not be built (g++ {proc.returncode}):\n"
                           f"{proc.stderr[-3000:]}")
    os.replace(tmp, out)
    return out
