"""Building the port's CUDA sources (``csrc/*.cu``) on the card's machine.

Each source is compiled on first use with ``nvcc`` into
``build/torch_kernels/`` at the root of the checkout, as a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
keyed on a hash of the source and flags, and loaded with ``ctypes`` by its
wrapper (``ops/fbank_cuda.py``, ``ops/bn_act_cuda.py``).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # resolves the toolkit

    if CUDA_HOME is None:
        raise RuntimeError("building the port's CUDA kernels needs the CUDA toolkit (nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` is built: ``lib<stem>_<hash of the source
    and the flags>.so``."""
    src = CSRC / source
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{key.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless this source is already built.
    nvcc's report (registers, shared memory, spills) is kept beside the
    library as ``.log``.  Returns the library's path."""
    src, lib = CSRC / source, library_path(source)
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib
