"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Every ``csrc/*.cu`` becomes one shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/lib<name>_<hash>.so csrc/<name>.cu

The libraries go to ``build/torch_kernels/`` beside the package (listed in
``.gitignore``), named by a hash of the sources and flags, so an unchanged
source is built once. All sources build in parallel, one ``nvcc`` each.
Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; the Python wrapper raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per kernel source: {"path", "seconds" (0.0 when cached), "ptxas" (nvcc's -v lines)}
build_info: dict[str, dict] = {}


def sources() -> dict[str, str]:
    """Kernel name -> ``.cu`` path, for every source under ``csrc/``."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _digest(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and the headers beside it (another directory's, for an A/B)
    for path in [src] + sorted(glob.glob(os.path.join(os.path.dirname(src), "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build_one(name: str, src: str) -> dict:
    path = os.path.join(BUILD_DIR, f"lib{name}_{_digest(src)}.so")
    log_path = path + ".log"
    if os.path.exists(path):
        ptxas = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                ptxas = f.read()
        return {"path": path, "seconds": 0.0, "ptxas": ptxas}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                         capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}\n{res.stderr}")
    ptxas = (res.stdout + res.stderr).strip()
    with open(log_path, "w") as f:
        f.write(ptxas)
    os.replace(tmp, path)  # atomic: another process never loads a partial file
    return {"path": path, "seconds": seconds, "ptxas": ptxas}


def build_all() -> dict[str, dict]:
    """Build every kernel source not built yet, all in parallel."""
    with _lock:
        todo = {n: s for n, s in sources().items() if n not in build_info}
        if todo:
            with ThreadPoolExecutor(max_workers=len(todo)) as ex:
                futs = {n: ex.submit(_build_one, n, s) for n, s in todo.items()}
                for n, fut in futs.items():
                    build_info[n] = fut.result()
        return dict(build_info)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _libs:
        info = build_all()
        if name not in info:
            raise KeyError(f"no kernel source csrc/{name}.cu")
        with _lock:
            _libs.setdefault(name, ctypes.CDLL(info[name]["path"]))
    return _libs[name]
