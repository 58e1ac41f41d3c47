"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one source under ``src/repro_torch/csrc/`` with a plain C
entry point.  It is compiled at first use, on the machine with the card, into
``build/kernels/<name>-<hash>/lib<name>.so`` at the root of the checkout
(a directory ``.gitignore`` lists).  The hash covers the source and the
compiler flags, so an edited source is rebuilt and an unchanged one is loaded
from the earlier build.  Nothing here runs when a module is imported.

``refuse_autograd`` and ``refuse_traced`` are the wrappers' shared guards:
a kernel launched through ctypes writes a fresh tensor that autograd cannot
see into, and reads memory that a traced tensor does not have.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise when gradients are being recorded and an input requires grad.

    The kernels are forward-only, as the reference's are (no Pallas kernel
    defines a ``custom_vjp``, and ``jax.grad`` through one raises).  A ctypes
    launch returns a tensor without a ``grad_fn``, so the gradients to its
    inputs would silently go missing.  Raised on either device, so a CPU
    run fails where the card would."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {kernel} kernel is forward-only and cannot record "
            f"gradients: call it under torch.no_grad() / "
            f"torch.inference_mode(), or train with use_flash_kernel=False "
            f"(the plain path), as the reference does")


def refuse_traced(kernel: str, *tensors) -> None:
    """Raise for a tensor with no memory of its own: a meta or fake tensor
    (a dry run's trace) or a DTensor.  Its data pointer is not the card's,
    and its plain version would hide that a traced step reached a
    kernel."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    for t in tensors:
        if t.is_meta or isinstance(t, (FakeTensor, DTensor)):
            raise ValueError(f"the {kernel} kernel runs on cpu or cuda "
                             f"tensors, not a traced {type(t).__name__} on "
                             f"{t.device}")


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH, CUDA_HOME and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(NVCC_FLAGS).encode()
    key = hashlib.sha256(src + flags).hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{key}" / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this exact source is built already.

    The compiler's report (registers, shared memory, spills per kernel, from
    ``-Xptxas -v``) is kept beside the library as ``build.log``."""
    lib = library_path(name)
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name and rename, so a build cut short never
    # leaves a library that looks finished.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (lib.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def build_all(names) -> Dict[str, Path]:
    """Build every kernel of ``names`` at once, one nvcc process each, all
    started together; raises the first failure after all have ended."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(build, name) for name in names}
    return {name: fut.result() for name, fut in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``name``, once per
    process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
