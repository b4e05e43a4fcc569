"""Build and load the port's CUDA kernels (``cmfrec_torch/csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object, all
of them at once (one ``nvcc`` process per source), and the objects are
linked into one shared library with a plain C interface, on first use, in
``build/`` at the repository root; the file name carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.  The library is bound
with ``ctypes``.  Nothing here runs at import time: the CPU path never needs
``nvcc``.  :func:`probe_libs` builds K3's or K2's source alone with a
probe flag, for scripts/time_k3_wide_torch.py and
scripts/time_k2_wide_torch.py only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(_PKG / "csrc" / name for name in
                ("masked_matmul.cu", "sparse_cg.cu", "k1_probes.cu",
                 "cd_solve.cu", "masked_rows.cu"))
HEADERS = (_PKG / "csrc" / "masked_gram.cuh",)
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                           "the CUDA kernels cannot be built")
    return str(path)


def _hashed(stem: str, sources, flags) -> Path:
    """The library built from `sources` with `flags`: its name carries a hash
    of both, so an edited source is rebuilt and a stale library never loaded."""
    h = hashlib.sha256()
    for src in (*sources, *HEADERS):
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    return _hashed("libcmfrec_kernels", SOURCES, NVCC_FLAGS)


def _nvcc_all(cmds) -> str:
    """Run the nvcc commands at once and wait for all; raise if one failed.
    Returns the diagnostics of all."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    try:
        outs = [proc.communicate() for proc in procs]
    finally:  # an interrupted wait leaves no compiler running
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}{err}")
    return "".join(out + err for out, err in outs)


def _build_all(targets) -> str:
    """Build each (library path, sources, flags) of `targets`: every object
    compiled at once (one nvcc a source), then each library linked.
    Returns nvcc's diagnostics."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compiles, links, done, temps = [], [], [], []
    for path, sources, flags in targets:
        tag = f"{path.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
        tmp = BUILD_DIR / f"{tag}.so.tmp"
        compiles += [[nvcc, *flags, "-c", "-o", str(obj), str(src)]
                     for src, obj in zip(sources, objs)]
        links.append([nvcc, flags[0], "-shared", "-o", str(tmp),
                      *map(str, objs)])
        done.append((tmp, path))
        temps += [*objs, tmp]
    try:
        log = _nvcc_all(compiles)
        log += _nvcc_all(links)
        for tmp, path in done:  # atomic: a loader never sees half a file
            os.replace(tmp, path)
    finally:
        for f in temps:
            f.unlink(missing_ok=True)
    return log


@lru_cache(maxsize=None)
def build() -> tuple[Path, str]:
    """Compile the kernels unless the hashed library exists.  Returns the
    library's path and nvcc's diagnostics (``-Xptxas -v``: registers, shared
    memory and spills per kernel; empty when nothing was compiled)."""
    path = library_path()
    if path.exists():
        return path, ""
    return path, _build_all([(path, SOURCES, NVCC_FLAGS)])


def _bind_bucket_cg(so) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    so.cmf_bucket_cg.argtypes = [P] * 10 + [I] * 10 + [P]
    so.cmf_bucket_cg.restype = I


def _bind_masked(so) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    so.cmf_masked_gram_matvec.argtypes = [P] * 5 + [I] * 7 + [P]
    so.cmf_masked_gram_matvec.restype = I
    so.cmf_gram_geometry.argtypes = [I, I, I, ctypes.POINTER(I)]
    so.cmf_gram_geometry.restype = I
    so.cmf_masked_rhs.argtypes = [P] * 6 + [I] * 7 + [P]
    so.cmf_masked_rhs.restype = I
    so.cmf_rhs_geometry.argtypes = [I, I, I, ctypes.POINTER(I)]
    so.cmf_rhs_geometry.restype = I
    so.cmf_error_string.argtypes = [I]
    so.cmf_error_string.restype = ctypes.c_char_p


# the probe builds: kernel -> (its source, the macro of its probe bits, binder)
PROBES = {"k3": (_PKG / "csrc" / "sparse_cg.cu", "CMF_K3_PROBE",
                 _bind_bucket_cg),
          "k2": (_PKG / "csrc" / "masked_matmul.cu", "CMF_K2_PROBE",
                 _bind_masked)}


def probe_libs(bits, kernel="k3") -> dict:
    """`kernel`'s source alone (K3: sparse_cg.cu, K2: masked_matmul.cu),
    built once for each of `bits` with ``-D<macro>=<bits>`` (all compiled at
    once): a launch of such a build leaves out the parts its bits name (K3
    past K = 256: 1 the slot passes, 2 gfix v, 4 the stop rule; K2's wide
    kernel: 1 V and the products, 2 the Be copies), so that
    scripts/time_k3_wide_torch.py and scripts/time_k2_wide_torch.py can
    split a launch's time.  Its results are not the kernel's, and the ops
    never load it.  Returns {bits: the bound library}."""
    source, macro, bind = PROBES[kernel]
    flags = {b: (*NVCC_FLAGS, f"-D{macro}={int(b)}") for b in bits}
    want = {b: _hashed(f"libcmfrec_{kernel}_probe{int(b)}", (source,), f)
            for b, f in flags.items()}
    missing = [(want[b], (source,), flags[b]) for b in want
               if not want[b].exists()]
    if missing:
        _build_all(missing)
    out = {}
    for b, path in want.items():
        so = ctypes.CDLL(str(path))
        bind(so)
        out[b] = so
    return out


@lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    so = ctypes.CDLL(str(build()[0]))
    P, I = ctypes.c_void_p, ctypes.c_int
    _bind_masked(so)
    so.cmf_k1_probe.argtypes = [P, P, P, P] + [I] * 7 + [P]
    so.cmf_k1_probe.restype = I
    so.cmf_w_stream.argtypes = [P, P] + [I] * 6 + [P]
    so.cmf_w_stream.restype = I
    _bind_bucket_cg(so)
    so.cmf_cd_solve.argtypes = ([P, ctypes.c_longlong, P, P, I, P, P, P]
                                + [I] * 5 + [ctypes.c_double, I, I, P])
    so.cmf_cd_solve.restype = I
    so.cmf_cd_plan.argtypes = [I, I, I, I, ctypes.POINTER(I)]
    so.cmf_cd_plan.restype = I
    so.cmf_rowlist_build.argtypes = [P, I, I, I, I] + [P] * 5 + [I, I, P]
    so.cmf_rowlist_build.restype = I
    so.cmf_gram_rows.argtypes = [P] * 9 + [I] * 5 + [P]
    so.cmf_gram_rows.restype = I
    return so


@lru_cache(maxsize=None)
def _device_optin(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def optin_smem(device) -> int:
    """The shared memory a block may opt in to on the card `device`, as the
    card reports it (the attribute the kernels read): what the ops' limits
    on K are held to before a launch."""
    import torch

    device = torch.device(device)
    return _device_optin(torch.cuda.current_device() if device.index is None
                         else device.index)


@lru_cache(maxsize=None)
def _device_sms(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SMs of the card `device`."""
    import torch

    device = torch.device(device)
    return _device_sms(torch.cuda.current_device() if device.index is None
                       else device.index)


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err:
        msg = lib().cmf_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} ({msg})")
