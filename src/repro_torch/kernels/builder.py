"""Build and load the hand-written CUDA kernels (one shared builder).

Each kernel is one CUDA source under ``csrc/`` with a plain C interface
(the bf16 kernels share the header ``csrc/mma_bf16.cuh``).  It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library in ``build/kernels/`` of
the repository checkout at its first launch, and loaded with ``ctypes``;
nothing compiles at import time.  The library's file name carries a hash
of the source, its headers and the flags, so an edited source is rebuilt
and an unchanged one reused; it is written under a temporary name and
renamed into place, so a concurrent build never loads a half-written
file.  :func:`build_many` starts one ``nvcc`` per source, all
together, and waits for them all.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

# build/kernels/ of the checkout: kernels -> repro_torch -> src -> root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class KernelSource:
    """One CUDA source, the headers it includes and the ``nvcc`` flags it
    is built with."""

    name: str  # stem of the library file
    source: Path
    flags: tuple[str, ...]
    headers: tuple[Path, ...] = ()

    def library_path(self) -> Path:
        """Where the library of this source, its headers and these flags
        lives."""
        text = b"".join(f.read_bytes() for f in (self.source, *self.headers))
        digest = hashlib.sha256(text + "\0".join(self.flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"


@dataclasses.dataclass(frozen=True)
class BuildResult:
    """A built kernel library: its path, the seconds ``nvcc`` took (0.0 when
    an up-to-date library was already there) and ``nvcc``'s output (the
    ``-Xptxas -v`` register and shared-memory report)."""

    path: Path
    seconds: float
    log: str


def _nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or the default
    toolkit location."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "the port's kernels")
    return str(path)


def build_many(kernels: "list[KernelSource] | tuple[KernelSource, ...]"
               ) -> list[BuildResult]:
    """Build every library that is not up to date, one ``nvcc`` process per
    source, all started together.  Raises with ``nvcc``'s output if any
    build fails (after every process has ended)."""
    results: dict[int, BuildResult] = {}
    pending = []
    for i, k in enumerate(kernels):
        lib = k.library_path()
        log_path = lib.with_suffix(".log")
        if lib.exists():
            results[i] = BuildResult(
                lib, 0.0, log_path.read_text() if log_path.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        tmp_log = tmp.with_suffix(".log")
        with open(tmp_log, "w") as out:  # nvcc's output, read back at its end
            proc = subprocess.Popen([_nvcc(), *k.flags, "-o", str(tmp), str(k.source)],
                                    stdout=out, stderr=subprocess.STDOUT)
        pending.append((i, k, lib, tmp, tmp_log, proc, time.perf_counter()))
    failures = []
    while pending:  # collect each process as it ends, so its time is its own
        running = []
        for item in pending:
            i, k, lib, tmp, tmp_log, proc, t0 = item
            if proc.poll() is None:
                running.append(item)
                continue
            seconds = time.perf_counter() - t0
            log = tmp_log.read_text()
            tmp_log.unlink()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"nvcc failed ({proc.returncode}) building "
                                f"{k.source}:\n{log}")
                continue
            lib.with_suffix(".log").write_text(log)
            os.replace(tmp, lib)
            results[i] = BuildResult(lib, seconds, log)
        pending = running
        if pending:
            time.sleep(0.05)
    if failures:
        raise RuntimeError("\n".join(failures))
    return [results[i] for i in range(len(kernels))]


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Per kernel (mangled name) of an ``nvcc -Xptxas -v`` log: registers a
    thread and spill stores / loads (bytes)."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def cuobjdump() -> str | None:
    """Path of ``cuobjdump``, beside the ``nvcc`` the kernels are built with
    or on PATH, or None."""
    beside = Path(_nvcc()).with_name("cuobjdump")
    return str(beside) if beside.exists() else shutil.which("cuobjdump")


def sass_counts(library: Path, opcodes: tuple[str, ...] = ("HMMA", "HGMMA")
                ) -> dict[str, dict[str, int]]:
    """Per kernel (mangled name) of a built library: how many SASS
    instructions start with each of ``opcodes`` (``cuobjdump -sass``)."""
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = func.split("\n", 1)
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body)
        out[name.strip()] = {op: sum(1 for o in ops if o.startswith(op)) for op in opcodes}
    return out


def all_kernels() -> tuple[KernelSource, ...]:
    """Every kernel of the port: fused_conv3x3 (K1), flash_attention (K2),
    fused_mlp (K3), the selective scan (K4) and the flash-attention
    backward, for :func:`build_many`."""
    from . import fused_attention, fused_conv, fused_mlp, flash_attention_bwd, mamba_scan

    return (fused_conv.KERNEL, fused_attention.KERNEL, fused_mlp.KERNEL,
            mamba_scan.KERNEL, flash_attention_bwd.KERNEL)


def build(kernel: KernelSource) -> BuildResult:
    """Build one library (see :func:`build_many`)."""
    return build_many([kernel])[0]


@functools.lru_cache(maxsize=None)
def load(kernel: KernelSource) -> ctypes.CDLL:
    """The built library of ``kernel``, built if needed and loaded once.
    The caller sets the C signatures."""
    return ctypes.CDLL(str(build(kernel).path))
