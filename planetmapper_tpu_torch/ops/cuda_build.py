"""
Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` is compiled with ``nvcc`` (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``, at first use on
a CUDA device, never at import. The library lands in ``build/`` at the
repository root, named by the hash of its source and the flags, with the
``-Xptxas -v`` report (registers, spills) beside it. A
:class:`CudaLibrary` also names its kernel's launch counter
(``launches.<name>`` in :mod:`..tracing`), which the wrapper raises by one
for each launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections.abc import Callable
from pathlib import Path

from .. import tracing

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)


def find_nvcc() -> str:
    candidates = [shutil.which('nvcc')]
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if cuda_home:
        candidates.append(os.path.join(cuda_home, 'bin', 'nvcc'))
    candidates.append('/usr/local/cuda/bin/nvcc')
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        'nvcc not found: the port compiles its CUDA kernels from '
        f'{CSRC} with the CUDA toolkit at first use on a CUDA device'
    )


class CudaLibrary:
    """
    One kernel library: ``csrc/<source>`` built into ``build/lib<name>-<hash>
    .so`` with :data:`NVCC_FLAGS` and its own ``flags``. ``configure(lib)``
    declares the C functions' types and checks the library against the
    wrapper (raising on a mismatch).
    """

    def __init__(self, name: str, source: str,
                 configure: Callable[[ctypes.CDLL], None],
                 flags: tuple[str, ...] = ()) -> None:
        self.name = name
        self.source = CSRC / source
        self.flags = NVCC_FLAGS + tuple(flags)
        self._configure = configure
        self._lib: ctypes.CDLL | None = None
        #: the launch counter's name in :mod:`..tracing`
        self.counter = f'launches.{name}'
        self._ptxas_log = ''
        #: seconds nvcc took in this process's build (0.0 when cached)
        self.build_seconds = 0.0

    def count_launches(self, n: int = 1) -> None:
        """Count ``n`` launches of the library's kernel."""
        tracing.count(self.counter, n)

    def launch_count(self) -> int:
        """Kernel launches so far in this process (plain-version calls excluded)."""
        return tracing.counts().get(self.counter, 0)

    def reset_launch_count(self) -> None:
        tracing.reset(self.counter)

    def ptxas_log(self) -> str:
        """The ``-Xptxas -v`` output of the build (empty before a build)."""
        return self._ptxas_log

    def build(self) -> Path:
        """Compile the source unless built for this exact source and flags."""
        digest = hashlib.sha256(
            self.source.read_bytes() + ' '.join(self.flags).encode()
        ).hexdigest()[:16]
        lib = BUILD_DIR / f'lib{self.name}-{digest}.so'
        log = BUILD_DIR / f'lib{self.name}-{digest}.ptxas.txt'
        if not lib.exists():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *self.flags, '-o', str(tmp), str(self.source)],
                capture_output=True, text=True, check=False,
            )
            self.build_seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f'nvcc failed with exit code {proc.returncode} on '
                    f'{self.source}:\n{proc.stdout}\n{proc.stderr}'
                )
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)
        self._ptxas_log = log.read_text() if log.exists() else ''
        return lib

    def load(self) -> ctypes.CDLL:
        """Build (at first use) and load the library; returns the handle."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._configure(lib)
            self._lib = lib
        return self._lib


def check_launch(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C launch function."""
    if rc != 0:
        raise RuntimeError(f'{what} kernel launch failed: cudaError {rc}')


def build_all(libraries) -> None:
    """
    Build several libraries at once, one ``nvcc`` process each, all started
    together (a build is single-threaded), then load them.
    """
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        list(pool.map(CudaLibrary.build, libraries))
    for library in libraries:
        library.load()
