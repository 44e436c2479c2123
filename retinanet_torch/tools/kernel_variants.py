"""One-edit variants of a CUDA source of `csrc/`, for the experiment tools.

A variant is the source with a list of (text, replacement) edits, each of
which must apply exactly once; it is written into the build directory and
compiled as a library of its own, beside the package's build of the source.
"""

from __future__ import annotations

import concurrent.futures
import subprocess
from typing import Iterable, List, Tuple

from retinanet_torch.ops.cuda_build import BUILD_DIR, CudaLibrary

Edits = List[Tuple[str, str]]


def variant_source(base: CudaLibrary, name: str, edits: Edits) -> str:
    source = base.source.read_text()
    for old, new in edits:
        if source.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} occurs "
                               f"{source.count(old)} times in {base.source}")
        source = source.replace(old, new)
    return source


def variant_library(base: CudaLibrary, declare, name: str,
                    edits: Edits) -> CudaLibrary:
    out = BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    slug = base.name + "_" + "".join(c if c.isalnum() else "_" for c in name)
    path = out / f"{slug}.cu"
    path.write_text(variant_source(base, name, edits))
    return CudaLibrary(slug, declare, source=path)


def build_all(libraries: Iterable[CudaLibrary]) -> None:
    """One `nvcc` for each library, all started together."""
    libraries = list(libraries)
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        for future in [pool.submit(lib.build) for lib in libraries]:
            future.result()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
