#!/usr/bin/env python3
"""Registers, stack and instruction mix of the port's CUDA kernels.

Run from the root of a checkout on a machine with the CUDA toolkit::

    python3 scripts/kernel_resources.py [--match flash]

It builds the library as ``chip_smoke.py`` does (``utils/cuda_build.py``;
nothing is compiled again when it exists) and reads it with ``cuobjdump``:
``-res-usage`` gives each kernel's registers per thread and its stack
frame in bytes (where spilled registers go: a kernel without local arrays
spills when it is not 0); ``-sass`` gives the count of tensor-core products
(``HMMA``), fp32 FMAs (``FFMA``), ``ldmatrix`` loads (``LDSM``) and
asynchronous copies (``LDGSTS``). One JSON line per kernel whose demangled
name holds ``--match``.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from horovod_tpu_torch.utils import cuda_build  # noqa: E402

OPCODES = ("HMMA", "FFMA", "LDSM", "LDGSTS")


def _tool(name: str) -> str:
    found = shutil.which(name) or str(Path(cuda_build._nvcc()).parent / name)
    if not Path(found).exists():
        raise RuntimeError(f"{name} was not found")
    return found


def _cuobjdump(flag: str, library: Path) -> str:
    return subprocess.run([_tool("cuobjdump"), flag, str(library)],
                          capture_output=True, text=True, check=True).stdout


def resources(library: Path):
    """{mangled kernel: {registers, stack, opcode counts}}."""
    kernels, current = {}, None
    for line in _cuobjdump("-res-usage", library).splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            current = kernels.setdefault(m.group(1), {})
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+)", line)
        if m and current is not None:
            current.update(registers=int(m.group(1)), stack=int(m.group(2)))
    current = None
    for line in _cuobjdump("-sass", library).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = kernels.setdefault(m.group(1), {})
            current.update(dict.fromkeys(OPCODES, 0))
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                      line)
        if current is not None and m and m.group(1) in OPCODES:
            current[m.group(1)] += 1
    return kernels


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--match", default="")
    args = parser.parse_args()
    kernels = resources(cuda_build.build())
    demangled = subprocess.run([_tool("cu++filt")], input="\n".join(kernels),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    for name, info in sorted(zip(demangled, kernels.values()),
                             key=lambda kv: kv[0]):
        if args.match in name:
            print(json.dumps({"kernel": name, **info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
