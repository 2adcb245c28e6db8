#!/usr/bin/env python3
"""Registers, stack and instruction mix of the port's CUDA kernels.

Run from the root of a checkout on a machine with the CUDA toolkit::

    python3 scripts/kernel_resources.py [--match flash] [--dump FILE]

It builds the library as ``chip_smoke.py`` does (``utils/cuda_build.py``;
nothing is compiled again when it exists) and reads it with ``cuobjdump``:
``-res-usage`` gives each kernel's registers per thread and its stack
frame in bytes (where spilled registers go: a kernel without local arrays
spills when it is not 0); ``-sass`` gives the count of its instructions
(``total``), of tensor-core products (``HMMA``), fp32 FMAs (``FFMA``),
``ldmatrix`` loads (``LDSM``), asynchronous copies (``LDGSTS``), integer
multiply-adds (``IMAD``, every form), three-input logic (``LOP3``), the
special-function unit (``MUFU``), shared-memory loads (``LDS``) and
conversions (``I2F``, ``I2FP``: Hopper's integer-to-float, ``F2I``,
``FRND``), and of each form of global load
and store by its full name (``LDG.E.128.CONSTANT`` against ``LDG.E``,
``STG.E.64`` against ``STG.E.U8``: the width each moves). Counts are of the
instructions in the code, not of those executed. One JSON line per kernel
whose demangled name holds ``--match``; ``--dump`` writes those kernels'
SASS to a file.
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

OPCODES = ("HMMA", "FFMA", "LDSM", "LDGSTS", "IMAD", "LOP3", "MUFU", "LDS",
           "I2F", "I2FP", "F2I", "FRND")
MEMORY = ("LDG", "STG")


def _tool(name: str) -> str:
    found = shutil.which(name) or str(Path(cuda_build._nvcc()).parent / name)
    if not Path(found).exists():
        raise RuntimeError(f"{name} was not found")
    return found


def _cuobjdump(flag: str, library: Path) -> str:
    return subprocess.run([_tool("cuobjdump"), flag, str(library)],
                          capture_output=True, text=True, check=True).stdout


def resources(library: Path):
    """({mangled kernel: {registers, stack, instruction counts}},
    {mangled kernel: its SASS lines})."""
    kernels, sass, current = {}, {}, None
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
            current.update(total=0, **dict.fromkeys(OPCODES, 0),
                           memory={})
            lines = sass.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z0-9]+(?:\.[A-Z0-9_]+)*)", line)
        if current is None or not m:
            continue
        lines.append(line.strip())
        name = m.group(1)
        base = name.split(".")[0]
        current["total"] += 1
        if base in OPCODES:
            current[base] += 1
        if base in MEMORY:
            current["memory"][name] = current["memory"].get(name, 0) + 1
    return kernels, sass


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--match", default="")
    parser.add_argument("--dump", default=None)
    args = parser.parse_args()
    kernels, sass = resources(cuda_build.build())
    demangled = subprocess.run([_tool("cu++filt")], input="\n".join(kernels),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    dump = []
    for name, mangled in sorted(zip(demangled, kernels)):
        if args.match in name:
            print(json.dumps({"kernel": name, **kernels[mangled]}),
                  flush=True)
            dump += [f"// {name}", *sass.get(mangled, []), ""]
    if args.dump:
        Path(args.dump).parent.mkdir(parents=True, exist_ok=True)
        Path(args.dump).write_text("\n".join(dump))
    return 0


if __name__ == "__main__":
    sys.exit(main())
