"""Machine-instruction counts of a kernel source (diagnostic, not product
code).

Builds each CUDA source given with the package's flags (``nvcc`` for
``sm_90a``, as ``ops/cuda_build`` does), disassembles the library with
the toolkit's ``cuobjdump -sass`` and counts, for every kernel function
whose name holds ``--kernel``, its instructions by opcode.  The opcodes
of a block-max epilogue (the penalty add, the ball test, the max) are
also given per accumulator value of a thread (``--per``, 64 for a
m64n128 wgmma tile), which is how ``csrc/phase_a_qm.cu``'s note compares
its designs.  It needs the CUDA toolkit: it runs on the machine with the
card.

Usage: python -m oryx_tpu_torch.bench.diag.sass_counts
       --source oryx_tpu_torch/csrc/phase_a_qm.cu [--source other.cu]
       [--kernel phase_a_qm] [--per 64]
Prints one JSON line per kernel function.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import tempfile
from pathlib import Path

from ...ops import cuda_build

__all__ = ["EPILOGUE_OPS", "opcode_counts", "sass_of", "main"]

# the epilogue's opcodes: add, xor, population count, compare, select, max
EPILOGUE_OPS = ("FADD", "LOP3", "POPC", "ISETP", "FSEL", "FMNMX")
_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTRUCTION = re.compile(
    r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def opcode_counts(sass: str, kernel: str = "") -> dict[str, collections.Counter]:
    """Instructions by opcode (the mnemonic before its first dot) of every
    function of ``cuobjdump -sass`` output whose name holds ``kernel``."""
    out: dict[str, collections.Counter] = {}
    current = None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = m.group(1) if kernel in m.group(1) else None
            if current is not None:
                out[current] = collections.Counter()
            continue
        m = _INSTRUCTION.match(line)
        if m and current is not None:
            out[current][m.group(1)] += 1
    return out


def sass_of(source: Path, include: Path) -> str:
    """``cuobjdump -sass`` of ``source`` built with the package's flags."""
    nvcc = cuda_build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "lib.so")
        subprocess.run([nvcc, *cuda_build._FLAGS, "-I", str(include), "-o",
                        lib, str(source)], check=True, capture_output=True)
        return subprocess.run([cuobjdump, "-sass", lib], check=True,
                              capture_output=True, text=True).stdout


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", required=True)
    ap.add_argument("--kernel", default="phase_a_qm")
    ap.add_argument("--per", type=int, default=64,
                    help="accumulator values of a thread")
    args = ap.parse_args(argv)
    include = Path(cuda_build.__file__).resolve().parents[1] / "csrc"
    for source in args.source:
        for fn, counts in opcode_counts(sass_of(Path(source), include),
                                        args.kernel).items():
            epi = {op: counts[op] for op in EPILOGUE_OPS}
            print(json.dumps({
                "source": source, "function": fn,
                "instructions": sum(counts.values()), "epilogue": epi,
                "epilogue_per_accumulator": sum(epi.values()) / args.per,
                "per_accumulator": {op: n / args.per
                                    for op, n in epi.items()}}),
                flush=True)


if __name__ == "__main__":
    main()
