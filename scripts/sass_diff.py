#!/usr/bin/env python3
"""Compare the machine code (SASS) of the BLAST tile kernel's
instantiations in two source trees.

    python3 scripts/sass_diff.py --a OTHER/src --b src [--lib blast_matmul]

Builds each tree's kernels with that tree's own ``kernels/build.py`` (one
process per tree), disassembles the library ``--lib`` of each with
``cuobjdump -sass`` and prints, for every ``__global__`` the two share, one
JSON line: its instruction count in each tree and how many instructions
differ.  Kernel-parameter offsets (``c[0x0][...]``) are ignored, so an
added parameter alone does not count as a difference.  Needs the CUDA
toolkit (``nvcc``, ``cuobjdump``) and ``c++filt``.
"""

from __future__ import annotations

import argparse
import difflib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path


def build(src: str, lib: str) -> str:
    """The path of ``lib``'s shared library, built by the tree at ``src``."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; "
            "print(build.build_all()[sys.argv[2]])")
    out = subprocess.run([sys.executable, "-c", code, src, lib],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and Path(cand).exists():
            return cand
    raise SystemExit("sass_diff: cuobjdump not found")


def kernels(so: str) -> dict[str, list[str]]:
    """Demangled kernel name → its instructions, parameter offsets masked."""
    out = subprocess.run([cuobjdump(), "-sass", so], capture_output=True,
                         text=True, check=True).stdout
    fs: dict[str, list[str]] = {}
    cur = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            fs[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if cur and m:
            fs[cur].append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][P]",
                                  m.group(1)))
    names = list(fs)
    demangled = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    return {d.replace("(anonymous namespace)::", "").split("(")[0]: fs[n]
            for n, d in zip(names, demangled)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="one tree's src directory")
    ap.add_argument("--b", required=True, help="the other tree's src")
    ap.add_argument("--lib", default="blast_matmul",
                    help="the library (csrc/<lib>.cu) to compare")
    args = ap.parse_args()
    a, b = (kernels(build(s, args.lib)) for s in (args.a, args.b))
    for name in sorted(set(a) & set(b)):
        sm = difflib.SequenceMatcher(None, a[name], b[name], autojunk=False)
        differ = sum(max(i2 - i1, j2 - j1)
                     for tag, i1, i2, j1, j2 in sm.get_opcodes()
                     if tag != "equal")
        print(json.dumps({"kernel": name, "a_instructions": len(a[name]),
                          "b_instructions": len(b[name]),
                          "differ": differ}), flush=True)
    only = sorted(set(a) ^ set(b))
    print(json.dumps({"only_in_one": only}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
