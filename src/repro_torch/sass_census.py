"""Count the SASS instructions of the port's CUDA kernels.

    python -m repro_torch.sass_census SOURCE.cu [SOURCE.cu ...] [--match NAME]

Compiles each source with the port's ``nvcc`` flags (``_build.NVCC_FLAGS``)
into a temporary directory, disassembles the library with ``cuobjdump
-sass`` and prints one JSON line per kernel whose mangled name contains one
of ``--match``'s comma-separated names (every kernel without it): the
instruction count, the count of each opcode family, and each loop (a
branch back to an earlier address) with the instructions it spans, its
global loads and stores, its shared loads and FFMAs, and the subroutines
it calls (a 64-bit division is one such call) with their sizes, and its
``divisions``: each ``MUFU.RCP`` (which a 32-bit integer or a float
division inlines) and each call.  A loop's instructions are its
per-iteration issue cost; a called subroutine's are added per call taken
(a slow path, such as an IEEE division's, is called only for some
operands).  Needs the CUDA toolkit (``nvcc``,
``cuobjdump``).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

from repro_torch import _build

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+|\$[\w$.]+):")
_TARGET = re.compile(r"`\(([^)]+)\)|(0x[0-9a-f]+)")


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(path).exists():
        raise SystemExit(f"sass_census: {name} not found (needs the CUDA toolkit)")
    return path


def disassemble(source: Path, workdir: Path) -> str:
    lib = workdir / f"{source.stem}-{abs(hash(str(source)))}.so"
    subprocess.run([_tool("nvcc"), *_build.NVCC_FLAGS, "-o", str(lib), str(source)],
                   check=True, capture_output=True, text=True)
    return library_sass(lib)


def functions(sass: str) -> dict[str, list[str]]:
    """The SASS lines of each function, by mangled name."""
    out: dict[str, list[str]] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def census(lines: list[str]) -> dict:
    """Instructions, opcode families and loops of one function."""
    insns, labels = [], {}
    for line in lines:
        lm = _LABEL.match(line)
        if lm:
            labels[lm.group(1)] = len(insns)
            continue
        m = _INSN.search(line)
        if m:
            insns.append((int(m.group(1), 16), m.group(2), m.group(3)))
    addr_index = {a: i for i, (a, _, _) in enumerate(insns)}

    def target(operands):
        t = _TARGET.search(operands)
        if not t:
            return None
        if t.group(1):
            return labels.get(t.group(1))
        return addr_index.get(int(t.group(2), 16))

    # subroutines: each call's target up to its first RET
    sub_start = {target(o): o.strip() for _, op, o in insns if op.startswith("CALL")}
    sub_size = {}
    for i, name in sub_start.items():
        if i is not None:
            end = next((k for k in range(i, len(insns)) if insns[k][1].startswith("RET")),
                       len(insns) - 1)
            sub_size[name] = end - i + 1

    def span(lo, hi):
        ops = [op for _, op, _ in insns[lo:hi + 1]]
        calls = Counter()
        for _, op, operands in insns[lo:hi + 1]:
            if op.startswith("CALL"):
                calls[operands.strip()] += 1
        n_of = Counter(ops)
        return {"instructions": hi - lo + 1,
                "global_loads": {o: n for o, n in n_of.items() if o.startswith("LDG")},
                "global_stores": {o: n for o, n in n_of.items() if o.startswith("STG")},
                "shared_loads": {o: n for o, n in n_of.items() if o.startswith("LDS")},
                "ffma": sum(n for o, n in n_of.items() if o.startswith("FFMA")),
                "divisions": sum(n for o, n in n_of.items() if o.startswith("MUFU.RCP"))
                + sum(calls.values()),
                "calls": {c: {"count": n, "subroutine_instructions": sub_size.get(c)}
                          for c, n in calls.items()}}

    loops = []
    for i, (_, op, operands) in enumerate(insns):
        if op.startswith("BRA"):
            t = target(operands)
            if t is not None and t < i:
                loops.append({"from": t, "to": i, **span(t, i)})
    families = Counter(op.split(".")[0] for _, op, _ in insns)
    end = min((i for i in sub_start if i is not None), default=len(insns))
    return {"instructions": len(insns), "body_instructions": end,
            "families": dict(families.most_common()), "loops": loops,
            "body": span(0, end - 1), "subroutines": sub_size}


def select(sass: str, match: str) -> list[dict]:
    """The census of each function of ``sass`` whose mangled name contains
    one of ``match``'s comma-separated names."""
    return [{"kernel": name, **census(lines)} for name, lines in functions(sass).items()
            if any(m in name for m in match.split(","))]


def library_sass(lib: Path) -> str:
    """The SASS of a built library (``cuobjdump -sass``)."""
    return subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--match", default="", help="comma-separated substrings of kernel names")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="sass_census_") as tmp:
        for src in args.sources:
            for rec in select(disassemble(src.resolve(), Path(tmp)), args.match):
                print(json.dumps({"source": str(src), **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
