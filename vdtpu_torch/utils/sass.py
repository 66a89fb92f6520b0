"""Static SASS counts of a built kernel library's main loops: which
instructions one iteration of each kernel's hottest loop issues, and how
many that is per unit of work (a score, for the attention kernels).

    python -m vdtpu_torch.utils.sass flash_bwd     # on the machine with nvcc

It builds (or finds) ``build/kernels/lib<name>-*.so`` through
``vdtpu_torch.ops.kernels.build``, disassembles it with the toolkit's
``cuobjdump -sass``, and for every kernel takes the loop (a backward branch)
with the most tensor-core instructions in its body, the innermost such loop
when several tie (an enclosing loop repeats the same products). Each
instruction is counted once, as written; a predicated instruction counts
whether or not it runs.
"""
from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys

_FUNC_RE = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR_RE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRA_RE = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")
# units of work one thread does in one iteration of a kernel's main loop,
# by a substring of the mangled name: every flash backward kernel has each
# warp compute a 16 x 64 score tile an iteration
WORK_PER_ITER = {"flash_bwd": 16 * 64 // 32}
_CLASSES = (("mma", ("HMMA", "IMMA", "HGMMA", "IGMMA")), ("exp", ("MUFU",)),
            ("fp32", ("FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "FSETP")),
            ("pack", ("F2FP",)), ("shared", ("LDS", "LDSM", "STS")),
            ("global", ("LDG", "STG", "LDGSTS", "RED", "ATOM")),
            ("sync", ("BAR", "SYNCS", "DEPBAR", "WARPSYNC")))


def _cuobjdump() -> str:
    from vdtpu_torch.ops.kernels.build import nvcc_path
    return os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")


def parse(sass: str) -> dict[str, list[tuple[int, str]]]:
    """Kernel name -> [(address, instruction text)]."""
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNC_RE.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSTR_RE.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def _opcode(text: str) -> str:
    parts = text.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0].split(".")[0] if parts else ""


def main_loop(instrs: list[tuple[int, str]]) -> list[str]:
    """The body of the innermost loop with the most tensor-core instructions."""
    best: list[str] = []
    best_key = (-1, 0)
    for i, (addr, text) in enumerate(instrs):
        m = _BRA_RE.search(text)
        if not m or int(m.group(1), 16) >= addr:
            continue
        target = int(m.group(1), 16)
        body = [t for a, t in instrs[: i + 1] if a >= target]
        mmas = sum(_opcode(t) in _CLASSES[0][1] for t in body)
        key = (mmas, -len(body))
        if key > best_key:
            best, best_key = body, key
    return best


def loop_counts(name: str) -> dict[str, dict]:
    """Per kernel of library ``name``: its main loop's instruction count,
    the count by class and, where the work per iteration is known, per unit."""
    from vdtpu_torch.ops.kernels.build import _lib_path, load
    load(name)
    sass = subprocess.run([_cuobjdump(), "-sass", _lib_path(name)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    work = next((w for k, w in WORK_PER_ITER.items() if k in name), None)
    for fn, instrs in parse(sass).items():
        body = main_loop(instrs)
        if not body:
            continue
        ops = collections.Counter(_opcode(t) for t in body)
        classes = {c: sum(ops[o] for o in names) for c, names in _CLASSES}
        classes["other"] = len(body) - sum(classes.values())
        row = dict(loop_instructions=len(body), by_class=classes,
                   opcodes=dict(ops.most_common()))
        if work:
            row["per_unit"] = len(body) / work
            row["per_unit_by_class"] = {c: n / work for c, n in classes.items()}
        out[fn] = row
    return out


if __name__ == "__main__":
    for lib in sys.argv[1:]:
        print(json.dumps({lib: loop_counts(lib)}, indent=1))
