"""Static SASS counts of a built kernel library's main loops: which
instructions one iteration of each kernel's hottest loop issues, and how
many that is per unit of work (a score, for the attention kernels).

    python -m vdtpu_torch.utils.sass flash_fwd nomax_fwd flash_bwd   # where nvcc is
    python -m vdtpu_torch.utils.sass resblock_q qconv3
    python -m vdtpu_torch.utils.sass --cubin build/triton/<hash>/kernel.cubin

It builds (or finds) ``build/kernels/lib<name>-*.so`` through
``vdtpu_torch.ops.kernels.build``, disassembles it with the toolkit's
``cuobjdump -sass``, and for every kernel takes the innermost loop (a
backward branch) with a tensor-core instruction in its body, a wgmma one
where the kernel has one (the whole-ResBlock kernel also holds the general
route's mma.sync loop). Each instruction is counted once, as written; a
predicated instruction counts whether or not it runs. Each row says how
many wgmma and mma.sync instructions the loop holds.

``--cubin`` disassembles any cubin (a Triton kernel's, from its cache
directory) and counts, for each kernel, its memory instructions by full
opcode (``STG.E.U8``, ``STS.128``, ...) over the whole kernel: what its
loads and stores are.
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
# by a substring of the kernel's mangled name (or else of the library's):
# every flash backward kernel has each warp compute a 16 x 64 score tile an
# iteration, the forwards' mma.sync kernels a 16 x 64 tile, the forwards'
# wgmma kernel (csrc/attn_fwd_sm90.cuh) a 16 x 128 tile
WORK_PER_ITER = {"attn_fwd_wg_kernel": 16 * 128 // 32, "flash_fwd_kernel": 16 * 64 // 32,
                 "nomax_fwd_kernel": 16 * 64 // 32, "flash_bwd": 16 * 64 // 32}
# the int8 convs' halo main loop (csrc/qconv_sm90.cuh::halo_tile_s8, in the
# s8 conv kernel and the whole-ResBlock kernel, templates <T, KC, BN, BM>):
# an iteration is one (chunk, tap) step, KC / 32 x BN / 8 products of 64
# pixels x 8 channels x 32 input channels for each warpgroup
HALO_LOOP_KERNELS = ("qconv3_halo_kernel", "resblock_kernel")
_WGMMA, _MMA_SYNC = ("HGMMA", "IGMMA"), ("HMMA", "IMMA")
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
    """The body of the innermost loop (the fewest instructions) that holds a
    tensor-core instruction. A backward branch from a retry block the
    compiler placed out of line (an mbarrier wait's) spans most of the
    kernel and holds every product, so "the most products" would pick it."""
    loops = []
    for i, (addr, text) in enumerate(instrs):
        m = _BRA_RE.search(text)
        if not m or int(m.group(1), 16) >= addr:
            continue
        target = int(m.group(1), 16)
        body = [t for a, t in instrs[: i + 1] if a >= target]
        if any(_opcode(t) in _CLASSES[0][1] for t in body):
            loops.append(body)
    wgmma = [b for b in loops if any(_opcode(t) in _WGMMA for t in b)]
    return min(wgmma or loops, key=len, default=[])


def _work(fn: str, lib: str) -> int | None:
    """Units of work a thread's warp does in one main-loop iteration."""
    if any(k in fn for k in HALO_LOOP_KERNELS):
        kc, bn = (int(v) for v in re.findall(r"Li(\d+)E", fn)[:2])
        return (kc // 32) * (bn // 8)
    return next((w for k, w in WORK_PER_ITER.items() if k in fn or k in lib), None)


def loop_counts(name: str) -> dict[str, dict]:
    """Per kernel of library ``name``: its main loop's instruction count,
    the count by class and, where the work per iteration is known, per unit."""
    from vdtpu_torch.ops.kernels.build import _lib_path, load
    load(name)
    sass = subprocess.run([_cuobjdump(), "-sass", _lib_path(name)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for fn, instrs in parse(sass).items():
        body = main_loop(instrs)
        if not body:
            continue
        work = _work(fn, name)
        ops = collections.Counter(_opcode(t) for t in body)
        classes = {c: sum(ops[o] for o in names) for c, names in _CLASSES}
        classes["other"] = len(body) - sum(classes.values())
        row = dict(loop_instructions=len(body), wgmma=sum(ops[o] for o in _WGMMA),
                   mma_sync=sum(ops[o] for o in _MMA_SYNC), by_class=classes,
                   opcodes=dict(ops.most_common()))
        if work:
            row["per_unit"] = len(body) / work
            row["per_unit_by_class"] = {c: n / work for c, n in classes.items()}
        out[fn] = row
    return out


_MEM_OPS = ("LDG", "STG", "LDS", "STS", "LDGSTS", "LDSM", "RED", "ATOM", "ATOMS")


def memory_ops(cubin: str) -> dict[str, dict[str, int]]:
    """Per kernel of a cubin: its memory instructions by full opcode (all of
    the kernel, each counted once as written)."""
    sass = subprocess.run([_cuobjdump(), "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for fn, instrs in parse(sass).items():
        ops = collections.Counter()
        for _, text in instrs:
            parts = text.split()
            op = parts[1] if parts and parts[0].startswith("@") and len(parts) > 1 else (
                parts[0] if parts else "")
            if op.split(".")[0] in _MEM_OPS:
                ops[op] += 1
        out[fn] = dict(ops.most_common())
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cubin"]:
        for path in sys.argv[2:]:
            print(json.dumps({os.path.basename(path): memory_ops(path)}, indent=1))
    else:
        for lib in sys.argv[1:]:
            print(json.dumps({lib: loop_counts(lib)}, indent=1))
