"""The port's counterpart of ``scripts/mosaic_probe.py``: its three probes,
each on its hand-written kernel (``vdtpu_torch/ops/probes.py``) at the
script's shapes and on the script's data.

    python -m vdtpu_torch.probes        # on the card

1. int8 matmul: s8 ones [4096, 2880] x s8 ones [2880, 128] -> s32, timed
   beside ``torch._int_mm`` on the same operands (the script's Pallas
   against XLA's int8 dot);
2. shifted slice-add: i32 [1056, 320] (arange % 7), rows at offsets -66,
   -1, 1, 66 summed;
3. scratch slice-write: bf16 [512, 320] (arange % 5) cast to s8 one row
   down.

Each probe checks its kernel exactly against the plain version and against
the script's own closed-form check, times it on the card by CUDA-graph
replay between CUDA events, and prints one line; a probe that fails raises.
On the CPU (``main("cpu")``) the wrappers run their plain versions and
nothing is timed.
"""
from __future__ import annotations

import numpy as np
import torch

from vdtpu_torch.ops.probes import (
    probe_s8mm, probe_s8mm_plain, probe_scratch, probe_scratch_plain, probe_shift,
    probe_shift_plain)
from vdtpu_torch.utils.timing import GRAPH_WARMUP, time_graph_ms

_REPS = 10
# kernel launches of one probe on the card: the check, the timing's warm-up
# calls and the calls captured in its graph (replays launch nothing new)
LAUNCHES_PER_PROBE = 1 + GRAPH_WARMUP + _REPS


def _result(name, shape, out, plain, closed_form, kern, library=None):
    exact = bool(torch.equal(out, plain))
    script_ok = bool(np.array_equal(out.cpu().numpy(), closed_form))
    timed = out.is_cuda
    return dict(probe=name, shape=shape, ok=exact and script_ok, equals_plain=exact,
                script_check=script_ok, ms=time_graph_ms(kern, _REPS) if timed else None,
                library_ms=time_graph_ms(library, _REPS) if timed and library else None)


def probe_int8_mm(device):
    m, k, n = 4096, 2880, 128
    a = torch.ones((m, k), dtype=torch.int8, device=device)
    b = torch.ones((k, n), dtype=torch.int8, device=device)
    out = probe_s8mm(a, b)
    b_cm = b.t().contiguous().t()   # torch._int_mm's column-major operand
    lib = (lambda: torch._int_mm(a, b_cm)) if out.is_cuda else None
    return _result("int8_mm", [m, k, n], out, probe_s8mm_plain(a, b),
                   np.full((m, n), k, np.int32), lambda: probe_s8mm(a, b), lib)


def probe_shift_add(device):
    m, c = 1056, 320
    x = (torch.arange(m * c, dtype=torch.int32, device=device) % 7).reshape(m, c)
    xn = x.cpu().numpy()
    ref = np.zeros((m, c), np.int32)
    for o in (-66, -1, 1, 66):
        lo, hi = max(0, -o), m - max(0, o)
        ref[lo:hi] += xn[lo + o:hi + o]
    return _result("shift", [m, c], probe_shift(x), probe_shift_plain(x), ref,
                   lambda: probe_shift(x))


def probe_scratch_write(device):
    m, c = 512, 320
    x = (torch.arange(m * c, dtype=torch.int32, device=device) % 5).reshape(m, c)
    x = x.to(torch.bfloat16)
    ref = np.zeros((m, c), np.int8)
    ref[1:] = x.float().cpu().numpy().astype(np.int8)[:m - 1]
    return _result("scratch", [m, c], probe_scratch(x), probe_scratch_plain(x), ref,
                   lambda: probe_scratch(x))


PROBES = (probe_int8_mm, probe_shift_add, probe_scratch_write)


def main(device=None) -> list[dict]:
    """Run the three probes; returns their results, raises if one failed."""
    from vdtpu_torch.serving.api import resolve_device
    dev = resolve_device(device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu, plain versions"
    results = []
    for probe in PROBES:
        r = probe(dev)
        fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        print(f"probe {r['probe']} {r['shape']}: ok={r['ok']} (equals plain "
              f"{r['equals_plain']}, script check {r['script_check']}) kernel "
              f"{fmt(r['ms'])} (CUDA-graph replay)"
              + (f", torch._int_mm {fmt(r['library_ms'])}" if r["probe"] == "int8_mm" else "")
              + f" [{where}]", flush=True)
        results.append(r)
    failed = [r["probe"] for r in results if not r["ok"]]
    if failed:
        raise RuntimeError(f"probes failed: {failed}")
    return results


if __name__ == "__main__":
    main()
