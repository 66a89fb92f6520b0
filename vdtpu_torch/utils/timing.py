"""Device time of a call on the card, by CUDA-graph replay: the one timing
helper of the port's probes and of ``chip_smoke.py``."""
from __future__ import annotations

import torch

# calls made on a side stream before capture (lazy init, Triton's first
# compile); with the captured ``reps`` calls they are every launch a timing
# makes: replays launch nothing new through the wrappers
GRAPH_WARMUP = 2


def time_graph_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Device ms of one call: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events, so host launch costs
    (Python, Triton's launcher) drop out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(GRAPH_WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)
