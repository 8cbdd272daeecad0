"""The program's own spans of a traced run, which `cvaegan_tpu_torch`
records while the profiler does (`cvaegan_tpu_torch.utils.profiling`):
the per-layer metrics of source `program_span` and `program_counter`
read them here. Where the program records none (a checkout whose
program has no spans), each function gives nothing to read, and the
metric reads None."""

from __future__ import annotations

from typing import List, Optional, Tuple


def recorded() -> List:
    """The spans the program recorded in this process: the traced calls'."""
    from cvaegan_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    return list(spans()) if spans is not None else []


def duration_ns(span) -> int:
    return span.end_ns - span.start_ns


def replayed_nodes(phase: Optional[str] = None) -> Tuple[int, int]:
    """(nodes, optimizer steps) of the traced `fit.epochs` spans that
    replayed a captured graph: each span's epochs times its graph's
    nodes that the device runs as kernels, kernel and memcpy nodes (a
    graph runs a memcpy node as a copy kernel, `memcpy32_post`; a memset
    node shows as a `Memset`, which `device_ops_per_step` leaves out), or
    its kernel nodes of `phase` alone, where one is named; and its steps,
    summed over the replicas."""
    nodes = steps = 0
    for s in recorded():
        graph = s.attrs.get("graph_nodes") if s.name == "fit.epochs" else None
        if not graph:
            continue
        per_epoch = (graph["kernel"] + graph["memcpy"] if phase is None
                     else graph["by_phase"].get(phase, 0))
        nodes += per_epoch * s.attrs["epochs"]
        steps += s.attrs["steps"]
    return nodes, steps
