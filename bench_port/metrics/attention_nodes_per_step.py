"""attention_nodes_per_step: `graph_nodes_per_step`'s kernel nodes of the
attention forwards alone (the `net.attention` phase of the captured
epoch: the Q, K and V projections, the scores, the softmax, the mix and
the out projection; their backward counts to the step's phase), over the
same steps. None where no replayed graph has that phase (a program whose
attention has no span)."""

from bench_port.harness import program_spans

PHASE = "net.attention"


def read(record):
    if not any(PHASE in s.attrs["graph_nodes"]["by_phase"] for s in program_spans.recorded()
               if s.name == "fit.epochs" and s.attrs.get("graph_nodes")):
        return None
    nodes, steps = program_spans.replayed_nodes(PHASE)
    return nodes / steps if steps else None
