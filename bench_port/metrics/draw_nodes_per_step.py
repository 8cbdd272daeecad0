"""draw_nodes_per_step: `graph_nodes_per_step`'s kernel nodes of the
random draws alone (the `step.draw` phase of the captured epoch: batch
rows, labels, z, eps and dropout masks, each replica's apart in a seed
bank), over the same steps."""

from bench_port.harness import program_spans


def read(record):
    nodes, steps = program_spans.replayed_nodes("step.draw")
    return nodes / steps if steps else None
