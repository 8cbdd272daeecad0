"""graph_nodes_per_step: the nodes of the captured epoch graph that the
device runs as kernels (kernel and memcpy nodes, the program's count at
capture) times the epochs each traced `fit.epochs` span replayed, over
those spans' optimizer steps, summed over replicas: `device_ops_per_step`
counted inside the program, without the trace."""

from bench_port.harness import program_spans


def read(record):
    nodes, steps = program_spans.replayed_nodes()
    return nodes / steps if steps else None
