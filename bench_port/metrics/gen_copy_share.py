"""gen_copy_share: the traced calls' `gen.copy` time (the rows from the
device into a numpy array) over their `gen.fast` time, summed over the
calls, as a percentage. Under the profiler the forward's span ends with
the kernel, so the copy's span holds the copy alone."""

from bench_port.harness import program_spans


def read(record):
    spans = program_spans.recorded()
    calls = sum(program_spans.duration_ns(s) for s in spans
                if s.name == "gen.fast" and s.end_ns is not None)
    copies = sum(program_spans.duration_ns(s) for s in spans
                 if s.name == "gen.copy" and s.end_ns is not None)
    return 100.0 * copies / calls if calls else None
