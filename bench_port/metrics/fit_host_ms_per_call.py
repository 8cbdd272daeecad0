"""fit_host_ms_per_call: the mean, over the traced calls, of each `fit`
(or `bank.fit`) span's milliseconds outside its `fit.epochs` spans: the
host's work of a call (preparing the data, the capture's lookup, a
bank's load and store, the chunk's end), the epochs and the transfer of
their losses left out."""

from bench_port.harness import program_spans

CALLS = ("fit", "bank.fit")


def read(record):
    spans = program_spans.recorded()
    calls = {i: program_spans.duration_ns(s) for i, s in enumerate(spans)
             if s.parent is None and s.name in CALLS and s.end_ns is not None}
    if not calls:
        return None
    for s in spans:
        if s.name == "fit.epochs" and s.call in calls and s.end_ns is not None:
            calls[s.call] -= program_spans.duration_ns(s)
    return sum(calls.values()) / len(calls) / 1e6
