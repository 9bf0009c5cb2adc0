"""Run one cell as benchmark/run.py does, traced, with a fourth segment in
its profiled stretch and, in generation, a segment of one whole request
(benchmark/spans.py): the device's idle gaps put down to the program's
spans.

    python3 benchmark/idle_by_span.py --workload <name> --seed <n> \
        --seconds <s>

Prints run.py's result line, whose breakdown gains `idle_by_span` (and
`request_idle_by_span` in generation); the log (standard error) gives the
fourth segment's span, its ratio to the second segment's (the spans'
on-cost), the idle seconds by span, the share of the idle time under a
program span, the per-layer figures of `spans.figures`, and the same
tables of the whole request.  The benchmark's own runs (run.py) take
neither segment.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import run  # noqa: E402  (first: the process's start)
from benchmark import harness, spans, trace  # noqa: E402
from benchmark.kinds import generate  # noqa: E402


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    trace.Stretch = spans.SpanStretch
    generate.stretch = spans.with_request_segment(generate.stretch)
    start_ranks = harness.start_ranks

    def start_this(cell, script, args):
        # the other ranks run this file too, so that every rank takes the
        # same units
        return start_ranks(cell, os.path.abspath(__file__), args)
    harness.start_ranks = start_this
    if "--trace" not in argv:
        argv += ["--trace", "1"]
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
