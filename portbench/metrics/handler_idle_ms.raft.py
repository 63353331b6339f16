"""Reader of the per-layer metric ``handler_idle_ms.raft``: idle device ms per
profiled step under the program's ``step.handler`` range."""

from portbench.metrics._phase import idle_ms


def read(records):
    return idle_ms(records, "step.handler")
