"""engine: milliseconds a frame in ``ViewGraph.process_frame`` (matching and two-view geometry inside it), from the harness's span in a traced run."""

from pbkit.trace import per_unit_ms

WRAP = {}


def read(r):
    return per_unit_ms(r.tracer, "process_frame", r.units.get("frames", 0))
