"""solver: milliseconds a solve in ``l1ra``, from the harness's span in a traced run."""

from pbkit.trace import per_unit_ms

WRAP = {}


def read(r):
    return per_unit_ms(r.tracer, "l1ra", r.units.get("solves", 0))
