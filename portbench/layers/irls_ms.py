"""solver: milliseconds a solve in ``irls``, from the harness's span in a traced run."""

from pbkit.trace import per_unit_ms

WRAP = {}


def read(r):
    return per_unit_ms(r.tracer, "irls", r.units.get("solves", 0))
