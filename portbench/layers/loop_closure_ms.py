"""placerec and loop closure: milliseconds a frame in the CLI's ``_loop_closure`` block (candidates, consistency, verification, the database), from the harness's span in a traced run."""

from pbkit.trace import per_unit_ms

WRAP = {}


def read(r):
    return per_unit_ms(r.tracer, "loop_closure", r.units.get("frames", 0))
