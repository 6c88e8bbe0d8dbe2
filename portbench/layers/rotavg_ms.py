"""engine solve: milliseconds a frame in ``ViewGraph.rot_avg`` with the poses' copy to the host, from the harness's span in a traced run."""

from pbkit.trace import per_unit_ms

WRAP = {}


def read(r):
    return per_unit_ms(r.tracer, "rot_avg", r.units.get("frames", 0))
