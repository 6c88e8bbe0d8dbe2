"""geometry: milliseconds a frame in ``geometry.fused._ransac_lanes`` (every RANSAC batch of the frame, the loop verification's included), from a span the harness wraps around it in a traced run."""

from pbkit.trace import per_unit_ms

WRAP = {"ransac": (["irotavg_tpu_torch.geometry.fused:_ransac_lanes"], False)}


def read(r):
    return per_unit_ms(r.tracer, "ransac", r.units.get("frames", 0))
