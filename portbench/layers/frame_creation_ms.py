"""frontend: milliseconds a frame in ``FramePrefetcher.frame`` (batched extraction, undistortion and BoW, amortised over the batch), from the harness's span in a traced run."""

from pbkit.trace import per_unit_ms

WRAP = {}


def read(r):
    return per_unit_ms(r.tracer, "frame_creation", r.units.get("frames", 0))
