"""How often the port decides as the JAX package on the CPU with the same
keys (RANSAC solved in f64, the port's route; its minimal samples and
votes are f64 kernels, so no f32 route is left to compare).

Not a test (pytest does not collect it): run it as a script from the
repo root,

    python tests/ransac_precision_parity.py [--jax_op_by_op]

It runs the fused programs' parity calls of ``test_torch_fused_keys.py``
(initial poses, refines, window candidates, loop verifications, pair
estimates) and the per-keyframe slice of ``test_torch_slice.py``, and
prints, per group, the calls whose matched rows (the final assignment)
equal the JAX package's, and for the slice the kept frames, the
connected view pairs, and the connections whose inlier pairs equal the
reference's.

``--jax_op_by_op`` adds the reference's own spread: the initial poses of
``test_torch_fused_keys.py`` by the JAX package run as one compiled
program (as its CLIs run) against the same calls run op by op
(``jax.disable_jit``), rows and cheirality counts (about 45 s a call).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import conftest  # noqa: E402,F401  (the test harness's CPU / x64 setup)
import jax  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_fused_keys as fk  # noqa: E402
import test_torch_slice as sl  # noqa: E402

GROUPS = (("initial poses", fk.test_fused_initial_pose_draws_like_jax),
          ("refines + window candidates",
           fk.test_fused_refine_window_draws_like_jax),
          ("loop verifications",
           fk.test_fused_bow_pair_estimate_draws_like_jax),
          ("pair estimates",
           fk.test_fused_pair_estimate_gather_draws_like_jax))


def fused_rows(scene):
    """Per group: [(same rows, calls), ...] of each tally the group's
    test checks, or the assertion that stopped it."""
    out = {}
    for name, test in GROUPS:
        tallies = []
        fk._Tally.check = lambda self: tallies.append(
            (self.same_rows, self.calls))
        try:
            test(scene)
            out[name] = tallies
        except AssertionError as e:
            out[name] = f"stopped: {e!r}"
    return out


def slice_pairs(sequence):
    (jvg, jkept), (vg, kept), _ = sl.both._fixture_function(sequence)
    same = [np.array_equal(np.asarray(vg.connections[k].pairs),
                           np.asarray(jvg.connections[k].pairs))
            for k in vg.connections if k in jvg.connections]
    return dict(kept_equal=kept == jkept,
                connections_equal=sorted(vg.connections)
                == sorted(jvg.connections),
                same_pairs=(sum(same), len(same)))


def jax_spread(scene):
    """Calls of the JAX package's initial poses whose rows are the same
    compiled and op by op, and whose port rows equal each: (compiled = op
    by op, port = compiled, port = op by op, calls)."""
    jfr, tfr, c, tc = scene
    tally = np.zeros(4, int)
    for cur, prev in ((2, 1), (4, 3)):
        for seed in fk.SEEDS:
            got, ref = fk._initial(jfr, tfr, c, tc, cur, prev, seed)
            with jax.disable_jit():
                _, op = fk._initial(jfr, tfr, c, tc, cur, prev, seed)
            same = [np.array_equal(ref[4], op[4]),
                    np.array_equal(got[4], ref[4]),
                    np.array_equal(got[4], op[4])]
            tally += same + [1]
            print(f"    {cur} -> {prev} seed {seed}: {same}, counts port "
                  f"{int(got[3])}, compiled {int(ref[3])}, op by op "
                  f"{int(op[3])}", flush=True)
    return tuple(int(v) for v in tally)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax_op_by_op", action="store_true")
    args = ap.parse_args()
    scene = fk.scene._fixture_function()
    if args.jax_op_by_op:
        print("the JAX package compiled vs op by op, initial poses:")
        print(f"  (compiled = op by op, port = compiled, port = op by op, "
              f"calls) {jax_spread(scene)}",
              flush=True)
    sequence = sl.sequence._fixture_function()
    print("f64 solves (the port)")
    for name, v in fused_rows(scene).items():
        print(f"  {name}: {v}")
    print(f"  slice: {slice_pairs(sequence)}", flush=True)


if __name__ == "__main__":
    main()
