"""The fused programs' draws against the JAX package's, seed for seed.

``fused_initial_pose``, ``fused_refine_window``, ``fused_bow_pair_estimate``
and ``fused_pair_estimate_gather`` of both packages get the same features
(the JAX ORB extractor's, on seqgen frames) and the same seeds; the JAX
side runs without x64, as its CLIs do, so both draw the same RANSAC
samples from the same key tree.

What remains between them is the rounding of the hypothesis solves: the
port solves and votes in f64, the JAX package in f32, so a re-ranked
candidate's Sampson or cheirality count can differ by one, and at small
baselines a near-tied hypothesis can then win in one package and not in
the other (and a refine then follows another path); and a minimal sample
that drew a correspondence twice has a two-dimensional null space, in
which the JAX package's Householder null vector points where f32
rounding sends it.  The JAX package does not repeat its own rows either:
run op by op (``jax.disable_jit``) instead of as one compiled program,
its initial poses keep the compiled program's rows in 7 of 12 calls, and
the port's in 9 of 12 (``ransac_precision_parity.py``).  Tolerances, over
every call of a test: the same success / accept flags in every call;
the same matched rows (the final assignment ``m12``) in at least
``SAME_ROWS`` (60%) of the calls; cheirality counts within ``N_TOL``
(2%, relative) in their median over the calls.  Measured on a CPU: the
same rows in 9 of 12 initial poses, 5 of 6 refines and 11 of 12 window
candidates, 6 of 6 loop verifications and 13 of 21 successful pair
estimates (whose refines run longest); the median count gap 0 in each.
"""

import jax
import numpy as np
import pytest
import torch

from irotavg_tpu.frontend import Camera as JCamera
from irotavg_tpu.frontend import Frame as JFrame
from irotavg_tpu.frontend import ORBExtractor as JORB
from irotavg_tpu.geometry import fused as jf
from irotavg_tpu.matching import matchers as jm
from irotavg_tpu_torch.frontend.camera import Camera
from irotavg_tpu_torch.frontend.frame import Frame
from irotavg_tpu_torch.geometry import fused as tf
from irotavg_tpu_torch.interop import features_from_arrays
from seqgen import make_sequence
from jax_programs import release_jax_programs  # noqa: F401

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

SAME_ROWS = 0.6
N_TOL = 0.02
MIN_MATCHES = 60
SEEDS = range(6)
KEYS = ("x", "y", "xu", "yu", "octave", "angle", "response", "size",
        "desc", "valid")


@pytest.fixture(scope="module")
def scene():
    frames, K, _ = make_sequence(n_frames=6, seed=3, step=0.3,
                                 yaw_deg_per_frame=-1.0)
    kw = dict(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=640,
              height=480)
    jcam, cam = JCamera(**kw), Camera(**kw)
    ext = JORB(n_features=1000, n_levels=8)
    jfr = [JFrame(i, im, ext, jcam) for i, im in enumerate(frames)]
    tfr = [Frame.restore(i, cam, {k: np.array(getattr(f, k)) for k in KEYS},
                         device="cpu") for i, f in enumerate(jfr)]
    c = dict(cam=np.array([cam.fx, cam.fy, cam.cx, cam.cy], np.float32),
             K_inv=np.linalg.inv(cam.K).astype(np.float32),
             sigma2=((1.2 ** np.arange(8)) ** 2).astype(np.float32),
             th_norm=np.float32(1.0 / cam.fx))
    tc = {k: torch.from_numpy(np.asarray(v)) for k, v in c.items()}
    return jfr, tfr, c, tc


class _Tally:
    """Flags per call, matched rows equal or not, relative count gaps."""

    def __init__(self):
        self.calls, self.same_rows, self.gaps = 0, 0, []

    def add(self, m12_port, m12_jax, n_port, n_jax):
        self.calls += 1
        self.same_rows += bool(np.array_equal(np.asarray(m12_port),
                                              np.asarray(m12_jax)))
        self.gaps.append(abs(int(n_port) - int(n_jax))
                         / max(int(n_jax), 1))

    def check(self):
        assert self.calls > 0
        assert self.same_rows >= SAME_ROWS * self.calls, \
            (self.same_rows, self.calls)
        assert np.median(self.gaps) <= N_TOL, self.gaps


def _np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _initial(jfr, tfr, c, tc, cur, prev, seed):
    jc, jp = jfr[cur], jfr[prev]
    tcur, tprev = tfr[cur], tfr[prev]
    with jax.enable_x64(False):
        ref = jf.fused_initial_pose(
            jc.pm1, jc.dev("valid"), jc.dev("octave"), jc.dev("xu"),
            jc.dev("yu"), jp.pm1.T, jp.dev("valid"), jp.dev("octave"),
            jp.dev("xu"), jp.dev("yu"), np.float32(45.0), c["cam"],
            c["th_norm"], np.uint32(seed), 2 * MIN_MATCHES, np.float32(0.9))
        ref = [np.asarray(v) for v in ref]
    got = tf.fused_initial_pose(
        tuple(tcur.dev(k) for k in ("desc", "valid", "octave", "xu", "yu")),
        tuple(tprev.dev(k) for k in ("desc", "valid", "octave", "xu",
                                     "yu")),
        45.0, tc["cam"], tc["th_norm"], seed, 2 * MIN_MATCHES, 0.9)
    return [_np(v) for v in got], ref


def test_fused_initial_pose_draws_like_jax(scene):
    """(E, R, t, n_che, m12, local_rad, rel_valid, accepted) for frames
    2 -> 1 and 4 -> 3 over the seeds."""
    jfr, tfr, c, tc = scene
    tally = _Tally()
    for cur, prev in ((2, 1), (4, 3)):
        for seed in SEEDS:
            got, ref = _initial(jfr, tfr, c, tc, cur, prev, seed)
            assert (bool(got[6]), bool(got[7])) == \
                (bool(ref[6]), bool(ref[7]))
            tally.add(got[4], ref[4], got[3], ref[3])
    tally.check()


def _tensors(f):
    return (f.dev("desc"), None, f.dev("valid"), f.dev("angle"),
            f.dev("xu"), f.dev("yu"), f.dev("octave"))


def _jtensors(f):
    return (f.pm1, None, f.dev("valid"), f.dev("angle"), f.dev("xu"),
            f.dev("yu"), f.dev("octave"))


def test_fused_refine_window_draws_like_jax(scene):
    """Frame 3 after frame 2 with frames 1 and 0 as window candidates,
    from each package's own initial pose of the same seed: the refine's
    and every candidate's matched rows, counts and success flags."""
    jfr, tfr, c, tc = scene
    cands = (1, 0)
    m12_w2p = np.stack([jm.match_locally(jfr[k], jfr[2], radius=60.0)
                        for k in cands]).astype(np.int64)
    assert ((m12_w2p >= 0).sum(axis=1) > 100).all()
    refined, window = _Tally(), _Tally()
    for seed in SEEDS:
        got0, ref0 = _initial(jfr, tfr, c, tc, 3, 2, seed)
        assert bool(got0[7]) == bool(ref0[7])
        with jax.enable_x64(False):
            rj, wj = jf.fused_refine_window(
                *_jtensors(jfr[3]), *_jtensors(jfr[2]),
                tuple(_jtensors(jfr[k]) for k in cands),
                m12_w2p.astype(np.int32), np.array([True, True]),
                *ref0[:3], ref0[4], c["K_inv"], c["sigma2"], c["cam"],
                c["th_norm"], np.uint32(seed), MIN_MATCHES, has_nodes=False)
            rj, wj = [np.asarray(v) for v in rj], [np.asarray(v) for v in wj]
        rt, wt = tf.fused_refine_window(
            _tensors(tfr[3]), _tensors(tfr[2]),
            tuple(_tensors(tfr[k]) for k in cands),
            torch.from_numpy(m12_w2p), [True, True],
            *(torch.from_numpy(v) for v in got0[:3]),
            torch.from_numpy(got0[4]), tc["K_inv"], tc["sigma2"], tc["cam"],
            tc["th_norm"], seed, MIN_MATCHES)
        refined.add(_np(rt[4]), rj[4], _np(rt[3]), rj[3])
        assert [bool(v) for v in wt[5]] == [bool(v) for v in wj[5]]
        for k in range(len(cands)):
            window.add(_np(wt[4][k]), wj[4][k], _np(wt[3][k]), wj[3][k])
    refined.check()
    window.check()


def test_fused_bow_pair_estimate_draws_like_jax(scene):
    """Loop verification without node ids (gate ``none``) on frame pairs
    one to five frames apart, seeded ``view * 31 + cand`` as the engines
    seed it."""
    jfr, tfr, c, tc = scene
    tally = _Tally()
    for i, j in ((0, 1), (0, 3), (1, 5), (2, 4), (0, 5), (3, 4)):
        seed = (j * 31 + i) & 0xFFFFFFFF
        with jax.enable_x64(False):
            ref = jf.fused_bow_pair_estimate(
                *_jtensors(jfr[i]), jfr[j].pm1.T, None,
                *_jtensors(jfr[j])[2:6], c["K_inv"], c["sigma2"], c["cam"],
                c["th_norm"], np.uint32(seed), np.float32(0.9),
                np.int32(MIN_MATCHES), has_nodes=False)
            ref = [np.asarray(v) for v in ref]
        t1 = tuple(torch.zeros(tfr[i].capacity, dtype=torch.int32)
                   if v is None else v for v in _tensors(tfr[i]))
        t2 = tuple(torch.zeros(tfr[j].capacity, dtype=torch.int32)
                   if v is None else v for v in _tensors(tfr[j]))
        got = tf.fused_bow_pair_estimate(
            t1, t2, tc["K_inv"], tc["sigma2"], tc["cam"], tc["th_norm"],
            seed, 0.9, MIN_MATCHES, False)
        assert bool(got[5]) == bool(ref[5]), (i, j)
        tally.add(_np(got[4]), ref[4], got[3], ref[3])
    tally.check()


def test_fused_pair_estimate_gather_draws_like_jax(scene):
    """Eight pairs of one chunk (a key per lane from one seed) for three
    seeds; lanes whose refine never runs, and lanes that fail, draw from
    their own keys like the others."""
    jfr, tfr, c, tc = scene
    outs = [{k: np.asarray(getattr(f, k)) for k in KEYS} for f in jfr]
    t = features_from_arrays(outs, device="cpu")
    import jax.numpy as jnp

    j = {k: jnp.asarray(np.stack([o[k] for o in outs]))
         for k in ("desc", "valid", "octave", "xu", "yu", "angle")}
    pairs = np.array([[0, 1], [0, 2], [1, 3], [2, 5], [3, 4], [4, 5],
                      [0, 5], [1, 2]], np.int32)
    radii = np.array([45, 60, 70, 110, 45, 45, 20, 45], np.float32)
    tally = _Tally()
    for seed in (0, 7919, 104729):
        with jax.enable_x64(False):
            ref = jf.fused_pair_estimate_gather(
                j["desc"], j["valid"], j["octave"], j["xu"], j["yu"],
                j["angle"], pairs[:, 0], pairs[:, 1], radii, c["K_inv"],
                c["sigma2"], c["cam"], c["th_norm"], np.uint32(seed),
                np.int32(MIN_MATCHES))
            ref = [np.asarray(v) for v in ref]
        got = tf.fused_pair_estimate_gather(
            t["desc"], t["valid"], t["octave"], t["xu"], t["yu"],
            t["angle"], torch.from_numpy(pairs[:, 0]).long(),
            torch.from_numpy(pairs[:, 1]).long(), torch.from_numpy(radii),
            tc["K_inv"], tc["sigma2"], tc["cam"], tc["th_norm"], seed,
            MIN_MATCHES)
        assert got[5] == [bool(v) for v in ref[5]], seed
        for p in range(len(pairs)):
            if ref[5][p]:
                tally.add(_np(got[4][p]), ref[4][p], got[3][p], ref[3][p])
    tally.check()
