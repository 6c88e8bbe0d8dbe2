"""Checkpoint/resume in the port: engine state round-trips and resumes
bit-identically (a mirror of tests/test_checkpoint.py), checkpoints cross
between the two packages in both directions, and the CLI's
``--checkpoint``/``--resume`` reproduce an uninterrupted run."""

import numpy as np
import pytest
import torch

from irotavg_tpu.engine import checkpoint as jckpt
from irotavg_tpu.engine.viewgraph import ViewGraph as JViewGraph
from irotavg_tpu.frontend.frame import Frame as JFrame
from irotavg_tpu.geometry.twoview import RelativePose as JRelativePose
from irotavg_tpu_torch.app import irotavg as port_cli
from irotavg_tpu_torch.engine.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from irotavg_tpu_torch.engine.viewgraph import ViewGraph
from irotavg_tpu_torch.frontend.camera import Camera
from irotavg_tpu_torch.frontend.frame import Frame
from irotavg_tpu_torch.frontend.orb import ORBExtractor
from irotavg_tpu_torch.placerec.vocabulary import make_random_vocabulary
from irotavg_tpu_torch.utils.sequence import write_pgm
from seqgen import make_sequence

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

FIELDS = ("x", "y", "xu", "yu", "octave", "angle", "response", "size",
          "desc", "valid", "cell")
MID, END = 5, 8


@pytest.fixture(scope="module")
def seq():
    frames, K, R_gt = make_sequence(n_frames=END, seed=11, step=0.3,
                                    yaw_deg_per_frame=-1.0)
    cam = Camera(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                 width=640, height=480)
    ext = ORBExtractor(n_features=1000, n_levels=8, device="cpu")
    return frames, K, R_gt, cam, ext


def _drive(vg, frames, ext, cam, start, stop):
    for i in range(start, stop):
        if vg.process_frame(Frame(i, frames[i], ext, cam), win_size=4):
            vg.rot_avg(10)


@pytest.fixture(scope="module")
def full_run(seq):
    frames, _, _, cam, ext = seq
    vg = ViewGraph(cam, min_matches=60, device="cpu")
    _drive(vg, frames, ext, cam, 0, END)
    return vg


def _loop_state(vg):
    """The database's views and the consistency groups of either
    package's graph (the port's live in its loop detector)."""
    if isinstance(vg, ViewGraph):
        return set(vg.loop.db.bows), vg.loop.groups
    return set(vg.db.bows), vg._consistent_groups


def _assert_same_state(a, b):
    """Solver state, connections, adjacency, frames, BoW, database and
    groups of two view graphs (either package) are equal."""
    np.testing.assert_array_equal(a.ra.Q, b.ra.Q)
    np.testing.assert_array_equal(a.ra.fixed, b.ra.fixed)
    np.testing.assert_array_equal(a.ra.edges, b.ra.edges)
    np.testing.assert_array_equal(a.ra.QQ, b.ra.QQ)
    assert a.local_rad == b.local_rad and a.min_matches == b.min_matches
    assert set(a.connections) == set(b.connections)
    for k in a.connections:
        np.testing.assert_array_equal(a.connections[k].pairs,
                                      b.connections[k].pairs)
        np.testing.assert_array_equal(a.connections[k].pose.R,
                                      b.connections[k].pose.R)
        np.testing.assert_array_equal(a.connections[k].pose.t,
                                      b.connections[k].pose.t)
    assert a.adjacency == b.adjacency
    assert len(a.frames) == len(b.frames)
    for fa, fb in zip(a.frames, b.frames):
        for name in FIELDS:
            va, vb = np.asarray(getattr(fa, name)), np.asarray(getattr(fb, name))
            if name == "desc":
                va, vb = va.view(np.uint32), vb.view(np.uint32)
            np.testing.assert_array_equal(va, vb, err_msg=name)
        assert fa.bow == fb.bow
        np.testing.assert_array_equal(fa.feat_nodes, fb.feat_nodes)
    assert _loop_state(a) == _loop_state(b)


def test_checkpoint_roundtrip_and_resume(seq, full_run, tmp_path):
    """A mirror of tests/test_checkpoint.py:28 on the port."""
    frames, _, _, cam, ext = seq
    vg_a = ViewGraph(cam, min_matches=60, device="cpu")
    _drive(vg_a, frames, ext, cam, 0, MID)
    path = tmp_path / "ck.npz"
    save_checkpoint(vg_a, str(path), extra={"count": MID})
    vg_b, extra = load_checkpoint(str(path), cam, device="cpu")
    assert int(extra["count"]) == MID
    _assert_same_state(vg_a, vg_b)
    assert vg_b.frames[-1].dev("desc").dtype == torch.int32

    _drive(vg_b, frames, ext, cam, MID, END)
    assert vg_b.num_views == full_run.num_views >= 5
    assert set(vg_b.connections) == set(full_run.connections)
    np.testing.assert_array_equal(vg_b.ra.Q, full_run.ra.Q)


def _with_bow(vg):
    """Give every frame a BoW vector and node ids, fill the database and
    set a consistency group."""
    vocab = make_random_vocabulary(k=4, L=3, seed=0, device="cpu")
    for f in vg.frames:
        f.compute_bow(vocab, levelsup=1)
    for i in range(vg.num_views):
        vg.add_to_database(i)
    vg.loop.groups = [({1, 2}, 3)]
    return vg


def test_checkpoint_preserves_bow_and_db(seq, full_run, tmp_path):
    """A mirror of tests/test_checkpoint.py:66 on the port."""
    vg = _with_bow(full_run)
    path = tmp_path / "ck.npz"
    save_checkpoint(vg, str(path))
    vg2, _ = load_checkpoint(str(path), seq[3], device="cpu")
    assert vg2.loop.groups == [({1, 2}, 3)]
    _assert_same_state(vg, vg2)
    assert all(f.bow for f in vg2.frames)
    assert (vg2.detect_loop_candidates(vg2.num_views - 1)
            == vg.detect_loop_candidates(vg.num_views - 1))


def _jax_graph(vg, cam):
    """The JAX package's ViewGraph holding the port graph's state, built
    through its own constructors (no JAX front end)."""
    from irotavg_tpu.frontend.camera import Camera as JCamera

    jcam = JCamera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                   width=cam.width, height=cam.height)
    jvg = JViewGraph(jcam, min_matches=vg.min_matches)
    for f in vg.frames:
        arrays = {k: np.asarray(getattr(f, k)) for k in FIELDS}
        arrays["desc"] = arrays["desc"].view(np.uint32)
        jvg.frames.append(JFrame.restore(f.id, jcam, arrays, bow=f.bow,
                                         feat_nodes=f.feat_nodes))
        jvg.ra.add_view()
    # insertion order is the solver's edge order
    for (i, j), c in vg.connections.items():
        p = c.pose
        jvg.connect(i, j, c.pairs, JRelativePose(
            R=p.R, t=p.t, E=p.E, n_cheirality=p.n_cheirality,
            inlier_mask=p.inlier_mask))
    jvg.ra.Q = vg.ra.Q.copy()
    jvg.ra.fixed = vg.ra.fixed.copy()
    jvg.local_rad = vg.local_rad
    for i in vg.loop.db.bows:
        jvg.add_to_database(i)
    jvg._consistent_groups = list(vg.loop.groups)
    return jvg, jcam


def test_checkpoints_cross_between_packages(seq, full_run, tmp_path):
    """A checkpoint the JAX ViewGraph writes loads into the port, and the
    port's loads into the JAX package, with every array, connection,
    adjacency, BoW vector, database entry and group equal."""
    vg = _with_bow(full_run)
    jvg, jcam = _jax_graph(vg, seq[3])
    np.testing.assert_array_equal(jvg.ra.QQ, vg.ra.QQ)
    jpath, tpath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jckpt.save_checkpoint(jvg, str(jpath), extra={"count": 7})
    from_jax, extra = load_checkpoint(str(jpath), seq[3], device="cpu")
    assert int(extra["count"]) == 7
    _assert_same_state(vg, from_jax)

    save_checkpoint(vg, str(tpath))
    from_port, _ = jckpt.load_checkpoint(str(tpath), jcam)
    _assert_same_state(jvg, from_port)
    assert np.asarray(from_port.frames[0].desc).dtype == np.uint32


@pytest.fixture(scope="module")
def cli_inputs(seq, tmp_path_factory):
    frames, K, R_gt, _, _ = seq
    root = tmp_path_factory.mktemp("cli")
    d = root / "seq"
    d.mkdir()
    for i, im in enumerate(frames):
        write_pgm(str(d / f"{i:06d}.pgm"), im)
    np.savetxt(root / "gt.txt", R_gt.reshape(len(frames), 9))
    yaml = root / "cam.yaml"
    yaml.write_text(
        "%YAML:1.0\n"
        f"Camera.fx: {K[0, 0]}\nCamera.fy: {K[1, 1]}\n"
        f"Camera.cx: {K[0, 2]}\nCamera.cy: {K[1, 2]}\n"
        "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
        "ORBextractor.nFeatures: 1000\nORBextractor.scaleFactor: 1.2\n"
        "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\n"
        "ORBextractor.minThFAST: 7\n")
    return root, d, yaml


def test_cli_checkpoint_and_resume(cli_inputs, tmp_path, capsys):
    """``--max_frames 3 --checkpoint`` then ``--resume`` gives the
    uninterrupted run's keyframes, ids and poses to the last bit."""
    root, d, yaml = cli_inputs
    base = ["none", str(yaml), str(d), "--image_ext", ".pgm", "--gt",
            str(root / "gt.txt"), "--device", "cpu"]
    full, part = tmp_path / "full", tmp_path / "part"
    assert port_cli.main(base + ["--out_dir", str(full)]) == 0
    assert port_cli.main(base + ["--out_dir", str(part), "--max_frames", "3",
                                 "--checkpoint"]) == 0
    ck = part / "checkpoint.npz"
    assert ck.exists()
    z = np.load(ck)
    assert int(z["extra_frame_id"]) == 3 and len(z["frame_ids"]) == 3
    capsys.readouterr()
    assert port_cli.main(base + ["--out_dir", str(part), "--resume",
                                 str(ck)]) == 0
    assert "resumed at source frame" in capsys.readouterr().out
    for name in ("rotavg_poses.txt", "rotavg_poses_ids.txt"):
        assert (part / name).read_text() == (full / name).read_text(), name
