"""The port's ``irotavg`` CLI, in-process, on PGM frames: the output
contract of test_app.py:147-155 without and with a vocabulary,
``--plot_matches`` and ``--trace_dir`` (``--checkpoint``/``--resume`` run
in test_torch_checkpoint.py), the device policy (the card unless
``--device cpu``) and the matcher's CPU dispatch."""

import numpy as np
import pytest
import torch

from irotavg_tpu_torch.app import irotavg as port_cli
from irotavg_tpu_torch.ops import match
from irotavg_tpu_torch.utils.sequence import read_pgm, write_pgm
from seqgen import make_sequence

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sequence():
    return make_sequence(n_frames=6, seed=1, step=0.3,
                         yaw_deg_per_frame=-1.0)


def _write_inputs(tmp_path, sequence):
    """PGM frames, a GT file and an ORB-SLAM YAML in ``tmp_path``."""
    frames, K, R_gt = sequence
    seq = tmp_path / "seq"
    seq.mkdir()
    for i, im in enumerate(frames):
        write_pgm(str(seq / f"{i:06d}.pgm"), im)
    assert np.array_equal(read_pgm(str(seq / "000000.pgm")), frames[0])
    np.savetxt(tmp_path / "gt.txt", R_gt.reshape(6, 9))
    yaml = tmp_path / "cam.yaml"
    yaml.write_text(
        "%YAML:1.0\n"
        f"Camera.fx: {K[0, 0]}\nCamera.fy: {K[1, 1]}\n"
        f"Camera.cx: {K[0, 2]}\nCamera.cy: {K[1, 2]}\n"
        "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
        "ORBextractor.nFeatures: 1200\nORBextractor.scaleFactor: 1.2\n"
        "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\n"
        "ORBextractor.minThFAST: 7\n")
    return seq, yaml


def _check_outputs(out):
    poses = (out / "rotavg_poses.txt").read_text().strip().splitlines()
    ids = (out / "rotavg_poses_ids.txt").read_text().strip().splitlines()
    assert len(poses) >= 4 and len(ids) == len(poses)
    row = poses[0].split("\t")
    assert len(row) == 8                      # id + q(4) + t(3)
    assert [float(v) for v in row[5:]] == [0.0, 0.0, 0.0]
    q = np.array([float(v) for v in row[1:5]])
    assert np.linalg.norm(q) == pytest.approx(1.0, abs=1e-6)


def test_cli_output_contract(tmp_path, sequence):
    """The port's CLI on 6 PGM frames (the contract of test_app.py:147-155)."""
    seq, yaml = _write_inputs(tmp_path, sequence)
    out = tmp_path / "out"
    rc = port_cli.main(["none", str(yaml), str(seq), "--image_ext", ".pgm",
                        "--gt", str(tmp_path / "gt.txt"),
                        "--out_dir", str(out), "--device", "cpu"])
    assert rc == 0
    _check_outputs(out)


def test_cli_with_vocabulary(tmp_path, sequence, monkeypatch, capsys):
    """With a vocabulary file written by the JAX ``save_text`` the CLI
    runs the loop-closure block and every keyframe carries a BoW vector
    and node ids."""
    from irotavg_tpu.placerec import train_vocabulary
    from irotavg_tpu_torch.engine.viewgraph import ViewGraph
    from irotavg_tpu_torch.frontend.orb import ORBExtractor

    ext = ORBExtractor(n_features=600, n_levels=8, device="cpu")
    sample = []
    for im in sequence[0][::3]:
        o = ext(im)
        d = o["desc"][o["valid"]].numpy()[:300]
        sample.append(np.ascontiguousarray(d).view(np.uint32))
    vocab = tmp_path / "vocab.txt"
    train_vocabulary(sample, k=6, L=3, seed=0).save_text(str(vocab))
    seq, yaml = _write_inputs(tmp_path, sequence)
    kept = []
    orig = ViewGraph.process_frame

    def spy(self, frame, win_size=4):
        ok = orig(self, frame, win_size)
        kept.extend([frame] if ok else [])
        return ok

    monkeypatch.setattr(ViewGraph, "process_frame", spy)
    out = tmp_path / "out"
    rc = port_cli.main([str(vocab), str(yaml), str(seq), "--image_ext",
                        ".pgm", "--out_dir", str(out), "--device", "cpu"])
    assert rc == 0
    _check_outputs(out)
    assert len(kept) >= 4
    for f in kept:
        assert f.bow and abs(sum(f.bow.values()) - 1.0) < 1e-9
        assert f.feat_nodes.shape == (f.capacity,)
        assert (f.feat_nodes >= 0).any()
    log = capsys.readouterr().out
    assert "loading vocabulary..." in log and "loop_closure: total" in log


def test_cli_plot_matches_writes_pngs(tmp_path, sequence):
    """``--plot_matches`` on the CPU: one PNG per connected consecutive
    keyframe pair, each the side-by-side canvas; the frames are extracted
    one at a time, so the keyframes are those of ``--prefetch 1``."""
    from irotavg_tpu_torch.utils.viz import read_png

    seq, yaml = _write_inputs(tmp_path, sequence)
    base = ["none", str(yaml), str(seq), "--image_ext", ".pgm",
            "--device", "cpu"]
    assert port_cli.main(base + ["--out_dir", str(tmp_path / "a"),
                                 "--prefetch", "1"]) == 0
    plots = tmp_path / "plots"
    assert port_cli.main(base + ["--out_dir", str(tmp_path / "b"),
                                 "--plot_matches", str(plots)]) == 0
    ids_a = (tmp_path / "a" / "rotavg_poses_ids.txt").read_text()
    ids_b = (tmp_path / "b" / "rotavg_poses_ids.txt").read_text()
    assert ids_a == ids_b
    n_key = len(ids_b.split())
    assert n_key >= 4
    pngs = sorted(p.name for p in plots.iterdir())
    assert pngs == [f"matches_{i:06d}.png" for i in range(1, n_key)]
    frames = sequence[0]
    h, w = frames[0].shape
    src = [int(v) - 1 for v in ids_b.split()]      # keyframe -> frame
    for i, name in enumerate(pngs, start=1):
        im = read_png(str(plots / name))
        assert im.shape == (h, 2 * w, 3) and im.dtype == np.uint8
        # the halves are the two keyframes wherever no line (a palette
        # colour, never gray) was drawn
        side = np.concatenate([frames[src[i - 1]], frames[src[i]]], axis=1)
        gray = (im[..., 0] == im[..., 1]) & (im[..., 1] == im[..., 2])
        assert gray.mean() > 0.5
        np.testing.assert_array_equal(im[..., 0][gray], side[gray])


def test_cli_trace_dir_writes_a_trace(tmp_path, sequence):
    """``--trace_dir`` on the CPU: one torch.profiler trace of the frame
    loop with the port's operator events."""
    import json

    seq, yaml = _write_inputs(tmp_path, sequence)
    trace = tmp_path / "trace"
    rc = port_cli.main(["none", str(yaml), str(seq), "--image_ext", ".pgm",
                        "--out_dir", str(tmp_path / "out"), "--max_frames",
                        "2", "--trace_dir", str(trace), "--device", "cpu"])
    assert rc == 0
    files = list(trace.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert len(events) > 1000 and "aten::matmul" in names


def test_matcher_runs_plain_version_on_cpu(sequence):
    """On CPU tensors the wrapper takes the plain version and launches
    nothing."""
    before = match.best2.launches
    d = torch.zeros((4, 8), dtype=torch.int32)
    f = torch.ones((4, 8))
    d1, d2, idx = match.best2(d, d, f, f, "none")
    assert match.best2.launches == before
    assert d1.tolist() == [0.0] * 4 and idx.tolist() == [0] * 4


def test_pick_device_takes_the_card_unless_asked_for_cpu(monkeypatch):
    from irotavg_tpu_torch.device import pick_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            pick_device(name)
    assert pick_device("cpu") == torch.device("cpu")
    assert pick_device(torch.device("cpu")) == torch.device("cpu")


def test_cli_without_a_card_needs_device_cpu(tmp_path, sequence, monkeypatch,
                                             capsys):
    """No silent CPU: without a card the CLI's default (--device cuda)
    exits 2 and names the CPU option."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seq, yaml = _write_inputs(tmp_path, sequence)
    out = tmp_path / "out"
    rc = port_cli.main(["none", str(yaml), str(seq), "--image_ext", ".pgm",
                        "--out_dir", str(out)])
    assert rc == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not out.exists()
