"""The port's offline pipeline with loop closure on the 14-frame
out-and-back sequence of tests/test_offline.py, and the ``irotavg_batch``
CLI (its output files with ``--device cpu``, exit 2 for ``--device
cuda`` without a card)."""

import numpy as np
import torch

from irotavg_tpu.frontend import ORBExtractor as JaxORB
from irotavg_tpu_torch.app import irotavg_batch
from irotavg_tpu_torch.config import LoopClosureConfig, PipelineConfig
from irotavg_tpu_torch.frontend.camera import Camera
from irotavg_tpu_torch.frontend.orb import ORBExtractor
from irotavg_tpu_torch.interop import vocabulary_from_arrays
from irotavg_tpu_torch.pipeline import run_offline
from irotavg_tpu_torch.utils.sequence import write_pgm
from seqgen import make_sequence

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)


def test_offline_loop_closure_adds_edges():
    """The out-and-back sequence of test_offline.py: a vocabulary trained
    by the JAX package on its frames, carried over; at least one loop
    edge, spanning more than 4 keyframes."""
    from irotavg_tpu.placerec import train_vocabulary

    frames, K, _ = make_sequence(n_frames=14, seed=4, step=0.3,
                                 yaw_deg_per_frame=-1.2, loop=True)
    jext = JaxORB(n_features=1000, n_levels=8)
    sample = []
    for im in frames[::4]:
        o = {k: np.asarray(v) for k, v in jext(im).items()}
        sample.append(o["desc"][o["valid"]][:300])
    jv = train_vocabulary(sample, k=8, L=3, seed=0)
    vocab = vocabulary_from_arrays(jv.k, jv.L, jv.children, jv.node_desc,
                                   jv.weight, jv.word_id, jv.is_leaf,
                                   jv.scoring, jv.weighting, device="cpu")
    cfg = PipelineConfig(loop=LoopClosureConfig(
        covisibility_consistency_th=1, min_matches=60))
    res = run_offline(frames, Camera(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2],
                                     cy=K[1, 2], width=640, height=480),
                      ORBExtractor(n_features=1000, n_levels=8,
                                   device="cpu"),
                      vocab=vocab, cfg=cfg, batch=4, chunk=8,
                      min_matches=60, win_size=4)
    assert res.loop_edges >= 1, "no loop edges on the out-and-back sequence"
    assert res.loop_mask.sum() == res.loop_edges
    spans = res.edges[res.loop_mask, 1] - res.edges[res.loop_mask, 0]
    assert spans.max() > 4
    assert res.stats["loop_candidate_pairs"] >= res.loop_edges


def _write_inputs(tmp_path, n_frames):
    frames, K, _ = make_sequence(n_frames=n_frames, seed=2, step=0.3,
                                 yaw_deg_per_frame=-1.0)
    seq = tmp_path / "seq"
    seq.mkdir()
    for i, im in enumerate(frames):
        write_pgm(str(seq / f"{i:06d}.pgm"), im)
    yaml = tmp_path / "cam.yaml"
    yaml.write_text(
        "%YAML:1.0\n"
        f"Camera.fx: {K[0, 0]}\nCamera.fy: {K[1, 1]}\n"
        f"Camera.cx: {K[0, 2]}\nCamera.cy: {K[1, 2]}\n"
        "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
        "ORBextractor.nFeatures: 1000\nORBextractor.scaleFactor: 1.2\n"
        "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\n"
        "ORBextractor.minThFAST: 7\n")
    return seq, yaml


def test_batch_cli_end_to_end(tmp_path, capsys):
    seq, yaml = _write_inputs(tmp_path, 8)
    out = tmp_path / "out"
    rc = irotavg_batch.main(["none", str(yaml), str(seq), "--image_ext",
                             ".pgm", "--out_dir", str(out), "--batch", "4",
                             "--chunk", "8", "--device", "cpu"])
    assert rc == 0
    poses = np.loadtxt(out / "rotavg_poses.txt")
    assert poses.shape[1] == 8 and len(poses) >= 4
    # unit quaternions, zero translations
    np.testing.assert_allclose(
        np.linalg.norm(poses[:, 1:5], axis=1), 1.0, atol=1e-6)
    assert (poses[:, 5:] == 0).all()
    ids = np.loadtxt(out / "rotavg_poses_ids.txt", dtype=int)
    assert len(ids) == len(poses) and ids[0] == 1      # 1-based
    log = capsys.readouterr().out
    for stage in ("extract:", "flow:", "pairs:", "solve:", "frames/s"):
        assert stage in log


def test_batch_cli_needs_a_card_unless_cpu(tmp_path, capsys):
    seq, yaml = _write_inputs(tmp_path, 2)
    rc = irotavg_batch.main(["none", str(yaml), str(seq), "--image_ext",
                             ".pgm", "--out_dir", str(tmp_path / "out"),
                             "--device", "cuda"])
    if torch.cuda.is_available():
        assert rc in (0, 1)
    else:
        assert rc == 2
        assert "--device cpu" in capsys.readouterr().err
