"""The port's remaining small surfaces against the JAX package:
``incidence_fixed_matvec`` (f64, within 1e-12, batched and not), the view
graph's YAML and id files (byte-equal), ``draw_matches`` (equal canvas),
the standard-library PNG writer (decodes to the canvas, and to what an
imaging library reads), ``plot_matches``' refusal without kept images,
and ``device_trace`` on the CPU."""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irotavg_tpu.engine.viewgraph import Connection as JConnection
from irotavg_tpu.engine.viewgraph import ViewGraph as JViewGraph
from irotavg_tpu.geometry.twoview import RelativePose as JRelativePose
from irotavg_tpu.solver import graph as jg
from irotavg_tpu.utils import viz as jviz
from irotavg_tpu_torch.engine.viewgraph import Connection, ViewGraph
from irotavg_tpu_torch.geometry.twoview import RelativePose
from irotavg_tpu_torch.solver import graph as tg
from irotavg_tpu_torch.utils import viz
from irotavg_tpu_torch.utils.timing import device_trace

torch.set_num_threads(1)


def _graph_problem(seed, n=9, m=20, k=4):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(m, 2)).astype(np.int64)
    x = rng.normal(size=(n, k))
    free = rng.random(n) > 0.3
    emask = rng.random(m) > 0.2
    return edges, x, free, emask


def test_incidence_fixed_matvec_equals_jax():
    for seed in range(3):
        edges, x, free, emask = _graph_problem(seed)
        ref = np.asarray(jg.incidence_fixed_matvec(
            jnp.asarray(edges, jnp.int32), jnp.asarray(x), jnp.asarray(free),
            jnp.asarray(emask)))
        got = tg.incidence_fixed_matvec(
            torch.from_numpy(edges), torch.from_numpy(x),
            torch.from_numpy(free), torch.from_numpy(emask))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


def test_incidence_fixed_matvec_batched_and_complement():
    """A stack of graphs gives each graph's result, and ``A@x_free +
    C@x_fixed == x[j] - x[i]`` on real edges."""
    probs = [_graph_problem(seed) for seed in (4, 5, 6)]
    edges, x, free, emask = (torch.from_numpy(np.stack(a))
                             for a in zip(*probs))
    got = tg.incidence_fixed_matvec(edges, x, free, emask)
    for b in range(3):
        one = tg.incidence_fixed_matvec(edges[b], x[b], free[b], emask[b])
        assert torch.equal(got[b], one)
    a = tg.incidence_matvec(edges, x, free, emask)
    full = torch.where(emask[..., None],
                       torch.gather(x, 1, edges[..., 1:2].expand(-1, -1, 4))
                       - torch.gather(x, 1, edges[..., 0:1].expand(-1, -1, 4)),
                       torch.zeros(()))
    np.testing.assert_allclose((a + got).numpy(), full.numpy(), rtol=0,
                               atol=1e-12)


class _Id:
    def __init__(self, fid):
        self.id = fid


def _both_graphs():
    """The same connections in a JAX and a port ViewGraph (no engine)."""
    rng = np.random.default_rng(2)
    frames = [_Id(v) for v in (7, 9, 12, 20)]
    conns = {(2, 3): None, (0, 1): None, (1, 2): None, (0, 2): None}
    jvg, tvg = JViewGraph.__new__(JViewGraph), ViewGraph.__new__(ViewGraph)
    for vg in (jvg, tvg):
        vg.frames, vg.connections = frames, {}
    for key in conns:
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        t = rng.normal(size=3)
        pairs = np.zeros((0, 2), np.int32)
        jvg.connections[key] = JConnection(pairs=pairs, pose=JRelativePose(
            R=q, t=t, E=np.eye(3), n_cheirality=0,
            inlier_mask=np.ones(0, bool)))
        tvg.connections[key] = Connection(pairs=pairs, pose=RelativePose(
            R=q, t=t, E=np.eye(3), n_cheirality=0,
            inlier_mask=np.ones(0, bool)))
    return jvg, tvg


def test_save_view_graph_and_pose_ids_byte_equal(tmp_path):
    jvg, tvg = _both_graphs()
    for name in ("save_view_graph", "save_pose_ids"):
        getattr(jvg, name)(str(tmp_path / f"j_{name}"))
        getattr(tvg, name)(str(tmp_path / f"t_{name}"))
        a = (tmp_path / f"j_{name}").read_bytes()
        b = (tmp_path / f"t_{name}").read_bytes()
        assert a == b and len(a) > 0
    text = (tmp_path / "t_save_view_graph").read_text()
    assert text.index("i: 7, j: 9,") < text.index("i: 12, j: 20,")


def _canvas_inputs():
    rng = np.random.default_rng(1)
    im1 = rng.integers(0, 255, (48, 64), np.uint8)
    im2 = rng.normal(size=(40, 70)).astype(np.float32)
    xy1 = rng.uniform(0, 60, (30, 2))
    xy2 = rng.uniform(0, 60, (30, 2))
    pairs = np.stack([rng.permutation(30), np.arange(30)], axis=1)
    return im1, xy1, im2, xy2, pairs


@pytest.mark.parametrize("max_lines", [500, 7])
def test_draw_matches_equals_jax(max_lines):
    args = _canvas_inputs()
    ref = jviz.draw_matches(*args, max_lines=max_lines)
    got = viz.draw_matches(*args, max_lines=max_lines)
    assert got.shape == (48, 134, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_png_writer_round_trip(tmp_path):
    """The zlib PNG decodes to the canvas, here and in an imaging
    library (used by this test only)."""
    from PIL import Image

    canvas = viz.draw_matches(*_canvas_inputs())
    path = str(tmp_path / "m.png")
    viz.save_png(path, canvas)
    np.testing.assert_array_equal(viz.read_png(path), canvas)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), canvas)
    gray = canvas[..., 1].copy()
    viz.save_png(path, gray)
    np.testing.assert_array_equal(viz.read_png(path), gray)
    with pytest.raises(ValueError):
        viz.save_png(path, canvas.astype(np.float32))


def test_plot_matches_writes_png_and_refuses_without_image(tmp_path):
    class F:
        pass

    f1, f2 = F(), F()
    f1.image = np.zeros((24, 24), np.uint8)
    f2.image = np.full((24, 24), 90, np.uint8)
    f1.x = np.array([3.0, 20.0])
    f1.y = np.array([3.0, 20.0])
    f2.x = np.array([4.0, 21.0])
    f2.y = np.array([5.0, 19.0])
    path = str(tmp_path / "m.png")
    pairs = np.array([[0, 0], [1, 1]])
    canvas = viz.plot_matches(f1, f2, pairs, path)
    np.testing.assert_array_equal(canvas,
                                  jviz.draw_matches(f1.image, np.stack(
                                      [f1.x, f1.y], 1), f2.image, np.stack(
                                      [f2.x, f2.y], 1), pairs))
    np.testing.assert_array_equal(viz.read_png(path), canvas)
    f2.image = None
    with pytest.raises(ValueError, match="keep_image"):
        viz.plot_matches(f1, f2, pairs)


def test_device_trace_writes_a_cpu_trace(tmp_path):
    with device_trace(None):
        pass
    assert list(tmp_path.iterdir()) == []
    d = str(tmp_path / "trace")
    with device_trace(d, device="cpu"):
        a = torch.ones(16, 16)
        (a @ a).sum()
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "aten::mm" in names
