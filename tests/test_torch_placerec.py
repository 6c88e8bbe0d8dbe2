"""The port's place recognition against the JAX package on the same
inputs: the DBoW2 text parser on the repo's k=10, L=5 fixture, the tree
descent and BoW assembly on seqgen ORB descriptors (the fixture and a
JAX-trained k=8, L=3 vocabulary carried across), the L1 scorer and the
database cascade.

Tolerances: exact for the vocabulary arrays, leaf/nid, candidate lists
and scores; 1e-12 for BoW weights.
"""

import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from irotavg_tpu.placerec import ViewDatabase as JaxViewDatabase
from irotavg_tpu.placerec import train_vocabulary
from irotavg_tpu.placerec.bow import bow_score as jax_bow_score
from irotavg_tpu.placerec.vocabulary import Vocabulary as JaxVocabulary
from irotavg_tpu.placerec.vocabulary import _descend
from irotavg_tpu.placerec.vocabulary import \
    make_random_vocabulary as jax_random_vocabulary
from irotavg_tpu_torch.frontend.orb import ORBExtractor
from irotavg_tpu_torch.interop import vocabulary_from_arrays
from irotavg_tpu_torch.placerec import ViewDatabase, Vocabulary, bow_score
from irotavg_tpu_torch.placerec.database import _to_arrays, l1_scores
from irotavg_tpu_torch.placerec.vocabulary import make_random_vocabulary
from seqgen import make_sequence

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "product_vocab_k10_L5_v1.txt.gz")


@pytest.fixture(scope="module")
def fixture_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "product_vocab_k10_L5_v1.txt"
    with gzip.open(FIXTURE, "rb") as src, open(path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    return str(path)


@pytest.fixture(scope="module")
def vocabs(fixture_path):
    """(JAX, port) pairs: the fixture, and a k=8, L=3 vocabulary trained
    by the JAX package and carried across."""
    jfix = JaxVocabulary.load_text(fixture_path)
    tfix = Vocabulary.load_text(fixture_path, device="cpu")
    jsmall = train_vocabulary([d[:300] for d in _descs()[::3]], k=8, L=3,
                              seed=0)
    tsmall = vocabulary_from_arrays(
        jsmall.k, jsmall.L, jsmall.children, jsmall.node_desc,
        jsmall.weight, jsmall.word_id, jsmall.is_leaf, jsmall.scoring,
        jsmall.weighting, device="cpu")
    return {"fixture": (jfix, tfix), "k8L3": (jsmall, tsmall)}


_DESCS = []


def _descs():
    """Valid ORB descriptors (uint32 words) of 8 seqgen frames, extracted
    once by the port's extractor."""
    if not _DESCS:
        frames, _, _ = make_sequence(n_frames=8, seed=4, step=0.3,
                                     yaw_deg_per_frame=-1.2, loop=True)
        ext = ORBExtractor(n_features=1000, n_levels=8, device="cpu")
        for im in frames:
            out = ext(im)
            d = out["desc"][out["valid"]].numpy()
            _DESCS.append(np.ascontiguousarray(d).view(np.uint32))
    return _DESCS


def _bows(pair, levelsup=4):
    jv, tv = pair
    out = []
    for d in _descs():
        jb, jn = jv.transform(d, levelsup=levelsup)
        tb, tn = tv.transform(torch.from_numpy(d.view(np.int32)),
                              levelsup=levelsup)
        out.append(((jb, jn), (tb, tn)))
    return out


def test_fixture_parses_to_reference_arrays(vocabs):
    jv, tv = vocabs["fixture"]
    assert (tv.k, tv.L, tv.scoring, tv.weighting) == \
        (jv.k, jv.L, jv.scoring, jv.weighting) == (10, 5, "L1", "TF_IDF")
    assert tv.n_words == jv.n_words == 100_000
    for name in ("children", "weight", "word_id", "is_leaf"):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name))
    np.testing.assert_array_equal(tv.node_desc.view(np.uint32), jv.node_desc)
    assert tv.node_desc.dtype == np.int32
    assert (tv.weight[tv.is_leaf] == 0).any()     # stopped words exist


def test_parser_skips_short_lines_and_reads_save_text(tmp_path, vocabs):
    """A vocabulary written by the JAX ``save_text`` parses to the JAX
    parse of that file, also with CRLF line ends, a short line and a
    blank line added (skipped, as the reference's line parser does)."""
    jv = vocabs["k8L3"][0]
    clean = tmp_path / "clean.txt"
    jv.save_text(str(clean))
    ref = JaxVocabulary.load_text(str(clean))
    lines = clean.read_text().splitlines()
    lines.insert(3, "7 1 2 3")
    lines.insert(5, "")
    noisy = tmp_path / "noisy.txt"
    noisy.write_text("\r\n".join(lines) + "\r\n")
    for path in (clean, noisy):
        got = Vocabulary.load_text(str(path), device="cpu")
        for name in ("children", "weight", "word_id", "is_leaf"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(ref, name))
        np.testing.assert_array_equal(got.node_desc.view(np.uint32),
                                      ref.node_desc)
    (tmp_path / "bad.txt").write_text(clean.read_text() + " x\n")
    with pytest.raises(ValueError, match="parse as numbers"):
        Vocabulary.load_text(str(tmp_path / "bad.txt"))


def test_save_text_roundtrip_is_byte_identical(tmp_path, vocabs):
    jv, tv = vocabs["k8L3"]
    jv.save_text(str(tmp_path / "ref.txt"))
    tv.save_text(str(tmp_path / "port.txt"))
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "ref.txt").read_bytes()


@pytest.mark.parametrize("which", ["fixture", "k8L3"])
@pytest.mark.parametrize("levelsup", [4, 2])
def test_descent_matches_reference(vocabs, which, levelsup):
    """leaf and nid equal the JAX ``_descend``'s on real descriptors
    (about half of the words have bit 31 set), invalid rows included."""
    import jax.numpy as jnp

    jv, tv = vocabs[which]
    d = np.concatenate(_descs()[:3])
    assert ((d >> 31) == 1).mean() > 0.3
    valid = np.random.default_rng(0).random(len(d)) > 0.1
    nid_level = max(jv.L - levelsup, 0)
    jl, jn = _descend(jnp.asarray(d), jnp.asarray(valid), jv._children_j,
                      jv._node_desc_j, jv._is_leaf_j, jv.L, nid_level)
    tl, tn = tv.descend(torch.from_numpy(d.view(np.int32)),
                        torch.from_numpy(valid), levelsup=levelsup)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert (tl.numpy()[~valid] == -1).all()


@pytest.mark.parametrize("which", ["fixture", "k8L3"])
def test_bow_and_feat_nodes_match_reference(vocabs, which):
    pair = vocabs[which]
    for (jb, jn), (tb, tn) in _bows(pair):
        assert tb.keys() == jb.keys() and len(tb) > 0
        assert max(abs(tb[k] - jb[k]) for k in tb) <= 1e-12
        np.testing.assert_array_equal(tn, jn)
        assert tn.dtype == np.int32
    if which == "fixture":
        # level-1 node ids, and -1 on stopped words, as the gates see them
        nodes = np.concatenate([b[1][1] for b in _bows(pair)])
        assert len(set(nodes[nodes >= 0].tolist())) > 1
        assert (nodes == -1).any()


def test_transform_batch_equals_transform(vocabs):
    tv = vocabs["fixture"][1]
    ds = [d[:500] for d in _descs()[:3]]
    stack = torch.from_numpy(np.stack(ds).view(np.int32))
    valid = torch.ones(stack.shape[:2], dtype=torch.bool)
    valid[1, ::7] = False
    got = tv.transform_batch(stack, valid)
    for b in range(3):
        bow, nid = tv.transform(stack[b], valid[b])
        assert got[b][0] == bow
        np.testing.assert_array_equal(got[b][1], nid)


def _merge_join_l1(q_ids, q_w, c_ids, c_w):
    """The JAX package's native ``bow_l1_scores`` (native.cpp:206-227) for
    one candidate, as a sequential Python loop: the same terms, summed in
    the same ascending word order."""
    acc, i, j = 0.0, 0, 0
    while i < len(q_ids) and j < len(c_ids):
        if q_ids[i] == c_ids[j]:
            v, w = float(q_w[i]), float(c_w[j])
            acc += abs(v) + abs(w) - abs(v - w)
            i, j = i + 1, j + 1
        elif q_ids[i] < c_ids[j]:
            i += 1
        else:
            j += 1
    return 0.5 * acc


def test_bow_score_and_batched_l1_match_reference(vocabs):
    from irotavg_tpu import native

    bows = [b[1][0] for b in _bows(vocabs["fixture"])]
    arrs = [_to_arrays(b) for b in bows]
    q_ids, q_w = arrs[0]
    got = l1_scores(q_ids, q_w, arrs[1:])
    for s, b, (c_ids, c_w) in zip(got, bows[1:], arrs[1:]):
        assert bow_score(bows[0], b) == jax_bow_score(bows[0], b)
        assert abs(s - bow_score(bows[0], b)) < 1e-12
        assert s == _merge_join_l1(q_ids, q_w, c_ids, c_w)  # bit for bit
    if native.available():
        c_off = np.cumsum([0] + [len(a[0]) for a in arrs[1:]])
        ref = native.bow_l1_scores(
            q_ids, q_w, np.concatenate([a[0] for a in arrs[1:]]),
            np.concatenate([a[1] for a in arrs[1:]]), c_off)
        np.testing.assert_array_equal(got, ref)        # same summation order


def test_database_cascade_matches_reference(vocabs):
    """A scripted sequence of adds, queries and an erase gives the same
    candidate lists in both databases."""
    bows = [b[1][0] for b in _bows(vocabs["fixture"])]
    jdb, tdb = JaxViewDatabase(), ViewDatabase()

    def covis(vid, n):
        return [v for v in (vid - 1, vid + 1, vid + 2) if v >= 0][:n]

    n_nonempty = 0
    for i, b in enumerate(bows):
        for q in range(i):
            kw = dict(query_id=100 + q, bow=bows[q], connected={i - 1},
                      min_score=0.02, covisibility_fn=covis)
            ref = jdb.detect_loop_candidates(score_fn=jax_bow_score, **kw)
            got = tdb.detect_loop_candidates(score_fn=bow_score, **kw)
            assert got == ref
            n_nonempty += bool(got)
            # any other scorer goes through the per-candidate route
            dot = lambda a, c: bow_score(a, c, "DOT_PRODUCT")  # noqa: E731
            assert tdb.detect_loop_candidates(score_fn=dot, **kw) == \
                jdb.detect_loop_candidates(score_fn=dot, **kw)
        jdb.add(i, b)
        tdb.add(i, b)
        if i == 5:
            jdb.erase(2)
            tdb.erase(2)
    assert n_nonempty > 0
    assert tdb.find_views_sharing_words(bows[0], set()) == \
        jdb.find_views_sharing_words(bows[0], set())


def test_random_vocabulary_matches_reference():
    jv = jax_random_vocabulary(k=4, L=3, seed=3)
    tv = make_random_vocabulary(k=4, L=3, seed=3, device="cpu")
    for name in ("children", "weight", "word_id", "is_leaf"):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name))
    np.testing.assert_array_equal(tv.node_desc.view(np.uint32), jv.node_desc)


def test_descend_refuses_other_device(vocabs):
    tv = vocabs["k8L3"][1]
    with pytest.raises(ValueError, match="vocabulary on cpu"):
        tv.descend(torch.zeros((2, 8), dtype=torch.int32, device="meta"))
