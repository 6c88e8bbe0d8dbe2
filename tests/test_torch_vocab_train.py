"""The port's vocabulary trainers against the JAX package's on the same
uint32 samples (numpy with the same generator calls; the port's IDF pass
is one descent on the CPU here).  Trees exactly equal (``children``,
``node_desc``, ``word_id``, ``is_leaf``), weights within 1e-12."""

import numpy as np
import pytest
import torch

from irotavg_tpu.placerec import vocabulary as jvoc
from irotavg_tpu_torch.placerec import (
    Vocabulary, train_vocabulary, train_vocabulary_flat,
)


def _random_images(seed=0, n_img=12, per=120):
    """tests/test_placerec.py's samples."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2 ** 32, (per, 8), dtype=np.uint32)
            for _ in range(n_img)]


def _noisy_images(rng, n_img=20, per=200, n_base=800, flip_bits=5):
    """tests/test_vocab_flat.py's samples: noisy re-observations of a
    base set of descriptors."""
    base = rng.integers(0, 2 ** 32, (n_base, 8), dtype=np.uint64
                        ).astype(np.uint32)
    imgs = []
    for _ in range(n_img):
        d = base[rng.integers(0, n_base, per)].copy()
        for _ in range(flip_bits):
            w = rng.integers(0, 8, per)
            b = rng.integers(0, 32, per).astype(np.uint32)
            d[np.arange(per), w] ^= np.uint32(1) << b
        imgs.append(d)
    return imgs


def _assert_same_tree(got: Vocabulary, want):
    np.testing.assert_array_equal(got.children, np.asarray(want.children))
    np.testing.assert_array_equal(got.node_desc.view(np.uint32),
                                  np.asarray(want.node_desc, np.uint32))
    np.testing.assert_array_equal(got.word_id, np.asarray(want.word_id))
    np.testing.assert_array_equal(got.is_leaf, np.asarray(want.is_leaf))
    np.testing.assert_allclose(got.weight, np.asarray(want.weight), rtol=0,
                               atol=1e-12)
    assert (got.k, got.L, got.n_words, got.scoring, got.weighting) == (
        want.k, want.L, want.n_words, want.scoring, want.weighting)


@pytest.mark.parametrize("weighting", ["TF_IDF", "TF"])
def test_train_vocabulary_matches_jax(weighting):
    images = _random_images()
    got = train_vocabulary(images, k=6, L=3, seed=0, weighting=weighting,
                           device="cpu")
    want = jvoc.train_vocabulary(images, k=6, L=3, seed=0,
                                 weighting=weighting)
    _assert_same_tree(got, want)
    assert got.n_words > 30 and (got.weight > 0).any()


@pytest.mark.parametrize("weighting", ["TF_IDF", "BINARY"])
def test_train_vocabulary_flat_matches_jax(weighting):
    imgs = _noisy_images(np.random.default_rng(0))
    got = train_vocabulary_flat(imgs, k=4, L=3, seed=1, iters=4,
                                weighting=weighting, device="cpu")
    want = jvoc.train_vocabulary_flat(imgs, k=4, L=3, seed=1, iters=4,
                                      weighting=weighting)
    _assert_same_tree(got, want)
    assert got.n_words == 4 ** 3 and (got.weight > 0).sum() > 10


def test_train_vocabulary_tiny_clusters_match_jax():
    """Nodes with at most k words (``_kmeans_binary``'s ``n <= k``
    branch) and empty branches become leaves as in the reference."""
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
              for n in (3, 5, 2)]
    got = train_vocabulary(images, k=4, L=3, seed=2, device="cpu")
    want = jvoc.train_vocabulary(images, k=4, L=3, seed=2)
    _assert_same_tree(got, want)


def _first_per_level(k, L):
    return np.cumsum([0] + [k ** d for d in range(L + 1)])


def test_flat_duplicated_seed_and_empty_cluster():
    """Too few descriptors for the tree (ADVICE.md, vocabulary.py:330):
    a cluster with fewer than k members repeats its first member as a
    seed, and the duplicate ties with its original and loses by first-min
    order, so no training descriptor reaches it; a cluster with no member
    keeps all-zero centres.  Both equal the JAX package's."""
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 2 ** 32, (6, 8), dtype=np.uint32)
            for _ in range(2)]
    k, L = 4, 3
    got = train_vocabulary_flat(imgs, k=k, L=L, seed=3, iters=3,
                                device="cpu")
    want = jvoc.train_vocabulary_flat(imgs, k=k, L=L, seed=3, iters=3)
    _assert_same_tree(got, want)

    first = _first_per_level(k, L)
    leaves = got.node_desc.view(np.uint32)[first[L]:first[L + 1]].reshape(
        -1, k, 8)
    # duplicated seeds: a later sibling equal to the first one
    dup = np.array([[j > 0 and np.array_equal(sib[j], sib[0])
                     and sib[0].any() for j in range(k)] for sib in leaves])
    assert dup.any(), "no duplicated seed at the leaf level"
    # empty clusters: every sibling all-zero
    empty = ~leaves.any(axis=(1, 2))
    assert empty.any(), "no empty cluster at the leaf level"
    # the duplicate never wins: no training descriptor lands on it
    desc = torch.from_numpy(np.concatenate(imgs).view(np.int32))
    leaf, _ = got.descend(desc, levelsup=L)
    reached = set((leaf.numpy() - first[L]).tolist())
    dup_words = set(np.flatnonzero(dup.ravel()).tolist())
    assert not reached & dup_words
    assert (got.weight[first[L]:][dup.ravel()] == 0).all()


def test_trained_vocabulary_text_round_trip(tmp_path):
    imgs = _noisy_images(np.random.default_rng(2), per=100)
    v = train_vocabulary_flat(imgs, k=8, L=3, seed=5, iters=3, device="cpu")
    path = str(tmp_path / "v.txt")
    v.save_text(path)
    v2 = Vocabulary.load_text(path, device="cpu")
    for name in ("children", "node_desc", "word_id", "is_leaf"):
        np.testing.assert_array_equal(getattr(v2, name), getattr(v, name))
    # the text format keeps weights to %.6g
    np.testing.assert_allclose(v2.weight, v.weight, rtol=1e-5)
    desc = torch.from_numpy(imgs[0].view(np.int32))
    b1, n1 = v.transform(desc)
    b2, n2 = v2.transform(desc)
    assert set(b1) == set(b2) and b1
    np.testing.assert_array_equal(n1, n2)
