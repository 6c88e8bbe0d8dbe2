"""Hierarchical binary-descriptor vocabulary (DBoW2-compatible).

Port of ``irotavg_tpu/placerec/vocabulary.py``: the runtime, the text IO
and the two trainers (numpy, with the reference's RNG calls, so the same
samples give the same tree; their IDF pass is one device descent).  The
tree is stored as flat
arrays: ``children (n_nodes, k)`` int32 padded with -1, ``node_desc
(n_nodes, 8)`` uint32 words held as int32 bit patterns like the port's
descriptors, ``weight`` f64, ``word_id`` int32 and ``is_leaf`` bool.
The descent tables also live on the vocabulary's ``device``.

The transform is the reference's level-synchronous greedy descent: at
each of the L levels every descriptor gathers its node's k child
descriptors and takes the Hamming argmin (ties -> first child, padded
children read ``1 << 20``).  The host assembly of the BoW dict is the
reference's, so the sums are bit-for-bit the same.

Text IO is the DBoW2 format (ORB-SLAM ``ORBvoc.txt``): header ``k L
scoring weighting``; one node per line ``parent is_leaf d0..d31
weight``; word ids in file order of the leaves.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from irotavg_tpu_torch.device import pick_device

SCORING_NAMES = ["L1", "L2", "CHI_SQUARE", "KL", "BHATTACHARYYA", "DOT_PRODUCT"]
WEIGHTING_NAMES = ["TF_IDF", "TF", "IDF", "BINARY"]
NODE_TOKENS = 35            # parent, is_leaf, 32 descriptor bytes, weight
_PAD_DIST = 1 << 20         # distance of a padded (-1) child
_WS = np.zeros(256, bool)
_WS[[ord(" "), ord("\t"), ord("\n"), ord("\r"), ord("\v"), ord("\f")]] = True


def _desc_to_words(desc_bytes: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 -> (N, 8) uint32 little-endian words."""
    return np.ascontiguousarray(desc_bytes, np.uint8).view("<u4").reshape(
        -1, 8).astype(np.uint32)


def _words_to_bytes(words: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 -> (N, 32) uint8."""
    return np.ascontiguousarray(words, "<u4").view(np.uint8).reshape(-1, 32)


def _popcount32(x):
    """Per-element popcount of int64 tensors holding values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def descend_tables(desc, valid, children, node_desc, n_levels: int,
                   nid_level: int):
    """Batched greedy descent (``_descend`` of the reference).

    ``desc`` (N, 8) int32 words, ``valid`` (N,) bool, ``children``
    (n_nodes, k) int64, ``node_desc`` (n_nodes, 8) int32, all on one
    device.  Returns (leaf (N,), nid (N,)) int64, -1 where not valid;
    nid is the node reached at ``nid_level`` (the root when 0).
    """
    n = desc.shape[0]
    dev = desc.device
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    nid = torch.zeros(n, dtype=torch.int64, device=dev)
    k = children.shape[1]
    slots = torch.arange(k, device=dev)
    for level in range(1, n_levels + 1):
        ch = children[cur]                                  # (N, k)
        has_child = ch >= 0
        ch_safe = ch.clamp(min=0)
        # XOR on the int32 bit patterns, popcount on the unsigned value
        x = (node_desc[ch_safe] ^ desc[:, None, :]).to(torch.int64) \
            & 0xFFFFFFFF
        d = _popcount32(x).sum(dim=-1)
        d = torch.where(has_child, d, torch.full_like(d, _PAD_DIST))
        # first child at the minimum, explicitly (reference scan order)
        dmin = d.amin(dim=1, keepdim=True)
        best = torch.where(d == dmin, slots, k).amin(dim=1)
        nxt = ch_safe.gather(1, best[:, None])[:, 0]
        cur = torch.where(has_child[:, 0], nxt, cur)        # leaf: stay
        if level == nid_level:
            nid = cur
    minus = torch.full_like(cur, -1)
    return torch.where(valid, cur, minus), torch.where(valid, nid, minus)


class Vocabulary:
    """Flat-array vocabulary with batched transform and DBoW2 text IO."""

    def __init__(self, k, L, children, node_desc, weight, word_id, is_leaf,
                 scoring="L1", weighting="TF_IDF", device=None):
        self.k = int(k)
        self.L = int(L)
        self.children = np.asarray(children, np.int32)
        self.node_desc = np.ascontiguousarray(
            np.asarray(node_desc).astype(np.uint32)).view(np.int32)
        self.weight = np.asarray(weight, np.float64)
        self.word_id = np.asarray(word_id, np.int32)
        self.is_leaf = np.asarray(is_leaf, bool)
        self.scoring = scoring
        self.weighting = weighting
        self.n_words = int(self.is_leaf.sum())
        self._children_t = torch.as_tensor(
            self.children, dtype=torch.int64, device=pick_device(device))
        # the tables' own device: "cuda" resolves to "cuda:<current>",
        # which is what the frames' tensors report
        self.device = self._children_t.device
        self._node_desc_t = torch.as_tensor(self.node_desc,
                                            device=self.device)

    # -- runtime ------------------------------------------------------------

    def descend(self, desc, valid=None, levelsup: int = 4):
        """Device ``(leaf, nid)`` for one frame's (N, 8) int32 descriptors,
        not fetched; nid is at level ``L - levelsup``."""
        if desc.device != self.device:
            raise ValueError(f"descriptors are on {desc.device}, the "
                             f"vocabulary on {self.device}")
        if valid is None:
            valid = torch.ones(desc.shape[0], dtype=torch.bool,
                               device=desc.device)
        return descend_tables(desc, valid, self._children_t,
                              self._node_desc_t, self.L,
                              max(self.L - levelsup, 0))

    def assemble(self, leaf, nid):
        """Host assembly of one frame's descent results (:meth:`descend`'s
        tensors, or host arrays) -> (bow, feat_nodes)."""
        leaf, nid = (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                     for v in (leaf, nid))
        return self._assemble(leaf, nid)

    def transform(self, desc, valid=None, levelsup: int = 4):
        """(N, 8) int32 descriptors -> (bow, feat_nodes).

        bow: dict word_id -> weight, L1-normalised (TF-IDF with the L1
        scorer, the ORB-SLAM configuration).  feat_nodes: (N,) int32 host
        array of node ids at level ``L - levelsup``, -1 for invalid
        features and for features on stopped (weight 0) words.
        """
        leaf, nid = self.descend(desc, valid, levelsup)
        leaf, nid = torch.stack([leaf, nid]).cpu().numpy()  # one fetch
        return self._assemble(leaf, nid)

    def transform_batch(self, descs, valids=None, levelsup: int = 4):
        """Transform of ``(B, N, 8)`` stacked descriptors in one descent
        and one fetch; returns a list of ``(bow, feat_nodes)``."""
        B, N = descs.shape[:2]
        if valids is not None:
            valids = valids.reshape(B * N)
        leaf, nid = self.descend(descs.reshape(B * N, -1), valids, levelsup)
        both = torch.stack([leaf, nid]).cpu().numpy().reshape(2, B, N)
        return [self._assemble(both[0, b], both[1, b]) for b in range(B)]

    def _assemble(self, leaf, nid):
        """Host assembly of (bow dict, feat_nodes) from descent results —
        vectorised (np.unique/bincount), no per-descriptor Python loop."""
        ok = leaf >= 0
        wids = self.word_id[leaf[ok]]
        ws = self.weight[leaf[ok]]
        pos = ws > 0
        bow: dict[int, float] = {}
        if pos.any():
            uids, inv = np.unique(wids[pos], return_inverse=True)
            sums = np.bincount(inv, weights=ws[pos])
            total = sums.sum()
            if total > 0:
                sums = sums / total
            bow = dict(zip(uids.tolist(), sums.tolist()))
        # stopped words (weight 0) get no feature-vector entry either
        stopped = np.zeros(len(leaf), bool)
        stopped[ok] = ws <= 0
        nid = np.where(stopped, -1, nid)
        return bow, nid.astype(np.int32)

    # -- text IO (ORB-SLAM format) -----------------------------------------

    @classmethod
    def load_text(cls, path: str, device=None) -> "Vocabulary":
        """Load a DBoW2 text vocabulary (TemplatedVocabulary::
        loadFromTextFile, TemplatedVocabulary.h:1337-1424).

        A vectorised numpy parser: token boundaries come from a
        whitespace mask over the file's bytes, every number is parsed in
        one ``np.fromstring`` call, and lines of fewer than 35 tokens are
        skipped like the reference's line parser does (the first 35
        tokens of a longer line are used)."""
        with open(path, "rb") as fh:
            data = fh.read()
        nl = data.find(b"\n")
        header, body = (data, b"") if nl < 0 else (data[:nl], data[nl + 1:])
        k, L, n1, n2 = (int(v) for v in header.split()[:4])
        table = _parse_node_lines(body)
        parents = table[:, 0].astype(np.int64)
        n_nodes = len(parents) + 1                 # + implicit root (node 0)
        children = np.full((n_nodes, k), -1, np.int32)
        node_desc = np.zeros((n_nodes, 8), np.uint32)
        weight = np.zeros(n_nodes, np.float64)
        is_leaf = np.zeros(n_nodes, bool)
        word_id = np.full(n_nodes, -1, np.int32)

        node_desc[1:] = _desc_to_words(table[:, 2:34].astype(np.uint8))
        weight[1:] = table[:, 34]
        is_leaf[1:] = table[:, 1] > 0
        # word ids in ascending node order (the file's leaf order)
        leaf_ids = np.flatnonzero(is_leaf)
        word_id[leaf_ids] = np.arange(len(leaf_ids), dtype=np.int32)
        # children slots: file order within each parent group
        order = np.argsort(parents, kind="stable")
        sp = parents[order]
        starts = np.r_[0, np.flatnonzero(np.diff(sp)) + 1]
        sizes = np.diff(np.r_[starts, len(order)])
        rank = np.arange(len(order)) - np.repeat(starts, sizes)
        children[sp, rank] = order + 1             # body node i is line i-1
        return cls(k, L, children, node_desc, weight, word_id, is_leaf,
                   scoring=SCORING_NAMES[n1], weighting=WEIGHTING_NAMES[n2],
                   device=device)

    def save_text(self, path: str) -> None:
        n1 = SCORING_NAMES.index(self.scoring)
        n2 = WEIGHTING_NAMES.index(self.weighting)
        n_nodes = len(self.children)
        parent = np.zeros(n_nodes, np.int32)
        mask = self.children >= 0
        parent[self.children[mask]] = np.repeat(
            np.arange(n_nodes, dtype=np.int32), mask.sum(axis=1))
        all_bytes = _words_to_bytes(self.node_desc.view(np.uint32))
        with open(path, "w") as fh:
            fh.write(f"{self.k} {self.L} {n1} {n2}\n")
            for i in range(1, n_nodes):
                db = " ".join(str(int(v)) for v in all_bytes[i])
                fh.write(f"{parent[i]} {1 if self.is_leaf[i] else 0} {db} "
                         f"{self.weight[i]:.6g}\n")


def _parse_node_lines(body: bytes) -> np.ndarray:
    """(n_lines, 35) f64 table of the node lines that hold at least 35
    whitespace-separated tokens (their first 35 tokens)."""
    if not body.strip():
        return np.zeros((0, NODE_TOKENS))
    b = np.frombuffer(body, np.uint8)
    ws = _WS[b]
    start = ~ws
    start[1:] &= ws[:-1]
    tok = np.flatnonzero(start)                    # first byte of each token
    nl = np.flatnonzero(b == ord("\n"))
    line = np.searchsorted(nl, tok)                # line of each token
    counts = np.bincount(line)
    first = np.cumsum(counts) - counts             # first token of each line
    keep = (counts[line] >= NODE_TOKENS) & (
        np.arange(len(tok)) - first[line] < NODE_TOKENS)
    with warnings.catch_warnings():
        # a token that is no number ends the parse early (checked below)
        warnings.simplefilter("ignore", DeprecationWarning)
        vals = np.fromstring(body, dtype=np.float64, sep=" ")
    if len(vals) != len(tok):
        raise ValueError(f"vocabulary body holds {len(tok)} tokens but "
                         f"only {len(vals)} parse as numbers")
    return vals[keep].reshape(-1, NODE_TOKENS)


def make_random_vocabulary(k: int = 10, L: int = 5, seed: int = 0,
                           scoring: str = "L1", weighting: str = "TF_IDF",
                           device=None) -> Vocabulary:
    """Complete k-ary tree of depth L with random descriptors (the
    reference's real-scale stand-in for the ORB-SLAM vocabulary; same
    draws, so the same tree for the same seed)."""
    rng = np.random.default_rng(seed)
    level_sizes = [k ** d for d in range(L + 1)]
    n_nodes = sum(level_sizes)
    children = np.full((n_nodes, k), -1, np.int32)
    first = np.cumsum([0] + level_sizes)
    for d in range(L):
        p0, p1 = first[d], first[d + 1]
        children[p0:p1] = (first[d + 1] + np.arange(
            (p1 - p0) * k, dtype=np.int32).reshape(p1 - p0, k))
    node_desc = rng.integers(0, 2 ** 32, (n_nodes, 8), dtype=np.uint64
                             ).astype(np.uint32)
    node_desc[0] = 0
    is_leaf = np.zeros(n_nodes, bool)
    is_leaf[first[L]:] = True
    weight = np.zeros(n_nodes, np.float64)
    weight[is_leaf] = rng.uniform(0.1, 3.0, level_sizes[L])
    word_id = np.full(n_nodes, -1, np.int32)
    word_id[is_leaf] = np.arange(level_sizes[L], dtype=np.int32)
    return Vocabulary(k, L, children, node_desc, weight, word_id, is_leaf,
                      scoring=scoring, weighting=weighting, device=device)


# -- training -----------------------------------------------------------------
#
# numpy, as in the reference (TemplatedVocabulary::create / HKmeansStep,
# TemplatedVocabulary.h:557-915), with the same generator calls in the same
# order; only the IDF pass runs on the vocabulary's device.

_POP = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1
).sum(axis=1).astype(np.uint8)  # byte popcount LUT


def _complete_tree_arrays(k: int, L: int):
    """Index plumbing for a complete k-ary tree of depth L (the layout of
    :func:`make_random_vocabulary`): (n_nodes, children, first_per_level)."""
    level_sizes = [k ** d for d in range(L + 1)]
    n_nodes = sum(level_sizes)
    children = np.full((n_nodes, k), -1, np.int32)
    first = np.cumsum([0] + level_sizes)
    for d in range(L):
        p0, p1 = first[d], first[d + 1]
        n_p = p1 - p0
        children[p0:p1] = (
            first[d + 1] + np.arange(n_p * k, dtype=np.int32).reshape(n_p, k))
    return n_nodes, children, first


def _image_word_counts(vocab: Vocabulary, per_image) -> np.ndarray:
    """How many of the images hold each word: every training descriptor
    through one greedy descent on the vocabulary's device
    (:func:`descend_tables`), then a per-image unique on the host
    (TemplatedVocabulary::setNodeWeights, :962-1000)."""
    sizes = [len(d) for d in per_image]
    words = np.concatenate(per_image) if per_image else np.zeros((0, 8),
                                                                 np.uint32)
    desc = torch.as_tensor(np.ascontiguousarray(words, np.uint32).view(
        np.int32), device=vocab.device)
    leaf, _ = vocab.descend(desc, levelsup=vocab.L)
    wids = vocab.word_id[leaf.cpu().numpy()]
    counts = np.zeros(vocab.n_words, np.int64)
    for w in np.split(wids, np.cumsum(sizes)[:-1]):
        counts[np.unique(w[w >= 0])] += 1
    return counts


def _idf(counts, n_images):
    """log(N_images / N_images holding the word), 0 where none does."""
    w = np.zeros(len(counts))
    nz = counts > 0
    w[nz] = np.log(n_images / counts[nz])
    return w


def train_vocabulary_flat(images_desc, k: int = 10, L: int = 5,
                          seed: int = 0, iters: int = 6,
                          weighting: str = "TF_IDF", scoring: str = "L1",
                          device=None) -> Vocabulary:
    """Production-scale trainer: level-synchronous hierarchical k-means
    (``irotavg_tpu/placerec/vocabulary.py:291``).

    Every node of a level trains in one vectorised pass: each descriptor
    gathers its k candidate children, byte-LUT popcount, first-min argmin,
    then one sort and ``np.add.reduceat`` segment sum for the bit-majority
    centre update (FORB::meanValue: strict majority, ties -> 0,
    FORB.cpp:63-69).  Seeding takes k random members per cluster.  A
    cluster with fewer than k members repeats its first member: the
    duplicate centre ties with its original and loses by first-min order.
    A cluster that loses every member keeps its centre, and a cluster with
    no member at all keeps an all-zero centre; either becomes a weight-0
    leaf.  The tree is complete.  IDF weights come from one greedy descent
    of the training images on ``device`` (the card unless ``"cpu"``).
    """
    rng = np.random.default_rng(seed)
    per_image = [np.asarray(d, np.uint32) for d in images_desc]
    B = _words_to_bytes(np.concatenate(per_image))     # (N, 32) uint8
    N = len(B)
    bits = np.unpackbits(B, axis=1, bitorder="little")  # (N, 256)

    assign = np.zeros(N, np.int64)   # cluster id within the current level
    centers_levels: list[np.ndarray] = []
    for level in range(L):
        n_clusters = k ** level
        n_child = n_clusters * k
        order = rng.permutation(N)
        a_sh = assign[order]
        s_idx = np.argsort(a_sh, kind="stable")
        members = order[s_idx]
        sorted_a = a_sh[s_idx]
        starts = np.searchsorted(sorted_a, np.arange(n_clusters))
        ends = np.searchsorted(sorted_a, np.arange(n_clusters), side="right")
        centers = np.zeros((n_child, 32), np.uint8)
        base = np.arange(n_clusters, dtype=np.int64) * k
        for j in range(k):
            pos = starts + j
            ok = pos < ends
            centers[base[ok] + j] = B[members[pos[ok]]]
            if j > 0:
                centers[base[~ok] + j] = centers[base[~ok]]

        child = assign * k
        grid = centers.reshape(n_clusters, k, 32)
        for _ in range(iters):
            cand = grid[assign]                          # (N, k, 32)
            d = _POP[cand ^ B[:, None, :]].sum(axis=-1, dtype=np.int32)
            new_child = assign * k + d.argmin(axis=1)    # first-min ties
            if (new_child == child).all():
                break
            child = new_child
            # bit-majority centre update as one segment sum
            cs = np.argsort(child, kind="stable")
            uniq, first_pos, counts = np.unique(
                child[cs], return_index=True, return_counts=True)
            sums = np.add.reduceat(bits[cs].astype(np.int32), first_pos,
                                   axis=0)
            maj = sums * 2 > counts[:, None]             # strict majority
            centers[uniq] = np.packbits(maj, axis=1, bitorder="little")
            grid = centers.reshape(n_clusters, k, 32)
        centers_levels.append(centers)
        assign = child

    n_nodes, children, first = _complete_tree_arrays(k, L)
    node_desc = np.zeros((n_nodes, 8), np.uint32)
    for d in range(L):
        node_desc[first[d + 1]:first[d + 2]] = _desc_to_words(
            centers_levels[d])
    is_leaf = np.zeros(n_nodes, bool)
    is_leaf[first[L]:] = True
    word_id = np.full(n_nodes, -1, np.int32)
    word_id[is_leaf] = np.arange(k ** L, dtype=np.int32)
    vocab = Vocabulary(k, L, children, node_desc, np.zeros(n_nodes),
                       word_id, is_leaf, scoring=scoring,
                       weighting=weighting, device=device)
    # IDF from the greedy descent the runtime transform does, not the last
    # Lloyd assignment (they differ where Lloyd stopped early)
    counts = _image_word_counts(vocab, per_image)
    vocab.weight[first[L]:] = (_idf(counts, len(per_image))
                               if weighting in ("TF_IDF", "IDF")
                               else (counts > 0).astype(np.float64))
    return vocab


def _bit_majority(words: np.ndarray) -> np.ndarray:
    """FORB::meanValue: per-bit majority vote (ties -> 0, the reference's
    strict > half comparison, FORB.cpp:63-69)."""
    bits = np.unpackbits(_words_to_bytes(words), axis=1, bitorder="little")
    maj = bits.sum(axis=0) * 2 > len(words)
    return _desc_to_words(np.packbits(maj, bitorder="little").reshape(
        1, 32))[0]


def _hamming_np(a, b):
    """(len(a), len(b)) Hamming distances of (., 8) uint32 words."""
    x = _words_to_bytes(np.atleast_2d(a))[:, None, :] ^ _words_to_bytes(
        np.atleast_2d(b))[None, :, :]
    return np.unpackbits(x, axis=-1).sum(axis=-1)


def _kmeans_binary(words, k, rng, iters=10):
    """kmeans++ seeding + Lloyd iterations with bit-majority means; a
    centre that loses all its members keeps its value."""
    n = len(words)
    if n <= k:
        return words.copy(), np.arange(n) % max(len(words), 1)
    centers = [words[rng.integers(n)]]
    d = _hamming_np(words, centers[-1][None])[:, 0].astype(np.float64)
    for _ in range(1, k):
        p = d * d
        if p.sum() <= 0:
            centers.append(words[rng.integers(n)])
            continue
        centers.append(words[rng.choice(n, p=p / p.sum())])
        d = np.minimum(d, _hamming_np(words, centers[-1][None])[:, 0])
    C = np.stack(centers)
    assign = None
    for _ in range(iters):
        new_assign = _hamming_np(words, C).argmin(axis=1)
        if assign is not None and (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            sel = words[assign == j]
            if len(sel):
                C[j] = _bit_majority(sel)
    return C, assign


def train_vocabulary(images_desc, k: int = 10, L: int = 3, seed: int = 0,
                     weighting: str = "TF_IDF", scoring: str = "L1",
                     device=None) -> Vocabulary:
    """Recursive hierarchical k-means with kmeans++ seeding
    (``irotavg_tpu/placerec/vocabulary.py:504``) from a list of per-image
    (Ni, 8) uint32 descriptor arrays; IDF weights from one greedy descent
    of the training images on ``device`` (the card unless ``"cpu"``)."""
    rng = np.random.default_rng(seed)
    per_image = [np.asarray(d, np.uint32) for d in images_desc]
    all_words = np.concatenate(per_image)

    children_rows = [[]]  # per node
    node_desc = [np.zeros(8, np.uint32)]
    is_leaf = [False]

    def split(node, words, level):
        if level == L or len(words) == 0:
            is_leaf[node] = True
            return
        C, assign = _kmeans_binary(words, k, rng)
        for j in range(len(C)):
            cid = len(node_desc)
            children_rows[node].append(cid)
            children_rows.append([])
            node_desc.append(C[j])
            is_leaf.append(False)
            split(cid, words[assign == j], level + 1)

    split(0, all_words, 0)

    n_nodes = len(node_desc)
    children = np.full((n_nodes, k), -1, np.int32)
    for i, row in enumerate(children_rows):
        children[i, :len(row)] = row
    # any node without children is a leaf (incomplete branches)
    is_leaf = np.asarray(is_leaf) | (children < 0).all(axis=1)
    word_id = np.full(n_nodes, -1, np.int32)
    word_id[is_leaf] = np.arange(is_leaf.sum())
    vocab = Vocabulary(k, L, children, np.stack(node_desc), np.zeros(n_nodes),
                       word_id, is_leaf, scoring=scoring,
                       weighting=weighting, device=device)
    counts = _image_word_counts(vocab, per_image)
    w = (_idf(counts, len(per_image)) if weighting in ("TF_IDF", "IDF")
         else np.ones(vocab.n_words))
    leaf_nodes = np.flatnonzero(vocab.is_leaf)
    vocab.weight[leaf_nodes] = w[vocab.word_id[leaf_nodes]]
    return vocab
