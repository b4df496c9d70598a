"""The port's place recognition against the JAX package's on the CPU: the
vocabulary descent, dense and sparse BoW vectors, both keyframe databases,
the numpy trainer, and recall on the held-out place set. Then the port's
copies of tests/test_place_posegraph.py's TestVocabulary, TestDatabase and
TestSparseDatabase.

Tolerances: word ids exact (on the shipped 100k tree and on a tree with
missing child slots); sparse BoW words exact and weights 1e-6; dense BoW
1e-6; database candidates equal, their scores 1e-6; trained centers equal;
recall@1, recall@5 equal to the JAX package's and the margin 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.eval_place_recognition import evaluate as jevaluate
from tpuslam.place import KeyFrameDatabase as JKeyFrameDatabase
from tpuslam.place import SparseKeyFrameDatabase as JSparseKeyFrameDatabase
from tpuslam.place import Vocabulary as JVocabulary, train_vocabulary as jtrain
from tpuslam.place.vocabulary import bow_vector as jbow_vector
from tpuslam.place.vocabulary import sparse_bow_vector as jsparse_bow_vector
from tpuslam.place.vocabulary import transform_words as jtransform_words
from tpuslam_torch.convert import vocabulary_from_numpy
from tpuslam_torch.place import (
    KeyFrameDatabase,
    SparseKeyFrameDatabase,
    Vocabulary,
    l1_score,
    sparse_bow_vector,
    train_vocabulary,
)
from tpuslam_torch.place.evaluate import PLACE_EVAL_PATH, evaluate
from tpuslam_torch.place.vocabulary import DEFAULT_VOCAB_PATH, bow_vector, transform_words

torch.set_num_threads(2)


def rand_desc(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def corrupt(rng, desc, nbits):
    out = desc.copy()
    for i in range(len(out)):
        for b in rng.integers(0, 256, nbits):
            out[i, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out


def td(desc):
    """uint32 descriptor words -> the port's int32 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(desc).view(np.int32).copy())


def ones(n):
    return torch.ones(n, dtype=torch.bool)


@pytest.fixture(scope="module")
def default_vocab():
    return JVocabulary.load(DEFAULT_VOCAB_PATH), Vocabulary.load(DEFAULT_VOCAB_PATH, device="cpu")


@pytest.fixture(scope="module")
def place_views():
    z = np.load(PLACE_EVAL_PATH)
    return z["view_a"], z["count_a"]


def gapped_tree(rng):
    """A trained k=6, L=3 tree with missing child slots (as trees converted
    from ORBvoc have), every node keeping at least one child."""
    jvoc = jtrain(rand_desc(rng, 2000), k=6, levels=3, seed=5)
    valid = []
    for lvl in range(3):
        v = rng.uniform(size=6 ** (lvl + 1)) > 0.3
        v.reshape(-1, 6)[:, 0] = True
        valid.append(v)
    return jvoc._replace(centers_valid=tuple(jnp.asarray(v) for v in valid))


def test_transform_words_exact_on_the_shipped_tree(default_vocab, place_views, rng):
    jvoc, voc = default_vocab
    va, ca = place_views
    desc = np.concatenate([va[:8].reshape(-1, 8), rand_desc(rng, 300)])
    valid = np.ones(len(desc), bool)
    valid[::7] = False
    want = np.asarray(jtransform_words(jvoc, jnp.asarray(desc), jnp.asarray(valid)))
    got = transform_words(voc, td(desc), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[valid] >= 0).all() and len(np.unique(got[valid])) > 500


def test_transform_words_exact_with_missing_child_slots(rng):
    jvoc = gapped_tree(rng)
    voc = vocabulary_from_numpy(jvoc, device="cpu")
    desc = rand_desc(rng, 500)
    want = np.asarray(jtransform_words(jvoc, jnp.asarray(desc), jnp.ones(500, bool)))
    got = transform_words(voc, td(desc), ones(500)).numpy()
    np.testing.assert_array_equal(got, want)
    leaf_ok = np.asarray(jvoc.centers_valid[2])
    assert leaf_ok[got].all()


@pytest.mark.parametrize("tree", ["shipped", "gapped"])
def test_bow_vectors_match_jax(default_vocab, place_views, rng, tree):
    if tree == "shipped":
        jvoc, voc = default_vocab
        va, ca = place_views
        desc, valid = va[3], np.arange(va.shape[1]) < ca[3]
    else:
        jvoc = gapped_tree(rng)
        voc = vocabulary_from_numpy(jvoc, device="cpu")
        desc, valid = rand_desc(rng, 300), np.arange(300) < 250
    js = jsparse_bow_vector(jvoc, jnp.asarray(desc), jnp.asarray(valid))
    sp = sparse_bow_vector(voc, td(desc), torch.from_numpy(valid))
    np.testing.assert_array_equal(sp.words.numpy(), np.asarray(js.words))
    np.testing.assert_allclose(sp.weight.numpy(), np.asarray(js.weight), atol=1e-6)
    if tree == "gapped":  # dense vectors only for the small tree
        jd = jbow_vector(jvoc, jnp.asarray(desc), jnp.asarray(valid))
        d = bow_vector(voc, td(desc), torch.from_numpy(valid))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
        np.testing.assert_allclose(sp.densify(voc.n_words).numpy(), d.numpy(), atol=1e-6)


def test_database_queries_match_jax(rng):
    """Both layouts, the same keyframes and queries (with exclusions, an
    erased row, a covisibility matrix and a min score): the same
    candidates, their raw scores within 1e-6."""
    jvoc = jtrain(rand_desc(rng, 3000), k=6, levels=3, seed=3)
    voc = vocabulary_from_numpy(jvoc, device="cpu")
    K, L = 12, 250
    descs = [rand_desc(rng, L) for _ in range(10)]
    jd, js = JKeyFrameDatabase(jvoc.n_words, K), JSparseKeyFrameDatabase(jvoc.n_words, K, L)
    d, s = KeyFrameDatabase(voc.n_words, K, device="cpu"), SparseKeyFrameDatabase(voc.n_words, K, L, device="cpu")
    for k in range(10):
        jd.add(k, jbow_vector(jvoc, jnp.asarray(descs[k]), jnp.ones(L, bool)))
        js.add(k, jsparse_bow_vector(jvoc, jnp.asarray(descs[k]), jnp.ones(L, bool)))
        d.add(k, bow_vector(voc, td(descs[k]), ones(L)))
        s.add(k, sparse_bow_vector(voc, td(descs[k]), ones(L)))
    for db in (jd, js, d, s):
        db.erase(7)
    covis = (rng.uniform(0, 1, (K, K)) > 0.7).astype(np.float32) * 20.0
    exclude = np.zeros(K, bool)
    exclude[9] = True
    for probe, min_score in ((2, 0.01), (5, 0.0), (4, 0.05)):
        c = corrupt(rng, descs[probe], 6)
        q_dense = (jbow_vector(jvoc, jnp.asarray(c), jnp.ones(L, bool)), bow_vector(voc, td(c), ones(L)))
        q_sparse = (jsparse_bow_vector(jvoc, jnp.asarray(c), jnp.ones(L, bool)), sparse_bow_vector(voc, td(c), ones(L)))
        for (jdb, db), (jq, q) in (((jd, d), q_dense), ((js, s), q_sparse)):
            jidx, jok = jdb.query(jq, jnp.asarray(exclude), jnp.asarray(covis), min_score)
            idx, ok = db.query(q, torch.from_numpy(exclude), torch.from_numpy(covis), min_score)
            np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
            np.testing.assert_array_equal(idx.numpy()[ok.numpy()], np.asarray(jidx)[np.asarray(jok)])
            assert ok[0]
        np.testing.assert_allclose(l1_score(d.bow, q_dense[1][None]).numpy(),
                                   np.asarray(jnp.sum(jnp.minimum(jd.bow, q_dense[0][None]), -1)), atol=1e-6)


def test_train_vocabulary_matches_jax(rng):
    desc = rand_desc(rng, 1500)
    jvoc = jtrain(desc, k=5, levels=3, seed=4)
    voc = train_vocabulary(desc, k=5, levels=3, seed=4, device="cpu")
    for c, jc in zip(voc.centers, jvoc.centers):
        np.testing.assert_array_equal(c.numpy().view(np.uint32), np.asarray(jc))
    np.testing.assert_array_equal(voc.word_weight.numpy(), np.asarray(jvoc.word_weight))


def test_vocabulary_save_load_roundtrip_with_the_jax_format(rng, tmp_path):
    jvoc = gapped_tree(rng)
    voc = vocabulary_from_numpy(jvoc, device="cpu")
    p = str(tmp_path / "voc.npz")
    voc.save(p)
    back = JVocabulary.load(p)
    for c, jc in zip(back.centers, jvoc.centers):
        np.testing.assert_array_equal(np.asarray(c), np.asarray(jc))
    for v, jv in zip(back.centers_valid, jvoc.centers_valid):
        np.testing.assert_array_equal(np.asarray(v), np.asarray(jv))
    voc2 = Vocabulary.load(p, device="cpu")
    desc = rand_desc(rng, 64)
    np.testing.assert_array_equal(transform_words(voc2, td(desc), ones(64)).numpy(),
                                  transform_words(voc, td(desc), ones(64)).numpy())


def test_recall_on_the_place_set_matches_jax(default_vocab):
    """tests/test_place_scale.py's gates on the port (220 enrolled places),
    and the same recall and margin as the JAX package's evaluation."""
    _, voc = default_vocab
    res = evaluate(voc, PLACE_EVAL_PATH, max_places=220)
    want = jevaluate(DEFAULT_VOCAB_PATH, PLACE_EVAL_PATH, max_places=220, verbose=False)
    assert res["n_places"] == 220
    assert res["recall_at_1"] >= 0.85 and res["recall_at_5"] >= 0.92 and res["mean_margin"] > 0.0, res
    assert res["recall_at_1"] == want["recall_at_1"] and res["recall_at_5"] == want["recall_at_5"]
    assert abs(res["mean_margin"] - want["mean_margin"]) < 1e-5


# -- The port's copies of tests/test_place_posegraph.py's place tests. ----


class TestVocabulary:
    def test_train_and_transform(self, rng):
        desc = rand_desc(rng, 2000)
        voc = train_vocabulary(desc, k=6, levels=3, seed=1, device="cpu")
        assert voc.n_words == 216
        words = transform_words(voc, td(desc[:100]), ones(100)).numpy()
        assert words.min() >= 0 and words.max() < 216

    def test_similar_descriptors_same_word(self, rng):
        desc = rand_desc(rng, 2000)
        voc = train_vocabulary(desc, k=6, levels=3, seed=1, device="cpu")
        a = desc[:200]
        b = corrupt(rng, a, 8)
        wa = transform_words(voc, td(a), ones(200)).numpy()
        wb = transform_words(voc, td(b), ones(200)).numpy()
        assert (wa == wb).mean() > 0.6

    def test_bow_similarity_discriminates(self, rng):
        voc = train_vocabulary(rand_desc(rng, 3000), k=6, levels=3, seed=2, device="cpu")
        img_a = rand_desc(rng, 300)
        img_a2 = corrupt(rng, img_a, 6)
        img_b = rand_desc(rng, 300)
        va = bow_vector(voc, td(img_a), ones(300))
        va2 = bow_vector(voc, td(img_a2), ones(300))
        vb = bow_vector(voc, td(img_b), ones(300))
        s_same = float(l1_score(va, va2))
        s_diff = float(l1_score(va, vb))
        assert s_same > s_diff + 0.1, (s_same, s_diff)
        for _ in range(3):
            vb = bow_vector(voc, td(rand_desc(rng, 300)), ones(300))
            assert s_same > float(l1_score(va, vb)) + 0.08

    def test_save_load_roundtrip(self, rng, tmp_path):
        desc = rand_desc(rng, 500)
        voc = train_vocabulary(desc, k=4, levels=2, seed=0, device="cpu")
        p = str(tmp_path / "voc.npz")
        voc.save(p)
        voc2 = Vocabulary.load(p, device="cpu")
        np.testing.assert_array_equal(transform_words(voc, td(desc[:50]), ones(50)).numpy(),
                                      transform_words(voc2, td(desc[:50]), ones(50)).numpy())


class TestDatabase:
    def test_query_finds_revisit(self, rng):
        voc = train_vocabulary(rand_desc(rng, 3000), k=6, levels=3, seed=3, device="cpu")
        K = 12
        db = KeyFrameDatabase(voc.n_words, K, device="cpu")
        descs = [rand_desc(rng, 250) for _ in range(10)]
        for k in range(10):
            db.add(k, bow_vector(voc, td(descs[k]), ones(250)))
        q = bow_vector(voc, td(corrupt(rng, descs[2], 6)), ones(250))
        exclude = torch.zeros(K, dtype=torch.bool)
        exclude[9] = True
        idx, ok = db.query(q, exclude, torch.zeros((K, K)), min_score=0.0)
        assert ok[0] and int(idx[0]) == 2

    def test_exclusion(self, rng):
        voc = train_vocabulary(rand_desc(rng, 2000), k=6, levels=3, seed=4, device="cpu")
        K = 6
        db = KeyFrameDatabase(voc.n_words, K, device="cpu")
        v = bow_vector(voc, td(rand_desc(rng, 200)), ones(200))
        db.add(0, v)
        idx, ok = db.query(v, torch.ones(K, dtype=torch.bool), torch.zeros((K, K)), 0.0)
        assert not ok.any()


class TestSparseDatabase:
    def test_sparse_bow_matches_dense(self, rng):
        voc = train_vocabulary(rand_desc(rng, 3000), k=6, levels=3, seed=2, device="cpu")
        desc = rand_desc(rng, 300)
        valid = torch.ones(300, dtype=torch.bool)
        valid[250:] = False
        dense = bow_vector(voc, td(desc), valid)
        sp = sparse_bow_vector(voc, td(desc), valid)
        np.testing.assert_allclose(sp.densify(voc.n_words).numpy(), dense.numpy(), atol=1e-6)

    def test_sparse_query_matches_dense(self, rng):
        voc = train_vocabulary(rand_desc(rng, 3000), k=6, levels=3, seed=3, device="cpu")
        K = 12
        db_d = KeyFrameDatabase(voc.n_words, K, device="cpu")
        db_s = SparseKeyFrameDatabase(voc.n_words, K, 250, device="cpu")
        descs = [rand_desc(rng, 250) for _ in range(10)]
        for k in range(10):
            db_d.add(k, bow_vector(voc, td(descs[k]), ones(250)))
            db_s.add(k, sparse_bow_vector(voc, td(descs[k]), ones(250)))
        db_d.erase(7)
        db_s.erase(7)
        covis = torch.from_numpy((rng.uniform(0, 1, (K, K)) > 0.7).astype(np.float32) * 20.0)
        exclude = torch.zeros(K, dtype=torch.bool)
        exclude[9] = True
        for probe in (2, 5):
            c = corrupt(rng, descs[probe], 6)
            id_d, ok_d = db_d.query(bow_vector(voc, td(c), ones(250)), exclude, covis, 0.01)
            id_s, ok_s = db_s.query(sparse_bow_vector(voc, td(c), ones(250)), exclude, covis, 0.01)
            np.testing.assert_array_equal(ok_d.numpy(), ok_s.numpy())
            np.testing.assert_array_equal(id_d[ok_d].numpy(), id_s[ok_s].numpy())

    def test_million_word_vocabulary_fits(self, rng):
        """A synthetic k=10, L=6 tree (the ORBvoc shape): the sparse database
        holds it in a few MB and its query finds the revisit."""
        k, levels = 10, 6
        voc = Vocabulary(centers=tuple(td(rand_desc(rng, k ** (l + 1))) for l in range(levels)),
                         word_weight=torch.ones(k ** levels), k=k, levels=levels)
        K, L = 150, 400
        db = SparseKeyFrameDatabase(voc.n_words, K, L, device="cpu")
        nbytes = sum(x.numel() * x.element_size() for x in (db.words, db.weight, db.has))
        assert nbytes < 50 * 2**20, nbytes
        descs = [rand_desc(rng, L) for _ in range(4)]
        for i, d in enumerate(descs):
            db.add(i, sparse_bow_vector(voc, td(d), ones(L)))
        q = sparse_bow_vector(voc, td(corrupt(rng, descs[1], 4)), ones(L))
        idx, ok = db.query(q, torch.zeros(K, dtype=torch.bool), torch.zeros((K, K)), min_score=0.0)
        assert ok[0] and int(idx[0]) == 1
