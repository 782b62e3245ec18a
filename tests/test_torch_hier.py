"""The port's taxonomy-tree algebra and hierarchical losses held against
vamb_tpu.models.hier on the CPU, on numpy-seeded inputs.

* Tree algebra (host numpy in both packages): equal. `Hierarchy`'s masks,
  depths, paths, children and accumulations, `FindLCA`, `make_graph` and
  `argmax_with_confidence`, on trees that `make_graph` builds from random
  lineages cut at random depths, and the other helpers on a fixed tree.
* Every loss and prediction function (the three Taxometer heads,
  `MarginLoss` soft and hard with each margin, the prediction helpers,
  `multilabel_log_likelihood`, `RandomCutLoss`): the value within rtol 1e-5
  of jax's and the gradient within rtol 1e-5 of `jax.grad`'s, with an atol
  of 1e-7 times the gradient's largest |entry| (at least 1e-7) for entries
  that are f32 rounding noise around 0: a root label's gradient is ~1e-9
  in either package, and a conditional softmax's entries that cancel terms
  of ~24 keep ~5e-7 of their rounding. Each batch holds
  leaf labels, internal-node labels and the root; the conditional softmax
  pads its blocks with -inf. A FlatSoftmaxNLL row whose label leaves all
  have log-probability -inf gives inf and a nan gradient row, as in jax.
* `RandomCut` draws jax's `bernoulli`: the cut masks are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vamb_torch.models import hier as th
from vamb_torch.taxonomy import ContigTaxonomy as TTax
from vamb_torch.utils import threefry

from vamb_tpu.models import hier as jh
from vamb_tpu.taxonomy import ContigTaxonomy as JTax


def random_lineages(seed, n=120, cls=JTax):
    "Lineages over a random 6-rank tree, cut at random depths, some unlabelled."
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, 32))
        full = ["Bac", f"P{s // 16}", f"C{s // 8}", f"O{s // 4}", f"G{s // 2}", f"s{s}"]
        cut = int(rng.integers(0, len(full) + 1))
        out.append(cls(full[:cut]) if cut else None)
    return out


def tree_pair(seed):
    nodes, _, parents = jh.make_graph(random_lineages(seed))
    return jh.Hierarchy(np.array(parents)), th.Hierarchy(np.array(parents))


SEEDS = [0, 1, 2]
FIXED = np.array([-1, 0, 0, 1, 1, 2, 2, 5, 5, 0])


# ------------------------------------------------------------ tree algebra


@pytest.mark.parametrize("seed", SEEDS)
def test_make_graph_equal(seed):
    assert th.make_graph(random_lineages(seed, cls=TTax)) == jh.make_graph(random_lineages(seed))


def test_make_graph_rejects_as_vamb_tpu():
    for lineages in ([["a", "b"], ["c", "b"]], [["root", "x"]]):
        for make, cls in ((th.make_graph, TTax), (jh.make_graph, JTax)):
            with pytest.raises(ValueError):
                make([cls(x) for x in lineages])


@pytest.mark.parametrize("seed", SEEDS)
def test_hierarchy_equal(seed):
    jt, tt = tree_pair(seed)
    assert tt.num_nodes() == jt.num_nodes()
    for name in ("leaf_mask", "leaf_subset", "internal_subset", "depths",
                 "num_children", "num_leaf_descendants"):
        assert np.array_equal(getattr(tt, name)(), getattr(jt, name)()), name
    for strict in (False, True):
        assert np.array_equal(tt.ancestor_mask(strict), jt.ancestor_mask(strict))
    for exclude_root in (False, True):
        assert np.array_equal(tt.paths_padded(-1, exclude_root), jt.paths_padded(-1, exclude_root))
    assert np.array_equal(tt.parents(root_loop=True), jt.parents(root_loop=True))
    assert tt.edges() == jt.edges()
    assert {k: v.tolist() for k, v in tt.children().items()} == {
        k: v.tolist() for k, v in jt.children().items()}
    values = np.arange(tt.num_nodes())
    assert np.array_equal(tt.accumulate_ancestors(np.add, values), jt.accumulate_ancestors(np.add, values))
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, tt.num_nodes(), (2, 200))
    assert np.array_equal(th.FindLCA(tt)(a, b), jh.FindLCA(jt)(a, b))
    assert np.array_equal(th.lca_depth(tt, a, b), jh.lca_depth(jt, a, b))
    assert np.array_equal(th.truncate_at_lca(tt, a, b), jh.truncate_at_lca(jt, a, b))
    sub = np.unique(np.concatenate([[0], rng.integers(0, tt.num_nodes(), 5)]))
    assert np.array_equal(th.find_projection(tt, sub), jh.find_projection(jt, sub))
    assert th.format_tree(tt, include_size=True) == jh.format_tree(jt, include_size=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_argmax_with_confidence_equal(seed):
    jt, tt = tree_pair(seed)
    rng = np.random.default_rng(seed + 10)
    p = rng.dirichlet(np.ones(tt.num_leaf_nodes()), 64) @ jt.ancestor_mask()[:, jt.leaf_mask()].T
    spec = -tt.num_leaf_descendants()
    cond = tt.num_children() != 1
    for c in (None, cond):
        assert np.array_equal(
            th.argmax_with_confidence(spec, p, 0.5, c), jh.argmax_with_confidence(spec, p, 0.5, c))
    assert np.array_equal(th.max_info_majority_subtree(tt, p), jh.max_info_majority_subtree(jt, p))
    assert np.array_equal(th.most_confident_leaf(tt, p), jh.most_confident_leaf(jt, p))
    assert np.array_equal(th.plurality_threshold(tt, p), jh.plurality_threshold(jt, p))
    for row in p[:4]:
        assert np.array_equal(th.pareto_optimal_predictions(spec, row, 0.1),
                              jh.pareto_optimal_predictions(spec, row, 0.1))


def test_other_tree_helpers_equal():
    jt, tt = jh.Hierarchy(FIXED), th.Hierarchy(FIXED)
    nodes = np.array([0, 1, 3, 4])
    assert np.array_equal(th.rooted_subtree(tt, nodes).parents(), jh.rooted_subtree(jt, nodes).parents())
    for a, b in zip(th.rooted_subtree_spanning(tt, np.array([6, 8])),
                    jh.rooted_subtree_spanning(jt, np.array([6, 8]))):
        assert np.array_equal(a if isinstance(a, np.ndarray) else a.parents(),
                              b if isinstance(b, np.ndarray) else b.parents())
    assert np.array_equal(th.uniform_cond(tt), jh.uniform_cond(jt))
    assert np.array_equal(th.uniform_leaf(tt), jh.uniform_leaf(jt))
    for extend in (False, True):
        assert [x.tolist() for x in th.level_nodes(tt, extend)] == [
            x.tolist() for x in jh.level_nodes(jt, extend)]
    assert [x.tolist() for x in th.siblings(tt)] == [x.tolist() for x in jh.siblings(jt)]
    value = -tt.num_leaf_descendants().astype(float)
    gt, pr = np.array([3, 7, 9, 0]), np.array([4, 5, 9, 8])
    for metric in ("value_at_lca", "deficient", "excess", "dist", "recall", "precision", "f1"):
        assert np.array_equal(getattr(th.LCAMetric(tt, value), metric)(gt, pr),
                              getattr(jh.LCAMetric(jt, value), metric)(gt, pr))
    edges = [("r", "a"), ("r", "b"), ("a", "c")]
    t_tree, t_names = th.make_hierarchy_from_edges(edges)
    j_tree, j_names = jh.make_hierarchy_from_edges(edges)
    assert t_names == j_names and np.array_equal(t_tree.parents(), j_tree.parents())
    import io
    text = "r,a\n\nr,b\na,c\n"
    assert th.load_edges(io.StringIO(text)) == jh.load_edges(io.StringIO(text))
    keys = (np.array([[3, 1, 2]]), np.array([[0, 0, 1]]))
    assert np.array_equal(th.arglexmin(keys), jh.arglexmin(keys))
    cond = np.array([[False, True, True]])
    assert np.array_equal(th.arglexmin_where(keys, cond), jh.arglexmin_where(keys, cond))


# ---------------------------------------------------------------- losses


def _labels(tree, b, seed):
    "One-hot rows: leaves, internal nodes and the root."
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, tree.num_nodes(), b)
    idx[0] = 0
    idx[1] = tree.internal_subset()[-1]
    idx[2] = tree.leaf_subset()[0]
    onehot = np.zeros((b, tree.num_nodes()), np.float32)
    onehot[np.arange(b), idx] = 1.0
    return onehot


def _loss_pair(name, jt, tt):
    if name == "flat_softmax":
        return jh.FlatSoftmaxNLL(jt), th.FlatSoftmaxNLL(tt), jt.num_leaf_nodes()
    if name == "cond_softmax":
        return jh.HierSoftmaxCrossEntropy(jt), th.HierSoftmaxCrossEntropy(tt), jt.num_nodes() - 1
    hardness, margin = name.split("/")
    return (jh.MarginLoss(jt, hardness, margin, tau=0.5),
            th.MarginLoss(tt, hardness, margin, tau=0.5), jt.num_nodes())


def _grads_close(t_grad, j_grad):
    "rtol 1e-5; atol 1e-7 times the largest |entry| (at least 1e-7)."
    j_grad = np.asarray(j_grad)
    scale = max(1.0, float(np.nanmax(np.abs(j_grad), initial=0.0)))
    np.testing.assert_allclose(t_grad, j_grad, rtol=1e-5, atol=1e-7 * scale)


LOSSES = ["flat_softmax", "cond_softmax"] + [
    f"{h}/{m}" for h in ("soft", "hard") for m in ("incorrect", "edge_dist", "depth_dist")]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_value_and_gradient_match_jax(name, seed):
    jt, tt = tree_pair(seed)
    jloss, tloss, width = _loss_pair(name, jt, tt)
    rng = np.random.default_rng(seed + 100)
    scores = (rng.normal(size=(48, width)) * 2).astype(np.float32)
    labels = _labels(jt, 48, seed)
    value, grad = jax.value_and_grad(lambda s: jloss(s, labels))(scores)
    ts = torch.tensor(scores, requires_grad=True)
    tvalue = tloss(ts, torch.from_numpy(labels))
    tvalue.backward()
    np.testing.assert_allclose(float(tvalue.detach()), float(value), rtol=1e-5)
    _grads_close(ts.grad.numpy(), grad)


def test_flat_softmax_all_minus_inf_row_as_jax():
    jt, tt = jh.Hierarchy(FIXED), th.Hierarchy(FIXED)
    scores = np.random.default_rng(0).normal(size=(2, jt.num_leaf_nodes())).astype(np.float32)
    scores[0, :2] = -np.inf  # node 1's leaves are 3 and 4, columns 0 and 1
    labels = np.zeros((2, 10), np.float32)
    labels[0, 1] = labels[1, 3] = 1.0
    value, grad = jax.value_and_grad(lambda s: jh.FlatSoftmaxNLL(jt)(s, labels))(scores)
    ts = torch.tensor(scores, requires_grad=True)
    tvalue = th.FlatSoftmaxNLL(tt)(ts, torch.from_numpy(labels))
    tvalue.backward()
    assert float(value) == float(tvalue.detach()) == np.inf
    assert np.array_equal(np.isnan(ts.grad.numpy()), np.isnan(np.asarray(grad)))
    assert np.isnan(ts.grad.numpy()[0]).all()
    _grads_close(ts.grad.numpy()[1], np.asarray(grad)[1])


@pytest.mark.parametrize("seed", SEEDS)
def test_prediction_helpers_match_jax(seed):
    jt, tt = tree_pair(seed)
    rng = np.random.default_rng(seed + 200)
    n = jt.num_nodes()
    nodes_x = rng.normal(size=(16, n)).astype(np.float32)
    child_x = rng.normal(size=(16, n - 1)).astype(np.float32)
    leaf_x = rng.normal(size=(16, jt.num_leaf_nodes())).astype(np.float32)
    cases = [
        (jh.SumDescendants(jt), th.SumDescendants(tt), nodes_x),
        (jh.SumDescendants(jt, strict=True), th.SumDescendants(tt, strict=True), nodes_x),
        (jh.SumAncestors(jt, exclude_root=True), th.SumAncestors(tt, exclude_root=True), child_x),
        (jh.SumLeafDescendants(jt), th.SumLeafDescendants(tt), leaf_x),
        (jh.HierCondLogSoftmax(jt), th.HierCondLogSoftmax(tt), child_x),
        (jh.HierLogSoftmax(jt), th.HierLogSoftmax(tt), child_x),
        (jh.multilabel_log_likelihood, th.multilabel_log_likelihood, nodes_x),
        (lambda s: jh.multilabel_log_likelihood(s, insert_root=True, temperature=2.0),
         lambda s: th.multilabel_log_likelihood(s, insert_root=True, temperature=2.0), child_x),
        (lambda s: jh.multilabel_log_likelihood(s, replace_root=True),
         lambda s: th.multilabel_log_likelihood(s, replace_root=True), nodes_x),
    ]
    weights = rng.normal(size=(16, 1)).astype(np.float32)
    for jf, tf, x in cases:
        want, grad = jf(x), jax.grad(lambda s: jnp.sum(jf(s) * weights))(x)
        tx = torch.tensor(x, requires_grad=True)
        got = tf(tx)
        torch.sum(got * torch.from_numpy(weights)).backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        _grads_close(tx.grad.numpy(), grad)


@pytest.mark.parametrize("permit_root_cut", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_cut_matches_jax(seed, permit_root_cut):
    jt, tt = tree_pair(seed)
    leaves = jt.leaf_subset()
    rng = np.random.default_rng(seed + 300)
    labels = np.zeros((32, len(leaves)), np.float32)
    labels[np.arange(32), rng.integers(0, len(leaves), 32)] = 1.0
    scores = rng.normal(size=(32, jt.num_nodes())).astype(np.float32)
    jcut = jh.RandomCut(jt, 0.3, permit_root_cut)(jax.random.key(seed), (32,))
    tcut = th.RandomCut(tt, 0.3, permit_root_cut)(threefry.key(seed), (32,))
    assert np.array_equal(tcut.numpy(), np.asarray(jcut))
    jloss = jh.RandomCutLoss(jt, 0.3, permit_root_cut)
    tloss = th.RandomCutLoss(tt, 0.3, permit_root_cut)
    value, grad = jax.value_and_grad(lambda s: jloss(s, labels, jax.random.key(seed + 7)))(scores)
    ts = torch.tensor(scores, requires_grad=True)
    tvalue = tloss(ts, torch.from_numpy(labels), threefry.key(seed + 7))
    tvalue.backward()
    np.testing.assert_allclose(float(tvalue.detach()), float(value), rtol=1e-5)
    _grads_close(ts.grad.numpy(), grad)
