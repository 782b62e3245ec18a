"""Taxonomy-tree algebra and the hierarchical classification losses.

Port of `vamb_tpu/models/hier.py` (itself the reference's vamb/hloss_misc.py
and `make_graph` of vamb/taxvamb_encode.py:29-61):

* the tree side is host numpy, a copy of `vamb_tpu`'s: `Hierarchy` (nodes
  0..n-1 in a topologically sorted parent array), `make_graph`, the LCA and
  subtree helpers, `LCAMetric`, `argmax_with_confidence`,
  `pareto_optimal_predictions`, `make_hierarchy_from_edges`, `load_edges`;
* the losses and prediction helpers are torch functions of tensors whose
  constant masks live on the `device` given at construction: each is a
  product with a 0/1 ancestor mask (`torch.matmul` in f32; the device
  module turns TF32 off) or a masked logsumexp. Labels are (B, n_nodes)
  one-hot rows (or distributions), as in `vamb_tpu`. Each loss is a mean
  over the batch's rows (`layers.batch_mean`), so in data-parallel training
  a rank's loss is its share of the global batch's.
"""

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..taxonomy import ContigTaxonomy
from ..utils import threefry
from . import layers


class Hierarchy:
    """Rooted tree over nodes 0..n-1, defined by a parent array.

    Node 0 is the root (parent -1) and every parent index is smaller than
    its child's, so iterating nodes in index order visits parents before
    children and in reverse order children before parents. Construction
    precomputes the root-to-node path of every node."""

    def __init__(self, parents: np.ndarray):
        parents = np.asarray(parents, dtype=int)
        n = len(parents)
        if n > 0 and parents[0] != -1:
            raise ValueError("node 0 must be the root (parent -1)")
        if not np.all(parents[1:] < np.arange(1, n)):
            raise ValueError("parents must be topologically sorted (parent < child)")
        self._parents = parents
        chains: list[list[int]] = [[0]] if n else []
        for j in range(1, n):
            chains.append(chains[parents[j]] + [j])
        self._chains = chains
        counts = np.zeros(n, dtype=int)
        for j in range(1, n):
            counts[parents[j]] += 1
        self._n_children = counts

    def num_nodes(self) -> int:
        return len(self._parents)

    def parents(self, root_loop: bool = False) -> np.ndarray:
        "Parent array; with `root_loop` the root points at itself."
        if root_loop:
            out = self._parents.copy()
            out[out < 0] = np.flatnonzero(self._parents < 0)
            return out
        return self._parents.copy()

    def edges(self) -> list[tuple[int, int]]:
        "(parent, child) pairs in child order."
        return [(int(p), j) for j, p in enumerate(self._parents) if p >= 0]

    def children(self) -> dict[int, np.ndarray]:
        "Child index arrays keyed by internal node."
        groups: dict[int, list[int]] = {}
        for p, j in self.edges():
            groups.setdefault(p, []).append(j)
        return {p: np.array(js, dtype=int) for p, js in groups.items()}

    def num_children(self) -> np.ndarray:
        return self._n_children.copy()

    def leaf_mask(self) -> np.ndarray:
        return self._n_children == 0

    def leaf_subset(self) -> np.ndarray:
        return np.flatnonzero(self.leaf_mask())

    def internal_subset(self) -> np.ndarray:
        return np.flatnonzero(self._n_children > 0)

    def num_leaf_nodes(self) -> int:
        return int(np.sum(self.leaf_mask()))

    def num_internal_nodes(self) -> int:
        return int(np.sum(self._n_children > 0))

    def depths(self) -> np.ndarray:
        "Edge count from the root (root depth 0)."
        return np.array([len(c) - 1 for c in self._chains], dtype=int)

    def num_leaf_descendants(self) -> np.ndarray:
        return self.accumulate_descendants(np.add, self.leaf_mask().astype(int))

    def accumulate_ancestors(self, func: Callable, values) -> np.ndarray:
        "Fold `func` down every root-to-leaf path (parents before children)."
        out = np.array(values)
        for j, p in enumerate(self._parents):
            if p >= 0:
                out[j] = func(out[p], out[j])
        return out

    def accumulate_descendants(self, func: Callable, values) -> np.ndarray:
        "Fold `func` up from the leaves (children before parents)."
        out = np.array(values)
        for j in range(len(self._parents) - 1, 0, -1):
            out[self._parents[j]] = func(out[self._parents[j]], out[j])
        return out

    def ancestor_mask(self, strict: bool = False) -> np.ndarray:
        "Boolean [i, j]: i lies on the root-to-j path (j itself unless strict)."
        n = self.num_nodes()
        out = np.zeros((n, n), dtype=bool)
        for j, chain in enumerate(self._chains):
            out[chain, j] = True
            if strict:
                out[j, j] = False
        return out

    def paths_padded(self, pad_value: int = -1, exclude_root: bool = False) -> np.ndarray:
        "Root-to-node chains as one (n, max_depth) pad-filled index matrix."
        chains = [c[1:] for c in self._chains] if exclude_root else self._chains
        width = max((len(c) for c in chains), default=0)
        out = np.full((self.num_nodes(), width), pad_value, dtype=int)
        for j, chain in enumerate(chains):
            out[j, : len(chain)] = chain
        return out


def make_graph(
    taxes: Sequence[Optional[ContigTaxonomy]],
) -> tuple[list[str], dict[str, int], list[int]]:
    """Build the taxonomy tree and BFS-order it into (nodes, index, parents).

    A virtual "root" is node 0; nodes are BFS-ordered with children in
    first-seen order, so the parent table is topologically sorted."""
    children: dict[str, list[str]] = {"root": []}
    parent_of: dict[str, str] = {}
    for tax in taxes:
        if tax is None or len(tax.ranks) == 0:
            continue
        if "root" in tax.ranks:
            raise ValueError(
                'Taxonomy rank named "root" collides with the virtual root '
                "node; rename the rank"
            )
        lineage = ["root"] + list(tax.ranks)
        for parent, child in zip(lineage, lineage[1:]):
            if child not in parent_of:
                parent_of[child] = parent
                children.setdefault(parent, []).append(child)
                children.setdefault(child, [])
            elif parent_of[child] != parent:
                raise ValueError(
                    f'Taxonomy is ambiguous: "{child}" has multiple parents'
                )
    nodes: list[str] = ["root"]
    queue = ["root"]
    while queue:
        u = queue.pop(0)
        for v in children.get(u, ()):
            nodes.append(v)
            queue.append(v)
    ind_nodes = {v: i for i, v in enumerate(nodes)}
    table_parent = [-1 if n == "root" else ind_nodes[parent_of[n]] for n in nodes]
    return nodes, ind_nodes, table_parent


def find_subset_index(base: list, subset: list) -> np.ndarray:
    "Index of subset elements in base list (injective map)."
    name_to_index = {x: i for i, x in enumerate(base)}
    return np.asarray([name_to_index[x] for x in subset], dtype=int)


class FindLCA:
    def __init__(self, tree: Hierarchy):
        self.paths = tree.paths_padded(-1, exclude_root=False)

    def __call__(self, inds_a: np.ndarray, inds_b: np.ndarray) -> np.ndarray:
        paths_a = self.paths[inds_a]
        paths_b = self.paths[inds_b]
        num_common = np.count_nonzero(
            (paths_a == paths_b) & (paths_a >= 0) & (paths_b >= 0), axis=-1
        )
        return self.paths[inds_a, num_common - 1]


def find_projection(tree: Hierarchy, node_subset: np.ndarray) -> np.ndarray:
    "Project each node to its nearest ancestor within `node_subset`."
    assert np.all(node_subset >= 0)
    paths = tree.paths_padded(-1)
    reindex = np.full(tree.num_nodes(), -1)
    reindex[node_subset] = np.arange(len(node_subset))
    subset_paths = np.where(paths >= 0, reindex[paths], -1)
    valid = subset_paths >= 0
    assert np.all(np.any(valid, axis=1))
    deepest = valid.shape[1] - 1 - np.argmax(valid[:, ::-1], axis=1)
    return subset_paths[np.arange(tree.num_nodes()), deepest]


# ----------------------------------------------------------------- losses


def uniform_leaf(tree: Hierarchy) -> np.ndarray:
    "Uniform distribution over leaves, accumulated up the tree."
    is_ancestor = tree.ancestor_mask(strict=False)
    is_leaf = tree.leaf_mask()
    return is_ancestor[:, is_leaf].sum(axis=1) / is_leaf.sum()


def _f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


class SumDescendants:
    """values @ descendant-mask: out[..., i] = sum of values over the
    descendants of i restricted to `subset` columns (hloss_misc.py:628-664)."""

    def __init__(
        self,
        tree: Hierarchy,
        subset: Optional[np.ndarray] = None,
        strict: bool = False,
        device="cpu",
    ):
        matrix = tree.ancestor_mask(strict=strict)
        if subset is not None:
            matrix = matrix[:, subset]
        self.matrix = _f32(matrix.T, device)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        return values @ self.matrix


class SumAncestors:
    def __init__(self, tree: Hierarchy, exclude_root: bool = False, device="cpu"):
        matrix = tree.ancestor_mask(strict=False)
        if exclude_root:
            matrix = matrix[1:, :]
        self.matrix = _f32(matrix, device)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        return values @ self.matrix


def SumLeafDescendants(tree: Hierarchy, strict: bool = False, device="cpu") -> SumDescendants:
    return SumDescendants(tree, subset=tree.leaf_subset(), strict=strict, device=device)


class HierCondLogSoftmax:
    """Per-node log-likelihood given its parent, from flat child scores.

    `scores` has one logit per non-root node, in node order; they are
    scattered into (internal, max_children) blocks padded with -inf,
    log-softmaxed per block and scattered back; the root's entry is 0
    (hloss_misc.py:722-821)."""

    def __init__(self, tree: Hierarchy, device="cpu"):
        node_to_children = tree.children()
        cond_children = [node_to_children[x] for x in tree.internal_subset()]
        cond_num = list(map(len, cond_children))
        self.num_internal = len(cond_children)
        self.max_children = max(cond_num)
        self.num_nodes = tree.num_nodes()
        row = np.concatenate([np.full(n, i) for i, n in enumerate(cond_num)])
        col = np.concatenate([np.arange(n) for n in cond_num])
        self.flat_index = _index(row * self.max_children + col, device)
        self.child_index = _index(np.concatenate(cond_children), device)

    def __call__(self, scores: torch.Tensor) -> torch.Tensor:
        prefix = scores.shape[:-1]
        flat_len = self.num_internal * self.max_children
        flat = scores.new_full((*prefix, flat_len), -torch.inf)
        flat = flat.index_copy(-1, self.flat_index, scores)
        blocks = flat.reshape(*prefix, self.num_internal, self.max_children)
        logp = torch.log_softmax(blocks, dim=-1).reshape(*prefix, flat_len)
        out = scores.new_zeros((*prefix, self.num_nodes))
        return out.index_copy(-1, self.child_index, logp.index_select(-1, self.flat_index))


class HierLogSoftmax:
    "Node log-likelihood: conditional log-softmax summed over ancestors."

    def __init__(self, tree: Hierarchy, device="cpu"):
        self.cond = HierCondLogSoftmax(tree, device)
        self.sum_ancestors = SumAncestors(tree, exclude_root=False, device=device)

    def __call__(self, scores: torch.Tensor) -> torch.Tensor:
        return self.sum_ancestors(self.cond(scores))


class HierSoftmaxCrossEntropy:
    """Cross-entropy of the conditional softmax (hloss_misc.py:667-719).
    `labels` is a (B, num_nodes) one-hot (or distribution) over nodes."""

    def __init__(self, tree: Hierarchy, device="cpu"):
        self.cond = HierCondLogSoftmax(tree, device)
        self.sum_label_descendants = SumDescendants(tree, device=device)

    def __call__(self, scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        q = self.sum_label_descendants(labels.float())
        log_cond_p = self.cond(scores)
        return layers.batch_mean(torch.sum(q * -log_cond_p, dim=-1))


class FlatSoftmaxNLL:
    """Leaf cross-entropy supporting internal labels: the NLL of the summed
    probability over the label's leaf descendants (hloss_misc.py:1102-1133).
    A row whose label leaves all have log-probability -inf has loss inf, as
    in jax."""

    def __init__(self, tree: Hierarchy, device="cpu"):
        is_ancestor = tree.ancestor_mask(strict=False)
        self.leaf_masks = torch.as_tensor(is_ancestor[:, tree.leaf_mask()], device=device)

    def __call__(self, scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        label_idx = torch.argmax(labels, dim=1)
        logp_leaf = torch.log_softmax(scores, dim=-1)
        mask = self.leaf_masks[label_idx]
        logp_label = torch.logsumexp(torch.where(mask, logp_leaf, -torch.inf), dim=-1)
        return layers.batch_mean(-logp_label)


class MarginLoss:
    """Soft or hard margin loss over all nodes (hloss_misc.py:1026-1099).

    TaxVamb uses margin="incorrect" (1 unless the node is an
    ancestor-or-self of the label) with tau 0.01 and soft hardness."""

    def __init__(
        self,
        tree: Hierarchy,
        hardness: str = "soft",
        margin: str = "incorrect",
        tau: float = 1.0,
        device="cpu",
    ):
        if hardness not in ("soft", "hard"):
            raise ValueError(f"unknown hardness {hardness!r}")
        n = tree.num_nodes()
        if margin == "incorrect":
            is_correct = tree.ancestor_mask(strict=False).T
            margin_arr = 1.0 - is_correct
        elif margin in ("edge_dist", "depth_dist"):
            depth = tree.depths()
            lca = FindLCA(tree)
            gt = np.arange(n)[:, None]
            pr = np.arange(n)[None, :]
            lca_idx = lca(np.broadcast_to(gt, (n, n)), np.broadcast_to(pr, (n, n)))
            margin_arr = (depth[gt] - depth[lca_idx]) + (depth[pr] - depth[lca_idx])
        else:
            raise ValueError(f"unknown margin {margin!r}")
        self.hardness = hardness
        self.tau = tau
        self.margin = _f32(margin_arr, device)

    def __call__(self, scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        label_idx = torch.argmax(labels, dim=1)
        label_score = torch.gather(scores, -1, label_idx[:, None])[:, 0]
        label_margin = self.margin[label_idx]
        if self.hardness == "soft":
            loss = -label_score + torch.logsumexp(scores + self.tau * label_margin, dim=-1)
        else:
            loss = torch.relu(
                torch.amax(scores - label_score[:, None] + self.tau * label_margin, dim=-1)
            )
        return layers.batch_mean(loss)


# --------------------------------------------------------- prediction pickers


def argmax_with_confidence(
    value: np.ndarray,
    p: np.ndarray,
    threshold: float,
    condition: Optional[np.ndarray] = None,
) -> np.ndarray:
    "Element maximizing (p, value) lexicographically subject to p > threshold."
    mask = p > threshold
    if condition is not None:
        mask = mask & condition
    assert np.all(np.any(mask, axis=-1)), "require at least one valid element"
    keys = np.broadcast_arrays(-p, -value)
    order = np.lexsort(keys, axis=-1)
    first_valid = np.expand_dims(
        np.argmax(np.take_along_axis(mask, order, axis=-1), axis=-1), -1
    )
    return np.take_along_axis(order, first_valid, axis=-1).squeeze(-1)


def pareto_optimal_predictions(
    info: np.ndarray,
    prob: np.ndarray,
    min_threshold: Optional[float] = None,
    condition: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Nodes more specific than every more-confident node, ordered by
    descending prob (hloss_misc.py:495-541)."""
    assert prob.ndim == 1 and info.ndim == 1
    is_valid = np.ones(prob.shape, dtype=bool)
    if min_threshold is not None:
        is_valid &= prob > min_threshold
    if condition is not None:
        is_valid &= condition
    assert np.any(is_valid), "require at least one valid element"
    prob_v = prob[is_valid]
    info_v = info[is_valid]
    valid_inds = np.flatnonzero(is_valid)
    order = np.lexsort((-info_v, -prob_v))
    prob_v = prob_v[order]
    info_v = info_v[order]
    max_info = np.maximum.accumulate(info_v)
    keep = np.concatenate(
        ([True], (prob_v[1:] > prob_v[:-1]) | (info_v[1:] > max_info[:-1]))
    )
    return valid_inds[order[keep]]


# -------------------------------------------------- additional tree algebra


def rooted_subtree(tree: Hierarchy, nodes: np.ndarray) -> Hierarchy:
    "Subtree over `nodes` (must include root 0 and all needed parents)."
    assert nodes[0] == 0
    reindex = np.full(tree.num_nodes(), -1)
    reindex[nodes] = np.arange(len(nodes))
    parents = tree.parents()
    subtree_parents = np.where(parents[nodes] >= 0, reindex[parents[nodes]], -1)
    assert np.all(subtree_parents[1:] >= 0), "parent not in subset"
    assert np.all(subtree_parents < np.arange(len(nodes)))
    return Hierarchy(subtree_parents)


def ancestors_union(tree: Hierarchy, node_subset: np.ndarray) -> np.ndarray:
    "Union of ancestors (incl. selves) of the given nodes."
    paths = tree.paths_padded(-1)[node_subset]
    return np.unique(paths[paths >= 0])


def rooted_subtree_spanning(tree: Hierarchy, nodes: np.ndarray) -> tuple[Hierarchy, np.ndarray]:
    nodes = ancestors_union(tree, nodes)
    return rooted_subtree(tree, nodes), nodes


def uniform_cond(tree: Hierarchy) -> np.ndarray:
    "Node likelihoods under uniform child choice at every conditional."
    node_to_num_children = {k: len(v) for k, v in tree.children().items()}
    num_children = np.asarray(
        [node_to_num_children.get(x, 0) for x in range(tree.num_nodes())]
    )
    parent_index = tree.parents()
    log_cond_p = np.concatenate([[0.0], -np.log(num_children[parent_index[1:]])])
    is_ancestor = tree.ancestor_mask(strict=False)
    return np.exp(np.dot(is_ancestor.T, log_cond_p))


def truncate_at_lca(tree: Hierarchy, gt: np.ndarray, pr: np.ndarray) -> np.ndarray:
    "Truncate predictions that overshoot below the ground truth."
    lca = FindLCA(tree)(gt, pr)
    return np.where(gt == lca, gt, pr)


def level_nodes(tree: Hierarchy, extend: bool = False) -> list[np.ndarray]:
    "Nodes at each depth (leaves optionally extended to deeper levels)."
    node_depth = tree.depths()
    is_leaf = tree.leaf_mask()
    max_depth = int(np.max(node_depth))
    level_depth = np.arange(1, max_depth + 1)
    if not extend:
        level_masks = level_depth[:, None] == node_depth
    else:
        level_masks = (level_depth[:, None] == node_depth) | (
            (level_depth[:, None] > node_depth) & is_leaf
        )
    return [np.flatnonzero(mask) for mask in level_masks]


def siblings(tree: Hierarchy) -> list[np.ndarray]:
    "For each node, the other children of its parent (root: empty)."
    node_parent = tree.parents()
    node_children = tree.children()
    out = []
    for u in range(tree.num_nodes()):
        p = node_parent[u]
        if p < 0:
            out.append(np.empty(0, dtype=int))
        else:
            sibs = node_children[p]
            out.append(sibs[sibs != u])
    return out


def format_tree(
    tree: Hierarchy, node_names: Optional[list[str]] = None, include_size: bool = False
) -> str:
    "ASCII rendering of the tree for logs."
    if node_names is None:
        node_names = [str(i) for i in range(tree.num_nodes())]
    node_to_children = tree.children()
    node_sizes = tree.num_leaf_descendants()

    def subtree(node, node_prefix, desc_prefix):
        name = node_names[node]
        size = node_sizes[node]
        text = f"{name} ({size})" if include_size and size > 1 else name
        yield node_prefix + text + "\n"
        children = node_to_children.get(node, ())
        for i, child in enumerate(children):
            is_last = i == len(children) - 1
            yield from subtree(
                child,
                node_prefix=desc_prefix + ("└── " if is_last else "├── "),
                desc_prefix=desc_prefix + ("    " if is_last else "│   "),
            )

    return "".join(subtree(0, "", ""))


def most_confident_leaf(tree: Hierarchy, p: np.ndarray) -> np.ndarray:
    "Leaf with highest probability per row."
    assert p.shape[-1] == tree.num_nodes()
    masked = np.where(tree.leaf_mask(), p, -np.inf)
    return np.argmax(masked, axis=-1)


def max_info_majority_subtree(tree: Hierarchy, p: np.ndarray) -> np.ndarray:
    "Most specific non-trivial node with probability > 0.5."
    assert p.shape[-1] == tree.num_nodes()
    specificity = -tree.num_leaf_descendants()
    not_trivial = tree.num_children() != 1
    return argmax_with_confidence(specificity, p, 0.5, not_trivial)


def plurality_threshold(tree: Hierarchy, p: np.ndarray, keepdims: bool = False) -> np.ndarray:
    "Largest second-best child probability over all non-trivial families."
    top2 = []
    for _u, inds in tree.children().items():
        if len(inds) > 1:
            top2.append(np.sort(p[..., inds], axis=-1)[..., -2])
    threshold = np.max(np.stack(top2, axis=-1), axis=-1)
    if keepdims:
        threshold = np.expand_dims(threshold, -1)
    return threshold


class LCAMetric:
    "Value-at-LCA metrics (depth/info recall, precision, f1, distances)."

    def __init__(self, tree: Hierarchy, value: np.ndarray):
        self.value = value
        self.find_lca = FindLCA(tree)

    def value_at_lca(self, gt, pr):
        return self.value[self.find_lca(gt, pr)]

    def deficient(self, gt, pr):
        return self.value[gt] - self.value[self.find_lca(gt, pr)]

    def excess(self, gt, pr):
        return self.value[pr] - self.value[self.find_lca(gt, pr)]

    def dist(self, gt, pr):
        lca = self.find_lca(gt, pr)
        return (self.value[pr] - self.value[lca]) + (self.value[gt] - self.value[lca])

    def recall(self, gt, pr):
        lca_value = self.value[self.find_lca(gt, pr)]
        gt_value = self.value[gt]
        with np.errstate(invalid="ignore"):
            return np.where((lca_value == 0) & (gt_value == 0), 1.0, lca_value / gt_value)

    def precision(self, gt, pr):
        lca_value = self.value[self.find_lca(gt, pr)]
        pr_value = self.value[pr]
        with np.errstate(invalid="ignore"):
            return np.where((lca_value == 0) & (pr_value == 0), 1.0, lca_value / pr_value)

    def f1(self, gt, pr):
        r = self.recall(gt, pr)
        p = self.precision(gt, pr)
        with np.errstate(divide="ignore"):
            return 2 / (1 / r + 1 / p)


# ----------------------------------------------------- tree construction IO


def make_hierarchy_from_edges(
    pairs: Sequence[tuple[str, str]],
) -> tuple[Hierarchy, list[str]]:
    """Build a Hierarchy from (parent, child) name pairs. The root is the
    first pair's parent; every other node appears exactly once as a child,
    edges parent-first (hloss_misc.py:167-195)."""
    if not pairs:
        raise ValueError("need at least one edge")
    root = pairs[0][0]
    index_of = {root: 0}
    names = [root]
    parents = [-1]
    for parent, child in pairs:
        if child in index_of:
            raise ValueError(f'node "{child}" has multiple parents')
        if parent not in index_of:
            raise ValueError(f'parent "{parent}" seen before being defined')
        index_of[child] = len(names)
        parents.append(index_of[parent])
        names.append(child)
    return Hierarchy(np.asarray(parents)), names


def load_edges(f, delimiter: str = ",") -> list[tuple[str, str]]:
    "Read (parent, child) rows from a delimited text stream."
    import csv

    pairs: list[tuple[str, str]] = []
    for row in csv.reader(f, delimiter=delimiter):
        if not row:
            continue
        if len(row) != 2:
            raise ValueError(f"expected 2 columns, got {row}")
        pairs.append((row[0], row[1]))
    return pairs


def lca_depth(tree: Hierarchy, inds_a: np.ndarray, inds_b: np.ndarray) -> np.ndarray:
    "Depth of the lowest common ancestor (root = depth 0); broadcasts."
    paths = tree.paths_padded(exclude_root=True)
    shared = (paths[inds_a] == paths[inds_b]) & (paths[inds_a] >= 0) & (paths[inds_b] >= 0)
    return np.count_nonzero(shared, axis=-1)


def truncate_given_lca(gt: np.ndarray, pr: np.ndarray, lca: np.ndarray) -> np.ndarray:
    "Replace predictions that descend from the ground truth by the truth itself."
    return np.where(gt == lca, gt, pr)


def arglexmin(keys: tuple, axis: int = -1) -> np.ndarray:
    "Index of the lexicographic minimum over `axis` (last key is primary)."
    return np.take(np.lexsort(keys, axis=axis), 0, axis=axis)


def arglexmin_where(
    keys: tuple, condition: np.ndarray, axis: int = -1, keepdims: bool = False
) -> np.ndarray:
    "Lexicographic argmin restricted to elements where `condition` holds."
    if not np.all(np.any(condition, axis=axis)):
        raise ValueError("need at least one valid element along the axis")
    order = np.lexsort(keys, axis=axis)
    ordered_ok = np.take_along_axis(condition, order, axis=axis)
    first = np.expand_dims(np.argmax(ordered_ok, axis=axis), axis)
    result = np.take_along_axis(order, first, axis=axis)
    return result if keepdims else np.squeeze(result, axis=axis)


# ------------------------------------------- multilabel / random-cut losses


def multilabel_log_likelihood(
    scores: torch.Tensor,
    insert_root: bool = False,
    replace_root: bool = False,
    temperature: Optional[float] = None,
) -> torch.Tensor:
    """Per-node independent log-likelihoods log sigmoid(score / T), the root
    optionally prepended or pinned to logp = 0 (hloss_misc.py:843-862)."""
    if insert_root and replace_root:
        raise ValueError("insert_root and replace_root are exclusive")
    if temperature:
        scores = scores / temperature
    logp = torch.nn.functional.logsigmoid(scores)
    zero = logp.new_zeros((*logp.shape[:-1], 1))
    if insert_root:
        return torch.cat([zero, logp], dim=-1)
    if replace_root:
        return torch.cat([zero, logp[..., 1:]], dim=-1)
    return logp


class RandomCut:
    """Sample random tree cuts: walking down from the root, each node is
    severed with probability `cut_prob`; the result is a boolean mask over
    nodes marking the leaf frontier of the surviving subtree
    (hloss_misc.py:865-909). The severed nodes are `jax.random.bernoulli`'s
    draw for the same key (`threefry.bernoulli`)."""

    def __init__(self, tree: Hierarchy, cut_prob: float, permit_root_cut: bool = False, device="cpu"):
        self.n = tree.num_nodes()
        self.cut_prob = cut_prob
        self.permit_root_cut = permit_root_cut
        self.device = torch.device(device)
        self.sum_ancestors = SumAncestors(tree, device=device)
        self.parent_loop = _index(tree.parents(root_loop=True), device)
        counts = np.zeros((self.n - 1, self.n), np.float32)
        counts[np.arange(1, self.n) - 1, tree.parents()[1:]] = 1.0
        self._child_counts = _f32(counts, device)

    def __call__(self, key, batch_shape: tuple = ()) -> torch.Tensor:
        drop = threefry.bernoulli(key, self.cut_prob, (*batch_shape, self.n), self.device)
        drop = drop.float()
        if not self.permit_root_cut:
            drop[..., 0] = 0.0
        alive = self.sum_ancestors(drop) == 0
        in_cut = alive[..., self.parent_loop]
        in_cut[..., 0] = True
        kept_children = in_cut[..., 1:].float() @ self._child_counts
        return in_cut & (kept_children == 0)


class RandomCutLoss:
    """Cross-entropy over the leaves of a random cut (hloss_misc.py:912-962).
    `labels` are leaf one-hots; the target inside the cut is the unique cut
    node that is an ancestor-or-self of the labelled leaf."""

    def __init__(self, tree: Hierarchy, cut_prob: float, permit_root_cut: bool = False, device="cpu"):
        self.random_cut = RandomCut(tree, cut_prob, permit_root_cut, device)
        targets = tree.ancestor_mask(strict=False).T[tree.leaf_subset()]
        self.label_to_targets = torch.as_tensor(targets, device=device)

    def __call__(self, scores: torch.Tensor, labels: torch.Tensor, key) -> torch.Tensor:
        label_idx = torch.argmax(labels, dim=-1)
        cut = self.random_cut(key, tuple(scores.shape[:-1]))
        targets = self.label_to_targets[label_idx]
        cut, targets, scores = cut[..., 1:], targets[..., 1:], scores[..., 1:]
        on_target = cut & targets
        pos = torch.sum(torch.where(on_target, scores, 0.0), dim=-1)
        lse = torch.logsumexp(torch.where(cut, scores, -torch.inf), dim=-1)
        return layers.batch_mean(lse - pos)
