"""Marker-guided bin refinement: SCG-seeded KMeans or per-genus DBSCAN.

Port of `vamb_tpu/reclustering.py` (behavioral parity: reference
vamb/reclustering.py, itself based on the SemiBin2 algorithm). Two
algorithms:

* **KMeans**: for each existing bin whose median SCG count >= 2, split into
  that many weighted-KMeans clusters, seeded by the contigs carrying the
  marker whose smallest carrier is longest (reclustering.py:94-228).
  The KMeans itself is the torch implementation in ops/kmeans.py, on the
  card unless the caller asks for the CPU.
* **DBSCAN**: per-genus density clustering over cosine distances, sweeping
  eps in 0.01:0.02:0.35 and keeping the binning that maximizes the number
  of near-good genomes (completeness >= 0.75, contamination <= 0.3);
  stop after 3 non-improving eps values (reclustering.py:239-320).
  With contig-length sample weights, every point satisfies min_samples=5,
  so DBSCAN reduces to connected components of the eps-neighborhood graph;
  implemented directly that way, in numpy float64 on the host as in
  `vamb_tpu` (whose reduction tests/test_reclustering.py::
  TestDBSCANSklearnEquivalence holds against sklearn's DBSCAN).
"""

from collections import defaultdict
from typing import Iterable, Optional, Union

import numpy as np

from .composition import CompositionMetaData
from .markers import Markers
from .taxonomy import Taxonomy
from .utils import RefHasher

EPS_VALUES = np.arange(0.01, 0.35, 0.02)


class KmeansAlgorithm:
    "Arguments needed specifically when using the KMeans algorithm."

    def __init__(
        self,
        clusters: list[set[int]],
        random_seed: int,
        contiglengths: np.ndarray,
        device="cuda",
    ):
        assert np.issubdtype(contiglengths.dtype, np.integer)
        self.contiglengths = contiglengths
        self.clusters = clusters
        self.random_seed = random_seed
        self.device = device


class DBScanAlgorithm:
    "Arguments needed specifically when using the DBScan algorithm."

    def __init__(
        self, comp_metadata: CompositionMetaData, taxonomy: Taxonomy, n_processes: int
    ):
        if not taxonomy.is_canonical:
            raise ValueError(
                "Can only run DBScan on a Taxonomy object with is_canonical set"
            )
        RefHasher.verify_refhash(
            taxonomy.refhash, comp_metadata.refhash, "taxonomy", "composition", None
        )
        self.contiglengths = comp_metadata.lengths
        self.taxonomy = taxonomy
        self.n_processes = n_processes


def recluster_bins(
    markers: Markers,
    latent: np.ndarray,
    algorithm: Union[KmeansAlgorithm, DBScanAlgorithm],
) -> list[set[int]]:
    assert np.issubdtype(algorithm.contiglengths.dtype, np.integer)
    assert np.issubdtype(latent.dtype, np.floating)
    if not (len(algorithm.contiglengths) == markers.n_seqs == len(latent)):
        raise ValueError(
            "Number of elements in contiglengths, markers and latent must match"
        )
    if isinstance(algorithm, KmeansAlgorithm):
        return recluster_kmeans(
            algorithm.clusters,
            latent,
            algorithm.contiglengths,
            markers,
            algorithm.random_seed,
            algorithm.device,
        )
    assert len(algorithm.taxonomy.contig_taxonomies) == markers.n_seqs
    return recluster_dbscan(
        algorithm.taxonomy, latent, algorithm.contiglengths, markers
    )


def recluster_kmeans(
    clusters: list[set[int]],
    latent: np.ndarray,
    contiglengths: np.ndarray,
    markers: Markers,
    random_seed: int,
    device="cuda",
) -> list[set[int]]:
    from .ops.kmeans import kmeans

    assert len(latent) == len(contiglengths) == markers.n_seqs
    assert latent.ndim == 2

    result: list[set[int]] = []
    for cluster in clusters:
        # single-contig bins cannot have duplicated SCGs
        if len(cluster) == 1:
            result.append(cluster)
            continue
        counts = count_markers(cluster, markers)
        cp = np.sort(counts.copy())
        median_counts = int(cp[len(cp) // 2])
        if median_counts < 2:
            result.append(cluster)
            continue

        seeds = get_kmeans_seeds(cluster, markers, contiglengths, counts, median_counts)
        cluster_indices = np.array(list(cluster))
        labels = kmeans(
            latent[cluster_indices],
            median_counts,
            latent[seeds],
            contiglengths[cluster_indices].astype(np.float64),
            device=device,
        )
        by_label: defaultdict[int, set[int]] = defaultdict(set)
        for lab, index in zip(labels, cluster_indices):
            by_label[int(lab)].add(int(index))
        result.extend(by_label.values())
    return result


def count_markers(contigs: Iterable[int], markers: Markers) -> np.ndarray:
    "counts[m] = number of occurrences of marker m among `contigs`."
    counts = np.zeros(markers.n_markers, dtype=np.int32)
    for contig in contigs:
        m = markers.markers[contig]
        if m is not None:
            counts[m] += 1
    return counts


def count_markers_saturated(
    contigs: Iterable[int], markers: Markers
) -> Optional[np.ndarray]:
    "Like count_markers but bails (None) once contamination reaches 1.0."
    counts = np.zeros(markers.n_markers, dtype=np.int32)
    n_markers = 0
    n_unique = 0
    max_duplicates = markers.n_markers
    for contig in contigs:
        m = markers.markers[contig]
        if m is not None:
            n_markers += len(m)
            for i in m:
                existing = counts[i]
                n_unique += existing == 0
                counts[i] = existing + 1
            if (n_markers - n_unique) > max_duplicates:
                return None
    return counts


def get_kmeans_seeds(
    contigs: Iterable[int],
    markers: Markers,
    contiglengths: np.ndarray,
    counts: np.ndarray,
    median: int,
) -> list[int]:
    """Seed contigs: carriers of the median-count marker whose smallest
    carrier is longest (reference reclustering.py:206-228)."""
    considered = {i for (i, c) in enumerate(counts) if c == median}
    contigs_of_markers: dict[int, list[int]] = defaultdict(list)
    for contig in contigs:
        m = markers.markers[contig]
        if m is None:
            continue
        for mid in m:
            if mid in considered:
                contigs_of_markers[int(mid)].append(contig)
    candidate_list = list(contigs_of_markers.items())
    pair = max(candidate_list, key=lambda x: min(contiglengths[i] for i in x[1]))
    result = pair[1]
    assert len(result) == median
    return result


def get_completeness_contamination(counts: np.ndarray) -> tuple[float, float]:
    n_total = counts.sum()
    n_unique = (counts > 0).sum()
    return (n_unique / len(counts), (n_total - n_unique) / len(counts))


def recluster_dbscan(
    taxonomy: Taxonomy,
    latent: np.ndarray,
    contiglengths: np.ndarray,
    markers: Markers,
) -> list[set[int]]:
    "eps sweep of per-genus DBSCAN, keeping the best-scoring binning."
    genera_indices = group_indices_by_genus(taxonomy)
    n_worse_in_row = 0
    best_score = 0
    best_bins: list[set[int]] = []
    for eps in EPS_VALUES:
        bins: list[set[int]] = []
        for indices in genera_indices:
            bins.extend(
                dbscan_genus(latent[indices], indices, contiglengths[indices], eps)
            )
        score = count_good_genomes(bins, markers)
        if best_score == 0 or score > best_score:
            best_bins = bins
            best_score = score
        if score >= best_score:
            n_worse_in_row = 0
        else:
            n_worse_in_row += 1
            if n_worse_in_row > 2:
                break
    return best_bins


def _cosine_distances(x: np.ndarray) -> np.ndarray:
    "Pairwise cosine distances, zero vectors treated as in sklearn (dist 1)."
    norms = np.linalg.norm(x, axis=1)
    safe = np.where(norms == 0, 1.0, norms)
    normed = x / safe[:, None]
    sim = normed @ normed.T
    np.clip(sim, -1.0, 1.0, out=sim)
    dist = 1.0 - sim
    np.fill_diagonal(dist, 0.0)
    return dist


def dbscan_genus(
    latent_of_genus: np.ndarray,
    original_indices: np.ndarray,
    contiglengths_of_genus: np.ndarray,
    eps: float,
    min_samples: float = 5.0,
) -> list[set[int]]:
    """Weighted DBSCAN within one genus (reference reclustering.py:276-305).

    Core condition: the summed length-weight of the eps-neighborhood
    (including self) >= min_samples; with contig lengths >= 2000 this holds
    for every point, making clusters the connected components of the
    eps-graph through core points. Border points attach to the first
    neighboring cluster; true noise gets a singleton bin (the reference
    likewise emits the label -1 group as one bin).
    """
    assert len(latent_of_genus) == len(original_indices) == len(contiglengths_of_genus)
    n = len(latent_of_genus)
    dist = _cosine_distances(np.asarray(latent_of_genus, np.float64))
    adj = dist <= eps
    weights = contiglengths_of_genus.astype(np.float64)
    core = (adj * weights[None, :]).sum(axis=1) >= min_samples

    labels = np.full(n, -1, dtype=np.int64)
    current = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        # BFS over core connectivity
        stack = [i]
        labels[i] = current
        while stack:
            j = stack.pop()
            if not core[j]:
                continue
            for k in np.flatnonzero(adj[j]):
                if labels[k] == -1:
                    labels[k] = current
                    if core[k]:
                        stack.append(k)
        current += 1

    bins: defaultdict[int, set[int]] = defaultdict(set)
    for original_index, bin_index in zip(original_indices, labels):
        bins[int(bin_index)].add(int(original_index))
    return list(bins.values())


def count_good_genomes(binning: Iterable[Iterable[int]], markers: Markers) -> int:
    "Bins with completeness >= 0.75 and contamination <= 0.3."
    result = 0
    for contigs in binning:
        count = count_markers_saturated(contigs, markers)
        if count is None:
            continue
        comp, cont = get_completeness_contamination(count)
        if comp >= 0.75 and cont <= 0.3:
            result += 1
    return result


def group_indices_by_genus(taxonomy: Taxonomy) -> list[np.ndarray]:
    if not taxonomy.is_canonical:
        raise ValueError("Can only group by genus for a canonical taxonomy")
    by_genus: defaultdict[Optional[str], list[int]] = defaultdict(list)
    for i, tax in enumerate(taxonomy.contig_taxonomies):
        genus = None if tax is None else tax.genus
        by_genus[genus].append(i)
    return [np.array(i, dtype=np.int32) for i in by_genus.values()]
