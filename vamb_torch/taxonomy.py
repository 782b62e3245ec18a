"""Contig taxonomy tables, the parts `recluster` reads.

Port of `vamb_tpu/taxonomy.py`: `ContigTaxonomy`, `Taxonomy` (`from_file`,
`from_refined_file`) and `PredictedTaxonomy` (Taxometer's scored output:
`parse_tax_file`, `to_taxonomy`, `write_as_tsv`), for the reference's two
formats:

* plain taxonomy TSV — header ``contigs<TAB>predictions``, one row per
  contig mapping its name to a semicolon-joined lineage (empty allowed);
* refined taxonomy TSV (what Taxometer emits) — header
  ``contigs<TAB>predictions<TAB>scores`` with a third semicolon-joined
  per-rank confidence column.

Where `vamb_tpu` departs from upstream Vamb (vamb/taxonomy.py), the port
keeps upstream's semantics:

* a refined row is right-stripped before it is split, so the row
  ``name\t\t`` that Taxometer writes for an unassigned contig is read as
  unassigned (`vamb_tpu` reaches ``float('')`` on it), and blank lines are
  skipped;
* a blank line in the plain format is an error (`vamb_tpu` skips it).

A *canonical* lineage uses the seven Linnean ranks domain, phylum, class,
order, family, genus, species — possibly cut short, never longer. Whatever
the rank scheme, the union of all lineages must form a tree when keyed by
name: the same name may not occur at two depths, nor under two different
parents (reference taxonomy.py:264-294).
"""

from pathlib import Path
from typing import IO, Iterator, Optional

import numpy as np

from .composition import CompositionMetaData

TAXONOMY_HEADER = "contigs\tpredictions"
PREDICTED_TAXONOMY_HEADER = "contigs\tpredictions\tscores"

# Depth of each canonical rank, 0-based; genus is the 6th of 7.
CANONICAL_RANK_COUNT = 7
GENUS_DEPTH = 5


def _tsv_rows(
    path: Path, expected_header: str, refined: bool
) -> Iterator[tuple[int, list[str]]]:
    """Stream ``(line_number, fields)`` from a headered TSV, with 1-based
    line numbers so parse errors point at the file.

    The plain format strips only the newline, so a blank line arrives as
    one empty field (and fails the caller's column count); the refined
    format right-strips all whitespace and skips blank lines, as upstream
    Vamb's ``filter(None, map(str.rstrip, file))`` does.
    """
    with open(path) as handle:
        first = next(handle, None)
        got = None if first is None else first.rstrip("\r\n")
        if got != expected_header:
            shown = "no header at all" if got is None else repr(got)
            raise ValueError(
                f"Taxonomy file '{path}': expected header line "
                f"{expected_header!r}; file has {shown}"
            )
        for lineno, raw in enumerate(handle, start=2):
            stripped = raw.rstrip() if refined else raw.rstrip("\r\n")
            if refined and not stripped:
                continue
            yield lineno, stripped.split("\t")


class ContigTaxonomy:
    """The lineage of a single contig, outermost rank first.

    ``is_canonical`` promises the seven-rank Linnean scheme (see module
    docstring); such a lineage may stop early but never exceeds 7 entries.
    """

    __slots__ = ["ranks"]

    def __init__(self, ranks: list[str], is_canonical: bool = False):
        if is_canonical and len(ranks) > CANONICAL_RANK_COUNT:
            raise ValueError(
                f"A canonical lineage has at most 7 ranks (domain..species); "
                f"got {len(ranks)}"
            )
        self.ranks = ranks

    @classmethod
    def from_semicolon_sep(cls, s: str, is_canonical: bool = False):
        "Parse a ``;``-joined lineage string; empty string = empty lineage."
        return cls(s.split(";") if s else [], is_canonical)

    def rank_at(self, depth: int) -> Optional[str]:
        "Name at 0-based `depth`, or None when the lineage stops earlier."
        return self.ranks[depth] if depth < len(self.ranks) else None

    @property
    def genus(self) -> Optional[str]:
        "Canonical genus (depth 5), when the lineage reaches it."
        return self.rank_at(GENUS_DEPTH)

    def __eq__(self, other) -> bool:
        return isinstance(other, ContigTaxonomy) and self.ranks == other.ranks

    def __repr__(self) -> str:
        return f"ContigTaxonomy({';'.join(self.ranks)!r})"


class Taxonomy:
    """Per-contig lineages aligned to a CompositionMetaData.

    ``contig_taxonomies[i]`` belongs to ``metadata.identifiers[i]``; entries
    may be None for contigs the source file left unassigned. The refhash
    ties the table to the composition it was parsed against.
    """

    __slots__ = ["contig_taxonomies", "refhash", "is_canonical"]

    def __init__(
        self,
        contig_taxonomies: list[Optional[ContigTaxonomy]],
        refhash: bytes,
        is_canonical: bool,
    ):
        self.contig_taxonomies = contig_taxonomies
        self.refhash = refhash
        self.is_canonical = is_canonical
        assert_unambiguous_ranks(self)

    @property
    def nseqs(self) -> int:
        return len(self.contig_taxonomies)

    @classmethod
    def from_file(cls, tax_file: Path, metadata: CompositionMetaData, is_canonical: bool):
        "Load a plain 2-column taxonomy TSV and align it to `metadata`."
        observed = cls.parse_tax_file(tax_file, is_canonical)
        return cls.from_observed(observed, metadata, is_canonical)

    @classmethod
    def from_refined_file(
        cls, tax_file: Path, metadata: CompositionMetaData, is_canonical: bool
    ):
        "Load a 3-column Taxometer TSV, discarding the confidence column."
        scored = PredictedTaxonomy.parse_tax_file(tax_file, is_canonical)
        return cls.from_observed(
            [(name, pred.contig_taxonomy) for (name, pred) in scored],
            metadata,
            is_canonical,
        )

    @classmethod
    def from_observed(
        cls,
        observed_taxonomies: list[tuple[str, ContigTaxonomy]],
        metadata: CompositionMetaData,
        is_canonical: bool,
    ):
        """Align parsed ``(name, lineage)`` pairs to the metadata's contig
        order. File rows for unknown names (e.g. contigs dropped by the
        length filter) are skipped; every kept contig must be covered
        exactly once."""
        keep = {name: i for (i, name) in enumerate(metadata.identifiers)}
        by_index: dict[int, ContigTaxonomy] = {}
        for contigname, lineage in observed_taxonomies:
            where = keep.get(contigname)
            if where is None:
                continue
            if where in by_index:
                raise ValueError(
                    f'Duplicate row for contig "{contigname}" in taxonomy file'
                )
            by_index[where] = lineage
        if len(by_index) != metadata.nseqs:
            raise ValueError(
                f"Taxonomy file covered {len(by_index)} of the composition's "
                f"kept contigs; expected {metadata.nseqs} contigs to be "
                "covered. (Rows for length-filtered contigs are ignored, but "
                "every kept contig needs one.)"
            )
        aligned = [by_index.get(i) for i in range(metadata.nseqs)]
        return cls(aligned, metadata.refhash, is_canonical)

    @staticmethod
    def parse_tax_file(
        path: Path, force_canonical: bool
    ) -> list[tuple[str, ContigTaxonomy]]:
        "Parse the 2-column format into ``(name, lineage)`` pairs, file order."
        out: list[tuple[str, ContigTaxonomy]] = []
        for lineno, fields in _tsv_rows(path, TAXONOMY_HEADER, refined=False):
            if len(fields) != 2:
                raise ValueError(
                    f"Taxonomy file '{path}' line {lineno}: need exactly 2 "
                    f"tab-separated columns, found {len(fields)}"
                )
            out.append(
                (fields[0], ContigTaxonomy.from_semicolon_sep(fields[1], force_canonical))
            )
        return out


class PredictedContigTaxonomy:
    "A lineage plus one confidence score per rank (clamped into [0, 1])."

    __slots__ = ["contig_taxonomy", "probs"]

    def __init__(self, tax: ContigTaxonomy, probs: np.ndarray):
        if len(probs) != len(tax.ranks):
            raise ValueError(
                f"Need one score per rank: {len(tax.ranks)} ranks vs "
                f"{len(probs)} scores"
            )
        np.clip(probs, a_min=0.0, a_max=1.0, out=probs)
        self.contig_taxonomy = tax
        self.probs = probs


class PredictedTaxonomy:
    "A Taxometer prediction: scored lineages in composition order."

    __slots__ = ["contig_taxonomies", "refhash", "is_canonical"]

    def __init__(
        self,
        taxonomies: list[PredictedContigTaxonomy],
        metadata: CompositionMetaData,
        is_canonical: bool,
    ):
        if len(taxonomies) != len(metadata.identifiers):
            raise ValueError(
                f"Got {len(taxonomies)} predictions for "
                f"{len(metadata.identifiers)} contigs; the lists must align "
                "1:1 with the composition"
            )
        self.contig_taxonomies = taxonomies
        self.refhash = metadata.refhash
        self.is_canonical = is_canonical
        assert_unambiguous_ranks(self)

    @property
    def nseqs(self) -> int:
        return len(self.contig_taxonomies)

    def to_taxonomy(self) -> Taxonomy:
        "Drop the scores, keeping lineages, refhash and canonicality."
        return Taxonomy(
            [pred.contig_taxonomy for pred in self.contig_taxonomies],
            self.refhash,
            self.is_canonical,
        )

    def write_as_tsv(self, file: IO[str], comp_metadata: CompositionMetaData) -> None:
        """Write the refined format, scores rounded to 5 decimals. An
        unassigned contig is the row ``name\t\t``, which `parse_tax_file`
        reads back as unassigned."""
        if self.refhash != comp_metadata.refhash:
            raise ValueError(
                "Cannot write predictions against a different composition: "
                "refhashes disagree"
            )
        assert self.nseqs == comp_metadata.nseqs
        print(PREDICTED_TAXONOMY_HEADER, file=file)
        for name, pred in zip(comp_metadata.identifiers, self.contig_taxonomies):
            print(
                name,
                ";".join(pred.contig_taxonomy.ranks),
                # np.round and str() of its elements: the strings of
                # str(round(p, 5)) for each numpy scalar p, at a tenth of the cost
                ";".join(np.round(pred.probs, 5).astype(str).tolist()),
                file=file,
                sep="\t",
            )

    @staticmethod
    def parse_tax_file(
        path: Path, force_canonical: bool
    ) -> list[tuple[str, PredictedContigTaxonomy]]:
        """Parse the 3-column refined format. A row carrying only a name
        (after right-stripping, as upstream Vamb reads ``name\\t\\t``) is
        read as an unassigned contig (empty lineage, no scores)."""
        out: list[tuple[str, PredictedContigTaxonomy]] = []
        for lineno, fields in _tsv_rows(path, PREDICTED_TAXONOMY_HEADER, refined=True):
            if len(fields) == 1:
                empty = PredictedContigTaxonomy(
                    ContigTaxonomy([], force_canonical), np.array([])
                )
                out.append((fields[0], empty))
                continue
            if len(fields) != 3:
                raise ValueError(
                    f"Refined taxonomy file '{path}' line {lineno}: need 1 or "
                    f"3 tab-separated columns, found {len(fields)}"
                )
            name, lineage_str, scores_str = fields
            lineage = ContigTaxonomy.from_semicolon_sep(lineage_str, force_canonical)
            scores = np.array([float(x) for x in scores_str.split(";")], dtype=float)
            out.append((name, PredictedContigTaxonomy(lineage, scores)))
        return out


def assert_unambiguous_ranks(taxonomy) -> None:
    """Verify the union of lineages is a tree keyed by name.

    One map carries everything we know about each name — its depth and its
    parent (None at the top rank). A second sighting with a different depth
    or parent is the ambiguity the models cannot represent.
    """
    known: dict[str, tuple[int, Optional[str]]] = {}
    for entry in taxonomy.contig_taxonomies:
        if entry is None:
            continue
        ranks = entry.ranks if isinstance(entry, ContigTaxonomy) else entry.contig_taxonomy.ranks
        above: Optional[str] = None
        for depth, name in enumerate(ranks):
            fact = (depth, above)
            prior = known.setdefault(name, fact)
            if prior[0] != depth:
                raise ValueError(
                    f'Ambiguous taxonomy: name "{name}" occurs at multiple ranks'
                )
            if prior[1] != above:
                raise ValueError(
                    f'Ambiguous taxonomy: name "{name}" occurs under multiple parents'
                )
            above = name
