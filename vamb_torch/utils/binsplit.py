"""Split clusters by sample of origin.

In the multi-sample workflow, contigs from every sample are concatenated
into one catalogue with identifiers of the form ``<sample><sep><contig>``
(``S1C19`` with the conventional separator ``C``). Because the same genome
assembles independently in each sample, a cross-sample cluster is really
one bin *per sample* — splitting it by the identifier prefix yields purer
bins for free. Role parity with the reference's BinSplitter
(vamb/vambtools.py:27-188): same modes, same separator default, same
validation rules.

Modes (selected by the constructor argument):

* ``None`` — opportunistic default: use ``"C"`` if every identifier has a
  valid prefix/suffix around it, otherwise log a warning once and carry on
  unsplit.
* a non-empty string — strict: every identifier must contain the separator
  with non-empty text on both sides, or initialization raises.
* ``""`` — splitting deliberately off.

Unlike the reference, split bins preserve deterministic member order (first
appearance within the cluster): downstream TSVs are compared byte-for-byte
in the golden parity suite, so hash-ordered sets are not acceptable here.
"""

import logging
import time
from typing import Iterable, Optional

logger = logging.getLogger("vamb_torch")

DEFAULT_SEPARATOR = "C"

_BAD_IDENTIFIER_HELP = (
    'Binsplit separator (option `-o`) {how} passed as "{sep}", '
    'but sequence identifier "{ident}" does not contain this separator, '
    "or contains it at the very start or end.\n"
    "A binsplit separator X implies that every sequence identifier is formatted as\n"
    "[sample identifier][X][sequence identifier], e.g. a binsplit separator of 'C' "
    "means that 'S1C19' and '7C11' are valid identifiers.\n"
)


def _prefix_of(identifier: str, separator: str) -> Optional[str]:
    "Sample prefix of `identifier`, or None if the separator placement is invalid."
    head, found, tail = identifier.partition(separator)
    if not found or not head or not tail:
        return None
    return head


class BinSplitter:
    __slots__ = ["is_default", "splitter", "is_initialized"]

    def __init__(self, binsplitter: Optional[str]):
        self.is_default = binsplitter is None
        if binsplitter is None:
            self.splitter: Optional[str] = DEFAULT_SEPARATOR
        else:
            self.splitter = binsplitter or None
        self.is_initialized = False

    def is_disabled(self) -> bool:
        return self.splitter is None

    def initialize(self, identifiers: Iterable[str]) -> None:
        "Check the separator against every identifier; see the module doc."
        if self.is_initialized:
            return
        self.is_initialized = True
        sep = self.splitter
        if sep is None:
            return
        for identifier in identifiers:
            if _prefix_of(identifier, sep) is not None:
                continue
            if self.is_default:
                logger.warning(
                    _BAD_IDENTIFIER_HELP.format(
                        how="implicitly", sep=sep, ident=identifier
                    )
                    + "\nSkipping binsplitting."
                )
                self.splitter = None
                return
            msg = _BAD_IDENTIFIER_HELP.format(
                how="explicitly", sep=sep, ident=identifier
            )
            logger.error(msg)
            raise ValueError(msg)

    def split_bin(
        self, binname: str, identifiers: Iterable[str]
    ) -> Iterable[tuple[str, list[str]]]:
        """Yield `(split_name, members)` per sample prefix, in order of first
        appearance; members keep their within-cluster order."""
        if self.splitter is None:
            yield (binname, list(identifiers))
            return
        by_sample: dict[str, list[str]] = {}
        for identifier in identifiers:
            sample = _prefix_of(identifier, self.splitter)
            if sample is None:
                raise KeyError(
                    f"Separator '{self.splitter}' not in sequence identifier, "
                    "or is at the very start or end of identifier: "
                    f"'{identifier}'"
                )
            by_sample.setdefault(sample, []).append(identifier)
        for sample, members in by_sample.items():
            yield f"{sample}{self.splitter}{binname}", members

    def binsplit(
        self, clusters: Iterable[tuple[str, Iterable[str]]]
    ) -> Iterable[tuple[str, list[str]]]:
        "Lazily apply `split_bin` to a stream of clusters."
        for binname, identifiers in clusters:
            yield from self.split_bin(binname, identifiers)

    def log_string(self) -> str:
        "Human-readable description of the active mode, for the run log."
        if not self.is_default:
            if self.is_disabled():
                return "Explicitly passed as empty (no binsplitting)"
            return f'"{self.splitter}"'
        if self.is_disabled():
            return "Defaulting to 'C', but disabled due to incompatible identifiers"
        return "Defaulting to 'C'"

    def log_clustering_result(
        self,
        n_total_contigs: int,
        n_split_clusters: int,
        n_unsplit_clusters: int,
        start_time: float,
    ) -> None:
        if self.is_disabled():
            logger.info(
                f"\tClustered {n_total_contigs} contigs in "
                f"{n_unsplit_clusters} unsplit bins"
            )
        else:
            logger.info(
                f"\tClustered {n_total_contigs} contigs in {n_split_clusters} "
                f"split bins ({n_unsplit_clusters} clusters)"
            )
        logger.info(
            f"\tWrote cluster file(s) in {round(time.time() - start_time, 2)} seconds."
        )
