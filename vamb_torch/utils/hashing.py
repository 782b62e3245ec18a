"""Identifier ref-hashing: the pipeline's input-integrity mechanism.

An md5 over the ordered sequence identifiers couples every artifact
(composition, abundance, taxonomy, markers) to the exact FASTA input; any
mismatch fails fast with a first-difference diagnostic
(reference vamb/vambtools.py:521-599).
"""

from hashlib import md5
from itertools import zip_longest
from typing import Iterable, Optional


class RefHasher:
    __slots__ = ["hasher"]

    def __init__(self):
        self.hasher = md5()

    def add_refname(self, ref: str) -> None:
        self.hasher.update(ref.encode().rstrip())

    def add_refnames(self, refs: Iterable[str]):
        for ref in refs:
            self.add_refname(ref)
        return self

    @classmethod
    def hash_refnames(cls, refs: Iterable[str]) -> bytes:
        return cls().add_refnames(refs).digest()

    def digest(self) -> bytes:
        return self.hasher.digest()

    @staticmethod
    def verify_refhash(
        refhash: bytes,
        target_refhash: bytes,
        observed_name: Optional[str],
        target_name: Optional[str],
        identifiers: Optional[tuple[Iterable[str], Iterable[str]]],
    ) -> None:
        """Raise ValueError with a precise diagnostic if the hashes differ.

        When the identifier iterables are provided, the error pinpoints the
        first position where they diverge (extra, missing, or mismatched).
        """
        if refhash == target_refhash:
            return None

        obs_name = "observed" if observed_name is None else observed_name
        tgt_name = "target" if target_name is None else target_name

        message = (
            f"Mismatch between sequence identifiers (names) in {obs_name} and {tgt_name}.\n"
            f"Observed {obs_name} identifier hash: {refhash.hex()}.\n"
            f"Expected {tgt_name} identifier hash: {target_refhash.hex()}\n"
            f"Make sure all identifiers in {obs_name} and {tgt_name} are identical "
            "and in the same order. "
            "Note that the identifier is the header before any whitespace."
        )

        if identifiers is not None:
            (observed_ids, target_ids) = identifiers
            for i, (observed_id, target_id) in enumerate(
                zip_longest(observed_ids, target_ids)
            ):
                if observed_id is None:
                    message += (
                        f"\nIdentifier mismatch: {obs_name} has only "
                        f"{i} identifier(s), which is fewer than {tgt_name}"
                    )
                    raise ValueError(message)
                elif target_id is None:
                    message += (
                        f"\nIdentifier mismatch: {tgt_name} has only "
                        f"{i} identifier(s), which is fewer than {obs_name}"
                    )
                    raise ValueError(message)
                elif observed_id != target_id:
                    message += (
                        f"\nIdentifier mismatch: Identifier number {i + 1} does not match "
                        f"between {obs_name} and {tgt_name}:"
                        f'{obs_name}: "{observed_id}"'
                        f'{tgt_name}: "{target_id}"'
                    )
                    raise ValueError(message)
            raise AssertionError("unreachable: hashes differ but identifiers equal")
        else:
            raise ValueError(message)
