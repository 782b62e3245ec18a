"""Profile-HMM search (the pyhmmer/hmmsearch role) on the CUDA card.

Port of `vamb_tpu/ops/hmm.py`: the host code (`read_hmms`, `format_hmm`,
`configure_local`, `encode_proteins`) is a copy with the same arrays, and
the Forward scan runs in the hand-written kernel `kernels.hmm_forward`
(one launch a profile and batch of genes) instead of a `lax.scan`. The
reference module's notes follow.

The reference scores predicted genes against single-copy-marker profile
HMMs with ``pyhmmer.hmmsearch`` and keeps hits above each profile's
trusted cutoff (reference vamb/parsemarkers.py:251-260).  This module is
a from-scratch equivalent:

* ``read_hmms`` parses the HMMER3 ASCII flat format (NAME/LENG/TC
  header, COMPO, per-node match/insert emission and transition lines,
  ``*`` = zero probability) into :class:`ProfileHMM` records.
* ``configure_local`` builds HMMER3's multihit-local search profile:
  occupancy-weighted local entry ``B->Mk``, unit local exit ``Mk->E``,
  ``E->{J,C}`` = 1/2, and the target-length model (loop ``L/(L+3)``,
  move ``3/(L+3)``); match emissions become log-odds against the
  standard amino-acid background, insert/N/C/J emissions score zero.
* ``forward_scores`` runs the full Forward algorithm over sequence
  positions, vectorized over the node axis (the in-row delete chain is a
  prefix log-sum-exp) and batched over sequences — one kernel launch
  scores a batch of genes against a profile instead of forking worker
  processes.

Scores are HMMER bit scores (log2-odds vs the null-1 length model).
Deviation from hmmsearch, documented: the ad-hoc null-2 biased
-composition correction is not applied, so scores for low-complexity
sequences run a few bits higher than HMMER's.  The DP itself is
verified against brute-force path enumeration in tests/test_hmm.py.
"""

from dataclasses import dataclass
from pathlib import Path
from typing import IO, Iterable, Sequence, Union

import numpy as np

AMINO = "ACDEFGHIKLMNPQRSTVWY"
_AA_INDEX = {c: i for i, c in enumerate(AMINO)}

# Standard Easel/HMMER amino-acid background frequencies
# (order ACDEFGHIKLMNPQRSTVWY).
BACKGROUND = np.array(
    [
        0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062,
        0.0695071, 0.0229198, 0.0590092, 0.0594422, 0.0963728,
        0.0237718, 0.0414386, 0.0482904, 0.0395639, 0.0540978,
        0.0683364, 0.0540687, 0.0673417, 0.0114135, 0.0304133,
    ],
    dtype=np.float64,
)

# transition column order in the HMMER3 flat file
_TRANS = ("mm", "mi", "md", "im", "ii", "dm", "dd")


@dataclass
class ProfileHMM:
    """One profile as stored in a HMMER3 flat file (probability space).

    ``match`` / ``insert`` are (M, 20) emission probabilities for nodes
    1..M; ``trans`` is (M+1, 7) probabilities in file column order with
    row 0 holding the begin-node transitions.  ``trusted_cutoff`` is the
    first TC field (full-sequence bits), None if absent.
    """

    name: str
    match: np.ndarray
    insert: np.ndarray
    trans: np.ndarray
    trusted_cutoff: Union[float, None]

    @property
    def m(self) -> int:
        return self.match.shape[0]


def _vals(fields: Sequence[str]) -> np.ndarray:
    return np.array(
        [np.inf if f == "*" else float(f) for f in fields], dtype=np.float64
    )


def read_hmms(src: Union[Path, str, IO[str]]) -> list[ProfileHMM]:
    "Parse every profile in a HMMER3 ASCII flat file."
    if isinstance(src, (Path, str)):
        import gzip

        opener = gzip.open if str(src).endswith(".gz") else open
        with opener(src, "rt") as file:
            return read_hmms(file)
    profiles = []
    line = src.readline()
    while line:
        if not line.startswith("HMMER3"):
            raise ValueError(f"Expected HMMER3 format header, got: {line!r}")
        name, length, cutoff = "", -1, None
        while True:
            line = src.readline()
            if not line:
                raise ValueError("Truncated HMM file")
            if line.startswith("NAME "):
                name = line.split(maxsplit=1)[1].strip()
            elif line.startswith("LENG "):
                length = int(line.split()[1])
            elif line.startswith("TC "):
                cutoff = float(line.split()[1].rstrip(";"))
            elif line.startswith("ALPH ") and line.split()[1].lower() != "amino":
                raise ValueError("Only amino-alphabet HMMs are supported")
            elif line.startswith("HMM "):
                break
        src.readline()  # transition-name header line
        # optional COMPO line (background composition; the standard
        # background is used instead) — branch on the tokens rather than
        # tell/seek so non-seekable streams (pipes) parse too
        first = src.readline().split()
        if first and first[0] == "COMPO":
            first = src.readline().split()
        insert0 = _vals(first[:20])
        trans0 = _vals(src.readline().split()[:7])
        match = np.empty((length, 20))
        insert = np.empty((length, 20))
        trans = np.empty((length + 1, 7))
        trans[0] = trans0
        del insert0  # node-0 inserts are irrelevant under the local config
        for k in range(1, length + 1):
            fields = src.readline().split()
            if not fields or int(fields[0]) != k:
                raise ValueError(f"Malformed node {k} in profile {name!r}")
            match[k - 1] = _vals(fields[1:21])
            insert[k - 1] = _vals(src.readline().split()[:20])
            trans[k] = _vals(src.readline().split()[:7])
        closer = src.readline()
        if not closer.startswith("//"):
            raise ValueError(f"Profile {name!r} not terminated by //")
        profiles.append(
            ProfileHMM(
                name=name,
                match=np.exp(-match),
                insert=np.exp(-insert),
                trans=np.exp(-trans),
                trusted_cutoff=cutoff,
            )
        )
        line = src.readline()
        while line and not line.strip():
            line = src.readline()
    return profiles


def format_hmm(p: ProfileHMM) -> str:
    "Render a profile back into HMMER3/f ASCII (for tests and tooling)."

    def row(v: np.ndarray) -> str:
        return "  ".join("*" if not x > 0 else f"{-np.log(x):.5f}" for x in v)

    lines = [
        "HMMER3/f [vamb_torch]",
        f"NAME  {p.name}",
        f"LENG  {p.m}",
        "ALPH  amino",
    ]
    if p.trusted_cutoff is not None:
        lines.append(f"TC    {p.trusted_cutoff:.2f} {p.trusted_cutoff:.2f};")
    lines.append("HMM   " + "  ".join(AMINO))
    lines.append("      " + "  ".join(_TRANS))
    lines.append("      " + row(BACKGROUND))  # insert-0 emissions
    lines.append("      " + row(p.trans[0]))
    for k in range(p.m):
        lines.append(f"{k + 1:>7} " + row(p.match[k]))
        lines.append("        " + row(p.insert[k]))
        lines.append("        " + row(p.trans[k + 1]))
    lines.append("//")
    return "\n".join(lines) + "\n"


@dataclass
class LocalProfile:
    """HMMER3 multihit-local search profile in log space (natural log).

    Emission scores are log-odds vs BACKGROUND; transition scores are
    log-probabilities.  ``t`` columns follow ``_TRANS`` order for the
    core nodes; ``tbm[k]`` is the occupancy-weighted local entry into
    match state k+1.  The length model (xn/xc/xj loop & move, and the
    null-1 correction) depends on the target length and is supplied at
    scoring time by :func:`forward_scores`.
    """

    name: str
    lom: np.ndarray  # (M, 20) match log-odds
    t: np.ndarray  # (M+1, 7) core log transitions
    tbm: np.ndarray  # (M,) local entry log-probs
    trusted_cutoff: Union[float, None]


def configure_local(p: ProfileHMM) -> LocalProfile:
    "Build the multihit-local search profile (HMMER3 modelconfig semantics)."
    with np.errstate(divide="ignore"):
        lom = np.log(p.match) - np.log(BACKGROUND)[None, :]
        t = np.log(p.trans)
    # Match-state occupancy, p7_hmm_CalculateOccupancy: how likely node k
    # is visited, given begin-state and core transitions.
    occ = np.zeros(p.m + 1)
    occ[1] = p.trans[0][0] + p.trans[0][1]  # B->M1 + B->I0
    for k in range(2, p.m + 1):
        tr = p.trans[k - 1]
        occ[k] = occ[k - 1] * (tr[0] + tr[1]) + (1.0 - occ[k - 1]) * tr[5]
    occ = occ[1:]
    z = float((occ * np.arange(p.m, 0, -1)).sum())
    with np.errstate(divide="ignore"):
        tbm = np.log(occ) - np.log(z)
    return LocalProfile(
        name=p.name, lom=lom, t=t, tbm=tbm, trusted_cutoff=p.trusted_cutoff
    )


# code point -> residue code (20, the null residue, outside the alphabet)
_CODE_OF = np.full(128, 20, dtype=np.int8)
for _c, _i in _AA_INDEX.items():
    _CODE_OF[ord(_c)] = _i


def encode_proteins(seqs: Iterable[str], pad_to: int) -> np.ndarray:
    """Encode proteins as int8 codes padded with 20 (the null residue).

    Residues outside the 20-letter alphabet (X, B, Z, ...) also map to
    the pad code: the DP skips them, matching HMMER's treatment of
    degenerate residues as (approximately) score-neutral. One vectorised
    lookup over the concatenated code points.
    """
    cut = [s[:pad_to] for s in seqs]
    out = np.full((len(cut), pad_to), 20, dtype=np.int8)
    lens = np.fromiter(map(len, cut), dtype=np.int64, count=len(cut))
    if lens.sum() == 0:
        return out
    points = np.frombuffer("".join(cut).encode("utf-32-le"), dtype=np.uint32)
    codes = np.where(points < 128, _CODE_OF[np.minimum(points, 127)], 20).astype(np.int8)
    rows = np.repeat(np.arange(len(cut)), lens)
    cols = np.arange(len(points)) - np.repeat(np.cumsum(lens) - lens, lens)
    out[rows, cols] = codes
    return out


class EncodedProteins:
    """Length-sorted, padded protein batches held as tensors on a device.

    Scoring the same gene set against many profiles (the marker pipeline
    scores ~100 single-copy profiles) would re-pay the per-residue encode,
    the length sort and the host->device upload on every call if the
    batches were rebuilt per profile — prepare once and pass this to
    :func:`forward_scores` instead. Each batch is (indices, codes (B, pad)
    int8, lengths (B,) float32 = min(len, pad), last non-null position + 1
    (B,) int32), with vamb_tpu's order and padding.
    """

    def __init__(self, proteins: Sequence[str], batch: int = 512, device="cuda"):
        import torch

        from ..device import resolve_device
        from ..kernels.hmm_kernels import last_residues

        self.device = resolve_device(device)
        self.n = len(proteins)
        self.batches: list[tuple[np.ndarray, object, object, object]] = []
        order = np.argsort([len(s) for s in proteins])
        for lo in range(0, self.n, batch):
            idx = order[lo : lo + batch]
            chunk = [proteins[i] for i in idx]
            pad = max(
                16, 1 << int(np.ceil(np.log2(max(len(s) for s in chunk) + 1)))
            )
            seqs = torch.as_tensor(encode_proteins(chunk, pad), device=self.device)
            lengths = torch.as_tensor(
                np.array([min(len(s), pad) for s in chunk], dtype=np.float32),
                device=self.device,
            )
            self.batches.append((idx, seqs, lengths, last_residues(seqs)))


def profile_tensors(profile: LocalProfile, device):
    """A local profile as `hmm_forward` takes it, on `device`: lom (M, 21)
    f32 (the 20 match log-odds and a zero column for the null residue), t
    and tbm f32 clamped at -1e30."""
    import torch

    m = profile.lom.shape[0]
    lom = np.zeros((m, 21), dtype=np.float32)
    lom[:, :20] = profile.lom
    return (torch.as_tensor(lom, device=device),
            torch.as_tensor(np.maximum(profile.t, -1e30).astype(np.float32), device=device),
            torch.as_tensor(np.maximum(profile.tbm, -1e30).astype(np.float32), device=device))


def forward_scores(
    profile: LocalProfile,
    proteins: Union[Sequence[str], EncodedProteins],
    batch: int = 512,
    device="cuda",
) -> np.ndarray:
    """HMMER bit scores of every protein against one local profile, on
    `device` (that of `proteins` when it is an EncodedProteins)."""
    import torch

    from ..kernels.hmm_kernels import hmm_forward

    if not isinstance(proteins, EncodedProteins):
        proteins = EncodedProteins(proteins, batch=batch, device=device)
    if proteins.n == 0:
        return np.empty(0, dtype=np.float32)
    lom, t, tbm = profile_tensors(profile, proteins.device)
    # the batches' scores stay on the device: one copy (and one sync) a profile
    scores = [hmm_forward(lom, t, tbm, seqs, lengths, nres)
              for _, seqs, lengths, nres in proteins.batches]
    out = np.empty(proteins.n, dtype=np.float32)
    out[np.concatenate([b[0] for b in proteins.batches])] = torch.cat(scores).cpu().numpy()
    return out
