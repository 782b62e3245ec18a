"""The port's marker prediction held against vamb_tpu: the ORF caller, the
HMMER3 reader, the local profile, the protein encoding, the Forward scores
and `Markers` with the native backend, on numpy-seeded inputs.

Host code (ORFs, profiles, encoding, marker files) must be equal. The
Forward scores are float32 log-sum-exp recurrences whose `exp`/`log1p` and
summation orders differ between XLA and torch, so they are held within
|a - b| <= TOL_ABS + TOL_REL * |a| bits. Measured on these fixtures, the
plain version (`hmm_forward_plain`, on the CPU) differs from vamb_tpu's
`forward_scores` by at most 4.8e-6 bits (the M = 60 case; 1.9e-6 at
M = 150), so the tolerance is 5e-5 + 1e-6 * |score|, ten times that; the
card's kernel is held to its plain version in tests/test_torch_cuda.py and
chip_smoke.py. A marker decision (score >= trusted cutoff) must agree for
every gene whose score lies outside that tolerance of its cutoff; the
genes inside it are counted.
"""

import gzip
import io

import numpy as np
import pytest
import torch

from vamb_torch import markers as t_markers
from vamb_torch.kernels import hmm_forward, hmm_forward_plain
from vamb_torch.ops import hmm as T
from vamb_torch.ops import orf as t_orf

from vamb_tpu import markers as j_markers
from vamb_tpu.ops import hmm as J
from vamb_tpu.ops import orf as j_orf

from .test_hmm import PROT, encode_gene, peptide_profile, random_profile
from .test_marker_fidelity import (
    AA,
    N_GENOMES,
    N_MARKERS,
    PROT_LEN,
    _encode_gene,
    _profile_from_consensus,
    _revcomp,
    _sample_variant,
)

TOL_ABS, TOL_REL = 5e-5, 1e-6
AAS = "ACDEFGHIKLMNPQRSTVWY"


def within(a, b) -> np.ndarray:
    return np.abs(np.asarray(a, np.float64) - b) <= TOL_ABS + TOL_REL * np.abs(a)


# ------------------------------------------------------------------- ORFs


def random_contig(rng, n: int, planted: int) -> bytes:
    "Random DNA with `planted` genes on both strands and a few ambiguous bases."
    parts = []
    for g in range(planted):
        parts.append("".join(rng.choice(list("ACGT"), size=int(rng.integers(20, 300)))))
        gene = encode_gene(PROT[: int(rng.integers(30, len(PROT) + 1))]).decode()
        parts.append(gene if g % 2 else _revcomp(gene.encode()).decode())
    parts.append("".join(rng.choice(list("ACGTN"), size=n, p=[0.24, 0.26, 0.26, 0.23, 0.01])))
    return "".join(parts).encode()


@pytest.mark.parametrize("seed", range(6))
def test_find_genes_identical(seed):
    rng = np.random.default_rng(seed)
    contig = random_contig(rng, int(rng.integers(500, 5000)), planted=seed % 3)
    for seq in (contig, contig.lower(), contig[: len(contig) // 3]):
        for min_len in (90, 30, 300):
            got = t_orf.find_genes(seq, min_len)
            assert got == j_orf.find_genes(seq, min_len)
    assert t_orf.find_genes(b"") == j_orf.find_genes(b"") == []


# --------------------------------------------------------------- profiles


def profiles_text(rng) -> str:
    profs = [random_profile(rng, m, f"p{m}") for m in (1, 3, 17, 64)]
    profs.append(peptide_profile(PROT, "TIGR00388", 12.5))
    profs[1].trusted_cutoff = None
    return "".join(J.format_hmm(p) for p in profs)


@pytest.mark.parametrize("gz", [False, True])
def test_read_hmms_and_configure_local_identical(tmp_path, gz):
    text = profiles_text(np.random.default_rng(1))
    path = tmp_path / ("p.hmm.gz" if gz else "p.hmm")
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    got, want = T.read_hmms(path), J.read_hmms(path)
    assert [p.name for p in got] == [p.name for p in want]
    for a, b in zip(got, want):
        assert a.trusted_cutoff == b.trusted_cutoff
        for key in ("match", "insert", "trans"):
            assert np.array_equal(getattr(a, key), getattr(b, key))
        la, lb = T.configure_local(a), J.configure_local(b)
        for key in ("lom", "t", "tbm"):
            assert np.array_equal(getattr(la, key), getattr(lb, key))
    # the port's writer reads back into the same profiles
    again = T.read_hmms(io.StringIO("".join(T.format_hmm(p) for p in got)))
    for a, b in zip(again, got):
        assert np.allclose(a.match, b.match, atol=1e-5) and a.name == b.name
    assert t_markers.read_hmm_names(path) == j_markers.read_hmm_names(path)


def test_encode_proteins_identical():
    rng = np.random.default_rng(2)
    seqs = ["".join(rng.choice(list(AAS + "XBZ*u"), size=int(n)))
            for n in rng.integers(0, 70, 40)] + ["", "é€Aµ", "MKV"]
    for pad in (16, 64, 128):
        assert np.array_equal(T.encode_proteins(seqs, pad), J.encode_proteins(seqs, pad))
    assert T.encode_proteins([], 16).shape == (0, 16)


# ---------------------------------------------------------- Forward scores


def random_genes(rng, lengths, null_frac: float = 0.05) -> list[str]:
    "Proteins with null residues (X, B, U) mid-sequence."
    out = []
    for n in lengths:
        s = rng.choice(list(AAS), size=int(n))
        s[rng.random(int(n)) < null_frac] = "X"
        if n > 4:
            s[int(n) // 2] = "B"
        out.append("".join(s))
    return out


@pytest.mark.parametrize("m", [1, 2, 5, 24, 60, 150])
def test_forward_plain_matches_vamb_tpu(m):
    rng = np.random.default_rng(m)
    prof = random_profile(rng, m)
    genes = random_genes(rng, [1, 2, 7, 16, 33, 90, 200, 5, 61])
    # several batches of other pads
    want = J.forward_scores(J.configure_local(prof), genes, batch=4)
    got = T.forward_scores(T.configure_local(prof), genes, batch=4, device="cpu")
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert within(want, got).all(), np.abs(want - got).max()


def test_forward_plain_is_the_kernel_contract():
    """`hmm_forward` on CPU tensors is `hmm_forward_plain`; padding past a
    gene and null residues anywhere leave its score unchanged."""
    rng = np.random.default_rng(7)
    local = T.configure_local(random_profile(rng, 12))
    lom = torch.zeros(12, 21)
    lom[:, :20] = torch.as_tensor(local.lom, dtype=torch.float32)
    t = torch.as_tensor(np.maximum(local.t, -1e30), dtype=torch.float32)
    tbm = torch.as_tensor(np.maximum(local.tbm, -1e30), dtype=torch.float32)
    genes = random_genes(rng, [9, 30, 31])
    codes = torch.as_tensor(T.encode_proteins(genes, 64))
    lengths = torch.tensor([9.0, 30.0, 31.0])
    base = hmm_forward(lom, t, tbm, codes, lengths)
    assert torch.equal(base, hmm_forward_plain(lom, t, tbm, codes, lengths))
    wide = torch.full((3, 128), 20, dtype=torch.int8)
    wide[:, :64] = codes
    assert torch.equal(hmm_forward(lom, t, tbm, wide, lengths), base)
    with pytest.raises(ValueError, match="int8"):
        hmm_forward(lom, t, tbm, codes.long(), lengths)
    with pytest.raises(ValueError, match="21"):
        hmm_forward(lom[:, :20], t, tbm, codes, lengths)


# ------------------------------------------------------------------ markers


@pytest.fixture(scope="module")
def fidelity_files(tmp_path_factory):
    """tests/test_marker_fidelity.py's experiment, rebuilt step for step
    from its seed (profiles, cutoffs calibrated by vamb_tpu, planted
    contigs) and written to files both packages read."""
    rng = np.random.default_rng(42)
    workdir = tmp_path_factory.mktemp("torch_fidelity")
    consensi = ["M" + "".join(AA[i] for i in rng.integers(0, 20, PROT_LEN - 1))
                for _ in range(N_MARKERS)]
    names = [f"TIGR9{i:04d}" for i in range(N_MARKERS)]
    profiles = [_profile_from_consensus(c, n) for c, n in zip(consensi, names)]
    for prof, cons in zip(profiles, consensi):
        local = J.configure_local(prof)
        true_scores = J.forward_scores(local, [_sample_variant(rng, cons) for _ in range(16)])
        [rng.integers(0, 20, PROT_LEN - 1) for _ in range(16)]  # the background draws
        prof.trusted_cutoff = float(true_scores.min()) - 0.5
    hmm_path = workdir / "markers.hmm"
    hmm_path.write_text("".join(J.format_hmm(p) for p in profiles))

    def flank(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    contig_names, fasta_lines = [], []
    for g in range(N_GENOMES):
        for m in range(N_MARKERS):
            gene = _encode_gene(_sample_variant(rng, consensi[m]))
            if (g + m) % 2:
                gene = _revcomp(gene.encode()).decode()
            contig_names.append(f"G{g}M{m}")
            fasta_lines.append(f">G{g}M{m}\n{flank(120) + 'TAA' + gene + flank(120)}\n")
    for i in range(16):
        contig_names.append(f"noise{i}")
        fasta_lines.append(f">noise{i}\n{flank(400)}\n")
    fasta = workdir / "contigs.fna"
    fasta.write_text("".join(fasta_lines))
    return workdir, fasta, hmm_path, contig_names


def _as_lists(markers):
    return [None if m is None else m.tolist() for m in markers.markers]


def test_native_backend_markers_identical(fidelity_files):
    workdir, fasta, hmm_path, names = fidelity_files
    got = t_markers.Markers.from_files(fasta, hmm_path, names, workdir / "t_tmp", 2, None,
                                       backend=t_markers.NativeBackend("cpu"))
    want = j_markers.Markers.from_files(fasta, hmm_path, names, workdir / "j_tmp", 2, None,
                                        backend=j_markers.NativeBackend())
    assert got.marker_names == want.marker_names
    assert got.refhash == want.refhash
    assert _as_lists(got) == _as_lists(want)
    assert sum(m is not None for m in got.markers) >= 0.9 * N_GENOMES * N_MARKERS

    # every gene's decision against every profile, and the genes whose score
    # lies within the tolerance of the cutoff (decided either way)
    proteins = [p for rec in fasta.read_text().split(">")[1:]
                for p in t_orf.find_genes(rec.split("\n")[1].encode())]
    near = 0
    for prof in T.read_hmms(hmm_path):
        a = J.forward_scores(J.configure_local(prof), proteins)
        b = T.forward_scores(T.configure_local(prof), proteins, device="cpu")
        assert within(a, b).all()
        band = ~within(a, np.full_like(a, prof.trusted_cutoff))
        assert np.array_equal((a >= prof.trusted_cutoff)[band], (b >= prof.trusted_cutoff)[band])
        near += int((~band).sum())
    print(f"\n[torch native backend] {len(proteins)} genes x {N_MARKERS} profiles, "
          f"{near} scores within the tolerance of their cutoff")


def test_markers_files_load_across_packages(tmp_path):
    refhash = b"\x01" * 16
    marks = [np.array([0, 2], np.uint8), None, np.array([1], np.uint8)]
    for mine, other in ((t_markers, j_markers), (j_markers, t_markers)):
        path = tmp_path / f"{mine.__name__}.npz"
        mine.Markers(marks, [["A"], ["B", "C"], ["D"]], refhash).save(path)
        back = other.Markers.load(path, refhash)
        assert back.marker_names == [["A"], ["B", "C"], ["D"]]
        assert [None if m is None else m.tolist() for m in back.markers] == [[0, 2], None, [1]]
        assert back.score_bin([0, 2]) == mine.Markers.load(path, None).score_bin([0, 2])
        with pytest.raises(BaseException):
            other.Markers.load(path, b"\x02" * 16)


def test_marker_helpers_identical(tmp_path, fidelity_files):
    names = ["TIGR00389", "TIGR00388", "PF0001", "TIGR02386", "X"]
    assert t_markers.get_name_to_id(names) == j_markers.get_name_to_id(names)
    tbl = ["# comment", "c1_1 - TIGR00388 - 1e-20 50.0", "", "c2_3 - PF0001 - 1 2",
           "c1_2 - unknown - 1 2", "c_x_4 - X - 1 2"]
    ids = t_markers.get_name_to_id(names)[0]
    assert t_markers.parse_hmmsearch_tblout(tbl, ids) == j_markers.parse_hmmsearch_tblout(tbl, ids)
    _, fasta, _, contig_names = fidelity_files
    keep = contig_names[::3]
    got = t_markers.split_file(fasta, keep, tmp_path / "t", 3)
    want = j_markers.split_file(fasta, keep, tmp_path / "j", 3)
    assert got[0] == want[0]
    assert [p.read_bytes() for p in got[1]] == [p.read_bytes() for p in want[1]]
    with pytest.raises(ValueError, match="at least 1"):
        t_markers.cap_processes(0)


def test_select_backend_is_vamb_tpu_s_choice(monkeypatch):
    "Without pyhmmer and without prodigal/hmmsearch, both pick the native backend."
    import shutil

    monkeypatch.setitem(__import__("sys").modules, "pyhmmer", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    backend = t_markers.select_backend("cpu")
    assert isinstance(backend, t_markers.NativeBackend) and backend.device == "cpu"
    assert isinstance(j_markers.select_backend(), j_markers.NativeBackend)
    monkeypatch.setattr(shutil, "which", lambda name: f"/bin/{name}")
    assert isinstance(t_markers.select_backend("cpu"), t_markers.SubprocessBackend)
