"""Host layer of the port held against vamb_tpu: FASTA parsing, 4-mer
counting, the TNF projection, composition/abundance artifacts, cluster
TSVs, bin FASTAs, binsplit, hashing and array helpers.

Everything here is host numpy in both packages, so the tolerance is none:
arrays must be bit-identical and files byte-identical. A last test imports
the port in a fresh interpreter with jax blocked and no vamb_tpu on the
import path.
"""

import io
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import vamb_torch.abundance as t_abundance
import vamb_torch.composition as t_composition
import vamb_torch.utils as t_utils
from vamb_torch.utils import kmers as t_kmers
from vamb_torch.utils import arrays as t_arrays

import vamb_tpu.abundance as j_abundance
import vamb_tpu.composition as j_composition
import vamb_tpu.utils as j_utils
from vamb_tpu.utils import kmers as j_kmers

from . import make_golden

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_io_data")
    make_golden.write_synthetic_dataset(d)
    # a few short contigs so the min-length mask is exercised
    with open(d / "contigs.fna", "a") as f:
        f.write(">short1\nACGTACGTAC\n>short2 desc\nGGGCCCAAATTT\n")
    with open(d / "abundance.tsv", "a") as f:
        f.write("short1\t1\t2\t3\t4\nshort2\t1\t1\t1\t1\n")
    return d


@pytest.fixture(scope="module")
def compositions(data):
    out = []
    for mod in (j_composition, t_composition):
        with open(data / "contigs.fna", "rb") as f:
            out.append(mod.Composition.from_file(f, "contigs.fna", minlength=2000))
    return out


def _npz_arrays(path) -> dict:
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def _assert_same_arrays(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        if a[k].dtype == object:
            assert list(a[k].ravel()) == list(b[k].ravel()), k
        else:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_composition_npz_bit_identical(compositions, tmp_path):
    jc, tc = compositions
    assert tc.matrix.shape == (400, 103)
    jc.save(tmp_path / "j.npz")
    tc.save(tmp_path / "t.npz")
    _assert_same_arrays(_npz_arrays(tmp_path / "j.npz"), _npz_arrays(tmp_path / "t.npz"))
    assert tc.metadata.refhash == jc.metadata.refhash


def test_abundance_npz_bit_identical(compositions, data, tmp_path):
    jc, tc = compositions
    ja = j_abundance.Abundance.from_tsv(data / "abundance.tsv", jc.metadata)
    ta = t_abundance.Abundance.from_tsv(data / "abundance.tsv", tc.metadata)
    ja.save(tmp_path / "j.npz")
    ta.save(tmp_path / "t.npz")
    _assert_same_arrays(_npz_arrays(tmp_path / "j.npz"), _npz_arrays(tmp_path / "t.npz"))
    # and the port reads the artifact back with its refhash check
    back = t_abundance.Abundance.load(tmp_path / "j.npz", tc.metadata.refhash)
    assert back.matrix.tobytes() == ta.matrix.tobytes()


def test_composition_load_roundtrip(compositions, tmp_path):
    jc, _ = compositions
    jc.save(tmp_path / "j.npz")
    back = t_composition.Composition.load(tmp_path / "j.npz")
    back.filter_min_length(2900)
    ref = j_composition.Composition.load(tmp_path / "j.npz")
    ref.filter_min_length(2900)
    assert back.matrix.tobytes() == ref.matrix.tobytes()
    assert list(back.metadata.identifiers) == list(ref.metadata.identifiers)


def test_bam_input_fails_loudly():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_abundance.Abundance.from_files([], None, None, True, 0.0, 1)


@pytest.mark.parametrize(
    "seq",
    [b"", b"ACG", b"ACGTNACGTTTTGCA", b"acgtACGTuuuuNNNNacgtTGCA" * 7, b"A" * 999 + b"C"],
)
def test_kmercounts_identical(seq):
    assert np.array_equal(t_kmers.kmercounts(seq), j_kmers.kmercounts(seq))
    assert np.array_equal(t_kmers._kmercounts_numpy(seq), j_kmers._kmercounts_numpy(seq))


def test_kmercounts_batch_identical(data):
    with open(data / "contigs.fna", "rb") as f:
        seqs = [bytes(e.sequence) for e in t_utils.byte_iterfasta(f, None)]
    assert np.array_equal(t_kmers.kmercounts_batch(seqs), j_kmers.kmercounts_batch(seqs))


def test_fasta_reader_identical(data):
    with open(data / "contigs.fna", "rb") as f:
        t_entries = [(e.identifier, e.description, bytes(e.sequence))
                     for e in t_utils.byte_iterfasta(f, None)]
    with open(data / "contigs.fna", "rb") as f:
        j_entries = [(e.identifier, e.description, bytes(e.sequence))
                     for e in j_utils.byte_iterfasta(f, None)]
    assert t_entries == j_entries


def test_cluster_tsv_writer_identical():
    clusters = [("1", ["S1C1", "S2C5"]), ("2", ["S3C9"]), ("x3", ["a", "b", "c"])]
    outs = []
    for mod in (j_utils, t_utils):
        buf = io.StringIO()
        counts = mod.write_clusters(buf, clusters)
        outs.append((buf.getvalue(), counts))
    assert outs[0] == outs[1]
    back = t_utils.read_clusters(io.StringIO(outs[0][0]))
    assert back == {k: set(v) for k, v in clusters}


@pytest.mark.parametrize("compress", [False, True])
def test_write_bins_identical(data, tmp_path, compress):
    bins = [("b1", ["S1C0", "S2C1"]), ("b2", ["S3C2"])]
    for name, mod in (("j", j_utils), ("t", t_utils)):
        with open(data / "contigs.fna", "rb") as f:
            mod.write_bins(tmp_path / name, bins, f, compress)
    for binname, _ in bins:
        suffix = ".fna.gz" if compress else ".fna"
        j_bytes = (tmp_path / "j" / (binname + suffix)).read_bytes()
        t_bytes = (tmp_path / "t" / (binname + suffix)).read_bytes()
        if compress:
            import gzip

            j_bytes, t_bytes = gzip.decompress(j_bytes), gzip.decompress(t_bytes)
        assert j_bytes == t_bytes


@pytest.mark.parametrize("separator", [None, "C", ""])
def test_binsplit_identical(separator):
    clusters = [("1", ["S1C1", "S2C5", "S1C7"]), ("2", ["S3C9"])]
    outs = []
    for mod in (j_utils, t_utils):
        splitter = mod.BinSplitter(separator)
        splitter.initialize([c for _, members in clusters for c in members])
        outs.append(list(splitter.binsplit(clusters)))
    assert outs[0] == outs[1]


def test_array_helpers_identical():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(50, 7)).astype(np.float32)
    x[:, 3] = 2.0  # zero-spread column
    for axis in (None, 0, 1):
        assert np.array_equal(t_utils.zscore(x, axis=axis), j_utils.zscore(x, axis=axis))
    a, b = x.copy(), x.copy()
    t_utils.mask_lower_bits(a, 12)
    j_utils.mask_lower_bits(b, 12)
    assert a.tobytes() == b.tobytes()
    pa = t_arrays.PushArray(np.float32, start_capacity=3)
    pa.extend(x[0])
    pa.append(1.5)
    assert np.array_equal(pa.take(), np.append(x[0], np.float32(1.5)))
    names = ["S1C1", "S2C2", "x"]
    assert t_utils.RefHasher.hash_refnames(names) == j_utils.RefHasher.hash_refnames(names)


def test_import_without_jax_or_vamb_tpu(tmp_path):
    """A fresh interpreter with `jax` blocked and only vamb_torch on the
    path imports every port module; none pulls in jax or vamb_tpu."""
    shutil.copytree(
        REPO / "vamb_torch", tmp_path / "vamb_torch",
        ignore=shutil.ignore_patterns("_build", "*.so", "__pycache__"),
    )
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vamb_tpu'] = None\n"
        "import vamb_torch, vamb_torch.__main__, vamb_torch.pipeline, vamb_torch.cluster\n"
        "import vamb_torch.kernels, vamb_torch.models.vae, vamb_torch.utils.checkpoint\n"
        "import vamb_torch.utils.threefry, vamb_torch.abundance, vamb_torch.composition\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vamb_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "assert vamb_torch.__file__.startswith(sys.argv[1]), vamb_torch.__file__\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
