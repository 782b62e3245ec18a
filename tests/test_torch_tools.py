"""The workflow tools of the port, held against the repo's src/ scripts and
vamb_tpu on the CPU.

* `python -m vamb_torch.tools.concatenate` against `src/concatenate.py`, both
  run as subprocesses on the same sample FASTAs: the catalogue byte for
  byte after gunzip (gzip headers carry a time), with the `S{n}C` rename,
  `--keepnames`, `-m` and `--nozip`; and the duplicate-identifier,
  existing-output and missing-input errors raised alike (the same exception
  line on stderr, a non-zero exit).
* `python -m vamb_torch.tools.create_fasta` against `src/create_fasta.py`:
  the bin files byte for byte (after gunzip with `--compress`), `minsize`
  filtering included, both run with one hash seed (a bin's contigs are
  written in the order of a set of strings).
* `create_rc_kernel`, `create_projection_kernel` and `create_dual_kernel`
  equal `vamb_tpu`'s array for array; `python -m
  vamb_torch.tools.create_kernel OUT` writes `vamb_tpu`'s dual kernel
  (both computed in one-thread processes: the null-space basis LAPACK
  returns depends on its thread count); the dual
  kernel spans the space of the vendored `load_tnf_kernel()` (their
  orthogonal projectors agree within 1e-5).
* `Composition.from_file(use_device=True, device="cpu")`: the same
  metadata as the host path and `vamb_tpu`'s `use_device=True`, and the
  same matrix up to the float32 roundoff of another product order. After
  the 12-bit mantissa mask a value differs only where the two products'
  roundings straddle a mask step: by at most one step (2^12 ulps) of the
  row's largest value, in under 1% of the values, as `vamb_tpu`'s own two paths
  (tests/test_composition.py, tests/test_results.py). Asking for a card
  where there is none raises.
* `workflow_avamb/run_local_torch.py --device cpu --mock-mapping --epochs 1`
  end to end on a tiny three-sample catalogue with synthetic marker
  profiles: its catalogue and BAMs are those of run_local.py's stages 1-2
  (src/concatenate.py and run_local.py's `mock_mapping`), byte for byte
  after gunzip, and it writes `quality_report.tsv` and `Final_bins/`.
"""

import gzip
import io
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from vamb_torch.composition import Composition as TorchComposition
from vamb_torch.ops import kernel as t_kernel
from vamb_torch.utils import PushArray, mask_lower_bits

from vamb_tpu.composition import Composition as JaxComposition
from vamb_tpu.ops import hmm as H
from vamb_tpu.ops import kernel as j_kernel

from . import testtools
from .test_hmm import _revcomp
from .test_marker_fidelity import AA, _encode_gene, _profile_from_consensus, _sample_variant

REPO = Path(__file__).resolve().parent.parent


def run(argv, cwd=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    # a bin's contigs come out in the order of a set of strings, which
    # follows the process's hash seed: the same seed on both sides
    env["PYTHONHASHSEED"] = "0"
    # one thread a tool: the suite's workers share the cores
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run([sys.executable, *map(str, argv)], capture_output=True, text=True,
                          cwd=cwd or REPO, env=env, timeout=300)


def src_tool(name):
    return [REPO / "src" / f"{name}.py"]


def port_tool(name):
    return ["-m", f"vamb_torch.tools.{name}"]


def read_maybe_gz(path: Path) -> bytes:
    data = path.read_bytes()
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


def last_error(stderr: str) -> str:
    "The exception line a failed tool printed last."
    return stderr.strip().splitlines()[-1]


@pytest.fixture
def samples(tmp_path):
    """Three sample FASTAs: contigs of 1,500-4,000 bp, the same identifiers
    in every sample (so `--keepnames` collides) and a description on some."""
    rng = np.random.default_rng(3)
    paths = []
    for s in range(3):
        p = tmp_path / f"sample{s}.fna"
        with open(p, "w") as f:
            for i in range(12):
                seq = "".join(rng.choice(list("ACGT"), int(rng.integers(1500, 4000))))
                desc = f" len={len(seq)}" if i % 3 == 0 else ""
                f.write(f">contig{i}{desc}\n")
                for k in range(0, len(seq), 70):  # another line width than the output's
                    f.write(seq[k:k + 70] + "\n")
        paths.append(p)
    return paths


@pytest.mark.parametrize("flags", [[], ["-m", "2500"], ["--nozip"], ["--keepnames", "--nozip"]])
def test_concatenate_matches_src(samples, tmp_path, flags):
    inputs = samples[:1] if "--keepnames" in flags else samples
    outs = {}
    for side, tool in (("src", src_tool), ("port", port_tool)):
        out = tmp_path / f"{side}.fna" if "--nozip" in flags else tmp_path / f"{side}.fna.gz"
        proc = run([*tool("concatenate"), out, *inputs, *flags])
        assert proc.returncode == 0, proc.stderr
        outs[side] = read_maybe_gz(out)
        if "--nozip" not in flags:
            assert out.read_bytes()[:2] == b"\x1f\x8b"
    assert outs["port"] == outs["src"]
    headers = [line for line in outs["port"].decode().splitlines() if line.startswith(">")]
    if "--keepnames" in flags:
        assert headers[0].startswith(">contig0")
    else:
        assert all(h.startswith((">S1Ccontig", ">S2Ccontig", ">S3Ccontig")) for h in headers)
        assert {h[:3] for h in headers} == {">S1", ">S2", ">S3"}
    if flags == ["-m", "2500"]:
        assert 0 < len(headers) < 36


@pytest.mark.parametrize("case", ["duplicate identifiers", "existing output", "missing input"])
def test_concatenate_errors_alike(samples, tmp_path, case):
    errors = []
    for side, tool in (("src", src_tool), ("port", port_tool)):
        out = tmp_path / f"{side}.fna"
        args = [out, *samples, "--nozip"]
        if case == "duplicate identifiers":
            args.append("--keepnames")
        elif case == "existing output":
            out = tmp_path / "exists.fna"
            out.write_text("")
            args[0] = out
        else:
            args.insert(1, tmp_path / "absent.fna")
        proc = run([*tool("concatenate"), *args])
        assert proc.returncode != 0
        errors.append(last_error(proc.stderr).replace(str(tmp_path), "<tmp>"))
    assert errors[0] == errors[1], errors
    assert errors[0].split(":")[0] == {"duplicate identifiers": "ValueError",
                                       "existing output": "FileExistsError",
                                       "missing input": "FileNotFoundError"}[case]


@pytest.mark.parametrize("flags", [["0"], ["5000"], ["0", "--compress"]])
def test_create_fasta_matches_src(samples, tmp_path, flags):
    fasta = tmp_path / "catalogue.fna"
    assert run([*port_tool("concatenate"), fasta, *samples, "--nozip", "-m", "0"]).returncode == 0
    names = [line[1:].split()[0] for line in fasta.read_text().splitlines() if line.startswith(">")]
    rng = np.random.default_rng(1)
    clusters = tmp_path / "clusters.tsv"
    clusters.write_text("clustername\tcontigname\n" + "".join(
        f"bin{int(b)}\t{n}\n" for n, b in zip(names, rng.integers(0, 7, len(names)))))
    bins = {}
    for side, tool in (("src", src_tool), ("port", port_tool)):
        out = tmp_path / side
        proc = run([*tool("create_fasta"), fasta, clusters, flags[0], out, *flags[1:]])
        assert proc.returncode == 0, proc.stderr
        bins[side] = {p.name: read_maybe_gz(p) for p in sorted(out.iterdir())}
    assert bins["port"] == bins["src"]
    assert 0 < len(bins["port"]) <= 7
    if flags[0] == "5000":
        assert len(bins["port"]) < 7  # some bins fall under the minimum size
    if "--compress" in flags:
        assert all(name.endswith(".fna.gz") for name in bins["port"])


def test_create_fasta_without_arguments_prints_help():
    port, src = run(port_tool("create_fasta")), run(src_tool("create_fasta"))
    assert port.returncode == src.returncode == 0
    assert "clusterspath" in port.stdout and "clusterspath" in src.stdout


@pytest.mark.parametrize("name", ["create_rc_kernel", "create_projection_kernel",
                                  "create_dual_kernel"])
def test_kernels_equal_vamb_tpus(name):
    got, want = getattr(t_kernel, name)(), getattr(j_kernel, name)()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _projector(k: np.ndarray) -> np.ndarray:
    k = k.astype(np.float64)
    return k @ np.linalg.pinv(k)


def test_create_kernel_tool_writes_a_basis_of_the_vendored_space(tmp_path):
    """The tool writes `vamb_tpu`'s dual kernel, computed in a process like
    its own (LAPACK's null-space basis depends on its thread count), a
    rotation of the vendored constants."""
    out = tmp_path / "kernel.npz"
    proc = run([*port_tool("create_kernel"), out])
    assert proc.returncode == 0, proc.stderr
    assert str(out) in proc.stdout
    dual = np.load(out)["arr_0"]
    want = tmp_path / "want.npy"
    proc = run(["-c", "import sys, numpy; from vamb_tpu.ops.kernel import create_dual_kernel; "
                "numpy.save(sys.argv[1], create_dual_kernel())", want])
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_array_equal(dual, np.load(want))
    vendored = t_kernel.load_tnf_kernel()
    np.testing.assert_array_equal(vendored, j_kernel.load_tnf_kernel())
    assert not np.array_equal(dual, vendored)  # a rotation of it, not the same constants
    np.testing.assert_allclose(_projector(dual), _projector(vendored), atol=1e-5)


def test_push_array_capacity():
    arr = PushArray(np.float32, start_capacity=3)
    assert arr.capacity == 3
    arr.extend(np.arange(5, dtype=np.float32))
    assert arr.capacity == 64 and len(arr) == 5
    assert arr.take().tolist() == [0, 1, 2, 3, 4] and arr.capacity == 5


# ------------------------------------------------------ use_device


def _one_mask_step(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Whether a and b ((n, 103) masked float32) are at most one mask step
    (2^12 ulps) of their row's largest value apart: a product's roundoff
    scales with its row, so a value near 0 may move by more than its own
    ulps."""
    row = np.maximum(np.abs(a), np.abs(b)).max(axis=1, keepdims=True).astype(np.float32)
    return np.abs(a.astype(np.float64) - b) <= np.spacing(row) * 4096


def test_use_device_composition_on_the_cpu():
    data, *_ = testtools.make_fasta_bytes(random.Random(2), 300, 2500, 6000)
    device = TorchComposition.from_file(io.BytesIO(data), None, use_device=True, device="cpu")
    host = TorchComposition.from_file(io.BytesIO(data), None)
    jax_device = JaxComposition.from_file(io.BytesIO(data), None, use_device=True)
    for other in (host, jax_device):
        for field in ("identifiers", "lengths", "mask", "refhash", "minlength"):
            assert np.array_equal(getattr(device.metadata, field), getattr(other.metadata, field))
        a, b = device.matrix, other.matrix
        assert a.shape == b.shape == (300, 103) and a.dtype == np.float32
        assert (a.view(np.uint32) & np.uint32(0xFFF) == 0).all()  # the mask applied
        assert _one_mask_step(a, b).all()
        assert (a == b).mean() > 0.99
    # masking is the last step: the device features masked again are unchanged
    again = device.matrix.ravel().copy()
    mask_lower_bits(again, 12)
    np.testing.assert_array_equal(again, device.matrix.ravel())


def test_use_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, *_ = testtools.make_fasta_bytes(random.Random(3), 5, 2500, 3000)
    with pytest.raises(RuntimeError, match="CUDA device"):
        TorchComposition.from_file(io.BytesIO(data), None, use_device=True, device="cuda")
    # the host path never touches a device
    assert TorchComposition.from_file(io.BytesIO(data), None, device="cuda").nseqs == 5


# ------------------------------------------------------ the workflow

N_GENOMES, N_MARKERS, CONTIGS_PER_SAMPLE, N_SAMPLES = 6, 4, 60, 3


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Three sample assemblies from 6 genomes of distinct composition, 4
    single-copy marker genes planted in sample 0's contigs, their profile
    HMMs (cutoffs calibrated on variants) and a run_local config."""
    rng = np.random.default_rng(17)
    work = tmp_path_factory.mktemp("avamb_torch_wf")
    consensi = ["M" + "".join(AA[i] for i in rng.integers(0, 20, 39)) for _ in range(N_MARKERS)]
    profiles = [_profile_from_consensus(c, f"SYN{i:03d}") for i, c in enumerate(consensi)]
    for prof, cons in zip(profiles, consensi):
        scores = H.forward_scores(H.configure_local(prof),
                                  [_sample_variant(rng, cons) for _ in range(8)])
        prof.trusted_cutoff = float(scores.min()) - 0.5
    hmm_path = work / "markers.hmm"
    hmm_path.write_text("".join(H.format_hmm(p) for p in profiles))

    base_probs = rng.dirichlet(np.full(4, 1.5), N_GENOMES)
    genomes = [rng.choice(4, 40_000, p=base_probs[g]).astype(np.uint8) for g in range(N_GENOMES)]
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    # contig i comes from genome i % N_GENOMES; each marker goes into one of its genome's contigs
    plant = {(g, m): g + N_GENOMES * int(rng.integers(0, CONTIGS_PER_SAMPLE // N_GENOMES))
             for g in range(N_GENOMES) for m in range(N_MARKERS)}
    sample_paths = []
    for s in range(N_SAMPLES):
        path = work / f"assembly_s{s}.fna"
        with open(path, "wb") as f:
            for i in range(CONTIGS_PER_SAMPLE):
                g = i % N_GENOMES
                ln = int(rng.integers(2100, 3200))
                st = int(rng.integers(0, 40_000 - ln))
                seq = bytearray(lut[genomes[g][st:st + ln]])
                for m in range(N_MARKERS):
                    if s == 0 and plant[(g, m)] == i:
                        gene = _encode_gene(_sample_variant(rng, consensi[m]))
                        if (g + m) % 2:
                            gene = _revcomp(gene.encode()).decode()
                        gb = ("TAA" + gene + "TAA").encode()
                        pos = int(rng.integers(30, ln - len(gb) - 30))
                        seq[pos:pos + len(gb)] = gb
                f.write(b">contig%d\n%s\n" % (i, bytes(seq)))
        sample_paths.append(str(path))
    (work / "contigs.txt").write_text("\n".join(sample_paths) + "\n")
    config = {"contigs": str(work / "contigs.txt"), "sample_data": "unused-in-mock-mode",
              "min_contig_size": 2000, "min_bin_size": 5000, "min_identity": 0.95,
              "avamb_params": "-o C --seed 0", "outdir": str(work / "out"), "min_comp": 0.35,
              "max_cont": 0.5, "scoring": "native", "hmm_path": str(hmm_path), "threads": 2}
    (work / "config.json").write_text(json.dumps(config))
    return work


def test_run_local_torch_end_to_end(workspace):
    t0 = time.time()
    proc = run([REPO / "workflow_avamb" / "run_local_torch.py", "--config",
                workspace / "config.json", "--device", "cpu", "--mock-mapping", "--epochs", "1"])
    took = time.time() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert took < 60, took
    out = workspace / "out"
    assert (out / "avamb" / "aae_z_clusters_unsplit.tsv").exists()
    assert (out / "avamb" / "aae_y_clusters_unsplit.tsv").exists()
    report = out / "Final_bins" / "quality_report.tsv"
    assert report.exists() and (out / "Final_bins").is_dir()
    lines = report.read_text().strip().splitlines()
    assert lines[0].split("\t")[0].lower().startswith("name")
    fastas = list((out / "Final_bins" / "bins").rglob("*.fna*"))
    assert len(lines) > 1 and len(fastas) == len(lines) - 1  # bins passed, each written

    # run_local.py's stages 1-2 on the same inputs: src/concatenate.py and its mock_mapping
    ref = workspace / "ref"
    ref.mkdir()
    concat = ref / "contigs.flt.fna.gz"
    samples = (workspace / "contigs.txt").read_text().split()
    proc = run([*src_tool("concatenate"), concat, *samples, "-m", 2000])
    assert proc.returncode == 0, proc.stderr
    sys.path.insert(0, str(REPO / "workflow_avamb"))
    try:
        from run_local import mock_mapping
    finally:
        sys.path.remove(str(REPO / "workflow_avamb"))
    mock_mapping(str(concat), len(samples), str(ref / "mapped"))
    assert read_maybe_gz(out / "contigs.flt.fna.gz") == read_maybe_gz(concat)
    bams = sorted(p.name for p in (ref / "mapped").glob("*.bam"))
    assert bams == sorted(p.name for p in (out / "mapped").glob("*.bam")) and len(bams) == N_SAMPLES
    for name in bams:
        assert read_maybe_gz(out / "mapped" / name) == read_maybe_gz(ref / "mapped" / name), name
