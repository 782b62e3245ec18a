"""The port's multi-process CLI: `--dist/--coordinator/--nprocs/--procid`.

* The fail-fast cases of `_maybe_init_distributed`, as `vamb_tpu`'s
  (tests/test_distributed.py:150-189): a partial triple exits before any
  work, and a run that asks for nothing is a no-op.
* `main` leaves the process group it initialised when it returns or
  raises, a world of one under `--dist` included, so the same process can
  call it again.
* `bin default` through `vamb_torch.__main__.main` in two processes on the
  CPU (gloo), `--coordinator 127.0.0.1:<free port> --nprocs 2 --procid r`,
  on make_golden's synthetic dataset: only process 0's outputs remain
  (`.proc1` is removed), and its clusters equal a single-process run's
  (the 400 contigs pad to 512 columns at W = 1 and 2 alike, so both draw
  over the same Gumbel width; the data-parallel latent differs by ulps,
  which the 12-bit mask absorbs); the same with the engine's switches
  under several processes, `--wander_scope subset` (the subset wander and
  attempt lanes on the row-sharded engine) and `--distance_dtype bfloat16`.
* `taxometer`, `bin taxvamb` (Taxometer first, on an unrefined taxonomy)
  and `bin avamb` in two processes through `main`, each model trained
  data-parallel: the run completes, process 0's artifacts and TSVs read
  back (the model files load, the latents are finite, every contig lies in
  exactly one cluster of each clusters file), the parameter checksums
  that process 0 logged after every epoch are process 1's, and `.proc1`
  is removed.
"""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vamb_torch.__main__ import _maybe_init_distributed
from vamb_torch.models.aae import AAE
from vamb_torch.models.taxometer import Taxometer
from vamb_torch.models.vaevae import VAEVAE

from . import make_golden

ROOT = Path(__file__).resolve().parent.parent
JOIN_TIMEOUT_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _args(**kw):
    base = dict(dist=False, nprocs=None, procid=None, coordinator=None)
    return type("Args", (), {**base, **kw})()


@pytest.mark.parametrize("kw", [
    dict(procid=2),
    dict(coordinator="h0:9876"),
    dict(nprocs=4, coordinator="h0:9876"),
    dict(nprocs=2, procid=0),
])
def test_partial_multiprocess_flags_exit(kw):
    with pytest.raises(SystemExit):
        _maybe_init_distributed(_args(**kw), device="cpu")


def test_no_multiprocess_flags_is_a_no_op():
    from vamb_torch.parallel import process_info

    _maybe_init_distributed(_args(), device="cpu")
    assert process_info() == (0, 1)


_TWICE = """
import sys
import torch.distributed as dist
from vamb_torch.__main__ import main
for i in range(2):
    try:
        main(["bin", "default", "--outdir", sys.argv[1] + f"/o{i}", "--fasta",
              sys.argv[1] + "/absent.fna", "--abundance_tsv", sys.argv[1] + "/absent.tsv",
              "--dist"], device="cpu")
    except FileNotFoundError:
        pass
    print("GROUP", i, dist.is_initialized(), flush=True)
"""


def test_main_leaves_the_group_it_joined(tmp_path):
    """Two `main` calls in one process under `--dist` with WORLD_SIZE 1:
    each joins a group, fails on its missing input, and leaves the group."""
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    proc = subprocess.run([sys.executable, "-c", _TWICE, str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=JOIN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr
    assert re.findall(r"^GROUP .*$", proc.stdout, re.M) == ["GROUP 0 False", "GROUP 1 False"]


def _argv(data: Path, out: Path) -> list:
    return ["bin", "default", "--outdir", str(out), "--fasta", str(data / "contigs.fna"),
            "--abundance_tsv", str(data / "abundance.tsv"), "-e", str(make_golden.EPOCHS),
            "-q", "2", "--seed", str(make_golden.SEED), "-u", str(make_golden.MIN_SUCCESSES)]


def _launch(argv: list) -> subprocess.Popen:
    code = ("import sys; from vamb_torch.__main__ import main; "
            "main(sys.argv[1:], device='cpu'); print('RANK_DONE', flush=True)")
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-c", code, *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))


def _join(procs: list) -> list:
    """Wait for every process; kill them all and fail if one fails or
    outlives its limit. Returns each one's standard error."""
    errs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=JOIN_TIMEOUT_S)
            assert p.returncode == 0 and "RANK_DONE" in out, f"a process failed:\n{err[-3000:]}"
            errs.append(err)
    except BaseException:
        for q in procs:
            q.kill()
            q.communicate()
        raise
    return errs


def _two_ranks(argv: list) -> list:
    "`argv` in two processes on a free port; returns their standard error."
    coordinator = f"127.0.0.1:{free_port()}"
    return _join([_launch(argv + ["--coordinator", coordinator, "--nprocs", "2", "--procid", str(r)])
                  for r in range(2)])


def _two_and_one(tmp_path, flags: list) -> tuple:
    """`bin default` with `flags` in two processes and in one, all at once.
    Returns the two runs' output directories (multi, single)."""
    data = tmp_path / "data"
    data.mkdir()
    make_golden.write_synthetic_dataset(data)
    coordinator = f"127.0.0.1:{free_port()}"
    multi, single = tmp_path / "multi", tmp_path / "single"
    procs = [_launch(_argv(data, multi) + flags + ["--coordinator", coordinator, "--nprocs", "2",
                                                   "--procid", str(r)]) for r in range(2)]
    procs.append(_launch(_argv(data, single) + flags))
    _join(procs)
    return multi, single


def test_two_process_bin_default(tmp_path):
    multi, single = _two_and_one(tmp_path, [])
    # process 0's outputs in place, process 1's scratch directory removed
    for name in ("vae_clusters_unsplit.tsv", "vae_clusters_metadata.tsv", "latent.npz",
                 "model.npz", "log.txt"):
        assert (multi / name).is_file(), name
    assert not (multi / ".proc1").exists()
    log = (multi / "log.txt").read_text()
    assert "Multi-process: process 0 of 2" in log
    assert "Using a 2-process mesh" in log and "Parameters identical on 2 ranks" in log
    assert ((multi / "vae_clusters_unsplit.tsv").read_text()
            == (single / "vae_clusters_unsplit.tsv").read_text())


@pytest.mark.parametrize("flags,engine", [
    (["--wander_scope", "subset"], "subset wander"),
    (["--distance_dtype", "bfloat16"], "bfloat16"),
])
def test_two_process_bin_default_engine_switches(tmp_path, flags, engine):
    """The engine's switches under two processes: the row-sharded engine
    takes them (the subset wander with its attempt lanes, or bfloat16
    distances) and emits the clusters of a single-process run."""
    multi, single = _two_and_one(tmp_path, flags)
    assert not (multi / ".proc1").exists()
    log = (multi / "log.txt").read_text()
    assert "Using a 2-process mesh" in log
    if engine == "subset wander":
        attempts = re.search(r'subset wander \{"attempts": (\d+)', log)
        assert attempts and int(attempts.group(1)) > 0, log[-2000:]
    assert ((multi / "vae_clusters_unsplit.tsv").read_text()
            == (single / "vae_clusters_unsplit.tsv").read_text())


# the models' epochs in the two-process runs: Taxometer 3, VAEVAE and the AAE 2
PRED_EPOCHS, EPOCHS = 3, 2
MODEL_RUNS = {
    "taxometer": (["taxometer", "--taxonomy", "{tax}", "-pe", str(PRED_EPOCHS), "-pt", "128"],
                  {"predictor_model.npz": Taxometer}, (), PRED_EPOCHS),
    "taxvamb": (["bin", "taxvamb", "--taxonomy", "{tax}", "-pe", str(PRED_EPOCHS), "-pt", "128",
                 "-e", str(EPOCHS), "-t", "64", "-q", "1", "-n", "64", "64", "-l", "16"],
                {"predictor_model.npz": Taxometer, "vaevae_model.npz": VAEVAE},
                ("vaevae_clusters_unsplit.tsv",), PRED_EPOCHS + EPOCHS),
    "avamb": (["bin", "avamb", "--e_aae", str(EPOCHS), "--t_aae", "64", "--q_aae", "1",
               "--n_aae", "48", "--z_aae", "8", "--y_aae", "10"],
              {"aae_model.npz": AAE}, ("aae_z_clusters_unsplit.tsv", "aae_y_clusters_unsplit.tsv"),
              EPOCHS),
}


def _checksums(text: str) -> list:
    return re.findall(r"Parameters identical on 2 ranks \(checksum (-?\d+)\)", text)


@pytest.mark.parametrize("run", list(MODEL_RUNS))
def test_two_process_model_subcommands(tmp_path, run):
    """`taxometer`, `bin taxvamb` (Taxometer first) and `bin avamb` in two
    processes, each model trained data-parallel: process 0's artifacts and
    TSVs read back, every contig in exactly one cluster of each clusters
    file, the checksums of every epoch the same on both processes, and
    `.proc1` removed."""
    data = tmp_path / "data"
    data.mkdir()
    make_golden.write_synthetic_dataset(data)
    make_golden.write_synthetic_taxonomy(data)
    argv, models, tsvs, epochs = MODEL_RUNS[run]
    out = tmp_path / "out"
    argv = [a.replace("{tax}", str(data / "taxonomy.tsv")) for a in argv]
    errs = _two_ranks([*argv, "--outdir", str(out), "--fasta", str(data / "contigs.fna"),
                       "--abundance_tsv", str(data / "abundance.tsv"), "--seed", "5"])
    assert not (out / ".proc1").exists()
    log = (out / "log.txt").read_text()
    assert "Multi-process: process 0 of 2" in log and "Using a 2-process mesh" in log
    sums = _checksums(log)
    assert len(sums) == epochs and sums == _checksums(errs[1]), (sums, _checksums(errs[1]))
    for name, cls in models.items():
        cls.load(out / name, device="cpu")
    expected = sorted(f"S{1 + i % 3}C{i}" for i in range(make_golden.N_CONTIGS))
    for name in tsvs:
        rows = [line.split("\t") for line in (out / name).read_text().splitlines()[1:]]
        assert sorted(r[1] for r in rows) == expected, name  # a full partition
    if run != "avamb":
        lines = (out / "results_taxometer.tsv").read_text().splitlines()
        assert len(lines) == make_golden.N_CONTIGS + 1
    latents = {"taxvamb": ("vaevae_latent.npz", 16), "avamb": ("aae_z_latent.npz", 8)}
    if run in latents:
        name, width = latents[run]
        latent = np.load(out / name)["arr_0"]
        assert latent.shape == (make_golden.N_CONTIGS, width) and np.isfinite(latent).all()
