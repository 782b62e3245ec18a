#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vamb_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` and the checkout this file sits in; it builds
the port's CUDA kernels from `vamb_torch/kernels/csrc/` itself. It imports
nothing of JAX or of `vamb_tpu`. Phases, each of which fails the run:

1. setup: print the card's name and power limit; build the kernels.
2. kernels: every hand-written kernel against its plain PyTorch version on
   the card, at the main path's shapes and around them, then timed with
   CUDA events beside its bound, its plain version and a library yardstick.
3. engine: the clustering engine on the card against the same engine on
   the CPU (the path the CPU tests hold against `vamb_tpu`), on a small
   clumpy latent: the emissions must be identical.
4. main path: `vamb_torch bin default` through its CLI entry point on a
   synthetic 100,000-contig dataset (VAE 512-512-32, 2 epochs, clustering
   capped at 2,000 clusters). Every kernel's launch counter is set to 0 just
   before and read just after; each must be > 0. The stage artifacts and
   TSVs are read back and checked.
5. profile: on the main path's own data, 100 clusters of the engine and
   100 training steps under torch.profiler: time per cluster and per step,
   the device's busy share and the kernels that take the most device time.

The last three lines of standard output are the kernels JSON object, the
card's `nvidia-smi` name and power limit, and `{"ok": true, "device": ...}`.
"""

import itertools
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s and float32 FLOP/s outside
# the tensor cores. The kernels' arithmetic is plain f32 FMA-free math.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

N_CONTIGS = 100_000
N_GENOMES = 1_000
N_SAMPLES = 6
F_PAD = 32  # the latent width 32, padded to a multiple of 8
MAXSTEPS = 25  # the engine's candidates per wander step
SEED = 1


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- timing


def time_ms(fn, iters: int = 50, cold_l2: bool = True) -> float:
    """Device ms of one call of `fn`, the median over `iters` calls after a
    warm-up, from CUDA events around each call. Before each call the card
    sleeps ~2 ms, so the host has queued the whole call when the start
    event fires and the span holds device time only. With `cold_l2`, a
    64 MiB buffer is overwritten first, so the call finds the 50 MB L2
    cold; without it, the call finds its inputs where the last one left
    them, as the engine's back-to-back wander steps do."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") if cold_l2 else None
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(4_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound(nbytes: float, nflops: float) -> tuple[float, str]:
    "Least ms for the work: bytes over HBM rate vs f32 ops over f32 rate."
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nflops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ inputs


def clumpy_matrixT(n: int, f: int, seed: int) -> np.ndarray:
    """(f, n) float32 columns of unit/sqrt(2) norm in tight clumps, so the
    radius-0.05 densities have many terms, as the engine's latents do."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(max(1, n // 100), f))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, len(centers), n)] + rng.normal(scale=0.03, size=(n, f))
    x /= np.linalg.norm(x, axis=1, keepdims=True) * np.sqrt(2)
    return np.ascontiguousarray(x.T.astype(np.float32))


def weights(n: int, seed: int, zero_half: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.integers(2000, 50_000, n).astype(np.float32)
    if zero_half:
        w[rng.permutation(n)[: n // 2]] = 0.0
    return w


# ------------------------------------------------------- phase 2: kernels


def check_kernels(dev) -> dict:
    from vamb_torch import kernels as K

    err_row = 0.0
    err_dens = 0.0
    for n in (N_CONTIGS, N_CONTIGS + 3):
        mT = torch.as_tensor(clumpy_matrixT(n, F_PAD, seed=n), device=dev)
        for idx in (0, 37, n - 1):
            d = K.row_sweep(mT, idx)
            p = K.row_sweep_plain(mT, idx)
            torch.cuda.synchronize()
            e = float((d - p).abs().max())
            if not (e <= 1e-6 and float(d[idx]) == 0.0 and bool(torch.isfinite(d).all())):
                raise AssertionError(f"row_sweep n={n} idx={idx}: max|d-plain|={e}, d[idx]={float(d[idx])}")
            err_row = max(err_row, e)
        rng = np.random.default_rng(n)
        for zero_half in (False, True):
            w = torch.as_tensor(weights(n, seed=n, zero_half=zero_half), device=dev)
            for c in (1, 25, 32):
                cand = torch.as_tensor(rng.choice(n, size=c, replace=False), device=dev)
                dens = K.candidate_density_sweep(mT, cand, w)
                plain = K.candidate_density_plain(mT, cand, w)
                torch.cuda.synchronize()
                e = float((dens - plain).abs().max())
                ok = torch.allclose(dens, plain, rtol=1e-5, atol=0.0)
                if not (ok and bool(torch.isfinite(dens).all())):
                    raise AssertionError(
                        f"candidate_density_sweep n={n} C={c} zero_half={zero_half}: "
                        f"max abs err {e}, dens {dens.tolist()} vs {plain.tolist()}"
                    )
                err_dens = max(err_dens, e)
    log(f"kernels agree with their plain versions: row_sweep max|err| {err_row} "
        f"(atol 1e-6, d[idx] == 0), candidate_density_sweep max|err| {err_dens} (rtol 1e-5)")
    return {"row_sweep": err_row, "candidate_density_sweep": err_dens}


def time_kernels(dev) -> dict:
    "Times at the main path's shapes: (32, 100,096) after 128-column padding, C = 25."
    from vamb_torch import kernels as K

    n_pad = -(-N_CONTIGS // 128) * 128
    mT = torch.as_tensor(clumpy_matrixT(n_pad, F_PAD, seed=5), device=dev)
    w = torch.as_tensor(weights(n_pad, seed=5), device=dev)
    cand = torch.as_tensor(np.random.default_rng(5).choice(n_pad, MAXSTEPS, replace=False), device=dev)
    idx = 37
    col = mT[:, idx].contiguous()
    mTt = mT.T  # a (N, F) view: torch.mv reads the same bytes

    out = {}
    for cold in (True, False):
        tag = "" if cold else "_l2_warm"
        out["row_sweep" + tag] = {
            "ms": time_ms(lambda: K.row_sweep(mT, idx), cold_l2=cold),
            "plain_ms": time_ms(lambda: K.row_sweep_plain(mT, idx), cold_l2=cold),
            "library_ms": time_ms(lambda: torch.mv(mTt, col), cold_l2=cold),
        }
        out["candidate_density_sweep" + tag] = {
            "ms": time_ms(lambda: K.candidate_density_sweep(mT, cand, w), cold_l2=cold),
            "plain_ms": time_ms(lambda: K.candidate_density_plain(mT, cand, w), cold_l2=cold),
            "library_ms": None,  # no single PyTorch call computes it
        }
    # bounds from this run's inputs: each input byte read once, each output
    # byte written once; density work counts only the kept (w > 0) columns
    f, n = mT.shape
    out["row_sweep"]["bound"] = bound((f * n + n) * 4, 2 * f * n)
    n_kept = int((w > 0).sum())
    c = len(cand)
    out["candidate_density_sweep"]["bound"] = bound(
        (f * n_kept + n + 2 * c) * 4, 2 * c * f * n_kept + 4 * c * n_kept
    )
    for name in ("row_sweep", "candidate_density_sweep"):
        r, wr = out[name], out[name + "_l2_warm"]
        lib = "n/a (no single PyTorch call)" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"{name} at F_pad {f}, N_pad {n}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound'][0] * 1e3:.2f} us ({r['bound'][1]}), "
            f"L2 cold; L2 warm: kernel {wr['ms']:.4f} ms, plain {wr['plain_ms']:.4f} ms")
    return out


# -------------------------------------------------------- phase 3: engine


def check_engine(dev) -> None:
    "The engine on the card emits exactly what it emits on the CPU."
    from vamb_torch.cluster import ClusterGenerator

    rng = np.random.default_rng(3)
    centers = rng.normal(size=(40, 32))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    m = np.concatenate([c + rng.normal(scale=0.04, size=(30, 32)) for c in centers]).astype(np.float32)
    lengths = rng.integers(2000, 50_000, len(m)).astype(np.float32)
    on_card = list(ClusterGenerator(m.copy(), lengths, rng_seed=3, device=dev))
    on_cpu = list(ClusterGenerator(m.copy(), lengths, rng_seed=3, device="cpu"))
    if len(on_card) != len(on_cpu):
        raise AssertionError(f"engine: {len(on_card)} clusters on the card, {len(on_cpu)} on the CPU")
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        same = (a.kind_str, a.medoid, a.seed, a.successes, a.attempts, a.radius, a.maximal_pvr) == (
            b.kind_str, b.medoid, b.seed, b.successes, b.attempts, b.radius, b.maximal_pvr
        ) and np.array_equal(a.members, b.members)
        if not same:
            raise AssertionError(f"engine: cluster {i} differs between the card and the CPU")
    log(f"engine on the card is emission-identical to the CPU engine: {len(on_card)} clusters of {len(m)} points")


# ----------------------------------------------------- phase 4: main path


def write_dataset(d: Path, n_contigs: int, n_genomes: int, n_samples: int, seed: int) -> np.ndarray:
    """A FASTA of `n_contigs` contigs of 2,000-4,000 bp from `n_genomes`
    planted genomes, and an `n_samples`-sample abundance TSV. Each genome
    draws its sequence as 4-mer words from its own Dirichlet distribution
    (so TNF separates genomes) and has its own abundance profile. Names are
    S{1..3}C{i}, for binsplitting. Returns each contig's genome."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, n_genomes, n_contigs)
    lengths = rng.integers(2000, 4001, n_contigs)
    # per-genome word tables: 4096 slots quantize each genome's distribution
    probs = rng.dirichlet(np.full(256, 0.5), n_genomes)
    table = np.zeros((n_genomes, 4096), np.uint8)
    for g in range(n_genomes):
        table[g] = np.searchsorted(np.cumsum(probs[g]), (np.arange(4096) + 0.5) / 4096).clip(0, 255)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    words = acgt[np.array([[(w >> s) & 3 for s in (6, 4, 2, 0)] for w in range(256)])]  # (256, 4)
    names = [f"S{1 + i % 3}C{i}" for i in range(n_contigs)]
    with open(d / "contigs.fna", "wb") as f:
        for lo in range(0, n_contigs, 2000):
            hi = min(lo + 2000, n_contigs)
            nwords = (lengths[lo:hi] + 3) // 4
            g = np.repeat(genome[lo:hi], nwords)
            w = table[g, rng.integers(0, 4096, len(g))]
            bases = words[w].reshape(-1)
            ends = np.cumsum(nwords * 4)
            starts = ends - nwords * 4
            buf = bases.tobytes()
            f.write(b"".join(
                b">" + names[i].encode() + b"\n" + buf[s : s + ln] + b"\n"
                for i, s, ln in zip(range(lo, hi), starts, lengths[lo:hi])
            ))
    profiles = rng.lognormal(1.5, 1.0, (n_genomes, n_samples))
    depth = profiles[genome] * rng.uniform(0.7, 1.3, (n_contigs, n_samples))
    with open(d / "abundance.tsv", "w") as f:
        f.write("contigname\t" + "\t".join(f"sample{j}" for j in range(n_samples)) + "\n")
        f.writelines(
            name + "\t" + "\t".join(f"{v:.4f}" for v in row) + "\n" for name, row in zip(names, depth)
        )
    return genome


def read_tsv(path: Path) -> list[list[str]]:
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def check_outputs(out: Path, genome: np.ndarray, max_clusters: int) -> dict:
    "Read every artifact back with the port's own loaders and check it."
    from vamb_torch.abundance import Abundance
    from vamb_torch.composition import Composition
    from vamb_torch.models import VAE
    from vamb_torch.utils import read_npz

    comp = Composition.load(out / "composition.npz")
    check(comp.matrix.shape == (N_CONTIGS, 103) and np.isfinite(comp.matrix).all(), "composition.npz")
    ab = Abundance.load(out / "abundance.npz", comp.metadata.refhash)
    check(ab.matrix.shape == (N_CONTIGS, N_SAMPLES) and np.isfinite(ab.matrix).all(), "abundance.npz")
    vae = VAE.load(out / "model.npz", device="cpu")
    check(vae.nhiddens == [512, 512] and vae.nlatent == 32 and vae.nsamples == N_SAMPLES, "model.npz")
    latent = read_npz(out / "latent.npz")
    check(latent.shape == (N_CONTIGS, 32) and latent.dtype == np.float32
          and np.isfinite(latent).all() and not (latent.view(np.uint32) & 0xFFF).any(),
          "latent.npz: (N, 32) finite float32 with 12 low mantissa bits masked")

    unsplit = read_tsv(out / "vae_clusters_unsplit.tsv")
    split = read_tsv(out / "vae_clusters_split.tsv")
    meta = read_tsv(out / "vae_clusters_metadata.tsv")
    check(unsplit[0] == ["clustername", "contigname"] and split[0] == unsplit[0], "TSV headers")
    members = [r[1] for r in unsplit[1:]]
    check(len(members) == len(set(members)) > 0, "a contig sits in two clusters")
    check(sorted(members) == sorted(r[1] for r in split[1:]), "split and unsplit TSVs hold other contigs")
    clusters = {r[0] for r in unsplit[1:]}
    check(len(clusters) == len(meta) - 1 <= max_clusters, f"{len(clusters)} clusters, {len(meta) - 1} metadata rows")
    # below the cap the engine ran to the end: every contig is in a cluster
    check(len(clusters) == max_clusters or len(members) == N_CONTIGS, "stopped below the cap with contigs left")
    check(all(int(r[5]) >= 1 and r[3] in ("normal", "loner", "fallback") for r in meta[1:]), "metadata rows")
    # pairwise precision of the emitted clusters against the planted genomes
    ids = np.array([int(m.split("C")[1]) for m in members])
    lab = np.unique([r[0] for r in unsplit[1:]], return_inverse=True)[1]
    g = genome[ids]
    same_cluster = sum(int(c) * (int(c) - 1) // 2 for c in np.bincount(lab))
    pairs = {}
    for a, b in zip(lab, g):
        pairs[(a, b)] = pairs.get((a, b), 0) + 1
    same_both = sum(c * (c - 1) // 2 for c in pairs.values())
    precision = same_both / same_cluster if same_cluster else 1.0
    log(f"outputs check: composition {comp.matrix.shape}, abundance {ab.matrix.shape}, "
        f"latent {latent.shape}, {len(clusters)} clusters holding {len(members)} contigs; "
        f"pairwise precision against the planted genomes {precision:.4f}")
    return {"clusters": len(clusters), "clustered_contigs": len(members), "precision": precision}


def stage_times(logfile: Path) -> dict:
    text = logfile.read_text()
    pats = {
        "tnf_s": r"Processed TNF in ([\d.]+) seconds",
        "abundance_s": r"Processed abundance in ([\d.]+) seconds",
        "vae_train_encode_s": r"Trained VAE and encoded in ([\d.]+) seconds",
        "cluster_write_s": r"Wrote cluster file\(s\) in ([\d.]+) seconds",
    }
    out = {}
    for k, p in pats.items():
        m = re.search(p, text)
        if m is None:
            raise AssertionError(f"log.txt lacks the line /{p}/")
        out[k] = float(m.group(1))
    out["epochs_s"] = [float(x) for x in re.findall(r"Epoch:.*\(([\d.]+)s\)", text)]
    return out


def run_main_path(dev, tmp: Path, max_clusters: int = 2000, epochs: int = 2) -> dict:
    from vamb_torch import kernels as K
    from vamb_torch.__main__ import main

    data = tmp / "data"
    data.mkdir()
    t = time.time()
    genome = write_dataset(data, N_CONTIGS, N_GENOMES, N_SAMPLES, SEED)
    log(f"wrote the synthetic dataset ({N_CONTIGS} contigs, {N_GENOMES} genomes, "
        f"{N_SAMPLES} samples) in {time.time() - t:.1f} s")
    out = tmp / "run"
    argv = ["bin", "default", "--outdir", str(out), "--fasta", str(data / "contigs.fna"),
            "--abundance_tsv", str(data / "abundance.tsv"),
            "-e", str(epochs), "-q", "1", "-c", str(max_clusters), "--seed", str(SEED)]
    K.reset_launch_counts()
    t = time.time()
    main(argv, device=str(dev))
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {"row_sweep": K.row_sweep.launches,
                "candidate_density_sweep": K.candidate_density_sweep.launches}
    log(f"bin default ran end to end in {wall:.2f} s; kernel launches {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name}")
    checked = check_outputs(out, genome, max_clusters)
    times = stage_times(out / "log.txt")
    times["total_s"] = wall
    times["clusters_per_s"] = checked["clusters"] / times["cluster_write_s"]
    log("stage times: " + json.dumps(times))
    return {"launches": launches, **checked, "times": times, "profile": profile_stages(dev, out)}


# --------------------------------------------------- phase 5: profile


def profiled(fn, label: str) -> dict:
    """Run `fn` under torch.profiler. Reports its wall time, the device's
    busy share (summed kernel time over wall time) and the PyTorch ops
    whose kernels take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        count = fn()
        torch.cuda.synchronize()
        wall = time.time() - t
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    ops = [a for a in prof.key_averages() if a.device_type == DeviceType.CPU]
    top = sorted(ops, key=lambda a: -a.self_device_time_total)[:6]
    result = {
        "units": count, "wall_s": wall, "ms_per_unit": wall / count * 1e3,
        "kernels_per_unit": len(kernels) / count, "device_busy_share": busy_s / wall,
        "top_ops": [{"op": a.key[:60], "calls": a.count, "device_ms": a.self_device_time_total / 1e3}
                    for a in top],
    }
    log(f"{label} profile: " + json.dumps(result))
    if not kernels:
        log(f"{label}: the profiler saw no device kernels, so the busy share is not measured")
    return result


def profile_stages(dev, out: Path) -> dict:
    """Where the time of the two device stages goes, on the main path's own
    data: 100 clusters of the engine on its latent (a unit is a cluster),
    and one training epoch of 100 steps at batch 256 on its first 25,600
    contigs (a unit is an optimizer step). Short windows: the profiler's
    own bookkeeping grows with the number of events."""
    from vamb_torch.abundance import Abundance
    from vamb_torch.cluster import ClusterGenerator
    from vamb_torch.composition import Composition
    from vamb_torch.models import VAE, make_dataset
    from vamb_torch.models.dataset import num_batches
    from vamb_torch.utils import read_npz

    comp = Composition.load(out / "composition.npz")
    gen = ClusterGenerator(read_npz(out / "latent.npz"), comp.metadata.lengths,
                           rng_seed=SEED, device=dev)
    next(gen)  # the first cluster loads the modules lazily

    def cluster_100():
        return sum(1 for _ in itertools.islice(gen, 100))

    ab = Abundance.load(out / "abundance.npz", comp.metadata.refhash)
    rows = 256 * 100
    ds = make_dataset(ab.matrix[:rows], comp.matrix[:rows], comp.metadata.lengths[:rows])
    vae = VAE(N_SAMPLES, seed=SEED, device=dev)

    def train_epoch():
        vae.trainmodel(ds, nepochs=1, batchsize=256, batchsteps=None)
        return num_batches(ds.n_obs, 256)

    return {"cluster": profiled(cluster_100, "clustering"), "train": profiled(train_epoch, "training")}


# ------------------------------------------------------------------ main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    import vamb_torch  # noqa: F401  (fails outside a checkout)
    from vamb_torch import kernels as K

    dev = torch.device("cuda")
    card = nvidia_smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t = time.time()
    K.build(verbose=True)
    log(f"built the CUDA kernels in {time.time() - t:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    errs = check_kernels(dev)
    timed = time_kernels(dev)
    check_engine(dev)
    with tempfile.TemporaryDirectory() as tmp:
        main_run = run_main_path(dev, Path(tmp))

    source = "vamb_torch/kernels/csrc/cluster_kernels.cu"
    replaces = {"row_sweep": "vamb_tpu/ops/pallas_cluster.py:219",
                "candidate_density_sweep": "vamb_tpu/ops/pallas_cluster.py:295"}
    kernels = []
    for name in ("row_sweep", "candidate_density_sweep"):
        r, warm = timed[name], timed[name + "_l2_warm"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces[name],
            "launches": main_run["launches"][name], "max_abs_err": errs[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
            "ms_l2_warm": warm["ms"], "plain_ms_l2_warm": warm["plain_ms"],
            "library_ms_l2_warm": warm["library_ms"],
        })
    print(json.dumps({"kernels": kernels, "main_path": {k: v for k, v in main_run.items() if k != "launches"}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
