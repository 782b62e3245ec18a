#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vamb_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc`, `g++` with zlib's header and the checkout
this file sits in; it builds the port's CUDA kernels from
`vamb_torch/kernels/csrc/` (one nvcc a source, started together) and the
native BAM reader and 4-mer counter itself. It imports nothing of JAX or
of `vamb_tpu`. Phases, each of which fails the run:

1. setup: print the card's name and power limit; build the kernels (with
   ptxas' register and spill report) and the native libraries, and count
   each kernel's SASS instructions by opcode family.
2. kernels: every hand-written kernel against its plain PyTorch version on
   the card, bit for bit, at the main paths' shapes and around them
   (`medoid_sweep`'s row, histogram, density and close count included;
   `spec_sweep` at S 1, 3 and 8 and `row_stats` on its rows also against
   `medoid_sweep` column by column, at 8,192, 100,003, 100,096, 150,016
   and 300,032 columns and at F_pad 288 on 100,096;
   `gather_ball`'s side vectors; `gumbel_scores`' bits with no, some and
   all columns eligible; `gumbel_topc`'s candidates and their validity
   array-equal and its optional scores bit for bit, with no, some and all
   columns eligible and at two keys whose top 25 hold tied scores, at C 1,
   25 and 32, one launch a call), then timed with CUDA events at every
   width the main paths give it, beside its bound (bytes, f32 or, for
   `gumbel_topc`, int32 operations), its plain version and a library
   yardstick (for `gumbel_topc`, the scores-only launch and `torch.topk`,
   the step as it was before the kernel took the selection, also on the
   host's clock; for `spec_sweep`, `torch.matmul` of its rows alone, and 8
   `medoid_sweep` launches beside it). At F_pad 288, the width phase 9
   clusters at, where the
   matrix kernels take their generic code: `row_sweep`,
   `candidate_density_sweep` and `medoid_sweep` bit for bit at 100,096 and
   100,003 columns, the gather at 100,096, each timed at 100,096 beside
   its bound, plain version and library yardstick. The bf16 variants of
   `medoid_sweep`, `spec_sweep` (S 1, 3 and 8) and
   `candidate_density_sweep` (the kernels a bfloat16 engine runs) on a
   bf16 matrix, bit for bit the f32 kernels on the widened matrix and
   their plain versions at 8,192, 100,003, 100,096, 150,016 and 300,032
   columns and at F_pad 288 on 100,096, then timed at 100,096, 150,016 and
   300,032 (and 100,096 at 288) beside their bounds (the matrix's bytes
   at 2 an element), their plain versions, the f32 kernels' times and,
   for `spec_sweep`, `torch.mm(rows, matrixT, out_dtype=torch.float32)` on
   the bf16 operands (or, where the card's PyTorch lacks it, the
   bf16-output `torch.matmul`, labelled so). The profile-HMM
   Forward kernel `hmm_forward` against
   its plain version within 1e-3 + 1e-5 |score| bits at M 50, 200, 600 and
   1,000 on 256 genes of 30-1,000 residues (null residues mid-sequence)
   and on phase 7's shape, 8,192 length-sorted genes at M 350, timed there
   beside its bound (11 f32 instructions a DP cell) and its plain version;
   no PyTorch call computes Forward or draws jax's bits.
3. engine: the clustering engine on the card against the same engine on
   the CPU (the path the CPU tests hold against `vamb_tpu`), on small
   clumpy latents at full scope, with the subset wander forced (also on a
   512-column ball, where its overflow and drift fallbacks run) and with
   the compaction ladder forced: the emissions must be identical. The
   VAE's eps drawn on the card must equal the CPU's bit for bit.
4. main path at 100,000 contigs: `vamb_torch bin default` through its CLI
   entry point on a synthetic dataset (VAE 512-512-32, 2 epochs,
   clustering capped at 2,000 clusters), full-scope wander. Every kernel's
   launch counter and its tally by N_pad are set to 0 just before and read
   just after; `candidate_density_sweep`, `medoid_sweep`, `gumbel_topc`
   and `spec_sweep` must be > 0, and no bf16 variant may have run (this
   path is f32; so in phase 5); the engine's counters (the subset
   wander's fallbacks, the seed cache's refills, the loner bursts, the
   attempt lanes and their cuts) are read from log.txt and logged. The
   stage artifacts and TSVs are read back
   and checked. Then 50 clusters of the engine on this path's latent on
   the card and on the CPU in lockstep, counting the clusters emitted alike
   and how often each decision input (the engine's Gumbel scores, through
   `gumbel_topc`'s optional output, its candidates, their densities,
   histogram, smoothed densities) differed: the Gumbel scores and the
   candidates must differ in no step and the 50 clusters must be
   identical.
5. main path at 300,000 contigs from 3,000 genomes (6 samples, 2 epochs,
   `-c 3200`): the subset wander with `gather_ball` and `row_sweep` on the
   ball, at least one logged compaction and the switch back to full
   sweeps, with attempt lanes on by "auto". Counters as in phase 4; all
   seven clustering kernels but `gumbel_scores` must be > 0, and the
   engine must have run lane passes.
6. profile: on each main path's own data, 20 clusters of the engine and
   20 training steps under torch.profiler: time per cluster and per step,
   device kernels per attempt and per wander step, the device's busy share
   and the ops that take the most device time. A clustering window that
   calls `aten::topk` fails the run: the selection is `gumbel_topc`'s.
7. BAM input and recluster, through the CLI entry points on the card:
   20,000 contigs from 200 genomes, each genome carrying a variant of each
   of 40 synthetic marker profiles (M 100-600, trusted cutoffs calibrated
   as tests/test_marker_fidelity.py does), half on the reverse strand; 3
   BAMs of 150 bp reads at about 3x; `bin default --bamfiles` (VAE
   512-512-32, 10 epochs, `-c 600`), then `recluster` k-means with
   markers predicted from the profiles (`--hmm_path`) on that run's bins,
   k-means with the saved markers on the planted genomes with 20 pairs
   merged, and DBSCAN with the saved markers on a taxonomy of genera of
   2-5 genomes (`--no_predictor`). Counters as in phase 4;
   `hmm_forward` and `gumbel_topc` must be > 0. Gates: marker precision
   and recall against the planted genes; on a sample of the encoded gene
   batches (the longest genes' included), every profile's scores from the kernel within the
   tolerance of the plain version's on the card and no marker call that
   differs outside that band around the cutoff (the calls inside it are
   counted); every TSV read back; and k-means' pairwise precision against
   the planted genomes not below its input's.
8. the taxonomy path at 100,000 contigs, through the CLI entry points on
   the card: phase 4's dataset with a partial taxonomy of the planted
   genomes (`write_taxonomy`: genera of 2-5 genomes and ranks nested above
   them; 70% of contigs labelled to species, 20% cut to a higher rank, 10%
   unlabelled, as an MMseqs2 annotation leaves them); `taxometer` at its
   published width (4 x 512, flat_softmax, batch 1,024, 4 epochs), then
   `bin taxvamb` on its refined TSV (VAEVAE 512-512-32, 2 epochs, `-c
   2000`). Counters as in phase 4 around `bin taxvamb`;
   `candidate_density_sweep`, `medoid_sweep` and `gumbel_topc` must be
   > 0. Every TSV and npz is read back with the port's loaders; the
   trained predictor's probabilities on the card within 1e-5 of the CPU's
   on 4,096 contigs, and its refined lineages equal but where a
   probability lies within 1e-5 of the threshold (counted). Logged, not
   gated: the taxvamb clusters' pairwise precision beside phase 4's, the
   refined genus's accuracy on the unlabelled contigs, the stage times,
   and training steps of Taxometer (40) and VAEVAE (10) under
   torch.profiler (ms and device kernels a step, busy share, top ops).
9. the Avamb path at 100,000 contigs, through the CLI entry points on the
   card: phase 4's dataset; `bin avamb` at the published widths (547 /
   283 / 700, batch 256; 2 epochs, `-c 2000`). Counters as in phase 4,
   also by F_pad: `candidate_density_sweep` and `medoid_sweep` must have
   launched at F_pad 288 alone, `gumbel_topc` > 0. Gates: the artifacts
   (`aae_model.npz`'s widths, the z latent (N, 283) finite), every contig in
   exactly one y bin, the z bins disjoint; the trained model's
   `get_latents` on 4,096 contigs on the card within 1e-5 x max |mu| of
   the CPU's, its
   y clusters equal but where the top two y probabilities lie within 1e-5
   (counted); 50 clusters of the z latent (fewer where it holds fewer, or
   where 50 wander steps are reached first) on the card and on the CPU as
   in phase 4 (scores and candidates different in no step, all
   identical); `avamb_ensemble` over the z and y bins with a CheckM2-style
   report from the planted genomes, every bin admitted (the cut's bins are
   not near-complete): its bins disjoint, each a subset of its input bin.
   Logged: stage times, the bins' pairwise precision, the bins the
   ensemble kept, and 10 AAE training steps under torch.profiler.
10. batched attempts: (a) a loner-tail latent of 10,000 points (70 wide
   clumps of 100 and 3,000 isolated random directions, about 0.5 apart in
   32 dimensions: loners) run to its last point at subset scope with
   attempt lanes on and off, on the card and on the CPU: the four
   emissions must be identical and the card's runs must launch
   `spec_sweep` and `row_stats`; (b) the same recipe at 100,000 points
   (700 clumps, 30,000 isolated) run to its last point on the card at auto
   scope (full sweeps: the seed cache and the loner bursts): clusters,
   loners, burst loners, refills, ms a cluster before the loner tail and
   inside it, device kernels a cluster in a profiled window of each; (c)
   an in-process A/B of the lanes on the 300,000-point latent of
   `--engine-ab` at subset scope, off, on, on, off, 200 clusters each: ms
   and device kernels a cluster, the medoids' hashes equal.
11. the bf16 path at 100,000 contigs: `bin default --precision bf16
   --distance_dtype bfloat16` through the CLI entry point on phase 4's
   dataset (VAE 512-512-32 trained at bf16, 2 epochs, `-c 2000`), the
   counters set to 0 just before and read just after. Gates: the bf16
   variants of `medoid_sweep`, `spec_sweep` and `candidate_density_sweep`
   launched and their f32 versions not, `row_sweep` and the gather never
   (a bf16 engine takes no subset wander); the artifacts and TSVs read
   back, `model.npz` recording "bf16"; 50 clusters of the bf16 engine on
   this path's latent on the card and on the CPU in lockstep (Gumbel
   scores and candidates different in no step, all 50 identical); phase
   4's f32 latent clustered at bf16 on the card agreeing with phase 4's
   f32 clusters on more than 0.95 of 1,000,000 sampled contig pairs
   (`vamb_tpu`'s criterion). Logged: stage times, the bins' pairwise
   precision beside phase 4's, and 20 bf16 training steps under
   torch.profiler beside phase 6's f32 steps.
12. several processes: the four shard entry points (`medoid_sweep_shard`,
   `spec_sweep_shard`, `candidate_density_shard`, `gumbel_topc_shard`) on
   the shards of 100,096 columns over 1, 2 and 4 ranks, bit for bit their
   plain versions on the card and the index entry points on the shard, the
   Gumbel shards merged bit for bit `gumbel_topc` over the whole width,
   then timed; `gather_ball_shard` on the 128-aligned shards of 100,096
   and 300,032 columns (KB 64) over 1, 2 and 4 ranks, bit for bit its plain
   version and `gather_ball` of the whole matrix for the shard's blocks,
   and the bf16 variants of the three shard sweeps on bf16 shards of
   100,096 columns, bit for bit their plain versions and the bf16 index
   entry points on the shard, then timed (the gather beside
   `index_select`); (a) a world of one on NCCL: phase 4's dataset trained
   for 2 epochs at batch 512 with `mesh=` (the replicas checked after each
   epoch), and 80
   clusters of its latent from the unsharded engine and from the
   row-sharded one, the counters set to 0 just before the sharded run and
   read just after (every shard entry point and `row_stats` launched, the
   index entry points of those kernels not; emission and every attempt's
   sums bit for bit the unsharded engine's), its NCCL collectives tallied
   by kind, calls and bytes an attempt; then the same pair, 80 clusters
   each, at the forced subset scope with attempt lanes on and off
   (`gather_ball_shard` launched, `gather_ball`, `medoid_sweep` and
   `spec_sweep` not; the "ball" collectives logged an attempt) and at
   bfloat16 distances (the bf16 shard variants alone), each bit for bit
   the unsharded engine, counters included; (b) two processes sharing the card
   over gloo (`--dist-rank`; gloo moves each collective through host
   memory): `bin default`'s library path at W = 2 on (a)'s composition
   and abundance (2 epochs at batch 512, 80 clusters), the parameters'
   checksums equal across ranks after every epoch, then the same W = 2
   engine on the CPU over the same group, its first 20 clusters identical
   to the card's; the W = 2
   clusters' agreement with (a)'s W = 1 clusters on sampled pairs; (c) two
   processes sharing the card over gloo (`--dist-engine-rank`) clustering
   phase 5's 300,032-wide latent (in `--dist` mode, where phase 5 does not
   run, the 300,000-point latent of `--engine-ab`) at the engine's default
   flags, so "auto" takes the subset wander and attempt lanes, 80
   clusters: the two ranks' clusters identical, the subset wander, lanes
   and `gather_ball_shard` run, and each rank's first 20 identical to the
   same W = 2 engine's on the CPU. A rank that fails or outlives its 420 s
   fails the phase; its children are killed. The same kernel checks and
   times at F_pad 288 (the AAE's 283-wide z latent, the kernels' generic
   width): the three shard sweeps, their bf16 variants and
   `gather_ball_shard` (KB 64) on the shards of 100,096 columns over 1, 2
   and 4 ranks. (d) a world of one on NCCL on 20,000 contigs of phase 4's
   recipe with phase 8's annotation: Taxometer (4 x 512, batch 1,024, 2
   epochs), VAEVAE (512-512-32, batch 256, 1 epoch) and the AAE (547 / 283
   / 700, batch 256, 1 epoch) each trained without a mesh and with
   `mesh=`, the replicas checked every epoch and the parameters held to the
   unmeshed training's (Taxometer and the AAE bit for bit, VAEVAE's epoch
   metrics within rtol 1e-3 and its weights within steps x lr); ms a step both ways and the collectives a
   step by kind logged; then the meshed AAE's z latent (degenerate after
   one epoch: a few clusters) clustered by the unsharded and the
   row-sharded engine, and 80 clusters of a 283-wide latent of 200 clumps
   (`wide_latent`) likewise at full scope, forced subset and bfloat16, each
   bit for bit (emission and sums), the shard entry points launched at
   F_pad 288 alone and, at full scope, the index entry points not at all; (e) two processes sharing the card over gloo
   (`--dist-main-rank`), each joining the group and then calling `main`
   for `taxometer`, `bin taxvamb` on rank 0's refined TSV and `bin avamb`
   at (d)'s widths on (d)'s data (batch 1,024, one epoch each, 50 clusters
   a `bin`): each rank's
   parameter checksums equal every epoch, rank 0's artifacts and TSVs read
   back, `.proc1` removed, and the first 10 z clusters of the W = 2 engine
   on the CPU equal to the card's (all of them where the z latent holds
   fewer), as the first 10 of `wide_latent`'s.
13. C above 32 and `wander_kernel`: (a) `gumbel_topc` (no, some and all
   columns eligible, and a tie key) and `gumbel_topc_shard` (two shards,
   merged) at 8,192, 100,096 and 300,032 columns, and the density kernel,
   its shard entry point and its bf16 variant at those widths and at
   100,096 at F_pad 288, at C 33, 40, 64 and 100: each bit for bit its
   plain version on the card, its launches a call counted by the library
   (`device_launches`) and its wrapper (ceil(C / 32) for the Gumbel
   kernel, one for the density kernel); both timed at C 40 and 64 beside
   their bounds, plain versions and, for `gumbel_topc`, `gumbel_scores` +
   `torch.topk`; (b) the slice's path: the engine at maxsteps 40 and 64 on
   phase 4's latent (in `--maxsteps` mode a synthetic 100,000-point one),
   at full scope (6 clusters) and at the subset scope with attempt lanes
   on (25), card vs CPU in lockstep as in phase 4 (scores and candidates
   different in no step, every cluster identical), the counters set to 0
   just before each run and read just after (the Gumbel kernel ceil(C /
   32) launches a wander step, the library's counts the wrappers'); (c)
   `wander_kernel` "auto", "pallas", "xla", "xla", "pallas", "auto" on the
   card on the same latent at its defaults: ms a cluster, device kernels a
   cluster, hand-written launches a cluster (none under "xla"), and one
   emission; (d) "pallas" with maxsteps 40 and with bfloat16 distances
   refused with ValueError.
14. the work counters and the workflow: (a) the engine's counters
   (`n_dists`, `n_dists_effective`, `emitted_total`, `dist_terms`) on
   every card-vs-CPU lockstep run (phases 4, 9, 11 and 13(b)): where the
   two emitted alike, the effective count and the emitted total must be
   equal and the raw counts must differ by the kernels' terms alone (one
   row more a full-scope wander step, seven fewer a subset final row),
   exactly while both sums are below 2^31; and phase 10(c)'s timed windows
   on the 300,000-point latent logged in the system's headline unit:
   raw and effective dists, clusters decided, clusters/s and effective
   dists/s. (b) the documented workflow on the port: three sample
   assemblies of 3,000 contigs from phase 7's recipe (its synthetic
   genomes carrying its 40 marker profiles); `python -m
   vamb_torch.tools.concatenate` as a subprocess; workflow_avamb/
   run_local_torch.py (`--mock-mapping --epochs 1`: mock BAMs, `bin avamb`
   at 547 / 283 / 700 with `-c 1000`, `avamb_ensemble --write_bins
   --hmm_path` with the profiles and its quality gates open, as phase 9's),
   the counters set to 0 just before and read just after; and
   `python -m vamb_torch.tools.create_fasta` on the z clusters as a
   subprocess. Gates: every subprocess exits 0; the catalogue's names
   `S{n}C{name}`; every bin file holds exactly its cluster's contigs;
   `quality_report.tsv` and `Final_bins/` written, with its bins' FASTAs;
   `gumbel_topc`,
   `candidate_density_sweep`, `medoid_sweep`, `spec_sweep` (the library's
   own counts and the wrappers') and `hmm_forward` launched; the
   catalogue's TNF projected on the card (`use_device=True`) equal to
   `bin avamb`'s host-path `composition.npz` but where the two products'
   float32 roundings straddle a mask step (at most one step of the row's
   largest value, under 1% of the values).

Each kernel's launches x (ms - bound) on each path, summed over widths, is
logged after phase 6. The last three lines of standard output are the
kernels JSON object (its `launches` are the 300,000-contig path's, and
phase 7's for `hmm_forward`; each row also holds every timed width under
`at_widths` and phase 8's launches; the rows with `f_pad` 288 are the
matrix kernels at the z latent's width, with phase 9's launches; the rows
with `dtype` "bfloat16" are the bf16 variants, one a timed width, with
phase 11's launches; the rows with `entry_point_of` are the shard entry
points, with phase 12(a)'s launches, and at `f_pad` 288 12(d)'s; the rows
with `c` are `gumbel_topc` and the density kernel at C 40 and 64, with
phase 13(b)'s launches at that maxsteps), the card's `nvidia-smi` name and
power limit, and `{"ok": true, "device": ...}`.

    python3 chip_smoke.py --kernels

runs phases 1 and 2 alone: the short first call after a kernel changes.

    python3 chip_smoke.py --recluster

runs phase 1, the Forward kernel's check and times, and phase 7.

    python3 chip_smoke.py --taxonomy

runs phase 1 and phase 8.

    python3 chip_smoke.py --avamb

runs phase 1, phase 2 at F_pad 288 and phase 9.

    python3 chip_smoke.py --bf16

runs phase 1, phase 2's checks and times of the bf16 variants, phase 4's
`bin default` (the f32 latent and clusters phase 11 compares with; no
profile, no card-vs-CPU run) and phase 11.

    python3 chip_smoke.py --dist

runs phase 1 and phase 12 (about 5 minutes).

    python3 chip_smoke.py --maxsteps

runs phase 1 and phase 13 (about 2 minutes after the build).

    python3 chip_smoke.py --workflow

runs phase 1 and phase 14(b), then 14(a) on the workflow's own 283-wide z
latent: 30 clusters (or 60 wander steps) card vs CPU in lockstep.

    python3 chip_smoke.py --lanes

runs phase 1, phase 2's checks and times of `spec_sweep` and `row_stats`
(F_pad 32 and 288) and phase 10.

    python3 chip_smoke.py --engine-ab DIR [DIR ...]

times the clustering engine of each checkout DIR in turn, each in a
process of its own, on one synthetic 300,000-point latent at subset
scope (list a parent and a change alternately, e.g. P C C P), and prints
one JSON line per run: ms per cluster over 200 clusters, device kernels
a cluster and an attempt over 50 more, and a hash of the emitted medoids,
which must agree between checkouts that emit alike.

    python3 chip_smoke.py --stage-ab DIR [DIR ...]

times `bin default`'s clustering stage, the engine at its default flags
to `-c` clusters, at 100,000 contigs (full scope, 2,000 clusters) and
300,000 (subset wander, lanes, a compaction; 3,200 clusters), each
checkout DIR in turn in a process of its own, on the latents of this
checkout's `bin default` on phases 4 and 5's datasets; prints one JSON
line per run: seconds, clusters/s, the lane and subset counts, the work
counters where the checkout keeps them, and a hash of the medoids, which
must agree between all checkouts.

    python3 chip_smoke.py --density-layouts

builds layout variants of the density kernel (threads a CTA, columns a
thread, chunk buffers, the chunk loop unrolled) beside the committed one,
and times each at every
path width for several candidate-group counts, each held bit for bit
against its plain version: the measurement behind the committed layout.

    python3 chip_smoke.py --layouts [SOURCE]

does the same for the gather (copies a thread), for `medoid_sweep` (its
most CTAs, which fixes its summation order) and for `spec_sweep` and
`row_stats` (`BATCH_LAYOUTS`) at the widths the main paths give them,
with unchecked diagnostic variants that show where the time goes. With
SOURCE, a `cluster_kernels.cu` of another checkout (say the parent's,
unpacked by `git archive` under `chip_scratch/`), it builds and times
that source's `spec_sweep` and `row_stats` layouts alone.
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

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s, and f32 operations/s
# outside the tensor cores for FMA-free code. The data sheet's 67 TFLOP/s
# counts an FMA as two operations; the kernels never fuse a multiply and an
# add (bit-identical distances), so each FMUL or FADD is one instruction a
# lane and the card issues them at half that: 33.5e12 a second.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
# int32 operations: 64 a clock an SM (the CUDA programming guide's throughput
# table, compute capability 9.0), 132 SMs at the 1,980 MHz boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# The Gumbel kernel's work a column: the threefry hash's 20 rounds of an add,
# a rotate (one funnel shift) and a xor, its 5 two-add key injections, the
# initial adds and the final xor, and the unit float's shift and or: 75 int32
# operations; the two logs and the score's adds: about 55 f32 operations;
# d, kept and tried read: 6 bytes (`gumbel_topc` writes only its C
# candidates; the scores stay in registers)
GUMBEL_INT_OPS, GUMBEL_F32_OPS, GUMBEL_READ_BYTES = 75, 55, 6

N_CONTIGS = 100_000
N_GENOMES = 1_000
N_SAMPLES = 6
BIG_CONTIGS = 300_000  # above the subset wander's 262,144-column floor
BIG_PAD = -(-BIG_CONTIGS // 128) * 128  # 300,032 columns
BIG_HALF = BIG_PAD // 2 // 128 * 128  # 150,016: the ladder's first width
BIG_GENOMES = 3_000
BIG_CLUSTERS = 3200  # the compaction at cluster 3,072, then 128 clusters at full scope
F_PAD = 32  # the latent width 32, padded to a multiple of 8
AAE_F_PAD = 288  # the AAE's z latent, 283 wide, padded to a multiple of 8
MAXSTEPS = 25  # the engine's candidates per wander step
BALL_KB = 64  # blocks of 128 columns in a subset ball (Q = 8,192)
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


def time_ms(fn, iters: int = 30, cold_l2: bool = True, warmup: int = 5) -> float:
    """Device ms of one call of `fn`, the median over `iters` calls after
    `warmup` calls, from CUDA events around each call. Before each call the card
    sleeps ~2 ms, so the host has queued the whole call when the start
    event fires and the span holds device time only. With `cold_l2`, a
    64 MiB buffer is overwritten first, so the call finds the 50 MB L2
    cold; without it, the call finds its inputs where the last one left
    them, as the engine's back-to-back wander steps do."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") if cold_l2 else None
    for _ in range(warmup):
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


def host_us(fn, iters: int = 500) -> float:
    """Host-clock us a call of `fn` over `iters` calls back to back, with a
    synchronize at the end: the host's issue cost where it exceeds the
    device's time, as in the engine's launch-bound steps."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e6


def bound(nbytes: float, nops: float, int_ops: float = 0.0) -> tuple[float, str]:
    """Least ms for the work: bytes over HBM rate vs f32 ops over the FMA-free
    rate and int32 ops over the int32 rate, whichever of those two is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(nops / F32_OPS_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
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


# phase 2's widths at F_pad 32: the 100k path's and an unpadded one; the
# 300k path's before and after its compaction (the density pass-1 grid is
# capped at 300,032 columns, so its blocks stride); a subset ball's. At
# F_pad 288, the width phase 9 clusters at (the generic code of every matrix
# kernel): the 100k path's and an unpadded one. The gather takes whole
# 128-column blocks: padded widths only.
CHECK_WIDTHS = {
    F_PAD: {"dens": (N_CONTIGS, N_CONTIGS + 3, BIG_PAD, BIG_HALF, BALL_KB * 128),
            "sweep": (N_CONTIGS + 3, -(-N_CONTIGS // 128) * 128, BIG_HALF, BIG_PAD),
            "gather": (-(-N_CONTIGS // 128) * 128, BIG_PAD),
            "batch": (BALL_KB * 128, N_CONTIGS + 3, -(-N_CONTIGS // 128) * 128, BIG_HALF, BIG_PAD)},
    AAE_F_PAD: {"dens": (-(-N_CONTIGS // 128) * 128, N_CONTIGS + 3),
                "sweep": (-(-N_CONTIGS // 128) * 128, N_CONTIGS + 3),
                "gather": (-(-N_CONTIGS // 128) * 128,),
                "batch": (-(-N_CONTIGS // 128) * 128,)},
}
SPEC_SEEDS = 8  # the seed cache's slots: the most rows spec_sweep and row_stats take


def check_kernels(dev, f_pad: int = F_PAD) -> dict:
    """Phase 2's checks at F_pad `f_pad`, at CHECK_WIDTHS: `row_sweep` and
    `candidate_density_sweep` (C 1, 25 and 32, int64 and int32 ids, all and
    half the weights) bit for bit against their plain versions;
    `medoid_sweep`'s row, histogram, density and close count bit for bit
    (all and half the weights); the gather array-equal; at F_pad 32 also
    the Gumbel kernels, which read no matrix. Returns max|err| by kernel."""
    from vamb_torch import kernels as K

    widths = CHECK_WIDTHS[f_pad]
    err_row = 0.0
    err_dens = 0.0
    for n in widths["dens"]:
        mT = torch.as_tensor(clumpy_matrixT(n, f_pad, seed=n), device=dev)
        for idx in (0, 37, n - 1):
            d = K.row_sweep(mT, idx)
            p = K.row_sweep_plain(mT, idx)
            torch.cuda.synchronize()
            e = float((d - p).abs().max())
            if not (torch.equal(d, p) and float(d[idx]) == 0.0 and bool(torch.isfinite(d).all())):
                raise AssertionError(f"row_sweep F_pad {f_pad} n={n} idx={idx}: max|d-plain|={e}, "
                                     f"d[idx]={float(d[idx])}")
            err_row = max(err_row, e)
        rng = np.random.default_rng(n)
        for zero_half in (False, True):
            w = torch.as_tensor(weights(n, seed=n, zero_half=zero_half), device=dev)
            for c in (1, 25, 32):
                cand = torch.as_tensor(rng.choice(n, size=c, replace=False), device=dev)
                dens = K.candidate_density_sweep(mT, cand, w)
                dens32 = K.candidate_density_sweep(mT, cand.to(torch.int32), w)
                plain = K.candidate_density_plain(mT, cand, w)
                torch.cuda.synchronize()
                e = float((dens - plain).abs().max())
                ok = torch.equal(dens, plain) and torch.equal(dens32, dens)
                if not (ok and bool(torch.isfinite(dens).all())):
                    raise AssertionError(
                        f"candidate_density_sweep F_pad {f_pad} n={n} C={c} zero_half={zero_half}: "
                        f"max abs err {e}, dens {dens.tolist()} vs {plain.tolist()}"
                    )
                err_dens = max(err_dens, e)
    err_sweep = 0.0
    for n in widths["sweep"]:
        mT = torch.as_tensor(clumpy_matrixT(n, f_pad, seed=n), device=dev)
        for zero_half in (False, True):
            w = torch.as_tensor(weights(n, seed=n + 1, zero_half=zero_half), device=dev)
            for idx in (0, 37, n - 1):
                got = K.medoid_sweep(mT, idx, w)
                expect = K.medoid_sweep_plain(mT, idx, w)
                torch.cuda.synchronize()
                e = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, expect))
                same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, expect))
                if not (same and torch.equal(got[0], K.row_sweep(mT, idx)) and float(got[0][idx]) == 0.0):
                    raise AssertionError(
                        f"medoid_sweep F_pad {f_pad} n={n} idx={idx} zero_half={zero_half}: "
                        f"max|kernel-plain| {e}, hist {got[1].tolist()} vs {expect[1].tolist()}, "
                        f"density {float(got[2])} vs {float(expect[2])}, n_close {int(got[3])} vs "
                        f"{int(expect[3])}")
                err_sweep = max(err_sweep, e)
    errs = {"row_sweep": err_row, "candidate_density_sweep": err_dens,
            "gather_blocks": check_gather(dev, widths["gather"], f_pad), "medoid_sweep": err_sweep,
            **check_batch(dev, f_pad)}
    log(f"kernels at F_pad {f_pad} agree with their plain versions (max|err| {json.dumps(errs)}): "
        "row_sweep (bit-identical, d[idx] == 0) and candidate_density_sweep (bit-identical, C 1, 25 "
        "and 32, int64 and int32 ids, all and half the weights) at N "
        f"{', '.join(map(str, widths['dens']))}; medoid_sweep (row, histogram, density and close "
        "count bit-identical, row equal to row_sweep's, all and half the weights) at N "
        f"{', '.join(map(str, widths['sweep']))}; gather_blocks and gather_ball array-equal "
        f"(padding slots, repeated ids) at N {', '.join(map(str, widths['gather']))}")
    if f_pad == F_PAD:
        errs["gumbel_topc"] = check_gumbel(dev)
        log("gumbel_scores bit-identical and gumbel_topc's candidates, validity and scores "
            f"array-equal at N {', '.join(map(str, PATH_WIDTHS))}, no, some and all columns eligible "
            f"and tie keys {TIE_STEPS}, C 1, {MAXSTEPS} and 32, one launch a call")
    return errs


def check_batch(dev, f_pad: int = F_PAD) -> dict:
    """`spec_sweep` at S 1, 3 and 8 and `row_stats` on its rows at F_pad
    `f_pad` and CHECK_WIDTHS' "batch" widths, all and half the weights: bit
    for bit their plain versions on the card and, column by column,
    `medoid_sweep`'s row and sums; the near count that of the kept columns
    within 0.05; one launch a call. Returns max|err| by kernel."""
    from vamb_torch import kernels as K

    widths = CHECK_WIDTHS[f_pad]["batch"]
    err = {"spec_sweep": 0.0, "row_stats": 0.0}
    for n in widths:
        mT = torch.as_tensor(clumpy_matrixT(n, f_pad, seed=n + 2), device=dev)
        rng = np.random.default_rng(n)
        for zero_half in (False, True):
            w = torch.as_tensor(weights(n, seed=n + 3, zero_half=zero_half), device=dev)
            for s in (1, 3, SPEC_SEEDS):
                cols = [int(c) for c in rng.choice(n, s, replace=False)]
                cols[0] = n - 1
                before = (K.spec_sweep.launches, K.row_stats.launches)
                got = K.spec_sweep(mT, cols, w)
                stats = K.row_stats(got[0], w)
                plain = K.spec_sweep_plain(mT, cols, w)
                plain_stats = K.row_stats_plain(got[0], w)
                torch.cuda.synchronize()
                check((K.spec_sweep.launches, K.row_stats.launches) == (before[0] + 1, before[1] + 1),
                      "spec_sweep / row_stats: not one launch a call")
                label = f"F_pad {f_pad} n={n} S={s} zero_half={zero_half}"
                for name, a, b in zip(("rows", "hist", "density", "n_close", "n_near"), got, plain):
                    err["spec_sweep"] = max(err["spec_sweep"], float((a.double() - b.double()).abs().max()))
                    if not (a.dtype == b.dtype and torch.equal(a, b)):
                        raise AssertionError(f"spec_sweep {label}: {name} differs from the plain version")
                for name, a, b, c in zip(("hist", "density", "n_close", "n_near"), stats, plain_stats,
                                         got[1:]):
                    err["row_stats"] = max(err["row_stats"], float((a.double() - b.double()).abs().max()))
                    if not (torch.equal(a, b) and torch.equal(a, c)):
                        raise AssertionError(f"row_stats {label}: {name} differs from the plain version "
                                             "or from spec_sweep's")
                for j, col in enumerate(cols):
                    if not all(torch.equal(g[j], m) for g, m in zip(got, K.medoid_sweep(mT, col, w))):
                        raise AssertionError(f"spec_sweep {label}: row {j} (column {col}) differs from "
                                             "medoid_sweep's")
                check(torch.equal(got[4], ((got[0] <= 0.05) & (w > 0)).sum(1).to(torch.int32)),
                      f"spec_sweep {label}: near counts")
    log(f"spec_sweep (S 1, 3 and 8) and row_stats on its rows at F_pad {f_pad}: bit for bit their plain "
        "versions and, column by column, medoid_sweep's row, histogram, density and close count; near "
        f"counts exact; all and half the weights; one launch a call; at N {', '.join(map(str, widths))} "
        f"(max|err| {json.dumps(err)})")
    return err


def gumbel_inputs(n: int, dev, seed: int, mask: str = "some"):
    """A wander step's inputs at width n: a key from the engine's split
    chain, distances, kept and tried flags leaving no, some or all columns
    eligible, and a medoid."""
    from vamb_torch.utils import threefry

    rng = np.random.default_rng(seed)
    key = threefry.split_host(threefry.split_host(threefry.key(seed))[0])[1]
    d = rng.random(n).astype(np.float32) * 0.1
    kept, tried = rng.random(n) < 0.8, rng.random(n) < 0.1
    if mask == "none":
        kept[:] = False
    elif mask == "all":
        d[:], kept[:], tried[:] = 0.0, True, False
    return (key, *(torch.as_tensor(a, device=dev) for a in (d, kept, tried)), int(rng.integers(n)))


# steps of the engine's chain `key, k1 = split(key)` from PRNGKey(0) whose
# top 25 of 8,192 scores, every column eligible but column 0, hold a tie
TIE_STEPS = (745, 1603)


def tie_key(step: int):
    "k1 of step `step` of the PRNGKey(0) chain."
    from vamb_torch.utils import threefry

    key = threefry.PRNGKey(0)
    for _ in range(step + 1):
        key, k1 = threefry.split_host(key)
    return k1


def check_gumbel(dev) -> float:
    """`gumbel_scores` and `gumbel_topc` against their plain versions at
    every width the wander draws at (`PATH_WIDTHS`), with no, some and all
    columns eligible and at the tie keys (every column eligible but column
    0): the scores bit for bit (as int32 bit patterns), `gumbel_topc`'s
    candidates and their validity array-equal at C 1, 25 and 32, its
    optional scores bit for bit; one launch a call."""
    from vamb_torch import kernels as K

    cases = []
    for n in PATH_WIDTHS:
        for i, mask in enumerate(("none", "some", "all")):
            cases.append((n, mask, *gumbel_inputs(n, dev, seed=n + i, mask=mask)))
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        for step in TIE_STEPS:
            cases.append((n, f"tie key {step}", tie_key(step), torch.zeros(n, device=dev), ones, ~ones, 0))
    ties = 0
    for n, label, key, d, kept, tried, medoid in cases:
        before = K.gumbel_scores.launches
        got = K.gumbel_scores(key, d, kept, tried, medoid)
        expect = K.gumbel_scores_plain(key, d, kept, tried, medoid)
        torch.cuda.synchronize()
        check(K.gumbel_scores.launches == before + 1, "gumbel_scores: not one launch a call")
        if not torch.equal(got.view(torch.int32), expect.view(torch.int32)):
            bad = int((got.view(torch.int32) != expect.view(torch.int32)).sum())
            raise AssertionError(f"gumbel_scores n={n} {label}: {bad} scores differ from the plain "
                                 "version's bits")
        eligible = int(torch.isfinite(got).sum())
        want = {"none": eligible == 0, "some": 0 < eligible < n}.get(label, eligible == n - 1)
        check(want, f"gumbel_scores n={n} {label}: {eligible} eligible columns")
        for c in (1, MAXSTEPS, 32):
            before = K.gumbel_topc.launches
            cand, valid, score = K.gumbel_topc(key, d, kept, tried, medoid, c, with_scores=True)
            lean = K.gumbel_topc(key, d, kept, tried, medoid, c)
            cand_p, valid_p = K.gumbel_topc_plain(key, d, kept, tried, medoid, c)
            torch.cuda.synchronize()
            check(K.gumbel_topc.launches == before + 2, "gumbel_topc: not one launch a call")
            same = (torch.equal(cand, cand_p) and torch.equal(valid, valid_p)
                    and torch.equal(lean[0], cand_p) and torch.equal(lean[1], valid_p)
                    and torch.equal(score.view(torch.int32), expect.view(torch.int32)))
            if not same:
                raise AssertionError(
                    f"gumbel_topc n={n} {label} C={c}: candidates {cand.tolist()} valid "
                    f"{valid.tolist()} (without scores {lean[0].tolist()}) vs the plain version's "
                    f"{cand_p.tolist()} {valid_p.tolist()}; scores bit-equal: "
                    f"{torch.equal(score.view(torch.int32), expect.view(torch.int32))}")
            check(int(valid.sum()) == min(c, eligible), f"gumbel_topc n={n} {label} C={c}: validity")
            if label.startswith("tie") and n == PATH_WIDTHS[0] and c == MAXSTEPS:
                ties += int(len(torch.unique(expect[cand_p])) < c)
    check(ties == len(TIE_STEPS), f"{len(TIE_STEPS) - ties} tie keys hold no tie in their top 25")
    return 0.0


def ball_inputs(n: int, dev, seed: int, f: int = F_PAD):
    "A ball's inputs at width n and F_pad f: matrix, weights, kept flags, seed row."
    rng = np.random.default_rng(seed)
    mT = torch.as_tensor(clumpy_matrixT(n, f, seed=n), device=dev)
    w = torch.as_tensor(weights(n, seed=seed), device=dev)
    kept = torch.as_tensor(rng.random(n) < 0.8, device=dev)
    d0 = torch.as_tensor(rng.random(n).astype(np.float32), device=dev)
    return mT, w, kept, d0


def gather_cases(n: int, seed: int) -> list:
    """(block ids, nb) of three balls at width n: all slots valid, a ball
    of 40 blocks and 24 padding slots (which gather block 0), repeated ids."""
    blocks = n // 128
    rng = np.random.default_rng(seed)
    part = BALL_KB * 5 // 8
    picked = np.sort(rng.choice(blocks, part, replace=False))
    return [(np.sort(rng.choice(blocks, BALL_KB, replace=False)), BALL_KB),
            (np.concatenate([picked, np.zeros(BALL_KB - part, np.int64)]), part),
            (np.array([5, 0, 0, blocks - 1]), 3)]


def check_gather(dev, widths, f: int) -> float:
    """`gather_blocks` and `gather_ball` against their plain versions at
    `widths` and F_pad f (`gather_cases`)."""
    from vamb_torch import kernels as K

    err = 0.0
    for n in widths:
        mT, w, kept, d0 = ball_inputs(n, dev, seed=n, f=f)
        for ids, nb in gather_cases(n, seed=n + 1):
            bids = torch.as_tensor(ids.astype(np.int32), device=dev)
            g, g_p = K.gather_blocks(mT, bids), K.gather_blocks_plain(mT, bids)
            got = K.gather_ball(mT, bids, nb, w, kept, d0)
            expect = K.gather_ball_plain(mT, bids, nb, w, kept, d0)
            torch.cuda.synchronize()
            same = torch.equal(g, g_p) and all(
                a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, expect))
            if not same:
                raise AssertionError(f"gather n={n} nb={nb} ids={ids[:6]}...: not array-equal "
                                     "to the plain version")
            err = max(err, float((g - g_p).abs().max()), float((got[0] - expect[0]).abs().max()))
    return err


PATH_WIDTHS = (BALL_KB * 128, -(-N_CONTIGS // 128) * 128, BIG_HALF, BIG_PAD)
# why a kernel's library time is null: no single PyTorch call computes its function
LIBRARY_NOTES = {
    "candidate_density_sweep": "none: no single call computes the weighted close-neighbour densities",
    "medoid_sweep": "none: no single call computes the row with its histogram, density and close count",
    "row_stats": "none: no single call computes a row's histogram, density and counts",
    "hmm_forward": "none: no single call computes the Forward recurrence",
}


def time_kernels(dev, f_pad: int = F_PAD, widths=PATH_WIDTHS, gather_n: int = BIG_PAD,
                 only=None) -> dict:
    """Times at every width the main paths give each kernel, at F_pad
    `f_pad` (with `only`, of those kernels alone): `row_sweep` and
    `candidate_density_sweep` (C = 25) at a
    subset ball's 8,192 columns, the 100,000-contig path's 100,096, the
    300,000-contig path's 300,032 and, after its compaction, 150,016;
    `medoid_sweep`, `spec_sweep` (S = 8, beside 8 `medoid_sweep` launches
    and the `torch.matmul` of its rows alone) and `row_stats` (S = 8) at
    the last three; `gather_ball` (64 blocks with their
    side vectors, the call the subset wander makes) from `gather_n`
    columns, beside `index_select` of the matrix alone; at F_pad 32,
    `gumbel_topc` (C = 25, some columns eligible; it reads no matrix) at
    all four, beside `gumbel_scores` and `torch.topk` of its scores. Each
    L2 cold and warm. Returns {(name, N_pad): {"ms", "plain_ms",
    "library_ms", "bound", and the same with an "_l2_warm" suffix}}.
    Logged beside them: `gather_blocks` (the matrix alone), an empty kernel
    (the harness's launch floor) and `gumbel_topc` and its yardstick on
    the host's clock."""
    from vamb_torch import kernels as K

    out = {}
    for n in widths:
        mT = torch.as_tensor(clumpy_matrixT(n, f_pad, seed=5), device=dev)
        w = torch.as_tensor(weights(n, seed=5), device=dev)
        cand = torch.as_tensor(np.random.default_rng(5).choice(n, MAXSTEPS, replace=False),
                               device=dev)
        idx = 37
        col = mT[:, idx].contiguous()
        mTt = mT.T  # a (N, F) view: torch.mv reads the same bytes
        f = mT.shape[0]
        kept = w > 0
        n_kept = int(kept.sum())
        c = len(cand)
        # the density's terms that this data needs: every kept (c, n) pair
        # costs F multiplies and F adds and the subtraction from 0.5; pairs
        # within the radius one more subtraction, a multiply and an add
        D = 0.5 - mT[:, cand].T @ mT
        n_within = int(((D <= 0.05) & kept[None, :]).sum())
        fns = {
            "row_sweep": (lambda: K.row_sweep(mT, idx), lambda: K.row_sweep_plain(mT, idx),
                          lambda: torch.mv(mTt, col), bound((f * n + n) * 4, 2 * f * n)),
            "candidate_density_sweep": (
                lambda: K.candidate_density_sweep(mT, cand, w),
                lambda: K.candidate_density_plain(mT, cand, w), None,
                bound((f * n_kept + n + 2 * c) * 4, (2 * f + 1) * c * n_kept + 3 * n_within)),
        }
        if n != PATH_WIDTHS[0]:
            # the row's products and sums, and per kept column a division
            # for its bin, its histogram add, and the density's subtraction,
            # multiply and add where it lies within the radius
            d_row = K.row_sweep(mT, idx)
            near = int(((d_row <= 0.05) & kept).sum())
            in_hist = int(((d_row >= 0) & (d_row <= 0.3) & kept).sum())
            fns["medoid_sweep"] = (
                lambda: K.medoid_sweep(mT, idx, w), lambda: K.medoid_sweep_plain(mT, idx, w), None,
                bound((f * n + 2 * n + 62) * 4, 2 * f * n + n + 2 * in_hist + 3 * near))
            # the seed cache's batch of S rows: each row's work as
            # medoid_sweep's, the matrix and w read once, S rows written; a
            # row's sums alone: the row and w read, the row's work less its dot
            spec_cols = [int(c) for c in np.random.default_rng(6).choice(n, SPEC_SEEDS, replace=False)]
            rows = K.spec_sweep(mT, spec_cols, w)[0]
            in_hist_s = int(((rows >= 0) & (rows <= 0.3) & kept).sum())
            near_s = int(((rows <= 0.05) & kept).sum())
            s_out = SPEC_SEEDS * (60 + 3) * 4  # a row's 60 bins, density and two counts
            feats = mT[:, spec_cols].T.contiguous()
            fns["spec_sweep"] = (
                lambda: K.spec_sweep(mT, spec_cols, w), lambda: K.spec_sweep_plain(mT, spec_cols, w),
                lambda: torch.matmul(feats, mT),
                bound((f * n + n + SPEC_SEEDS * n) * 4 + s_out,
                      SPEC_SEEDS * (2 * f * n + n) + 2 * in_hist_s + 3 * near_s))
            fns["row_stats"] = (
                lambda: K.row_stats(rows, w), lambda: K.row_stats_plain(rows, w), None,
                bound((SPEC_SEEDS * n + n) * 4 + s_out, SPEC_SEEDS * n + 2 * in_hist_s + 3 * near_s))
        if f_pad == F_PAD:
            # the library yardstick of the draw and selection: the step as
            # it was before (the scores written by the same kernel, then topk)
            gkey, gd, gkept, gtried, gmedoid = gumbel_inputs(n, dev, seed=8)
            fns["gumbel_topc"] = (
                lambda: K.gumbel_topc(gkey, gd, gkept, gtried, gmedoid, MAXSTEPS),
                lambda: K.gumbel_topc_plain(gkey, gd, gkept, gtried, gmedoid, MAXSTEPS),
                lambda: torch.topk(K.gumbel_scores(gkey, gd, gkept, gtried, gmedoid), MAXSTEPS),
                bound(GUMBEL_READ_BYTES * n, GUMBEL_F32_OPS * n, GUMBEL_INT_OPS * n))
        if n == gather_n:
            mTg, wg, keptg, d0g = ball_inputs(n, dev, seed=6, f=f_pad)
            bids = torch.as_tensor(np.sort(np.random.default_rng(6).choice(n // 128, BALL_KB, replace=False))
                                   .astype(np.int32), device=dev)
            q = BALL_KB * 128
            # the matrix's blocks read and written, the ids, and per slot
            # w, kept and d0 read and its id, flag, weight and d0 written
            fns["gather_blocks"] = (
                lambda: K.gather_ball(mTg, bids, BALL_KB, wg, keptg, d0g),
                lambda: K.gather_ball_plain(mTg, bids, BALL_KB, wg, keptg, d0g),
                lambda: mTg.view(f, n // 128, 128).index_select(1, bids),
                bound((2 * f * q + BALL_KB) * 4 + q * 22, 0))
        for name, (kern, plain, lib, bnd) in fns.items():
            if only is not None and name not in only:
                continue
            r = {"bound": bnd}
            for sfx, cold in (("", True), ("_l2_warm", False)):
                r["ms" + sfx] = time_ms(kern, cold_l2=cold)
                r["plain_ms" + sfx] = time_ms(plain, cold_l2=cold)
                r["library_ms" + sfx] = None if lib is None else time_ms(lib, cold_l2=cold)
            if name == "spec_sweep":  # the eight launches it replaces
                r["eight_medoid_sweeps_ms"] = time_ms(
                    lambda: [K.medoid_sweep(mT, c, w) for c in spec_cols])
            out[(name, n)] = r
            libs = LIBRARY_NOTES.get(name, "none") if lib is None else f"{r['library_ms']:.5f} ms"
            eight = (f", 8 medoid_sweep launches {r['eight_medoid_sweeps_ms']:.5f} ms"
                     if name == "spec_sweep" else "")
            log(f"{name} at F_pad {f}, N_pad {n}: kernel {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, "
                f"library {libs}{eight}, bound {bnd[0] * 1e3:.3f} us ({bnd[1]}), roofline share "
                f"{bnd[0] / r['ms']:.3f}, L2 cold; L2 warm: kernel {r['ms_l2_warm']:.5f} ms, "
                f"plain {r['plain_ms_l2_warm']:.5f} ms")
        if "gumbel_topc" in fns and (only is None or "gumbel_topc" in only):
            # the engine is launch-bound: what a step's draw and selection
            # costs the host, back to back, beside the step as it was
            kern, _, lib, _ = fns["gumbel_topc"]
            log(f"gumbel_topc at N_pad {n}, back to back: {host_us(kern):.2f} us a call on the "
                f"host's clock; gumbel_scores + torch.topk {host_us(lib):.2f} us")
        if n == gather_n and only is None:  # the matrix alone, and the launch floor of this harness
            log(f"gather_blocks (the matrix alone) at F_pad {f_pad}, N_pad {n}, KB {BALL_KB}: "
                f"{time_ms(lambda: K.gather_blocks(mTg, bids)):.5f} ms; an empty kernel "
                f"(torch.cuda._sleep(0), the launch floor) {time_ms(lambda: torch.cuda._sleep(0)):.5f} ms; "
                "L2 cold")
    return out


# ------------------------------------------- phase 2: the bf16 variants

# the kernels that read the matrix on a bfloat16 engine's path, each with a
# variant for a bf16 matrix; their checks' widths (the main paths', an
# unaligned one and a subset ball's at F_pad 32, the 100k path's at 288)
# and their times' (phase 11's 100,096, and the 300k path's two, at F_pad
# 32; 100,096 at 288)
BF16_KERNELS = ("medoid_sweep", "spec_sweep", "candidate_density_sweep")
BF16_CHECK_WIDTHS = {F_PAD: (BALL_KB * 128, N_CONTIGS + 3, -(-N_CONTIGS // 128) * 128, BIG_HALF, BIG_PAD),
                     AAE_F_PAD: (-(-N_CONTIGS // 128) * 128,)}
BF16_TIME_WIDTHS = {F_PAD: PATH_WIDTHS[1:], AAE_F_PAD: (PATH_WIDTHS[1],)}


def check_bf16(dev) -> dict:
    """The bf16 variants of `medoid_sweep` (columns 0, 37, N - 1),
    `spec_sweep` (S 1, 3 and 8) and `candidate_density_sweep` (C 1, 25 and
    32, int64 and int32 ids) on a bf16 matrix at BF16_CHECK_WIDTHS, all and
    half the weights: bit for bit the f32 kernel on the widened matrix and
    the plain version on the card, one launch a call, tallied as
    "bfloat16". Returns max|kernel - plain| by kernel (0 where equal)."""
    from vamb_torch import kernels as K

    err = dict.fromkeys(BF16_KERNELS, 0.0)

    def held(name, label, got, f32, plain):
        for a, b, c in zip(got, f32, plain):
            err[name] = max(err[name], float((a.double() - c.double()).abs().max()))
            if not (a.dtype == b.dtype == c.dtype and torch.equal(a, b) and torch.equal(a, c)):
                raise AssertionError(f"{name} bf16 {label}: differs from the f32 kernel on the widened "
                                     f"matrix ({torch.equal(a, b)}) or the plain version ({torch.equal(a, c)})")

    def one_bf16_launch(kernel, fn, n):
        # NaN in the blocks the caching allocator hands out next, so a
        # kernel that leaves part of its output unwritten cannot pass on a
        # freed block that held the right values
        for shape in ((n,), (SPEC_SEEDS, n), (1, n), (3, n)):
            torch.full(shape, float("nan"), device=dev)
        before = kernel.launches_by_dtype.get("bfloat16", 0)
        out = fn()
        check(kernel.launches_by_dtype.get("bfloat16", 0) == before + 1,
              f"{kernel.__name__} bf16: not one launch tallied as bfloat16 a call")
        return out

    for f_pad, widths in BF16_CHECK_WIDTHS.items():
        for n in widths:
            mT = torch.as_tensor(clumpy_matrixT(n, f_pad, seed=n + 4), device=dev).to(torch.bfloat16)
            wide = mT.float()
            rng = np.random.default_rng(n + 5)
            for zero_half in (False, True):
                w = torch.as_tensor(weights(n, seed=n + 6, zero_half=zero_half), device=dev)
                label = f"F_pad {f_pad} n={n} zero_half={zero_half}"
                for idx in (0, 37, n - 1):
                    got = one_bf16_launch(K.medoid_sweep, lambda: K.medoid_sweep(mT, idx, w), n)
                    held("medoid_sweep", f"{label} idx={idx}", got, K.medoid_sweep(wide, idx, w),
                         K.medoid_sweep_plain(mT, idx, w))
                for s in (1, 3, SPEC_SEEDS):
                    cols = [int(c) for c in rng.choice(n, s, replace=False)]
                    cols[0] = n - 1
                    got = one_bf16_launch(K.spec_sweep, lambda: K.spec_sweep(mT, cols, w), n)
                    held("spec_sweep", f"{label} S={s}", got, K.spec_sweep(wide, cols, w),
                         K.spec_sweep_plain(mT, cols, w))
                for c in (1, MAXSTEPS, 32):
                    cand = torch.as_tensor(rng.choice(n, c, replace=False), device=dev)
                    for ids in (cand, cand.to(torch.int32)):
                        got = one_bf16_launch(K.candidate_density_sweep,
                                              lambda: K.candidate_density_sweep(mT, ids, w), n)
                        held("candidate_density_sweep", f"{label} C={c} {ids.dtype}", (got,),
                             (K.candidate_density_sweep(wide, ids, w),),
                             (K.candidate_density_plain(mT, ids, w),))
    torch.cuda.synchronize()
    log(f"bf16 variants on a bf16 matrix: medoid_sweep (columns 0, 37, N - 1), spec_sweep (S 1, 3, 8) and "
        f"candidate_density_sweep (C 1, {MAXSTEPS}, 32; int64 and int32 ids) bit for bit the f32 kernels "
        "on the widened matrix and their plain versions, all and half the weights, one launch a call, "
        f"at {json.dumps({f: list(w) for f, w in BF16_CHECK_WIDTHS.items()})} (max|err| {json.dumps(err)})")
    return err


def spec_library(feats: torch.Tensor, mT: torch.Tensor):
    """`spec_sweep`'s library yardstick on bf16 operands: the (S, F) x (F, N)
    product summed in f32, `torch.mm(..., out_dtype=torch.float32)`, where
    the card's PyTorch has `aten::mm.dtype` for CUDA; else the bf16-output
    `torch.matmul`. Returns (call, what it is)."""
    try:
        torch.mm(feats, mT, out_dtype=torch.float32)
        return (lambda: torch.mm(feats, mT, out_dtype=torch.float32),
                "torch.mm(rows, matrixT, out_dtype=torch.float32) on bf16 operands, rows alone (no sums)")
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda: torch.matmul(feats, mT),
                "torch.matmul on bf16 operands, bf16 output (aten::mm.dtype absent), rows alone")


def time_bf16(dev) -> dict:
    """Each bf16 variant at BF16_TIME_WIDTHS, L2 cold, beside its bound
    (the matrix's bytes at 2 an element; operations as the f32 kernel's),
    its plain version, the f32 kernel on the widened matrix and, for
    `spec_sweep` (S 8), `spec_library`. `candidate_density_sweep` at C =
    25. Returns {(name, F_pad, N_pad): {"ms", "plain_ms", "f32_ms",
    "library_ms", "library_what", "bound"}}."""
    from vamb_torch import kernels as K

    out = {}
    for f_pad, widths in BF16_TIME_WIDTHS.items():
        for n in widths:
            mT = torch.as_tensor(clumpy_matrixT(n, f_pad, seed=5), device=dev).to(torch.bfloat16)
            wide = mT.float()
            w = torch.as_tensor(weights(n, seed=5), device=dev)
            kept = w > 0
            n_kept = int(kept.sum())
            f = f_pad
            idx = 37
            cand = torch.as_tensor(np.random.default_rng(5).choice(n, MAXSTEPS, replace=False), device=dev)
            c = len(cand)
            D = 0.5 - wide[:, cand].T @ wide
            n_within = int(((D <= 0.05) & kept[None, :]).sum())
            d_row = K.medoid_sweep(mT, idx, w)[0]
            near = int(((d_row <= 0.05) & kept).sum())
            in_hist = int(((d_row >= 0) & (d_row <= 0.3) & kept).sum())
            spec_cols = [int(x) for x in np.random.default_rng(6).choice(n, SPEC_SEEDS, replace=False)]
            rows = K.spec_sweep(mT, spec_cols, w)[0]
            in_hist_s = int(((rows >= 0) & (rows <= 0.3) & kept).sum())
            near_s = int(((rows <= 0.05) & kept).sum())
            s_out = SPEC_SEEDS * (60 + 3) * 4
            lib, lib_what = spec_library(mT[:, spec_cols].T.contiguous(), mT)
            fns = {
                # the f32 kernels' bounds with the matrix at 2 bytes an element
                "medoid_sweep": (lambda: K.medoid_sweep(mT, idx, w), lambda: K.medoid_sweep(wide, idx, w),
                                 lambda: K.medoid_sweep_plain(mT, idx, w), None,
                                 bound(f * n * 2 + (2 * n + 62) * 4, 2 * f * n + n + 2 * in_hist + 3 * near)),
                "spec_sweep": (lambda: K.spec_sweep(mT, spec_cols, w), lambda: K.spec_sweep(wide, spec_cols, w),
                               lambda: K.spec_sweep_plain(mT, spec_cols, w), lib,
                               bound(f * n * 2 + (n + SPEC_SEEDS * n) * 4 + s_out,
                                     SPEC_SEEDS * (2 * f * n + n) + 2 * in_hist_s + 3 * near_s)),
                "candidate_density_sweep": (
                    lambda: K.candidate_density_sweep(mT, cand, w),
                    lambda: K.candidate_density_sweep(wide, cand, w),
                    lambda: K.candidate_density_plain(mT, cand, w), None,
                    bound(f * n_kept * 2 + (n + 2 * c) * 4, (2 * f + 1) * c * n_kept + 3 * n_within)),
            }
            for name, (kern, f32, plain, library, bnd) in fns.items():
                r = {"bound": bnd, "ms": time_ms(kern), "f32_ms": time_ms(f32), "plain_ms": time_ms(plain),
                     "library_ms": None if library is None else time_ms(library),
                     "library_what": lib_what if library is not None else LIBRARY_NOTES[name]}
                out[(name, f_pad, n)] = r
                libs = "" if library is None else f", library {r['library_ms']:.5f} ms ({lib_what})"
                log(f"{name} bf16 at F_pad {f_pad}, N_pad {n}: kernel {r['ms']:.5f} ms, f32 kernel "
                    f"{r['f32_ms']:.5f} ms, plain {r['plain_ms']:.5f} ms{libs}, bound {bnd[0] * 1e3:.3f} us "
                    f"({bnd[1]}), roofline share {bnd[0] / r['ms']:.3f}, L2 cold")
    return out


def launch_gaps(timed: dict, tally: dict) -> dict:
    """Per kernel, the sum over widths of launches x (ms - bound ms), L2
    cold, from one main path's tally {name: {N_pad: launches}}: the time the
    path lost to each kernel beyond its bound, the ranking of kernels to
    redesign. A width that was not timed is listed apart."""
    out = {}
    for name, by_width in tally.items():
        gap, untimed = 0.0, {}
        for n, count in by_width.items():
            t = timed.get((name, n))
            if t is None:
                untimed[n] = count
            else:
                gap += count * (t["ms"] - t["bound"][0])
        out[name] = {"gap_s": gap * 1e-3, "untimed_launches": untimed}
    return out


def sass_counts(lib_path) -> None:
    """Print the instruction counts of each kernel's SASS by opcode family
    (cuobjdump from the CUDA toolkit), for the loads, stores and f32 ops
    that bound the kernels. Skipped where cuobjdump is missing."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("sass counts: cuobjdump not found, not measured")
        return
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120).stdout
    families = ("FADD", "FMUL", "FFMA", "LDG", "LDS", "LDC", "STG", "STS", "SHFL", "ATOM", "RED")
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", chunk)
        counts = {fam: sum(1 for o in ops if o == fam) for fam in families}
        log(f"sass {name[:90]}: {len(ops)} instructions, " + json.dumps({k: v for k, v in counts.items() if v}))


# -------------------------------------------------------- phase 3: engine


def wide_clumps(n_clumps: int, per: int, scale: float, noise_frac: float, seed: int):
    """32-wide latents in clumps wide enough (scale 0.06) that subset
    climbs drift past the ball's guard, plus uniform noise; and lengths."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clumps, 32))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rows = [c + rng.normal(scale=scale, size=(per, 32)) for c in centers]
    rows.append(rng.normal(size=(int(noise_frac * n_clumps * per), 32)))
    m = np.concatenate(rows).astype(np.float32)
    return m, rng.integers(2000, 50_000, len(m)).astype(np.float32)


def check_engine(dev) -> None:
    """The engine on the card emits exactly what it emits on the CPU: at
    full scope, with the subset wander forced, with the compaction ladder
    forced down to 128 columns in batches of 8 clusters, and with the
    subset wander on a 512-column ball (`_SUBSET_Q` patched) over wide
    clumps, where balls overflow and climbs drift, so both fallbacks to
    the full climb run on the card."""
    from vamb_torch import cluster as engine
    from vamb_torch.utils import threefry

    rng = np.random.default_rng(3)
    centers = rng.normal(size=(40, 32))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    m = np.concatenate([c + rng.normal(scale=0.04, size=(30, 32)) for c in centers]).astype(np.float32)
    lengths = rng.integers(2000, 50_000, len(m)).astype(np.float32)
    wide = wide_clumps(40, 30, scale=0.06, noise_frac=0.2, seed=4)
    # label: (latent, lengths, rng seed, generator arguments, patched _SUBSET_Q)
    cases = {
        "full scope": (m, lengths, 3, {}, None),
        "subset wander": (m, lengths, 3, {"wander_scope": "subset"}, None),
        "compaction": (m, lengths, 3, {"compact_min_pad": 128, "batch_clusters": 8}, None),
        "subset wander, 512-column ball": (
            *wide, 13, {"wander_scope": "subset", "windowsize": 120}, 512),
    }
    for label, (mat, lens, seed, kw, subset_q) in cases.items():
        saved_q = engine._SUBSET_Q
        if subset_q is not None:
            engine._SUBSET_Q = subset_q
        try:
            gens = [engine.ClusterGenerator(mat.copy(), lens, rng_seed=seed, device=d, **kw)
                    for d in (dev, "cpu")]
        finally:
            engine._SUBSET_Q = saved_q
        on_card, on_cpu = (list(g) for g in gens)
        if len(on_card) != len(on_cpu):
            raise AssertionError(f"engine, {label}: {len(on_card)} clusters on the card, {len(on_cpu)} on the CPU")
        for i, (a, b) in enumerate(zip(on_card, on_cpu)):
            same = (a.kind_str, a.medoid, a.seed, a.successes, a.attempts, a.radius, a.maximal_pvr) == (
                b.kind_str, b.medoid, b.seed, b.successes, b.attempts, b.radius, b.maximal_pvr
            ) and np.array_equal(a.members, b.members)
            if not same:
                raise AssertionError(f"engine, {label}: cluster {i} differs between the card and the CPU")
        if gens[0].compactions != gens[1].compactions or (label == "compaction" and not gens[0].compactions):
            raise AssertionError(f"engine, {label}: compactions {gens[0].compactions} vs {gens[1].compactions}")
        if gens[0].subset_counts != gens[1].subset_counts or gens[0].lane_counts != gens[1].lane_counts:
            raise AssertionError(f"engine, {label}: subset counts {gens[0].subset_counts} and lane counts "
                                 f"{gens[0].lane_counts} on the card, {gens[1].subset_counts} and "
                                 f"{gens[1].lane_counts} on the CPU")
        if subset_q is not None and not (gens[0].subset_counts["overflow"] > 0
                                         and gens[0].subset_counts["drift"] > 0):
            raise AssertionError(f"engine, {label}: no overflow or no drift fallback ran: "
                                 f"{gens[0].subset_counts}")
        log(f"engine on the card is emission-identical to the CPU engine, {label}: {len(on_card)} clusters "
            f"of {len(mat)} points; compactions {gens[0].compactions}; subset {gens[0].subset_counts}; "
            f"cache and lanes {gens[0].lane_counts}")
    # training eps: XLA's erfinv and log1p transcribed op by op, so the card
    # draws the CPU's bits (and jax's)
    keys = threefry.split(threefry.key(SEED), 64)
    a = threefry.normal_batched(keys, 4096, dev).cpu().numpy()
    b = threefry.normal_batched(keys, 4096, "cpu").numpy()
    ulps = int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())
    log(f"threefry normal on the card vs the CPU: max {ulps} ulps over {a.size} draws")
    check(ulps == 0, f"eps on the card differ from the CPU's by up to {ulps} ulps")


def engine_agreement(dev, latent: np.ndarray, lengths: np.ndarray, n_clusters: int = 50,
                     label: str = "the 100k path's latent", max_steps=None, **engine_kwargs) -> dict:
    """The engine on the card and on the CPU, cluster by cluster in
    lockstep on one latent, both recording the inputs of their decisions:
    each wander step's Gumbel scores (the engine's own, through
    `gumbel_topc`'s optional output), its C candidates in drawn order with
    their validity, the -inf slots included (their order is `jax.lax.top_k`'s
    too), and their densities, and each attempt's histogram and its
    smoothed densities. Counts the clusters emitted alike before the
    first that differs, and for each input how often it differed between
    the two, bit for bit, and by how much at most; names the first that
    did. A latent that holds fewer than `n_clusters` clusters is compared
    to its end: both engines must run out at the same cluster
    (`engines_exhausted`); one running out first is a difference. With
    `max_steps`, the comparison also ends after the cluster in which the
    wander steps compared reach it (`step_cap_reached`): the CPU's plain
    density takes ~0.2 s a step at F_pad 288. `engine_kwargs` go to both
    generators (phase 11's bfloat16 distances). The caller gates on the
    result (phases 4, 9 and 11)."""
    from vamb_torch import cluster as engine

    def instrumented(device):
        gen = engine.ClusterGenerator(latent.copy(), lengths, rng_seed=SEED, device=device,
                                      **engine_kwargs)
        events = []
        step = gen._step
        topc = gen._kernels.gumbel_topc  # the generator's own: the wrapper, or "xla"'s plain version

        def recorded_step(key, d, kept, tried, medoid, n, matrixT, wk):
            out = step(key, d, kept, tried, medoid, n, matrixT, wk)
            events.append(("candidates", torch.stack([out[1], out[2].long()]).cpu()))
            events.append(("candidate densities", out[3].cpu()))
            return out

        def recorded_topc(*args):
            cand, valid, score = topc(*args, with_scores=True)
            events.append(("gumbel scores", score.cpu()))
            return cand, valid

        gen._step = recorded_step
        gen._kernels.gumbel_topc = recorded_topc
        return gen, events

    find_threshold = engine.find_threshold

    def next_cluster(gen, events):
        def recorded(hist, pvr):
            events.append(("histogram", hist.cpu()))
            events.append(("smoothed densities", engine.smooth_histogram(hist).cpu()))
            return find_threshold(hist, pvr)

        events.clear()
        engine.find_threshold = recorded
        try:
            return next(gen, None)
        finally:
            engine.find_threshold = find_threshold

    t = time.time()
    card, cpu = instrumented(dev), instrumented("cpu")
    kinds = ("gumbel scores", "candidates", "candidate densities", "histogram", "smoothed densities")
    differed = {k: 0 for k in kinds}
    seen = {k: 0 for k in kinds}
    gap = {k: 0.0 for k in kinds}
    identical, compared, first_input, first_cluster, exhausted, capped = 0, 0, None, None, False, False
    for i in range(n_clusters):
        a, b = next_cluster(*card), next_cluster(*cpu)
        if a is None and b is None:
            exhausted = True
            break
        compared += 1
        for (kind, x), (kind_b, y) in zip(card[1], cpu[1]):
            if kind != kind_b:
                break
            seen[kind] += 1
            if not torch.equal(x, y):
                differed[kind] += 1
                g = float((x.double() - y.double()).abs().max()) if x.shape == y.shape else None
                gap[kind] = max(gap[kind], g) if g is not None else gap[kind]
                if first_input is None:
                    first_input = {"cluster": i, "input": kind, "max_abs_gap": g}
        same = a is not None and b is not None and (
            a.kind_str, a.medoid, a.seed, a.radius, a.maximal_pvr) == (
            b.kind_str, b.medoid, b.seed, b.radius, b.maximal_pvr) and np.array_equal(a.members, b.members)
        if not same:
            first_cluster = i
            break
        identical += 1
        if max_steps is not None and seen["candidates"] >= max_steps:
            capped = True
            break
    result = {"points": len(latent), "clusters_requested": n_clusters, "clusters_compared": compared,
              "engines_exhausted": exhausted, "step_cap_reached": capped, "identical_clusters": identical,
              "first_differing_cluster": first_cluster, "first_differing_input": first_input,
              "inputs_seen": seen, "inputs_that_differed": differed, "max_abs_gaps": gap,
              "work": work_agreement(card[0], cpu[0]), "seconds": time.time() - t}
    log(f"engine on the card vs the CPU on {label}: " + json.dumps(result))
    # phase 14(a): runs that emitted alike did the same work
    check(result["work"]["ok"] or identical != compared,
          f"phase 14(a): the work counters on {label} differ between the card and the CPU")
    return result


# ------------------------------------------------ phases 4 and 5: main paths


def write_dataset(d: Path, n_contigs: int, n_genomes: int, n_samples: int, seed: int,
                  plant=None) -> np.ndarray:
    """A FASTA of `n_contigs` contigs of 2,000-4,000 bp from `n_genomes`
    planted genomes, and an `n_samples`-sample abundance TSV. Each genome
    draws its sequence as 4-mer words from its own Dirichlet distribution
    (so TNF separates genomes) and has its own abundance profile. Names are
    S{1..3}C{i}, for binsplitting. `plant(genome, lengths)`, if given,
    returns {contig: (offset, bases)} to write over the contigs' sequence
    (the marker genes of phase 7). Returns each contig's genome."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, n_genomes, n_contigs)
    lengths = rng.integers(2000, 4001, n_contigs)
    planted = {} if plant is None else plant(genome, lengths)
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
            seqs = [buf[s : s + ln] for s, ln in zip(starts, lengths[lo:hi])]
            for i in range(lo, hi):
                if i in planted:
                    off, gene = planted[i]
                    seq = seqs[i - lo]
                    seqs[i - lo] = seq[:off] + gene + seq[off + len(gene):]
            f.write(b"".join(
                b">" + names[i].encode() + b"\n" + seq + b"\n"
                for i, seq in zip(range(lo, hi), seqs)
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
    n_contigs = len(genome)
    from vamb_torch.abundance import Abundance
    from vamb_torch.composition import Composition
    from vamb_torch.models import VAE
    from vamb_torch.utils import read_npz

    comp = Composition.load(out / "composition.npz")
    check(comp.matrix.shape == (n_contigs, 103) and np.isfinite(comp.matrix).all(), "composition.npz")
    ab = Abundance.load(out / "abundance.npz", comp.metadata.refhash)
    check(ab.matrix.shape == (n_contigs, N_SAMPLES) and np.isfinite(ab.matrix).all(), "abundance.npz")
    vae = VAE.load(out / "model.npz", device="cpu")
    check(vae.nhiddens == [512, 512] and vae.nlatent == 32 and vae.nsamples == N_SAMPLES, "model.npz")
    latent = read_npz(out / "latent.npz")
    check(latent.shape == (n_contigs, 32) and latent.dtype == np.float32
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
    check(len(clusters) == max_clusters or len(members) == n_contigs, "stopped below the cap with contigs left")
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


def engine_counts(log_lines: list) -> dict:
    """The engine's counters from its run's `Engine:` line in log.txt: the
    subset wander's attempts and fallbacks, and the seed cache's refills,
    the loner bursts and the loners they emitted, and the attempt lanes:
    passes, lanes, lanes admitted and deferred, and the passes cut by each
    of the acceptance scan's reasons (conflict, pvr bump, full climb,
    capacity)."""
    line = next(ln for ln in log_lines if "Engine: subset wander" in ln)
    subset, lanes = re.search(r"subset wander (\{.*?\}); seed cache, bursts and lanes (\{.*\})",
                              line).groups()
    return {"subset": json.loads(subset), "cache_and_lanes": json.loads(lanes)}


def clusters_of(path: Path, n_contigs: int) -> np.ndarray:
    """Each contig's cluster in a clusters TSV (contigs S?C{i}), as an int
    label; a contig in no cluster gets a label of its own (-1 - i)."""
    labels = -1 - np.arange(n_contigs)
    names = {}
    for row in read_tsv(path)[1:]:
        labels[int(row[1].split("C")[1])] = names.setdefault(row[0], len(names))
    return labels


def run_main_path(dev, tmp: Path, n_contigs: int, n_genomes: int, max_clusters: int,
                  required: tuple, epochs: int = 2, agreement: bool = False,
                  profile: bool = True) -> dict:
    """`bin default` through its CLI entry point on a fresh synthetic
    dataset; the launch counters are set to 0 just before and read just
    after, and each kernel in `required` must have launched, the bf16
    variants none. With `agreement`, `engine_agreement` on the path's
    latent follows; with `profile`, `profile_stages`. The result keeps the
    latent, the lengths and each contig's cluster (`clusters_of`) under
    "_latent", "_lengths" and "_labels", for phase 11."""
    from vamb_torch import kernels as K
    from vamb_torch.__main__ import main

    data = tmp / "data"
    data.mkdir()
    t = time.time()
    genome = write_dataset(data, n_contigs, n_genomes, N_SAMPLES, SEED)
    log(f"wrote the synthetic dataset ({n_contigs} contigs, {n_genomes} genomes, "
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
    launches = {k.__name__: k.launches for k in K.KERNELS}
    tally = {k.__name__: dict(sorted(k.launches_by_width.items())) for k in K.KERNELS}
    log(f"bin default on {n_contigs} contigs ran end to end in {wall:.2f} s; kernel launches {launches}")
    log(f"kernel launches by N_pad on the {n_contigs}-contig path: {json.dumps(tally)}")
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"the main path on {n_contigs} contigs never launched {name}")
    bf16 = {k.__name__: k.launches_by_dtype["bfloat16"] for k in K.KERNELS
            if k.launches_by_dtype.get("bfloat16")}
    check(not bf16, f"the f32 main path on {n_contigs} contigs launched bf16 variants: {bf16}")
    checked = check_outputs(out, genome, max_clusters)
    times = stage_times(out / "log.txt")
    times["total_s"] = wall
    times["clusters_per_s"] = checked["clusters"] / times["cluster_write_s"]
    log("stage times: " + json.dumps(times))
    lines = (out / "log.txt").read_text().splitlines()
    compactions = [line.split("| ")[-1].strip() for line in lines if "Compacted the engine matrix" in line]
    for line in compactions:
        log("compaction: " + line)
    engine = engine_counts(lines)
    log(f"the engine on the {n_contigs}-contig path: " + json.dumps(engine))
    from vamb_torch.composition import Composition
    from vamb_torch.utils import read_npz

    latent = read_npz(out / "latent.npz")
    lengths = Composition.load(out / "composition.npz").metadata.lengths
    result = {"launches": launches, "launches_by_width": tally, **checked, "times": times,
              "compactions": compactions, "engine_counts": engine,
              "_latent": latent, "_lengths": lengths,
              "_labels": clusters_of(out / "vae_clusters_unsplit.tsv", n_contigs)}
    if profile:
        result["profile"] = profile_stages(dev, out)
    if agreement:
        result["card_vs_cpu"] = engine_agreement(dev, latent, lengths)
    return result


# ------------------------------------------- phase 2: the Forward kernel

HMM_WIDTHS = (50, 200, 600, 1000)  # profile nodes M in phase 2
HMM_GENES = 256  # genes a timed batch, 30-1,000 residues, padded to 1,024
# phase 7's shape: a batch of 8,192 length-sorted genes (its batch size) of
# 30-1,000 residues, against a profile of M 350 (phase 7's M 100-600)
HMM_BATCH_GENES, HMM_BATCH_M = 8192, 350
HMM_TOL_ABS, HMM_TOL_REL = 1e-3, 1e-5  # bits: |kernel - plain| <= abs + rel * |plain|
# A DP cell (node, residue), as the recurrence needs it in scaled
# probabilities: M's three FMAs and two multiplies (B x tbm, the emission),
# I's FMA and multiply, the delete chain's term multiply, the FMA that folds
# it into the lane's map and the FMA that applies the scan (the maps' slopes
# are the profile's, formed once), and E's add: 11 f32 instructions, no
# transcendental.
HMM_F32_PER_CELL = 11


def random_local_profile(rng, m: int):
    """A random local profile as `hmm_forward` takes it (lom (M, 21), t and
    tbm clamped at -1e30), made with the port's HMMER3 configuration."""
    from vamb_torch.ops import hmm

    def dirichlet(n, k):
        x = rng.gamma(1.0, size=(n, k))
        return x / x.sum(axis=1, keepdims=True)

    trans = np.zeros((m + 1, 7))
    trans[:, 0:3], trans[:, 3:5], trans[:, 5:7] = dirichlet(m + 1, 3), dirichlet(m + 1, 2), dirichlet(m + 1, 2)
    trans[m] = [1.0, 0.0, 0.0, 1.0, 0.0, 1.0, 0.0]
    trans[0, 2] = 0.0
    trans[0, 0:2] /= trans[0, 0:2].sum()
    local = hmm.configure_local(hmm.ProfileHMM("p", dirichlet(m, 20), np.tile(hmm.BACKGROUND, (m, 1)),
                                               trans, 10.0))
    lom = np.zeros((m, 21), np.float32)
    lom[:, :20] = local.lom
    return (lom, np.maximum(local.t, -1e30).astype(np.float32),
            np.maximum(local.tbm, -1e30).astype(np.float32))


def hmm_bound(codes: np.ndarray, m: int) -> tuple[float, str, int]:
    """(bound ms, what bounds it, DP cells) of one launch: its cells are the
    batch's non-null residues times M (the kernel skips null residues and
    stops at each gene's last one); bytes read once and written once."""
    cells = int((codes < 20).sum()) * m
    nbytes = codes.size + 4 * (21 * m + 7 * (m + 1) + m) + 4 * 2 * len(codes)
    return (*bound(nbytes, cells * HMM_F32_PER_CELL), cells)


def hmm_case(m: int, n_genes: int, sort: bool, dev, seed: int):
    """A profile of M nodes and n_genes genes of 30-1,000 residues (the
    first two 30 and 1,000; 3% null residues, mid-sequence included) padded
    to 1,024, length-sorted when `sort`, as tensors on `dev`; and the codes."""
    rng = np.random.default_rng(seed)
    lom, t, tbm = (torch.as_tensor(a, device=dev) for a in random_local_profile(rng, m))
    lengths = np.concatenate([[30, 1000], rng.integers(30, 1001, n_genes - 2)])
    if sort:
        lengths = np.sort(lengths)
    codes = np.full((n_genes, 1024), 20, np.int8)
    for i, n in enumerate(lengths):
        codes[i, :n] = rng.integers(0, 20, n)
        codes[i, :n][rng.random(n) < 0.03] = 20
    return (lom, t, tbm, torch.as_tensor(codes, device=dev),
            torch.as_tensor(lengths.astype(np.float32), device=dev)), codes


def check_and_time_hmm(dev) -> dict:
    """`hmm_forward` against `hmm_forward_plain` on the card within HMM_TOL
    at M in HMM_WIDTHS on 256 genes (`hmm_case`), and on phase 7's shape,
    8,192 length-sorted genes at M 350; then each timed with CUDA events (L2
    cold) beside its bound and the plain version's time (3 calls: it
    launches ~30 ops a residue). No single PyTorch call computes Forward, so
    there is no library time. Keys: M, and "batch" for phase 7's shape."""
    from vamb_torch import kernels as K

    out = {}
    # the 256-gene cases on the inputs of earlier runs (seed M), so their times compare
    cases = [(m, m, HMM_GENES, False, m) for m in HMM_WIDTHS]
    cases.append(("batch", HMM_BATCH_M, HMM_BATCH_GENES, True, 7))
    for key, m, n_genes, sort, seed in cases:
        args, codes = hmm_case(m, n_genes, sort, dev, seed)
        got = K.hmm_forward(*args)
        plain = K.hmm_forward_plain(*args)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        if not (bool(torch.isfinite(got).all())
                and bool(((got - plain).abs() <= HMM_TOL_ABS + HMM_TOL_REL * plain.abs()).all())):
            raise AssertionError(f"hmm_forward M={m}, {n_genes} genes: max |kernel - plain| {err} bits, "
                                 f"outside {HMM_TOL_ABS} + {HMM_TOL_REL} |score|")
        bnd = hmm_bound(codes, m)
        ms = time_ms(lambda: K.hmm_forward(*args), iters=20)
        plain_ms = time_ms(lambda: K.hmm_forward_plain(*args), iters=3, warmup=1)
        out[key] = {"m": m, "genes": n_genes, "ms": ms, "plain_ms": plain_ms, "bound": bnd[:2],
                    "cells": bnd[2], "max_abs_err": err, "max_score": float(plain.abs().max())}
        log(f"hmm_forward at M {m}, {n_genes} {'length-sorted ' if sort else ''}genes of 30-1,000 residues "
            f"({bnd[2]} DP cells): kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bnd[0]:.5f} ms "
            f"({bnd[1]}), roofline share {bnd[0] / ms:.4f}, {bnd[2] / ms / 1e6:.3f} G cells/s; "
            f"max |kernel - plain| {err:.3g} bits (scores up to {out[key]['max_score']:.1f})")
    return out


# -------------------------------------- phase 7: BAM input and recluster

RC_CONTIGS = 20_000
RC_GENOMES = 200
RC_SAMPLES = 3
RC_MARKERS = 40
RC_MERGED_PAIRS = 20
RC_EPOCHS = 10  # two epochs are 117 optimizer steps at 20,000 contigs: too few to cluster
RC_CLUSTERS = 600  # bin default's -c, a cap on the clustering's time
# the padded lengths phase 7's sample of gene batches may sum to: the plain
# Forward takes some 0.5 ms a residue step and profile on the card, so 1,024
# steps x 40 profiles are some 20 s (cut from 2,048 for time)
RC_SAMPLE_PADS = 1024
READ_LEN = 150


def marker_profiles(rng) -> tuple[list, list[str]]:
    """RC_MARKERS synthetic single-copy profiles, M drawn from 100-600, whose
    match states put 0.7 on a random consensus (as tests/test_marker_fidelity
    .py builds them), and their consensus sequences."""
    from vamb_torch.ops import hmm

    aa = np.array(list(hmm.AMINO))
    profiles, consensi = [], []
    for i in range(RC_MARKERS):
        m = int(rng.integers(100, 601))
        cons = "M" + "".join(aa[rng.integers(0, 20, m - 1)])
        match = np.full((m, 20), 0.3 / 19)
        match[np.arange(m), [hmm.AMINO.index(c) for c in cons]] = 0.7
        trans = np.zeros((m + 1, 7))
        trans[:, 0], trans[:, 1], trans[:, 2] = 0.97, 0.015, 0.015
        trans[:, 3], trans[:, 4], trans[:, 5], trans[:, 6] = 0.9, 0.1, 0.9, 0.1
        trans[m] = [1.0, 0.0, 0.0, 1.0, 0.0, 1.0, 0.0]
        trans[0] = [0.985, 0.015, 0.0, 0.9, 0.1, 0.9, 0.1]
        profiles.append(hmm.ProfileHMM(f"SYN{i:03d}", match, np.tile(hmm.BACKGROUND, (m, 1)),
                                       trans, 0.0))
        consensi.append(cons)
    return profiles, consensi


def sample_variant(rng, cons: str) -> str:
    "Each residue the consensus' with probability 0.7, else uniform; keep the M start."
    from vamb_torch.ops import hmm

    keep = rng.random(len(cons)) < 0.7
    other = np.array(list(hmm.AMINO))[rng.integers(0, 20, len(cons))]
    out = np.where(keep, np.array(list(cons)), other)
    out[0] = "M"
    return "".join(out)


def encode_gene(prot: str) -> bytes:
    "One codon a residue (table 11's first in ACGT order; ATG for M), then TAA."
    from vamb_torch.ops.orf import _CODON_TABLE

    codon_of = {}
    for i in range(64):
        codon_of.setdefault(chr(_CODON_TABLE[i]), "ACGT"[i // 16] + "ACGT"[(i // 4) % 4] + "ACGT"[i % 4])
    codon_of["M"] = "ATG"
    return ("".join(codon_of[c] for c in prot) + "TAA").encode()


def revcomp(s: bytes) -> bytes:
    return s[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))


def calibrate_cutoffs(rng, profiles, consensi, dev) -> None:
    """HMMER-style trusted cutoffs, as tests/test_marker_fidelity.py sets
    them: the lowest score of 16 held-out variants less 0.5 bits, which
    must clear 16 random background proteins of the same length."""
    from vamb_torch.ops import hmm

    aa = np.array(list(hmm.AMINO))
    for prof, cons in zip(profiles, consensi):
        local = hmm.configure_local(prof)
        true = hmm.forward_scores(local, [sample_variant(rng, cons) for _ in range(16)], device=dev)
        bg = hmm.forward_scores(local, ["M" + "".join(aa[rng.integers(0, 20, len(cons) - 1)])
                                        for _ in range(16)], device=dev)
        prof.trusted_cutoff = float(true.min()) - 0.5
        check(prof.trusted_cutoff > bg.max(), f"{prof.name}: background overlaps the true members")


def marker_planter(rng, consensi):
    """plant(genome, lengths) for `write_dataset`: each genome carries one
    fresh variant of each marker, each on another of its contigs at a
    random offset, every other one on the reverse strand. Records the
    truth {contig: {marker ids}}."""
    truth: dict = {}

    def plant(genome, lengths):
        out = {}
        for g in range(RC_GENOMES):
            contigs = rng.permutation(np.flatnonzero(genome == g))
            for m, c in enumerate(contigs[:RC_MARKERS]):
                gene = encode_gene(sample_variant(rng, consensi[m]))
                if (g + m) % 2:
                    gene = revcomp(gene)
                off = int(rng.integers(0, int(lengths[c]) - len(gene) + 1))
                out[int(c)] = (off, gene)
                truth[int(c)] = {m}
        return out

    return plant, truth


def write_bams(d: Path, lengths: np.ndarray, genome: np.ndarray, seed: int) -> list[Path]:
    """RC_SAMPLES BAMs in tests/bamgen.py's format (one gzip member; 150M
    reads with an NM tag, no sequence), by vectorised numpy: each genome
    has a depth a sample (mean about 3x); each contig draws Poisson(depth x
    length / 150) reads at uniform positions."""
    import gzip

    rng = np.random.default_rng(seed)
    profile = rng.lognormal(0.0, 0.8, (RC_GENOMES, RC_SAMPLES))
    profile *= 3.0 / profile.mean()
    names = [f"S{1 + i % 3}C{i}".encode() for i in range(len(lengths))]
    header = [b"BAM\1", np.int32(11).tobytes(), b"@HD\tVN:1.6\n", np.int32(len(names)).tobytes()]
    for name, ln in zip(names, lengths):
        header += [np.int32(len(name) + 1).tobytes(), name + b"\0", np.int32(ln).tobytes()]
    rec = np.dtype([("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"), ("l_name", "u1"),
                    ("mapq", "u1"), ("bin", "<u2"), ("n_cigar", "<u2"), ("flag", "<u2"),
                    ("l_seq", "<i4"), ("next_ref", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4"),
                    ("name", "S2"), ("cigar", "<u4"), ("tag", "S3"), ("nm", "<i4")])
    paths = []
    for s in range(RC_SAMPLES):
        depth = profile[genome, s] * rng.uniform(0.7, 1.3, len(lengths))
        counts = rng.poisson(depth * lengths / READ_LEN)
        ref = np.repeat(np.arange(len(lengths)), counts)
        r = np.zeros(len(ref), rec)
        r["block_size"] = rec.itemsize - 4
        r["ref_id"] = ref
        r["pos"] = (rng.random(len(ref)) * (lengths[ref] - READ_LEN + 1)).astype(np.int32)
        r["l_name"], r["mapq"], r["n_cigar"] = 2, 60, 1
        r["next_ref"], r["next_pos"] = -1, -1
        r["name"], r["cigar"], r["tag"] = b"r", READ_LEN << 4, b"NMi"
        r["nm"] = rng.integers(0, 6, len(ref))
        paths.append(d / f"sample{s}.bam")
        paths[-1].write_bytes(gzip.compress(b"".join(header) + r.tobytes(), compresslevel=1))
    return paths


def pairwise_precision(bins: dict, genome: np.ndarray) -> float:
    "Of the contig pairs that share a bin, the share that share a planted genome."
    same_bin = same_both = 0
    for members in bins.values():
        ids = np.array([int(c.split("C")[1]) for c in members])
        same_bin += len(ids) * (len(ids) - 1) // 2
        same_both += sum(int(k) * (int(k) - 1) // 2 for k in np.bincount(genome[ids]))
    return same_both / same_bin if same_bin else 1.0


def read_bins(path: Path, n_contigs: int) -> dict:
    """A clusters TSV read back with the port's reader: each contig in at
    most one bin, and in exactly one when `n_contigs` is given."""
    from vamb_torch.utils import read_clusters

    with open(path) as f:
        bins = read_clusters(f)
    members = [c for b in bins.values() for c in b]
    check(len(members) == len(set(members)) > 0, f"{path.name}: a contig in two bins, or none")
    check(n_contigs is None or len(members) == n_contigs, f"{path.name}: not every contig binned")
    return bins


def compare_marker_calls(encoded, profiles) -> dict:
    """Fault check at scale: the card's marker calls against the plain
    version's. Scores every one of phase 7's encoded gene batches against
    every profile with `hmm_forward`, then picks the sample by content: the
    batch of the longest genes, then the batches with the most of the
    kernel's marker calls (score >= the profile's trusted cutoff), as long
    as the sample's padded lengths sum to at most RC_SAMPLE_PADS (the plain
    version's time goes with them). Scores the sample again with
    `hmm_forward` and with `hmm_forward_plain`, both on the card. Counts the
    scores outside the tolerance band (must be 0), the marker calls that
    differ while the plain score lies outside the band around the cutoff
    (must be 0), and the genes whose plain score lies inside that band; and
    gives the largest |kernel - plain| / band."""
    from vamb_torch import kernels as K
    from vamb_torch.ops import hmm

    t0 = time.time()
    tensors = [hmm.profile_tensors(hmm.configure_local(p), encoded.device) for p in profiles]
    per_batch = torch.zeros(len(encoded.batches), dtype=torch.int64, device=encoded.device)
    for (lom, t, tbm), prof in zip(tensors, profiles):
        per_batch += torch.stack([(K.hmm_forward(lom, t, tbm, seqs, lengths, nres) >= prof.trusted_cutoff).sum()
                                  for _, seqs, lengths, nres in encoded.batches])
    per_batch = per_batch.cpu().numpy()
    pads = [int(seqs.shape[1]) for _, seqs, _, _ in encoded.batches]
    picks = [len(pads) - 1]
    for b in np.argsort(-per_batch, kind="stable"):
        if b not in picks and sum(pads[i] for i in picks) + pads[b] <= RC_SAMPLE_PADS:
            picks.append(int(b))
    picks.sort()
    r = {"batches": [int(encoded.batches[b][1].shape[0]) for b in picks], "pads": [pads[b] for b in picks],
         "kernel_calls_in_sample": int(per_batch[picks].sum()), "kernel_calls_in_all": int(per_batch.sum()),
         "profiles": len(profiles), "scores": 0, "outside_tolerance": 0, "max_abs_err": 0.0,
         "worst_err_over_band": 0.0, "calls": 0, "calls_differ": 0, "calls_differ_outside_band": 0,
         "near_cutoff": 0}
    for (lom, t, tbm), prof in zip(tensors, profiles):
        cut = prof.trusted_cutoff
        for b in picks:
            _, seqs, lengths, nres = encoded.batches[b]
            got = K.hmm_forward(lom, t, tbm, seqs, lengths, nres)
            plain = K.hmm_forward_plain(lom, t, tbm, seqs, lengths)
            band = HMM_TOL_ABS + HMM_TOL_REL * plain.abs()
            near = (plain - cut).abs() <= band
            differ = (got >= cut) != (plain >= cut)
            r["scores"] += int(plain.numel())
            r["outside_tolerance"] += int(((got - plain).abs() > band).sum())
            r["max_abs_err"] = max(r["max_abs_err"], float((got - plain).abs().max()))
            r["worst_err_over_band"] = max(r["worst_err_over_band"], float(((got - plain).abs() / band).max()))
            r["calls"] += int((plain >= cut).sum())
            r["calls_differ"] += int(differ.sum())
            r["calls_differ_outside_band"] += int((differ & ~near).sum())
            r["near_cutoff"] += int(near.sum())
    r["seconds"] = time.time() - t0
    log("phase 7 marker calls, card kernel vs plain version on the card: " + json.dumps(r))
    check(r["outside_tolerance"] == 0, "phase 7: Forward scores outside the tolerance band")
    check(r["calls_differ_outside_band"] == 0, "phase 7: marker calls differ outside the tolerance band")
    return r


def run_recluster_path(dev, tmp: Path) -> dict:
    """Phase 7: `bin default --bamfiles` on RC_CONTIGS contigs from
    RC_GENOMES genomes carrying RC_MARKERS planted marker genes, then
    `recluster` k-means (markers predicted with --hmm_path, on the run's own
    clusters; then with the saved markers on the planted genomes with
    RC_MERGED_PAIRS pairs merged) and DBSCAN (--no_predictor, genera of 2-5
    genomes), all through the CLI entry points on the card. The launch
    counters are set to 0 just before and read just after."""
    from vamb_torch import kernels as K
    from vamb_torch.__main__ import main
    from vamb_torch.markers import Markers
    from vamb_torch.ops import hmm

    times = {}
    t = time.time()
    rng = np.random.default_rng(SEED + 7)
    profiles, consensi = marker_profiles(rng)
    calibrate_cutoffs(rng, profiles, consensi, dev)
    data = tmp / "data"
    data.mkdir()
    (data / "markers.hmm").write_text("".join(hmm.format_hmm(p) for p in profiles))
    plant, truth = marker_planter(rng, consensi)
    genome = write_dataset(data, RC_CONTIGS, RC_GENOMES, RC_SAMPLES, SEED + 7, plant=plant)
    with open(data / "contigs.fna", "rb") as f:
        from vamb_torch.utils import byte_iterfasta

        lengths = np.array([len(r.sequence) for r in byte_iterfasta(f, None)])
    bams = write_bams(data, lengths, genome, SEED + 8)
    names = [f"S{1 + i % 3}C{i}" for i in range(RC_CONTIGS)]
    with open(data / "merged.tsv", "w") as f:  # the planted genomes, 20 pairs merged
        f.write("clustername\tcontigname\n")
        f.writelines(f"g{g // 2 if g < 2 * RC_MERGED_PAIRS else g}\t{n}\n" for g, n in zip(genome, names))
    genus, g = {}, 0
    while g < RC_GENOMES:  # genera of 2-5 genomes
        size = int(rng.integers(2, 6))
        genus.update({x: len(set(genus.values())) for x in range(g, min(g + size, RC_GENOMES))})
        g += size
    with open(data / "taxonomy.tsv", "w") as f:
        f.write("contigs\tpredictions\n")
        f.writelines(f"{n}\tBacteria;P;C;O;F;G{genus[int(x)]};S{int(x)}\n" for x, n in zip(genome, names))
    times["write_inputs_s"] = time.time() - t
    log(f"phase 7 inputs: {RC_CONTIGS} contigs from {RC_GENOMES} genomes, {len(truth)} planted marker "
        f"genes of {RC_MARKERS} profiles (M {min(p.m for p in profiles)}-{max(p.m for p in profiles)}), "
        f"{RC_SAMPLES} BAMs of {sum(p.stat().st_size for p in bams) / 1e6:.1f} MB, "
        f"{len(set(genus.values()))} genera, in {times['write_inputs_s']:.1f} s")

    out = tmp / "bin"
    fasta = str(data / "contigs.fna")
    K.reset_launch_counts()
    t0 = time.time()
    main(["bin", "default", "--outdir", str(out), "--fasta", fasta, "--bamfiles", *map(str, bams),
          "-e", str(RC_EPOCHS), "-q", "1", "-c", str(RC_CLUSTERS), "--seed", str(SEED)],
         device=str(dev))
    torch.cuda.synchronize()
    times["bin_default_s"] = time.time() - t0
    times["bin_default_stages"] = stage_times(out / "log.txt")
    runs = {}
    encoded, encoded_cls = [], hmm.EncodedProteins

    class recorded_encoded(encoded_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            encoded.append(self)

    common = ["--fasta", fasta, "--latent_path", str(out / "latent.npz"), "--seed", str(SEED)]
    for label, argv in (
        ("kmeans_own", ["--algorithm", "kmeans", "--hmm_path", str(data / "markers.hmm"),
                        "--clusters_path", str(out / "vae_clusters_unsplit.tsv")]),
        ("kmeans_merged", ["--algorithm", "kmeans", "--markers", str(tmp / "kmeans_own" / "markers.npz"),
                           "--clusters_path", str(data / "merged.tsv")]),
        ("dbscan", ["--algorithm", "dbscan", "--markers", str(tmp / "kmeans_own" / "markers.npz"),
                    "--taxonomy", str(data / "taxonomy.tsv"), "--no_predictor"]),
    ):
        t1 = time.time()
        # keep the encoded gene batches the marker pipeline builds, for the
        # comparison with the plain version after the counters are read
        hmm.EncodedProteins = recorded_encoded
        try:
            main(["recluster", "--outdir", str(tmp / label), *common, *argv], device=str(dev))
        finally:
            hmm.EncodedProteins = encoded_cls
        torch.cuda.synchronize()
        times[f"{label}_s"] = time.time() - t1
        logtext = (tmp / label / "log.txt").read_text()
        found = re.search(r"Processed markers in ([\d.]+) seconds", logtext)
        times[f"{label}_markers_s"] = float(found.group(1)) if found else None
        genes = re.search(r"(\d+) candidate genes \((\d+) residues\) found in ([\d.]+) s, encoded in "
                          r"([\d.]+) s, scored against \d+ profiles on \S+ in ([\d.]+) s", logtext)
        if genes:
            times[f"{label}_genes"], times[f"{label}_residues"] = int(genes.group(1)), int(genes.group(2))
            times[f"{label}_orf_s"], times[f"{label}_encode_s"], times[f"{label}_forward_s"] = (
                float(genes.group(k)) for k in (3, 4, 5))
        n_in = None if label == "kmeans_own" else RC_CONTIGS  # -c leaves contigs unclustered
        runs[label] = {kind: read_bins(tmp / label / f"clusters_reclustered_{kind}.tsv", n_in)
                       for kind in ("unsplit", "split")}
    wall = time.time() - t0
    launches = {"hmm_forward": K.hmm_forward.launches, **{k.__name__: k.launches for k in K.KERNELS}}
    log(f"phase 7 path ran in {wall:.1f} s; kernel launches {launches}")
    check(launches["hmm_forward"] > 0 and launches["gumbel_topc"] > 0,
          "phase 7 never launched hmm_forward or gumbel_topc")
    check(len(encoded) == 1, f"phase 7 encoded {len(encoded)} gene sets, not one")
    calls = compare_marker_calls(encoded[0], profiles)

    # the predicted markers against the planted truth
    markers = Markers.load(tmp / "kmeans_own" / "markers.npz", None)
    check([n[0] for n in markers.marker_names] == [p.name for p in profiles], "marker names")
    tp = fp = fn = 0
    for i, got in enumerate(markers.markers):
        got = set() if got is None else {int(x) for x in got}
        want = truth.get(i, set())
        tp, fp, fn = tp + len(got & want), fp + len(got - want), fn + len(want - got)
    precision, recall = tp / max(tp + fp, 1), tp / max(tp + fn, 1)
    log(f"markers against the planted truth: precision {precision:.4f}, recall {recall:.4f} "
        f"(tp {tp}, fp {fp}, fn {fn})")
    check(precision >= 0.9 and recall >= 0.8, "marker precision or recall below 0.9 / 0.8")

    before = {"kmeans_own": read_bins(out / "vae_clusters_unsplit.tsv", None),
              "kmeans_merged": read_bins(data / "merged.tsv", RC_CONTIGS)}
    result = {"launches": launches, "marker_precision": precision, "marker_recall": recall,
              "marker_calls_vs_plain": calls, "times": times, "wall_s": wall}
    for label, bins in before.items():
        p_in, p_out = pairwise_precision(bins, genome), pairwise_precision(runs[label]["unsplit"], genome)
        log(f"recluster {label}: {len(bins)} bins in, {len(runs[label]['unsplit'])} out; pairwise "
            f"precision against the planted genomes {p_in:.4f} -> {p_out:.4f}")
        check(p_out >= p_in, f"recluster {label} lowered the pairwise precision")
        result[label] = {"bins_in": len(bins), "bins_out": len(runs[label]["unsplit"]),
                         "precision_in": p_in, "precision_out": p_out}
    bin_of = {c: b for b, members in runs["kmeans_merged"]["unsplit"].items() for c in members}
    split = 0
    for k in range(RC_MERGED_PAIRS):
        homes = []
        for g in (2 * k, 2 * k + 1):
            owned = [bin_of[names[i]] for i in np.flatnonzero(genome == g)]
            homes.append(max(set(owned), key=owned.count))
        split += homes[0] != homes[1]
    result["merged_pairs_split"] = split
    result["dbscan"] = {"bins": len(runs["dbscan"]["unsplit"]),
                        "precision": pairwise_precision(runs["dbscan"]["unsplit"], genome)}
    log(f"merged pairs that came back split: {split} of {RC_MERGED_PAIRS}; dbscan "
        f"{result['dbscan']['bins']} bins, pairwise precision {result['dbscan']['precision']:.4f}")
    log("phase 7 stage times: " + json.dumps(times))
    return result


# ------------------------------------------------- phase 8: the taxonomy path

TAX_RANKS = ("d", "p", "c", "o", "f", "g", "s")
TAX_PROBE_ROWS = 4096  # contigs on which the card's predictor is held to the CPU's
TAX_NEAR = 1e-5  # a probability this close to the 0.5 threshold may refine either way


def write_taxonomy(path: Path, genome: np.ndarray, seed: int) -> tuple[list, np.ndarray]:
    """A taxonomy of the planted genomes as an MMseqs2 annotation gives one:
    one species a genome; genera of 2-5 genomes, families of 2-5 genera,
    orders of 2-5 families, classes of 2-4 orders, phyla of 2-4 classes;
    one domain. 70% of contigs are labelled to species, 20% are cut to a
    random higher rank (domain to genus) and 10% have no label. Returns the
    genomes' full lineages and each contig's label depth (0: none)."""
    rng = np.random.default_rng(seed)
    n_genomes = int(genome.max()) + 1

    def group(n: int, lo: int, hi: int) -> np.ndarray:
        "Consecutive groups of lo..hi members over n items: each item's group."
        out, g, i = np.empty(n, int), 0, 0
        while i < n:
            size = int(rng.integers(lo, hi + 1))
            out[i : i + size] = g
            g, i = g + 1, i + size
        return out

    genus = group(n_genomes, 2, 5)
    family = group(genus.max() + 1, 2, 5)
    order = group(family.max() + 1, 2, 5)
    klass = group(order.max() + 1, 2, 4)
    phylum = group(klass.max() + 1, 2, 4)
    lineages = []
    for g in range(n_genomes):
        ge = genus[g]
        fa = family[ge]
        orr = order[fa]
        cl = klass[orr]
        lineages.append(["d__Bacteria", f"p__P{phylum[cl]}", f"c__C{cl}", f"o__O{orr}",
                         f"f__F{fa}", f"g__G{ge}", f"s__S{g}"])
    u = rng.random(len(genome))
    depth = np.where(u < 0.7, 7, np.where(u < 0.9, rng.integers(1, 7, len(genome)), 0))
    with open(path, "w") as f:
        f.write("contigs\tpredictions\n")
        f.writelines(f"S{1 + i % 3}C{i}\t{';'.join(lineages[g][:k])}\n"
                     for i, (g, k) in enumerate(zip(genome, depth)))
    return lineages, depth


def taxonomy_stage_times(logfile: Path) -> dict:
    text = logfile.read_text()
    pats = {
        "taxometer_train_s": r"Trained the taxonomy predictor in ([\d.]+) seconds",
        "taxometer_predict_s": r"Predicted the taxonomy in ([\d.]+) seconds",
        "vaevae_train_s": r"Trained VAEVAE in ([\d.]+) seconds",
        "vaevae_encode_s": r"Encoded the joint latent in ([\d.]+) seconds",
        "cluster_write_s": r"Wrote cluster file\(s\) in ([\d.]+) seconds",
    }
    out = {}
    for k, p in pats.items():
        m = re.search(p, text)
        if m is not None:
            out[k] = float(m.group(1))
    return out


def predictor_card_vs_cpu(model_path: Path, ds, threshold: float = 0.5) -> dict:
    """The trained predictor on the card and on the CPU, on the first
    TAX_PROBE_ROWS contigs: the largest probability difference, and the
    refined lineages (nodes above the threshold) that differ, each of which
    must have a probability within TAX_NEAR of the threshold."""
    from vamb_torch.models.taxometer import Taxometer

    x = np.concatenate((ds.depths, ds.tnf, ds.abundance), axis=1)[:TAX_PROBE_ROWS]
    probs = {}
    for where in ("cuda", "cpu"):
        model = Taxometer.load(model_path, device=where)
        probs[where] = model.probabilities(torch.as_tensor(x, device=model.device)).cpu().numpy()
    card, cpu = probs["cuda"], probs["cpu"]
    near = (np.abs(card - threshold) <= TAX_NEAR) | (np.abs(cpu - threshold) <= TAX_NEAR)
    differ = (card > threshold) != (cpu > threshold)
    rows_differ = differ.any(axis=1)
    explained = (~differ | near).all(axis=1)
    result = {"rows": int(len(x)), "max_abs_diff": float(np.abs(card - cpu).max()),
              "lineages_differ": int(rows_differ.sum()),
              "lineages_differ_near_threshold": int((rows_differ & explained).sum()),
              "probabilities_near_threshold": int(near.sum())}
    log("phase 8 predictor, card vs CPU: " + json.dumps(result))
    check(result["max_abs_diff"] <= 1e-5, "phase 8: the card's Taxometer probabilities differ "
          f"from the CPU's by {result['max_abs_diff']}")
    check(explained.all(), "phase 8: a refined lineage differs between card and CPU away from "
          "the threshold")
    return result


def profile_taxonomy_training(dev, out: Path, targets: np.ndarray, nodes, parents) -> dict:
    """Optimizer steps of Taxometer (4 x 512, batch 1,024, its published
    width; 40 steps) and VAEVAE (512-512-32, batch 256; 10 steps) under
    torch.profiler, on the path's own data: ms and device kernels a step,
    busy share, top ops."""
    from vamb_torch.abundance import Abundance
    from vamb_torch.composition import Composition
    from vamb_torch.models import make_dataset
    from vamb_torch.models.dataset import num_batches
    from vamb_torch.models.taxometer import Taxometer
    from vamb_torch.models.vaevae import VAEVAE

    comp = Composition.load(out / "composition.npz")
    ab = Abundance.load(out / "abundance.npz", comp.metadata.refhash)
    result = {}
    # Taxometer: 40 steps (two epochs of 20 batches of 1,024). VAEVAE: 10
    # steps of 256, as many device kernels as 40 of Taxometer's: the
    # profiler's trace analysis costs the host ~0.5 ms an event (83 s for
    # 100 VAEVAE steps, 23 s for 25, on the NVIDIA H100 80GB HBM3
    # (700.00 W) machine's host)
    for label, rows, bs, epochs in (("taxometer", 1024 * 20, 1024, 2), ("vaevae", 256 * 10, 256, 1)):
        ds = make_dataset(ab.matrix[:rows], comp.matrix[:rows], comp.metadata.lengths[:rows])
        if label == "taxometer":
            model = Taxometer(N_SAMPLES, len(nodes), nodes, parents, nhiddens=[512] * 4,
                              seed=SEED, device=dev)
        else:
            model = VAEVAE(N_SAMPLES, len(nodes), nodes, parents, hier_loss="flat_softmax",
                           seed=SEED, device=dev)

        def train_epoch():
            model.trainmodel(ds, targets[:rows], nepochs=epochs, batchsize=bs, batchsteps=None)
            return epochs * num_batches(ds.n_obs, bs)

        result[label] = profiled(train_epoch, f"{label} training")
    return result


def run_taxonomy_path(dev, tmp: Path, bin_default_precision=None) -> dict:
    """Phase 8: `taxometer`, then `bin taxvamb` on its refined TSV, through
    the CLI entry points on the card at 100,000 contigs (write_dataset's
    phase 4 data and `write_taxonomy`'s partial annotation)."""
    from vamb_torch import kernels as K
    from vamb_torch.__main__ import main
    from vamb_torch.abundance import Abundance
    from vamb_torch.composition import Composition
    from vamb_torch.models import make_dataset
    from vamb_torch.models.dataset import VAEDataset
    from vamb_torch.models.taxometer import Taxometer
    from vamb_torch.models.vaevae import VAEVAE
    from vamb_torch.pipeline import targets_from_taxonomy
    from vamb_torch.taxonomy import PredictedTaxonomy, Taxonomy
    from vamb_torch.utils import read_npz

    data = tmp / "data"
    data.mkdir()
    t = time.time()
    genome = write_dataset(data, N_CONTIGS, N_GENOMES, N_SAMPLES, SEED)
    lineages, depth = write_taxonomy(data / "taxonomy.tsv", genome, SEED)
    log(f"phase 8 inputs: {N_CONTIGS} contigs from {N_GENOMES} genomes; labelled to species "
        f"{np.mean(depth == 7):.3f}, cut higher {np.mean((depth > 0) & (depth < 7)):.3f}, "
        f"unlabelled {np.mean(depth == 0):.3f}; written in {time.time() - t:.1f} s")
    common = ["--fasta", str(data / "contigs.fna"), "--abundance_tsv", str(data / "abundance.tsv"),
              "--seed", str(SEED)]
    out_tm, out_tv = tmp / "taxometer", tmp / "taxvamb"

    t = time.time()
    main(["taxometer", "--outdir", str(out_tm), *common, "--taxonomy", str(data / "taxonomy.tsv"),
          "-pe", "4", "-pt", "1024", "-ploss", "flat_softmax"], device=str(dev))
    torch.cuda.synchronize()
    wall_tm = time.time() - t
    refined = out_tm / "results_taxometer.tsv"
    K.reset_launch_counts()
    t = time.time()
    main(["bin", "taxvamb", "--outdir", str(out_tv), *common, "--taxonomy", str(refined),
          "-e", "2", "-q", "1", "-c", "2000"], device=str(dev))
    torch.cuda.synchronize()
    wall_tv = time.time() - t
    launches = {k.__name__: k.launches for k in K.KERNELS}
    tally = {k.__name__: dict(sorted(k.launches_by_width.items())) for k in K.KERNELS}
    log(f"phase 8: taxometer ran in {wall_tm:.2f} s, bin taxvamb in {wall_tv:.2f} s; "
        f"kernel launches in bin taxvamb {launches}")
    for name in ("candidate_density_sweep", "medoid_sweep", "gumbel_topc"):
        check(launches[name] > 0, f"phase 8: bin taxvamb never launched {name}")
    check("already-refined" in (out_tv / "log.txt").read_text(),
          "phase 8: bin taxvamb did not read the refined taxonomy as refined")

    # every artifact read back with the port's own loaders
    t_checks = time.time()
    comp = Composition.load(out_tv / "composition.npz")
    ab = Abundance.load(out_tv / "abundance.npz", comp.metadata.refhash)
    check(comp.nseqs == N_CONTIGS and ab.matrix.shape == (N_CONTIGS, N_SAMPLES), "phase 8 inputs")
    scored = PredictedTaxonomy.parse_tax_file(refined, False)
    check([name for name, _ in scored] == list(comp.metadata.identifiers),
          "results_taxometer.tsv: rows other than the composition's contigs")
    refined_tax = Taxonomy.from_refined_file(refined, comp.metadata, False)
    predictor = Taxometer.load(out_tm / "predictor_model.npz", device="cpu")
    check(predictor.nhiddens == [512] * 4 and predictor.hier_loss_name == "flat_softmax",
          "predictor_model.npz")
    given = Taxonomy.from_file(data / "taxonomy.tsv", comp.metadata, False)
    nodes, _, parents, targets = targets_from_taxonomy(given.contig_taxonomies)
    check(predictor.nodes == nodes, "predictor_model.npz: another tree than the input's")
    vaevae = VAEVAE.load(out_tv / "vaevae_model.npz", device="cpu")
    check(vaevae.nhiddens == [512, 512] and vaevae.nlatent == 32
          and vaevae.hier_loss_name == "flat_softmax", "vaevae_model.npz")
    latent = read_npz(out_tv / "vaevae_latent.npz")
    check(latent.shape == (N_CONTIGS, 32) and latent.dtype == np.float32
          and np.isfinite(latent).all() and not (latent.view(np.uint32) & 0xFFF).any(),
          "vaevae_latent.npz: (N, 32) finite float32 with 12 low mantissa bits masked")
    bins = read_bins(out_tv / "vaevae_clusters_unsplit.tsv", None)
    split = read_bins(out_tv / "vaevae_clusters_split.tsv", None)
    meta = read_tsv(out_tv / "vaevae_clusters_metadata.tsv")
    check(sorted(c for b in bins.values() for c in b) == sorted(c for b in split.values() for c in b),
          "vaevae_clusters: split and unsplit TSVs hold other contigs")
    check(len(bins) == len(meta) - 1 <= 2000, "vaevae_clusters_metadata.tsv rows")
    precision = pairwise_precision(bins, genome)

    # the trained predictor on the card and on the CPU
    full = make_dataset(ab.matrix, comp.matrix, comp.metadata.lengths)
    probe = VAEDataset(*(a[:TAX_PROBE_ROWS] for a in full))
    card_vs_cpu = predictor_card_vs_cpu(out_tm / "predictor_model.npz", probe)

    # genus accuracy of the refined taxonomy on the contigs that had no label
    unlabelled = np.flatnonzero(depth == 0)
    right = sum(
        1 for i in unlabelled
        if (t := refined_tax.contig_taxonomies[i]) is not None and len(t.ranks) > 5
        and t.ranks[5] == lineages[genome[i]][5]
    )
    refined_depths = np.bincount([0 if t is None else len(t.ranks)
                                  for t in refined_tax.contig_taxonomies], minlength=8)
    times = taxonomy_stage_times(out_tm / "log.txt")
    times.update({k: v for k, v in taxonomy_stage_times(out_tv / "log.txt").items()
                  if k not in times})
    times.update({"taxometer_total_s": wall_tm, "bin_taxvamb_total_s": wall_tv})
    result = {
        "launches": launches, "launches_by_width": tally, "clusters": len(bins),
        "clustered_contigs": sum(len(b) for b in bins.values()),
        "precision_taxvamb": precision, "precision_bin_default_100k": bin_default_precision,
        "genus_accuracy_unlabelled": right / len(unlabelled), "unlabelled": int(len(unlabelled)),
        "refined_depths": refined_depths.tolist(), "predictor_card_vs_cpu": card_vs_cpu,
        "times": times,
    }
    log(f"phase 8: {len(bins)} taxvamb clusters, pairwise precision {precision:.4f} (bin default "
        f"at 100k: {bin_default_precision}); refined genus right on "
        f"{result['genus_accuracy_unlabelled']:.4f} of {len(unlabelled)} unlabelled contigs; "
        f"refined lineage depths {refined_depths.tolist()}")
    times["checks_s"] = time.time() - t_checks
    log("phase 8 stage times: " + json.dumps(times))
    result["profile"] = profile_taxonomy_training(dev, out_tv, targets, nodes, parents)
    return result


# ------------------------------------------------- phase 9: the Avamb path

# the AAE's published widths (hidden, z, y) and batch size
AAE_WIDTH_ARGS = ("--n_aae", "547", "--z_aae", "283", "--y_aae", "700", "--t_aae", "256")
AAE_EPOCHS = 2  # published 70, batch doubling at 25 and 50; here at 1
AAE_CLUSTERS = 2000  # -c, as phase 4
AAE_PROBE_ROWS = 4096  # contigs on which the card's encode is held to the CPU's
# mu: |card - CPU| <= 1e-5 x max |mu| (a norm-wise relative error: the
# f32 sums of 547-wide layers run in other orders on each); y: the margin
# of the top two probabilities inside which the argmax may differ
AAE_ENCODE_TOL = 1e-5
# 25 until the full run neared its limit: their analysis took 14 s on
# the NVIDIA H100 80GB HBM3 (700.00 W) machine's host
AAE_PROFILE_STEPS = 10
# wander steps after which the card-vs-CPU engine comparison may end (at the
# end of a cluster): phase 4's 50 clusters hold ~200; 100 (cut from 250,
# then 150) keeps the full run, phase 12 included, inside its time limit
# on a slow host
AAE_AGREEMENT_STEPS = 50
# the ensemble's quality gates: the cut's bins are far from near-complete
# (the AAE's z latent after 2 epochs holds a few giant clusters), so every
# bin enters, and dereplication and ripping resolve the z and y bins' overlaps
ENSEMBLE_GATES = ("--min_completeness", "0", "--max_contamination", "1")


def avamb_stage_times(logfile: Path) -> dict:
    "`bin avamb`'s stage lines from its log.txt; the z and y cluster writes in that order."
    text = logfile.read_text()
    pats = {
        "tnf_s": r"Processed TNF in ([\d.]+) seconds",
        "abundance_s": r"Processed abundance in ([\d.]+) seconds",
        "aae_train_encode_s": r"Trained AAE and encoded in ([\d.]+) seconds",
        "aae_encode_s": r"Encoded the z latent and the y clusters in ([\d.]+) seconds",
    }
    out = {}
    for k, p in pats.items():
        m = re.search(p, text)
        check(m is not None, f"log.txt lacks the line /{p}/")
        out[k] = float(m.group(1))
    writes = [float(x) for x in re.findall(r"Wrote cluster file\(s\) in ([\d.]+) seconds", text)]
    check(len(writes) == 2, f"log.txt holds {len(writes)} cluster writes, not the z and the y one")
    out["z_cluster_write_s"], out["y_export_s"] = writes
    out["epochs_s"] = [float(x) for x in re.findall(r"Epoch:.*\(([\d.]+)s\)", text)]
    return out


def planted_quality_report(path: Path, bins: dict, genome: np.ndarray, lengths: np.ndarray) -> None:
    """A CheckM2 quality_report.tsv of `bins` from the planted genomes:
    completeness is the bin's share of its majority genome's bp,
    contamination the bp of other genomes over the bin's bp, in percent."""
    genome_bp = np.bincount(genome, weights=lengths)
    with open(path, "w") as f:
        f.write("Name\tCompleteness\tContamination\tCompleteness_Model_Used\n")
        for name, members in sorted(bins.items()):
            ids = np.array([int(c.split("C")[1]) for c in members])
            bp = np.bincount(genome[ids], weights=lengths[ids], minlength=len(genome_bp))
            g = int(np.argmax(bp))
            f.write(f"{name}\t{100 * bp[g] / genome_bp[g]:.2f}\t"
                    f"{100 * (bp.sum() - bp[g]) / bp.sum():.2f}\tNeural Network\n")


def aae_encode_card_vs_cpu(dev, model_path: Path, ds, names: list) -> dict:
    """The trained AAE's `get_latents` on the card and on the CPU, on the
    first AAE_PROBE_ROWS contigs: the largest mu difference (at most
    AAE_ENCODE_TOL x the largest |mu|), and the contigs whose y cluster
    differs, each of which must have its top two y probabilities (on the
    CPU) within AAE_ENCODE_TOL."""
    from vamb_torch.models import VAEDataset
    from vamb_torch.models.aae import AAE

    probe = VAEDataset(*(a[:AAE_PROBE_ROWS] for a in ds))
    names = names[:AAE_PROBE_ROWS]
    got = {}
    for where in ("card", "cpu"):
        model = AAE.load(model_path, device=dev if where == "card" else "cpu")
        clusters, mu = model.get_latents(names, probe)
        y_of = {c: int(k) for k, members in clusters.items() for c in members}
        got[where] = (mu, np.array([y_of[c] for c in names]))
    with torch.no_grad():
        _, _, y = model.encode(torch.as_tensor(probe.depths), torch.as_tensor(probe.tnf))
    top2 = torch.topk(y, 2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1]).numpy()
    differ = got["card"][1] != got["cpu"][1]
    near = margin <= AAE_ENCODE_TOL
    result = {"rows": len(names), "mu_max_abs_diff": float(np.abs(got["card"][0] - got["cpu"][0]).max()),
              "mu_max_abs": float(np.abs(got["cpu"][0]).max()),
              "y_clusters_differ": int(differ.sum()), "y_within_margin": int(near.sum()),
              "y_differ_outside_margin": int((differ & ~near).sum())}
    log("phase 9 AAE encode, card vs CPU: " + json.dumps(result))
    check(result["mu_max_abs_diff"] <= AAE_ENCODE_TOL * result["mu_max_abs"],
          f"phase 9: the card's z latent differs from the CPU's by {result['mu_max_abs_diff']} "
          f"(largest |mu| {result['mu_max_abs']})")
    check(result["y_differ_outside_margin"] == 0,
          "phase 9: a y cluster differs between card and CPU outside the margin")
    return result


def run_avamb_path(dev, tmp: Path) -> dict:
    """Phase 9: `bin avamb` at the published widths (547 / 283 / 700, batch
    256) through the CLI entry point on the card, on phase 4's dataset; the
    launch counters are set to 0 just before and read just after. Then its
    artifacts read back and gated, the card's encode and engine held to the
    CPU's, AAE_PROFILE_STEPS training steps profiled, and `avamb_ensemble`
    over the z and y bins with a quality report from the planted genomes."""
    from vamb_torch import kernels as K
    from vamb_torch.__main__ import main
    from vamb_torch.abundance import Abundance
    from vamb_torch.composition import Composition
    from vamb_torch.models import make_dataset
    from vamb_torch.models.aae import AAE
    from vamb_torch.models.dataset import num_batches
    from vamb_torch.utils import read_npz
    from vamb_torch.utils.checkpoint import load_flat

    data = tmp / "data"
    data.mkdir()
    t = time.time()
    genome = write_dataset(data, N_CONTIGS, N_GENOMES, N_SAMPLES, SEED)
    log(f"phase 9 inputs: {N_CONTIGS} contigs from {N_GENOMES} genomes, {N_SAMPLES} samples, "
        f"written in {time.time() - t:.1f} s")
    out = tmp / "avamb"
    K.reset_launch_counts()
    t = time.time()
    main(["bin", "avamb", "--outdir", str(out), "--fasta", str(data / "contigs.fna"),
          "--abundance_tsv", str(data / "abundance.tsv"), *AAE_WIDTH_ARGS, "--e_aae", str(AAE_EPOCHS),
          "--q_aae", "1", "-c", str(AAE_CLUSTERS), "--seed", str(SEED)], device=str(dev))
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {k.__name__: k.launches for k in K.KERNELS}
    tally = {k.__name__: dict(sorted(k.launches_by_width.items())) for k in K.KERNELS}
    by_fpad = {k.__name__: dict(sorted(k.launches_by_fpad.items())) for k in K.KERNELS}
    log(f"phase 9: bin avamb ran end to end in {wall:.2f} s; kernel launches {launches}; by N_pad "
        f"{json.dumps(tally)}; by F_pad {json.dumps(by_fpad)}")
    for name in ("candidate_density_sweep", "medoid_sweep"):
        check(by_fpad[name].get(AAE_F_PAD, 0) > 0 and set(by_fpad[name]) == {AAE_F_PAD},
              f"phase 9: {name} was not launched at F_pad {AAE_F_PAD} alone: {by_fpad[name]}")
    check(launches["gumbel_topc"] > 0, "phase 9: bin avamb never launched gumbel_topc")

    t_checks = time.time()
    names = ("aae_model.npz", "aae_z_latent.npz", "aae_z_clusters_unsplit.tsv", "aae_z_clusters_split.tsv",
             "aae_z_clusters_metadata.tsv", "aae_y_clusters_unsplit.tsv", "aae_y_clusters_split.tsv")
    for name in names:
        check((out / name).is_file(), f"phase 9: {name} was not written")
    _, meta = load_flat(out / "aae_model.npz")
    check((meta["nhiddens"], meta["nlatent_z"], meta["nlatent_y"], meta["nsamples"])
          == (547, 283, 700, N_SAMPLES), f"phase 9: aae_model.npz meta {meta}")
    latent = read_npz(out / "aae_z_latent.npz")
    check(latent.shape == (N_CONTIGS, 283) and latent.dtype == np.float32 and np.isfinite(latent).all(),
          "phase 9: aae_z_latent.npz is not (N, 283) finite float32")
    z_bins = read_bins(out / "aae_z_clusters_unsplit.tsv", None)  # disjoint; -c may leave contigs out
    y_bins = read_bins(out / "aae_y_clusters_unsplit.tsv", N_CONTIGS)  # every contig in exactly one
    check(all(b.startswith("z_") for b in z_bins) and all(b.startswith("y_") for b in y_bins),
          "phase 9: bin names lack their z_ / y_ prefix")
    check(len(read_tsv(out / "aae_z_clusters_metadata.tsv")) - 1 == len(z_bins) <= AAE_CLUSTERS,
          "phase 9: aae_z_clusters_metadata.tsv rows")
    times = avamb_stage_times(out / "log.txt")
    times["bin_avamb_total_s"] = wall

    comp = Composition.load(out / "composition.npz")
    ab = Abundance.load(out / "abundance.npz", comp.metadata.refhash)
    ds = make_dataset(ab.matrix, comp.matrix, comp.metadata.lengths)
    encode = aae_encode_card_vs_cpu(dev, out / "aae_model.npz", ds, list(comp.metadata.identifiers))
    t = time.time()
    agree = engine_agreement(dev, latent, comp.metadata.lengths, label="phase 9's 283-wide z latent",
                             max_steps=AAE_AGREEMENT_STEPS)
    times["card_vs_cpu_engine_s"] = time.time() - t
    for kind in ("gumbel scores", "candidates"):
        check(agree["inputs_seen"][kind] > 0 and agree["inputs_that_differed"][kind] == 0,
              f"phase 9: the card's {kind} differ from the CPU's")
    # 50 clusters, or fewer: all the z latent holds (both engines run out
    # together), or as many as hold AAE_AGREEMENT_STEPS wander steps
    check(agree["identical_clusters"] == agree["clusters_compared"] > 0
          and (agree["clusters_compared"] == agree["clusters_requested"] or agree["engines_exhausted"]
               or agree["step_cap_reached"]),
          "phase 9: the card and the CPU emitted different clusters")

    # avamb_ensemble over the z and y bins, scored against the planted genomes
    lengths = np.asarray(comp.metadata.lengths, dtype=np.float64)
    planted_quality_report(tmp / "quality_report.tsv", {**z_bins, **y_bins}, genome, lengths)
    ens = tmp / "ensemble"
    t = time.time()
    main(["avamb_ensemble", "--outdir", str(ens), "--composition", str(out / "composition.npz"),
          "--clusters", str(out / "aae_z_clusters_unsplit.tsv"), str(out / "aae_y_clusters_unsplit.tsv"),
          "--quality_report", str(tmp / "quality_report.tsv"), *ENSEMBLE_GATES, "--seed", str(SEED)],
         device=str(dev))
    times["ensemble_s"] = time.time() - t
    merged = read_bins(ens / "ensemble_clusters.tsv", None)  # disjoint
    inputs = {**z_bins, **y_bins}
    check(all(name in inputs and members <= inputs[name] for name, members in merged.items()),
          "phase 9: an ensemble bin is not a subset of its input bin")
    times["checks_s"] = time.time() - t_checks
    precision = {"z": pairwise_precision(z_bins, genome), "y": pairwise_precision(y_bins, genome),
                 "ensemble": pairwise_precision(merged, genome)}
    kept = {"z": sum(b.startswith("z_") for b in merged), "y": sum(b.startswith("y_") for b in merged)}
    log(f"phase 9: {len(z_bins)} z bins, {len(y_bins)} y bins; the ensemble kept {len(merged)} "
        f"({kept}) holding {sum(len(b) for b in merged.values())} contigs; pairwise precision "
        f"against the planted genomes {json.dumps(precision)}")
    log("phase 9 stage times: " + json.dumps(times))

    rows = 256 * AAE_PROFILE_STEPS
    pds = make_dataset(ab.matrix[:rows], comp.matrix[:rows], comp.metadata.lengths[:rows])
    model = AAE(N_SAMPLES, seed=SEED, device=dev)  # the published widths

    def train_epoch():
        model.trainmodel(pds, nepochs=1, batchsize=256, batchsteps=None)
        return num_batches(pds.n_obs, 256)

    return {"launches": launches, "launches_by_width": tally, "launches_by_fpad": by_fpad,
            "z_bins": len(z_bins), "z_clustered_contigs": sum(len(b) for b in z_bins.values()),
            "y_bins": len(y_bins), "ensemble_bins": len(merged), "ensemble_kept": kept,
            "precision": precision, "encode_card_vs_cpu": encode, "card_vs_cpu": agree, "times": times,
            "profile": profiled(train_epoch, "AAE training")}


# ------------------------------------------------ phase 10: batched attempts

# loner-tail latents: (clumps, points a clump, isolated points); isolated
# random directions in 32 dimensions lie about 0.5 +- 0.09 apart: loners
# 10,000 points, run on the card and the CPU (20,000 until the full run neared
# its time limit: the CPU's run with lanes on took 43 s of them on
# the NVIDIA H100 80GB HBM3 (700.00 W) machine's host)
TAIL_CARD_VS_CPU = (70, 100, 3_000)
TAIL_BIG = (700, 100, 30_000)  # 100,000 points, on the card
TAIL_PROFILED = (20, 400)  # clusters profiled before the loner tail and inside it
AB_ORDER = ("off", "on", "on", "off")  # attempt_batch of phase 10(c)'s runs
AB_PROFILED = 20  # clusters a run profiles after its timed 200


def loner_tail(n_clumps: int, per: int, n_isolated: int, seed: int):
    "`wide_clumps`' clumps (scale 0.06) and `n_isolated` isolated points after them; lengths."
    m, lengths = wide_clumps(n_clumps, per, scale=0.06, noise_frac=n_isolated / (n_clumps * per),
                             seed=seed)
    check(len(m) == n_clumps * per + n_isolated, f"loner_tail: {len(m)} points")
    return m, lengths


def cluster_fields(c) -> tuple:
    return (c.kind_str, c.medoid, c.seed, c.radius, c.observed_pvr, c.maximal_pvr, c.successes,
            c.attempts, c.members.tolist())


def tail_card_vs_cpu(dev) -> dict:
    """Phase 10(a): the 10,000-point loner tail (TAIL_CARD_VS_CPU) run to
    its last point at subset scope with attempt lanes on and off, each on
    the card and on the CPU: the four emissions must be identical, every
    point clustered, the card's runs must have launched `spec_sweep` and
    `row_stats`, and the lanes' runs must have admitted lanes."""
    from vamb_torch import kernels as K
    from vamb_torch.cluster import ClusterGenerator

    m, lengths = loner_tail(*TAIL_CARD_VS_CPU, seed=SEED)
    runs, result = {}, {}
    for ab in ("on", "off"):
        for device in (dev, "cpu"):
            K.reset_launch_counts()
            t = time.time()
            gen = ClusterGenerator(m.copy(), lengths, rng_seed=SEED, device=device,
                                   wander_scope="subset", attempt_batch=ab)
            clusters = [cluster_fields(c) for c in gen]
            if device == dev:
                torch.cuda.synchronize()
            label = f"{ab}, {'card' if device == dev else 'cpu'}"
            runs[label] = clusters
            result[label] = {
                "seconds": time.time() - t, "clusters": len(clusters),
                "kinds": {k: sum(c[0] == k for c in clusters) for k in ("normal", "loner", "fallback")},
                "lane_counts": gen.lane_counts, "subset_counts": gen.subset_counts,
                **({"launches": {k.__name__: k.launches for k in K.KERNELS}} if device == dev else {})}
            log(f"phase 10(a) {label}: " + json.dumps(result[label]))
            check(sorted(x for c in clusters for x in c[8]) == list(range(len(m))),
                  f"phase 10(a) {label}: the clusters do not partition the points")
            if device == dev:
                check(K.spec_sweep.launches > 0 and K.row_stats.launches > 0,
                      f"phase 10(a) {label}: spec_sweep or row_stats never launched")
            check((gen.lane_counts["admitted"] > 0) == (ab == "on"),
                  f"phase 10(a) {label}: lanes admitted {gen.lane_counts['admitted']}")
    first = runs["on, card"]
    same = {label: r == first for label, r in runs.items()}
    log(f"phase 10(a): emissions identical to the card's with lanes on: {json.dumps(same)}")
    check(all(same.values()), "phase 10(a): the card's and the CPU's emissions differ")
    return result


def tail_big(dev) -> dict:
    """Phase 10(b): the 100,000-point loner tail (TAIL_BIG) run to its last
    point on the card at auto scope (full sweeps at 100,096 columns: the
    seed cache and the loner bursts, no lanes). The loner tail begins once
    every clump point is clustered. Logged: clusters, loners, loners the
    bursts emitted, refills, ms a cluster before the tail and inside it
    (host clock; the profiled clusters left out), and device kernels a
    cluster in a profiled window before it and one inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vamb_torch import kernels as K
    from vamb_torch.cluster import ClusterGenerator

    n_clumps, per, n_isolated = TAIL_BIG
    m, lengths = loner_tail(n_clumps, per, n_isolated, seed=SEED + 1)
    gen = ClusterGenerator(m, lengths, rng_seed=SEED, device=dev)
    K.reset_launch_counts()
    # profiled windows: the clusters after cluster `start`, `count` of them
    windows = {"before": {"start": 100, "count": TAIL_PROFILED[0]},
               "tail": {"start": None, "count": TAIL_PROFILED[1]}}
    spans = {"before": [0.0, 0], "tail": [0.0, 0]}  # host seconds and clusters, unprofiled
    kinds = {"normal": 0, "loner": 0, "fallback": 0}
    clump_left = n_clumps * per  # the clumps' rows come first
    tail_at, active, i = None, None, 0
    torch.cuda.synchronize()
    t0 = t = time.perf_counter()
    for c in gen:
        i += 1
        kinds[c.kind_str] += 1
        clump_left -= int((c.members < n_clumps * per).sum())
        if active is None:
            spans["before" if tail_at is None else "tail"][0] += time.perf_counter() - t
            spans["before" if tail_at is None else "tail"][1] += 1
        else:
            active["seen"] = active.get("seen", 0) + 1
            if active["seen"] == active["count"]:
                torch.cuda.synchronize()
                active["prof"].__exit__(None, None, None)
                active["kernels"] = sum(1 for e in active["prof"].events()
                                        if e.device_type == DeviceType.CUDA)
                active = None
        if tail_at is None and clump_left == 0:
            tail_at = windows["tail"]["start"] = i
        for win in windows.values():
            if active is None and "prof" not in win and win["start"] is not None and win["start"] <= i:
                torch.cuda.synchronize()
                win["prof"] = profile(activities=[ProfilerActivity.CUDA])
                win["prof"].__enter__()
                active = win
        t = time.perf_counter()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if active is not None:  # the run ended inside a window
        active["prof"].__exit__(None, None, None)
        active["kernels"] = sum(1 for e in active["prof"].events() if e.device_type == DeviceType.CUDA)

    def per_cluster(win):
        return win["kernels"] / win["seen"] if win.get("seen") else None

    result = {
        "points": len(m), "clusters": i, "kinds": kinds, "tail_starts_after_cluster": tail_at,
        "seconds": wall, "lane_counts": gen.lane_counts,
        "ms_per_cluster_before_tail": spans["before"][0] / max(spans["before"][1], 1) * 1e3,
        "ms_per_cluster_in_tail": spans["tail"][0] / max(spans["tail"][1], 1) * 1e3,
        "unprofiled_clusters": {k: v[1] for k, v in spans.items()},
        "kernels_per_cluster_before_tail": per_cluster(windows["before"]),
        "kernels_per_cluster_in_tail": per_cluster(windows["tail"]),
        "launches": {k.__name__: k.launches for k in K.KERNELS},
    }
    log("phase 10(b) loner tail at 100,000 points: " + json.dumps(result))
    check(clump_left == 0 and tail_at is not None and kinds["loner"] > 0,
          "phase 10(b): the run never reached its loner tail")
    check(gen.lane_counts["burst_loners"] > 0 and K.spec_sweep.launches > 0 and K.row_stats.launches > 0,
          "phase 10(b): no burst, or spec_sweep / row_stats never launched")
    return result


def lanes_ab() -> dict:
    """Phase 10(c): the engine on `ab_latent()` at subset scope, attempt
    lanes off, on, on, off (AB_ORDER), in one process: ms a cluster over
    200 clusters, device kernels a cluster over AB_PROFILED more; the
    medoids' hashes must agree."""
    data = ab_latent()
    runs = []
    for ab in AB_ORDER:
        r = engine_time(profiled=AB_PROFILED, data=data, wander_scope="subset", attempt_batch=ab)
        runs.append({"attempt_batch": ab, **r})
        log("phase 10(c): " + json.dumps(runs[-1]))
    check(len({r["medoids_sha"] for r in runs}) == 1, "phase 10(c): lanes on and off emitted different medoids")
    summary = {ab: {"ms_per_cluster": [r["ms_per_cluster"] for r in runs if r["attempt_batch"] == ab],
                    "kernels_per_cluster": [r["kernels_per_cluster"] for r in runs
                                            if r["attempt_batch"] == ab]}
               for ab in ("off", "on")}
    log("phase 10(c) lanes A/B on the 300,000-point latent: " + json.dumps(summary))
    # phase 14(a): the headline unit, effective dists/s, over each run's timed window
    headline = [{"attempt_batch": r["attempt_batch"], **r["work"]} for r in runs]
    log("phase 14(a): work of the 300,000-point latent's timed windows (n_dists, n_dists_effective, "
        "emitted_total, clusters/s, effective dists/s): " + json.dumps(headline))
    return {"runs": runs, "summary": summary, "headline": headline}


def batched_attempts(dev) -> dict:
    "Phase 10: (a), (b) and (c), with each part's seconds."
    out = {}
    for key, fn in (("card_vs_cpu", lambda: tail_card_vs_cpu(dev)), ("tail_100k", lambda: tail_big(dev)),
                    ("lanes_ab", lanes_ab)):
        t = time.time()
        out[key] = fn()
        out[key + "_seconds"] = time.time() - t
        log(f"phase 10 part {key} took {out[key + '_seconds']:.1f} s")
    return out


# ------------------------------------------------ phase 11: the bf16 path

BF16_FLAGS = ("--precision", "bf16", "--distance_dtype", "bfloat16")
BF16_CLUSTERS = 2000  # -c, as phase 4
BF16_PROFILE_STEPS = 20  # training steps profiled, as phase 6's
BF16_PAIRS = 1_000_000  # contig pairs sampled for the agreement with f32


def pair_agreement(a: np.ndarray, b: np.ndarray, seed: int) -> dict:
    """Co-membership of two labellings of the same contigs: the share of
    BF16_PAIRS sampled pairs on which they agree (together or apart:
    `vamb_tpu`'s test_bf16_partition_and_agreement), and the share of the
    pairs `a` puts together that `b` puts together too (random pairs seldom
    share a cluster, so this is the sharper number)."""
    idx = np.random.default_rng(seed).integers(0, len(a), (BF16_PAIRS, 2))
    same_a = a[idx[:, 0]] == a[idx[:, 1]]
    same_b = b[idx[:, 0]] == b[idx[:, 1]]
    pairs = lambda counts: float((counts * (counts - 1) // 2).sum())  # noqa: E731
    _, joint = np.unique(np.stack([a, b]), axis=1, return_counts=True)
    return {"sampled_pairs": BF16_PAIRS, "agreement": float(np.mean(same_a == same_b)),
            "kept_together": pairs(joint) / max(pairs(np.unique(a, return_counts=True)[1]), 1.0)}


def run_bf16_path(dev, tmp: Path, f32_run: dict) -> dict:
    """Phase 11: `bin default --precision bf16 --distance_dtype bfloat16`
    through the CLI entry point on the card, on phase 4's dataset (VAE
    512-512-32, 2 epochs, `-c 2000`); the launch counters are set to 0 just
    before and read just after. Gates: the bf16 variants of the three
    kernels launched, their f32 versions and `row_sweep` and the gather
    not; the artifacts and TSVs read back, `model.npz` recording "bf16";
    50 clusters of the bf16 engine on this path's latent on the card and
    on the CPU in lockstep (Gumbel scores and candidates different in no
    step, all 50 identical); phase 4's f32 latent (`f32_run`) clustered at
    bf16 on the card agreeing with phase 4's f32 clusters on more than 0.95
    of sampled pairs. Logged: stage times, the bins' pairwise precision
    beside phase 4's, and BF16_PROFILE_STEPS bf16 training steps under
    torch.profiler beside phase 6's f32 steps."""
    from vamb_torch import kernels as K
    from vamb_torch.__main__ import main
    from vamb_torch.abundance import Abundance
    from vamb_torch.cluster import ClusterGenerator
    from vamb_torch.composition import Composition
    from vamb_torch.models import VAE, make_dataset
    from vamb_torch.models.dataset import num_batches
    from vamb_torch.utils import read_npz
    from vamb_torch.utils.checkpoint import load_flat

    data = tmp / "data"
    data.mkdir()
    t = time.time()
    genome = write_dataset(data, N_CONTIGS, N_GENOMES, N_SAMPLES, SEED)
    log(f"phase 11 inputs: {N_CONTIGS} contigs from {N_GENOMES} genomes, {N_SAMPLES} samples, "
        f"written in {time.time() - t:.1f} s")
    out = tmp / "bf16"
    K.reset_launch_counts()
    t = time.time()
    main(["bin", "default", "--outdir", str(out), "--fasta", str(data / "contigs.fna"),
          "--abundance_tsv", str(data / "abundance.tsv"), "-e", "2", "-q", "1",
          "-c", str(BF16_CLUSTERS), "--seed", str(SEED), *BF16_FLAGS], device=str(dev))
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {k.__name__: k.launches for k in K.KERNELS}
    tally = {k.__name__: dict(sorted(k.launches_by_width.items())) for k in K.KERNELS}
    by_dtype = {k.__name__: dict(k.launches_by_dtype) for k in K.KERNELS}
    log(f"phase 11: bin default {' '.join(BF16_FLAGS)} ran end to end in {wall:.2f} s; kernel launches "
        f"{launches}; by N_pad {json.dumps(tally)}; by the matrix's type {json.dumps(by_dtype)}")
    for name in BF16_KERNELS:
        check(by_dtype[name].get("bfloat16", 0) > 0 and "float32" not in by_dtype[name],
              f"phase 11: {name} launches by type {by_dtype[name]}: the bf16 variant alone must run")
    check(launches["row_sweep"] == 0 and launches["gather_blocks"] == 0,
          "phase 11: row_sweep or the gather ran on the bf16 path")
    check(launches["gumbel_topc"] > 0, "phase 11: gumbel_topc never ran")
    t_checks = time.time()
    checked = check_outputs(out, genome, BF16_CLUSTERS)
    meta = load_flat(out / "model.npz")[1]
    check(meta["precision"] == "bf16", f"phase 11: model.npz records precision {meta['precision']!r}")
    lines = (out / "log.txt").read_text().splitlines()
    check(any("Precision: bf16" in ln for ln in lines), "phase 11: log.txt does not say it trained at bf16")
    times = stage_times(out / "log.txt")
    times["total_s"] = wall
    times["clusters_per_s"] = checked["clusters"] / times["cluster_write_s"]
    engine = engine_counts(lines)
    check(engine["subset"]["attempts"] == 0 and engine["cache_and_lanes"]["passes"] == 0,
          f"phase 11: the bf16 engine took the subset wander or ran lanes: {engine}")
    log(f"phase 11: the engine {json.dumps(engine)}; pairwise precision {checked['precision']:.4f} "
        f"(phase 4, f32: {f32_run['precision']:.4f}); stage times {json.dumps(times)}")

    comp = Composition.load(out / "composition.npz")
    t = time.time()
    agree = engine_agreement(dev, read_npz(out / "latent.npz"), comp.metadata.lengths,
                             label="phase 11's latent at bfloat16 distances", distance_dtype="bfloat16")
    times["card_vs_cpu_engine_s"] = time.time() - t
    for kind in ("gumbel scores", "candidates"):
        check(agree["inputs_seen"][kind] > 0 and agree["inputs_that_differed"][kind] == 0,
              f"phase 11: the card's {kind} differ from the CPU's")
    check(agree["identical_clusters"] == agree["clusters_compared"] == agree["clusters_requested"],
          "phase 11: the card and the CPU emitted different clusters")

    # phase 4's f32 latent at bf16 distances against phase 4's f32 clusters
    t = time.time()
    gen = ClusterGenerator(f32_run["_latent"].copy(), f32_run["_lengths"], rng_seed=SEED, device=dev,
                           distance_dtype="bfloat16")
    labels = -1 - np.arange(N_CONTIGS)
    n_bf16 = 0
    for i, c in enumerate(itertools.islice(gen, BF16_CLUSTERS)):
        labels[c.members] = i
        n_bf16 += 1
    torch.cuda.synchronize()
    times["f32_latent_at_bf16_s"] = time.time() - t
    vs_f32 = {"bf16_clusters": n_bf16, **pair_agreement(f32_run["_labels"], labels, SEED)}
    log("phase 11: phase 4's f32 latent clustered at bfloat16 distances on the card against phase 4's "
        f"f32 clusters: {json.dumps(vs_f32)}")
    check(vs_f32["agreement"] > 0.95, f"phase 11: pairwise agreement with f32 {vs_f32['agreement']}")
    times["checks_s"] = time.time() - t_checks

    ab = Abundance.load(out / "abundance.npz", comp.metadata.refhash)
    rows = 256 * BF16_PROFILE_STEPS
    ds = make_dataset(ab.matrix[:rows], comp.matrix[:rows], comp.metadata.lengths[:rows])
    vae = VAE(N_SAMPLES, seed=SEED, device=dev, precision="bf16")

    def train_epoch():
        vae.trainmodel(ds, nepochs=1, batchsize=256, batchsteps=None)
        return num_batches(ds.n_obs, 256)

    prof = profiled(train_epoch, "bf16 training")
    f32_prof = f32_run.get("profile", {}).get("train")
    log("phase 11: a bf16 training step " + json.dumps(
        {k: prof[k] for k in ("ms_per_unit", "kernels_per_unit", "device_busy_share")})
        + "; phase 6's f32 step " + (json.dumps(
            {k: f32_prof[k] for k in ("ms_per_unit", "kernels_per_unit", "device_busy_share")})
            if f32_prof else "not measured in this run"))
    log("phase 11 stage times: " + json.dumps(times))
    return {"launches": launches, "launches_by_width": tally, "launches_by_dtype": by_dtype, **checked,
            "f32_precision": f32_run["precision"], "times": times, "engine_counts": engine,
            "card_vs_cpu": agree, "f32_latent_at_bf16": vs_f32, "profile": prof}


# --------------------------------------------------- phase 6: profile

# Clusters a profiled window (was 100): a smaller window keeps the
# profiler's events, and the run's time, down.
PROFILE_CLUSTERS = 20


# ------------------------------------------- phase 12: several processes

DIST_CLUSTERS = 80  # clusters each of phase 12's engine runs takes: a cap on their time
DIST_CPU_CLUSTERS = 20  # clusters of 12(b)'s run on the card held to the same run on the CPU
# 12(e)'s W = 2 runs held card vs CPU (the CPU's engine at F_pad 288 is slow:
# 20 of the z latent's took 49 s on the NVIDIA H100 80GB HBM3 (700.00 W)
# machine's host)
DIST_E_CPU_CLUSTERS = 10
# phase 12's training batch (doubled after epoch 1, as phase 4's -q 1): twice
# phase 4's, half the steps, each of which gathers the gradient over gloo in 12(b)
DIST_BATCH = 512
DIST_SHARD_WORLDS = (1, 2, 4)  # the shards checked: the 100k path's 100,096 columns over W ranks
DIST_RANK_TIMEOUT_S = 420  # a 12(b) rank's limit, and every process group's timeout
SHARD_KERNELS = ("medoid_sweep_shard", "spec_sweep_shard", "candidate_density_shard",
                 "gumbel_topc_shard")
# the index entry point whose kernel each shard entry point launches
SHARD_OF = {"medoid_sweep_shard": "medoid_sweep", "spec_sweep_shard": "spec_sweep",
            "candidate_density_shard": "candidate_density_sweep",
            "gumbel_topc_shard": "gumbel_topc", "gather_ball_shard": "gather_blocks"}
# the shard entry points with a bf16 variant (a bfloat16 engine's shards)
BF16_SHARD_KERNELS = ("medoid_sweep_shard", "spec_sweep_shard", "candidate_density_shard")
# 12(a)'s engine runs beside its full-scope one, each sharded and unsharded
DIST_VARIANTS = {"subset, lanes on": {"wander_scope": "subset", "attempt_batch": "on"},
                 "subset, lanes off": {"wander_scope": "subset", "attempt_batch": "off"},
                 "bfloat16": {"distance_dtype": "bfloat16"}}


def check_and_time_shards(dev, f_pad: int = F_PAD) -> tuple[dict, dict]:
    """Phase 12's kernel checks and times of the four shard entry points at
    F_pad `f_pad` (at the AAE's 288, the three that read the matrix: the
    Gumbel kernel reads none). Checks: on the first and last shard of the
    100k path's 100,096 columns
    over W = 1, 2 and 4 ranks, each with queries on the shard and held by
    another rank (-1), against its plain version on the card and, given a
    shard column's own features and index, against the index entry point
    on the shard, bit for bit; each shard's `gumbel_topc_shard` keys against
    its plain version and their `topc_merge` against `gumbel_topc` over the
    whole width. Times at W = 1's shard (the whole width), as
    `time_kernels` times the index entry points. Returns ({kernel: max abs
    error}, {kernel: times})."""
    from vamb_torch import kernels as K

    n = PATH_WIDTHS[1]
    mT = torch.as_tensor(clumpy_matrixT(n, f_pad, seed=9), device=dev)
    w = torch.as_tensor(weights(n, seed=9, zero_half=True), device=dev)
    gumbel = f_pad == F_PAD
    errs = dict.fromkeys(SHARD_KERNELS if gumbel else SHARD_KERNELS[:3], 0.0)

    def held(name, got, want, what):
        for a, b in zip(got, want):
            check(a.dtype == b.dtype and torch.equal(a, b), f"phase 12: {name} differs from {what}")
            if a.is_floating_point():
                errs[name] = max(errs[name], float((a.double() - b.double()).abs().max()))

    gkey, gd, gkept, gtried, gmedoid = gumbel_inputs(n, dev, seed=8)
    for world in DIST_SHARD_WORLDS:
        keys = []
        for r in range(world):
            lo, hi = r * n // world, (r + 1) * n // world
            if gumbel:
                k = K.gumbel_topc_shard(gkey, gd[lo:hi], gkept[lo:hi], gtried[lo:hi], gmedoid,
                                        MAXSTEPS, n, lo)
                held("gumbel_topc_shard", (k,), (K.gumbel_topc_shard_plain(
                    gkey, gd[lo:hi], gkept[lo:hi], gtried[lo:hi], gmedoid, MAXSTEPS, lo),),
                    f"its plain version (W {world}, rank {r})")
                keys.append(k)
            if r not in (0, world - 1):
                continue
            part, wp = mT[:, lo:hi].contiguous(), w[lo:hi].contiguous()
            own, other = 37, (hi + 5) % n  # a shard column, and one on the next shard
            q_own, q_other = part[:, own].contiguous(), mT[:, other].contiguous()
            where = f"(F_pad {f_pad}, W {world}, rank {r})"
            for q, idx in ((q_own, own), (q_other, -1)):
                held("medoid_sweep_shard", K.medoid_sweep_shard(part, q, idx, wp),
                     K.medoid_sweep_shard_plain(part, q, idx, wp), f"its plain version {where}")
            held("medoid_sweep_shard", K.medoid_sweep_shard(part, q_own, own, wp),
                 K.medoid_sweep(part, own, wp), f"medoid_sweep on the shard {where}")
            m_loc = hi - lo
            cols = [own, -1, 5, m_loc - 1, -1, 200, own, 9]
            feats = torch.stack([part[:, c] if c >= 0 else mT[:, (other + s) % n]
                                 for s, c in enumerate(cols)], 1).contiguous()
            held("spec_sweep_shard", K.spec_sweep_shard(part, feats, cols, wp),
                 K.spec_sweep_shard_plain(part, feats, cols, wp), f"its plain version {where}")
            mine = [own, 5, m_loc - 1, 200, 9, own, 1, 2]
            held("spec_sweep_shard", K.spec_sweep_shard(part, part[:, mine].contiguous(), mine, wp),
                 K.spec_sweep(part, mine, wp), f"spec_sweep on the shard {where}")
            cand = torch.tensor([own, -1, 5, m_loc - 1, -1] * 5, device=dev)
            q = torch.stack([part[:, c] if c >= 0 else mT[:, (other + j) % n]
                             for j, c in enumerate(cand.tolist())], 1).contiguous()
            held("candidate_density_shard", (K.candidate_density_shard(part, q, cand, wp),),
                 (K.candidate_density_shard_plain(part, q, cand, wp),), f"its plain version {where}")
            ids = torch.tensor([own, 5, m_loc - 1, 200] * 6 + [9], device=dev)
            held("candidate_density_shard",
                 (K.candidate_density_shard(part, part[:, ids].contiguous(), ids, wp),),
                 (K.candidate_density_sweep(part, ids, wp),), f"the density kernel on the shard {where}")
        if gumbel:
            merged = K.topc_merge(torch.stack(keys), MAXSTEPS)
            held("gumbel_topc_shard", merged,
                 K.gumbel_topc(gkey, gd, gkept, gtried, gmedoid, MAXSTEPS),
                 f"gumbel_topc over the whole width once merged (W {world})")
    log(f"phase 12 shard entry points at F_pad {f_pad}: bit for bit their plain versions and the "
        f"index entry points on the shards at W {DIST_SHARD_WORLDS} ({n} columns): " + json.dumps(errs))
    errs.update(check_ball_and_bf16_shards(dev, mT, w, f_pad))

    # times at W = 1's shard, with the bounds of `time_kernels`
    idx, f = 37, f_pad
    kept = w > 0
    n_kept = int(kept.sum())
    q = mT[:, idx].contiguous()
    d_row = K.row_sweep(mT, idx)
    near = int(((d_row <= 0.05) & kept).sum())
    in_hist = int(((d_row >= 0) & (d_row <= 0.3) & kept).sum())
    spec_cols = [int(c) for c in np.random.default_rng(6).choice(n, SPEC_SEEDS, replace=False)]
    feats = mT[:, spec_cols].contiguous()
    rows = K.spec_sweep(mT, spec_cols, w)[0]
    in_hist_s = int(((rows >= 0) & (rows <= 0.3) & kept).sum())
    near_s = int(((rows <= 0.05) & kept).sum())
    cand = torch.as_tensor(np.random.default_rng(5).choice(n, MAXSTEPS, replace=False), device=dev)
    qc = mT[:, cand].contiguous()
    n_within = int((((0.5 - qc.T @ mT) <= 0.05) & kept[None, :]).sum())
    fns = {
        "medoid_sweep_shard": (
            lambda: K.medoid_sweep_shard(mT, q, idx, w), lambda: K.medoid_sweep_shard_plain(mT, q, idx, w),
            None, bound((f * n + 2 * n + 62 + f) * 4, 2 * f * n + n + 2 * in_hist + 3 * near)),
        "spec_sweep_shard": (
            lambda: K.spec_sweep_shard(mT, feats, spec_cols, w),
            lambda: K.spec_sweep_shard_plain(mT, feats, spec_cols, w),
            lambda: torch.matmul(feats.T, mT),
            bound((f * n + n + SPEC_SEEDS * n + f * SPEC_SEEDS) * 4 + SPEC_SEEDS * 63 * 4,
                  SPEC_SEEDS * (2 * f * n + n) + 2 * in_hist_s + 3 * near_s)),
        "candidate_density_shard": (
            lambda: K.candidate_density_shard(mT, qc, cand, w),
            lambda: K.candidate_density_shard_plain(mT, qc, cand, w), None,
            bound((f * n_kept + n + (2 + f) * MAXSTEPS) * 4,
                  (2 * f + 1) * MAXSTEPS * n_kept + 3 * n_within)),
    }
    if gumbel:
        fns["gumbel_topc_shard"] = (
            lambda: K.gumbel_topc_shard(gkey, gd, gkept, gtried, gmedoid, MAXSTEPS, n, 0),
            lambda: K.gumbel_topc_shard_plain(gkey, gd, gkept, gtried, gmedoid, MAXSTEPS, 0),
            lambda: torch.topk(K.gumbel_scores(gkey, gd, gkept, gtried, gmedoid), MAXSTEPS),
            bound(GUMBEL_READ_BYTES * n, GUMBEL_F32_OPS * n, GUMBEL_INT_OPS * n))
    # gather_ball_shard: a W = 1 shard of the 300k path's 300,032 columns
    # (at F_pad 288, of the 100k path's 100,096: the widths it is checked
    # at), 64 blocks with their side vectors, beside `index_select` of the
    # matrix's blocks alone; its bound is the gather's (the blocks read and
    # written, the ids, and per slot w, kept and d0 read and its id, flag,
    # weight and d0 written)
    gather_n = BIG_PAD if gumbel else n
    mTg, wg, keptg, d0g = ball_inputs(gather_n, dev, seed=6, f=f)
    bids = torch.as_tensor(np.sort(np.random.default_rng(6).choice(gather_n // 128, BALL_KB, replace=False))
                           .astype(np.int32), device=dev)
    q_cols = BALL_KB * 128
    fns["gather_ball_shard"] = (
        lambda: K.gather_ball_shard(mTg, bids, BALL_KB, wg, keptg, d0g, 0),
        lambda: K.gather_ball_shard_plain(mTg, bids, BALL_KB, wg, keptg, d0g, 0),
        lambda: mTg.view(f, gather_n // 128, 128).index_select(1, bids),
        bound((2 * f * q_cols + BALL_KB) * 4 + q_cols * 22, 0))
    # the bf16 variants at W = 1's shard: the f32 kernels' bounds with the
    # matrix at 2 bytes an element (`time_bf16`'s)
    mTb = mT.to(torch.bfloat16)
    wide = mTb.float()
    qb, featsb, qcb = (wide[:, idx].contiguous(), wide[:, spec_cols].contiguous(),
                       wide[:, cand].contiguous())
    db = K.medoid_sweep(mTb, idx, w)[0]
    near_b = int(((db <= 0.05) & kept).sum())
    in_hist_b = int(((db >= 0) & (db <= 0.3) & kept).sum())
    rows_b = K.spec_sweep(mTb, spec_cols, w)[0]
    in_hist_sb = int(((rows_b >= 0) & (rows_b <= 0.3) & kept).sum())
    near_sb = int(((rows_b <= 0.05) & kept).sum())
    n_within_b = int((((0.5 - qcb.T @ wide) <= 0.05) & kept[None, :]).sum())
    lib_b, lib_b_what = spec_library(mTb[:, spec_cols].T.contiguous(), mTb)
    fns_b = {
        "medoid_sweep_shard": (
            lambda: K.medoid_sweep_shard(mTb, qb, idx, w), lambda: K.medoid_sweep_shard_plain(mTb, qb, idx, w),
            None, bound(f * n * 2 + (2 * n + 62 + f) * 4, 2 * f * n + n + 2 * in_hist_b + 3 * near_b)),
        "spec_sweep_shard": (
            lambda: K.spec_sweep_shard(mTb, featsb, spec_cols, w),
            lambda: K.spec_sweep_shard_plain(mTb, featsb, spec_cols, w), lib_b,
            bound(f * n * 2 + (n + SPEC_SEEDS * n + f * SPEC_SEEDS) * 4 + SPEC_SEEDS * 63 * 4,
                  SPEC_SEEDS * (2 * f * n + n) + 2 * in_hist_sb + 3 * near_sb)),
        "candidate_density_shard": (
            lambda: K.candidate_density_shard(mTb, qcb, cand, w),
            lambda: K.candidate_density_shard_plain(mTb, qcb, cand, w), None,
            bound(f * n_kept * 2 + (n + (2 + f) * MAXSTEPS) * 4,
                  (2 * f + 1) * MAXSTEPS * n_kept + 3 * n_within_b)),
    }
    times = {}
    for dtype, table in (("float32", fns), ("bfloat16", fns_b)):
        for name, (kern, plain, lib, bnd) in table.items():
            r = {"bound": bnd, "ms": time_ms(kern), "plain_ms": time_ms(plain),
                 "library_ms": None if lib is None else time_ms(lib),
                 "n_pad": gather_n if name == "gather_ball_shard" else n}
            if dtype == "bfloat16" and lib is not None:
                r["library_what"] = lib_b_what
            times[(name, dtype)] = r
            libs = (LIBRARY_NOTES.get(SHARD_OF[name], "none") if lib is None
                    else f"{r['library_ms']:.5f} ms")
            log(f"{name} ({dtype}) at F_pad {f}, N_local {r['n_pad']}: kernel {r['ms']:.5f} ms, plain "
                f"{r['plain_ms']:.5f} ms, library {libs}, bound {bnd[0] * 1e3:.3f} us ({bnd[1]}), "
                f"roofline share {bnd[0] / r['ms']:.3f}, L2 cold")
    return errs, times


def check_ball_and_bf16_shards(dev, mT: torch.Tensor, w: torch.Tensor, f_pad: int = F_PAD) -> dict:
    """Phase 12's checks of `gather_ball_shard` and the bf16 shard
    variants at F_pad `f_pad` (`mT`'s). The gather: on the first and last
    128-aligned shard of the 100k path's 100,096 columns and (at F_pad 32)
    of the 300k path's 300,032 (KB 64, the engine's at either width) over
    W = 1, 2 and 4 ranks, 64 of the shard's blocks with all slots valid and
    with 24 padding slots, bit for bit its plain version on the card and
    `gather_ball` of the whole matrix for the shard's blocks (each slot's
    column global). The bf16 variants: on the first and last shard of the
    100,096 columns of `mT` rounded to bf16 over W = 1, 2 and 4, queries on
    the shard (the widened column) and held by another rank (-1), bit for
    bit their plain versions and, given a shard column's widened features
    and index, the bf16 index entry points on the shard; one launch a call,
    tallied as "bfloat16". Returns {"gather_ball_shard": err,
    "<name> bf16": err}."""
    from vamb_torch import kernels as K

    errs = {"gather_ball_shard": 0.0, **{f"{k} bf16": 0.0 for k in BF16_SHARD_KERNELS}}

    def held(name, got, want, what):
        for a, b in zip(got, want):
            check(a.dtype == b.dtype and torch.equal(a, b), f"phase 12: {name} differs from {what}")
            if a.is_floating_point():
                errs[name] = max(errs[name], float((a.double() - b.double()).abs().max()))

    for n in (PATH_WIDTHS[1], BIG_PAD) if f_pad == F_PAD else (PATH_WIDTHS[1],):
        mTg, wg, keptg, d0g = ball_inputs(n, dev, seed=n + 2, f=f_pad)
        blocks = n // 128
        for world in DIST_SHARD_WORLDS:
            for r in sorted({0, world - 1}):
                b_lo, b_hi = r * blocks // world, (r + 1) * blocks // world
                lo, hi = b_lo * 128, b_hi * 128
                part = mTg[:, lo:hi].contiguous()
                side = [v[lo:hi].contiguous() for v in (wg, keptg, d0g)]
                rng = np.random.default_rng(n + world + r)
                picked = np.sort(rng.choice(b_hi - b_lo, BALL_KB, replace=False)).astype(np.int32)
                part_ids = picked.copy()
                part_ids[BALL_KB * 5 // 8:] = 0  # 24 padding slots, which gather block 0
                for ids, nb in ((picked, BALL_KB), (part_ids, BALL_KB * 5 // 8)):
                    bids = torch.as_tensor(ids, device=dev)
                    got = K.gather_ball_shard(part, bids, nb, *side, lo)
                    where = f"(F_pad {f_pad}, N {n}, W {world}, rank {r}, nb {nb})"
                    held("gather_ball_shard", got, K.gather_ball_shard_plain(part, bids, nb, *side, lo),
                         f"its plain version {where}")
                    held("gather_ball_shard", got, K.gather_ball(mTg, bids + b_lo, nb, wg, keptg, d0g),
                         f"gather_ball of the whole matrix {where}")
    n = PATH_WIDTHS[1]
    mTb = mT.to(torch.bfloat16)

    def one_bf16_launch(kernel, fn):
        before = kernel.launches_by_dtype.get("bfloat16", 0)
        out = fn()
        check(kernel.launches_by_dtype.get("bfloat16", 0) == before + 1,
              f"phase 12: {kernel.__name__} bf16: not one launch tallied as bfloat16 a call")
        return out

    for world in DIST_SHARD_WORLDS:
        for r in sorted({0, world - 1}):
            lo, hi = r * n // world, (r + 1) * n // world
            part, wp = mTb[:, lo:hi].contiguous(), w[lo:hi].contiguous()
            wide = part.float()
            m_loc = hi - lo
            own, other = 37, (hi + 5) % n
            q_own, q_other = wide[:, own].contiguous(), mTb[:, other].float().contiguous()
            where = f"(bf16, F_pad {f_pad}, W {world}, rank {r})"
            for q, idx in ((q_own, own), (q_other, -1)):
                got = one_bf16_launch(K.medoid_sweep_shard, lambda: K.medoid_sweep_shard(part, q, idx, wp))
                held("medoid_sweep_shard bf16", got, K.medoid_sweep_shard_plain(part, q, idx, wp),
                     f"its plain version {where}")
            held("medoid_sweep_shard bf16", K.medoid_sweep_shard(part, q_own, own, wp),
                 K.medoid_sweep(part, own, wp), f"medoid_sweep on the shard {where}")
            cols = [own, -1, 5, m_loc - 1, -1, 200, own, 9]
            feats = torch.stack([wide[:, c] if c >= 0 else mTb[:, (other + s) % n].float()
                                 for s, c in enumerate(cols)], 1).contiguous()
            got = one_bf16_launch(K.spec_sweep_shard, lambda: K.spec_sweep_shard(part, feats, cols, wp))
            held("spec_sweep_shard bf16", got, K.spec_sweep_shard_plain(part, feats, cols, wp),
                 f"its plain version {where}")
            mine = [own, 5, m_loc - 1, 200, 9, own, 1, 2]
            held("spec_sweep_shard bf16", K.spec_sweep_shard(part, wide[:, mine].contiguous(), mine, wp),
                 K.spec_sweep(part, mine, wp), f"spec_sweep on the shard {where}")
            cand = torch.tensor([own, -1, 5, m_loc - 1, -1] * 5, device=dev)
            q = torch.stack([wide[:, c] if c >= 0 else mTb[:, (other + j) % n].float()
                             for j, c in enumerate(cand.tolist())], 1).contiguous()
            got = one_bf16_launch(K.candidate_density_shard,
                                  lambda: K.candidate_density_shard(part, q, cand, wp))
            held("candidate_density_shard bf16", (got,), (K.candidate_density_shard_plain(part, q, cand, wp),),
                 f"its plain version {where}")
            ids = torch.tensor([own, 5, m_loc - 1, 200] * 6 + [9], device=dev)
            held("candidate_density_shard bf16",
                 (K.candidate_density_shard(part, wide[:, ids].contiguous(), ids, wp),),
                 (K.candidate_density_sweep(part, ids, wp),), f"the bf16 density kernel on the shard {where}")
    torch.cuda.synchronize()
    log(f"phase 12 at F_pad {f_pad}: gather_ball_shard on the 128-aligned shards of {PATH_WIDTHS[1]}"
        f"{'' if f_pad != F_PAD else f' and {BIG_PAD}'} columns (KB {BALL_KB}) and the bf16 shard "
        f"variants on the shards of {n}, W {DIST_SHARD_WORLDS}: bit for bit their plain versions and the "
        "index entry points: " + json.dumps(errs))
    return errs


def engine_run(gen, n_clusters: int) -> list:
    "The first `n_clusters` clusters of `gen` as (medoid, kind, members)."
    return [(c.medoid, c.kind_str, c.members.tolist()) for c in itertools.islice(gen, n_clusters)]


def labels_of(clusters: list, n: int) -> np.ndarray:
    "Each point's cluster among `clusters`, a label of its own (-1 - i) where none."
    labels = -1 - np.arange(n)
    for i, (_, _, members) in enumerate(clusters):
        labels[members] = i
    return labels


def run_dist_one(dev, tmp: Path) -> dict:
    """Phase 12(a): a world of one on NCCL, on the card. Phase 4's dataset
    (written anew into `tmp / "data"`) trains for 2 epochs with `mesh=`
    (batch DIST_BATCH, doubled at 1, as phase 4's `-q 1`), and
    `DIST_CLUSTERS` clusters of its latent come from the unsharded engine
    and then from the row-sharded one, the launch counters set to 0 just
    before the sharded run and read just after: every shard entry point and
    `row_stats` launched, the index entry points of the same kernels not;
    the emission and every attempt's sums (`sums_trace`) bit for bit the
    unsharded engine's. The NCCL collectives of the sharded run are
    tallied, calls and bytes per attempt by kind."""
    from datetime import timedelta

    import torch.distributed as dist
    from vamb_torch import kernels as K
    from vamb_torch import pipeline
    from vamb_torch.cluster import ClusterGenerator
    from vamb_torch.models import VAE, make_dataset
    from vamb_torch.parallel import make_mesh
    from vamb_torch.utils import BinSplitter

    data = tmp / "data"
    data.mkdir()
    t = time.time()
    write_dataset(data, N_CONTIGS, N_GENOMES, N_SAMPLES, SEED)
    log(f"phase 12: wrote phase 4's dataset in {time.time() - t:.1f} s")
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'rendezvous_a'}", world_size=1,
                            rank=0, timeout=timedelta(seconds=DIST_RANK_TIMEOUT_S))
    try:
        mesh = make_mesh(1, device="cuda")
        check(dist.get_backend(mesh.group) == "nccl", "phase 12(a): the group is not NCCL's")
        general = pipeline.GeneralOptions(tmp / "a", seed=SEED, device=str(mesh.device))
        general.outdir.mkdir()
        comp, ab = pipeline.load_composition_and_abundance(
            general, pipeline.CompositionOptions(fasta=data / "contigs.fna"),
            pipeline.AbundanceOptions(abundance_tsv=data / "abundance.tsv"), BinSplitter(None))
        ds = make_dataset(ab.matrix, comp.matrix, comp.metadata.lengths)
        vae = VAE(N_SAMPLES, seed=SEED, device=mesh.device)
        lines = []
        t = time.time()
        vae.trainmodel(ds, nepochs=2, batchsize=DIST_BATCH, batchsteps=[1], mesh=mesh,
                       logger=lines.append)
        latent = vae.encode(ds)
        train_s = time.time() - t
        check(sum("Parameters identical on 1 ranks" in ln for ln in lines) == 2,
              "phase 12(a): the replicas were not checked after each epoch")
        lengths = comp.metadata.lengths
        t = time.time()
        plain_gen = ClusterGenerator(latent.copy(), lengths, rng_seed=SEED, device=dev)
        plain_gen.sums_trace = []
        plain = engine_run(plain_gen, DIST_CLUSTERS)
        torch.cuda.synchronize()
        plain_s = time.time() - t
        K.reset_launch_counts()
        mesh.reset_traffic()
        t = time.time()
        gen = ClusterGenerator(latent.copy(), lengths, rng_seed=SEED, mesh=mesh)
        gen.sums_trace = []
        sharded = engine_run(gen, DIST_CLUSTERS)
        torch.cuda.synchronize()
        sharded_s = time.time() - t
        launches = {k.__name__: k.launches for k in K.KERNELS}
        traffic = mesh.traffic
        variants = {label: engine_pair(dev, mesh, latent, lengths, label, kw)
                    for label, kw in DIST_VARIANTS.items()}
    finally:
        dist.destroy_process_group()
    log(f"phase 12(a): trained 2 epochs with mesh= and encoded in {train_s:.2f} s; "
        f"{DIST_CLUSTERS} clusters: unsharded engine {plain_s:.2f} s, sharded {sharded_s:.2f} s; "
        f"launches in the sharded run {launches}")
    for name in (*SHARD_KERNELS, "row_stats"):
        check(launches[name] > 0, f"phase 12(a): the sharded engine never launched {name}")
    for name in set(SHARD_OF.values()):
        check(launches[name] == 0, f"phase 12(a): the sharded engine launched {name}")
    check(sharded == plain, "phase 12(a): the sharded engine's emission differs from the unsharded one's")
    check(gen.sums_trace == plain_gen.sums_trace and len(gen.sums_trace) > 0,
          "phase 12(a): the sharded engine's sums differ from the unsharded one's")
    attempts = len(gen.sums_trace)
    per_attempt = {k: {"calls_per_attempt": v["calls"] / attempts,
                       "bytes_per_attempt": v["bytes"] / attempts, "max_bytes": v["max_bytes"]}
                   for k, v in traffic.items()}
    log(f"phase 12(a): NCCL collectives over {attempts} attempts (the seeds taken; a burst's "
        "loners after the first not counted), "
        "by kind: " + json.dumps(per_attempt))
    return {"launches": launches, "train_encode_s": train_s, "unsharded_engine_s": plain_s,
            "sharded_engine_s": sharded_s, "clusters": len(sharded), "attempts": attempts,
            "identical": True, "collectives": per_attempt, "variants": variants,
            "_labels": labels_of(sharded, N_CONTIGS)}


def engine_pair(dev, mesh, latent: np.ndarray, lengths: np.ndarray, label: str, kw: dict,
                phase: str = "12(a)") -> dict:
    """One of 12(a)'s (or 12(d)'s) engine runs: `DIST_CLUSTERS`
    clusters of the latent from the unsharded engine and then from the
    row-sharded one (a world of one) with generator arguments `kw`, the
    launch counters and the collective tally set to 0 just before the
    sharded run and read just after. Gates: emission, every attempt's sums
    and the subset and lane counters bit for bit the unsharded engine's; at
    full scope every shard entry point launched and the index entry points
    of the same kernels not (`row_stats` runs only where a seed may be a
    loner: its launches are the data's); at
    the subset scope `gather_ball_shard` launched and `gather_ball`,
    `medoid_sweep` and `spec_sweep` not, the subset wander (and, lanes on,
    attempt lanes) ran; at bfloat16 the bf16 variants of the three shard
    sweeps launched, their float32 ones and the index entry points not, and
    neither the gather nor `row_sweep`. Logged: the collectives by kind,
    calls and bytes an attempt (the seeds taken). The result holds the
    launches by kernel, by type and by F_pad."""
    from vamb_torch import kernels as K
    from vamb_torch.cluster import ClusterGenerator

    t = time.time()
    plain_gen = ClusterGenerator(latent.copy(), lengths, rng_seed=SEED, device=dev, **kw)
    plain_gen.sums_trace = []
    plain = engine_run(plain_gen, DIST_CLUSTERS)
    torch.cuda.synchronize()
    plain_s = time.time() - t
    K.reset_launch_counts()
    mesh.reset_traffic()
    t = time.time()
    gen = ClusterGenerator(latent.copy(), lengths, rng_seed=SEED, mesh=mesh, **kw)
    gen.sums_trace = []
    sharded = engine_run(gen, DIST_CLUSTERS)
    torch.cuda.synchronize()
    sharded_s = time.time() - t
    launches = {k.__name__: k.launches for k in K.KERNELS}
    by_dtype = {k.__name__: dict(k.launches_by_dtype) for k in K.KERNELS if k.launches_by_dtype}
    by_fpad = {k.__name__: dict(k.launches_by_fpad) for k in K.KERNELS if k.launches_by_fpad}
    traffic = mesh.traffic
    what = f"phase {phase}, {label}"
    check(sharded == plain, f"{what}: the sharded engine's emission differs from the unsharded one's")
    check(gen.sums_trace == plain_gen.sums_trace and len(gen.sums_trace) > 0,
          f"{what}: the sharded engine's sums differ from the unsharded one's")
    check(gen.subset_counts == plain_gen.subset_counts and gen.lane_counts == plain_gen.lane_counts,
          f"{what}: the sharded engine's subset or lane counters differ from the unsharded one's")
    if "distance_dtype" in kw:
        for name in BF16_SHARD_KERNELS:
            check(by_dtype.get(name, {}).get("bfloat16", 0) > 0
                  and by_dtype.get(name, {}).get("float32", 0) == 0,
                  f"{what}: {name} did not launch its bf16 variant alone: {by_dtype.get(name)}")
        for name in ("medoid_sweep", "spec_sweep", "candidate_density_sweep", "gather_ball_shard",
                     "gather_blocks", "row_sweep"):
            check(launches[name] == 0, f"{what}: the sharded engine launched {name}")
    elif kw.get("wander_scope") != "subset":
        for name in SHARD_KERNELS:
            check(launches[name] > 0, f"{what}: the sharded engine never launched {name}")
        for name in set(SHARD_OF.values()):
            check(launches[name] == 0, f"{what}: the sharded engine launched {name}")
    else:
        check(launches["gather_ball_shard"] > 0, f"{what}: the sharded engine never launched "
              "gather_ball_shard")
        for name in ("gather_blocks", "medoid_sweep", "spec_sweep"):
            check(launches[name] == 0, f"{what}: the sharded engine launched {name}")
        check(gen.subset_counts["attempts"] > 0, f"{what}: no subset wander ran")
        if kw.get("attempt_batch") == "on":
            check(gen.lane_counts["lanes"] > 0, f"{what}: no attempt lane ran")
    attempts = len(gen.sums_trace)
    per_attempt = {k: {"calls_per_attempt": v["calls"] / attempts,
                       "bytes_per_attempt": v["bytes"] / attempts, "max_bytes": v["max_bytes"]}
                   for k, v in traffic.items()}
    log(f"{what}: {DIST_CLUSTERS} clusters bit for bit the unsharded engine's (unsharded "
        f"{plain_s:.2f} s, sharded {sharded_s:.2f} s; subset {json.dumps(gen.subset_counts)}; lanes "
        f"{gen.lane_counts['lanes']} climbed, {gen.lane_counts['admitted']} admitted); launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}, by type {json.dumps(by_dtype)}; "
        f"NCCL collectives over {attempts} attempts by kind: " + json.dumps(per_attempt))
    return {"launches": launches, "launches_by_dtype": by_dtype, "launches_by_fpad": by_fpad,
            "unsharded_engine_s": plain_s, "sharded_engine_s": sharded_s, "attempts": attempts,
            "subset_counts": gen.subset_counts, "lane_counts": gen.lane_counts, "identical": True,
            "collectives": per_attempt}


def run_dist_two(tmp: Path, labels_one: np.ndarray) -> dict:
    """Phase 12(b): two processes sharing the card over gloo (`dist_rank`),
    on 12(a)'s dataset (its `composition.npz` and `abundance.npz`, so the
    two ranks do not parse the FASTA anew): `bin default`'s library path at
    W = 2, then the
    same W = 2 engine on the CPU. A rank that fails or outlives
    DIST_RANK_TIMEOUT_S fails the phase; the children are killed whatever
    happens. Gates: the parameters' checksums equal across ranks after
    every epoch, and the first DIST_CPU_CLUSTERS clusters on the card
    identical to the CPU's. Logged: the W = 2 clusters' agreement with
    12(a)'s W = 1 clusters on sampled pairs."""
    out = tmp / "b"
    out.mkdir()
    cmd = lambda r: [sys.executable, str(Path(__file__).resolve()), "--dist-rank",  # noqa: E731
                     str(tmp / "rendezvous_b"), str(r), str(tmp / "a"), str(out)]
    t = time.time()
    procs = [subprocess.Popen(cmd(r), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=str(ROOT)) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=max(1.0, t + DIST_RANK_TIMEOUT_S - time.time()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"check failed: phase 12(b): rank {r} outlived "
                                     f"{DIST_RANK_TIMEOUT_S} s") from None
            check(p.returncode == 0, f"phase 12(b): rank {r} failed ({p.returncode}):\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.time() - t
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    check(len(ranks[0]["checksums"]) == 2 and ranks[0]["checksums"] == ranks[1]["checksums"],
          f"phase 12(b): the ranks' parameter checksums differ: {[r['checksums'] for r in ranks]}")
    for r in ranks:
        check(all(r["launches"].get(name, 0) > 0 for name in (*SHARD_KERNELS, "row_stats")),
              f"phase 12(b): rank {r['rank']} did not launch every shard entry point: {r['launches']}")
        check(r["card_vs_cpu_identical"] == DIST_CPU_CLUSTERS,
              f"phase 12(b): rank {r['rank']}: the W = 2 clusters on the card differ from the CPU's "
              f"after {r['card_vs_cpu_identical']}")
    labels_two = clusters_of(out / "rank0" / "vae_clusters_unsplit.tsv", N_CONTIGS)
    agree = pair_agreement(labels_one, labels_two, SEED)
    result = {"wall_s": wall, "ranks": ranks, "w2_vs_w1": agree}
    log("phase 12(b): " + json.dumps(result))
    return result


def run_dist_engine_two(tmp: Path, latent: np.ndarray, lengths: np.ndarray, source: str) -> dict:
    """Phase 12(c): two processes sharing the card over gloo
    (`dist_engine_rank`), each clustering the 300,032-column latent (phase
    5's, or `ab_latent()` where phase 5 did not run) at the engine's default
    flags, so "auto" takes the subset wander and attempt lanes,
    DIST_CLUSTERS clusters; then the same W = 2 engine on the CPU over the
    same group. A rank that fails or outlives DIST_RANK_TIMEOUT_S fails the
    phase; the children are killed whatever happens. Gates: the two ranks'
    clusters identical, each rank's first DIST_CPU_CLUSTERS identical to the
    CPU's, the subset wander, attempt lanes and `gather_ball_shard` run on
    the card. Logged: the collectives an attempt by kind."""
    out = tmp / "c"
    out.mkdir()
    inputs = tmp / "latent_300k.npz"
    np.savez(inputs, latent=latent, lengths=lengths)
    cmd = lambda r: [sys.executable, str(Path(__file__).resolve()), "--dist-engine-rank",  # noqa: E731
                     str(tmp / "rendezvous_c"), str(r), str(inputs), str(out)]
    t = time.time()
    procs = [subprocess.Popen(cmd(r), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=str(ROOT)) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=max(1.0, t + DIST_RANK_TIMEOUT_S - time.time()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"check failed: phase 12(c): rank {r} outlived "
                                     f"{DIST_RANK_TIMEOUT_S} s") from None
            check(p.returncode == 0, f"phase 12(c): rank {r} failed ({p.returncode}):\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.time() - t
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    check(len(ranks[0]["clusters"]) == DIST_CLUSTERS and ranks[0]["clusters"] == ranks[1]["clusters"],
          "phase 12(c): the two ranks' clusters differ")
    for r in ranks:
        check(r["card_vs_cpu_identical"] == DIST_CPU_CLUSTERS,
              f"phase 12(c): rank {r['rank']}: the W = 2 clusters on the card differ from the CPU's "
              f"after {r['card_vs_cpu_identical']}")
        check(r["subset_ball"] > 0 and r["subset_counts"]["attempts"] > 0 and r["lane_counts"]["lanes"] > 0,
              f"phase 12(c): rank {r['rank']} did not take the subset wander and lanes at the default flags")
        check(r["launches"].get("gather_ball_shard", 0) > 0,
              f"phase 12(c): rank {r['rank']} never launched gather_ball_shard")
        r.pop("clusters")
    result = {"wall_s": wall, "latent": source, "ranks": ranks}
    log("phase 12(c): " + json.dumps(result))
    return result


def dist_engine_rank(rendezvous: str, rank: int, inputs: Path, out: Path) -> int:
    """One rank of phase 12(c): join a gloo group of 2 on the card, cluster
    the latent in `inputs` on the row-sharded engine at its default flags
    (DIST_CLUSTERS clusters, the launch counters and the collective tally
    set to 0 just before and read just after), then the same W = 2 engine
    on the CPU over the same group (DIST_CPU_CLUSTERS clusters). Writes
    `out/rank<r>.json`."""
    import torch.distributed as dist
    from vamb_torch import kernels as K
    from vamb_torch.cluster import ClusterGenerator
    from vamb_torch.parallel import distributed_init, make_mesh

    torch.set_num_threads(4)
    distributed_init(f"file://{rendezvous}", 2, rank, device="cuda", backend="gloo",
                     timeout_s=DIST_RANK_TIMEOUT_S)
    data = np.load(inputs)
    latent, lengths = data["latent"], data["lengths"]
    mesh = make_mesh(2, device="cuda")
    K.reset_launch_counts()
    t = time.time()
    gen = ClusterGenerator(latent.copy(), lengths, rng_seed=SEED, mesh=mesh)
    mesh.reset_traffic()  # the attempts' traffic, not the construction's broadcast of the latent
    gen.sums_trace = []
    card = engine_run(gen, DIST_CLUSTERS)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {k.__name__: k.launches for k in K.KERNELS if k.launches}
    attempts = len(gen.sums_trace)
    per_attempt = {k: {"calls_per_attempt": v["calls"] / attempts,
                       "bytes_per_attempt": v["bytes"] / attempts, "max_bytes": v["max_bytes"]}
                   for k, v in mesh.traffic.items()}
    t = time.time()
    cpu_gen = ClusterGenerator(latent.copy(), lengths, rng_seed=SEED, device="cpu",
                               mesh=make_mesh(2, device="cpu"))
    cpu = engine_run(cpu_gen, DIST_CPU_CLUSTERS)
    cpu_s = time.time() - t
    same = next((i for i, (a, b) in enumerate(zip(card, cpu)) if a != b), min(len(card), len(cpu)))
    (out / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "engine_s": wall, "cpu_engine_s": cpu_s, "subset_ball": gen.Q,
        "subset_counts": gen.subset_counts, "lane_counts": gen.lane_counts, "attempts": attempts,
        "launches": launches, "collectives": per_attempt, "card_vs_cpu_identical": same,
        "clusters": card}))
    dist.destroy_process_group()
    return 0


def dist_rank(rendezvous: str, rank: int, inputs: Path, out: Path) -> int:
    """One rank of phase 12(b): join a gloo group of 2 on the card, run
    `bin default`'s library path (`pipeline.run_bin_default` on the
    composition and abundance in `inputs`, 2 epochs at batch DIST_BATCH, -q
    1, DIST_CLUSTERS clusters) into `out/rank<r>`, then cluster rank 0's
    latent on the CPU over the same group and hold its first
    DIST_CPU_CLUSTERS clusters to the card's. Writes `out/rank<r>.json`."""
    import torch.distributed as dist
    from vamb_torch import kernels as K
    from vamb_torch import pipeline
    from vamb_torch.cluster import ClusterGenerator
    from vamb_torch.composition import Composition
    from vamb_torch.log import setup_logging
    from vamb_torch.parallel import distributed_init, make_mesh
    from vamb_torch.utils import read_npz

    torch.set_num_threads(4)
    distributed_init(f"file://{rendezvous}", 2, rank, device="cuda", backend="gloo",
                     timeout_s=DIST_RANK_TIMEOUT_S)
    outdir = out / f"rank{rank}"
    outdir.mkdir()
    setup_logging(outdir)
    opt = pipeline.BinDefaultOptions(
        general=pipeline.GeneralOptions(outdir, seed=SEED, device=pipeline.process_device("cuda")),
        comp=pipeline.CompositionOptions(composition=inputs / "composition.npz"),
        abundance=pipeline.AbundanceOptions(abundancepath=inputs / "abundance.npz"),
        vae=pipeline.VAEOptions(nepochs=2, batchsize=DIST_BATCH, batchsteps=[1]),
        clustering=pipeline.ClusterOptions(max_clusters=DIST_CLUSTERS),
        output=pipeline.BinOutputOptions())
    K.reset_launch_counts()
    t = time.time()
    pipeline.run_bin_default(opt)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {k.__name__: k.launches for k in K.KERNELS if k.launches}
    text = (outdir / "log.txt").read_text()
    checksums = re.findall(r"Parameters identical on 2 ranks \(checksum (-?\d+)\)", text)
    dist.barrier()  # rank 0's latent and clusters are written
    latent = read_npz(out / "rank0" / "latent.npz")
    lengths = Composition.load(inputs / "composition.npz").metadata.lengths
    t = time.time()
    gen = ClusterGenerator(latent, lengths, rng_seed=SEED, device="cpu", mesh=make_mesh(2, device="cpu"))
    cpu = [sorted(int(i) for i in c.members) for c in itertools.islice(gen, DIST_CPU_CLUSTERS)]
    cpu_s = time.time() - t
    card = {}
    for name, contig in read_tsv(out / "rank0" / "vae_clusters_unsplit.tsv")[1:]:
        card.setdefault(name, []).append(int(contig.split("C")[1]))
    card = [sorted(m) for m in card.values()][:DIST_CPU_CLUSTERS]
    same = next((i for i, (a, b) in enumerate(zip(card, cpu)) if a != b), min(len(card), len(cpu)))
    (out / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "device": opt.general.device, "bin_default_s": wall,
        "stage_times": stage_times(outdir / "log.txt"), "cpu_engine_s": cpu_s,
        "checksums": checksums, "launches": launches, "card_vs_cpu_identical": same}))
    dist.destroy_process_group()
    return 0


# phase 12(d) and 12(e): the models' data-parallel training at published widths

DIST_MODEL_CONTIGS, DIST_MODEL_GENOMES = 20_000, 200  # phase 4's recipe cut to 20,000 contigs
AAE_WIDTHS = (547, 283, 700)  # the AAE's published hidden, z and y widths (`bin avamb`'s defaults)
# each model's published widths, batch and epochs in 12(d) and 12(e): Taxometer
# 4 x 512 (pipeline.predict_taxonomy's), VAEVAE 512-512-32, the AAE 547 / 283 / 700
DIST_MODEL_RUNS = {"taxometer": dict(nepochs=2, batchsize=1024, batchsteps=[]),
                   "vaevae": dict(nepochs=1, batchsize=256, batchsteps=[]),
                   "aae": dict(nepochs=1, batchsize=256, batchsteps=[])}
# 12(e)'s three commands through `main` at W = 2 over gloo, every collective
# through host memory: the published widths, one epoch each at batch 1,024
# (4 x fewer steps than (d)'s VAEVAE and AAE), 50 clusters a `bin`
DIST_E_EPOCHS, DIST_E_BATCH, DIST_E_CLUSTERS = 1, 1024, 50
# 12(d)'s engine runs at F_pad 288, each sharded and unsharded: the trained
# AAE's z latent at full scope (after one epoch on this synthetic data it
# is degenerate, a few clusters hold every contig, as phase 9's after two),
# and a 283-wide latent of 200 clumps of 100 points (`wide_latent`) at full
# scope, at the forced subset scope and at bfloat16 distances
DIST_Z_VARIANTS = {"full scope": {}, "subset": {"wander_scope": "subset"},
                   "bfloat16": {"distance_dtype": "bfloat16"}}


def wide_latent(n_clumps: int, per: int, dim: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(n_clumps x per, dim) float32 points in tight clumps (noise 0.01 a
    feature around unit centres) and their lengths: a latent as wide as the
    AAE's z with the structure a trained one would have."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clumps, dim))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = np.repeat(centers, per, axis=0) + rng.normal(scale=0.01, size=(n_clumps * per, dim))
    return x.astype(np.float32), rng.integers(2000, 50_000, n_clumps * per).astype(np.float32)
# 12(d)'s tolerance of `trainmodel(mesh=)` at W = 1 against `trainmodel()` on
# the card: Taxometer and the AAE bit for bit (`layers.batch_mean` is the
# sum over the count, and at these power-of-two batches torch's mean on the
# card, the sum times 1 / count, rounds alike). VAEVAE's joint loss adds its
# batch-mean terms once where the unsharded loss adds them to every row: it
# may round an ulp apart a step, which Adam turns into a step of up to ~lr
# for each weight whose gradient is rounding noise (on the CPU the two
# trainings part so). So VAEVAE is held to its epoch metrics within
# VAEVAE_W1_RTOL and each weight within steps x lr (Adam's step, 1e-3).
VAEVAE_W1_RTOL = 1e-3
ADAM_LR = 1e-3


def metrics_of(lines: list) -> np.ndarray:
    "The metrics of each `Epoch:` log line of a model's training, in order."
    return np.array([[float(f.split()[0]) for f in line.split("Batchsize")[0].split(":")[2:]]
                     for line in lines if "Epoch:" in line])


def build_dist_model(name: str, nodes: list, parents: list, device):
    "The model `name` at its published widths (DIST_MODEL_RUNS)."
    from vamb_torch.models.aae import AAE
    from vamb_torch.models.taxometer import Taxometer
    from vamb_torch.models.vaevae import VAEVAE

    if name == "taxometer":
        return Taxometer(N_SAMPLES, len(nodes), nodes, parents, nhiddens=[512] * 4,
                         hier_loss="flat_softmax", seed=SEED, device=device)
    if name == "vaevae":
        return VAEVAE(N_SAMPLES, len(nodes), nodes, parents, nhiddens=[512, 512], nlatent=32,
                      hier_loss="flat_softmax", seed=SEED, device=device)
    return AAE(N_SAMPLES, *AAE_WIDTHS, seed=SEED, device=device)


def run_dist_models_one(dev, tmp: Path) -> dict:
    """Phase 12(d): a world of one on NCCL, on the card. 20,000 contigs of
    phase 4's recipe with `write_taxonomy`'s annotation; each of Taxometer,
    VAEVAE and the AAE at its published widths (DIST_MODEL_RUNS) trained
    without a mesh and then with `mesh=` from the same seed. Gates: the
    replicas checked after every epoch of the mesh training, its
    parameters and BatchNorm statistics within the stated tolerance of the
    unmeshed training's (Taxometer and the AAE bit for bit, VAEVAE's
    metrics within VAEVAE_W1_RTOL and its weights within steps x lr), then
    the meshed AAE's z latent (283 wide, F_pad 288) clustered by the
    unsharded and the row-sharded engine, at most DIST_CLUSTERS clusters
    (`engine_pair`), and `wide_latent`'s 283-wide clumps likewise at full
    scope, at the forced subset scope and at bfloat16 distances, each bit
    for bit (emission and sums), the shard entry points launched at F_pad
    288 alone, and at full scope the index entry points not at all. Logged: ms a step with and without
    the mesh, and the collectives a step by kind (calls, bytes)."""
    from datetime import timedelta

    import torch.distributed as dist
    from vamb_torch import pipeline
    from vamb_torch.models import make_dataset
    from vamb_torch.parallel import make_mesh
    from vamb_torch.taxonomy import Taxonomy
    from vamb_torch.utils import BinSplitter
    from vamb_torch.utils.checkpoint import params_to_jax

    data = tmp / "data_d"
    data.mkdir()
    t = time.time()
    genome = write_dataset(data, DIST_MODEL_CONTIGS, DIST_MODEL_GENOMES, N_SAMPLES, SEED)
    write_taxonomy(data / "taxonomy.tsv", genome, SEED)
    log(f"phase 12(d): wrote {DIST_MODEL_CONTIGS} contigs of phase 4's recipe and their taxonomy in "
        f"{time.time() - t:.1f} s")
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'rendezvous_d'}", world_size=1,
                            rank=0, timeout=timedelta(seconds=DIST_RANK_TIMEOUT_S))
    try:
        mesh = make_mesh(1, device="cuda")
        general = pipeline.GeneralOptions(tmp / "d", seed=SEED, device=str(mesh.device))
        general.outdir.mkdir()
        comp, ab = pipeline.load_composition_and_abundance(
            general, pipeline.CompositionOptions(fasta=data / "contigs.fna"),
            pipeline.AbundanceOptions(abundance_tsv=data / "abundance.tsv"), BinSplitter(None))
        ds = make_dataset(ab.matrix, comp.matrix, comp.metadata.lengths)
        taxonomy = Taxonomy.from_file(data / "taxonomy.tsv", comp.metadata, False)
        nodes, _, parents, targets = pipeline.targets_from_taxonomy(taxonomy.contig_taxonomies)
        models, trained = {}, {}
        for name, kw in DIST_MODEL_RUNS.items():
            args = (ds,) if name == "aae" else (ds, targets)
            steps = kw["nepochs"] * (DIST_MODEL_CONTIGS // kw["batchsize"])
            runs = {}
            for label, m in (("no mesh", None), ("mesh", mesh)):
                model = build_dist_model(name, nodes, parents, mesh.device)
                lines = []
                mesh.reset_traffic()
                torch.cuda.synchronize()
                t = time.time()
                model.trainmodel(*args, logger=lines.append, mesh=m, **kw)
                torch.cuda.synchronize()
                runs[label] = {"ms_a_step": (time.time() - t) * 1e3 / steps,
                               "flat": params_to_jax(model.state_dict()), "lines": lines}
                if m is not None:  # the kinds of a step, and those of the run or an epoch
                    once = ("replicate", "metrics", "checksums")
                    runs[label]["collectives_a_step"] = {
                        k: {"calls": v["calls"] / steps, "bytes": v["bytes"] / steps}
                        for k, v in mesh.traffic.items() if k not in once}
                    runs[label]["collectives_a_run"] = {
                        k: {"calls": v["calls"], "bytes": v["bytes"]}
                        for k, v in mesh.traffic.items() if k in once}
                    trained[name] = model
            checks = sum("Parameters identical on 1 ranks" in ln for ln in runs["mesh"]["lines"])
            check(checks == kw["nepochs"], f"phase 12(d): {name}'s replicas were checked {checks} "
                  f"times in {kw['nepochs']} epochs")
            a, b = runs["no mesh"]["flat"], runs["mesh"]["flat"]
            diff = {k: float(np.abs(b[k] - a[k]).max()) for k in a}
            rel = {k: float(np.linalg.norm((b[k] - a[k]).ravel()) / max(np.linalg.norm(a[k].ravel()), 1e-30))
                   for k in a}
            check(all(np.isfinite(v).all() for v in b.values()), f"phase 12(d): {name} trained to a "
                  "non-finite value")
            if name == "vaevae":
                ma, mb = (metrics_of(runs[k]["lines"]) for k in ("no mesh", "mesh"))
                check(ma.shape == mb.shape and np.allclose(mb, ma, rtol=VAEVAE_W1_RTOL, atol=0),
                      f"phase 12(d): VAEVAE's epoch metrics with a mesh {mb} are not those without {ma}")
                check(max(diff.values()) <= steps * ADAM_LR, f"phase 12(d): VAEVAE's mesh training is "
                      f"{max(diff.values())} from its training without one")
            else:
                check(max(diff.values()) == 0.0, f"phase 12(d): {name}'s mesh training differs from its "
                      f"training without one by {max(diff.values())}")
            models[name] = {
                "steps": steps, "ms_a_step_no_mesh": runs["no mesh"]["ms_a_step"],
                "ms_a_step_mesh": runs["mesh"]["ms_a_step"],
                "collectives_a_step": runs["mesh"]["collectives_a_step"],
                "collectives_a_run": runs["mesh"]["collectives_a_run"],
                "metrics_no_mesh": metrics_of(runs["no mesh"]["lines"]).tolist(),
                "metrics_mesh": metrics_of(runs["mesh"]["lines"]).tolist(),
                "max_abs_diff": max(diff.values()), "max_relative_norm": max(rel.values()),
                "checksums_checked": checks}
            log(f"phase 12(d): {name} at its published widths, {kw}: {json.dumps(models[name])}")
        clusters_y, latent = trained["aae"].get_latents(list(comp.metadata.identifiers), ds)
        check(latent.shape == (DIST_MODEL_CONTIGS, AAE_WIDTHS[1]) and np.isfinite(latent).all(),
              "phase 12(d): the AAE's z latent is not (N, 283) finite")
        z_run = engine_pair(dev, mesh, latent, comp.metadata.lengths, "the AAE's z latent, full scope",
                            {}, phase="12(d)")
        wide, wide_len = wide_latent(DIST_MODEL_CONTIGS // 100, 100, AAE_WIDTHS[1], SEED)
        variants = {label: engine_pair(dev, mesh, wide, wide_len, f"a 283-wide latent, {label}", kw,
                                       phase="12(d)")
                    for label, kw in DIST_Z_VARIANTS.items()}
    finally:
        dist.destroy_process_group()
    for label, v in (("the z latent", z_run), *variants.items()):
        for name, by in v["launches_by_fpad"].items():
            if name.endswith("_shard"):
                check(set(by) == {AAE_F_PAD}, f"phase 12(d), {label}: {name} launched at F_pad {by}")
    for label, v in (("the z latent", z_run), ("full scope", variants["full scope"])):
        check(all(set(v["launches_by_fpad"].get(k, {})) == {AAE_F_PAD} for k in SHARD_KERNELS[:3]),
              f"phase 12(d), {label}: the shard sweeps not launched at F_pad {AAE_F_PAD} alone")
    return {"contigs": DIST_MODEL_CONTIGS, "models": models, "z_latent_clusters": z_run,
            "y_clusters": len(clusters_y), "wide_latent_engine": variants}


def run_dist_models_two(tmp: Path) -> dict:
    """Phase 12(e): two processes sharing the card over gloo
    (`dist_main_rank`), each through `main` at W = 2 on 12(d)'s data:
    `taxometer`, then `bin taxvamb` on its refined TSV, then `bin avamb`.
    A rank that fails or outlives DIST_RANK_TIMEOUT_S fails the phase; the
    children are killed whatever happens. Gates: each rank's parameter
    checksums equal, epoch for epoch, in each command; process 0's
    artifacts and TSVs read back, each `.proc1` removed; each rank's first
    DIST_E_CPU_CLUSTERS clusters of the AAE's z latent from the W = 2 engine
    on the CPU equal to the card's (all of them where the degenerate latent
    holds fewer), and the same for `wide_latent`'s 283-wide clumps."""
    from vamb_torch.models.aae import AAE
    from vamb_torch.models.taxometer import Taxometer
    from vamb_torch.models.vaevae import VAEVAE
    from vamb_torch.utils import read_npz

    out = tmp / "e"
    out.mkdir()
    cmd = lambda r: [sys.executable, str(Path(__file__).resolve()), "--dist-main-rank",  # noqa: E731
                     str(tmp / "rendezvous_e"), str(r), str(tmp / "data_d"), str(out)]
    t = time.time()
    procs = [subprocess.Popen(cmd(r), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=str(ROOT)) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=max(1.0, t + DIST_RANK_TIMEOUT_S - time.time()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"check failed: phase 12(e): rank {r} outlived "
                                     f"{DIST_RANK_TIMEOUT_S} s") from None
            check(p.returncode == 0, f"phase 12(e): rank {r} failed ({p.returncode}):\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.time() - t
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    for cmd_name in ("taxometer", "taxvamb", "avamb"):
        sums = [r["checksums"][cmd_name] for r in ranks]
        check(len(sums[0]) == DIST_E_EPOCHS and sums[0] == sums[1],
              f"phase 12(e): {cmd_name}: the ranks' parameter checksums differ: {sums}")
    for r in ranks:
        n_card, n_cpu = r["z_clusters"]
        check(n_card == n_cpu == min(DIST_E_CPU_CLUSTERS, n_card) > 0
              and r["card_vs_cpu_identical"] == n_card,
              f"phase 12(e): rank {r['rank']}: the W = 2 z clusters on the card ({n_card}) differ from the "
              f"CPU's ({n_cpu}) after {r['card_vs_cpu_identical']}")
        check(r["wide_card_vs_cpu_identical"] == DIST_E_CPU_CLUSTERS,
              f"phase 12(e): rank {r['rank']}: the W = 2 clusters of `wide_latent` on the card differ from "
              f"the CPU's after {r['wide_card_vs_cpu_identical']}")
        check(all(set(by) == {str(AAE_F_PAD)} for k, by in r["launches_by_fpad"]["avamb"].items()
                  if k.endswith("_shard")) and r["launches"]["avamb"].get("medoid_sweep_shard", 0) > 0,
              f"phase 12(e): rank {r['rank']}: bin avamb's shard sweeps not at F_pad {AAE_F_PAD} alone: "
              f"{r['launches_by_fpad']['avamb']}")
    # process 0's artifacts, read back with the port's own loaders
    for sub in ("tm", "tv", "av"):
        check(not (out / sub / ".proc1").exists(), f"phase 12(e): {sub}/.proc1 was not removed")
    Taxometer.load(out / "tm" / "predictor_model.npz", device="cpu")
    VAEVAE.load(out / "tv" / "vaevae_model.npz", device="cpu")
    AAE.load(out / "av" / "aae_model.npz", device="cpu")
    rows = read_tsv(out / "tm" / "results_taxometer.tsv")
    check(len(rows) == DIST_MODEL_CONTIGS + 1, "phase 12(e): results_taxometer.tsv rows")
    for name, width in (("tv/vaevae_latent.npz", 32), ("av/aae_z_latent.npz", AAE_WIDTHS[1])):
        latent = read_npz(out / name)
        check(latent.shape == (DIST_MODEL_CONTIGS, width) and np.isfinite(latent).all(),
              f"phase 12(e): {name} is not (N, {width}) finite")
    for name in ("tv/vaevae_clusters_unsplit.tsv", "av/aae_z_clusters_unsplit.tsv",
                 "av/aae_y_clusters_unsplit.tsv"):
        members = [m for _, m in read_tsv(out / name)[1:]]
        check(len(members) == len(set(members)) > 0, f"phase 12(e): {name} lists a contig twice")
    result = {"wall_s": wall, "ranks": ranks}
    log("phase 12(e): " + json.dumps(result))
    return result


def dist_main_rank(rendezvous: str, rank: int, data: Path, out: Path) -> int:
    """One rank of phase 12(e): join a gloo group of 2 on the card, then run
    `main` (which finds the group joined) three times into `out`:
    `taxometer`, `bin taxvamb` on rank 0's refined TSV and `bin avamb`, at
    the published widths, DIST_E_EPOCHS epochs at batch DIST_E_BATCH,
    DIST_E_CLUSTERS clusters a `bin`, with a barrier after each; each run's parameter checksums (this
    rank's own, recorded as `check_replicas` takes them) and launches.
    Then rank 0's z latent clustered by the W = 2 engine on the CPU over
    the same group, its first DIST_E_CPU_CLUSTERS clusters held to rank 0's
    `aae_z_clusters_unsplit.tsv`, and `wide_latent`'s first
    DIST_E_CPU_CLUSTERS clusters from the W = 2 engine on the card and on the
    CPU. Writes `out/rank<r>.json`."""
    import torch.distributed as dist
    from vamb_torch import kernels as K
    from vamb_torch.__main__ import main
    from vamb_torch.cluster import ClusterGenerator
    from vamb_torch.composition import Composition
    from vamb_torch.models import training
    from vamb_torch.parallel import distributed_init, make_mesh
    from vamb_torch.utils import read_npz

    torch.set_num_threads(4)
    distributed_init(f"file://{rendezvous}", 2, rank, device="cuda", backend="gloo",
                     timeout_s=DIST_RANK_TIMEOUT_S)
    sums = []
    checksum = training.param_checksum

    def recording(params):
        c = checksum(params)
        sums.append(int(c))
        return c

    training.param_checksum = recording
    common = ["--fasta", str(data / "contigs.fna"), "--abundance_tsv", str(data / "abundance.tsv"),
              "--seed", str(SEED)]
    e, b, c = str(DIST_E_EPOCHS), str(DIST_E_BATCH), str(DIST_E_CLUSTERS)
    runs = {
        "taxometer": ["taxometer", "--outdir", str(out / "tm"), *common, "--taxonomy",
                      str(data / "taxonomy.tsv"), "-pe", e, "-pt", b],
        "taxvamb": ["bin", "taxvamb", "--outdir", str(out / "tv"), *common, "--taxonomy",
                    str(out / "tm" / "results_taxometer.tsv"), "-e", e, "-t", b, "-q", "-c", c],
        "avamb": ["bin", "avamb", "--outdir", str(out / "av"), *common, "--e_aae", e, "--t_aae", b,
                  "--q_aae", "-c", c],
    }
    result = {"rank": rank, "wall_s": {}, "checksums": {}, "launches": {}, "launches_by_fpad": {}}
    for name, argv in runs.items():
        sums.clear()
        K.reset_launch_counts()
        t = time.time()
        main(argv, device="cuda")
        torch.cuda.synchronize()
        result["wall_s"][name] = time.time() - t
        result["checksums"][name] = list(sums)
        result["launches"][name] = {k.__name__: k.launches for k in K.KERNELS if k.launches}
        result["launches_by_fpad"][name] = {k.__name__: {str(f): c for f, c in k.launches_by_fpad.items()}
                                            for k in K.KERNELS if k.launches_by_fpad}  # keys as JSON has them
        dist.barrier()  # rank 0's outputs are written before the next command reads them
    latent = read_npz(out / "av" / "aae_z_latent.npz")
    lengths = Composition.load(out / "av" / "composition.npz").metadata.lengths
    t = time.time()
    gen = ClusterGenerator(latent, lengths, rng_seed=SEED, device="cpu", mesh=make_mesh(2, device="cpu"))
    cpu = [sorted(int(i) for i in c.members) for c in itertools.islice(gen, DIST_E_CPU_CLUSTERS)]
    result["cpu_engine_s"] = time.time() - t
    card = {}
    for name, contig in read_tsv(out / "av" / "aae_z_clusters_unsplit.tsv")[1:]:
        card.setdefault(name, []).append(int(contig.split("C")[1]))
    card = [sorted(m) for m in card.values()][:DIST_E_CPU_CLUSTERS]
    result["z_clusters"] = [len(card), len(cpu)]  # after one epoch the z latent holds a few
    result["card_vs_cpu_identical"] = next(
        (i for i, (a, b) in enumerate(zip(card, cpu)) if a != b), min(len(card), len(cpu)))
    # the W = 2 engine at F_pad 288 on a latent with structure: card and CPU
    wide, wide_len = wide_latent(DIST_MODEL_CONTIGS // 100, 100, AAE_WIDTHS[1], SEED)
    runs = [[sorted(int(i) for i in c.members) for c in itertools.islice(
        ClusterGenerator(wide.copy(), wide_len, rng_seed=SEED, device=d, mesh=make_mesh(2, device=d)),
        DIST_E_CPU_CLUSTERS)] for d in ("cuda", "cpu")]
    result["wide_card_vs_cpu_identical"] = next(
        (i for i, (a, b) in enumerate(zip(*runs)) if a != b), min(map(len, runs)))
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    dist.destroy_process_group()
    return 0


def shard_rows_json(errs: dict, times: dict, run_one: dict, run_c: dict) -> list:
    """The kernels JSON line's rows of the shard entry points: phase 12's
    checks and times at the whole width of a world of one, and 12(a)'s
    launches (the full-scope run's; `gather_ball_shard`'s from the two
    subset runs, the bf16 variants' from the bfloat16 run), with 12(c)'s
    rank 0's launches beside them."""
    rows = []
    variants = run_one["variants"]
    c_launches = run_c["ranks"][0]["launches"]
    for (name, dtype), r in times.items():
        base = SHARD_OF[name]
        if dtype == "bfloat16":
            launches = variants["bfloat16"]["launches_by_dtype"].get(name, {}).get("bfloat16", 0)
            path = "phase 12(a), bfloat16 (the row-sharded engine, a world of one on NCCL)"
            err = errs[f"{name} bf16"]
        elif name == "gather_ball_shard":
            launches = sum(variants[v]["launches"][name] for v in ("subset, lanes on", "subset, lanes off"))
            path = "phase 12(a), subset lanes on and off (the row-sharded engine, a world of one on NCCL)"
            err = errs[name]
        else:
            launches, err = run_one["launches"][name], errs[name]
            path = "phase 12(a) (the row-sharded engine, a world of one on NCCL)"
        lib_key = "library_note" if r["library_ms"] is None else "library_what"
        lib_text = (LIBRARY_NOTES.get(base, "none") if r["library_ms"] is None
                    else r.get("library_what", "index_select of the matrix's blocks alone"
                               if name == "gather_ball_shard" else None))
        rows.append({
            "name": name, "route": "cuda", "source": CLUSTER_SOURCE, "replaces": REPLACES[base],
            "launches": launches, "max_abs_err": err,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            **({lib_key: lib_text} if lib_text is not None else {}),
            **({"replaces_kind": REPLACES_KIND[base]} if base in REPLACES_KIND else {}),
            "entry_point_of": base, "f_pad": F_PAD, "n_pad": r["n_pad"], "dtype": dtype,
            "path": path, "launches_12c_rank0": c_launches.get(name, 0) if dtype == "float32" else 0,
        })
    return rows


def shard_rows_json_aae(errs: dict, times: dict, run_d: dict, run_e: dict) -> list:
    """The kernels JSON line's rows of the shard entry points at F_pad 288:
    phase 12's checks and times at the whole width of a world of one, and
    12(d)'s launches on its 283-wide latent at F_pad 288 (the three sweeps'
    from its full-scope run, `gather_ball_shard`'s from its subset run, the
    bf16 variants' from its bfloat16 run), with 12(e)'s rank 0's `bin
    avamb` launches beside them."""
    rows = []
    z = run_d["wide_latent_engine"]
    e_launches = run_e["ranks"][0]["launches_by_fpad"]["avamb"]
    for (name, dtype), r in times.items():
        base = SHARD_OF[name]
        if dtype == "bfloat16":
            launches = z["bfloat16"]["launches_by_dtype"].get(name, {}).get("bfloat16", 0)
            path, err = "phase 12(d), bfloat16 (a 283-wide latent, a world of one on NCCL)", errs[f"{name} bf16"]
        else:
            run = "subset" if name == "gather_ball_shard" else "full scope"
            launches = z[run]["launches_by_fpad"].get(name, {}).get(AAE_F_PAD, 0)
            path, err = f"phase 12(d), {run} (a 283-wide latent, a world of one on NCCL)", errs[name]
        lib_key = "library_note" if r["library_ms"] is None else "library_what"
        lib_text = (LIBRARY_NOTES.get(base, "none") if r["library_ms"] is None
                    else r.get("library_what", "index_select of the matrix's blocks alone"
                               if name == "gather_ball_shard" else None))
        rows.append({
            "name": name, "route": "cuda", "source": CLUSTER_SOURCE, "replaces": REPLACES[base],
            "launches": launches, "max_abs_err": err,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            **({lib_key: lib_text} if lib_text is not None else {}),
            **({"replaces_kind": REPLACES_KIND[base]} if base in REPLACES_KIND else {}),
            "entry_point_of": base, "f_pad": AAE_F_PAD, "n_pad": r["n_pad"], "dtype": dtype,
            "path": path,
            "launches_12e_rank0": e_launches.get(name, {}).get(str(AAE_F_PAD), 0) if dtype == "float32" else 0,
        })
    return rows


def run_dist(dev, big=None) -> tuple[list, dict]:
    """Phase 12: the shard entry points' checks and times at F_pad 32 and
    288, 12(a), 12(b), 12(c) (on `big`, phase 5's (latent, lengths), else
    `ab_latent()`), 12(d) and 12(e). Returns (the kernels JSON rows, the
    phase's results)."""
    t = time.time()
    errs, times = check_and_time_shards(dev)
    errs_aae, times_aae = check_and_time_shards(dev, AAE_F_PAD)
    walls = {"kernels_s": time.time() - t}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.time()
        one = run_dist_one(dev, Path(tmp))
        two = run_dist_two(Path(tmp), one.pop("_labels"))
        latent, lengths = big if big is not None else ab_latent()
        source = ("phase 5's latent" if big is not None
                  else "ab_latent(): 300,000 points in 3,000 clumps (phase 5 did not run)")
        three = run_dist_engine_two(Path(tmp), latent, lengths, source)
        walls["a_to_c_s"] = time.time() - t
        t = time.time()
        four = run_dist_models_one(dev, Path(tmp))
        walls["d_s"] = time.time() - t
        t = time.time()
        five = run_dist_models_two(Path(tmp))
        walls["e_s"] = time.time() - t
    log("phase 12 times: " + json.dumps(walls))
    return (shard_rows_json(errs, times, one, three) + shard_rows_json_aae(errs_aae, times_aae, four, five),
            {"world_of_one": one, "two_processes": two, "two_processes_engine": three,
             "models_world_of_one": four, "models_two_processes": five, "times": walls})


def count_attempts(gen) -> list:
    "Count the generator's attempts (one seed chosen each) in the list's one item."
    counter = [0]
    pick = gen._next_seed

    def counted():
        counter[0] += 1
        return pick()

    gen._next_seed = counted
    return counter


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
    t = time.time()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    ops = [a for a in prof.key_averages() if a.device_type == DeviceType.CPU]
    top = sorted(ops, key=lambda a: -a.self_device_time_total)[:6]
    result = {
        "units": count, "wall_s": wall, "ms_per_unit": wall / count * 1e3,
        "trace_analysis_s": time.time() - t,
        "kernels_per_unit": len(kernels) / count, "device_busy_share": busy_s / wall,
        "topk_calls": sum(a.count for a in ops if a.key == "aten::topk"),
        "top_ops": [{"op": a.key[:60], "calls": a.count, "device_ms": a.self_device_time_total / 1e3}
                    for a in top],
    }
    log(f"{label} profile: " + json.dumps(result))
    if not kernels:
        log(f"{label}: the profiler saw no device kernels, so the busy share is not measured")
    return result


def profile_stages(dev, out: Path) -> dict:
    """Where the time of the two device stages goes, on the main path's own
    data: PROFILE_CLUSTERS clusters of the engine on its latent (a unit is
    a cluster; at 300,000 contigs these are subset-wander clusters, and as
    many more at full scope on the same latent follow for comparison), and
    one training epoch of 20 steps at batch 256 on its first 5,120 contigs
    (a unit is an optimizer step; the epoch's threefry draws are counted
    in). Short
    windows: the profiler's own bookkeeping grows with the number of
    events."""
    from vamb_torch import kernels as K
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

    def clusters():
        return sum(1 for _ in itertools.islice(gen, PROFILE_CLUSTERS))

    def per_step(label: str) -> dict:
        """Profile PROFILE_CLUSTERS clusters and count their attempts (seeds tried) and
        wander steps (each launches `candidate_density_sweep` once)."""
        K.reset_launch_counts()
        attempts = count_attempts(gen)
        r = profiled(clusters, label)
        steps = K.candidate_density_sweep.launches
        kernels = r["kernels_per_unit"] * r["units"]
        r["wander_steps"], r["attempts"] = steps, attempts[0]
        r["kernels_per_wander_step"] = kernels / steps if steps else None
        r["kernels_per_attempt"] = kernels / attempts[0]
        log(f"{label}: {attempts[0]} attempts, {steps} wander steps; device kernels "
            f"{r['kernels_per_attempt']} an attempt, {r['kernels_per_wander_step']} a step")
        check(steps > 0 and K.gumbel_topc.launches == steps,
              f"{label}: {K.gumbel_topc.launches} gumbel_topc launches for {steps} wander steps")
        check(r["topk_calls"] == 0, f"{label}: aten::topk ran {r['topk_calls']} times")
        return r

    log(f"profiled engine: {gen.n_pad} columns, subset ball {gen.Q or 'none (full scope)'}")
    result = {"cluster": per_step("clustering")}
    if gen.Q:  # the same latent at full scope: what the subset wander changes
        gen = ClusterGenerator(read_npz(out / "latent.npz"), comp.metadata.lengths,
                               rng_seed=SEED, device=dev, wander_scope="full")
        next(gen)
        result["cluster_full_scope"] = per_step("clustering at full scope")
    ab = Abundance.load(out / "abundance.npz", comp.metadata.refhash)
    rows = 256 * 20  # 20 steps: the trace analysis costs the host ~19 s per 100
    ds = make_dataset(ab.matrix[:rows], comp.matrix[:rows], comp.metadata.lengths[:rows])
    vae = VAE(N_SAMPLES, seed=SEED, device=dev)

    def train_epoch():
        vae.trainmodel(ds, nepochs=1, batchsize=256, batchsteps=None)
        return num_batches(ds.n_obs, 256)

    result["train"] = profiled(train_epoch, "training")
    return result


# --------------------------------- phase 13: C above 32 and wander_kernel

MANY_C = (33, 40, 64, 100)  # candidates a step above the kernels' old limit of 32
TIMED_C = (40, 64)  # the maxsteps phase 13(b) runs the engine at
MANY_C_WIDTHS = (BALL_KB * 128, -(-N_CONTIGS // 128) * 128, BIG_PAD)  # 8,192, 100,096, 300,032
# clusters of 13(b)'s card-vs-CPU runs by scope: the CPU's full climb at C 64
# took ~2 s a cluster at 100,096 columns on the NVIDIA H100 80GB HBM3
# (700.00 W) machine's host
ENGINE_C_CLUSTERS = {"full": 6, "subset": 25}
KERNEL_AB = ("auto", "pallas", "xla", "xla", "pallas", "auto")  # 13(c)'s runs, in turns
KERNEL_AB_CLUSTERS = 30  # clusters each 13(c) run times (after one warm-up)
KERNEL_AB_PROFILED = 2  # clusters each 13(c) run profiles after those


def maxsteps_latent():
    "A 100,000 x 32 latent in 1,000 clumps and its lengths (13(b) and (c) outside the full run)."
    rng = np.random.default_rng(SEED)
    centers = rng.normal(size=(N_GENOMES, 32))
    latent = (centers[rng.integers(0, N_GENOMES, N_CONTIGS)]
              + rng.normal(scale=0.1, size=(N_CONTIGS, 32))).astype(np.float32)
    return latent, rng.integers(2000, 50_001, N_CONTIGS).astype(np.float32)


def check_many_candidates(dev) -> tuple[dict, dict]:
    """Phase 13(a): at C 33, 40, 64 and 100, `gumbel_topc` (no, some and
    all columns eligible, and a tie key) and `gumbel_topc_shard` (two
    shards, merged) at 8,192, 100,096 and 300,032 columns, the density
    kernel, its shard entry point and its bf16 variant at those widths at
    F_pad 32 and at 100,096 at F_pad 288: each bit for bit its plain version
    on the card, with its launches a call counted by its wrapper and by the
    library (`device_launches`): ceil(C / 32) for the Gumbel kernel, one for
    the density kernel. Then the two kernels timed at C 40 and 64 at those
    widths (F_pad 32), beside their bounds, plain versions and, for
    `gumbel_topc`, `gumbel_scores` + `torch.topk`. Returns (max|err| by
    kernel, times by (name, C, N_pad))."""
    from vamb_torch import kernels as K

    def calls(kernel_name, fn, want):
        "fn() once; its launches by the library's count and its wrapper's."
        before = K.device_launches()[kernel_name]
        out = fn()
        torch.cuda.synchronize()
        got = K.device_launches()[kernel_name] - before
        check(got == want, f"phase 13(a): {kernel_name} launched {got} times for a call, not {want}")
        return out

    seen = {"gumbel_topc": 0, "gumbel_topc_shard": 0, "candidate_density_sweep": 0,
            "candidate_density_shard": 0, "candidate_density_sweep bf16": 0}
    for n in MANY_C_WIDTHS:
        for c in MANY_C:
            cases = [gumbel_inputs(n, dev, seed=n + c + i, mask=mask)
                     for i, mask in enumerate(("none", "some", "all"))]
            ones = torch.ones(n, dtype=torch.bool, device=dev)
            cases.append((tie_key(TIE_STEPS[0]), torch.zeros(n, device=dev), ones, ~ones, 0))
            for key, d, kept, tried, medoid in cases:
                rounds = K.topc_launches(c)
                before = K.gumbel_topc.launches
                cand, valid, score = calls("gumbel_topc_kernel", lambda: K.gumbel_topc(
                    key, d, kept, tried, medoid, c, with_scores=True), rounds)
                check(K.gumbel_topc.launches == before + rounds, "gumbel_topc's wrapper miscounted")
                cand_p, valid_p, score_p = K.gumbel_topc_plain(key, d, kept, tried, medoid, c,
                                                               with_scores=True)
                if not (torch.equal(cand, cand_p) and torch.equal(valid, valid_p)
                        and torch.equal(score.view(torch.int32), score_p.view(torch.int32))):
                    raise AssertionError(f"phase 13(a): gumbel_topc n={n} C={c}: candidates "
                                         f"{cand.tolist()} vs the plain version's {cand_p.tolist()}")
                keys = [calls("gumbel_topc_kernel", lambda lo=lo, hi=hi: K.gumbel_topc_shard(
                    key, d[lo:hi], kept[lo:hi], tried[lo:hi], medoid, c, n, lo), rounds)
                    for lo, hi in ((0, n // 2), (n // 2, n))]
                for (lo, hi), k in zip(((0, n // 2), (n // 2, n)), keys):
                    check(torch.equal(k, K.gumbel_topc_shard_plain(key, d[lo:hi], kept[lo:hi],
                                                                   tried[lo:hi], medoid, c, lo)),
                          f"phase 13(a): gumbel_topc_shard n={n} C={c} differs from its plain version")
                merged = K.topc_merge(torch.stack(keys), c)
                check(torch.equal(merged[0], cand) and torch.equal(merged[1], valid),
                      f"phase 13(a): the merged shards' candidates n={n} C={c} are not gumbel_topc's")
                seen["gumbel_topc"] += 1
                seen["gumbel_topc_shard"] += 2
    for f, widths in ((F_PAD, MANY_C_WIDTHS), (AAE_F_PAD, (MANY_C_WIDTHS[1],))):
        for n in widths:
            mT = torch.as_tensor(clumpy_matrixT(n, f, seed=n + f), device=dev)
            w = torch.as_tensor(weights(n, seed=n, zero_half=True), device=dev)
            bf = mT.to(torch.bfloat16)
            for c in MANY_C:
                cand = torch.as_tensor(np.random.default_rng(c).choice(n, c, replace=False), device=dev)
                q = mT[:, cand].contiguous()
                got = calls("candidate_density_kernel", lambda: K.candidate_density_sweep(mT, cand, w), 1)
                shard = calls("candidate_density_kernel", lambda: K.candidate_density_shard(mT, q, cand, w), 1)
                got_bf = calls("candidate_density_kernel", lambda: K.candidate_density_sweep(bf, cand, w), 1)
                for label, a, b in (
                        ("candidate_density_sweep", got, K.candidate_density_plain(mT, cand, w)),
                        ("candidate_density_shard", shard, K.candidate_density_shard_plain(mT, q, cand, w)),
                        ("candidate_density_shard on its own columns", shard, got),
                        ("candidate_density_sweep bf16", got_bf, K.candidate_density_plain(bf, cand, w)),
                        ("candidate_density_sweep bf16 vs f32 on the widened matrix", got_bf,
                         K.candidate_density_sweep(bf.float(), cand, w))):
                    check(torch.equal(a, b), f"phase 13(a): {label} at F_pad {f}, N_pad {n}, C {c} "
                          "differs bit for bit")
                    seen[label] = seen.get(label, 0) + 1
    log("phase 13(a): every check bit for bit; calls checked " + json.dumps(seen))
    errs = {name: 0.0 for name in ("gumbel_topc", "candidate_density_sweep")}

    timed = {}
    for n in MANY_C_WIDTHS:
        mT = torch.as_tensor(clumpy_matrixT(n, F_PAD, seed=5), device=dev)
        w = torch.as_tensor(weights(n, seed=5), device=dev)
        kept = w > 0
        n_kept = int(kept.sum())
        gkey, gd, gkept, gtried, gmedoid = gumbel_inputs(n, dev, seed=8)
        for c in TIMED_C:
            cand = torch.as_tensor(np.random.default_rng(5).choice(n, c, replace=False), device=dev)
            D = 0.5 - mT[:, cand].T @ mT
            n_within = int(((D <= 0.05) & kept[None, :]).sum())
            fns = {
                "gumbel_topc": (
                    lambda: K.gumbel_topc(gkey, gd, gkept, gtried, gmedoid, c),
                    lambda: K.gumbel_topc_plain(gkey, gd, gkept, gtried, gmedoid, c),
                    lambda: torch.topk(K.gumbel_scores(gkey, gd, gkept, gtried, gmedoid), c),
                    bound(GUMBEL_READ_BYTES * n, GUMBEL_F32_OPS * n, GUMBEL_INT_OPS * n)),
                "candidate_density_sweep": (
                    lambda: K.candidate_density_sweep(mT, cand, w),
                    lambda: K.candidate_density_plain(mT, cand, w), None,
                    bound((F_PAD * n_kept + n + 2 * c) * 4, (2 * F_PAD + 1) * c * n_kept + 3 * n_within)),
            }
            for name, (kern, plain, lib, bnd) in fns.items():
                r = {"bound": bnd, "ms": time_ms(kern), "plain_ms": time_ms(plain, iters=20),
                     "library_ms": None if lib is None else time_ms(lib),
                     "launches_a_call": K.topc_launches(c) if name == "gumbel_topc" else 1}
                timed[(name, c, n)] = r
                libs = LIBRARY_NOTES.get(name, "none") if lib is None else f"{r['library_ms']:.5f} ms"
                log(f"phase 13(a): {name} at C {c}, N_pad {n}: kernel {r['ms']:.5f} ms "
                    f"({r['launches_a_call']} launches), plain {r['plain_ms']:.5f} ms, library {libs}, "
                    f"bound {bnd[0] * 1e3:.3f} us ({bnd[1]}), roofline share {bnd[0] / r['ms']:.3f}, L2 cold")
    return errs, timed


def engine_above_32(dev, latent: np.ndarray, lengths: np.ndarray) -> dict:
    """Phase 13(b), this slice's path: the engine at maxsteps 40 and 64 on
    the 100,000-contig latent, at full scope (6 clusters) and at the
    subset scope with attempt lanes on (25), on the card and on the CPU in
    lockstep (`engine_agreement`): the Gumbel scores and candidates must
    differ in no step and the clusters must be identical. The launch
    counters are set to 0 just before each run and read just after:
    `gumbel_topc` and the density kernel must have run, the Gumbel kernel
    ceil(C / 32) times a wander step, the library's counts equal to the
    wrappers'."""
    from vamb_torch import kernels as K

    runs = {}
    for c in TIMED_C:
        for scope in ("full", "subset"):
            kw = {"maxsteps": c, "wander_scope": scope,
                  **({"attempt_batch": "on"} if scope == "subset" else {})}
            K.reset_launch_counts()
            before = K.device_launches()
            agree = engine_agreement(dev, latent, lengths, ENGINE_C_CLUSTERS[scope],
                                     label=f"the 100k latent at maxsteps {c}, {scope} scope", **kw)
            launches = {k.__name__: k.launches for k in K.KERNELS}
            lib = {k: v - before[k] for k, v in K.device_launches().items()}
            steps = launches["candidate_density_sweep"]
            for kind in ("gumbel scores", "candidates"):
                check(agree["inputs_seen"][kind] > 0 and agree["inputs_that_differed"][kind] == 0,
                      f"phase 13(b), maxsteps {c}, {scope}: the card's {kind} differ from the CPU's")
            check(agree["identical_clusters"] == agree["clusters_compared"] == ENGINE_C_CLUSTERS[scope],
                  f"phase 13(b), maxsteps {c}, {scope}: the card and the CPU emitted different clusters")
            check(steps > 0 and launches["gumbel_topc"] == K.topc_launches(c) * steps,
                  f"phase 13(b), maxsteps {c}, {scope}: {launches['gumbel_topc']} gumbel_topc launches "
                  f"for {steps} wander steps")
            check(lib["gumbel_topc_kernel"] == launches["gumbel_topc"]
                  and lib["candidate_density_kernel"] == steps,
                  f"phase 13(b): the library counted {lib}, the wrappers {launches}")
            if scope == "subset":
                check(launches["gather_blocks"] > 0 and launches["row_sweep"] > 0,
                      f"phase 13(b), maxsteps {c}: the subset wander gathered no ball")
            runs[f"maxsteps {c}, {scope}"] = {"card_vs_cpu": agree, "launches": launches,
                                              "wander_steps": steps}
            log(f"phase 13(b): maxsteps {c}, {scope} scope: {agree['identical_clusters']} of "
                f"{ENGINE_C_CLUSTERS[scope]} clusters identical card vs CPU; launches "
                f"{json.dumps(launches)}")
    return runs


def wander_kernel_ab(dev, latent: np.ndarray, lengths: np.ndarray) -> dict:
    """Phase 13(c): the engine on the card on the 100,000-contig latent at
    its defaults (full scope at 100,096 columns, maxsteps 25) under
    `wander_kernel` "auto", "pallas", "xla", "xla", "pallas", "auto", in one
    process: ms a cluster over 30 clusters after one warm-up, device kernels
    a cluster over 2 more under the profiler, hand-written launches a
    cluster (the library's count), and a hash of every cluster's medoid,
    kind and members, which must agree; "xla" must launch no hand-written
    kernel."""
    import hashlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vamb_torch import kernels as K
    from vamb_torch.cluster import ClusterGenerator

    runs = []
    for setting in KERNEL_AB:
        gen = ClusterGenerator(latent.copy(), lengths, rng_seed=SEED, device=dev, wander_kernel=setting)
        first = next(gen)
        torch.cuda.synchronize()
        before = K.device_launches()
        t = time.time()
        timed = list(itertools.islice(gen, KERNEL_AB_CLUSTERS))
        torch.cuda.synchronize()
        wall = time.time() - t
        handwritten = sum(v - before[k] for k, v in K.device_launches().items())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            more = list(itertools.islice(gen, KERNEL_AB_PROFILED))
            torch.cuda.synchronize()
        kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        digest = hashlib.sha256()
        for c in (first, *timed, *more):
            digest.update(np.array([c.medoid, len(c.members), *c.members], np.int64).tobytes())
            digest.update(c.kind_str.encode())
        runs.append({"wander_kernel": setting, "ms_per_cluster": wall / len(timed) * 1e3,
                     "clusters": len(timed), "handwritten_launches_per_cluster": handwritten / len(timed),
                     "kernels_per_cluster": kernels / len(more),
                     "emission_sha": digest.hexdigest()[:16]})
        log("phase 13(c): " + json.dumps(runs[-1]))
    check(len({r["emission_sha"] for r in runs}) == 1,
          "phase 13(c): auto, pallas and xla emitted different clusters")
    check(all((r["handwritten_launches_per_cluster"] == 0) == (r["wander_kernel"] == "xla") for r in runs),
          "phase 13(c): xla launched a hand-written kernel, or auto or pallas none")
    summary = {s: {key: [r[key] for r in runs if r["wander_kernel"] == s]
                   for key in ("ms_per_cluster", "kernels_per_cluster", "handwritten_launches_per_cluster")}
               for s in ("auto", "pallas", "xla")}
    log("phase 13(c) wander_kernel A/B on the 100k latent: " + json.dumps(summary))
    return {"runs": runs, "summary": summary}


def pallas_refusals(dev, latent: np.ndarray, lengths: np.ndarray) -> list:
    """Phase 13(d): `wander_kernel="pallas"` is refused with ValueError where
    `vamb_tpu` refuses it: maxsteps 40, bfloat16 distances."""
    from vamb_torch.cluster import ClusterGenerator

    refused = []
    for kw in ({"maxsteps": 40}, {"distance_dtype": "bfloat16"}):
        try:
            ClusterGenerator(latent[:4096].copy(), lengths[:4096], device=dev, wander_kernel="pallas", **kw)
        except ValueError as e:
            refused.append({**kw, "error": str(e)})
            continue
        raise AssertionError(f"phase 13(d): wander_kernel='pallas' with {kw} was not refused")
    log("phase 13(d): " + json.dumps(refused))
    return refused


def run_many_candidates(dev, data=None) -> tuple[dict, dict, dict]:
    """Phase 13: (a)-(d), on `data` (the 100k path's latent and lengths) or
    `maxsteps_latent()`. Returns (errs, times, the phase's results)."""
    latent, lengths = maxsteps_latent() if data is None else data
    out = {}
    t = time.time()
    errs, timed = check_many_candidates(dev)
    out["kernels_seconds"] = time.time() - t
    for key, fn in (("engine", lambda: engine_above_32(dev, latent, lengths)),
                    ("wander_kernel_ab", lambda: wander_kernel_ab(dev, latent, lengths)),
                    ("pallas_refused", lambda: pallas_refusals(dev, latent, lengths))):
        t = time.time()
        out[key] = fn()
        out[key + "_seconds"] = time.time() - t
        log(f"phase 13 part {key} took {out[key + '_seconds']:.1f} s")
    return errs, timed, out


def kernel_rows_many_c(errs: dict, timed: dict, phase13: dict) -> list:
    """The kernels JSON line's rows of `gumbel_topc` and the density kernel
    at C 40 and 64: phase 13(a)'s times at 100,096 columns (every width
    under `at_widths`) and its checks, and the launches of phase 13(b)'s
    runs at that maxsteps (full and subset scope)."""
    rows = []
    for name in ("gumbel_topc", "candidate_density_sweep"):
        for c in TIMED_C:
            r = timed[(name, c, MANY_C_WIDTHS[1])]
            launches = sum(run["launches"][name] for label, run in phase13["engine"].items()
                           if label.startswith(f"maxsteps {c},"))
            rows.append({
                "name": name, "route": "cuda", "source": CLUSTER_SOURCE, "replaces": REPLACES[name],
                "c": c, "launches_a_call": r["launches_a_call"], "launches": launches,
                "max_abs_err": errs[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"],
                **({"library_note": LIBRARY_NOTES[name]} if r["library_ms"] is None else
                   {"library_what": "gumbel_scores + torch.topk"}),
                **({"replaces_kind": REPLACES_KIND[name]} if name in REPLACES_KIND else {}),
                "f_pad": F_PAD, "n_pad": MANY_C_WIDTHS[1],
                "path": f"phase 13(b) (the engine at maxsteps {c})",
                "at_widths": {n: {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                                  "bound_by": t["bound"][1], "library_ms": t["library_ms"]}
                              for (k, cc, n), t in timed.items() if k == name and cc == c},
            })
    return rows


# ------------------------- phase 14: the work counters and the workflow

WF_SAMPLES = 3
WF_CONTIGS = 9_000  # 3,000 contigs a sample
# the workflow's config: `bin avamb` capped at 1,000 z clusters (-c, a cap
# on the clustering's time: all 9,000 contigs take some 2,900 clusters and
# 15 s), and the ensemble's quality gates open, as phase 9's, so that its
# bins are written (one epoch leaves no bin near-complete)
WF_CONFIG = {"min_contig_size": 2000, "min_bin_size": 20_000, "min_identity": 0.95,
             "avamb_params": f"-o C --seed {SEED} -c 1000", "min_comp": 0.0, "max_cont": 1.0,
             "scoring": "native", "threads": 8}
WF_AGREEMENT_CLUSTERS = 30  # --workflow mode's 14(a): clusters of the z latent card vs CPU
WF_AGREEMENT_STEPS = 60  # ... or fewer, where this many wander steps come first


def work_agreement(card, cpu) -> dict:
    """Phase 14(a): the work counters of one engine run on the card and on
    the CPU that emitted alike. The effective count and the emitted total
    must be equal (float32 sums of the same terms in the same order); the
    raw counts differ by the kernels' terms alone, the "pallas" family's
    on the card and the "xla" family's on the CPU: one row more a
    full-scope wander step and seven rows fewer a subset final row, whose
    sums of N (`dist_terms`) the two runs must share. Every term is a
    multiple of 128, so both raw sums are exact below 2^31 and their
    difference must then equal those terms exactly; above, the float32
    sums round, and it must lie within 2^-20 of the larger."""
    card.drain()
    terms = card.dist_terms
    delta = terms["full_steps"] - 7 * terms["final_rows"]
    gap = card.n_dists - cpu.n_dists
    exact = max(card.n_dists, cpu.n_dists) < 2 ** 31
    raw_ok = gap == delta if exact else abs(gap - delta) <= 2 ** -20 * max(card.n_dists, cpu.n_dists)
    out = {"n_dists": {"card": card.n_dists, "cpu": cpu.n_dists},
           "n_dists_effective": {"card": card.n_dists_effective, "cpu": cpu.n_dists_effective},
           "emitted_total": {"card": card.emitted_total, "cpu": cpu.emitted_total},
           "dist_terms": {"card": terms, "cpu": cpu.dist_terms}, "kernel_terms_sum": delta,
           "raw_gap": gap, "raw_exact": exact}
    out["ok"] = bool(card._kernel_terms and not cpu._kernel_terms and raw_ok
                     and card.n_dists_effective == cpu.n_dists_effective > 0
                     and card.emitted_total == cpu.emitted_total and terms == cpu.dist_terms)
    return out


def headline_of(gen, before: tuple, wall: float) -> dict:
    """The work of a timed window of `gen` (drained), from its counters
    `before` it: raw and effective distance evaluations, clusters decided,
    clusters/s and effective dists/s (the system's headline unit)."""
    gen.drain()
    d_raw, d_eff, d_em = (a - b for a, b in zip(
        (gen.n_dists, gen.n_dists_effective, gen.emitted_total), before))
    return {"n_dists": d_raw, "n_dists_effective": d_eff, "emitted_total": d_em,
            "clusters_per_s": d_em / wall, "effective_dists_per_s": d_eff / wall,
            "raw_dists_per_s": d_raw / wall, "window_s": wall}


def write_samples(dev, d: Path, rng) -> tuple[list[Path], Path, np.ndarray]:
    """Phase 14(b)'s inputs: WF_CONTIGS contigs of phase 7's recipe (its
    synthetic genomes, each carrying a variant of each of its 40 marker
    profiles) split into WF_SAMPLES sample assemblies, contig i named
    `c{i}` in sample i % 3, and the profiles' HMM file. Returns the sample
    FASTAs, the HMM file and each contig's genome."""
    from vamb_torch.ops import hmm

    profiles, consensi = marker_profiles(rng)
    calibrate_cutoffs(rng, profiles, consensi, dev)
    (d / "markers.hmm").write_text("".join(hmm.format_hmm(p) for p in profiles))
    plant, _ = marker_planter(rng, consensi)
    genome = write_dataset(d, WF_CONTIGS, RC_GENOMES, WF_SAMPLES, SEED + 14, plant=plant)
    lines = (d / "contigs.fna").read_bytes().split(b"\n")
    paths = [d / f"assembly_s{s}.fna" for s in range(WF_SAMPLES)]
    for s, path in enumerate(paths):
        path.write_bytes(b"".join(b">c%d\n%s\n" % (i, lines[2 * i + 1])
                                  for i in range(s, WF_CONTIGS, WF_SAMPLES)))
    return paths, d / "markers.hmm", genome


def fasta_names(path: Path) -> list[str]:
    import gzip

    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return [line[1:].split()[0] for line in f if line.startswith(">")]


def run_workflow_path(dev, tmp: Path) -> dict:
    """Phase 14(b): the documented workflow on the port, on the card. Three
    sample assemblies (`write_samples`); `python -m
    vamb_torch.tools.concatenate` as a subprocess; then
    workflow_avamb/run_local_torch.py's `main` (`--mock-mapping --epochs
    1`: run_local.py's mock BAMs, `bin avamb` at its published widths 547 /
    283 / 700, `avamb_ensemble --write_bins` scored with the profiles
    through `hmm_forward`), the launch counters set to 0 just before and
    read just after; then `python -m vamb_torch.tools.create_fasta` on the
    z clusters as a subprocess. Gates: every subprocess exits 0; the
    catalogue's names are `S{n}C{name}`, each in its sample; every bin file
    holds exactly its cluster's contigs; `quality_report.tsv` and
    `Final_bins/` are written, bins in it, one FASTA a reported bin; the clustering
    kernels and `hmm_forward` launched (the library's own counts); and the
    catalogue's composition projected on the card (`use_device=True`)
    equals `bin avamb`'s host-path `composition.npz` but for the values
    whose float32 roundings straddle a mask step (one step of the row's
    largest value, under 1% of them)."""
    import importlib.util
    import os

    from vamb_torch import kernels as K
    from vamb_torch.composition import Composition
    from vamb_torch.utils import Reader

    times = {}
    t = time.time()
    data = tmp / "data"
    data.mkdir()
    samples, hmm_path, genome = write_samples(dev, data, np.random.default_rng(SEED + 14))
    times["write_inputs_s"] = time.time() - t
    out = tmp / "workflow"
    out.mkdir()
    (data / "contigs.txt").write_text("".join(f"{p}\n" for p in samples))
    config = {"contigs": str(data / "contigs.txt"), "sample_data": "unused with --mock-mapping",
              "outdir": str(out), "hmm_path": str(hmm_path), **WF_CONFIG}
    (data / "config.json").write_text(json.dumps(config))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}

    def tool(name, *args):
        t = time.time()
        proc = subprocess.run([sys.executable, "-m", f"vamb_torch.tools.{name}", *map(str, args)],
                              capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
        times[f"{name}_s"] = time.time() - t
        check(proc.returncode == 0, f"phase 14: vamb_torch.tools.{name} exited {proc.returncode}: "
                                    f"{proc.stderr[-2000:]}")

    catalogue = out / "contigs.flt.fna.gz"
    tool("concatenate", catalogue, *samples, "-m", WF_CONFIG["min_contig_size"])
    names = fasta_names(catalogue)
    check(len(names) == WF_CONTIGS and all(
        re.fullmatch(rf"S{1 + int(n.split('Cc')[1]) % WF_SAMPLES}Cc\d+", n) for n in names),
        "phase 14: the catalogue's names are not S{n}C{name}, each in its sample")

    spec = importlib.util.spec_from_file_location("run_local_torch",
                                                  ROOT / "workflow_avamb" / "run_local_torch.py")
    workflow = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(workflow)
    K.reset_launch_counts()
    before = K.device_launches()
    t = time.time()
    workflow.main(["--config", str(data / "config.json"), "--device", str(dev), "--mock-mapping",
                   "--epochs", "1"])
    torch.cuda.synchronize()
    times["run_local_torch_s"] = time.time() - t
    launches = {"hmm_forward": K.hmm_forward.launches, **{k.__name__: k.launches for k in K.KERNELS}}
    library = {k: v - before[k] for k, v in K.device_launches().items() if v != before[k]}
    log(f"phase 14: run_local_torch.py ran in {times['run_local_torch_s']:.1f} s; wrapper launches "
        f"{json.dumps(launches)}; the library's own {json.dumps(library)}")
    for name, kernel in (("gumbel_topc", "gumbel_topc_kernel"),
                         ("candidate_density_sweep", "candidate_density_kernel"),
                         ("medoid_sweep", "medoid_sweep_kernel"), ("spec_sweep", "spec_sweep_kernel")):
        check(launches[name] > 0 and library.get(kernel, 0) > 0,
              f"phase 14: the workflow never launched {name} ({kernel})")
    check(launches["hmm_forward"] > 0, "phase 14: the workflow never launched hmm_forward")

    avamb = out / "avamb"
    final = out / "Final_bins"
    report = final / "quality_report.tsv"
    check(report.is_file() and final.is_dir(), "phase 14: no Final_bins/quality_report.tsv")
    rows = read_tsv(report)[1:]
    fastas = sorted((final / "bins").rglob("*.fna*")) if (final / "bins").is_dir() else []
    check(0 < len(fastas) == len(rows), f"phase 14: {len(rows)} bins reported, {len(fastas)} FASTAs")
    bins_out = tmp / "z_bins"
    tool("create_fasta", catalogue, avamb / "aae_z_clusters_unsplit.tsv", 0, bins_out)
    z_bins = read_bins(avamb / "aae_z_clusters_unsplit.tsv", None)
    written = {p.name.removesuffix(".fna"): set(fasta_names(p)) for p in bins_out.iterdir()}
    check(written == z_bins, "phase 14: a bin file does not hold exactly its cluster's contigs")

    t = time.time()
    with Reader(catalogue) as f:
        on_card = Composition.from_file(f, str(catalogue), minlength=WF_CONFIG["min_contig_size"],
                                        use_device=True, device=dev)
    times["tnf_on_card_s"] = time.time() - t
    host = Composition.load(avamb / "composition.npz")
    a, b = on_card.matrix, host.matrix
    row = np.maximum(np.abs(a), np.abs(b)).max(axis=1, keepdims=True).astype(np.float32)
    within = bool((np.abs(a.astype(np.float64) - b) <= np.spacing(row) * 4096).all())
    same = float((a == b).mean())
    check(np.array_equal(on_card.metadata.identifiers, host.metadata.identifiers) and within
          and same > 0.99 and not (a.view(np.uint32) & np.uint32(0xFFF)).any(),
          f"phase 14: the card's TNF projection differs from the host path's ({same} identical)")
    log(f"phase 14: composition on the card vs the host path: {same} of the values identical, "
        f"max |diff| {float(np.abs(a - b).max())}, all within one mask step of their row's largest")
    final_bins = {p.name: {n.replace("Cc", "C") for n in fasta_names(p)} for p in fastas}
    result = {"contigs": len(names), "samples": WF_SAMPLES, "launches": launches,
              "library_launches": library, "z_bins": len(z_bins), "final_bins": len(rows),
              "final_bins_precision": pairwise_precision(final_bins, genome),
              "tnf_card_identical": same, "times": times,
              "_z_latent": avamb / "aae_z_latent.npz", "_composition": avamb / "composition.npz"}
    log("phase 14(b): " + json.dumps({k: v for k, v in result.items() if not k.startswith("_")}))
    return result


def workflow_agreement(dev, phase14: dict) -> dict:
    """Phase 14(a) in `--workflow` mode, where phases 4 and 10 do not run:
    WF_AGREEMENT_CLUSTERS clusters of the workflow's 283-wide z latent
    (fewer where WF_AGREEMENT_STEPS wander steps come first) on the card
    and on the CPU in lockstep, as in phase 4: the same clusters, and the
    work counters as `work_agreement` requires."""
    from vamb_torch.composition import Composition
    from vamb_torch.utils import read_npz

    latent = read_npz(phase14["_z_latent"])
    lengths = Composition.load(phase14["_composition"]).metadata.lengths
    agree = engine_agreement(dev, latent, lengths, WF_AGREEMENT_CLUSTERS,
                             label="phase 14's 283-wide z latent", max_steps=WF_AGREEMENT_STEPS)
    for kind in ("gumbel scores", "candidates"):
        check(agree["inputs_that_differed"][kind] == 0, f"phase 14(a): the card's {kind} differ")
    check(agree["identical_clusters"] == agree["clusters_compared"] > 0 and agree["work"]["ok"],
          "phase 14(a): the card and the CPU emitted different clusters or did different work")
    return agree


# ------------------------------------------------- engine A/B across checkouts


def ab_latent():
    "A 300,000 x 32 latent in 3,000 clumps (subset scope at 300,032 columns) and its lengths."
    rng = np.random.default_rng(SEED)
    centers = rng.normal(size=(BIG_GENOMES, 32))
    latent = (centers[rng.integers(0, BIG_GENOMES, BIG_CONTIGS)]
              + rng.normal(scale=0.1, size=(BIG_CONTIGS, 32))).astype(np.float32)
    return latent, rng.integers(2000, 4001, BIG_CONTIGS).astype(np.float32)


def engine_time(n_clusters: int = 200, profiled: int = 50, data=None, **kwargs) -> dict:
    """ms per cluster of the engine on the card, on `ab_latent()` (or
    `data`), with generator arguments `kwargs`, after one warm-up cluster;
    then device kernels a cluster and an attempt over `profiled` more under
    the profiler; and a hash of the medoids of the timed clusters."""
    import hashlib

    from vamb_torch.cluster import ClusterGenerator

    latent, lengths = ab_latent() if data is None else data
    gen = ClusterGenerator(latent.copy(), lengths, rng_seed=SEED, device="cuda", **kwargs)
    next(gen)
    torch.cuda.synchronize()
    counted = hasattr(gen, "n_dists_effective")  # another checkout's engine may keep no counters
    before = (gen.n_dists, gen.n_dists_effective, gen.emitted_total) if counted else None
    t = time.time()
    medoids = [c.medoid for c in itertools.islice(gen, n_clusters)]
    torch.cuda.synchronize()
    wall = time.time() - t
    work = {"work": headline_of(gen, before, wall)} if counted else {}
    # then clusters under the profiler: device kernels a cluster and an
    # attempt (one seed chosen each; a wrapper that any checkout's engine takes)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    attempts = count_attempts(gen)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        more = [c.medoid for c in itertools.islice(gen, profiled)]
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return {"ms_per_cluster": wall / len(medoids) * 1e3, "clusters": len(medoids),
            "subset_ball": gen.Q, "subset_counts": gen.subset_counts,
            **({"lane_counts": gen.lane_counts} if hasattr(gen, "lane_counts") else {}),
            "kernels_per_cluster": kernels / len(more), "kernels_per_attempt": kernels / attempts[0],
            "medoids_sha": hashlib.sha256(np.array(medoids).tobytes()).hexdigest()[:16], **work}


def engine_ab(dirs: list[str]) -> int:
    "Run `engine_time` once per checkout in `dirs`, each in its own process."
    runs = []
    for d in dirs:
        out = subprocess.run([sys.executable, __file__, "--engine-time", d], capture_output=True,
                             text=True, check=True, timeout=600)
        runs.append({"checkout": d, **json.loads(out.stdout.strip().splitlines()[-1])})
        log(json.dumps(runs[-1]))
    print(nvidia_smi_line())
    return 0


STAGE_AB_SIZES = ((N_CONTIGS, N_GENOMES, 2000), (BIG_CONTIGS, BIG_GENOMES, BIG_CLUSTERS))
STAGE_WARM = 20_000  # rows of the 100k latent a `--stage-time` process warms its kernels on


def stage_time(data: Path) -> dict:
    """`bin default`'s clustering stage on the latents in `data` (see
    `stage_ab`) with the engine of the checkout on `sys.path`, after a
    warm-up that builds and first launches every clustering kernel."""
    import hashlib

    from vamb_torch.cluster import ClusterGenerator

    latent, lengths = (np.load(data / str(N_CONTIGS) / f) for f in ("latent.npy", "lengths.npy"))
    warm = ClusterGenerator(latent[:STAGE_WARM].copy(), lengths[:STAGE_WARM], rng_seed=SEED,
                            device="cuda", wander_scope="subset", attempt_batch="on")
    list(itertools.islice(warm, 20))
    out = {}
    for n, _, clusters in STAGE_AB_SIZES:
        latent, lengths = (np.load(data / str(n) / f) for f in ("latent.npy", "lengths.npy"))
        torch.cuda.synchronize()
        t = time.time()
        gen = ClusterGenerator(latent, lengths, rng_seed=SEED, device="cuda", destroy=True)
        medoids = [c.medoid for c in itertools.islice(gen, clusters)]
        torch.cuda.synchronize()
        wall = time.time() - t
        out[str(n)] = {
            "s": wall, "clusters": len(medoids), "clusters_per_s": len(medoids) / wall,
            "subset_ball": gen.Q, "subset_counts": gen.subset_counts,
            "lane_counts": gen.lane_counts, "compactions": len(gen.compactions),
            "medoids_sha": hashlib.sha256(np.array(medoids).tobytes()).hexdigest()[:16],
            **({"n_dists": gen.n_dists, "n_dists_effective": gen.n_dists_effective,
                "dist_terms": gen.dist_terms} if hasattr(gen, "n_dists") else {})}
    return out


def stage_ab(dirs: list[str]) -> int:
    """`bin default` on phases 4 and 5's datasets with this checkout, then
    its clustering stage on their latents with each checkout in `dirs`, in
    turn, each in its own process (`stage_time`). Fails unless every run
    emits the same medoids."""
    from vamb_torch.__main__ import main
    from vamb_torch.composition import Composition
    from vamb_torch.utils import read_npz

    if not torch.cuda.is_available():
        log("no CUDA device: --stage-ab needs the card")
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp)
        for n, genomes, clusters in STAGE_AB_SIZES:
            d = data / str(n)
            d.mkdir()
            write_dataset(d, n, genomes, N_SAMPLES, SEED)
            main(["bin", "default", "--outdir", str(d / "run"), "--fasta", str(d / "contigs.fna"),
                  "--abundance_tsv", str(d / "abundance.tsv"), "-e", "2", "-q", "1",
                  "-c", str(clusters), "--seed", str(SEED)], device="cuda")
            log(f"bin default on {n} contigs, stage times: "
                + json.dumps(stage_times(d / "run" / "log.txt")))
            np.save(d / "latent.npy", read_npz(d / "run" / "latent.npz"))
            np.save(d / "lengths.npy", Composition.load(d / "run" / "composition.npz").metadata.lengths)
        runs = []
        for d in dirs:
            out = subprocess.run([sys.executable, __file__, "--stage-time", d, str(data)],
                                 capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                log(out.stderr[-4000:])
                return 1
            runs.append({"checkout": d, **json.loads(out.stdout.strip().splitlines()[-1])})
            log(json.dumps(runs[-1]))
    for n, _, _ in STAGE_AB_SIZES:
        shas = {r[str(n)]["medoids_sha"] for r in runs}
        check(len(shas) == 1, f"--stage-ab: the checkouts emitted different medoids at {n}: {shas}")
        log(f"clustering stage at {n}, s: " + json.dumps([[r["checkout"], r[str(n)]["s"]] for r in runs]))
    print(nvidia_smi_line())
    return 0


HMM_HEADLINE = 200  # the M of hmm_forward's headline row


def hmm_row(hmm_timed: dict, run_rc: dict) -> dict:
    "hmm_forward's row of the kernels JSON line: phase 2's times, phase 7's launches."
    h = hmm_timed[HMM_HEADLINE]
    return {
        "name": "hmm_forward", "route": "cuda", "source": "vamb_torch/kernels/csrc/hmm_forward.cu",
        "replaces": "vamb_tpu/ops/hmm.py:229", "replaces_kind": "lax.scan (_forward_batch), not Pallas",
        "launches": run_rc["launches"]["hmm_forward"],
        "max_abs_err": max(t["max_abs_err"] for t in hmm_timed.values()),
        "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound"][0], "bound_by": h["bound"][1],
        "library_ms": None, "library_note": LIBRARY_NOTES["hmm_forward"], "m": HMM_HEADLINE,
        "genes": HMM_GENES,
        "at_widths": {k: {"m": t["m"], "genes": t["genes"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                          "bound_ms": t["bound"][0], "bound_by": t["bound"][1], "cells": t["cells"],
                          "max_abs_err": t["max_abs_err"]}
                      for k, t in hmm_timed.items()},
    }


CLUSTER_SOURCE = "vamb_torch/kernels/csrc/cluster_kernels.cu"
REPLACES = {"row_sweep": "vamb_tpu/ops/pallas_cluster.py:219",
            "candidate_density_sweep": "vamb_tpu/ops/pallas_cluster.py:295",
            "gather_blocks": "vamb_tpu/ops/pallas_cluster.py:368",
            "medoid_sweep": "vamb_tpu/ops/pallas_cluster.py:140",
            "gumbel_topc": "vamb_tpu/cluster.py:775",
            "spec_sweep": "vamb_tpu/cluster.py:498",
            "row_stats": "vamb_tpu/cluster.py:1104"}
# what a kernel replaces where that is not a Pallas kernel
REPLACES_KIND = {
    "gumbel_topc": "eager threefry uniform, two jnp.log and jax.lax.top_k (:775-782, :674-681), not Pallas",
    "spec_sweep": "XLA einsum (spec_batch, :498-515; the lanes' final rows, :1446-1456), not Pallas",
    "row_stats": "XLA reductions (the loner flags, :1100 and :1104-1112), not Pallas",
}


def kernel_rows(timed: dict, errs: dict, run_100k: dict, run_300k: dict, run_tax: dict,
                run_avamb: dict) -> list:
    """The kernels JSON line's rows of the clustering kernels at F_pad 32,
    from phase 2's checks and times and the main paths' launch counts
    (phases 4, 5 and 8; `gumbel_topc`, which reads no matrix, also phase
    9's)."""
    source, replaces = CLUSTER_SOURCE, REPLACES
    gaps_300k = launch_gaps(timed, run_300k["launches_by_width"])
    gaps_100k = launch_gaps(timed, run_100k["launches_by_width"])
    log("launches x (ms - bound), L2 cold, summed over widths: 300k path "
        + json.dumps(gaps_300k) + "; 100k path " + json.dumps(gaps_100k))
    kernels = []
    for name in replaces:
        # the headline width: the 100k path's for the sweeps (as in earlier
        # runs), the 300k path's for the gather and medoid_sweep
        main_n = PATH_WIDTHS[1] if (name, PATH_WIDTHS[1]) in timed else BIG_PAD
        r = timed[(name, main_n)]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces[name],
            "launches": run_300k["launches"][name], "max_abs_err": errs[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "n_pad": main_n,
            **({"f_pad": F_PAD, "dtype": "float32"} if name not in ("gumbel_topc", "row_stats") else
               {"launches_avamb_path": run_avamb["launches"][name]}),
            **({"library_note": LIBRARY_NOTES[name]} if r["library_ms"] is None else {}),
            **({"replaces_kind": REPLACES_KIND[name]} if name in REPLACES_KIND else {}),
            **({"library_what": "gumbel_scores + torch.topk, the step before the kernel selected"}
               if name == "gumbel_topc" else {}),
            **({"library_what": "torch.matmul of the 8 rows alone (no sums)",
                "eight_medoid_sweeps_ms": r["eight_medoid_sweeps_ms"]} if name == "spec_sweep" else {}),
            "ms_l2_warm": r["ms_l2_warm"], "plain_ms_l2_warm": r["plain_ms_l2_warm"],
            "library_ms_l2_warm": r["library_ms_l2_warm"],
            "launches_100k_path": run_100k["launches"][name],
            "launches_taxonomy_path": run_tax["launches"][name],
            "gap_s_300k_path": gaps_300k[name]["gap_s"],
            "gap_s_100k_path": gaps_100k[name]["gap_s"],
            "at_widths": {
                n: {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                    "bound_by": t["bound"][1], "library_ms": t["library_ms"],
                    "ms_l2_warm": t["ms_l2_warm"], "plain_ms_l2_warm": t["plain_ms_l2_warm"],
                    "library_ms_l2_warm": t["library_ms_l2_warm"],
                    "launches_300k_path": run_300k["launches_by_width"][name].get(n, 0),
                    "launches_100k_path": run_100k["launches_by_width"][name].get(n, 0),
                    "launches_taxonomy_path": run_tax["launches_by_width"][name].get(n, 0)}
                for (kname, n), t in timed.items() if kname == name},
        }
        kernels.append(row)
    return kernels


def kernel_rows_aae(timed: dict, errs: dict, run_avamb: dict) -> list:
    """The kernels JSON line's rows of the five matrix kernels at F_pad 288,
    the z latent's width: phase 2's checks and times there (100,096
    columns) and phase 9's launches at that width."""
    gaps = launch_gaps(timed, {k: v for k, v in run_avamb["launches_by_width"].items()
                               if k != "gumbel_topc"})
    log(f"launches x (ms - bound) at F_pad {AAE_F_PAD}, L2 cold, phase 9's path: " + json.dumps(gaps))
    rows = []
    for name in ("row_sweep", "candidate_density_sweep", "gather_blocks", "medoid_sweep", "spec_sweep"):
        r = timed[(name, PATH_WIDTHS[1])]
        rows.append({
            "name": name, "route": "cuda", "source": CLUSTER_SOURCE, "replaces": REPLACES[name],
            "launches": run_avamb["launches_by_fpad"][name].get(AAE_F_PAD, 0),
            "max_abs_err": errs[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            **({"library_note": LIBRARY_NOTES.get(name, "none")} if r["library_ms"] is None else {}),
            **({"replaces_kind": REPLACES_KIND[name], "eight_medoid_sweeps_ms": r["eight_medoid_sweeps_ms"]}
               if name == "spec_sweep" else {}),
            "f_pad": AAE_F_PAD, "dtype": "float32", "n_pad": PATH_WIDTHS[1], "path": "phase 9 (bin avamb)",
            "ms_l2_warm": r["ms_l2_warm"], "plain_ms_l2_warm": r["plain_ms_l2_warm"],
            "library_ms_l2_warm": r["library_ms_l2_warm"], "gap_s_avamb_path": gaps[name]["gap_s"],
        })
    return rows


def kernel_rows_bf16(timed: dict, errs: dict, run_bf16: dict) -> list:
    """The kernels JSON line's rows of the bf16 variants, one a kernel and
    timed width: `time_bf16`'s times, `check_bf16`'s errors and phase 11's
    launches at that width (its path runs at F_pad 32 alone)."""
    rows = []
    for (name, f_pad, n), r in timed.items():
        rows.append({
            "name": name, "dtype": "bfloat16", "route": "cuda", "source": CLUSTER_SOURCE,
            "replaces": REPLACES[name],
            "launches": run_bf16["launches_by_width"][name].get(n, 0) if f_pad == F_PAD else 0,
            "max_abs_err": errs[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            ("library_what" if r["library_ms"] is not None else "library_note"): r["library_what"],
            "f32_ms": r["f32_ms"], "f_pad": f_pad, "n_pad": n,
            **({"replaces_kind": REPLACES_KIND[name]} if name in REPLACES_KIND else {}),
            "path": "phase 11 (bin default --precision bf16 --distance_dtype bfloat16)",
        })
    return rows


# ----------------------------------------------- kernel layouts in one call

# Layout variants of the kernels: source edits and the matching constants of
# the plain versions (a layout can fix a summation order). The first of each
# kind is the committed source.
DENSITY_LAYOUTS = {
    "T128 V2 ring4": ([], {}),
    "T128 V2 ring4, chunk loop unrolled": (
        [("#pragma unroll 1\n    for (int q = 0;", "#pragma unroll\n    for (int q = 0;")], {}),
    "T256 V2 ring2": ([("kDensThreads = 128;", "kDensThreads = 256;"),
                       ("kDensRing = kDensChunks;", "kDensRing = 2;")], {"_DENS_THREADS": 256}),
    "T128 V4 ring2": ([("kDensVec = 2;", "kDensVec = 4;"), ("kDensRing = kDensChunks;", "kDensRing = 2;")],
                      {"_DENS_VEC": 4}),
    "T64 V4 ring4": ([("kDensThreads = 128;", "kDensThreads = 64;"), ("kDensVec = 2;", "kDensVec = 4;")],
                     {"_DENS_THREADS": 64, "_DENS_VEC": 4}),
}
GATHER_LAYOUTS = {
    "1 copy a thread, a CTA per 8 rows": ([], {}),
    "4 copies a thread, a CTA per 32 rows": ([("kGatherCopies = 1;", "kGatherCopies = 4;")], {}),
}
SWEEP_LAYOUTS = {
    "128 CTAs at most": ([], {}),
    "256 CTAs at most": ([("kSweepMaxBlocks = 128;", "kSweepMaxBlocks = 256;")],
                         {"_SWEEP_MAX_BLOCKS": 256}),
    "512 CTAs at most": ([("kSweepMaxBlocks = 128;", "kSweepMaxBlocks = 512;")],
                         {"_SWEEP_MAX_BLOCKS": 512}),
    # diagnostics, not checked against a plain version: where the time goes
    "diagnostic: no histogram adds": ([("    if (d >= 0.0f && d <= kXmax) {", "    if (false) {")], None),
    "diagnostic: no last CTA": ([("  if (!s_last) return;\n  __threadfence();\n  // the last CTA: thread r",
                                  "  return;\n  __threadfence();\n  // the last CTA: thread r")], None),
}
# `spec_sweep` and `row_stats` (S 8). `--layouts SOURCE` builds them from
# another checkout's source (e.g. the parent's) for a comparison in one
# call, where a layout whose text that source lacks is skipped.
# The `spec_sweep` variants change the register tile's columns a thread;
# "phases" stamps each CTA's phases with the card's clock (`batch_phases`);
# "no histogram adds" skips every histogram add (`sweep_column`);
# "spec_sweep's stream alone" stops it once its rows are written; "no last
# CTA" skips the cross-CTA totals; "rows only, no finish" stops each CTA
# before any sum leaves it (a compiler may then drop sums nothing reads).
BATCH_LAYOUTS = {
    "committed": ([], {}),
    "spec_sweep: 1 column a thread": ([("constexpr int kSpecVec = 2;", "constexpr int kSpecVec = 1;")], {}),
    "spec_sweep: 4 columns a thread": ([("constexpr int kSpecVec = 2;", "constexpr int kSpecVec = 4;")], {}),
    "diagnostic: phases": ([
        ("#define BATCH_PHASE(k)\n",
         "__device__ unsigned long long g_batch_phase[4096 * 8 * 2];\n"
         "#define BATCH_PHASE(k) do { if (threadIdx.x == 0) { unsigned long long t_;"
         " asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_));"
         " const size_t i_ = ((size_t)(blockIdx.y * gridDim.x + blockIdx.x) * 8 + (k)) * 2;"
         " g_batch_phase[i_] = t_; g_batch_phase[i_ + 1] = clock64(); } } while (0)\n"),
        ("}  // extern \"C\"\n",
         "int vt_batch_phases(void* dst) {\n  void* p = nullptr;\n"
         "  cudaError_t e = cudaGetSymbolAddress(&p, g_batch_phase);\n"
         "  if (e == cudaSuccess) e = cudaMemcpy(dst, p, sizeof(g_batch_phase), cudaMemcpyDeviceToHost);\n"
         "  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_batch_phase));\n"
         "  return (int)e;\n}\n}  // extern \"C\"\n")], None),
    "diagnostic: no histogram adds": ([("    if (d >= 0.0f && d <= kXmax) {", "    if (false) {")], None),
    "diagnostic: spec_sweep's stream alone": ([
        ("  __syncthreads();  // the CTA's rows are written and the ring is free\n", "  return;\n")], None),
    "diagnostic: no last CTA": ([("s_last = atomicAdd(ticket, 1u) == n - 1;",
                                  "s_last = atomicAdd(ticket, 1u) == n - 1 && false;")], None),
    "diagnostic: rows only, no finish": ([("  // the CTA's partial rows\n", "  return;\n")], None),
}


def build_layouts(layouts: dict, kind: str, source: Path = None) -> dict:
    """Build each layout's edited source (the checkout's, or `source`) into
    its own library (named by `kind`, the layout and the source), one nvcc
    each, all started together; log each kernel's registers. An edit is a
    pair (text, replacement). On the checkout's source an edit whose text
    is missing, or a layout that does not build, fails the run; on another
    `source` (a design the layouts were not written for) such a layout is
    logged and left out. Returns {name: (ctypes library, plain-version
    constants)}."""
    import ctypes
    import hashlib

    from vamb_torch.kernels import cluster_kernels as CK

    src = Path(source or CK._SOURCE).read_text()
    out = ROOT / "vamb_torch" / "kernels" / "_build" / "layouts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (edits, consts) in layouts.items():
        text = src
        missing = [a for a, _ in edits if a not in src]
        if missing and source is not None:
            log(f"layout {name}: not in {source}, skipped")
            continue
        check(not missing, f"layout {name}: its edits' text {missing} is not in the source")
        for a, b in edits:
            text = text.replace(a, b)
        tag = re.sub(r"\W+", "_", f"{kind} {name}") + "_" + hashlib.sha256(src.encode()).hexdigest()[:8]
        (out / f"{tag}.cu").write_text(text)
        procs[name] = (tag, subprocess.Popen(
            [CK._nvcc(), *CK.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out / f"{tag}.so"), str(out / f"{tag}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (tag, proc) in procs.items():
        text = proc.communicate(timeout=600)[0]
        if proc.returncode != 0 and source is not None:
            log(f"layout {name} failed to build from {source}, left out: {text[-1500:]}")
            continue
        check(proc.returncode == 0, f"layout {name} failed to build: {text[-2000:]}")
        regs = [ln.split(":")[-1].strip() for ln in text.splitlines() if "Used" in ln]
        log(f"layout {name}: registers of its kernels {regs}")
        libs[name] = (ctypes.CDLL(str(out / f"{tag}.so")), layouts[name][1])
    return libs


def with_consts(consts: dict, fn):
    "Run `fn` with the plain versions' layout constants set to `consts`."
    from vamb_torch.kernels import cluster_kernels as CK

    saved = {k: getattr(CK, k) for k in ("_DENS_THREADS", "_DENS_VEC", "_DENS_TILE_COLS",
                                         "_SWEEP_MAX_BLOCKS")}
    for k, v in consts.items():
        setattr(CK, k, v)
    CK._DENS_TILE_COLS = CK._DENS_THREADS * CK._DENS_VEC
    try:
        return fn()
    finally:
        for k, v in saved.items():
            setattr(CK, k, v)


def density_layouts() -> int:
    """Time each layout of `DENSITY_LAYOUTS` (threads a CTA, columns a
    thread, chunk buffers) at every path width, C = 25, L2 cold, for
    several candidate-group counts G; each result must equal the plain
    version computed with the layout's own constants. One JSON line per
    (width, layout)."""
    import ctypes

    from vamb_torch.kernels import cluster_kernels as CK

    libs = build_layouts(DENSITY_LAYOUTS, "density")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    partials, ticket, sms = CK._density_workspace(dev, stream)
    for n in PATH_WIDTHS:
        mT = torch.as_tensor(clumpy_matrixT(n, F_PAD, seed=5), device=dev)
        w = torch.as_tensor(weights(n, seed=5), device=dev)
        cand = torch.as_tensor(np.random.default_rng(5).choice(n, MAXSTEPS, replace=False), device=dev)
        for name, (lib, consts) in libs.items():
            lib.vt_candidate_density.argtypes = [vp, ci, ci, vp, ci, ci, vp, ci, vp, vp, vp, vp]
            lib.vt_candidate_density.restype = ci
            plain = with_consts(consts, lambda: CK.candidate_density_plain(mT, cand, w))
            b = with_consts(consts, lambda: CK.density_col_blocks(n)[1])
            default_g = CK.density_groups(MAXSTEPS, b, sms)
            ms = {}
            for g in sorted({default_g, 2, 3, 4, 7, 13, 25}):
                dens = torch.empty(MAXSTEPS, device=dev)

                def run():
                    err = lib.vt_candidate_density(
                        mT.data_ptr(), F_PAD, n, cand.data_ptr(), 1, MAXSTEPS, w.data_ptr(), g,
                        partials.data_ptr(), ticket.data_ptr(), dens.data_ptr(), stream)
                    check(err == 0, f"layout {name}: launch error {err}")
                run()
                torch.cuda.synchronize()
                check(torch.equal(dens, plain), f"layout {name}, N {n}, G {g}: differs from its plain version")
                ms[g] = time_ms(run)
            log(json.dumps({"n_pad": n, "layout": name, "column_ctas": b, "default_g": default_g,
                            "ms_by_g": ms}))
    print(nvidia_smi_line())
    return 0


def gather_and_sweep_layouts() -> int:
    """Time each layout of `GATHER_LAYOUTS` (`gather_ball` of 64 blocks from
    300,032 columns) and of `SWEEP_LAYOUTS` (`medoid_sweep` at the widths
    the main paths give it), L2 cold, each result equal to its plain
    version (with the layout's own constants); `medoid_sweep` also at a
    ball's 8,192 columns, where its fixed costs show. One JSON line per
    (kernel, width, layout)."""
    import ctypes

    from vamb_torch.kernels import cluster_kernels as CK

    libs = build_layouts({**GATHER_LAYOUTS, **SWEEP_LAYOUTS}, "sweep")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    n = BIG_PAD
    mT, w, kept, d0 = ball_inputs(n, dev, seed=6)
    bids = torch.as_tensor(gather_cases(n, seed=7)[0][0].astype(np.int32), device=dev)
    expect = CK.gather_ball_plain(mT, bids, BALL_KB, w, kept, d0)
    for name in GATHER_LAYOUTS:
        lib = libs[name][0]
        lib.vt_gather_blocks.argtypes = [vp, ci, ci, vp, ci, vp, ci, vp, vp, vp, vp, vp, vp, vp, vp]
        lib.vt_gather_blocks.restype = ci
        got = [torch.empty_like(t) for t in expect]

        def run():
            err = lib.vt_gather_blocks(mT.data_ptr(), F_PAD, n, bids.data_ptr(), BALL_KB,
                                       got[0].data_ptr(), BALL_KB, w.data_ptr(), kept.data_ptr(),
                                       d0.data_ptr(), *(t.data_ptr() for t in got[1:]), stream)
            check(err == 0, f"layout {name}: launch error {err}")
        run()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, expect)), f"layout {name}: differs from plain")
        log(json.dumps({"kernel": "gather_ball", "n_pad": n, "kb": BALL_KB, "layout": name,
                        "ms": time_ms(run)}))
    for n in PATH_WIDTHS:
        mT = torch.as_tensor(clumpy_matrixT(n, F_PAD, seed=5), device=dev)
        w = torch.as_tensor(weights(n, seed=5), device=dev)
        for name, (edits, consts) in SWEEP_LAYOUTS.items():
            lib = libs[name][0]
            lib.vt_medoid_sweep.argtypes = [vp, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp]
            lib.vt_medoid_sweep.restype = ci
            checked = consts is not None
            consts = consts or {}
            expect = with_consts(consts, lambda: CK.medoid_sweep_plain(mT, 37, w))
            blocks = consts.get("_SWEEP_MAX_BLOCKS", CK._SWEEP_MAX_BLOCKS)
            partials = torch.zeros((blocks, CK._SWEEP_SLOTS), device=dev)
            close_partials = torch.zeros(blocks, dtype=torch.int32, device=dev)
            ticket = torch.zeros(1, dtype=torch.int32, device=dev)
            d = torch.empty(n, device=dev)
            sums = torch.empty(CK._NBINS + 1, device=dev)
            n_close = torch.empty((), dtype=torch.int32, device=dev)

            def run():
                err = lib.vt_medoid_sweep(mT.data_ptr(), F_PAD, n, 37, w.data_ptr(), d.data_ptr(),
                                          partials.data_ptr(), close_partials.data_ptr(), ticket.data_ptr(),
                                          sums.data_ptr(), sums.data_ptr() + 4 * CK._NBINS,
                                          n_close.data_ptr(), stream)
                check(err == 0, f"layout {name}: launch error {err}")
            run()
            torch.cuda.synchronize()
            got = (d, sums[:CK._NBINS], sums[CK._NBINS], n_close)
            check(not checked or all(torch.equal(a, b) for a, b in zip(got, expect)),
                  f"layout {name}, N {n}: differs from its plain version")
            log(json.dumps({"kernel": "medoid_sweep", "n_pad": n, "layout": name, "checked": checked,
                            "ctas": with_consts(consts, lambda: CK.sweep_col_blocks(n)[1]),
                            "ms": time_ms(run)}))
    print(nvidia_smi_line())
    return 0


def batch_phases(lib, fn, n: int, rows: int) -> dict:
    """One L2-cold call of a batch kernel built with its phase marks
    (`BATCH_PHASE`, the "diagnostic: phases" layout): the card's clock
    (ns) at each mark of each CTA, relative to the first CTA's start; per
    mark, the median and the latest over the CTAs; the last CTA's marks;
    and the median cycles (clock64) a CTA spends between marks. Marks: 0
    start, 1 stream done (spec_sweep), 2 rows written, 3 chains done, 4
    counts gathered, 5 partial rows written, 6 ticket drawn, 7 totals
    written (the last CTA)."""
    import ctypes

    lib.vt_batch_phases.argtypes = [ctypes.c_void_p]
    lib.vt_batch_phases.restype = ctypes.c_int
    buf = np.zeros((4096, 8, 2), dtype=np.uint64)
    from vamb_torch.kernels import cluster_kernels as CK

    ctas = CK.sweep_col_blocks(n)[1] * rows
    for _ in range(3):  # the last call's marks, L2 cold
        torch.empty(64 << 20, dtype=torch.uint8, device="cuda").zero_()
        check(lib.vt_batch_phases(buf.ctypes.data) == 0, "phases: reset")
        fn()
        torch.cuda.synchronize()
    check(lib.vt_batch_phases(buf.ctypes.data) == 0, "phases: read")
    gt, clk = buf[:ctas, :, 0].astype(np.float64), buf[:ctas, :, 1].astype(np.float64)
    t0 = gt[:, 0].min()
    out = {"ctas": ctas, "median_ns": {}, "latest_ns": {}, "median_cycles_since_previous_mark": {}}
    for k in range(7):
        seen = gt[:, k] > 0
        if seen.any():
            out["median_ns"][k] = float(np.median(gt[seen, k] - t0))
            out["latest_ns"][k] = float((gt[seen, k] - t0).max())
            prev = [j for j in range(k) if (gt[seen, j] > 0).all()]
            if prev:
                out["median_cycles_since_previous_mark"][k] = float(np.median(clk[seen, k] - clk[seen, prev[-1]]))
    last = np.nonzero(gt[:, 7] > 0)[0]
    out["last_ctas_ns"] = {int(c): {k: float(gt[c, k] - t0) for k in range(8) if gt[c, k] > 0} for c in last[:8]}
    return out


def batch_layouts(source: Path = None) -> None:
    """Time each layout of `BATCH_LAYOUTS`, built from the checkout's
    source or `source`: `spec_sweep` and `row_stats` at S 8 (its rows the
    plain version's), L2 cold, at the widths the main paths give them (F_pad
    32) and at 100,096 columns (F_pad 288); each layout that is not a
    diagnostic equal to the plain versions bit for bit. One JSON line per
    (kernel, F_pad, width, layout), with the card's name and power limit."""
    import ctypes

    from vamb_torch.kernels import cluster_kernels as CK

    libs = build_layouts(BATCH_LAYOUTS, "batch", source)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    card = nvidia_smi_line()
    s = SPEC_SEEDS
    for f_pad, widths in ((F_PAD, PATH_WIDTHS[1:]), (AAE_F_PAD, PATH_WIDTHS[1:2])):
        for n in widths:
            mT = torch.as_tensor(clumpy_matrixT(n, f_pad, seed=5), device=dev)
            w = torch.as_tensor(weights(n, seed=5), device=dev)
            cols = [int(c) for c in np.random.default_rng(6).choice(n, s, replace=False)]
            expect = CK.spec_sweep_plain(mT, cols, w)
            for name, (lib, consts) in libs.items():
                lib.vt_spec_sweep.argtypes = [vp, ci, ci, *[ci] * s, ci, vp, vp, vp, vp, vp, vp, vp, vp]
                lib.vt_spec_sweep.restype = ci
                lib.vt_row_stats.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, vp, vp]
                lib.vt_row_stats.restype = ci
                # a workspace of its own: a diagnostic leaves its tickets counted
                partials = torch.zeros((s, CK._SWEEP_MAX_BLOCKS, CK._SWEEP_SLOTS), device=dev)
                count_partials = torch.zeros((s, CK._SWEEP_MAX_BLOCKS, 2), dtype=torch.int32, device=dev)
                ticket = torch.zeros(s, dtype=torch.int32, device=dev)
                rows = torch.empty((s, n), device=dev)
                sums = torch.empty((s, CK._NBINS + 1), device=dev)
                counts = torch.empty((s, 2), dtype=torch.int32, device=dev)
                ws = (partials.data_ptr(), count_partials.data_ptr(), ticket.data_ptr(), sums.data_ptr(),
                      counts.data_ptr(), stream)

                def spec():
                    err = lib.vt_spec_sweep(mT.data_ptr(), f_pad, n, *cols, s, w.data_ptr(), rows.data_ptr(), *ws)
                    check(err == 0, f"layout {name}: spec_sweep launch error {err}")

                def stats():
                    err = lib.vt_row_stats(expect[0].data_ptr(), n, s, w.data_ptr(), *ws)
                    check(err == 0, f"layout {name}: row_stats launch error {err}")
                checked = consts is not None
                for kernel, fn, got in (("spec_sweep", spec, (rows, sums, counts)), ("row_stats", stats, (sums, counts))):
                    if name == "diagnostic: phases":
                        log(json.dumps({"kernel": kernel, "f_pad": f_pad, "n_pad": n, "layout": name,
                                        "phases": batch_phases(lib, fn, n, s if kernel == "row_stats" else 1),
                                        "card": card}))
                    fn()
                    torch.cuda.synchronize()
                    if checked:
                        want = (*expect[:1], torch.cat([expect[1], expect[2][:, None]], 1),
                                torch.stack(expect[3:], 1))[-len(got):]
                        check(all(torch.equal(a, b) for a, b in zip(got, want)),
                              f"layout {name}, {kernel}, F_pad {f_pad}, N {n}: differs from its plain version")
                    log(json.dumps({"kernel": kernel, "f_pad": f_pad, "n_pad": n, "s": s, "layout": name,
                                    "source": str(source or CLUSTER_SOURCE), "checked": checked,
                                    "ms": time_ms(fn), "card": card}))


# ------------------------------------------------------------------ main


def build_all() -> Path:
    """Build both CUDA sources (one nvcc each, started together, with
    ptxas' register report) and both native host libraries from the
    checkout's sources. Returns the libraries to count SASS in."""
    from concurrent.futures import ThreadPoolExecutor

    from vamb_torch import kernels as K
    from vamb_torch.native import autobuild

    t = time.time()
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(K.build, True), pool.submit(K.build_hmm, True),
                pool.submit(autobuild.build_bamcov)]
        autobuild.ensure_built()
        libs = [j.result() for j in jobs]
    check((ROOT / "vamb_torch" / "native" / "libvambops.so").exists(), "libvambops.so did not build")
    log(f"built the CUDA kernels and the native libraries in {time.time() - t:.1f} s")
    return libs[:2]


def main(mode: str = "full") -> int:
    """mode "full" runs phases 1-14; "workflow" phases 1 and 14; "maxsteps" phases 1 and 13; "dist" phases 1 and 12; "kernels" phases 1-2; "recluster"
    phase 1, the Forward kernel's check and phase 7; "taxonomy" phases 1
    and 8; "avamb" phase 1, phase 2 at F_pad 288 and phase 9; "lanes"
    phase 1, phase 2's `spec_sweep` and `row_stats` and phase 10; "bf16"
    phase 1, phase 2's bf16 checks and times, phase 4's `bin default`
    (without its profile and card-vs-CPU run) and phase 11."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    import vamb_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    card = nvidia_smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    for lib_path in build_all():
        sass_counts(lib_path)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()

    def phase_done(name: str) -> None:
        log(f"phase {name} done at {time.time() - t0:.1f} s")

    if mode == "avamb":  # phase 1, phase 2 at F_pad 288, then phase 9
        errs_aae = check_kernels(dev, AAE_F_PAD)
        timed_aae = time_kernels(dev, AAE_F_PAD, (PATH_WIDTHS[1],), PATH_WIDTHS[1])
        phase_done(f"2 (kernel checks and times at F_pad {AAE_F_PAD})")
        with tempfile.TemporaryDirectory() as tmp:
            run_avamb = run_avamb_path(dev, Path(tmp))
        phase_done("9 (the Avamb path)")
        drop = ("launches_by_width",)
        print(json.dumps({"kernels": kernel_rows_aae(timed_aae, errs_aae, run_avamb),
                          "avamb_path": {k: v for k, v in run_avamb.items() if k not in drop}}))
        print(card)
        return 0
    if mode == "lanes":  # phase 1, phase 2's seed-cache kernels, phase 10
        errs = {**check_batch(dev), **{f"{k} at F_pad {AAE_F_PAD}": v
                                       for k, v in check_batch(dev, AAE_F_PAD).items()}}
        timed = time_kernels(dev, only=("spec_sweep", "row_stats"))
        timed_aae = time_kernels(dev, AAE_F_PAD, (PATH_WIDTHS[1],), PATH_WIDTHS[1], only=("spec_sweep",))
        phase_done("2 (spec_sweep and row_stats: checks and times)")
        phase10 = batched_attempts(dev)
        phase_done("10 (batched attempts)")
        print(json.dumps({"max_abs_err": errs,
                          "timed": {f"{k[0]} at F_pad {f}, N_pad {k[1]}": v
                                    for f, t in ((F_PAD, timed), (AAE_F_PAD, timed_aae))
                                    for k, v in t.items()},
                          "batched_attempts": phase10}))
        print(card)
        return 0
    if mode == "bf16":  # phase 1, phase 2's bf16 variants, phase 4's run, phase 11
        errs_bf16 = check_bf16(dev)
        timed_bf16 = time_bf16(dev)
        phase_done("2 (the bf16 variants: checks and times)")
        with tempfile.TemporaryDirectory() as tmp:
            run_100k = run_main_path(dev, Path(tmp), N_CONTIGS, N_GENOMES, 2000,
                                     ("candidate_density_sweep", "medoid_sweep", "gumbel_topc",
                                      "spec_sweep"), profile=False)
        phase_done("4 (100k path, f32: the latent phase 11 compares with)")
        with tempfile.TemporaryDirectory() as tmp:
            run_bf16 = run_bf16_path(dev, Path(tmp), run_100k)
        phase_done("11 (the bf16 path)")
        drop = ("launches_by_width",)
        print(json.dumps({"kernels": kernel_rows_bf16(timed_bf16, errs_bf16, run_bf16),
                          "bf16_path": {k: v for k, v in run_bf16.items() if k not in drop}}))
        print(card)
        return 0
    if mode == "maxsteps":  # phase 1, then phase 13 alone
        errs_c, timed_c, phase13 = run_many_candidates(dev)
        phase_done("13 (C above 32 and wander_kernel)")
        print(json.dumps({"kernels": kernel_rows_many_c(errs_c, timed_c, phase13),
                          "many_candidates": phase13}))
        print(card)
        return 0
    if mode == "dist":  # phase 1, then phase 12 alone
        shard_rows, phase12 = run_dist(dev)
        phase_done("12 (several processes)")
        print(json.dumps({"kernels": shard_rows, "dist": phase12}))
        print(card)
        return 0
    if mode == "workflow":  # phase 1, then phase 14: the workflow, and the counters on its z latent
        with tempfile.TemporaryDirectory() as tmp:
            phase14 = run_workflow_path(dev, Path(tmp))
            phase14["z_card_vs_cpu"] = workflow_agreement(dev, phase14)
        phase_done("14 (the work counters and the workflow)")
        print(json.dumps({"workflow": {k: v for k, v in phase14.items() if not k.startswith("_")}}))
        print(card)
        return 0
    if mode == "taxonomy":  # phase 1, then phase 8 alone
        with tempfile.TemporaryDirectory() as tmp:
            run_tax = run_taxonomy_path(dev, Path(tmp))
        phase_done("8 (the taxonomy path)")
        drop = ("launches_by_width",)
        print(json.dumps({"taxonomy_path": {k: v for k, v in run_tax.items() if k not in drop}}))
        print(card)
        return 0
    if mode != "recluster":
        errs = check_kernels(dev)
        errs_aae = check_kernels(dev, AAE_F_PAD)
        errs_bf16 = check_bf16(dev)
        phase_done("2 (kernel checks)")
    hmm_timed = check_and_time_hmm(dev)
    phase_done("2 (hmm_forward check and times)")
    if mode == "recluster":
        with tempfile.TemporaryDirectory() as tmp:
            run_rc = run_recluster_path(dev, Path(tmp))
        phase_done("7 (BAM input and recluster)")
        print(json.dumps({"kernels": [hmm_row(hmm_timed, run_rc)], "recluster_path": run_rc}))
        print(card)
        return 0
    timed = time_kernels(dev)
    timed_aae = time_kernels(dev, AAE_F_PAD, (PATH_WIDTHS[1],), PATH_WIDTHS[1])
    timed_bf16 = time_bf16(dev)
    phase_done("2 (kernel times)")
    if mode == "kernels":
        print(card)
        return 0
    check_engine(dev)
    phase_done("3 (engine)")
    with tempfile.TemporaryDirectory() as tmp:
        run_100k = run_main_path(dev, Path(tmp), N_CONTIGS, N_GENOMES, 2000,
                                 ("candidate_density_sweep", "medoid_sweep", "gumbel_topc",
                                  "spec_sweep"), agreement=True)
    phase_done("4 and 6 (100k path and its profile)")
    agree = run_100k["card_vs_cpu"]
    for kind in ("gumbel scores", "candidates"):
        check(agree["inputs_seen"][kind] > 0 and agree["inputs_that_differed"][kind] == 0,
              f"phase 4: the card's {kind} differ from the CPU's")
    check(agree["identical_clusters"] == agree["clusters_compared"] == agree["clusters_requested"],
          "phase 4: the card and the CPU emitted different clusters")
    with tempfile.TemporaryDirectory() as tmp:
        run_300k = run_main_path(dev, Path(tmp), BIG_CONTIGS, BIG_GENOMES, BIG_CLUSTERS,
                                 ("row_sweep", "candidate_density_sweep", "gather_blocks",
                                  "medoid_sweep", "gumbel_topc", "spec_sweep", "row_stats"))
    phase_done("5 and 6 (300k path and its profile)")
    check(run_300k["engine_counts"]["cache_and_lanes"]["passes"] > 0,
          "the 300,000-contig path ran no attempt lanes")
    check(len(run_300k["compactions"]) >= 1, "the 300,000-contig path compacted no time")
    check("wander scope full" in run_300k["compactions"][-1],
          "the 300,000-contig path never went back to full sweeps")
    with tempfile.TemporaryDirectory() as tmp:
        run_rc = run_recluster_path(dev, Path(tmp))
    phase_done("7 (BAM input and recluster)")
    with tempfile.TemporaryDirectory() as tmp:
        run_tax = run_taxonomy_path(dev, Path(tmp), run_100k["precision"])
    phase_done("8 (the taxonomy path)")
    with tempfile.TemporaryDirectory() as tmp:
        run_avamb = run_avamb_path(dev, Path(tmp))
    phase_done("9 (the Avamb path)")
    phase10 = batched_attempts(dev)
    phase_done("10 (batched attempts)")
    with tempfile.TemporaryDirectory() as tmp:
        run_bf16 = run_bf16_path(dev, Path(tmp), run_100k)
    phase_done("11 (the bf16 path)")
    shard_rows, phase12 = run_dist(dev, (run_300k["_latent"], run_300k["_lengths"]))
    phase_done("12 (several processes)")
    errs_c, timed_c, phase13 = run_many_candidates(dev, (run_100k["_latent"], run_100k["_lengths"]))
    phase_done("13 (C above 32 and wander_kernel)")
    with tempfile.TemporaryDirectory() as tmp:
        phase14 = run_workflow_path(dev, Path(tmp))
    phase14["counters_100k_card_vs_cpu"] = run_100k["card_vs_cpu"]["work"]
    phase14["headline_300k"] = phase10["lanes_ab"]["headline"]
    phase_done("14 (the work counters and the workflow)")

    kernels = (kernel_rows(timed, errs, run_100k, run_300k, run_tax, run_avamb)
               + kernel_rows_aae(timed_aae, errs_aae, run_avamb)
               + kernel_rows_bf16(timed_bf16, errs_bf16, run_bf16) + shard_rows
               + kernel_rows_many_c(errs_c, timed_c, phase13) + [hmm_row(hmm_timed, run_rc)])
    drop = ("launches", "launches_by_width", "launches_by_fpad", "_latent", "_lengths", "_labels")
    print(json.dumps({"kernels": kernels,
                      "main_path_100k": {k: v for k, v in run_100k.items() if k not in drop},
                      "main_path_300k": {k: v for k, v in run_300k.items() if k not in drop},
                      "recluster_path": run_rc,
                      "taxonomy_path": {k: v for k, v in run_tax.items() if k not in drop},
                      "avamb_path": {k: v for k, v in run_avamb.items() if k not in drop},
                      "batched_attempts": phase10,
                      "bf16_path": {k: v for k, v in run_bf16.items() if k not in drop},
                      "dist": phase12, "many_candidates": phase13,
                      "workflow": {k: v for k, v in phase14.items() if not k.startswith("_")}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--engine-time"]:  # one run of `engine_ab`, in the checkout named
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(engine_time()))
        sys.exit(0)
    if sys.argv[1:2] == ["--engine-ab"]:
        sys.exit(engine_ab(sys.argv[2:]))
    if sys.argv[1:2] == ["--stage-time"]:  # one run of `stage_ab`, in the checkout named
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(stage_time(Path(sys.argv[3]))))
        sys.exit(0)
    if sys.argv[1:2] == ["--stage-ab"]:
        sys.exit(stage_ab(sys.argv[2:]))
    if sys.argv[1:2] == ["--density-layouts"]:
        sys.exit(density_layouts() if torch.cuda.is_available() else 1)
    if sys.argv[1:2] == ["--layouts"]:
        if not torch.cuda.is_available():
            sys.exit(1)
        if len(sys.argv) > 2:  # another checkout's source: its batch kernels alone
            batch_layouts(Path(sys.argv[2]).resolve())
            sys.exit(0)
        gather_and_sweep_layouts()
        batch_layouts()
        sys.exit(0)
    if sys.argv[1:2] == ["--dist-rank"]:  # one rank of phase 12(b)
        sys.exit(dist_rank(sys.argv[2], int(sys.argv[3]), Path(sys.argv[4]), Path(sys.argv[5])))
    if sys.argv[1:2] == ["--dist-main-rank"]:  # one rank of phase 12(e)
        sys.exit(dist_main_rank(sys.argv[2], int(sys.argv[3]), Path(sys.argv[4]), Path(sys.argv[5])))
    if sys.argv[1:2] == ["--dist-engine-rank"]:  # one rank of phase 12(c)
        sys.exit(dist_engine_rank(sys.argv[2], int(sys.argv[3]), Path(sys.argv[4]), Path(sys.argv[5])))
    modes = {"--kernels": "kernels", "--recluster": "recluster", "--taxonomy": "taxonomy",
             "--avamb": "avamb", "--lanes": "lanes", "--bf16": "bf16", "--dist": "dist",
             "--maxsteps": "maxsteps", "--workflow": "workflow"}
    sys.exit(main(modes.get(sys.argv[1] if len(sys.argv) > 1 else "", "full")))
