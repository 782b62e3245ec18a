"""The port's multi-process runtime held against `vamb_tpu`'s mesh on the CPU.

Ranks are separate processes on gloo (tests/_torch_dist_worker.py), joined
through a file rendezvous under tmp_path so concurrent test workers never
race for a port; each process group has a 60 s timeout, and a group that
outlives its join timeout is killed and fails the test. `vamb_tpu` runs its
mesh on the 8 virtual CPU devices of tests/conftest.py, as its own
tests/test_parallel.py does. Held:

* the mesh helpers at W = 2 and 4: row blocks, padding, replication from
  rank 0, a rank-order sum the same on every rank, a gather of rows;
* BatchNorm's global statistics: a training forward and backward over a
  batch split across the ranks equals one process's on the whole batch
  (rtol 1e-5: sums in another order);
* data-parallel VAE training at W = 2 and 4 within `vamb_tpu`'s own
  sharded tolerance of its mesh training after 3 epochs (rtol 5e-4, atol
  5e-5, tests/test_parallel.py:68-91), with parameters bit-identical across
  ranks;
* the row-sharded engine emission-identical (medoid, kind and members of
  every cluster, compactions included) to `vamb_tpu`'s mesh engine on
  tests/test_parallel.py:55-66's data, a clumpy full-scope latent and a
  compacting run, at W = 2 and 4, and bit-identical (sums and emission) to
  the unsharded port at W = 1;
* the same on a 283-wide latent (the AAE's z, F_pad 288) of 2,200 points,
  at full scope and at the forced subset scope with a 1,024-column ball;
* the same at the subset scope and at bfloat16 distances: on
  tests/test_parallel.py:185-205's three subset-wander regimes (attempt
  lanes auto and off), a forced-subset run that compacts, a 1,024-column
  ball that overflows and drifts (`_SUBSET_Q` set on both packages for
  that run), and a bfloat16 run; every rank's emission and its subset and
  lane counters equal rank 0's; at W = 1 bit for bit the unsharded port,
  counters included;
* data-parallel Taxometer (16-16, flat_softmax), VAEVAE (16-16-8,
  flat_softmax) and AAE (16 / 8 / 8) training, 2 epochs on 300 contigs at
  batch 64 then 128, at W = 2 and 4: parameters, BatchNorm statistics and
  epoch metrics within `vamb_tpu`'s own sharded tolerance of its mesh
  training (rtol 5e-4, atol 5e-5; the AAE's dense biases that feed a
  BatchNorm and its running means within 6 steps x lr, see
  `test_dp_models_match_vamb_tpu_mesh`), parameters bit-identical across
  ranks and checked after each epoch; each model's first summed gradient
  (each of the AAE's three phases') over an uneven split of a 90-row batch
  within rtol 1e-5 of one process's gradient on the whole batch; at W = 1,
  `trainmodel(mesh=)` bit for bit `trainmodel()` for Taxometer and the AAE
  (VAEVAE within a stated tolerance: its joint loss adds its batch-mean
  terms once, not to every row);
* each shard entry point's plain version equal to the index plain version
  on a slice of the matrix, at F_pad 32 and 288 (the bf16 ones on a bf16 slice, and the ball's
  gather on a 128-aligned slice), and the Gumbel merge of the shards' keys
  equal to `gumbel_topc_plain` over the global width;
* no per-attempt collective payload grows between N = 2,048 and N = 8,192,
  at full scope and at the subset scope (a 512-column ball, so both widths
  are at least 4 Q): the ball's gather stays within W x Q x (F_pad + 3)
  floats and the members' gathers are bounded by the largest cluster.
"""

import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from vamb_torch import kernels as K
from vamb_torch.cluster import ClusterGenerator as TorchGenerator
from vamb_torch.models import hier as t_hier
from vamb_torch.models import layers as t_layers
from vamb_torch.optim import Adam as TAdam
from vamb_torch.optim import DAdaptAdam as TDAdaptAdam
from vamb_torch.parallel import make_mesh as t_make_mesh
from vamb_torch.taxonomy import ContigTaxonomy
from vamb_torch.utils import threefry
from vamb_torch.utils.checkpoint import flatten_tree, params_to_jax

from vamb_torch import cluster as t_cluster
from vamb_tpu import cluster as j_cluster
from vamb_tpu.cluster import ClusterGenerator as JaxGenerator
from vamb_tpu.models import VAE as JVAE
from vamb_tpu.models import make_dataset as j_make_dataset
from vamb_tpu.models.aae import AAE as JAAE
from vamb_tpu.models.taxometer import Taxometer as JTaxometer
from vamb_tpu.models.vaevae import VAEVAE as JVAEVAE
from vamb_tpu.parallel import make_mesh as j_make_mesh

from ._torch_dist_worker import (
    ENGINE_RUNS, GRAD_BATCH, GRAD_KINDS, MODELS, epoch_metrics, train_model,
)
from .test_parallel import make_raw
from .test_parity_cluster import clumpy_latents
from .test_torch_cluster import _wide_clumps

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_dist_worker.py"
SCENARIOS = ("mesh", "bn", "train", "models", "grads", "engine", "subset", "traffic")
JOIN_TIMEOUT_S = 150
KINDS = ("normal", "loner", "fallback")
SUBSET_RUNS = ("sub_clumpy", "sub_uniform", "sub_off", "sub_compact", "sub_fallback", "bf16",
               "sub_wide283")
FALLBACK_Q = 1 << 10  # sub_fallback's ball: overflows on some attempts
TRAFFIC_Q = 512  # the subset traffic runs' ball: N 2,048 and 8,192 are 4 Q and 16 Q


def model_inputs(n: int = 300, seed: int = 6) -> dict:
    """The models' data: a dataset's raw inputs and a taxonomy cut at random
    depths (some contigs unlabelled), as its graph and each contig's node."""
    ab, tnf, lengths = make_raw(n=n, s=3, seed=seed)
    rng = np.random.default_rng(seed)
    lineages = []
    for _ in range(n):
        g = int(rng.integers(0, 16))
        full = ["D", f"P{g // 8}", f"C{g // 4}", f"G{g // 2}", f"s{g}"]
        cut = int(rng.integers(0, len(full) + 1))
        lineages.append(ContigTaxonomy(full[:cut]) if cut else None)
    nodes, ind, parents = t_hier.make_graph(lineages)
    targets = np.array([0 if t is None else ind[t.ranks[-1]] for t in lineages])
    return {"models_ab": ab, "models_tnf": tnf, "models_len": lengths,
            "models_nodes": np.array(nodes), "models_parents": np.array(parents),
            "models_targets": targets}


def make_inputs(world: int) -> dict:
    rng = np.random.default_rng(11)
    random300 = rng.standard_normal((300, 24)).astype(np.float32)
    random300_len = rng.integers(2000, 9000, 300)
    clumpy, clumpy_len = clumpy_latents(20, 60, 16, noise_frac=0.1, seed=3)
    compact, compact_len = clumpy_latents(40, 50, 16, noise_frac=0.05, seed=8)
    ab, tnf, lengths = make_raw(n=512, s=3, seed=4)
    brng = np.random.default_rng(21)
    t2048, l2048 = clumpy_latents(32, 64, 16, seed=31)
    t8192, l8192 = clumpy_latents(128, 64, 16, seed=31)
    # tests/test_parallel.py:185-205's three subset-wander regimes
    urng = np.random.default_rng(5)
    uniform = urng.standard_normal((2048, 16)).astype(np.float32)
    uniform_len = urng.integers(2000, 50_000, 2048)
    sub_clumpy, sub_clumpy_len = clumpy_latents(40, 100, 16, noise_frac=0.1, seed=3)
    sub_off, sub_off_len = clumpy_latents(20, 80, 16, noise_frac=0.15, seed=9)
    # tests/test_torch_cluster.py's overflow-and-drift regime
    wide, wide_len = _wide_clumps(40, 60, 32, scale=0.06, noise_frac=0.2, seed=4)
    # the AAE's z latent width: 283 features, F_pad 288
    z283, z283_len = _wide_clumps(40, 50, 283, scale=0.01, noise_frac=0.1, seed=12)
    return {
        **model_inputs(),
        "wide283_m": z283, "wide283_len": z283_len,
        "wide283_kw": {"rng_seed": 3, "windowsize": 60},
        "sub_wide283_m": z283, "sub_wide283_len": z283_len, "sub_wide283_q": FALLBACK_Q,
        "sub_wide283_kw": {"rng_seed": 3, "windowsize": 60, "wander_scope": "subset"},
        # float32 summands whose sum depends on the order: 1e8 swallows a 1
        "order_terms": np.array([[1e8, 1.0], [1.0, -1e8], [-1e8, 1.0], [1.0, 3.0]][:world],
                                np.float32),
        "bn_x": brng.normal(2.0, 3.0, (32, 6)).astype(np.float32),
        "bn_coef": brng.normal(size=(32, 6)).astype(np.float32),
        "bn_scale": brng.uniform(0.5, 1.5, 6).astype(np.float32),
        "bn_bias": brng.normal(size=6).astype(np.float32),
        "train_ab": ab, "train_tnf": tnf, "train_len": lengths,
        "random300_m": random300, "random300_len": random300_len, "random300_kw": {},
        "clumpy_m": clumpy, "clumpy_len": clumpy_len,
        "clumpy_kw": {"rng_seed": 7, "windowsize": 60},
        "compact_m": compact, "compact_len": compact_len,
        "compact_kw": {"rng_seed": 2, "windowsize": 60, "batch_clusters": 8,
                       "compact_min_pad": 512},
        "sub_clumpy_m": sub_clumpy, "sub_clumpy_len": sub_clumpy_len,
        "sub_clumpy_kw": {"rng_seed": 7, "windowsize": 60, "wander_scope": "subset"},
        "sub_uniform_m": uniform, "sub_uniform_len": uniform_len,
        "sub_uniform_kw": {"rng_seed": 2, "windowsize": 40, "wander_scope": "subset"},
        "sub_off_m": sub_off, "sub_off_len": sub_off_len,
        "sub_off_kw": {"rng_seed": 1, "windowsize": 60, "wander_scope": "subset",
                       "attempt_batch": "off"},
        "sub_compact_m": compact, "sub_compact_len": compact_len,
        "sub_compact_kw": {"rng_seed": 2, "windowsize": 60, "batch_clusters": 8,
                           "compact_min_pad": 512, "wander_scope": "subset"},
        "sub_fallback_m": wide, "sub_fallback_len": wide_len, "sub_fallback_q": FALLBACK_Q,
        "sub_fallback_kw": {"rng_seed": 13, "windowsize": 120, "wander_scope": "subset"},
        "bf16_m": clumpy, "bf16_len": clumpy_len,
        "bf16_kw": {"rng_seed": 7, "windowsize": 60, "distance_dtype": "bfloat16"},
        "traffic2048_m": t2048, "traffic2048_len": l2048,
        "traffic8192_m": t8192, "traffic8192_len": l8192,
        "traffic_q": TRAFFIC_Q,
    }


def launch(world: int, d: Path, scenarios=SCENARIOS, inputs=None) -> list:
    "W ranks running `scenarios` on `inputs` (default `make_inputs`'s)."
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "inputs.npz", **(make_inputs(world) if inputs is None else inputs))
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, str(WORKER), str(d / "rendezvous"), str(world),
                              str(r), str(d), *scenarios],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env, cwd=str(ROOT))
            for r in range(world)]


def join(procs: list) -> None:
    "Wait for every rank; kill them all and fail if one fails or outlives its limit."
    try:
        for p in procs:
            out, err = p.communicate(timeout=JOIN_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"a rank failed ({p.returncode}):\n{err[-3000:]}")
    except BaseException:
        for q in procs:
            q.kill()
            q.communicate()
        raise


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups (W = 2 and 4) run at once; `vamb_tpu`'s references are
    computed meanwhile. Returns {W: (dir, references)}."""
    base = tmp_path_factory.mktemp("ranks")
    groups = {w: launch(w, base / f"w{w}") for w in (2, 4)}
    try:  # both meshes' references at once: jax compiles them on two threads
        with ThreadPoolExecutor(len(groups)) as pool:
            refs = dict(zip(groups, pool.map(
                lambda w: jax_references(w, np.load(base / f"w{w}" / "inputs.npz",
                                                    allow_pickle=True)), groups)))
    finally:
        for w, procs in groups.items():
            join(procs)
    return {w: (base / f"w{w}", refs[w]) for w in groups}


_CONSTRUCT = threading.Lock()  # the two worlds' threads construct one generator at a time


def jax_generator(inp, name: str, mesh):
    """`vamb_tpu`'s mesh engine on run `name` of the inputs, constructed
    (where `vamb_tpu` reads `_SUBSET_Q`) with the run's ball size, if any."""
    with _CONSTRUCT:
        default = j_cluster._SUBSET_Q
        j_cluster._SUBSET_Q = int(inp[f"{name}_q"]) if f"{name}_q" in inp.files else default
        try:
            return JaxGenerator(inp[f"{name}_m"].copy(), inp[f"{name}_len"], mesh=mesh,
                                **inp[f"{name}_kw"].item())
        finally:
            j_cluster._SUBSET_Q = default


def jax_references(world: int, inp) -> dict:
    mesh = j_make_mesh(world)
    ds = j_make_dataset(inp["train_ab"], inp["train_tnf"], inp["train_len"])
    vae = JVAE(nsamples=3, nhiddens=[32, 32], nlatent=8, seed=2)
    vae.trainmodel(ds, nepochs=3, batchsize=64, batchsteps=None, mesh=mesh)
    refs = {"train": flatten_tree({"params": vae.params, "bn_state": vae.bn_state})}
    refs["models"] = jax_models(inp, mesh)
    for name in (*ENGINE_RUNS, *SUBSET_RUNS):
        gen = jax_generator(inp, name, mesh)
        refs[name] = [(int(c.medoid), c.kind_str, np.sort(np.asarray(c.members))) for c in gen]
    return refs


def jax_models(inp, mesh) -> dict:
    """`vamb_tpu`'s mesh training of `train_model`'s three models: {model:
    (flat parameters and BatchNorm statistics, epoch metrics)}."""
    nodes = [str(x) for x in inp["models_nodes"]]
    parents = [int(x) for x in inp["models_parents"]]
    ds = j_make_dataset(inp["models_ab"], inp["models_tnf"], inp["models_len"])
    kw = dict(nepochs=2, batchsize=64, batchsteps=[1], mesh=mesh)
    out = {}
    for name in MODELS:
        lines = []
        if name == "taxometer":
            model = JTaxometer(3, len(nodes), nodes, parents, nhiddens=[16, 16],
                               hier_loss="flat_softmax", seed=3)
            model.trainmodel(ds, inp["models_targets"], logger=lines.append, **kw)
        elif name == "vaevae":
            model = JVAEVAE(3, len(nodes), nodes, parents, nhiddens=[16, 16], nlatent=8,
                            hier_loss="flat_softmax", seed=3)
            model.trainmodel(ds, inp["models_targets"], logger=lines.append, **kw)
        else:
            model = JAAE(3, nhiddens=16, nlatent_z=8, nlatent_y=8, seed=3)
            model.trainmodel(ds, logger=lines.append, **kw)
        flat = flatten_tree({"params": model.params, "bn_state": model.bn_state})
        out[name] = ({k: np.asarray(v) for k, v in flat.items()}, epoch_metrics(lines))
    return out


def results(d: Path, name: str, world: int) -> list:
    return [np.load(d / f"{name}_r{r}.npz") for r in range(world)]


def clusters_of(rows: np.ndarray) -> list:
    return [(int(r[0]), KINDS[int(r[1])], r[2:][r[2:] >= 0]) for r in rows]


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_helpers(runs, world):
    d, _ = runs[world]
    res = results(d, "mesh", world)
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    np.testing.assert_array_equal(np.concatenate([r["rows"] for r in res]), x)
    padded = np.concatenate([r["padded"] for r in res])
    assert len(padded) % world == 0
    np.testing.assert_array_equal(padded[:10], np.arange(30, dtype=np.float32).reshape(10, 3))
    assert not padded[10:].any()
    lin0 = t_layers.Linear(np.random.default_rng(100), 5, 3)
    terms = np.array([[1e8, 1.0], [1.0, -1e8], [-1e8, 1.0], [1.0, 3.0]][:world], np.float32)
    expect = terms[0]
    for t in terms[1:]:
        expect = expect + t  # float32, rank order
    for r, res_r in enumerate(res):
        np.testing.assert_array_equal(res_r["lin_w"], lin0.w.detach().numpy())
        np.testing.assert_array_equal(res_r["lin_b"], lin0.b.detach().numpy())
        np.testing.assert_array_equal(res_r["rep_a"], np.ones(3, np.float32))
        assert int(res_r["rep_b"]) == 0
        np.testing.assert_array_equal(res_r["sum"], expect)
        np.testing.assert_array_equal(
            res_r["gathered"], np.concatenate([np.full((q + 1, 2), q) for q in range(world)]))
        assert tuple(res_r["block"]) == (r * 10 // world, (r + 1) * 10 // world)


@pytest.mark.parametrize("world", [2, 4])
def test_batchnorm_global_statistics(runs, world):
    d, _ = runs[world]
    res = results(d, "bn", world)
    inp = np.load(d / "inputs.npz", allow_pickle=True)
    bn = t_layers.BatchNorm(6)
    with torch.no_grad():
        bn.scale.copy_(torch.as_tensor(inp["bn_scale"]))
        bn.bias.copy_(torch.as_tensor(inp["bn_bias"]))
    bn.train()
    x = torch.tensor(inp["bn_x"], requires_grad=True)
    out = bn(x)
    (out * torch.as_tensor(inp["bn_coef"])).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["out"] for r in res]), out.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([r["x_grad"] for r in res]), x.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(r["scale_grad"] for r in res), bn.scale.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(r["bias_grad"] for r in res), bn.bias.grad.numpy(), **tol)
    for r in res:  # the running statistics: the global batch's, on every rank
        np.testing.assert_allclose(r["mean"], bn.mean.numpy(), **tol)
        np.testing.assert_allclose(r["var"], bn.var.numpy(), **tol)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_training_matches_vamb_tpu_mesh(runs, world):
    d, refs = runs[world]
    res = results(d, "train", world)
    for r in res[1:]:  # replicas bit-identical on every rank
        for k in refs["train"]:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
    assert all(int(r["_checks"]) == 3 for r in res)  # checked after each epoch
    for k, v in refs["train"].items():
        np.testing.assert_allclose(res[0][k], np.asarray(v), rtol=5e-4, atol=5e-5, err_msg=k)


# the AAE's steps in `train_model`'s 2 epochs on 300 rows: 4 at batch 64, 2 at 128
AAE_STEPS, AAE_LR = 6, 1e-3


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("model", MODELS)
def test_dp_models_match_vamb_tpu_mesh(runs, world, model):
    """Data-parallel training of each model within `vamb_tpu`'s sharded
    tolerance of its mesh training (rtol 5e-4, atol 5e-5), parameters and
    BatchNorm statistics and the epoch metrics (the logs' 6-8 digits), the
    batch doubled after epoch 1; replicas bit-identical on every rank and
    checked after each epoch. Apart: the AAE's dense biases that feed a
    BatchNorm, and the running means that follow them. Such a bias has a
    gradient of zero but for rounding, which Adam scales to a step of ~lr
    all the same (tests/test_torch_aae.py), so they are held within the
    run's steps x lr."""
    d, refs = runs[world]
    res = results(d, "models", world)
    want, want_metrics = refs["models"][model]
    keys = [k for k in res[0].files if k.startswith(f"{model}:")]
    assert {k.split(":", 1)[1] for k in keys} == set(want)
    for r in res[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
    assert all(int(r[f"{model}_checks"]) == 2 for r in res)
    np.testing.assert_allclose(res[0][f"{model}_metrics"], want_metrics, rtol=5e-4, atol=5e-5)
    assert res[0][f"{model}_metrics"].shape[0] == 2
    for k in keys:
        name = k.split(":", 1)[1]
        pre_bn = model == "aae" and name.endswith(("/dense/b", "/mean"))
        np.testing.assert_allclose(res[0][k], want[name], rtol=5e-4,
                                   atol=AAE_STEPS * AAE_LR if pre_bn else 5e-5, err_msg=k)
    kinds = set(res[0]["traffic_kinds"])
    assert {"gradients", "gradients e+d", "gradients disc_z", "gradients disc_y", "metrics",
            "checksums", "batchnorm sums", "batchnorm sums cotangents", "replicate"} <= kinds


def one_process_gradients(model: str, inp, monkeypatch) -> list:
    """The port's first gradient of each of `model`'s optimizers on one
    process, on the whole first batch of the grads scenario's epoch: each
    optimizer's flat gradient at its first step, in the step's order."""
    first = {}
    for cls in (TAdam, TDAdaptAdam):
        def step(self, _orig=cls.step):
            if id(self) not in first:
                first[id(self)] = torch.cat([
                    (torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                    for p in self.params]).clone()
            return _orig(self)
        monkeypatch.setattr(cls, "step", step)
    train_model(model, inp, None, nepochs=1, batchsize=GRAD_BATCH, batchsteps=())
    return list(first.values())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("model", MODELS)
def test_dp_summed_gradient_is_one_process_gradient(runs, world, model, monkeypatch):
    """A step's gradient summed over the ranks, each on its block of a
    90-row batch (uneven at W = 4), equals one process's gradient on the
    whole batch within rtol 1e-5 (sums in another order; atol 1e-6 of the
    largest entry, for entries that a sum over rows cancels to near zero,
    whose rounding is that of their terms): Taxometer's and VAEVAE's, and
    each of the AAE's three
    phases', whose inputs the phase before updated. Every rank sums alike."""
    d, _ = runs[world]
    res = results(d, "grads", world)
    inp = np.load(d / "inputs.npz", allow_pickle=True)
    want = one_process_gradients(model, inp, monkeypatch)
    assert len(want) == len(GRAD_KINDS[model])
    for kind, w in zip(GRAD_KINDS[model], want):
        got = res[0][f"{model}:{kind}"]
        for r in res[1:]:
            np.testing.assert_array_equal(r[f"{model}:{kind}"], got, err_msg=kind)
        w = w.numpy()
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6 * np.abs(w).max(), err_msg=kind)


# VAEVAE at W = 1: the joint loss's batch-mean terms added once (mean(rows) +
# terms) where the unsharded loss adds them to every row (mean(rows + terms)):
# an ulp apart a step, which Adam's step carries into the weights
VAEVAE_W1 = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_dp_models_at_w1_are_the_unsharded_training(model):
    """`trainmodel(mesh=)` over a world of one equals `trainmodel()`: bit
    for bit for Taxometer and the AAE (the sharded means are the unsharded
    ones: `layers.batch_mean` is sum over count, as torch's CPU mean is),
    and VAEVAE within VAEVAE_W1, its epoch metrics within rtol 1e-5."""
    inp = model_inputs()
    (plain, plain_lines), (meshed, mesh_lines) = (
        train_model(model, inp, mesh) for mesh in (None, t_make_mesh(1, device="cpu")))
    a, b = params_to_jax(plain.state_dict()), params_to_jax(meshed.state_dict())
    assert sum("Parameters identical on 1 ranks" in ln for ln in mesh_lines) == 2
    if model == "vaevae":
        np.testing.assert_allclose(epoch_metrics(mesh_lines), epoch_metrics(plain_lines), rtol=1e-5)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg=k, **VAEVAE_W1)
        return
    assert epoch_metrics(mesh_lines).tolist() == epoch_metrics(plain_lines).tolist()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def assert_same_emission(rows: np.ndarray, want: list) -> None:
    "A rank's emission (`_torch_dist_worker.emission`) equals `vamb_tpu`'s clusters."
    got = clusters_of(rows)
    assert len(got) == len(want)
    for i, ((gm, gk, gmem), (wm, wk, wmem)) in enumerate(zip(got, want)):
        assert (gm, gk) == (wm, wk), (i, gm, gk, wm, wk)
        np.testing.assert_array_equal(gmem, wmem)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ENGINE_RUNS)
def test_sharded_engine_matches_vamb_tpu_mesh(runs, world, name):
    d, refs = runs[world]
    res = results(d, "engine", world)
    for r in res[1:]:
        np.testing.assert_array_equal(r[name], res[0][name])
    assert_same_emission(res[0][name], refs[name])
    if name == "compact":  # the ladder in units of 128 x W
        steps = [tuple(c[1:]) for c in res[0]["compact_compactions"]]
        assert steps and all(new % (128 * world) == 0 for _, new in steps), steps


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", SUBSET_RUNS)
def test_sharded_subset_and_bf16_engine_matches_vamb_tpu_mesh(runs, world, name):
    """The subset wander, attempt lanes and bfloat16 distances under a mesh:
    each cluster's medoid, kind and members `vamb_tpu`'s mesh engine's, and
    every rank's emission, compactions and counters rank 0's."""
    d, refs = runs[world]
    res = results(d, "subset", world)
    for r in res[1:]:
        for key in (name, f"{name}_compactions", f"{name}_subset_counts", f"{name}_lane_counts"):
            np.testing.assert_array_equal(r[key], res[0][key], err_msg=key)
    assert_same_emission(res[0][name], refs[name])
    attempts, overflow, drift = res[0][f"{name}_subset_counts"]
    lanes = int(res[0][f"{name}_lanes"])
    # bfloat16 distances keep to full sweeps, and the uniform latent's seeds
    # are all loners, emitted in bursts with no wander
    wanders = name not in ("bf16", "sub_uniform")
    assert (attempts > 0) == wanders
    assert (lanes > 0) == (wanders and name != "sub_off")
    if name == "sub_fallback":
        assert overflow > 0 and drift > 0
    if name == "sub_compact":
        steps = [tuple(c[1:]) for c in res[0]["sub_compact_compactions"]]
        assert steps and all(new % (128 * world) == 0 for _, new in steps), steps


@pytest.mark.parametrize("world", [2, 4])
def test_no_per_attempt_payload_grows_with_n(runs, world):
    d, _ = runs[world]
    r = results(d, "traffic", world)[0]
    kinds = {"query features", "sums", "wander keys", "candidate densities", "members"}
    for scope in ("full", "subset"):
        small = dict(zip(r[f"{scope}2048_kinds"], r[f"{scope}2048_max_bytes"]))
        large = dict(zip(r[f"{scope}8192_kinds"], r[f"{scope}8192_max_bytes"]))
        if scope == "subset":
            kinds |= {"ball counts", "ball", "lane decisions", "lane members"}
            assert all(int(r[f"subset{n}_subset_attempts"]) > 0 for n in (2048, 8192))
        assert set(small) == set(large) >= kinds, (scope, sorted(small), sorted(large))
        for n, tally in ((2048, small), (8192, large)):
            largest = int(r[f"{scope}{n}_largest_cluster"])
            # the emitted members: bounded by the largest cluster (a lane
            # pass emits at most 7 lanes)
            assert tally["members"] <= 8 * world * largest
            if scope == "subset":
                assert tally["lane members"] <= 8 * world * 7 * largest
                f_pad = int(r[f"subset{n}_f_pad"])
                assert tally["ball"] <= world * TRAFFIC_Q * (f_pad + 3) * 4, tally["ball"]
        for kind in small.keys() - {"members", "lane members"}:
            assert large[kind] <= small[kind], (scope, kind, small[kind], large[kind])


@pytest.mark.parametrize("name,kw", [
    ("clumpy", dict(rng_seed=7, windowsize=60)),
    ("compact", dict(rng_seed=2, windowsize=60, batch_clusters=8, compact_min_pad=128)),
    ("clumpy", dict(rng_seed=7, windowsize=60, wander_scope="subset", attempt_batch="on")),
    ("clumpy", dict(rng_seed=7, windowsize=60, wander_scope="subset", attempt_batch="off")),
    ("compact", dict(rng_seed=2, windowsize=60, batch_clusters=8, compact_min_pad=128,
                     wander_scope="subset")),
    ("sub_fallback", dict(rng_seed=13, windowsize=120, wander_scope="subset")),
    ("clumpy", dict(rng_seed=7, windowsize=60, distance_dtype="bfloat16")),
])
def test_sharded_engine_at_w1_is_the_unsharded_engine(name, kw, monkeypatch):
    """A world of one: emission, every attempt's sums, the compactions and
    the subset and lane counters bit for bit the unsharded engine's, at
    full scope, at the subset scope (lanes on and off, compacting, a ball
    that overflows and drifts) and at bfloat16 distances."""
    inp = make_inputs(1)
    m, lengths = inp[f"{name}_m"], inp[f"{name}_len"]
    if name == "sub_fallback":
        monkeypatch.setattr(t_cluster, "_SUBSET_Q", FALLBACK_Q)
    traced = []
    for mesh in (None, t_make_mesh(1, device="cpu")):
        gen = TorchGenerator(m.copy(), lengths, device="cpu", mesh=mesh, **kw)
        gen.sums_trace = []
        clusters = [(c.medoid, c.kind_str, c.members.tolist(), c.radius, c.observed_pvr) for c in gen]
        traced.append((clusters, gen.sums_trace, gen.compactions, gen.subset_counts,
                       gen.lane_counts))
    assert traced[0] == traced[1]
    assert traced[0][1]  # the attempts' sums were recorded
    if name == "compact":
        assert traced[0][2]
    subset = kw.get("wander_scope") == "subset"
    assert (traced[0][3]["attempts"] > 0) == subset
    assert (traced[0][4]["lanes"] > 0) == (subset and kw.get("attempt_batch") != "off")
    if name == "sub_fallback":
        assert traced[0][3]["overflow"] > 0 and traced[0][3]["drift"] > 0


def _slice_inputs(seed: int, n: int = 1024, f: int = 32, lo: int = 256, hi: int = 640):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(f, n)).astype(np.float32)
    m /= np.linalg.norm(m, axis=0, keepdims=True) * np.sqrt(2)
    m[:, 300:340] = m[:, 310:311] + 0.001 * rng.normal(size=(f, 40)).astype(np.float32)
    w = rng.uniform(1000, 5000, n).astype(np.float32)
    w[rng.random(n) < 0.2] = 0.0
    return torch.as_tensor(m), torch.as_tensor(w), lo, hi


@pytest.mark.parametrize("f_pad", [32, 288])
def test_shard_entry_points_equal_slicing_the_index_entry_points(f_pad):
    """At the VAE's F_pad 32 and the AAE's 288 (its 283-wide z latent, the
    kernels' generic width), on a slice [lo, hi) of the matrix, each shard entry point given a
    query's features (and its local column) equals the index entry point on
    the slice bit for bit, on a float32 and on a bfloat16 slice (the query
    the bf16 columns widened), and with the query outside the slice (-1)
    its row is the whole matrix's row sliced. The ball's gather on a
    128-aligned slice equals `gather_ball` of the whole matrix for that
    slice's blocks, each slot's column global."""
    m, w, lo, hi = _slice_inputs(3, f=f_pad)
    wp = w[lo:hi].contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        part = m[:, lo:hi].to(dtype).contiguous()
        q = part.float()
        three = [60, 3, 60]
        for got, want in ((K.medoid_sweep_shard(part, q[:, 60].contiguous(), 60, wp),
                           K.medoid_sweep(part, 60, wp)),
                          (K.spec_sweep_shard(part, q[:, three].contiguous(), three, wp),
                           K.spec_sweep(part, three, wp))):
            for g, e in zip(got, want):
                assert torch.equal(g, e), dtype
        cand = torch.tensor([60, 55, 1, 70], dtype=torch.int64)
        assert torch.equal(K.candidate_density_shard(part, q[:, cand].contiguous(), cand, wp),
                           K.candidate_density_sweep(part, cand, wp)), dtype
    part = m[:, lo:hi].contiguous()
    kept = w > 0
    d0 = K.row_sweep(m, 310)
    local = torch.tensor([2, 0, 1, 0], dtype=torch.int32)  # slots past nb = 3 masked
    first = lo // 128
    for got, want in zip(K.gather_ball_shard(part, local, 3, wp, kept[lo:hi], d0[lo:hi], lo),
                         K.gather_ball(m, local + first, 3, w, kept, d0)):
        assert torch.equal(got, want)
    # a query held by another rank: its row is the full row's slice
    d, *_ = K.medoid_sweep_shard(part, m[:, 5].contiguous(), -1, wp)
    assert torch.equal(d, K.row_sweep(m, 5)[lo:hi])
    rows, *_ = K.spec_sweep_shard(part, m[:, [5, 700]].contiguous(), [-1, -1], wp)
    assert torch.equal(rows[0], K.row_sweep(m, 5)[lo:hi])
    assert torch.equal(rows[1], K.row_sweep(m, 700)[lo:hi])


@pytest.mark.parametrize("world,c,mask", [(2, 25, "some"), (4, 25, "some"), (4, 32, "few")])
def test_gumbel_merge_equals_topc_over_the_global_width(world, c, mask):
    """Each shard's `gumbel_topc_shard_plain` keys over its slice of the
    stream, merged by `topc_merge`, give `gumbel_topc_plain`'s candidates
    and flags over the global width, the fill rule included where fewer
    than C columns are eligible."""
    n = 2048
    rng = np.random.default_rng(world + c)
    d = torch.as_tensor(rng.uniform(0.0, 0.08, n).astype(np.float32))
    kept = torch.as_tensor(rng.random(n) < (0.9 if mask == "some" else 0.004))
    tried = torch.as_tensor(rng.random(n) < 0.1)
    medoid = 777
    key = threefry.split_host(threefry.PRNGKey(world))[1]
    want = K.gumbel_topc_plain(key, d, kept, tried, medoid, c)
    keys = []
    for r in range(world):
        lo, hi = r * n // world, (r + 1) * n // world
        keys.append(K.gumbel_topc_shard(key, d[lo:hi], kept[lo:hi], tried[lo:hi], medoid, c, n, lo))
    cand, valid = K.topc_merge(torch.stack(keys), c)
    assert torch.equal(cand, want[0]) and torch.equal(valid, want[1])
    if mask == "few":
        assert not valid.all()
    scores = K.gumbel_scores_plain(key, d, kept, tried, medoid)
    for r in range(world):  # a shard's scores are the global draw's slice
        lo, hi = r * n // world, (r + 1) * n // world
        part = K.gumbel_scores_plain(key, d[lo:hi], kept[lo:hi], tried[lo:hi], medoid, lo)
        assert torch.equal(part, scores[lo:hi])
