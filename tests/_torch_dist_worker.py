"""One rank of a multi-process run of `vamb_torch` on the CPU (gloo).

Launched by tests/test_torch_parallel.py, W times, as

    python tests/_torch_dist_worker.py <rendezvous file> <W> <rank> <dir> <scenario>...

It joins a gloo group of W processes through a file rendezvous (so
concurrent test workers never race for a port), reads its inputs from
`<dir>/inputs.npz` (made by the parent with numpy, the same for every rank)
and writes each scenario's results to `<dir>/<scenario>_r<rank>.npz`. It
imports no jax: the parent holds the results against `vamb_tpu`.

Scenarios:
  mesh    the sharding helpers and collectives;
  bn      one training-mode BatchNorm forward and backward over a global
          batch split across the ranks;
  train   3 epochs of data-parallel VAE training;
  engine  the row-sharded engine on the parent's latents;
  subset  the row-sharded engine at the subset scope (attempt lanes auto
          and off, a compacting run) and at bfloat16 distances, with its
          subset and lane counters;
  traffic the engine's collective tally over its first clusters at two
          widths, at full scope and at the subset scope;
  models  2 epochs of data-parallel Taxometer, VAEVAE and AAE training
          (`train_models`), each model's parameters, BatchNorm statistics,
          epoch metrics and replica checks;
  grads   each model's first summed gradient (each of the AAE's three
          phases') over an uneven split of a 90-row batch;
  counters the row-sharded engine's work counters (tests/test_torch_counters.py)
          at full scope, at the subset scope with lanes and compacting.
"""

import itertools
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vamb_torch import cluster  # noqa: E402
from vamb_torch.cluster import ClusterGenerator  # noqa: E402
from vamb_torch.models import VAE, make_dataset  # noqa: E402
from vamb_torch.models import layers  # noqa: E402
from vamb_torch.models.aae import AAE  # noqa: E402
from vamb_torch.models.taxometer import Taxometer  # noqa: E402
from vamb_torch.models.vaevae import VAEVAE  # noqa: E402
from vamb_torch.parallel import (  # noqa: E402
    distributed_close, distributed_init, make_mesh, replicate, shard_rows, shard_rows_padded,
)
from vamb_torch.utils.checkpoint import params_to_jax  # noqa: E402

TRAFFIC_CLUSTERS = 40  # clusters the traffic scenario takes at each width
# the subset scenario's runs, each a latent `<name>_m`, `<name>_len` and
# `<name>_kw` of the inputs
SUBSET_RUNS = ("sub_clumpy", "sub_uniform", "sub_off", "sub_compact", "sub_fallback", "bf16",
               "sub_wide283")
ENGINE_RUNS = ("random300", "clumpy", "compact", "wide283")  # the engine scenario's runs
# the maxsteps scenario's runs (tests/test_torch_wander.py): C above 32 at
# full and subset scope, lanes on and off, compacting; one with "xla"
MAXSTEPS_RUNS = ("ms33_full", "ms40_subset_on", "ms64_subset_off", "ms40_xla")
# the counters scenario's runs (tests/test_torch_counters.py)
COUNTER_RUNS = ("cnt_full", "cnt_subset", "cnt_compact")


def scenario_mesh(mesh, inp) -> dict:
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    odd = np.arange(30, dtype=np.float32).reshape(10, 3)
    lin = layers.Linear(np.random.default_rng(100 + mesh.rank), 5, 3)
    replicate(lin, mesh)
    rep = replicate({"a": torch.full((3,), float(mesh.rank + 1)), "b": [torch.tensor(mesh.rank)]}, mesh)
    # summands whose float32 sum depends on the order
    mine = torch.tensor(inp["order_terms"][mesh.rank])
    return {
        "rows": shard_rows(x, mesh).numpy(),
        "padded": shard_rows_padded(odd, mesh).numpy(),
        "lin_w": lin.w.detach().numpy(), "lin_b": lin.b.detach().numpy(),
        "rep_a": rep["a"].numpy(), "rep_b": rep["b"][0].numpy(),
        "sum": mesh.sum_ranks(mine, "test").numpy(),
        "gathered": mesh.gather_rows(torch.full((mesh.rank + 1, 2), mesh.rank), "test").numpy(),
        "block": np.array(mesh.block(10)),
    }


def scenario_bn(mesh, inp) -> dict:
    x_all, coef_all = inp["bn_x"], inp["bn_coef"]
    lo, hi = mesh.block(len(x_all))
    bn = layers.BatchNorm(x_all.shape[1])
    with torch.no_grad():
        bn.scale.copy_(torch.as_tensor(inp["bn_scale"]))
        bn.bias.copy_(torch.as_tensor(inp["bn_bias"]))
    bn.train()
    x = torch.tensor(x_all[lo:hi], requires_grad=True)
    with layers.global_batch(mesh):
        out = bn(x)
        (out * torch.as_tensor(coef_all[lo:hi])).sum().backward()
    return {"out": out.detach().numpy(), "x_grad": x.grad.numpy(),
            "scale_grad": bn.scale.grad.numpy(), "bias_grad": bn.bias.grad.numpy(),
            "mean": bn.mean.numpy(), "var": bn.var.numpy()}


def scenario_train(mesh, inp) -> dict:
    ds = make_dataset(inp["train_ab"], inp["train_tnf"], inp["train_len"])
    vae = VAE(nsamples=3, nhiddens=[32, 32], nlatent=8, seed=2, device="cpu")
    lines = []
    vae.trainmodel(ds, nepochs=3, batchsize=64, batchsteps=None, mesh=mesh, logger=lines.append)
    flat = params_to_jax(vae.state_dict())
    checks = [line for line in lines if "Parameters identical" in line]
    return {**{k: v for k, v in flat.items()}, "_checks": np.array(len(checks))}


MODELS = ("taxometer", "vaevae", "aae")
GRAD_BATCH = 90  # the grads scenario's batch: blocks of 45 at W = 2, 22 and 23 at W = 4
# each model's gradient sums, in the order of a step
GRAD_KINDS = {"taxometer": ("gradients",), "vaevae": ("gradients",),
              "aae": ("gradients e+d", "gradients disc_z", "gradients disc_y")}


def build_model(name: str, inp, device="cpu"):
    """The narrow model `name` on the inputs' taxonomy graph: Taxometer 16-16
    (flat_softmax), VAEVAE 16-16-8 (flat_softmax), the AAE at 16 / 8 / 8."""
    nodes = [str(x) for x in inp["models_nodes"]]
    parents = [int(x) for x in inp["models_parents"]]
    s = inp["models_ab"].shape[1]
    if name == "taxometer":
        return Taxometer(s, len(nodes), nodes, parents, nhiddens=[16, 16],
                         hier_loss="flat_softmax", seed=3, device=device)
    if name == "vaevae":
        return VAEVAE(s, len(nodes), nodes, parents, nhiddens=[16, 16], nlatent=8,
                      hier_loss="flat_softmax", seed=3, device=device)
    return AAE(s, nhiddens=16, nlatent_z=8, nlatent_y=8, seed=3, device=device)


def train_model(name: str, inp, mesh=None, nepochs: int = 2, batchsize: int = 64,
                batchsteps=(1,)) -> tuple:
    "`build_model`'s model trained on the inputs' data; returns (model, log lines)."
    ds = make_dataset(inp["models_ab"], inp["models_tnf"], inp["models_len"])
    model = build_model(name, inp)
    lines = []
    kw = dict(nepochs=nepochs, batchsize=batchsize, batchsteps=list(batchsteps),
              logger=lines.append, mesh=mesh)
    if name == "aae":
        model.trainmodel(ds, **kw)
    else:
        model.trainmodel(ds, inp["models_targets"], **kw)
    return model, lines


def epoch_metrics(lines: list) -> np.ndarray:
    "The metrics of each `Epoch:` log line (either package's format), in order."
    rows = []
    for line in lines:
        if "Epoch:" not in line:
            continue
        fields = line.split("Batchsize")[0].split(":")[2:]
        rows.append([float(f.split()[0]) for f in fields])
    return np.array(rows)


def scenario_models(mesh, inp) -> dict:
    out = {}
    for name in MODELS:
        model, lines = train_model(name, inp, mesh)
        for k, v in params_to_jax(model.state_dict()).items():
            out[f"{name}:{k}"] = v
        out[f"{name}_metrics"] = epoch_metrics(lines)
        out[f"{name}_checks"] = np.array(sum("Parameters identical" in ln for ln in lines))
    out["traffic_kinds"] = np.array(sorted(mesh.traffic))
    return out


def scenario_grads(mesh, inp) -> dict:
    """Each model's first sum of each gradient kind, one epoch at GRAD_BATCH."""
    seen = {}
    summed = mesh.sum_ranks

    def recording(t, kind):
        total = summed(t, kind)
        if kind.startswith("gradients") and kind not in seen:
            seen[kind] = total.clone()
        return total

    mesh.sum_ranks = recording
    out = {}
    for name in MODELS:
        seen.clear()
        train_model(name, inp, mesh, nepochs=1, batchsize=GRAD_BATCH, batchsteps=())
        for kind in GRAD_KINDS[name]:
            out[f"{name}:{kind}"] = seen[kind].numpy()
    mesh.sum_ranks = summed
    return out


def emission(gen) -> np.ndarray:
    "Each cluster as (medoid, kind, then its sorted members), -1 padded into rows."
    rows = [[c.medoid, ("normal", "loner", "fallback").index(c.kind_str), *np.sort(c.members)]
            for c in gen]
    width = max(len(r) for r in rows)
    return np.array([r + [-1] * (width - len(r)) for r in rows], np.int64)


def scenario_engine(mesh, inp) -> dict:
    out = {}
    for name in ENGINE_RUNS:
        kw = dict(inp[f"{name}_kw"].item())
        gen = ClusterGenerator(inp[f"{name}_m"].copy(), inp[f"{name}_len"], device="cpu",
                               mesh=mesh, **kw)
        out[name] = emission(gen)
        out[f"{name}_compactions"] = np.array(gen.compactions, np.int64).reshape(-1, 3)
    return out


def scenario_subset(mesh, inp) -> dict:
    return _engine_runs(mesh, inp, SUBSET_RUNS)


def scenario_maxsteps(mesh, inp) -> dict:
    return _engine_runs(mesh, inp, MAXSTEPS_RUNS)


def scenario_counters(mesh, inp) -> dict:
    return _engine_runs(mesh, inp, COUNTER_RUNS)


def _engine_runs(mesh, inp, names) -> dict:
    """Each run's emission, compactions, its subset and lane counters and
    its work counters (n_dists, n_dists_effective, emitted_total; the lanes
    not climbed), with its
    ball size `<name>_q` where the inputs give one."""
    out = {}
    for name in names:
        kw = dict(inp[f"{name}_kw"].item())
        cluster._SUBSET_Q = int(inp[f"{name}_q"]) if f"{name}_q" in inp.files else 1 << 13
        gen = ClusterGenerator(inp[f"{name}_m"].copy(), inp[f"{name}_len"], device="cpu",
                               mesh=mesh, **kw)
        cluster._SUBSET_Q = 1 << 13
        out[name] = emission(gen)
        out[f"{name}_compactions"] = np.array(gen.compactions, np.int64).reshape(-1, 3)
        out[f"{name}_subset_counts"] = np.array(list(gen.subset_counts.values()))
        out[f"{name}_lane_counts"] = np.array(list(gen.lane_counts.values()))
        out[f"{name}_lanes"] = np.array(gen.lane_counts["lanes"])
        out[f"{name}_work"] = np.array([gen.n_dists, gen.n_dists_effective, gen.emitted_total])
        out[f"{name}_unclimbed"] = np.array(gen.dist_terms["unclimbed_lanes"])
    return out


def scenario_traffic(mesh, inp) -> dict:
    """The collective tally over the first clusters at N 2,048 and 8,192: at
    full scope, and at the subset scope with a ball of `traffic_q` columns
    (both widths at least 4 Q)."""
    out = {}
    q = int(inp["traffic_q"])
    for scope in ("full", "subset"):
        for n in (2048, 8192):
            cluster._SUBSET_Q = q if scope == "subset" else 1 << 13
            gen = ClusterGenerator(inp[f"traffic{n}_m"].copy(), inp[f"traffic{n}_len"],
                                   device="cpu", mesh=mesh, rng_seed=5, windowsize=60,
                                   wander_scope=scope)
            mesh.reset_traffic()  # the attempts' traffic, not the construction's broadcast
            sizes = [len(c.members) for c in itertools.islice(gen, TRAFFIC_CLUSTERS)]
            tag = f"{scope}{n}"
            out[f"{tag}_kinds"] = np.array(sorted(mesh.traffic))
            out[f"{tag}_max_bytes"] = np.array([mesh.traffic[k]["max_bytes"]
                                                for k in sorted(mesh.traffic)])
            out[f"{tag}_largest_cluster"] = np.array(max(sizes))
            out[f"{tag}_subset_attempts"] = np.array(gen.subset_counts["attempts"])
            out[f"{tag}_f_pad"] = np.array(gen.matrixT.shape[0])
    cluster._SUBSET_Q = 1 << 13
    return out


def main() -> None:
    rendezvous, world, rank, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    torch.set_num_threads(1)
    distributed_init(f"file://{rendezvous}", world, rank, device="cpu", timeout_s=60)
    mesh = make_mesh(world, device="cpu")
    inp = np.load(outdir / "inputs.npz", allow_pickle=True)
    for name in sys.argv[5:]:
        result = globals()[f"scenario_{name}"](mesh, inp)
        np.savez(outdir / f"{name}_r{rank}.npz", **result)
    del mesh  # the group's last reference goes before the group
    distributed_close()
    print("WORKER_OK", rank, flush=True)


if __name__ == "__main__":
    main()
