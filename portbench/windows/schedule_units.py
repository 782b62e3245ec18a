"""A window of whole units of the VAE's training schedule.

A unit is one `vamb_torch.models.vae.VAE.trainmodel` call as
`pipeline.trainvae` makes it, with the configuration's `nepochs`,
`batchsize` and `batchsteps`: the published schedule (batch 256 doubling at
epochs 25, 75, 150 and 225 of 300) divided by 25. Units run back to back,
on one model that trains on, until the window's seconds have passed; the
window closes at the end of that unit. Contigs trained are each epoch's
batches times its batch size (the last incomplete batch dropped), summed.

Set-up makes the contigs' raw TNF, depths and lengths from the seed, the
dataset from them as the pipeline does (`make_dataset`), and the model
(`VAE`, seeded by the run's seed). It then drives that model through the
window's own call on the window's dataset for one epoch at the first
batch size, recording its first three steps, and warms the schedule's
larger batch sizes on the dataset's first rows. The window's first unit
records the first three steps at each of its batch sizes.

The output check follows each recorded stretch in float64: set-up's from
the seed (the weights, the dataset and every draw worked out again), the
window's from the program's weights and optimizer state where the stretch
starts, with the draws worked out again from the seed and the epochs
trained before.
"""

import time

import numpy as np
import torch

from portbench.lib.inputs import planted_contigs
from portbench.reference import vae_steps

CHECKED_STEPS = 3
B1 = 0.9  # the optimizer's first beta: its m after a step gives the step's gradient
# compared numbers that are the worst stretch's
WORST = ("loss_gap", "first_grad_gap", "change_gap")


def _sync(run):
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def schedule(cfg: dict, n: int) -> list[int]:
    "Each epoch's batch size in a unit, capped at the rows, as the trainer sets it."
    return [min(cfg["batchsize"] * 2 ** sum(s <= e for s in cfg["batchsteps"]), n)
            for e in range(cfg["nepochs"])]


def unit_work(cfg: dict, n: int) -> tuple[int, int]:
    "(optimizer steps, contigs trained) of a unit over `n` rows, drop-last."
    steps = contigs = 0
    for bs in schedule(cfg, n):
        nb = 1 if n <= bs else n // bs
        steps, contigs = steps + nb, contigs + nb * bs
    return steps, contigs


def linear_flops_per_contig(cfg: dict) -> int:
    """Float32 operations of one contig through the VAE's Linear layers,
    forward and backward: 6 x in x out summed over the layers."""
    nf = cfg["nsamples"] + vae_steps.NTNF + 1
    h = cfg["nhiddens"]
    dims = [(a, b) for a, b in zip([nf] + h, h)] + [(h[-1], cfg["nlatent"])]
    dims += [(a, b) for a, b in zip([cfg["nlatent"]] + h[::-1], h[::-1])] + [(h[0], nf)]
    return 6 * sum(a * b for a, b in dims)


def _stretches(cfg: dict, n: int, chain: int) -> dict:
    """The stretches a unit records, by the optimizer step each starts at:
    the first steps at each batch size of the schedule, with the epochs
    trained before (`chain` before the unit), the batch size and the steps."""
    out, step, prev = {}, 0, None
    for e, bs in enumerate(schedule(cfg, n)):
        nb = 1 if n <= bs else n // bs
        if bs != prev:
            out[step] = {"chain": chain + e, "batch": bs, "steps": min(CHECKED_STEPS, nb)}
        step, prev = step + nb, bs
    return out


def _flat(vae) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).clone() for p in vae.parameters_flat_order()])


class _Recorder:
    """Records stretches of one `trainmodel` call (`_stretches`): each
    step's loss, the weights and the optimizer state before the stretch,
    the optimizer's m after its first step (which gives the gradient the
    optimizer got) and the weights after its last step. It wraps the
    model's loss and the optimizer the call builds, and plants the tests'
    faults there."""

    def __init__(self, vae, fault, stretches: dict):
        self.vae, self.fault, self.stretches = vae, fault, stretches
        self.calls = self.steps = 0
        self.open = None  # the stretch being recorded
        self.records = []

    def calc_loss(self, depths_in, depths_out, tnf_in, tnf_out, ab_in, ab_out, mu, weights):
        from vamb_torch.models.vae import VAE

        args = [depths_in, depths_out, tnf_in, tnf_out, ab_in, ab_out, mu]
        if self.fault == "half_batch":  # the mean taken over the first half of the rows
            h = len(mu) // 2
            args = [a[:h] for a in args]
        out = VAE.calc_loss(self.vae, *args, weights)
        if self.fault == "answer_altered":
            out = (out[0] * (1 + 1e-3), *out[1:])
        if self.calls in self.stretches:
            self.open = dict(self.stretches[self.calls], loss=[])
            self.records.append(self.open)
        if self.open is not None and len(self.open["loss"]) < self.open["steps"]:
            self.open["loss"].append(out[0].detach().clone())
        self.calls += 1
        return out

    def make_optimizer(self, cls):
        def build(*args, **kwargs):
            opt = cls(*args, **kwargs)
            step = opt.step

            def recorded():
                rec = self.open if self.steps in self.stretches else None
                if rec is not None:
                    rec.update(params=_flat(self.vae), m=opt.m.clone(), v=opt.v.clone(),
                               s=opt.s.clone(), d=opt.d.clone(), num=opt.numerator.clone())
                if self.fault != "state_unchanged":
                    step()
                if rec is not None:
                    rec["m1"] = opt.m.clone()
                if self.open is not None and len(self.open["loss"]) == self.open["steps"] \
                        and "end" not in self.open:
                    self.open["end"] = _flat(self.vae)
                    self.open = None
                self.steps += 1

            opt.step = recorded
            return opt
        return build


def _recorded_call(run, dataset, stretches: dict, **kwargs) -> list:
    """One `trainmodel` call of the run's model with `stretches` recorded."""
    from vamb_torch.models import vae as vae_module

    rec = _Recorder(run.vae, run.fault, stretches)
    saved = vae_module.DAdaptAdam
    vae_module.DAdaptAdam = rec.make_optimizer(saved)
    run.vae.calc_loss = rec.calc_loss
    try:
        run.vae.trainmodel(dataset, **kwargs)
    finally:
        vae_module.DAdaptAdam = saved
        del run.vae.calc_loss
    return rec.records


def setup(run) -> None:
    from vamb_torch.models import VAE, make_dataset
    from vamb_torch.models.dataset import VAEDataset

    cfg, tr = run.config, run.traffic
    run.raw = planted_contigs(tr["contigs"], cfg["nsamples"], vae_steps.NTNF, tr, run.seed,
                              run.device)
    ab, tnf, lengths = run.raw
    run.dataset = make_dataset(ab.copy(), tnf.copy(), lengths, destroy=True)
    run.vae = VAE(cfg["nsamples"], nhiddens=cfg["nhiddens"], nlatent=cfg["nlatent"],
                  alpha=cfg["alpha"], beta=cfg["beta"], dropout=cfg["dropout"], seed=run.seed,
                  device=run.device, precision="bf16" if run.control == "bf16" else cfg["precision"])
    if run.control == "tf32":  # the program turns TF32 off as it builds the model
        torch.backends.cuda.matmul.allow_tf32 = True
    n = run.dataset.n_obs
    first = _stretches(dict(cfg, nepochs=1, batchsteps=[]), n, 0)
    run.records = _recorded_call(run, run.dataset, first, nepochs=1, batchsize=cfg["batchsize"],
                                 batchsteps=[])
    run.records[0]["from_seed"] = True
    run.epochs = 1  # epochs the model has trained: each took the next key of its chain
    sizes = sorted(set(schedule(cfg, n)) - {cfg["batchsize"]})
    if sizes:
        rows = min(2 * sizes[-1], n)
        small = VAEDataset(*(a[:rows] for a in run.dataset))
        run.vae.trainmodel(small, nepochs=len(sizes), batchsize=sizes[0],
                           batchsteps=list(range(1, len(sizes))))
        run.epochs += len(sizes)
    run.window_recorded = False
    _sync(run)


def window(run, seconds: float, tracer) -> dict:
    cfg = run.config
    steps_unit, contigs_unit = unit_work(cfg, run.dataset.n_obs)
    if tracer is not None:
        from vamb_torch.models.vae import VAE

        def traced(*args):
            tracer.step()
            return VAE.calc_loss(run.vae, *args)

        run.vae.calc_loss = traced
    kwargs = {"nepochs": cfg["nepochs"], "batchsize": cfg["batchsize"],
              "batchsteps": cfg["batchsteps"]}
    units = 0
    t0 = time.perf_counter()
    while True:
        if run.window_recorded or tracer is not None:
            run.vae.trainmodel(run.dataset, **kwargs)
        else:  # the first unit of the run's first window
            run.records += _recorded_call(
                run, run.dataset, _stretches(cfg, run.dataset.n_obs, run.epochs), **kwargs)
            run.window_recorded = True
        run.epochs += cfg["nepochs"]
        _sync(run)
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    if tracer is not None:
        del run.vae.calc_loss
    return {"window_s": window_s, "units": units, "steps": units * steps_unit,
            "contigs": units * contigs_unit, "flops_per_contig": linear_flops_per_contig(cfg)}


def release(run) -> None:
    del run.vae, run.dataset


def _leaf_gaps(got, want, median) -> list:
    "Each leaf's gap between the program's norm and the reference's, over max(that leaf's, the median)."
    return [abs(float(g.norm()) - float(np.linalg.norm(w))) / max(float(np.linalg.norm(w)), median)
            for g, w in zip(got, want)]


def _gaps(rec: dict, ref: dict, sizes: list) -> dict:
    """One stretch's loss gap, its first gradient's gap (the worst leaf's
    and the median leaf's) and its parameters' change's (the worst leaf's)."""
    loss = max(abs(float(a) - b) / abs(b) for a, b in zip(rec["loss"], ref["loss"]))
    d0 = float(rec["d"])
    # m after a step is B1 m + (1 - B1) d g, lr 1
    grad = torch.split((rec["m1"].double() - B1 * rec["m"].double()) / ((1 - B1) * d0), sizes)
    gnorm = [float(np.linalg.norm(g)) for g in ref["grad"]]
    median = float(np.median(gnorm))
    # leaves whose reference gradient is rounding (a dense bias before a
    # BatchNorm) move by rounding alone under Adam: left out of the change
    moving = [i for i, n in enumerate(gnorm) if n >= 1e-3 * median]
    change = torch.split((rec["end"] - rec["params"]).double(), sizes)
    cnorm = [float(np.linalg.norm(ref["change"][i])) for i in moving]
    g = _leaf_gaps(grad, ref["grad"], median)
    c = _leaf_gaps([change[i] for i in moving], [ref["change"][i] for i in moving],
                   float(np.median(cnorm)))
    return {"loss_gap": loss, "first_grad_gap": max(g), "median_grad_gap": float(np.median(g)),
            "change_gap": max(c),
            "leaves": {"grad": [float(f"{x:.3g}") for x in g], "change": [float(f"{x:.3g}") for x in c]}}


def check(run, work: dict):
    """Each recorded stretch's losses, first gradient and parameters'
    change against the reference's: the worst stretch's gaps, and the
    median leaf's gradient gap of set-up's stretch, followed from the seed."""
    cfg = run.config
    rows = vae_steps.dataset(*run.raw)
    sizes = [int(np.prod(s)) for s in _leaf_shapes(cfg)]
    run.check_detail = []
    for rec in run.records:
        start = None if rec.get("from_seed") else {
            "params": rec["params"].double().cpu().numpy(),
            **{k: rec[k].double().cpu().numpy() for k in ("m", "v", "s")},
            "d": float(rec["d"]), "num": float(rec["num"])}
        ref = vae_steps.follow(cfg, run.seed, rows, rec["chain"], rec["batch"], rec["steps"],
                               run.device, start)
        run.check_detail.append({"batch": rec["batch"], "chain": rec["chain"],
                                 **_gaps(rec, ref, sizes)})
    numbers = {k: max(d[k] for d in run.check_detail) for k in WORST}
    # the stretch followed from the seed: its median leaf is steady from seed to seed
    numbers["start_median_grad_gap"] = run.check_detail[0]["median_grad_gap"]
    return numbers, work["units"]


def _leaf_shapes(cfg: dict) -> list:
    "Each leaf's shape, in the program's flat optimizer order."
    m = vae_steps.initial_weights(0, cfg["nsamples"], cfg["nhiddens"], cfg["nlatent"])
    shapes = {}
    for name, (w, b) in m.items():
        shapes[f"{name}.w"], shapes[f"{name}.b"] = w.shape, b.shape
    for stack in ("enc", "dec"):
        for i, h in enumerate(cfg["nhiddens"]):
            shapes[f"{stack}{i}.bn.scale"] = shapes[f"{stack}{i}.bn.bias"] = (h,)
    return [shapes[k] for k in vae_steps.leaves(cfg["nhiddens"])]
