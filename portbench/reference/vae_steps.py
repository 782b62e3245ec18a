"""Plain float64 reference of Vamb's VAE training: the dataset's
normalization, the weights' initial draw, the first steps' batches, dropout
masks and latent noise, the forward pass, the loss, its gradients and the
D-Adaptation Adam update, written from the published model (Nissen et al.,
Nat Biotechnol 2021; vamb/encode.py) and D-Adaptation (Defazio and
Mishchenko, ICML 2023, with `decouple=True` and no bias correction), with
the random streams of JAX's threefry (`threefry.py` beside this file).

It imports nothing of the program. Given the raw arrays and the settings
the program was given, it works out everything the program derived.
"""

import math

import numpy as np
import torch

from . import threefry as tf

NTNF = 103


def dataset(ab: np.ndarray, tnf: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The normalized rows [depths | tnf | log abundance | weight] (float64):
    depths scaled so each sample sums to 1e6, then each row to 1; the
    total's log, clipped at 1e-3, z-scored; TNF columns z-scored (population
    std); weights max(ln(length) - 5, 2) scaled to mean 1."""
    ab = ab.astype(np.float64)
    ab = ab * (1e6 / ab.sum(axis=0))
    total = ab.sum(axis=1)
    zero = total == 0
    ab[zero] = 1.0 / ab.shape[1]
    depths = ab / np.where(zero, 1.0, total)[:, None]
    lt = np.log(np.clip(total, 1e-3, None))
    lt = (lt - lt.mean()) / (lt.std() or 1.0)
    t = tnf.astype(np.float64)
    sd = t.std(axis=0)
    t = (t - t.mean(axis=0)) / np.where(sd == 0, 1.0, sd)
    w = np.maximum(np.log(lengths.astype(np.float64)) - 5.0, 2.0)
    w = w * (len(w) / w.sum())
    return np.concatenate([depths, t, lt[:, None], w[:, None]], axis=1)


def initial_weights(seed: int, nsamples: int, hidden: list, latent: int) -> dict:
    """Each Linear's (w (nin, nout), b) drawn from numpy's default_rng(seed)
    as U(+-1/sqrt(nin)) in float32, in the order encoder blocks, mu head,
    decoder blocks, output head (torch's default init of the reference)."""
    rng = np.random.default_rng(seed)
    nf = nsamples + NTNF + 1

    def linear(nin, nout):
        bound = 1.0 / np.sqrt(nin)
        w = rng.uniform(-bound, bound, (nin, nout)).astype(np.float32)
        b = rng.uniform(-bound, bound, (nout,)).astype(np.float32)
        return w, b

    enc_dims = [nf] + hidden
    dec_dims = [latent] + hidden[::-1]
    out = {}
    for i, (a, b) in enumerate(zip(enc_dims, enc_dims[1:])):
        out[f"enc{i}"] = linear(a, b)
    out["mu"] = linear(hidden[-1], latent)
    for i, (a, b) in enumerate(zip(dec_dims, dec_dims[1:])):
        out[f"dec{i}"] = linear(a, b)
    out["out"] = linear(hidden[0], nf)
    return out


def leaves(hidden: list) -> list[str]:
    """The parameter leaves, each a name, in the program's flat optimizer
    order: its parameter tree's keys sorted (dec before enc, then bias,
    scale, dense bias, dense weight a block; mu and out last)."""
    out = []
    for stack in ("dec", "enc"):
        for i in range(len(hidden)):
            out += [f"{stack}{i}.bn.bias", f"{stack}{i}.bn.scale", f"{stack}{i}.b", f"{stack}{i}.w"]
    return out + ["mu.b", "mu.w", "out.b", "out.w"]


class Model:
    "The VAE's parameters as float64 leaves, named as `leaves` names them."

    def __init__(self, cfg: dict, seed: int, device, flat=None):
        """The weights drawn from `seed`, or, where `flat` is given, those
        values (every leaf in `leaves` order, flattened and concatenated)."""
        self.cfg = cfg
        hidden = cfg["nhiddens"]
        init = initial_weights(seed, cfg["nsamples"], hidden, cfg["nlatent"])
        p = {}
        for name, (w, b) in init.items():
            p[f"{name}.w"], p[f"{name}.b"] = w, b
        for stack in ("enc", "dec"):
            for i, h in enumerate(hidden):
                p[f"{stack}{i}.bn.scale"] = np.ones(h, np.float32)
                p[f"{stack}{i}.bn.bias"] = np.zeros(h, np.float32)
        self.names = leaves(hidden)
        if flat is not None:
            parts = np.split(np.asarray(flat, np.float64), np.cumsum([p[k].size for k in self.names])[:-1])
            p = {k: v.reshape(p[k].shape) for k, v in zip(self.names, parts)}
        self.p = {k: torch.tensor(p[k], dtype=torch.float64, device=device, requires_grad=True)
                  for k in self.names}

    def loss(self, rows: torch.Tensor, eps: torch.Tensor, masks: list) -> torch.Tensor:
        """The batch's loss: encoder, mu head, decoder on mu + eps, output
        head; CE of the depths' softmax, SSE of TNF and of the abundance,
        the KLD of mu, weighted as Vamb weighs them, and the mean over the
        batch times the mean weight (the reference's broadcast)."""
        c, p = self.cfg, self.p
        s, k = c["nsamples"], len(c["nhiddens"])
        x = rows[:, : s + NTNF + 1]
        h = x
        for i in range(k):
            h = self._block(f"enc{i}", h, masks[i])
        mu = h @ p["mu.w"] + p["mu.b"]
        h = mu + eps
        for i in range(k):
            h = self._block(f"dec{i}", h, masks[k + i])
        rec = h @ p["out.w"] + p["out.b"]
        d_out = torch.softmax(rec[:, :s], dim=1)
        t_out, a_out = rec[:, s: s + NTNF], rec[:, s + NTNF:]
        d_in, t_in, a_in = x[:, :s], x[:, s: s + NTNF], x[:, s + NTNF:]
        alpha, beta = c["alpha"], c["beta"]
        ce_w = (1 - alpha) * (s - 1) / (s * math.log(s)) if s > 1 else 0.0
        terms = ((a_out - a_in).square().sum(1) * ((1 - alpha) / s)
                 - (torch.log(d_out + 1e-9) * d_in).sum(1) * ce_w
                 + (t_out - t_in).square().sum(1) * (alpha / NTNF)
                 + 0.5 * mu.square().sum(1) / (c["nlatent"] * beta))
        return terms.mean() * rows[:, -1].mean()

    def _block(self, name, x, mask):
        p = self.p
        h = x @ p[f"{name}.w"] + p[f"{name}.b"]
        h = torch.where(h >= 0, h, 0.01 * h)
        h = h * mask
        mean = h.mean(0)
        var = (h * h).mean(0) - mean * mean
        return (h - mean) / torch.sqrt(var + 1e-5) * p[f"{name}.bn.scale"] + p[f"{name}.bn.bias"]


class DAdaptAdam:
    """D-Adaptation Adam, decoupled, lr 1, betas (0.9, 0.999), eps 1e-8,
    d0 1e-6, no weight decay, no growth limit, no bias correction; the
    global sums over all leaves."""

    def __init__(self, params: list, state=None):
        """A fresh optimizer, or one that starts from `state` (flat "m",
        "v", "s" and the scalars "d" and "num")."""
        self.params = params
        n = sum(p.numel() for p in params)
        dev = params[0].device
        self.m, self.v, self.s = (torch.zeros(n, dtype=torch.float64, device=dev) for _ in range(3))
        self.d, self.num = 1e-6, 0.0
        if state is not None:
            self.m, self.v, self.s = (torch.as_tensor(np.asarray(state[k], np.float64), device=dev)
                                      for k in ("m", "v", "s"))
            self.d, self.num = float(state["d"]), float(state["num"])

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        "One update; returns the flat gradient it took."
        b1, b2 = 0.9, 0.999
        r = math.sqrt(b2)
        g = torch.cat([p.grad.reshape(-1) for p in self.params])
        dlr = self.d
        self.num = r * self.num + (1 - r) * dlr * float((g * (self.s / (self.v.sqrt() + 1e-8))).sum())
        self.m = b1 * self.m + (1 - b1) * dlr * g
        self.v = b2 * self.v + (1 - b2) * g * g
        self.s = r * self.s + (1 - r) * dlr * g
        l1 = float(self.s.abs().sum())
        if l1 > 0:
            self.d = max(self.d, self.num / ((1 - r) * l1))
        flat = -self.m / (self.v.sqrt() + 1e-8)
        i = 0
        for p in self.params:
            p.add_(flat[i: i + p.numel()].view_as(p))
            i += p.numel()
        return g


def epoch_draws(seed: int, chain: int, n: int, batch: int, steps: int, widths: list, nlatent: int):
    """The draws of the epoch that the model seeded `seed` trains after
    `chain` earlier epochs (each takes the next key of its chain), over `n`
    rows: the row permutation, each of the first `steps` steps' dropout
    bytes per layer (the epoch's bank rotated by 97 a step) and its latent
    noise."""
    rng = tf.key(seed)
    for _ in range(chain):
        rng = tf.split(rng)[0]
    rng, k = tf.split(rng)
    perm_key, scan_key, bank_key = tf.split(k, 3)
    perm = tf.permutation(perm_key, n)
    nwords = (sum(widths) + 3) // 4
    bank = tf.bytes_of(tf.bits(bank_key, batch * nwords).reshape(batch, nwords))[:, : sum(widths)]
    out = []
    for i in range(steps):
        scan_key, sub = tf.split(scan_key)
        eps = tf.normal(tf.split(sub, 3)[0], batch * nlatent).reshape(batch, nlatent)
        rot = ((bank.astype(np.int64) + (i * 97) % 256) % 256).astype(np.uint8)
        out.append((np.split(rot, np.cumsum(widths)[:-1], axis=1), eps))
    return perm, out


def follow(cfg: dict, seed: int, rows: np.ndarray, chain: int, batch: int, steps: int, device,
           start=None) -> dict:
    """`steps` training steps at batch size `batch` of the model seeded
    `seed`, in the epoch after `chain` earlier ones, on the normalized rows
    `rows` (`dataset`): from the weights drawn from the seed and a fresh
    optimizer where `start` is None, else from `start`'s flat "params" and
    optimizer state. Returns each step's loss, the first step's gradient
    and the parameters' change over the steps, by leaf (float64 numpy),
    and the leaves' names."""
    hidden = cfg["nhiddens"]
    widths = hidden + hidden[::-1]
    perm, draws = epoch_draws(seed, chain, len(rows), batch, steps, widths, cfg["nlatent"])
    t = min(255, round(cfg["dropout"] * 256))
    keep = 1.0 / (1.0 - t / 256.0)
    model = Model(cfg, seed, device, flat=None if start is None else start["params"])
    params = [model.p[k] for k in model.names]
    begin = [p.detach().clone() for p in params]
    opt = DAdaptAdam(params, state=start)
    losses, grad0 = [], None
    for i, (layer_bytes, eps) in enumerate(draws):
        batch_rows = torch.as_tensor(rows[perm[i * batch: (i + 1) * batch]], device=device)
        masks = [torch.as_tensor(np.where(b >= t, keep, 0.0), device=device) for b in layer_bytes]
        loss = model.loss(batch_rows, torch.as_tensor(eps, device=device), masks)
        for p in params:
            p.grad = None
        loss.backward()
        g = opt.step()
        losses.append(loss.item())
        if grad0 is None:
            grad0 = g
    sizes = [p.numel() for p in params]
    change = torch.cat([(p.detach() - s).reshape(-1) for p, s in zip(params, begin)])
    split = lambda flat: [x.cpu().numpy() for x in torch.split(flat, sizes)]  # noqa: E731
    return {"names": model.names, "loss": losses, "grad": split(grad0), "change": split(change)}
