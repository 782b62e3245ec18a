"""TaxVamb's semi-supervised bi-modal VAEVAE, as a PyTorch `nn.Module`.

Port of `vamb_tpu/models/vaevae.py` (reference vamb/semisupervised_encode.py:
700-1145 and vamb/taxvamb_encode.py:277-743). Three sub-VAEs share one
latent space:

* `vamb`: the feature VAE over [depths ‖ TNF ‖ total abundance];
* `labels`: a VAE over the one-hot labels (N_l = max(nlabels, 105) inputs),
  decoding to the hierarchical loss's logits (or N_l logits without one);
* `joint`: a VAE over [features ‖ labels] whose mu is decoded through both
  single-modality decoders; its loss pulls mu_joint toward the other two
  encoders' mus on the same rows with `kld_gauss` both ways.

Each step takes a supervised and an (independently permuted) unsupervised
batch and sums the three losses, with the reference's degenerate weighting
`mean(loss) * mean(weights)`. The optimizer is Adam at 1e-3 as optax writes
it (`optim.Adam`), not D-Adaptation.

Random streams follow `vamb_tpu`'s key chain (utils/threefry.py): the key
is `key(seed)`; an epoch takes `rng, key = split(rng)` and `k_sup, k_unsup,
scan_key, bank_key = split(key, 4)`, two permutations and one dropout bank;
step i takes `key, sub = split(key)` from `scan_key` and `keys = split(sub,
12)`, whose keys 1, 3, 6 and 10 draw the four eps (`normal`, bit for bit
jax's). The bank holds one slot of hidden widths for each of the nine
stack calls of a step, in call order `eddedeede` (e: encoder widths, d:
reversed). `vamb_tpu` declares `eddededde` (vaevae.py:310), so asymmetric
`-n` widths make its bank's slices mismatch the layers and it raises;
with symmetric widths the two orders slice the same bytes.

Data parallelism (`trainmodel(mesh=)`, `vamb_tpu`'s GSPMD over the global
batches): every rank draws the same permutations, bank and eps and
computes on its rows [r b / W, (r + 1) b / W) of both batches, inside
`layers.global_batch(mesh, b)`: BatchNorm takes the global batches'
statistics, and each loss's mean over rows is the rank's share of the
global batch's (`layers.batch_mean`). The weights' mean, which multiplies
the feature losses, is taken from the whole global batch, so each loss
stays linear in the rows' terms; the joint loss adds its batch-mean terms
(the label loss and the two `kld_gauss`) once, as partials of their own,
not to every row. Adam sums the flat gradient over the ranks in rank
order, the epoch's metrics are summed likewise, and the replicas are
checked after every epoch.

A layer called twice in a step keeps the running BatchNorm statistics of
its last call, each made from the step's starting statistics, as
`vamb_tpu` threads them. `encode_joint` returns the joint mu with the 12
low mantissa bits masked. `save`/`load` use `vaevae_model.npz`'s format.
"""

from pathlib import Path
from typing import IO, Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..optim import Adam
from ..parallel import replicate
from ..utils import mask_lower_bits, threefry
from ..utils.checkpoint import load_flat, params_from_jax, params_to_jax, save_flat
from . import hier, layers
from .dataset import VAEDataset, batchsize_at_epoch, encode_chunk_rows, num_batches
from .training import MetricsDrain, check_replicas, rows_of, segment_plan, validate_batchsteps

_ENCODE_CHUNK = 1 << 16
# encoder (e) or decoder (d) for each stack call of a step, in call order
_STACK_KINDS = "eddedeede"
_METRIC_NAMES = [
    "loss", "loss_vamb", "loss_labels", "loss_joint", "ce_vamb",
    "sse_vamb", "kld_vamb", "ce_labels", "kld_labels", "ce_labels_joint",
]


def kld_gauss(p_mu, p_logstd, q_mu, q_logstd):
    "Elementwise-mean KL(N(p) || N(q)) (semisupervised_encode.py:79-86)."
    loss = (
        q_logstd
        - p_logstd
        + (torch.exp(p_logstd) ** 2 + (p_mu - q_mu) ** 2) / (2 * torch.exp(q_logstd) ** 2)
        - 0.5
    )
    return layers.batch_mean(loss)


class _SubVAE(nn.Module):
    "One encoder/decoder pair in the VAE layout; weights drawn from `rng`."

    def __init__(self, rng, nin: int, nhiddens: list[int], nlatent: int, nout: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        dims_enc = [nin] + nhiddens
        dims_dec = [nlatent] + nhiddens[::-1]
        self.enc = nn.ModuleList(layers.Block(rng, i, o) for i, o in zip(dims_enc, dims_enc[1:]))
        self.mu = layers.Linear(rng, nhiddens[-1], nlatent)
        self.dec = nn.ModuleList(layers.Block(rng, i, o) for i, o in zip(dims_dec, dims_dec[1:]))
        self.out = layers.Linear(rng, nhiddens[0], nout)

    def _stack(self, blocks, x, bits, base):
        for i, block in enumerate(blocks):
            x = layers.leaky_relu(block.dense(x))
            if self.training and bits is not None:
                x = layers.dropout_from_bits(bits[i], x, self.dropout)
            x = block.bn(x, None if base is None else base[i])
        return x

    def encode(self, x, bits=None, base=None):
        return self.mu(self._stack(self.enc, x, bits, None if base is None else base["enc"]))

    def decode(self, z, bits=None, base=None):
        return self.out(self._stack(self.dec, z, bits, None if base is None else base["dec"]))


class VAEVAE(nn.Module):
    """The bi-modal semi-supervised composite (TaxVamb with `hier_loss`).

    `nodes`/`table_parent` are required for a hierarchical loss; with
    `hier_loss=None` the label loss is plain one-hot cross-entropy."""

    def __init__(
        self,
        nsamples: int,
        nlabels: int,
        nodes: Optional[list[str]] = None,
        table_parent: Optional[list[int]] = None,
        nhiddens: Optional[list[int]] = None,
        nlatent: int = 32,
        alpha: Optional[float] = None,
        beta: float = 200.0,
        dropout: Optional[float] = 0.2,
        hier_loss: Optional[str] = None,
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        if nsamples < 1:
            raise ValueError(f"nsamples must be > 0, not {nsamples}")
        if alpha is None:
            alpha = 0.15 if nsamples > 1 else 0.50
        if nhiddens is None:
            nhiddens = [512, 512] if nsamples > 1 else [256, 256]
        if dropout is None:
            dropout = 0.2 if nsamples > 1 else 0.0
        if beta <= 0:
            raise ValueError(f"beta must be > 0, not {beta}")
        if not (0 < alpha < 1):
            raise ValueError(f"alpha must be 0 < alpha < 1, not {alpha}")
        if not (0 <= dropout < 1):
            raise ValueError(f"dropout must be 0 <= dropout < 1, not {dropout}")

        self.nsamples = nsamples
        self.ntnf = 103
        self.n_input_labels = max(nlabels, 105)  # N_l (reference :733)
        self.n_tree_nodes = nlabels
        self.nhiddens = list(nhiddens)
        self.nlatent = nlatent
        self.alpha = alpha
        self.beta = beta
        self.dropout = dropout
        self.seed = seed
        self.hier_loss_name = hier_loss
        self.nodes = nodes
        self.table_parent = table_parent
        self.device = resolve_device(device)
        dev = self.device

        N_l = self.n_input_labels
        if hier_loss is not None:
            if nodes is None or table_parent is None:
                raise ValueError("hier_loss requires nodes and table_parent")
            self.tree = hier.Hierarchy(np.array(table_parent))
            if hier_loss == "flat_softmax":
                self._label_loss = hier.FlatSoftmaxNLL(self.tree, dev)
                label_logits = self.tree.num_leaf_nodes()
            elif hier_loss == "cond_softmax":
                self._label_loss = hier.HierSoftmaxCrossEntropy(self.tree, dev)
                label_logits = self.tree.num_nodes() - 1
            elif hier_loss == "soft_margin":
                self._label_loss = hier.MarginLoss(
                    self.tree, hardness="soft", margin="incorrect", tau=0.01, device=dev
                )
                label_logits = self.tree.num_nodes()
            else:
                raise AttributeError(f"Hierarchical loss {hier_loss} not found")
        else:
            self.tree = None
            self._label_loss = None
            label_logits = N_l

        rng = np.random.default_rng(seed)
        nfeat = nsamples + self.ntnf + 1
        h, d = self.nhiddens, self.dropout
        self.vamb = _SubVAE(rng, nfeat, h, nlatent, nfeat, d)
        self.labels = _SubVAE(rng, N_l, h, nlatent, label_logits, d)
        self.joint = _SubVAE(rng, nfeat + N_l, h, nlatent, nfeat + label_logits, d)
        self.rng = threefry.key(seed)
        self.to(dev)

    # -------------------------------------------------------------- losses

    def _label_ce(self, logits, onehot):
        "Mean label loss: the hierarchical loss, or one-hot cross-entropy."
        if self._label_loss is not None:
            return self._label_loss(logits, onehot[:, : self.n_tree_nodes])
        idx = torch.argmax(onehot, dim=1)
        logp = torch.log_softmax(logits, dim=-1)
        return layers.batch_mean(-torch.gather(logp, -1, idx[:, None]))

    def _split_features(self, rec):
        S, T = self.nsamples, self.ntnf
        return rec[:, :S], rec[:, S : S + T], rec[:, S + T : S + T + 1], rec[:, S + T + 1 :]

    def _weights(self):
        if self.nsamples == 1:
            ce_weight = 0.0
        else:
            ce_weight = ((1 - self.alpha) * (self.nsamples - 1)) / (
                self.nsamples * np.log(self.nsamples)
            )
        ab_w = (1 - self.alpha) / self.nsamples
        sse_w = self.alpha / self.ntnf
        kld_w = 1 / (self.nlatent * self.beta)
        return ce_weight, ab_w, sse_w, kld_w

    def _vamb_loss(self, depths_in, d_out, tnf_in, t_out, ab_in, a_out, mu, weights):
        "The feature VAE's loss (encode.py:316-357 semantics)."
        ab_sse = torch.sum(torch.square(a_out - ab_in), dim=1)
        ce = -torch.sum(torch.log(d_out + 1e-9) * depths_in, dim=1)
        sse = torch.sum(torch.square(t_out - tnf_in), dim=1)
        kld = 0.5 * torch.sum(torch.square(mu), dim=1)
        ce_w, ab_w, sse_w, kld_w = self._weights()
        # (B,) loss x (B, 1) weights broadcasts to (B, B) in the reference
        # (semisupervised_encode.py:558): its mean is mean(loss) * mean(weights)
        loss = layers.batch_mean(ce * ce_w + ab_sse * ab_w + sse * sse_w + kld * kld_w) * torch.mean(
            weights[:, 0]
        )
        return loss, layers.batch_mean(ce), layers.batch_mean(sse), layers.batch_mean(kld)

    def calc_loss_labels(self, logits, onehot, mu):
        """Labels-only sub-VAE loss (semisupervised_encode.py:248-257): the
        label loss plus the mu-only KLD."""
        ce_lab = self._label_ce(logits, onehot)
        kld_lab = 0.5 * layers.batch_mean(torch.sum(torch.square(mu), dim=1))
        kld_w = 1 / (self.nlatent * self.beta)
        return ce_lab + kld_lab * kld_w, ce_lab, kld_lab

    def calc_loss_joint(
        self, depths_in, d_out, tnf_in, t_out, ab_in, a_out, labels_logits,
        labels_onehot, mu_sup, mu_vamb_unsup, mu_labels_unsup, weights,
    ):
        """Joint sub-VAE loss (semisupervised_encode.py:762-827): the 3-term
        feature reconstruction, the label loss and the symmetric kld_gauss
        pair against the two single-modality posteriors (logsigmas zero)."""
        ab_sse_j = torch.sum(torch.square(a_out - ab_in), dim=1)
        ce_j = -torch.sum(torch.log(d_out + 1e-9) * depths_in, dim=1)
        sse_j = torch.sum(torch.square(t_out - tnf_in), dim=1)
        ce_w, ab_w, sse_w, kld_w = self._weights()
        ce_labels_j = self._label_ce(labels_logits, labels_onehot)
        zeros = torch.zeros_like(mu_sup)
        kld_vamb_j = kld_gauss(mu_sup, zeros, mu_vamb_unsup, zeros)
        kld_lab_j = kld_gauss(mu_sup, zeros, mu_labels_unsup, zeros)
        if layers.batch_rows() is None:
            rec_j = ce_j * ce_w + ab_sse_j * ab_w + sse_j * sse_w + ce_labels_j
            loss = torch.mean(rec_j + (kld_vamb_j + kld_lab_j) * kld_w) * torch.mean(weights[:, 0])
        else:  # a rank's share: the batch-mean terms once, as partials of their own
            rec_j = layers.batch_mean(ce_j * ce_w + ab_sse_j * ab_w + sse_j * sse_w)
            loss = (rec_j + ce_labels_j + (kld_vamb_j + kld_lab_j) * kld_w) * torch.mean(weights[:, 0])
        return (loss, layers.batch_mean(ce_j), layers.batch_mean(sse_j), ce_labels_j, kld_vamb_j,
                kld_lab_j)

    # ------------------------------------------------------------- training

    def _bank_widths(self) -> list[int]:
        widths: list[int] = []
        for kind in _STACK_KINDS:
            widths += self.nhiddens if kind == "e" else self.nhiddens[::-1]
        return widths

    def _draw_dropout_bank(self, key, batchsize: int):
        "One epoch's dropout bytes for every stack call and layer."
        if self.dropout == 0.0:
            return None
        return layers.dropout_bank(key, batchsize, self._bank_widths(), self.device)

    def _bn_base(self) -> dict:
        "The step's starting running statistics, per sub-VAE, stack and layer."
        bns = [b.bn for sub in (self.vamb, self.labels, self.joint) for b in (*sub.enc, *sub.dec)]
        copies = torch._foreach_mul([t for bn in bns for t in (bn.mean, bn.var)], 1.0)
        pairs = iter(zip(copies[0::2], copies[1::2]))
        return {
            name: {stack: [next(pairs) for _ in getattr(sub, stack)] for stack in ("enc", "dec")}
            for name, sub in (("vamb", self.vamb), ("labels", self.labels), ("joint", self.joint))
        }

    def step_losses(self, sup, unsup, eps, bits=None, base=None):
        """All three losses of one (supervised, unsupervised) batch pair, in
        `vamb_tpu`'s call order (semisupervised_encode.py:829-1008).

        `sup`/`unsup` are (depths, tnf, ab, weights, onehot) tuples, `eps`
        four (B, nlatent) draws, `bits` the step's 9 * len(nhiddens) byte
        slices (or None), `base` the step's starting BatchNorm statistics
        (`_bn_base`). Returns (total loss, metrics (10,))."""
        d_s, t_s, a_s, w_s, y_s = sup
        d_u, t_u, a_u, w_u, y_u = unsup
        L = len(self.nhiddens)

        def slot(j):
            return None if bits is None else bits[L * j : L * (j + 1)]

        def b(name):
            return None if base is None else base[name]

        mu_sup = self.joint.encode(torch.cat((d_s, t_s, a_s, y_s), dim=1), slot(0), b("joint"))
        rec_vamb_sup = self.vamb.decode(mu_sup + eps[0], slot(1), b("vamb"))
        d_os, t_os, a_os, _ = self._split_features(rec_vamb_sup)
        d_os = torch.softmax(d_os, dim=1)
        y_logits_sup = self.labels.decode(mu_sup + eps[1], slot(2), b("labels"))

        mu_vamb_u = self.vamb.encode(torch.cat((d_u, t_u, a_u), dim=1), slot(3), b("vamb"))
        rec_vamb_u = self.vamb.decode(mu_vamb_u + eps[2], slot(4), b("vamb"))
        d_ou, t_ou, a_ou, _ = self._split_features(rec_vamb_u)
        d_ou = torch.softmax(d_ou, dim=1)
        mu_vamb_s = self.vamb.encode(torch.cat((d_s, t_s, a_s), dim=1), slot(5), b("vamb"))

        mu_lab_u = self.labels.encode(y_u, slot(6), b("labels"))
        y_logits_u = self.labels.decode(mu_lab_u + eps[3], slot(7), b("labels"))
        mu_lab_s = self.labels.encode(y_s, slot(8), b("labels"))

        loss_vamb, ce_vamb, sse_vamb, kld_vamb = self._vamb_loss(
            d_u, d_ou, t_u, t_ou, a_u, a_ou, mu_vamb_u, w_u
        )
        loss_labels, ce_lab, kld_lab = self.calc_loss_labels(y_logits_u, y_u, mu_lab_u)
        loss_joint, _, _, ce_labels_j, _, _ = self.calc_loss_joint(
            d_s, d_os, t_s, t_os, a_s, a_os, y_logits_sup, y_s,
            mu_sup, mu_vamb_s, mu_lab_s, w_s,
        )
        total = loss_joint + loss_vamb + loss_labels
        metrics = torch.stack(
            [total, loss_vamb, loss_labels, loss_joint, ce_vamb, sse_vamb,
             kld_vamb, ce_lab, kld_lab, ce_labels_j]
        ).detach()
        return total, metrics

    def epoch_draws(self, rng, n: int, batchsize: int, nbatches: int):
        """One epoch's random draws from the key chain `rng`, as `vamb_tpu`'s
        `one_epoch` makes them (vaevae.py:505-511, :535-545). Returns (next
        rng, supervised and unsupervised permutations (nb * bs,), bank or
        None, eps (nb, 4, B, nlatent))."""
        rng, key = threefry.split_host(rng)
        k_sup, k_unsup, scan_key, bank_key = threefry.split_host(key, 4)
        bank = self._draw_dropout_bank(bank_key, batchsize)
        perm_sup = threefry.permutation(k_sup, n, self.device)[: nbatches * batchsize]
        perm_uns = threefry.permutation(k_unsup, n, self.device)[: nbatches * batchsize]
        eps_keys = []
        for _ in range(nbatches):
            scan_key, sub = threefry.split_host(scan_key)
            keys = threefry.split_host(sub, 12)
            eps_keys += [keys[1], keys[3], keys[6], keys[10]]
        eps = threefry.normal_batched(eps_keys, batchsize * self.nlatent, self.device)
        eps = eps.reshape(nbatches, 4, batchsize, self.nlatent)
        return torch.tensor(rng), perm_sup, perm_uns, bank, eps

    def trainmodel(
        self,
        dataset: VAEDataset,
        targets: np.ndarray,
        nepochs: int = 500,
        batchsize: int = 256,
        batchsteps: Optional[list[int]] = [25, 75, 150, 300],
        modelfile: Union[None, str, Path, IO[bytes]] = None,
        logger: Optional[Callable[[str], None]] = None,
        mesh=None,
    ) -> None:
        """Train in place on (dataset, integer node targets); with `mesh` (a
        `parallel.Mesh` whose device is this model's), data-parallel over
        its ranks (see the module notes)."""
        if nepochs < 1:
            raise ValueError(f"Minimum 1 epoch, not {nepochs}")
        if dataset.n_obs < 2:
            raise ValueError("Cannot train on fewer than 2 sequences")
        batchsteps_list = validate_batchsteps(nepochs, batchsteps)
        log = logger if logger is not None else lambda _m: None
        log("\tNetwork properties:")
        log(f"\t    Alpha: {self.alpha}")
        log(f"\t    Beta: {self.beta}")
        log(f"\t    Dropout: {self.dropout}")
        log(f"\t    N hidden: {', '.join(map(str, self.nhiddens))}")
        log(f"\t    N latent: {self.nlatent}")
        log("\tTraining properties:")
        log(f"\t    N epochs: {nepochs}")
        log(f"\t    Starting batch size: {batchsize}")
        log(
            "\t    Batchsteps: "
            + (", ".join(map(str, batchsteps_list)) if batchsteps_list else "None")
        )
        log(f"\t    N sequences: {dataset.n_obs}")
        log(f"\t    N samples: {dataset.nsamples}")

        dev = self.device
        n = dataset.n_obs
        S, T, N_l = self.nsamples, self.ntnf, self.n_input_labels
        packed = torch.as_tensor(np.concatenate(dataset, axis=1), device=dev)
        labels = torch.as_tensor(np.asarray(targets, dtype=np.int64), device=dev)
        if mesh is not None:
            replicate(self, mesh)  # rank 0's weights on every rank, as vamb_tpu's replicate
        params = list(self.parameters())
        optimizer = Adam(params, lr=1e-3, eps=1e-8,
                         grad_reduce=None if mesh is None else lambda g: mesh.sum_ranks(g, "gradients"))

        def gather(rows, onehot, lo, hi):
            """This rank's rows [lo, hi) of a global batch, with the whole
            batch's weights column: the losses read only its mean."""
            part = rows[lo:hi]
            return (part[:, :S], part[:, S : S + T], part[:, S + T : S + T + 1],
                    rows[:, S + T + 1 :], onehot[lo:hi])

        def emit(epoch, m, bs, seconds):
            log(
                f"\t\tEpoch: {epoch + 1}  "
                + "  ".join(f"{k}: {v:.5e}" for k, v in zip(_METRIC_NAMES, m))
                + f"  Batchsize: {bs}  ({seconds:.2f}s)"
            )

        drain = MetricsDrain(emit)
        self.train()
        for epoch0, seg_len in segment_plan(nepochs, batchsteps_list):
            bs = min(batchsize_at_epoch(batchsize, batchsteps_list, epoch0), n)
            nb = num_batches(n, bs)
            lo, hi = (0, bs) if mesh is None else mesh.block(bs)  # this rank's rows of a batch
            for epoch in range(epoch0, epoch0 + seg_len):
                self.rng, perm_sup, perm_uns, bank, eps = self.epoch_draws(self.rng, n, bs, nb)
                bank = rows_of(bank, lo, hi)
                shuf = {}
                for name, perm in (("sup", perm_sup), ("uns", perm_uns)):
                    onehot = nn.functional.one_hot(labels[perm], N_l).float()
                    shuf[name] = (packed[perm].reshape(nb, bs, -1), onehot.reshape(nb, bs, N_l))
                total = None
                with layers.global_batch(mesh, bs):
                    for i in range(nb):
                        sup = gather(shuf["sup"][0][i], shuf["sup"][1][i], lo, hi)
                        uns = gather(shuf["uns"][0][i], shuf["uns"][1][i], lo, hi)
                        loss, metrics = self.step_losses(
                            sup, uns, eps[i][:, lo:hi], layers.step_bank(bank, i), self._bn_base()
                        )
                        optimizer.zero_grad()
                        loss.backward()
                        optimizer.step()
                        total = metrics if total is None else total + metrics
                if mesh is not None:
                    total = mesh.sum_ranks(total, "metrics")
                drain.push(epoch, total / nb, bs)
                if mesh is not None:
                    check_replicas([*params, *self.buffers()], mesh, log)
        drain.flush()
        self.eval()
        if modelfile is not None:
            self.save(modelfile)

    # ------------------------------------------------------------- encode

    @torch.no_grad()
    def encode_joint(self, dataset: VAEDataset, targets: np.ndarray) -> np.ndarray:
        "The joint encoder's mu for every row (eval mode), 12 mantissa bits masked."
        self.eval()
        n = dataset.n_obs
        latent = np.empty((n, self.nlatent), dtype=np.float32)
        chunk = encode_chunk_rows(n, _ENCODE_CHUNK)
        targets = np.asarray(targets, dtype=np.int64)
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            d, t, a = (
                torch.as_tensor(arr[start:stop], device=self.device)
                for arr in (dataset.depths, dataset.tnf, dataset.abundance)
            )
            y = torch.as_tensor(targets[start:stop], device=self.device)
            onehot = nn.functional.one_hot(y, self.n_input_labels).float()
            mu = self.joint.encode(torch.cat((d, t, a, onehot), dim=1))
            latent[start:stop] = mu.cpu().numpy()
        mask_lower_bits(latent, 12)
        return latent

    # ------------------------------------------------------------ save/load

    def meta(self) -> dict:
        return {
            "model": "vaevae",
            "nsamples": self.nsamples,
            "nlabels": self.n_tree_nodes,
            "nhiddens": self.nhiddens,
            "nlatent": self.nlatent,
            "alpha": self.alpha,
            "beta": self.beta,
            "dropout": self.dropout,
            "hier_loss": self.hier_loss_name,
            "nodes": self.nodes,
            "table_parent": self.table_parent,
            "seed": self.seed,
        }

    def save(self, io: Union[str, Path, IO[bytes]]) -> None:
        "Write `vaevae_model.npz` in vamb_tpu's format."
        save_flat(io, params_to_jax(self.state_dict()), self.meta())

    @classmethod
    def load(cls, io: Union[str, Path, IO[bytes]], device="cuda") -> "VAEVAE":
        "Read a `vaevae_model.npz` written by either package."
        flat, meta = load_flat(io)
        model = cls(
            nsamples=meta["nsamples"],
            nlabels=meta["nlabels"],
            nodes=meta["nodes"],
            table_parent=meta["table_parent"],
            nhiddens=meta["nhiddens"],
            nlatent=meta["nlatent"],
            alpha=meta["alpha"],
            beta=meta["beta"],
            dropout=meta["dropout"],
            hier_loss=meta["hier_loss"],
            seed=meta.get("seed", 0),
            device=device,
        )
        model.load_state_dict(params_from_jax(flat))
        model.eval()
        return model
