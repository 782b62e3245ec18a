"""The VAE over [depths ‖ TNF ‖ abundance] as a PyTorch `nn.Module`.

Behavioral spec: `vamb_tpu/models/vae.py` (reference vamb/encode.py:149-610):

* architecture: Linear -> LeakyReLU -> Dropout -> BatchNorm encoder and
  decoder stacks, a single `mu` head (the latent noise is a fixed N(0, 1),
  encode.py:270-286), softmax over the per-sample depths of the output;
* loss: weighted CE(depths) + SSE(ab) + SSE(TNF) + KLD with the weights of
  encode.py:316-357, including the reference's degenerate length weighting
  `mean(loss) * mean(weights)` (vamb_tpu vae.py:290-296);
* defaults: nlatent 32, alpha 0.15 (0.50 single-sample), nhiddens
  [512, 512] ([256, 256] single-sample), beta 200, dropout 0.2 (0.0
  single-sample);
* training: D-Adaptation Adam, batch-size doubling at batchsteps, drop-last
  shuffled batches, and one dropout byte bank per epoch rotated by `i*97`
  per step (vamb_tpu vae.py:414-475);
* random streams: jax's threefry (utils/threefry.py) at the points of
  `vamb_tpu`'s key chain. The model key is `key(seed)`; each epoch takes
  `rng, key = split(rng)` and `perm_key, scan_key, bank_key =
  split(key, 3)`; the permutation is `permutation(perm_key, n)`, the bank
  `bits(bank_key, (B, (sum(widths) + 3) // 4))` read as little-endian
  bytes; step i takes `key, sub = split(key)` from `scan_key` and its eps
  is `normal(split(sub, 3)[0], (B, nlatent))`. So the port trains on the
  same batches and dropout masks as `vamb_tpu`, and its eps differs only
  by the few ulps of `log1p` inside erfinv. The step keys are split on the
  host and the whole epoch's eps is drawn in one call;
* precision: "f32", or "bf16" (vae.py:94-108, 226-262): training passes
  run the encoder and decoder stacks' dense layers in bf16 (x, w and b
  cast, the product and sum in bf16, the float32 master parameters
  updated), LeakyReLU and the byte dropout in bf16, BatchNorm's statistics
  and affine in float32 cast back to bf16, the `mu` head, the output head
  and the loss in float32; `encode` runs at float32 whatever the precision;
* data parallelism (`trainmodel(mesh=)`, vae.py:307-331 and :485-560):
  every rank draws the same global streams (permutation, dropout bank,
  eps) and computes on its rows [r b / W, (r + 1) b / W) of each global
  batch of b rows; BatchNorm takes the global batch's statistics
  (`layers.global_batch`), a rank's loss is its rows' terms over the global
  b (`layers.batch_mean`), and the flat gradient is summed over the ranks in rank order before
  D-Adaptation's update, so the replicated parameters stay bit-identical on
  every rank (checked after each epoch). Batch doubling and logging are
  unchanged; the epoch's metrics are summed over the ranks the same way.
  `encode` stays unsharded on every rank, as in `vamb_tpu`;
* `encode` returns `mu` with the 12 low mantissa bits masked (vae.py:684);
* `save`/`load` use `vamb_tpu`'s `model.npz` flat-key format, precision
  included.
"""

import time
from pathlib import Path
from typing import IO, Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..optim import DAdaptAdam
from ..parallel import replicate
from ..utils import mask_lower_bits, threefry
from ..utils.checkpoint import load_flat, params_from_jax, params_to_jax, save_flat
from . import layers
from .dataset import VAEDataset, batchsize_at_epoch, num_batches
from .training import check_replicas, rows_of, validate_batchsteps

_ENCODE_CHUNK = 1 << 16  # rows per encode forward


class VAE(nn.Module):
    """Variational autoencoder with fixed-sigma latent noise.

    Weights are drawn on the host from `np.random.default_rng(seed)` in
    `vamb_tpu`'s order, so both packages start from the same weights."""

    def __init__(
        self,
        nsamples: int,
        nhiddens: Optional[list[int]] = None,
        nlatent: int = 32,
        alpha: Optional[float] = None,
        beta: float = 200.0,
        dropout: Optional[float] = 0.2,
        seed: int = 0,
        device="cuda",
        precision: str = "f32",
    ):
        super().__init__()
        if nlatent < 1:
            raise ValueError(f"Minimum 1 latent neuron, not {nlatent}")
        if nsamples < 1:
            raise ValueError(f"nsamples must be > 0, not {nsamples}")
        if alpha is None:
            alpha = 0.15 if nsamples > 1 else 0.50
        if nhiddens is None:
            nhiddens = [512, 512] if nsamples > 1 else [256, 256]
        if dropout is None:
            dropout = 0.2 if nsamples > 1 else 0.0
        if any(i < 1 for i in nhiddens):
            raise ValueError(f"Minimum 1 neuron per layer, not {min(nhiddens)}")
        if beta <= 0:
            raise ValueError(f"beta must be > 0, not {beta}")
        if not (0 < alpha < 1):
            raise ValueError(f"alpha must be 0 < alpha < 1, not {alpha}")
        if not (0 <= dropout < 1):
            raise ValueError(f"dropout must be 0 <= dropout < 1, not {dropout}")
        if precision not in ("f32", "bf16"):
            raise ValueError(f"precision must be 'f32' or 'bf16', not {precision}")

        self.nsamples = nsamples
        self.ntnf = 103
        self.nhiddens = list(nhiddens)
        self.nlatent = nlatent
        self.alpha = alpha
        self.beta = beta
        self.dropout = dropout
        self.seed = seed
        # the training passes' compute type; `encode` is float32 whatever it
        # is, as vamb_tpu's (vae.py:193, :232)
        self.precision = precision
        self._compute_dtype = torch.bfloat16 if precision == "bf16" else None
        self.device = resolve_device(device)
        self.rng = threefry.key(seed)  # the training key chain, as vamb_tpu's

        rng = np.random.default_rng(seed)
        dims_enc = [self.nfeatures] + self.nhiddens
        dims_dec = [nlatent] + self.nhiddens[::-1]
        self.enc = nn.ModuleList(layers.Block(rng, i, o) for i, o in zip(dims_enc, dims_enc[1:]))
        self.mu = layers.Linear(rng, self.nhiddens[-1], nlatent)
        self.dec = nn.ModuleList(layers.Block(rng, i, o) for i, o in zip(dims_dec, dims_dec[1:]))
        self.out = layers.Linear(rng, self.nhiddens[0], self.nfeatures)
        self.to(self.device)

    @property
    def nfeatures(self) -> int:
        return self.nsamples + self.ntnf + 1

    def parameters_flat_order(self) -> list[nn.Parameter]:
        """Parameters in the leaf order of `vamb_tpu`'s params tree (dict
        keys sorted), which is the layout of its flat optimizer state."""
        out = []
        for stack in (self.dec, self.enc):
            for block in stack:
                out += [block.bn.bias, block.bn.scale, block.dense.b, block.dense.w]
        return out + [self.mu.b, self.mu.w, self.out.b, self.out.w]

    # ------------------------------------------------------------- forward

    def _stack(self, blocks, x, masks, bits):
        dtype = self._compute_dtype if self.training else None
        for i, block in enumerate(blocks):
            x = layers.leaky_relu(block.dense(x, dtype))
            if self.training:
                if masks is not None:
                    x = x * masks[i]
                elif bits is not None:
                    x = layers.dropout_from_bits(bits[i], x, self.dropout)
            x = block.bn(x)
        return x

    def forward(
        self,
        depths: torch.Tensor,
        tnf: torch.Tensor,
        abundance: torch.Tensor,
        *,
        eps: Optional[torch.Tensor] = None,
        inject: Optional[dict] = None,
        dropout_bank: Optional[dict] = None,
    ):
        """Full forward pass; returns (depths_out, tnf_out, abundance_out, mu).

        In training mode the decoder sees `mu + eps`: `eps` (B, nlatent)
        and the dropout bytes `dropout_bank` ({"enc"/"dec": list of (B,
        width) uint8 per layer}) are drawn by the caller, as `trainmodel`
        draws them from the epoch's key chain (`epoch_draws`, `step_bank`).
        `inject` replaces both with caller-supplied tensors: {"eps": (B,
        nlatent), "enc_masks"/"dec_masks": per-layer pre-scaled dropout
        masks} (the seam of vamb_tpu vae.py:186-201)."""
        x = torch.cat((depths, tnf, abundance), dim=1)
        return self._forward(x, eps=eps, inject=inject, dropout_bank=dropout_bank)

    def _forward(self, x, *, eps=None, inject=None, dropout_bank=None):
        enc_masks = dec_masks = enc_bits = dec_bits = None
        if inject is not None:
            enc_masks, dec_masks = inject["enc_masks"], inject["dec_masks"]
            eps = inject["eps"]
        elif dropout_bank is not None:
            enc_bits, dec_bits = dropout_bank["enc"], dropout_bank["dec"]
        if self.training and eps is None:
            raise ValueError("a training-mode forward needs `eps` or `inject`")
        h = self._stack(self.enc, x, enc_masks, enc_bits)
        mu = self.mu(h.float())  # the heads and the loss in float32 at any precision
        latent = mu + eps if self.training else mu
        h = self._stack(self.dec, latent, dec_masks, dec_bits)
        rec = self.out(h.float())
        S, T = self.nsamples, self.ntnf
        depths_out = torch.softmax(rec[:, :S], dim=1)
        return depths_out, rec[:, S : S + T], rec[:, S + T :], mu

    def calc_loss(self, depths_in, depths_out, tnf_in, tnf_out, ab_in, ab_out, mu, weights):
        """The 4-term weighted loss of reference encode.py:316-357. Its means
        over rows are `layers.batch_mean`s: inside `layers.global_batch(mesh,
        b)` the rows are one rank's share of a data-parallel batch, their
        terms over the global batch size, whose sum over the ranks is the
        batch's loss, and `weights` is the whole global batch's column."""
        ab_sse = torch.sum(torch.square(ab_out - ab_in), dim=1)
        ce = -torch.sum(torch.log(depths_out + 1e-9) * depths_in, dim=1)
        sse = torch.sum(torch.square(tnf_out - tnf_in), dim=1)
        kld = 0.5 * torch.sum(torch.square(mu), dim=1)

        if self.nsamples == 1:
            ce_weight = 0.0
        else:
            ce_weight = ((1 - self.alpha) * (self.nsamples - 1)) / (
                self.nsamples * np.log(self.nsamples)
            )
        ab_sse_weight = (1 - self.alpha) / self.nsamples
        sse_weight = self.alpha / self.ntnf
        kld_weight = 1 / (self.nlatent * self.beta)

        w_ab = ab_sse * ab_sse_weight
        w_ce = ce * ce_weight
        w_sse = sse * sse_weight
        w_kld = kld * kld_weight
        # the reference multiplies the (B,) loss by the (B, 1) weights
        # column, which broadcasts to (B, B): its mean is mean(loss) *
        # mean(weights), not a weighted mean. Training depends on it.
        loss = layers.batch_mean(w_ce + w_ab + w_sse + w_kld) * torch.mean(weights[:, 0])
        return loss, *(layers.batch_mean(w) for w in (w_ab, w_ce, w_sse, w_kld))

    # ------------------------------------------------------------ training

    def _draw_bank(self, bank_key, batchsize: int):
        """One epoch's dropout bytes for every layer, in a single draw:
        `bits(bank_key, (B, nwords))` as little-endian bytes (vae.py:356-384)."""
        if self.dropout == 0.0:
            return None
        return layers.dropout_bank(
            bank_key, batchsize, self.nhiddens + self.nhiddens[::-1], self.device
        )

    def epoch_draws(self, rng, n: int, batchsize: int, nbatches: int):
        """The random draws of one epoch from the key chain `rng`, as
        `vamb_tpu`'s `one_epoch` makes them (vae.py:414-453). Returns
        (next rng, permutation (n,), bank or None, eps (nbatches, B, nlatent))."""
        rng, key = threefry.split_host(rng)
        perm_key, scan_key, bank_key = threefry.split_host(key, 3)
        perm = threefry.permutation(perm_key, n, self.device)
        bank = self._draw_bank(bank_key, batchsize)
        eps_keys = []
        for _ in range(nbatches):
            scan_key, sub = threefry.split_host(scan_key)
            eps_keys.append(threefry.split_host(sub, 3)[0])
        eps = threefry.normal_batched(eps_keys, batchsize * self.nlatent, self.device)
        return torch.tensor(rng), perm, bank, eps.reshape(nbatches, batchsize, self.nlatent)

    def step_bank(self, bank, i: int) -> Optional[dict]:
        """Step i's dropout bytes: the epoch's bank rotated by `i * 97`
        (uint8 add wraps; vae.py:458-462), so every step gets distinct masks
        from one draw per epoch. None without dropout."""
        slices = layers.step_bank(bank, i)
        if slices is None:
            return None
        k = len(self.nhiddens)
        return {"enc": slices[:k], "dec": slices[k:]}

    def trainmodel(
        self,
        dataset: VAEDataset,
        nepochs: int = 500,
        batchsize: int = 256,
        batchsteps: Optional[list[int]] = [25, 75, 150, 300],
        modelfile: Union[None, str, Path, IO[bytes]] = None,
        logger: Optional[Callable[[str], None]] = None,
        mesh=None,
    ) -> None:
        """Train in place. Mirrors reference trainmodel (encode.py:543-610).
        With `mesh` (a `parallel.Mesh` whose device is this model's),
        training is data-parallel over its ranks (see the module notes)."""
        if nepochs < 1:
            raise ValueError(f"Minimum 1 epoch, not {nepochs}")
        if dataset.n_obs < 2:
            raise ValueError(
                "Cannot train on a dataset with fewer than 2 sequences, but got "
                f"{dataset.n_obs} sequences. "
                "If you are trying to fit a DL model to this few sequences, "
                "something probably went wrong in your pipeline."
            )
        batchsteps_list = validate_batchsteps(nepochs, batchsteps)

        log = logger if logger is not None else lambda _msg: None
        log("\tNetwork properties:")
        log(f"\t    Alpha: {self.alpha}")
        log(f"\t    Beta: {self.beta}")
        log(f"\t    Dropout: {self.dropout}")
        if self.precision != "f32":
            log(f"\t    Precision: {self.precision}")
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
        S, T = self.nsamples, self.ntnf
        # ONE packed buffer [depths | tnf | abundance | weights] on the card:
        # an epoch is one row gather, a step one slice
        packed = torch.as_tensor(np.concatenate(dataset, axis=1), device=dev)
        if mesh is not None:
            replicate(self, mesh)  # rank 0's weights on every rank, as vamb_tpu's replicate
        params = self.parameters_flat_order()
        optimizer = DAdaptAdam(
            params, grad_reduce=None if mesh is None else lambda g: mesh.sum_ranks(g, "gradients"))
        self.train()
        for epoch in range(nepochs):
            bs = min(batchsize_at_epoch(batchsize, batchsteps_list, epoch), n)
            nb = num_batches(n, bs)
            lo, hi = (0, bs) if mesh is None else mesh.block(bs)  # this rank's rows of a batch
            wall = time.time()
            self.rng, perm, bank, eps = self.epoch_draws(self.rng, n, bs, nb)
            shuf = packed[perm[: nb * bs]].reshape(nb, bs, -1)
            comps = torch.zeros(5, device=dev)
            with layers.global_batch(mesh, bs):
                for i in range(nb):
                    batch = shuf[i]
                    rows = batch[lo:hi]
                    d_out, t_out, a_out, mu = self._forward(
                        rows[:, : S + T + 1], eps=eps[i][lo:hi],
                        dropout_bank=rows_of(self.step_bank(bank, i), lo, hi),
                    )
                    loss, w_ab, w_ce, w_sse, w_kld = self.calc_loss(  # the global batch's weights
                        rows[:, :S], d_out, rows[:, S : S + T], t_out,
                        rows[:, S + T : S + T + 1], a_out, mu, batch[:, S + T + 1 :],
                    )
                    optimizer.zero_grad(set_to_none=True)
                    loss.backward()
                    optimizer.step()
                    comps += torch.stack([loss, w_ab, w_ce, w_sse, w_kld]).detach()
            if mesh is not None:
                comps = mesh.sum_ranks(comps, "metrics")
            c = (comps / nb).cpu().numpy()  # one host sync per epoch
            log(
                "\t\tEpoch: {:>3}  Loss: {:.5e}  CE: {:.5e}  AB: {:.5e}  "
                "SSE: {:.5e}  KLD: {:.5e}  Batchsize: {:>4}  ({:.2f}s)".format(
                    epoch + 1, c[0], c[2], c[1], c[3], c[4], bs,
                    time.time() - wall,
                )
            )
            if mesh is not None:
                check_replicas(params, mesh, log)
        self.eval()
        if modelfile is not None:
            self.save(modelfile)

    # ------------------------------------------------------------- encode

    @torch.no_grad()
    def encode(self, dataset: VAEDataset) -> np.ndarray:
        "Latent mu for every row, eval mode. Output has 12 mantissa bits masked."
        self.eval()
        n = dataset.n_obs
        latent = np.empty((n, self.nlatent), dtype=np.float32)
        for start in range(0, n, _ENCODE_CHUNK):
            stop = min(start + _ENCODE_CHUNK, n)
            d, t, a = (
                torch.as_tensor(arr[start:stop], device=self.device)
                for arr in (dataset.depths, dataset.tnf, dataset.abundance)
            )
            latent[start:stop] = self(d, t, a)[3].cpu().numpy()
        mask_lower_bits(latent, 12)
        return latent

    # ------------------------------------------------------------- save/load

    def meta(self) -> dict:
        return {
            "model": "vae",
            "nsamples": self.nsamples,
            "nhiddens": self.nhiddens,
            "nlatent": self.nlatent,
            "alpha": self.alpha,
            "beta": self.beta,
            "dropout": self.dropout,
            "seed": self.seed,
            "precision": self.precision,
        }

    def save(self, io: Union[str, Path, IO[bytes]]) -> None:
        "Write `model.npz` in vamb_tpu's format (loads with vamb_tpu's VAE.load)."
        save_flat(io, params_to_jax(self.state_dict()), self.meta())

    @classmethod
    def load(cls, io: Union[str, Path, IO[bytes]], device="cuda") -> "VAE":
        """Read a `model.npz` written by either package, at the precision it
        records ("f32" where it records none)."""
        flat, meta = load_flat(io)
        vae = cls(
            nsamples=meta["nsamples"],
            nhiddens=meta["nhiddens"],
            nlatent=meta["nlatent"],
            alpha=meta["alpha"],
            beta=meta["beta"],
            dropout=meta["dropout"],
            seed=meta.get("seed", 0),
            device=device,
            precision=meta.get("precision", "f32"),
        )
        vae.load_state_dict(params_from_jax(flat))
        vae.eval()
        return vae
