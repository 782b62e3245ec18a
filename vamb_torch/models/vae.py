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
  per step (vamb_tpu vae.py:414-475). The bank, the epoch permutation and
  the latent eps come from one `torch.Generator` on the device, so runs
  are reproducible per seed and device but draw other numbers than jax;
* `encode` returns `mu` with the 12 low mantissa bits masked (vae.py:684);
* `save`/`load` use `vamb_tpu`'s `model.npz` flat-key format.
"""

import time
from pathlib import Path
from typing import IO, Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..optim import DAdaptAdam
from ..utils import mask_lower_bits
from ..utils.checkpoint import load_flat, params_from_jax, params_to_jax, save_flat
from . import layers
from .dataset import VAEDataset, batchsize_at_epoch, num_batches
from .training import validate_batchsteps

_ENCODE_CHUNK = 1 << 16  # rows per encode forward


class _Block(nn.Module):
    "Dense -> LeakyReLU -> Dropout -> BatchNorm."

    def __init__(self, rng: np.random.Generator, nin: int, nout: int):
        super().__init__()
        self.dense = layers.Linear(rng, nin, nout)
        self.bn = layers.BatchNorm(nout)


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
        if precision != "f32":
            raise NotImplementedError(
                f"precision={precision!r} is not ported yet (ROADMAP queue 1, item 3: "
                "bf16 training); vamb_torch trains in f32"
            )

        self.nsamples = nsamples
        self.ntnf = 103
        self.nhiddens = list(nhiddens)
        self.nlatent = nlatent
        self.alpha = alpha
        self.beta = beta
        self.dropout = dropout
        self.seed = seed
        self.device = resolve_device(device)

        rng = np.random.default_rng(seed)
        dims_enc = [self.nfeatures] + self.nhiddens
        dims_dec = [nlatent] + self.nhiddens[::-1]
        self.enc = nn.ModuleList(_Block(rng, i, o) for i, o in zip(dims_enc, dims_enc[1:]))
        self.mu = layers.Linear(rng, self.nhiddens[-1], nlatent)
        self.dec = nn.ModuleList(_Block(rng, i, o) for i, o in zip(dims_dec, dims_dec[1:]))
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
        for i, block in enumerate(blocks):
            x = layers.leaky_relu(block.dense(x))
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
        inject: Optional[dict] = None,
        dropout_bank: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Full forward pass; returns (depths_out, tnf_out, abundance_out, mu).

        In training mode the decoder sees `mu + eps`, eps ~ N(0, 1) drawn
        from `generator`. `inject` replaces every draw with caller-supplied
        tensors: {"eps": (B, nlatent), "enc_masks"/"dec_masks": per-layer
        pre-scaled dropout masks} (the seam of vamb_tpu vae.py:186-201, so a
        test can drive both packages with one random stream).
        `dropout_bank` supplies dropout bytes instead: {"enc"/"dec": list of
        (B, width) uint8 per layer}. With neither, there is no dropout."""
        x = torch.cat((depths, tnf, abundance), dim=1)
        return self._forward(x, inject=inject, dropout_bank=dropout_bank,
                             generator=generator)

    def _forward(self, x, *, inject=None, dropout_bank=None, generator=None):
        enc_masks = dec_masks = enc_bits = dec_bits = None
        if inject is not None:
            enc_masks, dec_masks = inject["enc_masks"], inject["dec_masks"]
        elif dropout_bank is not None:
            enc_bits, dec_bits = dropout_bank["enc"], dropout_bank["dec"]
        h = self._stack(self.enc, x, enc_masks, enc_bits)
        mu = self.mu(h)
        if self.training:
            if inject is not None:
                eps = inject["eps"]
            else:
                eps = torch.randn(mu.shape, generator=generator, device=mu.device)
            latent = mu + eps
        else:
            latent = mu
        h = self._stack(self.dec, latent, dec_masks, dec_bits)
        rec = self.out(h)
        S, T = self.nsamples, self.ntnf
        depths_out = torch.softmax(rec[:, :S], dim=1)
        return depths_out, rec[:, S : S + T], rec[:, S + T :], mu

    def calc_loss(self, depths_in, depths_out, tnf_in, tnf_out, ab_in, ab_out, mu, weights):
        "The 4-term weighted loss of reference encode.py:316-357."
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
        loss = torch.mean(w_ce + w_ab + w_sse + w_kld) * torch.mean(weights[:, 0])
        return loss, w_ab.mean(), w_ce.mean(), w_sse.mean(), w_kld.mean()

    # ------------------------------------------------------------ training

    def _draw_bank(self, batchsize: int, generator: torch.Generator):
        "One epoch's dropout bytes for every layer, in a single draw."
        if self.dropout == 0.0:
            return None
        widths = self.nhiddens + self.nhiddens[::-1]
        bits = torch.randint(0, 256, (batchsize, sum(widths)), dtype=torch.uint8,
                             generator=generator, device=self.device)
        return bits, widths

    def trainmodel(
        self,
        dataset: VAEDataset,
        nepochs: int = 500,
        batchsize: int = 256,
        batchsteps: Optional[list[int]] = [25, 75, 150, 300],
        modelfile: Union[None, str, Path, IO[bytes]] = None,
        logger: Optional[Callable[[str], None]] = None,
    ) -> None:
        "Train in place. Mirrors reference trainmodel (encode.py:543-610)."
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
        generator = torch.Generator(device=dev)
        generator.manual_seed(self.seed)
        optimizer = DAdaptAdam(self.parameters_flat_order())
        self.train()
        for epoch in range(nepochs):
            bs = min(batchsize_at_epoch(batchsize, batchsteps_list, epoch), n)
            nb = num_batches(n, bs)
            wall = time.time()
            perm = torch.randperm(n, generator=generator, device=dev)
            shuf = packed[perm[: nb * bs]].reshape(nb, bs, -1)
            bank = self._draw_bank(bs, generator)
            comps = torch.zeros(5, device=dev)
            for i in range(nb):
                batch = shuf[i]
                step_bank = None
                if bank is not None:
                    # rotate the epoch's bytes per step (uint8 add wraps):
                    # distinct masks every step from one draw per epoch
                    bits = bank[0] + (i * 97) % 256
                    slices = torch.split(bits, bank[1], dim=1)
                    k = len(self.nhiddens)
                    step_bank = {"enc": slices[:k], "dec": slices[k:]}
                d_out, t_out, a_out, mu = self._forward(
                    batch[:, : S + T + 1], dropout_bank=step_bank, generator=generator
                )
                loss, w_ab, w_ce, w_sse, w_kld = self.calc_loss(
                    batch[:, :S], d_out, batch[:, S : S + T], t_out,
                    batch[:, S + T : S + T + 1], a_out, mu, batch[:, S + T + 1 :],
                )
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()
                comps += torch.stack([loss, w_ab, w_ce, w_sse, w_kld]).detach()
            c = (comps / nb).cpu().numpy()  # one host sync per epoch
            log(
                "\t\tEpoch: {:>3}  Loss: {:.5e}  CE: {:.5e}  AB: {:.5e}  "
                "SSE: {:.5e}  KLD: {:.5e}  Batchsize: {:>4}  ({:.2f}s)".format(
                    epoch + 1, c[0], c[2], c[1], c[3], c[4], bs,
                    time.time() - wall,
                )
            )
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
            "precision": "f32",
        }

    def save(self, io: Union[str, Path, IO[bytes]]) -> None:
        "Write `model.npz` in vamb_tpu's format (loads with vamb_tpu's VAE.load)."
        save_flat(io, params_to_jax(self.state_dict()), self.meta())

    @classmethod
    def load(cls, io: Union[str, Path, IO[bytes]], device="cuda") -> "VAE":
        "Read a `model.npz` written by either package."
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
