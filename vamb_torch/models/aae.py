"""Avamb's adversarial autoencoder (AAE), as a PyTorch `nn.Module`.

Port of `vamb_tpu/models/aae.py` (reference vamb/aamb_encode.py). A
continuous z latent (default 283 wide) and a categorical y latent (default
700) over [depths ‖ TNF]; two discriminators; each step runs three phases
with Adam at 1e-3 (`optim.Adam`, optax's rule) for the encoder, the
decoder and each discriminator:

1. generator: encode, sample z = mu + eps * exp(logvar / 2), decode; the
   loss (1 - sl) * reconstruction + sl * slr * adv_z + sl * (1 - slr) *
   adv_y updates the encoder and the decoder only (the discriminators are
   constants here: the backward pass reaches only their parameters);
2. discriminator z: a second encode in training mode with the updated
   weights (gradients stopped) against a N(0, 1) prior;
3. discriminator y: the encoder's y against a Gumbel-softmax prior at
   temperature T. The reference encodes a third time here, which only moves
   the encoder's BatchNorm statistics once more; with momentum m and the
   same batch statistics, s3 = (2 - m) * s2 - (1 - m) * s1 (s1 after phase
   1, s2 after phase 2), as `vamb_tpu` applies it.

Layers: encoder and decoder blocks are Linear -> BatchNorm -> LeakyReLU
(BatchNorm before the activation, no dropout, unlike the VAE); the
discriminators Linear(h) -> LeakyReLU -> Linear(h/2) -> LeakyReLU ->
Linear(1) -> Sigmoid. Weights are drawn from `np.random.default_rng(seed)`
in `vamb_tpu`'s order (encoder and decoder blocks, then mu, logvar, y, the
decoder's output and the discriminators), so a seed gives the same weights.

Data parallelism (`trainmodel(mesh=)`, `vamb_tpu`'s GSPMD over the
global batch): every rank draws the whole batch's streams and computes on
its rows of each (`train_epochs`'s notes); the losses are means over rows
(`layers.batch_mean`), so a rank's are its share of the global batch's.
Each of the three phases sums its flat gradient over the ranks in rank
order before its update: the encoder's and the decoder's in one gather
("gradients e+d", their Adams one rule over both, Adam being
elementwise), then each discriminator's ("gradients disc_z",
"gradients disc_y"), since each phase reads the weights that the one
before updated.

Random streams follow `vamb_tpu`'s key chain: an epoch splits its key in
two (`models/training.train_epochs`), step i takes `key, k_eps, k_prior_z,
k_prior_y, k_eps2 = split(key, 5)`, and the epoch's draws are made at once
(`_step_draws`): eps, the z prior and eps2 with `normal`, the y prior's
uniforms with `uniform`, its logs with XLA's CPU log (`threefry.log_xla`),
bit for bit jax's on the CPU and on the card. `get_latents` returns mu and
the y clusters (argmax of the softmax, from 1) in eval mode; `save`/`load`
use `aae_model.npz`'s format.
"""

from pathlib import Path
from typing import IO, Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..optim import Adam
from ..utils import threefry
from ..utils.checkpoint import load_flat, params_from_jax, params_to_jax, save_flat
from . import layers
from .dataset import VAEDataset, encode_chunk_rows
from .training import train_epochs, validate_batchsteps

_ENCODE_CHUNK = 1 << 16
_BN_MOMENTUM = 0.1  # layers.BatchNorm's default
_DRAW_CHUNK = 64  # steps whose draws are made in one call (bounds the temporaries)
_F32_TINY = float(np.finfo(np.float32).tiny)
_P_MAX = 1.0 - 2.0 ** -24  # the largest float32 below 1


def _bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on probabilities, as `vamb_tpu` writes it:
    the probabilities clipped to the nearest float32 numbers strictly inside
    (0, 1), so a saturated discriminator (sigmoid exactly 1.0) gives a
    finite loss and a zero gradient (`torch.nn.BCELoss` clamps its logs at
    -100 instead, another value)."""
    p = torch.clamp(pred, _F32_TINY, _P_MAX)
    return layers.batch_mean(-(target * torch.log(p) + (1 - target) * torch.log1p(-p)))


class AAE(nn.Module):
    "Adversarial autoencoder with z and y latents (reference aamb_encode.py:19)."

    def __init__(
        self,
        nsamples: int,
        nhiddens: int = 547,
        nlatent_z: int = 283,
        nlatent_y: int = 700,
        sl: float = 0.00964,
        slr: float = 0.5,
        alpha: Optional[float] = None,
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        for variable, name in [
            (nsamples, "nsamples"),
            (nhiddens, "nhiddens"),
            (nlatent_z, "nlatent_z"),
            (nlatent_y, "nlatent_y"),
        ]:
            if variable < 1:
                raise ValueError(f"{name} must be at least 1, not {variable}")
        for variable, name in [(sl, "sl"), (slr, "slr")]:
            if not (0.0 <= variable <= 1.0):
                raise ValueError(f"{name} must be in the interval [0.0, 1.0], not {variable}")
        if alpha is None:
            alpha = 0.15 if nsamples > 1 else 0.50

        self.nsamples = nsamples
        self.ntnf = 103
        self.input_len = self.ntnf + nsamples
        self.h_n = nhiddens
        self.ld = nlatent_z
        self.y_len = nlatent_y
        self.sl = sl
        self.slr = slr
        self.alpha = alpha
        self.seed = seed
        self.device = resolve_device(device)

        rng = np.random.default_rng(seed)
        h, half = nhiddens, nhiddens // 2
        self.enc = nn.ModuleList([layers.Block(rng, self.input_len, h), layers.Block(rng, h, h)])
        self.dec = nn.ModuleList([layers.Block(rng, self.ld + self.y_len, h), layers.Block(rng, h, h)])
        self.mu = layers.Linear(rng, h, self.ld)
        self.logvar = layers.Linear(rng, h, self.ld)
        self.y = layers.Linear(rng, h, self.y_len)
        self.dec_out = layers.Linear(rng, h, self.input_len)
        self.disc_z = nn.ModuleList(
            [layers.Linear(rng, self.ld, h), layers.Linear(rng, h, half), layers.Linear(rng, half, 1)]
        )
        self.disc_y = nn.ModuleList(
            [layers.Linear(rng, self.y_len, h), layers.Linear(rng, h, half), layers.Linear(rng, half, 1)]
        )
        self.rng = threefry.key(seed)
        self.to(self.device)

    # ------------------------------------------------------------- forward

    @staticmethod
    def _stack(blocks, x: torch.Tensor) -> torch.Tensor:
        "Linear -> BatchNorm -> LeakyReLU blocks (the AAE's order)."
        for block in blocks:
            x = layers.leaky_relu(block.bn(block.dense(x)))
        return x

    def encode(self, depths: torch.Tensor, tnf: torch.Tensor):
        "(mu, logvar, y): y is the softmax over the y latent."
        h = self._stack(self.enc, torch.cat((depths, tnf), dim=1))
        return self.mu(h), self.logvar(h), torch.softmax(self.y(h), dim=1)

    def decode(self, z: torch.Tensor, y: torch.Tensor):
        "(depths out, TNF out): the depths through a softmax."
        rec = self.dec_out(self._stack(self.dec, torch.cat((z, y), dim=1)))
        return torch.softmax(rec[:, : self.nsamples], dim=1), rec[:, self.nsamples :]

    @staticmethod
    def discriminate(blocks, x: torch.Tensor) -> torch.Tensor:
        x = layers.leaky_relu(blocks[0](x))
        x = layers.leaky_relu(blocks[1](x))
        return torch.sigmoid(blocks[2](x))

    def calc_loss(self, depths_in, depths_out, tnf_in, tnf_out):
        "(reconstruction loss, CE, SSE) (reference :176-188)."
        if self.nsamples > 1:
            ce = layers.batch_mean(-torch.sum(torch.log(depths_out + 1e-9) * depths_in, dim=1))
            ce_weight = (1 - self.alpha) / np.log(self.nsamples)
        else:
            ce = layers.batch_mean(torch.sum(torch.square(depths_out - depths_in), dim=1))
            ce_weight = 1 - self.alpha
        sse = layers.batch_mean(torch.sum(torch.square(tnf_out - tnf_in), dim=1))
        sse_weight = self.alpha / (self.ntnf * 2)
        return ce * ce_weight + sse * sse_weight, ce, sse

    def gumbel_softmax_prior(self, u: torch.Tensor, temperature: float) -> torch.Tensor:
        """A RelaxedOneHotCategorical(T, uniform logits) sample from the
        uniforms `u`, with XLA's CPU log as `vamb_tpu` draws it."""
        gumbel = -threefry.log_xla(-threefry.log_xla(u + 1e-20) + 1e-20)
        return torch.softmax(gumbel / temperature, dim=1)

    # ------------------------------------------------------------ training

    def _step_draws(self, keys: list, batchsize: int, temperature: float) -> list:
        """Every step's random draws of an epoch from its step keys (k_eps,
        k_prior_z, k_prior_y, k_eps2): [(eps, z prior, y prior, eps2)], the
        normals of (B, ld) and the y prior of (B, y_len), made _DRAW_CHUNK
        steps a call."""
        out = []
        for lo in range(0, len(keys), _DRAW_CHUNK):
            chunk = keys[lo : lo + _DRAW_CHUNK]
            normal_keys = [k for ks in chunk for k in (ks[0], ks[1], ks[3])]
            normals = threefry.normal_batched(normal_keys, batchsize * self.ld, self.device)
            normals = normals.reshape(len(chunk), 3, batchsize, self.ld)
            u = threefry.uniform_batched([ks[2] for ks in chunk], batchsize * self.y_len, self.device)
            y_prior = self.gumbel_softmax_prior(u.reshape(-1, self.y_len), temperature)
            y_prior = y_prior.reshape(len(chunk), batchsize, self.y_len)
            out += [(normals[i, 0], normals[i, 1], y_prior[i], normals[i, 2]) for i in range(len(chunk))]
        return out

    def trainmodel(
        self,
        dataset: VAEDataset,
        nepochs: int = 70,
        batchsize: int = 256,
        batchsteps: Optional[list[int]] = [25, 50],
        temperature: float = 0.1596,
        modelfile: Union[None, str, Path, IO[bytes]] = None,
        logger: Optional[Callable[[str], None]] = None,
        mesh=None,
    ) -> None:
        """Train in place on the dataset's depths and TNF; with `mesh` (a
        `parallel.Mesh` whose device is this model's), data-parallel over
        its ranks."""
        if nepochs < 1:
            raise ValueError(f"Minimum 1 epoch, not {nepochs}")
        batchsteps_list = validate_batchsteps(nepochs, batchsteps)
        log = logger if logger is not None else lambda _m: None
        log("\tNetwork properties:")
        log(f"\t    Alpha: {self.alpha}")
        log(f"\t    Y length: {self.y_len}")
        log(f"\t    Z length: {self.ld}")
        log("\tTraining properties:")
        log(f"\t    N epochs: {nepochs}")
        log(f"\t    Starting batch size: {batchsize}")
        log(
            "\t    Batchsteps: "
            + (", ".join(map(str, batchsteps_list)) if batchsteps_list else "None")
        )
        log(f"\t    N sequences: {dataset.n_obs}")
        log(f"\t    N samples: {dataset.nsamples}")

        enc_params = [p for m in (self.enc, self.mu, self.logvar, self.y) for p in m.parameters()]
        dec_params = [p for m in (self.dec, self.dec_out) for p in m.parameters()]
        gen_params = enc_params + dec_params

        def reduce(kind):
            return None if mesh is None else lambda g: mesh.sum_ranks(g, kind)

        # the encoder's and the decoder's Adams as one rule over both
        opt_g = Adam(gen_params, lr=1e-3, eps=1e-8, grad_reduce=reduce("gradients e+d"))
        opt_dz = Adam(self.disc_z.parameters(), lr=1e-3, eps=1e-8,
                      grad_reduce=reduce("gradients disc_z"))
        opt_dy = Adam(self.disc_y.parameters(), lr=1e-3, eps=1e-8,
                      grad_reduce=reduce("gradients disc_y"))
        enc_bns = [block.bn for block in self.enc]
        sl, slr, m = self.sl, self.slr, _BN_MOMENTUM

        def step(batch, draws, _extra, _i):
            d_in, t_in = batch
            eps, z_prior, y_prior, eps2 = draws
            ones = torch.ones((d_in.shape[0], 1), device=d_in.device)
            zeros = torch.zeros_like(ones)

            # generator: the encoder and the decoder
            mu, logvar, y = self.encode(d_in, t_in)
            z = eps * torch.exp(logvar / 2) + mu
            d_out, t_out = self.decode(z, y)
            rec_loss, ce, sse = self.calc_loss(d_in, d_out, t_in, t_out)
            adv_z = _bce(self.discriminate(self.disc_z, z), ones)
            adv_y = _bce(self.discriminate(self.disc_y, y), ones)
            ed_loss = (1 - sl) * rec_loss + (sl * slr) * adv_z + (sl * (1 - slr)) * adv_y
            opt_g.zero_grad()
            ed_loss.backward(inputs=gen_params)
            opt_g.step()

            # discriminator z, on a fresh encode with the updated weights
            s1 = torch._foreach_mul([t for bn in enc_bns for t in (bn.mean, bn.var)], 1.0)
            with torch.no_grad():
                mu, logvar, y_latent = self.encode(d_in, t_in)
                z_latent = eps2 * torch.exp(logvar / 2) + mu
            dz_loss = 0.5 * (
                _bce(self.discriminate(self.disc_z, z_prior), ones)
                + _bce(self.discriminate(self.disc_z, z_latent), zeros)
            )
            opt_dz.zero_grad()
            dz_loss.backward()
            opt_dz.step()

            # discriminator y; the encoder's statistics move as by a third encode
            s2 = [t for bn in enc_bns for t in (bn.mean, bn.var)]
            torch._foreach_mul_(s2, 2 - m)
            torch._foreach_sub_(s2, torch._foreach_mul(s1, 1 - m))
            dy_loss = 0.5 * (
                _bce(self.discriminate(self.disc_y, y_prior), ones)
                + _bce(self.discriminate(self.disc_y, y_latent), zeros)
            )
            opt_dy.zero_grad()
            dy_loss.backward()
            opt_dy.step()
            return torch.stack([ed_loss, rec_loss, ce, sse, dz_loss, dy_loss]).detach()

        def emit(epoch, v, bs, seconds):
            log(
                "\t\tEpoch: {:>3} Loss Enc/Dec: {:.5e} Rec. loss: {:.5e} "
                "CE: {:.5e} SSE: {:.5e} Dz loss: {:.5e} Dy loss: {:.5e} "
                "Batchsize: {:>4}  ({:.2f}s)".format(
                    epoch + 1, v[0], v[1], v[2], v[3], v[4], v[5], bs, seconds,
                )
            )

        data = tuple(torch.as_tensor(a, device=self.device) for a in (dataset.depths, dataset.tnf))
        self.train()
        self.rng = train_epochs(
            step, data, self.rng, dataset.n_obs, nepochs, batchsize, batchsteps_list, emit,
            step_keys=4, step_draws=lambda keys, bs: self._step_draws(keys, bs, temperature),
            mesh=mesh, model=self, log=log,
        )
        self.eval()
        if modelfile is not None:
            self.save(modelfile)

    # ------------------------------------------------------------- latents

    @torch.no_grad()
    def get_latents(self, contignames, dataset: VAEDataset) -> tuple[dict[str, set[str]], np.ndarray]:
        """(y clusters, z latent) in eval mode (reference :434-512): the z
        latent is mu, a contig's y cluster `str(argmax of y + 1)`."""
        self.eval()
        n = dataset.n_obs
        latent = np.empty((n, self.ld), dtype=np.float32)
        y_index = np.empty(n, dtype=np.int64)
        chunk = encode_chunk_rows(n, _ENCODE_CHUNK)
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            d, t = (torch.as_tensor(a[start:stop], device=self.device) for a in (dataset.depths, dataset.tnf))
            mu, _logvar, y = self.encode(d, t)
            latent[start:stop] = mu.cpu().numpy()
            y_index[start:stop] = torch.argmax(y, dim=1).cpu().numpy()
        clust_y_dict: dict[str, set[str]] = dict()
        for name, y in zip(contignames, y_index.tolist()):
            clust_y_dict.setdefault(str(y + 1), set()).add(name)
        return clust_y_dict, latent

    # ------------------------------------------------------------ save/load

    def meta(self) -> dict:
        return {
            "model": "aae",
            "nsamples": self.nsamples,
            "nhiddens": self.h_n,
            "nlatent_z": self.ld,
            "nlatent_y": self.y_len,
            "sl": self.sl,
            "slr": self.slr,
            "alpha": self.alpha,
            "seed": self.seed,
        }

    def save(self, io: Union[str, Path, IO[bytes]]) -> None:
        "Write `aae_model.npz` in vamb_tpu's format."
        save_flat(io, params_to_jax(self.state_dict()), self.meta())

    @classmethod
    def load(cls, io: Union[str, Path, IO[bytes]], device="cuda") -> "AAE":
        "Read an `aae_model.npz` written by either package."
        flat, meta = load_flat(io)
        model = cls(
            nsamples=meta["nsamples"],
            nhiddens=meta["nhiddens"],
            nlatent_z=meta["nlatent_z"],
            nlatent_y=meta["nlatent_y"],
            sl=meta["sl"],
            slr=meta["slr"],
            alpha=meta["alpha"],
            seed=meta.get("seed", 0),
            device=device,
        )
        model.load_state_dict(params_from_jax(flat))
        model.eval()
        return model
