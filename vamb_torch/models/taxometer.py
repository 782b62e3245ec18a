"""Taxometer: the feed-forward taxonomy predictor, as a PyTorch `nn.Module`.

Port of `vamb_tpu/models/taxometer.py` (reference vamb/taxvamb_encode.py:
746-1106, `VAMB2Label`): an MLP over [depths ‖ TNF ‖ total abundance]
(Linear -> LeakyReLU -> Dropout -> BatchNorm blocks, then a Linear head)
producing per-node logits, trained with one of three hierarchical losses
(models/hier.py) and D-Adaptation Adam:

* flat_softmax: logits over the leaves, NLL of the label's summed leaves;
* cond_softmax: logits per non-root node, conditional-softmax CE;
* soft_margin: logits over all nodes, soft margin with tau 0.01.

Weights are drawn from `np.random.default_rng(seed)` in `vamb_tpu`'s order.
Training runs `models/training.train_epochs` on `vamb_tpu`'s key chain with
the per-epoch dropout bank (`layers.dropout_bank`, rotated per step), so
both packages train on the same batches and masks; with `mesh=` training
is data-parallel over its ranks (`train_epochs`'s notes), on D-Adaptation
with the flat gradient summed in rank order. The labels are the
one-hot of each contig's node over `max(n_tree_nodes, 105)` classes, cut to
the tree's `n_tree_nodes` columns. `predict` computes node probabilities on
the device in chunks of 65,536 rows and picks each row's prediction with
`argmax_with_confidence` on the host; `predict_above` selects the
probabilities above a threshold on the device, for the refined TSV.
`save`/`load` use `vamb_tpu`'s `predictor_model.npz` format.
"""

from pathlib import Path
from typing import IO, Callable, Iterable, Optional, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..optim import DAdaptAdam
from ..utils import threefry
from ..utils.checkpoint import load_flat, params_from_jax, params_to_jax, save_flat
from . import hier, layers
from .dataset import VAEDataset
from .training import train_epochs, validate_batchsteps

DEFAULT_HIER_LOSS = "flat_softmax"
_PREDICT_CHUNK = 1 << 16


class Taxometer(nn.Module):
    """Taxonomy label predictor. `nodes`/`table_parent` come from
    `hier.make_graph` over the input taxonomy; `hier_loss` picks the head."""

    def __init__(
        self,
        nsamples: int,
        nlabels: int,
        nodes: list[str],
        table_parent: list[int],
        nhiddens: Optional[list[int]] = None,
        alpha: Optional[float] = None,
        beta: float = 200.0,
        dropout: Optional[float] = 0.2,
        hier_loss: str = DEFAULT_HIER_LOSS,
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
        if any(i < 1 for i in nhiddens):
            raise ValueError(f"Minimum 1 neuron per layer, not {min(nhiddens)}")
        if beta <= 0:
            raise ValueError(f"beta must be > 0, not {beta}")
        if not (0 < alpha < 1):
            raise ValueError(f"alpha must be 0 < alpha < 1, not {alpha}")
        if not (0 <= dropout < 1):
            raise ValueError(f"dropout must be 0 <= dropout < 1, not {dropout}")

        self.nsamples = nsamples
        self.ntnf = 103
        self.alpha = alpha
        self.beta = beta
        self.nhiddens = list(nhiddens)
        self.dropout = dropout
        self.seed = seed
        self.nodes = list(nodes)
        self.table_parent = list(table_parent)
        self.n_tree_nodes = nlabels
        self.hier_loss_name = hier_loss
        self.device = resolve_device(device)

        dev = self.device
        self.tree = hier.Hierarchy(np.array(table_parent))
        if hier_loss == "flat_softmax":
            self.loss_fn = hier.FlatSoftmaxNLL(self.tree, dev)
            helper = hier.SumLeafDescendants(self.tree, device=dev)
            self._pred_fn = lambda theta: helper(torch.softmax(theta, dim=-1))
            self.nlabels = self.tree.num_leaf_nodes()
        elif hier_loss == "cond_softmax":
            self.loss_fn = hier.HierSoftmaxCrossEntropy(self.tree, dev)
            helper = hier.HierLogSoftmax(self.tree, dev)
            self._pred_fn = lambda theta: torch.exp(helper(theta))
            self.nlabels = self.tree.num_nodes() - 1
        elif hier_loss == "soft_margin":
            self.loss_fn = hier.MarginLoss(
                self.tree, hardness="soft", margin="incorrect", tau=0.01, device=dev
            )
            helper = hier.SumDescendants(self.tree, device=dev)
            self._pred_fn = lambda theta: helper(torch.softmax(theta, dim=-1))
            self.nlabels = self.tree.num_nodes()
        else:
            raise AttributeError(f"Hierarchical loss {hier_loss} not found")

        self.specificity = -self.tree.num_leaf_descendants()
        self.not_trivial = self.tree.num_children() != 1
        self.rng = threefry.key(seed)

        rng = np.random.default_rng(seed)
        dims = [self.nfeatures] + self.nhiddens
        self.enc = nn.ModuleList(layers.Block(rng, i, o) for i, o in zip(dims, dims[1:]))
        self.out = layers.Linear(rng, self.nhiddens[-1], self.nlabels)
        self.to(dev)

    @property
    def nfeatures(self) -> int:
        return self.nsamples + self.ntnf + 1

    def parameters_flat_order(self) -> list[nn.Parameter]:
        "Parameters in the leaf order of `vamb_tpu`'s params tree (sorted keys)."
        out = []
        for block in self.enc:
            out += [block.bn.bias, block.bn.scale, block.dense.b, block.dense.w]
        return out + [self.out.b, self.out.w]

    def forward(self, x: torch.Tensor, bits=None) -> torch.Tensor:
        """Logits of the rows `x` = [depths ‖ TNF ‖ abundance]. In training
        mode `bits` holds one (B, width) uint8 slice a hidden layer."""
        for i, block in enumerate(self.enc):
            x = layers.leaky_relu(block.dense(x))
            if self.training and bits is not None:
                x = layers.dropout_from_bits(bits[i], x, self.dropout)
            x = block.bn(x)
        return self.out(x)

    def _draw_dropout_bank(self, key, batchsize: int):
        "One epoch's dropout bytes for all hidden layers (None without dropout)."
        if self.dropout == 0.0:
            return None
        return layers.dropout_bank(key, batchsize, self.nhiddens, self.device)

    # ------------------------------------------------------------ training

    def trainmodel(
        self,
        dataset: VAEDataset,
        targets: np.ndarray,
        nepochs: int = 500,
        batchsize: int = 1024,
        batchsteps: Optional[list[int]] = [25, 75, 150, 300],
        modelfile: Union[None, str, Path, IO[bytes]] = None,
        logger: Optional[Callable[[str], None]] = None,
        mesh=None,
    ) -> None:
        """Train in place on (dataset, integer node targets); with `mesh` (a
        `parallel.Mesh` whose device is this model's), data-parallel over
        its ranks."""
        if nepochs < 1:
            raise ValueError(f"Minimum 1 epoch, not {nepochs}")
        batchsteps_list = validate_batchsteps(nepochs, batchsteps)
        log = logger if logger is not None else lambda _m: None
        log("\tNetwork properties:")
        log(f"\t    Hierarchical loss: {self.hier_loss_name}")
        log(f"\t    Alpha: {self.alpha}")
        log(f"\t    Beta: {self.beta}")
        log(f"\t    Dropout: {self.dropout}")
        log(f"\t    N hidden: {', '.join(map(str, self.nhiddens))}")
        log("\tTraining properties:")
        log(f"\t    N epochs: {nepochs}")
        log(f"\t    Starting batch size: {batchsize}")
        log(
            "\t    Batchsteps: "
            + (", ".join(map(str, batchsteps_list)) if batchsteps_list else "None")
        )
        log(f"\t    N labels: {self.nlabels}")

        dev = self.device
        optimizer = DAdaptAdam(
            self.parameters_flat_order(),
            grad_reduce=None if mesh is None else lambda g: mesh.sum_ranks(g, "gradients"))
        n_label_classes = max(self.n_tree_nodes, 105)

        def step(batch, _key, bank, i):
            x, labels = batch
            onehot = nn.functional.one_hot(labels, n_label_classes)
            onehot = onehot[:, : self.n_tree_nodes].float()
            loss = self.loss_fn(self(x, layers.step_bank(bank, i)), onehot)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            return loss.detach()[None]

        def emit(epoch, m, bs, seconds):
            log(f"\tEpoch: {epoch + 1}\tCE: {float(m[0]):.7f}\tBatchsize: {bs}  ({seconds:.2f}s)")

        x = torch.as_tensor(
            np.concatenate((dataset.depths, dataset.tnf, dataset.abundance), axis=1), device=dev
        )
        y = torch.as_tensor(np.asarray(targets, dtype=np.int64), device=dev)
        self.train()
        self.rng = train_epochs(
            step, (x, y), self.rng, dataset.n_obs, nepochs, batchsize,
            batchsteps_list, emit, epoch_extra=self._draw_dropout_bank,
            mesh=mesh, model=self, log=log,
        )
        self.eval()
        if modelfile is not None:
            self.save(modelfile)

    # ------------------------------------------------------------- predict

    @torch.no_grad()
    def probabilities(self, x: torch.Tensor) -> torch.Tensor:
        "Node probabilities of the feature rows `x` (eval-mode BatchNorm)."
        self.eval()
        return self._pred_fn(self(x))

    def _chunks(self, dataset: VAEDataset, chunk: int) -> Iterable[torch.Tensor]:
        "Node probabilities on the device, `chunk` rows at a time."
        n = dataset.n_obs
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            x = np.concatenate(
                (dataset.depths[start:stop], dataset.tnf[start:stop],
                 dataset.abundance[start:stop]),
                axis=1,
            )
            yield self.probabilities(torch.as_tensor(x, device=self.device))

    def predict(
        self, dataset: VAEDataset, chunk: int = _PREDICT_CHUNK
    ) -> Iterable[tuple[np.ndarray, np.ndarray]]:
        """Yield (prob, pred) per chunk of rows: node probabilities and the
        confidence-thresholded node prediction (reference :890-918)."""
        for prob in self._chunks(dataset, chunk):
            prob = prob.cpu().numpy()
            pred = hier.argmax_with_confidence(self.specificity, prob, 0.5, self.not_trivial)
            yield prob, pred

    def predict_above(
        self, dataset: VAEDataset, threshold: float, chunk: int = _PREDICT_CHUNK
    ) -> Iterable[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield, per chunk of rows, the probabilities above `threshold`,
        selected on the device: (count a row, node columns in row-major
        order, float32 probabilities). What `predict`'s `prob > threshold`
        selects, without copying every node's probability to the host."""
        for prob in self._chunks(dataset, chunk):
            rows, cols = torch.nonzero(prob > threshold, as_tuple=True)
            counts = torch.bincount(rows, minlength=prob.shape[0])
            yield counts.cpu().numpy(), cols.cpu().numpy(), prob[rows, cols].cpu().numpy()

    # ------------------------------------------------------------ save/load

    def meta(self) -> dict:
        return {
            "model": "taxometer",
            "nsamples": self.nsamples,
            "nhiddens": self.nhiddens,
            "alpha": self.alpha,
            "beta": self.beta,
            "dropout": self.dropout,
            "hier_loss": self.hier_loss_name,
            "nodes": self.nodes,
            "table_parent": self.table_parent,
            "seed": self.seed,
        }

    def save(self, io: Union[str, Path, IO[bytes]]) -> None:
        "Write `predictor_model.npz` in vamb_tpu's format."
        save_flat(io, params_to_jax(self.state_dict()), self.meta())

    @classmethod
    def load(cls, io: Union[str, Path, IO[bytes]], device="cuda") -> "Taxometer":
        "Read a `predictor_model.npz` written by either package."
        flat, meta = load_flat(io)
        model = cls(
            nsamples=meta["nsamples"],
            nlabels=len(meta["nodes"]),
            nodes=meta["nodes"],
            table_parent=meta["table_parent"],
            nhiddens=meta["nhiddens"],
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
