"""Model layer: the PyTorch models over contig features.

* `vae` — the variational autoencoder (reference vamb/encode.py).
* `taxometer` — the taxonomy predictor; `vaevae` — TaxVamb's bi-modal VAE;
  `hier` — the taxonomy tree and the hierarchical losses they train on.
* `aae` — Avamb's adversarial autoencoder.
* `training` — the shared epoch loop on jax's key chain.
* `dataset` — the normalization contract (host numpy).
* `layers` — Linear/BatchNorm/dropout modules with vamb_tpu's semantics.
"""

from .dataset import VAEDataset, make_dataset  # noqa: F401
from .vae import VAE  # noqa: F401
