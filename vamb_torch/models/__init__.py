"""Model layer: the PyTorch VAE over contig features.

* `vae` — the variational autoencoder (reference vamb/encode.py).
* `dataset` — the normalization contract (host numpy).
* `layers` — Linear/BatchNorm/dropout modules with vamb_tpu's semantics.
"""

from .dataset import VAEDataset, make_dataset  # noqa: F401
from .vae import VAE  # noqa: F401
