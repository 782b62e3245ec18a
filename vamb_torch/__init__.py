"""vamb_torch — the PyTorch/CUDA port of vamb_tpu, for one NVIDIA H100.

A second package beside `vamb_tpu` (the JAX reference, which stays as it
is). It imports torch and numpy, never jax and nothing from `vamb_tpu`,
and keeps its own copies of the host-side code it needs. Entry points run
on the CUDA card unless the caller passes `device="cpu"`.

Ported so far: the `bin default` path — FASTA -> TNF (`composition`),
abundance TSV (`abundance`), dataset normalization, the VAE
(`models.vae`, trained with D-Adaptation Adam), the iterative medoid
clustering engine at full wander scope (`cluster`, on the hand-written
CUDA kernels in `kernels/`), binsplit and the cluster TSVs (`pipeline`).
"""

__version__ = "0.5.0"
