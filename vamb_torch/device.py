"""Device selection shared by every entry point of the port.

Entry points take an explicit `device` and run on the card ("cuda") unless
the caller asks for "cpu". Asking for the card where there is none raises:
nothing silently carries on on the CPU.
"""

import torch


def resolve_device(device) -> torch.device:
    """Return `device` as a torch.device, checking that it is usable.

    On the card this also turns TF32 off for matmuls and cuDNN: the
    clustering histogram's bins are 0.005 wide (vamb_tpu/cluster.py:82-83),
    and TF32 keeps only about three decimal digits. And it has cuBLAS sum a
    bf16 product in float32 and round once, as XLA does (the bf16 VAE),
    where it would otherwise keep reduced-precision partial sums."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vamb_torch was asked to run on a CUDA device, but torch sees "
                "none; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"vamb_torch runs on 'cuda' or 'cpu', not {device!r}")
    return dev
