"""`model.npz` in `vamb_tpu`'s flat-key format, and weights carried across.

`vamb_tpu/utils/checkpoint.py` saves a model as one npz whose keys are
slash-joined tree paths (`params/enc/0/dense/w`, `bn_state/dec/1/var`, ...)
plus a `__meta__` entry holding JSON hyperparameters as uint8 bytes. This
module writes and reads the same format with numpy, so a model trained by
either package loads into the other, and maps the flat keys onto the
port's `state_dict` names (`enc.0.dense.w`, `dec.1.bn.var`, ...). The
mapping covers every model of the port: the VAE and Taxometer
(`params/out/w` -> `out.w`) and VAEVAE, whose sub-VAEs add a level
(`params/joint/enc/0/dense/w` -> `joint.enc.0.dense.w`,
`bn_state/vamb/dec/1/var` -> `vamb.dec.1.bn.var`), and the AAE, whose
discriminators are lists of dense layers (`params/disc_z/2/w` ->
`disc_z.2.w`).
"""

import json
from pathlib import Path
from typing import IO, Any, Union

import numpy as np
import torch

_META_KEY = "__meta__"


def save_flat(
    io: Union[str, Path, IO[bytes]], arrays: dict[str, np.ndarray], meta: dict
) -> None:
    "Write flat-keyed arrays + JSON metadata as one npz."
    if _META_KEY in arrays:
        raise ValueError(f"Arrays may not contain a key named {_META_KEY!r}")
    payload = dict(arrays)
    payload[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(io, **payload)


def load_flat(io: Union[str, Path, IO[bytes]]) -> tuple[dict[str, np.ndarray], dict]:
    "Read an npz written by `save_flat` (or by vamb_tpu): (arrays, meta)."
    with np.load(io, allow_pickle=False) as arrs:
        meta = json.loads(bytes(arrs[_META_KEY]).decode())
        arrays = {k: arrs[k] for k in arrs.files if k != _META_KEY}
    return arrays, meta


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    "Flatten nested dicts/lists of arrays into `vamb_tpu`'s slash-joined keys."
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _torch_key(flat_key: str) -> str:
    head, _, rest = flat_key.partition("/")
    parts = rest.split("/")
    if head == "params":
        return ".".join(parts)
    if head == "bn_state":  # bn_state/[<sub-VAE>/]<stack>/<i>/<mean|var>
        return ".".join(parts[:-1] + ["bn", parts[-1]])
    raise KeyError(f"not a model key: {flat_key!r}")


def _flat_key(torch_key: str) -> str:
    parts = torch_key.split(".")
    if len(parts) >= 4 and parts[-2] == "bn" and parts[-1] in ("mean", "var"):
        return "bn_state/" + "/".join(parts[:-2] + parts[-1:])
    return "params/" + "/".join(parts)


def params_from_jax(
    flat: Union[dict, str, Path, IO[bytes]],
) -> dict[str, torch.Tensor]:
    """A model's `state_dict` from `vamb_tpu` weights (VAE, Taxometer, VAEVAE, AAE).

    `flat` is a `vamb_tpu` model.npz (path or file), a dict of its flat
    keys, or {"params": tree, "bn_state": tree} with the JAX trees as
    numpy arrays. Load the result with the model's `load_state_dict`."""
    if not isinstance(flat, dict):
        flat, _ = load_flat(flat)
    elif "params" in flat and not isinstance(flat["params"], np.ndarray):
        flat = flatten_tree({"params": flat["params"], "bn_state": flat["bn_state"]})
    return {
        _torch_key(k): torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in flat.items()
    }


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    "The inverse of `params_from_jax`: `vamb_tpu`'s flat keys to numpy arrays."
    return {
        _flat_key(k): v.detach().cpu().numpy().astype(np.float32)
        for k, v in state_dict.items()
    }
