"""The output check's control on the card: the program computed one
precision below what its configuration states must come out not correct,
while the program as configured comes out correct. At sizes a test run
holds: a cluster cell's whole job (the bfloat16 distances) and the
training cell's first steps (TF32 products and the bfloat16 training),
each on three seeds. About six minutes on one H100."""

import json

import pytest

import tiny  # noqa: F401
from tiny import ROOT


def _limits(workload):
    return json.loads((ROOT / "portbench" / "limits" / f"{workload}.json").read_text())


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _fails(numbers, limits):
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,fails", [("program", False), ("control_tf32", True),
                                        ("control_bf16", True)])
def test_training_control(mode, fails):
    from portbench.tests.readings import readings

    dev = _card()
    w = "train.vamb_s10.sched"
    for rec in readings(w, mode, [2**33 + 1, 2**33 + 2, 2**33 + 3], dev):
        assert _fails(rec["numbers"], _limits(w)) == fails, rec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["cluster.vamb_s10.300k", "cluster.avamb_s10.z283.100k"])
def test_cluster_control(workload):
    from portbench.tests.readings import readings

    dev = _card()
    for mode, fails in (("program", False), ("control_bf16", True)):
        for rec in readings(workload, mode, [2**33 + 11, 2**33 + 12, 2**33 + 13], dev):
            assert _fails(rec["numbers"], _limits(workload)) == fails, rec
