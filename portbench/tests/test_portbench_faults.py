"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, a whole run driven on the CPU at a tiny
size with each fault the cell can have planted in the program."""

import pytest

import tiny

FAULTS = ["state_unchanged", "half_batch", "answer_altered"]


@pytest.mark.parametrize("workload", ["train.vamb_s10.sched", "cluster.vamb_s10.300k",
                                      "cluster.avamb_s10.z283.100k"])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_makes_the_run_incorrect(workload, fault):
    result, checks = tiny.run(workload, fault=fault)
    assert not result["correct"], checks
    assert result["failed"] == result["attempted"]
    assert list(result)[-1] == "checks"


def test_the_same_run_without_a_fault_is_correct():
    result, _ = tiny.run("cluster.avamb_s10.z283.100k")
    assert result["correct"]
