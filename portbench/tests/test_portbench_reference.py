"""The plain references agree with the port at a tiny size on the CPU:
the training steps' reference with `VAE.trainmodel`'s first steps, the
clustering rule with a whole job of `ClusterGenerator`, and the
reference's threefry draws with the port's."""

import numpy as np
import pytest
import torch

import tiny
from portbench.reference import cluster_check, vae_steps
from portbench.reference import threefry as ref_tf


@pytest.mark.parametrize("workload", ["train.vamb_s10.sched", "cluster.vamb_s10.300k"])
def test_the_port_passes_its_check_at_a_tiny_size(workload):
    result, checks = tiny.run(workload)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 1


def test_training_reference_follows_the_port_closely():
    _, checks = tiny.run("train.vamb_s10.sched", seed=12345)
    assert checks["loss_gap"][0] < 1e-6
    assert checks["first_grad_gap"][0] < 1e-5


@pytest.mark.parametrize("seed", [0, 2**33 + 5])
def test_reference_threefry_is_the_ports(seed):
    from vamb_torch.utils import threefry

    k = ref_tf.key(seed)
    assert ref_tf.split(k, 3) == threefry.split_host(threefry.key(seed), 3)
    assert np.array_equal(ref_tf.bits(k, 999), threefry.bits(threefry.key(seed), 999).numpy())
    assert np.array_equal(ref_tf.permutation(k, 5000),
                          threefry.permutation(threefry.key(seed), 5000).numpy())
    sub = ref_tf.split(k)[1]
    want = threefry.normal_batched([sub], 4096)[0].double().numpy()
    assert np.abs(ref_tf.normal(sub, 4096) - want).max() < 1e-4


def test_reference_dataset_is_the_ports_normalization():
    from vamb_torch.models import make_dataset

    rng = np.random.default_rng(3)
    ab = rng.lognormal(size=(500, 4)).astype(np.float32)
    tnf = rng.normal(size=(500, 103)).astype(np.float32)
    lengths = rng.integers(2000, 4000, 500).astype(np.float32)
    want = np.concatenate(make_dataset(ab.copy(), tnf.copy(), lengths), axis=1)
    assert np.allclose(vae_steps.dataset(ab, tnf, lengths), want, rtol=1e-5, atol=1e-5)


def test_reference_initial_weights_are_the_ports():
    from vamb_torch.models import VAE

    vae = VAE(4, nhiddens=[64, 64], nlatent=8, seed=99, device="cpu")
    model = vae_steps.Model({"nsamples": 4, "nhiddens": [64, 64], "nlatent": 8}, 99, "cpu")
    for name, p in zip(model.names, vae.parameters_flat_order()):
        assert torch.equal(model.p[name].float(), p.detach()), name


def _judge(x, clusters):
    return cluster_check.check(x, np.full(len(x), 1000.0), clusters, "cpu")


def test_cluster_rule_flags_a_misassigned_point():
    x = np.array([[1, 0], [1, 0.01], [0, 1], [0.02, 1]], np.float32)
    good = [(0, np.array([0, 1]), 0.06, "fallback"), (2, np.array([2, 3]), 0.06, "fallback")]
    assert _judge(x, good)["misassigned_gap"] == 0.0
    bad = [(0, np.array([0]), 0.06, "fallback"), (2, np.array([1, 2, 3]), 0.06, "fallback")]
    got = _judge(x, bad)
    assert got["misassigned_gap"] > 0.01 and got["clusters_wrong"] == 2
    loner = [(0, np.array([0]), None, "loner"), (1, np.array([1]), None, "loner"),
             (2, np.array([2, 3]), 0.06, "fallback")]
    assert _judge(x, loner)["misassigned_gap"] > 0.0
    missing = [(0, np.array([0, 1]), 0.06, "fallback"), (2, np.array([2]), 0.0, "fallback")]
    assert _judge(x, missing)["partition_errors"] == 1


def test_valley_scan_finds_the_valley_between_two_peaks():
    hist = np.zeros(60)
    hist[:5], hist[30:40] = 100.0, 80.0
    assert cluster_check.threshold_bin(hist @ cluster_check._SMOOTH) == 17
    rising = np.zeros(60)
    rising[25:35] = 100.0  # the first peak past x = 0.1: no threshold
    assert cluster_check.threshold_bin(rising @ cluster_check._SMOOTH) is None


def test_cluster_rule_flags_a_wrong_radius():
    """A clump of 40 points around one medoid and another clump far off: the
    scan's threshold lies in the valley between; a radius a bin off, or a
    fallback where the scan finds a threshold, is wrong."""
    rng = np.random.default_rng(5)
    a = np.array([1.0, 0, 0]) + 0.02 * rng.normal(size=(40, 3))
    b = np.array([0.6, 0.8, 0]) + 0.02 * rng.normal(size=(40, 3))
    x = np.concatenate([a, b]).astype(np.float32)
    lengths = np.full(len(x), 1000.0)
    xn = cluster_check.normalized(x, "cpu")
    d = (0.5 - xn[0] @ xn.T).numpy()
    d[0] = 0.0
    hist = np.zeros(60)
    np.add.at(hist, np.minimum(d[d <= 0.3] // 0.005, 59).astype(int), 1000.0)
    thr = cluster_check.threshold_bin(hist @ cluster_check._SMOOTH)
    assert thr is not None
    radius = float(np.float32(thr * 0.005))
    members = np.flatnonzero(d <= radius)
    rest = np.setdiff1d(np.arange(len(x)), members)
    tail = [(int(i), np.array([i]), None, "loner") for i in rest]

    def judged(first):
        return cluster_check.check(x, lengths, [first] + tail, "cpu")["radius_errors"]

    assert judged((0, members, radius, "normal")) == 0
    assert judged((0, members, radius + 0.005, "normal")) == 1
    assert judged((0, members, 0.06, "fallback")) == 1


def test_training_check_follows_set_up_and_each_batch_size_of_the_window():
    """Set-up's first steps are followed from the seed, and the window's
    first unit at each batch size of its schedule from the program's
    state there, on the epochs' own draws."""
    from types import SimpleNamespace

    from portbench.lib.harness import load_module

    c = tiny.cell("train.vamb_s10.sched")
    window = load_module(c.window_path, "w_sched_check")
    run = SimpleNamespace(config=c.config, traffic=c.traffic, seed=2**33 + 21, device=torch.device("cpu"),
                          fault=None, control=None)
    window.setup(run)
    work = window.window(run, 0.0, None)
    window.release(run)
    numbers, attempted = window.check(run, work)
    assert attempted == 1 and set(numbers) == set(c.limits)
    sizes = window.schedule(c.config, c.traffic["contigs"])
    assert [(d["batch"], d["chain"]) for d in run.check_detail] == \
        [(sizes[0], 0)] + [(bs, run.epochs - len(sizes) + e) for e, bs in enumerate(sizes)
                           if e == 0 or bs != sizes[e - 1]]
    assert all(d["loss_gap"] < 1e-6 for d in run.check_detail), run.check_detail
