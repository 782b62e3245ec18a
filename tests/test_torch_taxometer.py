"""The port's Taxometer held against vamb_tpu's on the CPU, on numpy-seeded
inputs, for each of the three loss heads.

* Weights: a seed draws the same weights in both packages, and
  `params_from_jax`/`params_to_jax` carry them across exactly.
* Eval-mode probabilities with carried weights (BatchNorm statistics made
  non-trivial): within atol 1e-6; the thresholded predictions equal.
* Random streams: an epoch's permutation and dropout bank from the port's
  key chain are array-equal to those of `vamb_tpu`'s `make_scan_epoch_fn`
  chain (`split(rng)`, then `split(key, 3)` into permutation, step and bank
  keys, even without dropout).
* Lockstep: ten D-Adaptation steps (two epochs of five) of both packages'
  own `trainmodel` from one seed, dropout on and off: the epoch losses
  within rtol 1e-5 and every parameter and BatchNorm statistic within rtol
  1e-5, atol 1e-7 (worst relative differences seen over the 6 cases:
  3.9e-7 for a parameter of magnitude at least 1e-3, 2.0e-7 for a loss).
* `predictor_model.npz` written by either package loads into the other.
"""

import io

import jax
import numpy as np
import pytest
import torch

from vamb_torch.models import layers as t_layers
from vamb_torch.models.taxometer import Taxometer as TTaxometer
from vamb_torch.utils import threefry
from vamb_torch.utils.checkpoint import flatten_tree, params_from_jax, params_to_jax

from vamb_tpu.models import dataset as j_dataset
from vamb_tpu.models import hier as jh
from vamb_tpu.models.taxometer import Taxometer as JTaxometer
from vamb_tpu.taxonomy import ContigTaxonomy

S = 4
NHIDDENS = [32, 16]
LOSSES = ["flat_softmax", "cond_softmax", "soft_margin"]


def make_data(n=320, seed=0):
    "A dataset, and a taxonomy cut at random depths (some contigs unlabelled)."
    rng = np.random.default_rng(seed)
    lineages = []
    for _ in range(n):
        g = int(rng.integers(0, 16))
        full = ["D", f"P{g // 8}", f"C{g // 4}", f"G{g // 2}", f"s{g}"]
        cut = int(rng.integers(0, len(full) + 1))
        lineages.append(ContigTaxonomy(full[:cut]) if cut else None)
    nodes, ind, parents = jh.make_graph(lineages)
    targets = np.array([0 if t is None else ind[t.ranks[-1]] for t in lineages])
    ab = rng.gamma(1.0, 5.0, (n, S)).astype(np.float32)
    tnf = rng.normal(size=(n, 103)).astype(np.float32)
    lengths = rng.integers(2000, 50_000, n)
    return j_dataset.make_dataset(ab, tnf, lengths), nodes, parents, targets


DATA = make_data()


def models(hier_loss, dropout=0.2, seed=5):
    _, nodes, parents, _ = DATA
    kw = dict(nhiddens=NHIDDENS, hier_loss=hier_loss, dropout=dropout, seed=seed)
    return (JTaxometer(S, len(nodes), nodes, parents, **kw),
            TTaxometer(S, len(nodes), nodes, parents, device="cpu", **kw))


def flat_jax(model):
    return flatten_tree({"params": model.params, "bn_state": model.bn_state})


@pytest.mark.parametrize("hier_loss", LOSSES)
def test_weights_from_one_seed_and_carried_across(hier_loss):
    jm, tm = models(hier_loss)
    fj, ft = flat_jax(jm), params_to_jax(tm.state_dict())
    assert sorted(fj) == sorted(ft)
    for k in fj:
        assert np.array_equal(fj[k], ft[k]), k
    back = params_to_jax(params_from_jax({"params": jm.params, "bn_state": jm.bn_state}))
    assert all(np.array_equal(back[k], fj[k]) for k in fj)


def _perturbed(jm, seed):
    "vamb_tpu weights with non-trivial BatchNorm parameters and statistics."
    rng = np.random.default_rng(seed)
    fj = flat_jax(jm)
    for k, v in fj.items():
        if k.endswith(("/mean", "/bias")):
            fj[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
        elif k.endswith(("/var", "/scale")):
            fj[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return fj


def _unflatten(jm, fj):
    params, bn = jm.params, jm.bn_state
    for i, (p, s) in enumerate(zip(params["enc"], bn["enc"])):
        for name in ("scale", "bias"):
            p["bn"][name] = fj[f"params/enc/{i}/bn/{name}"]
        for name in ("mean", "var"):
            s[name] = fj[f"bn_state/enc/{i}/{name}"]


@pytest.mark.parametrize("hier_loss", LOSSES)
def test_eval_probabilities_with_carried_weights(hier_loss):
    jm, tm = models(hier_loss)
    fj = _perturbed(jm, 3)
    _unflatten(jm, fj)
    tm.load_state_dict(params_from_jax(fj))
    ds = DATA[0]
    (jp, jpred), = list(jm.predict(ds))
    (tp, tpred), = list(tm.predict(ds))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    assert np.array_equal(tpred, jpred)
    # a chunk smaller than the dataset gives the same rows
    tp2 = np.concatenate([p for p, _ in tm.predict(ds, chunk=100)])
    np.testing.assert_allclose(tp2, tp, rtol=0, atol=1e-7)


@pytest.mark.parametrize("dropout", [0.2, 0.0])
def test_epoch_draws_are_jaxs(dropout):
    jm, tm = models("flat_softmax", dropout=dropout)
    n, bs = DATA[0].n_obs, 64
    rng_j = jax.random.key(5)
    _, key = jax.random.split(rng_j)
    perm_key, _scan, extra_key = jax.random.split(key, 3)
    j_perm = np.asarray(jax.random.permutation(perm_key, n))
    j_bank = jm._draw_dropout_bank(extra_key, bs)

    _, key_t = threefry.split_host(tm.rng)
    perm_t, _scan_t, extra_t = threefry.split_host(key_t, 3)
    assert np.array_equal(threefry.permutation(perm_t, n).numpy(), j_perm)
    t_bank = tm._draw_dropout_bank(extra_t, bs)
    if dropout == 0.0:
        assert j_bank is None and t_bank is None
        return
    for step in (0, 3):
        rot = np.uint8((step * 97) % 256)
        for j_slice, t_slice in zip(j_bank, t_layers.step_bank(t_bank, step)):
            assert np.array_equal(t_slice.numpy(), np.asarray(j_slice) + rot)


def _losses(lines):
    return [float(line.split("CE: ")[1].split("\t")[0]) for line in lines if "Epoch:" in line]


@pytest.mark.parametrize("dropout", [0.2, 0.0])
@pytest.mark.parametrize("hier_loss", LOSSES)
def test_ten_steps_lockstep(hier_loss, dropout):
    jm, tm = models(hier_loss, dropout=dropout)
    ds, _, _, targets = DATA
    j_log, t_log = [], []
    kw = dict(nepochs=2, batchsize=64, batchsteps=[])
    jm.trainmodel(ds, targets, logger=j_log.append, **kw)
    tm.trainmodel(ds, targets, logger=t_log.append, **kw)
    np.testing.assert_allclose(_losses(t_log), _losses(j_log), rtol=1e-5)
    fj, ft = flat_jax(jm), params_to_jax(tm.state_dict())
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert np.array_equal(tm.rng.numpy(), np.asarray(jax.random.key_data(jm.rng)))


@pytest.mark.parametrize("hier_loss", LOSSES)
def test_predictor_model_npz_both_ways(hier_loss, tmp_path):
    jm, tm = models(hier_loss)
    fj = _perturbed(jm, 4)
    _unflatten(jm, fj)
    tm.load_state_dict(params_from_jax(fj))
    jm.save(tmp_path / "j.npz")
    tm.save(tmp_path / "t.npz")
    from_j = TTaxometer.load(tmp_path / "j.npz", device="cpu")
    from_t = JTaxometer.load(str(tmp_path / "t.npz"))
    for k, v in params_to_jax(from_j.state_dict()).items():
        assert np.array_equal(v, fj[k]), k
    for k, v in flat_jax(from_t).items():
        assert np.array_equal(np.asarray(v), fj[k]), k
    assert from_j.meta() == tm.meta()
    assert from_j.nodes == jm.nodes and from_t.table_parent == tm.table_parent
    buf = io.BytesIO()
    tm.save(buf)
    buf.seek(0)
    assert torch.equal(TTaxometer.load(buf, device="cpu").out.w, tm.out.w)
