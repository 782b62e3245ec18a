"""The port's VAEVAE (TaxVamb's model) held against vamb_tpu's on the CPU, on
numpy-seeded inputs. Widths are symmetric ([32, 32]) where the dropout bank
matters, so both packages' banks slice the same bytes; NLABELS > 105 where
the label width matters.

* `kld_gauss`, the three losses (feature, labels, joint) and each sub-VAE's
  eval forward with carried weights: values and gradients within rtol 1e-5
  (gradient atol 1e-7 times the largest |entry|).
* One training step's losses with carried weights, the same batches, eps
  and dropout bank: the 10 metrics within rtol 1e-5 and the running
  BatchNorm statistics after it within rtol 1e-5 (each layer keeps its last
  call's statistics, made from the step's starting ones).
* Random streams: an epoch's two permutations, its bank and every step's
  four eps are array-equal to those of `vamb_tpu`'s key chain.
* Lockstep: five Adam steps of both packages' own `trainmodel` from one
  seed, for the flat_softmax head and the plain CE head: epoch metrics
  within rtol 1e-5; parameters and BatchNorm statistics within rtol 1e-5,
  atol 1e-6, but for at most 0.01% of elements, which must lie within one
  Adam step (lr, 1e-3) of each other. Why: the step lr * m / (sqrt(v) +
  eps) of a weight whose gradient is small next to eps (1e-8) follows the
  gradient's f32 rounding, and the two packages sum in other orders. In the
  CE case one labels-encoder weight (a label column seen once) has a
  first-step gradient of -3.488e-9 (float64); the port's float32 gradient
  is 3.8e-11 from it, vamb_tpu's (XLA's CPU order) 5.3e-10, so their first
  steps are 0.261 lr and 0.287 lr and the weight ends up to 2.7e-5 apart
  (how far depends on the host's float32 kernels); its later gradients
  are above 20 eps and add little. At the same weights every step's
  gradients of the two packages lie within f32 rounding of the float64
  gradient (at most 1.01e-6 from it). A first step lr * g / (|g| +
  eps) is less than lr in size whatever g's rounding, so one step bounds
  such an element. The flat_softmax case stays within atol 1e-6 (worst
  relative difference 7.2e-6 for an element of magnitude at least 1e-3).
* `encode_joint` of carried weights: equal except values that straddle a
  12-bit mask step, each exactly one step off; at most 0.5% of them more
  than 1e-6 apart (6 of 2,400 here). tests/test_torch_vae.py allows 0.1%
  for the VAE's encoder; the joint encoder's first layer sums ~250 inputs
  where the VAE's sums 111, and before the mask its mu differs from
  vamb_tpu's by 10.4 ulps on average (7.6 at the seed's weights), so
  about 10.4 / 4096 = 0.25% of values are expected to straddle a step.
* Divergence kept on purpose: with asymmetric widths `vamb_tpu`'s bank is
  sliced in the declared order `eddededde`, not the call order, and its
  training raises; the port builds the bank in call order and trains.
* `vaevae_model.npz` written by either package loads into the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vamb_torch.models import layers as t_layers
from vamb_torch.models import vaevae as tv
from vamb_torch.utils import threefry
from vamb_torch.utils.checkpoint import flatten_tree, params_from_jax, params_to_jax

from vamb_tpu.models import dataset as j_dataset
from vamb_tpu.models import hier as jh
from vamb_tpu.models import vaevae as jv
from vamb_tpu.taxonomy import ContigTaxonomy

S, NLATENT = 4, 8
SYM = [32, 32]


def make_data(n=300, seed=0, n_species=80):
    "A dataset and a taxonomy of more than 105 nodes, cut at random depths."
    rng = np.random.default_rng(seed)
    lineages = []
    for _ in range(n):
        g = int(rng.integers(0, n_species))
        full = ["D", f"P{g // 32}", f"C{g // 16}", f"O{g // 8}", f"G{g // 2}", f"s{g}"]
        cut = int(rng.integers(0, len(full) + 1))
        lineages.append(ContigTaxonomy(full[:cut]) if cut else None)
    nodes, ind, parents = jh.make_graph(lineages)
    targets = np.array([0 if t is None else ind[t.ranks[-1]] for t in lineages])
    ab = rng.gamma(1.0, 5.0, (n, S)).astype(np.float32)
    tnf = rng.normal(size=(n, 103)).astype(np.float32)
    lengths = rng.integers(2000, 50_000, n)
    return j_dataset.make_dataset(ab, tnf, lengths), nodes, parents, targets


DATA = make_data()
NLABELS = len(DATA[1])
assert NLABELS > 105


def models(hier_loss="flat_softmax", nhiddens=SYM, seed=7, dropout=0.2):
    _, nodes, parents, _ = DATA
    kw = dict(nhiddens=nhiddens, nlatent=NLATENT, hier_loss=hier_loss, seed=seed, dropout=dropout)
    return (jv.VAEVAE(S, NLABELS, nodes, parents, **kw),
            tv.VAEVAE(S, NLABELS, nodes, parents, device="cpu", **kw))


def flat_jax(model):
    return flatten_tree({"params": model.params, "bn_state": model.bn_state})


def _grads_close(t_grad, j_grad):
    j_grad = np.asarray(j_grad)
    scale = max(1.0, float(np.abs(j_grad).max()))
    np.testing.assert_allclose(t_grad, j_grad, rtol=1e-5, atol=1e-7 * scale)


def _value_and_grads(jf, tf, args):
    "jax value and gradients against the port's, for numpy `args`."
    jval, jgrads = jax.value_and_grad(jf, argnums=tuple(range(len(args))))(*args)
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tval = tf(*targs)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    for t, j in zip(targs, jgrads):
        _grads_close(np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy(), j)


def test_weights_from_one_seed():
    jm, tm = models()
    fj, ft = flat_jax(jm), params_to_jax(tm.state_dict())
    assert sorted(fj) == sorted(ft)
    for k in fj:
        assert np.array_equal(fj[k], ft[k]), k
    assert tm.n_input_labels == jm.n_input_labels == NLABELS


def test_kld_gauss_value_and_gradient():
    rng = np.random.default_rng(0)
    args = [rng.normal(size=(32, NLATENT)).astype(np.float32) * s for s in (1, 0.1, 1, 0.1)]
    _value_and_grads(jv.kld_gauss, tv.kld_gauss, args)


@pytest.mark.parametrize("hier_loss", ["flat_softmax", "cond_softmax", "soft_margin", None])
def test_losses_value_and_gradient(hier_loss):
    jm, tm = models(hier_loss)
    rng = np.random.default_rng(1)
    B = 48
    n_logits = tm.labels.out.w.shape[1]
    onehot = np.eye(tm.n_input_labels, dtype=np.float32)[DATA[3][:B]]
    depths = rng.dirichlet(np.ones(S), B).astype(np.float32)
    d_out = rng.dirichlet(np.ones(S), B).astype(np.float32)
    tnf, t_out = (rng.normal(size=(B, 103)).astype(np.float32) for _ in range(2))
    ab, a_out = (rng.normal(size=(B, 1)).astype(np.float32) for _ in range(2))
    mus = [rng.normal(size=(B, NLATENT)).astype(np.float32) for _ in range(3)]
    weights = rng.uniform(0.5, 2, (B, 1)).astype(np.float32)
    logits = rng.normal(size=(B, n_logits)).astype(np.float32)
    t = torch.from_numpy
    _value_and_grads(
        lambda d, m: jm._vamb_loss(depths, d, tnf, t_out, ab, a_out, m, weights)[0],
        lambda d, m: tm._vamb_loss(t(depths), d, t(tnf), t(t_out), t(ab), t(a_out), m,
                                   t(weights))[0],
        [d_out, mus[0]])
    for i in range(3):
        _value_and_grads(
            lambda lg, m: jm.calc_loss_labels(lg, onehot, m)[i],
            lambda lg, m: tm.calc_loss_labels(lg, torch.from_numpy(onehot), m)[i],
            [logits, mus[0]])
    for i in (0, 3, 4, 5):
        _value_and_grads(
            lambda d, lg, m0, m1, m2: jm.calc_loss_joint(
                depths, d, tnf, t_out, ab, a_out, lg, onehot, m0, m1, m2, weights)[i],
            lambda d, lg, m0, m1, m2: tm.calc_loss_joint(
                t(depths), d, t(tnf), t(t_out), t(ab), t(a_out), lg, t(onehot), m0, m1, m2,
                t(weights))[i],
            [d_out, logits, *mus])


def _carried(seed=3):
    "Both models on one set of weights with non-trivial BatchNorm."
    jm, tm = models()
    rng = np.random.default_rng(seed)
    fj = flat_jax(jm)
    for k, v in fj.items():
        if k.endswith(("/mean", "/bias")):
            fj[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
        elif k.endswith(("/var", "/scale")):
            fj[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    tm.load_state_dict(params_from_jax(fj))
    params, bn = {}, {}
    for k, v in fj.items():
        head, *path = k.split("/")
        node = params if head == "params" else bn
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(v)

    def listify(tree):
        if isinstance(tree, dict):
            if tree and all(k.isdigit() for k in tree):
                return [listify(tree[str(i)]) for i in range(len(tree))]
            return {k: listify(v) for k, v in tree.items()}
        return tree

    jm.params, jm.bn_state = listify(params), listify(bn)
    return jm, tm


def test_sub_vae_forwards_with_carried_weights():
    jm, tm = _carried()
    tm.eval()
    rng = np.random.default_rng(2)
    for name, sub_j, sub_t in (("vamb", jm.vamb, tm.vamb), ("labels", jm.labels_vae, tm.labels),
                               ("joint", jm.joint, tm.joint)):
        x = rng.normal(size=(40, sub_j.nin)).astype(np.float32)
        z = rng.normal(size=(40, NLATENT)).astype(np.float32)
        mu, _ = sub_j.encode(jm.params[name], jm.bn_state[name], x, False)
        rec, _ = sub_j.decode(jm.params[name], jm.bn_state[name], z, False)
        with torch.no_grad():
            np.testing.assert_allclose(sub_t.encode(torch.from_numpy(x)).numpy(), np.asarray(mu),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(sub_t.decode(torch.from_numpy(z)).numpy(), np.asarray(rec),
                                       rtol=1e-5, atol=1e-6)


def _batch(perm, bs, n_l):
    ds, _, _, targets = DATA
    idx = perm[:bs]
    onehot = np.eye(n_l, dtype=np.float32)[targets[idx]]
    return (ds.depths[idx], ds.tnf[idx], ds.abundance[idx], ds.weights[idx], onehot)


def test_one_step_losses_and_batchnorm_with_carried_weights():
    jm, tm = _carried()
    bs = 64
    rng = np.random.default_rng(4)
    sup = _batch(rng.permutation(300), bs, tm.n_input_labels)
    uns = _batch(rng.permutation(300), bs, tm.n_input_labels)
    key_t = threefry.key(11)
    bank_t = tm._draw_dropout_bank(key_t, bs)
    bank_j = jm._draw_dropout_bank(jax.random.key(11), bs)
    sub = (12345, 678)
    keys = threefry.split_host(sub, 12)
    eps = threefry.normal_batched([keys[i] for i in (1, 3, 6, 10)], bs * NLATENT).reshape(
        4, bs, NLATENT)
    rot = np.uint8(3 * 97 % 256)
    _, new_bn, j_metrics = jm._step_losses(
        jm.params, jm.bn_state, sup, uns, jnp.asarray(np.array(sub, np.uint32)),
        bank=[b + rot for b in bank_j])
    tm.train()
    _, t_metrics = tm.step_losses(
        tuple(map(torch.from_numpy, sup)), tuple(map(torch.from_numpy, uns)), eps,
        t_layers.step_bank(bank_t, 3), tm._bn_base())
    np.testing.assert_allclose(t_metrics.numpy(), np.asarray(j_metrics), rtol=1e-5)
    fj = flatten_tree({"bn_state": new_bn})
    ft = params_to_jax(tm.state_dict())
    for k, v in fj.items():
        np.testing.assert_allclose(ft[k], np.asarray(v), rtol=1e-5, atol=1e-7, err_msg=k)


def test_epoch_draws_are_jaxs():
    jm, tm = models()
    n, bs, nb = 300, 60, 5
    _, key = jax.random.split(jax.random.key(7))
    k_sup, k_uns, scan_key, bank_key = jax.random.split(key, 4)
    j_eps = []
    for _ in range(nb):
        scan_key, sub = jax.random.split(scan_key)
        keys = jax.random.split(sub, 12)
        j_eps.append([np.asarray(jax.random.normal(keys[i], (bs, NLATENT))) for i in (1, 3, 6, 10)])
    j_bank = jm._draw_dropout_bank(bank_key, bs)
    _, perm_sup, perm_uns, bank, eps = tm.epoch_draws(tm.rng, n, bs, nb)
    assert np.array_equal(perm_sup.numpy(), np.asarray(jax.random.permutation(k_sup, n))[: nb * bs])
    assert np.array_equal(perm_uns.numpy(), np.asarray(jax.random.permutation(k_uns, n))[: nb * bs])
    assert np.array_equal(eps.numpy(), np.array(j_eps))
    for j_slice, t_slice in zip(j_bank, t_layers.step_bank(bank, 0)):
        assert np.array_equal(t_slice.numpy(), np.asarray(j_slice))


def _metrics(lines):
    return [[float(x.split(": ")[1]) for x in line.split("  ")[1:11]]
            for line in lines if "Epoch:" in line]


LR = 1e-3  # VAEVAE's Adam (vamb_tpu/models/vaevae.py:466)


@pytest.mark.parametrize("hier_loss", ["flat_softmax", None])
def test_five_adam_steps_lockstep(hier_loss):
    jm, tm = models(hier_loss)
    ds, _, _, targets = DATA
    j_log, t_log = [], []
    kw = dict(nepochs=1, batchsize=60, batchsteps=[])
    jm.trainmodel(ds, targets, logger=j_log.append, **kw)
    tm.trainmodel(ds, targets, logger=t_log.append, **kw)
    np.testing.assert_allclose(_metrics(t_log), _metrics(j_log), rtol=1e-5)
    fj, ft = flat_jax(jm), params_to_jax(tm.state_dict())
    outside = 0
    for k in fj:
        # the few elements outside the band below: within one Adam step
        np.testing.assert_allclose(ft[k], fj[k], rtol=1e-5, atol=LR, err_msg=k)
        outside += int((np.abs(ft[k] - fj[k]) > 1e-6 + 1e-5 * np.abs(fj[k])).sum())
    assert outside <= sum(v.size for v in fj.values()) // 10_000, outside
    assert np.array_equal(tm.rng.numpy(), np.asarray(jax.random.key_data(jm.rng)))


def test_encode_joint_equal_but_mask_straddles():
    jm, tm = _carried()
    ds, _, _, targets = DATA
    lj = jm.encode_joint(ds, targets)
    lt = tm.encode_joint(ds, targets)
    assert lt.shape == (300, NLATENT) and lt.dtype == np.float32
    assert not (lt.view(np.uint32) & 0xFFF).any()
    differ = lj != lt
    steps = np.abs(lt.view(np.int32).astype(np.int64) - lj.view(np.int32))
    assert (steps[differ] == 4096).all(), steps[differ]
    far = np.abs(lt - lj) > 1e-6
    assert far.sum() <= lt.size * 5 // 1000, far.sum()


def test_asymmetric_widths_divergence():
    "vamb_tpu's bank follows `eddededde`, the calls `eddedeede`: it raises."
    jm, tm = models(nhiddens=[32, 16])
    ds, _, _, targets = DATA
    with pytest.raises(Exception):
        jm.trainmodel(ds, targets, nepochs=1, batchsize=60, batchsteps=[])
    assert tv._STACK_KINDS == "eddedeede" and jv.VAEVAE._STACK_KINDS == "eddededde"
    before = tm.joint.enc[0].dense.w.detach().clone()
    tm.trainmodel(ds, targets, nepochs=1, batchsize=60, batchsteps=[])
    assert not torch.equal(before, tm.joint.enc[0].dense.w)
    widths = tm._bank_widths()
    assert widths == [32, 16, 16, 32, 16, 32, 32, 16, 16, 32, 32, 16, 32, 16, 16, 32, 32, 16]


def test_vaevae_model_npz_both_ways(tmp_path):
    jm, tm = _carried(5)
    jm.save(tmp_path / "j.npz")
    tm.save(tmp_path / "t.npz")
    from_j = tv.VAEVAE.load(tmp_path / "j.npz", device="cpu")
    from_t = jv.VAEVAE.load(str(tmp_path / "t.npz"))
    fj = flat_jax(jm)
    for k, v in params_to_jax(from_j.state_dict()).items():
        assert np.array_equal(v, np.asarray(fj[k])), k
    for k, v in flat_jax(from_t).items():
        assert np.array_equal(np.asarray(v), np.asarray(fj[k])), k
    assert from_j.meta() == tm.meta()
