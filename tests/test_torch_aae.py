"""The port's AAE (Avamb's model) held against vamb_tpu's on the CPU, on
numpy-seeded inputs, at small widths (h 32, z 8, y 12, as
tests/test_parity_aae.py).

* One seed gives both packages the same weights, key for key.
* With weights carried across (`params_from_jax`, BatchNorm randomized):
  encode and decode in eval and training mode, the running statistics a
  training-mode call leaves, both discriminators: within rtol 1e-5, atol
  1e-6 (atol 1e-5 for the decoder's TNF output, whose entries reach ~10).
* `calc_loss` (multi-sample CE and single-sample SSE) and `_bce`: values
  and gradients within rtol 1e-5; `_bce` at exact saturation finite, with a
  zero gradient through the sigmoid, as vamb_tpu's.
* An epoch's step draws (eps, z prior, eps2 and the Gumbel-softmax y prior)
  from `vamb_tpu`'s five-way key split: the normals and the prior's
  Gumbel values array-equal to jax's, the prior's softmax within rtol 1e-6.
* Lockstep: 10 steps of both packages' own `trainmodel` from one seed (7 at
  batch 16, then 3 at 32 after the doubling): the six epoch metrics within
  rtol 1e-5 (the log's 6 digits), parameters and BatchNorm statistics
  within rtol 1e-4, atol 1e-6, and the key chain equal. Apart: the dense
  biases that feed a BatchNorm, and its running means. Such a bias has a
  gradient of zero but for rounding, which differs between the packages,
  and Adam scales it to a step of ~lr (1e-3) all the same: they are held
  within 10 steps x lr (1.6e-3 apart here; every other element within
  1e-6 + 1e-4 |x|, most within 1e-7).
* `get_latents` of carried weights: mu within rtol 1e-5, atol 1e-6; the y
  clusters equal.
* `aae_model.npz` written by either package loads into the other.
* Training at the default widths on data where a discriminator saturates
  stays finite (tests/test_aae.py's case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vamb_torch.models import aae as ta
from vamb_torch.utils import threefry
from vamb_torch.utils.checkpoint import flatten_tree, params_from_jax, params_to_jax

from vamb_tpu.models import aae as ja
from vamb_tpu.models import dataset as j_dataset

from .test_aae import make_ds

S, H, LD, YLEN = 4, 32, 8, 12


def models(nsamples=S, seed=9):
    kw = dict(nhiddens=H, nlatent_z=LD, nlatent_y=YLEN, seed=seed)
    return ja.AAE(nsamples, **kw), ta.AAE(nsamples, device="cpu", **kw)


def flat_jax(model):
    return flatten_tree({"params": model.params, "bn_state": model.bn_state})


def unflatten(flat):
    "vamb_tpu's (params, bn_state) trees from flat keys."
    params, bn = {}, {}
    for k, v in flat.items():
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

    return listify(params), listify(bn)


def carried(nsamples=S, seed=3):
    "Both models on one set of weights with non-trivial BatchNorm."
    jm, tm = models(nsamples)
    rng = np.random.default_rng(seed)
    fj = flat_jax(jm)
    for k, v in fj.items():
        if k.endswith(("/mean", "/bn/bias")):
            fj[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
        elif k.endswith(("/var", "/scale")):
            fj[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    tm.load_state_dict(params_from_jax(fj))
    jm.params, jm.bn_state = unflatten(fj)
    return jm, tm


def batch(b=64, nsamples=S, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.dirichlet(np.ones(nsamples), b).astype(np.float32),
            rng.normal(size=(b, 103)).astype(np.float32))


def test_weights_from_one_seed():
    jm, tm = models()
    fj, ft = flat_jax(jm), params_to_jax(tm.state_dict())
    assert sorted(fj) == sorted(ft)
    for k in fj:
        assert np.array_equal(np.asarray(fj[k]), ft[k]), k
    assert (tm.alpha, tm.input_len, tm.h_n, tm.ld, tm.y_len) == (
        jm.alpha, jm.input_len, jm.h_n, jm.ld, jm.y_len)


def test_defaults_and_checks():
    tm = ta.AAE(3, device="cpu")
    assert (tm.h_n, tm.ld, tm.y_len, tm.sl, tm.slr, tm.alpha) == (547, 283, 700, 0.00964, 0.5, 0.15)
    assert ta.AAE(1, nhiddens=8, nlatent_z=2, nlatent_y=2, device="cpu").alpha == 0.5
    for kw in ({"nsamples": 0}, {"nsamples": 3, "nlatent_z": 0}, {"nsamples": 3, "sl": 1.5}):
        with pytest.raises(ValueError):
            ta.AAE(device="cpu", **kw)
    if not torch.cuda.is_available():  # the card is the default; without one it raises
        with pytest.raises(RuntimeError, match="CUDA"):
            ta.AAE(3, nhiddens=8, nlatent_z=2, nlatent_y=2)


@pytest.mark.parametrize("train", [False, True])
def test_encode_decode_discriminators_with_carried_weights(train):
    jm, tm = carried()
    depths, tnf = batch()
    rng = np.random.default_rng(2)
    z = rng.normal(size=(64, LD)).astype(np.float32)
    y = rng.dirichlet(np.ones(YLEN), 64).astype(np.float32)
    mu, logvar, yj, enc_s = jm.encode_apply(jm.params, jm.bn_state, depths, tnf, train)
    d_out, t_out, dec_s = jm.decode_apply(jm.params, jm.bn_state, z, y, train)
    tm.train(train)
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(depths), torch.from_numpy(tnf))
        got_dec = tm.decode(torch.from_numpy(z), torch.from_numpy(y))
        dz = tm.discriminate(tm.disc_z, torch.from_numpy(z))
        dy = tm.discriminate(tm.disc_y, torch.from_numpy(y))
    for a, b in zip(got, (mu, logvar, yj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_dec[0].numpy(), np.asarray(d_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_dec[1].numpy(), np.asarray(t_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dz.numpy(), np.asarray(jm._disc(jm.params["disc_z"], z)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dy.numpy(), np.asarray(jm._disc(jm.params["disc_y"], y)),
                               rtol=1e-5, atol=1e-6)
    if train:
        fj = flatten_tree({"bn_state": {"enc": enc_s, "dec": dec_s}})
        ft = params_to_jax(tm.state_dict())
        for k, v in fj.items():
            np.testing.assert_allclose(ft[k], np.asarray(v), rtol=1e-5, atol=1e-7, err_msg=k)


def _value_and_grads(jf, tf, args):
    jval, jgrads = jax.value_and_grad(jf, argnums=tuple(range(len(args))))(*args)
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tval = tf(*targs)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    for t, j in zip(targs, jgrads):
        j = np.asarray(j)
        grad = np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(grad, j, rtol=1e-5, atol=1e-7 * max(1.0, np.abs(j).max()))


@pytest.mark.parametrize("nsamples", [S, 1])
def test_calc_loss_value_and_gradient(nsamples):
    jm, tm = models(nsamples)
    rng = np.random.default_rng(4)
    d_in, t_in = batch(48, nsamples, seed=5)
    d_out = rng.dirichlet(np.ones(nsamples), 48).astype(np.float32)
    t_out = rng.normal(size=(48, 103)).astype(np.float32)
    for i in range(3):
        _value_and_grads(lambda d, t: jm.calc_loss(d_in, d, t_in, t)[i],
                         lambda d, t: tm.calc_loss(torch.from_numpy(d_in), d, torch.from_numpy(t_in), t)[i],
                         [d_out, t_out])


def test_bce_value_gradient_and_saturation():
    rng = np.random.default_rng(6)
    p = rng.uniform(0.01, 0.99, (32, 1)).astype(np.float32)
    for target in (np.ones((32, 1), np.float32), np.zeros((32, 1), np.float32)):
        _value_and_grads(lambda q: ja.AAE._bce(q, target),
                         lambda q: ta._bce(q, torch.from_numpy(target)), [p])
    # through an exactly saturated sigmoid: the same finite value, no NaN gradient
    for logit, tval in ((30.0, 0.0), (-120.0, 1.0), (30.0, 1.0), (-120.0, 0.0)):
        x = torch.tensor([logit], requires_grad=True)
        got = ta._bce(torch.sigmoid(x), torch.tensor([tval]))
        got.backward()
        jval, jgrad = jax.value_and_grad(
            lambda v: ja.AAE._bce(jax.nn.sigmoid(v), jnp.array([tval])))(jnp.float32(logit))
        assert np.isfinite(float(got.detach())) and np.isfinite(float(x.grad[0]))
        np.testing.assert_allclose(float(got.detach()), float(jval), rtol=1e-6)
        assert float(x.grad[0]) == float(jgrad) == 0.0


def test_step_draws_are_jaxs():
    jm, tm = models()
    bs, nb, temp = 16, 3, 0.1596
    key = jax.random.key(7)
    j_draws, t_keys = [], []
    for _ in range(nb):
        key, k_eps, k_pz, k_py, k_eps2 = jax.random.split(key, 5)
        j_draws.append([np.asarray(jax.random.normal(k_eps, (bs, LD))),
                        np.asarray(jax.random.normal(k_pz, (bs, LD))),
                        np.asarray(jm._gumbel_softmax_prior(k_py, bs, temp)),
                        np.asarray(jax.random.normal(k_eps2, (bs, LD)))])
        t_keys.append(tuple(tuple(int(w) for w in jax.random.key_data(k))
                            for k in (k_eps, k_pz, k_py, k_eps2)))
    # the same keys from the port's own split of the chain
    t_key = threefry.key(7)
    for ks in t_keys:
        t_key, *subs = threefry.split_host(t_key, 5)
        assert tuple(subs) == ks
    t_draws = tm._step_draws(t_keys, bs, temp)
    for jd, td in zip(j_draws, t_draws):
        for i in (0, 1, 3):
            assert np.array_equal(td[i].numpy(), jd[i])
        np.testing.assert_allclose(td[2].numpy(), jd[2], rtol=1e-6, atol=1e-12)
    # the prior's Gumbel values before the softmax: XLA's CPU log, bit for bit
    k_py = jax.random.key_data(jax.random.split(jax.random.key(3), 5)[3])
    u_j = jax.random.uniform(jax.random.wrap_key_data(k_py), (bs, YLEN))
    g_j = -jnp.log(-jnp.log(u_j + 1e-20) + 1e-20)
    u_t = threefry.uniform_batched([tuple(int(w) for w in k_py)], bs * YLEN).reshape(bs, YLEN)
    g_t = -threefry.log_xla(-threefry.log_xla(u_t + 1e-20) + 1e-20)
    assert np.array_equal(u_t.numpy(), np.asarray(u_j))
    assert np.array_equal(g_t.numpy().view(np.int32), np.asarray(g_j).view(np.int32))


def _metrics(lines):
    out = []
    for line in lines:
        if "Epoch:" in line:
            fields = line.split("Loss Enc/Dec: ")[1]
            out.append([float(x.split()[0]) for x in fields.split(": ")[0:1] + fields.split(": ")[1:6]])
    return out


def test_ten_steps_lockstep():
    jm, tm = models(seed=11)
    ds = make_ds(n=112, s=S, seed=2)
    j_log, t_log = [], []
    kw = dict(nepochs=2, batchsize=16, batchsteps=[1])
    jm.trainmodel(ds, logger=j_log.append, **kw)
    tm.trainmodel(ds, logger=t_log.append, **kw)
    assert [ln.split("Batchsize:")[1].split()[0] for ln in t_log if "Epoch:" in ln] == ["16", "32"]
    mj, mt = _metrics(j_log), _metrics(t_log)
    assert len(mj) == len(mt) == 2 and all(len(r) == 6 for r in mj)
    np.testing.assert_allclose(mt, mj, rtol=1e-5)
    fj, ft = flat_jax(jm), params_to_jax(tm.state_dict())
    for k in fj:
        # a dense bias that feeds a BatchNorm has a gradient of zero but for
        # rounding, which Adam scales to a step of ~lr each: such a bias and
        # the running mean that follows it drift apart by up to ~lr a step
        pre_bn = k.endswith("/dense/b") or k.endswith("/mean")
        np.testing.assert_allclose(ft[k], np.asarray(fj[k]), rtol=1e-4,
                                   atol=10 * 1e-3 if pre_bn else 1e-6, err_msg=k)
    assert np.array_equal(tm.rng.numpy(), np.asarray(jax.random.key_data(jm.rng)))


def test_get_latents_with_carried_weights():
    jm, tm = carried(seed=8)
    ds = make_ds(n=300, s=S, seed=4)
    names = [f"c{i}" for i in range(ds.n_obs)]
    yj, lj = jm.get_latents(names, ds)
    yt, lt = tm.get_latents(names, ds)
    assert lt.shape == (300, LD) and lt.dtype == np.float32
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-6)
    assert yt == yj and list(yt) == list(yj)


def test_aae_model_npz_both_ways(tmp_path):
    jm, tm = carried(seed=5)
    jm.save(tmp_path / "j.npz")
    tm.save(tmp_path / "t.npz")
    from_j = ta.AAE.load(tmp_path / "j.npz", device="cpu")
    from_t = ja.AAE.load(str(tmp_path / "t.npz"))
    fj = flat_jax(jm)
    for k, v in params_to_jax(from_j.state_dict()).items():
        assert np.array_equal(v, np.asarray(fj[k])), k
    for k, v in flat_jax(from_t).items():
        assert np.array_equal(np.asarray(v), np.asarray(fj[k])), k
    assert from_j.meta() == tm.meta()
    assert {k: getattr(from_t, a) for k, a in (("nlatent_z", "ld"), ("nlatent_y", "y_len"))} == {
        "nlatent_z": LD, "nlatent_y": YLEN}


def test_trainmodel_no_nan_under_adversarial_saturation():
    ds = make_ds(n=512, s=5, seed=3)
    tm = ta.AAE(nsamples=5, seed=1, device="cpu")
    tm.trainmodel(ds, nepochs=4, batchsize=64, batchsteps=None)
    for k, v in tm.state_dict().items():
        assert torch.isfinite(v).all(), k
    _, latent = tm.get_latents([str(i) for i in range(ds.n_obs)], ds)
    assert np.isfinite(latent).all()


def test_dataset_is_vamb_tpus():
    "The port trains on the same normalized arrays (make_ds is vamb_tpu's)."
    from vamb_torch.models import make_dataset

    rng = np.random.default_rng(0)
    ab = rng.uniform(0.5, 5, (50, 3)).astype(np.float32)
    tnf = rng.standard_normal((50, 103)).astype(np.float32)
    lengths = rng.integers(2000, 50_000, 50)
    a, b = make_dataset(ab, tnf, lengths), j_dataset.make_dataset(ab, tnf, lengths)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
