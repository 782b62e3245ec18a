"""The port's training stack held against vamb_tpu on the CPU.

* `make_dataset`: bit-identical arrays (host numpy in both packages).
* layers: within tests/test_layers.py's tolerances (f32 sums in another
  order): Linear rtol 1e-5/atol 1e-6, BatchNorm rtol 1e-4/atol 1e-5 (running
  mean atol 1e-6), LeakyReLU rtol 1e-6, byte dropout exact.
* 4 epochs of lockstep training, JAX `apply` + `dadapt_adam` against the
  port's VAE + `DAdaptAdam`, both fed the same injected eps and dropout
  masks: the gates of tests/test_parity_vae.py:182-341 (loss rtol 1e-4,
  d rtol 1e-4, weights and BatchNorm stats atol 3e-5).
* random streams: one epoch's permutation and dropout bank are
  bit-identical to those `vamb_tpu`'s key chain draws, its eps within the
  3 ulps of tests/test_torch_threefry.py; a training step's forward on
  those draws matches `apply(train=True, key=..., dropout_bank=...)` on
  the same step of `vamb_tpu`'s chain (rtol 1e-5, atol 1e-6).
* 10 optimizer steps of both packages' own `trainmodel` from one seed and
  one set of weights, with nothing injected: every parameter and BatchNorm
  statistic within rtol 1e-5, atol 1e-8 (measured: 3.6e-7 relative at
  most; the f32 sums run in another order).
* checkpoints: `params_from_jax` and its inverse round-trip exactly, and a
  port-written `model.npz` loads into `vamb_tpu.models.VAE.load`.
* `encode` of one shared `model.npz`: latents within atol 1e-6 after both
  sides' 12-bit mantissa mask, except values that sit on a mask step: the
  two packages' f32 matmuls sum in another order, so a value within an ulp
  of a step can land one mask step (4096 ulps) away. Those are counted
  (1 of 6000 here) and each must be exactly one step off.
* a model `vamb_tpu` trained at bf16 loads, encodes within the same
  tolerance, saves back as "bf16" and trains on at bf16.
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vamb_torch.models import VAE as TVAE
from vamb_torch.models import dataset as t_dataset
from vamb_torch.models import layers as t_layers
from vamb_torch.models import training as t_training
from vamb_torch.optim import DAdaptAdam
from vamb_torch.utils import threefry
from vamb_torch.utils.checkpoint import (
    flatten_tree,
    load_flat,
    params_from_jax,
    params_to_jax,
)

from vamb_tpu.models import VAE as JVAE
from vamb_tpu.models import dataset as j_dataset
from vamb_tpu.models import layers as j_layers
from vamb_tpu.models import training as j_training
from vamb_tpu.optim import dadapt_adam

CPU = torch.device("cpu")


# ------------------------------------------------------------- dataset


def _raw(n, s, seed, zero_rows=False, short=False):
    rng = np.random.default_rng(seed)
    ab = rng.gamma(1.0, 5.0, (n, s)).astype(np.float32)
    if zero_rows:
        ab[::7] = 0.0
    tnf = rng.normal(size=(n, 103)).astype(np.float32)
    lengths = rng.integers(100 if short else 2000, 60_000, n)
    return ab, tnf, lengths


@pytest.mark.parametrize(
    "n,s,kw",
    [(300, 4, {}), (200, 1, {}), (250, 3, {"zero_rows": True}), (100, 6, {"short": True})],
)
def test_make_dataset_bit_identical(n, s, kw):
    ab, tnf, lengths = _raw(n, s, seed=n + s, **kw)
    jd = j_dataset.make_dataset(ab.copy(), tnf.copy(), lengths)
    td = t_dataset.make_dataset(ab.copy(), tnf.copy(), lengths)
    for a, b in zip(jd, td):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,bs", [(1000, 256), (100, 256), (256, 256), (513, 64)])
def test_batch_schedule_identical(n, bs):
    assert t_dataset.num_batches(n, bs) == j_dataset.num_batches(n, bs)
    steps = [2, 5, 9]
    for epoch in range(12):
        assert t_dataset.batchsize_at_epoch(bs, steps, epoch) == j_dataset.batchsize_at_epoch(bs, steps, epoch)
    assert list(t_training.segment_plan(12, steps)) == list(j_training.segment_plan(12, steps))
    assert t_training.validate_batchsteps(12, [5, 2, 5]) == j_training.validate_batchsteps(12, [5, 2, 5])
    with pytest.raises(ValueError):
        t_training.validate_batchsteps(5, [5])


# -------------------------------------------------------------- layers


def test_linear_matches_jax():
    rng_t, rng_j = np.random.default_rng(0), np.random.default_rng(0)
    lin = t_layers.Linear(rng_t, 37, 11)
    p = j_layers.init_dense(rng_j, 37, 11)
    assert np.array_equal(lin.w.detach().numpy(), p["w"])
    assert np.array_equal(lin.b.detach().numpy(), p["b"])
    x = np.random.default_rng(1).normal(size=(64, 37)).astype(np.float32)
    out_j = np.asarray(j_layers.dense(p, x))
    out_t = lin(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-6)


def test_batchnorm_train_and_eval_match_jax():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(128, 24)) * 3 + 1).astype(np.float32)
    bn = t_layers.BatchNorm(24)
    scale = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    bias = rng.normal(0, 0.2, 24).astype(np.float32)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    params = {"scale": scale, "bias": bias}
    _, state = j_layers.init_batchnorm(24)
    out_j, new_state = j_layers.batchnorm_train(params, state, x)
    bn.train()
    out_t = bn(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out_t, np.asarray(out_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(new_state["mean"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(new_state["var"]), rtol=1e-4, atol=1e-5)
    bn.eval()
    y = rng.normal(size=(32, 24)).astype(np.float32)
    out_je = np.asarray(j_layers.batchnorm_eval(params, new_state, y))
    out_te = bn(torch.from_numpy(y)).detach().numpy()
    np.testing.assert_allclose(out_te, out_je, rtol=1e-4, atol=1e-5)


def test_leaky_relu_and_byte_dropout_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 40)).astype(np.float32)
    np.testing.assert_allclose(
        t_layers.leaky_relu(torch.from_numpy(x)).numpy(),
        np.asarray(j_layers.leaky_relu(x)), rtol=1e-6,
    )
    bits = rng.integers(0, 256, (64, 40)).astype(np.uint8)
    for rate in (0.0, 0.2, 0.5):
        assert t_layers.dropout_threshold(rate) == j_layers.dropout_threshold(rate)
        out_t = t_layers.dropout_from_bits(torch.from_numpy(bits), torch.from_numpy(x), rate)
        out_j = j_layers.dropout_from_bits(bits, x, rate)
        assert np.array_equal(out_t.numpy(), np.asarray(out_j))


# ----------------------------------------------------- lockstep training

S, NLATENT = 4, 8
NHIDDENS = [32, 16]


def _copy_jax_into_port(jvae, tvae):
    flat = flatten_tree({"params": jvae.params, "bn_state": jvae.bn_state})
    tvae.load_state_dict(params_from_jax(flat))


def test_initial_weights_identical():
    "Both packages draw the same initial weights from one seed."
    jvae = JVAE(nsamples=S, nhiddens=NHIDDENS, nlatent=NLATENT, seed=7)
    tvae = TVAE(nsamples=S, nhiddens=NHIDDENS, nlatent=NLATENT, seed=7, device=CPU)
    flat_j = flatten_tree({"params": jvae.params, "bn_state": jvae.bn_state})
    flat_t = params_to_jax(tvae.state_dict())
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        assert np.array_equal(flat_j[k], flat_t[k]), k


def test_training_lockstep():
    """4 epochs (32 optimizer steps) with injected identical eps and dropout
    masks. The window and gates are tests/test_parity_vae.py's: drift is
    ulp-scale through epoch 3 and grows exponentially afterwards, while a
    semantics bug shows at 1e-3+ in epoch 0-1."""
    N, B, EPOCHS, DROP = 256, 32, 4, 0.2
    rng = np.random.default_rng(11)
    group = rng.integers(0, 8, N)
    profiles = rng.dirichlet(np.ones(S) * 0.4, 8).astype(np.float32)
    depths = (profiles[group] + rng.uniform(0, 0.02, (N, S))).astype(np.float32)
    depths /= depths.sum(1, keepdims=True)
    tnf = (rng.normal(size=(8, 103))[group] * 0.5
           + 0.1 * rng.normal(size=(N, 103))).astype(np.float32)
    ab = rng.normal(size=(N, 1)).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, (N, 1)).astype(np.float32)

    jvae = JVAE(nsamples=S, nhiddens=NHIDDENS, nlatent=NLATENT, seed=7, dropout=DROP)
    tvae = TVAE(nsamples=S, nhiddens=NHIDDENS, nlatent=NLATENT, seed=7, dropout=DROP,
                device=CPU)
    _copy_jax_into_port(jvae, tvae)
    opt_j = dadapt_adam()
    params, bn_state = jvae.params, jvae.bn_state
    opt_state = opt_j.init(params)
    opt_t = DAdaptAdam(tvae.parameters_flat_order())

    @jax.jit
    def jax_step(params, bn_state, opt_state, batch, inject):
        d_in, t_in, a_in, w = batch

        def loss_fn(params, bn_state):
            (d, t, a, mu), new_state = jvae.apply(
                params, bn_state, d_in, t_in, a_in, train=True, inject=inject
            )
            loss, *_ = jvae.calc_loss(d_in, d, t_in, t, a_in, a, mu, w)
            return loss, new_state

        (loss, new_state), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, bn_state)
        updates, opt_state = opt_j.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, new_state, opt_state, loss

    keep_scale = np.float32(1.0 / (1.0 - DROP))
    tvae.train()
    for epoch in range(EPOCHS):
        perm = rng.permutation(N)
        for b in range(N // B):
            idx = perm[b * B : (b + 1) * B]
            eps = rng.standard_normal((B, NLATENT)).astype(np.float32)
            enc_masks = [(rng.random((B, w)) >= DROP).astype(np.float32) * keep_scale
                         for w in NHIDDENS]
            dec_masks = [(rng.random((B, w)) >= DROP).astype(np.float32) * keep_scale
                         for w in NHIDDENS[::-1]]
            batch = (depths[idx], tnf[idx], ab[idx], weights[idx])
            inject = {"eps": eps, "enc_masks": enc_masks, "dec_masks": dec_masks}
            params, bn_state, opt_state, jloss = jax_step(
                params, bn_state, opt_state, batch, inject)

            tb = [torch.from_numpy(a) for a in batch]
            t_inject = {"eps": torch.from_numpy(eps),
                        "enc_masks": [torch.from_numpy(m) for m in enc_masks],
                        "dec_masks": [torch.from_numpy(m) for m in dec_masks]}
            d_o, t_o, a_o, mu_o = tvae(tb[0], tb[1], tb[2], inject=t_inject)
            tloss, *_ = tvae.calc_loss(tb[0], d_o, tb[1], t_o, tb[2], a_o, mu_o, tb[3])
            opt_t.zero_grad(set_to_none=True)
            tloss.backward()
            opt_t.step()
            np.testing.assert_allclose(
                float(tloss.detach()), float(jloss), rtol=1e-4,
                err_msg=f"loss drift at epoch {epoch} batch {b}",
            )

        np.testing.assert_allclose(
            float(opt_t.d), float(opt_state.d), rtol=1e-4,
            err_msg=f"D-Adaptation d drift at epoch {epoch}",
        )
        flat_t = params_to_jax(tvae.state_dict())
        flat_j = flatten_tree({"params": params, "bn_state": bn_state})
        for k in flat_j:
            np.testing.assert_allclose(
                flat_t[k], flat_j[k], atol=3e-5, err_msg=f"{k} drift at epoch {epoch}"
            )


def test_trainmodel_runs_with_batch_doubling():
    "The port's own epoch loop: finite losses, doubling, a loadable model."
    ab, tnf, lengths = _raw(300, 3, seed=4)
    ds = t_dataset.make_dataset(ab, tnf, lengths)
    vae = TVAE(3, nhiddens=[24, 24], nlatent=6, seed=2, device=CPU)
    lines = []
    import io

    buf = io.BytesIO()
    vae.trainmodel(ds, nepochs=3, batchsize=64, batchsteps=[1, 2], modelfile=buf,
                   logger=lines.append)
    epochs = [l for l in lines if "Epoch:" in l]
    assert len(epochs) == 3
    assert [int(l.split("Batchsize:")[1].split()[0]) for l in epochs] == [64, 128, 256]
    assert all(np.isfinite(float(l.split("Loss:")[1].split()[0])) for l in epochs)
    buf.seek(0)
    back = TVAE.load(buf, device=CPU)
    np.testing.assert_array_equal(back.encode(ds), vae.encode(ds))


def test_epoch_draws_match_jax_key_chain():
    "Permutation and bank bit-identical, eps within 3 ulps, next key equal."
    n, bs, nb, drop = 300, 32, 9, 0.2
    tvae = TVAE(nsamples=S, nhiddens=NHIDDENS, nlatent=NLATENT, seed=7, dropout=drop,
                device=CPU)
    rng_t, perm, (bank, widths), eps = tvae.epoch_draws(tvae.rng, n, bs, nb)
    rng, key = jax.random.split(jax.random.key(7))
    perm_key, scan_key, bank_key = jax.random.split(key, 3)
    assert np.array_equal(perm.numpy(), np.asarray(jax.random.permutation(perm_key, n)))
    assert widths == NHIDDENS + NHIDDENS[::-1]
    nwords = (sum(widths) + 3) // 4
    words = jax.random.bits(bank_key, (bs, nwords), jnp.uint32)
    bank_j = np.asarray(jax.lax.bitcast_convert_type(words, jnp.uint8)).reshape(bs, -1)
    assert np.array_equal(bank.numpy(), bank_j[:, : sum(widths)])
    key = scan_key
    for i in range(nb):
        key, sub = jax.random.split(key)
        e = np.asarray(jax.random.normal(jax.random.split(sub, 3)[0], (bs, NLATENT)))
        ulps = np.abs(e.view(np.int32).astype(np.int64) - eps[i].numpy().view(np.int32))
        assert ulps.max() <= 3, (i, ulps.max())
    assert np.array_equal(rng_t.numpy(), np.asarray(jax.random.key_data(rng)).astype(np.int64))


@pytest.mark.parametrize("step", [0, 3])
def test_training_step_forward_matches_apply(step):
    """Step `step` of an epoch: the port's forward on its `epoch_draws` eps
    and rotated bank against jax's on the same step of the key chain."""
    bs, nb = 64, 4
    ab, tnf, lengths = _raw(bs, S, seed=5)
    ds = j_dataset.make_dataset(ab, tnf, lengths)
    jvae = JVAE(nsamples=S, nhiddens=NHIDDENS, nlatent=NLATENT, seed=3, dropout=0.2)
    tvae = TVAE(nsamples=S, nhiddens=NHIDDENS, nlatent=NLATENT, seed=3, dropout=0.2,
                device=CPU)
    _, _, bank, eps = tvae.epoch_draws(tvae.rng, bs, bs, nb)
    _, key = jax.random.split(jax.random.key(3))
    _, scan_key, _ = jax.random.split(key, 3)
    for _ in range(step + 1):
        scan_key, sub = jax.random.split(scan_key)
    t_bank = tvae.step_bank(bank, step)
    j_bank = {k: [np.asarray(b) for b in v] for k, v in t_bank.items()}
    outs_j, _ = jvae.apply(jvae.params, jvae.bn_state, ds.depths, ds.tnf, ds.abundance,
                           train=True, key=sub, dropout_bank=j_bank)
    tvae.train()
    with torch.no_grad():
        outs_t = tvae(*(torch.from_numpy(a) for a in (ds.depths, ds.tnf, ds.abundance)),
                      eps=eps[step], dropout_bank=t_bank)
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def test_ten_steps_of_trainmodel_match_vamb_tpu():
    """Both packages' own epoch loops, one epoch of 10 steps at batch 32,
    from the same seed and weights and with nothing injected."""
    ab, tnf, lengths = _raw(320, S, seed=4)
    kw = dict(nsamples=S, nhiddens=[64, 48], nlatent=NLATENT, seed=7, dropout=0.2)
    jvae, tvae = JVAE(**kw), TVAE(**kw, device=CPU)
    jvae.trainmodel(j_dataset.make_dataset(ab.copy(), tnf.copy(), lengths),
                    nepochs=1, batchsize=32, batchsteps=None)
    tvae.trainmodel(t_dataset.make_dataset(ab.copy(), tnf.copy(), lengths),
                    nepochs=1, batchsize=32, batchsteps=None)
    flat_j = flatten_tree({"params": jvae.params, "bn_state": jvae.bn_state})
    flat_t = params_to_jax(tvae.state_dict())
    for k in flat_j:
        np.testing.assert_allclose(flat_t[k], flat_j[k], rtol=1e-5, atol=1e-8, err_msg=k)
    assert np.array_equal(tvae.rng.numpy(),
                          np.asarray(jax.random.key_data(jvae.rng)).astype(np.int64))


# ---------------------------------------------------------- checkpoints


def test_params_roundtrip_both_ways(tmp_path):
    jvae = JVAE(nsamples=S, nhiddens=NHIDDENS, nlatent=NLATENT, seed=5)
    # non-trivial BatchNorm state so the bn_state keys are exercised
    for stack in ("enc", "dec"):
        for s in jvae.bn_state[stack]:
            s["mean"] = np.random.default_rng(1).normal(size=s["mean"].shape).astype(np.float32)
    jvae.save(tmp_path / "jax_model.npz")
    tvae = TVAE.load(tmp_path / "jax_model.npz", device=CPU)
    tvae.save(tmp_path / "torch_model.npz")
    j_flat, j_meta = load_flat(tmp_path / "jax_model.npz")
    t_flat, t_meta = load_flat(tmp_path / "torch_model.npz")
    assert j_flat.keys() == t_flat.keys()
    for k in j_flat:
        assert np.array_equal(j_flat[k], t_flat[k]), k
    assert {k: t_meta[k] for k in j_meta} == j_meta
    # the port's model.npz loads into vamb_tpu
    back = JVAE.load(tmp_path / "torch_model.npz")
    assert np.array_equal(back.params["enc"][0]["dense"]["w"], jvae.params["enc"][0]["dense"]["w"])
    assert np.array_equal(back.bn_state["dec"][1]["mean"], jvae.bn_state["dec"][1]["mean"])


def test_encode_shared_model(tmp_path):
    """Latents of one model.npz agree within atol 1e-6 after the 12-bit
    mask, but for at most 0.1% of values that sit exactly one mask step
    away (matmul sum order; see the module docstring)."""
    ab, tnf, lengths = _raw(500, 4, seed=9)
    ds_j = j_dataset.make_dataset(ab.copy(), tnf.copy(), lengths)
    ds_t = t_dataset.make_dataset(ab.copy(), tnf.copy(), lengths)
    jvae = JVAE(nsamples=4, nhiddens=[64, 48], nlatent=12, seed=3)
    rng = np.random.default_rng(0)
    for stack in ("enc", "dec"):
        for s in jvae.bn_state[stack]:
            s["mean"] = rng.normal(0, 0.3, s["mean"].shape).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2, s["var"].shape).astype(np.float32)
    jvae.save(tmp_path / "model.npz")
    lat_j = JVAE.load(tmp_path / "model.npz").encode(ds_j)
    lat_t = TVAE.load(tmp_path / "model.npz", device=CPU).encode(ds_t)
    assert lat_t.dtype == np.float32 and lat_t.shape == (500, 12)
    assert not (lat_t.view(np.uint32) & 0xFFF).any()
    close = np.abs(lat_t - lat_j) <= 1e-6
    steps = np.abs(lat_t.view(np.int32).astype(np.int64) - lat_j.view(np.int32))
    assert (~close).sum() <= lat_t.size // 1000, (~close).sum()
    assert (steps[~close] == 4096).all(), steps[~close]
    assert (np.sign(lat_t) == np.sign(lat_j))[~close].all()


def test_bf16_model_loads_encodes_and_round_trips():
    """A model.npz that vamb_tpu trained at bf16 loads into the port: it
    encodes as vamb_tpu's does (encode runs at f32 whatever the training
    precision; the mask-straddle tolerance of test_encode_shared_model),
    saves again as "bf16" in a file vamb_tpu loads, and trains on at bf16
    (tests/test_torch_bf16.py holds that training to vamb_tpu's)."""
    buf = io.BytesIO()
    jvae = JVAE(nsamples=3, nhiddens=[16, 16], nlatent=4, precision="bf16")
    jvae.save(buf)
    buf.seek(0)
    tvae = TVAE.load(buf, device=CPU)
    assert tvae.precision == "bf16"
    ab, tnf, lengths = _raw(400, 3, seed=11)
    lat_j = jvae.encode(j_dataset.make_dataset(ab.copy(), tnf.copy(), lengths))
    ds_t = t_dataset.make_dataset(ab.copy(), tnf.copy(), lengths)
    lat_t = tvae.encode(ds_t)
    assert lat_t.dtype == np.float32 and lat_t.shape == (400, 4)
    close = np.abs(lat_t - lat_j) <= 1e-6
    steps = np.abs(lat_t.view(np.int32).astype(np.int64) - lat_j.view(np.int32))
    assert (~close).sum() <= lat_t.size // 1000, (~close).sum()
    assert (steps[~close] == 4096).all(), steps[~close]

    out = io.BytesIO()
    tvae.save(out)
    out.seek(0)
    assert load_flat(out)[1]["precision"] == "bf16"
    out.seek(0)
    back = JVAE.load(out)
    assert back.precision == "bf16"
    assert np.array_equal(back.params["enc"][0]["dense"]["w"], jvae.params["enc"][0]["dense"]["w"])
    assert tvae._compute_dtype == torch.bfloat16
    tvae.trainmodel(ds_t, nepochs=1, batchsize=64, batchsteps=None)
    assert tvae.precision == "bf16"
    assert not np.array_equal(tvae.enc[0].dense.w.detach().numpy(),
                              jvae.params["enc"][0]["dense"]["w"])


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TVAE(4, nhiddens=[8, 8], nlatent=2)


def test_unported_precision_raises():
    "Precisions are f32 and bf16, as in vamb_tpu (vae.py:92-93); others raise."
    with pytest.raises(ValueError, match="precision"):
        TVAE(4, nhiddens=[8, 8], nlatent=2, device=CPU, precision="fp8")
    with pytest.raises(ValueError, match="precision"):
        JVAE(4, nhiddens=[8, 8], nlatent=2, precision="fp8")
