"""The port's ASDNet trainer (asdslam_torch/models/train.py, the training form
of models/asdnet.py, train_asdnet_torch.py) against the JAX package's on the
CPU, with the JAX draws replayed, and twins of tests/test_training.py's
TestLosses, TestTraining and TestAugmentation.

Bars, each measured here (CPU) and stated with its test:
- the losses, the augmentation and the learning-rate schedule: 1e-6 (the
  augmentation and the schedule are exact), but 2e-4 for a distance between
  identical descriptors (the square root's slope at its 1e-6 floor);
- the train-mode forward (batch statistics, a replayed dropout mask):
  1e-5 on the descriptors and the batch statistics (measured 3.6e-6);
- ``make_batch`` with replayed draws: 1e-5 (measured 1.3e-6: sin / cos and
  the bilinear sum's rounding);
- one ``train_step``: the loss 1e-5, the running statistics 1e-5, the
  convs 1e-3 (measured 2.4e-7, 2.4e-7 on the means and 1.3e-7 relative on
  the variances, 3.7e-4).  The convs' bar is wide because the JAX
  package's CPU gradient is the less accurate one: its BN statistics' f32
  reductions over 16 384 values lose up to 5e-4 of the gradient, where the
  port's stay within 1e-5 of a float64 evaluation
  (``test_bn_backward_against_float64``);
- five chained steps: the loss 0.05 and the convs 0.1 (measured 0.017 and
  0.019): the gap grows from the first step's 3.7e-4 as each step's
  gradient follows the weights the last one left;
- ``_orthogonal`` and ``save_weights``: bitwise;
- the port-trained pickle in the JAX package's ``apply`` (bf16): 2.72e-3,
  tests/test_torch_extract.py's bf16 bar;
- ``train_asdnet_torch.main`` against ``train_asdnet.py`` on one cache: the
  same keys, ``fpr95_patch_classical`` equal, ``fpr95_asd_trained`` within
  0.05 (see the test).

As a script it gives chip_smoke.py phase 9a's yardstick (CPU, ~40 min: the
JAX package's run, then the port's):

    python tests/test_torch_train.py --reference-phase9
"""

import io
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import train_asdnet_torch  # noqa: E402  (the scripts at the repository's root)
from chip_smoke import N_HELD_OUT, N_POOL, N_STEPS, TRAIN_BATCH  # noqa: E402
from asdslam_tpu.models import asdnet as jnet  # noqa: E402
from asdslam_tpu.models import train as jtr  # noqa: E402
from asdslam_torch.models import asdnet as tnet  # noqa: E402
from asdslam_torch.models import train as ttr  # noqa: E402

# chip_smoke.py phase 9a's flags, which its yardstick runs with
PHASE9_FLAGS = ["--steps", str(N_STEPS), "--batch", str(TRAIN_BATCH), "--eval_pairs",
                str(N_HELD_OUT)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.tensor(np.asarray(x))


def unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def jax_step_draws(key, batch):
    """The draws the JAX ``train_step`` makes from ``key``, as the port's
    ``StepDraws`` (the dropout masks transposed from NHWC to NCHW)."""
    ka, kp, kaug = jax.random.split(key, 3)
    return ttr.StepDraws(jax_augment_draws(kaug, batch), jax_mask(ka, batch), jax_mask(kp, batch))


def jax_augment_draws(key, batch):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return ttr.AugmentDraws(T(jax.random.randint(k1, (batch,), 0, 4)).long(),
                            T(jax.random.bernoulli(k2, 0.5, (batch,))),
                            T(jax.random.uniform(k3, (batch,), minval=0.7, maxval=1.0)),
                            T(jax.random.uniform(k4, (batch, 2), minval=-2.0, maxval=2.0)))


def jax_mask(key, batch):
    return T(jax.random.bernoulli(key, 0.7, (batch, 8, 8, 128))).permute(0, 3, 1, 2).contiguous()


def jax_batch_draws(key, batch, size=32):
    """The draws the JAX ``make_batch`` makes from ``key``."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)

    def noise(k):
        return T(jax.vmap(lambda kk: jax.random.normal(kk, (size, size)))(jax.random.split(k, batch)))

    return ttr.BatchDraws(T(jax.random.uniform(k1, (batch, 2), minval=40.0, maxval=216.0)),
                          T(jax.random.randint(k2, (batch,), 0, 4)).long(), noise(k3),
                          T(jax.random.uniform(k4, (batch,), minval=-0.4, maxval=0.4)),
                          T(jax.random.uniform(k5, (batch,), minval=0.8, maxval=1.25)),
                          T(jax.random.normal(jax.random.fold_in(k4, 1), (batch, 2))),
                          noise(jax.random.fold_in(k3, 1)))


def jax_seeds(key):
    return [int(jax.random.key_data(k)[-1]) for k in jax.random.split(key, len(jnet.LAYERS))]


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jnet.init_params(jax.random.PRNGKey(0)))


# --------------------------------------------------------------------------- #
# Twins of tests/test_training.py
# --------------------------------------------------------------------------- #
class TestLosses:
    def test_triplet_margin_zero_when_separated(self):
        g = np.random.default_rng(0)
        a = torch.tensor(unit(g.standard_normal((16, 8))).astype(np.float32))
        loss = ttr.asd_loss(a, a, adaptive=False, margin=1.0)
        d = ttr.l2_distance_matrix_sqrt(a, a) + torch.eye(16) * 10
        masked = d + torch.where(d < 0.008, 10.0, 0.0)
        assert abs(float(loss) - np.mean(np.maximum(1.0 - masked.min(dim=1).values.numpy(), 0))) < 0.3

    def test_adaptive_loss_finite(self):
        g = np.random.default_rng(1)
        a = g.standard_normal((32, 128))
        p = a + 0.1 * g.standard_normal((32, 128))
        loss = ttr.asd_loss(torch.tensor(unit(a), dtype=torch.float32),
                            torch.tensor(unit(p), dtype=torch.float32), adaptive=True)
        assert np.isfinite(float(loss))

    def test_correlation_penalty_zero_for_decorrelated(self):
        x = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])
        assert float(ttr.correlation_penalty(x)) < 1e-5

    def test_gor(self):
        a = torch.eye(8, 128)
        n = torch.roll(torch.eye(8, 128), 1, dims=1)
        assert float(ttr.global_orthogonal_regularization(a, n)) < 1e-6


class TestTraining:
    def test_few_steps_reduce_loss_and_improve_matching(self):
        model = tnet.ASDNetTrain(tnet.init_params(
            tnet.draw_init_seeds(torch.Generator().manual_seed(3))))
        f0 = ttr.evaluate_fpr95(model, torch.Generator().manual_seed(10))
        trained = ttr.train_asdnet(4, n_steps=30, batch_size=128, device="cpu")
        f1 = ttr.evaluate_fpr95(trained, torch.Generator().manual_seed(10))
        assert f1 <= f0 + 0.05, (f0, f1)

    def test_fpr95_metric(self):
        pos = np.array([0.1, 0.2, 0.3, 0.2])
        neg = np.array([1.0, 1.1, 0.9, 1.2])
        assert ttr.fpr95(pos, neg) == 0.0
        assert ttr.fpr95(neg, pos) > 0.9


class TestAugmentation:
    def test_augment_preserves_pair_correspondence(self):
        g = np.random.default_rng(1)
        base = torch.tensor(g.uniform(size=(32, 32, 32)), dtype=torch.float32)
        noise = torch.tensor(0.05 * g.standard_normal(base.shape), dtype=torch.float32)
        a, p = ttr.augment_pair(base, base + noise,
                                ttr.draw_augment(torch.Generator().manual_seed(0), 32))
        a, p = a.numpy(), p.numpy()
        assert a.shape == (32, 32, 32)
        d_pair = np.abs(a - p).mean()
        d_rand = np.abs(a - np.roll(p, 1, axis=0)).mean()
        assert d_pair < 0.5 * d_rand, (d_pair, d_rand)
        changed = np.abs(a - base.numpy()).mean(axis=(1, 2))
        assert (changed > 1e-3).mean() > 0.5

    def test_gor_term_in_loss(self):
        import inspect
        assert "global_orthogonal_regularization" in inspect.getsource(ttr.train_step)


# --------------------------------------------------------------------------- #
# Against the JAX package, its draws replayed
# --------------------------------------------------------------------------- #
LOSSES = {
    "l2_distance_matrix_sqrt": lambda m, a, p: m.l2_distance_matrix_sqrt(a, p),
    "asd_loss adaptive": lambda m, a, p: m.asd_loss(a, p, adaptive=True),
    "asd_loss triplet": lambda m, a, p: m.asd_loss(a, p, adaptive=False),
    "correlation_penalty": lambda m, a, p: m.correlation_penalty(a),
    "global_orthogonal_regularization":
        lambda m, a, p: m.global_orthogonal_regularization(a, np.roll(p, 1, 0) if m is jtr
                                                           else torch.roll(p, 1, 0)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_against_reference(name):
    g = np.random.default_rng(7)
    a = unit(g.standard_normal((64, 128))).astype(np.float32)
    p = unit(a + 0.3 * g.standard_normal((64, 128))).astype(np.float32)
    p[5] = a[5]            # a zero positive distance
    p[9] = a[11]           # a near-duplicate negative, masked below 0.008
    ref = np.asarray(LOSSES[name](jtr, jnp.asarray(a), jnp.asarray(p)))
    out = LOSSES[name](ttr, torch.tensor(a), torch.tensor(p)).numpy()
    # at a zero distance sqrt(|a|^2 + |p|^2 - 2 a.p + 1e-6) has slope 500 in
    # a sum that cancels: the dot's f32 rounding (2.4e-7) moves it by 1.2e-4
    zero = ref < 1e-2
    np.testing.assert_allclose(out[~zero], ref[~zero], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(out[zero], ref[zero], atol=2e-4, rtol=0)


def test_augment_pair_replayed():
    g = np.random.default_rng(2)
    a = g.uniform(size=(48, 32, 32)).astype(np.float32)
    p = g.uniform(size=(48, 32, 32)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ra, rp = jtr.augment_pair(key, jnp.asarray(a), jnp.asarray(p))
    oa, op = ttr.augment_pair(T(a), T(p), jax_augment_draws(key, 48))
    np.testing.assert_allclose(oa.numpy(), np.asarray(ra), atol=1e-6, rtol=0)
    np.testing.assert_allclose(op.numpy(), np.asarray(rp), atol=1e-6, rtol=0)


def test_make_batch_replayed():
    key = jax.random.PRNGKey(5)
    ra, rp = jtr.make_batch(key, 24)
    oa, op = ttr.make_batch(jax_batch_draws(key, 24))
    np.testing.assert_allclose(oa.numpy(), np.asarray(ra), atol=1e-5, rtol=0)
    np.testing.assert_allclose(op.numpy(), np.asarray(rp), atol=1e-5, rtol=0)


def test_lr_schedule_bitwise():
    for base in (0.5, 10.0, 0.3):
        for total in (10, 300, 2000):
            for step in (0, 1, total // 3, total - 1, total):
                assert ttr.lr_schedule(step, total, base) == float(jtr.lr_schedule(step, total, base))


def test_orthogonal_init_bitwise(jax_params):
    """init_params from the integer seeds the JAX init takes from its keys:
    every conv bitwise equal, BN statistics zeros and ones."""
    ours = tnet.init_params(jax_seeds(jax.random.PRNGKey(0)))
    for k in ("conv", "bn_mean", "bn_var"):
        for x, y in zip(ours[k], jax_params[k]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def test_train_forward_against_reference(jax_params):
    """The train-mode forward (batch statistics, a replayed dropout mask)
    against apply(train=True, batch_stats=True, compute_dtype=f32)."""
    patches, _ = jtr.make_batch(jax.random.PRNGKey(2), 32)
    key = jax.random.PRNGKey(3)
    ref, (rm, rv) = jnet.apply(jax_params, patches, train=True, dropout_key=key,
                               batch_stats=True, compute_dtype=jnp.float32)
    model = tnet.ASDNetTrain(jax_params)
    with torch.no_grad():
        out, (om, ov) = model(T(patches), train=True, dropout_mask=jax_mask(key, 32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    for x, y in zip(om, rm):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5, rtol=0)
    for x, y in zip(ov, rv):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=0, rtol=1e-5)


def run_steps(jax_params, n_steps, batch=32, base_lr=0.5):
    """n_steps of both trainers from the same parameters on the same
    batches, the JAX draws replayed.  Yields (step, JAX loss, port loss,
    JAX params, port model) after each step."""
    params = jax_params
    model = tnet.ASDNetTrain(jax_params)
    key = jax.random.PRNGKey(1)
    for step in range(n_steps):
        key, kb, ks = jax.random.split(key, 3)
        a, p = jtr.make_batch(kb, batch)
        lr = ttr.lr_schedule(step, 2 * n_steps, base_lr)
        adaptive = step < max(1, n_steps // 2)
        params, _, jloss = jtr.train_step(params, None, a, p, ks, lr, adaptive=adaptive)
        tloss = ttr.train_step(model, T(a), T(p), torch.tensor(lr), jax_step_draws(ks, batch),
                               adaptive=adaptive)
        yield step, float(jloss), float(tloss), jax.device_get(params), model


def max_diffs(jparams, model):
    ours = model.params_to_jax()
    conv = max(float(np.abs(x - y).max()) for x, y in zip(ours["conv"], jparams["conv"]))
    mean = max(float(np.abs(x - y).max()) for x, y in zip(ours["bn_mean"], jparams["bn_mean"]))
    var = max(float((np.abs(x - y) / y).max()) for x, y in zip(ours["bn_var"], jparams["bn_var"]))
    return conv, mean, var


def test_one_train_step_replayed(jax_params):
    """One step with the JAX draws replayed (augmentation, both dropout
    masks): the loss, the seven updated convs and the running statistics."""
    (_, jloss, tloss, jparams, model), = run_steps(jax_params, 1)
    conv, mean, var = max_diffs(jparams, model)
    assert abs(jloss - tloss) < 1e-5, (jloss, tloss)
    assert conv < 1e-3, conv
    assert mean < 1e-5 and var < 1e-5, (mean, var)


def test_five_chained_steps(jax_params):
    """Five chained steps (adaptive, then triplet) within the looser bar."""
    for step, jloss, tloss, jparams, model in run_steps(jax_params, 5):
        conv, mean, var = max_diffs(jparams, model)
        assert abs(jloss - tloss) < 0.05, (step, jloss, tloss)
        assert conv < 0.1, (step, conv)
    assert all(np.isfinite(x).all() for x in model.params_to_jax()["conv"])


def test_bn_backward_against_float64():
    """Where the one-step bar comes from: three conv-BN-ReLU layers (the
    net's first three, the stride-2 pad included), their conv gradients in
    f32 from the port's arithmetic and from the JAX package's, each against
    the same math in float64.  The port's stay within 1e-5 (relative to the
    largest entry); the JAX CPU backend's f32 BN reductions lose up to 1e-3."""
    g = np.random.default_rng(0)
    x = g.standard_normal((16, 32, 32, 1)).astype(np.float32)
    ws = [(0.3 * g.standard_normal(s)).astype(np.float32)
          for s in [(3, 3, 1, 32), (3, 3, 32, 32), (3, 3, 32, 64)]]

    def port(dtype):
        h = torch.tensor(x, dtype=dtype).permute(0, 3, 1, 2)
        W = [torch.tensor(w, dtype=dtype).permute(3, 2, 0, 1).contiguous().requires_grad_()
             for w in ws]
        for i, w in enumerate(W):
            h = F.conv2d(F.pad(h, (0, 1, 0, 1)), w, stride=2) if i == 2 else F.conv2d(h, w, padding=1)
            m, v = h.mean(dim=(0, 2, 3)), h.var(dim=(0, 2, 3), correction=0)
            h = torch.relu((h - m[:, None, None]) * torch.rsqrt(v + 1e-5)[:, None, None])
        (h * torch.arange(h.shape[1], dtype=dtype)[:, None, None]).sum().backward()
        return [w.grad.permute(2, 3, 1, 0).double().numpy() for w in W]

    def ref(ws):
        h = jnp.asarray(x)
        for i, w in enumerate(ws):
            h = jax.lax.conv_general_dilated(h, w, (2, 2) if i == 2 else (1, 1), "SAME",
                                             dimension_numbers=("NHWC", "HWIO", "NHWC"))
            h = jnp.maximum((h - jnp.mean(h, axis=(0, 1, 2)))
                            * jax.lax.rsqrt(jnp.var(h, axis=(0, 1, 2)) + 1e-5), 0.0)
        return jnp.sum(h * jnp.arange(h.shape[-1], dtype=jnp.float32))

    exact = port(torch.float64)
    ours = port(torch.float32)
    theirs = jax.grad(ref)([jnp.asarray(w) for w in ws])
    for e, o, t in zip(exact, ours, theirs):
        scale = np.abs(e).max()
        assert np.abs(o - e).max() / scale < 1e-5
        assert np.abs(np.asarray(t) - e).max() / scale < 1e-3


def test_save_weights_bitwise(jax_params, tmp_path):
    """save_weights of the JAX init params writes pickle.dump(jax.device_get(
    params))'s bytes, and load_weights / params_from_jax read it back."""
    path = tmp_path / "w.pkl"
    tnet.ASDNetTrain(jax_params).save_weights(path)
    buf = io.BytesIO()
    pickle.dump(jax.device_get(jnet.init_params(jax.random.PRNGKey(0))), buf)
    assert path.read_bytes() == buf.getvalue()
    sd = tnet.load_weights(path)
    for k, v in tnet.params_from_jax(jax_params).items():
        assert torch.equal(sd[k], v)


def test_port_trained_weights_load_in_both_packages(tmp_path):
    """A pickle the port trained: run_slam.py's reader (pickle.load into the
    JAX package's apply) and run_slam_torch.py's (load_weights into ASDNet)
    give the same descriptors within the bf16 bar."""
    model = ttr.train_asdnet(0, n_steps=3, batch_size=32, device="cpu")
    path = tmp_path / "trained.pkl"
    model.save_weights(path)
    with open(path, "rb") as f:
        jparams = pickle.load(f)
    assert list(jparams) == ["bn_mean", "bn_var", "conv"]
    assert not all(np.array_equal(m, 0) for m in jparams["bn_mean"])  # the stats moved
    patches, _ = jtr.make_batch(jax.random.PRNGKey(11), 64)
    ref = np.asarray(jnet.apply(jparams, patches))
    net = tnet.ASDNet()
    net.load_state_dict(tnet.load_weights(path))
    with torch.no_grad():
        out = net(T(patches)).numpy()
    np.testing.assert_allclose(out, ref, atol=2.72e-3, rtol=0)


def test_script_against_reference(tmp_path):
    """train_asdnet_torch.main against train_asdnet.py on one small cache:
    the same JSON keys (the port adds steps/s, the final loss, the device
    and the card), the same fpr95_patch_classical (the same descriptor on
    the same pairs), the trained FPR within 0.05 (the two init from
    different seeds, each package's own generator)."""
    cache = str(tmp_path / "pairs.npz")
    ttr.write_pair_cache(cache, 512, 256)
    flags = ["--pairs_cache", cache, "--steps", "10", "--batch", "64", "--pool", "512",
             "--eval_pairs", "256"]
    ref_json = str(tmp_path / "ref.json")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "train_asdnet.py")] + flags
                         + ["--out", str(tmp_path / "ref.pkl"), "--report", ref_json],
                         cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    with open(ref_json) as f:
        ref = json.load(f)
    res = train_asdnet_torch.main(flags + ["--out", str(tmp_path / "ours.pkl"), "--device", "cpu"])
    assert set(res) == set(ref) | {"steps_per_s", "final_loss", "device", "card"}
    for k in ("steps", "batch", "train_pairs", "eval_pairs", "source", "base_lr"):
        assert res[k] == ref[k], k
    assert res["fpr95_patch_classical"] == ref["fpr95_patch_classical"]
    assert abs(res["fpr95_asd_trained"] - ref["fpr95_asd_trained"]) <= 0.05, (res, ref)
    assert res["device"] == "cpu" and res["card"] is None and np.isfinite(res["final_loss"])
    assert tnet.load_weights(tmp_path / "ours.pkl")


def test_script_needs_a_card_unless_asked(monkeypatch, tmp_path):
    """--device cuda (the default) with no card: exit with a message, no run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        train_asdnet_torch.main(["--out", str(tmp_path / "w.pkl")])
    assert "no CUDA device" in str(e.value.code)
    assert not os.listdir(tmp_path)


@pytest.mark.gpu
def test_train_step_on_cuda_matches_cpu(jax_params):
    """One train_step on the card against the CPU from the same parameters,
    batch and draws: f32 convs without TF32 on both, so the loss within 1e-4
    and the convs within 1e-3 (the one-step bar: cuDNN's sums in another
    order, amplified through the BN backward)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, p = ttr.make_batch(ttr.draw_batch(torch.Generator().manual_seed(0), 256))
    draws = ttr.draw_step(torch.Generator().manual_seed(1), 256)
    losses, convs = [], []
    for dev in ("cpu", "cuda"):
        model = tnet.ASDNetTrain(jax_params).to(dev)
        moved = ttr.StepDraws(ttr.AugmentDraws(*(t.to(dev) for t in draws.augment)),
                              draws.mask_a.to(dev), draws.mask_p.to(dev))
        losses.append(float(ttr.train_step(model, a.to(dev), p.to(dev),
                                           torch.tensor(0.5, device=dev), moved)))
        convs.append(model.params_to_jax()["conv"])
    assert abs(losses[0] - losses[1]) < 1e-4, losses
    assert max(float(np.abs(x - y).max()) for x, y in zip(*convs)) < 1e-3


# --------------------------------------------------------------------------- #
# Script mode: chip_smoke.py phase 9a's yardstick
# --------------------------------------------------------------------------- #
def reference_phase9(workdir):
    """Phase 9a's cache, written as chip_smoke.py writes it (the port's
    make_batch on a CPU generator of seed 0), then the JAX package's
    train_asdnet.py on it with phase 9a's flags, then the port on the CPU
    with the same flags; prints both JSON lines."""
    import json
    import time

    os.makedirs(workdir, exist_ok=True)
    cache = os.path.join(workdir, "phase9_pairs.npz")
    t0 = time.time()
    ttr.write_pair_cache(cache, N_POOL, N_HELD_OUT)
    print(f"cache of {N_POOL} + {N_HELD_OUT} pairs written in {time.time() - t0:.1f} s",
          flush=True)
    flags = ["--pairs_cache", cache] + PHASE9_FLAGS
    report = os.path.join(workdir, "jax.json")
    subprocess.run([sys.executable, os.path.join(ROOT, "train_asdnet.py")] + flags
                   + ["--out", os.path.join(workdir, "jax.pkl"), "--report", report],
                   cwd=ROOT, check=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    with open(report) as f:
        print("JAX package, train_asdnet.py (CPU):", json.dumps(json.load(f)), flush=True)
    res = train_asdnet_torch.main(flags + ["--out", os.path.join(workdir, "port.pkl"),
                                           "--device", "cpu"])
    print("port, train_asdnet_torch.py (CPU):", json.dumps(res), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] != ["--reference-phase9"] or len(sys.argv) > 3:
        sys.exit(__doc__)
    import tempfile
    reference_phase9(sys.argv[2] if len(sys.argv) == 3 else tempfile.mkdtemp())
