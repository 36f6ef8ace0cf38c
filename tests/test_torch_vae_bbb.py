"""The two examples ``nd.random_normal`` opens, as ``chip_smoke.py``
mirrors them (the examples import ``mxtpu``), against ``mxtpu``:
``example/vae/vae_mnist.py``'s VAE and
``example/bayesian-methods/bbb_toy.py``'s Bayes by Backprop.

The two packages' generators differ, so each run takes its
reparameterization noise from a test subclass (``eps`` overridden) that
hands both packages the same numpy draws. From the same weights the
first steps' losses, step 1's gradients and the weights after the steps
must agree: within 1e-5 of each array's largest value, and the weights
after Adam steps but for at most ``ADAM_APART`` entries, each within 2
lr (Adam's step is near lr whatever a tiny gradient's size, so float32
rounding can move such an entry by up to 2 lr).
"""
import importlib.util
import pathlib

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHARE, ADAM_APART = 1e-5, 4
STEPS = 3


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", str(ROOT / "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def hold(got, want, lr):
    """(losses, weights, step 1's gradients) of the port against
    mxtpu's."""
    losses, values, first = got
    want_l, want_v, want_first = want
    assert CS.largest_share_apart({"l": np.array(losses)},
                                  {"l": np.array(want_l)}) <= SHARE
    assert CS.largest_share_apart(first, want_first) <= SHARE
    apart, worst, _n = CS.adam_weights_apart(values, want_v)
    assert apart <= ADAM_APART and worst <= 2 * lr, (apart, worst)


def noisy(cls, seed):
    """``cls`` (a mirrored model) whose ``eps`` returns numpy draws from
    RandomState(seed) in the order they are asked for: zeros until
    ``start()``."""
    class Noisy(cls):
        rng = None

        def start(self):
            self.rng = np.random.RandomState(seed)

        def eps(self, like):
            shape = like if isinstance(like, tuple) \
                else (like.shape[0], self.n_latent)
            draw = np.zeros(shape, np.float32) if self.rng is None \
                else self.rng.standard_normal(shape).astype(np.float32)
            return self._pkg.nd.array(draw)
    return Noisy


@pytest.fixture(scope="module")
def digits():
    """get_data.py's synthetic digits, 32 of them, as [0, 1] floats."""
    rng = np.random.RandomState(0)
    protos = rng.uniform(0, 160, (10, 28, 28))
    labels = rng.randint(0, 10, 32)
    images = np.clip(protos[labels] + rng.normal(0, 24, (32, 28, 28)),
                     0, 255).astype(np.uint8)
    return (images.reshape(32, -1) / 255.0).astype(np.float32)


def vae_run(pkg, x, weights, hidden, latent, batch):
    base = CS.vae_class(pkg)
    cls = noisy(base, 1)
    cls._pkg = pkg
    old = (CS.VAE_HIDDEN, CS.VAE_LATENT, CS.VAE_BATCH)
    CS.VAE_HIDDEN, CS.VAE_LATENT, CS.VAE_BATCH = hidden, latent, batch
    try:
        made = []

        class Started(cls):
            def __init__(self, **kw):
                super().__init__(**kw)
                made.append(self)
        net, trainer = CS.vae_net(pkg, pkg.cpu(), weights, Started)
        made[-1].start()
        params = net.collect_params()
        losses, first = [], None
        for i in range(STEPS):
            xb = pkg.nd.array(x[i * batch:(i + 1) * batch])
            losses.append(float(CS.vae_step(pkg, net, trainer, xb).mean()
                                .asnumpy()))
            if first is None:
                first = {k.split("_", 1)[1]: p.grad().asnumpy()
                         for k, p in params.items()}
        return losses, {k.split("_", 1)[1]: p.data().asnumpy()
                        for k, p in params.items()}, first
    finally:
        CS.VAE_HIDDEN, CS.VAE_LATENT, CS.VAE_BATCH = old


@pytest.mark.parametrize("hidden, latent, batch", [(32, 4, 8),
                                                   (64, 20, 10)])
def test_vae_steps_match_mxtpu(digits, hidden, latent, batch):
    """vae_mnist.py's loop (record, -ELBO, backward, Adam) from the
    port's Xavier weights, the same noise in both packages."""
    old = (CS.VAE_HIDDEN, CS.VAE_LATENT)
    CS.VAE_HIDDEN, CS.VAE_LATENT = hidden, latent
    try:
        with mt.cpu():
            weights = CS.vae_weights(mt)
    finally:
        CS.VAE_HIDDEN, CS.VAE_LATENT = old
    with mt.cpu():
        got = vae_run(mt, digits, weights, hidden, latent, batch)
    want = vae_run(mx, digits, weights, hidden, latent, batch)
    hold(got, want, CS.VAE_LR)
    assert got[0][-1] < got[0][0]


def bbb_steps(pkg):
    cls = noisy(CS.bbb_class(pkg), 2)
    cls._pkg = pkg

    class Started(cls):
        def __init__(self):
            super().__init__()
            self.start()
    return CS.bbb_run(pkg, pkg.cpu(), steps=STEPS, model_class=Started)[:3]


def test_bbb_steps_match_mxtpu():
    """bbb_toy.py's loop (the sampled weights, the KL term, softmax
    cross-entropy, Adam 5e-3) at its own sizes, the same noise in both
    packages."""
    with mt.cpu():
        got = bbb_steps(mt)
    want = bbb_steps(mx)
    hold(got, want, CS.BBB_LR)


def test_bbb_main_on_the_cpu():
    """bbb_toy.py's main at a third of its epochs on the port's CPU: the
    ELBO falls and its two asserts hold."""
    old = CS.BBB_EPOCHS
    CS.BBB_EPOCHS = 10
    try:
        with mt.cpu():
            losses, _w, _f, text = CS.bbb_run(mt, mt.cpu())
    finally:
        CS.BBB_EPOCHS = old
    assert float(losses[-1]) < 0.6 * float(losses[0])
    assert "MC predictive accuracy" in text
