"""The CVAE and StackGAN in the port against the JAX package on the CPU, the
JAX variables carried across by ``kuzu_torch.bridge``.

- CVAE (5 classes, latent 16, 128 px, one channel): the forward on JAX's
  own reparameterization noise (recon logits, mu, logvar), ``cvae_loss``
  and ``generate``, each within 1e-5 of the largest entry; the loss's
  gradient for every parameter within 1e-4 of each leaf's largest entry
  (the first convolution's zero bias over blank pixels puts its leaky ReLU
  at exactly 0, where flax's gradient is 1: torch's ``F.leaky_relu`` gave
  0.2 there and that bias's gradient 5.6% off);
- StackGAN (3 classes, latent 16, ``base_ch`` 64; three discriminators with
  ``base_ch`` 16), as ``tests/test_stackgan.py`` builds it: the
  generator's three stages and each discriminator (1e-5),
  ``multiscale_targets`` (antialiased bilinear, 1e-6), ``bcr_augment`` at
  the shifts and flips JAX draws from its keys (exact), and one ``d_step``
  and one ``g_step`` with SGD against JAX's ``make_gan_steps`` with
  ``optax.sgd``, fed the draws JAX derives from its keys: the losses
  (1e-5) and every parameter's update (1e-4 of the leaf's largest update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import flax_variables, numpy_tree

REL = 1e-5
LR = 0.1


def _close(got, want, rel=REL, what="") -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


# ---------------------------------------------------------------- CVAE


@pytest.fixture(scope="module")
def cvae():
    from kuzu.models.cvae import CVAE as JaxCVAE

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.cvae import CVAE

    jm = JaxCVAE(num_classes=5, latent_dim=16)
    v = numpy_tree(jax.jit(lambda r: jm.init(r, jnp.zeros((1, 128, 128, 1)),
                                             jnp.zeros(1, jnp.int32), r))(jax.random.key(0)))
    return jm, v, from_flax(CVAE(num_classes=5, latent_dim=16), v)


def test_cvae_forward_loss_and_gradients_match_jax(cvae):
    """JAX's noise is ``jax.random.normal(key, mu.shape)``: handed to the
    port as ``noise``."""
    from kuzu.models.cvae import cvae_loss as j_loss

    from kuzu_torch.models.cvae import cvae_loss

    jm, v, port = cvae
    rng = np.random.default_rng(1)
    imgs = (rng.uniform(0, 1, (2, 128, 128, 1)) > 0.7).astype(np.float32)
    labels = np.array([1, 3], np.int32)
    key = jax.random.key(2)

    def jfn(p):
        recon, mu, logvar = jm.apply({"params": p}, imgs, labels, key)
        loss, m = j_loss(recon, imgs, mu, logvar, beta=0.5)
        return loss, (recon, mu, logvar, m)

    (jl, (jr, jmu, jlv, jterms)), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        v["params"])
    noise = np.asarray(jax.random.normal(key, (2, 16)))
    recon, mu, logvar = port(_t(imgs), _t(labels), noise=_t(noise))
    loss, terms = cvae_loss(recon, _t(imgs), mu, logvar, beta=0.5)
    loss.backward()
    assert recon.shape == (2, 128, 128, 1)
    for got, want, what in ((recon, jr, "recon"), (mu, jmu, "mu"), (logvar, jlv, "logvar"),
                            (loss, jl, "loss"), (terms["bce"], jterms["bce"], "bce"),
                            (terms["kl"], jterms["kl"], "kl")):
        _close(got.detach(), want, what=what)
    want = dict(_leaves(numpy_tree(jg)))
    grads = flax_variables(port, {k: p.grad for k, p in port.named_parameters()},
                           collections=("params",))["params"]
    for name, g in _leaves(grads):
        _close(g, want[name], rel=1e-4, what=f"grad {name}")


def test_cvae_generate_matches_jax(cvae):
    """``generate`` on fixed z: conditioned on the class, in [0, 1]."""
    from kuzu.models.cvae import CVAE as JaxCVAE

    jm, v, port = cvae
    z = np.random.default_rng(3).normal(size=(3, 16)).astype(np.float32)
    labels = np.array([0, 4, 0], np.int32)
    want = jax.jit(lambda v, z, l: jm.apply(v, z, l, method=JaxCVAE.generate))(v, z, labels)
    with torch.no_grad():
        got = port.generate(_t(z), _t(labels))
    _close(got, want, what="generate")
    assert (got >= 0).all() and (got <= 1).all()
    assert not torch.allclose(got[0], got[1])


def test_cvae_draws_its_noise_from_the_generator(cvae):
    _, _, port = cvae
    imgs, labels = torch.zeros(2, 128, 128, 1), torch.tensor([0, 1])
    with torch.no_grad():
        a = port(imgs, labels, generator=torch.Generator().manual_seed(5))[0]
        b = port(imgs, labels, generator=torch.Generator().manual_seed(5))[0]
        c = port(imgs, labels, noise=torch.zeros(2, 16))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_cvae_noise_is_drawn_on_the_models_device(monkeypatch):
    """Without a generator the noise is drawn on mu's device (a CVAE on the
    card draws it there, with no copy from the host); with one, on the
    generator's. A CVAE on the meta device shows the device asked for."""
    from kuzu_torch.models.cvae import CVAE

    asked = []
    randn = torch.randn

    def spy(*args, **kwargs):
        asked.append(torch.device(kwargs["device"]))
        return randn(*args, **kwargs)

    monkeypatch.setattr(torch, "randn", spy)
    model = CVAE(num_classes=5, latent_dim=16).to("meta")
    imgs, labels = torch.zeros(2, 128, 128, 1, device="meta"), torch.tensor([0, 1], device="meta")
    with torch.no_grad():
        recon = model(imgs, labels)[0]
        model(imgs, labels, generator=torch.Generator())
    assert recon.device.type == "meta"
    assert asked == [torch.device("meta"), torch.device("cpu")]


# ------------------------------------------------------------ StackGAN


@pytest.fixture(scope="module")
def gan():
    """(JAX gen, discs, g_params, d_params; the port's gen and discs with
    them), as ``tests/test_stackgan.py::_setup``."""
    from kuzu.models.stackgan import StackGenerator as JaxGen
    from kuzu.models.stackgan import StageDiscriminator as JaxDisc

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.stackgan import StackGenerator, StageDiscriminator

    gen = JaxGen(num_classes=3, latent_dim=16, base_ch=64)
    discs = [JaxDisc(num_classes=3, base_ch=16) for _ in range(3)]
    z, labels = jnp.zeros((2, 16)), jnp.asarray([0, 1])

    def init():
        gp = gen.init(jax.random.key(0), z, labels)["params"]
        fakes = gen.apply({"params": gp}, z, labels)
        return gp, [d.init(jax.random.key(i), fakes[i], labels)["params"]
                    for i, d in enumerate(discs)]

    gp, dps = jax.jit(init)()
    gp, dps = numpy_tree(gp), [numpy_tree(p) for p in dps]
    tgen = from_flax(StackGenerator(num_classes=3, latent_dim=16, base_ch=64), {"params": gp})
    tdiscs = [from_flax(StageDiscriminator(3, s, base_ch=16), {"params": p})
              for s, p in zip((32, 64, 128), dps)]
    return gen, discs, gp, dps, tgen, tdiscs


def _batch():
    img = np.full((2, 128, 128, 1), -1.0, np.float32)
    img[0, 40:90, 40:90] = 1.0
    img[1, 20:40, :] = 1.0
    img[1, 60:100, 10:30] = 0.3
    return {"image": img, "label": np.array([0, 2], np.int32)}


def test_generator_and_discriminators_match_jax(gan):
    gen, discs, gp, dps, tgen, tdiscs = gan
    z = np.random.default_rng(4).normal(size=(2, 16)).astype(np.float32)
    labels = np.array([0, 2], np.int32)
    imgs = [np.random.default_rng(5).uniform(-1, 1, (2, s, s, 1)).astype(np.float32)
            for s in (32, 64, 128)]

    def jfn(gp, dps):
        return (gen.apply({"params": gp}, z, labels),
                [d.apply({"params": p}, x, labels) for d, p, x in zip(discs, dps, imgs)])

    jfakes, jlogits = jax.jit(jfn)(gp, dps)
    with torch.no_grad():
        fakes = tgen(_t(z), _t(labels))
        logits = [d(_t(x), _t(labels)) for d, x in zip(tdiscs, imgs)]
    assert [tuple(f.shape) for f in fakes] == [(2, 32, 32, 1), (2, 64, 64, 1), (2, 128, 128, 1)]
    for i in range(3):
        _close(fakes[i], jfakes[i], what=f"stage {i}")
        _close(logits[i], jlogits[i], what=f"discriminator {i}")
    assert [d.n_conv for d in tdiscs] == [3, 4, 5]


def test_multiscale_targets_and_hinge_losses_match_jax():
    from kuzu.models.stackgan import hinge_d_loss as j_d
    from kuzu.models.stackgan import hinge_g_loss as j_g
    from kuzu.models.stackgan import multiscale_targets as j_ms

    from kuzu_torch.models.stackgan import hinge_d_loss, hinge_g_loss, multiscale_targets

    x = np.random.default_rng(6).uniform(-1, 1, (2, 128, 128, 1)).astype(np.float32)
    for got, want in zip(multiscale_targets(_t(x)), jax.jit(j_ms)(x)):
        _close(got, want, rel=1e-6, what=f"target {got.shape[1]} px")
    real, fake = np.array([2.0, 0.5], np.float32), np.array([-2.0, 0.5], np.float32)
    assert float(hinge_d_loss(_t(real), _t(fake))) == float(j_d(real, fake)) == 1.0
    assert float(hinge_g_loss(_t(fake))) == float(j_g(fake)) == 0.75


def _jax_aug(key) -> tuple[tuple[int, int], bool]:
    """The (shift (dy, dx), flip) that ``bcr_augment(imgs, key)`` draws."""
    r1, r2, r3 = jax.random.split(key, 3)
    sx = int(jax.random.randint(r1, (), -4, 5))
    sy = int(jax.random.randint(r2, (), -4, 5))
    return (sy, sx), bool(jax.random.bernoulli(r3))


def test_bcr_augment_matches_jax_draws():
    from kuzu.models.stackgan import bcr_augment as j_aug

    from kuzu_torch.models.stackgan import bcr_augment, bcr_draw

    x = np.random.default_rng(7).uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    seen = set()
    for k in range(12):
        key = jax.random.key(k)
        shift, flip = _jax_aug(key)
        seen.add(flip)
        np.testing.assert_array_equal(bcr_augment(_t(x), shift, flip).numpy(),
                                      np.asarray(j_aug(x, key)))
    assert seen == {True, False}
    draws = [bcr_draw(torch.Generator().manual_seed(s)) for s in range(20)]
    assert all(-4 <= d <= 4 for (sh, _) in draws for d in sh)
    assert {f for _, f in draws} == {True, False}


@pytest.fixture(scope="module")
def gan_step(gan):
    """One ``d_step`` then one ``g_step`` on both sides, SGD at LR: JAX's
    ``make_gan_steps`` with ``optax.sgd``, the port's with the trainers'
    ``Optimizer`` over ``torch.optim.SGD``, fed JAX's draws."""
    from kuzu.models.stackgan import make_gan_steps as j_steps

    from kuzu_torch.core.train import Optimizer
    from kuzu_torch.models.stackgan import make_gan_steps

    gen, discs, gp, dps, tgen, tdiscs = gan
    batch = _batch()
    tx = optax.sgd(LR)
    d_step, g_step = j_steps(gen, discs, tx, tx, bcr_weight=1.0)
    kd, kg = jax.random.key(10), jax.random.key(11)
    jd_params, _, jd_loss = d_step(dps, [tx.init(p) for p in dps], gp, batch, kd)
    jg_params, _, jg_loss = g_step(gp, tx.init(gp), jd_params, batch, kg)
    z_key, *stage_keys = jax.random.split(kd, 4)
    draws = {"z": _t(jax.random.normal(z_key, (2, 16))),
             "aug": [_jax_aug(k) for k in stage_keys]}
    gz = _t(jax.random.normal(kg, (2, 16)))

    def sgd(m):
        return Optimizer(torch.optim.SGD(m.parameters(), lr=LR), lambda c: LR, 0.0)

    t_d, t_g = make_gan_steps(tgen, tdiscs, sgd(tgen), [sgd(d) for d in tdiscs], bcr_weight=1.0)
    tb = {"image": _t(batch["image"]), "label": _t(batch["label"])}
    td_loss = t_d(tb, draws)
    tg_loss = t_g(tb, gz)
    return dict(jax=(numpy_tree(jd_params), float(jd_loss), numpy_tree(jg_params), float(jg_loss)),
                port=([flax_variables(d, collections=("params",))["params"] for d in tdiscs],
                      float(td_loss), flax_variables(tgen, collections=("params",))["params"],
                      float(tg_loss)),
                before=(dps, gp))


def _updates_close(new, want, old, what):
    """Each leaf's update (new - old) within 1e-4 of the largest update of
    that leaf."""
    want_leaves, old_leaves = dict(_leaves(want)), dict(_leaves(old))
    for name, got in _leaves(new):
        _close(got - old_leaves[name], want_leaves[name] - old_leaves[name], rel=1e-4,
               what=f"{what} {name}")


def test_gan_d_step_matches_jax(gan_step):
    jd, jdl, _, _ = gan_step["jax"]
    td, tdl, _, _ = gan_step["port"]
    dps, _ = gan_step["before"]
    _close(tdl, jdl, what="d loss")
    for i in range(3):
        _updates_close(td[i], jd[i], dps[i], f"discriminator {i}")


def test_gan_g_step_matches_jax(gan_step):
    _, _, jg, jgl = gan_step["jax"]
    _, _, tg, tgl = gan_step["port"]
    _, gp = gan_step["before"]
    _close(tgl, jgl, what="g loss")
    _updates_close(tg, jg, gp, "generator")
