"""The training engine's parts beside the trainers: the port's RAdam
(``optimizer=radam`` and ``radam_schedulefree``) against
the JAX package's optax chain on the CPU: ``kuzu.core.train.build_optimizer``
builds both names as ``clip_by_global_norm -> add_decayed_weights (ndim >=
2) -> optax.radam(b1=momentum)``; the port's ``build_optimizer`` builds its
:class:`RAdam` the same way. Twelve updates of seeded gradients cover
RAdam's unrectified first steps (ro < 5: the bias-corrected momentum alone)
and its rectified ones, with warmup, linear decay, the clip active on some
steps and the decay on the kernel only. Each step's weights: 1e-6 relative
plus 1e-7 of lr0 (f32 on both sides, the same operations in the same
order). And the standalone ``DetectValidator`` over a run dir.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

STEPS = 12
SCALES = (2.0, 0.1, 3.0, 0.05, 1.0, 0.02, 5.0, 0.3, 0.01, 1.5, 0.2, 4.0)


def _module(w0: dict) -> torch.nn.Module:
    module = torch.nn.Module()
    for k, v in w0.items():
        setattr(module, k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    return module


@pytest.mark.parametrize("name", ["radam", "radam_schedulefree"])
def test_radam_matches_optax_over_steps(name):
    from kuzu.core.config import load_config as j_load_config
    from kuzu.core.train import build_optimizer as j_build_optimizer

    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import RAdam, build_optimizer

    over = dict(optimizer=name, lr0=0.01, lrf=0.1, epochs=3, warmup_epochs=0.5,
                weight_decay=0.1, grad_clip=1.0, momentum=0.9)
    rng = np.random.default_rng(3)
    w0 = {"kernel": rng.normal(0, 1, (4, 3)).astype(np.float32),
          "bias": rng.normal(0, 1, (3,)).astype(np.float32)}
    grads = [{k: rng.normal(0, s, v.shape).astype(np.float32) for k, v in w0.items()}
             for s in SCALES]
    jtx = j_build_optimizer(j_load_config(overrides=over), 4)
    jp = jax.tree.map(jnp.asarray, w0)
    jstate = jtx.init(jp)
    module = _module(w0)
    tx = build_optimizer(load_config(overrides=over), module, steps_per_epoch=4)
    assert type(tx.inner) is RAdam  # not schedule-free, as in JAX
    clipped = []
    for step, g in enumerate(grads):
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        norm = torch.linalg.vector_norm(torch.cat([p.grad.flatten()
                                                   for p in module.parameters()]))
        clipped.append(float(norm) > over["grad_clip"])
        tx.step(step, norm)
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7 * over["lr0"], err_msg=f"{k} step {step}")
    assert any(clipped) and not all(clipped)
    b2 = 0.999
    ro_inf = 2 / (1 - b2) - 1
    ro = [ro_inf - 2 * t * b2 ** t / (1 - b2 ** t) for t in range(1, STEPS + 1)]
    assert sum(r < 5 for r in ro) >= 4 and sum(r >= 5 for r in ro) >= 4  # both phases


def test_radam_freezes_what_has_no_grad():
    """Only parameters with ``requires_grad`` are stepped (LoRA's frozen
    base): a frozen kernel keeps its weights and holds no state."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import build_optimizer

    w0 = {"kernel": np.ones((2, 2), np.float32), "frozen": np.ones((2, 2), np.float32)}
    module = _module(w0)
    module.frozen.requires_grad_(False)
    tx = build_optimizer(load_config(overrides=dict(optimizer="radam", lr0=0.1,
                                                    warmup_epochs=0.0)), module, 1)
    assert tx.params() == [module.kernel]
    module.kernel.grad = torch.ones(2, 2)
    tx.step(0, torch.tensor(2.0))
    assert float(module.kernel.detach()[0, 0]) < 1.0 and torch.equal(module.frozen, torch.ones(2, 2))


def test_detect_validator_matches_the_trainers_validate(tmp_path):
    """``DetectValidator`` over a one-epoch yolov12n@64 run dir (its
    ``args.yaml`` the config, the trainer class a ``trainer_for`` one, the
    run's EMA weights loaded as the live ones) returns the metrics of the
    trainer's own ``validate`` on its final state (one epoch: best is
    last), exactly, and its ``validate`` sees the run's EMA weights (a
    seeded detector after 2 steps scores 0 mAP, so the weights are
    compared too)."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.tasks.detect import DetectValidator, trainer_for
    from kuzu_torch.testing import SyntheticDetectionDataset

    train_ds = SyntheticDetectionDataset(4, 64, max_boxes=8, nc=2, seed=0)
    val_ds = SyntheticDetectionDataset(2, 64, max_boxes=8, nc=2, seed=1)
    cls = trainer_for((train_ds, val_ds, 2))
    cfg = load_config(overrides=dict(model="yolov12n", imgsz=64, batch=2, epochs=1, workers=0,
                                     project=str(tmp_path), name="run", exist_ok=True,
                                     verbose=False))
    trainer = cls(cfg, device="cpu")
    trainer.train()
    want = trainer.validate(trainer.state)
    seen = {}

    class Seen(cls):  # the weights the validator's validate folds
        def validate(self, state):
            seen.update(state.ema_state_dict())
            return super().validate(state)

    validator = DetectValidator(load_config(overrides={"model": str(trainer.save_dir)}),
                                device="cpu")
    validator.trainer_cls = Seen
    got = validator.run()
    assert {"map50", "map", "fitness"} <= set(got) and got == want
    ema = trainer.state.ema_state_dict()
    assert sorted(seen) == sorted(ema) and all(torch.equal(seen[k], ema[k]) for k in ema)


def test_global_norm_is_accurate_on_the_cpu():
    """``global_norm`` (the clip's norm and the ``grad_norm`` metric) of a
    2.45M-entry f32 gradient (the CTC head's, 4788 x 512) and a small one,
    within 1e-6 of the f64 norm, as ``optax.global_norm``'s XLA reduction
    is: torch's f32 ``vector_norm`` on the CPU reads 4e-5 to 8e-4 low at
    this size."""
    from kuzu_torch.core.train import global_norm

    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn((4788, 512), generator=gen) * 1e-3, torch.randn((7,), generator=gen)]
    want = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    got = global_norm(grads)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
