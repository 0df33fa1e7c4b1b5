"""The port's trainer (``repro_torch.train.trainer``) and training launcher
on the CPU at the qwen2 smoke config: the loss falls, a restart from a
checkpoint replays the uninterrupted run bit for bit, the NaN-skip budget
holds, a checkpoint written by the JAX package's trainer restores into the
port's and the next step matches JAX's, and the CLI runs.

The JAX package's trainer is run with its parameter tree in sorted key
order: its ``adamw_update`` pairs the leaves in sorted order with the
decay mask's paths in insertion order, so only a sorted tree gets the
mask ``_decayable`` names (ROADMAP.md, queue C).  Tolerances against it:
the loss to 1e-5 relative, grad_norm to 1e-4, the moments to 1e-4 of
each leaf's largest |value| (float32; the gradients' f32 sums in other
orders, as ``tests/test_torch_train.py`` holds them), the parameters
after the step to that or 1e-2 of the step's lr, whichever is larger: a
leaf that starts at zero (the biases) holds only Adam's normalised steps,
and an element with a small gradient moves by up to lr on f32 noise.
"""
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro.train import trainer as jtrainer
from repro_torch.checkpoint import store
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.launch import train as tlaunch
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.train import trainer as ttrainer
from torch_threads import one_thread  # noqa: F401


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _tc(ckpt_dir, steps, ckpt_every, total=6, **kw):
    return ttrainer.TrainerConfig(
        total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir),
        log_every=100, train=tts.TrainConfig(adamw=topt.AdamWConfig(
            lr=3e-3, warmup_steps=2, total_steps=total)), **kw)


def _trainer(tc, cfg=None):
    return ttrainer.Trainer(cfg or t_smoke("qwen2-0.5b"), tc, seq_len=32,
                            global_batch=4, log_fn=lambda _m: None,
                            device="cpu")


def test_loss_falls_and_restart_replays(tmp_path):
    full = _trainer(_tc(tmp_path / "full", 6, 3))
    full.run()
    losses = [h["loss"] for h in full.history]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
    assert store.latest_step(str(tmp_path / "full")) == 6
    # a run that stops after its step-3 checkpoint, then the restart
    cut = _trainer(_tc(tmp_path / "cut", 3, 3))
    p3, o3 = cut.run()
    assert store.latest_step(str(tmp_path / "cut")) == 3
    again = _trainer(_tc(tmp_path / "cut", 6, 3))
    rp, ro, step = again.try_restore(*again.init_state())
    assert step == 3 and ro.step.shape == () and int(ro.step) == 3
    for a, b in zip(tts.leaves((rp, ro.mu, ro.nu)),
                    tts.leaves((p3, o3.mu, o3.nu))):
        assert torch.equal(a, b)
    again.run()
    assert [h["step"] for h in again.history] == [3, 4, 5]
    assert [h["loss"] for h in again.history] == losses[3:]
    assert [h["loss"] for h in cut.history] == losses[:3]


def test_nan_steps_are_skipped_within_budget(tmp_path):
    t = _trainer(_tc(tmp_path / "nan", 4, 100, max_skipped=2))
    step_fn, calls = t.step_fn, []

    def poisoned(params, opt, batch):
        p2, o2, m = step_fn(params, opt, batch)
        calls.append(int(opt.step))
        if len(calls) in (2, 3):
            m = dict(m, loss=torch.tensor(float("nan")))
        return p2, o2, m
    t.step_fn = poisoned
    params, opt = t.run()
    # steps 1 and 2 were dropped: their updates never landed
    assert calls == [0, 1, 1, 1]
    assert int(opt.step) == 2
    t2 = _trainer(_tc(tmp_path / "nan2", 4, 100, max_skipped=1))
    t2.step_fn = lambda p, o, b: (p, o, {"loss": torch.tensor(float("nan")),
                                        "grad_norm": torch.tensor(0.0),
                                        "lr": torch.tensor(0.0)})
    with pytest.raises(RuntimeError, match="NaN budget"):
        t2.run()


def test_jax_checkpoint_restores_and_steps_as_jax(tmp_path, monkeypatch):
    jcfg = dataclasses.replace(j_smoke("qwen2-0.5b"), dtype="float32")
    tcfg = dataclasses.replace(t_smoke("qwen2-0.5b"), dtype="float32")
    plain_init = jtrainer.Trainer.init_state

    def sorted_init(self, key=None):
        params, opt = plain_init(self, key)
        return _sorted(params), jopt.init_opt_state(_sorted(params))
    monkeypatch.setattr(jtrainer.Trainer, "init_state", sorted_init)

    def jtc(steps):
        return jtrainer.TrainerConfig(
            total_steps=steps, ckpt_every=100, ckpt_dir=str(tmp_path / "j"),
            log_every=100, train=jts.TrainConfig(adamw=jopt.AdamWConfig(
                lr=3e-3, warmup_steps=2, total_steps=6)))
    jtrainer.Trainer(jcfg, jtc(2), seq_len=32, global_batch=4,
                     log_fn=lambda _m: None).run()
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jnext = jtrainer.Trainer(jcfg, jtc(3), seq_len=32, global_batch=4,
                             log_fn=lambda _m: None)
    jp, jo = jnext.run()
    tnext = _trainer(_tc(tmp_path / "t", 3, 100), tcfg)
    tp, to = tnext.run()
    (jh,), (th,) = jnext.history, tnext.history
    assert jh["step"] == th["step"] == 2
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    np.testing.assert_allclose(th["grad_norm"], jh["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(th["lr"], jh["lr"], rtol=1e-6)
    assert int(to.step) == int(jo.step) == 3
    for got, want, floor in ((tp, jp, 1e-2 * th["lr"]), (to.mu, jo.mu, 0.0),
                             (to.nu, jo.nu, 0.0)):
        for g, w in zip(tts.leaves(got), jax.tree_util.tree_leaves(want)):
            w = np.asarray(w, np.float64)
            err = np.abs(g.numpy() - w).max()
            assert err <= max(1e-4 * np.abs(w).max(), floor)


def test_launcher_runs_and_refuses_a_mesh(tmp_path, capsys):
    t = tlaunch.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--seq-len", "32", "--global-batch",
                      "2", "--ckpt-dir", str(tmp_path / "c"),
                      "--grad-compress", "int8", "--microbatches", "2"])
    assert [h["step"] for h in t.history] == [0, 1]
    assert "[train] done: 2 steps" in capsys.readouterr().out
    assert store.latest_step(str(tmp_path / "c")) == 2
    with pytest.raises(NotImplementedError, match="item 16"):
        tlaunch.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                      "--model-parallel", "2"])
    with pytest.raises(NotImplementedError, match="item 16"):
        ttrainer.Trainer(t_smoke("qwen2-0.5b"), _tc(tmp_path, 1, 1), 32, 2,
                         mesh=object(), device="cpu")
