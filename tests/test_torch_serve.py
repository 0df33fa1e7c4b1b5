"""The port's serving path (repro_torch.serve.engine, launch/serve.py)
against the JAX package's engine at the smoke configs, float32, on the same
weights (``convert.lm_params``) and prompts.

Under teacher forcing both engines are fed the JAX engine's greedy tokens
and every step's logits (the prefill's and each decode step's) must agree
within 1e-4 of the largest |logit|.  Left to itself the port's greedy
engine must pick the JAX engine's tokens wherever JAX's top-1/top-2 gap
exceeds ten times that tolerance (a smaller gap is a tie the rounding may
break either way; after a broken tie the contexts differ and the
comparison of that request stops)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import lm as jlm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import configs, convert
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import Engine, Request
from torch_threads import one_thread  # noqa: F401

TOL = 1e-4
CASES = [("qwen2-0.5b", dict(attn_impl="flash")), ("rwkv6-3b", {})]


def _setup(arch, kw, seed=0):
    jc = dataclasses.replace(j_smoke_config(arch), dtype="float32", **kw)
    tc = configs.override(configs.smoke_config(arch), dtype="float32", **kw)
    p = jax.tree_util.tree_map(np.asarray,
                               jlm.init_params(jc, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        p)
    return jc, tc, p


def _prompts(vocab, seed, lens=(12, 9, 12)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,), dtype=np.int32) for n in lens]


def _jax_logits(eng, prompts, tokens):
    """The JAX engine's logits under its own greedy tokens: the prefill's,
    then each decode step's, (n + 1, B, V)."""
    B, S = len(prompts), max(len(p) for p in prompts)
    toks = np.zeros((B, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    logits, cache = eng._prefill(eng.params, {"tokens": jnp.asarray(toks)})
    out = [np.asarray(logits)]
    for t in range(tokens.shape[1]):
        _, logits, cache = eng._step(eng.params, cache,
                                     {"tokens": jnp.asarray(tokens[:, t:t + 1])})
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.mark.parametrize("arch,kw", CASES)
def test_engine_generate_matches_jax(arch, kw):
    jc, tc, p = _setup(arch, kw)
    prompts = _prompts(jc.vocab, 1)
    new = 6
    jeng = JEngine(jc, jax.tree_util.tree_map(jnp.asarray, p), max_len=32)
    jreqs = jeng.generate([JRequest(prompt=q, max_new_tokens=new)
                           for q in prompts])
    jtok = np.stack([r.out for r in jreqs])
    want = _jax_logits(jeng, prompts, jtok)

    eng = Engine(tc, convert.lm_params(tc, p, device="cpu"), max_len=32, device="cpu")
    reqs, got = eng.generate([Request(prompt=q, max_new_tokens=new)
                              for q in prompts], forced=jtok,
                             return_logits=True)
    assert got.shape == want.shape == (new + 1, len(prompts), jc.vocab)
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    assert err <= TOL, f"teacher-forced logits: relative error {err:.3e}"
    np.testing.assert_array_equal(np.stack([r.out for r in reqs]), jtok)
    assert eng.stats["steps"] == new and eng.stats["prefill_ms"] > 0

    free = eng.generate([Request(prompt=q, max_new_tokens=new)
                         for q in prompts])
    top2 = np.sort(want, axis=-1)[..., -2:]
    gap = (top2[..., 1] - top2[..., 0]) / scale
    compared = 0
    for i, r in enumerate(free):
        for t in range(new):
            if r.out[t] != jtok[i, t]:
                assert gap[t, i] <= 10 * TOL, (
                    f"request {i} step {t}: token {r.out[t]} against "
                    f"{jtok[i, t]} with a gap of {gap[t, i]:.3e}")
                break
            compared += 1
    assert compared >= new


def test_engine_same_prompt_same_continuation():
    """As ``tests/test_serve.py`` checks the JAX engine: identical prompts
    in one batch get identical greedy continuations, in range."""
    cfg = configs.smoke_config("qwen2-0.5b")
    eng = Engine(cfg, tlm.init_params(cfg, 0, "cpu"), max_len=64,
                 device="cpu")
    q = _prompts(cfg.vocab, 2, (12,))[0]
    reqs = eng.generate([Request(prompt=q, max_new_tokens=6),
                         Request(prompt=q, max_new_tokens=4)])
    assert reqs[0].out.shape == (6,) and reqs[1].out.shape == (4,)
    assert np.all((0 <= reqs[0].out) & (reqs[0].out < cfg.vocab))
    np.testing.assert_array_equal(reqs[0].out[:4], reqs[1].out)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_serve_launcher_runs_on_cpu(arch, capsys):
    """Every token-input arch serves; the archs fed by a stub frontend
    (frames, image embeddings) are refused, as the JAX package's launcher
    refuses them."""
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "8",
            "--new-tokens", "4", "--max-len", "32", "--device", "cpu"]
    cfg = configs.smoke_config(arch)
    if not cfg.embed_inputs or cfg.family == "vlm":
        with pytest.raises(SystemExit, match="supports token-input archs"):
            tserve.main(argv)
        return
    tserve.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] 8 tokens in ")
    assert out[1].startswith("  req0: [") and out[2].startswith("  req1: [")


def test_serving_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.smoke_config("rwkv6-3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_params(cfg)
    params = tlm.init_params(cfg, 0, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "rwkv6-3b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "gemma3-4b", "--smoke"])
    with pytest.raises(KeyError, match="unknown arch"):
        tserve.main(["--arch", "gpt-2", "--smoke", "--device", "cpu"])
