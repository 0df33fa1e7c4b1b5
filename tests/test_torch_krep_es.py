"""Whole runs of the port's K-Replicated and of its ``launch/es.py`` against
repro's, on the CPU.

* ``KReplicated.run_sim`` at 2, 4 and 8 virtual devices: the phases, their
  λ, group counts and evaluations exactly, best values to 1e-9 relative;
* ``repro_torch.launch.es --device cpu --json`` for ``seq``, ``kdist`` and
  ``krep`` at dim 4 against ``repro.launch.es --json``: the evaluations
  equal, ``best_error`` to 1e-9 relative (``wall_s`` is not compared).

The JAX side's ``eigen_decompose`` carries the port's sign convention.
"""
import json

import jax
import numpy as np
import pytest
from test_torch_ladder import _signed_eigen

from repro.core import cmaes as jcmaes
from repro.core import strategies as jst
from repro.fitness import bbob as jb
from repro.launch import es as jes
from repro_torch.core import strategies as tst
from repro_torch.fitness import bbob as tb
from repro_torch.launch import es as tes

N = 4


@pytest.fixture(autouse=True)
def signed_jax_eigen(monkeypatch):
    monkeypatch.setattr(jcmaes, "eigen_decompose", _signed_eigen)


@pytest.mark.parametrize("P,fid,phase_gens,impl,drop,max_evals", [
    (2, 1, 40, "eager", 0.0, None),
    (4, 2, 60, "eager_unfused", 0.2, 6000),
    (8, 8, 24, "eager", 0.0, 5000)])
def test_krep_run_sim_matches_jax(P, fid, phase_gens, impl, drop, max_evals):
    ji = jb.make_instance(fid, N, 1)
    ti = tb.make_instance(fid, N, 1, device="cpu")
    jimpl = {"eager": "xla", "eager_unfused": "xla_unfused"}[impl]
    want = jst.KReplicated(n=N, n_devices=P, impl=jimpl,
                           drop_prob=drop).run_sim(
        jax.random.PRNGKey(5), lambda X: jb.evaluate(fid, ji, X),
        phase_gens, max_evals=max_evals)
    got = tst.KReplicated(n=N, n_devices=P, impl=impl, drop_prob=drop,
                          device="cpu").run_sim(
        5, lambda X: tb.evaluate(fid, ti, X), phase_gens,
        max_evals=max_evals)
    assert got["fevals"] == want["fevals"]
    np.testing.assert_allclose(got["best_f"], want["best_f"], rtol=1e-9)
    assert len(got["phases"]) == len(want["phases"]) >= 2
    for pg, pw in zip(got["phases"], want["phases"]):
        for k in ("k_exp", "lam", "n_groups"):
            assert pg[k] == pw[k], k
        for k in ("fevals", "n_stopped"):
            np.testing.assert_array_equal(pg[k], pw[k], err_msg=k)
        for k in ("best_f", "group_best"):
            np.testing.assert_allclose(pg[k], pw[k], rtol=1e-9, err_msg=k)


def _json_line(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", [
    ["--strategy", "seq", "--max-evals", "1500"],
    ["--strategy", "kdist", "--devices", "7", "--gens", "40"],
    ["--strategy", "krep", "--devices", "4", "--gens", "24",
     "--max-evals", "4000"]])
def test_es_cli_matches_jax(argv, capsys):
    argv = argv + ["--dim", str(N), "--json"]
    want = _json_line(jes.main, argv, capsys)
    got = _json_line(tes.main, argv + ["--device", "cpu"], capsys)
    assert {k: got[k] for k in ("strategy", "fid", "dim")} == \
        {k: want[k] for k in ("strategy", "fid", "dim")}
    assert got["fevals"] == want["fevals"]
    np.testing.assert_allclose(got["best_error"], want["best_error"],
                               rtol=1e-9)
