"""The port's checkpoint store (``repro_torch/checkpoint/store.py``) against
the JAX package's: the same on-disk layout, so each reads the other's
steps bit for bit; ``.tmp`` and uncommitted steps are never taken; the
async writer, ``prune``, ``latest_step``, ``load_meta`` and the device and
dtype of restored leaves."""
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro_torch.checkpoint import store as tstore
from torch_threads import one_thread  # noqa: F401


class Pair(NamedTuple):
    a: np.ndarray
    b: np.ndarray


def _leaves(rng):
    """int64, uint32 and float64 leaves (keys, counters, states)."""
    return (rng.integers(-2 ** 40, 2 ** 40, (3, 2), dtype=np.int64),
            rng.integers(0, 2 ** 32, (2,), dtype=np.uint64).astype(np.uint32),
            rng.standard_normal((4, 5)))


def _tree(kind, rng):
    i64, u32, f64 = _leaves(rng)
    if kind == "namedtuple":
        return Pair(a=f64, b={"key": u32, "count": i64})
    if kind == "dict":
        return {"z": f64, "a": {"key": u32}, "m": i64}
    return [f64, [u32, i64]]


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in tstore._flatten(tree).items()}


def _as_torch(tree):
    """The port's form of a tree: tensors, the uint32 leaves as int64."""
    def leaf(x):
        x = np.asarray(x)
        return torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32
                                else x.copy())
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_as_torch(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return leaf(tree)


@pytest.mark.parametrize("kind", ["namedtuple", "dict", "list"])
def test_port_restores_jax_checkpoint(kind, tmp_path):
    """JAX ``save`` → port ``restore``: every leaf's bits, uint32 keys
    widened to int64 (the port's key words)."""
    tree = _tree(kind, np.random.default_rng(0))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jstore.save(str(tmp_path), 3, jtree, meta={"kind": kind})
    assert tstore.latest_step(str(tmp_path)) == 3
    assert tstore.load_meta(str(tmp_path), 3) == {"kind": kind}
    back = tstore.restore(str(tmp_path), 3, _as_torch(tree))
    want, got = _flat_np(tree), tstore._flatten(back)
    assert set(want) == set(got)
    for k, w in want.items():
        g = got[k]
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        if w.dtype == np.uint32:
            assert g.dtype == torch.int64
            w = w.astype(np.int64)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
        assert g.numpy().dtype == w.dtype, k


@pytest.mark.parametrize("kind", ["namedtuple", "dict", "list"])
def test_jax_restores_port_checkpoint(kind, tmp_path):
    """Port ``save`` (tensors and numpy leaves) → JAX ``restore`` against
    a template of the JAX package's dtypes: the same bits."""
    tree = _tree(kind, np.random.default_rng(1))
    ttree = _as_torch(tree)
    # the uint32 key leaf rides as numpy: torch has no general uint32
    if kind == "namedtuple":
        ttree = ttree._replace(b={**ttree.b, "key": tree.b["key"]})
    elif kind == "dict":
        ttree["a"]["key"] = tree["a"]["key"]
    else:
        ttree[1][0] = tree[1][0]
    tstore.save(str(tmp_path), 5, ttree, meta={"n": 1})
    assert jstore.latest_step(str(tmp_path)) == 5
    assert jstore.load_meta(str(tmp_path), 5) == {"n": 1}
    template = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype),
        tree)
    back = jstore.restore(str(tmp_path), 5, template)
    for k, w in _flat_np(tree).items():
        g = np.asarray(jstore._flatten(back)[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_layout_matches_jax_file_for_file(tmp_path):
    """The same tree saved by both packages gives the same files and the
    same manifest."""
    import json
    tree = _tree("namedtuple", np.random.default_rng(2))
    tree = tree._replace(b={"count": tree.b["count"]})
    jstore.save(str(tmp_path / "j"), 1, jax.tree_util.tree_map(
        jnp.asarray, tree))
    tstore.save(str(tmp_path / "t"), 1, _as_torch(tree))
    dj, dt = tmp_path / "j" / "step_00000001", tmp_path / "t" / "step_00000001"
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    assert json.loads((dj / "manifest.json").read_text()) == \
        json.loads((dt / "manifest.json").read_text())


def test_tmp_and_uncommitted_steps_are_not_taken(tmp_path):
    d = str(tmp_path)
    tstore.save(d, 2, {"x": torch.arange(3)})
    os.makedirs(os.path.join(d, "step_00000009.tmp"))      # a torn write
    os.makedirs(os.path.join(d, "step_00000007"))          # no manifest
    assert tstore.latest_step(d) == jstore.latest_step(d) == 2
    assert tstore.latest_step(str(tmp_path / "absent")) is None
    assert tstore.load_meta(d, 2) is None
    assert sorted(tstore.latest_candidates(d)) == [2, 7]


def test_async_save_copies_before_returning(tmp_path):
    """``blocking=False`` writes on a thread; the tensors are copied to the
    host first, so writing into them afterwards changes nothing saved."""
    x = torch.arange(6, dtype=torch.float64)
    th = tstore.save(str(tmp_path), 4, {"x": x}, blocking=False,
                     meta={"a": 1})
    x.fill_(-1.0)
    th.join()
    back = tstore.restore(str(tmp_path), 4, {"x": x})
    np.testing.assert_array_equal(back["x"].numpy(), np.arange(6.0))
    assert tstore.load_meta(str(tmp_path), 4) == {"a": 1}


def test_prune_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    for s in (1, 3, 5, 8):
        tstore.save(d, s, {"x": torch.zeros(1)})
    tstore.prune(d, keep=2)
    assert sorted(tstore.latest_candidates(d)) == [5, 8]
    assert tstore.latest_step(d) == 8
    tstore.prune(str(tmp_path / "absent"))                 # no directory


def test_restore_places_and_checks_leaves(tmp_path):
    """Leaves go to ``device`` or the template tensor's device, cast to
    the template's dtype; a shape mismatch and a missing leaf raise."""
    from repro_torch.core.ipop import ShapeDtype
    d = str(tmp_path)
    tstore.save(d, 1, {"a": torch.arange(4, dtype=torch.int32),
                       "b": np.ones((2, 2))})
    out = tstore.restore(d, 1, {"a": ShapeDtype((4,), np.dtype(np.int64)),
                                "b": torch.zeros((2, 2))}, device="cpu")
    assert out["a"].dtype == torch.int64 and out["b"].dtype == torch.float32
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(4))
    with pytest.raises(ValueError, match="shape"):
        tstore.restore(d, 1, {"a": torch.zeros(5), "b": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="missing"):
        tstore.restore(d, 1, {"c": torch.zeros(1)})
