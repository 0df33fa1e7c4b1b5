"""Move state between the JAX package and the port.

The JAX package's NamedTuples (``CMAState``, ``LadderCarry``, ``CMAParams``,
``BBOBInstance``, the strategies' ``KDistCarry`` and ``KRepCarry``), with
every leaf passed as a numpy array (``np.asarray``
of each leaf), become the port's tensors on a given device; ``to_numpy``
goes back.  Fields are matched by name.  uint32 arrays (PRNG keys) become
the port's int64-held words.  The LM's parameter and cache trees (nested
dicts) go across with ``lm_params`` and ``lm_cache``, its AdamW state with
``opt_state``.  Nothing here imports
the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cmaes import CMAState
from repro_torch.core.ladder import LadderCarry
from repro_torch.core.params import CMAParams
from repro_torch.core.strategies import KDistCarry, KRepCarry
from repro_torch.fitness.bbob import BBOBInstance


def tensor(a, device) -> torch.Tensor:
    """One numpy leaf as a tensor (uint32 widened to int64; bfloat16, which
    numpy holds as ``ml_dtypes.bfloat16``, kept bfloat16)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    if a.dtype.name == "bfloat16":
        bits = np.array(a, copy=True).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _named(cls, obj, device):
    return cls(*(tensor(getattr(obj, f), device) for f in cls._fields))


def cma_state(state, device) -> CMAState:
    """A slot-stacked state (leaves with a leading slot axis)."""
    return _named(CMAState, state, device)


def cma_params(params, device) -> CMAParams:
    return _named(CMAParams, params, device)


def bbob_instance(inst, device) -> BBOBInstance:
    """One instance, its Gallagher peak leaves included."""
    return _named(BBOBInstance, inst, device)


def bbob_instances(insts, device) -> BBOBInstance:
    """A list of the JAX package's instances, stacked as
    ``bbob.stack_instances`` stacks the port's (peaks padded)."""
    from repro_torch.fitness.bbob import stack_instances
    return stack_instances([bbob_instance(i, device) for i in insts])


def ladder_carry(carry, device) -> LadderCarry:
    fields = {f: tensor(getattr(carry, f), device)
              for f in LadderCarry._fields if f != "states"}
    return LadderCarry(states=cma_state(carry.states, device), **fields)


def kdist_carry(carry, device) -> KDistCarry:
    """K-Distributed's carry: descent-stacked states and (D,) counters."""
    fields = {f: tensor(getattr(carry, f), device)
              for f in KDistCarry._fields if f != "states"}
    return KDistCarry(states=cma_state(carry.states, device), **fields)


def krep_carry(carry, device) -> KRepCarry:
    """K-Replicated's carry of one phase, its group states stacked (G, ...)
    as ``KReplicated.run_sim`` holds them between chunks."""
    fields = {f: tensor(getattr(carry, f), device)
              for f in KRepCarry._fields if f != "state"}
    return KRepCarry(state=cma_state(carry.state, device), **fields)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return tensor(tree, device)


def lm_params(cfg, tree, device) -> dict:
    """The JAX package's ``lm.init_params`` tree (numpy leaves) as the
    port's: the same nested keys, every leaf a tensor of the same shape and
    dtype, for every family.  ``cfg`` must be one the port runs
    (``lm.check_supported``)."""
    from repro_torch.models import lm
    lm.check_supported(cfg)
    return _tree(tree, device)


def opt_state(tree, device):
    """The JAX package's ``OptState(mu, nu, step)`` (numpy leaves) as the
    port's ``train.optimizer.OptState``: moments as f32 tensors in the same
    nested dicts, ``step`` a 0-d int32 tensor."""
    from repro_torch.train.optimizer import OptState
    return OptState(mu=_tree(tree.mu, device), nu=_tree(tree.nu, device),
                    step=tensor(tree.step, device).to(torch.int32))


def lm_cache(tree, device) -> dict:
    """A prefill cache of the JAX package (``lm.init_cache``/``prefill``,
    numpy leaves) as the port's cache dict."""
    return _tree(tree, device)


def to_numpy(tree):
    """A NamedTuple of tensors (nested NamedTuples too) as numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return type(tree)(*(to_numpy(leaf) for leaf in tree))


#: leaves of a campaign-service snapshot (``service/server.py``) whose
#: dtype differs between the JAX package's and the port's: last path
#: component → (JAX dtype, port dtype).  ``checkpoint.store.restore``
#: casts each to the port's template (uint32 keys widened to int64), so a
#: JAX snapshot restores into the port's server.
SNAPSHOT_LEAVES = {"keys": ("uint32", "int64")}
