"""Move state between the JAX package and the port.

The JAX package's NamedTuples (``CMAState``, ``LadderCarry``, ``CMAParams``,
``BBOBInstance``, the strategies' ``KDistCarry`` and ``KRepCarry``), with
every leaf passed as a numpy array (``np.asarray``
of each leaf), become the port's tensors on a given device; ``to_numpy``
goes back.  Fields are matched by name.  uint32 arrays (PRNG keys) become
the port's int64-held words.  Nothing here imports the JAX package.
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
    """One numpy leaf as a tensor (uint32 widened to int64)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _named(cls, obj, device):
    return cls(*(tensor(getattr(obj, f), device) for f in cls._fields))


def cma_state(state, device) -> CMAState:
    """A slot-stacked state (leaves with a leading slot axis)."""
    return _named(CMAState, state, device)


def cma_params(params, device) -> CMAParams:
    return _named(CMAParams, params, device)


def bbob_instance(inst, device) -> BBOBInstance:
    return _named(BBOBInstance, inst, device)


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


def to_numpy(tree):
    """A NamedTuple of tensors (nested NamedTuples too) as numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return type(tree)(*(to_numpy(leaf) for leaf in tree))
