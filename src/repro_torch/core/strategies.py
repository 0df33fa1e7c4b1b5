"""K-Replicated and K-Distributed (paper §3.2) on one card — port of
``repro/core/strategies.py`` without its mesh drivers.

The JAX package writes both strategies from the per-device view with
named-axis collectives and simulates P devices with ``vmap``.  Here the P
virtual devices are a leading tensor axis (``core/eval_dispatch.py``): an
all-gather is the tensor itself, a psum a sum over the devices of one
descent.  No device holds a copy of its descent's state: the descent
states stay stacked (D, ...), and the sample op reads each descent's state
for the rows of its devices (``cmaes.sample_population``, the grouped
sample kernel on the card).

K-Distributed: one flat axis of P devices.  Descent k ∈ {0..K_max} owns the
contiguous heap range [2ᵏ−1, 2ᵏ⁺¹−1); the devices past n_active = 2^{K_max+1}−1
sample with the last descent's state and their fitness is +inf.  A
descent's gram family ``Ysᵀ·[Ys | √w]`` is one product over the rows of its
devices (a plain product, as the JAX package leaves it to XLA), where the
JAX package takes per-device partials and one stacked psum: the same sum
in another order, so parity is to tolerance, not bits.

K-Replicated: per phase, the devices form G = P/g groups of g = 2ᵏ, one
descent each, with states (G, ...); phases end when every group's descent
stopped or the budget is spent (a host read per chunk, as in JAX).

Not ported (ROADMAP.md): ``run_on_mesh``, ``lower_step`` and
``lower_phase`` (shard_map and HLO work, for the mesh slice).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cmaes, eval_dispatch, ladder, prng
from repro_torch.core.device import resolve_device
from repro_torch.core.params import (CMAConfig, CMAParams, broadcast_params,
                                     make_params, stack_params)
from repro_torch.kernels import ops as kops

COMM_CHOICES = ("stacked", "central")


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def heap_descent_of(idx: torch.Tensor, n_active: int) -> torch.Tensor:
    """Descent index of device ``idx`` in the heap layout (K-Dist): the
    floor of float64 log2(i + 1.5), i clipped to the active devices."""
    i = torch.clamp(idx, 0, n_active - 1)
    return torch.floor(torch.log2(i.to(torch.float64) + 1.5)).to(torch.int32)


def _apply_drop(keys: torch.Tensor, f: torch.Tensor,
                drop_prob: float) -> torch.Tensor:
    """Straggler/failure simulation: masked evaluations become +inf.  Each
    device draws float64 uniforms of its row count from its key (P, 2), as
    ``jax.random.uniform`` does in the default float type under x64."""
    if drop_prob <= 0.0:
        return f
    u = prng.uniform(keys, (f.shape[-1],), torch.float64)
    return torch.where(u < drop_prob, torch.inf, f)


def _split2(key: torch.Tensor):
    ks = prng.split(key)
    return ks[..., 0, :], ks[..., 1, :]


def _host_trace(tr) -> dict:
    return {f: v.cpu().numpy() for f, v in zip(tr._fields, tr)}


def _concat_traces(traces: List[dict]) -> dict:
    """The host traces of successive chunks as one dict of numpy arrays."""
    if not traces:
        return {}
    return {k: np.concatenate([t[k] for t in traces]) for k in traces[0]}


def _chunk_runner(step: Callable, interval: int):
    """Run a chunk of per-generation keys through ``step(carry, key,
    eigen)``: nested in eigen blocks when ``interval > 1`` divides the key
    count (``ladder.scan_eigen_blocks``), else one generation at a time
    with the lazy eigen mode (a ragged chunk)."""
    def run_chunk(carry, keys):
        T = int(keys.shape[0])
        if interval > 1 and T % interval == 0:
            return ladder.scan_eigen_blocks(step, carry, interval,
                                            T // interval, xs=keys)
        return ladder.scan(lambda c, k: step(c, k, "lazy"), carry, keys)
    return run_chunk


# ---------------------------------------------------------------------------
# K-Distributed
# ---------------------------------------------------------------------------

class KDistCarry(NamedTuple):
    states: cmaes.CMAState       # stacked (D, ...)
    restarts: torch.Tensor       # (D,) int32
    fevals: torch.Tensor         # (D,) int64 cumulative across restarts
    best_f: torch.Tensor         # () global best across descents, restarts
    best_x: torch.Tensor         # (n,)


class KDistTrace(NamedTuple):
    best_f: torch.Tensor         # () global best-so-far
    gen_best: torch.Tensor       # (D,) this generation's best per descent
    descent_best: torch.Tensor   # (D,) best within current incarnation
    fevals: torch.Tensor         # () total evaluations so far
    stopped: torch.Tensor        # (D,) which descents restarted this gen
    restarts: torch.Tensor       # (D,)


@dataclasses.dataclass
class KDistributed:
    """All population sizes K = 2⁰..2^kmax_exp run concurrently (paper
    §3.2.3).  ``device=None`` runs on the CUDA device and raises without
    one."""

    n: int
    n_devices: int
    lam_start: int = 12
    lam_slots: int = 12           # evaluations per device per generation
    kmax_exp: Optional[int] = None
    domain: Tuple[float, float] = (-5.0, 5.0)
    sigma0_frac: float = 0.25
    impl: str = "eager"
    drop_prob: float = 0.0
    restart_on_stop: bool = True  # paper §5 recommendation
    dtype: str = "float64"
    # "central": every descent's moments from the gathered population (the
    # paper's main process); "stacked": the per-descent gram family
    comm: str = "stacked"
    gram_dtype: str = ""          # e.g. "float32": the reduced gram family
                                  # rounded through this type
    eigen_interval: Optional[int] = None  # None: c-cmaes default
    device: Optional[str] = None

    def __post_init__(self):
        kops.validate_impl(self.impl)
        if self.comm not in COMM_CHOICES:
            raise ValueError(f"unknown comm {self.comm!r}; expected one of "
                             f"{COMM_CHOICES}")
        if self.kmax_exp is None:
            # largest ladder fitting the machine: Σ_{k≤K}2ᵏ ≤ P
            self.kmax_exp = max(0, int(math.floor(
                math.log2(self.n_devices + 1))) - 1)
        self.n_descents = self.kmax_exp + 1
        self.n_active = 2 ** (self.kmax_exp + 1) - 1
        if self.n_active > self.n_devices:
            raise ValueError(
                f"kmax_exp={self.kmax_exp} needs {self.n_active} devices, "
                f"have {self.n_devices}")
        if self.lam_slots != self.lam_start:
            raise ValueError("lam_slots must equal lam_start (one device per "
                             "2ᵏ slice of the population, paper §4.1)")
        self.device = resolve_device(self.device)
        width = self.domain[1] - self.domain[0]
        self.lam_max = (2 ** self.kmax_exp) * self.lam_start
        self.cfg = CMAConfig(n=self.n, lam=self.lam_max, lam_max=self.lam_max,
                             sigma0=self.sigma0_frac * width, dtype=self.dtype,
                             eigen_interval=self.eigen_interval)
        self.sparams = stack_params([
            make_params(self.cfg, lam=(2 ** k) * self.lam_start,
                        device=self.device)
            for k in range(self.n_descents)])
        d = eval_dispatch.flat_index(self.n_devices, self.device)
        self.groups = eval_dispatch.groups(heap_descent_of(d, self.n_active))
        # each device's descent, the inactive ones as D (no descent)
        self.kd_rows = torch.where(d < self.n_active, self.groups.index,
                                   self.n_descents)

    # -- carry ----------------------------------------------------------------
    def init_carry(self, key: torch.Tensor) -> KDistCarry:
        D, n, dt, dev = self.n_descents, self.n, self.cfg.tdtype, self.device
        lo, hi = self.domain
        x0 = prng.uniform(prng.split(key, D), (n,), dt, lo, hi)
        return KDistCarry(
            states=cmaes.init_state(self.cfg, x0),
            restarts=torch.zeros((D,), dtype=torch.int32, device=dev),
            fevals=torch.zeros((D,), dtype=torch.int64, device=dev),
            best_f=torch.tensor(torch.inf, dtype=dt, device=dev),
            best_x=torch.zeros((n,), dtype=dt, device=dev))

    # -- one generation, all devices -------------------------------------------
    def device_step(self, carry: KDistCarry, gen_key: torch.Tensor,
                    fitness_fn: Callable, eigen: str = "lazy"
                    ) -> Tuple[KDistCarry, KDistTrace]:
        D, n, dt = self.n_descents, self.n, self.cfg.tdtype
        lam, P, lam_max = self.lam_slots, self.n_devices, self.lam_max
        dev = self.device
        grp = self.groups
        d = eval_dispatch.flat_index(P, dev)
        kd = grp.index
        active = d < self.n_active

        key = prng.fold_in(prng.fold_in(gen_key, d), carry.restarts[kd])
        k_sample, k_drop = _split2(key)
        y, x = cmaes.sample_population(carry.states, k_sample, lam,
                                       impl=self.impl, groups=grp)
        f = fitness_fn(x.reshape(P * lam, n)).reshape(P, lam)
        f = _apply_drop(k_drop, f, self.drop_prob)
        f = torch.where(active[:, None], f, torch.inf)

        # ---- the gathered fitnesses (the paper's gather, §3.2.1) -------------
        f_flat = eval_dispatch.all_gather_flat(f).reshape(P * lam)
        desc_ids = torch.arange(D, device=dev)
        for_desc = (self.kd_rows.repeat_interleave(lam)[None, :]
                    == desc_ids[:, None])                          # (D, P·λ)
        f_desc = torch.where(for_desc, f_flat[None, :], torch.inf)
        ranks = eval_dispatch.local_ranks(f, f_desc[kd], d * lam)
        w = self.sparams.weights[kd[:, None], torch.clamp(ranks, 0,
                                                          lam_max - 1)]
        w = torch.where(torch.isfinite(f), w, 0.0)

        # ---- population moments ----------------------------------------------
        fused = kops.use_fused(self.impl)
        y_flat, w_flat = y.reshape(P * lam, n), w.reshape(P * lam)
        rows = [(a * lam, b * lam) for a, b in zip(grp.starts, grp.starts[1:])]
        gdt = getattr(torch, self.gram_dtype) if self.gram_dtype else dt
        if self.comm == "central":
            ranks_flat = torch.argsort(torch.argsort(f_desc, dim=1, stable=True),
                                       dim=1, stable=True)
            valid = for_desc & torch.isfinite(f_flat)[None, :]
            w_rows = torch.where(valid, self.sparams.weights.gather(
                1, torch.clamp(ranks_flat, 0, lam_max - 1)), 0.0)
            gram_st = torch.einsum("dp,pn,pm->dnm", w_rows, y_flat, y_flat)
            yw_st = torch.einsum("dp,pn->dn", w_rows, y_flat)
            wsum_st = w_rows.sum(1)
            nval_st = valid.sum(1).to(torch.int64)
        else:
            wsum_st = eval_dispatch.psum(w.sum(-1), grp)
            nval_st = eval_dispatch.psum(
                torch.isfinite(f).sum(-1).to(torch.int64), grp)
            if fused:
                rw = torch.sqrt(w_flat)[:, None]
                Ys = rw * y_flat
                fam_st = torch.stack([
                    Ys[a:b].transpose(0, 1) @ torch.cat([Ys[a:b], rw[a:b]], 1)
                    for a, b in rows]).to(gdt).to(dt)
                gram_st, yw_st = fam_st[:, :, :n], fam_st[:, :, n]
            else:
                yw_st = torch.stack([w_flat[a:b] @ y_flat[a:b]
                                     for a, b in rows])
                gram_st = torch.stack([
                    kops.rank_mu_gram(y_flat[a:b], w_flat[a:b],
                                      impl=self.impl)
                    for a, b in rows]).to(gdt).to(dt)

        # straggler mitigation: renormalize surviving weights
        scale = torch.where(wsum_st > 1e-12,
                            1.0 / torch.clamp(wsum_st, min=1e-12), 0.0)
        yw_st = yw_st * scale[:, None]
        gram_st = gram_st * scale[:, None, None]

        # ---- per-descent order statistics -----------------------------------
        f_sorted = torch.sort(f_desc, dim=1).values[:, :lam_max]
        i_loc = torch.argmin(f, dim=1)
        xb_all = x[d, i_loc]                                       # (P, n)
        fb_rows = f.amin(dim=1)
        row_masked = torch.where(self.kd_rows[None, :] == desc_ids[:, None],
                                 fb_rows[None, :], torch.inf)
        x_best = xb_all[torch.argmin(row_masked, dim=1)]           # (D, n)

        nval32 = nval_st.to(torch.int32)
        if fused:
            upd = cmaes.masked_update_from_gram(
                self.cfg, self.sparams, carry.states, gram_st, yw_st,
                f_sorted, x_best, nval32, eigen=eigen)
        else:
            mom = cmaes.Moments(y_w=yw_st, gram=gram_st, f_sorted=f_sorted,
                                x_best=x_best, n_evals=nval32)
            upd = cmaes.masked_update(self.cfg, self.sparams, carry.states,
                                      mom, impl=self.impl, eigen=eigen)

        # ---- global best (before any restart wipes descent state) -----------
        gen_best = f_sorted[:, 0]
        gb = torch.argmin(gen_best)
        better = gen_best[gb] < carry.best_f
        best_f = torch.where(better, gen_best[gb], carry.best_f)
        best_x = torch.where(better, x_best[gb], carry.best_x)

        # ---- in-place restart of stopped descents (same K, fresh mean/σ) ----
        stopped = upd.stop
        if self.restart_on_stop:
            lo, hi = self.domain
            rkeys = prng.fold_in(prng.fold_in(gen_key, 1_000_003 + desc_ids),
                                 carry.restarts)
            fresh = cmaes.init_state(self.cfg, prng.uniform(rkeys, (n,), dt,
                                                            lo, hi))
            new_states = cmaes.tree_select(stopped, fresh, upd)
            restarts = carry.restarts + stopped.to(torch.int32)
        else:
            new_states = upd
            restarts = carry.restarts

        fevals = carry.fevals + nval_st
        new_carry = KDistCarry(states=new_states, restarts=restarts,
                               fevals=fevals, best_f=best_f, best_x=best_x)
        trace = KDistTrace(best_f=best_f, gen_best=gen_best,
                           descent_best=upd.best_f, fevals=fevals.sum(),
                           stopped=stopped, restarts=restarts)
        return new_carry, trace

    # -- chunked generations ---------------------------------------------------
    def chunk_fn(self, fitness_fn: Callable):
        """``run_chunk(carry, keys) -> (carry, trace)`` over a chunk of
        per-generation keys, nested in eigen blocks when
        ``cfg.eigen_interval > 1`` divides the key count, else generation
        by generation with the lazy eigen mode."""
        return _chunk_runner(
            lambda c, k, eigen: self.device_step(c, k, fitness_fn,
                                                 eigen=eigen),
            int(self.cfg.eigen_interval))

    def run_sim(self, key, fitness_fn: Callable, total_gens: int,
                chunk: int = 16):
        """All generations in chunks of ``chunk`` keys (the chunk length
        changes the keys, as in the JAX package).  ``key`` is an int seed or
        a (2,) key.  Returns the final carry and the trace as numpy."""
        key = prng.as_key(key, self.device)
        carry = self.init_carry(prng.fold_in(key, 0))
        fn = self.chunk_fn(fitness_fn)
        traces = []
        for c0 in range(0, total_gens, chunk):
            key, kc = _split2(key)
            keys = prng.split(kc, min(chunk, total_gens - c0))
            carry, tr = fn(carry, keys)
            traces.append(_host_trace(tr))
        return carry, _concat_traces(traces)


# ---------------------------------------------------------------------------
# K-Replicated
# ---------------------------------------------------------------------------

class KRepCarry(NamedTuple):
    state: cmaes.CMAState        # (G, ...) one descent per group
    best_f: torch.Tensor         # () global best
    best_x: torch.Tensor         # (n,)
    fevals: torch.Tensor         # () int64 total evaluations


class KRepTrace(NamedTuple):
    best_f: torch.Tensor         # ()
    group_best: torch.Tensor     # (G,) per-group best-so-far
    n_stopped: torch.Tensor      # () int32
    fevals: torch.Tensor         # ()


@dataclasses.dataclass
class KReplicated:
    """Successive phases of replicated same-K descents (paper §3.2.2).
    ``device=None`` runs on the CUDA device and raises without one."""

    n: int
    n_devices: int
    lam_start: int = 12
    lam_slots: int = 12
    domain: Tuple[float, float] = (-5.0, 5.0)
    sigma0_frac: float = 0.25
    impl: str = "eager"
    drop_prob: float = 0.0
    dtype: str = "float64"
    eigen_interval: Optional[int] = None  # None: c-cmaes default
    device: Optional[str] = None

    def __post_init__(self):
        kops.validate_impl(self.impl)
        if self.lam_slots != self.lam_start:
            raise ValueError("lam_slots must equal lam_start")
        if self.n_devices & (self.n_devices - 1):
            raise ValueError("K-Replicated needs a power-of-two device count")
        self.device = resolve_device(self.device)
        self.kmax_exp = int(math.log2(self.n_devices))
        width = self.domain[1] - self.domain[0]
        self.sigma0 = self.sigma0_frac * width

    def phase_cfg(self, k_exp: int) -> tuple[CMAConfig, CMAParams, int, int]:
        g = 2 ** k_exp                       # devices per descent
        G = self.n_devices // g              # concurrent descents
        lam = g * self.lam_start
        cfg = CMAConfig(n=self.n, lam=lam, lam_max=lam, sigma0=self.sigma0,
                        dtype=self.dtype, eigen_interval=self.eigen_interval)
        return cfg, make_params(cfg, device=self.device), G, g

    def init_phase_states(self, cfg: CMAConfig, G: int,
                          key: torch.Tensor) -> cmaes.CMAState:
        lo, hi = self.domain
        x0 = prng.uniform(prng.split(key, G), (self.n,), cfg.tdtype, lo, hi)
        return cmaes.init_state(cfg, x0)

    def device_step(self, cfg: CMAConfig, params: CMAParams,
                    carry: KRepCarry, gen_key: torch.Tensor,
                    fitness_fn: Callable, eigen: str = "lazy"
                    ) -> Tuple[KRepCarry, KRepTrace]:
        """One generation of every device; device (grp, mem) is flat
        index grp·g + mem, group grp samples with state[grp]."""
        n, lam, P = self.n, self.lam_slots, self.n_devices
        dev = self.device
        state = carry.state
        G = state.m.shape[0]
        g = P // G
        grp = eval_dispatch.Groups(
            tuple(range(0, P + 1, g)),
            torch.arange(G, device=dev).repeat_interleave(g))
        d = eval_dispatch.flat_index(P, dev)

        k_sample, k_drop = _split2(prng.fold_in(gen_key, d))
        y, x = cmaes.sample_population(state, k_sample, lam, impl=self.impl,
                                       groups=grp)
        f = fitness_fn(x.reshape(P * lam, n)).reshape(P, lam)
        f = _apply_drop(k_drop, f, self.drop_prob)

        f_mem = f.reshape(G, g, lam)
        f_flat = f_mem.reshape(G, g * lam)          # gathered over 'mem'
        mem = torch.arange(g, device=dev)
        ranks = eval_dispatch.local_ranks(f_mem, f_flat[:, None, :],
                                          mem * lam)
        w = params.weights[torch.clamp(ranks, 0, params.weights.shape[0] - 1)]
        w = torch.where(torch.isfinite(f_mem), w, 0.0)

        y_g, w_g = y.reshape(G, g * lam, n), w.reshape(G, g * lam)
        if kops.use_fused(self.impl):
            rw = torch.sqrt(w_g)[..., None]
            Ys = rw * y_g
            fam = Ys.transpose(-1, -2) @ torch.cat([Ys, rw], -1)
            gram, yw = fam[..., :n], fam[..., n]
        else:
            yw = (w_g[:, None, :] @ y_g)[:, 0]
            gram = kops.rank_mu_gram(y_g, w_g, impl=self.impl)
        wsum = eval_dispatch.psum(w.reshape(P, lam).sum(-1), grp)
        nval = eval_dispatch.psum(
            torch.isfinite(f).sum(-1).to(torch.int64), grp)
        scale = torch.where(wsum > 1e-12, 1.0 / torch.clamp(wsum, min=1e-12),
                            0.0)
        yw, gram = yw * scale[:, None], gram * scale[:, None, None]

        f_sorted = torch.sort(f_flat, dim=-1).values    # lam == lam_max
        xb = x[d, torch.argmin(f, dim=1)].reshape(G, g, n)
        x_best = xb[torch.arange(G, device=dev),
                    torch.argmin(f_mem.amin(-1), dim=1)]

        params_g = broadcast_params(params, G)
        nval32 = nval.to(torch.int32)
        if kops.use_fused(self.impl):
            new_state = cmaes.masked_update_from_gram(
                cfg, params_g, state, gram, yw, f_sorted, x_best, nval32,
                eigen=eigen)
        else:
            mom = cmaes.Moments(y_w=yw, gram=gram, f_sorted=f_sorted,
                                x_best=x_best, n_evals=nval32)
            new_state = cmaes.masked_update(cfg, params_g, state, mom,
                                            impl=self.impl, eigen=eigen)

        # global best across groups
        gen_best = f_sorted[:, 0]
        i_star = torch.argmin(gen_best)
        better = gen_best[i_star] < carry.best_f
        best_f = torch.where(better, gen_best[i_star], carry.best_f)
        best_x = torch.where(better, x_best[i_star], carry.best_x)

        # stopped descents idle until the phase barrier (paper Fig. 3) and
        # stop consuming budget
        n_stopped = new_state.stop.sum().to(torch.int32)
        fevals = carry.fevals + torch.where(state.stop, 0, nval).sum()
        new_carry = KRepCarry(state=new_state, best_f=best_f, best_x=best_x,
                              fevals=fevals)
        trace = KRepTrace(best_f=best_f, group_best=new_state.best_f,
                          n_stopped=n_stopped, fevals=fevals)
        return new_carry, trace

    def phase_chunk_fn(self, cfg: CMAConfig, params: CMAParams,
                       fitness_fn: Callable):
        """A phase's chunk runner, nested in eigen blocks as
        ``KDistributed.chunk_fn``."""
        return _chunk_runner(
            lambda c, k, eigen: self.device_step(cfg, params, c, k,
                                                 fitness_fn, eigen=eigen),
            int(cfg.eigen_interval))

    def run_sim(self, key, fitness_fn: Callable, phase_gens: int,
                chunk: int = 16, max_evals: Optional[int] = None,
                phases: Optional[List[int]] = None) -> dict:
        """All phases in turn, each in chunks of ``chunk`` keys, until every
        group stopped or ``max_evals`` is spent (read on the host after
        each chunk).  Returns best_f, best_x, fevals and the per-phase
        traces (numpy, with k_exp, lam and n_groups)."""
        key = prng.as_key(key, self.device)
        best_f, best_x = np.inf, np.zeros(self.n)
        fevals = 0
        all_traces: List[dict] = []
        phase_list = (phases if phases is not None
                      else list(range(self.kmax_exp + 1)))
        for k_exp in phase_list:
            cfg, params, G, g = self.phase_cfg(k_exp)
            key, k_init = _split2(key)
            dt, dev = cfg.tdtype, self.device
            carry = KRepCarry(
                state=self.init_phase_states(cfg, G, k_init),
                best_f=torch.tensor(best_f, dtype=dt, device=dev),
                best_x=torch.as_tensor(best_x, dtype=dt, device=dev),
                fevals=torch.tensor(fevals, dtype=torch.int64, device=dev))
            fn = self.phase_chunk_fn(cfg, params, fitness_fn)
            traces = []
            gens_done = 0
            while gens_done < phase_gens:
                key, kc = _split2(key)
                n_keys = min(chunk, phase_gens - gens_done)
                carry, tr = fn(carry, prng.split(kc, n_keys))
                tr = _host_trace(tr)
                traces.append(tr)
                gens_done += n_keys
                if int(tr["n_stopped"][-1]) >= G:
                    break
                if max_evals is not None and int(tr["fevals"][-1]) >= max_evals:
                    break
            trace = _concat_traces(traces)
            trace["k_exp"] = k_exp
            trace["lam"] = cfg.lam
            trace["n_groups"] = G
            all_traces.append(trace)
            best_f = float(carry.best_f)
            best_x = carry.best_x.cpu().numpy()
            fevals = int(carry.fevals)
            if max_evals is not None and fevals >= max_evals:
                break
        return dict(best_f=best_f, best_x=best_x, fevals=fevals,
                    phases=all_traces)
