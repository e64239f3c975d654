"""Bayesian strategy search and the persistent strategy cache — the port's
own copy of ``dlrover_tpu/parallel/strategy_search.py``, line for line
where the code is numpy: ``REMAT_CHOICES``/``ACCUM_CHOICES``,
``strategy_to_dict`` ``:43`` / ``strategy_from_dict`` ``:61``,
``default_space`` ``:83``, ``estimate_step_hbm_bytes`` ``:137`` with
``_CALIBRATION``, ``prune_space_by_memory`` ``:241``, ``_features``
``:270``, ``_GP`` ``:298``, ``_expected_improvement`` ``:333``,
``SearchResult``, ``BayesStrategySearch`` ``:351``, ``fingerprint``
``:482``, ``StrategyCache`` ``:506`` and ``MasterStrategyCache`` ``:544``.

The search space is the discrete grid of (mesh factorization x remat
policy x grad-accum x optimizer offload) :class:`~.accelerate.Strategy`
points; the objective (``accelerate.search``) builds a candidate and
scores it; a small numpy Gaussian process with expected improvement picks
which points to pay for.  Points the port refuses (the ``offload`` remat
and ``offload_opt``, Queue A item 5c) raise in the objective and are
scored ``inf``, as the reference scores a candidate that fails to
compile; nothing is dropped from the space.

The cache's entries are ``strategy_to_dict``'s JSON with the reference's
keys, so each package reads an entry the other wrote.  The port's
``Strategy`` has no ``compute_dtype`` or ``donate`` (the model's config
sets the compute type; the port's step always updates in place): the
reference's defaults (``"bfloat16"``, ``true``) are written, and an entry
with another value is refused on read, which a cache treats as a miss.
:func:`fingerprint` hashes the parameters', optimizer state's and batch's
shapes and types and the device count; the parameter and batch parts are
the reference's strings (numpy type names), while the optimizer part is
the port's optimizer class (its state is not optax's tree), so a key
matches the reference's only where no optimizer state is given.

``estimate_step_hbm_bytes`` keeps the reference's ``_CALIBRATION = 0.75``,
a constant fitted on XLA buffer assignments on TPU (``CALIBRATE_HBM.json``),
not a measurement of this port.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import threading
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec, \
    candidate_specs

# Strategy is imported inside the functions: accelerate.py imports this
# module for search().

REMAT_CHOICES = ("none", "dots", "full", "block", "offload")
ACCUM_CHOICES = (1, 2, 4, 8)
#: The reference's defaults for the fields the port's Strategy lacks.
COMPUTE_DTYPE = "bfloat16"
DONATE = True


# -- strategy (de)serialization: the persistence format ----------------------

def _mesh_spec(mesh) -> MeshSpec:
    """A Strategy's mesh as a MeshSpec (a dict's absent axes are 1)."""
    if isinstance(mesh, MeshSpec):
        return mesh
    return MeshSpec(**{a: int(mesh.get(a, 1)) for a in AXIS_ORDER})


def strategy_to_dict(strategy) -> dict:
    m = _mesh_spec(strategy.mesh)
    return {
        "mesh": {a: getattr(m, a) for a in ("pp", "dp", "fsdp", "ep", "tp")},
        "remat": strategy.remat,
        "compute_dtype": COMPUTE_DTYPE,
        "grad_accum": strategy.grad_accum,
        "donate": DONATE,
        "offload_opt": strategy.offload_opt,
        "fp8": strategy.fp8,
        "quant_grads": strategy.quant_grads,
    }


def strategy_from_dict(d: dict):
    from dlrover_tpu_torch.parallel.accelerate import Strategy

    dtype = d.get("compute_dtype", COMPUTE_DTYPE)
    if dtype != COMPUTE_DTYPE:
        raise ValueError(f"compute_dtype {dtype!r}: the port's compute type "
                         f"is the model config's ({COMPUTE_DTYPE} entries "
                         f"only)")
    if not bool(d.get("donate", True)):
        raise ValueError("donate=False: the port's step always updates the "
                         "state in place")
    return Strategy(
        mesh=MeshSpec(**d["mesh"]),
        remat=d["remat"],
        grad_accum=int(d["grad_accum"]),
        offload_opt=bool(d.get("offload_opt", False)),
        fp8=bool(d.get("fp8", False)),
        quant_grads=bool(d.get("quant_grads", False)),
    )


# -- search space -------------------------------------------------------------

def default_space(
    n_devices: int,
    *,
    remat: Sequence[str] = REMAT_CHOICES,
    accum: Sequence[int] = ACCUM_CHOICES,
    allow_ep: bool = False,
    allow_pp: bool = True,
    offload_opt: Sequence[bool] = (False, True),
    fp8: Sequence[bool] = (False,),
    quant_grads: Sequence[bool] = (False,),
    base=None,
) -> List[Any]:
    """The discrete Strategy grid for ``n_devices``, in the reference's
    order.  ``quant_grads=True`` points are kept only where the reference's
    ``quant_grads_incompat`` admits them (a pure-``dp`` mesh with ``dp >
    1``, no fp8); the port refuses them all (item 5c) in the objective."""
    from dlrover_tpu_torch.parallel.accelerate import Strategy

    base = base or Strategy()
    out = []
    for spec in candidate_specs(
        n_devices, allow_ep=allow_ep, allow_pp=allow_pp
    ):
        for r in remat:
            for a in accum:
                for oo in offload_opt:
                    for f8 in fp8:
                        if f8 and spec.pp > 1:
                            continue
                        for qg in quant_grads:
                            cand = dataclasses.replace(
                                base, mesh=spec, remat=r,
                                grad_accum=a, offload_opt=oo,
                                fp8=f8, quant_grads=qg,
                            )
                            if qg and _quant_grads_incompat(cand):
                                continue
                            out.append(cand)
    return out


def _quant_grads_incompat(s) -> Optional[str]:
    """The reference's ``quant_grads_incompat`` (``accelerate.py:147``)."""
    if not s.quant_grads:
        return None
    if s.fp8:
        return "quant_grads is incompatible with fp8"
    m = s.mesh
    if any(getattr(m, a) > 1 for a in ("pp", "fsdp", "ep", "tp")):
        return f"quant_grads needs a pure-dp mesh (got {m.describe()})"
    if m.dp <= 1:
        return f"quant_grads needs mesh.dp > 1 (got {m.describe()})"
    return None


def _leaves(tree) -> list:
    from dlrover_tpu_torch.parallel.accelerate import tree_leaves

    return tree_leaves(tree)


@functools.lru_cache(maxsize=None)
def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return int(np.dtype(dtype).itemsize)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)


def estimate_step_hbm_bytes(
    params_shape: Any,
    sample_batch: Any,
    strategy,
    *,
    opt_state_multiplier: float = 2.0,
    d_model_hint: Optional[int] = None,
) -> float:
    """The reference's coarse per-device memory model, for pruning before
    any build: fp32 masters over ``fsdp * pp``, ``opt_state_multiplier`` x
    that for the optimizer state (0 with ``offload_opt``), one more for the
    gradients, and ``tokens / (dp * fsdp) / grad_accum x d_model x 2 x``
    the remat policy's factor for the activations, all times
    ``_CALIBRATION`` (fitted on TPU, see the module docstring)."""
    sizes = [
        int(np.prod(x.shape)) * _dtype_bytes(x)
        for x in _leaves(params_shape)
        if hasattr(x, "shape")
    ]
    p_bytes = float(sum(sizes))
    m = _mesh_spec(strategy.mesh)
    model_shards = max(1, m.fsdp) * max(1, m.pp)
    params_dev = 4.0 / _avg_dtype_bytes(params_shape) * p_bytes \
        / model_shards  # master f32 copy
    opt_dev = 0.0 if strategy.offload_opt else (
        opt_state_multiplier * params_dev
    )
    grads_dev = params_dev

    batch_leaves = [
        x for x in _leaves(sample_batch)
        if hasattr(x, "shape") and np.ndim(x) >= 2
    ]
    tokens = max(
        (int(np.prod(np.shape(x))) for x in batch_leaves), default=0
    )
    data_shards = max(1, m.dp) * max(1, m.fsdp)
    d_model = d_model_hint or _guess_d_model(params_shape)
    act_factor = {
        "none": 24.0, "dots": 8.0, "block": 2.0, "offload": 1.0,
        "full": 1.0,
    }.get(strategy.remat, 8.0)
    acts_dev = (
        tokens / data_shards / max(1, strategy.grad_accum)
        * d_model * 2.0 * act_factor  # bf16 activations
    )
    return _CALIBRATION * (params_dev + opt_dev + grads_dev + acts_dev)


# The reference's fit against XLA's buffer assignment on TPU (14 strategy
# points, llama_300m/800m; CALIBRATE_HBM.json).  Kept for parity, not
# refitted: it is not a measurement of this port.
_CALIBRATION = 0.75


def _dtype_bytes(x) -> int:
    try:
        return _itemsize(x.dtype)
    except Exception:  # noqa: BLE001 - a leaf without a dtype: fp32
        return 4


def _avg_dtype_bytes(params_shape) -> float:
    bs = [
        _dtype_bytes(x)
        for x in _leaves(params_shape)
        if hasattr(x, "dtype")
    ]
    return float(np.mean(bs)) if bs else 4.0


def _guess_d_model(params_shape) -> int:
    """Most common trailing dim among 2-D params."""
    dims = Counter()
    for x in _leaves(params_shape):
        shape = getattr(x, "shape", ())
        if len(shape) == 2:
            dims[int(min(shape))] += 1
    return dims.most_common(1)[0][0] if dims else 1024


def prune_space_by_memory(
    space: Sequence[Any],
    params_shape: Any,
    sample_batch: Any,
    hbm_bytes: float,
    **kw,
) -> List[Any]:
    """Drop strategies whose estimate exceeds the budget (keep everything
    if that would empty the space)."""
    kept = [
        s for s in space
        if estimate_step_hbm_bytes(params_shape, sample_batch, s, **kw)
        <= hbm_bytes
    ]
    if not kept:
        logger.warning(
            "memory pruning would empty the space (budget %.1f GB); "
            "keeping all %d candidates", hbm_bytes / 1e9, len(space)
        )
        return list(space)
    if len(kept) < len(space):
        logger.info(
            "memory pruning: %d -> %d candidates under %.1f GB",
            len(space), len(kept), hbm_bytes / 1e9,
        )
    return kept


def _features(strategy) -> np.ndarray:
    """log2 of the mesh factorization, the remat level, log2 accum and the
    flags, for the GP kernel."""
    m = _mesh_spec(strategy.mesh)
    return np.array(
        [
            np.log2(max(1, m.dp)),
            np.log2(max(1, m.fsdp)),
            np.log2(max(1, m.tp)),
            np.log2(max(1, m.ep)),
            np.log2(max(1, m.pp)),
            float(REMAT_CHOICES.index(strategy.remat))
            if strategy.remat in REMAT_CHOICES
            else 1.0,
            np.log2(max(1, strategy.grad_accum)),
            float(strategy.offload_opt),
            float(strategy.fp8),
            float(strategy.quant_grads),
        ],
        dtype=np.float64,
    )


# -- exact GP + expected improvement (minimization) --------------------------

class _GP:
    """Exact GP with an RBF kernel on standardized features."""

    def __init__(self, lengthscale: float = 1.0, noise: float = 1e-4):
        self.ls = lengthscale
        self.noise = noise
        self._X: Optional[np.ndarray] = None

    def _k(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.ls**2))

    def fit(self, X: np.ndarray, y: np.ndarray) -> None:
        self._X = X
        self._ymean = float(y.mean())
        self._ystd = float(y.std()) or 1.0
        yn = (y - self._ymean) / self._ystd
        K = self._k(X, X) + self.noise * np.eye(len(X))
        self._L = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, yn)
        )

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        Ks = self._k(Xs, self._X)
        mu = Ks @ self._alpha
        v = np.linalg.solve(self._L, Ks.T)
        var = np.clip(1.0 - (v**2).sum(0), 1e-12, None)
        return (
            mu * self._ystd + self._ymean,
            np.sqrt(var) * self._ystd,
        )


def _expected_improvement(
    mu: np.ndarray, sigma: np.ndarray, best: float
) -> np.ndarray:
    from scipy.special import ndtr  # Phi

    z = (best - mu) / sigma
    phi = np.exp(-0.5 * z**2) / np.sqrt(2 * np.pi)
    return (best - mu) * ndtr(z) + sigma * phi


@dataclasses.dataclass
class SearchResult:
    best: Any                      # Strategy
    best_cost: float
    evaluated: List[Tuple[Any, float]]  # (Strategy, cost) in eval order
    from_cache: bool = False


class BayesStrategySearch:
    """BO over the discrete strategy grid.  ``objective(strategy) -> cost``
    (lower is better; raise or return ``inf`` for an infeasible point).
    ``warm_start`` strategies are evaluated first."""

    def __init__(
        self,
        objective: Callable[[Any], float],
        space: Sequence[Any],
        *,
        n_init: int = 3,
        max_evals: int = 10,
        warm_start: Sequence[Any] = (),
        seed: int = 0,
    ):
        self.objective = objective
        self.space = list(space)
        self.n_init = n_init
        self.max_evals = max_evals
        self.warm_start = list(warm_start)
        self.rng = np.random.default_rng(seed)

    def run(self) -> SearchResult:
        feats = np.stack([_features(s) for s in self.space])
        fmean = feats.mean(0)
        fstd = feats.std(0)
        fstd[fstd == 0] = 1.0
        feats_n = (feats - fmean) / fstd

        evaluated: List[Tuple[Any, float]] = []
        seen: set = set()

        def key_of(s):
            return json.dumps(strategy_to_dict(s), sort_keys=True)

        def evaluate(idx: int) -> None:
            s = self.space[idx]
            k = key_of(s)
            if k in seen:
                return
            seen.add(k)
            try:
                cost = float(self.objective(s))
            except Exception as e:  # noqa: BLE001 - infeasible point
                logger.info(
                    "strategy search: %s infeasible: %s", s.describe(), e
                )
                cost = float("inf")
            evaluated.append((s, cost))
            logger.info(
                "strategy search: %s -> %.4g s/step", s.describe(), cost
            )

        # 1. Warm starts.
        for s in self.warm_start:
            k = key_of(s)
            for i, cand in enumerate(self.space):
                if key_of(cand) == k:
                    evaluate(i)
                    break
            else:
                if k not in seen:
                    seen.add(k)
                    try:
                        cost = float(self.objective(s))
                    except Exception:  # noqa: BLE001
                        cost = float("inf")
                    evaluated.append((s, cost))

        # 2. Random init to seed the surrogate.
        order = self.rng.permutation(len(self.space))
        for i in order:
            if sum(1 for _ in evaluated) >= self.n_init + len(
                self.warm_start
            ):
                break
            evaluate(int(i))

        # 3. BO loop: fit the GP on finite observations, maximize EI.
        while len(evaluated) < self.max_evals and len(seen) < len(
            self.space
        ):
            obs = [
                (s, c) for s, c in evaluated if np.isfinite(c)
            ]
            remaining = [
                i for i, s in enumerate(self.space)
                if key_of(s) not in seen
            ]
            if not remaining:
                break
            if len(obs) < 2:
                evaluate(int(self.rng.choice(remaining)))
                continue
            X = np.stack(
                [(_features(s) - fmean) / fstd for s, _ in obs]
            )
            y = np.array([c for _, c in obs])
            gp = _GP()
            try:
                gp.fit(X, y)
            except np.linalg.LinAlgError:
                evaluate(int(self.rng.choice(remaining)))
                continue
            mu, sigma = gp.predict(feats_n[remaining])
            ei = _expected_improvement(mu, sigma, float(y.min()))
            evaluate(remaining[int(np.argmax(ei))])

        finite = [(s, c) for s, c in evaluated if np.isfinite(c)]
        if not finite:
            raise RuntimeError("strategy search: every candidate failed")
        best, best_cost = min(finite, key=lambda sc: sc[1])
        logger.info(
            "strategy search: best %s (%.4g s/step) after %d evals",
            best.describe(), best_cost, len(evaluated),
        )
        return SearchResult(
            best=best, best_cost=best_cost, evaluated=evaluated
        )


# -- persistent strategy cache ------------------------------------------------

def fingerprint(
    params_shape: Any, batch: Any, n_devices: int, opt_shape: Any = None
) -> str:
    """Stable key for (model, optimizer, batch, topology): the flattened
    parameter / optimizer-state / batch shapes and types and the device
    count.  A leaf is anything with ``shape`` and ``dtype`` (a tensor, a
    fake tensor, an array) or a string (the port's optimizer part)."""

    def leaf_sig(leaf) -> str:
        if isinstance(leaf, str):
            return leaf
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            return f"{tuple(leaf.shape)}:{_dtype_name(leaf.dtype)}"
        return f"{tuple(np.shape(leaf))}:{np.asarray(leaf).dtype}"

    parts: List[str] = [f"ndev={n_devices}"]
    parts += [leaf_sig(x) for x in _leaves(params_shape)]
    parts.append("|opt|")
    if opt_shape is not None:
        parts += [leaf_sig(x) for x in _leaves(opt_shape)]
    parts.append("|batch|")
    parts += [leaf_sig(x) for x in _leaves(batch)]
    return hashlib.sha1("/".join(parts).encode()).hexdigest()[:16]


class StrategyCache:
    """JSON-file cache: fingerprint -> winning strategy dict."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def _load(self) -> Dict[str, dict]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def get(self, key: str):
        with self._lock:
            d = self._load().get(key)
        if d is None:
            return None
        try:
            return strategy_from_dict(d)
        except Exception:  # noqa: BLE001 - stale/corrupt entry
            return None

    def put(self, key: str, strategy) -> None:
        with self._lock:
            data = self._load()
            data[key] = strategy_to_dict(strategy)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            os.makedirs(
                os.path.dirname(os.path.abspath(self.path)), exist_ok=True
            )
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)


class MasterStrategyCache:
    """Strategy cache in the job master's KV store (the port's
    ``MasterClient.kv_store_get/set``): a worker relaunched on a fresh host
    still skips the search."""

    PREFIX = "strategy-cache/"

    def __init__(self, master_client):
        self.client = master_client

    def get(self, key: str):
        try:
            raw = self.client.kv_store_get(self.PREFIX + key)
        except Exception:  # noqa: BLE001 - master unreachable
            return None
        if not raw:
            return None
        try:
            return strategy_from_dict(json.loads(raw.decode()))
        except Exception:  # noqa: BLE001 - stale/corrupt entry
            return None

    def put(self, key: str, strategy) -> None:
        try:
            self.client.kv_store_set(
                self.PREFIX + key,
                json.dumps(strategy_to_dict(strategy)).encode(),
            )
        except Exception:  # noqa: BLE001 - a cache write is best-effort
            logger.warning("strategy cache: could not write %s to the "
                           "master", key)
