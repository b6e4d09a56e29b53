"""A copy of ``boxmot_tpu/engine/tuning/backends.py``: the tuner's search
strategies, small numpy samplers over the YAML search-space vocabulary
(uniform, loguniform, qrandint, randint, choice, grid_search).

- ``random``: i.i.d. draws from the spec priors.
- ``grid``: exhaustive cartesian sweep; continuous ranges discretized.
- ``tpe``: Tree-structured Parzen Estimator (the algorithm behind the
  reference's optuna backend).

They draw from ``np.random.Generator`` exactly as the JAX package's do, so
the same specs, seed and history give the same suggestions, bit for bit.
"""

from __future__ import annotations

import itertools
import json

import numpy as np


def _spec_kind(spec: dict) -> str:
    return spec.get("type", "choice")


def _spec_options(spec: dict):
    return spec.get("options", spec.get("values"))


def sample_param(spec: dict, rng: np.random.Generator):
    kind = _spec_kind(spec)
    if kind == "uniform":
        lo, hi = spec["range"]
        return float(rng.uniform(lo, hi))
    if kind == "loguniform":
        lo, hi = spec["range"]
        return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    if kind == "qrandint":
        lo, hi, q = spec["range"]
        return int(rng.choice(np.arange(lo, hi, q)))
    if kind == "randint":
        lo, hi = spec["range"]
        return int(rng.integers(lo, hi))  # upper-exclusive (Ray convention)
    if kind in ("choice", "grid_search"):
        options = _spec_options(spec)
        picked = options[int(rng.integers(len(options)))]
        return picked.item() if hasattr(picked, "item") else picked
    raise ValueError(f"unknown search space type {kind!r}")


class RandomBackend:
    """Independent draws from the spec priors."""

    name = "random"

    def __init__(self, specs: dict, seed: int = 0):
        self.specs = specs
        self.rng = np.random.default_rng(seed)

    def suggest(self, history: list[dict]) -> dict:
        return {k: sample_param(v, self.rng) for k, v in self.specs.items()}


class GridBackend:
    """Exhaustive sweep; continuous params are discretized to ``n_points``.

    Suggestions cycle through the cartesian product in order, skipping
    configurations already present in the history (resume-safe).
    """

    name = "grid"

    def __init__(self, specs: dict, seed: int = 0, n_points: int = 4):
        self.specs = specs
        axes = []
        for key, spec in specs.items():
            kind = _spec_kind(spec)
            if kind in ("choice", "grid_search"):
                vals = list(_spec_options(spec))
            elif kind in ("qrandint", "randint"):
                lo, hi, q = (*spec["range"], 1)[:3]
                vals = [int(v) for v in np.arange(lo, hi, q)]
                if len(vals) > 2 * n_points:  # keep integer axes bounded
                    vals = [int(v) for v in
                            np.unique(np.linspace(lo, hi - 1, n_points).round())]
            elif kind == "uniform":
                lo, hi = spec["range"]
                vals = [float(v) for v in np.linspace(lo, hi, n_points)]
            elif kind == "loguniform":
                lo, hi = spec["range"]
                vals = [float(v) for v in np.geomspace(lo, hi, n_points)]
            else:
                raise ValueError(f"unknown search space type {kind!r}")
            axes.append([(key, v) for v in vals])
        self._grid = [dict(combo) for combo in itertools.product(*axes)]

    def __len__(self) -> int:
        return len(self._grid)

    def suggest(self, history: list[dict]) -> dict | None:
        seen = {json.dumps(t["params"], sort_keys=True) for t in history}
        for params in self._grid:
            if json.dumps(params, sort_keys=True) not in seen:
                return params
        return None  # exhausted


class TPEBackend:
    """Tree-structured Parzen Estimator over the YAML space.

    Bergstra et al. 2011 ("Algorithms for Hyper-Parameter Optimization"):
    maximizing EI is equivalent to maximizing l(x)/g(x) where l models
    params of the top-gamma trials and g the rest.  Numeric params use
    Gaussian KDE with Scott bandwidth (log-space for loguniform);
    categorical params use smoothed category frequencies.
    """

    name = "tpe"

    def __init__(
        self,
        specs: dict,
        seed: int = 0,
        gamma: float = 0.25,
        n_candidates: int = 24,
        n_startup: int = 8,
        epsilon: float = 0.2,
    ):
        self.specs = specs
        self.rng = np.random.default_rng(seed)
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.n_startup = n_startup
        # Fraction of suggestions drawn purely from the prior.  The KDE
        # ratio can self-collapse onto an early local optimum (every new
        # trial lands in the cluster, reinforcing it); epsilon-random
        # interleaving bounds the worst case at random-search quality.
        self.epsilon = epsilon

    # -- per-kind density helpers ------------------------------------
    def _numeric_values(self, key: str, trials: list[dict], log: bool) -> np.ndarray:
        vals = np.asarray([t["params"][key] for t in trials], dtype=np.float64)
        return np.log(vals) if log else vals

    @staticmethod
    def _bandwidths(obs: np.ndarray, lo: float, hi: float) -> np.ndarray:
        """Per-component adaptive bandwidth, hyperopt-style: each kernel
        is as wide as the larger gap to its neighbors, so an isolated
        promising observation spreads candidates widely while a dense
        cluster stays sharp."""
        span = max(hi - lo, 1e-12)
        order = np.argsort(obs)
        srt = obs[order]
        ext = np.concatenate([[lo], srt, [hi]])
        left = srt - ext[:-2]
        right = ext[2:] - srt
        bw_sorted = np.maximum(left, right)
        bw = np.empty_like(bw_sorted)
        bw[order] = bw_sorted
        return np.clip(bw, span * 0.03, span)

    def _kde_sample(self, obs: np.ndarray, lo: float, hi: float, n: int) -> np.ndarray:
        """Draw from the observation mixture, with a uniform prior
        component (weight ~1/(n_obs+1)) so the search never collapses."""
        bw = self._bandwidths(obs, lo, hi)
        n_prior = max(1, int(round(n / (len(obs) + 1))))
        idx = self.rng.integers(len(obs), size=n - n_prior)
        kde = np.clip(obs[idx] + self.rng.normal(0.0, bw[idx]), lo, hi)
        prior = self.rng.uniform(lo, hi, size=n_prior)
        return np.concatenate([kde, prior])

    def _kde_logpdf(self, x: np.ndarray, obs: np.ndarray, lo: float, hi: float) -> np.ndarray:
        """Log density of the prior-smoothed mixture: n_obs Gaussian
        components (adaptive widths) plus one uniform over [lo, hi]."""
        bw = self._bandwidths(obs, lo, hi)
        d = (x[:, None] - obs[None, :]) / bw[None, :]
        comp = -0.5 * d * d - np.log(bw[None, :] * np.sqrt(2 * np.pi))
        uniform = np.full((len(x), 1), -np.log(max(hi - lo, 1e-12)))
        comp = np.concatenate([comp, uniform], axis=1)
        m = comp.max(axis=1, keepdims=True)
        return m[:, 0] + np.log(np.exp(comp - m).mean(axis=1))

    def suggest(self, history: list[dict]) -> dict:
        ok = [t for t in history if t.get("error") is None and "score" in t]
        if len(ok) < self.n_startup or self.rng.uniform() < self.epsilon:
            return {k: sample_param(v, self.rng) for k, v in self.specs.items()}

        ranked = sorted(ok, key=lambda t: t["score"], reverse=True)
        n_good = max(1, int(np.ceil(self.gamma * len(ranked))))
        good, bad = ranked[:n_good], ranked[n_good:] or ranked[-1:]

        out = {}
        for key, spec in self.specs.items():
            kind = _spec_kind(spec)
            if kind in ("choice", "grid_search"):
                options = list(_spec_options(spec))
                counts_g = np.ones(len(options))
                counts_b = np.ones(len(options))
                for t in good:
                    counts_g[options.index(t["params"][key])] += 1
                for t in bad:
                    counts_b[options.index(t["params"][key])] += 1
                ratio = (counts_g / counts_g.sum()) / (counts_b / counts_b.sum())
                probs = ratio / ratio.sum()
                picked = options[int(self.rng.choice(len(options), p=probs))]
                out[key] = picked.item() if hasattr(picked, "item") else picked
                continue

            log = kind == "loguniform"
            if kind in ("qrandint", "randint"):
                lo, hi, q = (*spec["range"], 1)[:3]
                lo_f, hi_f = float(lo), float(hi - 1)
            else:
                lo_f, hi_f = (float(v) for v in spec["range"])
            if log:
                lo_f, hi_f = np.log(lo_f), np.log(hi_f)

            obs_g = self._numeric_values(key, good, log)
            obs_b = self._numeric_values(key, bad, log)
            cand = self._kde_sample(obs_g, lo_f, hi_f, self.n_candidates)
            score = self._kde_logpdf(cand, obs_g, lo_f, hi_f) - self._kde_logpdf(
                cand, obs_b, lo_f, hi_f
            )
            x = float(cand[int(np.argmax(score))])
            if log:
                x = float(np.exp(x))
            if kind in ("qrandint", "randint"):
                lo, hi, q = (*spec["range"], 1)[:3]
                n_steps = max(0, (hi - 1 - lo) // q)  # grid: lo, lo+q, ..
                x = int(lo + int(np.clip(round((x - lo) / q), 0, n_steps)) * q)
            out[key] = x
        return out


BACKENDS = {
    "random": RandomBackend,
    "grid": GridBackend,
    "tpe": TPEBackend,
}


def create_backend(name: str, specs: dict, seed: int = 0, **kwargs):
    try:
        cls = BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown tuning backend {name!r}; options: {sorted(BACKENDS)}")
    return cls(specs, seed=seed, **kwargs)
