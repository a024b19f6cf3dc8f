"""Katib analog: hyperparameter search with Grid / Random / Bayesian
algorithms + median-rule early stopping (the paper's §5.3/§6.1 substrate).

The Bayesian searcher is a from-scratch numpy Gaussian Process (RBF kernel,
expected improvement acquisition) over the unit-cube-normalised search
space -- no external deps.  All three algorithms drive the same Experiment
tracker, so the Table 2 benchmark (time vs max_trials per algorithm) falls
out of the trial log.  The port's copy of ``repro.tuning.katib`` (numpy
only).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any, Callable, Optional

import numpy as np

from ..core.experiment import Experiment, Trial
from ..checkpoint.store import ArtifactStore


# ---------------------------------------------------------------------------
# Search space
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Double:
    low: float
    high: float
    log: bool = False


@dataclasses.dataclass(frozen=True)
class Integer:
    low: int
    high: int


@dataclasses.dataclass(frozen=True)
class Categorical:
    choices: tuple


SearchSpace = dict  # name -> Double | Integer | Categorical


def _to_unit(space: SearchSpace, params: dict) -> np.ndarray:
    xs = []
    for name, p in space.items():
        v = params[name]
        if isinstance(p, Double):
            if p.log:
                xs.append((math.log(v) - math.log(p.low))
                          / (math.log(p.high) - math.log(p.low)))
            else:
                xs.append((v - p.low) / (p.high - p.low))
        elif isinstance(p, Integer):
            xs.append((v - p.low) / max(p.high - p.low, 1))
        else:
            xs.append(p.choices.index(v) / max(len(p.choices) - 1, 1))
    return np.array(xs)


def _from_unit(space: SearchSpace, x: np.ndarray) -> dict:
    params = {}
    for (name, p), u in zip(space.items(), x):
        u = float(np.clip(u, 0.0, 1.0))
        if isinstance(p, Double):
            if p.log:
                params[name] = math.exp(math.log(p.low)
                                        + u * (math.log(p.high) - math.log(p.low)))
            else:
                params[name] = p.low + u * (p.high - p.low)
        elif isinstance(p, Integer):
            params[name] = int(round(p.low + u * (p.high - p.low)))
        else:
            params[name] = p.choices[int(round(u * (len(p.choices) - 1)))]
    return params


# ---------------------------------------------------------------------------
# Suggestion algorithms
# ---------------------------------------------------------------------------
class GridSearch:
    """Exhaustive sequential sweep (paper: "grows exponentially ... very
    inefficient in time")."""
    name = "grid"

    def __init__(self, space: SearchSpace, max_trials: int, seed: int = 0):
        self.space = space
        k = len(space)
        per_dim = max(2, int(math.ceil(max_trials ** (1.0 / k))))
        axes = [np.linspace(0, 1, per_dim) for _ in range(k)]
        self.points = list(itertools.product(*axes))[:max_trials]
        self.i = 0

    def suggest(self, experiment: Experiment) -> Optional[dict]:
        if self.i >= len(self.points):
            return None
        x = np.array(self.points[self.i]); self.i += 1
        return _from_unit(self.space, x)


class RandomSearch:
    name = "random"

    def __init__(self, space: SearchSpace, max_trials: int, seed: int = 0):
        self.space = space
        self.max_trials = max_trials
        self.rng = np.random.default_rng(seed)
        self.i = 0

    def suggest(self, experiment: Experiment) -> Optional[dict]:
        if self.i >= self.max_trials:
            return None
        self.i += 1
        return _from_unit(self.space, self.rng.random(len(self.space)))


class BayesianSearch:
    """GP(RBF) + expected-improvement; first `n_init` trials random."""
    name = "bayesian"

    def __init__(self, space: SearchSpace, max_trials: int, seed: int = 0,
                 n_init: int = 3, n_candidates: int = 256,
                 length_scale: float = 0.25, noise: float = 1e-4):
        self.space = space
        self.max_trials = max_trials
        self.rng = np.random.default_rng(seed)
        self.n_init = n_init
        self.n_candidates = n_candidates
        self.ls = length_scale
        self.noise = noise
        self.i = 0

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.ls ** 2)

    def suggest(self, experiment: Experiment) -> Optional[dict]:
        if self.i >= self.max_trials:
            return None
        self.i += 1
        done = [t for t in experiment.trials
                if t.status == "done" and experiment.objective(t) is not None]
        if len(done) < self.n_init:
            return _from_unit(self.space, self.rng.random(len(self.space)))
        X = np.stack([_to_unit(self.space, t.params) for t in done])
        y = np.array([experiment.objective(t) for t in done])
        sign = 1.0 if experiment.goal == "minimize" else -1.0
        y = sign * y
        mu_y, std_y = y.mean(), max(y.std(), 1e-9)
        yn = (y - mu_y) / std_y
        K = self._kernel(X, X) + self.noise * np.eye(len(X))
        Kinv = np.linalg.inv(K)
        cand = self.rng.random((self.n_candidates, len(self.space)))
        Ks = self._kernel(cand, X)                    # (C, N)
        mu = Ks @ Kinv @ yn
        var = np.maximum(1.0 - np.einsum("cn,nm,cm->c", Ks, Kinv, Ks), 1e-12)
        sigma = np.sqrt(var)
        best = yn.min()
        z = (best - mu) / sigma
        phi = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
        Phi = 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))
        ei = sigma * (z * Phi + phi)
        return _from_unit(self.space, cand[int(np.argmax(ei))])


ALGORITHMS = {"grid": GridSearch, "random": RandomSearch, "bayesian": BayesianSearch}


# ---------------------------------------------------------------------------
# Early stopping (Katib median-stop rule)
# ---------------------------------------------------------------------------
class MedianStop:
    """Stop a trial whose running objective is worse than the median of
    completed trials' objectives at the same step."""

    def __init__(self, min_trials: int = 3, min_steps: int = 2):
        self.min_trials = min_trials
        self.min_steps = min_steps

    def should_stop(self, experiment: Experiment, trial: Trial, step: int,
                    value: float) -> bool:
        if step < self.min_steps:
            return False
        peers = []
        for t in experiment.trials:
            if t.trial_id == trial.trial_id or not t.history:
                continue
            vals = [v for s, v in t.history if s <= step]
            if vals:
                peers.append(min(vals) if experiment.goal == "minimize" else max(vals))
        if len(peers) < self.min_trials:
            return False
        med = float(np.median(peers))
        return value > med if experiment.goal == "minimize" else value < med


# ---------------------------------------------------------------------------
# Katib experiment loop
# ---------------------------------------------------------------------------
def tune(objective_fn: Callable[..., Any], space: SearchSpace, *,
         algorithm: str = "random", max_trials: int = 10,
         objective_key: str = "loss", goal: str = "minimize",
         early_stopping: Optional[MedianStop] = None, seed: int = 0,
         name: str = "katib", store: Optional[ArtifactStore] = None,
         goal_value: Optional[float] = None) -> Experiment:
    """Run a Katib experiment.

    objective_fn(params, report) -> metrics dict; `report(step, value)` is
    the intermediate-metric callback enabling early stopping.  Stops early
    globally when goal_value is reached (Katib "objective goal").
    """
    exp = Experiment(name=f"{name}-{algorithm}", objective_key=objective_key,
                     goal=goal, store=store)
    algo = ALGORITHMS[algorithm](space, max_trials, seed=seed)
    while True:
        params = algo.suggest(exp)
        if params is None:
            break
        trial = exp.new_trial(params)
        trial.status = "running"
        stopped = {"flag": False}

        def report(step: int, value: float, trial=trial, stopped=stopped):
            trial.report(step, value)
            if early_stopping and early_stopping.should_stop(exp, trial, step, value):
                stopped["flag"] = True
                raise EarlyStopped()

        t0 = time.perf_counter()
        try:
            metrics = objective_fn(params, report)
            trial.metrics = dict(metrics)
            trial.status = "done"
        except EarlyStopped:
            if trial.history:
                trial.metrics = {objective_key: trial.history[-1][1]}
            trial.status = "early_stopped"
        trial.duration_s = time.perf_counter() - t0
        best = exp.best_trial()
        if goal_value is not None and best is not None:
            b = exp.objective(best)
            if (goal == "minimize" and b <= goal_value) or \
               (goal == "maximize" and b >= goal_value):
                break
    exp.save()
    return exp


class EarlyStopped(Exception):
    pass
