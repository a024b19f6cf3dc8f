"""Experiment tracking (Kubeflow "Experiments (AutoML)" tab analog):
trials, per-step metrics, best-trial queries.  Backing store is the
ArtifactStore so Katib results survive across pipeline runs.  The port's
copy of ``repro.core.experiment``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

from ..checkpoint.store import ArtifactStore


@dataclasses.dataclass
class Trial:
    trial_id: int
    params: dict
    metrics: dict = dataclasses.field(default_factory=dict)
    history: list = dataclasses.field(default_factory=list)  # intermediate
    status: str = "created"      # created | running | done | early_stopped
    duration_s: float = 0.0

    def report(self, step: int, value: float):
        self.history.append((step, float(value)))

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Experiment:
    def __init__(self, name: str, objective_key: str, goal: str = "minimize",
                 store: Optional[ArtifactStore] = None):
        assert goal in ("minimize", "maximize")
        self.name = name
        self.objective_key = objective_key
        self.goal = goal
        self.store = store
        self.trials: list[Trial] = []

    def new_trial(self, params: dict) -> Trial:
        t = Trial(trial_id=len(self.trials), params=params)
        self.trials.append(t)
        return t

    def objective(self, trial: Trial) -> Optional[float]:
        v = trial.metrics.get(self.objective_key)
        return None if v is None else float(v)

    def best_trial(self) -> Optional[Trial]:
        done = [t for t in self.trials if t.status == "done"
                and self.objective(t) is not None]
        if not done:
            return None
        key = lambda t: self.objective(t)
        return min(done, key=key) if self.goal == "minimize" else max(done, key=key)

    def save(self):
        if self.store:
            self.store.save_json(f"experiment_{self.name}", {
                "name": self.name, "objective": self.objective_key,
                "goal": self.goal, "time": time.time(),
                "trials": [t.as_dict() for t in self.trials],
            })

    def summary(self) -> dict:
        best = self.best_trial()
        return {
            "name": self.name,
            "n_trials": len(self.trials),
            "early_stopped": sum(t.status == "early_stopped" for t in self.trials),
            "best_params": best.params if best else None,
            "best_objective": self.objective(best) if best else None,
            "total_time_s": sum(t.duration_s for t in self.trials),
        }
