"""Hyperparameter sweeps over the wandb sweep.yaml grammar.

The port's own copy of ``neurovit_tpu/training/sweep.py`` (the reference's
``wandb.sweep``/``wandb.agent`` flow over ``configs/sweep.yaml``,
``main.py:149-157``), with the same names and behaviour:

- parameters are mapped onto the real config keys
  (``config.apply_sweep_overrides``; the reference's lowercase names never
  reached its UPPERCASE keys, SURVEY §2.1.5),
- with wandb installed and ``WANDB_ENABLED``, the same wandb.agent flow is
  used,
- without wandb, a local agent samples the identical search space:
  ``values`` uniformly, ``min/max`` ranges log-uniformly (wandb's default
  for positive ranges), tracking the best ``metric.name``; one
  ``np.random.RandomState(TRAINING_SEED)`` stream draws every proposal, so
  the same seed, space and metric history propose the same parameters as
  the JAX package, and each trial appends the same line to
  ``GLOBAL_OUTPUT_DIR/sweep_results.jsonl``.

Search strategy honesty: the local agent honors ``method: random`` exactly.
For ``method: bayes`` (sweep.yaml:2) it is NOT wandb's Bayesian optimizer —
it runs a per-dimension TPE surrogate (Bergstra et al. 2011: split observed
trials into good/bad quantiles, sample candidates from the prior, keep the
candidate maximizing the good/bad density ratio) after a random warmup.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict

import numpy as np
import yaml

from neurovit_tpu_torch.config import apply_sweep_overrides


def sample_params(space: Dict[str, Any], rng: np.random.RandomState
                  ) -> Dict[str, Any]:
    out = {}
    for name, spec in space.items():
        if "value" in spec:
            out[name] = spec["value"]
        elif "values" in spec:
            out[name] = spec["values"][rng.randint(len(spec["values"]))]
        elif "min" in spec and "max" in spec:
            lo, hi = float(spec["min"]), float(spec["max"])
            if lo > 0 and hi > 0:     # log-uniform for positive ranges
                out[name] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
            else:
                out[name] = float(rng.uniform(lo, hi))
        else:
            raise ValueError(f"Unsupported sweep spec for {name}: {spec}")
    return out


_TPE_WARMUP = 8      # random trials before the surrogate kicks in
_TPE_GAMMA = 0.25    # "good" quantile
_TPE_CANDIDATES = 24


def _log_space(spec) -> bool:
    return float(spec["min"]) > 0 and float(spec["max"]) > 0


def tpe_sample(space: Dict[str, Any], history, rng: np.random.RandomState,
               sign: float) -> Dict[str, Any]:
    """One ``method: bayes`` proposal: per-dimension TPE.

    history: [(params, value)]. Trials are split into the best
    ceil(gamma*n) ("good") and the rest ("bad"); for each continuous
    dimension, candidates drawn from the prior are scored by the ratio of
    Gaussian KDE densities good/bad (log-space for positive ranges);
    categorical dimensions sample from the smoothed good-frequency
    distribution. Falls back to the prior during warmup.
    """
    if len(history) < _TPE_WARMUP:
        return sample_params(space, rng)
    ranked = sorted(history, key=lambda pv: sign * pv[1])
    n_good = max(2, int(np.ceil(_TPE_GAMMA * len(ranked))))
    good = [p for p, _ in ranked[:n_good]]
    bad = [p for p, _ in ranked[n_good:]] or good

    def kde(xs, x):
        xs = np.asarray(xs, np.float64)
        bw = max(xs.std(), 1e-3 * (abs(xs.mean()) + 1e-3))
        return np.mean(np.exp(-0.5 * ((x - xs[:, None]) / bw) ** 2), axis=0)

    out = {}
    for name, spec in space.items():
        if "value" in spec:
            out[name] = spec["value"]
        elif "values" in spec:
            choices = list(spec["values"])
            weights = np.array(
                [1.0 + sum(g[name] == c for g in good) for c in choices])
            out[name] = choices[rng.choice(len(choices),
                                           p=weights / weights.sum())]
        elif "min" in spec and "max" in spec:
            to = np.log if _log_space(spec) else (lambda v: v)
            cands = np.array([sample_params({name: spec}, rng)[name]
                              for _ in range(_TPE_CANDIDATES)])
            score = (kde([to(g[name]) for g in good], to(cands))
                     / (kde([to(b[name]) for b in bad], to(cands)) + 1e-12))
            out[name] = float(cands[int(np.argmax(score))])
        else:
            raise ValueError(f"Unsupported sweep spec for {name}: {spec}")
    return out


def _wandb_if_enabled(config: Dict[str, Any]):
    """The wandb module when installed AND WANDB_ENABLED, else None."""
    if not config.get("WANDB_ENABLED", False):
        return None
    try:
        import wandb  # type: ignore
        return wandb
    except ImportError:
        return None


def _run_wandb_agent(wandb, base_config, train_fn, sweep_cfg, count,
                     metric_name, sign, log):
    """The reference's wandb.sweep + wandb.agent flow (main.py:149-157).

    Each agent trial mirrors the reference's ``train_sweep``
    (``main.py:65-84``): wandb.init gives the sampled params in
    ``wandb.config``; they overwrite the base config — but through
    ``apply_sweep_overrides`` so lowercase sweep names reach the real
    UPPERCASE keys (quirk §2.1.5 fix).
    """
    best = {"best_params": None, "best_metric": None, "trials": 0}

    def trial_fn():
        with wandb.init() as _run:
            params = dict(wandb.config)
            config = apply_sweep_overrides(base_config, params)
            metrics = train_fn(config)
            wandb.log(metrics)
        value = float(metrics[metric_name])
        log.write(json.dumps({"trial": best["trials"], "params": params,
                              "metrics": metrics}) + "\n")
        log.flush()
        best["trials"] += 1
        if (best["best_metric"] is None
                or sign * value < sign * best["best_metric"]):
            best["best_metric"] = value
            best["best_params"] = params

    sweep_id = wandb.sweep(sweep_cfg, project="NeuroViT_Sweep")
    wandb.agent(sweep_id, function=trial_fn, count=count)
    return best


def run_sweep(base_config: Dict[str, Any],
              train_fn: Callable[[Dict[str, Any]], Dict[str, float]],
              sweep_config_path: str, count: int = 50) -> Dict[str, Any]:
    """Run `count` sweep trials; returns {"best_params", "best_metric", ...}.

    ``train_fn(config) -> metrics`` must return the sweep metric
    (e.g. {"val_loss": ...}).
    """
    with open(sweep_config_path) as f:
        sweep_cfg = yaml.safe_load(f)
    space = sweep_cfg["parameters"]
    metric_name = sweep_cfg.get("metric", {}).get("name", "val_loss")
    goal = sweep_cfg.get("metric", {}).get("goal", "minimize")
    sign = 1.0 if goal == "minimize" else -1.0

    rng = np.random.RandomState(base_config.get("TRAINING_SEED", 42))
    out_dir = base_config.get("GLOBAL_OUTPUT_DIR", "./results/runs")
    os.makedirs(out_dir, exist_ok=True)
    log_path = os.path.join(out_dir, "sweep_results.jsonl")

    wandb = _wandb_if_enabled(base_config)
    if wandb is not None:
        with open(log_path, "a") as log:
            return _run_wandb_agent(wandb, base_config, train_fn, sweep_cfg,
                                    count, metric_name, sign, log)

    method = sweep_cfg.get("method", "random")
    if method == "bayes":
        print("[sweep] method: bayes -> local TPE surrogate "
              f"(random warmup {_TPE_WARMUP} trials; not wandb's GP)")
    best = {"best_params": None, "best_metric": None, "trials": 0}
    history = []
    with open(log_path, "a") as log:
        for trial in range(count):
            params = (tpe_sample(space, history, rng, sign)
                      if method == "bayes" else sample_params(space, rng))
            config = apply_sweep_overrides(base_config, params)
            print(f"[sweep] trial {trial + 1}/{count}: {params}")
            metrics = train_fn(config)
            value = float(metrics[metric_name])
            history.append((params, value))
            log.write(json.dumps({"trial": trial, "params": params,
                                  "metrics": metrics}) + "\n")
            log.flush()
            best["trials"] = trial + 1
            if (best["best_metric"] is None
                    or sign * value < sign * best["best_metric"]):
                best["best_metric"] = value
                best["best_params"] = params
                print(f"[sweep] new best {metric_name}={value:.5f}")
    return best
