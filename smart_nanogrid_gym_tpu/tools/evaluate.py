"""Evaluation CLI — the on-device counterpart of solvers/evaluator.py.

The reference loads every trained model, replays 100 *identical* days across
all of them via initial_values.json round-trips, and plots per-episode rewards
(solvers/evaluator.py:88-127).  Here the paired same-day comparison runs fully
on device (days are the batch axis) and always includes the RBC baseline and an
idle policy; trained checkpoints are restored from --models-dir.

Run:  python -m smart_nanogrid_gym_tpu.tools.evaluate --variant b-pv --days 100
"""

from __future__ import annotations

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..core import make_params
from ..solvers.evaluator import evaluate_policies_same_days
from ..solvers.ppo import PPOLearner
from ..solvers.rbc import make_rbc_policy_fn
from ..utils.checkpoint import latest_step, restore_checkpoint
from ..utils.compile_cache import enable_compile_cache
from .train_ppo import VARIANTS, build_config


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--variant", choices=sorted(VARIANTS), default="b-pv")
    p.add_argument("--num-chargers", type=int, default=4)
    p.add_argument("--time-interval", type=float, default=1.0)
    p.add_argument("--price-model", type=int, default=0)
    p.add_argument("--penalty-mode", default="sparse",
                   choices=["no_penalty", "on_departure", "sparse", "dense"])
    p.add_argument("--days", type=int, default=100, help="reference: 100 episodes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--models-dir", default=None,
                   help="PPO checkpoint dir to evaluate (optional)")
    p.add_argument("--models-root", default=None,
                   help="scan every run dir under this root (reference "
                        "evaluator style, solvers/evaluator.py:44-77)")
    p.add_argument("--checkpoint-step", type=int, default=None)
    p.add_argument("--at-scale", type=int, default=None, metavar="DAYS",
                   help="ALSO evaluate each checkpoint (PPO or DDPG) on DAYS "
                        "freshly generated days x 4096 envs in one jitted "
                        "program (solvers.evaluator.evaluate_policy_at_scale)")
    p.add_argument("--sb3-zip", action="append", default=[], metavar="ZIP",
                   help="evaluate an SB3 PPO checkpoint zip as shipped by the "
                        "reference (solvers/RL/models/*/NNN.zip); repeatable")
    p.add_argument("--sb3-models-dir", default=None,
                   help="reference-style model dir of NNN.zip checkpoints; "
                        "picks --sb3-checkpoint (reference evaluator.py:49-51)")
    p.add_argument("--sb3-checkpoint", default="999600",
                   help="checkpoint number inside --sb3-models-dir")
    p.add_argument("--plot", default=None, metavar="PNG",
                   help="save the per-episode reward comparison figure "
                        "(reference solvers/evaluator.py:111-127)")
    args = p.parse_args(argv)
    enable_compile_cache()

    config = build_config(args)
    params = make_params(config, dtype=jnp.float32)
    rbc = make_rbc_policy_fn(config)

    policies = {
        "RBC": lambda obs, key: rbc(obs),
        "idle": lambda obs, key: jnp.zeros(obs.shape[:-1] + (config.num_actions,), obs.dtype),
    }

    model_dirs = []
    at_scale_checkpoints: dict[str, tuple] = {}
    if args.models_dir:
        model_dirs.append(args.models_dir)
    if args.models_root and os.path.isdir(args.models_root):
        for name in sorted(os.listdir(args.models_root)):
            path = os.path.join(args.models_root, name)
            if os.path.isdir(path) and latest_step(path) is not None:
                model_dirs.append(path)

    if model_dirs:
        # Algorithm inferred from the run-dir name prefix, like the reference
        # evaluator's name->algorithm mapping (solvers/evaluator.py:67-77).
        # Learner templates are built lazily on the first matching run dir.
        from ..solvers.ddpg import DDPGLearner

        learners: dict[str, tuple] = {}

        def get_learner(is_ddpg: bool):
            kind = "ddpg" if is_ddpg else "ppo"
            if kind not in learners:
                if is_ddpg:
                    learner = DDPGLearner(config)
                    template = learner.init(jax.random.PRNGKey(0), params, batch_size=1).actor_params
                else:
                    learner = PPOLearner(config)
                    template = learner.init(jax.random.PRNGKey(0), params, batch_size=1).params
                learners[kind] = (learner, template)
            return learners[kind]

        for d in model_dirs:
            name = os.path.basename(os.path.normpath(d))
            step = args.checkpoint_step if args.checkpoint_step is not None else latest_step(d)
            is_ddpg = name.upper().startswith("DDPG")
            learner, template = get_learner(is_ddpg)
            try:
                net_params = restore_checkpoint(d, step, template)
            except Exception as exc:  # incompatible run dir (other config)
                print(f"# skipping {d}: {exc}", flush=True)
                continue
            policies[f"{name}@{step}"] = learner.policy_fn(net_params)
            at_scale_checkpoints[f"{name}@{step}"] = (
                "ddpg" if is_ddpg else "ppo", net_params)

    sb3_zips = list(args.sb3_zip)
    if args.sb3_models_dir:
        sb3_zips.append(os.path.join(args.sb3_models_dir, f"{args.sb3_checkpoint}.zip"))
    if sb3_zips:
        from ..compat.sb3_loader import load_sb3_actor_critic, make_sb3_policy_fn

        for zip_path in sb3_zips:
            net_params, _ = load_sb3_actor_critic(zip_path, config)
            tag = "SB3-" + os.path.splitext(os.path.basename(zip_path))[0]
            parent = os.path.basename(os.path.dirname(os.path.abspath(zip_path)))
            if parent:
                tag = f"SB3-{parent}@{os.path.splitext(os.path.basename(zip_path))[0]}"
            policies[tag] = make_sb3_policy_fn(config, net_params)
            at_scale_checkpoints[tag] = (
                "ppo", jax.tree.map(jnp.asarray, net_params))

    results = evaluate_policies_same_days(
        config, params, policies, num_days=args.days, seed=args.seed
    )
    report = {
        name: {
            "mean_day_return": float(np.mean(r)),
            "std": float(np.std(r)),
            "min": float(np.min(r)),
            "max": float(np.max(r)),
        }
        for name, r in results.items()
    }

    if args.at_scale:
        from ..solvers.evaluator import evaluate_policy_at_scale

        for name, (algo, net_params) in at_scale_checkpoints.items():
            report[f"{name} (at-scale)"] = evaluate_policy_at_scale(
                config, params, net_params, num_days=args.at_scale,
                seed=args.seed, algorithm=algo,
            )

    if args.plot:
        plot_reward_comparison(results, args.plot)
        report["figure"] = args.plot

    print(json.dumps(report, indent=2))
    return results


def plot_reward_comparison(results: dict[str, np.ndarray], out_path: str) -> str:
    """Per-episode total-reward comparison across policies — the figure the
    reference evaluator produces (solvers/evaluator.py:111-127, shipped as
    images/Comparison_Evaluation_Reward.png): one line per model over the
    evaluation episodes, legend, grid."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(15, 10))
    for name, rewards in results.items():
        ax.plot(np.asarray(rewards), label=name)
    ax.set_xlabel("Evaluation episodes")
    ax.set_ylabel("Total reward per episode")
    ax.legend()
    ax.grid(True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


if __name__ == "__main__":
    main()
