"""Single-day prediction CLI — the on-device counterpart of solvers/predictor.py.

Rolls one day per policy (RBC, restored PPO checkpoints, and/or the
reference's shipped SB3 zips) and dumps the full telemetry to a
reference-compatible ``*-prediction_results.json``
(smart_nanogrid_environment.py:239-309 keys) for the visualisation notebooks.
``--plot`` renders the reference predictor's final-rewards bar chart
(solvers/predictor.py:104-120: one bar per model, total day reward).

Run:  python -m smart_nanogrid_gym_tpu.tools.predict --variant b-pv --out out/
"""

from __future__ import annotations

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..compat.gym_adapter import SmartNanogridEnv
from ..solvers.rbc import make_rbc_policy_fn
from ..solvers.ppo import PPOLearner
from ..utils.checkpoint import latest_step, restore_checkpoint
from ..utils.compile_cache import enable_compile_cache
from .train_ppo import VARIANTS


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--variant", choices=sorted(VARIANTS), default="b-pv")
    p.add_argument("--num-chargers", type=int, default=4)
    p.add_argument("--time-interval", default="1h")
    p.add_argument("--penalty-mode", default="sparse",
                   choices=["no_penalty", "on_departure", "sparse", "dense"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="nanogrid_outputs")
    p.add_argument("--models-dir", default=None)
    p.add_argument("--checkpoint-step", type=int, default=None)
    p.add_argument("--sb3-zip", action="append", default=[], metavar="ZIP",
                   help="predict with one of the reference's shipped SB3 PPO "
                        "zips (solvers/predictor.py:60-74 flow, torch-free); "
                        "repeatable — each zip rolls its own fresh day")
    p.add_argument("--with-rbc", action="store_true",
                   help="also roll the RBC baseline (its own day) for the "
                        "--plot comparison")
    p.add_argument("--plot", default=None, metavar="PNG",
                   help="save the per-model total-reward bar chart the "
                        "reference predictor draws (solvers/predictor.py:104-120)")
    args = p.parse_args(argv)
    enable_compile_cache()

    v = VARIANTS[args.variant]
    env = SmartNanogridEnv(
        number_of_chargers=args.num_chargers,
        pv_system_available_in_model=v["pv_system"],
        battery_system_available_in_model=v["battery_system"],
        vehicle_to_everything=v["vehicle_to_everything"],
        time_interval=args.time_interval,
        vehicle_uncharged_penalty_mode=args.penalty_mode,
        algorithm_used="RBC" if not (args.models_dir or args.sb3_zip) else "PPO",
        environment_mode="prediction",
        output_directory=args.out,
        seed=args.seed,
    )

    # Assemble {name: (algorithm_tag, policy_fn)} — mirrors the reference
    # predictor's model loop (solvers/predictor.py:87-94: one fresh day per
    # model, environment_mode='prediction').
    policies: dict[str, tuple] = {}
    if args.sb3_zip:
        from ..compat.sb3_loader import load_sb3_actor_critic, make_sb3_policy_fn

        for zip_path in args.sb3_zip:
            net_params, _ = load_sb3_actor_critic(zip_path, env.config)
            sb3_policy = make_sb3_policy_fn(
                env.config, jax.tree.map(jnp.asarray, net_params))
            base = os.path.splitext(os.path.basename(zip_path))[0]
            parent = os.path.basename(os.path.dirname(os.path.abspath(zip_path)))
            tag = f"SB3-{parent}@{base}" if parent else f"SB3-{base}"
            # two zips with the same parent-dir/basename must not silently
            # overwrite each other in the policies dict (ADVICE r3)
            unique, n = tag, 2
            while unique in policies:
                unique = f"{tag}#{n}"
                n += 1
            policies[unique] = ("PPO", lambda obs, key, p=sb3_policy: p(obs))
    if args.models_dir:
        learner = PPOLearner(env.config)
        from ..core import make_params

        init_state = learner.init(
            jax.random.PRNGKey(0), make_params(env.config, dtype=jnp.float32), batch_size=1
        )
        step = args.checkpoint_step if args.checkpoint_step is not None else latest_step(args.models_dir)
        net_params = restore_checkpoint(args.models_dir, step, init_state.params)
        name = os.path.basename(os.path.normpath(args.models_dir))
        policies[f"{name}@{step}"] = ("PPO", learner.policy_fn(net_params))
    if args.with_rbc or not policies:
        rbc = make_rbc_policy_fn(env.config)
        policies["RBC"] = ("RBC", lambda obs, key: rbc(obs))

    day_returns: dict[str, float] = {}
    for name, (algo, policy) in policies.items():
        obs, _ = env.reset(algorithm_used=algo)
        total = 0.0
        done = False
        while not done:
            action = np.asarray(policy(jnp.asarray(obs), None))
            obs, reward, done, _, _ = env.step(action)
            total += reward
        day_returns[name] = total

    report = {"day_returns": day_returns, "output_dir": env._out_dir()}
    if len(day_returns) == 1:
        # the single-policy scalar convenience; ambiguous (and therefore
        # omitted) when several models ran — consumers read day_returns then
        report["day_return"] = next(iter(day_returns.values()))
    if args.plot:
        plot_final_rewards(day_returns, args.plot)
        report["figure"] = args.plot
    print(json.dumps(report))
    return report.get("day_return", day_returns)


def plot_final_rewards(day_returns: dict[str, float], out_path: str) -> str:
    """One bar per model, total single-day reward — the figure the reference
    predictor saves as prediction_figure_final_rewards_*.png
    (solvers/predictor.py:104-120: per-model bars, legend, grid)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(15, 10))
    for i, (name, total) in enumerate(day_returns.items()):
        ax.bar(i, total, label=name)
    ax.set_xlabel("Prediction model")
    ax.set_ylabel("Total reward")
    ax.set_xticks(range(len(day_returns)))
    ax.set_xticklabels(list(day_returns), rotation=15, ha="right", fontsize=8)
    ax.legend()
    ax.grid(True)
    parent = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(parent, exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


if __name__ == "__main__":
    main()
