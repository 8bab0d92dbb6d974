"""DDPG training CLI — the on-device counterpart of solvers/RL/ddpg_train.py.

Matches the reference setup: OU action noise with sigma=0.5 (ddpg_train.py:111),
the same four env variants, per-epoch numbered checkpoints under a
config-encoded directory name (``DDPG-{variant}-...``).

Run:  python -m smart_nanogrid_gym_tpu.tools.train_ddpg --variant b-pv --epochs 5
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import jax
import jax.numpy as jnp

from ..core import make_params
from ..solvers.ddpg import DDPGConfig, DDPGLearner
from ..utils.checkpoint import save_checkpoint
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
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--episodes-per-epoch", type=int, default=850)
    p.add_argument("--ou-sigma", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--models-dir", default="models")
    p.add_argument("--log-dir", default=None,
                   help="write progress.csv + TensorBoard events here "
                        "(default: <models-dir>/<run>/logs)")
    p.add_argument("--log-every", type=int, default=1)
    args = p.parse_args(argv)
    enable_compile_cache()

    config = build_config(args)
    learner = DDPGLearner(config, DDPGConfig(ou_sigma=args.ou_sigma))
    params = make_params(config, dtype=jnp.float32)
    state = learner.init(jax.random.PRNGKey(args.seed), params, batch_size=args.batch)
    train_step = learner.build_train_step()

    run_name = (
        f"DDPG-{args.variant}-{config.charging_mode}-"
        f"{['no_penalty','on_departure','sparse','dense'][int(config.penalty_mode)]}-"
        f"{config.num_chargers}ch-{args.time_interval}h"
    )
    models_dir = os.path.join(args.models_dir, run_name)
    updates_per_epoch = max(1, math.ceil(args.episodes_per_epoch / args.batch))
    steps_per_update = args.batch * config.steps_per_day

    from ..utils.metrics import MetricsWriter

    writer = MetricsWriter(args.log_dir or os.path.join(models_dir, "logs"))
    start = time.time()
    total_steps = 0
    for epoch in range(args.epochs):
        for _ in range(updates_per_epoch):
            state, metrics = train_step(state, learner.nanogrid_params_batched)
            total_steps += steps_per_update
        if epoch % args.log_every == 0 or epoch == args.epochs - 1:
            m = {k: float(v) for k, v in metrics.items()}
            elapsed = time.time() - start
            print(json.dumps({
                "epoch": epoch,
                "mean_day_return": round(m["mean_return"], 3),
                "critic_loss": round(m["critic_loss"], 4),
                "actor_loss": round(m["actor_loss"], 4),
                "env_steps": total_steps,
                "steps_per_sec": round(total_steps / elapsed, 1),
            }), flush=True)
            writer.add(
                total_steps,
                mean_day_return=m["mean_return"],
                critic_loss=m["critic_loss"],
                actor_loss=m["actor_loss"],
                steps_per_sec=total_steps / elapsed,
            )
        save_checkpoint(models_dir, steps_per_update * updates_per_epoch * (epoch + 1),
                        state.actor_params, env_config=config)

    writer.close()
    elapsed = time.time() - start
    print(f"Training lasted: {elapsed/3600:.0f} h and {elapsed%3600/60:.1f} min", flush=True)
    return state


if __name__ == "__main__":
    main()
