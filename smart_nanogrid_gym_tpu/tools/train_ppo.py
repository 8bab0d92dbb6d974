"""PPO training CLI — the on-device counterpart of solvers/RL/ppo_train.py.

The reference trains SB3 PPO for 50 epochs x 850 episodes x 24 steps = 1.02M
sequential env steps against one Python env (ppo_train.py:94-102).  Here each
update rolls a whole env *batch* for a day on device, so an epoch's 850
episodes take ceil(850/batch) updates; checkpoints are written per epoch with
the reference's numbered convention and config-encoded directory names
(``PPO-{variant}-{charging_mode}-{penalty_mode}-{N}ch-{interval}``,
ppo_train.py:79).

Run:  python -m smart_nanogrid_gym_tpu.tools.train_ppo --variant b-pv \\
          --num-chargers 4 --batch 256 --epochs 5
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import jax
import jax.numpy as jnp

from ..core import NanogridConfig, make_params
from ..parallel.mesh import make_mesh
from ..solvers.ppo import PPOConfig, PPOLearner
from ..utils.checkpoint import save_checkpoint
from ..utils.compile_cache import enable_compile_cache

# The four model variants of the reference training scripts
# (solvers/RL/ppo_train.py:22-75).
VARIANTS = {
    "basic": dict(pv_system=False, battery_system=False, vehicle_to_everything=False),
    "b-pv": dict(pv_system=True, battery_system=True, vehicle_to_everything=False),
    "v2x": dict(pv_system=False, battery_system=False, vehicle_to_everything=True),
    "v2x-b-pv": dict(pv_system=True, battery_system=True, vehicle_to_everything=True),
}


def build_config(args) -> NanogridConfig:
    return NanogridConfig(
        num_chargers=args.num_chargers,
        time_interval=args.time_interval,
        price_model=args.price_model,
        penalty_mode=args.penalty_mode,
        **VARIANTS[args.variant],
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--variant", choices=sorted(VARIANTS), default="b-pv")
    p.add_argument("--num-chargers", type=int, default=4)
    p.add_argument("--time-interval", type=float, default=1.0)
    p.add_argument("--price-model", type=int, default=0)
    p.add_argument("--penalty-mode", default="sparse",
                   choices=["no_penalty", "on_departure", "sparse", "dense"])
    p.add_argument("--batch", type=int, default=256, help="parallel envs")
    p.add_argument("--epochs", type=int, default=50, help="reference: 50")
    p.add_argument("--episodes-per-epoch", type=int, default=850, help="reference: 850")
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--models-dir", default="models")
    p.add_argument("--mesh", action="store_true", help="shard envs over all devices")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host: jax.distributed init + host-local env "
                        "shards over the global mesh (implies --mesh; --batch "
                        "is then the GLOBAL batch)")
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--log-dir", default=None,
                   help="write progress.csv + TensorBoard events here "
                        "(default: <models-dir>/<run>/logs; reference: "
                        "ppo_train.py:92 tensorboard_log)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest full-state checkpoint in models-dir")
    p.add_argument("--guard", action="store_true",
                   help="wrap training in a NaN guard with auto-rollback")
    args = p.parse_args(argv)
    enable_compile_cache()

    config = build_config(args)
    if args.distributed:
        from ..parallel.distributed import initialize_distributed

        proc, nprocs = initialize_distributed()
        print(f"process {proc}/{nprocs}, {len(jax.devices())} global devices", flush=True)
    mesh = make_mesh() if (args.mesh or args.distributed) else None
    learner = PPOLearner(config, PPOConfig(learning_rate=args.learning_rate), mesh=mesh)
    params = make_params(config, dtype=jnp.float32)
    if args.distributed:
        state = learner.init_distributed(
            jax.random.PRNGKey(args.seed), params, global_batch=args.batch, seed=args.seed
        )
    else:
        state = learner.init(jax.random.PRNGKey(args.seed), params, batch_size=args.batch)
    train_step = learner.build_train_step()

    run_name = (
        f"PPO-{args.variant}-{config.charging_mode}-"
        f"{['no_penalty','on_departure','sparse','dense'][int(config.penalty_mode)]}-"
        f"{config.num_chargers}ch-{args.time_interval}h"
    )
    models_dir = os.path.join(args.models_dir, run_name)
    full_state_dir = os.path.join(models_dir, "full")
    updates_per_epoch = max(1, math.ceil(args.episodes_per_epoch / args.batch))
    steps_per_update = args.batch * config.steps_per_day

    start_epoch = 0
    if args.resume:
        from ..utils.checkpoint import latest_step as _latest, restore_checkpoint as _restore

        step = _latest(full_state_dir)
        if step is not None:
            state = _restore(full_state_dir, step, state)
            start_epoch = int(step)
            print(f"resumed from epoch {start_epoch}", flush=True)

    print(f"training {run_name}: {args.epochs} epochs x {updates_per_epoch} updates "
          f"x {steps_per_update} env-steps", flush=True)
    from ..utils.metrics import MetricsWriter

    writer = MetricsWriter(args.log_dir or os.path.join(models_dir, "logs"))
    if args.guard:
        from ..utils.guard import TrainGuard

        guard = TrainGuard(
            lambda s: train_step(s, learner.nanogrid_params_batched),
            ckpt_dir=os.path.join(models_dir, "guard"),
            save_every=updates_per_epoch,
        )

    start = time.time()
    total_steps = 0
    for epoch in range(start_epoch, args.epochs):
        if args.guard:
            metrics = None

            def _capture(i, m):
                nonlocal metrics
                metrics = m

            state = guard.run(state, updates_per_epoch, on_metrics=_capture)
            total_steps += steps_per_update * updates_per_epoch
        else:
            for _ in range(updates_per_epoch):
                state, metrics = train_step(state, learner.nanogrid_params_batched)
                total_steps += steps_per_update
        if epoch % args.log_every == 0 or epoch == args.epochs - 1:
            m = jax.tree.map(float, metrics)
            elapsed = time.time() - start
            print(json.dumps({
                "epoch": epoch,
                "mean_day_return": round(m.mean_return, 3),
                "policy_loss": round(m.policy_loss, 5),
                "value_loss": round(m.value_loss, 3),
                "approx_kl": round(m.approx_kl, 5),
                "env_steps": total_steps,
                "steps_per_sec": round(total_steps / elapsed, 1),
            }), flush=True)
            writer.add(
                total_steps,
                mean_day_return=m.mean_return,
                policy_loss=m.policy_loss,
                value_loss=m.value_loss,
                entropy=m.entropy,
                approx_kl=m.approx_kl,
                steps_per_sec=total_steps / elapsed,
            )
        save_checkpoint(models_dir, steps_per_update * updates_per_epoch * (epoch + 1),
                        state.params, env_config=config)
        save_checkpoint(full_state_dir, epoch + 1, state)

    writer.close()
    elapsed = time.time() - start
    print(f"Training lasted: {elapsed/3600:.0f} h and {elapsed%3600/60:.1f} min "
          f"({total_steps/elapsed:,.0f} env-steps/s)", flush=True)
    return state


if __name__ == "__main__":
    main()
