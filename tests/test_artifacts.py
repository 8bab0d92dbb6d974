"""Committed trained artifact: restore + performance regression.

The reference ships trained SB3 checkpoints; this repo ships its own flagship
policy trained on an earlier accelerator (artifacts/PPO-b-pv-bounded-sparse-4ch-1h, see
artifacts/README.md).  This test restores it and verifies the recorded
evaluation still reproduces: the policy must beat the RBC baseline by a wide
margin on freshly generated paired days.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params
from smart_nanogrid_gym_tpu.solvers.evaluator import evaluate_policies_same_days
from smart_nanogrid_gym_tpu.solvers.ppo import PPOLearner
from smart_nanogrid_gym_tpu.solvers.rbc import make_rbc_policy_fn
from smart_nanogrid_gym_tpu.utils.checkpoint import latest_step, restore_checkpoint

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "artifacts", "PPO-b-pv-bounded-sparse-4ch-1h")

pytestmark = pytest.mark.skipif(not os.path.isdir(ART), reason="artifact absent")


def test_committed_checkpoint_beats_rbc():
    with open(os.path.join(ART, "config.json")) as fp:
        meta = json.load(fp)
    config = NanogridConfig(
        num_chargers=meta["num_chargers"],
        pv_system=meta["pv_system"],
        battery_system=meta["battery_system"],
        vehicle_to_everything=meta["vehicle_to_everything"],
        penalty_mode=meta["penalty_mode"],
        time_interval=meta["time_interval"],
    )
    params = make_params(config, dtype=jnp.float32)
    learner = PPOLearner(config)
    template = learner.init(jax.random.PRNGKey(0), params, batch_size=1).params
    step = latest_step(ART)
    # 9.83M (round 3) continued to 108.1M (round 5 — documented plateau at
    # mean return ~-50, see eval.json's note)
    assert step == 108_134_400
    net_params = restore_checkpoint(ART, step, template)

    rbc = make_rbc_policy_fn(config)
    res = evaluate_policies_same_days(
        config, params,
        {
            "ppo": learner.policy_fn(net_params),
            "rbc": lambda o, k: rbc(o),
        },
        num_days=64, seed=123,
    )
    ppo, rbc_r = res["ppo"].mean(), res["rbc"].mean()
    # recorded eval: ppo -50.6, rbc -167.6 (artifacts/.../eval.json)
    assert ppo > rbc_r * 0.5, (ppo, rbc_r)
    assert ppo > -90.0, ppo


def test_eval_sidecar_consistent():
    with open(os.path.join(ART, "eval.json")) as fp:
        ev = json.load(fp)
    assert ev["ppo"]["mean"] > ev["ddpg"]["mean"] > ev["rbc"]["mean"] \
        > ev["idle"]["mean"]
    assert ev["env_steps_trained"] == 108_134_400


DDPG_ART = os.path.join(os.path.dirname(ART),
                        "DDPG-b-pv-bounded-sparse-4ch-1h")


@pytest.mark.skipif(not os.path.isdir(DDPG_ART), reason="artifact absent")
def test_ddpg_artifact_beats_rbc():
    """Round-5 DDPG artifact (49.2M env-steps): the restored actor must keep
    beating the RBC baseline by a wide margin on fresh paired days (recorded
    paired eval: ddpg -68.5 vs rbc -167.6 vs idle -962.5)."""
    from smart_nanogrid_gym_tpu.solvers.ddpg import DDPGConfig, DDPGLearner

    with open(os.path.join(DDPG_ART, "config.json")) as fp:
        meta = json.load(fp)
    config = NanogridConfig(
        num_chargers=meta["num_chargers"], pv_system=meta["pv_system"],
        battery_system=meta["battery_system"],
        vehicle_to_everything=meta["vehicle_to_everything"],
        penalty_mode=meta["penalty_mode"],
        time_interval=meta["time_interval"],
    )
    params = make_params(config, dtype=jnp.float32)
    learner = DDPGLearner(config, DDPGConfig(buffer_days=2, gradient_steps=1))
    template = learner.init(
        jax.random.PRNGKey(0), params, batch_size=1).actor_params
    step = latest_step(DDPG_ART)
    assert step == 49_152_000
    actor_params = restore_checkpoint(DDPG_ART, step, template)

    rbc = make_rbc_policy_fn(config)
    res = evaluate_policies_same_days(
        config, params,
        {"ddpg": learner.policy_fn(actor_params),
         "rbc": lambda o, k: rbc(o)},
        num_days=64, seed=123,
    )
    ddpg_r, rbc_r = res["ddpg"].mean(), res["rbc"].mean()
    assert ddpg_r > rbc_r * 0.6, (ddpg_r, rbc_r)
    assert ddpg_r > -110.0, ddpg_r
