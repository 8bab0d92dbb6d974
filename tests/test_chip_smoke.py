"""chip_smoke.py at tiny size on the CPU.

On the card the script runs every phase at 4096 envs and compares each with
the plain reference; here each phase function runs on an explicitly passed
CPU device (its reference comparisons included), the device check refuses a
CPU-only process, and the result line has the format the script promises.
"""

import json

import jax
import pytest

import chip_smoke
from smart_nanogrid_gym_tpu.solvers.ddpg import DDPGConfig
from smart_nanogrid_gym_tpu.solvers.ppo import PPOConfig

CPU = jax.devices("cpu")[0]
SMALL = 16


def test_device_check_refuses_cpu_only_process(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_result_line_format():
    line = json.loads(chip_smoke.result_line(jax.devices("cpu")[:1]))
    assert line == {"ok": True, "device": {"platform": "cpu", "kind": CPU.device_kind,
                                           "count": 1}}


def _check(result, phase):
    assert result["phase"] == phase
    assert result["env_steps_per_s"] > 0


def test_phase_rbc_rollout():
    r = chip_smoke.phase_rbc_rollout(CPU, CPU, batch=SMALL)
    _check(r, "rbc_rollout")
    assert len(r["f64_reference"]["max_abs_dreward_per_step"]) == 24


def test_phase_policy_rollout():
    r = chip_smoke.phase_policy_rollout(CPU, CPU, batch=SMALL)
    _check(r, "policy_rollout")
    assert max(r["f64_reference"]["max_abs_dobs_per_step"]) <= chip_smoke.OBS_ATOL


def test_phase_ppo():
    r = chip_smoke.phase_ppo(CPU, CPU, batch=SMALL, ppo=PPOConfig(num_epochs=2, num_minibatches=2))
    _check(r, "ppo")
    assert len(r["mean_return"]) == 3
    assert r["first_update_vs_cpu"]["highest"]["params"]["rel_to_update"] == 0.0


def test_phase_ddpg():
    r = chip_smoke.phase_ddpg(CPU, CPU, batch=SMALL,
                              ddpg=DDPGConfig(buffer_days=2, gradient_steps=4, batch_size=32))
    _check(r, "ddpg")
    assert r["first_update_vs_cpu"]["highest"]["mean_return_rel"] == 0.0


def test_phase_gym_adapter(tmp_path):
    r = chip_smoke.phase_gym_adapter(CPU, CPU, out_dir=str(tmp_path))
    _check(r, "gym_adapter")
    assert any(tmp_path.rglob("*.json"))


def test_phase_at_scale():
    r = chip_smoke.phase_at_scale(CPU, CPU, batch=SMALL, days=2)
    _check(r, "at_scale")
    assert r["result"]["total_days"] == 2 * SMALL

