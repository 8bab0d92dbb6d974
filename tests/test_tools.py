"""CLI tools, checkpointing, registration, and profiling tests."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params
from smart_nanogrid_gym_tpu.solvers.ppo import PPOConfig, PPOLearner
from smart_nanogrid_gym_tpu.utils import (
    PhaseTimer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)


def test_checkpoint_round_trip(tmp_path):
    cfg = NanogridConfig(num_chargers=4, pv_system=False, battery_system=False)
    learner = PPOLearner(cfg, PPOConfig(num_epochs=1, num_minibatches=1))
    params = make_params(cfg, dtype=jnp.float32)
    state = learner.init(jax.random.PRNGKey(0), params, batch_size=8)

    d = str(tmp_path / "ckpts")
    save_checkpoint(d, 100, state.params, env_config=cfg)
    save_checkpoint(d, 200, state.params, env_config=cfg)
    assert latest_step(d) == 200

    restored = restore_checkpoint(d, 200, state.params)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with open(os.path.join(d, "config.json")) as fp:
        meta = json.load(fp)
    assert meta["num_chargers"] == 4


def test_train_ppo_cli_smoke(tmp_path):
    from smart_nanogrid_gym_tpu.tools.train_ppo import main

    state = main([
        "--variant", "basic", "--num-chargers", "4", "--batch", "16",
        "--epochs", "1", "--episodes-per-epoch", "16",
        "--models-dir", str(tmp_path / "models"), "--seed", "1",
    ])
    run_dirs = os.listdir(tmp_path / "models")
    assert len(run_dirs) == 1 and run_dirs[0].startswith("PPO-basic-bounded-sparse-4ch")
    assert latest_step(tmp_path / "models" / run_dirs[0]) is not None


def test_train_ddpg_cli_smoke(tmp_path):
    from smart_nanogrid_gym_tpu.tools.train_ddpg import main

    main([
        "--variant", "basic", "--num-chargers", "4", "--batch", "8",
        "--epochs", "1", "--episodes-per-epoch", "8",
        "--models-dir", str(tmp_path / "models"), "--seed", "1",
    ])
    run_dirs = os.listdir(tmp_path / "models")
    assert run_dirs[0].startswith("DDPG-basic")


def test_evaluate_cli_smoke(capsys):
    from smart_nanogrid_gym_tpu.tools.evaluate import main

    results = main(["--variant", "basic", "--num-chargers", "4", "--days", "8"])
    assert set(results) == {"RBC", "idle"}
    out = json.loads(capsys.readouterr().out)
    assert "RBC" in out and np.isfinite(out["RBC"]["mean_day_return"])


def test_predict_cli_smoke(tmp_path):
    from smart_nanogrid_gym_tpu.tools.predict import main

    ret = main(["--variant", "b-pv", "--num-chargers", "4",
                "--out", str(tmp_path / "out"), "--seed", "3"])
    assert np.isfinite(ret)
    files = []
    for root, _, names in os.walk(tmp_path / "out"):
        files += names
    assert any("prediction_results.json" in f for f in files)


def test_predict_cli_plot_and_multi_model(tmp_path, capsys):
    """--plot renders the reference predictor's final-rewards bar chart
    (solvers/predictor.py:104-120) over one fresh day per model."""
    from smart_nanogrid_gym_tpu.tools.predict import main

    sb3_zip = "/root/reference/solvers/RL/models/PPO-b-pv-bounded-sparse-4ch-1h/999600.zip"
    argv = ["--variant", "b-pv", "--num-chargers", "4",
            "--out", str(tmp_path / "out"), "--seed", "5",
            "--with-rbc", "--plot", str(tmp_path / "bars.png")]
    expected = {"RBC"}
    if os.path.exists(sb3_zip):
        # passed twice: duplicate tags must be de-duplicated, not silently
        # overwrite each other in the policies dict (ADVICE r3)
        argv += ["--sb3-zip", sb3_zip, "--sb3-zip", sb3_zip]
        expected.add("SB3-PPO-b-pv-bounded-sparse-4ch-1h@999600")
        expected.add("SB3-PPO-b-pv-bounded-sparse-4ch-1h@999600#2")
    ret = main(argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out["day_returns"]) == expected
    assert all(np.isfinite(v) for v in out["day_returns"].values())
    if len(expected) == 1:
        assert np.isfinite(ret)
        assert out["day_return"] == out["day_returns"]["RBC"]
    else:
        # multi-model: the ambiguous scalar is omitted (ADVICE r3)
        assert "day_return" not in out
        assert isinstance(ret, dict)
    fig = tmp_path / "bars.png"
    assert fig.exists() and fig.stat().st_size > 5_000


def test_api_docs_current():
    """docs/API.md must match the live public surface (regenerate with
    python -m smart_nanogrid_gym_tpu.tools.gen_api_docs)."""
    from smart_nanogrid_gym_tpu.tools.gen_api_docs import render

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo_root, "docs", "API.md")) as fp:
        assert fp.read() == render(), (
            "docs/API.md is stale — run python -m "
            "smart_nanogrid_gym_tpu.tools.gen_api_docs")


def test_gymnasium_registration():
    gymnasium = pytest.importorskip("gymnasium")
    import smart_nanogrid_gym_tpu.envs  # noqa: F401  (side effect: register)

    env = gymnasium.make(
        "SmartNanogridEnv-v0",
        number_of_chargers=4,
        pv_system_available_in_model=False,
        battery_system_available_in_model=False,
        time_interval="1h",
        vehicle_uncharged_penalty_mode="dense",
        output_directory=None,
    )
    obs, _ = env.reset()
    assert obs.shape == (12,)
    obs, reward, done, trunc, info = env.step(np.zeros(4, dtype=np.float32))
    assert np.isfinite(reward)


def test_visualize_cli(tmp_path):
    from smart_nanogrid_gym_tpu.tools.predict import main as predict_main
    from smart_nanogrid_gym_tpu.tools.visualize import main as viz_main

    predict_main(["--variant", "b-pv", "--num-chargers", "4",
                  "--out", str(tmp_path / "out"), "--seed", "2"])
    results = None
    for root, _, files in os.walk(tmp_path / "out"):
        for f in files:
            if f == "prediction_results.json":
                results = os.path.join(root, f)
    fig = viz_main(["--results", results, "--out", str(tmp_path / "fig.png"),
                    "--html", str(tmp_path / "day.html")])
    assert os.path.exists(fig) and os.path.getsize(fig) > 10_000

    # interactive self-contained HTML explorer (notebook-parity, no plotly):
    # the embedded panel payload must parse and carry the full telemetry
    import re

    html = (tmp_path / "day.html").read_text()
    panels = json.loads(re.search(r"const PANELS = (\[.*?\]);\n", html, re.S).group(1))
    titles = {p["title"] for p in panels}
    assert {"Actions", "Costs", "Vehicle penalties"} <= titles, titles
    assert all(p["series"] and all(s["y"] for s in p["series"]) for p in panels)
    js = html[html.index("<script>"):html.index("</script>")]
    for a, b in ("()", "{}", "[]"):
        assert js.count(a) == js.count(b), f"unbalanced {a}{b} in generated JS"


def test_evaluate_models_root_scan(tmp_path):
    from smart_nanogrid_gym_tpu.tools.train_ppo import main as train_main
    from smart_nanogrid_gym_tpu.tools.evaluate import main as eval_main

    train_main(["--variant", "basic", "--num-chargers", "4", "--batch", "8",
                "--epochs", "1", "--episodes-per-epoch", "8",
                "--models-dir", str(tmp_path / "models"), "--seed", "2"])
    results = eval_main(["--variant", "basic", "--num-chargers", "4", "--days", "8",
                         "--models-root", str(tmp_path / "models")])
    assert any(name.startswith("PPO-basic") for name in results), results.keys()


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("a"):
        _ = sum(range(1000))
    with t.phase("a"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2 and s["a"]["total_s"] > 0
def test_vector_env_api():
    import numpy as np
    from smart_nanogrid_gym_tpu.compat.vector_env import VectorSmartNanogridEnv

    env = VectorSmartNanogridEnv(
        num_envs=32, seed=0, number_of_chargers=4,
        pv_system_available_in_model=True, battery_system_available_in_model=True,
        time_interval="1h", vehicle_uncharged_penalty_mode="sparse",
    )
    obs, _ = env.reset()
    assert obs.shape == (32, 17)
    for t in range(24):
        actions = np.tile(np.asarray([0.5, 0.5, 0.5, 0.5, 0.1], np.float32), (32, 1))
        obs, rew, term, trunc, infos = env.step(actions)
        assert obs.shape == (32, 17) and rew.shape == (32,)
    assert term.all() and "final_observation" in infos
    # autoreset happened: next step runs on a fresh day
    obs2, rew2, term2, _, _ = env.step(actions)
    assert not term2.any()


def test_gymnasium_check_env():
    """The modern equivalent of the reference's only automated check —
    SB3's check_env(env) in ddpg_train.py:107 — is gymnasium's env_checker."""
    gymnasium = pytest.importorskip("gymnasium")
    from gymnasium.utils.env_checker import check_env

    from smart_nanogrid_gym_tpu.compat.gym_adapter import SmartNanogridEnv

    env = SmartNanogridEnv(
        number_of_chargers=4,
        pv_system_available_in_model=False,
        battery_system_available_in_model=False,
        time_interval="1h",
        vehicle_uncharged_penalty_mode="dense",
        output_directory=None,
    )
    # skip render check (the reference's render() is a no-op too)
    check_env(env, skip_render_check=True)


def test_train_multi_cli_smoke(tmp_path):
    from smart_nanogrid_gym_tpu.tools.train_multi import main

    results = main([
        "--algos", "ppo", "--variants", "basic", "--num-chargers", "4",
        "--batch", "8", "--epochs", "1", "--episodes-per-epoch", "8",
        "--models-dir", str(tmp_path / "m"), "--eval-days", "4",
    ])
    assert "basic" in results
    assert any(name.startswith("PPO-basic") for name in results["basic"])
