"""Plain-JAX networks (solvers/networks.py).

The param tree is the contract with the committed checkpoints and the SB3
loader, so where flax is importable the layout and the forward pass are
compared with the flax modules the checkpoints were written from.  Init draws
need not match flax's; the orthogonal gains must.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smart_nanogrid_gym_tpu.core import NanogridConfig
from smart_nanogrid_gym_tpu.solvers.networks import ActorCritic, DDPGActor, DDPGCritic

CONFIG = NanogridConfig(num_chargers=8, pv_system=True, battery_system=True)
LOW, HIGH = (tuple(b.tolist()) for b in CONFIG.action_bounds())
OBS = jax.random.uniform(jax.random.PRNGKey(5), (6, CONFIG.obs_dim), jnp.float32)
ACT = jax.random.uniform(jax.random.PRNGKey(6), (6, CONFIG.num_actions), jnp.float32)


def _flax_modules():
    """The flax definitions the committed checkpoints were written from."""
    nn = pytest.importorskip("flax.linen")

    class MLP(nn.Module):
        features: tuple
        activation: str = "tanh"
        out_dim: int = 1
        out_scale: float = 1.0

        @nn.compact
        def __call__(self, x):
            act = nn.tanh if self.activation == "tanh" else nn.relu
            for f in self.features:
                x = act(nn.Dense(f, kernel_init=nn.initializers.orthogonal(np.sqrt(2)))(x))
            return nn.Dense(self.out_dim,
                            kernel_init=nn.initializers.orthogonal(self.out_scale))(x)

    class FlaxActorCritic(nn.Module):
        action_dim: int

        @nn.compact
        def __call__(self, obs):
            mean = MLP((64, 64), "tanh", self.action_dim, 0.01, name="pi")(obs)
            log_std = self.param("log_std", nn.initializers.zeros, (self.action_dim,))
            value = MLP((64, 64), "tanh", 1, 1.0, name="vf")(obs)
            return mean, log_std, jnp.squeeze(value, axis=-1)

    class FlaxDDPGActor(nn.Module):
        action_dim: int

        @nn.compact
        def __call__(self, obs):
            x = jnp.tanh(MLP((400, 300), "relu", self.action_dim, 1.0, name="mu")(obs))
            low, high = jnp.asarray(LOW, x.dtype), jnp.asarray(HIGH, x.dtype)
            return low + (x + 1.0) * 0.5 * (high - low)

    class FlaxDDPGCritic(nn.Module):
        @nn.compact
        def __call__(self, obs, action):
            x = jnp.concatenate([obs, action], axis=-1)
            return jnp.squeeze(MLP((400, 300), "relu", 1, 1.0, name="q")(x), axis=-1)

    A = CONFIG.num_actions
    return {
        "actor_critic": (ActorCritic(A), FlaxActorCritic(A), (OBS,)),
        "ddpg_actor": (DDPGActor(A, LOW, HIGH), FlaxDDPGActor(A), (OBS,)),
        "ddpg_critic": (DDPGCritic(), FlaxDDPGCritic(), (OBS, ACT)),
    }


MODULES = ("actor_critic", "ddpg_actor", "ddpg_critic")


def _layout(tree):
    return jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jax.tree.map(jnp.asarray, tree))


@pytest.mark.parametrize("name", MODULES)
def test_param_tree_matches_flax(name):
    ours, theirs, inputs = _flax_modules()[name]
    # the checkpoints were written without x64 (flax's log_std takes the
    # default float dtype)
    with jax.enable_x64(False):
        p_ours = ours.init(jax.random.PRNGKey(0), *inputs)
        p_flax = theirs.init(jax.random.PRNGKey(0), *inputs)
    assert _layout(p_ours) == _layout(p_flax)


@pytest.mark.parametrize("name", MODULES)
def test_apply_matches_flax(name):
    ours, theirs, inputs = _flax_modules()[name]
    # flax-initialised params, as restored from a committed checkpoint
    params = theirs.init(jax.random.PRNGKey(1), *inputs)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                rtol=1e-6, atol=1e-7),
        ours.apply(params, *inputs), theirs.apply(params, *inputs))


def test_orthogonal_init_gains():
    """Hidden kernels are orthogonal with gain √2, output kernels with the
    SB3 head gains (0.01 policy mean, 1.0 value/DDPG), biases and log-std 0."""
    A = CONFIG.num_actions
    cases = [
        (ActorCritic(A).init(jax.random.PRNGKey(2), OBS)["params"],
         {"pi": 0.01, "vf": 1.0}),
        (DDPGActor(A, LOW, HIGH).init(jax.random.PRNGKey(3), OBS)["params"], {"mu": 1.0}),
        (DDPGCritic().init(jax.random.PRNGKey(4), OBS, ACT)["params"], {"q": 1.0}),
    ]
    for params, heads in cases:
        for mlp, head_gain in heads.items():
            layers = params[mlp]
            for i in range(len(layers)):
                k = np.asarray(layers[f"Dense_{i}"]["kernel"], np.float64)
                gain = head_gain if i == len(layers) - 1 else np.sqrt(2)
                gram = k.T @ k if k.shape[0] >= k.shape[1] else k @ k.T
                np.testing.assert_allclose(gram, gain**2 * np.eye(len(gram)), atol=1e-5 * gain**2 + 1e-6)
                assert not np.asarray(layers[f"Dense_{i}"]["bias"]).any()
        if "log_std" in params:
            assert not np.asarray(params["log_std"]).any()
