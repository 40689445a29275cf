"""Actor-critic policy networks.

Architecture matches the reference's stable-baselines3 MlpPolicy config:
separate policy and value towers, each 2x128 with tanh activations, a linear
action head initialized U(0, 0.01), and a state-independent log-std
(reference: learning/learn_locomotion.py:70-71,99-104; inference-side MLP at
src/learning/learned_locomotion.cpp:11-26).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIDDEN = 128

_lecun_normal = jax.nn.initializers.lecun_normal()


def _dense(key, fan_in, fan_out, kernel_init=_lecun_normal):
    return {"kernel": kernel_init(key, (fan_in, fan_out), jnp.float32),
            "bias": jnp.zeros((fan_out,), jnp.float32)}


def _apply_dense(p, x):
    return x @ p["kernel"] + p["bias"]


class ActorCritic:
    """Plain-JAX MLP with a `{"params": {...}}` tree: `pi_0`, `pi_1`,
    `action_head`, `vf_0`, `vf_1`, `value_head` ({kernel (in, out), bias})
    and `log_std`.  Hidden kernels use LeCun-normal init, biases and log-std
    zeros, the action head U(0, 0.01)."""

    def __init__(self, action_dim: int):
        self.action_dim = action_dim

    def init(self, key, obs):
        in_dim = obs.shape[-1]
        k = jax.random.split(key, 6)
        head_init = jax.nn.initializers.uniform(scale=0.01)
        params = {
            "pi_0": _dense(k[0], in_dim, HIDDEN),
            "pi_1": _dense(k[1], HIDDEN, HIDDEN),
            "action_head": _dense(k[2], HIDDEN, self.action_dim, head_init),
            "vf_0": _dense(k[3], in_dim, HIDDEN),
            "vf_1": _dense(k[4], HIDDEN, HIDDEN),
            "value_head": _dense(k[5], HIDDEN, 1),
            "log_std": jnp.zeros((self.action_dim,), jnp.float32),
        }
        return {"params": params}

    def apply(self, variables, obs):
        """Returns (action mean, log_std, value) for a batch of observations."""
        p = variables["params"]
        pi = obs
        for name in ("pi_0", "pi_1"):
            pi = jnp.tanh(_apply_dense(p[name], pi))
        mean = _apply_dense(p["action_head"], pi)
        vf = obs
        for name in ("vf_0", "vf_1"):
            vf = jnp.tanh(_apply_dense(p[name], vf))
        value = _apply_dense(p["value_head"], vf)
        return mean, p["log_std"], jnp.squeeze(value, -1)


def sample_action(mean, log_std, key):
    std = jnp.exp(log_std)
    noise = jax.random.normal(key, mean.shape)
    action = mean + std * noise
    logp = gaussian_logp(action, mean, log_std)
    return action, logp


def gaussian_logp(action, mean, log_std):
    std = jnp.exp(log_std)
    z = (action - mean) / std
    return jnp.sum(-0.5 * z * z - log_std - 0.5 * jnp.log(2.0 * jnp.pi), axis=-1)


def gaussian_entropy(log_std):
    return jnp.sum(log_std + 0.5 * jnp.log(2.0 * jnp.pi * jnp.e), axis=-1)
