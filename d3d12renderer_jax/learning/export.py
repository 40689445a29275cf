"""Policy weight export for engine-embedded inference.

Reference: learning/convert_model_to_c++.py:8-46 dumps the trained policy as
C arrays (`network.h`) consumed by a hand-written C++ MLP forward
(src/learning/learned_locomotion.cpp:11-26 applyLayer).  This framework's
in-engine inference is just jnp (learned_locomotion::update equivalent lives
in the env), but the C-array export is preserved for embedding the policy in
native runtimes.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def _extract_mlp(params: Any):
    """Pull (w1, b1, w2, b2, w_out, b_out) from ActorCritic params
    (policy tower + action head, learning/networks.py)."""
    p = params["params"] if "params" in params else params
    return [
        (np.asarray(p["pi_0"]["kernel"]), np.asarray(p["pi_0"]["bias"])),
        (np.asarray(p["pi_1"]["kernel"]), np.asarray(p["pi_1"]["bias"])),
        (np.asarray(p["action_head"]["kernel"]),
         np.asarray(p["action_head"]["bias"])),
    ]


def _c_array(name: str, arr: np.ndarray) -> str:
    if arr.ndim == 1:
        body = ", ".join(f"{v:.8f}f" for v in arr)
        return f"static const float {name}[{arr.shape[0]}] = {{ {body} }};\n"
    rows = []
    for r in arr:
        rows.append("  { " + ", ".join(f"{v:.8f}f" for v in r) + " }")
    return (f"static const float {name}[{arr.shape[0]}][{arr.shape[1]}] = "
            "{\n" + ",\n".join(rows) + "\n};\n")


def export_policy_header(params: Any, path: str):
    """Write network.h-style C arrays (weights stored [out][in] like the
    reference's applyLayer expects)."""
    layers = _extract_mlp(params)
    (w1, b1), (w2, b2), (wo, bo) = layers
    with open(path, "w") as f:
        f.write("// Auto-generated policy weights (tanh MLP).\n")
        f.write(f"#define INPUT_SIZE {w1.shape[0]}\n")
        f.write(f"#define HIDDEN_LAYER_SIZE {w1.shape[1]}\n")
        f.write(f"#define OUTPUT_SIZE {wo.shape[1]}\n\n")
        f.write(_c_array("policyWeights1", w1.T))
        f.write(_c_array("policyBias1", b1))
        f.write(_c_array("policyWeights2", w2.T))
        f.write(_c_array("policyBias2", b2))
        f.write(_c_array("actionWeights", wo.T))
        f.write(_c_array("actionBias", bo))


def policy_forward_np(params: Any, obs: np.ndarray) -> np.ndarray:
    """NumPy mirror of the exported network (deterministic action = mean),
    for validating the export against `ActorCritic.apply`."""
    (w1, b1), (w2, b2), (wo, bo) = _extract_mlp(params)
    a = np.tanh(obs @ w1 + b1)
    a = np.tanh(a @ w2 + b2)
    return a @ wo + bo
