"""d3d12renderer_jax — a batched physics + rendering framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
pkurth/D3D12Renderer: batched rigid-body physics (6 collider types, sequential
impulse solver, 6 joint types with limits/motors, cloth, ragdolls, vehicles),
a physically based renderer with a path tracer, an SoA-pytree scene system,
and an on-device reinforcement-learning loop for ragdoll locomotion.

Everything carries a leading scene-batch axis; `parallel/` shards that axis over
a device mesh with `shard_map`.
"""

import os

__version__ = "0.1.0"

# <checkout>/.jax_cache: a fixed path, so a later run of the same program in
# the same checkout finds what an earlier one compiled.
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir():
    """Directory for JAX's persistent compilation cache, or None when
    JAX_COMPILATION_CACHE_DIR is set (JAX then reads it itself)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CHECKOUT_CACHE_DIR


def _enable_persistent_compilation_cache():
    """The analog of the reference's pipeline-state cache
    (dx_pipeline.cpp:412): repeat runs skip the multi-second compiles."""
    path = compile_cache_dir()
    if path is None:
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)


_enable_persistent_compilation_cache()
