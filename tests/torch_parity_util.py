"""Helpers shared by the tests that hold sdflabel_tpu_torch against
sdflabel_tpu: both packages take the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np


def jax_tree_to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def jax_ransac_ranks(key, num_valid: int, num_hypotheses: int = 567,
                     sample_size: int = 4) -> np.ndarray:
    """The (H, S) ranks sdflabel_tpu.ops.ransac.ransac_pose draws from
    `key` (its draw_distinct, ransac.py:141-155) for `num_valid` valid
    scene points."""
    v = jnp.int32(num_valid)

    def draw_distinct(k):
        ks = jax.random.split(k, sample_size)
        chosen = []
        for j in range(sample_size):
            r = jax.random.randint(ks[j], (), 0, jnp.maximum(v - j, 1))
            if chosen:
                prev = jnp.sort(jnp.stack(chosen))
                for t in range(j):
                    r = r + (r >= prev[t])
            chosen.append(r)
        return jnp.stack(chosen)

    return np.array(jax.vmap(draw_distinct)(
        jax.random.split(key, num_hypotheses)))


class JaxRankSource:
    """Stands in for RefineRuntime.ransac_ranks: the ranks the JAX
    runtime draws, call after call (its key sequence from rng_seed)."""

    def __init__(self, rng_seed: int = 1, num_hypotheses: int = 567):
        self.key = jax.random.PRNGKey(rng_seed)
        self.num_hypotheses = num_hypotheses

    def __call__(self, num_valid: int):
        import torch

        self.key, sub = jax.random.split(self.key)
        return torch.as_tensor(jax_ransac_ranks(sub, num_valid,
                                                self.num_hypotheses))
