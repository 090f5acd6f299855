"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

Weights are made once by the JAX package, perturbed with numpy where its
init leaves a path dormant (noise buffers and gains, activation and ToRGB
biases start at zero), and handed to both packages: JAX keeps its tree, the
port loads it through ``where2edit_tpu_torch.convert``. Inputs come from a
numpy seed and cross as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from where2edit_tpu_torch import convert


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def perturb(tree, rng, scale: float = 0.3):
    """Randomise the leaves that a fresh init leaves at zero: NoiseInjection
    gains, activation biases, ToRGB biases and noise buffers."""
    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, path + (k,)) for k, v in node.items()}
        name = path[-1]
        parent = path[-2] if len(path) > 1 else ""
        if (name == "activate_bias" or path[0] == "noises"
                or (parent == "noise" and name == "weight")
                or (name == "bias" and parent.startswith("to_rgb"))):
            return (rng.standard_normal(node.shape) * scale).astype(np.float32)
        return node
    return visit(tree, ())


def jax_generator(size: int, seed: int = 0):
    """(flax Generator, perturbed numpy variables)."""
    from where2edit_tpu.models.stylegan2 import Generator  # noqa: PLC0415

    gen = Generator(size=size)
    key = jax.random.PRNGKey(seed)
    variables = jax.jit(lambda: gen.init({"params": key, "noise": key},
                                         [jnp.zeros((1, 512))]))()
    variables = {k: dict(v) for k, v in np_tree(variables).items()}
    return gen, perturb(variables, np.random.default_rng(seed))


def torch_generator(np_vars, size: int):
    from where2edit_tpu_torch.models.stylegan2 import Generator  # noqa: PLC0415

    gen = Generator(size)
    convert.load_converted(gen, convert.generator_state_dict(np_vars, size))
    return gen.eval()


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want, tol: float):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)
