"""Flax models on the JAX side of the port's parity tests, built without
running them op by op.

Run eagerly, flax dispatches a network one primitive at a time, and on a
full backbone that is most of a test's time. ``init`` and ``jit_apply``
compile each network once and run it as one program. ``np_tree`` moves a
variable tree to float64 numpy, where per-leaf set-up (casts,
perturbations) runs without compiling an XLA program per op and leaf
shape.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

KEY = jax.random.PRNGKey(0)


def init(model, shape):
    """``model.init`` on float32 zeros of ``shape`` (``train=False``),
    jitted."""
    return jax.jit(functools.partial(model.init, train=False))(
        {"params": KEY}, jnp.zeros(shape, jnp.float32))


def jit_apply(model, method=None, train=False, **kwargs):
    """``model.apply(variables, *args, method=, train=, **kwargs)``, jitted.

    ``kwargs`` (``mutable=``, ...) are fixed at build time."""
    return jax.jit(functools.partial(model.apply, method=method, train=train,
                                     **kwargs))


def np_tree(tree):
    """``tree`` with every leaf a float64 numpy array."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
