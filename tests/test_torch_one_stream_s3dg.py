"""``model_type: 1stream`` finetune on S3D-G, the port against the JAX
package, f64 on the CPU: two classifier steps from one merged state
(tests/test_torch_one_stream.py's ``one_stream_steps``), the JAX step's
dropout masks injected into the port's, in its own file for the time
budget.
"""
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_one_stream import one_stream_steps
from tests.test_torch_zoo import release_jax_memory  # noqa: F401

torch.set_num_threads(1)


def _s3dg_dropout_masks(jm):
    """The mask of the JAX step's dropout: the step draws it from its key
    (``rngs={"dropout": key}``) in the module ``dropout``, so that module
    alone, applied to ones with the same key, draws the same mask."""
    def masks(state, clips, key):
        ones = jnp.ones((clips.shape[0], jm.feature_dim))
        kept = jm.apply({"params": state.params}, ones,
                        method=lambda m, f: m.dropout(f, deterministic=False),
                        rngs={"dropout": key})
        return torch.from_numpy(np.asarray(kept) != 0)
    return masks


def test_s3dg_one_stream_steps_match_jax():
    # a small step: at test widths S3D-G's last BN sees 4 values per
    # channel and amplifies f64 rounding in the gradient about 1e4-fold
    # (tests/test_torch_s3dg.py), and the second step starts from weights
    # that carry the first one's
    net = one_stream_steps("s3dg", dropout_masks=_s3dg_dropout_masks,
                           lr=0.005)
    assert net.fc is not None and net.drop_prob == 0.5
