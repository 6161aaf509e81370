"""Weights for the port's parity tests from a numpy seed: the same draw in
every process.

The reference's ``init`` folds ``hash(name)`` into each child builder's
key (``repro.models.common.ParamBuilder.child``), so the weights it draws
change with Python's string-hash seed, and with them every greedy choice
a test compares. These helpers draw the tree both packages share from a
numpy generator instead: N(0, 1/fan_in) in the reference's tree, zero
norm scales. Module-level imports are numpy only.
"""
import numpy as np


def numpy_tree(spec, rng, unstack=False, norms=None):
    """Weights for a ``(shape, fan_in)`` spec tree (a ``param_shapes``):
    N(0, 1/fan_in); ones where fan_in is ``"ones"``; where it is None (the
    norm scales) zeros, or ``norms`` x N(0, 1) when ``norms`` is given.
    ``rng`` is a seed or a ``numpy.random.Generator`` (drawn in the tree's
    order); ``unstack`` drops the leading layer axis."""
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)

    def make(leaf):
        if isinstance(leaf, dict):
            return {k: make(v) for k, v in leaf.items()}
        shape, fan_in = leaf
        shape = tuple(shape[1:]) if unstack else tuple(shape)
        if fan_in is None:
            if norms is None:
                return np.zeros(shape, np.float32)
            return (norms * rng.standard_normal(shape)).astype(np.float32)
        if fan_in == "ones":
            return np.ones(shape, np.float32)
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return make(spec)


def model_tree(cfg, seed):
    """The numpy weights of the port's model for ``cfg`` (any family) in
    the reference's tree, padded query heads zeroed as both inits zero
    them."""
    from repro_torch.models import mamba2, transformer, whisper, xlstm
    module = {"ssm": xlstm, "hybrid": mamba2,
              "audio": whisper}.get(cfg.family, transformer)
    tree = numpy_tree(module.param_shapes(cfg), seed)
    mask = transformer.head_mask(cfg) if module is transformer else None
    if mask is not None:
        m = mask.numpy()
        tree["layers"]["attn"]["wq"][:, :, ~m] = 0
        tree["layers"]["attn"]["wo"][:, ~m] = 0
    return tree


def both_trees(cfg, seed):
    """(the reference's params, the port's on the host) of ``model_tree``:
    the same values, each package's own copy."""
    import jax
    import jax.numpy as jnp
    from repro_torch.bridge import params_from_numpy
    tree = model_tree(cfg, seed)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
