"""The port's weights as a flax variables tree, for the parity tests: the
inverse of ``veto_tpu_torch.utils.jax_weights.flax_to_state_dict``.

The tree's structure comes from ``jax.eval_shape`` of the JAX model's
``init_all``, which traces the model without compiling it: a few seconds
where a jitted ``init`` takes tens on the CPU.  Each leaf is the port
tensor of the same path, with the layout conversions undone (OIHW conv
weights → HWIO kernels, Linear weights → Dense kernels, transposed-convolution weights (I, O,
kh, kw) → flax ``ConvTranspose`` kernels (kh, kw, I, O) spatially
reversed)."""

import jax
import numpy as np

from veto_tpu_torch.utils.jax_weights import CONV_TRANSPOSE

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "mean": "running_mean", "var": "running_var"}


def flax_variables(jmodel, port_model, *init_args, method="init_all"):
    """``{"params": ..., "batch_stats": ...}`` of ``jmodel`` holding the
    weights of ``port_model`` (the same configuration), as numpy arrays;
    the tree is that of ``jmodel.init(*init_args, method=method)``."""
    shapes = jax.eval_shape(lambda *a: jmodel.init(*a, method=method), *init_args)
    sd = port_model.state_dict()

    def leaf(path, shape):
        _, *mod, name = [k.key for k in path]
        arr = sd[".".join(mod + [_LEAF.get(name, name)])].detach().numpy()
        if name == "kernel" and mod[-1] in CONV_TRANSPOSE:
            arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif name == "kernel":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        assert arr.shape == shape.shape, (path, arr.shape, shape.shape)
        return np.array(arr, np.float32, order="C")  # a copy, not a view of the port's

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))
