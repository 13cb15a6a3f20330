"""Helpers of the detector-step parity tests: the JAX package's own draws
of ``make_detector_train_step``, its step compiled once with LLVM's
optimisations off, and an optimizer whose state keeps the step's raw
gradients."""

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from veto_tpu_torch.engine.pretrain import DetectorDraws


@jax.jit
def _split_keys(keys):
    return jax.vmap(jax.random.split)(keys)


def draws(keys, n):
    """``balanced_sample``'s two uniforms of each key: (B, n) each."""
    kp, kn = jnp.moveaxis(_split_keys(keys), 1, 0)
    uniform = jax.vmap(lambda k: jax.random.uniform(k, (n,)))
    return (torch.from_numpy(np.array(uniform(kp))),
            torch.from_numpy(np.array(uniform(kn))))


def jax_draws(rng, b, num_anchors, num_props):
    """The step's uniforms as ``make_detector_train_step`` derives them
    (``veto_tpu/engine/pretrain.py:61-64`` and ``balanced_sample``)."""
    step_rng = jax.random.fold_in(rng, 0)
    out = []
    for stream, n in ((0, num_anchors), (1, num_props)):
        out += draws(jax.random.split(jax.random.fold_in(step_rng, stream), b), n)
    return DetectorDraws(*out)


def compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with the CPU backend's LLVM
    optimisations off: the same XLA program (fusions and all), compiled in
    half the time."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def keep_grads(inner):
    """``inner`` (an ``inject_hyperparams`` optimizer) whose state also
    keeps the step's raw gradients, so one jitted train step gives the
    losses, the gradients and the update."""
    class State(tuple):
        hyperparams = property(lambda self: self[0].hyperparams)

    jax.tree_util.register_pytree_node(
        State, lambda s: (tuple(s), None), lambda _, c: State(c))

    def init(params):
        return State((inner.init(params), jax.tree.map(jnp.zeros_like, params)))

    def update(grads, state, params=None):
        upd, s = inner.update(grads, state[0], params)
        return upd, State((s, grads))

    return optax.GradientTransformation(init, update)


def run_jax_detector_step(jm, variables, tx, jbatch, rng, lr_scale, **step_kw):
    """One ``make_detector_train_step(jm, tx, **step_kw)`` from ``variables``
    with ``tx`` (a :func:`keep_grads` optimizer), compiled once.  Returns
    its metrics, raw gradients and updated parameters (numpy trees) and the
    proposals of its selection, recorded by a debug callback in the JAX
    package's ``rpn_select_proposals`` (one call an image, in order) as
    (boxes, mask, objectness) tensors (B, P, ...)."""
    from veto_tpu.engine import pretrain as jpretrain
    from veto_tpu.engine.train import TrainState as JTrainState

    params = variables["params"]
    state = JTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                        batch_stats=variables["batch_stats"],
                        opt_state=jax.jit(tx.init)(params), rng=rng)
    seen = []
    select = jpretrain.rpn_select_proposals

    def recorded(*args):
        out = select(*args)
        jax.debug.callback(lambda *x: seen.append([np.asarray(a) for a in x]),
                           *out, ordered=True)
        return out

    jpretrain.rpn_select_proposals = recorded
    try:
        step = jpretrain.make_detector_train_step(jm, tx, **step_kw)
        args = (state, jbatch, jnp.asarray(lr_scale, jnp.float32))
        new, metrics = compiled(step, *args)(*args)
        jax.block_until_ready(metrics)
    finally:
        jpretrain.rpn_select_proposals = select
    proposals = tuple(torch.from_numpy(np.stack([s[i] for s in seen]))
                      for i in range(3))
    return (jax.tree.map(np.asarray, metrics), jax.tree.map(np.asarray, new.opt_state[1]),
            jax.tree.map(np.asarray, new.params), proposals)
