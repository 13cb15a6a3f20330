"""The Motifs converters of ``utils/torch_import.py`` against the JAX
package's (``lstm_cell_updates``, ``decoder_rnn_updates``,
``motifs_context_param_updates``, ``attribute_context_param_updates``), on
reference-format state dicts the test writes itself (seeded numpy tensors
under the reference's names, an SGCls context with its decoder and a
two-layer LSTM).  The JAX converters' trees, carried into torch names by
the weight bridge, and the port's converters give the same tensors under
the same names, and both load into the port's contexts with nothing left
over.  Exact: a conversion is renaming, transposing and summing two
biases.
"""

import numpy as np
import pytest
import torch

import veto_tpu.utils.torch_import as jti

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.models.relation.legacy import AttributeLSTMContext, LSTMContext
from veto_tpu_torch.utils import torch_import as tti
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

NO, NA, EMBED, HIDDEN, D = 11, 9, 16, 24, 20


def _lstm(rng, sd, name, d, layers):
    for layer in range(layers):
        for sfx in ("", "_reverse"):
            i = d if layer == 0 else 2 * HIDDEN
            sd[f"{name}.weight_ih_l{layer}{sfx}"] = rng.randn(4 * HIDDEN, i)
            sd[f"{name}.weight_hh_l{layer}{sfx}"] = rng.randn(4 * HIDDEN, HIDDEN)
            sd[f"{name}.bias_ih_l{layer}{sfx}"] = rng.randn(4 * HIDDEN)
            sd[f"{name}.bias_hh_l{layer}{sfx}"] = rng.randn(4 * HIDDEN)


def reference_state_dict(attributes: bool, layers: int = 2, seed: int = 0):
    """A reference (Attribute)LSTMContext state dict with its decoder, f32."""
    rng = np.random.RandomState(seed)
    sd = {}
    emb = 2 * EMBED if attributes else EMBED
    pre = D + emb + 128
    for name in ("obj_embed1", "obj_embed2"):
        sd[f"{name}.weight"] = rng.randn(NO, EMBED)
    if attributes:
        for name in ("att_embed1", "att_embed2"):
            sd[f"{name}.weight"] = rng.randn(NA, EMBED)
        pos = ((0, 9, 32), (3, 32, 128))
    else:
        pos = ((0, 9, 32), (2, 32, 128))
        for leaf in ("weight", "bias", "running_mean"):
            sd[f"pos_embed.1.{leaf}"] = rng.randn(32)
        sd["pos_embed.1.running_var"] = rng.uniform(0.5, 1.5, 32)
    for idx, i, o in pos:
        sd[f"pos_embed.{idx}.weight"] = rng.randn(o, i)
        sd[f"pos_embed.{idx}.bias"] = rng.randn(o)
    _lstm(rng, sd, "obj_ctx_rnn", pre, layers)
    _lstm(rng, sd, "edge_ctx_rnn", emb + D + HIDDEN, layers)
    dec = "decoder_rnn"
    sd[f"{dec}.obj_embed.weight"] = rng.randn(NO + 1, EMBED)
    sd[f"{dec}.input_linearity.weight"] = rng.randn(6 * HIDDEN, pre + HIDDEN + emb)
    sd[f"{dec}.input_linearity.bias"] = rng.randn(6 * HIDDEN)
    sd[f"{dec}.state_linearity.weight"] = rng.randn(5 * HIDDEN, HIDDEN)
    sd[f"{dec}.state_linearity.bias"] = rng.randn(5 * HIDDEN)
    sd[f"{dec}.out_obj.weight"] = rng.randn(NO, HIDDEN)
    sd[f"{dec}.out_obj.bias"] = rng.randn(NO)
    if attributes:
        sd[f"{dec}.att_embed.weight"] = rng.randn(NA, EMBED)
        sd[f"{dec}.out_att.weight"] = rng.randn(NA, HIDDEN)
        sd[f"{dec}.out_att.bias"] = rng.randn(NA)
    for name in ("lin_obj_h", "lin_edge_h"):
        sd[f"{name}.weight"] = rng.randn(HIDDEN, 2 * HIDDEN)
        sd[f"{name}.bias"] = rng.randn(HIDDEN)
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _jax_tree(updates):
    """(path tuple → array) updates as a nested params tree."""
    tree = {}
    for path, arr in updates.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return tree


def _same(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("attributes", (False, True))
def test_context_converters_match_jax(attributes):
    sd = {f"roi_heads.relation.predictor.context_layer.{k}": v
          for k, v in reference_state_dict(attributes).items()}
    src = "roi_heads.relation.predictor.context_layer"
    if attributes:
        jp, jstats = jti.attribute_context_param_updates(sd, src, 2, 2), {}
        got = tti.attribute_context_param_updates(sd, src, 2, 2)
        ctx = AttributeLSTMContext(NO, NA, EMBED, HIDDEN, D, 2, 2, mode="sgcls")
    else:
        jp, jstats = jti.motifs_context_param_updates(sd, src, 2, 2)
        got = tti.motifs_context_param_updates(sd, src, 2, 2)
        ctx = LSTMContext(NO, EMBED, HIDDEN, D, 2, 2, mode="sgcls")
    want = flax_to_state_dict({"params": _jax_tree(jp), "batch_stats": _jax_tree(jstats)})
    _same(got, want)
    missing, unexpected = ctx.load_state_dict(
        {k: torch.from_numpy(v) for k, v in got.items()}, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    prefixed = (tti.attribute_context_param_updates if attributes
                else tti.motifs_context_param_updates)(
        sd, src, 2, 2, dst_prefix="relation.context_layer")
    assert set(prefixed) == {f"relation.context_layer.{k}" for k in got}


def test_lstm_and_decoder_converters_match_jax():
    sd = reference_state_dict(attributes=True, layers=1, seed=1)
    jl = jti.lstm_cell_updates(sd, "obj_ctx_rnn", ("ctx",), 1)
    _same(tti.lstm_cell_updates(sd, "obj_ctx_rnn", "ctx", 1),
          flax_to_state_dict({"params": _jax_tree(jl)}))
    jd = jti.decoder_rnn_updates(sd, "decoder_rnn", ("dec",))
    got = tti.decoder_rnn_updates(sd, "decoder_rnn", "dec")
    want = flax_to_state_dict({"params": _jax_tree(jd)})
    assert {"dec.att_embed", "dec.att_out_w", "dec.att_out_b"} <= set(got)
    _same({k: v for k, v in got.items() if k in want}, want)
    # the JAX decoder converter leaves the attribute extras to the context's
    ja = jti.attribute_context_param_updates(sd, "", 1, 1)
    np.testing.assert_array_equal(got["dec.att_out_w"], ja[("decoder_rnn", "att_out_w")])
    # torch's two LSTM biases sum into the port's one
    np.testing.assert_array_equal(got["dec.input_b"], sd["decoder_rnn.input_linearity.bias"])
    lstm = tti.lstm_cell_updates(sd, "obj_ctx_rnn", "ctx", 1)
    np.testing.assert_array_equal(
        lstm["ctx.bwd0.bias"],
        sd["obj_ctx_rnn.bias_ih_l0_reverse"] + sd["obj_ctx_rnn.bias_hh_l0_reverse"])
