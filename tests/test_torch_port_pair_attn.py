"""Port parity for the encoder's ``pair_attn`` path: the pair-attention
function (B4a/B4b), ``VetoEncoder._xla_layer`` (``xla`` and ``pair_attn``)
through the trunk, the whole PredCls eval and train step with
``pair_attn``, and ``build_model``'s choice of encoder.

The JAX side runs ``veto_tpu.ops.pair_attention`` in the Pallas interpreter
(and the fused encoder's, where its model init needs it) and differentiates
with ``jax.grad``; the port runs the plain versions of its kernels on the
CPU, through the same ``torch.autograd.Function``s as on the card.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import veto_tpu.ops.fused_encoder as jfe
import veto_tpu.ops.pair_attention as jpa
from veto_tpu.engine.batch import SGGBatch as JBatch
from veto_tpu.models.relation.predictor_veto import VetoTrunk as JTrunk
from veto_tpu.models.relation.predictor_veto import weighted_ce_loss as j_wce
from veto_tpu.models.relation.sampling import gtbox_relsample as j_relsample
from veto_tpu.models.sgg import SGGModel as JModel

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.config import load_config
from veto_tpu_torch.data.predicate_stats import predicate_counts
from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
from veto_tpu_torch.engine.train import create_train_state, forward_backward
from veto_tpu_torch.models.relation.predictor_veto import (
    VetoTrunk, beta_class_weights,
)
from veto_tpu_torch.models.relation.sampling import RelSample
from veto_tpu_torch.models.sgg import SGGModel, build_model
from veto_tpu_torch.ops import fused_encoder as tfe
from veto_tpu_torch.ops import pair_attention as tpa
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, D, H = 19, 96, 6
NUM_OBJ, NUM_REL = 11, 7
MAX_BOXES, PAIRS = 8, 16
SMALL = dict(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
             stage_blocks=(1, 1, 1, 1), groups=4, width_per_group=4,
             fpn_channels=32, veto_dim=96, veto_layers=2, veto_heads=6,
             veto_depth_proj_dim=32, veto_visual_proj_dim=16, embed_dim=200,
             fold_bn=True)


@pytest.fixture
def interpret():
    jpa.INTERPRET = jfe.INTERPRET = True
    yield
    jpa.INTERPRET = jfe.INTERPRET = False


def _assert_scaled(got, ref, tol, what):
    """|got - ref| <= tol * max|ref|."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = float(np.abs(ref).max())
    assert scale > 0, what
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol, rtol=0,
                               err_msg=what)


# --------------------------------------------------------- pair attention
def _qkvw(seed, p, t=T, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(p, t, D) * scale).astype(np.float32) for _ in range(4)]


def _jax_attention_and_grads(q, k, v, w, dtype=jnp.float32):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]

    def loss(a, b, c):
        out = jpa.pair_attention(a, b, c, heads=H)
        return (out.astype(jnp.float32) * jnp.asarray(w)).sum()

    out = jpa.pair_attention(*args, heads=H)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(a.astype(jnp.float32)) for a in (out, *grads)]


def _port_attention_and_grads(q, k, v, w, dtype=torch.float32, t_valid=None):
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v))
    out = tpa.pair_attention(tq, tk, tv, H, t_valid=t_valid)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out, (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("pairs", [16, 13])  # 13: _choose_block cuts to 1
def test_pair_attention_matches_jax_f32(interpret, pairs):
    q, k, v, w = _qkvw(0, pairs)
    ref = _jax_attention_and_grads(q, k, v, w)
    out, grads = _port_attention_and_grads(q, k, v, w)
    assert out.shape == (pairs, T, D) and out.dtype == torch.float32
    # the JAX kernel test's own tolerance (tests/test_fused_encoder.py):
    # f32 sums in another order
    for name, got, r in zip(("out", "dq", "dk", "dv"), (out, *grads), ref):
        np.testing.assert_allclose(got.detach().numpy(), r, atol=2e-6, rtol=0,
                                   err_msg=name)


def test_pair_attention_matches_jax_bf16(interpret):
    """bf16 q, k, v: both round the probabilities, bf16(ds * scale) and each
    output at the same points; an f32 sum in another order can flip one
    rounding, one bf16 ulp (2^-8 relative) of that value."""
    q, k, v, w = _qkvw(1, 16)
    bq, bk, bv = (torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v))
    ref = _jax_attention_and_grads(bq, bk, bv, w, jnp.bfloat16)
    out, grads = _port_attention_and_grads(bq, bk, bv, w, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    for name, got, r in zip(("out", "dq", "dk", "dv"), (out, *grads), ref):
        got = got.detach().float().numpy()
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(got, r, atol=1e-2 * scale, rtol=0, err_msg=name)
        assert np.abs(got - r).mean() < 1e-3 * scale, name


def test_pair_attention_masks_padded_keys(interpret):
    """T = 24 tokens of which 19 are real (the port masks keys >= t_valid
    and needs no padding): the real queries' outputs and gradients are
    JAX's on the 19 real tokens, the padded keys get no gradient."""
    q, k, v, w = _qkvw(2, 8)
    pad = [np.concatenate([a, np.random.RandomState(3).randn(8, 5, D)
                           .astype(np.float32)], 1) for a in (q, k, v, w)]
    ref = _jax_attention_and_grads(q, k, v, w)
    pad[3][:, T:] = 0.0  # padded queries' outputs are not used
    out, grads = _port_attention_and_grads(*pad, t_valid=T)
    np.testing.assert_allclose(out[:, :T].detach().numpy(), ref[0], atol=2e-6)
    for got, r in zip(grads, ref[1:]):
        np.testing.assert_allclose(got[:, :T].numpy(), r, atol=2e-6)
    for g in grads[1:]:  # dk, dv of the padded keys
        assert float(g[:, T:].abs().max()) == 0.0


def test_pair_attention_packed_form_matches(interpret):
    """``pair_attention_qkv`` on the packed qkv is ``pair_attention`` of its
    thirds, bit for bit, and its gradient comes back packed."""
    q, k, v, w = _qkvw(4, 8)
    out, grads = _port_attention_and_grads(q, k, v, w)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).requires_grad_()
    packed = tpa.pair_attention_qkv(qkv, H)
    (packed * torch.from_numpy(w)).sum().backward()
    assert torch.equal(packed, out)
    assert qkv.grad.shape == (8, T, 3 * D)
    assert torch.equal(qkv.grad, torch.cat(grads, -1))


def test_pair_attention_oracle_matches_jax():
    q, k, v, _ = _qkvw(5, 4)
    ref = jpa.pair_attention_reference(*map(jnp.asarray, (q, k, v)), heads=H)
    got = tpa.pair_attention_reference(*map(torch.from_numpy, (q, k, v)), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)
    # the plain kernel version without rounding (f32) is the oracle
    plain = tpa.reference_pair_attention_forward(
        *map(torch.from_numpy, (q, k, v)), H, T)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), atol=2e-6)


def test_pair_attention_kernel_refuses_what_it_cannot_take():
    """The raw launches raise before they reach the card on inputs the
    kernels do not take: f32, q, k, v that are not the thirds of one packed
    qkv (mixed row strides), a head split that does not divide D, tensors
    that are not on a CUDA device."""
    x = torch.zeros(4, T, D, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        tpa._launch_forward(x.float(), x.float(), x.float(), H, T)
    packed = torch.zeros(4, T, 3 * D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="row stride"):
        tpa._launch_forward(packed[..., :D], x, x, H, T)
    with pytest.raises(ValueError, match="strides"):
        tpa._launch_forward(x.transpose(0, 1).contiguous().transpose(0, 1),
                            x, x, H, T)
    with pytest.raises(ValueError, match="heads"):
        tpa._launch_forward(x, x, x, 7, T)
    with pytest.raises(TypeError, match="CUDA"):
        tpa._launch_forward(*packed.chunk(3, dim=-1), H, T)
    with pytest.raises(ValueError, match="t_valid"):
        tpa.pair_attention(x, x, x, H, t_valid=T + 1)


# ------------------------------------------------------------------ trunk
def _trunk_inputs(seed, b=2, n=5, p=8, c=16):
    rng = np.random.RandomState(seed)
    boxes = np.sort(rng.uniform(0, 90, (b, n, 2, 2)), 2)  # x1 < x2, y1 < y2
    return dict(
        boxes=boxes.reshape(b, n, 4).astype(np.float32),
        box_mask=np.array([[1] * n, [1] * (n - 1) + [0]], bool)[:b],
        obj_labels=rng.randint(1, 11, (b, n)).astype(np.int32),
        pair_idx=rng.randint(0, n - 1, (b, p, 2)).astype(np.int32),
        roi_features=rng.randn(b, n, 8, 8, c).astype(np.float32),
        depth_features=rng.randn(b, n, 8, 8, c).astype(np.float32),
    )


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("impl", ["xla", "pair_attn"])
def test_trunk_matches_jax(interpret, impl, train):
    """The port's VetoTrunk against the JAX one with the same parameters
    (through the weight bridge), both running ``_xla_layer``: f32 forward
    and the gradient of a scalar loss w.r.t. every encoder parameter."""
    kw = dict(num_obj_classes=11, embed_dim=16, dim=D, layers=2, heads=H,
              depth_proj_dim=64, visual_proj_dim=32)
    inp = _trunk_inputs(6)
    jt = JTrunk(**kw, mode="predcls", dtype=jnp.float32, remat=False,
                encoder_impl=impl)
    jargs = {k: jnp.asarray(v) for k, v in inp.items()}
    jargs.update(obj_logits=jnp.zeros((2, 5, 11)),
                 pair_mask=jnp.ones((2, 8), bool))
    variables = jax.tree.map(np.asarray, jt.clone(encoder_impl="xla").init(
        jax.random.PRNGKey(0), **jargs, train=False))
    rng = np.random.RandomState(7)
    # non-trivial LN affines and biases (init leaves 1 and 0)
    enc = variables["params"]["fusion_transformer"]
    for name in list(enc):
        if name.endswith(("_scale", "_bias")):
            enc[name] = (enc[name] + rng.randn(*enc[name].shape) * 0.1).astype(np.float32)
    w = rng.randn(2, 8, D).astype(np.float32)

    def jloss(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        if train:
            out, _ = jt.apply(v, **jargs, train=True, mutable=["batch_stats"])
        else:
            out = jt.apply(v, **jargs, train=False)
        return (out * jnp.asarray(w)).sum(), out

    (_, ref), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    jg = flax_to_state_dict({"params": jax.tree.map(np.asarray, jg)})

    trunk = VetoTrunk(**kw, rgb_channels=16, depth_channels=16,
                      dtype=torch.float32, encoder_impl=impl)
    trunk.load_state_dict(flax_to_state_dict(variables), strict=True)
    trunk.train(train)
    out = trunk(*(torch.from_numpy(inp[k]) for k in (
        "boxes", "box_mask", "obj_labels", "pair_idx", "roi_features",
        "depth_features")))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-4,
                               rtol=0)
    enc_params = [(n, p) for n, p in trunk.named_parameters()
                  if n.startswith("fusion_transformer.")]
    assert len(enc_params) == 2 + 2 * 11
    for n, p in enc_params:
        # f32 through two layers: summation order only
        _assert_scaled(p.grad, jg[n].numpy(), 1e-4, n)


# ------------------------------------------------------------ whole model
@pytest.fixture(scope="module")
def small_model_pair_attn():
    """The small JAX model with ``pair_attn``, its perturbed variables and a
    synthetic batch of 2 images."""
    ds = SyntheticSGGDataset(num_images=2, image_size=(64, 96),
                             num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
                             max_objects=6, min_objects=4, max_relations=6,
                             seed=11)
    batch, _ = next(ds.batches(2, MAX_BOXES))
    jbatch = JBatch(**{k: jnp.asarray(v) for k, v in batch.fields().items()})
    jm = JModel(mode="predcls", **SMALL, dtype=jnp.float32,
                veto_encoder_impl="pair_attn", pooler_impl="separable",
                veto_remat=False)
    init = jax.jit(functools.partial(jm.clone(veto_encoder_impl="xla").init,
                                     train=False))
    variables = jax.tree.map(np.asarray, init(
        jax.random.PRNGKey(0), jbatch.images, jbatch.depth, jbatch.boxes,
        jbatch.box_mask, jbatch.labels, jbatch.obj_logits,
        jnp.zeros((2, PAIRS, 2), jnp.int32), jnp.ones((2, PAIRS), bool)))
    rng = np.random.RandomState(0)
    stats = jax.tree.map(lambda v: (rng.uniform(0.5, 1.5, v.shape) if v.ndim
                                    else v).astype(np.float32),
                         variables["batch_stats"])
    return jm, {"params": variables["params"], "batch_stats": stats}, batch, jbatch


def _port_model(variables):
    model = SGGModel(**SMALL, dtype=torch.float32, veto_encoder_impl="pair_attn")
    load_flax_variables(model, variables)
    assert model.relation.trunk.fusion_transformer.impl == "pair_attn"
    return model


def test_eval_rel_logits_pair_attn_match_jax(interpret, small_model_pair_attn):
    jm, variables, batch, jbatch = small_model_pair_attn
    rng = np.random.RandomState(8)
    pair_idx = rng.randint(0, 4, (2, PAIRS, 2)).astype(np.int32)
    pair_mask = np.ones((2, PAIRS), bool)
    ref = jax.jit(functools.partial(jm.apply, train=False))(
        variables, jbatch.images, jbatch.depth, jbatch.boxes, jbatch.box_mask,
        jbatch.labels, jbatch.obj_logits, jnp.asarray(pair_idx),
        jnp.asarray(pair_mask))
    model = _port_model(variables).eval()
    tb = batch.to("cpu")
    calls = []
    plain = tpa.reference_pair_attention_forward
    tpa.reference_pair_attention_forward = lambda *a: calls.append(1) or plain(*a)
    try:
        with torch.no_grad():
            got = model(tb.images, tb.depth, tb.boxes, tb.box_mask, tb.labels,
                        tb.obj_logits, torch.from_numpy(pair_idx),
                        torch.from_numpy(pair_mask))
    finally:
        tpa.reference_pair_attention_forward = plain
    assert len(calls) == SMALL["veto_layers"]
    # f32 through the frozen body, the pooler and two layers: summation order
    np.testing.assert_allclose(got.rel_logits.numpy(), np.asarray(ref.rel_logits),
                               atol=1e-4, rtol=1e-5)


def test_train_step_pair_attn_matches_jax(interpret, small_model_pair_attn):
    """One train step's loss and gradients with ``pair_attn``, on the same
    samples, against ``jax.grad`` of the JAX model's loss."""
    jm, variables, batch, jbatch = small_model_pair_attn
    params, stats = variables["params"], variables["batch_stats"]
    cw = beta_class_weights(predicate_counts("VG")[:NUM_REL])
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    js = jax.vmap(lambda kk, r, m: j_relsample(
        kk, r, m, batch_size=PAIRS, positive_fraction=0.25))(
        keys, jbatch.rel_matrix, jbatch.box_mask)

    def jloss(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, jbatch.images,
                          jbatch.depth, jbatch.boxes, jbatch.box_mask,
                          jbatch.labels, jbatch.obj_logits, js.pair_idx,
                          js.mask, train=True, mutable=["batch_stats"])
        return j_wce(out.rel_logits, js.labels, js.mask, jnp.asarray(cw))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    ref = flax_to_state_dict({"params": jax.tree.map(np.asarray, jg)})

    model = _port_model(variables)
    state = create_train_state(model, load_config(
        os.path.join(REPO, "configs", "veto_vg_predcls.yaml")).solver, cw)
    samples = RelSample(*(torch.from_numpy(np.array(a))
                          for a in (js.pair_idx, js.labels, js.mask)))
    before = tpa.BWD_LAUNCHES, tfe.FFN_BWD_LAUNCHES, tfe.MONO_BWD_LAUNCHES
    loss = forward_backward(state, batch.to("cpu"), samples)["loss"]
    # the CPU runs the plain versions: no kernel launch is counted
    assert (tpa.BWD_LAUNCHES, tfe.FFN_BWD_LAUNCHES, tfe.MONO_BWD_LAUNCHES) == before
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    assert {n.split(".")[0] for n, _ in trained} == {"depth_backbone", "relation"}
    for n, p in trained:
        # f32 through the frozen body, the pooler, two layers and back
        _assert_scaled(p.grad, ref[n].numpy(), 1e-4, n)


# ------------------------------------------------------------ build_model
def _small_cfg(impl):
    return load_config(os.path.join(REPO, "configs", "veto_vg_predcls.yaml"), [
        "model.stage_blocks=(1,1,1,1)", "veto.t_input_dim=96",
        "veto.enc_layers=2", f"veto.encoder_impl={impl}", "dtype=float32"])


@pytest.mark.parametrize("impl, want", [("auto", "fused"), ("fused", "fused"),
                                        ("pair_attn", "pair_attn"), ("xla", "xla")])
def test_build_model_honours_encoder_impl(impl, want):
    """Each ``veto.encoder_impl`` builds the encoder it names, and that
    encoder runs its own path: the fused layer's plain version for
    ``fused``, the pair-attention plain version for ``pair_attn``, neither
    for ``xla``."""
    model = build_model(_small_cfg(impl), "cpu")
    enc = model.relation.trunk.fusion_transformer
    assert enc.impl == want
    calls = {"fused": 0, "pair_attn": 0}
    spied = [(tfe, "_reference_forward", "fused"),
             (tpa, "reference_pair_attention_forward", "pair_attn")]
    saved = [getattr(mod, name) for mod, name, _ in spied]

    def spy(fn, key):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    for (mod, name, key), fn in zip(spied, saved):
        setattr(mod, name, spy(fn, key))
    try:
        rng = np.random.RandomState(10)
        tokens = torch.from_numpy(rng.randn(4, 16, 96).astype(np.float32))
        loc, cls = (torch.from_numpy(rng.randn(4, 96).astype(np.float32))
                    for _ in range(2))
        with torch.no_grad():
            out = enc(tokens, loc, cls)
    finally:
        for (mod, name, _), fn in zip(spied, saved):
            setattr(mod, name, fn)
    assert out.shape == (4, 96) and torch.isfinite(out).all()
    layers = 2
    assert calls == {"fused": layers if want == "fused" else 0,
                     "pair_attn": layers if want == "pair_attn" else 0}


def test_build_model_rejects_an_unknown_encoder_impl():
    """A typo raises instead of running another encoder than the one named."""
    with pytest.raises(ValueError, match="encoder_impl"):
        build_model(_small_cfg("bogus"), "cpu")


def test_pair_attn_model_loads_the_same_weights(small_model_pair_attn):
    """Every encoder implementation has the same parameter tree, so the
    bridge loads one set of JAX variables into each, strictly."""
    _, variables, _, _ = small_model_pair_attn
    sd = flax_to_state_dict(variables)
    names = None
    for impl in ("fused", "pair_attn", "xla"):
        model = SGGModel(**SMALL, dtype=torch.float32, veto_encoder_impl=impl)
        load_flax_variables(model, variables)
        keys = set(model.state_dict())
        names = keys if names is None else names
        assert keys == names, impl
        enc = "relation.trunk.fusion_transformer.attn0_qkv"
        assert torch.equal(model.state_dict()[enc], sd[enc])
