"""The port's int8 weights (``ops/quant.py``: ``quantize_int8``,
``quantize_tree``, ``resolve_weight``, ``quantized_bytes``) against the
JAX package's.

- ``quantize_int8`` of a port ``Linear.weight`` (out, in) equals the
  JAX package's of W (in, out), bit for bit after the transpose (f32 and
  bf16 weights, an all-zero channel); an ``Embedding`` table keeps the
  JAX layout and its per-column scales.
- ``dequantize`` multiplies in the model dtype: the port's bf16 weight
  equals the JAX package's ``dequantize(..., bfloat16)`` transposed, bit
  for bit.
- ``quantize_tree`` of a port model equals ``convert.from_jax_params`` of
  the JAX package's ``quantize_tree`` of the same weights; ``convert``
  carries a quantized JAX tree both ways unchanged; small matrices,
  biases and LayerNorms pass through, as in JAX.
- Logits of the quantized port model against the quantized JAX model:
  float32 atol 1e-5 (learned positions, rope + tied embeddings, GQA);
  bf16 within 4 bf16 ulps of the largest logit (|diff| <= 2^-6 x
  max|logit|: the two packages round bf16 activations in other places,
  the int8 weights themselves are bit-identical).
- ``quantized_bytes`` equals the JAX package's and is below half the
  float model's; the quantized model serves through ``generate()`` and
  ``InferenceEngine.submit()`` (contiguous and paged) with the JAX
  package's greedy tokens.

Serial run time ~35 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, jax_and_port_lm, to_np
from distributed_pytorch_tpu import models as jmodels
from distributed_pytorch_tpu.models.generate import generate as jgenerate
from distributed_pytorch_tpu.ops import quant as jquant
from distributed_pytorch_tpu_torch import (TransformerLM, from_jax_params,
                                           generate, to_jax_params)
from distributed_pytorch_tpu_torch.nn.core import Embedding, Linear
from distributed_pytorch_tpu_torch.ops import quant
from distributed_pytorch_tpu_torch.serve import (EngineConfig,
                                                 InferenceEngine,
                                                 SamplingParams)

MODELS = {"learned": dict(pos="learned"),
          "rope_tied_gqa": dict(pos="rope", tie_embeddings=True),
          "mha": dict(n_kv_heads=4)}


def _np_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_bitwise_after_the_transpose(dtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((48, 80)) * np.exp(rng.standard_normal(80))
         ).astype(np.float32)
    w[:, 7] = 0.0                                  # an all-zero channel
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).to(getattr(torch,
                                                                dtype))
    jq, js = jquant.quantize_int8(jw)              # JAX W (in, out)
    q, s = quant.quantize_int8(tw)                 # port W (out, in)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # Embedding (vocab, dim): the same layout, scales per dim column
    eq, es = quant.quantize_int8(torch.from_numpy(w).to(tw.dtype), axis=-2)
    jeq, jes = jquant.quantize_int8(jnp.asarray(w).astype(dtype))
    np.testing.assert_array_equal(eq.numpy(), np.asarray(jeq))
    np.testing.assert_array_equal(es.numpy(), np.asarray(jes))
    # dequantize multiplies in the model dtype, as the JAX package does
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = quant.dequantize(q, s, dt)
        want = jquant.dequantize(jq, js, jdt).astype(jnp.float32)
        np.testing.assert_array_equal(got.float().numpy().T,
                                      np.asarray(want))
    # within scale/2, up to the float32 rounding of the scale and of the
    # product (127 x 2^-21 of scale/2; bf16 weights hit exact ties)
    err = (quant.dequantize(q, s, torch.float32)
           - tw.float()).abs()
    assert (err <= s[:, None] / 2 * (1 + 127 * 2.0 ** -21)).all()


def test_quantize_tree_equals_convert_of_the_jax_tree():
    """The port's module transform and the JAX tree transform give the
    same int8 weights and scales; convert carries the JAX tree both
    ways unchanged; small and 1-D tensors pass through."""
    jm, params, pm = jax_and_port_lm(seed=1, dim=64, **MODELS["learned"])
    qp = jquant.quantize_tree(params, min_size=1024)
    quant.quantize_tree(pm, min_size=1024)
    _, _, pm2 = jax_and_port_lm(seed=1, dim=64, **MODELS["learned"])
    from_jax_params(_np_tree(qp), pm2)
    for (n1, a), (n2, b) in zip(pm.named_buffers(), pm2.named_buffers()):
        assert n1 == n2 and torch.equal(a, b), n1
    for (n1, a), (n2, b) in zip(pm.named_parameters(),
                                pm2.named_parameters()):
        assert n1 == n2 and torch.equal(a, b), n1
    back = _flat(to_jax_params(pm))
    want = _flat(_np_tree(qp))
    assert sorted(back) == sorted(want)
    for k in want:
        assert back[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    # eligible: ndim >= 2 and >= min_size elements (pos is 128 x 64)
    assert quant.is_quantized(pm.tok) and quant.is_quantized(pm.pos)
    assert quant.is_quantized(pm.blocks[0].attn.qkv)
    assert pm.blocks[0].attn.qkv.bias is not None
    assert not quant.is_quantized(pm.blocks[0].ln1)
    small = Linear(16, 16, device=CPU)
    quant.quantize_tree(small, min_size=1024)
    assert small.weight is not None and not hasattr(small, "weight_q")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_quantized_logits_match_jax_f32(name):
    jm, params, pm = jax_and_port_lm(seed=2, dim=64, **MODELS[name])
    qp = jquant.quantize_tree(params, min_size=512)
    from_jax_params(_np_tree(qp), pm)
    toks = np.random.default_rng(3).integers(0, 61, (2, 24)).astype(np.int32)
    want = np.asarray(jm.apply(qp, jnp.asarray(toks)))
    with torch.no_grad():
        got = pm(torch.from_numpy(toks))
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5, atol=1e-5)
    # the port's own transform of the float weights gives the same model
    _, _, pm2 = jax_and_port_lm(seed=2, dim=64, **MODELS[name])
    with torch.no_grad():
        assert torch.equal(quant.quantize_tree(pm2, min_size=512)(
            torch.from_numpy(toks)), got)
    assert quant.quantized_bytes(pm) == jquant.quantized_bytes(qp)
    assert quant.quantized_bytes(pm) < 0.5 * jquant.quantized_bytes(params)


def test_quantized_logits_match_jax_bf16():
    kw = dict(vocab=61, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
              pos="learned", max_seq=128)
    jm = jmodels.TransformerLM(dtype=jnp.bfloat16, **kw)
    params = jm.init(jax.random.PRNGKey(4))
    qp = jquant.quantize_tree(params, min_size=512)
    pm = TransformerLM(dtype=torch.bfloat16, device=CPU, **kw)
    from_jax_params(_np_tree(qp), pm)
    # the dequantized bf16 weights are the JAX package's, bit for bit
    w = jquant.dequantize(qp["blocks"][0]["fc1"]["w_q"],
                          qp["blocks"][0]["fc1"]["w_scale"], jnp.bfloat16)
    np.testing.assert_array_equal(
        quant.resolve_weight(pm.blocks[0].fc1).float().numpy().T,
        np.asarray(w.astype(jnp.float32)))
    toks = np.random.default_rng(5).integers(0, 61, (2, 24)).astype(np.int32)
    want = np.asarray(jm.apply(qp, jnp.asarray(toks)).astype(jnp.float32))
    with torch.no_grad():
        got = to_np(pm(torch.from_numpy(toks)))
    tol = 2.0 ** -6 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)
    assert quant.quantized_bytes(pm) == jquant.quantized_bytes(qp)


def test_quantized_model_serves_the_jax_greedy_tokens():
    jm, params, pm = jax_and_port_lm(seed=6, dim=64)
    qp = jquant.quantize_tree(params, min_size=512)
    from_jax_params(_np_tree(qp), pm)
    prompts = [np.random.default_rng(i).integers(0, 61, n).astype(np.int32)
               for i, n in enumerate((5, 13, 9))]
    n = 10
    refs = [np.asarray(jgenerate(jm, qp, jnp.asarray(p[None]), n)[0])
            for p in prompts]
    for p, ref in zip(prompts, refs):
        np.testing.assert_array_equal(generate(pm, p[None], n)[0].numpy(),
                                      ref)
    for cfg in (EngineConfig(n_slots=2, max_len=64),
                EngineConfig(n_slots=2, max_len=64, paged=True, page_len=8,
                             kv_dtype="q8")):
        eng = InferenceEngine(pm, cfg)
        with eng:
            outs = [h.result(timeout=120) for h in
                    [eng.submit(p, SamplingParams(max_new_tokens=n))
                     for p in prompts]]
        if not cfg.paged:
            for out, ref in zip(outs, refs):
                np.testing.assert_array_equal(out, ref)
        assert all(len(o) == n for o in outs)


def test_resolve_weight_and_device():
    emb = Embedding(300, 32, device=CPU,
                    generator=torch.Generator().manual_seed(0))
    w = emb.weight.detach().clone()
    quant.quantize_tree(emb, min_size=1)
    assert emb.weight is None and emb.weight_q.dtype == torch.int8
    assert emb.weight_scale.shape == (32,)
    ids = torch.tensor([[3, 299, 0]])
    np.testing.assert_array_equal(
        emb(ids).numpy(), quant.resolve_weight(emb)[ids].numpy())
    assert ((quant.resolve_weight(emb) - w).abs()
            <= emb.weight_scale / 2 * (1 + 127 * 2.0 ** -21)).all()
    model = TransformerLM(vocab=61, dim=32, n_layers=1, n_heads=4,
                          max_seq=64, device=CPU)
    quant.quantize_tree(model, min_size=256)
    assert model.tok.weight is None and model.device == CPU
    assert model.head_weight().shape == (61, 32)
    lin = Linear(8, 8, device=CPU)
    lin.register_parameter("weight", None)
    with pytest.raises(ValueError, match="weight_q"):
        quant.resolve_weight(lin)
