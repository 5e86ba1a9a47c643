"""The fused forms of ``quantize_rows`` (``llmd_tpu_torch/ops/quant.py``:
``add_rms_norm_quant``, ``glu_quant``) and the int8 layers that call them,
on the CPU.

The same numpy inputs from a seed go through the JAX package and the
port's plain versions, in f32 and bf16:

- ``add_rms_norm_quant``: the residual ``x + (delta + bias)`` bit-equal to
  JAX's; h against ``llmd_tpu/models/common.py:62 rms_norm`` within a few
  ulps (f32; XLA's rsqrt and its sum's order are not PyTorch's) or one ulp
  (bf16); (xq, a_scale) bit-equal to JAX's
  ``llmd_tpu/ops/quant.py:116 quantize_activations`` of the port's h.
- ``glu_quant``: act against ``jax.nn.silu(gate) * up``
  (``llmd_tpu/models/llama.py:154``) and ``llmd_tpu/models/moe.py:112
  expert_glu`` after the experts' biases, within a few ulps in f32 (XLA's
  exp and logistic); in bf16 silu within a few ulps (PyTorch rounds silu's
  output before the product, XLA need not), gpt-oss's clamped SwiGLU bit
  for bit (the port rounds 1.702 to bf16, 1.703125, and the sigmoid's exp
  and sum, as JAX does; also on 4,097 gates and ups over [-6, 6], where
  the older arithmetic differed in 1,158); (xq, a_scale) bit-equal to
  JAX's quantization of the port's act.
- Both forms bit-equal to the chain the port ran before them (its
  ``rms_norm`` or ``glu`` then ``quantize_rows_plain``), which keeps the
  int8 engines' streams equal to JAX's (``tests/test_torch_quant.py``).
- Quantizing rows then gathering them equals gathering then quantizing,
  bit for bit, and the MoE block's experts get the rows the old path
  quantized after its gather.
- One int8 forward of tiny, tiny-moe, tiny-mla and a tiny gpt-oss config
  calls each int8 wrapper as often as ``chip_smoke.q8_launches`` counts
  (the formula the card's launch counts are held to); a float tree calls
  none of them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from llmd_tpu.models import moe as jmoe
from llmd_tpu.models.common import rms_norm as jax_rms_norm
from llmd_tpu.ops import quant as jquant
from llmd_tpu_torch.config import tiny_model_config
from llmd_tpu_torch.models import llama, moe
from llmd_tpu_torch.models.common import StepInput, rms_norm
from llmd_tpu_torch.models.registry import get_model_config
from llmd_tpu_torch.ops import grouped_gemm, quant
from test_torch_mla import bucketed_step
from test_torch_model import NUM_PAGES, PAGE, TINY_OSS, step

MANTISSA = {"float32": 23, "bfloat16": 7}
# ulps of the JAX chain a plain form may lie from: f32 measured at most 4
# (XLA's rsqrt, exp and logistic, and the mean's sum order); bf16 norm 0
# measured (the f32 differences rarely move a bf16 rounding), silu at most
# 3 (PyTorch rounds silu's output before the product).
NORM_ULPS = {"float32": 8, "bfloat16": 1}
GLU_ULPS = {"float32": 8, "bfloat16": 4}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def from_jax(a) -> torch.Tensor:
    """A JAX array as a torch tensor with the same bits (bf16 included)."""
    return llama.params_from_jax({"x": np.asarray(a)})["x"]


def ulps(got: torch.Tensor, want: torch.Tensor, dtype: str) -> float:
    """The largest distance in units of the last place of ``want``."""
    g, w = got.double(), want.double()
    e = torch.floor(torch.log2(w.abs().clamp(min=2.0**-100)))
    return ((g - w).abs() / torch.exp2(e - MANTISSA[dtype])).max().item()


def assert_quantized_like_jax(xq, scale, rows: torch.Tensor) -> None:
    """(xq, scale) bit-equal to JAX's ``quantize_activations`` of rows."""
    jq, js = jquant.quantize_activations(jnp.asarray(rows.float().numpy(), str(rows.dtype)[6:]))
    assert torch.equal(xq, from_jax(jq)) and torch.equal(scale, from_jax(js)[:, 0])


def rows(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["norm", "add", "add_bias"])
def test_add_rms_norm_quant_plain_matches_jax(dtype, form):
    rng = np.random.default_rng(31)
    M, K = 19, 96
    x = rows(rng, (M, K)) * rng.uniform(0.05, 20.0, size=(M, 1)).astype(np.float32)
    d, b, w = rows(rng, (M, K)), rows(rng, (K,), 0.1), rows(rng, (K,))
    d[0] = -x[0]  # an all-zero residual: h 0, the scale at its floor
    jx, jd, jb, jw = (jnp.asarray(a, dtype) for a in (x, d, b, w))
    delta = None if form == "norm" else from_jax(jd)
    bias = from_jax(jb) if form == "add_bias" else None
    xn, h, xq, scale = quant.add_rms_norm_quant(from_jax(jx), delta, bias, from_jax(jw), 1e-5, True)
    want_x = jx if form == "norm" else jx + (jd + jb if form == "add_bias" else jd)
    assert torch.equal(xn, from_jax(want_x))
    assert h.dtype == xn.dtype and ulps(h, from_jax(jax_rms_norm(want_x, jw, 1e-5)), dtype) <= NORM_ULPS[dtype]
    assert_quantized_like_jax(xq, scale, h)
    # The port's chain before the fused form: its add, rms_norm, quantize_rows.
    assert torch.equal(h, rms_norm(xn, from_jax(jw), 1e-5))
    assert torch.equal(xq, quant.quantize_rows_plain(h)[0])
    assert form != "add" or torch.equal(scale[0], torch.tensor(1e-30) / 127.0)
    # h only where asked; the same rows either way.
    none = quant.add_rms_norm_quant(from_jax(jx), delta, bias, from_jax(jw), 1e-5)
    assert none[1] is None and torch.equal(none[2], xq) and torch.equal(none[3], scale)


GLU_CASES = [("silu", "split", False), ("silu", "pair", False), ("silu", "pair", True),
             ("swiglu_oss", "pair", True), ("swiglu_oss", "pair", False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,layout,biased", GLU_CASES, ids=["-".join(map(str, c)) for c in GLU_CASES])
def test_glu_quant_plain_matches_jax(dtype, kind, layout, biased):
    rng = np.random.default_rng(32)
    M, Fw, E = 21, 80, 5
    gate, up = rows(rng, (M, Fw), 4.0), rows(rng, (M, Fw), 4.0)
    gate[0, :3] = [9.0, -9.0, 0.0]  # past the clamp both ways
    up[0, :3] = [9.0, -9.0, 0.0]
    ids = rng.integers(0, E, size=M)  # unsorted, as a test of the gather
    bg, bu = rows(rng, (E, Fw), 0.5), rows(rng, (E, Fw), 0.5)
    jg, ju, jbg, jbu = (jnp.asarray(a, dtype) for a in (gate, up, bg, bu))
    tg, tu = from_jax(jg), from_jax(ju)
    cfg = tiny_model_config(**TINY_OSS) if kind == "swiglu_oss" else None
    if layout == "split":  # the halves of one [M, 2F] product, as views
        gu = torch.cat([tg, tu], dim=1)
        args, (tg, tu) = (gu, None), (gu[:, :Fw], gu[:, Fw:])
    else:
        args = (tg, tu)
    biases = (from_jax(jbg), from_jax(jbu)) if biased else None
    tids = torch.from_numpy(ids) if biased else None
    xq, scale, act = quant.glu_quant(*args, *moe.glu_kind(cfg), biases, tids, want_act=True)
    if biased:
        jg, ju = jg + jbg[ids], ju + jbu[ids]
        tg, tu = tg + biases[0][tids], tu + biases[1][tids]
    want = jax.nn.silu(jg) * ju if kind == "silu" else jmoe.expert_glu(jg, ju, cfg)
    if kind == "swiglu_oss" and dtype == "bfloat16":
        assert torch.equal(act, from_jax(want))  # JAX's roundings, bit for bit
    else:
        assert ulps(act, from_jax(want), dtype) <= GLU_ULPS[dtype]
    assert_quantized_like_jax(xq, scale, act)
    # The port's chain before the fused form: its GLU, then quantize_rows.
    assert torch.equal(act, moe.expert_glu(tg, tu, cfg))
    assert torch.equal(xq, quant.quantize_rows_plain(act)[0])
    assert quant.glu_quant(*args, *moe.glu_kind(cfg), biases, tids)[2] is None


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_gpt_oss_glu_rounds_as_jax(dtype):
    """gpt-oss's clamped SwiGLU (limit 7) on 4,097 gates and ups drawn
    over [-6, 6]: ``glu`` and ``glu_quant_plain``'s act bit-equal to JAX's
    ``expert_glu``. Tolerance 0: JAX rounds 1.702 to the dtype (bf16
    1.703125) and its sigmoid's exp and sum to the dtype, and so does the
    port; multiplying by 1.702 in f32 and rounding the sigmoid once gave
    1,158 of these bf16 values another result, by up to 0.125."""
    rng = np.random.default_rng(34)
    gate, up = (rng.uniform(-6.0, 6.0, size=(1, 4097)).astype(np.float32) for _ in range(2))
    jg, ju = jnp.asarray(gate, dtype), jnp.asarray(up, dtype)
    cfg = tiny_model_config(**TINY_OSS)
    want = from_jax(jmoe.expert_glu(jg, ju, dataclasses.replace(cfg, swiglu_limit=7.0)))
    tg, tu = from_jax(jg), from_jax(ju)
    assert torch.equal(quant.glu(tg, tu, "swiglu_oss", 7.0), want)
    assert torch.equal(quant.glu_quant_plain(tg, tu, "swiglu_oss", 7.0, want_act=True)[2], want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_then_gather_equals_gather_then_quantize(monkeypatch, dtype):
    """Per-row quantization commutes with a row gather, bit for bit, and
    JAX's quantization of the gathered rows agrees; the MoE block's int8
    experts gather the rows quantized once before the gather, and get the
    rows the old path quantized after it (the sorted token rows)."""
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rows(rng, (13, 64)) * rng.uniform(0.01, 50, size=(13, 1)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 13, size=40))
    xq, scale = quant.quantize_rows_plain(x)
    gq, gs = quant.quantize_rows_plain(x[idx])
    assert torch.equal(xq[idx], gq) and torch.equal(scale[idx], gs)
    assert_quantized_like_jax(gq, gs, x[idx])
    E, Fw, k = 4, 32, 2
    ws = [quant.quantize_weight(torch.from_numpy(rows(rng, s, 0.2)).to(dtype)) for s in
          ((E, 64, Fw), (E, 64, Fw), (E, Fw, 64))]
    weights = torch.from_numpy(rng.random(size=(13, k)).astype(np.float32))
    ids = torch.from_numpy(np.stack([rng.permutation(E)[:k] for _ in range(13)]))
    seen = []
    mlp = grouped_gemm.expert_mlp_grouped
    monkeypatch.setattr(grouped_gemm, "expert_mlp_grouped", lambda xs, *a, **kw: (seen.append(xs), mlp(xs, *a, **kw))[1])
    out = grouped_gemm.moe_apply_grouped(x, weights, ids, *(q.mT.contiguous() for q, _ in ws),
                                         scales=tuple(s for _, s in ws), hq=quant.QRows(xq, scale, dtype))
    tok = torch.argsort(ids.reshape(-1), stable=True) // k
    want_q, want_s = quant.quantize_rows_plain(x[tok])
    assert torch.equal(seen[0].xq, want_q) and torch.equal(seen[0].scale, want_s) and seen[0].dtype == dtype
    assert out.shape == (13, 64) and torch.isfinite(out).all()


WRAPPERS = ((quant, "add_rms_norm_quant"), (quant, "glu_quant"), (quant, "quantize_rows"),
            (grouped_gemm, "matmul_q8"), (grouped_gemm, "grouped_matmul_q8"),
            (grouped_gemm, "grouped_matmul_q8_pair"))
MODELS = {"tiny": "tiny", "tiny-moe": "tiny-moe", "tiny-mla": "tiny-mla", "tiny-oss": TINY_OSS}


def tiny_forward_inputs(cfg):
    """One step of the tiny config: a flat step, or a bucketed prefill step
    for MLA (its only layout), and a pool."""
    rng = np.random.default_rng(34)
    t = torch.from_numpy
    if cfg.is_mla:
        s = bucketed_step(rng, ((5, 6), (12, 1), (0, 9)), PAGE, cfg.vocab_size, 8)
        s["page_table"] %= NUM_PAGES
        inp = StepInput(**{k: t(v) for k, v in s.items()})
    else:
        s = step(rng, cfg)
        inp = StepInput(token_ids=t(s["ids"][:, None]), positions=t(s["positions"][:, None]),
                        kv_lens=t(s["kv_lens"]), page_table=t(s["page_table"]), token_rows=t(s["rows"]),
                        num_live=torch.tensor([s["total"]], dtype=torch.int32))
    shape = (cfg.num_layers, NUM_PAGES, cfg.kv_cache_heads, PAGE, cfg.kv_cache_entry_dim)
    return inp, t(rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("quantization", ["int8", None])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_int8_forward_calls_each_form_as_counted(monkeypatch, model, quantization):
    name = MODELS[model]
    over = dict(quantization=quantization)
    cfg = tiny_model_config(**name, **over) if isinstance(name, dict) else get_model_config(name, **over)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu", fused=True)
    calls = dict.fromkeys((fn for _, fn in WRAPPERS), 0)
    for mod, fn in WRAPPERS:
        def counted(*args, _f=getattr(mod, fn), _n=fn, **kwargs):
            calls[_n] += 1
            return _f(*args, **kwargs)
        monkeypatch.setattr(mod, fn, counted)
    inp, pool = tiny_forward_inputs(cfg)
    hidden, _ = llama.forward_hidden(params, pool, inp, cfg)
    logits = llama.compute_logits(params, hidden.reshape(-1, cfg.hidden_size), cfg)
    assert torch.isfinite(logits).all()
    assert calls == chip_smoke.q8_launches(cfg, 1)
    assert (quantization is None) == (sum(calls.values()) == 0)
