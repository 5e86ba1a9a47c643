"""K4''s latent form (``ops.rope_write_latent_full``: MLA's ``kv_norm``,
both ropes, the padding, the latent row's store and q_eff's assembly in one
launch a layer) on the CPU, where the wrapper runs its plain version.

- tiny-mla in f32 at ``Q == 1`` and ``Q > 1``, pad rows with garbage page
  targets and pad tokens in live rows, inputs from a numpy seed: the port's
  ``mla_write`` (one ``rope_write_latent_full`` call, no
  ``write_kv_pages_full``) against JAX's ``llmd_tpu/models/mla.py:32
  mla_write``, the pool and q_eff, at ``rtol = atol = 2e-5`` as
  ``tests/test_torch_mla.py`` holds the MLA layer.
- In bf16 the plain version bit-equal to the chain ``mla_write`` ran before
  the fused form (``rms_norm``, ``apply_rope``, ``cat``, ``pad`` and
  ``write_kv_pages_full``), with the norm's factor (``rstd=``) as the
  plain arithmetic computes it.
- The wrapper's argument checks (the kernel's side, reached here directly):
  the tensors ``mla_write`` passes at tiny-mla's and deepseek-v2-lite's
  widths are accepted (the einsum's output and the projection's views as
  they come); misaligned row strides, rank and rope widths, an int8 pool,
  mixed dtypes and the addressing's dtypes are refused.
- ``profile_step``'s split of an MLA model's "other" kernels by family
  names every family of a tiny-mla forward traced on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from llmd_tpu.models import mla as jmla
from llmd_tpu.models.common import rope_tables as jax_rope_tables
from llmd_tpu_torch import ops
from llmd_tpu_torch.models import mla
from llmd_tpu_torch.models.common import apply_rope, rms_norm, rope_tables
from llmd_tpu_torch.models.registry import get_model_config
from llmd_tpu_torch.ops import kv_write
from test_torch_mla import bucketed_step, inputs, jax_tree

PAGE, MAX_PAGES, P = 4, 8, 32
GARBAGE = 2**30  # a pad row's page ids: outside any pool
# (start, width) rows; a (start, 0) row is a pad row (query_len 0).
STEPS = {
    "decode": ((7, 1), (5, 0), (0, 1), (12, 1)),
    "prefill": ((0, 6), (9, 0), (9, 3), (20, 5)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """tiny-mla's JAX config and tree (norm weights away from one)."""
    return jax_tree("tiny-mla")


def step(rows, vocab, seed=5):
    rng = np.random.default_rng(seed)
    s = bucketed_step(rng, rows, PAGE, vocab, MAX_PAGES)
    s["page_table"] %= P
    for i, (_, w) in enumerate(rows):
        if w == 0:
            s["page_table"][i] = GARBAGE
    return rng, s


class Spy:
    """Records the port's calls of ``ops.rope_write_latent_full`` (then
    runs it) and fails on a call of ``ops.write_kv_pages_full``."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = ops.rope_write_latent_full

        def latent(*args, **kw):
            self.calls.append((args, kw))
            return real(*args, **kw)

        def store(*args, **kw):
            raise AssertionError("mla_write called write_kv_pages_full")

        monkeypatch.setattr(ops, "rope_write_latent_full", latent)
        monkeypatch.setattr(ops, "write_kv_pages_full", store)


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_mla_write_matches_jax(tiny, kind, monkeypatch):
    cfg, tree = tiny
    tcfg = get_model_config("tiny-mla")
    rng, s = step(STEPS[kind], cfg.vocab_size)
    jinp, tinp = inputs(s)
    lp = {k: v[0] for k, v in tree["layers"].items()}
    h = rng.normal(size=(*s["token_ids"].shape, cfg.hidden_size)).astype(np.float32)
    pool = rng.normal(size=(2, P, 1, PAGE, cfg.kv_cache_entry_dim)).astype(np.float32)
    cos, sin = jax_rope_tables(jinp.positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    jpool, jq = jax.jit(lambda h, lp, pool, inp, cos, sin: jmla.mla_write(
        h, lp, pool, jnp.int32(1), inp, cfg, cos, sin,
    ))(jnp.asarray(h), {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(pool), jinp, cos, sin)
    spy = Spy(monkeypatch)
    tcos, tsin = rope_tables(tinp.positions, tcfg.qk_rope_head_dim, tcfg.rope_theta)
    tpool, tq = mla.mla_write(
        torch.from_numpy(h), {k: torch.from_numpy(v.copy()) for k, v in lp.items()},
        torch.from_numpy(pool.copy()), 1, tinp, tcfg, tcos, tsin,
    )
    assert len(spy.calls) == 1
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), rtol=2e-5, atol=2e-5)
    assert np.array_equal(tpool.numpy()[0], pool[0])  # another layer: untouched
    # The kernel's side takes the model's tensors as they come.
    args, kw = spy.calls[0]
    kv_write._check_latent(*args[:2], *args[2:4], *args[5:9], kw.get("rstd"))


def old_chain(pool, layer, kv_a, w, eps, cos, sin, q_pe, q_eff_nope, pt, positions, valid):
    """``mla_write``'s body between the projections and the return before
    the fused form: the norm, the ropes, the concatenations and pads, the
    store through ``ops.write_kv_pages_full``."""
    rank, rope, Dl = q_eff_nope.shape[-1], q_pe.shape[-1], pool.shape[-1]
    c_kv = rms_norm(kv_a[..., :rank], w, eps)
    k_pe = apply_rope(kv_a[..., None, rank:], cos, sin)[:, :, 0]
    latent = F.pad(torch.cat([c_kv, k_pe], dim=-1), (0, Dl - rank - rope))
    lat4 = latent[:, :, None, :]
    ops.write_kv_pages_full(pool, layer, lat4[..., : Dl // 2], lat4[..., Dl // 2 :], pt,
                            positions, valid)
    q_pe = apply_rope(q_pe, cos, sin)
    return F.pad(torch.cat([q_eff_nope, q_pe], dim=-1), (0, Dl - rank - rope))


def latent_args(rng, cfg, B, Q, dtype=torch.bfloat16):
    """Seeded kv_a and a q projection (its rope heads a strided view, as
    the model slices them), kv_norm's weight and q_eff_nope, in dtype."""
    nh, nope, rope, rank = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dtype)

    kv_a = t(B, Q, rank + rope, scale=3.0)
    q = t(B, Q, nh, nope + rope)
    w = t(rank, scale=0.1) + 1
    q_eff_nope = torch.einsum("bqhn,hrn->bqhr", q[..., :nope], t(nh, rank, nope))
    return kv_a, w, q[..., nope:], q_eff_nope


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_plain_form_is_bit_equal_to_the_old_chain_in_bf16(tiny, kind):
    cfg = dataclasses.replace(get_model_config("tiny-mla"), dtype="bfloat16")
    rng, s = step(STEPS[kind], cfg.vocab_size, seed=8)
    _, tinp = inputs(s)
    B, Q = s["token_ids"].shape
    kv_a, w, q_pe, q_eff_nope = latent_args(rng, cfg, B, Q)
    pool = torch.from_numpy(rng.normal(size=(2, P, 1, PAGE, cfg.kv_cache_entry_dim))
                            .astype(np.float32)).to(torch.bfloat16)
    cos, sin = rope_tables(tinp.positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    addr = (tinp.page_table, tinp.positions, tinp.valid)
    want_pool = pool.clone()
    want = old_chain(want_pool, 1, kv_a, w, 1e-6, cos, sin, q_pe, q_eff_nope, *addr)
    rstd = torch.empty(B * Q)
    got = ops.rope_write_latent_plain(pool, 1, kv_a, w, 1e-6, cos, sin, q_pe, q_eff_nope, *addr,
                                      rstd=rstd)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(pool, want_pool)
    # The factor: the stored c_kv is (x r) rounded, times the weight, rounded.
    xf = kv_a[..., : cfg.kv_lora_rank].float()
    assert torch.equal(rstd, torch.rsqrt((xf * xf).mean(-1) + 1e-6).reshape(-1))
    c_kv = (xf * rstd.view(B, Q, 1)).to(torch.bfloat16) * w
    live = tinp.valid
    pos = tinp.positions.long()
    phys = torch.gather(tinp.page_table.long().clamp(max=P - 1), 1, pos // PAGE)
    stored = pool[1, phys[live], 0, (pos % PAGE)[live], : cfg.kv_lora_rank]
    assert torch.equal(stored, c_kv[live])


def test_checks_take_deepseek_widths(monkeypatch):
    """At deepseek-v2-lite's widths (rank 512, rope 64, Dl 640, 16 heads,
    q_lora_rank 0) the tensors ``mla_write`` passes are accepted, with
    16-byte rope vectors in bf16 (8 elements) and f32 (4)."""
    base = get_model_config("deepseek-v2-lite")
    for dtype, m in ((torch.bfloat16, 8), (torch.float32, 4)):
        cfg = dataclasses.replace(base, dtype=str(dtype)[6:])
        rng = np.random.default_rng(3)
        nh, nope, rope, rank = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
        H = 64  # a narrow hidden size: the widths that matter are the latent's

        def t(*shape):
            return torch.from_numpy((rng.normal(size=shape) * 0.1).astype(np.float32)).to(dtype)

        lp = {"wq": t(H, nh * (nope + rope)), "wkv_a": t(H, rank + rope), "kv_norm": t(rank) + 1,
              "wkv_b": t(rank, nh * (nope + cfg.v_head_dim))}
        for rows in (((7, 1), (3, 1), (5, 0)), ((0, 6), (9, 3))):
            _, s = step(rows, 100)
            _, tinp = inputs(s)
            B, Q = s["token_ids"].shape
            h = t(B, Q, H)
            pool = torch.zeros((1, P, 1, PAGE, cfg.kv_cache_entry_dim), dtype=dtype)
            cos, sin = rope_tables(tinp.positions, rope, cfg.rope_theta)
            spy = Spy(monkeypatch)
            mla.mla_write(h, lp, pool, 0, tinp, cfg, cos, sin)
            (args, kw), = spy.calls
            views, strides, got_m = kv_write._check_latent(*args[:2], *args[2:4], *args[5:9], None)
            assert got_m == m
            assert strides[0] == rank + rope and strides[1:3] == (nh * (nope + rope), nope + rope)
            monkeypatch.undo()


def check_args(dtype=torch.bfloat16, rank=64, rope=16, Dl=128, nh=2, N=3):
    g = torch.Generator().manual_seed(0)
    kv_a = torch.randn((N, 1, rank + rope), generator=g).to(dtype)
    q = torch.randn((N, 1, nh, 32 + rope), generator=g).to(dtype)
    return dict(
        kv_cache=torch.zeros((2, 8, 1, 4, Dl), dtype=dtype), layer=1, kv_a=kv_a,
        kv_norm=torch.ones(rank, dtype=dtype), cos=torch.zeros((N, 1, rope // 2)),
        sin=torch.zeros((N, 1, rope // 2)), q_pe=q[..., 32:],
        q_eff_nope=torch.zeros((N, 1, nh, rank), dtype=dtype), rstd=None,
    )


REFUSED = {
    "int8 pool": lambda a: a.update(kv_cache=a["kv_cache"].to(torch.int8)),
    "pool of another dtype": lambda a: a.update(kv_cache=a["kv_cache"].float()),
    "one head-pool of two": lambda a: a.update(kv_cache=torch.zeros((2, 8, 2, 4, 64),
                                                                     dtype=torch.bfloat16)),
    "layer out of range": lambda a: a.update(layer=2),
    "kv_a rows 2 bytes apart": lambda a: a.update(
        kv_a=torch.zeros((3, 1, 81), dtype=torch.bfloat16)[..., :80]),
    "kv_a's last axis strided": lambda a: a.update(
        kv_a=torch.zeros((3, 1, 160), dtype=torch.bfloat16)[..., ::2]),
    "rank not 16 bytes": lambda a: a.update(**check_args(rank=60)),
    "odd rope": lambda a: a.update(**check_args(rope=15, Dl=128)),
    "latent wider than Dl": lambda a: a.update(**check_args(rank=64, rope=16, Dl=72)),
    "q_pe of another dtype": lambda a: a.update(q_pe=a["q_pe"].float()),
    "kv_norm of another width": lambda a: a.update(kv_norm=torch.ones(32, dtype=torch.bfloat16)),
    "cos in bf16": lambda a: a.update(cos=a["cos"].to(torch.bfloat16)),
    "rope half of 2": lambda a: a.update(**check_args(rope=4, Dl=128)),
    "q_eff_nope heads misaligned": lambda a: a.update(
        q_eff_nope=torch.zeros((3, 1, 2, 65), dtype=torch.bfloat16)[..., :64]),
    "rstd of another length": lambda a: a.update(rstd=torch.zeros(2)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_checks_refuse_what_the_kernel_does_not_take(case):
    args = check_args()
    kv_write._check_latent(**args)  # the unchanged arguments pass
    REFUSED[case](args)
    with pytest.raises(ValueError):
        kv_write._check_latent(**args)


def test_bucketed_addressing_checks():
    pool = torch.zeros((2, 8, 1, 4, 128))
    pt, pos, valid = torch.zeros((2, 3), dtype=torch.int32), torch.zeros((2, 5), dtype=torch.int32), \
        torch.ones((2, 5), dtype=torch.bool)
    kv_write._check_bucket_index(pool, 2, 5, pt, pos, valid)
    for bad in ((pt.long(), pos, valid), (pt, pos.long(), valid), (pt, pos, valid.int()),
                (pt, pos[:, :4], valid), (pt[:1], pos, valid), (pt, pos.t().contiguous().t(), valid)):
        with pytest.raises(ValueError):
            kv_write._check_bucket_index(pool, 2, 5, *bad)


@pytest.mark.parametrize("Q", [1, 4])
def test_profile_step_names_every_family_of_an_mla_forward(Q):
    """``profile_step``'s split of an MLA model's "other" kernels: each
    CPU op of a tiny-mla forward (with its logits) traced under
    ``family_ranges`` falls in the family of the innermost range around
    it. The latent chain is the latent write's own ops (on the CPU, the
    plain version), the einsums are found by their enclosing aten::einsum,
    and the ranges are taken off after."""
    from torch.profiler import ProfilerActivity, profile

    from llmd_tpu_torch import profile_step
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.common import StepInput

    cfg = get_model_config("tiny-mla")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B = 3
    inp = StepInput(
        token_ids=torch.ones((B, Q), dtype=torch.long),
        positions=(torch.arange(Q, dtype=torch.int32) + 3).repeat(B, 1),
        kv_lens=torch.full((B,), Q + 3, dtype=torch.int32),
        page_table=torch.arange(B * 8, dtype=torch.int32).reshape(B, 8),
        query_lens=torch.full((B,), Q, dtype=torch.int32),
    )
    pool = torch.zeros((cfg.num_layers, 32, 1, PAGE, cfg.kv_cache_entry_dim))
    forward = llama.forward_hidden
    with profile_step.family_ranges(), profile(activities=[ProfilerActivity.CPU]) as prof:
        h, _ = llama.forward_hidden(params, pool, inp, cfg)
        llama.compute_logits(params, h[:, -1], cfg)
    seen = {profile_step._family(e) for e in prof.events() if e.name.startswith("aten::")}
    assert seen == set(profile_step._FAMILIES) | {"absorption einsums", "rest"}
    assert llama.forward_hidden is forward and llama.rms_norm is rms_norm
