"""HF checkpoints: ``config.json`` -> ``ModelConfig``, ``*.safetensors`` ->
the stacked parameter tree.

The port of ``llmd_tpu/models/loader.py`` (``config_from_hf``,
``load_params``). It maps HF names and layouts onto the port's tree, which
is the JAX package's:

  - HF linear weights are ``[out, in]`` and applied as ``x @ W.T``; the
    tree's are ``[in, out]`` applied as ``x @ W``, so every projection is
    transposed on load.
  - HF stores one tensor a layer (``model.layers.{i}.*``); the tree's
    leaves are stacked along a leading layer axis.
  - DeepSeek checkpoints store their rope dimensions interleaved (HF
    permutes them at run time); the permutation is baked into the loaded
    projections so that the split-half ``apply_rope`` matches.

The safetensors files are read by this module's own reader (``_Checkpoint``:
a little-endian u64 header length, a JSON header, then the raw bytes): each
tensor's bytes are mapped into memory on their own and viewed as a tensor,
with no copy on the host. The tree is built layer by layer on ``device``:
each leaf is allocated once and each layer's tensor is copied into it
(moved to the device as stored, then transposed and converted there), so
the host maps about one tensor at a time and the device holds no more than
the tree and one tensor.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import mmap
import pathlib
import struct

import torch

from llmd_tpu_torch.config import ModelConfig
from llmd_tpu_torch.models.common import SUPPORTED_ROPE_TYPES, rope_type

log = logging.getLogger(__name__)

_DENSE_ARCHS = {
    "LlamaForCausalLM",
    "MistralForCausalLM",
    "Qwen2ForCausalLM",
    "Qwen3ForCausalLM",
}
_MOE_ARCHS = {"MixtralForCausalLM", "Qwen3MoeForCausalLM", "GptOssForCausalLM"}
_MLA_ARCHS = {"DeepseekV2ForCausalLM", "DeepseekV3ForCausalLM"}
SUPPORTED_ARCHS = _DENSE_ARCHS | _MOE_ARCHS | _MLA_ARCHS

# ModelConfig fields of the JAX package that the port does not have yet,
# and the ROADMAP.md queue 1 item that brings each.
_NOT_PORTED = {
    "quantization": "int8 weights, ROADMAP.md queue 1 item 3",
    "num_lora_adapters": "LoRA, ROADMAP.md queue 1 item 8",
    "lora_rank": "LoRA, ROADMAP.md queue 1 item 8",
    "lora_dynamic": "LoRA, ROADMAP.md queue 1 item 8",
}


def is_model_dir(path: str) -> bool:
    p = pathlib.Path(path)
    return p.is_dir() and (p / "config.json").is_file()


def config_from_hf(model_dir: str, **overrides) -> ModelConfig:
    """A ModelConfig from an HF model directory's ``config.json``, field
    for field as the JAX package builds it."""
    for name in overrides:
        if name in _NOT_PORTED:
            raise ValueError(f"{name} is not ported yet ({_NOT_PORTED[name]})")
    p = pathlib.Path(model_dir)
    with open(p / "config.json") as f:
        hf = json.load(f)
    archs = hf.get("architectures") or []
    arch = archs[0] if archs else ""
    if arch not in SUPPORTED_ARCHS:
        raise ValueError(
            f"unsupported architecture {arch!r} in {model_dir}; "
            f"supported: {sorted(SUPPORTED_ARCHS)}"
        )
    rope_scaling = hf.get("rope_scaling")
    if rope_type(rope_scaling) not in SUPPORTED_ROPE_TYPES:
        raise ValueError(
            f"rope_scaling type {rope_type(rope_scaling)!r} "
            f"not supported (have: {SUPPORTED_ROPE_TYPES})"
        )
    if rope_type(rope_scaling) == "yarn":
        # HF's _compute_yarn_parameters falls back to the model's
        # max_position_embeddings when the original length is absent.
        rope_scaling = dict(rope_scaling)
        rope_scaling.setdefault(
            "original_max_position_embeddings",
            hf.get("max_position_embeddings", 8192),
        )
    kw: dict = dict(
        name=p.name or str(p),
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim"),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rope_scaling=rope_scaling,
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        max_model_len=int(hf.get("max_position_embeddings", 8192)),
        tie_word_embeddings=bool(hf.get("tie_word_embeddings", False)),
        # f16 checkpoints run in bf16 (f16's narrow range under/overflows
        # in softmax and logits). Newer transformers writes the key as
        # "dtype", older as "torch_dtype".
        dtype={
            "float32": "float32", "bfloat16": "bfloat16",
        }.get(str(hf.get("dtype") or hf.get("torch_dtype")), "bfloat16"),
    )
    # Sliding-window attention, in the HF conventions: Mistral's uniform
    # windows, Qwen2's use_sliding_window + max_window_layers (layers from
    # max_window_layers up slide), and gpt-oss's per-layer layer_types.
    if hf.get("sliding_window") and hf.get("use_sliding_window", True):
        kw["sliding_window"] = int(hf["sliding_window"])
        if hf.get("layer_types"):
            kw["layer_types"] = tuple(hf["layer_types"])
        elif "use_sliding_window" in hf:
            # A Qwen2 config that omits the key inherits HF's class default
            # (Qwen2Config: 28); uniform windows would slide layers the
            # trained model did not.
            kw["max_window_layers"] = int(hf.get("max_window_layers", 28))
    if arch == "Qwen2ForCausalLM":
        kw["attention_bias"] = True  # Qwen2 biases q|k|v (no config flag)
    else:
        kw["attention_bias"] = bool(hf.get("attention_bias", False))
    if arch in ("Qwen3ForCausalLM", "Qwen3MoeForCausalLM"):
        kw["qk_norm"] = True
    if arch == "MixtralForCausalLM":
        kw.update(
            num_experts=hf["num_local_experts"],
            num_experts_per_tok=hf["num_experts_per_tok"],
            moe_intermediate_size=hf["intermediate_size"],
        )
    elif arch == "Qwen3MoeForCausalLM":
        kw.update(
            num_experts=hf["num_experts"],
            num_experts_per_tok=hf["num_experts_per_tok"],
            moe_intermediate_size=hf["moe_intermediate_size"],
            norm_topk_prob=bool(hf.get("norm_topk_prob", True)),
        )
    elif arch == "GptOssForCausalLM":
        kw.update(
            # HF GptOssConfig defaults attention_bias to true: a config.json
            # that omits the key keeps its q|k|v and o biases.
            attention_bias=bool(hf.get("attention_bias", True)),
            num_experts=hf["num_local_experts"],
            num_experts_per_tok=hf["num_experts_per_tok"],
            moe_intermediate_size=hf["intermediate_size"],
            moe_activation="swiglu_oss",
            swiglu_limit=float(hf.get("swiglu_limit") or 7.0),
            router_logit_bias=True,
            norm_topk_prob=True,  # softmax over the selected logits
            attention_out_bias=bool(hf.get("attention_bias", True)),
            attention_sinks=True,
        )
    elif arch in _MLA_ARCHS:
        if arch == "DeepseekV3ForCausalLM":
            router_scoring, topk_method = "sigmoid", "group_top2"
        else:
            router_scoring = "softmax"
            topk_method = {
                "greedy": "greedy",
                "group_limited_greedy": "group_max",
            }[hf.get("topk_method", "greedy")]
        kw.update(
            kv_lora_rank=hf["kv_lora_rank"],
            q_lora_rank=hf.get("q_lora_rank") or 0,
            qk_nope_head_dim=hf["qk_nope_head_dim"],
            qk_rope_head_dim=hf["qk_rope_head_dim"],
            v_head_dim=hf["v_head_dim"],
            num_experts=hf.get("n_routed_experts") or 0,
            num_experts_per_tok=hf.get("num_experts_per_tok") or 2,
            moe_intermediate_size=hf.get("moe_intermediate_size"),
            first_dense_layers=hf.get("first_k_dense_replace", 0),
            shared_expert_intermediate_size=(
                (hf.get("n_shared_experts") or 0)
                * (hf.get("moe_intermediate_size") or 0)
            ),
            router_scoring=router_scoring,
            topk_method=topk_method,
            norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
            routed_scaling_factor=float(hf.get("routed_scaling_factor", 1.0)),
            n_group=hf.get("n_group") or 1,
            topk_group=hf.get("topk_group") or 1,
        )
    kw.update(overrides)
    return ModelConfig(**kw)


# The safetensors dtypes the reader maps (each one element per itemsize).
_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "I8": torch.int8, "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool,
}


@dataclasses.dataclass(frozen=True)
class _Entry:
    path: pathlib.Path
    dtype: torch.dtype
    shape: tuple[int, ...]
    offset: int  # bytes from the start of the file
    nbytes: int


class _Checkpoint:
    """Name-indexed view over a directory of ``.safetensors`` shards: the
    headers are read once; a tensor's bytes are mapped when it is asked
    for."""

    def __init__(self, model_dir: str) -> None:
        self.dir = pathlib.Path(model_dir)
        files = sorted(self.dir.glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors files in {model_dir}")
        self._where: dict[str, _Entry] = {}
        for f in files:
            with open(f, "rb") as fh:
                (n,) = struct.unpack("<Q", fh.read(8))
                header = json.loads(fh.read(n))
            for name, meta in header.items():
                if name == "__metadata__":
                    continue
                if meta["dtype"] not in _DTYPES:
                    raise ValueError(
                        f"{f.name}: tensor {name!r} has dtype {meta['dtype']!r}; "
                        f"the reader maps {sorted(_DTYPES)}"
                    )
                begin, end = meta["data_offsets"]
                entry = _Entry(f, _DTYPES[meta["dtype"]], tuple(meta["shape"]),
                               8 + n + begin, end - begin)
                itemsize = torch.empty((), dtype=entry.dtype).element_size()
                if entry.nbytes != math.prod(entry.shape) * itemsize:
                    raise ValueError(f"{f.name}: tensor {name!r} has {entry.nbytes} bytes "
                                     f"for shape {list(entry.shape)} {meta['dtype']}")
                self._where[name] = entry
        self.used: set[str] = set()

    def names(self) -> set[str]:
        return set(self._where)

    def has(self, name: str) -> bool:
        return name in self._where

    def _entry(self, name: str) -> _Entry:
        e = self._where.get(name)
        if e is None:
            raise KeyError(f"checkpoint tensor {name!r} not found")
        return e

    def shape(self, name: str) -> tuple[int, ...]:
        return self._entry(name).shape

    def get(self, name: str) -> torch.Tensor:
        """The tensor as stored: a view of its bytes mapped from the file
        (copy-on-write, so the view is a writable tensor and nothing is
        written back), no copy. The mapping lives as long as the view: a
        mapping of the whole file would stay resident as a whole on some
        kernels once touched."""
        e = self._entry(name)
        self.used.add(name)
        if e.nbytes == 0:
            return torch.empty(e.shape, dtype=e.dtype)
        start = e.offset - e.offset % mmap.ALLOCATIONGRANULARITY
        with open(e.path, "rb") as fh:
            buf = mmap.mmap(fh.fileno(), e.offset + e.nbytes - start,
                            access=mmap.ACCESS_COPY, offset=start)
        count = e.nbytes // torch.empty((), dtype=e.dtype).element_size()
        return torch.frombuffer(buf, dtype=e.dtype, count=count,
                                offset=e.offset - start).view(e.shape)


def _interleave_to_half(w: torch.Tensor, rope_dim: int) -> torch.Tensor:
    """Permute the trailing rope columns from interleaved (d0 d1 d0 d1 ...)
    to split-half (evens | odds): HF DeepSeek's run-time q/k permutation,
    baked into the weights."""
    head, tail = w[..., : w.shape[-1] - rope_dim], w[..., w.shape[-1] - rope_dim :]
    return torch.cat([head, tail[..., 0::2], tail[..., 1::2]], dim=-1)


def load_params(
    cfg: ModelConfig, model_dir: str, dtype: str | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """An HF checkpoint as the runner's stacked parameter tree on
    ``device``: ``fuse_projections`` of the JAX ``load_params``'s tree
    (after ``params_from_jax``), bit for bit. q|k|v and gate|up are written
    straight into the column blocks of ``wqkv`` and ``w_gu``, so that no
    unfused leaf is held beside its fused copy; MLA trees stay unfused, as
    the runner keeps them."""
    ckpt = _Checkpoint(model_dir)
    device = torch.device(device)
    dt = getattr(torch, dtype or cfg.dtype)
    Nq, L = cfg.num_heads, cfg.num_layers

    def put(dst: torch.Tensor, name: str, transpose: bool, fn) -> None:
        w = ckpt.get(name).to(device)
        if transpose:
            w = w.T
        dst.copy_(fn(w) if fn else w)

    def stack(names: list, transpose: bool = False, fn=None, dtype=None) -> torch.Tensor:
        """One leaf: ``names[j]`` into ``out[j]``, or ``names[j][e]`` into
        ``out[j, e]``; ``fn`` maps each (transposed) tensor."""
        nested = isinstance(names[0], list)
        shape = ckpt.shape(names[0][0] if nested else names[0])
        if transpose:
            shape = shape[::-1]
        if fn:
            shape = fn(torch.empty(shape, device="meta")).shape
        lead = (len(names), len(names[0])) if nested else (len(names),)
        out = torch.empty((*lead, *shape), dtype=dtype or dt, device=device)
        for j, row in enumerate(names):
            for e, name in enumerate(row) if nested else ((None, row),):
                put(out[j] if e is None else out[j, e], name, transpose, fn)
        return out

    def projections(parts: dict[str, list[str]], fused_name: str) -> dict:
        """Transposed projections side by side in the columns of one
        ``fused_name`` leaf (MLA: stacked apart)."""
        if cfg.is_mla:
            return {key: stack(names, True) for key, names in parts.items()}
        groups = list(parts.values())
        widths = [ckpt.shape(names[0])[0] for names in groups]  # [out, in] stored
        rows = ckpt.shape(groups[0][0])[1]
        out = torch.empty((len(groups[0]), rows, sum(widths)), dtype=dt, device=device)
        for j in range(len(groups[0])):
            c = 0
            for names, w in zip(groups, widths):
                put(out[j, :, c : c + w], names[j], True, None)
                c += w
        return {fused_name: out}

    def proj(i: int, name: str) -> str:
        return f"model.layers.{i}.{name}"

    def layer_stack(layer_ids: list[int], moe: bool) -> dict[str, torch.Tensor]:
        def names(name: str) -> list[str]:
            return [proj(i, name) for i in layer_ids]

        layers = {
            "input_norm": stack(names("input_layernorm.weight")),
            "post_norm": stack(names("post_attention_layernorm.weight")),
        }
        if cfg.is_mla:
            rope, nope = cfg.qk_rope_head_dim, cfg.qk_nope_head_dim

            def q_rows(w: torch.Tensor) -> torch.Tensor:
                # [H_in, Nq * (nope + rope)]: permute each head's rope tail.
                w = _interleave_to_half(w.reshape(w.shape[0], Nq, nope + rope), rope)
                return w.reshape(w.shape[0], Nq * (nope + rope))

            layers["wkv_a"] = stack(names("self_attn.kv_a_proj_with_mqa.weight"), True,
                                    lambda w: _interleave_to_half(w, rope))
            layers["kv_norm"] = stack(names("self_attn.kv_a_layernorm.weight"))
            layers["wkv_b"] = stack(names("self_attn.kv_b_proj.weight"), True)
            layers["wo"] = stack(names("self_attn.o_proj.weight"), True)
            if cfg.q_lora_rank > 0:
                layers["wq_a"] = stack(names("self_attn.q_a_proj.weight"), True)
                layers["q_norm"] = stack(names("self_attn.q_a_layernorm.weight"))
                layers["wq_b"] = stack(names("self_attn.q_b_proj.weight"), True, q_rows)
            else:
                layers["wq"] = stack(names("self_attn.q_proj.weight"), True, q_rows)
        else:
            layers.update(projections({
                "wq": names("self_attn.q_proj.weight"),
                "wk": names("self_attn.k_proj.weight"),
                "wv": names("self_attn.v_proj.weight"),
            }, "wqkv"))
            layers["wo"] = stack(names("self_attn.o_proj.weight"), True)
            if cfg.attention_bias:
                for key, which in (("bq", "q"), ("bk", "k"), ("bv", "v")):
                    layers[key] = stack(names(f"self_attn.{which}_proj.bias"))
            if cfg.attention_out_bias:
                layers["bo"] = stack(names("self_attn.o_proj.bias"))
            if cfg.attention_sinks:
                layers["sinks"] = stack(names("self_attn.sinks"), dtype=torch.float32)
            if cfg.qk_norm:
                layers["attn_q_norm"] = stack(names("self_attn.q_norm.weight"))
                layers["attn_k_norm"] = stack(names("self_attn.k_norm.weight"))
        if moe and ckpt.has(proj(layer_ids[0], "mlp.router.weight")):
            # gpt-oss: the router is mlp.router (weight [E, H] and a bias);
            # the experts are fused per-layer tensors: gate_up_proj [E, H,
            # 2F] with gate and up interleaved on the last axis (HF
            # GptOssExperts: gate = [..., ::2]), their biases [E, 2F], and
            # down_proj [E, F, H], already [in, out].
            def gate(w):
                return w[..., 0::2]

            def up(w):
                return w[..., 1::2]

            layers["router"] = stack(names("mlp.router.weight"), True)
            layers["router_bias"] = stack(names("mlp.router.bias"), dtype=torch.float32)
            gu, gub = names("mlp.experts.gate_up_proj"), names("mlp.experts.gate_up_proj_bias")
            layers["we_gate"] = stack(gu, fn=gate)
            layers["we_up"] = stack(gu, fn=up)
            layers["we_gate_b"] = stack(gub, fn=gate)
            layers["we_up_b"] = stack(gub, fn=up)
            layers["we_down"] = stack(names("mlp.experts.down_proj"))
            layers["we_down_b"] = stack(names("mlp.experts.down_proj_bias"))
        elif moe:
            E = cfg.num_experts
            if ckpt.has(proj(layer_ids[0], "block_sparse_moe.gate.weight")):
                # Mixtral's names: w1 = gate, w3 = up, w2 = down.
                gate_name = "block_sparse_moe.gate.weight"
                w_index = {"gate": "1", "up": "3", "down": "2"}

                def ename(i, e, which):
                    return proj(i, f"block_sparse_moe.experts.{e}.w{w_index[which]}.weight")
            else:
                gate_name = "mlp.gate.weight"

                def ename(i, e, which):
                    return proj(i, f"mlp.experts.{e}.{which}_proj.weight")

            layers["router"] = stack(names(gate_name), True)
            bias_name = "mlp.gate.e_score_correction_bias"
            if ckpt.has(proj(layer_ids[0], bias_name)):
                layers["router_bias"] = stack(names(bias_name), dtype=torch.float32)
            elif cfg.router_scoring == "sigmoid":
                layers["router_bias"] = torch.zeros(
                    (len(layer_ids), E), dtype=torch.float32, device=device
                )
            for which, key in (("gate", "we_gate"), ("up", "we_up"), ("down", "we_down")):
                layers[key] = stack(
                    [[ename(i, e, which) for e in range(E)] for i in layer_ids], True
                )
            if cfg.shared_expert_intermediate_size:
                for which, key in (("gate", "ws_gate"), ("up", "ws_up"), ("down", "ws_down")):
                    layers[key] = stack(names(f"mlp.shared_experts.{which}_proj.weight"), True)
        else:
            layers.update(projections({
                "w_gate": names("mlp.gate_proj.weight"),
                "w_up": names("mlp.up_proj.weight"),
            }, "w_gu"))
            layers["w_down"] = stack(names("mlp.down_proj.weight"), True)
        return layers

    n_dense = cfg.first_dense_layers if cfg.is_moe else 0
    params: dict = {
        "embed": stack(["model.embed_tokens.weight"])[0],
        "layers": layer_stack(list(range(n_dense, L)), moe=cfg.is_moe),
        "final_norm": stack(["model.norm.weight"])[0],
    }
    if n_dense:
        params["dense_layers"] = layer_stack(list(range(n_dense)), moe=False)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = stack(["lm_head.weight"], True)[0]

    unused = {
        n for n in ckpt.names() - ckpt.used
        if not n.endswith((".inv_freq", "rotary_emb.inv_freq"))
    }
    if unused:
        log.warning(
            "checkpoint tensors not mapped (%d): %s%s",
            len(unused), sorted(unused)[:8], " ..." if len(unused) > 8 else "",
        )
    # The JAX loader quantizes the tree to int8 here when
    # ModelConfig.quantization is "int8" (llmd_tpu/models/loader.py:472-479).
    # That hook comes with int8 weights (ROADMAP.md queue 1 item 3); until
    # then config_from_hf refuses a quantization override.
    return params
