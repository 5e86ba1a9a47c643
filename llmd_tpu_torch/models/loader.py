"""HF checkpoints: ``config.json`` -> ``ModelConfig``, ``*.safetensors`` ->
the stacked parameter tree.

The port of ``llmd_tpu/models/loader.py`` (``config_from_hf``,
``load_params``). It maps HF names and layouts onto the port's tree, which
is the JAX package's:

  - HF linear weights are ``[out, in]`` and applied as ``x @ W.T``; the
    tree's float ones are ``[in, out]`` applied as ``x @ W``, so every
    float projection is transposed on load. The port's int8 leaves are
    K-major, ``[out, in]``: an HF tensor is quantized as it lies, read
    through its ``.T`` view a block of columns at a time.
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
the tree and one tensor. With ``cfg.quantization == "int8"`` each
``QUANT_NAMES`` leaf is quantized as it is mapped, one layer's tensor at a
time (``ops.quant.quantize_weight_into``), into int8 with its
``<name>_scale`` beside it: the JAX loader's post-load
``quantize_param_tree_host`` of the float tree, bit for bit, without the
float tree ever being whole (a fused leaf's column blocks quantize apart,
which gives the bits of quantizing it whole).
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
from llmd_tpu_torch.models.llama import lora_slots
from llmd_tpu_torch.ops.quant import QUANT_NAMES, quantize_weight_into

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

def is_model_dir(path: str) -> bool:
    p = pathlib.Path(path)
    return p.is_dir() and (p / "config.json").is_file()


def config_from_hf(model_dir: str, **overrides) -> ModelConfig:
    """A ModelConfig from an HF model directory's ``config.json``, field
    for field as the JAX package builds it."""
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
    the runner keeps them. Under int8 the ``QUANT_NAMES`` leaves come int8
    with their scales (``ops.quant``), quantized as they are mapped."""
    ckpt = _Checkpoint(model_dir)
    device = torch.device(device)
    dt = getattr(torch, dtype or cfg.dtype)
    Nq, L = cfg.num_heads, cfg.num_layers
    q8 = cfg.quantization == "int8"

    def put(dst: torch.Tensor, name: str, transpose: bool, fn) -> None:
        w = ckpt.get(name).to(device)
        if transpose:
            w = w.T
        dst.copy_(fn(w) if fn else w)

    def put_q8(dst: torch.Tensor, scale: torch.Tensor, name: str, transpose: bool, fn) -> None:
        """What ``put`` would write ([in, out], in the tree's dtype),
        quantized into the K-major int8 ``dst`` ([out, in]) and its
        ``scale``: an HF [out, in] tensor is read through its ``.T``."""
        w = ckpt.get(name).to(device)
        if transpose:
            w = w.T
        quantize_weight_into((fn(w) if fn else w).to(dt), dst, scale)

    def stack(names: list, transpose: bool = False, fn=None, dtype=None, leaf: str = ""):
        """One leaf: ``names[j]`` into ``out[j]``, or ``names[j][e]`` into
        ``out[j, e]``; ``fn`` maps each (transposed) tensor. Returns the
        leaf, or under int8 for a ``QUANT_NAMES`` ``leaf`` the pair (K-major
        int8 leaf, its scales)."""
        nested = isinstance(names[0], list)
        shape = ckpt.shape(names[0][0] if nested else names[0])
        if transpose:
            shape = shape[::-1]
        if fn:
            shape = fn(torch.empty(shape, device="meta")).shape
        lead = (len(names), len(names[0])) if nested else (len(names),)
        quant = q8 and leaf in QUANT_NAMES
        scales = None
        if quant:
            out = torch.empty((*lead, *shape[:-2], shape[-1], shape[-2]), dtype=torch.int8, device=device)
            scales = torch.empty((*lead, *shape[:-2], shape[-1]), dtype=torch.float32, device=device)
        else:
            out = torch.empty((*lead, *shape), dtype=dtype or dt, device=device)
        for j, row in enumerate(names):
            for e, name in enumerate(row) if nested else ((None, row),):
                at = j if e is None else (j, e)
                if quant:
                    put_q8(out[at], scales[at], name, transpose, fn)
                else:
                    put(out[at], name, transpose, fn)
        return out if scales is None else (out, scales)

    def leaf(name: str, names: list, transpose: bool = False, fn=None) -> dict:
        """``{name: leaf}``, with ``name + "_scale"`` under int8."""
        out = stack(names, transpose, fn, leaf=name)
        return {name: out} if not isinstance(out, tuple) else {name: out[0], name + "_scale": out[1]}

    def projections(parts: dict[str, list[str]], fused_name: str) -> dict:
        """Transposed projections side by side in the columns of one
        ``fused_name`` leaf, or under int8 in the row blocks of a K-major
        one (MLA: stacked apart)."""
        if cfg.is_mla:
            return {k: v for key, names in parts.items() for k, v in leaf(key, names, True).items()}
        groups = list(parts.values())
        widths = [ckpt.shape(names[0])[0] for names in groups]  # [out, in] stored
        rows = ckpt.shape(groups[0][0])[1]
        quant = q8 and next(iter(parts)) in QUANT_NAMES
        out = torch.empty((len(groups[0]), sum(widths), rows) if quant else
                          (len(groups[0]), rows, sum(widths)),
                          dtype=torch.int8 if quant else dt, device=device)
        scales = torch.empty((len(groups[0]), sum(widths)), dtype=torch.float32,
                             device=device) if quant else None
        for j in range(len(groups[0])):
            c = 0
            for names, w in zip(groups, widths):
                if quant:
                    put_q8(out[j, c : c + w], scales[j, c : c + w], names[j], True, None)
                else:
                    put(out[j, :, c : c + w], names[j], True, None)
                c += w
        return {fused_name: out} if not quant else {fused_name: out, fused_name + "_scale": scales}

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

            layers.update(leaf("wkv_a", names("self_attn.kv_a_proj_with_mqa.weight"), True,
                               lambda w: _interleave_to_half(w, rope)))
            layers["kv_norm"] = stack(names("self_attn.kv_a_layernorm.weight"))
            layers["wkv_b"] = stack(names("self_attn.kv_b_proj.weight"), True)
            layers.update(leaf("wo", names("self_attn.o_proj.weight"), True))
            if cfg.q_lora_rank > 0:
                layers.update(leaf("wq_a", names("self_attn.q_a_proj.weight"), True))
                layers["q_norm"] = stack(names("self_attn.q_a_layernorm.weight"))
                layers.update(leaf("wq_b", names("self_attn.q_b_proj.weight"), True, q_rows))
            else:
                layers.update(leaf("wq", names("self_attn.q_proj.weight"), True, q_rows))
        else:
            layers.update(projections({
                "wq": names("self_attn.q_proj.weight"),
                "wk": names("self_attn.k_proj.weight"),
                "wv": names("self_attn.v_proj.weight"),
            }, "wqkv"))
            layers.update(leaf("wo", names("self_attn.o_proj.weight"), True))
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
            if cfg.num_lora_adapters:
                # Serving slots, not checkpoint weights: zeros, so every
                # slot is the base model until an adapter is installed.
                layers.update(lora_slots(cfg, len(layer_ids), device, dt))
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
            layers.update(leaf("we_gate", gu, fn=gate))
            layers.update(leaf("we_up", gu, fn=up))
            layers["we_gate_b"] = stack(gub, fn=gate)
            layers["we_up_b"] = stack(gub, fn=up)
            layers.update(leaf("we_down", names("mlp.experts.down_proj")))
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
                layers.update(leaf(
                    key, [[ename(i, e, which) for e in range(E)] for i in layer_ids], True
                ))
            if cfg.shared_expert_intermediate_size:
                for which, key in (("gate", "ws_gate"), ("up", "ws_up"), ("down", "ws_down")):
                    layers.update(leaf(key, names(f"mlp.shared_experts.{which}_proj.weight"), True))
        else:
            layers.update(projections({
                "w_gate": names("mlp.gate_proj.weight"),
                "w_up": names("mlp.up_proj.weight"),
            }, "w_gu"))
            layers.update(leaf("w_down", names("mlp.down_proj.weight"), True))
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
        head = leaf("lm_head", ["lm_head.weight"], True)
        params.update({k: v[0] for k, v in head.items()})

    unused = {
        n for n in ckpt.names() - ckpt.used
        if not n.endswith((".inv_freq", "rotary_emb.inv_freq"))
    }
    if unused:
        log.warning(
            "checkpoint tensors not mapped (%d): %s%s",
            len(unused), sorted(unused)[:8], " ..." if len(unused) > 8 else "",
        )
    # The JAX loader quantizes the float tree here when
    # ModelConfig.quantization is "int8" (llmd_tpu/models/loader.py:472-479);
    # this one quantized each leaf as it was mapped (``leaf``).
    return params


def load_lora_adapter(cfg: ModelConfig, adapter_dir: str) -> dict[str, torch.Tensor]:
    """An HF PEFT LoRA adapter directory (``adapter_config.json`` and
    ``adapter_model.safetensors``) in ``set_lora_weights``' form (JAX
    ``load_lora_adapter``): ``la_q``, ``lb_q``, ``la_v``, ``lb_v`` stacked
    ``[num_layers, ...]`` on the CPU in the model's dtype, the PEFT scaling
    (``lora_alpha / r``, rsLoRA ``lora_alpha / sqrt(r)``) folded into B and
    the rank zero-padded to the slot's (zero columns add nothing). Only
    ``q_proj`` and ``v_proj`` targets fit the slots; an adapter with other
    targets, biases or anything else that changes the arithmetic is
    refused, rather than served as something it is not."""
    p = pathlib.Path(adapter_dir)
    with open(p / "adapter_config.json") as f:
        acfg = json.load(f)
    raw_targets = acfg.get("target_modules") or []
    if isinstance(raw_targets, str):  # PEFT takes a bare string too
        raw_targets = [raw_targets]
    targets = set(raw_targets)
    unsupported = targets - {"q_proj", "v_proj"}
    if unsupported:
        raise ValueError(
            f"adapter targets unsupported modules {sorted(unsupported)}; "
            "servable slots cover q_proj and v_proj"
        )
    if acfg.get("bias", "none") != "none":
        raise ValueError(
            f"adapter bias={acfg['bias']!r} is not servable (slots carry "
            "A/B factors only); trained biases would silently drop"
        )
    for feature in ("use_dora", "modules_to_save", "alpha_pattern", "rank_pattern"):
        if acfg.get(feature):
            raise ValueError(
                f"adapter uses {feature}={acfg[feature]!r}, which the slot "
                "layout cannot represent; the adapter would serve wrong"
            )
    r = int(acfg["r"])
    if r > cfg.lora_rank:
        raise ValueError(f"adapter rank {r} > slot rank {cfg.lora_rank}; raise --lora-rank")
    alpha = float(acfg.get("lora_alpha", r))
    scale = alpha / math.sqrt(r) if acfg.get("use_rslora") else alpha / r
    ckpt = _Checkpoint(str(p))
    names = ckpt.names()

    def find(layer: int, proj: str, half: str) -> str | None:
        # PEFT's names vary with the wrapper's depth: match the suffix.
        suffix = f"layers.{layer}.self_attn.{proj}.{half}.weight"
        return next((n for n in sorted(names) if n.endswith(suffix)), None)

    H, D = cfg.hidden_size, cfg.head_dim
    Nq, K, L, R = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers, cfg.lora_rank
    dt = getattr(torch, cfg.dtype)
    shapes = {"la_q": (H, R), "lb_q": (R, Nq * D), "la_v": (H, R), "lb_v": (R, K * D)}
    out = {k: torch.zeros((L, *shape), dtype=dt) for k, shape in shapes.items()}
    for layer in range(L):
        for proj, a_key, b_key in (("q_proj", "la_q", "lb_q"), ("v_proj", "la_v", "lb_v")):
            if proj not in targets:
                continue
            a_name, b_name = find(layer, proj, "lora_A"), find(layer, proj, "lora_B")
            if a_name is None or b_name is None:
                raise KeyError(f"adapter missing lora_A/lora_B for layer {layer} {proj}")
            a = ckpt.get(a_name)  # [r, H]
            b = ckpt.get(b_name)  # [out, r]
            out[a_key][layer, :, :r] = a.T.to(dt)
            out[b_key][layer, :r, :] = (b.T * scale).to(dt)
    return out
