"""Model runner: owns the device state (params + KV pool) and the flat step.

The port of ``llmd_tpu/engine/runner.py``'s flattened-token step
(``stage_unified`` / ``dispatch_staged_unified`` / ``_build_flat`` /
``wait_step``): one engine step packs every scheduled sequence's tokens
(prefill chunks and one-token decode rows) into one ``[T]`` stream, padded
to a 16-token bucket, with per-row ``(row_start, pos0, qlen)`` metadata.
On the device the step derives each token's row, position and causal
horizon (``kv_len = position + 1``), runs the decoder stack, gathers each
row's last hidden state, projects logits and samples, and the host reads
back ONE packed ``[B, 2]`` (token, logprob) tensor.

One row per sequence: the JAX runner splits long prefill chunks into
64-token sub-rows for its bucketed layout, which the flat layout does not
need (a token's attention depends only on its row's pages and its own
position). The run plan (``_fill_flat_runs``) is gone too: it exists for
the TPU write kernel, which cannot store one row; the port's CUDA write
kernel addresses each token's (page, slot) itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from llmd_tpu_torch.config import EngineConfig
from llmd_tpu_torch.engine.sampler import sample_tokens, spec_seed
from llmd_tpu_torch.engine.scheduler import ScheduledSeq
from llmd_tpu_torch.models import llama
from llmd_tpu_torch.models.common import StepInput

# Packed-stream length granule: T pads up to a multiple of 16 tokens.
_T_GRANULE = 16


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return device


@dataclass
class StepResult:
    """Sampled token and its logprob for each row; [n, 1]."""

    tokens: np.ndarray
    logprobs: np.ndarray


@dataclass
class StagedUnified:
    """Host arrays of one flat step: the packed token stream and the
    per-row metadata, built from the schedule."""

    prefills: list[ScheduledSeq]
    decodes: list[ScheduledSeq]
    arrays: dict
    num_live: int
    all_greedy: bool


@dataclass
class PendingUnified:
    """One dispatched-but-unread flat step: the packed [B, 2] device
    output; rows [0, n_prefills) are the prefills, then the decodes."""

    packed: torch.Tensor
    n_prefills: int
    n_decodes: int


class ModelRunner:
    def __init__(
        self,
        config: EngineConfig,
        params: dict | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.config = config
        self.cfg = config.model
        self.device = resolve_device(device)
        self.page = config.cache.page_size
        self.max_pages = config.cache.max_pages_per_seq(self.cfg.max_model_len)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            params = llama.init_params(self.cfg, gen, self.device)
        else:
            params = _to_device(params, self.device)
        self.params = llama.fuse_projections(params)
        # [L, pages, K, page, 2D]: the K|V halves side by side on the last axis.
        self.kv_cache = torch.zeros(
            (
                self.cfg.num_layers,
                config.cache.num_blocks,
                self.cfg.num_kv_heads,
                self.page,
                2 * self.cfg.head_dim,
            ),
            dtype=getattr(torch, config.cache.dtype),
            device=self.device,
        )
        # Row-metadata width: every scheduled sequence is one row.
        self.flat_rows = config.scheduler.max_num_seqs
        self._np_rng = np.random.default_rng(config.seed ^ 0x5EED)
        # Padding accounting: live tokens and the pads the T bucket added.
        self.live_tokens_total = 0
        self.padded_tokens_total = 0

    # ------------------------------------------------------------------ #

    def stage_unified(
        self, prefills: list[ScheduledSeq], decodes: list[ScheduledSeq]
    ) -> StagedUnified:
        """Pack the step's rows (prefill chunks, then one-token decodes)
        into the token stream and per-row metadata. Pad rows carry
        ``row_start = total`` so the boundary array stays monotonic."""
        seqs = [*prefills, *decodes]
        B = max(self.flat_rows, len(seqs))
        total = sum(s.num_tokens for s in seqs)
        T = -(-total // _T_GRANULE) * _T_GRANULE
        a = {
            "stream": np.zeros(T, np.int64),
            "row_start": np.full(B, total, np.int64),
            "pos0": np.zeros(B, np.int64),
            "qlens": np.zeros(B, np.int64),
            "page_table": np.zeros((B, self.max_pages), np.int32),
            "temp": np.zeros(B, np.float32),
            "top_k": np.zeros(B, np.int32),
            "top_p": np.ones(B, np.float32),
            "seeds": self._np_rng.integers(0, 2**32, size=B, dtype=np.uint32),
        }
        t = 0
        for r, seq in enumerate(seqs):
            req = seq.request
            start = seq.start_pos
            w = seq.num_tokens
            a["stream"][t : t + w] = req.all_token_ids[start : start + w]
            a["row_start"][r] = t
            a["pos0"][r] = start
            a["qlens"][r] = w
            a["page_table"][r, : len(req.block_ids)] = req.block_ids
            sp = req.sampling
            a["temp"][r] = 0.0 if sp.greedy else sp.temperature
            a["top_k"][r] = sp.top_k
            a["top_p"][r] = sp.top_p
            if sp.seed is not None:
                # Deterministic per (request seed, output index).
                a["seeds"][r] = spec_seed(sp.seed, req.total_output_tokens)
            t += w
        all_greedy = all(s.request.sampling.greedy for s in seqs)
        return StagedUnified(list(prefills), list(decodes), a, total, all_greedy)

    def dispatch_unified(
        self, prefills: list[ScheduledSeq], decodes: list[ScheduledSeq]
    ) -> PendingUnified:
        """Stage and enqueue the whole step as one flat forward."""
        staged = self.stage_unified(prefills, decodes)
        a = staged.arrays
        self.live_tokens_total += staged.num_live
        self.padded_tokens_total += len(a["stream"]) - staged.num_live
        packed = self._flat_step(a, staged.num_live, staged.all_greedy)
        return PendingUnified(packed, len(staged.prefills), len(staged.decodes))

    @torch.inference_mode()
    def _flat_step(self, a: dict, num_live: int, all_greedy: bool) -> torch.Tensor:
        dev = self.device
        stream = torch.as_tensor(a["stream"], device=dev)
        row_start = torch.as_tensor(a["row_start"], device=dev)
        pos0 = torch.as_tensor(a["pos0"], device=dev)
        qlens = torch.as_tensor(a["qlens"], device=dev)
        page_table = torch.as_tensor(a["page_table"], device=dev)
        T, B = stream.shape[0], row_start.shape[0]
        # Per-token view derived on device from the cu_q_lens metadata:
        # token t belongs to the row whose [row_start, row_start + qlen)
        # span holds it, its position is pos0 + its offset in the row,
        # and its causal horizon is position + 1.
        t = torch.arange(T, device=dev)
        ends = row_start + qlens  # non-decreasing (pad rows = total)
        row_of = torch.searchsorted(ends, t, right=True).clamp_(0, B - 1)
        live = t < ends[-1]
        positions = torch.where(live, pos0[row_of] + (t - row_start[row_of]), 0)
        inp = StepInput(
            token_ids=torch.where(live, stream, 0)[:, None],
            positions=positions.int()[:, None],
            kv_lens=torch.where(live, positions + 1, 0).int(),
            page_table=page_table,
            token_rows=row_of.int(),
            num_live=num_live,
        )
        hidden, self.kv_cache = llama.forward_hidden(
            self.params, self.kv_cache, inp, self.cfg
        )
        last = (row_start + (qlens - 1).clamp(min=0)).clamp(0, T - 1)
        logits = llama.compute_logits(self.params, hidden[last, 0], self.cfg)
        tok, logp = sample_tokens(
            logits, a["temp"], a["top_k"], a["top_p"], a["seeds"], all_greedy
        )
        return torch.stack([tok.float(), logp], dim=1)  # [B, 2]

    def wait_step(self, pending: PendingUnified) -> tuple[StepResult | None, StepResult | None]:
        """Block on the step's ONE device->host copy and split it into the
        prefill and decode results."""
        arr = pending.packed.cpu().numpy()
        n_p, n_d = pending.n_prefills, pending.n_decodes
        pres = dres = None
        if n_p:
            pres = StepResult(arr[:n_p, :1].astype(np.int32), arr[:n_p, 1:2])
        if n_d:
            rows = slice(n_p, n_p + n_d)
            dres = StepResult(arr[rows, :1].astype(np.int32), arr[rows, 1:2])
        return pres, dres


def _to_device(tree: dict, device: torch.device) -> dict:
    return {
        k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
        for k, v in tree.items()
    }
