"""Prometheus metrics in the model-server protocol the router scrapes.

The router's metrics contract: TotalQueuedRequests, TotalRunningRequests,
KVCacheUtilization (and BlockSize / NumGPUBlocks), read through a metric-name
mapping per engine family. The page carries BOTH the vLLM names (a stock
llm-d EPP scrapes it unchanged under the vllm mapping) and the ``llmd:``
names. The port's copy of ``llmd_tpu/serve/metrics.py``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from llmd_tpu_torch import faults

if TYPE_CHECKING:
    from llmd_tpu_torch.engine.engine import EngineStats


def render_metrics(stats: EngineStats, model_name: str) -> str:
    """The Prometheus page of ``stats``: every gauge and counter under the
    ``vllm:`` and the ``llmd:`` family, and ``cache_config_info``.
    ``gpu_cache_usage_perc`` is the binding pool's usage: with the SWA
    ring, the larger of the main pool's and the ring pool's (a scorer
    reading only the main pool would keep sending work to an engine whose
    rings are full). The series of features the port does not have yet
    (the decode pager, context-parallel prefill) print 0, as on a JAX page
    where they are idle; the labelled and
    histogram series (LoRA, speculative decoding, wide EP, transfer
    failures) print only when their stats are set, and
    ``faults_injected_total`` only while a fault plan is armed, as in
    JAX."""
    label = f'{{model_name="{model_name}"}}'
    gauges = {
        "num_requests_waiting": stats.num_waiting,
        "num_requests_running": stats.num_running,
        "gpu_cache_usage_perc": round(
            max(stats.kv_usage, stats.swa_ring_usage), 6
        ),
        "prefix_cache_hit_rate": round(stats.prefix_hit_ratio, 6),
        "step_host_gap_ms": round(stats.step_host_gap_ms, 3),
        "dispatches_per_emitted_token": round(
            stats.dispatches_per_emitted_token, 6
        ),
    }
    gauges["batch_backlog_jobs"] = stats.batch_backlog_jobs
    gauges["batch_backfill_utilization"] = round(
        stats.batch_backfill_utilization, 6
    )
    if stats.swa_ring_pages:
        gauges["swa_ring_usage_perc"] = round(stats.swa_ring_usage, 6)
        gauges["swa_ring_pages"] = stats.swa_ring_pages
        gauges["kv_main_usage_perc"] = round(stats.kv_usage, 6)
        gauges["swa_sections"] = stats.swa_sections
    gauges["kv_offload_cpu_pages"] = stats.offload_pages
    gauges["kv_offload_fs_pages"] = stats.offload_fs_pages
    gauges["kv_paged_out_bytes"] = stats.kv_paged_out_bytes
    gauges["kv_stream_first_group_ms"] = round(
        stats.kv_stream_first_group_ms, 2
    )
    counters = {
        "prompt_tokens_total": stats.prompt_tokens,
        "generation_tokens_total": stats.generation_tokens,
        "request_success_total": stats.requests_finished,
        "num_preemptions_total": stats.preemptions,
        "kv_offload_saves_total": stats.offload_saves,
        "kv_offload_restores_total": stats.offload_restores,
        "batch_tokens_total": stats.batch_tokens,
        "batch_preemptions_total": stats.batch_preemptions,
        "kvstore_pulls_total": stats.kvstore_pulls,
        "kvstore_pull_failures_total": stats.kvstore_pull_failures,
        "kvstore_misses_total": stats.kvstore_misses,
        "kv_federation_published_total": stats.kv_federation_published,
        "kv_federation_hits_total": stats.kv_federation_hits,
        "recompute_avoided_tokens_total": stats.recompute_avoided_tokens,
        "kv_transfer_exported_requests_total": stats.kv_exported_requests,
        "kv_transfer_exported_bytes_total": stats.kv_exported_bytes,
        "kv_transfer_imported_requests_total": stats.kv_imported_requests,
        "kv_transfer_imported_bytes_total": stats.kv_imported_bytes,
        "kv_transfer_import_failures_total": stats.kv_import_failures,
        "kv_stream_groups_total": stats.kv_stream_groups_total,
        "kv_publish_paced_bytes_total": stats.kv_publish_paced_bytes_total,
        "kv_pager_prefetch_late_total": stats.kv_pager_prefetch_late_total,
        "cp_ring_steps_total": stats.cp_ring_steps_total,
        "engine_steps_total": stats.engine_steps_total,
        "step_host_gap_ms_total": round(stats.step_host_gap_ms_total, 3),
        "async_rollbacks_total": stats.async_rollbacks_total,
        "decode_dispatches_total": stats.decode_dispatches_total,
        "unified_steps_total": stats.unified_steps_total,
        "step_dispatches_total": stats.step_dispatches_total,
        "live_tokens_total": stats.live_tokens_total,
        "padded_tokens_total": stats.padded_tokens_total,
        "engine_watchdog_stalls_total": stats.engine_watchdog_stalls_total,
        "kv_bundle_crc_failures_total": stats.kv_bundle_crc_failures_total,
        "kv_recompute_fallbacks_total": stats.kv_recompute_fallbacks_total,
        "stream_resumes_total": stats.stream_resumes_total,
        "resume_replayed_tokens_total": stats.resume_replayed_tokens_total,
        "stream_resume_failures_total": stats.stream_resume_failures_total,
    }
    if stats.swa_ring_pages:
        counters["swa_section_hits_total"] = stats.swa_section_hits
        counters["swa_section_captures_total"] = stats.swa_section_captures
    lines: list[str] = []
    if stats.kv_transfer_failures:
        lines.append("# TYPE llmd:kv_transfer_failures_total counter")
        for (stage, policy), n in stats.kv_transfer_failures:
            lines.append(
                f'llmd:kv_transfer_failures_total{{stage="{stage}",'
                f'policy="{policy}",model_name="{model_name}"}} {n}'
            )
    if stats.moe_expert_tokens:
        lines.append("# TYPE llmd:moe_expert_tokens_total counter")
        for e, n in enumerate(stats.moe_expert_tokens):
            lines.append(
                f'llmd:moe_expert_tokens_total{{expert="{e}",'
                f'model_name="{model_name}"}} {n}'
            )
        gauges["moe_capacity_factor"] = round(stats.moe_capacity_factor, 4)
        gauges["moe_peak_demand"] = round(stats.moe_peak_demand, 4)
        counters["moe_dropped_slots_total"] = stats.moe_dropped_slots_total
        counters["moe_rebalances_total"] = stats.moe_rebalances_total
    injected = faults.injected_counts()
    if injected:
        # Only while a fault plan is armed: the injections each site
        # delivered, read beside the degradation they cause.
        lines.append("# TYPE llmd:faults_injected_total counter")
        for site, n in sorted(injected.items()):
            lines.append(
                f'llmd:faults_injected_total{{site="{site}",'
                f'model_name="{model_name}"}} {n}'
            )
    if stats.max_lora:
        running = ",".join(stats.running_lora_adapters)
        waiting = ",".join(stats.waiting_lora_adapters)
        available = ",".join(stats.available_lora_adapters)
        resident = ",".join(stats.resident_lora_adapters) or available
        lines.append("# TYPE vllm:lora_requests_info gauge")
        lines.append(
            f'vllm:lora_requests_info{{max_lora="{stats.max_lora}",'
            f'running_lora_adapters="{running}",'
            f'waiting_lora_adapters="{waiting}",'
            f'available_lora_adapters="{available}",'
            f'resident_lora_adapters="{resident}",'
            f'model_name="{model_name}"}} 1'
        )
        gauges["lora_pool_resident_adapters"] = (
            stats.lora_pool_resident_adapters
        )
        counters["lora_pool_evictions_total"] = stats.lora_pool_evictions_total
        counters["lora_cold_loads_total"] = stats.lora_cold_loads_total
        counters["lora_load_failures_total"] = stats.lora_load_failures_total
    if stats.spec_accepted_len_hist:
        lines.append("# TYPE llmd:spec_acceptance_rate gauge")
        lines.append(
            f"llmd:spec_acceptance_rate{label} "
            f"{round(stats.spec_acceptance_rate, 6)}"
        )
        for name, v in (
            ("spec_proposed_tokens_total", stats.spec_proposed_tokens_total),
            ("spec_accepted_tokens_total", stats.spec_accepted_tokens_total),
            ("spec_window_iters_total", stats.spec_window_iters_total),
            (
                "spec_window_early_exit_total",
                stats.spec_window_early_exit_total,
            ),
        ):
            lines.append(f"# TYPE llmd:{name} counter")
            lines.append(f"llmd:{name}{label} {v}")
        hist = stats.spec_accepted_len_hist
        lines.append("# TYPE llmd:spec_accepted_len histogram")
        cum = 0
        for ln, cnt in enumerate(hist):
            cum += cnt
            lines.append(
                f'llmd:spec_accepted_len_bucket{{le="{ln}",'
                f'model_name="{model_name}"}} {cum}'
            )
        lines.append(
            f'llmd:spec_accepted_len_bucket{{le="+Inf",'
            f'model_name="{model_name}"}} {cum}'
        )
        total = sum(j * c for j, c in enumerate(hist))
        lines.append(
            f'llmd:spec_accepted_len_sum{{model_name="{model_name}"}} {total}'
        )
        lines.append(
            f'llmd:spec_accepted_len_count{{model_name="{model_name}"}} {cum}'
        )
    if stats.spec_row_depth_hist:
        hist = stats.spec_row_depth_hist
        lines.append("# TYPE llmd:spec_row_depth histogram")
        cum = 0
        for d, cnt in enumerate(hist):
            cum += cnt
            lines.append(
                f'llmd:spec_row_depth_bucket{{le="{d}",'
                f'model_name="{model_name}"}} {cum}'
            )
        lines.append(
            f'llmd:spec_row_depth_bucket{{le="+Inf",'
            f'model_name="{model_name}"}} {cum}'
        )
        total = sum(d * c for d, c in enumerate(hist))
        lines.append(
            f'llmd:spec_row_depth_sum{{model_name="{model_name}"}} {total}'
        )
        lines.append(
            f'llmd:spec_row_depth_count{{model_name="{model_name}"}} {cum}'
        )
    for family in ("vllm", "llmd"):
        for name, v in gauges.items():
            lines.append(f"# TYPE {family}:{name} gauge")
            lines.append(f"{family}:{name}{label} {v}")
        for name, v in counters.items():
            lines.append(f"# TYPE {family}:{name} counter")
            lines.append(f"{family}:{name}{label} {v}")
        lines.append(f"# TYPE {family}:cache_config_info gauge")
        lines.append(
            f'{family}:cache_config_info{{block_size="{stats.page_size}",'
            f'num_gpu_blocks="{stats.num_pages}",model_name="{model_name}"}} 1'
        )
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict[str, float]:
    """Parse a Prometheus text page into {metric_name: value}.

    Labels are dropped; repeated names keep the first sample (single-model
    engines emit one series per name). This is the scrape-side half of the
    metrics contract used by the EPP data layer.
    """
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            name_part, value = line.rsplit(None, 1)
        except ValueError:
            continue
        name = name_part.split("{", 1)[0]
        if name not in out:
            try:
                out[name] = float(value)
            except ValueError:
                continue
    return out
